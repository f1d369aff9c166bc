#!/usr/bin/env python3
"""Time, on the card, one pass of each kernel that takes a ghost ring's
``bounds`` -- the fused strip kernel, the tile kernel's fused levels, the 3-D
march kernel at k = 2 (float32 and float64) and the general 3-D kernel at
k = 4, ``lanes_kernel``, ``wide_kernel`` and ``pass_kernel<double>`` -- at
the sizes of ``chip_smoke.py``'s paths, in dirichlet0, through the engine's
own pass (``StencilEngine._step_internal``), from this checkout or another
one:

    python3 tools/kernel_turns.py [--root DIR]

``--root`` imports ``lorastencil_tpu_torch`` from DIR (an older commit
unpacked with ``git archive`` into an ignored directory), so that two trees
can be timed in one call, in turns (parent, this, this, parent), each run
its own process.  Prints the card (name and power limit) and one JSON line,
{case: device ms per pass}: a CUDA graph of 20 passes, best of 3, so the
host's launch work is left out.
"""

import argparse
import json
import os
import subprocess
import sys

CASES = (  # (label, shape, interior, dtype, engine options)
    ("fused strip k=2 star2d3r 8192^2", "star2d3r", (8192, 8192), "float32", {}),
    ("tile fused k=2 star2d1r 8192^2", "star2d1r", (8192, 8192), "float32",
     {"fused_steps": 2}),
    ("tile fused k=2 float64 star2d1r 4096^2", "star2d1r", (4096, 4096), "float64",
     {"fused_steps": 2}),
    ("march k=2 star3d1r 256^3", "star3d1r", (256, 256, 256), "float32", {}),
    ("march k=2 box3d1r 256^3", "box3d1r", (256, 256, 256), "float32", {}),
    ("march k=2 float64 box3d1r 256^3", "box3d1r", (256, 256, 256), "float64", {}),
    ("general k=4 star3d1r 256^3", "star3d1r", (256, 256, 256), "float32",
     {"fused_steps_3d": 4}),
    ("lanes k=3 1d2r 16,777,216", "1d2r", (16_777_216,), "float32", {}),
    ("wide k=2 1d2r 1,000,000", "1d2r", (1_000_000,), "float32", {"algorithm": "vpu"}),
    ("pass<double> k=2 1d2r 16,777,216", "1d2r", (16_777_216,), "float64", {}),
)


def graph_ms(fn, calls=20):
    """Device ms per call: ``calls`` calls in one CUDA graph, best of 3."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.utils import reference

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {}
    for label, name, interior, dtype, kw in CASES:
        eng = engine.StencilEngine.for_shape(name, interior, dtype=dtype, **kw)
        x = eng.to_internal(reference.random_padded(eng.spec, interior, seed=1))
        donor = torch.zeros_like(x)
        k = eng._fused_k()
        out[label] = graph_ms(lambda: eng._step_internal(x, donor, k))
        del x, donor
    print(card, flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
