#!/usr/bin/env python3
"""Time, on the card, one pass of each kernel that takes a ghost ring's
``bounds`` -- the fused strip kernel, the tile kernel's fused levels, the 3-D
march kernel at k = 2 (float32 and float64) and the general 3-D kernel at
k = 4, ``lanes_kernel``, ``wide_kernel`` and ``pass_kernel<double>`` -- and
of the plan strip kernel on the custom plans (``PLAN_CASES``), at the sizes
of ``chip_smoke.py``'s paths, in dirichlet0, through the engine's own pass
(``StencilEngine._step_internal``); and a pass of the sharded 2-D engine
over a (2, 2) mesh of shards on the one card (``SHARDED_CASES``: the
exchanges, the launches and the host's work between them), from this
checkout or another one:

    python3 tools/kernel_turns.py [--root DIR]

``--root`` imports ``lorastencil_tpu_torch`` from DIR (an older commit
unpacked with ``git archive`` into an ignored directory), so that two trees
can be timed in one call, in turns (parent, this, this, parent), each run
its own process.  Prints the card (name and power limit) and one JSON line,
{case: ms per pass}: a CUDA graph of 20 passes, best of 3, so the host's
launch work is left out; a sharded pass by CUDA events around ``_run`` of
4 passes, best of 3, the host's work included.
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
# the plan strip kernel's cases of chip_smoke.py phase 28 (its 9x9 of rank
# 4: seeded random factors, ``chip_smoke.custom_coeffs``): (label, spec,
# interior, dtype, engine options)
PLAN_CASES = (
    ("plan strip 9x9 rank 4 8192^2", "9x9 rank 4", (8192, 8192), "float32", {}),
    ("plan strip df64 9x9 rank 4 8192^2", "9x9 rank 4", (8192, 8192), "df64", {}),
    ("plan strip k=3 bf16 star2d1r 8192^2", "star2d1r", (8192, 8192), "bfloat16",
     {"fused_steps": 3}),
)
# a float32 pass deeper than the strip walk's deepest launch on a shard:
# (label, spec, global interior, sharded engine options)
SHARDED_CASES = (
    ("sharded (2,2) k=5 star2d1r 8192^2", "star2d1r", (8192, 8192),
     {"fused_steps": 5}),
    ("sharded (2,2) k=3 custom_r5 8192^2", "custom_r5", (8192, 8192),
     {"fused_steps": 3}),
)


def spec_of(name):
    """A registry shape, the 9x9 of rank 4 (``for_coeffs``) or custom_r5,
    the 11x11 box of ones."""
    import numpy as np

    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import (SeparableTerm,
                                                     StencilSpec, get_shape)

    if name == "9x9 rank 4":
        rng = np.random.default_rng(15)
        S = sum(np.outer(rng.standard_normal(9), rng.standard_normal(9))
                for _ in range(4))
        return engine.StencilEngine.for_coeffs(S, (8, 8), name=name,
                                               device="cpu").spec
    if name == "custom_r5":
        ones = (1.0,) * 11
        return StencilSpec(name=name, ndim=2, radius=5, halo=(5, 5),
                           terms=(SeparableTerm(taps=(ones, ones)),),
                           residue=(), fuse_factor=1)
    return get_shape(name)


def sharded_ms(eng, padded, passes=4):
    """ms per pass of ``eng._run`` over ``passes`` passes (CUDA events,
    best of 3 after one run)."""
    import torch

    state = eng.to_sharded(padded)
    steps = passes * eng.fused_steps
    eng._run(state, steps)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng._run(state, steps)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / passes)
    return best


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
    from lorastencil_tpu_torch.parallel import domain
    from lorastencil_tpu_torch.utils import reference

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {}
    for label, name, interior, dtype, kw in CASES + PLAN_CASES:
        eng = engine.StencilEngine(spec_of(name), interior,
                                   engine._config(dict(kw, dtype=dtype)),
                                   device="cuda")
        x = eng.to_internal(reference.random_padded(eng.spec, interior, seed=1))
        donor = torch.zeros_like(x)
        k = eng._fused_k()
        out[label] = graph_ms(lambda: eng._step_internal(x, donor, k))
        del x, donor
    for label, name, interior, kw in SHARDED_CASES:
        eng = domain.sharded_engine(spec_of(name), interior, (2, 2),
                                    devices=["cuda:0"] * 4, **kw)
        padded = torch.rand(eng.spec.padded_shape(interior), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1),
                            dtype=torch.float64) * 0.01
        out[label] = sharded_ms(eng, padded)
        out[label + " launches a pass"] = len(eng._launch_depths(eng.fused_steps))
        out[label + " step"] = eng._step_fn().__name__
        del eng, padded
    print(card, flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
