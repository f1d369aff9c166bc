#!/usr/bin/env python3
"""Host time per launch of the port's fp32 wrappers, the host-bound 1d2r
1,000,000 x 256 run, and the device time of the 2-D step at 8192^2 and of
the wide 1-D pass, on one CUDA device.

    python3 launch_overhead.py [--root DIR] [--label NAME]

``--root`` imports ``lorastencil_tpu_torch`` from another checkout (an
unpacked older commit, say), so that two trees can be compared on one card:
run them in turns (old, new, new, old) and compare within that session.

Measured, each on the tree's own kernels (built at first use):

* ``stencil1d_lanes_step`` at 1d2r 1,000,000 with the engine's fused depth
  and ``stencil2d_step`` at star2d1r 1024^2: the wall time of one call with
  the device idle before it (synchronized), microseconds, the median of
  each of ``--rounds`` rounds of ``--calls`` calls and of all of them;
* ``run_internal`` of 1d2r 1,000,000 x 256 (CUDA events, best of 5 after a
  warmup), where that host time decides the run's time;
* ``stencil2d_step`` at star2d1r 8192^2, device-bound: CUDA events around 20
  back-to-back launches, best of 5 after a warmup, ms per launch;
* ``stencil1d_step``, the wide pass, in float64 at ``for_coeffs`` r = 40 x
  100,000 (chip_smoke.py's taps) and x 16,777,216, and in float32 at 1d2r
  1,000,000 with ``algorithm='vpu'`` (k = 2): 20 launches captured in a CUDA graph,
  replayed (best of 3), ms per launch, so the host's work is left out;
  beside it one float64 ``F.conv1d`` step with the same taps, timed the
  same way.

Prints the card (name, power limit) and one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def host_us(fn, calls):
    """Median wall time of one ``fn()`` with the device idle before it."""
    import numpy as np
    import torch

    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return times, float(np.median(times)) * 1e6


def wide_passes(engine, stencil1d, device, gen):
    """Device ms of the wide 1-D pass: float64 r = 40 x 100,000 and x
    16,777,216, float32 1d2r 1,000,000 at k = 2, and one float64
    ``F.conv1d`` r = 40 step at 100,000."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from chip_smoke import graph_ms

    taps = np.random.default_rng(40).integers(-3, 4, 81) / 256.0
    taps[0] = taps[-1] = 1.0 / 256.0
    out = {}
    for label, eng, k in (
            ("stencil1d_step_f64_r40_100000_ms",
             engine.StencilEngine.for_coeffs(taps, (100_000,), name="r40",
                                             device=device, dtype="df64"),
             1),
            ("stencil1d_step_f64_r40_16777216_ms",
             engine.StencilEngine.for_coeffs(taps, (16_777_216,), name="r40",
                                             device=device, dtype="df64"),
             1),
            ("stencil1d_step_1d2r_1000000_k2_ms",
             engine.StencilEngine.for_shape("1d2r", (1_000_000,),
                                            device=device, algorithm="vpu"),
             2)):
        if eng._fused_k() != k or eng.path != "flat":
            raise AssertionError(f"{label}: path {eng.path} k "
                                 f"{eng._fused_k()}")
        x = torch.rand(eng.layout.shape, generator=gen, device=device,
                       dtype=eng.dtype) * 0.01
        donor = torch.zeros_like(x)
        out[label] = graph_ms(lambda: stencil1d.stencil1d_step(
            x, donor, eng.spec, eng.layout, fused_steps=k))
        del x, donor
    w = torch.tensor(taps, dtype=torch.float64, device=device)[None, None]
    x = torch.rand((1, 1, 100_000 + 80), generator=gen, device=device,
                   dtype=torch.float64) * 0.01
    out["conv1d_f64_r40_100000_ms"] = graph_ms(lambda: F.conv1d(x, w))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout to import lorastencil_tpu_torch from")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("launch_overhead: no CUDA device", file=sys.stderr)
        return 1
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil1d, stencil2d
    from lorastencil_tpu_torch.utils import metrics

    package = os.path.dirname(engine.__file__)
    if not package.startswith(os.path.abspath(args.root)):
        raise AssertionError(f"imported {package}, not from {args.root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)

    n = 1_000_000
    eng1 = engine.StencilEngine.for_shape("1d2r", (n,), device=device)
    spec1, lay1, k = eng1.spec, eng1.layout, eng1._fused_k()
    x1 = torch.rand(lay1.shape, generator=gen, device=device) * 0.01
    d1 = torch.zeros_like(x1)
    eng2 = engine.StencilEngine.for_shape("star2d1r", (1024, 1024),
                                          device=device)
    x2 = torch.rand(eng2.layout.shape, generator=gen, device=device) * 0.01
    d2 = torch.zeros_like(x2)
    calls = {
        "stencil1d_lanes_step": lambda: stencil1d.stencil1d_lanes_step(
            x1, d1, spec1, lay1, fused_steps=k),
        "stencil2d_step": lambda: stencil2d.stencil2d_step(
            x2, d2, eng2.spec, eng2.layout)}
    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": card, "fused_k_1d2r": k}
    for name, fn in calls.items():
        fn()  # builds and loads the kernel
        rounds, every = [], []
        for _ in range(args.rounds):
            times, med = host_us(fn, args.calls)
            rounds.append(med)
            every += times
        out[name] = {"host_us_median": float(np.median(every)) * 1e6,
                     "host_us_round_medians": rounds}
    secs, _ = metrics.time_run(eng1.run_internal, x1, 256, repeats=5,
                               warmup=1)
    out["run_1d2r_1000000x256_ms"] = secs * 1e3
    out["launches_per_run"] = -(-256 // k)
    eng3 = engine.StencilEngine.for_shape("star2d1r", (8192, 8192),
                                          device=device)
    x3 = torch.rand(eng3.layout.shape, generator=gen, device=device) * 0.01
    d3 = torch.zeros_like(x3)

    def steps_8192():
        for _ in range(20):
            stencil2d.stencil2d_step(x3, d3, eng3.spec, eng3.layout)

    secs, _ = metrics.time_run(steps_8192, repeats=5, warmup=1)
    out["stencil2d_step_8192_device_ms"] = secs / 20 * 1e3
    del x3, d3
    torch.backends.cudnn.allow_tf32 = False
    out.update(wide_passes(engine, stencil1d, device, gen))
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
