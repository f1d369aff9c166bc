#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

The main path is the JAX package's flagship (bench.py): star2d1r,
fp32-exact, dirichlet0, 8192^2 interior, through
``lorastencil_tpu_torch.engine.StencilEngine`` and its CUDA kernel
(``lorastencil_tpu_torch/csrc/stencil2d.cu``, replacing the Pallas kernel
``lorastencil_tpu/ops/pallas_2d.py::_stencil2d_kernel``).  Phases, each
printing one line and raising on failure:

1. the card (nvidia-smi name and power limit), torch and nvcc versions;
   the kernel built from the checkout's sources;
2. the kernel against its plain PyTorch twin on the card, for star2d1r
   and box2d1r at an interior the (32, 128) tile divides, one it does not,
   and the main path's 8192^2: integer fill bit for bit at 1 and 2 steps;
   the fill times pi/100 within rel 1e-6 after 4 steps (the kernel fuses
   multiply-adds, the twin rounds each product);
3. the slice end to end: ``run`` of 2 steps at 8192^2 equal bit for bit to
   a float64 dense stencil on the card (every partial sum is an integer
   below 2**24), with the launch counter at exactly 2; a 256x384 grid at
   4 steps within rel 1e-5 of the fp64 ground truth (the CLI's float32
   tolerance);
4. 256 steps at 8192^2 timed with CUDA events (warmup, best of 3) through
   ``run_internal`` and through the naive dense stencil; GStencil/s counts
   star2d1r's x3 fuse factor.

It then prints the kernels' JSON record and, last, the device record.
It needs one CUDA device and exits non-zero without one.  JAX is never
imported; the shared NumPy modules of ``lorastencil_tpu`` (the stencil
registry, the fp64 ground truth, the GStencil/s record) are.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

INTERIOR = (8192, 8192)
BENCH_STEPS = 256
SOURCE = "lorastencil_tpu_torch/csrc/stencil2d.cu"
REPLACES = "lorastencil_tpu/ops/pallas_2d.py:127"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def port_layout(spec, interior):
    from lorastencil_tpu_torch.ops.layout import (Layout2D, default_tile_2d,
                                                  guard_2d)

    return Layout2D(interior=interior, halo=spec.halo,
                    tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, spec.radius))


def run_steps(step, x, spec, lay, steps):
    """``steps`` passes of a kernel wrapper or its twin, with the engine's
    donor rotation."""
    from lorastencil_tpu_torch.engine import ping_pong_loop

    return ping_pong_loop(lambda cur, donor: step(cur, donor, spec, lay),
                          x, steps)


def check_kernel(name, interior, device):
    """Phase 2 for one shape and size; returns the max abs and rel errors
    of the pi/100 fill after 1 and 4 steps."""
    from lorastencil_tpu.models.shapes import get_shape
    from lorastencil_tpu.utils import reference
    from lorastencil_tpu_torch.ops import stencil2d

    spec = get_shape(name)
    lay = port_layout(spec, interior)
    g0 = reference.random_padded(spec, interior, seed=1)
    x = lay.to_internal(g0, device=device)
    for steps in (1, 2):
        got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
        want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(
                f"{name} {interior}: kernel differs from its twin at "
                f"{bad} cells after {steps} steps (integer fill)")
    x = lay.to_internal(g0 * (np.pi / 100), device=device)
    errs = {}
    for steps in (1, 4):
        got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
        want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {interior}: non-finite output")
        abs_err = (got - want).abs().max().item()
        rel = abs_err / want.abs().max().item()
        errs[steps] = (abs_err, rel)
    if errs[4][1] > 1e-6:
        raise AssertionError(
            f"{name} {interior}: rel err {errs[4][1]:.3e} > 1e-6 after 4 "
            f"steps (pi/100 fill)")
    return errs


def time_step(spec, lay, device, calls=20):
    """Per-call device ms of the kernel and of its plain twin, one step
    each, at the layout's shape (uniform [0, 0.01) fill)."""
    from lorastencil_tpu_torch.ops import stencil2d
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(lay.shape, generator=gen, device=device) * 0.01
    donor = torch.zeros_like(x)

    def loop(step):
        for _ in range(calls):
            step(x, donor, spec, lay)

    ms = {}
    for name, fn in (("plain", stencil2d.stencil2d_step_plain),
                     ("kernel", stencil2d.stencil2d_step),
                     ("kernel2", stencil2d.stencil2d_step),
                     ("plain2", stencil2d.stencil2d_step_plain)):
        secs, _ = metrics.time_run(loop, fn, repeats=3, warmup=1)
        ms[name] = secs / calls * 1e3
    return min(ms["kernel"], ms["kernel2"]), min(ms["plain"], ms["plain2"])


def main_path(device):
    """Phase 3: the slice end to end at 8192^2; returns the number of
    kernel launches counted during ``run``."""
    from lorastencil_tpu.models.shapes import get_shape
    from lorastencil_tpu.utils import reference
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil2d, torch_ref

    spec = get_shape("star2d1r")
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device=device)
    if eng.algorithm != "mxu_hybrid1" or eng.backend != "pallas":
        raise AssertionError(f"main path resolved to {eng.algorithm}/"
                             f"{eng.backend}")
    g0 = reference.random_padded(spec, INTERIOR, seed=0)
    want = torch.from_numpy(g0).to(device)  # float64
    for _ in range(2):
        want = torch_ref.dense_step(want, spec)
    stencil2d.stencil2d_step.launches = 0
    out = eng.run(g0, 2)
    torch.cuda.synchronize()
    launches = stencil2d.stencil2d_step.launches
    if launches != 2:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times for 2 steps")
    if tuple(out.shape) != spec.padded_shape(INTERIOR):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("main path output is not finite")
    if not torch.equal(out.double(), want):
        bad = (out.double() != want).sum().item()
        raise AssertionError(
            f"main path differs from the float64 dense stencil at {bad} "
            f"cells after 2 steps")
    del want, out

    small = (256, 384)
    g1 = reference.random_padded(spec, small, seed=2)
    want = reference.run(g1, spec, 4)
    got = engine.StencilEngine.for_shape(
        "star2d1r", small, device=device).run(g1, 4)
    rel = (np.abs(got.cpu().numpy().astype(np.float64) - want).max()
           / np.abs(want).max())
    if not rel <= 1e-5:
        raise AssertionError(f"256x384 x4: rel err {rel:.3e} > 1e-5")
    return launches, rel


def bench(device, card):
    """Phase 4: kernel path and naive dense stencil, 256 steps each.
    Values grow 100x per step and overflow to inf/NaN after ~20 steps of
    the [0, 0.01) fill; fp32 arithmetic on inf/NaN runs at the same speed
    on this card, so the times stand (correctness is phases 2-3)."""
    from lorastencil_tpu.models.shapes import get_shape
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import metrics

    spec = get_shape("star2d1r")
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = torch.rand(eng.layout.shape, generator=gen,
                       device=device) * 0.01
    secs, _ = metrics.time_run(eng.run_internal, state, BENCH_STEPS,
                               repeats=3, warmup=1)
    res = metrics.bench_result(spec, INTERIOR, BENCH_STEPS, secs,
                               "cuda-stencil2d", "fp32-exact", 3)
    del state
    grid = torch.rand(spec.padded_shape(INTERIOR), generator=gen,
                      device=device) * 0.01

    def naive(g):
        for _ in range(BENCH_STEPS):
            g = torch_ref.dense_step(g, spec)
        return g

    bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
    base = metrics.bench_result(spec, INTERIOR, BENCH_STEPS, bsecs,
                                "torch-naive", "fp32", 3)
    for label, r in (("kernel", res), ("naive", base)):
        print(f"phase 4: {label} star2d1r {INTERIOR[0]}x{INTERIOR[1]} "
              f"x{BENCH_STEPS}: {r.time_ms} ms, {r.gstencil_per_s} "
              f"GStencil/s (x3 fused) [{card}]", flush=True)
    print(f"phase 4: vs_baseline {res.gstencil_per_s / base.gstencil_per_s}"
          f" [{card}]", flush=True)
    return res, base


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lorastencil_tpu_torch.ops import _cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    lib = _cuda_build.build("stencil2d")
    build_s = time.perf_counter() - t0
    with open(lib + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln
                 or "spill" in ln]
    print(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}),"
          f" {nvcc}; built {SOURCE} in {build_s:.1f} s: "
          f"{' | '.join(ptxas)}", flush=True)

    from lorastencil_tpu.models.shapes import get_shape

    main_errs = None
    for name in ("star2d1r", "box2d1r"):
        for interior in ((1024, 1024), (1000, 1000), INTERIOR):
            errs = check_kernel(name, interior, device)
            if name == "star2d1r" and interior == INTERIOR:
                main_errs = errs
            print(f"phase 2: {name} {interior}: integer fill bit-exact at "
                  f"1-2 steps; pi/100 fill rel err {errs[1][1]:.3e} (1 "
                  f"step), {errs[4][1]:.3e} (4 steps) <= 1e-6", flush=True)
    spec = get_shape("star2d1r")
    ms, plain_ms = time_step(spec, port_layout(spec, INTERIOR), device)
    print(f"phase 2: one step at 8192^2: kernel {ms} ms, plain twin "
          f"{plain_ms} ms [{card}]", flush=True)

    launches, rel = main_path(device)
    print(f"phase 3: run(8192^2, 2 steps) bit-exact against float64 on "
          f"the card with {launches} kernel launches; 256x384 x4 rel err "
          f"{rel:.3e} <= 1e-5", flush=True)

    bench(device, card)

    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    print(json.dumps({"kernels": [{
        "name": "stencil2d_step", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_errs[1][0], "ms": ms, "plain_ms": plain_ms}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
