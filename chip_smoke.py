#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Three paths, each through ``lorastencil_tpu_torch.engine.StencilEngine`` and
its hand-written CUDA kernels:

* 2-D, the JAX package's flagship (bench.py): star2d1r, fp32-exact,
  dirichlet0, 8192^2 interior, one step per pass, through
  ``csrc/stencil2d.cu`` (replacing
  ``lorastencil_tpu/ops/pallas_2d.py::_stencil2d_kernel``);
* 3-D, the reference artifact's 3-D configurations: star3d1r and box3d1r at
  256^3, two fused steps per pass (the engine's default), through
  ``csrc/stencil3d.cu`` (replacing
  ``lorastencil_tpu/ops/pallas_3d.py::_stencil3d_kernel``): every pass the
  march kernel, the general kernel held against it;
* 1-D, the reference artifact's 1-D configurations: 1d1r 4096 x 64 (all
  steps in one cooperative launch) and 1d2r 1,000,000 x 256 (passes of
  three fused steps), through ``csrc/stencil1d.cu``, whose two kernels in
  their narrow and wide instantiations replace the four TPU kernels of
  ``lorastencil_tpu/ops/pallas_1d.py``;
* the fp64-grade tier, dtypes 'df64' and 'float64': the float64 strip
  kernel of ``csrc/stencil2d.cu`` (every 2-D step at radius <= 4 and <= 3
  terms; the float64 tile kernel beyond: replacing
  ``pallas_df64._df64_kernel``), the float64 instances of
  ``csrc/stencil1d.cu`` (narrow pass, wide pass and narrow run, replacing
  the three kernels of ``lorastencil_tpu/ops/pallas_df64_1d.py``) and
  ``csrc/stencil3d.cu`` (replacing ``pallas_df64_3d._df64_3d_kernel``:
  star3d1r and box3d1r at 256^3, the JAX DF64 tier's 3-D rows), in native
  double where the TPU computes on error-free fp32 pairs;
* 2-D temporal fusion: star2d3r at 8192^2, the artifact's configuration
  whose engine default fuses two steps per pass, through the fused strip
  kernel, which serves both ``pallas_2d._stencil2d_kernel`` at k = 2 (the
  default, extent fusion) and ``pallas_2d._stencil2d_skew_kernel``
  (``fusion='skew'``) there, and one step per pass; the tile-based fused and
  skew kernels, which run every other fused or skewed pass; and the
  whole-grid runs, one cooperative launch for all steps (replacing
  ``pallas_2d._stencil2d_resident_kernel`` in float32 and
  ``pallas_df64._resident_pair_2d_kernel`` for df64), on by default on the
  card below the H100 caps: at 512^2 the shared-memory resident kernel of
  ``csrc/resident2d.cu`` (every registry shape), and for a radius-5 spec
  at 480^2 ``csrc/stencil2d.cu``'s resident kernel.

Phases, each printing one line or more and raising on failure:

1. the card (nvidia-smi name and power limit), torch and nvcc versions;
   the four sources built from the checkout, the nvcc runs started
   together;
2. the 2-D step (the strip kernel: float32, k = 1, radius <= 4) against its
   plain PyTorch twin on the card, for star2d1r and box2d1r at an interior
   the (32, 128) tile divides, one it does not, and 8192^2: integer fill bit
   for bit at 1 and 2 steps; the fill times pi/100 within rel 1e-6 after 4
   steps (the kernel fuses multiply-adds, the twin rounds each product),
   and bit for bit against the tile kernel it replaces at k = 1 (the same
   sums); a radius-5 step, which the tile kernel runs, against its twin;
3. the 2-D path end to end: ``run`` of 2 steps at 8192^2 equal bit for bit
   to a float64 dense stencil on the card (every partial sum is an integer
   below 2**24), with exactly 2 launches of the strip kernel counted from
   zero; a 256x384 grid at 4 steps within rel 1e-5 of the fp64 ground truth
   (the CLI's float32 tolerance);
4. 256 steps at 8192^2 timed with CUDA events (warmup, best of 3) through
   ``run_internal`` and through the naive dense stencil (GStencil/s counts
   star2d1r's x3 fuse factor); one ``F.conv2d`` with the dense 7x7
   coefficients (TF32 off) as the library yardstick, and the step's bound;
5. the 3-D kernel against its twin, for star3d1r and box3d1r at (6, 20,
   150), (37, 45, 130) (the (32, 64) tile divides neither plane axis) and
   256^3, at K = 1, 2 and 4 fused steps per pass: integer fill bit for bit
   after one and two passes; pi/100 fill within rel 1e-6 after 4 steps,
   printing whether it was bit-equal (every 3-D registry tap is a power of
   two, so the two should agree bit for bit on any fill); at K = 1 and 2
   the pass runs the march kernel (each launch counted), which must also
   equal the general kernel's pass bit for bit on both fills; K = 4 runs
   the general kernel;
6. the 3-D path end to end at 256^3 for both shapes: the engine resolves
   to 'vpu' at k = 2; ``run`` of 2 steps (1 launch) and of 3 steps (2
   launches: a pass of 2 and the remainder pass of 1), every launch the
   march kernel counted from zero, each bit for bit against a float64
   dense stencil on the card; a (24, 40, 200) grid at 4 steps within rel
   1e-5 of the fp64 ground truth;
7. 64 steps at 256^3 for both shapes through ``run_internal`` (32 march
   launches) and through the naive dense stencil; the march kernel's, the
   general kernel's and the twin's time per pass, in turns; one
   ``F.conv3d`` step with the dense 3x3x3 coefficients (TF32 off); the
   pass's bound;
8. each 1-D wrapper against its twin on the card: 1d1r and 1d2r at 4096,
   3001 (a ragged tile) and 1,000,000, and the wide kernels with
   ``for_coeffs`` taps of radius 40 and 127 at 100,000; passes at k = 1, the
   engine's default k and the largest legal k, resident runs over 2*refresh
   + 3 steps (two halo reloads and a tail); the integer fill bit for bit at
   1-2 steps and after one and two full passes, the pi/100 fill within rel
   1e-6 after 4 steps (the kernels round each product and sum on their own,
   in their twins' order, so both are bit for bit; the registry taps
   overflow fp32 to inf in the deepest wide passes, where the two agree
   too);
9. the 1-D path end to end, launches counted from zero: 1d1r 4096 resolves
   to 'mxu' and one resident launch per run; 1d2r 1,000,000 to passes of
   the narrow kernel at k = 3 (``run(.., 2)`` one remainder launch,
   ``run(.., 7)`` three); algorithm 'vpu' to the wide counterparts
   (resident at 4096, passes of 2 at 1,000,000); 2 steps bit for bit
   against a float64 dense stencil on the card, 7 steps of the pi/100 fill
   within rel 1e-5;
10. 1d1r 4096 x 64, 1d2r 1,000,000 x 256 and 1d2r 16,777,216 x 256 through
   ``run_internal`` and through the naive dense stencil (GStencil/s with the
   x3 / x2 fuse factors); per kernel its device time per pass or run (a
   CUDA graph of back-to-back passes, so the host's launch cost is left
   out), its twin's, one ``F.conv1d`` step with the dense taps (TF32 off)
   and its bound; the wrapper's host time per launch with the device idle,
   and the device's idle share of the 1,000,000-cell run;
11. each fp64 kernel against its fp64 twin on the card: the 2-D float64
   strip kernel for star2d1r, box2d1r and box2d3r at 1000^2 and 8192^2,
   star2d3r at 1000^2 and star2d1r at 300 x 140 with a guard off the
   16-byte grid (8-byte copies), each step counted in ``launches_k1`` and
   bit for bit against the float64 tile kernel and the twin on the integer,
   pi/100 and inf fills; the 1-D instances
   for 1d1r and 1d2r at 4096, 3001 and 16,777,216 and ``for_coeffs`` taps
   of radius 40 and 127 at 100,000 (passes at k = 1, 2 and the largest k
   whose window fits shared memory in fp64, runs over 2*refresh + 3 steps
   where the grid's blocks can all be resident); the integer fill bit for
   bit at 1-2 steps, the pi/100 fill's relative error after 4 steps
   printed beside its limit 1e-13 (the fp64 kernels round each product
   and sum on their own, in their twins' order: it should be 0);
12. each fp64 engine path, for 'df64' and for 'float64', launches counted
   from zero over the phase: star2d1r 8192^2 and box2d3r 4096^2 (every
   step a float64 strip launch, counted in ``df64_step`` and
   ``stencil2d_k1``), 1d1r 4096 (the narrow run), 1d2r 16,777,216 (narrow passes,
   k = 1 in df64 and 2 in float64), ``for_coeffs`` r = 40 at 100,000 (wide
   passes) and, float64 only, at 3001 (the wide run); ``run(.., 2)`` of the
   integer fill bit for bit against a float64 dense stencil on the card,
   ``run(.., 4)`` of the pi/100 fill within rel 1e-13 of it;
13. df64 star2d1r 8192^2 x 32, box2d3r 4096^2 x 32, 1d1r 4096 x 64 and
   1d2r 16,777,216 x 256 through ``run_internal`` and through the naive
   dense stencil in float64 (GStencil/s, vs_baseline; the 2-D runs' 32
   launches counted, every one a float64 strip launch); per fp64 kernel its
   device time, its twin's, one float64 ``F.conv2d`` / ``F.conv1d`` step
   (the library yardstick) and its bound: 8-byte cells over the memory
   rate, or the operations over the card's fp64 CUDA-core rate; the 2-D
   step at star2d1r 8192^2 and box2d3r 4096^2, each beside the float64
   tile kernel it replaces, timed in turns;
14. the wrappers' fused (#1 at k = 2 and 3) and skewed (#2) passes against
   single-step launches of the 2-D kernel (bit for bit on any fill: they
   share its per-cell sums) and against their twins (the 0/1 fill bit for
   bit over k steps, the pi/100 fill within rel 1e-5 in float32 and 1e-13
   in float64 after 2k steps): star2d3r at 1000^2, 8192^2 and 300 x 140
   (k = 2: in float32 the fused strip kernel from both wrappers, every
   launch counted, also bit for bit against the tile-based fused and skew
   kernels it replaces), box2d1r at 1000^2 (k = 3), star2d1r at 300 x 140
   (ragged, two skew chunks), float32 and float64; the whole-grid runs
   (``stencil2d_resident``: the shared-memory resident kernel, each run
   counted in ``launches_smem``) in float32 (star2d1r, box2d3r at 512^2,
   star2d3r at 300 x 140) and float64 (star2d1r at 512^2, box2d3r at 300 x
   140), whose rectangles do not divide the grid evenly, bit for bit against
   single-step launches, ``csrc/stencil2d.cu``'s resident kernel and the
   twin (the integer fill at 1-2 steps; the pi/100
   fill at 4 steps within rel 1e-5 in float32 and 1e-13 in float64 of the
   fp64 ground truth);
15. each fused path end to end, launches counted from zero: star2d3r
   8192^2 with the defaults (extent, k = 2: 32 fused strip launches and no
   tile-based fused one), ``fusion='skew'`` (the same through the skew
   wrapper) and ``fused_steps=1``; star2d1r and box2d3r 512^2 and df64
   star2d1r 512^2 under the default caps (one shared-memory resident
   run), and a radius-5 spec (an 11 x 11 box of ones, one term) at 480^2 in
   float32 and df64 (one run of ``csrc/stencil2d.cu``'s resident kernel);
   ``run(.., 3)`` (2 at 512^2)
   of the integer fill bit for bit against a float64 dense stencil on the
   card,
   ``run(.., 4)`` of the pi/100 fill within rel 1e-5 (df64 1e-13), and 64
   steps that must launch 32 fused passes, 32 skewed passes, 64 steps, or
   one resident run, and no other kernel;
16. star2d3r 8192^2 x 64 through ``run_internal`` in the three modes and
   through the naive dense stencil; the k = 2 pass through each wrapper
   (the fused strip kernel), the tile-based fused and skew kernels it
   replaces and two strip steps, timed in turns, beside the twin's time,
   one ``F.conv2d`` 7x7 step (TF32 off) and the bound; the whole-grid
   runs: ``run_internal`` x 64, tiled against resident (CUDA events), for
   star2d1r and box2d3r at 256^2, 512^2, 1024^2 and the largest grid the
   kernel's capacity takes, float32 and df64, and from them the H100
   default caps (the largest internal buffer at which the resident run won
   at every measured size below it); the shared-memory resident kernel's
   64-step run at 512^2 (star2d1r, box2d3r, star2d3r, both dtypes), 1024^2
   and a 64 x 128 interior (one small rectangle per block: the handshake
   floor, the 64-step run less the 1-step run) beside
   ``csrc/stencil2d.cu``'s resident kernel, in turns (CUDA graphs);
   the radius-5 runs on ``csrc/stencil2d.cu``'s kernel;
17. the 3-D kernel's float64 instance against its float64 twin, for
   star3d1r and box3d1r at (37, 45, 130) and 256^3, K = 1 and 2 (the march
   kernel, each launch counted, bit for bit against the general kernel's
   pass on both fills): the integer fill bit for bit against the twin and
   a float64 dense stencil on the card after one and two passes, the
   pi/100 fill's relative error after 4 steps beside its limit 1e-13 (it
   should be 0: no FMA in fp64);
18. the 3-D fp64 engine paths at 256^3, launches of the float64 instance
   and of the march kernel counted from zero over the phase, every pass
   the march kernel: 'df64' ('vpu_sep', one step per pass) and 'float64'
   (passes of k = 2) for both shapes, ``run(.., 2)`` of the integer fill
   bit for bit against a float64 dense stencil on the card and ``run(..,
   4)`` of the pi/100 fill within rel 1e-13 of it;
19. df64 (64 launches) and float64 (32) 256^3 x 64 through
   ``run_internal`` and the naive dense stencil in float64; the march
   kernel's float64 device time per df64 pass beside the general kernel's
   and the twin's, and per float64 k = 2 pass beside two k = 1 passes and
   the general kernel's k = 2 pass (each set in turns); one float64
   ``F.conv3d`` 3x3x3 step and the pass's byte bound;
20. the kernels redesigned for Hopper, each with its registers and
   spills from ptxas (the strip kernel and its float64 counterpart, the
   fused strip kernel, the wide 1-D pass, the 3-D march kernel, the
   shared-memory resident kernel, with its source's build time), failing
   on any spill: the 2-D strip kernel's step at star2d1r 8192^2 beside the
   tile kernel it replaces (timed in turns), its twin, ``F.conv2d``, its
   byte bound and its share of it; the float64 strip kernel's df64 steps
   at star2d1r 8192^2 and box2d3r 4096^2 beside the float64 tile kernel
   (phase 13) and their share of the byte bound; the march kernel's float32 k = 2, df64 and float64 k = 2 passes
   at 256^3 beside the general kernel (phases 7 and 19) and their share of
   the byte bound; the wide 1-D pass at float64 r = 40 x 100,000 and
   float32 1d2r 1,000,000 (k = 2), and at float64 r = 40 x 16,777,216 (134
   MB a buffer), each beside one ``F.conv1d`` step, its bound and its
   share of it.

It then prints the kernels' JSON record and, last, the device record.  It
needs one CUDA device and exits non-zero without one.  Neither JAX nor any
part of ``lorastencil_tpu`` is imported: the port carries its own stencil
registry and fp64 ground truth, and the script fails if either package
was loaded.
"""

import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

INTERIOR = (8192, 8192)
BENCH_STEPS = 256
INTERIOR_3D = (256, 256, 256)
BENCH_STEPS_3D = 64
SOURCES = {"stencil2d": "lorastencil_tpu_torch/csrc/stencil2d.cu",
           "stencil3d": "lorastencil_tpu_torch/csrc/stencil3d.cu",
           "stencil1d": "lorastencil_tpu_torch/csrc/stencil1d.cu",
           "resident2d": "lorastencil_tpu_torch/csrc/resident2d.cu"}
REPLACES = {"stencil2d": "lorastencil_tpu/ops/pallas_2d.py:127",
            "stencil2d_skew": "lorastencil_tpu/ops/pallas_2d.py:686",
            "stencil2d_resident": "lorastencil_tpu/ops/pallas_2d.py:981",
            "stencil2d_resident_pair": "lorastencil_tpu/ops/pallas_df64.py:609",
            "df64_step": "lorastencil_tpu/ops/pallas_df64.py:419",
            "df64_1d_step": "lorastencil_tpu/ops/pallas_df64_1d.py:135",
            "df64_1d_flat_step": "lorastencil_tpu/ops/pallas_df64_1d.py:312",
            "stencil1d_resident_pair":
                "lorastencil_tpu/ops/pallas_df64_1d.py:475",
            "df64_3d_step": "lorastencil_tpu/ops/pallas_df64_3d.py:276",
            "stencil3d": "lorastencil_tpu/ops/pallas_3d.py:118",
            "stencil1d_lanes_step": "lorastencil_tpu/ops/pallas_1d.py:348",
            "stencil1d_step": "lorastencil_tpu/ops/pallas_1d.py:97",
            "stencil1d_resident_lanes": "lorastencil_tpu/ops/pallas_1d.py:600",
            "stencil1d_resident": "lorastencil_tpu/ops/pallas_1d.py:542"}
KERNELS_1D = ("stencil1d_lanes_step", "stencil1d_step",
              "stencil1d_resident_lanes", "stencil1d_resident")
# the JAX df64 kernels -> the port's wrapper whose float64 instance replaces
# each (a wrapper counts its float32 and float64 launches apart)
KERNELS_FP64_1D = {"df64_1d_step": "stencil1d_lanes_step",
                   "df64_1d_flat_step": "stencil1d_step",
                   "stencil1d_resident_pair": "stencil1d_resident_lanes"}
KERNELS_FP64 = ("df64_step",) + tuple(KERNELS_FP64_1D)
N_1D = 1_000_000
N_1D_LARGE = 16_777_216
N_1D_SMALL = 4096
# NVIDIA H100 SXM data sheet, at the full 700 W power limit: HBM3, fp32 and
# fp64 on CUDA cores (fp64 on the tensor cores is 67 TFLOP/s, which the fp64
# kernels do not use)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _counters():
    """{kernel: (wrapper, the attribute that counts its launches)}: float32
    instances count in ``launches``, float64 ones in ``launches_f64`` (the
    wide run's float64 instance, which replaces no df64 kernel, as
    "stencil1d_resident_f64"; the 2-D resident run's float64 instance as
    "stencil2d_resident_pair", the kernel it replaces; the shared-memory
    resident kernel's runs, in either dtype, in "stencil2d_resident_smem"
    too).  The fused 2-D
    kernel counts with the step kernel it extends, as "stencil2d"; the
    strip kernels' steps count in "stencil2d_k1" too, beside "stencil2d"
    (float32) or "df64_step" (float64); the fused strip kernel's passes in
    the wrapper's own
    count and in "stencil2d_fused_strip" (from ``stencil2d_step``) or
    "stencil2d_skew_fused_strip" (from ``stencil2d_skew_step``); the 3-D
    march kernel's passes in "stencil3d" (float32) or "df64_3d_step"
    (float64) and in "stencil3d_march"."""
    from lorastencil_tpu_torch.ops import stencil1d, stencil2d, stencil3d

    out = {"stencil2d": (stencil2d.stencil2d_step, "launches"),
           "stencil2d_k1": (stencil2d.stencil2d_step, "launches_k1"),
           "stencil2d_fused_strip": (stencil2d.stencil2d_step,
                                     "launches_fused_strip"),
           "stencil2d_skew_fused_strip": (stencil2d.stencil2d_skew_step,
                                          "launches_fused_strip"),
           "stencil3d": (stencil3d.stencil3d_step, "launches"),
           "df64_3d_step": (stencil3d.stencil3d_step, "launches_f64"),
           "stencil3d_march": (stencil3d.stencil3d_step, "launches_march"),
           "df64_step": (stencil2d.stencil2d_step, "launches_f64"),
           "stencil2d_skew": (stencil2d.stencil2d_skew_step, "launches"),
           "stencil2d_skew_f64": (stencil2d.stencil2d_skew_step,
                                  "launches_f64"),
           "stencil2d_resident": (stencil2d.stencil2d_resident, "launches"),
           "stencil2d_resident_pair": (stencil2d.stencil2d_resident,
                                       "launches_f64"),
           "stencil2d_resident_smem": (stencil2d.stencil2d_resident,
                                       "launches_smem"),
           "stencil1d_resident_f64": (stencil1d.stencil1d_resident,
                                      "launches_f64")}
    out.update({name: (getattr(stencil1d, name), "launches")
                for name in KERNELS_1D})
    out.update({name: (getattr(stencil1d, wrapper), "launches_f64")
                for name, wrapper in KERNELS_FP64_1D.items()})
    return out


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def build_kernels():
    """Phase 1's builds, the nvcc runs at once; returns {name: (seconds,
    ptxas register lines, the compiler's log)}."""
    from lorastencil_tpu_torch.ops import _cuda_build

    def one(name):
        t0 = time.perf_counter()
        lib = _cuda_build.build(name)
        secs = time.perf_counter() - t0
        with open(lib + ".log") as f:
            log = f.read().splitlines()
        ptxas = [ln.strip() for ln in log if "registers" in ln
                 or "spill" in ln]
        return secs, ptxas, log

    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futs = {name: pool.submit(one, name) for name in SOURCES}
        return {name: fut.result() for name, fut in futs.items()}


def port_layout(spec, interior):
    from lorastencil_tpu_torch.ops.layout import (Layout2D, default_tile_2d,
                                                  guard_2d)

    return Layout2D(interior=interior, halo=spec.halo,
                    tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, spec.radius))


def port_layout_3d(spec, interior, K):
    from lorastencil_tpu_torch.ops.layout import (Layout3D, default_tile_3d,
                                                  guard_3d)

    return Layout3D(interior=interior, halo=spec.halo,
                    tile=default_tile_3d(*interior[1:]),
                    guard=guard_3d(spec.halo, K * spec.radius))


def run_steps(step, x, spec, lay, steps, k=1):
    """``steps`` timesteps of a kernel wrapper or its twin in passes of
    ``k``, with the engine's donor rotation."""
    from lorastencil_tpu_torch.engine import ping_pong_loop

    def one(cur, donor, depth):
        kw = {"fused_steps": depth} if depth > 1 else {}
        return step(cur, donor, spec, lay, **kw)

    return ping_pong_loop(one, x, steps, k)


def check_kernel(name, interior, device):
    """Phase 2 for one shape and size; returns the max abs and rel errors
    of the pi/100 fill after 1 and 4 steps.  The step runs the strip kernel,
    which must also equal the tile kernel's step bit for bit."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d
    from lorastencil_tpu_torch.utils import reference

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
    if not stencil2d.strip_takes(spec, x.dtype):
        raise AssertionError(f"{name}: the step does not take the strip kernel")
    tile = torch.zeros_like(x)
    stencil2d._launch("step", (x, tile), spec, lay, 1)
    strip = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay)
    torch.cuda.synchronize()
    if not torch.equal(strip, tile):
        bad = (strip != tile).sum().item()
        raise AssertionError(f"{name} {interior}: the strip kernel differs "
                             f"from the tile kernel at {bad} cells (pi/100)")
    del tile, strip
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


def check_wide_radius(device):
    """Phase 2: a radius-5 step (beyond the strip kernel's radii: the tile
    kernel) against its twin on the integer fill at 1-2 steps; returns its
    launches of the tile kernel (1 per step, none of the strip kernel)."""
    from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec
    from lorastencil_tpu_torch.ops import stencil2d
    from lorastencil_tpu_torch.utils import reference

    ones = (1.0,) * 11
    spec = StencilSpec(name="box2d5r", ndim=2, radius=5, halo=(5, 5),
                       terms=(SeparableTerm(taps=(ones, ones)),),
                       residue=(((0, 5), 1.0), ((-5, -2), -1.0)),
                       fuse_factor=1)
    interior = (300, 140)
    lay = port_layout(spec, interior)
    x = lay.to_internal(reference.random_padded(spec, interior, seed=4),
                        device=device)
    reset_counts()
    for steps in (1, 2):
        got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
        want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"radius 5 {interior}: the tile kernel "
                                 f"differs from its twin after {steps} steps")
    launched = counts()
    if (launched["stencil2d"], launched["stencil2d_k1"]) != (3, 0):
        raise AssertionError(f"radius 5 steps launched {launched}")
    return launched["stencil2d"]


def time_calls(fns, x, donor, calls):
    """Per-call device ms of each ``fn(x, donor)`` in ``fns`` (a dict),
    timed in turns fns..., then the same again reversed, best of the
    two."""
    from lorastencil_tpu_torch.utils import metrics

    def loop(fn):
        for _ in range(calls):
            fn(x, donor)

    order = list(fns) + list(reversed(list(fns)))
    ms = {}
    for name in order:
        secs, _ = metrics.time_run(loop, fns[name], repeats=3, warmup=1)
        ms[name] = min(ms.get(name, float("inf")), secs / calls * 1e3)
    return ms


def time_step(spec, lay, device, calls=20):
    """Per-call device ms of the 2-D step (the strip kernel), of the tile
    kernel it replaces at k = 1 and of its plain twin, one step each, at the
    layout's shape (uniform [0, 0.01) fill), timed in turns."""
    from lorastencil_tpu_torch.ops import stencil2d

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(lay.shape, generator=gen, device=device) * 0.01
    ms = time_calls({
        "plain": lambda a, b: stencil2d.stencil2d_step_plain(a, b, spec,
                                                             lay),
        "kernel": lambda a, b: stencil2d.stencil2d_step(a, b, spec, lay),
        "tile": lambda a, b: stencil2d._launch("step", (a, b), spec, lay,
                                               1)},
        x, torch.zeros_like(x), calls)
    return ms["kernel"], ms["plain"], ms["tile"]


def main_path(device):
    """Phase 3: the 2-D path end to end at 8192^2; returns the launch
    counts of ``run`` and the small grid's rel err."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape("star2d1r")
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device=device)
    if eng.algorithm != "mxu_hybrid1" or eng.backend != "pallas":
        raise AssertionError(f"main path resolved to {eng.algorithm}/"
                             f"{eng.backend}")
    g0 = reference.random_padded(spec, INTERIOR, seed=0)
    want = torch.from_numpy(g0).to(device)  # float64
    for _ in range(2):
        want = torch_ref.dense_step(want, spec)
    reset_counts()
    out = eng.run(g0, 2)
    torch.cuda.synchronize()
    launches = counts()
    if (launches["stencil2d"], launches["stencil2d_k1"]) != (2, 2):
        raise AssertionError(f"2-D path launched its kernel "
                             f"{launches['stencil2d']} times, the strip "
                             f"kernel {launches['stencil2d_k1']}, for 2 "
                             f"steps")
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


def count_run(eng, state, steps, kernel, expect):
    """Launches of ``kernel`` in one untimed ``run_internal`` of ``steps``
    steps, counted from zero; raises unless it is ``expect``."""
    reset_counts()
    eng.run_internal(state, steps)
    torch.cuda.synchronize()
    got = counts()[kernel]
    if got != expect:
        raise AssertionError(f"{steps} steps launched {kernel} {got} times,"
                             f" expected {expect}")
    return got


def sum_ops(weights) -> int:
    """The fewest operations of one weighted sum {offset: weight} per cell:
    an add to join each nonzero term after the first, and a multiply per
    weight that is not +-1, an equal (+o, -o) pair added first and
    multiplied once."""
    nz = {tuple(o): w for o, w in weights.items() if w != 0.0}
    muls = 0
    for o, w in nz.items():
        neg = tuple(-x for x in o)
        if abs(w) != 1.0 and not (neg < o and nz.get(neg) == w):
            muls += 1
    return max(len(nz) - 1, 0) + muls


def step_flops(spec) -> int:
    """Operations per cell of one step, the fewest the function needs: in
    1-D one sum over the dense taps; otherwise the separable form, a sum
    per axis of every term, the residue's sum, and an add to join each
    term and the residue."""
    def axis(taps):
        r = (len(taps) - 1) // 2
        return {(d - r,): float(w) for d, w in enumerate(taps)}

    if spec.ndim == 1:
        return sum_ops(axis(spec.dense_coeffs()))
    ops = sum(sum_ops(axis(taps)) for term in spec.terms
              for taps in term.taps if taps is not None)
    parts = len(spec.terms) + (1 if spec.residue else 0)
    return ops + sum_ops(dict(spec.residue)) + max(parts - 1, 0)


def bound_parts(spec, interior, steps_per_pass, itemsize=4):
    """(bytes ms, operations ms) of one pass: each input cell read once and
    each output cell written once (``itemsize`` bytes: 4 in float32, 8 in
    float64) over the memory rate; its operations over the fp32 or fp64
    rate."""
    cells = int(np.prod(interior))
    t_bytes = 2 * itemsize * cells / PEAK_BYTES_PER_S
    t_ops = cells * steps_per_pass * step_flops(spec) / (
        PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS)
    return t_bytes * 1e3, t_ops * 1e3


def bound_ms(spec, interior, steps_per_pass, itemsize=4):
    """Least time of one pass, the larger of ``bound_parts``, and which it
    is."""
    t_bytes, t_ops = bound_parts(spec, interior, steps_per_pass, itemsize)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_ms(spec, interior, device, dtype=torch.float32):
    """One cuDNN convolution with the dense coefficients (TF32 off) on
    the interior and a radius-deep margin, in ``dtype``: one step of the
    same function (cross-correlation, as the stencil is).  The port never
    calls it."""
    import torch.nn.functional as F

    from lorastencil_tpu_torch.utils import metrics

    r = spec.radius
    w = torch.tensor(spec.dense_coeffs(), dtype=dtype, device=device)[None,
                                                                      None]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, 1) + tuple(s + 2 * r for s in interior),
                   generator=gen, device=device, dtype=dtype) * 0.01
    conv = F.conv3d if spec.ndim == 3 else F.conv2d
    secs, out = metrics.time_run(lambda: conv(x, w), repeats=3, warmup=1)
    if tuple(out.shape[2:]) != tuple(interior):
        raise AssertionError(f"library conv gave {tuple(out.shape)}")
    return secs * 1e3


def bench(device, card):
    """Phase 4: 2-D kernel path and naive dense stencil, 256 steps each.
    Values grow 100x per step and overflow to inf/NaN after ~20 steps of
    the [0, 0.01) fill; fp32 arithmetic on inf/NaN runs at the same speed
    on this card, so the times stand (correctness is phases 2-3)."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
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
    launches = count_run(eng, state, BENCH_STEPS, "stencil2d", BENCH_STEPS)
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
          f"; {launches} launches per {BENCH_STEPS}-step run [{card}]",
          flush=True)
    return res, base


def general_3d(x, spec, lay, K, out=None):
    """One pass of the general 3-D kernel (``stencil3d_kernel``), which the
    march kernel replaces at K <= 2: the launch ``stencil3d_step`` makes for
    a pass ``march_takes`` refuses."""
    from lorastencil_tpu_torch.ops import stencil3d

    out = torch.zeros_like(x) if out is None else out
    return stencil3d._launch(x, out, spec, lay, K, stencil3d.plan_pass(
        spec, K, x.element_size())[1])


def check_kernel_3d(name, interior, K, device):
    """Phase 5 for one shape, size and depth; returns (abs err, rel err,
    bit-equal) of the pi/100 fill after 4 steps.  At K <= 2 the pass runs
    the march kernel, which must also equal the general kernel's pass bit
    for bit on both fills."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil3d
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = port_layout_3d(spec, interior, K)
    g0 = reference.random_padded(spec, interior, seed=1)
    x = lay.to_internal(g0, device=device)
    march = stencil3d.march_takes(spec, torch.float32, K)
    for passes in (1, 2):
        before = stencil3d.stencil3d_step.launches_march
        got = run_steps(stencil3d.stencil3d_step, x, spec, lay, passes * K, K)
        if stencil3d.stencil3d_step.launches_march - before != (
                passes if march else 0):
            raise AssertionError(f"{name} {interior} K={K}: march launches")
        want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay,
                         passes * K, K)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(
                f"{name} {interior} K={K}: kernel differs from its twin at "
                f"{bad} cells after {passes} passes (integer fill)")
    for fill in ((g0, g0 * (np.pi / 100)) if march else ()):
        x1 = lay.to_internal(fill, device=device)
        got = stencil3d.stencil3d_step(x1, torch.zeros_like(x1), spec, lay,
                                       fused_steps=K)
        if not torch.equal(got, general_3d(x1, spec, lay, K)):
            raise AssertionError(f"{name} {interior} K={K}: the march kernel "
                                 f"differs from the general kernel")
    x = lay.to_internal(g0 * (np.pi / 100), device=device)
    got = run_steps(stencil3d.stencil3d_step, x, spec, lay, 4, K)
    want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay, 4, K)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {interior} K={K}: non-finite output")
    abs_err = (got - want).abs().max().item()
    rel = abs_err / want.abs().max().item()
    if rel > 1e-6:
        raise AssertionError(
            f"{name} {interior} K={K}: rel err {rel:.3e} > 1e-6 after 4 "
            f"steps (pi/100 fill)")
    return abs_err, rel, bool(torch.equal(got, want))


def main_path_3d(name, device):
    """Phase 6 for one shape: returns the launch counts of ``run`` at 2
    and 3 steps and the small grid's rel err."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    eng = engine.StencilEngine.for_shape(name, INTERIOR_3D, device=device)
    if (eng.algorithm, eng.backend, eng._fused_k()) != ("vpu", "pallas", 2):
        raise AssertionError(
            f"{name} resolved to {eng.algorithm}/{eng.backend} at "
            f"k={eng._fused_k()}")
    g0 = reference.random_padded(spec, INTERIOR_3D, seed=0)
    want = torch_ref.dense_step(torch.from_numpy(g0).to(device), spec)
    launches = {}
    for steps, expect in ((2, 1), (3, 2)):
        want = torch_ref.dense_step(want, spec)  # float64, `steps` steps
        reset_counts()
        out = eng.run(g0, steps)
        torch.cuda.synchronize()
        launches[steps] = counts()
        if (launches[steps]["stencil3d"],
                launches[steps]["stencil3d_march"]) != (expect, expect):
            raise AssertionError(
                f"{name}: run({steps}) launched the 3-D kernel "
                f"{launches[steps]['stencil3d']} times, the march kernel "
                f"{launches[steps]['stencil3d_march']}, expected {expect}")
        if tuple(out.shape) != spec.padded_shape(INTERIOR_3D):
            raise AssertionError(f"{name}: output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output is not finite")
        if not torch.equal(out.double(), want):
            bad = (out.double() != want).sum().item()
            raise AssertionError(
                f"{name}: run({steps}) differs from the float64 dense "
                f"stencil at {bad} cells")
        del out
    del want

    small = (24, 40, 200)
    g1 = reference.random_padded(spec, small, seed=2)
    want = reference.run(g1, spec, 4)
    got = engine.StencilEngine.for_shape(name, small, device=device).run(g1,
                                                                         4)
    rel = (np.abs(got.cpu().numpy().astype(np.float64) - want).max()
           / np.abs(want).max())
    if not rel <= 1e-5:
        raise AssertionError(f"{name} {small} x4: rel err {rel:.3e} > 1e-5")
    return launches, rel


def bench_3d(name, device, card):
    """Phase 7 for one shape: 64 steps through ``run_internal`` and
    through the naive dense stencil; the kernel's (the march kernel), the
    general kernel's and the twin's ms per pass at the engine's k, in
    turns; returns the GStencil/s records and the per-pass times."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil3d, torch_ref
    from lorastencil_tpu_torch.utils import metrics

    spec = get_shape(name)
    eng = engine.StencilEngine.for_shape(name, INTERIOR_3D, device=device)
    k, lay = eng._fused_k(), eng.layout
    gen = torch.Generator(device=device).manual_seed(0)
    state = torch.rand(lay.shape, generator=gen, device=device) * 0.01
    secs, _ = metrics.time_run(eng.run_internal, state, BENCH_STEPS_3D,
                               repeats=3, warmup=1)
    res = metrics.bench_result(spec, INTERIOR_3D, BENCH_STEPS_3D, secs,
                               "cuda-stencil3d", "fp32-exact", 3)
    launches = count_run(eng, state, BENCH_STEPS_3D, "stencil3d_march",
                         BENCH_STEPS_3D // k)
    ms = time_calls({
        "plain": lambda a, b: stencil3d.stencil3d_step_plain(
            a, b, spec, lay, fused_steps=k),
        "kernel": lambda a, b: stencil3d.stencil3d_step(
            a, b, spec, lay, fused_steps=k),
        "general": lambda a, b: general_3d(a, spec, lay, k, b)},
        state, torch.zeros_like(state), calls=10)
    del state
    grid = torch.rand(spec.padded_shape(INTERIOR_3D), generator=gen,
                      device=device) * 0.01

    def naive(g):
        for _ in range(BENCH_STEPS_3D):
            g = torch_ref.dense_step(g, spec)
        return g

    bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
    base = metrics.bench_result(spec, INTERIOR_3D, BENCH_STEPS_3D, bsecs,
                                "torch-naive", "fp32", 3)
    del grid
    dims = "x".join(str(s) for s in INTERIOR_3D)
    for label, r in (("kernel", res), ("naive", base)):
        print(f"phase 7: {label} {name} {dims} x{BENCH_STEPS_3D}: "
              f"{r.time_ms} ms, {r.gstencil_per_s} GStencil/s [{card}]",
              flush=True)
    print(f"phase 7: {name} vs_baseline "
          f"{res.gstencil_per_s / base.gstencil_per_s}; {launches} march "
          f"launches per {BENCH_STEPS_3D}-step run; one pass of k={k} "
          f"steps: march kernel {ms['kernel']} ms, the general kernel it "
          f"replaces {ms['general']} ms, plain twin {ms['plain']} ms "
          f"[{card}]", flush=True)
    return res, base, ms["kernel"], ms["plain"], ms["general"]


def spec_1d(name):
    """A registry 1-D shape, or ``for_coeffs`` taps "r40" / "r127": integers
    in [-3, 3] over 256, whose sum of magnitudes (~1.7) keeps values finite
    over the deepest passes."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape

    if name.startswith("r"):
        r = int(name[1:])
        taps = np.random.default_rng(r).integers(-3, 4, 2 * r + 1) / 256.0
        taps[0] = taps[-1] = 1.0 / 256.0  # effective radius r
        return engine.StencilEngine.for_coeffs(taps, (64,), name=name,
                                               device="cpu").spec
    return get_shape(name)


def layout_1d(spec, n, reach):
    from lorastencil_tpu_torch.ops.layout import TILE_1D, Layout1D, guard_1d

    return Layout1D(interior=n, halo=spec.halo[0], tile=TILE_1D,
                    guard=guard_1d(spec.halo[0], reach))


def check_kernels_1d(name, n, device):
    """Phase 8 for one spec and size: every wrapper that takes the spec
    against its twin; returns {kernel: max abs err of the pi/100 fill after
    4 steps at the engine's k (runs: 2*refresh + 3 steps)}."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=1)
    cases = [("stencil1d_step", s1.stencil1d_step_plain, (1, 2, s1.MAX_FUSED))]
    runs = [("stencil1d_resident", s1.stencil1d_resident_plain, 1)]
    if r <= s1.MAX_LANES_REACH:
        cases.append(("stencil1d_lanes_step", s1.stencil1d_lanes_step_plain,
                      (1, max(1, 12 // r), s1.MAX_LANES_REACH // r)))
        runs.append(("stencil1d_resident_lanes",
                     s1.stencil1d_resident_lanes_plain, s1.lanes_refresh(r)))
    errs = {}

    def agree(got, want, what):
        torch.cuda.synchronize()
        if bool(torch.isnan(want).any()):
            raise AssertionError(f"{what}: the twin gave NaN")
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{what}: kernel differs from its twin at "
                                 f"{bad} cells")
        return (got - want).abs().max().item()

    for kernel, plain, ks in cases:
        wrapper = getattr(s1, kernel)
        for k in sorted(set(ks)):
            lay = layout_1d(spec, n, k * r)
            x = lay.to_internal(g0, device=device)
            for steps in sorted({1, 2, k, 2 * k}):
                agree(run_steps(wrapper, x, spec, lay, steps, k),
                      run_steps(plain, x, spec, lay, steps, k),
                      f"{kernel} {name} {n} k={k} x{steps} (integer fill)")
            x = lay.to_internal(g0 * (np.pi / 100), device=device)
            err = agree(run_steps(wrapper, x, spec, lay, 4, k),
                        run_steps(plain, x, spec, lay, 4, k),
                        f"{kernel} {name} {n} k={k} x4 (pi/100 fill)")
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    for kernel, plain, refresh in runs:
        wrapper = getattr(s1, kernel)
        lay = layout_1d(spec, n, refresh * r)
        for fill, steps_list in ((g0, (1, 2, 2 * refresh + 3)),
                                 (g0 * (np.pi / 100), (4, 2 * refresh + 3))):
            x = lay.to_internal(fill, device=device)
            keep = x.clone()
            for steps in steps_list:
                err = agree(wrapper(x, spec, lay, steps),
                            plain(x, spec, lay, steps),
                            f"{kernel} {name} {n} x{steps}")
                if fill is not g0:
                    errs[kernel] = max(errs.get(kernel, 0.0), err)
            if not torch.equal(x, keep):
                raise AssertionError(f"{kernel} wrote its input")
    return errs


def main_path_1d(device):
    """Phase 9: the 1-D path end to end; returns the launches of each 1-D
    kernel over the phase, counted from zero, and a line per case."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    cases = (("1d1r", N_1D_SMALL, {}, "mxu", "resident_lanes",
              "stencil1d_resident_lanes", 4, (1, 1)),
             ("1d2r", N_1D, {}, "mxu", "lanes", "stencil1d_lanes_step", 3,
              (1, 3)),
             ("1d1r", N_1D_SMALL, {"algorithm": "vpu"}, "vpu", "resident",
              "stencil1d_resident", 2, (1, 1)),
             ("1d2r", N_1D, {"algorithm": "vpu"}, "vpu", "flat",
              "stencil1d_step", 2, (1, 4)))
    lines = []
    reset_counts()
    for name, n, kw, alg, path, kernel, k, expect in cases:
        eng = engine.StencilEngine.for_shape(name, (n,), device=device, **kw)
        got = (eng.algorithm, eng.path, eng._fused_k())
        if got != (alg, path, k):
            raise AssertionError(f"{name} {n} {kw} resolved to {got}")
        spec = eng.spec
        g0 = reference.random_padded(spec, (n,), seed=0)
        for steps, want_launches in zip((2, 7), expect):
            fill = g0 if steps == 2 else g0 * (np.pi / 100)
            want = torch.from_numpy(fill).to(device)  # float64
            for _ in range(steps):
                want = torch_ref.dense_step(want, spec)
            before = counts()
            out = eng.run(fill, steps)
            torch.cuda.synchronize()
            launched = {key: v - before[key] for key, v in counts().items()
                        if v != before[key]}
            if launched != {kernel: want_launches}:
                raise AssertionError(f"{name} {n} {kw} run({steps}) "
                                     f"launched {launched}")
            if tuple(out.shape) != spec.padded_shape((n,)):
                raise AssertionError(f"output shape {tuple(out.shape)}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} {n}: output is not finite")
            if steps == 2 and not torch.equal(out.double(), want):
                bad = (out.double() != want).sum().item()
                raise AssertionError(
                    f"{name} {n} {kw}: run(2) differs from the float64 "
                    f"dense stencil at {bad} cells")
            rel = ((out.double() - want).abs().max()
                   / want.abs().max()).item()
            if not rel <= 1e-5:
                raise AssertionError(f"{name} {n} {kw}: run({steps}) rel "
                                     f"err {rel:.3e} > 1e-5")
            lines.append(f"{name} {n} {kw or ''} -> {alg}/{path} k={k}: "
                         f"run({steps}) {launched[kernel]} launch(es) of "
                         f"{kernel}, rel err {rel:.3e}")
    launches = counts()
    for kernel in KERNELS_1D:
        if launches[kernel] == 0:
            raise AssertionError(f"the 1-D path never launched {kernel}")
    return {kernel: launches[kernel] for kernel in KERNELS_1D}, lines


def graph_ms(fn, calls=20):
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed (best of 3), so the host's launch work is left out."""
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


def host_us_per_launch(fn, calls=200):
    """Median wall time of one call of ``fn`` with the device idle before
    it (synchronized), in microseconds."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def conv1d_ms(spec, n, device, dtype=torch.float32):
    """One cuDNN ``F.conv1d`` step with the dense taps (TF32 off) on the
    interior and a radius-deep margin, in ``dtype``, device ms (a CUDA
    graph of 20)."""
    import torch.nn.functional as F

    from lorastencil_tpu_torch.ops import stencil1d as s1

    taps = s1.dense_taps(spec)
    w = torch.tensor(taps, dtype=dtype, device=device)[None, None]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, 1, n + len(taps) - 1), generator=gen, device=device,
                   dtype=dtype) * 0.01
    if tuple(F.conv1d(x, w).shape) != (1, 1, n):
        raise AssertionError("library conv1d has the wrong shape")
    return graph_ms(lambda: F.conv1d(x, w))


def bench_1d(device, card):
    """Phase 10: the three 1-D configurations through ``run_internal`` and
    the naive dense stencil, and per kernel its device time, its twin's,
    the library step and the bound; returns the kernels' timing records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    runs = {}
    for name, n, steps in (("1d1r", N_1D_SMALL, 64), ("1d2r", N_1D, 256),
                           ("1d2r", N_1D_LARGE, 256)):
        eng = engine.StencilEngine.for_shape(name, (n,), device=device)
        state = torch.rand(eng.layout.shape, generator=gen,
                           device=device) * 0.01
        secs, _ = metrics.time_run(eng.run_internal, state, steps,
                                   repeats=3, warmup=1)
        res = metrics.bench_result(eng.spec, (n,), steps, secs,
                                   "cuda-stencil1d", "fp32-exact", 3)
        kernel = ("stencil1d_resident_lanes" if eng.path == "resident_lanes"
                  else "stencil1d_lanes_step")
        launches = count_run(eng, state, steps, kernel,
                             1 if eng.path == "resident_lanes"
                             else -(-steps // eng._fused_k()))
        del state
        grid = torch.rand(eng.spec.padded_shape((n,)), generator=gen,
                          device=device) * 0.01

        def naive(g, spec=eng.spec, steps=steps):
            for _ in range(steps):
                g = torch_ref.dense_step(g, spec)
            return g

        bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
        base = metrics.bench_result(eng.spec, (n,), steps, bsecs,
                                    "torch-naive", "fp32", 3)
        del grid
        runs[(name, n)] = (res, launches)
        for label, r in (("kernel", res), ("naive", base)):
            print(f"phase 10: {label} {name} {n} x{steps}: {r.time_ms} ms, "
                  f"{r.gstencil_per_s} GStencil/s (x{r.fuse_factor} fused) "
                  f"[{card}]", flush=True)
        print(f"phase 10: {name} {n} vs_baseline "
              f"{res.gstencil_per_s / base.gstencil_per_s}; {launches} "
              f"launches of {kernel} per {steps}-step run [{card}]",
              flush=True)

    timing = {}
    for kernel, name, n, kw, steps in (
            ("stencil1d_lanes_step", "1d2r", N_1D, {}, None),
            ("stencil1d_step", "1d2r", N_1D, {"algorithm": "vpu"}, None),
            ("stencil1d_resident_lanes", "1d1r", N_1D_SMALL, {}, 64),
            ("stencil1d_resident", "1d1r", N_1D_SMALL, {"algorithm": "vpu"},
             64)):
        eng = engine.StencilEngine.for_shape(name, (n,), device=device, **kw)
        spec, lay, k = eng.spec, eng.layout, eng._fused_k()
        x = torch.rand(lay.shape, generator=gen, device=device) * 0.01
        donor = torch.zeros_like(x)
        wrapper = getattr(s1, kernel)
        plain = getattr(s1, kernel + "_plain")
        if steps is None:  # a pass of k steps
            one = lambda: wrapper(x, donor, spec, lay, fused_steps=k)
            twin = lambda: plain(x, donor, spec, lay, fused_steps=k)
            per = k
        else:  # a whole run in one cooperative launch
            one = lambda: wrapper(x, spec, lay, steps)
            twin = lambda: plain(x, spec, lay, steps)
            per = steps
        ms, plain_ms = graph_ms(one), graph_ms(twin, 3)
        host_us = host_us_per_launch(one)
        bound, by = bound_ms(spec, (n,), per)
        parts = bound_parts(spec, (n,), per)
        lib = conv1d_ms(spec, n, device)
        timing[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, library_ms=lib,
                              steps_per_launch=per, library_steps=1,
                              shape=f"{name} {n} {kw or ''}".strip(),
                              host_us_per_launch=host_us)
        print(f"phase 10: {kernel} at {name} {n} {kw or ''}, {per} steps "
              f"per launch: kernel {ms} ms (device), plain twin {plain_ms} "
              f"ms, F.conv1d one step {lib} ms, bound {bound} ms ({by}; "
              f"bytes {parts[0]} ms, operations {parts[1]} ms); "
              f"host {host_us} us per launch with the device idle [{card}]",
              flush=True)
        del x, donor
    res, launches = runs[("1d2r", N_1D)]
    busy = launches * timing["stencil1d_lanes_step"]["ms"] / res.time_ms
    print(f"phase 10: 1d2r {N_1D} x256: {launches} passes x "
          f"{timing['stencil1d_lanes_step']['ms']} ms of kernel in "
          f"{res.time_ms} ms: device busy {busy}, idle {1 - busy} [{card}]",
          flush=True)
    return timing


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def check_kernel_fp64(name, interior, device, guard=None):
    """Phase 11, 2-D: the float64 strip kernel for one shape and size (and
    ``guard``, the layout's default if None) against the float64 tile
    kernel it replaces and its twin: every step a strip launch, counted in
    ``launches_k1`` and ``launches_f64``; one step bit for bit against both
    on the integer, pi/100 and inf fills (NaN where they have NaN), 1-2
    steps of the integer fill against the twin; returns (abs err, rel err,
    bit-equal) of the pi/100 fill after 4 steps."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d
    from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = (port_layout(spec, interior) if guard is None else
           Layout2D(interior=interior, halo=spec.halo,
                    tile=default_tile_2d(*interior), guard=guard))
    if not stencil2d.strip_takes(spec, torch.float64):
        raise AssertionError(f"{name}: the float64 step does not take the "
                             f"strip kernel")
    step = stencil2d.stencil2d_step
    g0 = reference.random_padded(spec, interior, seed=1)
    inf = g0 * (np.pi / 100)
    inf.flat[inf.size // 3] = np.inf
    for fill in (g0, g0 * (np.pi / 100), inf):
        x = lay.to_internal(fill, torch.float64, device)
        before = (step.launches_f64, step.launches_k1)
        strip = step(x, torch.zeros_like(x), spec, lay)
        if (step.launches_f64 - before[0], step.launches_k1 - before[1]) != (
                1, 1):
            raise AssertionError(f"{name} {interior}: the float64 step was "
                                 f"not one strip launch")
        tile = torch.zeros_like(x)
        stencil2d._launch("step", (x, tile), spec, lay, 1)
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec,
                                              lay)
        torch.cuda.synchronize()
        for other, what in ((tile, "the float64 tile kernel"),
                            (want, "its twin")):
            if not bool(((strip == other)
                         | (strip.isnan() & other.isnan())).all()):
                bad = (strip != other).sum().item()
                raise AssertionError(
                    f"{name} {interior} guard {lay.guard}: the float64 strip "
                    f"kernel differs from {what} at {bad} cells")
        del x, strip, tile, want
    for fill, steps_list in ((g0, (1, 2)), (g0 * (np.pi / 100), (4,))):
        x = lay.to_internal(fill, torch.float64, device)
        for steps in steps_list:
            got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
            want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay,
                             steps)
            torch.cuda.synchronize()
            if (got.dtype != torch.float64
                    or not bool(torch.isfinite(got).all())):
                raise AssertionError(
                    f"{name} {interior}: fp64 output not finite")
            if fill is g0 and not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(
                    f"{name} {interior}: fp64 kernel differs from its twin at "
                    f"{bad} cells after {steps} steps (integer fill)")
    rel = rel_err(got, want)
    if not rel <= 1e-13:
        raise AssertionError(f"{name} {interior}: fp64 rel err {rel:.3e} > "
                             f"1e-13 after 4 steps (pi/100 fill)")
    return (got - want).abs().max().item(), rel, bool(torch.equal(got, want))


def check_kernels_fp64_1d(name, n, device):
    """Phase 11, 1-D: each fp64 wrapper that takes the spec against its twin
    (passes at k = 1, 2 and the largest k whose fp64 window fits shared
    memory; runs where n <= 100,000, so that every block is resident);
    returns {kernel: (max abs err, max rel err, bit-equal) of the pi/100
    fill after 4 steps}."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=1)
    kmax = min(s1.MAX_FUSED, s1.max_pass_reach(torch.float64) // r)
    cases = [("df64_1d_flat_step", s1.stencil1d_step_plain, (1, 2, kmax))]
    runs = [("stencil1d_resident", s1.stencil1d_resident_plain, 1)]
    if r <= s1.MAX_LANES_REACH:
        cases.append(("df64_1d_step", s1.stencil1d_lanes_step_plain,
                      (1, 2, s1.MAX_LANES_REACH // r)))
        runs.append(("stencil1d_resident_pair",
                     s1.stencil1d_resident_lanes_plain, s1.lanes_refresh(r)))
    if n > 100_000:
        runs = []
    errs = {}

    def agree(got, want, what, fill):
        torch.cuda.synchronize()
        if got.dtype != torch.float64 or bool(torch.isnan(want).any()):
            raise AssertionError(f"{what}: not float64, or the twin gave NaN")
        if fill is g0 and not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{what}: fp64 kernel differs from its twin "
                                 f"at {bad} cells (integer fill)")
        return ((got - want).abs().max().item(), rel_err(got, want),
                bool(torch.equal(got, want)))

    def keep(kernel, err):
        old = errs.get(kernel, (0.0, 0.0, True))
        errs[kernel] = (max(old[0], err[0]), max(old[1], err[1]),
                        old[2] and err[2])

    for kernel, plain, ks in cases:
        wrapper = getattr(s1, KERNELS_FP64_1D[kernel])
        for k in sorted(set(ks)):
            lay = layout_1d(spec, n, k * r)
            for fill, steps_list in ((g0, sorted({1, 2, k})),
                                     (g0 * (np.pi / 100), (4,))):
                x = lay.to_internal(fill, torch.float64, device)
                for steps in steps_list:
                    err = agree(run_steps(wrapper, x, spec, lay, steps, k),
                                run_steps(plain, x, spec, lay, steps, k),
                                f"{kernel} {name} {n} k={k} x{steps}", fill)
                if fill is not g0:
                    keep(kernel, err)
    for kernel, plain, refresh in runs:
        wrapper = getattr(s1, KERNELS_FP64_1D.get(kernel, kernel))
        lay = layout_1d(spec, n, refresh * r)
        for fill, steps_list in ((g0, (1, 2, 2 * refresh + 3)),
                                 (g0 * (np.pi / 100), (4,))):
            x = lay.to_internal(fill, torch.float64, device)
            for steps in steps_list:
                err = agree(wrapper(x, spec, lay, steps),
                            plain(x, spec, lay, steps),
                            f"{kernel} {name} {n} x{steps}", fill)
            if fill is not g0:
                keep(kernel, err)
    for kernel, (_, rel, _) in errs.items():
        if not rel <= 1e-13:
            raise AssertionError(f"{kernel} {name} {n}: fp64 rel err "
                                 f"{rel:.3e} > 1e-13 (pi/100 fill)")
    return errs


# Phase 11's 2-D cases: (shape, interior, guard or None for the layout's)
FP64_2D_CASES = tuple((name, interior, None)
                      for name in ("star2d1r", "box2d1r", "box2d3r")
                      for interior in ((1000, 1000), INTERIOR)) + (
    ("star2d3r", (1000, 1000), None), ("star2d1r", (300, 140), (5, 7)))


# Phase 12's engine paths: (shape or for_coeffs radius, interior, dtypes,
# path, kernel whose count each run adds to)
FP64_PATHS = (
    ("star2d1r", INTERIOR, ("df64", "float64"), None, "df64_step"),
    ("box2d3r", (4096, 4096), ("df64", "float64"), None, "df64_step"),
    ("1d1r", (N_1D_SMALL,), ("df64", "float64"), "resident_lanes",
     "stencil1d_resident_pair"),
    ("1d2r", (N_1D_LARGE,), ("df64", "float64"), "lanes", "df64_1d_step"),
    ("r40", (100_000,), ("df64", "float64"), "flat", "df64_1d_flat_step"),
    ("r40", (3001,), ("float64",), "resident", "stencil1d_resident_f64"))


def fp64_engine(name, interior, dtype, device):
    from lorastencil_tpu_torch import engine

    if name.startswith("r"):
        return engine.StencilEngine.for_coeffs(
            np.asarray(spec_1d(name).terms[0].taps[0]), interior,
            name=name, device=device, dtype=dtype)
    return engine.StencilEngine.for_shape(name, interior, device=device,
                                          dtype=dtype)


def main_path_fp64(device):
    """Phase 12: every fp64 engine path end to end; returns the launches of
    each fp64 kernel over the phase, counted from zero, and a line per
    case.  Each run's launches are counted exactly: a 2-D step is one
    float64 strip launch, in "df64_step" and "stencil2d_k1"."""
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    lines = []
    reset_counts()
    for name, interior, dtypes, path, kernel in FP64_PATHS:
        for dtype in dtypes:
            eng = fp64_engine(name, interior, dtype, device)
            k = eng._fused_k()
            if eng.path != path or eng.dtype != torch.float64 or k != (
                    1 if dtype == "df64" or len(interior) == 2 else 2):
                raise AssertionError(f"{name} {interior} {dtype} resolved to "
                                     f"{eng.path} at k={k}")
            spec = eng.spec
            g0 = reference.random_padded(spec, interior, seed=0)
            for steps, fill in ((2, g0), (4, g0 * (np.pi / 100))):
                want = torch.from_numpy(fill).to(device)
                for _ in range(steps):
                    want = torch_ref.dense_step(want, spec)
                before = counts()
                out = eng.run(fill, steps)
                torch.cuda.synchronize()
                launched = {key: v - before[key] for key, v in counts().items()
                            if v != before[key]}
                expect = 1 if path and "resident" in path else -(-steps // k)
                want_launches = {kernel: expect}
                if len(interior) == 2:  # every step a float64 strip launch
                    want_launches["stencil2d_k1"] = expect
                if launched != want_launches:
                    raise AssertionError(f"{name} {interior} {dtype} run("
                                         f"{steps}) launched {launched}")
                if (tuple(out.shape) != spec.padded_shape(interior)
                        or out.dtype != torch.float64
                        or not bool(torch.isfinite(out).all())):
                    raise AssertionError(f"{name} {interior} {dtype}: output "
                                         f"{tuple(out.shape)} {out.dtype}")
                if steps == 2 and not torch.equal(out, want):
                    bad = (out != want).sum().item()
                    raise AssertionError(
                        f"{name} {interior} {dtype}: run(2) differs from the "
                        f"float64 dense stencil at {bad} cells")
                rel = rel_err(out, want)
                if not rel <= 1e-13:
                    raise AssertionError(f"{name} {interior} {dtype}: run(4) "
                                         f"rel err {rel:.3e} > 1e-13")
                lines.append(f"{dtype} {name} {interior} -> path {eng.path} "
                             f"k={k}: run({steps}) {expect} launch(es) of "
                             f"{kernel}, rel err {rel:.3e}")
                del out, want
    launches = counts()
    for kernel in KERNELS_FP64:
        if launches[kernel] == 0:
            raise AssertionError(f"the fp64 paths never launched {kernel}")
    return {kernel: launches[kernel] for kernel in KERNELS_FP64}, lines


def bench_fp64(device, card):
    """Phase 13: the df64 runs through ``run_internal`` and the naive dense
    stencil in float64, then per fp64 kernel its device time, its twin's,
    the float64 library step and the bound; returns the kernels' timing
    records."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import stencil2d, torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    for name, interior, steps in (("star2d1r", INTERIOR, 32),
                                  ("box2d3r", (4096, 4096), 32),
                                  ("1d1r", (N_1D_SMALL,), 64),
                                  ("1d2r", (N_1D_LARGE,), 256)):
        eng = fp64_engine(name, interior, "df64", device)
        state = torch.rand(eng.layout.shape, generator=gen, device=device,
                           dtype=torch.float64) * 0.01
        secs, _ = metrics.time_run(eng.run_internal, state, steps, repeats=3,
                                   warmup=1)
        res = metrics.bench_result(eng.spec, interior, steps, secs,
                                   "cuda-fp64", "df64", 3)
        if len(interior) == 2:  # every step a float64 strip launch
            count_run(eng, state, steps, "df64_step", steps)
            if counts()["stencil2d_k1"] != steps:
                raise AssertionError(f"df64 {name} x{steps}: "
                                     f"{counts()['stencil2d_k1']} strip "
                                     f"launches")
        del state
        grid = torch.rand(eng.spec.padded_shape(interior), generator=gen,
                          device=device, dtype=torch.float64) * 0.01

        def naive(g, spec=eng.spec, steps=steps):
            for _ in range(steps):
                g = torch_ref.dense_step(g, spec)
            return g

        bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
        base = metrics.bench_result(eng.spec, interior, steps, bsecs,
                                    "torch-naive", "float64", 3)
        del grid
        dims = "x".join(str(s) for s in interior)
        for label, r in (("kernel", res), ("naive", base)):
            print(f"phase 13: {label} df64 {name} {dims} x{steps}: "
                  f"{r.time_ms} ms, {r.gstencil_per_s} GStencil/s "
                  f"(x{r.fuse_factor} fused) [{card}]", flush=True)
        print(f"phase 13: df64 {name} {dims} path {eng.path}: vs_baseline "
              f"{res.gstencil_per_s / base.gstencil_per_s} [{card}]",
              flush=True)

    timing = {}
    for name, interior in (("star2d1r", INTERIOR), ("box2d3r", (4096, 4096))):
        eng = fp64_engine(name, interior, "df64", device)
        spec, lay = eng.spec, eng.layout
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=torch.float64) * 0.01
        donor = torch.zeros_like(x)
        fns = {"kernel": lambda: stencil2d.stencil2d_step(x, donor, spec, lay),
               "tile": lambda: stencil2d._launch("step", (x, donor), spec,
                                                 lay, 1)}
        ms = {}
        for which in ("kernel", "tile", "tile", "kernel"):  # in turns
            ms[which] = min(ms.get(which, float("inf")), graph_ms(fns[which]))
        plain_ms = graph_ms(lambda: stencil2d.stencil2d_step_plain(
            x, donor, spec, lay), 3)
        bound, by = bound_ms(spec, interior, 1, itemsize=8)
        parts = bound_parts(spec, interior, 1, itemsize=8)
        lib = library_ms(spec, interior, device, torch.float64)
        dims = "x".join(str(s) for s in interior)
        rec = dict(ms=ms["kernel"], plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, library_ms=lib, steps_per_launch=1,
                   library_steps=1, shape=f"df64 {name} {dims}",
                   kernel="strip64_kernel", tile_kernel_ms=ms["tile"])
        if name == "star2d1r":
            timing["df64_step"] = rec
        else:
            timing["df64_step"][name] = rec
        print(f"phase 13: df64_step at df64 {name} {dims}, one step: the "
              f"float64 strip kernel {ms['kernel']} ms (device), "
              f"{bound / ms['kernel']:.4f} of its bound; the float64 tile "
              f"kernel it replaces {ms['tile']} ms "
              f"({ms['tile'] / ms['kernel']:.4f}x); plain twin {plain_ms} ms, "
              f"float64 F.conv2d one step {lib} ms, bound {bound} ms ({by}; "
              f"bytes {parts[0]} ms in 8-byte cells, operations {parts[1]} ms "
              f"at {PEAK_FP64_FLOPS / 1e12:.0f} fp64 TFLOP/s) [{card}]",
              flush=True)
        del x, donor
    for kernel, name, interior, steps in (
            ("df64_1d_step", "1d2r", (N_1D_LARGE,), None),
            ("df64_1d_flat_step", "r40", (100_000,), None),
            ("stencil1d_resident_pair", "1d1r", (N_1D_SMALL,), 64)):
        eng = fp64_engine(name, interior, "df64", device)
        spec, lay = eng.spec, eng.layout
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=torch.float64) * 0.01
        donor = torch.zeros_like(x)
        wrapper = getattr(s1, KERNELS_FP64_1D[kernel])
        plain = getattr(s1, KERNELS_FP64_1D[kernel] + "_plain")
        if steps is None:  # one step
            one = lambda: wrapper(x, donor, spec, lay)
            twin = lambda: plain(x, donor, spec, lay)
            per = 1
        else:  # a whole run in one cooperative launch
            one = lambda: wrapper(x, spec, lay, steps)
            twin = lambda: plain(x, spec, lay, steps)
            per = steps
        ms, plain_ms = graph_ms(one), graph_ms(twin, 3)
        bound, by = bound_ms(spec, interior, per, itemsize=8)
        parts = bound_parts(spec, interior, per, itemsize=8)
        lib = conv1d_ms(spec, interior[0], device, torch.float64)
        dims = "x".join(str(s) for s in interior)
        timing[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, library_ms=lib,
                              steps_per_launch=per, library_steps=1,
                              shape=f"df64 {name} {dims}")
        print(f"phase 13: {kernel} at df64 {name} {dims}, {per} step(s) per "
              f"launch: kernel {ms} ms (device), plain twin {plain_ms} ms, "
              f"float64 F.conv1d one step {lib} ms, bound "
              f"{bound} ms ({by}; bytes {parts[0]} ms in 8-byte cells, "
              f"operations {parts[1]} ms at {PEAK_FP64_FLOPS / 1e12:.0f} "
              f"fp64 TFLOP/s) [{card}]", flush=True)
        del x, donor
    return timing


# Phases 14-16: 2-D temporal fusion.  star2d3r 8192^2 x 64 is the artifact's
# configuration (BASELINE.md); the engine fuses it at k = 2.
FUSED_SHAPE = "star2d3r"
FUSED_STEPS = 64
SMALL_2D = (512, 512)
# Phase 14's (shape, interior, k, dtypes) for the fused and skewed kernels
FUSED_CASES = (
    ("star2d3r", (1000, 1000), 2, (torch.float32, torch.float64)),
    ("star2d3r", INTERIOR, 2, (torch.float32,)),
    ("star2d3r", (300, 140), 2, (torch.float32,)),
    ("box2d1r", (1000, 1000), 3, (torch.float32, torch.float64)),
    ("star2d1r", (300, 140), 2, (torch.float32, torch.float64)))


def fused_layout(spec, interior, k):
    from lorastencil_tpu_torch.ops.layout import (Layout2D, default_tile_2d,
                                                  guard_2d)

    return Layout2D(interior=interior, halo=spec.halo,
                    tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, k * spec.radius))


def fused_passes(kind, x, spec, lay, steps, k):
    """``steps`` timesteps in passes of ``k`` through the wrappers' fused
    ("fused"), skewed ("skew") or single-step ("single") pass, the
    tile-based fused or skew kernel launched directly ("tile_step",
    "tile_skew"), or their twin ("*_plain": the skew kernel's is the fused
    pass's), with the engine's donor rotation."""
    from lorastencil_tpu_torch.engine import ping_pong_loop
    from lorastencil_tpu_torch.ops import stencil2d as s2

    def one(cur, donor, depth):
        if kind.startswith("tile_"):
            s2._launch(kind[5:], (cur, donor), spec, lay, depth)
            return donor
        if kind == "skew" and depth > 1:
            fn, kw = s2.stencil2d_skew_step, {"skew_steps": depth}
        else:
            fn = s2.stencil2d_step_plain if kind.endswith("plain") else \
                s2.stencil2d_step
            kw = {"fused_steps": depth}
        return fn(cur, donor, spec, lay, **kw)

    return ping_pong_loop(one, x, steps, 1 if kind == "single" else k)


def check_fused(name, interior, k, dtype, device):
    """Phase 14 for one shape, size, depth and dtype: the wrappers' fused
    (#1 at k) and skewed (#2) passes against single-step launches (bit for
    bit on any fill: the kernels share the per-cell sums) and against their
    twins (the 0/1 fill, k steps, bit for bit; the pi/100 fill, 2k steps,
    rel 1e-5 in float32, 1e-13 in float64).  Where the fused strip kernel
    takes the pass, both wrappers must launch it (counted in
    ``launches_fused_strip``) and equal the tile-based fused and skew
    kernels it replaces bit for bit on both fills.  Returns {kernel: (max
    abs err, rel err)} of the pi/100 fill and whether the fused strip
    kernel ran."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = fused_layout(spec, interior, k)
    g0 = reference.random_padded(spec, interior, seed=1)
    strip = s2.fused_strip_takes(spec, dtype, k)
    errs = {}
    for integer, fill in ((True, g0 % 2), (False, g0 * (np.pi / 100))):
        x = lay.to_internal(fill, dtype, device)
        steps = k if integer else 2 * k
        single = fused_passes("single", x, spec, lay, steps, k)
        for kind in ("fused", "skew"):
            reset_counts()
            got = fused_passes(kind, x, spec, lay, steps, k)
            ran = counts()["stencil2d_fused_strip" if kind == "fused"
                           else "stencil2d_skew_fused_strip"]
            want = fused_passes(kind + "_plain", x, spec, lay, steps, k)
            torch.cuda.synchronize()
            what = f"{kind} {name} {interior} {dtype} k={k} x{steps}"
            if ran != (steps // k if strip else 0):
                raise AssertionError(f"{what}: {ran} fused strip launches")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{what}: non-finite output")
            if not torch.equal(got, single):
                bad = (got != single).sum().item()
                raise AssertionError(f"{what}: differs from single-step "
                                     f"launches at {bad} cells")
            if strip:
                tile = fused_passes("tile_" + ("step" if kind == "fused"
                                               else "skew"),
                                    x, spec, lay, steps, k)
                if not torch.equal(got, tile):
                    bad = (got != tile).sum().item()
                    raise AssertionError(f"{what}: differs from the "
                                         f"tile-based {kind} kernel at {bad} "
                                         f"cells")
            if (integer or dtype == torch.float64) and not torch.equal(got,
                                                                       want):
                bad = (got != want).sum().item()
                raise AssertionError(f"{what}: differs from its twin at "
                                     f"{bad} cells")
            rel = rel_err(got, want)
            limit = 1e-13 if dtype == torch.float64 else 1e-5
            if not rel <= limit:
                raise AssertionError(f"{what}: rel err {rel:.3e} > {limit}")
            if not integer:
                errs[kind] = ((got - want).abs().max().item(), rel)
        del x, single, got, want
    return errs, strip


# Phase 14's whole-grid runs: (shape, interior, dtype); on 132 SMs the
# 512^2 rectangles are 46-47 x 42-43 cells, the 300 x 140 ones (the
# rounded interior 320 x 256) 32 x 19-20, and both cut the true interior.
RESIDENT_CASES = (("star2d1r", SMALL_2D, torch.float32),
                  ("box2d3r", SMALL_2D, torch.float32),
                  ("star2d3r", (300, 140), torch.float32),
                  ("star2d1r", SMALL_2D, torch.float64),
                  ("box2d3r", (300, 140), torch.float64))


def resident_grid_synced(x, spec, lay, steps):
    """A run of ``csrc/stencil2d.cu``'s resident kernel (a grid barrier a
    step), which the shared-memory kernel replaces for the registry's
    specs."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    outs = (torch.zeros_like(x), torch.zeros_like(x))
    s2._launch("resident", (x,) + outs, spec, lay, steps)
    return outs[(steps - 1) % 2]


def check_resident(name, interior, dtype, device):
    """Phase 14, the whole-grid run (#3 in float32, #10 in float64): one
    ``stencil2d_resident`` launch of 1, 2 and 4 steps, which must be the
    shared-memory resident kernel (``launches_smem``), against as many
    single-step launches and ``csrc/stencil2d.cu``'s resident kernel (both
    bit for bit), its twin (the integer fill at 1-2 steps bit for bit) and
    the fp64 ground truth
    (the pi/100 fill at 4 steps, rel 1e-5 in float32, 1e-13 in float64);
    returns (max abs err against the twin, rel err against the ground
    truth) of the pi/100 fill."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = fused_layout(spec, interior, 1)
    g0 = reference.random_padded(spec, interior, seed=2)
    for fill, steps_list in ((g0, (1, 2)), (g0 * (np.pi / 100), (4,))):
        x = lay.to_internal(fill, dtype, device)
        for steps in steps_list:
            reset_counts()
            got = s2.stencil2d_resident(x, spec, lay, steps)
            ran = counts()["stencil2d_resident_smem"]
            others = {"single steps": fused_passes("single", x, spec, lay,
                                                   steps, 1),
                      "the grid-synced resident kernel": resident_grid_synced(
                          x, spec, lay, steps)}
            want = s2.stencil2d_resident_plain(x, spec, lay, steps)
            torch.cuda.synchronize()
            what = f"resident {name} {interior} {dtype} x{steps}"
            if ran != 1:
                raise AssertionError(f"{what}: {ran} shared-memory launches")
            for other, out in others.items():
                if not torch.equal(got, out):
                    bad = (got != out).sum().item()
                    raise AssertionError(f"{what}: differs from {other} at "
                                         f"{bad} cells")
            if (fill is g0 or dtype == torch.float64) and not torch.equal(
                    got, want):
                raise AssertionError(f"{what}: differs from its twin")
    truth = reference.run(g0 * (np.pi / 100), spec, 4)
    rel = rel_err(lay.from_internal(got).double().cpu(),
                  torch.from_numpy(truth))
    limit = 1e-13 if dtype == torch.float64 else 1e-5
    if not rel <= limit:
        raise AssertionError(f"{what}: rel err {rel:.3e} > {limit}")
    return (got - want).abs().max().item(), rel


def set_resident_caps(nbytes):
    """The whole-grid runs' caps, as ``LORASTENCIL_RESIDENT2D_KB`` and
    ``LORASTENCIL_RESIDENT2D_PAIR_KB`` set them (0: off), on the CPU and
    the card; None: the defaults (the variables unset)."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    if nbytes is None:
        s2.RESIDENT_2D_BYTES = s2.RESIDENT_PAIR_2D_BYTES = 0
        s2.CUDA_RESIDENT_2D_BYTES = s2.H100_RESIDENT_2D_BYTES
        s2.CUDA_RESIDENT_PAIR_2D_BYTES = s2.H100_RESIDENT_PAIR_2D_BYTES
    else:
        s2.RESIDENT_2D_BYTES = s2.RESIDENT_PAIR_2D_BYTES = nbytes
        s2.CUDA_RESIDENT_2D_BYTES = s2.CUDA_RESIDENT_PAIR_2D_BYTES = nbytes


# the radius-5 runs' interior: its layout (a guard of 8) fits the H100
# default caps in float32 and df64 (2,095,104 bytes in df64)
R5_2D = (480, 480)


def custom_r5():
    """A radius-5 spec, an 11 x 11 box of ones as one term: beyond the
    shared-memory kernel's radii, so its whole-grid runs take
    ``csrc/stencil2d.cu``'s resident kernel."""
    from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec

    ones = (1.0,) * 11
    return StencilSpec(name="custom_r5", ndim=2, radius=5, halo=(5, 5),
                       terms=(SeparableTerm(taps=(ones, ones)),), residue=(),
                       fuse_factor=1)


def path_engine(name, interior, device, **kw):
    from lorastencil_tpu_torch import engine

    if name == "custom_r5":
        return engine.StencilEngine(custom_r5(), interior,
                                    engine._config(kw), device=device)
    return engine.StencilEngine.for_shape(name, interior, device=device, **kw)


# Phase 15's paths, under the default caps: (shape, interior, engine
# options, whether the run is resident, the kernel of its 64-step run, that
# run's launches, the steps of the integer fill's run, exact below 2**24,
# and its launches).  A single float32 step, the
# remainder of an odd run or every step at fused_steps=1, runs the strip
# kernel and counts in "stencil2d_k1" too; star2d3r's k = 2 passes run the
# fused strip kernel from either wrapper, so each of its wrapper's launches
# counts in its "*_fused_strip" too: equal counts mean that no tile-based
# fused or skew kernel ran.
FUSED_PATHS = (
    ("star2d3r", INTERIOR, {}, False, "stencil2d_fused_strip",
     {"stencil2d": 32, "stencil2d_fused_strip": 32}, 3,
     {"stencil2d": 2, "stencil2d_fused_strip": 1, "stencil2d_k1": 1}),
    ("star2d3r", INTERIOR, {"fusion": "skew"}, False,
     "stencil2d_skew_fused_strip",
     {"stencil2d_skew": 32, "stencil2d_skew_fused_strip": 32}, 3,
     {"stencil2d_skew": 1, "stencil2d_skew_fused_strip": 1, "stencil2d": 1,
      "stencil2d_k1": 1}),
    ("star2d3r", INTERIOR, {"fused_steps": 1}, False, "stencil2d",
     {"stencil2d": 64, "stencil2d_k1": 64}, 3,
     {"stencil2d": 3, "stencil2d_k1": 3}),
    ("star2d1r", SMALL_2D, {}, True, "stencil2d_resident",
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}, 2,
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}),
    ("box2d3r", SMALL_2D, {}, True, "stencil2d_resident",
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}, 2,
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}),
    ("star2d1r", SMALL_2D, {"dtype": "df64"}, True,
     "stencil2d_resident_pair",
     {"stencil2d_resident_pair": 1, "stencil2d_resident_smem": 1}, 2,
     {"stencil2d_resident_pair": 1, "stencil2d_resident_smem": 1}),
    ("custom_r5", R5_2D, {}, True, "stencil2d_resident",
     {"stencil2d_resident": 1}, 2, {"stencil2d_resident": 1}),
    ("custom_r5", R5_2D, {"dtype": "df64"}, True,
     "stencil2d_resident_pair", {"stencil2d_resident_pair": 1}, 2,
     {"stencil2d_resident_pair": 1}))


def main_path_fused(device):
    """Phase 15: each fused path end to end, launches counted from zero:
    ``run(.., 3)`` (star2d3r; 2 for the others) of the integer fill bit for
    bit against a float64 dense stencil on the card (every partial sum an
    integer below 2**24),
    ``run(.., 4)`` of the pi/100 fill within rel 1e-5 (1e-13 for df64), and
    a 64-step ``run_internal`` that must launch its kernel the expected
    number of times and no other; returns {(shape, mode, dtype): 64-step
    launches}, {(shape, mode, dtype): the pi/100 run's max abs err against
    the dense stencil} and a line per path."""
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    launches, errs, lines = {}, {}, []
    for name, interior, kw, resident, kernel, expect, n_int, run_int in \
            FUSED_PATHS:
        eng = path_engine(name, interior, device, **kw)
        spec = eng.spec
        k = eng._fused_k()
        mode = ("resident" if resident else "skew"
                if eng._fusion_mode() == "skew" else f"extent k={k}")
        if eng._resident_2d() != resident:
            raise AssertionError(f"{name} {kw}: resident {eng._resident_2d()}")
        g0 = reference.random_padded(spec, interior, seed=0)
        for steps, fill in ((n_int, g0), (4, g0 * (np.pi / 100))):
            want = torch.from_numpy(fill).to(device)
            for _ in range(steps):
                want = torch_ref.dense_step(want, spec)
            reset_counts()
            out = eng.run(fill, steps)
            torch.cuda.synchronize()
            got = {key: v for key, v in counts().items() if v}
            if fill is g0 and got != run_int:
                raise AssertionError(f"{name} {kw} run({steps}) launched "
                                     f"{got}")
            if (tuple(out.shape) != spec.padded_shape(interior)
                    or not bool(torch.isfinite(out).all())):
                raise AssertionError(f"{name} {kw}: output {tuple(out.shape)}")
            if fill is g0 and not torch.equal(out.double(), want):
                bad = (out.double() != want).sum().item()
                raise AssertionError(f"{name} {kw}: run({steps}) differs from "
                                     f"the float64 dense stencil at {bad} "
                                     f"cells")
            rel = rel_err(out.double(), want)
            limit = 1e-13 if eng.dtype == torch.float64 else 1e-5
            if not rel <= limit:
                raise AssertionError(f"{name} {kw}: run(4) rel err {rel:.3e}"
                                     f" > {limit}")
            errs[(name, mode, kw.get("dtype", "float32"))] = (
                out.double() - want).abs().max().item()
            del out, want
        gen = torch.Generator(device=device).manual_seed(0)
        state = torch.rand(eng.layout.shape, generator=gen, device=device,
                           dtype=eng.dtype) * 0.01
        reset_counts()
        eng.run_internal(state, FUSED_STEPS)
        torch.cuda.synchronize()
        got = {key: v for key, v in counts().items() if v}
        if got != expect:
            raise AssertionError(f"{name} {kw} x{FUSED_STEPS} launched {got}")
        launches[(name, mode, kw.get("dtype", "float32"))] = expect[kernel]
        dims = "x".join(str(s) for s in interior)
        lines.append(f"{name} {dims} {kw or 'defaults'} -> {mode}: "
                     f"run({n_int}) {run_int} bit-exact, run(4) rel err "
                     f"{rel:.3e}; "
                     f"x{FUSED_STEPS}: launches {expect}, none of the "
                     f"others")
        del state
    return launches, errs, lines


def bench_fused(device, card):
    """Phase 16: star2d3r 8192^2 x 64 through ``run_internal`` in the three
    modes (extent k = 2, skew k = 2, fused_steps = 1) and through the naive
    dense stencil; the resident runs at 512^2 x 64 against the tiled passes;
    per new kernel its device time, its twin's, the library step and the
    bound; returns the kernels' timing records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    spec = get_shape(FUSED_SHAPE)
    dims = f"{INTERIOR[0]}x{INTERIOR[1]}"
    res = {}
    for mode, kw in (("extent", {}), ("skew", {"fusion": "skew"}),
                     ("k=1", {"fused_steps": 1})):
        eng = engine.StencilEngine.for_shape(FUSED_SHAPE, INTERIOR,
                                             device=device, **kw)
        state = torch.rand(eng.layout.shape, generator=gen,
                           device=device) * 0.01
        secs, _ = metrics.time_run(eng.run_internal, state, FUSED_STEPS,
                                   repeats=3, warmup=1)
        res[mode] = metrics.bench_result(spec, INTERIOR, FUSED_STEPS, secs,
                                         f"cuda-stencil2d-{mode}",
                                         "fp32-exact", 3)
        del state
    grid = torch.rand(spec.padded_shape(INTERIOR), generator=gen,
                      device=device) * 0.01

    def naive(g):
        for _ in range(FUSED_STEPS):
            g = torch_ref.dense_step(g, spec)
        return g

    bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
    del grid
    base = metrics.bench_result(spec, INTERIOR, FUSED_STEPS, bsecs,
                                "torch-naive", "fp32", 3)
    for label, r in list(res.items()) + [("naive", base)]:
        print(f"phase 16: {label} {FUSED_SHAPE} {dims} x{FUSED_STEPS}: "
              f"{r.time_ms} ms, {r.gstencil_per_s} GStencil/s "
              f"(x{r.fuse_factor} fused), vs_baseline "
              f"{r.gstencil_per_s / base.gstencil_per_s} [{card}]",
              flush=True)

    # per kernel: one k = 2 pass through each wrapper (the fused strip
    # kernel), through the tile-based fused and skew kernels it replaces,
    # and as two strip-kernel steps, and one k = 1 step, timed in turns
    # (time_calls); the twin apart
    timing = {}
    lay2 = fused_layout(spec, INTERIOR, 2)
    x = torch.rand(lay2.shape, generator=gen, device=device) * 0.01
    spare = torch.zeros_like(x)
    ms = time_calls({
        "fused": lambda a, b: s2.stencil2d_step(a, b, spec, lay2,
                                                fused_steps=2),
        "skew": lambda a, b: s2.stencil2d_skew_step(a, b, spec, lay2,
                                                    skew_steps=2),
        "tile_step": lambda a, b: s2._launch("step", (a, b), spec, lay2, 2),
        "tile_skew": lambda a, b: s2._launch("skew", (a, b), spec, lay2, 2),
        "two": lambda a, b: s2.stencil2d_step(
            s2.stencil2d_step(a, b, spec, lay2), spare, spec, lay2),
        "single": lambda a, b: s2.stencil2d_step(a, b, spec, lay2)},
        x, torch.zeros_like(x), 20)
    del spare
    # the two kernels' twin: a k = 2 pass of the fused kernel's
    plain = time_calls({
        "twin": lambda a, b: s2.stencil2d_step_plain(a, b, spec, lay2, 2)},
        x, torch.zeros_like(x), 3)["twin"]
    del x
    lib = library_ms(spec, INTERIOR, device)
    bound, by = bound_ms(spec, INTERIOR, 2)
    parts = bound_parts(spec, INTERIOR, 2)
    for kernel, tile in (("fused", "tile_step"), ("skew", "tile_skew")):
        timing[kernel] = dict(kernel="fused_strip_kernel", ms=ms[kernel],
                              plain_ms=plain, bound_ms=bound, bound_by=by,
                              library_ms=lib, tile_kernel_ms=ms[tile],
                              two_strip_steps_ms=ms["two"],
                              steps_per_launch=2, library_steps=1,
                              shape=f"{FUSED_SHAPE} {dims}")
        print(f"phase 16: {kernel} k=2 pass at {FUSED_SHAPE} {dims}: fused "
              f"strip kernel {ms[kernel]} ms ({bound / ms[kernel]:.4f} of "
              f"the bound), the tile-based {tile[5:]} kernel it replaces "
              f"{ms[tile]} ms ({ms[tile] / ms[kernel]:.4f}x), two strip "
              f"steps {ms['two']} ms ({ms['two'] / ms[kernel]:.4f}x), plain "
              f"twin {plain} ms, F.conv2d 7x7 one step {lib} ms, bound "
              f"{bound} ms ({by}; bytes {parts[0]} ms, operations {parts[1]} "
              f"ms) [{card}]", flush=True)
    print(f"phase 16: single k=1 step at {FUSED_SHAPE} {dims}: kernel "
          f"{ms['single']} ms; bound of one step "
          f"{bound_ms(spec, INTERIOR, 1)[0]} ms [{card}]", flush=True)

    timing.update(bench_resident(device, card, gen))
    return timing


# Phase 16's whole-grid sweep: square interiors, and the largest one the
# kernel's capacity takes; a cap above any capacity turns the runs on
RESIDENT_SIZES = (256, 512, 1024)
RESIDENT_SWEEP_CAP = 2**30
RESIDENT_LARGE = (1024, 1024)
FLOOR_2D = (64, 128)


def largest_square(name, dtype, device):
    """The largest n, a multiple of 32, whose n x n engine layout the
    shared-memory kernel's capacity takes."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    eng = path_engine(name, (1024, 1024), device, dtype=dtype)
    cap = s2.resident_capacity(eng.spec, eng.dtype, device)
    n = 1024
    while True:
        rows, pitch = path_engine(name, (n + 32, n + 32), device,
                                  dtype=dtype).layout.shape
        if rows * pitch * eng.dtype.itemsize > cap:
            return n
        n += 32


def in_turns(fns, calls=5):
    """Device ms per call of each of ``fns`` (CUDA graphs of ``calls``
    calls), timed forward then backward; the better of the two."""
    res = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        res[k].append(graph_ms(fns[k], calls))
    return {k: min(v) for k, v in res.items()}


def bench_resident(device, card, gen):
    """Phase 16's whole-grid runs: the tiled-against-resident sweep and the
    default caps it gives; the shared-memory kernel beside
    ``csrc/stencil2d.cu``'s resident kernel (at 512^2, 1024^2 and the
    handshake floor's 64 x 128); the radius-5
    runs on ``csrc/stencil2d.cu``'s kernel.  Returns the kernels' timing
    records."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import metrics

    for dtype in ("float32", "df64"):
        sweep = []
        for name in ("star2d1r", "box2d3r"):
            for n in RESIDENT_SIZES + (largest_square(name, dtype, device),):
                runs = {}
                for caps in (0, RESIDENT_SWEEP_CAP):
                    set_resident_caps(caps)
                    eng = path_engine(name, (n, n), device, dtype=dtype)
                    if eng._resident_2d() != bool(caps):
                        raise AssertionError(f"{dtype} {name} {n}: resident "
                                             f"{eng._resident_2d()}")
                    x = torch.rand(eng.layout.shape, generator=gen,
                                   device=device, dtype=eng.dtype) * 0.01
                    secs, _ = metrics.time_run(eng.run_internal, x,
                                               FUSED_STEPS, repeats=3,
                                               warmup=1)
                    runs["resident" if caps else "tiled"] = secs * 1e3
                    del x
                rows, pitch = eng.layout.shape
                nbytes = rows * pitch * eng.dtype.itemsize
                sweep.append((nbytes, runs["tiled"], runs["resident"]))
                print(f"phase 16: {dtype} {name} {n}x{n} x{FUSED_STEPS} "
                      f"({nbytes} bytes): run_internal tiled "
                      f"({FUSED_STEPS} launches) {runs['tiled']} ms, "
                      f"resident (1 launch) {runs['resident']} ms "
                      f"({runs['tiled'] / runs['resident']:.4f}x) [{card}]",
                      flush=True)
        set_resident_caps(None)
        default = 0  # every shape must win at a size, and below it
        for nbytes in sorted({size for size, _, _ in sweep}):
            if any(resident >= tiled for size, tiled, resident in sweep
                   if size == nbytes):
                break
            default = nbytes
        port = (s2.H100_RESIDENT_PAIR_2D_BYTES if dtype == "df64"
                else s2.H100_RESIDENT_2D_BYTES)
        print(f"phase 16: {dtype} default cap from this sweep (the largest "
              f"internal buffer at which the resident run won for both shapes "
              f"at every size measured up to it): {default} bytes; the port's "
              f"H100 default "
              f"{port} bytes [{card}]", flush=True)

    timing = {}
    for label, interior, shapes in (("512^2", SMALL_2D,
                                     ("star2d1r", "box2d3r", "star2d3r")),
                                    ("1024^2", RESIDENT_LARGE,
                                     ("star2d1r", "box2d3r")),
                                    ("floor", FLOOR_2D, ("star2d1r",))):
        for name in shapes:
            spec = get_shape(name)
            lay = fused_layout(spec, interior, 1)
            for dtype in (torch.float32, torch.float64):
                x = torch.rand(lay.shape, generator=gen, device=device,
                               dtype=dtype) * 0.01
                fns = {"kernel": lambda: s2.stencil2d_resident(
                           x, spec, lay, FUSED_STEPS),
                       "grid-synced": lambda: resident_grid_synced(
                           x, spec, lay, FUSED_STEPS)}
                if label == "floor":  # a run of one step: the fixed part
                    fns["one step"] = lambda: s2.stencil2d_resident(
                        x, spec, lay, 1)
                ms = in_turns(fns)
                per = {k: v / FUSED_STEPS * 1e3 for k, v in ms.items()}
                if label == "floor":
                    per["one step"] = ms["one step"] * 1e3
                    ms["a step"] = (ms["kernel"] - ms["one step"]) / (
                        FUSED_STEPS - 1)
                    per["a step"] = ms["a step"] * 1e3
                print(f"phase 16: {str(dtype)[6:]} {name} "
                      f"{interior[0]}x{interior[1]} x{FUSED_STEPS}, in turns: "
                      f"the shared-memory kernel "
                      f"{ms['kernel']} ms ({per['kernel']:.3f} us a step), "
                      + ", ".join(f"{k} {v} ms ({per[k]:.3f} us)"
                                  for k, v in ms.items() if k != "kernel")
                      + f" [{card}]", flush=True)
                if name == "star2d1r" and label != "1024^2":
                    key = "resident" if dtype == torch.float32 else \
                        "resident_pair"
                    timing.setdefault(key, {})[label] = (x, spec, lay, ms)
                else:
                    del x

    # the kernels' records: star2d1r 512^2 (#3 float32, #10 float64) and
    # the radius-5 runs on csrc/stencil2d.cu's kernel
    records = {}
    for key, itemsize, tdtype in (("resident", 4, torch.float32),
                                  ("resident_pair", 8, torch.float64)):
        x, spec, lay, ms = timing[key]["512^2"]
        floor = timing[key]["floor"][3]["a step"]
        plain = graph_ms(lambda: s2.stencil2d_resident_plain(
            x, spec, lay, FUSED_STEPS), 2)
        bound, by = bound_ms(spec, SMALL_2D, FUSED_STEPS, itemsize)
        records[key] = dict(
            kernel="resident_smem_kernel", ms=ms["kernel"], plain_ms=plain,
            bound_ms=bound, bound_by=by,
            library_ms=library_ms(spec, SMALL_2D, device, tdtype),
            grid_synced_kernel_ms=ms["grid-synced"], floor_step_ms=floor,
            floor_shape=f"{FLOOR_2D[0]}x{FLOOR_2D[1]}",
            steps_per_launch=FUSED_STEPS, library_steps=1,
            shape=f"{'df64' if itemsize == 8 else 'float32'} star2d1r 512x512")
        print(f"phase 16: {key} star2d1r 512x512 x{FUSED_STEPS}: the "
              f"shared-memory kernel {ms['kernel']} ms (device), the "
              f"grid-synced kernel {ms['grid-synced']} ms "
              f"({ms['grid-synced'] / ms['kernel']:.4f}x), "
              f"handshake floor ({FLOOR_2D[0]}x{FLOOR_2D[1]}, a step: the "
              f"64-step run less the 1-step run, over 63) {floor} ms, "
              f"plain twin {plain} ms, one "
              f"{'float64 ' if itemsize == 8 else ''}F.conv2d step "
              f"{records[key]['library_ms']} ms, bound {bound} ms ({by}) "
              f"[{card}]", flush=True)
    spec = custom_r5()
    lay = fused_layout(spec, R5_2D, 1)
    dims = f"{R5_2D[0]}x{R5_2D[1]}"
    for key, itemsize, tdtype in (("resident_r5", 4, torch.float32),
                                  ("resident_pair_r5", 8, torch.float64)):
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=tdtype) * 0.01
        rms = graph_ms(lambda: s2.stencil2d_resident(x, spec, lay,
                                                     FUSED_STEPS), 5)
        plain = graph_ms(lambda: s2.stencil2d_resident_plain(
            x, spec, lay, FUSED_STEPS), 2)
        bound, by = bound_ms(spec, R5_2D, FUSED_STEPS, itemsize)
        records[key] = dict(
            kernel="resident_kernel", ms=rms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=library_ms(spec, R5_2D, device, tdtype),
            steps_per_launch=FUSED_STEPS, library_steps=1,
            shape=f"{'df64' if itemsize == 8 else 'float32'} custom_r5 "
                  f"{dims}")
        print(f"phase 16: {key} custom_r5 {dims} x{FUSED_STEPS}: "
              f"csrc/stencil2d.cu's resident kernel {rms} ms (device), plain "
              f"twin {plain} ms, one {'float64 ' if itemsize == 8 else ''}"
              f"F.conv2d 11x11 step {records[key]['library_ms']} ms, bound "
              f"{bound} ms ({by}) [{card}]", flush=True)
        del x
    return records


# Phases 17-19: the 3-D fp64-grade tier, the float64 instance of the 3-D
# kernel (replacing pallas_df64_3d.df64_3d_step), at the JAX DF64 tier's 3-D
# rows, 256^3 x 64 (benchmarks/suite.py:125-126).
SHAPES_3D = ("star3d1r", "box3d1r")


def check_kernel_fp64_3d(name, interior, K, device):
    """Phase 17 for one shape, size and depth: the float64 instance against
    its twin after one and two passes of K (bit for bit on both fills) and,
    on the integer fill, against a float64 dense stencil on the card; returns
    (abs err, rel err, bit-equal) of the pi/100 fill after 4 steps.  The
    pass runs the march kernel, which must also equal the general kernel's
    pass bit for bit on both fills."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil3d, torch_ref
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = port_layout_3d(spec, interior, K)
    g0 = reference.random_padded(spec, interior, seed=1)
    x = lay.to_internal(g0, torch.float64, device)
    dense = torch.from_numpy(g0).to(device)
    for passes in (1, 2):
        got = run_steps(stencil3d.stencil3d_step, x, spec, lay, passes * K, K)
        want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay,
                         passes * K, K)
        for _ in range(K):
            dense = torch_ref.dense_step(dense, spec)
        torch.cuda.synchronize()
        if got.dtype != torch.float64 or not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(
                f"{name} {interior} K={K}: fp64 kernel differs from its twin "
                f"at {bad} cells after {passes} passes (integer fill)")
        if not torch.equal(lay.from_internal(got), dense):
            bad = (lay.from_internal(got) != dense).sum().item()
            raise AssertionError(
                f"{name} {interior} K={K}: fp64 kernel differs from the "
                f"float64 dense stencil at {bad} cells after {passes} passes")
    for fill in (g0, g0 * (np.pi / 100)):
        x1 = lay.to_internal(fill, torch.float64, device)
        before = stencil3d.stencil3d_step.launches_march
        got = stencil3d.stencil3d_step(x1, torch.zeros_like(x1), spec, lay,
                                       fused_steps=K)
        if stencil3d.stencil3d_step.launches_march != before + 1:
            raise AssertionError(f"{name} {interior} K={K}: no march launch")
        if not torch.equal(got, general_3d(x1, spec, lay, K)):
            raise AssertionError(f"{name} {interior} K={K}: the fp64 march "
                                 f"kernel differs from the general kernel")
    x = lay.to_internal(g0 * (np.pi / 100), torch.float64, device)
    got = run_steps(stencil3d.stencil3d_step, x, spec, lay, 4, K)
    want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay, 4, K)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {interior} K={K}: non-finite output")
    rel = rel_err(got, want)
    if not rel <= 1e-13:
        raise AssertionError(f"{name} {interior} K={K}: fp64 rel err "
                             f"{rel:.3e} > 1e-13 after 4 steps (pi/100 fill)")
    return (got - want).abs().max().item(), rel, bool(torch.equal(got, want))


def main_path_fp64_3d(device):
    """Phase 18: the df64 and float64 engines at 256^3 for both shapes, the
    launches of the float64 instance counted from zero over the phase;
    returns the launches of each run, the phase's total and a line per
    case."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    lines, launches = [], {}
    reset_counts()
    for name in SHAPES_3D:
        for dtype in ("df64", "float64"):
            eng = engine.StencilEngine.for_shape(name, INTERIOR_3D,
                                                 device=device, dtype=dtype)
            k = eng._fused_k()
            label = eng.df64_algorithm if eng.df64 else eng.algorithm
            if (k, eng.backend, eng.dtype, label) != (
                    1 if eng.df64 else 2, "pallas", torch.float64,
                    "vpu_sep" if eng.df64 else "vpu_roll"):
                raise AssertionError(f"{dtype} {name} resolved to {label}/"
                                     f"{eng.backend} at k={k}")
            spec = eng.spec
            g0 = reference.random_padded(spec, INTERIOR_3D, seed=0)
            for steps, fill in ((2, g0), (4, g0 * (np.pi / 100))):
                want = torch.from_numpy(fill).to(device)
                for _ in range(steps):
                    want = torch_ref.dense_step(want, spec)
                before = counts()
                out = eng.run(fill, steps)
                torch.cuda.synchronize()
                launched = {key: v - before[key] for key, v in counts().items()
                            if v != before[key]}
                expect = -(-steps // k)
                if launched != {"df64_3d_step": expect,
                                "stencil3d_march": expect}:
                    raise AssertionError(f"{dtype} {name} run({steps}) "
                                         f"launched {launched}")
                if (tuple(out.shape) != spec.padded_shape(INTERIOR_3D)
                        or out.dtype != torch.float64
                        or not bool(torch.isfinite(out).all())):
                    raise AssertionError(f"{dtype} {name}: output "
                                         f"{tuple(out.shape)} {out.dtype}")
                if steps == 2 and not torch.equal(out, want):
                    bad = (out != want).sum().item()
                    raise AssertionError(
                        f"{dtype} {name}: run(2) differs from the float64 "
                        f"dense stencil at {bad} cells")
                rel = rel_err(out, want)
                if not rel <= 1e-13:
                    raise AssertionError(f"{dtype} {name}: run({steps}) rel "
                                         f"err {rel:.3e} > 1e-13")
                launches[(name, dtype, steps)] = expect
                lines.append(f"{dtype} {name} {INTERIOR_3D} -> "
                             f"{label} k={k}: run({steps}) {expect} "
                             f"launch(es) of df64_3d_step, each the march "
                             f"kernel, rel err {rel:.3e}")
                del out, want
    total = counts()["df64_3d_step"]
    if total == 0 or counts()["stencil3d_march"] != total:
        raise AssertionError("the 3-D fp64 paths did not launch the march "
                             "kernel for every pass")
    return launches, total, lines


def bench_fp64_3d(device, card):
    """Phase 19: df64 (k = 1) and float64 (k = 2) 256^3 x 64 through
    ``run_internal`` and the naive dense stencil in float64; per shape the
    march kernel's float64 device time per df64 pass beside the general
    kernel's and the twin's, and per float64 k = 2 pass beside two k = 1
    passes and the general kernel's k = 2 pass, each set in turns; one
    float64 ``F.conv3d`` step and the pass's bound; returns the kernels'
    timing records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil3d, torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    dims = "x".join(str(s) for s in INTERIOR_3D)
    timing = {}
    for name in SHAPES_3D:
        res = {}
        for dtype in ("df64", "float64"):
            eng = engine.StencilEngine.for_shape(name, INTERIOR_3D,
                                                 device=device, dtype=dtype)
            state = torch.rand(eng.layout.shape, generator=gen, device=device,
                               dtype=torch.float64) * 0.01
            secs, _ = metrics.time_run(eng.run_internal, state,
                                       BENCH_STEPS_3D, repeats=3, warmup=1)
            res[dtype] = metrics.bench_result(eng.spec, INTERIOR_3D,
                                              BENCH_STEPS_3D, secs,
                                              "cuda-fp64", dtype, 3)
            k = eng._fused_k()
            res[dtype + " launches"] = count_run(
                eng, state, BENCH_STEPS_3D, "stencil3d_march",
                BENCH_STEPS_3D // k)
            if dtype == "df64":
                spec, lay = eng.spec, eng.layout
                ms = time_calls({
                    "plain": lambda a, b: stencil3d.stencil3d_step_plain(
                        a, b, spec, lay),
                    "kernel": lambda a, b: stencil3d.stencil3d_step(
                        a, b, spec, lay, algorithm="vpu_sep"),
                    "general": lambda a, b: general_3d(a, spec, lay, 1, b)},
                    state, torch.zeros_like(state), calls=10)
            else:
                lay2 = eng.layout
                k2 = time_calls({
                    "k=2": lambda a, b: stencil3d.stencil3d_step(
                        a, b, spec, lay2, fused_steps=2),
                    "two k=1": lambda a, b: stencil3d.stencil3d_step(
                        stencil3d.stencil3d_step(a, b, spec, lay2), a, spec,
                        lay2),
                    "general k=2": lambda a, b: general_3d(a, spec, lay2, 2,
                                                           b)},
                    state, torch.zeros_like(state), calls=10)
                ms.update(k2)
            del state
        grid = torch.rand(spec.padded_shape(INTERIOR_3D), generator=gen,
                          device=device, dtype=torch.float64) * 0.01

        def naive(g, spec=spec):
            for _ in range(BENCH_STEPS_3D):
                g = torch_ref.dense_step(g, spec)
            return g

        bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
        del grid
        base = metrics.bench_result(spec, INTERIOR_3D, BENCH_STEPS_3D, bsecs,
                                    "torch-naive", "float64", 3)
        for label in ("df64", "float64"):
            r = res[label]
            print(f"phase 19: {label} {name} {dims} x{BENCH_STEPS_3D} "
                  f"({res[label + ' launches']} launches): {r.time_ms} ms, "
                  f"{r.gstencil_per_s} GStencil/s, vs_baseline "
                  f"{r.gstencil_per_s / base.gstencil_per_s} [{card}]",
                  flush=True)
        print(f"phase 19: naive float64 {name} {dims} x{BENCH_STEPS_3D}: "
              f"{base.time_ms} ms, {base.gstencil_per_s} GStencil/s [{card}]",
              flush=True)
        lib = library_ms(spec, INTERIOR_3D, device, torch.float64)
        bound, by = bound_ms(spec, INTERIOR_3D, 1, itemsize=8)
        parts = bound_parts(spec, INTERIOR_3D, 1, itemsize=8)
        timing[name] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                            bound_ms=bound, bound_by=by, library_ms=lib,
                            steps_per_launch=1, library_steps=1,
                            shape=f"df64 {name} {dims}",
                            general_kernel_ms=ms["general"],
                            float64_k2_ms=ms["k=2"],
                            float64_two_k1_ms=ms["two k=1"],
                            float64_general_k2_ms=ms["general k=2"])
        print(f"phase 19: df64_3d_step at df64 {name} {dims}, 1 step per "
              f"launch: march kernel {ms['kernel']} ms, the general kernel "
              f"it replaces {ms['general']} ms, plain twin {ms['plain']} "
              f"ms, float64 F.conv3d 3x3x3 one step {lib} ms, bound {bound} "
              f"ms ({by}; bytes {parts[0]} ms in 8-byte cells, operations "
              f"{parts[1]} ms at {PEAK_FP64_FLOPS / 1e12:.0f} fp64 TFLOP/s) "
              f"[{card}]", flush=True)
        print(f"phase 19: float64 {name} {dims} k=2 pass: march kernel "
              f"{ms['k=2']} ms, two march k=1 passes {ms['two k=1']} ms "
              f"({ms['two k=1'] / ms['k=2']:.4f}x), the general kernel's k=2 "
              f"pass {ms['general k=2']} ms; bound {bound} ms [{card}]",
              flush=True)
    return timing


# Phase 20: the kernels redesigned for Hopper, csrc/resident2d.cu
# resident_smem_kernel (float and double, radius 1-4),
# csrc/stencil2d.cu strip_kernel
# (an instantiation per radius 1-4 and term count 0-3), strip64_kernel (the
# same in float64, each with 16-byte or 8-byte copies) and
# fused_strip_kernel (radius 1-4, 1-2 terms, K = 2, the terms' kinds),
# csrc/stencil1d.cu wide_kernel (float and double) and csrc/stencil3d.cu
# march_kernel (float and double, radius 1-2, K = 1-2, star3d1r's and
# box3d1r's term kinds): {kernel: (source, the pattern of the mangled names
# ptxas reports, what the instantiation's numbers are)}.  A mangled name carries its length before it
# ("12strip_kernel"), which keeps strip_kernel's pattern off
# "18fused_strip_kernel".
PTXAS_KERNELS = {
    "strip_kernel": ("stencil2d", r"\dstrip_kernelILi(\d)ELi(\d)E", "R,terms"),
    "strip64_kernel": ("stencil2d", r"strip64_kernelILi(\d)ELi(\d)ELb([01])E",
                       "R,terms,16-byte"),
    "fused_strip_kernel": (
        "stencil2d", r"fused_strip_kernelILi(\d)ELi(\d)ELi(\d)ELi(\d+)E",
        "R,terms,K,kinds"),
    "wide_kernel": ("stencil1d", r"wide_kernelI([fd])E", "type"),
    "march_kernel": (
        "stencil3d",
        r"march_kernelI([fd])Li(\d)ELi(\d)ELi(\d)ELi(\d+)ELb([01])E",
        "type,R,K,terms,kinds,16-byte"),
    "resident_smem_kernel": (
        "resident2d", r"resident_smem_kernelI([fd])Li(\d)EEE", "type,R")}


def ptxas_table(log, pattern):
    """{instantiation: (registers, spill store bytes)} of the kernels whose
    entry name matches ``pattern``; raises on a spill."""
    import re

    table = {}
    for i, line in enumerate(log):
        m = re.search(pattern, line)
        if "Compiling entry function" in line and m:
            info = " ".join(log[i + 1: i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            table[",".join(m.groups())] = (int(regs.group(1)),
                                           int(spill.group(1)))
    if not table:
        raise AssertionError(f"no ptxas lines for {pattern}")
    spilled = {k: v for k, v in table.items() if v[1]}
    if spilled:
        raise AssertionError(f"{pattern} spills: {spilled}")
    return table


def redesigned(device, card, builds, step_ms, lib2, fp64_step, march_ms):
    """Phase 20: per redesigned kernel its registers and spills, device ms,
    bound and share of it, and library ms; the 2-D step beside the tile
    kernel it replaces (``step_ms``: phase 2's strip, tile and twin times,
    timed in turns), the float64 strip kernel's df64 steps beside the
    float64 tile kernel (``fp64_step``: phase 13's record, star2d1r's with
    box2d3r's inside), the 3-D march kernel's passes beside the general
    kernel's (``march_ms``: phases 7 and 19, each timed in turns) and the
    wide pass at three sizes; returns the large wide pass's record."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil1d as s1

    for kernel, (source, pattern, what) in PTXAS_KERNELS.items():
        table = ptxas_table(builds[source][2], pattern)
        print(f"phase 20: {kernel} registers per instantiation ({what}), no "
              f"spill: "
              + " ".join(f"{k}:{v[0]}" for k, v in sorted(table.items()))
              + f"; {SOURCES[source]} built in {builds[source][0]:.1f} s",
              flush=True)
    spec2 = get_shape("star2d1r")
    strip, plain, tile = step_ms
    bound2, by2 = bound_ms(spec2, INTERIOR, 1)
    print(f"phase 20: strip kernel, star2d1r 8192^2 step: {strip} ms "
          f"(device), {bound2 / strip:.4f} of its {bound2} ms {by2} bound; "
          f"the tile kernel it replaces {tile} ms ({tile / strip:.4f}x); "
          f"plain twin {plain} ms; F.conv2d 7x7 {lib2} ms [{card}]",
          flush=True)
    for rec in (fp64_step, fp64_step["box2d3r"]):
        print(f"phase 20: strip64_kernel, {rec['shape']} step: {rec['ms']} "
              f"ms (device), {rec['bound_ms'] / rec['ms']:.4f} of its "
              f"{rec['bound_ms']} ms {rec['bound_by']} bound; the float64 tile "
              f"kernel it replaces {rec['tile_kernel_ms']} ms "
              f"({rec['tile_kernel_ms'] / rec['ms']:.4f}x); float64 F.conv2d "
              f"{rec['library_ms']} ms [{card}]", flush=True)
    for label, ms, general, bound in march_ms:
        print(f"phase 20: march_kernel, {label} pass at 256^3: {ms} ms "
              f"(device), {bound / ms:.4f} of its {bound} ms bytes bound; "
              f"the general kernel {general} ms ({general / ms:.4f}x) "
              f"[{card}]", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    large = None
    for name, n, dtype, k in (("r40", 100_000, torch.float64, 1),
                              ("1d2r", N_1D, torch.float32, 2),
                              ("r40", N_1D_LARGE, torch.float64, 1)):
        spec = spec_1d(name)
        r = s1.effective_radius(spec)
        lay = layout_1d(spec, n, k * r)
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=dtype) * 0.01
        donor = torch.zeros_like(x)
        ms = graph_ms(lambda: s1.stencil1d_step(x, donor, spec, lay,
                                                fused_steps=k))
        itemsize = dtype.itemsize
        bound, by = bound_ms(spec, (n,), k, itemsize)
        lib = conv1d_ms(spec, n, device, dtype)
        tile = s1.pass_tile(lay.rounded, s1._sm_count(device.index or 0))
        print(f"phase 20: wide_kernel {str(dtype)[6:]} {name} {n} k={k}: {ms} ms "
              f"(device), {bound / ms:.4f} of its {bound} ms {by} bound; "
              f"one F.conv1d step {lib} ms; {lay.rounded // tile} blocks of "
              f"{tile} cells [{card}]", flush=True)
        if n == N_1D_LARGE:
            plain_ms = graph_ms(lambda: s1.stencil1d_step_plain(
                x, donor, spec, lay, k), 2)
            large = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=lib, steps_per_launch=k,
                         library_steps=1, shape=f"float64 {name} {n}")
        del x, donor
    return large


def loaded_reference_modules():
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "lorastencil_tpu"
                  or m.startswith("lorastencil_tpu."))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lorastencil_tpu_torch.models.shapes import get_shape
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
    builds = build_kernels()
    print(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}),"
          f" {nvcc}; built {len(builds)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (secs, ptxas, _) in builds.items():
        print(f"phase 1: {SOURCES[name]} {secs:.1f} s: {' | '.join(ptxas)}",
              flush=True)

    main_errs = None
    for name in ("star2d1r", "box2d1r"):
        for interior in ((1024, 1024), (1000, 1000), INTERIOR):
            errs = check_kernel(name, interior, device)
            if name == "star2d1r" and interior == INTERIOR:
                main_errs = errs
            print(f"phase 2: {name} {interior}: integer fill bit-exact at "
                  f"1-2 steps; pi/100 fill rel err {errs[1][1]:.3e} (1 "
                  f"step), {errs[4][1]:.3e} (4 steps) <= 1e-6; strip kernel "
                  f"bit-equal to the tile kernel", flush=True)
    wide_launches = check_wide_radius(device)
    print(f"phase 2: radius 5 (300, 140): the tile kernel bit-exact against "
          f"its twin at 1-2 steps on the integer fill, {wide_launches} "
          f"launches, none of the strip kernel", flush=True)
    spec2 = get_shape("star2d1r")
    ms2, plain_ms2, tile_ms2 = time_step(spec2, port_layout(spec2, INTERIOR),
                                         device)
    print(f"phase 2: one step at 8192^2: strip kernel {ms2} ms, the tile "
          f"kernel it replaces {tile_ms2} ms, plain twin {plain_ms2} ms "
          f"[{card}]", flush=True)

    launches2, rel = main_path(device)
    print(f"phase 3: run(8192^2, 2 steps) bit-exact against float64 on "
          f"the card, launches {launches2}; 256x384 x4 rel err "
          f"{rel:.3e} <= 1e-5", flush=True)

    bench(device, card)
    lib2 = library_ms(spec2, INTERIOR, device)
    bound2, by2 = bound_ms(spec2, INTERIOR, 1)
    print(f"phase 4: one step at 8192^2: F.conv2d 7x7 {lib2} ms; bound "
          f"{bound2} ms ({by2}) [{card}]", flush=True)

    main_errs_3d = {}
    for name in ("star3d1r", "box3d1r"):
        for interior in ((6, 20, 150), (37, 45, 130), INTERIOR_3D):
            for K in (1, 2, 4):
                abs_err, rel, same = check_kernel_3d(name, interior, K,
                                                     device)
                if interior == INTERIOR_3D and K == 2:
                    main_errs_3d[name] = abs_err
                which = ("the march kernel, bit-equal to the general "
                         "kernel," if K <= 2 else "the general kernel")
                print(f"phase 5: {name} {interior} K={K}: {which} integer "
                      f"fill bit-exact after 1-2 passes; pi/100 fill rel err "
                      f"{rel:.3e} after 4 steps (<= 1e-6), bit-equal "
                      f"{same}", flush=True)

    paths_3d = {}
    for name in ("star3d1r", "box3d1r"):
        launches, rel = main_path_3d(name, device)
        paths_3d[name] = launches
        print(f"phase 6: {name} {INTERIOR_3D}: 'vpu' at k=2; run(2) and "
              f"run(3) bit-exact against float64 on the card, every pass "
              f"the march kernel, launches {launches}; (24, 40, 200) x4 rel "
              f"err {rel:.3e} <= 1e-5", flush=True)

    timing_3d = {}
    for name in ("star3d1r", "box3d1r"):
        spec3 = get_shape(name)
        _, _, ms3, plain_ms3, general3 = bench_3d(name, device, card)
        lib3 = library_ms(spec3, INTERIOR_3D, device)
        bound3, by3 = bound_ms(spec3, INTERIOR_3D, 2)
        timing_3d[name] = (ms3, plain_ms3, lib3, bound3, by3, general3)
        print(f"phase 7: {name} one step at 256^3: F.conv3d 3x3x3 {lib3} "
              f"ms; bound of one k=2 pass {bound3} ms ({by3}) [{card}]",
              flush=True)

    errs_1d = {}
    for name, sizes in (("1d1r", (N_1D_SMALL, 3001, N_1D)),
                        ("1d2r", (N_1D_SMALL, 3001, N_1D)),
                        ("r40", (100_000,)), ("r127", (100_000,))):
        for n in sizes:
            errs = check_kernels_1d(name, n, device)
            for kernel, err in errs.items():
                errs_1d[kernel] = max(errs_1d.get(kernel, 0.0), err)
            print(f"phase 8: {name} {n}: {sorted(errs)} bit-exact against "
                  f"their twins (integer fill at 1-2 steps and one and two "
                  f"passes of k = 1, default, largest; pi/100 fill after 4 "
                  f"steps and 2*refresh+3 steps), max abs err "
                  f"{max(errs.values())}", flush=True)

    launches_1d, lines = main_path_1d(device)
    for line in lines:
        print(f"phase 9: {line}", flush=True)
    print(f"phase 9: launches over the phase, counted from zero: "
          f"{launches_1d}", flush=True)

    timing_1d = bench_1d(device, card)

    errs_fp64 = {}
    for name, interior, guard in FP64_2D_CASES:
        abs_err, rel, same = check_kernel_fp64(name, interior, device, guard)
        if name == "star2d1r" and interior == INTERIOR:
            errs_fp64["df64_step"] = (abs_err, rel, same)
        print(f"phase 11: df64_step {name} {interior} guard "
              f"{guard or 'default'}: the float64 strip kernel, bit-equal to "
              f"the float64 tile kernel and the twin on the integer, pi/100 "
              f"and inf fills; integer fill bit-exact at 1-2 steps; pi/100 "
              f"fill rel err {rel:.3e} after 4 steps (limit 1e-13), "
              f"bit-equal {same}", flush=True)
    for name, sizes in (("1d1r", (N_1D_SMALL, 3001, N_1D_LARGE)),
                        ("1d2r", (N_1D_SMALL, 3001, N_1D_LARGE)),
                        ("r40", (100_000,)), ("r127", (100_000,))):
        for n in sizes:
            errs = check_kernels_fp64_1d(name, n, device)
            for kernel, (abs_err, rel, same) in errs.items():
                old = errs_fp64.get(kernel, (0.0, 0.0, True))
                errs_fp64[kernel] = (max(old[0], abs_err), max(old[1], rel),
                                     old[2] and same)
                print(f"phase 11: {kernel} {name} {n}: integer fill "
                      f"bit-exact; pi/100 fill rel err {rel:.3e} after 4 "
                      f"steps (limit 1e-13), bit-equal {same}", flush=True)

    launches_fp64, lines = main_path_fp64(device)
    for line in lines:
        print(f"phase 12: {line}", flush=True)
    print(f"phase 12: launches over the phase, counted from zero: "
          f"{launches_fp64}", flush=True)

    timing_fp64 = bench_fp64(device, card)

    errs_fused = {}
    for name, interior, k, dtypes in FUSED_CASES:
        for dtype in dtypes:
            errs, strip = check_fused(name, interior, k, dtype, device)
            if name == FUSED_SHAPE and interior == INTERIOR:
                errs_fused = errs
            which = ("the fused strip kernel from both wrappers, bit-equal "
                     "to the tile-based fused and skew kernels," if strip
                     else "the tile-based fused and skew kernels")
            print(f"phase 14: {name} {interior} {dtype} k={k}: {which} "
                  f"bit-equal to single-step launches on both "
                  f"fills and to their twins on the 0/1 fill; pi/100 fill "
                  f"rel err fused {errs['fused'][1]:.3e}, skew "
                  f"{errs['skew'][1]:.3e} after {2 * k} steps", flush=True)
    errs_res = {}
    for name, interior, dtype in RESIDENT_CASES:
        errs_res[(name, dtype)] = check_resident(name, interior, dtype,
                                                 device)
        print(f"phase 14: resident {name} {interior} {dtype}: the "
              f"shared-memory kernel, bit-equal to single-step launches and "
              f"the grid-synced resident kernel at 1, 2 and 4 steps and to "
              f"its twin "
              f"on the integer fill; pi/100 "
              f"fill rel err {errs_res[(name, dtype)][1]:.3e} against the "
              f"fp64 ground truth after 4 steps", flush=True)

    launches_fused, errs_paths, lines = main_path_fused(device)
    for line in lines:
        print(f"phase 15: {line}", flush=True)

    timing_fused = bench_fused(device, card)

    errs_fp64_3d = {}
    for name in SHAPES_3D:
        for interior in ((37, 45, 130), INTERIOR_3D):
            for K in (1, 2):
                abs_err, rel, same = check_kernel_fp64_3d(name, interior, K,
                                                          device)
                if interior == INTERIOR_3D and K == 1:
                    errs_fp64_3d[name] = abs_err
                print(f"phase 17: df64_3d_step {name} {interior} K={K}: "
                      f"the march kernel, bit-equal to the general kernel; "
                      f"integer fill bit-exact against its twin and a float64 "
                      f"dense stencil after 1-2 passes; pi/100 fill rel err "
                      f"{rel:.3e} after 4 steps (limit 1e-13), bit-equal "
                      f"{same}", flush=True)

    launches_fp64_3d, total, lines = main_path_fp64_3d(device)
    for line in lines:
        print(f"phase 18: {line}", flush=True)
    print(f"phase 18: df64_3d_step launches over the phase, counted from "
          f"zero: {total}", flush=True)

    timing_fp64_3d = bench_fp64_3d(device, card)

    march_ms = [(f"float32 k=2 {name}", timing_3d[name][0],
                 timing_3d[name][5], timing_3d[name][3]) for name in SHAPES_3D]
    for name in SHAPES_3D:
        t = timing_fp64_3d[name]
        march_ms += [(f"df64 k=1 {name}", t["ms"], t["general_kernel_ms"],
                      t["bound_ms"]),
                     (f"float64 k=2 {name}", t["float64_k2_ms"],
                      t["float64_general_k2_ms"], t["bound_ms"])]
    wide_large = redesigned(device, card, builds, (ms2, plain_ms2, tile_ms2),
                            lib2, timing_fp64["df64_step"], march_ms)

    loaded = loaded_reference_modules()
    if loaded:
        raise AssertionError(f"the reference packages were imported: "
                             f"{loaded}")
    kernels = [{
        "name": "stencil2d_step", "route": "cuda",
        "source": SOURCES["stencil2d"], "replaces": REPLACES["stencil2d"],
        "kernel": "strip_kernel", "launches": launches2["stencil2d_k1"],
        "max_abs_err": main_errs[1][0], "ms": ms2, "plain_ms": plain_ms2,
        "bound_ms": bound2, "bound_by": by2, "library_ms": lib2,
        "tile_kernel_ms": tile_ms2}]
    for name in ("star3d1r", "box3d1r"):
        ms3, plain_ms3, lib3, bound3, by3, general3 = timing_3d[name]
        kernels.append({
            "name": f"stencil3d_step[{name}]", "route": "cuda",
            "source": SOURCES["stencil3d"], "replaces": REPLACES["stencil3d"],
            "kernel": "march_kernel",
            "launches": paths_3d[name][3]["stencil3d_march"],
            "max_abs_err": main_errs_3d[name], "ms": ms3,
            "plain_ms": plain_ms3, "bound_ms": bound3, "bound_by": by3,
            "library_ms": lib3, "steps_per_launch": 2, "library_steps": 1,
            "general_kernel_ms": general3})
    for kernel in KERNELS_1D:
        kernels.append(dict({
            "name": kernel, "route": "cuda", "source": SOURCES["stencil1d"],
            "replaces": REPLACES[kernel], "launches": launches_1d[kernel],
            "max_abs_err": errs_1d[kernel]}, **timing_1d[kernel]))
    for kernel in KERNELS_FP64:
        kernels.append(dict({
            "name": "df64_step[star2d1r]" if kernel == "df64_step" else kernel,
            "route": "cuda",
            "source": SOURCES["stencil2d" if kernel == "df64_step"
                              else "stencil1d"],
            "replaces": REPLACES[kernel], "launches": launches_fp64[kernel],
            "max_abs_err": errs_fp64[kernel][0]}, **timing_fp64[kernel]))
    for name, kernel, replaces, launches, err in (
            (f"stencil2d_step[k=2, {FUSED_SHAPE}]", "fused", "stencil2d",
             launches_fused[(FUSED_SHAPE, "extent k=2", "float32")],
             errs_fused["fused"][0]),
            (f"stencil2d_skew_step[{FUSED_SHAPE}]", "skew", "stencil2d_skew",
             launches_fused[(FUSED_SHAPE, "skew", "float32")],
             errs_fused["skew"][0]),
            ("stencil2d_resident[star2d1r 512x512]", "resident",
             "stencil2d_resident",
             launches_fused[("star2d1r", "resident", "float32")],
             errs_res[("star2d1r", torch.float32)][0]),
            ("stencil2d_resident_pair[star2d1r 512x512]", "resident_pair",
             "stencil2d_resident_pair",
             launches_fused[("star2d1r", "resident", "df64")],
             errs_res[("star2d1r", torch.float64)][0]),
            ("stencil2d_resident[custom_r5 480x480]", "resident_r5",
             "stencil2d_resident",
             launches_fused[("custom_r5", "resident", "float32")],
             errs_paths[("custom_r5", "resident", "float32")]),
            ("stencil2d_resident_pair[custom_r5 480x480]",
             "resident_pair_r5",
             "stencil2d_resident_pair",
             launches_fused[("custom_r5", "resident", "df64")],
             errs_paths[("custom_r5", "resident", "df64")])):
        source = ("resident2d" if timing_fused.get(kernel, {}).get("kernel")
                  == "resident_smem_kernel" else "stencil2d")
        kernels.append(dict({
            "name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": REPLACES[replaces], "launches": launches,
            "max_abs_err": err}, **timing_fused[kernel]))
    kernels.append(dict({
        "name": f"df64_1d_flat_step[r40 {N_1D_LARGE}]", "route": "cuda",
        "source": SOURCES["stencil1d"],
        "replaces": REPLACES["df64_1d_flat_step"],
        "launches": launches_fp64["df64_1d_flat_step"],
        "max_abs_err": errs_fp64["df64_1d_flat_step"][0]}, **wide_large))
    for name in SHAPES_3D:
        kernels.append(dict({
            "name": f"df64_3d_step[{name}]", "route": "cuda",
            "source": SOURCES["stencil3d"],
            "replaces": REPLACES["df64_3d_step"], "kernel": "march_kernel",
            "launches": launches_fp64_3d[(name, "df64", 4)],
            "max_abs_err": errs_fp64_3d[name]}, **timing_fp64_3d[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
