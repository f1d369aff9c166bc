"""2-D stencil passes on the internal layout: the CUDA kernels' wrappers.

Counterpart of ``lorastencil_tpu/ops/pallas_2d.py`` ``stencil2d_step``
(kernel ``_stencil2d_kernel``, every fused depth), ``stencil2d_skew_step``
(``_stencil2d_skew_kernel``) and ``stencil2d_resident``
(``_stencil2d_resident_kernel``), and of ``lorastencil_tpu/ops/
pallas_df64.py`` ``df64_step`` (``_df64_kernel``) and
``stencil2d_resident_pair``.  ``csrc/stencil2d.cu`` has a float32 and a
float64 instance of each kernel: a wrapper launches the one of its state's
dtype.  On a CUDA tensor a wrapper launches or raises; only a CPU tensor
runs the plain PyTorch twin (``*_plain``), which is also callable directly
(the tests and ``chip_smoke.py`` hold the kernels against them on the
card); the skew kernel's twin is the fused pass's.

``algorithm``: the TPU kernel's exact-fp32 variants ``'mxu_hybrid1'``,
``'vpu_roll'`` and ``'vpu'`` differ only in how they use the TPU's matrix
and vector units.  On Hopper they are one computation, so all three run
this one CUDA-core kernel.  The TPU's df64 variants ``'vpu'``,
``'vpu_roll'`` and ``'vpu_sep'`` (dense rolls, dense slices, separable
form on (hi, lo) fp32 pairs) are likewise one native-fp64 computation:
all three run the float64 instance.  The lossy or TPU-specific fp32
variants are still to be ported (ROADMAP B13).

A step (k = 1) of radius 1-4 with at most three terms, which is every
2-D registry shape's, runs the strip kernel of its dtype (``strip_takes``):
a warp walks down a strip of rows keeping the column convs in registers
(four float32 or two float64 cells a lane), its plan by value in the
launch's parameters (``plan_array`` in host memory, in the state's dtype).
So every 2-D step of the fp64-grade tier (dtypes 'df64' and 'float64')
runs the float64 strip kernel.  Every other step runs the tile kernel, as
the fused levels do; the two give the same values cell for cell.
``stencil2d_step.launches`` counts the float32 launches of both,
``launches_f64`` the float64 ones, ``launches_k1`` the strip kernels' in
either dtype.

A float32 pass of two fused steps of radius 1-4 with one or two terms and
no residue, star2d3r's (the one registry shape the engine fuses by
default), runs the fused strip kernel (``fused_strip_takes``), from either
wrapper: the strip kernel's walk with every level kept in registers, which
computes the same values as the fused and the skewed tile kernels in
another traversal.  Each wrapper counts its launches in
``launches_fused_strip`` too.  Every other fused or skewed pass runs the
tile kernels.

Shared memory bounds the reach of one launch: a fused pass holds about
three (32 + 2kr) x (128 + 2kr) windows (16 rows in float64), a skewed one a
band of every level.  A pass deeper than the largest k that fits
(``max_fused_steps``) runs as launches of that k, each counted; the values
do not change, because every level is masked to the interior.

A whole-grid run (``stencil2d_resident``) of radius 1-4 with at most three
terms, every registry shape's, runs the shared-memory resident kernel of
``csrc/resident2d.cu`` (``resident_takes``): one block per SM holds a
rectangle of the state in shared memory for the whole run and swaps its
border with its neighbours only, as tagged words in a zeroed buffer of two
parities.  Its capacity is the kernel's own (``resident_capacity``).
Every other run
takes ``csrc/stencil2d.cu``'s resident kernel, which streams the state
through device memory with a grid barrier per step.  The wrapper counts
both in ``launches`` / ``launches_f64``, the first in ``launches_smem``
too.  On a card the runs are on by default below ``CUDA_RESIDENT_2D_BYTES``
/ ``CUDA_RESIDENT_PAIR_2D_BYTES`` (measured on an H100); on the CPU the
JAX package's caps hold, off by default.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ..models.shapes import StencilSpec

from . import _cuda_build
from .band_gemm import apply_spec, mask_to_interior, plan_array
from .layout import Layout2D

ALGORITHMS = ("mxu_hybrid1", "vpu_roll", "vpu")
# the names pallas_df64.df64_step takes
DF64_ALGORITHMS = ("vpu", "vpu_roll", "vpu_sep")
# the names pallas_2d.stencil2d_skew_step takes
SKEW_ALGORITHMS = ("vpu_roll", "mxu_hybrid1")
# the TPU kernel's other variants, still to be ported (ROADMAP B13)
UNPORTED_ALGORITHMS = ("mxu", "mxu_split", "mxu_hybrid", "mxu_hybrid1r",
                       "mxu_hybrid3")
MAX_RADIUS = 16  # csrc/stencil2d.cu kMaxRadius
MAX_PLAN = 4096  # csrc/stencil2d.cu kMaxPlan
MAX_SMEM = 232448  # csrc/stencil2d.cu kMaxSmem: bytes a block may use
TILE_COLS = 128  # csrc/stencil2d.cu kTileCols
# csrc/stencil2d.cu's strip kernel: radii and terms it takes
STRIP_RADII = (1, 2, 3, 4)
STRIP_MAX_TERMS = 3
# csrc/stencil2d.cu's fused strip kernel: the depths and terms it takes
FUSED_STRIP_DEPTHS = (2,)
FUSED_STRIP_MAX_TERMS = 2
_ENTRIES = {
    "strip": {torch.float32: "ls_stencil2d_strip",
              torch.float64: "ls_stencil2d_strip_f64"},
    # the fused strip kernel, launched by stencil2d_step and by
    # stencil2d_skew_step: one entry, a kind for each wrapper's counts
    "fused_strip": {torch.float32: "ls_stencil2d_fused_strip"},
    "fused_strip_skew": {torch.float32: "ls_stencil2d_fused_strip"},
    "step": {torch.float32: "ls_stencil2d_step",
             torch.float64: "ls_stencil2d_step_f64"},
    "skew": {torch.float32: "ls_stencil2d_skew",
             torch.float64: "ls_stencil2d_skew_f64"},
    "resident": {torch.float32: "ls_stencil2d_resident",
                 torch.float64: "ls_stencil2d_resident_f64"}}
# csrc/resident2d.cu's shared-memory resident kernel
_RESIDENT_SMEM = {torch.float32: "ls_stencil2d_resident_smem",
                  torch.float64: "ls_stencil2d_resident_smem_f64"}
# csrc/resident2d.cu kWindowBytes: a window's bytes, at most (two of them
# beside the residue's 81 offsets in a block's 232,448 bytes)
RESIDENT_SMEM_BYTES = (232448 - 4 * 81) // 2

# Whole-grid runs: the JAX package's caps on the internal buffer's bytes
# (pallas_2d.RESIDENT_2D_BYTES, pallas_df64.RESIDENT_PAIR_2D_BYTES), read
# from the same environment variables and off (0) by default.  The test is
# the port's, on the port's layout: near a cap the two packages may choose
# differently (ROADMAP section C).
RESIDENT_2D_BYTES = int(os.environ.get("LORASTENCIL_RESIDENT2D_KB",
                                       "0")) * 1024
RESIDENT_PAIR_2D_BYTES = int(os.environ.get(
    "LORASTENCIL_RESIDENT2D_PAIR_KB", "0")) * 1024
# The caps on a card where the variables are unset: the largest internal
# buffer at which a 64-step resident run beat the tiled passes at every
# size measured up to it, in each of two runs (chip_smoke.py phase 16,
# star2d1r and box2d3r at 256^2, 512^2, 1024^2 and the largest grid the
# kernel's capacity takes; NVIDIA H100 80GB HBM3, 700.00 W).  The tiled
# runs are host-bound and their time moves from run to run; the resident
# kernel's does not.  run_internal x 64, tiled -> resident, ms (run 1;
# run 2):
#   float32 1024^2 (4,260,096 bytes): star2d1r 2.911 -> 0.892 (2.223 ->
#     0.763), box2d3r 2.001 -> 1.018 (1.896 -> 1.015); at 1664^2 box2d3r
#     2.306 -> 2.235 (1.851 -> 2.154: lost);
#   df64 512^2 (2,163,200 bytes): star2d1r 2.835 -> 0.593 (2.742 ->
#     0.550), box2d3r 2.315 -> 0.847 (2.857 -> 0.894); at 1024^2 box2d3r
#     2.687 -> 1.852 (1.637 -> 1.769: lost).
# Every smaller size won by more.  The float32 cap also serves dtype
# float64 at 8 bytes a cell, as in the JAX package.
H100_RESIDENT_2D_BYTES = 4_260_096
H100_RESIDENT_PAIR_2D_BYTES = 2_163_200


def cuda_cap(env: str, default: int) -> int:
    """The cap a CUDA state takes: the variable ``env`` (KiB) where it is
    set, 0 turning the runs off, else ``default``."""
    return int(os.environ[env]) * 1024 if env in os.environ else default


CUDA_RESIDENT_2D_BYTES = cuda_cap("LORASTENCIL_RESIDENT2D_KB",
                                  H100_RESIDENT_2D_BYTES)
CUDA_RESIDENT_PAIR_2D_BYTES = cuda_cap("LORASTENCIL_RESIDENT2D_PAIR_KB",
                                       H100_RESIDENT_PAIR_2D_BYTES)


def _fits(layout, dtype, cap: int, cuda_cap: int, device, spec) -> bool:
    if not isinstance(layout, Layout2D) or layout.extra_row_tiles:
        return False
    R, C = layout.shape
    nbytes = R * C * dtype.itemsize
    if device is None or torch.device(device).type != "cuda":
        return nbytes <= cap
    if nbytes > cuda_cap:
        return False
    capacity = (None if spec is None
                else resident_capacity(spec, dtype, device))
    return capacity is None or nbytes <= capacity


def fits_resident_2d(layout, itemsize: int = 4, device=None,
                     spec: StencilSpec = None) -> bool:
    """Whether the float32 (or, at ``itemsize`` 8, float64) state runs all
    its steps in one ``stencil2d_resident`` launch: under
    ``RESIDENT_2D_BYTES``, or on a CUDA ``device`` under
    ``CUDA_RESIDENT_2D_BYTES`` and the capacity of the kernel that takes
    ``spec`` (``resident_capacity``)."""
    dtype = torch.float64 if itemsize == 8 else torch.float32
    return _fits(layout, dtype, RESIDENT_2D_BYTES, CUDA_RESIDENT_2D_BYTES,
                 device, spec)


def fits_resident_pair_2d(layout, device=None,
                          spec: StencilSpec = None) -> bool:
    """Whether a df64 state runs all its steps in one launch: the JAX
    pair grid's 2 * R * C * 4 bytes, R * C * 8 for the float64 state,
    under ``RESIDENT_PAIR_2D_BYTES``, or on a CUDA ``device`` under
    ``CUDA_RESIDENT_PAIR_2D_BYTES`` and the kernel's capacity."""
    return _fits(layout, torch.float64, RESIDENT_PAIR_2D_BYTES,
                 CUDA_RESIDENT_PAIR_2D_BYTES, device, spec)


def resident_takes(spec: StencilSpec, dtype) -> bool:
    """Whether a whole-grid run in ``dtype`` runs the shared-memory
    resident kernel: float32 or float64, radius 1-4, at most three terms
    (every registry shape); else ``csrc/stencil2d.cu``'s resident kernel."""
    return (dtype in _RESIDENT_SMEM and spec.radius in STRIP_RADII
            and len(spec.terms) <= STRIP_MAX_TERMS)


def resident_capacity_bytes(itemsize: int, blocks: int) -> int:
    """csrc/resident2d.cu capacity_bytes: the largest internal buffer
    (rows x pitch cells) a launch over ``blocks`` blocks (one per SM)
    takes, 4/5 of the cells their windows hold."""
    return 4 * blocks * (RESIDENT_SMEM_BYTES // itemsize) // 5 * itemsize


def resident_capacity(spec: StencilSpec, dtype, device):
    """Bytes of the largest internal buffer the kernel that takes a run
    of ``spec`` in ``dtype`` holds on ``device`` (the card answers, through
    ``ls_stencil2d_resident_capacity``), or None where that is
    ``csrc/stencil2d.cu``'s kernel, which streams through device memory."""
    if not resident_takes(spec, dtype):
        return None
    return _capacity(dtype == torch.float64, spec.radius, len(spec.terms),
                     torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _capacity(f64: bool, radius: int, n_terms: int, index: int) -> int:
    with torch.cuda.device(index):
        cap = _resident_lib().ls_stencil2d_resident_capacity(
            int(f64), radius, n_terms)
    if cap <= 0:
        raise RuntimeError(f"resident capacity query failed: {cap}")
    return cap


def tile_rows(dtype) -> int:
    """Output rows of a block tile and of a skew band (csrc/stencil2d.cu
    tile_rows): 32 in float32, 16 in float64."""
    return 16 if dtype == torch.float64 else 32


def strip_takes(spec: StencilSpec, dtype, depth: int = 1) -> bool:
    """Whether a launch of ``depth`` fused steps in ``dtype`` runs a strip
    kernel: float32 or float64, one step, radius 1-4, at most three
    terms."""
    return (dtype in _ENTRIES["strip"] and depth == 1
            and spec.radius in STRIP_RADII
            and len(spec.terms) <= STRIP_MAX_TERMS)


def fused_strip_takes(spec: StencilSpec, dtype, depth: int) -> bool:
    """Whether a launch of ``depth`` fused steps in ``dtype`` runs the
    fused strip kernel: float32, two steps, radius 1-4, one or two terms,
    each with a row or a column axis, and no residue."""
    return (dtype == torch.float32 and depth in FUSED_STRIP_DEPTHS
            and spec.radius in STRIP_RADII
            and 1 <= len(spec.terms) <= FUSED_STRIP_MAX_TERMS
            and all(any(a is not None for a in term.taps)
                    for term in spec.terms)
            and not spec.residue)


def plan_len(spec: StencilSpec) -> int:
    """Entries of the kernels' tap table (``band_gemm.plan_array``)."""
    W = 2 * spec.radius + 1
    return len(spec.terms) * (2 + 2 * W) + 3 * len(spec.residue)


def smem_bytes(kind: str, k: int, radius: int, n_plan: int,
               dtype=torch.float32) -> int:
    """Shared memory of one launch (csrc/stencil2d.cu step_cells and
    skew_cells): ``kind`` "step" (a pass of k fused steps, or one step of
    a resident run at k = 1) or "skew"."""
    tm, R = tile_rows(dtype), radius
    if kind == "skew":
        band = tm + 2 * R
        cells = n_plan + band * (TILE_COLS + 2 * (k - 1) * R)
        cells += sum(band * (TILE_COLS + 2 * (k - lv) * R)
                     for lv in range(k))
    else:
        E, e1 = k * R, (k - 1) * R
        cells = ((tm + 2 * E) * (TILE_COLS + 2 * E)
                 + ((tm + 2 * e1) * (TILE_COLS + 2 * e1) if k > 1 else 0)
                 + (tm + 2 * E) * (TILE_COLS + 2 * e1) + n_plan)
    return cells * (8 if dtype == torch.float64 else 4)


@functools.lru_cache(maxsize=None)
def max_fused_steps(kind: str, radius: int, n_plan: int,
                    dtype=torch.float32) -> int:
    """The deepest pass of ``kind`` one launch takes (its shared memory
    within ``MAX_SMEM``), at least 1 ("step") or 2 ("skew"); 128 steps, the
    engine's largest k, when the radius is 0."""
    k = 1 if kind == "step" else 2
    while k < 128 and smem_bytes(kind, k + 1, radius, n_plan,
                                 dtype) <= MAX_SMEM:
        k += 1
    return k


def _check_state(cur, spec: StencilSpec, layout: Layout2D, reach: int):
    if spec.ndim != 2:
        raise ValueError(f"{spec.name} is {spec.ndim}-D, not 2-D")
    if spec.radius > MAX_RADIUS:
        raise ValueError(
            f"radius {spec.radius} exceeds the kernel's cap {MAX_RADIUS}")
    layout.validate()
    if min(layout.guard) < reach:
        raise ValueError(
            f"guard {layout.guard} is narrower than the pass's reach "
            f"{reach} (fused steps x radius {spec.radius})")
    if cur.dtype not in _ENTRIES["step"]:
        raise TypeError(f"cur must be float32 or float64, got {cur.dtype}")
    if tuple(cur.shape) != layout.shape:
        raise ValueError(
            f"cur has shape {tuple(cur.shape)}, layout is {layout.shape}")
    if not cur.is_contiguous():
        raise ValueError("cur must be contiguous")
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stencil2d kernel for device {cur.device}")


def _check(cur, donor, spec: StencilSpec, layout: Layout2D,
           algorithm: str, fused_steps: int):
    # a float64 state also takes the df64 names ('vpu_sep' is the new one)
    algorithms = (ALGORITHMS + ("vpu_sep",) if cur.dtype == torch.float64
                  else ALGORITHMS)
    if algorithm in UNPORTED_ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {algorithm!r} is not ported yet (ROADMAP B13); "
            f"the port runs {ALGORITHMS} through one exact fp32 kernel")
    if algorithm not in algorithms:
        raise ValueError(f"unknown algorithm {algorithm!r}; this wrapper "
                         f"takes {algorithms}")
    if fused_steps < 1:
        raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
    _check_state(cur, spec, layout, fused_steps * spec.radius)
    if donor.dtype != cur.dtype:
        raise TypeError(f"donor must be {cur.dtype}, got {donor.dtype}")
    if tuple(donor.shape) != layout.shape:
        raise ValueError(
            f"donor has shape {tuple(donor.shape)}, layout is "
            f"{layout.shape}")
    if not donor.is_contiguous():
        raise ValueError("donor must be contiguous")
    if cur.device != donor.device:
        raise ValueError(
            f"cur on {cur.device} but donor on {donor.device}")
    if cur.data_ptr() == donor.data_ptr():
        raise ValueError("donor must be a different buffer from cur")


def stencil2d_step_plain(cur, donor, spec: StencilSpec, layout: Layout2D,
                         fused_steps: int = 1):
    """The step and fused kernels' plain PyTorch twin: the same pass with
    tensor ops on whatever device and dtype ``cur`` has.  Level L = 1..k
    steps the window at reach (k - L) r around the rounded interior and
    zeroes its cells outside the true interior; level k is written to the
    rounded interior of ``donor`` in place, which is returned.  The guard
    ring of ``donor`` is left as it is."""
    r = spec.radius
    r0, c0 = layout.origin
    mr, nr = layout.rounded
    e = fused_steps * r
    val = cur[r0 - e: r0 + mr + e, c0 - e: c0 + nr + e]
    for _ in range(fused_steps):
        e -= r
        val = mask_to_interior(apply_spec(val, spec, (r, r)),
                               *layout.interior, margin=e)
    donor[r0: r0 + mr, c0: c0 + nr] = val
    return donor


def stencil2d_resident_plain(cur, spec: StencilSpec, layout: Layout2D,
                             steps: int):
    """The resident kernel's plain twin: ``steps`` single steps between
    two new zeroed buffers; returns the last one written."""
    bufs = (torch.zeros_like(cur), torch.zeros_like(cur))
    for s in range(steps):
        cur = stencil2d_step_plain(cur, bufs[s % 2], spec, layout)
    return cur


@functools.lru_cache(maxsize=None)
def _plan_buffer(spec: StencilSpec, device: torch.device, dtype):
    """The tap/residue table in ``dtype`` on ``device``, built once per
    (spec, device, dtype) and never per step."""
    plan = plan_array(spec, dtype)
    if plan.numel() > MAX_PLAN:
        raise ValueError(
            f"{spec.name}: tap table of {plan.numel()} entries exceeds the "
            f"kernel's cap {MAX_PLAN}")
    return plan.to(device)


# the kinds whose launch copies the plan from host memory into the
# kernel's parameters
_HOST_PLAN = ("strip", "fused_strip", "fused_strip_skew")


@functools.lru_cache(maxsize=None)
def _plan_host(spec: StencilSpec, dtype):
    """The tap/residue table in ``dtype`` in host memory, which the strip
    kernels' launches copy into their parameters: a float64 tap rounded
    through float32 would change the float64 kernel's sums."""
    return plan_array(spec, dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built and bound once per process."""
    lib = _cuda_build.load("stencil2d")
    for kind, entries in _ENTRIES.items():
        pointers = 4 if kind == "resident" else 3
        for entry in entries.values():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 13
                           + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _resident_lib():
    """csrc/resident2d.cu, built and bound once per process."""
    lib = _cuda_build.load("resident2d")
    for entry in _RESIDENT_SMEM.values():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.ls_stencil2d_resident_capacity.restype = ctypes.c_longlong
    lib.ls_stencil2d_resident_capacity.argtypes = [ctypes.c_int] * 3
    return lib


def _launch_resident_smem(cur, spec: StencilSpec, layout: Layout2D,
                          steps: int):
    """One launch of the shared-memory resident kernel, with a zeroed
    output buffer and tagged exchange words; returns the output.  Raises
    if refused (a buffer above its capacity among them)."""
    plan = _plan_host(spec, cur.dtype)
    out = torch.zeros_like(cur)
    mr, nr = layout.rounded
    xch = torch.zeros(2 * mr * nr * (cur.element_size() // 4),
                      dtype=torch.int64, device=cur.device)
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_resident_lib(), _RESIDENT_SMEM[cur.dtype])(
            cur.data_ptr(), out.data_ptr(), xch.data_ptr(), xch.numel(),
            plan.data_ptr(), plan.numel(), len(spec.terms), spec.radius,
            len(spec.residue), rows, pitch, r0, c0, m, n, mr, nr, steps,
            stream)
    if err != 0:
        raise RuntimeError(
            f"stencil2d shared-memory resident kernel launch failed: CUDA "
            f"error {err}")
    if cur.dtype == torch.float64:
        stencil2d_resident.launches_f64 += 1
    else:
        stencil2d_resident.launches += 1
    stencil2d_resident.launches_smem += 1
    return out


def _launch(kind: str, buffers, spec: StencilSpec, layout: Layout2D,
            depth: int):
    """One launch of ``kind``'s instance of the buffers' dtype: ``depth``
    fused steps ("step", "strip", "skew", and the fused strip kernel as
    "fused_strip" for ``stencil2d_step`` or "fused_strip_skew" for
    ``stencil2d_skew_step``) or the steps of a run ("resident"); raises if
    refused, and counts it on the wrapper it serves."""
    cur = buffers[0]
    plan = (_plan_host(spec, cur.dtype) if kind in _HOST_PLAN
            else _plan_buffer(spec, cur.device, cur.dtype))
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), _ENTRIES[kind][cur.dtype])(
            *(b.data_ptr() for b in buffers), plan.data_ptr(), plan.numel(),
            len(spec.terms), spec.radius, len(spec.residue), rows, pitch, r0,
            c0, m, n, mr, nr, depth, stream)
    if err != 0:
        raise RuntimeError(
            f"stencil2d {kind} kernel launch failed: CUDA error {err}")
    wrapper = {"strip": stencil2d_step, "step": stencil2d_step,
               "fused_strip": stencil2d_step,
               "skew": stencil2d_skew_step,
               "fused_strip_skew": stencil2d_skew_step,
               "resident": stencil2d_resident}[kind]
    if cur.dtype == torch.float64:
        wrapper.launches_f64 += 1
    else:
        wrapper.launches += 1
    if kind == "strip":
        wrapper.launches_k1 += 1
    elif kind.startswith("fused_strip"):
        wrapper.launches_fused_strip += 1


def _split_pass(kind: str, cur, donor, spec: StencilSpec, layout: Layout2D,
                k: int):
    """A pass of k steps as launches of at most the k one launch takes,
    from ``cur`` into ``donor`` and, past the first, a spare zero-guarded
    buffer by turns; returns the buffer the last launch wrote.  A
    leftover single step runs the strip kernel where ``strip_takes`` says
    so (else the step kernel); a launch that ``fused_strip_takes`` runs
    the fused strip kernel, counted on the wrapper of ``kind``."""
    kmax = max_fused_steps(kind, spec.radius, plan_len(spec), cur.dtype)
    depths = [kmax] * (k // kmax) + ([k % kmax] if k % kmax else [])
    src, spare = cur, None
    for i, depth in enumerate(depths):
        if i == 0:
            dst = donor
        else:
            if spare is None:
                spare = torch.zeros_like(donor)
            dst = spare if src is donor else donor
        if depth == 1:
            one = "strip" if strip_takes(spec, cur.dtype) else "step"
        elif fused_strip_takes(spec, cur.dtype, depth):
            one = "fused_strip" if kind == "step" else "fused_strip_skew"
        else:
            one = kind
        _launch(one, (src, dst), spec, layout, depth)
        src = dst
    return src


def stencil2d_step(cur, donor, spec: StencilSpec, layout: Layout2D,
                   algorithm: str = "mxu_hybrid1", fused_steps: int = 1):
    """``fused_steps`` timesteps on the internal layout: reads ``cur``,
    writes the rounded interior of ``donor`` in place and returns it (past
    ``max_fused_steps`` of one launch, the buffer the last launch wrote).

    ``donor``'s guard ring must be zero; it stays untouched, which is
    what makes the halo decay after the first step.  The layout's guard
    must cover the reach ``fused_steps * radius``.  A CUDA tensor runs the
    kernel's instance of its dtype (or raises); a CPU tensor runs
    ``stencil2d_step_plain``.  On a float64 state (dtypes 'float64' and
    'df64') it is also the fp64-grade step of ``pallas_df64.df64_step``
    and takes that wrapper's name 'vpu_sep'.  ``launches`` counts the
    float32 instances' launches, ``launches_f64`` the float64 ones',
    ``launches_k1`` those of the steps a strip kernel ran (either dtype)
    and ``launches_fused_strip`` those of the fused strip kernel."""
    _check(cur, donor, spec, layout, algorithm, fused_steps)
    if cur.device.type == "cpu":
        return stencil2d_step_plain(cur, donor, spec, layout, fused_steps)
    return _split_pass("step", cur, donor, spec, layout, fused_steps)


def stencil2d_skew_step(cur, donor, spec: StencilSpec, layout: Layout2D,
                        algorithm: str = "vpu_roll", skew_steps: int = 2):
    """``skew_steps`` >= 2 timesteps per pass over device memory by
    time-skewed row bands (``pallas_2d.stencil2d_skew_step``): the same
    values as ``stencil2d_step`` at the same depth, in another traversal.
    Takes what that wrapper takes: algorithm 'vpu_roll' or 'mxu_hybrid1',
    a guard covering ``skew_steps * radius`` (the port's layout, which
    needs no extra row tiles), a band of ``tile_rows`` rows at least 2r
    deep.  Counts its launches as ``stencil2d_step`` does, the fused strip
    kernel's in ``launches_fused_strip`` too.  The kernel
    changes only the traversal, never a value, so its plain twin, which a
    CPU tensor runs, is the fused pass's, ``stencil2d_step_plain``."""
    if algorithm not in SKEW_ALGORITHMS:
        raise ValueError(
            f"skewed fusion supports algorithm 'vpu_roll' or "
            f"'mxu_hybrid1', got {algorithm!r}")
    if skew_steps < 2:
        raise ValueError("skew_steps must be >= 2 (use the plain step "
                         "for k=1)")
    _check(cur, donor, spec, layout, algorithm, skew_steps)
    if tile_rows(cur.dtype) < 2 * spec.radius:
        raise ValueError(
            f"band height (tile rows) must be >= 2 * {spec.radius}; got "
            f"{tile_rows(cur.dtype)}")
    if cur.device.type == "cpu":
        return stencil2d_step_plain(cur, donor, spec, layout, skew_steps)
    return _split_pass("skew", cur, donor, spec, layout, skew_steps)


def stencil2d_resident(cur, spec: StencilSpec, layout: Layout2D,
                       steps: int):
    """All ``steps`` timesteps in one cooperative launch
    (``pallas_2d.stencil2d_resident``; on a float64 state
    ``pallas_df64.stencil2d_resident_pair``): reads ``cur`` and returns a
    new buffer, the same values as ``steps`` single steps.  A CUDA state
    runs the shared-memory resident kernel where ``resident_takes`` says
    so, else ``csrc/stencil2d.cu``'s; raises if the card refuses the
    launch (no fallback to passes or to the other kernel).  The engine
    takes this path only under the caps ``fits_resident_2d`` and
    ``fits_resident_pair_2d``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    _check_state(cur, spec, layout, spec.radius)
    if cur.device.type == "cpu":
        return stencil2d_resident_plain(cur, spec, layout, steps)
    if resident_takes(spec, cur.dtype):
        return _launch_resident_smem(cur, spec, layout, steps)
    outs = (torch.zeros_like(cur), torch.zeros_like(cur))
    _launch("resident", (cur,) + outs, spec, layout, steps)
    return outs[(steps - 1) % 2]


# kernel launches per instance, for chip_smoke.py: float32 and float64, and
# the strip kernels' launches apart (launches_k1: the strip kernel's steps
# in either dtype; launches_fused_strip: the fused strip kernel's passes;
# launches_smem: the shared-memory resident kernel's runs)
for _wrapper in (stencil2d_step, stencil2d_skew_step, stencil2d_resident):
    _wrapper.launches = _wrapper.launches_f64 = 0
stencil2d_step.launches_k1 = 0
stencil2d_resident.launches_smem = 0
for _wrapper in (stencil2d_step, stencil2d_skew_step):
    _wrapper.launches_fused_strip = 0
del _wrapper


# -- 'auto' for the df64 tier (pallas_df64.pick_algorithm, NumPy only) -------
# The JAX engine labels a 2-D df64 engine with the pair kernel's variant
# whose static op count is lowest; the port runs every variant through the
# one fp64 kernel and keeps the label, so both engines name the same
# algorithm.  Cost units and rules are pallas_df64's.
_COST_PRODUCT = 20.0
_COST_FOLD = 13.0
_COST_SPLIT = 3.0
_COST_ROLL = 3.0


def _split_weight(w64):
    """fp64 weight -> (w_h, w_l), its fp32 head and the fp32 rounding of
    the rest (the two halves the costs read)."""
    wh = np.float32(np.float64(w64))
    return float(wh), float(np.float32(np.float64(w64) - np.float64(wh)))


def _fold_taps(taps):
    """Odd-length taps -> ('single', d, w) and, for equal +-d weights,
    ('pair', d, w) entries."""
    taps = [float(t) for t in taps]
    r = (len(taps) - 1) // 2
    entries = []
    if taps[r] != 0.0:
        entries.append(("single", 0, _split_weight(taps[r])))
    for d in range(1, r + 1):
        wp, wm = taps[r + d], taps[r - d]
        if wp == wm:
            if wp != 0.0:
                entries.append(("pair", d, _split_weight(wp)))
        else:
            if wp != 0.0:
                entries.append(("single", d, _split_weight(wp)))
            if wm != 0.0:
                entries.append(("single", -d, _split_weight(wm)))
    return tuple(entries)


def _sep_plan(spec: StencilSpec):
    """((col_ops|None, row_ops|None) per term, folded residue entries):
    residue offsets o and -o with equal weights fold into a pair."""
    terms = tuple(tuple(None if t is None else _fold_taps(t)
                        for t in term.taps) for term in spec.terms)
    items = [(tuple(int(o) for o in off), float(w))
             for off, w in spec.residue]
    used = set()
    res = []
    for i, (off, w) in enumerate(items):
        if i in used:
            continue
        neg = tuple(-o for o in off)
        j = next((k for k in range(i + 1, len(items))
                  if k not in used and items[k][0] == neg
                  and items[k][1] == w), None)
        if j is not None and off != neg:
            used.add(j)
            res.append(("pair", off, _split_weight(w)))
        else:
            res.append(("single", off, _split_weight(w)))
    return terms, tuple(res)


def _entry_cost(kind: str, d, w2) -> float:
    """Cost of one folded entry on the code path the pair kernel takes."""
    unit = 1.0 if isinstance(d, int) else float(sum(1 for o in d if o))
    is_zero = (d == 0) if isinstance(d, int) else not any(d)
    w_pm1 = (abs(w2[0]), w2[1]) == (1.0, 0.0)
    if kind == "pair":
        cost = 4 * unit * _COST_ROLL + _COST_FOLD
        if w_pm1:
            return cost + _COST_FOLD
        return cost + _COST_SPLIT + _COST_PRODUCT
    if is_zero:
        return _COST_FOLD if w_pm1 else _COST_PRODUCT
    if w_pm1:
        return 2 * unit * _COST_ROLL + _COST_FOLD
    return 3 * unit * _COST_ROLL + _COST_PRODUCT


def _sep_cost(spec: StencilSpec) -> float:
    terms, res = _sep_plan(spec)
    cost = _COST_SPLIT
    for axes in terms:
        for ai, ops in enumerate(axes):
            if ops is None:
                continue
            cost += sum(_entry_cost(kind, d, w) for kind, d, w in ops)
            if ai > 0:
                cost += _COST_SPLIT
    return cost + sum(_entry_cost(kind, off, w) for kind, off, w in res)


def _dense_cost(spec: StencilSpec) -> float:
    idxs = np.argwhere(np.abs(spec.dense_coeffs()) > 0)
    cost = len({int(i[0]) for i in idxs}) * 4 * _COST_ROLL
    for idx in idxs:
        if int(idx[1]) - spec.radius:
            cost += 4 * _COST_ROLL
        cost += _COST_PRODUCT
    return cost


def pick_algorithm(spec: StencilSpec) -> str:
    """'vpu_sep' when the separable pair plan's static op count beats the
    dense roll path, else 'vpu_roll' (pallas_df64.pick_algorithm)."""
    return "vpu_sep" if _sep_cost(spec) < _dense_cost(spec) else "vpu_roll"
