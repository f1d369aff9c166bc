"""1-D stencil passes and whole runs on the internal layout: the CUDA kernels'
wrappers.

Counterpart of ``lorastencil_tpu/ops/pallas_1d.py`` and
``lorastencil_tpu/ops/pallas_df64_1d.py``.  Their seven TPU kernels become
the hand-written CUDA kernels of ``csrc/stencil1d.cu``, in float32 and in
float64:

* ``stencil1d_lanes_step``: a pass, narrow (``_stencil1d_lanes_kernel``:
  ``lanes_kernel``; in float64 ``_df64_1d_lanes_kernel``:
  ``pass_kernel<double>``);
* ``stencil1d_step``: a pass, wide (``_stencil1d_kernel``; in float64
  ``_df64_1d_flat_kernel``): ``wide_kernel``;
* ``stencil1d_resident_lanes``: a run, narrow
  (``_stencil1d_resident_lanes_kernel``; in float64 the kernel of
  ``pallas_df64_1d.stencil1d_resident_pair``): ``run_kernel``, narrow sums;
* ``stencil1d_resident``: a run, wide (``_stencil1d_resident_kernel``; the
  JAX df64 tier never runs a wide run, so its float64 instance replaces
  no df64 kernel): ``run_kernel``, wide sums.

The TPU computes its fp64-grade tier on error-free (hi, lo) fp32 pairs
because it has no fp64 unit; the H100 has one, so the float64 instances
compute in native double.  Each wrapper launches the instance of its
state's dtype and counts the launches of each instance apart:
``launches`` in float32, ``launches_f64`` in float64.

A pass runs ``fused_steps`` steps and writes the donor; a run does all
``steps`` in one cooperative launch and returns a new buffer whose guard
the kernel zeroes.  *Narrow*
takes an effective radius up to 32 (the TPU's overlapped-lanes kernels:
taps in registers, a symmetric tap pair summed before its one multiply, as
``pallas_1d._conv_lanes``); *wide* takes any radius up to 127 (the flat
kernels: taps in a loop, +d then -d, as ``pallas_1d._conv_flat``).  Every
substep zeroes the cells outside the interior [0, n); under a ghost
boundary a pass's substeps before the last keep its ``bounds`` instead,
the interior and the ring the engine refilled.  A wide pass gets
its nonzero taps as (offset, weight) pairs in that order (``wide_taps``)
by value in its launch's parameters, and tiles of ``pass_tile`` cells,
the largest that still give the card two blocks per SM.

Three kernels were redesigned for Hopper.  The float32 narrow pass runs
``lanes_kernel``: a thread owns 8 contiguous cells and computes them from
a register window, the taps as a host plan by value (``lanes_plan``: per
d a pair, one tap or both, in the twin's order) and tiles of
``lanes_tile`` cells (``launches_lanes`` counts it).  Both runs, narrow
and wide, in both dtypes, run ``run_kernel``: the state stays in shared
memory, B blocks of it that swap m*r border cells with their neighbours
every m steps (``run_plan``; each wrapper counts it in ``launches_run``);
the narrow run sums in the narrow order, from ``lanes_plan``.  The kernels
they replace, ``pass_kernel<float>`` and the grid-synced
``resident_kernel`` (which reloads the narrow run's halo from global
memory every ``lanes_refresh`` steps), are reached only through ``_pass``
and ``_run``, which chip_smoke.py and the card tests hold the new kernels
against.

On a CUDA tensor each wrapper launches its kernel or raises; only a CPU
tensor runs the plain twin (``*_plain``), which sums in the kernel's order,
in the tensor's dtype.  The kernels round every product and sum on its own
(no FMA), so a twin agrees with its kernel bit for bit on any data.  The
lanes wrappers accept ``algorithm`` 'mxu' and 'vpu' (on the TPU: banded
matmuls or lane rolls, the same function): both run the one kernel of the
dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models.shapes import StencilSpec
from . import _cuda_build
from .layout import TILE_1D, Layout1D, check_bounds

MAX_RADIUS = 127  # csrc/stencil1d.cu kMaxRadius (pallas_1d._dense_taps)
# the lanes kernels' cap on the effective radius and on a pass's reach
# fused_steps * r_eff (the JAX Layout1DLanes.build clamp k * r_eff <= 32)
MAX_LANES_REACH = 32
MAX_FUSED = 64  # the flat pass's depth cap (the JAX engine's min(k, 64))
LANES_ALGORITHMS = ("mxu", "vpu")
# whole-run byte caps of the JAX engine (pallas_1d.RESIDENT_LANES_BYTES,
# RESIDENT_BYTES), applied by the port's engine to the port's layout
RESIDENT_LANES_BYTES = 2 * 2**20
RESIDENT_BYTES = 512 * 2**10
# csrc/stencil1d.cu: a block's shared memory (kMaxSmem bytes) holds the tap
# slots (kTapSlots) and two windows of the tile plus k*r cells each side
# (the wide pass's two windows, without the tap slots, fit the same cap)
_SMEM_BYTES, _TAP_SLOTS = 232448, 2 * MAX_RADIUS + 2
# csrc/stencil1d.cu: a wide pass's tiles (cells per block) and the 4 KB its
# launch's parameters, the taps' struct WideTaps among them, may take
PASS_TILES = (TILE_1D, 1024, 512, 256)
PARAM_LIMIT = 4096
_ENTRIES = {torch.float32: ("ls_stencil1d_pass", "ls_stencil1d_resident",
                            "ls_stencil1d_run", "ls_stencil1d_run_lanes"),
            torch.float64: ("ls_stencil1d_pass_f64",
                            "ls_stencil1d_resident_f64",
                            "ls_stencil1d_run_f64",
                            "ls_stencil1d_run_lanes_f64")}
# csrc/stencil1d.cu lanes_kernel: cells a thread owns, and the narrow pass's
# tiles (tile / 8 threads a block).  The rule: the largest tile that gives
# every SM at least H100_LANES_BLOCKS_PER_SM blocks, so that a
# 1,000,000-cell grid runs in one even wave of 1024-cell tiles (978 blocks
# of 128 threads, at most 8 on an SM) and a 16,777,216-cell one in
# 2048-cell tiles, whose staged halo is at most 64 cells of 2048.
# chip_smoke.py phase 10 times every tile (NVIDIA H100 80GB HBM3, 700.00 W;
# a k = 3 1d2r pass, ms, tiles 2048 / 1024 / 512 / 256): 1,000,000 cells
# 0.00664 / 0.00628 / 0.00721 / 0.00709; 16,777,216 cells 0.05668 /
# 0.05673 / 0.07028 / 0.07328.
LANES_V = 8
LANES_TILES = PASS_TILES
H100_LANES_BLOCKS_PER_SM = 4
# lanes_plan's kinds of a d (csrc/stencil1d.cu kPlus, kMinus, kPair)
LANES_PLUS, LANES_MINUS, LANES_PAIR = 1, 2, 4
# csrc/stencil1d.cu run_kernel: threads a block at most, and the H100 plan
# of both runs (run_plan): one block where the grid's two windows fit its
# shared memory and a step's work (rounded cells x nonzero taps) is at most
# H100_RUN_ONE_BLOCK_WORK; else a block per H100_RUN_CHUNK cells, at most
# one per SM, and m*r, the halo a block computes between two exchanges,
# up to H100_RUN_REACH cells.  chip_smoke.py phase 10 times the plans
# around these in both dtypes (NVIDIA H100 80GB HBM3, 700.00 W; 64 steps,
# ms): one block lost at every size that fits it, so no work takes it --
# 1d1r 2048: 0.03215 against 0.02445 for 8 blocks (float64 0.05272 /
# 0.03018); 4096: 0.04767 against 0.02493 for 16 (0.08848 / 0.03057).
# The rule's plan was the fastest measured at 1d1r 2048 and 4096 in float32,
# r = 40 x 100,000 (132 blocks, m = 4: 0.34862; m = 1: 0.37439) and 1d1r
# 129,024 (0.03007) in float32 and float64, and within 2% of it elsewhere.
RUN_MAX_THREADS = 1024
H100_RUN_ONE_BLOCK_WORK = 0
H100_RUN_CHUNK = 256
H100_RUN_REACH = 192


@functools.lru_cache(maxsize=None)
def max_pass_reach(dtype) -> int:
    """The largest reach k * r_eff of a pass in ``dtype``: 13,440 cells in
    float32 (beyond any legal pass), 6,176 in float64 (a wide pass of r =
    127 takes k <= 48)."""
    cells = _SMEM_BYTES // dtype.itemsize
    return ((cells - _TAP_SLOTS) // 2 - TILE_1D) // 2


@functools.lru_cache(maxsize=None)
def dense_taps(spec: StencilSpec):
    """Flat dense taps of a 1-D spec (terms and residue collapsed), as
    ``pallas_1d._dense_taps``."""
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is {spec.ndim}-D, not 1-D")
    taps = tuple(float(t) for t in spec.dense_coeffs())
    if len(taps) > 2 * MAX_RADIUS + 1:
        raise ValueError(
            f"{spec.name}: 1-D radius {spec.radius} exceeds {MAX_RADIUS}")
    return taps


@functools.lru_cache(maxsize=None)
def effective_radius(spec: StencilSpec) -> int:
    """Largest |offset| with a nonzero tap (1d1r's 9 taps have zero ends,
    so its radius here is 3, not 4), as ``pallas_1d.effective_radius``."""
    taps = dense_taps(spec)
    r = (len(taps) - 1) // 2
    return max((abs(d - r) for d, w in enumerate(taps) if w != 0.0),
               default=0)


@functools.lru_cache(maxsize=None)
def _taps(spec: StencilSpec):
    """(taps trimmed to the effective radius, effective radius)."""
    taps, r = dense_taps(spec), effective_radius(spec)
    mid = (len(taps) - 1) // 2
    return taps[mid - r: mid + r + 1], r


@functools.lru_cache(maxsize=None)
def wide_taps(spec: StencilSpec):
    """A wide pass's nonzero taps as ((offset, ...), (weight, ...)) in its
    twin's order: the centre, then for d = 1..r_eff the +d tap, then the -d
    tap (``_conv`` with ``pairs`` off)."""
    taps, r = _taps(spec)
    order = [0] + [o for d in range(1, r + 1) for o in (d, -d)]
    pairs = [(o, taps[r + o]) for o in order if taps[r + o] != 0.0]
    return tuple(o for o, _ in pairs), tuple(w for _, w in pairs)


def wide_param_bytes(dtype) -> int:
    """Bytes of the wide pass's tap struct in ``dtype`` (``WideTaps``:
    the count, the offsets, the weights at their alignment)."""
    head = 4 * (1 + 2 * MAX_RADIUS + 1)
    size = dtype.itemsize
    weights_at = -(-head // size) * size
    end = weights_at + size * (2 * MAX_RADIUS + 1)
    return -(-end // max(4, size)) * max(4, size)


def pass_tile(rounded: int, sms: int) -> int:
    """Cells per block of a wide pass over ``rounded`` cells: the largest of
    ``PASS_TILES`` that gives at least two blocks per SM, else the
    smallest."""
    for tile in PASS_TILES:
        if rounded // tile >= 2 * sms:
            return tile
    return PASS_TILES[-1]


def lanes_tile(rounded: int, sms: int) -> int:
    """Cells per block of a float32 narrow pass over ``rounded`` cells: the
    largest of ``LANES_TILES`` that gives every one of ``sms`` SMs at least
    ``H100_LANES_BLOCKS_PER_SM`` blocks, else the smallest."""
    for tile in LANES_TILES:
        if rounded // tile >= H100_LANES_BLOCKS_PER_SM * sms:
            return tile
    return LANES_TILES[-1]


@functools.lru_cache(maxsize=None)
def lanes_plan(spec: StencilSpec):
    """The float32 narrow pass's taps as its kernel takes them, in the order
    of the twin's ``_conv(..., pairs=True)``: (centre weight or None, ((kind,
    wp, wm) for d = 1..r_eff)).  kind 4 (``LANES_PAIR``) is an equal nonzero
    pair, one product of the pair's sum with weight wp; else bit 0 the +d
    tap's product (wp), then bit 1 the -d tap's (wm); 0 adds nothing."""
    taps, r = _taps(spec)
    centre = taps[r] if taps[r] != 0.0 else None
    per_d = []
    for d in range(1, r + 1):
        wp, wm = taps[r + d], taps[r - d]
        if wp != 0.0 and wp == wm:
            per_d.append((LANES_PAIR, wp, wm))
        else:
            per_d.append((LANES_PLUS * (wp != 0.0) + LANES_MINUS * (wm != 0.0),
                          wp, wm))
    return centre, tuple(per_d)


def run_cells(itemsize: int, r: int) -> int:
    """Contiguous cells a run thread owns (csrc/stencil1d.cu run_cells):
    two 16-byte words at radius 1-8 (a register window), else one."""
    return (32 if 1 <= r <= 8 else 16) // itemsize


class RunPlan(NamedTuple):
    """A run's launch (csrc/stencil1d.cu RunGrid): ``blocks`` blocks,
    ``m`` steps between exchanges, a window of ``halo`` cells each side of a
    block's chunk, ``threads`` a block."""
    blocks: int
    m: int
    halo: int
    threads: int


def make_run_plan(rounded: int, r: int, itemsize: int, blocks: int,
                  m: int) -> RunPlan:
    """The launch of ``blocks`` blocks and m steps between exchanges: the
    halo (r, or m * r where B > 1) rounded up to whole groups of
    ``run_cells`` cells, and one thread for each group of the widest step
    (the largest chunk and, where B > 1, (m - 1) * r cells each side), at
    most ``RUN_MAX_THREADS``."""
    V = run_cells(itemsize, r)
    edge = -(-(m - 1) * r // V) if blocks > 1 else 0
    widest = -(-rounded // V // blocks) + 2 * edge
    reach = m * r if blocks > 1 else r
    return RunPlan(blocks, m, -(-reach // V) * V,
                   min(RUN_MAX_THREADS, 32 * -(-widest // 32)))


def run_plan(rounded: int, r: int, n_taps: int, steps: int, itemsize: int,
             sms: int) -> RunPlan:
    """A run's (B, m) on ``sms`` SMs (the H100 rule; see ``H100_RUN_*``),
    ``n_taps`` the products of a cell's sum (``wide_taps``' count, or
    ``lanes_products``).  B = 1: every step over the whole grid, m = steps.
    B > 1: chunks of whole groups of ``run_cells`` cells, each at least
    m * r cells so that a border comes from the neighbour alone, and both
    windows within a block's shared memory."""
    if (2 * (rounded + 2 * r) * itemsize <= _SMEM_BYTES
            and rounded * n_taps <= H100_RUN_ONE_BLOCK_WORK):
        return make_run_plan(rounded, r, itemsize, 1, steps)
    blocks = max(2, min(sms, rounded // H100_RUN_CHUNK))
    if not r:
        return make_run_plan(rounded, r, itemsize, blocks, steps)
    V = run_cells(itemsize, r)
    groups = rounded // V
    blocks = min(blocks, groups // -(-r // V))
    m = max(1, min(steps, H100_RUN_REACH // r, groups // blocks * V // r))
    cmax = -(-groups // blocks) * V
    pad = -(-r // (16 // itemsize)) * (16 // itemsize)  # the window's reach
    while m > 1 and 2 * (cmax + 2 * -(-m * r // V) * V + 2 * pad) * itemsize \
            > _SMEM_BYTES:
        m -= 1
    return make_run_plan(rounded, r, itemsize, blocks, m)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lanes_products(spec: StencilSpec) -> int:
    """Products of one cell's narrow sum (``lanes_plan``): the centre's, one
    a pair, one a tap otherwise."""
    centre, per_d = lanes_plan(spec)
    return (centre is not None) + sum(
        1 if kind == LANES_PAIR else bin(kind).count("1")
        for kind, _, _ in per_d)


def lanes_refresh(r_eff: int) -> int:
    """The TPU narrow run's fixup interval ``lane_halo // r_eff`` with
    ``lane_halo = min(8, 32 // r_eff) * r_eff``: steps between its halo
    reloads, and the reloads of ``resident_kernel`` (``_run``).  The
    narrow run's layout keeps a guard of this many steps' reach, so that
    both engines take the same branch; ``run_kernel`` reloads nothing."""
    return min(8, MAX_LANES_REACH // r_eff)


def fits_resident(layout, itemsize: int = 4) -> bool:
    """The flat whole-run branch's size test (``pallas_1d.fits_resident``'s
    512 KiB cap) on the port's layout."""
    return (isinstance(layout, Layout1D)
            and layout.shape[0] * itemsize <= RESIDENT_BYTES)


def fits_resident_lanes(layout, itemsize: int = 4) -> bool:
    """The lanes whole-run branch's size test (``pallas_1d.
    fits_resident_lanes``'s 2 MiB cap) on the port's layout."""
    return (isinstance(layout, Layout1D)
            and layout.shape[0] * itemsize <= RESIDENT_LANES_BYTES)


# -- plain twins -------------------------------------------------------------
def _conv(x, taps, r: int, pairs: bool):
    """One substep's sums over ``x`` (the cells and r more on each side):
    centre, then d = 1..r; ``pairs`` adds an equal (+d, -d) pair as one
    product of the pair's sum.  Zero taps are skipped."""
    length = x.shape[0] - 2 * r

    def sh(d):
        return x[r + d: r + d + length]

    acc = taps[r] * sh(0) if taps[r] != 0.0 else None
    for d in range(1, r + 1):
        wp, wm = taps[r + d], taps[r - d]
        if pairs and wp != 0.0 and wp == wm:
            terms = (wp * (sh(d) + sh(-d)),)
        else:
            terms = tuple(w * sh(s) for w, s in ((wp, d), (wm, -d))
                          if w != 0.0)
        for v in terms:
            acc = v if acc is None else acc + v
    return x.new_zeros(length) if acc is None else acc


def _run_plain(cur, spec: StencilSpec, layout: Layout1D, steps: int,
               pairs: bool):
    """``steps`` masked substeps; returns the rounded interior."""
    taps, r = _taps(spec)
    o, n, nr = layout.origin, layout.interior, layout.rounded
    x = cur[o - r: o + nr + r]
    for s in range(steps):
        val = _conv(x, taps, r, pairs)
        val[n:] = 0
        if s == steps - 1:
            return val
        x = torch.nn.functional.pad(val, (r, r))  # zero beyond [0, n)


def _pass_plain(cur, spec: StencilSpec, layout: Layout1D, steps: int,
                pairs: bool, bounds=None):
    """A pass's ``steps`` masked substeps, as the pass kernels take them:
    substep s over the rounded interior and (steps - s) * r_eff cells each
    side, read from the buffer, keeping the cells in ``bounds`` ``(lo,
    hi)`` (the interior when None), the last one the interior; returns
    the rounded interior.  With no bounds the same values as
    ``_run_plain``'s."""
    taps, r = _taps(spec)
    o, n, nr = layout.origin, layout.interior, layout.rounded
    lo, hi = (0, n) if bounds is None else bounds
    e = steps * r
    x = cur[o - e: o + nr + e]
    for s in range(1, steps + 1):
        e -= r  # the substep's extent beyond the rounded interior
        x = _conv(x, taps, r, pairs)
        a, b = (lo, hi) if s < steps else (0, n)
        x[:max(0, e + a)] = 0
        x[max(0, e + b):] = 0
    return x


def stencil1d_lanes_step_plain(cur, donor, spec: StencilSpec,
                               layout: Layout1D, fused_steps: int = 1,
                               bounds=None):
    """The narrow pass's twin: writes the rounded interior of ``donor``
    and returns it; ``donor``'s guard is left as it is.  Substeps before
    the last keep ``bounds`` ``(lo, hi)``, the last the interior."""
    o, nr = layout.origin, layout.rounded
    donor[o: o + nr] = _pass_plain(cur, spec, layout, fused_steps, True,
                                   bounds)
    return donor


def stencil1d_step_plain(cur, donor, spec: StencilSpec, layout: Layout1D,
                         fused_steps: int = 1, bounds=None):
    """The wide pass's twin (see ``stencil1d_lanes_step_plain``)."""
    o, nr = layout.origin, layout.rounded
    donor[o: o + nr] = _pass_plain(cur, spec, layout, fused_steps, False,
                                   bounds)
    return donor


def stencil1d_resident_lanes_plain(cur, spec: StencilSpec, layout: Layout1D,
                                   steps: int):
    """The narrow run's twin: a new buffer with a zero guard.  The run's
    chunks and exchanges change no value, so the twin steps the whole
    interior."""
    out = torch.zeros_like(cur)
    o, nr = layout.origin, layout.rounded
    out[o: o + nr] = _run_plain(cur, spec, layout, steps, True)
    return out


def stencil1d_resident_plain(cur, spec: StencilSpec, layout: Layout1D,
                             steps: int):
    """The wide run's twin (see ``stencil1d_resident_lanes_plain``)."""
    out = torch.zeros_like(cur)
    o, nr = layout.origin, layout.rounded
    out[o: o + nr] = _run_plain(cur, spec, layout, steps, False)
    return out


# -- the kernels -------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library's entries, built and bound once per process:
    {dtype: (pass, resident_kernel's run, wide run, narrow run), "lanes":
    the float32 narrow pass}."""
    lib = _cuda_build.load("stencil1d")
    entries = {}
    for dtype, names in _ENTRIES.items():
        fns = pass_fn, run_fn, wide_run_fn, lanes_run_fn = tuple(
            getattr(lib, name) for name in names)
        for fn in fns:
            fn.restype = ctypes.c_int
        pass_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        run_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        head = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
        wide_run_fn.argtypes = head + [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 11 + [ctypes.c_void_p]
        weight = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
        lanes_run_fn.argtypes = head + [ctypes.c_void_p] * 3 + [
            ctypes.c_int, weight] + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        entries[dtype] = fns
    lanes_fn = lib.ls_stencil1d_lanes
    lanes_fn.restype = ctypes.c_int
    lanes_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float] + [
        ctypes.c_int] * 7 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    entries["lanes"] = lanes_fn
    return entries


@functools.lru_cache(maxsize=None)
def _taps_buffer(spec: StencilSpec, device: torch.device, dtype):
    """The trimmed taps in the state's ``dtype`` on ``device``, made once
    per (spec, device, dtype): fp64 taps rounded to float32 would cost
    ~1e-8 per step."""
    return torch.tensor(_taps(spec)[0], dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _wide_table(spec: StencilSpec, dtype):
    """``wide_taps`` as host arrays for the launch: (int32 offsets, weights
    in ``dtype``, count), made once per (spec, dtype)."""
    offsets, weights = wide_taps(spec)
    n = len(offsets)
    ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    return (ctypes.c_int * max(n, 1))(*offsets), \
        (ctype * max(n, 1))(*weights), n


@functools.lru_cache(maxsize=None)
def _lanes_table(spec: StencilSpec, dtype=torch.float32):
    """``lanes_plan`` as the launch's host arrays: (kinds, wp, wm, centre
    flag, centre weight), the weights in ``dtype`` (float64 taps rounded to
    float32 would cost ~1e-8 a step), made once per (spec, dtype)."""
    centre, per_d = lanes_plan(spec)
    r = len(per_d)
    kinds, wp, wm = zip(*per_d)
    ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    return ((ctypes.c_int * r)(*kinds), (ctype * r)(*wp), (ctype * r)(*wm),
            int(centre is not None), 0.0 if centre is None else centre)


def _check(cur, spec: StencilSpec, layout: Layout1D, reach: int,
           donor=None):
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is {spec.ndim}-D, not 1-D")
    if not isinstance(layout, Layout1D):
        raise TypeError(f"layout must be a Layout1D, got {type(layout)}")
    layout.validate()
    if layout.guard < reach:
        raise ValueError(
            f"guard {layout.guard} is narrower than the reach {reach} "
            f"(fused steps x effective radius)")
    if layout.shape[0] >= 2**31:
        raise ValueError(f"layout of {layout.shape[0]} cells exceeds 2**31")
    if cur.dtype not in _ENTRIES:
        raise TypeError(f"cur must be float32 or float64, got {cur.dtype}")
    for name, t in (("cur", cur), ("donor", donor)):
        if t is None:
            continue
        if t.dtype != cur.dtype:
            raise TypeError(f"{name} must be {cur.dtype}, got {t.dtype}")
        if tuple(t.shape) != layout.shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, layout is "
                f"{layout.shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if donor is not None:
        if cur.device != donor.device:
            raise ValueError(
                f"cur on {cur.device} but donor on {donor.device}")
        if cur.data_ptr() == donor.data_ptr():
            raise ValueError("donor must be a different buffer from cur")
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stencil1d kernel for device {cur.device}")


def _check_lanes(spec: StencilSpec, algorithm: str, reach_steps: int):
    if algorithm not in LANES_ALGORITHMS:
        raise ValueError(
            f"algorithm must be one of {LANES_ALGORITHMS}, got "
            f"{algorithm!r}")
    r = effective_radius(spec)
    if not 1 <= r <= MAX_LANES_REACH:
        raise ValueError(
            f"{spec.name}: effective radius {r} outside the lanes kernels' "
            f"range [1, {MAX_LANES_REACH}]; stencil1d_step takes it")
    if reach_steps * r > MAX_LANES_REACH:
        raise ValueError(
            f"{reach_steps} steps per pass need k*r_eff = "
            f"{reach_steps * r} > {MAX_LANES_REACH}")
    return r


def _refuse_unported(region):
    if region is not None:
        raise NotImplementedError(
            "region (the overlapped sharded engine) is not ported yet "
            "(ROADMAP A11)")


def _pass(cur, donor, spec, layout, k: int, narrow: bool, bounds=None):
    """A pass on ``pass_kernel`` (narrow: #12's float64 pass, and in float32
    the kernel ``lanes_kernel`` replaced) or ``wide_kernel``, its substeps
    before the last keeping ``bounds`` (the interior when None)."""
    lo, hi = check_bounds(bounds, (layout.interior,), (layout.guard,))
    if narrow:
        taps = _taps_buffer(spec, cur.device, cur.dtype).data_ptr()
        off, w, n_taps, tile = None, None, 0, 0
    else:
        taps = None
        off, w, n_taps = _wide_table(spec, cur.dtype)
        tile = pass_tile(layout.rounded, _sm_count(cur.device.index))
    with torch.cuda.device(cur.device):
        err = _lib()[cur.dtype][0](
            cur.data_ptr(), donor.data_ptr(), taps,
            effective_radius(spec), k, int(narrow), layout.shape[0],
            layout.origin, layout.interior, layout.rounded,
            torch.cuda.current_stream().cuda_stream, off, w, n_taps, tile,
            lo, hi)
    if err != 0:
        raise RuntimeError(f"stencil1d pass launch failed: CUDA error {err}")
    return donor


def _lanes(cur, donor, spec, layout, k: int, tile: int = None,
           bounds=None):
    """A float32 narrow pass on ``lanes_kernel``, in tiles of ``tile`` cells
    (``lanes_tile``'s if None), its substeps before the last keeping
    ``bounds`` (the interior when None)."""
    kinds, wp, wm, has_centre, centre = _lanes_table(spec)
    lo, hi = check_bounds(bounds, (layout.interior,), (layout.guard,))
    if tile is None:
        tile = lanes_tile(layout.rounded, _sm_count(cur.device.index))
    with torch.cuda.device(cur.device):
        err = _lib()["lanes"](
            cur.data_ptr(), donor.data_ptr(), kinds, wp, wm, has_centre,
            centre, effective_radius(spec), k, layout.shape[0],
            layout.origin, layout.interior, layout.rounded, tile,
            torch.cuda.current_stream().cuda_stream, lo, hi)
    if err != 0:
        raise RuntimeError(f"stencil1d lanes launch failed: CUDA error {err}")
    return donor


def _launch_run(cur, spec, layout, steps: int, plan, n_products: int,
                entry: int, taps):
    """A run on ``run_kernel`` through entry ``entry`` of the dtype's
    (2: wide, 3: narrow), ``taps`` its plan's host arrays, by ``plan``
    (``run_plan``'s if None); returns the new buffer.  The zeroed exchange
    words are made only for a run of more than one phase (steps > m) on
    more than one block: one phase sends nothing."""
    r = effective_radius(spec)
    if plan is None:
        plan = run_plan(layout.rounded, r, n_products, steps,
                        cur.element_size(), _sm_count(cur.device.index))
    words = (4 * plan.blocks * plan.m * r * cur.element_size() // 4
             if plan.blocks > 1 and steps > plan.m else 0)
    out = torch.empty_like(cur)  # the kernel zeroes its guard
    xch = (torch.zeros(words, dtype=torch.int64, device=cur.device) if words
           else None)
    with torch.cuda.device(cur.device):
        err = _lib()[cur.dtype][entry](
            cur.data_ptr(), out.data_ptr(),
            None if xch is None else xch.data_ptr(), words, *taps, r,
            steps, plan.blocks, plan.m, plan.halo, plan.threads,
            layout.shape[0], layout.origin, layout.interior, layout.rounded,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"stencil1d resident launch failed: CUDA error {err}")
    return out


def _wide_run(cur, spec, layout, steps: int, plan: RunPlan = None):
    """A wide run on ``run_kernel``, by ``plan`` (``run_plan``'s if None);
    returns the new buffer."""
    off, w, n_taps = _wide_table(spec, cur.dtype)
    return _launch_run(cur, spec, layout, steps, plan, n_taps, 2,
                       (off, w, n_taps))


def _lanes_run(cur, spec, layout, steps: int, plan: RunPlan = None):
    """A narrow run on ``run_kernel``'s narrow instances (the sums of a plan
    of pairs only, or of any narrow plan), by ``plan`` (``run_plan``'s if
    None); returns the new buffer."""
    return _launch_run(cur, spec, layout, steps, plan, lanes_products(spec),
                       3, _lanes_table(spec, cur.dtype))


def _run(cur, spec, layout, steps: int, refresh: int, narrow: bool):
    """A run on ``resident_kernel``, the first port's grid-synced run, now
    on no path: each block reloads its chunk and halo from global memory
    every ``refresh`` steps.  The card tests and chip_smoke.py hold
    ``run_kernel`` against it: narrow at ``lanes_refresh`` (the narrow
    runs #7 and #14 launched it until ``run_kernel`` took them), wide at
    refresh 1."""
    taps = _taps_buffer(spec, cur.device, cur.dtype)
    outs = (torch.zeros_like(cur), torch.zeros_like(cur))
    with torch.cuda.device(cur.device):
        err = _lib()[cur.dtype][1](
            cur.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            taps.data_ptr(), effective_radius(spec), steps, refresh,
            int(narrow), layout.shape[0], layout.origin, layout.interior,
            layout.rounded, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"stencil1d resident launch failed: CUDA error {err}")
    phases = -(-steps // refresh)
    return outs[(phases - 1) % 2]


def _count(wrapper, dtype):
    """One launch more of ``wrapper``'s instance in ``dtype``."""
    if dtype == torch.float64:
        wrapper.launches_f64 += 1
    else:
        wrapper.launches += 1


def stencil1d_lanes_step(cur, donor, spec: StencilSpec, layout: Layout1D,
                         fused_steps: int = 1, algorithm: str = "vpu",
                         bounds=None, region=None):
    """``fused_steps`` timesteps in one narrow pass: reads ``cur``, writes
    the rounded interior of ``donor`` (whose guard must be zero and stays
    untouched) and returns ``donor``.  Needs an effective radius r_eff <=
    32 and ``fused_steps * r_eff <= 32``, as the TPU kernel's lane halo.
    On a float64 state it is the fp64-grade step of
    ``pallas_df64_1d.df64_1d_step`` (which the JAX df64 engine runs at k =
    1).

    ``bounds`` ``(lo, hi)`` (interior coordinates; the interior when None;
    ``layout.check_bounds``): the cells that the substeps before the last
    keep, the JAX wrapper's argument, so that a ghost ring the caller
    filled stays alive through them.  The last substep keeps the interior
    in every case: the ring and round-up cells it would keep are rewritten
    by the next pass's ring refresh before anything reads them (see
    ``stencil2d.stencil2d_step``), so a one-step pass only checks
    ``bounds``."""
    _refuse_unported(region)
    r = _check_lanes(spec, algorithm, fused_steps)
    if fused_steps < 1:
        raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
    _check(cur, spec, layout, fused_steps * r, donor)
    box = check_bounds(bounds, (layout.interior,), (layout.guard,))
    if cur.device.type == "cpu":
        return stencil1d_lanes_step_plain(cur, donor, spec, layout,
                                          fused_steps, box)
    if cur.dtype == torch.float64:
        _pass(cur, donor, spec, layout, fused_steps, True, box)
    else:
        _lanes(cur, donor, spec, layout, fused_steps, bounds=box)
        stencil1d_lanes_step.launches_lanes += 1
    _count(stencil1d_lanes_step, cur.dtype)
    return donor


def stencil1d_step(cur, donor, spec: StencilSpec, layout: Layout1D,
                   fused_steps: int = 1, bounds=None, region=None):
    """``fused_steps`` timesteps in one wide pass (any radius up to 127,
    ``fused_steps`` up to 64, the reach within ``max_pass_reach``); see
    ``stencil1d_lanes_step``.  On a float64 state it is the fp64-grade
    step of ``pallas_df64_1d.df64_1d_flat_step`` (r_eff 33-127).
    ``bounds`` as ``stencil1d_lanes_step``'s."""
    _refuse_unported(region)
    if not 1 <= fused_steps <= MAX_FUSED:
        raise ValueError(
            f"fused_steps {fused_steps} outside [1, {MAX_FUSED}]")
    reach = fused_steps * effective_radius(spec)
    _check(cur, spec, layout, reach, donor)
    cap = max_pass_reach(cur.dtype)
    if reach > cap:
        raise ValueError(
            f"a {cur.dtype} pass of reach {reach} (fused steps x effective "
            f"radius) exceeds the kernel's shared memory ({cap})")
    box = check_bounds(bounds, (layout.interior,), (layout.guard,))
    if cur.device.type == "cpu":
        return stencil1d_step_plain(cur, donor, spec, layout, fused_steps,
                                    box)
    _pass(cur, donor, spec, layout, fused_steps, False, box)
    _count(stencil1d_step, cur.dtype)
    return donor


def stencil1d_resident_lanes(cur, spec: StencilSpec, layout: Layout1D,
                             steps: int, algorithm: str = "mxu"):
    """All ``steps`` timesteps in one narrow cooperative launch of
    ``run_kernel`` (its narrow instances: the narrow sum order), the state
    resident in shared memory; reads ``cur`` and returns a new buffer.
    Raises if the card cannot hold the grid's blocks at once (no fallback
    to passes).  On a float64 state it is the fp64-grade run of
    ``pallas_df64_1d.stencil1d_resident_pair``."""
    r = _check_lanes(spec, algorithm, 1)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    _check(cur, spec, layout, r)
    if cur.device.type == "cpu":
        return stencil1d_resident_lanes_plain(cur, spec, layout, steps)
    out = _lanes_run(cur, spec, layout, steps)
    stencil1d_resident_lanes.launches_run += 1
    _count(stencil1d_resident_lanes, cur.dtype)
    return out


def stencil1d_resident(cur, spec: StencilSpec, layout: Layout1D, steps: int):
    """All ``steps`` timesteps in one wide cooperative launch of
    ``run_kernel``, the state resident in shared memory (the flat TPU
    kernel keeps it in VMEM and steps the whole grid); see
    ``stencil1d_resident_lanes``.  The JAX df64 tier has no wide run: the
    float64 instance serves dtype 'float64'."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    _check(cur, spec, layout, effective_radius(spec))
    if cur.device.type == "cpu":
        return stencil1d_resident_plain(cur, spec, layout, steps)
    out = _wide_run(cur, spec, layout, steps)
    stencil1d_resident.launches_run += 1
    _count(stencil1d_resident, cur.dtype)
    return out


# kernel launches per instance, for chip_smoke.py: float32 and float64; and
# of the redesigned kernels, lanes_kernel (float32 narrow passes) and
# run_kernel (narrow and wide runs, either dtype, each wrapper its own)
for _wrapper in (stencil1d_lanes_step, stencil1d_step,
                 stencil1d_resident_lanes, stencil1d_resident):
    _wrapper.launches = _wrapper.launches_f64 = 0
del _wrapper
stencil1d_lanes_step.launches_lanes = 0
stencil1d_resident_lanes.launches_run = stencil1d_resident.launches_run = 0
