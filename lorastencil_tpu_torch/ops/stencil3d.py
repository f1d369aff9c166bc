"""K fused 3-D stencil steps on the internal layout: the CUDA kernel's wrapper.

Counterpart of ``lorastencil_tpu/ops/pallas_3d.py`` ``stencil3d_step``
(kernel ``_stencil3d_kernel``) and, on a float64 state, of
``lorastencil_tpu/ops/pallas_df64_3d.py`` ``df64_3d_step`` (kernel
``_df64_3d_kernel``): ``csrc/stencil3d.cu`` has a float32 and a float64
instance, and the wrapper launches the one of its state's dtype.  The TPU
computes the fp64-grade tier on error-free (hi, lo) fp32 pairs because it has
no fp64 unit; the card has one, so the float64 instance computes in native
double.  On a CUDA tensor ``stencil3d_step`` launches the hand-written
kernel or raises; only a CPU tensor runs the plain PyTorch twin,
``stencil3d_step_plain`` (in the state's dtype), which is also callable
directly (the tests and ``chip_smoke.py`` hold the kernel against it on the
card).

``algorithm``: the TPU kernel's exact-fp32 variants ``'vpu'``,
``'vpu_roll'`` and ``'mxu_hybrid1'`` differ only in how they use the TPU's
vector and matrix units; here all three run the one CUDA-core kernel of the
state's dtype, and a float64 state also takes the df64 kernel's name
``'vpu_sep'`` (its separable pair slices).  ``'mxu'`` (banded matmuls at
Mosaic precision, ~1e-3 a step at ``precision='default'``) runs it too,
exactly, one step a pass: the JAX kernel refuses temporal fusion under it,
and so does this wrapper.  ``conv_carry`` is
accepted and has no effect: on the TPU it reuses plane convs across slabs
with bit-identical output, and the CUDA kernel's z-march computes each
plane's conv once by construction.

Two kernels: every pass the engine launches for the 3-D registry (star3d1r
and box3d1r, float32 and float64, one or two steps) runs the march kernel,
the source's redesign for Hopper (z-sums in registers, compile-time term
kinds, 16-byte copies); ``march_takes`` is its fixed rule on spec, dtype and
depth, and ``stencil3d_step.launches_march`` counts its launches (they also
count in ``launches`` / ``launches_f64``).  Every other pass of one or two
steps and radius 1-4 -- residue, another term mix, radius 2-4, up to
``PLAN_MAX_TERMS`` terms and ``PLAN_MAX_RESIDUE`` points -- runs the plan
march kernel of ``csrc/plan3d.cu`` (``plan_march_takes``;
``launches_plan_march`` counts it): the march kernel's z-march for any
plan, each level's plane summed once, when the plane R beyond it has
landed, from the last 2r + 1 planes in shared memory.  What neither takes
-- more than two steps, radius 0 or 5-8 -- runs the general kernel,
``stencil3d_kernel``.  None falls back to another.

The bfloat16 state tier: both kernels have a bfloat16 instance (built
apart as ``csrc/stencil3d_bf16.cu``: ``_lib_bf16``), the float32 kernel on
bf16 cells.  A cell is widened as it is staged and rounded to nearest even
once, at the pass's store; the fused levels stay fp32, as the JAX kernel's
level buffer (``lvlbuf``) keeps them, so a bf16 pass equals the float32
pass of the widened input, rounded, and JAX's bf16 pass on the integer
fill bit for bit.  The taps, shared memory and tiles are float32's
(``compute_dtype``).  A general-kernel pass that shared memory splits into
launches (``plan_pass``; none at the engine's default depth of the
registry shapes) rounds between them, where its intermediate buffer holds
the state.  The twin widens, computes in float32 and rounds at the store;
``launches_bf16`` counts the bf16 launches.

A pass may write a window of the layout's (row, column) tiles only
(``region``, the JAX wrapper's ``((i0, i1), (j0, j1))``; z is always
whole), which the sharded engine's overlapped step takes
(``parallel/domain.py``): the launch covers the window's rows and columns
alone (on the card the entries' ``in_window`` moves its origin and extent),
and every other cell of the donor stays as it was.  A pass that the general
kernel's shared memory splits into launches (``launch_depths``) cannot keep
a window and refuses one.  The ``bounds`` may be a shard's box
(``check_bounds(..., shard=True)``), and the last level keeps it cut to the
interior.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.shapes import StencilSpec
from . import _cuda_build
from .band_gemm import (BUFFERED, CENTRE, IDENTITY_Z, apply_spec_3d,
                        plan_array, term_class)
from .layout import Layout3D, check_bounds, compute_dtype

ALGORITHMS = ("vpu", "vpu_roll", "mxu_hybrid1", "mxu")
MAX_RADIUS = 8  # csrc/stencil3d.cu kMaxRadius
MAX_FUSED = 8  # csrc/stencil3d.cu kMaxK
MAX_PLAN = 4096  # csrc/stencil3d.cu kMaxPlan
# the instance of each state dtype
_ENTRIES = {torch.float32: "ls_stencil3d_step",
            torch.float64: "ls_stencil3d_step_f64",
            torch.bfloat16: "ls_stencil3d_step_bf16"}
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
# in-plane block tiles, largest first; all divide the layout's TILE_3D
BLOCK_TILES = ((32, 64), (16, 64), (16, 32), (8, 32), (8, 16))
Z_CHUNKS = (64, 32, 16)  # output planes per block, largest first
# the march kernel (csrc/stencil3d.cu march_kernel): its entries, radii and
# depths, and a task's tile, 32 rows x 16 quads of 16 bytes
_MARCH_ENTRIES = {torch.float32: "ls_stencil3d_march",
                  torch.float64: "ls_stencil3d_march_f64",
                  torch.bfloat16: "ls_stencil3d_march_bf16"}
# csrc/stencil3d.cu: cells of one level plane a general-kernel thread holds
# at most (kPerThread) and its block's threads (kThreads)
PER_THREAD, THREADS = 10, 256
MARCH_RADII = (1,)  # kMarchMaxRadius
MARCH_DEPTHS = (1, 2)
MARCH_TILE_ROWS = 32  # kMarchTileRows
MARCH_TILE_QUADS = 16  # kMarchTileQuads
_HAS_COL, _HAS_ROW = 1, 2  # kHasCol, kHasRow
# the term mixes it is built for, (terms, KINDS): star3d1r's identity term
# and centre terms with a row and a column conv (kStarKinds), box3d1r's
# buffered term with both axes (kBoxKinds)
MARCH_KINDS = (
    (3, (IDENTITY_Z << 2) | ((CENTRE << 2 | _HAS_ROW) << 4)
     | ((CENTRE << 2 | _HAS_COL) << 8)),
    (1, BUFFERED << 2 | _HAS_COL | _HAS_ROW))
# the plan march kernel (csrc/plan3d.cu): its entries, radii, depths and
# the plans it takes (kGenMaxTerms, kGenMaxRes)
_PLAN_ENTRIES = {torch.float32: "ls_stencil3d_plan_march",
                 torch.float64: "ls_stencil3d_plan_march_f64",
                 torch.bfloat16: "ls_stencil3d_plan_march_bf16"}
PLAN_RADII = (1, 2, 3, 4)
PLAN_DEPTHS = (1, 2)
PLAN_MAX_TERMS = 12
PLAN_MAX_RESIDUE = 48


def _classify_terms(spec: StencilSpec):
    """Term indices by class, as ``pallas_3d._classify_terms``: buffered
    (z taps with an in-plane conv), identity-z (z taps only), centre (no
    z taps)."""
    classes = [term_class(t) for t in spec.terms]
    return tuple([i for i, c in enumerate(classes) if c == want]
                 for want in (BUFFERED, IDENTITY_Z, CENTRE))


def term_kinds(spec: StencilSpec) -> int:
    """The march kernel's KINDS of ``spec``: four bits a term (term t at
    bits 4t .. 4t + 3), its class at bits 2-3 and its in-plane axes, a
    column conv (1) and a row conv (2), as ``plan_array`` flags them."""
    kinds = 0
    for t, term in enumerate(spec.terms):
        _, rt, ct = term.taps
        axes = (_HAS_COL if ct is not None else 0) | (
            _HAS_ROW if rt is not None else 0)
        kinds |= (term_class(term) << 2 | axes) << (4 * t)
    return kinds


def march_takes(spec: StencilSpec, dtype, depth: int) -> bool:
    """Whether a pass of ``depth`` fused steps in ``dtype`` runs the march
    kernel: float32, float64 or bfloat16, one or two steps, radius 1, no
    residue,
    and star3d1r's or box3d1r's term mix (``MARCH_KINDS``), whatever the
    taps.  Every other pass runs the general kernel."""
    return (dtype in _MARCH_ENTRIES and depth in MARCH_DEPTHS
            and spec.ndim == 3 and spec.radius in MARCH_RADII
            and not spec.residue
            and (len(spec.terms), term_kinds(spec)) in MARCH_KINDS)


def plan_march_takes(spec: StencilSpec, dtype, depth: int) -> bool:
    """Whether a pass of ``depth`` fused steps in ``dtype`` runs the plan
    march kernel: float32, float64 or bfloat16, one or two steps, radius
    1-4, at most ``PLAN_MAX_TERMS`` terms and ``PLAN_MAX_RESIDUE`` residue
    points, and not a pass the march kernel takes."""
    return (dtype in _PLAN_ENTRIES and depth in PLAN_DEPTHS
            and spec.ndim == 3 and spec.radius in PLAN_RADII
            and len(spec.terms) <= PLAN_MAX_TERMS
            and len(spec.residue) <= PLAN_MAX_RESIDUE
            and not march_takes(spec, dtype, depth))


def region_cells(region, layout: Layout3D):
    """A pass's window ``((i0, i1), (j0, j1))`` of ``layout.grid`` (row,
    column) tiles (the JAX wrapper's ``region``) as cells ``(r0, r1, c0,
    c1)`` of the rounded plane; None is all of it.  Raises where the JAX
    wrapper asserts: a window that is empty or leaves the tile grid."""
    _, mr, nr = layout.rounded
    if region is None:
        return (0, mr, 0, nr)
    try:
        (i0, i1), (j0, j1) = ((int(a), int(b)) for a, b in region)
    except (TypeError, ValueError):
        raise ValueError(
            f"region must be ((i0, i1), (j0, j1)), got {region!r}") from None
    gi, gj = layout.grid
    if not (0 <= i0 < i1 <= gi and 0 <= j0 < j1 <= gj):
        raise ValueError(
            f"region {region!r} is not a window of the layout's {gi}x{gj} "
            f"tile grid")
    tm, tn = layout.tile
    return (i0 * tm, i1 * tm, j0 * tn, j1 * tn)


def _check(cur, donor, spec: StencilSpec, layout: Layout3D, algorithm: str,
           fused_steps: int, bounds, region):
    # a float64 state also takes the df64 kernel's name
    algorithms = (ALGORITHMS + ("vpu_sep",) if cur.dtype == torch.float64
                  else ALGORITHMS)
    if algorithm not in algorithms:
        raise ValueError(f"unknown algorithm {algorithm!r}; this wrapper "
                         f"takes {algorithms}")
    if fused_steps > 1 and algorithm == "mxu":
        # pallas_3d.stencil3d_step's rule
        raise ValueError("3-D temporal fusion needs vpu*/hybrid")
    if spec.ndim != 3:
        raise ValueError(f"{spec.name} is {spec.ndim}-D, not 3-D")
    if not 0 <= spec.radius <= MAX_RADIUS:
        raise ValueError(
            f"radius {spec.radius} outside the kernel's range "
            f"[0, {MAX_RADIUS}]")
    if not 1 <= fused_steps <= MAX_FUSED:
        raise ValueError(
            f"fused_steps {fused_steps} outside [1, {MAX_FUSED}]")
    layout.validate()
    reach = fused_steps * spec.radius
    if min(layout.guard) < reach:
        raise ValueError(
            f"guard {layout.guard} is narrower than the pass's reach "
            f"{reach} (fused_steps x radius)")
    if cur.dtype not in _ENTRIES:
        raise TypeError(
            f"cur must be float32 or float64, or bfloat16, got {cur.dtype}")
    if donor.dtype != cur.dtype:
        raise TypeError(f"donor must be {cur.dtype}, got {donor.dtype}")
    for name, t in (("cur", cur), ("donor", donor)):
        if tuple(t.shape) != layout.shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, layout is "
                f"{layout.shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cur.device != donor.device:
        raise ValueError(
            f"cur on {cur.device} but donor on {donor.device}")
    if cur.data_ptr() == donor.data_ptr():
        raise ValueError("donor must be a different buffer from cur")
    box = check_bounds(bounds, layout.interior, layout.guard, shard=True)
    region_cells(region, layout)
    if region is not None:
        depths = launch_depths(spec, cur.dtype, fused_steps)
        if len(depths) > 1:
            raise ValueError(
                f"a region needs a pass of one launch: {fused_steps} fused "
                f"steps of radius {spec.radius} take {len(depths)} (one "
                f"launch holds {depths[0]})")
    return box


def stencil3d_step_plain(cur, donor, spec: StencilSpec, layout: Layout3D,
                         fused_steps: int = 1, bounds=None, region=None):
    """The kernel's plain PyTorch twin: the same K-level pass with tensor
    ops on whatever device and dtype ``cur`` has, each level masked to the
    global interior (levels before the last: to ``bounds``, 4 or 6 ints, a
    shard's box, ``check_bounds(..., shard=True)``; the last: that box cut
    to the interior).  Writes the rounded interior of ``donor`` in place
    (``region``'s rows and columns of it, ``region_cells``; zero beyond the
    true interior) and returns it; the guard ring of ``donor`` and every
    other cell are left as they are.  A bfloat16 state is widened, computed
    in float32 and rounded once, at the store."""
    K, r = fused_steps, spec.radius
    h, m, n = layout.interior
    z0, r0, c0 = layout.origin
    i0, i1, j0, j1 = region_cells(region, layout)
    box = check_bounds(bounds, layout.interior, layout.guard, shard=True)
    last = (0, min(box[1], h), 0, min(box[3], m), 0, min(box[5], n))
    start = (0, i0, j0)  # the window's first cell in each axis
    e = K * r
    level = cur[z0 - e: z0 + h + e, r0 + i0 - e: r0 + i1 + e,
                c0 + j0 - e: c0 + j1 + e].to(compute_dtype(cur.dtype))
    for L in range(1, K + 1):
        e = (K - L) * r  # the level's extent beyond the window
        full = apply_spec_3d(level, spec)
        lohi = box if L < K else last
        inside = tuple(slice(max(0, e + lohi[2 * a] - start[a]),
                             max(0, e + lohi[2 * a + 1] - start[a]))
                       for a in range(3))
        level = torch.zeros_like(full)
        level[inside] = full[inside]
    donor[z0: z0 + h, r0 + i0: r0 + i1, c0 + j0: c0 + j1] = level
    return donor


@functools.lru_cache(maxsize=None)
def _plan_buffer(spec: StencilSpec, device: torch.device, dtype):
    """The tap/residue table in the compute dtype of a ``dtype`` state on
    ``device``, built once per (spec, device, dtype) and never per step:
    fp64 taps rounded to float32 would cost ~1e-8 per step (a bfloat16
    state's are float32)."""
    plan = plan_array(spec, compute_dtype(dtype))
    if plan.numel() > MAX_PLAN:
        raise ValueError(
            f"{spec.name}: tap table of {plan.numel()} entries exceeds the "
            f"kernel's cap {MAX_PLAN}")
    return plan.to(device)


def _bind(name: str, bf16: bool):
    """``csrc/<name>.cu``, built and its entries of the bfloat16 instances
    (``bf16``) or the others bound, and the shared-memory sizing entry."""
    lib = _cuda_build.load(name)
    if name.startswith("plan3d"):
        for dtype, entry in _PLAN_ENTRIES.items():
            if (dtype == torch.bfloat16) == bf16:
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 26
                               + [ctypes.c_void_p])
        return lib
    lib.ls_stencil3d_smem_bytes.restype = ctypes.c_longlong
    lib.ls_stencil3d_smem_bytes.argtypes = [ctypes.c_int] * 8
    for entries, ints in ((_ENTRIES, 31), (_MARCH_ENTRIES, 26)):
        for dtype, entry in entries.items():
            if (dtype == torch.bfloat16) != bf16:
                continue
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * ints
                           + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    """The float32 and float64 instances' library, built and bound once per
    process."""
    return _bind("stencil3d", False)


@functools.lru_cache(maxsize=None)
def _lib_bf16():
    """The bfloat16 instances' library (``csrc/stencil3d_bf16.cu``, the
    same source built apart), built and bound once per process."""
    return _bind("stencil3d_bf16", True)


def _lib_of(dtype):
    return _lib_bf16() if dtype == torch.bfloat16 else _lib()


@functools.lru_cache(maxsize=None)
def _plan_lib():
    """csrc/plan3d.cu's float32 and float64 instances, built and bound once
    per process."""
    return _bind("plan3d", False)


@functools.lru_cache(maxsize=None)
def _plan_lib_bf16():
    """csrc/plan3d_bf16.cu (its bfloat16 instances), built and bound once
    per process."""
    return _bind("plan3d_bf16", True)


@functools.lru_cache(maxsize=None)
def _plan_host(spec: StencilSpec, dtype):
    """The tap table in the compute dtype of a ``dtype`` state in host
    memory, which the march kernel's launches copy into their
    parameters."""
    return plan_array(spec, compute_dtype(dtype)).contiguous()


def _term_mix(spec: StencilSpec):
    """(buffered terms, planes per level ring): a level keeps 2r+1 planes
    when a centre or identity term or the residue reads them, else only
    the plane whose convs are being taken."""
    buffered, identity, centre = _classify_terms(spec)
    ring = 2 * spec.radius + 1 if (identity or centre or spec.residue) else 1
    return len(buffered), ring


def smem_bytes(radius: int, K: int, bm: int, bn: int, n_buf: int, ring: int,
               plan_len: int, itemsize: int) -> int:
    """Shared-memory bytes of a general-kernel launch (``csrc/stencil3d.cu``
    ``ls_stencil3d_smem_bytes``, which the card tests hold it against): the
    tap table rounded up to 4 cells, the level rings (the input's one plane
    more) and each buffered term's conv rings, at the level extents of a
    (bm x bn) tile; -1 if the arguments are out of range."""
    if not (0 <= radius <= MAX_RADIUS and 1 <= K <= MAX_FUSED and bm >= 1
            and bn >= 1 and n_buf >= 0 and plan_len >= 0
            and itemsize in (4, 8)):
        return -1

    def cells(L):
        e = (K - L) * radius
        return (bm + 2 * e) * (bn + 2 * e)

    if cells(1) > PER_THREAD * THREADS:
        return -1
    total = -(-plan_len // 4) * 4
    total += sum((ring + (L == 0)) * cells(L) for L in range(K))
    total += sum((2 * radius + 1) * n_buf * cells(L) for L in range(1, K + 1))
    return itemsize * total


@functools.lru_cache(maxsize=None)
def plan_pass(spec: StencilSpec, fused_steps: int, itemsize: int):
    """(K, block tile) of the kernel's passes for ``fused_steps`` levels of
    ``itemsize``-byte cells (4 float32, 8 float64, 2 bfloat16, whose rings
    hold float32: float32's plan): the largest tile whose shared-memory
    rings fit at that K (``smem_bytes``), and if none fits, the largest K
    <= ``fused_steps`` for which one does (the wrapper then runs several
    passes)."""
    itemsize = max(itemsize, 4)
    n_buf, ring = _term_mix(spec)
    plan_len = plan_array(spec).numel()
    for K in range(fused_steps, 0, -1):
        for bm, bn in BLOCK_TILES:
            need = smem_bytes(spec.radius, K, bm, bn, n_buf, ring, plan_len,
                              itemsize)
            if 0 <= need <= MAX_SMEM:
                return K, (bm, bn)
    raise ValueError(
        f"{spec.name}: no block tile fits the kernel's shared memory even "
        f"at one step per pass")


def launch_depths(spec: StencilSpec, dtype, k: int):
    """The depths of the launches a pass of k steps in ``dtype`` takes: one
    where ``march_takes`` or ``plan_march_takes``, else launches of the
    largest depth the general kernel's shared memory holds (``plan_pass``),
    then the rest."""
    if march_takes(spec, dtype, k) or plan_march_takes(spec, dtype, k):
        return [k]
    K = plan_pass(spec, k, dtype.itemsize)[0]
    return [K] * (k // K) + ([k % K] if k % K else [])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _z_chunk(dims, tile, device: torch.device) -> int:
    """Output planes per block over ``dims`` ``(h, rows, cols)``: the
    largest chunk that still gives every SM a block, else the smallest.  A
    block recomputes K*r planes of lookback at each end of its chunk, so
    longer chunks cost less."""
    h, mr, nr = dims
    tiles = -(-mr // tile[0]) * -(-nr // tile[1])
    for zc in Z_CHUNKS:
        if tiles * -(-h // zc) >= _sm_count(device):
            return zc
    return Z_CHUNKS[-1]


def _launch(cur, out, spec: StencilSpec, layout: Layout3D, K: int, tile,
            box=None, window=None):
    """One launch of the instance of ``cur``'s dtype, its levels before
    the last kept to ``box`` (``check_bounds``' 6 ints, a shard's box cut;
    the interior when None), over the rows and columns ``window`` (``(r0,
    r1, c0, c1)`` of the rounded plane; all of it when None); raises if
    refused, and counts it (in ``launches_region`` too for a window)."""
    plan = _plan_buffer(spec, cur.device, cur.dtype)
    n_buf, ring = _term_mix(spec)
    nz, rows, pitch = layout.shape
    z0, r0, c0 = layout.origin
    h, m, n = layout.interior
    _, mr, nr = layout.rounded
    win = (0, mr, 0, nr) if window is None else window
    zc = _z_chunk((h, win[1] - win[0], win[3] - win[2]), tile, cur.device)
    box = check_bounds(box, layout.interior, layout.guard, shard=True)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib_of(cur.dtype), _ENTRIES[cur.dtype])(
            cur.data_ptr(), out.data_ptr(), plan.data_ptr(), plan.numel(),
            len(spec.terms), spec.radius, len(spec.residue), n_buf, ring, K,
            nz, rows, pitch, z0, r0, c0, h, m, n, mr, nr, tile[0], tile[1],
            zc, *box, *win, stream)
    if err != 0:
        raise RuntimeError(
            f"stencil3d kernel launch failed: CUDA error {err}")
    _count(cur.dtype, window)
    return out


def _launch_march(cur, out, spec: StencilSpec, layout: Layout3D, K: int,
                  box, window=None, plan_march=False):
    """One launch of the march kernel's (``plan_march``: the plan march
    kernel's) instance of ``cur``'s dtype, its first level kept to ``box``
    at K = 2 (``check_bounds``' 6 ints), over the rows and columns
    ``window`` (all of the rounded plane when None); raises if refused, and
    counts it (in ``launches_region`` too for a window).  Both kernels take
    the tap table from host memory and one signature."""
    plan = _plan_host(spec, cur.dtype)
    nz, rows, pitch = layout.shape
    z0, r0, c0 = layout.origin
    h, m, n = layout.interior
    _, mr, nr = layout.rounded
    win = (0, mr, 0, nr) if window is None else window
    if plan_march:
        bf16 = cur.dtype == torch.bfloat16
        fn = getattr(_plan_lib_bf16() if bf16 else _plan_lib(),
                     _PLAN_ENTRIES[cur.dtype])
    else:
        fn = getattr(_lib_of(cur.dtype), _MARCH_ENTRIES[cur.dtype])
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cur.data_ptr(), out.data_ptr(), plan.data_ptr(),
                 plan.numel(), len(spec.terms), spec.radius,
                 len(spec.residue), K, nz, rows, pitch, z0, r0, c0, h, m, n,
                 mr, nr, *box, *win, stream)
    kernel = "plan march" if plan_march else "march"
    if err != 0:
        raise RuntimeError(
            f"stencil3d {kernel} kernel launch failed: CUDA error {err}")
    _count(cur.dtype, window)
    if plan_march:
        stencil3d_step.launches_plan_march += 1
    else:
        stencil3d_step.launches_march += 1
    return out


def _launch_plan_march(cur, out, spec: StencilSpec, layout: Layout3D,
                       K: int, box, window=None):
    """One launch of the plan march kernel (``_launch_march``)."""
    return _launch_march(cur, out, spec, layout, K, box, window, True)


def _count(dtype, window=None):
    """One launch of the instance of ``dtype``, over ``window`` if not
    None."""
    attr = {torch.float64: "launches_f64",
            torch.bfloat16: "launches_bf16"}.get(dtype, "launches")
    setattr(stencil3d_step, attr, getattr(stencil3d_step, attr) + 1)
    if window is not None:
        stencil3d_step.launches_region += 1


def stencil3d_step(cur, donor, spec: StencilSpec, layout: Layout3D,
                   algorithm: str = "vpu", fused_steps: int = 1,
                   conv_carry=None, bounds=None, region=None, refresh=None):
    """``fused_steps`` timesteps on the internal layout: reads ``cur``,
    writes the rounded interior of ``donor`` in place and returns
    ``donor``.

    ``donor``'s guard ring must be zero; it stays untouched, which is
    what makes the halo decay.  A CUDA tensor runs the CUDA kernel (or
    raises); a CPU tensor runs ``stencil3d_step_plain``.  A float32 state
    runs the float32 instances and counts in ``launches``, a float64 state
    the float64 ones and counts in ``launches_f64``, a bfloat16 state the
    bfloat16 ones and counts in ``launches_bf16``.  A pass that
    ``march_takes`` runs the march kernel in one launch, also counted in
    ``launches_march``; a pass that ``plan_march_takes`` runs the plan
    march kernel in one launch, also counted in ``launches_plan_march``.
    Any other runs the general kernel: one launch
    does all ``fused_steps`` levels when a block's shared-memory rings fit
    at that depth; otherwise it runs passes of the largest depth that
    fits, through one extra zero-ringed buffer, and the launch counter
    shows each pass.

    ``bounds``, as the JAX wrapper's: 4 ints ``(rlo, rhi, clo, chi)`` or 6
    ``(zlo, zhi, rlo, rhi, clo, chi)`` in interior coordinates (the
    interior when None; a shard's box, ``layout.check_bounds(...,
    shard=True)``), the box that the fused levels before the last keep, so
    that a ghost ring the caller filled stays alive through them.  The last
    level keeps that box cut to the interior (see
    ``stencil2d.stencil2d_step``).  ``refresh`` refills the ring of the buffer between two
    launches of a pass split for shared memory.

    ``region`` (``((i0, i1), (j0, j1))``, a window of ``layout.grid``
    tiles; the whole plane when None) writes those rows and columns of
    ``donor`` only, every plane, and leaves its other cells as they were
    (``launches_region`` counts such launches).  A pass the general
    kernel's shared memory splits (``launch_depths``) cannot keep a
    window -- its second launch would read cells the first did not write --
    so such a call raises ``ValueError``, on the CPU as on a card."""
    del conv_carry  # bit-identical by contract; see the module docstring
    box = _check(cur, donor, spec, layout, algorithm, fused_steps, bounds,
                 region)
    if cur.device.type == "cpu":
        return stencil3d_step_plain(cur, donor, spec, layout, fused_steps,
                                    box, region)
    if cur.device.type != "cuda":
        raise ValueError(f"no stencil3d kernel for device {cur.device}")
    return _kernel_pass(cur, donor, spec, layout, fused_steps, box, refresh,
                        None if region is None else region_cells(region,
                                                                 layout))


def _kernel_pass(cur, donor, spec: StencilSpec, layout: Layout3D,
                 fused_steps: int, box=None, refresh=None, window=None):
    """A checked pass on the card: the march kernel where ``march_takes``
    says so, the plan march kernel where ``plan_march_takes``, else the
    general kernel's launches (``launch_depths``), each
    keeping ``box`` (``check_bounds``' ints; the interior when None), the
    ring refilled by ``refresh`` before each launch past the first, over
    the rows and columns ``window`` (all of the plane when None; a pass of
    one launch only)."""
    box = check_bounds(box, layout.interior, layout.guard, shard=True)
    win = () if window is None else (window,)
    if march_takes(spec, cur.dtype, fused_steps):
        return _launch_march(cur, donor, spec, layout, fused_steps, box, *win)
    if plan_march_takes(spec, cur.dtype, fused_steps):
        return _launch_plan_march(cur, donor, spec, layout, fused_steps, box,
                                  *win)
    itemsize = cur.element_size()
    depths = launch_depths(spec, cur.dtype, fused_steps)
    if len(depths) == 1:
        return _launch(cur, donor, spec, layout, fused_steps,
                       plan_pass(spec, fused_steps, itemsize)[1], box, *win)
    # alternate donor and a scratch buffer so the last pass lands in donor
    bufs = (donor, torch.zeros_like(donor))
    src = cur
    for i, k in enumerate(depths):
        dst = bufs[(len(depths) - 1 - i) % 2]
        if i and refresh is not None:
            src = refresh(src)
        _launch(src, dst, spec, layout, k, plan_pass(spec, k, itemsize)[1],
                box)
        src = dst
    return donor


# kernel launches per instance, for chip_smoke.py: float32, float64 and
# bfloat16, the march and plan march kernels' (of any dtype) apart, and the
# launches over a region
stencil3d_step.launches = stencil3d_step.launches_f64 = 0
stencil3d_step.launches_bf16 = 0
stencil3d_step.launches_march = 0
stencil3d_step.launches_plan_march = 0
stencil3d_step.launches_region = 0
