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
Mosaic precision) is still to be ported (ROADMAP B13).  ``conv_carry`` is
accepted and has no effect: on the TPU it reuses plane convs across slabs
with bit-identical output, and the CUDA kernel's z-march computes each
plane's conv once by construction.

Two kernels: every pass the engine launches for the 3-D registry (star3d1r
and box3d1r, float32 and float64, one or two steps) runs the march kernel,
the source's redesign for Hopper (z-sums in registers, compile-time term
kinds, 16-byte copies); ``march_takes`` is its fixed rule on spec, dtype and
depth, and ``stencil3d_step.launches_march`` counts its launches (they also
count in ``launches`` / ``launches_f64``).  Every other pass -- radius above
1, residue, another term mix, more than two steps -- runs the general
kernel, ``stencil3d_kernel``.  Neither falls back to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.shapes import StencilSpec
from . import _cuda_build
from .band_gemm import (BUFFERED, CENTRE, IDENTITY_Z, apply_spec_3d,
                        plan_array, term_class)
from .layout import Layout3D, check_bounds

ALGORITHMS = ("vpu", "vpu_roll", "mxu_hybrid1")
UNPORTED_ALGORITHMS = ("mxu",)  # ROADMAP B13
MAX_RADIUS = 8  # csrc/stencil3d.cu kMaxRadius
MAX_FUSED = 8  # csrc/stencil3d.cu kMaxK
MAX_PLAN = 4096  # csrc/stencil3d.cu kMaxPlan
# the instance of each state dtype
_ENTRIES = {torch.float32: "ls_stencil3d_step",
            torch.float64: "ls_stencil3d_step_f64"}
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
# in-plane block tiles, largest first; all divide the layout's TILE_3D
BLOCK_TILES = ((32, 64), (16, 64), (16, 32), (8, 32), (8, 16))
Z_CHUNKS = (64, 32, 16)  # output planes per block, largest first
# the march kernel (csrc/stencil3d.cu march_kernel): its entries, radii and
# depths, and a task's tile, 32 rows x 16 quads of 16 bytes
_MARCH_ENTRIES = {torch.float32: "ls_stencil3d_march",
                  torch.float64: "ls_stencil3d_march_f64"}
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
    kernel: float32 or float64, one or two steps, radius 1, no residue,
    and star3d1r's or box3d1r's term mix (``MARCH_KINDS``), whatever the
    taps.  Every other pass runs the general kernel."""
    return (dtype in _MARCH_ENTRIES and depth in MARCH_DEPTHS
            and spec.ndim == 3 and spec.radius in MARCH_RADII
            and not spec.residue
            and (len(spec.terms), term_kinds(spec)) in MARCH_KINDS)


def _check(cur, donor, spec: StencilSpec, layout: Layout3D, algorithm: str,
           fused_steps: int, bounds, region):
    # a float64 state also takes the df64 kernel's name
    algorithms = (ALGORITHMS + ("vpu_sep",) if cur.dtype == torch.float64
                  else ALGORITHMS)
    if algorithm in UNPORTED_ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {algorithm!r} is not ported yet (ROADMAP B13); "
            f"the port runs {ALGORITHMS} through one exact kernel")
    if algorithm not in algorithms:
        raise ValueError(f"unknown algorithm {algorithm!r}; this wrapper "
                         f"takes {algorithms}")
    if region is not None:
        raise NotImplementedError(
            "region (the overlapped sharded engine) is not ported yet "
            "(ROADMAP A11)")
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
        raise TypeError(f"cur must be float32 or float64, got {cur.dtype}")
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
    return check_bounds(bounds, layout.interior, layout.guard)


def stencil3d_step_plain(cur, donor, spec: StencilSpec, layout: Layout3D,
                         fused_steps: int = 1, bounds=None):
    """The kernel's plain PyTorch twin: the same K-level pass with tensor
    ops on whatever device and dtype ``cur`` has, each level masked to the
    global interior (levels before the last: to ``bounds``, 4 or 6 ints,
    see ``stencil3d_step``).  Writes the rounded interior of ``donor`` in
    place (zero beyond the true interior) and returns it; the guard ring
    of ``donor`` is left as it is."""
    K, r = fused_steps, spec.radius
    h, m, n = layout.interior
    _, mr, nr = layout.rounded
    z0, r0, c0 = layout.origin
    box = check_bounds(bounds, layout.interior, layout.guard)
    e = K * r
    level = cur[z0 - e: z0 + h + e, r0 - e: r0 + mr + e, c0 - e: c0 + nr + e]
    for L in range(1, K + 1):
        e = (K - L) * r  # the level's extent beyond the rounded interior
        full = apply_spec_3d(level, spec)
        lohi = box if L < K else (0, h, 0, m, 0, n)
        inside = tuple(slice(max(0, e + lohi[2 * a]), e + lohi[2 * a + 1])
                       for a in range(3))
        level = torch.zeros_like(full)
        level[inside] = full[inside]
    donor[z0: z0 + h, r0: r0 + mr, c0: c0 + nr] = level
    return donor


@functools.lru_cache(maxsize=None)
def _plan_buffer(spec: StencilSpec, device: torch.device, dtype):
    """The tap/residue table in ``dtype`` on ``device``, built once per
    (spec, device, dtype) and never per step: fp64 taps rounded to float32
    would cost ~1e-8 per step."""
    plan = plan_array(spec, dtype)
    if plan.numel() > MAX_PLAN:
        raise ValueError(
            f"{spec.name}: tap table of {plan.numel()} entries exceeds the "
            f"kernel's cap {MAX_PLAN}")
    return plan.to(device)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built and bound once per process."""
    lib = _cuda_build.load("stencil3d")
    lib.ls_stencil3d_smem_bytes.restype = ctypes.c_longlong
    lib.ls_stencil3d_smem_bytes.argtypes = [ctypes.c_int] * 8
    for entry in _ENTRIES.values():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 27
                       + [ctypes.c_void_p])
    for entry in _MARCH_ENTRIES.values():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 22
                       + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _plan_host(spec: StencilSpec, dtype):
    """The tap table in ``dtype`` in host memory, which the march kernel's
    launches copy into their parameters."""
    return plan_array(spec, dtype).contiguous()


def _term_mix(spec: StencilSpec):
    """(buffered terms, planes per level ring): a level keeps 2r+1 planes
    when a centre or identity term or the residue reads them, else only
    the plane whose convs are being taken."""
    buffered, identity, centre = _classify_terms(spec)
    ring = 2 * spec.radius + 1 if (identity or centre or spec.residue) else 1
    return len(buffered), ring


@functools.lru_cache(maxsize=None)
def plan_pass(spec: StencilSpec, fused_steps: int, itemsize: int):
    """(K, block tile) of the kernel's passes for ``fused_steps`` levels of
    ``itemsize``-byte cells (4 float32, 8 float64): the largest tile whose
    shared-memory rings fit at that K, and if none fits, the largest K <=
    ``fused_steps`` for which one does (the wrapper then runs several
    passes)."""
    lib = _lib()
    n_buf, ring = _term_mix(spec)
    plan_len = plan_array(spec).numel()
    for K in range(fused_steps, 0, -1):
        for bm, bn in BLOCK_TILES:
            need = lib.ls_stencil3d_smem_bytes(spec.radius, K, bm, bn,
                                               n_buf, ring, plan_len,
                                               itemsize)
            if 0 <= need <= MAX_SMEM:
                return K, (bm, bn)
    raise ValueError(
        f"{spec.name}: no block tile fits the kernel's shared memory even "
        f"at one step per pass")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _z_chunk(layout: Layout3D, tile, device: torch.device) -> int:
    """Output planes per block: the largest chunk that still gives every
    SM a block, else the smallest.  A block recomputes K*r planes of
    lookback at each end of its chunk, so longer chunks cost less."""
    h, mr, nr = layout.rounded
    tiles = -(-mr // tile[0]) * -(-nr // tile[1])
    for zc in Z_CHUNKS:
        if tiles * -(-h // zc) >= _sm_count(device):
            return zc
    return Z_CHUNKS[-1]


def _launch(cur, out, spec: StencilSpec, layout: Layout3D, K: int, tile,
            box=None):
    """One launch of the instance of ``cur``'s dtype, its levels before
    the last kept to ``box`` (``check_bounds``' 6 ints; the interior when
    None); raises if refused, and counts it."""
    plan = _plan_buffer(spec, cur.device, cur.dtype)
    n_buf, ring = _term_mix(spec)
    nz, rows, pitch = layout.shape
    z0, r0, c0 = layout.origin
    h, m, n = layout.interior
    _, mr, nr = layout.rounded
    zc = _z_chunk(layout, tile, cur.device)
    box = check_bounds(box, layout.interior, layout.guard)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), _ENTRIES[cur.dtype])(
            cur.data_ptr(), out.data_ptr(), plan.data_ptr(), plan.numel(),
            len(spec.terms), spec.radius, len(spec.residue), n_buf, ring, K,
            nz, rows, pitch, z0, r0, c0, h, m, n, mr, nr, tile[0], tile[1],
            zc, *box, stream)
    if err != 0:
        raise RuntimeError(
            f"stencil3d kernel launch failed: CUDA error {err}")
    if cur.dtype == torch.float64:
        stencil3d_step.launches_f64 += 1
    else:
        stencil3d_step.launches += 1
    return out


def _launch_march(cur, out, spec: StencilSpec, layout: Layout3D, K: int,
                  box):
    """One launch of the march kernel's instance of ``cur``'s dtype, its
    first level kept to ``box`` at K = 2 (``check_bounds``' 6 ints);
    raises if refused, and counts it."""
    plan = _plan_host(spec, cur.dtype)
    nz, rows, pitch = layout.shape
    z0, r0, c0 = layout.origin
    h, m, n = layout.interior
    _, mr, nr = layout.rounded
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), _MARCH_ENTRIES[cur.dtype])(
            cur.data_ptr(), out.data_ptr(), plan.data_ptr(), plan.numel(),
            len(spec.terms), spec.radius, len(spec.residue), K, nz, rows,
            pitch, z0, r0, c0, h, m, n, mr, nr, *box, stream)
    if err != 0:
        raise RuntimeError(
            f"stencil3d march kernel launch failed: CUDA error {err}")
    if cur.dtype == torch.float64:
        stencil3d_step.launches_f64 += 1
    else:
        stencil3d_step.launches += 1
    stencil3d_step.launches_march += 1
    return out


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
    the float64 ones and counts in ``launches_f64``.  A pass that
    ``march_takes`` runs the march kernel in one launch, also counted in
    ``launches_march``.  Any other runs the general kernel: one launch
    does all ``fused_steps`` levels when a block's shared-memory rings fit
    at that depth; otherwise it runs passes of the largest depth that
    fits, through one extra zero-ringed buffer, and the launch counter
    shows each pass.

    ``bounds``, as the JAX wrapper's: 4 ints ``(rlo, rhi, clo, chi)`` or 6
    ``(zlo, zhi, rlo, rhi, clo, chi)`` in interior coordinates (the
    interior when None; ``layout.check_bounds``), the box that the fused
    levels before the last keep, so that a ghost ring the caller filled
    stays alive through them.  The last level is masked to the interior
    in every case (see ``stencil2d.stencil2d_step``): a one-step pass
    only checks ``bounds``.  ``refresh`` refills the ring of the buffer
    between two launches of a pass split for shared memory.  ``region``
    is not ported (ROADMAP A11)."""
    del conv_carry  # bit-identical by contract; see the module docstring
    box = _check(cur, donor, spec, layout, algorithm, fused_steps, bounds,
                 region)
    if cur.device.type == "cpu":
        return stencil3d_step_plain(cur, donor, spec, layout, fused_steps,
                                    box)
    if cur.device.type != "cuda":
        raise ValueError(f"no stencil3d kernel for device {cur.device}")
    return _kernel_pass(cur, donor, spec, layout, fused_steps, box, refresh)


def _kernel_pass(cur, donor, spec: StencilSpec, layout: Layout3D,
                 fused_steps: int, box=None, refresh=None):
    """A checked pass on the card: the march kernel where ``march_takes``
    says so, else the general kernel's launches, each keeping ``box``
    (``check_bounds``' ints; the interior when None), the ring refilled
    by ``refresh`` before each launch past the first."""
    box = check_bounds(box, layout.interior, layout.guard)
    if march_takes(spec, cur.dtype, fused_steps):
        return _launch_march(cur, donor, spec, layout, fused_steps, box)
    itemsize = cur.element_size()
    K, tile = plan_pass(spec, fused_steps, itemsize)
    depths = [K] * (fused_steps // K) + (
        [fused_steps % K] if fused_steps % K else [])
    if len(depths) == 1:
        return _launch(cur, donor, spec, layout, K, tile, box)
    # alternate donor and a scratch buffer so the last pass lands in donor
    bufs = (donor, torch.zeros_like(donor))
    src = cur
    for i, k in enumerate(depths):
        dst = bufs[(len(depths) - 1 - i) % 2]
        if i and refresh is not None:
            src = refresh(src)
        _launch(src, dst, spec, layout, k,
                tile if k == K else plan_pass(spec, k, itemsize)[1], box)
        src = dst
    return donor


# kernel launches per instance, for chip_smoke.py: float32 and float64, and
# the march kernel's (of either dtype) apart
stencil3d_step.launches = stencil3d_step.launches_f64 = 0
stencil3d_step.launches_march = 0
