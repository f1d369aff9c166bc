"""One 2-D stencil pass on the internal layout: the CUDA kernel's wrapper.

Counterpart of ``lorastencil_tpu/ops/pallas_2d.py`` ``stencil2d_step``
(kernel ``_stencil2d_kernel``) at ``fused_steps=1``, and of
``lorastencil_tpu/ops/pallas_df64.py`` ``df64_step`` (kernel
``_df64_kernel``).  ``csrc/stencil2d.cu`` has a float32 and a float64
instance: ``stencil2d_step`` launches the one of its state's dtype.  On a
CUDA tensor the wrapper launches or raises; only a CPU tensor runs the
plain PyTorch twin, ``stencil2d_step_plain``, which is also callable
directly (the tests and ``chip_smoke.py`` hold the kernels against it on
the card).

``algorithm``: the TPU kernel's exact-fp32 variants ``'mxu_hybrid1'``,
``'vpu_roll'`` and ``'vpu'`` differ only in how they use the TPU's matrix
and vector units.  On Hopper they are one computation, so all three run
this one CUDA-core kernel.  The TPU's df64 variants ``'vpu'``,
``'vpu_roll'`` and ``'vpu_sep'`` (dense rolls, dense slices, separable
form on (hi, lo) fp32 pairs) are likewise one native-fp64 computation:
all three run the float64 instance.  The lossy or TPU-specific fp32
variants are still to be ported (ROADMAP queue B).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.shapes import StencilSpec

from . import _cuda_build
from .band_gemm import apply_spec, mask_to_interior, plan_array
from .layout import Layout2D

ALGORITHMS = ("mxu_hybrid1", "vpu_roll", "vpu")
# the names pallas_df64.df64_step takes
DF64_ALGORITHMS = ("vpu", "vpu_roll", "vpu_sep")
# the TPU kernel's other variants, still to be ported (ROADMAP B2, B13)
UNPORTED_ALGORITHMS = ("mxu", "mxu_split", "mxu_hybrid", "mxu_hybrid1r",
                       "mxu_hybrid3")
MAX_RADIUS = 16  # csrc/stencil2d.cu kMaxRadius
MAX_PLAN = 4096  # csrc/stencil2d.cu kMaxPlan
_ENTRIES = {torch.float32: "ls_stencil2d_step",
            torch.float64: "ls_stencil2d_step_f64"}


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
    if fused_steps != 1:
        raise NotImplementedError(
            "fused_steps > 1 is not ported yet (ROADMAP B2)")
    if spec.ndim != 2:
        raise ValueError(f"{spec.name} is {spec.ndim}-D, not 2-D")
    if spec.radius > MAX_RADIUS:
        raise ValueError(
            f"radius {spec.radius} exceeds the kernel's cap {MAX_RADIUS}")
    layout.validate()
    if min(layout.guard) < spec.radius:
        raise ValueError(
            f"guard {layout.guard} is narrower than radius {spec.radius}")
    if cur.dtype not in _ENTRIES:
        raise TypeError(f"cur must be float32 or float64, got {cur.dtype}")
    for name, t in (("cur", cur), ("donor", donor)):
        if t.dtype != cur.dtype:
            raise TypeError(f"{name} must be {cur.dtype}, got {t.dtype}")
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
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stencil2d kernel for device {cur.device}")


def stencil2d_step_plain(cur, donor, spec: StencilSpec, layout: Layout2D):
    """The kernels' plain PyTorch twin: the same pass with tensor ops on
    whatever device and dtype ``cur`` has.  Writes the rounded interior of
    ``donor`` in place (masked to the true interior) and returns it; the
    guard ring of ``donor`` is left as it is."""
    r = spec.radius
    r0, c0 = layout.origin
    mr, nr = layout.rounded
    window = cur[r0 - r: r0 + mr + r, c0 - r: c0 + nr + r]
    val = mask_to_interior(apply_spec(window, spec, (r, r)),
                           *layout.interior)
    donor[r0: r0 + mr, c0: c0 + nr] = val
    return donor


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


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built and bound once per process."""
    lib = _cuda_build.load("stencil2d")
    for entry in _ENTRIES.values():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
    return lib


def _launch(cur, donor, spec: StencilSpec, layout: Layout2D):
    """One launch of the instance of ``cur``'s dtype; raises if refused."""
    plan = _plan_buffer(spec, cur.device, cur.dtype)
    n_terms, n_res = len(spec.terms), len(spec.residue)
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), _ENTRIES[cur.dtype])(
            cur.data_ptr(), donor.data_ptr(), plan.data_ptr(),
            plan.numel(), n_terms, spec.radius, n_res, rows, pitch, r0,
            c0, m, n, mr, nr, stream)
    if err != 0:
        raise RuntimeError(
            f"stencil2d kernel launch failed: CUDA error {err}")


def stencil2d_step(cur, donor, spec: StencilSpec, layout: Layout2D,
                   algorithm: str = "mxu_hybrid1", fused_steps: int = 1):
    """One timestep on the internal layout: reads ``cur``, writes the
    rounded interior of ``donor`` in place and returns ``donor``.

    ``donor``'s guard ring must be zero; it stays untouched, which is
    what makes the halo decay after the first step.  A CUDA tensor runs
    the kernel's instance of its dtype (or raises); a CPU tensor runs
    ``stencil2d_step_plain``.  On a float64 state (dtypes 'float64' and
    'df64') it is the fp64-grade step of ``pallas_df64.df64_step`` and also
    takes that wrapper's name 'vpu_sep'.  ``launches`` counts the float32
    instance's launches, ``launches_f64`` the float64 one's."""
    _check(cur, donor, spec, layout, algorithm, fused_steps)
    if cur.device.type == "cpu":
        return stencil2d_step_plain(cur, donor, spec, layout)
    _launch(cur, donor, spec, layout)
    if cur.dtype == torch.float64:
        stencil2d_step.launches_f64 += 1
    else:
        stencil2d_step.launches += 1
    return donor


# kernel launches per instance, for chip_smoke.py: float32 and float64
stencil2d_step.launches = stencil2d_step.launches_f64 = 0


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
