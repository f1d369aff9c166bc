"""One 2-D stencil pass on the internal layout: the CUDA kernel's wrapper.

Counterpart of ``lorastencil_tpu/ops/pallas_2d.py`` ``stencil2d_step``
(kernel ``_stencil2d_kernel``) at ``fused_steps=1``.  On a CUDA tensor
``stencil2d_step`` launches the hand-written kernel ``csrc/stencil2d.cu``
or raises; only a CPU tensor runs the plain PyTorch twin,
``stencil2d_step_plain``, which is also callable directly (the tests and
``chip_smoke.py`` hold the kernel against it on the card).

``algorithm``: the TPU kernel's exact-fp32 variants ``'mxu_hybrid1'``,
``'vpu_roll'`` and ``'vpu'`` differ only in how they use the TPU's matrix
and vector units.  On Hopper they are one computation, so all three run
this one fp32 CUDA-core kernel.  The lossy or TPU-specific variants are
still to be ported (ROADMAP queue B).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.shapes import StencilSpec

from . import _cuda_build
from .band_gemm import apply_spec, mask_to_interior, plan_array
from .layout import Layout2D

ALGORITHMS = ("mxu_hybrid1", "vpu_roll", "vpu")
# the TPU kernel's other variants, still to be ported (ROADMAP B2, B13)
UNPORTED_ALGORITHMS = ("mxu", "mxu_split", "mxu_hybrid", "mxu_hybrid1r",
                       "mxu_hybrid3")
MAX_RADIUS = 16  # csrc/stencil2d.cu kMaxRadius
MAX_PLAN = 4096  # csrc/stencil2d.cu kMaxPlan


def _check(cur, donor, spec: StencilSpec, layout: Layout2D,
           algorithm: str, fused_steps: int):
    if algorithm in UNPORTED_ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {algorithm!r} is not ported yet (ROADMAP B13); "
            f"the port runs {ALGORITHMS} through one exact fp32 kernel")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
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
    for name, t in (("cur", cur), ("donor", donor)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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


def stencil2d_step_plain(cur, donor, spec: StencilSpec, layout: Layout2D):
    """The kernel's plain PyTorch twin: the same pass with tensor ops on
    whatever device ``cur`` is on.  Writes the rounded interior of
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
def _plan_buffer(spec: StencilSpec, device: torch.device):
    """The tap/residue table on ``device``, built once per (spec,
    device) and never per step."""
    plan = plan_array(spec)
    if plan.numel() > MAX_PLAN:
        raise ValueError(
            f"{spec.name}: tap table of {plan.numel()} floats exceeds the "
            f"kernel's cap {MAX_PLAN}")
    return plan.to(device)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built and bound once per process."""
    lib = _cuda_build.load("stencil2d")
    fn = lib.ls_stencil2d_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    return lib


def stencil2d_step(cur, donor, spec: StencilSpec, layout: Layout2D,
                   algorithm: str = "mxu_hybrid1", fused_steps: int = 1):
    """One timestep on the internal layout: reads ``cur``, writes the
    rounded interior of ``donor`` in place and returns ``donor``.

    ``donor``'s guard ring must be zero; it stays untouched, which is
    what makes the halo decay after the first step.  A CUDA tensor runs
    the CUDA kernel (or raises); a CPU tensor runs
    ``stencil2d_step_plain``."""
    _check(cur, donor, spec, layout, algorithm, fused_steps)
    if cur.device.type == "cpu":
        return stencil2d_step_plain(cur, donor, spec, layout)
    if cur.device.type != "cuda":
        raise ValueError(f"no stencil2d kernel for device {cur.device}")
    lib = _lib()
    plan = _plan_buffer(spec, cur.device)
    n_terms, n_res = len(spec.terms), len(spec.residue)
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ls_stencil2d_step(
            cur.data_ptr(), donor.data_ptr(), plan.data_ptr(),
            plan.numel(), n_terms, spec.radius, n_res, rows, pitch, r0,
            c0, m, n, mr, nr, stream)
    if err != 0:
        raise RuntimeError(
            f"stencil2d kernel launch failed: CUDA error {err}")
    stencil2d_step.launches += 1
    return donor


stencil2d_step.launches = 0  # kernel launches, for chip_smoke.py
