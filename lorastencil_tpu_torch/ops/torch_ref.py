"""Plain PyTorch stencil steps on the reference-padded layout.

Counterpart of ``lorastencil_tpu/ops/xla_ref.py`` (``dense_step``,
``separable_step``, ``conv_full``):

* ``dense_step``     -- one shifted slice-add per nonzero coefficient: the
                        naive stencil, the baseline ``chip_smoke.py`` times
                        the kernel against, and (in float64) its on-card
                        ground truth;
* ``separable_step`` -- per-term axis convs plus the residue, the
                        ``backend='xla'`` path of the engine;
* ``conv_full``      -- the unmasked correlation over the whole padded
                        extent that ends the adjoint chain of
                        ``engine.StencilEngine.run_diff``.

All three take 1-D, 2-D and 3-D grids; the steps write the stencil into
the interior and zero the halo (the reference's multi-step semantics,
``utils/reference.py``).  None uses a matmul or a convolution routine, so
TF32 cannot enter on a GPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.shapes import StencilSpec

from .band_gemm import _conv_1axis, apply_spec, apply_spec_3d


def _interior(spec: StencilSpec, shape):
    if len(shape) != spec.ndim:
        raise ValueError(
            f"grid is {len(shape)}-D and {spec.name!r} is {spec.ndim}-D")
    return tuple(slice(h, s - h) for h, s in zip(spec.halo, shape))


def dense_step(grid, spec: StencilSpec):
    """Naive stencil: one shifted slice per nonzero tap, in ``grid``'s
    dtype."""
    S = spec.dense_coeffs()
    r = spec.radius
    it = _interior(spec, grid.shape)
    acc = None
    for idx in np.argwhere(np.abs(S) > 0):
        w = float(S[tuple(idx)])
        src = tuple(slice(sl.start + int(i) - r, sl.stop + int(i) - r)
                    for sl, i in zip(it, idx))
        v = w * grid[src]
        acc = v if acc is None else acc + v
    out = torch.zeros_like(grid)
    out[it] = acc
    return out


def conv_full(grid, spec: StencilSpec):
    """Unmasked correlation over the FULL padded extent, zero beyond the
    array: out[p] = sum_o S[o] * grid[p + o] for every p, in ``grid``'s
    dtype on its device (a bfloat16 grid sums in float32 and rounds once),
    one shifted slice-add per nonzero tap in ``np.argwhere`` order.  The
    last factor of the dirichlet0 adjoint
    (``engine.StencilEngine.run_diff``): unlike ``dense_step`` it writes
    the halo too, since step one of the forward pass reads the input
    halo.  ``utils/reference.conv_full`` is its float64 host twin."""
    if grid.ndim != spec.ndim:
        raise ValueError(
            f"grid is {grid.ndim}-D and {spec.name!r} is {spec.ndim}-D")
    S = spec.dense_coeffs()
    r = spec.radius
    gp = F.pad(grid, (r, r) * grid.ndim)
    if grid.dtype == torch.bfloat16:
        gp = gp.float()
    acc = None
    for idx in np.argwhere(np.abs(S) > 0):
        v = float(S[tuple(idx)]) * gp[tuple(
            slice(int(i), int(i) + s) for i, s in zip(idx, grid.shape))]
        acc = v if acc is None else acc + v
    return torch.zeros_like(grid) if acc is None else acc.to(grid.dtype)


def separable_step(grid, spec: StencilSpec):
    """Axis-separated stencil: per-term column then row convs, then the
    residue (``band_gemm.apply_spec`` on the whole padded array; in 3-D
    ``band_gemm.apply_spec_3d`` on the interior and a radius-deep margin;
    in 1-D each term's taps, then the residue, as ``xla_ref``)."""
    it = _interior(spec, grid.shape)
    out = torch.zeros_like(grid)
    if spec.ndim == 1:
        (sl,) = it
        n = sl.stop - sl.start
        acc = None
        for term in spec.terms:
            (taps,) = term.taps
            if taps is None:
                v = grid[sl]
            else:
                v = _conv_1axis(grid, taps, 0, sl.start - len(taps) // 2, n)
                if v is None:
                    continue
            acc = v if acc is None else acc + v
        for (d,), w in spec.residue:
            v = float(w) * grid[sl.start + d: sl.stop + d]
            acc = v if acc is None else acc + v
        if acc is not None:
            out[it] = acc
    elif spec.ndim == 2:
        out[it] = apply_spec(grid, spec, spec.halo)
    else:
        r = spec.radius
        out[it] = apply_spec_3d(
            grid[tuple(slice(sl.start - r, sl.stop + r) for sl in it)],
            spec)
    return out
