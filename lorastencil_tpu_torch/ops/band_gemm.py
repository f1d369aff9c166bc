"""Plain PyTorch separable stencil application on a halo'd window.

Counterpart of ``lorastencil_tpu/ops/band_gemm.py`` (``apply_spec_hybrid1``
with its residue and one-axis conv helpers, ``_residue_rolled`` and
``_conv_rolled_1axis``).  The TPU version runs the column conv as
split-bf16 banded matmuls and the rest as cyclic rolls over the full
window, letting wrap garbage creep into the guard margin.  Here every
operand is an exact shifted slice of the window, and there is no matmul,
so TF32 cannot enter on a GPU.

This is the arithmetic of the CUDA kernels (``csrc/stencil2d.cu``, and
per 3-D term ``conv_plane`` for ``csrc/stencil3d.cu``) written with tensor
ops, in the kernels' order: per term a column-axis conv (``taps[-1]``)
then a row-axis conv (``taps[-2]``), taps in ascending offset, zero taps
skipped, a ``None`` axis the identity; then the sparse residue point by
point.  The fp32 kernels fuse each multiply-add (``fmaf``), so on data
whose products round the two agree to fp32 rounding, and bit for bit on
integer data below 2**24 -- and on any data where every tap is a power of
two (all of the 3-D registry's), since an exact product makes an FMA equal
to a multiply then an add.  The fp64 instance of the 2-D kernel rounds each
product and sum on its own, so on float64 tensors the two agree bit for bit
on any data.

The whole-grid 2-D runs keep this order too.  The JAX resident kernels
(``pallas_2d._stencil2d_resident_kernel``, ``pallas_df64.
_resident_pair_2d_kernel``) step with ``apply_spec_vpu_rolled``, which adds
an equal (+d, -d) tap pair before one multiply and sums the residue by row
groups; that order only saves TPU vector rolls.  Here every 2-D kernel --
step, fused, skewed and resident -- runs the one per-cell sum above, so a
resident run equals the tiled passes bit for bit on any data, and the JAX
resident kernels to fp32 rounding (bit for bit on integer data below
2**24, where no order rounds).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models.shapes import StencilSpec


def _conv_1axis(src, taps: Sequence[float], axis: int, start: int,
                length: int):
    """``sum_k taps[k] * src[start + k : start + k + length]`` along
    ``axis``; None when every tap is zero."""
    acc = None
    for k, w in enumerate(taps):
        if w == 0.0:
            continue
        v = float(w) * src.narrow(axis, start + k, length)
        acc = v if acc is None else acc + v
    return acc


def _half(taps: Optional[Sequence[float]]) -> int:
    return 0 if taps is None else (len(taps) - 1) // 2


def conv_plane(X, rt: Optional[Sequence[float]],
               ct: Optional[Sequence[float]], halo: Tuple[int, int]):
    """One separable term's in-plane conv on the last two axes of ``X``
    (extent ``(R + 2*hr, C + 2*hc)`` there, any leading axes): the column
    conv ``ct`` over the rows the row conv will read, then the row conv
    ``rt``; ``None`` is the identity along that axis.  Returns the
    ``(R, C)`` centre, or None when every tap is zero."""
    hr, hc = halo
    R, C = X.shape[-2] - 2 * hr, X.shape[-1] - 2 * hc
    rr, rc = _half(rt), _half(ct)
    rows = X.narrow(-2, hr - rr, R + 2 * rr)
    if ct is None:
        Y = rows.narrow(-1, hc, C)
    else:
        Y = _conv_1axis(rows, ct, -1, hc - rc, C)
    if Y is None or rt is None:
        return Y
    return _conv_1axis(Y, rt, -2, 0, R)


def apply_spec(X, spec: StencilSpec, halo: Tuple[int, int]):
    """One stencil application on window ``X`` of extent
    ``(R + 2*hr, C + 2*hc)``; returns the ``(R, C)`` centre.  Needs
    ``halo >= spec.radius`` per axis."""
    hr, hc = halo
    R, C = X.shape[0] - 2 * hr, X.shape[1] - 2 * hc
    acc = None
    for term in spec.terms:
        Z = conv_plane(X, term.taps[-2], term.taps[-1], halo)
        if Z is not None:
            acc = Z if acc is None else acc + Z
    for (dr, dc), w in spec.residue:
        v = float(w) * X[hr + dr: hr + dr + R, hc + dc: hc + dc + C]
        acc = v if acc is None else acc + v
    if acc is None:
        return X.new_zeros((R, C))
    return acc


def apply_spec_3d(P, spec: StencilSpec):
    """One 3-D stencil application on a block ``P`` with a margin of
    ``spec.radius`` on every axis; returns the ``(Z, R, C)`` centre.

    The sum per cell, in ``csrc/stencil3d.cu``'s order (that of
    ``pallas_3d._stencil3d_kernel``'s ``combine_plane``): the centre
    terms' plane convs; each buffered term's plane convs of planes
    z - rz .. z + rz (every plane's conv computed once) times its z taps;
    each identity term's z-shifted planes times its z taps; then the
    residue point by point."""
    r = spec.radius
    Z, R, C = (s - 2 * r for s in P.shape)
    acc = None

    def add(v):
        nonlocal acc
        if v is not None:
            acc = v if acc is None else acc + v

    def z_taps(tz):
        rz = _half(tz)
        return [(dz, float(tz[rz + dz])) for dz in range(-rz, rz + 1)
                if tz[rz + dz] != 0.0]

    by_class = {c: [t for t in spec.terms if term_class(t) == c]
                for c in (CENTRE, BUFFERED, IDENTITY_Z)}
    for t in by_class[CENTRE]:
        add(conv_plane(P.narrow(0, r, Z), t.taps[1], t.taps[2], (r, r)))
    for t in by_class[BUFFERED]:
        conv = conv_plane(P, t.taps[1], t.taps[2], (r, r))
        if conv is not None:
            for dz, w in z_taps(t.taps[0]):
                add(w * conv.narrow(0, r + dz, Z))
    plane = P[:, r: r + R, r: r + C]
    for t in by_class[IDENTITY_Z]:
        for dz, w in z_taps(t.taps[0]):
            add(w * plane.narrow(0, r + dz, Z))
    for (dz, dr, dc), w in spec.residue:
        add(float(w) * P[r + dz: r + dz + Z, r + dr: r + dr + R,
                         r + dc: r + dc + C])
    if acc is None:
        return P.new_zeros((Z, R, C))
    return acc


def mask_to_interior(val, m: int, n: int, margin: int = 0, bounds=None):
    """Zero, in place, the cells of a block beyond the true interior
    (m, n), where the block's cell (margin, margin) is interior cell
    (0, 0): the tile round-up cells, which would otherwise feed real cells
    on the next step, and at a fused level the ``margin`` halo and guard
    cells around the interior (pallas_2d.py mask_to_interior).

    ``bounds`` ``(rlo, rhi, clo, chi)``, in interior coordinates, widens
    the box kept to ``[rlo, rhi) x [clo, chi)`` (``rlo <= 0``, ``rhi >=
    m``, ...): a fused level under a ghost boundary keeps the ring.  None
    is ``(0, m, 0, n)``."""
    rlo, rhi, clo, chi = (0, m, 0, n) if bounds is None else bounds
    val[:max(0, margin + rlo), :] = 0.0
    val[max(0, margin + rhi):, :] = 0.0
    val[:, :max(0, margin + clo)] = 0.0
    val[:, max(0, margin + chi):] = 0.0
    return val


# 3-D term classes (lorastencil_tpu/ops/pallas_3d.py _classify_terms)
CENTRE, IDENTITY_Z, BUFFERED = 0, 1, 2


def term_class(term) -> int:
    """A 3-D term's class: CENTRE (no z taps), IDENTITY_Z (z taps only,
    star3d1r's z +- 1 planes) or BUFFERED (z taps with an in-plane conv,
    box3d1r: each plane's conv is computed once and reused)."""
    tz, rt, ct = term.taps
    if tz is None:
        return CENTRE
    return IDENTITY_Z if rt is None and ct is None else BUFFERED


def plan_array(spec: StencilSpec,
               dtype=torch.float32) -> "torch.Tensor":
    """The CUDA kernels' tap and residue table in the state's ``dtype``
    (float32, or float64 for the fp64 instances: fp64 taps rounded to
    float32 would cost ~1e-8 per step), with W = 2r+1.
    2-D (``csrc/stencil2d.cu``):

        per term:  has_col, has_row, col taps[W], row taps[W]
        per point: dr, dc, w

    3-D (``csrc/stencil3d.cu``):

        per term:  class, has_col, has_row, z taps[W], col taps[W],
                   row taps[W]
        per point: dz, dr, dc, w

    Taps are centred in W; a ``None`` axis has flag 0 and zero taps.
    Small integers (classes, flags, offsets) are exact in either dtype."""
    r = spec.radius
    W = 2 * r + 1
    vals = []

    def centred(taps):
        out = [0.0] * W
        if taps is not None:
            pad = r - _half(taps)
            if pad < 0:
                raise ValueError(f"{spec.name}: taps wider than 2r+1")
            out[pad: pad + len(taps)] = [float(t) for t in taps]
        return out

    for term in spec.terms:
        rt, ct = term.taps[-2], term.taps[-1]
        if spec.ndim == 3:
            vals.append(float(term_class(term)))
        vals += [float(ct is not None), float(rt is not None)]
        if spec.ndim == 3:
            vals += centred(term.taps[0])
        vals += centred(ct) + centred(rt)
    for off, w in spec.residue:
        if max(abs(o) for o in off) > r:
            raise ValueError(f"{spec.name}: residue offset beyond radius")
        vals += [float(o) for o in off] + [float(w)]
    return torch.tensor(vals, dtype=dtype)
