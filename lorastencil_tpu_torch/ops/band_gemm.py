"""Plain PyTorch separable stencil application on a halo'd window.

Counterpart of ``lorastencil_tpu/ops/band_gemm.py`` (``apply_spec_hybrid1``
with its residue and one-axis conv helpers, ``_residue_rolled`` and
``_conv_rolled_1axis``).  The TPU version runs the column conv as
split-bf16 banded matmuls and the rest as cyclic rolls over the full
window, letting wrap garbage creep into the guard margin.  Here every
operand is an exact shifted slice of the window, and there is no matmul,
so TF32 cannot enter on a GPU.

This is the arithmetic of the CUDA kernel (``csrc/stencil2d.cu``) written
with tensor ops, in the kernel's order: per term a column-axis conv
(``taps[-1]``) then a row-axis conv (``taps[-2]``), taps in ascending
offset, zero taps skipped, a ``None`` axis the identity; then the sparse
residue point by point.  The kernel fuses each multiply-add (``fmaf``), so
on data whose products round the two agree to fp32 rounding, and bit for
bit on integer data below 2**24.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lorastencil_tpu.models.shapes import StencilSpec


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


def apply_spec(X, spec: StencilSpec, halo: Tuple[int, int]):
    """One stencil application on window ``X`` of extent
    ``(R + 2*hr, C + 2*hc)``; returns the ``(R, C)`` centre.  Needs
    ``halo >= spec.radius`` per axis."""
    hr, hc = halo
    R, C = X.shape[0] - 2 * hr, X.shape[1] - 2 * hc
    acc = None
    for term in spec.terms:
        rt, ct = term.taps[-2], term.taps[-1]
        rr, rc = _half(rt), _half(ct)
        # column conv over the rows the row conv will read
        rows = X.narrow(0, hr - rr, R + 2 * rr)
        if ct is None:
            Y = rows.narrow(1, hc, C)
        else:
            Y = _conv_1axis(rows, ct, 1, hc - rc, C)
        if Y is None:
            continue
        Z = Y if rt is None else _conv_1axis(Y, rt, 0, 0, R)
        if Z is not None:
            acc = Z if acc is None else acc + Z
    for (dr, dc), w in spec.residue:
        v = float(w) * X[hr + dr: hr + dr + R, hc + dc: hc + dc + C]
        acc = v if acc is None else acc + v
    if acc is None:
        return X.new_zeros((R, C))
    return acc


def mask_to_interior(val, m: int, n: int):
    """Zero, in place, the cells of an interior-origin block beyond the
    true interior (m, n): the tile round-up cells, which would otherwise
    feed real cells on the next step."""
    val[m:, :] = 0.0
    val[:, n:] = 0.0
    return val


def plan_array(spec: StencilSpec) -> "torch.Tensor":
    """The CUDA kernel's tap and residue table, float32, with W = 2r+1:

        per term:  has_col, has_row, col taps[W], row taps[W]
        per point: dr, dc, w

    Taps are centred in W; a ``None`` axis has flag 0 and zero taps.
    Small integers (flags, offsets) are exact in float32."""
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
        vals += [float(ct is not None), float(rt is not None)]
        vals += centred(ct) + centred(rt)
    for (dr, dc), w in spec.residue:
        if max(abs(dr), abs(dc)) > r:
            raise ValueError(f"{spec.name}: residue offset beyond radius")
        vals += [float(dr), float(dc), float(w)]
    return torch.tensor(vals, dtype=torch.float32)
