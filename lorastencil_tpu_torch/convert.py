"""Carry stencil parameters and state from the JAX package into the port.

A system whose parameters are stencil coefficients carries its "weights"
across as a spec: ``spec_from_jax`` rebuilds the port's ``StencilSpec``
from a JAX spec's fields, so both packages compute with the same
coefficients.

The JAX engine keeps its state in its own internal layout
(``lorastencil_tpu/ops/layout.py`` ``Layout1D`` / ``Layout1DLanes`` /
``Layout2D`` / ``Layout3D``: an (8, 128)-aligned guard and TPU tile
round-up, and in 1-D rows of 128 lanes); the port's layouts have their own
guard and tile.  Both hold the same reference-padded array at
the same place relative to their origin, so carrying state across
re-embeds that array.  The JAX df64 tier keeps its state as a stacked
``(2, *layout)`` pair of float32 planes (hi, lo); the port's fp64-grade
state is one float64 buffer, so a pair is merged in float64 first, as
``lorastencil_tpu/ops/df64.py`` ``merge_host`` does.  Nothing here
imports the JAX package: the JAX objects are read through their fields
only.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.shapes import SeparableTerm, StencilSpec


def spec_from_jax(jax_spec) -> StencilSpec:
    """The port's ``StencilSpec`` with the fields of a JAX
    ``lorastencil_tpu.models.shapes.StencilSpec`` (name, ndim, radius,
    halo, terms, residue, fuse_factor), coefficients as Python floats."""

    def taps(t):
        return None if t is None else tuple(float(w) for w in t)

    return StencilSpec(
        name=str(jax_spec.name), ndim=int(jax_spec.ndim),
        radius=int(jax_spec.radius),
        halo=tuple(int(h) for h in jax_spec.halo),
        terms=tuple(SeparableTerm(taps=tuple(taps(t) for t in term.taps))
                    for term in jax_spec.terms),
        residue=tuple((tuple(int(o) for o in off), float(w))
                      for off, w in jax_spec.residue),
        fuse_factor=int(jax_spec.fuse_factor))


def _padded_1d(buf: np.ndarray, jax_layout):
    """(the reference-padded array held by a JAX 1-D buffer, a copy of the
    buffer's other cells with that array zeroed): the latter must be all
    zero."""
    n, h = int(jax_layout.interior), int(jax_layout.halo)
    if hasattr(jax_layout, "lane_halo"):
        # Layout1DLanes: each 128-lane group holds `stride` payload cells
        # after `lane_halo` halo lanes; halo lanes are stale by contract
        lh = int(jax_layout.lane_halo)
        stride = 128 - 2 * lh
        flat = buf.reshape(-1, 128)[:, lh: lh + stride].reshape(-1)
        base = int(jax_layout.guard_rows) * (int(jax_layout.width) // 128) \
            * stride
    else:
        flat = buf.reshape(-1)  # Layout1D: origin guard_rows * 128
        base = int(jax_layout.origin)
    rest = flat.copy()
    rest[base - h: base + n + h] = 0
    return flat[base - h: base + n + h], rest


def merge_pair(state2: np.ndarray) -> np.ndarray:
    """A stacked (2, ...) float32 (hi, lo) pair as one float64 array:
    hi + lo, each widened to float64 first (``df64.merge_host``)."""
    state2 = np.asarray(state2, dtype=np.float32)
    return state2[0].astype(np.float64) + state2[1].astype(np.float64)


def state_from_jax(internal: np.ndarray, jax_layout, port_layout,
                   device=None) -> torch.Tensor:
    """Re-embed a JAX internal-layout buffer (as a NumPy array) into a
    new port internal buffer on ``device``: float64 from a JAX df64 pair
    state (``(2,) + jax_layout.shape``, merged with ``merge_pair``) or a
    JAX float64 state, bfloat16 from a JAX bfloat16 state (an
    ``ml_dtypes.bfloat16`` array: its bits, unchanged), float32 from
    anything else.

    ``jax_layout`` is the JAX ``Layout2D`` or ``Layout3D`` the buffer was
    made with (origin ``(8, 128)`` or ``(zguard, 8, 128)``; only its
    ``interior``, ``halo`` and ``origin`` are read), or a JAX ``Layout1D``
    (flat rows of 128 lanes) or ``Layout1DLanes`` (only the payload lanes
    are read).  ``port_layout`` is the port's layout of the same
    dimension.  Raises if the two layouts hold
    different grids, or if the buffer holds nonzero values outside the
    padded array (the JAX kernels keep the rest of the ring and the
    round-up cells zero, so such values mean the buffer is not a valid
    state)."""
    buf = np.asarray(internal)
    if buf.shape == (2,) + tuple(jax_layout.shape):  # a df64 pair
        buf = merge_pair(buf)
    bf16 = buf.dtype.name == "bfloat16"
    if bf16:  # an ml_dtypes array: carried as its bits
        buf = buf.view(np.int16)
    if not hasattr(port_layout.interior, "__len__"):  # 1-D
        if (int(jax_layout.interior), int(jax_layout.halo)) != (
                port_layout.interior, port_layout.halo):
            raise ValueError(
                f"layouts disagree: JAX interior/halo {jax_layout.interior}/"
                f"{jax_layout.halo}, port {port_layout.interior}/"
                f"{port_layout.halo}")
        padded, rest = _padded_1d(buf, jax_layout)
    else:
        if (tuple(jax_layout.interior) != tuple(port_layout.interior)
                or tuple(jax_layout.halo) != tuple(port_layout.halo)):
            raise ValueError(
                f"layouts disagree: JAX interior/halo {jax_layout.interior}/"
                f"{jax_layout.halo}, port {port_layout.interior}/"
                f"{port_layout.halo}")
        box = tuple(slice(o - h, o + e + h) for o, e, h in
                    zip(jax_layout.origin, jax_layout.interior,
                        jax_layout.halo))
        padded, rest = buf[box], buf.copy()
        rest[box] = 0
    # (a bfloat16 -0.0, which a masked cell can hold, has its sign bit only)
    if np.any((rest & 0x7FFF) != 0 if bf16 else rest != 0):
        raise ValueError(
            "JAX buffer holds nonzero values outside its padded array")
    # copy: a JAX array's NumPy view is read-only, which torch warns about
    src = torch.from_numpy(padded.copy())
    if bf16:
        return port_layout.to_internal(src.view(torch.bfloat16),
                                       torch.bfloat16, device)
    dtype = torch.float64 if buf.dtype == np.float64 else torch.float32
    return port_layout.to_internal(src, dtype, device)
