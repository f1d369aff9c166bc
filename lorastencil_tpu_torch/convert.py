"""Carry 2-D state from the JAX package into the port.

The JAX engine keeps its state in its own internal layout
(``lorastencil_tpu/ops/layout.py`` ``Layout2D``: an (8, 128)-aligned guard
and TPU tile round-up); the port's layout has its own guard and tile.
Both hold the same reference-padded array at the same place relative to
their origin, so carrying state across re-embeds that array.  The stencil
parameters need no conversion: both packages run the same ``StencilSpec``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.layout import Layout2D


def state_from_jax(internal: np.ndarray, jax_layout, port_layout: Layout2D,
                   device=None) -> torch.Tensor:
    """Re-embed a JAX internal-layout buffer (as a NumPy array) into a
    new port internal buffer on ``device``.

    ``jax_layout`` is the JAX ``Layout2D`` the buffer was made with; only
    its ``interior``, ``halo`` and ``origin`` are read, so this module
    needs no JAX.  Raises if the two layouts hold different grids, or if
    the buffer holds nonzero values outside the padded array (the JAX
    kernels keep the rest of the ring and the round-up cells zero, so
    such values mean the buffer is not a valid state)."""
    buf = np.asarray(internal)
    if (tuple(jax_layout.interior) != tuple(port_layout.interior)
            or tuple(jax_layout.halo) != tuple(port_layout.halo)):
        raise ValueError(
            f"layouts disagree: JAX interior/halo {jax_layout.interior}/"
            f"{jax_layout.halo}, port {port_layout.interior}/"
            f"{port_layout.halo}")
    m, n = jax_layout.interior
    hm, hn = jax_layout.halo
    r0, c0 = jax_layout.origin
    box = (slice(r0 - hm, r0 + m + hm), slice(c0 - hn, c0 + n + hn))
    rest = buf.copy()
    rest[box] = 0
    if np.any(rest != 0):
        raise ValueError(
            "JAX buffer holds nonzero values outside its padded array")
    # copy: a JAX array's NumPy view is read-only, which torch warns about
    return port_layout.to_internal(buf[box].copy(), device=device)
