"""NumPy float64 ground truth for all stencil shapes.

The port's copy of the NumPy path of ``lorastencil_tpu/utils/reference.py``
(the port imports nothing of the JAX package).  It reproduces the reference
artifact's ``test_cpu`` verifiers and their multi-step behaviour:

* State is the *padded* array (interior + halo of width ``spec.halo``).
* One step writes the dense stencil into the interior only; every halo
  cell of the output is zero (the reference's output buffers are
  zero-initialized and its kernels write interior tiles only, so halo
  values decay to zero after the first step).
* The first step therefore sees the *user-provided* halo values; later
  steps see zeros.

The JAX module's optional C++ speed-up (``lorastencil_tpu.native``) is not
copied: on the card the checks use ``ops/torch_ref.dense_step`` in float64.
"""

from __future__ import annotations

import numpy as np

from ..models.shapes import StencilSpec


def interior_slices(spec: StencilSpec, padded_shape):
    """Slices selecting the interior of a padded array."""
    return tuple(
        slice(h, s - h) for h, s in zip(spec.halo, padded_shape)
    )


def dense_step(grid: np.ndarray, spec: StencilSpec) -> np.ndarray:
    """One stencil step on a padded grid; returns the new padded grid
    (interior = stencil, halo = 0).  float64 throughout."""
    grid = np.asarray(grid, dtype=np.float64)
    assert grid.ndim == spec.ndim
    S = spec.dense_coeffs()
    r = spec.radius
    out = np.zeros_like(grid)
    it = interior_slices(spec, grid.shape)
    acc = np.zeros(out[it].shape, dtype=np.float64)
    for idx in np.argwhere(np.abs(S) > 0):
        w = S[tuple(idx)]
        off = [int(i) - r for i in idx]
        src = tuple(
            slice(sl.start + o, sl.stop + o) for sl, o in zip(it, off)
        )
        acc += w * grid[src]
    out[it] = acc
    return out


def run(grid0: np.ndarray, spec: StencilSpec, steps: int) -> np.ndarray:
    """``steps`` stencil steps from the user-provided padded grid."""
    g = np.asarray(grid0, dtype=np.float64)
    for _ in range(steps):
        g = dense_step(g, spec)
    return g


def random_padded(spec: StencilSpec, interior, seed: int = 0,
                  lo: int = 0, hi: int = 100) -> np.ndarray:
    """Random integer-valued padded grid, mirroring the reference's
    FILL_RANDOM (rand() % 100) over the whole padded buffer, halo
    included."""
    rng = np.random.default_rng(seed)
    shape = spec.padded_shape(interior)
    return rng.integers(lo, hi, size=shape).astype(np.float64)
