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

``run_periodic`` and ``run_reflect`` are the ground truth of the ghost
boundaries (``boundary='periodic'`` / ``'reflect'``), copied from the JAX
module as well.

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


def run_periodic(grid0: np.ndarray, spec: StencilSpec,
                 steps: int) -> np.ndarray:
    """Periodic-wrap ground truth over the padded layout: the interior
    evolves as out[p] = sum_o S[o] * in[(p+o) mod n] (np.roll); the halo
    cells of the result are zero (the engine's output guard ring is the
    zero donor ring -- only the interior is written).  The input halo is
    ignored (the wrap defines the neighbors)."""
    shape = grid0.shape
    it = interior_slices(spec, shape)
    g = np.asarray(grid0, np.float64)[it]
    S = spec.dense_coeffs()
    r = spec.radius
    for _ in range(steps):
        acc = np.zeros_like(g)
        for idx in np.argwhere(np.abs(S) > 0):
            off = tuple(int(i) - r for i in idx)
            acc += float(S[tuple(idx)]) * np.roll(
                g, tuple(-o for o in off), axis=tuple(range(g.ndim)))
        g = acc
    out = np.zeros(shape, np.float64)
    out[it] = g
    return out


def run_reflect(grid0: np.ndarray, spec: StencilSpec,
                steps: int) -> np.ndarray:
    """Reflect (symmetric / zero-flux) ground truth: each step pads the
    interior with np.pad(mode='symmetric') by the radius, correlates,
    and crops.  Result halo cells are zero (like run_periodic)."""
    shape = grid0.shape
    it = interior_slices(spec, shape)
    g = np.asarray(grid0, np.float64)[it]
    S = spec.dense_coeffs()
    r = spec.radius
    for _ in range(steps):
        gp = np.pad(g, r, mode="symmetric")
        acc = np.zeros_like(g)
        for idx in np.argwhere(np.abs(S) > 0):
            sl = tuple(slice(int(i), int(i) + s)
                       for i, s in zip(idx, g.shape))
            acc += float(S[tuple(idx)]) * gp[sl]
        g = acc
    out = np.zeros(shape, np.float64)
    out[it] = g
    return out


def random_padded(spec: StencilSpec, interior, seed: int = 0,
                  lo: int = 0, hi: int = 100) -> np.ndarray:
    """Random integer-valued padded grid, mirroring the reference's
    FILL_RANDOM (rand() % 100) over the whole padded buffer, halo
    included."""
    rng = np.random.default_rng(seed)
    shape = spec.padded_shape(interior)
    return rng.integers(lo, hi, size=shape).astype(np.float64)
