"""Coefficient factorization the stencil registry needs.

The port's copy of ``pivot_peel`` from ``lorastencil_tpu/models/factorize.py``
(box2d3r's terms come from it, ``models/shapes.py``).  The JAX module's other
factorizations (greedy and SVD peels, 3-D decomposition, tap fusion, banded
matrices) serve ``for_coeffs`` and the TPU's matrix unit; they arrive with the
ROADMAP items that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PeelResult:
    terms: Tuple[Tuple[np.ndarray, np.ndarray], ...]  # (u, v): u v^T terms
    residual: np.ndarray  # S - sum(u v^T)


def pivot_peel(
    S: np.ndarray,
    pivots: Optional[Sequence[Tuple[int, int]]] = None,
    tol: float = 1e-12,
) -> PeelResult:
    """Peel rank-1 terms off ``S`` by Gaussian elimination at given pivots.

    Each step subtracts ``R[:, pj] R[pi, :] / R[pi, pj]`` (the rank-1 cross
    through the pivot), which zeroes the pivot's entire row and column.  For
    the reference's box coefficients with pivots on the diagonal this
    reproduces its factorization exactly (outer ring -> inner), leaving a
    zero residual.  Pivots with |value| <= tol are skipped.

    Returns terms (u, v) with ``contribution = outer(u, v)`` where ``u``
    indexes axis 0 (rows) and ``v`` axis 1 (cols).
    """
    R = np.asarray(S, dtype=np.float64).copy()
    n = R.shape[0]
    if pivots is None:
        pivots = [(i, i) for i in range(n // 2 + 1)]
    terms = []
    for (pi, pj) in pivots:
        p = R[pi, pj]
        if abs(p) <= tol:
            continue
        u = R[:, pj].copy() / p
        v = R[pi, :].copy()
        R = R - np.outer(u, v)
        terms.append((u, v))
    return PeelResult(terms=tuple(terms), residual=R)
