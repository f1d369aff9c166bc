"""Internal 2-D grid layout on torch tensors.

Counterpart of ``lorastencil_tpu/ops/layout.py`` (``Layout2D`` and
``default_tile_2d``).  The user-facing state is the reference-padded array
(interior + halo, ``(m + 2*hm, n + 2*hn)``); internally it is re-embedded
into a buffer with a zero guard ring and an interior rounded up to whole
tiles:

    rows:  [ guard | interior rows (rounded up to TM) | guard ]
    cols:  [ guard | interior cols (rounded up to TN) | guard ]

The user halo sits in the innermost guard cells; the rest of the ring is
zero and stays zero, because the step kernels write whole interior tiles
only and the engine's output buffers start zeroed.  Round-up cells beyond
the true interior are written as zeros on every step.

The TPU layout's (8, 128) DMA alignment does not carry over: the guard
only has to cover the halo and the stencil's reach, and is rounded up to
four cells so that interior rows start on a 16-byte boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# The CUDA kernel's block tile (csrc/stencil2d.cu: kTileRows, kTileCols).
TILE_2D = (32, 128)
GUARD_ALIGN = 4  # cells: 16 bytes of float32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Layout2D:
    interior: Tuple[int, int]  # (m, n)
    halo: Tuple[int, int]
    tile: Tuple[int, int]  # (TM, TN): the round-up granule
    guard: Tuple[int, int]
    # zero row tiles below the round-up (the TPU skew kernel's spill
    # room; kept for contract parity, 0 for every port kernel)
    extra_row_tiles: int = 0

    @property
    def grid(self) -> Tuple[int, int]:
        m, n = self.interior
        return (_cdiv(m, self.tile[0]), _cdiv(n, self.tile[1]))

    @property
    def origin(self) -> Tuple[int, int]:
        """Internal coordinates of interior cell (0, 0)."""
        return self.guard

    @property
    def rounded(self) -> Tuple[int, int]:
        """Interior extent rounded up to whole tiles."""
        gi, gj = self.grid
        return (gi * self.tile[0], gj * self.tile[1])

    @property
    def shape(self) -> Tuple[int, int]:
        gi, gj = self.grid
        gr, gc = self.guard
        return (gr + (gi + self.extra_row_tiles) * self.tile[0] + gr,
                gc + gj * self.tile[1] + gc)

    def validate(self):
        if min(self.tile) < 1:
            raise ValueError(f"tile must be positive, got {self.tile}")
        if self.halo[0] > self.guard[0] or self.halo[1] > self.guard[1]:
            raise ValueError(
                f"halo {self.halo} must fit in the guard {self.guard}")

    def to_internal(self, padded, dtype=torch.float32, device=None):
        """Embed a user padded array (NumPy or torch) into a new internal
        buffer; the user halo goes into the guard ring."""
        m, n = self.interior
        hm, hn = self.halo
        src = torch.as_tensor(padded, dtype=dtype, device=device)
        want = (m + 2 * hm, n + 2 * hn)
        if tuple(src.shape) != want:
            raise ValueError(
                f"padded array has shape {tuple(src.shape)}, layout "
                f"expects {want}")
        buf = torch.zeros(self.shape, dtype=dtype, device=src.device)
        r0, c0 = self.origin
        buf[r0 - hm: r0 + m + hm, c0 - hn: c0 + n + hn] = src
        return buf

    def from_internal(self, buf):
        """The user padded array as a view of the internal buffer."""
        m, n = self.interior
        hm, hn = self.halo
        r0, c0 = self.origin
        return buf[r0 - hm: r0 + m + hm, c0 - hn: c0 + n + hn]


def default_tile_2d(m: int, n: int) -> Tuple[int, int]:
    """The port's tile: the CUDA kernel's block tile, whatever the grid
    size (the kernel masks its ragged edge itself, so the tile only
    decides how far the interior is rounded up)."""
    del m, n
    return TILE_2D


def guard_2d(halo: Tuple[int, int], reach: int) -> Tuple[int, int]:
    """Guard per axis: at least the user halo and the stencil's reach per
    pass (fused steps x radius), rounded up to ``GUARD_ALIGN`` cells."""
    return tuple(GUARD_ALIGN * _cdiv(max(h, reach, 1), GUARD_ALIGN)
                 for h in halo)
