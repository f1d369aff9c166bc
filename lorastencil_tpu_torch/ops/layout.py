"""Internal 1-D, 2-D and 3-D grid layouts on torch tensors.

Counterpart of ``lorastencil_tpu/ops/layout.py`` (``Layout1D``,
``Layout2D``, ``default_tile_2d``, ``Layout3D`` and ``default_tile_3d``;
``Layout1DLanes`` has no counterpart, see ``Layout1D``).  The
user-facing state is the reference-padded array (interior + halo,
``(m + 2*hm, n + 2*hn)``); internally it is re-embedded
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
four cells so that interior rows start on a 16-byte boundary in float32
and a 32-byte one in float64 (the row pitch is a multiple of four cells
too); the kernels' loads are of one cell, 4 or 8 bytes, so either dtype
keeps them aligned.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# The CUDA kernels' block tiles (csrc/stencil2d.cu: kTileRows, kTileCols;
# the largest in-plane tile of csrc/stencil3d.cu, ops/stencil3d.py;
# csrc/stencil1d.cu: kTile).
TILE_1D = 2048
TILE_2D = (32, 128)
TILE_3D = (32, 64)
GUARD_ALIGN = 4  # cells: 16 bytes of float32, 32 of float64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Layout1D:
    """The 1-D internal layout, one flat buffer for every 1-D kernel:

        [ guard | interior (rounded up to ``tile``) | guard ]

    Counterpart of the JAX ``Layout1D`` (rows of 128 lanes, origin
    ``guard_rows * 128``) and of its ``Layout1DLanes``, whose duplicated
    halo lanes exist because a TPU shift is a 128-lane roll.  On the card a
    shift is an address offset, so the port keeps no duplicated lanes; the
    guard (``guard_1d``) only has to cover the user halo and a pass's
    reach."""

    interior: int  # n
    halo: int
    tile: int  # the round-up granule (cells)
    guard: int

    @property
    def grid(self) -> Tuple[int]:
        return (_cdiv(self.interior, self.tile),)

    @property
    def origin(self) -> int:
        """Buffer index of interior cell 0."""
        return self.guard

    @property
    def rounded(self) -> int:
        """Interior extent rounded up to whole tiles."""
        return self.grid[0] * self.tile

    @property
    def shape(self) -> Tuple[int]:
        return (self.guard + self.rounded + self.guard,)

    def validate(self):
        if self.tile < 1:
            raise ValueError(f"tile must be positive, got {self.tile}")
        if self.halo > self.guard:
            raise ValueError(
                f"halo {self.halo} must fit in the guard {self.guard}")

    def to_internal(self, padded, dtype=torch.float32, device=None):
        """Embed a user padded array (NumPy or torch) into a new internal
        buffer; the user halo goes into the guard."""
        n, h = self.interior, self.halo
        src = torch.as_tensor(padded, dtype=dtype, device=device)
        if tuple(src.shape) != (n + 2 * h,):
            raise ValueError(
                f"padded array has shape {tuple(src.shape)}, layout "
                f"expects {(n + 2 * h,)}")
        buf = torch.zeros(self.shape, dtype=dtype, device=src.device)
        buf[self.origin - h: self.origin + n + h] = src
        return buf

    def from_internal(self, buf):
        """The user padded array as a view of the internal buffer."""
        n, h = self.interior, self.halo
        return buf[self.origin - h: self.origin + n + h]


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


@dataclasses.dataclass(frozen=True)
class Layout3D:
    """The 3-D internal layout: z planes are not rounded up, the plane is
    rounded up to whole (TM, TN) tiles as in ``Layout2D``:

        z:     [ zg | h interior planes | zg ]
        rows:  [ gr | interior rows (rounded up to TM) | gr ]
        cols:  [ gc | interior cols (rounded up to TN) | gc ]

    Counterpart of the JAX ``Layout3D`` (origin ``(zguard, 8, 128)``),
    with the port's own guard ``(zg, gr, gc)`` (``guard_3d``)."""

    interior: Tuple[int, int, int]  # (h, m, n)
    halo: Tuple[int, int, int]
    tile: Tuple[int, int]  # (TM, TN): the in-plane round-up granule
    guard: Tuple[int, int, int]

    @property
    def grid(self) -> Tuple[int, int]:
        _, m, n = self.interior
        return (_cdiv(m, self.tile[0]), _cdiv(n, self.tile[1]))

    @property
    def origin(self) -> Tuple[int, int, int]:
        """Internal coordinates of interior cell (0, 0, 0)."""
        return self.guard

    @property
    def rounded(self) -> Tuple[int, int, int]:
        """Interior extent with the plane rounded up to whole tiles."""
        gi, gj = self.grid
        return (self.interior[0], gi * self.tile[0], gj * self.tile[1])

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(e + 2 * g for e, g in zip(self.rounded, self.guard))

    def validate(self):
        if min(self.tile) < 1:
            raise ValueError(f"tile must be positive, got {self.tile}")
        if any(h > g for h, g in zip(self.halo, self.guard)):
            raise ValueError(
                f"halo {self.halo} must fit in the guard {self.guard}")

    def _box(self):
        return tuple(slice(o - h, o + e + h) for o, e, h in
                     zip(self.origin, self.interior, self.halo))

    def to_internal(self, padded, dtype=torch.float32, device=None):
        """Embed a user padded array (NumPy or torch) into a new internal
        buffer; the user halo goes into the guard ring."""
        src = torch.as_tensor(padded, dtype=dtype, device=device)
        want = tuple(e + 2 * h for e, h in zip(self.interior, self.halo))
        if tuple(src.shape) != want:
            raise ValueError(
                f"padded array has shape {tuple(src.shape)}, layout "
                f"expects {want}")
        buf = torch.zeros(self.shape, dtype=dtype, device=src.device)
        buf[self._box()] = src
        return buf

    def from_internal(self, buf):
        """The user padded array as a view of the internal buffer."""
        return buf[self._box()]


def default_tile_2d(m: int, n: int) -> Tuple[int, int]:
    """The port's tile: the CUDA kernel's block tile, whatever the grid
    size (the kernel masks its ragged edge itself, so the tile only
    decides how far the interior is rounded up)."""
    del m, n
    return TILE_2D


def guard_1d(halo: int, reach: int) -> int:
    """The 1-D guard: at least the user halo and the reach of one pass
    (fused steps x effective radius), rounded up to ``GUARD_ALIGN`` cells
    as in ``guard_2d``."""
    return GUARD_ALIGN * _cdiv(max(halo, reach, 1), GUARD_ALIGN)


def guard_2d(halo: Tuple[int, int], reach: int) -> Tuple[int, int]:
    """Guard per axis: at least the user halo and the stencil's reach per
    pass (fused steps x radius), rounded up to ``GUARD_ALIGN`` cells."""
    return tuple(GUARD_ALIGN * _cdiv(max(h, reach, 1), GUARD_ALIGN)
                 for h in halo)


def default_tile_3d(m: int, n: int) -> Tuple[int, int]:
    """The port's 3-D tile: the CUDA kernel's largest block tile,
    whatever the plane size (the kernel masks its ragged edge itself)."""
    del m, n
    return TILE_3D


def guard_3d(halo: Tuple[int, int, int],
             reach: int) -> Tuple[int, int, int]:
    """Guard per axis: at least the user halo and the reach of one pass
    (fused steps x radius); z planes as they are, the plane axes rounded
    up to ``GUARD_ALIGN`` cells as in ``guard_2d``."""
    return (max(halo[0], reach, 1),) + guard_2d(halo[1:], reach)


def check_bounds(bounds, interior, guard) -> Tuple[int, ...]:
    """A pass's ``bounds`` as flat ints ``(lo, hi)`` per axis, checked: the
    box ``[lo, hi)`` (interior coordinates) that the fused levels before
    the last keep, the interior and at most the guard beyond it (``lo <=
    0``, ``hi >= n``, ``-lo`` and ``hi - n`` within the guard).  None is
    the interior.  A 3-D pass also takes 4 values, the rows' and the
    columns' (the z box is then ``[0, h)``), as the JAX kernels do."""
    dims = tuple(interior)
    if bounds is None:
        return tuple(v for s in dims for v in (0, s))
    try:
        flat = tuple(int(v) for v in bounds)
    except (TypeError, ValueError, RuntimeError):
        raise ValueError(f"bounds must be ints, got {bounds!r}") from None
    if len(dims) == 3 and len(flat) == 4:
        flat = (0, dims[0]) + flat
    if len(flat) != 2 * len(dims):
        raise ValueError(
            f"bounds of a {len(dims)}-D pass take "
            f"{'4 or 6' if len(dims) == 3 else 2 * len(dims)} values, got "
            f"{len(flat)}")
    for a, (s, g) in enumerate(zip(dims, guard)):
        lo, hi = flat[2 * a], flat[2 * a + 1]
        if not (-g <= lo <= 0 and s <= hi <= s + g):
            raise ValueError(
                f"bounds [{lo}, {hi}) on axis {a} must hold the interior "
                f"[0, {s}) and reach at most the guard {g} beyond it")
    return flat
