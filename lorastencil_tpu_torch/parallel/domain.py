"""Domain decomposition of the 1-D, 2-D and 3-D engines over a mesh of shards.

Counterpart of ``lorastencil_tpu/parallel/domain.py``: ``ShardedConfig``,
``make_mesh``, ``ShardedStencil1D``, ``ShardedStencil2D``,
``ShardedStencil3D``, their fp64-grade twins ``ShardedStencilDF64_1D``,
``ShardedStencilDF64`` and ``ShardedStencilDF64_3D``, ``sharded_engine`` and
``sharded_engine_for_coeffs``, with the JAX engines' fields, checks and
messages.

The global interior is cut into a mesh of blocks -- (dx,) in 1-D, (dx, dy)
in 2-D, (dx, dy) or (dz, dx, dy) in 3-D -- and each shard owns one block in
a buffer of the port's internal layout (``ops/layout.py``), whose guard
ring doubles as the halo-receive buffer, ``depth`` = k * radius cells deep
for a pass of k fused steps.  A pass exchanges the strips along the block
edges axis by axis -- in 3-D z first, then rows, then columns -- each
phase's strips spanning what the phases before it received, so that
corners (and in 3-D the 8 corner octants) travel; and it runs the kernel
of ``ops/stencil{1,2,3}d.py`` on each shard with the shard's ``bounds``:
its box in the global interior, in local coordinates, which keeps an inner
shard's ring alive through the fused levels and zeroes the padding of the
last shard of an axis the mesh does not divide.

The JAX engine runs one ``shard_map`` program whose collective is
``ppermute``; the port runs from the host, eagerly.  ``Mesh`` maps each
mesh coordinate to a (rank, device) pair, and the exchange moves a strip

  * between two shards of one process, by a copy onto the destination's
    device (``Tensor.copy_``, on its current stream; in the overlapped step
    a side stream).  Shards may share a device: that is how one card or the
    CPU holds a whole mesh (``devices=["cuda:0"] * 4``, ``["cpu"] * 8``);
  * between processes, by ``torch.distributed.batch_isend_irecv`` on the
    tensors' own device, as raw bytes: NCCL for CUDA, gloo for the CPU
    (``parallel/multihost.py`` starts the group).  A CUDA state in a group
    without NCCL raises: nothing is staged through the host.

A shard with no neighbour on a side receives zeros (the Dirichlet-0 edge),
``periodic`` closes each axis into a ring, and ``reflect`` mirrors the
shard's own edge strip at the global edge, as the JAX engine's ``_shift``
and ``_exchange``
do.  The local steps are the JAX engine's three, chosen
by the same rule (``_step_fn``): the sequential step (exchange into the
input, then one kernel call; ``overlap=False``), the ring-out step (one
kernel call, then the output's edge strips exchanged into its own ring: the
default where the tile grid cannot split, and always on a z-sharded 3-D
mesh) and the overlapped step (the boundary windows first, ``region``
launches: the head and tail tiles in 1-D, the four frame windows in 2-D
and 3-D; the exchange of their edge strips on a side stream while the inner
window runs on the compute stream; then the received ring written into the
output).  On the card a region launch covers its window only (the entries'
``in_window`` in ``csrc/stencil{1,2,3}d.cu``).

The port's own choices (ROADMAP section C): its default tile is the
kernel's block tile, (32, 128) in 2-D and (32, 64) in 3-D
(``_pad_local_block``), so that where the JAX engine pads a local block to
its TPU tile the port may split it into another tile grid, and
``_can_overlap`` may then differ for the same configuration -- the values
do not.  In 1-D the port keeps its flat layout (``Layout1D``: tiles of
``TILE_1D`` cells, no duplicated lanes), so ``lanes``, set by the JAX rule,
only picks the narrow kernel against the wide one, and ``_overlap_reason``
tests the port's tile; an exchange depth beyond a 1-D local block raises
(the JAX engine would exchange stale ring cells).  A pass deeper than one
launch of the 2-D or 3-D kernel (``launch_depths``) runs as passes of one
launch each with an exchange between them, because a launch past the
first would read a ring its neighbours have moved on from, and takes the
ring-out step (``_overlap_reason``), as the JAX engine does where it
cannot split.
``precision`` is a label, as in the single-device engine; ``interpret``
has no counterpart and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.shapes import StencilSpec, get_shape
from ..ops import stencil1d, stencil2d, stencil3d
from ..ops.layout import (TILE_1D, TILE_2D, TILE_3D, Layout1D, Layout2D,
                          Layout3D, as_state, guard_1d, guard_2d)

# the JAX layout's (sublane, lane) alignment: a local block is rounded up to
# it before the tile, so that with the same explicit tile both engines cut
# the same blocks (the JAX engine's ``_pad_local_block``)
SUBLANE, LANE = 8, 128
STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "df64": torch.float64}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_reflect_fused(spec: StencilSpec, config) -> None:
    if config.boundary != "reflect" or max(1, config.fused_steps) <= 1:
        return
    if not spec.axis_symmetric():
        raise ValueError(
            "sharded reflect boundaries with fused_steps > 1 need "
            "per-axis symmetric coefficients (mirror symmetry must "
            "commute with the stencil); use fused_steps=1")


def _check_tails(boundary: str, tails, depth: int, mesh_shape) -> None:
    """Ghost modes wrap/mirror at the TRUE global edge, which for the
    last shard along an axis sits ``tail`` cells into its (padded)
    block; the ghost machinery needs ``depth`` real cells on its inside
    (and the far-side wrap source reads the same strip)."""
    if boundary == "dirichlet0":
        return
    for t in tails:
        if t < depth:
            raise ValueError(
                f"boundary={boundary!r}: the last device's true block "
                f"tail ({t} cells) is smaller than the exchange depth "
                f"{depth} on mesh {tuple(mesh_shape)}; use fewer "
                f"devices or lower fused_steps")


def divisor_tile_2d(m: int, default=TILE_2D) -> Tuple[int, int]:
    """The largest tile of the port's shape -- rows a multiple of 8 up to
    the kernel's (``default``'s rows: 32), its columns (128 in 2-D, 64 in
    3-D) -- whose rows DIVIDE m (a block's columns are a multiple of 128
    already): the JAX rule (``lorastencil_tpu/ops/layout.py``
    ``divisor_tile_2d``) under the port's tile."""
    tm = next(c for c in range(default[0], 0, -SUBLANE) if m % c == 0)
    return (tm, default[1])


def _pad_local_block(lm: int, ln: int, tile, explicit_tile: bool,
                     default=TILE_2D):
    """The JAX engine's local-block padding under the port's tile, shared
    by the 2-D and 3-D engines: round the block up to (8, 128), then to a
    tile multiple (no tile round-up region, so the exchanged guard ring
    never aliases interior tiles; padded fake cells are bounds-masked to
    zero).  When padding to the default tile would waste > ~8% of the
    block, a zero-waste divisor tile wins instead.  Returns (lm, ln,
    tile)."""
    bm = SUBLANE * _cdiv(lm, SUBLANE)
    bn = LANE * _cdiv(ln, LANE)
    if not explicit_tile and (bm % tile[0] or bn % tile[1]):
        pad = (tile[0] * _cdiv(bm, tile[0])) * (tile[1] * _cdiv(bn, tile[1]))
        if pad > 1.08 * bm * bn:
            tile = divisor_tile_2d(bm, default)
    return (tile[0] * _cdiv(bm, tile[0]), tile[1] * _cdiv(bn, tile[1]),
            tuple(tile))


def _device(device) -> torch.device:
    """A shard's device, checked as the engine checks one; a bare "cuda"
    is the current device, so that shards on one card compare equal."""
    from ..engine import _device as engine_device

    dev = engine_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of shards, the port's ``jax.sharding.Mesh``: for each
    coordinate, in row-major order, the rank of the process that holds it
    and its device; ``rank`` is this process's."""

    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...]
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self):
        return list(itertools.product(*(range(s) for s in self.shape)))

    def index(self, coord) -> int:
        return int(np.ravel_multi_index(coord, self.shape))

    def device(self, coord) -> torch.device:
        return self.devices[self.index(coord)]

    def rank_of(self, coord) -> int:
        return self.ranks[self.index(coord)]

    def local(self):
        """The coordinates this process holds."""
        return [c for c in self.coords() if self.rank_of(c) == self.rank]

    @property
    def spans_processes(self) -> bool:
        return len(set(self.ranks)) > 1


def make_mesh(shape: Tuple[int, ...], devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (one per shard, row-major; a
    device may be named for several shards, e.g. ``["cuda:0"] * 4`` or
    ``["cpu"] * 8``), all held by this process.  By default one visible
    CUDA device per shard."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError(
                f"need {n} devices, have 0: CUDA is not available; pass "
                f"devices=['cpu'] * {n} to shard on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    rank = _rank()
    return Mesh(shape, tuple(_device(d) for d in devices[:n]), (rank,) * n,
                rank)


def _send_bytes(t):
    """``t``'s bytes as a uint8 view (contiguous first): both NCCL and gloo
    move uint8, whatever the state's dtype."""
    return t.contiguous().view(torch.uint8)


def _p2p(ops) -> None:
    """Post the point-to-point operations of one exchange phase and wait
    for them.  A CUDA tensor needs an NCCL group, a CPU one gloo."""
    backend = str(dist.get_backend())
    for op in ops:
        if op.tensor.is_cuda and "nccl" not in backend:
            raise RuntimeError(
                f"a CUDA state cannot ride a {backend!r} process group: "
                f"start the group for the card (multihost.initialize(..., "
                f"device='cuda'), NCCL); the exchange does not stage strips "
                f"through the host")
        if not op.tensor.is_cuda and "gloo" not in backend:
            raise RuntimeError(
                f"a CPU state needs a gloo process group, not {backend!r}")
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def shift(mesh: Mesh, strips, axis: int, fwd: bool, wrap: bool = False):
    """The neighbour permutation along a mesh axis (the JAX engine's
    ``_shift``): ``strips`` holds a tensor per local coordinate; returns,
    per local coordinate, a new tensor holding the strip of the shard
    before it on ``axis`` (``fwd``) or after it.  Without ``wrap`` a shard
    with no such neighbour receives zeros; ``wrap`` closes the ring.  Every
    process of a mesh that spans processes calls it with the same
    arguments: each posts its sends and receives in one global order (by
    destination), so that both ends of a pair of ranks agree."""
    n = mesh.shape[axis]

    def source(coord):
        s = coord[axis] + (-1 if fwd else 1)
        if not 0 <= s < n:
            if not wrap:
                return None
            s %= n
        return coord[:axis] + (s,) + coord[axis + 1:]

    out, ops = {}, []
    for dst in mesh.coords():
        src = source(dst)
        dst_here = mesh.rank_of(dst) == mesh.rank
        src_here = src is not None and mesh.rank_of(src) == mesh.rank
        if src is None:
            if dst_here:
                out[dst] = torch.zeros_like(strips[dst])
        elif dst_here and src_here:
            out[dst] = torch.empty_like(strips[src], device=mesh.device(dst))
            out[dst].copy_(strips[src], non_blocking=True)
        elif src_here:
            ops.append(dist.P2POp(dist.isend, _send_bytes(strips[src]),
                                  mesh.rank_of(dst), tag=mesh.index(dst)))
        elif dst_here:
            out[dst] = torch.empty_like(strips[dst],
                                        memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, out[dst].view(torch.uint8),
                                  mesh.rank_of(src), tag=mesh.index(dst)))
    if ops:
        _p2p(ops)
    return out


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    """The JAX engine's ``ShardedConfig``, field for field: the mesh shape
    ((dx,) for 1-D, (dx, dy) for 2-D, (dx, dy) or (dz, dx, dy) for 3-D),
    ``tile`` (the port's round-up granule in 2-D and 3-D; the kernel's
    block tile when None, see ``_pad_local_block``; 1-D keeps
    ``TILE_1D``), the state ``dtype``
    ('float32', 'bfloat16': half the bytes moved and exchanged, or 'df64':
    the fp64-grade tier, a float64 state here), ``precision`` (a label),
    ``algorithm`` (resolved as the single-device engine resolves it; every
    exact name runs the one kernel), ``fused_steps`` per exchange,
    ``overlap`` (the overlapped step where the local tile grid splits),
    ``boundary`` and ``residue_mxu`` (a label).  ``interpret`` has no
    counterpart: the CPU runs the kernels' plain twins."""

    mesh_shape: Tuple[int, ...]
    tile: Optional[Tuple[int, int]] = None
    dtype: str = "float32"
    precision: str = "highest"
    interpret: Optional[bool] = None
    algorithm: str = "auto"
    fused_steps: int = 1
    overlap: bool = True
    boundary: str = "dirichlet0"
    residue_mxu: str = "auto"

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16", "df64"):
            raise ValueError(
                f"sharded dtype must be 'float32', 'bfloat16' or "
                f"'df64', got {self.dtype!r}")
        if self.boundary not in ("dirichlet0", "periodic", "reflect"):
            raise ValueError(
                f"sharded boundary must be 'dirichlet0', 'periodic' or "
                f"'reflect', got {self.boundary!r}")
        if self.precision not in ("highest", "default"):
            raise ValueError(
                f"precision must be 'highest' or 'default', got "
                f"{self.precision!r} (a typo would silently degrade "
                f"algorithm='mxu' to ~1e-3/step)")
        if self.interpret:
            raise ValueError(
                "the port has no interpret mode: devices=['cpu'] * n runs "
                "the kernels' plain PyTorch twins")


def _split_reason(eng):
    """Why ``eng``'s pass cannot keep a region: it takes more than one
    launch (``_launch_depths``); None when it takes one."""
    depths = eng._launch_depths(eng.fused_steps)
    if len(depths) > 1:
        return (f"a pass of {eng.fused_steps} fused steps takes "
                f"{len(depths)} launches; a region needs one")
    return None


class _Axis(NamedTuple):
    """One axis of a shard's buffer, as the exchange and ``to_sharded`` /
    ``from_sharded`` see it."""
    dim: int        # the buffer's axis, from the last: -1, -2 or -3
    size: int       # the global interior along it
    halo: int       # the user halo
    local: int      # a shard's block
    tail: int       # the true edge within the last shard's block
    ring: int       # the ring a pass exchanges (uncut: the user halo)
    origin: int     # the block's first cell in the buffer
    mesh_axis: Optional[int]  # the mesh axis that cuts it; None: uncut


def _at(dim: int, lo: int, hi: int):
    """The index of cells ``[lo, hi)`` along axis ``dim`` (from the last)
    and every cell of the other axes."""
    return (Ellipsis, slice(lo, hi)) + (slice(None),) * (-1 - dim)


def _ghost_fill(gpad, axes, wrap: bool) -> None:
    """Fill the ghost rings of ``gpad``, the block-padded global array with
    a ring of ``axes[n].ring`` cells before and after each axis's interior,
    by wrap or mirror, one cut axis after another: an axis's rings span the
    rings filled before it and the interior of the axes after it, so that
    the corners compose (``np.pad``'s wrap and symmetric modes)."""
    for n, a in enumerate(axes):
        if a.mesh_axis is None:
            continue
        d, s = a.ring, a.size

        def at(lo, hi):
            return tuple(slice(lo, hi) if m == n else
                         slice(b.ring, b.ring + b.size) if m > n else
                         slice(None) for m, b in enumerate(axes))
        if wrap:
            gpad[at(0, d)] = gpad[at(s, s + d)]
            gpad[at(d + s, 2 * d + s)] = gpad[at(d, 2 * d)]
        else:
            gpad[at(0, d)] = gpad[at(d, 2 * d)].flip(n)
            gpad[at(d + s, 2 * d + s)] = gpad[at(s, s + d)].flip(n)


class _ShardedEngine:
    """What the sharded engines of every dimension share: the neighbour
    shift along a mesh axis, the exchange one cut axis after another, the
    side streams of the overlapped step, the three local steps and the JAX
    engine's choice among them, passes split into launches, the run loop
    and the user API (``to_sharded`` / ``from_sharded``).  A subclass gives
    the layout, its axes (``_shard_axes``), the shard's box (``_bounds``),
    ``_overlap_reason`` and the kernel call (``_kernel``)."""

    def _shift(self, strips, axis: int, fwd: bool):
        return shift(self.mesh, strips, axis, fwd,
                     self.config.boundary == "periodic")

    def _can_overlap(self) -> bool:
        return self.config.overlap and self._overlap_reason() is None

    @contextlib.contextmanager
    def _on_side_streams(self):
        """Queue the block's work on a side stream of each CUDA device of
        the local shards, after what is queued so far on its current
        stream; yields the side streams, which the caller joins."""
        devices = sorted({self.mesh.device(c) for c in self.local
                          if self.mesh.device(c).type == "cuda"},
                         key=lambda d: d.index)
        streams = []
        with contextlib.ExitStack() as stack:
            for d in devices:
                if d not in self._side:
                    self._side[d] = torch.cuda.Stream(device=d)
                side = self._side[d]
                side.wait_stream(torch.cuda.current_stream(d))
                stack.enter_context(torch.cuda.stream(side))
                streams.append(side)
            yield streams

    @staticmethod
    def _join(streams, parts):
        """The current streams wait for the side ``streams``; the strips
        made there (``parts``, a tuple of tensors, or of tuples, per shard)
        are marked as used on the current stream."""
        for side in streams:
            torch.cuda.current_stream(side.device).wait_stream(side)

        def mark(t):
            if isinstance(t, torch.Tensor):
                if t.is_cuda:  # made on a side stream, read on the current
                    t.record_stream(torch.cuda.current_stream(t.device))
            elif t is not None:
                for u in t:
                    mark(u)
        mark(list(parts.values()))

    # -- halo exchange ----------------------------------------------------
    def _cut_axes(self):
        """The buffer's axes that the mesh cuts, in the exchange's order:
        z, rows, columns."""
        return [a for a in self._shard_axes() if a.mesh_axis is not None]

    def _from_neighbour(self, a: _Axis, c, high: bool) -> bool:
        """Whether shard ``c``'s low (or ``high``) ring along ``a`` comes
        from a neighbour: always under periodic, else off the global
        edge."""
        if self.config.boundary == "periodic":
            return True
        i = c[a.mesh_axis]
        return i < self.mesh.shape[a.mesh_axis] - 1 if high else i > 0

    def _rings(self, a: _Axis, c):
        """Shard ``c``'s (low ring, low edge, high ring, high edge) along
        ``a`` as ``(start, end)``: an edge is the strip its neighbour
        receives and reflect mirrors; the high ring starts at the true tail
        on the last shard of the axis, at the block edge otherwise."""
        o, d = a.origin, a.ring
        last = c[a.mesh_axis] == self.mesh.shape[a.mesh_axis] - 1
        hs = o + (a.tail if last else a.local)
        return (o - d, o), (o, o + d), (hs, hs + d), (hs - d, hs)

    def _refresh(self, bufs):
        """The ring cells a shard refreshes on its own before a pass: none
        (the 3-D engine's z guard of an unsharded z)."""
        return bufs

    def _exchange(self, bufs):
        """Fill each local buffer's ring, in place, to ``ring`` cells along
        each cut axis -- deep enough for a whole fused pass -- one axis
        after another, each phase's strips spanning the cells the phases
        before it filled, so that the corners travel.  Under dirichlet0 a
        shard on the global edge keeps its ring there (the user halo before
        step 1, zero after); periodic takes the wrapped strip; reflect
        mirrors the shard's own edge."""
        self._refresh(bufs)
        refl = self.config.boundary == "reflect"
        for a in self._cut_axes():
            rings = {c: self._rings(a, c) for c in bufs}
            lo = {c: b[_at(a.dim, *rings[c][1])] for c, b in bufs.items()}
            hi = {c: b[_at(a.dim, *rings[c][3])] for c, b in bufs.items()}
            got = (self._shift(hi, a.mesh_axis, True),
                   self._shift(lo, a.mesh_axis, False))
            for c, b in bufs.items():
                for high, edge in ((False, lo), (True, hi)):
                    ring = _at(a.dim, *rings[c][2 * high])
                    if self._from_neighbour(a, c, high):
                        b[ring] = got[high][c]
                    elif refl:
                        b[ring] = edge[c].flip(a.dim)
        return bufs

    def _exchange_strips(self, bufs):
        """The exchange WITHOUT writing into ``bufs``: per local shard, per
        cut axis, the received (low, high) ring strips.  A phase's strips
        hold the rings of the phases before it as the output will hold them
        (received; mirrored under reflect, zero under dirichlet0 at a
        global edge), so that the corners travel as in the sequential
        exchange."""
        refl = self.config.boundary == "reflect"
        done = []  # (axis, rings, low edges, high edges, received) a phase

        def strip(c, a, span):
            s = bufs[c][_at(a.dim, *span)]
            if done:
                s = s.clone()
            for q, rings, lo, hi, got in done:
                for high, edge in ((False, lo), (True, hi)):
                    part = (got[high][c] if self._from_neighbour(q, c, high)
                            else edge[c].flip(q.dim) if refl else None)
                    s[_at(q.dim, *rings[c][2 * high])] = (
                        0 if part is None else
                        part.narrow(a.dim, span[0], span[1] - span[0]))
            return s

        for a in self._cut_axes():
            rings = {c: self._rings(a, c) for c in bufs}
            lo = {c: strip(c, a, rings[c][1]) for c in bufs}
            hi = {c: strip(c, a, rings[c][3]) for c in bufs}
            done.append((a, rings, lo, hi,
                         (self._shift(hi, a.mesh_axis, True),
                          self._shift(lo, a.mesh_axis, False))))
        return {c: tuple((got[0][c], got[1][c]) for *_, got in done)
                for c in bufs}

    def _write_ring(self, bufs, parts):
        """Write the received strips (``_exchange_strips``) into each local
        ring, one cut axis after another; at a global edge dirichlet0
        writes zeros and reflect mirrors the buffer's edge as the axes
        before it left it, so that reflect corners compose as ``np.pad``'s
        symmetric mode."""
        refl = self.config.boundary == "reflect"
        axes = self._cut_axes()
        for c, b in bufs.items():
            for a, got in zip(axes, parts[c]):
                rings = self._rings(a, c)
                for high in (False, True):
                    ring = _at(a.dim, *rings[2 * high])
                    b[ring] = (got[high] if self._from_neighbour(a, c, high)
                               else b[_at(a.dim, *rings[2 * high + 1])]
                               .flip(a.dim) if refl else 0)
        return bufs

    def exchange_bytes(self) -> int:
        """The bytes an inner shard sends a pass: two strips along each cut
        axis, ``ring`` deep and over the buffer's full extent in the other
        axes, in the state's dtype."""
        shape = self.layout.shape
        cells = sum(2 * a.ring * math.prod(shape) // shape[a.dim]
                    for a in self._cut_axes())
        return cells * self.dtype.itemsize

    def _launch_depths(self, k: int):
        """The depths of the launches of a pass of k steps; one launch."""
        return [k]

    def _pass(self, step_fn):
        """``step_fn`` for ``ping_pong_loop``: a pass deeper than one launch
        of the kernel (``_launch_depths``) runs as passes of one launch
        each, every one with its exchange, into a spare set of buffers by
        turns."""
        def run(cur, donor, k):
            depths = self._launch_depths(k)
            src, spare = cur, None
            for i, depth in enumerate(depths):
                if i == 1:
                    spare = self._zeros(donor)
                src = step_fn(src, spare if i % 2 else donor, depth)
            return src
        return run

    @staticmethod
    def _zeros(state):
        return {c: torch.zeros_like(b) for c, b in state.items()}

    # -- per-shard steps ----------------------------------------------------
    def _windows(self):
        """The overlapped step's boundary windows and its inner window, in
        the layout's tiles: the head and tail tiles in 1-D, the four frame
        windows in 2-D and 3-D."""
        grid = self.layout.grid
        if len(grid) == 1:
            (g,) = grid
            return ((0, 1), (g - 1, g)), (1, g - 1)
        gi, gj = grid
        return ((((0, 1), (0, gj)), ((gi - 1, gi), (0, gj)),
                 ((1, gi - 1), (0, 1)), ((1, gi - 1), (gj - 1, gj))),
                ((1, gi - 1), (1, gj - 1)))

    def _local_step(self, cur, donor, fused_k):
        """Exchange into the input, then one kernel call per shard."""
        self._exchange(cur)
        return {c: self._kernel(cur[c], donor[c], fused_k, c) for c in cur}

    def _local_step_ringout(self, cur, donor, fused_k):
        """One kernel call per shard from ``cur`` (whose ring already holds
        this pass's neighbour data), then the output's edge strips
        exchanged and written into the output's own ring, ready for the
        next pass: the overlapped step's dataflow without the split."""
        self._refresh(cur)
        out = {c: self._kernel(cur[c], donor[c], fused_k, c) for c in cur}
        return self._write_ring(out, self._exchange_strips(out))

    def _local_step_overlap(self, cur, donor, fused_k):
        """One pass with the exchange overlapped with inner compute: each
        shard's boundary windows first (region launches), then the
        exchange of their edge strips on a side stream of each card while
        the inner window runs on the compute stream, then the received
        ring written into the output for the next pass."""
        self._refresh(cur)
        frame, inner = self._windows()
        for c in cur:
            for region in frame:
                self._kernel(cur[c], donor[c], fused_k, c, region)
        with self._on_side_streams() as streams:
            parts = self._exchange_strips(donor)
        for c in cur:
            self._kernel(cur[c], donor[c], fused_k, c, inner)
        self._join(streams, parts)
        return self._write_ring(donor, parts)

    def _step_fn(self):
        """The JAX engine's choice of local step."""
        if self._can_overlap() and self.mesh.size > 1:
            return self._local_step_overlap
        if self.config.overlap:
            return self._local_step_ringout
        return self._local_step

    def _run(self, state, steps: int):
        """``steps`` timesteps on a buffer per local shard (``to_sharded``'s
        dict); returns the new buffers."""
        from ..engine import ping_pong_loop

        return ping_pong_loop(self._pass(self._step_fn()), state, steps,
                              self.fused_steps, zeros=self._zeros)

    def _home(self) -> torch.device:
        """The device of the global arrays: the first local shard's."""
        return self.mesh.device(self.local[0]) if self.local else \
            torch.device("cpu")

    def _gather(self, out, blocks):
        """``out``, a global array that holds this process's blocks, whole
        on every process of a mesh that spans processes (an all-gather of
        each rank's blocks); ``blocks(coords)`` yields (coordinate, global
        box, local box) of those coordinates' blocks."""
        if self.mesh.spans_processes:
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size())]
            dist.all_gather([p.view(torch.uint8) for p in parts],
                            out.view(torch.uint8))
            for c, box, _ in blocks(self.mesh.coords()):
                out[box] = parts[self.mesh.rank_of(c)][box]
        return out

    # -- user API -----------------------------------------------------------
    def _block(self, a: _Axis, c) -> int:
        """Shard ``c``'s block index along ``a`` (0 on an uncut axis)."""
        return 0 if a.mesh_axis is None else c[a.mesh_axis]

    def to_sharded(self, padded):
        """User global padded array -> {coordinate: internal buffer} of the
        local shards, in the state's dtype on each shard's device (a float64
        source rounds once to bfloat16, ``as_state``).

        Each buffer gets its block plus a ring, ``ring`` deep along each
        axis, taken from the global array (neighbour interiors inside the
        grid, the user halo at the boundary, the wrapped or mirrored edge
        under a ghost boundary, zeros beyond): pass 1 then needs no leading
        exchange.  An uncut axis embeds the user halo."""
        axes = self._shard_axes()
        src = torch.as_tensor(padded).to(self._home())
        want = tuple(a.size + 2 * a.halo for a in axes)
        if tuple(src.shape) != want:
            raise ValueError(
                f"padded array has shape {tuple(src.shape)}, the engine "
                f"expects {want}")
        # the block-padded global extent; fake cells beyond the true
        # interior stay zero
        gpad = src.new_zeros(tuple(
            (1 if a.mesh_axis is None else self.mesh.shape[a.mesh_axis])
            * a.local + 2 * a.ring for a in axes))
        gpad[tuple(slice(a.ring - a.halo, a.ring + a.size + a.halo)
                   for a in axes)] = src
        if self.config.boundary != "dirichlet0":
            _ghost_fill(gpad, axes, self.config.boundary == "periodic")
        out = {}
        for c in self.local:
            dev = self.mesh.device(c)
            buf = torch.zeros(self.layout.shape, dtype=self.dtype,
                              device=dev)
            blocks = [self._block(a, c) * a.local for a in axes]
            buf[tuple(slice(a.origin - a.ring, a.origin + a.local + a.ring)
                      for a in axes)] = as_state(
                gpad[tuple(slice(i, i + a.local + 2 * a.ring)
                           for a, i in zip(axes, blocks))], self.dtype, dev)
            out[c] = buf
        return out

    def from_sharded(self, state):
        """{coordinate: local buffer} -> the user global padded array, on
        the first local shard's device; whole on every process of a mesh
        that spans processes (an all-gather of each rank's blocks).  A cut
        axis gives its interior only (the halo is zero after a step); an
        uncut one keeps its guard cells (zero after a step, the user halo
        at steps == 0), as the JAX engine's."""
        axes = self._shard_axes()
        out = torch.zeros(tuple(a.size + 2 * a.halo for a in axes),
                          dtype=self.dtype, device=self._home())

        def blocks(coords):
            for c in coords:
                glob, loc = [], []
                for a in axes:
                    if a.mesh_axis is None:
                        glob.append(slice(0, a.size + 2 * a.halo))
                        loc.append(slice(a.origin - a.halo,
                                         a.origin + a.local + a.halo))
                        continue
                    i = c[a.mesh_axis] * a.local
                    take = min(a.local, a.size - i)  # the padded tail
                    if take <= 0:
                        break
                    glob.append(slice(a.halo + i, a.halo + i + take))
                    loc.append(slice(a.origin, a.origin + take))
                else:
                    yield c, tuple(glob), tuple(loc)

        for c, box, local in blocks(self.local):
            out[box] = state[c][local]
        return self._gather(out, blocks)

    def run(self, padded, steps: int):
        """Reference-semantics run of the global padded array: a new
        tensor of the state's dtype (float64 for df64)."""
        return self.from_sharded(self._run(self.to_sharded(padded), steps))

    def run_checksum(self, padded, steps: int):
        """Like ``run`` but returns only the sum of the final state, every
        shard's buffer, as a 0-d float64 tensor (summed over the processes
        of a mesh that spans them)."""
        state = self._run(self.to_sharded(padded), steps)
        home = self._home()
        total = torch.zeros((), dtype=torch.float64, device=home)
        for b in state.values():
            total += b.sum(dtype=torch.float64).to(home)
        if self.mesh.spans_processes:
            dist.all_reduce(total)
        return total


class ShardedStencil2D(_ShardedEngine):
    """Domain-decomposed 2-D stencil over a mesh of shards: ``run(padded,
    steps)`` takes the global padded array (NumPy or torch; every process
    of a mesh that spans processes passes the same one) and returns the
    global result on the first local shard's device, ``run_checksum`` the
    sum of the final state as a 0-d float64 tensor; ``to_sharded`` /
    ``from_sharded`` convert between the global padded array and a buffer
    per local shard."""

    def __init__(self, spec: StencilSpec, interior: Tuple[int, int],
                 config: ShardedConfig, mesh: Optional[Mesh] = None,
                 devices=None):
        from ..engine import _not_ported, resolve_algorithm, \
            residue_mxu_policy

        if spec.ndim != 2:
            raise ValueError(f"{spec.name} is {spec.ndim}-D; "
                             f"{type(self).__name__} takes a 2-D spec")
        if config.dtype == "df64" and type(self) is ShardedStencil2D:
            raise ValueError(
                "dtype='df64' pair state needs ShardedStencilDF64 "
                "(sharded_engine routes there)")
        if len(config.mesh_shape) != 2:
            raise ValueError(f"a 2-D mesh is (dx, dy), got "
                             f"{tuple(config.mesh_shape)}")
        self.spec = spec
        self.config = config
        _check_reflect_fused(spec, config)
        gm, gn = (int(s) for s in interior)
        dx, dy = (int(s) for s in config.mesh_shape)
        self.interior = (gm, gn)
        self.mesh = mesh if mesh is not None else make_mesh((dx, dy), devices)
        if self.mesh.shape != (dx, dy):
            raise ValueError(f"mesh {self.mesh.shape} is not the config's "
                             f"{(dx, dy)}")
        self.dtype = self._state_dtype()
        self.algorithm = resolve_algorithm(spec, config.algorithm,
                                           config.dtype)
        if self.algorithm in stencil2d.UNPORTED_ALGORITHMS:
            raise _not_ported(f"algorithm {self.algorithm!r}", "B13")
        names = stencil2d.ALGORITHMS + (
            stencil2d.DF64_ALGORITHMS if self.dtype == torch.float64 else ())
        if self.algorithm not in names:
            raise ValueError(f"algorithm {self.algorithm!r} has no 2-D "
                             f"path; the port runs {names}")
        self.residue_mxu = residue_mxu_policy(config.residue_mxu,
                                              config.dtype, self.algorithm)
        k = max(1, config.fused_steps)
        self.fused_steps = k
        lm, ln = _cdiv(gm, dx), _cdiv(gn, dy)
        tile = config.tile if config.tile is not None else TILE_2D
        lm, ln, tile = _pad_local_block(lm, ln, tuple(int(t) for t in tile),
                                        config.tile is not None)
        self.local_interior = (lm, ln)
        # exchange depth per pass: k*radius cells feed the fused substeps
        self.depth = max(max(spec.halo), k * spec.radius)
        # the true global edge within the LAST shard's block along each
        # axis (the block size when it divides); dirichlet0 needs no ghost
        # source at the global edge, so it keeps the block edge
        if config.boundary == "dirichlet0":
            self.tails = (lm, ln)
        else:
            self.tails = (gm - (dx - 1) * lm, gn - (dy - 1) * ln)
        _check_tails(config.boundary, self.tails, self.depth, (dx, dy))
        if self.depth > LANE:
            raise ValueError(
                f"exchange depth {self.depth} exceeds the {LANE}-column "
                f"guard the JAX layout allows; lower fused_steps")
        if self.depth > min(lm, ln):
            raise ValueError(
                f"exchange depth {self.depth} exceeds the local block "
                f"{(lm, ln)}; use fewer devices or lower fused_steps")
        self.layout = Layout2D(interior=self.local_interior, halo=spec.halo,
                               tile=tile, guard=guard_2d(spec.halo,
                                                         self.depth))
        self.layout.validate()
        self.precision = config.precision
        self.local = self.mesh.local()
        self._side = {}  # a side stream per CUDA device (overlapped step)

    def _state_dtype(self):
        return STATE_DTYPES[self.config.dtype]

    def _kernel_algorithm(self) -> str:
        return self.algorithm

    # -- halo exchange ----------------------------------------------------
    def _shard_axes(self):
        (hm, hn), (gm, gn) = self.spec.halo, self.interior
        (lm, ln), (tm, tn) = self.local_interior, self.tails
        r0, c0 = self.layout.origin
        return (_Axis(-2, gm, hm, lm, tm, self.depth, r0, 0),
                _Axis(-1, gn, hn, ln, tn, self.depth, c0, 1))

    def _bounds(self, coord):
        """The shard's box in the global interior, in local coordinates:
        inner shards must not mask ring intermediates that hold exchanged
        data; under a ghost boundary the global-edge rings hold wrapped or
        mirrored data too, so the box widens by the exchange depth."""
        lm, ln = self.local_interior
        gm, gn = self.interior
        ix, iy = coord
        d = self.depth if self.config.boundary != "dirichlet0" else 0
        return (-ix * lm - d, gm - ix * lm + d, -iy * ln - d, gn - iy * ln + d)

    def _overlap_reason(self):
        """None when the overlapped exchange can run, else why not."""
        gi, gj = self.layout.grid
        TM, TN = self.layout.tile
        HR, HC = self.layout.guard
        tm, tn = self.tails
        lm, ln = self.local_interior
        if gi < 3 or gj < 3:
            return f"local tile grid {gi}x{gj} < 3x3"
        # inner tiles must not touch the ring, and the exchanged strips
        # must come out of the boundary tiles alone
        if HR > TM or HC > TN or self.depth > min(TM, TN):
            return "exchange depth exceeds the boundary tile"
        # tailed ghost modes read the TRUE-edge strip (at the tail
        # offset), which must also live in the last tile row/col
        if ((tm != lm and tm - self.depth < (gi - 1) * TM)
                or (tn != ln and tn - self.depth < (gj - 1) * TN)):
            return "true-tail edge strip lies outside the boundary tiles"
        return _split_reason(self)

    def _launch_depths(self, k: int):
        return stencil2d.launch_depths("step", self.spec, self.dtype, k)

    # -- per-shard steps ----------------------------------------------------
    def _kernel(self, cur, donor, fused_k: int, coord, region=None):
        return stencil2d.stencil2d_step(
            cur, donor, self.spec, self.layout,
            algorithm=self._kernel_algorithm(), fused_steps=fused_k,
            bounds=self._bounds(coord), region=region)


class ShardedStencilDF64(ShardedStencil2D):
    """Domain-decomposed fp64-grade 2-D stencil.  The JAX engine carries
    fp64-grade values as (hi, lo) fp32 pairs, because the TPU has no fp64
    unit; the card has one, so here the state is float64 and each shard
    runs the float64 instances of the 2-D kernel (the float64 strip kernel
    for every registry shape: TPU kernel #9's counterpart).  The JAX
    engine's tier boundaries hold: fused_steps == 1 (the pair kernel is
    single-step), and no overlapped exchange (the pair kernel takes no
    region calls): the ring-out step, or the sequential one under
    ``overlap=False``.  ``run`` takes a float64 padded array and returns a
    float64 tensor."""

    def __init__(self, spec: StencilSpec, interior: Tuple[int, int],
                 config: ShardedConfig, mesh: Optional[Mesh] = None,
                 devices=None):
        if config.dtype != "df64":
            raise ValueError("ShardedStencilDF64 needs dtype='df64'")
        if max(1, config.fused_steps) != 1:
            raise ValueError(
                "sharded df64 needs fused_steps=1 (the pair kernel is "
                "single-step)")
        if config.algorithm == "auto":
            alg = stencil2d.pick_algorithm(spec)
        else:
            alg = config.algorithm
        if alg not in stencil2d.DF64_ALGORITHMS:
            raise ValueError(
                f"df64 kernel algorithm must be 'auto', 'vpu', "
                f"'vpu_roll' or 'vpu_sep', got {config.algorithm!r} "
                f"(no error-free product path exists on the MXU)")
        self.df64_algorithm = alg
        base = dataclasses.replace(config, dtype="float32", algorithm=alg)
        super().__init__(spec, interior, base, mesh, devices)

    def _state_dtype(self):
        return torch.float64

    def _kernel_algorithm(self) -> str:
        return self.df64_algorithm

    def _step_fn(self):
        return (self._local_step_ringout if self.config.overlap
                else self._local_step)


# the JAX flat layout's whole-run cap (pallas_1d.RESIDENT_BYTES), which the
# JAX 1-D sharded engine tests on its own flat layout to choose its lanes
JAX_RESIDENT_BYTES = 512 * 2**10


def _jax_flat_fits_resident(n: int, k: int) -> bool:
    """``pallas_1d.fits_resident`` of the JAX engine's flat local layout
    (``lorastencil_tpu/parallel/domain.py`` ``ShardedStencil1D``): rows of
    128 lanes, tiles of ``max(8, min(512, 8 * ceil(n / 1024)))`` rows and
    ``8 * ceil(k / 8)`` guard rows each side, 4 bytes a cell."""
    rows = max(8, min(512, SUBLANE * _cdiv(n, SUBLANE * LANE)))
    guard_rows = SUBLANE * _cdiv(k, SUBLANE)
    cells = (2 * guard_rows + _cdiv(n, rows * LANE) * rows) * LANE
    return cells * 4 <= JAX_RESIDENT_BYTES


class ShardedStencil1D(_ShardedEngine):
    """Domain-decomposed 1-D stencil over a (dx,) mesh: each shard owns a
    contiguous block of ``local_interior`` cells (a multiple of 128, the
    JAX engine's lane multiple) in a flat ``Layout1D`` of ``TILE_1D``-cell
    tiles, whose guard holds the ``depth``-deep ring; a pass exchanges the
    two edge strips with the neighbours and runs the narrow pass
    (``stencil1d_lanes_step``, where ``lanes``) or the wide one
    (``stencil1d_step``) on each shard.  ``lanes`` is the JAX rule: a local
    block beyond the JAX flat kernel's whole-run size, an effective radius
    of 1-16, a lane halo that fits and no true tail inside the block; it
    then takes the JAX lanes depth ``min(k, 32 // r_eff)``.  Arguments and
    API as ``ShardedStencil2D``'s, with an int interior."""

    def __init__(self, spec: StencilSpec, interior: int,
                 config: ShardedConfig, mesh: Optional[Mesh] = None,
                 devices=None):
        if spec.ndim != 1:
            raise ValueError(f"{spec.name} is {spec.ndim}-D; "
                             f"{type(self).__name__} takes a 1-D spec")
        if config.dtype == "df64" and type(self) is ShardedStencil1D:
            raise ValueError(
                "dtype='df64' pair state needs ShardedStencilDF64_1D "
                "(sharded_engine dispatches there)")
        self.spec = spec
        self.config = config
        _check_reflect_fused(spec, config)
        dx = int(config.mesh_shape[0])
        self.interior = int(interior)
        self.mesh = mesh if mesh is not None else make_mesh((dx,), devices)
        if self.mesh.shape != (dx,):
            raise ValueError(f"mesh {self.mesh.shape} is not the config's "
                             f"{(dx,)}")
        self.dtype = self._state_dtype()
        # pad the local block to a lane multiple: arbitrary global sizes
        # shard for every boundary; dirichlet0 masks fake tail cells to
        # zero, ghost modes anchor the wrap/mirror at the last shard's true
        # tail
        nl = _cdiv(self.interior, dx)
        self.local_interior = LANE * _cdiv(nl, LANE)
        self.tail = (self.local_interior
                     if config.boundary == "dirichlet0"
                     else self.interior - (dx - 1) * self.local_interior)
        self.dx = dx
        k = max(1, config.fused_steps)
        self.fused_steps = min(k, stencil1d.MAX_FUSED)
        # exchange depth per pass: k*radius cells feed the fused substeps
        self.depth = max(spec.halo[0], self.fused_steps * spec.radius)
        r_eff = stencil1d.effective_radius(spec)
        k_l = max(1, min(self.fused_steps, 32 // max(1, r_eff)))
        h = k_l * max(1, r_eff)
        d_l = max(spec.halo[0], k_l * spec.radius)
        self.lanes = (not _jax_flat_fits_resident(self.local_interior,
                                                  self.fused_steps)
                      and 1 <= r_eff <= 16 and d_l <= LANE - 2 * h
                      and self.tail == self.local_interior)
        if self.lanes:
            self.fused_steps = k_l
            self.depth = d_l
        _check_tails(config.boundary, (self.tail,), self.depth, (dx,))
        if self.depth > self.local_interior:
            raise ValueError(
                f"exchange depth {self.depth} exceeds the local block "
                f"{self.local_interior}; use fewer devices or lower "
                f"fused_steps")
        self.layout = Layout1D(
            interior=self.local_interior, halo=spec.halo[0], tile=TILE_1D,
            guard=guard_1d(spec.halo[0], self.depth))
        self.layout.validate()
        self.precision = config.precision
        self.local = self.mesh.local()
        self._side = {}

    def _state_dtype(self):
        return STATE_DTYPES[self.config.dtype]

    # -- halo exchange ----------------------------------------------------
    def _shard_axes(self):
        return (_Axis(-1, self.interior, self.spec.halo[0],
                      self.local_interior, self.tail, self.depth,
                      self.layout.origin, 0),)

    def _bounds(self, coord):
        """The shard's box ``[-ix*nl - d, N - ix*nl + d)`` in local cells
        (d the depth under a ghost boundary, else 0), as the JAX engine's."""
        nl = self.local_interior
        d = self.depth if self.config.boundary != "dirichlet0" else 0
        return (-coord[0] * nl - d, self.interior - coord[0] * nl + d)

    def _overlap_reason(self):
        """None when the overlapped exchange can run, else why not: the
        edge strips must come out of the head and tail tiles alone (the
        port's ``TILE_1D``-cell tiles)."""
        (g,) = self.layout.grid
        T = self.layout.tile
        n = self.local_interior
        if g < 3:
            return f"local tile grid {g} < 3"
        if self.depth > T:
            return "exchange depth exceeds the boundary tile"
        if n - self.depth < (g - 1) * T:
            return "an edge strip lies outside the boundary tiles"
        if self.tail != n and self.tail - self.depth < (g - 1) * T:
            return "true-tail edge strip lies outside the boundary tiles"
        return None

    # -- per-shard steps ----------------------------------------------------
    def _kernel(self, cur, donor, fused_k: int, coord, region=None):
        kw = dict(fused_steps=fused_k, bounds=self._bounds(coord),
                  region=region)
        if self.lanes:
            alg = ("mxu" if self.config.algorithm in ("auto", "mxu")
                   else "vpu")
            return stencil1d.stencil1d_lanes_step(
                cur, donor, self.spec, self.layout, algorithm=alg, **kw)
        return stencil1d.stencil1d_step(cur, donor, self.spec, self.layout,
                                        **kw)


class ShardedStencilDF64_1D(ShardedStencil1D):
    """Domain-decomposed fp64-grade 1-D stencil: a float64 state (the JAX
    engine's (hi, lo) fp32 pairs) on the float64 instances of the 1-D
    kernels, as ``ShardedStencilDF64``.  The JAX engine's two layouts are
    its two kernels here: divisible blocks at an effective radius <= 32 run
    the narrow pass (``pass_kernel<double>``, TPU kernel #12), tailed ghost
    blocks and wide radii (33-127) the wide pass (``wide_kernel``, #13).
    Tier boundaries as JAX's: fused_steps == 1, algorithm 'auto' or
    'vpu_roll', an effective radius in [1, 127], no region (ring-out, or
    the sequential step under ``overlap=False``)."""

    def __init__(self, spec: StencilSpec, interior: int,
                 config: ShardedConfig, mesh: Optional[Mesh] = None,
                 devices=None):
        if config.dtype != "df64":
            raise ValueError("ShardedStencilDF64_1D needs dtype='df64'")
        if max(1, config.fused_steps) != 1:
            raise ValueError(
                "sharded df64 needs fused_steps=1 (the pair kernel is "
                "single-step)")
        if config.algorithm not in ("auto", "vpu_roll"):
            raise ValueError(
                f"1-D df64 kernel algorithm must be 'auto' or "
                f"'vpu_roll' (pair rolls), got {config.algorithm!r}")
        r_eff = stencil1d.effective_radius(spec)
        if not 1 <= r_eff <= LANE - 1:
            raise ValueError(
                f"sharded 1-D df64 needs an effective radius in "
                f"[1, 127] (flat shifts wrap one 128-lane row); this "
                f"spec has {r_eff} -- run single-device via "
                f"StencilEngine's XLA pair path")
        base = dataclasses.replace(config, dtype="float32",
                                   algorithm="vpu_roll", fused_steps=1)
        super().__init__(spec, interior, base, mesh, devices)
        if (not self.lanes and self.tail == self.local_interior
                and r_eff <= stencil1d.MAX_LANES_REACH):
            # divisible blocks the base rule keeps flat take the narrow
            # pass too (the JAX engine forces its lanes layout, k = 1)
            self.fused_steps = 1
            self.depth = max(spec.halo[0], spec.radius)
            self.lanes = True
            self.layout = Layout1D(
                interior=self.local_interior, halo=spec.halo[0],
                tile=TILE_1D, guard=guard_1d(spec.halo[0], self.depth))

    def _state_dtype(self):
        return torch.float64

    def _step_fn(self):
        return (self._local_step_ringout if self.config.overlap
                else self._local_step)


class ShardedStencil3D(_ShardedEngine):
    """Domain-decomposed 3-D stencil.  ``mesh_shape=(dx, dy)`` shards the
    (row, col) plane axes (the kernel's z march stays local to a shard);
    ``(dz, dx, dy)`` also cuts the z axis: a z phase runs before the row
    and column phases, the z guard planes double as the z halo-receive
    buffer, and the later phases' strips carry the earlier phases' cells so
    that the 8 corner octants travel.  Each shard runs ``stencil3d_step``
    (the march kernel, or the general one) with its box; ``algorithm``
    takes the JAX 3-D engine's names ('auto' / 'vpu', 'vpu_roll',
    'mxu_hybrid1', 'mxu'), each run by the port's exact kernel.  Arguments
    and API as ``ShardedStencil2D``'s."""

    def __init__(self, spec: StencilSpec, interior, config: ShardedConfig,
                 mesh: Optional[Mesh] = None, devices=None):
        if spec.ndim != 3:
            raise ValueError(f"{spec.name} is {spec.ndim}-D; "
                             f"{type(self).__name__} takes a 3-D spec")
        if config.dtype == "df64" and type(self) is ShardedStencil3D:
            raise ValueError(
                "dtype='df64' pair state needs ShardedStencilDF64_3D "
                "(sharded_engine dispatches there)")
        self.spec = spec
        self.config = config
        _check_reflect_fused(spec, config)
        h, gm, gn = (int(s) for s in interior)
        ms = tuple(int(s) for s in config.mesh_shape)
        if len(ms) == 3:
            dz, dx, dy = ms
        elif len(ms) == 2:
            dz, (dx, dy) = 1, ms
        else:
            raise ValueError(f"a 3-D mesh is (dx, dy) or (dz, dx, dy), got "
                             f"{ms}")
        self.dz, self.dxy = dz, (dx, dy)
        self.interior = (h, gm, gn)
        shape = (dz, dx, dy) if dz > 1 else (dx, dy)
        self.mesh = mesh if mesh is not None else make_mesh(shape, devices)
        if self.mesh.shape != shape:
            raise ValueError(f"mesh {self.mesh.shape} is not the config's "
                             f"{shape}")
        self.dtype = self._state_dtype()
        self.algorithm = self._alg3()
        k = max(1, config.fused_steps)
        self.fused_steps = k
        lm, ln = _cdiv(gm, dx), _cdiv(gn, dy)
        tile = config.tile if config.tile is not None else TILE_3D
        lm, ln, tile = _pad_local_block(lm, ln, tuple(int(t) for t in tile),
                                        config.tile is not None, TILE_3D)
        # z blocks need no alignment (planes are the leading axis); a
        # non-divisible depth pads the last block, masked by the bounds
        lz = _cdiv(h, dz)
        self.local_interior = (lz, lm, ln)
        # exchange depth per pass: k*radius cells feed the fused substeps
        self.depth = max(max(spec.halo[1:]), k * spec.radius)
        zd = max(spec.halo[0], k * spec.radius)
        self.zdepth = zd
        if config.boundary == "dirichlet0":
            self.tails = (lm, ln)
            self.ztail = lz
        else:
            self.tails = (gm - (dx - 1) * lm, gn - (dy - 1) * ln)
            self.ztail = h - (dz - 1) * lz
        _check_tails(config.boundary, self.tails, self.depth, (dx, dy))
        if dz > 1:
            _check_tails(config.boundary, (self.ztail,), zd, (dz,))
            if zd > lz:
                raise ValueError(
                    f"z exchange depth {zd} exceeds the local z block {lz}; "
                    f"use fewer z devices or lower fused_steps")
        if self.depth > SUBLANE:
            raise ValueError(
                f"3-D fused exchange depth {self.depth} exceeds the "
                f"{SUBLANE}-row window guard; lower fused_steps")
        if self.depth > min(lm, ln):
            raise ValueError(
                f"exchange depth {self.depth} exceeds the local block "
                f"{(lm, ln)}; use fewer devices or lower fused_steps")
        self.layout = Layout3D(
            interior=self.local_interior, halo=spec.halo, tile=tile,
            guard=(max(zd, 1),) + guard_2d(spec.halo[1:], self.depth))
        self.layout.validate()
        self.precision = config.precision
        self.local = self.mesh.local()
        self._side = {}

    def _state_dtype(self):
        return STATE_DTYPES[self.config.dtype]

    def _alg3(self):
        """The JAX engine's 3-D names ('auto' is 'vpu'); each runs the
        port's one exact kernel of the dtype."""
        alg = self.config.algorithm
        if alg == "auto":
            return "vpu"
        if alg not in ("vpu", "vpu_roll", "mxu", "mxu_hybrid1"):
            raise ValueError(
                f"algorithm {alg!r} has no 3-D path; sharded 3-D "
                f"engines support 'auto'/'vpu', 'vpu_roll', "
                f"'mxu_hybrid1' or 'mxu'")
        return alg

    def _kernel_algorithm(self) -> str:
        # 'mxu' (banded matmuls on the TPU) is the same function: the exact
        # kernel runs it
        return "vpu" if self.algorithm == "mxu" else self.algorithm

    # -- mesh coordinates ---------------------------------------------------
    def _axes(self, coord):
        """(iz, ix, iy) of a mesh coordinate (iz 0 on a plane mesh)."""
        return tuple(coord) if self.dz > 1 else (0,) + tuple(coord)

    def _axis(self, name: str) -> int:
        """The mesh axis of 'z', 'x' or 'y'."""
        return {"z": 0, "x": 1, "y": 2}[name] - (self.dz == 1)

    # -- halo exchange ----------------------------------------------------
    def _shard_axes(self):
        """z (cut on a (dz, dx, dy) mesh; else whole, its user halo
        embedded), rows and columns."""
        (hz, hm, hn), (H, gm, gn) = self.spec.halo, self.interior
        (lz, lm, ln), (tm, tn) = self.local_interior, self.tails
        z0, r0, c0 = self.layout.origin
        z = (_Axis(-3, H, hz, lz, self.ztail, self.zdepth, z0, 0)
             if self.dz > 1 else _Axis(-3, H, hz, lz, lz, hz, z0, None))
        return (z, _Axis(-2, gm, hm, lm, tm, self.depth, r0, self._axis("x")),
                _Axis(-1, gn, hn, ln, tn, self.depth, c0, self._axis("y")))

    def _refresh(self, bufs):
        """Local ghost refresh of the z guard planes (unsharded z under a
        ghost boundary): wrap for periodic, mirror for reflect, over the
        full (row, col) extent so that the row and column phases carry the
        z ghost rings."""
        if not self._needs_local_zghost():
            return bufs
        h, z0, d = self.local_interior[0], self.layout.origin[0], self.zdepth
        for b in bufs.values():
            if self.config.boundary == "reflect":
                lo, hi = b[z0: z0 + d].flip(0), b[z0 + h - d: z0 + h].flip(0)
            else:
                lo, hi = b[z0 + h - d: z0 + h].clone(), b[z0: z0 + d].clone()
            b[z0 - d: z0] = lo
            b[z0 + h: z0 + h + d] = hi
        return bufs

    def _needs_local_zghost(self) -> bool:
        """Only unsharded-z ghost boundaries refresh the z guard locally;
        a z-sharded mesh exchanges it."""
        return self.dz == 1 and self.config.boundary != "dirichlet0"

    def _bounds(self, coord):
        """The shard's box, as the JAX engine's: on a z-sharded mesh 6
        values with its z range, under a ghost boundary 6 with the z guard
        kept, else 4; ghost boxes widen by the exchange depths."""
        lz, lm, ln = self.local_interior
        H, gm, gn = self.interior
        iz, ix, iy = self._axes(coord)
        ghost = self.config.boundary != "dirichlet0"
        d = self.depth if ghost else 0
        plane = (-ix * lm - d, gm - ix * lm + d, -iy * ln - d,
                 gn - iy * ln + d)
        if self.dz > 1:
            zd = self.zdepth if ghost else 0
            return (-iz * lz - zd, H - iz * lz + zd) + plane
        if ghost:
            return (-self.zdepth, H + self.zdepth) + plane
        return plane

    def _overlap_reason(self):
        """None when the overlapped exchange can run, else why not."""
        gi, gj = self.layout.grid
        TM, TN = self.layout.tile
        _, HR, HC = self.layout.guard
        _, lm, ln = self.local_interior
        tm, tn = self.tails
        if self.dz > 1:
            # the z slabs span the full plane: every tile makes them, so
            # there is no boundary frame to exchange early
            return "z-sharded meshes exchange after the full-grid kernel"
        if gi < 3 or gj < 3:
            return f"local tile grid {gi}x{gj} < 3x3"
        if HR > TM or HC > TN or self.depth > min(TM, TN):
            return "exchange depth exceeds the boundary tile"
        if ((tm != lm and tm - self.depth < (gi - 1) * TM)
                or (tn != ln and tn - self.depth < (gj - 1) * TN)):
            return "true-tail edge strip lies outside the boundary tiles"
        return _split_reason(self)

    def _launch_depths(self, k: int):
        return stencil3d.launch_depths(self.spec, self.dtype, k)

    # -- per-shard steps ----------------------------------------------------
    def _kernel(self, cur, donor, fused_k: int, coord, region=None):
        return stencil3d.stencil3d_step(
            cur, donor, self.spec, self.layout,
            algorithm=self._kernel_algorithm(), fused_steps=fused_k,
            bounds=self._bounds(coord), region=region)

    def _run(self, state, steps: int):
        """As ``_ShardedEngine._run``; an unsharded-z ghost boundary also
        clears the z guard planes of the result, which a donor may have
        kept from its turn as an input (the halo contract: zero after a
        step)."""
        out = super()._run(state, steps)
        if steps > 0 and self._needs_local_zghost():
            z0, d = self.layout.origin[0], self.zdepth
            h = self.local_interior[0]
            for b in out.values():
                b[z0 - d: z0] = 0
                b[z0 + h: z0 + h + d] = 0
        return out


class ShardedStencilDF64_3D(ShardedStencil3D):
    """Domain-decomposed fp64-grade 3-D stencil over a (dx, dy) or (dz, dx,
    dy) mesh: a float64 state (the JAX engine's (hi, lo) fp32 pairs) on the
    float64 instances of the 3-D kernels (TPU kernel #11's counterpart), as
    ``ShardedStencilDF64``.  Tier boundaries as JAX's: fused_steps == 1,
    algorithm 'auto' / 'vpu_sep', no region (ring-out, or the sequential
    step under ``overlap=False``)."""

    def __init__(self, spec: StencilSpec, interior, config: ShardedConfig,
                 mesh: Optional[Mesh] = None, devices=None):
        if config.dtype != "df64":
            raise ValueError("ShardedStencilDF64_3D needs dtype='df64'")
        if max(1, config.fused_steps) != 1:
            raise ValueError(
                "sharded df64 needs fused_steps=1 (the pair kernel is "
                "single-step)")
        alg = "vpu_sep" if config.algorithm == "auto" else config.algorithm
        if alg != "vpu_sep":
            raise ValueError(
                f"the 3-D pair slab kernel's only path is separable "
                f"slices ('auto'/'vpu_sep'), got {config.algorithm!r}")
        self.df64_algorithm = alg
        base = dataclasses.replace(config, dtype="float32", algorithm="auto")
        super().__init__(spec, interior, base, mesh, devices)

    def _state_dtype(self):
        return torch.float64

    def _kernel_algorithm(self) -> str:
        return self.df64_algorithm

    def _step_fn(self):
        return (self._local_step_ringout if self.config.overlap
                else self._local_step)


def sharded_engine(shape, interior, mesh_shape, mesh: Optional[Mesh] = None,
                   devices=None, **kw):
    """Domain-decomposed engine for a registry shape name OR a custom
    ``StencilSpec`` (e.g. ``StencilEngine.for_coeffs(...).spec``), over
    ``mesh`` or a mesh of ``devices`` (``make_mesh``); ``kw`` are
    ``ShardedConfig`` fields.  The spec's dimension picks the engine, and
    dtype 'df64' its fp64-grade twin."""
    spec = shape if isinstance(shape, StencilSpec) else get_shape(shape)
    cfg = ShardedConfig(mesh_shape=tuple(mesh_shape), **kw)
    if spec.ndim == 1:
        cls = (ShardedStencilDF64_1D if cfg.dtype == "df64"
               else ShardedStencil1D)
        return cls(spec, int(np.atleast_1d(interior)[0]), cfg, mesh, devices)
    if spec.ndim == 3:
        cls = (ShardedStencilDF64_3D if cfg.dtype == "df64"
               else ShardedStencil3D)
    else:
        cls = ShardedStencilDF64 if cfg.dtype == "df64" else ShardedStencil2D
    return cls(spec, tuple(interior), cfg, mesh, devices)


def sharded_engine_for_coeffs(coeffs, interior, mesh_shape, name="custom",
                              halo=None, max_rank: int = 4, **kw):
    """Sharded engine for arbitrary dense coefficients (1-D taps, a square
    2-D array with odd sides or a 3-D array with odd extents): the
    factorization of ``StencilEngine.for_coeffs``, then domain
    decomposition over the mesh."""
    from ..engine import StencilEngine

    spec = StencilEngine.for_coeffs(
        np.asarray(coeffs, np.float64), interior, name=name, halo=halo,
        max_rank=max_rank, device="cpu").spec
    return sharded_engine(spec, interior, mesh_shape, **kw)
