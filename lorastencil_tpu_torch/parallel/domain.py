"""Domain decomposition of the 2-D engines over a mesh of shards.

Counterpart of ``lorastencil_tpu/parallel/domain.py`` for 2-D specs:
``ShardedConfig``, ``make_mesh``, ``ShardedStencil2D``,
``ShardedStencilDF64``, ``sharded_engine`` and ``sharded_engine_for_coeffs``,
with the JAX engine's fields, checks and messages.  1-D and 3-D specs are
still to be ported (ROADMAP A11(b), A11(c)): ``sharded_engine`` refuses them.

The global interior is cut into a (dx, dy) mesh of blocks; each shard owns
one block in a buffer of the port's internal layout (``ops/layout.py``),
whose guard ring doubles as the halo-receive buffer, ``depth`` = k * radius
cells deep for a pass of k fused steps.  A pass exchanges the strips along
the block edges in two phases, rows then columns (the column strips span
the rows just received, so corners travel), and runs the 2-D kernel of
``ops/stencil2d.py`` on each shard with the shard's ``bounds``: its box in
the global interior, in local coordinates, which keeps an inner shard's
ring alive through the fused levels and zeroes the padding of the last
shard of an axis the mesh does not divide.

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
and ``_exchange`` do.  The local steps are the JAX engine's three, chosen
by the same rule (``_run``): the sequential step (exchange into the input,
then one kernel call; ``overlap=False``), the ring-out step (one kernel
call, then the output's edge strips exchanged into its own ring: the
default where the tile grid cannot split) and the overlapped step (the
four boundary-frame windows first, ``region`` launches; the exchange of
their edge strips on a side stream while the inner window runs on the
compute stream; then the received ring written into the output).  On the
card a region launch covers its window only (``csrc/stencil2d.cu``
in_window).

The port's own choices (ROADMAP section C): its default tile is the
kernel's (32, 128) block tile (``_pad_local_block``), so that where the
JAX engine pads a local block to its TPU tile the port may split it into
another tile grid, and ``_can_overlap`` may then differ for the same
configuration -- the values do not; a pass deeper than one launch of the
2-D kernel (``stencil2d.launch_depths``) runs as passes of one launch each
with an exchange between them, because a launch past the first would read
a ring its neighbours have moved on from, and takes the ring-out step
(``_overlap_reason``), as the JAX engine does where it cannot split.
``precision`` is a label, as in the single-device engine; ``interpret``
has no counterpart and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.shapes import StencilSpec, get_shape
from ..ops import stencil2d
from ..ops.layout import TILE_2D, Layout2D, as_state, guard_2d

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


def divisor_tile_2d(m: int) -> Tuple[int, int]:
    """The largest tile of the port's shape -- rows a multiple of 8 up to
    the kernel's 32, the kernel's 128 columns -- whose rows DIVIDE m (a
    block's columns are a multiple of 128 already): the JAX rule
    (``lorastencil_tpu/ops/layout.py`` ``divisor_tile_2d``) under the
    port's tile."""
    tm = next(c for c in range(TILE_2D[0], 0, -SUBLANE) if m % c == 0)
    return (tm, TILE_2D[1])


def _pad_local_block(lm: int, ln: int, tile, explicit_tile: bool):
    """The JAX engine's local-block padding under the port's tile: round
    the block up to (8, 128), then to a tile multiple (no tile round-up
    region, so the exchanged guard ring never aliases interior tiles;
    padded fake cells are bounds-masked to zero).  When padding to the
    default tile would waste > ~8% of the block, a zero-waste divisor tile
    wins instead.  Returns (lm, ln, tile)."""
    bm = SUBLANE * _cdiv(lm, SUBLANE)
    bn = LANE * _cdiv(ln, LANE)
    if not explicit_tile and (bm % tile[0] or bn % tile[1]):
        pad = (tile[0] * _cdiv(bm, tile[0])) * (tile[1] * _cdiv(bn, tile[1]))
        if pad > 1.08 * bm * bn:
            tile = divisor_tile_2d(bm)
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
    ((dx, dy) for 2-D), ``tile`` (the port's round-up granule; the kernel's
    block tile when None, see ``_pad_local_block``), the state ``dtype``
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


class ShardedStencil2D:
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
    def _hi_starts(self, coord):
        """(row, col) local starts of the high-side ghost ring: the true
        global tail for the LAST shard along each axis, the block edge
        otherwise."""
        m, n = self.layout.interior
        tm, tn = self.tails
        dx, dy = self.config.mesh_shape
        return (tm if coord[0] == dx - 1 else m,
                tn if coord[1] == dy - 1 else n)

    def _shift(self, strips, axis: int, fwd: bool):
        return shift(self.mesh, strips, axis, fwd,
                     self.config.boundary == "periodic")

    def _exchange(self, bufs):
        """Fill each local buffer's guard ring, in place, from its
        neighbours to ``self.depth`` cells -- deep enough for a whole fused
        pass.  Under dirichlet0 a shard on the global edge keeps its ring
        there (the user halo before step 1, zero after); periodic takes the
        wrapped strip; reflect mirrors the shard's own edge.  The high-side
        ring sits at the shard's true-tail offset (``_hi_starts``)."""
        h = self.depth
        r0, c0 = self.layout.origin
        dx, dy = self.config.mesh_shape
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        starts = {c: self._hi_starts(c) for c in self.local}

        # phase 1: rows.  My top interior strip goes to the north
        # neighbour (its bottom ring) and my bottom one to the south.
        top = {c: b[r0: r0 + h, :] for c, b in bufs.items()}
        bot = {c: b[r0 + starts[c][0] - h: r0 + starts[c][0], :]
               for c, b in bufs.items()}
        from_north = self._shift(bot, 0, True)
        from_south = self._shift(top, 0, False)
        for c, b in bufs.items():
            rs = starts[c][0]
            if wrap or c[0] > 0:
                b[r0 - h: r0, :] = from_north[c]
            elif refl:
                b[r0 - h: r0, :] = top[c].flip(0)
            if wrap or c[0] < dx - 1:
                b[r0 + rs: r0 + rs + h, :] = from_south[c]
            elif refl:
                b[r0 + rs: r0 + rs + h, :] = bot[c].flip(0)

        # phase 2: columns, whose strips hold the rows just filled, so that
        # the corners travel
        left = {c: b[:, c0: c0 + h] for c, b in bufs.items()}
        right = {c: b[:, c0 + starts[c][1] - h: c0 + starts[c][1]]
                 for c, b in bufs.items()}
        from_west = self._shift(right, 1, True)
        from_east = self._shift(left, 1, False)
        for c, b in bufs.items():
            cs = starts[c][1]
            if wrap or c[1] > 0:
                b[:, c0 - h: c0] = from_west[c]
            elif refl:
                b[:, c0 - h: c0] = left[c].flip(1)
            if wrap or c[1] < dy - 1:
                b[:, c0 + cs: c0 + cs + h] = from_east[c]
            elif refl:
                b[:, c0 + cs: c0 + cs + h] = right[c].flip(1)
        return bufs

    def _exchange_strips(self, bufs):
        """The two-phase exchange WITHOUT writing into ``bufs``: per local
        shard the received ring strips (north, south, west, east; zeros at
        the global edge under dirichlet0).  The column strips span the full
        buffer height with the phase-1 rows patched in, so corners
        propagate as in the sequential exchange."""
        h = self.depth
        r0, c0 = self.layout.origin
        dx = self.config.mesh_shape[0]
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        starts = {c: self._hi_starts(c) for c in self.local}
        top = {c: b[r0: r0 + h, :] for c, b in bufs.items()}
        bot = {c: b[r0 + starts[c][0] - h: r0 + starts[c][0], :]
               for c, b in bufs.items()}
        from_north = self._shift(bot, 0, True)
        from_south = self._shift(top, 0, False)

        def col_strip(c, c_lo):
            rs = starts[c][0]
            s = bufs[c][:, c_lo: c_lo + h].clone()
            if wrap or c[0] > 0:
                s[r0 - h: r0] = from_north[c][:, c_lo: c_lo + h]
            elif refl:
                s[r0 - h: r0] = top[c][:, c_lo: c_lo + h].flip(0)
            else:
                s[r0 - h: r0] = 0
            if wrap or c[0] < dx - 1:
                s[r0 + rs: r0 + rs + h] = from_south[c][:, c_lo: c_lo + h]
            elif refl:
                s[r0 + rs: r0 + rs + h] = bot[c][:, c_lo: c_lo + h].flip(0)
            else:
                s[r0 + rs: r0 + rs + h] = 0
            return s

        from_west = self._shift(
            {c: col_strip(c, c0 + starts[c][1] - h) for c in bufs}, 1, True)
        from_east = self._shift({c: col_strip(c, c0) for c in bufs}, 1,
                                False)
        return {c: (from_north[c], from_south[c], from_west[c], from_east[c])
                for c in bufs}

    def _write_ring(self, bufs, parts):
        """Write received strips into each local guard ring: rows first,
        then columns, whose mirrors read the buffer after the row writes so
        that reflect corners compose row-mirror x col-mirror (``np.pad``
        symmetric)."""
        h = self.depth
        r0, c0 = self.layout.origin
        dx, dy = self.config.mesh_shape
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        for c, b in bufs.items():
            rs, cs = self._hi_starts(c)
            fn, fs, fw, fe = parts[c]
            rings = ((wrap or c[0] > 0, slice(r0 - h, r0), fn,
                      slice(r0, r0 + h)),
                     (wrap or c[0] < dx - 1, slice(r0 + rs, r0 + rs + h), fs,
                      slice(r0 + rs - h, r0 + rs)))
            for take, ring, strip, edge in rings:
                if take:
                    b[ring, :] = strip
                elif refl:
                    b[ring, :] = b[edge, :].flip(0)
                else:
                    b[ring, :] = 0
            rings = ((wrap or c[1] > 0, slice(c0 - h, c0), fw,
                      slice(c0, c0 + h)),
                     (wrap or c[1] < dy - 1, slice(c0 + cs, c0 + cs + h), fe,
                      slice(c0 + cs - h, c0 + cs)))
            for take, ring, strip, edge in rings:
                if take:
                    b[:, ring] = strip
                elif refl:
                    b[:, ring] = b[:, edge].flip(1)
                else:
                    b[:, ring] = 0
        return bufs

    def exchange_bytes(self) -> int:
        """The bytes an inner shard sends a pass: two row strips (depth x
        the buffer's pitch) and two column strips (the buffer's rows x
        depth), in the state's dtype."""
        rows, pitch = self.layout.shape
        return 2 * self.depth * (rows + pitch) * self.dtype.itemsize

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
        depths = stencil2d.launch_depths("step", self.spec, self.dtype,
                                         self.fused_steps)
        if len(depths) > 1:
            return (f"a pass of {self.fused_steps} fused steps takes "
                    f"{len(depths)} launches; a region needs one")
        return None

    def _can_overlap(self) -> bool:
        return self.config.overlap and self._overlap_reason() is None

    # -- per-shard steps ----------------------------------------------------
    def _kernel(self, cur, donor, fused_k: int, coord, region=None):
        return stencil2d.stencil2d_step(
            cur, donor, self.spec, self.layout,
            algorithm=self._kernel_algorithm(), fused_steps=fused_k,
            bounds=self._bounds(coord), region=region)

    def _local_step(self, cur, donor, fused_k):
        """Exchange into the input, then one kernel call per shard."""
        self._exchange(cur)
        return {c: self._kernel(cur[c], donor[c], fused_k, c) for c in cur}

    def _local_step_ringout(self, cur, donor, fused_k):
        """One kernel call per shard from ``cur`` (whose ring already holds
        this pass's neighbour data), then the output's edge strips
        exchanged and written into the output's own ring, ready for the
        next pass: the overlapped step's dataflow without the split."""
        out = {c: self._kernel(cur[c], donor[c], fused_k, c) for c in cur}
        return self._write_ring(out, self._exchange_strips(out))

    def _local_step_overlap(self, cur, donor, fused_k):
        """One pass with the exchange overlapped with inner compute: each
        shard's boundary frame first (four region launches), then the
        exchange of the frame's edge strips on a side stream of each card
        while the inner window runs on the compute stream, then the
        received ring written into the output for the next pass."""
        gi, gj = self.layout.grid
        frame = (((0, 1), (0, gj)), ((gi - 1, gi), (0, gj)),
                 ((1, gi - 1), (0, 1)), ((1, gi - 1), (gj - 1, gj)))
        for c in cur:
            for region in frame:
                self._kernel(cur[c], donor[c], fused_k, c, region)
        with self._on_side_streams() as streams:
            parts = self._exchange_strips(donor)
        for c in cur:
            self._kernel(cur[c], donor[c], fused_k, c,
                         ((1, gi - 1), (1, gj - 1)))
        for side in streams:
            torch.cuda.current_stream(side.device).wait_stream(side)
        for strips in parts.values():
            for t in strips:
                if t.is_cuda:  # made on a side stream, read on the current
                    t.record_stream(torch.cuda.current_stream(t.device))
        return self._write_ring(donor, parts)

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

    def _pass(self, step_fn):
        """``step_fn`` for ``ping_pong_loop``: a pass deeper than one launch
        of the kernel (``stencil2d.launch_depths``) runs as passes of one
        launch each, every one with its exchange, into a spare set of
        buffers by turns."""
        def run(cur, donor, k):
            depths = stencil2d.launch_depths("step", self.spec, self.dtype, k)
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

    # -- user API -----------------------------------------------------------
    def _home(self) -> torch.device:
        """The device of the global arrays: the first local shard's."""
        return self.mesh.device(self.local[0]) if self.local else \
            torch.device("cpu")

    def to_sharded(self, padded):
        """User global padded array -> {coordinate: internal buffer} of the
        local shards, in the state's dtype on each shard's device (a float64
        source rounds once to bfloat16, ``as_state``).

        Each buffer gets its block plus a DEPTH-wide ring taken from the
        global array (neighbour interiors inside the grid, the user halo at
        the boundary, the wrapped or mirrored edge under a ghost boundary,
        zeros beyond): pass 1 then needs no leading exchange."""
        hm, hn = self.spec.halo
        gm, gn = self.interior
        lm, ln = self.local_interior
        dx, dy = self.config.mesh_shape
        r0, c0 = self.layout.origin
        d = self.depth
        src = torch.as_tensor(padded).to(self._home())
        if tuple(src.shape) != (gm + 2 * hm, gn + 2 * hn):
            raise ValueError(
                f"padded array has shape {tuple(src.shape)}, the engine "
                f"expects {(gm + 2 * hm, gn + 2 * hn)}")
        # the block-padded global extent; fake cells beyond the true
        # interior stay zero
        gpad = src.new_zeros((dx * lm + 2 * d, dy * ln + 2 * d))
        gpad[d - hm: d + gm + hm, d - hn: d + gn + hn] = src
        if self.config.boundary == "periodic":
            # the high-side ghost sits at the TRUE edge gm / gn
            gpad[:d, d: d + gn] = gpad[gm: gm + d, d: d + gn]
            gpad[d + gm: 2 * d + gm, d: d + gn] = gpad[d: 2 * d, d: d + gn]
            gpad[:, :d] = gpad[:, gn: gn + d]
            gpad[:, d + gn: 2 * d + gn] = gpad[:, d: 2 * d]
        elif self.config.boundary == "reflect":
            gpad[:d, d: d + gn] = gpad[d: 2 * d, d: d + gn].flip(0)
            gpad[d + gm: 2 * d + gm, d: d + gn] = \
                gpad[gm: gm + d, d: d + gn].flip(0)
            gpad[:, :d] = gpad[:, d: 2 * d].flip(1)
            gpad[:, d + gn: 2 * d + gn] = gpad[:, gn: gn + d].flip(1)
        out = {}
        for c in self.local:
            i, j = c
            dev = self.mesh.device(c)
            buf = torch.zeros(self.layout.shape, dtype=self.dtype,
                              device=dev)
            buf[r0 - d: r0 + lm + d, c0 - d: c0 + ln + d] = as_state(
                gpad[i * lm: i * lm + lm + 2 * d, j * ln: j * ln + ln + 2 * d],
                self.dtype, dev)
            out[c] = buf
        return out

    def from_sharded(self, state):
        """{coordinate: local buffer} -> the user global padded array (zero
        halo), on the first local shard's device.  On a mesh that spans
        processes every process calls it and receives the whole array
        (an all-gather of each rank's blocks)."""
        hm, hn = self.spec.halo
        lm, ln = self.local_interior
        r0, c0 = self.layout.origin
        gm, gn = self.interior
        out = torch.zeros((gm + 2 * hm, gn + 2 * hn), dtype=self.dtype,
                          device=self._home())

        def blocks(coords):
            for i, j in coords:
                tm = min(lm, gm - i * lm)  # clamp the block-padded tail
                tn = min(ln, gn - j * ln)
                if tm > 0 and tn > 0:
                    yield (i, j), (slice(hm + i * lm, hm + i * lm + tm),
                                   slice(hn + j * ln, hn + j * ln + tn)), \
                        (slice(r0, r0 + tm), slice(c0, c0 + tn))

        for c, box, local in blocks(self.local):
            out[box] = state[c][local]
        if self.mesh.spans_processes:
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size())]
            dist.all_gather([p.view(torch.uint8) for p in parts],
                            out.view(torch.uint8))
            for c, box, _ in blocks(self.mesh.coords()):
                out[box] = parts[self.mesh.rank_of(c)][box]
        return out

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


def sharded_engine(shape, interior, mesh_shape, mesh: Optional[Mesh] = None,
                   devices=None, **kw):
    """Domain-decomposed engine for a registry shape name OR a custom
    ``StencilSpec`` (e.g. ``StencilEngine.for_coeffs(...).spec``), over
    ``mesh`` or a mesh of ``devices`` (``make_mesh``); ``kw`` are
    ``ShardedConfig`` fields.  2-D specs only, for now."""
    spec = shape if isinstance(shape, StencilSpec) else get_shape(shape)
    cfg = ShardedConfig(mesh_shape=tuple(mesh_shape), **kw)
    if spec.ndim == 1:
        raise NotImplementedError(
            "the sharded 1-D engines are not ported to lorastencil_tpu_torch "
            "yet (ROADMAP A11(b))")
    if spec.ndim == 3:
        raise NotImplementedError(
            "the sharded 3-D engines are not ported to lorastencil_tpu_torch "
            "yet (ROADMAP A11(c))")
    if cfg.dtype == "df64":
        return ShardedStencilDF64(spec, tuple(interior), cfg, mesh, devices)
    return ShardedStencil2D(spec, tuple(interior), cfg, mesh, devices)


def sharded_engine_for_coeffs(coeffs, interior, mesh_shape, name="custom",
                              halo=None, max_rank: int = 4, **kw):
    """Sharded engine for arbitrary dense coefficients (a square 2-D
    array with odd sides): the factorization of ``StencilEngine.for_coeffs``,
    then domain decomposition over the mesh."""
    from ..engine import StencilEngine

    spec = StencilEngine.for_coeffs(
        np.asarray(coeffs, np.float64), interior, name=name, halo=halo,
        max_rank=max_rank, device="cpu").spec
    return sharded_engine(spec, interior, mesh_shape, **kw)
