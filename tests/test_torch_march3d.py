"""The 3-D march kernel (csrc/stencil3d.cu march_kernel): its dispatch rule
(ops/stencil3d.march_takes), its task plan, and a plain PyTorch emulation of
its traversal held against the plain twin it must equal
(ops/stencil3d.stencil3d_step_plain at the same depth).  CPU only; the kernel
itself is held against the twin and the general 3-D kernel on the card by
tests/test_torch_cuda.py.

What the emulation repeats: the launch's tasks (launch_march: a z chunk that
gives each resident block about one task, at least 16 K r planes, the blocks
walking the tasks); per task a cell grid of 2-row x one-quad groups (4
float32 or 2 float64 cells) over the tile plus, at K = 2, r rows and one
quad each side; input plane u (interior z = zs - K r + u) fetched three
planes ahead into a ring of shared slots, zeros outside the buffer;
level 1 taking plane u (level_step): its z term's value Y(u) (the buffered
term's conv or the identity term's cells), plane u's sum started with the
centre terms' convs of u and the z taps of Y(u - r) .. Y(u - 1) (a
buffered term's held convs, or an identity term's cells read back from the
slots that still hold those planes) and Y(u), the r waiting sums each
taking their tap of Y(u), the oldest -- plane u - r -- yielded; at K = 2
that plane, masked, written into a ring of level slots whose cells no
group owns are NaN, so that a leak into a stored cell shows, and level 2
taking it likewise to yield plane u - 2r; every level
masked to the interior; the last level's cells stored only by the groups
inside the tile and the rounded interior.  Per cell the sums are the
twin's: the kernel fuses each multiply-add in fp32, the emulation takes the
twin's product then sum, which agree on the registry's power-of-two taps;
it checks the traversal, which is all the kernel changes.  Tolerance: none,
in float32 and float64, on the integer, pi/100 and inf fills (NaN where the
twin has NaN)."""

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec, get_shape
from lorastencil_tpu_torch.ops import stencil3d
from lorastencil_tpu_torch.ops.band_gemm import BUFFERED, CENTRE, term_class
from lorastencil_tpu_torch.ops.layout import Layout3D, default_tile_3d, guard_3d
from lorastencil_tpu_torch.utils import reference

SHAPES_3D = ["star3d1r", "box3d1r"]
DTYPES = [torch.float32, torch.float64]
FILLS = ["integer", "pi", "inf"]
CH = 2      # csrc/stencil3d.cu kMarchRows: rows of a thread's cell group
AHEAD = 3   # kMarchAhead: input planes in flight
QUADS = stencil3d.MARCH_TILE_QUADS
TM = stencil3d.MARCH_TILE_ROWS
RESIDENT = 264  # blocks an H100 holds at once at two per SM


def _same(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _fill(g0, fill):
    if fill == "integer":
        return g0
    x = g0 * (np.pi / 100)
    if fill == "inf":
        x = x.copy()
        x.flat[x.size // 3] = np.inf
    return x


def _geometry(dtype, R, K):
    """csrc/stencil3d.cu March<T, R, K>: cells a quad, tile, the cell grid's
    margins and extent, thread groups."""
    V = 16 // torch.empty((), dtype=dtype).element_size()
    ER, EQ = (K - 1) * R, (1 if K > 1 else 0)
    GR, GX = TM + 2 * ER, QUADS + 2 * EQ
    return dict(V=V, TN=QUADS * V, ER=ER, EQ=EQ, GR=GR, GX=GX, GC=GX * V,
                groups=GX * (GR // CH))


def _tasks(layout, dtype, K, R, resident=RESIDENT):
    """(zc, [(i0, j0, zs)] in the order the blocks walk them), as
    launch_march sizes the chunk and march_kernel's blocks walk the tasks
    (block b takes tasks b, b + blocks, ...)."""
    h, mr, nr = layout.rounded
    g = _geometry(dtype, R, K)
    tiles_c = -(-nr // g["TN"])
    tiles = tiles_c * -(-mr // TM)
    chunks = max(resident // tiles, 1)
    zc = max(-(-h // chunks), min(16 * K * R, h))
    tasks = tiles * -(-h // zc)
    blocks = min(tasks, resident)
    walked = [t for b in range(blocks) for t in range(b, tasks, blocks)]
    return zc, [(t % tiles // tiles_c * TM, t % tiles % tiles_c * g["TN"], t // tiles * zc)
                for t in walked]


def _stored(g, i0, j0, mr, nr):
    """The cell grid's stored cells of a task at (i0, j0): those of the
    groups (2 rows x a quad) inside the tile's columns, on rows inside the
    tile and the rounded interior, columns inside the rounded interior.
    Returns (rows, cols) masks over the cell grid."""
    r = torch.arange(g["GR"])
    c = torch.arange(g["GC"])
    rows = (r >= g["ER"]) & (r < g["ER"] + TM) & (i0 - g["ER"] + r < mr)
    gx = c // g["V"]
    cols = (gx >= g["EQ"]) & (gx < g["GX"] - g["EQ"]) & (j0 - g["EQ"] * g["V"] + c < nr)
    return rows, cols


def _terms(spec):
    """(class, column taps or None, row taps or None, z taps) of each term,
    centred in 2r + 1 as the kernel's parameters hold them."""
    r = spec.radius
    out = []
    for term in spec.terms:
        tz, rt, ct = term.taps

        def centred(t):
            if t is None:
                return None
            pad = r - (len(t) - 1) // 2
            return [0.0] * pad + [float(v) for v in t] + [0.0] * pad

        out.append((term_class(term), centred(ct), centred(rt), centred(tz)))
    return out


def _add(acc, v):
    return v if acc is None else acc + v


def _convs(terms, cls, P, R, g):
    """Each class-``cls`` term's in-plane conv at the cell grid, from planes
    P (tasks, GR + 2R, GC + 2V): the cell grid at rows R.., columns V..; per
    cell the twin's order (column conv, then row conv, zero taps skipped)."""
    V, GR, GC = g["V"], g["GR"], g["GC"]
    out = []
    for c, ct, rt, _ in terms:
        if c != cls:
            continue
        if ct is None:
            Y = P[:, :, V: V + GC]
        else:
            Y = None
            for b, w in enumerate(ct):
                if w != 0.0:
                    Y = _add(Y, w * P[:, :, V - R + b: V - R + b + GC])
            if Y is None:
                Y = torch.zeros_like(P[:, :, V: V + GC])
        if rt is None:
            Z = Y[:, R: R + GR]
        else:
            Z = None
            for a, w in enumerate(rt):
                if w != 0.0:
                    Z = _add(Z, w * Y[:, a: a + GR])
            if Z is None:
                Z = torch.zeros_like(Y[:, R: R + GR])
        out.append(Z)
    return out


def _mad(acc, w, x):
    """acc + w x, a zero tap skipped (the twin's order: product, then sum)."""
    return acc if w == 0.0 else _add(acc, w * x)


def _emulation(cur, donor, spec, layout, K, resident=RESIDENT, bounds=None):
    """A pass of K fused steps as csrc/stencil3d.cu's march_kernel runs it:
    the tasks of one plane count at once; at K = 2 level 1 masked to
    ``bounds`` (zlo, zhi, rlo, rhi, clo, chi: the kernel's second flag set in
    ``keep``), the last level to the interior."""
    R = spec.radius
    dtype = cur.dtype
    g = _geometry(dtype, R, K)
    V, GR, GC = g["V"], g["GR"], g["GC"]
    terms = _terms(spec)
    (zcls, _, _, tz), = [t for t in terms if t[0] != CENTRE]  # the z term
    # shared slots: the planes in flight and the one read, and with an
    # identity z term R more, which hold the cells of planes w - R .. w - 1
    extra = R if zcls != BUFFERED else 0
    in_slots, lv_slots = AHEAD + 1 + extra, 1 + extra
    h, m, n = layout.interior
    z0, r0, c0 = layout.origin
    _, mr, nr = layout.rounded
    zc, tasks = _tasks(layout, dtype, K, R, resident)
    # the buffer with zeros beyond it on every side, so that a window's cells
    # outside the buffer read 0 (buffer cell (0, 0, 0) at (pz, pr, pc))
    pz, pr, pc = K * R + 1, GR + 2 * R, GC + 3 * V
    wide = torch.nn.functional.pad(cur, (pc, GC + 3 * V, pr, GR + 2 * R, pz, zc + 2 * K * R))
    PR, PCOL = GR + 2 * R, GC + 2 * V
    for nin in sorted({min(zc, h - t[2]) + 2 * K * R for t in tasks}):
        group = [t for t in tasks if min(zc, h - t[2]) + 2 * K * R == nin]
        i0 = torch.tensor([t[0] for t in group])
        j0 = torch.tensor([t[1] for t in group])
        zb = torch.tensor([t[2] for t in group]) - K * R
        ii = (i0 - g["ER"])[:, None] + torch.arange(GR)[None, :]  # interior rows
        jj = (j0 - g["EQ"] * V)[:, None] + torch.arange(GC)[None, :]  # interior cols
        keep = (((ii >= 0) & (ii < m))[:, :, None] & ((jj >= 0) & (jj < n))[:, None, :])
        zlo, zhi, rlo, rhi, clo, chi = (0, h, 0, m, 0, n) if bounds is None else bounds
        keep_box = (((ii >= rlo) & (ii < rhi))[:, :, None]
                    & ((jj >= clo) & (jj < chi))[:, None, :])
        prow = (r0 + i0 - g["ER"] - R)[:, None] + torch.arange(PR)[None, :]
        pcol = (c0 + j0 - (g["EQ"] + 1) * V)[:, None] + torch.arange(PCOL)[None, :]

        def fetch(u):
            gz = z0 + zb + u
            return wide[(gz + pz)[:, None, None], (prow + pr)[:, :, None], (pcol + pc)[:, None, :]]

        def cells(plane):
            return plane[:, R: R + GR, V: V + GC]

        def level_step(plane, back, pend, held):
            """level_step: plane w's sum starts (centre convs, then the z taps
            of Y(w - R) .. Y(w)); each waiting sum takes its tap of Y(w), and
            the oldest, plane w - R's, is returned.  An identity term's
            Y(w - R) .. Y(w - 1) are the cells of the shared planes
            ``back``, a buffered term's the convs ``held``."""
            if zcls == BUFFERED:
                y, = _convs(terms, BUFFERED, plane, R, g)
            else:
                y = cells(plane)
            a = None
            for z in _convs(terms, CENTRE, plane, R, g):
                a = _add(a, z)
            for d in range(R):
                a = _mad(a, tz[d], held[d] if zcls == BUFFERED else cells(back[d]))
            a = _mad(a, tz[R], y)
            for k in range(R):
                pend[k] = _mad(pend[k], tz[2 * R - k], y)
            done = pend[0]
            pend[:] = pend[1:] + [torch.zeros_like(y) if a is None else a]
            held[:] = held[1:] + [y]
            return done

        def mask(v, val, box=False):
            z = (zb + v)[:, None, None]
            inside = (keep_box & (z >= zlo) & (z < zhi) if box
                      else keep & (z >= 0) & (z < h))
            return torch.where(inside, val, torch.zeros((), dtype=dtype))

        def store(v, val):
            for k in range(len(group)):
                rr, cc = _stored(g, int(i0[k]), int(j0[k]), mr, nr)
                gz = z0 + int(zb[k]) + v
                donor[gz, r0 + ii[k][rr][:, None], c0 + jj[k][cc][None, :]] = val[k][rr][:, cc]

        nan = torch.full((len(group), PR, PCOL), float("nan"), dtype=dtype)
        slots, lslots = [nan] * in_slots, [nan] * lv_slots
        zero = torch.zeros((len(group), GR, GC), dtype=dtype)
        state = [([zero] * R, [zero] * R) for _ in range(K)]  # (pend, held)
        for u in range(AHEAD):
            if u < nin:
                slots[u % in_slots] = fetch(u)
        for u in range(nin):
            if u + AHEAD < nin:
                slots[(u + AHEAD) % in_slots] = fetch(u + AHEAD)
            back = [slots[(u - R + d) % in_slots] for d in range(R)]
            lv = level_step(slots[u % in_slots], back, *state[0])
            if u < 2 * R:
                continue
            lv = mask(u - R, lv, box=K == 2)
            if K == 1:
                store(u - R, lv)
                continue
            # level 1's plane in shared memory; cells no group owns are NaN
            v1 = u - R
            plane = nan.clone()
            plane[:, R: R + GR, V: V + GC] = lv
            lslots[v1 % lv_slots] = plane
            back = [lslots[(v1 - R + d) % lv_slots] for d in range(R)]
            out = level_step(plane, back, *state[1])
            if u >= 4 * R:
                store(u - 2 * R, mask(u - 2 * R, out))
    return donor


def _layout(spec, interior, K, guard=None):
    return Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(*interior[1:]),
                    guard=guard or guard_3d(spec.halo, K * spec.radius))


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("interior", [(40, 40, 40), (37, 45, 130)], ids=["40^3", "37x45x130"])
@pytest.mark.parametrize("name", SHAPES_3D)
def test_march_emulation_equals_the_twin_bit_for_bit(name, interior, dtype, fill):
    spec = get_shape(name)
    for K in stencil3d.MARCH_DEPTHS:
        assert stencil3d.march_takes(spec, dtype, K)
        lay = _layout(spec, interior, K)
        g0 = reference.random_padded(spec, interior, seed=9)
        x = lay.to_internal(_fill(g0, fill), dtype)
        # one task a block (the card's residency), and a few blocks walking
        # many tasks
        for resident in (RESIDENT, 3):
            want = stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, K)
            got = _emulation(x, torch.zeros_like(x), spec, lay, K, resident)
            _same(got, want)
            if fill != "inf":
                assert bool(torch.isfinite(got).all())
        # a second pass, from the first's output
        _same(_emulation(got, torch.zeros_like(x), spec, lay, K),
              stencil3d.stencil3d_step_plain(got, torch.zeros_like(x), spec, lay, K))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("interior", [(256, 256, 256), (37, 45, 130), (6, 20, 150), (1, 32, 64),
                                      (300, 96, 320)])
@pytest.mark.parametrize("resident", [RESIDENT, 132, 528, 7, 1])
def test_march_tasks_store_every_output_cell_once(dtype, interior, resident):
    """Every cell of the rounded interior is stored by exactly one (task,
    thread) and no guard cell by any, at K = 1 and 2."""
    h = interior[0]
    for R in stencil3d.MARCH_RADII:
        spec = StencilSpec(name="r", ndim=3, radius=R, halo=(R, R, R), terms=(), residue=(),
                           fuse_factor=1)
        for K in (1, 2):
            lay = _layout(spec, interior, K)
            g = _geometry(dtype, R, K)
            zc, tasks = _tasks(lay, dtype, K, R, resident)
            assert len(tasks) == len(set(tasks))
            _, mr, nr = lay.rounded
            count = torch.zeros((mr, nr), dtype=torch.int64)
            planes = torch.zeros(h, dtype=torch.int64)
            for i0, j0, zs in tasks:
                if (i0, j0) == tasks[0][:2]:
                    planes[zs: min(zs + zc, h)] += 1
                if zs:
                    continue
                rr, cc = _stored(g, i0, j0, mr, nr)
                gr = i0 - g["ER"] + torch.arange(g["GR"])[rr]
                gc = j0 - g["EQ"] * g["V"] + torch.arange(g["GC"])[cc]
                assert gr.min() >= 0 and gc.min() >= 0
                count[gr[:, None], gc[None, :]] += 1
            assert bool((count == 1).all())
            assert bool((planes == 1).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_march_tasks_at_256_cubed(dtype):
    """At 256^3 the tasks fill the resident blocks once (one wave, at least
    nine tenths full) and the lookback costs at most 1/8 of a chunk, at the
    engine's depths: k = 2 (float32 and float64) and k = 1 (df64), at one
    and two blocks per SM."""
    spec = get_shape("star3d1r")
    for K in (1, 2):
        lay = _layout(spec, (256, 256, 256), K)
        for resident in (132, 264):
            zc, tasks = _tasks(lay, dtype, K, 1, resident)
            assert 0.9 * resident <= len(tasks) <= resident
            assert (zc + 2 * K) / zc <= 1.125


def test_march_recomputed_cells():
    """Level 1's cell grid over the stored tile: 1.195 at K = 2, r = 1, in
    either dtype (34 x 72 of 32 x 64 cells; 34 x 36 of 32 x 32); none at
    K = 1."""
    for dtype in DTYPES:
        g = _geometry(dtype, 1, 2)
        assert g["GR"] * g["GC"] / (TM * g["TN"]) == pytest.approx(1.1953125)
        g1 = _geometry(dtype, 1, 1)
        assert (g1["GR"], g1["GC"]) == (TM, g1["TN"])
        assert g["groups"] == 306 and g1["groups"] == 256


@pytest.mark.parametrize("dtype", DTYPES + [torch.float16])
@pytest.mark.parametrize("name", SHAPES_3D)
def test_march_dispatch_by_shape_dtype_and_depth(name, dtype):
    """Both registry shapes run the march kernel in float32 and float64 at
    one and two steps (every pass the engine launches for them); deeper
    passes and other dtypes do not."""
    spec = get_shape(name)
    for depth in (1, 2, 3, 4):
        want = dtype in DTYPES and depth in (1, 2)
        assert stencil3d.march_takes(spec, dtype, depth) == want


def _custom_3d(kinds, R, residue=()):
    """A 3-D spec of radius R whose terms are ``kinds``: "i" an identity-z
    term, "r" / "c" / "b" a centre term with a row / column / both convs,
    "B" a buffered term with both convs, "Bc" one with a column conv."""
    W = 2 * R + 1
    t = tuple(float(v) for v in range(1, W + 1))
    make = {"i": (t, None, None), "r": (None, t, None), "c": (None, None, t),
            "b": (None, t, t), "B": (t, t, t), "Bc": (t, None, t)}
    return StencilSpec(name=f"custom_{'_'.join(kinds)}_r{R}", ndim=3, radius=R,
                       halo=(R, R, R),
                       terms=tuple(SeparableTerm(taps=make[k]) for k in kinds),
                       residue=residue, fuse_factor=1)


def test_march_dispatch_takes_the_registry_mixes_at_any_taps():
    for kinds in (("i", "r", "c"), ("B",)):
        spec = _custom_3d(kinds, 1)
        assert all(stencil3d.march_takes(spec, d, k) for d in DTYPES for k in (1, 2))
    assert stencil3d.term_kinds(get_shape("star3d1r")) == stencil3d.MARCH_KINDS[0][1]
    assert stencil3d.term_kinds(get_shape("box3d1r")) == stencil3d.MARCH_KINDS[1][1]


@pytest.mark.parametrize("kinds,R,residue", [
    (("i", "r", "c"), 2, ()),                     # radius beyond the march kernel's
    (("B",), 2, ()),
    (("B",), 4, ()),
    (("B",), 1, (((1, 0, 0), 2.0),)),             # residue
    (("i", "r", "c"), 1, (((0, 1, 1), 1.0),)),
    (("i", "c", "r"), 1, ()),                     # another order of the terms
    (("i", "b"), 1, ()),                          # other term mixes
    (("Bc",), 1, ()),
    (("B", "B"), 1, ()),
    (("r",), 1, ()),
])
def test_march_dispatch_sends_the_rest_to_the_general_kernel(kinds, R, residue):
    spec = _custom_3d(kinds, R, residue)
    assert not any(stencil3d.march_takes(spec, d, k) for d in DTYPES for k in (1, 2, 3))


@pytest.mark.parametrize("name,dtype,k,march", [
    ("star3d1r", torch.float32, 2, True),   # the engine's default pass
    ("box3d1r", torch.float64, 1, True),    # df64
    ("box3d1r", torch.float64, 2, True),    # float64
    ("star3d1r", torch.float32, 4, False),  # deeper: the general kernel
    ("box3d1r", torch.float64, 3, False),
])
def test_kernel_pass_launches_the_march_kernel_by_the_rule(name, dtype, k, march, monkeypatch):
    """stencil3d_step's pass on the card sends a pass the rule takes to the
    march kernel and every other to the general kernel, one launch each;
    each launch replaced by the twin, the pass equals the twin."""
    spec = get_shape(name)
    lay = _layout(spec, (20, 40, 70), k)
    x = lay.to_internal(reference.random_padded(spec, (20, 40, 70), seed=4), dtype)
    launched = []

    def fake_march(cur, out, spec_, layout, depth, box):
        launched.append(("march", depth))
        return stencil3d.stencil3d_step_plain(cur, out, spec_, layout, depth, box)

    def fake_general(cur, out, spec_, layout, depth, tile, box):
        launched.append(("general", depth))
        return stencil3d.stencil3d_step_plain(cur, out, spec_, layout, depth, box)

    monkeypatch.setattr(stencil3d, "_launch_march", fake_march)
    monkeypatch.setattr(stencil3d, "_launch", fake_general)
    monkeypatch.setattr(stencil3d, "plan_pass", lambda spec_, depth, itemsize: (depth, (32, 64)))
    got = stencil3d._kernel_pass(x, torch.zeros_like(x), spec, lay, k)
    assert launched == [("march" if march else "general", k)]
    _same(got, stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, k))


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SHAPES_3D)
def test_march_emulation_with_ghost_bounds_equals_the_twin(name, dtype, boundary):
    """Under a ghost boundary (ROADMAP A6(a)) level 1 of a K = 2 pass keeps
    the box [-2, s + 2) per axis, which holds the ring the engine's refresh
    filled; level 2 keeps the interior.  Emulation and twin with the same
    bounds agree bit for bit on the pi/100 fill."""
    from lorastencil_tpu_torch.engine import _ring_refresh_nd

    spec = get_shape(name)
    interior, K = (12, 40, 70), 2
    lay = _layout(spec, interior, K)
    d = K * spec.radius
    bounds = tuple(v for s in interior for v in (-d, s + d))
    g0 = reference.random_padded(spec, interior, seed=10)
    for fill in ("pi",):
        x = _ring_refresh_nd(lay.to_internal(_fill(g0, fill), dtype), boundary, lay.origin,
                             lay.interior, d)
        want = stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, K, bounds)
        _same(_emulation(x, torch.zeros_like(x), spec, lay, K, bounds=bounds), want)
        assert not torch.equal(want, stencil3d.stencil3d_step_plain(
            x, torch.zeros_like(x), spec, lay, K))
