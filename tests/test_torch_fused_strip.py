"""The 2-D fused strip kernel (csrc/stencil2d.cu fused_strip_kernel): its
dispatch rule (ops/stencil2d.fused_strip_takes), its task plan, and a plain
PyTorch emulation of its traversal held against the plain twin it must equal
(ops/stencil2d.stencil2d_step_plain at the same depth).  CPU only; the kernel
itself is held against the twin, single strip steps and the tile-based fused
and skew kernels on the card by tests/test_torch_cuda.py.

What the emulation repeats: the launch's tasks (size_strips: a column strip's
share of the resident warps, each strip storing 128 - 8 (K - 1) columns, the
strips overlapping by 8 (K - 1)); per task the input rows i0 - KR .. in pairs,
zeros outside the buffer, a stale row past the task's last as NaN; level 1's
column convs of each input row into its ring at the kernel's index
(u + h) % Y, Y = 2R + 2; at each pair, level L's rows s + h - 2LR from its
ring at (u + h + 2L + q) % Y, masked to the interior; level L + 1's column
convs of those rows, the R cells beyond a lane's four taken from its
neighbours' (the cells missing at lanes 0 and 31 as NaN, so that a leak into
a stored cell shows), into the next ring at (u + h + 2L) % Y; level K's rows
stored from lanes K - 1 .. 32 - K.  Per cell the sums are the twin's: the
kernel fuses each multiply-add in fp32, the emulation takes the twin's
product then sum, so it checks the traversal, which is all the kernel
changes (the card tests hold the kernel bit for bit against the tile
kernels, whose fmaf chains it keeps).  Tolerance: none, in float32 and
float64, on the integer, pi/100 and inf fills (NaN where the twin has
NaN)."""

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec, get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.band_gemm import plan_array
from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d, guard_2d
from lorastencil_tpu_torch.utils import reference

SHAPES_2D = ["star2d1r", "box2d1r", "box2d3r", "star2d3r"]
DTYPES = [torch.float32, torch.float64]
FILLS = ["integer", "pi", "inf"]
STRIP_COLS = 128  # csrc/stencil2d.cu kStripCols: a warp's 32 lanes x 4
STRIP_WARPS = 4   # kStripWarps
MIN_ROWS = 32     # kStripMinRows
PAD = 4           # kStripPad: window columns each side of a warp's 128
RESIDENT = 264    # blocks an H100 holds at once at two per SM


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


def _custom_2d(R, kinds, seed):
    """A residue-free 2-D spec of radius R with a term of integer taps (zeros
    among them) per letter of ``kinds``: its row and column convs ("b"), its
    column conv alone ("c": the row axis the identity) or its row conv alone
    ("r")."""
    rng = np.random.default_rng(seed)
    W = 2 * R + 1

    def taps():
        t = rng.integers(-3, 4, W).astype(np.float64)
        t[rng.random(W) < 0.3] = 0.0
        t[0] = 1.0  # the full radius
        return tuple(float(v) for v in t)

    terms = tuple(SeparableTerm(taps=(None if k == "c" else taps(), None if k == "r" else taps()))
                  for k in kinds)
    return StencilSpec(name=f"custom_r{R}_{kinds}", ndim=2, radius=R, halo=(R, R),
                       terms=terms, residue=(), fuse_factor=1)


# every kind of term alone and beside another (star2d3r is "rc")
CUSTOM = [(1, "b"), (2, "bc"), (3, "r"), (4, "bc"), (2, "c"), (3, "cr"), (1, "rb")]
CASES = ["star2d3r"] + [f"r{R}{kinds}" for R, kinds in CUSTOM]


def _spec(case):
    if case in SHAPES_2D:
        return get_shape(case)
    return _custom_2d(int(case[1]), case[2:], seed=int(case[1]) + len(case))


def _layout(spec, interior, K, guard=None):
    return Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                    guard=guard or guard_2d(spec.halo, K * spec.radius))


def _tasks(mr, nr, K, resident=RESIDENT):
    """[(i0, n_out, j0)] of one launch, as csrc/stencil2d.cu size_strips sizes
    them and fused_strip_kernel's warps walk them (task w, w + the launch's
    warps, ...), in the order the warps take them."""
    out_cols = STRIP_COLS - 8 * (K - 1)
    col_tasks = -(-nr // out_cols)
    share = max(resident * STRIP_WARPS // col_tasks, 1)
    rows = max(-(-mr // share), MIN_ROWS)
    tasks = col_tasks * -(-mr // rows)
    blocks = min(-(-tasks // STRIP_WARPS), resident)
    walked = [t for w in range(blocks * STRIP_WARPS)
              for t in range(w, tasks, blocks * STRIP_WARPS)]
    return [(t // col_tasks * rows, min(rows, mr - t // col_tasks * rows),
             t % col_tasks * out_cols) for t in walked]


def _plan(spec, dtype):
    """plan_array parsed as csrc/stencil2d.cu fill_strip_plan parses it."""
    W = 2 * spec.radius + 1
    vals = plan_array(spec, dtype).tolist()
    terms = []
    for _ in spec.terms:
        terms.append((vals[0] != 0.0, vals[1] != 0.0, vals[2: 2 + W], vals[2 + W: 2 + 2 * W]))
        vals = vals[2 + 2 * W:]
    assert not vals  # no residue
    return terms


def _column_convs(terms, x, R):
    """Every term's column conv of the warps' 136-cell windows (the 128 cells
    of each warp and PAD each side; a warp per row of ``x``)."""
    out = []
    for has_col, _, ct, _ in terms:
        if has_col:
            y = torch.zeros(x.shape[0], STRIP_COLS, dtype=x.dtype)
            for q, w in enumerate(ct):
                if w != 0.0:
                    y = y + w * x[:, PAD - R + q: PAD - R + q + STRIP_COLS]
        else:
            y = x[:, PAD: PAD + STRIP_COLS]
        out.append(y)
    return out


def _emulation(cur, donor, spec, layout, K, resident=RESIDENT, bounds=None):
    """A pass of K fused steps as csrc/stencil2d.cu's fused_strip_kernel runs
    it: the tasks of one row count at once, a warp's 128 columns per task;
    the levels before the last masked to ``bounds`` (rlo, rhi, clo, chi),
    compared per cell as the kernel does, the last to the interior."""
    terms = _plan(spec, cur.dtype)
    R = spec.radius
    Y = 2 * R + 2
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    rlo, rhi, clo, chi = (0, m, 0, n) if bounds is None else bounds
    zero = torch.zeros((), dtype=cur.dtype)
    lanes = torch.arange(STRIP_COLS + 2 * PAD)
    # the buffer with zeros beyond its columns, so that a window's cells
    # outside the buffer read 0 (column `left` is buffer column 0)
    left = PAD + 4 * (K - 1)
    wide = torch.nn.functional.pad(cur, (left, STRIP_COLS + 2 * PAD))
    tasks = _tasks(mr, nr, K, resident)
    for n_out in sorted({t[1] for t in tasks}):
        i0 = torch.tensor([t[0] for t in tasks if t[1] == n_out])
        jw = torch.tensor([t[2] for t in tasks if t[1] == n_out]) - 4 * (K - 1)
        n_in = n_out + 2 * K * R
        cells = torch.arange(STRIP_COLS)  # a warp's: lane l holds 4 l .. 4 l + 3
        cols = jw[:, None] + cells[None, :]  # their interior columns
        col_in = (cols >= 0) & (cols < n)
        nan = torch.full((len(i0), PAD), float("nan"), dtype=cur.dtype)

        def input_rows(s):
            """The ring row of input row s of every task: buffer columns from
            c0 + jw - PAD, zero outside the buffer; NaN past the task's rows
            (a stale slot)."""
            if s >= n_in:
                return torch.full((len(i0), STRIP_COLS + 2 * PAD), float("nan"),
                                  dtype=cur.dtype)
            gr = r0 + i0 - K * R + s  # < rows: the guard covers K R
            return wide[gr[:, None], left + c0 + jw[:, None] - PAD + lanes[None, :]]

        ring = [[None] * Y for _ in range(K)]
        for s0 in range(0, n_in, Y):
            for u in range(0, Y, 2):
                s = s0 + u
                if s >= n_in:
                    break
                for h in (0, 1):
                    ring[0][(u + h) % Y] = _column_convs(terms, input_rows(s + h), R)
                v = [None, None]
                for L in range(1, K + 1):
                    if L > 1:  # level L - 1 yielded rows: their column convs
                        for h in (0, 1):
                            x = torch.cat([nan, v[h], nan], 1)  # the lane hand-off
                            ring[L - 1][(u + h + 2 * (L - 1)) % Y] = _column_convs(terms, x, R)
                    if s < 2 * L * R:
                        break
                    for h in (0, 1):
                        acc = torch.zeros(len(i0), STRIP_COLS, dtype=cur.dtype)
                        for t, (_, has_row, _, rt) in enumerate(terms):
                            if has_row:
                                z = torch.zeros_like(acc)
                                for q, w in enumerate(rt):
                                    if w != 0.0:
                                        z = z + w * ring[L - 1][(u + h + 2 * L + q) % Y][t]
                            else:
                                z = ring[L - 1][(u + h + 2 * L + R) % Y][t]
                            acc = acc + z
                        i = i0 - K * R + s + h - L * R  # interior row
                        if L == K:
                            keep = col_in & ((i >= 0) & (i < m))[:, None]
                        else:  # Grid2D's box
                            keep = (((cols >= clo) & (cols < chi))
                                    & ((i >= rlo) & (i < rhi))[:, None])
                        v[h] = torch.where(keep, acc, zero)
                if s < 2 * K * R:
                    continue
                lo = 4 * (K - 1)  # lanes K - 1 .. 32 - K store
                store = (cols < nr) & ((cells >= lo) & (cells < STRIP_COLS - lo))[None, :]
                for h in (0, 1):
                    o = s + h - 2 * K * R
                    if o >= n_out:
                        continue
                    gr = (r0 + i0 + o)[:, None].expand(-1, STRIP_COLS)
                    donor[gr[store], (c0 + cols)[store]] = v[h][store]
    return donor


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("interior,guard", [
    ((300, 140), None),  # ragged rows and columns, two strips
    ((70, 131), (8, 9)),  # a guard off the 16-byte grid
    ((37, 45), None),     # narrower than one strip
], ids=["300x140", "70x131-guard-8-9", "37x45"])
@pytest.mark.parametrize("case", CASES)
def test_fused_strip_emulation_equals_the_twin_bit_for_bit(case, interior, guard, dtype, fill):
    spec = _spec(case)
    for K in stencil2d.FUSED_STRIP_DEPTHS:
        assert stencil2d.fused_strip_takes(spec, torch.float32, K)
        lay = _layout(spec, interior, K, guard)
        g0 = reference.random_padded(spec, interior, seed=8)
        x = lay.to_internal(_fill(g0, fill), dtype)
        # tasks of 32 rows, and (small grids) two tasks a strip
        for resident in (RESIDENT,) if interior[0] > 100 else (RESIDENT, 1):
            want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, K)
            got = _emulation(x, torch.zeros_like(x), spec, lay, K, resident)
            _same(got, want)
            if fill != "inf":
                assert bool(torch.isfinite(got).all())
            # a second pass, from the first's output
            _same(_emulation(got, torch.zeros_like(x), spec, lay, K, resident),
                  stencil2d.stencil2d_step_plain(got, torch.zeros_like(x), spec, lay, K))


@pytest.mark.parametrize("mr,nr", [(8192, 8192), (300, 144), (32, 128), (1000, 1000),
                                   (65, 4), (4096, 120), (4096, 121)])
@pytest.mark.parametrize("resident", [RESIDENT, 132, 7, 1])
def test_fused_strip_tasks_cover_every_output_cell_once(mr, nr, resident):
    """Each task stores a rectangle, rows [i0, i0 + n_out) x columns [j0,
    j0 + 128 - 8 (K - 1)) cut at nr: the launch's tasks are every pair of a
    row interval and a column interval, once each, and the intervals tile
    [0, mr) and [0, nr)."""
    def tiles(intervals, size):
        edges = sorted(intervals)
        return edges[0][0] == 0 and edges[-1][1] == size and all(
            a[1] == b[0] for a, b in zip(edges, edges[1:]))

    for K in stencil2d.FUSED_STRIP_DEPTHS:
        out_cols = STRIP_COLS - 8 * (K - 1)
        tasks = _tasks(mr, nr, K, resident)
        row_iv = {(i0, i0 + n_out) for i0, n_out, _ in tasks}
        col_iv = {(j0, min(j0 + out_cols, nr)) for _, _, j0 in tasks}
        assert all(j0 % 4 == 0 for _, _, j0 in tasks)  # 16-byte stores
        assert len(tasks) == len(set(tasks)) == len(row_iv) * len(col_iv)
        assert tiles(row_iv, mr) and tiles(col_iv, nr)


def test_fused_strip_tasks_at_8192_squared():
    """star2d3r 8192^2 at k = 2: 69 strips of 120 columns, tasks of ~540 rows,
    so level 1 recomputes ~6.7% of its columns and ~1% of its rows."""
    tasks = _tasks(8192, 8192, 2)
    assert len({j0 for _, _, j0 in tasks}) == 69
    rows = max(n_out for _, n_out, _ in tasks)
    assert 500 <= rows <= 560
    assert len(tasks) <= RESIDENT * STRIP_WARPS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SHAPES_2D)
def test_fused_strip_dispatch_by_shape_dtype_and_depth(name, dtype):
    """Only star2d3r among the registry shapes (two terms, no residue) runs
    the fused strip kernel, and only in float32 at two steps; star2d1r
    (residue) and the box shapes (three terms) keep the tile kernels."""
    spec = get_shape(name)
    for depth in (1, 2, 3, 4):
        want = name == "star2d3r" and dtype == torch.float32 and depth == 2
        assert stencil2d.fused_strip_takes(spec, dtype, depth) == want


def test_fused_strip_dispatch_refuses_radius_terms_and_residue():
    assert all(stencil2d.fused_strip_takes(_custom_2d(R, kinds, 1), torch.float32, 2)
               for R, kinds in CUSTOM)
    assert not stencil2d.fused_strip_takes(_custom_2d(5, "b", 1), torch.float32, 2)
    three = _custom_2d(2, "bcr", 1)
    assert not stencil2d.fused_strip_takes(three, torch.float32, 2)
    none = StencilSpec(name="none", ndim=2, radius=2, halo=(2, 2), terms=(), residue=(),
                       fuse_factor=1)
    assert not stencil2d.fused_strip_takes(none, torch.float32, 2)
    centre = StencilSpec(name="centre", ndim=2, radius=2, halo=(2, 2),
                         terms=_custom_2d(2, "c", 1).terms + (SeparableTerm(taps=(None, None)),),
                         residue=(), fuse_factor=1)
    assert not stencil2d.fused_strip_takes(centre, torch.float32, 2)
    res = _custom_2d(2, "b", 1)
    res = StencilSpec(name="res", ndim=2, radius=2, halo=(2, 2), terms=res.terms,
                      residue=(((1, 0), 2.0),), fuse_factor=1)
    assert not stencil2d.fused_strip_takes(res, torch.float32, 2)


@pytest.mark.parametrize("kind", ["step", "skew"])
@pytest.mark.parametrize("name,dtype,k,want", [
    ("star2d3r", torch.float32, 2, "fused_strip"),  # the engine's default pass
    ("star2d3r", torch.float64, 2, None),           # the tile kernels
    ("box2d3r", torch.float32, 2, None),            # three terms
    ("star2d1r", torch.float32, 2, None),           # residue
    ("star2d3r", torch.float32, 3, None),           # k = 3
])
def test_split_pass_launches_the_fused_strip_kernel_by_the_rule(kind, name, dtype, k, want,
                                                                 monkeypatch):
    """_split_pass sends a pass the rule takes to the fused strip kernel
    ("fused_strip") and every other pass to the plan strip kernel
    ("plan_strip"), from either wrapper, each launch counted on the wrapper
    of its pass (``_launch``'s ``wrapper``).  The pass keeps a shard's ring (a box past the
    interior, no refresh), which holds it to one launch whatever the rule
    of strip launches (tests/test_torch_plan_kernels.py holds that rule);
    each launch replaced by the twin, the pass equals the unsplit twin."""
    spec = get_shape(name)
    lay = _layout(spec, (37, 45), k)
    x = lay.to_internal(reference.random_padded(spec, (37, 45), seed=4) % 2, dtype)
    kinds = []

    def fake_launch(kind_, buffers, spec_, layout, depth, bounds=None, wrapper=None):
        kinds.append((kind_, wrapper))
        stencil2d.stencil2d_step_plain(*buffers, spec_, layout, depth, bounds)

    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    r = spec.radius
    ring = (-r, 37 + r, -r, 45 + r)
    got = stencil2d._split_pass(kind, x, torch.zeros_like(x), spec, lay, k, ring)
    expect = want or "plan_strip"
    wrapper = stencil2d.stencil2d_skew_step if kind == "skew" else stencil2d.stencil2d_step
    assert kinds == [(expect, wrapper)]
    assert stencil2d._ENTRIES[expect][dtype]
    _same(got, stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k, ring))


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("fill", ["integer", "pi"])
@pytest.mark.parametrize("interior", [(70, 140), (37, 45)], ids=["70x140", "37x45"])
@pytest.mark.parametrize("case", CASES)
def test_fused_strip_emulation_with_ghost_bounds_equals_the_twin(case, interior, fill,
                                                                 boundary):
    """Under a ghost boundary (ROADMAP A6(a)) level 1 keeps the box [-d, m +
    d) x [-d, n + d), d = K R, which holds the ring the engine's refresh
    filled; level K keeps the interior.  The emulation equals the twin with
    the same bounds bit for bit, on a buffer whose ring is filled."""
    from lorastencil_tpu_torch.engine import _ring_refresh_nd

    spec = _spec(case)
    for K in stencil2d.FUSED_STRIP_DEPTHS:
        lay = _layout(spec, interior, K)
        d = K * spec.radius
        g0 = reference.random_padded(spec, interior, seed=9)
        x = _ring_refresh_nd(lay.to_internal(_fill(g0, fill)), boundary, lay.origin,
                             lay.interior, d)
        bounds = (-d, interior[0] + d, -d, interior[1] + d)
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, K, bounds)
        _same(_emulation(x, torch.zeros_like(x), spec, lay, K, bounds=bounds), want)
        # the bounds matter: without them the ring is zeroed at level 1
        assert not torch.equal(want, stencil2d.stencil2d_step_plain(
            x, torch.zeros_like(x), spec, lay, K))
