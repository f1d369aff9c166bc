"""The 2-D float64 strip kernel (csrc/stencil2d.cu strip64_kernel): its
dispatch rule (ops/stencil2d.strip_takes on float64), the plan its launch
copies from host memory, its task plan, and a plain PyTorch emulation of its
traversal held against the plain twin it must equal (ops/stencil2d.
stencil2d_step_plain).  CPU only, no JAX; the kernel itself is held against
the float64 tile kernel and the twin on the card by tests/test_torch_cuda.py
and chip_smoke.py.

What the emulation repeats: the launch's tasks (size_strips: a column strip's
share of the resident warps, each strip storing 64 columns, two cells per
lane); per task the input rows i0 - R .. in pairs, each copied into a ring of
16 row slots six rows ahead of the pair that reads it, zeros outside the
buffer, slots never written as NaN; each term's column conv of both rows of
the pair into a register ring of Y = 2R + 2 rows at index (u + h) % Y; the
row conv of output rows s + h - 2R from that ring at (u + h + 2 + q) % Y; the
sum over terms from 0; the residue point by point, each point's two cells
taken from the aligned 16-byte pairs of its ring row (one pair, or at an odd
offset the two around them); the masks and the stores of columns below the
rounded interior.  The kernel rounds each product and sum on its own, in the
twin's order, so the emulation and the twin agree bit for bit.  Tolerance:
none, on the integer, pi/100 and inf fills (NaN where the twin has NaN)."""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec, get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.band_gemm import plan_array
from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d, guard_2d
from lorastencil_tpu_torch.utils import reference

F64 = torch.float64
SHAPES_2D = ["star2d1r", "box2d1r", "box2d3r", "star2d3r"]
FILLS = ["integer", "pi", "inf"]
STRIP_COLS = 64   # csrc/stencil2d.cu kStrip64Cols: 32 lanes x 2 cells
STRIP_WARPS = 4   # kStripWarps
MIN_ROWS = 32     # kStripMinRows
PAD = 4           # kStripPad: window columns each side of a warp's 64
WINDOW = STRIP_COLS + 2 * PAD
RING = 16         # kStripRing: row slots of a warp's shared ring
AHEAD = 6         # kStripAhead: rows copied ahead of the pair read
SMS = 132         # an H100's SMs


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


def _custom_2d(R, n_terms, n_res, seed):
    """A 2-D spec of radius R: ``n_terms`` terms of integer taps (zeros among
    them, the second term's row axis and the third's column axis the
    identity) and ``n_res`` residue points in no particular order."""
    rng = np.random.default_rng(seed)
    W = 2 * R + 1

    def taps():
        t = rng.integers(-3, 4, W).astype(np.float64)
        t[rng.random(W) < 0.3] = 0.0
        return tuple(float(v) for v in t)

    terms = tuple(SeparableTerm(taps=(None if i == 1 else taps(), None if i == 2 else taps()))
                  for i in range(n_terms))
    points = [(int(a), int(b)) for a, b in rng.integers(-R, R + 1, (n_res, 2))]
    residue = tuple((p, float(rng.integers(-3, 4) or 1)) for p in points)
    return StencilSpec(name=f"custom_r{R}_t{n_terms}", ndim=2, radius=R, halo=(R, R),
                       terms=terms, residue=residue, fuse_factor=1)


# (radius, terms, residue points): every radius, every term count
CUSTOM = [(1, 1, 3), (2, 2, 0), (3, 3, 4), (4, 3, 9), (4, 0, 5), (1, 2, 2)]
CASES = SHAPES_2D + [f"r{R}t{t}e{e}" for R, t, e in CUSTOM]


def _spec(case):
    if case in SHAPES_2D:
        return get_shape(case)
    R, t, e = (int(v) for v in case[1:].replace("t", " ").replace("e", " ").split())
    return _custom_2d(R, t, e, seed=R * 10 + t)


def _layout(spec, interior, guard=None):
    return Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                    guard=guard or guard_2d(spec.halo, spec.radius))


# -- (a) the dispatch rule ----------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_float64_steps_of_radius_1_to_4_and_3_terms_take_the_strip_kernel(case):
    spec = _spec(case)
    assert stencil2d.strip_takes(spec, F64)
    assert stencil2d.strip_takes(spec, F64, depth=1)
    for depth in (2, 3, 4):
        assert not stencil2d.strip_takes(spec, F64, depth=depth)


def test_float64_strip_dispatch_refuses_radius_5_and_four_terms():
    assert not stencil2d.strip_takes(_custom_2d(5, 1, 2, seed=1), F64)
    three = _custom_2d(2, 3, 1, seed=3)
    four = StencilSpec(name="four", ndim=2, radius=2, halo=(2, 2),
                       terms=three.terms + three.terms[:1], residue=(), fuse_factor=1)
    assert not stencil2d.strip_takes(four, F64)
    assert not stencil2d.strip_takes(get_shape("star2d1r"), torch.float16)


@pytest.mark.parametrize("kind,k,want", [
    ("step", 1, ["strip"]),   # a single step, either dtype
    ("step", None, None),     # past one launch's depth: k_max, then the leftover step
    ("skew", None, None),
])
def test_split_pass_sends_float64_single_steps_to_the_strip_kernel(kind, k, want,
                                                                   monkeypatch):
    """_split_pass runs each single float64 step (a k = 1 pass, or a pass
    deeper than one launch of the tile kernels takes) on the strip kernel:
    the deeper launches of a spec whose steps the strip kernel takes run as
    single strip launches (``strips_beat_plan``), counted on the pass's
    wrapper; each launch replaced by the twin, the pass equals the unsplit
    twin."""
    spec = get_shape("box2d3r")
    if k is None:
        k = stencil2d.max_fused_steps(kind, spec.radius, stencil2d.plan_len(spec), F64) + 1
        want = ["strip"] * k
    lay = _layout(spec, (37, 45), guard=guard_2d(spec.halo, k * spec.radius))
    x = lay.to_internal(reference.random_padded(spec, (37, 45), seed=4) % 2, F64)
    kinds = []

    def fake_launch(kind_, buffers, spec_, layout, depth, bounds=None, wrapper=None):
        kinds.append(kind_)
        wrappers.add(wrapper)
        stencil2d.stencil2d_step_plain(*buffers, spec_, layout, depth, bounds)

    wrappers = set()
    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    got = stencil2d._split_pass(kind, x, torch.zeros_like(x), spec, lay, k)
    assert kinds == want
    assert wrappers == {stencil2d.stencil2d_skew_step if kind == "skew"
                        else stencil2d.stencil2d_step}
    _same(got, stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k))


# -- (b) the plan the launch copies --------------------------------------------
def test_float64_launch_copies_the_float64_plan_from_host_memory(monkeypatch):
    """The float64 strip launch passes ``plan_array(spec, float64)`` in host
    memory, a tap of 0.1 (which float32 cannot hold) exactly, to the entry
    ls_stencil2d_strip_f64, and counts one launch in launches_f64 and in
    launches_k1."""
    tenth = (0.1, -0.25, 1.0 / 3.0)
    spec = StencilSpec(name="tenth", ndim=2, radius=1, halo=(1, 1),
                       terms=(SeparableTerm(taps=(tenth, tenth[::-1])),),
                       residue=(((1, -1), 0.1),), fuse_factor=1)
    want = plan_array(spec, F64)
    assert want.dtype == F64 and 0.1 in want.tolist()
    assert float(np.float32(0.1)) != 0.1
    host = stencil2d._plan_host(spec, F64)
    assert host.dtype == F64 and host.device.type == "cpu"
    assert torch.equal(host, want)
    seen = {}

    def entry(name):
        def call(cur, donor, plan, plan_len, *rest):
            seen[name] = list((ctypes.c_double * plan_len).from_address(plan))
            return 0
        return call

    monkeypatch.setattr(stencil2d, "_lib",
                        lambda: types.SimpleNamespace(
                            ls_stencil2d_strip_f64=entry("ls_stencil2d_strip_f64")))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    lay = _layout(spec, (40, 70))
    x = torch.zeros(lay.shape, dtype=F64)
    step = stencil2d.stencil2d_step
    before = (step.launches, step.launches_f64, step.launches_k1)
    stencil2d._launch("strip", (x, torch.zeros_like(x)), spec, lay, 1)
    assert (step.launches - before[0], step.launches_f64 - before[1],
            step.launches_k1 - before[2]) == (0, 1, 1)
    assert seen == {"ls_stencil2d_strip_f64": want.tolist()}


# -- (c) the task plan -----------------------------------------------------------
def _tasks(mr, nr, resident):
    """[(i0, n_out, j0)] of one launch, as csrc/stencil2d.cu size_strips sizes
    them for 64-column strips and strip64_kernel's warps walk them (task w,
    w + the launch's warps, ...), in the order the warps take them."""
    col_tasks = -(-nr // STRIP_COLS)
    share = max(resident * STRIP_WARPS // col_tasks, 1)
    rows = max(-(-mr // share), MIN_ROWS)
    tasks = col_tasks * -(-mr // rows)
    blocks = min(-(-tasks // STRIP_WARPS), resident)
    walked = [t for w in range(blocks * STRIP_WARPS)
              for t in range(w, tasks, blocks * STRIP_WARPS)]
    return [(t // col_tasks * rows, min(rows, mr - t // col_tasks * rows),
             t % col_tasks * STRIP_COLS) for t in walked]


@pytest.mark.parametrize("mr,nr", [(8192, 8192), (4096, 4096), (1024, 1024), (160, 256),
                                   (32, 128), (1000, 1000), (65, 4), (4096, 122)])
@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
def test_strip64_tasks_store_every_output_cell_once(mr, nr, per_sm):
    """Each task stores rows [i0, i0 + n_out) x columns [j0, j0 + 64) cut at
    nr: the launch's tasks are every pair of a row interval and a column
    interval, once each, and the intervals tile [0, mr) and [0, nr)."""
    def tiles(intervals, size):
        edges = sorted(intervals)
        return edges[0][0] == 0 and edges[-1][1] == size and all(
            a[1] == b[0] for a, b in zip(edges, edges[1:]))

    tasks = _tasks(mr, nr, per_sm * SMS)
    row_iv = {(i0, i0 + n_out) for i0, n_out, _ in tasks}
    col_iv = {(j0, min(j0 + STRIP_COLS, nr)) for _, _, j0 in tasks}
    assert all(j0 % 2 == 0 for _, _, j0 in tasks)  # 16-byte stores
    assert len(tasks) == len(set(tasks)) == len(row_iv) * len(col_iv)
    assert tiles(row_iv, mr) and tiles(col_iv, nr)
    assert len(tasks) <= per_sm * SMS * STRIP_WARPS  # one wave


def test_strip64_tasks_at_8192_and_4096_squared():
    """star2d1r's instance (126 registers on an H100) runs four blocks per
    SM: 8192^2 in 128 strips of 512 rows; box2d3r's three (its launch
    bound): 4096^2 in 64 strips of 171 rows, 1536 tasks, one wave."""
    tasks = _tasks(8192, 8192, 4 * SMS)
    assert len({j0 for _, _, j0 in tasks}) == 128
    assert max(n for _, n, _ in tasks) == 512
    tasks = _tasks(4096, 4096, 3 * SMS)
    assert len(tasks) == 1536 and max(n for _, n, _ in tasks) == 171
    assert len(tasks) <= 3 * SMS * STRIP_WARPS


# -- (d) the traversal ---------------------------------------------------------
def _plan(spec):
    """plan_array parsed as csrc/stencil2d.cu fill_strip_plan parses it: per
    term (has_col, has_row, col taps, row taps), and (dr, dc, w) a point."""
    W = 2 * spec.radius + 1
    vals = plan_array(spec, F64).tolist()
    terms = []
    for _ in spec.terms:
        terms.append((vals[0] != 0.0, vals[1] != 0.0, vals[2: 2 + W], vals[2 + W: 2 + 2 * W]))
        vals = vals[2 + 2 * W:]
    res = [(int(vals[3 * p]), int(vals[3 * p + 1]), vals[3 * p + 2])
           for p in range(len(spec.residue))]
    return terms, res


def _emulation(cur, donor, spec, layout, resident):
    """One float64 step as csrc/stencil2d.cu's strip64_kernel runs it: the
    tasks of one row count at once, a warp's 64 columns per task."""
    terms, res = _plan(spec)
    R = spec.radius
    W, Y = 2 * R + 1, 2 * R + 2
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    zero = torch.zeros((), dtype=F64)
    # the buffer with zero columns beyond it: window column 0 of a task at
    # buffer column c0 + j0 - PAD, which is column `left` + that here
    left = PAD
    wide = torch.nn.functional.pad(cur, (left, WINDOW))
    cells = torch.arange(STRIP_COLS)  # lane l holds cells 2 l, 2 l + 1
    lanes = torch.arange(WINDOW)
    tasks = _tasks(mr, nr, resident)
    for n_out in sorted({t[1] for t in tasks}):
        i0 = torch.tensor([t[0] for t in tasks if t[1] == n_out])
        j0 = torch.tensor([t[2] for t in tasks if t[1] == n_out])
        n_in = n_out + 2 * R
        cols = j0[:, None] + cells[None, :]  # interior columns of the warp
        ring = [torch.full((len(i0), WINDOW), float("nan"), dtype=F64)
                for _ in range(RING)]  # never-written slots: NaN

        def fetch(s):
            if s < n_in:
                gr = r0 + i0 - R + s  # inside the buffer: the guard covers R
                ring[s % RING] = wide[gr[:, None], left + c0 + j0[:, None] - PAD + lanes[None, :]]

        def pairs(row, dc):
            """The residue point's two cells per lane from the aligned pairs of a
            ring row: pair (PAD + dc) / 2 + l, or at an odd dc the .y of pair
            (PAD + dc - 1) / 2 + l and the .x of the next."""
            p = row.reshape(len(i0), WINDOW // 2, 2)
            a = p[:, (PAD + dc - (dc & 1)) // 2 + torch.arange(32)]
            if dc % 2 == 0:
                return a.reshape(len(i0), STRIP_COLS)
            b = p[:, (PAD + dc + 1) // 2 + torch.arange(32)]
            return torch.stack([a[..., 1], b[..., 0]], -1).reshape(len(i0), STRIP_COLS)

        for s in range(AHEAD):
            fetch(s)
        y = [[torch.zeros(len(i0), STRIP_COLS, dtype=F64)] * Y for _ in terms]
        for s0 in range(0, n_in, Y):
            for u in range(0, Y, 2):
                s = s0 + u
                if s >= n_in:
                    break
                fetch(s + AHEAD)
                fetch(s + AHEAD + 1)
                for h in (0, 1):
                    x = ring[(s + h) % RING]  # a stale slot past n_in
                    for t, (has_col, _, ct, _) in enumerate(terms):
                        if has_col:
                            acc = torch.zeros(len(i0), STRIP_COLS, dtype=F64)
                            for q, w in enumerate(ct):
                                if w != 0.0:
                                    acc = acc + w * x[:, PAD - R + q: PAD - R + q + STRIP_COLS]
                        else:
                            acc = x[:, PAD: PAD + STRIP_COLS]
                        y[t][(u + h) % Y] = acc
                if s + 1 < 2 * R:
                    continue
                for h in (0, 1):
                    acc = torch.zeros(len(i0), STRIP_COLS, dtype=F64)
                    for t, (_, has_row, _, rt) in enumerate(terms):
                        if has_row:
                            z = torch.zeros_like(acc)
                            for q, w in enumerate(rt):
                                if w != 0.0:
                                    z = z + w * y[t][(u + h + 2 + q) % Y]
                        else:
                            z = y[t][(u + h + 2 + R) % Y]
                        acc = acc + z
                    for dr, dc, w in res:  # the plan's order
                        acc = acc + w * pairs(ring[(s - R + dr + h) % RING], dc)
                    o = s + h - 2 * R  # output row of the task
                    if o >= n_out:
                        continue
                    i = i0 + o
                    keep = (i < m)[:, None] & (cols < n)
                    acc = torch.where(keep, acc, zero)
                    store = cols < nr
                    gr = (r0 + i)[:, None].expand(-1, STRIP_COLS)
                    donor[gr[store], (c0 + cols)[store]] = acc[store]
    return donor


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("interior,guard", [
    ((96, 256), None),    # 16-byte copies, four strips
    ((130, 131), (5, 7)),  # a guard off the 16-byte grid: 8-byte copies
    ((37, 45), None),     # narrower than one strip
], ids=["96x256", "130x131-guard-5-7", "37x45"])
@pytest.mark.parametrize("case", CASES)
def test_strip64_emulation_equals_the_twin_bit_for_bit(case, interior, guard, fill):
    spec = _spec(case)
    assert stencil2d.strip_takes(spec, F64)
    lay = _layout(spec, interior, guard)
    g0 = reference.random_padded(spec, interior, seed=8)
    x = lay.to_internal(_fill(g0, fill), F64)
    # tasks of 32 rows (one row count or two); one block: tasks of a warp in turn
    for resident in (2 * SMS, 1):
        cur = x
        for _ in range(2):  # two steps, the second from the first's output
            want = stencil2d.stencil2d_step_plain(cur, torch.zeros_like(cur), spec, lay)
            got = _emulation(cur, torch.zeros_like(cur), spec, lay, resident)
            _same(got, want)
            if fill != "inf":
                assert bool(torch.isfinite(got).all())
            cur = got
