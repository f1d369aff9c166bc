"""The shared-memory resident kernel (csrc/resident2d.cu resident_smem_kernel):
its block ownership (a mirror of the launcher's partition and the kernel's
rectangles), its capacity rule (resident_capacity_bytes), its tasks,
and a plain PyTorch emulation of a run held against the plain twins it must
equal (ops/stencil2d.stencil2d_resident_plain and single stencil2d_step calls).
CPU only, no JAX; the kernel itself is held against the strip kernel, csrc/
stencil2d.cu's resident kernel and the twin on the card by tests/
test_torch_cuda.py and chip_smoke.py.

What the emulation repeats: each block's two windows (its rectangle and the
R-wide ring), the first read from the input buffer and the second NaN until
written; per step the cells within R of the rectangle's border first, sent to
the exchange buffer of the step's parity with the state's number as their tag,
then the next step's inner cells from a window whose ring is NaN (they need
none), then the ring polled from the exchange until every cell carries the
state awaited (0 outside the rounded interior); per cell the column conv of
every window row, then the row conv, taps in ascending offset and zero taps
skipped, the sum over terms from 0, the residue point by point, the mask; the
last step's rectangle written whole.  The blocks run as coroutines in a
random order that each poll constrains: a ring cell of a newer state fails the
test, so the two parities are shown to suffice.  The kernel rounds
each float64 product and sum on its own, as the emulation and the twin do; in
float32 it fuses each multiply-add, where the emulation takes the twin's
arithmetic (the product rounded).  So emulation and twins agree bit for bit:
the tests take the 0..99 fill in float32 and the pi/100 fill in float64."""

import random

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.band_gemm import plan_array
from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d, guard_2d
from lorastencil_tpu_torch.utils import reference

SHAPES_2D = ["star2d1r", "box2d1r", "box2d3r", "star2d3r"]
THREADS = 384  # csrc/resident2d.cu kThreads
WINDOW = (232448 - 4 * 81) // 2  # kWindowBytes: one window's bytes, at most


def _partition(mr, nr, radius, blocks):
    """csrc/resident2d.cu partition: (pr, pc, window cells) of the kernel's
    pr x pc rectangles of the rounded interior (mr, nr), at most ``blocks``,
    each at least ``radius`` cells on a side unless it spans its axis, the
    largest window (its rectangle and the radius-wide ring) the smallest;
    the first, at the fewest row cuts, among equals."""
    best = None
    for pr in range(1, max(1, min(mr // radius, blocks)) + 1):
        pc = max(1, min(blocks // pr, nr // radius))
        cells = (-(-mr // pr) + 2 * radius) * (-(-nr // pc) + 2 * radius)
        if best is None or cells < best[2]:
            best = (pr, pc, cells)
    return best


def _rects(mr, nr, pr, pc):
    """The kernel's block ownership: block b's rectangle (rows [i0, i1),
    columns [j0, j1)) of the rounded interior, b = a * pc + c."""
    return [(a * mr // pr, (a + 1) * mr // pr, c * nr // pc, (c + 1) * nr // pc)
            for a in range(pr) for c in range(pc)]


def _plan(spec, dtype):
    """plan_array parsed as csrc/resident2d.cu fill_plan parses it."""
    R, W = spec.radius, 2 * spec.radius + 1
    vals = plan_array(spec, dtype).tolist()
    terms = []
    for _ in spec.terms:
        terms.append((vals[0] != 0.0, vals[1] != 0.0, vals[2: 2 + W], vals[2 + W: 2 + 2 * W]))
        vals = vals[2 + 2 * W:]
    res = [(int(vals[3 * p]), int(vals[3 * p + 1]), vals[3 * p + 2])
           for p in range(len(spec.residue))]
    return terms, res


def _tasks(h, w, R, cols):
    """The kernel's work on an h x w rectangle (plan_tasks, band_cell), by
    its index arithmetic: the border cells (u, v), one a thread, and the
    inner cells' tasks (first column, first row, rows): one cell each where
    they are no more than the threads, else the march's, of ``cols``
    columns each (march_cols: 2 in float32, 1 in float64)."""
    a, c = min(R, h), min(R, w)
    b, d = max(a, h - R), max(c, w - R)
    side_cols = c + w - d
    top, bottom = a * w, (h - b) * w
    t = np.arange(top + bottom + (b - a) * side_cols)
    u = np.where(t < top, t // w, t // w + b - a)
    v = t % w
    side = t >= top + bottom
    ts = t[side] - top - bottom
    u[side] = a + ts // side_cols
    vi = ts % side_cols
    v[side] = np.where(vi < c, vi, d + vi - c)
    groups = -(-(d - c) // cols)
    mid = b - a
    if mid <= 0 or groups <= 0:
        return (u, v), (np.zeros(0, int),) * 3
    if mid * (d - c) <= THREADS:  # one inner cell a thread: tasks of one cell
        t = np.arange(mid * (d - c))
        return (u, v), (c + t % (d - c), a + t // (d - c), np.ones_like(t))
    chunks = 1 if groups >= THREADS else min(mid, THREADS // groups)
    crows = -(-mid // chunks)
    task = np.arange(groups * -(-mid // crows))
    first = a + task // groups * crows
    return (u, v), (c + task % groups * cols, first, np.minimum(crows, b - first))
def _rect_step(src, R, h, w, terms, res, gi0, gj0, m, n):
    """The h x w rectangle of one step from the window ``src`` ((h + 2R) x
    (w + 2R)), every column at once."""
    W = 2 * R + 1
    acc = torch.zeros((h, w), dtype=src.dtype)
    for has_col, has_row, ct, rt in terms:
        if has_col:  # every window row's column conv
            y = torch.zeros((h + 2 * R, w), dtype=src.dtype)
            for k in range(W):
                if ct[k] != 0.0:
                    y = y + ct[k] * src[:, k: k + w]
        else:
            y = src[:, R: R + w]
        if has_row:
            z = torch.zeros((h, w), dtype=src.dtype)
            for k in range(W):
                if rt[k] != 0.0:
                    z = z + rt[k] * y[k: k + h]
        else:
            z = y[R: R + h]
        acc = acc + z
    for dr, dc, wt in res:
        acc = acc + wt * src[R + dr: R + dr + h, R + dc: R + dc + w]
    rows = torch.arange(gi0, gi0 + h)[:, None] < m
    cols = torch.arange(gj0, gj0 + w)[None, :] < n
    return torch.where(rows & cols, acc, torch.zeros((), dtype=src.dtype))


def _emulate(cur, spec, layout, steps, blocks, seed=0):
    """A run as resident_smem_kernel does it; returns the buffer the run
    returns and the state after each step."""
    R = spec.radius
    terms, res = _plan(spec, cur.dtype)
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    pr, pc, _ = _partition(mr, nr, R, blocks)
    rects = _rects(mr, nr, pr, pc)
    out = torch.zeros_like(cur)
    # the exchange: state t's border at parity (t - 1) % 2, each cell beside
    # the state that stored it (the tag; 0: never stored)
    xch = [torch.zeros_like(cur) for _ in range(2)]
    tag = [torch.zeros((rows, pitch), dtype=torch.int64) for _ in range(2)]
    snapshots = [torch.zeros_like(cur) for _ in range(steps)]
    nan = float("nan")

    def block(b):
        i0, i1, j0, j1 = rects[b]
        h, w = i1 - i0, j1 - j0
        box = (slice(r0 + i0 - R, r0 + i1 + R), slice(c0 + j0 - R, c0 + j1 + R))
        inner = (slice(r0 + i0, r0 + i1), slice(c0 + j0, c0 + j1))
        rect = (slice(R, R + h), slice(R, R + w))
        win = [cur[box].clone(), torch.full((h + 2 * R, w + 2 * R), nan, dtype=cur.dtype)]
        border = torch.ones((h, w), dtype=torch.bool)
        border[R: h - R, R: w - R] = False
        ring = torch.ones_like(win[0], dtype=torch.bool)
        ring[rect] = False
        gi = torch.arange(i0 - R, i1 + R)[:, None]
        gj = torch.arange(j0 - R, j1 + R)[None, :]
        inside = (gi >= 0) & (gi < mr) & (gj >= 0) & (gj < nr)

        def step_cells(src, dst, keep):
            dst[rect][keep] = _rect_step(src, R, h, w, terms, res, i0, j0, m, n)[keep]

        def inner_cells(src, dst):
            # from the rectangle alone: its ring is not there yet
            step_cells(torch.where(ring, torch.full_like(src, nan), src), dst, ~border)

        inner_cells(win[0], win[1])
        yield
        for s in range(steps):
            src, dst = win[s % 2], win[(s + 1) % 2]
            if s > 0:  # the ring of state s: poll until every word carries s
                p = (s - 1) % 2
                while bool((tag[p][box][ring & inside] != s).any()):
                    assert bool((tag[p][box][ring & inside] <= s).all()), \
                        f"block {b}: state {s}'s border overwritten before it was read"
                    yield
                got = torch.where(inside, xch[p][box], torch.zeros((), dtype=cur.dtype))
                src[ring] = got[ring]
            step_cells(src, dst, border)
            snapshots[s][inner] = dst[rect]
            if s + 1 == steps:
                out[inner] = dst[rect]
                return
            xch[s % 2][inner][border] = dst[rect][border]
            tag[s % 2][inner][border] = s + 1
            yield
            inner_cells(dst, src)
            yield

    rng = random.Random(seed)
    live = {b: block(b) for b in range(len(rects))}
    while live:
        b = rng.choice(sorted(live))
        try:
            next(live[b])
        except StopIteration:
            del live[b]
    return out, snapshots


def _layout(spec, interior):
    return Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, spec.radius))


@pytest.mark.parametrize("interior,blocks,dtype", [
    ((37, 150), 132, torch.float32), ((200, 300), 132, torch.float64),
    ((512, 512), 128, torch.float32), ((512, 512), 132, torch.float64)])
@pytest.mark.parametrize("name", SHAPES_2D)
def test_resident_emulation_equals_the_twins_bit_for_bit(name, interior, blocks, dtype):
    """Steps 1-5 against stencil2d_resident_plain and single stencil2d_step
    calls (both the twin on the CPU): the 0..99 fill in float32, the pi/100 fill
    in float64; interiors that no partition splits evenly."""
    spec = get_shape(name)
    assert stencil2d.resident_takes(spec, dtype)
    lay = _layout(spec, interior)
    g0 = reference.random_padded(spec, interior, seed=9)
    x = lay.to_internal(g0 if dtype == torch.float32 else g0 * (np.pi / 100), dtype)
    keep = x.clone()
    got, snapshots = _emulate(x, spec, lay, 5, blocks, seed=blocks)
    assert torch.equal(got, snapshots[-1])
    single = x
    for steps in range(1, 6):
        single = stencil2d.stencil2d_step(single, torch.zeros_like(x), spec, lay)
        assert torch.equal(snapshots[steps - 1], single), steps
    assert torch.equal(got, stencil2d.stencil2d_resident_plain(x, spec, lay, 5))
    assert torch.equal(x, keep)


@pytest.mark.parametrize("seed", range(6))
def test_two_parities_suffice_in_any_order(seed):
    """Rectangles of R to 2R cells a side, many blocks, other interleavings:
    no ring cell is read from a stale or a newer state."""
    spec = get_shape("star2d3r")
    lay = Layout2D(interior=(20, 45), halo=spec.halo, tile=(1, 1),
                   guard=guard_2d(spec.halo, spec.radius))
    x = lay.to_internal(reference.random_padded(spec, (20, 45), seed=seed) % 3, torch.float64)
    got, _ = _emulate(x, spec, lay, 7, 30, seed=seed)
    assert torch.equal(got, stencil2d.stencil2d_resident_plain(x, spec, lay, 7))


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("mr,nr", [(512, 512), (37, 150), (1, 9), (64, 128), (3000, 40),
                                   (96, 1024), (1232, 1280), (7, 7)])
@pytest.mark.parametrize("blocks", [1, 7, 128, 132])
def test_every_rounded_interior_cell_is_owned_exactly_once(mr, nr, radius, blocks):
    pr, pc, cells = _partition(mr, nr, radius, blocks)
    assert 1 <= pr * pc <= blocks
    owner = torch.zeros((mr, nr), dtype=torch.int64)
    largest = 0
    for i0, i1, j0, j1 in _rects(mr, nr, pr, pc):
        owner[i0:i1, j0:j1] += 1
        h, w = i1 - i0, j1 - j0
        # at least R on a side unless it spans the axis: the ring lies in the
        # <= 8 neighbours
        assert (h >= radius or pr == 1) and (w >= radius or pc == 1)
        largest = max(largest, (h + 2 * radius) * (w + 2 * radius))
        for cols in (1, 2):
            (bu, bv), (v, first, rows) = _tasks(h, w, radius, cols)
            assert len(v) <= max(w, THREADS) and (len(v) == 0 or rows.min() >= 1)
            # +1 where a task's rows start, -1 past them, per column it owns
            edges = np.zeros((h + 1, w + 1), dtype=np.int64)
            direct = len(v) and rows.max() == 1 and len(v) == (h - 2 * radius) * (w - 2 * radius)
            for j in range(1 if direct else cols):
                keep = v + j < max(radius, w - radius)  # the inner columns
                np.add.at(edges, (first[keep], v[keep] + j), 1)
                np.add.at(edges, (first[keep] + rows[keep], v[keep] + j), -1)
            cover = np.cumsum(edges, axis=0)[:h, :w]
            np.add.at(cover, (bu, bv), 1)
            assert (cover == 1).all()
    assert bool((owner == 1).all())
    assert largest == cells


def test_capacity_rule_on_hand_worked_cases():
    # 4/5 of the cells of one 116,062-byte window per SM
    assert stencil2d.RESIDENT_SMEM_BYTES == WINDOW == 116062
    assert stencil2d.resident_capacity_bytes(4, 132) == 3063984 * 4  # 4*132*29015//5
    assert stencil2d.resident_capacity_bytes(8, 132) == 1531939 * 8  # 4*132*14507//5
    assert stencil2d.resident_capacity_bytes(4, 1) == 23212 * 4
    # 512^2 at R = 3 on 132 SMs: 11 x 12 rectangles of at most 47 x 43
    # cells, a 53 x 49 window (12 x 11 ties, at more row cuts)
    assert _partition(512, 512, 3, 132) == (11, 12, 53 * 49)
    # one block: the whole rounded interior and its ring
    assert _partition(32, 128, 3, 1) == (1, 1, 38 * 134)
    # a single row cannot be cut: 132 column slices of ceil(1000 / 132) = 8
    assert _partition(1, 1000, 4, 132) == (1, 132, 9 * 16)
    # rectangles of at least R cells: 9 columns at R = 4 make 2 slices
    assert _partition(2, 9, 4, 132) == (1, 2, 10 * 13)


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("sms", [16, 114, 132])
def test_every_buffer_below_capacity_fits(sms, itemsize, radius):
    """Any internal buffer (rows >= mr + 2R, pitch >= nr + 2R) within the
    capacity partitions into windows that fit a block's shared memory, at every
    aspect ratio sampled."""
    cap_cells = stencil2d.resident_capacity_bytes(itemsize, sms) // itemsize
    window = WINDOW // itemsize
    for mr in list(range(1, 64)) + list(range(64, 8000, 41)):
        top = cap_cells // (mr + 2 * radius) - 2 * radius
        for nr in {top, top - 1, top * 9 // 10, top // 2}:
            if nr >= 1:
                assert _partition(mr, nr, radius, sms)[2] <= window, (mr, nr)


def test_resident_dispatch_by_radius_and_terms():
    """Every registry 2-D shape runs the shared-memory kernel in both dtypes;
    a radius beyond 4 or a fourth term runs csrc/stencil2d.cu's kernel."""
    from lorastencil_tpu_torch.models.shapes import StencilSpec

    for name in SHAPES_2D:
        for dtype in (torch.float32, torch.float64):
            assert stencil2d.resident_takes(get_shape(name), dtype)
    box = get_shape("box2d3r")
    four = StencilSpec(name="four", ndim=2, radius=3, halo=(4, 4),
                       terms=box.terms + box.terms[:1], residue=(), fuse_factor=1)
    wide = StencilSpec(name="wide", ndim=2, radius=5, halo=(5, 5), terms=box.terms[:1],
                       residue=(), fuse_factor=1)
    assert not stencil2d.resident_takes(four, torch.float32)
    assert not stencil2d.resident_takes(wide, torch.float64)
    assert stencil2d.resident_capacity(wide, torch.float32, "cuda") is None
