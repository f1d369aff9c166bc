"""The 1-D runs redesigned for Hopper (csrc/stencil1d.cu run_kernel), wide and
narrow: the host plan (ops/stencil1d.run_plan, make_run_plan, run_cells), the
narrow plan's host arrays and its hand-off to the entry, and a plain PyTorch
emulation of a run held against the plain twin it must equal
(ops/stencil1d.stencil1d_resident_plain, stencil1d_resident_lanes_plain).
CPU only, no JAX; the kernel itself is held against the twins and the kernel
it replaces (resident_kernel, a grid sync every step wide, every
lanes_refresh steps narrow) on the card by tests/test_torch_cuda.py and
chip_smoke.py.

What the emulation repeats: B blocks, each owning a chunk of whole groups of
``run_cells`` cells and two windows of the chunk and ``halo`` cells on each
side, the first read from the input buffer (the chunk, m * r cells on a side
with a neighbour, r cells of the guard on a side without one), every other
cell NaN until written; phases of m steps, step j computing the groups that
cover the chunk and (m - j) * r cells on each side with a neighbour into the
other window, per cell the centre's product or -0, then for d = 1..r the +d
tap's product and the -d tap's where the plan has them (the narrow run, from
lanes_plan: one product of an equal pair's sum instead), each rounded on its
own, then the mask to the interior; on a side without a neighbour the r
cells beyond the chunk 0 from step 2 on; the last step of a phase sending the
chunk's first and last m' * r cells to the exchange of the phase's parity,
each cell beside the state's number (its tag), and the next phase polling its
halo from the neighbours' cells until every one carries the state awaited;
the chunk written out and the guard zeroed.  The blocks run as coroutines in
a random order that each poll constrains: a halo cell of a newer state fails
the test, so the two parities are shown to suffice.  Tolerance: none; the
emulation equals the twin bit for bit in float32 and float64, on the integer
fill, on the pi/100 fill and on a fill holding an inf."""

import contextlib
import random
import types

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil1d
from lorastencil_tpu_torch.ops.layout import TILE_1D, Layout1D, guard_1d
from lorastencil_tpu_torch.utils import reference

SMS = 132  # the H100's SMs
SMEM = 232448  # bytes of shared memory a block may use
DTYPES = [torch.float32, torch.float64]
FILLS = ["integer", "pi", "inf"]


def _mixed(r):
    """A narrow spec of effective radius r whose d cycle through every kind of
    the narrow plan: the +d tap alone, the -d tap alone, both unequal,
    neither, an equal pair (and d = r a pair); the centre nonzero."""
    rng = np.random.default_rng(r)
    w = rng.integers(1, 4, 2 * r + 1) * rng.choice([-1.0, 1.0], 2 * r + 1) / 256.0
    taps = np.zeros(2 * r + 1)
    taps[r] = w[r]
    for d in range(1, r + 1):
        kind = d % 5 if d < r else 0
        if kind in (0, 1, 3):
            taps[r + d] = w[r + d]
        if kind in (2, 3):
            taps[r - d] = w[r - d] if kind == 2 else -w[r + d]
        if kind == 0:
            taps[r - d] = w[r + d]
    return engine.StencilEngine.for_coeffs(taps, (64,), name=f"m{r}", device="cpu").spec


def _spec(name):
    if name.startswith("m"):
        return _mixed(int(name[1:]))
    if name.startswith("r"):
        r = int(name[1:])
        taps = np.random.default_rng(r).integers(-3, 4, 2 * r + 1) / 256.0
        taps[np.random.default_rng(r + 1).random(2 * r + 1) < 0.3] = 0.0
        taps[0] = taps[-1] = 1.0 / 256.0
        return engine.StencilEngine.for_coeffs(taps, (64,), name=name, device="cpu").spec
    return get_shape(name)


def _fill(g0, fill):
    if fill == "integer":
        return g0
    x = g0 * (np.pi / 100)
    if fill == "inf":
        x = x.copy()
        x[x.size // 3] = np.inf
    return x


def _layout(spec, n, pairs=False):
    """The wide run's layout, or the narrow run's (the engine's guard)."""
    r = stencil1d.effective_radius(spec)
    reach = stencil1d.lanes_refresh(r) * r if pairs else 2 * r
    return Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], reach))


def _plan(spec, lay, dtype, steps=64, pairs=False):
    n_products = (stencil1d.lanes_products(spec) if pairs
                  else len(stencil1d.wide_taps(spec)[0]))
    return stencil1d.run_plan(lay.rounded, stencil1d.effective_radius(spec),
                              n_products, steps, dtype.itemsize, SMS)


# -- the host plan -------------------------------------------------------------
def _largest(dtype):
    n = stencil1d.RESIDENT_BYTES // dtype.itemsize // TILE_1D * TILE_1D
    while not stencil1d.fits_resident(_layout(get_shape("1d1r"), n), dtype.itemsize):
        n -= TILE_1D
    return n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,n,blocks,m", [
    ("1d1r", 4096, 16, 64),   # 256-cell chunks, one phase: no exchange
    ("1d1r", 3001, 16, 64),
    ("1d2r", 4096, 16, 48),   # 192 // 4
    ("r40", 100_000, 132, 4),
    ("r127", 100_000, 132, 1),
    ("1d1r", None, 132, 64),  # the largest grid under RESIDENT_BYTES
])
def test_run_plan_at_the_measured_sizes(name, n, blocks, m, dtype):
    spec = _spec(name)
    lay = _layout(spec, n or _largest(dtype))
    plan = _plan(spec, lay, dtype)
    assert (plan.blocks, plan.m) == (blocks, m)


def _largest_lanes(dtype):
    spec = get_shape("1d1r")
    n = stencil1d.RESIDENT_LANES_BYTES // dtype.itemsize // TILE_1D * TILE_1D
    while not stencil1d.fits_resident_lanes(_layout(spec, n, True), dtype.itemsize):
        n -= TILE_1D
    return n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,n,blocks,m", [
    ("1d1r", 4096, 16, 64),   # one phase of 64 steps: no exchange
    ("1d1r", 3001, 16, 64),
    ("1d2r", 4096, 16, 48),
    ("m16", 65_536, 132, 12),  # 192 // 16: a grid sync every 2 steps before
    ("m32", 65_536, 132, 6),   # and every step
    ("1d1r", None, 132, 64),  # the largest grid under RESIDENT_LANES_BYTES
])
def test_run_plan_at_the_narrow_sizes(name, n, blocks, m, dtype):
    """The narrow run takes the wide run's rule on its own layout (the
    engine's guard of lanes_refresh(r) * r) and its plan's products."""
    spec = _spec(name)
    lay = _layout(spec, n or _largest_lanes(dtype), True)
    if n is None:
        assert stencil1d.fits_resident_lanes(lay, dtype.itemsize)
    assert _plan(spec, lay, dtype, pairs=True)[:2] == (blocks, m)


@pytest.mark.parametrize("name,products", [("1d1r", 4), ("1d2r", 5), ("m5", 6), ("m9", 11),
                                           ("m32", 33)])
def test_lanes_products_count_the_narrow_sums(name, products):
    """The centre's product, one a pair, one a tap otherwise: m9's d = 1..9
    are +, -, both, none, pair, +, -, both, pair."""
    spec = _spec(name)
    assert stencil1d.lanes_products(spec) == products
    centre, per_d = stencil1d.lanes_plan(spec)
    kinds = [kind for kind, _, _ in per_d]
    if name.startswith("m"):
        assert set(kinds) == {0, 1, 2, 3, 4} and kinds[-1] == stencil1d.LANES_PAIR
        assert centre is not None


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_block_where_the_rule_allows_it(monkeypatch, dtype):
    """B = 1 (m = steps, the halo r in whole groups, a thread a group) where
    the grid's two windows fit a block and its work is within
    H100_RUN_ONE_BLOCK_WORK: 1d1r 4096 once the cap is 4096 x 7 taps; never
    where the windows do not fit shared memory."""
    spec = get_shape("1d1r")
    lay = _layout(spec, 4096)
    monkeypatch.setattr(stencil1d, "H100_RUN_ONE_BLOCK_WORK", 4096 * 7)
    V = stencil1d.run_cells(dtype.itemsize, 3)
    assert _plan(spec, lay, dtype) == stencil1d.RunPlan(1, 64, V, 4096 // V)
    monkeypatch.setattr(stencil1d, "H100_RUN_ONE_BLOCK_WORK", 10**9)
    big = _layout(spec, 64 * 2048)
    assert _plan(spec, big, dtype).blocks > 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rounded", [2048, 4096, 6144, 100_352, 129_024, 1_001_472])
@pytest.mark.parametrize("r", [0, 1, 3, 4, 8, 9, 40, 127])
def test_every_plan_gives_each_border_from_a_neighbour(dtype, rounded, r):
    """Whole-group chunks of at least m * r cells (a border comes from the
    neighbour alone), a halo of whole groups covering m * r, a thread for
    each group of the widest step, and two windows within shared memory
    wherever B > 1 can hold the grid."""
    isz = dtype.itemsize
    plan = stencil1d.run_plan(rounded, r, 2 * r + 1, 64, isz, SMS)
    V = stencil1d.run_cells(isz, r)
    assert 1 <= plan.blocks <= SMS and 1 <= plan.m <= 64
    assert plan.halo % V == 0 and plan.halo >= (plan.m * r if plan.blocks > 1 else r)
    assert plan.threads % 32 == 0 and plan.threads <= stencil1d.RUN_MAX_THREADS
    groups = rounded // V
    if plan.blocks > 1:
        assert groups // plan.blocks * V >= plan.m * r
    widest = -(-groups // plan.blocks) + (
        2 * -(-(plan.m - 1) * r // V) if plan.blocks > 1 else 0)
    assert plan.threads >= min(widest, stencil1d.RUN_MAX_THREADS)
    cmax = -(-groups // plan.blocks) * V
    pad = -(-r // (16 // isz)) * (16 // isz)
    if 2 * isz * (cmax + 2 * pad) <= SMEM // 2:
        assert 2 * isz * (cmax + 2 * plan.halo + 2 * pad) <= SMEM


# -- the kernel's traversal ----------------------------------------------------
def _run_plan_table(spec, dtype):
    """run_kernel's TapPlan from the wide taps: (centre or None, per d
    (wp or None, wm or None)) in the twin's order."""
    offsets, weights = stencil1d.wide_taps(spec)
    taps = dict(zip(offsets, weights))
    r = stencil1d.effective_radius(spec)
    return taps.get(0), [(taps.get(d), taps.get(-d)) for d in range(1, r + 1)]


def _emulate(cur, spec, layout, steps, plan, seed=0, pairs=False):
    """A run as run_kernel does it (``pairs``: its narrow instances, the plan
    from lanes_plan); returns the output buffer."""
    dtype = cur.dtype
    if pairs:
        centre, per_d = stencil1d.lanes_plan(spec)
    else:
        centre, per_d = _run_plan_table(spec, dtype)
    r = len(per_d)
    B, m, HW = plan.blocks, plan.m, plan.halo
    V = stencil1d.run_cells(dtype.itemsize, r)
    P = -(-r // (16 // dtype.itemsize)) * (16 // dtype.itemsize)
    o, n, nr, L = layout.origin, layout.interior, layout.rounded, layout.shape[0]
    groups = nr // V
    cmax = -(-groups // B) * V
    W = cmax + 2 * HW + 2 * P
    nan = float("nan")
    out = torch.full_like(cur, nan)  # the kernel writes it whole
    # the exchange: (parity, block, side) -> cells and their tags (0: never)
    xch = {(p, b, s): (torch.zeros(m * r, dtype=dtype), torch.zeros(m * r, dtype=torch.int64))
           for p in range(2) for b in range(B) for s in range(2)}

    def sums(src, i):  # window_sums<T, R, V, pairs> over window indices i
        def x(d):
            return src[P + i + d]

        acc = centre * x(0) if centre is not None else torch.full(i.shape, -0.0, dtype=dtype)
        for d, plan_d in enumerate(per_d, 1):
            if pairs:
                kind, wp, wm = plan_d
                if kind == stencil1d.LANES_PAIR:
                    acc = acc + wp * (x(d) + x(-d))
                    continue
                wp = wp if kind & stencil1d.LANES_PLUS else None
                wm = wm if kind & stencil1d.LANES_MINUS else None
            else:
                wp, wm = plan_d
            if wp is not None:
                acc = acc + wp * x(d)
            if wm is not None:
                acc = acc + wm * x(-d)
        return acc

    def block(b):
        c0 = b * groups // B * V
        C = (b + 1) * groups // B * V - c0
        has_l, has_r = b > 0, b + 1 < B
        win = [torch.full((W,), nan, dtype=dtype), torch.full((W,), nan, dtype=dtype)]
        m0 = min(m, steps)
        i = torch.arange(HW - (m0 * r if has_l else r), HW + C + (m0 * r if has_r else r))
        g = o + c0 - HW + i
        win[0][P + i] = torch.where((g >= 0) & (g < L), cur[g.clamp(0, L - 1)],
                                    torch.zeros((), dtype=dtype))
        outer = ([torch.arange(HW - r, HW)] * (not has_l)
                 + [torch.arange(HW + C, HW + C + r)] * (not has_r))
        for cells in outer:
            win[1][P + cells] = 0
        yield
        done, cur_w, p = 0, 0, 0
        while True:
            mp = min(m, steps - done)
            if p > 0:  # poll the halo of state `done`
                par, hc = (p - 1) % 2, mp * r
                wants = ([((par, b - 1, 1), torch.arange(HW - hc, HW))] if has_l else []) + (
                    [((par, b + 1, 0), torch.arange(HW + C, HW + C + hc))] if has_r else [])
                for key, cells in wants:
                    while bool((xch[key][1][:hc] != done).any()):
                        assert bool((xch[key][1][:hc] <= done).all()), \
                            f"block {b}: state {done}'s border overwritten before it was read"
                        yield
                    win[cur_w][P + cells] = xch[key][0][:hc]
            bc = min(m, steps - done - mp) * r
            for j in range(1, mp + 1):
                src, dst = win[cur_w], win[cur_w ^ 1]
                lo = HW - ((mp - j) * r if has_l else 0)
                hi = HW + C + ((mp - j) * r if has_r else 0)
                i = torch.arange(lo // V * V, -(-hi // V) * V)
                f = c0 - HW + i
                acc = torch.where((f >= 0) & (f < n), sums(src, i), torch.zeros((), dtype=dtype))
                dst[P + i] = acc
                if j == mp and bc:
                    u = i - HW
                    tag = done + j
                    for side, keep, at in ((0, has_l, u), (1, has_r, u - (C - bc))):
                        sel = (u >= 0) & (u < C) & (at >= 0) & (at < bc) & keep
                        xch[(p % 2, b, side)][0][at[sel]] = acc[sel]
                        xch[(p % 2, b, side)][1][at[sel]] = tag
                if done + j == 2:
                    for cells in outer:
                        win[0][P + cells] = 0
                cur_w ^= 1
                yield
            done += mp
            p += 1
            if done == steps:
                break
        out[o + c0: o + c0 + C] = win[cur_w][P + HW: P + HW + C]
        if not has_l:
            out[:o] = 0
        if not has_r:
            out[o + nr:] = 0

    rng = random.Random(seed)
    live = {b: block(b) for b in range(B)}
    while live:
        b = rng.choice(sorted(live))
        try:
            next(live[b])
        except StopIteration:
            del live[b]
    return out


def _check(spec, n, dtype, fill, steps, plan, seed=0, pairs=False):
    lay = _layout(spec, n, pairs)
    x = lay.to_internal(_fill(reference.random_padded(spec, (n,), seed=5), fill), dtype)
    keep = x.clone()
    got = _emulate(x, spec, lay, steps, plan, seed, pairs)
    twin = (stencil1d.stencil1d_resident_lanes_plain if pairs
            else stencil1d.stencil1d_resident_plain)
    want = twin(x, spec, lay, steps)
    assert fill == "inf" or not bool(torch.isnan(want).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.signbit(got), torch.signbit(want)) and torch.equal(x, keep)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,n", [("1d1r", 3001), ("1d1r", 4096), ("1d2r", 4096),
                                    ("r40", 3001)])
def test_run_emulation_under_the_rule_equals_the_twin(name, n, dtype, fill):
    """The H100 rule's plan over 1, 2 and 2m + 3 steps (at m = 64 a run
    shorter than m has one phase; the last has two exchanges and a tail)."""
    spec = _spec(name)
    plan = _plan(spec, _layout(spec, n), dtype)
    for steps in (1, 2, min(2 * plan.m + 3, 67)):
        _check(spec, n, dtype, fill, steps, plan, seed=steps)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,n,blocks,m", [
    ("1d1r", 4096, 1, 7),    # one block, no neighbour on either side
    ("1d1r", 4096, 16, 3),   # many short phases
    ("1d2r", 3001, 5, 2),    # uneven chunks of whole groups
    ("r40", 4096, 4, 2),     # the runtime-radius instance (r > 8)
])
def test_run_emulation_under_other_plans_equals_the_twin(name, n, blocks, m, dtype, fill):
    spec = _spec(name)
    r = stencil1d.effective_radius(spec)
    lay = _layout(spec, n)
    plan = stencil1d.make_run_plan(lay.rounded, r, dtype.itemsize, blocks, m)
    for steps in (1, 2 * m + 3):
        _check(spec, n, dtype, fill, steps, plan, seed=blocks + steps)


@pytest.mark.parametrize("seed", range(6))
def test_two_parities_suffice_in_any_order(seed):
    """Chunks of two groups (8 cells, m * r = 3 of them sent each way),
    many blocks, other interleavings: no halo cell is read from a stale or
    a newer state."""
    spec = get_shape("1d1r")
    lay = Layout1D(200, 4, 8, 8)
    plan = stencil1d.make_run_plan(lay.rounded, 3, 8, 25, 1)
    x = lay.to_internal(reference.random_padded(spec, (200,), seed=seed) % 3, torch.float64)
    got = _emulate(x, spec, lay, 9, plan, seed)
    assert torch.equal(got, stencil1d.stencil1d_resident_plain(x, spec, lay, 9))


# -- the narrow run (run_kernel's narrow instances) ------------------------------
NARROW = [("1d1r", 3001), ("1d1r", 4096), ("1d2r", 4096), ("m5", 4096), ("m9", 4096),
          ("m32", 4096)]


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,n", NARROW)
def test_narrow_run_emulation_under_the_rule_equals_its_twin(name, n, dtype, fill):
    """The H100 rule's plan for the narrow run over 1, 2 and 2m + 3 steps
    (at most 67): the pair order of lanes_plan, bit for bit against
    stencil1d_resident_lanes_plain; the registry shapes take the instance of
    a plan of pairs only, m5 (radius 5) and m9 and m32 (the runtime-radius
    instance) the one of any narrow plan, with every kind of d."""
    spec = _spec(name)
    plan = _plan(spec, _layout(spec, n, True), dtype, pairs=True)
    for steps in (1, 2, min(2 * plan.m + 3, 67)):
        _check(spec, n, dtype, fill, steps, plan, seed=steps, pairs=True)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks,m", [(1, 7), (4, 2)])
@pytest.mark.parametrize("name,n", NARROW)
def test_narrow_run_emulation_under_other_plans_equals_its_twin(name, n, blocks, m, dtype,
                                                                fill):
    """One block (no neighbour on either side) and four blocks of two-step
    phases (exchanges every other step)."""
    spec = _spec(name)
    lay = _layout(spec, n, True)
    plan = stencil1d.make_run_plan(lay.rounded, stencil1d.effective_radius(spec),
                                   dtype.itemsize, blocks, m)
    for steps in (1, 2 * m + 3):
        _check(spec, n, dtype, fill, steps, plan, seed=blocks + steps, pairs=True)


def _fake_entries(monkeypatch, err=0):
    """``_lib`` replaced by entries that record their arguments and return
    ``err``; the CUDA device and stream by stand-ins, 132 SMs."""
    seen = []

    def entry(name):
        def call(*args):
            seen.append((name, args))
            return err
        return call

    entries = {dtype: tuple(entry((dtype, i)) for i in range(4))
               for dtype in (torch.float32, torch.float64)}
    monkeypatch.setattr(stencil1d, "_lib", lambda: entries)
    monkeypatch.setattr(stencil1d, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
def test_narrow_run_hands_its_plan_to_the_narrow_entry(monkeypatch, dtype):
    """_lanes_run calls the dtype's narrow run entry (ls_stencil1d_run_lanes
    or _f64) with the narrow plan's host arrays, weights of 1/3 carried bit
    for bit in float64 (rounded once to float32 in float32), the H100
    rule's plan and 4 * B * m * r cells of zeroed exchange words."""
    third = [2 / 3, 1 / 7, 1 / 3, 1 / 3, 1 / 3, 0.0, 1 / 3]  # d = 1 a pair, 2 -d alone, 3 both
    spec = engine.StencilEngine.for_coeffs(np.asarray(third), (64,), name="third",
                                           device="cpu").spec
    seen = _fake_entries(monkeypatch)
    lay = _layout(spec, 3001, True)
    x = torch.zeros(lay.shape, dtype=dtype)
    out = stencil1d._lanes_run(x, spec, lay, 100)
    assert out.shape == x.shape and out.dtype == dtype and out.data_ptr() != x.data_ptr()
    ((name, args),) = seen
    assert name == (dtype, 3)
    plan = _plan(spec, lay, dtype, 100, pairs=True)
    assert plan.m < 100 and plan.blocks > 1  # two phases: an exchange
    words = 4 * plan.blocks * plan.m * 3 * dtype.itemsize // 4
    assert args[1] == out.data_ptr() and args[2] is not None and args[3] == words
    kinds, wp, wm, has_centre, centre = args[4:9]
    want = stencil1d.lanes_plan(spec)
    cast = (lambda v: v) if dtype == torch.float64 else (lambda v: float(np.float32(v)))
    assert list(kinds) == [kind for kind, _, _ in want[1]]
    assert list(wp) == [cast(w) for _, w, _ in want[1]]
    assert list(wm) == [cast(w) for _, _, w in want[1]]
    assert (has_centre, centre) == (1, 1 / 3)
    assert list(kinds) == [stencil1d.LANES_PAIR, stencil1d.LANES_MINUS,
                           stencil1d.LANES_PLUS | stencil1d.LANES_MINUS]
    if dtype == torch.float64:
        assert list(wp) == [1 / 3, 0.0, 1 / 3] and list(wm) == [1 / 3, 1 / 7, 2 / 3]
    assert args[9:16] == (3, 100) + tuple(plan)[:2] + tuple(plan)[2:] + (lay.shape[0],)
    assert args[16:19] == (lay.origin, lay.interior, lay.rounded)


def test_one_phase_makes_no_exchange_words(monkeypatch):
    """A run that one phase takes whole (steps <= m: 1d1r 4096 x 64 on 16
    blocks) sends no border: the entry gets no exchange words (a null
    pointer and 0), the wide run's as the narrow run's."""
    seen = _fake_entries(monkeypatch)
    spec = get_shape("1d1r")
    lay = _layout(spec, 4096, True)
    x = torch.zeros(lay.shape)
    assert _plan(spec, lay, torch.float32, pairs=True)[:2] == (16, 64)
    stencil1d._lanes_run(x, spec, lay, 64)
    stencil1d._wide_run(x, spec, _layout(spec, 4096), 64)
    assert [(name[1], args[2:4]) for name, args in seen] == [(3, (None, 0)), (2, (None, 0))]


def test_a_refused_narrow_run_raises(monkeypatch):
    """An entry that refuses (or fails to launch) raises RuntimeError: no
    fallback to resident_kernel or to the twin."""
    _fake_entries(monkeypatch, err=1)
    spec = get_shape("1d2r")
    lay = _layout(spec, 4096, True)
    with pytest.raises(RuntimeError, match="resident launch failed"):
        stencil1d._lanes_run(torch.zeros(lay.shape), spec, lay, 3)
