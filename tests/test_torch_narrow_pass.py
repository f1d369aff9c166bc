"""The float32 narrow 1-D pass redesigned for Hopper (csrc/stencil1d.cu
lanes_kernel): its host plans (ops/stencil1d.lanes_plan, lanes_tile) and a
plain PyTorch emulation of its traversal held against the plain twin it must
equal (ops/stencil1d.stencil1d_lanes_step_plain).  CPU only, no JAX; the
kernel itself is held against the twin and the kernel it replaces
(pass_kernel<float>) on the card by tests/test_torch_cuda.py and
chip_smoke.py.

What the emulation repeats: tiles of ``lanes_tile`` cells; per tile the tile
and E = k * r_eff rounded up to whole groups of 8 cells on each side staged
into a window with P = r_eff rounded up to 4 cells more on each side, zero
outside the buffer, the window's other cells NaN (never written); substep s
computing the groups of 8 that cover the tile and (k - s) * r_eff cells on
each side into a fresh NaN window, so that a kept cell that read a cell no
substep wrote would come out NaN; per group the plan's terms in order (the
centre's product or -0, then per d one product of an equal pair's sum, or
the +d tap's product then the -d tap's), every product and sum rounded on
its own; the mask to the interior; the last substep's tile written to the
donor.  Tolerance: none.  The emulation equals the twin bit for bit in
float32 on the integer fill, on the pi/100 fill and on a fill holding an inf,
at 3001 cells (a ragged tile) and 4096, at k = 1, 3 and 32 // r_eff."""

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil1d
from lorastencil_tpu_torch.ops.layout import TILE_1D, Layout1D, guard_1d
from lorastencil_tpu_torch.utils import reference

SMS = 132  # the H100's SMs: the tile choice the card makes
FILLS = ["integer", "pi", "inf"]
PAIR, PLUS, MINUS = stencil1d.LANES_PAIR, stencil1d.LANES_PLUS, stencil1d.LANES_MINUS


def _custom(taps, name):
    return engine.StencilEngine.for_coeffs(np.asarray(taps, dtype=np.float64), (64,),
                                           name=name, device="cpu").spec


def _spec(name):
    """Registry shapes, an asymmetric spec (no pair), one with zero interior
    taps and a zero centre, and a radius-9 one (the runtime-radius
    instance)."""
    if name == "asym":
        return _custom([1, -2, 0.5, 3, 0.25, 1.5, 0.75], name)
    if name == "holes":
        return _custom([2, 0, 1, 0, 0, 1, 0, 0, 3], name)
    if name == "r9":
        taps = np.random.default_rng(9).integers(-3, 4, 19) / 256.0
        taps[0], taps[-1] = 1 / 256.0, 2 / 256.0
        return _custom(taps, name)
    return get_shape(name)


def _fill(g0, fill):
    if fill == "integer":
        return g0
    x = g0 * (np.pi / 100)
    if fill == "inf":
        x = x.copy()
        x[x.size // 3] = np.inf
    return x


# -- host plans ----------------------------------------------------------------
@pytest.mark.parametrize("name,centre,per_d", [
    ("1d1r", 4.0, ((PAIR, 3.0, 3.0), (PAIR, 2.0, 2.0), (PAIR, 1.0, 1.0))),
    ("1d2r", 5.0, ((PAIR, 4.0, 4.0), (PAIR, 3.0, 3.0), (PAIR, 2.0, 2.0),
                   (PAIR, 1.0, 1.0))),
    ("asym", 3.0, ((PLUS | MINUS, 0.25, 0.5), (PLUS | MINUS, 1.5, -2.0),
                   (PLUS | MINUS, 0.75, 1.0))),
    ("holes", None, ((PLUS, 1.0, 0.0), (MINUS, 0.0, 1.0), (0, 0.0, 0.0),
                     (PLUS | MINUS, 3.0, 2.0))),
])
def test_lanes_plan_is_the_twin_order(name, centre, per_d):
    """The centre (None where its tap is zero), then per d a pair's one
    weight, or the +d and -d taps that are nonzero, as _conv(pairs=True)."""
    assert stencil1d.lanes_plan(_spec(name)) == (centre, per_d)


@pytest.mark.parametrize("name", ["1d1r", "1d2r", "asym", "holes", "r9"])
def test_lanes_plan_covers_every_nonzero_tap_once(name):
    spec = _spec(name)
    centre, per_d = stencil1d.lanes_plan(spec)
    taps, r = stencil1d._taps(spec)
    assert len(per_d) == stencil1d.effective_radius(spec) == r
    used = {0: centre} if centre is not None else {}
    for d, (kind, wp, wm) in enumerate(per_d, 1):
        assert kind in (0, PLUS, MINUS, PLUS | MINUS, PAIR)
        if kind == PAIR:
            assert wp == wm != 0.0
            used[d] = used[-d] = wp
        if kind & PLUS:
            used[d] = wp
        if kind & MINUS:
            used[-d] = wm
    assert used == {d - r: w for d, w in enumerate(taps) if w != 0.0}


@pytest.mark.parametrize("n,tile", [
    (3001, 256),        # rounded 4096: 16 blocks, the smallest tile
    (4096, 256),
    (1_000_000, 1024),  # 978 blocks of 128 threads: one even wave on 132 SMs
    (16_777_216, 2048),
])
def test_lanes_tile_at_132_sms(n, tile):
    rounded = Layout1D(n, 4, TILE_1D, 12).rounded
    assert stencil1d.lanes_tile(rounded, SMS) == tile
    assert rounded % tile == 0 and tile % stencil1d.LANES_V == 0
    blocks = rounded // tile
    if n >= 1_000_000:
        assert blocks >= stencil1d.H100_LANES_BLOCKS_PER_SM * SMS
    if n == 1_000_000:
        # at most 8 blocks of tile / 8 threads an SM: one wave of 2048 threads
        assert -(-blocks // SMS) * tile // stencil1d.LANES_V <= 2048


# -- the kernel's traversal ----------------------------------------------------
def _sums(src, idx, centre, per_d):
    """One group's sums as window_sums<float, R, 8, true> takes them."""
    def x(d):
        return src[idx + d]

    acc = centre * x(0) if centre is not None else torch.full(idx.shape, -0.0)
    for d, (kind, wp, wm) in enumerate(per_d, 1):
        if kind & PAIR:
            acc = acc + wp * (x(d) + x(-d))
        else:
            if kind & PLUS:
                acc = acc + wp * x(d)
            if kind & MINUS:
                acc = acc + wm * x(-d)
    return acc


def _lanes_emulation(cur, donor, spec, layout, k, bounds=None):
    """The narrow pass as lanes_kernel runs it, tile by tile; the substeps
    before the last masked to ``bounds`` (lo, hi), the last to the
    interior."""
    centre, per_d = stencil1d.lanes_plan(spec)
    r, V = len(per_d), stencil1d.LANES_V
    P = -(-r // 4) * 4
    E = -(-k * r // V) * V
    o, n, nr, L = layout.origin, layout.interior, layout.rounded, layout.shape[0]
    tile = stencil1d.lanes_tile(nr, SMS)
    S = tile + 2 * E
    blo, bhi = (0, n) if bounds is None else bounds
    nan = float("nan")
    for t0 in range(0, nr, tile):
        g = torch.arange(o + t0 - E, o + t0 - E + S)
        src = torch.full((S + 2 * P,), nan)
        src[P:P + S] = torch.where((g >= 0) & (g < L), cur[g.clamp(0, L - 1)],
                                   torch.zeros(()))
        for s in range(1, k + 1):
            e = (k - s) * r
            q0, q1 = (E - e) // V, -(-(E + tile + e) // V)
            if s == k:  # one group a thread: the tile
                q0, q1 = E // V, (E + tile) // V
            i = torch.arange(q0 * V, q1 * V)
            acc = _sums(src, P + i, centre, per_d)
            f = t0 - E + i
            a, b = (0, n) if s == k else (blo, bhi)
            acc = torch.where((f >= a) & (f < b), acc, torch.zeros(()))
            if s == k:
                donor[o + t0: o + t0 + tile] = acc
            else:
                src = torch.full((S + 2 * P,), nan)
                src[P + i] = acc
    return donor


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("n", [3001, 4096])
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "asym", "holes", "r9"])
def test_lanes_emulation_equals_the_twin_bit_for_bit(name, n, fill):
    spec = _spec(name)
    r = stencil1d.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=4)
    for k in sorted({1, min(3, stencil1d.MAX_LANES_REACH // r),
                     stencil1d.MAX_LANES_REACH // r}):
        lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], k * r))
        x = lay.to_internal(_fill(g0, fill))
        got = _lanes_emulation(x, torch.zeros_like(x), spec, lay, k)
        want = stencil1d.stencil1d_lanes_step_plain(x, torch.zeros_like(x), spec, lay, k)
        assert fill == "inf" or not bool(torch.isnan(want).any())
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_the_staged_halo_is_small_at_16m():
    """At 1d2r 16,777,216 k = 3 a 2048-cell tile stages E = 16 cells on each
    side (12 rounded up to whole groups): 1.6% more than the tile."""
    k, r = 3, stencil1d.effective_radius(get_shape("1d2r"))
    E = -(-k * r // stencil1d.LANES_V) * stencil1d.LANES_V
    assert (E, stencil1d.lanes_tile(16_777_216, SMS)) == (16, 2048)
    assert 2 * E / 2048 < 0.02


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "asym", "r9"])
def test_lanes_emulation_with_ghost_bounds_equals_the_twin(name, boundary):
    """Under a ghost boundary (ROADMAP A6(a)) the substeps before the last
    keep [-d, n + d), d = k * radius, which holds the ring the engine's
    refresh filled: the emulation equals the twin with the same bounds bit
    for bit, at k = 3 and at the largest k."""
    from lorastencil_tpu_torch.engine import _ring_refresh_nd

    spec = _spec(name)
    r, n = stencil1d.effective_radius(spec), 3001
    g0 = reference.random_padded(spec, (n,), seed=5) * (np.pi / 100)
    for k in sorted({min(3, stencil1d.MAX_LANES_REACH // r), stencil1d.MAX_LANES_REACH // r}):
        d = k * spec.radius
        lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], d))
        x = _ring_refresh_nd(lay.to_internal(g0), boundary, (lay.origin,), (n,), d)
        bounds = (-d, n + d)
        want = stencil1d.stencil1d_lanes_step_plain(x, torch.zeros_like(x), spec, lay, k,
                                                    bounds)
        got = _lanes_emulation(x, torch.zeros_like(x), spec, lay, k, bounds)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert k == 1 or not torch.equal(want, stencil1d.stencil1d_lanes_step_plain(
            x, torch.zeros_like(x), spec, lay, k))
