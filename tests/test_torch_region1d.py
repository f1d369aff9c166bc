"""The 1-D passes over a window of tiles (``region``) and under a shard's box
(``bounds`` from the sharded engine, ``check_bounds(..., shard=True)``), on the CPU: the twins
``stencil1d_step_plain`` and ``stencil1d_lanes_step_plain`` -- which the CUDA
kernels are held to on the card -- against the JAX flat kernel
``pallas_1d.stencil1d_step(..., bounds=, interpret=True)`` on the same cells
for the boxes of an inner, a first and a tailed last shard; then, without
JAX: the windows of the overlapped step (head tile, tail tile, inner window)
and of other splits assemble the whole pass, a window leaves every other cell
as it was, ``region=None`` is the pass it was (a frozen copy of the twin
before windows), the host's window arithmetic (a mirror of the entries'
``in_window``) gives the same cells, the 1-D shard boxes ``check_bounds``
takes, and the refusals.

Tolerances: the 0..99 integer fill, for which every partial sum of one to
three steps of 1d1r / 1d2r (integer taps) is an integer below 2**24, so the
packages and the two sum orders agree bit for bit in float32."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu.ops import layout as jax_layout
from lorastencil_tpu.ops import pallas_1d
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil1d
from lorastencil_tpu_torch.ops.layout import TILE_1D, Layout1D, check_bounds, guard_1d

LOCAL = 3 * TILE_1D      # a shard's block: 3 tiles
GLOBAL = 2 * LOCAL + 1000  # over a (3,) mesh: the last shard holds 1000 cells
TWINS = {"wide": stencil1d.stencil1d_step_plain, "narrow": stencil1d.stencil1d_lanes_step_plain}
WRAPPERS = {"wide": stencil1d.stencil1d_step, "narrow": stencil1d.stencil1d_lanes_step}


def box(ix, d=0):
    """The sharded engine's box of shard ix (domain.ShardedStencil1D._bounds)."""
    return (-ix * LOCAL - d, GLOBAL - ix * LOCAL + d)


def port_layout(spec, k, n=LOCAL):
    return Layout1D(interior=n, halo=spec.halo[0], tile=TILE_1D,
                    guard=guard_1d(spec.halo[0], k * spec.radius))


def fill(lay, seed, dtype=torch.float32):
    """The 0..99 integer fill over the whole buffer, guard too."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 100, lay.shape).astype(np.float64)).to(dtype)


def jax_pass(x, spec, lay, k, bounds):
    """The JAX flat kernel on the same cells: the port buffer placed in a JAX
    layout of the same interior (rows of 128 lanes, 8 guard rows)."""
    jlay = jax_layout.Layout1D(interior=LOCAL, halo=spec.halo[0], tile_rows=16, guard_rows=8)
    jo, po = jlay.origin, lay.origin
    flat = np.zeros(jlay.shape[0] * jlay.shape[1])
    flat[jo - po: jo - po + lay.shape[0]] = x.double().numpy()
    out = pallas_1d.stencil1d_step(
        jnp.asarray(flat.reshape(jlay.shape), jnp.float32), jnp.zeros(jlay.shape, jnp.float32),
        spec, jlay, interpret=True, fused_steps=k,
        bounds=None if bounds is None else jnp.asarray(bounds, jnp.int32))
    return np.asarray(out, np.float64).reshape(-1)[jo: jo + LOCAL]


@pytest.mark.parametrize("kernel", ["wide", "narrow"])
@pytest.mark.parametrize("k,shard", [(1, "inner"), (2, "first"), (3, "last"),
                                     (2, "last periodic")])
def test_twin_matches_the_jax_kernel(kernel, k, shard):
    """The JAX kernel masks every level to its bounds; the twins keep the box on
    the levels before the last and the box cut to the interior on the last:
    the same interior cells, the padding past a last shard's true edge zero."""
    spec = get_shape("1d2r")
    lay = port_layout(spec, k, LOCAL)
    d = k * spec.radius
    bounds = {"inner": box(1), "first": box(0), "last": box(2),
              "last periodic": box(2, d)}[shard]
    x = fill(lay, 11)
    got = TWINS[kernel](x, torch.zeros_like(x), spec, lay, k, bounds)
    o = lay.origin
    assert np.array_equal(got[o: o + LOCAL].double().numpy(), jax_pass(x, spec, lay, k, bounds))
    if shard == "last":
        assert not got[o + bounds[1]: o + LOCAL].any()


def old_twin(cur, donor, spec, layout, fused_steps, pairs, bounds=None):
    """The twins before windows and shard boxes, frozen here."""
    taps, r = stencil1d._taps(spec)
    o, n, nr = layout.origin, layout.interior, layout.rounded
    lo, hi = (0, n) if bounds is None else bounds
    e = fused_steps * r
    x = cur[o - e: o + nr + e].to(torch.float32 if cur.dtype == torch.bfloat16 else cur.dtype)
    for s in range(1, fused_steps + 1):
        e -= r
        x = stencil1d._conv(x, taps, r, pairs)
        if pairs:
            x = stencil1d._round_bf16(x, cur.dtype)
        a, b = (lo, hi) if s < fused_steps else (0, n)
        x[:max(0, e + a)] = 0
        x[max(0, e + b):] = 0
    donor[o: o + nr] = x
    return donor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kernel", ["wide", "narrow"])
@pytest.mark.parametrize("k,ghost", [(1, False), (2, False), (3, True)])
def test_no_region_is_the_pass_it_was(kernel, k, ghost, dtype):
    """region=None and a box that holds the interior: bit for bit the twin as it
    was, on a ragged interior (round-up cells) and a pi/100 fill."""
    spec = get_shape("1d1r")
    lay = port_layout(spec, k, 5000)
    d = k * spec.radius
    bounds = (-d, 5000 + d) if ghost else None
    x = (fill(lay, 5, torch.float64) * (np.pi / 100)).to(dtype)
    got = TWINS[kernel](x, torch.zeros_like(x), spec, lay, k, bounds)
    want = old_twin(x, torch.zeros_like(x), spec, lay, k, kernel == "narrow", bounds)
    assert torch.equal(got, want)
    whole = WRAPPERS[kernel](x, torch.zeros_like(x), spec, lay, fused_steps=k, bounds=bounds,
                             region=(0, lay.grid[0]))
    assert torch.equal(whole, want)


def windows(g):
    """The overlapped step's three windows (head tile, tail tile, inner) and a
    split into thirds."""
    a, b = g // 3, 2 * g // 3
    return [[(0, 1), (g - 1, g), (1, g - 1)], [(0, a), (a, b), (b, g)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kernel", ["wide", "narrow"])
@pytest.mark.parametrize("k,shard", [(1, 1), (2, 2), (3, 0)])
def test_windows_assemble_the_whole_pass(kernel, k, shard, dtype):
    """The windows of a split, one after another into one output, give the
    whole pass bit for bit; each window alone writes its own cells only (the
    rest stays NaN)."""
    spec = get_shape("1d2r")
    lay = port_layout(spec, k, 6 * TILE_1D)
    (g,) = lay.grid
    x = (fill(lay, 3, torch.float64) * (np.pi / 100)).to(dtype)
    bounds = (-shard * 6 * TILE_1D, 16 * TILE_1D - shard * 6 * TILE_1D + 100)
    wrapper = WRAPPERS[kernel]
    whole = wrapper(x, torch.full_like(x, np.nan), spec, lay, fused_steps=k, bounds=bounds)
    o = lay.origin
    for split in windows(g):
        out = torch.full_like(x, np.nan)
        for region in split:
            alone = wrapper(x, torch.full_like(x, np.nan), spec, lay, fused_steps=k,
                            bounds=bounds, region=region)
            inside = torch.zeros(lay.shape, dtype=torch.bool)
            inside[o + region[0] * TILE_1D: o + region[1] * TILE_1D] = True
            assert torch.equal(alone[inside], whole[inside])
            assert alone[~inside].isnan().all()
            wrapper(x, out, spec, lay, fused_steps=k, bounds=bounds, region=region)
        assert torch.equal(out.nan_to_num(-1.0), whole.nan_to_num(-1.0))


def in_window(origin, n, rounded, lo, hi, w0, w1):
    """csrc/stencil1d.cu in_window, mirrored: the launch of a window."""
    assert 0 <= w0 < w1 <= rounded
    nw = min(max(min(hi, n) - w0, 0), w1 - w0)
    return origin + w0, nw, w1 - w0, lo - w0, max(hi - w0, nw)


@pytest.mark.parametrize("kernel", ["wide", "narrow"])
@pytest.mark.parametrize("bounds", [None, box(1), box(2), box(2, 8), box(0, 8)])
def test_host_window_is_the_region(kernel, bounds):
    """A launch over the window that in_window makes of a region -- its origin,
    interior, rounded extent and box moved to the window's first cell, the
    interior cut at the box's end -- computes the region's cells: the twin
    run as that launch equals the twin over the region."""
    spec = get_shape("1d1r")
    k = 2
    lay = port_layout(spec, k, LOCAL)
    x = fill(lay, 8)
    lo, hi = check_bounds(bounds, (LOCAL,), (lay.guard,), shard=True)
    pairs = kernel == "narrow"
    for region in ((0, 1), (2, 3), (1, 3), (0, 3)):
        w0, w1 = region[0] * TILE_1D, region[1] * TILE_1D
        o, n, rounded, wlo, whi = in_window(lay.origin, LOCAL, lay.rounded, lo, hi, w0, w1)
        assert wlo <= 0 and whi >= n  # what the entry then checks
        launch = types.SimpleNamespace(origin=o, interior=n, rounded=rounded)
        got = stencil1d._pass_plain(x, spec, launch, k, pairs, (wlo, whi))
        want = TWINS[kernel](x, torch.full_like(x, np.nan), spec, lay, k, bounds, region)
        assert torch.equal(got, want[o: o + rounded])


def test_check_bounds_takes_1d_shard_boxes():
    """JAX's 1-D boxes: an inner shard's start beyond the guard is cut to the
    guard, an end inside the interior stays, one beyond the guard is cut; the
    strict check (no ``shard``) refuses them."""
    assert check_bounds(box(1), (LOCAL,), (8,), shard=True) == (-8, LOCAL + 8)
    assert check_bounds(box(2), (LOCAL,), (8,), shard=True) == (-8, 1000)
    assert check_bounds(box(0, 4), (LOCAL,), (8,), shard=True) == (-4, LOCAL + 8)
    for bad in ((1, 100), (0,), "ab"):
        with pytest.raises(ValueError, match="bounds"):
            check_bounds(bad, (LOCAL,), (8,), shard=True)
    with pytest.raises(ValueError, match="guard 8"):
        check_bounds(box(2), (LOCAL,), (8,))


@pytest.mark.parametrize("kernel", ["wide", "narrow"])
def test_region_refusals(kernel):
    """A window off the tile grid, a layout whose tile is not whole kernel
    tiles, and a box that starts inside the interior are refused by name; a
    shard's box is taken."""
    spec = get_shape("1d2r")
    wrapper = WRAPPERS[kernel]
    lay = port_layout(spec, 1)
    x = fill(lay, 2)
    for region in ((0, 4), (1, 1), (-1, 1), (0,), "ab"):
        with pytest.raises(ValueError, match="region"):
            wrapper(x, torch.zeros_like(x), spec, lay, region=region)
    small = Layout1D(interior=LOCAL, halo=4, tile=512, guard=8)
    y = fill(small, 2)
    with pytest.raises(ValueError, match=f"multiple of {TILE_1D}"):
        wrapper(y, torch.zeros_like(y), spec, small, region=(0, 1))
    wrapper(y, torch.zeros_like(y), spec, small)  # no region: any tile
    wrapper(x, torch.zeros_like(x), spec, lay, bounds=box(2))
    for bad in ((1, LOCAL), (0, LOCAL, 0)):
        with pytest.raises(ValueError, match="bounds"):
            wrapper(x, torch.zeros_like(x), spec, lay, bounds=bad)
