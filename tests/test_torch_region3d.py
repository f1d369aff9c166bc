"""The 3-D pass over a window of (row, column) tiles (``region``) and under a
shard's box (``bounds`` from the sharded engine, ``check_bounds(..., shard=True)``), on the
CPU: ``stencil3d.stencil3d_step_plain`` -- the twin both CUDA kernels (march
and general) are held to on the card -- against the JAX kernel
``pallas_3d.stencil3d_step(..., region=, bounds=, interpret=True)`` on the
same local buffer (the port's layout given the JAX guard and tile), for the
4- and 6-value boxes of an inner, a first and a tailed last shard, a z
shard's box included; then, without JAX: the overlapped step's five windows
assemble the whole pass, a window leaves every other cell as it was,
``region=None`` is the pass it was (a frozen copy of the twin before
windows), the host's window arithmetic (a mirror of the entries'
``in_window``) gives the same cells, the 3-D shard boxes ``check_bounds``
takes, ``smem_bytes``' mirror of the kernel's sizing, and the refusals (a
pass the general kernel's shared memory splits keeps no window).

Tolerances: the 0..99 integer fill, for which every partial sum of one or two
steps of star3d1r / box3d1r (integer taps) is an integer below 2**24, so the
packages agree bit for bit in float32."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu.ops import layout as jax_layout
from lorastencil_tpu.ops import pallas_3d
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil3d
from lorastencil_tpu_torch.ops.band_gemm import apply_spec_3d
from lorastencil_tpu_torch.ops.layout import Layout3D, check_bounds, compute_dtype

LOCAL = (4, 24, 384)      # a shard's block: 3 x 3 tiles of (8, 128)
TILE = (8, 128)
GLOBAL = (7, 70, 1100)    # over a (2, 3, 3) mesh: the last shards hold 3, 22, 332


def box(iz, ix, iy, d=0, zd=0, z=True):
    """The sharded engine's box of shard (iz, ix, iy) (ShardedStencil3D._bounds):
    6 values with z, else 4."""
    lz, lm, ln = LOCAL
    H, gm, gn = GLOBAL
    plane = (-ix * lm - d, gm - ix * lm + d, -iy * ln - d, gn - iy * ln + d)
    return ((-iz * lz - zd, H - iz * lz + zd) if z else ()) + plane


def layouts(spec, k):
    """(port layout, JAX layout) of one buffer: the JAX guard (zguard, 8, 128)."""
    zg = max(spec.halo[0], k * spec.radius)
    jlay = jax_layout.Layout3D(interior=LOCAL, halo=spec.halo, tile=TILE, zguard=zg)
    return Layout3D(interior=LOCAL, halo=spec.halo, tile=TILE, guard=jlay.origin), jlay


def fill(lay, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 100, lay.shape).astype(np.float64)).to(dtype)


@pytest.mark.parametrize("name,k,bounds,region", [
    ("star3d1r", 2, box(0, 1, 1, z=False), ((0, 1), (0, 3))),
    ("box3d1r", 2, box(1, 2, 2), ((1, 2), (1, 2))),
    ("box3d1r", 1, box(0, 0, 2, 1, 1), ((2, 3), (0, 3))),
    ("star3d1r", 2, box(1, 2, 0, 2, 2), None),
])
def test_twin_matches_the_jax_kernel(name, k, bounds, region):
    spec = get_shape(name)
    lay, jlay = layouts(spec, k)
    assert lay.shape == jlay.shape
    x = fill(lay, 21)
    sentinel = 7.0
    got = stencil3d.stencil3d_step_plain(x, torch.full_like(x, sentinel), spec, lay, k, bounds,
                                         region)
    want = pallas_3d.stencil3d_step(
        jnp.asarray(x.numpy()), jnp.full(jlay.shape, sentinel, jnp.float32), spec, jlay,
        interpret=True, algorithm="vpu", fused_steps=k,
        bounds=jnp.asarray(bounds, jnp.int32), region=region)
    assert np.array_equal(got.numpy(), np.asarray(want))


def old_twin(cur, donor, spec, layout, fused_steps=1, bounds=None):
    """stencil3d_step_plain before windows and shard boxes, frozen here."""
    K, r = fused_steps, spec.radius
    h, m, n = layout.interior
    _, mr, nr = layout.rounded
    z0, r0, c0 = layout.origin
    box_ = check_bounds(bounds, layout.interior, layout.guard)
    e = K * r
    level = cur[z0 - e: z0 + h + e, r0 - e: r0 + mr + e, c0 - e: c0 + nr + e].to(
        compute_dtype(cur.dtype))
    for L in range(1, K + 1):
        e = (K - L) * r
        full = apply_spec_3d(level, spec)
        lohi = box_ if L < K else (0, h, 0, m, 0, n)
        inside = tuple(slice(max(0, e + lohi[2 * a]), e + lohi[2 * a + 1]) for a in range(3))
        level = torch.zeros_like(full)
        level[inside] = full[inside]
    donor[z0: z0 + h, r0: r0 + mr, c0: c0 + nr] = level
    return donor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("k,ghost", [(1, False), (2, False), (2, True)])
def test_no_region_is_the_pass_it_was(k, ghost, dtype):
    """region=None and a box that holds the interior: bit for bit the twin as it
    was, on a ragged plane (round-up cells) and a pi/100 fill."""
    spec = get_shape("box3d1r")
    interior = (5, 37, 150)
    d = k * spec.radius
    lay = Layout3D(interior=interior, halo=spec.halo, tile=(32, 64), guard=(2, 4, 4))
    bounds = (-d, 5 + d, -d, 37 + d, -d, 150 + d) if ghost else None
    x = (fill(lay, 5, torch.float64) * (np.pi / 100)).to(dtype)
    want = old_twin(x, torch.zeros_like(x), spec, lay, k, bounds)
    got = stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, k, bounds)
    assert torch.equal(got, want)
    gi, gj = lay.grid
    whole = stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, lay, fused_steps=k,
                                     bounds=bounds, region=((0, gi), (0, gj)))
    assert torch.equal(whole, want)


def overlap_windows(gi, gj):
    """The overlapped step's windows: the four frame windows, then the inner."""
    return [((0, 1), (0, gj)), ((gi - 1, gi), (0, gj)), ((1, gi - 1), (0, 1)),
            ((1, gi - 1), (gj - 1, gj)), ((1, gi - 1), (1, gj - 1))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,k,shard", [("star3d1r", 2, (0, 1, 1)),
                                          ("box3d1r", 1, (1, 2, 2)),
                                          ("box3d1r", 2, (0, 0, 2))])
def test_windows_assemble_the_whole_pass(name, k, shard, dtype):
    """The overlapped step's five windows into one output give the whole pass
    bit for bit; each window alone writes its own rows and columns only (every
    plane; the rest stays NaN)."""
    spec = get_shape(name)
    lay, _ = layouts(spec, k)
    gi, gj = lay.grid
    bounds = box(*shard, d=2, zd=2)
    x = (fill(lay, 3, torch.float64) * (np.pi / 100)).to(dtype)
    whole = stencil3d.stencil3d_step(x, torch.full_like(x, np.nan), spec, lay, fused_steps=k,
                                     bounds=bounds)
    out = torch.full_like(x, np.nan)
    z0, r0, c0 = lay.origin
    for region in overlap_windows(gi, gj):
        alone = stencil3d.stencil3d_step(x, torch.full_like(x, np.nan), spec, lay,
                                         fused_steps=k, bounds=bounds, region=region)
        (i0, i1), (j0, j1) = ((a * t, b * t) for (a, b), t in zip(region, lay.tile))
        inside = torch.zeros(lay.shape, dtype=torch.bool)
        inside[z0: z0 + LOCAL[0], r0 + i0: r0 + i1, c0 + j0: c0 + j1] = True
        assert torch.equal(alone[inside], whole[inside])
        assert alone[~inside].isnan().all()
        stencil3d.stencil3d_step(x, out, spec, lay, fused_steps=k, bounds=bounds,
                                 region=region)
    assert torch.equal(out.nan_to_num(-1.0), whole.nan_to_num(-1.0))


def in_window(p, i0, i1, j0, j1):
    """csrc/stencil3d.cu in_window, mirrored on a dict of Pass fields."""
    assert 0 <= i0 < i1 <= p["mr"] and 0 <= j0 < j1 <= p["nr"]
    q = dict(p)
    q["hz"] = min(max(min(p["zh"], p["h"]), 0), p["h"])
    q["m"] = min(max(min(p["rh"], p["m"]) - i0, 0), i1 - i0)
    q["n"] = min(max(min(p["ch"], p["n"]) - j0, 0), j1 - j0)
    q["zh"] = max(p["zh"], q["hz"])
    q.update(r0=p["r0"] + i0, c0=p["c0"] + j0, mr=i1 - i0, nr=j1 - j0, rl=p["rl"] - i0,
             rh=max(p["rh"] - i0, q["m"]), cl=p["cl"] - j0, ch=max(p["ch"] - j0, q["n"]))
    return q


@pytest.mark.parametrize("bounds", [None, box(0, 1, 1), box(1, 2, 2), box(1, 2, 2, 2, 2),
                                    box(0, 0, 1, 2, 2, z=False)])
def test_host_window_is_the_region(bounds):
    """The pass that in_window makes of a region -- origin, plane, interior and
    box moved to the window, the interior cut at the box's ends (z too: hz) --
    computes the region's cells: the twin run as that pass (a layout whose
    interior is the cut one, over the same buffer) equals the twin over the
    region, and the box the entry then checks holds the cut interior."""
    spec = get_shape("box3d1r")
    k = 2
    lay, _ = layouts(spec, k)
    x = fill(lay, 8)
    b = check_bounds(bounds, LOCAL, lay.guard, shard=True)
    z0, r0, c0 = lay.origin
    p = dict(h=LOCAL[0], m=LOCAL[1], n=LOCAL[2], mr=lay.rounded[1], nr=lay.rounded[2],
             r0=r0, c0=c0, zl=b[0], zh=b[1], rl=b[2], rh=b[3], cl=b[4], ch=b[5])
    for region in ((0, 1), (0, 3)), ((1, 2), (1, 2)), ((2, 3), (2, 3)), ((0, 3), (0, 3)):
        (i0, i1), (j0, j1) = ((a * t, bb * t) for (a, bb), t in zip(region, TILE))
        q = in_window(p, i0, i1, j0, j1)
        assert q["zl"] <= 0 <= q["hz"] <= q["zh"] and q["rl"] <= 0 and q["rh"] >= q["m"]
        assert q["cl"] <= 0 and q["ch"] >= q["n"]
        # the pass as the kernel sees it: the window's cells at the origin
        view = x[:, q["r0"] - r0:, q["c0"] - c0:]
        view_lay = types.SimpleNamespace(
            interior=(q["hz"], q["m"], q["n"]), rounded=(LOCAL[0], q["mr"], q["nr"]),
            origin=(z0, r0, c0), guard=(z0, r0, c0))
        want = stencil3d.stencil3d_step_plain(x, torch.full_like(x, np.nan), spec, lay, k,
                                              bounds, region)
        got = launch_twin(view, spec, view_lay, k, (q["zl"], q["zh"], q["rl"], q["rh"],
                                                     q["cl"], q["ch"]))
        assert torch.equal(got, want[z0: z0 + LOCAL[0], r0 + i0: r0 + i1, c0 + j0: c0 + j1])


def launch_twin(x, spec, lay, K, box_):
    """The kernels' contract on a Pass: levels before the last keep the box,
    the last (and every level) the interior [0, hz) x [0, m) x [0, n) of the
    rounded plane; the rounded plane's cells returned, all h planes."""
    r = spec.radius
    h = lay.rounded[0]
    hz, m, n = lay.interior
    _, mr, nr = lay.rounded
    z0, r0, c0 = lay.origin
    e = K * r
    level = x[z0 - e: z0 + h + e, r0 - e: r0 + mr + e, c0 - e: c0 + nr + e].double()
    for L in range(1, K + 1):
        e = (K - L) * r
        full = apply_spec_3d(level, spec)
        lohi = box_ if L < K else (0, hz, 0, m, 0, n)
        inside = tuple(slice(max(0, e + lohi[2 * a]), max(0, e + lohi[2 * a + 1]))
                       for a in range(3))
        level = torch.zeros_like(full)
        level[inside] = full[inside]
    return level.to(x.dtype)


def test_check_bounds_takes_3d_shard_boxes():
    """JAX's 3-D boxes, 6 values (a z-sharded mesh, or a ghost boundary) or 4:
    starts beyond the guard cut to it, ends inside the interior kept."""
    interior, guard = LOCAL, (2, 8, 8)
    assert check_bounds(box(1, 1, 1), interior, guard, shard=True) == (
        -2, 3, -8, 32, -8, 392)
    assert check_bounds(box(0, 2, 2, z=False), interior, guard, shard=True) == (
        0, 4, -8, 22, -8, 332)
    assert check_bounds(box(0, 0, 0, 1, 1), interior, guard, shard=True) == (
        -1, 6, -1, 32, -1, 392)
    with pytest.raises(ValueError, match="guard"):
        check_bounds(box(1, 1, 1), interior, guard)


def test_smem_bytes_mirrors_the_kernel_sizing():
    """The general kernel's shared memory, hand-worked: star3d1r at K = 2 on a
    (32, 64) tile, float32: the 24-entry plan rounded to 24 cells, the input
    ring (3 + 1 planes of 36 x 68), level 1's ring (3 planes of 34 x 66), no
    conv rings; and the out-of-range answers."""
    n_buf, ring = stencil3d._term_mix(get_shape("star3d1r"))
    assert (n_buf, ring) == (0, 3)
    want = 4 * (24 + 4 * 36 * 68 + 3 * 34 * 66)
    assert stencil3d.smem_bytes(1, 2, 32, 64, 0, 3, 24 + 0, 4) == want
    assert stencil3d.smem_bytes(9, 1, 8, 8, 0, 1, 0, 4) == -1
    assert stencil3d.smem_bytes(8, 8, 32, 64, 0, 1, 0, 4) == -1  # over a block's cells
    assert stencil3d.smem_bytes(1, 1, 8, 8, 0, 1, 0, 2) == -1


def test_region_refusals():
    spec = get_shape("star3d1r")
    lay, _ = layouts(spec, 1)
    x = fill(lay, 2)
    for region in (((0, 4), (0, 1)), ((1, 1), (0, 1)), ((0, 1), (-1, 1)), ((0, 1),), "ab"):
        with pytest.raises(ValueError, match="region"):
            stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, lay, region=region)
    # a pass the general kernel's shared memory splits keeps no window, on the
    # CPU as on a card (a dense 5 x 5 x 5 spec of 14 terms at 3 levels: two
    # launches)
    spec7 = _dense5_spec()
    wide = Layout3D(interior=(8, 64, 256), halo=spec7.halo, tile=(32, 64), guard=(6, 8, 8))
    k = 3
    depths = stencil3d.launch_depths(spec7, torch.float32, k)
    assert depths == [2, 1], depths
    y = fill(wide, 2)
    with pytest.raises(ValueError, match=f"{k} fused steps"):
        stencil3d.stencil3d_step(y, torch.zeros_like(y), spec7, wide, fused_steps=k,
                                 region=((0, 1), (0, 1)))
    stencil3d.stencil3d_step(y, torch.zeros_like(y), spec7, wide, fused_steps=2,
                             region=((0, 1), (0, 1)))
    stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, lay, bounds=box(1, 2, 2))
    h, m, n = LOCAL
    for bad in ((1, h, 0, m, 0, n), (0, m, 3, n), (0, h, 0, m, 0)):
        with pytest.raises(ValueError, match="bounds"):
            stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, lay, bounds=bad)


def _dense5_spec():
    """A dense random 5 x 5 x 5 spec (per-plane 2-D terms and a residue,
    radius 2): the general kernel, whose rings at 3 levels need two
    launches."""
    from lorastencil_tpu_torch import engine

    rng = np.random.default_rng(0)
    rng.integers(1, 4, 33)  # the draws before it, where the spec was found
    S = rng.integers(1, 4, (5, 5, 5)).astype(np.float64)
    return engine.StencilEngine.for_coeffs(S, (8, 64, 256), device="cpu").spec
