"""The 2-D pass over a window of tiles (``region``) and under a shard's box
(``bounds`` from the sharded engine, ``check_bounds(..., shard=True)``), on the
CPU: ``stencil2d.stencil2d_step_plain`` -- the twin the CUDA kernels are held
to on the card -- against the JAX kernel ``pallas_2d.stencil2d_step(...,
region=, bounds=, interpret=True)`` on the same local buffer, at k = 1 and 2,
float32 and bfloat16, for the boxes of an inner, a first and a tailed last
shard; then, without JAX: the windows of a split assemble the whole pass, a
window leaves every other cell as it was, ``region=None`` is the pass it was
(a frozen copy of the twin before windows), the shard boxes ``check_bounds``
takes and cuts, and the refusals.

Tolerances: the 0..99 integer fill, for which every partial sum of one or two
steps of a registry shape is an integer below 2**24, so the two packages agree
bit for bit in float32; in bfloat16 both round once a pass, at the store
(JAX 'vpu_roll'), so they agree bit for bit too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu.ops import layout as jax_layout
from lorastencil_tpu.ops import pallas_2d
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.band_gemm import apply_spec, mask_to_interior
from lorastencil_tpu_torch.ops.layout import Layout2D, check_bounds, compute_dtype, guard_2d

LOCAL = (24, 384)        # a shard's block: 3 x 3 tiles of (8, 128)
TILE = (8, 128)
GLOBAL = (70, 1100)      # over a (3, 3) mesh: the last shards hold 22 and 332 cells
SENTINEL = 7.0


def box(ix, iy, d=0):
    """The sharded engine's box of shard (ix, iy) (domain._bounds)."""
    lm, ln = LOCAL
    gm, gn = GLOBAL
    return (-ix * lm - d, gm - ix * lm + d, -iy * ln - d, gn - iy * ln + d)


def port_layout(spec, k):
    return Layout2D(interior=LOCAL, halo=spec.halo, tile=TILE,
                    guard=guard_2d(spec.halo, k * spec.radius))


def fill(lay, seed, dtype=torch.float32):
    """The 0..99 integer fill over the whole buffer, ring and guard too."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 100, lay.shape).astype(np.float64)).to(dtype)


def jax_pass(x, spec, lay, k, bounds, region):
    """The JAX kernel on the same cells: the port buffer placed in a JAX layout
    of the same interior and tile (its wider guard zero beyond the port's)."""
    jlay = jax_layout.Layout2D(interior=LOCAL, halo=spec.halo, tile=TILE,
                               guard=(8, 128))
    (pr, pc), (jr, jc) = lay.origin, jlay.origin
    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    cur = np.zeros(jlay.shape)
    cur[jr - pr: jr - pr + lay.shape[0], jc - pc: jc - pc + lay.shape[1]] = x.double().numpy()
    donor = jnp.full(jlay.shape, SENTINEL, dt)
    out = pallas_2d.stencil2d_step(
        jnp.asarray(cur, dt), donor, spec, jlay, interpret=True, algorithm="vpu_roll",
        fused_steps=k, bounds=None if bounds is None else jnp.asarray(bounds, jnp.int32),
        region=region)
    out = np.asarray(out.astype(jnp.float32), np.float64)
    return out[jr - pr: jr - pr + lay.shape[0], jc - pc: jc - pc + lay.shape[1]]


@pytest.mark.parametrize("k,dtype,shard,region", [
    (1, torch.float32, "inner", ((1, 2), (1, 2))),
    (2, torch.float32, "inner", ((0, 1), (0, 3))),
    (2, torch.float32, "first", ((1, 2), (0, 1))),
    (2, torch.float32, "last", None),
    (2, torch.float32, "last periodic", ((1, 2), (2, 3))),
    (1, torch.float32, "none", ((2, 3), (0, 3))),
    (1, torch.bfloat16, "last", ((2, 3), (0, 3))),
    (2, torch.bfloat16, "inner", ((1, 2), (1, 2))),
])
def test_twin_matches_the_jax_kernel(k, dtype, shard, region):
    spec = get_shape("star2d3r" if k == 2 else "box2d3r")
    lay = port_layout(spec, k)
    d = k * spec.radius
    bounds = {"inner": box(1, 1), "first": box(0, 0), "last": box(2, 2),
              "last periodic": box(2, 2, d), "none": None}[shard]
    x = fill(lay, 11, dtype)
    donor = torch.full(lay.shape, SENTINEL, dtype=dtype)
    got = stencil2d.stencil2d_step_plain(x, donor, spec, lay, k, bounds, region)
    assert np.array_equal(got.double().numpy(), jax_pass(x, spec, lay, k, bounds, region))


def old_twin(cur, donor, spec, layout, fused_steps=1, bounds=None):
    """stencil2d_step_plain before windows and shard boxes, frozen here."""
    r = spec.radius
    r0, c0 = layout.origin
    mr, nr = layout.rounded
    e = fused_steps * r
    val = cur[r0 - e: r0 + mr + e, c0 - e: c0 + nr + e].to(compute_dtype(cur.dtype))
    for level in range(1, fused_steps + 1):
        e -= r
        val = mask_to_interior(apply_spec(val, spec, (r, r)), *layout.interior, margin=e,
                               bounds=bounds if level < fused_steps else None)
    donor[r0: r0 + mr, c0: c0 + nr] = val
    return donor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("k,ghost", [(1, False), (2, False), (3, True)])
def test_no_region_is_the_pass_it_was(k, ghost, dtype):
    """region=None and a box that holds the interior: bit for bit the twin as it
    was, on a ragged interior (round-up cells) and a pi/100 fill."""
    spec = get_shape("star2d1r")
    interior = (37, 300)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=(32, 128),
                   guard=guard_2d(spec.halo, k * spec.radius))
    d = k * spec.radius
    bounds = (-d, interior[0] + d, -d, interior[1] + d) if ghost else None
    x = (fill(lay, 5, torch.float64) * (np.pi / 100)).to(dtype)
    got = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k, bounds)
    want = old_twin(x, torch.zeros_like(x), spec, lay, k, bounds)
    assert torch.equal(got, want)
    gi, gj = lay.grid
    full = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k, bounds,
                                          ((0, gi), (0, gj)))
    assert torch.equal(full, want)


def split_windows(gi, gj):
    """The five windows of a 3 x 3 split of a gi x gj tile grid: the top and
    bottom bands, the middle band's left and right blocks, and its centre."""
    a, b = gi // 3, 2 * gi // 3
    c, d = gj // 3, 2 * gj // 3
    return [((0, a), (0, gj)), ((b, gi), (0, gj)), ((a, b), (0, c)), ((a, b), (d, gj)),
            ((a, b), (c, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,shard", [(1, (1, 1)), (2, (2, 2)), (2, (0, 2))])
def test_windows_assemble_the_whole_pass(k, shard, dtype):
    """The five windows of a 3 x 3 split, launched one after another into one
    output, give the whole pass bit for bit; each window alone writes its own
    cells only (the rest stays NaN), and so does a one-tile window."""
    spec = get_shape("star2d3r")
    lay = Layout2D(interior=(96, 768), halo=spec.halo, tile=(8, 128),
                   guard=guard_2d(spec.halo, k * spec.radius))
    gi, gj = lay.grid
    bounds = box(*shard)
    x = (fill(lay, 3, torch.float64) * (np.pi / 100)).to(dtype)
    whole = stencil2d.stencil2d_step_plain(x, torch.full_like(x, np.nan), spec, lay, k, bounds)
    out = torch.full_like(x, np.nan)
    r0, c0 = lay.origin
    for region in split_windows(gi, gj) + [((gi - 1, gi), (1, 2))]:
        alone = stencil2d.stencil2d_step(x, torch.full_like(x, np.nan), spec, lay,
                                         fused_steps=k, bounds=bounds, region=region)
        (i0, i1), (j0, j1) = ((a * t, b * t) for (a, b), t in zip(region, lay.tile))
        inside = torch.zeros(lay.shape, dtype=torch.bool)
        inside[r0 + i0: r0 + i1, c0 + j0: c0 + j1] = True
        assert torch.equal(alone[inside], whole[inside])
        assert alone[~inside].isnan().all()
        if region[0][1] - region[0][0] > 1 or region[1] != (1, 2):
            stencil2d.stencil2d_step(x, out, spec, lay, fused_steps=k, bounds=bounds,
                                     region=region)
    assert torch.equal(out.nan_to_num(-1.0), whole.nan_to_num(-1.0))


def test_tailed_box_zeroes_the_padding():
    """A last shard's box ends inside the interior (hi < m): the cells past it
    are zero after the pass, at every level, as the JAX kernel's last level
    masks to its bounds."""
    spec = get_shape("star2d1r")
    lay = port_layout(spec, 2)
    x = fill(lay, 4)
    bounds = box(2, 2)
    out = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, 2, bounds)
    r0, c0 = lay.origin
    tail = out[r0: r0 + LOCAL[0], c0: c0 + LOCAL[1]]
    assert not tail[bounds[1]:, :].any() and not tail[:, bounds[3]:].any()
    assert tail[: bounds[1], : bounds[3]].all()


def test_check_bounds_takes_shard_boxes():
    """JAX's boxes: an inner shard's start beyond the guard is cut to the guard,
    an end inside the interior stays, an end beyond the guard is cut to it; the
    strict check (1-D and 3-D, and no ``shard``) still refuses them."""
    interior, guard = (24, 384), (8, 8)
    assert check_bounds((-24, 48, -384, 768), interior, guard, shard=True) == (-8, 32, -8, 392)
    assert check_bounds((-48, 22, -768, 332), interior, guard, shard=True) == (-8, 22, -8, 332)
    assert check_bounds((-54, -2, 0, 384), interior, guard, shard=True) == (-8, 0, 0, 384)
    assert check_bounds(None, interior, guard, shard=True) == (0, 24, 0, 384)
    for bad in ((1, 24, 0, 384), (0, 24, 3, 384), (0, 24), "ab"):
        with pytest.raises(ValueError, match="bounds"):
            check_bounds(bad, interior, guard, shard=True)
    with pytest.raises(ValueError, match="guard 8"):
        check_bounds((-24, 48, -384, 768), interior, guard)


def test_region_refusals():
    spec = get_shape("star2d1r")
    lay = port_layout(spec, 1)
    x = fill(lay, 2)
    for region in (((0, 4), (0, 1)), ((1, 1), (0, 1)), ((0, 1), (-1, 1)), ((0, 1),), "ab"):
        with pytest.raises(ValueError, match="region"):
            stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay, region=region)
    # a pass deeper than one launch cannot keep a window, on the CPU as on a card
    k = stencil2d.launch_depths("step", spec, torch.float32, 1000)[0] + 1
    deep = Layout2D(interior=(96, 384), halo=spec.halo, tile=(32, 128),
                    guard=guard_2d(spec.halo, k * spec.radius))
    y = fill(deep, 2)
    with pytest.raises(ValueError, match=f"{k} fused steps"):
        stencil2d.stencil2d_step(y, torch.zeros_like(y), spec, deep, fused_steps=k,
                                 region=((0, 1), (0, 1)))
    stencil2d.stencil2d_step(y, torch.zeros_like(y), spec, deep, fused_steps=k - 1,
                             region=((0, 1), (0, 1)))
