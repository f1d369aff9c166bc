"""The port's 2-D stencil kernel module (lorastencil_tpu_torch.ops.stencil2d)
against the JAX Pallas kernel it replaces, on the CPU.

On a CPU tensor the port's wrapper runs the kernel's plain PyTorch twin; the
JAX kernel runs in Pallas interpret mode.  Both get the same internal buffer
(the JAX layout's own guard and tile), made from a seed with NumPy.  With the
integer fill every partial sum is an integer below 2**24, so the two must
agree bit for bit whatever order they sum in.  The CUDA kernel itself is held
against the same twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu.models.shapes import get_shape as jax_get_shape
from lorastencil_tpu.ops import pallas_2d, xla_ref
from lorastencil_tpu.ops.layout import Layout2D as JaxLayout2D
from lorastencil_tpu.ops.layout import default_tile_2d as jax_default_tile
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import band_gemm, stencil2d, torch_ref
from lorastencil_tpu_torch.ops.layout import Layout2D
from lorastencil_tpu_torch.utils import reference


def _layouts(spec, interior, tile=None):
    jl = JaxLayout2D(interior=interior, halo=spec.halo,
                     tile=tile or jax_default_tile(*interior), guard=(8, 128))
    pl = Layout2D(interior=interior, halo=spec.halo, tile=jl.tile, guard=jl.guard)
    return jl, pl


@pytest.mark.parametrize("interior", [(64, 256), (40, 300)])
@pytest.mark.parametrize("name", ["star2d1r", "box2d1r", "box2d3r", "star2d3r"])
def test_step_matches_pallas_kernel_bit_for_bit(name, interior):
    spec = get_shape(name)
    jl, pl = _layouts(spec, interior)
    g0 = reference.random_padded(spec, interior, seed=7)
    x = np.asarray(jl.to_internal(g0))
    want = np.asarray(pallas_2d.stencil2d_step(
        jnp.asarray(x), jnp.zeros_like(x), jax_get_shape(name), jl, interpret=True,
        algorithm="mxu_hybrid1", fused_steps=1))
    cur = torch.from_numpy(x.copy())
    donor = torch.zeros_like(cur)
    got = stencil2d.stencil2d_step(cur, donor, spec, pl, algorithm="mxu_hybrid1")
    assert got is donor
    assert np.array_equal(got.numpy(), want)  # the whole buffer, ring included
    assert np.array_equal(cur.numpy(), x)  # the input is only read
    assert np.array_equal(pl.from_internal(got).numpy(), reference.run(g0, spec, 1))


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r"])
def test_ragged_tiles_zero_round_up_and_keep_donor_ring(name):
    """A tile that divides neither axis: round-up cells are written as zeros
    even where the input holds garbage, and the donor's ring is not touched."""
    spec = get_shape(name)
    interior = (37, 45)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=(16, 32), guard=(4, 4))
    g0 = reference.random_padded(spec, interior, seed=3)
    cur = lay.to_internal(g0)
    r0, c0 = lay.origin
    mr, nr = lay.rounded
    assert (mr, nr) == (48, 64)
    cur[r0 + interior[0] + 4: r0 + mr, c0: c0 + nr] = 5.0  # round-up garbage
    donor = torch.full(lay.shape, 7.0)
    stencil2d.stencil2d_step_plain(cur, donor, spec, lay)
    assert torch.all(donor[r0 + interior[0]: r0 + mr, c0: c0 + nr] == 0)
    assert torch.all(donor[r0: r0 + mr, c0 + interior[1]: c0 + nr] == 0)
    ring = torch.ones(lay.shape, dtype=torch.bool)
    ring[r0: r0 + mr, c0: c0 + nr] = False
    assert torch.all(donor[ring] == 7.0)


def test_plan_array_encodes_identity_axes():
    spec = get_shape("star2d3r")  # one-sided terms: (taps, None), (None, taps)
    plan = band_gemm.plan_array(spec).tolist()
    W = 2 * spec.radius + 1
    t0, t1 = plan[: 2 + 2 * W], plan[2 + 2 * W: 4 + 4 * W]
    assert t0[:2] == [0.0, 1.0] and t0[2: 2 + W] == [0.0] * W
    assert t0[2 + W:] == list(spec.terms[0].taps[0])
    assert t1[:2] == [1.0, 0.0] and t1[2: 2 + W] == list(spec.terms[1].taps[1])
    assert len(plan) == 4 + 4 * W  # no residue
    star = band_gemm.plan_array(get_shape("star2d1r"))
    assert star.numel() == 2 + 2 * W + 3 * len(get_shape("star2d1r").residue)


@pytest.mark.parametrize("fn,jax_fn", [(torch_ref.dense_step, xla_ref.dense_step),
                                       (torch_ref.separable_step, xla_ref.separable_step)])
@pytest.mark.parametrize("name", ["star2d1r", "box2d3r", "star2d3r"])
def test_reference_steps_match_xla_ref(fn, jax_fn, name):
    spec = get_shape(name)
    g0 = reference.random_padded(spec, (24, 40), seed=11)
    got = fn(torch.from_numpy(g0.astype(np.float32)), spec).numpy()
    want = np.asarray(jax_fn(jnp.asarray(g0, jnp.float32), jax_get_shape(name)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, reference.run(g0, spec, 1))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    spec = get_shape("star2d1r")
    lay = Layout2D(interior=(16, 16), halo=spec.halo, tile=(16, 16), guard=(4, 4))
    cur = torch.zeros(lay.shape)
    donor = torch.zeros(lay.shape)
    with pytest.raises(ValueError, match="reach"):  # fused_steps * radius > guard
        stencil2d.stencil2d_step(cur, donor, spec, lay, fused_steps=2)
    with pytest.raises(NotImplementedError, match="B13"):
        stencil2d.stencil2d_step(cur, donor, spec, lay, algorithm="mxu_split")
    with pytest.raises(ValueError, match="unknown algorithm"):
        stencil2d.stencil2d_step(cur, donor, spec, lay, algorithm="fast")
    with pytest.raises(TypeError):
        stencil2d.stencil2d_step(cur.half(), donor.half(), spec, lay)
    with pytest.raises(ValueError, match="contiguous"):
        stencil2d.stencil2d_step(cur.t(), donor, spec, lay)
    with pytest.raises(ValueError, match="different buffer"):
        stencil2d.stencil2d_step(cur, cur, spec, lay)
    with pytest.raises(ValueError, match="shape"):
        stencil2d.stencil2d_step(cur[1:], donor, spec, lay)
    narrow = Layout2D(interior=(16, 16), halo=(2, 2), tile=(16, 16), guard=(2, 2))
    with pytest.raises(ValueError, match="guard"):
        stencil2d.stencil2d_step(torch.zeros(narrow.shape), torch.zeros(narrow.shape),
                                 spec, narrow)
    before = stencil2d.stencil2d_step.launches
    stencil2d.stencil2d_step(cur, donor, spec, lay)  # a CPU tensor launches nothing
    assert stencil2d.stencil2d_step.launches == before
