"""Periodic and reflect boundaries (ROADMAP A6(a)) of the port in 3-D, on the
CPU: the port's StencilEngine (device="cpu") against the JAX engine (Pallas
interpret mode) and both against ``utils/reference.run_periodic`` /
``run_reflect``, twinning tests/test_boundary.py's 3-D cases at its (6, 16,
150) interior; the fp64-grade tier, a deeper fused pass (the general
kernel's on the card), the 4-value bounds of the JAX 3-D wrapper, and a
pass split across launches refilling the ring between them.  Tolerances as
tests/test_torch_boundary1d.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil3d
from torch_boundary_common import both, check, padded_input, rel_err, truth

INTERIOR = (6, 16, 150)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_periodic_3d_shapes(name, steps):
    peng, jeng = both(name, INTERIOR, "periodic")
    assert peng._fused_k() == jeng._fused_k() == 2
    assert peng._ghost_bounds() == (-2, 8, -2, 18, -2, 152)
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 41), steps, "periodic")


@pytest.mark.parametrize("steps", [1, 3])
def test_reflect_box3d1r(steps):
    peng, jeng = both("box3d1r", INTERIOR, "reflect")
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 43), steps, "reflect")


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_deeper_fused_pass_3d(boundary):
    """fused_steps_3d = 4: on the card the general kernel's pass (the march
    kernel takes one or two levels); the ring is 4 deep."""
    peng, jeng = both("star3d1r", (8, 16, 150), boundary, fused_steps_3d=4)
    assert peng._fused_k() == jeng._fused_k() == 4 and peng._ring_depth() == 4
    assert not stencil3d.march_takes(peng.spec, torch.float32, 4)
    check(peng, jeng, padded_input(peng.spec, (8, 16, 150), 44), 5, boundary)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
@pytest.mark.parametrize("dtype", ["df64", "float64"])
def test_fp64_3d(dtype, name, boundary, x64):
    """df64 one step per pass, float64 two (the float32 rules)."""
    peng, jeng = both(name, INTERIOR, boundary, dtype)
    assert peng._fused_k() == jeng._fused_k() == (1 if dtype == "df64" else 2)
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 45), 3, boundary, dtype)


def test_run_checksum_3d():
    peng, jeng = both("box3d1r", INTERIOR, "periodic")
    padded = padded_input(peng.spec, INTERIOR, 47)
    want = truth("periodic", padded, peng.spec, 4)
    s = float(peng.run_checksum(padded, 4))
    assert abs(s - want.sum()) <= 1e-6 * np.abs(want).sum()
    assert abs(s - float(jeng.run_checksum(jnp.asarray(padded, jnp.float32), 4))) <= (
        1e-6 * np.abs(want).sum())


def test_four_value_bounds_keep_the_z_interior():
    """The JAX 3-D wrapper's 4 values are the rows' and columns' box; z then
    keeps [0, h): the same pass as 6 values with the z interior."""
    spec = get_shape("box3d1r")
    eng = engine.StencilEngine.for_shape("box3d1r", INTERIOR, device="cpu",
                                         boundary="periodic")
    x = eng._ring_refresh(eng.to_internal(padded_input(spec, INTERIOR, 48)), "periodic")
    b = eng._ghost_bounds()
    four = stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, eng.layout,
                                    fused_steps=2, bounds=b[2:])
    six = stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, eng.layout,
                                   fused_steps=2, bounds=(0, INTERIOR[0]) + b[2:])
    ghost = stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, eng.layout,
                                     fused_steps=2, bounds=b)
    assert torch.equal(four, six) and not torch.equal(four, ghost)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_split_pass_refills_the_ring_3d(boundary, monkeypatch):
    """A pass that the general kernel's shared memory splits (plan_pass
    here made to take 2 levels a launch) refills the ring of the buffer
    between its launches; each launch replaced by the twin, the pass
    matches the ground truth."""
    spec = get_shape("star3d1r")
    interior = (8, 12, 40)
    eng = engine.StencilEngine.for_shape("star3d1r", interior, device="cpu",
                                         boundary=boundary, fused_steps_3d=4)
    launches = []

    def fake_general(cur, out, spec_, layout, depth, tile, box=None):
        launches.append((depth, box))
        return stencil3d.stencil3d_step_plain(cur, out, spec_, layout, depth, box)

    monkeypatch.setattr(stencil3d, "_launch", fake_general)
    monkeypatch.setattr(stencil3d, "plan_pass", lambda spec_, depth, itemsize: (
        min(depth, 3), (32, 64)))
    padded = padded_input(spec, interior, 49)
    x = eng._ring_refresh(eng.to_internal(padded), boundary)
    out = stencil3d._kernel_pass(x, torch.zeros_like(x), spec, eng.layout, 4,
                                 eng._ghost_bounds(),
                                 lambda s: eng._ring_refresh(s, boundary))
    assert launches == [(3, eng._ghost_bounds()), (1, eng._ghost_bounds())]
    got = eng.from_internal(eng._ring_refresh(out, "zero")).numpy()
    assert rel_err(got, truth(boundary, padded, spec, 4)) <= 1e-6
