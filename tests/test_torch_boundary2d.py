"""Periodic and reflect boundaries (ROADMAP A6(a)) of the port in 2-D, on the
CPU: the port's StencilEngine (device="cpu") against the JAX engine (Pallas
interpret mode) and both against ``utils/reference.run_periodic`` /
``run_reflect``, twinning tests/test_boundary.py's 2-D cases at its (24,
200) interior; the fp64-grade tier, the df64 'xla' step's per-step refresh
of the padded array, the refusals, no whole-grid run under a ghost mode,
and a pass split across launches refilling the ring between them.
Helpers and tolerances: tests/torch_boundary_common.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d, guard_2d
from torch_boundary_common import TOL, both, check, padded_input, rel_err, truth

INTERIOR = (24, 200)
SHAPES = ["star2d1r", "box2d1r", "star2d3r", "box2d3r"]


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", SHAPES)
def test_periodic_2d_shapes(name, steps):
    peng, jeng = both(name, INTERIOR, "periodic")
    assert peng._fused_k() == jeng._fused_k()
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 41), steps, "periodic")


def test_periodic_fused_2d():
    peng, jeng = both("star2d1r", INTERIOR, "periodic", fused_steps=2)
    assert peng._fused_k() == jeng._fused_k() == 2
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 41), 5, "periodic")


@pytest.mark.parametrize("kw,match", [
    ({"boundary": "periodic", "backend": "xla"}, "periodic"),
    ({"boundary": "reflect", "backend": "xla", "dtype": "float64"}, "reflect"),
    ({"boundary": "periodic", "fusion": "skew"}, "dirichlet0"),
    ({"boundary": "wrap"}, "boundary must be"),
])
def test_ghost_refusals_2d(kw, match, x64):
    """The JAX engine's messages, from both engines: a ghost boundary needs
    the kernels (df64 excepted), and skewed fusion keeps dirichlet0."""
    with pytest.raises(ValueError, match=match):
        engine.StencilEngine.for_shape("star2d1r", INTERIOR, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jax_engine.StencilEngine.for_shape("star2d1r", INTERIOR, **kw)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["star2d1r", "box2d3r"])
def test_reflect_2d(name, steps):
    peng, jeng = both(name, INTERIOR, "reflect")
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 43), steps, "reflect")


def test_reflect_fused_symmetric_2d():
    """A symmetric registry shape: fused reflect (one refresh a pass) is
    exact."""
    peng, jeng = both("star2d1r", INTERIOR, "reflect", fused_steps=2)
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 44), 5, "reflect")


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name", ["star2d1r", "box2d3r"])
@pytest.mark.parametrize("dtype", ["df64", "float64"])
def test_fp64_2d(dtype, name, boundary, x64):
    peng, jeng = both(name, INTERIOR, boundary, dtype)
    assert peng._fused_k() == jeng._fused_k() == 1
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 45), 3, boundary, dtype)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_df64_xla_step_refreshes_the_padded_ring(boundary):
    """df64 backend 'xla' steps the padded array: its ring (the spec's halo
    deep, the radius wide) is refilled before every step, as the JAX XLA
    pair path does (_ring_refresh_padded)."""
    peng, jeng = both("star2d1r", INTERIOR, boundary, "df64", backend="xla")
    assert peng.backend == "xla" and not jeng.df64_pallas
    padded = padded_input(peng.spec, INTERIOR, 46)
    check(peng, jeng, padded, 3, boundary, "df64")
    before = padded.copy()
    peng.run(torch.from_numpy(padded), 2)
    assert np.array_equal(padded, before)  # the caller's array is not written


def test_run_checksum_2d():
    for dtype in ("float32", "df64"):
        peng, jeng = both("box2d1r", INTERIOR, "reflect", dtype)
        padded = padded_input(peng.spec, INTERIOR, 47)
        want = truth("reflect", padded, peng.spec, 4)
        s = float(peng.run_checksum(padded, 4))
        assert abs(s - want.sum()) <= TOL[dtype] * np.abs(want).sum()
        j = (jeng.run_checksum(jnp.asarray(padded, jnp.float32), 4) if dtype == "float32"
             else jeng.run_checksum(padded, 4))
        assert abs(s - float(j)) <= 1e-6 * np.abs(want).sum()


def test_no_whole_grid_run_under_a_ghost_boundary(monkeypatch):
    """With the caps on, a dirichlet0 grid runs all its steps in one launch;
    the same grid under a ghost boundary runs passes (the JAX engine's
    rule: its ring is refilled between passes)."""
    monkeypatch.setattr(stencil2d, "RESIDENT_2D_BYTES", 2**30)
    monkeypatch.setattr(stencil2d, "RESIDENT_PAIR_2D_BYTES", 2**30)
    for dtype in ("float32", "df64"):
        assert engine.StencilEngine.for_shape("star2d1r", INTERIOR, device="cpu",
                                              dtype=dtype)._resident_2d()
        ghost = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device="cpu",
                                               dtype=dtype, boundary="periodic")
        assert not ghost._resident_2d()
        padded = padded_input(ghost.spec, INTERIOR, 48)
        assert rel_err(ghost.run(padded, 3).numpy(),
                       truth("periodic", padded, ghost.spec, 3)) <= TOL[dtype]


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_split_pass_refills_the_ring_between_launches(boundary, monkeypatch):
    """A pass deeper than one launch of the tile kernel takes
    (max_fused_steps) runs as several launches, each masking its last level
    to the interior: the ring of the buffer between them is refilled by the
    engine's refresh, which is exact (a refresh at any step is np.pad at that
    step).  Each launch of the strip walk's depth (``walk_depth``) runs as
    single strip launches (``strips_beat_plan``), the refresh between them
    too.  Each launch replaced by the twin, the pass matches the ground
    truth."""
    spec = get_shape("star2d1r")
    k = stencil2d.max_fused_steps("step", spec.radius, stencil2d.plan_len(spec)) + 2
    interior = (k * spec.radius + 5, 2 * k * spec.radius)
    eng = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu",
                                         boundary=boundary, fused_steps=k)
    launches = []

    def fake_launch(kind, buffers, spec_, layout, depth, bounds=None, **_):
        launches.append((kind, depth, bounds))
        stencil2d.stencil2d_step_plain(*buffers, spec_, layout, depth, bounds)

    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    padded = padded_input(spec, interior, 49)
    x = eng._ring_refresh(eng.to_internal(padded), boundary)
    out = stencil2d._split_pass("step", x, torch.zeros_like(x), spec, eng.layout, k,
                                eng._ghost_bounds(),
                                lambda s: eng._ring_refresh(s, boundary))
    assert [(kind, d) for kind, d, _ in launches] == [("strip", 1)] * k
    assert all(b == eng._ghost_bounds() for _, _, b in launches)
    got = eng.from_internal(eng._ring_refresh(out, "zero")).numpy()
    assert rel_err(got, truth(boundary, padded, spec, k)) <= 1e-6


def test_ring_refresh_composes_corners_as_np_pad():
    """The 2-D ring, axis by axis, equals np.pad's wrap / symmetric fill,
    corners included; 'zero' clears it."""
    spec = get_shape("box2d3r")
    lay = Layout2D(interior=(9, 13), halo=spec.halo, tile=default_tile_2d(9, 13),
                   guard=guard_2d(spec.halo, 4))
    eng = engine.StencilEngine.for_shape("box2d3r", (9, 13), device="cpu",
                                         boundary="periodic")
    g = np.arange(9 * 13, dtype=np.float64).reshape(9, 13)
    for mode, np_mode in (("periodic", "wrap"), ("reflect", "symmetric")):
        buf = torch.zeros(lay.shape, dtype=torch.float64)
        r0, c0 = lay.origin
        buf[r0: r0 + 9, c0: c0 + 13] = torch.from_numpy(g)
        engine._ring_refresh_nd(buf, mode, lay.origin, lay.interior, 4)
        assert np.array_equal(buf[r0 - 4: r0 + 13, c0 - 4: c0 + 17].numpy(),
                              np.pad(g, 4, mode=np_mode))
        engine._ring_refresh_nd(buf, "zero", lay.origin, lay.interior, 4)
        assert np.array_equal(buf[r0 - 4: r0 + 13, c0 - 4: c0 + 17].numpy(),
                              np.pad(g, 4))
    assert eng._ghost_bounds() == (-eng._ring_depth(), 9 + eng._ring_depth(),
                                   -eng._ring_depth(), 13 + eng._ring_depth())
