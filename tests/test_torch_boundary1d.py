"""Periodic and reflect boundaries (ROADMAP A6(a)) of the port in 1-D, on the
CPU: lorastencil_tpu_torch's StencilEngine (device="cpu", the kernels' plain
twins) against the JAX engine (Pallas interpret mode) on the same seeded
input, and both against the port's fp64 ground truth
(``utils/reference.run_periodic`` / ``run_reflect``).  The cases twin
tests/test_boundary.py's 1-D ones, with its (300,) interior and its
uniform [0, 0.01) fill, and add the fp64-grade tier, the dispatch at the
card's sizes and run_checksum.  2-D and 3-D are in
tests/test_torch_boundary2d.py and tests/test_torch_boundary3d.py; the
helpers and tolerances in tests/torch_boundary_common.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.ops.layout import Layout1DLanes
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil1d
from torch_boundary_common import both, check, jax_run, padded_input, rel_err, truth

INTERIOR = (300,)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["1d1r", "1d2r"])
def test_periodic_1d_shapes(name, steps):
    """A small grid takes the flat passes under a ghost boundary, as the
    JAX engine's flat layout, at the same fused depth (1d1r k = 4, 1d2r 3)."""
    peng, jeng = both(name, INTERIOR, "periodic")
    assert peng.path == "flat" and not isinstance(jeng.layout, Layout1DLanes)
    assert peng._fused_k() == jeng._fused_k() == {"1d1r": 4, "1d2r": 3}[name]
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 41), steps, "periodic")


def test_periodic_1d_lanes_layout():
    """A grid over RESIDENT_BYTES rides the lanes passes (the JAX engine's
    overlapped-lane layout) at k = 3."""
    peng, jeng = both("1d2r", (200_000,), "periodic")
    assert peng.path == "lanes" and isinstance(jeng.layout, Layout1DLanes)
    assert peng._fused_k() == jeng._fused_k() == 3
    check(peng, jeng, padded_input(peng.spec, (200_000,), 41), 3, "periodic")


def test_ghost_rejects_tiny_interior_1d():
    for eng in (engine.StencilEngine, jax_engine.StencilEngine):
        kw = {"device": "cpu"} if eng is engine.StencilEngine else {}
        with pytest.raises(ValueError, match="ring depth"):
            eng.for_shape("1d2r", (2,), boundary="periodic", **kw)


@pytest.mark.parametrize("steps", [1, 3])
def test_reflect_1d1r(steps):
    peng, jeng = both("1d1r", INTERIOR, "reflect")
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 43), steps, "reflect")


def test_reflect_fused_nonsymmetric_rejected_k1_runs():
    """Non-symmetric taps: fused reflect is refused by both engines with the
    same message; one step per pass runs (a refresh per step is np.pad per
    step)."""
    taps = np.array([0.25, 0.5, 0.125])
    for eng in (engine.StencilEngine, jax_engine.StencilEngine):
        kw = {"device": "cpu"} if eng is engine.StencilEngine else {}
        with pytest.raises(ValueError, match="symmetric"):
            eng.for_coeffs(taps, (3000,), halo=(1,), boundary="reflect", fused_steps=2, **kw)
    peng = engine.StencilEngine.for_coeffs(taps, (3000,), halo=(1,), device="cpu",
                                           boundary="reflect", fused_steps=1)
    jeng = jax_engine.StencilEngine.for_coeffs(taps, (3000,), halo=(1,), boundary="reflect",
                                               fused_steps=1)
    padded = np.zeros(3002)
    padded[1:-1] = np.random.default_rng(44).uniform(0, 0.01, 3000)
    check(peng, jeng, padded, 3, "reflect")


def test_periodic_mass_conservation():
    """A normalized stencil on a periodic domain conserves the total."""
    taps = np.array([1.0, 2.0, 4.0, 2.0, 1.0]) / 10.0
    peng = engine.StencilEngine.for_coeffs(taps, (1280,), halo=(2,), device="cpu",
                                           boundary="periodic")
    jeng = jax_engine.StencilEngine.for_coeffs(taps, (1280,), halo=(2,), boundary="periodic")
    padded = np.zeros(1284)
    padded[2:-2] = np.random.default_rng(9).uniform(0, 1, 1280)
    out = peng.run(padded, 10).numpy().astype(np.float64)
    assert abs(out[2:-2].sum() - padded[2:-2].sum()) < 1e-2
    assert rel_err(out, jax_run(jeng, padded, 10, "float32")) <= 1e-6


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name", ["1d1r", "1d2r"])
@pytest.mark.parametrize("dtype", ["df64", "float64"])
def test_fp64_1d(dtype, name, boundary, x64):
    """df64 runs narrow passes of one step (no run under a ghost boundary),
    float64 the flat passes of the float32 rules (k = 2 under 'vpu_roll')."""
    peng, jeng = both(name, INTERIOR, boundary, dtype)
    assert peng._fused_k() == jeng._fused_k() == (1 if dtype == "df64" else 2)
    assert peng.path == ("lanes" if dtype == "df64" else "flat")
    check(peng, jeng, padded_input(peng.spec, INTERIOR, 45), 3, boundary, dtype)


@pytest.mark.parametrize("dtype,n,path,k", [
    ("float32", 4096, "flat", 4),          # 1d1r: wide_kernel passes, not the run
    ("float32", 16_777_216, "lanes", 4),
    ("df64", 16_777_216, "lanes", 1),
    ("float64", 4096, "flat", 2),
])
def test_ghost_dispatch_at_the_card_sizes(dtype, n, path, k):
    """chip_smoke.py's ring runs take the JAX engine's branch and depth, and
    the guard covers the ring: 1d1r's is k * radius = 16 deep where a
    pass reaches k * r_eff = 12."""
    spec = get_shape("1d1r")
    peng = engine.StencilEngine.for_shape("1d1r", (n,), device="cpu", boundary="reflect",
                                          dtype=dtype)
    jeng = jax_engine.StencilEngine.for_shape("1d1r", (n,), boundary="reflect",
                                              dtype="float32" if dtype == "float64" else dtype)
    assert peng.path == path and peng._fused_k() == k
    assert isinstance(jeng.layout, Layout1DLanes) == (path == "lanes")
    if dtype != "float64":  # (the JAX float64 engine needs x64 to build)
        assert jeng._fused_k() == k
    assert peng._ring_depth() == k * spec.radius
    assert peng.layout.guard >= peng._ring_depth() > k * stencil1d.effective_radius(spec)
    dirichlet = engine.StencilEngine.for_shape("1d1r", (n,), device="cpu", dtype=dtype)
    if n == 4096:  # the same grid in dirichlet0 runs all its steps in one launch
        assert dirichlet.path == "resident_lanes"


def test_run_checksum_and_input_kept_1d():
    """run_checksum agrees with the JAX engine's; run_internal does not write
    the state it is given, though every pass refills the ring of its input;
    the CPU counts no launch."""
    peng, jeng = both("1d2r", (5000,), "periodic")
    padded = padded_input(peng.spec, (5000,), 47)
    want = truth("periodic", padded, peng.spec, 7)
    s = float(peng.run_checksum(padded, 7))
    assert abs(s - want.sum()) <= 1e-6 * np.abs(want).sum()
    assert abs(s - float(jeng.run_checksum(jnp.asarray(padded, jnp.float32), 7))) <= (
        1e-6 * np.abs(want).sum())
    state = peng.to_internal(padded)
    kept = state.clone()
    before = stencil1d.stencil1d_step.launches
    peng.run_internal(state, 7)
    assert (state == kept).all()
    assert stencil1d.stencil1d_step.launches == before
