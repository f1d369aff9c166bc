"""A fault of the port, repaired (ROADMAP C4), on the CPU against the JAX engine
(Pallas interpret mode) and the fp64 ground truth: a 3-D radius-0 spec, which
crashed at build (float32, float64: a division by the radius) or at the first
run (df64: the wrapper refused radius 0), builds with k = 2 (df64: 1) and runs
in every dtype and boundary with error 0 (0.75 is dyadic: every product is
exact).  C3, a 2-D radius above 16: tests/test_torch_repairs.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import convert, engine
from lorastencil_tpu_torch.ops import stencil3d
from lorastencil_tpu_torch.utils import reference


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "df64"])
def test_c4_radius0_3d(dtype, boundary, request):
    """The JAX engine's k, and its run and the ground truth's bit for bit."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    interior = (9, 10, 13)
    S = np.array([[[0.75]]])
    peng = engine.StencilEngine.for_coeffs(S, interior, device="cpu", dtype=dtype,
                                           boundary=boundary)
    jeng = jax_engine.StencilEngine.for_coeffs(S, interior, dtype=dtype, boundary=boundary)
    assert peng.spec.radius == 0 and peng.spec == convert.spec_from_jax(jeng.spec)
    assert peng._fused_k() == jeng._fused_k() == (1 if dtype == "df64" else 2)
    truth = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    g0 = reference.random_padded(peng.spec, interior, seed=3)
    jin = jnp.asarray(g0, jnp.float32) if dtype == "float32" else g0
    for steps in (1, 3):
        got = peng.run(g0, steps).double().numpy()
        assert np.array_equal(got, truth(g0, peng.spec, steps))
        assert np.array_equal(got, np.asarray(jeng.run(jin, steps), np.float64))


def test_c4_wrapper_takes_radius0():
    """The 3-D wrapper's range starts at 0: the general kernel's radius-0
    instances (the march kernel stays radius 1)."""
    eng = engine.StencilEngine.for_coeffs(np.array([[[2.0]]]), (4, 5, 6), device="cpu")
    x = eng.to_internal(np.ones((4, 5, 6)))
    out = stencil3d.stencil3d_step(x, x.clone().zero_(), eng.spec, eng.layout, fused_steps=2)
    assert float(eng.from_internal(out).sum()) == 4.0 * 4 * 5 * 6
    assert not stencil3d.march_takes(eng.spec, x.dtype, 2)
