"""A fault of the port, repaired (ROADMAP section C), on the CPU against the
JAX engine (Pallas interpret mode) and the fp64 ground truth (C4, a 3-D
radius-0 spec: tests/test_torch_repairs_3d.py).

C3: a 2-D radius above 16.  ``for_coeffs`` of a 35 x 35 and a 129 x 129 cross
(radius 17 and 64) runs at k = 1 and 2, as the JAX engine does (its 128-column
guard clamps k to 128 // r): rel <= 1e-5 of the largest value in float32,
1e-13 in float64 and df64.  The JAX df64 pair kernel takes over five minutes
a run at radius 64 in interpret mode, so there the df64 engine is held to the
ground truth and, bit for bit, to the port's float64 engine (both native
fp64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import convert, engine
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.utils import reference

F32, F64 = torch.float32, torch.float64
INTERIOR = (40, 300)
TOL = {"float32": 1e-5, "float64": 1e-13, "df64": 1e-13}


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def cross(radius):
    S = np.zeros((2 * radius + 1,) * 2)
    S[radius, :] = S[:, radius] = 1.0
    return S


def rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _c3(radius, dtype, k, with_jax=True):
    peng = engine.StencilEngine.for_coeffs(cross(radius), INTERIOR, device="cpu",
                                           dtype=dtype, fused_steps=k)
    assert peng.spec.radius == radius > stencil2d.STRIP_RADII[-1]
    g0 = reference.random_padded(peng.spec, INTERIOR, seed=1) * (np.pi / 100)
    want = reference.run(g0, peng.spec, 3)
    got = peng.run(g0, 3)
    assert got.dtype == engine.DTYPES[dtype]
    got = got.double().numpy()
    assert rel(got, want) <= TOL[dtype]
    if with_jax:
        jeng = jax_engine.StencilEngine.for_coeffs(cross(radius), INTERIOR, dtype=dtype,
                                                   fused_steps=k)
        assert peng.spec == convert.spec_from_jax(jeng.spec)
        assert peng._fused_k() == jeng._fused_k()
        jin = jnp.asarray(g0, jnp.float32) if dtype == "float32" else g0
        assert rel(got, jeng.run(jin, 3)) <= TOL[dtype]
    return peng, got


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("radius", [17, 64])
def test_c3_wide_cross_float32(radius, k):
    peng, _ = _c3(radius, "float32", k)
    assert peng._fused_k() == k


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("radius", [17, 64])
def test_c3_wide_cross_float64(radius, k, x64):
    _c3(radius, "float64", k, with_jax=radius == 17 or k == 1)


@pytest.mark.parametrize("radius", [17, 64])
def test_c3_wide_cross_df64(radius):
    peng, got = _c3(radius, "df64", 1, with_jax=radius == 17)
    assert peng._fused_k() == 1
    if radius == 64:
        g0 = reference.random_padded(peng.spec, INTERIOR, seed=1) * (np.pi / 100)
        f64 = engine.StencilEngine.for_coeffs(cross(radius), INTERIOR, device="cpu",
                                              dtype="float64", fused_steps=1)
        assert np.array_equal(got, f64.run(g0, 3).numpy())


def test_c3_kernel_rules_at_wide_radii():
    """The wrappers take radius up to 128 (the JAX guard's reach at k = 1) and
    refuse 129; a step past the tile kernel's shared memory is the wide
    kernel's (``wide_takes``), a deeper pass splits into launches that fit,
    and no whole-grid run takes a radius whose window the resident kernel
    cannot hold."""
    for radius, dtype, wide in ((17, F32, False), (60, F32, False), (64, F32, True),
                                (35, F64, False), (36, F64, True), (128, F64, True)):
        spec = engine.StencilEngine.for_coeffs(cross(radius), (8, 8), device="cpu").spec
        assert stencil2d.wide_takes(spec, dtype) == wide, (radius, dtype)
        kmax = stencil2d.max_fused_steps("step", radius, stencil2d.plan_len(spec), dtype)
        assert kmax >= 1 and (kmax == 1 or not wide)
        lay = engine.StencilEngine.for_coeffs(cross(radius), (8, 8), device="cpu").layout
        assert not stencil2d.fits_resident_2d(lay, dtype.itemsize, "cuda", spec) or not wide
    spec = engine.StencilEngine.for_coeffs(cross(128), (8, 8), device="cpu").spec
    assert stencil2d.MAX_RADIUS == 128 and spec.radius == 128
    wide = spec.__class__(name="w", ndim=2, radius=129, halo=(4, 4), terms=(), residue=(),
                          fuse_factor=1)
    eng = engine.StencilEngine.for_coeffs(cross(128), (8, 8), device="cpu")
    x = eng.to_internal(np.zeros(spec.padded_shape((8, 8))))
    with pytest.raises(ValueError, match="cap 128"):
        stencil2d.stencil2d_step(x, x.clone(), wide, eng.layout)
