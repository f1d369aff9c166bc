"""The whole-grid 2-D runs in the port on the CPU: every step in one
``stencil2d_resident`` launch, in float32 (``pallas_2d.stencil2d_resident``) and
for df64 / float64 (``pallas_df64.stencil2d_resident_pair``), behind the JAX
package's caps ``LORASTENCIL_RESIDENT2D_KB`` and ``LORASTENCIL_RESIDENT2D_PAIR_KB``
(both off by default).  lorastencil_tpu_torch's StencilEngine (device="cpu",
which runs the resident kernel's plain twin) against the JAX engine on its
resident path (Pallas interpret mode) and the fp64 ground truth, with each
package's cap constant raised by monkeypatch.

The fit test is each package's own, on its own layout, so near a cap the two may
choose differently (ROADMAP section C); the dispatch tests sit well inside and
well outside the cap.

Tolerances, relative to the largest value of the ground truth: the 0..99 fill
bit for bit at 1 and 2 steps (integers below 2**24); the pi/100 fill 1e-5 after
5 steps in float32 (the JAX resident kernel adds equal tap pairs before one
multiply, ops/band_gemm.py); df64 within 1e-13 of JAX df64 and of the ground
truth, float64 1e-14."""

import os

import jax
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.ops import pallas_2d, pallas_df64
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.utils import reference

PI = np.pi / 100
CAP = 8 * 2**20


@pytest.fixture(autouse=True)
def empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LORASTENCIL_CACHE", str(tmp_path))


@pytest.fixture()
def caps_on(monkeypatch):
    for module, name in ((pallas_2d, "RESIDENT_2D_BYTES"), (stencil2d, "RESIDENT_2D_BYTES"),
                         (pallas_df64, "RESIDENT_PAIR_2D_BYTES"),
                         (stencil2d, "RESIDENT_PAIR_2D_BYTES")):
        monkeypatch.setattr(module, name, CAP)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def jax_resident(jeng):
    """Whether the JAX engine's run takes its whole-grid kernel."""
    if jeng.df64:
        return jeng.df64_pallas and pallas_df64.fits_resident_pair_2d(jeng.layout)
    return (jeng._fusion_mode() != "skew"
            and jeng.algorithm in ("mxu_hybrid1", "vpu_roll", "vpu")
            and pallas_2d.fits_resident_2d(jeng.layout, jeng.dtype.itemsize))


def test_caps_default_off_in_both_packages():
    for env, port, jax_ in (("LORASTENCIL_RESIDENT2D_KB", stencil2d.RESIDENT_2D_BYTES,
                             pallas_2d.RESIDENT_2D_BYTES),
                            ("LORASTENCIL_RESIDENT2D_PAIR_KB",
                             stencil2d.RESIDENT_PAIR_2D_BYTES,
                             pallas_df64.RESIDENT_PAIR_2D_BYTES)):
        assert port == jax_ == int(os.environ.get(env, "0")) * 1024
    if "LORASTENCIL_RESIDENT2D_KB" not in os.environ:
        for dtype in ("float32", "float64", "df64"):
            eng = engine.StencilEngine.for_shape("star2d1r", (64, 128), device="cpu",
                                                 dtype=dtype)
            assert not eng._resident_2d()


@pytest.mark.parametrize("name,interior", [
    ("star2d1r", (512, 512)), ("box2d3r", (256, 384)), ("star2d3r", (200, 300)),
])
def test_2d_resident_small_grid(name, interior, caps_on):
    """Twin of tests/test_engine.py::test_2d_resident_small_grid."""
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu")
    jeng = jax_engine.StencilEngine.for_shape(name, interior)
    assert peng._resident_2d() and jax_resident(jeng)
    g0 = reference.random_padded(spec, interior, seed=31)
    for steps in (1, 2):
        got = peng.run(g0, steps).numpy()
        assert np.array_equal(got, reference.run(g0, spec, steps))
        assert np.array_equal(got, np.asarray(jeng.run(g0, steps)))
    g1 = g0 * PI
    got = peng.run(g1, 5).numpy()
    want = reference.run(g1, spec, 5)
    assert rel_err(got, want) <= 1e-5
    assert rel_err(got, np.asarray(jeng.run(g1, 5))) <= 1e-5
    h = spec.halo
    assert np.all(got[: h[0]] == 0.0) and np.all(got[:, : h[1]] == 0.0)
    tiled = engine.StencilEngine.for_shape(name, interior, device="cpu", fused_steps=1)
    assert np.array_equal(got, tiled.run(g1, 5).numpy())


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r"])
def test_df64_2d_resident_pair(name, caps_on):
    """Twin of tests/test_df64.py::test_df64_2d_resident_pair: the pair cap."""
    spec = get_shape(name)
    interior = (256, 384)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="df64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="df64")
    assert peng._resident_2d() and jax_resident(jeng)
    g1 = reference.random_padded(spec, interior, seed=61) * PI
    for steps in (1, 4):
        got = peng.run(g1, steps)
        assert got.dtype == torch.float64
        got = got.numpy()
        want = reference.run(g1, spec, steps)
        assert rel_err(got, want) <= 1e-13
        assert rel_err(got, jeng.run(g1, steps)) <= 1e-13
    h = spec.halo
    assert np.all(got[: h[0]] == 0.0) and np.all(got[:, : h[1]] == 0.0)


def test_float64_resident_matches_jax_float64(caps_on, x64):
    """dtype float64 takes the float32 cap at 8 bytes per cell, in both
    packages."""
    name, interior = "box2d1r", (200, 300)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="float64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="float64")
    assert peng._resident_2d() and jax_resident(jeng)
    g1 = reference.random_padded(spec, interior, seed=62) * PI
    got = peng.run(g1, 4).numpy()
    assert rel_err(got, reference.run(g1, spec, 4)) <= 1e-14
    assert rel_err(got, np.asarray(jeng.run(g1, 4))) <= 1e-14


@pytest.mark.parametrize("dtype", ["float32", "float64", "df64"])
@pytest.mark.parametrize("kw", [{}, {"fusion": "skew"}, {"backend": "xla"},
                                {"fused_steps": 3}])
@pytest.mark.parametrize("interior", [(64, 256), (4096, 4096)])
def test_dispatch_agrees_well_inside_and_outside_the_cap(interior, kw, dtype, monkeypatch,
                                                         x64):
    """With both packages' caps at 1 MiB: a 64 x 256 grid (~100 KB in either
    layout) runs resident, a 4096^2 grid (64 MiB and more) does not; the skewed
    path and the 'xla' backend never do.  df64 has no skewed path and runs its
    pair cap, but the JAX engine builds its skew layout for it all the same,
    whose extra storage band (when the interior leaves no slack for the lag)
    turns its run off; the port's layout has no such band (ROADMAP section C)."""
    for module, name in ((pallas_2d, "RESIDENT_2D_BYTES"), (stencil2d, "RESIDENT_2D_BYTES"),
                         (pallas_df64, "RESIDENT_PAIR_2D_BYTES"),
                         (stencil2d, "RESIDENT_PAIR_2D_BYTES")):
        monkeypatch.setattr(module, name, 2**20)
    peng = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu", dtype=dtype,
                                          **kw)
    jeng = jax_engine.StencilEngine.for_shape("star2d1r", interior, dtype=dtype, **kw)
    want = (interior == (64, 256) and kw.get("backend") != "xla"
            and (dtype == "df64" or kw.get("fusion") != "skew"))
    assert peng._resident_2d() == want
    jax_want = want and not jeng.layout.extra_row_tiles
    assert (jax_resident(jeng) and jeng.backend != "xla") == jax_want


def test_resident_wrapper_equals_single_steps():
    for name in ("star2d1r", "star2d3r", "box2d3r"):
        spec = get_shape(name)
        for dtype in (torch.float32, torch.float64):
            eng = engine.StencilEngine.for_shape(name, (37, 150), device="cpu", fused_steps=1)
            x = eng.layout.to_internal(
                reference.random_padded(spec, (37, 150), seed=7) * PI, dtype)
            keep = x.clone()
            before = (stencil2d.stencil2d_resident.launches,
                      stencil2d.stencil2d_resident.launches_f64)
            got = stencil2d.stencil2d_resident(x, spec, eng.layout, 3)
            want = x
            for _ in range(3):
                want = stencil2d.stencil2d_step(want, torch.zeros_like(x), spec, eng.layout)
            assert torch.equal(got, want) and torch.equal(x, keep)
            assert (stencil2d.stencil2d_resident.launches,
                    stencil2d.stencil2d_resident.launches_f64) == before
    with pytest.raises(ValueError, match="steps"):
        stencil2d.stencil2d_resident(x, spec, eng.layout, 0)
