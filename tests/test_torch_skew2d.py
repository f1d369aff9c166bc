"""Time-skewed 2-D fusion (fusion='skew') in the port on the CPU: twins of
tests/test_skew.py, lorastencil_tpu_torch's StencilEngine (device="cpu", which
runs the skew kernel's plain twin) against the JAX engine's skewed path (Pallas
interpret mode) and the fp64 ground truth; the validation errors, with the JAX
engine's exception types; skew against extent fusion at the same depth.

The skew kernel changes only the traversal, never the numerics: the port's skewed
run equals its extent-fused run at the same k bit for bit, and both hold the
reference's per-step halo-decay semantics.  The JAX tests' band tile (16, 128)
is passed to both engines; the port's tile only sets its round-up (its skew
kernel takes bands of 32 rows in float32 and needs no extra row tiles).

Tolerances, relative to max(1, the largest value of the ground truth), as in
tests/test_skew.py: 1e-6 on the 0..99 fill over up to 2k + 1 steps (the
integers pass 2**24 after two steps; from there each step rounds to fp32), 5e-6
against JAX's split-bf16 'mxu_hybrid1' path; the 0/1 fill bit for bit over 3
steps; float64 1e-14 against JAX float64 and the ground truth."""

import jax
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.utils import reference

SHAPES_2D = ["star2d1r", "star2d3r", "box2d3r", "box2d1r"]


@pytest.fixture(autouse=True)
def empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LORASTENCIL_CACHE", str(tmp_path))


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(want).max())


def _run_skew(name, interior, steps, tile, k, tol=1e-6, seed=11, **kw):
    """The port's skewed run against the ground truth and the JAX engine's
    skewed run (tol each), and bit for bit against its own extent run."""
    spec = get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=seed)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", fusion="skew",
                                          fused_steps=k, tile=tile, **kw)
    jeng = jax_engine.StencilEngine.for_shape(name, interior, fusion="skew",
                                              fused_steps=k, tile=tile, **kw)
    assert peng._fusion_mode() == jeng._fusion_mode() == "skew"
    assert peng._fused_k() == jeng._fused_k() == k
    assert peng.layout.extra_row_tiles == 0
    got = peng.run(g0, steps).numpy()
    want = reference.run(g0, spec, steps)
    assert _rel(got, want) < tol
    assert _rel(got, np.asarray(jeng.run(g0, steps))) < tol
    extent = engine.StencilEngine.for_shape(name, interior, device="cpu", fused_steps=k,
                                            tile=tile, **kw)
    assert np.array_equal(got, extent.run(g0, steps).numpy())
    return got


@pytest.mark.parametrize("name", SHAPES_2D)
@pytest.mark.parametrize("k", [2, 3])
def test_skew_matches_reference(name, k):
    # interior divisible by neither the band height nor the tile width
    _run_skew(name, (70, 300), steps=2 * k + 1, tile=(16, 128), k=k)


@pytest.mark.parametrize("name", ["star2d1r", "star2d3r"])
def test_skew_vpu_roll(name):
    _run_skew(name, (70, 300), steps=4, tile=(16, 128), k=2, algorithm="vpu_roll")


@pytest.mark.parametrize("steps", [0, 1, 2, 4, 5])
def test_skew_step_counts(steps):
    # remainder passes (steps % k) of one step run the extent kernel on the same
    # layout; steps < k runs a single short skewed pass
    _run_skew("star2d1r", (40, 200), steps=steps, tile=(16, 128), k=2)


@pytest.mark.parametrize("interior,tile,extra", [((64, 256), (16, 128), 1),
                                                 ((70, 256), (48, 128), 0)])
def test_skew_needs_no_extra_row_tiles(interior, tile, extra):
    """Twin of test_skew_band_divisible_interior / test_skew_slack_absorbs_lag:
    the JAX layout adds a storage band when the interior leaves no slack for
    the k*s lag; the port's kernel drains the lagging levels itself."""
    jeng = jax_engine.StencilEngine.for_shape("star2d1r", interior, fusion="skew",
                                              fused_steps=2, tile=tile)
    assert jeng.layout.extra_row_tiles == extra
    _run_skew("star2d1r", interior, steps=4, tile=tile, k=2)


@pytest.mark.parametrize("residue_mxu", ["off", "on"])
def test_skew_mxu_hybrid1(residue_mxu):
    _run_skew("star2d1r", (70, 300), steps=4, tile=(16, 128), k=2, tol=5e-6,
              algorithm="mxu_hybrid1", residue_mxu=residue_mxu)


def test_skew_halo_contributes_then_decays():
    # the first pass must see the user halo; afterwards it decays to zero
    spec = get_shape("star2d1r")
    g0 = reference.random_padded(spec, (40, 200), seed=3)
    hm, hn = spec.halo
    assert np.abs(g0[:hm]).max() > 0
    got = _run_skew("star2d1r", (40, 200), steps=2, tile=(16, 128), k=2, seed=3)
    assert np.all(got[:hm] == 0) and np.all(got[:, :hn] == 0)
    assert np.all(got[-hm:] == 0) and np.all(got[:, -hn:] == 0)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", SHAPES_2D)
def test_skew_bit_equal_to_extent_on_integer_fills(name, k):
    interior = (37, 300)
    spec = get_shape(name)
    g = reference.random_padded(spec, interior, seed=12) % 2
    skew = engine.StencilEngine.for_shape(name, interior, device="cpu", fusion="skew",
                                          fused_steps=k)
    extent = engine.StencilEngine.for_shape(name, interior, device="cpu", fused_steps=k)
    for steps in (k, 3):
        got = skew.run(g, steps).numpy()
        assert np.array_equal(got, extent.run(g, steps).numpy())
        assert np.array_equal(got, reference.run(g, spec, steps))


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r"])
def test_skew_float64_matches_jax_float64(name, x64):
    """The JAX engine accepts fusion='skew' in float64 off the TPU; the port
    runs the skew kernel's float64 instance."""
    interior = (70, 300)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="float64",
                                          fusion="skew")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="float64", fusion="skew")
    assert peng._fused_k() == jeng._fused_k() == 2 and peng.algorithm == "vpu_roll"
    g1 = reference.random_padded(spec, interior, seed=13) * (np.pi / 100)
    got = peng.run(g1, 5)
    assert got.dtype == torch.float64
    want = reference.run(g1, spec, 5)
    assert _rel(got.numpy(), want) <= 1e-14
    assert _rel(got.numpy(), np.asarray(jeng.run(g1, 5))) <= 1e-14


def test_skew_df64_runs_single_steps():
    """df64 accepts fusion='skew' as the JAX engine does and runs its one-step
    passes."""
    eng = engine.StencilEngine.for_shape("star2d1r", (40, 200), device="cpu", dtype="df64",
                                         fusion="skew")
    jeng = jax_engine.StencilEngine.for_shape("star2d1r", (40, 200), dtype="df64",
                                              fusion="skew")
    assert eng._fused_k() == jeng._fused_k() == 1
    g1 = reference.random_padded(eng.spec, (40, 200), seed=14) * (np.pi / 100)
    assert _rel(eng.run(g1, 3).numpy(), reference.run(g1, eng.spec, 3)) <= 1e-14


@pytest.mark.parametrize("kw,err,match", [
    ({"fusion": "skew", "boundary": "periodic"}, ValueError, "dirichlet0"),
    ({"fusion": "skew", "backend": "xla"}, ValueError, "Pallas"),
    ({"fusion": "skew", "algorithm": "vpu"}, ValueError, "vpu_roll"),
    ({"fusion": "diagonal"}, ValueError, "fusion"),
    ({"fusion": "skew", "fused_steps": 1}, ValueError, "fused_steps"),
    ({"fusion": "skew", "dtype": "float64", "algorithm": "vpu"}, ValueError, "vpu_roll"),
])
def test_skew_validation_errors(kw, err, match, x64):
    for make in (lambda: engine.StencilEngine.for_shape("star2d1r", (40, 200), device="cpu",
                                                        **kw),
                 lambda: jax_engine.StencilEngine.for_shape("star2d1r", (40, 200), **kw)):
        with pytest.raises(err, match=match):
            make()


@pytest.mark.parametrize("name,interior", [("1d1r", (300,)), ("star3d1r", (8, 16, 16))])
def test_skew_is_2d_only(name, interior):
    for make in (lambda: engine.StencilEngine.for_shape(name, interior, device="cpu",
                                                        fusion="skew"),
                 lambda: jax_engine.StencilEngine.for_shape(name, interior, fusion="skew")):
        with pytest.raises(ValueError, match="skew"):
            make()


def test_skew_wrapper_refuses_what_the_kernel_does_not_take():
    spec = get_shape("star2d1r")
    eng = engine.StencilEngine.for_shape("star2d1r", (40, 200), device="cpu", fusion="skew")
    cur = eng.to_internal(reference.random_padded(spec, (40, 200)))
    donor = torch.zeros_like(cur)
    with pytest.raises(ValueError, match="vpu_roll"):
        stencil2d.stencil2d_skew_step(cur, donor, spec, eng.layout, algorithm="vpu")
    with pytest.raises(ValueError, match="skew_steps"):
        stencil2d.stencil2d_skew_step(cur, donor, spec, eng.layout, skew_steps=1)
    with pytest.raises(ValueError, match="guard"):
        stencil2d.stencil2d_skew_step(cur, donor, spec, eng.layout, skew_steps=3)
    with pytest.raises(TypeError):
        stencil2d.stencil2d_skew_step(cur.half(), donor.half(), spec, eng.layout)
    before = (stencil2d.stencil2d_skew_step.launches,
              stencil2d.stencil2d_skew_step.launches_f64)
    out = stencil2d.stencil2d_skew_step(cur, donor, spec, eng.layout)
    assert out is donor and (stencil2d.stencil2d_skew_step.launches,
                             stencil2d.stencil2d_skew_step.launches_f64) == before
