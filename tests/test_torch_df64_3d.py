"""The port's fp64-grade tier in 3-D on the CPU: lorastencil_tpu_torch's
StencilEngine with dtype "df64" and "float64" for star3d1r and box3d1r
(device="cpu", which runs the float64 instance's plain twin) against the JAX
engine of the same dtype (df64: the pair slab kernel in Pallas interpret mode;
float64: pallas_3d under jax_enable_x64) and the fp64 ground truth; the df64
algorithm label and fused depth, backend 'xla', carrying JAX state across, the
wrapper's dtypes and the CLI.

Tolerances, relative to the largest value of the ground truth:
* against JAX df64, 1e-13 after 1, 2 and 4 steps: the pair arithmetic holds
  ~1e-14 per step against fp64 and the port's native fp64 is ~1e-16 per step;
* against JAX float64: the integer fill bit for bit (every partial sum is an
  integer far below 2**53), the pi/100 fill 1e-14 after 4 steps (the two sum
  in different orders);
* against the port's fp64 ground truth (utils/reference.py), 1e-14.
The JAX df64 interpret kernel refuses a one-tile plane grid, so the grids here
span at least two JAX tiles (the JAX engine splits its default tile)."""

import jax
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import cli, convert, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil3d
from lorastencil_tpu_torch.ops.layout import Layout3D
from lorastencil_tpu_torch.utils import reference

PI = np.pi / 100
SHAPES = ["star3d1r", "box3d1r"]


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("interior", [(4, 16, 256), (5, 20, 150)])
@pytest.mark.parametrize("name", SHAPES)
def test_df64_engine_matches_jax_df64_and_reference(name, interior):
    """(5, 20, 150): neither the port's (32, 64) tile nor the JAX tile divides
    the plane."""
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="df64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="df64")
    assert peng.df64 and peng.df64_pallas and jeng.df64_pallas
    assert peng.df64_algorithm == jeng.df64_algorithm == "vpu_sep"
    assert peng.algorithm == jeng.algorithm == "vpu"
    assert peng._fused_k() == jeng._fused_k() == 1
    g1 = reference.random_padded(spec, interior, seed=21) * PI
    for steps in (1, 2, 4):
        want = reference.run(g1, spec, steps)
        got = peng.run(g1, steps)
        assert got.dtype == torch.float64 and got.shape == g1.shape
        got = got.numpy()
        assert rel_err(got, want) <= 1e-14
        assert rel_err(got, jeng.run(g1, steps)) <= 1e-13
    s = float(peng.run_checksum(g1, 4))
    assert abs(s - want.sum()) <= 1e-14 * np.abs(want).sum()


@pytest.mark.parametrize("name", SHAPES)
def test_float64_engine_matches_jax_float64(name, x64):
    """k = 2 in both engines, so 3 steps take a pass and the remainder pass."""
    interior = (5, 20, 150)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="float64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="float64")
    assert peng.algorithm == jeng.algorithm == "vpu_roll"
    assert peng._fused_k() == jeng._fused_k() == 2 and not peng.df64
    g0 = reference.random_padded(spec, interior, seed=22)
    for steps in (1, 2, 3):
        got = peng.run(g0, steps)
        assert got.dtype == torch.float64
        got = got.numpy()
        assert np.array_equal(got, reference.run(g0, spec, steps))
        assert np.array_equal(got, np.asarray(jeng.run(g0, steps)))
    g1 = g0 * PI
    want = reference.run(g1, spec, 4)
    got = peng.run(g1, 4).numpy()
    assert rel_err(got, want) <= 1e-14
    assert rel_err(got, np.asarray(jeng.run(g1, 4))) <= 1e-14


@pytest.mark.parametrize("kw", [{}, {"fused_steps_3d": 1}, {"fused_steps_3d": 3},
                                {"fused_steps_3d": 12}, {"backend": "xla"}])
@pytest.mark.parametrize("dtype", ["df64", "float64"])
def test_fused_depth_and_labels_match_jax(dtype, kw, x64):
    interior = (6, 20, 150)
    for name in SHAPES:
        peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype=dtype, **kw)
        jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype=dtype, **kw)
        assert peng._fused_k() == jeng._fused_k()
        assert peng.algorithm == jeng.algorithm
        assert peng.df64_pallas == jeng.df64_pallas
        if dtype == "df64":
            assert peng.df64_algorithm == jeng.df64_algorithm
        assert peng.layout.guard[0] >= peng._fused_k() * peng.spec.radius


@pytest.mark.parametrize("algorithm", ["vpu_roll", "vpu", "mxu_hybrid1"])
def test_df64_3d_refuses_what_the_jax_engine_refuses(algorithm):
    msg = "df64 kernel algorithm must be 'auto' or one of \\('vpu_sep',\\) for 3-D"
    for make, kw in ((engine.StencilEngine.for_shape, {"device": "cpu"}),
                     (jax_engine.StencilEngine.for_shape, {})):
        with pytest.raises(ValueError, match=msg):
            make("box3d1r", (6, 20, 150), dtype="df64", algorithm=algorithm, **kw)
    # the 'xla' step takes no kernel name, and so refuses none
    eng = engine.StencilEngine.for_shape("box3d1r", (6, 20, 150), device="cpu", dtype="df64",
                                         algorithm=algorithm, backend="xla")
    assert not eng.df64_pallas and eng.df64_algorithm == algorithm


def test_xla_backend_and_algorithm_names_agree():
    """backend 'xla' steps the plain fp64 separable step; 'vpu_sep' named
    explicitly is the kernel's 'auto'."""
    interior = (5, 20, 70)
    for name in SHAPES:
        spec = get_shape(name)
        g0 = reference.random_padded(spec, interior, seed=3)
        for kw in ({"backend": "xla"}, {"algorithm": "vpu_sep"}, {"backend": "pallas"}):
            eng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="df64",
                                                 **kw)
            assert eng.df64_pallas == (kw.get("backend") != "xla")
            assert np.array_equal(eng.run(g0, 3).numpy(), reference.run(g0, spec, 3))
            g1 = g0 * PI
            want = reference.run(g1, spec, 4)
            assert rel_err(eng.run(g1, 4).numpy(), want) <= 1e-14


def _carry(jeng, peng, g, steps=1):
    """``steps`` JAX steps on its internal state, carried over with
    convert.state_from_jax and stepped ``steps`` more by the port."""
    s1 = np.asarray(jeng.run_internal(jeng.to_internal(g), steps))
    state = convert.state_from_jax(s1, jeng.layout, peng.layout)
    assert state.dtype == torch.float64 and state.shape == peng.layout.shape
    return s1, peng.from_internal(peng.run_internal(state, steps)).numpy()


@pytest.mark.parametrize("name", SHAPES)
def test_state_from_jax_takes_a_3d_df64_pair(name):
    """On the integer fill the pair's lo planes are zero and the run carries
    over exactly; on the pi/100 fill at the tier's tolerance."""
    interior = (4, 16, 256)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="df64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="df64")
    g0 = reference.random_padded(spec, interior, seed=5)
    pair, got = _carry(jeng, peng, g0)
    assert pair.shape == (2,) + tuple(jeng.layout.shape) and pair.dtype == np.float32
    assert np.array_equal(got, reference.run(g0, spec, 2))
    _, got = _carry(jeng, peng, g0 * PI)
    assert rel_err(got, reference.run(g0 * PI, spec, 2)) <= 1e-13


@pytest.mark.parametrize("name", SHAPES)
def test_state_from_jax_takes_a_3d_float64_state(name, x64):
    interior = (5, 20, 150)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="float64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="float64")
    g0 = reference.random_padded(spec, interior, seed=6)
    s1, got = _carry(jeng, peng, g0, steps=2)
    assert s1.dtype == np.float64 and s1.shape == tuple(jeng.layout.shape)
    assert np.array_equal(got, reference.run(g0, spec, 4))
    assert np.array_equal(got, np.asarray(jeng.run(g0, 4)))


def test_wrapper_takes_float64_and_refuses_the_rest():
    spec = get_shape("box3d1r")
    lay = Layout3D(interior=(4, 8, 8), halo=spec.halo, tile=(8, 8), guard=(2, 4, 4))
    g0 = reference.random_padded(spec, (4, 8, 8), seed=7)
    cur = lay.to_internal(g0, torch.float64)
    donor = torch.zeros_like(cur)
    before = (stencil3d.stencil3d_step.launches, stencil3d.stencil3d_step.launches_f64)
    for algorithm in stencil3d.ALGORITHMS + ("vpu_sep",):
        for k in (1, 2):
            out = stencil3d.stencil3d_step(cur, donor, spec, lay, algorithm=algorithm,
                                           fused_steps=k)
            assert out is donor and out.dtype == torch.float64
            assert np.array_equal(lay.from_internal(out).numpy(), reference.run(g0, spec, k))
    # CPU: the plain twin, no launch counted
    assert (stencil3d.stencil3d_step.launches,
            stencil3d.stencil3d_step.launches_f64) == before
    with pytest.raises(TypeError, match="float32 or float64"):
        stencil3d.stencil3d_step(cur.half(), donor.half(), spec, lay)
    with pytest.raises(TypeError, match="donor must be torch.float64"):
        stencil3d.stencil3d_step(cur, donor.float(), spec, lay)
    with pytest.raises(ValueError, match="unknown algorithm"):
        stencil3d.stencil3d_step(cur.float(), donor.float(), spec, lay, algorithm="vpu_sep")
    with pytest.raises(NotImplementedError, match="B13"):
        stencil3d.stencil3d_step(cur, donor, spec, lay, algorithm="mxu")
    with pytest.raises(ValueError, match="reach"):
        stencil3d.stencil3d_step(cur, donor, spec, lay, fused_steps=3)


def test_cli_3d_fp64_check_passes_on_cpu(capsys):
    for dtype in ("df64", "float64"):
        for name, fill in (("star3d1r", "random"), ("box3d1r", "index")):
            assert cli.main([name, "5", "20", "150", "3", "--check", "--device", "cpu",
                             "--dtype", dtype, "--fill", fill]) == 0
            assert "Correct! (max rel err" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        cli.main(["star3d1r", "5", "20", "150", "2", "--device", "cpu", "--dtype", "df64",
                  "--algorithm", "vpu_roll"])
    assert exc.value.code == 2 and "df64 kernel algorithm" in capsys.readouterr().err
