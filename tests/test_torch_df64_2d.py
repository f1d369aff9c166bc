"""The port's fp64-grade tier in 2-D on the CPU: lorastencil_tpu_torch's
StencilEngine with dtype "df64" and "float64" (device="cpu", which runs the
float64 instance's plain twin) against the JAX engine of the same dtype (Pallas
interpret mode: df64 on (hi, lo) fp32 pairs, float64 under jax_enable_x64) and
the fp64 ground truth; the df64 algorithm label, run_checksum, carrying JAX
state across, the refusals and the CLI.  The 1-D cases are in
tests/test_torch_df64_1d.py; the two files are apart so that a test run spread
over workers runs them side by side.

Tolerances, relative to the largest value of the ground truth:
* against JAX df64, 1e-13 after 1, 2 and 4 steps: the pair arithmetic holds
  ~1e-14 per step against fp64 and the port's native fp64 is ~1e-16 per step;
* against JAX float64: the integer fill bit for bit (every partial sum is an
  integer far below 2**53), the pi/100 fill 1e-14 after 4 steps (the two sum
  in different orders);
* against the port's fp64 ground truth (utils/reference.py), 1e-14.
The JAX df64 run_checksum sums each fp32 plane of its pair state in fp32, so
the port's float64 checksum is held to it at 1e-6 of the sum of magnitudes."""

import jax
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models.shapes import StencilSpec as JaxStencilSpec
from lorastencil_tpu.models.shapes import get_shape as jax_get_shape
from lorastencil_tpu.ops import pallas_df64
from lorastencil_tpu_torch import cli, convert, engine
from lorastencil_tpu_torch.models.shapes import ALL_SHAPES, get_shape
from lorastencil_tpu_torch.ops import band_gemm, stencil2d
from lorastencil_tpu_torch.utils import reference

PI = np.pi / 100
SHAPES = ["star2d1r", "box2d1r", "box2d3r"]


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("interior", [(40, 200), (37, 300)])
@pytest.mark.parametrize("name", SHAPES)
def test_df64_engine_matches_jax_df64_and_reference(name, interior):
    """(37, 300): neither the port's (32, 128) tile nor the JAX pair tile
    divides the interior."""
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="df64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="df64")
    assert peng.df64 and peng.df64_pallas and jeng.df64_pallas
    assert peng.df64_algorithm == jeng.df64_algorithm == "vpu_sep"
    assert peng.algorithm == jeng.algorithm and peng._fused_k() == 1
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
    # the JAX df64 checksum sums each fp32 plane of its pair state in fp32
    assert abs(s - jeng.run_checksum(g1, 4)) <= 1e-6 * np.abs(want).sum()


@pytest.mark.parametrize("name", SHAPES)
def test_float64_engine_matches_jax_float64(name, x64):
    interior = (40, 200)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="float64")
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="float64")
    assert peng.algorithm == jeng.algorithm == "vpu_roll"
    assert peng._fused_k() == jeng._fused_k() == 1 and not peng.df64
    g0 = reference.random_padded(spec, interior, seed=22)
    for steps in (1, 2):
        got = peng.run(g0, steps).numpy()
        assert np.array_equal(got, reference.run(g0, spec, steps))
        assert np.array_equal(got, np.asarray(jeng.run(g0, steps)))
    g1 = g0 * PI
    want = reference.run(g1, spec, 4)
    got = peng.run(g1, 4).numpy()
    assert rel_err(got, want) <= 1e-14
    assert rel_err(got, np.asarray(jeng.run(g1, 4))) <= 1e-14


def test_algorithms_and_backends_agree_and_label_as_jax():
    """Every df64 name runs the one fp64 kernel's twin, as does backend 'xla'
    (the plain fp64 step); 'auto' takes the label the JAX engine gives."""
    interior = (30, 70)
    g1 = reference.random_padded(get_shape("star2d1r"), interior, seed=1) * PI
    want = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu",
                                          dtype="df64").run(g1, 3)
    for kw in ({"algorithm": "vpu"}, {"algorithm": "vpu_roll"}, {"algorithm": "vpu_sep"},
               {"backend": "pallas"}, {"backend": "xla"}):
        eng = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu", dtype="df64",
                                             **kw)
        assert eng.df64_pallas == (kw.get("backend") != "xla")
        assert torch.equal(eng.run(g1, 3), want)
    for name in ALL_SHAPES:
        if get_shape(name).ndim == 2:
            assert stencil2d.pick_algorithm(get_shape(name)) == pallas_df64.pick_algorithm(
                jax_get_shape(name)) == "vpu_sep"
    # residue points sharing a row with unequal weights: the dense plan wins
    residue = (((1, 0), 0.5), ((1, 1), 0.25), ((1, -1), -0.75))
    fields = dict(name="row3", ndim=2, radius=1, halo=(1, 1), terms=(), residue=residue,
                  fuse_factor=1)
    spec = convert.spec_from_jax(JaxStencilSpec(**fields))
    assert stencil2d.pick_algorithm(spec) == pallas_df64.pick_algorithm(
        JaxStencilSpec(**fields)) == "vpu_roll"
    eng = engine.StencilEngine(spec, (20, 20), engine.EngineConfig(dtype="df64"), device="cpu")
    assert eng.df64_algorithm == "vpu_roll"
    g = np.random.default_rng(2).standard_normal((22, 22))
    assert np.abs(eng.run(g, 2).numpy() - reference.run(g, spec, 2)).max() <= 1e-14 * np.abs(
        g).max()


def _carry_one_step(jeng, peng, g1):
    """One JAX step on its internal state, carried over with
    convert.state_from_jax and stepped once more by the port (float64)."""
    s1 = np.asarray(jeng.run_internal(jeng.to_internal(g1), 1))
    state = convert.state_from_jax(s1, jeng.layout, peng.layout)
    assert state.dtype == torch.float64 and state.shape == peng.layout.shape
    return s1, peng.from_internal(peng.run_internal(state, 1)).numpy()


def test_state_from_jax_takes_a_df64_pair():
    name, interior = "box2d1r", (40, 200)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="df64")
    g1 = reference.random_padded(spec, interior, seed=5) * PI
    pair, got = _carry_one_step(
        jax_engine.StencilEngine.for_shape(name, interior, dtype="df64"), peng, g1)
    assert pair.shape[0] == 2 and pair.dtype == np.float32  # (hi, lo) planes
    assert rel_err(got, reference.run(g1, spec, 2)) <= 1e-13
    assert np.array_equal(convert.merge_pair(pair), pair[0].astype(np.float64) + pair[1])


def test_state_from_jax_takes_a_float64_state(x64):
    name, interior = "box2d1r", (40, 200)
    spec = get_shape(name)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="float64")
    g1 = reference.random_padded(spec, interior, seed=5) * PI
    s1, got = _carry_one_step(
        jax_engine.StencilEngine.for_shape(name, interior, dtype="float64"), peng, g1)
    assert s1.dtype == np.float64
    assert rel_err(got, reference.run(g1, spec, 2)) <= 1e-14


def test_run_keeps_input_decays_halo_and_counts_no_cpu_launches():
    interior = (37, 45)
    eng = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu", dtype="df64")
    g0 = reference.random_padded(eng.spec, interior, seed=8) * PI + 1.0  # nonzero halo
    keep = g0.copy()
    before = (stencil2d.stencil2d_step.launches_f64, stencil2d.stencil2d_step.launches)
    out = eng.run(g0, 3).numpy()
    halo = np.ones(out.shape, dtype=bool)
    halo[4:-4, 4:-4] = False
    assert np.all(out[halo] == 0) and np.all(out[~halo] != 0)
    assert np.array_equal(g0, keep)
    state = eng.to_internal(g0)
    assert state.dtype == torch.float64
    snapshot = state.clone()
    eng.run_internal(state, 3)
    assert torch.equal(state, snapshot)
    assert np.array_equal(eng.run(g0, 0).numpy(), g0)
    assert (stencil2d.stencil2d_step.launches_f64,
            stencil2d.stencil2d_step.launches) == before


def test_wrappers_take_float64_and_refuse_the_rest():
    spec = get_shape("star2d1r")
    lay = engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cpu").layout
    cur = torch.zeros(lay.shape, dtype=torch.float64)
    donor = torch.zeros_like(cur)
    for algorithm in stencil2d.DF64_ALGORITHMS + stencil2d.ALGORITHMS:
        assert stencil2d.stencil2d_step(cur, donor, spec, lay, algorithm=algorithm) is donor
    with pytest.raises(TypeError):
        stencil2d.stencil2d_step(cur.half(), donor.half(), spec, lay)
    with pytest.raises(TypeError):
        stencil2d.stencil2d_step(cur, donor.float(), spec, lay)
    with pytest.raises(ValueError, match="unknown algorithm"):
        stencil2d.stencil2d_step(cur.float(), donor.float(), spec, lay, algorithm="vpu_sep")
    with pytest.raises(ValueError, match="reach"):  # fused_steps * radius > guard
        stencil2d.stencil2d_step(cur, donor, spec, lay, fused_steps=2)
    # the table holds fp64 taps unrounded (a float32 table rounds 0.1)
    tenth = convert.spec_from_jax(JaxStencilSpec(
        name="tenth", ndim=2, radius=1, halo=(1, 1), terms=(), residue=(((0, 1), 0.1),),
        fuse_factor=1))
    assert band_gemm.plan_array(tenth, torch.float64).tolist()[-1] == 0.1
    assert band_gemm.plan_array(tenth).tolist()[-1] != 0.1


@pytest.mark.parametrize("kw,err,match", [
    ({"dtype": "df64", "algorithm": "mxu_hybrid1"}, ValueError, "df64 kernel algorithm"),
    ({"dtype": "df64", "algorithm": "fast"}, ValueError, "algorithm"),
    ({"dtype": "float64", "algorithm": "vpu_sep"}, ValueError, "no 2-D path"),
])
def test_2d_fp64_configs_that_raise(kw, err, match):
    with pytest.raises(err, match=match):
        engine.StencilEngine.for_shape("star2d1r", (40, 200), device="cpu", **kw)
    if kw.get("algorithm") == "mxu_hybrid1":  # the JAX engine refuses it too
        with pytest.raises(ValueError, match="df64 kernel algorithm"):
            jax_engine.StencilEngine.for_shape("star2d1r", (40, 200), **kw)


@pytest.mark.parametrize("kw", [{"dtype": "float64", "boundary": "reflect"},
                                {"dtype": "df64", "boundary": "periodic"}])
def test_2d_fp64_ghost_configs_now_run(kw):
    """Once refused (ROADMAP A6): the mode's fp64 ground truth at 1e-13."""
    spec = get_shape("star2d1r")
    g0 = reference.random_padded(spec, (40, 200), seed=8) * PI
    truth = (reference.run_periodic if kw["boundary"] == "periodic"
             else reference.run_reflect)
    got = engine.StencilEngine.for_shape("star2d1r", (40, 200), device="cpu", **kw).run(g0, 4)
    assert rel_err(got.numpy(), truth(g0, spec, 4)) <= 1e-13


@pytest.mark.parametrize("dtype", ["df64", "float64"])
def test_3d_fp64_raises_b10(dtype):
    """B10 is ported: 3-D takes both fp64-grade dtypes (tests/test_torch_df64_3d.py
    holds them against the JAX engine); what 3-D still refuses names its item."""
    eng = engine.StencilEngine.for_shape("box3d1r", (6, 20, 150), device="cpu", dtype=dtype)
    g0 = reference.random_padded(eng.spec, (6, 20, 150), seed=3)
    assert np.array_equal(eng.run(g0, 2).numpy(), reference.run(g0, eng.spec, 2))
    # the ghost boundaries run too (ROADMAP A6 is ported)
    ghost = engine.StencilEngine.for_shape("box3d1r", (6, 20, 150), device="cpu", dtype=dtype,
                                           boundary="periodic")
    assert rel_err(ghost.run(g0, 2).numpy(), reference.run_periodic(g0, eng.spec, 2)) <= 1e-13


def test_cli_fp64_check_passes_on_cpu(capsys):
    for dtype in ("df64", "float64"):
        assert cli.main(["star2d1r", "40", "200", "3", "--check", "--device", "cpu",
                         "--dtype", dtype]) == 0
        assert "Correct! (max rel err" in capsys.readouterr().out
    assert cli.main(["box2d3r", "33", "65", "2", "--check", "--device", "cpu", "--dtype",
                     "df64", "--algorithm", "vpu_roll", "--fill", "index"]) == 0
    assert cli.main(["star3d1r", "6", "20", "150", "2", "--check", "--device", "cpu",
                     "--dtype", "float64"]) == 0
    assert "Correct! (max rel err" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["star2d1r", "40", "200", "2", "--device", "cpu", "--dtype", "df64",
                  "--algorithm", "mxu_hybrid1"])
