"""The port's fp64-grade tier in 1-D on the CPU: lorastencil_tpu_torch's
StencilEngine with dtype "df64" and "float64" (device="cpu", which runs the
float64 instances' plain twins) against the JAX engine of the same dtype (Pallas
interpret mode: df64 on (hi, lo) fp32 pairs, float64 under jax_enable_x64) and
the fp64 ground truth, on every 1-D df64 branch (the narrow run, narrow passes,
wide passes, the plain step of a centre-only spec), the float64 dispatch, the
wrappers' fp64 instances, carrying a JAX pair state across and the refusals.

Tolerances, relative to the largest value of the ground truth: against JAX df64
1e-13 after 1, 2 and 4 steps; against JAX float64 the integer fill bit for bit
and the pi/100 fill 1e-14 after 4 steps; against the port's fp64 ground truth
(utils/reference.py) 1e-14 (see tests/test_torch_df64_2d.py)."""

import jax
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.ops import pallas_1d, pallas_df64_1d
from lorastencil_tpu.ops.layout import Layout1DLanes
from lorastencil_tpu_torch import cli, convert, engine
from lorastencil_tpu_torch.ops import stencil1d
from lorastencil_tpu_torch.ops.layout import TILE_1D, Layout1D, guard_1d
from lorastencil_tpu_torch.utils import reference

PI = np.pi / 100
# each 1-D JAX df64 kernel -> the port's wrapper whose float64 instance replaces it
FP64_WRAPPERS = {"stencil1d_resident_pair": "stencil1d_resident_lanes",
                 "df64_1d_step": "stencil1d_lanes_step",
                 "df64_1d_flat_step": "stencil1d_step"}


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def jax_path(jeng, itemsize=4):
    """The JAX engine's 1-D branch, named as the port's ``path``."""
    lay = jeng.layout
    if isinstance(lay, Layout1DLanes):
        return "resident_lanes" if lay.resident else "lanes"
    return ("resident" if not jeng.df64 and pallas_1d.fits_resident(lay, itemsize)
            else "flat")


def wide_taps(r):
    """for_coeffs taps of effective radius r: integers in [-3, 3] over 256."""
    taps = np.random.default_rng(r).integers(-3, 4, 2 * r + 1) / 256.0
    taps[0] = taps[-1] = 1.0 / 256.0
    return taps


def sparse_taps(r):
    """Four taps of effective radius r, unequal at +-r // 3 (the JAX df64
    pair chain's compile time in interpret mode grows with the tap count)."""
    taps = np.zeros(2 * r + 1)
    taps[0] = taps[-1] = 0.5
    taps[r] = 1.0
    taps[r // 3] = -0.625
    return taps


def engines(case, n, dtype, **kw):
    if case.startswith("r"):
        r = int(case[1:])
        taps = sparse_taps(r) if dtype == "df64" else wide_taps(r)
        return (engine.StencilEngine.for_coeffs(taps, (n,), device="cpu", dtype=dtype, **kw),
                jax_engine.StencilEngine.for_coeffs(taps, (n,), dtype=dtype, **kw))
    return (engine.StencilEngine.for_shape(case, (n,), device="cpu", dtype=dtype, **kw),
            jax_engine.StencilEngine.for_shape(case, (n,), dtype=dtype, **kw))


@pytest.mark.parametrize("case,n,kw,path,counter", [
    ("1d1r", 4096, {}, "resident_lanes", "stencil1d_resident_pair"),
    ("1d2r", 20_000, {"lanes_width": 256}, "lanes", "df64_1d_step"),
    ("r40", 3001, {}, "flat", "df64_1d_flat_step"),
    ("r127", 3001, {}, "flat", "df64_1d_flat_step"),
])
def test_df64_engine_matches_jax_df64_and_reference(case, n, kw, path, counter):
    """The three df64 kernel branches: 1d1r 4096 fits the resident cap at 8 B
    per cell; lanes_width (as lanes_tile_rows) keeps a grid off the resident
    run in both engines; r_eff = 40 and 127 (four taps) take the wide pass,
    never a run."""
    peng, jeng = engines(case, n, "df64", **kw)
    assert peng.path == jax_path(jeng) == path
    assert peng.df64_pallas and jeng.df64_pallas and peng._fused_k() == jeng._fused_k() == 1
    assert peng.df64_algorithm == jeng.df64_algorithm == "vpu_roll"
    assert peng.algorithm == jeng.algorithm
    spec = peng.spec
    g1 = reference.random_padded(spec, (n,), seed=31) * PI
    for steps in (1, 2, 4):
        want = reference.run(g1, spec, steps)
        got = peng.run(g1, steps)
        assert got.dtype == torch.float64 and tuple(got.shape) == g1.shape
        assert rel_err(got.numpy(), want) <= 1e-14
        assert rel_err(got.numpy(), jeng.run(g1, steps)) <= 1e-13
    s = float(peng.run_checksum(g1, 4))
    assert abs(s - want.sum()) <= 1e-14 * np.abs(want).sum()
    wrapper = getattr(stencil1d, FP64_WRAPPERS[counter])
    launches = (wrapper.launches, wrapper.launches_f64)
    peng.run(g1, 3)
    assert (wrapper.launches, wrapper.launches_f64) == launches  # CPU: the twin


def test_df64_resident_run_crosses_refreshes():
    """17 steps of 1d1r: two halo reloads (every 8 steps) and a tail."""
    peng, jeng = engines("1d1r", 4096, "df64")
    g1 = reference.random_padded(peng.spec, (4096,), seed=32) * PI
    want = reference.run(g1, peng.spec, 17)
    got = peng.run(g1, 17).numpy()
    assert rel_err(got, want) <= 1e-14 and rel_err(got, jeng.run(g1, 17)) <= 1e-13


@pytest.mark.parametrize("case,n,kw,path,k", [
    ("1d1r", 4096, {}, "resident_lanes", 2),
    ("1d2r", 300_000, {}, "lanes", 2),
    ("1d2r", 3001, {"algorithm": "vpu"}, "resident", 2),
    ("r40", 3001, {}, "resident", 2),
])
def test_float64_engine_matches_jax_float64(case, n, kw, path, k, x64):
    """dtype float64 keeps the float32 dispatch at 8 B per cell: 'vpu_roll'
    (auto) takes the narrow kernels at k = 2; r_eff = 40 and 'vpu' the wide
    run (the 512 KiB cap holds 3001 cells); 300,000 cells exceed both caps."""
    peng, jeng = engines(case, n, "float64", **kw)
    assert peng.path == jax_path(jeng, 8) == path
    assert peng._fused_k() == jeng._fused_k() == k and peng.algorithm == jeng.algorithm
    spec = peng.spec
    g0 = reference.random_padded(spec, (n,), seed=33)
    for steps in (1, 2):
        got = peng.run(g0, steps).numpy()
        assert np.array_equal(got, reference.run(g0, spec, steps))
        assert np.array_equal(got, np.asarray(jeng.run(g0, steps)))
    g1 = g0 * PI
    want = reference.run(g1, spec, 5)
    got = peng.run(g1, 5).numpy()
    assert rel_err(got, want) <= 1e-14
    assert rel_err(got, np.asarray(jeng.run(g1, 5))) <= 1e-14


def test_df64_centre_only_spec_runs_the_plain_step():
    """An effective radius of 0 has no df64 kernel in either engine: 'auto'
    runs the plain fp64 step, 'pallas' raises."""
    taps = np.zeros(9)
    taps[4] = 1.5
    peng = engine.StencilEngine.for_coeffs(taps, (4096,), device="cpu", dtype="df64")
    jeng = jax_engine.StencilEngine.for_coeffs(taps, (4096,), dtype="df64")
    assert not peng.df64_pallas and not jeng.df64_pallas and peng.backend == "xla"
    g1 = reference.random_padded(peng.spec, (4096,), seed=34) * PI
    got = peng.run(g1, 3).numpy()
    assert rel_err(got, reference.run(g1, peng.spec, 3)) <= 1e-14
    assert rel_err(got, jeng.run(g1, 3)) <= 1e-13
    with pytest.raises(ValueError, match="1-D needs an effective radius"):
        engine.StencilEngine.for_coeffs(taps, (4096,), device="cpu", dtype="df64",
                                        backend="pallas")
    with pytest.raises(ValueError, match="1-D needs an effective radius"):
        jax_engine.StencilEngine.for_coeffs(taps, (4096,), dtype="df64", backend="pallas")


def test_state_from_jax_takes_a_1d_df64_pair():
    """A JAX df64 lanes pair state (its halo lanes stale by contract), one step
    in, carried over and stepped once more by the port."""
    peng, jeng = engines("1d2r", 20_000, "df64", lanes_width=256)
    g1 = reference.random_padded(peng.spec, (20_000,), seed=35) * PI
    pair = np.asarray(jeng.run_internal(jeng.to_internal(g1), 1))
    assert pair.shape == (2,) + jeng.layout.shape
    state = convert.state_from_jax(pair, jeng.layout, peng.layout)
    assert state.dtype == torch.float64
    got = peng.from_internal(peng.run_internal(state, 1)).numpy()
    assert rel_err(got, reference.run(g1, peng.spec, 2)) <= 1e-13


@pytest.mark.parametrize("wrapper,fp64,k", [
    ("stencil1d_lanes_step", "df64_1d_step", 8),
    ("stencil1d_step", "df64_1d_flat_step", 3),
])
def test_pass_wrappers_route_float64_to_their_fp64_instance(wrapper, fp64, k):
    """A float64 pass through the wrapper (its float64 instance replaces the JAX
    kernel ``fp64``) is bit for bit against the ground truth on the integer fill
    and counts no launch on the CPU; a mixed or a half state raises."""
    assert FP64_WRAPPERS[fp64] == wrapper and callable(getattr(pallas_df64_1d, fp64))
    fn = getattr(stencil1d, wrapper)
    spec = engine.StencilEngine.for_shape("1d2r", (64,), device="cpu").spec
    n = 5000
    lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], k * 4))
    g0 = reference.random_padded(spec, (n,), seed=36)
    x = lay.to_internal(g0, torch.float64)
    launches = (fn.launches, fn.launches_f64)
    out = fn(x, torch.zeros_like(x), spec, lay, fused_steps=k)
    assert out.dtype == torch.float64
    assert np.array_equal(lay.from_internal(out).numpy(), reference.run(g0, spec, k))
    assert (fn.launches, fn.launches_f64) == launches
    with pytest.raises(TypeError):
        fn(x.half(), torch.zeros_like(x.half()), spec, lay)
    with pytest.raises(TypeError):
        fn(x, torch.zeros_like(x.float()), spec, lay)


def test_run_wrappers_and_the_fp64_reach_cap():
    spec = engine.StencilEngine.for_shape("1d1r", (64,), device="cpu").spec
    n = 3001
    lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], 24))
    g0 = reference.random_padded(spec, (n,), seed=37)
    x = lay.to_internal(g0, torch.float64)
    want = reference.run(g0, spec, 11)
    for run in (stencil1d.stencil1d_resident_lanes, stencil1d.stencil1d_resident):
        out = run(x, spec, lay, 11)
        assert out.dtype == torch.float64
        assert np.array_equal(lay.from_internal(out).numpy(), want)
        with pytest.raises(TypeError):
            run(x.half(), spec, lay, 3)
    # a wide fp64 pass holds twice the bytes per cell in shared memory
    assert stencil1d.max_pass_reach(torch.float32) >= stencil1d.MAX_FUSED * stencil1d.MAX_RADIUS
    wide = engine.StencilEngine.for_coeffs(wide_taps(127), (64,), device="cpu").spec
    big = Layout1D(n, 127, TILE_1D, guard_1d(127, 64 * 127))
    y = torch.zeros(big.shape, dtype=torch.float64)
    assert stencil1d.max_pass_reach(torch.float64) // 127 == 48
    stencil1d.stencil1d_step(y, torch.zeros_like(y), wide, big, fused_steps=48)
    with pytest.raises(ValueError, match="shared memory"):
        stencil1d.stencil1d_step(y, torch.zeros_like(y), wide, big, fused_steps=49)
    stencil1d.stencil1d_step(y.float(), torch.zeros_like(y.float()), wide, big, fused_steps=64)


@pytest.mark.parametrize("kw,err,match", [
    ({"dtype": "df64", "algorithm": "vpu_sep"}, ValueError, "1-D"),
    ({"dtype": "df64", "algorithm": "mxu"}, ValueError, "df64 kernel algorithm"),
])
def test_1d_fp64_configs_that_raise(kw, err, match):
    with pytest.raises(err, match=match):
        engine.StencilEngine.for_shape("1d1r", (4096,), device="cpu", **kw)
    if err is ValueError:  # the JAX engine refuses it too
        with pytest.raises(ValueError, match=match):
            jax_engine.StencilEngine.for_shape("1d1r", (4096,), **kw)


@pytest.mark.parametrize("kw", [{"dtype": "float64", "boundary": "reflect"}])
def test_1d_fp64_ghost_configs_now_run(kw):
    """Once refused (ROADMAP A6): passes on the flat path (no run), the
    mode's fp64 ground truth at 1e-13."""
    eng = engine.StencilEngine.for_shape("1d1r", (4096,), device="cpu", **kw)
    assert eng.path == "flat" and eng._fused_k() == 2
    g0 = reference.random_padded(eng.spec, (4096,), seed=9) * PI
    want = reference.run_reflect(g0, eng.spec, 4)
    got = eng.run(g0, 4).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_cli_1d_fp64_check_passes_on_cpu(capsys):
    for dtype in ("df64", "float64"):
        assert cli.main(["1d2r", "5000", "3", "--check", "--device", "cpu",
                         "--dtype", dtype]) == 0
        assert "Correct!" in capsys.readouterr().out
