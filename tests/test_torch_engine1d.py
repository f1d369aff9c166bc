"""The port's 1-D path end to end on the CPU: lorastencil_tpu_torch's StencilEngine
(device="cpu", which runs the CUDA kernels' plain twins) against the JAX engine
(Pallas interpret mode) and the fp64 ground truth, its dispatch, for_coeffs,
the refusals and the CLI.  The kernel-level cases are in
tests/test_torch_stencil1d.py; the two files are apart so that a test run
spread over workers runs them side by side.

Tolerances: with the integer fill every partial sum of steps 1-2 is an integer
below 2**24, so the port, the JAX engine and the ground truth agree bit for bit.
On the pi/100 fill, and over a resident run's 2*refresh + 3 steps, the two
packages round in different orders (the JAX engine's default 'mxu' sums a
3-part bf16 split through matmuls): rel <= 1e-6 of the largest value."""

import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models.shapes import get_shape as jax_get_shape
from lorastencil_tpu.ops.layout import Layout1D as JaxLayout1D
from lorastencil_tpu.ops.layout import Layout1DLanes
from lorastencil_tpu_torch import cli, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil1d
from lorastencil_tpu_torch.utils import reference

PI = np.pi / 100


def _jax_path(jeng):
    """The JAX engine's 1-D branch, named as the port's ``path``."""
    lay = jeng.layout
    if isinstance(lay, Layout1DLanes):
        return "resident_lanes" if lay.resident else "lanes"
    from lorastencil_tpu.ops import pallas_1d

    return "resident" if pallas_1d.fits_resident(lay) else "flat"


def compare_engines(peng, jeng, n, steps_list=(1, 2), long_steps=(4,), seed=21):
    assert peng.path == _jax_path(jeng)
    assert peng.algorithm == jeng.algorithm and peng._fused_k() == jeng._fused_k()
    spec = peng.spec
    g0 = reference.random_padded(spec, (n,), seed=seed)
    for steps in steps_list:  # exact: integers below 2**24
        got = peng.run(g0, steps)
        assert got.dtype == torch.float32 and got.shape == (n + 2 * spec.halo[0],)
        got = got.numpy()
        assert np.array_equal(got, reference.run(g0, spec, steps))
        assert np.array_equal(got, np.asarray(jeng.run(g0, steps)))
    g1 = g0 * PI
    for steps in long_steps:
        want = reference.run(g1, spec, steps)
        scale = np.abs(want).max()
        got = peng.run(g1, steps).numpy()
        assert np.abs(got - want).max() <= 1e-6 * scale
        assert np.abs(got - np.asarray(jeng.run(g1, steps))).max() <= 1e-6 * scale
    want = reference.run(g1, spec, long_steps[0])
    total = np.abs(want).sum()
    s = float(peng.run_checksum(g1, long_steps[0]))
    assert abs(s - want.sum()) <= 1e-6 * total
    if not isinstance(jeng.layout, Layout1DLanes):
        # the JAX checksum sums its internal buffer, which on a lanes layout
        # holds every halo cell twice (duplicated lanes); the port's sums the
        # padded state, like the JAX flat layouts
        assert abs(s - float(jeng.run_checksum(g1, long_steps[0]))) <= 1e-6 * total


@pytest.mark.parametrize("n", [4096, 3001])
@pytest.mark.parametrize("name", ["1d1r", "1d2r"])
def test_resident_engine_matches_jax_engine_and_reference(name, n):
    """Both engines run all steps in one resident launch (2*refresh + 3 = 19
    steps crosses two halo reloads and a tail)."""
    peng = engine.StencilEngine.for_shape(name, (n,), device="cpu")
    jeng = jax_engine.StencilEngine.for_shape(name, (n,))
    assert peng.path == "resident_lanes"
    compare_engines(peng, jeng, n, long_steps=(4, 19))


@pytest.mark.parametrize("name", ["1d1r", "1d2r"])
def test_tiled_engine_matches_jax_engine_and_reference(name):
    """n = 600,000: the JAX engine builds a tiled Layout1DLanes and the port's
    2.4 MB state exceeds its 2 MiB cap, so both run passes of k fused steps
    (k = 12 // r_eff: 4 for 1d1r, 3 for 1d2r) and a remainder pass."""
    n = 600_000
    peng = engine.StencilEngine.for_shape(name, (n,), device="cpu")
    jeng = jax_engine.StencilEngine.for_shape(name, (n,))
    assert peng.path == "lanes" and peng._fused_k() == {"1d1r": 4, "1d2r": 3}[name]
    compare_engines(peng, jeng, n, steps_list=(2,), long_steps=(5,))


def _launches(eng, steps):
    """Kernel launches of ``run_internal(steps)``, counted without running it."""
    if eng.path.startswith("resident") and steps > 0:
        return 1
    seen = []
    engine.ping_pong_loop(lambda c, d, depth: seen.append(depth) or d, torch.zeros(1), steps,
                          eng._fused_k())
    return len(seen)


@pytest.mark.parametrize("name,n,kw,path,k,launches", [
    ("1d1r", 4096, {}, "resident_lanes", 4, 1),
    ("1d2r", 1_000_000, {}, "lanes", 3, 86),
    ("1d2r", 16_777_216, {}, "lanes", 3, 86),
    ("1d1r", 4096, {"algorithm": "vpu"}, "resident", 2, 1),
    ("1d2r", 1_000_000, {"algorithm": "vpu"}, "flat", 2, 128),
    ("1d2r", 1_000_000, {"algorithm": "vpu_roll"}, "lanes", 2, 128),
    ("1d2r", 1_000_000, {"fused_steps": 12}, "lanes", 8, 32),
    ("1d2r", 1_000_000, {"algorithm": "vpu", "fused_steps": 100}, "flat", 64, 4),
])
def test_dispatch_at_the_baseline_sizes(name, n, kw, path, k, launches):
    """The branch, k and launches per 256 steps that each engine picks, asserted
    without running: 1d1r 4096 x 64 is one resident launch, 1d2r 1,000,000 x 256
    is 85 passes of 3 and one of 1; 'vpu' takes the flat counterparts."""
    steps = 64 if n == 4096 else 256
    peng = engine.StencilEngine.for_shape(name, (n,), device="cpu", **kw)
    jeng = jax_engine.StencilEngine.for_shape(name, (n,), **kw)
    assert (peng.path, peng._fused_k(), _launches(peng, steps)) == (path, k, launches)
    assert _jax_path(jeng) == path and jeng._fused_k() == k
    assert peng.layout.guard >= (stencil1d.lanes_refresh(3) * 3 if path == "resident_lanes"
                                 else k * stencil1d.effective_radius(peng.spec))


def test_for_coeffs_vpu_and_xla_match_jax():
    """for_coeffs taps: r = 40 (wider than the lanes kernels) runs the flat
    resident kernel; r = 6 and r = 12 the lanes resident kernel (compile-time
    and run-time radius on the card).  algorithm='vpu' and backend='xla' on
    1d2r."""
    rng = np.random.default_rng(4)
    n = 3001
    for r, path in ((40, "resident"), (6, "resident_lanes"), (12, "resident_lanes")):
        taps = rng.integers(-3, 4, 2 * r + 1).astype(np.float64)
        taps[0] = taps[-1] = 1.0  # r_eff = r
        peng = engine.StencilEngine.for_coeffs(taps, (n,), device="cpu")
        jeng = jax_engine.StencilEngine.for_coeffs(taps, (n,))
        assert peng.path == path and stencil1d.effective_radius(peng.spec) == r
        g0 = reference.random_padded(peng.spec, (n,), seed=r)
        for steps in (1, 2):
            got = peng.run(g0, steps).numpy()
            want = reference.run(g0, peng.spec, steps)
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
            assert np.array_equal(got, np.asarray(jeng.run(g0, steps)))
    vpu = engine.StencilEngine.for_shape("1d2r", (n,), device="cpu", algorithm="vpu")
    compare_engines(vpu, jax_engine.StencilEngine.for_shape("1d2r", (n,), algorithm="vpu"), n,
                    long_steps=(5,))
    assert isinstance(jax_engine.StencilEngine.for_shape("1d2r", (n,), algorithm="vpu").layout,
                      JaxLayout1D)
    xla = engine.StencilEngine.for_shape("1d1r", (n,), device="cpu", backend="xla")
    jxla = jax_engine.StencilEngine.for_shape("1d1r", (n,), backend="xla")
    g0 = reference.random_padded(xla.spec, (n,), seed=5)
    assert xla._fused_k() == 1
    for steps in (1, 2):
        got = xla.run(g0, steps).numpy()
        assert np.array_equal(got, reference.run(g0, xla.spec, steps))
        assert np.array_equal(got, np.asarray(jxla.run(g0, steps)))


def test_run_keeps_input_decays_halo_and_counts_no_cpu_launches():
    counters = [stencil1d.stencil1d_resident_lanes, stencil1d.stencil1d_lanes_step]
    before = [f.launches for f in counters]
    for n in (3001, 600_000):
        eng = engine.StencilEngine.for_shape("1d2r", (n,), device="cpu")
        g0 = reference.random_padded(eng.spec, (n,), seed=8) + 1.0  # nonzero halo
        keep = g0.copy()
        out = eng.run(g0, 3).numpy()
        assert np.all(out[:4] == 0) and np.all(out[-4:] == 0) and np.all(out[4:-4] != 0)
        assert np.array_equal(g0, keep)
        state = eng.to_internal(g0)
        before_state = state.clone()
        eng.run_internal(state, 3)
        assert torch.equal(state, before_state)
        assert np.array_equal(eng.run(g0, 0).numpy(), g0.astype(np.float32))
    assert [f.launches for f in counters] == before  # CPU: the twins


@pytest.mark.parametrize("kw,err,match", [
    ({"dtype": "bfloat16"}, NotImplementedError, "ROADMAP A6"),
    ({"fusion": "skew"}, ValueError, "2-D time-skewed"),
    ({"interpret": True}, ValueError, "interpret"),
])
def test_1d_configs_that_still_raise(kw, err, match):
    with pytest.raises(err, match=match):
        engine.StencilEngine.for_shape("1d2r", (4096,), device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    {"dtype": "float64", "boundary": "periodic"},
    {"dtype": "df64", "boundary": "reflect"},
    {"boundary": "periodic"},
    {"boundary": "reflect"},
])
def test_1d_ghost_configs_now_run(kw):
    """Once refused (ROADMAP A6): each runs passes (no run under a ghost
    boundary) and matches the mode's fp64 ground truth, rel 1e-6 in float32
    and 1e-13 in the fp64-grade tier."""
    eng = engine.StencilEngine.for_shape("1d2r", (4096,), device="cpu", **kw)
    assert eng.path in ("flat", "lanes")
    g0 = reference.random_padded(eng.spec, (4096,), seed=6)
    truth = (reference.run_periodic if kw["boundary"] == "periodic"
             else reference.run_reflect)
    want = truth(g0, eng.spec, 5)
    tol = 1e-6 if "dtype" not in kw else 1e-13
    got = eng.run(g0, 5).numpy().astype(np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_for_coeffs_refusals_and_accepted_lanes_options():
    for coeffs in (np.ones((3, 3)), np.ones((3, 3, 3))):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            engine.StencilEngine.for_coeffs(coeffs, (16,) * coeffs.ndim, device="cpu")
    with pytest.raises(ValueError, match="odd length"):
        engine.StencilEngine.for_coeffs(np.ones(4), (100,), device="cpu")
    with pytest.raises(ValueError, match="exceeds 127"):
        engine.StencilEngine.for_coeffs(np.ones(257), (1000,), device="cpu")
    base = engine.StencilEngine.for_shape("1d2r", (600_000,), device="cpu")
    other = engine.StencilEngine.for_shape("1d2r", (600_000,), device="cpu",
                                           lanes_width=256, lanes_tile_rows=16, tile=(8, 8))
    assert (other.layout, other.path, other._fused_k()) == (base.layout, base.path, 3)
    for name in ("1d1r", "1d2r"):
        assert (engine.resolve_algorithm(get_shape(name), "auto")
                == jax_engine.resolve_algorithm(jax_get_shape(name), "auto") == "mxu")


def test_cuda_device_raises_without_cuda_1d():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.StencilEngine.for_shape("1d2r", (4096,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.StencilEngine.for_coeffs(np.ones(9), (4096,))


def test_cli_1d_check_passes_on_cpu(capsys):
    assert cli.main(["1d2r", "5000", "3", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Correct!" in out and "sizes = (5000,)" in out
    assert cli.main(["1d1r", "3001", "2", "--check", "--device", "cpu", "--fill", "index",
                     "--algorithm", "vpu"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["1d2r", "20", "150", "2", "--device", "cpu"])  # 2 sizes for a 1-D shape
