"""2-D extent fusion in the port on the CPU: lorastencil_tpu_torch's StencilEngine
at fused depths k > 1 (star2d3r's default k = 2, ``fused_steps``; device="cpu",
which runs the fused kernel's plain twin) against the JAX engine (Pallas interpret
mode) and the fp64 ground truth; the fused-depth rule ``_fused_k`` against the JAX
engine's; a pass deeper than one launch takes; ``residue_mxu='on'``; the CLI.
The skewed traversal is in tests/test_torch_skew2d.py and the whole-grid runs in
tests/test_torch_resident2d.py, apart so that a run spread over workers runs them
side by side.

Every JAX engine here reads its autotune cache from an empty directory, so its
``fusion='auto'`` resolves 'extent', as the port's does.

Tolerances, relative to the largest value of the ground truth:
* integer fills bit for bit while every partial sum is an integer below 2**24:
  the 0..99 fill for 2 steps (3 for star2d3r, whose taps sum to 28), the 0/1
  fill for 3 steps of any 2-D registry shape (taps summing to at most 232);
* the pi/100 fill 1e-5 after 4 or more steps, the limit the 2-D port already
  holds against the fp64 ground truth (the packages sum symmetric tap pairs in
  different orders, and the kernel fuses multiply-adds);
* float64 against JAX float64 and the ground truth 1e-14 after 4 steps."""

import jax
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import cli, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.utils import reference

PI = np.pi / 100
SHAPES = ["star2d1r", "star2d3r", "box2d1r", "box2d3r"]


@pytest.fixture(autouse=True)
def empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LORASTENCIL_CACHE", str(tmp_path))


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def engines(name, interior, **kw):
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", **kw)
    jeng = jax_engine.StencilEngine.for_shape(name, interior, **kw)
    assert peng._fused_k() == jeng._fused_k()
    assert peng._fusion_mode() == jeng._fusion_mode() == "extent"
    return peng, jeng


def agree(peng, jeng, g, steps, exact):
    """The port's run of ``steps`` against the JAX engine's and the ground
    truth: bit for bit, or within 1e-5."""
    spec = peng.spec
    got = peng.run(g, steps)
    assert got.shape == g.shape and got.device.type == "cpu"
    got = got.numpy()
    want = reference.run(g, spec, steps)
    jgot = np.asarray(jeng.run(g, steps))
    if exact:
        assert np.abs(want).max() < 2**24
        assert np.array_equal(got, want) and np.array_equal(got, jgot)
    else:
        assert rel_err(got, want) <= 1e-5 and rel_err(got, jgot) <= 1e-5


@pytest.mark.parametrize("interior", [(64, 256), (40, 300)])
def test_star2d3r_default_k2_matches_jax_and_reference(interior):
    """The slice's main path: star2d3r with the defaults fuses k = 2."""
    peng, jeng = engines("star2d3r", interior)
    assert peng.algorithm == jeng.algorithm == "mxu_hybrid1"
    assert peng._fused_k() == 2 and peng.layout.guard == (8, 8)
    g0 = reference.random_padded(peng.spec, interior, seed=21)
    for steps in (1, 2, 3):  # one remainder pass, one pass, pass + remainder
        agree(peng, jeng, g0, steps, exact=True)
    g1 = g0 * PI
    agree(peng, jeng, g1, 4, exact=False)
    want = reference.run(g1, peng.spec, 4)
    s = float(peng.run_checksum(g1, 4))
    assert abs(s - want.sum()) <= 1e-5 * np.abs(want).sum()
    assert abs(s - float(jeng.run_checksum(g1, 4))) <= 1e-5 * np.abs(want).sum()


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["box2d1r", "box2d3r", "star2d1r"])
def test_fused_steps_match_jax_and_reference(name, k):
    interior = (40, 300)  # neither package's tile divides it
    peng, jeng = engines(name, interior, fused_steps=k)
    assert peng._fused_k() == k
    g0 = reference.random_padded(peng.spec, interior, seed=22)
    for steps in (2, 3):
        agree(peng, jeng, g0 % 2, steps, exact=True)
    agree(peng, jeng, g0 * PI, 2 * k + 1, exact=False)


def test_depth_above_one_launch_matches_jax():
    """One step deeper than a single launch of the fused kernel takes: on the
    card the pass runs as two launches (tests/test_torch_cuda.py); every level
    is masked, so the values are those of single steps."""
    name, interior = "star2d1r", (40, 300)
    spec = get_shape(name)
    k = stencil2d.max_fused_steps("step", spec.radius, stencil2d.plan_len(spec),
                                  torch.float32) + 1
    assert 2 < k <= 128 // spec.radius
    peng, jeng = engines(name, interior, fused_steps=k)
    assert peng._fused_k() == k
    g1 = reference.random_padded(spec, interior, seed=23) * PI
    agree(peng, jeng, g1, k, exact=False)
    single = engine.StencilEngine.for_shape(name, interior, device="cpu", fused_steps=1)
    assert torch.equal(peng.run(g1, k), single.run(g1, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_deep_pass_splits_into_launches(dtype, monkeypatch):
    """The wrapper's split of a pass deeper than one launch of the tile
    kernel, on the CPU: each launch replaced by its twin, the pass
    ping-pongs between the donor and a spare buffer and equals the unsplit
    pass bit for bit.  In float32 and in float64 every launch is the strip
    kernel's single step (launches of the strip walk's depth, each split by
    ``strips_beat_plan``)."""
    spec = get_shape("star2d3r")  # taps summing to 28: 23 steps stay finite in fp32
    k = 2 * stencil2d.max_fused_steps("step", spec.radius, stencil2d.plan_len(spec),
                                      dtype) + 1
    eng = engine.StencilEngine.for_shape("star2d3r", (37, 45), device="cpu",
                                         fused_steps=k, dtype="float64"
                                         if dtype == torch.float64 else "float32")
    x = eng.to_internal(reference.random_padded(spec, (37, 45), seed=3) * PI)
    depths = []

    def fake_launch(kind, buffers, spec_, layout, depth, bounds=None, **_):
        assert kind == "strip" and depth == 1
        assert buffers[0] is not buffers[1]
        depths.append(depth)
        stencil2d.stencil2d_step_plain(*buffers, spec_, layout, depth, bounds)

    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    donor = torch.zeros_like(x)
    got = stencil2d._split_pass("step", x, donor, spec, eng.layout, k)
    assert depths == [1] * k and got is donor
    want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, eng.layout, k)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.parametrize("steps", [3, 5])
def test_ragged_interior_with_a_remainder_pass(steps):
    interior = (37, 300)
    peng, jeng = engines("star2d3r", interior)
    g0 = reference.random_padded(peng.spec, interior, seed=24)
    agree(peng, jeng, g0 % 2, 3, exact=True)
    agree(peng, jeng, g0 * PI, steps, exact=False)


@pytest.mark.parametrize("name", ["star2d1r", "star2d3r", "box2d3r"])
def test_float64_fused_steps_match_jax_float64(name, x64):
    """dtype float64 with an explicit fused_steps reaches the same fused kernel
    in both packages (the JAX one under x64; the port's float64 instance)."""
    interior = (40, 200)
    peng, jeng = engines(name, interior, dtype="float64", fused_steps=2)
    assert peng.algorithm == "vpu_roll" and peng._fused_k() == 2
    g0 = reference.random_padded(peng.spec, interior, seed=25)
    got = peng.run(g0, 2)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), reference.run(g0, peng.spec, 2))
    assert np.array_equal(got.numpy(), np.asarray(jeng.run(g0, 2)))
    g1 = g0 * PI
    want = reference.run(g1, peng.spec, 4)
    got = peng.run(g1, 4).numpy()
    assert rel_err(got, want) <= 1e-14
    assert rel_err(got, np.asarray(jeng.run(g1, 4))) <= 1e-14


def test_fused_wrapper_equals_single_steps():
    """The fused twin's levels are single steps: bit for bit on any fill."""
    for name in SHAPES:
        spec = get_shape(name)
        for dtype in (torch.float32, torch.float64):
            eng = engine.StencilEngine.for_shape(name, (37, 150), device="cpu", fused_steps=4)
            x = eng.layout.to_internal(
                reference.random_padded(spec, (37, 150), seed=6) * PI, dtype)
            got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, eng.layout,
                                           fused_steps=4)
            want = x
            for _ in range(4):
                want = stencil2d.stencil2d_step(want, torch.zeros_like(x), spec,
                                                eng.layout)
            assert torch.equal(got, want)


FUSED_K_GRID = [
    dict(dtype=dtype, algorithm=alg, fused_steps=fs, fusion=fu)
    for dtype in ("float32", "float64", "df64")
    for alg in ("auto", "mxu_hybrid1", "vpu_roll", "vpu")
    for fs in (None, 0, 1, 2, 3, 50, 200)
    for fu in ("auto", "extent", "skew")
]


def _outcome(make):
    try:
        eng = make()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__
    return eng._fused_k(), eng._fusion_mode(), eng.layout.extra_row_tiles


@pytest.mark.parametrize("name", SHAPES)
def test_fused_k_matches_jax(name, x64):
    """The 2-D fused-depth rules, the 128 // radius clamp and the skew rule
    over a grid of configurations: the same k and fusion mode as the JAX
    engine, or the same exception type.  (The JAX skew layout's extra row
    tiles are its own; the port's layout needs none.)"""
    shape_grid = {"star2d1r": (40, 300), "star2d3r": (64, 256)}.get(name, (37, 150))
    for kw in FUSED_K_GRID:
        port = _outcome(lambda: engine.StencilEngine.for_shape(
            name, shape_grid, device="cpu", **kw))
        jax_ = _outcome(lambda: jax_engine.StencilEngine.for_shape(name, shape_grid, **kw))
        if isinstance(port, tuple):
            assert isinstance(jax_, tuple), (kw, port, jax_)
            assert port[:2] == jax_[:2] and port[2] == 0, (kw, port, jax_)
        else:
            assert port == jax_, (kw, port, jax_)
    eng = engine.StencilEngine.for_shape(name, shape_grid, device="cpu", fused_steps=200)
    assert eng._fused_k() == 128 // get_shape(name).radius == 42
    assert eng.layout.guard == (128, 128)


def test_residue_mxu_on_runs_the_same_kernel():
    """residue_mxu='on' moves the TPU kernel's residue onto its matrix unit;
    the port runs its one exact kernel, the same values as 'auto'."""
    interior = (40, 300)
    peng = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu",
                                          residue_mxu="on")
    jeng = jax_engine.StencilEngine.for_shape("star2d1r", interior, residue_mxu="on")
    g1 = reference.random_padded(peng.spec, interior, seed=26) * PI
    got = peng.run(g1, 4).numpy()
    assert rel_err(got, np.asarray(jeng.run(g1, 4))) <= 1e-5
    assert rel_err(got, reference.run(g1, peng.spec, 4)) <= 1e-5
    assert np.array_equal(got, engine.StencilEngine.for_shape(
        "star2d1r", interior, device="cpu").run(g1, 4).numpy())


def test_cli_fused_steps_reach_2d(capsys):
    assert cli.main(["star2d3r", "40", "300", "3", "--check", "--device", "cpu"]) == 0
    assert cli.main(["star2d1r", "40", "300", "5", "--check", "--device", "cpu",
                     "--fused-steps", "3", "--fill", "ones"]) == 0
    assert cli.main(["box2d3r", "33", "65", "4", "--check", "--device", "cpu",
                     "--dtype", "float64", "--fused-steps", "2"]) == 0
    assert capsys.readouterr().out.count("Correct!") == 3

