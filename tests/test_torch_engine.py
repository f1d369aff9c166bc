"""The port's slice end to end on the CPU: lorastencil_tpu_torch's StencilEngine
(device="cpu", which runs the CUDA kernel's plain twin) against the JAX engine
(Pallas interpret mode) and the fp64 ground truth, plus the port's CLI.

Tolerances: with the integer fill every partial sum of steps 1-2 is an integer
below 2**24, so all three agree bit for bit.  With the pi/100 fill the two
packages sum symmetric tap pairs in different orders, so they agree to fp32
rounding: rel <= 1e-6 of the grid's largest value after 4 steps."""

import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models.shapes import get_shape as jax_get_shape
from lorastencil_tpu_torch import cli, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.utils import reference

SHAPES = ["star2d1r", "box2d1r", "box2d3r"]


@pytest.mark.parametrize("interior", [(64, 256), (40, 300)])
@pytest.mark.parametrize("name", SHAPES)
def test_engine_matches_jax_engine_and_reference(name, interior):
    spec = get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=21)
    jeng = jax_engine.StencilEngine.for_shape(name, interior)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu")
    assert peng.algorithm == jeng.algorithm == "mxu_hybrid1"
    for steps in (1, 2):  # exact: integers below 2**24
        got = peng.run(g0, steps)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        got = got.numpy()
        assert np.array_equal(got, np.asarray(jeng.run(g0, steps)))
        assert np.array_equal(got, reference.run(g0, spec, steps))
    g1 = g0 * (np.pi / 100)
    want = reference.run(g1, spec, 4)
    scale = np.abs(want).max()
    got = peng.run(g1, 4).numpy()
    assert np.abs(got - want).max() <= 1e-6 * scale
    assert np.abs(got - np.asarray(jeng.run(g1, 4))).max() <= 1e-6 * scale
    s = float(peng.run_checksum(g1, 4))
    assert abs(s - want.sum()) <= 1e-6 * np.abs(want).sum()
    assert abs(s - float(jeng.run_checksum(g1, 4))) <= 1e-6 * np.abs(want).sum()


@pytest.mark.parametrize("algorithm", ["mxu_hybrid1", "vpu_roll", "vpu"])
def test_backends_and_algorithms_agree(algorithm):
    """Every accepted algorithm name and the 'xla' backend compute the same
    steps; star2d3r runs on 'xla', where the JAX engine's fused depth is 1."""
    g0 = reference.random_padded(get_shape("star2d1r"), (30, 70), seed=1)
    want = reference.run(g0, get_shape("star2d1r"), 2)
    for backend in ("auto", "pallas", "xla"):
        eng = engine.StencilEngine.for_shape("star2d1r", (30, 70), device="cpu",
                                             algorithm=algorithm, backend=backend)
        assert np.array_equal(eng.run(g0, 2).numpy(), want)
    xla = engine.StencilEngine.for_shape("star2d3r", (30, 70), device="cpu", backend="xla")
    assert np.array_equal(xla.run(g0, 2).numpy(), reference.run(g0, get_shape("star2d3r"), 2))


def test_run_keeps_input_and_decays_halo():
    spec = get_shape("star2d1r")
    interior = (37, 45)  # the (32, 128) tile divides neither axis
    eng = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu")
    g0 = reference.random_padded(spec, interior, seed=8) + 1.0  # nonzero halo
    keep = g0.copy()
    t0 = torch.from_numpy(g0.astype(np.float32))
    t_keep = t0.clone()
    for src in (g0, t0):
        out = eng.run(src, 3)
        halo = np.ones(out.shape, dtype=bool)
        halo[4:-4, 4:-4] = False
        assert np.all(out.numpy()[halo] == 0)
        assert np.all(out.numpy()[~halo] != 0)
    assert np.array_equal(g0, keep) and torch.equal(t0, t_keep)
    state = eng.to_internal(g0)
    before = state.clone()
    eng.run_internal(state, 3)
    assert torch.equal(state, before)
    assert torch.equal(eng.run(g0, 0), t0)


def test_launches_count_only_kernel_launches():
    eng = engine.StencilEngine.for_shape("box2d1r", (16, 16), device="cpu")
    before = stencil2d.stencil2d_step.launches
    eng.run(reference.random_padded(eng.spec, (16, 16)), 3)
    assert stencil2d.stencil2d_step.launches == before  # CPU: the plain twin


@pytest.mark.parametrize("name,kw,item", [
    ("star2d3r", {"algorithm": "mxu"}, "B13"),
    ("star2d1r", {"algorithm": "mxu_hybrid3"}, "B13"),
    ("star2d1r", {"algorithm": "mxu_split"}, "B13"),
])
def test_unsupported_configs_name_their_roadmap_item(name, kw, item):
    interior = {1: (256,), 2: (16, 16), 3: (8, 16, 16)}[get_shape(name).ndim]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        engine.StencilEngine.for_shape(name, interior, device="cpu", **kw)


@pytest.mark.parametrize("name,kw", [
    ("star2d1r", {"dtype": "bfloat16"}),
    ("star2d1r", {"fusion": "skew", "dtype": "bfloat16"}),
    ("box2d3r", {"residue_mxu": "on", "dtype": "bfloat16"}),
    ("box3d1r", {"dtype": "bfloat16"}),
    ("1d2r", {"dtype": "bfloat16"}),
])
def test_bf16_configs_now_run(name, kw):
    """The bfloat16 configs these were refused with (ROADMAP A6(c)) run, in
    2-D, 3-D and 1-D, within the JAX tier's 5e-2 of the fp64 ground truth
    after 4 steps (tests/test_torch_bf16_*.py hold them against the JAX
    engine)."""
    spec = get_shape(name)
    interior = {1: (256,), 2: (16, 16), 3: (8, 16, 16)}[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=5)
    eng = engine.StencilEngine.for_shape(name, interior, device="cpu", **kw)
    got = eng.run(g0, 4)
    assert got.dtype == torch.bfloat16
    want = reference.run(g0, spec, 4)
    assert np.abs(got.double().numpy() - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("name,kw", [
    ("star2d1r", {"dtype": "float64", "boundary": "periodic"}),
    ("star3d1r", {"boundary": "periodic"}),
    ("star2d1r", {"boundary": "periodic"}),
    ("star2d1r", {"boundary": "reflect"}),
    ("box3d1r", {"dtype": "df64", "boundary": "reflect"}),
])
def test_ghost_configs_now_run(name, kw):
    """The ghost boundaries these configs were refused with (ROADMAP A6)
    run, against the port's fp64 ground truth of the mode: rel 1e-6 in
    float32, 1e-13 in the fp64-grade tier (tests/test_torch_boundary*.py
    hold them against the JAX engine)."""
    spec = get_shape(name)
    interior = {2: (16, 16), 3: (8, 16, 16)}[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=5)
    truth = (reference.run_periodic if kw["boundary"] == "periodic"
             else reference.run_reflect)
    want = truth(g0, spec, 3)
    got = engine.StencilEngine.for_shape(name, interior, device="cpu", **kw).run(g0, 3)
    tol = 1e-6 if kw.get("dtype", "float32") == "float32" else 1e-13
    assert np.abs(got.numpy().astype(np.float64) - want).max() <= tol * np.abs(want).max()


def test_unported_entry_points_and_bad_values_raise():
    eng = engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cpu")
    # for_coeffs in 2-D and 3-D and autodiff are ported (ROADMAP A6(b), A10)
    assert eng.adjoint().spec == eng.spec.flipped()
    assert engine.StencilEngine.for_coeffs(np.ones((3, 3)), (16, 16), device="cpu").spec.ndim == 2
    # the 2-D bf16 tier is ported (ROADMAP A6(c)), on the kernels only
    for eng in (engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cpu",
                                               dtype="bfloat16"),
                engine.StencilEngine.for_coeffs(np.ones((3, 3)), (16, 16), device="cpu",
                                                dtype="bfloat16")):
        assert eng.run(np.zeros((24, 24) if eng.spec.halo == (4, 4) else (18, 18)),
                       1).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cpu", dtype="bfloat16",
                                       backend="xla")
    with pytest.raises(ValueError, match="run_diff"):
        engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cpu",
                                       dtype="df64").run_diff(np.zeros((24, 24)), 1)
    for kw in ({"dtype": "float16"}, {"backend": "triton"}, {"boundary": "open"},
               {"algorithm": "fast"}, {"fusion": "time"}, {"interpret": True},
               {"precision": "low"}):
        with pytest.raises(ValueError):
            engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cpu", **kw)
    with pytest.raises(ValueError):
        engine.StencilEngine.for_shape("star2d1r", (16, 16), device="meta")


def test_resolve_algorithm_matches_jax():
    for name in ["1d1r", "1d2r", "star2d1r", "star2d3r", "box2d1r", "box2d3r", "star3d1r",
                 "box3d1r"]:
        for alg in ("auto", "vpu", "mxu_hybrid1"):
            assert (engine.resolve_algorithm(get_shape(name), alg)
                    == jax_engine.resolve_algorithm(jax_get_shape(name), alg))


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.StencilEngine.for_shape("star2d1r", (16, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cuda")


def test_cli_check_passes_on_cpu(capsys):
    assert cli.main(["star2d1r", "40", "300", "3", "--check", "--device", "cpu",
                     "--tile", "16", "64"]) == 0
    assert "Correct!" in capsys.readouterr().out
    assert cli.main(["box2d1r", "33", "65", "2", "--check", "--device", "cpu",
                     "--fill", "index", "--backend", "xla"]) == 0


@pytest.mark.parametrize("argv,item", [
    (["1d2r", "4096", "2", "--device", "cpu", "--mesh", "2"], "A11"),
    (["star3d1r", "8", "32", "32", "2", "--device", "cpu", "--mesh", "2", "2"], "A11"),
    (["star2d1r", "32", "32", "2", "--device", "cpu", "--autotune"], "A12"),
])
def test_cli_refuses_unported_flags(argv, item, capsys):
    """A flag the port does not run yet is refused naming its ROADMAP item.
    ``--mesh`` for 1-D and 3-D shapes, once refused naming A11, is ported:
    those flags now run, and ``--check`` holds them to the ground truth."""
    if item == "A11":
        assert cli.main(argv + ["--check"]) == 0
        out = capsys.readouterr()
        assert "Correct!" in out.out and "ROADMAP" not in out.err
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", ["float32", "df64"])
@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_cli_boundary_check_passes_on_cpu(boundary, dtype, capsys):
    """--boundary, once refused (ROADMAP A6), runs and --check holds it to
    the mode's ground truth (run_periodic / run_reflect)."""
    assert cli.main(["star3d1r", "8", "16", "16", "2", "--device", "cpu", "--dtype", dtype,
                     "--boundary", boundary, "--check"]) == 0
    assert "Correct!" in capsys.readouterr().out


@pytest.mark.parametrize("shape", ["star2d1r", "star2d3r", "1d1r", "1d2r", "star3d1r",
                                   "box3d1r"])
def test_cli_bf16_check_passes_on_cpu(shape, capsys):
    """--dtype bfloat16, once refused (ROADMAP A6(c)), runs in 1-D, 2-D and
    3-D and --check holds it to the JAX CLI's bf16 tolerance, 2e-2 of the
    ground truth."""
    sizes = {1: ["3001"], 2: ["40", "300"], 3: ["8", "16", "40"]}[get_shape(shape).ndim]
    assert cli.main([shape, *sizes, "3", "--device", "cpu", "--dtype", "bfloat16",
                     "--check"]) == 0
    assert "Correct!" in capsys.readouterr().out
