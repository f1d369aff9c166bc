"""The port's sharded 2-D engines (``lorastencil_tpu_torch.parallel.domain``) on
meshes of CPU shards (``devices=["cpu"] * n``, which run the kernels' plain
twins), on the CPU:

* against the JAX sharded engines on their 8 virtual CPU devices (Pallas
  interpret mode), on the same input from a seed, in a few small cases: (2, 2)
  dirichlet0 with the overlapped exchange, (2, 1) periodic at k = 2, reflect, a
  non-divisible interior under a ghost boundary, df64 and bfloat16;
* against the fp64 ground truth and the port's single-device engine over mesh
  shapes (1, 1), (2, 1), (1, 2), (2, 2), (4, 2) and (3, 3), the three
  boundaries, k = 1-3 and the overlapped exchange on and off, and
  ``sharded_engine_for_coeffs``;
* the refusals, with the JAX engine's messages, and the CLI's ``--mesh``.

Tolerances, relative to the largest value of the ground truth: the 0..99
integer fill for 2 steps bit for bit against JAX in float32 and df64 (every
partial sum an integer below 2**24); otherwise float32 1e-6 (tests/
test_parallel.py's), df64 1e-13, bfloat16 1e-2 against JAX and 5e-2 against
the ground truth (the JAX engine rounds the state to bf16 through float32
first).  Against the port's single-device engine at the same fused depth:
bit for bit in every dtype (the same twin on the same cells, level for
level)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu.parallel import domain as jax_domain
from lorastencil_tpu_torch import cli, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.parallel import domain
from lorastencil_tpu_torch.utils import reference

TRUTH = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
         "reflect": reference.run_reflect}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the twins' small tensor ops: beside the
    suite's other workers, a parallel region per op oversubscribes the
    cores and runs each case ~50x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def padded_input(spec, interior, seed, boundary, integers=False):
    """A uniform [0, 0.01) fill (or 0..99 integers), with a random halo under
    dirichlet0 (the reference's first step reads it) and a zero one under a
    ghost boundary (which ignores it)."""
    rng = np.random.default_rng(seed)
    shape = spec.padded_shape(interior)
    g = rng.integers(0, 100, shape).astype(np.float64) if integers else \
        rng.uniform(0, 0.01, shape)
    if boundary != "dirichlet0":
        it = reference.interior_slices(spec, shape)
        ghost = np.zeros(shape)
        ghost[it] = g[it]
        g = ghost
    return g


def rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def port(name, interior, mesh, **kw):
    spec = name if not isinstance(name, str) else get_shape(name)
    return domain.sharded_engine(spec, interior, mesh, devices=["cpu"] * int(np.prod(mesh)),
                                 **kw)


# -- against the JAX sharded engines ------------------------------------------
@pytest.mark.parametrize("name,interior,mesh,kw,integers", [
    ("star2d1r", (48, 768), (2, 2), dict(tile=(8, 128), fused_steps=2), True),
    ("star2d3r", (32, 512), (2, 1), dict(tile=(8, 128), fused_steps=2,
                                         boundary="periodic"), True),
    ("box2d3r", (48, 768), (2, 2), dict(tile=(8, 128), boundary="reflect"), False),
    ("star2d1r", (100, 300), (2, 2), dict(boundary="periodic"), False),
    ("star2d1r", (48, 768), (2, 2), dict(tile=(8, 128), dtype="df64"), True),
    ("star2d1r", (32, 512), (2, 2), dict(tile=(8, 128), dtype="bfloat16",
                                         fused_steps=2), False),
])
def test_matches_the_jax_sharded_engine(name, interior, mesh, kw, integers):
    spec = get_shape(name)
    boundary = kw.get("boundary", "dirichlet0")
    dtype = kw.get("dtype", "float32")
    g0 = padded_input(spec, interior, 21, boundary, integers)
    steps = 2 if integers else 3
    jeng = jax_domain.sharded_engine(name, interior, mesh, **kw)
    peng = port(name, interior, mesh, **kw)
    assert peng.local_interior == jeng.local_interior
    assert peng.tails == jeng.tails and peng.depth == jeng.depth
    assert peng.algorithm == jeng.algorithm
    assert peng._can_overlap() == jeng._can_overlap()
    got = peng.run(g0, steps)
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                         "df64": torch.float64}[dtype]
    got = got.double().numpy()
    if dtype == "df64":
        want = np.asarray(jeng.run(g0, steps), np.float64)
    else:
        want = np.asarray(jeng.run(g0, steps).astype(jnp.float32), np.float64)
    truth = TRUTH[boundary](g0, spec, steps)
    it = reference.interior_slices(spec, g0.shape)
    if integers:
        assert np.array_equal(got, want)
    tol = {"float32": 1e-6, "df64": 1e-13, "bfloat16": 1e-2}[dtype]
    assert rel(got[it], want[it]) <= tol
    assert rel(got[it], truth[it]) <= (5e-2 if dtype == "bfloat16" else tol)
    halo = np.ones(got.shape, bool)
    halo[it] = False
    assert not got[halo].any()


# -- against the ground truth and the single-device engine --------------------
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (3, 3)]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("mesh", MESHES)
def test_matches_truth_and_single_device(mesh, boundary, k, overlap):
    name, interior = "star2d1r", (150, 700)
    spec = get_shape(name)
    g0 = padded_input(spec, interior, 7, boundary)
    eng = port(name, interior, mesh, fused_steps=k, boundary=boundary, overlap=overlap)
    single = engine.StencilEngine.for_shape(name, interior, device="cpu", fused_steps=k,
                                            boundary=boundary)
    it = reference.interior_slices(spec, g0.shape)
    for steps in (k, 2 * k + 1):
        got = eng.run(g0, steps)
        assert torch.equal(got, single.run(g0, steps))
        assert rel(got.numpy()[it], TRUTH[boundary](g0, spec, steps)[it]) <= 1e-6


@pytest.mark.parametrize("mesh,interior,tile,step", [
    ((2, 2), (192, 768), None, "_local_step_overlap"),
    ((2, 2), (192, 768), (8, 128), "_local_step_overlap"),
    ((3, 3), (60, 1000), None, "_local_step_ringout"),
    ((1, 1), (192, 768), None, "_local_step_ringout"),
])
def test_step_choice(mesh, interior, tile, step):
    """The JAX engine's rule: the overlapped step where the local tile grid
    splits and there is more than one shard, else the ring-out step; the
    sequential step under overlap=False."""
    eng = port("box2d3r", interior, mesh, tile=tile)
    assert eng._step_fn().__name__ == step
    off = port("box2d3r", interior, mesh, tile=tile, overlap=False)
    assert off._step_fn().__name__ == "_local_step"


@pytest.mark.parametrize("dtype", ["bfloat16", "df64"])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
def test_tiers_match_single_device(dtype, boundary):
    name, interior, mesh = "box2d3r", (192, 768), (2, 2)
    spec = get_shape(name)
    g0 = padded_input(spec, interior, 9, boundary)
    eng = port(name, interior, mesh, dtype=dtype, boundary=boundary)
    single = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype=dtype,
                                            fused_steps=1, boundary=boundary)
    it = reference.interior_slices(spec, g0.shape)
    got = eng.run(g0, 3)
    assert torch.equal(got, single.run(g0, 3))
    assert rel(got.double().numpy()[it], TRUTH[boundary](g0, spec, 3)[it]) <= (
        5e-2 if dtype == "bfloat16" else 1e-13)


def test_deep_pass_runs_one_launch_a_pass():
    """A pass deeper than one launch of the kernel runs as passes of one
    launch, each with its exchange, and takes the ring-out step."""
    spec = get_shape("star2d1r")
    from lorastencil_tpu_torch.ops import stencil2d

    k = stencil2d.launch_depths("step", spec, torch.float32, 1000)[0] + 1
    interior = (384, 768)  # local (192, 384): 3 x 3 tiles of (64, 128)
    eng = port("star2d1r", interior, (2, 2), fused_steps=k, tile=(64, 128))
    assert "launches" in eng._overlap_reason()
    assert eng._step_fn().__name__ == "_local_step_ringout"
    g0 = padded_input(spec, interior, 3, "dirichlet0")
    single = engine.StencilEngine.for_shape("star2d1r", interior, device="cpu",
                                            fused_steps=k)
    assert torch.equal(eng.run(g0, k + 1), single.run(g0, k + 1))


def test_for_coeffs_and_run_checksum():
    S = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0
    S[0, 2] += 0.125
    interior = (96, 512)
    eng = domain.sharded_engine_for_coeffs(S, interior, (2, 2), devices=["cpu"] * 4,
                                           fused_steps=2)
    g0 = reference.random_padded(eng.spec, interior, seed=44)
    got = eng.run(g0, 5)
    assert rel(got.numpy(), reference.run(g0, eng.spec, 5)) <= 1e-6
    single = engine.StencilEngine(eng.spec, interior, engine.EngineConfig(fused_steps=2),
                                  device="cpu")
    assert torch.equal(got, single.run(g0, 5))
    state = eng._run(eng.to_sharded(g0), 5)
    assert eng.from_sharded(state).equal(got)
    want = sum(b.sum(dtype=torch.float64) for b in state.values())
    assert float(eng.run_checksum(g0, 5)) == float(want)


def test_to_and_from_sharded_round_trip():
    spec = get_shape("star2d1r")
    interior = (100, 300)
    g0 = padded_input(spec, interior, 1, "dirichlet0")
    eng = port("star2d1r", interior, (3, 3))
    state = eng.to_sharded(g0)
    assert sorted(state) == eng.mesh.coords()
    back = eng.from_sharded(state).numpy()
    it = reference.interior_slices(spec, g0.shape)
    assert np.array_equal(back[it], np.float32(g0[it]))
    assert not back[~np.isin(np.arange(back.size).reshape(back.shape),
                             np.arange(back.size).reshape(back.shape)[it])].any()


# -- refusals -----------------------------------------------------------------
def test_refusals():
    with pytest.raises(ValueError, match="tail"):  # last tail 4 < depth 6
        port("star2d1r", (100, 300), (4, 1), fused_steps=2, boundary="periodic")
    S = np.array([[0.0, 0.5, -0.25], [1.0, 2.0, 0.0], [0.0, -0.5, 0.125]])
    with pytest.raises(ValueError, match="symmetric"):
        domain.sharded_engine_for_coeffs(S, (32, 512), (2, 2), halo=(1, 1), fused_steps=2,
                                         boundary="reflect", devices=["cpu"] * 4)
    for kw, match in ((dict(dtype="float64"), "sharded dtype"),
                      (dict(boundary="wrap"), "sharded boundary"),
                      (dict(precision="higest"), "precision"),
                      (dict(interpret=True), "interpret")):
        with pytest.raises(ValueError, match=match):
            domain.ShardedConfig(mesh_shape=(2, 2), **kw)
    with pytest.raises(ValueError, match="fused_steps=1"):
        port("star2d1r", (64, 512), (2, 2), dtype="df64", fused_steps=2)
    with pytest.raises(ValueError, match="local block"):
        port("star2d1r", (64, 512), (8, 1), fused_steps=4)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        domain.sharded_engine("star2d1r", (64, 512), (4, 2), devices=["cpu"] * 4)
    # the 1-D and 3-D engines, once refused naming A11(b) and A11(c), build
    assert type(port("1d2r", (4096,), (4,))).__name__ == "ShardedStencil1D"
    assert type(port("star3d1r", (8, 32, 256), (2, 2))).__name__ == "ShardedStencil3D"
    with pytest.raises(NotImplementedError, match="B13"):
        port("star2d1r", (64, 512), (2, 2), algorithm="mxu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            domain.make_mesh((2, 2))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            domain.make_mesh((2, 1), ["cuda:0"] * 2)


def test_jax_refusals_agree():
    """The same configurations refused by both engines, with one message."""
    for args, kw, match in ((("star2d1r", (100, 300), (4, 1)),
                             dict(fused_steps=2, boundary="periodic"), "tail"),
                            (("star2d1r", (64, 512), (2, 2)),
                             dict(dtype="df64", fused_steps=2), "fused_steps=1")):
        with pytest.raises(ValueError, match=match):
            jax_domain.sharded_engine(*args, **kw)
        with pytest.raises(ValueError, match=match):
            port(*args, **kw)


# -- the CLI's --mesh -----------------------------------------------------------
@pytest.mark.parametrize("extra", [[], ["--no-overlap"], ["--dtype", "df64"],
                                   ["--boundary", "periodic", "--fused-steps", "2"],
                                   ["--dtype", "bfloat16"]])
def test_cli_mesh_check_passes_on_cpu(extra, capsys):
    assert cli.main(["box2d3r", "100", "400", "3", "--mesh", "2", "2", "--device", "cpu",
                     "--check", *extra]) == 0
    out = capsys.readouterr().out
    assert "INFO: mesh = (2, 2), local interior = (56, 256), overlapped exchange = " in out
    assert "Correct!" in out


@pytest.mark.parametrize("argv,match", [
    (["1d2r", "4096", "2", "--mesh", "2", "--device", "cpu"], r"ROADMAP A11\(b\)"),
    (["star3d1r", "8", "32", "256", "2", "--mesh", "2", "2", "--device", "cpu"],
     r"ROADMAP A11\(c\)"),
    (["star2d1r", "64", "512", "2", "--mesh", "2", "2", "2", "--device", "cpu"],
     "needs 2 integer"),
    (["star2d1r", "64", "512", "2", "--mesh", "2", "2", "--device", "cpu", "--dtype",
      "float64"], "float32/bfloat16/df64"),
    (["star2d1r", "64", "512", "2", "--mesh", "2", "2", "--device", "cpu", "--autotune"],
     "--autotune tunes the single-chip engine"),
])
def test_cli_mesh_refusals(argv, match, capsys):
    """What ``--mesh`` refuses, by the JAX CLI's messages.  1-D and 3-D
    shapes, once refused naming A11(b) and A11(c), are ported: they run, and
    ``--check`` holds them to the ground truth."""
    if match.startswith("ROADMAP A11"):
        assert cli.main(argv + ["--check"]) == 0
        assert "Correct!" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert __import__("re").search(match, capsys.readouterr().err)


def test_cli_mesh_needs_a_card_per_shard(capsys):
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards are present: the mesh would run on them")
    with pytest.raises(SystemExit):
        cli.main(["star2d1r", "64", "512", "2", "--mesh", "2", "2"])
    assert "needs 4 devices, have" in capsys.readouterr().err
