"""The port's sharded 3-D engines (``ShardedStencil3D``,
``ShardedStencilDF64_3D``) on meshes of CPU shards (``devices=["cpu"] * n``,
which run the kernels' plain twins), on the CPU:

* against the JAX sharded engines on their 8 virtual CPU devices (Pallas
  interpret mode), on the same input from a seed, in a few tiny cases: a
  (2, 2) plane mesh at k = 2, the (2, 2, 2) z-sharded mesh under periodic and
  (non-divisible) reflect, df64 and bfloat16, and the overlapped step's choice
  with the same explicit tile;
* against the fp64 ground truth and the port's single-device engine over
  meshes (1, 1), (2, 2), (3, 1) and (2, 2, 2), the three boundaries,
  divisible and non-divisible interiors, k = 1 and 2, the overlapped, ring-out
  and sequential steps (the z ghost refreshed locally before the frame
  launches of an unsharded z), float32, bf16 and df64, a pass the general
  kernel splits into launches, ``sharded_engine_for_coeffs``;
* the step the JAX rule chooses and the refusals, with the JAX messages.

Tolerances, relative to the largest value of the ground truth: the 0..99
integer fill for 3 steps bit for bit against the single-device engine and the
JAX engine in float32 and df64 (every partial sum of star3d1r / box3d1r is an
integer below 2**24); otherwise float32 1e-6, df64 1e-12, bfloat16 1e-2
against JAX and 5e-2 against the ground truth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu.parallel import domain as jax_domain
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil3d
from lorastencil_tpu_torch.parallel import domain
from lorastencil_tpu_torch.utils import reference

TRUTH = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
         "reflect": reference.run_reflect}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the twins' small tensor ops (see
    tests/test_torch_sharded2d.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def padded_input(spec, interior, seed, boundary, integers=True):
    """The 0..99 integer fill (or a uniform [0, 0.01) one), with a random halo
    under dirichlet0 and a zero one under a ghost boundary."""
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


def single_of(eng, interior, boundary, dtype="float32"):
    """The single-device engine of the same spec, dtype, boundary and depth."""
    cfg = engine.EngineConfig(dtype=dtype, boundary=boundary,
                              fused_steps_3d=eng.fused_steps)
    return engine.StencilEngine(eng.spec, interior, cfg, device="cpu")


def check_halo(got, spec):
    it = reference.interior_slices(spec, got.shape)
    halo = np.ones(got.shape, bool)
    halo[it] = False
    assert not got[halo].any()


# -- against the JAX sharded engines ------------------------------------------
@pytest.mark.parametrize("name,interior,mesh,kw", [
    ("star3d1r", (4, 16, 256), (2, 2), dict(tile=(8, 128), fused_steps=2)),
    ("star3d1r", (8, 16, 256), (2, 2, 2), dict(tile=(8, 128), boundary="periodic")),
    ("box3d1r", (7, 20, 200), (2, 2, 2), dict(boundary="reflect")),
    ("box3d1r", (8, 32, 256), (2, 2, 2), dict(dtype="df64")),
    ("star3d1r", (4, 16, 256), (2, 2), dict(tile=(8, 128), dtype="bfloat16")),
])
def test_matches_the_jax_sharded_engine(name, interior, mesh, kw):
    spec = get_shape(name)
    boundary = kw.get("boundary", "dirichlet0")
    dtype = kw.get("dtype", "float32")
    g0 = padded_input(spec, interior, 21, boundary)
    jeng = jax_domain.sharded_engine(name, interior, mesh, **kw)
    peng = port(name, interior, mesh, **kw)
    assert (peng.dz, peng.dxy, peng.tails, peng.ztail) == (jeng.dz, jeng.dxy, jeng.tails,
                                                           jeng.ztail)
    assert (peng.depth, peng.zdepth, peng.fused_steps) == (jeng.depth, jeng.zdepth,
                                                           jeng.fused_steps)
    if "tile" in kw:
        assert peng.local_interior == jeng.local_interior
    got = peng.run(g0, 3)
    got = got.double().numpy()
    if dtype == "df64":
        want = np.asarray(jeng.run(g0, 3), np.float64)
    else:
        want = np.asarray(jeng.run(g0, 3).astype(jnp.float32), np.float64)
    truth = TRUTH[boundary](g0, spec, 3)
    it = reference.interior_slices(spec, g0.shape)
    if dtype != "bfloat16":
        assert np.array_equal(got[it], want[it])
    assert rel(got[it], want[it]) <= (1e-2 if dtype == "bfloat16" else 1e-12)
    assert rel(got[it], truth[it]) <= (5e-2 if dtype == "bfloat16" else 1e-12)
    check_halo(got, spec)


@pytest.mark.parametrize("interior,mesh,kw", [
    ((6, 48, 768), (2, 2), {}), ((6, 48, 768), (2, 2, 2), dict(boundary="periodic")),
    ((6, 40, 700), (2, 2), dict(boundary="reflect")), ((6, 16, 256), (2, 2), {}),
])
def test_overlap_choice_agrees_with_the_same_tile(interior, mesh, kw):
    """With the same explicit tile both engines split the same tile grid and
    choose the same step (engines built, not run)."""
    jeng = jax_domain.sharded_engine("star3d1r", interior, mesh, tile=(8, 128), **kw)
    peng = port("star3d1r", interior, mesh, tile=(8, 128), **kw)
    assert peng.local_interior == jeng.local_interior
    assert peng._can_overlap() == jeng._can_overlap()
    assert peng._overlap_reason() == jeng._overlap_reason()


# -- against the ground truth and the single-device engine --------------------
CASES = [((1, 1), (6, 96, 384)), ((2, 2), (6, 96, 512)), ((3, 1), (6, 96, 384)),
         ((2, 2, 2), (8, 96, 384)), ((2, 2), (7, 90, 380)), ((2, 2, 2), (9, 70, 300))]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("mesh,interior", CASES)
def test_matches_truth_and_single_device(mesh, interior, boundary, k, overlap):
    name = "box3d1r" if k == 1 else "star3d1r"
    spec = get_shape(name)
    g0 = padded_input(spec, interior, 7, boundary)
    eng = port(name, interior, mesh, fused_steps=k, boundary=boundary, overlap=overlap,
               tile=(8, 64))
    got = eng.run(g0, 3)
    assert torch.equal(got, single_of(eng, interior, boundary).run(g0, 3))
    it = reference.interior_slices(spec, g0.shape)
    assert rel(got.numpy()[it], TRUTH[boundary](g0, spec, 3)[it]) == 0.0
    check_halo(got.numpy(), spec)


@pytest.mark.parametrize("mesh,interior,kw,step", [
    ((2, 2), (6, 96, 512), dict(tile=(8, 64)), "_local_step_overlap"),
    ((2, 2), (6, 96, 512), dict(tile=(8, 64), boundary="periodic"), "_local_step_overlap"),
    ((3, 1), (6, 96, 384), dict(tile=(8, 64), boundary="reflect", fused_steps=2),
     "_local_step_overlap"),
    ((2, 2, 2), (8, 96, 384), dict(tile=(8, 64)), "_local_step_ringout"),
    ((1, 1), (6, 96, 384), dict(tile=(8, 64)), "_local_step_ringout"),
    ((2, 2), (6, 64, 256), {}, "_local_step_ringout"),
])
def test_step_choice(mesh, interior, kw, step):
    """The JAX engine's rule: the overlapped step where the local tile grid
    splits 3 x 3 and there is more than one shard, never on a z-sharded mesh;
    the sequential step under overlap=False."""
    eng = port("star3d1r", interior, mesh, **kw)
    assert eng._step_fn().__name__ == step
    assert port("star3d1r", interior, mesh, overlap=False,
                **kw)._step_fn().__name__ == "_local_step"


def dense5():
    """A dense random 5 x 5 x 5 spec whose general-kernel pass of 3 levels
    takes two launches (tests/test_torch_region3d.py)."""
    rng = np.random.default_rng(0)
    rng.integers(1, 4, 33)
    S = rng.integers(1, 4, (5, 5, 5)).astype(np.float64) / 64.0
    return engine.StencilEngine.for_coeffs(S, (8, 64, 256), device="cpu").spec


def test_split_pass_runs_one_launch_a_pass():
    """A pass the general kernel's shared memory splits (3 levels: 2 + 1)
    runs as passes of one launch, each with its exchange, and takes the
    ring-out step; the values are the single-device engine's."""
    spec = dense5()
    interior = (8, 96, 512)
    eng = port(spec, interior, (2, 2), fused_steps=3, tile=(8, 64))
    assert stencil3d.launch_depths(spec, torch.float32, 3) == [2, 1]
    assert "launches" in eng._overlap_reason()
    assert eng._step_fn().__name__ == "_local_step_ringout"
    g0 = reference.random_padded(spec, interior, seed=3)
    single = single_of(eng, interior, "dirichlet0")
    assert torch.equal(eng.run(g0, 4), single.run(g0, 4))


@pytest.mark.parametrize("dtype", ["bfloat16", "df64"])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("mesh", [(2, 2), (2, 2, 2)])
def test_tiers_match_single_device(dtype, boundary, mesh):
    name, interior = "box3d1r", (8, 96, 512)
    spec = get_shape(name)
    g0 = padded_input(spec, interior, 9, boundary, integers=False)
    eng = port(name, interior, mesh, dtype=dtype, boundary=boundary, tile=(8, 64))
    got = eng.run(g0, 3)
    assert torch.equal(got, single_of(eng, interior, boundary, dtype).run(g0, 3))
    it = reference.interior_slices(spec, g0.shape)
    assert rel(got.double().numpy()[it], TRUTH[boundary](g0, spec, 3)[it]) <= (
        5e-2 if dtype == "bfloat16" else 1e-13)


def test_for_coeffs_mxu_and_run_checksum():
    """A 3-D ``for_coeffs`` spec over a z-sharded mesh, the JAX names
    ('mxu' too) on the exact kernel, and ``run_checksum``."""
    u = np.array([0.25, 0.5, 0.25])
    S = np.einsum("i,j,k->ijk", u, u, u)
    S[1, 1, 2] += 0.125
    interior = (8, 40, 150)
    for alg in ("auto", "vpu_roll", "mxu_hybrid1", "mxu"):
        eng = domain.sharded_engine_for_coeffs(S, interior, (2, 2, 2), devices=["cpu"] * 8,
                                               algorithm=alg)
        g0 = reference.random_padded(eng.spec, interior, seed=44)
        got = eng.run(g0, 3)
        assert rel(got.numpy(), reference.run(g0, eng.spec, 3)) <= 1e-6
        assert torch.equal(got, single_of(eng, interior, "dirichlet0").run(g0, 3))
    state = eng._run(eng.to_sharded(g0), 3)
    want = sum(b.sum(dtype=torch.float64) for b in state.values())
    assert float(eng.run_checksum(g0, 3)) == float(want)


def test_refusals():
    with pytest.raises(ValueError, match="z exchange depth"):
        port("star3d1r", (4, 16, 256), (4, 2, 1), fused_steps=2)
    with pytest.raises(ValueError, match="window guard"):
        port("star3d1r", (8, 96, 384), (2, 2), fused_steps=9)
    with pytest.raises(ValueError, match="tail"):  # the last z shard: 1 plane
        port("star3d1r", (5, 16, 256), (3, 1, 1), boundary="reflect", fused_steps=2)
    with pytest.raises(ValueError, match="tail"):
        port("star3d1r", (8, 17, 300), (2, 2), fused_steps=2, boundary="periodic",
             tile=(8, 128))
    with pytest.raises(ValueError, match="fused_steps=1"):
        port("box3d1r", (8, 32, 256), (2, 2), dtype="df64", fused_steps=2)
    with pytest.raises(ValueError, match="separable"):
        port("box3d1r", (8, 32, 256), (2, 2), dtype="df64", algorithm="vpu")
    with pytest.raises(ValueError, match="no 3-D path"):
        port("box3d1r", (8, 32, 256), (2, 2), algorithm="mxu_hybrid")
    with pytest.raises(ValueError, match="3-D mesh"):
        port("box3d1r", (8, 32, 256), (2,))
    with pytest.raises(ValueError, match="ShardedStencilDF64_3D"):
        domain.ShardedStencil3D(get_shape("box3d1r"), (8, 32, 256),
                                domain.ShardedConfig(mesh_shape=(2, 2), dtype="df64"),
                                devices=["cpu"] * 4)


def test_jax_refusals_agree():
    """The same configurations refused by both engines: the JAX engine
    asserts where the port raises ``ValueError`` with its message."""
    for args, kw, match in ((("star3d1r", (4, 16, 256), (4, 2, 1)), dict(fused_steps=2),
                             "z exchange depth"),
                            (("star3d1r", (8, 96, 384), (2, 2)), dict(fused_steps=9),
                             "window guard"),
                            (("box3d1r", (8, 32, 256), (2, 2)),
                             dict(dtype="df64", fused_steps=2), "fused_steps=1")):
        with pytest.raises((ValueError, AssertionError), match=match):
            jax_domain.sharded_engine(*args, **kw)
        with pytest.raises(ValueError, match=match):
            port(*args, **kw)


def test_z_ghost_before_the_frame_launches():
    """An unsharded z under a ghost boundary refreshes the z guard planes of
    the input before the frame windows run, and the result's z guard is
    cleared (the halo is zero after a step)."""
    name, interior = "star3d1r", (6, 96, 512)
    spec = get_shape(name)
    for boundary in ("periodic", "reflect"):
        eng = port(name, interior, (2, 2), boundary=boundary, tile=(8, 64))
        assert eng._step_fn().__name__ == "_local_step_overlap"
        g0 = padded_input(spec, interior, 11, boundary)
        state = eng.to_sharded(g0)
        out = eng._run(state, 1)
        z0, h, d = eng.layout.origin[0], interior[0], eng.zdepth
        for c, b in state.items():
            want = b[z0 + h - d: z0 + h] if boundary == "periodic" else b[z0: z0 + d].flip(0)
            assert torch.equal(b[z0 - d: z0], want)
        for b in out.values():
            assert not b[z0 - d: z0].any() and not b[z0 + h: z0 + h + d].any()
