"""The port's sharded 1-D engines (``ShardedStencil1D``,
``ShardedStencilDF64_1D``) on meshes of CPU shards (``devices=["cpu"] * n``,
which run the kernels' plain twins), on the CPU:

* against the JAX sharded engines on their 8 virtual CPU devices (Pallas
  interpret mode), on the same input from a seed, in a few tiny cases:
  dirichlet0 over (3,), periodic at k = 2 over (4,), reflect with a tailed
  block, df64 and bfloat16; and the JAX ``lanes`` rule at a size where it
  picks the narrow kernel (the engines built, not run);
* against the fp64 ground truth and the port's single-device engine over
  meshes (1,), (3,) and (4,), the three boundaries, divisible and
  non-divisible interiors, k = 1-3, the overlapped, ring-out and sequential
  steps, float32, bf16 and df64, ``sharded_engine_for_coeffs``;
* the step the JAX rule chooses (and ring-out where the exchange depth passes
  the port's 2048-cell tile), and the refusals.

Tolerances, relative to the largest value of the ground truth: the 0..99
integer fill for 3 steps bit for bit against the single-device engine and
the JAX engine in float32 and df64 (every partial sum of 1d1r / 1d2r, whose
taps are integers, is an integer below 2**24, whatever the sum's order);
otherwise float32 1e-6, df64 1e-12 (the JAX engine's df64 pairs), bfloat16
1e-2 against JAX and 5e-2 against the ground truth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu.parallel import domain as jax_domain
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
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


def padded_input(spec, n, seed, boundary, integers=True):
    """The 0..99 integer fill (or a uniform [0, 0.01) one), with a random halo
    under dirichlet0 and a zero one under a ghost boundary."""
    rng = np.random.default_rng(seed)
    shape = spec.padded_shape((n,))
    g = rng.integers(0, 100, shape).astype(np.float64) if integers else \
        rng.uniform(0, 0.01, shape)
    if boundary != "dirichlet0":
        h = spec.halo[0]
        g[:h] = 0
        g[h + n:] = 0
    return g


def rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def port(name, n, mesh, **kw):
    spec = name if not isinstance(name, str) else get_shape(name)
    return domain.sharded_engine(spec, n, mesh, devices=["cpu"] * int(np.prod(mesh)), **kw)


def single_of(eng, name, n, boundary, dtype="float32"):
    """The single-device engine of the same spec, dtype, boundary and fused
    depth, on the kernel family the sharded engine runs: the narrow pass (or
    run) where ``lanes``, else the wide one."""
    spec = name if not isinstance(name, str) else get_shape(name)
    alg = "auto" if dtype == "df64" else "mxu" if eng.lanes else "vpu"
    cfg = engine.EngineConfig(dtype=dtype, boundary=boundary, fused_steps=eng.fused_steps,
                              algorithm=alg)
    return engine.StencilEngine(spec, (n,), cfg, device="cpu")


# -- against the JAX sharded engines ------------------------------------------
@pytest.mark.parametrize("name,n,mesh,kw", [
    ("1d2r", 3001, (3,), {}),
    ("1d1r", 5000, (4,), dict(fused_steps=2, boundary="periodic")),
    ("1d2r", 5001, (4,), dict(boundary="reflect")),
    ("1d2r", 4096, (4,), dict(dtype="df64", boundary="reflect")),
    ("1d2r", 3001, (3,), dict(dtype="bfloat16")),
])
def test_matches_the_jax_sharded_engine(name, n, mesh, kw):
    spec = get_shape(name)
    boundary = kw.get("boundary", "dirichlet0")
    dtype = kw.get("dtype", "float32")
    g0 = padded_input(spec, n, 21, boundary)
    jeng = jax_domain.sharded_engine(name, n, mesh, **kw)
    peng = port(name, n, mesh, **kw)
    assert peng.local_interior == jeng.local_interior and peng.tail == jeng.tail
    assert peng.depth == jeng.depth and peng.lanes == jeng.lanes
    assert peng.fused_steps == jeng.fused_steps
    got = peng.run(g0, 3)
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                         "df64": torch.float64}[dtype]
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
    halo = np.ones(got.shape, bool)
    halo[it] = False
    assert not got[halo].any()


@pytest.mark.parametrize("n,kw", [(600_000, {}), (600_000, dict(fused_steps=5)),
                                  (600_001, dict(boundary="periodic")),
                                  (600_000, dict(dtype="df64")), (100_000, {})])
def test_lanes_follows_the_jax_rule(n, kw):
    """``lanes`` (the narrow kernel) and the lanes depth, as the JAX engine
    sets them: a block beyond its flat kernel's whole-run size and no true
    tail inside it (engines built, not run)."""
    jeng = jax_domain.sharded_engine("1d2r", n, (4,), **kw)
    peng = port("1d2r", n, (4,), **kw)
    assert (peng.lanes, peng.fused_steps, peng.depth) == (jeng.lanes, jeng.fused_steps,
                                                          jeng.depth)


# -- against the ground truth and the single-device engine --------------------
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("mesh,n", [((1,), 24576), ((3,), 24576), ((4,), 24576),
                                    ((4,), 25001), ((3,), 7001)])
def test_matches_truth_and_single_device(mesh, n, boundary, k, overlap):
    name = "1d2r"
    spec = get_shape(name)
    g0 = padded_input(spec, n, 7, boundary)
    eng = port(name, n, mesh, fused_steps=k, boundary=boundary, overlap=overlap)
    single = single_of(eng, name, n, boundary)
    got = eng.run(g0, 3)
    assert torch.equal(got, single.run(g0, 3))
    it = reference.interior_slices(spec, g0.shape)
    assert rel(got.numpy()[it], TRUTH[boundary](g0, spec, 3)[it]) == 0.0


@pytest.mark.parametrize("name,n,mesh,kw,step", [
    ("1d2r", 24576, (4,), {}, "_local_step_overlap"),
    ("1d2r", 25001, (4,), dict(boundary="periodic"), "_local_step_overlap"),
    ("1d2r", 7001, (3,), {}, "_local_step_ringout"),
    ("1d2r", 24576, (1,), {}, "_local_step_ringout"),
    ("1d1r", 600_000, (4,), dict(fused_steps=3), "_local_step_overlap"),
])
def test_step_choice(name, n, mesh, kw, step):
    """The JAX engine's rule: the overlapped step where the local tile grid
    splits (>= 3 of the port's 2048-cell tiles, the edge strips inside the
    head and tail tiles) and there is more than one shard, else ring-out;
    the sequential step under overlap=False."""
    eng = port(name, n, mesh, **kw)
    assert eng._step_fn().__name__ == step
    assert port(name, n, mesh, overlap=False, **kw)._step_fn().__name__ == "_local_step"


def wide_taps(r):
    """A wide-radius 1-D spec whose steps neither grow nor decay much: taps
    0.2 at +-r, 0.3 beside the centre, 0.1 at the centre, -0.1 at r - 2."""
    taps = np.zeros(2 * r + 1)
    taps[0] = taps[-1] = 0.2
    taps[r - 1] = taps[r + 1] = 0.3
    taps[r] = 0.1
    taps[r - 2] = -0.1
    return taps


def test_depth_beyond_the_tile_takes_ring_out():
    """Where the exchange depth passes the port's tile (r = 40 at k = 64: 2560
    cells against 2048), the edge strips would reach the inner window: the
    step is ring-out, and its values equal the single-device engine's."""
    taps = wide_taps(40)
    n = 4 * 4 * 2048
    eng = domain.sharded_engine_for_coeffs(taps, n, (4,), fused_steps=64,
                                           devices=["cpu"] * 4)
    assert eng.depth == 2560 and not eng.lanes
    assert eng._overlap_reason() == "exchange depth exceeds the boundary tile"
    assert eng._step_fn().__name__ == "_local_step_ringout"
    g0 = reference.random_padded(eng.spec, (n,), seed=4)
    single = engine.StencilEngine(eng.spec, (n,), engine.EngineConfig(
        fused_steps=64, algorithm="vpu"), device="cpu")
    assert torch.equal(eng.run(g0, 70), single.run(g0, 70))


def test_lanes_engine_matches_single_device():
    """A block the JAX rule sends to the narrow kernel (1d2r 600,000 over 4:
    150,016 cells a shard), overlapped, k = 5 (the lanes clamp 32 // 4 = 8
    not reached): bit for bit the single-device narrow passes."""
    name, n = "1d2r", 600_000
    spec = get_shape(name)
    eng = port(name, n, (4,), fused_steps=5)
    assert eng.lanes and eng._step_fn().__name__ == "_local_step_overlap"
    g0 = padded_input(spec, n, 3, "dirichlet0", integers=False)
    single = single_of(eng, name, n, "dirichlet0")
    assert torch.equal(eng.run(g0, 7), single.run(g0, 7))


@pytest.mark.parametrize("dtype", ["bfloat16", "df64"])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("n", [24576, 25001])
def test_tiers_match_single_device(dtype, boundary, n):
    name = "1d1r"
    spec = get_shape(name)
    g0 = padded_input(spec, n, 9, boundary, integers=False)
    eng = port(name, n, (4,), dtype=dtype, boundary=boundary)
    single = single_of(eng, name, n, boundary, dtype)
    got = eng.run(g0, 3)
    it = reference.interior_slices(spec, g0.shape)
    truth = TRUTH[boundary](g0, spec, 3)
    if dtype == "df64" and eng.lanes != (single.path in ("lanes", "resident_lanes")):
        # a tailed ghost block runs the wide pass, the single engine the
        # narrow one: the sums differ in order only
        assert rel(got.numpy()[it], single.run(g0, 3).numpy()[it]) <= 1e-15
    else:
        assert torch.equal(got, single.run(g0, 3))
    assert rel(got.double().numpy()[it], truth[it]) <= (5e-2 if dtype == "bfloat16"
                                                       else 1e-13)


def test_for_coeffs_and_run_checksum():
    taps = np.array([0.25, -1.0, 1.5, 2.0, 1.5, -0.5, 0.125])
    n = 30_000
    eng = domain.sharded_engine_for_coeffs(taps, n, (4,), devices=["cpu"] * 4, fused_steps=3)
    assert eng._step_fn().__name__ == "_local_step_overlap"
    g0 = reference.random_padded(eng.spec, (n,), seed=44) * 1e-3
    got = eng.run(g0, 5)
    assert rel(got.numpy(), reference.run(g0, eng.spec, 5)) <= 1e-6
    single = engine.StencilEngine(eng.spec, (n,), engine.EngineConfig(
        fused_steps=3, algorithm="vpu"), device="cpu")
    assert torch.equal(got, single.run(g0, 5))
    state = eng._run(eng.to_sharded(g0), 5)
    assert eng.from_sharded(state).equal(got)
    want = sum(b.sum(dtype=torch.float64) for b in state.values())
    total = eng.run_checksum(g0, 5)
    assert total.dtype == torch.float64 and float(total) == float(want)


def test_refusals():
    with pytest.raises(ValueError, match="tail"):  # last tail 104 < depth 128
        port("1d2r", 3 * 512 + 104, (4,), fused_steps=32, boundary="periodic")
    with pytest.raises(ValueError, match="local block"):
        port("1d2r", 512, (4,), fused_steps=64)
    with pytest.raises(ValueError, match="fused_steps=1"):
        port("1d2r", 4096, (4,), dtype="df64", fused_steps=2)
    with pytest.raises(ValueError, match="'auto' or 'vpu_roll'"):
        port("1d2r", 4096, (4,), dtype="df64", algorithm="vpu")
    with pytest.raises(ValueError, match="effective radius in"):
        domain.sharded_engine_for_coeffs(np.array([0.0, 1.0, 0.0]), 4096, (4,), dtype="df64",
                                         devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="1-D spec"):
        domain.ShardedStencil1D(get_shape("star2d1r"), 4096,
                                domain.ShardedConfig(mesh_shape=(4,)), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="ShardedStencilDF64_1D"):
        domain.ShardedStencil1D(get_shape("1d2r"), 4096,
                                domain.ShardedConfig(mesh_shape=(4,), dtype="df64"),
                                devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        domain.sharded_engine("1d2r", 4096, (4,), devices=["cpu"] * 2)


def test_jax_refusals_agree():
    """The same configurations refused by both engines, with one message."""
    for args, kw, match in ((("1d2r", 3 * 512 + 104, (4,)),
                             dict(fused_steps=32, boundary="periodic"), "tail"),
                            (("1d2r", 4096, (4,)), dict(dtype="df64", fused_steps=2),
                             "fused_steps=1")):
        with pytest.raises(ValueError, match=match):
            jax_domain.sharded_engine(*args, **kw)
        with pytest.raises(ValueError, match=match):
            port(*args, **kw)


def test_overlapped_step_writes_the_ring_for_the_next_pass():
    """After an overlapped pass each shard's ring holds its neighbours' edge
    cells of that pass's output (zeros at a dirichlet0 global edge), as after
    the sequential exchange."""
    name, n = "1d2r", 24576
    eng = port(name, n, (4,))
    g0 = padded_input(get_shape(name), n, 5, "dirichlet0")
    state = eng.to_sharded(g0)
    out = eng._local_step_overlap(state, eng._zeros(state), 1)
    want = eng._exchange({c: b.clone() for c, b in out.items()})
    o, h = eng.layout.origin, eng.depth
    for c in out:
        assert torch.equal(out[c][o - h: o], want[c][o - h: o] * (c[0] > 0))
        hs = eng.tail if c[0] == 3 else eng.local_interior
        assert torch.equal(out[c][o + hs: o + hs + h],
                           want[c][o + hs: o + hs + h] * (c[0] < 3))
