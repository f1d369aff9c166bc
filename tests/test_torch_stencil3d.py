"""The port's 3-D path on the CPU: its kernel module (lorastencil_tpu_torch.ops.
stencil3d, whose wrapper runs the CUDA kernel's plain twin on a CPU tensor), its
layout, reference steps and state conversion against the JAX package, and the
engine against the JAX engine (Pallas interpret mode) for star3d1r.  box3d1r's
engine cases are in tests/test_torch_engine3d.py.

Tolerances: with the integer fill every partial sum is an exact integer as long
as the fp64 ground truth stays below 2**24 (every 3-D tap is positive), and then
the port, the JAX engine and the ground truth agree bit for bit.  Beyond that,
and on the pi/100 fill, the two packages round in different orders (the JAX
plane conv sums symmetric tap pairs first, ``band_gemm.apply_spec_vpu``), so
they agree to fp32 rounding: rel <= 1e-6 of the grid's largest value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models import shapes as jax_shapes
from lorastencil_tpu.ops import pallas_3d, xla_ref
from lorastencil_tpu.ops.layout import Layout3D as JaxLayout3D
from lorastencil_tpu_torch import cli, convert, engine
from lorastencil_tpu_torch.models.shapes import ALL_SHAPES, get_shape
from lorastencil_tpu_torch.ops import band_gemm, stencil3d, torch_ref
from lorastencil_tpu_torch.ops.layout import Layout3D, default_tile_3d, guard_3d
from lorastencil_tpu_torch.utils import reference

EXACT = 2.0 ** 24  # below this every integer partial sum is exact in fp32


def compare_with_jax_engine(name, interior, k, seed=5):
    """The port's engine (device "cpu") against the JAX engine and the fp64
    ground truth, steps k and 2k+1 on the integer fill and k on pi/100."""
    spec = get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=seed)
    jeng = jax_engine.StencilEngine.for_shape(name, interior, fused_steps_3d=k)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu",
                                          fused_steps_3d=k)
    assert (peng.algorithm, peng._fused_k()) == (jeng.algorithm, jeng._fused_k()) == ("vpu", k)
    for fill, steps_list in ((g0, (k, 2 * k + 1)), (g0 * (np.pi / 100), (k,))):
        for steps in steps_list:
            want = reference.run(fill, spec, steps)
            got = peng.run(fill, steps)
            assert got.dtype == torch.float32 and got.shape == spec.padded_shape(interior)
            got = got.numpy()
            jgot = np.asarray(jeng.run(fill, steps))
            scale = np.abs(want).max()
            if fill is g0 and scale < EXACT:
                assert np.array_equal(got, want) and np.array_equal(got, jgot)
            else:
                assert np.abs(got - want).max() <= 1e-6 * scale
                assert np.abs(got - jgot).max() <= 1e-6 * scale


SMALL = [(1, 8, 128), (2, 8, 128), (6, 20, 150)]  # the last: ragged tiles
SLABS = (64, 16, 150)  # several JAX slabs and several port z chunks


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name,interior", [("star3d1r", i) for i in SMALL + [SLABS]]
                         + [("box3d1r", i) for i in SMALL])
def test_engine_matches_jax_engine(name, interior, k):
    compare_with_jax_engine(name, interior, k)


def _jax_layout(spec, interior, k, tile=(8, 128)):
    return JaxLayout3D(interior=interior, halo=spec.halo, tile=tile,
                       zguard=max(spec.halo[0], k * spec.radius))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_step_matches_pallas_kernel_bit_for_bit(name, k):
    """One pass of k levels: the port's wrapper (its plain twin on a CPU tensor)
    against the Pallas kernel it replaces, on the same padded input, each in its
    own layout."""
    spec = get_shape(name)
    interior = (6, 20, 150)
    g0 = reference.random_padded(spec, interior, seed=7)
    jl = _jax_layout(spec, interior, k)
    x = jl.to_internal(g0)
    want = np.asarray(pallas_3d.stencil3d_step(
        x, jnp.zeros_like(x), jax_shapes.get_shape(name), jl, interpret=True,
        fused_steps=k))
    pl = Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(20, 150),
                  guard=guard_3d(spec.halo, k * spec.radius))
    cur = pl.to_internal(g0)
    keep = cur.clone()
    donor = torch.zeros_like(cur)
    got = stencil3d.stencil3d_step(cur, donor, spec, pl, fused_steps=k)
    assert got is donor and torch.equal(cur, keep)
    assert np.array_equal(pl.from_internal(got).numpy(), jl.from_internal(want))
    assert np.array_equal(pl.from_internal(got).numpy(), reference.run(g0, spec, k))


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_plain_step_matches_reference_on_ragged_tiles(name, K):
    """A tile that divides neither plane axis: the rounded interior is written
    (zeros beyond the true interior, even where the input holds garbage) and the
    donor's guard ring is left as it is."""
    spec = get_shape(name)
    interior = (5, 19, 70)
    lay = Layout3D(interior=interior, halo=spec.halo, tile=(8, 32),
                   guard=guard_3d(spec.halo, K * spec.radius))
    assert lay.rounded == (5, 24, 96)
    g0 = reference.random_padded(spec, interior, seed=3)
    cur = lay.to_internal(g0)
    z0, r0, c0 = lay.origin
    cur[z0: z0 + 5, r0 + 19 + spec.halo[1]: r0 + 24, c0: c0 + 96] = 5.0  # round-up garbage
    donor = torch.full(lay.shape, 7.0)
    stencil3d.stencil3d_step_plain(cur, donor, spec, lay, fused_steps=K)
    assert np.array_equal(lay.from_internal(donor).numpy()[1:-1, 2:-2, 4:-4],
                          reference.run(g0, spec, K)[1:-1, 2:-2, 4:-4])
    assert torch.all(donor[z0: z0 + 5, r0 + 19: r0 + 24, c0: c0 + 96] == 0)
    assert torch.all(donor[z0: z0 + 5, r0: r0 + 24, c0 + 70: c0 + 96] == 0)
    ring = torch.ones(lay.shape, dtype=torch.bool)
    ring[z0: z0 + 5, r0: r0 + 24, c0: c0 + 96] = False
    assert torch.all(donor[ring] == 7.0)


def test_layout3d_round_trip_and_guard():
    spec = get_shape("box3d1r")
    interior = (6, 20, 150)
    lay = Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(20, 150),
                   guard=guard_3d(spec.halo, 2))
    assert default_tile_3d(256, 256) == (32, 64)
    assert lay.guard == (2, 4, 4) and guard_3d((1, 2, 4), 5) == (5, 8, 8)
    assert lay.rounded == (6, 32, 192) and lay.shape == (10, 40, 200)
    g0 = reference.random_padded(spec, interior, seed=2) + 1.0  # no zeros
    buf = lay.to_internal(g0)
    assert buf.dtype == torch.float32 and np.array_equal(lay.from_internal(buf).numpy(), g0)
    inside = torch.zeros(lay.shape, dtype=torch.bool)
    inside[lay._box()] = True
    assert torch.all(buf[inside] > 0) and torch.all(buf[~inside] == 0)
    jl = _jax_layout(spec, interior, 2, tile=(24, 256))
    assert np.array_equal(np.asarray(jl.from_internal(jl.to_internal(g0))),
                          lay.from_internal(buf).numpy())
    with pytest.raises(ValueError, match="shape"):
        lay.to_internal(g0[1:])
    with pytest.raises(ValueError, match="guard"):
        Layout3D(interior=interior, halo=(1, 2, 4), tile=(8, 8), guard=(1, 1, 4)).validate()


@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_state_from_jax_continues_the_run_exactly(name):
    """One JAX step on its internal state (a JAX Layout3D, origin
    (zguard, 8, 128)), carried over, then one port step: two steps of the
    reference (integer partial sums below 2**24, so exact)."""
    interior = (6, 20, 150)
    spec = get_shape(name)
    jeng = jax_engine.StencilEngine.for_shape(name, interior)
    g0 = reference.random_padded(spec, interior, seed=9)
    s1 = jeng.run_internal(jeng.to_internal(g0), 1)
    assert tuple(jeng.layout.origin) == (2, 8, 128)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu")
    state = convert.state_from_jax(np.asarray(s1), jeng.layout, peng.layout)
    got = peng.from_internal(peng.run_internal(state, 1)).numpy()
    assert np.array_equal(got, np.asarray(jeng.run(g0, 2)))
    assert np.array_equal(got, reference.run(g0, spec, 2))


@pytest.mark.parametrize("name", ALL_SHAPES)
def test_spec_from_jax_equals_the_port_registry(name):
    jspec = jax_shapes.get_shape(name)
    spec = convert.spec_from_jax(jspec)
    assert spec == get_shape(name)
    assert np.array_equal(spec.dense_coeffs(), jspec.dense_coeffs())
    assert spec.fuse_factor == jspec.fuse_factor and spec.halo == jspec.halo


@pytest.mark.parametrize("name", ["1d2r", "box2d3r", "box3d1r"])
def test_copied_modules_match_the_jax_package(name):
    """The port's copies of the fp64 ground truth and the GStencil/s record
    give what the JAX package's give."""
    from lorastencil_tpu.utils import metrics as jax_metrics
    from lorastencil_tpu.utils import reference as jax_reference
    from lorastencil_tpu_torch.utils import metrics

    spec, jspec = get_shape(name), jax_shapes.get_shape(name)
    interior = {1: (300,), 2: (20, 30), 3: (5, 9, 12)}[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=13)
    assert np.array_equal(g0, jax_reference.random_padded(jspec, interior, seed=13))
    assert np.array_equal(reference.run(g0, spec, 2),
                          jax_reference.run(g0, jspec, 2))
    got = metrics.bench_result(spec, interior, 64, 0.0125, "cuda", "fp32", 3)
    want = jax_metrics.bench_result(jspec, interior, 64, 0.0125, "cuda", "fp32", 3)
    assert got.json() == want.json() and got.human() == want.human()


def test_plan_array_encodes_3d_classes_and_z_taps():
    W = 3
    star = band_gemm.plan_array(get_shape("star3d1r")).tolist()
    stride = 3 + 3 * W
    assert len(star) == 3 * stride  # three terms, no residue
    z, row, col = (star[i * stride: (i + 1) * stride] for i in range(3))
    assert z[:3] == [band_gemm.IDENTITY_Z, 0.0, 0.0] and z[3: 3 + W] == [1.0, 0.0, 1.0]
    assert row[:3] == [band_gemm.CENTRE, 0.0, 1.0] and row[3 + 2 * W:] == [1.0, 1.0, 1.0]
    assert col[:3] == [band_gemm.CENTRE, 1.0, 0.0] and col[3 + W: 3 + 2 * W] == [1.0, 1.0, 1.0]
    box = band_gemm.plan_array(get_shape("box3d1r")).tolist()
    assert box == [band_gemm.BUFFERED, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 1.0, 1.0, 1.0, 1.0]
    assert stencil3d._classify_terms(get_shape("star3d1r")) == ([], [0], [1, 2])
    assert stencil3d._classify_terms(get_shape("box3d1r")) == ([0], [], [])
    assert (stencil3d._classify_terms(get_shape("box3d1r"))
            == tuple(map(list, pallas_3d._classify_terms(jax_shapes.get_shape("box3d1r")))))


@pytest.mark.parametrize("fn,jax_fn", [(torch_ref.dense_step, xla_ref.dense_step),
                                       (torch_ref.separable_step, xla_ref.separable_step)])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_reference_steps_match_xla_ref(fn, jax_fn, name):
    spec = get_shape(name)
    g0 = reference.random_padded(spec, (5, 12, 20), seed=11)
    got = fn(torch.from_numpy(g0.astype(np.float32)), spec).numpy()
    want = np.asarray(jax_fn(jnp.asarray(g0, jnp.float32), jax_shapes.get_shape(name)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, reference.run(g0, spec, 1))


def test_ping_pong_loop_runs_passes_then_the_remainder():
    state = torch.ones(4)
    seen = []

    def step(cur, donor, depth):
        seen.append((depth, donor.data_ptr()))
        donor.copy_(cur + depth)
        return donor

    out = engine.ping_pong_loop(step, state, 7, 2)
    assert [d for d, _ in seen] == [2, 2, 2, 1]
    assert len({p for _, p in seen}) == 2 and state.data_ptr() not in {p for _, p in seen}
    assert torch.equal(state, torch.ones(4)) and torch.equal(out, torch.full((4,), 8.0))
    assert engine.ping_pong_loop(step, state, 0, 2) is state


def test_engine_3d_resolution_backends_and_refusals():
    eng = engine.StencilEngine.for_shape("box3d1r", (6, 20, 150), device="cpu")
    assert (eng.algorithm, eng.backend, eng._fused_k()) == ("vpu", "pallas", 2)
    assert eng.layout.guard == guard_3d((1, 2, 4), 2) and eng.layout.tile == (32, 64)
    deep = engine.StencilEngine.for_shape("star3d1r", (6, 20, 150), device="cpu",
                                          fused_steps_3d=12)
    assert deep._fused_k() == 8 and deep.layout.guard == (8, 8, 8)
    g0 = reference.random_padded(eng.spec, (6, 20, 150), seed=4)
    for kw in ({"backend": "xla"}, {"algorithm": "vpu_roll"}, {"algorithm": "mxu_hybrid1"},
               {"fused_steps_3d": 3}):
        other = engine.StencilEngine.for_shape("box3d1r", (6, 20, 150), device="cpu", **kw)
        assert np.array_equal(other.run(g0, 3).numpy(), reference.run(g0, eng.spec, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP B13"):
        engine.StencilEngine.for_shape("star3d1r", (6, 20, 150), device="cpu", algorithm="mxu")
    with pytest.raises(ValueError, match="no 3-D path"):
        engine.StencilEngine.for_shape("star3d1r", (6, 20, 150), device="cpu",
                                       algorithm="mxu_split")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        engine.StencilEngine.for_shape("star3d1r", (6, 20, 150), device="cpu",
                                       dtype="bfloat16")
    for dtype, k in (("float64", 2), ("df64", 1)):  # the fp64-grade tier runs
        fp64 = engine.StencilEngine.for_shape("box3d1r", (6, 20, 150), device="cpu",
                                              dtype=dtype)
        assert fp64._fused_k() == k and fp64.backend == "pallas"
        assert np.array_equal(fp64.run(g0, 3).numpy(), reference.run(g0, eng.spec, 3))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    spec = get_shape("star3d1r")
    lay = Layout3D(interior=(4, 8, 8), halo=spec.halo, tile=(8, 8), guard=(2, 4, 4))
    cur, donor = torch.zeros(lay.shape), torch.zeros(lay.shape)
    with pytest.raises(NotImplementedError, match="B13"):
        stencil3d.stencil3d_step(cur, donor, spec, lay, algorithm="mxu")
    stencil3d.stencil3d_step(cur, donor, spec, lay, bounds=(0, 4, 0, 8, 0, 8))  # ported (A6)
    stencil3d.stencil3d_step(cur, donor, spec, lay, bounds=(-2, 4, -4, 12, -4, 12))
    for bad in ((0, 4, 0, 8, 0, 7), (1, 4, 0, 8, 0, 8), (0, 4, -5, 8, 0, 8), (0, 4, 0, 8, 0)):
        with pytest.raises(ValueError, match="bounds"):
            stencil3d.stencil3d_step(cur, donor, spec, lay, bounds=bad)
    with pytest.raises(NotImplementedError, match="A11"):
        stencil3d.stencil3d_step(cur, donor, spec, lay, region=((0, 1), (0, 1)))
    with pytest.raises(ValueError, match="unknown algorithm"):
        stencil3d.stencil3d_step(cur, donor, spec, lay, algorithm="fast")
    with pytest.raises(ValueError, match="reach"):
        stencil3d.stencil3d_step(cur, donor, spec, lay, fused_steps=3)
    with pytest.raises(ValueError, match="fused_steps"):
        stencil3d.stencil3d_step(cur, donor, spec, lay, fused_steps=9)
    with pytest.raises(ValueError, match="not 3-D"):
        stencil3d.stencil3d_step(cur, donor, get_shape("star2d1r"), lay)
    with pytest.raises(TypeError):
        stencil3d.stencil3d_step(cur.half(), donor.half(), spec, lay)
    with pytest.raises(ValueError, match="different buffer"):
        stencil3d.stencil3d_step(cur, cur, spec, lay)
    with pytest.raises(ValueError, match="shape"):
        stencil3d.stencil3d_step(cur[1:], donor, spec, lay)
    before = stencil3d.stencil3d_step.launches
    out = stencil3d.stencil3d_step(cur, donor, spec, lay, fused_steps=2, conv_carry=True)
    assert out is donor and stencil3d.stencil3d_step.launches == before  # CPU: the twin


def test_cli_3d_check_passes_on_cpu(capsys):
    assert cli.main(["star3d1r", "6", "20", "150", "3", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Correct!" in out and "sizes = (6, 20, 150)" in out
    with pytest.raises(SystemExit):
        cli.main(["box3d1r", "20", "150", "2", "--device", "cpu"])  # 2 sizes for a 3-D shape
