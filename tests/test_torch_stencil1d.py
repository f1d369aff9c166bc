"""The port's 1-D kernel module on the CPU: each wrapper of lorastencil_tpu_torch.
ops.stencil1d (its plain twin on a CPU tensor) against the Pallas kernel it
replaces (lorastencil_tpu.ops.pallas_1d, interpret mode) on the same seeded
input, each in its own layout, plus the 1-D layout, state conversion, reference
steps and the module's dispatch helpers.  The engine's cases are in
tests/test_torch_engine1d.py.

Tolerances: with the integer fill every partial sum of steps 1-2 (and of more
steps while the ground truth stays below 2**24) is an exact integer, so the
port, the Pallas kernel and the fp64 ground truth agree bit for bit.  On the
pi/100 fill, and over a resident run's 2*refresh + 3 steps, they round in
different orders (the TPU's 'mxu' path sums a 3-part bf16 split through
matmuls): rel <= 1e-6 of the largest value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models import shapes as jax_shapes
from lorastencil_tpu.ops import pallas_1d, xla_ref
from lorastencil_tpu.ops.layout import Layout1D as JaxLayout1D
from lorastencil_tpu.ops.layout import Layout1DLanes
from lorastencil_tpu_torch import convert, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil1d, torch_ref
from lorastencil_tpu_torch.ops.layout import TILE_1D, Layout1D, guard_1d
from lorastencil_tpu_torch.utils import reference

PI = np.pi / 100
TAPS_40 = np.random.default_rng(40).integers(-3, 4, 81).astype(np.float64)  # r = 40


def _specs(name):
    """(port spec, JAX spec) of a registry shape or of the r = 40 taps."""
    if name == "r40":
        return (engine.StencilEngine.for_coeffs(TAPS_40, (64,), device="cpu").spec,
                jax_engine.StencilEngine.for_coeffs(TAPS_40, (64,)).spec)
    return get_shape(name), jax_shapes.get_shape(name)


def _port_layout(spec, n, reach):
    return Layout1D(interior=n, halo=spec.halo[0], tile=TILE_1D,
                    guard=guard_1d(spec.halo[0], reach))


def _compare(name, n, jax_layout, port_layout, jax_run, port_run, steps_list, seed=3):
    """Both runs from the same padded input (carried into the port's layout with
    convert.state_from_jax) against each other and the fp64 ground truth."""
    spec, _ = _specs(name)
    g0 = reference.random_padded(spec, (n,), seed=seed)
    for fill, steps in [(g0, s) for s in steps_list[0]] + [(g0 * PI, s) for s in steps_list[1]]:
        x = jax_layout.to_internal(jnp.asarray(fill, jnp.float32))
        want_jax = np.asarray(jax_layout.from_internal(jax_run(x, steps)))
        cur = convert.state_from_jax(np.asarray(x), jax_layout, port_layout)
        keep = cur.clone()
        got = port_layout.from_internal(port_run(cur, steps)).numpy()
        assert torch.equal(cur, keep)
        want = reference.run(fill, spec, steps)
        scale = np.abs(want).max()
        if fill is g0 and scale < 2.0 ** 24:
            assert np.array_equal(got, want) and np.array_equal(got, want_jax)
        else:
            assert np.abs(got - want).max() <= 1e-6 * scale
            assert np.abs(got - want_jax).max() <= 1e-6 * scale


def _passes(step, k, spec, lay):
    def run(x, steps):
        return engine.ping_pong_loop(
            lambda c, d, depth: step(c, d, spec, lay, fused_steps=depth), x, steps, k)
    return run


def _jax_passes(step, k, jspec, jlay, **kw):
    def run(x, steps):
        for depth in [k] * (steps // k) + ([steps % k] if steps % k else []):
            x = step(x, jnp.zeros_like(x), jspec, jlay, interpret=True, fused_steps=depth, **kw)
        return x
    return run


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", ["1d1r", "1d2r"])
def test_lanes_step_matches_pallas_kernel(name, k):
    """#5: the narrow pass against _stencil1d_lanes_kernel on an overlapped-lanes
    layout of several tiles (n = 33,001, 16-row tiles)."""
    spec, jspec = _specs(name)
    n = 33_001
    jl = Layout1DLanes(interior=n, halo=4, lane_halo=8, tile_rows=16)
    pl = _port_layout(spec, n, 8)
    _compare(name, n, jl, pl,
             _jax_passes(pallas_1d.stencil1d_lanes_step, k, jspec, jl, algorithm="mxu"),
             _passes(stencil1d.stencil1d_lanes_step, k, spec, pl),
             ([1, 2] if k == 1 else [2], [4]))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40"])
def test_flat_step_matches_pallas_kernel(name, k):
    """#4: the wide pass against _stencil1d_kernel on the flat layout the JAX
    engine builds for algorithm='vpu' (n = 5000: several 1024-cell tiles)."""
    spec, jspec = _specs(name)
    n = 5000
    jl = JaxLayout1D(interior=n, halo=spec.halo[0], tile_rows=8, guard_rows=8)
    r_eff = stencil1d.effective_radius(spec)
    pl = _port_layout(spec, n, k * r_eff)
    _compare(name, n, jl, pl,
             _jax_passes(pallas_1d.stencil1d_step, k, jspec, jl),
             _passes(stencil1d.stencil1d_step, k, spec, pl),
             ([1, 2] if k == 1 else [3], [3 if k == 3 else 4]))


@pytest.mark.parametrize("n", [4096, 3001])
@pytest.mark.parametrize("name", ["1d1r", "1d2r"])
def test_resident_lanes_matches_pallas_kernel(name, n):
    """#7: the narrow whole run against _stencil1d_resident_lanes_kernel on the
    JAX engine's resident lanes layout, over 2*refresh + 3 steps (two halo
    reloads and a tail)."""
    spec, jspec = _specs(name)
    jl = jax_engine.StencilEngine.for_shape(name, (n,)).layout
    assert pallas_1d.fits_resident_lanes(jl)
    r_eff = stencil1d.effective_radius(spec)
    refresh = stencil1d.lanes_refresh(r_eff)
    assert refresh == jl.lane_halo // r_eff == 8
    pl = _port_layout(spec, n, refresh * r_eff)
    _compare(name, n, jl, pl,
             lambda x, s: pallas_1d.stencil1d_resident_lanes(x, jspec, jl, s, interpret=True),
             lambda x, s: stencil1d.stencil1d_resident_lanes(x, spec, pl, s),
             ([1, 2], [2 * refresh + 3]))


@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40"])
def test_resident_matches_pallas_kernel(name):
    """#6: the wide whole run (a grid sync every step) against
    _stencil1d_resident_kernel on the JAX engine's flat layout for
    algorithm='vpu', over 2*1 + 3 steps."""
    spec, jspec = _specs(name)
    n = 3001
    jl = JaxLayout1D(interior=n, halo=spec.halo[0], tile_rows=24, guard_rows=8)
    assert pallas_1d.fits_resident(jl)
    pl = _port_layout(spec, n, stencil1d.effective_radius(spec))
    _compare(name, n, jl, pl,
             lambda x, s: pallas_1d.stencil1d_resident(x, jspec, jl, s, interpret=True),
             lambda x, s: stencil1d.stencil1d_resident(x, spec, pl, s),
             ([1, 2], [5]))


def test_twins_write_the_rounded_interior_only():
    """A pass writes [0, rounded) of the donor with zeros beyond n, even where the
    input holds garbage there, and leaves the donor's guard as it is; a run
    returns a new buffer with a zero guard."""
    spec = get_shape("1d2r")
    n = 3001
    lay = _port_layout(spec, n, 8)
    assert (lay.rounded, lay.guard, lay.shape) == (4096, 8, (4112,))
    g0 = reference.random_padded(spec, (n,), seed=2)
    cur = lay.to_internal(g0)
    cur[8 + n + 4: 8 + 4096] = 5.0  # round-up garbage
    o = lay.origin
    for step in (stencil1d.stencil1d_lanes_step, stencil1d.stencil1d_step):
        donor = torch.full(lay.shape, 7.0)
        out = step(cur, donor, spec, lay, fused_steps=2)
        assert out is donor
        assert np.array_equal(donor[o: o + n].numpy(), reference.run(g0, spec, 2)[4:-4])
        assert torch.all(donor[o + n: o + 4096] == 0)
        assert torch.all(donor[:o] == 7.0) and torch.all(donor[o + 4096:] == 7.0)
    for run in (stencil1d.stencil1d_resident_lanes, stencil1d.stencil1d_resident):
        out = run(cur, spec, lay, 2)
        assert out.data_ptr() != cur.data_ptr()
        assert np.array_equal(lay.from_internal(out).numpy(), reference.run(g0, spec, 2))
        assert torch.all(out[:o] == 0) and torch.all(out[o + n:] == 0)


@pytest.mark.parametrize("kind", ["flat", "lanes", "resident_lanes"])
def test_state_from_jax_reads_both_1d_layouts(kind):
    """One JAX step on its internal state, carried over, then one port step: two
    steps of the reference.  The lanes layouts' halo lanes are nonzero by then
    (stale by contract) and are not read."""
    n = {"flat": 3001, "lanes": 600_000, "resident_lanes": 3001}[kind]
    kw = {"algorithm": "vpu"} if kind == "flat" else {}
    jeng = jax_engine.StencilEngine.for_shape("1d2r", (n,), **kw)
    peng = engine.StencilEngine.for_shape("1d2r", (n,), device="cpu", **kw)
    assert type(jeng.layout) is (JaxLayout1D if kind == "flat" else Layout1DLanes)
    assert peng.path == {"flat": "resident"}.get(kind, kind)
    g0 = reference.random_padded(peng.spec, (n,), seed=9)
    s1 = np.asarray(jeng.run_internal(jeng.to_internal(g0), 1))
    state = convert.state_from_jax(s1, jeng.layout, peng.layout)
    got = peng.from_internal(peng.run_internal(state, 1)).numpy()
    assert np.array_equal(got, reference.run(g0, peng.spec, 2))
    bad = s1.copy().reshape(-1)
    bad[jeng.layout.shape[-1] * 8 - 200] = 1.0  # a payload cell before the halo
    with pytest.raises(ValueError, match="outside its padded array"):
        convert.state_from_jax(bad.reshape(s1.shape), jeng.layout, peng.layout)
    with pytest.raises(ValueError, match="layouts disagree"):
        convert.state_from_jax(s1, jeng.layout, _port_layout(peng.spec, n + 1, 8))


@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40"])
def test_taps_radius_and_size_caps_match_pallas_1d(name):
    spec, jspec = _specs(name)
    assert stencil1d.dense_taps(spec) == pallas_1d._dense_taps(jspec)
    assert stencil1d.effective_radius(spec) == pallas_1d.effective_radius(jspec)
    assert (stencil1d.RESIDENT_BYTES, stencil1d.RESIDENT_LANES_BYTES) == (
        pallas_1d.RESIDENT_BYTES, pallas_1d.RESIDENT_LANES_BYTES)
    for n in (3001, 50_000, 300_000, 1_000_000):
        jl = JaxLayout1D(interior=n, halo=spec.halo[0],
                         tile_rows=max(8, min(512, 8 * -(-n // 1024))), guard_rows=8)
        assert stencil1d.fits_resident(_port_layout(spec, n, 8)) == pallas_1d.fits_resident(jl)
    assert not stencil1d.fits_resident(jl) and not stencil1d.fits_resident_lanes(jl)


def test_layout1d_round_trip_and_guard():
    spec = get_shape("1d1r")
    lay = _port_layout(spec, 3001, 9)
    assert lay.guard == 12 and guard_1d(4, 0) == 4 and guard_1d(40, 3) == 40
    assert lay.grid == (2,) and lay.rounded == 4096 and lay.shape == (4120,)
    g0 = reference.random_padded(spec, (3001,), seed=2) + 1.0  # no zeros
    buf = lay.to_internal(g0)
    assert buf.dtype == torch.float32 and np.array_equal(lay.from_internal(buf).numpy(), g0)
    assert torch.all(buf[8: 8 + 3009] > 0)
    assert torch.all(buf[:8] == 0) and torch.all(buf[8 + 3009:] == 0)
    with pytest.raises(ValueError, match="shape"):
        lay.to_internal(g0[1:])
    with pytest.raises(ValueError, match="guard"):
        Layout1D(interior=10, halo=4, tile=8, guard=3).validate()


@pytest.mark.parametrize("fn,jax_fn", [(torch_ref.dense_step, xla_ref.dense_step),
                                       (torch_ref.separable_step, xla_ref.separable_step)])
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40"])
def test_reference_steps_match_xla_ref(fn, jax_fn, name):
    spec, jspec = _specs(name)
    g0 = reference.random_padded(spec, (300,), seed=11)
    got = fn(torch.from_numpy(g0.astype(np.float32)), spec).numpy()
    want = np.asarray(jax_fn(jnp.asarray(g0, jnp.float32), jspec))
    assert np.array_equal(got, want)
    assert np.array_equal(got, reference.run(g0, spec, 1))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    spec = get_shape("1d2r")
    lay = _port_layout(spec, 100, 8)
    cur, donor = torch.zeros(lay.shape), torch.zeros(lay.shape)
    wide, _ = _specs("r40")
    lanes, flat = stencil1d.stencil1d_lanes_step, stencil1d.stencil1d_step
    flat(cur, donor, spec, lay, bounds=(0, 100))  # the interior: ported (A6)
    for bad in ((1, 100), (0, 99), (-9, 100), (0, 100, 0)):
        with pytest.raises(ValueError, match="bounds"):
            flat(cur, donor, spec, lay, bounds=bad)
    with pytest.raises(NotImplementedError, match="A11"):
        lanes(cur, donor, spec, lay, region=(0, 1))
    with pytest.raises(ValueError, match="effective radius 40"):
        lanes(cur, donor, wide, _port_layout(wide, 100, 40))
    with pytest.raises(ValueError, match="k\\*r_eff = 36"):
        lanes(cur, donor, spec, lay, fused_steps=9)
    with pytest.raises(ValueError, match="reach 12"):
        lanes(cur, donor, spec, lay, fused_steps=3)
    with pytest.raises(ValueError, match="fused_steps 65"):
        flat(cur, donor, spec, lay, fused_steps=65)
    with pytest.raises(ValueError, match="algorithm"):
        lanes(cur, donor, spec, lay, algorithm="mxu_split")
    with pytest.raises(ValueError, match="not 1-D"):
        flat(cur, donor, get_shape("star2d1r"), lay)
    with pytest.raises(TypeError):
        flat(cur.half(), donor.half(), spec, lay)
    with pytest.raises(ValueError, match="different buffer"):
        flat(cur, cur, spec, lay)
    with pytest.raises(ValueError, match="shape"):
        lanes(cur[1:], donor, spec, lay)
    with pytest.raises(ValueError, match="steps"):
        stencil1d.stencil1d_resident(cur, spec, lay, 0)
    with pytest.raises(ValueError, match="effective radius 40"):
        stencil1d.stencil1d_resident_lanes(cur, wide, lay, 3)
    counters = [f.launches for f in (lanes, flat, stencil1d.stencil1d_resident,
                                     stencil1d.stencil1d_resident_lanes)]
    assert flat(cur, donor, spec, lay, fused_steps=2) is donor
    assert lanes(cur, donor, spec, lay, fused_steps=2, algorithm="mxu") is donor
    stencil1d.stencil1d_resident(cur, spec, lay, 3)
    stencil1d.stencil1d_resident_lanes(cur, spec, lay, 3)
    assert counters == [f.launches for f in (lanes, flat, stencil1d.stencil1d_resident,
                                             stencil1d.stencil1d_resident_lanes)]  # CPU: twins
