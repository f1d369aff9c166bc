"""The rest of the 2-D bfloat16 tier (ROADMAP A6(c)) on the CPU: ghost
boundaries and a ``for_coeffs`` spec against the JAX bf16 engine, the adjoint
(``run_vjp``, ``run_diff``), ``convert.state_from_jax`` of a JAX bf16 state,
the bf16 twins against the float32 twins, the layout's single rounding, and
what still raises.  Rule and tolerances: tests/torch_bf16_common.py; the
twins are held bit for bit: a bf16 twin is the float32 twin of the widened
input, rounded to nearest even at each store."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import cli, convert, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.layout import as_state, round_to_bf16
from lorastencil_tpu_torch.utils import reference
from torch_bf16_common import TRUTH_TOL, check, labels_agree, rel

BF16 = torch.bfloat16
INTERIOR = (40, 200)
TRUTH = {"periodic": reference.run_periodic, "reflect": reference.run_reflect}


@pytest.fixture(autouse=True)
def empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LORASTENCIL_CACHE", str(tmp_path))


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name", ["star2d1r", "star2d3r"])
def test_ghost_boundaries_match_jax(name, boundary):
    """The ring refresh copies bf16 cells (no rounding); star2d1r k = 1 is
    bit for bit, star2d3r's 'mxu_hybrid' k = 2 within 1e-2."""
    kw = dict(dtype="bfloat16", boundary=boundary)
    peng = engine.StencilEngine.for_shape(name, INTERIOR, device="cpu", **kw)
    jeng = jax_engine.StencilEngine.for_shape(name, INTERIOR, **kw)
    labels_agree(peng, jeng)
    g0 = reference.random_padded(peng.spec, INTERIOR, seed=7)
    check(peng, jeng, g0, 3, truth=TRUTH[boundary])


def _custom_5x5():
    """Integer coefficients of rank 2 with two spikes: two terms and a
    residue."""
    S = np.outer([1, 2, 3, 2, 1], [1, 0, 2, 0, 1]) + np.outer([0, 1, 1, 1, 0], [1, 1, 1, 1, 1])
    S = S.astype(np.float64)
    S[0, 4] += 1.0
    S[4, 1] -= 2.0
    return S


@pytest.mark.parametrize("kw", [{}, {"fused_steps": 2, "algorithm": "vpu_roll"}])
def test_for_coeffs_matches_jax(kw):
    """A 5x5 of integer coefficients with a residue: k = 1 (and 'vpu_roll'
    k = 2) bit for bit."""
    S = _custom_5x5()
    peng = engine.StencilEngine.for_coeffs(S, INTERIOR, device="cpu", dtype="bfloat16", **kw)
    jeng = jax_engine.StencilEngine.for_coeffs(S, INTERIOR, dtype="bfloat16", **kw)
    labels_agree(peng, jeng)
    g0 = reference.random_padded(peng.spec, INTERIOR, seed=9)
    check(peng, jeng, g0, 3)


@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
def test_adjoint_matches_jax(boundary):
    """run_vjp on a bf16 engine runs where JAX's does: within the tier's 5e-2
    of the JAX product, and within 1e-2 of the float64 engine's (the port's
    last unmasked correlation and reflect fold-back sum in float32 and round
    once; JAX's round each product and sum to bf16, 1.5e-2 from float64 after
    3 steps, the port 3e-3); autograd through run_diff gives run_vjp's
    tensor, bit for bit."""
    name, steps = "star2d1r", 3
    kw = dict(dtype="bfloat16", boundary=boundary)
    peng = engine.StencilEngine.for_shape(name, INTERIOR, device="cpu", **kw)
    jeng = jax_engine.StencilEngine.for_shape(name, INTERIOR, **kw)
    g = np.random.default_rng(2).integers(0, 4, get_shape(name).padded_shape(INTERIOR))
    g = g.astype(np.float64)
    got = peng.run_vjp(g, steps)
    assert got.dtype == BF16
    got = got.double().numpy()
    want = np.asarray(jeng.run_vjp(jnp.asarray(g, jnp.bfloat16), steps).astype(jnp.float32),
                      np.float64)
    truth = engine.StencilEngine.for_shape(name, INTERIOR, device="cpu", dtype="float64",
                                           boundary=boundary).run_vjp(g, steps).numpy()
    assert rel(got, want) <= TRUTH_TOL
    assert rel(got, truth) <= 1e-2
    x = torch.zeros(get_shape(name).padded_shape(INTERIOR), dtype=BF16, requires_grad=True)
    (peng.run_diff(x, steps).float() * torch.from_numpy(g).float()).sum().backward()
    assert x.grad.dtype == BF16
    assert torch.equal(x.grad, peng.run_vjp(g, steps))


def test_df64_run_diff_still_raises_as_jax_does():
    for eng in (engine.StencilEngine.for_shape("star2d1r", (16, 16), device="cpu",
                                               dtype="df64"),
                jax_engine.StencilEngine.for_shape("star2d1r", (16, 16), dtype="df64")):
        with pytest.raises(ValueError, match="run_diff"):
            eng.run_diff(np.zeros((24, 24)), 1)


def test_state_from_jax_takes_a_bf16_state():
    """A JAX bf16 internal state (an ml_dtypes array) carried to a
    torch.bfloat16 port state bit for bit, round-tripped through
    from_internal, then stepped on by the port as the JAX engine steps."""
    name = "box2d1r"
    peng = engine.StencilEngine.for_shape(name, INTERIOR, device="cpu", dtype="bfloat16")
    jeng = jax_engine.StencilEngine.for_shape(name, INTERIOR, dtype="bfloat16")
    g1 = reference.random_padded(peng.spec, INTERIOR, seed=5) * (np.pi / 100)
    s1 = np.asarray(jeng.run_internal(jeng.to_internal(g1), 1))
    assert s1.dtype == ml_dtypes.bfloat16
    state = convert.state_from_jax(s1, jeng.layout, peng.layout)
    assert state.dtype == BF16 and state.shape == peng.layout.shape
    padded = np.asarray(jeng.from_internal(jnp.asarray(s1)))
    assert np.array_equal(peng.from_internal(state).view(torch.int16).numpy(),
                          padded.view(np.int16))
    s2 = np.asarray(jeng.run_internal(jnp.asarray(s1), 1))
    got = peng.from_internal(peng.run_internal(state, 1))
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(jeng.from_internal(jnp.asarray(s2))).view(np.int16))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", ["star2d1r", "box2d3r", "star2d3r"])
def test_bf16_twins_round_the_float32_twins(name, k):
    """Each bf16 twin is its float32 twin on the widened input, rounded at
    each store: a pass once, a whole-grid run every step (any fill, NaN and
    inf included)."""
    spec = get_shape(name)
    eng = engine.StencilEngine.for_shape(name, INTERIOR, device="cpu", fused_steps=k)
    lay = eng.layout
    g = reference.random_padded(spec, INTERIOR, seed=k) * (np.pi / 100)
    g.flat[g.size // 3] = np.inf
    x = lay.to_internal(g, BF16)
    f = x.float()
    got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay, fused_steps=k)
    want = stencil2d.stencil2d_step(f, torch.zeros_like(f), spec, lay, fused_steps=k)
    torch.testing.assert_close(got, want.to(BF16), rtol=0, atol=0, equal_nan=True)
    if k >= 2:
        skew = stencil2d.stencil2d_skew_step(x, torch.zeros_like(x), spec, lay, skew_steps=k)
        torch.testing.assert_close(skew, got, rtol=0, atol=0, equal_nan=True)
    run = stencil2d.stencil2d_resident(x, spec, lay, k)
    cur = f
    for _ in range(k):
        cur = stencil2d.stencil2d_step_plain(cur, torch.zeros_like(cur), spec, lay)
        cur = cur.to(BF16).float()
    torch.testing.assert_close(run, cur.to(BF16), rtol=0, atol=0, equal_nan=True)


def test_to_internal_rounds_once():
    """float64 -> bfloat16 in one rounding to nearest even (torch's and
    ml_dtypes' conversions go through float32 and can round twice), exact
    on bf16 values, a view back out; run_checksum sums in float64."""
    halfway = 1 + 2.0 ** -8
    x = np.array([halfway + 2.0 ** -30, -(halfway + 2.0 ** -30), halfway, 1 + 3 * 2.0 ** -8,
                  np.inf, -0.0, 1e-40, 3.0])
    got = round_to_bf16(torch.from_numpy(x)).double().numpy()
    assert got.tolist()[:4] == [1 + 2.0 ** -7, -(1 + 2.0 ** -7), 1.0, 1 + 2.0 ** -6]
    assert np.array_equal(got[4:], x[4:].astype(ml_dtypes.bfloat16).astype(np.float64))
    assert torch.from_numpy(x).to(BF16).double()[0].item() == 1.0  # the double rounding
    rng = np.random.default_rng(0)
    v = rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
    b = round_to_bf16(torch.from_numpy(v))
    assert torch.equal(as_state(b.double().numpy(), BF16), b)  # exact on bf16 values
    # the nearest bf16: no closer neighbour (bits +- 1), an even one at a tie
    bits = b.view(torch.int16).numpy().astype(np.int32)
    mine = np.abs(b.double().numpy() - v)
    for step in (-1, 1):
        other = torch.from_numpy((bits + step).astype(np.int16)).view(BF16).double().numpy()
        theirs = np.abs(other - v)
        assert np.all((mine < theirs) | ((mine == theirs) & (bits % 2 == 0)))
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device="cpu", dtype="bfloat16")
    g = reference.random_padded(eng.spec, INTERIOR, seed=1) + 2.0 ** -30
    state = eng.to_internal(g)
    assert state.dtype == BF16 and eng.from_internal(state).data_ptr() == state[
        eng.layout.origin[0] - 4, eng.layout.origin[1] - 4].data_ptr()
    assert torch.equal(eng.from_internal(state), round_to_bf16(torch.from_numpy(g)))
    s = eng.run_checksum(g, 2)
    assert s.dtype == torch.float64
    assert s.item() == eng.run(g, 2).double().sum().item()


@pytest.mark.parametrize("argv", [["1d2r", "4096", "2"], ["star3d1r", "8", "16", "16", "2"]])
def test_cli_bf16_refuses_1d_and_3d(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--device", "cpu", "--dtype", "bfloat16"])
    assert exc.value.code == 2
    assert "ROADMAP A6(c)" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["1d1r", "star3d1r", "box3d1r"])
def test_1d_and_3d_bf16_still_raise(name):
    interior = {1: (4096,), 3: (8, 16, 16)}[get_shape(name).ndim]
    with pytest.raises(NotImplementedError, match=r"ROADMAP A6\(c\)"):
        engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="bfloat16")
