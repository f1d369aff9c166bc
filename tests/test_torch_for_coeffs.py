"""2-D ``StencilEngine.for_coeffs`` of the port (ROADMAP A6(b)) on the CPU,
against the JAX engine (Pallas interpret mode) and the fp64 ground truth:
twins of tests/test_aux.py's custom-coefficient engines, of
tests/test_interactions.py's custom specs under periodic and reflect
boundaries and of tests/test_property.py's random custom stencils (drawing
only the algorithm names the port runs; the rest are pinned refused).

Each case holds the port's spec equal to ``convert.spec_from_jax`` of the
JAX engine's, its ``algorithm``, ``df64_algorithm`` and ``_fused_k`` equal
to the JAX engine's, and its run within rel 1e-5 (float32) of both the JAX
engine's run and ``utils.reference.run`` / ``run_periodic`` /
``run_reflect`` (relative to the largest value of the reference, floored at
1 as the JAX tests do; helpers: tests/torch_custom_common.py).  3-D and
the fp64-grade tier: tests/test_torch_for_coeffs3d.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import convert, engine
from lorastencil_tpu_torch.models.shapes import StencilSpec, get_shape
from lorastencil_tpu_torch.utils import reference
from torch_custom_common import check, engines, rel

PORT_NAMES = ("auto", "vpu", "vpu_roll", "mxu_hybrid1")
UNPORTED = ("mxu", "mxu_split", "mxu_hybrid1r", "mxu_hybrid3")


def dense_spec(S, halo):
    """Ground-truth spec: the matrix as pure residue points."""
    r = (S.shape[0] - 1) // 2
    return StencilSpec(
        name="dense", ndim=2, radius=r, halo=halo, terms=(),
        residue=tuple((tuple(int(i) - r for i in idx), float(S[tuple(idx)]))
                      for idx in np.argwhere(np.abs(S) > 0)), fuse_factor=1)


# -- tests/test_aux.py:31-55 -------------------------------------------------
def test_custom_coeffs_engine():
    rng = np.random.default_rng(0)
    u, v = rng.normal(size=5), rng.normal(size=5)
    S = np.outer(u, u) + 0.25 * np.outer(v, v)
    S[0, 4] += 1.0
    S[4, 0] += 1.0
    peng, jeng = engines(S, (40, 200), halo=(4, 4))
    g0 = np.random.default_rng(1).uniform(0, 1, size=peng.spec.padded_shape((40, 200)))
    check(peng, jeng, g0, 2, dense=dense_spec(S, (4, 4)))


def test_custom_coeffs_fused():
    spec = get_shape("box2d3r")
    peng, jeng = engines(spec.dense_coeffs(), (40, 200), halo=(4, 4), fused_steps=2)
    assert peng._fused_k() == 2
    g0 = reference.random_padded(spec, (40, 200), seed=2)
    got = check(peng, jeng, g0, 3)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


# -- tests/test_interactions.py:35-62 ----------------------------------------
def _padded(spec, interior, seed, scale=0.01):
    p = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    p[it] = np.random.default_rng(seed).uniform(0, scale, interior)
    return p, it


def test_reflect_custom_coeffs_2d():
    S = np.array([[0.0, 0.5, 0.0],
                  [0.25, 1.0, 0.25],
                  [0.0, 0.5, 0.0]]) / 3.0
    peng, jeng = engines(S, (24, 200), halo=(1, 1), boundary="reflect", fused_steps=1)
    p, it = _padded(peng.spec, (24, 200), 102)
    got = check(peng, jeng, p, 3)
    want = reference.run_reflect(p, peng.spec, 3)[it]
    assert np.abs(got[it] - want).max() / np.abs(want).max() < 1e-6


def test_periodic_custom_coeffs_with_residue():
    S = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0
    S[0, 2] += 0.125  # non-separable spike -> residue path
    peng, jeng = engines(S, (24, 200), halo=(1, 1), boundary="periodic", fused_steps=2)
    assert peng.spec.residue and peng._fused_k() == 2
    p, it = _padded(peng.spec, (24, 200), 103)
    got = check(peng, jeng, p, 4)
    want = reference.run_periodic(p, peng.spec, 4)[it]
    assert np.abs(got[it] - want).max() / np.abs(want).max() < 1e-6


@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
def test_asymmetric_5x5_every_boundary(boundary):
    """The non-symmetric spec of tests/test_df64.py:309 in float32: 3 terms
    and 4 unpaired residue points; reflect at k = 1 only (the JAX check)."""
    S = np.random.default_rng(43).standard_normal((5, 5))
    peng, jeng = engines(S, (24, 200), boundary=boundary)
    assert (len(peng.spec.terms), len(peng.spec.residue)) == (3, 4)
    p, _ = _padded(peng.spec, (24, 200), 104, scale=1.0)
    check(peng, jeng, p, 3)


def test_reflect_fused_asymmetric_refused_by_both():
    S = np.random.default_rng(43).standard_normal((5, 5))
    for build in (lambda: engine.StencilEngine.for_coeffs(
            S, (24, 200), device="cpu", boundary="reflect", fused_steps=2),
                  lambda: jax_engine.StencilEngine.for_coeffs(
            S, (24, 200), boundary="reflect", fused_steps=2)):
        with pytest.raises(ValueError, match="symmetric"):
            build()


# -- tests/test_property.py:40-95 --------------------------------------------
def _random_low_rank(rng, w, rank, spikes):
    S = np.zeros((w, w))
    for _ in range(rank):
        u = np.round(rng.normal(size=w), 2)
        v = np.round(rng.normal(size=w), 2)
        S += np.outer(u, v)
    for _ in range(spikes):
        i, j = rng.integers(0, w, 2)
        S[i, j] += round(float(rng.normal()), 2)
    return S


@pytest.mark.parametrize("seed", range(12))
def test_random_custom_stencils(seed):
    """test_random_custom_stencils (seeds 0-5) and its round-2 tiers (6-11):
    random low-rank + spike matrices, algorithm drawn from the names the
    port runs, fused depth 1-4, 1-4 steps."""
    rng = np.random.default_rng(seed)
    w = int(rng.choice([3, 5, 7]))
    rank = int(rng.integers(1, 3))
    spikes = int(rng.integers(0, 4))
    S = _random_low_rank(rng, w, rank, spikes)
    r = (w - 1) // 2
    alg = rng.choice(PORT_NAMES).item()
    k = int(rng.choice([1, 2, 3, 4] if seed < 6 else [1, 2, 3]))
    peng, jeng = engines(S, (24, 136), halo=(r, r), max_rank=4, algorithm=alg,
                         fused_steps=k)
    g0 = rng.uniform(-1, 1, peng.spec.padded_shape((24, 136)))
    check(peng, jeng, g0, int(rng.integers(1, 5)), dense=dense_spec(S, (r, r)))


@pytest.mark.parametrize("alg", UNPORTED)
def test_unported_algorithm_names_stay_refused(alg):
    """The JAX engine accepts these TPU variants for a custom spec; the
    port's kernel backend refuses them, naming ROADMAP B13, and its 'xla'
    backend runs them."""
    S = _random_low_rank(np.random.default_rng(5), 5, 2, 1)
    jax_engine.StencilEngine.for_coeffs(S, (24, 136), algorithm=alg)
    with pytest.raises(NotImplementedError, match="B13"):
        engine.StencilEngine.for_coeffs(S, (24, 136), device="cpu", algorithm=alg)
    engine.StencilEngine.for_coeffs(S, (24, 136), device="cpu", algorithm=alg,
                                    backend="xla")


def test_mxu_hybrid_runs_the_exact_kernel():
    """'mxu_hybrid', refused until the bf16 tier made it the 'auto' of
    star2d3r-like specs there (ROADMAP A6(c)), runs the one exact kernel of
    the dtype: bit for bit the run under 'mxu_hybrid1', within rel 1e-5 of
    the ground truth, and within 1e-4 of the JAX engine's two-part split
    (~6e-6 a step)."""
    S = _random_low_rank(np.random.default_rng(5), 5, 2, 1)
    peng, jeng = engines(S, (24, 136), algorithm="mxu_hybrid")
    g0 = np.random.default_rng(6).uniform(-1, 1, peng.spec.padded_shape((24, 136)))
    got = peng.run(g0, 3).numpy()
    exact = engine.StencilEngine.for_coeffs(S, (24, 136), device="cpu",
                                            algorithm="mxu_hybrid1").run(g0, 3).numpy()
    assert np.array_equal(got, exact)
    want = reference.run(g0, peng.spec, 3)
    assert rel(got, want) < 1e-5
    assert rel(got, np.asarray(jeng.run(jnp.asarray(g0, jnp.float32), 3))) < 1e-4


# -- the decomposition's options, the checks -----------------------------------
@pytest.mark.parametrize("w,max_rank", [(3, 1), (3, 2), (3, 4), (5, 1), (5, 2)])
def test_max_rank_reaches_the_decomposition(w, max_rank):
    """A random full-rank matrix: max_rank bounds the terms (the SVD's
    leftover goes to the residue where it is sparse enough, else the
    decomposition raises), as in the JAX engine."""
    S = np.random.default_rng(21).standard_normal((w, w))
    try:
        jax_engine.StencilEngine.for_coeffs(S, (24, 136), max_rank=max_rank)
    except ValueError:
        with pytest.raises(ValueError, match="cannot decompose"):
            engine.StencilEngine.for_coeffs(S, (24, 136), device="cpu", max_rank=max_rank)
        assert w == 5
        return
    peng, jeng = engines(S, (24, 136), max_rank=max_rank)
    assert len(peng.spec.terms) == min(max_rank, 2)
    r = (w - 1) // 2
    g0 = np.random.default_rng(22).uniform(-1, 1, peng.spec.padded_shape((24, 136)))
    check(peng, jeng, g0, 2, dense=dense_spec(S, (r, r)))


def test_max_rank_changes_the_spec():
    S = np.random.default_rng(23).standard_normal((3, 3))
    four = engine.StencilEngine.for_coeffs(S, (24, 136), device="cpu")
    assert len(four.spec.terms) == 2 and len(four.spec.residue) == 1
    for kw in ({"max_rank": 1}, {"max_rank": 1, "name": "other", "fuse_factor": 3}):
        one = engine.StencilEngine.for_coeffs(S, (24, 136), device="cpu", **kw)
        jone = jax_engine.StencilEngine.for_coeffs(S, (24, 136), **kw)
        assert one.spec == convert.spec_from_jax(jone.spec) != four.spec
        assert len(one.spec.terms) == 1 and one.spec.name == kw.get("name", "custom")


@pytest.mark.parametrize("coeffs", [np.ones((3, 5)), np.ones((4, 4)), np.ones((2, 3, 3)),
                                    np.ones((3, 3, 3, 3))])
def test_bad_shapes_raise_value_error_where_jax_asserts(coeffs):
    """Kept on purpose (ROADMAP section C): the JAX engine asserts, the port
    raises ValueError, in the JAX engine's order of checks."""
    with pytest.raises(AssertionError):
        jax_engine.StencilEngine.for_coeffs(coeffs, (16,) * coeffs.ndim)
    with pytest.raises(ValueError, match="odd"):
        engine.StencilEngine.for_coeffs(coeffs, (16,) * coeffs.ndim, device="cpu")


def test_for_coeffs_engine_runs_like_engine_run_on_its_spec():
    """The engine of a coefficient array and the one-shot ``engine.run`` of
    its spec: the same values bit for bit."""
    S = np.random.default_rng(24).standard_normal((5, 5))
    peng = engine.StencilEngine.for_coeffs(S, (24, 136), device="cpu", halo=(3, 3))
    g0 = np.random.default_rng(25).uniform(-1, 1, peng.spec.padded_shape((24, 136)))
    assert peng.spec.halo == (3, 3)
    np.testing.assert_array_equal(peng.run(g0, 3).numpy(),
                                  engine.run(g0, peng.spec, 3, device="cpu").numpy())
