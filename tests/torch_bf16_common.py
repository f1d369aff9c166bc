"""Helpers of the bfloat16 tier's tests (tests/test_torch_bf16_2d*.py): both
engines of one configuration, the rounding rule's cases, and the comparisons.

The rounding rule (ops/stencil2d.py): the port's tiled passes round to bf16
once a pass, at the store; its whole-grid run every step.  On the integer fill
every fp32 sum is exact, so the port equals the JAX bf16 engine bit for bit
wherever the JAX kernel rounds the same way -- at k = 1 under every name but
'mxu_hybrid' on a two-axis term (which rounds that term's column conv through
the matrix unit), at k >= 2 under 'vpu_roll' in extent fusion, and in the
whole-grid run -- and within 1e-2 of the largest value of the ground truth
elsewhere (measured: 7.0e-3 after 4 steps); within 5e-2 of the ground truth
everywhere (the JAX tests' bound)."""

import jax.numpy as jnp
import numpy as np

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.utils import reference

JAX_TOL = 1e-2
TRUTH_TOL = 5e-2


def engines(name, interior, **kw):
    """(port engine on the CPU, JAX engine) of a registry shape in bf16, their
    labels held equal: ``algorithm``, ``_fused_k()``, the fusion mode and the
    ``residue_mxu`` policy."""
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="bfloat16",
                                          **kw)
    jeng = jax_engine.StencilEngine.for_shape(name, interior, dtype="bfloat16", **kw)
    labels_agree(peng, jeng)
    return peng, jeng


def labels_agree(peng, jeng):
    assert peng.algorithm == jeng.algorithm
    assert peng._fused_k() == jeng._fused_k()
    assert peng._fusion_mode() == jeng._fusion_mode()
    assert peng.residue_mxu == jax_engine.residue_mxu_policy(
        jeng.config.residue_mxu, jnp.bfloat16, jeng.algorithm)


def two_axis(spec):
    return any(all(t is not None for t in term.taps) for term in spec.terms)


def exact_name(peng):
    """Whether the JAX kernel rounds as the port does (see the module)."""
    k = peng._fused_k()
    if peng._fusion_mode() == "skew" and k >= 2:
        return False
    if k == 1:
        return not (peng.algorithm == "mxu_hybrid" and two_axis(peng.spec))
    return peng.algorithm in ("vpu_roll", "vpu")


def rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def check(peng, jeng, g0, steps, exact=None, truth=reference.run):
    """The port's bf16 run against the JAX engine's (bit for bit where
    ``exact``, by default ``exact_name``; else within JAX_TOL) and the ground
    truth (TRUTH_TOL); returns it as float64."""
    got = peng.run(g0, steps)
    assert str(got.dtype) == "torch.bfloat16"
    got = got.double().numpy()
    want = np.asarray(jeng.run(g0, steps).astype(jnp.float32), np.float64)
    truth = truth(g0, peng.spec, steps)
    if exact is None:
        exact = exact_name(peng)
    if exact:
        assert np.array_equal(got, want), (got != want).sum()
    assert rel(got, want) <= JAX_TOL
    assert rel(got, truth) <= TRUTH_TOL
    return got
