"""Helpers of the ghost-boundary tests (tests/test_torch_boundary1d.py,
_2d.py, _3d.py): the input, the ground truth and the check that holds the
port's engine to it and to the JAX engine.

Tolerances, relative to the largest value of the ground truth: float32 1e-6
(tests/test_boundary.py's), against the ground truth and against the JAX
engine; df64 and float64 1e-13 (the port runs both in native fp64, the JAX
df64 pairs hold ~1e-14 a step)."""

import jax.numpy as jnp
import numpy as np

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.utils import reference

TOL = {"float32": 1e-6, "df64": 1e-13, "float64": 1e-13}


def padded_input(spec, interior, seed):
    """tests/test_boundary.py's input: a uniform [0, 0.01) interior, a zero
    halo (a ghost boundary ignores the halo given)."""
    padded = np.zeros(spec.padded_shape(interior))
    padded[reference.interior_slices(spec, padded.shape)] = (
        np.random.default_rng(seed).uniform(0, 0.01, interior))
    return padded


def truth(boundary, padded, spec, steps):
    fn = reference.run_periodic if boundary == "periodic" else reference.run_reflect
    return fn(padded, spec, steps)


def rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / max(1e-30, np.abs(want).max())


def jax_run(jeng, padded, steps, dtype):
    if dtype == "float32":
        return np.asarray(jeng.run(jnp.asarray(padded, jnp.float32), steps), np.float64)
    return np.asarray(jeng.run(padded, steps), np.float64)


def both(name, interior, boundary, dtype="float32", **kw):
    """(port engine on the CPU, JAX engine) of one config."""
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", boundary=boundary,
                                          dtype=dtype, **kw)
    jeng = jax_engine.StencilEngine.for_shape(name, interior, boundary=boundary, dtype=dtype,
                                              **kw)
    return peng, jeng


def check(peng, jeng, padded, steps, boundary, dtype="float32"):
    """The port's run against the ground truth and the JAX engine's; the
    output's halo is zero, as the ground truth's."""
    want = truth(boundary, padded, peng.spec, steps)
    got = peng.run(padded, steps).numpy()
    assert rel_err(got, want) <= TOL[dtype]
    assert rel_err(got, jax_run(jeng, padded, steps, dtype)) <= TOL[dtype]
    halo = np.ones(got.shape, bool)
    halo[reference.interior_slices(peng.spec, got.shape)] = False
    assert not got[halo].any()
