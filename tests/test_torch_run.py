"""Two entry points of the port against the JAX engine on the CPU: backend
'xla' with every algorithm name the JAX engine accepts, and the one-shot
``engine.run(padded, spec, steps, device=..., **config)``.

Under backend 'xla' both packages step the plain separable step, which takes
no kernel and so no algorithm name: the names that choose among the JAX
package's TPU kernels (and that the port's kernels refuse, ROADMAP B13, or
have no counterpart for in that dimension) run there all the same.  On the
integer fill every partial sum is an integer below 2**24, so the port, the
JAX engine and the fp64 ground truth agree bit for bit."""

import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models.shapes import SeparableTerm as JaxSeparableTerm
from lorastencil_tpu.models.shapes import StencilSpec as JaxStencilSpec
from lorastencil_tpu.models.shapes import get_shape as jax_get_shape
from lorastencil_tpu_torch import convert, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.utils import reference

INTERIORS = {"1d2r": (300,), "star2d1r": (16, 128), "box2d3r": (20, 70),
             "star3d1r": (8, 8, 64), "box3d1r": (5, 12, 40)}


@pytest.mark.parametrize("algorithm", engine.ALGORITHM_NAMES)
@pytest.mark.parametrize("name", sorted(INTERIORS))
def test_xla_backend_runs_every_algorithm_name(name, algorithm):
    interior = INTERIORS[name]
    spec = get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=4)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu", backend="xla",
                                          algorithm=algorithm)
    jeng = jax_engine.StencilEngine.for_shape(name, interior, backend="xla",
                                              algorithm=algorithm)
    assert peng.backend == jeng.backend == "xla"
    assert peng._fused_k() == jeng._fused_k() == 1
    got = peng.run(g0, 2)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.array_equal(got, reference.run(g0, spec, 2))
    assert np.array_equal(got, np.asarray(jeng.run(g0, 2)))


@pytest.mark.parametrize("name,algorithm,err", [
    ("star2d1r", "mxu_hybrid3", NotImplementedError),
    ("star2d1r", "vpu_sep", ValueError),
    ("star3d1r", "mxu_split", ValueError),
    ("star3d1r", "mxu", NotImplementedError),
])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_kernel_backends_still_refuse_names_without_a_kernel(name, algorithm, err, backend):
    with pytest.raises(err):
        engine.StencilEngine.for_shape(name, INTERIORS[name], device="cpu", backend=backend,
                                       algorithm=algorithm)


@pytest.mark.parametrize("kw", [{}, {"dtype": "df64"}, {"fused_steps_3d": 1, "backend": "xla"}])
@pytest.mark.parametrize("name", ["star2d1r", "box3d1r"])
def test_module_run_matches_jax_run_on_a_registry_spec(name, kw):
    interior = INTERIORS[name]
    spec = get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=5)
    got = engine.run(g0, spec, 2, device="cpu", steps_unused=7, **kw)
    assert got.shape == g0.shape and got.device.type == "cpu"
    assert got.dtype == (torch.float64 if kw.get("dtype") else torch.float32)
    got = got.numpy()
    want = jax_engine.run(g0, jax_get_shape(name), 2, steps_unused=7, **kw)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, reference.run(g0, spec, 2))
    # a torch tensor goes in as well as a NumPy array
    assert np.array_equal(engine.run(torch.from_numpy(g0), spec, 2, device="cpu",
                                     **kw).numpy(), got)


def test_module_run_takes_a_custom_spec():
    """A 1-D spec built outside the registry (as JAX ``run`` takes one),
    with a halo wider than its radius."""
    fields = dict(name="custom1d", ndim=1, radius=2, halo=(3,), residue=(),
                  fuse_factor=1)
    taps = (0.25, -0.5, 1.0, -0.5, 0.25)
    jspec = JaxStencilSpec(terms=(JaxSeparableTerm(taps=(taps,)),), **fields)
    spec = convert.spec_from_jax(jspec)
    g1 = np.random.default_rng(6).standard_normal(500 + 2 * 3)
    got = engine.run(g1, spec, 4, device="cpu", algorithm="vpu")
    want = np.asarray(jax_engine.run(g1, jspec, 4, algorithm="vpu"))
    ref = reference.run(g1, spec, 4)
    scale = np.abs(ref).max()
    assert got.shape == g1.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale
    assert np.abs(got.numpy() - want).max() <= 1e-6 * scale
    # the port's run built the engine for this spec, not a registry entry
    assert np.array_equal(got.numpy(), engine.StencilEngine(
        spec, (500,), engine.EngineConfig(algorithm="vpu"), device="cpu").run(g1, 4).numpy())


def test_module_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run goes there")
    spec = get_shape("star2d1r")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.run(reference.random_padded(spec, (16, 16)), spec, 1)
