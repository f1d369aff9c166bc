"""The 2-D bfloat16 state tier (ROADMAP A6(c)) on the CPU: the port's engine
(device="cpu": the bf16 twins of the kernels) against the JAX bf16 engine
(Pallas interpret mode) and the fp64 ground truth, one step a pass (k = 1) and
the whole-grid run, on the four 2-D registry shapes under every algorithm name
the tier takes; the labels (``algorithm``, ``_fused_k``, ``residue_mxu``)
equal the JAX engine's.  Fused and skewed passes:
tests/test_torch_bf16_2d_fused.py; the rest of the tier:
tests/test_torch_bf16_2d_tier.py.  Rule and tolerances: tests/torch_bf16_common.py."""

import numpy as np
import pytest

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models.shapes import get_shape as jax_get_shape
from lorastencil_tpu.ops import pallas_2d
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.utils import reference
from torch_bf16_common import check, engines, exact_name

SHAPES = ("star2d1r", "box2d1r", "box2d3r", "star2d3r")
NAMES = ("auto", "vpu_roll", "mxu_hybrid", "mxu_hybrid1", "vpu")
INTERIOR = (40, 200)


@pytest.fixture(autouse=True)
def empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LORASTENCIL_CACHE", str(tmp_path))


@pytest.mark.parametrize("name", SHAPES)
def test_resolve_algorithm_and_policies_match_jax(name):
    """'auto' in bf16 is 'mxu_hybrid' for two or fewer terms and no residue
    (star2d3r), 'mxu_hybrid1' otherwise; residue_mxu 'auto' is on under
    'mxu_hybrid1' only; the fused depth is JAX's."""
    spec, jspec = get_shape(name), jax_get_shape(name)
    for dtype in ("float32", "bfloat16", "float64"):
        for alg in ("auto",) + NAMES[1:]:
            jdt = {"float32": np.float32, "float64": np.float64}.get(dtype, "bfloat16")
            assert (engine.resolve_algorithm(spec, alg, dtype)
                    == jax_engine.resolve_algorithm(jspec, alg, jdt))
    for mode in ("auto", "on", "off"):
        for alg in NAMES[1:]:
            for dtype, jdt in (("bfloat16", "bfloat16"), ("float32", np.float32)):
                assert (engine.residue_mxu_policy(mode, dtype, alg)
                        == jax_engine.residue_mxu_policy(mode, jdt, alg))
    want = "mxu_hybrid" if name == "star2d3r" else "mxu_hybrid1"
    peng, _ = engines(name, INTERIOR)
    assert peng.algorithm == want


@pytest.mark.parametrize("alg", NAMES)
@pytest.mark.parametrize("name", SHAPES)
def test_one_step_passes_match_jax(name, alg):
    """k = 1: bit for bit with the JAX engine on the integer fill after 4
    steps, except 'mxu_hybrid' on a two-axis term (within 1e-2)."""
    peng, jeng = engines(name, INTERIOR, algorithm=alg, fused_steps=1)
    assert peng._fused_k() == 1
    g0 = reference.random_padded(peng.spec, INTERIOR, seed=77)
    check(peng, jeng, g0, 4)


@pytest.mark.parametrize("name", SHAPES)
def test_default_passes_match_jax(name):
    """The engine's default config: k = 1 under 'mxu_hybrid1' (residue_mxu
    on where there is a residue), star2d3r k = 2 under 'mxu_hybrid'; the
    pi/100 fill as well, within the tier's tolerances."""
    peng, jeng = engines(name, INTERIOR)
    g0 = reference.random_padded(peng.spec, INTERIOR, seed=77)
    check(peng, jeng, g0, 4)
    check(peng, jeng, g0 * (np.pi / 100), 3, exact=False)
    assert exact_name(peng) == (name != "star2d3r")


@pytest.fixture()
def caps_on(monkeypatch):
    for module in (pallas_2d, stencil2d):
        monkeypatch.setattr(module, "RESIDENT_2D_BYTES", 8 * 2**20)


@pytest.mark.parametrize("alg", ["auto", "vpu_roll", "vpu"])
@pytest.mark.parametrize("name,interior", [("star2d1r", (256, 384)), ("box2d3r", (200, 300)),
                                           ("star2d3r", (200, 300))])
def test_whole_grid_run_matches_jax(name, interior, alg, caps_on, monkeypatch):
    """Under the same cap (JAX's rule at 2 bytes a cell), both engines take
    their whole-grid run where the name allows it ('mxu_hybrid' does not:
    star2d3r's 'auto'), which rounds every step in both packages: bit for bit
    on the integer fill."""
    peng, jeng = engines(name, interior, algorithm=alg)
    takes = peng.algorithm in ("mxu_hybrid1", "vpu_roll", "vpu")
    assert peng._resident_2d() == takes
    assert pallas_2d.fits_resident_2d(jeng.layout, jeng.dtype.itemsize)
    g0 = reference.random_padded(peng.spec, interior, seed=31)
    got = check(peng, jeng, g0, 3, exact=takes or exact_name(peng))
    if takes:  # every step rounded: the tiled k = 1 passes' values
        monkeypatch.setattr(stencil2d, "RESIDENT_2D_BYTES", 0)
        tiled = engine.StencilEngine.for_shape(name, interior, device="cpu",
                                               dtype="bfloat16", algorithm=alg,
                                               fused_steps=1)
        assert not tiled._resident_2d()
        assert np.array_equal(got, tiled.run(g0, 3).double().numpy())
