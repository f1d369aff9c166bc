"""The 2-D bfloat16 tier's fused and skewed passes (ROADMAP A6(c)) on the CPU:
the port's engine against the JAX bf16 engine (Pallas interpret mode) and the
fp64 ground truth at k = 2 and 3, extent and skew fusion, on the four 2-D
registry shapes.  Under 'vpu_roll' extent fusion both packages round once a
pass: bit for bit on the integer fill.  JAX's 'mxu_hybrid' / 'mxu_hybrid1' also
round a fused level through the matrix operand, and its skew kernel keeps its
level carries in bf16: there within 1e-2 (tests/torch_bf16_common.py)."""

import pytest

from lorastencil_tpu_torch.utils import reference
from torch_bf16_common import check, engines, exact_name

SHAPES = ("star2d1r", "box2d1r", "box2d3r", "star2d3r")
INTERIOR = (40, 200)


@pytest.fixture(autouse=True)
def empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LORASTENCIL_CACHE", str(tmp_path))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("alg", ["vpu_roll", "mxu_hybrid", "mxu_hybrid1"])
@pytest.mark.parametrize("name", SHAPES)
def test_extent_passes_match_jax(name, alg, k):
    peng, jeng = engines(name, INTERIOR, algorithm=alg, fused_steps=k)
    assert peng._fused_k() == k and exact_name(peng) == (alg == "vpu_roll")
    g0 = reference.random_padded(peng.spec, INTERIOR, seed=77)
    check(peng, jeng, g0, 4)


@pytest.mark.parametrize("alg", ["vpu_roll", "mxu_hybrid1"])
@pytest.mark.parametrize("name", SHAPES)
def test_skew_passes_match_jax(name, alg):
    """fusion='skew' at its default k = 2, and a remainder step (5 steps)."""
    peng, jeng = engines(name, INTERIOR, algorithm=alg, fusion="skew")
    assert peng._fusion_mode() == "skew" and peng._fused_k() == 2
    g0 = reference.random_padded(peng.spec, INTERIOR, seed=78)
    check(peng, jeng, g0, 5)


def test_skew_refuses_star2d3r_auto_as_jax_does():
    """star2d3r's bf16 'auto' is 'mxu_hybrid', which skew fusion does not take
    in either package (the same ValueError)."""
    from lorastencil_tpu import engine as jax_engine
    from lorastencil_tpu_torch import engine

    for make in (lambda: jax_engine.StencilEngine.for_shape(
                     "star2d3r", INTERIOR, dtype="bfloat16", fusion="skew"),
                 lambda: engine.StencilEngine.for_shape(
                     "star2d3r", INTERIOR, device="cpu", dtype="bfloat16", fusion="skew")):
        with pytest.raises(ValueError, match="resolved algorithm is 'mxu_hybrid'"):
            make()
