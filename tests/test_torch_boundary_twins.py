"""The plain twins' ``bounds`` (ROADMAP A6(a)), no JAX: every level before the
last keeps the box ``[lo, hi)`` per axis, the last the interior, so that a
ghost ring filled before the pass survives its fused levels.

* each twin at k fused steps on a buffer whose ring the engine's refresh
  filled, with the engine's ghost bounds, equals k steps of the fp64 ground
  truth (``run_periodic`` / ``run_reflect``) on the interior, bit for bit on
  an integer fill in float64 (every partial sum an integer below 2**53),
  and leaves zeros beyond the interior;
* no bounds and the interior's bounds are the same pass, bit for bit, on
  any fill, and every wrapper checks its bounds (``layout.check_bounds``);
* ``band_gemm.mask_to_interior``'s box."""

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.ops import band_gemm, stencil1d, stencil2d, stencil3d
from lorastencil_tpu_torch.ops.layout import check_bounds
from lorastencil_tpu_torch.utils import reference

CASES = [  # name, interior, engine kw, twin
    ("1d1r", (3001,), {}, stencil1d.stencil1d_step_plain),
    ("1d2r", (3001,), {}, stencil1d.stencil1d_lanes_step_plain),
    ("1d2r", (5000,), {"fused_steps": 8}, stencil1d.stencil1d_lanes_step_plain),
    ("star2d1r", (37, 45), {"fused_steps": 3}, stencil2d.stencil2d_step_plain),
    ("star2d3r", (37, 45), {}, stencil2d.stencil2d_step_plain),
    ("box2d3r", (40, 130), {"fused_steps": 2}, stencil2d.stencil2d_step_plain),
    ("star3d1r", (9, 20, 70), {}, stencil3d.stencil3d_step_plain),
    ("box3d1r", (9, 20, 70), {"fused_steps_3d": 4}, stencil3d.stencil3d_step_plain),
]
IDS = [f"{c[0]}-{c[1]}-{c[2]}" for c in CASES]


def ghost_engine(name, interior, boundary, kw, dtype="float32"):
    return engine.StencilEngine.for_shape(name, interior, device="cpu", boundary=boundary,
                                          dtype=dtype, **kw)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name,interior,kw,twin", CASES, ids=IDS)
def test_twin_with_ghost_bounds_is_k_steps_of_the_ground_truth(name, interior, kw, twin,
                                                                boundary):
    eng = ghost_engine(name, interior, boundary, kw)
    k = eng._fused_k()
    assert k >= 2  # the levels before the last are what the bounds keep
    g0 = reference.random_padded(eng.spec, interior, seed=7) % 4
    # float64: the sums stay integers, exact, up to 2**53 (1d2r's 8 steps
    # pass 2**24)
    x = eng._ring_refresh(eng.to_internal(g0).double(), boundary)
    out = twin(x, torch.zeros_like(x), eng.spec, eng.layout, k, eng._ghost_bounds())
    fn = reference.run_periodic if boundary == "periodic" else reference.run_reflect
    want = fn(g0, eng.spec, k)
    assert np.array_equal(eng.from_internal(out).numpy(), want)
    # beyond the interior the pass wrote zeros (the last level's mask), and
    # the donor's ring is left as it was
    rest = out.clone()
    rest[tuple(slice(o, o + s) for o, s in zip(np.atleast_1d(eng.layout.origin),
                                               interior))] = 0
    assert not rest.any()
    # without bounds the fused levels zero the ring: a dirichlet0 pass
    plain = twin(x, torch.zeros_like(x), eng.spec, eng.layout, k)
    assert not np.array_equal(eng.from_internal(plain).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,interior,kw,twin", CASES, ids=IDS)
def test_interior_bounds_are_no_bounds(name, interior, kw, twin, dtype):
    """The default keeps today's pass bit for bit, on a fill whose sums
    round (pi/100) and with a nonzero guard."""
    eng = ghost_engine(name, interior, "periodic", kw)
    k = eng._fused_k()
    g0 = reference.random_padded(eng.spec, interior, seed=8) * np.pi / 100
    x = eng.to_internal(g0).to(dtype)
    x = eng._ring_refresh(x, "reflect")  # a guard that a mask must zero
    box = tuple(v for s in interior for v in (0, s))
    none = twin(x, torch.zeros_like(x), eng.spec, eng.layout, k)
    assert torch.equal(twin(x, torch.zeros_like(x), eng.spec, eng.layout, k, box), none)
    ghost = twin(x, torch.zeros_like(x), eng.spec, eng.layout, k, eng._ghost_bounds())
    assert not torch.equal(ghost, none)


def test_one_step_pass_ignores_bounds():
    """The last level keeps the interior whatever the bounds: a one-step
    pass is the same with or without them."""
    for name, interior, twin in (("star2d1r", (37, 45), stencil2d.stencil2d_step_plain),
                                 ("box3d1r", (9, 20, 70), stencil3d.stencil3d_step_plain),
                                 ("1d2r", (3001,), stencil1d.stencil1d_lanes_step_plain)):
        eng = ghost_engine(name, interior, "periodic", {"fused_steps": 1}
                           if len(interior) < 3 else {"fused_steps_3d": 1})
        x = eng._ring_refresh(eng.to_internal(
            reference.random_padded(eng.spec, interior, seed=9)), "periodic")
        assert torch.equal(twin(x, torch.zeros_like(x), eng.spec, eng.layout, 1,
                                eng._ghost_bounds()),
                           twin(x, torch.zeros_like(x), eng.spec, eng.layout, 1))


@pytest.mark.parametrize("name,interior,wrapper,bad", [
    # every wrapper takes a shard's box (an end inside the interior, a start
    # beyond the guard: test_torch_region{1,2,3}d.py), not a start inside it
    ("1d2r", (3001,), stencil1d.stencil1d_lanes_step, [(1, 3001), (7, 3000), (0, 3001, 0),
                                                       (0,), "ab"]),
    ("1d1r", (3001,), stencil1d.stencil1d_step, [(1, 3001), (0, 3000, 0, 1)]),
    ("star2d1r", (37, 45), stencil2d.stencil2d_step, [(1, 37, 0, 45), (0, 37, 2, 45),
                                                      (0, 37), "ab"]),
    ("box3d1r", (9, 20, 70), stencil3d.stencil3d_step, [(0, 20, 3, 70), (1, 9, 0, 20, 0, 70),
                                                        (0, 9, 0, 20, 0, 70, 0),
                                                        (0, 9, 2, 20, 0, 70)]),
])
def test_wrappers_refuse_bad_bounds(name, interior, wrapper, bad):
    eng = ghost_engine(name, interior, "periodic", {})
    x = eng.to_internal(reference.random_padded(eng.spec, interior, seed=1))
    k = eng._fused_k()
    wrapper(x, torch.zeros_like(x), eng.spec, eng.layout, fused_steps=k,
            bounds=eng._ghost_bounds())
    for b in bad:
        with pytest.raises(ValueError, match="bounds"):
            wrapper(x, torch.zeros_like(x), eng.spec, eng.layout, fused_steps=k, bounds=b)


def test_check_bounds():
    assert check_bounds(None, (5, 7), (4, 4)) == (0, 5, 0, 7)
    assert check_bounds(torch.tensor([-4, 9, -1, 8]), (5, 7), (4, 4)) == (-4, 9, -1, 8)
    assert check_bounds((-2, 6, -2, 9), (3, 4, 7), (2, 2, 2)) == (0, 3, -2, 6, -2, 9)
    with pytest.raises(ValueError, match="guard 4"):
        check_bounds((-5, 5, 0, 7), (5, 7), (4, 4))


def test_mask_to_interior_keeps_the_box():
    val = torch.ones(12, 14)
    band_gemm.mask_to_interior(val, 6, 8, margin=3, bounds=(-2, 8, -4, 9))
    want = torch.zeros(12, 14)
    want[1:11, 0:12] = 1
    assert torch.equal(val, want)
    val = torch.ones(12, 14)
    assert torch.equal(band_gemm.mask_to_interior(val.clone(), 6, 8, margin=3),
                       band_gemm.mask_to_interior(val, 6, 8, margin=3, bounds=(0, 6, 0, 8)))
