"""The strip walk's reach over 2-D passes (csrc/plan2d.cu at depth 4 and
radius 5-8; ``stencil2d_skew_step`` on the walk): which kernel each launch of
a pass runs and how a pass splits into launches (``stencil2d._one_kind``,
``stencil2d._split_pass``, ``stencil2d.launch_depths``), the host plan the
radius 5-8 instances receive, the values of the new splits, and the port's
engine against the JAX engine on the wide-radius plans.  CPU only: the
launches are replaced by fake entries or by the plain twins; the kernels
themselves are held against their twins and the kernels they replace on the
card (tests/test_torch_cuda.py and chip_smoke.py phase 29).

Tolerances: the routing and split tests none (the twins stand in for the
kernels, so a split pass equals the unsplit twin bit for bit on the integer
fill); the engine parity tests the existing float32 parity tolerance of
tests/torch_custom_common.py (1e-5 of the largest value, floored at 1) and,
for bfloat16, the tier's 7e-3 of the largest value after 4 steps
(tests/torch_bf16_common.py's rule)."""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.band_gemm import plan_array
from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d, guard_2d

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
DTYPES = (F32, BF16, F64)


def _spec(R, n_terms, n_res, seed=0, integer=False):
    """A radius-R plan of ``n_terms`` two-axis terms and ``n_res`` residue
    points (at the corners and edges of the radius), random taps (integers
    in [-3, 3] where ``integer``)."""
    rng = np.random.default_rng(seed + 100 * R)
    W = 2 * R + 1

    def taps():
        t = rng.integers(-3, 4, W) if integer else rng.standard_normal(W)
        t = t.astype(np.float64)
        t[R] = 1.0
        return tuple(float(v) for v in t)

    offsets = ((-R, R), (R, -R + 1), (0, R), (R - 1, 0), (-1, -R))[:n_res]
    return StencilSpec(
        name=f"r{R} x{n_terms}+{n_res}", ndim=2, radius=R, halo=(R, R),
        terms=tuple(SeparableTerm(taps=(taps(), taps())) for _ in range(n_terms)),
        residue=tuple((off, float(rng.integers(1, 4))) for off in offsets),
        fuse_factor=1)


# the deepest plan strip launch: float32 4 at radius 1-4 and 2 at 5-8,
# bfloat16 4 (it rounds once a launch), float64 2; none at radius 9
WALK = {F32: lambda R: 4 if R <= 4 else 2, BF16: lambda R: 4, F64: lambda R: 2}


def _tile_split(kind, spec, dtype, k):
    kmax = stencil2d.max_fused_steps(kind, spec.radius, stencil2d.plan_len(spec), dtype)
    return [kmax] * (k // kmax) + ([k % kmax] if k % kmax else [])


def _f64_tile(spec, depth):
    """The measured float64 exception: a block of fewer than 3 warps."""
    warps = min(8, stencil2d.MAX_SMEM // stencil2d.plan_warp_bytes(spec, F64, depth))
    return warps < 3


def _expected(family, kind, R, k, dtype):
    """The launches (kind, depth) of a pass, written from the rule: a
    float32 or float64 pass whose single step the strip walk takes runs as
    k single launches (the strip kernel's where it takes the spec, ``few``
    at radius 1-4, else the plan strip kernel's); a float64 plan strip
    launch of fewer than 3 warps a block, and every launch at radius 9,
    keeps the tile kernels and their split; a bfloat16 pass keeps the tile
    kernels' split, each launch of depth <= 4 on the plan strip kernel
    (strip kernel for a ``few`` single step) and deeper ones on the tile
    kernels."""
    spec = _spec(R, 2 if family == "few" else 4, 3)

    def tile(depths):
        return [("step" if d == 1 else kind, d) for d in depths]

    if R > 8:
        return tile(_tile_split(kind, spec, dtype, k))
    few = family == "few" and R <= 4
    if dtype != BF16:
        if few:
            return [("strip", 1)] * k
        if dtype == F64 and _f64_tile(spec, 1):
            return tile(_tile_split(kind, spec, dtype, k))
        return [("plan_strip", 1)] * k
    out = []
    for d in _tile_split(kind, spec, dtype, k):
        if d == 1 and few:
            out.append(("strip", 1))
        elif d <= 4:
            out.append(("plan_strip", d))
        else:
            out.append(("step" if d == 1 else kind, d))
    return out


@pytest.mark.parametrize("R", range(1, 10))
@pytest.mark.parametrize("kind", ["step", "skew"])
@pytest.mark.parametrize("family", ["plan", "few"])
def test_rule_table(family, kind, R, monkeypatch):
    """Each wrapper's pass at radius 1-9, depth 1-6 (the skew wrapper from
    2), in each dtype: the launches ``_split_pass`` makes and the kernel
    ``_one_kind`` names for each, against the rule written out
    (``_expected``).  No launch of radius <= 8 names the step or skew kernel
    unless it is a bfloat16 launch deeper than 4 or a float64 launch the
    card measured faster there (``tile_beats_plan``); every radius-9 launch
    does.  Every launch is counted on the wrapper of its pass.  A float32 or
    float64 pass on the walk splits into launches of at most the walk's
    depth (``launch_depths``); a bfloat16 pass keeps the tile kernel's
    split."""
    spec = _spec(R, 2 if family == "few" else 4, 3)
    launched, wrappers = [], set()

    def fake_launch(kind_, buffers, spec_, layout, depth, bounds=None, wrapper=None):
        launched.append((kind_, depth))
        wrappers.add(wrapper)

    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    for dtype in DTYPES:
        for k in range(2 if kind == "skew" else 1, 7):
            lay = Layout2D(interior=(40, 60), halo=spec.halo, tile=default_tile_2d(40, 60),
                           guard=guard_2d(spec.halo, k * R))
            x = torch.zeros(lay.shape, dtype=dtype)
            launched.clear()
            stencil2d._split_pass(kind, x, torch.zeros_like(x), spec, lay, k)
            assert launched == _expected(family, kind, R, k, dtype), (dtype, k)
            for name, depth in launched:
                assert stencil2d._ENTRIES[name][dtype]
                assert stencil2d._one_kind(kind, spec, dtype, depth) == name
                old = (R > 8 or (dtype == BF16 and depth > 4)
                       or (dtype == F64 and _f64_tile(spec, depth)))
                assert (name in ("step", "skew")) == old, (dtype, k, name, depth)
            depths = stencil2d.launch_depths(kind, spec, dtype, k)
            if dtype == F32 and R <= 8:
                assert max(depths) == min(k, WALK[F32](R))
            elif dtype == BF16:  # the tile kernel's split: it rounds a launch
                assert depths == _tile_split(kind, spec, dtype, k)
    assert wrappers == {stencil2d.stencil2d_skew_step if kind == "skew"
                        else stencil2d.stencil2d_step}


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_strip_rule_at_wide_radii_follows_shared_memory(dtype):
    """At radius 5-8 the rule takes depths 1-2 (bfloat16 1-4) where a warp's
    shared memory (``plan_warp_bytes``, the kernel's plan_warp_bytes) fits a
    block's, at most 9 terms and 81 residue points, and refuses the rest."""
    for R in (5, 6, 7, 8):
        for depth in range(1, 6):
            for n_terms in (1, 4, 9):
                spec = _spec(R, n_terms, 2)
                fits = stencil2d.plan_warp_bytes(spec, dtype, depth) <= stencil2d.MAX_SMEM
                want = depth in ((1, 2, 3, 4) if dtype == BF16 else (1, 2)) and fits
                assert stencil2d.plan_strip_takes(spec, dtype, depth) == want
    # the input ring, a level ring and the column convs of one term at R = 8:
    # 32 rows of 148 cells, 32 rows, 18 rows x 32 lanes x 4 cells
    spec = _spec(8, 1, 0)
    cell = dtype.itemsize
    comp = 8 if dtype == F64 else 4
    assert stencil2d.plan_warp_bytes(spec, dtype, 2) == (
        32 * 148 * cell + 32 * 148 * comp + 2 * 18 * 128 * comp)
    many = StencilSpec(name="many", ndim=2, radius=5, halo=(5, 5),
                       terms=_spec(5, 10, 0).terms, residue=(), fuse_factor=1)
    assert not stencil2d.plan_strip_takes(many, dtype, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1000, 1024, 1056, 2048])
def test_one_term_wide_step_runs_the_walk_at_any_size(n, dtype, monkeypatch):
    """A step of one term and no residue at radius 5 runs the plan strip
    kernel at any grid size, the small ones too (the card measured the tile
    kernel about 7 us a step faster at 1024^2 and below, PERF.md; no rule
    keeps it there): the route depends on the spec, the dtype and the depth
    alone, and so does a region's launch."""
    box = StencilSpec(name="box r5", ndim=2, radius=5, halo=(5, 5),
                      terms=(SeparableTerm(taps=((1.0,) * 11, (1.0,) * 11)),),
                      residue=(), fuse_factor=1)
    lay = Layout2D(interior=(n, n), halo=box.halo, tile=(32, 128),
                   guard=guard_2d(box.halo, 5))
    launched = []
    monkeypatch.setattr(stencil2d, "_launch",
                        lambda kind_, buffers, spec_, layout, depth, bounds=None, **_:
                        launched.append(kind_))
    x = torch.zeros(lay.shape, dtype=dtype)
    stencil2d._split_pass("step", x, torch.zeros_like(x), box, lay, 1)
    assert launched == ["plan_strip"]
    with_point = StencilSpec(name="box r5 + point", ndim=2, radius=5, halo=(5, 5),
                             terms=box.terms, residue=(((5, -5), 2.0),), fuse_factor=1)
    assert stencil2d._one_kind("step", with_point, dtype, 1) == "plan_strip"
    assert stencil2d._one_kind("step", _spec(4, 1, 0), dtype, 1) == "strip"


@pytest.mark.parametrize("R", [5, 6, 7, 8])
@pytest.mark.parametrize("dtype,entry,width", [
    (F32, "ls_stencil2d_plan_strip", ctypes.c_float),
    (F64, "ls_stencil2d_plan_strip_f64", ctypes.c_double),
    (BF16, "ls_stencil2d_plan_strip_bf16", ctypes.c_float),
])
@pytest.mark.parametrize("pass_", ["step", "skew"])
def test_wide_radius_launch_passes_the_host_plan(pass_, dtype, entry, width, R, monkeypatch):
    """A radius 5-8 launch hands its dtype's entry plan_array's table in the
    compute dtype from host memory, byte for byte, with the pass's radius,
    counts and depth, and counts one launch on the wrapper it is given (that
    of its pass: ``stencil2d_step`` or ``stencil2d_skew_step``)."""
    seen = {}

    def call(cur, donor, plan, plan_len, *rest):
        seen["plan"] = bytes((width * plan_len).from_address(plan))
        seen["ints"] = rest[:20]
        return 0

    lib = types.SimpleNamespace(**{entry: call})
    monkeypatch.setattr(stencil2d, "_plan_lib", lambda: lib)
    monkeypatch.setattr(stencil2d, "_plan_lib_bf16", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    spec = _spec(R, 3, 5, seed=1)
    depth = 2
    lay = Layout2D(interior=(40, 70), halo=spec.halo, tile=default_tile_2d(40, 70),
                   guard=guard_2d(spec.halo, depth * R))
    x = torch.zeros(lay.shape, dtype=dtype)
    wrapper = (stencil2d.stencil2d_skew_step if pass_ == "skew"
               else stencil2d.stencil2d_step)
    attr = {F64: "launches_f64", BF16: "launches_bf16"}.get(dtype, "launches")
    before = (getattr(wrapper, attr), wrapper.launches_plan_strip, wrapper.launches_tile)
    stencil2d._launch("plan_strip", (x, torch.zeros_like(x)), spec, lay, depth,
                      wrapper=wrapper)
    assert (getattr(wrapper, attr) - before[0], wrapper.launches_plan_strip - before[1],
            wrapper.launches_tile - before[2]) == (1, 1, 0)
    want = plan_array(spec, F64 if dtype == F64 else F32).numpy().tobytes()
    assert seen["plan"] == want
    rows, pitch = lay.shape
    assert seen["ints"][:4] == (len(spec.terms), R, len(spec.residue), rows)
    assert seen["ints"][11] == depth


def _interior(x, lay):
    (r0, c0), (m, n) = lay.origin, lay.interior
    return x[r0:r0 + m, c0:c0 + n]


@pytest.mark.parametrize("k", [5, 6])
@pytest.mark.parametrize("kind", ["step", "skew"])
@pytest.mark.parametrize("R,n_terms", [(2, 4), (2, 2), (5, 1), (7, 4)])
def test_deep_float32_pass_splits_with_the_same_values(R, n_terms, kind, k, monkeypatch):
    """A float32 pass of k = 5 and 6, extent and skew, split as the rule
    splits it (launches of at most the walk's depth, or single strip
    launches), each launch replaced by the twin: equal to the unsplit twin
    bit for bit on the integer fill."""
    spec = _spec(R, n_terms, 3, seed=2, integer=True)
    lay = Layout2D(interior=(37, 45), halo=spec.halo, tile=default_tile_2d(37, 45),
                   guard=guard_2d(spec.halo, k * R))
    g = np.random.default_rng(5).integers(0, 2, lay.shape).astype(np.float32)
    x = torch.from_numpy(g)
    launched = []

    def fake_launch(kind_, buffers, spec_, layout, depth, bounds=None, **_):
        launched.append((kind_, depth))
        stencil2d.stencil2d_step_plain(*buffers, spec_, layout, depth, bounds)

    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    got = stencil2d._split_pass(kind, x, torch.zeros_like(x), spec, lay, k)
    assert launched == _expected("few" if n_terms <= 3 else "plan", kind, R, k, F32)
    assert len(launched) > 1
    want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k)
    torch.testing.assert_close(_interior(got, lay), _interior(want, lay), rtol=0, atol=0)


# -- the port's engine against the JAX engine on the wide-radius plans ------------
def _coeffs(name):
    """A seeded 17x17 of rank 4, or an 11x11 of rank 3 and two points off
    it, of positive factors, scaled to a sum of 1: a step amplifies and
    cancels nothing, so float32's rounding stays at its own scale."""
    rng = np.random.default_rng(17 if name == "17x17" else 11)
    n, rank = (17, 4) if name == "17x17" else (11, 3)
    S = sum(np.outer(rng.uniform(0.1, 1.0, n), rng.uniform(0.1, 1.0, n))
            for _ in range(rank))
    if name == "11x11":
        S[0, 10] += 2.0
        S[7, 2] -= 1.5
    return S / S.sum()


JAX_F32_TOL = 1e-5  # tests/torch_custom_common.py TOL["float32"]
BF16_TIER_TOL = 7e-3  # the bfloat16 tier's, after 4 steps


@pytest.mark.parametrize("kw", [{"fused_steps": 1}, {"fused_steps": 2},
                                {"fused_steps": 2, "fusion": "skew"}],
                         ids=["k1", "k2", "skew-k2"])
@pytest.mark.parametrize("name", ["11x11", "17x17"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_radius_engine_matches_jax(name, dtype, kw):
    """``for_coeffs`` of a seeded 11x11 (rank 3 and two points) and a 17x17
    of rank 4 at a small interior, at fused_steps 1 and 2 and under
    fusion='skew' k = 2: the port's run on the CPU within float32's parity
    tolerance (bfloat16: the tier's 7e-3 of the largest value after 4 steps)
    of the JAX engine's run (interpret mode)."""
    import jax.numpy as jnp

    from lorastencil_tpu import engine as jax_engine
    from lorastencil_tpu_torch import convert, engine
    from lorastencil_tpu_torch.utils import reference

    S = _coeffs(name)
    interior = (24, 136)
    peng = engine.StencilEngine.for_coeffs(S, interior, device="cpu", dtype=dtype, **kw)
    jeng = jax_engine.StencilEngine.for_coeffs(S, interior, dtype=dtype, **kw)
    assert peng.spec == convert.spec_from_jax(jeng.spec)
    assert peng.spec.radius == (8 if name == "17x17" else 5)
    assert 1 <= len(peng.spec.terms) <= stencil2d.PLAN_MAX_TERMS
    assert peng._fused_k() == jeng._fused_k() == kw["fused_steps"]
    assert stencil2d.plan_strip_takes(peng.spec, peng.dtype, kw["fused_steps"])
    g0 = reference.random_padded(peng.spec, interior, seed=3)
    steps = 4
    got = peng.run(g0, steps).double().numpy()
    jin = jnp.asarray(g0, jnp.float32)
    want = np.asarray(jeng.run(jin, steps).astype(jnp.float32), np.float64)
    scale = max(1.0, np.abs(want).max()) if dtype == "float32" else np.abs(want).max()
    tol = JAX_F32_TOL if dtype == "float32" else BF16_TIER_TOL
    assert np.abs(got - want).max() / scale <= tol
