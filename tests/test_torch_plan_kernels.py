"""The plan strip kernel (csrc/plan2d.cu) and the plan march kernel
(csrc/plan3d.cu): which launches the wrappers send them
(``stencil2d.plan_strip_takes``, ``stencil2d.strips_beat_plan``,
``stencil3d.plan_march_takes``), the host side of their launches (the entry
of each dtype, the plan in host memory, the counters).  CPU only, no JAX:
the launches are replaced by fake entries or by the plain twins; the
kernels themselves are held against their twins and the kernels they
replace on the card (tests/test_torch_cuda.py and chip_smoke.py phase 28).
Tolerance: none (the twins stand in for the kernels, so a pass equals the
unsplit twin bit for bit)."""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import StencilSpec, get_shape
from lorastencil_tpu_torch.ops import stencil2d, stencil3d
from lorastencil_tpu_torch.ops.band_gemm import plan_array
from lorastencil_tpu_torch.ops.layout import (Layout2D, Layout3D, check_bounds,
                                              default_tile_2d, default_tile_3d,
                                              guard_2d, guard_3d)
from lorastencil_tpu_torch.utils import reference

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


def _coeffs_spec(S):
    return engine.StencilEngine.for_coeffs(S, (8,) * S.ndim, device="cpu").spec


def _rank(R, n, seed=0):
    rng = np.random.default_rng(seed)
    W = 2 * R + 1
    return _coeffs_spec(sum(np.outer(rng.standard_normal(W), rng.standard_normal(W))
                            for _ in range(n)))


ASYM = _coeffs_spec(np.random.default_rng(43).standard_normal((5, 5)))  # 3 terms, 4 points
RANK4 = _rank(4, 4, seed=15)  # the 9x9 of rank 4: 4 terms, no residue


def _with_terms(spec, n):
    """``spec`` with its terms repeated to ``n``."""
    terms = (spec.terms * n)[:n]
    return StencilSpec(name=f"{spec.name} x{n}", ndim=spec.ndim, radius=spec.radius,
                       halo=spec.halo, terms=terms, residue=spec.residue, fuse_factor=1)


# -- (a) the 2-D rule ------------------------------------------------------------
@pytest.mark.parametrize("spec,dtype,depth,want", [
    (get_shape("star2d1r"), F32, 1, False),   # the strip kernel: the main path
    (get_shape("star2d1r"), F32, 2, True),    # residue: the fused strip refuses
    (get_shape("star2d1r"), BF16, 3, True),
    (get_shape("star2d1r"), F64, 2, True),
    (get_shape("star2d1r"), F64, 3, False),   # float64: depth 1-2
    (get_shape("star2d1r"), F32, 4, True),    # depth 4 in float32 and bf16
    (get_shape("star2d1r"), BF16, 4, True),
    (get_shape("star2d1r"), F32, 5, False),   # deeper: launches of at most 4
    (get_shape("star2d3r"), F32, 2, False),   # the fused strip kernel
    (get_shape("star2d3r"), BF16, 2, False),
    (get_shape("star2d3r"), F32, 3, True),
    (get_shape("star2d3r"), F64, 2, True),
    (get_shape("box2d3r"), F32, 1, False),    # three terms: the strip kernel
    (get_shape("box2d3r"), F32, 2, True),
    (ASYM, F32, 1, False),
    (ASYM, F32, 2, True),
    (ASYM, BF16, 2, True),
    (ASYM, F64, 2, True),
    (ASYM, F64, 3, False),                    # float64: depth 1-2
    (RANK4, F32, 1, True),                    # four terms
    (RANK4, F64, 1, True),
    (RANK4, F64, 2, True),
    (RANK4, BF16, 1, True),
    (RANK4, F32, 3, True),
    (RANK4, BF16, 3, True),
    (RANK4, torch.float16, 1, False),
    (_with_terms(RANK4, 9), F32, 1, True),
    (_with_terms(RANK4, 10), F32, 1, False),  # past kPlanMaxTerms
    (_rank(5, 4), F32, 1, True),              # radius 5-8: depth 1-2
    (_rank(8, 4), F64, 2, True),
    (_rank(5, 4), F32, 3, False),
    (_rank(8, 1), BF16, 4, True),             # bf16 to depth 4: one rounding
    (_rank(9, 4), F32, 1, False),             # radius 9: the tile kernel
])
def test_plan_strip_rule(spec, dtype, depth, want):
    assert stencil2d.plan_strip_takes(spec, dtype, depth) == want
    if want:
        assert not stencil2d.strip_takes(spec, dtype, depth)
        assert not stencil2d.fused_strip_takes(spec, dtype, depth)


@pytest.mark.parametrize("name", ["star2d1r", "box2d1r", "box2d3r", "star2d3r"])
@pytest.mark.parametrize("dtype", [F32, F64, BF16])
def test_main_path_routes_do_not_move(name, dtype):
    """Every registry shape's single step stays on the strip kernel and
    star2d3r's k = 2 pass (float32, bf16) on the fused strip kernel."""
    spec = get_shape(name)
    assert stencil2d._one_kind("step", spec, dtype, 1) == "strip"
    if name == "star2d3r" and dtype != F64:
        assert stencil2d._one_kind("step", spec, dtype, 2) == "fused_strip"
        assert stencil2d._one_kind("skew", spec, dtype, 2) == "fused_strip"


@pytest.mark.parametrize("spec,dtype,depth,want", [
    (RANK4, F32, 1, "plan_strip"),
    (RANK4, F64, 1, "plan_strip"),
    (ASYM, F32, 2, "plan_strip"),
    (ASYM, F32, 4, "plan_strip"),             # depth 4
    (ASYM, BF16, 5, "step"),                  # a bf16 launch past 4: the tile kernel
    (get_shape("star2d1r"), BF16, 3, "plan_strip"),
    (_rank(5, 4), F32, 1, "plan_strip"),
    (_rank(9, 4), F32, 1, "step"),
])
def test_one_kind_sends_the_plan_strip_kernel_its_launches(spec, dtype, depth, want):
    assert stencil2d._one_kind("step", spec, dtype, depth) == want
    # a skewed launch takes the same kernel (counted on the skew wrapper by
    # _split_pass); past the walk's reach the skew kernel
    skew = stencil2d._one_kind("skew", spec, dtype, depth)
    if want != "step":
        assert skew == want
    else:
        assert skew == ("step" if depth == 1 else "skew")
    assert stencil2d._ENTRIES[want][dtype] and stencil2d._ENTRIES[skew][dtype]


def _layout(spec, interior, k):
    return Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, k * spec.radius))


def _ring_case(spec, dtype, k, box):
    """(layout, 0/1 fill, bounds, refresh) of a pass over a 37 x 45 interior:
    ``box`` "none" keeps no ring, "ghost" a periodic ring of depth k r that
    ``refresh`` refills (the engine's), "shard" a ring no refresh refills (a
    shard's exchanged ring)."""
    lay = _layout(spec, (37, 45), k)
    x = lay.to_internal(reference.random_padded(spec, (37, 45), seed=4) % 2, dtype)
    if box == "none":
        return lay, x, None, None
    d = k * spec.radius
    bounds = (-d, 37 + d, -d, 45 + d)
    if box == "shard":
        return lay, x, bounds, None

    def refresh(state):
        return engine._ring_refresh_nd(state, "periodic", lay.origin, lay.interior, d)
    return lay, refresh(x), bounds, refresh


@pytest.mark.parametrize("box", ["none", "ghost", "shard"])
@pytest.mark.parametrize("spec,dtype,k", [
    (ASYM, F32, 2), (ASYM, F64, 2), (get_shape("star2d1r"), F32, 3),
    (get_shape("box2d3r"), F32, 2), (ASYM, BF16, 2), (RANK4, F32, 2)])
def test_split_pass_routing_rule(spec, dtype, k, box, monkeypatch):
    """A float32 or float64 pass the plan strip kernel would take runs as k
    single launches -- strip launches on a spec whose single steps the strip
    kernel takes, else (four terms) single plan strip launches -- where it
    keeps no ring or a refreshed ghost ring, else (a shard's ring) one plan
    strip launch; a bf16 pass stays one launch.  Each launch replaced by the twin, the
    pass equals the unsplit twin on the interior (a periodic ring: the
    refresh gives the ring cells the values the fused levels compute there;
    a refreshed buffer keeps its ring, which the next pass's refresh
    rewrites)."""
    lay, x, bounds, refresh = _ring_case(spec, dtype, k, box)
    kinds = []

    def fake_launch(kind_, buffers, spec_, layout, depth, bounds_=None, **_):
        kinds.append((kind_, depth))
        stencil2d.stencil2d_step_plain(*buffers, spec_, layout, depth, bounds_)

    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    got = stencil2d._split_pass("step", x, torch.zeros_like(x), spec, lay, k, bounds,
                                refresh)
    split = dtype != BF16
    assert stencil2d.strips_beat_plan(spec, dtype, k) == split
    single = "strip" if stencil2d.strip_takes(spec, dtype) else "plan_strip"
    split = split and box != "shard"
    assert kinds == ([(single, 1)] * k if split else [("plan_strip", k)])
    want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k, bounds)
    torch.testing.assert_close(_interior(got, lay), _interior(want, lay), rtol=0, atol=0)


def _interior(x, lay):
    (r0, c0), (m, n) = lay.origin, lay.interior
    return x[r0:r0 + m, c0:c0 + n]


@pytest.mark.parametrize("box", ["ring", "refreshed ring", "interior"])
def test_a_pass_that_keeps_a_ring_is_not_split(box, monkeypatch):
    """A pass whose bounds keep a ring that no refresh refills (a shard's
    exchanged ring) stays one plan strip launch: a split would lose the ring
    between the steps.  A ghost ring that ``refresh`` refills (once, between
    the two launches), or a box that is the interior (no ring), splits."""
    spec = get_shape("star2d1r")
    lay, x, bounds, refresh = _ring_case(spec, F32, 2,
                                         "shard" if box == "ring" else "ghost")
    if box == "interior":
        bounds, refresh = (0, 37, 0, 45), None
    kinds, refreshed = [], []

    def fake_launch(kind_, buffers, spec_, layout, depth, bounds_=None, **_):
        kinds.append((kind_, depth))
        stencil2d.stencil2d_step_plain(*buffers, spec_, layout, depth, bounds_)

    def counted(state):
        refreshed.append(state)
        return refresh(state)

    monkeypatch.setattr(stencil2d, "_launch", fake_launch)
    got = stencil2d._split_pass("step", x, torch.zeros_like(x), spec, lay, 2, bounds,
                                refresh and counted)
    assert kinds == ([("plan_strip", 2)] if box == "ring" else [("strip", 1)] * 2)
    assert len(refreshed) == (box == "refreshed ring")
    want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, 2, bounds)
    torch.testing.assert_close(_interior(got, lay), _interior(want, lay), rtol=0, atol=0)


@pytest.mark.parametrize("extra", [0, 1])
def test_split_pass_spare_buffer_zeroes_its_ring_only(extra, monkeypatch):
    """The spare buffer of a split pass: every cell outside the rounded
    interior (the guard ring, extra row tiles) zero, the rounded interior
    left to the launches, which write all of it."""
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: torch.full(t.shape, float("nan"), dtype=t.dtype))
    spec = get_shape("star2d1r")
    lay = Layout2D(interior=(37, 45), halo=spec.halo, tile=(32, 128),
                   guard=guard_2d(spec.halo, 2 * spec.radius), extra_row_tiles=extra)
    spare = stencil2d._spare_like(torch.zeros(lay.shape), lay)
    (r0, c0), (mr, nr) = lay.origin, lay.rounded
    inside = torch.zeros(lay.shape, dtype=torch.bool)
    inside[r0:r0 + mr, c0:c0 + nr] = True
    assert bool(spare[inside].isnan().all())
    assert bool((spare[~inside] == 0).all())


def test_region_pass_is_one_plan_strip_launch():
    """A pass over a region is one launch of the kernel ``_one_kind`` names
    whatever the routing rule (a split pass could not keep a window): the
    wrapper's region branch launches it directly, never through
    ``_split_pass``."""
    spec = get_shape("star2d1r")
    assert stencil2d.strips_beat_plan(spec, F32, 2)
    assert stencil2d._one_kind("step", spec, F32, 2) == "plan_strip"
    assert stencil2d.launch_depths("step", spec, F32, 2) == [2]


# -- (b) the 3-D rule ---------------------------------------------------------------
PER_PLANE = _coeffs_spec(np.random.default_rng(5).standard_normal((3, 3, 3)))


def _star3d(r):
    d = {2: (-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12),
         4: (-1 / 560, 8 / 315, -1 / 5, 8 / 5, -205 / 72, 8 / 5, -1 / 5, 8 / 315,
             -1 / 560)}[r]
    S = np.zeros((2 * r + 1,) * 3)
    for axis in range(3):
        for i, w in enumerate(d):
            idx = [r, r, r]
            idx[axis] = i
            S[tuple(idx)] += 0.1 * w
    S[r, r, r] += 1.0
    return _coeffs_spec(S)


STAR4 = _star3d(4)


@pytest.mark.parametrize("spec,dtype,depth,want", [
    (get_shape("star3d1r"), F32, 2, False),   # the march kernel: the main path
    (get_shape("box3d1r"), F64, 1, False),
    (get_shape("star3d1r"), F32, 3, False),   # deeper: the general kernel
    (PER_PLANE, F32, 2, True),                # 6 terms and 3 residue points
    (PER_PLANE, F64, 1, True),
    (PER_PLANE, BF16, 2, True),
    (PER_PLANE, F32, 3, False),
    (_star3d(2), F32, 2, True),
    (STAR4, F32, 2, True),                    # two terms, 8 points along z
    (STAR4, torch.float16, 2, False),
])
def test_plan_march_rule(spec, dtype, depth, want):
    assert stencil3d.plan_march_takes(spec, dtype, depth) == want
    if want:
        assert stencil3d.launch_depths(spec, dtype, depth) == [depth]


def test_plan_march_rule_refuses_radius_and_size():
    big = StencilSpec(name="big", ndim=3, radius=1, halo=(1, 1, 1),
                      terms=PER_PLANE.terms * 3, residue=(), fuse_factor=1)
    assert len(big.terms) == 18 and not stencil3d.plan_march_takes(big, F32, 1)
    many = StencilSpec(name="many", ndim=3, radius=1, halo=(1, 1, 1), terms=(),
                       residue=tuple(((a, b, c), 1.0) for a in (-1, 0, 1)
                                     for b in (-1, 0, 1) for c in (-1, 0, 1)) * 2,
                       fuse_factor=1)
    assert not stencil3d.plan_march_takes(many, F32, 1)
    zero = StencilSpec(name="zero", ndim=3, radius=0, halo=(0, 0, 0),
                       terms=(), residue=(((0, 0, 0), 2.0),), fuse_factor=1)
    assert not stencil3d.plan_march_takes(zero, F32, 1)


def _layout3(spec, interior, k):
    return Layout3D(interior=interior, halo=spec.halo,
                    tile=default_tile_3d(*interior[1:]),
                    guard=guard_3d(spec.halo, k * spec.radius))


@pytest.mark.parametrize("spec,dtype,k,kernel", [
    (get_shape("star3d1r"), F32, 2, "march"),
    (PER_PLANE, F32, 2, "plan"),
    (PER_PLANE, F64, 1, "plan"),
    (STAR4, F32, 2, "plan"),
    (get_shape("star3d1r"), F32, 4, "general"),
])
def test_kernel_pass_launches_the_plan_march_kernel_by_the_rule(spec, dtype, k, kernel,
                                                                monkeypatch):
    """stencil3d_step's pass on the card: the march kernel, the plan march
    kernel or the general kernel by the rules, one launch each; each launch
    replaced by the twin, the pass equals the twin."""
    interior = (6, 20, 40)
    lay = _layout3(spec, interior, k)
    x = lay.to_internal(reference.random_padded(spec, interior, seed=4) % 2, dtype)
    launched = []

    def fake(name):
        def call(cur, out, spec_, layout, depth, *rest):
            launched.append((name, depth))
            box = rest[-1] if name != "general" else rest[1]
            return stencil3d.stencil3d_step_plain(cur, out, spec_, layout, depth, box)
        return call

    monkeypatch.setattr(stencil3d, "_launch_march", fake("march"))
    monkeypatch.setattr(stencil3d, "_launch_plan_march", fake("plan"))
    monkeypatch.setattr(stencil3d, "_launch", fake("general"))
    monkeypatch.setattr(stencil3d, "plan_pass", lambda spec_, depth, itemsize: (depth,
                                                                                 (32, 64)))
    got = stencil3d._kernel_pass(x, torch.zeros_like(x), spec, lay, k)
    assert launched == [(kernel, k)]
    want = stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, k)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- (c) the launches' host side ------------------------------------------------------
def _fake_entry(seen, name, width, ints):
    def call(cur, donor, plan, plan_len, *rest):
        seen[name] = (list((width * plan_len).from_address(plan)), rest[:ints])
        return 0
    return call


@pytest.mark.parametrize("dtype,entry,width", [
    (F32, "ls_stencil2d_plan_strip", ctypes.c_float),
    (F64, "ls_stencil2d_plan_strip_f64", ctypes.c_double),
    (BF16, "ls_stencil2d_plan_strip_bf16", ctypes.c_float),
])
def test_plan_strip_launch_passes_the_host_plan_and_counts(dtype, entry, width,
                                                           monkeypatch):
    """A plan strip launch hands its dtype's entry (csrc/plan2d.cu, or the
    bfloat16 build) plan_array's table in the compute dtype from host memory
    and the pass's ints in LS_ENTRY's order, and counts one launch of the
    dtype and one in launches_plan_strip."""
    seen = {}
    lib = types.SimpleNamespace(**{entry: _fake_entry(seen, entry, width, 20)})
    monkeypatch.setattr(stencil2d, "_plan_lib", lambda: lib)
    monkeypatch.setattr(stencil2d, "_plan_lib_bf16", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    spec = ASYM
    lay = _layout(spec, (40, 70), 2)
    x = torch.zeros(lay.shape, dtype=dtype)
    step = stencil2d.stencil2d_step
    attr = {F64: "launches_f64", BF16: "launches_bf16"}.get(dtype, "launches")
    before = (getattr(step, attr), step.launches_plan_strip, step.launches_k1)
    stencil2d._launch("plan_strip", (x, torch.zeros_like(x)), spec, lay, 2)
    assert (getattr(step, attr) - before[0], step.launches_plan_strip - before[1],
            step.launches_k1 - before[2]) == (1, 1, 0)
    plan, ints = seen[entry]
    want = plan_array(spec, F64 if dtype == F64 else F32)
    assert plan == want.tolist()
    rows, pitch = lay.shape
    mr, nr = lay.rounded
    assert ints[:4] == (len(spec.terms), spec.radius, len(spec.residue), rows)
    assert ints[-4:] == (0, mr, 0, nr)


@pytest.mark.parametrize("dtype,entry,width", [
    (F32, "ls_stencil3d_plan_march", ctypes.c_float),
    (F64, "ls_stencil3d_plan_march_f64", ctypes.c_double),
    (BF16, "ls_stencil3d_plan_march_bf16", ctypes.c_float),
])
def test_plan_march_launch_passes_the_host_plan_and_counts(dtype, entry, width,
                                                           monkeypatch):
    """A plan march launch hands its dtype's entry (csrc/plan3d.cu, or the
    bfloat16 build) the 3-D plan_array table from host memory and the 25
    ints of LS_PLAN_MARCH (counts, K, extents, origin, interior, rounded
    plane, the box, the window), and counts one launch of the dtype and one
    in launches_plan_march (and in launches_region over a window)."""
    seen = {}
    lib = types.SimpleNamespace(**{entry: _fake_entry(seen, entry, width, 25)})
    monkeypatch.setattr(stencil3d, "_plan_lib", lambda: lib)
    monkeypatch.setattr(stencil3d, "_plan_lib_bf16", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    spec = PER_PLANE
    lay = _layout3(spec, (6, 20, 40), 2)
    x = torch.zeros(lay.shape, dtype=dtype)
    w = stencil3d.stencil3d_step
    attr = {F64: "launches_f64", BF16: "launches_bf16"}.get(dtype, "launches")
    before = (getattr(w, attr), w.launches_plan_march, w.launches_march,
              w.launches_region)
    box = check_bounds(None, lay.interior, lay.guard)
    stencil3d._launch_plan_march(x, torch.zeros_like(x), spec, lay, 2, box, (0, 32, 0, 64))
    assert (getattr(w, attr) - before[0], w.launches_plan_march - before[1],
            w.launches_march - before[2], w.launches_region - before[3]) == (1, 1, 0, 1)
    plan, ints = seen[entry]
    assert plan == plan_array(spec, F64 if dtype == F64 else F32).tolist()
    nz, rows, pitch = lay.shape
    assert ints[:5] == (len(spec.terms), spec.radius, len(spec.residue), 2, nz)
    assert ints[-10:] == box + (0, 32, 0, 64)
