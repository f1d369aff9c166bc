"""The CUDA kernels (lorastencil_tpu_torch/csrc/stencil2d.cu, stencil3d.cu,
stencil1d.cu, and their float64 instances) on the card against their plain
PyTorch twins, at small sizes.  Needs an NVIDIA GPU
with nvcc (the kernels are built from source at first use); elsewhere every test
here skips.

    python -m pytest tests/test_torch_cuda.py -q -n 0 -m cuda --noconftest

Tolerances: the integer fill is exact (every partial sum is an integer below
2**24), so kernel and twin agree bit for bit at 1 and 2 steps.  On the pi/100
fill the 2-D kernel fuses each multiply-add and the twin rounds products
separately: rel <= 1e-6 of the largest value after 4 steps.  Every 3-D tap is a
power of two, so each product is exact and the 3-D kernel, which sums in its
twin's order, agrees with it bit for bit on any fill.  The 1-D kernels round each
product and sum on its own, in their twins' order: bit for bit on any fill.  So
do the float64 instances of the 2-D, 3-D and 1-D kernels (no FMA in fp64); the
fp64 engine paths hold 1e-13 of the fp64 ground truth after 4 steps."""

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec, get_shape
from lorastencil_tpu_torch.ops import stencil1d, stencil2d, stencil3d
from lorastencil_tpu_torch.ops.layout import (TILE_1D, Layout1D, Layout2D, Layout3D,
                                              default_tile_2d, default_tile_3d, guard_1d,
                                              guard_2d, guard_3d)
from lorastencil_tpu_torch.utils import reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def tiled_2d(monkeypatch):
    """The whole-grid runs off on the card, as LORASTENCIL_RESIDENT2D_KB=0 and
    LORASTENCIL_RESIDENT2D_PAIR_KB=0 turn them off: the tests of the tiled
    passes' launch counts on small 2-D grids, which the H100 default caps would
    otherwise run in one resident launch."""
    monkeypatch.setattr(stencil2d, "CUDA_RESIDENT_2D_BYTES", 0)
    monkeypatch.setattr(stencil2d, "CUDA_RESIDENT_PAIR_2D_BYTES", 0)


def _steps(step, cur, spec, lay, steps, k=1):
    def one(c, d, depth):
        return step(c, d, spec, lay, **({"fused_steps": depth} if depth > 1 else {}))

    return engine.ping_pong_loop(one, cur, steps, k)


@pytest.mark.parametrize("interior", [(96, 256), (100, 131), (37, 45)])
@pytest.mark.parametrize("name", ["star2d1r", "box2d1r", "star2d3r"])
def test_kernel_matches_plain_twin(cuda, name, interior):
    spec = get_shape(name)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                   guard=guard_2d(spec.halo, spec.radius))
    g0 = reference.random_padded(spec, interior, seed=3)
    for fill, steps_list in ((g0, (1, 2)), (g0 * (np.pi / 100), (4,))):
        x = lay.to_internal(fill, device=cuda)
        for steps in steps_list:
            got = _steps(stencil2d.stencil2d_step, x, spec, lay, steps)
            want = _steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
            torch.cuda.synchronize()
            if fill is g0:
                assert torch.equal(got, want)
                assert np.array_equal(lay.from_internal(got).cpu().numpy(),
                                      reference.run(g0, spec, steps))
            else:
                err = (got - want).abs().max().item()
                assert err <= 1e-6 * want.abs().max().item()


def test_engine_counts_its_launches(cuda, tiled_2d):
    eng = engine.StencilEngine.for_shape("star2d1r", (64, 200), device=cuda)
    g0 = reference.random_padded(eng.spec, (64, 200), seed=1)
    before = stencil2d.stencil2d_step.launches
    out = eng.run(g0, 3)
    assert stencil2d.stencil2d_step.launches - before == 3
    assert out.is_cuda
    want = reference.run(g0, eng.spec, 3)
    assert np.abs(out.cpu().numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_refused_launches_raise(cuda):
    spec = get_shape("star2d1r")
    lay = Layout2D(interior=(32, 128), halo=spec.halo, tile=(32, 128), guard=(4, 4))
    cur = torch.zeros(lay.shape, device=cuda)
    donor = torch.zeros(lay.shape, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stencil2d.stencil2d_step(cur.t().contiguous().t(), donor, spec, lay)
    wide = get_shape("star2d1r").__class__(
        name="wide", ndim=2, radius=129, halo=(4, 4), terms=(), residue=(), fuse_factor=1)
    with pytest.raises(ValueError, match="cap"):
        stencil2d.stencil2d_step(cur, donor, wide, lay)
    before = stencil2d.stencil2d_step.launches
    with pytest.raises(ValueError):
        stencil2d.stencil2d_step(cur, donor.cpu(), spec, lay)
    assert stencil2d.stencil2d_step.launches == before


# -- the strip kernel (float32, k = 1, radius 1-4): the tile kernel's sums ----------
def _custom_2d(R, n_terms, n_res, seed):
    """A 2-D spec of radius R with integer taps (zeros among them; the second
    term's row axis and the third's column axis the identity) and n_res
    residue points in no particular order."""
    rng = np.random.default_rng(seed)

    def taps():
        t = rng.integers(-3, 4, 2 * R + 1).astype(np.float64)
        t[rng.random(2 * R + 1) < 0.3] = 0.0
        return tuple(float(v) for v in t)

    terms = tuple(SeparableTerm(taps=(None if i == 1 else taps(), None if i == 2 else taps()))
                  for i in range(n_terms))
    residue = tuple(((int(a), int(b)), float(rng.integers(-3, 4) or 1))
                    for a, b in rng.integers(-R, R + 1, (n_res, 2)))
    return StencilSpec(name=f"custom_r{R}_t{n_terms}", ndim=2, radius=R, halo=(R, R),
                       terms=terms, residue=residue, fuse_factor=1)


STRIP_CASES = ["star2d1r", "box2d1r", "star2d3r", (1, 1, 3), (2, 2, 0), (4, 3, 9), (4, 0, 5)]


@pytest.mark.parametrize("guard", ["aligned", (5, 7)])
@pytest.mark.parametrize("interior", [(96, 256), (130, 131), (37, 45)])
@pytest.mark.parametrize("case", STRIP_CASES, ids=str)
def test_strip_kernel_equals_the_tile_kernel_on_any_fill(cuda, case, interior, guard):
    """The strip kernel (counted in launches_k1) against the tile kernel it
    replaces at k = 1: bit for bit on the integer, pi/100 and inf fills (NaN
    where it has NaN), both 16-byte and 4-byte staging; the integer fill also
    against the twin."""
    spec = get_shape(case) if isinstance(case, str) else _custom_2d(*case, seed=sum(case))
    assert stencil2d.strip_takes(spec, torch.float32)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                   guard=guard_2d(spec.halo, spec.radius) if guard == "aligned" else guard)
    g0 = reference.random_padded(spec, interior, seed=6)
    pi = g0 * (np.pi / 100)
    inf = pi.copy()
    inf.flat[inf.size // 3] = np.inf
    for fill in (g0, pi, inf):
        x = lay.to_internal(fill, device=cuda)
        before = (stencil2d.stencil2d_step.launches, stencil2d.stencil2d_step.launches_k1)
        got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay)
        assert (stencil2d.stencil2d_step.launches - before[0],
                stencil2d.stencil2d_step.launches_k1 - before[1]) == (1, 1)
        tile = torch.zeros_like(x)
        stencil2d._launch("step", (x, tile), spec, lay, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, tile, rtol=0, atol=0, equal_nan=True)
        if fill is g0:
            assert torch.equal(got, stencil2d.stencil2d_step_plain(
                x, torch.zeros_like(x), spec, lay))


def test_steps_beyond_the_strip_radii_run_the_tile_kernel(cuda):
    """A radius-5 step, beyond the strip kernel's radii: once the tile
    kernel's, now the plan strip kernel's radius-5 instance (counted in
    launches_plan_strip, none in launches_tile), equal to the tile kernel
    launched directly and to the twin."""
    spec = _custom_2d(5, 2, 4, seed=5)
    assert not stencil2d.strip_takes(spec, torch.float32)
    lay = Layout2D(interior=(70, 140), halo=spec.halo, tile=default_tile_2d(70, 140),
                   guard=guard_2d(spec.halo, spec.radius))
    x = lay.to_internal(reference.random_padded(spec, (70, 140), seed=2), device=cuda)
    step = stencil2d.stencil2d_step
    before = (step.launches, step.launches_k1, step.launches_plan_strip, step.launches_tile)
    got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay)
    torch.cuda.synchronize()
    assert (step.launches - before[0], step.launches_k1 - before[1],
            step.launches_plan_strip - before[2], step.launches_tile - before[3]) == (1, 0, 1, 0)
    assert torch.equal(got, stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay))
    tile = torch.zeros_like(x)
    stencil2d._launch("step", (x, tile), spec, lay, 1)
    assert torch.equal(got, tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,n,guard", [("r40", 100_000, None), ("r40", 5001, 43),
                                          ("1d2r", 1_000_000, None), ("1d1r", 3001, 9)])
def test_wide_pass_on_any_fill_tile_and_alignment(cuda, name, n, guard, dtype):
    """The wide pass at 256-cell tiles (100,000 and 5,001 cells) and 2048 (a
    million), staged by 16-byte copies or, off the 16-byte grid, cell by cell:
    bit for bit with its twin on the pi/100 fill and one holding an inf."""
    spec = _spec_1d(name)
    r = stencil1d.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=8) * (np.pi / 100)
    inf = g0.copy()
    inf.flat[n // 2] = np.inf
    for k in (1, 2, 3):
        lay = Layout1D(n, spec.halo[0], TILE_1D,
                       guard or guard_1d(spec.halo[0], k * r))
        if lay.guard < k * r:
            continue
        for fill in (g0, inf):
            x = lay.to_internal(fill, dtype, cuda)
            got = stencil1d.stencil1d_step(x, torch.zeros_like(x), spec, lay, fused_steps=k)
            want = stencil1d.stencil1d_step_plain(x, torch.zeros_like(x), spec, lay, k)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("interior", [(6, 20, 150), (37, 45, 130), (40, 64, 128)])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_3d_kernel_matches_plain_twin(cuda, name, interior, K):
    spec = get_shape(name)
    lay = Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(*interior[1:]),
                   guard=guard_3d(spec.halo, K * spec.radius))
    g0 = reference.random_padded(spec, interior, seed=3)
    for fill, steps_list in ((g0, (K, 2 * K)), (g0 * (np.pi / 100), (4,))):
        x = lay.to_internal(fill, device=cuda)
        for steps in steps_list:
            got = _steps(stencil3d.stencil3d_step, x, spec, lay, steps, K)
            want = _steps(stencil3d.stencil3d_step_plain, x, spec, lay, steps, K)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            if fill is g0 and steps <= 2:
                assert np.array_equal(lay.from_internal(got).cpu().numpy(),
                                      reference.run(g0, spec, steps))


@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_3d_engine_counts_its_launches(cuda, name):
    interior = (20, 40, 200)
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda)
    g0 = reference.random_padded(eng.spec, interior, seed=1)
    for steps, launches in ((2, 1), (3, 2), (5, 3)):
        before = stencil3d.stencil3d_step.launches
        out = eng.run(g0, steps)
        assert stencil3d.stencil3d_step.launches - before == launches
        assert out.is_cuda
        want = reference.run(g0, eng.spec, steps)
        assert np.abs(out.cpu().numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_3d_refused_launches_raise(cuda):
    spec = get_shape("star3d1r")
    lay = Layout3D(interior=(4, 32, 64), halo=spec.halo, tile=(32, 64), guard=(2, 4, 4))
    cur = torch.zeros(lay.shape, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stencil3d.stencil3d_step(cur.transpose(1, 2).contiguous().transpose(1, 2),
                                 torch.zeros_like(cur), spec, lay)
    before = stencil3d.stencil3d_step.launches
    with pytest.raises(ValueError):
        stencil3d.stencil3d_step(cur, torch.zeros(lay.shape), spec, lay)
    assert stencil3d.stencil3d_step.launches == before


# -- the march kernel (radius 1, K = 1-2, the registry's term mixes) ---------------
# It keeps the general 3-D kernel's per-cell sums, so the two agree bit for bit on any
# fill and any taps; with the registry's power-of-two taps both equal the twin bit
# for bit (the inf fill: NaN where the twin has NaN); float64 equals the twin on any
# taps.
def _3d_fills(g0):
    inf = g0 * (np.pi / 100)
    inf.flat[inf.size // 3] = np.inf
    return (g0, g0 * (np.pi / 100), inf)


def _general_3d(x, spec, lay, K):
    out = torch.zeros_like(x)
    stencil3d._launch(x, out, spec, lay, K, stencil3d.plan_pass(spec, K, x.element_size())[1])
    return out


@pytest.mark.parametrize("guard", ["aligned", (2, 5, 7)])
@pytest.mark.parametrize("interior", [(6, 20, 150), (37, 45, 130), (40, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_march_kernel_equals_the_general_kernel_and_twin(cuda, name, dtype, interior, guard):
    """The march kernel (launches_march) against the general kernel and the
    twin at K = 1 and 2, with 16-byte and (guard (2, 5, 7)) 4- or 8-byte
    copies, after one and two passes."""
    spec = get_shape(name)
    for K in (1, 2):
        assert stencil3d.march_takes(spec, dtype, K)
        lay = Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(*interior[1:]),
                       guard=guard_3d(spec.halo, K * spec.radius) if guard == "aligned"
                       else guard)
        for fill in _3d_fills(reference.random_padded(spec, interior, seed=6)):
            x = lay.to_internal(fill, dtype, cuda)
            for _ in range(2):
                before = stencil3d.stencil3d_step.launches_march
                got = stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, lay, fused_steps=K)
                assert stencil3d.stencil3d_step.launches_march - before == 1
                want = stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, K)
                general = _general_3d(x, spec, lay, K)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, general, rtol=0, atol=0, equal_nan=True)
                torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
                x = got


def _kinds_3d(kind, R, seed):
    """star3d1r's or box3d1r's term mix at radius R with integer taps, zeros
    among them."""
    rng = np.random.default_rng(seed)

    def taps():
        t = rng.integers(-3, 4, 2 * R + 1).astype(np.float64)
        t[rng.random(2 * R + 1) < 0.3] = 0.0
        t[0] = 1.0
        return tuple(float(v) for v in t)

    if kind == "star":
        terms = (SeparableTerm(taps=(taps(), None, None)),
                 SeparableTerm(taps=(None, taps(), None)),
                 SeparableTerm(taps=(None, None, taps())))
    else:
        terms = (SeparableTerm(taps=(taps(), taps(), taps())),)
    return StencilSpec(name=f"{kind}_r{R}", ndim=3, radius=R, halo=(R, R, R), terms=terms,
                       residue=(), fuse_factor=1)


@pytest.mark.parametrize("kind", ["star", "box"])
def test_march_kernel_at_any_taps(cuda, kind):
    """Custom taps (zeros among them) at radius 1: the march kernel equals the
    general kernel bit for bit on any fill, and in float64 the twin; at
    radius 2 the pass runs the general kernel."""
    interior = (21, 45, 130)
    for R in (1, 2):
        spec = _kinds_3d(kind, R, seed=R)
        for dtype in (torch.float32, torch.float64):
            for K in (1, 2):
                assert stencil3d.march_takes(spec, dtype, K) == (R == 1)
                lay = Layout3D(interior=interior, halo=spec.halo,
                               tile=default_tile_3d(*interior[1:]),
                               guard=guard_3d(spec.halo, K * R))
                for fill in _3d_fills(reference.random_padded(spec, interior, seed=2)):
                    x = lay.to_internal(fill, dtype, cuda)
                    before = stencil3d.stencil3d_step.launches_march
                    got = stencil3d.stencil3d_step(x, torch.zeros_like(x), spec, lay,
                                                   fused_steps=K)
                    assert stencil3d.stencil3d_step.launches_march - before == (R == 1)
                    general = _general_3d(x, spec, lay, K)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, general, rtol=0, atol=0, equal_nan=True)
                    if dtype == torch.float64:
                        want = stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, K)
                        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype,k", [("float32", 2), ("df64", 1), ("float64", 2)])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_3d_engine_runs_the_march_kernel(cuda, name, dtype, k):
    """Every pass of the engine's 3-D paths launches the march kernel; a pass
    of four steps (fused_steps_3d=4) runs the general kernel."""
    interior = (20, 40, 200)
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda, dtype=dtype)
    assert eng._fused_k() == k
    g1 = reference.random_padded(eng.spec, interior, seed=3)
    counter = stencil3d.stencil3d_step
    before = (counter.launches + counter.launches_f64, counter.launches_march)
    out = eng.run(g1, 8)
    torch.cuda.synchronize()
    assert (counter.launches + counter.launches_f64 - before[0],
            counter.launches_march - before[1]) == (8 // k, 8 // k)
    want, got = reference.run(g1, eng.spec, 8), out.cpu().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:  # every partial sum an integer below 2**53
        assert np.array_equal(got, want)
    if dtype != "df64":  # df64 runs one step a pass whatever the config
        deep = engine.StencilEngine.for_shape(name, interior, device=cuda, dtype=dtype,
                                              fused_steps_3d=4)
        before = (counter.launches + counter.launches_f64, counter.launches_march)
        deep.run(g1, 4)
        assert counter.launches + counter.launches_f64 > before[0]
        assert counter.launches_march == before[1]


def _mixed_1d(r):
    """A narrow spec of effective radius r whose d cycle through every kind of
    the narrow plan (+d alone, -d alone, both unequal, neither, an equal pair;
    d = r a pair), the centre nonzero (tests/test_torch_resident1d.py)."""
    rng = np.random.default_rng(r)
    w = rng.integers(1, 4, 2 * r + 1) * rng.choice([-1.0, 1.0], 2 * r + 1) / 256.0
    taps = np.zeros(2 * r + 1)
    taps[r] = w[r]
    for d in range(1, r + 1):
        kind = d % 5 if d < r else 0
        if kind in (0, 1, 3):
            taps[r + d] = w[r + d]
        if kind in (2, 3):
            taps[r - d] = w[r - d] if kind == 2 else -w[r + d]
        if kind == 0:
            taps[r - d] = w[r + d]
    return engine.StencilEngine.for_coeffs(taps, (64,), name=f"m{r}", device="cpu").spec


def _spec_1d(name):
    if name.startswith("m"):
        return _mixed_1d(int(name[1:]))
    if name == "r40":  # taps / 256: values stay finite over deep passes
        taps = np.random.default_rng(40).integers(-3, 4, 81) / 256.0
        return engine.StencilEngine.for_coeffs(taps, (64,), device="cpu").spec
    return get_shape(name)


@pytest.mark.parametrize("n", [4096, 3001, 100_000])
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40"])
def test_1d_kernels_match_plain_twins(cuda, name, n):
    """Each 1-D wrapper against its twin: passes at k = 1, 2 and the largest
    legal k (one and two passes), whole runs over 2*refresh + 3 steps."""
    spec = _spec_1d(name)
    r = stencil1d.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=3)
    narrow = r <= stencil1d.MAX_LANES_REACH
    passes = [(stencil1d.stencil1d_step, stencil1d.stencil1d_step_plain, 64)]
    runs = [(stencil1d.stencil1d_resident, stencil1d.stencil1d_resident_plain, 1)]
    if narrow:
        passes.append((stencil1d.stencil1d_lanes_step, stencil1d.stencil1d_lanes_step_plain,
                       stencil1d.MAX_LANES_REACH // r))
        runs.append((stencil1d.stencil1d_resident_lanes,
                     stencil1d.stencil1d_resident_lanes_plain, stencil1d.lanes_refresh(r)))
    for fill in (g0, g0 * (np.pi / 100)):
        for step, plain, kmax in passes:
            for k in (1, 2, kmax):
                lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], k * r))
                x = lay.to_internal(fill, device=cuda)
                for steps in (k, 2 * k):
                    got = _steps(step, x, spec, lay, steps, k)
                    want = _steps(plain, x, spec, lay, steps, k)
                    torch.cuda.synchronize()
                    assert not bool(torch.isnan(want).any())
                    assert torch.equal(got, want)
        for run, plain, refresh in runs:
            lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], refresh * r))
            x = lay.to_internal(fill, device=cuda)
            keep = x.clone()
            for steps in (1, 2, 2 * refresh + 3):
                got = run(x, spec, lay, steps)
                torch.cuda.synchronize()
                assert torch.equal(got, plain(x, spec, lay, steps)) and torch.equal(x, keep)


def _fills_1d(g0):
    pi = g0 * (np.pi / 100)
    inf = pi.copy()
    inf[inf.size // 3] = np.inf
    return (g0, pi, inf)


@pytest.mark.parametrize("n", [3001, 4096, 100_000])
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r13"])
def test_lanes_kernel_equals_its_twin_and_pass_kernel(cuda, name, n):
    """#5 redesigned: the float32 narrow pass (lanes_kernel, counted in
    launches_lanes) at k = 1, 3 and 32 // r_eff, bit for bit against its
    twin and the kernel it replaces (pass_kernel<float>) on the integer,
    pi/100 and inf fills; r13 takes the runtime-radius instance."""
    if name == "r13":
        taps = np.random.default_rng(13).integers(-3, 4, 27) / 256.0
        taps[0] = taps[-1] = 1.0 / 256.0
        spec = engine.StencilEngine.for_coeffs(taps, (64,), device="cpu").spec
    else:
        spec = get_shape(name)
    r = stencil1d.effective_radius(spec)
    w = stencil1d.stencil1d_lanes_step
    g0 = reference.random_padded(spec, (n,), seed=3)
    for k in sorted({1, min(3, 32 // r), 32 // r}):
        lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], k * r))
        for fill in _fills_1d(g0):
            x = lay.to_internal(fill, device=cuda)
            before = (w.launches, w.launches_lanes)
            got = w(x, torch.zeros_like(x), spec, lay, fused_steps=k)
            assert (w.launches - before[0], w.launches_lanes - before[1]) == (1, 1)
            old = stencil1d._pass(x, torch.zeros_like(x), spec, lay, k, True)
            want = stencil1d.stencil1d_lanes_step_plain(x, torch.zeros_like(x), spec, lay, k)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, old, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,n", [("1d1r", 4096), ("1d1r", 3001), ("1d2r", 4096),
                                    ("r40", 100_000)])
def test_run_kernel_equals_its_twin_and_resident_kernel(cuda, name, n, dtype):
    """#6 redesigned: the wide run (run_kernel, counted in launches_run)
    under the H100 plan, one block and four blocks of two-step phases, over
    1, 2 and 7 steps, bit for bit against its twin and the kernel it
    replaces (resident_kernel, a grid sync every step) on the integer,
    pi/100 and inf fills."""
    spec = _spec_1d(name)
    r = stencil1d.effective_radius(spec)
    lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], r))
    isz = dtype.itemsize
    plans = [None]
    for blocks, m in ((4, 2), (1, 7)):  # where their windows fit a block
        if 2 * (-(-lay.rounded // blocks) + 2 * m * r + 64) * isz <= 232448:
            plans.append(stencil1d.make_run_plan(lay.rounded, r, isz, blocks, m))
    w = stencil1d.stencil1d_resident
    for fill in _fills_1d(reference.random_padded(spec, (n,), seed=3)):
        x = lay.to_internal(fill, dtype, cuda)
        keep = x.clone()
        for steps in (1, 2, 7):
            before = w.launches_run
            got = w(x, spec, lay, steps)
            assert w.launches_run - before == 1
            old = stencil1d._run(x, spec, lay, steps, 1, False)
            want = stencil1d.stencil1d_resident_plain(x, spec, lay, steps)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, old, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
            for plan in plans[1:]:
                other = stencil1d._wide_run(x, spec, lay, steps, plan)
                torch.cuda.synchronize()
                torch.testing.assert_close(other, want, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(x, keep)


def _largest_lanes_1d(dtype):
    spec = get_shape("1d1r")
    n = stencil1d.RESIDENT_LANES_BYTES // dtype.itemsize // TILE_1D * TILE_1D
    while not stencil1d.fits_resident_lanes(
            Layout1D(n, 4, TILE_1D, guard_1d(4, 24)), dtype.itemsize):
        n -= TILE_1D
    return n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,n", [("1d1r", 3001), ("1d1r", 4096), ("1d2r", 4096),
                                    ("m5", 4096), ("m9", 4096), ("m32", 4096), ("m16", 65_536),
                                    ("m32", 65_536), ("1d1r", None)])
def test_narrow_run_kernel_equals_its_twin_and_resident_kernel(cuda, name, n, dtype):
    """#7 and #14 redesigned: the narrow run (run_kernel's narrow instances,
    counted in launches_run) under the H100 plan, one block and four blocks
    of two-step phases, over 1, 2, 7 and 2m + 3 steps, bit for bit against its
    twin and the kernel it replaces (resident_kernel, a grid sync every
    lanes_refresh steps) on the integer, pi/100 and inf fills; the registry
    shapes take the instance of a plan of pairs only, the m specs (every kind
    of d) the one of any plan, m9, m16 and m32 at the runtime radius; None: the
    largest 1d1r grid under RESIDENT_LANES_BYTES (132 blocks)."""
    spec = _spec_1d(name)
    n = n or _largest_lanes_1d(dtype)
    r = stencil1d.effective_radius(spec)
    refresh = stencil1d.lanes_refresh(r)
    lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], refresh * r))
    assert stencil1d.fits_resident_lanes(lay, dtype.itemsize)
    isz = dtype.itemsize
    plan = stencil1d.run_plan(lay.rounded, r, stencil1d.lanes_products(spec), 64, isz,
                              stencil1d._sm_count(cuda.index or 0))
    plans = []
    for blocks, m in ((4, 2), (1, 7)):  # where their windows fit a block
        if 2 * (-(-lay.rounded // blocks) + 2 * m * r + 64) * isz <= 232448:
            plans.append(stencil1d.make_run_plan(lay.rounded, r, isz, blocks, m))
    w = stencil1d.stencil1d_resident_lanes
    for fill in _fills_1d(reference.random_padded(spec, (n,), seed=3)):
        x = lay.to_internal(fill, dtype, cuda)
        keep = x.clone()
        for steps in sorted({1, 2, 7, 2 * plan.m + 3}):
            before = (w.launches_run, w.launches, w.launches_f64)
            got = w(x, spec, lay, steps)
            assert (w.launches_run - before[0],
                    w.launches + w.launches_f64 - before[1] - before[2]) == (1, 1)
            old = stencil1d._run(x, spec, lay, steps, refresh, True)
            want = stencil1d.stencil1d_resident_lanes_plain(x, spec, lay, steps)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, old, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
            for other in plans:
                got = stencil1d._lanes_run(x, spec, lay, steps, other)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(x, keep)


@pytest.mark.parametrize("name,n,kw,counter,launches", [
    ("1d1r", 4096, {}, "stencil1d_resident_lanes", {2: 1, 7: 1}),
    ("1d2r", 600_000, {}, "stencil1d_lanes_step", {2: 1, 7: 3}),
    ("1d2r", 4096, {"algorithm": "vpu"}, "stencil1d_resident", {2: 1, 7: 1}),
    ("1d2r", 600_000, {"algorithm": "vpu"}, "stencil1d_step", {2: 1, 7: 4}),
])
def test_1d_engine_counts_its_launches(cuda, name, n, kw, counter, launches):
    eng = engine.StencilEngine.for_shape(name, (n,), device=cuda, **kw)
    fn = getattr(stencil1d, counter)
    g0 = reference.random_padded(eng.spec, (n,), seed=1)
    for steps, expect in launches.items():
        before = fn.launches
        before_run = getattr(fn, "launches_run", 0)
        out = eng.run(g0, steps)
        assert fn.launches - before == expect and out.is_cuda
        if counter in ("stencil1d_resident_lanes", "stencil1d_resident"):  # run_kernel
            assert fn.launches_run - before_run == expect
        want = reference.run(g0, eng.spec, steps)
        assert np.abs(out.cpu().numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_1d_refused_launches_raise(cuda):
    spec = get_shape("1d2r")
    n = 4_000_000  # a resident chunk per SM too large for shared memory
    lay = Layout1D(n, 4, TILE_1D, guard_1d(4, 32))
    x = torch.zeros(lay.shape, device=cuda)
    w = stencil1d.stencil1d_resident_lanes
    before = (w.launches, w.launches_run)
    with pytest.raises(RuntimeError, match="resident launch failed"):
        w(x, spec, lay, 3)
    assert (w.launches, w.launches_run) == before
    with pytest.raises(ValueError):
        stencil1d.stencil1d_step(x, torch.zeros(lay.shape), spec, lay)


@pytest.mark.parametrize("interior", [(96, 256), (100, 131), (37, 45)])
@pytest.mark.parametrize("name", ["star2d1r", "box2d1r", "box2d3r"])
def test_fp64_2d_kernel_matches_plain_twin(cuda, name, interior):
    spec = get_shape(name)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                   guard=guard_2d(spec.halo, spec.radius))
    g0 = reference.random_padded(spec, interior, seed=3)
    before = stencil2d.stencil2d_step.launches_f64
    for fill in (g0, g0 * (np.pi / 100)):
        x = lay.to_internal(fill, torch.float64, cuda)
        for steps in (1, 2, 4):
            got = _steps(stencil2d.stencil2d_step, x, spec, lay, steps)
            want = _steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
            torch.cuda.synchronize()
            assert got.dtype == torch.float64 and torch.equal(got, want)
            if fill is g0 and steps <= 2:
                assert np.array_equal(lay.from_internal(got).cpu().numpy(),
                                      reference.run(g0, spec, steps))
    assert stencil2d.stencil2d_step.launches_f64 - before == 2 * (1 + 2 + 4)


@pytest.mark.parametrize("n", [4096, 3001, 100_000])
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40"])
def test_fp64_1d_kernels_match_plain_twins(cuda, name, n):
    """Each 1-D wrapper on a float64 state (its fp64 instance) against its twin:
    passes at k = 1, 2 and the largest legal k, runs over 2*refresh + 3 steps."""
    spec = _spec_1d(name)
    r = stencil1d.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=3)
    kmax = min(64, stencil1d.max_pass_reach(torch.float64) // r)
    passes = [(stencil1d.stencil1d_step, stencil1d.stencil1d_step_plain, kmax)]
    runs = [(stencil1d.stencil1d_resident, stencil1d.stencil1d_resident_plain, 1)]
    if r <= stencil1d.MAX_LANES_REACH:
        passes.append((stencil1d.stencil1d_lanes_step, stencil1d.stencil1d_lanes_step_plain,
                       stencil1d.MAX_LANES_REACH // r))
        runs.append((stencil1d.stencil1d_resident_lanes,
                     stencil1d.stencil1d_resident_lanes_plain, stencil1d.lanes_refresh(r)))
    for fill in (g0, g0 * (np.pi / 100)):
        for step, plain, k_top in passes:
            for k in sorted({1, 2, k_top}):
                lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], k * r))
                x = lay.to_internal(fill, torch.float64, cuda)
                for steps in (k, 2 * k):
                    before = step.launches_f64
                    got = _steps(step, x, spec, lay, steps, k)
                    assert step.launches_f64 - before == steps // k
                    want = _steps(plain, x, spec, lay, steps, k)
                    torch.cuda.synchronize()
                    assert not bool(torch.isnan(want).any())
                    assert got.dtype == torch.float64 and torch.equal(got, want)
        for run, plain, refresh in runs:
            lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], refresh * r))
            x = lay.to_internal(fill, torch.float64, cuda)
            keep = x.clone()
            for steps in (1, 2, 2 * refresh + 3):
                got = run(x, spec, lay, steps)
                torch.cuda.synchronize()
                assert torch.equal(got, plain(x, spec, lay, steps)) and torch.equal(x, keep)


@pytest.mark.parametrize("dtype", ["df64", "float64"])
@pytest.mark.parametrize("name,interior,counter,launches", [
    ("star2d1r", (64, 200), stencil2d.stencil2d_step, {2: 2, 4: 4}),
    ("box2d3r", (100, 131), stencil2d.stencil2d_step, {2: 2, 4: 4}),
    ("1d1r", (4096,), stencil1d.stencil1d_resident_lanes, {2: 1, 4: 1}),
])
def test_fp64_engine_counts_its_launches(cuda, tiled_2d, dtype, name, interior, counter,
                                         launches):
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda, dtype=dtype)
    g1 = reference.random_padded(eng.spec, interior, seed=1) * (np.pi / 100)
    for steps, expect in launches.items():
        before = (counter.launches, counter.launches_f64)
        before_run = getattr(counter, "launches_run", 0)
        out = eng.run(g1, steps)
        assert (counter.launches, counter.launches_f64 - before[1]) == (before[0], expect)
        if counter is stencil1d.stencil1d_resident_lanes:  # run_kernel, float64
            assert counter.launches_run - before_run == expect
        assert out.is_cuda and out.dtype == torch.float64
        want = reference.run(g1, eng.spec, steps)
        assert np.abs(out.cpu().numpy() - want).max() <= 1e-13 * np.abs(want).max()


# -- the float64 strip kernel (k = 1, radius 1-4, <= 3 terms): the tile kernel's sums --
@pytest.mark.parametrize("guard", ["aligned", (5, 7)])
@pytest.mark.parametrize("interior", [(96, 256), (130, 131), (37, 45)])
@pytest.mark.parametrize("case", STRIP_CASES, ids=str)
def test_float64_strip_kernel_equals_the_tile_kernel_and_the_twin(cuda, case, interior,
                                                                 guard):
    """The float64 strip kernel (counted in launches_f64 and launches_k1)
    against the float64 tile kernel it replaces at k = 1 and the twin: bit
    for bit on the integer, pi/100 and inf fills (NaN where they have NaN),
    16-byte staging and, with the guard off the 16-byte grid, 8-byte."""
    spec = get_shape(case) if isinstance(case, str) else _custom_2d(*case, seed=sum(case))
    assert stencil2d.strip_takes(spec, torch.float64)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                   guard=guard_2d(spec.halo, spec.radius) if guard == "aligned" else guard)
    g0 = reference.random_padded(spec, interior, seed=6)
    pi = g0 * (np.pi / 100)
    inf = pi.copy()
    inf.flat[inf.size // 3] = np.inf
    step = stencil2d.stencil2d_step
    for fill in (g0, pi, inf):
        x = lay.to_internal(fill, torch.float64, cuda)
        before = (step.launches, step.launches_f64, step.launches_k1)
        got = step(x, torch.zeros_like(x), spec, lay)
        assert (step.launches - before[0], step.launches_f64 - before[1],
                step.launches_k1 - before[2]) == (0, 1, 1)
        tile = torch.zeros_like(x)
        stencil2d._launch("step", (x, tile), spec, lay, 1)
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay)
        torch.cuda.synchronize()
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, tile, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", ["df64", "float64"])
@pytest.mark.parametrize("name", ["star2d1r", "box2d1r", "box2d3r", "star2d3r"])
def test_fp64_2d_engines_run_only_strip_launches(cuda, tiled_2d, dtype, name):
    """Every step of a df64 or float64 2-D engine is one float64 strip
    launch: launches_f64 and launches_k1 each grow by the steps, and no
    float32 or fused launch happens."""
    eng = engine.StencilEngine.for_shape(name, (70, 200), device=cuda, dtype=dtype)
    g1 = reference.random_padded(eng.spec, (70, 200), seed=1) * (np.pi / 100)
    step = stencil2d.stencil2d_step
    for steps in (1, 2, 5):
        before = (step.launches, step.launches_f64, step.launches_k1,
                  step.launches_fused_strip)
        out = eng.run(g1, steps)
        assert (step.launches - before[0], step.launches_f64 - before[1],
                step.launches_k1 - before[2],
                step.launches_fused_strip - before[3]) == (0, steps, steps, 0)
        want = reference.run(g1, eng.spec, steps)
        assert np.abs(out.cpu().numpy() - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("dtype,kw,counter,launches", [
    ("df64", {}, "df64_1d_step", {2: 2, 7: 7}),
    ("float64", {}, "df64_1d_step", {2: 1, 7: 4}),
    ("df64", {"lanes_width": 256}, "df64_1d_step", {2: 2, 7: 7}),
    ("float64", {"algorithm": "vpu"}, "df64_1d_flat_step", {2: 1, 7: 4}),
])
def test_fp64_1d_engine_counts_its_launches(cuda, dtype, kw, counter, launches):
    n = 600_000
    eng = engine.StencilEngine.for_shape("1d2r", (n,), device=cuda, dtype=dtype, **kw)
    fn = getattr(stencil1d, {"df64_1d_step": "stencil1d_lanes_step",
                             "df64_1d_flat_step": "stencil1d_step"}[counter])
    g1 = reference.random_padded(eng.spec, (n,), seed=1) * (np.pi / 100)
    for steps, expect in launches.items():
        before = fn.launches_f64
        out = eng.run(g1, steps)
        assert fn.launches_f64 - before == expect and out.dtype == torch.float64
        want = reference.run(g1, eng.spec, steps)
        assert np.abs(out.cpu().numpy() - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("interior", [(6, 20, 150), (37, 45, 130)])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_fp64_3d_kernel_matches_plain_twin(cuda, name, interior, K):
    """The 3-D kernel's float64 instance (df64_3d_step's counterpart): one
    launch per pass of K, bit for bit with its twin on any fill."""
    spec = get_shape(name)
    lay = Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(*interior[1:]),
                   guard=guard_3d(spec.halo, K * spec.radius))
    g0 = reference.random_padded(spec, interior, seed=3)
    for fill in (g0, g0 * (np.pi / 100)):
        x = lay.to_internal(fill, torch.float64, cuda)
        for steps in (K, 2 * K):
            before = (stencil3d.stencil3d_step.launches, stencil3d.stencil3d_step.launches_f64)
            got = _steps(stencil3d.stencil3d_step, x, spec, lay, steps, K)
            assert (stencil3d.stencil3d_step.launches,
                    stencil3d.stencil3d_step.launches_f64 - before[1]) == (before[0], steps // K)
            want = _steps(stencil3d.stencil3d_step_plain, x, spec, lay, steps, K)
            torch.cuda.synchronize()
            assert got.dtype == torch.float64 and torch.equal(got, want)
            if fill is g0:
                assert np.array_equal(lay.from_internal(got).cpu().numpy(),
                                      reference.run(g0, spec, steps))


@pytest.mark.parametrize("dtype,launches", [("df64", {2: 2, 3: 3}), ("float64", {2: 1, 3: 2})])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_fp64_3d_engine_counts_its_launches(cuda, name, dtype, launches):
    interior = (20, 40, 200)
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda, dtype=dtype)
    g1 = reference.random_padded(eng.spec, interior, seed=1) * (np.pi / 100)
    for steps, expect in launches.items():
        before = stencil3d.stencil3d_step.launches_f64
        out = eng.run(g1, steps)
        assert stencil3d.stencil3d_step.launches_f64 - before == expect
        assert out.is_cuda and out.dtype == torch.float64
        want = reference.run(g1, eng.spec, steps)
        assert np.abs(out.cpu().numpy() - want).max() <= 1e-13 * np.abs(want).max()


# -- 2-D temporal fusion: the fused, skewed and resident kernels -------------------
# Every 2-D kernel runs the same per-cell sums, so on the card a fused pass of k
# steps, a skewed pass and a resident run each equal k single-step launches bit for
# bit on any fill.  Against the twins: the integer 0/1 fill is exact while every
# value stays below 2**24 (three steps of any 2-D registry shape); the pi/100 fill
# agrees to fp32 rounding, rel <= 1e-5 after up to 13 steps (the kernels fuse
# multiply-adds, the twin rounds each product); float64 bit for bit on any fill.


def _layout_2d(spec, interior, k):
    return Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, k * spec.radius))


def _agree(got, want, exact):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
    if exact:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


SHAPES_FUSED = [("star2d3r", (96, 256)), ("box2d1r", (100, 131)), ("star2d1r", (37, 45)),
                ("box2d3r", (300, 140))]


@pytest.mark.parametrize("k", [2, 3, 4, "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,interior", SHAPES_FUSED)
def test_fused_kernel_matches_single_steps_and_twin(cuda, name, interior, dtype, k):
    """#1 at k > 1; "split": one step deeper than a tile launch takes.  A
    float32 or float64 pass runs as launches of at most the strip walk's
    depth (``stencil2d.walk_depth``), and a launch the plan strip kernel
    would take runs as single strip launches (``stencil2d.strips_beat_plan``;
    every shape here takes the strip kernel's single steps): one launch a
    step.  The launches are pinned: star2d3r's float32 k = 2 pass is one
    fused strip launch, every other pass k strip launches."""
    spec = get_shape(name)
    launches = {2: 1 if (name, dtype) == ("star2d3r", torch.float32) else 2,
                3: 3, 4: 4, "split": None}[k]
    kmax = stencil2d.max_fused_steps("step", spec.radius, stencil2d.plan_len(spec), dtype)
    if k == "split":
        k = launches = kmax + 1
    lay = _layout_2d(spec, interior, k)
    g0 = reference.random_padded(spec, interior, seed=3)
    for integer, fill in ((True, g0 % 2), (False, g0 * (np.pi / 100))):
        x = lay.to_internal(fill, dtype, cuda)
        keep = x.clone()
        before = stencil2d.stencil2d_step.launches + stencil2d.stencil2d_step.launches_f64
        got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay, fused_steps=k)
        after = stencil2d.stencil2d_step.launches + stencil2d.stencil2d_step.launches_f64
        assert after - before == launches
        _agree(got, _steps(stencil2d.stencil2d_step, x, spec, lay, k), True)
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k)
        _agree(got, want, dtype == torch.float64 or (integer and k <= 3))
        assert torch.equal(x, keep)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,interior", SHAPES_FUSED)
def test_skew_kernel_matches_fused_kernel_and_twin(cuda, name, interior, dtype, k):
    """#2 through ``stencil2d_skew_step``, every launch on the skew wrapper:
    star2d3r's float32 k = 2 pass one fused strip launch, every other pass k
    strip launches (``stencil2d.strips_beat_plan``), none of skew_kernel;
    equal to the extent pass and to skew_kernel launched directly, and to
    the twin."""
    spec = get_shape(name)
    launches = 1 if (name, dtype, k) == ("star2d3r", torch.float32, 2) else k
    wrapper = stencil2d.stencil2d_skew_step
    lay = _layout_2d(spec, interior, k)
    g0 = reference.random_padded(spec, interior, seed=4)
    for integer, fill in ((True, g0 % 2), (False, g0 * (np.pi / 100))):
        x = lay.to_internal(fill, dtype, cuda)
        before = (wrapper.launches + wrapper.launches_f64, wrapper.launches_tile)
        got = stencil2d.stencil2d_skew_step(x, torch.zeros_like(x), spec, lay,
                                            skew_steps=k)
        assert (wrapper.launches + wrapper.launches_f64 - before[0],
                wrapper.launches_tile - before[1]) == (launches, 0)
        _agree(got, stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay,
                                             fused_steps=k), True)
        old = torch.zeros_like(x)
        stencil2d._launch("skew", (x, old), spec, lay, k)
        _agree(got, old, True)
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k)
        _agree(got, want, dtype == torch.float64 or integer)


def _resident_grid_synced(x, spec, lay, steps):
    """A run of csrc/stencil2d.cu's resident kernel (a grid barrier a step),
    which the shared-memory kernel replaces for the registry's specs."""
    outs = (torch.zeros_like(x), torch.zeros_like(x))
    stencil2d._launch("resident", (x,) + outs, spec, lay, steps)
    return outs[(steps - 1) % 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,interior", [("star2d1r", (512, 512)), ("box2d3r", (100, 131)),
                                           ("star2d3r", (37, 45)), ("box2d1r", (300, 140))])
def test_resident_kernel_matches_single_steps_and_twin(cuda, name, interior, dtype):
    """#3 (float32) and #10 (float64): the shared-memory resident kernel
    (counted in launches_smem) against single steps and csrc/stencil2d.cu's
    resident kernel bit for bit, and the twin."""
    spec = get_shape(name)
    lay = _layout_2d(spec, interior, 1)
    g0 = reference.random_padded(spec, interior, seed=5)
    counter = stencil2d.stencil2d_resident
    for fill in (g0, g0 * (np.pi / 100)):
        x = lay.to_internal(fill, dtype, cuda)
        keep = x.clone()
        for steps in (1, 2, 5):
            before = (counter.launches, counter.launches_f64, counter.launches_smem)
            got = stencil2d.stencil2d_resident(x, spec, lay, steps)
            after = (counter.launches, counter.launches_f64, counter.launches_smem)
            assert sum(after[:2]) - sum(before[:2]) == 1 and after[2] - before[2] == 1
            assert (after[1] > before[1]) == (dtype == torch.float64)
            _agree(got, _steps(stencil2d.stencil2d_step, x, spec, lay, steps), True)
            _agree(got, _resident_grid_synced(x, spec, lay, steps), True)
            if steps <= 2 or dtype == torch.float64:
                want = stencil2d.stencil2d_resident_plain(x, spec, lay, steps)
                _agree(got, want, dtype == torch.float64 or fill is g0)
        assert torch.equal(x, keep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["star2d1r", "box2d1r", "box2d3r", "star2d3r"])
def test_resident_launch_at_and_beyond_capacity(cuda, name, dtype):
    """A square layout at the kernel's capacity runs (equal to single steps
    there); one row tile beyond it the launch is refused and raises."""
    spec = get_shape(name)
    cap = stencil2d.resident_capacity(spec, dtype, cuda)
    assert cap == stencil2d.resident_capacity_bytes(
        dtype.itemsize, torch.cuda.get_device_properties(0).multi_processor_count)
    n = 32
    while True:
        lay = _layout_2d(spec, (n + 32, n + 32), 1)
        if lay.shape[0] * lay.shape[1] * dtype.itemsize > cap:
            break
        n += 32
    lay = _layout_2d(spec, (n, n), 1)
    x = lay.to_internal(reference.random_padded(spec, (n, n), seed=8) * (np.pi / 100), dtype,
                        cuda)
    _agree(stencil2d.stencil2d_resident(x, spec, lay, 2),
           _steps(stencil2d.stencil2d_step, x, spec, lay, 2), True)
    over = Layout2D(interior=(n + 32, n), halo=spec.halo, tile=default_tile_2d(n, n),
                    guard=lay.guard)
    while over.shape[0] * over.shape[1] * dtype.itemsize <= cap:
        over = Layout2D(interior=(over.interior[0] + 32, n), halo=spec.halo,
                        tile=over.tile, guard=lay.guard)
    before = stencil2d.stencil2d_resident.launches_smem
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil2d.stencil2d_resident(torch.zeros(over.shape, dtype=dtype, device=cuda), spec,
                                     over, 2)
    assert stencil2d.stencil2d_resident.launches_smem == before


@pytest.mark.parametrize("kw,kernel,launches", [
    ({}, "stencil2d_step", {2: 1, 3: 2, 64: 32}),
    ({"fusion": "skew"}, "stencil2d_skew_step", {2: 1, 3: 1, 64: 32}),
    ({"fused_steps": 1}, "stencil2d_step", {2: 2, 3: 3, 64: 64}),
])
def test_star2d3r_engine_counts_its_launches(cuda, tiled_2d, kw, kernel, launches):
    interior = (200, 300)
    eng = engine.StencilEngine.for_shape("star2d3r", interior, device=cuda, **kw)
    g1 = reference.random_padded(eng.spec, interior, seed=1) * (np.pi / 100)
    counter = getattr(stencil2d, kernel)
    for steps, expect in launches.items():
        before = counter.launches
        out = eng.run(g1, steps)
        assert counter.launches - before == expect and out.is_cuda
        if steps <= 4:
            want = reference.run(g1, eng.spec, steps)
            assert np.abs(out.cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- the fused strip kernel (float32, k = 2, radius 1-4, <= 2 terms, no residue) ----
# It keeps the strip kernel's and the tile kernels' fmaf chains, so a pass equals two
# strip steps, the tile-based fused pass and the tile-based skewed pass bit for bit
# on any fill (the inf fill: NaN where they have NaN); against the twin, the 0/1
# fill bit for bit, the pi/100 fill rel 1e-5 after two passes (2K steps).
def _kinds_2d(R, kinds, seed):
    """A residue-free 2-D spec of radius R with a term of integer taps per
    letter of ``kinds``: row and column convs ("b"), the column conv alone
    ("c") or the row conv alone ("r")."""
    rng = np.random.default_rng(seed)

    def taps():
        t = rng.integers(-3, 4, 2 * R + 1).astype(np.float64)
        t[rng.random(2 * R + 1) < 0.3] = 0.0
        t[0] = 1.0
        return tuple(float(v) for v in t)

    terms = tuple(SeparableTerm(taps=(None if k == "c" else taps(), None if k == "r" else taps()))
                  for k in kinds)
    return StencilSpec(name=f"kinds_r{R}_{kinds}", ndim=2, radius=R, halo=(R, R), terms=terms,
                       residue=(), fuse_factor=1)


# every kind of term alone and beside another (star2d3r is "rc")
FUSED_STRIP_CASES = ["star2d3r", (1, "b"), (2, "bc"), (3, "r"), (4, "bc"), (2, "c"), (3, "cr"),
                     (1, "rb"), (4, "rr")]


@pytest.mark.parametrize("guard", ["aligned", (8, 9)])
@pytest.mark.parametrize("interior", [(96, 256), (300, 140), (37, 45)])
@pytest.mark.parametrize("case", FUSED_STRIP_CASES, ids=str)
def test_fused_strip_kernel_equals_strip_steps_and_tile_kernels(cuda, case, interior, guard):
    """Both wrappers' k = 2 pass (counted in launches_fused_strip) against two
    strip-kernel steps and the tile-based fused and skew kernels it replaces,
    with 16-byte and (guard (8, 9)) 4-byte staging, and against the twin."""
    spec = get_shape(case) if isinstance(case, str) else _kinds_2d(*case, seed=case[0])
    K = 2
    assert stencil2d.fused_strip_takes(spec, torch.float32, K)
    lay = _layout_2d(spec, interior, K) if guard == "aligned" else Layout2D(
        interior=interior, halo=spec.halo, tile=default_tile_2d(*interior), guard=guard)
    g0 = reference.random_padded(spec, interior, seed=7)
    inf = g0 * (np.pi / 100)
    inf.flat[inf.size // 3] = np.inf
    for integer, fill in ((True, g0 % 2), (False, g0 * (np.pi / 100)), (None, inf)):
        x = lay.to_internal(fill, device=cuda)
        keep = x.clone()
        passes = {}
        for name, wrapper, kw in (("fused", stencil2d.stencil2d_step, "fused_steps"),
                                  ("skew", stencil2d.stencil2d_skew_step, "skew_steps")):
            before = (wrapper.launches, wrapper.launches_fused_strip)
            passes[name] = wrapper(x, torch.zeros_like(x), spec, lay, **{kw: K})
            assert (wrapper.launches - before[0],
                    wrapper.launches_fused_strip - before[1]) == (1, 1)
        before = stencil2d.stencil2d_step.launches_k1
        strip = _steps(stencil2d.stencil2d_step, x, spec, lay, K)
        assert stencil2d.stencil2d_step.launches_k1 - before == K
        for kind in ("step", "skew"):
            tile = torch.zeros_like(x)
            stencil2d._launch(kind, (x, tile), spec, lay, K)
            passes["tile " + kind] = tile
        if integer is None:
            torch.cuda.synchronize()
            for name, got in passes.items():
                torch.testing.assert_close(got, strip, rtol=0, atol=0, equal_nan=True)
            continue
        for name, got in passes.items():
            _agree(got, strip, True)
        _agree(passes["fused"], stencil2d.stencil2d_step_plain(
            x, torch.zeros_like(x), spec, lay, K), integer)
        if not integer:
            two = stencil2d.stencil2d_step(passes["fused"], torch.zeros_like(x), spec, lay,
                                           fused_steps=K)
            want = stencil2d.stencil2d_step_plain(stencil2d.stencil2d_step_plain(
                x, torch.zeros_like(x), spec, lay, K), torch.zeros_like(x), spec, lay, K)
            _agree(two, want, False)
        assert torch.equal(x, keep)


@pytest.mark.parametrize("kw,wrapper", [({}, "stencil2d_step"),
                                        ({"fusion": "skew"}, "stencil2d_skew_step")])
def test_star2d3r_engine_runs_the_fused_strip_kernel(cuda, tiled_2d, kw, wrapper):
    """The engine's default star2d3r pass (k = 2) and its skewed pass launch the
    fused strip kernel and no tile-based fused or skewed kernel; float64 and the
    box shapes (three terms) keep the tile kernels."""
    interior = (200, 300)
    eng = engine.StencilEngine.for_shape("star2d3r", interior, device=cuda, **kw)
    counter = getattr(stencil2d, wrapper)
    state = eng.to_internal(reference.random_padded(eng.spec, interior, seed=3))
    before = (counter.launches, counter.launches_fused_strip)
    eng.run_internal(state, 64)
    torch.cuda.synchronize()
    assert (counter.launches - before[0], counter.launches_fused_strip - before[1]) == (32, 32)
    for name, dtype in (("box2d3r", "float32"), ("star2d3r", "float64")):
        other = engine.StencilEngine.for_shape(name, interior, device=cuda, dtype=dtype,
                                               fused_steps=2, **kw)
        before = counter.launches_fused_strip
        other.run(reference.random_padded(other.spec, interior, seed=3), 2)
        assert counter.launches_fused_strip == before


@pytest.mark.parametrize("dtype,cap", [("float32", "CUDA_RESIDENT_2D_BYTES"),
                                       ("float64", "CUDA_RESIDENT_2D_BYTES"),
                                       ("df64", "CUDA_RESIDENT_PAIR_2D_BYTES")])
def test_resident_engine_runs_one_launch(cuda, dtype, cap, monkeypatch):
    """With the variables unset, the card takes the H100 default caps: a 512^2
    engine run is one launch of the shared-memory resident kernel."""
    for env in ("LORASTENCIL_RESIDENT2D_KB", "LORASTENCIL_RESIDENT2D_PAIR_KB"):
        monkeypatch.delenv(env, raising=False)
    default = (stencil2d.H100_RESIDENT_PAIR_2D_BYTES if dtype == "df64"
               else stencil2d.H100_RESIDENT_2D_BYTES)
    monkeypatch.setattr(stencil2d, cap, stencil2d.cuda_cap(
        "LORASTENCIL_RESIDENT2D_PAIR_KB" if dtype == "df64" else "LORASTENCIL_RESIDENT2D_KB",
        default))
    interior = (512, 512)
    eng = engine.StencilEngine.for_shape("star2d1r", interior, device=cuda, dtype=dtype)
    assert eng._resident_2d()
    g1 = reference.random_padded(eng.spec, interior, seed=2) * (np.pi / 100)
    counter = stencil2d.stencil2d_resident
    before = (counter.launches + counter.launches_f64, counter.launches_smem)
    out = eng.run(g1, 4)
    assert (counter.launches + counter.launches_f64 - before[0],
            counter.launches_smem - before[1]) == (1, 1)
    want = reference.run(g1, eng.spec, 4)
    tol = 1e-5 if dtype == "float32" else 1e-13
    assert np.abs(out.cpu().numpy() - want).max() <= tol * np.abs(want).max()


# -- ghost boundaries (ROADMAP A6(a)): each kernel that gained a bounds branch
# (the levels before the last keep the box, the last keeps the interior) ----
GHOST_KERNELS = [  # (shape, interior, dtype, engine options, the counter)
    ("star2d3r", (300, 140), torch.float32, {}, "launches_fused_strip"),  # fused strip
    ("star2d1r", (100, 131), torch.float32, {"fused_steps": 2}, "launches"),  # step_kernel
    ("box2d3r", (100, 131), torch.float32, {"fused_steps": 3}, "launches"),
    ("star2d1r", (100, 131), torch.float64, {"fused_steps": 2}, "launches_f64"),
    ("star3d1r", (37, 45, 130), torch.float32, {}, "launches_march"),  # march K = 2
    ("box3d1r", (37, 45, 130), torch.float64, {}, "launches_march"),
    ("star3d1r", (37, 45, 130), torch.float32, {"fused_steps_3d": 4}, "launches"),  # general
    ("1d2r", (200_000,), torch.float32, {}, "launches_lanes"),  # lanes_kernel
    ("1d1r", (4096,), torch.float32, {}, "launches"),  # wide_kernel<float>
    ("1d1r", (4096,), torch.float64, {}, "launches_f64"),  # wide_kernel<double>
    ("1d2r", (200_000,), torch.float64, {}, "launches_f64"),  # pass_kernel<double>
]


def _ghost_engine(name, interior, dtype, kw, boundary, device):
    return engine.StencilEngine.for_shape(
        name, interior, device=device, boundary=boundary,
        dtype="float64" if dtype == torch.float64 else "float32", **kw)


def _ghost_wrapper(eng):
    if eng.spec.ndim == 1:
        return ((stencil1d.stencil1d_lanes_step, stencil1d.stencil1d_lanes_step_plain)
                if eng.path == "lanes" else
                (stencil1d.stencil1d_step, stencil1d.stencil1d_step_plain))
    if eng.spec.ndim == 2:
        return stencil2d.stencil2d_step, stencil2d.stencil2d_step_plain
    return stencil3d.stencil3d_step, stencil3d.stencil3d_step_plain


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name,interior,dtype,kw,counter", GHOST_KERNELS,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in GHOST_KERNELS])
def test_ghost_bounds_kernel_matches_twin(cuda, name, interior, dtype, kw, counter, boundary):
    """One pass with the engine's ghost bounds on a buffer whose ring the
    engine's refresh filled: bit for bit against the twin with the same
    bounds (the 0/1 fill: the float32 2-D kernels fuse multiply-adds), and
    with the interior's bounds bit for bit against no bounds."""
    eng = _ghost_engine(name, interior, dtype, kw, boundary, cuda)
    k = eng._fused_k()
    assert k >= 2
    wrapper, twin = _ghost_wrapper(eng)
    g0 = reference.random_padded(eng.spec, interior, seed=5) % 2
    x = eng._ring_refresh(eng.to_internal(g0), boundary)
    counted = wrapper if counter != "launches_march" else stencil3d.stencil3d_step
    before = getattr(counted, counter)
    got = wrapper(x, torch.zeros_like(x), eng.spec, eng.layout, fused_steps=k,
                  bounds=eng._ghost_bounds())
    assert getattr(counted, counter) == before + 1
    want = twin(x, torch.zeros_like(x), eng.spec, eng.layout, k, eng._ghost_bounds())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    box = tuple(v for s in interior for v in (0, s))
    assert torch.equal(
        wrapper(x, torch.zeros_like(x), eng.spec, eng.layout, fused_steps=k, bounds=box),
        wrapper(x, torch.zeros_like(x), eng.spec, eng.layout, fused_steps=k))


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name,interior,kw", [
    ("star2d1r", (300, 260), {}),
    ("star2d3r", (300, 260), {}),
    ("star2d1r", (300, 260), {"fused_steps": 40}),  # a pass split across launches
    ("star3d1r", (20, 40, 70), {"fused_steps_3d": 4}),
    ("box3d1r", (20, 40, 70), {}),
    ("1d1r", (4096,), {}),
    ("1d2r", (200_000,), {}),
    ("star2d1r", (300, 260), {"dtype": "df64"}),
    ("box3d1r", (20, 40, 70), {"dtype": "float64"}),
    ("1d2r", (200_000,), {"dtype": "df64"}),
])
def test_ghost_engine_matches_twins_and_ground_truth(cuda, name, interior, kw, boundary):
    """run(.., 2) of the integer fill bit for bit against the CPU engine (the
    twins) and the ground truth; run(.., 5) within rel 1e-5 (fp64: 1e-13);
    no whole-grid run under a ghost boundary."""
    spec = get_shape(name)
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda, boundary=boundary, **kw)
    cpu = engine.StencilEngine.for_shape(name, interior, device="cpu", boundary=boundary, **kw)
    truth = reference.run_periodic if boundary == "periodic" else reference.run_reflect
    runs = (stencil2d.stencil2d_resident, stencil1d.stencil1d_resident_lanes,
            stencil1d.stencil1d_resident)
    before = [(f.launches, f.launches_f64) for f in runs]
    g0 = reference.random_padded(spec, interior, seed=6)
    got = eng.run(g0, 2).cpu()
    assert torch.equal(got, cpu.run(g0, 2))
    assert np.array_equal(got.numpy(), truth(g0, spec, 2))
    g1 = g0 * (np.pi / 100)
    want = truth(g1, spec, 5)
    tol = 1e-5 if kw.get("dtype", "float32") == "float32" else 1e-13
    assert (np.abs(eng.run(g1, 5).cpu().numpy() - want).max()
            <= tol * np.abs(want).max())
    assert [(f.launches, f.launches_f64) for f in runs] == before


# -- custom coefficients (ROADMAP A6(b)) and the adjoint (A10) ---------------------
# chip_smoke.py's phase 22 at small sizes: its arrays (chip_smoke.custom_coeffs),
# each pass's kernel by the wrappers' rules (chip_smoke.custom_kernel, launches
# counted from zero), and the dyadic twin of each spec (chip_smoke.dyadic: the
# same plan, exact float32 sums on a 0/1 fill), whose runs hold bit for bit
# against the CPU engine (the twins) and the fp64 ground truth.
CUSTOM_2D, CUSTOM_3D = (300, 260), (20, 40, 70)
CUSTOM_TRUTH = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
                "reflect": reference.run_reflect}


def _custom_cases():
    import chip_smoke

    for name, kw, _, kernels, modes in chip_smoke.CUSTOM_CASES:
        for dtype, kernel in zip(("float32", "df64"), kernels):
            for mode in modes:
                if kernel is not None:
                    yield pytest.param(name, kw, dtype, mode, kernel,
                                       id=f"{name}-{kw or ''}-{dtype}-{mode}")


@pytest.mark.parametrize("name,kw,dtype,mode,kernel", list(_custom_cases()))
def test_custom_spec_engine_on_card(cuda, tiled_2d, name, kw, dtype, mode, kernel):
    import chip_smoke

    S = chip_smoke.custom_coeffs()[name]
    interior = CUSTOM_2D if S.ndim == 2 else CUSTOM_3D
    cfg = dict(dtype=dtype, boundary=mode, **kw)
    eng = engine.StencilEngine.for_coeffs(S, interior, device=cuda, **cfg)
    assert chip_smoke.custom_kernel(eng)[0] == kernel
    dspec = chip_smoke.dyadic(eng.spec)
    deng = engine.StencilEngine(dspec, interior, eng.config, device=cuda)
    dcpu = engine.StencilEngine(dspec, interior, eng.config, device="cpu")
    g01 = reference.random_padded(eng.spec, interior, seed=7) % 2
    got, launches = chip_smoke.counted_run(deng, g01, 2, chip_smoke.custom_kernel(deng))
    assert launches >= 1
    assert torch.equal(got.cpu(), dcpu.run(g01, 2))
    assert np.array_equal(got.cpu().numpy(), CUSTOM_TRUTH[mode](g01, dspec, 2))
    g1 = g01 * (np.pi / 10) + 0.25
    want = CUSTOM_TRUTH[mode](g1, eng.spec, 4)
    tol = 1e-13 if dtype == "df64" else 1e-5
    assert np.abs(eng.run(g1, 4).cpu().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "df64"])
def test_custom_spec_resident_run_on_card(cuda, dtype):
    """Under the H100 default caps a small custom 2-D grid runs one launch of
    the shared-memory resident kernel, and so does its adjoint."""
    import chip_smoke

    S = chip_smoke.custom_coeffs()["5x5 asym"]
    eng = engine.StencilEngine.for_coeffs(S, CUSTOM_2D, device=cuda, dtype=dtype)
    kernel = chip_smoke.custom_kernel(eng)
    assert kernel[0] == "resident_smem_kernel"
    dspec = chip_smoke.dyadic(eng.spec)
    deng = engine.StencilEngine(dspec, CUSTOM_2D, eng.config, device=cuda)
    g01 = reference.random_padded(eng.spec, CUSTOM_2D, seed=8) % 2
    got, launches = chip_smoke.counted_run(deng, g01, 3, kernel)
    assert launches == 1
    assert np.array_equal(got.cpu().numpy(), reference.run(g01, dspec, 3))
    assert chip_smoke.dot_identity(eng, cuda, kernel)["adjoint_launches"] == 1


@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("dtype", ["float32", "df64"])
@pytest.mark.parametrize("which", ["5x5 asym", "per-plane"])
def test_custom_adjoint_on_card(cuda, tiled_2d, which, dtype, boundary):
    """The dot-product identity in float64 (1e-5, df64 1e-12), autograd equal
    to run_vjp bit for bit (float32), the adjoint's launches counted (none
    for the reflect fold-back), and on the dyadic spec with a 0/1 cotangent
    run_vjp bit for bit against the CPU engine's."""
    import chip_smoke

    S = chip_smoke.custom_coeffs()[which]
    interior = CUSTOM_2D if S.ndim == 2 else CUSTOM_3D
    kw = {"fused_steps_3d": 1} if S.ndim == 3 and boundary == "reflect" else {}
    eng = engine.StencilEngine.for_coeffs(S, interior, device=cuda, dtype=dtype,
                                          boundary=boundary, **kw)
    rec = chip_smoke.dot_identity(eng, cuda)
    assert rec["dot_err"] <= (1e-12 if dtype == "df64" else 1e-5)
    dspec = chip_smoke.dyadic(eng.spec)
    deng = engine.StencilEngine(dspec, interior, eng.config, device=cuda)
    dcpu = engine.StencilEngine(dspec, interior, eng.config, device="cpu")
    g = reference.random_padded(dspec, interior, seed=9) % 2
    assert torch.equal(deng.run_vjp(g, 3).cpu(), dcpu.run_vjp(g, 3))


def test_inverse_source_example_on_card(cuda):
    """examples/torch_inverse_source.py's loop on the card against the CPU
    (the twins): the losses within rel 1e-5, falling at every iteration."""
    from examples import torch_inverse_source as example

    losses = {}
    for dev in (cuda, torch.device("cpu")):
        eng, _, y_obs = example.problem(device=dev)
        seen = losses.setdefault(dev.type, [])
        example.descend(eng, y_obs, 30, on_step=lambda i, loss, x: seen.append(float(loss)))
    card, cpu = np.array(losses["cuda"]), np.array(losses["cpu"])
    assert (np.diff(card) < 0).all()
    assert np.abs(card - cpu).max() <= 1e-5 * cpu.max()


# -- the bfloat16 state tier (ROADMAP A6(c), 2-D) ------------------------------------
# Every bf16 instance computes the float32 instance's sums on the widened state and
# rounds once, at its store, to nearest even (torch's .to rounds so too): a bf16
# pass equals the float32 pass of the widened input, rounded, bit for bit on any fill
# (the inf fill: NaN where it has NaN).  A whole-grid run stores every step in bf16,
# so it equals bf16 single steps.  On the integer fill the twins agree bit for bit.
BF16 = torch.bfloat16


def _bf16_fills(spec, interior, seed):
    g0 = reference.random_padded(spec, interior, seed=seed)
    inf = g0 * (np.pi / 100)
    inf.flat[inf.size // 3] = np.inf
    return g0, g0 * (np.pi / 100), inf


def _same(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _bf16_counts(wrapper):
    return (wrapper.launches, wrapper.launches_f64, wrapper.launches_bf16)


@pytest.mark.parametrize("guard", ["aligned", (5, 7)])
@pytest.mark.parametrize("interior", [(96, 256), (130, 131), (37, 45)])
@pytest.mark.parametrize("case", STRIP_CASES, ids=str)
def test_bf16_strip_kernel_rounds_the_float32_step(cuda, case, interior, guard):
    """#1's bf16 strip kernel (8-byte quads, or one-cell copies off the quad
    grid at guard (5, 7)) against the float32 strip kernel and the bf16 tile
    kernel, and the twin on the integer fill."""
    spec = get_shape(case) if isinstance(case, str) else _custom_2d(*case, seed=sum(case))
    assert stencil2d.strip_takes(spec, BF16)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                   guard=guard_2d(spec.halo, spec.radius) if guard == "aligned" else guard)
    g0, pi, inf = _bf16_fills(spec, interior, 6)
    counter = stencil2d.stencil2d_step
    for fill in (g0, pi, inf):
        x = lay.to_internal(fill, BF16, cuda)
        before = _bf16_counts(counter), counter.launches_k1
        got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay)
        assert (_bf16_counts(counter), counter.launches_k1) == (
            (before[0][0], before[0][1], before[0][2] + 1), before[1] + 1)
        f32 = x.float()
        _same(got, stencil2d.stencil2d_step(f32, torch.zeros_like(f32), spec, lay).to(BF16))
        tile = torch.zeros_like(x)
        stencil2d._launch("step", (x, tile), spec, lay, 1)
        _same(got, tile)
        if fill is g0:
            _same(got, stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay))


@pytest.mark.parametrize("guard", ["aligned", (8, 9)])
@pytest.mark.parametrize("interior", [(96, 256), (37, 45)])
@pytest.mark.parametrize("case", FUSED_STRIP_CASES, ids=str)
def test_bf16_fused_strip_kernel_rounds_the_float32_pass(cuda, case, interior, guard):
    """#1 and #2's bf16 fused strip kernel, from both wrappers, against the
    float32 fused strip pass and the bf16 tile-based fused and skew kernels."""
    spec = get_shape(case) if isinstance(case, str) else _kinds_2d(*case, seed=case[0])
    assert stencil2d.fused_strip_takes(spec, BF16, 2)
    lay = _layout_2d(spec, interior, 2) if guard == "aligned" else Layout2D(
        interior=interior, halo=spec.halo, tile=default_tile_2d(*interior), guard=guard)
    g0, pi, inf = _bf16_fills(spec, interior, 7)
    for fill in (g0 % 2, pi, inf):
        x = lay.to_internal(fill, BF16, cuda)
        f32 = x.float()
        want = stencil2d.stencil2d_step(f32, torch.zeros_like(f32), spec, lay,
                                        fused_steps=2).to(BF16)
        for wrapper, kw in ((stencil2d.stencil2d_step, {"fused_steps": 2}),
                            (stencil2d.stencil2d_skew_step, {"skew_steps": 2})):
            before = wrapper.launches_bf16, wrapper.launches_fused_strip
            got = wrapper(x, torch.zeros_like(x), spec, lay, **kw)
            assert (wrapper.launches_bf16, wrapper.launches_fused_strip) == (
                before[0] + 1, before[1] + 1)
            _same(got, want)
        for kind in ("step", "skew"):
            tile = torch.zeros_like(x)
            stencil2d._launch(kind, (x, tile), spec, lay, 2)
            _same(tile, want)
        if fill is not pi and fill is not inf:
            _same(want, stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, 2))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name,interior", SHAPES_FUSED)
def test_bf16_fused_and_skew_kernels_round_the_float32_pass(cuda, name, interior, k):
    """#1 and #2 at k = 2-3 through the tile-based kernels (the fused strip
    kernel where it takes the pass): one rounding a pass."""
    spec = get_shape(name)
    lay = _layout_2d(spec, interior, k)
    for fill in _bf16_fills(spec, interior, 3):
        x = lay.to_internal(fill, BF16, cuda)
        f32 = x.float()
        want = stencil2d.stencil2d_step(f32, torch.zeros_like(f32), spec, lay,
                                        fused_steps=k).to(BF16)
        _same(stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay, fused_steps=k), want)
        _same(stencil2d.stencil2d_skew_step(x, torch.zeros_like(x), spec, lay, skew_steps=k),
              want)


@pytest.mark.parametrize("name,interior", [("star2d1r", (512, 512)), ("box2d3r", (100, 131)),
                                           ("star2d3r", (37, 45)), ("box2d1r", (300, 140)),
                                           ("r5", (300, 140))])
def test_bf16_resident_kernels_round_every_step(cuda, name, interior):
    """#3's bf16 instances: the shared-memory resident kernel (registry
    shapes) and csrc/stencil2d.cu's (a radius-5 spec) against bf16 single
    steps bit for bit, and the twin on the integer fill."""
    spec = _custom_2d(5, 2, 4, seed=5) if name == "r5" else get_shape(name)
    lay = _layout_2d(spec, interior, 1)
    counter = stencil2d.stencil2d_resident
    for integer, fill in zip((True, False, False), _bf16_fills(spec, interior, 5)):
        x = lay.to_internal(fill, BF16, cuda)
        keep = x.clone()
        for steps in (1, 2, 5):
            before = _bf16_counts(counter), counter.launches_smem
            got = stencil2d.stencil2d_resident(x, spec, lay, steps)
            assert _bf16_counts(counter) == before[0][:2] + (before[0][2] + 1,)
            assert counter.launches_smem - before[1] == (name != "r5")
            _same(got, _steps(stencil2d.stencil2d_step, x, spec, lay, steps))
            if name != "r5":
                _same(got, _resident_grid_synced(x, spec, lay, steps))
            if integer and steps <= 2:
                _same(got, stencil2d.stencil2d_resident_plain(x, spec, lay, steps))
        assert torch.equal(x, keep)


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r"])
def test_bf16_resident_capacity_counts_float32_windows(cuda, name):
    """The bf16 run's windows hold float32 cells: its capacity is float32's
    in cells, at 2 bytes a cell; a layout beyond it is refused."""
    spec = get_shape(name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cap = stencil2d.resident_capacity(spec, BF16, cuda)
    assert cap == stencil2d.resident_capacity_bytes(2, sms, 4) == \
        stencil2d.resident_capacity(spec, torch.float32, cuda) // 2
    n = 512
    lay = _layout_2d(spec, (n, n), 1)
    x = lay.to_internal(reference.random_padded(spec, (n, n), seed=8) * (np.pi / 100), BF16,
                        cuda)
    _same(stencil2d.stencil2d_resident(x, spec, lay, 2),
          _steps(stencil2d.stencil2d_step, x, spec, lay, 2))
    rows = cap // 2 // lay.shape[1] + 64
    over = Layout2D(interior=(rows, n), halo=spec.halo, tile=lay.tile, guard=lay.guard)
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil2d.stencil2d_resident(torch.zeros(over.shape, dtype=BF16, device=cuda), spec,
                                     over, 2)


@pytest.mark.parametrize("name", ["star2d1r", "box2d1r", "box2d3r", "star2d3r"])
def test_bf16_engine_on_card(cuda, name, monkeypatch):
    """The bf16 engine on the card equals the twins' engine on the CPU bit for
    bit on the integer fill at 1-2 steps (every sum exact) and within 1e-2
    at 3-4, tiled (the whole-grid runs off) and under the default caps,
    launching only bf16 instances; within 5e-2 of the ground truth after 4
    steps."""
    interior = (200, 300)
    g0 = reference.random_padded(get_shape(name), interior, seed=2)
    twin = engine.StencilEngine.for_shape(name, interior, device="cpu", dtype="bfloat16")
    for tiled in (True, False):
        if tiled:
            monkeypatch.setattr(stencil2d, "CUDA_RESIDENT_2D_BYTES", 0)
        else:
            monkeypatch.undo()
        eng = engine.StencilEngine.for_shape(name, interior, device=cuda, dtype="bfloat16")
        assert eng._resident_2d() == (not tiled and eng.algorithm != "mxu_hybrid")
        wrappers = (stencil2d.stencil2d_step, stencil2d.stencil2d_skew_step,
                    stencil2d.stencil2d_resident)
        for steps in (1, 2, 3, 4):
            before = [_bf16_counts(w) for w in wrappers]
            out = eng.run(g0, steps)
            after = [_bf16_counts(w) for w in wrappers]
            assert all(a[:2] == b[:2] for a, b in zip(after, before))
            assert sum(a[2] - b[2] for a, b in zip(after, before)) >= 1
            assert out.dtype == BF16 and out.is_cuda
            want = twin.run(g0, steps)
            if steps <= 2:
                assert torch.equal(out.cpu(), want)
            else:
                err = (out.cpu().double() - want.double()).abs().max().item()
                assert err <= 1e-2 * want.double().abs().max().item()
        want = reference.run(g0, eng.spec, 4)
        got = out.cpu().double().numpy()
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


# -- ROADMAP C3: 2-D radii above 16, up to 128 (the wide kernel beyond the tile
# kernel's shared memory) -------------------------------------------------------
def _cross_spec(radius):
    S = np.zeros((2 * radius + 1,) * 2)
    S[radius, :] = S[:, radius] = 1.0
    return engine.StencilEngine.for_coeffs(S, (32, 32), device="cpu").spec


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, BF16])
@pytest.mark.parametrize("case", ["cross17", "cross64", "r40", "r128"])
def test_wide_radius_steps_match_twin(cuda, case, dtype):
    """A step and a k = 2 pass at radius 17-128: the tile and fused kernels
    where their windows fit, the wide kernel (counted in launches_wide) where
    a step's does not; against the twin within rel 1e-5 (float32 fuses
    multiply-adds), bit for bit in float64, and in bf16 against the float32
    pass of the widened input, rounded."""
    spec = (_cross_spec(int(case[5:])) if case.startswith("cross")
            else _custom_2d(int(case[1:]), 3, 5, seed=int(case[1:])))
    interior = (70, 300)
    lay = _layout_2d(spec, interior, 2)
    x = lay.to_internal(reference.random_padded(spec, interior, seed=9) * (np.pi / 100),
                        dtype, cuda)
    counter = stencil2d.stencil2d_step
    for k in (1, 2):
        before = counter.launches_wide
        got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay, fused_steps=k)
        wide = stencil2d.wide_takes(spec, dtype)
        kmax = stencil2d.max_fused_steps("step", spec.radius, stencil2d.plan_len(spec), dtype)
        assert counter.launches_wide - before == (k if wide and kmax == 1 else
                                                  int(wide and k == 1))
        if dtype == BF16:
            f32 = x.float()
            want = _steps(stencil2d.stencil2d_step, f32, spec, lay, k, k)
            if k > kmax:  # a launch a step: each rounds
                want = _steps(stencil2d.stencil2d_step, x, spec, lay, k)
            else:
                want = want.to(BF16)
            _same(got, want)
            continue
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k)
        torch.cuda.synchronize()
        if dtype == torch.float64:
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "float64", "df64"])
@pytest.mark.parametrize("radius", [17, 64])
def test_wide_radius_cross_engine_on_card(cuda, radius, dtype):
    """for_coeffs of a radius-17 and a radius-64 cross through the engine's
    default dispatch on the card (tiled passes: no whole-grid run takes a
    radius the resident kernels' windows refuse) against the fp64 ground
    truth: rel 1e-5 in float32, 1e-13 in the fp64-grade tier."""
    S = np.zeros((2 * radius + 1,) * 2)
    S[radius, :] = S[:, radius] = 1.0
    interior = (40, 300)
    eng = engine.StencilEngine.for_coeffs(S, interior, device=cuda, dtype=dtype)
    g0 = reference.random_padded(eng.spec, interior, seed=4)
    for steps in (1, 2, 3):
        want = reference.run(g0, eng.spec, steps)
        got = eng.run(g0, steps).cpu().double().numpy()
        tol = 1e-5 if dtype == "float32" else 1e-13
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


# -- ROADMAP C4: a 3-D radius-0 spec -------------------------------------------------
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "df64"])
def test_radius0_3d_engine_on_card(cuda, dtype, boundary):
    """The general 3-D kernel's radius-0 instances: k = 2 (df64: 1), error 0
    against the ground truth of each boundary (0.75 is dyadic)."""
    interior = (9, 10, 13)
    eng = engine.StencilEngine.for_coeffs(np.array([[[0.75]]]), interior, device=cuda,
                                          dtype=dtype, boundary=boundary)
    assert eng._fused_k() == (1 if dtype == "df64" else 2)
    truth = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    g0 = reference.random_padded(eng.spec, interior, seed=3)
    counter = stencil3d.stencil3d_step
    for steps in (1, 2, 3):
        before = counter.launches + counter.launches_f64
        got = eng.run(g0, steps).cpu().double().numpy()
        assert counter.launches + counter.launches_f64 - before == -(-steps // eng._fused_k())
        assert np.array_equal(got, truth(g0, eng.spec, steps))


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("name", ["star2d1r", "star2d3r"])
def test_bf16_ghost_engine_on_card(cuda, tiled_2d, name, boundary):
    """bf16 under a ghost boundary: the bf16 strip kernel (k = 1) and the
    bf16 fused strip kernel with the ring's bounds (k = 2) against the twins'
    engine on the CPU, bit for bit on the integer fill at 1-2 steps."""
    interior = (96, 256)
    kw = dict(dtype="bfloat16", boundary=boundary)
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda, **kw)
    twin = engine.StencilEngine.for_shape(name, interior, device="cpu", **kw)
    g0 = reference.random_padded(eng.spec, interior, seed=12)
    for steps in (1, 2, 3):
        before = stencil2d.stencil2d_step.launches_bf16
        out = eng.run(g0, steps)
        assert stencil2d.stencil2d_step.launches_bf16 - before == -(-steps // eng._fused_k())
        want = twin.run(g0, steps)
        if steps <= 2:
            assert torch.equal(out.cpu(), want)
        else:
            assert (out.cpu().double() - want.double()).abs().max() <= \
                1e-2 * want.double().abs().max()


@pytest.mark.parametrize("kw", [{}, {"fused_steps": 2}])
def test_bf16_custom_spec_and_adjoint_on_card(cuda, tiled_2d, kw):
    """A for_coeffs 5x5 of integer coefficients with a residue in bf16 (the
    strip kernel at k = 1, the tile fused kernel at k = 2) and its run_vjp
    against the twins' engine on the CPU: bit for bit on the integer fill at
    2 steps; run_vjp within 1e-2 (its adjoint passes run the kernels)."""
    S = np.outer([1, 2, 3, 2, 1], [1, 0, 2, 0, 1]).astype(np.float64)
    S[0, 4] += 1.0
    interior = (96, 256)
    eng = engine.StencilEngine.for_coeffs(S, interior, device=cuda, dtype="bfloat16", **kw)
    twin = engine.StencilEngine.for_coeffs(S, interior, device="cpu", dtype="bfloat16", **kw)
    g0 = reference.random_padded(eng.spec, interior, seed=13)
    assert torch.equal(eng.run(g0, 2).cpu(), twin.run(g0, 2))
    g = np.random.default_rng(3).integers(0, 4, g0.shape).astype(np.float64)
    got = eng.run_vjp(g, 3).cpu().double()
    want = twin.run_vjp(g, 3).double()
    assert got.dtype == want.dtype and (got - want).abs().max() <= 1e-2 * want.abs().max()


# -- the bfloat16 state tier in 1-D and 3-D (ROADMAP A6(c)) ---------------------------
# The 1-D bf16 instances round each product and sum on its own in fp32, in their
# twins' order, so each equals its bf16 twin bit for bit on any fill.  The wide pass
# (#4) rounds once, at its store: it equals the float32 wide pass of the widened
# input, rounded.  The narrow pass (#5) rounds every level: it equals k float32
# single steps, each rounded.  Both runs (#6, #7) round every step: they equal bf16
# single steps.  The 3-D bf16 instances (#8) equal the float32 pass of the widened
# input, rounded, on any fill, and the twin on the integer fill.
def _spec_1d_bf16(name):
    if name == "r13":  # the narrow kernels' runtime-radius instances
        taps = np.random.default_rng(13).integers(-3, 4, 27) / 256.0
        taps[0] = taps[-1] = 1.0 / 256.0
        return engine.StencilEngine.for_coeffs(taps, (64,), device="cpu").spec
    return _spec_1d(name)


@pytest.mark.parametrize("guard", [None, 45])
@pytest.mark.parametrize("name,n", [("1d1r", 3001), ("1d2r", 100_000), ("r40", 5001)])
def test_bf16_wide_pass_rounds_the_float32_pass(cuda, name, n, guard):
    """#4's bf16 wide_kernel at k = 1-3, staged by 8-byte quads or, off the
    quads' grid (guard 45), cell by cell: against the float32 wide pass of
    the widened input, rounded, and its twin, on the integer, pi/100 and
    inf fills; each launch counted in launches_bf16 alone."""
    spec = _spec_1d_bf16(name)
    r = stencil1d.effective_radius(spec)
    w = stencil1d.stencil1d_step
    fills = _fills_1d(reference.random_padded(spec, (n,), seed=4))
    for k in (1, 2, 3):
        lay = Layout1D(n, spec.halo[0], TILE_1D, guard or guard_1d(spec.halo[0], k * r))
        if lay.guard < k * r:
            continue
        for fill in fills:
            x = lay.to_internal(fill, BF16, cuda)
            before = _bf16_counts(w)
            got = w(x, torch.zeros_like(x), spec, lay, fused_steps=k)
            assert _bf16_counts(w) == before[:2] + (before[2] + 1,)
            f32 = x.float()
            _same(got, w(f32, torch.zeros_like(f32), spec, lay, fused_steps=k).to(BF16))
            _same(got, stencil1d.stencil1d_step_plain(x, torch.zeros_like(x), spec, lay, k))


@pytest.mark.parametrize("guard", [None, 45])
@pytest.mark.parametrize("name,n", [("1d1r", 3001), ("1d2r", 4096), ("1d2r", 100_000),
                                    ("r13", 3001)])
def test_bf16_narrow_pass_rounds_every_level(cuda, name, n, guard):
    """#5's bf16 lanes_kernel at k = 1, 3 and 32 // r_eff (8-byte quads, or
    cell by cell off their grid): bit for bit its twin on the integer,
    pi/100 and inf fills and k float32 single steps, each rounded; counted in
    launches_bf16 and launches_lanes."""
    spec = _spec_1d_bf16(name)
    r = stencil1d.effective_radius(spec)
    w = stencil1d.stencil1d_lanes_step
    fills = _fills_1d(reference.random_padded(spec, (n,), seed=5))
    for k in sorted({1, min(3, 32 // r), 32 // r}):
        lay = Layout1D(n, spec.halo[0], TILE_1D, guard or guard_1d(spec.halo[0], k * r))
        if lay.guard < k * r:
            continue
        for fill in fills:
            x = lay.to_internal(fill, BF16, cuda)
            before = _bf16_counts(w), w.launches_lanes
            got = w(x, torch.zeros_like(x), spec, lay, fused_steps=k)
            assert (_bf16_counts(w), w.launches_lanes) == (
                before[0][:2] + (before[0][2] + 1,), before[1] + 1)
            _same(got, stencil1d.stencil1d_lanes_step_plain(x, torch.zeros_like(x), spec,
                                                             lay, k))
            y = x
            for _ in range(k):
                f32 = y.float()
                y = w(f32, torch.zeros_like(f32), spec, lay).to(BF16)
            _same(got, y)
    with pytest.raises(RuntimeError, match="pass launch failed"):  # no bf16 pass_kernel
        stencil1d._pass(x, torch.zeros_like(x), spec, lay, 1, True)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("name,n", [("1d1r", 3001), ("1d1r", 4096), ("1d2r", 4096),
                                    ("m5", 4096), ("m9", 4096), ("r40", 100_000),
                                    ("1d1r", None)])
def test_bf16_runs_round_every_step(cuda, name, n, narrow):
    """#6 and #7's bf16 run_kernel (wide or narrow sums) under the H100 plan
    and four blocks of two-step phases, over 1, 2 and 7 steps: bit for bit
    its twin and bf16 single steps (k = 1 passes) on the integer, pi/100 and
    inf fills; counted in launches_bf16 and launches_run.  None: the largest
    1d1r grid under RESIDENT_LANES_BYTES at 2 bytes a cell."""
    spec = _spec_1d(name)
    r = stencil1d.effective_radius(spec)
    if narrow and r > stencil1d.MAX_LANES_REACH:
        pytest.skip("no narrow run beyond the lanes kernels' radius")
    n = n or _largest_lanes_1d(BF16)
    lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], r))
    if narrow:
        w, plain, step = (stencil1d.stencil1d_resident_lanes,
                          stencil1d.stencil1d_resident_lanes_plain,
                          stencil1d.stencil1d_lanes_step)
    else:
        w, plain, step = (stencil1d.stencil1d_resident, stencil1d.stencil1d_resident_plain,
                          stencil1d.stencil1d_step)
    plans = []
    if 2 * (-(-lay.rounded // 4) + 4 * r + 64) * 4 <= 232448:
        plans.append(stencil1d.make_run_plan(lay.rounded, r, 4, 4, 2))
    for fill in _fills_1d(reference.random_padded(spec, (n,), seed=3)):
        x = lay.to_internal(fill, BF16, cuda)
        keep = x.clone()
        for steps in (1, 2, 7):
            before = _bf16_counts(w), w.launches_run
            got = w(x, spec, lay, steps)
            assert (_bf16_counts(w), w.launches_run) == (
                before[0][:2] + (before[0][2] + 1,), before[1] + 1)
            _same(got, plain(x, spec, lay, steps))
            _same(got, _steps(step, x, spec, lay, steps))
            for plan in plans:
                run = stencil1d._lanes_run if narrow else stencil1d._wide_run
                _same(run(x, spec, lay, steps, plan), got)
        assert torch.equal(x, keep)


_WRAPPERS_1D = {"resident_lanes": "stencil1d_resident_lanes", "resident": "stencil1d_resident",
                "lanes": "stencil1d_lanes_step", "flat": "stencil1d_step"}


@pytest.mark.parametrize("name,n,kw,path", [
    ("1d1r", 4096, {}, "resident_lanes"),
    ("1d2r", 1_000_000, {}, "resident_lanes"),
    ("1d2r", 1_200_000, {}, "lanes"),
    ("1d2r", 4096, {"algorithm": "vpu"}, "resident"),
    ("1d2r", 300_000, {"algorithm": "vpu"}, "flat"),
    ("1d2r", 1_200_000, {"algorithm": "vpu_roll"}, "lanes"),
    ("1d1r", 4096, {"boundary": "periodic"}, "flat"),
    ("1d2r", 1_200_000, {"boundary": "reflect"}, "lanes"),
    ("r40", 100_000, {}, "resident"),
])
def test_bf16_1d_engine_on_card(cuda, name, n, kw, path):
    """The bf16 1-D engine on the card equals the twins' engine on the CPU bit
    for bit (the 1-D kernels round every operation as their twins do), on
    every path and boundary, launching only bf16 instances, one a run or
    pass; within 5e-2 of the ground truth after 3 steps (dirichlet0)."""
    spec = _spec_1d(name)
    config = engine._config(dict(kw, dtype="bfloat16"))
    eng = engine.StencilEngine(spec, (n,), config, device=cuda)
    twin = engine.StencilEngine(spec, (n,), config, device="cpu")
    assert eng.path == twin.path == path
    g0 = reference.random_padded(spec, (n,), seed=9)
    wrappers = [getattr(stencil1d, w) for w in _WRAPPERS_1D.values()]
    for steps in (1, 2, 5):
        before = [_bf16_counts(w) for w in wrappers]
        out = eng.run(g0, steps)
        after = [_bf16_counts(w) for w in wrappers]
        assert all(a[:2] == b[:2] for a, b in zip(after, before))
        launched = {w.__name__: a[2] - b[2] for w, a, b in zip(wrappers, after, before)
                    if a[2] != b[2]}
        passes = 1 if path.startswith("resident") else -(-steps // eng._fused_k())
        assert launched == {_WRAPPERS_1D[path]: passes}
        assert out.dtype == BF16 and out.is_cuda
        assert torch.equal(out.cpu(), twin.run(g0, steps))
    if "boundary" not in kw:
        want = reference.run(g0, spec, 3)
        got = eng.run(g0, 3).cpu().double().numpy()
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("guard", ["aligned", (2, 5, 7)])
@pytest.mark.parametrize("interior", [(6, 20, 150), (37, 45, 130)])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_bf16_march_kernel_rounds_the_float32_pass(cuda, name, interior, guard):
    """#8's bf16 march kernel at K = 1 and 2, with 8-byte quads or (guard
    (2, 5, 7)) one-cell copies: against the float32 march pass of the
    widened input, rounded, and the bf16 general kernel on the integer,
    pi/100 and inf fills, the twin on the integer fill; counted in
    launches_bf16 and launches_march."""
    spec = get_shape(name)
    w = stencil3d.stencil3d_step
    for K in (1, 2):
        assert stencil3d.march_takes(spec, BF16, K)
        lay = Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(*interior[1:]),
                       guard=guard_3d(spec.halo, K * spec.radius) if guard == "aligned"
                       else guard)
        g0 = reference.random_padded(spec, interior, seed=6)
        for fill in _3d_fills(g0):
            x = lay.to_internal(fill, BF16, cuda)
            before = _bf16_counts(w), w.launches_march
            got = w(x, torch.zeros_like(x), spec, lay, fused_steps=K)
            assert (_bf16_counts(w), w.launches_march) == (
                before[0][:2] + (before[0][2] + 1,), before[1] + 1)
            f32 = x.float()
            _same(got, w(f32, torch.zeros_like(f32), spec, lay, fused_steps=K).to(BF16))
            _same(got, _general_3d(x, spec, lay, K))
            if fill is g0:
                _same(got, stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, K))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("case", ["star3d1r", "box_r2", "star_r3", "r0"])
def test_bf16_general_kernel_rounds_the_float32_pass(cuda, case, K):
    """#8's bf16 general kernel (radius 0-3, K = 1 and 3): against the
    float32 general pass of the widened input, rounded, on the integer,
    pi/100 and inf fills, and the twin on the integer fill."""
    if case == "r0":
        spec = engine.StencilEngine.for_coeffs(np.array([[[0.75]]]), (8, 8, 8),
                                               device="cpu").spec
    elif case == "star3d1r":
        spec = get_shape(case)
    else:
        spec = _kinds_3d(case[:-3], int(case[-1]), seed=int(case[-1]))
    interior = (21, 45, 130)
    lay = Layout3D(interior=interior, halo=spec.halo, tile=default_tile_3d(*interior[1:]),
                   guard=guard_3d(spec.halo, K * spec.radius))
    g0 = reference.random_padded(spec, interior, seed=7)
    for fill in _3d_fills(g0):
        x = lay.to_internal(fill, BF16, cuda)
        got = _general_3d(x, spec, lay, K)
        _same(got, _general_3d(x.float(), spec, lay, K).to(BF16))
        if fill is g0:
            _same(got, stencil3d.stencil3d_step_plain(x, torch.zeros_like(x), spec, lay, K))


@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_bf16_3d_engine_on_card(cuda, name, boundary):
    """The bf16 3-D engine (k = 2, the march kernel) on the card against the
    twins' engine on the CPU: bit for bit on the integer fill at 1-3 steps,
    launching only bf16 instances, one a pass; within 5e-2 of the ground
    truth after 3 steps."""
    interior = (20, 40, 200)
    kw = dict(dtype="bfloat16", boundary=boundary)
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda, **kw)
    twin = engine.StencilEngine.for_shape(name, interior, device="cpu", **kw)
    assert eng._fused_k() == 2
    g0 = reference.random_padded(eng.spec, interior, seed=8)
    w = stencil3d.stencil3d_step
    for steps in (1, 2, 3):
        before = _bf16_counts(w), w.launches_march
        out = eng.run(g0, steps)
        passes = -(-steps // 2)
        assert (_bf16_counts(w), w.launches_march) == (
            before[0][:2] + (before[0][2] + passes,), before[1] + passes)
        assert out.dtype == BF16 and torch.equal(out.cpu(), twin.run(g0, steps))
    truth = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    want = truth(g0, eng.spec, 3)
    assert np.abs(out.cpu().double().numpy() - want).max() <= 5e-2 * np.abs(want).max()


# -- region launches and the sharded 2-D engines (ROADMAP A11(a)) ------------------
def _region_cases():
    ones11, ones129 = (1.0,) * 11, (1.0,) * 129
    box_r5 = StencilSpec(name="box r5", ndim=2, radius=5, halo=(5, 5),
                         terms=(SeparableTerm(taps=(ones11, ones11)),), residue=(),
                         fuse_factor=1)
    cross_r64 = StencilSpec(name="cross r64", ndim=2, radius=64, halo=(64, 64),
                            terms=(SeparableTerm(taps=(ones129, None)),
                                   SeparableTerm(taps=(None, ones129))),
                            residue=(), fuse_factor=1)
    # (kernel, spec, k, the counter its launches add to)
    return {"strip": (get_shape("star2d1r"), 1, "launches_k1"),
            "fused strip": (get_shape("star2d3r"), 2, "launches_fused_strip"),
            "tile": (box_r5, 1, None),
            "fused tile": (get_shape("star2d1r"), 2, None),
            "wide": (cross_r64, 1, "launches_wide")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["strip", "fused strip", "tile", "fused tile", "wide"])
def test_region_launches_match_the_twin(cuda, kernel, dtype):
    """Each 2-D kernel over the five windows of a 3 x 3 split of the tile grid
    and a one-tile window, with a shard's box (a start beyond the guard, an end
    inside the interior): bit for bit against the twin with the same window on
    the integer fill, every cell outside the window left as it was (NaN)."""
    spec, k, counter = _region_cases()[kernel]
    interior = (300, 1100)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=(32, 128),
                   guard=guard_2d(spec.halo, k * spec.radius))
    gi, gj = lay.grid
    a, b, c, d = gi // 3, 2 * gi // 3, gj // 3, 2 * gj // 3
    windows = [((0, a), (0, gj)), ((b, gi), (0, gj)), ((a, b), (0, c)), ((a, b), (d, gj)),
               ((a, b), (c, d)), ((gi - 1, gi), (gj - 1, gj))]
    bounds = (-1000, interior[0] - 10, -1000, interior[1] - 100)
    g = np.random.default_rng(8).integers(0, 100, lay.shape).astype(np.float32)
    x = torch.as_tensor(g, device=cuda).to(dtype)
    step = stencil2d.stencil2d_step
    for region in windows:
        before = (step.launches_region, getattr(step, counter) if counter else 0)
        got = step(x, torch.full_like(x, float("nan")), spec, lay, fused_steps=k,
                   bounds=bounds, region=region)
        want = stencil2d.stencil2d_step_plain(x, torch.full_like(x, float("nan")), spec,
                                              lay, k, bounds, region)
        torch.cuda.synchronize()
        assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0)), (kernel, region)
        assert step.launches_region == before[0] + 1
        if counter:
            assert getattr(step, counter) == before[1] + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "df64"])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
def test_sharded_engine_on_card(cuda, tiled_2d, boundary, dtype):
    """A (2, 2) mesh of shards on one card against the single-device engine at
    the same depth, bit for bit, the overlapped step's region launches (or
    df64's ring-out step) counted."""
    from lorastencil_tpu_torch.parallel import domain

    name, interior = "star2d1r", (300, 1200)
    spec = get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=6) * (np.pi / 100)
    kw = dict(dtype=dtype, boundary=boundary)
    eng = domain.sharded_engine(name, interior, (2, 2), devices=[cuda] * 4, **kw)
    single = engine.StencilEngine.for_shape(name, interior, device=cuda, fused_steps=1, **kw)
    before = stencil2d.stencil2d_step.launches_region
    got = eng.run(g0, 3)
    assert torch.equal(got, single.run(g0, 3))
    regions = stencil2d.stencil2d_step.launches_region - before
    assert regions == (0 if dtype == "df64" else 3 * 4 * 5)


# -- region launches in 1-D and 3-D, the sharded 1-D and 3-D engines (A11(b), (c)) --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kernel", ["wide", "narrow"])
def test_region_1d_launches_match_the_twin(cuda, kernel, dtype):
    """Each 1-D pass kernel (wide_kernel; lanes_kernel, or pass_kernel<double>
    in float64) over the overlapped step's windows (head, tail, inner), a
    split into thirds and a one-tile window, with a shard's box (a start beyond
    the guard, an end inside the interior): bit for bit against the twin with
    the same window, every cell outside the window left as it was (NaN)."""
    spec = get_shape("1d2r")
    k = 3 if kernel == "wide" else 2
    n = 5 * TILE_1D + 100
    lay = Layout1D(interior=n, halo=4, tile=TILE_1D, guard=guard_1d(4, k * 4))
    (g,) = lay.grid
    windows = [(0, 1), (g - 1, g), (1, g - 1), (0, 2), (2, 4), (4, g), (3, 4)]
    bounds = (-5000, n - 150)
    x = torch.as_tensor(np.random.default_rng(8).integers(0, 100, lay.shape),
                        device=cuda).to(dtype)
    step = stencil1d.stencil1d_step if kernel == "wide" else stencil1d.stencil1d_lanes_step
    for region in windows:
        before = (step.launches_region, stencil1d.stencil1d_lanes_step.launches_lanes)
        got = step(x, torch.full_like(x, float("nan")), spec, lay, fused_steps=k,
                   bounds=bounds, region=region)
        plain = (stencil1d.stencil1d_step_plain if kernel == "wide"
                 else stencil1d.stencil1d_lanes_step_plain)
        want = plain(x, torch.full_like(x, float("nan")), spec, lay, k, bounds, region)
        torch.cuda.synchronize()
        assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0)), (kernel, region)
        assert step.launches_region == before[0] + 1
        lanes = kernel == "narrow" and dtype != torch.float64
        assert stencil1d.stencil1d_lanes_step.launches_lanes == before[1] + lanes


def test_region_1d_refuses_a_window_off_the_quads(cuda):
    """The narrow pass's entry refuses a window whose first cell is off its
    16-byte quads: no scalar copies stand in."""
    spec = get_shape("1d2r")
    lay = Layout1D(interior=4 * TILE_1D, halo=4, tile=TILE_1D, guard=8)
    x = torch.ones(lay.shape, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil1d._lanes(x, torch.zeros_like(x), spec, lay, 1, window=(2, 2 + TILE_1D))
    stencil1d._lanes(x, torch.zeros_like(x), spec, lay, 1, window=(4, 4 + TILE_1D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kernel", ["march", "general"])
def test_region_3d_launches_match_the_twin(cuda, kernel, dtype):
    """The march kernel (star3d1r, k = 2) and the general kernel (star3d1r,
    k = 4) over the overlapped step's five windows and a one-tile window,
    with a z-sharded shard's box (starts beyond the guard, ends inside the
    interior in every axis): bit for bit against the twin with the same
    window on the integer fill (power-of-two taps: the kernels' fused
    multiply-adds round nothing), the rest left as it was."""
    spec, k = get_shape("star3d1r"), (2 if kernel == "march" else 4)
    interior = (9, 100, 300)
    lay = Layout3D(interior=interior, halo=spec.halo, tile=(32, 64),
                   guard=guard_3d(spec.halo, k * spec.radius))
    gi, gj = lay.grid
    windows = [((0, 1), (0, gj)), ((gi - 1, gi), (0, gj)), ((1, gi - 1), (0, 1)),
               ((1, gi - 1), (gj - 1, gj)), ((1, gi - 1), (1, gj - 1)), ((1, 2), (2, 3))]
    bounds = (-100, 7, -1000, 90, -1000, 270)
    x = torch.as_tensor(np.random.default_rng(9).integers(0, 100, lay.shape),
                        device=cuda).to(dtype)
    step = stencil3d.stencil3d_step
    for region in windows:
        before = (step.launches_region, step.launches_march)
        got = step(x, torch.full_like(x, float("nan")), spec, lay, fused_steps=k,
                   bounds=bounds, region=region)
        want = stencil3d.stencil3d_step_plain(x, torch.full_like(x, float("nan")), spec, lay,
                                              k, bounds, region)
        torch.cuda.synchronize()
        assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0)), (kernel, region)
        assert step.launches_region == before[0] + 1
        assert step.launches_march == before[1] + (kernel == "march")


def test_smem_bytes_mirror_matches_the_kernel(cuda):
    """``stencil3d.smem_bytes`` (which sizes every general-kernel pass, and the
    region refusal on the CPU) against the kernel's own
    ``ls_stencil3d_smem_bytes``, over radii, depths, tiles and term mixes."""
    lib = stencil3d._lib()
    for radius in range(0, 9):
        for K in range(1, 9):
            for bm, bn in stencil3d.BLOCK_TILES:
                for n_buf, ring, plan_len in ((0, 1, 7), (1, 3, 13), (6, 5, 100), (14, 9, 400)):
                    for itemsize in (4, 8):
                        assert stencil3d.smem_bytes(radius, K, bm, bn, n_buf, ring, plan_len,
                                                    itemsize) == lib.ls_stencil3d_smem_bytes(
                            radius, K, bm, bn, n_buf, ring, plan_len, itemsize)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "df64"])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
def test_sharded_1d_engine_on_card(cuda, boundary, dtype):
    """A (4,) mesh of shards on one card (a tailed last block under a ghost
    boundary) against the single-device engine's kernel family at the same
    depth, bit for bit; the overlapped step's region launches counted."""
    from lorastencil_tpu_torch.parallel import domain

    name, n = "1d2r", 50_001
    spec = get_shape(name)
    g0 = reference.random_padded(spec, (n,), seed=6) * (np.pi / 100)
    eng = domain.sharded_engine(name, n, (4,), devices=[cuda] * 4, dtype=dtype,
                                boundary=boundary)
    alg = "auto" if dtype == "df64" else "mxu" if eng.lanes else "vpu"
    single = engine.StencilEngine(spec, (n,), engine.EngineConfig(
        dtype=dtype, boundary=boundary, fused_steps=eng.fused_steps, algorithm=alg), device=cuda)
    before = stencil1d.stencil1d_step.launches_region
    got = eng.run(g0, 3)
    regions = stencil1d.stencil1d_step.launches_region - before
    want = single.run(g0, 3)
    if dtype == "df64" and not eng.lanes:
        assert (got - want).abs().max() <= 1e-15 * want.abs().max()
    else:
        assert torch.equal(got, want)
    assert regions == (0 if dtype == "df64" else 3 * 4 * 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "df64"])
@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic", "reflect"])
@pytest.mark.parametrize("mesh", [(2, 2), (2, 2, 2)])
def test_sharded_3d_engine_on_card(cuda, mesh, boundary, dtype):
    """Meshes of shards on one card -- (2, 2) overlapped, (2, 2, 2) z-sharded
    ring-out -- against the single-device engine at the same depth, bit for
    bit; the region launches counted."""
    from lorastencil_tpu_torch.parallel import domain

    name, interior = "star3d1r", (10, 180, 760)
    spec = get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=6) * (np.pi / 100)
    k = 1 if dtype == "df64" else 2
    eng = domain.sharded_engine(name, interior, mesh, devices=[cuda] * int(np.prod(mesh)),
                                dtype=dtype, boundary=boundary, fused_steps=k, tile=(32, 64))
    single = engine.StencilEngine(spec, interior, engine.EngineConfig(
        dtype=dtype, boundary=boundary, fused_steps_3d=k), device=cuda)
    before = stencil3d.stencil3d_step.launches_region
    got = eng.run(g0, 4)
    regions = stencil3d.stencil3d_step.launches_region - before
    assert torch.equal(got, single.run(g0, 4))
    overlapped = eng._step_fn().__name__ == "_local_step_overlap"
    assert overlapped == (len(mesh) == 2 and dtype != "df64")
    assert regions == (4 // k * 4 * 5 if overlapped else 0)


def test_dryrun_multichip_on_card(cuda):
    from lorastencil_tpu_torch.parallel import dryrun

    dryrun.dryrun_multichip(8, devices=[cuda] * 8)


# -- the last modules: every algorithm name, autotune, profiling, checkpoints --
@pytest.mark.parametrize("name,interior", [("star2d3r", (96, 256)), ("star3d1r", (6, 20, 150))])
@pytest.mark.parametrize("alg", ["mxu", "mxu_split", "mxu_hybrid1r", "mxu_hybrid3"])
def test_every_algorithm_name_on_card(cuda, tiled_2d, name, interior, alg):
    """The names B13 accepted run the exact kernel at the JAX engine's depth
    (one step a pass): bit for bit 'mxu_hybrid1' at that depth."""
    if len(interior) == 3 and alg != "mxu":
        pytest.skip("3-D takes 'mxu' only of these (the JAX engine's rule)")
    g0 = reference.random_padded(get_shape(name), interior, seed=9)
    eng = engine.StencilEngine.for_shape(name, interior, device=cuda, algorithm=alg)
    assert eng._fused_k() == 1
    kw = {"fused_steps_3d" if len(interior) == 3 else "fused_steps": 1}
    want = engine.StencilEngine.for_shape(name, interior, device=cuda, **kw).run(g0, 3)
    assert torch.equal(eng.run(g0, 3), want)


def test_autotune_on_card(cuda, tmp_path, monkeypatch):
    """autotune_params on a tiny grid in a fresh cache: a winner among the
    candidates, served from the cache the second time with no launch, and a
    tuned engine that is exact."""
    from lorastencil_tpu_torch.utils import autotune

    monkeypatch.setenv("LORASTENCIL_CACHE", str(tmp_path))
    kw = autotune.autotune_params("star2d1r", (64, 256), steps=2)
    spec = get_shape("star2d1r")
    assert kw in [dict(c, tile=kw["tile"]) for c in autotune.candidates_2d_params(spec)]
    before = stencil2d.stencil2d_step.launches
    assert autotune.autotune_params("star2d1r", (64, 256)) == kw
    assert stencil2d.stencil2d_step.launches == before
    eng = engine.StencilEngine.for_shape("star2d1r", (64, 256), device=cuda, **kw)
    g0 = reference.random_padded(spec, (64, 256), seed=2)
    assert np.array_equal(eng.run(g0, 2).cpu().numpy(), reference.run(g0, spec, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune_params("star2d1r", (16, 128), device="cpu")


def test_trace_names_the_kernel_on_card(cuda, tiled_2d, tmp_path):
    from lorastencil_tpu_torch.utils import profiling

    eng = engine.StencilEngine.for_shape("star2d1r", (512, 512), device=cuda)
    g0 = reference.random_padded(eng.spec, (512, 512), seed=1)
    eng.run(g0, 1)
    with profiling.trace(str(tmp_path)):
        eng.run(g0, 4)
    shares = profiling.kernel_shares(str(tmp_path / "trace.json"))
    assert sum(v for k, v in shares.items() if "strip_kernel" in k) > 0.1
    assert profiling.engine_roofline(eng).governing_gcells > 0


def test_sharded_checkpoint_round_trip_on_card(cuda, tmp_path):
    from lorastencil_tpu_torch.parallel import domain
    from lorastencil_tpu_torch.utils import checkpoint

    eng = domain.sharded_engine("star2d1r", (256, 512), (2, 2), devices=[cuda] * 4)
    state0 = eng.to_sharded(reference.random_padded(eng.spec, (256, 512), seed=4))
    want = eng._run(state0, 6)
    ck = checkpoint.ShardedCheckpointer(str(tmp_path))
    ck.save(3, eng._run(state0, 3), "star2d1r")
    ck.wait()
    back, meta = ck.restore(ck.latest_step(), state0)
    ck.close()
    assert meta == {"shape": "star2d1r", "step": 3}
    assert all(b.device == state0[c].device for c, b in back.items())
    got = eng._run(back, 3)
    assert all(torch.equal(got[c], want[c]) for c in want)


# -- the plan strip and plan march kernels (csrc/plan2d.cu, csrc/plan3d.cu) ----
def _plan_cases():
    import chip_smoke

    for dims, name, interior, k, dtype in chip_smoke.plan_check_cases():
        yield pytest.param(dims, name, interior, k, dtype,
                           id=f"{name}-{interior}-k{k}-{str(dtype)[6:]}")


@pytest.mark.parametrize("dims,name,interior,k,dtype", list(_plan_cases()))
def test_plan_kernel_on_card(cuda, dims, name, interior, k, dtype):
    """Each plan kernel on its own entry in every dtype and depth it takes
    (chip_smoke.py phase 28 (a)): bit for bit against its twin on the 0/1
    fill with dyadic taps at 1 and 2 passes (float64 on the pi/100 fill
    too), against the kernel it replaces (step_kernel, stencil3d_kernel) on
    the pi/100 fill, under a ghost ring's box and over a window of tiles;
    each launch counted."""
    import chip_smoke

    assert chip_smoke.check_plan_case(dims, name, interior, k, dtype, cuda)


def _plan_engine_cases():
    # reflect fuses only per-axis symmetric coefficients (the engine's rule):
    # the asymmetric specs take it at one step a pass
    for name, interior, kw, counter in (
            ("9x9 rank 4", (100, 300), {}, "stencil2d_plan_strip"),
            ("9x9 rank 4", (100, 300), {"dtype": "df64"}, "stencil2d_plan_strip"),
            ("5x5 asym", (70, 250), {"fused_steps": 2, "dtype": "bfloat16"},
             "stencil2d_plan_strip"),
            ("star2d1r", (64, 200), {"fused_steps": 3, "dtype": "bfloat16"},
             "stencil2d_plan_strip"),
            ("per-plane", (20, 40, 70), {}, "stencil3d_plan_march"),
            ("per-plane", (20, 40, 70), {"dtype": "df64"}, "stencil3d_plan_march"),
            ("star r4", (20, 40, 70), {}, "stencil3d_plan_march")):
        for boundary in ("dirichlet0", "periodic", "reflect"):
            opts = kw
            if boundary == "reflect" and name == "5x5 asym":
                continue  # at one step a pass the strip kernel's (phase 22)
            if boundary == "reflect" and name == "per-plane" and not kw:
                opts = {"fused_steps_3d": 1}
            yield pytest.param(name, interior, opts, counter, boundary,
                               id=f"{name}-{opts}-{boundary}")


@pytest.mark.parametrize("name,interior,kw,counter,boundary", list(_plan_engine_cases()))
def test_plan_kernels_through_the_engine_every_boundary(cuda, tiled_2d, name, interior,
                                                        kw, counter, boundary):
    """The named cases through StencilEngine under each boundary (the ghost
    rings' bounds on the plan kernels' levels before the last): run(2k) of
    the dyadic twin on the 0/1 fill, every launch the plan kernel's, bit
    for bit against the engine's run with the plain twins."""
    import chip_smoke

    eng = chip_smoke.plan_engine(name, interior, cuda, boundary=boundary, **kw)
    k = eng._fused_k()
    deng = engine.StencilEngine(chip_smoke.dyadic(eng.spec), interior, eng.config,
                                device=cuda)
    g01 = reference.random_padded(eng.spec, interior, seed=21) % 2
    chip_smoke.reset_counts()
    got = deng.run(g01, 2 * k)
    torch.cuda.synchronize()
    c = chip_smoke.counts()
    assert c[counter] == 2 and not c["stencil2d_k1"] and not c["stencil3d_march"]
    with chip_smoke.twins():
        want = deng.run(g01, 2 * k)
    _same(got, want)


def _ghost_split_cases():
    for name, interior, kw in (("star2d1r", (64, 200), {"fused_steps": 2}),
                               ("star2d1r", (64, 200), {"fused_steps": 2, "dtype": "float64"}),
                               ("box2d3r", (60, 140), {"fused_steps": 3}),
                               ("5x5 asym", (70, 250), {"fused_steps": 2})):
        for boundary in ("periodic", "reflect"):
            if boundary == "reflect" and name == "5x5 asym":
                continue  # reflect fuses only per-axis symmetric coefficients
            yield pytest.param(name, interior, kw, boundary, id=f"{name}-{kw}-{boundary}")


@pytest.mark.parametrize("name,interior,kw,boundary", list(_ghost_split_cases()))
def test_ghost_ring_pass_runs_strip_launches(cuda, tiled_2d, monkeypatch, name, interior,
                                            kw, boundary):
    """A float32 or float64 pass that ``stencil2d.strips_beat_plan`` sends to
    strip launches keeps that route under a ghost ring, the engine's refresh
    refilling the ring between them: run(2k) of the dyadic twin on the 0/1
    fill is 2k strip launches, none of a plan or fused strip kernel, bit for
    bit against the same launches' plain versions with the refreshes between
    them.  Periodic also bit for bit against the engine's run with the plain
    twins, whose fused levels keep the ring: a wrapped ring cell sums what
    its interior cell sums, in the same order.  A reflected one sums its
    mirror image in the mirrored order, which can round otherwise once the
    sums pass 2**24 (box2d3r's six steps)."""
    import chip_smoke

    eng = chip_smoke.plan_engine(name, interior, cuda, boundary=boundary, **kw)
    k = eng._fused_k()
    deng = engine.StencilEngine(chip_smoke.dyadic(eng.spec), interior, eng.config,
                                device=cuda)
    g01 = reference.random_padded(eng.spec, interior, seed=21) % 2
    chip_smoke.reset_counts()
    got = deng.run(g01, 2 * k)
    torch.cuda.synchronize()
    c = chip_smoke.counts()
    assert (c["stencil2d_k1"], c["stencil2d_plan_strip"], c["stencil2d_fused_strip"]) == (
        2 * k, 0, 0)
    if boundary == "periodic":
        with chip_smoke.twins():
            _same(got, deng.run(g01, 2 * k))

    def plain(kind, buffers, spec, layout, depth, bounds=None, region=None, **_):
        stencil2d.stencil2d_step_plain(*buffers, spec, layout, depth, bounds, region)

    monkeypatch.setattr(stencil2d, "_launch", plain)
    _same(got, deng.run(g01, 2 * k))


# -- the strip walk's reach (chip_smoke.py phase 29): the plan strip kernel at depth 4
# and radius 5-8, stencil2d_skew_step on the walk; none of step_kernel or skew_kernel
def _reach_cases():
    import chip_smoke

    for name, interior, k, dtype in chip_smoke.reach_check_cases():
        yield pytest.param(name, interior, k, dtype,
                           id=f"{name}-{interior}-k{k}-{str(dtype)[6:]}")


@pytest.mark.parametrize("name,interior,k,dtype", list(_reach_cases()))
def test_reach_kernel_on_card(cuda, name, interior, k, dtype):
    """Each new plan strip instance on its own entry (chip_smoke.py phase 29
    (a), ``check_plan_case``): bit for bit against its twin on the 0/1 fill
    with dyadic taps at 1 and 2 passes (float64 on the pi/100 fill too),
    against step_kernel on the pi/100 fill, under a ghost ring's box and over
    a window of tiles."""
    import chip_smoke

    assert chip_smoke.check_plan_case(2, name, interior, k, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_plan_warp_bytes_are_the_kernels(cuda, dtype):
    """``stencil2d.plan_warp_bytes``, which decides ``plan_strip_takes`` and
    ``tile_beats_plan``, equals the shared memory a warp of the kernel's own
    launch takes (csrc/plan2d.cu ls_stencil2d_plan_strip_warp_bytes*, through
    the launch's own choice of instance) at every radius 1-8, term count 1-9
    and depth of ``plan_strip_depths``; the kernel refuses every other
    depth."""
    import ctypes

    lib = stencil2d._plan_lib_bf16() if dtype == torch.bfloat16 else stencil2d._plan_lib()
    fn = getattr(lib, "ls_stencil2d_plan_strip_warp_bytes"
                 + {torch.float64: "_f64", torch.bfloat16: "_bf16"}.get(dtype, ""))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    for R in range(1, 9):
        taps = (1.0,) * (2 * R + 1)
        for nt in range(1, stencil2d.PLAN_MAX_TERMS + 1):
            spec = StencilSpec(name=f"r{R} x{nt}", ndim=2, radius=R, halo=(R, R),
                               terms=(SeparableTerm(taps=(taps, taps)),) * nt,
                               residue=(), fuse_factor=1)
            for k in range(1, 5):
                want = (stencil2d.plan_warp_bytes(spec, dtype, k)
                        if k in stencil2d.plan_strip_depths(R, dtype) else -1)
                assert fn(nt, R, k) == want, (R, nt, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("name,interior,k", [("star2d1r", (200, 300), 2),
                                             ("5x5 asym", (133, 217), 2),
                                             ("custom_r5", (133, 217), 2),
                                             ("r6 residue", (100, 140), 3)])
def test_reach_skew_on_card(cuda, name, interior, k, dtype):
    """``stencil2d_skew_step`` on the walk (chip_smoke.py phase 29 (a),
    ``check_reach_skew``): every launch on the skew wrapper, none of
    skew_kernel, bit for bit against skew_kernel and the twin."""
    import chip_smoke

    assert chip_smoke.check_reach_skew(name, interior, k, dtype, cuda)


def _reach_engine_cases():
    import chip_smoke

    for label, name, _, kw in chip_smoke.REACH_CASES:
        yield pytest.param(label, name, kw, id=label)


@pytest.mark.parametrize("label,name,kw", list(_reach_engine_cases()))
def test_reach_engine_on_card(cuda, tiled_2d, label, name, kw):
    """Each phase 29 case through StencilEngine at a small interior: run(2k)
    of the dyadic twin on the 0/1 fill, its launches those of
    ``chip_smoke.reach_route`` (step_kernel or skew_kernel only where
    ``stencil2d.tile_beats_plan`` says), bit for bit against the engine's
    run with the plain twins."""
    import chip_smoke

    interior = (100, 300)
    eng = chip_smoke.reach_engine(name, interior, cuda, **kw)
    k = eng._fused_k()
    want = chip_smoke.reach_route(eng)
    deng = engine.StencilEngine(chip_smoke.dyadic(eng.spec), interior, eng.config,
                                device=cuda)
    g01 = reference.random_padded(eng.spec, interior, seed=29) % 2
    chip_smoke.reset_counts()
    got = deng.run(g01, 2 * k)
    torch.cuda.synchronize()
    c = chip_smoke.counts()
    assert {n: c[n] for n in want} == want
    assert not any(c[t] for t in chip_smoke.TILE_COUNTERS if t not in want)
    with chip_smoke.twins():
        _same(got, deng.run(g01, 2 * k))
