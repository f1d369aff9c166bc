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
        name="wide", ndim=2, radius=17, halo=(4, 4), terms=(), residue=(), fuse_factor=1)
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
    spec = _custom_2d(5, 2, 4, seed=5)
    assert not stencil2d.strip_takes(spec, torch.float32)
    lay = Layout2D(interior=(70, 140), halo=spec.halo, tile=default_tile_2d(70, 140),
                   guard=guard_2d(spec.halo, spec.radius))
    x = lay.to_internal(reference.random_padded(spec, (70, 140), seed=2), device=cuda)
    before = (stencil2d.stencil2d_step.launches, stencil2d.stencil2d_step.launches_k1)
    got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay)
    torch.cuda.synchronize()
    assert (stencil2d.stencil2d_step.launches - before[0],
            stencil2d.stencil2d_step.launches_k1 - before[1]) == (1, 0)
    assert torch.equal(got, stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay))


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
    """#1 at k > 1; "split": one step deeper than a launch takes, so the pass
    runs as two launches."""
    spec = get_shape(name)
    kmax = stencil2d.max_fused_steps("step", spec.radius, stencil2d.plan_len(spec), dtype)
    k = kmax + 1 if k == "split" else k
    lay = _layout_2d(spec, interior, k)
    g0 = reference.random_padded(spec, interior, seed=3)
    for integer, fill in ((True, g0 % 2), (False, g0 * (np.pi / 100))):
        x = lay.to_internal(fill, dtype, cuda)
        keep = x.clone()
        before = stencil2d.stencil2d_step.launches + stencil2d.stencil2d_step.launches_f64
        got = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay, fused_steps=k)
        after = stencil2d.stencil2d_step.launches + stencil2d.stencil2d_step.launches_f64
        assert after - before == -(-k // kmax)
        _agree(got, _steps(stencil2d.stencil2d_step, x, spec, lay, k), True)
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay, k)
        _agree(got, want, dtype == torch.float64 or (integer and k <= 3))
        assert torch.equal(x, keep)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,interior", SHAPES_FUSED)
def test_skew_kernel_matches_fused_kernel_and_twin(cuda, name, interior, dtype, k):
    spec = get_shape(name)
    lay = _layout_2d(spec, interior, k)
    g0 = reference.random_padded(spec, interior, seed=4)
    for integer, fill in ((True, g0 % 2), (False, g0 * (np.pi / 100))):
        x = lay.to_internal(fill, dtype, cuda)
        before = stencil2d.stencil2d_skew_step.launches + \
            stencil2d.stencil2d_skew_step.launches_f64
        got = stencil2d.stencil2d_skew_step(x, torch.zeros_like(x), spec, lay,
                                            skew_steps=k)
        assert (stencil2d.stencil2d_skew_step.launches
                + stencil2d.stencil2d_skew_step.launches_f64 - before) == 1
        _agree(got, stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay,
                                             fused_steps=k), True)
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
