"""The host-side plans of the wide 1-D pass and of the 2-D strip kernel
(csrc/stencil1d.cu wide_kernel, csrc/stencil2d.cu strip_kernel), and a plain
PyTorch emulation of each kernel's per-cell loop held against the plain twin
it must equal (ops/stencil1d.stencil1d_step_plain, ops/stencil2d.
stencil2d_step_plain).  CPU only; the kernels themselves are held against the
twins on the card by tests/test_torch_cuda.py.

What the emulations repeat: the 1-D pass's tiles of ``pass_tile`` cells, the
window staged with zeros outside the buffer, the substeps over extents that
shrink by r, each masked to the interior, and per cell the nonzero
(offset, weight) pairs of ``wide_taps`` summed in their order, the first
product standing alone; the strip kernel's strips of 64 rows walked row by
row, the column conv of each input row computed once per term and kept for
the 2R + 1 rows the row conv reads, the row conv, the sum over terms from 0,
then the residue point by point from the raw rows.  The 2-D kernel fuses each
multiply-add in fp32; the emulation takes the twin's product then sum, so it
checks the order of the kernel's sums, which is all the strip kernel changes
(the card tests hold the strip kernel bit for bit against the tile kernel
that it replaces on the main path).  Tolerance: none.  Both emulations equal
the twins bit for bit in float32 and float64, on the integer fill, on the
pi/100 fill and on a fill holding an inf (NaN where the twin has NaN)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec, get_shape
from lorastencil_tpu_torch.ops import stencil1d, stencil2d
from lorastencil_tpu_torch.ops.band_gemm import plan_array
from lorastencil_tpu_torch.ops.layout import (TILE_1D, Layout1D, Layout2D, default_tile_2d,
                                              guard_1d, guard_2d)
from lorastencil_tpu_torch.utils import reference

SHAPES_2D = ["star2d1r", "box2d1r", "box2d3r", "star2d3r"]
DTYPES = [torch.float32, torch.float64]
FILLS = ["integer", "pi", "inf"]
SMS = 132  # the H100's SMs: the tile choice the card makes


def _same(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _fill(g0, fill):
    if fill == "integer":
        return g0
    x = g0 * (np.pi / 100)
    if fill == "inf":
        x = x.copy()
        x.flat[x.size // 3] = np.inf
    return x


def _taps_1d(r, seed):
    """for_coeffs taps of effective radius r: integers in [-3, 3] over 256,
    a third of them zero."""
    taps = np.random.default_rng(seed).integers(-3, 4, 2 * r + 1) / 256.0
    taps[np.random.default_rng(seed + 1).random(2 * r + 1) < 0.33] = 0.0
    taps[0] = taps[-1] = 1.0 / 256.0
    taps[r] = 0.0  # a zero centre: the first product is a +-d one
    return taps


def _spec_1d(name):
    if name.startswith("r"):
        r = int(name[1:])
        return engine.StencilEngine.for_coeffs(_taps_1d(r, r), (64,), name=name,
                                               device="cpu").spec
    return get_shape(name)


# -- the wide 1-D pass -------------------------------------------------------
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40", "r127"])
def test_wide_taps_are_the_nonzero_taps_in_the_twin_order(name):
    spec = _spec_1d(name)
    offsets, weights = stencil1d.wide_taps(spec)
    taps = stencil1d.dense_taps(spec)
    mid = (len(taps) - 1) // 2
    r = stencil1d.effective_radius(spec)
    want = [(0, taps[mid])] + [(o, taps[mid + o]) for d in range(1, r + 1) for o in (d, -d)]
    assert list(zip(offsets, weights)) == [(o, w) for o, w in want if w != 0.0]
    assert len(offsets) == sum(1 for t in taps if t != 0.0)


def test_wide_param_struct_fits_a_launch_at_r127_in_fp64():
    # the struct's bytes, then the kernel's two pointers and seven ints
    assert stencil1d.wide_param_bytes(torch.float64) == 4 + 255 * 4 + 255 * 8  # 3,064
    assert stencil1d.wide_param_bytes(torch.float32) == 4 + 255 * 4 + 255 * 4
    assert stencil1d.wide_param_bytes(torch.float64) + 2 * 8 + 7 * 4 <= stencil1d.PARAM_LIMIT
    spec = _spec_1d("r127")
    assert len(stencil1d.wide_taps(spec)[0]) <= 2 * stencil1d.MAX_RADIUS + 1


@pytest.mark.parametrize("rounded,sms,tile", [
    (100_352, 132, 256),          # r = 40 x 100,000: 392 blocks, not 49
    (1_001_472, 132, 2048),       # 1d2r 1,000,000: 489 blocks of 2048
    (16_777_216, 132, 2048),
    (2 * 132 * 1024, 132, 1024),  # the largest tile that keeps two per SM
    (2 * 132 * 1024 - 2048, 132, 512),
    (2048, 132, 256),             # too short for two per SM: the smallest
])
def test_pass_tile_fills_the_sms(rounded, sms, tile):
    assert stencil1d.pass_tile(rounded, sms) == tile
    assert rounded % tile == 0


def _wide_emulation(cur, donor, spec, layout, k, bounds=None):
    """The wide pass as csrc/stencil1d.cu's wide_kernel runs it, tile by
    tile; the substeps before the last masked to ``bounds`` (lo, hi), the
    last to the interior."""
    offsets, weights = stencil1d.wide_taps(spec)
    weights = [float(torch.tensor(w, dtype=cur.dtype)) for w in weights]
    r = stencil1d.effective_radius(spec)
    H, o, n, nr = k * r, layout.origin, layout.interior, layout.rounded
    tile = stencil1d.pass_tile(nr, SMS)
    blo, bhi = (0, n) if bounds is None else bounds
    pad = torch.zeros(H, dtype=cur.dtype)
    buf = torch.cat([pad, cur, pad])  # zero outside the buffer
    for t0 in range(0, nr, tile):
        src = buf[o + t0: o + t0 + tile + 2 * H]  # window, from buffer o + t0 - H
        for s in range(1, k + 1):
            e = (k - s) * r
            lo, cnt = H - e, tile + 2 * e
            acc = None
            for off, w in zip(offsets, weights):
                v = w * src[lo + off: lo + off + cnt]
                acc = v if acc is None else acc + v
            if acc is None:
                acc = torch.zeros(cnt, dtype=cur.dtype)
            f = torch.arange(t0 - e, t0 - e + cnt)
            a, b = (0, n) if s == k else (blo, bhi)
            acc = torch.where((f >= a) & (f < b), acc, torch.zeros((), dtype=cur.dtype))
            src = F.pad(acc, (lo, lo))  # cells [lo, lo + cnt) of the window
        donor[o + t0: o + t0 + tile] = acc
    return donor


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["1d1r", "1d2r", "r40", "r127"])
def test_wide_emulation_equals_the_twin_bit_for_bit(name, dtype, fill):
    spec = _spec_1d(name)
    r = stencil1d.effective_radius(spec)
    n = 5001  # a ragged last tile; 256-cell tiles
    g0 = reference.random_padded(spec, (n,), seed=7)
    for k in (1, 2, 3):
        lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], k * r))
        x = lay.to_internal(_fill(g0, fill), dtype)
        want = stencil1d.stencil1d_step_plain(x, torch.zeros_like(x), spec, lay, k)
        got = _wide_emulation(x, torch.zeros_like(x), spec, lay, k)
        _same(got, want)
        if fill != "inf":
            assert bool(torch.isfinite(got).all())


# -- the 2-D strip kernel ------------------------------------------------------
def _custom_2d(R, n_terms, n_res, seed):
    """A 2-D spec of radius R: ``n_terms`` terms with integer taps (zeros
    among them, an identity axis in the second and third terms) and
    ``n_res`` residue points in no particular order."""
    rng = np.random.default_rng(seed)
    W = 2 * R + 1

    def taps():
        t = rng.integers(-3, 4, W).astype(np.float64)
        t[rng.random(W) < 0.3] = 0.0
        return tuple(float(v) for v in t)

    terms = []
    for i in range(n_terms):
        rt, ct = taps(), taps()
        if i == 1:
            rt = None
        if i == 2:
            ct = None
        terms.append(SeparableTerm(taps=(rt, ct)))
    points = [(int(a), int(b)) for a, b in rng.integers(-R, R + 1, (n_res, 2))]
    residue = tuple((p, float(rng.integers(-3, 4) or 1)) for p in points)
    return StencilSpec(name=f"custom_r{R}_t{n_terms}", ndim=2, radius=R, halo=(R, R),
                       terms=tuple(terms), residue=residue, fuse_factor=1)


CUSTOM_2D = [(1, 1, 3), (2, 2, 0), (4, 3, 9), (4, 0, 5), (3, 3, 4)]


def _strip_plan(spec, dtype):
    """plan_array parsed as csrc/stencil2d.cu fill_strip_plan parses it."""
    R, W = spec.radius, 2 * spec.radius + 1
    vals = plan_array(spec, dtype).tolist()
    terms = []
    for _ in spec.terms:
        terms.append((vals[0] != 0.0, vals[1] != 0.0, vals[2: 2 + W], vals[2 + W: 2 + 2 * W]))
        vals = vals[2 + 2 * W:]
    res = [(int(vals[3 * p]), int(vals[3 * p + 1]), vals[3 * p + 2])
           for p in range(len(spec.residue))]
    return R, terms, res


def _strip_emulation(cur, donor, spec, layout, strip_rows=64):
    """One step as csrc/stencil2d.cu's strip_kernel runs it: per strip of
    ``strip_rows`` output rows, across the whole width at once (its columns
    are independent)."""
    R, terms, res = _strip_plan(spec, cur.dtype)
    W = 2 * R + 1
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    zero = torch.zeros((), dtype=cur.dtype)
    # window columns c0 - R .. c0 + nr + R (inside the buffer: guard >= R)
    for i0 in range(0, mr, strip_rows):
        n_in = min(strip_rows, mr - i0) + 2 * R
        raw, ring = [], [[None] * W for _ in terms]
        for s in range(n_in):
            gr = r0 + i0 - R + s
            row = (cur[gr, c0 - R: c0 + nr + R] if gr < rows
                   else torch.zeros(nr + 2 * R, dtype=cur.dtype))
            raw.append(row)
            for t, (has_col, _, ct, _) in enumerate(terms):
                if has_col:
                    y = torch.zeros(nr, dtype=cur.dtype)
                    for q, w in enumerate(ct):
                        if w != 0.0:
                            y = y + w * row[q: q + nr]
                else:
                    y = row[R: R + nr]
                ring[t] = ring[t][1:] + [y]
            if s < 2 * R:
                continue
            i = i0 + s - 2 * R
            acc = torch.zeros(nr, dtype=cur.dtype)
            for t, (_, has_row, _, rt) in enumerate(terms):
                if has_row:
                    z = torch.zeros(nr, dtype=cur.dtype)
                    for q, w in enumerate(rt):
                        if w != 0.0:
                            z = z + w * ring[t][q]
                else:
                    z = ring[t][R]
                acc = acc + z
            for dr, dc, w in res:  # the plan's order
                acc = acc + w * raw[s - R + dr][R + dc: R + dc + nr]
            keep = (torch.arange(nr) < n) & (i < m)
            donor[r0 + i, c0: c0 + nr] = torch.where(keep, acc, zero)
    return donor


def _layout_2d(spec, interior, guard=None):
    return Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                    guard=guard or guard_2d(spec.halo, spec.radius))


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SHAPES_2D + [f"r{R}t{t}e{e}" for R, t, e in CUSTOM_2D])
def test_strip_emulation_equals_the_twin_bit_for_bit(case, dtype, fill):
    if case in SHAPES_2D:
        spec = get_shape(case)
    else:
        R, t, e = (int(v) for v in case[1:].replace("t", " ").replace("e", " ").split())
        spec = _custom_2d(R, t, e, seed=R * 10 + t)
    assert stencil2d.strip_takes(spec, torch.float32)
    interior = (70, 131)  # two strips, the second ragged; ragged columns
    lay = _layout_2d(spec, interior)
    g0 = reference.random_padded(spec, interior, seed=5)
    x = lay.to_internal(_fill(g0, fill), dtype)
    for steps in (1, 2):
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay)
        got = _strip_emulation(x, torch.zeros_like(x), spec, lay)
        _same(got, want)
        x = got


def test_strip_emulation_takes_a_guard_off_the_16_byte_grid():
    spec = get_shape("star2d1r")
    lay = _layout_2d(spec, (40, 100), guard=(5, 7))
    x = lay.to_internal(reference.random_padded(spec, (40, 100), seed=6) * (np.pi / 100))
    _same(_strip_emulation(x, torch.zeros_like(x), spec, lay, strip_rows=16),
          stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec, lay))


@pytest.mark.parametrize("name", SHAPES_2D)
def test_strip_dispatch_by_radius(name):
    """Every 2-D registry shape's step runs the strip kernel of its dtype
    (float32, or float64: strip64_kernel); a fused pass and a radius beyond
    4 run the tile kernel."""
    spec = get_shape(name)
    assert spec.radius in stencil2d.STRIP_RADII
    assert stencil2d.strip_takes(spec, torch.float32)
    assert stencil2d.strip_takes(spec, torch.float64)
    assert not stencil2d.strip_takes(spec, torch.float32, depth=2)
    assert not stencil2d.strip_takes(spec, torch.float64, depth=2)
    wide = _custom_2d(5, 1, 2, seed=1)
    assert not stencil2d.strip_takes(wide, torch.float32)
    assert all(stencil2d.strip_takes(_custom_2d(R, t, e, 2), torch.float32)
               for R, t, e in CUSTOM_2D)
    four = _custom_2d(2, 3, 1, seed=3)
    four = StencilSpec(name="four", ndim=2, radius=2, halo=(2, 2),
                       terms=four.terms + four.terms[:1], residue=(), fuse_factor=1)
    assert not stencil2d.strip_takes(four, torch.float32)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["1d1r", "r40"])
def test_wide_emulation_with_ghost_bounds_equals_the_twin(name, dtype, boundary):
    """Under a ghost boundary (ROADMAP A6(a)) the substeps before the last
    keep [-d, n + d), d = k * radius (1d1r: 16 at k = 4, beyond its reach
    12), which holds the ring the engine's refresh filled: the emulation
    equals the twin with the same bounds bit for bit."""
    from lorastencil_tpu_torch.engine import _ring_refresh_nd

    spec = _spec_1d(name)
    n = 5001
    g0 = reference.random_padded(spec, (n,), seed=8) * (np.pi / 100)
    for k in (2, 4):
        d = k * spec.radius
        lay = Layout1D(n, spec.halo[0], TILE_1D, guard_1d(spec.halo[0], d))
        x = _ring_refresh_nd(lay.to_internal(g0, dtype), boundary, (lay.origin,), (n,), d)
        bounds = (-d, n + d)
        want = stencil1d.stencil1d_step_plain(x, torch.zeros_like(x), spec, lay, k, bounds)
        _same(_wide_emulation(x, torch.zeros_like(x), spec, lay, k, bounds), want)
        assert not torch.equal(want, stencil1d.stencil1d_step_plain(
            x, torch.zeros_like(x), spec, lay, k))
