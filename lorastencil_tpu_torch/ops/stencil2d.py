"""2-D stencil passes on the internal layout: the CUDA kernels' wrappers.

Counterpart of ``lorastencil_tpu/ops/pallas_2d.py`` ``stencil2d_step``
(kernel ``_stencil2d_kernel``, every fused depth), ``stencil2d_skew_step``
(``_stencil2d_skew_kernel``) and ``stencil2d_resident``
(``_stencil2d_resident_kernel``), and of ``lorastencil_tpu/ops/
pallas_df64.py`` ``df64_step`` (``_df64_kernel``) and
``stencil2d_resident_pair``.  ``csrc/stencil2d.cu`` has a float32, a
float64 and a bfloat16 instance of each kernel: a wrapper launches the one
of its state's dtype.  On a CUDA tensor a wrapper launches or raises; only
a CPU tensor runs the plain PyTorch twin (``*_plain``), which is also
callable directly (the tests and ``chip_smoke.py`` hold the kernels against
them on the card); the skew kernel's twin is the fused pass's.

``algorithm``: the TPU kernel's exact-fp32 variants ``'mxu_hybrid1'``,
``'vpu_roll'`` and ``'vpu'`` differ only in how they use the TPU's matrix
and vector units.  On Hopper they are one computation, so all three run
this one CUDA-core kernel, and so does ``'mxu_hybrid'`` (both axes on the
TPU's matrix unit, the bfloat16 tier's 'auto' for star2d3r), whose
two-part split of a float32 state is ~6e-6 a step from exact and which on
a bfloat16 state rounds a two-axis term's column conv to bf16 before its
row conv: the port computes it exactly.  The TPU's remaining variants
run it too, each at or above its class of accuracy: ``'mxu_hybrid3'``
and ``'mxu_hybrid1r'`` (three-part splits, exact-fp32-grade),
``'mxu_split'`` (every term and the residue on the matrix unit, ~6e-6 a
step) and ``'mxu'`` (the matrix unit at its own precision, ~1e-3 a step
at ``precision='default'``; one step a pass, as the JAX kernel refuses
temporal fusion under it).  The TPU's df64 variants
``'vpu'``, ``'vpu_roll'`` and ``'vpu_sep'`` (dense rolls, dense slices,
separable form on (hi, lo) fp32 pairs) are likewise one native-fp64
computation: all three run the float64 instance.

The bfloat16 state tier stores bf16 and computes in fp32: each kernel
widens a cell at its load (exact) and rounds at its store to nearest even,
as JAX's ``astype`` and torch's ``.to`` do; the taps stay float32.  The
rounding rule: a tiled pass (strip, fused strip, tile, fused and skew
kernels) rounds once a pass, at its store; its fused levels stay fp32.
That is JAX's 'vpu_roll' extent pass, and at k = 1 every JAX name but
'mxu_hybrid' on a spec with a two-axis term.  JAX's 'mxu_hybrid' and
'mxu_hybrid1' at k >= 2 also round a fused level through their matrix
operand (``cur.astype(bfloat16)``), 'mxu_hybrid' a two-axis term's column
conv, and JAX's skew kernel keeps its level carries in bf16; the port does
not copy those roundings, so there the two packages agree to the tier's
tolerance (7e-3 of the largest value after 4 steps), not bit for bit.  A
whole-grid run rounds every step, as JAX's does (its state lives in the
bf16 output between steps).  The bf16 twins upcast at the load, run the
float32 twin's arithmetic and round at the store, by the same rule.

A step (k = 1) of radius 1-4 with at most three terms, which is every
2-D registry shape's, runs the strip kernel of its dtype (``strip_takes``):
a warp walks down a strip of rows keeping the column convs in registers
(four float32 or bf16 cells or two float64 cells a lane), its plan by value
in the launch's parameters (``plan_array`` in host memory, in the compute
dtype).  So every 2-D step of the fp64-grade tier (dtypes 'df64' and
'float64') runs the float64 strip kernel.  A step past the strip walk's
reach (below) runs the tile kernel, as the fused levels there do, or,
where the tile kernel's staged window does not fit a block's shared memory
(radius above about 60 in float32, 35 in float64: ``wide_takes``), the wide
kernel, which reads its inputs through the read-only cache and stages only
the column convs; the kernels give the same values cell for cell.  Radii up
to 128 run, the reach the JAX engine's 128-column guard allows.
``stencil2d_step.launches`` counts the float32 launches, ``launches_f64``
the float64 ones, ``launches_bf16`` the bfloat16 ones, ``launches_k1`` the
strip kernels' in any dtype, ``launches_tile`` the tile kernel's and
``launches_wide`` the wide kernel's.

A float32 or bfloat16 pass of two fused steps of radius 1-4 with one or
two terms and no residue, star2d3r's (the one registry shape the engine
fuses by default), runs the fused strip kernel (``fused_strip_takes``),
from either wrapper: the strip kernel's walk with every level kept in
registers, which computes the same values as the fused and the skewed tile
kernels in another traversal.  Each wrapper counts its launches in
``launches_fused_strip`` too.

Every other launch of radius 1-8 that either wrapper makes -- a step of
more than three terms or of radius 5-8, a fused pass of depth 2-4 (radius
5-8 and float64: 2; bfloat16 at radius 5-8: 4) with residue points, three
or more terms, a term with neither axis or a radius past 4, up to
``PLAN_MAX_TERMS`` terms, ``PLAN_MAX_RESIDUE`` residue points and a warp's
shared memory within a block's -- runs the plan strip kernel of
``csrc/plan2d.cu`` (``plan_strip_takes``; ``launches_plan_strip`` counts
it on the wrapper whose pass made it): the strip kernels' walk for any
plan, each fused level in a per-warp ring of rows, the column convs in
registers or a per-lane shared ring.  It gives the tile kernels' values
cell for cell.  A float32 or float64 launch of two or more steps that the
plan strip kernel would take runs as single launches of the walk instead
(``strips_beat_plan``: the strip kernel's where it takes the spec, else
the plan strip kernel's single step), where it keeps no ring or the caller
refreshes the ring between them (a ghost boundary); a
shard's exchanged ring keeps the fused pass, and a bfloat16 launch stays
one launch, which rounds once.  A skewed pass (``stencil2d_skew_step``)
computes the fused pass's values, so it takes the same launches, counted
on its own wrapper (``launches_k1``, ``launches_fused_strip``,
``launches_plan_strip``).  The tile kernels keep what lies beyond: radius 9
up to the wide radii, plans past the plan strip kernel's caps, bfloat16
launches deeper than 4, and the launches the card measured faster there
(``tile_beats_plan``); ``launches_tile`` counts step_kernel's and
skew_kernel's launches on their wrappers.

A float32 or float64 pass deeper than the walk's deepest launch
(``walk_depth``: 4 at radius 1-4 in float32, else 2) runs as launches of
that depth, each counted; the values do not change, because every level is
masked to the interior.  A bfloat16 pass rounds once a launch, so it keeps
the tile kernels' split: shared memory bounds their reach, about three
(32 + 2kr) x (128 + 2kr) windows for a fused pass (16 rows in float64), a
band of every level for a skewed one, and a pass deeper than the largest k
that fits (``max_fused_steps``) runs as launches of that k.  Under a
ghost boundary the levels before a launch's last keep the ring
(``bounds``) and the engine's ``refresh`` refills it between launches: a
refresh at any step is the boundary condition's padding at that step.

A whole-grid run (``stencil2d_resident``) of radius 1-4 with at most three
terms, every registry shape's, runs the shared-memory resident kernel of
``csrc/resident2d.cu`` (``resident_takes``): one block per SM holds a
rectangle of the state in shared memory for the whole run and swaps its
border with its neighbours only, as tagged words in a zeroed buffer of two
parities.  Its capacity is the kernel's own (``resident_capacity``).
Every other run
takes ``csrc/stencil2d.cu``'s resident kernel, which streams the state
through device memory with a grid barrier per step.  The wrapper counts
both in ``launches`` / ``launches_f64`` / ``launches_bf16``, the first in
``launches_smem`` too.  On a card the runs are on by default below
``CUDA_RESIDENT_2D_BYTES`` / ``CUDA_RESIDENT_PAIR_2D_BYTES`` (measured on an
H100; a bfloat16 state is held to float32's cap counted in cells, until
its own is measured); on the CPU the JAX package's caps hold, off by
default.

A pass may write a window of the layout's tiles only (``region``, the JAX
wrapper's argument, which the sharded engine's overlapped step takes:
``parallel/domain.py``): the launch covers the window's rows and columns
alone, and every other cell of the output stays as it was.  A shard's
``bounds`` may start beyond the guard and end inside the interior
(``check_bounds(..., shard=True)``); the last level keeps them cut to the
interior.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ..models.shapes import StencilSpec

from . import _cuda_build
from .band_gemm import apply_spec, mask_to_interior, plan_array
from .layout import Layout2D, check_bounds, compute_dtype

ALGORITHMS = ("mxu_hybrid1", "vpu_roll", "vpu", "mxu_hybrid", "mxu",
              "mxu_split", "mxu_hybrid1r", "mxu_hybrid3")
# the names pallas_df64.df64_step takes
DF64_ALGORITHMS = ("vpu", "vpu_roll", "vpu_sep")
# the names pallas_2d.stencil2d_skew_step takes
SKEW_ALGORITHMS = ("vpu_roll", "mxu_hybrid1")
# csrc/stencil2d.cu kMaxRadius: the reach k * r <= 128 of the JAX layout's
# column guard, at k = 1
MAX_RADIUS = 128
MAX_PLAN = 4096  # csrc/stencil2d.cu kMaxPlan
MAX_SMEM = 232448  # csrc/stencil2d.cu kMaxSmem: bytes a block may use
TILE_COLS = 128  # csrc/stencil2d.cu kTileCols
# csrc/stencil2d.cu's strip kernel: radii and terms it takes
STRIP_RADII = (1, 2, 3, 4)
STRIP_MAX_TERMS = 3
# csrc/stencil2d.cu's fused strip kernel: the depths and terms it takes
FUSED_STRIP_DEPTHS = (2,)
FUSED_STRIP_MAX_TERMS = 2
# csrc/plan2d.cu's plan strip kernel: its radii (kPlanMaxRadius), the depths
# of each dtype at radius 1-4 and at radius 5-8 (plan_max_k), the terms
# (kPlanMaxTerms) and residue points (kStripMaxRes) it takes
PLAN_RADII = (1, 2, 3, 4, 5, 6, 7, 8)
PLAN_STRIP_DEPTHS = {torch.float32: (1, 2, 3, 4), torch.bfloat16: (1, 2, 3, 4),
                     torch.float64: (1, 2)}
PLAN_STRIP_WIDE_DEPTHS = {torch.float32: (1, 2), torch.bfloat16: (1, 2, 3, 4),
                          torch.float64: (1, 2)}
PLAN_MAX_TERMS = 9
PLAN_MAX_RESIDUE = 81  # kStripMaxRes: every point of a radius-4 square
PLAN_REG_FLOATS = 144  # kPlanRegFloats
_ENTRIES = {
    "strip": {torch.float32: "ls_stencil2d_strip",
              torch.float64: "ls_stencil2d_strip_f64",
              torch.bfloat16: "ls_stencil2d_strip_bf16"},
    "fused_strip": {torch.float32: "ls_stencil2d_fused_strip",
                    torch.bfloat16: "ls_stencil2d_fused_strip_bf16"},
    "step": {torch.float32: "ls_stencil2d_step",
             torch.float64: "ls_stencil2d_step_f64",
             torch.bfloat16: "ls_stencil2d_step_bf16"},
    "skew": {torch.float32: "ls_stencil2d_skew",
             torch.float64: "ls_stencil2d_skew_f64",
             torch.bfloat16: "ls_stencil2d_skew_bf16"},
    "resident": {torch.float32: "ls_stencil2d_resident",
                 torch.float64: "ls_stencil2d_resident_f64",
                 torch.bfloat16: "ls_stencil2d_resident_bf16"},
    # csrc/plan2d.cu (built apart, plan2d_bf16.cu its bfloat16 instances)
    "plan_strip": {torch.float32: "ls_stencil2d_plan_strip",
                   torch.float64: "ls_stencil2d_plan_strip_f64",
                   torch.bfloat16: "ls_stencil2d_plan_strip_bf16"}}
# the kinds of csrc/plan2d.cu's library
_PLAN_KINDS = ("plan_strip",)
# csrc/resident2d.cu's shared-memory resident kernel
_RESIDENT_SMEM = {torch.float32: "ls_stencil2d_resident_smem",
                  torch.float64: "ls_stencil2d_resident_smem_f64",
                  torch.bfloat16: "ls_stencil2d_resident_smem_bf16"}
# the code of each state dtype in ls_stencil2d_resident_capacity
_CAPACITY_KIND = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# csrc/resident2d.cu kWindowBytes: a window's bytes, at most (two of them
# beside the residue's 81 offsets in a block's 232,448 bytes)
RESIDENT_SMEM_BYTES = (232448 - 4 * 81) // 2

# Whole-grid runs: the JAX package's caps on the internal buffer's bytes
# (pallas_2d.RESIDENT_2D_BYTES, pallas_df64.RESIDENT_PAIR_2D_BYTES), read
# from the same environment variables and off (0) by default.  The test is
# the port's, on the port's layout: near a cap the two packages may choose
# differently (ROADMAP section C).
RESIDENT_2D_BYTES = int(os.environ.get("LORASTENCIL_RESIDENT2D_KB",
                                       "0")) * 1024
RESIDENT_PAIR_2D_BYTES = int(os.environ.get(
    "LORASTENCIL_RESIDENT2D_PAIR_KB", "0")) * 1024
# The caps on a card where the variables are unset: the largest internal
# buffer at which a 64-step resident run beat the tiled passes at every
# size measured up to it, in each of two runs (chip_smoke.py phase 16,
# star2d1r and box2d3r at 256^2, 512^2, 1024^2 and the largest grid the
# kernel's capacity takes; NVIDIA H100 80GB HBM3, 700.00 W).  The tiled
# runs are host-bound and their time moves from run to run; the resident
# kernel's does not.  run_internal x 64, tiled -> resident, ms (run 1;
# run 2):
#   float32 1024^2 (4,260,096 bytes): star2d1r 2.911 -> 0.892 (2.223 ->
#     0.763), box2d3r 2.001 -> 1.018 (1.896 -> 1.015); at 1664^2 box2d3r
#     2.306 -> 2.235 (1.851 -> 2.154: lost);
#   df64 512^2 (2,163,200 bytes): star2d1r 2.835 -> 0.593 (2.742 ->
#     0.550), box2d3r 2.315 -> 0.847 (2.857 -> 0.894); at 1024^2 box2d3r
#     2.687 -> 1.852 (1.637 -> 1.769: lost).
# Every smaller size won by more.  The float32 cap also serves dtype
# float64 at 8 bytes a cell, as in the JAX package.
H100_RESIDENT_2D_BYTES = 4_260_096
H100_RESIDENT_PAIR_2D_BYTES = 2_163_200


def cuda_cap(env: str, default: int) -> int:
    """The cap a CUDA state takes: the variable ``env`` (KiB) where it is
    set, 0 turning the runs off, else ``default``."""
    return int(os.environ[env]) * 1024 if env in os.environ else default


CUDA_RESIDENT_2D_BYTES = cuda_cap("LORASTENCIL_RESIDENT2D_KB",
                                  H100_RESIDENT_2D_BYTES)
CUDA_RESIDENT_PAIR_2D_BYTES = cuda_cap("LORASTENCIL_RESIDENT2D_PAIR_KB",
                                       H100_RESIDENT_PAIR_2D_BYTES)


def _fits(layout, dtype, cap: int, cuda_cap: int, device, spec) -> bool:
    """On the CPU the JAX rule, the buffer's bytes under ``cap``; on a card
    its cells at the compute dtype's bytes under ``cuda_cap`` (a bfloat16
    state takes float32's cap counted in cells), its bytes under the
    capacity of the kernel that takes ``spec``, and, for
    ``csrc/stencil2d.cu``'s resident kernel, a step's window within a
    block's shared memory (a radius past about 60 runs tiled passes)."""
    if not isinstance(layout, Layout2D) or layout.extra_row_tiles:
        return False
    R, C = layout.shape
    nbytes = R * C * dtype.itemsize
    if device is None or torch.device(device).type != "cuda":
        return nbytes <= cap
    if R * C * compute_dtype(dtype).itemsize > cuda_cap:
        return False
    if spec is None:
        return True
    if not resident_takes(spec, dtype):
        return smem_bytes("step", 1, spec.radius, plan_len(spec),
                          dtype) <= MAX_SMEM
    return nbytes <= resident_capacity(spec, dtype, device)


def fits_resident_2d(layout, itemsize: int = 4, device=None,
                     spec: StencilSpec = None) -> bool:
    """Whether the float32 (at ``itemsize`` 8 float64, at 2 bfloat16)
    state runs all its steps in one ``stencil2d_resident`` launch: under
    ``RESIDENT_2D_BYTES``, or on a CUDA ``device`` under
    ``CUDA_RESIDENT_2D_BYTES`` and the capacity of the kernel that takes
    ``spec`` (``resident_capacity``)."""
    dtype = {8: torch.float64, 2: torch.bfloat16}.get(itemsize,
                                                      torch.float32)
    return _fits(layout, dtype, RESIDENT_2D_BYTES, CUDA_RESIDENT_2D_BYTES,
                 device, spec)


def fits_resident_pair_2d(layout, device=None,
                          spec: StencilSpec = None) -> bool:
    """Whether a df64 state runs all its steps in one launch: the JAX
    pair grid's 2 * R * C * 4 bytes, R * C * 8 for the float64 state,
    under ``RESIDENT_PAIR_2D_BYTES``, or on a CUDA ``device`` under
    ``CUDA_RESIDENT_PAIR_2D_BYTES`` and the kernel's capacity."""
    return _fits(layout, torch.float64, RESIDENT_PAIR_2D_BYTES,
                 CUDA_RESIDENT_PAIR_2D_BYTES, device, spec)


def resident_takes(spec: StencilSpec, dtype) -> bool:
    """Whether a whole-grid run in ``dtype`` runs the shared-memory
    resident kernel: float32, float64 or bfloat16, radius 1-4, at most
    three terms (every registry shape); else ``csrc/stencil2d.cu``'s
    resident kernel."""
    return (dtype in _RESIDENT_SMEM and spec.radius in STRIP_RADII
            and len(spec.terms) <= STRIP_MAX_TERMS)


def resident_capacity_bytes(itemsize: int, blocks: int,
                            window_itemsize: int = None) -> int:
    """csrc/resident2d.cu capacity_bytes: the largest internal buffer
    (rows x pitch cells of ``itemsize`` bytes) a launch over ``blocks``
    blocks (one per SM) takes, 4/5 of the cells their windows hold at
    ``window_itemsize`` bytes a cell (the compute dtype's: 4 for a
    bfloat16 state; ``itemsize`` when None)."""
    cell = window_itemsize or itemsize
    return 4 * blocks * (RESIDENT_SMEM_BYTES // cell) // 5 * itemsize


def resident_capacity(spec: StencilSpec, dtype, device):
    """Bytes of the largest internal buffer the kernel that takes a run
    of ``spec`` in ``dtype`` holds on ``device`` (the card answers, through
    ``ls_stencil2d_resident_capacity``), or None where that is
    ``csrc/stencil2d.cu``'s kernel, which streams through device memory."""
    if not resident_takes(spec, dtype):
        return None
    return _capacity(_CAPACITY_KIND[dtype], spec.radius, len(spec.terms),
                     torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _capacity(kind: int, radius: int, n_terms: int, index: int) -> int:
    with torch.cuda.device(index):
        cap = _resident_lib().ls_stencil2d_resident_capacity(
            kind, radius, n_terms)
    if cap <= 0:
        raise RuntimeError(f"resident capacity query failed: {cap}")
    return cap


def tile_rows(dtype) -> int:
    """Output rows of a block tile and of a skew band (csrc/stencil2d.cu
    tile_rows): 32 in float32, 16 in float64."""
    return 16 if dtype == torch.float64 else 32


def strip_takes(spec: StencilSpec, dtype, depth: int = 1) -> bool:
    """Whether a launch of ``depth`` fused steps in ``dtype`` runs a strip
    kernel: float32, float64 or bfloat16, one step, radius 1-4, at most
    three terms."""
    return (dtype in _ENTRIES["strip"] and depth == 1
            and spec.radius in STRIP_RADII
            and len(spec.terms) <= STRIP_MAX_TERMS)


def fused_strip_takes(spec: StencilSpec, dtype, depth: int) -> bool:
    """Whether a launch of ``depth`` fused steps in ``dtype`` runs the
    fused strip kernel: float32 or bfloat16, two steps, radius 1-4, one or
    two terms, each with a row or a column axis, and no residue."""
    return (dtype in _ENTRIES["fused_strip"] and depth in FUSED_STRIP_DEPTHS
            and spec.radius in STRIP_RADII
            and 1 <= len(spec.terms) <= FUSED_STRIP_MAX_TERMS
            and all(any(a is not None for a in term.taps)
                    for term in spec.terms)
            and not spec.residue)


def plan_strip_depths(radius: int, dtype):
    """The depths one plan strip launch takes at ``radius`` in ``dtype``
    (csrc/plan2d.cu plan_max_k): 1-4 in float32 and bfloat16 and 1-2 in
    float64 at radius 1-4; 1-2 at radius 5-8, and 1-4 in bfloat16, whose
    pass rounds once a launch; none elsewhere."""
    if radius not in PLAN_RADII:
        return ()
    return (PLAN_STRIP_DEPTHS if radius <= 4
            else PLAN_STRIP_WIDE_DEPTHS).get(dtype, ())


def plan_warp_bytes(spec: StencilSpec, dtype, depth: int) -> int:
    """Shared memory of one warp of a plan strip launch (csrc/plan2d.cu
    plan_warp_bytes): the input ring of state cells and ``depth - 1`` level
    rings of compute cells, rows of ``plan_row_cells`` (``plan_ring`` and
    ``plan_level_ring`` of them), and, unless ``plan_in_registers``, the
    column convs of every term: per level and term 2R + 2 rows of 32 lanes x
    4 cells."""
    R, nt = spec.radius, len(spec.terms)
    cell, comp = dtype.itemsize, compute_dtype(dtype).itemsize
    row = TILE_COLS + 8 * ((R + 3) // 4) + 4
    ring = 16 if 6 + 2 * R + 2 <= 16 else 32
    level_ring = 1 << max(1, (2 * R + 1).bit_length())
    regs = (R <= 4 and depth >= 2 and 1 <= nt <= 3
            and depth * nt * (2 * R + 2) * comp <= PLAN_REG_FLOATS)
    conv = 0 if regs else depth * nt * (2 * R + 2) * 32 * 4 * comp
    return (ring * row * cell + (depth - 1) * level_ring * row * comp
            + conv)


def plan_strip_takes(spec: StencilSpec, dtype, depth: int) -> bool:
    """Whether a launch of ``depth`` fused steps in ``dtype`` runs the
    plan strip kernel: radius 1-8, the depths of ``plan_strip_depths``, at
    most ``PLAN_MAX_TERMS`` terms and ``PLAN_MAX_RESIDUE`` residue points, a
    warp's shared memory (``plan_warp_bytes``) within a block's, and not a
    launch that the strip kernel (a step of at most three terms) or the
    fused strip kernel takes."""
    return (depth in plan_strip_depths(spec.radius, dtype)
            and len(spec.terms) <= PLAN_MAX_TERMS
            and len(spec.residue) <= PLAN_MAX_RESIDUE
            and plan_warp_bytes(spec, dtype, depth) <= MAX_SMEM
            and not strip_takes(spec, dtype, depth)
            and not fused_strip_takes(spec, dtype, depth))


# the fewest warps a block of a float64 plan strip launch may hold before the
# tile kernel beats it (``tile_beats_plan``)
PLAN_MIN_WARPS_F64 = 3


def tile_beats_plan(spec: StencilSpec, dtype, depth: int) -> bool:
    """Whether a launch the plan strip kernel takes runs the tile kernel
    instead, where the card measured the tile kernel faster: a float64
    launch whose block holds fewer than ``PLAN_MIN_WARPS_F64`` warps
    (csrc/plan2d.cu launch_plan: as many as a block's shared memory fits,
    ``plan_warp_bytes`` each; the column convs in the shared ring leave one
    or two, too few to hide float64's latency).  The card's timing
    (chip_smoke.py phase 29, NVIDIA H100 80GB HBM3, 700.00 W, ms at 8192^2,
    the plan strip kernel / the tile kernel in turns): float64 17x17 of rank
    4 k = 1 (2 warps) 7.599 / 5.870, k = 2 (1 warp) 54.944 / 27.549; float64
    custom_r5 k = 2 (2 warps) 7.204 / 3.623; float64 9x9 of rank 4 k = 3
    (its k = 2 launch 1 warp) 31.137 / 28.037.  At 3 or more warps the plan
    strip kernel won: float64 custom_r5 k = 1 (4 warps) 0.917 / 1.083, df64
    9x9 of rank 4 k = 1 (3 warps, phase 28) 2.531 / 2.800."""
    return (dtype == torch.float64 and MAX_SMEM // plan_warp_bytes(
        spec, dtype, depth) < PLAN_MIN_WARPS_F64)


def _walk_kind(spec: StencilSpec, dtype, depth: int):
    """The strip walk's kernel of a launch of ``depth`` steps: "strip",
    "fused_strip" or "plan_strip"; None past its reach (the tile kernels'
    launches)."""
    if strip_takes(spec, dtype, depth):
        return "strip"
    if fused_strip_takes(spec, dtype, depth):
        return "fused_strip"
    if (plan_strip_takes(spec, dtype, depth)
            and not tile_beats_plan(spec, dtype, depth)):
        return "plan_strip"
    return None


def walk_depth(spec: StencilSpec, dtype) -> int:
    """The deepest launch of the strip walk (the strip, fused strip and plan
    strip kernels) on a float32 or float64 pass of ``spec``: a deeper pass
    runs as launches of at most this depth (``launch_depths``), with the
    same values, every level masked as a single step masks it.  0 where the
    walk takes no launch of the spec, and for bfloat16, whose pass rounds
    once a launch: there the split stays the tile kernel's."""
    if dtype not in (torch.float32, torch.float64):
        return 0
    return max((d for d in plan_strip_depths(spec.radius, dtype)
                if _walk_kind(spec, dtype, d)), default=0)


def strips_beat_plan(spec: StencilSpec, dtype, depth: int) -> bool:
    """Whether a launch of ``depth`` >= 2 steps that the plan strip kernel
    would run runs as ``depth`` single launches of the strip walk instead
    (``_split_pass``), from either wrapper: float32 or float64, each single
    step on the strip kernel (``strip_takes``) or the plan strip kernel.  A
    bfloat16 pass stays one launch: it rounds once.  Without a ring the two
    give the same values bit for bit (every level masked as a single step
    masks it); under a ghost boundary the caller's refresh refills the ring
    between the launches, the boundary's padding at each step: bit for bit
    under a periodic ring, where a ring cell sums what its interior cell
    sums in the same order; a reflected ring cell sums its mirror image in
    the mirrored order, which can round otherwise.  Every fused plan strip
    pass the card timed lost to single launches, which keep no level rings
    and no overlap and hold more warps an SM.  The card's timing (NVIDIA
    H100 80GB HBM3, 700.00 W, ms a pass at 8192^2, the plan strip pass / k
    single launches in turns): chip_smoke.py phase 28, strip launches: 5x5
    asym k = 2 0.760 / 0.684, its float64 3.903 / 1.171, star2d1r k = 2
    0.892 / 0.643, box2d3r k = 3 3.176 / 1.098; under a periodic ring, with
    the refresh between the launches, 0.752 / 0.695, 3.866 / 1.162, 0.866 /
    0.636, 3.139 / 1.123; phase 29: star2d1r k = 4 1.934 / 1.256 (strip
    launches), and on the plan strip kernel's single steps the 9x9 of rank
    4 k = 2 2.881 / 1.331, custom_r5 k = 2 0.953 / 0.622 (float64 7.212 /
    1.841), the 17x17 of rank 4 k = 2 9.027 / 3.048.  Both are issue-bound,
    and a fused level does a step's sums plus its level ring and overlap."""
    return (dtype in (torch.float32, torch.float64) and depth >= 2
            and _walk_kind(spec, dtype, depth) == "plan_strip"
            and _walk_kind(spec, dtype, 1) is not None)


def wide_takes(spec: StencilSpec, dtype, depth: int = 1) -> bool:
    """Whether a launch of ``depth`` fused steps in ``dtype`` runs the wide
    kernel: one step that the strip kernels do not take and whose tile
    window does not fit a block's shared memory."""
    return (depth == 1 and not strip_takes(spec, dtype, depth)
            and smem_bytes("step", 1, spec.radius, plan_len(spec),
                           dtype) > MAX_SMEM)


def plan_len(spec: StencilSpec) -> int:
    """Entries of the kernels' tap table (``band_gemm.plan_array``)."""
    W = 2 * spec.radius + 1
    return len(spec.terms) * (2 + 2 * W) + 3 * len(spec.residue)


def smem_bytes(kind: str, k: int, radius: int, n_plan: int,
               dtype=torch.float32) -> int:
    """Shared memory of one launch (csrc/stencil2d.cu step_cells and
    skew_cells): ``kind`` "step" (a pass of k fused steps, or one step of
    a resident run at k = 1) or "skew"; cells of the compute dtype (a
    bfloat16 state's windows hold float32)."""
    tm, R = tile_rows(dtype), radius
    if kind == "skew":
        band = tm + 2 * R
        cells = n_plan + band * (TILE_COLS + 2 * (k - 1) * R)
        cells += sum(band * (TILE_COLS + 2 * (k - lv) * R)
                     for lv in range(k))
    else:
        E, e1 = k * R, (k - 1) * R
        cells = ((tm + 2 * E) * (TILE_COLS + 2 * E)
                 + ((tm + 2 * e1) * (TILE_COLS + 2 * e1) if k > 1 else 0)
                 + (tm + 2 * E) * (TILE_COLS + 2 * e1) + n_plan)
    return cells * compute_dtype(dtype).itemsize


@functools.lru_cache(maxsize=None)
def max_fused_steps(kind: str, radius: int, n_plan: int,
                    dtype=torch.float32) -> int:
    """The deepest pass of ``kind`` one launch takes (its shared memory
    within ``MAX_SMEM``), at least 1 ("step") or 2 ("skew"); 128 steps, the
    engine's largest k, when the radius is 0."""
    k = 1 if kind == "step" else 2
    while k < 128 and smem_bytes(kind, k + 1, radius, n_plan,
                                 dtype) <= MAX_SMEM:
        k += 1
    return k


def _check_state(cur, spec: StencilSpec, layout: Layout2D, reach: int):
    if spec.ndim != 2:
        raise ValueError(f"{spec.name} is {spec.ndim}-D, not 2-D")
    if spec.radius > MAX_RADIUS:
        raise ValueError(
            f"radius {spec.radius} exceeds the kernel's cap {MAX_RADIUS}")
    layout.validate()
    if min(layout.guard) < reach:
        raise ValueError(
            f"guard {layout.guard} is narrower than the pass's reach "
            f"{reach} (fused steps x radius {spec.radius})")
    if cur.dtype not in _ENTRIES["step"]:
        raise TypeError(
            f"cur must be float32, float64 or bfloat16, got {cur.dtype}")
    if tuple(cur.shape) != layout.shape:
        raise ValueError(
            f"cur has shape {tuple(cur.shape)}, layout is {layout.shape}")
    if not cur.is_contiguous():
        raise ValueError("cur must be contiguous")
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stencil2d kernel for device {cur.device}")


def _check(cur, donor, spec: StencilSpec, layout: Layout2D,
           algorithm: str, fused_steps: int):
    # a float64 state also takes the df64 names ('vpu_sep' is the new one)
    algorithms = (ALGORITHMS + ("vpu_sep",) if cur.dtype == torch.float64
                  else ALGORITHMS)
    if algorithm not in algorithms:
        raise ValueError(f"unknown algorithm {algorithm!r}; this wrapper "
                         f"takes {algorithms}")
    if fused_steps > 1 and algorithm == "mxu":
        # pallas_2d.stencil2d_step's rule and message
        raise ValueError(
            "temporal fusion (fused_steps > 1) needs algorithm='vpu', "
            "'vpu_roll', 'mxu_split', 'mxu_hybrid' or 'mxu_hybrid3'")
    if fused_steps < 1:
        raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
    _check_state(cur, spec, layout, fused_steps * spec.radius)
    if donor.dtype != cur.dtype:
        raise TypeError(f"donor must be {cur.dtype}, got {donor.dtype}")
    if tuple(donor.shape) != layout.shape:
        raise ValueError(
            f"donor has shape {tuple(donor.shape)}, layout is "
            f"{layout.shape}")
    if not donor.is_contiguous():
        raise ValueError("donor must be contiguous")
    if cur.device != donor.device:
        raise ValueError(
            f"cur on {cur.device} but donor on {donor.device}")
    if cur.data_ptr() == donor.data_ptr():
        raise ValueError("donor must be a different buffer from cur")


def region_cells(region, layout: Layout2D):
    """A pass's window ``((ti0, ti1), (tj0, tj1))`` of ``layout.grid``
    tiles (the JAX wrapper's ``region``) as cells ``(i0, i1, j0, j1)`` of
    the rounded interior; None is all of it.  Raises where the JAX wrapper
    asserts: a window that is empty or leaves the tile grid."""
    mr, nr = layout.rounded
    if region is None:
        return (0, mr, 0, nr)
    try:
        (ti0, ti1), (tj0, tj1) = ((int(a), int(b)) for a, b in region)
    except (TypeError, ValueError):
        raise ValueError(
            f"region must be ((ti0, ti1), (tj0, tj1)), got {region!r}"
        ) from None
    gi, gj = layout.grid
    if not (0 <= ti0 < ti1 <= gi and 0 <= tj0 < tj1 <= gj):
        raise ValueError(
            f"region {region!r} is not a window of the layout's {gi}x{gj} "
            f"tile grid")
    tm, tn = layout.tile
    return (ti0 * tm, ti1 * tm, tj0 * tn, tj1 * tn)


def stencil2d_step_plain(cur, donor, spec: StencilSpec, layout: Layout2D,
                         fused_steps: int = 1, bounds=None, region=None):
    """The step and fused kernels' plain PyTorch twin: the same pass with
    tensor ops on whatever device and dtype ``cur`` has.  Level L = 1..k
    steps the window at reach (k - L) r around the rounded interior (or
    around ``region``'s cells, ``region_cells``) and zeroes its cells
    outside the box ``bounds``, ``(rlo, rhi, clo, chi)`` (the interior
    when None; a shard's box, ``check_bounds(..., shard=True)``); level k,
    masked to the box cut to the interior, is written to the same cells of
    ``donor`` in place, which is returned.  Every other cell of ``donor``,
    its guard ring among them, is left as it is.  A bfloat16 state is
    widened to float32 at the load, computed as float32 and rounded to
    nearest even at the store: once a pass."""
    r = spec.radius
    r0, c0 = layout.origin
    m, n = layout.interior
    i0, i1, j0, j1 = region_cells(region, layout)
    box = check_bounds(bounds, layout.interior, layout.guard, shard=True)
    last = (0, min(box[1], m), 0, min(box[3], n))
    e = fused_steps * r
    val = cur[r0 + i0 - e: r0 + i1 + e, c0 + j0 - e: c0 + j1 + e].to(
        compute_dtype(cur.dtype))
    for level in range(1, fused_steps + 1):
        e -= r
        rlo, rhi, clo, chi = box if level < fused_steps else last
        val = mask_to_interior(apply_spec(val, spec, (r, r)), m - i0, n - j0,
                               margin=e, bounds=(rlo - i0, rhi - i0,
                                                 clo - j0, chi - j0))
    donor[r0 + i0: r0 + i1, c0 + j0: c0 + j1] = val
    return donor


def stencil2d_resident_plain(cur, spec: StencilSpec, layout: Layout2D,
                             steps: int):
    """The resident kernel's plain twin: ``steps`` single steps between
    two new zeroed buffers; returns the last one written (a bfloat16
    state rounds every step)."""
    bufs = (torch.zeros_like(cur), torch.zeros_like(cur))
    for s in range(steps):
        cur = stencil2d_step_plain(cur, bufs[s % 2], spec, layout)
    return cur


@functools.lru_cache(maxsize=None)
def _plan_buffer(spec: StencilSpec, device: torch.device, dtype):
    """The tap/residue table in the compute dtype of a ``dtype`` state on
    ``device``, built once per (spec, device, dtype) and never per step."""
    plan = plan_array(spec, compute_dtype(dtype))
    if plan.numel() > MAX_PLAN:
        raise ValueError(
            f"{spec.name}: tap table of {plan.numel()} entries exceeds the "
            f"kernel's cap {MAX_PLAN}")
    return plan.to(device)


# the kinds whose launch copies the plan from host memory into the
# kernel's parameters
_HOST_PLAN = ("strip", "fused_strip", "plan_strip")


@functools.lru_cache(maxsize=None)
def _plan_host(spec: StencilSpec, dtype):
    """The tap/residue table in the compute dtype of a ``dtype`` state, in
    host memory, which the strip kernels' launches copy into their
    parameters: a float64 tap rounded through float32 would change the
    float64 kernel's sums."""
    return plan_array(spec, compute_dtype(dtype)).contiguous()


def _bind(name: str, bf16: bool, kinds=None):
    """``csrc/<name>.cu``, built and its entries of the bfloat16 instances
    (``bf16``) or the others bound, those of ``kinds`` (when None, all but
    the plan strip kernel's, which ``csrc/plan2d.cu`` holds)."""
    lib = _cuda_build.load(name)
    for kind, entries in _ENTRIES.items():
        if kind not in (kinds or [k for k in _ENTRIES
                                  if k not in _PLAN_KINDS]):
            continue
        # a run: 4 pointers; a pass: 3, and 8 ints more, its bounds and its
        # window
        pointers = 4 if kind == "resident" else 3
        ints = 13 if kind == "resident" else 21
        for dtype, entry in entries.items():
            if (dtype == torch.bfloat16) != bf16:
                continue
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                           + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    """The float32 and float64 instances' library, built and bound once
    per process."""
    return _bind("stencil2d", False)


@functools.lru_cache(maxsize=None)
def _lib_bf16():
    """The bfloat16 instances' library (``csrc/stencil2d_bf16.cu``, the
    same source built apart), built and bound once per process."""
    return _bind("stencil2d_bf16", True)


@functools.lru_cache(maxsize=None)
def _plan_lib():
    """csrc/plan2d.cu's float32 and float64 instances, built and bound
    once per process."""
    return _bind("plan2d", False, _PLAN_KINDS)


@functools.lru_cache(maxsize=None)
def _plan_lib_bf16():
    """csrc/plan2d_bf16.cu (its bfloat16 instances), built and bound once
    per process."""
    return _bind("plan2d_bf16", True, _PLAN_KINDS)


def _lib_of(kind: str, dtype):
    """The library of ``kind``'s instance of ``dtype``."""
    bf16 = dtype == torch.bfloat16
    if kind in _PLAN_KINDS:
        return _plan_lib_bf16() if bf16 else _plan_lib()
    return _lib_bf16() if bf16 else _lib()


@functools.lru_cache(maxsize=None)
def _resident_lib():
    """csrc/resident2d.cu, built and bound once per process."""
    lib = _cuda_build.load("resident2d")
    for entry in _RESIDENT_SMEM.values():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.ls_stencil2d_resident_capacity.restype = ctypes.c_longlong
    lib.ls_stencil2d_resident_capacity.argtypes = [ctypes.c_int] * 3
    return lib


def _launch_resident_smem(cur, spec: StencilSpec, layout: Layout2D,
                          steps: int):
    """One launch of the shared-memory resident kernel, with a zeroed
    output buffer and tagged exchange words; returns the output.  Raises
    if refused (a buffer above its capacity among them)."""
    plan = _plan_host(spec, cur.dtype)
    out = torch.zeros_like(cur)
    mr, nr = layout.rounded
    # two parities of tagged 8-byte words, one a 4-byte compute cell
    words = compute_dtype(cur.dtype).itemsize // 4
    xch = torch.zeros(2 * mr * nr * words, dtype=torch.int64,
                      device=cur.device)
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_resident_lib(), _RESIDENT_SMEM[cur.dtype])(
            cur.data_ptr(), out.data_ptr(), xch.data_ptr(), xch.numel(),
            plan.data_ptr(), plan.numel(), len(spec.terms), spec.radius,
            len(spec.residue), rows, pitch, r0, c0, m, n, mr, nr, steps,
            stream)
    if err != 0:
        raise RuntimeError(
            f"stencil2d shared-memory resident kernel launch failed: CUDA "
            f"error {err}")
    _count(stencil2d_resident, cur.dtype)
    stencil2d_resident.launches_smem += 1
    return out


def _count(wrapper, dtype):
    """One launch of the instance of ``dtype`` on ``wrapper``."""
    attr = {torch.float64: "launches_f64",
            torch.bfloat16: "launches_bf16"}.get(dtype, "launches")
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def _launch(kind: str, buffers, spec: StencilSpec, layout: Layout2D,
            depth: int, bounds=None, region=None, wrapper=None):
    """One launch of ``kind``'s instance of the buffers' dtype: ``depth``
    fused steps ("step" and "skew", the tile kernels; "strip",
    "fused_strip" and "plan_strip", the strip walk's) or the steps of a run
    ("resident"); raises if refused, and counts it on ``wrapper``, the
    wrapper it serves (when None: ``stencil2d_resident`` for a run,
    ``stencil2d_skew_step`` for "skew", else ``stencil2d_step``).  A pass's
    levels before the last keep ``bounds`` (``check_bounds``' flat ints, a shard's
    box cut to the guard; the interior when None), its last the box cut to
    the interior, and it writes ``region``'s cells (``region_cells``; the
    rounded interior when None: the entry's window, which
    ``csrc/stencil2d.cu`` in_window makes the launch's grid); a run takes
    neither."""
    cur = buffers[0]
    plan = (_plan_host(spec, cur.dtype) if kind in _HOST_PLAN
            else _plan_buffer(spec, cur.device, cur.dtype))
    rows, pitch = layout.shape
    r0, c0 = layout.origin
    m, n = layout.interior
    mr, nr = layout.rounded
    box = () if kind == "resident" else (
        check_bounds(bounds, layout.interior, layout.guard, shard=True)
        + region_cells(region, layout))
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _lib_of(kind, cur.dtype)
        err = getattr(lib, _ENTRIES[kind][cur.dtype])(
            *(b.data_ptr() for b in buffers), plan.data_ptr(), plan.numel(),
            len(spec.terms), spec.radius, len(spec.residue), rows, pitch, r0,
            c0, m, n, mr, nr, depth, *box, stream)
    if err != 0:
        raise RuntimeError(
            f"stencil2d {kind} kernel launch failed: CUDA error {err}")
    if wrapper is None:
        wrapper = {"resident": stencil2d_resident,
                   "skew": stencil2d_skew_step}.get(kind, stencil2d_step)
    _count(wrapper, cur.dtype)
    if region is not None:
        wrapper.launches_region += 1
    if kind == "strip":
        wrapper.launches_k1 += 1
    elif kind == "fused_strip":
        wrapper.launches_fused_strip += 1
    elif kind == "plan_strip":
        wrapper.launches_plan_strip += 1
    elif kind == "step" and wide_takes(spec, cur.dtype, depth):
        wrapper.launches_wide += 1
    elif kind in ("step", "skew"):
        wrapper.launches_tile += 1


def _spare_like(donor, layout: Layout2D):
    """A buffer like ``donor`` whose cells outside the rounded interior are
    zero: every launch writes each cell of the rounded interior, so only the
    ring needs a fill (a full one costs a memset of the grid a pass)."""
    spare = torch.empty_like(donor)
    r0, c0 = layout.origin
    mr, nr = layout.rounded
    spare[:r0] = 0
    spare[r0 + mr:] = 0
    spare[r0:r0 + mr, :c0] = 0
    spare[r0:r0 + mr, c0 + nr:] = 0
    return spare


def _split_pass(kind: str, cur, donor, spec: StencilSpec, layout: Layout2D,
                k: int, bounds=None, refresh=None):
    """A pass of k steps as launches of at most the k one launch takes
    (``launch_depths``), from ``cur`` into ``donor`` and, past the first, a
    spare zero-guarded buffer (``_spare_like``) by turns; returns the buffer
    the last launch wrote.  Each launch runs the kernel ``_one_kind`` names,
    counted on the wrapper of ``kind``.  Each launch keeps ``bounds`` on its
    levels before the last, and a launch past the first reads a buffer that
    ``refresh`` (if given) has refilled the ring of: the previous launch
    masked its last level to the interior and never writes the ring.  A
    launch that ``strips_beat_plan`` runs as single strip launches where the
    pass keeps no ring (``bounds`` the interior) or ``refresh`` refills it
    between them (a ghost ring); a shard's exchanged ring, which no refresh
    refills, lives through the fused levels of one launch."""
    src, spare = cur, None
    no_ring = (check_bounds(bounds, layout.interior, layout.guard, shard=True)
               == check_bounds(None, layout.interior, layout.guard))
    wrapper = stencil2d_skew_step if kind == "skew" else stencil2d_step
    depths = []
    for depth in launch_depths(kind, spec, cur.dtype, k):
        split = ((no_ring or refresh is not None)
                 and strips_beat_plan(spec, cur.dtype, depth))
        depths += [1] * depth if split else [depth]
    for i, depth in enumerate(depths):
        if i == 0:
            dst = donor
        else:
            if spare is None:
                spare = _spare_like(donor, layout)
            dst = spare if src is donor else donor
            if refresh is not None:
                src = refresh(src)
        _launch(_one_kind(kind, spec, cur.dtype, depth), (src, dst), spec,
                layout, depth, bounds, wrapper=wrapper)
        src = dst
    return src


def launch_depths(kind: str, spec: StencilSpec, dtype, k: int):
    """The depths of the launches a pass of ``kind`` ("step" or "skew") and
    k steps takes: launches of the largest depth one launch holds, then
    the rest.  A float32 or float64 pass that the strip walk takes holds
    ``walk_depth`` (the values do not move: every level is masked as a
    single step masks it); any other, a bfloat16 pass among them (it rounds
    once a launch), the tile kernel's (``max_fused_steps``).  The sharded
    2-D engine splits its passes here too, each launch a pass with its own
    exchange (``parallel/domain.py``): the card measured the walk's launches
    and their exchanges faster than one tile launch (tools/kernel_turns.py,
    PERF.md)."""
    kmax = walk_depth(spec, dtype) or max_fused_steps(
        kind, spec.radius, plan_len(spec), dtype)
    return [kmax] * (k // kmax) + ([k % kmax] if k % kmax else [])


def _one_kind(kind: str, spec: StencilSpec, dtype, depth: int) -> str:
    """The kernel of one launch of ``depth`` steps of a ``kind`` pass
    ("step" or "skew"): the strip walk's (``_walk_kind``: the strip kernel
    for a single step that ``strip_takes``, the fused strip kernel where
    ``fused_strip_takes``, the plan strip kernel where ``plan_strip_takes``
    at radius 1-8 within its caps and ``tile_beats_plan`` does not say
    otherwise), from either wrapper; else the tile kernels: the step kernel
    for a single step, or ``kind``'s own (radius 9 up to the wide radii,
    plans past the plan strip kernel's caps, a bfloat16 pass deeper than 4,
    the launches of ``tile_beats_plan``)."""
    return (_walk_kind(spec, dtype, depth)
            or ("step" if depth == 1 else kind))


def stencil2d_step(cur, donor, spec: StencilSpec, layout: Layout2D,
                   algorithm: str = "mxu_hybrid1", fused_steps: int = 1,
                   bounds=None, refresh=None, region=None):
    """``fused_steps`` timesteps on the internal layout: reads ``cur``,
    writes the rounded interior of ``donor`` in place and returns it (past
    ``max_fused_steps`` of one launch, the buffer the last launch wrote).

    ``donor``'s guard ring must be zero; it stays untouched, which is
    what makes the halo decay after the first step.  The layout's guard
    must cover the reach ``fused_steps * radius``.  A CUDA tensor runs the
    kernel's instance of its dtype (or raises); a CPU tensor runs
    ``stencil2d_step_plain``.  On a float64 state (dtypes 'float64' and
    'df64') it is also the fp64-grade step of ``pallas_df64.df64_step``
    and takes that wrapper's name 'vpu_sep'.  A bfloat16 state rounds once
    a launch, at its store (see the module's rounding rule).
    ``launches`` counts the float32 instances' launches, ``launches_f64``
    the float64 ones', ``launches_bf16`` the bfloat16 ones',
    ``launches_k1`` those of the steps a strip kernel ran (any dtype),
    ``launches_fused_strip`` those of the fused strip kernel,
    ``launches_plan_strip`` those of the plan strip kernel,
    ``launches_tile`` those of the tile kernel (step_kernel),
    ``launches_wide`` those of the wide kernel and ``launches_region`` the
    launches of any kernel over a ``region``.

    ``bounds`` (4 ints ``(rlo, rhi, clo, chi)``, interior coordinates; the
    interior when None; ``check_bounds(..., shard=True)``) is the box that
    the fused levels keep, the JAX wrapper's argument: a ghost boundary's
    ring, which the caller has filled, or a shard's exchanged ring stays
    alive through them.  The levels before the last take it whole: the
    next level reads them.  The last level keeps it cut to the interior:
    the ring and round-up cells it would keep are rewritten by the next
    pass's ring refresh (or the sharded exchange) before anything reads
    them, so the output is the JAX kernel's where it matters, and a shard's
    padding past the true edge (``rhi < m``) is zeroed as the JAX kernel
    zeroes it.  A box that holds the interior leaves a single step as it
    is without one.  ``refresh`` refills the ring of the buffer between two
    launches of a split pass (``_split_pass``): one too deep for a launch,
    or k strip launches (``strips_beat_plan``).

    ``region`` (``((ti0, ti1), (tj0, tj1))``, a window of ``layout.grid``
    tiles; the whole grid when None) writes that window of ``donor`` only
    and leaves its other cells as they were.  A pass deeper than one launch
    (``launch_depths``) cannot keep a window -- its second launch would
    read cells the first did not write -- so such a call raises
    ``ValueError``, on the CPU as on a card."""
    _check(cur, donor, spec, layout, algorithm, fused_steps)
    check_bounds(bounds, layout.interior, layout.guard, shard=True)
    region_cells(region, layout)
    if region is not None:
        depths = launch_depths("step", spec, cur.dtype, fused_steps)
        if len(depths) > 1:
            raise ValueError(
                f"a region needs a pass of one launch: {fused_steps} fused "
                f"steps of radius {spec.radius} take {len(depths)} (one "
                f"launch holds {depths[0]})")
    if cur.device.type == "cpu":
        return stencil2d_step_plain(cur, donor, spec, layout, fused_steps,
                                    bounds, region)
    if region is not None:
        _launch(_one_kind("step", spec, cur.dtype, fused_steps), (cur, donor),
                spec, layout, fused_steps, bounds, region)
        return donor
    return _split_pass("step", cur, donor, spec, layout, fused_steps, bounds,
                       refresh)


def stencil2d_skew_step(cur, donor, spec: StencilSpec, layout: Layout2D,
                        algorithm: str = "vpu_roll", skew_steps: int = 2):
    """``skew_steps`` >= 2 timesteps per pass over device memory by
    time-skewed row bands (``pallas_2d.stencil2d_skew_step``): the same
    values as ``stencil2d_step`` at the same depth, in another traversal.
    Takes what that wrapper takes: algorithm 'vpu_roll' or 'mxu_hybrid1',
    a guard covering ``skew_steps * radius`` (the port's layout, which
    needs no extra row tiles), a band of ``tile_rows`` rows at least 2r
    deep.  The skew kernel changes only the traversal, never a value, so a
    CUDA pass takes the fused pass's launches where the strip walk reaches
    (``_one_kind``: single strip launches, the fused strip or the plan strip
    kernel), skew_kernel beyond; each counted here as ``stencil2d_step``
    counts its own, the strip walk's in ``launches_k1``,
    ``launches_fused_strip`` and ``launches_plan_strip`` too and
    skew_kernel's in ``launches_tile``.  Its plain twin, which a CPU tensor
    runs, is the fused pass's, ``stencil2d_step_plain``."""
    if algorithm not in SKEW_ALGORITHMS:
        raise ValueError(
            f"skewed fusion supports algorithm 'vpu_roll' or "
            f"'mxu_hybrid1', got {algorithm!r}")
    if skew_steps < 2:
        raise ValueError("skew_steps must be >= 2 (use the plain step "
                         "for k=1)")
    _check(cur, donor, spec, layout, algorithm, skew_steps)
    if tile_rows(cur.dtype) < 2 * spec.radius:
        raise ValueError(
            f"band height (tile rows) must be >= 2 * {spec.radius}; got "
            f"{tile_rows(cur.dtype)}")
    if cur.device.type == "cpu":
        return stencil2d_step_plain(cur, donor, spec, layout, skew_steps)
    return _split_pass("skew", cur, donor, spec, layout, skew_steps)


def stencil2d_resident(cur, spec: StencilSpec, layout: Layout2D,
                       steps: int):
    """All ``steps`` timesteps in one cooperative launch
    (``pallas_2d.stencil2d_resident``; on a float64 state
    ``pallas_df64.stencil2d_resident_pair``): reads ``cur`` and returns a
    new buffer, the same values as ``steps`` single steps.  A CUDA state
    runs the shared-memory resident kernel where ``resident_takes`` says
    so, else ``csrc/stencil2d.cu``'s; raises if the card refuses the
    launch (no fallback to passes or to the other kernel).  The engine
    takes this path only under the caps ``fits_resident_2d`` and
    ``fits_resident_pair_2d``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    _check_state(cur, spec, layout, spec.radius)
    if cur.device.type == "cpu":
        return stencil2d_resident_plain(cur, spec, layout, steps)
    if resident_takes(spec, cur.dtype):
        return _launch_resident_smem(cur, spec, layout, steps)
    outs = (torch.zeros_like(cur), torch.zeros_like(cur))
    _launch("resident", (cur,) + outs, spec, layout, steps)
    return outs[(steps - 1) % 2]


# kernel launches per instance, for chip_smoke.py: float32, float64 and
# bfloat16, and each kernel's launches apart, in any dtype, on the wrapper
# whose pass made them (launches_k1: the strip kernel's steps;
# launches_fused_strip: the fused strip kernel's passes;
# launches_plan_strip: the plan strip kernel's launches; launches_tile: the
# tile kernels' -- step_kernel's from stencil2d_step, skew_kernel's from
# stencil2d_skew_step; launches_wide: the wide kernel's steps;
# launches_region: stencil2d_step's launches over a region; launches_smem:
# the shared-memory resident kernel's runs)
for _wrapper in (stencil2d_step, stencil2d_skew_step, stencil2d_resident):
    _wrapper.launches = _wrapper.launches_f64 = _wrapper.launches_bf16 = 0
stencil2d_step.launches_wide = stencil2d_step.launches_region = 0
stencil2d_resident.launches_smem = 0
for _wrapper in (stencil2d_step, stencil2d_skew_step):
    _wrapper.launches_k1 = _wrapper.launches_fused_strip = 0
    _wrapper.launches_plan_strip = _wrapper.launches_tile = 0
del _wrapper


# -- 'auto' for the df64 tier (pallas_df64.pick_algorithm, NumPy only) -------
# The JAX engine labels a 2-D df64 engine with the pair kernel's variant
# whose static op count is lowest; the port runs every variant through the
# one fp64 kernel and keeps the label, so both engines name the same
# algorithm.  Cost units and rules are pallas_df64's.
_COST_PRODUCT = 20.0
_COST_FOLD = 13.0
_COST_SPLIT = 3.0
_COST_ROLL = 3.0


def _split_weight(w64):
    """fp64 weight -> (w_h, w_l), its fp32 head and the fp32 rounding of
    the rest (the two halves the costs read)."""
    wh = np.float32(np.float64(w64))
    return float(wh), float(np.float32(np.float64(w64) - np.float64(wh)))


def _fold_taps(taps):
    """Odd-length taps -> ('single', d, w) and, for equal +-d weights,
    ('pair', d, w) entries."""
    taps = [float(t) for t in taps]
    r = (len(taps) - 1) // 2
    entries = []
    if taps[r] != 0.0:
        entries.append(("single", 0, _split_weight(taps[r])))
    for d in range(1, r + 1):
        wp, wm = taps[r + d], taps[r - d]
        if wp == wm:
            if wp != 0.0:
                entries.append(("pair", d, _split_weight(wp)))
        else:
            if wp != 0.0:
                entries.append(("single", d, _split_weight(wp)))
            if wm != 0.0:
                entries.append(("single", -d, _split_weight(wm)))
    return tuple(entries)


def _sep_plan(spec: StencilSpec):
    """((col_ops|None, row_ops|None) per term, folded residue entries):
    residue offsets o and -o with equal weights fold into a pair."""
    terms = tuple(tuple(None if t is None else _fold_taps(t)
                        for t in term.taps) for term in spec.terms)
    items = [(tuple(int(o) for o in off), float(w))
             for off, w in spec.residue]
    used = set()
    res = []
    for i, (off, w) in enumerate(items):
        if i in used:
            continue
        neg = tuple(-o for o in off)
        j = next((k for k in range(i + 1, len(items))
                  if k not in used and items[k][0] == neg
                  and items[k][1] == w), None)
        if j is not None and off != neg:
            used.add(j)
            res.append(("pair", off, _split_weight(w)))
        else:
            res.append(("single", off, _split_weight(w)))
    return terms, tuple(res)


def _entry_cost(kind: str, d, w2) -> float:
    """Cost of one folded entry on the code path the pair kernel takes."""
    unit = 1.0 if isinstance(d, int) else float(sum(1 for o in d if o))
    is_zero = (d == 0) if isinstance(d, int) else not any(d)
    w_pm1 = (abs(w2[0]), w2[1]) == (1.0, 0.0)
    if kind == "pair":
        cost = 4 * unit * _COST_ROLL + _COST_FOLD
        if w_pm1:
            return cost + _COST_FOLD
        return cost + _COST_SPLIT + _COST_PRODUCT
    if is_zero:
        return _COST_FOLD if w_pm1 else _COST_PRODUCT
    if w_pm1:
        return 2 * unit * _COST_ROLL + _COST_FOLD
    return 3 * unit * _COST_ROLL + _COST_PRODUCT


def _sep_cost(spec: StencilSpec) -> float:
    terms, res = _sep_plan(spec)
    cost = _COST_SPLIT
    for axes in terms:
        for ai, ops in enumerate(axes):
            if ops is None:
                continue
            cost += sum(_entry_cost(kind, d, w) for kind, d, w in ops)
            if ai > 0:
                cost += _COST_SPLIT
    return cost + sum(_entry_cost(kind, off, w) for kind, off, w in res)


def _dense_cost(spec: StencilSpec) -> float:
    idxs = np.argwhere(np.abs(spec.dense_coeffs()) > 0)
    cost = len({int(i[0]) for i in idxs}) * 4 * _COST_ROLL
    for idx in idxs:
        if int(idx[1]) - spec.radius:
            cost += 4 * _COST_ROLL
        cost += _COST_PRODUCT
    return cost


def pick_algorithm(spec: StencilSpec) -> str:
    """'vpu_sep' when the separable pair plan's static op count beats the
    dense roll path, else 'vpu_roll' (pallas_df64.pick_algorithm)."""
    return "vpu_sep" if _sep_cost(spec) < _dense_cost(spec) else "vpu_roll"
