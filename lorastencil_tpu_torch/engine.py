"""High-level stencil engine of the PyTorch / CUDA port.

Counterpart of ``lorastencil_tpu/engine.py``: ``EngineConfig`` (the same
fields and defaults), ``resolve_algorithm``, ``ping_pong_loop``,
``StencilEngine`` with ``for_shape``, ``run``, ``run_checksum``,
``run_internal``, ``to_internal`` and ``from_internal``, and the one-shot
``run(padded, spec, steps, device=..., **config)``.

    eng = StencilEngine.for_shape("star2d1r", (8192, 8192))  # on "cuda"
    out_padded = eng.run(in_padded, steps=4)
    eng3 = StencilEngine.for_shape("box3d1r", (256, 256, 256))
    eng1 = StencilEngine.for_shape("1d2r", (1_000_000,))
    out_padded = run(in_padded, get_shape("star3d1r"), 4, dtype="df64")

What this engine runs, ``backend`` "auto" / "pallas" (a CUDA
kernel; its plain twin on a CPU tensor) or "xla"
(``ops/torch_ref.separable_step``, which takes every algorithm name the
JAX engine takes), in float32 and in the fp64-grade tier (dtype "float64"
or "df64", see below):
  * 1-D shapes (1d1r, 1d2r, ``for_coeffs`` taps up to radius 127) through
    ``ops/stencil1d.py``, with the JAX engine's dispatch (see
    ``_build_layout_1d``): small grids run all steps in one launch, large
    ones ``ping_pong_loop`` passes of the JAX engine's fused depth;
  * 2-D shapes (star2d1r, box2d1r, box2d3r, star2d3r) through
    ``ops/stencil2d.py`` at the JAX engine's fused depth (see
    ``_fused_k``: k = 2 for the few-term star2d3r, 1 for the others unless
    ``fused_steps`` says otherwise), in either fusion mode: 'extent'
    (``stencil2d_step``, k levels over shrinking extents) or 'skew'
    (``stencil2d_skew_step``, time-skewed row bands); a remainder pass of
    ``steps % k``; and, when the state fits the caps
    (``LORASTENCIL_RESIDENT2D_KB``, ``LORASTENCIL_RESIDENT2D_PAIR_KB``: on
    the CPU the JAX package's, off by default; on a card, where they are
    unset, ``stencil2d.CUDA_RESIDENT_2D_BYTES`` and
    ``CUDA_RESIDENT_PAIR_2D_BYTES``, measured on an H100), every step in
    one ``stencil2d_resident`` launch.
    ``fusion='auto'`` means 'extent': the JAX engine's 'auto' reads its
    autotune cache, which the port does not have yet (ROADMAP A12), and
    resolves 'extent' when the cache is empty;
  * 3-D shapes (star3d1r, box3d1r) at the JAX engine's fused depth
    ``k = min(fused_steps_3d, 8 // radius)`` (2 by default; 1 for "df64")
    through ``ops/stencil3d.py``: ``steps // k`` passes of k steps, then
    one pass of ``steps % k``;
  * ``boundary`` 'dirichlet0' (the reference's halo decay), 'periodic'
    (the grid wraps) or 'reflect' (a symmetric, zero-flux mirror), the
    latter two "ghost" modes as the JAX engine runs them: before every
    pass the guard ring, k * radius deep (``_ring_depth``), is refilled
    from the interior (``_ring_refresh``: plain tensor copies, axis by
    axis, so corners compose as ``np.pad``), and the pass's kernel keeps
    the ring through its fused levels (``bounds``, ``_ghost_bounds``; the
    last level keeps the interior, see ``ops/stencil2d.stencil2d_step``);
    no whole-grid run is taken (the 1-D and 2-D small grids run passes,
    1-D on the flat path below ``RESIDENT_BYTES``); the output's ring is
    cleared at the end.  df64 on the 'xla' step refreshes the padded
    array's ring before every step; float32 and float64 refuse 'xla'.
    Fused reflect needs per-axis symmetric coefficients, and every
    interior dimension must hold the ring: the JAX engine's checks and
    messages, in its order.
Every other accepted value of the JAX engine raises
``NotImplementedError`` naming the ROADMAP item that will port it.

The fp64-grade tier.  The TPU has no fp64 unit, so the JAX engine's dtype
"df64" carries fp64-grade values as error-free (hi, lo) fp32 pairs, and its
dtype "float64" runs only off the TPU.  The H100 has fp64 units: here both
dtypes hold a float64 state and run the float64 instances of the same CUDA
kernels, in native double; the pair arithmetic is not ported.  Each keeps
the JAX engine's dispatch: "df64" one step per pass everywhere, its 1-D
branches (``_build_layout_1d``) and the ``df64_algorithm`` label
(``ops/stencil2d.pick_algorithm`` in 2-D, 'vpu_sep' in 3-D), an effective
radius of 0 on the "xla" step, in 2-D the pair cap of the whole-grid run;
"float64" resolves "auto" to "vpu_roll" and keeps the float32 rules for
the fused depth (1 in 2-D unless ``fused_steps`` is given, 2 on the 1-D
lanes path and in 3-D).  ``run`` returns a float64 tensor.

``residue_mxu`` takes the JAX engine's values; 'on' moves the TPU kernel's
residue onto its matrix unit, which the card has no use for: every value
runs the same exact CUDA-core sums.

``device`` defaults to "cuda" and raises when CUDA is absent: the engine
never moves to the CPU by itself.  ``device="cpu"`` runs the plain twins.
PyTorch runs eagerly, so there is no jit: each step is one kernel launch
on the current stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .models.shapes import SeparableTerm, StencilSpec, get_shape

from .ops import stencil1d, stencil2d, stencil3d, torch_ref
from .ops.layout import (TILE_1D, Layout1D, Layout2D, Layout3D,
                         default_tile_2d, default_tile_3d, guard_1d, guard_2d,
                         guard_3d)

ALGORITHM_NAMES = ("auto", "vpu", "vpu_roll", "vpu_sep", "mxu", "mxu_split",
                   "mxu_hybrid", "mxu_hybrid1", "mxu_hybrid1r",
                   "mxu_hybrid3")
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "df64": torch.float64}
# the JAX 2-D layout's column guard (its LANE), which caps a 2-D pass's
# reach k * radius in the JAX engine's fused-depth rules
JAX_COL_GUARD = 128


def resolve_algorithm(spec: StencilSpec, name: str,
                      dtype: str = "float32") -> str:
    """Resolve algorithm='auto' as the JAX engine does: 'vpu_roll' for
    float64; otherwise 'mxu' for 1-D, 'mxu_hybrid1' for 2-D, 'vpu' for
    3-D.  Like the other exact names they run the CUDA kernels of their
    dimension.  (The bf16 resolutions arrive with that ROADMAP item.)"""
    if name != "auto":
        return name
    if dtype == "float64":
        return "vpu_roll"
    return {1: "mxu", 2: "mxu_hybrid1", 3: "vpu"}[spec.ndim]


def ping_pong_loop(step_fn, state, steps: int, k: int = 1):
    """Run ``steps`` timesteps as ``steps // k`` passes of
    ``step_fn(cur, donor, k) -> out`` and then, if ``steps % k``, one
    pass of ``step_fn(cur, donor, steps % k)`` (the JAX engine's
    remainder pass).

    Two zero buffers are made here and alternate as the donor, so the
    input ``state`` is read but never written: its guard ring holds the
    user halo and must never become an output buffer (the halo would
    stop decaying).  ``step_fn`` writes the donor's interior in place;
    the donor's zero guard ring is what zeroes the halo from step 1 on.
    """
    if steps == 0:
        return state
    passes, rem = divmod(steps, k)
    depths = [k] * passes + ([rem] if rem else [])
    bufs = (torch.zeros_like(state), torch.zeros_like(state))
    cur = state
    for i, depth in enumerate(depths):
        cur = step_fn(cur, bufs[i % 2], depth)
    return cur


def _ring_refresh_nd(state, mode: str, origin, dims, d: int):
    """Axis-by-axis ghost-ring fill, in place, of depth ``d`` around the
    box at ``origin`` / ``dims`` of ``state`` (``lorastencil_tpu/engine.py``
    ``_ring_refresh_nd``): 'periodic' copies the opposite interior edge,
    'reflect' mirrors the same edge (``torch.flip``), 'zero' clears the
    ring.  Later axes copy the rings already written, so corners (and 3-D
    edges) compose as ``np.pad`` does.  Returns ``state``."""
    ext = [slice(o, o + n) for o, n in zip(origin, dims)]
    for a, (o, n) in enumerate(zip(origin, dims)):
        def at(sl):
            box = list(ext)
            box[a] = sl
            return tuple(box)

        left, right = at(slice(o - d, o)), at(slice(o + n, o + n + d))
        if mode == "zero":
            state[left] = 0
            state[right] = 0
        else:
            head = state[at(slice(o, o + d))]
            tail = state[at(slice(o + n - d, o + n))]
            # the sources lie inside the box, the ring outside it (the box
            # is at least d deep: the engine's ring-depth check)
            if mode == "reflect":
                head, tail = head.flip(a), tail.flip(a)
            else:  # periodic
                head, tail = tail, head
            state[left] = head
            state[right] = tail
        ext[a] = slice(o - d, o + n + d)
    return state


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX engine's configuration, field for field (see
    ``lorastencil_tpu.engine.EngineConfig`` for what each one means).
    ``StencilEngine`` says which values the port runs.  ``lanes_width``
    and ``lanes_tile_rows`` shape the TPU's overlapped-lanes 1-D layout,
    which the port's flat ``Layout1D`` replaces (``ops/layout.py``): they
    change no value, and their one use is the JAX engine's, to keep a
    df64 grid off the resident run."""

    dtype: str = "float32"
    precision: str = "highest"
    backend: str = "auto"  # 'pallas' | 'xla' | 'auto'
    tile: Optional[Tuple[int, int]] = None
    interpret: Optional[bool] = None
    algorithm: str = "auto"
    fused_steps: Optional[int] = None
    fused_steps_3d: int = 2
    fusion: str = "auto"
    lanes_width: Optional[int] = None
    lanes_tile_rows: Optional[int] = None
    residue_mxu: str = "auto"
    boundary: str = "dirichlet0"


def _config(kw) -> EngineConfig:
    """An ``EngineConfig`` of the items of ``kw`` that are its fields; the
    rest are ignored, as the JAX engine's constructors do."""
    return EngineConfig(**{k: v for k, v in kw.items()
                           if k in EngineConfig.__dataclass_fields__})


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to lorastencil_tpu_torch yet (ROADMAP "
        f"{item})")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but CUDA is not available; pass "
                "device='cpu' to run the plain PyTorch twins")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


class StencilEngine:
    def __init__(self, spec: StencilSpec, interior,
                 config: EngineConfig = EngineConfig(), device="cuda"):
        self.spec = spec
        self.interior = tuple(int(s) for s in np.atleast_1d(interior))
        if len(self.interior) != spec.ndim:
            raise ValueError(
                f"{spec.name} is {spec.ndim}-D, interior is "
                f"{self.interior}")
        self.config = config
        self._validate(spec, config)
        self.device = _device(device)
        self.dtype = DTYPES[config.dtype]
        self.df64 = config.dtype == "df64"
        self.backend = "xla" if config.backend == "xla" else "pallas"
        self.df64_algorithm = None
        if self.df64:
            self._resolve_df64()
        else:
            self.algorithm = resolve_algorithm(spec, config.algorithm,
                                               config.dtype)
        self.df64_pallas = self.df64 and self.backend == "pallas"
        # 1-D and the 'xla' step: every name runs
        if spec.ndim > 1 and not self.df64 and self.backend != "xla":
            kernel = stencil3d if spec.ndim == 3 else stencil2d
            if self.algorithm in kernel.UNPORTED_ALGORITHMS:
                raise _not_ported(f"algorithm {self.algorithm!r}", "B13")
            if self.algorithm not in kernel.ALGORITHMS:
                raise ValueError(
                    f"algorithm {self.algorithm!r} has no {spec.ndim}-D "
                    f"path; the port runs {kernel.ALGORITHMS}")
        # periodic / reflect: the guard ring is refilled before every pass
        self.ghost = config.boundary != "dirichlet0"
        # the 1-D kernel: "resident_lanes", "resident", "lanes" or "flat"
        self.path = None
        if spec.ndim == 1:
            self.layout, self.path = self._build_layout_1d()
        else:
            self.layout = self._build_layout()
        if self.ghost and min(self.interior) < self._ring_depth():
            raise ValueError(
                f"{config.boundary} boundaries need every interior dim "
                f">= the ring depth {self._ring_depth()} "
                f"(= fused_steps * radius); got {self.interior}")
        if (config.boundary == "reflect" and self._fused_k() > 1
                and not spec.axis_symmetric()):
            raise ValueError(
                "reflect boundaries with fused_steps > 1 need per-axis "
                "symmetric coefficients (mirror symmetry must commute "
                "with the stencil for the once-per-pass ring refresh to "
                "be exact); use fused_steps=1 for this spec")

    @staticmethod
    def _validate(spec: StencilSpec, config: EngineConfig):
        if config.dtype == "bfloat16":
            raise _not_ported(f"dtype {config.dtype!r}", "A6")
        if config.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {config.dtype!r}")
        if config.backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {config.backend!r}")
        if config.algorithm not in ALGORITHM_NAMES:
            raise ValueError(f"unknown algorithm {config.algorithm!r}")
        if config.boundary not in ("dirichlet0", "periodic", "reflect"):
            raise ValueError(
                f"boundary must be 'dirichlet0', 'periodic' or "
                f"'reflect', got {config.boundary!r}")
        if (config.boundary != "dirichlet0" and config.backend == "xla"
                and config.dtype != "df64"):
            # (df64 is exempt: its 'xla' step refreshes the ring of the
            # padded array before every step, _ring_refresh_padded)
            raise ValueError(
                f"{config.boundary} boundaries need the Pallas backend "
                f"(the XLA reference path implements the reference's "
                f"halo-decay semantics only)")
        if config.precision not in ("highest", "default"):
            raise ValueError(
                f"precision must be 'highest' or 'default', got "
                f"{config.precision!r}")
        if config.fusion not in ("auto", "extent", "skew"):
            raise ValueError(
                f"fusion must be 'auto', 'extent' or 'skew', got "
                f"{config.fusion!r}")
        if config.fusion == "skew":
            StencilEngine._validate_skew(spec, config)
        if config.residue_mxu not in ("auto", "on", "off"):
            raise ValueError(
                f"residue_mxu must be 'auto', 'on' or 'off', got "
                f"{config.residue_mxu!r}")
        if config.interpret:
            raise ValueError(
                "the port has no interpret mode: device='cpu' runs the "
                "kernels' plain PyTorch twins")

    @staticmethod
    def _validate_skew(spec: StencilSpec, config: EngineConfig):
        """The JAX engine's checks of fusion='skew', in its order and with
        its messages.  Its algorithm is the resolved one, which for df64 is
        'auto' resolved in float32 (the JAX engine accepts 'skew' there
        and runs its single-step df64 passes)."""
        if spec.ndim != 2:
            raise ValueError(
                "fusion='skew' is the 2-D time-skewed path; use "
                "fused_steps/fused_steps_3d elsewhere")
        if config.backend == "xla":
            raise ValueError("fusion='skew' needs the Pallas backend")
        if config.boundary != "dirichlet0":
            raise ValueError(
                "fusion='skew' supports dirichlet0 boundaries only "
                "(ghost rings would need per-level ring evolution)")
        algorithm = (resolve_algorithm(spec, "auto") if config.dtype == "df64"
                     else resolve_algorithm(spec, config.algorithm,
                                            config.dtype))
        if algorithm not in stencil2d.SKEW_ALGORITHMS:
            raise ValueError(
                f"fusion='skew' supports algorithm 'vpu_roll' or "
                f"'mxu_hybrid1'; resolved algorithm is {algorithm!r}")
        if config.fused_steps is not None and config.fused_steps < 2:
            raise ValueError(
                "fusion='skew' needs fused_steps >= 2 (k=1 has no lag to "
                "skew; use fusion='extent')")
        if JAX_COL_GUARD // max(1, spec.radius) < 2:
            raise ValueError(
                f"fusion='skew' creeps k*radius columns into the "
                f"{JAX_COL_GUARD}-col guard; radius {spec.radius} leaves no "
                f"room for k >= 2")

    def _resolve_df64(self):
        """The JAX engine's df64 branch (``lorastencil_tpu/engine.py``
        ``StencilEngine.__init__``): the kernel applies unless the backend
        is 'xla' or, in 1-D, the effective radius is 0 (a centre tap only,
        which then runs the 'xla' step); ``df64_algorithm`` is 'auto'
        resolved to ``stencil2d.pick_algorithm`` in 2-D, 'vpu_sep' in 3-D
        and 'vpu_roll' in 1-D, or the given name, which must be one the
        kernel takes; and ``algorithm`` is what the JAX engine resolves
        'auto' to."""
        spec, config = self.spec, self.config
        kernel = config.backend != "xla" and (
            spec.ndim > 1 or stencil1d.effective_radius(spec) >= 1)
        if config.backend == "pallas" and not kernel:
            raise ValueError(
                "no df64 kernel applies: 1-D needs an effective radius in "
                "[1, 127]; this spec runs the plain fp64 step (backend "
                "'auto'/'xla')")
        if config.algorithm != "auto":
            self.df64_algorithm = config.algorithm
        elif kernel and spec.ndim == 3:
            self.df64_algorithm = "vpu_sep"
        elif kernel and spec.ndim == 2:
            self.df64_algorithm = stencil2d.pick_algorithm(spec)
        else:
            self.df64_algorithm = "vpu_roll"
        allowed = {1: ("vpu_roll",), 2: stencil2d.DF64_ALGORITHMS,
                   3: ("vpu_sep",)}[spec.ndim]
        if kernel and self.df64_algorithm not in allowed:
            raise ValueError(
                f"df64 kernel algorithm must be 'auto' or one of {allowed} "
                f"for {spec.ndim}-D, got {config.algorithm!r}")
        self.backend = "pallas" if kernel else "xla"
        self.algorithm = resolve_algorithm(spec, "auto")

    @classmethod
    def for_shape(cls, name: str, interior, device="cuda",
                  **kw) -> "StencilEngine":
        return cls(get_shape(name), interior, _config(kw), device=device)

    @classmethod
    def for_coeffs(cls, coeffs, interior, name: str = "custom", halo=None,
                   fuse_factor: int = 1, device="cuda",
                   **kw) -> "StencilEngine":
        """Engine for a dense coefficient array.  1-D: a vector of taps
        (odd length, radius up to 127), as the JAX engine builds it; 2-D
        and 3-D (the low-rank decompositions, and their ``max_rank``) are
        not ported yet."""
        S = np.asarray(coeffs, dtype=np.float64)
        if S.ndim != 1:
            raise _not_ported(f"StencilEngine.for_coeffs in {S.ndim}-D", "A6")
        if S.size % 2 != 1:
            raise ValueError(f"1-D taps must have odd length, got {S.size}")
        radius = (S.size - 1) // 2
        spec = StencilSpec(
            name=name, ndim=1, radius=radius,
            halo=tuple(halo) if halo is not None else (radius,),
            terms=(SeparableTerm(taps=(tuple(float(w) for w in S),)),),
            residue=(), fuse_factor=fuse_factor)
        return cls(spec, interior, _config(kw), device=device)

    def _fusion_mode(self) -> str:
        """'skew' for fusion='skew' in 2-D, else 'extent'.  The JAX
        engine's 'auto' adopts 'skew' only where its per-device autotune
        cache says so; the port has no such cache yet (ROADMAP A12), so its
        'auto' is 'extent', as the JAX engine's on an empty cache."""
        if self.spec.ndim == 2 and self.config.fusion == "skew":
            return "skew"
        return "extent"

    def _fused_k(self) -> int:
        """The JAX engine's fused-depth rules: 1 for 'xla' and 'df64'; 1-D
        (see below); 3-D ``min(max(1, fused_steps_3d), 8 // radius)``; 2-D
        skew ``min(fused_steps or 2, 128 // radius)``, 2-D extent
        ``fused_steps`` or, unset, 2 for few-term specs without residue in
        float32 and 1 otherwise, clamped to ``128 // radius``.  The clamp is
        the JAX layout's 128-column guard; the port's guard is its own
        (``guard_2d``), but the same config takes the same k and so the same
        launches."""
        if self.backend == "xla" or self.df64:
            return 1
        if self.spec.ndim == 1:
            # 'mxu' (the default): max(1, 12 // r_eff), the TPU's measured
            # optimum; else 2.  The lanes kernels cap k * r_eff at 32
            # (the resident run at its refresh), the flat pass k at 64.
            r_eff = stencil1d.effective_radius(self.spec)
            k = self.config.fused_steps
            if k is None:
                k = (max(1, 12 // max(1, r_eff)) if self.algorithm == "mxu"
                     else 2)
            k = max(1, k)
            path = getattr(self, "path", None)
            if path == "lanes":
                return min(k, stencil1d.MAX_LANES_REACH // r_eff)
            if path == "resident_lanes":
                return min(k, stencil1d.lanes_refresh(r_eff))
            return min(k, stencil1d.MAX_FUSED)
        if self.spec.ndim == 3:
            return max(1, min(self.config.fused_steps_3d,
                              8 // self.spec.radius))
        r = max(1, self.spec.radius)
        if self._fusion_mode() == "skew":
            return min(self.config.fused_steps or 2, JAX_COL_GUARD // r)
        k = self.config.fused_steps
        if k is None:
            few_terms = (not self.spec.residue
                         and len(self.spec.terms) <= 2
                         and self.dtype != torch.float64
                         and self.algorithm in ("mxu_hybrid1", "vpu_roll"))
            k = 2 if few_terms else 1
        return min(max(1, k), JAX_COL_GUARD // r)

    def _build_layout(self):
        # the guard covers a pass's reach, which is also the ring depth of
        # a ghost boundary (_ring_depth)
        reach = self._fused_k() * self.spec.radius
        if self.spec.ndim == 3:
            tile = self.config.tile or default_tile_3d(*self.interior[1:])
            layout = Layout3D(
                interior=self.interior, halo=self.spec.halo,
                tile=tuple(int(t) for t in tile),
                guard=guard_3d(self.spec.halo, reach))
        else:
            tile = self.config.tile or default_tile_2d(*self.interior)
            layout = Layout2D(
                interior=self.interior, halo=self.spec.halo,
                tile=tuple(int(t) for t in tile),
                guard=guard_2d(self.spec.halo, reach))
        layout.validate()
        return layout

    def _build_layout_1d(self):
        """(layout, path): the JAX engine's 1-D dispatch
        (``lorastencil_tpu/engine.py`` ``_build_layout`` and
        ``_run_internal``), branch for branch:

        * r_eff in [1, 32] and algorithm 'mxu' (auto) or 'vpu_roll'
          ("lanes ok"): a grid whose state fits ``RESIDENT_LANES_BYTES``
          runs all steps in one ``stencil1d_resident_lanes`` launch
          (``run_kernel``'s narrow sums), else passes of
          ``stencil1d_lanes_step`` (``lanes_kernel``);
        * otherwise (other algorithms, wider taps): a grid whose state
          fits ``RESIDENT_BYTES`` runs one ``stencil1d_resident`` launch
          (``run_kernel``'s wide sums), else passes of ``stencil1d_step``
          (``wide_kernel``).

        The df64 tier (one step per pass) has its own branches: r_eff in
        [1, 32] runs the narrow run (``run_kernel``'s float64 narrow
        sums) when its state fits ``RESIDENT_LANES_BYTES`` and neither
        ``lanes_width`` nor ``lanes_tile_rows`` is set, else narrow passes
        (``pass_kernel<double>``); r_eff in [33, 127] wide passes
        (``wide_kernel``), never a run.  The narrow run's layout keeps a
        guard of ``lanes_refresh(r_eff) * r_eff``, the JAX run's lane halo,
        so that the size test matches the JAX engine's; ``run_kernel``
        needs only r_eff of it.

        The two caps are the JAX engine's numbers (2 MiB, 512 KiB), kept
        so that both engines take the same branch at the BASELINE sizes
        (1d1r 4096 resident, 1d2r 1,000,000 tiled) and under 'vpu';
        re-tuning them for the H100 is later work.  The test is the
        port's own, on the port's layout, at the state's bytes per cell.

        Under a ghost boundary no run is taken (the ring is refilled
        between passes, ``_run_internal`` of the JAX engine): a grid under
        ``RESIDENT_BYTES`` runs passes on the flat path whatever its taps
        (1d1r 4096: ``wide_kernel`` at k = 4), a larger one with "lanes
        ok" the lanes passes, and df64 its narrow passes.  The guard then
        also covers the ring, k * radius deep (``_ring_depth``), which is
        more than the pass's reach k * r_eff where the outer taps are zero
        (1d1r: radius 4, r_eff 3)."""
        spec = self.spec
        n, halo = self.interior[0], spec.halo[0]
        r_eff = stencil1d.effective_radius(spec)
        itemsize = self.dtype.itemsize

        def layout(k):
            # a pass of k steps: its reach, and its ring under a ghost mode
            reach = k * r_eff
            if self.ghost:
                reach = max(reach, k * spec.radius, 1)
            lay = Layout1D(interior=n, halo=halo, tile=TILE_1D,
                           guard=guard_1d(halo, reach))
            lay.validate()
            return lay

        if self.backend == "xla":
            return layout(0), "flat"
        if self.df64:
            if r_eff > stencil1d.MAX_LANES_REACH:
                return layout(1), "flat"
            if not (self.ghost or self.config.lanes_width
                    or self.config.lanes_tile_rows):
                lay = layout(stencil1d.lanes_refresh(r_eff))
                if stencil1d.fits_resident_lanes(lay, itemsize):
                    return lay, "resident_lanes"
            return layout(1), "lanes"
        lanes_ok = (1 <= r_eff <= stencil1d.MAX_LANES_REACH
                    and self.algorithm in ("mxu", "vpu_roll"))
        if lanes_ok and not self.ghost:
            lay = layout(stencil1d.lanes_refresh(r_eff))
            if stencil1d.fits_resident_lanes(lay, itemsize):
                return lay, "resident_lanes"
        flat = layout(self._fused_k())
        if self.ghost and (not lanes_ok
                           or stencil1d.fits_resident(flat, itemsize)):
            return flat, "flat"
        if lanes_ok:
            self.path = "lanes"  # for _fused_k's lanes clamp
            return layout(self._fused_k()), "lanes"
        return flat, ("resident" if stencil1d.fits_resident(flat, itemsize)
                      else "flat")

    # -- ghost boundaries (periodic, reflect) ------------------------------
    def _ring_depth(self) -> int:
        """The ghost ring's depth: a pass's reach, fused steps x radius."""
        return max(1, self._fused_k() * self.spec.radius)

    def _ring_refresh(self, state, mode: str):
        """Fill, in place, the guard ring (depth ``_ring_depth``) of a
        layout buffer so that one pass sees the boundary's ghost cells:
        'periodic' the opposite interior edge, 'reflect' the same edge
        mirrored, 'zero' clears it (the output's halo contract).  The
        JAX engine's ``_ring_refresh``; plain tensor copies on the
        state's device, as the JAX engine leaves them to XLA."""
        lay = self.layout
        if self.spec.ndim == 1:
            return _ring_refresh_nd(state, mode, (lay.origin,),
                                    (lay.interior,), self._ring_depth())
        return _ring_refresh_nd(state, mode, lay.origin, lay.interior,
                                self._ring_depth())

    def _ring_refresh_padded(self, state, mode: str):
        """The ring refresh of the 'xla' step's padded array (df64 only):
        origin the spec's halo, depth its radius, before every step."""
        return _ring_refresh_nd(state, mode, self.spec.halo, self.interior,
                                self.spec.radius)

    def _ghost_bounds(self):
        """The box ``[-d, s + d)`` per axis, d the ring depth, that the
        fused levels keep, so that the ring survives them."""
        d = self._ring_depth()
        return tuple(v for s in self.interior for v in (-d, s + d))

    def _step_internal(self, cur, donor, fused_k: int = 1):
        mode = self.config.boundary
        if self.backend == "xla":
            for _ in range(fused_k):
                if self.ghost:  # df64 only (_validate)
                    cur = self._ring_refresh_padded(cur, mode)
                cur = torch_ref.separable_step(cur, self.spec)
            return cur
        bounds = refresh = None
        if self.ghost:
            cur = self._ring_refresh(cur, mode)
            bounds = self._ghost_bounds()

            def refresh(state):
                return self._ring_refresh(state, mode)
        if self.path == "lanes":
            return stencil1d.stencil1d_lanes_step(
                cur, donor, self.spec, self.layout, fused_steps=fused_k,
                bounds=bounds)
        if self.spec.ndim == 1:
            return stencil1d.stencil1d_step(cur, donor, self.spec,
                                            self.layout, fused_steps=fused_k,
                                            bounds=bounds)
        algorithm = self.df64_algorithm if self.df64 else self.algorithm
        if self.spec.ndim == 3:
            return stencil3d.stencil3d_step(
                cur, donor, self.spec, self.layout, algorithm=algorithm,
                fused_steps=fused_k, bounds=bounds, refresh=refresh)
        if self._fusion_mode() == "skew" and fused_k >= 2:
            # a remainder pass of one step runs the extent kernel
            return stencil2d.stencil2d_skew_step(
                cur, donor, self.spec, self.layout,
                algorithm=self.algorithm, skew_steps=fused_k)
        return stencil2d.stencil2d_step(
            cur, donor, self.spec, self.layout, algorithm=algorithm,
            fused_steps=fused_k, bounds=bounds, refresh=refresh)

    def _resident_2d(self) -> bool:
        """Whether a 2-D run takes every step in one ``stencil2d_resident``
        launch: the JAX engine's rule (``_run_internal``), evaluated at run
        time on the port's layout.  df64: the pair cap; otherwise not skew,
        an exact algorithm, and the state under the cap.  On a card the
        caps are the CUDA ones, and the kernel's capacity bounds them.  A
        ghost boundary never takes it: its ring is refilled per pass."""
        if self.spec.ndim != 2 or self.backend != "pallas" or self.ghost:
            return False
        if self.df64:
            return stencil2d.fits_resident_pair_2d(self.layout, self.device,
                                                   self.spec)
        return (self._fusion_mode() != "skew"
                and self.algorithm in ("mxu_hybrid1", "vpu_roll", "vpu")
                and stencil2d.fits_resident_2d(self.layout,
                                               self.dtype.itemsize,
                                               self.device, self.spec))

    # -- public API -------------------------------------------------------
    def to_internal(self, padded):
        """The internal state on the engine's device and in its dtype
        (float32, or float64 for 'float64' and 'df64'): a new layout
        buffer, or for backend 'xla' (which steps the padded layout) the
        padded array as a tensor, which no step writes to."""
        if self.backend == "xla":
            return torch.as_tensor(padded, dtype=self.dtype,
                                   device=self.device)
        return self.layout.to_internal(padded, self.dtype, self.device)

    def from_internal(self, state):
        if self.backend == "xla":
            return state
        return self.layout.from_internal(state)

    def run_internal(self, state, steps: int):
        """``steps`` timesteps on internal state; ``state`` is read, not
        written (the result lives in a new buffer).  1-D small grids, and
        2-D grids under the caps (``_resident_2d``), run every step in one
        resident launch.  Under a ghost boundary every pass first refills
        the ring of its input (the first pass's on a copy of ``state``),
        and the result's ring is cleared at the end."""
        if steps > 0 and self.path == "resident_lanes":
            return stencil1d.stencil1d_resident_lanes(
                state, self.spec, self.layout, steps)
        if steps > 0 and self.path == "resident":
            return stencil1d.stencil1d_resident(state, self.spec, self.layout,
                                                steps)
        if steps > 0 and self._resident_2d():
            return stencil2d.stencil2d_resident(state, self.spec, self.layout,
                                                steps)
        if not (self.ghost and steps > 0):
            return ping_pong_loop(self._step_internal, state, steps,
                                  self._fused_k())
        out = ping_pong_loop(self._step_internal, state.clone(), steps,
                             self._fused_k())
        if self.backend == "xla":
            return out  # each step's output has a zero halo
        # the output buffer's ring was refilled when it was a pass's input;
        # the output halo contract is zeros
        return self._ring_refresh(out, "zero")

    def run(self, padded, steps: int):
        """Reference-semantics run on a user padded array (NumPy or
        torch); returns a new tensor of the engine's dtype (float64 in the
        fp64-grade tier) on the engine's device.  The caller's array is
        not modified."""
        out = self.from_internal(
            self.run_internal(self.to_internal(padded), steps))
        return out.clone(memory_format=torch.contiguous_format)

    def run_checksum(self, padded, steps: int):
        """Like ``run`` but returns only the sum of the final state, as
        a 0-d float64 tensor on the device (for timing)."""
        return self.run_internal(self.to_internal(padded), steps).sum(
            dtype=torch.float64)

    def run_diff(self, *args, **kw):
        raise _not_ported("StencilEngine.run_diff", "A10")

    def run_vjp(self, *args, **kw):
        raise _not_ported("StencilEngine.run_vjp", "A10")

    def adjoint(self):
        raise _not_ported("StencilEngine.adjoint", "A10")


def run(padded, spec: StencilSpec, steps: int, device="cuda", **kw):
    """One-shot run (``lorastencil_tpu.engine.run`` with ``device``): an
    engine for ``spec`` itself (a custom spec as well as a registry one),
    its interior taken from ``padded``'s shape less the halo; ``kw`` items
    that are ``EngineConfig`` fields configure it, the rest are ignored."""
    interior = tuple(int(s) - 2 * h for s, h in zip(np.shape(padded),
                                                    spec.halo))
    return StencilEngine(spec, interior, _config(kw),
                         device=device).run(padded, steps)
