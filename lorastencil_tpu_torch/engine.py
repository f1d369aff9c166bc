"""High-level stencil engine of the PyTorch / CUDA port.

Counterpart of ``lorastencil_tpu/engine.py``: ``EngineConfig`` (the same
fields and defaults), ``resolve_algorithm``, ``ping_pong_loop`` and
``StencilEngine`` with ``for_shape``, ``run``, ``run_checksum``,
``run_internal``, ``to_internal`` and ``from_internal``.

    eng = StencilEngine.for_shape("star2d1r", (8192, 8192))  # on "cuda"
    out_padded = eng.run(in_padded, steps=4)
    eng3 = StencilEngine.for_shape("box3d1r", (256, 256, 256))

What this engine runs, float32, dirichlet0, ``backend`` "auto" / "pallas"
(a CUDA kernel; its plain twin on a CPU tensor) or "xla"
(``ops/torch_ref.separable_step``):
  * 2-D shapes whose fused depth resolves to one step (star2d1r, box2d1r,
    box2d3r) through ``ops/stencil2d.py``;
  * 3-D shapes (star3d1r, box3d1r) at the JAX engine's fused depth
    ``k = min(fused_steps_3d, 8 // radius)`` (2 by default) through
    ``ops/stencil3d.py``: ``steps // k`` passes of k steps, then one pass
    of ``steps % k``.
Every other accepted value of the JAX engine raises
``NotImplementedError`` naming the ROADMAP item that will port it.

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

from .models.shapes import StencilSpec, get_shape

from .ops import stencil2d, stencil3d, torch_ref
from .ops.layout import (Layout2D, Layout3D, default_tile_2d,
                         default_tile_3d, guard_2d, guard_3d)

ALGORITHM_NAMES = ("auto", "vpu", "vpu_roll", "mxu", "mxu_split",
                   "mxu_hybrid", "mxu_hybrid1", "mxu_hybrid1r",
                   "mxu_hybrid3")


def resolve_algorithm(spec: StencilSpec, name: str) -> str:
    """Resolve algorithm='auto' as the JAX engine does for float32:
    'vpu' for 3-D, 'mxu_hybrid1' for 2-D; like the other exact fp32
    names they run the one CUDA kernel of their dimension.  (The JAX
    engine's other resolutions, for 1-D, bf16 and fp64, arrive with
    those ROADMAP items.)"""
    if name != "auto":
        return name
    return "vpu" if spec.ndim == 3 else "mxu_hybrid1"


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


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX engine's configuration, field for field (see
    ``lorastencil_tpu.engine.EngineConfig`` for what each one means).
    ``StencilEngine`` says which values the port runs."""

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
        self.dtype = torch.float32
        self.backend = "xla" if config.backend == "xla" else "pallas"
        self.algorithm = resolve_algorithm(spec, config.algorithm)
        kernel = stencil3d if spec.ndim == 3 else stencil2d
        if self.algorithm in kernel.UNPORTED_ALGORITHMS:
            raise _not_ported(f"algorithm {self.algorithm!r}", "B13")
        if self.algorithm not in kernel.ALGORITHMS:
            raise ValueError(
                f"algorithm {self.algorithm!r} has no {spec.ndim}-D path; "
                f"the port runs {kernel.ALGORITHMS}")
        if spec.ndim == 2 and self._fused_k() != 1:
            raise _not_ported(
                f"{spec.name} at fused_steps={self._fused_k()} (k > 1)",
                "B2")
        self.layout = self._build_layout()

    @staticmethod
    def _validate(spec: StencilSpec, config: EngineConfig):
        if spec.ndim == 1:
            raise _not_ported("1-D stencils", "A7")
        if config.dtype in ("bfloat16", "float64"):
            raise _not_ported(f"dtype {config.dtype!r}", "A6")
        if config.dtype == "df64":
            raise _not_ported("dtype 'df64'", "A9")
        if config.dtype != "float32":
            raise ValueError(f"unknown dtype {config.dtype!r}")
        if config.backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {config.backend!r}")
        if config.boundary in ("periodic", "reflect"):
            raise _not_ported(f"boundary {config.boundary!r}", "A6")
        if config.boundary != "dirichlet0":
            raise ValueError(
                f"boundary must be 'dirichlet0', 'periodic' or "
                f"'reflect', got {config.boundary!r}")
        if config.precision not in ("highest", "default"):
            raise ValueError(
                f"precision must be 'highest' or 'default', got "
                f"{config.precision!r}")
        if config.algorithm not in ALGORITHM_NAMES:
            raise ValueError(f"unknown algorithm {config.algorithm!r}")
        if config.fusion == "skew":
            raise _not_ported("fusion='skew'", "B11")
        if config.fusion not in ("auto", "extent"):
            raise ValueError(
                f"fusion must be 'auto', 'extent' or 'skew', got "
                f"{config.fusion!r}")
        if config.residue_mxu == "on":
            raise _not_ported("residue_mxu='on'", "B2")
        if config.residue_mxu not in ("auto", "off"):
            raise ValueError(
                f"residue_mxu must be 'auto', 'on' or 'off', got "
                f"{config.residue_mxu!r}")
        if config.interpret:
            raise ValueError(
                "the port has no interpret mode: device='cpu' runs the "
                "kernels' plain PyTorch twins")

    @classmethod
    def for_shape(cls, name: str, interior, device="cuda",
                  **kw) -> "StencilEngine":
        cfg_kw = {k: v for k, v in kw.items()
                  if k in EngineConfig.__dataclass_fields__}
        return cls(get_shape(name), interior, EngineConfig(**cfg_kw),
                   device=device)

    @classmethod
    def for_coeffs(cls, *args, **kw):
        raise _not_ported("StencilEngine.for_coeffs", "A6")

    def _fused_k(self) -> int:
        """The JAX engine's fused-depth rules: 3-D
        ``min(max(1, fused_steps_3d), 8 // radius)``; 2-D extent fusion."""
        if self.backend == "xla":
            return 1
        if self.spec.ndim == 3:
            return max(1, min(self.config.fused_steps_3d,
                              8 // self.spec.radius))
        k = self.config.fused_steps
        if k is None:
            few_terms = (not self.spec.residue
                         and len(self.spec.terms) <= 2
                         and self.algorithm in ("mxu_hybrid1", "vpu_roll"))
            k = 2 if few_terms else 1
        return max(1, k)

    def _build_layout(self):
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

    def _step_internal(self, cur, donor, fused_k: int = 1):
        if self.backend == "xla":
            for _ in range(fused_k):
                cur = torch_ref.separable_step(cur, self.spec)
            return cur
        if self.spec.ndim == 3:
            return stencil3d.stencil3d_step(
                cur, donor, self.spec, self.layout,
                algorithm=self.algorithm, fused_steps=fused_k)
        return stencil2d.stencil2d_step(cur, donor, self.spec, self.layout,
                                        algorithm=self.algorithm,
                                        fused_steps=fused_k)

    # -- public API -------------------------------------------------------
    def to_internal(self, padded):
        """The internal state on the engine's device: a new layout buffer,
        or for backend 'xla' (which steps the padded layout) the padded
        array as a float32 tensor, which no step writes to."""
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
        written (the result lives in one of two new buffers)."""
        return ping_pong_loop(self._step_internal, state, steps,
                              self._fused_k())

    def run(self, padded, steps: int):
        """Reference-semantics run on a user padded array (NumPy or
        torch); returns a new float32 tensor on the engine's device.  The
        caller's array is not modified."""
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
