"""lorastencil_tpu_torch: the PyTorch / CUDA port of lorastencil_tpu.

Counterpart of ``lorastencil_tpu/__init__.py``.  The port imports ``torch``
and nothing of the JAX package: the stencil registry (``models/shapes.py``),
the fp64 ground truth (``utils/reference.py``) and the GStencil/s record
(``utils/metrics.py``) are its own copies, and ``convert.spec_from_jax``
carries a JAX spec across.

What runs today, dirichlet0, each through a hand-written CUDA kernel with
a plain PyTorch twin for CPU tensors:
  * 2-D (star2d1r, box2d1r, box2d3r, star2d3r) at the engine's fused
    depth, extent-fused or time-skewed, and the opt-in whole-grid runs:
    ``csrc/stencil2d.cu``;
  * 3-D at the engine's fused depth (star3d1r, box3d1r; k = 2 by
    default): ``csrc/stencil3d.cu``;
  * 1-D (1d1r, 1d2r, ``for_coeffs`` taps): ``csrc/stencil1d.cu``;
in float32 and, in 1-D and 2-D, the fp64-grade tier (native fp64).
ROADMAP.md lists what is still to be ported.
"""

from .models.shapes import ALL_SHAPES, SeparableTerm, StencilSpec, get_shape

__version__ = "0.1.0"
__all__ = ["ALL_SHAPES", "StencilSpec", "SeparableTerm", "get_shape"]
