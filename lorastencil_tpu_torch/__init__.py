"""lorastencil_tpu_torch: the PyTorch / CUDA port of lorastencil_tpu.

Counterpart of ``lorastencil_tpu/__init__.py``.  The port imports ``torch``
and nothing of the JAX package: the stencil registry (``models/shapes.py``),
the fp64 ground truth (``utils/reference.py``) and the GStencil/s record
(``utils/metrics.py``) are its own copies, and ``convert.spec_from_jax``
carries a JAX spec across.

What runs today, float32, dirichlet0, each through a hand-written CUDA
kernel with a plain PyTorch twin for CPU tensors:
  * 2-D at one timestep per pass (star2d1r, box2d1r, box2d3r):
    ``csrc/stencil2d.cu``;
  * 3-D at the engine's fused depth (star3d1r, box3d1r; k = 2 by
    default): ``csrc/stencil3d.cu``.
ROADMAP.md lists what is still to be ported.
"""

from .models.shapes import ALL_SHAPES, SeparableTerm, StencilSpec, get_shape

__version__ = "0.1.0"
__all__ = ["ALL_SHAPES", "StencilSpec", "SeparableTerm", "get_shape"]
