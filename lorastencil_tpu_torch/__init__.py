"""lorastencil_tpu_torch: the PyTorch / CUDA port of lorastencil_tpu.

Counterpart of ``lorastencil_tpu/__init__.py``.  The stencil registry
(``models/shapes.py``) is plain NumPy and is shared with the JAX package,
not copied: both packages run the same ``StencilSpec`` objects.  This
package imports ``torch`` and never ``jax``.

What runs today: 2-D dirichlet0 stencils in float32 at one timestep per
pass (star2d1r, box2d1r, box2d3r) through a hand-written CUDA kernel
(``csrc/stencil2d.cu``), with a plain PyTorch twin for CPU tensors.
ROADMAP.md lists what is still to be ported.
"""

from lorastencil_tpu.models.shapes import (ALL_SHAPES, SeparableTerm,
                                           StencilSpec, get_shape)

__version__ = "0.1.0"
__all__ = ["ALL_SHAPES", "StencilSpec", "SeparableTerm", "get_shape"]
