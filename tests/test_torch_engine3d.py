"""The port's 3-D engine against the JAX engine (Pallas interpret mode) and the
fp64 ground truth for box3d1r over several JAX slabs, on the CPU (device "cpu"
runs the CUDA kernel's plain twin).  The other engine cases, the kernel
module's checks and the tolerances' reasons are in tests/test_torch_stencil3d.py;
the two files are apart so that a test run spread over workers runs them side by
side."""

import pytest

from test_torch_stencil3d import SLABS, compare_with_jax_engine


@pytest.mark.parametrize("k", [1, 2, 4])
def test_box3d1r_engine_matches_jax_engine_over_slabs(k):
    compare_with_jax_engine("box3d1r", SLABS, k)
