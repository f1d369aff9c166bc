"""The CUDA kernel (lorastencil_tpu_torch/csrc/stencil2d.cu) on the card against
its plain PyTorch twin, at small sizes.  Needs an NVIDIA GPU with nvcc (the
kernel is built from source at first use); elsewhere every test here skips.

    python -m pytest tests/test_torch_cuda.py -q -n 0 -m cuda

Tolerances: the integer fill is exact (every partial sum is an integer below
2**24), so kernel and twin agree bit for bit at 1 and 2 steps.  On the pi/100
fill the kernel fuses each multiply-add and the twin rounds products
separately: rel <= 1e-6 of the largest value after 4 steps."""

import numpy as np
import pytest
import torch

from lorastencil_tpu.models.shapes import get_shape
from lorastencil_tpu.utils import reference
from lorastencil_tpu_torch import engine
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d, guard_2d

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _steps(step, cur, spec, lay, steps):
    return engine.ping_pong_loop(lambda c, d: step(c, d, spec, lay), cur, steps)


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


def test_engine_counts_its_launches(cuda):
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
