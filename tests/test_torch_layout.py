"""The port's internal layout (lorastencil_tpu_torch.ops.layout), state carried
over from the JAX package (lorastencil_tpu_torch.convert), and the port's
independence from JAX."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorastencil_tpu import engine as jax_engine
from lorastencil_tpu.models.shapes import get_shape as jax_get_shape
from lorastencil_tpu.ops import pallas_2d
from lorastencil_tpu.ops.layout import Layout2D as JaxLayout2D
from lorastencil_tpu_torch import convert, engine
from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.ops import stencil2d
from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d, guard_2d
from lorastencil_tpu_torch.utils import reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("interior,tile,guard", [((64, 256), (64, 256), (8, 128)),
                                                 ((40, 300), (40, 384), (8, 128)),
                                                 ((37, 45), (16, 32), (8, 128))])
def test_layout_contract_matches_jax(interior, tile, guard):
    """Same fields, same grid/origin/shape, same embedding of the padded array."""
    spec = get_shape("star2d1r")
    jl = JaxLayout2D(interior=interior, halo=spec.halo, tile=tile, guard=guard)
    pl = Layout2D(interior=interior, halo=spec.halo, tile=tile, guard=guard)
    assert (pl.grid, pl.origin, pl.shape) == (jl.grid, jl.origin, jl.shape)
    g0 = reference.random_padded(spec, interior, seed=5)
    buf = pl.to_internal(g0)
    assert buf.dtype == torch.float32
    assert np.array_equal(buf.numpy(), np.asarray(jl.to_internal(g0)))
    assert np.array_equal(pl.from_internal(buf).numpy(), g0)


def test_port_layout_guard_and_ring():
    spec = get_shape("star2d1r")
    interior = (50, 70)
    lay = Layout2D(interior=interior, halo=spec.halo, tile=default_tile_2d(*interior),
                   guard=guard_2d(spec.halo, spec.radius))
    assert lay.guard == (4, 4)  # >= max(halo, radius), 16-byte aligned
    assert guard_2d((4, 4), 5) == (8, 8)
    assert lay.rounded == (64, 128) and lay.shape == (72, 136)
    g0 = reference.random_padded(spec, interior, seed=2) + 1.0  # no zeros
    buf = lay.to_internal(g0)
    r0, c0 = lay.origin
    inside = torch.zeros(lay.shape, dtype=torch.bool)
    inside[r0 - 4: r0 + 54, c0 - 4: c0 + 74] = True
    assert torch.all(buf[inside] > 0) and torch.all(buf[~inside] == 0)
    with pytest.raises(ValueError, match="shape"):
        lay.to_internal(g0[1:])
    with pytest.raises(ValueError, match="guard"):
        Layout2D(interior=interior, halo=(4, 4), tile=(8, 8), guard=(2, 4)).validate()


@pytest.mark.parametrize("name,interior", [("star2d1r", (40, 300)), ("box2d1r", (64, 256))])
def test_state_from_jax_continues_the_run_exactly(name, interior):
    """One JAX step on its internal state, carried over, then one port step:
    equal to two JAX steps."""
    spec = get_shape(name)
    jeng = jax_engine.StencilEngine.for_shape(name, interior)
    g0 = reference.random_padded(spec, interior, seed=9)
    s1 = jeng.run_internal(jeng.to_internal(g0), 1)
    peng = engine.StencilEngine.for_shape(name, interior, device="cpu")
    state = convert.state_from_jax(np.asarray(s1), jeng.layout, peng.layout)
    got = peng.from_internal(peng.run_internal(state, 1)).numpy()
    want = np.asarray(jeng.run(g0, 2))
    assert np.array_equal(got, want)
    assert np.array_equal(got, reference.run(g0, spec, 2))


def test_state_from_jax_refuses_a_foreign_buffer():
    spec = get_shape("star2d1r")
    jl = JaxLayout2D(interior=(16, 128), halo=spec.halo, tile=(16, 128))
    pl = Layout2D(interior=(16, 128), halo=spec.halo, tile=(32, 128), guard=(4, 4))
    buf = np.asarray(jl.to_internal(np.ones(spec.padded_shape((16, 128)))))
    assert torch.equal(convert.state_from_jax(buf, jl, pl),
                       pl.to_internal(np.ones(spec.padded_shape((16, 128)))))
    dirty = buf.copy()
    dirty[0, 0] = 1.0  # outside the padded array
    with pytest.raises(ValueError, match="outside"):
        convert.state_from_jax(dirty, jl, pl)
    other = Layout2D(interior=(16, 64), halo=spec.halo, tile=(32, 128), guard=(4, 4))
    with pytest.raises(ValueError, match="disagree"):
        convert.state_from_jax(buf, jl, other)


def test_convert_feeds_the_kernel_from_a_pallas_step():
    """A Pallas kernel step, carried into the port's own layout, then the
    port's kernel module: two steps of the reference."""
    spec = get_shape("box2d3r")
    interior = (24, 200)
    jl = JaxLayout2D(interior=interior, halo=spec.halo, tile=(24, 256))
    g0 = reference.random_padded(spec, interior, seed=4)
    x = jl.to_internal(g0)
    s1 = pallas_2d.stencil2d_step(x, jnp.zeros_like(x), jax_get_shape("box2d3r"), jl,
                                  interpret=True,
                                  algorithm="mxu_hybrid1", fused_steps=1)
    pl = Layout2D(interior=interior, halo=spec.halo, tile=(32, 128), guard=(4, 4))
    cur = convert.state_from_jax(np.asarray(s1), jl, pl)
    out = stencil2d.stencil2d_step(cur, torch.zeros_like(cur), spec, pl)
    assert np.array_equal(pl.from_internal(out).numpy(), reference.run(g0, spec, 2))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import lorastencil_tpu_torch, lorastencil_tpu_torch.engine\n"
            "import lorastencil_tpu_torch.cli, lorastencil_tpu_torch.convert\n"
            "import lorastencil_tpu_torch.utils.metrics\n"
            "import lorastencil_tpu_torch.ops._cuda_build\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
