"""The port, chip_smoke.py, launch_overhead.py and the port's example
(examples/torch_inverse_source.py) import nothing of JAX and nothing of the
JAX package (lorastencil_tpu): each is imported in a fresh interpreter, and
both scripts refuse to run without a CUDA device."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import lorastencil_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return ["lorastencil_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(lorastencil_tpu_torch.__path__,
                                              "lorastencil_tpu_torch."))


def test_port_modules_load_no_jax_and_no_jax_package():
    modules = _port_modules()
    assert {"lorastencil_tpu_torch.ops.stencil3d", "lorastencil_tpu_torch.models.shapes",
            "lorastencil_tpu_torch.models.factorize", "lorastencil_tpu_torch.ops.torch_ref",
            "lorastencil_tpu_torch.utils.reference", "lorastencil_tpu_torch.cli",
            "lorastencil_tpu_torch.parallel.domain",
            "lorastencil_tpu_torch.parallel.dryrun",
            "lorastencil_tpu_torch.parallel.multihost"} <= set(modules)
    # the port's examples too (examples/ on the path)
    scripts = ["chip_smoke", "launch_overhead", "torch_inverse_source"]
    code = ("import importlib, sys\n"
            "sys.path.append('examples')\n"
            f"for name in {modules + scripts!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'lorastencil_tpu' or m.startswith('lorastencil_tpu.'))\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith('lorastencil_tpu_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= len(modules)


def test_chip_smoke_flags_reference_imports():
    import chip_smoke

    # this test process imported both packages (tests/conftest.py, the parity tests)
    import lorastencil_tpu.models.shapes  # noqa: F401

    loaded = chip_smoke.loaded_reference_modules()
    assert "lorastencil_tpu.models.shapes" in loaded
    assert all(m == "jax" or m.startswith(("jax.", "lorastencil_tpu.")) or m == "lorastencil_tpu"
               for m in loaded)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run on it")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr


def test_launch_overhead_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: launch_overhead.py would run on it")
    proc = subprocess.run([sys.executable, "launch_overhead.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not proc.stdout


def test_chip_smoke_bound_counts_the_fewest_operations():
    """A bound's operations: an add per nonzero term after the first, a multiply
    per weight that is not +-1, an equal (+d, -d) pair added first."""
    import chip_smoke
    from lorastencil_tpu_torch.models.shapes import get_shape

    # 1d1r taps 1 2 3 4 3 2 1: 6 adds, multiplies for 4, 3 and 2
    assert chip_smoke.step_flops(get_shape("1d1r")) == 9
    assert chip_smoke.step_flops(get_shape("1d2r")) == 12
    assert chip_smoke.sum_ops({(0,): 2.0}) == 1
    assert chip_smoke.sum_ops({(-1,): 0.5, (0,): 1.0, (1,): 0.25}) == 4
    assert chip_smoke.sum_ops({(-1, 1): -3.0, (1, -1): -3.0, (0, 0): 0.0}) == 2
    bound, by = chip_smoke.bound_ms(get_shape("1d1r"), (4096,), 64, itemsize=8)
    assert by == "operations" and bound == 4096 * 64 * 9 / chip_smoke.PEAK_FP64_FLOPS * 1e3
    assert chip_smoke.bound_ms(get_shape("star2d1r"), (8192, 8192), 1)[1] == "bytes"
