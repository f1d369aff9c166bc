"""The port and chip_smoke.py import nothing of JAX and nothing of the JAX
package (lorastencil_tpu): each is imported in a fresh interpreter, and
chip_smoke.py refuses to run without a CUDA device."""

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
            "lorastencil_tpu_torch.utils.reference", "lorastencil_tpu_torch.cli"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for name in {modules + ['chip_smoke']!r}:\n"
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
