"""The port's dry run of the sharded engines,
``lorastencil_tpu_torch.parallel.dryrun.dryrun_multichip``, on the CPU: the
JAX dry run's cases (``__graft_entry__.dryrun_multichip``) over meshes of CPU
shards, each held to the fp64 ground truth (1e-6 float32, 1e-12 df64) inside
the function, which raises on a mismatch; its command line; and every case
printed once (the z-sharded and df64 ones only on 8 shards, as in JAX)."""

import os
import subprocess
import sys

import pytest
import torch

from lorastencil_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,cases", [(8, 18), (4, 15), (2, 5)])
def test_dryrun_multichip(n, cases, capsys):
    dryrun.dryrun_multichip(n)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == cases and all(": OK, rel err" in ln for ln in lines)
    if n == 8:
        assert any("(2,2,2) z-sharded" in ln for ln in lines)
        assert any("df64 (4,) 1-D wide radius 49" in ln for ln in lines)


def test_dryrun_command_line():
    proc = subprocess.run([sys.executable, "-m", "lorastencil_tpu_torch.parallel.dryrun", "4",
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count(": OK, rel err") == 15


def test_dryrun_raises_on_a_wrong_result(monkeypatch):
    """A mismatch fails the run: the ground truth moved by one step."""
    from lorastencil_tpu_torch.utils import reference

    run = reference.run
    monkeypatch.setattr(reference, "run", lambda g, spec, steps: run(g, spec, steps + 1))
    with pytest.raises(AssertionError, match="sharded dryrun mismatch"):
        dryrun.dryrun_multichip(2)
