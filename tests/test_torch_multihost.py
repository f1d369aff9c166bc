"""The port's multi-process meshes (``lorastencil_tpu_torch.parallel.multihost``)
on the CPU: gloo groups of processes, each holding CPU shards of one mesh,
run ``run_replicated`` (tests/torch_multihost_worker.py) and hold the whole
result bit for bit against the same engine over a mesh one process holds, and
within 1e-6 of the fp64 ground truth: in 2-D two processes with two shards
each on a (2, 2) mesh (the overlapped exchange), and four processes of one
shard each on a periodic (2, 2) torus; in 1-D two processes of two shards on
a (4,) mesh (the overlapped exchange) and a reflect one; in 3-D two
processes on a (2, 2) plane mesh (the overlapped exchange) and a periodic
(2, 2, 2) z-sharded mesh.  Every process gets a time limit and a free port,
so that a hang fails the test instead of stalling the run."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lorastencil_tpu_torch.parallel import domain, multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")


def run_group(world, shards, mesh, boundary, shape):
    """The worker's outputs, (returncode, stdout, stderr) per rank, of a gloo
    group of ``world`` processes."""
    port = multihost.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(port), str(world), str(rank),
                               str(shards), ",".join(map(str, mesh)), boundary, shape],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def check_outputs(outs, overlap):
    for rank, (code, out, err) in enumerate(outs):
        assert code == 0, err[-3000:]
        assert out.startswith(f"OK {rank} "), out
        assert out.split()[-1] == str(overlap)  # which step ran


@pytest.mark.parametrize("world,shards,boundary", [(2, 2, "dirichlet0"),
                                                   (4, 1, "periodic")])
def test_processes_run_replicated(world, shards, boundary):
    check_outputs(run_group(world, shards, (2, 2), boundary, "star2d1r"), True)


@pytest.mark.parametrize("shape,mesh,boundary,overlap", [
    ("1d2r", (4,), "dirichlet0", True),
    ("1d2r", (4,), "reflect", True),
    ("box3d1r", (2, 2), "dirichlet0", True),
    ("box3d1r", (2, 2, 2), "periodic", False),
])
def test_processes_run_replicated_1d_3d(shape, mesh, boundary, overlap):
    """The 1-D and 3-D engines across two processes of half the shards
    each; a z-sharded mesh takes the ring-out step."""
    check_outputs(run_group(2, int(np.prod(mesh)) // 2, mesh, boundary, shape),
                  overlap)


def test_global_mesh_without_a_group_is_make_mesh():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is running in this process")
    mesh = multihost.global_mesh((2, 2), ["cpu"] * 4)
    assert mesh == domain.make_mesh((2, 2), ["cpu"] * 4)
    assert not mesh.spans_processes and mesh.local() == mesh.coords()
