"""Multi-process meshes for the sharded engines.

Counterpart of ``lorastencil_tpu/parallel/multihost.py``: ``initialize``
starts the process group (``jax.distributed.initialize`` there,
``torch.distributed.init_process_group`` here), ``global_mesh`` builds a
mesh of any shape -- (dx,), (dx, dy) or (dz, dx, dy) -- over every
process's devices and ``run_replicated`` runs a sharded engine of any
dimension so that every process receives the whole global result.

Nothing here reads a cluster from the environment: the caller names the
coordinator (``host:port``, any free port of one of the hosts), the
number of processes and this process's id, as
``torch.distributed``'s TCP rendezvous needs.  The group's backend follows
the device the state lives on: NCCL for CUDA, gloo for the CPU.  NCCL
takes one device per rank, so a rank's shards share its one card.
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .domain import Mesh, _device, make_mesh


def free_port() -> int:
    """A TCP port of this host that no socket holds now (the OS picks it),
    for a coordinator on ``localhost``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Start the process group (idempotent: a second call, or a group
    already started, is left as it is).  ``coordinator_address`` is
    'host:port' of the rank-0 process (a single process needs none);
    ``backend`` 'nccl' or 'gloo', by default chosen from ``device``: NCCL
    for 'cuda' (this rank's card becomes the current device), gloo for
    'cpu'; with neither, NCCL where CUDA is available."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes, process_id = 1, 0
    if process_id is None:
        raise ValueError("process_id is needed with num_processes")
    if device is not None:
        dev = _device(device)
    else:
        dev = torch.device("cuda" if backend == "nccl" or (
            backend is None and torch.cuda.is_available()) else "cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else
                              torch.cuda.current_device())
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError("a group of several processes needs "
                             "coordinator_address='host:port'")
        coordinator_address = f"localhost:{free_port()}"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def global_mesh(mesh_shape: Sequence[int],
                devices_per_process: Sequence) -> Mesh:
    """A mesh over every process's devices: each process passes its own
    local devices (e.g. ``["cpu", "cpu"]`` or ``["cuda:0"]``), every
    process must call it, and the mesh takes the devices in rank order,
    then in each process's order, row-major over ``mesh_shape``.  Without
    a process group it is ``make_mesh``."""
    shape = tuple(int(s) for s in mesh_shape)
    n = int(np.prod(shape))
    if not dist.is_initialized():
        return make_mesh(shape, devices_per_process)
    mine = [str(_device(d)) for d in devices_per_process]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    flat = [(rank, d) for rank, devs in enumerate(gathered) for d in devs]
    if len(flat) < n:
        raise ValueError(
            f"mesh {shape} needs {n} devices; the global device set has "
            f"{len(flat)} (over {dist.get_world_size()} processes)")
    flat = flat[:n]
    rank = dist.get_rank()
    return Mesh(shape, tuple(_device(d) if r == rank else torch.device(d)
                             for r, d in flat),
                tuple(r for r, _ in flat), rank)


def run_replicated(eng, padded, steps: int):
    """``eng.run`` with a replicated output: every process passes the SAME
    global padded array and receives the whole global result, so host-side
    code (checksums, checkpoints, verification) needs no gather.  ``eng``
    is a sharded engine of ``parallel.domain`` whose mesh may span
    processes (``from_sharded`` gathers the blocks)."""
    return eng.from_sharded(eng._run(eng.to_sharded(padded), steps))
