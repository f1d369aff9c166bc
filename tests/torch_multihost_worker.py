"""One process of tests/test_torch_multihost.py: joins a gloo group of
``world`` processes at ``localhost:port``, builds a mesh over every
process's CPU shards (``multihost.global_mesh``), runs the sharded engine of
``shape`` (1-D, 2-D or 3-D) through ``multihost.run_replicated`` and checks
the whole result against the fp64 ground truth and the same engine run in
this process over a mesh it holds alone (``devices=["cpu"] * n``): bit for
bit.  Prints "OK <rank> <max rel err> overlap <bool>" on success.

    python tests/torch_multihost_worker.py PORT WORLD RANK SHARDS MESH BOUNDARY SHAPE

MESH is the mesh shape as comma-separated ints, e.g. "2,2" or "2,2,2".
"""

import sys

import numpy as np
import torch

from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.parallel import domain, multihost
from lorastencil_tpu_torch.utils import reference

# each shape's interior and engine options: the 2-D and 3-D ones split into
# >= 3 x 3 local tiles and the 1-D one into >= 3 local tiles, so that the
# overlapped exchange runs on plane meshes
CASES = {"star2d1r": ((192, 768), dict(fused_steps=2)),
         "1d2r": ((30_000,), dict(fused_steps=2)),
         "box3d1r": ((6, 96, 384), dict(tile=(8, 64)))}
STEPS = 5


def main(argv):
    port, world, rank, shards = (int(a) for a in argv[:4])
    mesh_shape = tuple(int(d) for d in argv[4].split(","))
    boundary, shape = argv[5], argv[6]
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    spec = get_shape(shape)
    interior, kw = CASES[shape]
    kw = dict(kw, boundary=boundary)
    padded = np.zeros(spec.padded_shape(interior))
    it = reference.interior_slices(spec, padded.shape)
    padded[it] = np.random.default_rng(7).uniform(0, 0.01, interior)
    mesh = multihost.global_mesh(mesh_shape, ["cpu"] * shards)
    assert mesh.spans_processes and len(mesh.local()) == shards
    eng = domain.sharded_engine(shape, interior, mesh_shape, mesh=mesh, **kw)
    got = multihost.run_replicated(eng, padded, STEPS)
    n = int(np.prod(mesh_shape))
    alone = domain.sharded_engine(
        shape, interior, mesh_shape,
        mesh=domain.Mesh(mesh_shape, (torch.device("cpu"),) * n, (rank,) * n,
                         rank), **kw)
    assert alone._can_overlap() == eng._can_overlap()
    want_alone = alone.run(padded, STEPS)
    assert torch.equal(got, want_alone), (got - want_alone).abs().max()
    truth = {"periodic": reference.run_periodic,
             "reflect": reference.run_reflect}.get(boundary, reference.run)
    want = truth(padded, spec, STEPS)
    err = np.abs(got.double().numpy()[it] - want[it]).max() / np.abs(want[it]).max()
    assert err <= 1e-6, err
    total = eng.run_checksum(padded, STEPS)
    assert float(total) == float(alone.run_checksum(padded, STEPS))
    torch.distributed.destroy_process_group()
    print(f"OK {rank} {err} overlap {eng._can_overlap()}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
