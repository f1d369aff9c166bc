"""One process of tests/test_torch_multihost.py: joins a gloo group of
``world`` processes at ``localhost:port``, builds a mesh over every
process's CPU shards (``multihost.global_mesh``), runs the 2-D sharded
engine through ``multihost.run_replicated`` and checks the whole result
against the fp64 ground truth and the same engine run in this process over
a mesh it holds alone (``devices=["cpu"] * n``): bit for bit.  Prints
"OK <rank> <max rel err>" on success.

    python tests/torch_multihost_worker.py PORT WORLD RANK SHARDS DX DY BOUNDARY
"""

import sys

import numpy as np
import torch

from lorastencil_tpu_torch.models.shapes import get_shape
from lorastencil_tpu_torch.parallel import domain, multihost
from lorastencil_tpu_torch.utils import reference

INTERIOR = (192, 768)
STEPS = 5


def main(argv):
    port, world, rank, shards, dx, dy = (int(a) for a in argv[:6])
    boundary = argv[6]
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    spec = get_shape("star2d1r")
    padded = np.zeros(spec.padded_shape(INTERIOR))
    it = reference.interior_slices(spec, padded.shape)
    padded[it] = np.random.default_rng(7).uniform(0, 0.01, INTERIOR)
    kw = dict(fused_steps=2, boundary=boundary)
    mesh = multihost.global_mesh((dx, dy), ["cpu"] * shards)
    assert mesh.spans_processes and len(mesh.local()) == shards
    eng = domain.sharded_engine("star2d1r", INTERIOR, (dx, dy), mesh=mesh, **kw)
    got = multihost.run_replicated(eng, padded, STEPS)
    alone = domain.sharded_engine("star2d1r", INTERIOR, (dx, dy),
                                  mesh=domain.Mesh((dx, dy), (torch.device("cpu"),) * (dx * dy),
                                                   (rank,) * (dx * dy), rank), **kw)
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
