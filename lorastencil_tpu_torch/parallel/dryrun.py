"""A multi-shard dry run of the sharded engines on tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip`` (the JAX package's):
the same cases at the same sizes, each held to the fp64 ground truth
(``utils/reference.py``) at the same tolerance -- 1e-6 in float32, 1e-12
in df64 -- over a mesh of ``n_devices`` shards in this process.  The
shards are CPU shards by default (the kernels' plain twins); on a card,
``devices=["cuda:0"] * n`` puts them all on it (the CUDA kernels, strips
moved by device copies).  Run it with

    python -m lorastencil_tpu_torch.parallel.dryrun [n_devices] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models.shapes import get_shape
from ..utils import reference
from . import domain


def _rel(got, want) -> float:
    got = np.asarray(got.cpu().double().numpy() if hasattr(got, "cpu")
                     else got, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _ghost(spec, g0, interior):
    """``g0`` with a zero halo (a ghost boundary ignores it) and the
    interior's slices."""
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    out = np.zeros_like(g0)
    out[it] = g0[it]
    return out, it


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Domain decomposition with the neighbour exchange and per-shard
    kernels, real steps on tiny shapes, verified against the fp64 ground
    truth: a 1-D mesh, a 2-D mesh, a 3-D shape, a fused custom stencil,
    ghost boundaries, the overlapped exchange, non-divisible interiors, a
    z-sharded 3-D mesh and the sharded df64 tier in 1-D, 2-D and 3-D (the
    JAX dry run's cases).  ``devices``: one per shard (default CPU
    shards).  Raises ``AssertionError`` on a mismatch."""
    n = int(n_devices)
    devices = list(devices) if devices is not None else ["cpu"] * n

    def engine(shape, interior, mesh, **kw):
        size = int(np.prod(mesh))
        return domain.sharded_engine(shape, interior, mesh,
                                     devices=devices[:size], **kw)

    def report(tag, err, tol):
        assert err < tol, f"sharded dryrun mismatch [{tag}]: rel err {err}"
        print(f"dryrun_multichip({n}) {tag}: OK, rel err {err:.2e}",
              flush=True)

    def check(tag, sh, spec, g0, steps):
        report(tag, _rel(sh.run(g0, steps), reference.run(g0, spec, steps)),
               1e-6)

    # 1) flagship on a 1-D mesh, 2 timesteps fused per halo exchange
    spec = get_shape("star2d1r")
    interior = (8 * n, 128)
    g0 = reference.random_padded(spec, interior, seed=0)
    sh = engine("star2d1r", interior, (n, 1), tile=(8, 128), fused_steps=2)
    check("star2d1r 1-D mesh k=2", sh, spec, g0, 3)

    if n % 2 == 0 and n >= 4:
        dx, dy = n // 2, 2
        # 2) flagship on a 2-D mesh (fused)
        interior = (8 * dx, 128 * dy)
        g0 = reference.random_padded(spec, interior, seed=1)
        sh = engine("star2d1r", interior, (dx, dy), tile=(8, 128),
                    fused_steps=2)
        check(f"star2d1r {dx}x{dy} mesh k=2", sh, spec, g0, 5)

        # 3) a 3-D shape on a 2-D mesh (the fused 3-D pass per shard)
        spec3 = get_shape("box3d1r")
        interior3 = (4, 8 * dx, 128 * dy)
        g3 = reference.random_padded(spec3, interior3, seed=2)
        sh3 = engine("box3d1r", interior3, (dx, dy), tile=(8, 128),
                     fused_steps=2)
        check(f"box3d1r {dx}x{dy} mesh k=2", sh3, spec3, g3, 3)

    # 4) fused custom-coefficient stencil (factorized automatically)
    S = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0
    S[0, 2] += 0.125  # non-separable spike -> residue path
    shc = domain.sharded_engine_for_coeffs(
        S, (8 * n, 128), (n, 1), tile=(8, 128), fused_steps=2,
        devices=devices[:n])
    g0 = reference.random_padded(shc.spec, (8 * n, 128), seed=3)
    check("custom 3x3+spike k=2", shc, shc.spec, g0, 3)

    # 5) periodic torus: the ring exchange wraps
    spec = get_shape("star2d1r")
    interior = (8 * n, 128)
    g0p, it = _ghost(spec, reference.random_padded(spec, interior, seed=4),
                     interior)
    shp = engine("star2d1r", interior, (n, 1), tile=(8, 128), fused_steps=2,
                 boundary="periodic")
    report("periodic torus k=2",
           _rel(shp.run(g0p, 3)[it], reference.run_periodic(g0p, spec,
                                                            3)[it]), 1e-6)

    # 6) reflect (zero-flux) mirroring at the global edge
    shr = engine("star2d1r", interior, (n, 1), tile=(8, 128),
                 boundary="reflect")
    report("reflect", _rel(shr.run(g0p, 3)[it],
                           reference.run_reflect(g0p, spec, 3)[it]), 1e-6)

    # 7) overlapped exchange: >= 3x3 local tiles, so that the boundary-first
    #    region launches and the exchange under the inner window run
    if n % 2 == 0 and n >= 4:
        dx, dy = n // 2, 2
        interior = (24 * dx, 384 * dy)
        g0 = reference.random_padded(spec, interior, seed=5)
        sho = engine("star2d1r", interior, (dx, dy), tile=(8, 128),
                     fused_steps=2)
        assert sho._can_overlap(), "overlap config must exercise overlap"
        check(f"star2d1r {dx}x{dy} overlapped exchange k=2", sho, spec, g0,
              5)

    # 8) non-divisible global interior: block padding + bounds masking
    interior = (8 * n + 5, 130)
    g0 = reference.random_padded(spec, interior, seed=6)
    shn = engine("star2d1r", interior, (n, 1), tile=(8, 128), fused_steps=2)
    check("star2d1r non-divisible k=2", shn, spec, g0, 3)

    # 9b) z-axis decomposition: a (2, 2, 2) mesh with the z phase,
    #     divisible and non-divisible, fused
    if n >= 8:
        spec3 = get_shape("star3d1r")
        for tag, interior3, k in (("divisible", (8, 16, 256), 2),
                                  ("non-divisible", (7, 20, 200), 1)):
            g3 = reference.random_padded(spec3, interior3, seed=8)
            sh3z = engine("star3d1r", interior3, (2, 2, 2), tile=(8, 128),
                          fused_steps=k)
            assert sh3z.dz == 2
            check(f"star3d1r (2,2,2) z-sharded {tag} k={k}", sh3z, spec3,
                  g3, 3)

    # 9c) sharded df64: the fp64-grade state rides the same exchange
    if n % 2 == 0 and n >= 4:
        dx, dy = n // 2, 2
        interior = (16 * dx, 128 * dy)
        g0 = reference.random_padded(spec, interior, seed=9) * (
            np.pi / 100.0)  # a non-integer fill
        shd = engine("star2d1r", interior, (dx, dy), dtype="df64")
        report(f"df64 {dx}x{dy}", _rel(shd.run(g0, 3),
                                       reference.run(g0, spec, 3)), 1e-12)

    # 9c') sharded 1-D df64: the narrow pass over a 1-D mesh
    if n >= 4:
        spec1 = get_shape("1d2r")
        n1 = 1024 * 4
        g1 = reference.random_padded(spec1, (n1,), seed=11) * (
            np.pi / 100.0)
        shd1 = engine("1d2r", n1, (4,), dtype="df64", boundary="periodic")
        report("df64 (4,) 1-D periodic",
               _rel(shd1.run(g1, 3), reference.run_periodic(g1, spec1, 3)),
               1e-12)

    # 9c'') sharded 1-D df64 with a non-divisible ghost block: the true-tail
    #       strips and the wide pass
    if n >= 4:
        spec1 = get_shape("1d1r")
        n1 = 5000  # not divisible into lane-aligned blocks over 4
        g1p, it1 = _ghost(spec1, reference.random_padded(
            spec1, (n1,), seed=12) * (np.e / 100.0), (n1,))
        for boundary, truth in (("periodic", reference.run_periodic),
                                ("reflect", reference.run_reflect)):
            shd1t = engine("1d1r", n1, (4,), dtype="df64", boundary=boundary)
            assert not shd1t.lanes  # the wide (flat) tier
            report(f"df64 (4,) 1-D non-divisible {boundary}",
                   _rel(shd1t.run(g1p, 3)[it1], truth(g1p, spec1, 3)[it1]),
                   1e-12)

    # 9c''') sharded wide-radius 1-D df64 (r_eff > 32): the wide pass
    if n >= 4:
        wide = np.zeros(99)
        wide[0] = wide[-1] = 1.0
        wide[49] = -2.0
        shw = domain.sharded_engine_for_coeffs(wide, 8192, (4,), dtype="df64",
                                               devices=devices[:4])
        assert not shw.lanes
        gw = reference.random_padded(shw.spec, (8192,), seed=13) * 0.01
        report("df64 (4,) 1-D wide radius 49",
               _rel(shw.run(gw, 2), reference.run(gw, shw.spec, 2)), 1e-12)

    # 9d) sharded 3-D df64 over a (2, 2, 2) mesh with the z phase
    if n >= 8:
        spec3 = get_shape("box3d1r")
        interior3 = (8, 32, 256)
        g3 = reference.random_padded(spec3, interior3, seed=10) * (
            np.pi / 100.0)
        shd3 = engine("box3d1r", interior3, (2, 2, 2), dtype="df64")
        report("df64 (2,2,2) z-sharded",
               _rel(shd3.run(g3, 3), reference.run(g3, spec3, 3)), 1e-12)

    # 9) non-divisible periodic / reflect: the ghost ring anchors at the
    #    last shard's true tail inside its padded block
    if n % 2 == 0 and n >= 4:
        dx, dy = n // 2, 2
        interior = (24 * dx - 10, 128 * dy - 20)
        g0p, it = _ghost(spec, reference.random_padded(spec, interior,
                                                       seed=7), interior)
        for boundary, truth in (("periodic", reference.run_periodic),
                                ("reflect", reference.run_reflect)):
            shg = engine("star2d1r", interior, (dx, dy), tile=(8, 128),
                         boundary=boundary)
            report(f"non-divisible {boundary}",
                   _rel(shg.run(g0p, 3)[it], truth(g0p, spec, 3)[it]), 1e-6)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lorastencil_tpu_torch.parallel.dryrun")
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu",
                   help="cpu: CPU shards; cuda: every shard on cuda:0")
    args = p.parse_args(argv)
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    dryrun_multichip(args.n_devices, [dev] * args.n_devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
