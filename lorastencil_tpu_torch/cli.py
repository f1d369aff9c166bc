"""Command-line entry point of the port, with the JAX CLI's contract:

    python -m lorastencil_tpu_torch.cli <shape> <n> <steps> [options]
    python -m lorastencil_tpu_torch.cli <shape> <m> <n> <steps> [options]
    python -m lorastencil_tpu_torch.cli <shape> <h> <m> <n> <steps> [options]

Counterpart of ``lorastencil_tpu/cli.py``: the same positional arguments,
fill modes and ``--check`` (the port's fp64 ground truth,
``utils/reference.py``, of the ``--boundary`` given: ``run``,
``run_periodic`` or ``run_reflect``, compared in float64 at the JAX CLI's tolerance
per dtype relative to the grid's largest value: 1e-5 for float32, 1e-12
for float64, 1e-11 for df64), plus ``--device cuda|cpu``.  ``--dtype
float64`` and ``df64`` run the fp64-grade tier for 1-D, 2-D and 3-D
shapes.
On ``cuda`` the run is timed with CUDA events; ``cpu`` runs the kernels'
plain PyTorch twins and is not timed.  ``--mesh`` shards the grid over a
mesh (``parallel/domain.py``): ``dx`` for 1-D shapes, ``dx dy`` for 2-D,
``dx dy`` or ``dz dx dy`` for 3-D (a z-sharded mesh), one card per shard on
``cuda``, a CPU shard each on ``cpu``; ``--no-overlap`` turns the
overlapped exchange off.  The JAX CLI's flags and values the port does not
run yet are refused with the ROADMAP item that will port them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .models.shapes import ALL_SHAPES, get_shape
from .utils import reference

from . import engine
from .utils import metrics


def make_input(spec, interior, fill: str, seed: int = 0) -> np.ndarray:
    """The JAX CLI's fills: random integers (the reference's rand() %
    100), a row-major index ramp, or ones; halo zero except 'random'."""
    shape = spec.padded_shape(interior)
    if fill == "random":
        return reference.random_padded(spec, interior, seed=seed)
    grid = np.zeros(shape, dtype=np.float64)
    it = reference.interior_slices(spec, shape)
    if fill == "index":
        grid[it] = np.arange(int(np.prod(interior))).reshape(interior)
    else:  # ones
        grid[it] = 1.0
    return grid


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lorastencil_tpu_torch",
        description="low-rank stencils on PyTorch / CUDA")
    p.add_argument("shape", choices=sorted(ALL_SHAPES))
    p.add_argument("sizes", type=int, nargs="+",
                   help="interior sizes then steps")
    p.add_argument("--fill", choices=["random", "index", "ones"],
                   default="random")
    p.add_argument("--check", action="store_true",
                   help="verify against the fp64 ground truth")
    p.add_argument("--backend", choices=["auto", "pallas", "xla"],
                   default="auto",
                   help="auto/pallas: the CUDA kernel; xla: the plain "
                        "separable step")
    p.add_argument("--algorithm", choices=engine.ALGORITHM_NAMES,
                   default="auto",
                   help="2-D/3-D: auto, mxu_hybrid1, vpu_roll, vpu (2-D: and "
                        "mxu_hybrid) run "
                        "the one exact kernel of the dtype (df64 2-D: vpu, "
                        "vpu_roll, vpu_sep; df64 3-D: vpu_sep); 1-D: auto "
                        "(mxu) and vpu_roll the narrow kernels, the others "
                        "the wide; backend xla: every name, one plain "
                        "step")
    p.add_argument("--fused-steps", type=int, default=None,
                   help="steps per pass (1-D, 2-D; the JAX engine's rule "
                        "when unset)")
    p.add_argument("--precision", choices=["highest", "default"],
                   default="highest")
    p.add_argument("--dtype",
                   choices=["float32", "bfloat16", "float64", "df64"],
                   default="float32",
                   help="float64 and df64: native fp64 on the fp64 "
                        "instances of the kernels; bfloat16 (1-D, 2-D, "
                        "3-D): bf16 state, fp32 compute on the bf16 "
                        "instances")
    p.add_argument("--boundary",
                   choices=["dirichlet0", "periodic", "reflect"],
                   default="dirichlet0")
    p.add_argument("--tile", type=int, nargs=2, default=None)
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   metavar="D",
                   help="shard the grid over a mesh (1-D: dx; 2-D: dx dy; "
                        "3-D: dx dy or dz dx dy): one CUDA device per shard, "
                        "or CPU shards with --device cpu")
    p.add_argument("--no-overlap", action="store_true",
                   help="with --mesh: disable the overlapped exchange")
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="emit JSON metrics")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    spec = get_shape(args.shape)
    if len(args.sizes) != spec.ndim + 1:
        p.error(f"{args.shape} needs {spec.ndim} size(s) + steps, got "
                f"{len(args.sizes)} numbers")
    interior = tuple(args.sizes[: spec.ndim])
    steps = args.sizes[spec.ndim]
    if args.mesh is not None:
        return _run_sharded(p, args, spec, interior, steps)
    if args.autotune:
        p.error("--autotune is not ported yet (ROADMAP A12)")
    try:
        eng = engine.StencilEngine.for_shape(
            args.shape, interior, device=args.device,
            backend=args.backend, dtype=args.dtype,
            precision=args.precision, algorithm=args.algorithm,
            fused_steps=args.fused_steps,
            tile=tuple(args.tile) if args.tile else None,
            boundary=args.boundary)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        p.error(str(e))  # a config not ported yet or refused, or no CUDA
    print(f"INFO: shape = {spec.name}, sizes = {interior}, steps = "
          f"{steps}, device = {eng.device}", flush=True)
    grid0 = make_input(spec, interior, args.fill, args.seed)

    if eng.device.type == "cuda":
        secs, _ = metrics.time_run(
            lambda: eng.run_checksum(grid0, steps), repeats=args.repeats)
        res = metrics.bench_result(spec, interior, steps, secs,
                                   f"cuda-{eng.backend}", args.precision,
                                   args.repeats)
        print(res.human(), flush=True)
        if args.json:
            print(res.json(), flush=True)
    else:
        print("INFO: not timed (--device cpu runs the plain PyTorch "
              "twins; timing needs a CUDA device)", flush=True)
    if args.check:
        return _check(spec, grid0, steps, eng.run, args.dtype,
                      args.boundary)
    return 0


def _run_sharded(p, args, spec, interior, steps) -> int:
    """--mesh: domain decomposition over a mesh of shards, after the JAX
    CLI's ``_run_sharded`` (its checks and messages, in its order)."""
    import torch

    from .parallel import domain

    mesh_shape = tuple(args.mesh)
    # 1-D shapes: (dx); 2-D: (dx, dy); 3-D: (dx, dy) or (dz, dx, dy)
    want_axes = {1: (1,), 2: (2,), 3: (2, 3)}[spec.ndim]
    if len(mesh_shape) == 1 and spec.ndim > 1:
        mesh_shape = (mesh_shape[0], 1)
    if len(mesh_shape) not in want_axes:
        p.error(f"--mesh for {args.shape} needs "
                f"{' or '.join(map(str, want_axes))} integer(s), "
                f"got {len(args.mesh)}")
    if args.dtype == "float64":
        p.error("--mesh supports float32/bfloat16/df64 state (the fp64 "
                "tier is the single-process CPU regime)")
    if args.autotune:
        p.error("--autotune tunes the single-chip engine; pass --tile/"
                "--fused-steps explicitly with --mesh")
    n_need = int(np.prod(mesh_shape))
    if args.device == "cuda":
        n_have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_have < n_need:
            p.error(f"--mesh {mesh_shape} needs {n_need} devices, have "
                    f"{n_have} (--device cpu shards on the CPU)")
        devices = [f"cuda:{i}" for i in range(n_need)]
    else:
        devices = ["cpu"] * n_need
    sh_kw = dict(tile=tuple(args.tile) if args.tile else None,
                 dtype=args.dtype, precision=args.precision,
                 algorithm=args.algorithm, boundary=args.boundary,
                 overlap=not args.no_overlap)
    if args.fused_steps is not None:
        sh_kw["fused_steps"] = args.fused_steps
    try:
        eng = domain.sharded_engine(args.shape, interior, mesh_shape,
                                    devices=devices, **sh_kw)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        p.error(str(e))
    print(f"INFO: shape = {spec.name}, sizes = {interior}, steps = "
          f"{steps}, device = {args.device}", flush=True)
    print(f"INFO: mesh = {mesh_shape}, local interior = "
          f"{eng.local_interior}, overlapped exchange = "
          f"{eng._can_overlap()}", flush=True)
    grid0 = make_input(spec, interior, args.fill, args.seed)
    if args.device == "cuda":
        secs, _ = metrics.time_run(
            lambda: eng.run_checksum(grid0, steps), repeats=args.repeats)
        res = metrics.bench_result(spec, interior, steps, secs,
                                   f"cuda-mesh{mesh_shape}", args.precision,
                                   args.repeats)
        print(res.human(), flush=True)
        if args.json:
            print(res.json(), flush=True)
    else:
        print("INFO: not timed (--device cpu runs the plain PyTorch "
              "twins; timing needs a CUDA device)", flush=True)
    if args.check:
        return _check(spec, grid0, steps, eng.run, args.dtype,
                      args.boundary)
    return 0


# the JAX CLI's tolerances: fp32 compute against the fp64 ground truth, the
# fp64-grade tiers with headroom (the port runs both in native fp64), and the
# bf16 tier's storage rounding (~4e-3 a step)
TOLERANCE = {"float32": 1e-5, "float64": 1e-12, "df64": 1e-11,
             "bfloat16": 2e-2}


def _check(spec, grid0, steps, run_fn, dtype: str = "float32",
           boundary: str = "dirichlet0") -> int:
    """fp64 ground-truth comparison, in float64, at the JAX CLI's
    tolerance for ``dtype`` (``lorastencil_tpu/cli.py`` ``_check``),
    against the ground truth of ``boundary``."""
    print("\nChecking correctness ...", flush=True)
    if boundary == "periodic":
        want = reference.run_periodic(grid0, spec, steps)
    elif boundary == "reflect":
        want = reference.run_reflect(grid0, spec, steps)
    else:
        want = reference.run(grid0, spec, steps)
    got = run_fn(grid0, steps).cpu().double().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    # (bfloat16 has float32's exponent range)
    state = np.float64 if dtype in ("float64", "df64") else np.float32
    limit = float(np.finfo(state).max)
    if not np.isfinite(scale) or scale > limit:
        print(f"FAILED: ground truth reaches {scale:.2e}, beyond the "
              f"{dtype} range -- use fewer --check steps (values grow by "
              f"sum|coeffs| per step)")
        return 1
    diff = np.abs(got - want)
    rel = float(diff.max()) / scale
    tol = TOLERANCE[dtype]
    bad = np.argwhere(~(diff <= tol * scale))  # NaN counts as mismatch
    for idx in bad[:10]:
        print(f"mismatch at {tuple(int(i) for i in idx)}: "
              f"got {got[tuple(idx)]}, want {want[tuple(idx)]}")
    if len(bad):
        print(f"FAILED: {len(bad)} mismatches (max rel err {rel:.2e})")
        return 1
    print(f"Correct! (max rel err {rel:.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
