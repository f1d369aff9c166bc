#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Three paths, each through ``lorastencil_tpu_torch.engine.StencilEngine`` and
its hand-written CUDA kernels:

* 2-D, the JAX package's flagship (bench.py): star2d1r, fp32-exact,
  dirichlet0, 8192^2 interior, one step per pass, through
  ``csrc/stencil2d.cu`` (replacing
  ``lorastencil_tpu/ops/pallas_2d.py::_stencil2d_kernel``);
* 3-D, the reference artifact's 3-D configurations: star3d1r and box3d1r at
  256^3, two fused steps per pass (the engine's default), through
  ``csrc/stencil3d.cu`` (replacing
  ``lorastencil_tpu/ops/pallas_3d.py::_stencil3d_kernel``): every pass the
  march kernel, the general kernel held against it;
* 1-D, the reference artifact's 1-D configurations: 1d1r 4096 x 64 (all
  steps in one cooperative launch) and 1d2r 1,000,000 x 256 (passes of
  three fused steps), and 1d2r 16,777,216 x 256, through
  ``csrc/stencil1d.cu``, whose kernels replace the four TPU kernels of
  ``lorastencil_tpu/ops/pallas_1d.py``: the float32 narrow pass on
  ``lanes_kernel``, both runs on ``run_kernel`` (narrow and wide sums) and
  the wide pass on ``wide_kernel``, all redesigned for Hopper;
* the fp64-grade tier, dtypes 'df64' and 'float64': the float64 strip
  kernel of ``csrc/stencil2d.cu`` (every 2-D step at radius <= 4 and <= 3
  terms; the float64 tile kernel beyond: replacing
  ``pallas_df64._df64_kernel``), the float64 instances of
  ``csrc/stencil1d.cu`` (narrow pass, wide pass and narrow run, replacing
  the three kernels of ``lorastencil_tpu/ops/pallas_df64_1d.py``) and
  ``csrc/stencil3d.cu`` (replacing ``pallas_df64_3d._df64_3d_kernel``:
  star3d1r and box3d1r at 256^3, the JAX DF64 tier's 3-D rows), in native
  double where the TPU computes on error-free fp32 pairs;
* 2-D temporal fusion: star2d3r at 8192^2, the artifact's configuration
  whose engine default fuses two steps per pass, through the fused strip
  kernel, which serves both ``pallas_2d._stencil2d_kernel`` at k = 2 (the
  default, extent fusion) and ``pallas_2d._stencil2d_skew_kernel``
  (``fusion='skew'``) there, and one step per pass; the tile-based fused and
  skew kernels, which run every other fused or skewed pass; and the
  whole-grid runs, one cooperative launch for all steps (replacing
  ``pallas_2d._stencil2d_resident_kernel`` in float32 and
  ``pallas_df64._resident_pair_2d_kernel`` for df64), on by default on the
  card below the H100 caps: at 512^2 the shared-memory resident kernel of
  ``csrc/resident2d.cu`` (every registry shape), and for a radius-5 spec
  at 480^2 ``csrc/stencil2d.cu``'s resident kernel.
* the bfloat16 state tier in 2-D (dtype 'bfloat16': bf16 state, fp32
  compute): star2d1r 8192^2 through the bf16 strip kernel, star2d3r 8192^2
  through the bf16 fused strip kernel, and the bf16 instances of every
  other kernel of TPU kernels #1-#3 (tile, fused, skew, both resident
  runs); and the repaired wide 2-D radii (up to 128: the wide kernel) and
  3-D radius 0.

Phases, each printing one line or more and raising on failure:

1. the card (nvidia-smi name and power limit), torch and nvcc versions;
   the five sources built from the checkout (``csrc/stencil2d_bf16.cu``,
   ``stencil2d.cu``'s bf16 instances, apart), the nvcc runs started
   together;
2. the 2-D step (the strip kernel: float32, k = 1, radius <= 4) against its
   plain PyTorch twin on the card, for star2d1r and box2d1r at an interior
   the (32, 128) tile divides, one it does not, and 8192^2: integer fill bit
   for bit at 1 and 2 steps; the fill times pi/100 within rel 1e-6 after 4
   steps (the kernel fuses multiply-adds, the twin rounds each product),
   and bit for bit against the tile kernel it replaces at k = 1 (the same
   sums); a radius-5 step, which the tile kernel runs, against its twin;
3. the 2-D path end to end: ``run`` of 2 steps at 8192^2 equal bit for bit
   to a float64 dense stencil on the card (every partial sum is an integer
   below 2**24), with exactly 2 launches of the strip kernel counted from
   zero; a 256x384 grid at 4 steps within rel 1e-5 of the fp64 ground truth
   (the CLI's float32 tolerance);
4. 256 steps at 8192^2 timed with CUDA events (warmup, best of 3) through
   ``run_internal`` and through the naive dense stencil (GStencil/s counts
   star2d1r's x3 fuse factor); one ``F.conv2d`` with the dense 7x7
   coefficients (TF32 off) as the library yardstick, and the step's bound;
5. the 3-D kernel against its twin, for star3d1r and box3d1r at (6, 20,
   150), (37, 45, 130) (the (32, 64) tile divides neither plane axis) and
   256^3, at K = 1, 2 and 4 fused steps per pass: integer fill bit for bit
   after one and two passes; pi/100 fill within rel 1e-6 after 4 steps,
   printing whether it was bit-equal (every 3-D registry tap is a power of
   two, so the two should agree bit for bit on any fill); at K = 1 and 2
   the pass runs the march kernel (each launch counted), which must also
   equal the general kernel's pass bit for bit on both fills; K = 4 runs
   the general kernel;
6. the 3-D path end to end at 256^3 for both shapes: the engine resolves
   to 'vpu' at k = 2; ``run`` of 2 steps (1 launch) and of 3 steps (2
   launches: a pass of 2 and the remainder pass of 1), every launch the
   march kernel counted from zero, each bit for bit against a float64
   dense stencil on the card; a (24, 40, 200) grid at 4 steps within rel
   1e-5 of the fp64 ground truth;
7. 64 steps at 256^3 for both shapes through ``run_internal`` (32 march
   launches) and through the naive dense stencil; the march kernel's, the
   general kernel's and the twin's time per pass, in turns; one
   ``F.conv3d`` step with the dense 3x3x3 coefficients (TF32 off); the
   pass's bound;
8. each 1-D wrapper against its twin on the card: 1d1r and 1d2r at 4096,
   3001 (a ragged tile) and 1,000,000, and the wide kernels with
   ``for_coeffs`` taps of radius 40 and 127 at 100,000; passes at k = 1, the
   engine's default k and the largest legal k, resident runs over 2*refresh
   + 3 steps (two halo reloads and a tail); the integer fill bit for bit at
   1-2 steps and after one and two full passes, the pi/100 fill within rel
   1e-6 after 4 steps (the kernels round each product and sum on their own,
   in their twins' order, so both are bit for bit; the registry taps
   overflow fp32 to inf in the deepest wide passes, where the two agree
   too); then the two redesigned kernels against their twins and the
   kernels they replace, bit for bit on the integer, pi/100 and inf fills:
   ``lanes_kernel`` (each launch counted in ``launches_lanes``) one pass at
   k = 1, 3 and 32 // r_eff for 1d2r at 3001, 4096, 1,000,000 and
   16,777,216 and 1d1r up to 1,000,000, against ``pass_kernel<float>``;
   ``run_kernel`` (``launches_run``) over 1, 2 and 2m + 3 steps in float32
   and float64 for 1d1r at 4096 (also one block) and 3001, ``for_coeffs``
   r = 40 and 127 at 100,000 and 1d1r at the largest size under
   ``RESIDENT_BYTES`` (132 blocks), against the grid-synced
   ``resident_kernel``; the narrow run on ``run_kernel``'s narrow instances
   (``stencil1d_resident_lanes.launches_run``) the same way in float32
   and float64, also over 7 steps and under one block and four blocks of
   two-step phases, for 1d1r at 3001 and 4096, 1d2r at 4096, specs whose
   d cycle through every kind of the narrow plan at radius 5, 9 and 32 (4096)
   and 16 and 32 (65,536), and 1d1r at the largest size under
   ``RESIDENT_LANES_BYTES`` (132 blocks), against ``resident_kernel``
   reloading every ``lanes_refresh`` steps;
9. the 1-D path end to end, launches counted from zero: 1d1r 4096 resolves
   to 'mxu' and one resident launch per run (#7, ``run_kernel``'s narrow
   instance, counted in ``launches_run`` too);
   1d2r 1,000,000 and 16,777,216 to passes of the narrow kernel at k = 3
   (``run(.., 2)`` one remainder launch, ``run(.., 7)`` three), every one
   ``lanes_kernel``; algorithm 'vpu' to the wide counterparts (resident at
   4096, every run ``run_kernel``; passes of 2 at 1,000,000); 2 steps bit
   for bit against a float64 dense stencil on the card, 7 steps of the
   pi/100 fill within rel 1e-5;
10. 1d1r 4096 x 64, 1d2r 1,000,000 x 256 and 1d2r 16,777,216 x 256 through
   ``run_internal`` and through the naive dense stencil (GStencil/s with the
   x3 / x2 fuse factors); per kernel its device time per pass or run (a
   CUDA graph of back-to-back passes, so the host's launch cost is left
   out), its twin's, one ``F.conv1d`` step with the dense taps (TF32 off)
   and its bound; the wrapper's host time per launch with the device idle,
   and the device's idle share of the 1,000,000-cell run; the two
   redesigned kernels beside the kernels they replace, in turns:
   ``lanes_kernel``'s k = 3 pass at 1d2r 1,000,000 and 16,777,216 beside
   ``pass_kernel<float>``, and in each tile of ``LANES_TILES``;
   ``run_kernel``'s 1d1r 4096 x 64 runs, wide and narrow, in float32 and
   float64 beside ``resident_kernel``, with the per-step floor (the
   64-step run less the 1-step run) of both; and 64-step runs under plans
   around the H100 rule (``stencil1d.run_plan``), in both dtypes: wide at
   1d1r 2048 and 4096, r = 40 x 100,000 and the largest 1d1r grid under
   ``RESIDENT_BYTES``; narrow at 1d1r 4096, the radius-16 and radius-32
   specs at 65,536 and the largest 1d1r grid under
   ``RESIDENT_LANES_BYTES``, each beside ``resident_kernel``;
11. each fp64 kernel against its fp64 twin on the card: the 2-D float64
   strip kernel for star2d1r, box2d1r and box2d3r at 1000^2 and 8192^2,
   star2d3r at 1000^2 and star2d1r at 300 x 140 with a guard off the
   16-byte grid (8-byte copies), each step counted in ``launches_k1`` and
   bit for bit against the float64 tile kernel and the twin on the integer,
   pi/100 and inf fills; the 1-D instances
   for 1d1r and 1d2r at 4096, 3001 and 16,777,216 and ``for_coeffs`` taps
   of radius 40 and 127 at 100,000 (passes at k = 1, 2 and the largest k
   whose window fits shared memory in fp64, runs over 2*refresh + 3 steps
   where the grid's blocks can all be resident); the integer fill bit for
   bit at 1-2 steps, the pi/100 fill's relative error after 4 steps
   printed beside its limit 1e-13 (the fp64 kernels round each product
   and sum on their own, in their twins' order: it should be 0);
12. each fp64 engine path, for 'df64' and for 'float64', launches counted
   from zero over the phase: star2d1r 8192^2 and box2d3r 4096^2 (every
   step a float64 strip launch, counted in ``df64_step`` and
   ``stencil2d_k1``), 1d1r 4096 (the narrow run), 1d2r 16,777,216 (narrow passes,
   k = 1 in df64 and 2 in float64), ``for_coeffs`` r = 40 at 100,000 (wide
   passes) and, float64 only, at 3001 (the wide run); ``run(.., 2)`` of the
   integer fill bit for bit against a float64 dense stencil on the card,
   ``run(.., 4)`` of the pi/100 fill within rel 1e-13 of it; the float64
   wide run counted in ``launches_run`` too, the narrow run (#14) in
   ``stencil1d_resident_lanes.launches_run``, and no float64 pass on
   ``lanes_kernel``: #12 launches ``pass_kernel<double>``;
13. df64 star2d1r 8192^2 x 32, box2d3r 4096^2 x 32, 1d1r 4096 x 64 and
   1d2r 16,777,216 x 256 through ``run_internal`` and through the naive
   dense stencil in float64 (GStencil/s, vs_baseline; the 2-D runs' 32
   launches counted, every one a float64 strip launch); per fp64 kernel
   (the narrow run's: phase 10) its
   device time, its twin's, one float64 ``F.conv2d`` / ``F.conv1d`` step
   (the library yardstick) and its bound: 8-byte cells over the memory
   rate, or the operations over the card's fp64 CUDA-core rate; the 2-D
   step at star2d1r 8192^2 and box2d3r 4096^2, each beside the float64
   tile kernel it replaces, timed in turns;
14. the wrappers' fused (#1 at k = 2 and 3) and skewed (#2) passes against
   single-step launches of the 2-D kernel (bit for bit on any fill: they
   share its per-cell sums) and against their twins (the 0/1 fill bit for
   bit over k steps, the pi/100 fill within rel 1e-5 in float32 and 1e-13
   in float64 after 2k steps): star2d3r at 1000^2, 8192^2 and 300 x 140
   (k = 2: in float32 the fused strip kernel from both wrappers, every
   launch counted, also bit for bit against the tile-based fused and skew
   kernels it replaces), box2d1r at 1000^2 (k = 3), star2d1r at 300 x 140
   (ragged, two skew chunks), float32 and float64; the whole-grid runs
   (``stencil2d_resident``: the shared-memory resident kernel, each run
   counted in ``launches_smem``) in float32 (star2d1r, box2d3r at 512^2,
   star2d3r at 300 x 140) and float64 (star2d1r at 512^2, box2d3r at 300 x
   140), whose rectangles do not divide the grid evenly, bit for bit against
   single-step launches, ``csrc/stencil2d.cu``'s resident kernel and the
   twin (the integer fill at 1-2 steps; the pi/100
   fill at 4 steps within rel 1e-5 in float32 and 1e-13 in float64 of the
   fp64 ground truth);
15. each fused path end to end, launches counted from zero: star2d3r
   8192^2 with the defaults (extent, k = 2: 32 fused strip launches and no
   tile-based fused one), ``fusion='skew'`` (the same through the skew
   wrapper) and ``fused_steps=1``; star2d1r and box2d3r 512^2 and df64
   star2d1r 512^2 under the default caps (one shared-memory resident
   run), and a radius-5 spec (an 11 x 11 box of ones, one term) at 480^2 in
   float32 and df64 (one run of ``csrc/stencil2d.cu``'s resident kernel);
   ``run(.., 3)`` (2 at 512^2)
   of the integer fill bit for bit against a float64 dense stencil on the
   card,
   ``run(.., 4)`` of the pi/100 fill within rel 1e-5 (df64 1e-13), and 64
   steps that must launch 32 fused passes, 32 skewed passes, 64 steps, or
   one resident run, and no other kernel;
16. star2d3r 8192^2 x 64 through ``run_internal`` in the three modes and
   through the naive dense stencil; the k = 2 pass through each wrapper
   (the fused strip kernel), the tile-based fused and skew kernels it
   replaces and two strip steps, timed in turns, beside the twin's time,
   one ``F.conv2d`` 7x7 step (TF32 off) and the bound; the whole-grid
   runs: ``run_internal`` x 64, tiled against resident (CUDA events), for
   star2d1r and box2d3r at 256^2, 512^2, 1024^2 and the largest grid the
   kernel's capacity takes, float32 and df64, and from them the H100
   default caps (the largest internal buffer at which the resident run won
   at every measured size below it); the shared-memory resident kernel's
   64-step run at 512^2 (star2d1r, box2d3r, star2d3r, both dtypes), 1024^2
   and a 64 x 128 interior (one small rectangle per block: the handshake
   floor, the 64-step run less the 1-step run) beside
   ``csrc/stencil2d.cu``'s resident kernel, in turns (CUDA graphs);
   the radius-5 runs on ``csrc/stencil2d.cu``'s kernel;
17. the 3-D kernel's float64 instance against its float64 twin, for
   star3d1r and box3d1r at (37, 45, 130) and 256^3, K = 1 and 2 (the march
   kernel, each launch counted, bit for bit against the general kernel's
   pass on both fills): the integer fill bit for bit against the twin and
   a float64 dense stencil on the card after one and two passes, the
   pi/100 fill's relative error after 4 steps beside its limit 1e-13 (it
   should be 0: no FMA in fp64);
18. the 3-D fp64 engine paths at 256^3, launches of the float64 instance
   and of the march kernel counted from zero over the phase, every pass
   the march kernel: 'df64' ('vpu_sep', one step per pass) and 'float64'
   (passes of k = 2) for both shapes, ``run(.., 2)`` of the integer fill
   bit for bit against a float64 dense stencil on the card and ``run(..,
   4)`` of the pi/100 fill within rel 1e-13 of it;
19. df64 (64 launches) and float64 (32) 256^3 x 64 through
   ``run_internal`` and the naive dense stencil in float64; the march
   kernel's float64 device time per df64 pass beside the general kernel's
   and the twin's, and per float64 k = 2 pass beside two k = 1 passes and
   the general kernel's k = 2 pass (each set in turns); one float64
   ``F.conv3d`` 3x3x3 step and the pass's byte bound;
20. the kernels redesigned for Hopper, each with its registers and
   spills from ptxas (the strip kernel and its float64 counterpart, the
   fused strip kernel, the wide 1-D pass, the narrow 1-D pass, the wide
   1-D run, the 3-D march kernel, the shared-memory resident kernel, with
   its source's build time), failing
   on any spill: the 2-D strip kernel's step at star2d1r 8192^2 beside the
   tile kernel it replaces (timed in turns), its twin, ``F.conv2d``, its
   byte bound and its share of it; the float64 strip kernel's df64 steps
   at star2d1r 8192^2 and box2d3r 4096^2 beside the float64 tile kernel
   (phase 13) and their share of the byte bound; the march kernel's float32 k = 2, df64 and float64 k = 2 passes
   at 256^3 beside the general kernel (phases 7 and 19) and their share of
   the byte bound; the narrow pass (``lanes_kernel``, 1d2r 1,000,000 and
   16,777,216) and both runs (``run_kernel``, 1d1r 4096 x 64, wide and
   narrow, float32 and float64) beside the kernels they replace (phase 10),
   their bounds and
   shares of them; the wide 1-D pass at float64 r = 40 x 100,000 and
   float32 1d2r 1,000,000 (k = 2), and at float64 r = 40 x 16,777,216 (134
   MB a buffer), each beside one ``F.conv1d`` step, its bound and its
   share of it;
21. the ghost boundaries, periodic and reflect (ROADMAP A6(a)): each
   kernel that gained a bounds branch (the fused strip kernel, the tile
   kernel's fused levels in float32 and float64, the march kernel at K = 2
   in both dtypes, the general 3-D kernel at K = 4, ``lanes_kernel``,
   ``wide_kernel`` in both dtypes, ``pass_kernel<double>`` at k = 2), one
   pass with the engine's ghost bounds on a ring its refresh filled, bit
   for bit against its twin with the same bounds (the 0/1 fill) and within
   rel 1e-6 (float64 1e-13) of the float64 ground truth's k steps, each
   launch counted; then the ring paths through ``StencilEngine``'s default
   dispatch in both modes -- star2d1r 8192^2 x 256, star2d3r 8192^2 x 64
   (the fused strip kernel), star3d1r and box3d1r 256^3 x 64 (the march
   kernel at k = 2), 1d2r 16,777,216 x 256 (``lanes_kernel`` at k = 3),
   1d1r 4096 x 64 (``wide_kernel`` at k = 4: no run under a ghost
   boundary), df64 star2d1r 8192^2 x 32 and df64 1d2r 16,777,216 x 256 --
   ``run(.., 2)`` of the integer fill bit for bit against a float64 dense
   stencil with ``torch.roll`` wrap or a symmetric pad on the card and
   ``run(.., 4)`` of the pi/100 fill within rel 1e-5 (df64 1e-13),
   launches counted from zero (the path's kernel, no whole-grid run); the
   timed run beside the same run in dirichlet0 (its own default dispatch),
   in turns, and the ring refresh alone, per call, as a CUDA graph and
   eagerly; a ``{"ghost": [...]}`` line of the records;
22. custom coefficients and the adjoint (ROADMAP A6(b), A10): the arrays
   of ``custom_coeffs`` through ``StencilEngine.for_coeffs`` at 8192^2 and
   256^3 (``CUSTOM_CASES``: a non-symmetric 5x5 of 3 terms and 4 unpaired
   residue points at k = 1 and 2, heat5x5 at k = 2 and 1, the inverse
   source's 3x3, a 9x9 of rank 4, a separable-z and a per-plane 3-D
   array), float32 and df64, dirichlet0 and periodic (the 5x5 also
   reflect), each pass's kernel named by the wrappers' rules and checked
   against the expected one: the spec's dyadic twin (``dyadic``: taps
   +-1/2, +-1, the same plan) run(2) bit for bit against the engine run
   with the plain twins (``twins``) and a float64 dense stencil, the spec
   itself run(2) against the twins (df64 bit for bit, float32 rel 1e-5)
   and run(4) within rel 1e-5 (df64 1e-13) of the float64 dense stencil,
   launches counted from zero; the strip, fused strip and march kernels
   bit for bit against the tile and general kernels on the custom plans;
   the 5x5's whole-grid run at 512^2 (the shared-memory resident kernel)
   and its adjoint; the adjoint at 8192^2 in every mode, float32 and df64:
   the dot-product identity in float64 (1e-5, df64 1e-12), autograd
   through ``run_diff`` equal to ``run_vjp`` bit for bit, the adjoint's
   launches counted, a forward and a forward + backward timed with the
   backward's parts; 20 iterations of ``examples/torch_inverse_source.py``
   at 8192^2, the loss falling at every one; each custom kernel's pass
   timed beside its twin, a library step and its bound; a
   ``{"custom": ...}`` line of the records;
23. the bfloat16 state tier in 2-D (ROADMAP A6(c)) and the repairs C3 and
   C4: each bf16 instance of TPU kernels #1-#3 (``BF16_CHECKS``: the strip
   kernel at star2d1r and box2d3r 8192^2, the fused strip kernel from both
   wrappers and the tile-based fused and skew kernels at star2d3r 8192^2
   k = 2, the tile kernel's fused levels at k = 3 and on phase 22's 5x5,
   its step on a radius-5 spec, the skew kernel on star2d1r, the
   shared-memory resident kernel at 512^2 and ``csrc/stencil2d.cu``'s at
   480^2) bit for bit against its bf16 twin on the integer fill at 1-2
   passes, and on a uniform fill bit for bit against the float32 instance
   of the widened input, rounded to bf16 (within one bf16 ulp of the twin);
   each bf16 path through ``StencilEngine`` (``BF16_PATHS``) run(2) bit for
   bit against the engine with the plain twins and a counted run, launches
   from zero, only bf16 instances; star2d1r 8192^2 x 256 and star2d3r
   8192^2 x 64 timed in bf16 beside float32, in turns, each pass beside its
   bound at 2-byte cells and ``F.conv2d`` in bf16 and float32; every bf16
   instance's pass timed beside its twin, a bf16 library step and its
   bound; C3: ``for_coeffs`` crosses of radius 17 and 64 at 8192^2 in
   float32 and float64 (the tile kernel, its fused levels, the wide
   kernel) against the engine with the twins and a float64 dense stencil,
   the wide kernel timed; C4: the radius-0 3-D spec at 256^3 in float32,
   float64 and df64 under every boundary, bit for bit against a float64
   dense stencil on the card, the general kernel's pass timed;
24. the bfloat16 state tier in 1-D and 3-D (ROADMAP A6(c)): each bf16
   instance of TPU kernels #4-#8 (``BF16_CHECKS_1D3D``: the wide pass at
   1d2r 1,000,000 k = 2 and r = 40 x 100,000, the narrow pass at 1d2r
   16,777,216 k = 3 and 1d1r 1,000,000 k = 4, the narrow run at 1d1r 4096
   and 1d2r 1,000,000, the wide run at 1d1r 4096, the march kernel at
   star3d1r and box3d1r 256^3 k = 2, the general kernel at star3d1r 256^3 k
   = 4) bit for bit against its bf16 twin on the integer fill at 1-2 passes
   (and in 1-D, whose kernels round every operation as their twins do, on a
   uniform fill too), and on a uniform fill bit for bit against the float32
   instance run on the widened input and rounded as the rule says (a wide
   or 3-D pass once, a narrow pass every level, a run every step); each
   bf16 path through ``StencilEngine`` (``BF16_PATHS_1D3D``) run(2) bit for
   bit against the engine with the plain twins and a counted run, launches
   from zero, only bf16 instances; 1d2r 16,777,216 x 256, 1d2r 1,000,000 x
   256 (the narrow run the port takes there, beside the tiled passes the
   JAX engine takes), 1d1r 4096 x 64 and star3d1r / box3d1r 256^3 x 64 in
   bf16 beside float32, in turns; every bf16 instance's pass or run timed
   beside its float32 counterpart (in turns), its twin, a bf16
   ``F.conv1d`` / ``F.conv3d`` step and its bound at 2-byte cells;
25. the sharded 2-D engines (ROADMAP A11(a), ``parallel/domain.py``) on one
   card, every shard on ``cuda:0``, the strips swapped by device copies:
   each 2-D kernel's region launches (strip, fused strip, tile and its
   fused levels, wide; float32 and bf16) over the five windows of a 3 x 3
   split and a one-tile window with a shard's box, bit for bit against the
   twin with the same window, the cells outside it untouched; the flagship
   star2d1r 8192^2 x 256 float32 dirichlet0 over a (2, 2) mesh, with the
   overlapped exchange and without, bit for bit against the single-device
   engine and timed beside it in turns, launches and host microseconds a
   pass; a one-rank NCCL group through ``multihost`` (``run_replicated``
   bit for bit against the in-process run); each case of
   ``SHARDED_CASES`` (every region kernel in float32 and bf16, the
   non-divisible 8190 x 8191 under periodic and reflect on (2, 2) and
   (3, 3), box2d3r reflect on (4, 1), df64's ring-out step) counted from
   zero, bit for bit against the single-device engine at the same depth
   and within the tier's tolerance of a float64 dense stencil after 2
   steps, timed in turns; the bytes a shard exchanges a pass beside the
   NVLink 4 data sheet's 450 GB/s (a prediction: no strip crosses NVLink
   here); each region kernel's launch over its shard's inner window beside
   its twin, ``F.conv2d`` and its bound; a ``{"sharded": ...}`` line;
26. the sharded 1-D and 3-D engines (ROADMAP A11(b), A11(c)): the region
   kernels over random windows, ``SHARDED_ND_CASES`` against the
   single-device engine (each case's roofline share kept for phase 27), a
   one-rank NCCL group, the dry run on ``cuda:0``;
27. the last modules (ROADMAP B13, A12, A14): (a) every algorithm name B13
   accepted at star2d1r and star2d3r 8192^2 ('mxu' also star3d1r 256^3),
   run(2) bit for bit against 'mxu_hybrid1' on the integer fill at one
   step a pass, launches counted; (b) ``autotune_params`` in float32 in a
   fresh cache for ``AUTOTUNE_CASES``: every candidate's time and the
   winner, a second call from the cache with no launch, the tuned engine
   bit-exact against float64 at 2 steps and within rel 1e-5 after 4 (1-D
   7), timed in turns with the default engine, a cached 'skew' winner taken
   by ``fusion='auto'``; (c) ``profiling.probe_ceilings`` beside
   ``MEASURED``, the flagship's and phase 26's rows' share of their
   governing roofline bound, a ``profiling.trace`` of 8 flagship steps
   naming the strip kernel and its share of the device time; (d)
   ``checkpoint.run_with_checkpoints`` at star2d1r 8192^2 x 64 every 16,
   resumed from step 32 bit for bit, and ``ShardedCheckpointer`` over (2, 2)
   shards of the card, saved at step 32, restored and continued bit for
   bit, a snapshot's ms and bytes; (e) ``examples/torch_heat_diffusion.py``
   on the card printing what it prints on the CPU; (f) TPU kernel #11's
   radius-0 float64 instance timed at 256^3 beside its bound and a float64
   ``F.conv3d`` 1x1x1 step;
28. the plan strip and plan march kernels (``csrc/plan2d.cu``,
   ``csrc/plan3d.cu``, the redesigns of ``step_kernel`` and
   ``stencil3d_kernel``): their ptxas lines, failing on a spill; (a) each on
   its own entry in every dtype and depth it takes (``plan_check_cases``)
   bit for bit against its twin (0/1 fill, dyadic taps, two passes; float64
   the pi/100 fill too) and against the kernel it replaces (pi/100 fill),
   under a ring box and over a window; (b) ``PLAN_CASES`` through
   StencilEngine with their launches counted from zero on the kernel the
   routing rules name, the dyadic twin's run bit for bit against the
   twins', and the main path's routes unchanged (star2d1r 8192^2 x 256:
   256 strip launches, star2d3r x 64: 32 fused strip launches, star3d1r and
   box3d1r 256^3 x 64: 32 march launches, none of a plan kernel); (c) every
   case of ``PLAN_CASES`` timed at full size on its plan kernel beside the
   kernel it replaces (and k strip launches where the strip kernel takes
   the spec's steps: the routing rule ``stencil2d.strips_beat_plan``), its
   twin, one cuDNN step and its bound, and phase 25's tile case over its
   shard's inner window; (d) each case of (c) that runs k strip launches,
   under a periodic ring: through StencilEngine, counted (2k strip launches
   in run(2k), none of a plan kernel) and bit for bit against the twins'
   fused run on the dyadic 0/1 fill, then one pass timed on the plan strip
   kernel with the ring's box beside k strip launches with the ring
   refresh between them and beside the wrapper's pass, in turns;
29. the strip walk past the plan strip kernel's first reach (the plan strip
   kernel at depth 4 and radius 5-8, ``stencil2d_skew_step`` on the walk:
   the redesigns of ``skew_kernel`` and of ``step_kernel`` there): the
   ptxas lines, failing on a spill; (a) each new instance on its own entry
   (``REACH_CHECKS``) against its twin and ``step_kernel``, under a ring box
   and over a window, and each skewed pass (``REACH_SKEW_CHECKS``) against
   ``skew_kernel`` and the twin; (b) ``REACH_CASES`` through StencilEngine,
   their launches counted from zero (none of ``step_kernel`` or
   ``skew_kernel`` but where ``stencil2d.tile_beats_plan`` keeps them),
   bit for bit against the twins' run; (c) each case timed at full size
   beside the kernel it replaces, its twin, one cuDNN step and its bound,
   and region launches over a shard's inner window; (d) one radius-5 and
   one 17x17 step at 1024^2-8192^2 on the plan strip and the tile kernel.

It then prints the kernels' JSON record and, last, the device record.  It
needs one CUDA device and exits non-zero without one.  Neither JAX nor any
part of ``lorastencil_tpu`` is imported: the port carries its own stencil
registry and fp64 ground truth, and the script fails if either package
was loaded.
"""

import concurrent.futures
import functools
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from lorastencil_tpu_torch.utils import profiling

# the data-sheet peaks and the least-time model of a pass, shared with the
# port's roofline (its ``utils/profiling.py``)
from lorastencil_tpu_torch.utils.profiling import (  # noqa: F401
    PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, PEAK_FP64_FLOPS, bound_ms, bound_parts,
    step_flops, sum_ops)

INTERIOR = (8192, 8192)
BENCH_STEPS = 256
INTERIOR_3D = (256, 256, 256)
BENCH_STEPS_3D = 64
SOURCES = {"stencil2d": "lorastencil_tpu_torch/csrc/stencil2d.cu",
           "stencil2d_bf16": "lorastencil_tpu_torch/csrc/stencil2d_bf16.cu",
           "stencil3d": "lorastencil_tpu_torch/csrc/stencil3d.cu",
           "stencil3d_bf16": "lorastencil_tpu_torch/csrc/stencil3d_bf16.cu",
           "stencil1d": "lorastencil_tpu_torch/csrc/stencil1d.cu",
           "stencil1d_bf16": "lorastencil_tpu_torch/csrc/stencil1d_bf16.cu",
           "resident2d": "lorastencil_tpu_torch/csrc/resident2d.cu",
           "plan2d": "lorastencil_tpu_torch/csrc/plan2d.cu",
           "plan2d_bf16": "lorastencil_tpu_torch/csrc/plan2d_bf16.cu",
           "plan3d": "lorastencil_tpu_torch/csrc/plan3d.cu",
           "plan3d_bf16": "lorastencil_tpu_torch/csrc/plan3d_bf16.cu"}
REPLACES = {"stencil2d": "lorastencil_tpu/ops/pallas_2d.py:127",
            "stencil2d_skew": "lorastencil_tpu/ops/pallas_2d.py:686",
            "stencil2d_resident": "lorastencil_tpu/ops/pallas_2d.py:981",
            "stencil2d_resident_pair": "lorastencil_tpu/ops/pallas_df64.py:609",
            "df64_step": "lorastencil_tpu/ops/pallas_df64.py:419",
            "df64_1d_step": "lorastencil_tpu/ops/pallas_df64_1d.py:135",
            "df64_1d_flat_step": "lorastencil_tpu/ops/pallas_df64_1d.py:312",
            "stencil1d_resident_pair":
                "lorastencil_tpu/ops/pallas_df64_1d.py:475",
            "df64_3d_step": "lorastencil_tpu/ops/pallas_df64_3d.py:276",
            "stencil3d": "lorastencil_tpu/ops/pallas_3d.py:118",
            "stencil1d_lanes_step": "lorastencil_tpu/ops/pallas_1d.py:348",
            "stencil1d_step": "lorastencil_tpu/ops/pallas_1d.py:97",
            "stencil1d_resident_lanes": "lorastencil_tpu/ops/pallas_1d.py:600",
            "stencil1d_resident": "lorastencil_tpu/ops/pallas_1d.py:542"}
KERNELS_1D = ("stencil1d_lanes_step", "stencil1d_step",
              "stencil1d_resident_lanes", "stencil1d_resident")
# the JAX df64 kernels -> the port's wrapper whose float64 instance replaces
# each (a wrapper counts its float32 and float64 launches apart)
KERNELS_FP64_1D = {"df64_1d_step": "stencil1d_lanes_step",
                   "df64_1d_flat_step": "stencil1d_step",
                   "stencil1d_resident_pair": "stencil1d_resident_lanes"}
KERNELS_FP64 = ("df64_step",) + tuple(KERNELS_FP64_1D)
N_1D = 1_000_000
N_1D_LARGE = 16_777_216
N_1D_SMALL = 4096
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _counters():
    """{kernel: (wrapper, the attribute that counts its launches)}: float32
    instances count in ``launches``, float64 ones in ``launches_f64`` (the
    wide run's float64 instance, which replaces no df64 kernel, as
    "stencil1d_resident_f64"; the 2-D resident run's float64 instance as
    "stencil2d_resident_pair", the kernel it replaces; the shared-memory
    resident kernel's runs, in either dtype, in "stencil2d_resident_smem"
    too; the 1-D kernels redesigned for Hopper, lanes_kernel's float32
    narrow passes in "stencil1d_lanes", run_kernel's wide runs, in either
    dtype, in "stencil1d_run", and its narrow runs, in either dtype, in
    "stencil1d_lanes_run", beside their wrapper's count).  The fused 2-D
    kernel counts with the step kernel it extends, as "stencil2d"; the
    strip kernels' steps count in "stencil2d_k1" too, beside "stencil2d"
    (float32) or "df64_step" (float64); the fused strip kernel's passes in
    the wrapper's own
    count and in "stencil2d_fused_strip" (from ``stencil2d_step``) or
    "stencil2d_skew_fused_strip" (from ``stencil2d_skew_step``); the 3-D
    march kernel's passes in "stencil3d" (float32) or "df64_3d_step"
    (float64) and in "stencil3d_march"."""
    from lorastencil_tpu_torch.ops import stencil1d, stencil2d, stencil3d

    out = {"stencil2d": (stencil2d.stencil2d_step, "launches"),
           "stencil2d_k1": (stencil2d.stencil2d_step, "launches_k1"),
           "stencil2d_fused_strip": (stencil2d.stencil2d_step,
                                     "launches_fused_strip"),
           "stencil2d_skew_fused_strip": (stencil2d.stencil2d_skew_step,
                                          "launches_fused_strip"),
           "stencil3d": (stencil3d.stencil3d_step, "launches"),
           "df64_3d_step": (stencil3d.stencil3d_step, "launches_f64"),
           "stencil3d_march": (stencil3d.stencil3d_step, "launches_march"),
           # the plan strip and plan march kernels (csrc/plan2d.cu,
           # csrc/plan3d.cu), of any dtype
           "stencil2d_plan_strip": (stencil2d.stencil2d_step,
                                    "launches_plan_strip"),
           "stencil3d_plan_march": (stencil3d.stencil3d_step,
                                    "launches_plan_march"),
           # the tile kernels' launches (step_kernel from stencil2d_step,
           # skew_kernel from stencil2d_skew_step), and the strip walk's
           # launches of a skewed pass, in any dtype
           "stencil2d_tile": (stencil2d.stencil2d_step, "launches_tile"),
           "stencil2d_skew_tile": (stencil2d.stencil2d_skew_step,
                                   "launches_tile"),
           "stencil2d_skew_k1": (stencil2d.stencil2d_skew_step,
                                 "launches_k1"),
           "stencil2d_skew_plan_strip": (stencil2d.stencil2d_skew_step,
                                         "launches_plan_strip"),
           "df64_step": (stencil2d.stencil2d_step, "launches_f64"),
           "stencil2d_skew": (stencil2d.stencil2d_skew_step, "launches"),
           "stencil2d_skew_f64": (stencil2d.stencil2d_skew_step,
                                  "launches_f64"),
           "stencil2d_resident": (stencil2d.stencil2d_resident, "launches"),
           "stencil2d_resident_pair": (stencil2d.stencil2d_resident,
                                       "launches_f64"),
           "stencil2d_resident_smem": (stencil2d.stencil2d_resident,
                                       "launches_smem"),
           "stencil1d_resident_f64": (stencil1d.stencil1d_resident,
                                      "launches_f64"),
           "stencil1d_lanes": (stencil1d.stencil1d_lanes_step,
                               "launches_lanes"),
           "stencil1d_run": (stencil1d.stencil1d_resident, "launches_run"),
           "stencil1d_lanes_run": (stencil1d.stencil1d_resident_lanes,
                                   "launches_run"),
           # the bfloat16 instances (ROADMAP A6(c)) and the wide kernel (C3)
           "stencil2d_bf16": (stencil2d.stencil2d_step, "launches_bf16"),
           "stencil2d_skew_bf16": (stencil2d.stencil2d_skew_step,
                                   "launches_bf16"),
           "stencil2d_resident_bf16": (stencil2d.stencil2d_resident,
                                       "launches_bf16"),
           "stencil2d_wide": (stencil2d.stencil2d_step, "launches_wide"),
           # stencil2d_step's launches over a region (ROADMAP A11(a))
           "stencil2d_region": (stencil2d.stencil2d_step, "launches_region"),
           # ... and in 1-D and 3-D (each wrapper's launches_bf16)
           "stencil1d_lanes_step_bf16": (stencil1d.stencil1d_lanes_step,
                                         "launches_bf16"),
           "stencil1d_step_bf16": (stencil1d.stencil1d_step,
                                   "launches_bf16"),
           "stencil1d_resident_lanes_bf16": (
               stencil1d.stencil1d_resident_lanes, "launches_bf16"),
           "stencil1d_resident_bf16": (stencil1d.stencil1d_resident,
                                       "launches_bf16"),
           "stencil3d_bf16": (stencil3d.stencil3d_step, "launches_bf16"),
           # the 1-D and 3-D pass wrappers' launches over a region (ROADMAP
           # A11(b), A11(c))
           "stencil1d_region": (stencil1d.stencil1d_step, "launches_region"),
           "stencil1d_lanes_region": (stencil1d.stencil1d_lanes_step,
                                      "launches_region"),
           "stencil3d_region": (stencil3d.stencil3d_step, "launches_region")}
    out.update({name: (getattr(stencil1d, name), "launches")
                for name in KERNELS_1D})
    out.update({name: (getattr(stencil1d, wrapper), "launches_f64")
                for name, wrapper in KERNELS_FP64_1D.items()})
    return out


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def build_kernels():
    """Phase 1's builds, the nvcc runs at once; returns {name: (seconds,
    ptxas register lines, the compiler's log)}."""
    from lorastencil_tpu_torch.ops import _cuda_build

    def one(name):
        t0 = time.perf_counter()
        lib = _cuda_build.build(name)
        secs = time.perf_counter() - t0
        with open(lib + ".log") as f:
            log = f.read().splitlines()
        ptxas = [ln.strip() for ln in log if "registers" in ln
                 or "spill" in ln]
        return secs, ptxas, log

    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futs = {name: pool.submit(one, name) for name in SOURCES}
        return {name: fut.result() for name, fut in futs.items()}


def port_layout(spec, interior):
    from lorastencil_tpu_torch.ops.layout import (Layout2D, default_tile_2d,
                                                  guard_2d)

    return Layout2D(interior=interior, halo=spec.halo,
                    tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, spec.radius))


def port_layout_3d(spec, interior, K):
    from lorastencil_tpu_torch.ops.layout import (Layout3D, default_tile_3d,
                                                  guard_3d)

    return Layout3D(interior=interior, halo=spec.halo,
                    tile=default_tile_3d(*interior[1:]),
                    guard=guard_3d(spec.halo, K * spec.radius))


def run_steps(step, x, spec, lay, steps, k=1):
    """``steps`` timesteps of a kernel wrapper or its twin in passes of
    ``k``, with the engine's donor rotation."""
    from lorastencil_tpu_torch.engine import ping_pong_loop

    def one(cur, donor, depth):
        kw = {"fused_steps": depth} if depth > 1 else {}
        return step(cur, donor, spec, lay, **kw)

    return ping_pong_loop(one, x, steps, k)


def check_kernel(name, interior, device):
    """Phase 2 for one shape and size; returns the max abs and rel errors
    of the pi/100 fill after 1 and 4 steps.  The step runs the strip kernel,
    which must also equal the tile kernel's step bit for bit."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = port_layout(spec, interior)
    g0 = reference.random_padded(spec, interior, seed=1)
    x = lay.to_internal(g0, device=device)
    for steps in (1, 2):
        got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
        want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(
                f"{name} {interior}: kernel differs from its twin at "
                f"{bad} cells after {steps} steps (integer fill)")
    x = lay.to_internal(g0 * (np.pi / 100), device=device)
    if not stencil2d.strip_takes(spec, x.dtype):
        raise AssertionError(f"{name}: the step does not take the strip kernel")
    tile = torch.zeros_like(x)
    stencil2d._launch("step", (x, tile), spec, lay, 1)
    strip = stencil2d.stencil2d_step(x, torch.zeros_like(x), spec, lay)
    torch.cuda.synchronize()
    if not torch.equal(strip, tile):
        bad = (strip != tile).sum().item()
        raise AssertionError(f"{name} {interior}: the strip kernel differs "
                             f"from the tile kernel at {bad} cells (pi/100)")
    del tile, strip
    errs = {}
    for steps in (1, 4):
        got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
        want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {interior}: non-finite output")
        abs_err = (got - want).abs().max().item()
        rel = abs_err / want.abs().max().item()
        errs[steps] = (abs_err, rel)
    if errs[4][1] > 1e-6:
        raise AssertionError(
            f"{name} {interior}: rel err {errs[4][1]:.3e} > 1e-6 after 4 "
            f"steps (pi/100 fill)")
    return errs


def check_wide_radius(device):
    """Phase 2: a radius-5 step (beyond the strip kernel's radii: the plan
    strip kernel's radius-5 instance, which replaced the tile kernel there)
    against its twin on the integer fill at 1-2 steps; returns its launches
    (1 per step, none of the strip kernel or the tile kernel)."""
    from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec
    from lorastencil_tpu_torch.ops import stencil2d
    from lorastencil_tpu_torch.utils import reference

    ones = (1.0,) * 11
    spec = StencilSpec(name="box2d5r", ndim=2, radius=5, halo=(5, 5),
                       terms=(SeparableTerm(taps=(ones, ones)),),
                       residue=(((0, 5), 1.0), ((-5, -2), -1.0)),
                       fuse_factor=1)
    interior = (300, 140)
    lay = port_layout(spec, interior)
    x = lay.to_internal(reference.random_padded(spec, interior, seed=4),
                        device=device)
    reset_counts()
    for steps in (1, 2):
        got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
        want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay, steps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"radius 5 {interior}: the plan strip "
                                 f"kernel differs from its twin after "
                                 f"{steps} steps")
    launched = counts()
    if (launched["stencil2d"], launched["stencil2d_k1"],
            launched["stencil2d_plan_strip"],
            launched["stencil2d_tile"]) != (3, 0, 3, 0):
        raise AssertionError(f"radius 5 steps launched {launched}")
    return launched["stencil2d"]


def time_calls(fns, x, donor, calls):
    """Per-call device ms of each ``fn(x, donor)`` in ``fns`` (a dict),
    timed in turns fns..., then the same again reversed, best of the
    two."""
    from lorastencil_tpu_torch.utils import metrics

    def loop(fn):
        for _ in range(calls):
            fn(x, donor)

    order = list(fns) + list(reversed(list(fns)))
    ms = {}
    for name in order:
        secs, _ = metrics.time_run(loop, fns[name], repeats=3, warmup=1)
        ms[name] = min(ms.get(name, float("inf")), secs / calls * 1e3)
    return ms


def time_step(spec, lay, device, calls=20):
    """Per-call device ms of the 2-D step (the strip kernel), of the tile
    kernel it replaces at k = 1 and of its plain twin, one step each, at the
    layout's shape (uniform [0, 0.01) fill), timed in turns."""
    from lorastencil_tpu_torch.ops import stencil2d

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(lay.shape, generator=gen, device=device) * 0.01
    ms = time_calls({
        "plain": lambda a, b: stencil2d.stencil2d_step_plain(a, b, spec,
                                                             lay),
        "kernel": lambda a, b: stencil2d.stencil2d_step(a, b, spec, lay),
        "tile": lambda a, b: stencil2d._launch("step", (a, b), spec, lay,
                                               1)},
        x, torch.zeros_like(x), calls)
    return ms["kernel"], ms["plain"], ms["tile"]


def main_path(device):
    """Phase 3: the 2-D path end to end at 8192^2; returns the launch
    counts of ``run`` and the small grid's rel err."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape("star2d1r")
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device=device)
    if eng.algorithm != "mxu_hybrid1" or eng.backend != "pallas":
        raise AssertionError(f"main path resolved to {eng.algorithm}/"
                             f"{eng.backend}")
    g0 = reference.random_padded(spec, INTERIOR, seed=0)
    want = torch.from_numpy(g0).to(device)  # float64
    for _ in range(2):
        want = torch_ref.dense_step(want, spec)
    reset_counts()
    out = eng.run(g0, 2)
    torch.cuda.synchronize()
    launches = counts()
    if (launches["stencil2d"], launches["stencil2d_k1"]) != (2, 2):
        raise AssertionError(f"2-D path launched its kernel "
                             f"{launches['stencil2d']} times, the strip "
                             f"kernel {launches['stencil2d_k1']}, for 2 "
                             f"steps")
    if tuple(out.shape) != spec.padded_shape(INTERIOR):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("main path output is not finite")
    if not torch.equal(out.double(), want):
        bad = (out.double() != want).sum().item()
        raise AssertionError(
            f"main path differs from the float64 dense stencil at {bad} "
            f"cells after 2 steps")
    del want, out

    small = (256, 384)
    g1 = reference.random_padded(spec, small, seed=2)
    want = reference.run(g1, spec, 4)
    got = engine.StencilEngine.for_shape(
        "star2d1r", small, device=device).run(g1, 4)
    rel = (np.abs(got.cpu().numpy().astype(np.float64) - want).max()
           / np.abs(want).max())
    if not rel <= 1e-5:
        raise AssertionError(f"256x384 x4: rel err {rel:.3e} > 1e-5")
    return launches, rel


def count_run(eng, state, steps, kernel, expect):
    """Launches of ``kernel`` in one untimed ``run_internal`` of ``steps``
    steps, counted from zero; raises unless it is ``expect``."""
    reset_counts()
    eng.run_internal(state, steps)
    torch.cuda.synchronize()
    got = counts()[kernel]
    if got != expect:
        raise AssertionError(f"{steps} steps launched {kernel} {got} times,"
                             f" expected {expect}")
    return got


def library_ms(spec, interior, device, dtype=torch.float32, repeats=3):
    """One cuDNN convolution with the dense coefficients (TF32 off) on
    the interior and a radius-deep margin, in ``dtype``: one step of the
    same function (cross-correlation, as the stencil is), best of
    ``repeats`` after a warmup.  The port never calls it."""
    import torch.nn.functional as F

    from lorastencil_tpu_torch.utils import metrics

    r = spec.radius
    w = torch.tensor(spec.dense_coeffs(), dtype=dtype, device=device)[None,
                                                                      None]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, 1) + tuple(s + 2 * r for s in interior),
                   generator=gen, device=device, dtype=dtype) * 0.01
    conv = F.conv3d if spec.ndim == 3 else F.conv2d
    secs, out = metrics.time_run(lambda: conv(x, w), repeats=repeats,
                                 warmup=1)
    if tuple(out.shape[2:]) != tuple(interior):
        raise AssertionError(f"library conv gave {tuple(out.shape)}")
    return secs * 1e3


def bench(device, card):
    """Phase 4: 2-D kernel path and naive dense stencil, 256 steps each.
    Values grow 100x per step and overflow to inf/NaN after ~20 steps of
    the [0, 0.01) fill; fp32 arithmetic on inf/NaN runs at the same speed
    on this card, so the times stand (correctness is phases 2-3)."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import metrics

    spec = get_shape("star2d1r")
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = torch.rand(eng.layout.shape, generator=gen,
                       device=device) * 0.01
    secs, _ = metrics.time_run(eng.run_internal, state, BENCH_STEPS,
                               repeats=3, warmup=1)
    res = metrics.bench_result(spec, INTERIOR, BENCH_STEPS, secs,
                               "cuda-stencil2d", "fp32-exact", 3)
    launches = count_run(eng, state, BENCH_STEPS, "stencil2d", BENCH_STEPS)
    del state
    grid = torch.rand(spec.padded_shape(INTERIOR), generator=gen,
                      device=device) * 0.01

    def naive(g):
        for _ in range(BENCH_STEPS):
            g = torch_ref.dense_step(g, spec)
        return g

    bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
    base = metrics.bench_result(spec, INTERIOR, BENCH_STEPS, bsecs,
                                "torch-naive", "fp32", 3)
    for label, r in (("kernel", res), ("naive", base)):
        print(f"phase 4: {label} star2d1r {INTERIOR[0]}x{INTERIOR[1]} "
              f"x{BENCH_STEPS}: {r.time_ms} ms, {r.gstencil_per_s} "
              f"GStencil/s (x3 fused) [{card}]", flush=True)
    print(f"phase 4: vs_baseline {res.gstencil_per_s / base.gstencil_per_s}"
          f"; {launches} launches per {BENCH_STEPS}-step run [{card}]",
          flush=True)
    return res, base


def general_3d(x, spec, lay, K, out=None):
    """One pass of the general 3-D kernel (``stencil3d_kernel``), which the
    march kernel replaces at K <= 2: the launch ``stencil3d_step`` makes for
    a pass ``march_takes`` refuses."""
    from lorastencil_tpu_torch.ops import stencil3d

    out = torch.zeros_like(x) if out is None else out
    return stencil3d._launch(x, out, spec, lay, K, stencil3d.plan_pass(
        spec, K, x.element_size())[1])


def check_kernel_3d(name, interior, K, device):
    """Phase 5 for one shape, size and depth; returns (abs err, rel err,
    bit-equal) of the pi/100 fill after 4 steps.  At K <= 2 the pass runs
    the march kernel, which must also equal the general kernel's pass bit
    for bit on both fills."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil3d
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = port_layout_3d(spec, interior, K)
    g0 = reference.random_padded(spec, interior, seed=1)
    x = lay.to_internal(g0, device=device)
    march = stencil3d.march_takes(spec, torch.float32, K)
    for passes in (1, 2):
        before = stencil3d.stencil3d_step.launches_march
        got = run_steps(stencil3d.stencil3d_step, x, spec, lay, passes * K, K)
        if stencil3d.stencil3d_step.launches_march - before != (
                passes if march else 0):
            raise AssertionError(f"{name} {interior} K={K}: march launches")
        want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay,
                         passes * K, K)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(
                f"{name} {interior} K={K}: kernel differs from its twin at "
                f"{bad} cells after {passes} passes (integer fill)")
    for fill in ((g0, g0 * (np.pi / 100)) if march else ()):
        x1 = lay.to_internal(fill, device=device)
        got = stencil3d.stencil3d_step(x1, torch.zeros_like(x1), spec, lay,
                                       fused_steps=K)
        if not torch.equal(got, general_3d(x1, spec, lay, K)):
            raise AssertionError(f"{name} {interior} K={K}: the march kernel "
                                 f"differs from the general kernel")
    x = lay.to_internal(g0 * (np.pi / 100), device=device)
    got = run_steps(stencil3d.stencil3d_step, x, spec, lay, 4, K)
    want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay, 4, K)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {interior} K={K}: non-finite output")
    abs_err = (got - want).abs().max().item()
    rel = abs_err / want.abs().max().item()
    if rel > 1e-6:
        raise AssertionError(
            f"{name} {interior} K={K}: rel err {rel:.3e} > 1e-6 after 4 "
            f"steps (pi/100 fill)")
    return abs_err, rel, bool(torch.equal(got, want))


def main_path_3d(name, device):
    """Phase 6 for one shape: returns the launch counts of ``run`` at 2
    and 3 steps and the small grid's rel err."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    eng = engine.StencilEngine.for_shape(name, INTERIOR_3D, device=device)
    if (eng.algorithm, eng.backend, eng._fused_k()) != ("vpu", "pallas", 2):
        raise AssertionError(
            f"{name} resolved to {eng.algorithm}/{eng.backend} at "
            f"k={eng._fused_k()}")
    g0 = reference.random_padded(spec, INTERIOR_3D, seed=0)
    want = torch_ref.dense_step(torch.from_numpy(g0).to(device), spec)
    launches = {}
    for steps, expect in ((2, 1), (3, 2)):
        want = torch_ref.dense_step(want, spec)  # float64, `steps` steps
        reset_counts()
        out = eng.run(g0, steps)
        torch.cuda.synchronize()
        launches[steps] = counts()
        if (launches[steps]["stencil3d"],
                launches[steps]["stencil3d_march"]) != (expect, expect):
            raise AssertionError(
                f"{name}: run({steps}) launched the 3-D kernel "
                f"{launches[steps]['stencil3d']} times, the march kernel "
                f"{launches[steps]['stencil3d_march']}, expected {expect}")
        if tuple(out.shape) != spec.padded_shape(INTERIOR_3D):
            raise AssertionError(f"{name}: output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output is not finite")
        if not torch.equal(out.double(), want):
            bad = (out.double() != want).sum().item()
            raise AssertionError(
                f"{name}: run({steps}) differs from the float64 dense "
                f"stencil at {bad} cells")
        del out
    del want

    small = (24, 40, 200)
    g1 = reference.random_padded(spec, small, seed=2)
    want = reference.run(g1, spec, 4)
    got = engine.StencilEngine.for_shape(name, small, device=device).run(g1,
                                                                         4)
    rel = (np.abs(got.cpu().numpy().astype(np.float64) - want).max()
           / np.abs(want).max())
    if not rel <= 1e-5:
        raise AssertionError(f"{name} {small} x4: rel err {rel:.3e} > 1e-5")
    return launches, rel


def bench_3d(name, device, card):
    """Phase 7 for one shape: 64 steps through ``run_internal`` and
    through the naive dense stencil; the kernel's (the march kernel), the
    general kernel's and the twin's ms per pass at the engine's k, in
    turns; returns the GStencil/s records and the per-pass times."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil3d, torch_ref
    from lorastencil_tpu_torch.utils import metrics

    spec = get_shape(name)
    eng = engine.StencilEngine.for_shape(name, INTERIOR_3D, device=device)
    k, lay = eng._fused_k(), eng.layout
    gen = torch.Generator(device=device).manual_seed(0)
    state = torch.rand(lay.shape, generator=gen, device=device) * 0.01
    secs, _ = metrics.time_run(eng.run_internal, state, BENCH_STEPS_3D,
                               repeats=3, warmup=1)
    res = metrics.bench_result(spec, INTERIOR_3D, BENCH_STEPS_3D, secs,
                               "cuda-stencil3d", "fp32-exact", 3)
    launches = count_run(eng, state, BENCH_STEPS_3D, "stencil3d_march",
                         BENCH_STEPS_3D // k)
    ms = time_calls({
        "plain": lambda a, b: stencil3d.stencil3d_step_plain(
            a, b, spec, lay, fused_steps=k),
        "kernel": lambda a, b: stencil3d.stencil3d_step(
            a, b, spec, lay, fused_steps=k),
        "general": lambda a, b: general_3d(a, spec, lay, k, b)},
        state, torch.zeros_like(state), calls=10)
    del state
    grid = torch.rand(spec.padded_shape(INTERIOR_3D), generator=gen,
                      device=device) * 0.01

    def naive(g):
        for _ in range(BENCH_STEPS_3D):
            g = torch_ref.dense_step(g, spec)
        return g

    bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
    base = metrics.bench_result(spec, INTERIOR_3D, BENCH_STEPS_3D, bsecs,
                                "torch-naive", "fp32", 3)
    del grid
    dims = "x".join(str(s) for s in INTERIOR_3D)
    for label, r in (("kernel", res), ("naive", base)):
        print(f"phase 7: {label} {name} {dims} x{BENCH_STEPS_3D}: "
              f"{r.time_ms} ms, {r.gstencil_per_s} GStencil/s [{card}]",
              flush=True)
    print(f"phase 7: {name} vs_baseline "
          f"{res.gstencil_per_s / base.gstencil_per_s}; {launches} march "
          f"launches per {BENCH_STEPS_3D}-step run; one pass of k={k} "
          f"steps: march kernel {ms['kernel']} ms, the general kernel it "
          f"replaces {ms['general']} ms, plain twin {ms['plain']} ms "
          f"[{card}]", flush=True)
    return res, base, ms["kernel"], ms["plain"], ms["general"]


def spec_1d(name):
    """A registry 1-D shape, ``for_coeffs`` taps "r40" / "r127": integers
    in [-3, 3] over 256, whose sum of magnitudes (~1.7) keeps values finite
    over the deepest passes, or a narrow spec "m5" / "m9" / "m16" / "m32" of
    that radius whose d cycle through every kind of the narrow plan (+d alone,
    -d alone, both unequal, neither, an equal pair; d = r a pair), the
    centre nonzero (tests/test_torch_resident1d.py's)."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape

    if name.startswith("m"):
        r = int(name[1:])
        rng = np.random.default_rng(r)
        w = rng.integers(1, 4, 2 * r + 1) * rng.choice([-1.0, 1.0],
                                                        2 * r + 1) / 256.0
        taps = np.zeros(2 * r + 1)
        taps[r] = w[r]
        for d in range(1, r + 1):
            kind = d % 5 if d < r else 0
            if kind in (0, 1, 3):
                taps[r + d] = w[r + d]
            if kind in (2, 3):
                taps[r - d] = w[r - d] if kind == 2 else -w[r + d]
            if kind == 0:
                taps[r - d] = w[r + d]
        return engine.StencilEngine.for_coeffs(taps, (64,), name=name,
                                               device="cpu").spec
    if name.startswith("r"):
        r = int(name[1:])
        taps = np.random.default_rng(r).integers(-3, 4, 2 * r + 1) / 256.0
        taps[0] = taps[-1] = 1.0 / 256.0  # effective radius r
        return engine.StencilEngine.for_coeffs(taps, (64,), name=name,
                                               device="cpu").spec
    return get_shape(name)


def layout_1d(spec, n, reach):
    from lorastencil_tpu_torch.ops.layout import TILE_1D, Layout1D, guard_1d

    return Layout1D(interior=n, halo=spec.halo[0], tile=TILE_1D,
                    guard=guard_1d(spec.halo[0], reach))


def check_kernels_1d(name, n, device):
    """Phase 8 for one spec and size: every wrapper that takes the spec
    against its twin; returns {kernel: max abs err of the pi/100 fill after
    4 steps at the engine's k (runs: 2*refresh + 3 steps)}."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=1)
    cases = [("stencil1d_step", s1.stencil1d_step_plain, (1, 2, s1.MAX_FUSED))]
    runs = [("stencil1d_resident", s1.stencil1d_resident_plain, 1)]
    if r <= s1.MAX_LANES_REACH:
        cases.append(("stencil1d_lanes_step", s1.stencil1d_lanes_step_plain,
                      (1, max(1, 12 // r), s1.MAX_LANES_REACH // r)))
        runs.append(("stencil1d_resident_lanes",
                     s1.stencil1d_resident_lanes_plain, s1.lanes_refresh(r)))
    errs = {}

    def agree(got, want, what):
        torch.cuda.synchronize()
        if bool(torch.isnan(want).any()):
            raise AssertionError(f"{what}: the twin gave NaN")
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{what}: kernel differs from its twin at "
                                 f"{bad} cells")
        return (got - want).abs().max().item()

    for kernel, plain, ks in cases:
        wrapper = getattr(s1, kernel)
        for k in sorted(set(ks)):
            lay = layout_1d(spec, n, k * r)
            x = lay.to_internal(g0, device=device)
            for steps in sorted({1, 2, k, 2 * k}):
                agree(run_steps(wrapper, x, spec, lay, steps, k),
                      run_steps(plain, x, spec, lay, steps, k),
                      f"{kernel} {name} {n} k={k} x{steps} (integer fill)")
            x = lay.to_internal(g0 * (np.pi / 100), device=device)
            err = agree(run_steps(wrapper, x, spec, lay, 4, k),
                        run_steps(plain, x, spec, lay, 4, k),
                        f"{kernel} {name} {n} k={k} x4 (pi/100 fill)")
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    for kernel, plain, refresh in runs:
        wrapper = getattr(s1, kernel)
        lay = layout_1d(spec, n, refresh * r)
        for fill, steps_list in ((g0, (1, 2, 2 * refresh + 3)),
                                 (g0 * (np.pi / 100), (4, 2 * refresh + 3))):
            x = lay.to_internal(fill, device=device)
            keep = x.clone()
            for steps in steps_list:
                err = agree(wrapper(x, spec, lay, steps),
                            plain(x, spec, lay, steps),
                            f"{kernel} {name} {n} x{steps}")
                if fill is not g0:
                    errs[kernel] = max(errs.get(kernel, 0.0), err)
            if not torch.equal(x, keep):
                raise AssertionError(f"{kernel} wrote its input")
    return errs


def fills_1d(g0):
    """The integer fill, the pi/100 fill and the pi/100 fill with one inf."""
    pi = g0 * (np.pi / 100)
    inf = pi.copy()
    inf[inf.size // 3] = np.inf
    return {"integer": g0, "pi/100": pi, "inf": inf}


def same_bits(got, want, what):
    """Bit for bit, NaN where the other has NaN; raises otherwise."""
    torch.cuda.synchronize()
    if not bool(((got == want) | (got.isnan() & want.isnan())).all()):
        bad = (got != want).sum().item()
        raise AssertionError(f"{what}: differs at {bad} cells")


def check_lanes(name, n, device):
    """Phase 8, #5: one float32 narrow pass (lanes_kernel, counted in
    ``launches_lanes``) at k = 1, 3 and 32 // r_eff against its twin and
    the kernel it replaces (``pass_kernel<float>``, ``stencil1d._pass``),
    bit for bit on the integer, pi/100 and inf fills; returns the max abs
    err against the twin on the pi/100 fill."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    w = s1.stencil1d_lanes_step
    err = 0.0
    for k in sorted({1, 3, s1.MAX_LANES_REACH // r}):
        lay = layout_1d(spec, n, k * r)
        for fill_name, fill in fills_1d(
                reference.random_padded(spec, (n,), seed=1)).items():
            x = lay.to_internal(fill, device=device)
            before = (w.launches, w.launches_lanes)
            got = w(x, torch.zeros_like(x), spec, lay, fused_steps=k)
            if (w.launches - before[0], w.launches_lanes - before[1]) != (1, 1):
                raise AssertionError(f"{name} {n} k={k}: not one lanes launch")
            what = f"lanes_kernel {name} {n} k={k} ({fill_name} fill)"
            same_bits(got, s1._pass(x, torch.zeros_like(x), spec, lay, k, True),
                      f"{what} against pass_kernel<float>")
            want = s1.stencil1d_lanes_step_plain(x, torch.zeros_like(x), spec,
                                                 lay, k)
            same_bits(got, want, f"{what} against its twin")
            if fill_name == "pi/100":
                err = max(err, (got - want).abs().max().item())
            del x, got, want
    return err


def check_run(name, n, dtype, device):
    """Phase 8, #6: the wide run (run_kernel, counted in ``launches_run``)
    over 1, 2 and 2m + 3 steps (m its plan's steps between exchanges; two
    exchanges and a tail where B > 1) against its twin and the kernel it
    replaces (``resident_kernel``, a grid sync every step:
    ``stencil1d._run``), bit for bit on the integer, pi/100 and inf fills;
    at 4096 cells also the one-block plan (B = 1); returns (the plan, the
    max abs err against the twin on the pi/100 fill)."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    lay = layout_1d(spec, n, r)
    n_taps = len(s1.wide_taps(spec)[0])
    w = s1.stencil1d_resident
    err = 0.0
    plan = None
    for fill_name, fill in fills_1d(
            reference.random_padded(spec, (n,), seed=1)).items():
        x = lay.to_internal(fill, dtype, device)
        keep = x.clone()
        plan = s1.run_plan(lay.rounded, r, n_taps, 64, x.element_size(),
                           s1._sm_count(x.device.index or 0))
        for steps in (1, 2, 2 * plan.m + 3):
            before = (w.launches_run, w.launches, w.launches_f64)
            got = w(x, spec, lay, steps)
            if (w.launches_run - before[0],
                    w.launches + w.launches_f64 - before[1] - before[2]) != (
                        1, 1):
                raise AssertionError(f"{name} {n} x{steps}: not one run")
            what = f"run_kernel {dtype} {name} {n} x{steps} ({fill_name} fill)"
            same_bits(got, s1._run(x, spec, lay, steps, 1, False),
                      f"{what} against resident_kernel")
            want = s1.stencil1d_resident_plain(x, spec, lay, steps)
            same_bits(got, want, f"{what} against its twin")
            if n == N_1D_SMALL:
                one = s1.make_run_plan(lay.rounded, r, x.element_size(), 1,
                                       steps)
                same_bits(s1._wide_run(x, spec, lay, steps, one), want,
                          f"{what}, one block, against its twin")
            if fill_name == "pi/100":
                err = max(err, (got - want).abs().max().item())
        if not torch.equal(x, keep):
            raise AssertionError(f"run_kernel {name} {n} wrote its input")
        del x, keep
    return plan, err


def check_lanes_run(name, n, dtype, device):
    """Phase 8, #7 and #14: the narrow run (run_kernel's narrow instances,
    counted in ``stencil1d_resident_lanes.launches_run``) over 1, 2, 7 and
    2m + 3 steps against its twin and the kernel it replaces
    (``resident_kernel`` reloading every ``lanes_refresh`` steps:
    ``stencil1d._run``), bit for bit on the integer, pi/100 and inf fills;
    also under one block and four blocks of two-step phases where their
    windows fit a block; returns (the plan, the max abs err against the
    twin on the pi/100 fill)."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    refresh = s1.lanes_refresh(r)
    lay = layout_1d(spec, n, refresh * r)
    isz = dtype.itemsize
    if not s1.fits_resident_lanes(lay, isz):
        raise AssertionError(f"{name} {n} does not fit RESIDENT_LANES_BYTES")
    plan = s1.run_plan(lay.rounded, r, s1.lanes_products(spec), 64, isz,
                       s1._sm_count(device.index or 0))
    others = [s1.make_run_plan(lay.rounded, r, isz, blocks, m)
              for blocks, m in ((4, 2), (1, 7))
              if 2 * (-(-lay.rounded // blocks) + 2 * m * r + 64) * isz
              <= 232448]
    w = s1.stencil1d_resident_lanes
    err = 0.0
    for fill_name, fill in fills_1d(
            reference.random_padded(spec, (n,), seed=1)).items():
        x = lay.to_internal(fill, dtype, device)
        keep = x.clone()
        for steps in sorted({1, 2, 7, 2 * plan.m + 3}):
            before = (w.launches_run, w.launches, w.launches_f64)
            got = w(x, spec, lay, steps)
            if (w.launches_run - before[0],
                    w.launches + w.launches_f64 - before[1] - before[2]) != (
                        1, 1):
                raise AssertionError(f"{name} {n} x{steps}: not one run")
            what = (f"narrow run_kernel {dtype} {name} {n} x{steps} "
                    f"({fill_name} fill)")
            same_bits(got, s1._run(x, spec, lay, steps, refresh, True),
                      f"{what} against resident_kernel")
            want = s1.stencil1d_resident_lanes_plain(x, spec, lay, steps)
            same_bits(got, want, f"{what} against its twin")
            for other in others:
                same_bits(s1._lanes_run(x, spec, lay, steps, other), want,
                          f"{what}, plan {tuple(other)}, against its twin")
            if fill_name == "pi/100":
                err = max(err, (got - want).abs().max().item())
        if not torch.equal(x, keep):
            raise AssertionError(f"narrow run_kernel {name} {n} wrote its "
                                 f"input")
        del x, keep
    return plan, err


def largest_resident_1d(name, dtype, narrow=False):
    """The largest interior whose run layout fits RESIDENT_BYTES ('vpu', the
    wide run) or, ``narrow``, RESIDENT_LANES_BYTES ('mxu')."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops.layout import TILE_1D

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    if narrow:
        cap, fits = s1.RESIDENT_LANES_BYTES, s1.fits_resident_lanes
        reach = s1.lanes_refresh(r) * r
    else:
        cap, fits, reach = s1.RESIDENT_BYTES, s1.fits_resident, 2 * r
    n = cap // dtype.itemsize // TILE_1D * TILE_1D
    while not fits(layout_1d(spec, n, reach), dtype.itemsize):
        n -= TILE_1D
    return n


def main_path_1d(device):
    """Phase 9: the 1-D path end to end; returns the launches of each 1-D
    kernel over the phase, counted from zero, and a line per case."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    # (shape, n, engine options, algorithm, path, the kernel counted, k,
    # its launches in run(2) and run(7), the redesigned kernel's count that
    # must grow with it or None: the wide pass, wide_kernel, has none)
    cases = (("1d1r", N_1D_SMALL, {}, "mxu", "resident_lanes",
              "stencil1d_resident_lanes", 4, (1, 1), "stencil1d_lanes_run"),
             ("1d2r", N_1D, {}, "mxu", "lanes", "stencil1d_lanes_step", 3,
              (1, 3), "stencil1d_lanes"),
             ("1d2r", N_1D_LARGE, {}, "mxu", "lanes", "stencil1d_lanes_step",
              3, (1, 3), "stencil1d_lanes"),
             ("1d1r", N_1D_SMALL, {"algorithm": "vpu"}, "vpu", "resident",
              "stencil1d_resident", 2, (1, 1), "stencil1d_run"),
             ("1d2r", N_1D, {"algorithm": "vpu"}, "vpu", "flat",
              "stencil1d_step", 2, (1, 4), None))
    lines = []
    per_case = {}
    reset_counts()
    for name, n, kw, alg, path, kernel, k, expect, new in cases:
        eng = engine.StencilEngine.for_shape(name, (n,), device=device, **kw)
        got = (eng.algorithm, eng.path, eng._fused_k())
        if got != (alg, path, k):
            raise AssertionError(f"{name} {n} {kw} resolved to {got}")
        spec = eng.spec
        g0 = reference.random_padded(spec, (n,), seed=0)
        for steps, want_launches in zip((2, 7), expect):
            fill = g0 if steps == 2 else g0 * (np.pi / 100)
            want = torch.from_numpy(fill).to(device)  # float64
            for _ in range(steps):
                want = torch_ref.dense_step(want, spec)
            before = counts()
            out = eng.run(fill, steps)
            torch.cuda.synchronize()
            launched = {key: v - before[key] for key, v in counts().items()
                        if v != before[key]}
            want_launched = {kernel: want_launches}
            if new:
                want_launched[new] = want_launches
            if launched != want_launched:
                raise AssertionError(f"{name} {n} {kw} run({steps}) "
                                     f"launched {launched}")
            if tuple(out.shape) != spec.padded_shape((n,)):
                raise AssertionError(f"output shape {tuple(out.shape)}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} {n}: output is not finite")
            if steps == 2 and not torch.equal(out.double(), want):
                bad = (out.double() != want).sum().item()
                raise AssertionError(
                    f"{name} {n} {kw}: run(2) differs from the float64 "
                    f"dense stencil at {bad} cells")
            rel = ((out.double() - want).abs().max()
                   / want.abs().max()).item()
            if not rel <= 1e-5:
                raise AssertionError(f"{name} {n} {kw}: run({steps}) rel "
                                     f"err {rel:.3e} > 1e-5")
            per_case[(name, n, alg)] = (per_case.get((name, n, alg), 0)
                                        + launched[kernel])
            lines.append(f"{name} {n} {kw or ''} -> {alg}/{path} k={k}: "
                         f"run({steps}) {launched[kernel]} launch(es) of "
                         f"{kernel}" + (f", every one {new}" if new else "")
                         + f", rel err {rel:.3e}")
            del out, want
    launches = counts()
    new = ("stencil1d_lanes", "stencil1d_run", "stencil1d_lanes_run")
    for kernel in KERNELS_1D + new:
        if launches[kernel] == 0:
            raise AssertionError(f"the 1-D path never launched {kernel}")
    return {kernel: launches[kernel] for kernel in KERNELS_1D + new}, \
        per_case, lines


def graph_ms(fn, calls=20):
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed (best of 3), so the host's launch work is left out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def host_us_per_launch(fn, calls=200):
    """Median wall time of one call of ``fn`` with the device idle before
    it (synchronized), in microseconds."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def conv1d_ms(spec, n, device, dtype=torch.float32):
    """One cuDNN ``F.conv1d`` step with the dense taps (TF32 off) on the
    interior and a radius-deep margin, in ``dtype``, device ms (a CUDA
    graph of 20)."""
    import torch.nn.functional as F

    from lorastencil_tpu_torch.ops import stencil1d as s1

    taps = s1.dense_taps(spec)
    w = torch.tensor(taps, dtype=dtype, device=device)[None, None]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, 1, n + len(taps) - 1), generator=gen, device=device,
                   dtype=dtype) * 0.01
    if tuple(F.conv1d(x, w).shape) != (1, 1, n):
        raise AssertionError("library conv1d has the wrong shape")
    return graph_ms(lambda: F.conv1d(x, w))


def lanes_tiles(device, card, gen):
    """Phase 10: a k = 3 pass of lanes_kernel at 1d2r 1,000,000 and
    16,777,216 in each tile of ``LANES_TILES``, in turns; ``lanes_tile``'s
    choice beside them."""
    from lorastencil_tpu_torch.ops import stencil1d as s1

    spec = spec_1d("1d2r")
    for n in (N_1D, N_1D_LARGE):
        lay = layout_1d(spec, n, 3 * s1.effective_radius(spec))
        x = torch.rand(lay.shape, generator=gen, device=device) * 0.01
        donor = torch.zeros_like(x)
        ms = in_turns({tile: (lambda t=tile: s1._lanes(x, donor, spec, lay,
                                                         3, t))
                       for tile in s1.LANES_TILES}, 20)
        pick = s1.lanes_tile(lay.rounded, s1._sm_count(device.index or 0))
        print(f"phase 10: lanes_kernel 1d2r {n} k=3 by tile (cells: ms): "
              f"{ms}; lanes_tile picks {pick} [{card}]", flush=True)
        del x, donor


# Phase 10's run plans: (shape, n, dtype, blocks, m*r reaches) around the
# H100 rule, at the sizes whose rule it sets; the narrow run's at its
# configuration, at the radii where resident_kernel synced the grid every
# step or two, and at its largest grid
RUN_SWEEP = (
    ("1d1r", 2048, (1, 2, 4, 8, 16), (64, 128, 192)),
    ("1d1r", N_1D_SMALL, (1, 4, 8, 16, 32), (64, 128, 192)),
    ("r40", 100_000, (64, 132), (40, 120, 160, 240)),
    ("1d1r", None, (64, 132), (64, 128, 192, 256)))
LANES_RUN_SWEEP = (
    ("1d1r", N_1D_SMALL, (1, 8, 16, 32), (64, 128, 192)),
    ("m16", 65_536, (64, 132), (32, 96, 192, 256)),
    ("m32", 65_536, (64, 132), (32, 96, 192, 256)),
    ("1d1r", None, (64, 132), (64, 128, 192, 256)))


def run_plans(device, card, gen, narrow=False):
    """Phase 10: 64-step runs (run_kernel, wide or ``narrow``) under plans
    around the H100 rule (``run_plan``), in both dtypes: B = 1 where the
    grid fits a block, and B blocks at m = reach // r; the rule's plan and
    the fastest; a narrow run beside ``resident_kernel`` (reloading every
    ``lanes_refresh`` steps), in the same turns."""
    from lorastencil_tpu_torch.ops import stencil1d as s1

    for dtype in (torch.float32, torch.float64):
        for name, n, blocks_list, reaches in (LANES_RUN_SWEEP if narrow
                                              else RUN_SWEEP):
            n = n or largest_resident_1d(name, dtype, narrow)
            spec = spec_1d(name)
            r = s1.effective_radius(spec)
            lay = layout_1d(spec, n, (s1.lanes_refresh(r) if narrow else 2)
                            * r)
            x = torch.rand(lay.shape, generator=gen, device=device,
                           dtype=dtype) * 0.01
            isz, V = dtype.itemsize, s1.run_cells(dtype.itemsize, r)
            plans = {}
            for blocks in blocks_list:
                for reach in (reaches if blocks > 1 else (r,)):
                    m = 64 if blocks == 1 else max(1, min(64, reach // r))
                    chunk = lay.rounded // V // blocks * V
                    p = s1.make_run_plan(lay.rounded, r, isz, blocks, m)
                    cmax = -(-lay.rounded // V // blocks) * V
                    if (blocks > 1 and chunk < m * r) or 2 * isz * (
                            cmax + 2 * p.halo + 2 * V + 2 * r) > 232448:
                        continue
                    plans[tuple(p)] = p
            n_products = (s1.lanes_products(spec) if narrow
                          else len(s1.wide_taps(spec)[0]))
            rule = s1.run_plan(lay.rounded, r, n_products, 64, isz,
                               s1._sm_count(device.index or 0))
            plans[tuple(rule)] = rule
            launch = s1._lanes_run if narrow else s1._wide_run
            fns = {k: (lambda p=p: launch(x, spec, lay, 64, p))
                   for k, p in plans.items()}
            if narrow:
                fns["resident_kernel"] = lambda: s1._run(
                    x, spec, lay, 64, s1.lanes_refresh(r), True)
            ms = in_turns(fns, 5)
            old = ms.pop("resident_kernel", None)
            best = min(ms, key=ms.get)
            print(f"phase 10: {'narrow' if narrow else 'wide'} run_kernel "
                  f"{str(dtype)[6:]} {name} {n} x64 by plan ((blocks, m, "
                  f"halo, threads): ms): {ms}; the rule {tuple(rule)} "
                  f"{ms[tuple(rule)]} ms, the fastest {best} {ms[best]} ms"
                  + (f"; resident_kernel (refresh {s1.lanes_refresh(r)}) "
                     f"{old} ms in the same turns, "
                     f"{old / ms[tuple(rule)]:.4f}x the rule's"
                     if narrow else "") + f" [{card}]", flush=True)
            del x


def bench_1d(device, card):
    """Phase 10: the three 1-D configurations through ``run_internal`` and
    the naive dense stencil, and per kernel its device time, its twin's,
    the library step and the bound; returns the kernels' timing records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    runs = {}
    for name, n, steps in (("1d1r", N_1D_SMALL, 64), ("1d2r", N_1D, 256),
                           ("1d2r", N_1D_LARGE, 256)):
        eng = engine.StencilEngine.for_shape(name, (n,), device=device)
        state = torch.rand(eng.layout.shape, generator=gen,
                           device=device) * 0.01
        secs, _ = metrics.time_run(eng.run_internal, state, steps,
                                   repeats=3, warmup=1)
        res = metrics.bench_result(eng.spec, (n,), steps, secs,
                                   "cuda-stencil1d", "fp32-exact", 3)
        kernel = ("stencil1d_resident_lanes" if eng.path == "resident_lanes"
                  else "stencil1d_lanes_step")
        launches = count_run(eng, state, steps, kernel,
                             1 if eng.path == "resident_lanes"
                             else -(-steps // eng._fused_k()))
        del state
        grid = torch.rand(eng.spec.padded_shape((n,)), generator=gen,
                          device=device) * 0.01

        def naive(g, spec=eng.spec, steps=steps):
            for _ in range(steps):
                g = torch_ref.dense_step(g, spec)
            return g

        bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
        base = metrics.bench_result(eng.spec, (n,), steps, bsecs,
                                    "torch-naive", "fp32", 3)
        del grid
        runs[(name, n)] = (res, launches)
        for label, r in (("kernel", res), ("naive", base)):
            print(f"phase 10: {label} {name} {n} x{steps}: {r.time_ms} ms, "
                  f"{r.gstencil_per_s} GStencil/s (x{r.fuse_factor} fused) "
                  f"[{card}]", flush=True)
        print(f"phase 10: {name} {n} vs_baseline "
              f"{res.gstencil_per_s / base.gstencil_per_s}; {launches} "
              f"launches of {kernel} per {steps}-step run [{card}]",
              flush=True)

    # per record: the wrapper, shape, size, engine options, steps of a run
    # (None: a pass of the engine's k) and dtype.  #5, #6, #7 and #14,
    # redesigned, are timed in turns beside the kernel each replaces
    # (pass_kernel<float>, the grid-synced resident_kernel: wide at refresh
    # 1, narrow at lanes_refresh), graphs of 20 calls.
    timing = {}
    for key, kernel, name, n, kw, steps, dtype in (
            ("stencil1d_lanes_step", "stencil1d_lanes_step", "1d2r", N_1D,
             {}, None, torch.float32),
            (f"stencil1d_lanes_step[1d2r {N_1D_LARGE}]",
             "stencil1d_lanes_step", "1d2r", N_1D_LARGE, {}, None,
             torch.float32),
            ("stencil1d_step", "stencil1d_step", "1d2r", N_1D,
             {"algorithm": "vpu"}, None, torch.float32),
            ("stencil1d_resident_lanes", "stencil1d_resident_lanes", "1d1r",
             N_1D_SMALL, {}, 64, torch.float32),
            ("stencil1d_resident_pair", "stencil1d_resident_lanes", "1d1r",
             N_1D_SMALL, {}, 64, torch.float64),
            ("stencil1d_resident", "stencil1d_resident", "1d1r", N_1D_SMALL,
             {"algorithm": "vpu"}, 64, torch.float32),
            ("stencil1d_resident_f64", "stencil1d_resident", "1d1r",
             N_1D_SMALL, {"algorithm": "vpu"}, 64, torch.float64)):
        eng = engine.StencilEngine.for_shape(
            name, (n,), device=device, **kw,
            **({"dtype": "float64"} if dtype == torch.float64 else {}))
        spec, lay, k = eng.spec, eng.layout, eng._fused_k()
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=dtype) * 0.01
        donor = torch.zeros_like(x)
        wrapper = getattr(s1, kernel)
        plain = getattr(s1, kernel + "_plain")
        replaced = None
        if steps is None:  # a pass of k steps
            one = lambda: wrapper(x, donor, spec, lay, fused_steps=k)
            twin = lambda: plain(x, donor, spec, lay, fused_steps=k)
            per = k
            if kernel == "stencil1d_lanes_step":
                replaced = lambda: s1._pass(x, donor, spec, lay, k, True)
        else:  # a whole run in one cooperative launch
            one = lambda: wrapper(x, spec, lay, steps)
            twin = lambda: plain(x, spec, lay, steps)
            per = steps
            narrow = kernel == "stencil1d_resident_lanes"
            r = s1.effective_radius(spec)
            refresh = s1.lanes_refresh(r) if narrow else 1
            old_run = (lambda st, refresh=refresh, narrow=narrow:
                       s1._run(x, spec, lay, st, refresh, narrow))
            replaced = lambda: old_run(steps)
        rec = {}
        if replaced is None:
            ms = graph_ms(one)
        else:
            turns = in_turns({"new": one, "old": replaced}, 20)
            ms = turns["new"]
            rec["replaced_kernel_ms"] = turns["old"]
            rec["kernel"] = ("lanes_kernel" if steps is None
                             else "run_kernel")
        if steps is not None and replaced is not None:
            # the per-step floor: the 64-step run less the 1-step run
            one1 = lambda: wrapper(x, spec, lay, 1)
            old1 = lambda: old_run(1)
            turns1 = in_turns({"new": one1, "old": old1}, 20)
            rec["floor_ms_per_step"] = (ms - turns1["new"]) / (steps - 1)
            rec["replaced_floor_ms_per_step"] = (
                rec["replaced_kernel_ms"] - turns1["old"]) / (steps - 1)
            rec["plan"] = list(s1.run_plan(
                lay.rounded, r, s1.lanes_products(spec) if narrow
                else len(s1.wide_taps(spec)[0]), steps, x.element_size(),
                s1._sm_count(device.index or 0)))
            if narrow:
                rec["kernel"] = "run_kernel (narrow sums)"
        plain_ms = graph_ms(twin, 3)
        host_us = host_us_per_launch(one)
        bound, by = bound_ms(spec, (n,), per, dtype.itemsize)
        parts = bound_parts(spec, (n,), per, dtype.itemsize)
        lib = conv1d_ms(spec, n, device, dtype)
        timing[key] = dict(rec, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, library_ms=lib,
                           steps_per_launch=per, library_steps=1,
                           shape=f"{str(dtype)[6:]} {name} {n} {kw or ''}"
                           .strip(),
                           host_us_per_launch=host_us)
        print(f"phase 10: {key} at {str(dtype)[6:]} {name} {n} {kw or ''}, "
              f"{per} steps per launch: kernel {ms} ms (device), "
              f"{bound / ms:.4f} of its bound {bound} ms ({by}; bytes "
              f"{parts[0]} ms, operations {parts[1]} ms); plain twin "
              f"{plain_ms} ms, F.conv1d one step {lib} ms; host {host_us} us "
              f"per launch with the device idle [{card}]", flush=True)
        if replaced is not None:
            old = rec["replaced_kernel_ms"]
            print(f"phase 10: {key}: {rec['kernel']} {ms} ms beside the "
                  f"kernel it replaces {old} ms ({old / ms:.4f}x), in turns"
                  + (f"; per-step floor (64 steps less 1) "
                     f"{rec['floor_ms_per_step']} ms beside "
                     f"{rec['replaced_floor_ms_per_step']} ms; plan "
                     f"(blocks, m, halo, threads) {rec['plan']}"
                     if steps is not None else "")
                  + f" [{card}]", flush=True)
        del x, donor
    lanes_tiles(device, card, gen)
    run_plans(device, card, gen)
    run_plans(device, card, gen, narrow=True)
    res, launches = runs[("1d2r", N_1D)]
    busy = launches * timing["stencil1d_lanes_step"]["ms"] / res.time_ms
    print(f"phase 10: 1d2r {N_1D} x256: {launches} passes x "
          f"{timing['stencil1d_lanes_step']['ms']} ms of kernel in "
          f"{res.time_ms} ms: device busy {busy}, idle {1 - busy} [{card}]",
          flush=True)
    return timing


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def check_kernel_fp64(name, interior, device, guard=None):
    """Phase 11, 2-D: the float64 strip kernel for one shape and size (and
    ``guard``, the layout's default if None) against the float64 tile
    kernel it replaces and its twin: every step a strip launch, counted in
    ``launches_k1`` and ``launches_f64``; one step bit for bit against both
    on the integer, pi/100 and inf fills (NaN where they have NaN), 1-2
    steps of the integer fill against the twin; returns (abs err, rel err,
    bit-equal) of the pi/100 fill after 4 steps."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d
    from lorastencil_tpu_torch.ops.layout import Layout2D, default_tile_2d
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = (port_layout(spec, interior) if guard is None else
           Layout2D(interior=interior, halo=spec.halo,
                    tile=default_tile_2d(*interior), guard=guard))
    if not stencil2d.strip_takes(spec, torch.float64):
        raise AssertionError(f"{name}: the float64 step does not take the "
                             f"strip kernel")
    step = stencil2d.stencil2d_step
    g0 = reference.random_padded(spec, interior, seed=1)
    inf = g0 * (np.pi / 100)
    inf.flat[inf.size // 3] = np.inf
    for fill in (g0, g0 * (np.pi / 100), inf):
        x = lay.to_internal(fill, torch.float64, device)
        before = (step.launches_f64, step.launches_k1)
        strip = step(x, torch.zeros_like(x), spec, lay)
        if (step.launches_f64 - before[0], step.launches_k1 - before[1]) != (
                1, 1):
            raise AssertionError(f"{name} {interior}: the float64 step was "
                                 f"not one strip launch")
        tile = torch.zeros_like(x)
        stencil2d._launch("step", (x, tile), spec, lay, 1)
        want = stencil2d.stencil2d_step_plain(x, torch.zeros_like(x), spec,
                                              lay)
        torch.cuda.synchronize()
        for other, what in ((tile, "the float64 tile kernel"),
                            (want, "its twin")):
            if not bool(((strip == other)
                         | (strip.isnan() & other.isnan())).all()):
                bad = (strip != other).sum().item()
                raise AssertionError(
                    f"{name} {interior} guard {lay.guard}: the float64 strip "
                    f"kernel differs from {what} at {bad} cells")
        del x, strip, tile, want
    for fill, steps_list in ((g0, (1, 2)), (g0 * (np.pi / 100), (4,))):
        x = lay.to_internal(fill, torch.float64, device)
        for steps in steps_list:
            got = run_steps(stencil2d.stencil2d_step, x, spec, lay, steps)
            want = run_steps(stencil2d.stencil2d_step_plain, x, spec, lay,
                             steps)
            torch.cuda.synchronize()
            if (got.dtype != torch.float64
                    or not bool(torch.isfinite(got).all())):
                raise AssertionError(
                    f"{name} {interior}: fp64 output not finite")
            if fill is g0 and not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(
                    f"{name} {interior}: fp64 kernel differs from its twin at "
                    f"{bad} cells after {steps} steps (integer fill)")
    rel = rel_err(got, want)
    if not rel <= 1e-13:
        raise AssertionError(f"{name} {interior}: fp64 rel err {rel:.3e} > "
                             f"1e-13 after 4 steps (pi/100 fill)")
    return (got - want).abs().max().item(), rel, bool(torch.equal(got, want))


def check_kernels_fp64_1d(name, n, device):
    """Phase 11, 1-D: each fp64 wrapper that takes the spec against its twin
    (passes at k = 1, 2 and the largest k whose fp64 window fits shared
    memory; runs where n <= 100,000, so that every block is resident);
    returns {kernel: (max abs err, max rel err, bit-equal) of the pi/100
    fill after 4 steps}."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name)
    r = s1.effective_radius(spec)
    g0 = reference.random_padded(spec, (n,), seed=1)
    kmax = min(s1.MAX_FUSED, s1.max_pass_reach(torch.float64) // r)
    cases = [("df64_1d_flat_step", s1.stencil1d_step_plain, (1, 2, kmax))]
    runs = [("stencil1d_resident", s1.stencil1d_resident_plain, 1)]
    if r <= s1.MAX_LANES_REACH:
        cases.append(("df64_1d_step", s1.stencil1d_lanes_step_plain,
                      (1, 2, s1.MAX_LANES_REACH // r)))
        runs.append(("stencil1d_resident_pair",
                     s1.stencil1d_resident_lanes_plain, s1.lanes_refresh(r)))
    if n > 100_000:
        runs = []
    errs = {}

    def agree(got, want, what, fill):
        torch.cuda.synchronize()
        if got.dtype != torch.float64 or bool(torch.isnan(want).any()):
            raise AssertionError(f"{what}: not float64, or the twin gave NaN")
        if fill is g0 and not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{what}: fp64 kernel differs from its twin "
                                 f"at {bad} cells (integer fill)")
        return ((got - want).abs().max().item(), rel_err(got, want),
                bool(torch.equal(got, want)))

    def keep(kernel, err):
        old = errs.get(kernel, (0.0, 0.0, True))
        errs[kernel] = (max(old[0], err[0]), max(old[1], err[1]),
                        old[2] and err[2])

    for kernel, plain, ks in cases:
        wrapper = getattr(s1, KERNELS_FP64_1D[kernel])
        for k in sorted(set(ks)):
            lay = layout_1d(spec, n, k * r)
            for fill, steps_list in ((g0, sorted({1, 2, k})),
                                     (g0 * (np.pi / 100), (4,))):
                x = lay.to_internal(fill, torch.float64, device)
                for steps in steps_list:
                    err = agree(run_steps(wrapper, x, spec, lay, steps, k),
                                run_steps(plain, x, spec, lay, steps, k),
                                f"{kernel} {name} {n} k={k} x{steps}", fill)
                if fill is not g0:
                    keep(kernel, err)
    for kernel, plain, refresh in runs:
        wrapper = getattr(s1, KERNELS_FP64_1D.get(kernel, kernel))
        lay = layout_1d(spec, n, refresh * r)
        for fill, steps_list in ((g0, (1, 2, 2 * refresh + 3)),
                                 (g0 * (np.pi / 100), (4,))):
            x = lay.to_internal(fill, torch.float64, device)
            for steps in steps_list:
                err = agree(wrapper(x, spec, lay, steps),
                            plain(x, spec, lay, steps),
                            f"{kernel} {name} {n} x{steps}", fill)
            if fill is not g0:
                keep(kernel, err)
    for kernel, (_, rel, _) in errs.items():
        if not rel <= 1e-13:
            raise AssertionError(f"{kernel} {name} {n}: fp64 rel err "
                                 f"{rel:.3e} > 1e-13 (pi/100 fill)")
    return errs


# Phase 11's 2-D cases: (shape, interior, guard or None for the layout's)
FP64_2D_CASES = tuple((name, interior, None)
                      for name in ("star2d1r", "box2d1r", "box2d3r")
                      for interior in ((1000, 1000), INTERIOR)) + (
    ("star2d3r", (1000, 1000), None), ("star2d1r", (300, 140), (5, 7)))


# Phase 12's engine paths: (shape or for_coeffs radius, interior, dtypes,
# path, kernel whose count each run adds to)
FP64_PATHS = (
    ("star2d1r", INTERIOR, ("df64", "float64"), None, "df64_step"),
    ("box2d3r", (4096, 4096), ("df64", "float64"), None, "df64_step"),
    ("1d1r", (N_1D_SMALL,), ("df64", "float64"), "resident_lanes",
     "stencil1d_resident_pair"),
    ("1d2r", (N_1D_LARGE,), ("df64", "float64"), "lanes", "df64_1d_step"),
    ("r40", (100_000,), ("df64", "float64"), "flat", "df64_1d_flat_step"),
    ("r40", (3001,), ("float64",), "resident", "stencil1d_resident_f64"))


def fp64_engine(name, interior, dtype, device):
    from lorastencil_tpu_torch import engine

    if name.startswith("r"):
        return engine.StencilEngine.for_coeffs(
            np.asarray(spec_1d(name).terms[0].taps[0]), interior,
            name=name, device=device, dtype=dtype)
    return engine.StencilEngine.for_shape(name, interior, device=device,
                                          dtype=dtype)


def main_path_fp64(device):
    """Phase 12: every fp64 engine path end to end; returns the launches of
    each fp64 kernel over the phase, counted from zero, and a line per
    case.  Each run's launches are counted exactly: a 2-D step is one
    float64 strip launch, in "df64_step" and "stencil2d_k1"."""
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    lines = []
    reset_counts()
    for name, interior, dtypes, path, kernel in FP64_PATHS:
        for dtype in dtypes:
            eng = fp64_engine(name, interior, dtype, device)
            k = eng._fused_k()
            if eng.path != path or eng.dtype != torch.float64 or k != (
                    1 if dtype == "df64" or len(interior) == 2 else 2):
                raise AssertionError(f"{name} {interior} {dtype} resolved to "
                                     f"{eng.path} at k={k}")
            spec = eng.spec
            g0 = reference.random_padded(spec, interior, seed=0)
            for steps, fill in ((2, g0), (4, g0 * (np.pi / 100))):
                want = torch.from_numpy(fill).to(device)
                for _ in range(steps):
                    want = torch_ref.dense_step(want, spec)
                before = counts()
                out = eng.run(fill, steps)
                torch.cuda.synchronize()
                launched = {key: v - before[key] for key, v in counts().items()
                            if v != before[key]}
                expect = 1 if path and "resident" in path else -(-steps // k)
                want_launches = {kernel: expect}
                if len(interior) == 2:  # every step a float64 strip launch
                    want_launches["stencil2d_k1"] = expect
                if kernel == "stencil1d_resident_f64":  # run_kernel's
                    want_launches["stencil1d_run"] = expect
                if kernel == "stencil1d_resident_pair":  # run_kernel's
                    want_launches["stencil1d_lanes_run"] = expect
                if launched != want_launches:
                    raise AssertionError(f"{name} {interior} {dtype} run("
                                         f"{steps}) launched {launched}")
                if (tuple(out.shape) != spec.padded_shape(interior)
                        or out.dtype != torch.float64
                        or not bool(torch.isfinite(out).all())):
                    raise AssertionError(f"{name} {interior} {dtype}: output "
                                         f"{tuple(out.shape)} {out.dtype}")
                if steps == 2 and not torch.equal(out, want):
                    bad = (out != want).sum().item()
                    raise AssertionError(
                        f"{name} {interior} {dtype}: run(2) differs from the "
                        f"float64 dense stencil at {bad} cells")
                rel = rel_err(out, want)
                if not rel <= 1e-13:
                    raise AssertionError(f"{name} {interior} {dtype}: run(4) "
                                         f"rel err {rel:.3e} > 1e-13")
                lines.append(f"{dtype} {name} {interior} -> path {eng.path} "
                             f"k={k}: run({steps}) {expect} launch(es) of "
                             f"{kernel}, rel err {rel:.3e}")
                del out, want
    launches = counts()
    for kernel in KERNELS_FP64:
        if launches[kernel] == 0:
            raise AssertionError(f"the fp64 paths never launched {kernel}")
    if launches["stencil1d_lanes"]:
        raise AssertionError("a float64 narrow pass ran lanes_kernel")
    return {kernel: launches[kernel] for kernel in
            KERNELS_FP64 + ("stencil1d_resident_f64", "stencil1d_run",
                            "stencil1d_lanes_run")}, lines


def bench_fp64(device, card):
    """Phase 13: the df64 runs through ``run_internal`` and the naive dense
    stencil in float64, then per fp64 kernel its device time, its twin's,
    the float64 library step and the bound (the narrow run's, #14, in phase
    10, beside the kernel it replaces); returns the kernels' timing
    records."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import stencil2d, torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    for name, interior, steps in (("star2d1r", INTERIOR, 32),
                                  ("box2d3r", (4096, 4096), 32),
                                  ("1d1r", (N_1D_SMALL,), 64),
                                  ("1d2r", (N_1D_LARGE,), 256)):
        eng = fp64_engine(name, interior, "df64", device)
        state = torch.rand(eng.layout.shape, generator=gen, device=device,
                           dtype=torch.float64) * 0.01
        secs, _ = metrics.time_run(eng.run_internal, state, steps, repeats=3,
                                   warmup=1)
        res = metrics.bench_result(eng.spec, interior, steps, secs,
                                   "cuda-fp64", "df64", 3)
        if len(interior) == 2:  # every step a float64 strip launch
            count_run(eng, state, steps, "df64_step", steps)
            if counts()["stencil2d_k1"] != steps:
                raise AssertionError(f"df64 {name} x{steps}: "
                                     f"{counts()['stencil2d_k1']} strip "
                                     f"launches")
        del state
        grid = torch.rand(eng.spec.padded_shape(interior), generator=gen,
                          device=device, dtype=torch.float64) * 0.01

        def naive(g, spec=eng.spec, steps=steps):
            for _ in range(steps):
                g = torch_ref.dense_step(g, spec)
            return g

        bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
        base = metrics.bench_result(eng.spec, interior, steps, bsecs,
                                    "torch-naive", "float64", 3)
        del grid
        dims = "x".join(str(s) for s in interior)
        for label, r in (("kernel", res), ("naive", base)):
            print(f"phase 13: {label} df64 {name} {dims} x{steps}: "
                  f"{r.time_ms} ms, {r.gstencil_per_s} GStencil/s "
                  f"(x{r.fuse_factor} fused) [{card}]", flush=True)
        print(f"phase 13: df64 {name} {dims} path {eng.path}: vs_baseline "
              f"{res.gstencil_per_s / base.gstencil_per_s} [{card}]",
              flush=True)

    timing = {}
    for name, interior in (("star2d1r", INTERIOR), ("box2d3r", (4096, 4096))):
        eng = fp64_engine(name, interior, "df64", device)
        spec, lay = eng.spec, eng.layout
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=torch.float64) * 0.01
        donor = torch.zeros_like(x)
        fns = {"kernel": lambda: stencil2d.stencil2d_step(x, donor, spec, lay),
               "tile": lambda: stencil2d._launch("step", (x, donor), spec,
                                                 lay, 1)}
        ms = {}
        for which in ("kernel", "tile", "tile", "kernel"):  # in turns
            ms[which] = min(ms.get(which, float("inf")), graph_ms(fns[which]))
        plain_ms = graph_ms(lambda: stencil2d.stencil2d_step_plain(
            x, donor, spec, lay), 3)
        bound, by = bound_ms(spec, interior, 1, itemsize=8)
        parts = bound_parts(spec, interior, 1, itemsize=8)
        lib = library_ms(spec, interior, device, torch.float64)
        dims = "x".join(str(s) for s in interior)
        rec = dict(ms=ms["kernel"], plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, library_ms=lib, steps_per_launch=1,
                   library_steps=1, shape=f"df64 {name} {dims}",
                   kernel="strip64_kernel", tile_kernel_ms=ms["tile"])
        if name == "star2d1r":
            timing["df64_step"] = rec
        else:
            timing["df64_step"][name] = rec
        print(f"phase 13: df64_step at df64 {name} {dims}, one step: the "
              f"float64 strip kernel {ms['kernel']} ms (device), "
              f"{bound / ms['kernel']:.4f} of its bound; the float64 tile "
              f"kernel it replaces {ms['tile']} ms "
              f"({ms['tile'] / ms['kernel']:.4f}x); plain twin {plain_ms} ms, "
              f"float64 F.conv2d one step {lib} ms, bound {bound} ms ({by}; "
              f"bytes {parts[0]} ms in 8-byte cells, operations {parts[1]} ms "
              f"at {PEAK_FP64_FLOPS / 1e12:.0f} fp64 TFLOP/s) [{card}]",
              flush=True)
        del x, donor
    for kernel, name, interior, steps in (
            ("df64_1d_step", "1d2r", (N_1D_LARGE,), None),
            ("df64_1d_flat_step", "r40", (100_000,), None)):
        eng = fp64_engine(name, interior, "df64", device)
        spec, lay = eng.spec, eng.layout
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=torch.float64) * 0.01
        donor = torch.zeros_like(x)
        wrapper = getattr(s1, KERNELS_FP64_1D[kernel])
        plain = getattr(s1, KERNELS_FP64_1D[kernel] + "_plain")
        one = lambda: wrapper(x, donor, spec, lay)  # one step
        twin = lambda: plain(x, donor, spec, lay)
        per = 1
        ms, plain_ms = graph_ms(one), graph_ms(twin, 3)
        bound, by = bound_ms(spec, interior, per, itemsize=8)
        parts = bound_parts(spec, interior, per, itemsize=8)
        lib = conv1d_ms(spec, interior[0], device, torch.float64)
        dims = "x".join(str(s) for s in interior)
        timing[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, library_ms=lib,
                              steps_per_launch=per, library_steps=1,
                              shape=f"df64 {name} {dims}")
        print(f"phase 13: {kernel} at df64 {name} {dims}, one step per "
              f"launch: kernel {ms} ms (device), plain twin {plain_ms} ms, "
              f"float64 F.conv1d one step {lib} ms, bound "
              f"{bound} ms ({by}; bytes {parts[0]} ms in 8-byte cells, "
              f"operations {parts[1]} ms at {PEAK_FP64_FLOPS / 1e12:.0f} "
              f"fp64 TFLOP/s) [{card}]", flush=True)
        del x, donor
    return timing


# Phases 14-16: 2-D temporal fusion.  star2d3r 8192^2 x 64 is the artifact's
# configuration (BASELINE.md); the engine fuses it at k = 2.
FUSED_SHAPE = "star2d3r"
FUSED_STEPS = 64
SMALL_2D = (512, 512)
# Phase 14's (shape, interior, k, dtypes) for the fused and skewed kernels
FUSED_CASES = (
    ("star2d3r", (1000, 1000), 2, (torch.float32, torch.float64)),
    ("star2d3r", INTERIOR, 2, (torch.float32,)),
    ("star2d3r", (300, 140), 2, (torch.float32,)),
    ("box2d1r", (1000, 1000), 3, (torch.float32, torch.float64)),
    ("star2d1r", (300, 140), 2, (torch.float32, torch.float64)))


def fused_layout(spec, interior, k):
    from lorastencil_tpu_torch.ops.layout import (Layout2D, default_tile_2d,
                                                  guard_2d)

    return Layout2D(interior=interior, halo=spec.halo,
                    tile=default_tile_2d(*interior),
                    guard=guard_2d(spec.halo, k * spec.radius))


def fused_passes(kind, x, spec, lay, steps, k):
    """``steps`` timesteps in passes of ``k`` through the wrappers' fused
    ("fused"), skewed ("skew") or single-step ("single") pass, the
    tile-based fused or skew kernel launched directly ("tile_step",
    "tile_skew"), or their twin ("*_plain": the skew kernel's is the fused
    pass's), with the engine's donor rotation."""
    from lorastencil_tpu_torch.engine import ping_pong_loop
    from lorastencil_tpu_torch.ops import stencil2d as s2

    def one(cur, donor, depth):
        if kind.startswith("tile_"):
            s2._launch(kind[5:], (cur, donor), spec, lay, depth)
            return donor
        if kind == "skew" and depth > 1:
            fn, kw = s2.stencil2d_skew_step, {"skew_steps": depth}
        else:
            fn = s2.stencil2d_step_plain if kind.endswith("plain") else \
                s2.stencil2d_step
            kw = {"fused_steps": depth}
        return fn(cur, donor, spec, lay, **kw)

    return ping_pong_loop(one, x, steps, 1 if kind == "single" else k)


def check_fused(name, interior, k, dtype, device):
    """Phase 14 for one shape, size, depth and dtype: the wrappers' fused
    (#1 at k) and skewed (#2) passes against single-step launches (bit for
    bit on any fill: the kernels share the per-cell sums) and against their
    twins (the 0/1 fill, k steps, bit for bit; the pi/100 fill, 2k steps,
    rel 1e-5 in float32, 1e-13 in float64).  Where the fused strip kernel
    takes the pass, both wrappers must launch it (counted in
    ``launches_fused_strip``) and equal the tile-based fused and skew
    kernels it replaces bit for bit on both fills.  Returns {kernel: (max
    abs err, rel err)} of the pi/100 fill and whether the fused strip
    kernel ran."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = fused_layout(spec, interior, k)
    g0 = reference.random_padded(spec, interior, seed=1)
    strip = s2.fused_strip_takes(spec, dtype, k)
    errs = {}
    for integer, fill in ((True, g0 % 2), (False, g0 * (np.pi / 100))):
        x = lay.to_internal(fill, dtype, device)
        steps = k if integer else 2 * k
        single = fused_passes("single", x, spec, lay, steps, k)
        for kind in ("fused", "skew"):
            reset_counts()
            got = fused_passes(kind, x, spec, lay, steps, k)
            ran = counts()["stencil2d_fused_strip" if kind == "fused"
                           else "stencil2d_skew_fused_strip"]
            want = fused_passes(kind + "_plain", x, spec, lay, steps, k)
            torch.cuda.synchronize()
            what = f"{kind} {name} {interior} {dtype} k={k} x{steps}"
            if ran != (steps // k if strip else 0):
                raise AssertionError(f"{what}: {ran} fused strip launches")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{what}: non-finite output")
            if not torch.equal(got, single):
                bad = (got != single).sum().item()
                raise AssertionError(f"{what}: differs from single-step "
                                     f"launches at {bad} cells")
            if strip:
                tile = fused_passes("tile_" + ("step" if kind == "fused"
                                               else "skew"),
                                    x, spec, lay, steps, k)
                if not torch.equal(got, tile):
                    bad = (got != tile).sum().item()
                    raise AssertionError(f"{what}: differs from the "
                                         f"tile-based {kind} kernel at {bad} "
                                         f"cells")
            if (integer or dtype == torch.float64) and not torch.equal(got,
                                                                       want):
                bad = (got != want).sum().item()
                raise AssertionError(f"{what}: differs from its twin at "
                                     f"{bad} cells")
            rel = rel_err(got, want)
            limit = 1e-13 if dtype == torch.float64 else 1e-5
            if not rel <= limit:
                raise AssertionError(f"{what}: rel err {rel:.3e} > {limit}")
            if not integer:
                errs[kind] = ((got - want).abs().max().item(), rel)
        del x, single, got, want
    return errs, strip


# Phase 14's whole-grid runs: (shape, interior, dtype); on 132 SMs the
# 512^2 rectangles are 46-47 x 42-43 cells, the 300 x 140 ones (the
# rounded interior 320 x 256) 32 x 19-20, and both cut the true interior.
RESIDENT_CASES = (("star2d1r", SMALL_2D, torch.float32),
                  ("box2d3r", SMALL_2D, torch.float32),
                  ("star2d3r", (300, 140), torch.float32),
                  ("star2d1r", SMALL_2D, torch.float64),
                  ("box2d3r", (300, 140), torch.float64))


def resident_grid_synced(x, spec, lay, steps):
    """A run of ``csrc/stencil2d.cu``'s resident kernel (a grid barrier a
    step), which the shared-memory kernel replaces for the registry's
    specs."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    outs = (torch.zeros_like(x), torch.zeros_like(x))
    s2._launch("resident", (x,) + outs, spec, lay, steps)
    return outs[(steps - 1) % 2]


def check_resident(name, interior, dtype, device):
    """Phase 14, the whole-grid run (#3 in float32, #10 in float64): one
    ``stencil2d_resident`` launch of 1, 2 and 4 steps, which must be the
    shared-memory resident kernel (``launches_smem``), against as many
    single-step launches and ``csrc/stencil2d.cu``'s resident kernel (both
    bit for bit), its twin (the integer fill at 1-2 steps bit for bit) and
    the fp64 ground truth
    (the pi/100 fill at 4 steps, rel 1e-5 in float32, 1e-13 in float64);
    returns (max abs err against the twin, rel err against the ground
    truth) of the pi/100 fill."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = fused_layout(spec, interior, 1)
    g0 = reference.random_padded(spec, interior, seed=2)
    for fill, steps_list in ((g0, (1, 2)), (g0 * (np.pi / 100), (4,))):
        x = lay.to_internal(fill, dtype, device)
        for steps in steps_list:
            reset_counts()
            got = s2.stencil2d_resident(x, spec, lay, steps)
            ran = counts()["stencil2d_resident_smem"]
            others = {"single steps": fused_passes("single", x, spec, lay,
                                                   steps, 1),
                      "the grid-synced resident kernel": resident_grid_synced(
                          x, spec, lay, steps)}
            want = s2.stencil2d_resident_plain(x, spec, lay, steps)
            torch.cuda.synchronize()
            what = f"resident {name} {interior} {dtype} x{steps}"
            if ran != 1:
                raise AssertionError(f"{what}: {ran} shared-memory launches")
            for other, out in others.items():
                if not torch.equal(got, out):
                    bad = (got != out).sum().item()
                    raise AssertionError(f"{what}: differs from {other} at "
                                         f"{bad} cells")
            if (fill is g0 or dtype == torch.float64) and not torch.equal(
                    got, want):
                raise AssertionError(f"{what}: differs from its twin")
    truth = reference.run(g0 * (np.pi / 100), spec, 4)
    rel = rel_err(lay.from_internal(got).double().cpu(),
                  torch.from_numpy(truth))
    limit = 1e-13 if dtype == torch.float64 else 1e-5
    if not rel <= limit:
        raise AssertionError(f"{what}: rel err {rel:.3e} > {limit}")
    return (got - want).abs().max().item(), rel


def set_resident_caps(nbytes):
    """The whole-grid runs' caps, as ``LORASTENCIL_RESIDENT2D_KB`` and
    ``LORASTENCIL_RESIDENT2D_PAIR_KB`` set them (0: off), on the CPU and
    the card; None: the defaults (the variables unset)."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    if nbytes is None:
        s2.RESIDENT_2D_BYTES = s2.RESIDENT_PAIR_2D_BYTES = 0
        s2.CUDA_RESIDENT_2D_BYTES = s2.H100_RESIDENT_2D_BYTES
        s2.CUDA_RESIDENT_PAIR_2D_BYTES = s2.H100_RESIDENT_PAIR_2D_BYTES
    else:
        s2.RESIDENT_2D_BYTES = s2.RESIDENT_PAIR_2D_BYTES = nbytes
        s2.CUDA_RESIDENT_2D_BYTES = s2.CUDA_RESIDENT_PAIR_2D_BYTES = nbytes


# the radius-5 runs' interior: its layout (a guard of 8) fits the H100
# default caps in float32 and df64 (2,095,104 bytes in df64)
R5_2D = (480, 480)


def custom_r5():
    """A radius-5 spec, an 11 x 11 box of ones as one term: beyond the
    shared-memory kernel's radii, so its whole-grid runs take
    ``csrc/stencil2d.cu``'s resident kernel."""
    from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec

    ones = (1.0,) * 11
    return StencilSpec(name="custom_r5", ndim=2, radius=5, halo=(5, 5),
                       terms=(SeparableTerm(taps=(ones, ones)),), residue=(),
                       fuse_factor=1)


def path_engine(name, interior, device, **kw):
    from lorastencil_tpu_torch import engine

    if name == "custom_r5":
        return engine.StencilEngine(custom_r5(), interior,
                                    engine._config(kw), device=device)
    return engine.StencilEngine.for_shape(name, interior, device=device, **kw)


# Phase 15's paths, under the default caps: (shape, interior, engine
# options, whether the run is resident, the kernel of its 64-step run, that
# run's launches, the steps of the integer fill's run, exact below 2**24,
# and its launches).  A single float32 step, the
# remainder of an odd run or every step at fused_steps=1, runs the strip
# kernel and counts in "stencil2d_k1" too; star2d3r's k = 2 passes run the
# fused strip kernel from either wrapper, so each of its wrapper's launches
# counts in its "*_fused_strip" too: equal counts mean that no tile-based
# fused or skew kernel ran.
FUSED_PATHS = (
    ("star2d3r", INTERIOR, {}, False, "stencil2d_fused_strip",
     {"stencil2d": 32, "stencil2d_fused_strip": 32}, 3,
     {"stencil2d": 2, "stencil2d_fused_strip": 1, "stencil2d_k1": 1}),
    ("star2d3r", INTERIOR, {"fusion": "skew"}, False,
     "stencil2d_skew_fused_strip",
     {"stencil2d_skew": 32, "stencil2d_skew_fused_strip": 32}, 3,
     {"stencil2d_skew": 1, "stencil2d_skew_fused_strip": 1, "stencil2d": 1,
      "stencil2d_k1": 1}),
    ("star2d3r", INTERIOR, {"fused_steps": 1}, False, "stencil2d",
     {"stencil2d": 64, "stencil2d_k1": 64}, 3,
     {"stencil2d": 3, "stencil2d_k1": 3}),
    ("star2d1r", SMALL_2D, {}, True, "stencil2d_resident",
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}, 2,
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}),
    ("box2d3r", SMALL_2D, {}, True, "stencil2d_resident",
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}, 2,
     {"stencil2d_resident": 1, "stencil2d_resident_smem": 1}),
    ("star2d1r", SMALL_2D, {"dtype": "df64"}, True,
     "stencil2d_resident_pair",
     {"stencil2d_resident_pair": 1, "stencil2d_resident_smem": 1}, 2,
     {"stencil2d_resident_pair": 1, "stencil2d_resident_smem": 1}),
    ("custom_r5", R5_2D, {}, True, "stencil2d_resident",
     {"stencil2d_resident": 1}, 2, {"stencil2d_resident": 1}),
    ("custom_r5", R5_2D, {"dtype": "df64"}, True,
     "stencil2d_resident_pair", {"stencil2d_resident_pair": 1}, 2,
     {"stencil2d_resident_pair": 1}))


def main_path_fused(device):
    """Phase 15: each fused path end to end, launches counted from zero:
    ``run(.., 3)`` (star2d3r; 2 for the others) of the integer fill bit for
    bit against a float64 dense stencil on the card (every partial sum an
    integer below 2**24),
    ``run(.., 4)`` of the pi/100 fill within rel 1e-5 (1e-13 for df64), and
    a 64-step ``run_internal`` that must launch its kernel the expected
    number of times and no other; returns {(shape, mode, dtype): 64-step
    launches}, {(shape, mode, dtype): the pi/100 run's max abs err against
    the dense stencil} and a line per path."""
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    launches, errs, lines = {}, {}, []
    for name, interior, kw, resident, kernel, expect, n_int, run_int in \
            FUSED_PATHS:
        eng = path_engine(name, interior, device, **kw)
        spec = eng.spec
        k = eng._fused_k()
        mode = ("resident" if resident else "skew"
                if eng._fusion_mode() == "skew" else f"extent k={k}")
        if eng._resident_2d() != resident:
            raise AssertionError(f"{name} {kw}: resident {eng._resident_2d()}")
        g0 = reference.random_padded(spec, interior, seed=0)
        for steps, fill in ((n_int, g0), (4, g0 * (np.pi / 100))):
            want = torch.from_numpy(fill).to(device)
            for _ in range(steps):
                want = torch_ref.dense_step(want, spec)
            reset_counts()
            out = eng.run(fill, steps)
            torch.cuda.synchronize()
            got = {key: v for key, v in counts().items() if v}
            if fill is g0 and got != run_int:
                raise AssertionError(f"{name} {kw} run({steps}) launched "
                                     f"{got}")
            if (tuple(out.shape) != spec.padded_shape(interior)
                    or not bool(torch.isfinite(out).all())):
                raise AssertionError(f"{name} {kw}: output {tuple(out.shape)}")
            if fill is g0 and not torch.equal(out.double(), want):
                bad = (out.double() != want).sum().item()
                raise AssertionError(f"{name} {kw}: run({steps}) differs from "
                                     f"the float64 dense stencil at {bad} "
                                     f"cells")
            rel = rel_err(out.double(), want)
            limit = 1e-13 if eng.dtype == torch.float64 else 1e-5
            if not rel <= limit:
                raise AssertionError(f"{name} {kw}: run(4) rel err {rel:.3e}"
                                     f" > {limit}")
            errs[(name, mode, kw.get("dtype", "float32"))] = (
                out.double() - want).abs().max().item()
            del out, want
        gen = torch.Generator(device=device).manual_seed(0)
        state = torch.rand(eng.layout.shape, generator=gen, device=device,
                           dtype=eng.dtype) * 0.01
        reset_counts()
        eng.run_internal(state, FUSED_STEPS)
        torch.cuda.synchronize()
        got = {key: v for key, v in counts().items() if v}
        if got != expect:
            raise AssertionError(f"{name} {kw} x{FUSED_STEPS} launched {got}")
        launches[(name, mode, kw.get("dtype", "float32"))] = expect[kernel]
        dims = "x".join(str(s) for s in interior)
        lines.append(f"{name} {dims} {kw or 'defaults'} -> {mode}: "
                     f"run({n_int}) {run_int} bit-exact, run(4) rel err "
                     f"{rel:.3e}; "
                     f"x{FUSED_STEPS}: launches {expect}, none of the "
                     f"others")
        del state
    return launches, errs, lines


def bench_fused(device, card):
    """Phase 16: star2d3r 8192^2 x 64 through ``run_internal`` in the three
    modes (extent k = 2, skew k = 2, fused_steps = 1) and through the naive
    dense stencil; the resident runs at 512^2 x 64 against the tiled passes;
    per new kernel its device time, its twin's, the library step and the
    bound; returns the kernels' timing records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    spec = get_shape(FUSED_SHAPE)
    dims = f"{INTERIOR[0]}x{INTERIOR[1]}"
    res = {}
    for mode, kw in (("extent", {}), ("skew", {"fusion": "skew"}),
                     ("k=1", {"fused_steps": 1})):
        eng = engine.StencilEngine.for_shape(FUSED_SHAPE, INTERIOR,
                                             device=device, **kw)
        state = torch.rand(eng.layout.shape, generator=gen,
                           device=device) * 0.01
        secs, _ = metrics.time_run(eng.run_internal, state, FUSED_STEPS,
                                   repeats=3, warmup=1)
        res[mode] = metrics.bench_result(spec, INTERIOR, FUSED_STEPS, secs,
                                         f"cuda-stencil2d-{mode}",
                                         "fp32-exact", 3)
        del state
    grid = torch.rand(spec.padded_shape(INTERIOR), generator=gen,
                      device=device) * 0.01

    def naive(g):
        for _ in range(FUSED_STEPS):
            g = torch_ref.dense_step(g, spec)
        return g

    bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
    del grid
    base = metrics.bench_result(spec, INTERIOR, FUSED_STEPS, bsecs,
                                "torch-naive", "fp32", 3)
    for label, r in list(res.items()) + [("naive", base)]:
        print(f"phase 16: {label} {FUSED_SHAPE} {dims} x{FUSED_STEPS}: "
              f"{r.time_ms} ms, {r.gstencil_per_s} GStencil/s "
              f"(x{r.fuse_factor} fused), vs_baseline "
              f"{r.gstencil_per_s / base.gstencil_per_s} [{card}]",
              flush=True)

    # per kernel: one k = 2 pass through each wrapper (the fused strip
    # kernel), through the tile-based fused and skew kernels it replaces,
    # and as two strip-kernel steps, and one k = 1 step, timed in turns
    # (time_calls); the twin apart
    timing = {}
    lay2 = fused_layout(spec, INTERIOR, 2)
    x = torch.rand(lay2.shape, generator=gen, device=device) * 0.01
    spare = torch.zeros_like(x)
    ms = time_calls({
        "fused": lambda a, b: s2.stencil2d_step(a, b, spec, lay2,
                                                fused_steps=2),
        "skew": lambda a, b: s2.stencil2d_skew_step(a, b, spec, lay2,
                                                    skew_steps=2),
        "tile_step": lambda a, b: s2._launch("step", (a, b), spec, lay2, 2),
        "tile_skew": lambda a, b: s2._launch("skew", (a, b), spec, lay2, 2),
        "two": lambda a, b: s2.stencil2d_step(
            s2.stencil2d_step(a, b, spec, lay2), spare, spec, lay2),
        "single": lambda a, b: s2.stencil2d_step(a, b, spec, lay2)},
        x, torch.zeros_like(x), 20)
    del spare
    # the two kernels' twin: a k = 2 pass of the fused kernel's
    plain = time_calls({
        "twin": lambda a, b: s2.stencil2d_step_plain(a, b, spec, lay2, 2)},
        x, torch.zeros_like(x), 3)["twin"]
    del x
    lib = library_ms(spec, INTERIOR, device)
    bound, by = bound_ms(spec, INTERIOR, 2)
    parts = bound_parts(spec, INTERIOR, 2)
    for kernel, tile in (("fused", "tile_step"), ("skew", "tile_skew")):
        timing[kernel] = dict(kernel="fused_strip_kernel", ms=ms[kernel],
                              plain_ms=plain, bound_ms=bound, bound_by=by,
                              library_ms=lib, tile_kernel_ms=ms[tile],
                              two_strip_steps_ms=ms["two"],
                              steps_per_launch=2, library_steps=1,
                              shape=f"{FUSED_SHAPE} {dims}")
        print(f"phase 16: {kernel} k=2 pass at {FUSED_SHAPE} {dims}: fused "
              f"strip kernel {ms[kernel]} ms ({bound / ms[kernel]:.4f} of "
              f"the bound), the tile-based {tile[5:]} kernel it replaces "
              f"{ms[tile]} ms ({ms[tile] / ms[kernel]:.4f}x), two strip "
              f"steps {ms['two']} ms ({ms['two'] / ms[kernel]:.4f}x), plain "
              f"twin {plain} ms, F.conv2d 7x7 one step {lib} ms, bound "
              f"{bound} ms ({by}; bytes {parts[0]} ms, operations {parts[1]} "
              f"ms) [{card}]", flush=True)
    print(f"phase 16: single k=1 step at {FUSED_SHAPE} {dims}: kernel "
          f"{ms['single']} ms; bound of one step "
          f"{bound_ms(spec, INTERIOR, 1)[0]} ms [{card}]", flush=True)

    timing.update(bench_resident(device, card, gen))
    return timing


# Phase 16's whole-grid sweep: square interiors, and the largest one the
# kernel's capacity takes; a cap above any capacity turns the runs on
RESIDENT_SIZES = (256, 512, 1024)
RESIDENT_SWEEP_CAP = 2**30
RESIDENT_LARGE = (1024, 1024)
FLOOR_2D = (64, 128)


def largest_square(name, dtype, device):
    """The largest n, a multiple of 32, whose n x n engine layout the
    shared-memory kernel's capacity takes."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    eng = path_engine(name, (1024, 1024), device, dtype=dtype)
    cap = s2.resident_capacity(eng.spec, eng.dtype, device)
    n = 1024
    while True:
        rows, pitch = path_engine(name, (n + 32, n + 32), device,
                                  dtype=dtype).layout.shape
        if rows * pitch * eng.dtype.itemsize > cap:
            return n
        n += 32


def in_turns(fns, calls=5):
    """Device ms per call of each of ``fns`` (CUDA graphs of ``calls``
    calls), timed forward then backward; the better of the two."""
    res = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        res[k].append(graph_ms(fns[k], calls))
    return {k: min(v) for k, v in res.items()}


def bench_resident(device, card, gen):
    """Phase 16's whole-grid runs: the tiled-against-resident sweep and the
    default caps it gives; the shared-memory kernel beside
    ``csrc/stencil2d.cu``'s resident kernel (at 512^2, 1024^2 and the
    handshake floor's 64 x 128); the radius-5
    runs on ``csrc/stencil2d.cu``'s kernel.  Returns the kernels' timing
    records."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import metrics

    for dtype in ("float32", "df64"):
        sweep = []
        for name in ("star2d1r", "box2d3r"):
            for n in RESIDENT_SIZES + (largest_square(name, dtype, device),):
                runs = {}
                for caps in (0, RESIDENT_SWEEP_CAP):
                    set_resident_caps(caps)
                    eng = path_engine(name, (n, n), device, dtype=dtype)
                    if eng._resident_2d() != bool(caps):
                        raise AssertionError(f"{dtype} {name} {n}: resident "
                                             f"{eng._resident_2d()}")
                    x = torch.rand(eng.layout.shape, generator=gen,
                                   device=device, dtype=eng.dtype) * 0.01
                    secs, _ = metrics.time_run(eng.run_internal, x,
                                               FUSED_STEPS, repeats=3,
                                               warmup=1)
                    runs["resident" if caps else "tiled"] = secs * 1e3
                    del x
                rows, pitch = eng.layout.shape
                nbytes = rows * pitch * eng.dtype.itemsize
                sweep.append((nbytes, runs["tiled"], runs["resident"]))
                print(f"phase 16: {dtype} {name} {n}x{n} x{FUSED_STEPS} "
                      f"({nbytes} bytes): run_internal tiled "
                      f"({FUSED_STEPS} launches) {runs['tiled']} ms, "
                      f"resident (1 launch) {runs['resident']} ms "
                      f"({runs['tiled'] / runs['resident']:.4f}x) [{card}]",
                      flush=True)
        set_resident_caps(None)
        default = 0  # every shape must win at a size, and below it
        for nbytes in sorted({size for size, _, _ in sweep}):
            if any(resident >= tiled for size, tiled, resident in sweep
                   if size == nbytes):
                break
            default = nbytes
        port = (s2.H100_RESIDENT_PAIR_2D_BYTES if dtype == "df64"
                else s2.H100_RESIDENT_2D_BYTES)
        print(f"phase 16: {dtype} default cap from this sweep (the largest "
              f"internal buffer at which the resident run won for both shapes "
              f"at every size measured up to it): {default} bytes; the port's "
              f"H100 default "
              f"{port} bytes [{card}]", flush=True)

    timing = {}
    for label, interior, shapes in (("512^2", SMALL_2D,
                                     ("star2d1r", "box2d3r", "star2d3r")),
                                    ("1024^2", RESIDENT_LARGE,
                                     ("star2d1r", "box2d3r")),
                                    ("floor", FLOOR_2D, ("star2d1r",))):
        for name in shapes:
            spec = get_shape(name)
            lay = fused_layout(spec, interior, 1)
            for dtype in (torch.float32, torch.float64):
                x = torch.rand(lay.shape, generator=gen, device=device,
                               dtype=dtype) * 0.01
                fns = {"kernel": lambda: s2.stencil2d_resident(
                           x, spec, lay, FUSED_STEPS),
                       "grid-synced": lambda: resident_grid_synced(
                           x, spec, lay, FUSED_STEPS)}
                if label == "floor":  # a run of one step: the fixed part
                    fns["one step"] = lambda: s2.stencil2d_resident(
                        x, spec, lay, 1)
                ms = in_turns(fns)
                per = {k: v / FUSED_STEPS * 1e3 for k, v in ms.items()}
                if label == "floor":
                    per["one step"] = ms["one step"] * 1e3
                    ms["a step"] = (ms["kernel"] - ms["one step"]) / (
                        FUSED_STEPS - 1)
                    per["a step"] = ms["a step"] * 1e3
                print(f"phase 16: {str(dtype)[6:]} {name} "
                      f"{interior[0]}x{interior[1]} x{FUSED_STEPS}, in turns: "
                      f"the shared-memory kernel "
                      f"{ms['kernel']} ms ({per['kernel']:.3f} us a step), "
                      + ", ".join(f"{k} {v} ms ({per[k]:.3f} us)"
                                  for k, v in ms.items() if k != "kernel")
                      + f" [{card}]", flush=True)
                if name == "star2d1r" and label != "1024^2":
                    key = "resident" if dtype == torch.float32 else \
                        "resident_pair"
                    timing.setdefault(key, {})[label] = (x, spec, lay, ms)
                else:
                    del x

    # the kernels' records: star2d1r 512^2 (#3 float32, #10 float64) and
    # the radius-5 runs on csrc/stencil2d.cu's kernel
    records = {}
    for key, itemsize, tdtype in (("resident", 4, torch.float32),
                                  ("resident_pair", 8, torch.float64)):
        x, spec, lay, ms = timing[key]["512^2"]
        floor = timing[key]["floor"][3]["a step"]
        plain = graph_ms(lambda: s2.stencil2d_resident_plain(
            x, spec, lay, FUSED_STEPS), 2)
        bound, by = bound_ms(spec, SMALL_2D, FUSED_STEPS, itemsize)
        records[key] = dict(
            kernel="resident_smem_kernel", ms=ms["kernel"], plain_ms=plain,
            bound_ms=bound, bound_by=by,
            library_ms=library_ms(spec, SMALL_2D, device, tdtype),
            grid_synced_kernel_ms=ms["grid-synced"], floor_step_ms=floor,
            floor_shape=f"{FLOOR_2D[0]}x{FLOOR_2D[1]}",
            steps_per_launch=FUSED_STEPS, library_steps=1,
            shape=f"{'df64' if itemsize == 8 else 'float32'} star2d1r 512x512")
        print(f"phase 16: {key} star2d1r 512x512 x{FUSED_STEPS}: the "
              f"shared-memory kernel {ms['kernel']} ms (device), the "
              f"grid-synced kernel {ms['grid-synced']} ms "
              f"({ms['grid-synced'] / ms['kernel']:.4f}x), "
              f"handshake floor ({FLOOR_2D[0]}x{FLOOR_2D[1]}, a step: the "
              f"64-step run less the 1-step run, over 63) {floor} ms, "
              f"plain twin {plain} ms, one "
              f"{'float64 ' if itemsize == 8 else ''}F.conv2d step "
              f"{records[key]['library_ms']} ms, bound {bound} ms ({by}) "
              f"[{card}]", flush=True)
    spec = custom_r5()
    lay = fused_layout(spec, R5_2D, 1)
    dims = f"{R5_2D[0]}x{R5_2D[1]}"
    for key, itemsize, tdtype in (("resident_r5", 4, torch.float32),
                                  ("resident_pair_r5", 8, torch.float64)):
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=tdtype) * 0.01
        rms = graph_ms(lambda: s2.stencil2d_resident(x, spec, lay,
                                                     FUSED_STEPS), 5)
        plain = graph_ms(lambda: s2.stencil2d_resident_plain(
            x, spec, lay, FUSED_STEPS), 2)
        bound, by = bound_ms(spec, R5_2D, FUSED_STEPS, itemsize)
        records[key] = dict(
            kernel="resident_kernel", ms=rms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=library_ms(spec, R5_2D, device, tdtype),
            steps_per_launch=FUSED_STEPS, library_steps=1,
            shape=f"{'df64' if itemsize == 8 else 'float32'} custom_r5 "
                  f"{dims}")
        print(f"phase 16: {key} custom_r5 {dims} x{FUSED_STEPS}: "
              f"csrc/stencil2d.cu's resident kernel {rms} ms (device), plain "
              f"twin {plain} ms, one {'float64 ' if itemsize == 8 else ''}"
              f"F.conv2d 11x11 step {records[key]['library_ms']} ms, bound "
              f"{bound} ms ({by}) [{card}]", flush=True)
        del x
    return records


# Phases 17-19: the 3-D fp64-grade tier, the float64 instance of the 3-D
# kernel (replacing pallas_df64_3d.df64_3d_step), at the JAX DF64 tier's 3-D
# rows, 256^3 x 64 (benchmarks/suite.py:125-126).
SHAPES_3D = ("star3d1r", "box3d1r")


def check_kernel_fp64_3d(name, interior, K, device):
    """Phase 17 for one shape, size and depth: the float64 instance against
    its twin after one and two passes of K (bit for bit on both fills) and,
    on the integer fill, against a float64 dense stencil on the card; returns
    (abs err, rel err, bit-equal) of the pi/100 fill after 4 steps.  The
    pass runs the march kernel, which must also equal the general kernel's
    pass bit for bit on both fills."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil3d, torch_ref
    from lorastencil_tpu_torch.utils import reference

    spec = get_shape(name)
    lay = port_layout_3d(spec, interior, K)
    g0 = reference.random_padded(spec, interior, seed=1)
    x = lay.to_internal(g0, torch.float64, device)
    dense = torch.from_numpy(g0).to(device)
    for passes in (1, 2):
        got = run_steps(stencil3d.stencil3d_step, x, spec, lay, passes * K, K)
        want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay,
                         passes * K, K)
        for _ in range(K):
            dense = torch_ref.dense_step(dense, spec)
        torch.cuda.synchronize()
        if got.dtype != torch.float64 or not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(
                f"{name} {interior} K={K}: fp64 kernel differs from its twin "
                f"at {bad} cells after {passes} passes (integer fill)")
        if not torch.equal(lay.from_internal(got), dense):
            bad = (lay.from_internal(got) != dense).sum().item()
            raise AssertionError(
                f"{name} {interior} K={K}: fp64 kernel differs from the "
                f"float64 dense stencil at {bad} cells after {passes} passes")
    for fill in (g0, g0 * (np.pi / 100)):
        x1 = lay.to_internal(fill, torch.float64, device)
        before = stencil3d.stencil3d_step.launches_march
        got = stencil3d.stencil3d_step(x1, torch.zeros_like(x1), spec, lay,
                                       fused_steps=K)
        if stencil3d.stencil3d_step.launches_march != before + 1:
            raise AssertionError(f"{name} {interior} K={K}: no march launch")
        if not torch.equal(got, general_3d(x1, spec, lay, K)):
            raise AssertionError(f"{name} {interior} K={K}: the fp64 march "
                                 f"kernel differs from the general kernel")
    x = lay.to_internal(g0 * (np.pi / 100), torch.float64, device)
    got = run_steps(stencil3d.stencil3d_step, x, spec, lay, 4, K)
    want = run_steps(stencil3d.stencil3d_step_plain, x, spec, lay, 4, K)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {interior} K={K}: non-finite output")
    rel = rel_err(got, want)
    if not rel <= 1e-13:
        raise AssertionError(f"{name} {interior} K={K}: fp64 rel err "
                             f"{rel:.3e} > 1e-13 after 4 steps (pi/100 fill)")
    return (got - want).abs().max().item(), rel, bool(torch.equal(got, want))


def main_path_fp64_3d(device):
    """Phase 18: the df64 and float64 engines at 256^3 for both shapes, the
    launches of the float64 instance counted from zero over the phase;
    returns the launches of each run, the phase's total and a line per
    case."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import reference

    lines, launches = [], {}
    reset_counts()
    for name in SHAPES_3D:
        for dtype in ("df64", "float64"):
            eng = engine.StencilEngine.for_shape(name, INTERIOR_3D,
                                                 device=device, dtype=dtype)
            k = eng._fused_k()
            label = eng.df64_algorithm if eng.df64 else eng.algorithm
            if (k, eng.backend, eng.dtype, label) != (
                    1 if eng.df64 else 2, "pallas", torch.float64,
                    "vpu_sep" if eng.df64 else "vpu_roll"):
                raise AssertionError(f"{dtype} {name} resolved to {label}/"
                                     f"{eng.backend} at k={k}")
            spec = eng.spec
            g0 = reference.random_padded(spec, INTERIOR_3D, seed=0)
            for steps, fill in ((2, g0), (4, g0 * (np.pi / 100))):
                want = torch.from_numpy(fill).to(device)
                for _ in range(steps):
                    want = torch_ref.dense_step(want, spec)
                before = counts()
                out = eng.run(fill, steps)
                torch.cuda.synchronize()
                launched = {key: v - before[key] for key, v in counts().items()
                            if v != before[key]}
                expect = -(-steps // k)
                if launched != {"df64_3d_step": expect,
                                "stencil3d_march": expect}:
                    raise AssertionError(f"{dtype} {name} run({steps}) "
                                         f"launched {launched}")
                if (tuple(out.shape) != spec.padded_shape(INTERIOR_3D)
                        or out.dtype != torch.float64
                        or not bool(torch.isfinite(out).all())):
                    raise AssertionError(f"{dtype} {name}: output "
                                         f"{tuple(out.shape)} {out.dtype}")
                if steps == 2 and not torch.equal(out, want):
                    bad = (out != want).sum().item()
                    raise AssertionError(
                        f"{dtype} {name}: run(2) differs from the float64 "
                        f"dense stencil at {bad} cells")
                rel = rel_err(out, want)
                if not rel <= 1e-13:
                    raise AssertionError(f"{dtype} {name}: run({steps}) rel "
                                         f"err {rel:.3e} > 1e-13")
                launches[(name, dtype, steps)] = expect
                lines.append(f"{dtype} {name} {INTERIOR_3D} -> "
                             f"{label} k={k}: run({steps}) {expect} "
                             f"launch(es) of df64_3d_step, each the march "
                             f"kernel, rel err {rel:.3e}")
                del out, want
    total = counts()["df64_3d_step"]
    if total == 0 or counts()["stencil3d_march"] != total:
        raise AssertionError("the 3-D fp64 paths did not launch the march "
                             "kernel for every pass")
    return launches, total, lines


def bench_fp64_3d(device, card):
    """Phase 19: df64 (k = 1) and float64 (k = 2) 256^3 x 64 through
    ``run_internal`` and the naive dense stencil in float64; per shape the
    march kernel's float64 device time per df64 pass beside the general
    kernel's and the twin's, and per float64 k = 2 pass beside two k = 1
    passes and the general kernel's k = 2 pass, each set in turns; one
    float64 ``F.conv3d`` step and the pass's bound; returns the kernels'
    timing records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil3d, torch_ref
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    dims = "x".join(str(s) for s in INTERIOR_3D)
    timing = {}
    for name in SHAPES_3D:
        res = {}
        for dtype in ("df64", "float64"):
            eng = engine.StencilEngine.for_shape(name, INTERIOR_3D,
                                                 device=device, dtype=dtype)
            state = torch.rand(eng.layout.shape, generator=gen, device=device,
                               dtype=torch.float64) * 0.01
            secs, _ = metrics.time_run(eng.run_internal, state,
                                       BENCH_STEPS_3D, repeats=3, warmup=1)
            res[dtype] = metrics.bench_result(eng.spec, INTERIOR_3D,
                                              BENCH_STEPS_3D, secs,
                                              "cuda-fp64", dtype, 3)
            k = eng._fused_k()
            res[dtype + " launches"] = count_run(
                eng, state, BENCH_STEPS_3D, "stencil3d_march",
                BENCH_STEPS_3D // k)
            if dtype == "df64":
                spec, lay = eng.spec, eng.layout
                ms = time_calls({
                    "plain": lambda a, b: stencil3d.stencil3d_step_plain(
                        a, b, spec, lay),
                    "kernel": lambda a, b: stencil3d.stencil3d_step(
                        a, b, spec, lay, algorithm="vpu_sep"),
                    "general": lambda a, b: general_3d(a, spec, lay, 1, b)},
                    state, torch.zeros_like(state), calls=10)
            else:
                lay2 = eng.layout
                k2 = time_calls({
                    "k=2": lambda a, b: stencil3d.stencil3d_step(
                        a, b, spec, lay2, fused_steps=2),
                    "two k=1": lambda a, b: stencil3d.stencil3d_step(
                        stencil3d.stencil3d_step(a, b, spec, lay2), a, spec,
                        lay2),
                    "general k=2": lambda a, b: general_3d(a, spec, lay2, 2,
                                                           b)},
                    state, torch.zeros_like(state), calls=10)
                ms.update(k2)
            del state
        grid = torch.rand(spec.padded_shape(INTERIOR_3D), generator=gen,
                          device=device, dtype=torch.float64) * 0.01

        def naive(g, spec=spec):
            for _ in range(BENCH_STEPS_3D):
                g = torch_ref.dense_step(g, spec)
            return g

        bsecs, _ = metrics.time_run(naive, grid, repeats=3, warmup=1)
        del grid
        base = metrics.bench_result(spec, INTERIOR_3D, BENCH_STEPS_3D, bsecs,
                                    "torch-naive", "float64", 3)
        for label in ("df64", "float64"):
            r = res[label]
            print(f"phase 19: {label} {name} {dims} x{BENCH_STEPS_3D} "
                  f"({res[label + ' launches']} launches): {r.time_ms} ms, "
                  f"{r.gstencil_per_s} GStencil/s, vs_baseline "
                  f"{r.gstencil_per_s / base.gstencil_per_s} [{card}]",
                  flush=True)
        print(f"phase 19: naive float64 {name} {dims} x{BENCH_STEPS_3D}: "
              f"{base.time_ms} ms, {base.gstencil_per_s} GStencil/s [{card}]",
              flush=True)
        lib = library_ms(spec, INTERIOR_3D, device, torch.float64)
        bound, by = bound_ms(spec, INTERIOR_3D, 1, itemsize=8)
        parts = bound_parts(spec, INTERIOR_3D, 1, itemsize=8)
        timing[name] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                            bound_ms=bound, bound_by=by, library_ms=lib,
                            steps_per_launch=1, library_steps=1,
                            shape=f"df64 {name} {dims}",
                            general_kernel_ms=ms["general"],
                            float64_k2_ms=ms["k=2"],
                            float64_two_k1_ms=ms["two k=1"],
                            float64_general_k2_ms=ms["general k=2"])
        print(f"phase 19: df64_3d_step at df64 {name} {dims}, 1 step per "
              f"launch: march kernel {ms['kernel']} ms, the general kernel "
              f"it replaces {ms['general']} ms, plain twin {ms['plain']} "
              f"ms, float64 F.conv3d 3x3x3 one step {lib} ms, bound {bound} "
              f"ms ({by}; bytes {parts[0]} ms in 8-byte cells, operations "
              f"{parts[1]} ms at {PEAK_FP64_FLOPS / 1e12:.0f} fp64 TFLOP/s) "
              f"[{card}]", flush=True)
        print(f"phase 19: float64 {name} {dims} k=2 pass: march kernel "
              f"{ms['k=2']} ms, two march k=1 passes {ms['two k=1']} ms "
              f"({ms['two k=1'] / ms['k=2']:.4f}x), the general kernel's k=2 "
              f"pass {ms['general k=2']} ms; bound {bound} ms [{card}]",
              flush=True)
    return timing


# Phase 20: the kernels redesigned for Hopper, csrc/resident2d.cu
# resident_smem_kernel (float and double, radius 1-4),
# csrc/stencil2d.cu strip_kernel
# (an instantiation per radius 1-4 and term count 0-3), strip64_kernel (the
# same in float64, each with 16-byte or 8-byte copies) and
# fused_strip_kernel (radius 1-4, 1-2 terms, K = 2, the terms' kinds),
# csrc/stencil1d.cu wide_kernel (float, double and bfloat16), lanes_kernel
# (float and bfloat16, radius 1-8 and one for 9-32) and run_kernel (float,
# double and bfloat16, radius 1-8 and one for the rest; the wide sums, the
# narrow ones of a plan of pairs only, and any narrow plan's),
# csrc/stencil3d.cu march_kernel (float, double and bfloat16, radius 1,
# K = 1-2, star3d1r's and box3d1r's term kinds, and at K = 2 a ghost ring's
# box or not); the bfloat16 instances are built apart (the *_bf16 sources):
# {kernel: (sources, the pattern of the mangled names
# ptxas reports, what the instantiation's numbers are)}.  A mangled name carries its length before it
# ("12strip_kernel"), which keeps strip_kernel's pattern off
# "18fused_strip_kernel".
PTXAS_KERNELS = {
    "strip_kernel": (("stencil2d", "stencil2d_bf16"),
                     r"\dstrip_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)E",
                     "type,R,terms"),
    "strip64_kernel": ("stencil2d", r"strip64_kernelILi(\d)ELi(\d)ELb([01])E",
                       "R,terms,16-byte"),
    "fused_strip_kernel": (
        ("stencil2d", "stencil2d_bf16"),
        r"fused_strip_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)ELi(\d)ELi(\d+)E",
        "type,R,terms,K,kinds"),
    "wide_kernel": (("stencil1d", "stencil1d_bf16"),
                    r"wide_kernelI([fd]|13__nv_bfloat16)[fd]E", "type"),
    "lanes_kernel": (("stencil1d", "stencil1d_bf16"),
                     r"lanes_kernelI(f|13__nv_bfloat16)Li(\d)EE", "type,R"),
    "run_kernel": (("stencil1d", "stencil1d_bf16"),
                   r"run_kernelI([fd]|13__nv_bfloat16)Li(\d)ELi(\d)E[fd]E",
                   "type,R,form: 0 wide, 2 pairs, 3 mixed"),
    "march_kernel": (
        ("stencil3d", "stencil3d_bf16"),
        r"march_kernelI([fd]|13__nv_bfloat16)Li(\d)ELi(\d)ELi(\d)ELi(\d+)"
        r"ELb([01])ELb([01])E",
        "type,R,K,terms,kinds,16-byte,box"),
    "resident_smem_kernel": (
        "resident2d", r"resident_smem_kernelI([fd]|13__nv_bfloat16)Li(\d)EEE",
        "type,R")}


def ptxas_table(log, pattern):
    """{instantiation: (registers, spill store bytes)} of the kernels whose
    entry name matches ``pattern``; raises on a spill."""
    import re

    table = {}
    for i, line in enumerate(log):
        m = re.search(pattern, line)
        if "Compiling entry function" in line and m:
            info = " ".join(log[i + 1: i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            table[",".join(m.groups())] = (int(regs.group(1)),
                                           int(spill.group(1)))
    if not table:
        raise AssertionError(f"no ptxas lines for {pattern}")
    spilled = {k: v for k, v in table.items() if v[1]}
    if spilled:
        raise AssertionError(f"{pattern} spills: {spilled}")
    return table


def redesigned(device, card, builds, step_ms, lib2, fp64_step, march_ms,
               timing_1d):
    """Phase 20: per redesigned kernel its registers and spills, device ms,
    bound and share of it, and library ms; the 2-D step beside the tile
    kernel it replaces (``step_ms``: phase 2's strip, tile and twin times,
    timed in turns), the float64 strip kernel's df64 steps beside the
    float64 tile kernel (``fp64_step``: phase 13's record, star2d1r's with
    box2d3r's inside), the 3-D march kernel's passes beside the general
    kernel's (``march_ms``: phases 7 and 19, each timed in turns), the
    narrow pass and both runs beside the kernels they replace
    (``timing_1d``: phase 10, in turns) and the wide pass at three sizes;
    returns the large wide pass's record."""
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil1d as s1

    for kernel, (sources, pattern, what) in PTXAS_KERNELS.items():
        sources = (sources,) if isinstance(sources, str) else sources
        table = ptxas_table([ln for s in sources for ln in builds[s][2]],
                            pattern)
        print(f"phase 20: {kernel} registers per instantiation ({what}), no "
              f"spill: "
              + " ".join(f"{k}:{v[0]}" for k, v in sorted(table.items()))
              + "; " + ", ".join(f"{SOURCES[s]} built in {builds[s][0]:.1f} s"
                                 for s in sources), flush=True)
    spec2 = get_shape("star2d1r")
    strip, plain, tile = step_ms
    bound2, by2 = bound_ms(spec2, INTERIOR, 1)
    print(f"phase 20: strip kernel, star2d1r 8192^2 step: {strip} ms "
          f"(device), {bound2 / strip:.4f} of its {bound2} ms {by2} bound; "
          f"the tile kernel it replaces {tile} ms ({tile / strip:.4f}x); "
          f"plain twin {plain} ms; F.conv2d 7x7 {lib2} ms [{card}]",
          flush=True)
    for rec in (fp64_step, fp64_step["box2d3r"]):
        print(f"phase 20: strip64_kernel, {rec['shape']} step: {rec['ms']} "
              f"ms (device), {rec['bound_ms'] / rec['ms']:.4f} of its "
              f"{rec['bound_ms']} ms {rec['bound_by']} bound; the float64 tile "
              f"kernel it replaces {rec['tile_kernel_ms']} ms "
              f"({rec['tile_kernel_ms'] / rec['ms']:.4f}x); float64 F.conv2d "
              f"{rec['library_ms']} ms [{card}]", flush=True)
    for label, ms, general, bound in march_ms:
        print(f"phase 20: march_kernel, {label} pass at 256^3: {ms} ms "
              f"(device), {bound / ms:.4f} of its {bound} ms bytes bound; "
              f"the general kernel {general} ms ({general / ms:.4f}x) "
              f"[{card}]", flush=True)
    for key in ("stencil1d_lanes_step", f"stencil1d_lanes_step[1d2r "
                f"{N_1D_LARGE}]", "stencil1d_resident",
                "stencil1d_resident_f64", "stencil1d_resident_lanes",
                "stencil1d_resident_pair"):
        rec = timing_1d[key]
        print(f"phase 20: {rec['kernel']}, {rec['shape']}, "
              f"{rec['steps_per_launch']} steps a launch: {rec['ms']} ms "
              f"(device), {rec['bound_ms'] / rec['ms']:.4f} of its "
              f"{rec['bound_ms']} ms {rec['bound_by']} bound; the kernel it "
              f"replaces {rec['replaced_kernel_ms']} ms "
              f"({rec['replaced_kernel_ms'] / rec['ms']:.4f}x); one F.conv1d "
              f"step {rec['library_ms']} ms [{card}]", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    large = None
    for name, n, dtype, k in (("r40", 100_000, torch.float64, 1),
                              ("1d2r", N_1D, torch.float32, 2),
                              ("r40", N_1D_LARGE, torch.float64, 1)):
        spec = spec_1d(name)
        r = s1.effective_radius(spec)
        lay = layout_1d(spec, n, k * r)
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=dtype) * 0.01
        donor = torch.zeros_like(x)
        ms = graph_ms(lambda: s1.stencil1d_step(x, donor, spec, lay,
                                                fused_steps=k))
        itemsize = dtype.itemsize
        bound, by = bound_ms(spec, (n,), k, itemsize)
        lib = conv1d_ms(spec, n, device, dtype)
        tile = s1.pass_tile(lay.rounded, s1._sm_count(device.index or 0))
        print(f"phase 20: wide_kernel {str(dtype)[6:]} {name} {n} k={k}: {ms} ms "
              f"(device), {bound / ms:.4f} of its {bound} ms {by} bound; "
              f"one F.conv1d step {lib} ms; {lay.rounded // tile} blocks of "
              f"{tile} cells [{card}]", flush=True)
        if n == N_1D_LARGE:
            plain_ms = graph_ms(lambda: s1.stencil1d_step_plain(
                x, donor, spec, lay, k), 2)
            large = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=lib, steps_per_launch=k,
                         library_steps=1, shape=f"float64 {name} {n}")
        del x, donor
    return large


# Phase 21: the ghost boundaries (ROADMAP A6(a)).  Each ring path at the
# size of the path it extends: (shape, interior, engine options, steps of
# the timed run, the counter its kernel launches count in).
GHOST_MODES = ("periodic", "reflect")
GHOST_PATHS = (
    ("star2d1r", INTERIOR, {}, 256, "stencil2d_k1"),
    ("star2d3r", INTERIOR, {}, 64, "stencil2d_fused_strip"),
    ("star3d1r", INTERIOR_3D, {}, 64, "stencil3d_march"),
    ("box3d1r", INTERIOR_3D, {}, 64, "stencil3d_march"),
    ("1d2r", (N_1D_LARGE,), {}, 256, "stencil1d_lanes"),
    ("1d1r", (N_1D_SMALL,), {}, 64, "stencil1d_step"),
    ("star2d1r", INTERIOR, {"dtype": "df64"}, 32, "df64_step"),
    ("1d2r", (N_1D_LARGE,), {"dtype": "df64"}, 256, "df64_1d_step"),
)
# the whole-grid runs' counters: none may count under a ghost boundary
RUN_COUNTERS = ("stencil2d_resident", "stencil2d_resident_pair",
                "stencil1d_resident_lanes", "stencil1d_resident",
                "stencil1d_resident_f64", "stencil1d_resident_pair",
                "stencil1d_run", "stencil1d_lanes_run")
# each kernel that gained a bounds branch: (kernel, shape, interior, dtype,
# engine options for the fused depth, that depth, the counter its launch
# counts in)
GHOST_KERNELS = (
    ("fused_strip_kernel", "star2d3r", (1000, 1000), "float32", {}, 2,
     "stencil2d_fused_strip"),
    ("plan_strip_kernel", "star2d1r", (1000, 1000), "float32",
     {"fused_steps": 2}, 2, "stencil2d_plan_strip"),
    ("plan_strip_kernel", "box2d3r", (300, 140), "float32",
     {"fused_steps": 3}, 3, "stencil2d_plan_strip"),
    ("plan_strip_kernel<double>", "star2d1r", (1000, 1000), "float64",
     {"fused_steps": 2}, 2, "stencil2d_plan_strip"),
    ("plan_strip_kernel K=4", "star2d1r", (1000, 1000), "float32",
     {"fused_steps": 4}, 4, "stencil2d_plan_strip"),
    # the tile kernel's fused pass (kBox) where the strip walk leaves it:
    # radius 9, and a bfloat16 pass deeper than 4
    ("step_kernel<float> fused", "custom_r9", (1000, 1000), "float32",
     {"fused_steps": 2}, 2, "stencil2d"),
    ("step_kernel<double> fused", "custom_r9", (1000, 1000), "float64",
     {"fused_steps": 2}, 2, "df64_step"),
    ("step_kernel<bf16> fused", "star2d1r", (1000, 1000), "bfloat16",
     {"fused_steps": 5}, 5, "stencil2d_bf16"),
    ("march_kernel<float> K=2", "star3d1r", (37, 45, 130), "float32", {}, 2,
     "stencil3d_march"),
    ("march_kernel<float> K=2", "box3d1r", (37, 45, 130), "float32", {}, 2,
     "stencil3d_march"),
    ("march_kernel<double> K=2", "box3d1r", (37, 45, 130), "float64", {}, 2,
     "stencil3d_march"),
    ("stencil3d_kernel<float> K=4", "star3d1r", (37, 45, 130), "float32",
     {"fused_steps_3d": 4}, 4, "stencil3d"),
    ("lanes_kernel", "1d2r", (N_1D,), "float32", {}, 3, "stencil1d_lanes"),
    ("wide_kernel<float>", "1d1r", (N_1D_SMALL,), "float32", {}, 4,
     "stencil1d_step"),
    ("wide_kernel<double>", "1d1r", (N_1D_SMALL,), "float64", {}, 2,
     "df64_1d_flat_step"),
    ("pass_kernel<double>", "1d2r", (N_1D,), "float64", {}, 2,
     "df64_1d_step"),
)


def ghost_dense(padded, spec, steps, mode):
    """``steps`` of the dense stencil in float64 on the card under a ghost
    boundary, the ground truth's way (``utils/reference.run_periodic`` /
    ``run_reflect``): each step ``torch.roll`` wrap (periodic) or a
    symmetric pad of the radius (reflect) of the interior; the halo of the
    result is zero."""
    from lorastencil_tpu_torch.utils import reference

    it = reference.interior_slices(spec, tuple(padded.shape))
    g = padded[it].double()
    S = spec.dense_coeffs()
    r = spec.radius
    taps = [(tuple(int(i) for i in idx), float(S[tuple(idx)]))
            for idx in np.argwhere(np.abs(S) > 0)]
    for _ in range(steps):
        acc = torch.zeros_like(g)
        if mode == "periodic":
            for idx, w in taps:
                acc += w * torch.roll(g, tuple(r - i for i in idx),
                                      tuple(range(g.ndim)))
        else:
            gp = g
            for a in range(g.ndim):
                n = gp.shape[a]
                gp = torch.cat([gp.narrow(a, 0, r).flip(a), gp,
                                gp.narrow(a, n - r, r).flip(a)], a)
            for idx, w in taps:
                acc += w * gp[tuple(slice(i, i + s)
                                    for i, s in zip(idx, g.shape))]
        g = acc
    out = torch.zeros(padded.shape, dtype=torch.float64, device=padded.device)
    out[it] = g
    return out


def check_ghost_kernels(device):
    """Phase 21 (a): each kernel that gained a bounds branch, launched by its
    wrapper with the engine's ghost bounds on a buffer whose ring the
    engine's refresh filled: one pass, all its levels, bit for bit against
    its twin with the same bounds on the card (the 0/1 fill, as phase 14's:
    the float32 kernels fuse multiply-adds) and within rel 1e-6 (float64
    1e-13) of the float64 ground truth's k steps; returns {kernel:
    launches}."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import stencil3d as s3
    from lorastencil_tpu_torch.utils import reference

    launched = {}
    for kernel, name, interior, dtype, kw, k, counter in GHOST_KERNELS:
        spec = reach_spec(name) or get_shape(name)
        g0 = reference.random_padded(spec, interior, seed=21) % 2
        # bfloat16 rounds once a pass: 2**-8 of the largest value
        tol = {"float64": 1e-13, "bfloat16": 2.0 ** -8}.get(dtype, 1e-6)
        for mode in GHOST_MODES:
            eng = engine.StencilEngine(
                spec, interior,
                engine._config(dict(kw, boundary=mode, dtype=dtype)),
                device=device)
            if eng._fused_k() != k:
                raise AssertionError(f"{kernel}: the engine's k is "
                                     f"{eng._fused_k()}, not {k}")
            x = eng._ring_refresh(eng.to_internal(g0), mode)
            bounds = eng._ghost_bounds()
            if spec.ndim == 1:
                wrapper = (s1.stencil1d_lanes_step if eng.path == "lanes"
                           else s1.stencil1d_step)
                twin = (s1.stencil1d_lanes_step_plain if eng.path == "lanes"
                        else s1.stencil1d_step_plain)
            elif spec.ndim == 2:
                wrapper, twin = s2.stencil2d_step, s2.stencil2d_step_plain
            else:
                wrapper, twin = s3.stencil3d_step, s3.stencil3d_step_plain
            reset_counts()
            got = wrapper(x, torch.zeros_like(x), spec, eng.layout,
                          fused_steps=k, bounds=bounds)
            torch.cuda.synchronize()
            c = counts()
            if c[counter] != 1 or (kernel.startswith("step_kernel")
                                   and (c["stencil2d_fused_strip"]
                                        or c["stencil2d_plan_strip"]
                                        or c["stencil2d_tile"] != 1)) or (
                    kernel.startswith("stencil3d_kernel")
                    and c["stencil3d_march"]):
                raise AssertionError(f"{kernel} {name} {mode}: launches "
                                     f"{c}")
            launched[kernel] = launched.get(kernel, 0) + c[counter]
            same_bits(got, twin(x, torch.zeros_like(x), spec, eng.layout, k,
                                bounds), f"{kernel} {name} {mode} vs twin")
            want = ghost_dense(torch.from_numpy(g0).to(device), spec, k, mode)
            rel = float((eng.from_internal(got).double() - want).abs().max()
                        / want.abs().max())
            if not rel <= tol:
                raise AssertionError(f"{kernel} {name} {mode}: one pass "
                                     f"off {k} steps of the float64 ground "
                                     f"truth by rel {rel:.3e}")
    return launched


def ghost_paths(device, card):
    """Phase 21 (b): each ring path of ``GHOST_PATHS`` through the engine's
    default dispatch in both modes: ``run(.., 2)`` of the integer fill bit
    for bit against ``ghost_dense`` on the card and ``run(.., 4)`` of the
    pi/100 fill within rel 1e-5 (df64 1e-13), the launches of both counted
    from zero (the path's kernel launched, no whole-grid run); the timed
    run beside the same run in dirichlet0 (its own default dispatch: a run
    where the grid is small), in turns, and the ring refresh alone, per
    call, as a CUDA graph (device) and eagerly (wall: the best of 20 calls,
    each between CUDA events).  Returns the records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.utils import metrics, reference

    def wall_ms(fn, repeats=1):
        # CUDA events around one call: the host's work is in it where the
        # device waits for it
        return metrics.time_run(fn, repeats=repeats, warmup=0)[0] * 1e3

    records = []
    for name, interior, kw, steps, counter in GHOST_PATHS:
        spec = get_shape(name)
        dtype = kw.get("dtype", "float32")
        tol = 1e-13 if dtype == "df64" else 1e-5
        g0 = reference.random_padded(spec, interior, seed=22)
        gdev = torch.from_numpy(g0).to(device)
        engines = {mode: engine.StencilEngine.for_shape(
            name, interior, device=device, boundary=mode, **kw)
            for mode in ("dirichlet0",) + GHOST_MODES}
        rec = {"shape": name, "interior": list(interior), "dtype": dtype,
               "steps": steps, "card": card}
        for mode in GHOST_MODES:
            eng = engines[mode]
            reset_counts()
            out = eng.run(g0, 2)
            torch.cuda.synchronize()
            c2 = counts()
            want = ghost_dense(gdev, spec, 2, mode)
            if not torch.equal(out.double(), want):
                bad = (out.double() != want).sum().item()
                raise AssertionError(f"{name} {interior} {dtype} {mode}: "
                                     f"run(2) differs from the float64 "
                                     f"ground truth at {bad} cells")
            del out, want
            g1 = g0 * (np.pi / 100)
            reset_counts()
            out = eng.run(g1, 4)
            torch.cuda.synchronize()
            c4 = counts()
            want = ghost_dense(torch.from_numpy(g1).to(device), spec, 4, mode)
            rel = float((out.double() - want).abs().max()
                        / want.abs().max())
            if not rel <= tol:
                raise AssertionError(f"{name} {interior} {dtype} {mode}: "
                                     f"run(4) rel err {rel:.3e} > {tol}")
            del out, want
            for c in (c2, c4):
                if not c[counter] or any(c[r] for r in RUN_COUNTERS):
                    raise AssertionError(f"{name} {mode}: launches {c}")
            rec[mode] = {"path": eng.path, "k": eng._fused_k(),
                         "ring_depth": eng._ring_depth(),
                         "launches_run2": c2[counter],
                         "launches_run4": c4[counter], "rel_err_4": rel}
        # the timed runs, in turns, and their launches counted from zero
        states = {mode: e.to_internal(g0) for mode, e in engines.items()}
        fns = {mode: (lambda e=e, s=states[mode]: e.run_internal(s, steps))
               for mode, e in engines.items()}
        best = {mode: float("inf") for mode in fns}
        for mode, fn in fns.items():  # warm up
            fn()
        order = list(fns)
        for turn in range(3):
            for mode in (order if turn % 2 == 0 else order[::-1]):
                best[mode] = min(best[mode], wall_ms(fns[mode]))
        for mode in fns:
            reset_counts()
            fns[mode]()
            torch.cuda.synchronize()
            c = counts()
            if mode != "dirichlet0" and (not c[counter] or any(
                    c[r] for r in RUN_COUNTERS)):
                raise AssertionError(f"{name} {mode} x{steps}: launches {c}")
            launches = {k: v for k, v in c.items() if v}
            rec.setdefault(mode, {}).update(
                {"run_ms": best[mode], "launches": launches})
        passes = rec["periodic"]["launches"][counter]
        for mode in GHOST_MODES:
            eng = engines[mode]
            buf = states[mode].clone()
            rec[mode]["refresh_graph_ms"] = graph_ms(
                lambda e=eng, b=buf, m=mode: e._ring_refresh(b, m))
            rec[mode]["refresh_wall_ms"] = wall_ms(
                lambda e=eng, b=buf, m=mode: e._ring_refresh(b, m), 20)
            rec[mode]["refreshes_per_run"] = passes + 1
        del states
        records.append(rec)
    return records


# Phase 22: custom coefficients (ROADMAP A6(b)) and the adjoint (A10).
# StencilEngine.for_coeffs decomposes these arrays into plans no registry
# shape gives: non-symmetric taps, unpaired residue points, four terms, z
# taps beside plane taps.  {name: coefficient array}.
def custom_coeffs():
    g = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    heat = np.outer(g, g)  # examples/heat_diffusion.py's heat5x5
    heat[0, 2] += 0.05
    heat[4, 2] += 0.05
    rng = np.random.default_rng(15)
    return {
        "5x5 asym": np.random.default_rng(43).standard_normal((5, 5)),
        "heat5x5": heat,
        "3x3 inverse-source": np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0],
                                        [1.0, 2.0, 1.0]]) / 16.0,
        "9x9 rank 4": sum(np.outer(rng.standard_normal(9),
                                   rng.standard_normal(9)) for _ in range(4)),
        "separable-z": np.einsum("i,j,k->ijk", [0.5, 1.0, 0.25],
                                 [1.0, 2.0, -1.0], [0.5, 1.0, 0.75]),
        "per-plane": np.random.default_rng(5).standard_normal((3, 3, 3))}


# (coefficients, engine options, (terms, residue points), the kernel a pass
# runs in float32 and in df64, the boundary modes): the dispatch the
# wrappers' rules must give, checked before each run
CUSTOM_CASES = (
    ("5x5 asym", {}, (3, 4), ("strip_kernel", "strip64_kernel"),
     ("dirichlet0", "periodic", "reflect")),
    ("5x5 asym", {"fused_steps": 2}, (3, 4),
     ("strip_kernel x2", None), ("dirichlet0", "periodic")),
    ("heat5x5", {}, (2, 0), ("fused_strip_kernel", "strip64_kernel"),
     ("dirichlet0", "periodic")),
    ("heat5x5", {"fused_steps": 1}, (2, 0), ("strip_kernel", None),
     ("dirichlet0", "periodic")),
    ("3x3 inverse-source", {}, (1, 0),
     ("fused_strip_kernel", "strip64_kernel"), ("dirichlet0", "periodic")),
    ("9x9 rank 4", {}, (4, 0), ("plan_strip_kernel", "plan_strip_kernel<double>"),
     ("dirichlet0", "periodic")),
    ("separable-z", {}, (1, 0), ("march_kernel", "march_kernel"),
     ("dirichlet0", "periodic")),
    ("per-plane", {}, (6, 3), ("plan_march_kernel", "plan_march_kernel"),
     ("dirichlet0", "periodic")))
# the whole-grid runs of a custom spec: (coefficients, interior)
CUSTOM_RESIDENT = ("5x5 asym", SMALL_2D)
ADJOINT_SPEC = "5x5 asym"
ADJOINT_STEPS = 4
INVERSE_ITERATIONS = 20


def custom_kernel(eng):
    """(kernel, the counter its launches count in, counters that must stay
    zero) of an engine's passes, from the wrappers' own rules."""
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import stencil3d as s3

    spec, k, f64 = eng.spec, eng._fused_k(), eng.dtype == torch.float64
    if eng._resident_2d():
        return "resident_smem_kernel", "stencil2d_resident_smem", ()
    if spec.ndim == 3:
        if s3.march_takes(spec, eng.dtype, k):
            return "march_kernel", "stencil3d_march", ()
        if s3.plan_march_takes(spec, eng.dtype, k):
            return ("plan_march_kernel", "stencil3d_plan_march",
                    ("stencil3d_march",))
        return ("stencil3d_kernel", "df64_3d_step" if f64 else "stencil3d",
                ("stencil3d_march", "stencil3d_plan_march"))
    strip = "strip64_kernel" if f64 else "strip_kernel"
    if k == 1 and s2.strip_takes(spec, eng.dtype):
        return strip, "stencil2d_k1", ()
    if s2.fused_strip_takes(spec, eng.dtype, k):
        return "fused_strip_kernel", "stencil2d_fused_strip", ()
    if k > 1 and s2.strips_beat_plan(spec, eng.dtype, k):
        return (f"{strip} x{k}", "stencil2d_k1",
                ("stencil2d_plan_strip", "stencil2d_fused_strip"))
    if s2.plan_strip_takes(spec, eng.dtype, k):
        return ("plan_strip_kernel<double>" if f64 else "plan_strip_kernel",
                "stencil2d_plan_strip", ("stencil2d_k1",
                                         "stencil2d_fused_strip"))
    kernel = "step_kernel<double>" if f64 else "step_kernel<float>"
    return (kernel + (" fused" if k > 1 else ""),
            "df64_step" if f64 else "stencil2d",
            ("stencil2d_k1", "stencil2d_fused_strip"))


def dyadic(spec):
    """``spec`` with each nonzero tap and residue weight replaced by +-1/2 or
    +-1 (its sign; the magnitude the nearer of the two), zero taps kept: the
    same plan (terms, axes, zero taps, residue offsets), whose float32 sums
    on a 0/1 fill stay exact for two steps (at most 4 * 9 * 9 per step in
    units of 1/4 per axis, below 2**24), so that the kernels, which fuse
    multiply-adds, and their twins agree bit for bit."""
    import dataclasses
    import math

    from lorastencil_tpu_torch.models.shapes import SeparableTerm

    def q(w):
        w = float(w)
        return 0.0 if w == 0.0 else math.copysign(
            1.0 if abs(w) >= 0.75 else 0.5, w)

    return dataclasses.replace(
        spec, name=spec.name + " dyadic",
        terms=tuple(SeparableTerm(taps=tuple(
            None if t is None else tuple(q(w) for w in t)
            for t in term.taps)) for term in spec.terms),
        residue=tuple((off, q(w)) for off, w in spec.residue))


class twins:
    """Inside ``with twins():`` every 1-D, 2-D and 3-D kernel wrapper the
    engine calls (the skew pass's too) is its plain PyTorch twin, on the state's device: an engine run
    is the kernels' run with each launch's plain version, levels, bounds
    and ring refreshes as the engine gives them."""

    def __enter__(self):
        from lorastencil_tpu_torch.ops import stencil1d as s1
        from lorastencil_tpu_torch.ops import stencil2d as s2
        from lorastencil_tpu_torch.ops import stencil3d as s3

        self.saved = (s2.stencil2d_step, s2.stencil2d_resident,
                      s3.stencil3d_step, s2.stencil2d_skew_step)
        self.saved_1d = {name: getattr(s1, name) for name in KERNELS_1D}

        def pass1(plain):
            def call(cur, donor, spec, layout, fused_steps=1, bounds=None,
                     **_):
                return plain(cur, donor, spec, layout, fused_steps, bounds)
            return call

        s1.stencil1d_lanes_step = pass1(s1.stencil1d_lanes_step_plain)
        s1.stencil1d_step = pass1(s1.stencil1d_step_plain)
        s1.stencil1d_resident_lanes = s1.stencil1d_resident_lanes_plain
        s1.stencil1d_resident = s1.stencil1d_resident_plain

        def step2(cur, donor, spec, layout, algorithm=None, fused_steps=1,
                  bounds=None, refresh=None):
            return s2.stencil2d_step_plain(cur, donor, spec, layout,
                                           fused_steps, bounds)

        def skew2(cur, donor, spec, layout, algorithm=None, skew_steps=2):
            return s2.stencil2d_step_plain(cur, donor, spec, layout,
                                           skew_steps)

        def step3(cur, donor, spec, layout, algorithm=None, fused_steps=1,
                  conv_carry=None, bounds=None, region=None, refresh=None):
            return s3.stencil3d_step_plain(cur, donor, spec, layout,
                                           fused_steps, bounds)

        s2.stencil2d_step, s3.stencil3d_step = step2, step3
        s2.stencil2d_skew_step = skew2
        s2.stencil2d_resident = s2.stencil2d_resident_plain
        return self

    def __exit__(self, *exc):
        from lorastencil_tpu_torch.ops import stencil1d as s1
        from lorastencil_tpu_torch.ops import stencil2d as s2
        from lorastencil_tpu_torch.ops import stencil3d as s3

        (s2.stencil2d_step, s2.stencil2d_resident, s3.stencil3d_step,
         s2.stencil2d_skew_step) = self.saved
        for name, fn in self.saved_1d.items():
            setattr(s1, name, fn)


def dense_truth(padded, spec, steps, mode):
    """``steps`` of the dense stencil in float64 on the card: the
    reference's halo decay (dirichlet0) or ``ghost_dense``'s wrap / mirror."""
    from lorastencil_tpu_torch.ops import torch_ref

    if mode != "dirichlet0":
        return ghost_dense(padded, spec, steps, mode)
    out = padded.double()
    for _ in range(steps):
        out = torch_ref.dense_step(out, spec)
    return out


def counted_run(eng, padded, steps, kernel):
    """``eng.run(padded, steps)``, its launches counted from zero; raises
    unless ``kernel`` (``custom_kernel``) launched and its zero counters
    stayed zero.  Returns (output, launches of the kernel)."""
    _, counter, zero = kernel
    reset_counts()
    out = eng.run(padded, steps)
    torch.cuda.synchronize()
    c = counts()
    if not c[counter] or any(c[z] for z in zero):
        raise AssertionError(f"{eng.spec.name} {eng.config.dtype} "
                             f"{eng.config.boundary} run({steps}): {kernel[0]}"
                             f" not launched alone: {c}")
    return out, c[counter]


def magnitude(spec):
    """The stencil of the magnitudes |S| of ``spec``'s coefficients (as
    residue points): on |x| it bounds the sum a float32 run rounds, the
    scale its rounding errors are relative to."""
    from lorastencil_tpu_torch.models.shapes import StencilSpec

    S = np.abs(spec.dense_coeffs())
    r = spec.radius
    return StencilSpec(
        name=spec.name + " magnitude", ndim=spec.ndim, radius=r,
        halo=spec.halo, terms=(), fuse_factor=1,
        residue=tuple((tuple(int(i) - r for i in idx), float(S[tuple(idx)]))
                      for idx in np.argwhere(S > 0)))


@functools.lru_cache(maxsize=1)
def custom_fills(shape, device):
    """The 0/1 and pi/100 fills of phase 22 on a padded ``shape``: float64
    tensors made on the card from one seeded draw of integers in [0, 100)
    (``utils/reference.random_padded``'s range), its parity and its
    multiple of pi/100; made once per shape, since a spec's cases run one
    after another."""
    gen = torch.Generator(device=device).manual_seed(22)
    g = torch.randint(0, 100, shape, generator=gen, device=device,
                      dtype=torch.float64)
    return g % 2, g * (np.pi / 100)


_MAGNITUDE_SCALES = {}


def magnitude_scale(name, mode, spec, g1):
    """The largest value of 4 steps of the magnitude stencil
    (``magnitude``) on |g1| under ``mode``, computed once per spec and
    mode."""
    if (name, mode) not in _MAGNITUDE_SCALES:
        _MAGNITUDE_SCALES[name, mode] = float(dense_truth(
            g1.abs(), magnitude(spec), 4, mode).max())
    return _MAGNITUDE_SCALES[name, mode]


def check_custom(name, kw, dtype, mode, device, expect=None):
    """Phase 22 (a)-(f) for one spec, dtype and boundary mode: the dyadic
    twin of the spec (``dyadic``) through the same kernel, run(2) on the 0/1
    fill bit for bit against the engine's run with the plain twins
    (``twins``) and the float64 dense stencil; the spec itself on the
    pi/100 fill: run(2) against the twins' run (df64 bit for bit; float32,
    whose kernels fuse multiply-adds, no further from the float64 dense
    stencil than twice the twins' run) and run(4) against the float64
    dense stencil, df64 within rel 1e-13 of its largest value, float32
    within rel 1e-5 of the largest value of the magnitude stencil
    (``magnitude``) on the fill's magnitudes: the float32 sums of random
    taps cancel, and a float32 run in any order misses 1e-5 of the
    output's own largest value on the 9x9.  Each run's launches counted
    from zero, the kernel the only one of its kind.  Returns a record."""
    from lorastencil_tpu_torch import engine

    t0 = time.perf_counter()
    S = custom_coeffs()[name]
    interior = INTERIOR if S.ndim == 2 else INTERIOR_3D
    eng = engine.StencilEngine.for_coeffs(S, interior, name=name,
                                          device=device, dtype=dtype,
                                          boundary=mode, **kw)
    kernel = custom_kernel(eng)
    if expect is not None and kernel[0] != expect:
        raise AssertionError(f"{name} {kw} {dtype} {mode}: the pass runs "
                             f"{kernel[0]}, not {expect}")
    spec = eng.spec
    rec = {"spec": name, "options": kw, "dtype": dtype, "mode": mode,
           "terms": len(spec.terms), "residue": len(spec.residue),
           "radius": spec.radius, "k": eng._fused_k(), "kernel": kernel[0]}
    deng = engine.StencilEngine(dyadic(spec), interior, eng.config,
                                device=device)
    if custom_kernel(deng) != kernel:
        raise AssertionError(f"{name}: the dyadic twin runs another kernel")
    g01, g1 = custom_fills(spec.padded_shape(interior), device)
    out, rec["launches_dyadic_2"] = counted_run(deng, g01, 2, kernel)
    with twins():
        same_bits(out, deng.run(g01, 2), f"{name} dyadic {dtype} {mode} "
                                          f"run(2) vs the twins")
    same_bits(out.double(), dense_truth(g01, deng.spec, 2, mode),
              f"{name} dyadic {dtype} {mode} run(2) vs float64")
    del out
    out, rec["launches_2"] = counted_run(eng, g1, 2, kernel)
    with twins():
        twin = eng.run(g1, 2)
    rec["twin_equal_share_2"] = float((out == twin).double().mean())
    if dtype == "df64":
        same_bits(out, twin, f"{name} df64 {mode} run(2) vs the twins")
    else:
        want = dense_truth(g1, spec, 2, mode)
        rec["abs_err_2"] = float((out.double() - want).abs().max())
        rec["twin_abs_err_2"] = float((twin.double() - want).abs().max())
        # (and a few roundings of the largest value, should the twins' run
        # happen to be exact)
        if not rec["abs_err_2"] <= (2 * rec["twin_abs_err_2"]
                                    + 2**-22 * float(want.abs().max())):
            raise AssertionError(f"{name} {mode} run(2): {rec['abs_err_2']} "
                                 f"off float64, the twins "
                                 f"{rec['twin_abs_err_2']}")
        del want
    del out, twin
    out, rec["launches_4"] = counted_run(eng, g1, 4, kernel)
    want = dense_truth(g1, spec, 4, mode)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name} {dtype} {mode}: non-finite run(4)")
    rec["abs_err_4"] = float((out.double() - want).abs().max())
    rec["rel_err_4"] = rec["abs_err_4"] / float(want.abs().max())
    del out, want
    if dtype == "df64":
        err, tol = rec["rel_err_4"], 1e-13
    else:
        scale = magnitude_scale(name, mode, spec, g1)
        err, tol = rec["abs_err_4"] / scale, 1e-5
        rec["rel_err_4_magnitude"] = err
    if not err <= tol:
        raise AssertionError(f"{name} {dtype} {mode}: run(4) rel err "
                             f"{err:.3e} > {tol}")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def check_custom_kernels(device):
    """Phase 22: each redesigned kernel on a custom spec bit for bit against
    the kernel it replaces there (the strip kernels against the tile
    kernel of their dtype, the fused strip kernel against the tile-based
    fused kernel, the march kernel against the general one) on the pi/100
    fill: the same sums in the same order.  Returns a line per check."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import stencil3d as s3

    lines = []
    coeffs = custom_coeffs()
    for name, kw, _, _, _ in CUSTOM_CASES:
        for dtype in ("float32", "df64")[:1 if kw else 2]:
            eng = engine.StencilEngine.for_coeffs(coeffs[name], INTERIOR if
                                                  coeffs[name].ndim == 2 else
                                                  INTERIOR_3D, name=name,
                                                  device=device, dtype=dtype,
                                                  **kw)
            spec, k, lay = eng.spec, eng._fused_k(), eng.layout
            kernel = custom_kernel(eng)[0]
            x = eng.to_internal(custom_fills(
                spec.padded_shape(eng.interior), device)[1])
            if spec.ndim == 3:
                if kernel not in ("march_kernel", "plan_march_kernel"):
                    continue
                other = "stencil3d_kernel"
                want = general_3d(x, spec, lay, k)
                got = s3.stencil3d_step(x, torch.zeros_like(x), spec, lay,
                                        fused_steps=k)
            elif kernel.startswith(("strip", "fused_strip", "plan_strip")):
                other = ("step_kernel<double>" if eng.df64 else
                         "step_kernel<float>") + (" fused" if k > 1 else "")
                want = torch.zeros_like(x)
                s2._launch("step", (x, want), spec, lay, k)
                got = s2.stencil2d_step(x, torch.zeros_like(x), spec, lay,
                                        fused_steps=k)
            else:
                continue
            same_bits(got, want, f"{kernel} {name} {dtype} vs {other}")
            lines.append(f"{kernel} on {name} {dtype} k={k} bit-equal to "
                         f"{other} (pi/100 fill)")
            del x, got, want
    return lines


def custom_timing(device, card):
    """Phase 22: one pass of each custom spec's kernel at the full size
    (the engine's layout and depth), its plain twin's, one library step
    (``F.conv2d`` / ``F.conv3d`` with the dense coefficients, in the dtype)
    and the pass's bound, in turns; and the whole-grid run of 64 steps at
    ``CUSTOM_RESIDENT``.  Returns {(spec, options, dtype): record}."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import stencil3d as s3

    gen = torch.Generator(device=device).manual_seed(0)
    coeffs = custom_coeffs()
    records = {}
    for name, kw, _, _, _ in CUSTOM_CASES:
        # df64 is one step a pass whatever the options
        for dtype in ("float32", "df64")[:1 if kw else 2]:
            S = coeffs[name]
            interior = INTERIOR if S.ndim == 2 else INTERIOR_3D
            eng = engine.StencilEngine.for_coeffs(S, interior, name=name,
                                                  device=device, dtype=dtype,
                                                  **kw)
            spec, k, lay = eng.spec, eng._fused_k(), eng.layout
            wrapper, plain = ((s3.stencil3d_step, s3.stencil3d_step_plain)
                              if S.ndim == 3 else
                              (s2.stencil2d_step, s2.stencil2d_step_plain))
            x = torch.rand(lay.shape, generator=gen, device=device,
                           dtype=eng.dtype) * 0.01
            ms = time_calls({
                "kernel": lambda a, b: wrapper(a, b, spec, lay,
                                               fused_steps=k)}, x,
                torch.zeros_like(x), 20)["kernel"]
            plain_ms = time_calls({
                "plain": lambda a, b: plain(a, b, spec, lay, k)}, x,
                torch.zeros_like(x), 3)["plain"]
            del x
            itemsize = eng.dtype.itemsize
            bound, by = bound_ms(spec, interior, k, itemsize)
            lib = library_ms(spec, interior, device, eng.dtype)
            rec = dict(kernel=custom_kernel(eng)[0], ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=lib,
                       steps_per_launch=k, library_steps=1,
                       shape=f"{dtype} {name} "
                             + "x".join(str(s) for s in interior))
            records[(name, tuple(kw.items()), dtype)] = rec
            print(f"phase 22: {rec['kernel']} at {rec['shape']} k={k}: "
                  f"{ms} ms ({bound / ms:.4f} of the bound {bound} ms, "
                  f"{by}), plain twin {plain_ms} ms, one library step {lib} "
                  f"ms [{card}]", flush=True)
    name, interior = CUSTOM_RESIDENT
    for dtype in ("float32", "df64"):
        eng = engine.StencilEngine.for_coeffs(coeffs[name], interior,
                                              name=name, device=device,
                                              dtype=dtype)
        if not eng._resident_2d():
            raise AssertionError(f"{name} {interior} {dtype}: no resident run")
        spec, lay = eng.spec, eng.layout
        x = torch.rand(lay.shape, generator=gen, device=device,
                       dtype=eng.dtype) * 0.01
        ms = in_turns({"kernel": lambda: s2.stencil2d_resident(
            x, spec, lay, FUSED_STEPS)})["kernel"]
        plain_ms = graph_ms(lambda: s2.stencil2d_resident_plain(
            x, spec, lay, FUSED_STEPS), 2)
        bound, by = bound_ms(spec, interior, FUSED_STEPS, eng.dtype.itemsize)
        rec = dict(kernel=custom_kernel(eng)[0], ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by,
                   library_ms=library_ms(spec, interior, device, eng.dtype),
                   steps_per_launch=FUSED_STEPS, library_steps=1,
                   shape=f"{dtype} {name} {interior[0]}x{interior[1]}")
        records[(name, "resident", dtype)] = rec
        print(f"phase 22: {rec['kernel']} at {rec['shape']} x{FUSED_STEPS}: "
              f"{ms} ms, plain twin {plain_ms} ms, one library step "
              f"{rec['library_ms']} ms, bound {bound} ms ({by}) [{card}]",
              flush=True)
        del x
    return records


def check_custom_resident(dtype, device):
    """Phase 22: the whole-grid run of ``CUSTOM_RESIDENT`` (one launch of
    the shared-memory resident kernel): the dyadic twin's run(2) bit for
    bit against the twins and the float64 dense stencil, run(4) of the spec
    within rel 1e-5 (of the magnitude stencil; df64 1e-13), and the
    adjoint's dot-product identity
    (its adjoint run is resident too).  Returns a record."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.utils import reference

    name, interior = CUSTOM_RESIDENT
    eng = engine.StencilEngine.for_coeffs(custom_coeffs()[name], interior,
                                          name=name, device=device,
                                          dtype=dtype)
    kernel = custom_kernel(eng)
    if kernel[0] != "resident_smem_kernel":
        raise AssertionError(f"{name} {interior} {dtype}: runs {kernel[0]}")
    deng = engine.StencilEngine(dyadic(eng.spec), interior, eng.config,
                                device=device)
    g01 = reference.random_padded(eng.spec, interior, seed=25) % 2
    out, launches2 = counted_run(deng, g01, 2, kernel)
    with twins():
        same_bits(out, deng.run(g01, 2), f"resident {name} dyadic vs twins")
    same_bits(out.double(), dense_truth(torch.from_numpy(g01).to(device),
                                        deng.spec, 2, "dirichlet0"),
              f"resident {name} dyadic vs float64")
    g1 = reference.random_padded(eng.spec, interior, seed=26) * (np.pi / 100)
    out, launches4 = counted_run(eng, g1, 4, kernel)
    want = dense_truth(torch.from_numpy(g1).to(device), eng.spec, 4,
                       "dirichlet0")
    abs_err = float((out.double() - want).abs().max())
    rel = abs_err / float(want.abs().max())
    if dtype == "float32":  # relative to the magnitude stencil, as above
        rel = abs_err / float(dense_truth(
            torch.from_numpy(np.abs(g1)).to(device), magnitude(eng.spec), 4,
            "dirichlet0").max())
    if not rel <= (1e-13 if dtype == "df64" else 1e-5):
        raise AssertionError(f"resident {name} {dtype}: rel err {rel:.3e}")
    dot = dot_identity(eng, device, kernel)
    return {"launches_2": launches2, "launches_4": launches4,
            "abs_err_4": abs_err, "rel_err_4": rel, **dot}


def dot_identity(eng, device, kernel=None):
    """The adjoint's dot-product identity in float64 on the card,
    |<run(x, 4), y> - <x, run_vjp(y, 4)>| / (|run(x, 4)| |y|), x and y from
    a seeded generator (in the engine's dtype), the adjoint's kernel
    launches counted from zero (``kernel``: the adjoint engine's,
    ``custom_kernel``; the reflect fold-back launches none); float32 also
    holds ``torch.autograd.grad`` of <run_diff(x, 4), y> equal to
    run_vjp(y, 4) bit for bit.  Raises past 1e-5 (df64 1e-12); returns a
    record, with the wall time of that run_vjp call (the first of its
    engine: the adjoint engine's set-up in it)."""
    shape = eng.spec.padded_shape(eng.interior)
    gen = torch.Generator(device=device).manual_seed(27)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    y = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    x, y = x.to(eng.dtype), y.to(eng.dtype)
    ax = eng.run(x, ADJOINT_STEPS).double()
    kernel = kernel or custom_kernel(eng.adjoint())
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aty = eng.run_vjp(y, ADJOINT_STEPS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    c = counts()
    launches = c[kernel[1]]
    if (launches == 0) != (eng.config.boundary == "reflect"):
        raise AssertionError(f"{eng.spec.name} {eng.config.dtype} "
                             f"{eng.config.boundary}: the adjoint launched "
                             f"{c}")
    lhs = float((ax * y.double()).sum())
    rhs = float((x.double() * aty.double()).sum())
    err = abs(lhs - rhs) / float(ax.norm() * y.double().norm())
    tol = 1e-12 if eng.df64 else 1e-5
    if not err <= tol:
        raise AssertionError(f"{eng.spec.name} {eng.config.dtype} "
                             f"{eng.config.boundary}: dot-product identity off"
                             f" by {err:.3e} > {tol}")
    rec = {"dot_err": err, "adjoint_kernel": kernel[0],
           "adjoint_launches": launches, "run_vjp_wall_ms": wall}
    if not eng.df64:
        xg = x.clone().requires_grad_()
        (grad,) = torch.autograd.grad(
            (eng.run_diff(xg, ADJOINT_STEPS) * y).sum(), xg)
        same_bits(grad, aty, f"{eng.spec.name} {eng.config.boundary} autograd "
                             f"vs run_vjp")
        rec["autograd_equals_run_vjp"] = True
    return rec


def adjoint_paths(device, card):
    """Phase 22: the adjoint of ``ADJOINT_SPEC`` at 8192^2 in float32 and
    df64, each boundary mode: ``dot_identity``, then one forward (run of 4
    steps), one backward (``run_vjp``) and one forward + backward (float32:
    ``run_diff`` and ``torch.autograd.grad``; df64, which ``run_diff``
    refuses: ``run`` then ``run_vjp``), each best of 3 after a warm-up,
    and the backward's parts: the adjoint engine's passes, and the last
    unmasked correlation (``torch_ref.conv_full``) or one fold-back step
    (of ``steps``), all on the card.  Returns the records."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import torch_ref
    from lorastencil_tpu_torch.utils import metrics, reference

    S = custom_coeffs()[ADJOINT_SPEC]
    records = []
    for dtype in ("float32", "df64"):
        for mode in ("dirichlet0", "periodic", "reflect"):
            eng = engine.StencilEngine.for_coeffs(S, INTERIOR,
                                                  name=ADJOINT_SPEC,
                                                  device=device, dtype=dtype,
                                                  boundary=mode)
            rec = {"spec": ADJOINT_SPEC, "dtype": dtype, "mode": mode,
                   "steps": ADJOINT_STEPS, "card": card,
                   **dot_identity(eng, device)}
            shape = eng.spec.padded_shape(INTERIOR)
            gen = torch.Generator(device=device).manual_seed(28)
            x = torch.rand(shape, generator=gen, device=device,
                           dtype=eng.dtype)
            y = torch.rand(shape, generator=gen, device=device,
                           dtype=eng.dtype)

            def ms(fn, *args):
                return metrics.time_run(fn, *args, repeats=3,
                                        warmup=1)[0] * 1e3

            rec["forward_ms"] = ms(eng.run, x, ADJOINT_STEPS)
            rec["backward_ms"] = ms(eng.run_vjp, y, ADJOINT_STEPS)
            if dtype == "float32":
                def both(v=x.clone().requires_grad_()):
                    return torch.autograd.grad(
                        (eng.run_diff(v, ADJOINT_STEPS) * y).sum(), v)
            else:
                def both():
                    return (eng.run(x, ADJOINT_STEPS),
                            eng.run_vjp(y, ADJOINT_STEPS))
            rec["forward_backward_ms"] = ms(both)
            adj = eng.adjoint()
            it = reference.interior_slices(eng.spec, shape)
            mg = torch.zeros_like(y)
            mg[it] = y[it]
            if mode != "reflect":
                passes = ADJOINT_STEPS - (mode == "dirichlet0")
                rec["adjoint_passes_ms"] = ms(adj.run, mg, passes)
            if mode == "dirichlet0":
                rec["conv_full_ms"] = ms(torch_ref.conv_full, mg, adj.spec)
            elif mode == "reflect":  # one of the fold-back steps
                rec["fold_step_ms"] = ms(engine._fold_adjoint_step, y[it],
                                         eng.spec.flipped())
            del x, y, mg
            records.append(rec)
            line = {k: v for k, v in rec.items() if k != "card"}
            print(f"phase 22: adjoint {ADJOINT_SPEC} 8192^2 {dtype} {mode}: "
                  f"{json.dumps(line)} [{card}]", flush=True)
    return records


def inverse_source(device, card):
    """Phase 22: ``examples/torch_inverse_source.py``'s problem at 8192^2
    (periodic, the 3x3 stencil, two hot spots, 4 steps), ``INVERSE_ITERATIONS``
    gradient-descent iterations through ``run_diff`` and autograd; the loss
    must fall at every iteration (lr 0.45 is below 2/L), the fused strip
    kernel counted forward and back.  Returns a record."""
    from examples import torch_inverse_source as example

    eng, _, y_obs = example.problem(INTERIOR, device)
    kernel = custom_kernel(eng)
    losses = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    example.descend(eng, y_obs, INVERSE_ITERATIONS,
                    on_step=lambda i, loss, x: losses.append(loss))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / INVERSE_ITERATIONS
    c = counts()
    losses = [float(v) for v in losses]
    if any(b >= a for a, b in zip(losses, losses[1:])) or not all(
            np.isfinite(losses)):
        raise AssertionError(f"inverse source: the loss did not fall at "
                             f"every iteration: {losses}")
    passes = 2 * INVERSE_ITERATIONS * (example.STEPS // eng._fused_k())
    if c[kernel[1]] != passes:
        raise AssertionError(f"inverse source: {kernel[0]} launched "
                             f"{c[kernel[1]]} times, not {passes}: {c}")
    rec = {"iterations": INVERSE_ITERATIONS, "ms_per_iteration": ms,
           "loss_first": losses[0], "loss_last": losses[-1],
           "kernel": kernel[0], "launches": c[kernel[1]], "card": card}
    print(f"phase 22: inverse source 8192^2 periodic, {INVERSE_ITERATIONS} "
          f"iterations: loss {losses[0]:.6e} -> {losses[-1]:.6e}, falling at "
          f"every iteration; {ms} ms an iteration (wall); {kernel[0]} "
          f"{c[kernel[1]]} launches [{card}]", flush=True)
    return rec


def custom_paths(device, card):
    """Phase 22: every case of ``CUSTOM_CASES`` in both dtypes and its modes
    (``check_custom``), the redesigned kernels against the ones they replace
    on the custom plans, the whole-grid custom run and its adjoint, the
    adjoint at 8192^2 and the inverse-source loop.  Returns the records."""
    out = {"cases": [], "resident": {}, "seconds": {}}
    t0 = time.perf_counter()
    for name, kw, (terms, residue), kernels, modes in CUSTOM_CASES:
        for dtype, expect in zip(("float32", "df64"), kernels):
            if expect is None:
                continue
            for mode in modes:
                rec = check_custom(name, kw, dtype, mode, device,
                                   expect.get(mode) if isinstance(expect, dict)
                                   else expect)
                if (rec["terms"], rec["residue"]) != (terms, residue):
                    raise AssertionError(f"{name}: {rec['terms']} terms, "
                                         f"{rec['residue']} residue points")
                out["cases"].append(rec)
                run2 = ("bit-exact against the twins" if dtype == "df64"
                        else f"off float64 by {rec['abs_err_2']:.3e}, the "
                             f"twins by {rec['twin_abs_err_2']:.3e}")
                print(f"phase 22: {name} {kw or ''} {dtype} {mode}: "
                      f"{rec['terms']} terms, {rec['residue']} residue "
                      f"points, k={rec['k']}, {rec['kernel']}; dyadic run(2)"
                      f" bit-exact against the twins and float64 "
                      f"({rec['launches_dyadic_2']} launches); run(2) {run2}"
                      f" (cells equal to the twins' "
                      f"{rec['twin_equal_share_2']:.6f}), "
                      f"{rec['launches_2']} launches; run(4) rel err "
                      f"{rec['rel_err_4']:.3e}"
                      + (f" ({rec['rel_err_4_magnitude']:.3e} of the "
                         f"magnitude stencil)" if dtype == "float32" else "")
                      + f", {rec['launches_4']} launches; "
                        f"{rec['seconds']:.1f} s", flush=True)
    for line in check_custom_kernels(device):
        print(f"phase 22: {line}", flush=True)
    for dtype in ("float32", "df64"):
        out["resident"][dtype] = check_custom_resident(dtype, device)
        print(f"phase 22: resident {CUSTOM_RESIDENT[0]} "
              f"{CUSTOM_RESIDENT[1]} {dtype}: "
              f"{json.dumps(out['resident'][dtype])}", flush=True)
    t1 = time.perf_counter()
    out["adjoint"] = adjoint_paths(device, card)
    t2 = time.perf_counter()
    out["inverse_source"] = inverse_source(device, card)
    out["seconds"] = {"cases": t1 - t0, "adjoint": t2 - t1,
                      "inverse_source": time.perf_counter() - t2}
    print(f"phase 22: seconds {json.dumps(out['seconds'])}", flush=True)
    return out


def custom_kernel_entries(custom):
    """Phase 22's entries of the kernels' record: each custom spec's kernel,
    its launches and max abs err from the dirichlet0 run(4) of
    ``check_custom`` (the resident run's from ``check_custom_resident``),
    its times from ``custom_timing``."""
    entries = []
    for (name, options, dtype), t in custom["timing"].items():
        if options == "resident":
            rec = custom["resident"][dtype]
            wrapper = ("stencil2d_resident" if dtype == "float32"
                       else "stencil2d_resident_pair")
            label = f"{wrapper}[custom {name} {t['shape'].split()[-1]}]"
            source = "resident2d"
        else:
            rec = next(r for r in custom["cases"] if r["spec"] == name
                       and r["options"] == dict(options)
                       and r["dtype"] == dtype and r["mode"] == "dirichlet0")
            dims = 3 if name in ("separable-z", "per-plane") else 2
            wrapper = {(2, "float32"): "stencil2d", (2, "df64"): "df64_step",
                       (3, "float32"): "stencil3d",
                       (3, "df64"): "df64_3d_step"}[(dims, dtype)]
            k = t["steps_per_launch"]
            label = (("stencil2d_step" if wrapper == "stencil2d" else
                      "stencil3d_step" if wrapper == "stencil3d" else wrapper)
                     + f"[{'k=2, ' if k == 2 and dims == 2 else ''}custom "
                       f"{name}]")
            source = ("plan3d" if t["kernel"].startswith("plan_march")
                      else "plan2d" if t["kernel"].startswith("plan_strip")
                      else "stencil3d" if dims == 3 else "stencil2d")
        entries.append(dict({
            "name": label, "route": "cuda", "source": SOURCES[source],
            "replaces": REPLACES[wrapper], "launches": rec["launches_4"],
            "max_abs_err": rec["abs_err_4"]}, **t))
    return entries


# Phase 23: the bfloat16 state tier in 2-D (ROADMAP A6(c)): the bf16 instances
# of TPU kernels #1-#3; and the repairs C3 (a 2-D radius above 16, up to 128:
# the wide kernel past the tile kernel's shared memory) and C4 (a 3-D
# radius-0 spec: the general kernel's radius-0 instances).
BF16 = torch.bfloat16
# Each bf16 instance's check cases: (kernel, spec, interior, k or "run",
# the wrapper of the pass, the counter its launches count in besides the
# wrapper's launches_bf16; None: a tile kernel's, which counts in none of
# STRIP_COUNTERS).  "5x5 asym" is phase 22's custom spec.
BF16_CHECKS = (
    ("strip_kernel<bf16>", "star2d1r", INTERIOR, 1, "step", "stencil2d_k1"),
    ("strip_kernel<bf16>", "box2d3r", INTERIOR, 1, "step", "stencil2d_k1"),
    ("fused_strip_kernel<bf16>", "star2d3r", INTERIOR, 2, "step",
     "stencil2d_fused_strip"),
    ("fused_strip_kernel<bf16>", "star2d3r", INTERIOR, 2, "skew",
     "stencil2d_skew_fused_strip"),
    ("plan_strip_kernel<bf16>", "star2d1r", (1000, 1000), 3, "step",
     "stencil2d_plan_strip"),
    ("plan_strip_kernel<bf16>", "5x5 asym", INTERIOR, 2, "step",
     "stencil2d_plan_strip"),
    ("step_kernel<bf16> fused", "star2d1r", (1000, 1000), 5, "step", None),
    ("step_kernel<bf16>", "custom_r9", (1000, 1000), 1, "step", None),
    ("skew_kernel<bf16>", "star2d1r", INTERIOR, 5, "skew", None),
    ("resident_smem_kernel<bf16>", "star2d1r", SMALL_2D, "run", None,
     "stencil2d_resident_smem"),
    ("resident_kernel<bf16>", "custom_r5", R5_2D, "run", None, None))
# The bf16 paths through StencilEngine's default dispatch, each counted from
# zero: (kernel, spec, interior, engine options, steps of the counted run,
# the counter, its launches, the counters that stay zero).  custom_r5's bf16
# 'auto' is 'mxu_hybrid' (one term, no residue): k = 2 and no whole-grid run,
# so its paths name k = 1 and 'vpu_roll'.  The tile kernels' cases take what
# the strip walk leaves them (phase 29): a pass deeper than 4, radius 9.
BF16_PATHS = (
    ("strip_kernel<bf16>", "star2d1r", INTERIOR, {}, BENCH_STEPS,
     "stencil2d_k1", BENCH_STEPS, ("stencil2d_fused_strip",)),
    ("fused_strip_kernel<bf16>", "star2d3r", INTERIOR, {}, FUSED_STEPS,
     "stencil2d_fused_strip", FUSED_STEPS // 2, ("stencil2d_k1",)),
    ("plan_strip_kernel<bf16>", "star2d1r", INTERIOR, {"fused_steps": 3}, 6,
     "stencil2d_plan_strip", 2, ("stencil2d_k1", "stencil2d_fused_strip")),
    ("step_kernel<bf16> fused", "star2d1r", INTERIOR, {"fused_steps": 5}, 10,
     "stencil2d_bf16", 2, ("stencil2d_k1", "stencil2d_fused_strip",
                           "stencil2d_plan_strip")),
    ("step_kernel<bf16>", "custom_r9", INTERIOR, {"fused_steps": 1}, 4,
     "stencil2d_bf16", 4,
     ("stencil2d_k1", "stencil2d_fused_strip", "stencil2d_plan_strip",
      "stencil2d_wide")),
    ("skew_kernel<bf16>", "star2d1r", INTERIOR,
     {"fusion": "skew", "fused_steps": 5}, 10, "stencil2d_skew_bf16", 2,
     ("stencil2d_skew_fused_strip", "stencil2d_skew_plan_strip",
      "stencil2d_skew_k1")),
    ("resident_smem_kernel<bf16>", "star2d1r", SMALL_2D, {}, FUSED_STEPS,
     "stencil2d_resident_smem", 1, ("stencil2d_bf16",)),
    ("resident_kernel<bf16>", "custom_r5", R5_2D, {"algorithm": "vpu_roll"},
     FUSED_STEPS,
     "stencil2d_resident_bf16", 1, ("stencil2d_resident_smem",
                                    "stencil2d_bf16")))
# the counters of the other dtypes, which no bf16 run may add to
NOT_BF16 = ("stencil2d", "df64_step", "stencil2d_skew", "stencil2d_skew_f64",
            "stencil2d_resident", "stencil2d_resident_pair")
# the counters of the strip kernels' launches and the wide kernel's, which a
# tile kernel's launch leaves as they are
STRIP_COUNTERS = ("stencil2d_k1", "stencil2d_fused_strip",
                  "stencil2d_plan_strip", "stencil2d_wide")
# C3's crosses: radius, interior, dtype, the counter of its passes' kernel
C3_CASES = ((17, INTERIOR, "float32", "stencil2d"),
            (64, INTERIOR, "float32", "stencil2d_wide"),
            (17, INTERIOR, "float64", "df64_step"),
            (64, INTERIOR, "float64", "stencil2d_wide"))


def bf16_spec(name):
    """A registry shape, a spec of ``reach_spec`` (``custom_r5``,
    ``custom_r9``, ...) or phase 22's custom array's spec."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape

    if reach_spec(name) is not None:
        return reach_spec(name)
    if name in custom_coeffs():
        return engine.StencilEngine.for_coeffs(custom_coeffs()[name], (8, 8),
                                               name=name, device="cpu").spec
    return get_shape(name)


def bf16_check(kernel, name, interior, k, kind, counter, device):
    """Phase 23: one bf16 kernel instance against its bf16 twin, bit for bit
    on the integer fill (a custom spec's dyadic twin on the 0/1 fill) at 1
    and 2 steps; on a uniform fill in [0, 0.01) bit for bit against the
    float32 instance's pass of the widened input, rounded to bf16 (a run:
    against bf16 single steps, since it rounds every step), and against the
    twin within one bf16 ulp of the largest value (the kernels fuse
    multiply-adds, the twin rounds each product, which can move a
    rounding); each launch counted.  Returns the max abs err against the
    twin on the uniform fill."""
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops.layout import (Layout2D, default_tile_2d,
                                                  guard_2d)
    from lorastencil_tpu_torch.utils import reference

    real = bf16_spec(name)
    depth = 1 if k == "run" else k
    wrapper = {"step": s2.stencil2d_step, "skew": s2.stencil2d_skew_step,
               None: s2.stencil2d_resident}[kind]
    plain = (s2.stencil2d_resident_plain if k == "run"
             else s2.stencil2d_step_plain)
    wrapper_bf16 = {"step": "stencil2d_bf16", "skew": "stencil2d_skew_bf16",
                    None: "stencil2d_resident_bf16"}[kind]

    def one(x, spec, lay, steps=2):
        if k == "run":
            return wrapper(x, spec, lay, steps)
        kw = {"fused_steps": k} if kind == "step" else {"skew_steps": k}
        return wrapper(x, torch.zeros_like(x), spec, lay, **kw)

    def twin(x, spec, lay, steps=2):
        if k == "run":
            return plain(x, spec, lay, steps)
        return plain(x, torch.zeros_like(x), spec, lay, k)

    for spec, fill in ((dyadic(real) if name in custom_coeffs() else real,
                        "integer"), (real, "uniform")):
        lay = Layout2D(interior=interior, halo=spec.halo,
                       tile=default_tile_2d(*interior),
                       guard=guard_2d(spec.halo, depth * spec.radius))
        if fill == "integer":
            g0 = reference.random_padded(spec, interior, seed=23)
            if name in custom_coeffs():
                g0 = g0 % 2
            x = lay.to_internal(g0, BF16, device)
            for steps in (1, 2):
                if k == "run":
                    got, want = one(x, spec, lay, steps), twin(x, spec, lay,
                                                               steps)
                else:
                    got = run_steps(lambda c, d, s, ly, **kw: one(c, s, ly),
                                    x, spec, lay, steps * depth, depth)
                    want = run_steps(lambda c, d, s, ly, **kw: twin(c, s, ly),
                                     x, spec, lay, steps * depth, depth)
                same_bits(got, want, f"{kernel} {name} {interior} integer "
                                     f"fill, {steps} passes")
            del x
            continue
        gen = torch.Generator(device=device).manual_seed(23)
        x = (torch.rand(lay.shape, generator=gen, device=device)
             * 0.01).to(BF16)
        reset_counts()
        got = one(x, spec, lay, 4)
        torch.cuda.synchronize()
        c = counts()
        if c[wrapper_bf16] != 1 or any(c[n] for n in NOT_BF16) or (
                c[counter] != 1 if counter
                else any(c[n] for n in STRIP_COUNTERS)):
            raise AssertionError(f"{kernel} {name}: launched {c}")
        if k == "run":
            want = run_steps(s2.stencil2d_step, x, spec, lay, 4)
        else:
            f32 = x.float()
            kw = {"fused_steps": k} if kind == "step" else {"skew_steps": k}
            want = wrapper(f32, torch.zeros_like(f32), spec, lay, **kw).to(BF16)
        same_bits(got, want, f"{kernel} {name} {interior} against the float32 "
                             f"instance, rounded")
        if name == "star2d3r" and k == 2:  # the tile-based kernels it serves
            for launch in ("step", "skew"):
                out = torch.zeros_like(x)
                s2._launch(launch, (x, out), spec, lay, 2)
                same_bits(out, got, f"bf16 {launch} kernel at star2d3r k=2")
        ref = twin(x, spec, lay, 4)
        err = (got.double() - ref.double()).abs().max().item()
        if not err <= 2.0 ** -7 * ref.double().abs().max().item():
            raise AssertionError(f"{kernel} {name}: {err} from the twin")
        del x, got, want, ref
        return err


def bf16_engine(name, interior, device, **kw):
    from lorastencil_tpu_torch import engine

    if reach_spec(name) is not None:
        return engine.StencilEngine(reach_spec(name), interior,
                                    engine._config(dict(kw, dtype="bfloat16")),
                                    device=device)
    return engine.StencilEngine.for_shape(name, interior, device=device,
                                          dtype="bfloat16", **kw)


def bf16_paths(device):
    """Phase 23: each bf16 path through StencilEngine's default dispatch:
    run(2) of the integer fill bit for bit against the same engine with the
    plain twins (``twins``); the counted run of BF16_PATHS' steps, launches
    counted from zero: only bf16 instances, the path's kernel as many times
    as its passes; returns {kernel: launches}."""
    from lorastencil_tpu_torch.utils import reference

    launches = {}
    for kernel, name, interior, kw, steps, counter, n, zero in BF16_PATHS:
        eng = bf16_engine(name, interior, device, **kw)
        g0 = reference.random_padded(eng.spec, interior, seed=31)
        got = eng.run(g0, 2)
        with twins():
            want = eng.run(g0, 2)
        same_bits(got, want, f"{kernel} path {name} run(2)")
        if not bool(torch.isfinite(got).all()) or got.dtype != BF16:
            raise AssertionError(f"{kernel} path: {got.dtype}, not finite")
        state = eng.to_internal(g0 * 1e-3)
        reset_counts()
        out = eng.run_internal(state, steps)
        torch.cuda.synchronize()
        c = counts()
        if c[counter] != n or any(c[z] for z in zero + NOT_BF16):
            raise AssertionError(f"{kernel} path {name} x{steps}: {c}")
        launches[kernel] = c[counter]
        print(f"phase 23: bf16 {name} {interior} {kw or ''}: run(2) bit-exact "
              f"against the twins; x{steps}: {n} launches of {kernel} "
              f"({counter}), none of a float32 or float64 instance; output "
              f"{out.dtype}", flush=True)
        del state, out
    return launches


def bf16_timing(device, card):
    """Phase 23: star2d1r 8192^2 x 256 and star2d3r 8192^2 x 64 through
    run_internal in bf16 and float32, in turns; per bf16 instance one pass's
    (or a run's) device time, its twin's, one F.conv2d in bf16 and the
    bound at 2-byte cells.  Returns {kernel: record}."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    for name, steps in (("star2d1r", BENCH_STEPS), (FUSED_SHAPE, FUSED_STEPS)):
        engs = {dt: engine.StencilEngine.for_shape(name, INTERIOR,
                                                   device=device, dtype=dt)
                for dt in ("float32", "bfloat16")}
        states = {dt: (torch.rand(e.layout.shape, generator=gen, device=device)
                       * 0.01).to(e.dtype) for dt, e in engs.items()}
        ms = {}
        for dt in ("float32", "bfloat16", "bfloat16", "float32"):
            secs, _ = metrics.time_run(engs[dt].run_internal, states[dt],
                                       steps, repeats=3, warmup=1)
            ms[dt] = min(ms.get(dt, float("inf")), secs * 1e3)
        step = {}
        for dt, e in engs.items():
            x = states[dt]
            k = e._fused_k()
            step[dt] = time_calls({"kernel": lambda a, b: s2.stencil2d_step(
                a, b, e.spec, e.layout, fused_steps=k)}, x,
                torch.zeros_like(x), 20)["kernel"]
        launches = {}
        for dt, e in engs.items():
            reset_counts()
            e.run_internal(states[dt], steps)
            torch.cuda.synchronize()
            c = counts()
            launches[dt] = {n: v for n, v in c.items() if v}
        del states
        k = engs["bfloat16"]._fused_k()
        spec = engs["bfloat16"].spec
        b16, by16 = bound_ms(spec, INTERIOR, k, 2)
        b32, by32 = bound_ms(spec, INTERIOR, k, 4)
        lib16 = library_ms(spec, INTERIOR, device, BF16)
        lib32 = library_ms(spec, INTERIOR, device, torch.float32)
        print(f"phase 23: {name} {INTERIOR[0]}x{INTERIOR[1]} x{steps} "
              f"(k={k}) through run_internal, in turns: bf16 "
              f"{ms['bfloat16']} ms, float32 {ms['float32']} ms "
              f"({ms['float32'] / ms['bfloat16']:.4f}x); one pass: bf16 "
              f"{step['bfloat16']} ms ({b16 / step['bfloat16']:.4f} of its "
              f"{b16} ms {by16} bound at 2-byte cells), float32 "
              f"{step['float32']} ms ({b32 / step['float32']:.4f} of "
              f"{b32} ms {by32}); one F.conv2d step: bf16 {lib16} ms, "
              f"float32 {lib32} ms; launches {launches} [{card}]", flush=True)
    records = {}
    for kernel, name, interior, kw, _, _, _, _ in BF16_PATHS:
        eng = bf16_engine(name, interior, device, **kw)
        spec, lay, k = eng.spec, eng.layout, eng._fused_k()
        x = (torch.rand(lay.shape, generator=gen, device=device)
             * 0.01).to(BF16)
        if eng._resident_2d():
            steps = FUSED_STEPS
            t = in_turns({"kernel": lambda: s2.stencil2d_resident(
                x, spec, lay, steps)})["kernel"]
            plain = graph_ms(lambda: s2.stencil2d_resident_plain(
                x, spec, lay, steps), 2)
        else:
            steps = k
            skew = kw.get("fusion") == "skew"
            fn = (lambda a, b: s2.stencil2d_skew_step(a, b, spec, lay,
                                                      skew_steps=k)) if skew \
                else (lambda a, b: s2.stencil2d_step(a, b, spec, lay,
                                                     fused_steps=k))
            t = time_calls({"kernel": fn}, x, torch.zeros_like(x),
                           20)["kernel"]
            plain = time_calls({"plain": lambda a, b: s2.stencil2d_step_plain(
                a, b, spec, lay, k)}, x, torch.zeros_like(x), 3)["plain"]
        bound, by = bound_ms(spec, interior, steps, 2)
        lib = library_ms(spec, interior, device, BF16)
        records[kernel] = dict(
            kernel=kernel, ms=t, plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=lib, steps_per_launch=steps, library_steps=1,
            shape=f"bfloat16 {name} {interior[0]}x{interior[1]}")
        print(f"phase 23: {kernel} at bf16 {name} {interior} {kw or ''} "
              f"({steps} steps a launch): {t} ms ({bound / t:.4f} of its "
              f"{bound} ms {by} bound at 2-byte cells), plain twin {plain} ms, "
              f"one F.conv2d bf16 step {lib} ms [{card}]", flush=True)
        del x
    return records


def c3_cross(radius):
    S = np.zeros((2 * radius + 1,) * 2)
    S[radius, :] = S[:, radius] = 1.0
    return S


def c3_dense(radius):
    """The cross as residue points alone: the dense stencil of its 4r + 1
    taps (the engine's decomposition leaves ~1e-17 off the cross, which a
    dense step would sum over every one of the (2r + 1)^2 offsets)."""
    from lorastencil_tpu_torch.models.shapes import StencilSpec

    S = c3_cross(radius)
    return StencilSpec(
        name=f"cross r{radius} dense", ndim=2, radius=radius,
        halo=(radius, radius), terms=(),
        residue=tuple(((int(i) - radius, int(j) - radius), 1.0)
                      for i, j in np.argwhere(S != 0)), fuse_factor=1)


def c3_paths(device, card):
    """Phase 23, ROADMAP C3: ``for_coeffs`` crosses of radius 17 and 64 at
    8192^2 in float32 and float64: run(2) against the same engine with the
    plain twins (float64 bit for bit, float32 rel 1e-5: the kernels fuse
    multiply-adds) and run(3) within rel 1e-5 (float64 1e-13) of a float64
    dense stencil on the card, launches counted from zero; the wide kernel's
    step timed beside its twin, F.conv2d and its bound.  Returns the wide
    kernel's records and max abs errs."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.utils import reference

    gen = torch.Generator(device=device).manual_seed(0)
    records = {}
    for radius, interior, dtype, counter in C3_CASES:
        eng = engine.StencilEngine.for_coeffs(c3_cross(radius), interior,
                                              name=f"cross r{radius}",
                                              device=device, dtype=dtype)
        spec, k, lay = eng.spec, eng._fused_k(), eng.layout
        g0 = reference.random_padded(spec, interior, seed=17) * (np.pi / 100)
        reset_counts()
        got = eng.run(g0, 2)
        torch.cuda.synchronize()
        c = counts()
        passes = -(-2 // k) * (2 if counter == "stencil2d_wide" and k == 2
                               else 1)
        if c[counter] != passes or c["stencil2d_k1"]:
            raise AssertionError(f"C3 r{radius} {dtype}: launched {c}")
        with twins():
            want = eng.run(g0, 2)
        tol = 1e-5 if dtype == "float32" else 0.0
        err = rel_err(got.double(), want.double())
        if not err <= tol:
            raise AssertionError(f"C3 r{radius} {dtype}: {err} from the twins")
        truth = dense_truth(torch.from_numpy(g0).to(device), c3_dense(radius),
                            3, "dirichlet0")
        got3 = eng.run(g0, 3)
        err3 = rel_err(got3.double(), truth)
        if not err3 <= (1e-5 if dtype == "float32" else 1e-13):
            raise AssertionError(f"C3 r{radius} {dtype}: rel {err3} after 3")
        abs_err = (got3.double() - truth).abs().max().item()
        del got, want, truth, got3
        line = (f"phase 23: C3 for_coeffs cross r={radius} {dtype} "
                f"{interior[0]}x{interior[1]} (k={k}): run(2) against the "
                f"twins rel {err}, run(3) rel {err3} of the float64 dense "
                f"stencil; {c[counter]} launches ({counter})")
        if counter == "stencil2d_wide":
            x = torch.rand(lay.shape, generator=gen, device=device,
                           dtype=eng.dtype) * 0.01
            t = time_calls({"kernel": lambda a, b: s2.stencil2d_step(
                a, b, spec, lay)}, x, torch.zeros_like(x), 3)["kernel"]
            plain = time_calls({"plain": lambda a, b: s2.stencil2d_step_plain(
                a, b, spec, lay)}, x, torch.zeros_like(x), 1)["plain"]
            del x
            itemsize = eng.dtype.itemsize
            bound, by = bound_ms(spec, interior, 1, itemsize)
            # a 129 x 129 cuDNN convolution at 8192^2 takes seconds (16.8 s
            # in float64): one timed call
            lib = library_ms(spec, interior, device, eng.dtype, repeats=1)
            records[dtype] = dict(
                kernel=f"wide_step_kernel<{'double' if itemsize == 8 else 'float'}>",
                ms=t, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, steps_per_launch=1, library_steps=1,
                shape=f"{dtype} cross r{radius} {interior[0]}x{interior[1]}",
                launches=c[counter], max_abs_err=abs_err)
            line += (f"; one step {t} ms ({bound / t:.4f} of its {bound} ms "
                     f"{by} bound), plain twin {plain} ms, one F.conv2d "
                     f"{lib} ms")
        print(line + f" [{card}]", flush=True)
    return records


def c4_paths(device, card):
    """Phase 23, ROADMAP C4: ``for_coeffs`` of the radius-0 3-D spec
    [[[0.75]]] at 256^3 in float32, float64 and df64 and every boundary:
    k = 2 (df64: 1), run(3) bit for bit against a float64 dense stencil on
    the card (0.75 is dyadic), the general kernel's launches counted from
    zero (none of the march kernel); its float32 pass timed.  Returns the
    record of the pass and its max abs err."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil3d as s3
    from lorastencil_tpu_torch.utils import reference

    S = np.array([[[0.75]]])
    rec = None
    for dtype in ("float32", "float64", "df64"):
        for mode in ("dirichlet0",) + GHOST_MODES:
            eng = engine.StencilEngine.for_coeffs(S, INTERIOR_3D, name="r0",
                                                  device=device, dtype=dtype,
                                                  boundary=mode)
            k = eng._fused_k()
            if k != (1 if dtype == "df64" else 2):
                raise AssertionError(f"C4 {dtype}: k = {k}")
            g0 = reference.random_padded(eng.spec, INTERIOR_3D, seed=4)
            reset_counts()
            got = eng.run(g0, 3)
            torch.cuda.synchronize()
            c = counts()
            general = c["stencil3d"] + c["df64_3d_step"]
            if general != -(-3 // k) or c["stencil3d_march"]:
                raise AssertionError(f"C4 {dtype} {mode}: launched {c}")
            want = dense_truth(torch.from_numpy(g0).to(device), eng.spec, 3,
                               mode)
            if not torch.equal(got.double(), want):
                raise AssertionError(f"C4 {dtype} {mode}: differs")
            print(f"phase 23: C4 radius-0 3-D spec {dtype} {mode} "
                  f"{'x'.join(map(str, INTERIOR_3D))} "
                  f"(k={k}): run(3) bit-exact against the float64 dense "
                  f"stencil, {general} launches of the general kernel", flush=True)
            if dtype == "float32" and mode == "dirichlet0":
                gen = torch.Generator(device=device).manual_seed(0)
                lay, spec = eng.layout, eng.spec
                x = torch.rand(lay.shape, generator=gen, device=device) * 0.01
                t = time_calls({"kernel": lambda a, b: s3.stencil3d_step(
                    a, b, spec, lay, fused_steps=2)}, x, torch.zeros_like(x),
                    20)["kernel"]
                plain = time_calls({"plain": lambda a, b: s3.stencil3d_step_plain(
                    a, b, spec, lay, 2)}, x, torch.zeros_like(x), 3)["plain"]
                del x
                bound, by = bound_ms(spec, INTERIOR_3D, 2, 4)
                lib = library_ms(spec, INTERIOR_3D, device)
                rec = dict(kernel="stencil3d_kernel<float, 0>", ms=t,
                           plain_ms=plain, bound_ms=bound, bound_by=by,
                           library_ms=lib, steps_per_launch=2, library_steps=1,
                           shape="float32 radius 0 "
                                 + "x".join(map(str, INTERIOR_3D)),
                           launches=general,
                           max_abs_err=0.0)
                print(f"phase 23: C4 general kernel radius 0, k=2 pass at "
                      f"{'x'.join(map(str, INTERIOR_3D))}: {t} ms "
                      f"({bound / t:.4f} of its {bound} ms {by} "
                      f"bound), plain twin {plain} ms, one F.conv3d 1x1x1 "
                      f"{lib} ms [{card}]", flush=True)
    return rec


def bf16_phase(device, card):
    """Phase 23; returns the kernels' record entries."""
    errs = {}
    for kernel, name, interior, k, kind, counter in BF16_CHECKS:
        err = bf16_check(kernel, name, interior, k, kind, counter, device)
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        print(f"phase 23: {kernel} {name} {interior} "
              f"{'run' if k == 'run' else f'k={k}'}{' skew' if kind == 'skew' else ''}: "
              f"bit-exact against its bf16 twin on the integer fill at 1-2 "
              f"passes, against the float32 instance rounded on a uniform "
              f"fill; max abs err against the twin {err}", flush=True)
    launches = bf16_paths(device)
    timing = bf16_timing(device, card)
    wide = c3_paths(device, card)
    r0 = c4_paths(device, card)
    replaces = {"skew_kernel<bf16>": "stencil2d_skew",
                "resident_smem_kernel<bf16>": "stencil2d_resident",
                "resident_kernel<bf16>": "stencil2d_resident"}
    entries = []
    for kernel, name, interior, kw, _, _, _, _ in BF16_PATHS:
        t = timing[kernel]
        wrapper = ("stencil2d_skew_step" if "skew" in kernel else
                   "stencil2d_resident" if "resident" in kernel else
                   "stencil2d_step")
        entries.append(dict({
            "name": f"{wrapper}[bf16 {name} {interior[0]}x{interior[1]}"
                    f"{' k=' + str(t['steps_per_launch']) if 'resident' not in kernel else ''}]",
            "route": "cuda",
            "source": SOURCES["resident2d" if "smem" in kernel
                              else "plan2d_bf16" if "plan_strip" in kernel
                              else "stencil2d"],
            "replaces": REPLACES[replaces.get(kernel, "stencil2d")],
            "launches": launches[kernel], "max_abs_err": errs[kernel]}, **t))
    for dtype, rec in wide.items():
        rec = dict(rec)
        entries.append(dict({
            "name": f"stencil2d_step[wide {rec['shape']}]", "route": "cuda",
            "source": SOURCES["stencil2d"],
            "replaces": REPLACES["stencil2d" if dtype == "float32"
                                 else "df64_step"],
            "launches": rec.pop("launches"),
            "max_abs_err": rec.pop("max_abs_err")}, **rec))
    rec = dict(r0)
    entries.append(dict({
        "name": f"stencil3d_step[radius 0 {rec['shape'].split()[-1]}]",
        "route": "cuda",
        "source": SOURCES["stencil3d"], "replaces": REPLACES["stencil3d"],
        "launches": rec.pop("launches"), "max_abs_err": rec.pop("max_abs_err")},
        **rec))
    return entries


# Phase 24: the bfloat16 state tier in 1-D and 3-D (ROADMAP A6(c)): the bf16
# instances of TPU kernels #4-#8.  Each instance's check cases: (kernel, shape,
# size, k or "run", the wrapper).  The general 3-D kernel's: star3d1r at k = 4,
# which the march kernel does not take.
BF16_CHECKS_1D3D = (
    ("wide_kernel<bf16>", "1d2r", (N_1D,), 2, "stencil1d_step"),
    ("wide_kernel<bf16>", "r40", (100_000,), 1, "stencil1d_step"),
    ("lanes_kernel<bf16>", "1d2r", (N_1D_LARGE,), 3, "stencil1d_lanes_step"),
    ("lanes_kernel<bf16>", "1d1r", (N_1D,), 4, "stencil1d_lanes_step"),
    ("run_kernel<bf16> narrow", "1d1r", (N_1D_SMALL,), "run",
     "stencil1d_resident_lanes"),
    ("run_kernel<bf16> narrow", "1d2r", (N_1D,), "run",
     "stencil1d_resident_lanes"),
    ("run_kernel<bf16> wide", "1d1r", (N_1D_SMALL,), "run",
     "stencil1d_resident"),
    ("march_kernel<bf16>", "star3d1r", INTERIOR_3D, 2, "stencil3d_step"),
    ("march_kernel<bf16>", "box3d1r", INTERIOR_3D, 2, "stencil3d_step"),
    ("stencil3d_kernel<bf16>", "star3d1r", INTERIOR_3D, 4, "stencil3d_step"))
# The bf16 paths through StencilEngine's default dispatch, each counted from
# zero: (kernel, shape, size, engine options, steps of the counted run, the
# counter, its launches).  1d2r 1,000,000 in bf16 is one narrow run (its
# 2,003,072-byte state is under the 2 MiB cap), and with 'vpu' the wide
# passes at k = 1 (a bf16 state fuses one step off 'mxu').
BF16_PATHS_1D3D = (
    ("lanes_kernel<bf16>", "1d2r", (N_1D_LARGE,), {}, BENCH_STEPS,
     "stencil1d_lanes_step_bf16", -(-BENCH_STEPS // 3)),
    ("run_kernel<bf16> narrow", "1d1r", (N_1D_SMALL,), {}, 64,
     "stencil1d_resident_lanes_bf16", 1),
    ("run_kernel<bf16> narrow", "1d2r", (N_1D,), {}, BENCH_STEPS,
     "stencil1d_resident_lanes_bf16", 1),
    ("wide_kernel<bf16>", "1d2r", (N_1D,), {"algorithm": "vpu"}, 16,
     "stencil1d_step_bf16", 16),
    ("run_kernel<bf16> wide", "1d1r", (N_1D_SMALL,), {"algorithm": "vpu"}, 64,
     "stencil1d_resident_bf16", 1),
    ("march_kernel<bf16>", "star3d1r", INTERIOR_3D, {}, BENCH_STEPS_3D,
     "stencil3d_march", BENCH_STEPS_3D // 2),
    ("march_kernel<bf16>", "box3d1r", INTERIOR_3D, {}, BENCH_STEPS_3D,
     "stencil3d_march", BENCH_STEPS_3D // 2),
    ("stencil3d_kernel<bf16>", "star3d1r", INTERIOR_3D, {"fused_steps_3d": 4},
     8, "stencil3d_bf16", 2))
# the counters of the float32 and float64 1-D and 3-D instances, which no bf16
# run may add to
NOT_BF16_1D3D = KERNELS_1D + tuple(KERNELS_FP64_1D) + (
    "stencil3d", "df64_3d_step", "stencil1d_resident_f64")
# the timed configurations: (shape, size, steps, engine options)
BF16_TIMED_1D3D = (("1d2r", (N_1D_LARGE,), BENCH_STEPS, {}),
                   ("1d2r", (N_1D,), BENCH_STEPS, {}),
                   ("1d1r", (N_1D_SMALL,), 64, {}),
                   ("star3d1r", INTERIOR_3D, BENCH_STEPS_3D, {}),
                   ("box3d1r", INTERIOR_3D, BENCH_STEPS_3D, {}))


def bf16_engine_nd(name, size, device, dtype="bfloat16", **kw):
    from lorastencil_tpu_torch import engine

    spec = spec_1d(name) if len(size) == 1 else bf16_spec(name)
    return engine.StencilEngine(spec, size, engine._config(dict(kw,
                                                               dtype=dtype)),
                                device=device)


def bf16_layout_nd(spec, size, reach):
    if len(size) == 1:
        return layout_1d(spec, size[0], reach)
    return port_layout_3d(spec, size, reach // max(1, spec.radius))


def bf16_calls(wrapper_name, spec, lay, k):
    """(one call of the wrapper on a state, its twin's, its rounding by the
    float32 instance): each a function of the state; a run takes k steps
    (an int) and so do its float32 single steps, each rounded; a narrow pass
    is k float32 single steps, each rounded; a wide or 3-D pass the float32
    pass of k levels, rounded once."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import stencil3d as s3

    wrapper = getattr(s3 if wrapper_name == "stencil3d_step" else s1,
                      wrapper_name)
    plain = getattr(s3 if wrapper_name == "stencil3d_step" else s1,
                    wrapper_name + "_plain")
    if wrapper_name.startswith("stencil1d_resident"):
        step = (s1.stencil1d_lanes_step if "lanes" in wrapper_name
                else s1.stencil1d_step)

        def rounded(x):
            for _ in range(k):
                f = x.float()
                x = step(f, torch.zeros_like(f), spec, lay).to(BF16)
            return x
        return (lambda x: wrapper(x, spec, lay, k),
                lambda x: plain(x, spec, lay, k), rounded)

    def one(x):
        return wrapper(x, torch.zeros_like(x), spec, lay, fused_steps=k)

    def twin(x):
        return plain(x, torch.zeros_like(x), spec, lay, k)

    def rounded(x):
        f = x.float()
        if wrapper_name == "stencil1d_lanes_step":
            for _ in range(k):
                f = wrapper(f, torch.zeros_like(f), spec, lay).to(BF16).float()
            return f.to(BF16)
        return wrapper(f, torch.zeros_like(f), spec, lay,
                       fused_steps=k).to(BF16)
    return one, twin, rounded


def bf16_check_nd(kernel, name, size, k, wrapper_name, device):
    """Phase 24: one bf16 instance against its bf16 twin, bit for bit on the
    integer fill at 1-2 passes (a run: of k and 2k steps); on a uniform fill
    in [0, 0.01) bit for bit against the float32 instance run on the widened
    input and rounded as the rule says, and against the twin (1-D: bit for
    bit; 3-D: within one bf16 ulp of the largest value, the kernels fuse
    multiply-adds); each launch counted in launches_bf16 and nowhere else.
    Returns the max abs err against the twin on the uniform fill."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.utils import reference

    spec = spec_1d(name) if len(size) == 1 else bf16_spec(name)
    r = s1.effective_radius(spec) if len(size) == 1 else spec.radius
    steps = 7 if k == "run" else k
    lay = bf16_layout_nd(spec, size, (1 if k == "run" else k) * r)
    one, twin, rounded = bf16_calls(wrapper_name, spec, lay, steps)
    g0 = reference.random_padded(spec, size, seed=24)
    x = lay.to_internal(g0, BF16, device)
    for passes in (1, 2):
        got, want = x, x
        for _ in range(passes):
            got, want = one(got), twin(want)
        same_bits(got, want, f"{kernel} {name} {size} integer fill, {passes} "
                             f"passes")
    del x, got, want
    gen = torch.Generator(device=device).manual_seed(24)
    x = (torch.rand(lay.shape, generator=gen, device=device) * 0.01).to(BF16)
    counter = {"stencil3d_step": "stencil3d_bf16"}.get(wrapper_name,
                                                      wrapper_name + "_bf16")
    reset_counts()
    got = one(x)
    torch.cuda.synchronize()
    c = counts()
    if c[counter] != 1 or any(c[n] for n in NOT_BF16_1D3D + NOT_BF16):
        raise AssertionError(f"{kernel} {name}: launched {c}")
    same_bits(got, rounded(x), f"{kernel} {name} {size} against the float32 "
                               f"instance, rounded")
    ref = twin(x)
    err = (got.double() - ref.double()).abs().max().item()
    if len(size) == 1:
        same_bits(got, ref, f"{kernel} {name} {size} uniform fill, twin")
    elif not err <= 2.0 ** -7 * ref.double().abs().max().item():
        raise AssertionError(f"{kernel} {name}: {err} from the twin")
    del x, got, ref
    return err


def bf16_paths_nd(device):
    """Phase 24: each bf16 path through StencilEngine's default dispatch:
    run(2) of the integer fill bit for bit against the same engine with the
    plain twins (``twins``); the counted run of BF16_PATHS_1D3D's steps,
    launches counted from zero: only bf16 instances, the path's kernel as
    many times as its passes; returns {kernel: launches}."""
    from lorastencil_tpu_torch.utils import reference

    launches = {}
    for kernel, name, size, kw, steps, counter, n in BF16_PATHS_1D3D:
        eng = bf16_engine_nd(name, size, device, **kw)
        g0 = reference.random_padded(eng.spec, size, seed=31)
        got = eng.run(g0, 2)
        with twins():
            want = eng.run(g0, 2)
        same_bits(got, want, f"{kernel} path {name} {size} run(2)")
        if not bool(torch.isfinite(got).all()) or got.dtype != BF16:
            raise AssertionError(f"{kernel} path: {got.dtype}, not finite")
        state = eng.to_internal(g0 * 1e-3)
        reset_counts()
        out = eng.run_internal(state, steps)
        torch.cuda.synchronize()
        c = counts()
        bf16 = {k: v for k, v in c.items() if v}
        if c[counter] != n or any(c[z] for z in NOT_BF16_1D3D + NOT_BF16):
            raise AssertionError(f"{kernel} path {name} x{steps}: {bf16}")
        launches[kernel] = launches.get(kernel, 0) + c[counter]
        print(f"phase 24: bf16 {name} {size} {kw or ''} ("
              f"{eng.path or '3-D'} path, k={eng._fused_k()}): run(2) "
              f"bit-exact against the twins; "
              f"x{steps}: {n} launches of {kernel} ({counter}), none of a "
              f"float32 or float64 instance: {bf16}; output {out.dtype}",
              flush=True)
        del state, out
    return launches


def bf16_timing_nd(device, card):
    """Phase 24: the timed configurations through run_internal in bf16 and
    float32, in turns (and 1d2r 1,000,000 in bf16 also tiled, as the JAX
    engine runs it); per bf16 instance one pass's (or run's) device time
    beside the float32 instance's (in turns), its twin's, one bf16
    F.conv1d / F.conv3d step and its bound at 2-byte cells.  Returns
    {kernel: record}."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import stencil3d as s3
    from lorastencil_tpu_torch.utils import metrics

    gen = torch.Generator(device=device).manual_seed(0)
    for name, size, steps, kw in BF16_TIMED_1D3D:
        engs = {dt: bf16_engine_nd(name, size, device, dt, **kw)
                for dt in ("float32", "bfloat16")}
        if size == (N_1D,):  # the branch the JAX engine takes there
            cap = s1.RESIDENT_LANES_BYTES
            s1.RESIDENT_LANES_BYTES = 0
            try:
                engs["bfloat16 tiled"] = bf16_engine_nd(name, size, device,
                                                        **kw)
            finally:
                s1.RESIDENT_LANES_BYTES = cap
        states = {dt: (torch.rand(e.layout.shape, generator=gen,
                                  device=device) * 0.01).to(e.dtype)
                  for dt, e in engs.items()}
        ms = {}
        for dt in list(engs) + list(engs)[::-1]:
            secs, _ = metrics.time_run(engs[dt].run_internal, states[dt],
                                       steps, repeats=3, warmup=1)
            ms[dt] = min(ms.get(dt, float("inf")), secs * 1e3)
        launches = {}
        for dt, e in engs.items():
            reset_counts()
            e.run_internal(states[dt], steps)
            torch.cuda.synchronize()
            launches[dt] = {n: v for n, v in counts().items() if v}
        del states
        paths = {dt: f"{e.path or '3-D'} k={e._fused_k()}"
                 for dt, e in engs.items()}
        print(f"phase 24: {name} {size} x{steps} through run_internal, in "
              f"turns: " + ", ".join(f"{dt} ({paths[dt]}) {ms[dt]} ms"
                                     for dt in engs)
              + f"; float32 / bf16 {ms['float32'] / ms['bfloat16']:.4f}x; "
                f"launches {launches} [{card}]", flush=True)
    records = {}
    for kernel, name, size, k, wrapper_name in BF16_CHECKS_1D3D:
        if kernel in records:
            continue
        spec = spec_1d(name) if len(size) == 1 else bf16_spec(name)
        r = s1.effective_radius(spec) if len(size) == 1 else spec.radius
        run = k == "run"
        steps = 64 if run else k
        lay = bf16_layout_nd(spec, size, (1 if run else k) * r)
        mod = s3 if len(size) == 3 else s1
        wrapper = getattr(mod, wrapper_name)
        plain = getattr(mod, wrapper_name + "_plain")
        xs = {dt: (torch.rand(lay.shape, generator=gen, device=device)
                   * 0.01).to(dt) for dt in (torch.float32, BF16)}
        donors = {dt: torch.zeros_like(x) for dt, x in xs.items()}
        if run:
            fns = {str(dt)[6:]: (lambda x=x: wrapper(x, spec, lay, steps))
                   for dt, x in xs.items()}
            twin = lambda: plain(xs[BF16], spec, lay, steps)
        else:
            fns = {str(dt)[6:]: (lambda x=x, d=donors[dt]: wrapper(
                x, d, spec, lay, fused_steps=k)) for dt, x in xs.items()}
            twin = lambda: plain(xs[BF16], donors[BF16], spec, lay, k)
        t = in_turns(fns, 10 if len(size) == 3 else 20)
        plain_ms = metrics.time_run(twin, repeats=2, warmup=1)[0] * 1e3
        bound, by = bound_ms(spec, size, steps, 2)
        bound32, _ = bound_ms(spec, size, steps, 4)
        lib = (conv1d_ms(spec, size[0], device, BF16) if len(size) == 1
               else library_ms(spec, size, device, BF16))
        del xs, donors, fns
        records[kernel] = dict(
            kernel=kernel, ms=t["bfloat16"], plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib,
            float32_ms=t["float32"], float32_bound_ms=bound32,
            steps_per_launch=steps, library_steps=1,
            shape=f"bfloat16 {name} {'x'.join(map(str, size))}")
        print(f"phase 24: {kernel} at bf16 {name} {size} ({steps} steps a "
              f"launch): {t['bfloat16']} ms ({bound / t['bfloat16']:.4f} of "
              f"its {bound} ms {by} bound at 2-byte cells); the float32 "
              f"instance {t['float32']} ms ({bound32 / t['float32']:.4f} of "
              f"its {bound32} ms bound), in turns; plain twin {plain_ms} ms; "
              f"one {'F.conv1d' if len(size) == 1 else 'F.conv3d'} bf16 step "
              f"{lib} ms [{card}]", flush=True)
    return records


def bf16_phase_nd(device, card):
    """Phase 24; returns the kernels' record entries."""
    errs = {}
    for kernel, name, size, k, wrapper_name in BF16_CHECKS_1D3D:
        err = bf16_check_nd(kernel, name, size, k, wrapper_name, device)
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        print(f"phase 24: {kernel} {name} {size} "
              f"{'run x7' if k == 'run' else f'k={k}'}: bit-exact against its "
              f"bf16 twin on the integer fill at 1-2 passes, against the "
              f"float32 instance rounded by the rule on a uniform fill; max "
              f"abs err against the twin {err}", flush=True)
    launches = bf16_paths_nd(device)
    timing = bf16_timing_nd(device, card)
    replaces = {"wide_kernel<bf16>": "stencil1d_step",
                "lanes_kernel<bf16>": "stencil1d_lanes_step",
                "run_kernel<bf16> narrow": "stencil1d_resident_lanes",
                "run_kernel<bf16> wide": "stencil1d_resident",
                "march_kernel<bf16>": "stencil3d",
                "stencil3d_kernel<bf16>": "stencil3d"}
    entries = []
    for kernel, rec in timing.items():
        wrapper = {"stencil3d": "stencil3d_step"}.get(replaces[kernel],
                                                      replaces[kernel])
        entries.append(dict({
            "name": f"{wrapper}[{rec['shape']}"
                    f"{' k=' + str(rec['steps_per_launch']) if 'run' not in kernel else ''}]",
            "route": "cuda",
            "source": SOURCES["stencil3d_bf16" if "3d" in wrapper
                              else "stencil1d_bf16"],
            "replaces": REPLACES[replaces[kernel]],
            "launches": launches[kernel], "max_abs_err": errs[kernel]},
            **rec))
    return entries


# Phase 25: the sharded 2-D engines (ROADMAP A11(a)) on one card.  NCCL takes
# one card per rank, so one H100 shows the sharded path as a mesh of shards that
# all sit on the card and swap their strips by device copies (the counterpart of
# the JAX tests' virtual CPU devices), and a one-rank NCCL group; no strip
# crosses NVLink.  Each case: (label, shape or phase 22's custom array, interior,
# steps, engine options, mesh, the region kernel its passes run or None where
# they take the ring-out step, and the counter of its kernel).
SHARD_MESH = (2, 2)
# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s over both directions, 450 GB/s
# each way -- a prediction of a strip's time between two cards, not a
# measurement
NVLINK_BYTES_PER_S = 450e9
SHARDED_CASES = (
    ("fused strip", "star2d3r", INTERIOR, FUSED_STEPS,
     dict(fused_steps=2, boundary="periodic"), (2, 2), "stencil2d_fused_strip"),
    ("strip", "box2d3r", INTERIOR, 8, dict(boundary="reflect"), (4, 1),
     "stencil2d_k1"),
    ("strip", "star2d1r", (8190, 8191), 8, dict(boundary="periodic"), (2, 2),
     "stencil2d_k1"),
    ("strip", "star2d1r", (8190, 8191), 8, dict(boundary="reflect"), (2, 2),
     "stencil2d_k1"),
    (None, "star2d1r", (8190, 8191), 8, dict(boundary="periodic"), (3, 3),
     "stencil2d_k1"),
    (None, "star2d1r", (8190, 8191), 8, dict(boundary="reflect"), (3, 3),
     "stencil2d_k1"),
    ("tile", "9x9 rank 4", (4096, 4096), 4, {}, (2, 2),
     "stencil2d_plan_strip"),
    ("wide", "cross r64", (2048, 2048), 2, dict(tile=(64, 128)), (2, 2),
     "stencil2d_wide"),
    ("strip bf16", "star2d1r", INTERIOR, BENCH_STEPS, dict(dtype="bfloat16"),
     (2, 2), "stencil2d_k1"),
    ("fused strip bf16", "star2d3r", (4096, 4096), 8,
     dict(dtype="bfloat16", fused_steps=2), (2, 2), "stencil2d_fused_strip"),
    ("tile bf16", "9x9 rank 4", (2048, 2048), 2, dict(dtype="bfloat16"),
     (2, 2), "stencil2d_plan_strip"),
    ("wide bf16", "cross r64", (2048, 2048), 2,
     dict(dtype="bfloat16", tile=(64, 128)), (2, 2), "stencil2d_wide"),
    (None, "star2d1r", INTERIOR, 32, dict(dtype="df64"), (2, 2), "df64_step"),
)
# each region kernel alone: (kernel, shape, k, counter), on REGION_INTERIOR over
# the five windows of a 3 x 3 split and a one-tile window
REGION_KERNELS = (("strip", "star2d1r", 1, "stencil2d_k1"),
                  ("fused strip", "star2d3r", 2, "stencil2d_fused_strip"),
                  ("tile", "9x9 rank 4", 1, None),
                  ("fused tile", "star2d1r", 2, None),
                  ("wide", "cross r64", 1, "stencil2d_wide"))
REGION_INTERIOR = (1000, 1100)
REGION_NAMES = {"strip": "strip_kernel", "fused strip": "fused_strip_kernel",
                "tile": "plan_strip_kernel", "wide": "wide_step_kernel"}


def shard_spec(name):
    """A registry shape, phase 22's "9x9 rank 4" or C3's radius-64 cross."""
    if name == "cross r64":
        from lorastencil_tpu_torch import engine

        return engine.StencilEngine.for_coeffs(
            c3_cross(64), (8, 8), name=name, device="cpu").spec
    return bf16_spec(name)


def split_windows(gi, gj):
    """The five windows of a 3 x 3 split of a gi x gj tile grid and a one-tile
    window (the last tile)."""
    a, b, c, d = gi // 3, 2 * gi // 3, gj // 3, 2 * gj // 3
    return [((0, a), (0, gj)), ((b, gi), (0, gj)), ((a, b), (0, c)),
            ((a, b), (d, gj)), ((a, b), (c, d)), ((gi - 1, gi), (gj - 1, gj))]


def check_regions(device):
    """Phase 25 (c): each region kernel alone, float32 and bf16, over every
    window of ``split_windows`` with a shard's box (a start beyond the guard,
    an end inside the interior), bit for bit against the twin with the same
    window, the cells outside the window left as they were (NaN): the
    spec's dyadic twin (``dyadic``: the same plan, exact float32 sums) on a
    0/1 fill, where the kernels' fused multiply-adds round nothing.
    Returns {(kernel, dtype): max abs err}."""
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops.layout import Layout2D, guard_2d

    gen = torch.Generator(device=device).manual_seed(25)
    errs = {}
    for kernel, name, k, counter in REGION_KERNELS:
        spec = dyadic(shard_spec(name))
        lay = Layout2D(interior=REGION_INTERIOR, halo=spec.halo,
                       tile=(32, 128), guard=guard_2d(spec.halo,
                                                      k * spec.radius))
        m, n = REGION_INTERIOR
        bounds = (-5000, m - 10, -5000, n - 100)
        for dtype in (torch.float32, BF16):
            x = torch.randint(0, 2, lay.shape, generator=gen,
                              device=device).to(dtype)
            err = 0.0
            for region in split_windows(*lay.grid):
                nan = torch.full_like(x, float("nan"))
                reset_counts()
                got = s2.stencil2d_step(x, nan.clone(), spec, lay,
                                        fused_steps=k, bounds=bounds,
                                        region=region)
                torch.cuda.synchronize()
                c = counts()
                if c["stencil2d_region"] != 1 or (counter and c[counter] != 1):
                    raise AssertionError(f"region {kernel} {dtype}: {c}")
                want = s2.stencil2d_step_plain(x, nan, spec, lay, k, bounds,
                                               region)
                if not torch.equal(got.nan_to_num(-1.0),
                                   want.nan_to_num(-1.0)):
                    raise AssertionError(f"region {kernel} {dtype} {region}"
                                         f": not the twin's cells")
                err = max(err, (got - want).nan_to_num(0.0).abs().max()
                          .item())
            errs[(kernel, str(dtype)[6:])] = err
    return errs


def bit_equal(a, b) -> bool:
    """Whether two tensors of one dtype hold the same bits, cell for cell:
    NaN included (``torch.equal`` calls two NaN unequal).  A [0, 0.01) fill
    overflows after ~20 steps of star2d1r (100x a step) and inf - inf
    within a term with taps of both signs gives NaN."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def sharded_input(spec, interior, mode, device, gen):
    """A uniform [0, 0.01) float64 padded array on the card, with a random
    halo under dirichlet0 and a zero one under a ghost boundary."""
    shape = spec.padded_shape(interior)
    g = torch.rand(shape, generator=gen, device=device,
                   dtype=torch.float64) * 0.01
    if mode != "dirichlet0":
        hm, hn = spec.halo
        ring = torch.ones(shape, dtype=torch.bool, device=device)
        ring[hm: hm + interior[0], hn: hn + interior[1]] = False
        g[ring] = 0.0
    return g


def sharded_engines(name, interior, kw, mesh, device):
    """(the sharded engine over ``mesh`` shards on the card, the
    single-device engine of the same spec, dtype, boundary and fused depth)."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.parallel import domain

    spec = shard_spec(name)
    devices = [device] * int(np.prod(mesh))
    eng = domain.sharded_engine(spec, interior, mesh, devices=devices, **kw)
    single = engine.StencilEngine(spec, interior, engine.EngineConfig(
        dtype=kw.get("dtype", "float32"), boundary=kw.get("boundary",
                                                          "dirichlet0"),
        fused_steps=eng.fused_steps), device=device)
    return eng, single


def sharded_turns(eng, single, padded, steps):
    """Device ms of a run of ``steps`` through the sharded engine's ``_run``
    and the single-device ``run_internal`` on the same input, in turns
    (sharded, single, single, sharded), best of each."""
    from lorastencil_tpu_torch.utils import metrics

    state, inner = eng.to_sharded(padded), single.to_internal(padded)
    fns = {"sharded": lambda: eng._run(state, steps),
           "single": lambda: single.run_internal(inner, steps)}
    ms = {}
    for key in ("sharded", "single", "single", "sharded"):
        secs, _ = metrics.time_run(fns[key], repeats=2, warmup=1)
        ms[key] = min(ms.get(key, float("inf")), secs * 1e3)
    return ms


def host_per_pass(eng, padded, passes=16):
    """Host microseconds a pass of the sharded engine: the wall time of
    issuing ``passes`` passes with the card idle before them."""
    state = eng.to_sharded(padded)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._run(state, passes * eng.fused_steps)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / passes * 1e6


def sharded_case(case, device, card, gen):
    """Phase 25 (b) for one case: run(steps) with the launches counted from
    zero, bit for bit against the single-device engine (the same kernel at
    the same depth, or the float64 instance for df64), run(2) against the
    float64 dense stencil on the card, the two timed in turns.  Returns its
    record."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    kernel, name, interior, steps, kw, mesh, counter = case
    mode = kw.get("boundary", "dirichlet0")
    eng, single = sharded_engines(name, interior, kw, mesh, device)
    spec = eng.spec
    padded = sharded_input(spec, interior, mode, device, gen)
    reset_counts()
    got = eng.run(padded, steps)
    torch.cuda.synchronize()
    c = counts()
    regions = c["stencil2d_region"]
    if not c[counter] or (kernel is not None) != bool(regions):
        raise AssertionError(f"sharded {name} {kw} {mesh}: launched {c}, "
                             f"{regions} region launches")
    want = single.run(padded, steps)
    if not bit_equal(got, want):
        raise AssertionError(f"sharded {name} {kw} {mesh}: not the "
                             f"single-device engine's result")
    finite = int(torch.isfinite(got).sum())
    del want
    truth = dense_truth(padded, spec, 2, mode)
    got2 = eng.run(padded, 2).double()
    err = rel_err(got2, truth)
    tol = {"bfloat16": 1e-2, "df64": 1e-13}.get(kw.get("dtype"), 1e-5)
    if not err <= tol:
        raise AssertionError(f"sharded {name} {kw} {mesh}: rel {err} of the "
                             f"float64 dense stencil after 2 steps")
    abs_err = (got2 - truth).abs().max().item()
    del got, got2, truth
    ms = sharded_turns(eng, single, padded, steps)
    passes = -(-steps // eng.fused_steps)
    rec = dict(
        label=f"{kw.get('dtype', 'float32')} {name} {interior[0]}x"
              f"{interior[1]} x{steps} {mode} mesh {mesh}",
        step=eng._step_fn().__name__, kernel=kernel, k=eng.fused_steps,
        local_interior=eng.local_interior, tile_grid=eng.layout.grid,
        launches=c[counter], region_launches=regions,
        launches_per_pass=sum(c[n] for n in ("stencil2d", "df64_step",
                                             "stencil2d_bf16")) / passes,
        sharded_ms=ms["sharded"], single_ms=ms["single"],
        host_us_per_pass=host_per_pass(eng, padded),
        exchange_bytes_per_pass=eng.exchange_bytes(),
        nvlink_prediction_us=eng.exchange_bytes() / NVLINK_BYTES_PER_S * 1e6,
        rel_err_2=err, max_abs_err_2=abs_err, finite_cells=finite)
    print(f"phase 25: sharded {rec['label']} ({rec['step']}, k={rec['k']}, "
          f"local {rec['local_interior']}, tiles {rec['tile_grid']}): "
          f"bit-exact against the single-device engine ({finite} finite "
          f"cells of the padded result); 2 steps rel {err} of "
          f"the float64 dense stencil; {c[counter]} launches ({counter}), "
          f"{regions} over a region, {rec['launches_per_pass']} a pass; "
          f"sharded {ms['sharded']} ms, single {ms['single']} ms in turns; "
          f"host {rec['host_us_per_pass']} us a pass; exchanged "
          f"{rec['exchange_bytes_per_pass']} bytes a pass a shard "
          f"(prediction at the NVLink 4 data sheet's 450 GB/s one way: "
          f"{rec['nvlink_prediction_us']} us, not measured) [{card}]",
          flush=True)
    return rec


def flagship(device, card, gen):
    """Phase 25 (a): star2d1r 8192^2 x 256 float32 dirichlet0 over a (2, 2)
    mesh on the card, overlapped and ``overlap=False``, each bit for bit
    against the single-device engine (its default depth; float32 fused levels
    equal single steps bit for bit); device ms a run in turns with the
    single-device run, launches and host microseconds a pass."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.parallel import domain
    from lorastencil_tpu_torch.utils import metrics

    spec = shard_spec("star2d1r")
    padded = sharded_input(spec, INTERIOR, "dirichlet0", device, gen)
    single = engine.StencilEngine.for_shape("star2d1r", INTERIOR,
                                            device=device)
    want = single.run(padded, BENCH_STEPS)
    engs, out = {}, {}
    for overlap in (True, False):
        eng = domain.sharded_engine("star2d1r", INTERIOR, SHARD_MESH,
                                    devices=[device] * 4, overlap=overlap)
        reset_counts()
        got = eng.run(padded, BENCH_STEPS)
        torch.cuda.synchronize()
        c = counts()
        if not bit_equal(got, want):
            raise AssertionError(f"flagship overlap={overlap}: not the "
                                 f"single-device engine's result")
        del got
        # a fill 1e-30 as large stays finite for 16 steps (its values grow
        # 100x a step): the same run there, held to a float64 dense stencil
        small = eng.run(padded * 1e-30, 16).double()
        truth = dense_truth(padded * 1e-30, spec, 16, "dirichlet0")
        if not (bit_equal(small, single.run(padded * 1e-30, 16).double())
                and rel_err(small, truth) <= 1e-5):
            raise AssertionError(f"flagship overlap={overlap}: 16 finite "
                                 f"steps")
        del small, truth
        engs[overlap] = eng
        out[overlap] = dict(step=eng._step_fn().__name__,
                            strip_launches=c["stencil2d_k1"],
                            region_launches=c["stencil2d_region"],
                            launches_per_pass=c["stencil2d"] / BENCH_STEPS,
                            host_us_per_pass=host_per_pass(eng, padded),
                            exchange_bytes_per_pass=eng.exchange_bytes())
    states = {o: e.to_sharded(padded) for o, e in engs.items()}
    inner = single.to_internal(padded)
    fns = {"overlap": lambda: engs[True]._run(states[True], BENCH_STEPS),
           "sequential": lambda: engs[False]._run(states[False], BENCH_STEPS),
           "single": lambda: single.run_internal(inner, BENCH_STEPS)}
    ms = {}
    for key in list(fns) + list(fns)[::-1]:
        secs, _ = metrics.time_run(fns[key], repeats=2, warmup=1)
        ms[key] = min(ms.get(key, float("inf")), secs * 1e3)
    out[True]["ms"], out[False]["ms"] = ms["overlap"], ms["sequential"]
    for overlap in (True, False):
        rec = out[overlap]
        print(f"phase 25: star2d1r {INTERIOR[0]}x{INTERIOR[1]} x{BENCH_STEPS} "
              f"float32 over a {SHARD_MESH} mesh on one card, overlap="
              f"{overlap} ({rec['step']}): bit-exact against the "
              f"single-device engine (the fill overflows after ~20 steps: "
              f"inf and NaN compared as bits), and at 16 steps of the fill "
              f"x 1e-30, finite, within 1e-5 of the float64 dense stencil; "
              f"{rec['ms']} ms a run beside the "
              f"single-device {ms['single']} ms in turns; "
              f"{rec['launches_per_pass']} launches a pass "
              f"({rec['region_launches']} over a region, "
              f"{rec['strip_launches']} of the strip kernel in all), host "
              f"{rec['host_us_per_pass']} us a pass; exchanged "
              f"{rec['exchange_bytes_per_pass']} bytes a pass a shard "
              f"(prediction at NVLink 4's data-sheet 450 GB/s one way: "
              f"{rec['exchange_bytes_per_pass'] / NVLINK_BYTES_PER_S * 1e6} "
              f"us, not measured) [{card}]", flush=True)
    return {"single_ms": ms["single"], "overlap": out[True],
            "sequential": out[False]}, engs[True], padded


def one_rank_nccl(eng, padded, device):
    """Phase 25 (d): a one-rank NCCL group (``multihost.initialize`` on a free
    local port), the (2, 2) mesh of cards of that rank (``global_mesh``), and
    ``run_replicated`` against the in-process run, bit for bit.  One card
    holds every shard, so no strip crosses NCCL."""
    from lorastencil_tpu_torch.parallel import domain, multihost

    multihost.initialize(f"localhost:{multihost.free_port()}", 1, 0,
                         device=device)
    try:
        want = "nccl" if device.type == "cuda" else "gloo"
        if torch.distributed.get_backend() != want:
            raise AssertionError(f"the group is not {want}")
        mesh = multihost.global_mesh(SHARD_MESH, [device] * 4)
        meng = domain.sharded_engine("star2d1r", INTERIOR, SHARD_MESH,
                                     mesh=mesh)
        got = multihost.run_replicated(meng, padded, 8)
        if not bit_equal(got, eng.run(padded, 8)):
            raise AssertionError("run_replicated is not the in-process run")
        total = meng.run_checksum(padded * 1e-30, 8)
        torch.distributed.all_reduce(total)  # one NCCL collective
        if float(total) != float(eng.run_checksum(padded * 1e-30, 8)):
            raise AssertionError("the NCCL all-reduce of one rank moved the "
                                 "checksum")
    finally:
        torch.distributed.destroy_process_group()


def region_timing(device, card, cases):
    """Phase 25's records of the region kernels: for each sharded case with a
    region kernel, one launch over the inner window of its shard's layout
    (a uniform fill), its twin over the same window, one F.conv2d of the
    window's size in the state's dtype and the bound of the window's cells."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    gen = torch.Generator(device=device).manual_seed(26)
    records = {}
    for case in SHARDED_CASES:
        kernel, name, interior, _, kw, mesh, _ = case
        if kernel is None or kernel in records:
            continue
        eng, _ = sharded_engines(name, interior, kw, mesh, device)
        spec, lay, k = eng.spec, eng.layout, eng.fused_steps
        gi, gj = lay.grid
        region = ((1, gi - 1), (1, gj - 1))
        dims = ((gi - 2) * lay.tile[0], (gj - 2) * lay.tile[1])
        x = (torch.rand(lay.shape, generator=gen, device=device) * 0.01).to(
            eng.dtype)
        t = time_calls({"kernel": lambda a, b: s2.stencil2d_step(
            a, b, spec, lay, fused_steps=k, region=region)}, x,
            torch.zeros_like(x), 10)["kernel"]
        plain = time_calls({"plain": lambda a, b: s2.stencil2d_step_plain(
            a, b, spec, lay, k, None, region)}, x, torch.zeros_like(x),
            2)["plain"]
        bound, by = bound_ms(spec, dims, k, eng.dtype.itemsize)
        lib = library_ms(spec, dims, device, eng.dtype, repeats=1)
        del x
        records[kernel] = dict(
            kernel=REGION_NAMES[kernel.removesuffix(" bf16")],
            ms=t, plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=lib, steps_per_launch=k, library_steps=1,
            shape=f"{eng.config.dtype if eng.dtype != torch.float64 else 'df64'}"
                  f" {name} window {dims[0]}x{dims[1]} of a "
                  f"{lay.interior[0]}x{lay.interior[1]} shard",
            launches=cases[kernel]["launches"])
        print(f"phase 25: {kernel} kernel over the inner window {region} of a "
              f"{name} {lay.interior} shard ({dims[0]}x{dims[1]} cells, "
              f"k={k}): {t} ms ({bound / t:.4f} of its {bound} ms {by} "
              f"bound), plain twin {plain} ms, one F.conv2d {lib} ms "
              f"[{card}]", flush=True)
    return records


def sharded_phase(device, card):
    """Phase 25; returns the kernels' record entries."""
    gen = torch.Generator(device=device).manual_seed(18)
    errs = check_regions(device)
    for (kernel, dtype), err in errs.items():
        print(f"phase 25: {kernel} kernel {dtype}, {REGION_INTERIOR}: over "
              f"the five windows of a 3 x 3 split and a one-tile window with "
              f"a shard's box, bit for bit against the twin with the same "
              f"window (the spec's dyadic twin on a 0/1 fill), the cells "
              f"outside it untouched; one "
              f"region launch each; max abs err {err}", flush=True)
    flag, eng, padded = flagship(device, card, gen)
    one_rank_nccl(eng, padded, device)
    print("phase 25: a one-rank NCCL group (multihost.initialize on a free "
          "local port): global_mesh over (2, 2) shards of cuda:0, "
          "run_replicated(8) bit-exact against the in-process run, one NCCL "
          "all-reduce of its checksum; no strip crosses NCCL on one card",
          flush=True)
    del eng, padded
    cases = {}
    for case in SHARDED_CASES:
        rec = sharded_case(case, device, card, gen)
        if case[0] is not None:
            cases.setdefault(case[0], rec)
    cases["strip"] = dict(cases["strip"], launches=flag["overlap"][
        "strip_launches"])
    timing = region_timing(device, card, cases)
    print(json.dumps({"sharded": {"flagship": flag, "cases": cases}},
                     default=str), flush=True)
    entries = []
    for kernel, rec in timing.items():
        rec = dict(rec)
        dtype = "bf16" if kernel.endswith("bf16") else "float32"
        base = kernel[:-5] if dtype == "bf16" else kernel
        entries.append(dict({
            "name": f"stencil2d_step[region {base} {dtype}]", "route": "cuda",
            "source": SOURCES[("plan2d" if base == "tile" else "stencil2d")
                              + ("_bf16" if dtype == "bf16" else "")],
            "replaces": REPLACES["stencil2d"],
            "launches": rec.pop("launches"),
            "max_abs_err": errs[(base, "bfloat16" if dtype == "bf16"
                                 else "float32")]}, **rec))
    return entries


# Phase 26: the sharded 1-D and 3-D engines (ROADMAP A11(b), A11(c)) on one
# card, as phase 25 does for 2-D: every shard on cuda:0, strips moved by
# device copies, and a one-rank NCCL group.  (a) each kernel that gained a
# window -- #4's wide_kernel and pass_kernel, #5's lanes_kernel, #8's march
# and general kernels, float32 and bf16 (pass_kernel: float32 and float64) --
# over random windows with a shard's box, bit for bit against its twin and the
# full launch cut to the window, the overlapped pass's windows together equal
# to one full launch; (b) the engines at full width against the single-device
# engine, bit for bit, timed in turns; (c) the NCCL group and the dry run.
# Each case: (label, shape, interior, steps, engine options, mesh, the region
# kernel its overlapped passes run or None where they take the ring-out step).
SHARDED_ND_CASES = (
    ("lanes", "1d2r", (N_1D_LARGE,), BENCH_STEPS, dict(fused_steps=3), (4,)),
    (None, "1d2r", (N_1D_LARGE,), BENCH_STEPS, dict(fused_steps=3, overlap=False),
     (4,)),
    ("wide", "1d1r", (N_1D_LARGE - 5,), 64, dict(boundary="periodic"), (4,)),
    ("wide", "1d1r", (N_1D_LARGE - 5,), 64, dict(boundary="reflect"), (4,)),
    ("march", "star3d1r", INTERIOR_3D, BENCH_STEPS_3D,
     dict(fused_steps=2, tile=(32, 32)), (2, 2)),
    (None, "box3d1r", INTERIOR_3D, BENCH_STEPS_3D,
     dict(fused_steps=2, boundary="reflect"), (2, 2, 2)),
    ("general", "star3d1r", INTERIOR_3D, 16, dict(fused_steps=4, tile=(32, 32)),
     (2, 2)),
    ("lanes bf16", "1d2r", (N_1D_LARGE,), BENCH_STEPS,
     dict(dtype="bfloat16", fused_steps=3), (4,)),
    ("wide bf16", "1d1r", (N_1D_LARGE - 5,), 16,
     dict(dtype="bfloat16", boundary="periodic"), (4,)),
    ("march bf16", "star3d1r", INTERIOR_3D, BENCH_STEPS_3D,
     dict(dtype="bfloat16", fused_steps=2, tile=(32, 32)), (2, 2)),
    ("general bf16", "star3d1r", INTERIOR_3D, 16,
     dict(dtype="bfloat16", fused_steps=4, tile=(32, 32)), (2, 2)),
    (None, "1d2r", (N_1D_LARGE,), BENCH_STEPS, dict(dtype="df64"), (4,)),
    (None, "box3d1r", INTERIOR_3D, BENCH_STEPS_3D, dict(dtype="df64"),
     (2, 2, 2)),
)
# the region kernels: (kernel, shape, k, the wrapper's launches_region counter,
# the CUDA source, the TPU kernel it replaces)
REGION_ND_KERNELS = {
    "wide": ("1d2r", 3, "stencil1d_region", "stencil1d", "stencil1d_step"),
    "lanes": ("1d2r", 2, "stencil1d_lanes_region", "stencil1d",
              "stencil1d_lanes_step"),
    "march": ("star3d1r", 2, "stencil3d_region", "stencil3d", "stencil3d"),
    "general": ("star3d1r", 4, "stencil3d_region", "stencil3d", "stencil3d")}
REGION_ND_NAMES = {"wide": "wide_kernel", "lanes": "lanes_kernel",
                   "pass": "pass_kernel", "march": "march_kernel",
                   "general": "stencil3d_kernel"}
REGION_1D_N = 9 * 2048 + 300
REGION_3D_INTERIOR = (20, 200, 330)


def random_windows(g, gen, count=2):
    """``count`` random windows (t0, t1) of a g-tile grid."""
    out = []
    for _ in range(count):
        t0 = int(torch.randint(0, g, (1,), generator=gen, device="cpu"))
        t1 = int(torch.randint(t0 + 1, g + 1, (1,), generator=gen, device="cpu"))
        out.append((t0, t1))
    return out


def region_nd_call(kernel, dtype):
    """(wrapper call, its twin, a layout maker, counter) of one region
    kernel: the call takes (x, donor, spec, lay, k, bounds, region)."""
    from lorastencil_tpu_torch.ops import stencil1d as s1
    from lorastencil_tpu_torch.ops import stencil3d as s3

    if kernel == "pass":  # pass_kernel: float32 (no path), float64 (#12)
        def call(x, d, spec, lay, k, bounds, region):
            if x.dtype == torch.float64:
                return s1.stencil1d_lanes_step(x, d, spec, lay, fused_steps=k,
                                               bounds=bounds, region=region)
            box = s1.check_bounds(bounds, (lay.interior,), (lay.guard,), True)
            return s1._pass(x, d, spec, lay, k, True, box,
                            None if region is None else s1.region_cells(
                                region, lay))
        return call, s1.stencil1d_lanes_step_plain
    if kernel in ("wide", "lanes"):
        wrapper = s1.stencil1d_step if kernel == "wide" else \
            s1.stencil1d_lanes_step

        def call(x, d, spec, lay, k, bounds, region):
            return wrapper(x, d, spec, lay, fused_steps=k, bounds=bounds,
                           region=region)
        return call, (s1.stencil1d_step_plain if kernel == "wide"
                      else s1.stencil1d_lanes_step_plain)

    def call(x, d, spec, lay, k, bounds, region):
        return s3.stencil3d_step(x, d, spec, lay, fused_steps=k, bounds=bounds,
                                 region=region)
    return call, s3.stencil3d_step_plain


def check_regions_nd(device):
    """Phase 26 (a): each region kernel over the overlapped pass's windows
    and two random ones, with a shard's box (a start beyond the guard, an end
    inside the interior; in 3-D a z-sharded box), on the integer fill: bit
    for bit against its twin with the same window and against the full
    launch cut to the window, the cells outside the window left as they
    were (NaN), one region launch counted each; the overlapped windows into
    one output equal the full launch.  Returns {(kernel, dtype): max abs
    err}."""
    from lorastencil_tpu_torch.ops.layout import (TILE_1D, Layout1D, Layout3D,
                                                  guard_1d, guard_3d)

    gen = torch.Generator(device="cpu").manual_seed(26)
    errs = {}
    cases = [("wide", torch.float32), ("wide", BF16), ("lanes", torch.float32),
             ("lanes", BF16), ("pass", torch.float32), ("pass", torch.float64),
             ("march", torch.float32), ("march", BF16),
             ("general", torch.float32), ("general", BF16)]
    for kernel, dtype in cases:
        name, k = (("1d2r", 2) if kernel == "pass"
                   else REGION_ND_KERNELS[kernel][:2])
        spec = bf16_spec(name)
        call, twin = region_nd_call(kernel, dtype)
        if spec.ndim == 1:
            n = REGION_1D_N
            lay = Layout1D(interior=n, halo=spec.halo[0], tile=TILE_1D,
                           guard=guard_1d(spec.halo[0], k * spec.radius))
            (g,) = lay.grid
            overlap = [(0, 1), (g - 1, g), (1, g - 1)]
            windows = overlap + random_windows(g, gen)
            bounds = (-3 * n, n - 77)
        else:
            lay = Layout3D(interior=REGION_3D_INTERIOR, halo=spec.halo,
                           tile=(32, 64),
                           guard=guard_3d(spec.halo, k * spec.radius))
            gi, gj = lay.grid
            overlap = [((0, 1), (0, gj)), ((gi - 1, gi), (0, gj)),
                       ((1, gi - 1), (0, 1)), ((1, gi - 1), (gj - 1, gj)),
                       ((1, gi - 1), (1, gj - 1))]
            windows = overlap + list(zip(random_windows(gi, gen),
                                         random_windows(gj, gen)))
            h, m, nn = REGION_3D_INTERIOR
            bounds = (-50, h - 3, -1000, m - 11, -1000, nn - 70)
        x = torch.randint(0, 100, lay.shape, device=device).to(dtype)
        nan = torch.full_like(x, float("nan"))
        full = call(x, nan.clone(), spec, lay, k, bounds, None)
        union = nan.clone()
        err = 0.0
        for i, region in enumerate(windows):
            reset_counts()
            got = call(x, nan.clone(), spec, lay, k, bounds, region)
            torch.cuda.synchronize()
            c = counts()
            regions = c["stencil1d_region"] + c["stencil1d_lanes_region"] + \
                c["stencil3d_region"]
            if regions != (0 if kernel == "pass" and dtype == torch.float32
                           else 1):
                raise AssertionError(f"region {kernel} {dtype}: {c}")
            want = twin(x, nan.clone(), spec, lay, k, bounds, region)
            inside = ~want.isnan()
            if not (torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))
                    and torch.equal(got[inside], full[inside])):
                raise AssertionError(f"region {kernel} {dtype} {region}: not "
                                     f"the twin's or the full launch's cells")
            err = max(err, (got - want).nan_to_num(0.0).abs().max().item())
            if i < len(overlap):
                call(x, union, spec, lay, k, bounds, region)
        if not torch.equal(union.nan_to_num(-1.0), full.nan_to_num(-1.0)):
            raise AssertionError(f"region {kernel} {dtype}: the overlapped "
                                 f"windows are not the full launch")
        errs[(kernel, str(dtype)[6:])] = err
    return errs


def sharded_input_nd(spec, interior, mode, device, gen):
    """A uniform [0, 0.01) float64 padded array on the card in any dimension,
    with a random halo under dirichlet0 and a zero one under a ghost
    boundary."""
    from lorastencil_tpu_torch.utils import reference

    shape = spec.padded_shape(interior)
    g = torch.rand(shape, generator=gen, device=device,
                   dtype=torch.float64) * 0.01
    if mode != "dirichlet0":
        it = reference.interior_slices(spec, shape)
        inner = g[it].clone()
        g.zero_()
        g[it] = inner
    return g


def sharded_engines_nd(name, interior, kw, mesh, device):
    """(the sharded engine over ``mesh`` shards on the card, the single-device
    engine of the same spec, dtype, boundary and depth, on the same kernel
    family: 1-D the narrow sums where ``lanes``, else the wide ones)."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.parallel import domain

    spec = bf16_spec(name)
    eng = domain.sharded_engine(spec, interior, mesh,
                                devices=[device] * int(np.prod(mesh)), **kw)
    dtype = kw.get("dtype", "float32")
    cfg = dict(dtype=dtype, boundary=kw.get("boundary", "dirichlet0"))
    if spec.ndim == 1:
        cfg.update(fused_steps=eng.fused_steps, algorithm=(
            "auto" if dtype == "df64" else "mxu" if eng.lanes else "vpu"))
    else:
        cfg.update(fused_steps_3d=eng.fused_steps)
    return eng, engine.StencilEngine(spec, interior,
                                     engine.EngineConfig(**cfg), device=device)


def sharded_case_nd(case, device, card, gen):
    """Phase 26 (b) for one case: run(steps) with the launches counted from
    zero, bit for bit against the single-device engine; run(2) (run(4) in
    df64) against the float64 dense stencil on the card; the two timed in
    turns; host microseconds, launches and exchanged bytes a pass."""
    kernel, name, interior, steps, kw, mesh = case
    mode = kw.get("boundary", "dirichlet0")
    dtype = kw.get("dtype", "float32")
    eng, single = sharded_engines_nd(name, interior, kw, mesh, device)
    spec = eng.spec
    padded = sharded_input_nd(spec, interior, mode, device, gen)
    reset_counts()
    got = eng.run(padded, steps)
    torch.cuda.synchronize()
    c = counts()
    regions = c["stencil1d_region"] + c["stencil1d_lanes_region"] + \
        c["stencil3d_region"]
    launches = sum(c[k] for k in (
        "stencil1d_step", "stencil1d_step_bf16", "stencil1d_lanes_step",
        "stencil1d_lanes_step_bf16", "df64_1d_step", "df64_1d_flat_step",
        "stencil3d", "stencil3d_bf16", "df64_3d_step"))
    step = eng._step_fn().__name__
    if (kernel is not None) != bool(regions) or (kernel is not None) != (
            step == "_local_step_overlap") or not launches:
        raise AssertionError(f"sharded {name} {kw} {mesh}: {step}, launched "
                             f"{c}, {regions} region launches")
    if not bit_equal(got, single.run(padded, steps)):
        raise AssertionError(f"sharded {name} {kw} {mesh}: not the "
                             f"single-device engine's result")
    finite = int(torch.isfinite(got).sum())
    del got
    few = 4 if dtype == "df64" else 2
    truth = dense_truth(padded, spec, few, mode)
    got2 = eng.run(padded, few).double()
    err = rel_err(got2, truth)
    tol = {"bfloat16": 1e-2, "df64": 1e-13}.get(dtype, 1e-5)
    if not err <= tol:
        raise AssertionError(f"sharded {name} {kw} {mesh}: rel {err} of the "
                             f"float64 dense stencil after {few} steps")
    del got2, truth
    ms = sharded_turns(eng, single, padded, steps)
    passes = -(-steps // eng.fused_steps)
    shape = "x".join(map(str, interior))
    roof = profiling.engine_roofline(eng)
    gcells = int(np.prod(interior)) * steps / ms["sharded"] / 1e6
    rec = dict(
        label=f"{dtype} {name} {shape} x{steps} {mode} mesh {mesh}",
        step=step, kernel=kernel, k=eng.fused_steps,
        local_interior=eng.local_interior, tile_grid=eng.layout.grid,
        launches=launches, region_launches=regions,
        launches_per_pass=launches / passes,
        sharded_ms=ms["sharded"], single_ms=ms["single"],
        host_us_per_pass=host_per_pass(eng, padded),
        exchange_bytes_per_pass=eng.exchange_bytes(),
        nvlink_prediction_us=eng.exchange_bytes() / NVLINK_BYTES_PER_S * 1e6,
        rel_err=err, truth_steps=few, finite_cells=finite,
        roofline=roof.human(), gcells_per_s=gcells,
        share_of_governing_bound=roof.share(gcells))
    print(f"phase 26: sharded {rec['label']} ({step}, k={rec['k']}, local "
          f"{rec['local_interior']}, tiles {rec['tile_grid']}): bit-exact "
          f"against the single-device engine ({finite} finite cells); {few} "
          f"steps rel {err} of the float64 dense stencil; {launches} launches, "
          f"{regions} over a region, {rec['launches_per_pass']} a pass; "
          f"sharded {ms['sharded']} ms, single {ms['single']} ms in turns; "
          f"host {rec['host_us_per_pass']} us a pass; exchanged "
          f"{rec['exchange_bytes_per_pass']} bytes a pass a shard (at the "
          f"NVLink 4 data sheet's 450 GB/s one way: "
          f"{rec['nvlink_prediction_us']} us, a prediction, not measured) "
          f"[{card}]", flush=True)
    return rec, eng, padded


def one_rank_nccl_nd(eng, padded, device):
    """Phase 26 (c): a one-rank NCCL group, a mesh of ``eng``'s shape over
    cuda:0 (``global_mesh``), ``run_replicated`` against the in-process run
    bit for bit, one NCCL all-reduce of a checksum."""
    from lorastencil_tpu_torch.parallel import domain, multihost

    multihost.initialize(f"localhost:{multihost.free_port()}", 1, 0,
                         device=device)
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("the group is not NCCL")
        shape = eng.mesh.shape
        mesh = multihost.global_mesh(shape, [device] * int(np.prod(shape)))
        cfg = eng.config
        meng = domain.sharded_engine(
            eng.spec, eng.interior, cfg.mesh_shape, mesh=mesh, tile=cfg.tile,
            dtype=cfg.dtype, fused_steps=cfg.fused_steps, overlap=cfg.overlap,
            boundary=cfg.boundary)
        got = multihost.run_replicated(meng, padded, 4)
        if not bit_equal(got, eng.run(padded, 4)):
            raise AssertionError("run_replicated is not the in-process run")
        total = meng.run_checksum(padded * 1e-30, 4)
        torch.distributed.all_reduce(total)
        if float(total) != float(eng.run_checksum(padded * 1e-30, 4)):
            raise AssertionError("the NCCL all-reduce of one rank moved the "
                                 "checksum")
    finally:
        torch.distributed.destroy_process_group()


def region_timing_nd(device, card, engines, launches):
    """Phase 26's records of the region kernels: for each, one launch over
    the inner window of a shard of its case (a uniform fill), its twin over
    the same window, one library call of the window's size (``F.conv1d`` as
    CUDA graphs, ``F.conv3d``) and the bound of the window's cells."""
    gen = torch.Generator(device=device).manual_seed(27)
    records = {}
    for kernel, eng in engines.items():
        base = kernel.removesuffix(" bf16")
        spec, lay, k = eng.spec, eng.layout, eng.fused_steps
        call, twin = region_nd_call(base, eng.dtype)
        if spec.ndim == 1:
            (g,) = lay.grid
            region = (1, g - 1)
            dims = ((g - 2) * lay.tile,)
        else:
            gi, gj = lay.grid
            region = ((1, gi - 1), (1, gj - 1))
            dims = (lay.interior[0], (gi - 2) * lay.tile[0],
                    (gj - 2) * lay.tile[1])
        bounds = eng._bounds(eng.local[0])
        x = (torch.rand(lay.shape, generator=gen, device=device) * 0.01).to(
            eng.dtype)
        calls = 4 if base == "general" else 10
        both = time_calls({
            "window": lambda a, b: call(a, b, spec, lay, k, bounds, region),
            "full": lambda a, b: call(a, b, spec, lay, k, bounds, None)}, x,
            torch.zeros_like(x), calls)
        t = both["window"]
        # the full launch's time for the window's cells, at its per-cell rate
        full = both["full"] * int(np.prod(dims)) / int(np.prod(
            (lay.interior,) if spec.ndim == 1 else lay.interior))
        plain = time_calls({"p": lambda a, b: twin(a, b, spec, lay, k, bounds,
                                                   region)}, x,
                           torch.zeros_like(x), 1)["p"]
        bound, by = bound_ms(spec, dims, k, eng.dtype.itemsize)
        lib = (conv1d_ms(spec, dims[0], device, eng.dtype) if spec.ndim == 1
               else library_ms(spec, dims, device, eng.dtype, repeats=1))
        del x
        records[kernel] = dict(
            kernel=REGION_ND_NAMES[base], ms=t, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib,
            full_launch_ms_per_window=full, full_launch_ms=both["full"],
            steps_per_launch=k,
            library_steps=1,
            shape=f"{'bf16' if eng.dtype == BF16 else 'float32'} {spec.name} "
                  f"window {'x'.join(map(str, dims))} of a "
                  f"{'x'.join(map(str, np.atleast_1d(lay.interior)))} shard",
            launches=launches[kernel])
        print(f"phase 26: {kernel} kernel over the inner window {region} of a "
              f"{spec.name} shard ({'x'.join(map(str, dims))} cells, k={k}): "
              f"{t} ms ({bound / t:.4f} of its {bound} ms {by} bound); the "
              f"full launch over the shard {both['full']} ms in the same "
              f"turns, {full} ms at its per-cell rate for the window's cells "
              f"(window {t / full:.3f}x); plain twin {plain} ms, one library "
              f"step {lib} ms [{card}]", flush=True)
    return records


def sharded_phase_nd(device, card):
    """Phase 26; returns the kernels' record entries."""
    from lorastencil_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(19)
    errs = check_regions_nd(device)
    for (kernel, dtype), err in errs.items():
        print(f"phase 26: {REGION_ND_NAMES[kernel]} {dtype}: over the "
              f"overlapped pass's windows and two random ones with a shard's "
              f"box, bit for bit against the twin with the same window and "
              f"the full launch cut to it, the cells outside untouched, the "
              f"overlapped windows together the full launch; max abs err "
              f"{err}", flush=True)
    cases, engines, launches, nccl = [], {}, {}, {}
    for case in SHARDED_ND_CASES:
        rec, eng, padded = sharded_case_nd(case, device, card, gen)
        cases.append(rec)
        kernel = case[0]
        if kernel is not None:
            launches[kernel] = launches.get(kernel, 0) + rec["region_launches"]
            engines.setdefault(kernel, eng)
        ndim = eng.spec.ndim
        if ndim not in nccl and eng.dtype == torch.float32:
            nccl[ndim] = (eng, padded)
        del eng, padded
    for ndim, (eng, padded) in sorted(nccl.items()):
        one_rank_nccl_nd(eng, padded, device)
        print(f"phase 26: a one-rank NCCL group: global_mesh over "
              f"{eng.mesh.shape} shards of cuda:0, the {ndim}-D engine's "
              f"run_replicated(4) bit-exact against the in-process run, one "
              f"NCCL all-reduce of its checksum", flush=True)
    nccl.clear()
    t1 = time.perf_counter()
    dryrun.dryrun_multichip(8, devices=[device] * 8)
    print(f"phase 26: dryrun_multichip(8, devices=['cuda:0'] * 8) passed in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    timing = region_timing_nd(device, card, engines, launches)
    print(json.dumps({"sharded_nd": {"cases": cases}}, default=str),
          flush=True)
    entries = []
    for kernel, rec in timing.items():
        rec = dict(rec)
        base = kernel.removesuffix(" bf16")
        dtype = "bf16" if kernel.endswith("bf16") else "float32"
        name, _, _, source, replaces = REGION_ND_KERNELS[base]
        wrapper = {"wide": "stencil1d_step", "lanes": "stencil1d_lanes_step"
                   }.get(base, "stencil3d_step")
        entries.append(dict({
            "name": f"{wrapper}[region {base} {dtype}]", "route": "cuda",
            "source": SOURCES[source + ("_bf16" if dtype == "bf16" else "")],
            "replaces": REPLACES[replaces], "launches": rec.pop("launches"),
            "max_abs_err": errs[(base, "bfloat16" if dtype == "bf16"
                                 else "float32")]}, **rec))
    print(f"phase 26: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries, cases


# -- phase 27: the last modules (ROADMAP B13, A12, A14) ----------------------
B13_NAMES = ("mxu", "mxu_split", "mxu_hybrid1r", "mxu_hybrid3")
B13_CASES = tuple((name, INTERIOR, alg) for name in ("star2d1r", "star2d3r")
                  for alg in B13_NAMES) + (("star3d1r", INTERIOR_3D, "mxu"),)
# (shape, interior, steps timed in turns, steps held within rel 1e-5)
AUTOTUNE_CASES = (("star2d1r", INTERIOR, 64, 4), ("star2d3r", INTERIOR, 64, 4),
                  ("1d2r", (N_1D_LARGE,), BENCH_STEPS, 7),
                  ("star3d1r", INTERIOR_3D, BENCH_STEPS_3D, 4))
CHECKPOINT_STEPS, CHECKPOINT_EVERY = 64, 16
TRACE_STEPS = 8


def integer_fill(spec, interior, device, gen):
    """The padded grid of random integers in [0, 100) on the card, the
    halo too (the reference's rand() % 100)."""
    return torch.randint(0, 100, spec.padded_shape(interior), generator=gen,
                         device=device).float()


def b13_paths(device, card, gen):
    """Phase 27 (a): every name B13 accepted, run(2) bit for bit against
    'mxu_hybrid1' on the integer fill, at the JAX engine's fused depth
    (each of them 1: two single-step launches, where 'mxu_hybrid1' fuses
    star2d3r's two steps in one), launches counted from zero."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape

    out = {}
    for name, interior, alg in B13_CASES:
        spec = get_shape(name)
        padded = integer_fill(spec, interior, device, gen)
        want = engine.StencilEngine.for_shape(name, interior, device=device,
                                              algorithm="mxu_hybrid1").run(
                                                  padded, 2)
        eng = engine.StencilEngine.for_shape(name, interior, device=device,
                                             algorithm=alg)
        reset_counts()
        got = eng.run(padded, 2)
        torch.cuda.synchronize()
        c = counts()
        kernel = "stencil3d_march" if spec.ndim == 3 else "stencil2d_k1"
        if eng._fused_k() != 1 or c[kernel] != 2 or not torch.equal(got,
                                                                    want):
            raise AssertionError(f"B13 {name} {alg}: k {eng._fused_k()}, "
                                 f"launched {c}, equal "
                                 f"{torch.equal(got, want)}")
        out[(name, alg)] = c[kernel]
        print(f"phase 27 (a): {name} {'x'.join(map(str, interior))} "
              f"algorithm={alg!r}: k=1, run(2) bit-exact against "
              f"'mxu_hybrid1' on the integer fill, {c[kernel]} launches of "
              f"{'the march' if spec.ndim == 3 else 'the strip'} kernel "
              f"[{card}]", flush=True)
        del padded, want, got
    return out


def tuned_checks(name, interior, kw, truth_steps, device, gen):
    """The tuned engine bit for bit against a float64 dense stencil on the
    integer fill at 2 steps, and within rel 1e-5 of it on the pi/100 fill
    after ``truth_steps``."""
    from lorastencil_tpu_torch import engine

    eng = engine.StencilEngine.for_shape(name, interior, device=device, **kw)
    padded = integer_fill(eng.spec, interior, device, gen)
    if not torch.equal(eng.run(padded, 2).double(),
                       dense_truth(padded, eng.spec, 2, "dirichlet0")):
        raise AssertionError(f"autotune {name} {kw}: run(2) not bit-exact")
    padded = padded * (np.pi / 100)
    err = rel_err(eng.run(padded, truth_steps).double(),
                  dense_truth(padded, eng.spec, truth_steps, "dirichlet0"))
    if not err <= 1e-5:
        raise AssertionError(f"autotune {name} {kw}: rel {err} after "
                             f"{truth_steps} steps")
    return eng, err


def autotune_phase(device, card, gen):
    """Phase 27 (b): ``autotune_params`` in float32 for ``AUTOTUNE_CASES``
    in a fresh cache: every candidate's ms and the winner; a second call
    served from the cache with no launch; the tuned engine held to float64;
    the tuned and default engines timed in turns; a cached 'skew' winner
    taken by ``fusion='auto'``."""
    import os
    import tempfile

    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.utils import autotune, metrics

    recs = {}
    old = os.environ.get("LORASTENCIL_CACHE")
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["LORASTENCIL_CACHE"] = cache_dir
        try:
            for name, interior, steps, truth_steps in AUTOTUNE_CASES:
                reset_counts()
                t0 = time.perf_counter()
                kw = autotune.autotune_params(name, interior, device=device)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launched = {k: v for k, v in counts().items() if v}
                reset_counts()
                again = autotune.autotune_params(name, interior,
                                                 device=device)
                torch.cuda.synchronize()
                if again != kw or any(counts().values()):
                    raise AssertionError(f"autotune {name}: the second call "
                                         f"gave {again}, launched {counts()}")
                measured = {}
                for key, rec in autotune._load_cache().items():
                    if f"|{name}|" in key:
                        measured.update(rec["measured"])
                print(f"phase 27 (b): autotune {name} "
                      f"{'x'.join(map(str, interior))} float32 in {secs:.1f}"
                      f" s: winner {kw}; candidates (s) "
                      f"{json.dumps(measured)}; launches {launched}; a second "
                      f"call from the cache, no launch [{card}]", flush=True)
                tuned, err = tuned_checks(name, interior, kw, truth_steps,
                                          device, gen)
                default = engine.StencilEngine.for_shape(name, interior,
                                                         device=device)
                padded = integer_fill(tuned.spec, interior, device, gen)
                states = {"tuned": tuned.to_internal(padded * 1e-30),
                          "default": default.to_internal(padded * 1e-30)}
                del padded
                fns = {"tuned": lambda: tuned.run_internal(states["tuned"],
                                                           steps),
                       "default": lambda: default.run_internal(
                           states["default"], steps)}
                ms = {}
                for key in list(fns) + list(fns)[::-1]:
                    t, _ = metrics.time_run(fns[key], repeats=2, warmup=1)
                    ms[key] = min(ms.get(key, float("inf")), t * 1e3)
                skew = None
                if kw.get("fusion") == "skew":
                    auto_kw = {k: v for k, v in kw.items() if k != "fusion"}
                    auto = engine.StencilEngine.for_shape(
                        name, interior, device=device, **auto_kw)
                    reset_counts()
                    auto.run_internal(states["tuned"], 4)
                    torch.cuda.synchronize()
                    c = counts()
                    skew = c["stencil2d_skew"]  # every float32 launch
                    if auto._fusion_mode() != "skew" or not skew:
                        raise AssertionError(f"fusion='auto' missed the "
                                             f"cached skew winner: {c}")
                recs[name] = dict(winner=kw, candidates=measured,
                                  tune_s=secs, launches=launched, rel_err=err,
                                  tuned_ms=ms["tuned"],
                                  default_ms=ms["default"], steps=steps,
                                  auto_skew_launches=skew)
                print(f"phase 27 (b): {name} tuned engine bit-exact against "
                      f"float64 at 2 steps, rel {err} after {truth_steps}; "
                      f"{steps} steps in turns: tuned {ms['tuned']} ms, "
                      f"default {ms['default']} ms"
                      + ("" if skew is None else
                         f"; fusion='auto' took the cached skew winner: "
                         f"{skew} launches of stencil2d_skew_step in 4 "
                         f"steps")
                      + f" [{card}]", flush=True)
                del states, tuned, default
        finally:
            if old is None:
                os.environ.pop("LORASTENCIL_CACHE", None)
            else:
                os.environ["LORASTENCIL_CACHE"] = old
    return recs


def profiling_phase(device, card, nd_cases):
    """Phase 27 (c): ``probe_ceilings`` beside ``MEASURED``; the flagship's
    and phase 26's sharded rows' rooflines with each run's share of its
    governing bound; a ``trace`` of 8 flagship steps naming the strip
    kernel, and its share of the device time."""
    import os
    import tempfile

    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    probe = profiling.probe_ceilings(device)
    print(f"phase 27 (c): probe_ceilings in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(probe)}; MEASURED "
          f"{json.dumps(profiling.MEASURED)} [{card}]", flush=True)
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device=device)
    gen = torch.Generator(device=device).manual_seed(27)
    state = eng.to_internal(torch.rand(eng.spec.padded_shape(INTERIOR),
                                       generator=gen, device=device) * 1e-30)
    secs, _ = metrics.time_run(eng.run_internal, state, BENCH_STEPS)
    roof = profiling.engine_roofline(eng)
    gcells = INTERIOR[0] * INTERIOR[1] * BENCH_STEPS / secs / 1e9
    rows = {"star2d1r flagship": dict(roofline=roof.human(),
                                      gcells_per_s=gcells,
                                      share=roof.share(gcells))}
    print(f"phase 27 (c): star2d1r {INTERIOR[0]}x{INTERIOR[1]} x"
          f"{BENCH_STEPS}: {secs * 1e3} ms, {gcells} GCells/s, "
          f"{roof.share(gcells)} of its governing bound; {roof.human()} "
          f"[{card}]", flush=True)
    for rec in nd_cases:
        rows[rec["label"]] = dict(roofline=rec["roofline"],
                                  gcells_per_s=rec["gcells_per_s"],
                                  share=rec["share_of_governing_bound"])
        print(f"phase 27 (c): phase 26 sharded {rec['label']} "
              f"({rec['step']}): "
              f"{rec['gcells_per_s']} GCells/s, "
              f"{rec['share_of_governing_bound']} of its governing bound; "
              f"{rec['roofline']} [{card}]", flush=True)
    eng.run_internal(state, 2)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir):
            eng.run_internal(state, TRACE_STEPS)
        path = os.path.join(logdir, "trace.json")
        with open(path) as f:
            named = "strip_kernel" in f.read()
        shares = profiling.kernel_shares(path)
    strip = sum(v for k, v in shares.items() if "strip_kernel" in k)
    if not named or not strip:
        raise AssertionError(f"trace: the strip kernel is not in it: "
                             f"{shares}")
    print(f"phase 27 (c): trace() of {TRACE_STEPS} flagship steps names the "
          f"strip kernel: {strip} of the device time ({len(shares)} kernel "
          f"names: {json.dumps(shares)}) [{card}]", flush=True)
    return dict(probe=probe, rows=rows, trace_strip_share=strip,
                trace_kernels=shares)


def checkpoint_phase(device, card, gen):
    """Phase 27 (d): star2d1r 8192^2 x 64 through ``run_with_checkpoints``
    every 16, resumed from the step-32 snapshot bit for bit against the
    uninterrupted run; the same over (2, 2) shards of the card through
    ``ShardedCheckpointer``; the ms and bytes of one snapshot."""
    import os
    import tempfile

    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.parallel import domain
    from lorastencil_tpu_torch.utils import checkpoint

    spec = shard_spec("star2d1r")
    eng = engine.StencilEngine.for_shape("star2d1r", INTERIOR, device=device)
    padded = sharded_input(spec, INTERIOR, "dirichlet0", device, gen)
    rec = {}
    with tempfile.TemporaryDirectory() as d:
        full_path, part_path = (os.path.join(d, f) for f in ("a.npz",
                                                              "b.npz"))
        reset_counts()
        full = checkpoint.run_with_checkpoints(
            eng, padded, CHECKPOINT_STEPS, CHECKPOINT_EVERY, full_path,
            resume=False)
        torch.cuda.synchronize()
        rec["launches"] = counts()["stencil2d_k1"]
        checkpoint.run_with_checkpoints(eng, padded, CHECKPOINT_STEPS // 2,
                                        CHECKPOINT_EVERY, part_path,
                                        resume=False)
        if checkpoint.load(part_path).step != CHECKPOINT_STEPS // 2:
            raise AssertionError("checkpoint: no step-32 snapshot")
        resumed = checkpoint.run_with_checkpoints(
            eng, padded, CHECKPOINT_STEPS, CHECKPOINT_EVERY, part_path)
        if not bit_equal(resumed, full):
            raise AssertionError("checkpoint: the resumed run differs")
        t0 = time.perf_counter()
        checkpoint.save(full_path, checkpoint.Snapshot("star2d1r", 64, full))
        rec["save_ms"] = (time.perf_counter() - t0) * 1e3
        rec["snapshot_bytes"] = os.path.getsize(full_path)
        del full, resumed
    print(f"phase 27 (d): star2d1r {INTERIOR[0]}x{INTERIOR[1]} x"
          f"{CHECKPOINT_STEPS} every {CHECKPOINT_EVERY}: resumed from the "
          f"step-{CHECKPOINT_STEPS // 2} snapshot bit for bit the "
          f"uninterrupted run ({rec['launches']} strip launches); one "
          f"snapshot {rec['save_ms']} ms, "
          f"{rec['snapshot_bytes']} bytes [{card}]", flush=True)
    sh = domain.sharded_engine("star2d1r", INTERIOR, SHARD_MESH,
                               devices=[device] * 4)
    state0 = sh.to_sharded(padded)
    want = sh._run(state0, CHECKPOINT_STEPS)
    half = sh._run(state0, CHECKPOINT_STEPS // 2)
    with tempfile.TemporaryDirectory() as d:
        ck = checkpoint.ShardedCheckpointer(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(CHECKPOINT_STEPS // 2, half, "star2d1r")
        rec["sharded_save_ms"] = (time.perf_counter() - t0) * 1e3
        ck.wait()
        rec["sharded_write_ms"] = (time.perf_counter() - t0) * 1e3
        step = ck.latest_step()
        del half
        back, meta = ck.restore(step, state0)
        ck.close()
        rec["sharded_bytes"] = sum(
            os.path.getsize(os.path.join(d, f"step_{step}", f))
            for f in os.listdir(os.path.join(d, f"step_{step}")))
    reset_counts()
    got = sh._run(back, CHECKPOINT_STEPS - step)
    torch.cuda.synchronize()
    rec["sharded_launches"] = counts()["stencil2d_k1"]
    rec["sharded_region_launches"] = counts()["stencil2d_region"]
    if step != CHECKPOINT_STEPS // 2 or meta["shape"] != "star2d1r" or not all(
            bit_equal(got[c], want[c]) for c in want):
        raise AssertionError(f"sharded checkpoint: step {step}, meta {meta},"
                             f" differs")
    print(f"phase 27 (d): star2d1r over {SHARD_MESH} shards of one card: "
          f"ShardedCheckpointer save at step {step} ({rec['sharded_save_ms']}"
          f" ms to return, the host copies; {rec['sharded_write_ms']} ms to "
          f"disk, {rec['sharded_bytes']} bytes), restore, {CHECKPOINT_STEPS - step} "
          f"more steps ({rec['sharded_launches']} strip launches, "
          f"{rec['sharded_region_launches']} over a region): bit for bit the "
          f"uninterrupted sharded run [{card}]",
          flush=True)
    return rec


def heat_totals(lines):
    """(total heat, peak) of the heat example's output lines."""
    line = next(ln for ln in lines if ln.startswith("after 40 steps"))
    return (float(line.split("total heat ")[1].split(",")[0]),
            float(line.split("peak ")[1]))


def heat_example(card):
    """Phase 27 (e): ``examples/torch_heat_diffusion.py`` on the card and on
    the CPU, as subprocesses: both exit 0 and print the same factorization
    and roofline lines; the total heat and the peak within rel 1e-6 of the
    CPU's (the card's fused multiply-adds and the twins' separately rounded
    products part in float32's last bits over 40 steps, the last printed
    digits with them); the sharded line's rel err below 1e-5 on both."""
    import os

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "torch_heat_diffusion.py")
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, script, "--device", dev],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"heat example --device {dev} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        outs[dev] = (proc.stdout.splitlines(), time.perf_counter() - t0)
    lines = {dev: [ln for ln in out if "rel err" not in ln
                   and not ln.startswith("after 40 steps")]
             for dev, (out, _) in outs.items()}
    errs = {dev: float(next(ln for ln in out if "rel err" in ln).split()[-1])
            for dev, (out, _) in outs.items()}
    totals = {dev: heat_totals(out) for dev, (out, _) in outs.items()}
    apart = [abs(a - b) / abs(b) for a, b in zip(totals["cuda"],
                                                 totals["cpu"])]
    if (lines["cuda"] != lines["cpu"] or not max(errs.values()) < 1e-5
            or not max(apart) <= 1e-6):
        raise AssertionError(f"heat example: {outs}")
    print(f"phase 27 (e): examples/torch_heat_diffusion.py --device cuda "
          f"({outs['cuda'][1]:.1f} s) prints the lines of --device cpu "
          f"({outs['cpu'][1]:.1f} s): {' | '.join(lines['cuda'])}; total "
          f"heat, peak {totals['cuda']} on the card, {totals['cpu']} on the "
          f"CPU (rel {apart}); sharded rel err {errs} [{card}]", flush=True)
    return dict(lines=lines["cuda"], totals=totals, rel_apart=apart,
                rel_err=errs)


def row11_radius0(device, card):
    """Phase 27 (f): the radius-0 float64 3-D instance (TPU kernel #11,
    the general kernel's R = 0 float64 instance) at 256^3: a k = 2 pass
    timed beside its twin, its byte bound at 8-byte cells and one float64
    ``F.conv3d`` 1x1x1 step; launches of a counted run(3) from zero."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil3d as s3
    from lorastencil_tpu_torch.utils import reference

    eng = engine.StencilEngine.for_coeffs(np.array([[[0.75]]]), INTERIOR_3D,
                                          name="r0", device=device,
                                          dtype="float64")
    lay, spec = eng.layout, eng.spec
    g0 = reference.random_padded(spec, INTERIOR_3D, seed=4)
    reset_counts()
    got = eng.run(g0, 3)
    torch.cuda.synchronize()
    c = counts()
    want = dense_truth(torch.from_numpy(g0).to(device), spec, 3, "dirichlet0")
    if (eng._fused_k() != 2 or c["df64_3d_step"] != 2 or c["stencil3d_march"]
            or not torch.equal(got, want)):
        raise AssertionError(f"row 11 radius 0: launched {c}")
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(lay.shape, generator=gen, device=device,
                   dtype=torch.float64) * 0.01
    t = time_calls({"kernel": lambda a, b: s3.stencil3d_step(
        a, b, spec, lay, fused_steps=2)}, x, torch.zeros_like(x),
        20)["kernel"]
    plain = time_calls({"plain": lambda a, b: s3.stencil3d_step_plain(
        a, b, spec, lay, 2)}, x, torch.zeros_like(x), 3)["plain"]
    del x
    bound, by = bound_ms(spec, INTERIOR_3D, 2, 8)
    lib = library_ms(spec, INTERIOR_3D, device, dtype=torch.float64)
    print(f"phase 27 (f): row 11 radius 0 float64, the general kernel's "
          f"k=2 pass at {'x'.join(map(str, INTERIOR_3D))}: {t} ms ({bound / t}"
          f" of its {bound} ms {by} bound), plain twin {plain} ms, one "
          f"float64 F.conv3d 1x1x1 {lib} ms; run(3) bit-exact against the "
          f"float64 dense stencil, {c['df64_3d_step']} launches [{card}]",
          flush=True)
    return dict(kernel="stencil3d_kernel<double, 0>", ms=t, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                steps_per_launch=2, library_steps=1,
                shape="float64 radius 0 " + "x".join(map(str, INTERIOR_3D)),
                launches=c["df64_3d_step"], max_abs_err=0.0)


def slice_phase(device, card, nd_cases):
    """Phase 27; returns the kernels' record entries (row 11's radius-0
    instance)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(27)
    b13 = b13_paths(device, card, gen)
    tuned = autotune_phase(device, card, gen)
    prof = profiling_phase(device, card, nd_cases)
    ck = checkpoint_phase(device, card, gen)
    heat = heat_example(card)
    row11 = row11_radius0(device, card)
    print(json.dumps({"slice": {
        "b13_launches": {" ".join(k): v for k, v in b13.items()},
        "autotune": tuned, "profiling": prof, "checkpoint": ck,
        "heat": heat, "row11": row11}}, default=str), flush=True)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s", flush=True)
    rec = dict(row11)
    return [dict({"name": "df64_3d_step[radius 0 float64]", "route": "cuda",
                  "source": SOURCES["stencil3d"],
                  "replaces": REPLACES["df64_3d_step"],
                  "launches": rec.pop("launches"),
                  "max_abs_err": rec.pop("max_abs_err")}, **rec)]


def loaded_reference_modules():
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "lorastencil_tpu"
                  or m.startswith("lorastencil_tpu."))


# Phase 28: the plan strip kernel (csrc/plan2d.cu) and the plan march kernel
# (csrc/plan3d.cu), the redesigns for Hopper of the tile kernel (step_kernel:
# its k = 1 step and its fused pass) and of the general 3-D kernel
# (stencil3d_kernel) on the plans no registry shape gives.  Each kernel
# against its plain twin and the kernel it replaces on the card, through
# StencilEngine with its launches counted, the main path's routes
# unchanged, and its times beside the replaced kernel's, in turns.
PLAN_R4_TAPS = (-1 / 560, 8 / 315, -1 / 5, 8 / 5, -205 / 72, 8 / 5, -1 / 5,
                8 / 315, -1 / 560)


def star_r4():
    """The 8th-order central-difference Laplacian heat step: the identity
    plus 0.1 x the Laplacian of per-axis second-derivative taps
    ``PLAN_R4_TAPS``, a 25-point 3-D star of radius 4 (``for_coeffs``
    decomposes it into two buffered terms and eight residue points along z)."""
    S = np.zeros((9, 9, 9))
    for axis in range(3):
        for i, w in enumerate(PLAN_R4_TAPS):
            idx = [4, 4, 4]
            idx[axis] = i
            S[tuple(idx)] += 0.1 * w
    S[4, 4, 4] += 1.0
    return S


def plan_coeffs(name):
    """Phase 22's custom arrays, the radius-2 and radius-4 3-D stars and the
    registry shapes' (by name)."""
    if name == "star r4":
        return star_r4()
    if name == "star r2":
        S = np.zeros((5, 5, 5))
        for axis in range(3):
            for i, w in enumerate((-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12)):
                idx = [2, 2, 2]
                idx[axis] = i
                S[tuple(idx)] += 0.1 * w
        S[2, 2, 2] += 1.0
        return S
    return custom_coeffs()[name]


def plan_spec(name):
    """The spec of ``plan_coeffs(name)`` (``for_coeffs``), a registry shape
    or a phase 29 spec (``reach_spec``)."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape

    if name in ("star2d1r", "box2d1r", "box2d3r", "star3d1r"):
        return get_shape(name)
    if reach_spec(name) is not None:
        return reach_spec(name)
    S = plan_coeffs(name)
    return engine.StencilEngine.for_coeffs(
        S, (8,) * S.ndim, name=name, device="cpu").spec


# (spec, interior, depths): every depth in each dtype that takes it
# (float64: 1-2 in 2-D), on the kernel's own entry
PLAN_CHECKS_2D = (("9x9 rank 4", (1000, 1000), (1, 2)),
                  ("5x5 asym", (333, 517), (1, 2, 3)),
                  ("star2d1r", (1000, 1000), (2, 3)),
                  ("box2d3r", (300, 140), (2, 3)),
                  ("heat5x5", (200, 600), (3,)))
PLAN_CHECKS_3D = (("per-plane", (37, 45, 130), (1, 2)),
                  ("star r2", (24, 40, 200), (1, 2)),
                  ("star r4", (37, 45, 130), (1, 2)),
                  ("per-plane", (64, 96, 200), (2,)))
PLAN_DTYPES = (torch.float32, BF16, torch.float64)


def plan_fills(spec, shape, dtype, device, seed):
    """(the 0/1 fill with the spec's dyadic twin, the pi/100 fill with the
    spec) on a buffer of ``shape``: the first bit for bit against the twin
    in every dtype, the second in float64 (each product and sum rounded in
    the twin's order) and against the replaced kernel in every dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randint(0, 100, shape, generator=gen, device=device,
                      dtype=torch.float64)
    return ((dyadic(spec), (g % 2).to(dtype)),
            (spec, (g * (np.pi / 100)).to(dtype)))


def check_plan_case(dims, name, interior, k, dtype, device):
    """Phase 28 (a) for one case: the plan kernel on its own entry at depth
    k in ``dtype``: two passes on the 0/1 fill with the dyadic twin bit for
    bit against the plain twin (the pi/100 fill too in float64); the pi/100
    fill bit for bit against the kernel it replaces (``step_kernel``,
    ``stencil3d_kernel``: the same sums in the same order); one pass under a
    ghost ring's box (levels before the last) and one over a window of tiles
    against the twin; each launch counted.  Returns a line."""
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import stencil3d as s3
    from lorastencil_tpu_torch.ops.layout import (Layout2D, Layout3D,
                                                  check_bounds,
                                                  default_tile_2d,
                                                  default_tile_3d, guard_2d,
                                                  guard_3d)

    real = plan_spec(name)
    r = real.radius
    takes = s2.plan_strip_takes if dims == 2 else s3.plan_march_takes
    if not takes(real, dtype, k) and not (dims == 2 and k == 1):
        raise AssertionError(f"{name} {dtype} k={k}: the plan kernel refuses")
    if dims == 2:
        lay = Layout2D(interior=interior, halo=real.halo,
                       tile=default_tile_2d(*interior),
                       guard=guard_2d(real.halo, k * r))
        plain = s2.stencil2d_step_plain
    else:
        lay = Layout3D(interior=interior, halo=real.halo,
                       tile=default_tile_3d(*interior[1:]),
                       guard=guard_3d(real.halo, k * r))
        plain = s3.stencil3d_step_plain

    def kernel(x, spec, box=None, region=None, out=None):
        out = torch.zeros_like(x) if out is None else out
        if dims == 2:
            s2._launch("plan_strip", (x, out), spec, lay, k, box, region)
        else:
            s3._launch_plan_march(
                x, out, spec, lay, k,
                check_bounds(box, lay.interior, lay.guard, shard=True),
                *(() if region is None else (s3.region_cells(region, lay),)))
        return out

    def twin(x, spec, box=None, region=None):
        return plain(x, torch.zeros_like(x), spec, lay, k, box, region)

    def replaced(x, spec):
        out = torch.zeros_like(x)
        if dims == 2:
            s2._launch("step", (x, out), spec, lay, k)
            return out
        return general_3d(x, spec, lay, k, out)

    counter = "stencil2d_plan_strip" if dims == 2 else "stencil3d_plan_march"
    label = f"{name} {interior} {str(dtype)[6:]} k={k}"
    (dspec, x01), (spec, xpi) = plan_fills(real, lay.shape, dtype, device,
                                           seed=28 + k)
    fills = [(dspec, x01, "0/1 fill, dyadic taps")]
    if dtype == torch.float64:
        fills.append((spec, xpi, "pi/100 fill"))
    for sp, x, what in fills:
        reset_counts()
        a = kernel(x, sp)
        b = kernel(a, sp)
        torch.cuda.synchronize()
        if counts()[counter] != 2:
            raise AssertionError(f"{label}: launches {counts()}")
        wa = twin(x, sp)
        same_bits(a, wa, f"plan kernel {label} {what}, pass 1")
        same_bits(b, twin(wa, sp), f"plan kernel {label} {what}, pass 2")
    same_bits(kernel(xpi, spec), replaced(xpi, spec),
              f"plan kernel {label} vs the replaced kernel, pi/100 fill")
    if k >= 2:
        box = tuple(v for e in lay.interior for v in (-r, e + r))
        same_bits(kernel(x01, dspec, box=box), twin(x01, dspec, box=box),
                  f"plan kernel {label} under the box {box}")
    gi, gj = lay.grid
    region = ((min(1, gi - 1), gi), (0, max(1, gj - 1)))
    out = torch.full_like(x01, 7.0)
    want = out.clone()
    kernel(x01, dspec, region=region, out=out)
    plain(x01, want, dspec, lay, k, None, region)
    same_bits(out, want, f"plan kernel {label} over {region}")
    return (f"{'plan_strip' if dims == 2 else 'plan_march'}_kernel {label}: "
            f"bit for bit against its twin (0/1 fill, dyadic taps"
            f"{'; pi/100 fill' if dtype == torch.float64 else ''}; 2 passes), "
            f"the replaced kernel (pi/100 fill), "
            f"{'under a ring box, ' if k >= 2 else ''}over the window {region}")


def plan_check_cases():
    """(dims, spec, interior, k, dtype) of every depth in each dtype that
    takes it (2-D float64: 1-2)."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    for dims, cases in ((2, PLAN_CHECKS_2D), (3, PLAN_CHECKS_3D)):
        for name, interior, depths in cases:
            for dtype, k in itertools.product(PLAN_DTYPES, depths):
                if dims == 2 and k not in s2.PLAN_STRIP_DEPTHS[dtype]:
                    continue
                yield dims, name, interior, k, dtype


def check_plan_kernels(device):
    """Phase 28 (a): ``check_plan_case`` for every case of
    ``plan_check_cases``.  Returns lines."""
    return [check_plan_case(*case, device) for case in plan_check_cases()]


# The named cases, each through StencilEngine (a counted run of 2k steps)
# and timed at full size: (label, spec, interior, engine options).
PLAN_CASES = (
    ("9x9 rank 4 k=1", "9x9 rank 4", INTERIOR, {}),
    ("df64 9x9 rank 4 k=1", "9x9 rank 4", INTERIOR, {"dtype": "df64"}),
    ("5x5 asym k=2", "5x5 asym", INTERIOR, {"fused_steps": 2}),
    ("float64 5x5 asym k=2", "5x5 asym", INTERIOR,
     {"fused_steps": 2, "dtype": "float64"}),
    ("star2d1r k=2", "star2d1r", INTERIOR, {"fused_steps": 2}),
    ("box2d3r k=3", "box2d3r", INTERIOR, {"fused_steps": 3}),
    ("bf16 star2d1r k=3", "star2d1r", INTERIOR,
     {"fused_steps": 3, "dtype": "bfloat16"}),
    ("bf16 5x5 asym k=2", "5x5 asym", INTERIOR,
     {"fused_steps": 2, "dtype": "bfloat16"}),
    ("per-plane k=2", "per-plane", INTERIOR_3D, {}),
    ("df64 per-plane k=1", "per-plane", INTERIOR_3D, {"dtype": "df64"}),
    ("star r4 k=2", "star r4", INTERIOR_3D, {}))


def plan_engine(name, interior, device, **kw):
    """The engine of a phase 28 case: a registry shape's, or
    ``for_coeffs`` of ``plan_coeffs(name)``."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import get_shape

    if name in ("star2d1r", "box2d3r"):
        return engine.StencilEngine(get_shape(name), interior,
                                    engine.EngineConfig(**kw), device=device)
    return engine.StencilEngine.for_coeffs(plan_coeffs(name), interior,
                                           name=name, device=device, **kw)


def plan_route(eng):
    """(the counter of an engine's passes, its launches a step pair, the
    counters that stay zero), from the wrappers' rules: a plan kernel, or
    k strip launches where ``stencil2d.strips_beat_plan``."""
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import stencil3d as s3

    spec, k, dtype = eng.spec, eng._fused_k(), eng.dtype
    if spec.ndim == 3:
        if not s3.plan_march_takes(spec, dtype, k):
            raise AssertionError(f"{spec.name} k={k}: not the plan march")
        return "stencil3d_plan_march", 1, ("stencil3d_march",)
    if k >= 2 and s2.strips_beat_plan(spec, dtype, k):
        return "stencil2d_k1", k, ("stencil2d_plan_strip",
                                   "stencil2d_fused_strip")
    if not s2.plan_strip_takes(spec, dtype, k):
        raise AssertionError(f"{spec.name} k={k}: not the plan strip")
    return "stencil2d_plan_strip", 1, ("stencil2d_k1",
                                       "stencil2d_fused_strip")


def plan_paths(device):
    """Phase 28 (b): each case of ``PLAN_CASES`` through StencilEngine:
    run(2k) of the dyadic twin on the 0/1 fill, its launches counted from
    zero (the counter ``plan_route`` names, the others zero), bit for bit
    against the engine's run with the plain twins; run(2k) of the spec on
    the pi/100 fill against the twins' run (float64: bit for bit); and the
    main path's routes, counted: star2d1r 8192^2 x 256 on the strip kernel
    (256 launches), star2d3r x 64 on the fused strip kernel (32), star3d1r
    and box3d1r 256^3 x 64 on the march kernel (32 each), none of a plan
    kernel.  Returns ({label: (launches, max abs err, counter)}, lines)."""
    from lorastencil_tpu_torch import engine

    out_rec, lines = {}, []
    for label, name, interior, kw in PLAN_CASES:
        eng = plan_engine(name, interior, device, **kw)
        spec, k = eng.spec, eng._fused_k()
        counter, per_pass, zero = plan_route(eng)
        steps = 2 * k
        deng = engine.StencilEngine(dyadic(spec), interior, eng.config,
                                    device=device)
        g01, gpi = custom_fills(spec.padded_shape(interior), device)
        reset_counts()
        out = deng.run(g01, steps)
        torch.cuda.synchronize()
        c = counts()
        if c[counter] != 2 * per_pass or any(c[z] for z in zero):
            raise AssertionError(f"{label} run({steps}): {c}")
        with twins():
            same_bits(out, deng.run(g01, steps),
                      f"{label} run({steps}) vs the twins")
        got = eng.run(gpi, steps)
        with twins():
            want = eng.run(gpi, steps)
        if eng.dtype == torch.float64:
            same_bits(got, want, f"{label} run({steps}) pi/100 fill vs twins")
        err = float((got.double() - want.double()).abs().max())
        out_rec[label] = (c[counter], err, counter)
        lines.append(f"{label} {interior}: run({steps}) at k={k}: "
                     f"{c[counter]} launches counted in {counter}, none in "
                     f"{zero}; the dyadic twin's run bit for bit against the "
                     f"twins' run; pi/100 fill max abs err {err} against it")
        del out, got, want, g01, gpi
    for name, interior, steps, counter, want in (
            ("star2d1r", INTERIOR, BENCH_STEPS, "stencil2d_k1", BENCH_STEPS),
            ("star2d3r", INTERIOR, FUSED_STEPS, "stencil2d_fused_strip",
             FUSED_STEPS // 2),
            ("star3d1r", INTERIOR_3D, BENCH_STEPS_3D, "stencil3d_march",
             BENCH_STEPS_3D // 2),
            ("box3d1r", INTERIOR_3D, BENCH_STEPS_3D, "stencil3d_march",
             BENCH_STEPS_3D // 2)):
        eng = engine.StencilEngine.for_shape(name, interior, device=device)
        state = torch.zeros(eng.layout.shape, device=device)
        reset_counts()
        eng.run_internal(state, steps)
        torch.cuda.synchronize()
        c = counts()
        if (c[counter] != want or c["stencil2d_plan_strip"]
                or c["stencil3d_plan_march"]):
            raise AssertionError(f"main path {name} x{steps}: {c}")
        lines.append(f"main path {name} {interior} x{steps}: {c[counter]} "
                     f"launches in {counter}, none of a plan kernel")
        del state
    return out_rec, lines


def plan_timing(device, card):
    """Phase 28 (c): one pass of each case of ``PLAN_CASES`` at full size
    (the engine's layout and depth) on its plan kernel and on the kernel it
    replaces, in turns (then reversed, best of), its plain twin, the library
    step (cuDNN, TF32 off, the dtype; one step) and the pass's bound; at 2-D
    k >= 2 on a spec whose single steps the strip kernel takes, k strip
    launches too (the routing rule of ``stencil2d.strips_beat_plan``).  Also
    the region launch of phase 25's tile case (9x9 rank 4 over the inner
    1984 x 1792 window of a 2048^2 shard).  Returns {label: record}."""
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops import stencil3d as s3

    gen = torch.Generator(device=device).manual_seed(28)
    records = {}
    for label, name, interior, kw in PLAN_CASES:
        eng = plan_engine(name, interior, device, **kw)
        spec, lay, k = eng.spec, eng.layout, eng._fused_k()
        x = (torch.rand(lay.shape, generator=gen, device=device)
             * 0.01).to(eng.dtype)
        tmp = torch.zeros_like(x)
        if spec.ndim == 2:
            fns = {"plan": lambda a, b: s2._launch("plan_strip", (a, b),
                                                   spec, lay, k),
                   "replaced": lambda a, b: s2._launch("step", (a, b), spec,
                                                       lay, k)}
            if k >= 2 and s2.strip_takes(spec, eng.dtype):
                def strips(a, b):
                    src = a
                    for i in range(k):  # the last launch writes b
                        dst = b if (k - i) % 2 == 1 else tmp
                        s2._launch("strip", (src, dst), spec, lay, 1)
                        src = dst
                fns["strips"] = strips

            def plain(a, b):
                return s2.stencil2d_step_plain(a, b, spec, lay, k)
        else:
            K, tile = s3.plan_pass(spec, k, x.element_size())
            if K != k:
                raise AssertionError(f"{label}: the general kernel splits")
            box = s3.check_bounds(None, lay.interior, lay.guard)
            fns = {"plan": lambda a, b: s3._launch_plan_march(
                       a, b, spec, lay, k, box),
                   "replaced": lambda a, b: s3._launch(a, b, spec, lay, k,
                                                       tile)}

            def plain(a, b):
                return s3.stencil3d_step_plain(a, b, spec, lay, k)
        ms = time_calls(fns, x, torch.zeros_like(x), 10)
        plain_ms = time_calls({"plain": plain}, x, torch.zeros_like(x),
                              2)["plain"]
        del x, tmp
        bound, by = bound_ms(spec, interior, k, eng.dtype.itemsize)
        lib = library_ms(spec, interior, device, eng.dtype, repeats=2)
        rec = dict(kernel=("plan_strip_kernel" if spec.ndim == 2
                           else "plan_march_kernel"),
                   ms=ms["plan"], replaced_ms=ms["replaced"],
                   strips_ms=ms.get("strips"), plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=lib,
                   steps_per_launch=k, library_steps=1,
                   shape=f"{label} {'x'.join(map(str, interior))}")
        records[label] = rec
        print(f"phase 28: {label} {interior}: plan kernel {ms['plan']} ms "
              f"({bound / ms['plan']:.4f} of the {by} bound {bound} ms), the "
              f"kernel it replaces {ms['replaced']} ms"
              + (f", {k} strip launches {ms['strips']} ms" if "strips" in ms
                 else "")
              + f", plain twin {plain_ms} ms, one library step {lib} ms "
                f"[{card}]", flush=True)
    eng, _ = sharded_engines("9x9 rank 4", (4096, 4096), {}, (2, 2), device)
    spec, lay = eng.spec, eng.layout
    gi, gj = lay.grid
    region = ((1, gi - 1), (1, gj - 1))
    dims = ((gi - 2) * lay.tile[0], (gj - 2) * lay.tile[1])
    x = torch.rand(lay.shape, generator=gen, device=device) * 0.01
    ms = time_calls({
        "plan": lambda a, b: s2._launch("plan_strip", (a, b), spec, lay, 1,
                                        None, region),
        "replaced": lambda a, b: s2._launch("step", (a, b), spec, lay, 1,
                                            None, region)},
        x, torch.zeros_like(x), 10)
    plain_ms = time_calls({"plain": lambda a, b: s2.stencil2d_step_plain(
        a, b, spec, lay, 1, None, region)}, x, torch.zeros_like(x),
        2)["plain"]
    del x
    bound, by = bound_ms(spec, dims, 1, 4)
    lib = library_ms(spec, dims, device, repeats=2)
    records["region 9x9 rank 4"] = dict(
        kernel="plan_strip_kernel", ms=ms["plan"], replaced_ms=ms["replaced"],
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib,
        steps_per_launch=1, library_steps=1,
        shape=f"9x9 rank 4 window {dims[0]}x{dims[1]} of a "
              f"{lay.interior[0]}x{lay.interior[1]} shard")
    print(f"phase 28: region 9x9 rank 4 window {dims[0]}x{dims[1]} of a "
          f"{lay.interior} shard: plan kernel {ms['plan']} ms "
          f"({bound / ms['plan']:.4f} of the {by} bound {bound} ms), the "
          f"kernel it replaces {ms['replaced']} ms, plain twin {plain_ms} "
          f"ms, one library step {lib} ms [{card}]", flush=True)
    reset_counts()
    eng.run(torch.zeros(spec.padded_shape((4096, 4096)), device=device), 2)
    torch.cuda.synchronize()
    records["region 9x9 rank 4"]["launches"] = counts()[
        "stencil2d_plan_strip"]
    return records


def plan_ring_split(device, card):
    """Phase 28 (d): each 2-D case of ``PLAN_CASES`` whose pass
    ``stencil2d.strips_beat_plan`` sends to strip launches, under a periodic
    boundary, where the engine's ``refresh`` refills the ring between them:
    run(2k) of the dyadic twin on the 0/1 fill counted from zero (2k strip
    launches, none of a plan or fused strip kernel) and bit for bit against
    the twins' run, whose fused levels keep the ring; then one pass at full
    size on a uniform [0, 0.01) fill, timed in turns (then reversed, best
    of): the plan strip kernel with the ring's box, k strip launches with
    the ring refresh between them, and ``stencil2d_step`` with the engine's
    bounds and refresh (the route taken: the strip launches, their refresh
    and spare buffer).  Returns {label: {timing}}."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.ops import stencil2d as s2

    gen = torch.Generator(device=device).manual_seed(28)
    records = {}
    for label, name, interior, kw in PLAN_CASES:
        eng = plan_engine(name, interior, device, boundary="periodic", **kw)
        spec, lay, k = eng.spec, eng.layout, eng._fused_k()
        if spec.ndim != 2 or k < 2 or not s2.strips_beat_plan(spec, eng.dtype,
                                                              k):
            continue
        deng = engine.StencilEngine(dyadic(spec), interior, eng.config,
                                    device=device)
        g01, _ = custom_fills(spec.padded_shape(interior), device)
        reset_counts()
        out = deng.run(g01, 2 * k)
        torch.cuda.synchronize()
        c = counts()
        if (c["stencil2d_k1"] != 2 * k or c["stencil2d_plan_strip"]
                or c["stencil2d_fused_strip"]):
            raise AssertionError(f"{label} periodic run({2 * k}): {c}")
        with twins():
            same_bits(out, deng.run(g01, 2 * k),
                      f"{label} periodic run({2 * k}) vs the twins")
        del out, g01
        bounds = eng._ghost_bounds()

        def refresh(state):
            return eng._ring_refresh(state, "periodic")

        x = refresh((torch.rand(lay.shape, generator=gen, device=device)
                     * 0.01).to(eng.dtype))
        tmp = torch.zeros_like(x)

        def strips(a, b):
            src = a
            for i in range(k):  # the last launch writes b
                dst = b if (k - i) % 2 == 1 else tmp
                if i:
                    src = refresh(src)
                s2._launch("strip", (src, dst), spec, lay, 1, bounds)
                src = dst

        ms = time_calls({
            "plan": lambda a, b: s2._launch("plan_strip", (a, b), spec, lay,
                                            k, bounds),
            "strips": strips,
            "route": lambda a, b: s2.stencil2d_step(
                a, b, spec, lay, fused_steps=k, bounds=bounds,
                refresh=refresh)}, x, torch.zeros_like(x), 10)
        del x, tmp
        records[label] = ms
        print(f"phase 28: {label} {interior} periodic: run({2 * k}) "
              f"{c['stencil2d_k1']} strip launches, none of a plan kernel, "
              f"bit for bit against the twins' fused run (dyadic 0/1 fill); "
              f"a pass: plan strip kernel with the ring's box {ms['plan']} "
              f"ms, {k} strip launches with the ring refresh between them "
              f"{ms['strips']} ms, the wrapper's pass {ms['route']} ms "
              f"[{card}]", flush=True)
    return records


def plan_phase(device, card, builds=None):
    """Phase 28; returns the kernels' record entries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if builds is not None:
        for name in ("plan2d", "plan2d_bf16", "plan3d", "plan3d_bf16"):
            ptxas = builds[name][1]
            # every function of these builds is a plan kernel's instance
            spills = [ln for ln in ptxas if "spill" in ln and
                      "0 bytes spill stores, 0 bytes spill loads" not in ln]
            regs = sorted({int(ln.split("Used ")[1].split()[0])
                           for ln in ptxas if "Used " in ln})
            print(f"phase 28: {SOURCES[name]} built in {builds[name][0]:.1f} "
                  f"s, {len(regs) and sum('Used ' in ln for ln in ptxas)} "
                  f"instances, registers {regs[0]}-{regs[-1]}, no spill",
                  flush=True)
            if spills:
                raise AssertionError(f"{name} spills: {spills}")
    t0 = time.perf_counter()
    for line in check_plan_kernels(device):
        print(f"phase 28: {line}", flush=True)
    launches, lines = plan_paths(device)
    for line in lines:
        print(f"phase 28: {line}", flush=True)
    timing = plan_timing(device, card)
    plan_ring_split(device, card)
    entries = []
    for label, t in timing.items():
        dims = 3 if t["kernel"] == "plan_march_kernel" else 2
        f64 = "float64" in label or "df64" in label
        wrapper = {(2, False): "stencil2d", (2, True): "df64_step",
                   (3, False): "stencil3d", (3, True): "df64_3d_step"}[
                       (dims, f64)]
        n, err, counter = launches.get(
            label, (t.pop("launches", 0), 0.0, "stencil2d_plan_strip"))
        if counter not in ("stencil2d_plan_strip", "stencil3d_plan_march"):
            continue  # the engine runs strip launches: printed above
        entries.append(dict({
            "name": f"{'stencil2d_step' if dims == 2 else 'stencil3d_step'}"
                    f"[plan, {label}]",
            "route": "cuda",
            "source": SOURCES[("plan2d" if dims == 2 else "plan3d")
                              + ("_bf16" if "bf16" in label else "")],
            "replaces": REPLACES[wrapper], "launches": n,
            "max_abs_err": err}, **t))
    print(f"phase 28: seconds {time.perf_counter() - t0:.1f}", flush=True)
    return entries


# Phase 29: the strip walk past the reach phase 28 gave it.  The plan strip
# kernel (csrc/plan2d.cu) at depth 4 (float32, bfloat16) and at radius 5-8
# (depth 1-2, bfloat16 1-4), and stencil2d_skew_step on the walk (single strip
# launches, the fused strip and plan strip kernels): the redesign for Hopper of
# the skew kernel (skew_kernel, TPU kernel #2) and of the tile kernel past the
# plan strip kernel's first reach (step_kernel, #1 and #9).  Each case against
# its twin and the kernel it replaces on the card, through StencilEngine with
# its launches counted (none of step_kernel or skew_kernel but where the
# measured rule stencil2d.tile_beats_plan keeps them), and timed beside the
# replaced kernel in turns.
def reach_spec(name):
    """A phase 29 spec: ``custom_r5``, a radius-9 box (``custom_r9``: past
    the walk, the tile kernel's), the 17x17 of rank 4 (``for_coeffs``), a
    radius-6 plan of three terms with zero taps and residue points in every
    column class (``r6 residue``); None for another name."""
    from lorastencil_tpu_torch import engine
    from lorastencil_tpu_torch.models.shapes import SeparableTerm, StencilSpec

    if name == "custom_r5":
        return custom_r5()
    if name == "custom_r9":
        ones = (1.0,) * 19
        return StencilSpec(name=name, ndim=2, radius=9, halo=(9, 9),
                           terms=(SeparableTerm(taps=(ones, ones)),),
                           residue=(), fuse_factor=1)
    if name == "17x17 rank 4":
        rng = np.random.default_rng(22)
        S = sum(np.outer(rng.standard_normal(17), rng.standard_normal(17))
                for _ in range(4))
        return engine.StencilEngine.for_coeffs(S, (8, 8), name=name,
                                               device="cpu").spec
    if name == "r6 residue":
        rng = np.random.default_rng(6)

        def taps():
            t = rng.standard_normal(13)
            t[rng.random(13) < 0.3] = 0.0
            return tuple(float(v) for v in t)

        return StencilSpec(
            name=name, ndim=2, radius=6, halo=(6, 6),
            terms=(SeparableTerm(taps=(taps(), taps())),
                   SeparableTerm(taps=(taps(), None)),
                   SeparableTerm(taps=(None, taps()))),
            residue=tuple((off, float(rng.standard_normal())) for off in (
                (-6, -5), (6, 3), (0, 6), (-3, -6), (5, -1), (2, 2),
                (-1, -2))), fuse_factor=1)
    return None


# (spec, interior, depths): each depth in each dtype the plan strip kernel
# takes, on its own entry (check_plan_case: the twin, the replaced
# step_kernel, a ring box, a window)
REACH_CHECKS = (("star2d1r", (1000, 1000), (4,)),
                ("5x5 asym", (333, 517), (4,)),
                ("custom_r5", (333, 517), (1, 2, 3, 4)),
                ("r6 residue", (300, 140), (1, 2, 3, 4)),
                ("17x17 rank 4", (1000, 1000), (1, 2)))
# the skewed passes checked against skew_kernel: (spec, interior, k)
REACH_SKEW_CHECKS = (("star2d1r", (1000, 1000), 2),
                     ("5x5 asym", (333, 517), 2),
                     ("9x9 rank 4", (1000, 1000), 2),
                     ("custom_r5", (333, 517), 2),
                     ("r6 residue", (300, 140), 3))
# The cases through StencilEngine, counted and timed at full size: (label,
# spec, interior, engine options).
REACH_CASES = (
    ("skew star2d1r k=2", "star2d1r", INTERIOR, {"fusion": "skew"}),
    ("bf16 skew star2d1r k=2", "star2d1r", INTERIOR,
     {"fusion": "skew", "dtype": "bfloat16"}),
    ("float64 skew star2d1r k=2", "star2d1r", INTERIOR,
     {"fusion": "skew", "dtype": "float64"}),
    ("skew 5x5 asym k=2", "5x5 asym", INTERIOR,
     {"fusion": "skew", "fused_steps": 2}),
    ("skew 9x9 rank 4 k=2", "9x9 rank 4", INTERIOR,
     {"fusion": "skew", "fused_steps": 2}),
    ("star2d1r k=4", "star2d1r", INTERIOR, {"fused_steps": 4}),
    ("bf16 star2d1r k=4", "star2d1r", INTERIOR,
     {"fused_steps": 4, "dtype": "bfloat16"}),
    ("float64 9x9 rank 4 k=3", "9x9 rank 4", INTERIOR,
     {"fused_steps": 3, "dtype": "float64"}))
REACH_CASES += tuple(
    (f"{dt + ' ' if dt != 'float32' else ''}{name} k={k}", name, INTERIOR,
     {"fused_steps": k, "dtype": dt})
    for name in ("custom_r5", "17x17 rank 4") for k in (1, 2)
    for dt in ("float32", "bfloat16", "float64"))
REACH_CASES += (("periodic custom_r5 k=2", "custom_r5", INTERIOR,
                 {"fused_steps": 2, "boundary": "periodic"}),)
# the counters of the kernels phase 29 moves launches off
TILE_COUNTERS = ("stencil2d_tile", "stencil2d_skew_tile")
# the region launches: (spec, dtype) of a sharded engine of REACH_REGION over
# a (2, 2) mesh
REACH_REGION = (4096, 4096)
REACH_REGION_CASES = (("custom_r5", "float32"), ("custom_r5", "bfloat16"),
                      ("17x17 rank 4", "float32"))


def reach_engine(name, interior, device, **kw):
    """The engine of a phase 29 case: a registry shape's, a spec of
    ``reach_spec``, or ``for_coeffs`` of phase 22's arrays."""
    from lorastencil_tpu_torch import engine

    spec = reach_spec(name)
    if spec is None:
        return plan_engine(name, interior, device, **kw)
    return engine.StencilEngine(spec, interior, engine._config(kw),
                                device=device)


def check_reach_skew(name, interior, k, dtype, device):
    """Phase 29 (a) for one skewed pass: ``stencil2d_skew_step`` (its
    launches counted from zero: all on the skew wrapper, none of the tile
    kernels, unless ``stencil2d.tile_beats_plan`` keeps them) against
    skew_kernel launched
    directly and the twin, on the 0/1
    fill with the dyadic twin and on the pi/100 fill (the replaced kernel
    bit for bit; the twin in float64).  Returns a line."""
    from lorastencil_tpu_torch.ops import stencil2d as s2
    from lorastencil_tpu_torch.ops.layout import (Layout2D, default_tile_2d,
                                                  guard_2d)

    real = plan_spec(name)
    lay = Layout2D(interior=interior, halo=real.halo,
                   tile=default_tile_2d(*interior),
                   guard=guard_2d(real.halo, k * real.radius))
    label = f"skew {name} {interior} {str(dtype)[6:]} k={k}"
    # the measured exceptions (stencil2d.tile_beats_plan) keep skew_kernel
    tile = any(s2._one_kind("skew", real, dtype, d) in ("step", "skew")
               for d in s2.launch_depths("skew", real, dtype, k))
    (dspec, x01), (spec, xpi) = plan_fills(real, lay.shape, dtype, device,
                                           seed=29)
    for sp, x, what in ((dspec, x01, "0/1 fill, dyadic taps"),
                        (spec, xpi, "pi/100 fill")):
        reset_counts()
        got = s2.stencil2d_skew_step(x, torch.zeros_like(x), sp, lay,
                                     skew_steps=k)
        torch.cuda.synchronize()
        c = counts()
        if not tile and (any(c[t] for t in TILE_COUNTERS) or c["stencil2d"]
                         or c["df64_step"] or c["stencil2d_bf16"]):
            raise AssertionError(f"{label}: launches {c}")
        old = torch.zeros_like(x)
        s2._launch("skew", (x, old), sp, lay, k)
        same_bits(got, old, f"{label} {what} vs skew_kernel")
        if what.startswith("0/1") or dtype == torch.float64:
            same_bits(got, s2.stencil2d_step_plain(x, torch.zeros_like(x), sp,
                                                   lay, k),
                      f"{label} {what} vs the twin")
    route = {n: v for n, v in c.items() if v}
    return (f"{label}: the wrapper's launches {route}, "
            + ("the tile kernels' by stencil2d.tile_beats_plan; " if tile
               else "none of skew_kernel; ") +
            f"bit for bit against skew_kernel (0/1 and pi/100 fills) and the "
            f"twin (0/1 fill, dyadic taps"
            f"{'; pi/100 fill' if dtype == torch.float64 else ''})")


def reach_check_cases():
    """(spec, interior, k, dtype) of ``REACH_CHECKS`` that the plan strip
    kernel takes."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    for name, interior, depths in REACH_CHECKS:
        spec = plan_spec(name)
        for dtype, k in itertools.product(PLAN_DTYPES, depths):
            if s2.plan_strip_takes(spec, dtype, k):
                yield name, interior, k, dtype


def reach_route(eng):
    """The launches of a run of two passes of an engine, by counter, from
    the wrappers' rules: each launch of ``launch_depths`` on the kernel
    ``_one_kind`` names, or as single launches where ``strips_beat_plan``,
    counted on the wrapper of the engine's fusion mode (the tile kernels'
    in "stencil2d_tile" / "stencil2d_skew_tile")."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    spec, k, dtype = eng.spec, eng._fused_k(), eng.dtype
    kind = "skew" if eng._fusion_mode() == "skew" else "step"
    pre = "stencil2d_skew_" if kind == "skew" else "stencil2d_"
    want = {}
    for depth in s2.launch_depths(kind, spec, dtype, k):
        if depth >= 2 and s2.strips_beat_plan(spec, dtype, depth):
            kinds = [s2._one_kind(kind, spec, dtype, 1)] * depth
        else:
            kinds = [s2._one_kind(kind, spec, dtype, depth)]
        for one in kinds:
            counter = pre + {"strip": "k1", "plan_strip": "plan_strip",
                             "fused_strip": "fused_strip", "step": "tile",
                             "skew": "tile"}[one]
            want[counter] = want.get(counter, 0) + 2
    return want


def reach_paths(device):
    """Phase 29 (b): each case of ``REACH_CASES`` through StencilEngine:
    run(2k) of the dyadic twin on the 0/1 fill, its launches counted from
    zero (``reach_route``'s, none of step_kernel or skew_kernel), bit for
    bit against the engine's run with the plain twins; run(2k) of the spec
    on the pi/100 fill against the twins' run (float64: bit for bit).
    Returns ({label: (launches, max abs err, counters)}, lines)."""
    from lorastencil_tpu_torch import engine

    out_rec, lines = {}, []
    for label, name, interior, kw in REACH_CASES:
        eng = reach_engine(name, interior, device, **kw)
        spec, k = eng.spec, eng._fused_k()
        want = reach_route(eng)
        steps = 2 * k
        deng = engine.StencilEngine(dyadic(spec), interior, eng.config,
                                    device=device)
        g01, gpi = custom_fills(spec.padded_shape(interior), device)
        reset_counts()
        out = deng.run(g01, steps)
        torch.cuda.synchronize()
        c = counts()
        got = {n: c[n] for n in want}
        if got != want or any(c[t] for t in TILE_COUNTERS if t not in want):
            raise AssertionError(f"{label} run({steps}): {c}, want {want}")
        with twins():
            same_bits(out, deng.run(g01, steps),
                      f"{label} run({steps}) vs the twins")
        res = eng.run(gpi, steps)
        with twins():
            ref = eng.run(gpi, steps)
        if eng.dtype == torch.float64:
            same_bits(res, ref, f"{label} run({steps}) pi/100 fill vs twins")
        err = float((res.double() - ref.double()).abs().max())
        out_rec[label] = (sum(want.values()), err, want)
        tile = [t for t in TILE_COUNTERS if t in want]
        lines.append(f"{label} {interior}: run({steps}) at k={k}: launches "
                     f"{want}"
                     + (f" (the tile kernel by stencil2d.tile_beats_plan)"
                        if tile else f", none in {TILE_COUNTERS}")
                     + "; the dyadic twin's run "
                     f"bit for bit against the twins' run; pi/100 fill max "
                     f"abs err {err} against it")
        del out, res, ref, g01, gpi
    return out_rec, lines


def reach_timing(device, card):
    """Phase 29 (c): one pass of each case of ``REACH_CASES`` at full size
    (the engine's layout and depth) through its wrapper's route (the
    launches ``reach_route`` names) and on the kernel it replaces (one
    launch of step_kernel or skew_kernel at the same depth), in turns (then
    reversed, best of); at k = 4 in float32 the plan strip kernel's one
    launch and k strip launches too (the routing rule of
    ``stencil2d.strips_beat_plan``); its plain twin, one library step
    (cuDNN, TF32 off, the dtype) and the pass's bound.  The periodic case
    with the engine's bounds and refresh, the replaced kernel with the
    ring's box.  Also one region launch at radius 5 (custom_r5 over the
    inner window of a 4096^2 shard of a (2, 2) mesh).  Returns {label:
    record}."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    gen = torch.Generator(device=device).manual_seed(29)
    records = {}
    for label, name, interior, kw in REACH_CASES:
        eng = reach_engine(name, interior, device, **kw)
        spec, lay, k = eng.spec, eng.layout, eng._fused_k()
        skew = eng._fusion_mode() == "skew"
        x = (torch.rand(lay.shape, generator=gen, device=device)
             * 0.01).to(eng.dtype)
        bounds = refresh = None
        if eng.config.boundary != "dirichlet0":
            bounds = eng._ghost_bounds()

            def refresh(state):
                return eng._ring_refresh(state, eng.config.boundary)

            x = refresh(x)
        if skew:
            fns = {"route": lambda a, b: s2.stencil2d_skew_step(
                       a, b, spec, lay, skew_steps=k),
                   "replaced": lambda a, b: s2._launch("skew", (a, b), spec,
                                                       lay, k)}
        else:
            fns = {"route": lambda a, b: s2.stencil2d_step(
                       a, b, spec, lay, fused_steps=k, bounds=bounds,
                       refresh=refresh),
                   "replaced": lambda a, b: s2._launch("step", (a, b), spec,
                                                       lay, k, bounds)}
        if s2.plan_strip_takes(spec, eng.dtype, k):
            fns["plan"] = lambda a, b: s2._launch("plan_strip", (a, b), spec,
                                                  lay, k, bounds)
        single = s2._one_kind("step", spec, eng.dtype, 1)
        if k >= 2 and eng.dtype != BF16 and single in ("strip", "plan_strip"):
            tmp = torch.zeros_like(x)

            def singles(a, b):
                src = a
                for i in range(k):  # the last launch writes b
                    dst = b if (k - i) % 2 == 1 else tmp
                    if i and refresh is not None:
                        src = refresh(src)
                    s2._launch(single, (src, dst), spec, lay, 1, bounds)
                    src = dst

            fns["singles"] = singles
        ms = time_calls(fns, x, torch.zeros_like(x), 10)
        plain_ms = time_calls({"plain": lambda a, b: s2.stencil2d_step_plain(
            a, b, spec, lay, k, bounds)}, x, torch.zeros_like(x), 1)["plain"]
        del x
        fns.clear()
        bound, by = bound_ms(spec, interior, k, eng.dtype.itemsize)
        lib = library_ms(spec, interior, device, eng.dtype, repeats=2)
        records[label] = dict(
            kernel=label, ms=ms["route"], replaced_ms=ms["replaced"],
            plan_ms=ms.get("plan"), singles_ms=ms.get("singles"),
            plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib,
            steps_per_launch=k, library_steps=1,
            shape=f"{label} {'x'.join(map(str, interior))}")
        print(f"phase 29: {label} {interior}: the route {ms['route']} ms "
              f"({bound / ms['route']:.4f} of the {by} bound {bound} ms), "
              f"the kernel it replaces ({'skew' if skew else 'step'}_kernel) "
              f"{ms['replaced']} ms"
              + (f", one plan strip launch {ms['plan']} ms" if "plan" in ms
                 else "")
              + (f", {k} single launches ({single}) {ms['singles']} ms"
                 if "singles" in ms else "")
              + f", plain twin {plain_ms} ms, one library step {lib} ms "
                f"[{card}]", flush=True)
    for name, dtype in REACH_REGION_CASES:
        records.update(reach_region(name, dtype, device, card, gen))
    return records


def reach_region(name, dtype, device, card, gen):
    """Phase 29 (c): one step of a shard of ``REACH_REGION`` over a (2, 2)
    mesh, on the card: over the inner window of the overlapped step (the
    route's launch, the tile kernel's; the wrapper's pass bit for bit
    against the twin on a 0/1 fill with the dyadic taps, its launches
    counted) and over the whole shard, device time of each launch from
    CUDA graphs of 10 (the host's launch work left out, which at these
    sizes is longer than the kernels), in turns.  Returns {label:
    record}."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    eng, _ = sharded_engines(name, REACH_REGION, {"dtype": dtype}, (2, 2),
                             device)
    spec, lay = eng.spec, eng.layout
    gi, gj = lay.grid
    region = ((1, gi - 1), (1, gj - 1))
    dims = ((gi - 2) * lay.tile[0], (gj - 2) * lay.tile[1])
    tdtype = getattr(torch, dtype)
    x = (torch.rand(lay.shape, generator=gen, device=device)
         * 0.01).to(tdtype)
    route = s2._one_kind("step", spec, tdtype, 1)
    out = torch.zeros_like(x)
    fns = {"route": lambda: s2._launch(route, (x, out), spec, lay, 1, None,
                                       region),
           "replaced": lambda: s2._launch("step", (x, out), spec, lay, 1,
                                          None, region),
           "shard": lambda: s2._launch(route, (x, out), spec, lay, 1),
           "shard_tile": lambda: s2._launch("step", (x, out), spec, lay, 1)}
    ms = {}
    for key in list(fns) + list(fns)[::-1]:
        ms[key] = min(ms.get(key, float("inf")), graph_ms(fns[key], 10))
    del fns, out
    plain_ms = time_calls({"plain": lambda a, b: s2.stencil2d_step_plain(
        a, b, spec, lay, 1, None, region)}, x, torch.zeros_like(x),
        1)["plain"]
    dspec = dyadic(spec)
    x01 = torch.randint(0, 2, lay.shape, generator=gen,
                        device=device).to(tdtype)
    out = torch.full_like(x01, 7.0)
    want = out.clone()
    reset_counts()
    s2.stencil2d_step(x01, out, dspec, lay, region=region)
    torch.cuda.synchronize()
    c = counts()
    counter = {"plan_strip": "stencil2d_plan_strip",
               "step": "stencil2d_tile"}[route]
    if (c[counter], c["stencil2d_region"]) != (1, 1):
        raise AssertionError(f"region {name}: launches {c}")
    s2.stencil2d_step_plain(x01, want, dspec, lay, 1, None, region)
    same_bits(out, want, f"region {name} {dtype} vs the twin")
    err = float((out.double() - want.double()).abs().max())
    del x, x01, out, want
    bound, by = bound_ms(spec, dims, 1, tdtype.itemsize)
    lib = library_ms(spec, dims, device, tdtype, repeats=2)
    label = f"region {'' if dtype == 'float32' else dtype + ' '}{name}"
    print(f"phase 29: {label} window {dims[0]}x{dims[1]} of a "
          f"{lay.interior} shard: the route ({route}) {ms['route']} ms "
          f"({bound / ms['route']:.4f} of the {by} bound {bound} ms), the "
          f"tile kernel {ms['replaced']} ms, plain twin {plain_ms} ms, one "
          f"library step {lib} ms, bit for bit against the twin; the whole "
          f"shard: the route {ms['shard']} ms, the tile kernel "
          f"{ms['shard_tile']} ms (device time, CUDA graphs) [{card}]",
          flush=True)
    return {label: dict(
        kernel=label, ms=ms["route"], replaced_ms=ms["replaced"],
        shard_ms=ms["shard"], shard_tile_ms=ms["shard_tile"],
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib,
        steps_per_launch=1, library_steps=1, launches=1, max_abs_err=err,
        launches_by_kernel={counter: 1},
        shape=f"{name} {dtype} window {dims[0]}x{dims[1]} of a "
              f"{lay.interior[0]}x{lay.interior[1]} shard")}


# one step of each spec at n^2 in each dtype, the plan strip kernel beside the
# tile kernel (CUDA graphs): what the walk costs on small grids, where a
# warp's task is a few rows
REACH_SIZES = (1024, 2048, 4096, 8192)
REACH_SIZE_CASES = (("custom_r5", "float32"), ("custom_r5", "bfloat16"),
                    ("17x17 rank 4", "float32"))


def reach_sizes(device, card):
    """Phase 29 (d): one step of each case of ``REACH_SIZE_CASES`` at
    ``REACH_SIZES``: the plan strip kernel's launch and the tile kernel's,
    device time from CUDA graphs of 10, in turns; the route is the plan
    strip kernel at every size.  Returns {(spec, dtype, n): (plan strip ms,
    tile ms)}."""
    from lorastencil_tpu_torch.ops import stencil2d as s2

    gen = torch.Generator(device=device).manual_seed(29)
    out_rec = {}
    for name, dtype in REACH_SIZE_CASES:
        spec = reach_spec(name)
        tdtype = getattr(torch, dtype)
        row = []
        for n in REACH_SIZES:
            lay = port_layout(spec, (n, n))
            x = (torch.rand(lay.shape, generator=gen, device=device)
                 * 0.01).to(tdtype)
            out = torch.zeros_like(x)
            fns = {"route": lambda: s2._launch("plan_strip", (x, out), spec,
                                               lay, 1),
                   "tile": lambda: s2._launch("step", (x, out), spec, lay,
                                              1)}
            ms = {}
            for key in ("route", "tile", "tile", "route"):
                ms[key] = min(ms.get(key, float("inf")),
                              graph_ms(fns[key], 10))
            out_rec[(name, dtype, n)] = (ms["route"], ms["tile"])
            row.append(f"{n}^2 {ms['route']} / {ms['tile']}")
            del x, out, fns
        print(f"phase 29: {name} {dtype} one step, the plan strip kernel / "
              f"the tile kernel (ms, CUDA graphs): {'; '.join(row)} "
              f"[{card}]", flush=True)
    return out_rec


def reach_phase(device, card, builds=None):
    """Phase 29; returns the kernels' record entries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if builds is not None:
        for name in ("plan2d", "plan2d_bf16"):
            ptxas = builds[name][1]
            spills = [ln for ln in ptxas if "spill" in ln and
                      "0 bytes spill stores, 0 bytes spill loads" not in ln]
            print(f"phase 29: {SOURCES[name]} built in {builds[name][0]:.1f} "
                  f"s, {sum('Used ' in ln for ln in ptxas)} instances",
                  flush=True)
            if spills:
                raise AssertionError(f"{name} spills: {spills}")
    t0 = time.perf_counter()
    for name, interior, k, dtype in reach_check_cases():
        print(f"phase 29: {check_plan_case(2, name, interior, k, dtype, device)}",
              flush=True)
    for name, interior, k in REACH_SKEW_CHECKS:
        for dtype in PLAN_DTYPES:
            print(f"phase 29: "
                  f"{check_reach_skew(name, interior, k, dtype, device)}",
                  flush=True)
    launches, lines = reach_paths(device)
    for line in lines:
        print(f"phase 29: {line}", flush=True)
    timing = reach_timing(device, card)
    reach_sizes(device, card)
    entries = []
    for label, t in timing.items():
        n, err, counters = launches.get(
            label, (t.pop("launches", 0), t.pop("max_abs_err", 0.0),
                    t.pop("launches_by_kernel", {})))
        t.pop("launches", None), t.pop("max_abs_err", None)
        t.pop("launches_by_kernel", None)
        skew = any(cn.startswith("stencil2d_skew_") for cn in counters)
        f64 = "float64" in label
        strip_only = all(cn.endswith("k1") for cn in counters)
        tile_only = all(cn.endswith("tile") for cn in counters)
        entries.append(dict({
            "name": f"{'stencil2d_skew_step' if skew else 'stencil2d_step'}"
                    f"[walk, {label}]",
            "route": "cuda",
            "source": SOURCES["stencil2d" if strip_only or tile_only
                              else "plan2d_bf16" if "bf16" in label
                              or "bfloat16" in label else "plan2d"],
            "replaces": REPLACES["stencil2d_skew" if skew else "df64_step"
                                 if f64 else "stencil2d"],
            "launches": n, "max_abs_err": err,
            "launches_by_kernel": counters}, **t))
    print(f"phase 29: seconds {time.perf_counter() - t0:.1f}", flush=True)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lorastencil_tpu_torch.models.shapes import get_shape
    from lorastencil_tpu_torch.ops import _cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    builds = build_kernels()
    print(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}),"
          f" {nvcc}; built {len(builds)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (secs, ptxas, _) in builds.items():
        print(f"phase 1: {SOURCES[name]} {secs:.1f} s: {' | '.join(ptxas)}",
              flush=True)

    main_errs = None
    for name in ("star2d1r", "box2d1r"):
        for interior in ((1024, 1024), (1000, 1000), INTERIOR):
            errs = check_kernel(name, interior, device)
            if name == "star2d1r" and interior == INTERIOR:
                main_errs = errs
            print(f"phase 2: {name} {interior}: integer fill bit-exact at "
                  f"1-2 steps; pi/100 fill rel err {errs[1][1]:.3e} (1 "
                  f"step), {errs[4][1]:.3e} (4 steps) <= 1e-6; strip kernel "
                  f"bit-equal to the tile kernel", flush=True)
    wide_launches = check_wide_radius(device)
    print(f"phase 2: radius 5 (300, 140): the plan strip kernel bit-exact "
          f"against its twin at 1-2 steps on the integer fill, "
          f"{wide_launches} launches, none of the strip or tile kernel",
          flush=True)
    spec2 = get_shape("star2d1r")
    ms2, plain_ms2, tile_ms2 = time_step(spec2, port_layout(spec2, INTERIOR),
                                         device)
    print(f"phase 2: one step at 8192^2: strip kernel {ms2} ms, the tile "
          f"kernel it replaces {tile_ms2} ms, plain twin {plain_ms2} ms "
          f"[{card}]", flush=True)

    launches2, rel = main_path(device)
    print(f"phase 3: run(8192^2, 2 steps) bit-exact against float64 on "
          f"the card, launches {launches2}; 256x384 x4 rel err "
          f"{rel:.3e} <= 1e-5", flush=True)

    bench(device, card)
    lib2 = library_ms(spec2, INTERIOR, device)
    bound2, by2 = bound_ms(spec2, INTERIOR, 1)
    print(f"phase 4: one step at 8192^2: F.conv2d 7x7 {lib2} ms; bound "
          f"{bound2} ms ({by2}) [{card}]", flush=True)

    main_errs_3d = {}
    for name in ("star3d1r", "box3d1r"):
        for interior in ((6, 20, 150), (37, 45, 130), INTERIOR_3D):
            for K in (1, 2, 4):
                abs_err, rel, same = check_kernel_3d(name, interior, K,
                                                     device)
                if interior == INTERIOR_3D and K == 2:
                    main_errs_3d[name] = abs_err
                which = ("the march kernel, bit-equal to the general "
                         "kernel," if K <= 2 else "the general kernel")
                print(f"phase 5: {name} {interior} K={K}: {which} integer "
                      f"fill bit-exact after 1-2 passes; pi/100 fill rel err "
                      f"{rel:.3e} after 4 steps (<= 1e-6), bit-equal "
                      f"{same}", flush=True)

    paths_3d = {}
    for name in ("star3d1r", "box3d1r"):
        launches, rel = main_path_3d(name, device)
        paths_3d[name] = launches
        print(f"phase 6: {name} {INTERIOR_3D}: 'vpu' at k=2; run(2) and "
              f"run(3) bit-exact against float64 on the card, every pass "
              f"the march kernel, launches {launches}; (24, 40, 200) x4 rel "
              f"err {rel:.3e} <= 1e-5", flush=True)

    timing_3d = {}
    for name in ("star3d1r", "box3d1r"):
        spec3 = get_shape(name)
        _, _, ms3, plain_ms3, general3 = bench_3d(name, device, card)
        lib3 = library_ms(spec3, INTERIOR_3D, device)
        bound3, by3 = bound_ms(spec3, INTERIOR_3D, 2)
        timing_3d[name] = (ms3, plain_ms3, lib3, bound3, by3, general3)
        print(f"phase 7: {name} one step at 256^3: F.conv3d 3x3x3 {lib3} "
              f"ms; bound of one k=2 pass {bound3} ms ({by3}) [{card}]",
              flush=True)

    errs_1d = {}
    for name, sizes in (("1d1r", (N_1D_SMALL, 3001, N_1D)),
                        ("1d2r", (N_1D_SMALL, 3001, N_1D)),
                        ("r40", (100_000,)), ("r127", (100_000,))):
        for n in sizes:
            errs = check_kernels_1d(name, n, device)
            for kernel, err in errs.items():
                errs_1d[kernel] = max(errs_1d.get(kernel, 0.0), err)
            print(f"phase 8: {name} {n}: {sorted(errs)} bit-exact against "
                  f"their twins (integer fill at 1-2 steps and one and two "
                  f"passes of k = 1, default, largest; pi/100 fill after 4 "
                  f"steps and 2*refresh+3 steps), max abs err "
                  f"{max(errs.values())}", flush=True)
    errs_new = {}
    for name, sizes in (("1d2r", (3001, N_1D_SMALL, N_1D, N_1D_LARGE)),
                        ("1d1r", (3001, N_1D_SMALL, N_1D))):
        for n in sizes:
            err = check_lanes(name, n, device)
            errs_new[("lanes", n)] = max(errs_new.get(("lanes", n), 0.0), err)
            print(f"phase 8: lanes_kernel {name} {n}: one pass at k = 1, 3 "
                  f"and 32 // r_eff bit for bit against its twin and "
                  f"pass_kernel<float> on the integer, pi/100 and inf fills, "
                  f"each launch counted; max abs err {err}", flush=True)
    for dtype in (torch.float32, torch.float64):
        for name, n in (("1d1r", N_1D_SMALL), ("1d1r", 3001),
                        ("r40", 100_000), ("r127", 100_000),
                        ("1d1r", largest_resident_1d("1d1r", dtype))):
            plan, err = check_run(name, n, dtype, device)
            errs_new[("run", dtype)] = max(errs_new.get(("run", dtype), 0.0),
                                           err)
            print(f"phase 8: run_kernel {str(dtype)[6:]} {name} {n}, plan "
                  f"(blocks, m, halo, threads) {tuple(plan)}: 1, 2 and "
                  f"2m+3 steps bit for bit against its twin and "
                  f"resident_kernel on the integer, pi/100 and inf fills"
                  + (", and one block" if n == N_1D_SMALL else "")
                  + f"; max abs err {err}", flush=True)
        for name, n in (("1d1r", 3001), ("1d1r", N_1D_SMALL),
                        ("1d2r", N_1D_SMALL), ("m5", N_1D_SMALL),
                        ("m9", N_1D_SMALL),
                        ("m32", N_1D_SMALL), ("m16", 65_536),
                        ("m32", 65_536),
                        ("1d1r", largest_resident_1d("1d1r", dtype, True))):
            plan, err = check_lanes_run(name, n, dtype, device)
            errs_new[("lanes_run", dtype)] = max(
                errs_new.get(("lanes_run", dtype), 0.0), err)
            print(f"phase 8: narrow run_kernel {str(dtype)[6:]} {name} {n}, "
                  f"plan (blocks, m, halo, threads) {tuple(plan)}: 1, 2, 7 "
                  f"and 2m+3 steps bit for bit against its twin and "
                  f"resident_kernel on the integer, pi/100 and inf fills, "
                  f"and one block and four where they fit; max abs err "
                  f"{err}", flush=True)

    launches_1d, cases_1d, lines = main_path_1d(device)
    for line in lines:
        print(f"phase 9: {line}", flush=True)
    print(f"phase 9: launches over the phase, counted from zero: "
          f"{launches_1d}", flush=True)
    if launches_1d["stencil1d_lanes_run"] != launches_1d[
            "stencil1d_resident_lanes"]:
        raise AssertionError("a float32 narrow run missed run_kernel")

    timing_1d = bench_1d(device, card)

    errs_fp64 = {}
    for name, interior, guard in FP64_2D_CASES:
        abs_err, rel, same = check_kernel_fp64(name, interior, device, guard)
        if name == "star2d1r" and interior == INTERIOR:
            errs_fp64["df64_step"] = (abs_err, rel, same)
        print(f"phase 11: df64_step {name} {interior} guard "
              f"{guard or 'default'}: the float64 strip kernel, bit-equal to "
              f"the float64 tile kernel and the twin on the integer, pi/100 "
              f"and inf fills; integer fill bit-exact at 1-2 steps; pi/100 "
              f"fill rel err {rel:.3e} after 4 steps (limit 1e-13), "
              f"bit-equal {same}", flush=True)
    for name, sizes in (("1d1r", (N_1D_SMALL, 3001, N_1D_LARGE)),
                        ("1d2r", (N_1D_SMALL, 3001, N_1D_LARGE)),
                        ("r40", (100_000,)), ("r127", (100_000,))):
        for n in sizes:
            errs = check_kernels_fp64_1d(name, n, device)
            for kernel, (abs_err, rel, same) in errs.items():
                old = errs_fp64.get(kernel, (0.0, 0.0, True))
                errs_fp64[kernel] = (max(old[0], abs_err), max(old[1], rel),
                                     old[2] and same)
                print(f"phase 11: {kernel} {name} {n}: integer fill "
                      f"bit-exact; pi/100 fill rel err {rel:.3e} after 4 "
                      f"steps (limit 1e-13), bit-equal {same}", flush=True)

    launches_fp64, lines = main_path_fp64(device)
    for line in lines:
        print(f"phase 12: {line}", flush=True)
    print(f"phase 12: launches over the phase, counted from zero: "
          f"{launches_fp64}", flush=True)
    if launches_fp64["stencil1d_lanes_run"] != launches_fp64[
            "stencil1d_resident_pair"]:
        raise AssertionError("a float64 narrow run missed run_kernel")
    print(f"phase 12: #12 df64_1d_step {launches_fp64['df64_1d_step']} "
          f"launches of pass_kernel<double> (none of lanes_kernel); the "
          f"narrow runs every one on run_kernel: #14 stencil1d_resident_pair "
          f"{launches_fp64['stencil1d_resident_pair']} (launches_run "
          f"{launches_fp64['stencil1d_lanes_run']}), #7 "
          f"stencil1d_resident_lanes {launches_1d['stencil1d_resident_lanes']}"
          f" (launches_run {launches_1d['stencil1d_lanes_run']}, phase 9), "
          f"one a run, none of resident_kernel", flush=True)

    timing_fp64 = bench_fp64(device, card)
    timing_fp64["stencil1d_resident_pair"] = timing_1d[
        "stencil1d_resident_pair"]

    errs_fused = {}
    for name, interior, k, dtypes in FUSED_CASES:
        for dtype in dtypes:
            errs, strip = check_fused(name, interior, k, dtype, device)
            if name == FUSED_SHAPE and interior == INTERIOR:
                errs_fused = errs
            which = ("the fused strip kernel from both wrappers, bit-equal "
                     "to the tile-based fused and skew kernels," if strip
                     else "the tile-based fused and skew kernels")
            print(f"phase 14: {name} {interior} {dtype} k={k}: {which} "
                  f"bit-equal to single-step launches on both "
                  f"fills and to their twins on the 0/1 fill; pi/100 fill "
                  f"rel err fused {errs['fused'][1]:.3e}, skew "
                  f"{errs['skew'][1]:.3e} after {2 * k} steps", flush=True)
    errs_res = {}
    for name, interior, dtype in RESIDENT_CASES:
        errs_res[(name, dtype)] = check_resident(name, interior, dtype,
                                                 device)
        print(f"phase 14: resident {name} {interior} {dtype}: the "
              f"shared-memory kernel, bit-equal to single-step launches and "
              f"the grid-synced resident kernel at 1, 2 and 4 steps and to "
              f"its twin "
              f"on the integer fill; pi/100 "
              f"fill rel err {errs_res[(name, dtype)][1]:.3e} against the "
              f"fp64 ground truth after 4 steps", flush=True)

    launches_fused, errs_paths, lines = main_path_fused(device)
    for line in lines:
        print(f"phase 15: {line}", flush=True)

    timing_fused = bench_fused(device, card)

    errs_fp64_3d = {}
    for name in SHAPES_3D:
        for interior in ((37, 45, 130), INTERIOR_3D):
            for K in (1, 2):
                abs_err, rel, same = check_kernel_fp64_3d(name, interior, K,
                                                          device)
                if interior == INTERIOR_3D and K == 1:
                    errs_fp64_3d[name] = abs_err
                print(f"phase 17: df64_3d_step {name} {interior} K={K}: "
                      f"the march kernel, bit-equal to the general kernel; "
                      f"integer fill bit-exact against its twin and a float64 "
                      f"dense stencil after 1-2 passes; pi/100 fill rel err "
                      f"{rel:.3e} after 4 steps (limit 1e-13), bit-equal "
                      f"{same}", flush=True)

    launches_fp64_3d, total, lines = main_path_fp64_3d(device)
    for line in lines:
        print(f"phase 18: {line}", flush=True)
    print(f"phase 18: df64_3d_step launches over the phase, counted from "
          f"zero: {total}", flush=True)

    timing_fp64_3d = bench_fp64_3d(device, card)

    march_ms = [(f"float32 k=2 {name}", timing_3d[name][0],
                 timing_3d[name][5], timing_3d[name][3]) for name in SHAPES_3D]
    for name in SHAPES_3D:
        t = timing_fp64_3d[name]
        march_ms += [(f"df64 k=1 {name}", t["ms"], t["general_kernel_ms"],
                      t["bound_ms"]),
                     (f"float64 k=2 {name}", t["float64_k2_ms"],
                      t["float64_general_k2_ms"], t["bound_ms"])]
    wide_large = redesigned(device, card, builds, (ms2, plain_ms2, tile_ms2),
                            lib2, timing_fp64["df64_step"], march_ms,
                            timing_1d)

    ghost_launches = check_ghost_kernels(device)
    print(f"phase 21: each kernel that gained a bounds branch, with the "
          f"engine's ghost bounds on a ring the refresh filled, bit for bit "
          f"against its twin and k steps of the float64 ground truth "
          f"(integer fill, periodic and reflect): launches "
          f"{ghost_launches}", flush=True)
    ghost = ghost_paths(device, card)
    for rec in ghost:
        line = {m: {k: rec[m][k] for k in ("run_ms", "launches")}
                for m in ("dirichlet0",) + GHOST_MODES}
        for m in GHOST_MODES:
            line[m].update({k: rec[m][k] for k in (
                "path", "k", "ring_depth", "rel_err_4", "refresh_graph_ms",
                "refresh_wall_ms", "refreshes_per_run")})
        print(f"phase 21: {rec['shape']} {tuple(rec['interior'])} "
              f"{rec['dtype']} x{rec['steps']}: run(2) bit-exact against "
              f"the float64 wrap / mirror stencil on the card, run(4) "
              f"within rel {'1e-13' if rec['dtype'] == 'df64' else '1e-5'}, "
              f"no whole-grid run; {json.dumps(line)} [{card}]", flush=True)
    print(json.dumps({"ghost": ghost}), flush=True)

    custom = custom_paths(device, card)
    custom["timing"] = custom_timing(device, card)
    print(json.dumps({"custom": {
        k: ({" ".join(map(str, key)): v for key, v in val.items()}
            if k == "timing" else val) for k, val in custom.items()}},
        default=str), flush=True)

    bf16_entries = bf16_phase(device, card)
    bf16_entries += bf16_phase_nd(device, card)
    sharded_entries = sharded_phase(device, card)
    nd_entries, nd_cases = sharded_phase_nd(device, card)
    sharded_entries += nd_entries
    slice_entries = slice_phase(device, card, nd_cases)
    plan_entries = plan_phase(device, card, builds)
    reach_entries = reach_phase(device, card, builds)

    loaded = loaded_reference_modules()
    if loaded:
        raise AssertionError(f"the reference packages were imported: "
                             f"{loaded}")
    kernels = [{
        "name": "stencil2d_step", "route": "cuda",
        "source": SOURCES["stencil2d"], "replaces": REPLACES["stencil2d"],
        "kernel": "strip_kernel", "launches": launches2["stencil2d_k1"],
        "max_abs_err": main_errs[1][0], "ms": ms2, "plain_ms": plain_ms2,
        "bound_ms": bound2, "bound_by": by2, "library_ms": lib2,
        "tile_kernel_ms": tile_ms2}]
    for name in ("star3d1r", "box3d1r"):
        ms3, plain_ms3, lib3, bound3, by3, general3 = timing_3d[name]
        kernels.append({
            "name": f"stencil3d_step[{name}]", "route": "cuda",
            "source": SOURCES["stencil3d"], "replaces": REPLACES["stencil3d"],
            "kernel": "march_kernel",
            "launches": paths_3d[name][3]["stencil3d_march"],
            "max_abs_err": main_errs_3d[name], "ms": ms3,
            "plain_ms": plain_ms3, "bound_ms": bound3, "bound_by": by3,
            "library_ms": lib3, "steps_per_launch": 2, "library_steps": 1,
            "general_kernel_ms": general3})
    for kernel in KERNELS_1D:
        kernels.append(dict({
            "name": kernel, "route": "cuda", "source": SOURCES["stencil1d"],
            "replaces": REPLACES[kernel], "launches": launches_1d[kernel],
            "max_abs_err": errs_1d[kernel]}, **timing_1d[kernel]))
    key = f"stencil1d_lanes_step[1d2r {N_1D_LARGE}]"
    kernels.append(dict({
        "name": key, "route": "cuda", "source": SOURCES["stencil1d"],
        "replaces": REPLACES["stencil1d_lanes_step"],
        "launches": cases_1d[("1d2r", N_1D_LARGE, "mxu")],
        "max_abs_err": errs_new[("lanes", N_1D_LARGE)]}, **timing_1d[key]))
    kernels.append(dict({
        "name": "stencil1d_resident_f64", "route": "cuda",
        "source": SOURCES["stencil1d"],
        "replaces": REPLACES["stencil1d_resident"],
        "launches": launches_fp64["stencil1d_resident_f64"],
        "max_abs_err": errs_new[("run", torch.float64)]},
        **timing_1d["stencil1d_resident_f64"]))
    for kernel in KERNELS_FP64:
        kernels.append(dict({
            "name": "df64_step[star2d1r]" if kernel == "df64_step" else kernel,
            "route": "cuda",
            "source": SOURCES["stencil2d" if kernel == "df64_step"
                              else "stencil1d"],
            "replaces": REPLACES[kernel], "launches": launches_fp64[kernel],
            "max_abs_err": errs_fp64[kernel][0]}, **timing_fp64[kernel]))
    for name, kernel, replaces, launches, err in (
            (f"stencil2d_step[k=2, {FUSED_SHAPE}]", "fused", "stencil2d",
             launches_fused[(FUSED_SHAPE, "extent k=2", "float32")],
             errs_fused["fused"][0]),
            (f"stencil2d_skew_step[{FUSED_SHAPE}]", "skew", "stencil2d_skew",
             launches_fused[(FUSED_SHAPE, "skew", "float32")],
             errs_fused["skew"][0]),
            ("stencil2d_resident[star2d1r 512x512]", "resident",
             "stencil2d_resident",
             launches_fused[("star2d1r", "resident", "float32")],
             errs_res[("star2d1r", torch.float32)][0]),
            ("stencil2d_resident_pair[star2d1r 512x512]", "resident_pair",
             "stencil2d_resident_pair",
             launches_fused[("star2d1r", "resident", "df64")],
             errs_res[("star2d1r", torch.float64)][0]),
            ("stencil2d_resident[custom_r5 480x480]", "resident_r5",
             "stencil2d_resident",
             launches_fused[("custom_r5", "resident", "float32")],
             errs_paths[("custom_r5", "resident", "float32")]),
            ("stencil2d_resident_pair[custom_r5 480x480]",
             "resident_pair_r5",
             "stencil2d_resident_pair",
             launches_fused[("custom_r5", "resident", "df64")],
             errs_paths[("custom_r5", "resident", "df64")])):
        source = ("resident2d" if timing_fused.get(kernel, {}).get("kernel")
                  == "resident_smem_kernel" else "stencil2d")
        kernels.append(dict({
            "name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": REPLACES[replaces], "launches": launches,
            "max_abs_err": err}, **timing_fused[kernel]))
    kernels.append(dict({
        "name": f"df64_1d_flat_step[r40 {N_1D_LARGE}]", "route": "cuda",
        "source": SOURCES["stencil1d"],
        "replaces": REPLACES["df64_1d_flat_step"],
        "launches": launches_fp64["df64_1d_flat_step"],
        "max_abs_err": errs_fp64["df64_1d_flat_step"][0]}, **wide_large))
    for name in SHAPES_3D:
        kernels.append(dict({
            "name": f"df64_3d_step[{name}]", "route": "cuda",
            "source": SOURCES["stencil3d"],
            "replaces": REPLACES["df64_3d_step"], "kernel": "march_kernel",
            "launches": launches_fp64_3d[(name, "df64", 4)],
            "max_abs_err": errs_fp64_3d[name]}, **timing_fp64_3d[name]))
    kernels += custom_kernel_entries(custom)
    kernels += bf16_entries
    kernels += sharded_entries
    kernels += slice_entries
    kernels += plan_entries
    kernels += reach_entries
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
