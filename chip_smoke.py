#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stencil_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each ending in a line of its own:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the CUDA kernels (``csrc/tiled_sweep.cu``, the 3D
   kernel's window schedule, six modes and tile subsets;
   ``csrc/tiled_march.cu``, its d0 march, the homogeneous and source modes
   with pins, bf16 and subsets, the two-level mode with pins and bf16, the
   Chebyshev and dual modes with bf16 and subsets and the coefficient mode
   with pins and subsets; ``csrc/coeff_weights.cu``,
   the coefficient mode's weights; ``csrc/slab_sweep.cu``, the 2D
   kernel's window schedule; ``csrc/slab_march.cu``, its d0 march, every
   mode of the window;
   ``csrc/rma_iterate.cu``) and the native golden from the sources in
   this checkout, all seven compilers started together
   (into ``build/stencil_tpu_torch/``);
3. kernel vs plain: the 2D march (``slab_march``) in every mode against
   its plain version and the window's launch, bitwise, at cfg1, cfg2 (-b
   256), the ragged ``star2d_r2`` and the Poisson 63² and 4096² shapes,
   on Dirichlet, periodic and Neumann d0 faces, in fp32 and bf16 (the
   ``slab_sweep`` rows below ask their plans for the window); each kernel
   mode (3D tiled, 3D tiled with a source,
   each of the two on the march schedule wherever the plan rule gives it,
   so on every homogeneous and source case below,
   the 3D tiled kernel's Chebyshev, dual, two-level and coefficient modes,
   2D slab, 2D slab with a source) against its plain PyTorch version on the
   card, on random fp32
   inputs from a numpy seed, at the main paths' shapes and at ragged, box
   and radius-2 cases, plus remainder runs; each source mode also at each
   of its Poisson paths' own shape, spec, k, tiles, walls and source (one
   launch, and the runner over 19 sweeps); the Chebyshev mode at nu = 2
   and 4 and the dual mode for weighted Jacobi nu1 = 2 and Chebyshev
   nu1 = 4 (k = 2 .. 5), at 255³ and ragged, each launch on the march and
   on the window, both bitwise their plain version and each other, with
   both dual outputs compared; every fine-level operation of the three
   solver paths of phase 4 at that path's own plan (shape, tiles,
   coefficients) and right-hand side (the Chebyshev and dual ones on both
   schedules); the
   two-level mode on the march at cfg9's plan (wave 256³ k=8), at k=1 and
   ragged k=3 and k=8, both outputs, each launch bitwise its plain version
   and the window's launch, and ``WaveEquation.simulate(method="tiled")`` with a
   remainder against the eager leapfrog; the coefficient mode on the
   march, each case the weights kernel bitwise its plain version and the
   march launch through its weights bitwise its plain version and the
   window's launch from a(x): cfg16's plan (256³ k=8, two_material
   contrast 100) and ragged k=3, with ``--periodic 0 1`` at 256³,
   ``--neumann 1`` and periodic 0 + Neumann 1 ragged, and as cfg18's k=1
   matvec (255³) at every ``OperatorMultigrid`` level on a random ghost
   ring, the level's own weights equal to the kernel's; the pins
   (periodic and Neumann faces live) of every other
   mode on a dynamic-wall path, on refreshed random grids: the 3D kernel
   at 256³ k=8 with periodic 0 1, Neumann 0 1 and periodic 0 + Neumann 1,
   ragged k=3, ``laplace3d_ho`` k=4, ``--periodic all`` at k=1, and at the
   streamed paths' chunk plans and pins (1024³ in 8 chunks: the first, an
   inner and the last chunk; 256³ in 4 with each wall mix), the live d0
   ghost planes random data; its source
   mode at the periodic/Neumann Poisson path's plan; its two-level mode on
   the march at cfg9's plan and ragged with periodic 0 + Neumann 1 and
   ragged k=1 periodic (both outputs, also against the window); the 2D
   kernel at cfg1's plan (periodic 0, Neumann 0), cfg2's, ``star2d_r2``
   ragged, ``--periodic all`` at k=1 and its source mode at 4096²; and
   the runners over a remainder against the eager iterate; then every
   mode but the coefficient one in bfloat16, each case required bitwise:
   the 3D kernel at cfg3's plan (jacobi7 256³ k=8), cfg4's full shape
   (``laplace3d_ho`` 384³ k=4), ragged, ``jacobi27`` and on inputs near 0
   (fp32 subnormals, signed zeros); its source mode at the bf16 Poisson
   path's plan (one launch and the runner) and ragged near 0; its
   Chebyshev and dual modes at 255³, ragged and the bf16 multigrid path's
   63³, on both schedules; its two-level mode on the march at cfg9's
   plan, ragged k=1 and
   ragged k=3 near 0 (also against the window), with periodic 0 + Neumann
   1 at cfg9's plan, ragged k=3 near 0 and ragged k=8; its pins
   (periodic, Neumann, mixed, radius 2) and those of its source mode; the 2D
   kernel at cfg1's and cfg2's plans, ``star2d_r2`` ragged near 0, its
   source mode at 4096² and its pins; and the bf16 runners over a
   remainder against the eager bf16 iterate; then the tile subsets (B1f):
   for every mode that takes one, the interior and then the edge columns
   (``partition_tiles``) launched into one output, each launch bitwise
   against its plain version and the pair bitwise against the full launch,
   with rank (0, 0)'s pins of a (2, 2) mesh (its hi faces mesh-internal,
   live) or a dynamic-wall path's: homogeneous and source, fp32 and bf16,
   at the local blocks of the phase-4 sharded paths (256³ over (2, 2)) and
   of phase 5 (1024³ over (2, 2)), their remainder depth, ragged, radius
   2 and ``jacobi27``; the Chebyshev and dual modes on both schedules in
   fp32 and bf16, the coefficient mode on the march (through its weights)
   and on the window;
   then B3 (``rma_iterate``, the in-kernel exchange): one launch of
   ``iters // k`` outer steps and one of the remainder on every rank's
   buffers, both slots bitwise the plain version's (the kernel runs the
   sweeps between in shared memory and leaves the compute buffers alone),
   with distinct face values, at the cases of ``RMA_CASES``: Dirichlet fp32
   (jacobi7 64×64×128 k=2 on (1,), (2,), (2, 2); a box on (2, 4); radius 2
   on (2, 2); 2D with a remainder on (4,) and on (2, 2); 128³ on (2, 2)),
   on dynamic walls (rings of 1, 2 and 4 in d0 and d1, Neumann mirrors,
   the local refresh of d1 on (2,), mixed walls, jacobi27, a box, radius
   2, 2D) and in bf16 (the bench cell on (1,), rings, the refresh, 2D, and
   160³ on (1,), which fits the L2 only in bf16); and the march itself:
   ``jacobi7``, ``jacobi27`` and ``star3d_r2`` in fp32 and bf16 at k = 1,
   2, 3 and 8 on the ragged 57×50×46, then with ``--periodic 0 1``,
   ``--neumann 0 1`` and the source mode, each launch bitwise its plain
   version on the whole padded output and bitwise the window schedule's
   launch of the same sweeps (filed under the window's modes), and the
   window's own subset launches;
4. main paths, each with the launch counts set to 0 just before it and
   read just after (every launch of a homogeneous or source path must be
   a march launch, ``march_launches`` and its mode's ``march_*`` count: the
   headline, cfg3, the Poisson runners (cfg8), the sharded paths; every
   2D path runs on the schedule ``make_slab_plan`` gives it, required, and
   the ``slab_sweep*`` rows count its window launches, the
   ``slab_march*`` rows its march launches): the 3D
   CLI (``-s 256 256 256 --spec jacobi7 -m
   pallas_temporal -k 8 -i 64 -c``), the 2D CLI (``-s 512 512 --spec
   jacobi5 -m pallas_temporal -k 16 -i 1024 -c`` and ``-s 4096 4096 --spec
   jacobi9 -m pallas_temporal -k 4 -b 256 -i 64 -c``), each passing the
   float64 golden check over every iteration; the Poisson model's
   manufactured solves (2D 63², 3D 31³, ``method="auto"``), each within
   5 h² of the exact solution; the Poisson runner (``method="auto"``, k=8)
   at 4096² and at 256³ against the float64 golden with the source over 8
   iterations, one launch (the NumPy golden; the native one has no source
   term); the solver CLI (``--solve poisson``): PCG with Chebyshev multigrid on
   the tiled fine level at 255³ (``--smoother chebyshev --tol 1e-5 -i 50``, the
   Chebyshev and dual modes), multigrid V(4,4) cycles at 255³ (``--solver mg
   --nu-smooth 4 4 -i 30``, the source and dual modes) and FMG at 63³ on the
   tiled fine level (``--solver fmg --fine-method pallas_tiled``), each
   converged and within 3 h² of the exact solution (4 h² for the
   weighted-Jacobi tiled cycle, whose fp32 floor is ~3.3 h² at 255³; see
   ``SOLVE_PATHS``), the float64 certificate printed, and cfg17's
   Chebyshev V(4,4) cycles at 255³ (their update norm falling), each
   fine-level launch counted in the row of its plan's schedule
   (``tiled_march+cheby``, ``tiled_march+dual``: the march from k=2 on)
   and every one of the path's rows launched; the
   wave at 256³ (16 steps on ``tiled`` k=8 against ``eager``, every launch
   a march two-level one) and at 64³
   (against the float64 golden loop and the analytic standing mode);
   ``-s 128 128 128 --spec jacobi7 -m varcoeff -k 8 -i 64 -c`` against the
   float64 field golden (capped at 50 iterations); ``--solve hetero -s 255
   255 255 --tol 1e-4 -c`` with ``--op-kernel auto`` and ``pallas``, both
   converged within one iteration of each other (the ``pallas`` run and
   ``-m varcoeff`` with ``plan`` schedule ``march``, every coefficient
   launch a march one, the weights formed once per runner and once per
   multigrid level); then the dynamic-wall
   paths, each launch of each a pins launch of its mode: the 3D CLI with
   ``--periodic 0 1`` at k=8 and ``-m pallas --periodic all`` (k=1), the
   2D CLI cfg1 with ``--periodic 0``, each ``-c`` over every iteration;
   the Poisson runner at 256³ (periodic 0, Neumann 1) and 4096² (periodic
   0) against the float64 golden with the source; the wave at 256³
   (periodic 0, Neumann 1) tiled against eager; ``-m varcoeff --periodic
   0 1 -c``; the advection family (upwind at cfg12's velocity on a box
   periodic in d0 and d1 at k=8 against the native golden, and integer
   CFL on a fully periodic box at k=1, bitwise against
   ``exact_translate``); then the bf16 paths, each launch of each a bf16
   one: cfg3 (``-s 256 256 256 --spec jacobi7 -m pallas_temporal -k 8
   --dtype bfloat16 -c``) and cfg4-bf16 (``-s 384 384 384 --spec
   laplace3d_ho -m pallas_temporal -k 4 --dtype bfloat16 -c``) at 16
   iterations, cfg1 in bf16 at 32 (the float64 golden within 3e-2; bf16
   drifts past that bar at greater depth, see ``BF16_TOL``), the Poisson
   runner in bf16 at 256³ (Dirichlet; periodic 0 with Neumann 1) and
   4096² against the float64 golden within 0.15, the multigrid fine level
   in bf16 (Chebyshev V(2,2) at 63³, the card against the CPU's plain
   versions, its two launches on their plans' schedule), the wave in
   bf16 at 256³ (Dirichlet and periodic 0 with
   Neumann 1, tiled against eager), and the 3D CLI with ``--periodic 0
   1`` and cfg1 with ``--periodic 0`` in bf16; then the sharded paths on
   a (2, 2) mesh whose four ranks share the card, every launch of each an
   interior or edge subset launch: ``-s 256 256 256 --spec jacobi7 -m
   sharded_pallas --mesh 2 2 -k 8 -c`` (64 iterations; in bf16 16), ``-m
   sharded --mesh 2 2 -c`` (the eager method, ``jacobi27`` at 64³), the
   sharded Poisson runner at 256³ (periodic 0, Neumann 1; fp32 and bf16)
   bitwise against the single-device Poisson tiled runner, and 2D
   ``sharded_pallas --mesh 4`` at 4096² (the slab kernel) bitwise against
   ``slab``; then the rma bench cell, ``-s 64 64 128 --spec jacobi7 -m rma
   -k 2 -i 64 -c`` on (1,) and with ``--mesh 2 2``, every launch an
   ``rma_iterate`` one, then with ``--periodic 0 1 --mesh 2 2`` and
   ``--neumann 1 --mesh 2`` (every launch a pins one) and with ``--dtype
   bfloat16`` on (1,) and (2, 2) at 16 sweeps (every launch a bf16 one),
   and each runner's sweeps (one launch) bitwise ``tiled`` at k=2 on the
   same walls and dtype; then the out-of-core ``-m streamed`` (jacobi7
   1024³ fp32 ``-k 8 -i 16 --chunks 8`` from a seeded random interior, a
   4 GiB host iterate; at 256³ ``--periodic 0 1`` and ``--periodic 0
   --neumann 1``, also against the float64 golden, and the chunk count
   ``auto_chunks`` gives with ``STENCIL_TPU_HBM_MB`` set small), each
   bitwise ``-m tiled`` at the same k, every launch a march launch with a
   live face (counted in ``tiled_march+pins``); ``-m tiled -k 8`` at 256³
   through ``CheckpointedRun`` (the CLI's ``--checkpoint-dir``),
   interrupted after its first save and resumed, bitwise the
   uninterrupted run, and ``--solve poisson`` 63³ with
   ``--checkpoint-dir``; ``-m pallas_temporal -k 8`` at 256³ with
   ``--dump-image`` and ``--profile`` (a BMP of the right header and size,
   a non-empty trace); and cfg14 and cfg15 (``bench.py:397-432``: advdiff
   255³, velocity (1, -0.5, 0.25), ν 0.05, f from ``default_rng(3)``,
   BiCGStab and GMRES(8) right-preconditioned by OperatorMultigrid, tol
   1e-4), each converged with a float64 certificate under 1e-4, their
   iterations and time to solution (a host clock around the solve and its
   fetch, the median of 3 after a warm-up). Phase 4's CLI runs time their
   paths with a 0.3 s signal (``BENCH_SIGNAL_S``), as phase 5 does;
5. times: GLUPS of the 3D tiled kernel on the march and on the window
   schedule at k = 1, 2, 4 and 8 and of ``eager`` at 256³ (the k=1 pair
   printed beside the schedule the plan rule gives k=1); cfg3–cfg6 and
   cfg8 on both schedules (cfg5, cfg6 and cfg8 required to march); the
   sharded 1024³ meshes on both; of cfg1 (2D 5-pt 512², slab k=16) and
   cfg2 (2D 9-pt 4096², slab, both also on the schedule their plans do
   not give; every ``slab_sweep`` mode's launch beside the march's launch
   of its sweeps, the ``slab_march`` rows the main paths launch (cfg2,
   the 63² Poisson solve) timed at their shapes beside the window's;
   cfg1's host µs per launch, the iterate's return before a synchronize,
   beside its wall and device time per launch on both schedules; cfg2 at
   k=4, ``-b 256``) and ``eager`` at both sizes; of cfg8 (Poisson 256³, the
   tiled source kernel at k=8); ms per V-cycle, contraction per cycle and
   ms per decade of cfg10 (weighted Jacobi V(4,4), tiled fine level), cfg11
   (Chebyshev V(2,2), eager fine level), cfg17 (Chebyshev V(4,4), tiled
   fine level) and weighted Jacobi V(2,2) on both fine levels, at 255³ with
   a seeded random f, each tiled one again with every fine plan on the
   window (:func:`on_window`; the same contraction required), each with
   the device's busy ms per cycle; cfg13 (PCG, Chebyshev multigrid on the
   tiled fine level, 255³, random f, tol 1e-4, at most 50 iterations) as
   time to solution and iterations, also on the window (the same
   iterations required); the error floor of the multigrid cycles at
   255³ (manufactured sine, error against the exact solution per cycle)
   in fp32 on both fine levels and in fp64 on the eager one; cfg9 (the
   wave at 256³, leapfrog steps per second) on ``tiled`` k=8, on the march
   and on the window, and ``eager``; cfg16/cfg16b (FTCS diffusion at
   256³) on the coefficient mode k=8, on the march and on the window, and
   the eager field sweep; cfg18 (BiCGStab + OperatorMultigrid, 255³, tol
   1e-4, f seed 7) as time to solution and iterations with
   ``--op-kernel auto`` and ``pallas``, and each solve's device idle share;
   for each kernel mode one launch's kernel ms
   against its plain version's, against one call of
   ``torch.nn.functional.conv3d``/``conv2d`` that computes one sweep of
   the mode (fp32, TF32 off; for the two-level mode one 2-channel conv3d
   per step; none for the coefficient mode, whose weights are per point:
   the eager field sweep is printed beside it) and against the bound the
   card's peaks give, at a main path's shape (the source modes at the
   Poisson golden checks', the Chebyshev and dual modes at the PCG path's
   (cfg13's two launches) and at cfg10's and cfg17's (k = 4, 5), each on
   the march and on the window in turns,
   the two-level mode at cfg9's beside the window's launch, the
   coefficient mode at cfg16's beside
   the window's launch, the weights kernel at cfg16's padded grid, and the
   k=1 matvec at cfg18's beside the window's and the eager matvec); the
   device's busy
   share over cfg1's main-path run and over one cfg13 solve, from
   ``torch.profiler`` traces; then GLUPS of 3D k=8 ``--periodic 0 1`` and
   cfg1 ``--periodic 0`` beside the Dirichlet runs, of cfg12 (upwind
   advection 256³ k=8, reference walls) beside eager and a periodic (0, 1)
   box, the device's busy share of 3D k=8 on Dirichlet and periodic walls
   and of cfg1 periodic, and one launch of each pins mode against its
   plain version, its bound and a conv yardstick after the library's own
   walls (``F.pad`` circular or replicate), with the runner's refresh
   beside it; GLUPS of cfg3 and cfg4-bf16 and of the fp32 cfg4, cfg5
   (256×256×1024 k=8) and cfg6 (ragged 257³ k=8); one launch of each
   bf16 mode against its plain version, its bound (2 bytes per value) and
   one bf16 ``conv3d``/``conv2d`` call; BASELINE.json:11's sharded
   headline, jacobi7 1024³ fp32 k=8 from a seeded random interior, on
   ``tiled`` and on ``sharded_pallas`` over (1,), (2,), (2, 2) and (2, 2)
   with ``--no-overlap``, each result bitwise the single-device one after
   16 sweeps (the race check of the in-place exchange), with GLUPS, ms per
   outer step (the marginal of 16 and 32 sweeps), the exchange's ms alone
   on its side stream, the bytes it moves (the audit) and the (2, 2) run's
   device idle share; one interior and one edge launch of each subset mode
   beside the full launch on the same block (rank 0's at 1024³ for
   ``tiled_sweep+subset``, at the phase-4 paths' 128×128×256 for the other
   three); the rma bench cell (64×64×128 k=2) and 128³ on (1,) and (2, 2)
   as GLUPS and ms per outer step beside ``tiled`` k=2 and k=8, the bench
   cell with ``--periodic 0 1`` on (2, 2), ``--neumann 1`` on (2,) and in
   bf16 on (1,) and (2, 2), and 160³ bf16 on (1,), each beside ``tiled``
   k=2 on the same walls and dtype, the bench cell's idle share, and
   launches alone of 32 and 64 steps at the bench cell, with each of
   those walls and dtypes, and at 8×8×16, whose step is mostly the
   kernel's fixed cost per step (the wait on the flags, the barriers
   inside a block), each with its tile count and flag waits per step;
   the streamed path at 1024³ (jacobi7 k=8, 8 chunks) through its
   registry runner as ms per outer step (the runner's marginal, in whole
   outer steps), beside its bound (the bytes up and down per step over
   the pinned-copy rates measured in the run, one way at a time and both
   at once) and the chunk launches' device time in a profiler trace of
   two outer steps.

The march replaces the window schedule in the homogeneous and source
modes, with pins, bf16 and subsets, in the two-level mode with pins and
bf16, in the Chebyshev and dual modes with bf16, and in the coefficient
mode with pins: their rows are
``tiled_march...``, each with ``window_ms``, the
window schedule's time for the same launch (its own chooser's tiles; a
subset row the window's interior + edge pair; the coefficient rows the
window's launch from a(x)). The ``coeff_weights`` row is the weights
kernel at cfg16's padded grid: a(x) read once and four fields written,
``WEIGHTS_KERNEL_OPS`` per padded point; its ``launches`` one per
phase-4 varcoeff run and one per multigrid level of the hetero run. The
coefficient subsets' pair is printed beside the window's pair (no
phase-4 path runs them).

Each kernel's ``launches`` in the kernel record sums the phase-4 runs of
that mode (a bf16 mode, name ending ``+bf16``, its bf16 runs); its
``max_abs_err`` is the largest of its phase-3 cases. Its ``bound_ms`` is
the larger of the bytes the launch must move (each operand read once
where the function needs it: the input over the interior and, at a
pinned face, the wall layer its taps read, at a live face the k*r ghosts
the launch updates; a source at the points it is added to; each output's
interior written once; at the plan's 4 or 2 bytes per value) over 3.35
TB/s and its floating-point operations (every
sweep's update of every interior point; in the coefficient mode, which
a(x) fixes, the weights once per point and launch, ``COEFF_WEIGHT_OPS``,
and ``COEFF_SWEEP_OPS`` per update) over 67 TFLOP/s in fp32 and 989
TFLOP/s in bf16, the H100 SXM's published peaks; ``bound_by`` names the
larger.
The two-level mode reads its input level so and the older level at the
points it updates, and writes two interiors; the coefficient mode reads
u and a(x) where the taps need them and writes one interior. A
subset mode's ``ms`` is one interior launch plus one edge launch, its
``plain_ms`` their plain versions', its ``bound_ms`` the two launches'
bounds summed, each the input cells its columns' points need read once
and its columns written once (the full launch's bound is printed beside), its
``library_ms`` one conv3d sweep over the block. The ``rma_iterate`` row is
one launch of 32 outer steps of the bench cell on (1,): its bound reads
the grid with its radius-deep ghosts once and writes the interior once,
with the taps of all 64 sweeps; its ``library_ms`` one conv3d sweep of
the grid; its ``launches`` the two phase-4 CLI runs'. The
``rma_iterate+pins`` row is the same launch with ``--neumann 1`` on (2,)
(the library after ``F.pad``), its ``launches`` the pins launches of the
two phase-4 dynamic-wall runs; ``rma_iterate+bf16`` the bf16 launch on
(1,) at 2 bytes per value and the bf16 rate, its ``launches`` the bf16
launches of the two phase-4 bf16 runs. The runner-against-eager case on a
Neumann face is printed apart from the kernel rows (it agrees to fp32
rounding, where every kernel-against-plain case is bitwise).

The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
so does a host without a CUDA device, or a directory without the package.
"""

import concurrent.futures
import contextlib
import functools
import itertools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# kernel vs plain: the same taps in the same order, the source added after
# them, no FMA contraction, so the two should agree bitwise; a difference
# up to this much is tolerated (and reported) in case a compiler reorders
KERNEL_TOL = 1e-6
# the float64 golden bar, the reference's
GOLDEN_TOL = 1e-4
DEVICE = "cuda"
MAIN_SIZE = (256, 256, 256)
RAGGED_SIZE = (57, 50, 46)
BOX_SIZE = (64, 48, 80)
MAIN_ITERS = 64
CFG1 = ("jacobi5", (512, 512), 16, None, 1024)   # spec, size, k, -b, -i
CFG2 = ("jacobi9", (4096, 4096), 4, 256, 64)
POISSON_2D = (63, 63)
POISSON_3D = (31, 31, 31)
POISSON_BIG = (256, 256, 256)
POISSON_BIG_2D = (4096, 4096)
POISSON_BIG_ITERS = 8        # one launch of k=8: the NumPy golden's cost
POISSON_COMPARE_ITERS = 19   # two launches of k=8 and a remainder of 3
RAGGED_2D = (250, 333)
SLAB_SOURCE_SIZE = (4096, 4096)
MG_SIZE = (255, 255, 255)
MG_SEED = 2                  # bench.py's seed for the multigrid cells' f
# the solver main paths (phase 4), each run with -c, and the bar on the
# error against the exact solution in units of h^2: the JAX tests' 3 h^2,
# except for weighted Jacobi on the tiled fine level. Its fp32 smoother
# coefficients (1 - omega, omega/6), rounded apart as in the JAX kernel,
# sum to 1 + 1.5e-8, which moves the cycle's fixed point: at 255^3 it
# floors near 3.3 h^2 whatever the tolerance (phase 5 measures the floor),
# so that path is held to 4 h^2
SOLVE_PATHS = (
    ("pcg-cheby", ["--solve", "poisson", "-s", "255", "255", "255",
                   "--smoother", "chebyshev", "--tol", "1e-5", "-i", "50"],
     3.0),
    ("mg-nu4", ["--solve", "poisson", "--solver", "mg", "--nu-smooth", "4",
                "4", "-s", "255", "255", "255", "-i", "30"], 4.0),
    ("fmg", ["--solve", "poisson", "--solver", "fmg", "-s", "63", "63", "63",
             "--fine-method", "pallas_tiled"], 3.0),
)
# the wave (two-level) and heterogeneous-diffusion (coefficient) paths:
# cfg9's wave at 256^3 k=8, cfg16's two-material field (contrast 100,
# seed 0), cfg18's heterogeneous Poisson solve at 255^3 (f seed 7)
WAVE_K = 8
WAVE_STEPS = 16
WAVE_SMALL = (64, 64, 64)
WAVE_TOL = 1e-5              # tiled vs eager on the main path
CONTRAST = 100.0
VARCOEFF_ARGS = ["-s", "128", "128", "128", "--spec", "jacobi7", "-m",
                 "varcoeff", "-k", "8", "-i", "64"]
HETERO_SIZE = (255, 255, 255)
HETERO_ARGS = ["--solve", "hetero", "-s", "255", "255", "255", "--tol",
               "1e-4"]
HETERO_SEED = 7
HETERO_CERT_BAR = 1e-2        # float64 max |f - A u| / max |f|, as the CPU test
HETERO_CERT_AGREE = 0.01      # auto vs pallas certificates, relative
# the dynamic-wall (pins) paths: the advection family's cfg12 velocity
# (bench.py:275-287), its golden run's iterations at k=8, and the
# integer-CFL translations at k=1 on a fully periodic box, each checked
# against exact_translate
# cfg14/cfg15 (bench.py:397-432): steady advection-diffusion at 255^3 by
# BiCGStab and GMRES(8), each right-preconditioned by OperatorMultigrid
ADVDIFF_SIZE = (255, 255, 255)
ADVDIFF_VELOCITY = (1.0, -0.5, 0.25)
ADVDIFF_NU = 0.05
ADVDIFF_SEED = 3
ADVDIFF_TOL = 1e-4
ADVDIFF_MAX_ITERS = 3000
ADVDIFF_RUNS = 3             # timed solves after one warm-up, median taken
# the streamed (out-of-core) paths: 1024^3 (a 4 GiB host iterate) in 8
# chunks, bitwise tiled; the walls and auto chunk count at 256^3
STREAM_SIZE = (1024, 1024, 1024)
STREAM_K = 8
STREAM_ITERS = 16
STREAM_CHUNKS = 8
STREAM_SMALL = (256, 256, 256)
STREAM_WALLS = (((0, 1), ()), ((0,), (1,)))
STREAM_AUTO_HBM_MB = 512     # auto_chunks then gives more than 1 at 256^3
STREAM_TRACE_STEPS = 2       # phase 5: outer steps in the profiler trace
COPY_BYTES = 1 << 30         # phase 5: the pinned-copy rates' transfer
# the marginal timings' signal, seconds: phase 5's GLUPS and the CLI's own
# timing of phase 4's main paths, which phase 4 runs for their checks and
# launch counts. The CLI's default is 0.75 s; the spread of a row's two
# marginals was no wider at 0.3 s (phase 5 prints its median and largest)
BENCH_SIGNAL_S = 0.3
# (relative spread of its two marginals, row) of each phase-5 bench row
MARGINAL_SPREADS = []
ADVECT_VELOCITY = (0.5, -0.25, 0.125)
ADVECT_ITERS = 32
TRANSLATE_VELOCITIES = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0))
TRANSLATE_STEPS = 40
FLOOR_CYCLES = 12            # cycles of the phase-5 floor measurement
CFG17_CYCLES = 4             # cfg17's phase-4 path
CYCLE_REPEATS = 10           # V-cycles per timed run
CYCLE_RUNS = 5               # timed runs per --cycles case
BUSY_CYCLES = 2              # V-cycles per profiler trace of phase 5
CONTRACTION_CYCLES = 6
# bfloat16 (phase 3: every mode but coeff bitwise; phase 4: cfg3,
# bench.py:80-81, and cfg4-bf16, :91-92, with cfg1, cfg8 and the other bf16
# paths; phase 5: their times, and the fp32 cfg4/cfg5/cfg6). Each bf16 -c
# runs fewer iterations than its fp32 path: bf16 rounds every sweep to an
# 8-bit significand and the Jacobi average does not damp the slow modes of
# that rounding, so the float64 golden drifts past the 3e-2 bar with depth
# (jacobi7 at 64 sweeps 3.4e-2 on the CPU, in JAX's xla path as in the
# port's eager one, which agree bitwise; 16 sweeps 1.2e-2; cfg1's 1024
# sweeps 0.34, 32 sweeps 4e-3). cfg4's full-shape launch is also held
# bitwise against the plain version in phase 3.
BF16_TOL = 3e-2              # the JAX suite's bf16 bar (-c uses it too)
BF16_SOURCE_TOL = 0.15       # tests/test_tiled_source.py:85-87
CFG3 = ("jacobi7", (256, 256, 256), 8, 16)          # spec, size, k, -i
CFG4 = ("laplace3d_ho", (384, 384, 384), 4, 16)
CFG1_BF16_ITERS = 32
CFG5 = ("jacobi7", (256, 256, 1024), 8)              # bench.py:100-101
CFG6 = ("jacobi7", (257, 257, 257), 8)               # bench.py:95-96
TINY = 1e-37                 # inputs near 0: fp32 subnormals, signed zeros
BF16_MG_SIZE = (63, 63, 63)  # the bf16 multigrid path: the FMG path's size
BF16_MG_CYCLES = 2
# the sharded paths (B1f, the tiled kernel's tile subsets, on a
# single-controller mesh whose ranks share the card): phase 3 holds each
# subset mode against its plain version at the local blocks of the phase-4
# and phase-5 meshes with rank (0, 0)'s pins (its hi faces mesh-internal);
# phase 4 runs the sharded CLI, Poisson and 2D paths; phase 5 times
# BASELINE.json:11's headline, jacobi7 1024^3 fp32 k=8, on tiled and on
# sharded_pallas over these meshes (name, mesh, overlap)
SHARDED_MESH = (2, 2)
MESH_PINS = (1, 0, 1, 0)
SHARDED_SIZE = (1024, 1024, 1024)
SHARDED_K = 8
SCHEDULE_DEPTHS = (1, 2, 4, 8)  # phase 5: 256^3 GLUPS on both schedules
SHARDED_TIMED = (("tiled", None, True), ("sharded_pallas", (1,), True),
                 ("sharded_pallas", (2,), True),
                 ("sharded_pallas", SHARDED_MESH, True),
                 ("sharded_pallas", SHARDED_MESH, False))
SHARDED_EAGER_SIZE = (64, 64, 64)
SHARDED_2D = ("jacobi5", (4096, 4096), 8, (4,), 16)  # spec, size, k, mesh, -i
# the in-kernel exchange (B3, csrc/rma_iterate.cu): phase 3 holds one
# launch (and one of a remainder) against the plain version on every rank's
# buffers, with distinct face values (a corner of a Dirichlet and a live
# face shows a wrong face), on Dirichlet, periodic and Neumann walls, in
# fp32 and bf16; phase 4 runs the bench cell (bench.py:106-107) through the
# CLI on (1,) and (2, 2), with periodic d0 d1 on (2, 2), Neumann d1 on (2,)
# (the local refresh) and in bf16; phase 5 times them and 128^3, near the
# L2 budget, beside tiled, 160^3 in bf16 (fp32 exceeds the budget there),
# and a tiny block whose steps are mostly the kernel's fixed cost per step
RMA_CASES = (  # spec, global shape, mesh, k, iterations, periodic, neumann,
    # dtype
    ("jacobi7", (64, 64, 128), (1,), 2, 8, (), (), "float32"),
    ("jacobi7", (64, 64, 128), (2,), 2, 8, (), (), "float32"),
    ("jacobi7", (64, 64, 128), (2, 2), 2, 8, (), (), "float32"),
    ("box3", (32, 64, 40), (2, 4), 2, 6, (), (), "float32"),
    ("star3_r2", (32, 32, 20), (2, 2), 2, 6, (), (), "float32"),
    ("jacobi5", (64, 40), (4,), 4, 10, (), (), "float32"),
    ("jacobi5", (32, 256), (2, 2), 2, 7, (), (), "float32"),
    ("jacobi7", (128, 128, 128), (2, 2), 2, 6, (), (), "float32"),
    # rings (of 1, 2 and 4), mirrors, the local refresh of d1, mixed walls
    ("jacobi7", (64, 64, 128), (2, 2), 2, 8, (0, 1), (), "float32"),
    ("jacobi7", (64, 64, 128), (2,), 2, 7, (), (1,), "float32"),
    ("jacobi7", (64, 64, 128), (1,), 2, 7, (0, 1), (), "float32"),
    ("jacobi27", (32, 64, 40), (2,), 3, 7, (0,), (1,), "float32"),
    ("box3", (32, 64, 40), (2, 4), 2, 6, (1,), (0,), "float32"),
    ("star3_r2", (32, 32, 20), (2, 2), 2, 6, (0,), (1,), "float32"),
    ("jacobi5", (64, 40), (4,), 4, 10, (), (0,), "float32"),
    ("jacobi5", (32, 256), (2, 2), 2, 7, (0,), (), "float32"),
    # bf16
    ("jacobi7", (64, 64, 128), (1,), 2, 8, (), (), "bfloat16"),
    ("jacobi7", (64, 64, 128), (2, 2), 2, 7, (0, 1), (), "bfloat16"),
    ("jacobi7", (64, 64, 128), (2,), 2, 8, (), (1,), "bfloat16"),
    ("jacobi27", (32, 64, 40), (2,), 3, 7, (0,), (1,), "bfloat16"),
    ("jacobi5", (32, 256), (2, 2), 2, 7, (), (0,), "bfloat16"),
    ("jacobi7", (160, 160, 160), (1,), 2, 4, (), (), "bfloat16"),
)
RMA_FACES = {2: ((0.5, -1.0), (2.0, 0.25)),
             3: ((0.5, -1.0), (2.0, 0.25), (1.0, 1.5))}
RMA_SIZE = (64, 64, 128)
RMA_K = 2
RMA_ITERS = 64
RMA_BF16_ITERS = 16          # bf16 -c: the 3D bf16 bar's depth (BF16_TOL)
RMA_MESHES = ((1,), (2, 2))
RMA_BIG = (128, 128, 128)
RMA_BF16_BIG = (160, 160, 160)
RMA_TINY = (8, 8, 16)
RMA_STEPS = 32               # the kernel record's launch: 32 outer steps
RMA_TIMED_STEPS = (64, 256)  # the iterate's marginal, in outer steps
RMA_REPEATS = 2              # each marginal's runs, the least taken
# the dynamic-wall and bf16 runs of the bench cell (phases 4 and 5): the
# CLI's wall flags, the mesh, the dtype, the kernel count they all bump,
# the kernel record's mode
RMA_WALL_RUNS = (
    (("--periodic", "0", "1"), (2, 2), "float32", "pins_launches",
     "rma_iterate+pins"),
    (("--neumann", "1"), (2,), "float32", "pins_launches",
     "rma_iterate+pins"),
    ((), (1,), "bfloat16", "bf16_launches", "rma_iterate+bf16"),
    ((), (2, 2), "bfloat16", "bf16_launches", "rma_iterate+bf16"),
)
# the kernel record's launch of each rma mode (walls flags, mesh, dtype):
# the Dirichlet fp32 bench cell on (1,), the refresh's run, bf16 on (1,)
RMA_RECORD = {((), (1,), "float32"): "rma_iterate",
              (("--neumann", "1"), (2,), "float32"): "rma_iterate+pins",
              ((), (1,), "bfloat16"): "rma_iterate+bf16"}
# the H100 SXM's published peaks (NVIDIA's data sheet): device memory, fp32
# outside the tensor cores, and bf16 (the table's rate for bf16 operations)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12


# the kernel record's modes: every fp32 mode, then each bf16 one
KERNEL_MODES = (
    "tiled_march", "tiled_march+source", "tiled_march+cheby",
    "tiled_march+dual", "tiled_march+two_level", "tiled_march+coeff",
    "coeff_weights", "tiled_march+pins", "tiled_march+source+pins",
    "tiled_march+two_level+pins", "tiled_march+coeff+pins", "slab_sweep",
    "slab_sweep+source", "slab_sweep+pins", "slab_sweep+source+pins",
    "tiled_march+bf16", "tiled_march+source+bf16", "tiled_march+cheby+bf16",
    "tiled_march+dual+bf16", "tiled_march+two_level+bf16",
    "tiled_march+pins+bf16", "tiled_march+source+pins+bf16",
    "tiled_march+two_level+pins+bf16", "slab_sweep+bf16",
    "slab_sweep+source+bf16", "slab_sweep+pins+bf16",
    "slab_march", "slab_march+source", "slab_march+pins",
    "slab_march+source+pins", "slab_march+bf16", "slab_march+source+bf16",
    "slab_march+pins+bf16",
    "tiled_march+subset", "tiled_march+source+subset",
    "tiled_march+subset+bf16", "tiled_march+source+subset+bf16",
    "rma_iterate", "rma_iterate+pins", "rma_iterate+bf16")


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def gpu_state():
    """The card's SM and memory clocks, power draw and temperature, as
    ``nvidia-smi`` reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def check_equal(label, got, want, exact=False):
    """Kernel output against the plain version's; returns the max abs
    difference. ``exact`` (the bf16 cases) requires bitwise equality."""
    import torch

    torch.cuda.synchronize()
    require(got.dtype == want.dtype, f"{label}: {got.dtype} vs {want.dtype}")
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    diff = (got.float() - want.float()).abs().max().item()
    bitwise = torch.equal(got, want)
    print(f"  {label}: "
          f"{'bitwise equal' if bitwise else 'max abs diff %.3e' % diff}")
    require(bitwise or not exact, f"{label}: kernel vs plain not bitwise "
            f"({diff:.3e})")
    if not bitwise:
        print(f"    not bitwise: the compiled kernel rounds differently "
              f"from the eager version somewhere; tolerated up to "
              f"{KERNEL_TOL:g}")
    require(diff <= KERNEL_TOL, f"{label}: kernel vs plain {diff} > "
            f"{KERNEL_TOL}")
    return diff


def random_grid(shape, radius, rng, device, bc=None, dtype="float32"):
    """A random interior in [0, 1) with ``bc`` (default the reference
    faces), drawn in fp32 and cast to ``dtype``."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid, torch_dtype

    x = rng.random(shape, dtype=np.float32)
    return HaloGrid.from_interior(
        torch.from_numpy(x).to(torch_dtype(dtype)), halo=radius, bc=bc,
        device=device)


def walls(ndim, periodic=(), neumann=()):
    """The reference faces, ``periodic`` dims wrapped and ``neumann`` dims
    mirrored."""
    from stencil_tpu_torch.core.grid import DirichletBC

    return DirichletBC.reference_default(ndim).with_periodic(periodic) \
        .with_neumann(neumann)


def walls_name(bc):
    ndim = len(bc.values)
    parts = [f"{kind} {' '.join(str(d) for d in range(ndim) if mask[d])}"
             for kind, mask in (("periodic", bc.periodic_mask(ndim)),
                                ("neumann", bc.neumann_mask(ndim)))
             if any(mask)]
    return ", ".join(parts) or "dirichlet"


def refreshed(plan, grid):
    """``grid`` in ``plan``'s layout, its dynamic ghosts refreshed to the
    launch's depth, as the runners hand it to a launch."""
    from stencil_tpu_torch.ops.layout import refresh_dynamic_layout

    return refresh_dynamic_layout(plan.layout.pad_grid(grid), plan.layout,
                                  grid.bc, plan.halo)


def pins_input(plan, bc, rng, device):
    """A random grid with ``bc`` at ``plan``'s shape, refreshed."""
    return refreshed(plan, random_grid(plan.interior_shape, plan.spec.radius,
                                       rng, device, bc))


def compare_pins(kernel, plan, bc, cur, mode, src=None, coeff=None,
                 prev=None, pins=None):
    """One launch of ``plan`` with ``bc``'s pins (or ``pins``) on the
    refreshed ``cur`` against the plain version (both outputs of a
    two-level launch, given ``prev``); ``src``/``coeff`` carry the walls'
    images."""
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    if pins is None:
        pins = dynamic_pins(bc, len(plan.interior_shape))
    label = (f"{mode} {plan.spec.name} {plan.interior_shape} k="
             f"{plan.sweeps_per_call} tiles {plan.tiles}, {walls_name(bc)},"
             f" pins {list(pins)}")
    if prev is not None:
        got = kernel(cur, cur.clone(), plan, pins=pins, prev=prev,
                     out2=prev.clone())
        want = sweep_reference(cur, plan, prev=prev, pins=pins)
        return max(check_equal(f"{label}, L_(n+k)", got[0], want[0]),
                   check_equal(f"{label}, L_(n+k-1)", got[1], want[1]))
    return check_equal(label, kernel(cur, cur.clone(), plan, src, pins,
                                     coeff=coeff),
                       sweep_reference(cur, plan, src, coeff=coeff,
                                       pins=pins))


def compare_stream_chunks(kernel, rng, device):
    """One launch of each streamed chunk plan at the shape and pins a
    phase-4 streamed path gives it, against the plain version: the 1024^3
    run's chunk (``STREAM_CHUNKS`` chunks, k = ``STREAM_K``) with the
    first, an inner and the last chunk's pins, and the 256^3 wall runs'
    first chunk (4 chunks). The input is random, its ghost planes on a
    live d0 face too (the neighbour chunks' planes). Returns the largest
    difference."""
    import torch

    from stencil_tpu_torch.core.grid import DirichletBC
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.streaming import StreamedStencil

    j7 = get_spec("jacobi7")
    cases = [(StreamedStencil(j7, STREAM_SIZE, sweeps_per_call=STREAM_K,
                              chunks=STREAM_CHUNKS, device=device),
              DirichletBC.reference_default(3), ci)
             for ci in (0, 1, STREAM_CHUNKS - 1)]
    cases += [(StreamedStencil(j7, STREAM_SMALL, sweeps_per_call=STREAM_K,
                               chunks=4, device=device),
               walls(3, periodic, neumann), 0)
              for periodic, neumann in STREAM_WALLS]
    errs = []
    for m, bc, ci in cases:
        plan, pins = m.plans[ci], m.chunk_pins(ci, bc)
        cur = pins_input(plan, bc, rng, device)
        h = plan.halo
        n1, n2 = plan.interior_shape[1:]
        for rows, pin in zip((slice(0, h), slice(-h, None)), pins[:2]):
            if not pin:
                cur[rows, h:h + n1, h:h + n2] = torch.from_numpy(
                    rng.random((h, n1, n2), dtype=np.float32)).to(device)
        errs.append(compare_pins(kernel, plan, bc, cur,
                                 f"streamed chunk {ci} of {m.num_chunks}",
                                 pins=pins))
        del cur
    return max(errs)


def bf16_input(plan, bc, rng, device, tiny=False):
    """A random bf16 padded input of ``plan`` with walls ``bc``, refreshed
    as the runners hand it to a launch; with ``tiny`` its values lie near 0
    (about TINY: fp32 and bf16 subnormals, exact and negative zeros, and
    walls of 1e-38), where the rounding after each op meets the subnormal
    range."""
    import torch

    from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid

    shape = plan.interior_shape
    x = rng.random(shape, dtype=np.float32)
    if tiny:
        x = (x - np.float32(0.5)) * np.float32(TINY)
        flat = x.reshape(-1)
        flat[::3] = 0.0
        flat[1::5] = -0.0
        bc = DirichletBC(values=((1e-38, -1e-39),) * len(shape),
                         periodic=bc.periodic, neumann=bc.neumann)
    grid = HaloGrid.from_interior(torch.from_numpy(x).to(torch.bfloat16),
                                  halo=plan.spec.radius, bc=bc,
                                  device=device)
    return refreshed(plan, grid)


def compare_bf16(kernel, plan, mode, rng, device, bc=None, tiny=False,
                 src_scale=None, f=None, prev=False):
    """One launch of the bf16 ``plan`` against its plain version, bitwise,
    on a random input (``tiny``: near 0) with walls ``bc`` (default the
    reference faces) and their pins: with ``src_scale`` a padded source
    (``f``, default random), with ``prev`` an older level and both
    outputs, a dual plan's two outputs."""
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    nd = len(plan.interior_shape)
    bc = bc if bc is not None else walls(nd)
    cur = bf16_input(plan, bc, rng, device, tiny)
    pins = dynamic_pins(bc, nd)
    label = (f"{mode} {plan.spec.name} {plan.interior_shape} k="
             f"{plan.sweeps_per_call} tiles {plan.tiles}, {walls_name(bc)}"
             f"{', values near 0' if tiny else ''}")
    if prev:
        older = bf16_input(plan, bc, rng, device, tiny)
        got = kernel(cur, cur.clone(), plan, pins=pins, prev=older,
                     out2=older.clone())
        want = sweep_reference(cur, plan, prev=older, pins=pins)
        return max(check_equal(f"{label}, L_(n+k)", got[0], want[0], True),
                   check_equal(f"{label}, L_(n+k-1)", got[1], want[1], True))
    src = None
    if src_scale is not None:
        if f is None:
            f = rng.normal(size=plan.interior_shape) * (TINY if tiny else 1)
        src = pad_source(plan, f, src_scale, bc).to(device)
    return check_equal(label, kernel(cur, cur.clone(), plan, src, pins),
                       sweep_reference(cur, plan, src, pins=pins), True)


def compare_launch(kernel, make_plan, spec, shape, k, rng, device,
                   t0=None, scale=None):
    """One launch of k sweeps against the plain version; ``scale`` adds a
    random source of that scale."""
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference

    plan = make_plan(spec, shape, "float32", k, t0_fixed=t0)
    grid = random_grid(shape, spec.radius, rng, device)
    cur = plan.layout.pad_grid(grid)
    src = None
    if scale is not None:
        src = pad_source(plan, rng.normal(size=shape), scale,
                         grid.bc).to(device)
    got = kernel(cur, cur.clone(), plan, src)
    want = sweep_reference(cur, plan, src)
    return check_equal(f"{kernel.name}{'+source' if src is not None else ''}"
                       f" {spec.name} {shape} k={k} tiles {plan.tiles}",
                       got, want)


def compare_march(kernel, spec, shape, k, dtype, bc, source, rng, device):
    """One launch of the march plan of ``spec`` at ``shape``, k sweeps, in
    ``dtype``, on walls ``bc`` with their pins (``source``: a random padded
    source), bitwise against its plain version on the whole padded output
    and against the window schedule's launch of the same sweeps where a
    window fits. Returns {mode: max abs difference} for the march's mode
    and, where it ran, the window's (``tiled_sweep...``)."""
    import torch

    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins, make_tiled_plan

    plan = make_tiled_plan(spec, shape, dtype, k, has_source=source)
    require(plan.schedule == "march", f"{spec.name} {shape} k={k} {dtype}: "
            f"a {plan.schedule} plan")
    try:
        window = make_tiled_plan(spec, shape, dtype, k, has_source=source,
                                 schedule="window")
    except ValueError:
        window = None  # no window fits: the march alone runs these sweeps
    cur = (bf16_input(plan, bc, rng, device) if dtype == "bfloat16"
           else pins_input(plan, bc, rng, device))
    src = pad_source(plan, rng.normal(size=shape), -0.01, bc).to(device) \
        if source else None
    pins = dynamic_pins(bc, 3)
    suffix = (("+source" if source else "") + ("" if all(pins) else "+pins")
              + ("+bf16" if dtype == "bfloat16" else ""))
    label = (f"{spec.name} {shape} k={k} {dtype}, {walls_name(bc)}, march "
             f"tiles {plan.tiles}")
    want = sweep_reference(cur, plan, src, pins=pins)
    out = {"tiled_march" + suffix: check_equal(
        f"tiled_march{suffix} {label}",
        kernel(cur, cur.clone(), plan, src, pins), want, True)}
    if window is not None:
        got = kernel(cur, cur.clone(), window, src, pins)
        out["tiled_sweep" + suffix] = check_equal(
            f"tiled_sweep{suffix} (window tiles {window.tiles}) {label}",
            got, want, True)
        torch.cuda.synchronize()
    return out


def compare_slab_march(kernel, spec, shape, k, dtype, bc, rng, device,
                       t0=None, scale=None, f=None):
    """One launch of the 2D march plan of ``spec`` at ``shape`` (``t0``:
    the chunk pinned as ``-b`` pins it), k sweeps, in ``dtype``, on walls
    ``bc`` with their pins (``scale``: a padded source of that scale, from
    ``f`` or random), bitwise against its plain version and against the
    window schedule's launch of the same sweeps. Returns {mode: max abs
    difference} for the march's mode (``slab_march...``) and the window's
    (``slab_sweep...``)."""
    import torch

    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.slab import make_slab_plan
    from stencil_tpu_torch.ops.sweep_kernel import dynamic_pins, sweep_reference

    plan = make_slab_plan(spec, shape, dtype, k, t0_fixed=t0,
                          schedule="march")
    window = make_slab_plan(spec, shape, dtype, k, t0_fixed=t0,
                            schedule="window")
    require(plan.layout == window.layout, f"{shape}: layouts differ")
    cur = (bf16_input(plan, bc, rng, device) if dtype == "bfloat16"
           else pins_input(plan, bc, rng, device))
    src = None
    if scale is not None:
        src = pad_source(plan, rng.normal(size=shape) if f is None else f,
                         scale, bc).to(device)
    pins = dynamic_pins(bc, 2)
    suffix = (("+source" if src is not None else "")
              + ("" if all(pins) else "+pins")
              + ("+bf16" if dtype == "bfloat16" else ""))
    label = (f"{spec.name} {shape} k={k} {dtype}, {walls_name(bc)}, march "
             f"tiles {plan.tiles}, window tiles {window.tiles}")
    want = sweep_reference(cur, plan, src, pins=pins)
    got = kernel(cur, cur.clone(), plan, src, pins)
    via = kernel(cur, cur.clone(), window, src, pins)
    torch.cuda.synchronize()
    require(torch.equal(got, via), f"slab_march{suffix} {label}: not "
            "bitwise the window's launch")
    return {"slab_march" + suffix: check_equal(
                f"slab_march{suffix} {label}", got, want, True),
            "slab_sweep" + suffix: check_equal(
                f"slab_sweep{suffix} (window) {label}", via, want, True)}


def compare_iterate(stencil_cls, spec, shape, k, iters, rng, device,
                    scale=None, bc=None, dtype="float32", schedule=None):
    """The iterate (iters // k launches plus a remainder launch) against
    the eager iterate, on walls ``bc`` (default the reference faces), in
    ``dtype`` (bf16: bitwise required; no Neumann face there, whose live
    ghosts sum the mirrored taps in another order)."""
    import torch

    from stencil_tpu_torch.core.grid import torch_dtype
    from stencil_tpu_torch.ops import eager
    from stencil_tpu_torch.ops.eager import round_to

    grid = random_grid(shape, spec.radius, rng, device, bc, dtype)
    f = rng.normal(size=shape) if scale is not None else None
    got = stencil_cls(spec, shape, dtype, sweeps_per_call=k, device=device,
                      source=f, source_scale=scale or 1.0, schedule=schedule
                      ).iterate(grid, iters).data
    scaled = None
    if f is not None:
        scaled = torch.from_numpy(f).to(torch_dtype(dtype)).to(device) \
            * round_to(scale, dtype)
    want = eager.iterate(grid, spec, iters, scaled).data
    return check_equal(f"{stencil_cls.__name__}"
                       f"{'+source' if f is not None else ''}"
                       f"{'' if schedule is None else ' ' + schedule} "
                       f"{spec.name} "
                       f"{shape} k={k} {dtype}, {iters} iterations, "
                       f"{walls_name(grid.bc)}", got, want,
                       exact=dtype == "bfloat16")


def compare_poisson(prob, f, kernel, make_plan, rng, device):
    """A Poisson main path's kernel mode against its plain version at that
    path's own shape, spec, k, tiles, walls, dtype and source ``f``: one
    launch, then the runner (``method="auto"``) over POISSON_COMPARE_ITERS
    sweeps against the eager iterate, from a random u (bf16: bitwise
    required)."""
    from stencil_tpu_torch.ops import eager
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference

    runner = prob.runner(f, method="auto")
    k = runner.plan_info["k"]
    exact = prob.dtype == "bfloat16"
    plan = make_plan(prob.spec, prob.shape, prob.dtype, k)
    require(list(plan.tiles) == runner.plan_info["tiles"],
            f"Poisson {prob.shape}: plan {plan.tiles} is not the runner's "
            f"{runner.plan_info}")
    grid = prob.initial_grid(rng.random(prob.shape, dtype=np.float32))
    cur = plan.layout.pad_grid(grid)
    src = pad_source(plan, f, prob.source_scale, grid.bc).to(device)
    label = (f"{kernel.name}+source Poisson {prob.spec.name} {prob.shape} "
             f"k={k} tiles {plan.tiles} {prob.dtype}")
    one = check_equal(f"{label}, one launch",
                      kernel(cur, cur.clone(), plan, src),
                      sweep_reference(cur, plan, src), exact)
    iters = POISSON_COMPARE_ITERS
    got = runner.iterate(grid, iters).data
    want = eager.iterate(grid, prob.spec, iters,
                         src[plan.layout.interior_index]).data
    return max(one, check_equal(f"{label}, the runner over {iters} "
                                f"iterations", got, want, exact))


def cheby_plan(shape, coeffs, dual=False, dtype="float32", schedule=None,
               tiles=None):
    from stencil_tpu_torch.multigrid import nbsum_spec
    from stencil_tpu_torch.ops.tiled import make_tiled_plan

    return make_tiled_plan(nbsum_spec(3), shape, dtype, len(coeffs),
                           has_source=True, cheby_coeffs=coeffs,
                           cheby_dual=dual, schedule=schedule, tiles=tiles)


def cheby_row(plan):
    """The kernel record's row of a Chebyshev or dual launch of ``plan``:
    ``tiled_march+...`` on the march, ``tiled_sweep+...`` on the window."""
    return (("tiled_march" if plan.schedule == "march" else "tiled_sweep")
            + ("+dual" if plan.cheby_dual else "+cheby")
            + ("+bf16" if plan.dtype == "bfloat16" else ""))


def mg_coeffs(shape, nu, smoother, dual):
    """The multigrid fine level's coefficient tuples at ``shape`` (h =
    1/(n0+1)): ``nu`` smoother sweeps, then the residual when ``dual``."""
    from stencil_tpu_torch.multigrid import _cheby_sweep_coeffs

    h = 1.0 / (shape[0] + 1)
    if smoother == "chebyshev":
        co = _cheby_sweep_coeffs(nu, 4.0, 3, h)
    else:
        w = 2.0 / 3.0
        co = ((1.0 - w, w / 6, 0.0, -(w / 6) * h * h),) * nu
    if dual:
        co += ((6.0 / h ** 2, -1.0 / h ** 2, 0.0, 1.0),)
    return co


def compare_plan(kernel, plan, grid, src, mode, label):
    """One launch of ``plan`` (row ``mode``) against the plain version
    (bf16: bitwise required); a Chebyshev or dual plan on both schedules
    (:func:`compare_schedules`), both outputs of a dual plan compared.
    Returns {row: max abs difference}."""
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference

    cur = plan.layout.pad_grid(grid)
    if plan.cheby_coeffs:
        return compare_schedules(kernel, plan, cur, src, label)
    return {mode: check_equal(f"{mode} {label}",
                              kernel(cur, cur.clone(), plan, src),
                              sweep_reference(cur, plan, src),
                              plan.dtype == "bfloat16")}


def compare_schedules(kernel, plan, cur, src, label):
    """One Chebyshev or dual launch of ``plan`` on the march and on the
    window (``window_twin``, or the march's twin of a window plan), each
    bitwise its plain version on every output and the two bitwise each
    other. Returns {row: max abs difference} for the two rows
    (:func:`cheby_row`)."""
    import torch

    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference

    other = "window" if plan.schedule == "march" else "march"
    twin = cheby_plan(plan.interior_shape, plan.cheby_coeffs,
                      plan.cheby_dual, plan.dtype, other)
    require(twin.layout == plan.layout, f"{label}: layouts differ")
    want = sweep_reference(cur, plan, src)
    want = list(want) if plan.cheby_dual else [want]
    outs = {}
    for p in (plan, twin):
        got = kernel(cur, cur.clone(), p, src,
                     out2=cur.clone() if p.cheby_dual else None)
        outs[cheby_row(p)] = (p, list(got) if p.cheby_dual else [got])
    (_, a), (_, b) = outs.values()
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            f"{label}: the march's launch is not bitwise the window's")
    return {row: max(check_equal(
        f"{row} {label}, {p.schedule} tiles {p.tiles}, {name}", g, w, True)
        for name, g, w in zip(("residual output", "smoothed output")
                              if p.cheby_dual else ("output",), got, want))
        for row, (p, got) in outs.items()}


def compare_cheby(kernel, shape, nu, smoother, dual, rng, device,
                  dtype="float32"):
    """The Chebyshev (or dual) mode at ``shape`` in ``dtype``, random u
    (reference walls) and a random f, on the march and on the window, each
    bitwise its plain version and the other (:func:`compare_schedules`).
    Returns {row: max abs difference}."""
    from stencil_tpu_torch.ops.layout import pad_source

    plan = cheby_plan(shape, mg_coeffs(shape, nu, smoother, dual), dual,
                      dtype, "march")
    grid = random_grid(shape, 1, rng, device, dtype=dtype)
    src = pad_source(plan, rng.normal(size=shape), 1.0, grid.bc).to(device)
    return compare_schedules(kernel, plan, plan.layout.pad_grid(grid), src,
                             f"{smoother} nu={nu} {shape} k="
                             f"{plan.sweeps_per_call} {dtype}")


def compare_cheby_iterate(shape, k, iters, rng, device):
    """The Chebyshev iterate (iters // k launches and a remainder launch of
    the first coefficients, on the plan's schedule) against the plain
    version's launches."""
    from stencil_tpu_torch.multigrid import nbsum_spec
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.ops.tiled import TiledStencil

    stencil = TiledStencil(nbsum_spec(3), shape, sweeps_per_call=k,
                           device=device, source=rng.normal(size=shape),
                           cheby_coeffs=mg_coeffs(shape, k, "chebyshev",
                                                  False))
    grid = random_grid(shape, 1, rng, device)
    got = stencil.iterate(grid, iters).interior()
    plan, src = stencil.plan, stencil.padded_source(grid.bc)
    cur = plan.layout.pad_grid(grid)
    for _ in range(iters // k):
        cur = sweep_reference(cur, plan, src)
    if iters % k:
        cur = sweep_reference(cur, plan.with_sweeps(iters % k), src)
    return {cheby_row(plan): check_equal(
        f"TiledStencil+cheby {shape} k={k} {plan.schedule}, {iters} "
        f"iterations", got, plan.layout.unpad(cur), True)}


def solve_path(args):
    """A solver main path's problem, right-hand side and multigrid, built
    as the CLI builds them, and the fine-level operations its cycle runs
    (mode name, op)."""
    from stencil_tpu_torch import solve_cli
    from stencil_tpu_torch.config import parse_args

    cfg = parse_args([*args, "--device", DEVICE])
    prob = solve_cli.build_problem(cfg)
    f, u_exact = solve_cli.build_rhs(cfg, prob)
    solver, kind, plan = solve_cli.build_solver(cfg, prob)
    mg = solver.preconditioner if kind == "krylov" else solver
    require(mg is not None and mg.tiled_fine,
            f"solver path {args} does not run the tiled fine level: {plan}")
    pre, res, post, fused = mg._fine_ops()
    require(fused is not None and mg.nu2 > 0, f"{args}: no fused level")
    post_mode = (cheby_row(post.plan) if post.plan.cheby_coeffs
                 else "tiled_march+source")
    require(post.plan.cheby_coeffs or post.plan.schedule == "march",
            f"{args}: the source smoother takes a {post.plan.schedule} plan")
    return prob, f, mg, ((cheby_row(fused.plan), fused), (post_mode, post))


def run_solve_cli(cli, kernel, name, args, bar_h2, label):
    """One solver main path through the CLI, the kernel's counts set to 0
    just before; it must converge within ``bar_h2`` h^2 of the exact
    solution. Returns (record, {mode: launches})."""
    kernel.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "solve.jsonl"
        t0 = time.perf_counter()
        rc = cli.main([*args, "-c", "--device", DEVICE, "--json-out",
                       str(out)])
        seconds = time.perf_counter() - t0
        counts = cheby_counts(kernel)
        rec = json.loads(out.read_text().splitlines()[0])
    n = int(args[args.index("-s") + 1])
    bar = bar_h2 / (n + 1) ** 2
    chk = rec.get("check", {})
    err = chk.get("error_vs_exact", float("nan"))
    print(f"solver path {name} ({' '.join(args)} -c): "
          f"{'converged' if rec.get('converged') else 'NOT converged'} in "
          f"{rec.get('iterations')} iterations, residual_rel "
          f"{rec.get('residual_rel', float('nan')):.3e}; error vs exact "
          f"{err:.3e} (bar {bar_h2:g} h^2 = {bar:.3e}); float64 certificate "
          f"max |f - A u| = {chk.get('residual_f64', float('nan')):.3e} (rel "
          f"{chk.get('residual_f64_rel', float('nan')):.3e}, printed, not "
          f"judged: fp32 floors it); plan {rec.get('plan')}; launches "
          f"{counts}; {seconds:.2f} s with the f64 check [{label}]")
    require(rc == 0 and rec.get("converged"),
            f"solver path {name} returned {rc}: {rec}")
    require(np.isfinite(err) and err < bar,
            f"solver path {name}: error {err} >= {bar}")
    return rec, counts


def cheby_counts(kernel, bf16=False):
    """The launches of a multigrid path by row: the source mode's on the
    march, the Chebyshev and dual modes' on each schedule (``bf16``: the
    bf16 rows, counted in the bf16 counts)."""
    suffix, b = ("+bf16", "_bf16") if bf16 else ("", "")
    march_cheby = getattr(kernel, f"march_cheby{b}_launches")
    march_dual = getattr(kernel, f"march_dual{b}_launches")
    return {"tiled_march+source" + suffix: kernel.march_source_launches,
            "tiled_march+cheby" + suffix: march_cheby,
            "tiled_march+dual" + suffix: march_dual,
            "tiled_sweep+cheby" + suffix:
                kernel.cheby_launches - kernel.march_cheby_launches,
            "tiled_sweep+dual" + suffix:
                kernel.dual_launches - kernel.march_dual_launches}


def cfg17_multigrid():
    """cfg17's multigrid (Chebyshev V(4,4), tiled fine level) at
    MG_SIZE."""
    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.multigrid import Multigrid

    return Multigrid(PoissonProblem(shape=MG_SIZE, device=DEVICE), nu1=4,
                     nu2=4, smoother="chebyshev", fine_method="pallas_tiled")


def cheby_rows(run, bf16=False):
    """The rows of a Chebyshev multigrid runner's two fine-level launches
    (the smoother's and the fused launch's), their plans' schedules."""
    s = run.plan_info["fine_schedules"]
    return tuple(("tiled_march" if s[op] == "march" else "tiled_sweep")
                 + mode + ("+bf16" if bf16 else "")
                 for op, mode in (("pre", "+cheby"), ("fused", "+dual")))


def run_cfg17(kernel, label):
    """cfg17's path: CFG17_CYCLES V-cycles of Chebyshev V(4,4) on the tiled
    fine level at MG_SIZE from u = 0 (bench.py's seeded random f), the
    counts set to 0 just before and read just after; the update norm must
    fall. Returns its launches by row (:func:`cheby_counts`)."""
    import torch

    mg = cfg17_multigrid()
    f = np.random.default_rng(MG_SEED).normal(size=MG_SIZE).astype(
        np.float32)
    run, g = mg.runner(f), mg.problem.initial_grid()
    kernel.reset_counts()
    norms = []
    for _ in range(CFG17_CYCLES):
        nxt = run.iterate(g, 1)
        norms.append(float((nxt.data - g.data).abs().max()))
        g = nxt
    torch.cuda.synchronize()
    counts = cheby_counts(kernel)
    print(f"cfg17 path: chebyshev V(4,4) tiled fine level {MG_SIZE}, "
          f"{CFG17_CYCLES} cycles, update norms "
          f"{[f'{u:.3e}' for u in norms]}; fine schedules "
          f"{run.plan_info['fine_schedules']}; launches {counts} [{label}]")
    require(all(np.isfinite(norms)) and norms[-1] < norms[0],
            f"cfg17: update norms {norms}")
    require(all(counts[m] > 0 for m in cheby_rows(run)),
            f"cfg17: launches {counts}")
    return counts


def wave_plan(shape, k, dtype="float32", schedule=None):
    """The chooser's two-level plan of the wave spec at the CFL limit (the
    rule's schedule, or ``schedule``)."""
    from stencil_tpu_torch.models.wave import WaveEquation
    from stencil_tpu_torch.ops.tiled import make_tiled_plan

    spec = WaveEquation(shape=shape, device=DEVICE).spec
    return make_tiled_plan(spec, shape, dtype, k, two_level=True,
                           schedule=schedule)


def compare_two_level(kernel, shape, k, rng, device, bc=None,
                      dtype="float32", tiny=False):
    """One two-level launch of the march plan of the wave at ``shape``, k
    steps (at k=1 the march asked for: the rule gives the window), in
    ``dtype``, on two random levels with walls ``bc`` (default
    the reference faces) and their pins (bf16 ``tiny``: values near 0),
    bitwise against its plain version and against the window schedule's
    launch, on both outputs. Returns {mode: max abs difference} for the
    march's row (``tiled_march+two_level...``) and the window's
    (``tiled_sweep+two_level...``)."""
    import torch

    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    plan = wave_plan(shape, k, dtype, "march")  # k=1: the rule's is a window
    twin = window_twin(plan)
    bc = bc if bc is not None else walls(3)
    pins = dynamic_pins(bc, 3)
    if dtype == "bfloat16":
        cur, prev = (bf16_input(plan, bc, rng, device, tiny)
                     for _ in range(2))
    else:
        cur, prev = (pins_input(plan, bc, rng, device) for _ in range(2))
    got = kernel(cur, cur.clone(), plan, pins=pins, prev=prev,
                 out2=prev.clone())
    via = kernel(cur, cur.clone(), twin, pins=pins, prev=prev,
                 out2=prev.clone())
    want = sweep_reference(cur, plan, prev=prev, pins=pins)
    suffix = ("+two_level" + ("" if all(pins) else "+pins")
              + ("+bf16" if dtype == "bfloat16" else ""))
    label = (f"{plan.spec.name} {shape} k={k} {dtype}, {walls_name(bc)}"
             f"{', values near 0' if tiny else ''}, march tiles "
             f"{plan.tiles}, window tiles {twin.tiles}")
    out = {}
    for name, g, w, v in zip(("L_(n+k)", "L_(n+k-1)"), got, want, via):
        require(torch.equal(g, v), f"tiled_march{suffix} {label}, {name}: "
                "not bitwise the window's launch")
        for row, t in (("tiled_march", g), ("tiled_sweep", v)):
            out[row + suffix] = max(out.get(row + suffix, 0.0), check_equal(
                f"{row}{suffix} {label}, {name}", t, w, True))
    return out


def compare_wave_iterate(shape, k, steps, rng, device, bc=None,
                         dtype="float32"):
    """``WaveEquation.simulate(method="tiled")`` (``wave_iterate``: steps
    // k launches and a remainder) against the eager leapfrog, whose ops
    are the plain version's, on walls ``bc`` (default zero), in ``dtype``
    (bf16: bitwise required)."""
    from stencil_tpu_torch.models.wave import WaveEquation

    w = WaveEquation(shape=shape, bc=bc, dtype=dtype, device=DEVICE)
    prev, cur = w.initial_pair(rng.normal(size=shape), rng.normal(size=shape))
    got = w.simulate(prev, cur, steps, method="tiled", sweeps_per_call=k)
    want = w.simulate(prev, cur, steps, method="eager")
    return max(check_equal(f"wave_iterate {shape} k={k} {dtype}, {steps} "
                           f"steps, {walls_name(w.bc)}, {name}", g.data,
                           e.data, exact=dtype == "bfloat16")
               for name, g, e in zip(("L_(n+s-1)", "L_(n+s)"), got, want))


def compare_coeff(kernel, plan, cur, a, label, bc=None):
    """The coefficient mode of the march ``plan`` on ``cur`` with ``bc``'s
    pins (default every face pinned), from the padded a(x) ``a``: the
    weights kernel bitwise its plain version; one march launch through
    those weights bitwise its plain version and the window schedule's
    launch from ``a``. Returns ({mode: max abs difference} for
    ``coeff_weights``, the march's mode and the window's
    ``tiled_sweep+coeff...``, and the weights)."""
    from stencil_tpu_torch.ops.sweep_kernel import (
        coeff_weights_reference, sweep_reference,
    )
    from stencil_tpu_torch.ops.tiled import dynamic_pins
    from stencil_tpu_torch.ops.tiled_kernel import coeff_weights

    require(plan.schedule == "march", f"{label}: a {plan.schedule} plan")
    pins = dynamic_pins(bc, 3) if bc is not None else (1, 1, 1, 1)
    suffix = "+coeff" + ("" if all(pins) else "+pins")
    label = (f"{label} k={plan.sweeps_per_call}"
             + (f", {walls_name(bc)}" if bc is not None else "")
             + f", march tiles {plan.tiles}")
    w = coeff_weights(a, plan)
    out = {"coeff_weights": check_equal(
        f"coeff_weights {label}", w, coeff_weights_reference(a, plan),
        True)}
    got = kernel(cur, cur.clone(), plan, pins=pins, coeff=w)
    out["tiled_march" + suffix] = check_equal(
        f"tiled_march{suffix} {label}", got,
        sweep_reference(cur, plan, coeff=w, pins=pins), True)
    twin = window_twin(plan)
    out["tiled_sweep" + suffix] = check_equal(
        f"tiled_sweep{suffix} (window tiles {twin.tiles}) {label}",
        kernel(cur, cur.clone(), twin, pins=pins, coeff=a), got, True)
    return out, w


def marching_inputs(shape, k, rng, device, bc=None):
    """cfg16's FTCS plan (the runner's, a march plan), padded coefficient
    a(x) and a random padded u at ``shape``, on walls ``bc`` (default the
    reference faces; u refreshed, a(x) wrapped or mirrored for dynamic
    ones)."""
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.models.diffusion import (
        HeterogeneousDiffusion, two_material,
    )
    from stencil_tpu_torch.ops.tiled import make_tiled_plan, pad_coeff

    het = HeterogeneousDiffusion(
        shape=shape, a=two_material(shape, lo=1.0 / CONTRAST, hi=1.0,
                                    seed=0), bc=bc, device=DEVICE)
    runner = het.runner(method="tiled", sweeps_per_call=k)
    lam = het.stable_dt / het.h ** 2
    plan = make_tiled_plan(get_spec("jacobi7"), shape, "float32", k,
                           coeff_scales=(lam, 1.0, -lam))
    require(list(plan.tiles) == runner.plan_info["tiles"],
            f"coeff {shape}: plan {plan.tiles} is not the runner's "
            f"{runner.plan_info}")
    coeff = pad_coeff(plan, het.a, het.bc).to(device)
    return plan, pins_input(plan, het.bc, rng, device), coeff


def hetero_problem(kernel):
    """cfg18's problem: the two-material field at 255^3, contrast 100."""
    from stencil_tpu_torch.models.diffusion import (
        HeterogeneousPoissonProblem, two_material,
    )

    return HeterogeneousPoissonProblem(
        shape=HETERO_SIZE, a=two_material(HETERO_SIZE, lo=1.0 / CONTRAST,
                                          hi=1.0, seed=0),
        kernel=kernel, device=DEVICE)


def random_ring(shape, rng, device):
    """A halo-1 padded tensor, interior and ghost ring random."""
    import torch

    return torch.from_numpy(rng.normal(size=tuple(n + 2 for n in shape))
                            .astype(np.float32)).to(device)


def run_wave(kernel, rng, label):
    """The wave main path: cfg9's WaveEquation at 256^3 over WAVE_STEPS
    steps on ``tiled`` k=8 against ``eager``; at 64^3 against the float64
    golden loop (5e-4) and the analytic standing mode (3e-4, the JAX
    tests' bars). Every launch must be a march two-level one (cfg9's plan
    marches). Returns the two-level launches, counts set to 0 just
    before."""
    import torch

    from stencil_tpu_torch.models.wave import WaveEquation, golden_wave

    w = WaveEquation(shape=MAIN_SIZE, device=DEVICE)
    prev, cur = w.initial_pair(rng.normal(size=MAIN_SIZE))
    kernel.reset_counts()
    t0 = time.perf_counter()
    _, got = w.simulate(prev, cur, WAVE_STEPS, method="tiled",
                        sweeps_per_call=WAVE_K)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel.two_level_launches
    _, want = w.simulate(prev, cur, WAVE_STEPS, method="eager")
    diff = float((got.data - want.data).abs().max())
    print(f"wave {MAIN_SIZE} {WAVE_STEPS} steps tiled k={WAVE_K} vs eager: "
          f"max abs diff {diff:.3e} (bar {WAVE_TOL:g}); {launches} "
          f"two-level launches; {seconds:.3f} s [{label}]")
    require(bool(torch.isfinite(got.data).all()) and diff <= WAVE_TOL,
            f"wave {MAIN_SIZE}: tiled vs eager {diff}")
    require(launches == WAVE_STEPS // WAVE_K
            and launches == kernel.launches, f"wave launches {launches}")
    require_marched(kernel, wave_plan(MAIN_SIZE, WAVE_K), launches,
                    "march_two_level_launches")
    small = WaveEquation(shape=WAVE_SMALL, device=DEVICE)
    u0 = rng.normal(size=WAVE_SMALL)
    got = small.simulate_interior(u0, 24, method="tiled",
                                  sweeps_per_call=WAVE_K)
    want = golden_wave(u0, small.spec, 24, small.bc,
                       dt=small.courant * small.h / small.c)
    err = float(np.max(np.abs(got - want)))
    n = WAVE_SMALL[0]
    mode_w = WaveEquation(shape=WAVE_SMALL, dt=0.25, device=DEVICE)
    x = np.arange(1, n + 1) / (n + 1)
    m1 = np.sin(np.pi * x)
    mode = np.einsum("i,j,k->ijk", m1, m1, m1)
    s2 = mode_w.courant ** 2
    theta = np.arccos((2 - 6 * s2 + 6 * s2 * np.cos(np.pi / (n + 1))) / 2)
    got_m = mode_w.simulate_interior(mode, 12, method="tiled",
                                     sweeps_per_call=WAVE_K)
    err_m = float(np.max(np.abs(got_m - np.cos(12 * theta) * mode)))
    launches = kernel.two_level_launches
    print(f"wave {WAVE_SMALL} tiled k={WAVE_K}: 24 steps vs the float64 "
          f"golden loop max err {err:.3e} (bar 5e-4); standing mode after "
          f"12 steps max err {err_m:.3e} (bar 3e-4); {launches} two-level "
          f"launches in all [{label}]")
    require(np.isfinite(err) and err < 5e-4, f"wave golden {err}")
    require(np.isfinite(err_m) and err_m < 3e-4, f"wave standing {err_m}")
    require_marched(kernel, wave_plan(WAVE_SMALL, WAVE_K), launches,
                    "march_two_level_launches")
    return launches


def require_marched(kernel, plan, launches, count):
    """A wave path's plan is a march plan, and every one of its
    ``launches`` two-level launches a march one (``count``)."""
    require(plan.schedule == "march" and getattr(kernel, count) == launches,
            f"wave {plan.interior_shape} {plan.dtype}: a {plan.schedule} "
            f"plan, {getattr(kernel, count)} {count} of {launches}")


def run_wave_pins(kernel, rng, label):
    """The wave at 256^3 with periodic d0 and Neumann d1: WAVE_STEPS steps
    on ``tiled`` k=8 against ``eager`` (WAVE_TOL); returns the two-level
    pins launches, counts set to 0 just before."""
    import torch

    from stencil_tpu_torch.models.wave import WaveEquation

    w = WaveEquation(shape=MAIN_SIZE, bc=walls(3, (0,), (1,)), device=DEVICE)
    prev, cur = w.initial_pair(rng.normal(size=MAIN_SIZE))
    kernel.reset_counts()
    _, got = w.simulate(prev, cur, WAVE_STEPS, method="tiled",
                        sweeps_per_call=WAVE_K)
    torch.cuda.synchronize()
    launches = kernel.two_level_pins_launches
    require(launches == WAVE_STEPS // WAVE_K and launches == kernel.launches,
            f"wave {walls_name(w.bc)}: {launches} pins launches of "
            f"{kernel.launches}")
    require_marched(kernel, wave_plan(MAIN_SIZE, WAVE_K), launches,
                    "march_two_level_pins_launches")
    _, want = w.simulate(prev, cur, WAVE_STEPS, method="eager")
    diff = float((got.data - want.data).abs().max())
    print(f"wave {MAIN_SIZE} {walls_name(w.bc)}, {WAVE_STEPS} steps tiled "
          f"k={WAVE_K} vs eager: max abs diff {diff:.3e} (bar {WAVE_TOL:g}); "
          f"{launches} two-level pins launches [{label}]")
    require(bool(torch.isfinite(got.data).all()) and diff <= WAVE_TOL,
            f"wave {walls_name(w.bc)}: tiled vs eager {diff}")
    return launches


def run_cli_bf16(cli, args, kernel, label, count="launches"):
    """One bf16 CLI main path (``run_cli`` with ``--dtype bfloat16``; -c at
    the bf16 bar): every launch of the run must be a bf16 one of ``count``.
    Returns (record, launches)."""
    rec, n = run_cli(cli, [*args, "--dtype", "bfloat16"], kernel, label,
                     count)
    require(rec["dtype"] == "bfloat16" and kernel.bf16_launches == n
            and n == kernel.launches,
            f"bf16 main path {args}: {kernel.bf16_launches} bf16 launches, "
            f"{n} {count}, {kernel.launches} in all")
    return rec, n


def run_wave_bf16(kernel, rng, label, bc=None):
    """The wave in bf16 at 256^3 (cfg9's plan in bf16) over WAVE_STEPS steps
    on ``tiled`` k=8 against the eager bf16 leapfrog, on walls ``bc``
    (default zero): bitwise expected without a Neumann face, else within
    BF16_TOL of the field's largest value (a live Neumann ghost sums the
    mirrored taps in another order, and the leapfrog does not damp the
    ulps that makes; at |u| ~ 4 a bf16 ulp is 0.03); returns the
    two-level launches (``bc`` dynamic: the pins ones), counts set to 0
    just before, every one a bf16 launch."""
    import torch

    from stencil_tpu_torch.models.wave import WaveEquation

    w = WaveEquation(shape=MAIN_SIZE, bc=bc, dtype="bfloat16", device=DEVICE)
    prev, cur = w.initial_pair(rng.normal(size=MAIN_SIZE))
    kernel.reset_counts()
    _, got = w.simulate(prev, cur, WAVE_STEPS, method="tiled",
                        sweeps_per_call=WAVE_K)
    torch.cuda.synchronize()
    count = ("two_level_pins_launches" if w.bc.any_dynamic
             else "two_level_launches")
    launches = getattr(kernel, count)
    require(launches == WAVE_STEPS // WAVE_K and launches == kernel.launches
            and kernel.bf16_launches == launches,
            f"wave bf16 {walls_name(w.bc)}: {launches} {count}, "
            f"{kernel.bf16_launches} bf16, {kernel.launches} in all")
    require_marched(kernel, wave_plan(MAIN_SIZE, WAVE_K, "bfloat16"),
                    launches, "march_" + count)
    _, want = w.simulate(prev, cur, WAVE_STEPS, method="eager")
    g, e = got.data.float(), want.data.float()
    diff = float((g - e).abs().max())
    same = torch.equal(got.data, want.data)
    bar = BF16_TOL * max(1.0, float(e.abs().max()))
    print(f"wave {MAIN_SIZE} bf16 {walls_name(w.bc)}, {WAVE_STEPS} steps "
          f"tiled k={WAVE_K} vs eager bf16: "
          f"{'bitwise equal' if same else f'max abs diff {diff:.3e}'} (bar "
          f"{BF16_TOL:g} x max |u| = {bar:.3e}); {launches} {count} "
          f"[{label}]")
    require(bool(torch.isfinite(g).all()) and diff <= bar,
            f"wave bf16 {walls_name(w.bc)}: tiled vs eager {diff}")
    require(same or w.bc.neumann_mask(3) != (False,) * 3,
            f"wave bf16 {walls_name(w.bc)}: not bitwise without a Neumann "
            "face")
    return launches


def run_mg_bf16(kernel, label):
    """The multigrid fine level in bf16 (the Chebyshev and dual modes):
    ``Multigrid(PoissonProblem(dtype="bfloat16"), smoother="chebyshev",
    fine_method="pallas_tiled")`` at BF16_MG_SIZE, on the
    manufactured sine, BF16_MG_CYCLES V(2,2) cycles from u = 0 on the card
    against the same cycles on the CPU, where the wrapper runs the kernels'
    plain versions and the coarse levels the same eager ops (within
    BF16_TOL); bf16 holds this cycle to its rounding floor (the error
    against the exact solution is printed: 0.18 after 4 cycles at 63^3 on
    the CPU, JAX's cycle with its XLA fine level 0.83). Returns the launches
    by mode, counts set to 0 just before; every one a bf16 launch."""
    import torch

    from stencil_tpu_torch.models.poisson import (
        PoissonProblem, manufactured_sine,
    )
    from stencil_tpu_torch.multigrid import Multigrid

    shape = BF16_MG_SIZE
    f, u_exact = manufactured_sine(shape)
    out = {}
    for device in (DEVICE, "cpu"):
        prob = PoissonProblem(shape=shape, dtype="bfloat16", device=device)
        run = Multigrid(prob, smoother="chebyshev",
                        fine_method="pallas_tiled").runner(f)
        kernel.reset_counts()
        out[device] = run.iterate(prob.initial_grid(), BF16_MG_CYCLES)
        if device == DEVICE:
            torch.cuda.synchronize()
            counts = {m: n for m, n in cheby_counts(kernel, True).items()
                      if "source" not in m}
            rows = cheby_rows(run, True)
            require(all(counts[m] > 0 for m in rows)
                    and kernel.bf16_launches == kernel.launches
                    and sum(counts.values()) == kernel.launches,
                    f"multigrid bf16: launches {counts}, "
                    f"{kernel.bf16_launches} bf16 of {kernel.launches}")
    got = out[DEVICE].interior().float().cpu()
    want = out["cpu"].interior().float()
    diff = float((got - want).abs().max())
    err = float((got.double() - torch.from_numpy(u_exact)).abs().max())
    same = "bitwise equal" if diff == 0 else f"max abs diff {diff:.3e}"
    print(f"multigrid bf16 chebyshev V(2,2) tiled fine level {shape}, "
          f"{BF16_MG_CYCLES} cycles on the card vs on the CPU (plain "
          f"versions): {same} (bar {BF16_TOL:g}); error vs exact "
          f"{err:.3e} (printed); launches {counts} [{label}]")
    require(bool(torch.isfinite(got).all()) and diff <= BF16_TOL,
            f"multigrid bf16: card vs CPU {diff}")
    return counts


def run_advection(kernel, rng, label, count="pins_launches"):
    """The advection family on the tiled kernel: upwind at cfg12's velocity
    on a box periodic in d0 and d1 (d2 the reference faces), k=8, against
    the float64 native golden over ADVECT_ITERS iterations; then integer
    CFL on a fully periodic box at k=1 against ``exact_translate``,
    bitwise. Returns the pins launches (by ``count``, which must be all of
    each run's launches), counts set to 0 just before each run."""
    from stencil_tpu_torch import native
    from stencil_tpu_torch.models.advection import Advection
    from stencil_tpu_torch.ops import golden
    from stencil_tpu_torch.ops.tiled import TiledStencil

    adv = Advection(shape=MAIN_SIZE, velocity=ADVECT_VELOCITY,
                    bc=walls(3, (0, 1)), device=DEVICE)
    u0 = rng.random(MAIN_SIZE, dtype=np.float32)
    stencil = TiledStencil(adv.spec, MAIN_SIZE, sweeps_per_call=8,
                           device=DEVICE)
    kernel.reset_counts()
    got = stencil.iterate(adv.initial_grid(u0), ADVECT_ITERS)
    total = getattr(kernel, count)
    require(total == ADVECT_ITERS // 8 and total == kernel.launches,
            f"advection: {total} pins launches of {kernel.launches}")
    want = native.golden_iterate_native(u0, adv.spec, ADVECT_ITERS,
                                        bc=adv.bc)
    chk = golden.check_against_golden(got.interior().double().cpu().numpy(),
                                      want, GOLDEN_TOL)
    print(f"advection upwind {MAIN_SIZE} velocity {ADVECT_VELOCITY} "
          f"({len(adv.spec.weights)} taps), {walls_name(adv.bc)}, k=8 tiles "
          f"{list(stencil.plan.tiles)}, {ADVECT_ITERS} iterations vs the "
          f"float64 native golden: {'OK' if chk.ok else 'FAILED'} "
          f"{chk.message()}; {total} pins launches [{label}]")
    require(chk.ok and np.isfinite(chk.max_abs_err), "advection golden")
    for velocity in TRANSLATE_VELOCITIES:
        adv = Advection(shape=MAIN_SIZE, velocity=velocity, dt=1.0,
                        device=DEVICE)
        stencil = TiledStencil(adv.spec, MAIN_SIZE, sweeps_per_call=1,
                               device=DEVICE)
        kernel.reset_counts()
        got = stencil.iterate(adv.initial_grid(u0), TRANSLATE_STEPS)
        n = getattr(kernel, count)
        require(n == TRANSLATE_STEPS and n == kernel.launches,
                f"translation {velocity}: {n} pins launches")
        same = np.array_equal(got.interior().cpu().numpy(),
                              adv.exact_translate(u0, TRANSLATE_STEPS))
        verdict = "bitwise equal to" if same else "DIFFER from"
        print(f"advection upwind {MAIN_SIZE} velocity {velocity} dt 1 "
              f"(integer CFL), {walls_name(adv.bc)}, k=1: "
              f"{TRANSLATE_STEPS} steps {verdict} exact_translate; {n} pins "
              f"launches [{label}]")
        require(same, f"translation {velocity} is not exact")
        total += n
    return total


def run_varcoeff_cli(cli, kernel, label, walls_args=(),
                     count="march_coeff_launches"):
    """``-m varcoeff -c`` at 128^3 k=8 with ``walls_args``: the float64
    field golden (NumPy, capped at 50 iterations), on the march
    (``plan_info`` schedule ``march``), the weights formed once; returns
    the launches by ``count`` and the weights kernel's, counts set to 0
    just before."""
    from stencil_tpu_torch.ops.tiled_kernel import coeff_weights

    kernel.reset_counts()
    coeff_weights.reset_counts()
    args = [*VARCOEFF_ARGS, *walls_args]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "varcoeff.jsonl"
        rc = cli.main([*args, "-c", "--device", DEVICE,
                       "--json-out", str(out)])
        launches = getattr(kernel, count)
        weights = coeff_weights.launches
        rec = json.loads(out.read_text().splitlines()[0])
    chk = rec["check"]
    print(f"main path {' '.join(args)} -c: check "
          f"{'OK' if chk['ok'] else 'FAILED'} over "
          f"{chk['iterations_checked']} iterations vs the float64 field "
          f"golden (NumPy, capped), max abs err {chk['max_abs_err']:.3e}; "
          f"{launches} {count}, {weights} coeff_weights launches; plan "
          f"{rec['plan']}; {rec['glups']:.2f} GLUPS [{label}]")
    require(rc == 0 and chk["ok"] and np.isfinite(chk["max_abs_err"])
            and chk["iterations_checked"] == 50,
            f"varcoeff main path: {rec}")
    require(rec["plan"]["kernel"] == "tiled"
            and rec["plan"]["schedule"] == "march" and launches > 0
            and launches == kernel.launches and weights == 1,
            f"varcoeff main path did not run the march coefficient mode "
            f"with its weights formed once: {weights} weights launches")
    return launches, weights


def run_hetero_cli(cli, kernel, label):
    """``--solve hetero -c`` at 255^3 with ``--op-kernel auto`` and then
    ``pallas``: both converge, within one iteration of each other, with
    float64 certificates under ``HETERO_CERT_BAR`` that agree within
    ``HETERO_CERT_AGREE`` (the solver judges convergence with the operator
    it applies; the certificate applies an independent one), and only
    ``pallas`` launches the coefficient mode, on the march (``plan``
    schedule ``march``), its weights formed once per OperatorMultigrid
    level. Returns the march coefficient launches and the weights
    kernel's of the ``pallas`` run, counts set to 0 just before each."""
    from stencil_tpu_torch.ops.tiled_kernel import coeff_weights

    recs, counts, weights = {}, {}, {}
    for op in ("auto", "pallas"):
        kernel.reset_counts()
        coeff_weights.reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "hetero.jsonl"
            t0 = time.perf_counter()
            rc = cli.main([*HETERO_ARGS, "--op-kernel", op, "-c",
                           "--device", DEVICE, "--json-out", str(out)])
            seconds = time.perf_counter() - t0
            counts[op] = kernel.march_coeff_launches
            require(counts[op] == kernel.launches,
                    f"hetero --op-kernel {op}: {kernel.launches} launches, "
                    f"{counts[op]} on the march")
            weights[op] = coeff_weights.launches
            rec = recs[op] = json.loads(out.read_text().splitlines()[0])
        chk = rec.get("check", {})
        tag = "converged" if rec.get("converged") else "NOT converged"
        print(f"solver path hetero --op-kernel {op} ({' '.join(HETERO_ARGS)}"
              f" -c): {tag} in {rec.get('iterations')} iterations, "
              f"residual_rel {rec.get('residual_rel', float('nan')):.3e}; "
              f"float64 certificate max |f - A u| = "
              f"{chk.get('residual_f64', float('nan')):.3e} (rel "
              f"{chk.get('residual_f64_rel', float('nan')):.3e}); plan "
              f"{rec.get('plan')}; {counts[op]} tiled_march+coeff "
              f"launches, {weights[op]} coeff_weights launches; "
              f"{seconds:.2f} s with the f64 check [{label}]")
        require(rc == 0 and rec.get("converged")
                and chk.get("residual_f64_rel", float("nan"))
                < HETERO_CERT_BAR,
                f"hetero --op-kernel {op}: {rec}")
    require(abs(recs["auto"]["iterations"] - recs["pallas"]["iterations"])
            <= 1, f"hetero iteration counts {recs}")
    certs = [recs[op]["check"]["residual_f64"] for op in ("auto", "pallas")]
    require(abs(certs[0] - certs[1]) <= HETERO_CERT_AGREE * max(certs),
            f"hetero float64 certificates {certs} differ by more than "
            f"{HETERO_CERT_AGREE:.0%}")
    require(counts["auto"] == 0 and counts["pallas"] > 0
            and weights["auto"] == 0 and weights["pallas"] > 0
            and recs["pallas"]["plan"].get("schedule") == "march",
            f"hetero coefficient launches {counts}, weights {weights}, plan "
            f"{recs['pallas']['plan']}")
    return counts["pallas"], weights["pallas"]


def run_advdiff_cells(label):
    """cfg14 and cfg15 as ``bench.py:397-432`` builds them: the 255^3
    advection-diffusion problem, f from ``default_rng(3).normal``,
    OperatorMultigrid right-preconditioning BiCGStab and GMRES(8), tol
    1e-4, at most 3000 iterations. Each must converge with a float64
    certificate (``residual_f64`` over max |f|) under the tolerance; its
    time to solution is a host clock around the solve and its one fetch,
    the median of ``ADVDIFF_RUNS`` after a warm-up. No hand-written kernel
    runs: the operator and the cycle are eager, as JAX's are XLA. Returns
    {cell: (iterations, median ms, all ms, certificate)}."""
    import torch

    from stencil_tpu_torch.krylov import GMRES, BiCGStab
    from stencil_tpu_torch.models.advection_diffusion import (
        AdvectionDiffusionProblem,
    )
    from stencil_tpu_torch.multigrid import OperatorMultigrid

    prob = AdvectionDiffusionProblem(shape=ADVDIFF_SIZE,
                                     velocity=ADVDIFF_VELOCITY,
                                     nu=ADVDIFF_NU, device=DEVICE)
    f_np = np.random.default_rng(ADVDIFF_SEED).normal(
        size=ADVDIFF_SIZE).astype(np.float32)
    f = torch.from_numpy(f_np).to(DEVICE)
    opmg = OperatorMultigrid(prob)
    out = {}
    for cell, solver in (("cfg14", BiCGStab(prob, preconditioner=opmg)),
                         ("cfg15", GMRES(prob, preconditioner=opmg,
                                         restart=8))):
        times = []
        for run in range(ADVDIFF_RUNS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver.solve(f, tolerance=ADVDIFF_TOL,
                               max_iterations=ADVDIFF_MAX_ITERS)
            torch.cuda.synchronize()
            if run:
                times.append((time.perf_counter() - t0) * 1e3)
        cert = prob.residual_f64(res.grid, f_np) / float(np.max(np.abs(f_np)))
        ms = statistics.median(times)
        print(f"{cell} ({type(solver).__name__}"
              f"{'(8)' if cell == 'cfg15' else ''} + OperatorMultigrid, "
              f"advdiff {'x'.join(map(str, ADVDIFF_SIZE))} velocity "
              f"{ADVDIFF_VELOCITY} nu {ADVDIFF_NU}, tol {ADVDIFF_TOL}): "
              f"{res.summary()}; float64 certificate max |f - A u| / max|f|"
              f" = {cert:.3e}; time to solution {ms:.3f} ms (median of "
              f"{ADVDIFF_RUNS} after a warm-up: "
              f"{', '.join(f'{t:.3f}' for t in times)}) [{label}]")
        require(res.converged and cert < ADVDIFF_TOL
                and np.isfinite(res.residual),
                f"{cell}: {res.summary()}, certificate {cert:.3e}")
        out[cell] = (res.iterations, ms, times, cert)
    return out


def seeded_grid(shape, bc, device, seed=SEED):
    """A halo-1 grid on ``device`` with a seeded random interior, drawn on
    the device (a 1024^3 interior in one call)."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(shape, generator=gen, device=device)
    return HaloGrid.from_interior(x, halo=1, bc=bc, device=device)


def streamed_case(kernel, args, grid, label, hbm_mb=None, golden=False):
    """``-m streamed`` through the registry (the CLI's runner) on ``grid``
    against ``-m tiled`` at the same k, bitwise; the streamed run with the
    kernel's counts set to 0 just before and read just after: every launch
    a march launch with a live face (each chunk has one) or, in one chunk,
    a plain march launch. ``hbm_mb`` sets ``STENCIL_TPU_HBM_MB`` while the
    runner is made (auto chunks). Returns (launches, pins launches,
    runner)."""
    import os

    import torch

    from stencil_tpu_torch import registry
    from stencil_tpu_torch.config import parse_args

    cfg = parse_args([*args, "--device", DEVICE])
    spec = cfg.resolved_spec()
    if hbm_mb is not None:
        os.environ["STENCIL_TPU_HBM_MB"] = str(hbm_mb)
    try:
        runner = registry.get_runner("streamed", cfg, spec, grid)
    finally:
        os.environ.pop("STENCIL_TPU_HBM_MB", None)
    kernel.reset_counts()
    t0 = time.perf_counter()
    out = runner.iterate(grid, cfg.iterations)
    seconds = time.perf_counter() - t0
    n, pins = kernel.launches, kernel.march_pins_launches
    chunks = runner.plan_info["chunks"]
    k = runner.plan_info["k"]
    require(n == chunks * -(-cfg.iterations // k),
            f"streamed {args}: {n} launches, {chunks} chunks")
    require(kernel.march_launches == n and (pins == n or chunks == 1),
            f"streamed {args}: {n} launches, {kernel.march_launches} march, "
            f"{pins} march pins")
    require(out.device.type == "cpu", f"streamed {args}: a device result")
    ref = registry.get_runner("tiled", cfg, spec, grid).iterate(
        grid, cfg.iterations)
    same = torch.equal(out.interior().to(grid.device), ref.interior())
    msg = ""
    if golden:
        from stencil_tpu_torch import native
        from stencil_tpu_torch.ops import golden as golden_mod

        x0 = grid.interior().double().cpu().numpy()
        want = native.golden_iterate_native(x0, spec, cfg.iterations,
                                            bc=grid.bc)
        chk = golden_mod.check_against_golden(
            out.interior().double().numpy(), want, tolerance=GOLDEN_TOL)
        require(chk.ok, f"streamed {args} vs the float64 golden: "
                f"{chk.message()}")
        msg = f", {chk.message()} vs the float64 golden"
    print(f"streamed path {' '.join(args)}: {runner.name}, chunk planes "
          f"{runner.plan_info['chunk_planes'][:2]}..., plan "
          f"{ {k_: runner.plan_info[k_] for k_ in ('tiles', 'schedule')} }"
          f", {n} launches ({pins} with live faces) in {seconds:.2f} s "
          f"with its host copies; {'bitwise' if same else 'NOT bitwise'} "
          f"-m tiled -k {k}{msg} [{label}]")
    require(same, f"streamed {args} differs from tiled")
    return n, pins, runner


def run_streamed_paths(kernel, label):
    """The out-of-core paths: jacobi7 1024^3 fp32 ``-k 8 -i 16 --chunks
    8`` from a seeded random interior (the 4 GiB host iterate), the walls
    ``--periodic 0 1`` and ``--periodic 0 --neumann 1`` at 256^3 (also
    against the float64 golden), and at 256^3 the chunk count
    ``auto_chunks`` gives with ``STENCIL_TPU_HBM_MB`` set small; each
    bitwise ``-m tiled``. Returns (plain march launches, march pins
    launches)."""
    import gc

    import torch

    from stencil_tpu_torch.core.grid import DirichletBC

    counts = [0, 0]

    def add(n, pins):
        counts[0] += n - pins
        counts[1] += pins

    big = ["-s", *map(str, STREAM_SIZE), "--spec", "jacobi7", "-m",
           "streamed", "-k", str(STREAM_K), "-i", str(STREAM_ITERS),
           "--chunks", str(STREAM_CHUNKS)]
    grid = seeded_grid(STREAM_SIZE, DirichletBC.reference_default(3),
                       DEVICE)
    add(*streamed_case(kernel, big, grid, label)[:2])
    del grid
    gc.collect()
    torch.cuda.empty_cache()
    small = ["-s", *map(str, STREAM_SMALL), "--spec", "jacobi7", "-m",
             "streamed", "-k", str(STREAM_K), "-i", str(STREAM_ITERS)]
    for periodic, neumann in STREAM_WALLS:
        bc = walls(3, periodic, neumann)
        args = [*small, "--chunks", "4"]
        for flag, dims in (("--periodic", periodic), ("--neumann", neumann)):
            if dims:
                args += [flag, *map(str, dims)]
        add(*streamed_case(kernel, args, seeded_grid(STREAM_SMALL, bc,
                                                     DEVICE), label,
                           golden=True)[:2])
    n, pins, runner = streamed_case(
        kernel, small, seeded_grid(STREAM_SMALL,
                                   DirichletBC.reference_default(3),
                                   DEVICE),
        label, hbm_mb=STREAM_AUTO_HBM_MB)
    require(runner.plan_info["chunks"] > 1,
            f"auto chunks at {STREAM_AUTO_HBM_MB} MiB: "
            f"{runner.plan_info['chunks']}")
    add(n, pins)
    return tuple(counts)


def run_checkpoint_paths(cli, kernel, label):
    """``CheckpointedRun`` on ``-m tiled -k 8`` at 256^3 (the CLI's
    ``--checkpoint-dir``), interrupted after its first save and resumed,
    bitwise the uninterrupted run; one checkpointed ``--solve poisson``
    through the CLI (converged, its checkpoints on disk); and ``-m
    pallas_temporal -k 8`` at 256^3 with ``--dump-image`` and
    ``--profile`` (a BMP of the right header and size, a non-empty trace).
    Returns the march launches of the tiled runs, counts set to 0 just
    before each."""
    import torch

    from stencil_tpu_torch import registry
    from stencil_tpu_torch.config import parse_args
    from stencil_tpu_torch.core.grid import DirichletBC
    from stencil_tpu_torch.utils import checkpoint

    args = ["-s", *map(str, STREAM_SMALL), "--spec", "jacobi7", "-m",
            "tiled", "-k", str(STREAM_K), "-i", str(STREAM_ITERS),
            "--device", DEVICE]
    cfg = parse_args(args)
    spec = cfg.resolved_spec()
    grid = seeded_grid(STREAM_SMALL, DirichletBC.reference_default(3),
                       DEVICE)
    runner = registry.get_runner("tiled", cfg, spec, grid)
    kernel.reset_counts()
    ref = runner.iterate(grid, STREAM_ITERS)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.CheckpointedRun(runner, tmp, every=STREAM_K,
                                   spec_name=spec.name).run(grid, STREAM_K)
        msgs = []
        out, done = checkpoint.CheckpointedRun(
            runner, tmp, every=STREAM_K, spec_name=spec.name).run(
                grid, STREAM_ITERS, progress=msgs.append)
        files = sorted(p.name for p in Path(tmp).iterdir())
    n = kernel.march_launches
    require(n == kernel.launches == 2 * STREAM_ITERS // STREAM_K,
            f"checkpointed tiled: {kernel.launches} launches, {n} march")
    same = torch.equal(out.data, ref.data)
    print(f"checkpointed -m tiled -k {STREAM_K} at "
          f"{'x'.join(map(str, STREAM_SMALL))}: {msgs}, files {files}; "
          f"{'bitwise' if same else 'NOT bitwise'} the uninterrupted "
          f"{STREAM_ITERS} sweeps [{label}]")
    require(same and done == STREAM_ITERS
            and f"iteration {STREAM_K}" in msgs[0],
            f"checkpointed tiled: {msgs}, done {done}")
    with tempfile.TemporaryDirectory() as tmp:
        out_json = Path(tmp) / "solve.jsonl"
        solve = ["--solve", "poisson", "-s", "63", "63", "63", "--tol",
                 "1e-5", "-c", "--checkpoint-dir", str(Path(tmp) / "ck"),
                 "--checkpoint-every", "2"]
        rc = cli.main([*solve, "--device", DEVICE, "--json-out",
                       str(out_json)])
        rec = json.loads(out_json.read_text().splitlines()[0])
        ckpts = sorted(p.name for p in (Path(tmp) / "ck").iterdir())
    print(f"checkpointed solve {' '.join(solve[:-4])} --checkpoint-every "
          f"2: converged {rec.get('converged')} in {rec.get('iterations')}"
          f" iterations, residual_rel {rec.get('residual_rel'):.3e}, "
          f"certificate {rec.get('check', {}).get('residual_f64_rel'):.3e},"
          f" error vs exact {rec.get('check', {}).get('error_vs_exact'):.3e}"
          f"; checkpoints {ckpts} [{label}]")
    require(rc == 0 and rec.get("converged") and rec.get("checkpointed")
            and ckpts, f"checkpointed solve: {rec}")
    kernel.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        bmp, trace = Path(tmp) / "heat.bmp", Path(tmp) / "trace"
        flags = ["-s", *map(str, STREAM_SMALL), "--spec", "jacobi7", "-m",
                 "pallas_temporal", "-k", str(STREAM_K), "-i",
                 str(STREAM_ITERS), "--dump-image", str(bmp), "--profile",
                 str(trace)]
        rc = cli.main([*flags, "--device", DEVICE])
        data = bmp.read_bytes()
        traces = [(p.name, p.stat().st_size) for p in trace.iterdir()]
    width = STREAM_SMALL[2] * 3
    size = 14 + 40 + (width + (-width) % 4) * STREAM_SMALL[1]
    print(f"--dump-image and --profile on {' '.join(flags[:-4])}: BMP "
          f"{data[:2]!r}, {len(data)} bytes (want {size}); traces "
          f"{traces}; {kernel.launches} launches [{label}]")
    require(rc == 0 and data[:2] == b"BM" and len(data) == size
            and traces and all(b > 0 for _, b in traces),
            f"--dump-image/--profile: rc {rc}, {len(data)} bytes, {traces}")
    require(kernel.march_launches == kernel.launches > 0,
            f"--dump-image run: {kernel.launches} launches")
    return n + kernel.launches


def time_streamed(label):
    """Phase 5: the streamed path at 1024^3 (jacobi7 fp32 k=8, 8 chunks)
    through the registry's runner (the CLI's): ms per outer step, k times
    the marginal ms per sweep of its ``iterate`` (``measure_marginal`` in
    whole outer steps: the copy of the grid in and out of each call
    cancels); the pinned-copy rates each way (``COPY_BYTES``, CUDA events,
    the least of 3); the bound (the bytes up and down per outer step over
    those rates, summed: one copy at a time; their larger: both
    directions at once); and the kernel's share, the chunks' launches per
    step times their mean device time in a ``torch.profiler`` trace of one
    iterate of ``STREAM_TRACE_STEPS`` outer steps, over the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stencil_tpu_torch import registry
    from stencil_tpu_torch.config import parse_args
    from stencil_tpu_torch.core.grid import DirichletBC
    from stencil_tpu_torch.streaming import StreamedStencil
    from stencil_tpu_torch.utils.timing import measure_marginal

    device = torch.device(DEVICE)
    rates = {}
    host = torch.empty(COPY_BYTES // 4, dtype=torch.float32,
                       pin_memory=True)
    dev = torch.empty_like(host, device=device)
    for name, dst, src in (("up", dev, host), ("down", host, dev)):
        best = float("inf")
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        rates[name] = COPY_BYTES / (best * 1e-3)
    del host, dev
    cfg = parse_args(["-s", *map(str, STREAM_SIZE), "--spec", "jacobi7",
                      "-m", "streamed", "-k", str(STREAM_K), "--chunks",
                      str(STREAM_CHUNKS), "--device", DEVICE])
    spec = cfg.resolved_spec()
    grid = seeded_grid(STREAM_SIZE, DirichletBC.reference_default(3),
                       DEVICE)
    runner = registry.get_runner("streamed", cfg, spec, grid)
    m = measure_marginal(lambda n: runner.iterate(grid, n).data, device,
                         warmup_iters=STREAM_K, granularity=STREAM_K,
                         repeats=2, min_signal_seconds=BENCH_SIGNAL_S)
    step_ms = m.seconds_per_iteration * STREAM_K * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.iterate(grid, STREAM_TRACE_STEPS * STREAM_K)
        torch.cuda.synchronize()
    # the trace may miss a launch (one of 16 in a run): a step's share is
    # the mean launch in the trace times the chunks a step launches
    chunk_launches = [
        e.time_range.end - e.time_range.start for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "tiled_" in e.name]
    kernel_ms = (sum(chunk_launches) / len(chunk_launches) / 1e3
                 * STREAM_CHUNKS if chunk_launches else None)
    del grid
    up, down = StreamedStencil(spec, STREAM_SIZE, sweeps_per_call=STREAM_K,
                               chunks=STREAM_CHUNKS,
                               device=device).transfer_bytes()
    serial = (up / rates["up"] + down / rates["down"]) * 1e3
    duplex = max(up / rates["up"], down / rates["down"]) * 1e3
    share = ("not measured (no device event in the trace)"
             if kernel_ms is None else
             f"{kernel_ms:.3f} ms per step, {kernel_ms / step_ms:.1%} of "
             f"it ({STREAM_CHUNKS} launches of the mean in the trace, "
             f"which holds {len(chunk_launches)} of the "
             f"{STREAM_TRACE_STEPS * STREAM_CHUNKS} launched)")
    print(f"streamed 1024^3 jacobi7 k={STREAM_K}, {STREAM_CHUNKS} chunks, "
          f"{runner.name}, plan {runner.plan_info['tiles']} "
          f"{runner.plan_info['schedule']}: {step_ms:.3f} ms per outer "
          f"step (marginals "
          f"{[f'{x * STREAM_K * 1e3:.3f}' for x in m.marginals]} ms per "
          f"step); pinned copies {rates['up'] / 1e9:.2f} GB/s up, "
          f"{rates['down'] / 1e9:.2f} GB/s down; {up / 1e9:.3f} GB up and "
          f"{down / 1e9:.3f} GB down per step: bound {serial:.3f} ms one "
          f"way at a time, {duplex:.3f} ms both at once "
          f"({step_ms / serial:.2f}x and {step_ms / duplex:.2f}x); the "
          f"chunk launches in the profiler trace {share}; "
          f"{STREAM_K * math.prod(STREAM_SIZE) / step_ms / 1e6:.2f} GLUPS "
          f"[{label}]")
    require(np.isfinite(step_ms) and step_ms > 0,
            f"streamed step marginals {m.marginals}")
    return step_ms, kernel_ms, rates, serial, duplex


def on_window():
    """A context in which ``make_tiled_plan`` gives the window schedule
    wherever its caller asks for none: a multigrid's fine-level plans, made
    inside it, take the window, the comparison the plan rule's cycles are
    held to (the two schedules compute them bitwise)."""
    from unittest import mock

    from stencil_tpu_torch.ops import tiled

    return mock.patch.object(tiled, "make_tiled_plan", functools.partial(
        tiled.make_tiled_plan, schedule="window"))


def time_cycles(mg, f, device):
    """(ms per V-cycle, contraction per cycle, ms per decade) of ``mg`` on
    ``f``: the median over 3 runs of CYCLE_REPEATS cycles, after one
    warm-up; the contraction is the geometric mean of the ratios of
    successive update norms max |u_{n+1} - u_n| over cycles 2..
    CONTRACTION_CYCLES from u = 0 (the asymptotic error contraction; the
    fp32 residual certificate floors too early at 255^3 to read it), and
    the device's busy ms per cycle in a profiler trace of BUSY_CYCLES
    cycles."""
    import torch

    from stencil_tpu_torch.utils.timing import timed

    runner = mg.runner(f)
    g0 = mg.problem.initial_grid()
    runner.iterate(g0, 1)
    runs = sorted(timed(lambda: runner.iterate(g0, CYCLE_REPEATS), device)
                  for _ in range(3))
    ms = runs[1] / CYCLE_REPEATS * 1e3
    _, busy, _ = device_busy(lambda: runner.iterate(g0, BUSY_CYCLES),
                             device)
    g, upd, res = g0, [], []
    for _ in range(CONTRACTION_CYCLES):
        nxt = runner.iterate(g, 1)
        upd.append(float((nxt.interior() - g.interior()).abs().max()))
        res.append(mg.residual_norm(nxt, f))
        g = nxt
    ratios = [b / a for a, b in zip(upd[1:], upd[2:])]
    rho = float(np.prod(ratios)) ** (1.0 / len(ratios))
    decade = ms / -np.log10(rho) if 0 < rho < 1 else float("inf")
    torch.cuda.synchronize()
    return ms, rho, decade, upd, res, busy / BUSY_CYCLES


def needed_cells(plan, pins=None, pinned=None, live=None):
    """The cells of one of ``plan``'s padded operands that a launch's
    function needs: the interior widened on each face by ``pinned`` cells
    where the face is pinned and by ``live`` where it is live (``pins``,
    default every face pinned; the last dim's faces always pinned). The
    defaults are the input's: the wall layer the taps read (the radius) at
    a pinned face, the launch's ghosts (the halo k*r) at a live one."""
    r, h = plan.spec.radius, plan.layout.halo
    pinned = r if pinned is None else pinned
    live = h if live is None else live
    nd = len(plan.interior_shape)
    pins = (1,) * (2 * (nd - 1)) if pins is None else tuple(pins)
    cells = 1
    for d, n in enumerate(plan.interior_shape):
        ends = (pins[2 * d], pins[2 * d + 1]) if d < nd - 1 else (1, 1)
        cells *= n + sum(pinned if p else live for p in ends)
    return cells


def point_cells(plan, pins=None):
    """The cells of an operand a launch reads only at the points it
    updates (a source f, the two-level mode's older level): the interior,
    and at a live face the ghosts its first sweep updates, (k-1)*r."""
    return needed_cells(plan, pins, 0,
                        plan.layout.halo - plan.spec.radius)


def bound(plan, src, dual, pins=None):
    """(bound ms, 'bytes' or 'operations') of one launch of ``plan`` with
    ``pins`` (default every face pinned), its values ``plan.itemsize``
    bytes each: the input read once where the function needs it
    (:func:`needed_cells`), a source where it is added
    (:func:`point_cells`), each output's interior written once."""
    n_int = int(np.prod(plan.interior_shape))
    nbytes = plan.itemsize * (needed_cells(plan, pins) + n_int
                              + (point_cells(plan, pins)
                                 if src is not None else 0)
                              + (n_int if dual else 0))
    per_point = plan.spec.flops_per_point
    k = plan.sweeps_per_call
    if getattr(plan, "cheby_coeffs", ()):
        # 3 multiplies and 2 adds, and from sweep 2 on one more of each
        ops = n_int * sum(per_point + 5 + (2 if t >= 2 else 0)
                          for t in range(1, k + 1))
    else:
        ops = n_int * k * (per_point + (1 if src is not None else 0))
    return bound_of(nbytes, ops, plan.dtype)


def bound_of(nbytes, ops, dtype="float32"):
    """(bound ms, 'bytes' or 'operations') of moving ``nbytes`` and doing
    ``ops`` operations on ``dtype`` values at the card's peaks (fp32 outside
    the tensor cores; bf16 at the table's bf16 rate)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / (PEAK_BF16_PER_S if dtype == "bfloat16"
                   else PEAK_FP32_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wave_bound(plan, pins=None):
    """(bound ms, 'bytes' or 'operations') of one two-level launch: the
    input level read where the taps need it, the older one at the points
    of the first sweep, both outputs' interiors written; per update the
    taps and the subtraction."""
    n_int = int(np.prod(plan.interior_shape))
    return bound_of(
        plan.itemsize * (needed_cells(plan, pins) + point_cells(plan, pins)
                         + 2 * n_int),
        n_int * plan.sweeps_per_call * (plan.spec.flops_per_point + 1),
        plan.dtype)


# fp32 operations of the coefficient mode. The function needs the weights
# once per point and launch (a(x) is fixed; the window kernel recomputing
# them at every sweep is its own choice): six face means of 4 (2x, *y,
# x+y, /), their sum 5, the center 2, six weights 6. Then per update seven
# products and six sums. The weights kernel forms three weights per
# padded point (the hi faces are the neighbours' lo weights): 34.
COEFF_WEIGHT_OPS = 37
COEFF_SWEEP_OPS = 13
WEIGHTS_KERNEL_OPS = 34


def coeff_ops(n_int, k):
    """fp32 operations one coefficient-mode launch of ``k`` sweeps over
    ``n_int`` interior points needs."""
    return n_int * (COEFF_WEIGHT_OPS + k * COEFF_SWEEP_OPS)


def wall_cut(plan, bc):
    """The index of the input a yardstick conv reads: ``plan``'s interior
    widened by the radius, but in the dynamic dims of ``bc``, which
    :func:`wall_pad` pads."""
    r, h = plan.spec.radius, plan.layout.halo
    dyn = bc.dynamic_mask(len(plan.interior_shape)) if bc is not None \
        else (False,) * len(plan.interior_shape)
    return tuple(slice(h, h + n) if dyn[d] else slice(h - r, h + n + r)
                 for d, n in enumerate(plan.interior_shape))


def wall_pad(x, plan, bc):
    """The library's own walls for a yardstick conv: ``x`` (batch and
    channels first, cut by :func:`wall_cut`) padded by the radius in each
    dynamic dim, one ``F.pad`` per kind: circular for periodic, replicate
    (the mirror at radius 1) for Neumann. ``x`` itself without them."""
    import torch.nn.functional as F

    if bc is None or not bc.any_dynamic:
        return x
    r, nd = plan.spec.radius, len(plan.interior_shape)
    for mode, mask in (("circular", bc.periodic_mask(nd)),
                       ("replicate", bc.neumann_mask(nd))):
        if any(mask):
            pad = [r if mask[d] else 0 for d in reversed(range(nd))
                   for _ in (0, 1)]
            x = F.pad(x, tuple(pad), mode=mode)
    return x


def wave_library_step(plan, cur, prev, bc=None):
    """One ``torch.nn.functional.conv3d`` call computing one leapfrog step
    of ``plan`` on the same levels: two input channels (L_t and L_(t-1)),
    weights S and -delta; with dynamic walls ``bc`` after their
    :func:`wall_pad`, which the call includes. Returns (call, check) as
    ``library_sweep``."""
    import torch
    import torch.nn.functional as F

    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    cut = wall_cut(plan, bc)
    x = torch.stack([cur[cut], prev[cut]])[None].contiguous()
    w = torch.zeros((1, 2, 3, 3, 3), dtype=x.dtype, device=x.device)
    for off, wt in zip(plan.spec.offsets, plan.spec.weights):
        w[(0, 0) + tuple(1 + o for o in off)] += wt
    w[0, 1, 1, 1, 1] = -1.0
    pins = dynamic_pins(bc, 3) if bc is not None else None

    def call():
        return F.conv3d(wall_pad(x, plan, bc), w)

    def check():
        want = plan.layout.unpad(sweep_reference(
            cur, plan.with_sweeps(1), prev=prev, pins=pins)[0])
        return float((call()[0, 0] - want).abs().max())

    return call, check


def library_sweep(plan, cur, src, bc=None):
    """One ``torch.nn.functional.conv3d``/``conv2d`` call computing one
    sweep of ``plan``'s mode on the same inputs: the padded u cut to the
    stencil's radius, the source as a second input channel (for the
    Chebyshev modes the raw f, with sweep 1's c, n and s as weights); with
    dynamic walls ``bc`` the cut stops at the interior in their dims and
    the call includes their :func:`wall_pad`. Returns (call, check) where
    check() is the call's max abs difference from one sweep of the plain
    version."""
    import torch
    import torch.nn.functional as F

    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    spec, r = plan.spec, plan.spec.radius
    nd = len(plan.interior_shape)
    cut = wall_cut(plan, bc)
    pins = dynamic_pins(bc, nd) if bc is not None else None
    chans = [cur[cut]] + ([src[cut]] if src is not None else [])
    x = torch.stack(chans)[None].contiguous()
    w = torch.zeros((1, len(chans)) + (2 * r + 1,) * nd, dtype=x.dtype,
                    device=x.device)
    center = (r,) * nd
    if getattr(plan, "cheby_coeffs", ()):
        c, n, _, s_ = (float(np.float32(v)) for v in plan.cheby_coeffs[0])
    else:
        c, n, s_ = 0.0, 1.0, 1.0
    for off, wt in zip(spec.offsets, spec.weights):
        w[(0, 0) + tuple(r + o for o in off)] += n * wt
    w[(0, 0) + center] += c
    if src is not None:
        w[(0, 1) + center] = s_
    conv = F.conv3d if nd == 3 else F.conv2d

    def call():
        return conv(wall_pad(x, plan, bc), w)

    def check():
        want = plan.layout.unpad(sweep_reference(cur, plan.with_sweeps(1),
                                                 src, pins=pins))
        return float((call()[0, 0] - want).abs().max())

    return call, check


def window_twin(plan, schedule="window"):
    """The window schedule's plan (or ``schedule``'s) of the same launch
    as the march ``plan`` (its own chooser's tiles, the same padded
    layout)."""
    from stencil_tpu_torch.ops.tiled import make_tiled_plan

    twin = make_tiled_plan(plan.spec, plan.interior_shape, plan.dtype,
                           plan.sweeps_per_call, schedule=schedule,
                           coeff_scales=plan.coeff_scales or None,
                           two_level=plan.two_level,
                           has_source=bool(plan.cheby_coeffs),
                           cheby_coeffs=plan.cheby_coeffs or None,
                           cheby_dual=plan.cheby_dual)
    require(twin.layout == plan.layout, f"{plan.tiles}: layouts differ")
    return twin


def time_call(fn, device, reps):
    from stencil_tpu_torch.utils.timing import timed

    fn()
    return timed(lambda: [fn() for _ in range(reps)], device) / reps * 1e3


def discarding(fn):
    """``fn`` with its result dropped at once: timed repeats of a call that
    allocates its output then reuse one block of the allocator's instead
    of holding every output (and paying a new allocation for each)."""
    def call():
        fn()
    return call


def slab_row(schedule, suffix=""):
    """The kernel record's row of a 2D launch on ``schedule``."""
    return ("slab_march" if schedule == "march" else "slab_sweep") + suffix


def slab_schedule(plan_info, spec, shape, dtype, k, block=None):
    """The schedule a 2D main path ran on (its ``plan_info``), required to
    be the one its plan gives (``make_slab_plan``'s rule)."""
    from stencil_tpu_torch.ops.slab import make_slab_plan

    want = make_slab_plan(spec, shape, dtype, k, t0_fixed=block).schedule
    require(plan_info.get("schedule") == want,
            f"{spec.name} {shape} {dtype} k={k}: ran {plan_info}, the plan "
            f"gives the {want}")
    return want


def other_schedule(schedule):
    return "window" if schedule == "march" else "march"


def run_cli(cli, args, kernel, label, count="launches"):
    """One CLI main path with ``kernel``'s counts set to 0 just before;
    returns (record, launches by ``count``), which must be all of the
    kernel's launches."""
    kernel.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "main.jsonl"
        rc = cli.main([*args, "-c", "--device", DEVICE,
                       "--json-out", str(out)])
        launches = getattr(kernel, count)
        require(launches == kernel.launches,
                f"main path {args}: {launches} {count} of "
                f"{kernel.launches} launches")
        rec = json.loads(out.read_text().splitlines()[0])
    iters = int(args[args.index("-i") + 1])
    require(rc == 0, f"main path {args} returned {rc}")
    chk = rec["check"]
    require(chk["ok"] and not chk["capped"]
            and chk["iterations_checked"] == iters
            and np.isfinite(chk["max_abs_err"]),
            f"main path {args} check: {chk}")
    require(launches > 0, f"main path {args} launched no {kernel.name}")
    print(f"main path {' '.join(args)}: check OK over "
          f"{chk['iterations_checked']} iterations vs the float64 golden, "
          f"max abs err {chk['max_abs_err']:.3e}; {launches} {kernel.name} "
          f"{count}; plan {rec['plan']}; {rec['glups']:.2f} GLUPS "
          f"[{label}]")
    return rec, launches


def poisson_solve(shape, kernel, device, count="source_launches"):
    """The manufactured solve through ``method="auto"``; returns the
    source-mode launches it made (by ``count``), which must be all of its
    launches."""
    from stencil_tpu_torch.models.poisson import (
        PoissonProblem, manufactured_sine,
    )

    prob = PoissonProblem(shape=shape, device=device)
    f, u_exact = manufactured_sine(shape)
    kernel.reset_counts()
    t0 = time.perf_counter()
    res = prob.solve(f, tolerance=1e-6, max_iterations=100_000,
                     check_every=200, method="auto")
    seconds = time.perf_counter() - t0
    launches = getattr(kernel, count)
    u = res.grid.interior().double().cpu().numpy()
    err = float(np.max(np.abs(u - u_exact)))
    bar = 5.0 * prob.h ** 2
    print(f"Poisson {shape} auto: {res.summary()} in {seconds:.2f} s; max "
          f"err vs exact {err:.3e} (bar 5 h^2 = {bar:.3e}); "
          f"{launches} {kernel.name}+source launches")
    require(res.converged, f"Poisson {shape} did not converge")
    require(np.isfinite(err) and err < bar,
            f"Poisson {shape}: error {err} >= {bar}")
    require(launches > 0 and launches == kernel.launches,
            f"Poisson {shape} did not run the {kernel.name} source mode")
    return launches


def poisson_golden(shape, kernel, rng, bc=None, count="source_launches",
                   dtype="float32"):
    """The Poisson runner (``method="auto"``, k=8) over POISSON_BIG_ITERS
    sweeps at ``shape`` on walls ``bc`` (default zero) in ``dtype``, against
    the float64 NumPy golden with the source (full shape, iterations cut)
    from the same (dtype-rounded) u0, within GOLDEN_TOL (bf16:
    BF16_SOURCE_TOL, and the source must move the golden by 5x that, where
    fp32 asks 100x its bar); returns (runner, problem, f, launches by
    ``count``), the counts set to 0 just before the run. In bf16 every
    launch must be a bf16 one."""
    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.ops import golden

    prob = PoissonProblem(shape=shape, bc=bc, dtype=dtype, device=DEVICE)
    tol, moved_by = ((BF16_SOURCE_TOL, 5) if dtype == "bfloat16"
                     else (GOLDEN_TOL, 100))
    u0 = rng.random(shape, dtype=np.float32)
    # f of size 1/h^2 makes the source's share of each sweep O(1), so a
    # missing or misplaced source fails the check
    f = rng.normal(size=shape) / prob.h ** 2
    runner = prob.runner(f, method="auto")
    grid0 = prob.initial_grid(u0)
    u0 = grid0.interior().double().cpu().numpy()  # as the runner starts
    kernel.reset_counts()
    out = runner.iterate(grid0, POISSON_BIG_ITERS)
    n_src = getattr(kernel, count)
    require(dtype == "float32" or kernel.bf16_launches == kernel.launches,
            f"Poisson {shape} {dtype}: {kernel.bf16_launches} bf16 launches "
            f"of {kernel.launches}")
    got = out.interior().double().cpu().numpy()
    want = golden.golden_iterate(u0, prob.spec, POISSON_BIG_ITERS,
                                 bc=prob.bc, source=f,
                                 source_scale=prob.source_scale)
    moved = np.max(np.abs(want - golden.golden_iterate(
        u0, prob.spec, POISSON_BIG_ITERS, bc=prob.bc)))
    chk = golden.check_against_golden(got, want, tol)
    print(f"Poisson {shape} {dtype} {walls_name(prob.bc)} {runner.name} tiles "
          f"{runner.plan_info['tiles']}, "
          f"{POISSON_BIG_ITERS} iterations vs the float64 NumPy golden with "
          f"the source (full shape, iterations cut to {POISSON_BIG_ITERS}): "
          f"{'OK' if chk.ok else 'FAILED'} {chk.message()}; the source "
          f"moves the golden by {moved:.3e}; bar {tol:g}; {n_src} "
          f"{kernel.name} {count}")
    require(chk.ok and np.isfinite(chk.max_abs_err),
            f"Poisson {shape} {dtype} golden check")
    require(moved > moved_by * tol,
            f"Poisson {shape}: the source does not move the golden")
    require(n_src == POISSON_BIG_ITERS // runner.plan_info["k"]
            and n_src == kernel.launches, f"Poisson {shape} launches")
    return runner, prob, f, n_src


def bench(runner, grid, points, device, hbm, label, name=None):
    """GLUPS of ``runner`` on ``grid``, its roofline at the grid's dtype
    (2 bytes per value per sweep in bf16, 4 in fp32)."""
    from stencil_tpu_torch.core.grid import dtype_name
    from stencil_tpu_torch.utils import roofline
    from stencil_tpu_torch.utils.timing import measure_marginal

    g = max(1, runner.granularity)
    m = measure_marginal(lambda n: runner.iterate(grid, n).data, device,
                         warmup_iters=g, granularity=g, repeats=2,
                         min_signal_seconds=BENCH_SIGNAL_S)
    rep = roofline.report(points, 1, m.seconds_per_iteration,
                          dtype_name(grid.dtype), hbm)
    lo, hi = min(m.marginals), max(m.marginals)
    MARGINAL_SPREADS.append(((hi - lo) / lo, name or runner.name))
    print(f"{name or runner.name}: {rep.glups:.2f} GLUPS, "
          f"{rep.roofline_fraction:.3f} x naive roofline "
          f"({rep.roofline_glups:.1f} GLUPS at {hbm:.1f} GB/s), marginals "
          f"{[f'{x * 1e3:.4f}' for x in m.marginals]} ms/sweep [{label}]")
    return rep.glups


def compare_subset(kernel, plan, cur, pins, mode, src=None, coeff=None,
                   dual=False):
    """The interior and then the edge tile subsets of ``plan``
    (``partition_tiles``) launched into one output whose interior starts at
    -1: each launch bitwise against its plain version (which leaves the
    other columns as they were), the pair bitwise against the full launch;
    a dual plan's two outputs both. Returns the max abs difference."""
    import torch

    from stencil_tpu_torch.ops.sweep_kernel import subset_reference
    from stencil_tpu_torch.ops.tiled import partition_tiles

    interior, edge = partition_tiles(plan)
    require(interior and edge, f"{mode} {plan.interior_shape} tiles "
            f"{plan.tiles}: no interior/edge split")
    base = [cur.clone() for _ in range(2 if dual else 1)]
    for t in base:
        t[plan.layout.interior_index] = -1.0

    def pair(x):
        return list(x) if isinstance(x, tuple) else [x]

    def launch(outs, subset):
        got = kernel(cur, outs[0].clone(), plan, src, pins,
                     out2=outs[1].clone() if dual else None, coeff=coeff,
                     subset=subset)
        want = subset_reference(cur, outs[0], plan, subset, src, coeff,
                                pins, outs[1] if dual else None)
        return pair(got), pair(want)

    label = (f"{mode} {plan.spec.name} {plan.interior_shape} k="
             f"{plan.sweeps_per_call} tiles {plan.tiles}, pins {list(pins)}, "
             f"{len(interior)} interior + {len(edge)} edge columns")
    part, want = launch(base, interior)
    diff = max(check_equal(f"{label}: interior launch", g, w, True)
               for g, w in zip(part, want))
    got, want = launch(part, edge)
    full = pair(kernel(cur, base[0].clone(), plan, src, pins,
                       out2=base[1].clone() if dual else None, coeff=coeff))
    torch.cuda.synchronize()
    for g, w, f in zip(got, want, full):
        diff = max(diff, check_equal(f"{label}: then the edge launch", g, w,
                                     True))
        require(torch.equal(g, f), f"{label}: interior + edge launches are "
                "not the full launch")
    print(f"  {label}: interior + edge launches bitwise equal to the full "
          "launch")
    return diff


def subset_bound(plan, subset, src, pins):
    """(bound ms, 'bytes' or 'operations') of one subset launch with
    ``pins``: the input cells the function of its columns' points needs
    read once (those within k*r of the columns, at a pinned face only the
    wall layer, in d2 the interior and its wall layers; a coefficient
    plan's a(x) the same cells), a source within (k-1)*r of the columns
    (at a pinned face the interior only), its columns' points written
    once, k sweeps of updates on those points (a coefficient plan's
    weights once per point, ``coeff_ops``)."""
    from stencil_tpu_torch.ops.sweep_kernel import column_boxes

    kr, r = plan.halo, plan.spec.radius
    h = plan.layout.halo
    p0, p1, _ = plan.layout.padded_shape
    n0, n1, n2 = plan.interior_shape
    pins = (1,) * 4 if pins is None else tuple(pins)

    def cover(reach, wall):
        """The (d0, d1) cells within ``reach`` of the columns, cut at a
        pinned face ``wall`` cells past the interior."""
        m = np.zeros((p0, p1), bool)
        for b0, b1, _ in column_boxes(plan, subset):
            m[b0.start - reach:b0.stop + reach,
              b1.start - reach:b1.stop + reach] = True
        lo0, hi0 = (h - wall if pins[0] else 0,
                    h + n0 + wall if pins[1] else p0)
        lo1, hi1 = (h - wall if pins[2] else 0,
                    h + n1 + wall if pins[3] else p1)
        return int(m[lo0:hi0, lo1:hi1].sum())

    written = cover(0, 0) * n2
    read = cover(kr, r) * (n2 + 2 * r) * (2 if plan.has_coeff else 1)
    if src is not None:
        read += cover(kr - r, 0) * n2
    ops = coeff_ops(written, plan.sweeps_per_call) if plan.has_coeff else \
        written * plan.sweeps_per_call * (
            plan.spec.flops_per_point + (1 if src is not None else 0))
    return bound_of(plan.itemsize * (read + written), ops, plan.dtype)


def subset_times(kernel, plan, cur, pins, src, reps, coeff=None):
    """One interior and one edge launch of ``plan`` (a coefficient plan
    with its operand ``coeff``) and the full launch on the same block:
    kernel ms of each, the plain version's ms of the pair, and the pair's
    bound (the two launches' bounds summed)."""
    from stencil_tpu_torch.ops.sweep_kernel import subset_reference
    from stencil_tpu_torch.ops.tiled import partition_tiles

    interior, edge = partition_tiles(plan)
    nxt = cur.clone()
    t_int = time_call(lambda: kernel(cur, nxt, plan, src, pins, coeff=coeff,
                                     subset=interior), DEVICE, reps)
    t_edge = time_call(lambda: kernel(cur, nxt, plan, src, pins, coeff=coeff,
                                      subset=edge), DEVICE, reps)
    t_full = time_call(lambda: kernel(cur, nxt, plan, src, pins,
                                      coeff=coeff), DEVICE, reps)
    plain = time_call(lambda: [subset_reference(cur, nxt, plan, s, src,
                                                coeff, pins)
                               for s in (interior, edge)], DEVICE, 2)
    b_int, b_edge = (subset_bound(plan, s, src, pins)
                     for s in (interior, edge))
    by = "bytes" if "bytes" in (b_int[1], b_edge[1]) else "operations"
    return dict(interior=t_int, edge=t_edge, full=t_full, plain=plain,
                bound=b_int[0] + b_edge[0], by=by,
                columns=(len(interior), len(edge)))


def window_pair_ms(kernel, plan, cur, pins, src, reps, coeff=None):
    """The window schedule's interior + edge launches of the same block
    as the march ``plan`` (its own partition; a coefficient plan with the
    window's operand ``coeff``, the padded a(x)), or its full launch where
    its tiles leave either set empty."""
    from stencil_tpu_torch.ops.tiled import partition_tiles

    twin = window_twin(plan)
    if all(partition_tiles(twin)):
        rec = subset_times(kernel, twin, cur, pins, src, reps, coeff)
        return rec["interior"] + rec["edge"]
    nxt = cur.clone()
    return time_call(lambda: kernel(cur, nxt, twin, src, pins, coeff=coeff),
                     DEVICE, reps)


def run_sharded_eager_cli(cli, label):
    """``-m sharded --mesh 2 2 -c`` (the eager sweep per rank, r-deep halos
    every sweep) at SHARDED_EAGER_SIZE: the float64 golden over every
    iteration."""
    args = ["-s", *map(str, SHARDED_EAGER_SIZE), "--spec", "jacobi27", "-m",
            "sharded", "--mesh", "2", "2", "-i", "16"]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "sharded.jsonl"
        rc = cli.main([*args, "-c", "--device", DEVICE, "--json-out",
                       str(out)])
        rec = json.loads(out.read_text().splitlines()[0])
    chk = rec["check"]
    require(rc == 0 and chk["ok"] and not chk["capped"]
            and np.isfinite(chk["max_abs_err"]),
            f"main path {args}: rc {rc}, check {chk}")
    print(f"main path {' '.join(args)}: check OK over "
          f"{chk['iterations_checked']} iterations vs the float64 golden, "
          f"max abs err {chk['max_abs_err']:.3e}; plan {rec['plan']}; "
          f"{rec['glups']:.2f} GLUPS [{label}]")


def run_sharded_poisson(kernel, rng, label, dtype):
    """The sharded Poisson runner at POISSON_BIG on a (2, 2) mesh, periodic
    d0 and Neumann d1, k=8, over POISSON_COMPARE_ITERS sweeps (two steps
    and a remainder of 3), against the single-device Poisson tiled runner:
    bitwise. Every launch a source subset launch (and in bf16 a bf16 one);
    returns their count, the counts set to 0 just before."""
    import torch

    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.parallel.mesh import make_mesh

    bc = walls(3, (0,), (1,))
    prob = PoissonProblem(shape=POISSON_BIG, bc=bc, dtype=dtype,
                          device=DEVICE)
    f = rng.normal(size=POISSON_BIG) / prob.h ** 2
    mesh = make_mesh(SHARDED_MESH, ("x", "y"), DEVICE)
    runner = prob.sharded_runner(f, mesh, sweeps_per_call=8,
                                 axis_names=("x", "y"))
    g0 = prob.initial_grid(rng.random(POISSON_BIG, dtype=np.float32))
    kernel.reset_counts()
    got = runner.iterate(g0, POISSON_COMPARE_ITERS)
    torch.cuda.synchronize()
    n = kernel.march_source_subset_launches
    steps = -(-POISSON_COMPARE_ITERS // 8)
    require(n == kernel.launches == 2 * steps * mesh.size
            and (dtype == "float32" or kernel.bf16_launches == n),
            f"sharded Poisson {dtype}: {n} source subset launches, "
            f"{kernel.bf16_launches} bf16, {kernel.launches} in all")
    want = prob.runner(f, method="tiled", sweeps_per_call=8).iterate(
        g0, POISSON_COMPARE_ITERS)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.data.float()).all())
            and torch.equal(got.data, want.data),
            f"sharded Poisson {dtype}: not bitwise the single-device runner")
    print(f"sharded Poisson {POISSON_BIG} {dtype} {walls_name(bc)} "
          f"{runner.name} mesh {SHARDED_MESH} local tiles "
          f"{runner.plan_info['tiles']}, {POISSON_COMPARE_ITERS} sweeps: "
          f"bitwise equal to the single-device Poisson tiled runner (max |u| "
          f"{float(got.interior().float().abs().max()):.3e}); {n} "
          f"{kernel.name} source subset launches [{label}]")
    return n


def run_sharded_2d(kernel, label):
    """2D ``sharded_pallas`` on a 1D mesh (the slab kernel per rank, no
    split) at SHARDED_2D against ``slab``: bitwise; returns the launches."""
    import torch

    from stencil_tpu_torch import cli, registry
    from stencil_tpu_torch.config import RunConfig
    from stencil_tpu_torch.core.spec import get_spec

    spec_name, size, k, mesh, iters = SHARDED_2D
    spec = get_spec(spec_name)
    cfg = RunConfig(size=size, spec=spec_name, temporal=k, mesh=mesh,
                    device=DEVICE)
    grid = cli.make_grid(cfg, spec)
    runner = registry.get_runner("sharded_pallas", cfg, spec, grid)
    kernel.reset_counts()
    got = runner.iterate(grid, iters)
    torch.cuda.synchronize()
    n = kernel.launches
    want = registry.get_runner("slab", cfg, spec, grid).iterate(grid, iters)
    torch.cuda.synchronize()
    require(n == iters // k * int(np.prod(mesh)) and
            torch.equal(got.data, want.data),
            f"2D sharded_pallas {size}: {n} launches, or not bitwise slab")
    local = (size[0] // mesh[0], *size[1:])
    slab_schedule(runner.plan_info, spec, local, "float32", k)
    print(f"2D {runner.name} {spec_name} {size}, {iters} sweeps: bitwise "
          f"equal to slab; plan {runner.plan_info}; {n} {kernel.name} "
          f"launches [{label}]")
    return n


def time_sharded(kernel, label):
    """The sharded headline at BASELINE's width: jacobi7 SHARDED_SIZE fp32
    k=8 from a seeded random interior, on ``tiled`` and on
    ``sharded_pallas`` over SHARDED_TIMED meshes. Each sharded result after
    2k sweeps bitwise the single-device one (the race check of the in-place
    exchange); per run GLUPS and ms per outer step from the marginal of 2k
    and 4k sweeps (CUDA events); per mesh the exchange's ms alone on its
    side stream and the bytes it moves (the audit); the (2, 2) run's device
    idle share. Then the subset launches' times at the (2, 2) local block.
    Returns the kernel record's row of ``tiled_march+subset``."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.ops.tiled import TiledStencil
    from stencil_tpu_torch.parallel import comm_audit
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.sharded_kernel import (
        ShardedKernelStencil,
    )
    from stencil_tpu_torch.utils.timing import timed

    j7, k = get_spec("jacobi7"), SHARDED_K
    points = int(np.prod(SHARDED_SIZE))
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    grid = HaloGrid.from_interior(
        torch.rand(SHARDED_SIZE, generator=gen, device=DEVICE), halo=1,
        device=DEVICE)
    n1, n2 = 2 * k, 4 * k
    ref = None
    record = None
    for (method_name, mesh_sizes, overlap), schedule in itertools.product(
            SHARDED_TIMED, ("march", "window")):
        if method_name == "tiled":
            name = f"tiled k={k} {schedule}"
            st = TiledStencil(j7, SHARDED_SIZE, sweeps_per_call=k,
                              device=DEVICE, schedule=schedule)

            def run(n, st=st):
                return st.iterate(grid, n)
        else:
            axes = ("x", "y")[:len(mesh_sizes)]
            mesh = make_mesh(mesh_sizes, axes, DEVICE)
            st = ShardedKernelStencil(j7, SHARDED_SIZE, axis_names=axes,
                                      sweeps_per_call=k, overlap=overlap,
                                      schedule=schedule)
            name = (f"sharded_pallas mesh {mesh_sizes} k={k}"
                    f"{'' if overlap else ' --no-overlap'} {schedule}")

            def run(n, st=st, mesh=mesh):
                return st.iterate(grid, n, mesh)
        kernel.reset_counts()
        out = run(n1)
        torch.cuda.synchronize()
        launches, subsets = kernel.launches, kernel.subset_launches
        require(schedule == "window" or (
            kernel.march_launches == launches > 0
            and kernel.march_subset_launches == subsets),
            f"{name}: {kernel.march_launches} march launches of {launches}")
        if ref is None:
            ref = out.data
            same = "the reference"
        else:
            require(torch.equal(out.data, ref),
                    f"{name}: not bitwise the single-device result")
            same = "bitwise equal to tiled"
        del out
        # the least of two runs each (the window's, steady to 1%: one)
        tries = range(2 if schedule == "march" else 1)
        t1 = min(timed(lambda: run(n1), DEVICE) for _ in tries)
        t2 = min(timed(lambda: run(n2), DEVICE) for _ in tries)
        per_sweep = (t2 - t1) / (n2 - n1)
        extra = ""
        if method_name != "tiled" and schedule == "march":
            plan = st.local_plan(mesh_sizes)
            blocks = st.scatter(grid, mesh)
            with comm_audit.audit() as rec:
                st.exchange(mesh, blocks, plan, grid.bc)
            side = mesh.side_stream(mesh.devices[0])
            # the exchange's blocks were padded on the compute stream
            side.wait_stream(torch.cuda.current_stream(mesh.devices[0]))
            with mesh.exchange_streams():
                st.exchange(mesh, blocks, plan, grid.bc)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(side)
                for _ in range(10):
                    st.exchange(mesh, blocks, plan, grid.bc)
                end.record(side)
            end.synchronize()
            xms = start.elapsed_time(end) / 10
            del blocks
            extra = (f"; the exchange alone {xms:.4f} ms per outer step on "
                     f"its side stream, {rec.ppermute_count} ppermutes of "
                     f"{rec.ppermute_bytes} bytes per rank "
                     f"({rec.ppermute_bytes * mesh.size / 1e6:.1f} MB over "
                     f"the {mesh.size} ranks); local plan "
                     f"{plan.interior_shape} tiles {plan.tiles}")
            if mesh_sizes == SHARDED_MESH and overlap:
                wall, busy, span = device_busy(lambda: run(n1), DEVICE)
                extra += ("; device busy share not measured (the trace "
                          "holds no device events)" if busy is None else
                          f"; {n1} sweeps: host wall {wall:.3f} ms "
                          f"unprofiled, device busy {busy:.3f} ms of a "
                          f"{span:.3f} ms span, idle "
                          f"{100 * (1 - busy / span):.1f}%")
        print(f"{name} jacobi7 {SHARDED_SIZE} fp32: "
              f"{points / per_sweep / 1e9:.2f} GLUPS, "
              f"{per_sweep * k * 1e3:.3f} ms per outer step (marginal of "
              f"{n1} and {n2} sweeps: {t1 * 1e3:.1f} / {t2 * 1e3:.1f} ms); "
              f"{launches} launches for {n1} sweeps, {subsets} of them "
              f"subset launches; {same}{extra} [{label}]")
        if mesh_sizes == SHARDED_MESH and overlap and schedule == "march":
            plan = st.local_plan(mesh_sizes)
            cur = st.scatter(grid, mesh)[0]
            pins = st.pins(mesh, 0, grid.bc)
            record = subset_times(kernel, plan, cur, pins, None, 3)
            record["window"] = window_pair_ms(kernel, plan, cur, pins, None,
                                              2)
            lib, lib_check = library_sweep(plan, cur, None)
            record["library"] = time_call(lib, DEVICE, 3)
            record["full_bound"] = bound(plan, None, False, pins)[0]
            print(f"one interior + one edge launch of tiled_march+subset "
                  f"(rank 0's block {plan.interior_shape} k={k} tiles "
                  f"{plan.tiles}, pins {list(pins)}, "
                  f"{record['columns'][0]} interior + "
                  f"{record['columns'][1]} edge columns): kernel "
                  f"{record['interior']:.4f} + {record['edge']:.4f} ms "
                  f"beside {record['full']:.4f} ms for the full launch; "
                  f"the window schedule's pair {record['window']:.4f} ms; "
                  f"plain {record['plain']:.4f} ms; bound "
                  f"{record['bound']:.4f} ms (by {record['by']}; the full "
                  f"launch {record['full_bound']:.4f}); library conv3d "
                  f"{record['library']:.4f} ms per sweep (vs one plain sweep "
                  f"max abs diff {lib_check():.3e}) [{label}]")
            del cur
        del st
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return record


def rma_spec(name):
    from stencil_tpu_torch.core.spec import box, get_spec, star

    return {"box3": lambda: box(3, 1),
            "star3_r2": lambda: star(3, 2)}.get(name,
                                                lambda: get_spec(name))()


def rma_walls(ndim, periodic, neumann):
    """RMA_FACES on ``ndim`` dims with the given dims periodic or
    Neumann."""
    from stencil_tpu_torch.core.grid import DirichletBC

    bc = DirichletBC(values=RMA_FACES[ndim])
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    return bc


def rma_mode(periodic, neumann, dtype):
    """The kernel record's mode of an rma case."""
    if dtype == "bfloat16":
        return "rma_iterate+bf16"
    return "rma_iterate+pins" if periodic or neumann else "rma_iterate"


def compare_rma(kernel, rng):
    """Each of RMA_CASES: one launch of ``iters // k`` steps and one of the
    remainder on every rank's buffers (scattered from a random grid with
    RMA_FACES on the case's walls, in its dtype), both slots, cell for
    cell, against the plain version's from the same buffers, bitwise
    required. The compute buffers are left out: the kernel runs the sweeps
    between in shared memory and never touches them. Returns the largest
    difference per kernel record mode."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid, torch_dtype
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, rma_iterate_reference,
    )

    worst = {}
    for name, shape, sizes, k, iters, per, neu, dtype in RMA_CASES:
        sp = rma_spec(name)
        bc = rma_walls(len(shape), per, neu)
        x = rng.random(shape, dtype=np.float32)
        g = HaloGrid.from_interior(
            torch.from_numpy(x).to(torch_dtype(dtype)), halo=sp.radius,
            bc=bc, device=DEVICE)
        mesh = make_mesh(sizes, ("x", "y")[:len(sizes)], DEVICE)
        method = RmaStencil(sp, shape, dtype, sweeps_per_call=k)
        plan = method.plan_for(mesh, bc)
        n_outer, rem = divmod(iters, k)
        got = method.scatter(g, mesh, plan)
        want = got.clone()
        kernel(got, plan, n_outer)
        rma_iterate_reference(want, plan, n_outer)
        if rem:
            kernel(got, plan.with_sweeps(rem), 1, n_outer % 2)
            rma_iterate_reference(want, plan.with_sweeps(rem), 1,
                                  n_outer % 2)
        mode = rma_mode(per, neu, dtype)
        worst[mode] = max(worst.get(mode, 0.0), check_equal(
            f"rma_iterate {sp.name} {shape} mesh {sizes} k={k} {dtype}, "
            f"{walls_name(bc)}, {n_outer} steps"
            f"{f' + a remainder of {rem}' if rem else ''}, tile "
            f"{plan.tile}, both slots of {tuple(plan.buffer_shape)}",
            got[:, :2], want[:, :2], exact=True))
        del got, want
    return worst


def run_rma_paths(cli, kernel, label):
    """The bench cell through the CLI, ``-s 64 64 128 -i 64 --spec jacobi7
    -m rma -k 2 -c``, on (1,) and with ``--mesh 2 2``, then each of
    RMA_WALL_RUNS (``--periodic 0 1 --mesh 2 2``, ``--neumann 1 --mesh 2``;
    ``--dtype bfloat16`` on (1,) and (2, 2) at RMA_BF16_ITERS sweeps, the
    golden's bf16 bar), each run's launches counted from 0 and every one
    of them of the run's kind; then each runner's result bitwise the
    ``tiled`` runner's at the same k, walls and dtype. Returns the
    launches per kernel record mode."""
    import torch

    from stencil_tpu_torch import registry
    from stencil_tpu_torch.config import parse_args

    runs = [((), mesh, "float32", "launches", "rma_iterate")
            for mesh in RMA_MESHES] + list(RMA_WALL_RUNS)
    total = {}
    for flags, mesh, dtype, count, mode in runs:
        iters = RMA_BF16_ITERS if dtype == "bfloat16" else RMA_ITERS
        args = ["-s", *map(str, RMA_SIZE), "--spec", "jacobi7", "-m", "rma",
                "-k", str(RMA_K), "-i", str(iters), *flags]
        if mesh != (1,):
            args += ["--mesh", *map(str, mesh)]
        if dtype != "float32":
            args += ["--dtype", dtype]
        rec, n = run_cli(cli, args, kernel, label, count)
        require(rec["plan"]["kernel"] == "rma_iterate"
                and rec["plan"]["mesh"] == list(mesh), f"{args} ran "
                f"{rec['plan']}")
        total[mode] = total.get(mode, 0) + n
        cfg = parse_args([*args, "--device", DEVICE])
        sp = cfg.resolved_spec()
        grid = cli.make_grid(cfg, sp)
        kernel.reset_counts()
        got = registry.get_runner("rma", cfg, sp, grid).iterate(grid, iters)
        launches = getattr(kernel, count)
        want = registry.get_runner("tiled", cfg, sp, grid).iterate(grid,
                                                                   iters)
        torch.cuda.synchronize()
        require(launches == kernel.launches == 1
                and torch.equal(got.data, want.data),
                f"rma {args}: {launches} {count} of {kernel.launches} "
                "launches, or not bitwise tiled")
        print(f"rma {' '.join(flags) or 'dirichlet'} mesh {mesh} k={RMA_K} "
              f"{dtype} {RMA_SIZE}, {iters} sweeps in one launch: bitwise "
              f"equal to tiled k={RMA_K} [{label}]")
    return total


def time_rma(kernel, label):
    """GLUPS and ms per outer step of ``rma`` k=2 beside ``tiled`` on the
    same walls and dtype: on RMA_MESHES at RMA_SIZE (the bench cell) and
    RMA_BIG, Dirichlet fp32, beside ``tiled`` at k=2 and k=8; at RMA_SIZE
    on each of RMA_WALL_RUNS' walls, mesh and dtype; at RMA_BF16_BIG in
    bf16 on (1,). Each the marginal of RMA_TIMED_STEPS outer steps of the
    iterate (the least of RMA_REPEATS runs), on the host's clock after a
    synchronisation (an rma iterate is one launch between a scatter and a
    gather whose host time hides a short launch from CUDA events around
    it); the device idle share of the bench cell's Dirichlet iterates,
    where the trace holds the cooperative launch. Then launches alone, of
    RMA_STEPS and 2 * RMA_STEPS steps, and their marginal per step, at the
    bench cell (its plain version beside) on RMA_MESHES and (2,) (the
    Dirichlet twin of ``--neumann 1``'s mesh) and with every run's walls,
    mesh and dtype, and at RMA_TINY, whose step is mostly the kernel's
    fixed cost per step; each line names the tile count and the flag
    waits per step.
    Then the kernel record's rows: one launch of RMA_STEPS steps at the
    bench cell, its plain version, its bound and the library's one sweep
    of the same grid (after ``F.pad`` with dynamic walls): Dirichlet fp32
    on (1,) for ``rma_iterate``, ``--neumann 1`` on (2,) (the refresh) for
    ``rma_iterate+pins``, bf16 on (1,) for ``rma_iterate+bf16``. Returns
    the rows by mode."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid, torch_dtype
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.ops.tiled import TiledStencil, make_tiled_plan
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, rma_iterate_reference, rma_tiles,
    )

    def wall(run, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def walls_of(flags):
        per = tuple(int(d) for d in flags[1:]) if "--periodic" in flags \
            else ()
        neu = tuple(int(d) for d in flags[1:]) if "--neumann" in flags \
            else ()
        return rma_walls(3, per, neu)

    j7 = get_spec("jacobi7")
    gen = torch.Generator(DEVICE).manual_seed(SEED)

    def grid_of(shape, bc=None, dtype="float32"):
        x = torch.rand(shape, generator=gen, device=DEVICE)
        return HaloGrid.from_interior(x.to(torch_dtype(dtype)), halo=1,
                                      bc=bc, device=DEVICE)

    def mesh_of(sizes):
        return make_mesh(sizes, ("x", "y")[:len(sizes)], DEVICE)

    # (label, shape, grid, dtype, rma meshes, tiled ks)
    cells = [("dirichlet", shape, grid_of(shape), "float32", RMA_MESHES,
              (RMA_K, 8)) for shape in (RMA_SIZE, RMA_BIG)]
    for flags, sizes, dtype, _, _ in RMA_WALL_RUNS:
        bc = walls_of(flags) if flags else None
        cells.append((" ".join(flags) or "dirichlet", RMA_SIZE,
                      grid_of(RMA_SIZE, bc, dtype), dtype, (sizes,),
                      (RMA_K,)))
    cells.append(("dirichlet", RMA_BF16_BIG,
                  grid_of(RMA_BF16_BIG, dtype="bfloat16"), "bfloat16",
                  ((1,),), (RMA_K,)))
    for walls, shape, grid, dtype, meshes, ks in cells:
        runs = [(f"rma mesh {sizes} k={RMA_K}", RMA_K,
                 lambda n, st=RmaStencil(j7, shape, dtype, RMA_K),
                 mesh=mesh_of(sizes): st.iterate(grid, n, mesh))
                for sizes in meshes]
        runs += [(f"tiled k={k}", k,
                  lambda n, st=TiledStencil(j7, shape, dtype,
                                            sweeps_per_call=k,
                                            device=DEVICE):
                  st.iterate(grid, n))
                 for k in ks]
        for name, k, run in runs:
            n1, n2 = (steps * k for steps in RMA_TIMED_STEPS)
            run(n1)
            t1 = min(wall(run, n1) for _ in range(RMA_REPEATS))
            t2 = min(wall(run, n2) for _ in range(RMA_REPEATS))
            per_sweep = (t2 - t1) / (n2 - n1)
            print(f"{name} jacobi7 {shape} {dtype} {walls}: "
                  f"{int(np.prod(shape)) / per_sweep / 1e9:.2f} GLUPS, "
                  f"{per_sweep * k * 1e3:.4f} ms per outer step (marginal "
                  f"of {n1} and {n2} sweeps: {t1 * 1e3:.3f} / "
                  f"{t2 * 1e3:.3f} ms) [{label}]")
            if (shape == RMA_SIZE and walls == "dirichlet"
                    and dtype == "float32" and name.startswith("rma")):
                host, busy, span = device_busy(lambda: run(RMA_ITERS),
                                               DEVICE, "rma_iterate",
                                               tries=3)
                print(f"  {name} {RMA_ITERS} sweeps: host wall {host:.3f} "
                      "ms unprofiled, " + (
                          "device busy share not measured (no trace of 3 "
                          "held an rma_iterate launch)" if busy is None else
                          f"device busy {busy:.3f} ms of a {span:.3f} ms "
                          f"span, idle {100 * (1 - busy / span):.1f}%")
                      + f" [{label}]")
    # launches alone: walls flags, shape, mesh, dtype
    alone = [((), shape, sizes, "float32") for shape in (RMA_SIZE, RMA_TINY)
             for sizes in RMA_MESHES + ((2,),)]
    alone += [(flags, RMA_SIZE, sizes, dtype)
              for flags, sizes, dtype, _, _ in RMA_WALL_RUNS]
    rows = {}
    for flags, shape, sizes, dtype in alone:
        walls = " ".join(flags) or "dirichlet"
        mode = RMA_RECORD.get((flags, sizes, dtype)) \
            if shape == RMA_SIZE else None
        bc = walls_of(flags) if flags else None
        grid = grid_of(shape, bc, dtype)
        mesh = mesh_of(sizes)
        st = RmaStencil(j7, shape, dtype, RMA_K)
        plan = st.plan_for(mesh, bc)
        bufs = st.scatter(grid, mesh, plan)
        t1 = time_call(lambda: kernel(bufs, plan, RMA_STEPS), DEVICE, 5)
        t2 = time_call(lambda: kernel(bufs, plan, 2 * RMA_STEPS), DEVICE, 5)
        step = (t2 - t1) / RMA_STEPS * 1e3
        tiles = rma_tiles(plan)
        line = (f"one rma_iterate launch of {RMA_STEPS} steps, jacobi7 "
                f"{shape} k={RMA_K} mesh {sizes} {dtype} {walls}: "
                f"{t1:.4f} ms, {step:.2f} us per step (the marginal of "
                f"{RMA_STEPS} and {2 * RMA_STEPS} steps); {tiles.ntiles} "
                f"tiles of {plan.tile}, {tiles.waits_per_step} flag waits "
                f"per step ({tiles.waits_per_step / tiles.ntiles:.1f} per "
                "tile), one grid barrier per launch")
        if shape == RMA_SIZE:
            plain = st.scatter(grid, mesh, plan)
            plain_ms = time_call(lambda: rma_iterate_reference(
                plain, plan, RMA_STEPS), DEVICE, 1)
            line += f"; plain {plain_ms:.4f} ms"
            del plain
        print(f"{line} [{label}]")
        if mode is not None:
            # the function: RMA_STEPS * k sweeps of the grid; the grid
            # and its radius-deep ghosts read once, the interior written
            # once, the taps of every update
            n_int = int(np.prod(shape))
            n_pad = int(np.prod([n + 2 * j7.radius for n in shape]))
            bound, by = bound_of(
                plan.itemsize * (n_pad + n_int),
                n_int * RMA_STEPS * RMA_K * j7.flops_per_point, dtype)
            tplan = make_tiled_plan(j7, shape, dtype, 1)
            lib, lib_check = library_sweep(tplan, refreshed(tplan, grid),
                                           None, bc)
            library = time_call(lib, DEVICE, 20)
            rows[mode] = {"ms": t1, "plain": plain_ms, "bound": bound,
                          "by": by, "library": library}
            print(f"{mode} bound for {RMA_STEPS} steps of k={RMA_K} at "
                  f"{shape} {dtype} {walls}: {bound:.4f} ms (by {by}); "
                  f"library {'F.pad + ' if bc is not None else ''}conv3d "
                  f"{library:.4f} ms per sweep (vs one plain sweep max abs "
                  f"diff {lib_check():.3e}) [{label}]")
        del bufs, grid
    return rows


def device_busy(run, device, kernel_name="", tries=1):
    """(host wall ms, device busy ms, device span ms) of ``run()`` from a
    ``torch.profiler`` trace; busy is None when none of ``tries`` traces
    holds a device event whose name holds ``kernel_name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(kernel_name in e.name for e in events):
            break
    else:
        return wall, None, None
    ranges = [(e.time_range.start, e.time_range.end) for e in events]
    busy = sum(end - start for start, end in ranges) / 1e3
    span = (max(e for _, e in ranges) - min(s for s, _ in ranges)) / 1e3
    return wall, busy, span


def cycles_main(checkout) -> int:
    """``python3 chip_smoke.py --cycles CHECKOUT``: cfg10's V-cycle
    (weighted Jacobi V(4,4), the tiled fine level, MG_SIZE, bench.py's
    seeded f) on the package of CHECKOUT, which may be another commit's
    (unpacked with ``git archive``). Run it for two checkouts in turns
    (parent, change, change, parent, ...) to compare them on one card.
    Four runs in turns, the plan rule's schedules and every fine plan on
    the window (:func:`on_window`), each printing ms per V-cycle (the
    median of CYCLE_RUNS runs of CYCLE_REPEATS cycles, CUDA events), the
    host's ms per cycle to enqueue them (their median) and, from a
    profiler trace of CYCLE_REPEATS cycles, per cycle the device's busy
    ms, the host's CUDA runtime calls and the operators of most host time
    (self CPU ms and calls); then one launch of each fine-level operation
    (the mean of 20). The kernels build into CHECKOUT's ``build/``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    root = Path(checkout).resolve()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (root / "stencil_tpu_torch").is_dir():
        print(f"chip_smoke: no stencil_tpu_torch package in {root}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import stencil_tpu_torch
    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.multigrid import Multigrid
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

    require(Path(stencil_tpu_torch.__file__).resolve().parents[1] == root,
            f"imported {stencil_tpu_torch.__file__}, not {root}'s package")
    label = f"{gpu_label()}; checkout {root}"
    prob = PoissonProblem(shape=MG_SIZE, device=DEVICE)
    f = torch.from_numpy(np.random.default_rng(MG_SEED).normal(
        size=MG_SIZE).astype(np.float32)).to(DEVICE)
    timed_ops = set()
    for sched in ("rule", "window", "window", "rule"):
        with on_window() if sched == "window" else contextlib.nullcontext():
            mg = Multigrid(prob, nu1=4, nu2=4, fine_method="pallas_tiled")
            run = mg.runner(f)
            ops = [op for op in mg._fine_ops()[2:] if op is not None]
        g0 = prob.initial_grid()
        run.iterate(g0, 1)
        torch.cuda.synchronize()
        walls, hosts = [], []
        for _ in range(CYCLE_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run.iterate(g0, CYCLE_REPEATS)
            end.record()
            hosts.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            walls.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run.iterate(g0, CYCLE_REPEATS)
            torch.cuda.synchronize()
        busy = sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        rows = [(a.key, a.self_cpu_time_total / 1e3 / CYCLE_REPEATS,
                 a.count / CYCLE_REPEATS) for a in prof.key_averages()
                if a.self_cpu_time_total > 0]
        rows.sort(key=lambda row: -row[1])
        host_ms = sum(ms for _, ms, _ in rows)
        n_ops = sum(c for n, _, c in rows if not n.startswith("cuda"))

        def listing(picked):
            return "; ".join(f"{n} {ms:.4f} ms x{c:g}" for n, ms, c in picked)

        calls = listing([row for row in rows
                         if row[0].startswith("cuda")][:3])
        top = listing([row for row in rows
                       if not row[0].startswith("cuda")][:6])
        where = "the plan rule's schedules" if sched == "rule" else \
            "every fine plan on the window"
        print(f"cfg10 wjacobi V(4,4) {MG_SIZE}, tiled fine level, {where}: "
              f"{statistics.median(walls) / CYCLE_REPEATS:.4f} ms per "
              f"V-cycle (median of {CYCLE_RUNS} runs of {CYCLE_REPEATS}; "
              f"runs {[round(w / CYCLE_REPEATS, 3) for w in walls]}), the "
              f"host {statistics.median(hosts) / CYCLE_REPEATS:.4f} ms per "
              f"cycle to enqueue it; per cycle in the trace: device busy "
              f"{busy / 1e3 / CYCLE_REPEATS:.4f} ms, host self CPU "
              f"{host_ms:.4f} ms in {n_ops:g} operator calls; CUDA calls "
              f"{calls}; operators {top} [{label}]")
        sys.stdout.flush()
        if sched in timed_ops:
            continue
        timed_ops.add(sched)
        parts = []
        for op in ops:
            plan = op.plan
            cur = plan.layout.pad_grid(g0)
            src = pad_source(plan, f, op.source_scale, prob.bc)
            nxt = cur.clone()
            out2 = cur.clone() if plan.cheby_dual else None
            ms = time_call(lambda: tiled_sweep(cur, nxt, plan, src,
                                               out2=out2), DEVICE, 20)
            parts.append(f"{plan.spec.name} k={plan.sweeps_per_call} "
                         f"{plan.schedule} tiles {plan.tiles} {ms:.4f} ms")
        print(f"  one launch of each fine-level operation, {where}: "
              f"{'; '.join(parts)} [{label}]")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "stencil_tpu_torch").is_dir():
        print(f"chip_smoke: no stencil_tpu_torch package beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    def stamp(what):
        """The script's clock at a section's end, for its time budget."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}")

    # 1. device
    device = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    label = gpu_label()
    print(f"device: {kind}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(label)
    print(f"clocks.sm, clocks.mem, power.draw, temperature: {gpu_state()}")
    print("PHASE 1 device: ok")

    # 2. build: nvcc for each kernel and g++ for the golden, together
    from stencil_tpu_torch import native
    from stencil_tpu_torch.ops import slab_kernel, tiled_kernel
    from stencil_tpu_torch.parallel import rma as rma_module

    kernels = (tiled_kernel.tiled_sweep, tiled_kernel.tiled_march,
               tiled_kernel.coeff_weights, slab_kernel.slab_sweep,
               slab_kernel.slab_march, rma_module.rma_iterate)
    with concurrent.futures.ThreadPoolExecutor(len(kernels) + 1) as pool:
        t0 = time.perf_counter()
        golden = pool.submit(native.available)
        builds = [pool.submit(kernel.build) for kernel in kernels]
        builds = [b.result() for b in builds]
        require(golden.result(), "native golden failed to build (g++)")
    print(f"parallel build: {time.perf_counter() - t0:.2f} s")
    for kernel, b in zip(kernels, builds):
        kernel.library()
        print(f"nvcc build of {kernel.source.relative_to(ROOT)}: "
              f"{b.seconds:.2f} s{' (cached)' if b.cached else ''}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"PHASE 2 build: ok at {time.perf_counter() - t_start:.1f} s")

    # 3. kernel vs plain on the card, per kernel mode
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.models.poisson import (
        PoissonProblem, manufactured_sine,
    )
    from stencil_tpu_torch.ops.slab import SlabStencil, make_slab_plan
    from stencil_tpu_torch.ops.tiled import TiledStencil, make_tiled_plan

    tiled = tiled_kernel.tiled_sweep
    slab = slab_kernel.slab_sweep
    # the slab_sweep rows hold the window schedule, the slab_march rows the
    # march: each asks its plan for its schedule
    window_slab = functools.partial(make_slab_plan, schedule="window")
    rng = np.random.default_rng(SEED)
    j5, j7, j9 = get_spec("jacobi5"), get_spec("jacobi7"), get_spec("jacobi9")
    err = {}
    err["tiled_march"] = max(
        [compare_launch(tiled, make_tiled_plan, j7, s, k, rng, device)
         for s in (MAIN_SIZE, RAGGED_SIZE) for k in (1, 2, 8)]
        + [compare_launch(tiled, make_tiled_plan, get_spec(n), BOX_SIZE, 4,
                          rng, device)
           for n in ("jacobi27", "laplace3d_ho")]
        + [compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng,
                           device)])
    err["tiled_march+source"] = max(
        compare_launch(tiled, make_tiled_plan, j7, MAIN_SIZE, 8, rng, device,
                       scale=-0.01),
        compare_launch(tiled, make_tiled_plan, j7, RAGGED_SIZE, 3, rng,
                       device, scale=-0.01),
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        scale=-0.01))
    err["slab_sweep"] = max(
        compare_launch(slab, window_slab, j5, CFG1[1], 1, rng, device),
        compare_launch(slab, window_slab, j5, CFG1[1], CFG1[2], rng,
                       device),
        compare_launch(slab, window_slab, j9, CFG2[1], CFG2[2], rng,
                       device, t0=CFG2[3]),
        compare_launch(slab, window_slab, get_spec("star2d_r2"),
                       RAGGED_2D, 3, rng, device),
        compare_iterate(SlabStencil, j5, RAGGED_2D, 4, 11, rng, device))
    err["slab_sweep+source"] = max(
        compare_launch(slab, window_slab, j5, SLAB_SOURCE_SIZE, 4, rng,
                       device, scale=-0.01),
        compare_iterate(SlabStencil, j9, RAGGED_2D, 4, 11, rng, device,
                        scale=-0.01))
    # the Poisson main paths' own shapes, k, tiles and sources: the
    # manufactured solves and the golden checks of phase 4
    poisson_f = {}
    for shape, kernel, make_plan, mode in (
            (POISSON_2D, slab, make_slab_plan, "slab_sweep+source"),
            (POISSON_3D, tiled, make_tiled_plan, "tiled_march+source"),
            (POISSON_BIG_2D, slab, make_slab_plan, "slab_sweep+source"),
            (POISSON_BIG, tiled, make_tiled_plan, "tiled_march+source")):
        prob = PoissonProblem(shape=shape, device=DEVICE)
        f = manufactured_sine(shape)[0] if shape in (POISSON_2D, POISSON_3D) \
            else rng.normal(size=shape) / prob.h ** 2
        if kernel is slab:  # the row of the schedule the plan gives
            mode = slab_row(make_slab_plan(prob.spec, shape, "float32",
                                           8).schedule, "+source")
        err[mode] = max(err.get(mode, 0.0), compare_poisson(
            prob, f, kernel, make_plan, rng, device))
    def fold(found):
        for m, d in found.items():
            err[m] = max(err.get(m, 0.0), d)

    # the Chebyshev and dual modes, each launch on the march and on the
    # window, bitwise its plain version and the other: k = 2 .. 5 at 255^3
    # and ragged (the smoother nu = 2, 4 and the fused launch of nu1 = 2,
    # 4), and a remainder run
    for shape in (MG_SIZE, RAGGED_SIZE):
        for nu in (2, 4):
            fold(compare_cheby(tiled, shape, nu, "chebyshev", False, rng,
                               device))
        for smoother, nu in (("wjacobi", 2), ("chebyshev", 4)):
            fold(compare_cheby(tiled, shape, nu, smoother, True, rng,
                               device))
    fold(compare_cheby_iterate(RAGGED_SIZE, 4, 11, rng, device))
    # each fine-level operation of the solver paths of phase 4 at the
    # path's own plan and right-hand side (PCG's cycle sees the CG residual
    # there, for which a random field stands in), u random, zero walls;
    # the Chebyshev and dual ones on both schedules
    from stencil_tpu_torch.ops.layout import pad_source

    solve_paths = {}
    for name, args, _ in SOLVE_PATHS:
        prob, f, mg, ops = solve_path(args)
        solve_paths[name] = (prob, f, mg, ops)
        rhs = rng.normal(size=prob.shape) if name == "pcg-cheby" else f
        grid = prob.initial_grid(rng.random(prob.shape, dtype=np.float32))
        for mode, op in ops:
            src = pad_source(op.plan, rhs, op.source_scale,
                             prob.bc).to(device)
            fold(compare_plan(
                tiled, op.plan, grid, src, mode,
                f"on the {name} path {prob.shape} {op.plan.spec.name} "
                f"k={op.plan.sweeps_per_call}"
                + ("" if op.plan.cheby_coeffs
                   else f" tiles {op.plan.tiles}")))

    # the two-level mode on the march, each launch bitwise its plain
    # version and the window's launch on both outputs: cfg9's plan (256^3
    # k=8), k=1, ragged k=3 and k=8 (the pins and bf16 below), and through
    # the wave runner with a remainder
    for shape, k in ((MAIN_SIZE, WAVE_K), (MAIN_SIZE, 1), (RAGGED_SIZE, 3),
                     (RAGGED_SIZE, WAVE_K)):
        fold(compare_two_level(tiled, shape, k, rng, device))
    fold({"tiled_march+two_level": compare_wave_iterate(RAGGED_SIZE, 4, 11,
                                                        rng, device)})
    # the coefficient mode on the march, its weights from the weights
    # kernel, each case also against the window's launch from a(x):
    # cfg16's marching plan and ragged at k=3, with periodic 0 1, neumann
    # 1 and periodic 0 + neumann 1; the k=1 matvec of cfg18 (its scales,
    # a random ghost ring) at 255^3 and at every OperatorMultigrid level
    # below it, the level's own weights (operator_data) equal to the
    # kernel's
    from stencil_tpu_torch.multigrid import OperatorMultigrid
    from stencil_tpu_torch.ops.tiled import pad_coeff

    per01, neu01 = walls(3, (0, 1)), walls(3, (), (0, 1))
    mixed, neu1 = walls(3, (0,), (1,)), walls(3, (), (1,))
    for shape, k, bc in ((MAIN_SIZE, 8, None), (RAGGED_SIZE, 3, None),
                         (MAIN_SIZE, 8, per01), (RAGGED_SIZE, 3, neu1),
                         (RAGGED_SIZE, 3, mixed)):
        plan, cur, a = marching_inputs(shape, k, rng, device, bc)
        fold(compare_coeff(tiled, plan, cur, a, f"FTCS {shape} two_material"
                           f" contrast {CONTRAST:g}", bc)[0])
    for level, lp in enumerate(OperatorMultigrid(
            hetero_problem("pallas"))._probs):
        lplan = lp._kernel_plan()
        found, w = compare_coeff(
            tiled, lplan, random_ring(lp.shape, rng, device),
            pad_coeff(lplan, lp.a, lp.bc).to(device),
            f"cfg18 matvec, OperatorMultigrid level {level} {lp.shape}, "
            f"random ghost ring,")
        fold(found)
        require(torch.equal(lp.operator_data()[1], w),
                f"level {level}: operator_data's weights differ")
    # the pins: every mode on a dynamic-wall path, one launch on a refreshed
    # random grid at the main paths' plans (periodic, Neumann, mixed,
    # ragged, radius 2, --periodic all at k=1), and the runners over a
    # remainder against the eager iterate (the coefficient mode's above)
    per_all = walls(3, (0, 1, 2))
    per0_2d, neu0_2d = walls(2, (0,)), walls(2, (), (0,))

    def pins_case(kernel, plan, bc, mode, **kw):
        return compare_pins(kernel, plan, bc, pins_input(plan, bc, rng,
                                                         device), mode, **kw)

    mode = "tiled_march+pins"
    plan8 = make_tiled_plan(j7, MAIN_SIZE, "float32", 8)
    err[mode] = max(
        [pins_case(tiled, plan8, bc, mode) for bc in (per01, neu01, mixed)]
        + [pins_case(tiled, make_tiled_plan(j7, RAGGED_SIZE, "float32", 3),
                     per01, mode),
           pins_case(tiled, make_tiled_plan(get_spec("laplace3d_ho"),
                                            BOX_SIZE, "float32", 4),
                     per01, mode),
           pins_case(tiled, make_tiled_plan(j7, MAIN_SIZE, "float32", 1),
                     per_all, mode),
           compare_stream_chunks(tiled, rng, device)])
    # the runner against the eager iterate with a Neumann face at k=3: a
    # live Neumann ghost sums its mirrored taps in another order, so the
    # two agree to fp32 rounding; filed apart from the kernel's row, whose
    # every case is kernel against plain
    runner_err = {"TiledStencil vs eager, periodic 0, neumann 1": (
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        bc=mixed))}
    mode = "tiled_march+source+pins"
    pprob = PoissonProblem(shape=POISSON_BIG, bc=mixed, device=DEVICE)
    pplan = make_tiled_plan(pprob.spec, POISSON_BIG, "float32", 8)
    ragged3 = make_tiled_plan(j7, RAGGED_SIZE, "float32", 3)
    err[mode] = max(
        pins_case(tiled, pplan, mixed, mode, src=pad_source(
            pplan, rng.normal(size=POISSON_BIG) / pprob.h ** 2,
            pprob.source_scale, mixed).to(device)),
        pins_case(tiled, ragged3, per01, mode, src=pad_source(
            ragged3, rng.normal(size=RAGGED_SIZE), -0.01, per01).to(device)),
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        scale=-0.01, bc=per01))
    fold(compare_two_level(tiled, MAIN_SIZE, WAVE_K, rng, device, mixed))
    fold(compare_two_level(tiled, RAGGED_SIZE, 3, rng, device, mixed))
    fold(compare_two_level(tiled, RAGGED_SIZE, 1, rng, device, per01))
    fold({"tiled_march+two_level+pins": compare_wave_iterate(
        RAGGED_SIZE, 4, 11, rng, device, bc=per01)})
    mode = "slab_sweep+pins"
    s16 = window_slab(j5, CFG1[1], "float32", CFG1[2])
    err[mode] = max(
        pins_case(slab, s16, per0_2d, mode),
        pins_case(slab, s16, neu0_2d, mode),
        pins_case(slab, window_slab(j9, CFG2[1], "float32", CFG2[2],
                                       t0_fixed=CFG2[3]), per0_2d, mode),
        pins_case(slab, window_slab(get_spec("star2d_r2"), RAGGED_2D,
                                       "float32", 3), neu0_2d, mode),
        pins_case(slab, window_slab(j5, CFG1[1], "float32", 1),
                  walls(2, (0, 1)), mode),
        compare_iterate(SlabStencil, j5, RAGGED_2D, 4, 11, rng, device,
                        bc=per0_2d))
    mode = "slab_sweep+source+pins"
    pprob2 = PoissonProblem(shape=POISSON_BIG_2D, bc=per0_2d, device=DEVICE)
    splan = window_slab(pprob2.spec, POISSON_BIG_2D, "float32", 8)
    err[mode] = max(
        pins_case(slab, splan, per0_2d, mode, src=pad_source(
            splan, rng.normal(size=POISSON_BIG_2D) / pprob2.h ** 2,
            pprob2.source_scale, per0_2d).to(device)),
        compare_iterate(SlabStencil, j9, RAGGED_2D, 4, 11, rng, device,
                        scale=-0.01, bc=per0_2d))
    # bf16: every mode but the coefficient one, bitwise, at the plans of
    # the bf16 main paths of phase 4 (cfg3, cfg4's full shape, cfg1, cfg2,
    # the Poisson runners, the wave, the multigrid levels), ragged, radius
    # 2, on inputs near 0, and the runners over a remainder
    t_bf16 = time.perf_counter()
    bf = "bfloat16"
    lap = get_spec("laplace3d_ho")
    plan8b = make_tiled_plan(j7, MAIN_SIZE, bf, CFG3[2])
    ragged3b = make_tiled_plan(j7, RAGGED_SIZE, bf, 3)
    s16b = window_slab(j5, CFG1[1], bf, CFG1[2])
    mode = "tiled_march+bf16"
    err[mode] = max(
        compare_bf16(tiled, plan8b, mode, rng, device),
        compare_bf16(tiled, ragged3b, mode, rng, device),
        compare_bf16(tiled, ragged3b, mode, rng, device, tiny=True),
        compare_bf16(tiled, make_tiled_plan(get_spec("jacobi27"), BOX_SIZE,
                                            bf, 4), mode, rng, device),
        compare_bf16(tiled, make_tiled_plan(lap, CFG4[1], bf, CFG4[2]), mode,
                     rng, device),
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        dtype=bf))
    mode = "tiled_march+source+bf16"
    err[mode] = max(
        compare_poisson(PoissonProblem(shape=POISSON_BIG, dtype=bf,
                                       device=DEVICE),
                        rng.normal(size=POISSON_BIG) * (POISSON_BIG[0] + 1)
                        ** 2, tiled, make_tiled_plan, rng, device),
        compare_bf16(tiled, ragged3b, mode, rng, device, tiny=True,
                     src_scale=-0.01),
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        scale=-0.01, dtype=bf))
    for dual, cases in ((False, (("chebyshev", 2), ("chebyshev", 4))),
                        (True, (("wjacobi", 2), ("chebyshev", 4)))):
        for shape in (MG_SIZE, RAGGED_SIZE, BF16_MG_SIZE):
            for smoother, nu in cases:
                fold(compare_cheby(tiled, shape, nu, smoother, dual, rng,
                                   device, bf))
    fold(compare_two_level(tiled, MAIN_SIZE, WAVE_K, rng, device, dtype=bf))
    fold(compare_two_level(tiled, RAGGED_SIZE, 3, rng, device, dtype=bf,
                           tiny=True))
    fold(compare_two_level(tiled, RAGGED_SIZE, 1, rng, device, dtype=bf))
    fold({"tiled_march+two_level+bf16": compare_wave_iterate(
        RAGGED_SIZE, 4, 11, rng, device, dtype=bf)})
    mode = "tiled_march+pins+bf16"
    err[mode] = max(
        compare_bf16(tiled, plan8b, mode, rng, device, per01),
        compare_bf16(tiled, plan8b, mode, rng, device, neu01),
        compare_bf16(tiled, ragged3b, mode, rng, device, mixed, tiny=True),
        compare_bf16(tiled, make_tiled_plan(lap, BOX_SIZE, bf, 4), mode, rng,
                     device, per01),
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        bc=per01, dtype=bf))
    mode = "tiled_march+source+pins+bf16"
    pplanb = make_tiled_plan(pprob.spec, POISSON_BIG, bf, 8)
    err[mode] = max(
        compare_bf16(tiled, pplanb, mode, rng, device, mixed,
                     src_scale=pprob.source_scale,
                     f=rng.normal(size=POISSON_BIG) / pprob.h ** 2),
        compare_bf16(tiled, ragged3b, mode, rng, device, per01, tiny=True,
                     src_scale=-0.01),
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        scale=-0.01, bc=per01, dtype=bf))
    fold(compare_two_level(tiled, MAIN_SIZE, WAVE_K, rng, device, mixed,
                           bf))
    fold(compare_two_level(tiled, RAGGED_SIZE, 3, rng, device, mixed, bf,
                           tiny=True))
    fold(compare_two_level(tiled, RAGGED_SIZE, WAVE_K, rng, device, mixed,
                           bf))
    fold({"tiled_march+two_level+pins+bf16": compare_wave_iterate(
        RAGGED_SIZE, 4, 11, rng, device, bc=per01, dtype=bf)})
    mode = "slab_sweep+bf16"
    err[mode] = max(
        compare_bf16(slab, s16b, mode, rng, device),
        compare_bf16(slab, window_slab(j9, CFG2[1], bf, CFG2[2],
                                          t0_fixed=CFG2[3]), mode, rng,
                     device),
        compare_bf16(slab, window_slab(get_spec("star2d_r2"), RAGGED_2D,
                                          bf, 3), mode, rng, device,
                     tiny=True),
        compare_iterate(SlabStencil, j5, RAGGED_2D, 4, 11, rng, device,
                        dtype=bf))
    mode = "slab_sweep+source+bf16"
    err[mode] = max(
        compare_poisson(PoissonProblem(shape=POISSON_BIG_2D, dtype=bf,
                                       device=DEVICE),
                        rng.normal(size=POISSON_BIG_2D)
                        * (POISSON_BIG_2D[0] + 1) ** 2, slab,
                        make_slab_plan, rng, device),
        compare_iterate(SlabStencil, j9, RAGGED_2D, 4, 11, rng, device,
                        scale=-0.01, dtype=bf))
    mode = "slab_sweep+pins+bf16"
    err[mode] = max(
        compare_bf16(slab, s16b, mode, rng, device, per0_2d),
        compare_bf16(slab, s16b, mode, rng, device, neu0_2d, tiny=True),
        compare_iterate(SlabStencil, j5, RAGGED_2D, 4, 11, rng, device,
                        bc=per0_2d, dtype=bf))
    # the 2D march (csrc/slab_march.cu): every mode against its plain
    # version and the window's launch, bitwise, at cfg1, cfg2 (-b 256), the
    # ragged star2d_r2 and the Poisson shapes, on Dirichlet, periodic and
    # Neumann d0 faces, in both dtypes
    t_march2d = time.perf_counter()
    sr2 = get_spec("star2d_r2")
    for dtype in ("float32", bf):
        for bc in (walls(2), per0_2d, neu0_2d):
            cases2d = [
                (j5, CFG1[1], CFG1[2], None, None),
                (j9, CFG2[1], CFG2[2], CFG2[3], None),
                (sr2, RAGGED_2D, 3, None, None),
                (pprob2.spec, POISSON_2D, 8, None, -0.25),
                (pprob2.spec, POISSON_BIG_2D, 8, None, pprob2.source_scale)]
            for spec, shape, k, t0, scale in cases2d:
                f = None
                if scale is not None and shape == POISSON_BIG_2D:
                    f = rng.normal(size=shape) / pprob2.h ** 2
                for m, e in compare_slab_march(slab, spec, shape, k, dtype,
                                               bc, rng, device, t0, scale,
                                               f).items():
                    err[m] = max(err.get(m, 0.0), e)
    err["slab_march"] = max(err["slab_march"], compare_iterate(
        SlabStencil, j5, RAGGED_2D, 4, 11, rng, device, schedule="march"))
    print(f"the 2D march's cases: {time.perf_counter() - t_march2d:.1f} s")
    # B1f: the interior and edge subsets of every mode that takes one, with
    # live faces where a mesh rank has neighbours, at the local blocks of
    # the sharded paths: the phase-4 CLI's and Poisson runner's (256^3 over
    # (2, 2), in fp32 and bf16), phase 5's (1024^3 over (2, 2)), ragged and
    # radius 2, and the remainder launch's depth
    from stencil_tpu_torch.parallel.sharded_kernel import (
        ShardedKernelStencil,
    )

    t_sub = time.perf_counter()
    local = tuple(n // m for n, m in zip(MAIN_SIZE, SHARDED_MESH + (1,)))
    star2 = get_spec("star3d_r2")

    def subset_case(mode, plan, pins=MESH_PINS, bc=None, scale=None, **kw):
        cur = (bf16_input(plan, bc or walls(3), rng, device)
               if plan.dtype == "bfloat16" else
               pins_input(plan, bc or walls(3), rng, device))
        src = None if scale is None else pad_source(
            plan, rng.normal(size=plan.interior_shape), scale,
            bc or walls(3)).to(device)
        return compare_subset(tiled, plan, cur, pins, mode, src, **kw)

    mode = "tiled_march+subset"
    sub8 = make_tiled_plan(j7, local, "float32", 8)
    err[mode] = max(
        subset_case(mode, sub8), subset_case(mode, sub8.with_sweeps(3)),
        subset_case(mode, ShardedKernelStencil(
            j7, SHARDED_SIZE, axis_names=("x", "y"),
            sweeps_per_call=SHARDED_K).local_plan(SHARDED_MESH)),
        subset_case(mode, make_tiled_plan(star2, RAGGED_SIZE, "float32", 2,
                                          tiles=(8, 8, 16)), (0, 0, 0, 0),
                    per01),
        subset_case(mode, make_tiled_plan(get_spec("jacobi27"), local,
                                          "float32", 4)))
    mode = "tiled_march+source+subset"
    psub = make_tiled_plan(pprob.spec, local, "float32", 8, has_source=True)
    err[mode] = max(
        subset_case(mode, psub, (0, 0, 0, 0), mixed,
                    pprob.source_scale * 100),
        subset_case(mode, psub.with_sweeps(3), (0, 0, 0, 0), mixed, -0.01),
        subset_case(mode, make_tiled_plan(j7, RAGGED_SIZE, "float32", 3,
                                          tiles=(8, 8, 16)), MESH_PINS,
                    scale=-0.01))
    mode = "tiled_march+subset+bf16"
    err[mode] = max(
        subset_case(mode, make_tiled_plan(j7, local, bf, 8)),
        subset_case(mode, make_tiled_plan(j7, local, bf, 8).with_sweeps(3)),
        subset_case(mode, make_tiled_plan(star2, RAGGED_SIZE, bf, 2,
                                          tiles=(8, 8, 16)), (0, 0, 0, 0),
                    per01))
    mode = "tiled_march+source+subset+bf16"
    err[mode] = max(
        subset_case(mode, make_tiled_plan(pprob.spec, local, bf, 8,
                                          has_source=True), (0, 0, 0, 0),
                    mixed, pprob.source_scale * 100),
        subset_case(mode, make_tiled_plan(j7, RAGGED_SIZE, bf, 3,
                                          tiles=(8, 8, 16)), MESH_PINS,
                    scale=-0.01))
    # the modes no sharded path runs take a subset too (every face pinned
    # in the Chebyshev modes); the coefficient mode on the march through
    # its weights and on the window from a(x)
    from stencil_tpu_torch.ops.tiled_kernel import coeff_weights

    cheby = ((0.1, 0.2, -0.05, 0.3), (0.2, 0.1, 0.4, -0.2),
             (0.3, 0.15, 0.05, 0.1))
    cheby_tiles = tuple(min(t, n) for t, n in zip((8, 8, 32), local))
    for dual, dtype, sched in itertools.product(
            (False, True), ("float32", bf), ("march", "window")):
        plan = cheby_plan(local, cheby, dual, dtype, sched, cheby_tiles)
        mode = cheby_row(plan).replace("+bf16", "") + "+subset" + (
            "+bf16" if dtype == bf else "")
        fold({mode: subset_case(mode, plan, (1, 1, 1, 1), scale=1.0,
                                dual=dual)})
    cplan = make_tiled_plan(j7, local, "float32", 8,
                            coeff_scales=(0.1, 1.0, -0.1))
    ca = pad_coeff(cplan, rng.random(local) + 0.5, walls(3)).to(device)
    err["tiled_march+coeff+subset"] = subset_case(
        "tiled_march+coeff+subset", cplan, coeff=coeff_weights(ca, cplan))
    err["tiled_sweep+coeff+subset"] = subset_case(
        "tiled_sweep+coeff+subset", window_twin(cplan), coeff=ca)
    # the march (csrc/tiled_march.cu): jacobi7, jacobi27 and star3d_r2 in
    # fp32 and bf16 at k = 1, 2, 3, 8 on the ragged shape, then with
    # --periodic 0 1, --neumann 0 1 and the source mode, each launch
    # bitwise its plain version and the window schedule's launch (whose
    # errors file under the window's modes); the subset cases above ran on
    # march plans, and the window's subsets run here
    t_march = time.perf_counter()
    j27 = get_spec("jacobi27")
    for spec in (j7, j27, star2):
        for dtype in ("float32", bf):
            for k in (1, 2, 3, 8):
                fold(compare_march(tiled, spec, RAGGED_SIZE, k, dtype,
                                   walls(3), False, rng, device))
    for spec, k in ((j7, 3), (j7, 8), (j27, 2), (star2, 2)):
        for dtype in ("float32", bf):
            for bc, source in ((per01, False), (neu01, False),
                               (walls(3), True), (mixed, True)):
                fold(compare_march(tiled, spec, RAGGED_SIZE, k, dtype, bc,
                                   source, rng, device))
    wsub = functools.partial(make_tiled_plan, schedule="window")
    for mode, plan, pins, bc, scale in (
            ("tiled_sweep+subset", wsub(j7, local, "float32", 8), MESH_PINS,
             None, None),
            ("tiled_sweep+source+subset", wsub(pprob.spec, local, "float32",
                                               8, has_source=True),
             (0, 0, 0, 0), mixed, pprob.source_scale * 100),
            ("tiled_sweep+subset+bf16", wsub(j7, local, bf, 8), MESH_PINS,
             None, None)):
        err[mode] = subset_case(mode, plan, pins, bc, scale)
    stamp(f"the march cases ({time.perf_counter() - t_march:.1f} s)")
    # B3: every rank's buffers after one launch (and a remainder)
    t_rma = time.perf_counter()
    err.update(compare_rma(rma_module.rma_iterate, rng))
    stamp(f"the rma cases ({time.perf_counter() - t_rma:.1f} s)")
    print(f"PHASE 3 kernel vs plain: ok at "
          f"{time.perf_counter() - t_start:.1f} s (the bf16 cases "
          f"{t_sub - t_bf16:.1f} s, the subset cases "
          f"{time.perf_counter() - t_sub:.1f} s; max abs diff per mode "
          f"{ {k: float(f'{v:.3e}') for k, v in err.items()} }; runners "
          f"against the eager iterate "
          f"{ {k: float(f'{v:.3e}') for k, v in runner_err.items()} })")

    # 4. main paths, launch counts set to 0 just before each
    from stencil_tpu_torch import cli

    cli.MIN_SIGNAL_SECONDS["cuda"] = BENCH_SIGNAL_S

    launches = {}
    rec3d, launches["tiled_march"] = run_cli(
        cli, ["-s", *map(str, MAIN_SIZE), "--spec", "jacobi7", "-m",
              "pallas_temporal", "-k", "8", "-i", str(MAIN_ITERS)],
        tiled, label, "march_launches")
    require(tiled.source_launches == 0, "3D main path ran the source mode")
    require(rec3d["plan"]["schedule"] == "march",
            f"3D main path plan {rec3d['plan']}")
    # the 2D paths: each on the schedule its plan gives, through the CLI
    # (the rows slab_sweep* and slab_march* count the launches of each)
    launches.update({slab_row(sc, sfx): 0 for sc in ("march", "window")
                     for sfx in ("", "+source", "+pins", "+source+pins",
                                 "+bf16", "+source+bf16", "+pins+bf16")})
    for spec_name, size, k, block, iters in (CFG1, CFG2):
        args = ["-s", *map(str, size), "--spec", spec_name, "-m",
                "pallas_temporal", "-k", str(k), "-i", str(iters)]
        if block is not None:
            args += ["-b", str(block)]
        rec, n = run_cli(cli, args, slab, label)
        require(rec["plan"]["kernel"] == "slab", f"{args} ran {rec['plan']}")
        spec = get_spec(spec_name)
        sched = slab_schedule(rec["plan"], spec, size, "float32", k, block)
        launches[slab_row(sched)] += n
    # each source mode: a manufactured solve and a golden check, at the
    # shapes phase 3 held the kernel at
    poisson_big = {}
    for mode, kernel, small, big in (
            ("slab_sweep+source", slab, POISSON_2D, POISSON_BIG_2D),
            ("tiled_march+source", tiled, POISSON_3D, POISSON_BIG)):
        count = ("march_source_launches" if kernel is tiled
                 else "source_launches")
        n_solve = poisson_solve(small, kernel, device, count)
        n_solve_march = kernel.march_launches
        poisson_big[mode] = poisson_golden(big, kernel, rng, count=count)
        if kernel is tiled:
            launches[mode] = n_solve + poisson_big[mode][3]
            continue
        runner, prob, f, n_big = poisson_big[mode]
        small_sched = make_slab_plan(prob.spec, small, "float32",
                                     runner.plan_info["k"]).schedule
        big_sched = slab_schedule(runner.plan_info, prob.spec, big,
                                  "float32", runner.plan_info["k"])
        require((n_solve_march == n_solve) == (small_sched == "march"),
                f"Poisson {small}: {n_solve_march} march launches of "
                f"{n_solve}, the plan gives the {small_sched}")
        launches[slab_row(small_sched, "+source")] += n_solve
        launches[slab_row(big_sched, "+source")] += n_big
    # the solver paths: PCG (Chebyshev and dual modes, cfg13's), multigrid
    # V(4,4) (source and dual modes, cfg10's), FMG on the tiled fine level,
    # and cfg17's Chebyshev V(4,4) cycles; each fine-level launch on the
    # schedule its plan gives (the row of that schedule), every mode of
    # the path launched
    solve_counts = {name: run_solve_cli(cli, tiled, name, args, bar,
                                        label)[1]
                    for name, args, bar in SOLVE_PATHS}
    solve_counts["cfg17"] = run_cfg17(tiled, label)
    for name, (prob, _, mg, ops) in solve_paths.items():
        for mode, op in ops:
            require(solve_counts[name][mode] > 0,
                    f"solver path {name} launched no {mode}")
    for counts in solve_counts.values():
        for mode, n in counts.items():
            launches[mode] = launches.get(mode, 0) + n
    # the wave main path (two-level mode), -m varcoeff and --solve hetero
    # (the coefficient mode on the march, and the weights kernel)
    launches["tiled_march+two_level"] = run_wave(tiled, rng, label)
    coeff_runs = [run_varcoeff_cli(cli, tiled, label),
                  run_hetero_cli(cli, tiled, label)]
    launches["tiled_march+coeff"] = sum(n for n, _ in coeff_runs)
    launches["coeff_weights"] = sum(w for _, w in coeff_runs)
    # the dynamic-wall paths: every launch of each run must be a pins
    # launch of its mode (no eager or plain fallback)
    main3d = ["-s", *map(str, MAIN_SIZE), "--spec", "jacobi7", "-i",
              str(MAIN_ITERS)]
    launches["tiled_march+pins"] = sum(
        run_cli(cli, main3d + extra, tiled, label, "march_pins_launches")[1]
        for extra in (["-m", "pallas_temporal", "-k", "8", "--periodic",
                       "0", "1"],
                      ["-m", "pallas", "-k", "1", "--periodic", "all"]))
    launches["tiled_march+pins"] += run_advection(tiled, rng, label,
                                                  "march_pins_launches")
    spec_name, size, k, _, iters = CFG1
    rec, n = run_cli(
        cli, ["-s", *map(str, size), "--spec", spec_name, "-m",
              "pallas_temporal", "-k", str(k), "-i", str(iters), "--periodic",
              "0"], slab, label, "pins_launches")
    sched = slab_schedule(rec["plan"], j5, size, "float32", k)
    launches[slab_row(sched, "+pins")] += n
    for mode, kernel, shape, bc, count in (
            ("tiled_march+source+pins", tiled, POISSON_BIG, mixed,
             "march_source_pins_launches"),
            ("slab_sweep+source+pins", slab, POISSON_BIG_2D, per0_2d,
             "source_pins_launches")):
        poisson_big[mode] = poisson_golden(shape, kernel, rng, bc, count)
        if kernel is tiled:
            launches[mode] = poisson_big[mode][3]
            continue
        runner, prob, f, n = poisson_big[mode]
        sched = slab_schedule(runner.plan_info, prob.spec, shape, "float32",
                              runner.plan_info["k"])
        launches[slab_row(sched, "+source+pins")] += n
    launches["tiled_march+two_level+pins"] = run_wave_pins(tiled, rng, label)
    launches["tiled_march+coeff+pins"], weights = run_varcoeff_cli(
        cli, tiled, label, ("--periodic", "0", "1"),
        "march_coeff_pins_launches")
    launches["coeff_weights"] += weights
    # the bf16 main paths, each -c at the bf16 bar and every launch a bf16
    # one: cfg3 and cfg4-bf16 through the CLI (fewer iterations than the
    # fp32 path, see BF16_TOL), cfg1 in bf16, the Poisson runners (cfg8 in
    # bf16, 4096^2), the multigrid fine level, the wave, and the
    # dynamic-wall paths
    t_bf16 = time.perf_counter()
    bf_runs = {}
    for name, (spec_name, size, k, iters) in (("cfg3", CFG3),
                                              ("cfg4-bf16", CFG4)):
        bf_runs[name] = run_cli_bf16(
            cli, ["-s", *map(str, size), "--spec", spec_name, "-m",
                  "pallas_temporal", "-k", str(k), "-i", str(iters)],
            tiled, label, "march_bf16_launches")
    launches["tiled_march+bf16"] = sum(n for _, n in bf_runs.values())
    cfg1_bf16 = ["-s", *map(str, CFG1[1]), "--spec", CFG1[0], "-m",
                 "pallas_temporal", "-k", str(CFG1[2]), "-i",
                 str(CFG1_BF16_ITERS)]
    rec, n = run_cli_bf16(cli, cfg1_bf16, slab, label)
    sched = slab_schedule(rec["plan"], j5, CFG1[1], bf, CFG1[2])
    launches[slab_row(sched, "+bf16")] += n
    for mode, kernel, shape, bc, count in (
            ("tiled_march+source+bf16", tiled, POISSON_BIG, None,
             "march_source_launches"),
            ("slab_sweep+source+bf16", slab, POISSON_BIG_2D, None,
             "source_launches"),
            ("tiled_march+source+pins+bf16", tiled, POISSON_BIG, mixed,
             "march_source_pins_launches")):
        poisson_big[mode] = poisson_golden(shape, kernel, rng, bc, count,
                                           dtype="bfloat16")
        if kernel is tiled:
            launches[mode] = poisson_big[mode][3]
            continue
        runner, prob, f, n = poisson_big[mode]
        sched = slab_schedule(runner.plan_info, prob.spec, shape, bf,
                              runner.plan_info["k"])
        launches[slab_row(sched, "+source+bf16")] += n
    launches.update(run_mg_bf16(tiled, label))
    launches["tiled_march+two_level+bf16"] = run_wave_bf16(tiled, rng, label)
    launches["tiled_march+two_level+pins+bf16"] = run_wave_bf16(
        tiled, rng, label, mixed)
    launches["tiled_march+pins+bf16"] = run_cli_bf16(
        cli, ["-s", *map(str, CFG3[1]), "--spec", CFG3[0], "-m",
              "pallas_temporal", "-k", str(CFG3[2]), "-i", str(CFG3[3]),
              "--periodic", "0", "1"], tiled, label,
        "march_pins_launches")[1]
    rec, n = run_cli_bf16(cli, [*cfg1_bf16, "--periodic", "0"], slab,
                          label, "pins_launches")
    sched = slab_schedule(rec["plan"], j5, CFG1[1], bf, CFG1[2])
    launches[slab_row(sched, "+pins+bf16")] += n
    # the sharded paths on a (2, 2) mesh whose four ranks share the card:
    # sharded_pallas through the CLI in fp32 and bf16 (every launch an
    # interior or edge subset launch), the eager sharded method, the sharded
    # Poisson runner against the single-device one, 2D over d0 on slab
    t_sharded = time.perf_counter()
    sharded3d = ["-s", *map(str, MAIN_SIZE), "--spec", "jacobi7", "-m",
                 "sharded_pallas", "--mesh", *map(str, SHARDED_MESH), "-k",
                 "8"]
    rec, launches["tiled_march+subset"] = run_cli(
        cli, [*sharded3d, "-i", str(MAIN_ITERS)], tiled, label,
        "march_subset_launches")
    require(rec["plan"]["split"], f"sharded_pallas did not split: "
            f"{rec['plan']}")
    launches["tiled_march+subset+bf16"] = run_cli_bf16(
        cli, [*sharded3d, "-i", str(CFG3[3])], tiled, label,
        "march_subset_launches")[1]
    run_sharded_eager_cli(cli, label)
    launches["tiled_march+source+subset"] = run_sharded_poisson(
        tiled, rng, label, "float32")
    launches["tiled_march+source+subset+bf16"] = run_sharded_poisson(
        tiled, rng, label, "bfloat16")
    run_sharded_2d(slab, label)
    # B3: the bench cell through the CLI on (1,) and (2, 2), on dynamic
    # walls and in bf16
    t_rma = time.perf_counter()
    launches.update(run_rma_paths(cli, rma_module.rma_iterate, label))
    # the out-of-core paths (every chunk a march launch, with a live face
    # where it has one), the checkpointed runs, --dump-image and
    # --profile, and cfg14/cfg15 (eager, no hand-written kernel)
    t_stream = time.perf_counter()
    plain_n, pins_n = run_streamed_paths(tiled, label)
    launches["tiled_march"] += plain_n
    launches["tiled_march+pins"] += pins_n
    launches["tiled_march"] += run_checkpoint_paths(cli, tiled, label)
    t_advdiff = time.perf_counter()
    advdiff = run_advdiff_cells(label)
    print(f"PHASE 4 main paths: ok at {time.perf_counter() - t_start:.1f} s "
          f"(the bf16 paths {t_sharded - t_bf16:.1f} s, the sharded paths "
          f"{t_rma - t_sharded:.1f} s, the rma paths "
          f"{t_stream - t_rma:.1f} s, the streamed and checkpointed paths "
          f"{t_advdiff - t_stream:.1f} s, cfg14/cfg15 "
          f"{time.perf_counter() - t_advdiff:.1f} s; launches {launches})")

    # 5. times
    from stencil_tpu_torch import registry
    from stencil_tpu_torch.config import RunConfig
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.utils import roofline

    hbm = roofline.measure_hbm_bandwidth(device)
    print(f"measured HBM bandwidth: {hbm:.1f} GB/s [{label}]")
    # 3D jacobi7 at 256^3 on both schedules at k = 1, 2, 4, 8: the k=1
    # pair decides which schedule serves k=1 (the ops/tiled.py docstring)
    glups = {}
    for k in SCHEDULE_DEPTHS:
        for schedule in ("march", "window"):
            st = TiledStencil(j7, MAIN_SIZE, sweeps_per_call=k,
                              device=DEVICE, schedule=schedule)
            grid = cli.make_grid(RunConfig(size=MAIN_SIZE, spec="jacobi7",
                                           device=DEVICE), j7)
            glups[(k, schedule)] = bench(
                registry.Runner(name=f"tiled_{schedule}", granularity=k,
                                iterate=st.iterate), grid,
                int(np.prod(MAIN_SIZE)), device, hbm, label,
                f"jacobi7 {MAIN_SIZE} {schedule} k={k} tiles "
                f"{st.plan.tiles}")
    faster = max(("march", "window"), key=lambda sc: glups[(1, sc)])
    served = make_tiled_plan(j7, MAIN_SIZE, "float32", 1).schedule
    print(f"k=1 at {MAIN_SIZE}: march {glups[(1, 'march')]:.2f} GLUPS, "
          f"window {glups[(1, 'window')]:.2f}: the {faster} is faster in "
          f"this run; the plan rule serves k=1 by the {served} [{label}]")
    for spec, size, methods in (
            (j7, MAIN_SIZE, (("eager", 1, None),)),
            (j5, CFG1[1], (("slab", CFG1[2], CFG1[3]), ("eager", 1, None))),
            (j9, CFG2[1], (("slab", CFG2[2], CFG2[3]), ("eager", 1, None)))):
        for method, k, block in methods:
            cfg = RunConfig(size=size, spec=spec.name, temporal=k,
                            block=block, methods=(method,), device=DEVICE)
            grid = cli.make_grid(cfg, spec)
            runner = registry.get_runner(method, cfg, spec, grid)
            bench(runner, grid, int(np.prod(size)), device, hbm, label,
                  f"{spec.name} {size} {runner.name} "
                  f"{runner.plan_info.get('schedule', '')}")
    # cfg1 and cfg2 on the schedule their plans do not give
    for spec, (_, size, k, block, _) in ((j5, CFG1), (j9, CFG2)):
        other = other_schedule(make_slab_plan(spec, size, "float32", k,
                                              t0_fixed=block).schedule)
        st = SlabStencil(spec, size, sweeps_per_call=k, t0_fixed=block,
                         device=DEVICE, schedule=other)
        grid = cli.make_grid(RunConfig(size=size, spec=spec.name,
                                       device=DEVICE), spec)
        bench(registry.Runner(name=f"slab_{other}", granularity=k,
                              iterate=st.iterate), grid,
              int(np.prod(size)), device, hbm, label,
              f"{spec.name} {size} {other} k={k} tiles {st.plan.tiles}")
    # cfg8: Poisson 256^3 through the tiled source kernel at k=8
    prob = PoissonProblem(shape=POISSON_BIG, device=DEVICE)
    f = np.random.default_rng(SEED).normal(size=POISSON_BIG) \
        .astype(np.float32)
    for schedule in ("march", "window"):
        runner = prob.runner(f, method="pallas_tiled", sweeps_per_call=8,
                             schedule=schedule)
        tiled.reset_counts()
        bench(runner, prob.initial_grid(), int(np.prod(POISSON_BIG)), device,
              hbm, label, f"cfg8 Poisson {POISSON_BIG} {runner.name} "
              f"{schedule} {runner.plan_info['tiles']}")
        require(schedule == "window" or tiled.march_source_launches
                == tiled.launches > 0, f"cfg8: {tiled.launches} launches, "
                f"{tiled.march_source_launches} march source launches")
    # cfg3 and cfg4-bf16 on the tiled kernel's bf16 entries, and the fp32
    # configurations it ran untimed before: cfg4, cfg5 and cfg6 (ragged)
    for name, (spec_name, size, k), dtype in (
            ("cfg3", CFG3[:3], "bfloat16"),
            ("cfg4-bf16", CFG4[:3], "bfloat16"),
            ("cfg4", CFG4[:3], "float32"), ("cfg5", CFG5, "float32"),
            ("cfg6", CFG6, "float32")):
        cfg = RunConfig(size=size, spec=spec_name, temporal=k,
                        methods=("tiled",), dtype=dtype, device=DEVICE)
        spec = get_spec(spec_name)
        grid = cli.make_grid(cfg, spec)
        runner = registry.get_runner("tiled", cfg, spec, grid)
        tiled.reset_counts()
        bench(runner, grid, int(np.prod(size)), device, hbm, label,
              f"{name} {spec_name} {size} {dtype} {runner.name} "
              f"{runner.plan_info['schedule']}")
        require(runner.plan_info["schedule"] == "march"
                and tiled.march_launches == tiled.launches > 0,
                f"{name}: {tiled.march_launches} march launches of "
                f"{tiled.launches}, plan {runner.plan_info}")
        wst = TiledStencil(spec, size, dtype, sweeps_per_call=k,
                           device=DEVICE, schedule="window")
        bench(registry.Runner(name="tiled_window", granularity=k,
                              iterate=wst.iterate), grid,
              int(np.prod(size)), device, hbm, label,
              f"{name} {spec_name} {size} {dtype} window k={k} tiles "
              f"{wst.plan.tiles}")
        del wst, grid

    stamp("GLUPS of the iterate configurations")
    # the multigrid cells at 255^3, bench.py's seeded random f
    from stencil_tpu_torch.krylov import ConjugateGradient
    from stencil_tpu_torch.multigrid import Multigrid

    mprob = PoissonProblem(shape=MG_SIZE, device=DEVICE)
    mf = torch.from_numpy(np.random.default_rng(MG_SEED).normal(
        size=MG_SIZE).astype(np.float32)).to(device)
    # (the tiled fine levels on the plan rule's schedules, then on the
    # window's: the same cycles, bitwise, so the same contraction)
    tiled_fine = dict(fine_method="pallas_tiled")
    for name, kw in (
            ("cfg10 wjacobi V(4,4), tiled fine level",
             dict(nu1=4, nu2=4, **tiled_fine)),
            ("cfg11 chebyshev V(2,2), eager fine level",
             dict(smoother="chebyshev")),
            ("cfg17 chebyshev V(4,4), tiled fine level",
             dict(nu1=4, nu2=4, smoother="chebyshev", **tiled_fine)),
            ("wjacobi V(2,2), eager fine level", {}),
            ("wjacobi V(2,2), tiled fine level", tiled_fine)):
        found = {}
        for sched in (("rule", "window") if "tiled" in name else ("rule",)):
            with on_window() if sched == "window" else \
                    contextlib.nullcontext():
                mg = Multigrid(mprob, **kw)
                ms_c, rho, decade, upd, res, busy = time_cycles(mg, mf,
                                                                device)
                scheds = (mg.runner(mf).plan_info["fine_schedules"]
                          if mg.tiled_fine else "eager")
            found[sched] = (rho, tuple(upd))
            where = "" if sched == "rule" else ", every plan on the window"
            print(f"{name}{where} {MG_SIZE}: {ms_c:.4f} ms per V-cycle "
                  f"(median of 3 runs of {CYCLE_REPEATS}), the device busy "
                  f"{busy:.4f} ms per cycle (profiler), contraction "
                  f"{rho:.4f} per cycle (update norms "
                  f"{[f'{u:.3e}' for u in upd]}; residual "
                  f"{[f'{r:.3e}' for r in res]}), {decade:.4f} ms per "
                  f"decade; fine schedules {scheds} [{label}]")
        require(len(set(found.values())) == 1,
                f"{name}: the march's and the window's cycles differ "
                f"{found}")
    # cfg13: PCG with Chebyshev multigrid on the tiled fine level, its
    # plans on the window first (the same iterations, bitwise)
    with on_window():
        pcg_window = ConjugateGradient(mprob, preconditioner=Multigrid(
            mprob, smoother="chebyshev", fine_method="pallas_tiled"))
        res13w = pcg_window.solve(mf, tolerance=1e-4, max_iterations=50,
                                  check_every=1)
        wall_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            pcg_window.solve(mf, tolerance=1e-4, max_iterations=50,
                             check_every=1)
            wall_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"cfg13 PCG chebyshev tiled {MG_SIZE} tol 1e-4, check_every=1, "
          f"every fine plan on the window: {res13w.summary()}; time to "
          f"solution {sorted(wall_ms)[1]:.3f} ms (median of {wall_ms}) "
          f"[{label}]")
    pcg = ConjugateGradient(mprob, preconditioner=Multigrid(
        mprob, smoother="chebyshev", fine_method="pallas_tiled"))
    for every in (8, 1):
        def solve13():
            return pcg.solve(mf, tolerance=1e-4, max_iterations=50,
                             check_every=every)

        res13 = solve13()
        wall_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            solve13()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"cfg13 PCG chebyshev tiled {MG_SIZE} tol 1e-4, check_every="
              f"{every}: {res13.summary()}; time to solution "
              f"{sorted(wall_ms)[1]:.3f} ms (median of {wall_ms}) [{label}]")
        require(res13.converged, "cfg13 did not converge")
    require(res13.iterations == res13w.iterations
            and res13.residual_rel == res13w.residual_rel,
            f"cfg13: {res13.summary()} on the plan rule's schedules, "
            f"{res13w.summary()} on the window")
    # the error floor of the cycles at 255^3: manufactured sine, error
    # against the exact solution after each cycle
    from stencil_tpu_torch.models.poisson import manufactured_sine as sine

    f_sine, u_sine = sine(MG_SIZE)
    u_sine = torch.from_numpy(u_sine).to(device)
    for dtype, kw in (("float32", dict(nu1=4, nu2=4,
                                       fine_method="pallas_tiled")),
                      ("float32", dict(nu1=4, nu2=4)),
                      ("float64", dict(nu1=4, nu2=4)),
                      ("float32", dict(smoother="chebyshev",
                                       fine_method="pallas_tiled"))):
        fprob = PoissonProblem(shape=MG_SIZE, dtype=dtype, device=DEVICE)
        mgf = Multigrid(fprob, **kw)
        frun, g = mgf.runner(f_sine), fprob.initial_grid()
        errs = []
        for _ in range(FLOOR_CYCLES):
            g = frun.iterate(g, 1)
            errs.append(float((g.interior().double() - u_sine).abs().max()))
        print(f"error floor {dtype} {mgf.smoother} V({mgf.nu1},{mgf.nu2}) "
              f"{mgf.fine_method} fine level {MG_SIZE}: error vs exact after "
              f"cycles 1..{FLOOR_CYCLES} {[f'{e:.3e}' for e in errs]} (h^2 = "
              f"{fprob.h ** 2:.3e}) [{label}]")
    wall, busy, span = device_busy(solve13, device)
    print(f"cfg13 one solve (check_every=1): host wall {wall:.3f} ms "
          "unprofiled; " + ("device busy share not measured (the trace "
                            "holds no device events)" if busy is None else
                            f"device busy {busy:.3f} ms of a {span:.3f} ms "
                            f"span, idle {100 * (1 - busy / span):.1f}%")
          + f" [{label}]")

    stamp("the multigrid and Krylov cells")
    # cfg9: the leapfrog wave at 256^3 on the two-level mode, k=8 (GLUPS
    # counts leapfrog steps, bench.py's rule), and on eager
    from stencil_tpu_torch.models.diffusion import (
        HeterogeneousDiffusion, two_material,
    )
    from stencil_tpu_torch.models.wave import WaveEquation

    w = WaveEquation(shape=MAIN_SIZE, device=DEVICE)
    wprev, wcur = w.initial_pair(np.random.default_rng(1).normal(
        size=MAIN_SIZE) * 0.01)
    for method, k, sched in (("tiled", WAVE_K, None),
                             ("tiled", WAVE_K, "window"), ("eager", 1, None)):
        kw = {} if sched is None else {"schedule": sched}
        wrun = registry.Runner(
            name=f"wave_{method}", granularity=k,
            iterate=lambda g, n, m=method, k_=k, kw=kw: w.simulate(
                wprev, g, n, method=m, sweeps_per_call=k_, **kw)[1])
        wp = wave_plan(MAIN_SIZE, k, schedule=sched)
        bench(wrun, wcur, int(np.prod(MAIN_SIZE)), device, hbm, label,
              f"cfg9 wave {MAIN_SIZE} {method} k={k}"
              + (f", {wp.schedule} tiles {wp.tiles}"
                 if method == "tiled" else ""))
    # cfg16 / cfg16b: two-material FTCS diffusion at 256^3 (contrast 100,
    # seed 0) on the coefficient mode at k=8 and on the eager field sweep
    vdiff = HeterogeneousDiffusion(
        shape=MAIN_SIZE, a=two_material(MAIN_SIZE, lo=0.01, hi=1.0, seed=0),
        device=DEVICE)
    for name, method in (("cfg16", "tiled"), ("cfg16b", "eager")):
        vrun = vdiff.runner(method=method, sweeps_per_call=8)
        require(method != "tiled" or vrun.plan_info["schedule"] == "march",
                f"cfg16: plan {vrun.plan_info}")
        bench(vrun, vdiff.initial_grid(), int(np.prod(MAIN_SIZE)), device,
              hbm, label, f"{name} varcoeff {MAIN_SIZE} {vrun.name} "
              f"{vrun.plan_info}")
    # cfg16 on the window schedule: the same sweeps from the padded a(x)
    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.ops.tiled import coeff_iterate, pad_coeff

    lam = vdiff.stable_dt / vdiff.h ** 2
    wplan = make_tiled_plan(j7, MAIN_SIZE, "float32", 8,
                            coeff_scales=(lam, 1.0, -lam), schedule="window")
    wa = pad_coeff(wplan, vdiff.a, vdiff.bc).to(device)

    def window16(g, n):
        return HaloGrid(data=coeff_iterate(wplan, g.data, vdiff.bc, wa,
                                           n // 8, g.halo, n % 8),
                        halo=g.halo, bc=g.bc)

    bench(registry.Runner(name="cfg16_window", granularity=8,
                          iterate=window16), vdiff.initial_grid(),
          int(np.prod(MAIN_SIZE)), device, hbm, label,
          f"cfg16 varcoeff {MAIN_SIZE} window k=8 tiles {wplan.tiles}")
    del wa
    # cfg18: BiCGStab + OperatorMultigrid on the 255^3 heterogeneous
    # Poisson problem, tol 1e-4, at most 1000 iterations, f seed 7, with
    # the eager matvec (auto) and the coefficient mode's (pallas)
    from stencil_tpu_torch.krylov import BiCGStab
    from stencil_tpu_torch.multigrid import OperatorMultigrid

    fhet = torch.from_numpy(np.random.default_rng(HETERO_SEED).normal(
        size=HETERO_SIZE).astype(np.float32)).to(device)
    for op in ("auto", "pallas"):
        hprob = hetero_problem(op)
        hsolver = BiCGStab(hprob, preconditioner=OperatorMultigrid(hprob))

        def solve18():
            return hsolver.solve(fhet, tolerance=1e-4, max_iterations=1000)

        res18 = solve18()
        wall_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            solve18()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"cfg18 BiCGStab + OperatorMultigrid hetero {HETERO_SIZE} "
              f"--op-kernel {op}, tol 1e-4: {res18.summary()}; time to "
              f"solution {sorted(wall_ms)[1]:.3f} ms (median of {wall_ms}) "
              f"[{label}]")
        require(res18.converged, f"cfg18 --op-kernel {op} did not converge")
        wall, busy, span = device_busy(solve18, device)
        print(f"cfg18 --op-kernel {op} one solve: host wall {wall:.3f} ms "
              "unprofiled; " + ("device busy share not measured (the trace "
                                "holds no device events)" if busy is None
                                else f"device busy {busy:.3f} ms of a "
                                f"{span:.3f} ms span, idle "
                                f"{100 * (1 - busy / span):.1f}%")
              + f" [{label}]")

    stamp("cfg9, cfg16, cfg18")
    # one launch per kernel mode at the shape, spec, k, tiles and source
    # of a main path that phase 3 held it at and phase 4 counted
    launch_inputs = []  # (mode, kernel, plan, padded u, padded source)
    for mode, kernel, make_plan, spec, size, k in (
            ("tiled_march", tiled, make_tiled_plan, j7, MAIN_SIZE, 8),
            ("slab_sweep", slab, window_slab, j5, CFG1[1], CFG1[2])):
        plan = make_plan(spec, size, "float32", k)
        launch_inputs.append((mode, kernel, plan, plan.layout.pad_grid(
            random_grid(size, spec.radius, rng, device)), None))
    for mode, kernel, make_plan in (
            ("tiled_march+source", tiled, make_tiled_plan),
            ("slab_sweep+source", slab, window_slab)):
        runner, prob, f, _ = poisson_big[mode]
        plan = make_plan(prob.spec, prob.shape, "float32",
                         runner.plan_info["k"])
        require(list(plan.tiles) == runner.plan_info["tiles"],
                f"{mode}: plan {plan.tiles} is not the runner's")
        grid = prob.initial_grid(rng.random(prob.shape, dtype=np.float32))
        launch_inputs.append((mode, kernel, plan, plan.layout.pad_grid(grid),
                              pad_source(plan, f, prob.source_scale,
                                         grid.bc).to(device)))
    # the march rows the 2D main paths launch, at their shapes: cfg2 (-b
    # 256) and the 63^2 Poisson solve's source mode, each beside the
    # window's launch of the same sweeps on the same inputs
    slab_windows = {}
    plan = make_slab_plan(j9, CFG2[1], "float32", CFG2[2], t0_fixed=CFG2[3])
    slab_windows["slab_march"] = window_slab(j9, CFG2[1], "float32", CFG2[2],
                                             t0_fixed=CFG2[3])
    launch_inputs.append(("slab_march", slab, plan, plan.layout.pad_grid(
        random_grid(CFG2[1], j9.radius, rng, device)), None))
    prob = PoissonProblem(shape=POISSON_2D, device=DEVICE)
    plan = make_slab_plan(prob.spec, POISSON_2D, "float32", 8)
    slab_windows["slab_march+source"] = window_slab(prob.spec, POISSON_2D,
                                                    "float32", 8)
    grid = prob.initial_grid(rng.random(POISSON_2D, dtype=np.float32))
    launch_inputs.append(("slab_march+source", slab, plan,
                          plan.layout.pad_grid(grid),
                          pad_source(plan, rng.normal(size=POISSON_2D),
                                     prob.source_scale, grid.bc).to(device)))
    for mode, _, plan, _, _ in launch_inputs[-2:]:
        require(plan.schedule == "march"
                and slab_windows[mode].layout == plan.layout,
                f"{mode}: the plan gives the {plan.schedule}")
    # the per-mode times below start from an empty allocator cache (the
    # plain versions allocate whole padded tensors), with the card's state
    # beside them
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    print(f"before the per-mode times: "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / gib:.2f} GiB reserved; "
          f"clocks.sm, clocks.mem, power.draw, temperature: {gpu_state()} "
          f"[{label}]")
    # the library yardstick: one conv per sweep, in full fp32, cuDNN free
    # to pick its fastest algorithm (time_call's untimed first call tunes)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    ms, plain_ms, library_ms, bound_ms, bound_by = {}, {}, {}, {}, {}
    window_ms = {}  # the window schedule's time for each march row's launch
    def slab_twin(mode, plan, cur, src, pins=None):
        """The march's launch of a slab_sweep row's sweeps on its inputs
        beside the window's time; the slab_march row's numbers where no
        main path launches that row (``slab_windows`` holds those that one
        does, timed at its shape); the bound, plain and library times are
        the same function's."""
        row = mode.replace("slab_sweep", "slab_march")
        twin = make_slab_plan(plan.spec, plan.interior_shape, plan.dtype,
                              plan.sweeps_per_call, schedule="march")
        require(twin.layout == plan.layout, f"{row}: layouts differ")
        nxt = cur.clone()
        twin_ms = time_call(lambda: slab(cur, nxt, twin, src, pins), device,
                            20)
        print(f"  the march's launch of {mode}'s sweeps (tiles "
              f"{twin.tiles}): {twin_ms:.4f} ms beside the window's "
              f"{ms[mode]:.4f} ms [{label}]")
        if row in slab_windows:
            return
        ms[row], window_ms[row] = twin_ms, ms[mode]
        for rec in (plain_ms, bound_ms, bound_by, library_ms):
            rec[row] = rec[mode]

    for mode, kernel, plan, cur, src in launch_inputs:
        nxt = cur.clone()
        out2 = cur.clone() if getattr(plan, "cheby_dual", False) else None
        ms[mode] = time_call(lambda: kernel(cur, nxt, plan, src, out2=out2),
                             device, 20)
        if mode.startswith("tiled_march"):
            twin = window_twin(plan)
            window_ms[mode] = time_call(lambda: kernel(cur, nxt, twin, src,
                                                       out2=out2),
                                        device, 10)
            print(f"  the window schedule's launch of {mode} (tiles "
                  f"{twin.tiles}): {window_ms[mode]:.4f} ms [{label}]")
        elif mode in slab_windows:
            twin = slab_windows[mode]
            window_ms[mode] = time_call(lambda: kernel(cur, nxt, twin, src),
                                        device, 20)
            print(f"  the window schedule's launch of {mode} (tiles "
                  f"{twin.tiles}): {window_ms[mode]:.4f} ms [{label}]")
        plain_ms[mode] = time_call(lambda: sweep_reference(cur, plan, src),
                                   device, 5)
        lib, lib_check = library_sweep(plan, cur, src)
        library_ms[mode] = time_call(lib, device, 20)
        bound_ms[mode], bound_by[mode] = bound(plan, src, out2 is not None)
        print(f"one call of {mode} {plan.spec.name} {plan.interior_shape} "
              f"k={plan.sweeps_per_call}, tiles {plan.tiles}: kernel "
              f"{ms[mode]:.4f} ms, plain {plain_ms[mode]:.4f} ms, bound "
              f"{bound_ms[mode]:.4f} ms (by {bound_by[mode]}); library "
              f"conv{len(plan.interior_shape)}d {library_ms[mode]:.4f} ms "
              f"per sweep (the kernel does {plan.sweeps_per_call}; vs one "
              f"plain sweep max abs diff {lib_check():.3e}) [{label}]")
        if mode.startswith("slab_sweep"):
            slab_twin(mode, plan, cur, src)

    # the Chebyshev and dual modes: cfg13's two launches (the PCG path's
    # plans, bench.py's f), cfg10's fused launch (the mg-nu4 path's, k=5)
    # and cfg17's two (k=4, k=5), each on the march and on the window in
    # turns; the rows of the plan's schedule (cfg13's) take these times.
    # Beside them cfg10's weighted-Jacobi smoother (the source mode, 7
    # taps, k=4), which the march runs through its unrolled 7-tap instance
    cheby_launches = [("cfg13", op) for _, op in
                      solve_paths["pcg-cheby"][3]]
    cheby_launches += [("cfg10", op) for _, op in solve_paths["mg-nu4"][3]]
    pre17, _, _, fused17 = cfg17_multigrid()._fine_ops()
    cheby_launches += [("cfg17", pre17), ("cfg17", fused17)]
    cell_counts = {"cfg13": solve_counts["pcg-cheby"],
                   "cfg10": solve_counts["mg-nu4"],
                   "cfg17": solve_counts["cfg17"]}
    for cell, op in cheby_launches:
        plan = op.plan
        dual = plan.cheby_dual
        plans = [window_twin(plan, sched) for sched in ("march", "window")]
        grid = random_grid(MG_SIZE, 1, rng, device)
        cur = plan.layout.pad_grid(grid)
        src = pad_source(plan, mf, op.source_scale, grid.bc)
        nxt = cur.clone()
        out2 = cur.clone() if dual else None
        times = {}
        for p in plans + plans[::-1]:
            t = time_call(lambda: tiled(cur, nxt, p, src, out2=out2),
                          device, 20)
            times[p.schedule] = min(times.get(p.schedule, t), t)
        plain = time_call(lambda: sweep_reference(cur, plan, src), device,
                          5)
        lib, lib_check = library_sweep(plan, cur, src)
        lib_ms = time_call(lib, device, 20)
        b_ms, b_by = bound(plan, src, dual)
        row = cheby_row(plan) if plan.cheby_coeffs else \
            "tiled_march+source"
        print(f"one call of {row} ({cell}) {plan.spec.name} {MG_SIZE} "
              f"k={plan.sweeps_per_call}: march (tiles {plans[0].tiles}) "
              f"{times['march']:.4f} ms, window (tiles {plans[1].tiles}) "
              f"{times['window']:.4f} ms (each the least of two runs of 20, "
              f"in turns); the plan takes the {plan.schedule}; plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms (by {b_by}); library "
              f"conv3d {lib_ms:.4f} ms per sweep (vs one plain sweep max "
              f"abs diff {lib_check():.3e}); {row} launches on the "
              f"{cell} path in phase 4 {cell_counts[cell][row]} [{label}]")
        if cell != "cfg13" or not plan.cheby_coeffs:
            continue
        for p in plans:
            r = cheby_row(p)
            ms[r], plain_ms[r], library_ms[r] = times[p.schedule], plain, \
                lib_ms
            bound_ms[r], bound_by[r] = b_ms, b_by
        window_ms[cheby_row(plans[0])] = times["window"]

    # the two-level mode at cfg9's plan, on the march and on the window:
    # the yardstick is one 2-channel conv3d per leapfrog step
    mode = "tiled_march+two_level"
    plan = wave_plan(MAIN_SIZE, WAVE_K)
    twin = window_twin(plan)
    cur = plan.layout.pad_grid(random_grid(MAIN_SIZE, 1, rng, device))
    prev = plan.layout.pad_grid(random_grid(MAIN_SIZE, 1, rng, device))
    nxt, out2 = cur.clone(), prev.clone()
    ms[mode] = time_call(lambda: tiled(cur, nxt, plan, prev=prev, out2=out2),
                         device, 20)
    window_ms[mode] = time_call(lambda: tiled(cur, nxt, twin, prev=prev,
                                              out2=out2), device, 10)
    plain_ms[mode] = time_call(lambda: sweep_reference(cur, plan, prev=prev),
                               device, 3)
    lib, lib_check = wave_library_step(plan, cur, prev)
    library_ms[mode] = time_call(lib, device, 20)
    bound_ms[mode], bound_by[mode] = wave_bound(plan)
    print(f"one call of {mode} {plan.spec.name} {MAIN_SIZE} k={WAVE_K}, "
          f"march tiles {plan.tiles}: kernel {ms[mode]:.4f} ms, the "
          f"window's launch (tiles {twin.tiles}) {window_ms[mode]:.4f} ms, "
          f"plain {plain_ms[mode]:.4f} ms, bound {bound_ms[mode]:.4f} ms (by "
          f"{bound_by[mode]}); library conv3d (2 channels) "
          f"{library_ms[mode]:.4f} ms per step (the kernel does {WAVE_K}; "
          f"vs one plain step max abs diff {lib_check():.3e}) [{label}]")
    # the coefficient mode at cfg16's plan, on the march through the
    # weights and on the window from a(x): no single PyTorch call forms
    # per-point weights; the eager field sweep (cfg16b's) is printed beside
    from stencil_tpu_torch.ops.eager import apply_fields
    from stencil_tpu_torch.ops.sweep_kernel import coeff_weights_reference
    from stencil_tpu_torch.ops.tiled import coeff_apply
    from stencil_tpu_torch.ops.tiled_kernel import coeff_weights

    mode = "tiled_march+coeff"
    plan, cur, a = marching_inputs(MAIN_SIZE, 8, rng, device)
    w = coeff_weights(a, plan)
    twin = window_twin(plan)
    nxt = cur.clone()
    ms[mode] = time_call(lambda: tiled(cur, nxt, plan, coeff=w), device, 10)
    window_ms[mode] = time_call(lambda: tiled(cur, nxt, twin, coeff=a),
                                device, 3)
    plain_ms[mode] = time_call(lambda: sweep_reference(cur, plan, coeff=w),
                               device, 3)
    library_ms[mode] = None
    n_int = int(np.prod(plan.interior_shape))
    n_pad = int(np.prod(plan.layout.padded_shape))
    bound_ms[mode], bound_by[mode] = bound_of(
        plan.itemsize * (2 * needed_cells(plan) + n_int),
        coeff_ops(n_int, plan.sweeps_per_call))
    offsets, fields = vdiff.tap_fields()
    fields = torch.from_numpy(fields).float().to(device)
    h = plan.layout.halo
    cur_h1 = cur[tuple(slice(h - 1, h + n + 1) for n in MAIN_SIZE)]
    eager_ms = time_call(lambda: apply_fields(cur_h1, offsets, fields, 1),
                         device, 10)
    del fields
    print(f"one call of {mode} {MAIN_SIZE} k={plan.sweeps_per_call}, march "
          f"tiles {plan.tiles}: kernel {ms[mode]:.4f} ms, the window's "
          f"launch (tiles {twin.tiles}) {window_ms[mode]:.4f} ms, plain "
          f"{plain_ms[mode]:.4f} ms, bound {bound_ms[mode]:.4f} ms (by "
          f"{bound_by[mode]}); library none (per-point weights); the eager "
          f"field sweep (cfg16b) {eager_ms:.4f} ms per sweep [{label}]")
    # the weights kernel, once per run, at cfg16's padded grid: a(x) read
    # once, four fields written
    mode = "coeff_weights"
    ms[mode] = time_call(discarding(lambda: coeff_weights(a, plan)), device,
                         10)
    plain_ms[mode] = time_call(
        discarding(lambda: coeff_weights_reference(a, plan)), device, 3)
    library_ms[mode] = None
    bound_ms[mode], bound_by[mode] = bound_of(20 * n_pad,
                                              WEIGHTS_KERNEL_OPS * n_pad)
    print(f"one call of {mode} {plan.layout.padded_shape} (cfg16's padded "
          f"a(x), once per run): kernel {ms[mode]:.4f} ms, plain "
          f"{plain_ms[mode]:.4f} ms, bound {bound_ms[mode]:.4f} ms (by "
          f"{bound_by[mode]}); library none [{label}]")
    del w, a, cur, nxt
    # the k=1 matvec of cfg18 at 255^3: one launch on the march through
    # the level's weights and one on the window from a(x), into one
    # output; the operator's matvec around the march launch; plain; the
    # eager field matvec
    kprob, eprob = hetero_problem("pallas"), hetero_problem("auto")
    kplan, kdata, edata = (kprob._kernel_plan(), kprob.operator_data(),
                           eprob.operator_data())
    x = random_ring(HETERO_SIZE, rng, device)
    y = torch.empty_like(x)
    mv_twin = window_twin(kplan)
    mv_a = pad_coeff(kplan, kprob.a, kprob.bc).to(device)
    mv_ms = time_call(lambda: tiled(x, y, kplan, coeff=kdata[1]), device, 20)
    mv_window = time_call(lambda: tiled(x, y, mv_twin, coeff=mv_a), device,
                          20)
    mv_apply = time_call(discarding(lambda: kprob.operator_apply(x, kdata)),
                         device, 20)
    mv_plain = time_call(discarding(lambda: sweep_reference(
        x, kplan, coeff=kdata[1])), device, 3)
    mv_eager = time_call(discarding(lambda: eprob.operator_apply(x, edata)),
                         device, 20)
    n_int = int(np.prod(HETERO_SIZE))
    mv_bound, mv_by = bound_of(
        kplan.itemsize * (2 * int(np.prod(x.shape)) + n_int),
        coeff_ops(n_int, 1))
    print(f"one cfg18 matvec {HETERO_SIZE} (coeff mode k=1, march tiles "
          f"{kplan.tiles}): kernel {mv_ms:.4f} ms, the window's launch "
          f"(tiles {mv_twin.tiles}) {mv_window:.4f} ms, operator_apply "
          f"{mv_apply:.4f} ms, plain {mv_plain:.4f} ms, bound "
          f"{mv_bound:.4f} ms (by {mv_by}); the eager field matvec "
          f"{mv_eager:.4f} ms [{label}]")
    del kdata, edata, mv_a, x, y

    stamp("one launch per fp32 mode")
    # the device's busy share over cfg1's main-path run (1024 iterations)
    cfg = RunConfig(size=CFG1[1], spec="jacobi5", temporal=CFG1[2],
                    methods=("slab",), device=DEVICE)
    grid = cli.make_grid(cfg, j5)
    runner = registry.get_runner("slab", cfg, j5, grid)
    march1 = SlabStencil(j5, CFG1[1], sweeps_per_call=CFG1[2], device=DEVICE,
                         schedule="march")
    for name, iterate in ((f"{runner.name}, {runner.plan_info['schedule']}",
                           runner.iterate),
                          (f"slab march {march1.plan.tiles}",
                           march1.iterate)):
        wall, busy, span = device_busy(lambda: iterate(grid, CFG1[4]),
                                       device)
        n_launch = CFG1[4] // CFG1[2]
        # the host's own cost: the iterate's return, before a synchronize,
        # the least of 3 runs (its 64 launches queue without a wait)
        enqueue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iterate(grid, CFG1[4])
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        host = (f"host {min(enqueue):.3f} ms to enqueue, "
                f"{min(enqueue) / n_launch * 1e3:.1f} us of host per launch; "
                f"wall {wall:.3f} ms to the synchronize, "
                f"{wall / n_launch * 1e3:.1f} us per launch")
        if busy is None:
            print(f"cfg1 {CFG1[4]} iterations ({name}): {host}; device "
                  f"busy share not measured (the trace holds no device "
                  f"events) [{label}]")
        else:
            print(f"cfg1 {CFG1[4]} iterations ({name}): {host} "
                  f"(unprofiled); device busy {busy:.3f} ms, "
                  f"{busy / n_launch * 1e3:.1f} us per launch, of a "
                  f"{span:.3f} ms span, idle {100 * (1 - busy / span):.1f}% "
                  f"[{label}]")

    # the dynamic-wall paths: GLUPS beside the Dirichlet runs above, cfg12,
    # the device's idle share, and one launch of each pins mode
    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.models.advection import Advection
    from stencil_tpu_torch.ops import eager
    from stencil_tpu_torch.ops.layout import refresh_dynamic_layout
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    pins_runs = {}
    for spec, size, k, dims, method in (
            (j7, MAIN_SIZE, 8, ("0", "1"), "tiled"),
            (j5, CFG1[1], CFG1[2], ("0",), "slab")):
        cfg = RunConfig(size=size, spec=spec.name, temporal=k,
                        methods=(method,), periodic=dims, device=DEVICE)
        grid = cli.make_grid(cfg, spec)
        runner = registry.get_runner(method, cfg, spec, grid)
        bench(runner, grid, int(np.prod(size)), device, hbm, label,
              f"{spec.name} {size} {runner.name} --periodic {' '.join(dims)}")
        pins_runs[size] = (runner, grid)
    # cfg12: upwind advection at 256^3 k=8 on the reference faces (the
    # table-loop evaluator, no pins), beside eager and a periodic (0, 1) box
    for bc in (walls(3), walls(3, (0, 1))):
        adv = Advection(shape=MAIN_SIZE, velocity=ADVECT_VELOCITY, bc=bc,
                        device=DEVICE)
        agrid = HaloGrid.create(MAIN_SIZE, halo=1, bc=bc, device=DEVICE)
        astencil = TiledStencil(adv.spec, MAIN_SIZE, sweeps_per_call=8,
                                device=DEVICE)
        runs = [registry.Runner(name="advection_upwind_k8", granularity=8,
                                iterate=astencil.iterate)]
        if not bc.any_dynamic:
            runs.append(registry.Runner(
                name="advection_upwind_eager", granularity=1,
                iterate=lambda g, n, sp=adv.spec: eager.iterate(g, sp, n)))
        for arun in runs:
            bench(arun, agrid, int(np.prod(MAIN_SIZE)), device, hbm, label,
                  f"{'cfg12 ' if not bc.any_dynamic else ''}advection upwind "
                  f"{MAIN_SIZE} velocity {ADVECT_VELOCITY}, {walls_name(bc)}, "
                  f"{arun.name} tiles {list(astencil.plan.tiles)}")
    # the device's busy share: 3D k=8 on Dirichlet and periodic (0, 1)
    # walls, cfg1 on periodic d0 (its Dirichlet run is above)
    dirichlet3d = registry.get_runner(
        "tiled", RunConfig(size=MAIN_SIZE, spec="jacobi7", temporal=8,
                           methods=("tiled",), device=DEVICE), j7,
        cli.make_grid(RunConfig(size=MAIN_SIZE, spec="jacobi7",
                                device=DEVICE), j7))
    for name, (runner, grid), iters in (
            (f"3D jacobi7 {MAIN_SIZE} k=8 dirichlet",
             (dirichlet3d, cli.make_grid(RunConfig(
                 size=MAIN_SIZE, spec="jacobi7", device=DEVICE), j7)),
             MAIN_ITERS),
            (f"3D jacobi7 {MAIN_SIZE} k=8 --periodic 0 1",
             pins_runs[MAIN_SIZE],
             MAIN_ITERS),
            ("cfg1 --periodic 0", pins_runs[CFG1[1]], CFG1[4])):
        wall, busy, span = device_busy(lambda: runner.iterate(grid, iters),
                                       device)
        print(f"{name}, {iters} iterations ({runner.name}): host wall "
              f"{wall:.3f} ms unprofiled; " + (
                  "device busy share not measured (the trace holds no "
                  "device events)" if busy is None else
                  f"device busy {busy:.3f} ms of a {span:.3f} ms span, idle "
                  f"{100 * (1 - busy / span):.1f}%") + f" [{label}]")
    # one launch of each pins mode at the plan of a phase-4 dynamic-wall
    # path, on a refreshed random grid: (mode, kernel, plan, walls, u,
    # source, u_(n-1), a(x))
    pins_inputs = [("tiled_march+pins", tiled, plan8, per01,
                    pins_input(plan8, per01, rng, device), None, None, None)]
    for mode, kernel, make_plan in (
            ("tiled_march+source+pins", tiled, make_tiled_plan),
            ("slab_sweep+source+pins", slab, window_slab)):
        runner, prob, f, _ = poisson_big[mode]
        plan = make_plan(prob.spec, prob.shape, "float32",
                         runner.plan_info["k"])
        require(list(plan.tiles) == runner.plan_info["tiles"],
                f"{mode}: plan {plan.tiles} is not the runner's")
        pins_inputs.append((mode, kernel, plan, prob.bc,
                            pins_input(plan, prob.bc, rng, device),
                            pad_source(plan, f, prob.source_scale,
                                       prob.bc).to(device), None, None))
    wplan = wave_plan(MAIN_SIZE, WAVE_K)
    pins_inputs.append(("tiled_march+two_level+pins", tiled, wplan, mixed,
                        pins_input(wplan, mixed, rng, device), None,
                        pins_input(wplan, mixed, rng, device), None))
    plan, cur, a = marching_inputs(MAIN_SIZE, 8, rng, device, per01)
    window_coeff = {"tiled_march+coeff+pins": a}  # the window reads a(x)
    pins_inputs.append(("tiled_march+coeff+pins", tiled, plan, per01, cur,
                        None, None, coeff_weights(a, plan)))
    pins_inputs.append(("slab_sweep+pins", slab, s16, per0_2d,
                        pins_input(s16, per0_2d, rng, device), None, None,
                        None))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for mode, kernel, plan, bc, cur, src, prev, coeff in pins_inputs:
        pins = dynamic_pins(bc, len(plan.interior_shape))
        nxt = cur.clone()
        out2 = None if prev is None else prev.clone()
        ms[mode] = time_call(lambda: kernel(cur, nxt, plan, src, pins,
                                            out2=out2, prev=prev,
                                            coeff=coeff), device, 10)
        if mode.startswith("tiled_march"):
            twin = window_twin(plan)
            window_ms[mode] = time_call(lambda: kernel(
                cur, nxt, twin, src, pins, out2=out2, prev=prev,
                coeff=window_coeff.get(mode)),
                device, 3 if mode in window_coeff else 5)
            print(f"  the window schedule's launch of {mode} (tiles "
                  f"{twin.tiles}): {window_ms[mode]:.4f} ms [{label}]")
        plain_ms[mode] = time_call(lambda: sweep_reference(
            cur, plan, src, prev, coeff, pins), device, 3)
        # the runner refreshes each input level before every launch
        refresh_ms = time_call(lambda: [refresh_dynamic_layout(
            t, plan.layout, bc, plan.halo) for t in (cur, prev)
            if t is not None], device, 20)
        n_int = int(np.prod(plan.interior_shape))
        k = plan.sweeps_per_call
        if coeff is not None:
            library_ms[mode] = None
            bound_ms[mode], bound_by[mode] = bound_of(
                plan.itemsize * (2 * needed_cells(plan, pins) + n_int),
                coeff_ops(n_int, k))
            lib_text = "library none (per-point weights)"
        else:
            if prev is not None:
                lib, lib_check = wave_library_step(plan, cur, prev, bc)
                bound_ms[mode], bound_by[mode] = wave_bound(plan, pins)
            else:
                lib, lib_check = library_sweep(plan, cur, src, bc)
                bound_ms[mode], bound_by[mode] = bound(plan, src, False,
                                                       pins)
            library_ms[mode] = time_call(lib, device, 10)
            lib_text = (f"library F.pad + conv{len(plan.interior_shape)}d "
                        f"{library_ms[mode]:.4f} ms per sweep (vs one plain "
                        f"sweep max abs diff {lib_check():.3e})")
        print(f"one call of {mode} {plan.spec.name} {plan.interior_shape} "
              f"k={k}, tiles {plan.tiles}, {walls_name(bc)}, pins "
              f"{list(pins)}: kernel {ms[mode]:.4f} ms, plain "
              f"{plain_ms[mode]:.4f} ms, bound {bound_ms[mode]:.4f} ms (by "
              f"{bound_by[mode]}); {lib_text}; the runner's refresh before "
              f"a launch {refresh_ms:.4f} ms [{label}]")
        if mode.startswith("slab_sweep"):
            slab_twin(mode, plan, cur, src, pins)
    stamp("the dynamic-wall times")
    # one launch of each bf16 mode at the plan of its phase-4 path (the
    # Chebyshev and dual modes at the PCG path's fp32 plans, in bf16):
    # kernel, plain, the bound at 2 bytes per value, and the library's conv
    # in bf16 (one sweep, or one leapfrog step)
    bf_inputs = []  # (mode, kernel, plan, walls, padded u, source, u_(n-1))

    def bf_case(mode, kernel, plan, bc=None, src=None, prev=False):
        bc = bc if bc is not None else walls(len(plan.interior_shape))
        bf_inputs.append((mode, kernel, plan, bc,
                          bf16_input(plan, bc, rng, device), src,
                          bf16_input(plan, bc, rng, device) if prev
                          else None))

    bf_case("tiled_march+bf16", tiled, plan8b)
    bf_case("tiled_march+pins+bf16", tiled, plan8b, per01)
    for mode, kernel, make_plan in (
            ("tiled_march+source+bf16", tiled, make_tiled_plan),
            ("slab_sweep+source+bf16", slab, window_slab),
            ("tiled_march+source+pins+bf16", tiled, make_tiled_plan)):
        runner, prob, f, _ = poisson_big[mode]
        plan = make_plan(prob.spec, prob.shape, bf, runner.plan_info["k"])
        require(list(plan.tiles) == runner.plan_info["tiles"],
                f"{mode}: plan {plan.tiles} is not the runner's")
        bf_case(mode, kernel, plan, prob.bc,
                pad_source(plan, f, prob.source_scale, prob.bc).to(device))
    prob, _, _, ops = solve_paths["pcg-cheby"]
    for mode, op in ops:
        plan = cheby_plan(MG_SIZE, op.plan.cheby_coeffs, op.plan.cheby_dual,
                          bf)
        bf_case(cheby_row(plan), tiled, plan,
                src=pad_source(plan, mf, op.source_scale, prob.bc))
    bf_case("tiled_march+two_level+bf16", tiled,
            wave_plan(MAIN_SIZE, WAVE_K, bf), prev=True)
    bf_case("tiled_march+two_level+pins+bf16", tiled,
            wave_plan(MAIN_SIZE, WAVE_K, bf), mixed, prev=True)
    bf_case("slab_sweep+bf16", slab, s16b)
    bf_case("slab_sweep+pins+bf16", slab, s16b, per0_2d)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for mode, kernel, plan, bc, cur, src, prev in bf_inputs:
        nd = len(plan.interior_shape)
        pins = dynamic_pins(bc, nd)
        dual = getattr(plan, "cheby_dual", False)
        nxt = cur.clone()
        out2 = prev.clone() if prev is not None else (
            cur.clone() if dual else None)
        ms[mode] = time_call(lambda: kernel(cur, nxt, plan, src, pins,
                                            out2=out2, prev=prev), device, 20)
        if mode.startswith("tiled_march"):
            twin = window_twin(plan)
            window_ms[mode] = time_call(lambda: kernel(
                cur, nxt, twin, src, pins, out2=out2, prev=prev), device, 10)
            print(f"  the window schedule's launch of {mode} (tiles "
                  f"{twin.tiles}): {window_ms[mode]:.4f} ms [{label}]")
        plain_ms[mode] = time_call(lambda: sweep_reference(
            cur, plan, src, prev, pins=pins), device, 3)
        n_int = int(np.prod(plan.interior_shape))
        k = plan.sweeps_per_call
        if prev is not None:
            lib, lib_check = wave_library_step(plan, cur, prev, bc)
            bound_ms[mode], bound_by[mode] = wave_bound(plan, pins)
        else:
            lib, lib_check = library_sweep(plan, cur, src, bc)
            bound_ms[mode], bound_by[mode] = bound(plan, src, dual, pins)
        library_ms[mode] = time_call(lib, device, 20)
        print(f"one call of {mode} {plan.spec.name} {plan.interior_shape} "
              f"k={k}, tiles {plan.tiles}, {walls_name(bc)}: kernel "
              f"{ms[mode]:.4f} ms, plain {plain_ms[mode]:.4f} ms, bound "
              f"{bound_ms[mode]:.4f} ms (by {bound_by[mode]}, "
              f"{plan.itemsize} bytes per value); library "
              f"{'F.pad + ' if bc.any_dynamic else ''}conv{nd}d in bf16 "
              f"{library_ms[mode]:.4f} ms per "
              f"{'step' if prev is not None else 'sweep'} (vs one plain "
              f"sweep max abs diff {lib_check():.3e}) [{label}]")
        if mode.startswith("slab_sweep"):
            slab_twin(mode, plan, cur, src, pins)
    stamp("the bf16 modes")
    # B3: the bench cell and 128^3 beside tiled, the fixed cost, the
    # kernel record's launch (before the 1024^3 runs, whose traces are the
    # largest of the script)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for mode, rec in time_rma(rma_module.rma_iterate, label).items():
        ms[mode], plain_ms[mode] = rec["ms"], rec["plain"]
        bound_ms[mode], bound_by[mode] = rec["bound"], rec["by"]
        library_ms[mode] = rec["library"]
    stamp("the rma runs")
    # the sharded headline at 1024^3 (the single-device run, then each
    # mesh; each run's tensors freed before the next), and one launch of
    # each other subset mode at its phase-4 path's local block
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sub = {"tiled_march+subset": time_sharded(tiled, label)}
    stamp("the sharded runs at 1024^3")
    local = tuple(n // m for n, m in zip(MAIN_SIZE, SHARDED_MESH + (1,)))
    pprob_sh = PoissonProblem(shape=POISSON_BIG, bc=mixed, device=DEVICE)
    for mode, dtype, source in (
            ("tiled_march+source+subset", "float32", True),
            ("tiled_march+subset+bf16", bf, False),
            ("tiled_march+source+subset+bf16", bf, True)):
        spec = pprob_sh.spec if source else j7
        plan = make_tiled_plan(spec, local, dtype, 8, has_source=source)
        bc = mixed if source else walls(3)
        pins = (0, 0, 0, 0) if source else MESH_PINS
        cur = (bf16_input(plan, bc, rng, device) if dtype == bf
               else pins_input(plan, bc, rng, device))
        src = pad_source(plan, rng.normal(size=local) / pprob_sh.h ** 2,
                         pprob_sh.source_scale, bc).to(device) \
            if source else None
        rec = subset_times(tiled, plan, cur, pins, src, 10)
        rec["window"] = window_pair_ms(tiled, plan, cur, pins, src, 5)
        lib, lib_check = library_sweep(plan, cur, src)
        rec["library"] = time_call(lib, device, 10)
        rec["full_bound"] = bound(plan, src, False, pins)[0]
        sub[mode] = rec
        print(f"one interior + one edge launch of {mode} ({spec.name} "
              f"{local} k=8 tiles {plan.tiles}, pins {list(pins)}, "
              f"{rec['columns'][0]} interior + {rec['columns'][1]} edge "
              f"columns): kernel {rec['interior']:.4f} + "
              f"{rec['edge']:.4f} ms beside {rec['full']:.4f} ms for the "
              f"full launch; the window schedule's pair {rec['window']:.4f} "
              f"ms; plain {rec['plain']:.4f} ms; bound "
              f"{rec['bound']:.4f} ms (by {rec['by']}; the full launch "
              f"{rec['full_bound']:.4f}); library conv3d "
              f"{rec['library']:.4f} ms per sweep (vs one plain sweep max "
              f"abs diff {lib_check():.3e}) [{label}]")
    # the coefficient subsets (no sharded path runs them): one interior +
    # one edge launch on the march through the weights beside the
    # window's pair from a(x), at the same local block
    cplan = make_tiled_plan(j7, local, "float32", 8,
                            coeff_scales=(0.1, 1.0, -0.1))
    cur = pins_input(cplan, walls(3), rng, device)
    ca = pad_coeff(cplan, rng.random(local) + 0.5, walls(3)).to(device)
    rec = subset_times(tiled, cplan, cur, MESH_PINS, None, 10,
                       coeff_weights(ca, cplan))
    rec["window"] = window_pair_ms(tiled, cplan, cur, MESH_PINS, None, 3, ca)
    n_local = int(np.prod(local))
    full_bound = bound_of(cplan.itemsize * (2 * ca.numel() + n_local),
                          coeff_ops(n_local, cplan.sweeps_per_call))[0]
    print(f"one interior + one edge launch of tiled_march+coeff+subset "
          f"({local} k=8 tiles {cplan.tiles}, pins {list(MESH_PINS)}, "
          f"{rec['columns'][0]} interior + {rec['columns'][1]} edge "
          f"columns): kernel {rec['interior']:.4f} + {rec['edge']:.4f} ms "
          f"beside {rec['full']:.4f} ms for the full launch; the window "
          f"schedule's pair {rec['window']:.4f} ms; plain "
          f"{rec['plain']:.4f} ms; bound {rec['bound']:.4f} ms (by "
          f"{rec['by']}; the full launch {full_bound:.4f}) [{label}]")
    for mode, rec in sub.items():
        ms[mode] = rec["interior"] + rec["edge"]
        window_ms[mode] = rec["window"]
        plain_ms[mode] = rec["plain"]
        bound_ms[mode], bound_by[mode] = rec["bound"], rec["by"]
        library_ms[mode] = rec["library"]
    stamp("the subset launches")
    stream_times = time_streamed(label)
    spreads = sorted(MARGINAL_SPREADS)
    print(f"bench marginals at a {BENCH_SIGNAL_S} s signal, "
          f"{len(spreads)} rows: the two marginals of a row apart by "
          f"{spreads[len(spreads) // 2][0]:.4%} (median), at most "
          f"{spreads[-1][0]:.4%} ({spreads[-1][1]}); rows past 1%: "
          f"{[(n, f'{x:.2%}') for x, n in spreads if x > 0.01]} [{label}]")
    print(f"cfg14/cfg15 time to solution (phase 4): "
          f"{ {c: (v[0], round(v[1], 3)) for c, v in advdiff.items()} } "
          f"(iterations, ms); the streamed step at 1024^3 "
          f"{stream_times[0]:.3f} ms [{label}]")
    print(f"PHASE 5 times: ok ({time.perf_counter() - t_start:.1f} s in "
          "all)")

    modules = {"tiled_sweep": tiled_kernel, "tiled_march": tiled_kernel,
               "coeff_weights": tiled_kernel, "slab_sweep": slab_kernel,
               "rma_iterate": rma_module}
    modules["slab_march"] = slab_kernel
    sources = {"tiled_march": tiled_kernel.MARCH_SOURCE,
               "coeff_weights": tiled_kernel.WEIGHTS_SOURCE,
               "slab_march": slab_kernel.MARCH_SOURCE}
    print(json.dumps({"kernels": [{
        "name": mode, "route": "cuda",
        "source": str(sources.get(mode.split("+")[0], modules[
            mode.split("+")[0]].SOURCE).relative_to(ROOT)),
        "replaces": getattr(modules[mode.split("+")[0]], "REPLACES_MODE",
                            {}).get(mode,
                                    modules[mode.split("+")[0]].REPLACES),
        "launches": launches[mode], "max_abs_err": err[mode],
        "ms": ms[mode], "plain_ms": plain_ms[mode],
        "bound_ms": bound_ms[mode], "bound_by": bound_by[mode],
        "library_ms": library_ms[mode],
        **({"window_ms": window_ms[mode]} if mode in window_ms else {}),
    } for mode in KERNEL_MODES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(cycles_main(sys.argv[2]) if sys.argv[1:2] == ["--cycles"]
             and len(sys.argv) == 3 else main())
