#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hippyflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile   # also: device-time tables of the main
                                      # path, the training lane and the
                                      # two large lanes
    python3 chip_smoke.py --parent DIR   # also time the K1 chain, K1's
                                      # Schur step and K2 (k=1 and the
                                      # panels) of another
                                      # checkout of this repository,
                                      # unpacked into DIR inside this one
                                      # (it builds its kernels there), in
                                      # turns with this one's
    python3 chip_smoke.py --save-h1 FILE.npz   # also: write the n=32 H1
                                      # comparison's arrays (about 18 MB)

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or
``/usr/local/cuda/bin``); imports nothing of JAX.  Phases, one summary line
each:

1. device: the card, and its name and power limit from ``nvidia-smi``;
2. build: the hand-written kernels K1-K4 compiled from ``csrc/`` (one nvcc
   process per source, in parallel);
3. kernels: K1 (``banded_factorize``) and K2 (``banded_solve``) against their
   plain PyTorch versions on confusion bands at nx=64 (N=256, nb=s=65,
   k=1 and k=100) in float32 and float64, with residuals and timings; K1's
   row-panel design at s=65 against the chain and the plain version; a
   ``K1 designs`` line per dtype at N=256 and at the main path's N=1024
   (the chain, the rows, with ``--parent`` that checkout's chain; each
   held against the plain version
   and the chain against the rows, then timed in turns, beside the bound
   and the design that ``design=None`` takes; the same at every K1 shape
   of the lanes in phases 5-7); a ``K2 clusters`` line per orientation of
   the k=1 solve (the streamed design with one thread block per sample,
   with the number ``stream_cluster`` picks and with its neighbours among
   1, 2, 3, 4, 6, 8, each held against the plain version, then timed in
   turns with the plain version and, with ``--parent``, that checkout's
   K2, beside the bound; the same at s=193 (N=16 and 32), at each coarse
   level and at s=516 in both dtypes); a ``K2 panels`` line per dtype
   and orientation of the k=100 solve (the panel design at the geometry
   ``panel_geometry`` picks and at one column tile fewer and one more,
   each held against the plain version, then timed in turns with the
   plain version and, with ``--parent``, that checkout's K2, beside the
   bound; the same transposed at s=193 and at s=516, k=200, both dtypes);
4. inverses: K3 and K4 (``batched_inverse``) against their plain version on
   the prior's cyclic-reduction blocks at nx=64 (N=32, s=65) and nx=192
   (N=96, s=193), both dtypes, with the identity residual and timings; K3
   timed at one thread block per matrix and at 2, 4, 6, 8 and the picked
   number (``gj_cluster``), in turns, beside ``torch.linalg.inv`` and the
   bound (a ``K3 clusters`` line; the same at each later cyclic-reduction
   level of nx=192, N=48 down to 1, and at s=193 and s=516 below);
5. s=193: K1 (row panels) and K2 (k=1 streamed, and k=100 transposed
   through panels, with a ``K2 panels`` line) against their plain versions
   on Newton bands of nx=192 (N=16,
   nb=s=193), both dtypes, with residuals and timings; K3 as K1's rows call
   it, on one block row of an (N, 8, s, s) buffer at N=32 and 16 (the
   other rows must come out untouched), at each cluster size; ``K1 Schur``
   lines at N=16 (both dtypes) and 32 (float32): K1's Schur step alone at
   block rows 0 and 5, held against the plain step (the other rows must
   come out untouched), then timed in turns with the plain step and the
   library pair (``torch.bmm`` + ``torch.baddbmm``, TF32 off), beside the
   bound; with ``--parent`` also the profiler's time per launch of that
   checkout's Schur kernel and of this one's, in their row designs;
6. coarse grids: K1 and K2 (k=1) against their plain versions on the
   Newton bands of the grid-sequencing levels, s=33 and 17 (N=1024, the
   nx=64 chunk) and s=97, 49 and 25 (N=32, the nx=192 chunk), both dtypes;
7. s=516: K1 (row panels: Schur step + K3 per block row), K2 (k=1
   streamed, both directions; k=200 transposed through panels, with a
   ``K2 panels`` line) and K3 on the helmholtz lane's own bands (N=16,
   nb=52), both dtypes,
   against the pivoted plain versions: K1 against plain, max|T T^-1 - I|
   of K3 and of ``torch.linalg.inv`` on the same Schur complements, and
   ||Ax - b|| / ||b|| through K1+K2 and through the plain pair, K3's
   within 10x of the pivoted ones; timings, K3 at each cluster size; a
   ``K1 Schur`` line per dtype;
8. parity: the float64 pipeline on ``.bench/parity_ref.npz`` against the
   stored reference spectrum (relative error <= 1e-8 over eigenvalues above
   1e-4 lambda_0), with the dense prior and again with the structured one;
9. main path: the float32 input active subspace of confusion at nx=64 with
   the steady Navier-Stokes velocity, 1024 prior samples, rank 100,
   oversampling 10, through ``ActiveSubspaceProjector``, grid-sequenced
   (depth 2: coarse levels nx=32 and 16 on the restricted velocity, as
   ``bench.py`` builds them), and once more cold-started for comparison;
    then ``bench.py``'s forward-utilization probe: ``mfu_report``
    (``utils/profiling.py``) over ``solve_fwd`` of 256 prior samples, and
    ``forward_tflops`` / ``forward_mfu`` and ``forward_hbm_gbs_model`` /
    ``forward_hbm_util_model`` from the analytic inverse-Thomas models
    (``thomas_inv_flops`` / ``thomas_inv_bytes``, one factorization and
    one k=1 solve per sample and Newton iteration), both shares in (0, 1];
9b. training: ``bench.py``'s training lane on the main path's
    grid-sequenced run (its samples and decoder; ``training_lane``): the
    output POD from data, DIPNet 8 x 16 (1924 parameters), 512 / 512
    samples, one warm sweep and 20 inexact Newton-CG sweeps, with the
    checks that every number is finite, the loss falls and the final
    validation accuracy is at least 0.75; one float64 sweep on the card
    against the same sweep on the CPU (parameters within 1e-8); DIPNet
    and DIPResNet at 32 training samples with l2 and with the normalized
    H1 loss on the Jacobian sketches J^T Phi, 40 sweeps for each of the
    weight seeds 0-4, the mean gap logged;
9c. setup: the setup driver's lane (``confusion_setup.setup_lane``) in
    float32 at its defaults on the main path's observable and prior (512
    samples and data, rank 128, POD rank 100, Jacobian rank 128, the error
    tests at ranks 8-128 with 50 samples), then ``DataGenerator`` (512
    samples, the J^T Phi sketches of the POD decoder), into a temporary
    directory read back through ``confusion_training``; one ``setup`` line
    (stage seconds, Newton iterations, launches, peak memory, the batched
    SVD of the lane's Jacobians timed alone) and one of errors, with the
    checks: spectra finite and descending, max|V^T R V - I| and the mass
    KLE's max|V^T M V - I| <= 1e-3, the POD and output errors not rising
    with rank, the KLE and input errors at rank 128 below rank 8's, no
    discarded output sample, K1 and K2 launched; then the same lane in
    float64 at nx=16 on the card against the CPU from the same given
    noise (spectra and projectors within 1e-8);
9d. control: the nonlinear Poisson control problem of the reference's
    unit tests (``hippyflow_tpu_torch.testing``) at nx=ny=64 (4225 dofs,
    s=nb=65), 10 observations, 25 controls, float32, from one given
    noise: (1) ``auto`` (K1/K2): a POD decoder (rank 10), then
    ``DataGenerator.generate(512, derivatives=(1, 1))`` with it and
    ``construct_low_rank_control_Jacobians`` at rank 10; (2)-(4) the same
    (m, z) on ``block_cyclic`` (K3 at every cyclic-reduction level, the
    path ``control_cr``, its launches a multiple of levels + root),
    ``block_tridiag`` and ``dense`` (64 samples), q, J^T Phi and Jz^T Phi
    within 1e-3 of ``auto``; (5) ``iterative`` in float64 (16 samples)
    within 1e-6 of the direct float64 solve, with the worst
    ``solve_info`` residual; (6) the grid renumbered without a
    structured shape on ``dense`` and ``iterative`` (forward solves, q
    against the structured runs'); (7) ``auto`` on nx=8, ny=300 (s=9,
    nb=301), where it takes cyclic reduction for the adjoint factor and
    ``thomas_inv`` forward, J and Jz against an explicit ``thomas_inv``
    run; (8) K3 against its plain version, ``torch.linalg.inv`` and the
    bound at every cyclic-reduction shape of (2) and (7), and K1 and K2
    against theirs at every shape that (1) and (7) gave them (on the
    solved bands, seeded right-hand sides, K2's residual), both dtypes,
    float32 times beside the bound;
    (9) steps 1 and 2 in float64 at nx=16 on the card against the CPU
    (limit 1e-8).  Each step's launches are one path of the JSON line;
9e. models: the rest of the modeling layer, float32, at the main path's
    width (confusion and the Poisson control problem at nx=64), each item
    one path: (1) ``ModelWrapper`` on confusion (data at rel_noise 0.01;
    on 64 samples the costs, the gradients, the GN Hessian on 16
    directions with its symmetry, the rank-20 Jacobian against the dense
    one; the float64 gradient against a central difference, 4 samples);
    (2) ``MultiPDEProblem`` of 4 Poisson problems with fixed controls as
    sources, 10 observations, 64 samples (each problem alone, the control
    problem at that control, q the sum, a Jacobian dot test); (3) the
    full-state input subspace (``StateSpaceIdentityOperator``, 64 samples,
    rank 40) batched matrix-free, serialized in chunks of 16 and as the
    unpreconditioned HEP, with ``materialize`` refused, the spectra of the
    first two within 1e-4 and the serialized peak memory below the
    batched; (4) ``test_errors_double_loop`` on confusion at ranks 8, 32,
    100 with 32 x 4 samples, not rising with rank, in float64 (float32
    Newton's stopping residual puts a floor under the error that ranks 32
    and 100 both reach); (5)
    ``two_step_generate(256, pod_rank=32, derivatives=(1, 1))`` in chunks
    of 16, in float64 (float32 misses its ||Psi^* Psi - I|| < 1e-5 check;
    K2 at k=4225); (6) the boundary KLE, the Laplacian prior and its KLE,
    ``two_state_solution`` and the CSR matrices, constrained Newton at
    nx=32 in float64 on the card and on the CPU (same iterations and
    reason, 1e-10); then K1 and K2 at every shape of (1)-(5) against their
    plain versions in both dtypes (``k12_shape_records``) and (1)-(5) in
    float64 at nx=16 on the card against the CPU (limit 1e-8);
9f. drivers: the application drivers as a user runs them, each step one
    path: (1) ``ns_nx64``: ``steady_navier_stokes`` at nx=64 in float64
    (12675 dofs, s=195, nb=65: K1's rows on an indefinite nonsymmetric
    saddle-point band, unpivoted), the Newton iterations per Reynolds
    number, within 1e-6 of the JAX package's field
    (``.bench/ns_velocity_nx64.npy``), K1's rows, the Schur step, K3 and
    K2 launched; (2) ``confusion_setup_nx32_ns``: ``confusion_setup.main``
    at nx=32 with ``--velocity ns`` in float32 (no field is cached there,
    so the driver solves Navier-Stokes at s=99), its files; on the bands of
    both solves, K1 and K2 at every shape against their plain versions
    (K2's residual within 10x of the pivoted plain pair's), ``K1 designs``
    and ``K1 Schur`` lines, and K3's max|T T^-1 - I| on the Schur
    complements within 10x of ``torch.linalg.inv``'s, with a ``K3
    clusters`` line; (3) ``helmholtz_setup``: the driver at its defaults
    with ``--error_test`` (nx=64, 600 Hz, 32 samples, 512 data, rank 128,
    float64), stage seconds, launches, peak memory above its start, the
    JAX driver's layout, orthonormality <= 1e-3, errors not rising with
    rank, nothing discarded, and whether plots were written (none without
    matplotlib); (4) ``helmholtz_setup_laplacian``: the same with
    ``--laplacian_prior --n_data 64``; (5) ``helmholtz_training``:
    ``as_resnet`` on (3)'s output, 20 AdamW epochs and 3 Newton-CG
    epochs, s/epoch and val acc, the loss falling, all finite; (6)
    ``helmholtz_multirun``: 2 data sizes x 1 seed x 5 epochs, then the
    same call, which trains nothing; then float64 card against CPU:
    Navier-Stokes at nx=16 (limit 1e-10) and the helmholtz setup lane at
    nx=10 from one given noise (limit 1e-8);
9g. p2: a scalar P2 state, the JAX package's P2 fixture (flux exp(m) grad
    u, source u^3 - 1, u = 0 on the boundary) at nx=64 (16641 dofs, s=258,
    nb=65; P1 parameter, the main path's dense prior and 100
    observations), each step one path: (1) ``p2``: the float32 input
    active subspace, 256 samples, rank 128, chunks 32 / 16 (stage seconds
    from the projector's ``PhaseTimer``, each stage an ``annotate``
    range), K1's rows, the Schur step, K3 and K2 both designs launched,
    the float32 Jacobian against float64 for 2 samples (limit 1e-4), the
    run under ``utils.profiling.trace`` (the device busy share and the
    Chrome trace's size); (2) ``p2_f64``: the Poisson problem with
    u = x^2 on the boundary at nx=64 (x^2 to 1e-9), the L2 error's rate at
    nx=16, 32, 64 (above 2.7), and the float64 subspace at nx=16 on the
    card against the CPU from one given noise (1e-8); then K1 and K2 at
    N=16 and 32 (K2 streamed k=1 and panels k=100 transposed) against
    their plain versions in both dtypes, K1's rows (``K1 designs``), its
    Schur step beside the library pair (``K1 Schur``) and K3 on one block
    row's Schur complements (32, 258) against plain, ``torch.linalg.inv``
    and the bound (``K3 clusters``);
9h. parallel: a one-rank NCCL group (``parallel.initialize_distributed``
    through a FileStore in a temporary directory, destroyed at the end),
    its (1, 1) ('sample', 'fem') mesh and a ``DeviceCollective`` over
    'sample', each step one path: (1) ``parallel_spike``: the partitioned
    SPIKE factor (``factorize_distributed_banded``, both directions) at
    P=4 and 8 partitions on the main path's Newton bands (N=1024 float32,
    N=256 float64; 65 rows padded to 68 and 72), its solves at k=1 and
    k=100, forward and transposed, held against K1+K2 (relative residual
    against the float64 band, and the difference), the factor and solve
    times beside K1's and K2's, and K3 against its plain version,
    ``torch.linalg.inv`` and the bound at every cyclic-reduction shape of
    the partitions (``K3 spike_p4_l`` / ``spike_p8_l`` lines); (2)
    ``parallel_parity``: the float64 parity pipeline through
    ``solver="dist_banded"``, the dof-sharded structured prior (``mesh=``)
    and the collective (limit 1e-8); (3) ``parallel_nx64``: the float32
    main path, cold, through ``dist_banded`` and the collective (samples
    and Jacobians in chunks of 256, each cold-started), stage seconds,
    Newton, resampled failures, peak memory and the spectrum beside
    ``auto``'s cold run of phase 9 (other draws: the chunks draw apart), and
    K1/K2/K3 launches; (4) ``parallel_prior192``: the nx=192 structured
    prior with P=4 unplaced SPIKE factors and built dof-sharded
    (``dist_assemble_band``), 256 samples and ``Rsolver_matmat`` against
    the float64 unsharded prior (float32: within 10x of the float32
    unsharded prior's own distance), and K3 at its partitions' shapes
    (``K3 prior192_p4_l`` lines);
10. nx=192 lane: the same at nx=192 (37249 dofs, the structured prior),
    256 samples, rank 128, oversampling 10, chunk 32, Jacobian chunk 16,
    grid-sequenced at depth 3 (nx=96, 48, 24), and cold-started; then the
    structured prior's build alone, with K3 at the picked cluster size and
    at one block per matrix, in turns;
11. helmholtz lane: the float32 input active subspace of the split-complex
    P2 helmholtz problem at nx=64 (ny=51), 600 Hz (26574 dofs, s=516,
    nb=52), dense BiLaplacian prior (gamma=1, delta=5, 3380 dofs),
    32 samples, rank 128, oversampling 10, chunk 16, through the fused
    pass; for 2 samples the float32 Jacobian against the same samples
    run through the kernels in float64;
12. surface, in three parts: (a) ``bench.py``'s save stage, once at nx=64
    after 9b (the main path of phase 9, grid-sequenced, one chunk of 1024)
    and once at nx=192 in phase 10 (the lane's settings, eight chunks of
    32): the forward stage, then ``confusion_mq_data.npz`` written on a
    thread while the Jacobian and GHEP stages run, then
    ``AS_input_decoder.npy``, with the seconds the writer waits for its
    copy of (m, q) and that copy alone against the stages (the most the
    JAX package's host prefetch could hide; not a counted path);
    (b) ``surface_jt``, run after 11 on its observables:
    ``ObservableJacobian.transpmult`` through a ``ComponentObservation``
    of the real component of the helmholtz state (s=516) for 4 of the
    lane's samples, float32, against ``materialize(lin).mT @ dq`` (limit
    1e-4), and in float64 for 2 samples (limit 1e-10) and against the
    same product on the CPU (limit 1e-8); K1's rows, the Schur step, K3
    and K2 launched; (c) ``surface_vector``, after (b) on the same
    observables: the lane's problem with a P2 parameter space and a copy
    of its form scaled by an all-ones P1 dof-valued coefficient
    (``coefficients``), at the P2 interpolant of the lane's samples, the
    same J^T for the lane's chunk of 16 in float32 and for 2 samples in
    float64 with the same limits, and the float64 band against the lane's
    own band at the P1 samples (limit 1e-12); K1's rows, the Schur step,
    K3 and K2 launched.

Then a JSON line describing the kernels (``launches`` is the sum over the
paths, which are each driven with the counts set to 0 just before and
read just after; ``launches_by_path`` splits it; ``bound_ms`` is the least
time the card could take for a call at that shape, from its operations at
the peak rate of its type and its bytes at the memory rate, whichever is
larger, ``bound_by`` says which; ``library_ms`` is ``torch.linalg.inv``'s
time for K3/K4 and null for K1/K2, which no single PyTorch call
computes; K1's Schur step, under ``banded_factorize.schur``, has its
launches on each path and at each shape its time, the plain step's, the
library pair's and the bound; K2's launches by design, panels and
streamed, on each path, and its ``K2 panels`` records under
``banded_solve.panels``), and last the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without printing the result line.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the kernels' bounds on one H100 SXM (operations at 67 TFLOP/s in float32
# and float64, bytes at 3.35 TB/s)
from hippyflow_tpu_torch.utils.profiling import (  # noqa: E402
    bound_keys,
    k1_bound,
    k2_bound,
    k3_bound,
    schur_bound,
)

NX = 64
N_BAND = 256  # samples of the kernel phase
N_SAMPLES = 1024  # main path (bench.py's default)
RANK, OVERSAMPLING = 100, 10
SEED = 0
# the nx=192 lane of bench.py (NX192_*, chunk_default, jac_chunk_default)
NX192, N192_SAMPLES, RANK192 = 192, 256, 128
CHUNK192, JAC_CHUNK192 = 32, 16
N_BAND192 = 16  # samples of the s=193 kernel phase
# grid-sequencing depth of bench.py's lanes (coarse levels below the fine)
GRIDSEQ_DEPTH = {NX: 2, NX192: 3}
# the helmholtz lane of bench.py (run_helmholtz_lane)
HELM_NX, HELM_FREQ = 64, 600.0
HELM_SAMPLES, HELM_RANK, HELM_CHUNK = 32, 128, 16
N_BAND_HELM = HELM_CHUNK  # samples of the s=516 kernel phase
# K3's identity residual and the K1+K2 solve residual on the helmholtz
# bands (indefinite, no pivoting) may exceed the pivoted plain versions'
# by at most this factor.  For the identity residual, 32 samples of these
# bands on the CPU gave 1.0-4.8x (float64) and 1.4-8.8x (float32) sample by
# sample; on an H100 the worst of 16 samples' 832 blocks was 2.3x and 4.2x
PIVOT_FACTOR = 10.0
# the float32 helmholtz Jacobian against the same samples in float64,
# relative to max|J|
JAC_TOL_F32 = 1e-4
# the later block row at which K1's Schur step is checked and timed alone
SCHUR_ROW = 5
# thread blocks per matrix at which K3 is timed beside 1 and the picked one
K3_CLUSTERS = (2, 4, 6, 8)
# thread blocks per sample of K2's streamed design: it is timed at 1, at the
# picked number and at the picked number's neighbours among these
K2_CLUSTERS = (1, 2, 3, 4, 6, 8)

# Kernel against plain version, relative to the largest plain entry, and
# relative residuals ||A x - b|| / ||b|| of the kernels' solves (taken in
# float64 against the float64 band).  float64: Gauss-Jordan without
# pivoting (kernel) and pivoted LU (plain) round differently, by a few ulps
# times the growth of the 65-row chain.  float32: accumulation is plain
# IEEE float32 (no TF32); the plain float32 factorization of these bands
# differs from the float64 one by 7e-7 (K1) and 4e-6 (K2), and leaves a
# residual of 1.3e-6 (measured on the CPU), so 1e-4 leaves a margin of 25x.
TOL = {
    torch.float64: {"diff": 1e-11, "residual": 1e-12},
    torch.float32: {"diff": 1e-4, "residual": 1e-4},
}
# max |V^T R V - I| of the float32 decoder: R = K M^-1 K is ill conditioned,
# and CholQR2 in float32 kept R-orthonormality to 2.4e-5 at 32 samples on
# the CPU; 1e-3 flags a broken orthogonalization
ORTHO_TOL_F32 = 1e-3
# K3/K4 against their plain version (the same Gauss-Jordan in PyTorch
# operations, summed in another order), relative to the largest plain
# entry, and the identity residual max|X X^-1 - I| on the prior's
# cyclic-reduction blocks (SPD and diagonally dominant); the first chip
# runs measured 5e-9 and 1.3e-7 in float32, 1.5e-16 and 6.7e-16 in float64
TOL_INV = {
    torch.float64: {"diff": 1e-12, "residual": 1e-12},
    torch.float32: {"diff": 1e-5, "residual": 1e-4},
}
# bench.py's training lane (run_training_lane): the first 1024 samples of
# the main path split 512 / 512, DIPNet with input rank 8 and output rank
# 16, one warm sweep then 20 Newton-CG sweeps
TRAIN_N, TRAIN_SWEEPS, TRAIN_IN_RANK, TRAIN_OUT_RANK = 1024, 20, 8, 16
# the JAX lane's validation accuracy on its own samples was 0.79-0.81
# (BENCH_r03/r04.json); an accuracy, not a speed figure
TRAIN_MIN_VAL_ACC = 0.75
# one float64 Newton-CG sweep on the card against the same sweep on the
# CPU (the first 64 samples): the parameters, relative to the largest.
# One sweep only: past the loss of orthogonality CG amplifies rounding,
# so two summation orders part beyond any tolerance after a few sweeps
TRAIN_F64_N, TRAIN_F64_TOL = 64, 1e-8
# the few-data comparison of ACCURACY.md (n=32): 32 training samples
# against the fixed held-out block of samples 512-1023, the output POD
# from samples 0-511; 40 sweeps and weight seeds 0-4, as
# benchmarks/accuracy_sweep.py sets them for n <= 256
H1_N_TRAIN, H1_N_POOL, H1_SWEEPS, H1_SEEDS = 32, 512, 40, (0, 1, 2, 3, 4)
# the setup driver's defaults (applications/confusion_setup.py): 512
# samples and data, rank 128 (POD rank min(128, dQ) = 100), oversampling
# 10, Jacobian rank 128, 50 error-test samples; then 512 samples of
# DataGenerator with the POD decoder (the JstarPhi sketches)
SETUP_N, SETUP_RANK, SETUP_ERROR_SAMPLES = 512, 128, 50
# the float64 setup on the card against the CPU from the same given noise,
# at nx=16 (rank 16, 32 samples and data, 8 error-test samples): every
# spectrum above 1e-4 lambda_0 and every basis's projector (relative)
SETUP_CHECK_NX, SETUP_F64_TOL = 16, 1e-8
# the repaired J^T on the helmholtz bands: samples in float32 and float64,
# columns of dq; the float32 product against the materialized one is held
# to JAC_TOL_F32, the float64 one to JT_TOL_F64 and to the CPU's to
# JT_CPU_TOL (relative to the largest entry)
JT_SAMPLES, JT_SAMPLES_F64, JT_COLUMNS = 4, 2, 3
JT_TOL_F64, JT_CPU_TOL = 1e-10, 1e-8
# the vector form with a P2 parameter space and a unit P1 dof-valued
# coefficient: at the P2 interpolant of the lane's (P1) m its float64 band
# is the lane's own to this (relative to the largest entry)
VECTOR_BAND_TOL = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (one warm-up)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def paired_ms(kernel, plain, reps: int = 5):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p0 = cuda_ms(plain, reps)
    k0 = cuda_ms(kernel, reps)
    k1 = cuda_ms(kernel, reps)
    p1 = cuda_ms(plain, reps)
    return 0.5 * (k0 + k1), 0.5 * (p0 + p1)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_k3_clusters(X, label, row=None, reps=5):
    """K3 at one thread block per matrix and at each count of K3_CLUSTERS
    and the picked one (``gj_cluster``), each count timed in turns with 1
    (1, c, c, 1), with ``torch.linalg.inv`` and the bound beside them.  X
    (N, s, s); or, with ``row``, an (N, nb, s, s) buffer whose block row
    ``row`` K3 inverts in place as K1's row design calls it, where every
    count's result is held against the plain version and the other rows
    must come out untouched.  Without ``row`` every count's result is held
    against one block's.  Returns the record for the kernels' JSON line."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    dtype = X.dtype
    tol = TOL_INV[dtype]["diff"]
    if row is None:
        N, s, _ = X.shape

        def run(c):
            return hk.batched_inverse(X, cluster=c)

        def inv():
            return torch.linalg.inv(X)
    else:
        N, nb, s, _ = X.shape
        before = X.clone()

        def run(c):
            return hk.batched_inverse_row_(X, row, cluster=c)

        def inv():
            return torch.linalg.inv(X[:, row])
    picked = hk.gj_cluster(N, s, hk._sm_count(X.device))
    counts = sorted((set(K3_CLUSTERS) | {picked}) - {1})
    if row is None:
        ref = run(1)
        for c in counts:
            diff = rel_err(run(c), ref)
            check(diff <= tol, f"K3 {label} c={c}: against c=1 {diff:.3e}")
    else:
        want = hk.batched_inverse_plain(before[:, row].contiguous())
        for c in (1, *counts):
            X.copy_(before)
            run(c)
            torch.cuda.synchronize()
            diff = rel_err(X[:, row], want)
            check(diff <= tol, f"K3 {label} c={c}: against plain {diff:.3e}")
            others = [q for q in range(nb) if q != row]
            check(torch.equal(X[:, others], before[:, others]),
                  f"K3 {label} c={c}: other block rows changed")
    ms, ms1 = {}, []
    for c in counts:
        ms[c], t1 = paired_ms(lambda c=c: run(c), lambda: run(1), reps)
        ms1.append(t1)
    ms[1] = sum(ms1) / len(ms1)
    inv_ms = cuda_ms(inv, reps)
    b_ms, b_by = k3_bound(N, s, dtype)
    log(f"K3 clusters {label} {str(dtype)[6:]} N={N} s={s}: "
        + ", ".join(f"c={c} {ms[c]:.4f} ms" for c in sorted(ms))
        + f"; picked c={picked} ({ms[1] / ms[picked]:.2f}x c=1); "
        f"torch.linalg.inv {inv_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    return {"cluster": picked, "ms": ms[picked],
            **{f"ms_c{c}": v for c, v in sorted(ms.items())},
            "inv_ms": inv_ms, "bound_ms": b_ms, "bound_by": b_by}


def k2_clusters(M, Dinv, B, bb, trans, label, parent=None, reps=None):
    """K2's streamed design on one factor and rhs (k < 8) with one thread
    block per sample, with the number ``stream_cluster`` picks and with
    that number's neighbours in K2_CLUSTERS, each held against the plain
    version within TOL, then timed in turns (the list forwards, then
    backwards) with the plain version and (``parent``) the K2 of an
    earlier checkout, beside the bound; ``reps`` launches a timing (None:
    3, and 30 below s=100, where a launch lasts about 0.1 ms).  Returns the
    record for the kernels' JSON line."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    N, nb, s, _ = M.shape
    k, dtype = bb.shape[-1], bb.dtype
    if reps is None:
        reps = 3 if s >= 100 else 30
    picked = hk.stream_cluster(N, s, hk._sm_count(bb.device))
    below = [c for c in K2_CLUSTERS if c < picked][-1:]
    above = [c for c in K2_CLUSTERS if c > picked][:1]
    counts = sorted(c for c in {1, picked, *below, *above} if c <= s)
    x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
    worst = 0.0
    for c in counts:
        x = hk.banded_solve(M, Dinv, B, bb, trans, cluster=c)
        torch.cuda.synchronize()
        diff = rel_err(x, x_p)
        check(diff <= TOL[dtype]["diff"],
              f"K2 clusters {label} {dtype} trans={trans} c={c}: against "
              f"plain {diff:.3e}")
        worst = max(worst, (x - x_p).abs().max().item())
    del x, x_p
    runs = {f"c={c}": (lambda c=c: hk.banded_solve(M, Dinv, B, bb, trans,
                                                    cluster=c))
            for c in counts}
    runs["plain"] = lambda: hk.banded_solve_plain(M, Dinv, B, bb, trans)
    if parent is not None:
        runs["parent"] = lambda: parent.banded_solve(M, Dinv, B, bb, trans)
    ms = {key: [] for key in runs}
    for keys in (list(runs), list(runs)[::-1]):
        for key in keys:
            ms[key].append(cuda_ms(runs[key], reps))
    ms = {key: sum(v) / len(v) for key, v in ms.items()}
    best = min((key for key in ms if key.startswith("c=")), key=ms.get)
    b_ms, b_by = k2_bound(N, nb, s, k, dtype)
    log(f"K2 clusters {label} {str(dtype)[6:]} N={N} nb={nb} s={s} k={k} "
        f"{'transposed' if trans else 'forward'}: "
        + ", ".join(f"{key} {v:.4f} ms" for key, v in ms.items())
        + f"; picked c={picked} ({ms['c=1'] / ms[f'c={picked}']:.2f}x c=1, "
        f"{ms[f'c={picked}'] / ms[best]:.3f}x the fastest, {best}); bound "
        f"{b_ms:.4f} ms ({b_by}); max abs err {worst:.3e}")
    return {"picked": picked, "fastest": best, "ms": ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst}


def k2_panels(M, Dinv, B, bb, trans, label, parent=None, reps=2):
    """K2's panel design on one factor and rhs (k >= 8) at the geometry
    ``panel_geometry`` picks and at its neighbours in column tiles (the
    same rule at one tile fewer and one more, where they fit), each held
    against the plain version within TOL, then timed in turns (the list
    forwards, then backwards) with the plain version and (``parent``) the
    K2 of an earlier checkout, beside the bound.  Returns the record for
    the kernels' JSON line."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    N, nb, s, _ = M.shape
    k, dtype, dev = bb.shape[-1], bb.dtype, bb.device
    args = (N, s, k, bb.element_size(), hk._sm_count(dev), hk._smem_limit(dev),
            hk._sm_smem(dev))
    picked = hk.panel_geometry(*args)
    geos = {}
    for t in (picked.tiles - 1, picked.tiles, picked.tiles + 1):
        g = picked if t == picked.tiles else (
            hk.panel_geometry(*args, tiles=t) if 1 <= t <= k else None)
        if g is not None:
            geos[f"t={g.tiles} R={g.rows} rt={g.row_tile} ls={g.lsplit}"] = g
    x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
    worst = 0.0
    for key, g in geos.items():
        x = hk.banded_solve(M, Dinv, B, bb, trans,
                            tiles=(g.rows, g.tiles, g.row_tile, g.lsplit))
        torch.cuda.synchronize()
        diff = rel_err(x, x_p)
        check(diff <= TOL[dtype]["diff"],
              f"K2 panels {label} {dtype} trans={trans} {key}: against plain "
              f"{diff:.3e}")
        worst = max(worst, (x - x_p).abs().max().item())
    del x, x_p
    runs = {key: (lambda g=g: hk.banded_solve(
        M, Dinv, B, bb, trans, tiles=(g.rows, g.tiles, g.row_tile, g.lsplit)))
        for key, g in geos.items()}
    runs["plain"] = lambda: hk.banded_solve_plain(M, Dinv, B, bb, trans)
    if parent is not None:
        runs["parent"] = lambda: parent.banded_solve(M, Dinv, B, bb, trans)
    ms = {key: [] for key in runs}
    for keys in (list(runs), list(runs)[::-1]):
        for key in keys:
            ms[key].append(cuda_ms(runs[key], reps))
    ms = {key: sum(v) / len(v) for key, v in ms.items()}
    pick = f"t={picked.tiles} R={picked.rows} rt={picked.row_tile} ls={picked.lsplit}"
    best = min(geos, key=ms.get)
    b_ms, b_by = k2_bound(N, nb, s, k, dtype)
    log(f"K2 panels {label} {str(dtype)[6:]} N={N} nb={nb} s={s} k={k} "
        f"{'transposed' if trans else 'forward'}: "
        + ", ".join(f"{key} {v:.4f} ms" for key, v in ms.items())
        + f"; picked {pick} ({picked.threads} threads, {picked.smem_bytes} "
        f"bytes, {picked.share} blocks an SM; {ms[pick] / ms[best]:.3f}x the "
        f"fastest, {best}); bound {b_ms:.4f} ms ({b_by}); max abs err "
        f"{worst:.3e}")
    return {"picked": picked._asdict(), "fastest": best, "ms": ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": worst}


def load_parent(path):
    """The kernel module of another checkout of this repository (``--parent
    DIR``: its ``hippyflow_tpu_torch/ops/hopper_kernels.py``, which builds
    its own sources into its own directory), for timing an earlier design
    in turns with this one.  DIR must lie inside this checkout: nothing is
    written around it."""
    from hippyflow_tpu_torch.ops.stream_solve_sweep import load_parent as load

    path = os.path.realpath(path)
    if os.path.commonpath([path, os.path.realpath(REPO)]) != os.path.realpath(REPO):
        raise SystemExit(f"--parent {path}: not inside {REPO}")
    return load(path)


def k1_designs(band64, label, parent=None, dtypes=(torch.float32, torch.float64),
               reps=3):
    """K1's designs on one band: the chain where the shape takes it, the
    rows, and (``parent``) the chain of an earlier checkout, each held
    against the plain version (and the chain against the rows) within TOL,
    then timed in turns (the list forwards, then backwards), beside the
    bound and the design that ``design=None`` takes.  Returns
    {dtype name: {...}} for the kernels' JSON line."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    N, nb, s, _ = band64.shape
    limit = hk._smem_limit(band64.device)
    out = {}
    for dtype in dtypes:
        name, tol = str(dtype)[6:], TOL[dtype]["diff"]
        band = band64.to(dtype)
        item = band.element_size()
        runs = {"rows": lambda: hk.banded_factorize(band, design="rows")}
        if parent is not None and (5 * s * s + 2 * s + 1) * item <= limit:
            runs["parent chain"] = lambda: parent.banded_factorize(band, design="chain")
        picked, _ = hk.factorize_design(s, item, limit)
        if hk.chain_geometry(s, item, limit) is not None:
            runs["chain"] = lambda: hk.banded_factorize(band, design="chain")
        M_p, D_p = hk.banded_factorize_plain(band)
        scale = D_p.abs().max().item()
        worst, rows = 0.0, None
        for key, fn in runs.items():
            M, Dinv = fn()
            torch.cuda.synchronize()
            err = max((M - M_p).abs().max().item(), (Dinv - D_p).abs().max().item())
            check(err <= tol * scale and not M[:, 0].any(),
                  f"K1 {label} {name} {key}: against plain {err / scale:.3e}")
            worst = max(worst, err)
            if key == "rows":
                rows = (M, Dinv)
            elif key == "chain":
                diff = max(rel_err(M, rows[0]), rel_err(Dinv, rows[1]))
                check(diff <= tol, f"K1 {label} {name} {key}: against rows {diff:.3e}")
            del M, Dinv
        del rows, M_p, D_p
        ms = {key: [] for key in runs}
        order = list(runs)
        for keys in (order, order[::-1]):
            for key in keys:
                ms[key].append(cuda_ms(runs[key], reps))
        ms = {key: sum(v) / len(v) for key, v in ms.items()}
        best = min((k for k in ms if k != "parent chain"), key=ms.get)
        b_ms, b_by = k1_bound(N, nb, s, dtype)
        log(f"K1 designs {label} {name} N={N} nb={nb} s={s}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; bound {b_ms:.4f} ms ({b_by}); picked {picked} "
            f"({ms[picked]:.4f} ms), fastest {best}; max abs err {worst:.3e}")
        out[name] = {"ms": ms, "picked": picked, "fastest": best,
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": worst}
    return out


def k1_schur(band64, label, parent=None, dtypes=(torch.float32, torch.float64),
             j=SCHUR_ROW, reps=10):
    """K1's Schur step alone (``schur_step_``) on one band, in each dtype,
    at block rows 0
    and j: held against the plain step (``schur_step_plain`` on the same
    Dinv_{j-1}, the float64 plain factorization of the rows before j)
    within TOL, every other row of M and Dinv untouched; then at row j
    timed in turns (the list forwards, then backwards; device time,
    ``schur_sweep.device_ms``) with the plain step and the library pair
    (``torch.bmm`` + ``torch.baddbmm``, TF32 off: a yardstick the port
    never calls), beside the bound; with ``parent``, the profiler's time
    per launch of the parent's Schur kernel (any name that holds
    ``schur_``) in its row design on
    the band's first rows, in turns with this checkout's kernel read the
    same way.  Returns {dtype name: record} for the kernels' JSON line."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.schur_sweep import (
        device_ms,
        kernel_ms,
        library_pair,
    )

    N, _, s, _ = band64.shape
    sub64 = band64[:, : j + 2].contiguous()  # row j + 1 must stay untouched
    _, D64 = hk.banded_factorize_plain(band64[:, :j].contiguous())
    gen = torch.Generator(device=band64.device).manual_seed(SEED)
    out = {}
    for dtype in dtypes:
        name, tol = str(dtype)[6:], TOL[dtype]["diff"]
        band = sub64.to(dtype)
        threads, smem = hk.schur_geometry(s, band.element_size(),
                                          hk._smem_limit(band.device))
        M, Dinv = (torch.randn(N, j + 2, s, s, generator=gen, dtype=dtype,
                               device=band.device) for _ in range(2))
        Dinv[:, j - 1] = D64[:, j - 1].to(dtype)
        worst = 0.0
        for row in (0, j):
            M0, D0 = M.clone(), Dinv.clone()
            hk.schur_step_(band, M, Dinv, row)
            M_p, T_p = hk.schur_step_plain(band, D0[:, row - 1] if row else None,
                                           row)
            torch.cuda.synchronize()
            err = max((M[:, row] - M_p).abs().max().item(),
                      (Dinv[:, row] - T_p).abs().max().item())
            scale = max(M_p.abs().max().item(), T_p.abs().max().item())
            others = [q for q in range(j + 2) if q != row]
            check(err <= tol * scale, f"K1 Schur {label} {name} j={row}: "
                  f"against plain {err / scale:.3e}")
            check(torch.equal(M[:, others], M0[:, others])
                  and torch.equal(Dinv[:, others], D0[:, others]),
                  f"K1 Schur {label} {name} j={row}: other block rows changed")
            worst = max(worst, err)
        del M0, D0
        runs = {"step": lambda: hk.schur_step_(band, M, Dinv, j),
                "plain": lambda: hk.schur_step_plain(band, Dinv[:, j - 1], j),
                "library": lambda: library_pair(band, Dinv[:, j - 1], j)}
        ms = {key: [] for key in runs}
        for keys in (list(runs), list(runs)[::-1]):
            for key in keys:
                ms[key].append(device_ms(runs[key], reps))
        ms = {key: sum(v) / len(v) for key, v in ms.items()}
        line = ", ".join(f"{key} {v:.4f} ms" for key, v in ms.items())
        rec = {"ms": ms["step"], "plain_ms": ms["plain"],
               "library_ms": ms["library"], "max_abs_err": worst,
               "threads": threads, "smem_bytes": smem}
        if parent is not None:
            rows4 = band[:, :4].contiguous()
            prof = {"parent": [], "rows": []}
            for who in ("parent", "rows", "rows", "parent"):
                mod, kernel = ((parent, "schur_") if who == "parent"
                               else (hk, "schur_tile_kernel"))
                prof[who].append(kernel_ms(
                    lambda: mod.banded_factorize(rows4, design="rows"), kernel,
                    skip=1)[0])
            rec["parent_ms"] = sum(prof["parent"]) / 2
            rec["profiled_ms"] = sum(prof["rows"]) / 2
            line += (f"; profiled per launch in the row design: parent "
                     f"{rec['parent_ms']:.4f} ms, this {rec['profiled_ms']:.4f} ms "
                     f"({rec['parent_ms'] / rec['profiled_ms']:.2f}x)")
        b_ms, b_by = schur_bound(N, s, dtype)
        rec.update(bound_ms=b_ms, bound_by=b_by)
        log(f"K1 Schur {label} {name} N={N} s={s} j={j}: {line}; bound "
            f"{b_ms:.4f} ms ({b_by}); {threads} threads a block; max abs err "
            f"{worst:.3e}")
        out[name] = rec
        del band, M, Dinv
    return out


def setup(dtype, device, nx=NX, with_prior=True):
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
        load_ns_velocity,
    )

    vel = load_ns_velocity(nx)
    obs, Vh = confusion_linear_observable(
        nx=nx, velocity=vel, dtype=dtype, device=device
    )
    prior = confusion_prior(Vh, dtype=dtype, device=device) if with_prior else None
    return obs, prior


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def newton_bands(obs64, prior64, n, device):
    """bc-symmetrized Newton bands (n, nb, s, 3s) in float64 at prior
    samples of m and at states u drawn from the same prior (the cubic term
    is live)."""
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_from_mask

    pde = obs64.problem
    gen = torch.Generator(device=device).manual_seed(SEED)
    xi = torch.randn(2 * n, prior64.noise_dim, generator=gen,
                     dtype=torch.float64, device=device)
    ms = prior64.sample(xi)
    band = bc_symmetrize_banded_from_mask(
        pde.bound.assemble_A_banded(ms[n:], ms[:n]), pde.bc
    ).contiguous()
    return band, gen


def phase_kernels(obs64, prior64, device, parent=None):
    """K1/K2 against their plain versions at the main path's shapes, and
    K1's designs at N=256 and at the main path's N=1024 (the 256 bands
    four times over, float32)."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    band64, gen = newton_bands(obs64, prior64, N_BAND, device)
    N, nb, s, _ = band64.shape
    rhs64 = {
        k: torch.randn(N, nb, s, k, generator=gen, dtype=torch.float64,
                       device=device)
        for k in (1, 100)
    }
    report, panels = {}, {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        band = band64.to(dtype)
        B = band[..., 2 * s :].contiguous()
        M, Dinv = hk.banded_factorize(band)
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        k1_err = max((M - M_p).abs().max().item(), (Dinv - D_p).abs().max().item())
        k1_rel = k1_err / D_p.abs().max().item()
        check(k1_rel <= tol["diff"],
              f"K1 {dtype}: kernel vs plain {k1_rel:.3e} > {tol['diff']}")
        line = f"kernels {str(dtype)[6:]}: K1 rel diff {k1_rel:.3e}"
        k2_err = 0.0
        for k, trans in ((1, False), (1, True), (100, True)):
            bb = rhs64[k].to(dtype)
            x = hk.banded_solve(M, Dinv, B, bb, trans)
            x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
            torch.cuda.synchronize()
            err = (x - x_p).abs().max().item()
            rel = err / x_p.abs().max().item()
            apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
            b_flat = rhs64[k].reshape(N, nb * s, k)
            res = (
                torch.linalg.vector_norm(
                    apply(band64, x.to(torch.float64).reshape(N, nb * s, k))
                    - b_flat
                )
                / torch.linalg.vector_norm(b_flat)
            ).item()
            check(rel <= tol["diff"],
                  f"K2 {dtype} k={k}: kernel vs plain {rel:.3e}")
            check(res <= tol["residual"],
                  f"K2 {dtype} k={k}: residual {res:.3e} > {tol['residual']}")
            line += f"; K2 k={k} trans={trans} rel diff {rel:.3e} residual {res:.3e}"
            k2_err = max(k2_err, err)
        log(line)
        sfx = "" if dtype == torch.float32 else "_f64"
        for trans in (True, False):
            panels[f"n{N}_s{s}_{'trans' if trans else 'fwd'}{sfx}"] = k2_panels(
                M, Dinv, B, rhs64[100].to(dtype), trans, f"nx={NX} Newton bands",
                parent)
        if dtype != torch.float32:
            continue
        bb1, bb100 = rhs64[1].to(dtype), rhs64[100].to(dtype)
        k1_ms, k1_plain = paired_ms(
            lambda: hk.banded_factorize(band),
            lambda: hk.banded_factorize_plain(band), reps=2
        )
        k2_ms, k2_plain = paired_ms(
            lambda: hk.banded_solve(M, Dinv, B, bb100, True),
            lambda: hk.banded_solve_plain(M, Dinv, B, bb100, True),
        )
        k2_ms1, k2_plain1 = paired_ms(
            lambda: hk.banded_solve(M, Dinv, B, bb1, False),
            lambda: hk.banded_solve_plain(M, Dinv, B, bb1, False),
        )
        log(
            f"timing float32 N={N} nb={nb} s={s}: K1 {k1_ms:.3f} ms "
            f"(plain {k1_plain:.3f}); K2 k=100 trans {k2_ms:.3f} ms "
            f"(plain {k2_plain:.3f}); K2 k=1 {k2_ms1:.3f} ms "
            f"(plain {k2_plain1:.3f})"
        )
        b1, by1 = k1_bound(N, nb, s, dtype)
        b2, by2 = k2_bound(N, nb, s, 100, dtype)
        report = {
            "banded_factorize": {"max_abs_err": k1_err, "ms": k1_ms,
                                 "plain_ms": k1_plain, "bound_ms": b1,
                                 "bound_by": by1, "library_ms": None},
            "banded_solve": {"max_abs_err": k2_err, "ms": k2_ms,
                             "plain_ms": k2_plain, "bound_ms": b2,
                             "bound_by": by2, "library_ms": None,
                             "ms_k1": k2_ms1, "plain_ms_k1": k2_plain1,
                             **bound_keys("k1", *k2_bound(N, nb, s, 1, dtype)),
                             "clusters": {
                                 f"n{N}_s{s}_{'trans' if t else 'fwd'}":
                                 k2_clusters(M, Dinv, B, bb1, t,
                                             f"nx={NX} Newton bands", parent)
                                 for t in (False, True)}},
        }
    report["banded_solve"]["panels"] = panels
    designs = {f"n{N}_s{s}": k1_designs(band64, f"nx={NX} Newton bands", parent)}
    designs[f"n{N_SAMPLES}_s{s}"] = k1_designs(
        torch.cat([band64.float()] * (N_SAMPLES // N)), f"nx={NX} Newton bands",
        parent, dtypes=(torch.float32,), reps=2)
    report["banded_factorize"]["designs"] = designs
    return report, band64


def phase_rows_s65(band64):
    """K1's row-panel design (the s=193 one) at s=65, against the one-block
    chain and the plain version, on the nx=64 Newton bands."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    band64 = band64[:32].contiguous()
    line = "K1 rows design s=65 N=32"
    for dtype in (torch.float32, torch.float64):
        band = band64.to(dtype)
        M, Dinv = hk.banded_factorize(band, design="rows")
        M_c, D_c = hk.banded_factorize(band, design="chain")
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        vs_chain = max(rel_err(M, M_c), rel_err(Dinv, D_c))
        vs_plain = max(rel_err(M, M_p), rel_err(Dinv, D_p))
        tol = TOL[dtype]["diff"]
        check(vs_chain <= tol and vs_plain <= tol,
              f"K1 rows s=65 {dtype}: {vs_chain:.3e} vs chain, "
              f"{vs_plain:.3e} vs plain")
        line += f"; {str(dtype)[6:]}: vs chain {vs_chain:.3e}, vs plain {vs_plain:.3e}"
    log(line)


def phase_inverses(priors):
    """K3 and K4 against their plain version on the blocks that cyclic
    reduction inverts first (the odd diagonal blocks of the structured
    prior's K band), at each nx of ``priors`` {nx: float64 structured
    prior}, in both dtypes; float32 timings, with torch.linalg.inv's time
    beside them for reference."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import _cr_reduce

    report = {}
    for nx, prior in priors.items():
        s = nx + 1
        X64 = prior.K_band[1::2, :, s : 2 * s].contiguous()
        eye = torch.eye(s, dtype=torch.float64, device=X64.device)
        line = f"inverses nx={nx} N={X64.shape[0]} s={s}"
        for dtype in (torch.float32, torch.float64):
            tol = TOL_INV[dtype]
            X = X64.to(dtype)
            for name, rank1, w in (("K3", False, hk.GJ_WIDTH), ("K4", True, 1)):
                Y = hk.batched_inverse(X, rank1=rank1)
                Y_p = hk.batched_inverse_plain(X, w)
                torch.cuda.synchronize()
                diff = rel_err(Y, Y_p)
                res = (X64 @ Y.double() - eye).abs().max().item()
                check(diff <= tol["diff"],
                      f"{name} nx={nx} {dtype}: kernel vs plain {diff:.3e}")
                check(res <= tol["residual"],
                      f"{name} nx={nx} {dtype}: max|X X^-1 - I| {res:.3e}")
                line += (f"; {name} {str(dtype)[6:]} rel diff {diff:.3e} "
                         f"residual {res:.3e}")
                if dtype == torch.float32:
                    report[(name, nx)] = {
                        "max_abs_err": (Y - Y_p).abs().max().item()}
        log(line)
        X = X64.to(torch.float32)
        t = {}
        for name, rank1, w in (("K3", False, hk.GJ_WIDTH), ("K4", True, 1)):
            t[name] = paired_ms(lambda: hk.batched_inverse(X, rank1=rank1),
                                lambda: hk.batched_inverse_plain(X, w))
            report[(name, nx)].update(ms=t[name][0], plain_ms=t[name][1])
        inv_ms = cuda_ms(lambda: torch.linalg.inv(X), 5)
        b_ms, b_by = k3_bound(X.shape[0], s, X.dtype)
        for name in ("K3", "K4"):
            report[(name, nx)].update(library_ms=inv_ms, bound_ms=b_ms,
                                      bound_by=b_by)
        log(f"timing float32 inverses nx={nx} N={X.shape[0]} s={s}: K3 "
            f"{t['K3'][0]:.3f} ms (plain {t['K3'][1]:.3f}); K4 {t['K4'][0]:.3f} "
            f"ms (plain {t['K4'][1]:.3f}); torch.linalg.inv {inv_ms:.3f} ms; "
            f"bound {b_ms:.4f} ms ({b_by})")
        report[("clusters", nx)] = time_k3_clusters(
            X, f"nx={nx} cyclic reduction")
        if nx != NX192:
            continue
        # the later levels' odd diagonal blocks (N=48 down to 1)
        a, d, b = (prior.K_band[..., q * s : (q + 1) * s] for q in range(3))
        _, (a, d, b) = _cr_reduce(a, d, b)
        while d.shape[0] > 1:
            Xl = d[1::2].to(torch.float32).contiguous()
            report[("clusters_level", Xl.shape[0])] = time_k3_clusters(
                Xl, f"nx={nx} cyclic reduction level")
            _, (a, d, b) = _cr_reduce(a, d, b)
    return report


def phase_s193(obs64, prior64, device, parent=None):
    """K1 (row panels) and K2 (streamed at k=1, panels at k=100), each
    picked by shape, against their plain versions on Newton bands of the
    nx=192 problem."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    band64, gen = newton_bands(obs64, prior64, N_BAND192, device)
    N, nb, s, _ = band64.shape
    rhs64 = {k: torch.randn(N, nb, s, k, generator=gen, dtype=torch.float64,
                            device=device) for k in (1, 100)}
    report, panels = {}, {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        band = band64.to(dtype)
        B = band[..., 2 * s :].contiguous()
        M, Dinv = hk.banded_factorize(band)
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        k1_rel = max(rel_err(M, M_p), rel_err(Dinv, D_p))
        check(k1_rel <= tol["diff"], f"K1 s={s} {dtype}: kernel vs plain {k1_rel:.3e}")
        line = f"s={s} kernels {str(dtype)[6:]} N={N}: K1 rel diff {k1_rel:.3e}"
        k2_err = 0.0
        for k, trans in ((1, False), (1, True), (100, True)):
            bb = rhs64[k].to(dtype)
            x = hk.banded_solve(M, Dinv, B, bb, trans)
            x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
            torch.cuda.synchronize()
            rel = rel_err(x, x_p)
            apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
            b_flat = rhs64[k].reshape(N, nb * s, k)
            res = (torch.linalg.vector_norm(
                apply(band64, x.double().reshape(N, nb * s, k)) - b_flat)
                / torch.linalg.vector_norm(b_flat)).item()
            check(rel <= tol["diff"], f"K2 s={s} {dtype} k={k}: kernel vs plain {rel:.3e}")
            check(res <= tol["residual"],
                  f"K2 s={s} {dtype} k={k}: residual {res:.3e} > {tol['residual']}")
            line += f"; K2 k={k} trans={trans} rel diff {rel:.3e} residual {res:.3e}"
            k2_err = max(k2_err, (x - x_p).abs().max().item())
        log(line)
        panels[f"n{N}_s{s}_trans" + ("" if dtype == torch.float32 else "_f64")] = (
            k2_panels(M, Dinv, B, rhs64[100].to(dtype), True,
                      f"nx={NX192} Newton bands", parent))
        if dtype != torch.float32:
            continue
        bb1, bb100 = rhs64[1].to(dtype), rhs64[100].to(dtype)
        k1 = paired_ms(lambda: hk.banded_factorize(band),
                       lambda: hk.banded_factorize_plain(band), reps=1)
        k2 = paired_ms(lambda: hk.banded_solve(M, Dinv, B, bb100, True),
                       lambda: hk.banded_solve_plain(M, Dinv, B, bb100, True),
                       reps=2)
        k2_1 = paired_ms(lambda: hk.banded_solve(M, Dinv, B, bb1, False),
                         lambda: hk.banded_solve_plain(M, Dinv, B, bb1, False),
                         reps=2)
        log(f"timing float32 N={N} nb={nb} s={s}: K1 rows {k1[0]:.3f} ms "
            f"(plain {k1[1]:.3f}); K2 panels k=100 trans {k2[0]:.3f} ms "
            f"(plain {k2[1]:.3f}); K2 streamed k=1 {k2_1[0]:.3f} ms "
            f"(plain {k2_1[1]:.3f})")
        report = {
            "banded_factorize": {
                "max_abs_err_s193": max((M - M_p).abs().max().item(),
                                        (Dinv - D_p).abs().max().item()),
                "ms_s193": k1[0], "plain_ms_s193": k1[1],
                **bound_keys("s193", *k1_bound(N, nb, s, dtype))},
            "banded_solve": {"max_abs_err_s193": k2_err, "ms_s193": k2[0],
                             "plain_ms_s193": k2[1], "ms_k1_s193": k2_1[0],
                             "plain_ms_k1_s193": k2_1[1],
                             **bound_keys("s193", *k2_bound(N, nb, s, 100, dtype)),
                             **bound_keys("k1_s193", *k2_bound(N, nb, s, 1, dtype))},
        }
        # the k=1 solve at the lane's Jacobian chunk (16) and chunk (32: the
        # 16 factors twice)
        label = f"nx={NX192} Newton bands"
        clusters = {f"n{N}_s{s}_{'trans' if t else 'fwd'}":
                    k2_clusters(M, Dinv, B, bb1, t, label, parent, reps=2)
                    for t in (False, True)}
        M2, D2, B2, bb2 = (torch.cat([t, t]) for t in (M, Dinv, B, bb1))
        clusters.update({f"n{2 * N}_s{s}_{'trans' if t else 'fwd'}":
                         k2_clusters(M2, D2, B2, bb2, t, label, parent, reps=2)
                         for t in (False, True)})
        del M2, D2, B2, bb2
        report["banded_solve"]["clusters"] = clusters
    report["banded_solve"]["panels"] = panels
    # K1's Schur step at the lane's Jacobian chunk (16) and chunk (32)
    label = f"nx={NX192} Newton bands"
    report["schur"] = {
        f"n{N}_s{s}": k1_schur(band64, label, parent),
        f"n{2 * N}_s{s}": k1_schur(torch.cat([band64[:, : SCHUR_ROW + 2]] * 2),
                                   label, parent, dtypes=(torch.float32,))}
    # K1's designs at the nx=192 lane's chunk (32) and Jacobian chunk (16)
    report["designs"] = {
        f"n{N}_s{s}": k1_designs(band64, f"nx={NX192} Newton bands", parent,
                                 reps=2),
        f"n{2 * N}_s{s}": k1_designs(
            torch.cat([band64.float()] * 2), f"nx={NX192} Newton bands", parent,
            dtypes=(torch.float32,), reps=2)}
    # K3 as K1's rows call it in the nx=192 lane (chunk 32) and at N=16:
    # one block row of an (N, 8, s, s) buffer (the band's diagonal blocks)
    D = band64[:, :8, :, s : 2 * s].to(torch.float32)
    for n in (32, 16):
        buf = torch.cat([D] * (n // N), dim=0).contiguous()
        report[f"rows_n{n}_s{s}"] = time_k3_clusters(
            buf, "K1 rows (N, 8, s, s) row 3", row=3)
    return report


def warm_start_levels(obs, vel, nx, depth, dtype, device):
    """The grid-sequencing levels below nx as ``bench.py`` builds them:
    (problem, V) pairs at nx/2, nx/4, ... (at most ``depth``, none below
    nx=8), each on the velocity restricted from the level above, so that no
    second Navier-Stokes solve is needed."""
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
    )
    from hippyflow_tpu_torch.fem import (
        FunctionSpace,
        restrict_injection,
        unit_square_mesh,
    )

    levels = []
    V_prev, vel_prev, nx_prev = obs.problem.Vu, vel, nx
    while len(levels) < depth and nx_prev % 2 == 0 and nx_prev // 2 >= 8:
        nx_c = nx_prev // 2
        vel_c = restrict_injection(
            torch.as_tensor(vel_prev)[None], V_prev,
            FunctionSpace(unit_square_mesh(nx_c)))[0].numpy()
        obs_c, V_c = confusion_linear_observable(
            nx=nx_c, velocity=vel_c, dtype=dtype, device=device)
        levels.append((obs_c.problem, V_c))
        V_prev, vel_prev, nx_prev = V_c, vel_c, nx_c
    return levels


def check_band_kernels(band64, ks, label, gen, reps=2, parent=None):
    """K1 and K2 (for each (k, trans) of ``ks``) against their plain
    versions on float64 bands, in both dtypes, with the residuals of the
    kernels' solves; float32 times.  Returns {dtype: {...}}."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    N, nb, s, _ = band64.shape
    rhs64 = {k: torch.randn(N, nb, s, k, generator=gen, dtype=torch.float64,
                            device=band64.device) for k, _ in ks}
    out = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        band = band64.to(dtype)
        B = band[..., 2 * s :].contiguous()
        M, Dinv = hk.banded_factorize(band)
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        k1_rel = max(rel_err(M, M_p), rel_err(Dinv, D_p))
        check(k1_rel <= tol["diff"], f"K1 {label} {dtype}: vs plain {k1_rel:.3e}")
        line = f"{label} {str(dtype)[6:]} N={N}: K1 rel diff {k1_rel:.3e}"
        rec = {"max_abs_err": max((M - M_p).abs().max().item(),
                                  (Dinv - D_p).abs().max().item())}
        for k, trans in ks:
            bb = rhs64[k].to(dtype)
            x = hk.banded_solve(M, Dinv, B, bb, trans)
            x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
            torch.cuda.synchronize()
            rel = rel_err(x, x_p)
            apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
            b_flat = rhs64[k].reshape(N, nb * s, k)
            res = (torch.linalg.vector_norm(
                apply(band64, x.double().reshape(N, nb * s, k)) - b_flat)
                / torch.linalg.vector_norm(b_flat)).item()
            check(rel <= tol["diff"], f"K2 {label} {dtype} k={k}: vs plain {rel:.3e}")
            check(res <= tol["residual"],
                  f"K2 {label} {dtype} k={k}: residual {res:.3e}")
            line += f"; K2 k={k} trans={trans} rel diff {rel:.3e} residual {res:.3e}"
            rec[f"k2_max_abs_err_k{k}"] = (x - x_p).abs().max().item()
            if dtype == torch.float32:
                rec[f"k2_k{k}"] = paired_ms(
                    lambda: hk.banded_solve(M, Dinv, B, bb, trans),
                    lambda: hk.banded_solve_plain(M, Dinv, B, bb, trans), reps)
        if dtype == torch.float32:
            rec["k1_bound"] = k1_bound(N, nb, s, dtype)
            rec["k2_bound"] = {k: k2_bound(N, nb, s, k, dtype) for k, _ in ks}
            rec["k1"] = paired_ms(lambda: hk.banded_factorize(band),
                                  lambda: hk.banded_factorize_plain(band), reps)
            line += f"; float32 K1 {rec['k1'][0]:.3f} ms (plain {rec['k1'][1]:.3f})"
            for k, trans in ks:
                t = rec[f"k2_k{k}"]
                line += f", K2 k={k} {t[0]:.3f} ms (plain {t[1]:.3f})"
        log(line)
        if dtype == torch.float32:
            bb1 = torch.randn(N, nb, s, 1, generator=gen, dtype=dtype,
                              device=band64.device)
            rec["k2_clusters"] = {
                f"n{N}_s{s}_{'trans' if t else 'fwd'}":
                k2_clusters(M, Dinv, B, bb1, t, label, parent)
                for t in (False, True)}
        out[dtype] = rec
    out["designs"] = k1_designs(band64, label, parent)
    return out


def phase_coarse(levels, prior64, n, device, parent=None):
    """K1 and K2 (k=1, the Newton solves) at the grid-sequencing levels'
    block sizes, on their own Newton bands: prior samples of m and u
    restricted from the fine grid, N = the lane's chunk."""
    from hippyflow_tpu_torch.fem import (
        bc_symmetrize_banded_from_mask,
        restrict_injection,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    xi = torch.randn(2 * n, prior64.noise_dim, generator=gen,
                     dtype=torch.float64, device=device)
    x, V_prev = prior64.sample(xi), prior64.Vh
    report = {}
    for problem, V in levels:
        x = restrict_injection(x, V_prev, V)
        V_prev = V
        band = bc_symmetrize_banded_from_mask(
            problem.bound.assemble_A_banded(x[n:], x[:n]), problem.bc
        ).contiguous()
        s = band.shape[-2]
        report[s] = check_band_kernels(band, ((1, False),), f"coarse s={s}", gen,
                                       parent=parent)
        del band
    return report


def phase_s516(device, parent=None):
    """K1, K2 and K3 at the helmholtz lane's block size on its own bands
    (the operator at prior samples of m, N=16), both dtypes, against the
    pivoted plain versions; the Schur complements T_j = D_j - M_j B_{j-1}
    come from the float64 plain factorization."""
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
        helmholtz_prior,
    )
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    f64 = dict(dtype=torch.float64, device=device)
    obs, Vh = helmholtz_linear_observable(nx=HELM_NX, frequency=HELM_FREQ, **f64)
    prior = helmholtz_prior(Vh, **f64)
    pde = obs.problem
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = N_BAND_HELM
    m = prior.sample(torch.randn(n, prior.noise_dim, generator=gen, **f64))
    zero = torch.zeros(n, pde.state_dim, **f64)
    band64 = bc_symmetrize_banded_masked(
        pde.bound.assemble_A_banded_ordered(zero, m, None, pde._band_order),
        pde._band_mask).contiguous()
    del zero, m, obs, prior
    N, nb, s, _ = band64.shape
    B64 = band64[..., 2 * s :].contiguous()
    M64, _ = hk.banded_factorize_plain(band64)
    T64 = band64[..., s : 2 * s].clone()
    T64[:, 1:] -= M64[:, 1:] @ B64[:, :-1]
    del M64
    eye = torch.eye(s, **f64)
    rhs64 = {k: torch.randn(N, nb, s, k, generator=gen, **f64) for k in (1, 200)}
    # the lane solves transposed (forward solve, refinement, Jacobian); the
    # k=1 solve forward as well, as a Newton solve would
    ks = ((1, False), (1, True), (200, True))
    report = {}
    for dtype in (torch.float32, torch.float64):
        tol, name = TOL[dtype], str(dtype)[6:]
        band = band64.to(dtype)
        B = band[..., 2 * s :].contiguous()
        M, Dinv = hk.banded_factorize(band)
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        k1_rel = max(rel_err(M, M_p), rel_err(Dinv, D_p))
        check(k1_rel <= tol["diff"], f"K1 s={s} {dtype}: vs plain {k1_rel:.3e}")
        line = f"s={s} kernels {name} N={N} nb={nb}: K1 rel diff {k1_rel:.3e}"
        # K3 and the pivoted inverse on the same Schur complements
        T = T64.to(dtype).reshape(N * nb, s, s)
        res_k3 = res_inv = 0.0
        for c in range(0, N * nb, 128):
            t64 = T64.reshape(N * nb, s, s)[c : c + 128]
            res_k3 = max(res_k3, (t64 @ hk.batched_inverse(T[c : c + 128]).double()
                                  - eye).abs().max().item())
            res_inv = max(res_inv, (t64 @ torch.linalg.inv(T[c : c + 128]).double()
                                    - eye).abs().max().item())
        check(res_k3 <= PIVOT_FACTOR * res_inv,
              f"K3 s={s} {dtype}: max|T T^-1 - I| {res_k3:.3e} against the "
              f"pivoted {res_inv:.3e}")
        line += (f"; max|T T^-1 - I| K3 {res_k3:.3e} torch.linalg.inv "
                 f"{res_inv:.3e} ({res_k3 / res_inv:.2f}x)")
        rec = {"max_abs_err": max((M - M_p).abs().max().item(),
                                  (Dinv - D_p).abs().max().item())}
        for k, trans in ks:
            bb = rhs64[k].to(dtype)
            x = hk.banded_solve(M, Dinv, B, bb, trans)
            x_k = hk.banded_solve_plain(M, Dinv, B, bb, trans)
            x_p = hk.banded_solve_plain(M_p, D_p, B, bb, trans)
            torch.cuda.synchronize()
            rel = rel_err(x, x_k)
            check(rel <= tol["diff"],
                  f"K2 s={s} {dtype} k={k} trans={trans}: vs plain {rel:.3e}")
            apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
            b_flat = rhs64[k].reshape(N, nb * s, k)

            def res(sol):
                return (torch.linalg.vector_norm(
                    apply(band64, sol.double().reshape(N, nb * s, k)) - b_flat)
                    / torch.linalg.vector_norm(b_flat)).item()

            r_k, r_p = res(x), res(x_p)
            check(r_k <= PIVOT_FACTOR * r_p,
                  f"K1+K2 s={s} {dtype} k={k} trans={trans}: residual "
                  f"{r_k:.3e} against the plain pair's {r_p:.3e}")
            line += (f"; K2 k={k} trans={trans} rel diff {rel:.3e}, residual "
                     f"K1+K2 {r_k:.3e} plain pair {r_p:.3e}")
            key = f"k2_max_abs_err_k{k}"
            rec[key] = max(rec.get(key, 0.0), (x - x_k).abs().max().item())
        log(line)
        bb1, bb200 = rhs64[1].to(dtype), rhs64[200].to(dtype)
        rec["k2_panels"] = {
            f"n{N}_s{s}_trans" + ("" if dtype == torch.float32 else "_f64"):
            k2_panels(M, Dinv, B, bb200, True, "helmholtz bands", parent)}
        rec["k1"] = paired_ms(lambda: hk.banded_factorize(band),
                              lambda: hk.banded_factorize_plain(band), reps=1)
        rec["k1_rows_plain"] = cuda_ms(lambda: hk.banded_factorize_rows_plain(band), 1)
        rec["k2_k200"] = paired_ms(
            lambda: hk.banded_solve(M, Dinv, B, bb200, True),
            lambda: hk.banded_solve_plain(M, Dinv, B, bb200, True), reps=2)
        rec["k2_k1"] = paired_ms(
            lambda: hk.banded_solve(M, Dinv, B, bb1, True),
            lambda: hk.banded_solve_plain(M, Dinv, B, bb1, True), reps=2)
        rec["k2_k1_fwd"] = paired_ms(
            lambda: hk.banded_solve(M, Dinv, B, bb1, False),
            lambda: hk.banded_solve_plain(M, Dinv, B, bb1, False), reps=2)
        # one block row's Schur complements, (N, s, s)
        T1 = T.reshape(N, nb, s, s)[:, nb // 2].contiguous()
        rec["k3"] = paired_ms(lambda: hk.batched_inverse(T1),
                              lambda: hk.batched_inverse_plain(T1), reps=2)
        rec["k3_clusters"] = time_k3_clusters(T1, "helmholtz Schur complements")
        rec["k2_clusters"] = {
            f"n{N}_s{s}_{'trans' if t else 'fwd'}"
            + ("" if dtype == torch.float32 else "_f64"):
            k2_clusters(M, Dinv, B, bb1, t, "helmholtz bands", parent, reps=2)
            for t in (False, True)}
        rec["k1_bound"] = k1_bound(N, nb, s, dtype)
        rec["k2_bound"] = {k: k2_bound(N, nb, s, k, dtype) for k in (1, 200)}
        log(f"timing {name} s={s} N={N} nb={nb}: K1 rows {rec['k1'][0]:.3f} ms "
            f"(plain {rec['k1'][1]:.3f}, rows plain {rec['k1_rows_plain']:.3f}); "
            f"K2 k=200 trans {rec['k2_k200'][0]:.3f} ms (plain "
            f"{rec['k2_k200'][1]:.3f}); K2 k=1 trans {rec['k2_k1'][0]:.3f} ms "
            f"(plain {rec['k2_k1'][1]:.3f}), k=1 {rec['k2_k1_fwd'][0]:.3f} ms "
            f"(plain {rec['k2_k1_fwd'][1]:.3f}); K3 {tuple(T1.shape)} {rec['k3'][0]:.3f} "
            f"ms (plain {rec['k3'][1]:.3f})")
        report[dtype] = rec
        del band, B, M, Dinv, M_p, D_p, T, T1
        torch.cuda.empty_cache()
    report["designs"] = k1_designs(band64, "helmholtz bands", parent, reps=1)
    report["schur"] = {f"n{N}_s{s}": k1_schur(band64, "helmholtz bands", parent,
                                              reps=5)}
    return s, report


def phase_parity(obs64, prior64, label=None, collective=None):
    """The float64 pipeline against the stored reference spectrum (through
    ``collective`` where given)."""
    label = label or type(prior64).__name__
    import numpy as np

    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    data = np.load(os.path.join(REPO, ".bench", "parity_ref.npz"))
    check(int(data["nx"]) == NX, "parity reference is not at nx=64")
    rank = int(data["rank"])
    device, dtype = prior64.mean.device, prior64.mean.dtype
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = rank, OVERSAMPLING
    params["samples_per_process"] = data["xi"].shape[0]
    params["ms_given"], params["verbose"] = True, False
    proj = ActiveSubspaceProjector(obs64, prior64, parameters=params,
                                   collective=collective)
    proj.ms = prior64.sample(torch.as_tensor(data["xi"], dtype=dtype, device=device))
    proj.Omega_GN = torch.as_tensor(data["Omega"], dtype=dtype, device=device)
    t0 = time.perf_counter()
    d, _, _ = proj.construct_input_subspace()
    secs = time.perf_counter() - t0
    d = d.cpu().numpy()[:rank]
    d_ref = data["d_ref"][:rank]
    head = np.abs(d_ref) > 1e-4 * abs(d_ref[0])
    rel = np.abs(d - d_ref) / np.abs(d_ref)
    err = float(rel[head].max())
    log(f"parity float64 {label}: rel eig err {err:.3e} over {int(head.sum())} "
        f"head eigenvalues (limit 1e-8), {secs:.2f} s")
    check(err <= 1e-8,
          f"parity {label}: relative eigenvalue error {err:.3e} > 1e-8")
    return err


def launch_counts() -> dict:
    """Every kernel's launches since the counts were last set to 0, K1's
    and K2's by design and K1's Schur steps."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    return {
        "banded_factorize": hk.banded_factorize.launches,
        "banded_solve": hk.banded_solve.launches,
        "batched_inverse": hk.batched_inverse.launches,
        "batched_inverse_rank1": hk.batched_inverse.rank1_launches,
        "schur_step": hk.schur_step_.launches,
        **{f"banded_factorize_{d}": n
           for d, n in hk.banded_factorize.launches_by_design.items()},
        **{f"banded_solve_{d}": n
           for d, n in hk.banded_solve.launches_by_design.items()},
    }


def run_subspace(obs32, prior_fn, label, n_samples, rank, warm_levels=None,
                 collective=None, **params_kw):
    """The float32 input active subspace once, through the user entry
    points, with every launch count set to 0 just before (``prior_fn``
    builds the prior, and the grid-sequencing map on ``warm_levels`` is
    built, inside the counted run) and read just after; then the health
    checks.  Returns (launches, projector); the projector's
    ``smoke_summary`` holds the logged figures."""
    from hippyflow_tpu_torch.fem import coarse_newton_warm_start
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    prior32 = prior_fn()
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = rank, OVERSAMPLING
    params["samples_per_process"] = n_samples
    params["verbose"], params["seed"] = False, SEED
    warm = None
    if warm_levels:
        warm = coarse_newton_warm_start(
            prior32, warm_levels[0][0], obs32.problem.Vu, warm_levels[0][1],
            coarser_levels=warm_levels[1:])
        params["coarse_warm_start"] = warm
    for key, value in params_kw.items():
        params[key] = value
    proj = ActiveSubspaceProjector(obs32, prior32, parameters=params,
                                   collective=collective)
    d, V, E = proj.construct_input_subspace()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = proj.stage_seconds
    it = proj.samples.iterations.to(torch.float64)
    ortho = (V.T @ E - torch.eye(V.shape[1], dtype=V.dtype, device=V.device))
    ortho = ortho.abs().max().item()
    stages = ", ".join(f"{k} {v:.3f}" for k, v in st.items())
    newton = (f"Newton iterations max {int(it.max().item())} mean "
              f"{it.mean().item():.3f}")
    if warm is not None:
        for (problem, _), its in zip(warm_levels, warm.iterations):
            c = torch.cat(its).to(torch.float64)
            newton += (f", coarse s={problem._block_size} max "
                       f"{int(c.max().item())} mean {c.mean().item():.3f}")
    log(
        f"{label} samples={n_samples} rank={rank}: total {total:.3f} s "
        f"(prior {total - sum(st.values()):.3f}, {stages}); {newton}; "
        f"resampled failures {proj.samples.n_failures}; launches K1 "
        f"{launches['banded_factorize']} (chain "
        f"{launches['banded_factorize_chain']}, rows "
        f"{launches['banded_factorize_rows']}; Schur steps "
        f"{launches['schur_step']}) K2 {launches['banded_solve']} (panels "
        f"{launches['banded_solve_panels']}, streamed "
        f"{launches['banded_solve_streamed']}) K3 "
        f"{launches['batched_inverse']} K4 {launches['batched_inverse_rank1']}; "
        f"peak {peak_gb:.2f} GB"
    )
    log(f"{label} eigenvalues[:5] {[round(x, 6) for x in d[:5].tolist()]}; "
        f"max|V^T R V - I| {ortho:.3e}")
    for t_name, t in (("d", d), ("decoder", V), ("encoder", E)):
        check(bool(torch.isfinite(t).all()), f"{label}: non-finite {t_name}")
    check(d.shape == (rank,) and V.shape == (obs32.dM, rank),
          f"{label}: shapes {tuple(d.shape)}, {tuple(V.shape)}")
    check(bool((d[1:] <= d[:-1]).all()), f"{label}: eigenvalues are not descending")
    check(ortho <= ORTHO_TOL_F32, f"{label}: max|V^T R V - I| {ortho:.3e}")
    proj.smoke_summary = {
        "total": total, "stages": dict(st), "newton_max": int(it.max().item()),
        "newton_mean": it.mean().item(), "failures": proj.samples.n_failures,
        "peak_gb": peak_gb, "d": d.cpu()}
    return launches, proj


def phase_main(obs32, prior32, levels):
    """The float32 main path, once grid-sequenced through the user entry
    point (the counted path), and once cold-started for comparison.
    Returns the launches by path, the grid-sequenced run's projector (its
    samples, Jacobians and decoder feed the training phase) and the cold
    run's summary (the parallel phase's yardstick)."""
    paths, kept, cold = {}, None, None
    for name, lv in (("nx64", levels), ("nx64_cold", None)):
        label = " cold start" if lv is None else f" grid-sequenced depth {len(lv)}"
        launches, proj = run_subspace(obs32, lambda: prior32,
                                      f"main float32 nx={NX}{label}", N_SAMPLES,
                                      RANK, warm_levels=lv)
        for key in ("banded_factorize", "banded_solve"):
            check(launches[key] > 0, f"{key} was not launched on {name}")
        paths[name] = launches
        if lv is not None:
            kept = proj
        else:
            cold = proj.smoke_summary
    return paths, kept, cold


def save_stage(obs32, prior32, warm, n_samples, rank, label, **params_kw):
    """One pass of ``bench.py``'s timed lane (``timed_pass``) through the
    port, into a temporary directory: the forward stage, then a thread that
    copies ``samples.ms`` / ``qs`` to the host and writes
    ``confusion_mq_data.npz`` while the Jacobian and GHEP stages run, then
    the decoder's ``AS_input_decoder.npy``.  Logs the stage seconds, the
    seconds the writer waited for its copy, and the copy of (m, q) alone
    after the pass, against the forward + Jacobian + GHEP seconds: the
    most that a copy to the host started as each sampling chunk ends (the
    JAX package's ``prefetch_host``) could take off the pass."""
    import threading

    import numpy as np
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = rank, OVERSAMPLING
    params["samples_per_process"] = n_samples
    params["verbose"], params["seed"] = False, SEED
    params["coarse_warm_start"] = warm
    for key, value in params_kw.items():
        params[key] = value
    proj = ActiveSubspaceProjector(obs32, prior32, parameters=params)
    st, waited = {}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proj._ensure_samples()
        torch.cuda.synchronize()
        st["forward"] = time.perf_counter() - t0

        def write_npz():
            t = time.perf_counter()
            m, q = proj.samples.ms.cpu().numpy(), proj.samples.qs.cpu().numpy()
            waited["s"] = time.perf_counter() - t
            np.savez(os.path.join(out_dir, "confusion_mq_data.npz"), m_data=m,
                     q_data=q)

        saver = threading.Thread(target=write_npz)
        saver.start()
        t2 = time.perf_counter()
        d, dec, _ = proj.construct_input_subspace()
        torch.cuda.synchronize()
        st["jacobian_ghep"] = time.perf_counter() - t2
        t4 = time.perf_counter()
        saver.join()
        np.save(os.path.join(out_dir, "AS_input_decoder.npy"),
                dec.cpu().numpy())
        st["save"] = time.perf_counter() - t4
        st["total"] = time.perf_counter() - t0
        with np.load(os.path.join(out_dir, "confusion_mq_data.npz")) as z:
            check(z["m_data"].shape == (n_samples, obs32.dM)
                  and z["q_data"].shape == (n_samples, obs32.dQ)
                  and np.array_equal(z["q_data"],
                                     proj.samples.qs.cpu().numpy()),
                  f"save stage {label}: confusion_mq_data.npz")
    ms, qs = proj.samples.ms, proj.samples.qs
    torch.cuda.synchronize()
    t = time.perf_counter()
    ms.cpu(), qs.cpu()
    copy_s = time.perf_counter() - t
    mb = (ms.numel() * ms.element_size() + qs.numel() * qs.element_size()) / 1e6
    stages = st["forward"] + st["jacobian_ghep"]
    log(f"save stage {label} samples={n_samples} (bench.py's layout): "
        + ", ".join(f"{k} {v:.4f}" for k, v in st.items())
        + f" s; the writer waited {waited['s']:.4f} s; the copy of (m, q) "
        f"alone ({mb:.1f} MB) {copy_s:.4f} s, {100 * copy_s / stages:.2f}% "
        f"of forward + jacobian_ghep; {nvidia_smi_line()}")


def phase_surface(obs32, prior32, levels, n_samples, rank, **params_kw):
    """(a) The save stage of ``bench.py``'s lane, grid-sequenced on
    ``levels``: at nx=64 one sampling chunk of 1024, at nx=192 eight of
    32."""
    from hippyflow_tpu_torch.fem import coarse_newton_warm_start

    warm = coarse_newton_warm_start(prior32, levels[0][0], obs32.problem.Vu,
                                    levels[0][1], coarser_levels=levels[1:])
    nx = obs32.problem.Vu.mesh.structured_shape[0]
    save_stage(obs32, prior32, warm, n_samples, rank,
               f"float32 nx={nx} grid-sequenced depth {len(levels)}",
               **params_kw)


def component_observable(pde, targets):
    """The real component (0 of 2) of a helmholtz state observed at the
    lane's targets."""
    from hippyflow_tpu_torch.fem import ComponentObservation
    from hippyflow_tpu_torch.models import (
        LinearStateObservable,
        PointwiseObservation,
    )

    B = PointwiseObservation(pde.Vu, targets, dtype=pde.dtype, device=pde.device)
    return LinearStateObservable(pde, ComponentObservation(B, 2, 0))


def jt_directions(obs, n):
    """dq (n, dQ, JT_COLUMNS) from the seed, at the problem's dtype."""
    gen = torch.Generator().manual_seed(SEED)
    return torch.randn(n, obs.dQ, JT_COLUMNS, generator=gen,
                       dtype=torch.float64).to(obs.problem.dtype)


def phase_surface_jt(device, obs32, obs64, ms):
    """(b) The repaired J^T on the helmholtz lane's bands (s=516): a
    ``ComponentObservation`` of the real component (ncomp=2) at the lane's
    targets; the float32 linearization and ``transpmult`` of
    ``JT_SAMPLES`` of the lane's samples (the counted path
    ``surface_jt``) against ``materialize(lin).mT @ dq``; in float64 the
    same at ``JT_TOL_F64``, and against the same product on the CPU."""
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
    )
    from hippyflow_tpu_torch.models import ObservableJacobian
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    targets = obs32.B.targets
    comp32 = component_observable(obs32.problem, targets)
    m32 = ms[:JT_SAMPLES]
    u32, info = obs32.problem.solve_fwd(m32)
    check(bool(info.converged.all()), "surface J^T: float32 solves")
    dq32 = jt_directions(comp32, JT_SAMPLES).to(device)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    lin = obs32.problem.linearize(u32, m32, needs="adj")
    J = ObservableJacobian(comp32)
    jt32 = J.transpmult(lin, dq32)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    err32 = rel_err(jt32, J.materialize(lin).mT @ dq32)
    del lin
    comp64 = component_observable(obs64.problem, targets)
    m64 = ms[:JT_SAMPLES_F64].double()
    u64, info = obs64.problem.solve_fwd(m64)
    check(bool(info.converged.all()), "surface J^T: float64 solves")
    dq64 = jt_directions(comp64, JT_SAMPLES_F64).to(device)
    J64 = ObservableJacobian(comp64)
    lin = obs64.problem.linearize(u64, m64, needs="adj")
    jt64 = J64.transpmult(lin, dq64)
    err64 = rel_err(jt64, J64.materialize(lin).mT @ dq64)
    del lin
    obs_cpu, _ = helmholtz_linear_observable(
        nx=HELM_NX, frequency=HELM_FREQ, dtype=torch.float64, device="cpu")
    comp_cpu = component_observable(obs_cpu.problem, targets)
    lin = obs_cpu.problem.linearize(u64.cpu(), m64.cpu(), needs="adj")
    err_cpu = rel_err(jt64.cpu(),
                      ObservableJacobian(comp_cpu).transpmult(lin, dq64.cpu()))
    log(f"surface J^T helmholtz s={obs32.problem._block_size} component 0 of "
        f"2, dQ={comp32.dQ}, k={JT_COLUMNS}: float32 N={JT_SAMPLES} "
        f"linearize + transpmult {seconds:.4f} s, against materialize "
        f"{err32:.3e} (limit {JAC_TOL_F32}); float64 N={JT_SAMPLES_F64} "
        f"{err64:.3e} (limit {JT_TOL_F64}), card against CPU {err_cpu:.3e} "
        f"(limit {JT_CPU_TOL}); launches K1 {launches['banded_factorize']} "
        f"(rows {launches['banded_factorize_rows']}; Schur steps "
        f"{launches['schur_step']}) K2 {launches['banded_solve']} K3 "
        f"{launches['batched_inverse']}; {nvidia_smi_line()}")
    check(err32 <= JAC_TOL_F32, f"surface J^T float32 {err32:.3e}")
    check(err64 <= JT_TOL_F64, f"surface J^T float64 {err64:.3e}")
    check(err_cpu <= JT_CPU_TOL, f"surface J^T card against CPU {err_cpu:.3e}")
    for key in ("banded_factorize_rows", "schur_step", "batched_inverse",
                "banded_solve"):
        check(launches[key] > 0, f"{key} was not launched on surface_jt")
    return {"surface_jt": launches}


def vector_problem(lane):
    """The helmholtz lane's problem with a P2 parameter space and a copy
    of its form whose flux and source scale by a P1 dof-valued coefficient
    ``a`` (``coefficients``), all ones: the same mesh, state, rhs and
    Dirichlet data, the lane's dtype and device."""
    import numpy as np

    from hippyflow_tpu_torch.fem import FunctionSpace
    from hippyflow_tpu_torch.fem.vector_assembly import VectorGalerkinForm
    from hippyflow_tpu_torch.models import VariationalPDEProblem

    base = lane.form
    form = VectorGalerkinForm(
        2, lambda x, u, gu, m, z, c: c["a"][..., None, None]
        * base.flux(x, u, gu, m, z, c),
        lambda x, u, gu, m, z, c: c["a"][..., None]
        * base.source(x, u, gu, m, z, c),
        base.quad_degree, False, {"a": np.ones(lane.Vu.mesh.num_vertices)})
    return VariationalPDEProblem(
        lane.Vu, FunctionSpace(lane.Vu.mesh, 2), form, lane.bc, True,
        rhs_vector=lane.rhs_vector, operator_symmetric=True, dtype=lane.dtype,
        device=lane.device)


def phase_surface_vector(device, obs32, obs64, ms):
    """(c) The vector form's coefficients and any-degree parameter space
    on the helmholtz lane (s=516): ``vector_problem`` of the lane's
    problems, m the P2 interpolant of the lane's samples, observed on the
    real component.  Float32 at the lane's chunk (the counted path
    ``surface_vector``: linearize and ``transpmult``) against
    ``materialize(lin).mT @ dq``; float64 for 2 samples at ``JT_TOL_F64``
    and against the CPU at ``JT_CPU_TOL``; the float64 band at the P2
    interpolant against the lane's own band at the P1 m."""
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
    )
    from hippyflow_tpu_torch.fem import prolong_p1_to_p2
    from hippyflow_tpu_torch.models import ObservableJacobian
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    targets = obs32.B.targets
    t_phase = t0 = time.perf_counter()
    pde32 = vector_problem(obs32.problem)
    comp32 = component_observable(pde32, targets)
    m32 = prolong_p1_to_p2(ms[:HELM_CHUNK], obs32.problem.Vm, pde32.Vm)
    u32, info = pde32.solve_fwd(m32)
    check(bool(info.converged.all()), "surface vector: float32 solves")
    newton32 = info.iterations.float()
    dq32 = jt_directions(comp32, HELM_CHUNK).to(device)
    torch.cuda.synchronize()
    build_solve = time.perf_counter() - t0
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    lin = pde32.linearize(u32, m32, needs="adj")
    J = ObservableJacobian(comp32)
    jt32 = J.transpmult(lin, dq32)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    check(bool(torch.isfinite(jt32).all())
          and jt32.shape == (HELM_CHUNK, pde32.Vm.dim, JT_COLUMNS),
          f"surface vector: J^T float32 {tuple(jt32.shape)}")
    err32 = rel_err(jt32, J.materialize(lin).mT @ dq32)
    del lin
    lane64 = obs64.problem
    pde64 = vector_problem(lane64)
    comp64 = component_observable(pde64, targets)
    m1 = ms[:JT_SAMPLES_F64].double()
    m64 = prolong_p1_to_p2(m1, lane64.Vm, pde64.Vm)
    u64, info = pde64.solve_fwd(m64)
    check(bool(info.converged.all()), "surface vector: float64 solves")
    bo = lane64._band_order
    band_err = rel_err(pde64.bound.assemble_A_banded_ordered(u64, m64, None, bo),
                       lane64.bound.assemble_A_banded_ordered(u64, m1, None, bo))
    dq64 = jt_directions(comp64, JT_SAMPLES_F64).to(device)
    J64 = ObservableJacobian(comp64)
    lin = pde64.linearize(u64, m64, needs="adj")
    jt64 = J64.transpmult(lin, dq64)
    err64 = rel_err(jt64, J64.materialize(lin).mT @ dq64)
    del lin
    obs_cpu, _ = helmholtz_linear_observable(
        nx=HELM_NX, frequency=HELM_FREQ, dtype=torch.float64, device="cpu")
    pde_cpu = vector_problem(obs_cpu.problem)
    lin = pde_cpu.linearize(u64.cpu(), m64.cpu(), needs="adj")
    err_cpu = rel_err(jt64.cpu(), ObservableJacobian(
        component_observable(pde_cpu, targets)).transpmult(lin, dq64.cpu()))
    log(f"surface vector helmholtz s={pde32._block_size} nb="
        f"{pde32._band_order.nb}, P2 parameter ({pde32.Vm.dim} dofs), unit P1 "
        f"coefficient, component 0 of 2, k={JT_COLUMNS}: float32 N={HELM_CHUNK} "
        f"build + solve_fwd {build_solve:.4f} s (Newton max "
        f"{int(newton32.max())} mean {newton32.mean().item():.3f}), "
        f"linearize + transpmult {seconds:.4f} s, against materialize "
        f"{err32:.3e} (limit {JAC_TOL_F32}); float64 N={JT_SAMPLES_F64} "
        f"{err64:.3e} (limit {JT_TOL_F64}), card against CPU {err_cpu:.3e} "
        f"(limit {JT_CPU_TOL}), band at the P2 interpolant against the "
        f"lane's {band_err:.3e} (limit {VECTOR_BAND_TOL}); launches K1 "
        f"{launches['banded_factorize']} (rows "
        f"{launches['banded_factorize_rows']}; Schur steps "
        f"{launches['schur_step']}) K2 {launches['banded_solve']} K3 "
        f"{launches['batched_inverse']}; phase {time.perf_counter() - t_phase:.1f} "
        f"s; {nvidia_smi_line()}")
    check(err32 <= JAC_TOL_F32, f"surface vector J^T float32 {err32:.3e}")
    check(err64 <= JT_TOL_F64, f"surface vector J^T float64 {err64:.3e}")
    check(err_cpu <= JT_CPU_TOL,
          f"surface vector J^T card against CPU {err_cpu:.3e}")
    check(band_err <= VECTOR_BAND_TOL, f"surface vector band {band_err:.3e}")
    for key in ("banded_factorize_rows", "schur_step", "batched_inverse",
                "banded_solve"):
        check(launches[key] > 0, f"{key} was not launched on surface_vector")
    return {"surface_vector": launches}


def forward_utilization(obs32, prior32):
    """bench.py's forward-solve utilization probe on the nx=64 main path:
    ``mfu_report`` over ``solve_fwd`` of B = min(256, N_SAMPLES) prior
    samples, and the analytic inverse-Thomas models (one factorization and
    one k=1 solve per sample and Newton iteration, at the most iterations
    of any sample) over its seconds, against the card's peaks.  Both shares
    must lie in (0, 1]."""
    from hippyflow_tpu_torch.ops import thomas_inv_bytes, thomas_inv_flops
    from hippyflow_tpu_torch.utils.profiling import (
        device_peak_hbm_gbs,
        device_peak_tflops,
        mfu_report,
    )

    problem = obs32.problem
    device, dtype = prior32.mean.device, prior32.mean.dtype
    B = min(256, N_SAMPLES)
    gen = torch.Generator(device=device).manual_seed(SEED)
    ms = prior32.sample(torch.randn(B, prior32.noise_dim, generator=gen,
                                    dtype=dtype, device=device))
    rep = mfu_report(lambda m: problem.solve_fwd(m)[0], ms, name="newton_forward")
    _, info = problem.solve_fwd(ms)
    iters = float(info.iterations.max().item())
    check(problem.fwd_solver == "thomas_inv",
          f"forward utilization: the forward solver is {problem.fwd_solver}")
    s = problem._block_size
    nb = problem.state_dim // s
    tf = thomas_inv_flops(nb, s, 1) * B * iters / rep["seconds"] / 1e12
    gbs = (thomas_inv_bytes(nb, s, 1, torch.finfo(dtype).bits // 8) * B * iters
           / rep["seconds"] / 1e9)
    out = {
        "forward_tflops": tf, "forward_mfu": tf / device_peak_tflops(device),
        "forward_hbm_gbs_model": gbs,
        "forward_hbm_util_model": gbs / device_peak_hbm_gbs(device),
        "newton_iters_max": iters, "samples": B, "seconds": rep["seconds"],
        "aten_tflops": rep["tflops"], "aten_gbs": rep["gbs"],
        "aten_bytes_ratio": rep["xla_bytes_ratio"],
    }
    log(f"forward utilization float32 nx={NX}: {json.dumps(out)}")
    for key in ("forward_mfu", "forward_hbm_util_model"):
        check(0.0 < out[key] <= 1.0, f"forward utilization {key} {out[key]}")
    return out


def _finite(*values) -> bool:
    return all(math.isfinite(v) for v in values)


def train_lane(proj, device):
    """bench.py's training lane on the card, at its full size, from the
    main path's float32 samples and decoder (``training_lane``)."""
    from hippyflow_tpu_torch.applications.confusion_training import training_lane
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    hk.reset_launch_counts()
    out = training_lane(proj.samples.ms, proj.samples.qs, proj.V_GN,
                        sweeps=TRAIN_SWEEPS, n=TRAIN_N, in_rank=TRAIN_IN_RANK,
                        out_rank=TRAIN_OUT_RANK, device=device)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = (hk.banded_factorize.launches + hk.banded_solve.launches
                + hk.batched_inverse.launches)
    lg, params = out["logger"], out["params"]
    n_params = sum(p.numel() for p in params.values())
    log(f"training lane float32 nx={NX}: DIPNet {TRAIN_IN_RANK} x "
        f"{TRAIN_OUT_RANK} ({n_params} parameters), {TRAIN_N // 2} / "
        f"{TRAIN_N // 2} samples, incg batch 128, Hessian batch 16, rank "
        f"20: {out['s_per_sweep']:.4f} s/sweep over {TRAIN_SWEEPS} sweeps, "
        f"first run (1 sweep) {out['first_run_s']:.3f} s, POD "
        f"{out['pod_s']:.4f} s; loss {lg['loss'][0]:.4e} -> "
        f"{lg['loss'][-1]:.4e}; val acc per sweep "
        f"{[round(v, 4) for v in lg['val_acc']]} (max "
        f"{lg['max_val_acc']:.4f}); train acc {lg['train_acc'][-1]:.4f}; "
        f"peak {peak_gb:.3f} GB ({peak_gb - held_gb:.3f} GB above the "
        f"{held_gb:.3f} GB held before); kernel launches {launches}")
    check(n_params == 1924, f"training lane: {n_params} parameters")
    check(_finite(out["s_per_sweep"], out["first_run_s"], out["pod_s"],
                  *lg["loss"], *lg["val_acc"], *lg["train_acc"], *lg["gnorm"])
          and all(bool(torch.isfinite(p).all()) for p in params.values()),
          "training lane: a non-finite number")
    check(lg["loss"][-1] < lg["loss"][0],
          f"training lane: loss {lg['loss'][0]:.4e} -> {lg['loss'][-1]:.4e}")
    check(out["val_acc"] >= TRAIN_MIN_VAL_ACC,
          f"training lane: val acc {out['val_acc']:.4f} < {TRAIN_MIN_VAL_ACC}")
    return out


def train_card_against_cpu(proj, device):
    """One float64 Newton-CG sweep (the lane's settings) on the card and on
    the CPU from the same weights, data and probe blocks (``train`` draws
    them on the CPU)."""
    from hippyflow_tpu_torch.applications.confusion_training import modify_projectors
    from hippyflow_tpu_torch.models.pod import PODProjectorFromData
    from hippyflow_tpu_torch.nn import projected_dense, train

    f64 = torch.float64
    ms = proj.samples.ms[:TRAIN_F64_N].to(f64).cpu()
    qs = proj.samples.qs[:TRAIN_F64_N].to(f64).cpu()
    _, phi, _, shift = PODProjectorFromData(
        None, M_output=torch.eye(qs.shape[1], dtype=f64)).construct_subspace(
        qs, u_rank=TRAIN_OUT_RANK, shifted=True, method="hep")
    P, Phi = modify_projectors({
        "AS_input": proj.V_GN[:, :TRAIN_IN_RANK].to(f64).cpu().numpy(),
        "POD": phi.numpy()})
    fit = dict(epochs=1, batch_size=128, optimizer="incg", hess_batch_size=16,
               hessian_low_rank=20, validation_split=0.5, seed=0)
    got = {}
    for dev in ("cpu", device):
        model = projected_dense(P, Phi, output_shift=shift, dtype=f64, device=dev,
                                generator=torch.Generator().manual_seed(1))
        t0 = time.perf_counter()
        params, lg = train(model, ms, qs, **fit)
        if dev != "cpu":
            torch.cuda.synchronize()
        got[str(dev)] = (torch.cat([p.reshape(-1).cpu() for p in params.values()]),
                         lg, time.perf_counter() - t0)
    (w_cpu, lg_cpu, s_cpu), (w_gpu, lg_gpu, s_gpu) = got["cpu"], got[str(device)]
    err = ((w_gpu - w_cpu).abs().max() / w_cpu.abs().max()).item()
    log(f"training float64 card against CPU, 1 sweep on {TRAIN_F64_N} samples: "
        f"max|w_card - w_cpu| / max|w_cpu| {err:.3e} (limit {TRAIN_F64_TOL:g}); "
        f"loss {lg_gpu['loss'][0]:.10e} / {lg_cpu['loss'][0]:.10e}; val acc "
        f"{lg_gpu['val_acc'][0]:.10f} / {lg_cpu['val_acc'][0]:.10f}; "
        f"{s_gpu:.3f} s / {s_cpu:.3f} s")
    check(err <= TRAIN_F64_TOL, f"training float64 card against CPU: {err:.3e}")


def train_h1(proj, device, save=None):
    """ACCURACY.md's few-data comparison at n=32 as
    ``benchmarks/accuracy_sweep.py`` runs it: DIPNet and DIPResNet (ranks
    8, 8), l2 and normalized H1 (weight 1), 40 Newton-CG sweeps for each
    weight seed (the init's generator and the train's seed), 32 training
    samples against the held-out samples 512-1023; the orthonormal rank-16
    POD Phi of samples 0-511 and its shift, the network's output bias at
    that shift, and Jacobian sketches J^T Phi from the main path's
    Jacobians (three of them first held against float64 Jacobians solved
    afresh at their samples).  With ``save`` the arrays go to that .npz file, for the
    same comparison through the JAX train on the CPU
    (``tests/test_torch_training.py`` run as a script)."""
    from hippyflow_tpu_torch.applications.confusion_training import modify_projectors
    from hippyflow_tpu_torch.models import ObservableJacobian
    from hippyflow_tpu_torch.models.pod import PODProjectorFromData
    from hippyflow_tpu_torch.nn import (
        projected_dense,
        projected_low_rank_residual_network,
        train,
    )

    ms, qs = proj.samples.ms, proj.samples.qs
    eye = torch.eye(qs.shape[1], dtype=qs.dtype, device=device)
    _, phi, _, q_shift = PODProjectorFromData(None, M_output=eye).construct_subspace(
        qs[:H1_N_POOL], u_rank=TRAIN_OUT_RANK, shifted=True, method="hep")
    n = H1_N_TRAIN
    jstarphi = torch.einsum("nqm,qp->nmp", proj.Js[:n], phi)
    # the sketches' Jacobians belong to their samples: three of them against
    # the float64 Jacobian at the same samples, solved afresh
    obs64, _ = setup(torch.float64, device, with_prior=False)
    idx = torch.tensor([0, 1, n - 1], device=device)
    m64 = ms[idx].double()
    u64, info = obs64.problem.solve_fwd(m64)
    check(bool(info.converged.all()), "training H1: float64 solves did not converge")
    J64 = ObservableJacobian(obs64).materialize(
        obs64.problem.linearize(u64, m64, needs="adj"))
    rel = rel_err(proj.Js[idx].double(), J64)
    log(f"training H1 sketches: the Jacobians of samples {idx.tolist()} against "
        f"float64 ones at the same samples: max|dJ| / max|J| {rel:.3e} (limit "
        f"{JAC_TOL_F32})")
    check(rel <= JAC_TOL_F32, f"training H1: Jacobians against float64 {rel:.3e}")
    del obs64, u64, J64
    decoder = proj.V_GN[:, :TRAIN_IN_RANK].cpu().numpy()
    P, Phi = modify_projectors({"AS_input": decoder, "POD": phi.cpu().numpy()})
    val = (ms[H1_N_POOL:2 * H1_N_POOL], qs[H1_N_POOL:2 * H1_N_POOL])
    if save:
        import numpy as np

        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        np.savez(save, m=ms[:n].cpu().numpy(), q=qs[:n].cpu().numpy(),
                 JstarPhi=jstarphi.cpu().numpy(), m_val=val[0].cpu().numpy(),
                 q_val=val[1].cpu().numpy(), decoder=decoder,
                 phi=phi.cpu().numpy(), q_shift=q_shift.cpu().numpy())
        log(f"training H1 arrays -> {save}")
    acc = {}
    for arch in ("as_dense", "as_resnet"):
        for loss in ("l2", "h1"):
            accs, secs = [], []
            for seed in H1_SEEDS:
                kw = dict(output_shift=q_shift, dtype=qs.dtype, device=device,
                          generator=torch.Generator().manual_seed(seed))
                model = (projected_dense(P, Phi, **kw) if arch == "as_dense" else
                         projected_low_rank_residual_network(P, Phi, ranks=(8, 8),
                                                             **kw))
                kw = {}
                if loss == "h1":
                    kw = dict(JstarPhi_data=jstarphi, input_decoder=P,
                              output_encoder=phi, h1_weight=1.0, h1_normalized=True)
                t0 = time.perf_counter()
                _, lg = train(model, ms[:n], qs[:n], validation_data=val,
                              epochs=H1_SWEEPS, batch_size=n, optimizer="incg",
                              hess_batch_size=16, hessian_low_rank=20, seed=seed,
                              **kw)
                torch.cuda.synchronize()
                secs.append((time.perf_counter() - t0) / H1_SWEEPS)
                accs.append(lg["max_val_acc"])
                check(_finite(*lg["loss"], *lg["val_acc"], secs[-1]),
                      f"training {arch} {loss} seed {seed}: a non-finite number")
            acc[arch, loss] = torch.tensor(accs, dtype=torch.float64)
            log(f"training {arch} {loss} n={n} float32, {H1_SWEEPS} sweeps, seeds "
                f"{list(H1_SEEDS)}: max val acc {[round(a, 4) for a in accs]} "
                f"(mean {acc[arch, loss].mean():.4f}, std "
                f"{acc[arch, loss].std(correction=0):.4f}); "
                f"{sum(secs) / len(secs):.4f} "
                f"s/sweep (first sweep included)")
    for arch, name in (("as_dense", "DIPNet"), ("as_resnet", "DIPResNet")):
        l2, h1 = acc[arch, "l2"], acc[arch, "h1"]
        gap = (h1 - l2).mean().item()
        sd = max(l2.std(correction=0), h1.std(correction=0)).item()
        log(f"training H1 gap n={n} {name} (mean max val acc over "
            f"{len(H1_SEEDS)} seeds, h1 - l2; logged, not checked): "
            f"{gap:+.4f} ({gap / sd:+.1f} times the larger seed std {sd:.4f}, "
            "np.std as ACCURACY.md takes it)")


def phase_training(proj, device, profile=False, save=None):
    """The surrogate layer on the main path's data: bench.py's training
    lane, the float64 card-against-CPU sweep, and the H1 runs (``save``:
    their arrays' file); with
    ``profile`` the lane once more (a warm sweep and 2 more) under the
    profiler."""
    train_lane(proj, device)
    train_card_against_cpu(proj, device)
    train_h1(proj, device, save)
    if profile:
        from hippyflow_tpu_torch.applications.confusion_training import training_lane

        profile_run(f"training lane float32 nx={NX} (1 warm + 2 sweeps)",
                    lambda: training_lane(
                        proj.samples.ms, proj.samples.qs, proj.V_GN, sweeps=2,
                        n=TRAIN_N, in_rank=TRAIN_IN_RANK,
                        out_rank=TRAIN_OUT_RANK, device=device))


def _its(t) -> str:
    t = t.to(torch.float64)
    return f"max {int(t.max().item())} mean {t.mean().item():.3f}"


def setup_check_f64(device):
    """The float64 setup lane at nx=16 on the card and on the CPU from the
    same given noise; returns lane_difference's errors."""
    import numpy as np

    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
    )
    from hippyflow_tpu_torch.applications.confusion_setup import (
        lane_difference,
        setup_lane,
    )

    runs = []
    for dev in (device, torch.device("cpu")):
        kw = dict(dtype=torch.float64, device=dev)
        obs, Vh = confusion_linear_observable(
            nx=SETUP_CHECK_NX, velocity="analytic", **kw)
        with tempfile.TemporaryDirectory(prefix="setup_f64_") as out:
            runs.append(setup_lane(
                obs, confusion_prior(Vh, **kw), out, rank=16, n_samples=32,
                n_data=32, jacobian_rank=16, error_test_samples=8, seed=SEED,
                noise_rng=np.random.default_rng(SEED)))
    return lane_difference(*runs)


def phase_setup(obs32, prior32, device):
    """The setup driver's lane (``setup_lane``: input and output active
    subspaces, mass KLE, POD, the error tests, training data and the
    low-rank Jacobian data) in float32 at its defaults, then
    ``DataGenerator.generate`` with the POD decoder, into a temporary
    directory, counted; the directory read back through
    ``confusion_training``; the checks; the batched SVD of the lane's
    Jacobians timed alone; then the float64 card-against-CPU check at
    nx=16.  Returns the launches of the counted run."""
    import numpy as np

    from hippyflow_tpu_torch.applications.confusion_setup import setup_lane
    from hippyflow_tpu_torch.applications.confusion_training import (
        get_projectors,
        load_confusion_data,
    )
    from hippyflow_tpu_torch.models import DataGenerator
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    dM, dQ = obs32.dM, obs32.dQ
    r_out = min(SETUP_RANK, dQ)  # the POD's rank and the Jacobians' rank
    with tempfile.TemporaryDirectory(prefix="setup_smoke_") as out:
        torch.cuda.reset_peak_memory_stats()
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        res = setup_lane(obs32, prior32, out, rank=SETUP_RANK,
                         oversampling=OVERSAMPLING, n_samples=SETUP_N,
                         n_data=SETUP_N, jacobian_rank=SETUP_RANK,
                         error_test=True, error_test_samples=SETUP_ERROR_SAMPLES,
                         seed=SEED)
        t1 = time.perf_counter()
        DataGenerator(obs32, prior32, settings=dict(verbose=False, seed=SEED)
                      ).generate(SETUP_N, derivatives=(1, 0),
                                 output_decoder=res["pod_decoder"],
                                 data_dir=os.path.join(out, "data_generator"))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        m_data, q_data = load_confusion_data(out)
        proj = get_projectors(out, fixed_input_rank=SETUP_RANK,
                              fixed_output_rank=r_out)
        with np.load(os.path.join(out, "data_generator",
                                  "JstarPhi_data.npz")) as z:
            jsp_shape = z["JstarPhi_data"].shape
        with np.load(os.path.join(out, "jacobian_data", "Jsvd_data.npz")) as z:
            jsvd_shape = z["V_data"].shape
        # one host copy and npz write of the lane's SVD arrays (the
        # jacobian_data stage makes two: its chunk file and the bundle)
        t3 = time.perf_counter()
        np.savez(os.path.join(out, "svd_write.npz"), **{
            k: v.cpu().numpy() for k, v in zip("USV", res["jacobian_svd"])})
        write_s = time.perf_counter() - t3
    AS, KLE, POD = res["as"], res["kle"], res["pod"]
    # the batched SVD of the lane's Jacobians alone (its share of the
    # jacobian_data stage)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    torch.linalg.svd(AS.Js, full_matrices=False)
    e1.record()
    e1.synchronize()
    svd_s = e0.elapsed_time(e1) / 1e3
    st = res["seconds"]
    err = res["errors"]
    V, Vk = res["as_decoder"], res["kle_decoder"]
    eye = torch.eye(SETUP_RANK, dtype=V.dtype, device=V.device)
    ortho_as = (V.T @ prior32.R_matmat(V) - eye).abs().max().item()
    ortho_kle = (Vk.T @ prior32.M_matmat(Vk) - eye).abs().max().item()
    stages = ", ".join(f"{k} {v:.3f}" for k, v in st.items())
    io_its = torch.cat(POD.io_iterations)
    log(f"setup float32 nx={NX} samples={SETUP_N} data={SETUP_N} rank="
        f"{SETUP_RANK} (POD {POD.d.shape[0]}) jacobian rank {SETUP_RANK}: "
        f"lane {t1 - t0:.3f} s ({stages}), DataGenerator JstarPhi "
        f"{t2 - t1:.3f} s; batched SVD of the ({SETUP_N}, {dQ}, {dM}) "
        f"Jacobians alone {svd_s:.3f} s, one host copy and npz write of its "
        f"U, sigma, V {write_s:.3f} s; Newton iterations AS "
        f"{_its(AS.samples.iterations)}, POD {_its(POD.samples.iterations)}, "
        f"input-output re-solves "
        f"{_its(io_its)} ({sum(POD.io_failed)} unconverged); resampled "
        f"failures AS {AS.samples.n_failures} POD {POD.samples.n_failures}; "
        f"output_discarded {err['as'][('output_discarded', None)]}; launches "
        f"K1 {launches['banded_factorize']} K2 {launches['banded_solve']} "
        f"(panels {launches['banded_solve_panels']}, streamed "
        f"{launches['banded_solve_streamed']}) K3 {launches['batched_inverse']}; "
        f"peak {peak_gb:.2f} GB")
    ranks = [r for r, _ in err["input_output"]["rank_pairs"]]
    as_in = [err["as"][("input", r)][0] for r in ranks]
    as_out = [err["as"][("output", r)][0] for r in ranks]
    kle_e, pod_e = list(err["kle"][0]), list(err["pod"][0])
    log(f"setup errors at ranks {ranks}: AS input {[f'{x:.4e}' for x in as_in]}, "
        f"AS output {[f'{x:.4e}' for x in as_out]}, KLE "
        f"{[f'{x:.4e}' for x in kle_e]}, POD {[f'{x:.4e}' for x in pod_e]}, "
        f"input-output {[f'{x:.4e}' for x in err['input_output']['avg']]}; "
        f"max|V^T R V - I| {ortho_as:.3e}, KLE max|V^T M V - I| {ortho_kle:.3e}; "
        f"d_GN[:3] {[round(x, 6) for x in res['d_GN'][:3].tolist()]}")
    for name in ("d_GN", "d_NG", "d_KLE", "d_POD"):
        d = res[name]
        check(bool(torch.isfinite(d).all()), f"setup: non-finite {name}")
        check(bool((d[1:] <= d[:-1]).all()), f"setup: {name} is not descending")
    check(ortho_as <= ORTHO_TOL_F32, f"setup: AS max|V^T R V - I| {ortho_as:.3e}")
    check(ortho_kle <= ORTHO_TOL_F32, f"setup: KLE max|V^T M V - I| {ortho_kle:.3e}")
    for name, e in (("POD", pod_e), ("AS output", as_out)):
        check(all(b <= a for a, b in zip(e, e[1:])),
              f"setup: {name} errors rise with rank {e}")
    for name, e in (("KLE", kle_e), ("AS input", as_in)):
        check(e[-1] < e[0], f"setup: {name} error at rank {ranks[-1]} {e[-1]:.4e} "
              f"not below rank {ranks[0]}'s {e[0]:.4e}")
    check(err["as"][("output_discarded", None)] == 0, "setup: output_discarded")
    for key in ("banded_factorize", "banded_solve"):
        check(launches[key] > 0, f"{key} was not launched on setup")
    check(m_data.shape == (SETUP_N, dM) and q_data.shape == (SETUP_N, dQ),
          f"setup: mq_data {m_data.shape}, {q_data.shape}")
    shapes = {k: v.shape for k, v in proj.items()}
    check(shapes == {"AS_input": (dM, SETUP_RANK), "KLE": (dM, SETUP_RANK),
                     "POD": (dQ, r_out)}, f"setup: projectors {shapes}")
    check(jsp_shape == (SETUP_N, dM, r_out), f"setup: JstarPhi_data {jsp_shape}")
    check(jsvd_shape == (SETUP_N, dM, r_out), f"setup: Jsvd V_data {jsvd_shape}")
    del res, AS, KLE, POD
    torch.cuda.empty_cache()
    errs = setup_check_f64(device)
    worst = max(errs.values())
    log(f"setup float64 nx={SETUP_CHECK_NX} card against CPU: max relative "
        f"difference {worst:.3e} ({', '.join(f'{k} {v:.1e}' for k, v in errs.items())})"
        f" (limit {SETUP_F64_TOL:.0e})")
    check(worst <= SETUP_F64_TOL, f"setup float64: {worst:.3e} > {SETUP_F64_TOL}")
    return launches


# the control phase of chip_smoke.py: the nonlinear Poisson control problem
# of the reference's unit tests (hippyflow_tpu_torch.testing) at nx=ny=64
# (4225 dofs, s=nb=65), 10 pointwise observations, float32, seed 0
CONTROL_N, CONTROL_DENSE_N, CONTROL_ITERATIVE_N = 512, 64, 16
CONTROL_RANK = 10  # the POD decoder's rank (dQ = 10) and the Jz SVD's
# every other solver against auto on the same (m, z), relative to the
# largest entry: q and the sketches J^T Phi, Jz^T Phi.  float32 Newton stops
# at a relative residual of 1.2e-5 and the solves round at ~1e-7 times the
# operator's condition (~4e3 at nx=64), so two correct solvers may part by
# ~1e-4; a wrong factor parts by O(1)
CONTROL_TOL_F32 = 1e-3
# the float64 iterative solver (BiCGStab, tol 1e-10) against the direct
# solve: the Jacobians' linear solves stop at 1e-10 relative residual, so
# their error is below cond * 1e-10 ~ 1e-6; Newton's at 1e-9 of its first
# residual, within the same bound for q
CONTROL_TOL_ITERATIVE = 1e-6
# the long thin band on which auto takes cyclic reduction for the adjoint
# factor (s=9 < 128, nb=301 > 256), and its samples
THIN_NX, THIN_NY, THIN_N = 8, 300, 256
# float64 card against CPU at nx=16, steps 1 and 2
CONTROL_CHECK_NX, CONTROL_F64_TOL = 16, 1e-8


def control_problem(nx, dtype, device, ny=None, mesh=None, **pde_kwargs):
    """(observable, prior, control distribution) of the nonlinear Poisson
    control problem."""
    from hippyflow_tpu_torch.testing import (
        poisson_control_settings,
        poisson_pointwise_observable,
        setup_poisson_control_problem,
    )

    st = poisson_control_settings()
    st["nx"], st["ny"], st["LINEAR"] = nx, ny or nx, False
    pde, prior, dist, Vh = setup_poisson_control_problem(
        st, mesh=mesh, dtype=dtype, device=device, **pde_kwargs)
    return poisson_pointwise_observable(pde, Vh), prior, dist


def control_noise(n, noise_dim, dist, dtype, device, seed=SEED):
    """The given (noise (n, noise_dim), controls (n, dZ)) of the phase."""
    from hippyflow_tpu_torch.utils import KeyChain

    kc = KeyChain(seed, device)
    return kc.normal((n, noise_dim), dtype), dist.sample_n(kc, n, dtype)


def control_run(obs, prior, dist, out, noise, controls, Phi, derivatives=(1, 1)):
    """DataGenerator.generate on given noise and controls, counted: the
    launches, the generator (its stage seconds and Newton counts) and the
    arrays it wrote."""
    import numpy as np

    from hippyflow_tpu_torch.models import DataGenerator
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    hk.reset_launch_counts()
    t0 = time.perf_counter()
    gen = DataGenerator(obs, prior, control_distribution=dist,
                        settings=dict(verbose=False, seed=SEED))
    gen.generate(noise.shape[0], derivatives=derivatives, output_decoder=Phi,
                 data_dir=out, noise=noise, controls=controls)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    arrays = {}
    for name in ("mzq_data", "JstarPhi_data", "JzstarPhi_data"):
        path = os.path.join(out, name + ".npz")
        if os.path.exists(path):
            with np.load(path) as z:
                arrays.update({k: z[k] for k in z.files if k not in ("Phi", "MPhi")})
    return launches, gen, arrays, seconds


def _control_line(label, gen, seconds, launches, extra=""):
    st = ", ".join(f"{k} {v:.3f}" for k, v in gen.stage_seconds.items())
    n_fail = gen.samples["n_failures"]
    log(f"control {label}: {seconds:.3f} s ({st}); Newton "
        f"{_its(gen.samples['iterations'])}; unconverged (resampled) {n_fail}, "
        f"discarded {n_fail}; launches K1 {launches['banded_factorize']} K2 "
        f"{launches['banded_solve']} K3 {launches['batched_inverse']}{extra}")


def _arrays_rel(got, want, keys=("q_data", "JstarPhi_data", "JzstarPhi_data")):
    import numpy as np

    out = {}
    for k in keys:
        if k in got and k in want:
            w = np.asarray(want[k], dtype=np.float64)
            out[k] = float(np.abs(got[k] - w).max() / np.abs(w).max())
    return out


def _cr_levels(nb):
    n, levels = nb, 0
    while n > 1:
        n, levels = (n + 1) // 2, levels + 1
    return levels


def capture_k3_inputs(band, factorize=None):
    """The inputs of every K3 call that ``factorize(band)`` makes (by
    default the forward cyclic-reduction factor: one per level and the
    root), cloned."""
    from hippyflow_tpu_torch.ops import structured

    seen, real = [], structured.batched_inverse

    def record(X, *args, **kwargs):
        seen.append(X.clone())
        return real(X, *args, **kwargs)

    structured.batched_inverse = record
    try:
        if factorize is None:
            structured.factorize_block_cyclic_banded(band, with_transpose=False)
        else:
            factorize(band)
    finally:
        structured.batched_inverse = real
    return seen


def k3_cr_records(bands, label, factorize=None,
                  dtypes=(torch.float32, torch.float64)):
    """K3 against its plain version, torch.linalg.inv and the bound at
    every shape ``factorize`` (``capture_k3_inputs``) gives it on
    ``bands`` (N, nb, s, 3s) float64, in each of ``dtypes``.  Returns the
    records for the kernels' JSON line."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    records = {}
    for dtype in dtypes:
        for level, X in enumerate(capture_k3_inputs(bands.to(dtype),
                                                    factorize)):
            N, s, _ = X.shape
            Y = hk.batched_inverse(X)
            Y_p = hk.batched_inverse_plain(X)
            torch.cuda.synchronize()
            diff = rel_err(Y, Y_p)
            eye = torch.eye(s, dtype=torch.float64, device=X.device)
            res = (X.double() @ Y.double() - eye).abs().max().item()
            res_inv = (X.double() @ torch.linalg.inv(X).double()
                       - eye).abs().max().item()
            check(diff <= TOL_INV[dtype]["diff"],
                  f"K3 {label} level {level} {dtype}: kernel vs plain {diff:.3e}")
            ms, plain_ms = paired_ms(lambda: hk.batched_inverse(X),
                                     lambda: hk.batched_inverse_plain(X), 3)
            inv_ms = cuda_ms(lambda: torch.linalg.inv(X), 3)
            b_ms, b_by = k3_bound(N, s, dtype)
            tag = (f"{label}{level}_n{N}_s{s}"
                   + ("" if dtype == torch.float32 else "_f64"))
            records.update({f"max_abs_err_{tag}": (Y - Y_p).abs().max().item(),
                            f"ms_{tag}": ms, f"plain_ms_{tag}": plain_ms,
                            f"inv_ms_{tag}": inv_ms, **bound_keys(tag, b_ms, b_by)})
            log(f"K3 {label} level {level} {str(dtype)[6:]} N={N} s={s}: rel "
                f"diff {diff:.3e}, max|X X^-1 - I| {res:.3e} (torch.linalg.inv "
                f"{res_inv:.3e}); K3 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.linalg.inv {inv_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            del X, Y, Y_p
    return records


@contextlib.contextmanager
def band_kernel_shapes():
    """Within the block, the shape of every K1 and K2 call that the PDE
    problem's band factors make (through ``ops.structured``): a set of
    ("K1", N, nb, s) and ("K2", N, nb, s, k, trans)."""
    from hippyflow_tpu_torch.ops import structured

    seen, fac, sol = set(), structured.banded_factorize, structured.banded_solve

    def factorize(band, *args, **kwargs):
        seen.add(("K1",) + tuple(band.shape[:3]))
        return fac(band, *args, **kwargs)

    def solve(M, Dinv, B, bb, trans, *args, **kwargs):
        seen.add(("K2",) + tuple(bb.shape) + (bool(trans),))
        return sol(M, Dinv, B, bb, trans, *args, **kwargs)

    structured.banded_factorize, structured.banded_solve = factorize, solve
    try:
        yield seen
    finally:
        structured.banded_factorize, structured.banded_solve = fac, sol


def k12_shape_records(band64, shapes, label, indefinite=False):
    """K1 and K2 against their plain versions at every shape of ``shapes``
    (from ``band_kernel_shapes``), on the first N samples of the float64
    bands ``band64`` and seeded right-hand sides, in both dtypes, with the
    residual of K2's solves; float32 times in turns with the plain
    versions, beside the bound.  ``indefinite`` bands (no pivoting in the
    kernels) also solve through the pivoted plain pair, and the kernels'
    residual may exceed TOL's where it stays within PIVOT_FACTOR of the
    pair's, as on the helmholtz bands.  Returns (K1's, K2's) records for
    the kernels' JSON line."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    N0, nb0, s0, _ = band64.shape
    gen = torch.Generator(device=band64.device).manual_seed(SEED)
    records = {"K1": {}, "K2": {}}
    for key in sorted(shapes):
        N, nb, s = key[1:4]
        check((nb, s) == (nb0, s0) and N <= N0, f"{label}: no band for {key}")
        sub64 = band64[:N]
        if key[0] == "K2":
            k, trans = key[4:]
            rhs64 = torch.randn(N, nb, s, k, generator=gen, dtype=torch.float64,
                                device=band64.device)
            tag = f"{label}_k{k}_{'trans' if trans else 'fwd'}_n{N}_s{s}"
        else:
            tag = f"{label}_n{N}_s{s}"
        rec, line = records[key[0]], f"{key[0]} {label} N={N} nb={nb} s={s}"
        if key[0] == "K2":
            line += f" k={k} trans={trans}"
        for dtype in (torch.float32, torch.float64):
            band = sub64.to(dtype)
            M, Dinv = hk.banded_factorize(band)
            sfx = "" if dtype == torch.float32 else "_f64"
            if key[0] == "K1":
                M_p, D_p = hk.banded_factorize_plain(band)
                torch.cuda.synchronize()
                rel = max(rel_err(M, M_p), rel_err(Dinv, D_p))
                err = max((M - M_p).abs().max().item(),
                          (Dinv - D_p).abs().max().item())
                res = None
                run = lambda: hk.banded_factorize(band)
                plain = lambda: hk.banded_factorize_plain(band)
                del M_p, D_p
            else:
                B, bb = band[..., 2 * s :].contiguous(), rhs64.to(dtype)
                x = hk.banded_solve(M, Dinv, B, bb, trans)
                x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
                torch.cuda.synchronize()
                rel, err = rel_err(x, x_p), (x - x_p).abs().max().item()
                apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
                b_flat = rhs64.reshape(N, nb * s, k)

                def residual(sol):
                    return (torch.linalg.vector_norm(
                        apply(sub64, sol.double().reshape(N, nb * s, k)) - b_flat)
                        / torch.linalg.vector_norm(b_flat)).item()

                res = residual(x)
                if indefinite:
                    res_p = residual(hk.banded_solve_plain(
                        *hk.banded_factorize_plain(band), B, bb, trans))
                run = lambda: hk.banded_solve(M, Dinv, B, bb, trans)
                plain = lambda: hk.banded_solve_plain(M, Dinv, B, bb, trans)
                del x, x_p
            tol = TOL[dtype]
            check(rel <= tol["diff"],
                  f"{key[0]} {label} {key[1:]} {dtype}: vs plain {rel:.3e}")
            if res is not None:
                limit = tol["residual"]
                if indefinite:
                    limit = max(limit, PIVOT_FACTOR * res_p)
                check(res <= limit,
                      f"K2 {label} {key[1:]} {dtype}: residual {res:.3e}")
            rec[f"max_abs_err_{tag}{sfx}"] = err
            line += f"; {str(dtype)[6:]} rel diff {rel:.3e}" + (
                "" if res is None else f" residual {res:.3e}") + (
                f" (pivoted plain pair {res_p:.3e})"
                if res is not None and indefinite else "")
            if dtype == torch.float32:
                ms, plain_ms = paired_ms(run, plain, 3)
                b_ms, b_by = (k1_bound(N, nb, s, dtype) if key[0] == "K1"
                              else k2_bound(N, nb, s, k, dtype))
                rec.update({f"ms_{tag}": ms, f"plain_ms_{tag}": plain_ms,
                            **bound_keys(tag, b_ms, b_by)})
                line += (f", {ms:.4f} ms (plain {plain_ms:.4f}, bound "
                         f"{b_ms:.5f} ({b_by}))")
            del band, M, Dinv, run, plain
        log(line)
    return records["K1"], records["K2"]


def control_check_f64(device):
    """Steps 1 and 2 in float64 at nx=16 on the card and on the CPU from
    the same given noise and controls: the largest relative difference of
    q, J^T Phi and Jz^T Phi."""
    import numpy as np

    runs = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        for solver in ("auto", "block_cyclic"):
            obs, prior, dist = control_problem(CONTROL_CHECK_NX, torch.float64,
                                               dev, solver=solver)
            noise, controls = control_noise(32, prior.noise_dim, dist,
                                            torch.float64, torch.device("cpu"))
            Phi = np.linalg.qr(np.random.default_rng(SEED).standard_normal(
                (obs.dQ, obs.dQ)))[0]
            with tempfile.TemporaryDirectory(prefix="control_f64_") as out:
                runs[(where, solver)] = control_run(
                    obs, prior, dist, out, noise.to(dev), controls.to(dev),
                    Phi)[2]
    return {solver: max(_arrays_rel(runs[("card", solver)],
                                    runs[("cpu", solver)]).values())
            for solver in ("auto", "block_cyclic")}


def phase_control(device):
    """The control paths on the Poisson control problem at nx=64: the
    steps of each solver choice, each counted as its own path, then K3 at
    the cyclic-reduction shapes and the float64 card-against-CPU check.
    Returns (launches by path, the records of K1, K2 and K3 by kernel)."""
    import numpy as np

    from hippyflow_tpu_torch.fem import Mesh2D, rectangle_mesh
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
        PODParameterList,
        PODProjector,
        fresh_solves,
        materialize_jacobians,
        sample_until_solved,
    )
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    f32, f64 = torch.float32, torch.float64
    paths, t_phase = {}, time.perf_counter()
    obs, prior, dist = control_problem(NX, f32, device)
    noise, controls = control_noise(CONTROL_N, prior.noise_dim, dist, f32, device)
    tmp = tempfile.TemporaryDirectory(prefix="control_smoke_")
    d = lambda name: os.path.join(tmp.name, name)

    # 1. auto: a POD decoder, DataGenerator, the control Jacobians' SVD;
    # the shapes of its K1 and K2 calls are held in step 8
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    with band_kernel_shapes() as shapes_auto:
        pp = PODParameterList()
        pp["sample_per_process"], pp["rank"], pp["verbose"] = (
            64, CONTROL_RANK, False)
        pod = PODProjector(obs, prior, control_distribution=dist, parameters=pp)
        _, Phi, _ = pod.construct_subspace()
        Phi = Phi.cpu().numpy()
        t_pod = time.perf_counter() - t0
        launches_pod = launch_counts()
        launches, gen, ref, seconds = control_run(obs, prior, dist, d("auto"),
                                                  noise, controls, Phi)
        ap = ActiveSubspaceParameterList()
        ap["samples_per_process"], ap["jacobian_rank"] = CONTROL_N, CONTROL_RANK
        ap["verbose"], ap["seed"] = False, SEED
        t1 = time.perf_counter()
        asp = ActiveSubspaceProjector(obs, prior, parameters=ap,
                                      control_distribution=dist)
        Uz, sz, Vz = asp.construct_low_rank_control_Jacobians(d("jacobian_data"))
        torch.cuda.synchronize()
        t_svd = time.perf_counter() - t1
    # control_run set the counts to 0, so these hold its launches and the
    # projector's
    launches_as = launch_counts()
    paths["control"] = {k: launches_pod[k] + launches_as[k] for k in launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    _control_line(f"auto float32 nx={NX} samples={CONTROL_N}", gen, seconds,
                  launches, f"; POD decoder {t_pod:.3f} s; "
                  f"construct_low_rank_control_Jacobians rank {CONTROL_RANK} "
                  f"{t_svd:.3f} s (Newton {_its(asp.samples.iterations)}, "
                  f"resampled {asp.samples.n_failures}); peak {peak:.2f} GB")
    q_ref = ref["q_data"]
    check(q_ref.shape == (CONTROL_N, obs.dQ) and ref["z_data"].shape == (
        CONTROL_N, 25), f"control: mzq shapes {q_ref.shape}")
    check(ref["JstarPhi_data"].shape == (CONTROL_N, obs.dM, CONTROL_RANK)
          and ref["JzstarPhi_data"].shape == (CONTROL_N, 25, CONTROL_RANK),
          "control: sketch shapes")
    check(all(np.isfinite(v).all() for v in ref.values()), "control: non-finite")
    check(Uz.shape == (CONTROL_N, obs.dQ, CONTROL_RANK)
          and bool(torch.isfinite(sz).all()) and bool((sz[:, 1:] <= sz[:, :-1]).all()),
          "control: Jz SVD")
    with np.load(d("jacobian_data/Jzsvd_data.npz")) as z:
        check(sorted(z.files) == ["Uz_data", "Vz_data", "sigmaz_data"],
              f"control: Jzsvd files {z.files}")
    for key in ("banded_factorize", "banded_solve"):
        check(paths["control"][key] > 0, f"{key} was not launched on control")
    check(int(gen.samples["iterations"].max()) >= 2, "control: Newton did not run")

    # 2-4. the direct solver choices on the same (m, z)
    n_levels = _cr_levels(NX + 1)
    for solver, n in (("block_cyclic", CONTROL_N), ("block_tridiag", CONTROL_N),
                      ("dense", CONTROL_DENSE_N)):
        o, p, dist_s = control_problem(NX, f32, device, solver=solver)
        torch.cuda.reset_peak_memory_stats()
        launches, g, arr, seconds = control_run(o, p, dist_s, d(solver),
                                                noise[:n], controls[:n], Phi)
        name = {"block_cyclic": "control_cr", "block_tridiag": "control_tridiag",
                "dense": "control_dense"}[solver]
        paths[name] = launches
        rel = _arrays_rel(arr, {k: v[:n] for k, v in ref.items()})
        worst = max(rel.values())
        k3 = launches["batched_inverse"]
        _control_line(f"{solver} float32 nx={NX} samples={n}", g, seconds,
                      launches, f"; against auto: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
                      + f" (limit {CONTROL_TOL_F32:.0e}); peak "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check(worst <= CONTROL_TOL_F32, f"control {solver}: {worst:.3e} from auto")
        if solver == "block_cyclic":
            # each factorization makes one K3 call per level and one at the
            # root, for A (Newton) or A^T (the two Jacobians) alone
            check(k3 > 0 and k3 % (n_levels + 1) == 0,
                  f"control_cr: {k3} K3 launches, not a multiple of "
                  f"{n_levels + 1}")
            log(f"control_cr K3 launches {k3} = {k3 // (n_levels + 1)} "
                f"factorizations x ({n_levels} levels + root)")
        else:
            check(k3 == 0, f"{name}: K3 launched")
        del o, p

    # 5. iterative, float64, against the direct float64 solve
    n = CONTROL_ITERATIVE_N
    runs = {}
    for solver in ("auto", "iterative"):
        o, p, dist_s = control_problem(NX, f64, device, solver=solver)
        launches, g, arr, seconds = control_run(
            o, p, dist_s, d(f"{solver}64"), noise[:n].double(),
            controls[:n].double(), Phi)
        runs[solver] = (o, arr)
        if solver == "iterative":
            paths["control_iterative"] = launches
            rel = _arrays_rel(arr, runs["auto"][1])
            m = torch.as_tensor(arr["m_data"], device=device)
            z = torch.as_tensor(arr["z_data"], device=device)
            u, _ = o.problem.solve_fwd(m, z)
            lin = o.problem.linearize(u, m, z)
            Bt = o.B.dense().T.expand(n, -1, -1)
            _, info = o.problem.solve_incremental(lin, Bt, is_adj=True,
                                                  return_info=True)
            worst_res = info.max().item()
            _control_line(f"iterative float64 nx={NX} samples={n}", g, seconds,
                          launches, "; against the direct float64 solve: "
                          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
                          + f" (limit {CONTROL_TOL_ITERATIVE:.0e}); worst "
                          f"solve_info residual {worst_res:.3e}")
            check(max(rel.values()) <= CONTROL_TOL_ITERATIVE,
                  f"control iterative: {max(rel.values()):.3e} from direct")
            check(worst_res <= 1e-10, f"control iterative: solve_info {worst_res:.3e}")

    # 6. the nx=64 mesh renumbered, no structured shape: dense and iterative
    base = rectangle_mesh(NX, NX)
    perm = np.random.default_rng(SEED).permutation(base.num_vertices)
    mesh = Mesh2D(base.vertices[perm], np.argsort(perm)[base.cells].astype(np.int32),
                  base.boundary_mask[perm])
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    line = []
    for solver, dtype, n, want in (("dense", f32, CONTROL_DENSE_N, ref),
                                   ("iterative", f64, 4, runs["iterative"][1])):
        o, _, _ = control_problem(NX, dtype, device, mesh=mesh, solver=solver)
        m = torch.as_tensor(want["m_data"][:n], dtype=dtype, device=device)
        z = torch.as_tensor(want["z_data"][:n], dtype=dtype, device=device)
        q, ok, its = fresh_solves(o, m[:, perm], zs=z)
        check(bool(ok.all()), f"control unstructured {solver}: unconverged")
        w = want["q_data"][:n]
        rel = float(np.abs(q.cpu().numpy() - w).max() / np.abs(w).max())
        tol = CONTROL_TOL_F32 if dtype == f32 else CONTROL_TOL_ITERATIVE
        check(rel <= tol, f"control unstructured {solver}: q {rel:.3e}")
        line.append(f"{solver} {str(dtype)[6:]} samples={n} q {rel:.3e} (limit "
                    f"{tol:.0e}), Newton {_its(its)}")
        del o
    torch.cuda.synchronize()
    paths["control_unstructured"] = launch_counts()
    log(f"control unstructured nx={NX} (permuted, structured_shape=None): "
        f"{time.perf_counter() - t0:.3f} s; " + "; ".join(line))

    # 7. auto on the long thin band: thomas_inv forward, cyclic reduction
    # for the adjoint factor, against an explicit thomas_inv run
    o, p, dist_t = control_problem(THIN_NX, f32, device, ny=THIN_NY)
    check((o.problem.adj_solver, o.problem.fwd_solver)
          == ("block_cyclic", "thomas_inv"),
          f"thin: auto picked {o.problem.adj_solver}")
    o_t, _, _ = control_problem(THIN_NX, f32, device, ny=THIN_NY,
                                solver="thomas_inv")
    from hippyflow_tpu_torch.utils import KeyChain

    hk.reset_launch_counts()
    t0 = time.perf_counter()
    with band_kernel_shapes() as shapes_thin:
        batch = sample_until_solved(o, p, KeyChain(SEED, device), THIN_N,
                                    control_distribution=dist_t)
        J = materialize_jacobians(o, batch.ms, batch.us, batch.zs)
        Jz = materialize_jacobians(o, batch.ms, batch.us, batch.zs, control=True)
        torch.cuda.synchronize()
    paths["control_thin"] = launch_counts()
    t_thin = time.perf_counter() - t0
    J_t = materialize_jacobians(o_t, batch.ms, batch.us, batch.zs)
    Jz_t = materialize_jacobians(o_t, batch.ms, batch.us, batch.zs, control=True)
    rel_j, rel_jz = rel_err(J, J_t), rel_err(Jz, Jz_t)
    k3 = paths["control_thin"]["batched_inverse"]
    nl = _cr_levels(THIN_NY + 1)
    log(f"control thin float32 nx={THIN_NX} ny={THIN_NY} (s={THIN_NX + 1}, "
        f"nb={THIN_NY + 1}) samples={THIN_N}: {t_thin:.3f} s; Newton "
        f"{_its(batch.iterations)}; J against thomas_inv {rel_j:.3e}, Jz "
        f"{rel_jz:.3e} (limit {CONTROL_TOL_F32:.0e}); launches K1 "
        f"{paths['control_thin']['banded_factorize']} K2 "
        f"{paths['control_thin']['banded_solve']} K3 {k3} (2 adjoint "
        f"factorizations x ({nl} levels + root))")
    check(max(rel_j, rel_jz) <= CONTROL_TOL_F32, "control thin: J from thomas_inv")
    check(k3 == 2 * (nl + 1), f"control thin: K3 launches {k3}")
    o64, _, _ = control_problem(THIN_NX, f64, device, ny=THIN_NY)
    thin_band = bc_symmetrize_banded_masked(
        o64.problem.bound.assemble_A_banded(batch.us.double(), batch.ms.double(),
                                            batch.zs.double()),
        o64.problem._mask)
    del o, o_t, o64, J, Jz, J_t, Jz_t, batch
    torch.cuda.empty_cache()

    # 8. K3 against its plain version at every cyclic-reduction shape, and
    # K1 and K2 at every shape that steps 1 and 7 gave them
    m = torch.as_tensor(ref["m_data"], device=device, dtype=f64)
    z = torch.as_tensor(ref["z_data"], device=device, dtype=f64)
    o64, _, _ = control_problem(NX, f64, device, solver="block_cyclic")
    u, _ = o64.problem.solve_fwd(m, z)
    band = bc_symmetrize_banded_masked(o64.problem.bound.assemble_A_banded(u, m, z),
                                       o64.problem._mask)
    del o64, u
    torch.cuda.empty_cache()
    records = {"batched_inverse": k3_cr_records(band, "control_cr")}
    records["banded_factorize"], records["banded_solve"] = k12_shape_records(
        band, shapes_auto, "control")
    del band
    torch.cuda.empty_cache()
    records["batched_inverse"].update(k3_cr_records(thin_band, "control_thin"))
    for name, shapes in (("control", shapes_auto), ("control_thin", shapes_thin)):
        check({key[0] for key in shapes} == {"K1", "K2"},
              f"{name}: K1 and K2 shapes {sorted(shapes)}")
    k1_thin, k2_thin = k12_shape_records(thin_band, shapes_thin, "control_thin")
    records["banded_factorize"].update(k1_thin)
    records["banded_solve"].update(k2_thin)
    del thin_band
    tmp.cleanup()
    torch.cuda.empty_cache()

    # 9. float64 card against CPU at nx=16
    errs = control_check_f64(device)
    worst = max(errs.values())
    log(f"control float64 nx={CONTROL_CHECK_NX} card against CPU: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (limit {CONTROL_F64_TOL:.0e}); phase {time.perf_counter() - t_phase:.1f} s")
    check(worst <= CONTROL_F64_TOL, f"control float64: {worst:.3e}")
    return paths, records


# the models phase of chip_smoke.py: the modeling layer's last modules (the
# inverse-problem wrapper, multi-source problems, the full-state observable
# in its three strategies, the double-loop error test, two-step data
# generation, the boundary KLE, the Laplacian prior, the POD extras and
# constrained Newton), float32, seed 0, at the main path's width: confusion
# at nx=64 (the cached velocity, 100 observations, the dense prior) and the
# control lane's Poisson problem at nx=ny=64 (4225 dofs, s=nb=65)
MODELS_FULL = dict(
    nx=NX, n=64, directions=16, low_rank=20, sources=4, n_obs=10,
    fs_rank=40, fs_oversampling=10, fs_chunk=16,
    dl_samples=256, dl_rank=100, dl_ranks=(8, 32, 100), dl_outer=32,
    dl_inner=4, ts_n=256, ts_pod_rank=32, ts_chunk=16)
# items 1-5 again in float64 at nx=16 (the analytic velocity), on the card
# and on the CPU from the same draws: every array within MODELS_F64_TOL
MODELS_CHECK = dict(
    nx=16, n=8, directions=4, low_rank=5, sources=4, n_obs=10,
    fs_rank=10, fs_oversampling=5, fs_chunk=3,
    dl_samples=16, dl_rank=20, dl_ranks=(2, 8, 20), dl_outer=8,
    dl_inner=2, ts_n=16, ts_pod_rank=8, ts_chunk=4)
MODELS_F64_TOL = 1e-8
# float32 limits, each relative to the largest entry: the Gauss-Newton
# Hessian's symmetry <x, H y> = <H x, y> (J and J^T through separate
# solves, rounding at ~1e-7 times the operator's condition), the batched
# against the serialized spectrum (the same products summed in another
# order), the multi-source dot test, each problem alone, and
# ||J - U S V^T||_2 against sigma_{r+1}
MODELS_TOL_F32 = 1e-4
# float64 limits of the same checks (the card-against-CPU lane); the
# gradient's central difference (eps 1e-6, Newton to 1e-9 relative) in
# float64 at nx=64 on 4 samples
MODELS_TOL_F64 = 1e-9
MODELS_FD_SAMPLES, MODELS_FD_TOL = 4, 1e-6
# item 6: the boundary KLE at rank 100 on the nx=64 dense prior, the
# Laplacian prior's samples and mass KLE, and constrained Newton in float64
# on a P1 energy at nx=32 (1089 dofs), card against CPU
MODELS_KLE_RANK, MODELS_NEWTON_NX, MODELS_NEWTON_TOL = 100, 32, 1e-10


def _models_tol(dtype):
    return MODELS_TOL_F32 if dtype == torch.float32 else MODELS_TOL_F64


class _Item:
    """One item of the models phase, counted: wall seconds (ended by a
    device synchronize), every kernel's launches and the peak memory above
    what was allocated before it (GB; None on the CPU)."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from hippyflow_tpu_torch.ops import hopper_kernels as hk

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.base = torch.cuda.memory_allocated()
        hk.reset_launch_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.launches = launch_counts()
        self.peak = ((torch.cuda.max_memory_allocated() - self.base) / 1e9
                     if cuda else None)
        return False

    def line(self):
        l = self.launches
        peak = "" if self.peak is None else f", peak {self.peak:.3f} GB"
        return (f"{self.seconds:.3f} s, launches K1 {l['banded_factorize']} K2 "
                f"{l['banded_solve']} (panels {l['banded_solve_panels']}, "
                f"streamed {l['banded_solve_streamed']}) K3 "
                f"{l['batched_inverse']}{peak}")


@contextlib.contextmanager
def _no_materialize():
    """Within the block ObservableJacobian.materialize raises: the
    matrix-free strategies never form a Jacobian."""
    from hippyflow_tpu_torch.models import ObservableJacobian

    real = ObservableJacobian.materialize

    def refuse(self, lin):
        raise AssertionError("materialize called on a matrix-free path")

    ObservableJacobian.materialize = refuse
    try:
        yield
    finally:
        ObservableJacobian.materialize = real


def _given(seed, device):
    import numpy as np

    from hippyflow_tpu_torch.utils import GivenNoise

    return GivenNoise(np.random.default_rng(seed), device)


def _models_confusion(dtype, device, nx):
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
        load_ns_velocity,
    )

    vel = load_ns_velocity(nx) if nx in (NX, NX192) else "analytic"
    obs, Vh = confusion_linear_observable(nx=nx, velocity=vel, dtype=dtype,
                                          device=device)
    return obs, confusion_prior(Vh, dtype=dtype, device=device)


def _models_poisson(dtype, device, nx):
    """The control lane's nonlinear Poisson problem: (pde, prior, control
    distribution, space, settings)."""
    from hippyflow_tpu_torch.testing import (
        poisson_control_settings,
        setup_poisson_control_problem,
    )

    st = poisson_control_settings()
    st["nx"], st["ny"], st["LINEAR"] = nx, nx, False
    pde, prior, dist, Vh = setup_poisson_control_problem(st, dtype=dtype,
                                                         device=device)
    return pde, prior, dist, Vh, st


def models_wrapper(dtype, device, z, arrays, checks):
    """Item 1: ModelWrapper on confusion: data at a drawn mtrue
    (rel_noise 0.01), on z['n'] prior samples the costs, the variational
    gradients and the mass- and R-preconditioned gradients, the GN
    Hessian on z['directions'] directions a sample with its symmetry, and
    the rank-z['low_rank'] Jacobian against the dense one."""
    from hippyflow_tpu_torch.models import ModelWrapper

    obs, prior = _models_confusion(dtype, device, z["nx"])
    w = ModelWrapper(obs, prior)
    w.keychain = _given(SEED, device)
    mis = w.setUpInverseProblem(rel_noise=0.01)
    m = w.samplePrior(z["n"])
    arrays["wrapper_d"] = mis.d
    arrays["wrapper_cost"] = w.evalCost(m)
    arrays["wrapper_grad_misfit"] = w.evalVariationalGradient(m)
    arrays["wrapper_grad"] = w.evalVariationalGradient(m, misfit_only=False)
    arrays["wrapper_grad_mass"] = w.evalGradient(m, misfit_only=False)
    arrays["wrapper_grad_R"] = w.evalGradient(m, misfit_only=False,
                                              invert_regularization=True)
    lin = obs.linearize(m)
    X = w.keychain.normal((z["n"], w.dM, z["directions"]), dtype=dtype)
    HX = w.evalGNHessian(X, lin=lin)
    G = X.mT @ HX  # (n, k, k): symmetric where H is
    asym = ((G - G.mT).abs().amax(dim=(1, 2)) / G.abs().amax(dim=(1, 2))).max().item()
    r = z["low_rank"]
    U, s, V = w.evalLowRankJacobian(r, lin=lin)
    Jd = w.evalJacobian(lin=lin)
    s_all = torch.linalg.svdvals(Jd)
    err = torch.linalg.matrix_norm(Jd - (U * s[:, None, :]) @ V.mT, ord=2)
    low_rank = ((err - s_all[:, r]).abs() / s_all[:, 0]).max().item()
    arrays["wrapper_HX"], arrays["wrapper_sigma"] = HX, s
    arrays["wrapper_low_rank"] = (U * s[:, None, :]) @ V.mT
    tol = _models_tol(dtype)
    for key in ("wrapper_cost", "wrapper_grad", "wrapper_grad_mass",
                "wrapper_grad_R", "wrapper_HX", "wrapper_sigma"):
        checks.append((bool(torch.isfinite(arrays[key]).all()), f"{key} finite"))
    checks.append((asym <= tol, f"wrapper: <x, H y> - <H x, y> {asym:.3e}"))
    checks.append((low_rank <= tol, f"wrapper: ||J - U S V^T|| - sigma_r+1 {low_rank:.3e}"))
    checks.append((bool((arrays["wrapper_cost"] > 0).all()), "wrapper: cost > 0"))
    return (f"noise variance {mis.noise_variance:.4e}, cost mean "
            f"{arrays['wrapper_cost'].mean().item():.4e}, GN symmetry {asym:.3e}, "
            f"rank-{r} J error against sigma_{r + 1} {low_rank:.3e}")


def models_multi(dtype, device, z, arrays, checks):
    """Item 2: MultiPDEProblem of z['sources'] Poisson problems sharing m,
    each with a fixed control as its source, z['n_obs'] pointwise
    observations: the states against each problem alone and against the
    control problem at that control, q the sum, a Jacobian dot test."""

    from hippyflow_tpu_torch.fem import GalerkinForm
    from hippyflow_tpu_torch.models import (
        MultiPDEProblem,
        MultiStateLinearObservable,
        ObservableJacobian,
        VariationalPDEProblem,
    )
    from hippyflow_tpu_torch.testing import make_poisson_varf, poisson_pointwise_observable

    pde, prior, dist, Vh, st = _models_poisson(dtype, device, z["nx"])
    kc = _given(SEED + 1, device)
    controls = dist.sample_n(kc, z["sources"], dtype)
    base = make_poisson_varf(st)

    def fixed(zk):
        def source(x, u, gu, m, _z, c):
            return base.source(x, u, gu, m, zk.expand(m.shape[0], -1), c)

        form = GalerkinForm(flux=base.flux, source=source, quad_degree=4,
                            symmetric=True)
        return VariationalPDEProblem(Vh, Vh, form, pde.bc, is_fwd_linear=False,
                                     dtype=dtype, device=device)

    problems = [fixed(zk) for zk in controls]
    B = poisson_pointwise_observable(pde, Vh, z["n_obs"]).B
    mobs = MultiStateLinearObservable(MultiPDEProblem(problems), B)
    m = prior.sample(kc.normal((z["n"], prior.noise_dim), dtype=dtype))
    u, info = mobs.solve_fwd(m)
    q = mobs.evalu(u)
    tol = _models_tol(dtype)
    alone = max(rel_err(u[k], p.solve_fwd(m)[0]) for k, p in enumerate(problems))
    control = max(rel_err(u[k], pde.solve_fwd(m, z=zk.expand(z["n"], -1))[0])
                  for k, zk in enumerate(controls))
    summed = rel_err(q, sum(B.apply(u[k]) for k in range(len(problems))))
    J = ObservableJacobian(mobs)
    lins = mobs.linearize(m, u=u)
    dm = kc.normal((z["n"], mobs.dM), dtype=dtype)
    dq = kc.normal((z["n"], mobs.dQ), dtype=dtype)
    Jdm, Jtdq = J.mult(lins, dm), J.transpmult(lins, dq)
    lhs, rhs = (dq * Jdm).sum(dim=1), (Jtdq * dm).sum(dim=1)
    dot = ((lhs - rhs).abs() / (dq.norm(dim=1) * Jdm.norm(dim=1))).max().item()
    arrays.update(multi_u=u, multi_q=q, multi_Jdm=Jdm, multi_Jtdq=Jtdq)
    checks += [(bool(info.converged.all()), "multi: unconverged"),
               (u.shape == (len(problems), z["n"], Vh.dim), f"multi: u {tuple(u.shape)}"),
               (alone <= tol, f"multi: against each problem alone {alone:.3e}"),
               (control <= tol, f"multi: against the control problem {control:.3e}"),
               (summed <= tol, f"multi: q against the sum {summed:.3e}"),
               (dot <= tol, f"multi: dot test {dot:.3e}")]
    return (f"k={len(problems)}, Newton {_its(info.iterations)}; against each "
            f"problem alone {alone:.3e}, the control problem {control:.3e}, q the "
            f"sum {summed:.3e}, dot test {dot:.3e}")


def models_full_state(dtype, device, z, arrays, checks, items):
    """Item 3: the input subspace of the full-state Poisson observable
    (B = I, B^T = M) on one batch of solved samples and one probe, three
    ways: batched matrix-free, serialized (chunks of z['fs_chunk']) and the
    unpreconditioned HEP; each counted into ``items`` with Jacobian
    materialization refused.  Returns the line's text."""
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
        SampleBatch,
    )
    from hippyflow_tpu_torch.testing import poisson_full_state_observable

    pde, prior, dist, Vh, _ = _models_poisson(dtype, device, z["nx"])
    fobs = poisson_full_state_observable(pde, Vh)
    kc = _given(SEED + 2, device)
    ms = prior.sample(kc.normal((z["n"], prior.noise_dim), dtype=dtype))
    zs = dist.sample_n(kc, z["n"], dtype)
    us, info = pde.solve_fwd(ms, z=zs)
    batch = SampleBatch(ms=ms, us=us, qs=fobs.evalu(us), n_failures=0,
                        iterations=info.iterations, zs=zs)
    r, p = z["fs_rank"], z["fs_oversampling"]
    Omega = kc.normal((Vh.dim, r + p), dtype=dtype)
    runs, parts = {}, []
    for way, serialized, pp in (("batched", False, True),
                                ("serialized", True, True),
                                ("hep", False, False)):
        params = ActiveSubspaceParameterList()
        params["rank"], params["oversampling"] = r, p
        params["samples_per_process"], params["verbose"] = z["n"], False
        params["serialized_sampling"], params["chunk_size"] = serialized, z["fs_chunk"]
        proj = ActiveSubspaceProjector(fobs, prior, parameters=params,
                                       control_distribution=dist)
        proj.samples, proj.Omega_GN = batch, Omega
        with _Item(device) as it, _no_materialize():
            d, V, E = proj.construct_input_subspace(prior_preconditioned=pp)
        runs[way] = (d, V, E, proj, it)
        items[f"models_fs_{way}"] = it
        W = prior.R_matmat(V) if pp else V
        ortho = (V.T @ W - torch.eye(r, dtype=dtype, device=device)).abs().max().item()
        checks += [(bool(torch.isfinite(d).all()) and bool((d[1:] <= d[:-1]).all()),
                    f"full state {way}: spectrum"),
                   (ortho <= (ORTHO_TOL_F32 if dtype == torch.float32 else 1e-8),
                    f"full state {way}: orthonormality {ortho:.3e}"),
                   (proj.Js is None, f"full state {way}: Jacobians formed")]
        arrays[f"fs_d_{way}"] = d
        if z["nx"] <= 16:  # the leading projector, for the card-against-CPU check
            arrays[f"fs_P_{way}"] = V[:, :4] @ E[:, :4].T
        st = ", ".join(f"{k} {v:.3f}" for k, v in proj.stage_seconds.items())
        parts.append(f"{way}: {it.line()} ({st}); max|V^T W V - I| {ortho:.2e}")
    d_b, d_s = runs["batched"][0], runs["serialized"][0]
    rel = ((d_b - d_s).abs() / d_b[0].abs()).max().item()
    checks.append((rel <= _models_tol(dtype),
                   f"full state: batched against serialized {rel:.3e}"))
    if device.type == "cuda":
        pb, ps = runs["batched"][4].peak, runs["serialized"][4].peak
        checks.append((ps < pb, f"full state: serialized peak {ps:.3f} GB not "
                       f"below batched {pb:.3f} GB"))
    return (f"rank {r}, oversampling {p}, Newton {_its(info.iterations)}; "
            f"batched against serialized {rel:.3e}; " + "; ".join(parts)
            + f"; lambda_0 {d_b[0].item():.4e} (HEP {runs['hep'][0][0].item():.4e})")


def models_double_loop(dtype, device, z, arrays, checks):
    """Item 4: the input subspace of confusion (z['dl_samples'] samples,
    rank z['dl_rank']), then test_errors_double_loop at z['dl_ranks'] with
    z['dl_outer'] outer x z['dl_inner'] inner samples."""
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    obs, prior = _models_confusion(dtype, device, z["nx"])
    params = ActiveSubspaceParameterList()
    params["samples_per_process"], params["rank"] = z["dl_samples"], z["dl_rank"]
    params["oversampling"], params["verbose"] = OVERSAMPLING, False
    proj = ActiveSubspaceProjector(obs, prior, parameters=params)
    proj.keychain = _given(SEED + 3, device)
    proj.construct_input_subspace()
    dl = proj.test_errors_double_loop(ranks=z["dl_ranks"], n_samples=z["dl_outer"],
                                      double_loop_samples=z["dl_inner"])
    errs = [dl[("double_loop", r)][0] for r in z["dl_ranks"]]
    arrays["dl_errors"] = torch.tensor([dl[("double_loop", r)] for r in z["dl_ranks"]],
                                       dtype=torch.float64)
    discarded = [dl[("double_loop_discarded", r)] for r in z["dl_ranks"]]
    checks += [(all(a >= b for a, b in zip(errs, errs[1:])),
                f"double loop: errors rise with rank {errs}"),
               (all(map(math.isfinite, errs)), "double loop: non-finite")]
    return ("errors " + ", ".join(f"r={r} {e:.4e}" for r, e in zip(z["dl_ranks"], errs))
            + f"; discarded (outer, inner) {discarded}")


def models_two_step(dtype, device, z, arrays, checks, out):
    """Item 5: DataGenerator.two_step_generate(z['ts_n'], pod_rank
    z['ts_pod_rank'], derivatives=(1, 1)) of the full-state Poisson
    observable in chunks of z['ts_chunk'], into ``out``."""
    import numpy as np

    from hippyflow_tpu_torch.models import DataGenerator
    from hippyflow_tpu_torch.testing import poisson_full_state_observable

    pde, prior, dist, Vh, _ = _models_poisson(dtype, device, z["nx"])
    fobs = poisson_full_state_observable(pde, Vh)
    kc = _given(SEED + 4, device)
    n, r = z["ts_n"], z["ts_pod_rank"]
    noise = kc.normal((n, prior.noise_dim), dtype=dtype)
    controls = dist.sample_n(kc, n, dtype)
    gen = DataGenerator(fobs, prior, control_distribution=dist,
                        settings=dict(chunk_size=z["ts_chunk"], verbose=False,
                                      seed=SEED))
    # the POD's verify lines go to a sink
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        gen.two_step_generate(n, derivatives=(1, 1), pod_rank=r, data_dir=out,
                              noise=noise, controls=controls)
    files = {}
    for name in ("POD/POD_decoder.npy", "POD/POD_encoder.npy", "POD/d_POD.npy",
                 "POD/POD_shift.npy"):
        files[name] = np.load(os.path.join(out, name))
    for name in ("mzq_data", "JstarPhi_data", "JzstarPhi_data"):
        with np.load(os.path.join(out, name + ".npz")) as data:
            files.update({f"{name}/{k}": data[k] for k in data.files})
    phi, Mphi = files["POD/POD_decoder.npy"], files["POD/POD_encoder.npy"]
    orth = float(np.linalg.norm(Mphi[:, : r - 1].T @ phi[:, : r - 1] - np.eye(r - 1)))
    dQ = Vh.dim
    checks += [(phi.shape == (dQ, r), f"two-step: POD decoder {phi.shape}"),
               (files["JstarPhi_data/JstarPhi_data"].shape == (n, dQ, r),
                "two-step: JstarPhi shape"),
               (files["JzstarPhi_data/JzstarPhi_data"].shape == (n, dist.dim, r),
                "two-step: JzstarPhi shape"),
               (all(np.isfinite(v).all() for v in files.values()), "two-step: non-finite"),
               (orth < 1e-5, f"two-step: ||Psi^* Psi - I|| {orth:.3e}")]
    arrays.update({f"ts_{k}": torch.as_tensor(v) for k, v in files.items()})
    st = ", ".join(f"{k} {v:.3f}" for k, v in gen.stage_seconds.items())
    return (f"{n} samples, POD rank {r}, chunks of {z['ts_chunk']}: "
            f"||Psi^* Psi - I|| {orth:.3e} (limit 1e-5); generate ({st}); Newton "
            f"{_its(gen.samples['iterations'])}")


def models_lane(dtype, device, z, out):
    """Items 1-5 of the models phase at the sizes ``z``: (arrays by name,
    {path: _Item}, {item: its text}), with every check failing the run."""
    arrays, checks, items, texts = {}, [], {}, {}

    def counted(name, fn, item_dtype, **kw):
        with _Item(device) as it:
            texts[name] = fn(item_dtype, device, z, arrays, checks, **kw)
        items[name] = it

    counted("models_wrapper", models_wrapper, dtype)
    counted("models_multi", models_multi, dtype)
    texts["models_full_state"] = models_full_state(dtype, device, z, arrays,
                                                   checks, items)
    # float64 always: float32 Newton stops at a relative residual of
    # 1.2e-5, which puts a floor of ~7e-4 under the error that ranks 32 and
    # 100 both reach at nx=64
    counted("models_double_loop", models_double_loop, torch.float64)
    # float64 always: in float32 the POD basis misses the check
    # ||Psi^* Psi - I|| < 1e-5 (2.2e-5 at nx=16 on the CPU)
    counted("models_two_step", models_two_step, torch.float64,
            out=os.path.join(out, "two_step"))
    for ok, what in checks:
        check(ok, f"models {str(dtype)[6:]} nx={z['nx']}: {what}")
    return arrays, items, texts


def _models_compare(a, b):
    """The largest relative difference over the arrays of two lanes; the
    POD basis and the sketches are aligned column by column first (eigh
    picks each column's sign)."""
    import numpy as np

    num = lambda x: x.detach().cpu().double().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, dtype=np.float64)
    sign = np.sign((num(a["ts_POD/POD_decoder.npy"])
                    * num(b["ts_POD/POD_decoder.npy"])).sum(axis=0))
    signed = ("ts_POD/POD_decoder.npy", "ts_POD/POD_encoder.npy",
              "ts_JstarPhi_data/JstarPhi_data", "ts_JstarPhi_data/Phi",
              "ts_JstarPhi_data/MPhi", "ts_JzstarPhi_data/JzstarPhi_data",
              "ts_JzstarPhi_data/Phi", "ts_JzstarPhi_data/MPhi")
    worst = {}
    for key in a:
        x, y = num(a[key]), num(b[key])
        if key in signed:
            x = x * sign
        worst[key] = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))
    return worst


def _models_newton(device):
    """Constrained Newton in float64 on 1/2 u^T K u + 1/4 w . u^4 - (M f) . u
    at nx=MODELS_NEWTON_NX (w the lumped mass, u = 0 on the boundary):
    (u, iterations, reason, seconds)."""
    import numpy as np

    from hippyflow_tpu_torch.fem import (
        DirichletBC,
        FunctionSpace,
        mass_matrix,
        stiffness_matrix,
        unit_square_mesh,
    )
    from hippyflow_tpu_torch.models import ConstrainedNSolver

    kw = dict(dtype=torch.float64, device=device)
    V = FunctionSpace(unit_square_mesh(MODELS_NEWTON_NX))
    K, M = stiffness_matrix(V, **kw), mass_matrix(V, **kw)
    x = V.dof_coords
    f = torch.as_tensor(40.0 * np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]), **kw)
    w, Mf = M.sum(dim=1), M @ f
    bc = DirichletBC.from_predicate(V, None, 0.0)
    solver = ConstrainedNSolver()
    t0 = time.perf_counter()
    u, reason = solver.solve(lambda u: 0.5 * u @ (K @ u) + 0.25 * w @ u**4 - Mf @ u,
                             lambda u: 0.0 * u.sum(), torch.zeros(V.dim, **kw),
                             torch.zeros(V.dim, **kw), bc=bc)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return u.cpu(), solver.it, reason, time.perf_counter() - t0


def models_extras(device, out):
    """Item 6: the boundary KLE (rank MODELS_KLE_RANK) on the nx=64 dense
    prior, the Laplacian prior's samples and mass KLE, the POD extras'
    files, constrained Newton on the card against the CPU."""
    import scipy.sparse as sp

    from hippyflow_tpu_torch.models import (
        BoundaryRestrictedKLEProjector,
        KLEParameterList,
        KLEProjector,
        LaplacianPrior,
        PODParameterList,
        PODProjector,
    )

    f32 = torch.float32
    obs, prior = _models_confusion(f32, device, NX)
    parts = []
    kp = KLEParameterList()
    kp["rank"], kp["verbose"], kp["oversampling"] = MODELS_KLE_RANK, False, OVERSAMPLING
    t0 = time.perf_counter()
    bk = BoundaryRestrictedKLEProjector(prior, parameters=kp)
    bk.keychain = _given(SEED + 5, device)
    d, V, E = bk.construct_input_subspace()
    ortho = (V.T @ (bk.B @ V) - torch.eye(V.shape[1], device=device)).abs().max().item()
    enc = rel_err(E, bk.M_b @ V)
    check(bool(torch.isfinite(d).all()) and bool((d[1:] <= d[:-1]).all()),
          "models boundary KLE: spectrum")
    check(ortho <= ORTHO_TOL_F32, f"models boundary KLE: max|V^T B V - I| {ortho:.3e}")
    check(enc <= 1e-6, f"models boundary KLE: encoder {enc:.3e}")
    parts.append(f"boundary KLE rank {MODELS_KLE_RANK} {time.perf_counter() - t0:.3f} s, "
                 f"lambda_0 {d[0].item():.4e}, max|V^T B V - I| {ortho:.2e}")

    t0 = time.perf_counter()
    lap = {dt: LaplacianPrior(obs.problem.Vu, 0.1, 1.0, dtype=dt, device=device)
           for dt in (f32, torch.float64)}
    xi = _given(SEED + 6, device).normal((64, lap[f32].noise_dim), dtype=torch.float64)
    samples = {dt: p.sample(xi.to(dt)) for dt, p in lap.items()}
    rel_s = rel_err(samples[f32].double(), samples[torch.float64])
    lk = KLEProjector(lap[f32], parameters=kp)
    lk.keychain = _given(SEED + 7, device)
    dl, Vl, El = lk.construct_input_subspace("mass")
    ortho_l = (Vl.T @ El - torch.eye(Vl.shape[1], device=device)).abs().max().item()
    check(rel_s <= MODELS_TOL_F32, f"models Laplacian prior: float32 samples {rel_s:.3e}")
    check(bool((dl[1:] <= dl[:-1]).all()) and ortho_l <= ORTHO_TOL_F32,
          f"models Laplacian KLE: max|V^T M V - I| {ortho_l:.3e}")
    parts.append(f"Laplacian prior 64 samples (float32 against float64 {rel_s:.2e}) and "
                 f"mass KLE rank {MODELS_KLE_RANK} {time.perf_counter() - t0:.3f} s, "
                 f"max|V^T M V - I| {ortho_l:.2e}")

    with _Item(device) as it:
        pp = PODParameterList()
        pp["verbose"], pp["output_directory"] = False, os.path.join(out, "pod")
        pod = PODProjector(obs, prior, parameters=pp)
        pod.keychain = _given(SEED + 8, device)
        (m0, u0), (m1, u1) = pod.two_state_solution()
        pod.save_mass_and_stiffness_matrices()
    names = sorted(os.listdir(os.path.join(out, "pod", "two_states")))
    check(len(names) == 8, f"models two_state_solution files {names}")
    Mc = sp.load_npz(os.path.join(out, "pod", "mass_csr.npz"))
    check(Mc.shape == (obs.dM, obs.dM) and abs(Mc.sum() - 1.0) < 1e-12,
          f"models mass_csr: shape {Mc.shape}, sum {Mc.sum()}")
    check(all(bool(torch.isfinite(x).all()) for x in (u0, u1, m1)),
          "models two_state_solution: non-finite")
    parts.append(f"two_state_solution + CSR matrices {it.line()}")

    (uc, itc, rc, sc), (uh, ith, rh, sh) = (_models_newton(device),
                                            _models_newton(torch.device("cpu")))
    diff = (uc - uh).abs().max().item() / max(uh.abs().max().item(), 1.0)
    check((itc, rc) == (ith, rh) and rc in (1, 3),  # the two converged reasons
          f"models Newton: card it {itc} reason {rc}, CPU it {ith} reason {rh}")
    check(diff <= MODELS_NEWTON_TOL, f"models Newton: card against CPU {diff:.3e}")
    parts.append(f"constrained Newton float64 nx={MODELS_NEWTON_NX}: {itc} iterations, "
                 f"reason {rc} on both, card {sc:.3f} s, CPU {sh:.3f} s, u against "
                 f"CPU {diff:.2e} (limit {MODELS_NEWTON_TOL:.0e})")
    return "; ".join(parts), it


def models_fd_check(device):
    """The wrapper's full gradient in float64 at nx=64 against a central
    difference of its cost (eps 1e-6) on MODELS_FD_SAMPLES samples."""
    from hippyflow_tpu_torch.models import ModelWrapper

    obs, prior = _models_confusion(torch.float64, device, NX)
    w = ModelWrapper(obs, prior)
    w.keychain = _given(SEED, device)
    w.setUpInverseProblem(rel_noise=0.01)
    m = w.samplePrior(MODELS_FD_SAMPLES)
    g = w.evalVariationalGradient(m, misfit_only=False)
    dm = w.keychain.normal(m.shape, dtype=torch.float64)
    eps = 1e-6
    fd = (w.evalCost(m + eps * dm) - w.evalCost(m - eps * dm)) / (2 * eps)
    an = (g * dm).sum(dim=1)
    return ((fd - an).abs() / an.abs()).max().item()


def models_check_f64(device):
    """Items 1-5 in float64 at nx=16 on the card and on the CPU from the
    same draws: the largest relative difference of each array."""
    lanes = []
    for dev in (device, torch.device("cpu")):
        with tempfile.TemporaryDirectory(prefix="models_f64_") as out:
            lanes.append(models_lane(torch.float64, dev, MODELS_CHECK, out)[0])
    return _models_compare(*lanes)


def phase_models(device):
    """The models phase: items 1-5 in float32 at the main path's width,
    each counted as its own path (the full-state item as three, one per
    strategy), then item 6, the float64 central difference, K1 and K2 at
    every shape the items gave them against their plain versions, and
    the float64 nx=16 card-against-CPU check.  Returns (launches by path,
    the records of K1 and K2)."""

    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="models_smoke_")
    with band_kernel_shapes() as shapes:
        arrays, items, texts = models_lane(f32, device, MODELS_FULL, tmp.name)
    z = MODELS_FULL
    labels = {
        "models_wrapper": f"wrapper float32 nx={NX} confusion, {z['n']} samples",
        "models_multi": f"multi-source float32 nx={NX} Poisson, {z['n']} samples",
        "models_full_state": f"full state float32 nx={NX} Poisson, {z['n']} samples",
        "models_double_loop": f"double loop float64 nx={NX} confusion, "
                              f"{z['dl_outer']} x {z['dl_inner']} samples",
        "models_two_step": f"two-step float64 nx={NX} Poisson full state",
    }
    for name, label in labels.items():
        head = "" if name == "models_full_state" else items[name].line() + "; "
        log(f"models {label}: {head}{texts[name]}")
    fd = models_fd_check(device)
    log(f"models wrapper float64 nx={NX} central difference of the full gradient, "
        f"{MODELS_FD_SAMPLES} samples: {fd:.3e} (limit {MODELS_FD_TOL:.0e})")
    check(fd <= MODELS_FD_TOL, f"models wrapper: central difference {fd:.3e}")
    text, it_extras = models_extras(device, tmp.name)
    log(f"models extras: {text}")
    paths = {name: it.launches for name, it in items.items()}
    paths["models_extras"] = it_extras.launches
    for name in ("models_wrapper", "models_multi", "models_fs_batched",
                 "models_fs_serialized", "models_double_loop", "models_two_step"):
        for key in ("banded_factorize", "banded_solve"):
            check(paths[name][key] > 0, f"{key} was not launched on {name}")
    ks = sorted(key[4] for key in shapes if key[0] == "K2")
    log(f"models K1/K2 shapes: {len([s for s in shapes if s[0] == 'K1'])} K1, "
        f"{len(ks)} K2 (k = {sorted(set(ks))})")

    # K1 and K2 at every shape of the items, on the two-step samples' bands
    m = torch.as_tensor(arrays["ts_mzq_data/m_data"].numpy(), dtype=f64, device=device)
    zz = torch.as_tensor(arrays["ts_mzq_data/z_data"].numpy(), dtype=f64, device=device)
    del arrays
    pde64 = _models_poisson(f64, device, NX)[0]
    u, _ = pde64.solve_fwd(m, z=zz)
    band = bc_symmetrize_banded_masked(pde64.bound.assemble_A_banded(u, m, zz),
                                       pde64._mask)
    del pde64, u
    torch.cuda.empty_cache()
    records = {}
    records["banded_factorize"], records["banded_solve"] = k12_shape_records(
        band, shapes, "models")
    del band
    tmp.cleanup()
    torch.cuda.empty_cache()

    errs = models_check_f64(device)
    worst_key = max(errs, key=errs.get)
    log(f"models float64 nx={MODELS_CHECK['nx']} card against CPU: {len(errs)} arrays, "
        f"worst {worst_key} {errs[worst_key]:.3e} (limit {MODELS_F64_TOL:.0e}); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    check(errs[worst_key] <= MODELS_F64_TOL,
          f"models float64: {worst_key} {errs[worst_key]:.3e}")
    return paths, records


# the drivers phase: the application drivers as a user runs them.
# Navier-Stokes at nx=64 (s=195) in float64, held against the JAX package's
# own field (.bench/ns_velocity_nx64.npy), relative to max|v|
NS_NX, NS_CACHE_TOL = 64, 1e-6
# the confusion setup driver where no field is cached: it solves
# Navier-Stokes at nx=32 (s=99)
NS_SETUP_NX = 32
# the float64 card-against-CPU checks: Navier-Stokes at nx=16, and the
# helmholtz setup lane at nx=10 (rank 16, 32 samples and data, 8
# error-test samples) from one given noise
NS_F64_NX, NS_F64_TOL = 16, 1e-10
HELM_CHECK_NX, HELM_F64_TOL = 10, 1e-8
# cuts of the helmholtz drivers (PERF.md section 4): the Laplacian-prior
# setup writes 64 training data (the driver's default is 512); training
# runs 20 AdamW epochs (200) and 3 Newton-CG epochs; the sweep 2 data
# sizes x 1 seed x 5 epochs (5 sizes x 3 seeds x 150)
LAPLACIAN_N_DATA = 64
DRIVER_EPOCHS, DRIVER_INCG_EPOCHS = 20, 3
SWEEP_SIZES, SWEEP_EPOCHS = "32,64", 5
# the setup driver's files (the JAX driver's layout); the spectra's plots
# come on top where matplotlib is installed
SETUP_FILES = ("AS_{n}_input_decoder.npy", "AS_{n}_d_GN.npy",
               "AS_{n}_output_decoder.npy", "AS_{n}_d_NG.npy", "KLE_decoder.npy",
               "KLE_d.npy", "POD_projector.npy", "POD_d.npy", "error_data.pkl",
               "metadata.pkl", "mq_data.npz", "jacobian_data")
SETUP_METADATA = {f"{k}_time" for k in ("as_input", "as_output", "kle", "pod",
                                        "error_test", "data", "jacobian_data")}
# a float64 projection error at or below this is rounding (the POD of 32
# samples reproduces them exactly from rank 32 on): "not rising with rank"
# compares errors above it
ROUNDING_F64 = 1e3 * torch.finfo(torch.float64).eps


def _have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def check_setup_dir(out, n_samples, label):
    """The setup driver's layout in ``out``: every file of the JAX
    driver, nothing else but the spectra's PDFs, and those only where
    matplotlib is installed.  Returns (metadata, error data, a note on the
    plots)."""
    import pickle

    files = set(os.listdir(out))
    want = {f.format(n=n_samples) for f in SETUP_FILES}
    pdfs = {f for f in files if f.endswith(".pdf")}
    check(want <= files and files - want <= pdfs,
          f"{label}: files {sorted(files)}")
    check("Jsvd_data.npz" in os.listdir(os.path.join(out, "jacobian_data")),
          f"{label}: no jacobian_data/Jsvd_data.npz")
    if _have_matplotlib():
        check(len(pdfs) == 4, f"{label}: plots {sorted(pdfs)}")
        note = f"{len(pdfs)} spectrum plots"
    else:
        check(not pdfs, f"{label}: plots {sorted(pdfs)} without matplotlib")
        note = "matplotlib is not installed: no PDF written"
    with open(os.path.join(out, "metadata.pkl"), "rb") as f:
        meta = pickle.load(f)
    with open(os.path.join(out, "error_data.pkl"), "rb") as f:
        err = pickle.load(f)
    check(set(meta) == SETUP_METADATA, f"{label}: metadata keys {sorted(meta)}")
    return meta, err, note


def ns_state(V, velocity, pressure):
    return torch.cat([velocity[:, 0], velocity[:, 1], pressure])[None]


def ordered_band(pde, u, m):
    """The bc-symmetrized band of ``pde`` (a P2 or vector state) at (u, m),
    in band order (N, nb, s, 3s)."""
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked

    band = pde.bound.assemble_A_banded_ordered(u, m, None, pde._band_order)
    return bc_symmetrize_banded_masked(band, pde._band_mask).contiguous()


def ns_band(V, u, device):
    """The bc-symmetrized Navier-Stokes Jacobian at Re=100 at the state
    u (1, 3n), float64, in band order (1, nb, s, 3s)."""
    from hippyflow_tpu_torch.applications.navier_stokes import _ns_bc, _ns_form
    from hippyflow_tpu_torch.models import VariationalPDEProblem

    pde = VariationalPDEProblem(V, V, _ns_form(V, 100.0), _ns_bc(V),
                                dtype=torch.float64, device=device)
    return ordered_band(pde, u, torch.zeros((1, V.dim), dtype=torch.float64,
                                            device=device))


def ns_k3_residual(band64, label):
    """K3 and the pivoted inverse on the Navier-Stokes Schur complements
    T_j = D_j - M_j B_{j-1} (from the float64 plain factorization), as K1's
    rows invert them: max|T T^-1 - I| of each, K3's within PIVOT_FACTOR of
    the pivoted one's.  Returns (K3's, torch.linalg.inv's, T)."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    N, nb, s, _ = band64.shape
    M64, _ = hk.banded_factorize_plain(band64)
    T = band64[..., s : 2 * s].clone()
    T[:, 1:] -= M64[:, 1:] @ band64[:, :-1, :, 2 * s :]
    T = T.reshape(N * nb, s, s)
    eye = torch.eye(s, dtype=torch.float64, device=band64.device)
    res_k3 = (T @ hk.batched_inverse(T) - eye).abs().amax().item()
    res_inv = (T @ torch.linalg.inv(T) - eye).abs().amax().item()
    log(f"K3 {label} float64 Schur complements ({N * nb}, {s}, {s}): "
        f"max|T T^-1 - I| K3 {res_k3:.3e}, torch.linalg.inv {res_inv:.3e} "
        f"({res_k3 / res_inv:.2f}x, limit {PIVOT_FACTOR:.0f}x)")
    check(res_k3 <= PIVOT_FACTOR * res_inv,
          f"K3 {label}: max|T T^-1 - I| {res_k3:.3e} against the pivoted "
          f"{res_inv:.3e}")
    return res_k3, res_inv, T


def ns_kernel_records(band64, shapes, label):
    """On one Navier-Stokes band: K1 and K2 at every shape the solve gave
    them against their plain versions (``k12_shape_records``), K1's row
    design (``k1_designs``) and its Schur step alone (``k1_schur``), K3's
    identity residual on the Schur complements and K3 timed on one block
    row's (``time_k3_clusters``), in float64 and float32.  Returns the
    records for the kernels' JSON line by kernel."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    N, nb, s, _ = band64.shape
    k1, k2 = k12_shape_records(band64, shapes, label, indefinite=True)
    k1[f"designs_{label}"] = k1_designs(band64, f"{label} bands", reps=3)
    schur = {f"{label}_n{N}_s{s}": k1_schur(band64, f"{label} bands", reps=5)}
    res_k3, res_inv, T = ns_k3_residual(band64, label)
    T1 = T.reshape(N, nb, s, s)[:, nb // 2].contiguous()
    tag = f"{label}_n{N}_s{s}_f64"
    k3 = {f"{key}_{tag}": v
          for key, v in time_k3_clusters(T1, f"{label} Schur complements").items()}
    ms, plain_ms = paired_ms(lambda: hk.batched_inverse(T1),
                             lambda: hk.batched_inverse_plain(T1))
    log(f"K3 {label} float64 one block row {tuple(T1.shape)}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    k3.update({f"plain_ms_{tag}": plain_ms, f"residual_{label}_s{s}_f64": res_k3,
               f"inv_residual_{label}_s{s}_f64": res_inv})
    return {"banded_factorize": k1, "banded_solve": k2, "batched_inverse": k3,
            "schur": schur}


def drivers_ns(device):
    """Path ns_nx64: steady Navier-Stokes at nx=64 in float64, counted,
    against the JAX package's cached field; then its kernel records."""
    import numpy as np

    from hippyflow_tpu_torch.applications.confusion import load_ns_velocity
    from hippyflow_tpu_torch.applications.navier_stokes import steady_navier_stokes
    from hippyflow_tpu_torch.fem import FunctionSpace, unit_square_mesh
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    V = FunctionSpace(unit_square_mesh(NS_NX))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with band_kernel_shapes() as shapes:
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        v, p, info = steady_navier_stokes(V, dtype=torch.float64, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ref = torch.as_tensor(load_ns_velocity(NS_NX), device=device)
    err = ((v - ref).abs().max() / ref.abs().max()).item()
    log(f"drivers ns_nx64 float64 nx={NS_NX} ({3 * V.dim} dofs, s={3 * (NS_NX + 1)}): "
        f"{secs:.3f} s; Newton iterations by Reynolds number "
        f"{[(re, it) for re, it, _ in info.history]}; max|v - JAX field| / max|v| "
        f"{err:.3e} (limit {NS_CACHE_TOL:.0e}); launches K1 "
        f"{launches['banded_factorize']} (rows {launches['banded_factorize_rows']}, "
        f"Schur steps {launches['schur_step']}) K2 {launches['banded_solve']} "
        f"(streamed {launches['banded_solve_streamed']}, panels "
        f"{launches['banded_solve_panels']}) K3 {launches['batched_inverse']}; "
        f"peak {peak:.3f} GB above the start")
    check(err <= NS_CACHE_TOL, f"ns_nx64: against the JAX field {err:.3e}")
    for key in ("banded_factorize_rows", "schur_step", "batched_inverse",
                "banded_solve"):
        check(launches[key] > 0, f"{key} was not launched on ns_nx64")
    band = ns_band(V, ns_state(V, v, p), device)
    del v, p, ref
    records = ns_kernel_records(band, shapes, "ns64")
    del band
    torch.cuda.empty_cache()
    return launches, records


def drivers_confusion_setup(device):
    """Path confusion_setup_nx32_ns: the confusion setup driver at nx=32
    with the Navier-Stokes velocity, float32, on the card (no field is
    cached at nx=32, so the driver solves it, at s=99); then the kernel
    records of that solve's band."""
    from hippyflow_tpu_torch.applications import confusion_setup
    from hippyflow_tpu_torch.applications.navier_stokes import steady_navier_stokes
    from hippyflow_tpu_torch.fem import FunctionSpace, unit_square_mesh
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    with tempfile.TemporaryDirectory(prefix="drivers_conf_") as out:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        confusion_setup.main(["--nx", str(NS_SETUP_NX), "--velocity", "ns",
                              "--error_test", "--output", out, "--device",
                              str(device)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        meta, err, note = check_setup_dir(out, 512, "confusion_setup_nx32_ns")
    check(set(err) == {"as", "kle", "pod", "input_output"},
          f"confusion_setup_nx32_ns: error data {sorted(err)}")
    for key in ("banded_factorize_chain", "banded_factorize_rows", "schur_step",
                "batched_inverse", "banded_solve"):
        check(launches[key] > 0,
              f"{key} was not launched on confusion_setup_nx32_ns")
    log(f"drivers confusion_setup_nx32_ns float32 nx={NS_SETUP_NX} --velocity ns: "
        f"{secs:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in meta.items())}); "
        f"launches K1 {launches['banded_factorize']} (chain "
        f"{launches['banded_factorize_chain']}, rows "
        f"{launches['banded_factorize_rows']}) Schur steps {launches['schur_step']} "
        f"K2 {launches['banded_solve']} K3 {launches['batched_inverse']}; peak "
        f"{peak:.3f} GB above the start; {note}")
    V = FunctionSpace(unit_square_mesh(NS_SETUP_NX))
    with band_kernel_shapes() as shapes:
        v, p, _ = steady_navier_stokes(V, dtype=torch.float64, device=device)
    band = ns_band(V, ns_state(V, v, p), device)
    records = ns_kernel_records(band, shapes, "ns32")
    del band
    torch.cuda.empty_cache()
    return launches, records


def drivers_helmholtz_setup(device, out, extra, label):
    """Path ``label``: the helmholtz setup driver at its defaults with
    --error_test (and ``extra`` flags), float64, on the card, into
    ``out``; the layout, orthonormality, error and launch checks."""
    from hippyflow_tpu_torch.applications import helmholtz_setup
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    res = helmholtz_setup.main(["--error_test", "--output", out, "--device",
                                str(device), *extra])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    meta, err, note = check_setup_dir(out, HELM_SAMPLES, label)
    check(set(err) == {"as", "kle", "pod"}, f"{label}: error data {sorted(err)}")
    AS, KLE, POD = res["as"], res["kle"], res["pod"]
    V, Vk = res["as_decoder"], res["kle_decoder"]
    eye = torch.eye(V.shape[1], dtype=V.dtype, device=V.device)
    ortho_as = (V.T @ AS.prior.R_matmat(V) - eye).abs().max().item()
    ortho_kle = (Vk.T @ AS.prior.M_matmat(Vk) - eye).abs().max().item()
    ranks = sorted(r for kind, r in err["as"] if kind == "input")
    as_in = [err["as"][("input", r)][0] for r in ranks]
    as_out = [err["as"][("output", r)][0] for r in ranks]
    kle_e, pod_e = list(err["kle"][0]), list(err["pod"][0])
    discarded = err["as"][("output_discarded", None)]
    log(f"drivers {label} float64 nx={HELM_NX} {HELM_FREQ:.0f} Hz "
        f"(s={AS.observable.problem._block_size}, nb="
        f"{AS.observable.problem._band_order.nb}) {' '.join(extra)}: {secs:.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in meta.items())}); launches K1 "
        f"{launches['banded_factorize']} (rows {launches['banded_factorize_rows']}) "
        f"Schur steps {launches['schur_step']} K2 {launches['banded_solve']} "
        f"(panels {launches['banded_solve_panels']}, streamed "
        f"{launches['banded_solve_streamed']}) K3 {launches['batched_inverse']}; "
        f"peak {peak:.3f} GB above the start; {note}")
    log(f"drivers {label} errors at ranks {ranks}: AS input "
        f"{[f'{x:.4e}' for x in as_in]}, AS output {[f'{x:.4e}' for x in as_out]}, "
        f"KLE {[f'{x:.4e}' for x in kle_e]}, POD {[f'{x:.4e}' for x in pod_e]}; "
        f"max|V^T R V - I| {ortho_as:.3e}, KLE max|V^T M V - I| {ortho_kle:.3e}; "
        f"resampled failures AS {AS.samples.n_failures} POD "
        f"{POD.samples.n_failures}; output_discarded {discarded}")
    for name in ("d_GN", "d_NG", "d_KLE", "d_POD"):
        d = res[name]
        check(bool(torch.isfinite(d).all()), f"{label}: non-finite {name}")
    check(ortho_as <= ORTHO_TOL_F32, f"{label}: AS max|V^T R V - I| {ortho_as:.3e}")
    check(ortho_kle <= ORTHO_TOL_F32,
          f"{label}: KLE max|V^T M V - I| {ortho_kle:.3e}")
    for name, e in (("POD", pod_e), ("AS output", as_out)):
        check(all(b <= max(a, ROUNDING_F64) for a, b in zip(e, e[1:])),
              f"{label}: {name} errors rise with rank {e}")
    for name, e in (("KLE", kle_e), ("AS input", as_in)):
        check(e[-1] < e[0], f"{label}: {name} error at rank {ranks[-1]} "
              f"{e[-1]:.4e} not below rank {ranks[0]}'s {e[0]:.4e}")
    check(discarded == 0 and AS.samples.n_failures == 0
          and POD.samples.n_failures == 0, f"{label}: a sample was discarded")
    for key in ("banded_factorize_rows", "schur_step", "batched_inverse",
                "banded_solve"):
        check(launches[key] > 0, f"{key} was not launched on {label}")
    return launches


def drivers_training(device, data_dir):
    """Path helmholtz_training: the helmholtz training driver's as_resnet
    on the setup driver's output, AdamW then Newton-CG."""
    from hippyflow_tpu_torch.applications import helmholtz_training
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    hk.reset_launch_counts()
    parts = []
    for optimizer, epochs in (("adamw", DRIVER_EPOCHS), ("incg", DRIVER_INCG_EPOCHS)):
        t0 = time.perf_counter()
        lg = helmholtz_training.main(["--data_dir", data_dir, "--epochs",
                                      str(epochs), "--optimizer", optimizer,
                                      "--device", str(device)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(_finite(*lg["loss"], *lg["train_acc"], *lg["val_acc"]),
              f"helmholtz_training {optimizer}: non-finite logger")
        check(lg["loss"][-1] < lg["loss"][0],
              f"helmholtz_training {optimizer}: loss {lg['loss'][0]:.4e} -> "
              f"{lg['loss'][-1]:.4e}")
        per = lg["epoch_time"][1:] or lg["epoch_time"]
        parts.append(f"{optimizer} {epochs} epochs {secs:.3f} s "
                     f"({sum(per) / len(per):.4f} s/epoch after the first), loss "
                     f"{lg['loss'][0]:.4e} -> {lg['loss'][-1]:.4e}, val acc "
                     f"{[round(x, 4) for x in lg['val_acc']]}")
    log("drivers helmholtz_training float32 as_resnet (sigmoid): " + "; ".join(parts))
    return launch_counts()


def drivers_multirun(device, data_dir):
    """Path helmholtz_multirun: the sweep at 2 data sizes x 1 seed x 5
    epochs, then the same call again, which must train nothing and leave
    the master logger's keys as they were."""
    import pickle

    from hippyflow_tpu_torch.applications import helmholtz_multirun
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    argv = ["--data_dir", data_dir, "--data_sizes", SWEEP_SIZES, "--n_seeds", "1",
            "--epochs", str(SWEEP_EPOCHS), "--device", str(device)]
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    master, trained = helmholtz_multirun.main(argv)
    t1 = time.perf_counter()
    again, trained2 = helmholtz_multirun.main(argv)
    t2 = time.perf_counter()
    n_arch = 3 * len(SWEEP_SIZES.split(","))
    check(len(trained) == n_arch and sorted(master) == sorted(trained),
          f"helmholtz_multirun: trained {trained}")
    with open(os.path.join(data_dir, "master_logger.pkl"), "rb") as f:
        kept = pickle.load(f)
    check(trained2 == [] and sorted(again) == sorted(kept) == sorted(master),
          f"helmholtz_multirun: the second call trained {trained2}")
    check(all(_finite(*r["val_acc"]) for r in master.values()),
          "helmholtz_multirun: non-finite accuracy")
    log(f"drivers helmholtz_multirun: {len(trained)} runs in {t1 - t0:.3f} s, "
        f"the second call {len(trained2)} runs in {t2 - t1:.3f} s; final val acc "
        + ", ".join(f"{k} {v['val_acc'][-1]:.4f}" for k, v in sorted(master.items())))
    return launch_counts()


def drivers_check_f64(device):
    """Float64 card against CPU: steady Navier-Stokes at nx=16, and the
    helmholtz setup lane at nx=10 from one given noise (as
    ``setup_check_f64`` draws it).  Returns (NS error, the lanes' errors)."""
    import numpy as np

    from hippyflow_tpu_torch.applications.confusion_setup import (
        lane_difference,
        setup_lane,
    )
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
        helmholtz_prior,
    )
    from hippyflow_tpu_torch.applications.navier_stokes import steady_navier_stokes
    from hippyflow_tpu_torch.fem import FunctionSpace, unit_square_mesh

    V = FunctionSpace(unit_square_mesh(NS_F64_NX))

    def ns(dev):
        v, p, _ = steady_navier_stokes(V, dtype=torch.float64, device=dev)
        return torch.cat([v, p[:, None]], dim=1).cpu()

    ns_err = rel_err(ns(device), ns(torch.device("cpu")))
    lanes = []
    for dev in (device, torch.device("cpu")):
        kw = dict(dtype=torch.float64, device=dev)
        obs, Vh = helmholtz_linear_observable(nx=HELM_CHECK_NX,
                                              frequency=HELM_FREQ, **kw)
        with tempfile.TemporaryDirectory(prefix="helm_f64_") as out:
            lanes.append(setup_lane(
                obs, helmholtz_prior(Vh, **kw), out, rank=16, n_samples=32,
                n_data=32, jacobian_rank=16, error_test_samples=8, seed=SEED,
                noise_rng=np.random.default_rng(SEED), input_output_test=False))
    return ns_err, lane_difference(*lanes)


def phase_drivers(device):
    """The drivers phase: each step one path (see the module doc).
    Returns (launches by path, the kernel records)."""
    t_phase = time.perf_counter()
    paths = {}
    paths["ns_nx64"], rec64 = drivers_ns(device)
    paths["confusion_setup_nx32_ns"], rec32 = drivers_confusion_setup(device)
    with tempfile.TemporaryDirectory(prefix="drivers_helm_") as tmp:
        out = os.path.join(tmp, "helmholtz_output")
        paths["helmholtz_setup"] = drivers_helmholtz_setup(device, out, [],
                                                           "helmholtz_setup")
        torch.cuda.empty_cache()
        paths["helmholtz_setup_laplacian"] = drivers_helmholtz_setup(
            device, os.path.join(tmp, "laplacian"),
            ["--laplacian_prior", "--n_data", str(LAPLACIAN_N_DATA)],
            "helmholtz_setup_laplacian")
        torch.cuda.empty_cache()
        paths["helmholtz_training"] = drivers_training(device, out)
        paths["helmholtz_multirun"] = drivers_multirun(device, out)
    ns_err, lane_errs = drivers_check_f64(device)
    worst = max(lane_errs.values())
    log(f"drivers float64 card against CPU: steady Navier-Stokes nx={NS_F64_NX} "
        f"{ns_err:.3e} (limit {NS_F64_TOL:.0e}); helmholtz setup nx={HELM_CHECK_NX} "
        f"max relative difference {worst:.3e} ("
        f"{', '.join(f'{k} {v:.1e}' for k, v in lane_errs.items())}) (limit "
        f"{HELM_F64_TOL:.0e}); phase {time.perf_counter() - t_phase:.1f} s")
    check(ns_err <= NS_F64_TOL, f"drivers Navier-Stokes float64: {ns_err:.3e}")
    check(worst <= HELM_F64_TOL, f"drivers helmholtz float64: {worst:.3e}")
    records = {}
    for rec in (rec64, rec32):
        for name, r in rec.items():
            records.setdefault(name, {}).update(r)
    # the drivers' projectors hold device arrays in reference cycles: free
    # them now, so that no later lane's peak memory counts them
    gc.collect()
    return paths, records


# the p2 phase: the JAX package's scalar P2 fixture (tests/test_band_order.py,
# tests/test_p2.py: flux exp(m) grad u, source u^3 - 1, quadrature degree
# 4, u = 0 on the boundary) at the main path's mesh (P2 state, 16641 dofs,
# s=258, nb=65; P1 parameter, 4225 dofs), the main path's dense prior and
# observations, and the nx=192 lane's settings
P2_NX, P2_S = NX, 2 * (2 * NX + 1)
P2_SAMPLES, P2_RANK, P2_CHUNK, P2_JAC_CHUNK = 256, 128, 32, 16
# float64: the Poisson problem with u = x^2 on the boundary reproduces x^2,
# and the L2 error of the sin sin problem falls at a rate above 2.7 (P2's
# is 3) over these meshes
P2_EXACT_TOL, P2_RATE_MIN, P2_RATE_NX = 1e-9, 2.7, (16, 32, 64)
# the float64 subspace at nx=16 on the card against the CPU from the same
# given noise (rank 16, 32 samples): every eigenvalue above 1e-4 lambda_0
P2_CHECK_NX, P2_CHECK_RANK, P2_CHECK_N, P2_F64_TOL = 16, 16, 32, 1e-8


def p2_observable(nx, dtype, device):
    """(observable, P1 space) of the scalar P2 fixture at nx, observed at
    the confusion problem's 100 targets."""
    from hippyflow_tpu_torch.fem import (
        DirichletBC,
        FunctionSpace,
        GalerkinForm,
        grid_targets,
        unit_square_mesh,
    )
    from hippyflow_tpu_torch.models import (
        LinearStateObservable,
        PointwiseObservation,
        VariationalPDEProblem,
    )

    mesh = unit_square_mesh(nx)
    V2, V1 = FunctionSpace(mesh, degree=2), FunctionSpace(mesh)
    form = GalerkinForm(
        flux=lambda x, u, gu, m, z, c: torch.exp(m)[..., None] * gu,
        source=lambda x, u, gu, m, z, c: u**3 - 1.0, quad_degree=4)
    pde = VariationalPDEProblem(V2, V1, form,
                                DirichletBC.from_predicate(V2, None, 0.0),
                                dtype=dtype, device=device)
    B = PointwiseObservation(V2, grid_targets(0.6, 0.8, 10), dtype=dtype,
                             device=device)
    return LinearStateObservable(pde, B), V1


def p2_subspace(device):
    """Path p2: the float32 input active subspace of the P2 problem at
    nx=64, counted and under ``utils.profiling.trace`` (the device busy
    share); its stage seconds (PhaseTimer phases and annotate ranges
    inside the projector), K1's rows, the Schur step, K3 and K2 both
    designs launched, the float32 Jacobian against float64 for 2 samples.
    Float32 Newton stalls at its rounding floor on a few samples (exp(m)
    reaches e^8): those are resampled, as in the JAX package, and counted
    in the run's line.  Returns (launches, the shapes K1 and K2 ran at,
    the float64 band of the first chunk)."""
    from hippyflow_tpu_torch.applications.confusion import confusion_prior
    from hippyflow_tpu_torch.models import ObservableJacobian
    from hippyflow_tpu_torch.utils import trace

    f32, f64 = torch.float32, torch.float64
    obs32, V1 = p2_observable(P2_NX, f32, device)
    pde = obs32.problem
    border = pde._band_order
    log(f"p2 nx={P2_NX}: P2 state {pde.state_dim} dofs, P1 parameter {V1.dim} "
        f"dofs, s={border.s}, nb={border.nb}, pad rows {border.n_pad}, "
        f"dQ={obs32.dQ}; solvers {pde.fwd_solver} / {pde.adj_solver}")
    check((border.s, border.nb, pde.fwd_solver, pde.adj_solver)
          == (P2_S, P2_NX + 1, "thomas_inv", "thomas_inv"),
          f"p2: s={border.s}, nb={border.nb}, {pde.fwd_solver}/{pde.adj_solver}")

    def run(label):
        return run_subspace(
            obs32, lambda: confusion_prior(V1, dtype=f32, device=device), label,
            P2_SAMPLES, P2_RANK, chunk_size=P2_CHUNK, jac_chunk_size=P2_JAC_CHUNK)

    label = f"p2 float32 nx={P2_NX}"
    # one run, counted and traced (the profiler's host cost is small beside
    # the run's; its Chrome trace goes to a temporary directory)
    with tempfile.TemporaryDirectory(prefix="p2_trace_") as log_dir:
        with band_kernel_shapes() as shapes, trace(log_dir) as prof:
            t0 = time.perf_counter()
            launches, proj = run(label)
            wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(log_dir, f))
                   for f in os.listdir(log_dir))
    busy = busy_line(prof, wall)
    t2 = time.perf_counter()
    log(f"trace {label}: {busy}; Chrome trace {size / 1e6:.1f} MB, written in "
        f"{t1 - t0 - wall:.1f} s, read in {t2 - t1:.1f} s")
    del prof
    check(set(proj.stage_seconds) == {"forward", "jacobian", "ghep"},
          f"p2 stages {sorted(proj.stage_seconds)}")
    for key in ("banded_factorize_rows", "schur_step", "batched_inverse",
                "banded_solve_streamed", "banded_solve_panels"):
        check(launches[key] > 0, f"{key} was not launched on p2")
    check(launches["banded_factorize_chain"] == 0,
          "p2: K1's chain ran at s=258 (above its limit)")
    obs64, _ = p2_observable(P2_NX, f64, device)
    m64 = proj.samples.ms[:2].double()
    u64, info = obs64.problem.solve_fwd(m64)
    check(bool(info.converged.all()), "p2 float64 solves did not converge")
    J64 = ObservableJacobian(obs64).materialize(
        obs64.problem.linearize(u64, m64, needs="adj"))
    rel = rel_err(proj.Js[:2].double(), J64)
    log(f"p2 Jacobian float32 against float64 (2 samples): max|dJ| / max|J| "
        f"{rel:.3e} (limit {JAC_TOL_F32})")
    check(rel <= JAC_TOL_F32, f"p2 J float32 vs float64 {rel:.3e}")
    n_band = max(key[1] for key in shapes)
    band64 = ordered_band(obs64.problem, proj.samples.us[:n_band].double(),
                          proj.samples.ms[:n_band].double())
    return launches, shapes, band64


def p2_f64(device):
    """Path p2_f64: the float64 checks that need no reference (x^2 exact
    at nx=64, the convergence rate), then the float64 subspace at nx=16 on
    the card against the CPU from one given noise.  Returns the launches."""
    import numpy as np

    from hippyflow_tpu_torch.fem import (
        DirichletBC,
        FunctionSpace,
        GalerkinForm,
        unit_square_mesh,
    )
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
        BiLaplacian2D,
        VariationalPDEProblem,
    )
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.utils import GivenNoise

    f64 = dict(dtype=torch.float64, device=device)
    hk.reset_launch_counts()

    def poisson(nx, bc_value, source):
        V2 = FunctionSpace(unit_square_mesh(nx), degree=2)
        V1 = FunctionSpace(V2.mesh)
        form = GalerkinForm(flux=lambda x, u, gu, m, z, c: gu, source=source,
                            quad_degree=5, symmetric=True)
        pde = VariationalPDEProblem(V2, V1, form,
                                    DirichletBC.from_predicate(V2, None, bc_value),
                                    is_fwd_linear=True, **f64)
        u, info = pde.solve_fwd(torch.zeros((1, V1.dim), **f64))
        check(bool(info.converged.all()), f"p2 Poisson nx={nx} did not converge")
        return V2, u[0]

    V2, u = poisson(P2_NX, lambda x: x[:, 0] ** 2, lambda x, u, gu, m, z, c: 2.0)
    exact = torch.as_tensor(V2.dof_coords[:, 0] ** 2, **f64)
    err = (u - exact).abs().max().item()
    sin_src = (lambda x, u, gu, m, z, c: -2.0 * math.pi**2
               * torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1]))
    errs = []
    for nx in P2_RATE_NX:
        V2, u = poisson(nx, 0.0, sin_src)
        x = V2.dof_coords
        e = u - torch.as_tensor(np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]),
                                **f64)
        # e^T M e cell by cell (the P2 mass matrix at nx=64 is 2.2 GB dense)
        phi, _, _, wdet = V2.quad_data(2 * V2.degree)
        eq = e[torch.as_tensor(V2.cell_dofs, device=device)] @ torch.as_tensor(
            phi, **f64).T
        errs.append(math.sqrt((eq**2 * torch.as_tensor(wdet, **f64)).sum().item()))
    rates = [math.log2(a / b) for a, b in zip(errs, errs[1:])]
    log(f"p2 float64 exactness nx={P2_NX}: max|u - x^2| {err:.3e} (limit "
        f"{P2_EXACT_TOL:.0e}); L2 errors at nx={P2_RATE_NX} "
        f"{[f'{v:.3e}' for v in errs]}, rates {[round(r, 3) for r in rates]} "
        f"(limit > {P2_RATE_MIN})")
    check(err <= P2_EXACT_TOL, f"p2 x^2 exactness {err:.3e}")
    check(min(rates) > P2_RATE_MIN, f"p2 convergence rates {rates}")
    spectra = []
    for dev in (device, torch.device("cpu")):
        obs, V1 = p2_observable(P2_CHECK_NX, torch.float64, dev)
        params = ActiveSubspaceParameterList()
        params["rank"], params["oversampling"] = P2_CHECK_RANK, OVERSAMPLING
        params["samples_per_process"], params["verbose"] = P2_CHECK_N, False
        proj = ActiveSubspaceProjector(
            obs, BiLaplacian2D(V1, gamma=0.1, delta=1.0, dtype=torch.float64,
                               device=dev), parameters=params)
        proj.keychain = GivenNoise(np.random.default_rng(SEED), dev)
        spectra.append(proj.construct_input_subspace()[0].cpu())
    d, d_cpu = spectra
    head = d_cpu.abs() > 1e-4 * d_cpu[0].abs()
    diff = ((d - d_cpu).abs() / d_cpu.abs())[head].max().item()
    launches = launch_counts()
    log(f"p2 float64 card against CPU nx={P2_CHECK_NX} ({P2_CHECK_N} samples, "
        f"rank {P2_CHECK_RANK}): max relative eigenvalue difference {diff:.3e} "
        f"over {int(head.sum())} (limit {P2_F64_TOL:.0e}); launches K1 "
        f"{launches['banded_factorize']} (chain {launches['banded_factorize_chain']}"
        f", rows {launches['banded_factorize_rows']}) K2 {launches['banded_solve']}"
        f" K3 {launches['batched_inverse']}")
    check(diff <= P2_F64_TOL, f"p2 float64 card vs CPU {diff:.3e}")
    return launches


def p2_kernel_records(band64, shapes, label):
    """On the P2 bands: K1 and K2 at every shape of the p2 run, with K2's
    streamed k=1 and panels k=100 transposed at N=16 and 32 both, against
    their plain versions (``k12_shape_records``), K1's rows
    (``k1_designs``) and its Schur step alone (``k1_schur``, beside the
    library pair), and K3 on one block row's Schur complements in both
    dtypes against its plain version (and ``torch.linalg.inv``'s identity
    residual), timed in turns with it, at each cluster size, beside
    ``torch.linalg.inv`` and the bound.  Returns the records for the
    kernels' JSON line by kernel."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    N, nb, s, _ = band64.shape
    # the chunks' shapes (Newton also runs the lanes still active, at every
    # smaller N), with K2 at k=1 and k=100 at both
    ns = (P2_JAC_CHUNK, P2_CHUNK)
    log(f"{label}: K1 ran at N={sorted({k[1] for k in shapes if k[0] == 'K1'})}, "
        f"K2 at (N, k, trans)={sorted({(k[1], k[4], k[5]) for k in shapes if k[0] == 'K2'})}")
    shapes = {k for k in shapes if k[1] in ns} | {
        ("K2", n, nb, s, k, k > 1) for n in ns for k in (1, RANK)}
    k1, k2 = k12_shape_records(band64, shapes, label)
    k1[f"designs_{label}"] = k1_designs(band64, f"{label} bands", reps=3)
    schur = {f"{label}_n{N}_s{s}": k1_schur(band64, f"{label} bands", reps=5)}
    j = nb // 2
    M64, _ = hk.banded_factorize_plain(band64[:, : j + 1].contiguous())
    T64 = (band64[:, j, :, s : 2 * s]
           - M64[:, j] @ band64[:, j - 1, :, 2 * s :]).contiguous()
    del M64
    k3, eye = {}, torch.eye(s, dtype=torch.float64, device=band64.device)
    for dtype in (torch.float32, torch.float64):
        T = T64.to(dtype)
        Y, Y_p = hk.batched_inverse(T), hk.batched_inverse_plain(T)
        torch.cuda.synchronize()
        diff = rel_err(Y, Y_p)
        res = (T64 @ Y.double() - eye).abs().max().item()
        res_inv = (T64 @ torch.linalg.inv(T).double() - eye).abs().max().item()
        check(diff <= TOL_INV[dtype]["diff"],
              f"K3 {label} {dtype}: kernel vs plain {diff:.3e}")
        check(res <= max(TOL_INV[dtype]["residual"], PIVOT_FACTOR * res_inv),
              f"K3 {label} {dtype}: max|T T^-1 - I| {res:.3e}")
        tag = f"{label}_n{N}_s{s}" + ("" if dtype == torch.float32 else "_f64")
        rec = time_k3_clusters(T, f"{label} Schur complements")
        ms, plain_ms = paired_ms(lambda: hk.batched_inverse(T),
                                 lambda: hk.batched_inverse_plain(T), 3)
        log(f"K3 {label} {str(dtype)[6:]} Schur complements {tuple(T.shape)}: rel "
            f"diff {diff:.3e}, max|T T^-1 - I| {res:.3e} (torch.linalg.inv "
            f"{res_inv:.3e}); K3 {ms:.4f} ms, plain {plain_ms:.4f} ms")
        k3.update({f"{key}_{tag}": v for key, v in rec.items()})
        k3.update({f"max_abs_err_{tag}": (Y - Y_p).abs().max().item(),
                   f"plain_ms_{tag}": plain_ms})
        del T, Y, Y_p
    return {"banded_factorize": k1, "banded_solve": k2, "batched_inverse": k3,
            "schur": schur}


def phase_p2(device):
    """The p2 phase: each step one path (see the module doc).  Returns
    (launches by path, the kernel records)."""
    t_phase = time.perf_counter()
    paths = {}
    paths["p2"], shapes, band64 = p2_subspace(device)
    torch.cuda.empty_cache()
    t_f64 = time.perf_counter()
    paths["p2_f64"] = p2_f64(device)
    t_rec = time.perf_counter()
    records = p2_kernel_records(band64, shapes, "p2")
    del band64
    torch.cuda.empty_cache()
    t_end = time.perf_counter()
    log(f"p2 phase {t_end - t_phase:.1f} s (p2 {t_f64 - t_phase:.1f}, p2_f64 "
        f"{t_rec - t_f64:.1f}, kernel records {t_end - t_rec:.1f})")
    return paths, records


# the parallel phase: the partitioned SPIKE solve at P=4 and 8 partitions
# on the main path's Newton bands (N=1024 in float32, 256 in float64), its
# solves at k=1 and k=100 held against K1+K2 (relative residual, taken in
# float64, of the system in the solve's dtype, and the solution
# difference, relative to the largest entry); the main path through solver="dist_banded" and a
# DeviceCollective on a one-rank NCCL group's (1, 1) mesh (one partition,
# samples and Jacobians in chunks of 256: at 1024 the forward chunk's
# factors peaked at 36.3 GB; each chunk cold-started, as the one chunk of
# auto's cold run is); the nx=192 structured prior at P=4
PAR_PARTS, PAR_N = (4, 8), {torch.float32: 1024, torch.float64: 256}
PAR_KS, PAR_CHUNK = (1, RANK), 256
PAR_TOL = {torch.float32: {"residual": 1e-4, "diff": 1e-3},
           torch.float64: {"residual": 1e-12, "diff": 1e-10}}
PAR_PRIOR_PARTS, PAR_PRIOR_N, PAR_PRIOR_K = 4, 256, 16
# the SPIKE priors' samples and R^{-1} X against the float64 unsharded
# prior's, relative to the largest entry: in float64 within 1e-10; in
# float32 within 10x of the float32 unsharded prior's own distance from
# float64 (R^{-1} = K^{-1} M K^{-1} squares K's conditioning: the float32
# bands' assembly roundoff alone moved it by 1.3e-3 on the card)
PAR_PRIOR_TOL, PAR_PRIOR_F32_FACTOR = 1e-10, 10.0


def _spike_factor(P):
    from hippyflow_tpu_torch.parallel import factorize_distributed_banded

    return lambda b: factorize_distributed_banded(b, P, with_transpose=False)


def parallel_spike(device):
    """Path parallel_spike: the SPIKE factors (both directions) at P=4 and
    8 and their solves, the counted run; then, uncounted, the same factors
    and solves again with their residuals, held against K1+K2 (the
    yardstick), times of both in turns, and K3 at every cyclic-reduction
    shape of the partitions against its plain version, ``torch.linalg.inv``
    and the bound.  Returns (launches, records)."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
        factorize_thomas_inv_banded,
    )
    from hippyflow_tpu_torch.parallel import factorize_distributed_banded

    # each dtype's bands and right-hand sides, and no more: the library LU
    # of the reduced systems allocates outside PyTorch's cache, so the
    # phase keeps its own footprint small and empties the cache before
    # each factorization
    obs64, prior64 = setup(torch.float64, device)
    bands64, gen = newton_bands(obs64, prior64, PAR_N[torch.float32], device)
    del obs64, prior64
    nb, s = bands64.shape[1], bands64.shape[2]
    rhs64 = {k: torch.randn(bands64.shape[0], nb * s, k, generator=gen,
                            dtype=torch.float64, device=device) for k in PAR_KS}
    bands = {dtype: bands64[:N].to(dtype, copy=True) for dtype, N in PAR_N.items()}
    rhs = {dtype: {k: b[:N].to(dtype, copy=True) for k, b in rhs64.items()}
           for dtype, N in PAR_N.items()}
    del bands64, rhs64
    torch.cuda.empty_cache()
    hk.reset_launch_counts()
    for dtype in PAR_N:
        for P in PAR_PARTS:
            torch.cuda.empty_cache()
            F = factorize_distributed_banded(bands[dtype], P)
            for k in PAR_KS:
                for trans in (False, True):
                    F.solve(rhs[dtype][k], trans=trans)
            del F
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches["batched_inverse"] > 0, "K3 was not launched on parallel_spike")
    torch.cuda.empty_cache()

    def residual(band, x, b, trans, chunk=128):
        """||A x - b|| / ||b|| in float64 (of the system in the band's
        dtype), a chunk of samples at a time."""
        mv = block_tridiag_matmat_trans if trans else block_tridiag_matmat
        num = sum(((mv(band[a:a + chunk].double(), x[a:a + chunk].double())
                    - b[a:a + chunk].double()) ** 2).sum().item()
                  for a in range(0, x.shape[0], chunk))
        return math.sqrt(num) / b.double().norm().item()

    spike = {}
    for dtype, N in PAR_N.items():
        band = bands[dtype]
        T = factorize_thomas_inv_banded(band)
        tol = PAR_TOL[dtype]
        sfx = "" if dtype == torch.float32 else "_f64"
        k1_ms = cuda_ms(lambda: factorize_thomas_inv_banded(band), 2)
        line = [f"K1 {k1_ms:.3f} ms"]
        spike[f"k1_ms_n{N}{sfx}"] = k1_ms
        for P in PAR_PARTS:
            torch.cuda.empty_cache()
            fac_ms = cuda_ms(lambda: factorize_distributed_banded(band, P), 1)
            torch.cuda.empty_cache()
            F = factorize_distributed_banded(band, P)
            spike[f"factor_ms_p{P}_n{N}{sfx}"] = fac_ms
            line.append(f"SPIKE P={P} factor {fac_ms:.3f} ms")
            for k in PAR_KS:
                for trans in (False, True):
                    B = rhs[dtype][k]
                    x = F.solve(B, trans=trans)
                    res = residual(band, x, B, trans)
                    diff = rel_err(x, T.solve(B, trans=trans))
                    del x
                    tag = f"p{P}_k{k}_{'trans' if trans else 'fwd'}_n{N}{sfx}"
                    check(res <= tol["residual"],
                          f"SPIKE {tag}: relative residual {res:.3e}")
                    check(diff <= tol["diff"],
                          f"SPIKE {tag}: against K1+K2 {diff:.3e}")
                    ms, k2_ms = paired_ms(lambda: F.solve(B, trans=trans),
                                          lambda: T.solve(B, trans=trans), 2)
                    spike.update({f"residual_{tag}": res, f"diff_{tag}": diff,
                                  f"solve_ms_{tag}": ms, f"k2_ms_{tag}": k2_ms})
                    line.append(f"P={P} k={k}{' trans' if trans else ''}: "
                                f"residual {res:.3e}, against K1+K2 {diff:.3e}, "
                                f"SPIKE {ms:.3f} ms, K2 {k2_ms:.3f} ms")
                    del B
            del F
            torch.cuda.empty_cache()
        log(f"parallel_spike {str(dtype)[6:]} N={N} nb=s={s}: "
            + "; ".join(line))
        del T, band
    del rhs
    torch.cuda.empty_cache()
    k3 = {}
    for P in PAR_PARTS:
        for dtype in PAR_N:
            k3.update(k3_cr_records(bands[dtype], f"spike_p{P}_l",
                                    factorize=_spike_factor(P), dtypes=(dtype,)))
            torch.cuda.empty_cache()
    del bands
    torch.cuda.empty_cache()
    return launches, {**k3, "spike": spike}


def parallel_parity(device, mesh, coll):
    """Path parallel_parity: the float64 parity pipeline through
    solver="dist_banded" on the mesh's 'fem' axis, the dof-sharded
    structured prior (mesh=) and the DeviceCollective."""
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        load_ns_velocity,
    )
    from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    kw = dict(dtype=torch.float64, device=device)
    hk.reset_launch_counts()
    obs, V = confusion_linear_observable(
        nx=NX, velocity=load_ns_velocity(NX), solver="dist_banded",
        dist_mesh=mesh, dist_axis="fem", **kw)
    prior = StructuredBiLaplacianPrior(V, gamma=0.1, delta=1.0, mesh=mesh, **kw)
    phase_parity(obs, prior, "dist_banded, dof-sharded structured prior, "
                 "DeviceCollective", collective=coll)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches["batched_inverse"] > 0, "K3 was not launched on parallel_parity")
    return launches


def parallel_nx64(device, mesh, coll, cold):
    """Path parallel_nx64: the float32 main path (cold start) through
    solver="dist_banded" and the DeviceCollective (chunks of 256), beside
    ``auto``'s cold run from the main phase."""
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
        load_ns_velocity,
    )

    kw = dict(dtype=torch.float32, device=device)
    obs, V = confusion_linear_observable(
        nx=NX, velocity=load_ns_velocity(NX), solver="dist_banded",
        dist_mesh=mesh, dist_axis="fem", **kw)
    prior = confusion_prior(V, **kw)
    launches, proj = run_subspace(
        obs, lambda: prior, f"parallel float32 nx={NX} cold start dist_banded",
        N_SAMPLES, RANK, collective=coll, chunk_size=PAR_CHUNK,
        reset_initial_guess=True)
    got = proj.smoke_summary
    check(launches["batched_inverse"] > 0, "K3 was not launched on parallel_nx64")
    # the chunks draw their noise apart, and the card's generator gives 4
    # draws of 256 other numbers than one of 1024: the spectra differ by
    # the Monte Carlo spread, not by the solver (parity checks that)
    head = cold["d"][0].abs().item()
    d_diff = ((got["d"] - cold["d"]).abs().max() / head).item()
    stages = lambda st: ", ".join(f"{k} {v:.3f}" for k, v in st.items())
    log(f"parallel_nx64 against auto (main phase, cold): total {got['total']:.3f} "
        f"/ {cold['total']:.3f} s; stages {stages(got['stages'])} / "
        f"{stages(cold['stages'])}; Newton max {got['newton_max']} / "
        f"{cold['newton_max']}, mean {got['newton_mean']:.3f} / "
        f"{cold['newton_mean']:.3f}; resampled failures {got['failures']} / "
        f"{cold['failures']}; peak {got['peak_gb']:.2f} / {cold['peak_gb']:.2f} "
        f"GB; max|d - d_auto| / d_0 {d_diff:.3e}; launches K1 "
        f"{launches['banded_factorize']} K2 {launches['banded_solve']} K3 "
        f"{launches['batched_inverse']}")
    del proj, obs, prior
    torch.cuda.empty_cache()
    return launches


def parallel_prior192(device, mesh):
    """Path parallel_prior192: the nx=192 structured prior with its K and M
    solves through unplaced SPIKE factors at P=4, and built dof-sharded on
    the mesh (``dist_assemble_band``, one partition), 256 samples and
    ``Rsolver_matmat`` against the float64 unsharded prior, in both
    dtypes."""
    from hippyflow_tpu_torch.fem import FunctionSpace, unit_square_mesh
    from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.parallel import factorize_distributed_banded

    V = FunctionSpace(unit_square_mesh(NX192))
    gen = torch.Generator(device=device).manual_seed(SEED)
    xi = torch.randn(PAR_PRIOR_N, V.dim, generator=gen, dtype=torch.float64,
                     device=device)
    X = torch.randn(V.dim, PAR_PRIOR_K, generator=gen, dtype=torch.float64,
                    device=device)
    hk.reset_launch_counts()
    out = {}
    for dtype in (torch.float32, torch.float64):
        kw = dict(dtype=dtype, device=device)
        t0 = time.perf_counter()
        spike = StructuredBiLaplacianPrior(V, 0.1, 1.0, **kw)
        # the same prior with its K and M solves through P=4 SPIKE factors
        spike._K_fac = factorize_distributed_banded(
            spike.K_band, PAR_PRIOR_PARTS, with_transpose=False)
        spike._M_fac = factorize_distributed_banded(
            spike.M_band, PAR_PRIOR_PARTS, with_transpose=False)
        sharded = StructuredBiLaplacianPrior(V, 0.1, 1.0, mesh=mesh, **kw)
        out[dtype] = {name: (p.sample(xi.to(dtype)), p.Rsolver_matmat(X.to(dtype)))
                      for name, p in (("spike", spike), ("sharded", sharded))}
        torch.cuda.synchronize()
        out[dtype]["seconds"] = time.perf_counter() - t0
        del spike, sharded
    launches = launch_counts()
    check(launches["batched_inverse"] > 0,
          "K3 was not launched on parallel_prior192")
    ref = StructuredBiLaplacianPrior(V, 0.1, 1.0, dtype=torch.float64,
                                     device=device)
    want = (ref.sample(xi), ref.Rsolver_matmat(X))
    del ref
    ref32 = StructuredBiLaplacianPrior(V, 0.1, 1.0, dtype=torch.float32,
                                       device=device)
    own = max(rel_err(got, w) for got, w in zip(
        (ref32.sample(xi.float()), ref32.Rsolver_matmat(X.float())), want))
    del ref32
    for dtype in (torch.float32, torch.float64):
        limit = (PAR_PRIOR_TOL if dtype == torch.float64
                 else PAR_PRIOR_F32_FACTOR * own)
        errs = {f"{name} {op}": rel_err(got, w)
                for name in ("spike", "sharded")
                for op, got, w in zip(("samples", "Rsolver"), out[dtype][name],
                                      want)}
        log(f"parallel_prior192 {str(dtype)[6:]} nx={NX192} ({V.dim} dofs, "
            f"P={PAR_PRIOR_PARTS} unplaced; one rank sharded): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" against the float64 unsharded prior (limit {limit:.3e}"
            + ("" if dtype == torch.float64 else
               f": 10x the float32 unsharded prior's {own:.3e}")
            + f"); {out[dtype]['seconds']:.2f} s")
        for k, v in errs.items():
            check(v <= limit, f"parallel_prior192 {dtype} {k}: {v:.3e}")
    log(f"parallel_prior192 launches K3 {launches['batched_inverse']}")
    # K3 at the P=4 partitions' cyclic-reduction shapes of the prior's K
    band = StructuredBiLaplacianPrior(V, 0.1, 1.0, dtype=torch.float64,
                                      device=device).K_band[None]
    records = k3_cr_records(band, f"prior192_p{PAR_PRIOR_PARTS}_l",
                            factorize=_spike_factor(PAR_PRIOR_PARTS))
    return launches, records


def phase_parallel(device, main_cold):
    """The parallel phase: a one-rank NCCL group (a FileStore in a
    temporary directory), its (1, 1) ('sample', 'fem') mesh and a
    DeviceCollective over 'sample'; each step one path (see the module
    doc); the group is destroyed at the end.  Returns (launches by path,
    the kernel records)."""
    import shutil

    import torch.distributed as dist

    from hippyflow_tpu_torch.parallel import (
        DeviceCollective,
        initialize_distributed,
        make_sample_fem_mesh,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    log(f"parallel phase: {free / 1e9:.2f} of {total / 1e9:.2f} GB free on entry, "
        f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated by tensors")
    tmp = tempfile.mkdtemp(prefix="hippyflow_nccl_")
    initialize_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_sample_fem_mesh(1, 1)
        coll = DeviceCollective(mesh, axis="sample")
        paths, times = {}, {}
        paths["parallel_spike"], records = parallel_spike(device)
        times["spike"] = time.perf_counter() - t_phase
        t = time.perf_counter()
        paths["parallel_parity"] = parallel_parity(device, mesh, coll)
        times["parity"] = time.perf_counter() - t
        t = time.perf_counter()
        paths["parallel_nx64"] = parallel_nx64(device, mesh, coll, main_cold)
        times["nx64"] = time.perf_counter() - t
        t = time.perf_counter()
        paths["parallel_prior192"], prior_k3 = parallel_prior192(device, mesh)
        times["prior192"] = time.perf_counter() - t
        records.update(prior_k3)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"parallel phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + ")")
    return paths, {"batched_inverse": records}


def phase_lane192(device, profile=False):
    """The float32 nx=192 lane, grid-sequenced (the counted path) and
    cold-started: confusion_prior builds the structured prior (cyclic
    reduction through K3) inside each counted run."""
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_prior,
        load_ns_velocity,
    )
    from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    obs32, _ = setup(torch.float32, device, nx=NX192, with_prior=False)
    Vh = obs32.problem.Vu
    levels = warm_start_levels(obs32, load_ns_velocity(NX192), NX192,
                               GRIDSEQ_DEPTH[NX192], torch.float32, device)
    check([p._block_size for p, _ in levels] == [NX192 // 2 + 1, NX192 // 4 + 1,
                                                 NX192 // 8 + 1],
          f"nx={NX192} levels {[p._block_size for p, _ in levels]}")

    def prior_fn():
        prior = confusion_prior(Vh, dtype=torch.float32, device=device)
        check(isinstance(prior, StructuredBiLaplacianPrior),
              f"nx={NX192}: confusion_prior gave {type(prior).__name__}")
        return prior

    def run(lv, label):
        return run_subspace(obs32, prior_fn, label, N192_SAMPLES, RANK192,
                            warm_levels=lv, chunk_size=CHUNK192,
                            jac_chunk_size=JAC_CHUNK192)

    paths = {}
    for name, lv in (("nx192", levels), ("nx192_cold", None)):
        cold = " cold start" if lv is None else f" grid-sequenced depth {len(lv)}"
        launches, _ = run(lv, f"lane float32 nx={NX192}{cold}")
        for key in ("banded_factorize", "banded_solve", "batched_inverse",
                    "schur_step"):
            check(launches[key] > 0, f"{key} was not launched on {name}")
        paths[name] = launches
    phase_surface(obs32, prior_fn(), levels, N192_SAMPLES, RANK192,
                  chunk_size=CHUNK192, jac_chunk_size=JAC_CHUNK192)
    torch.cuda.empty_cache()
    # the prior build alone with gj_cluster's choice and with one block per
    # matrix forced, in turns (picked, 1, 1, picked, three times): a host-
    # bound stage, so the mean and the least of each
    picked = hk.gj_cluster

    def build_s(one):
        hk.gj_cluster = (lambda n, s, sm: 1) if one else picked
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prior_fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            hk.gj_cluster = picked

    t = {False: [], True: []}
    for one in (False, True, True, False) * 3:
        t[one].append(build_s(one))
    log(f"nx={NX192} prior build float32, 6 each in turns: picked c mean "
        f"{sum(t[False]) / 6:.4f} s, least {min(t[False]):.4f} s; c=1 mean "
        f"{sum(t[True]) / 6:.4f} s, least {min(t[True]):.4f} s")
    if profile:
        label = f"lane float32 nx={NX192} grid-sequenced depth {len(levels)}"
        profile_run(label, lambda: run(levels, f"{label} (profiled)"))
    return paths


def phase_helmholtz(device, profile=False):
    """The float32 helmholtz lane, once, through the fused pass; then for 2
    of its samples the float32 Jacobian against the same samples run
    through the kernels in float64.  Returns the launches and (the float32
    and float64 observables, the lane's samples) for ``phase_surface_jt``."""
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
        helmholtz_prior,
    )
    from hippyflow_tpu_torch.models import ObservableJacobian

    obs32, Vh = helmholtz_linear_observable(
        nx=HELM_NX, frequency=HELM_FREQ, dtype=torch.float32, device=device)
    pde = obs32.problem
    log(f"helmholtz nx={HELM_NX} ({Vh.mesh.structured_shape}) {HELM_FREQ:.0f} Hz: "
        f"state {pde.state_dim} dofs, s={pde._block_size}, "
        f"nb={pde._band_order.nb}, pad rows {pde._band_order.n_pad}, "
        f"dM={obs32.dM}, dQ={obs32.dQ}")
    def run(label):
        return run_subspace(
            obs32, lambda: helmholtz_prior(Vh, dtype=torch.float32, device=device),
            label, HELM_SAMPLES, HELM_RANK, chunk_size=HELM_CHUNK,
            jac_chunk_size=HELM_CHUNK,
        )

    label = f"helmholtz float32 nx={HELM_NX}"
    launches, proj = run(label)
    check(set(proj.stage_seconds) == {"fused", "ghep"},
          f"helmholtz stages {sorted(proj.stage_seconds)}: not the fused pass")
    check(proj.samples.n_failures == 0,
          f"helmholtz: {proj.samples.n_failures} resampled failures")
    for key in ("banded_factorize", "banded_solve", "batched_inverse",
                "schur_step"):
        check(launches[key] > 0, f"{key} was not launched on the helmholtz lane")
    obs64, _ = helmholtz_linear_observable(
        nx=HELM_NX, frequency=HELM_FREQ, dtype=torch.float64, device=device)
    m64 = proj.samples.ms[:2].double()
    u64, info = obs64.problem.solve_fwd(m64)
    check(bool(info.converged.all()), "helmholtz float64 solves did not converge")
    J64 = ObservableJacobian(obs64).materialize(
        obs64.problem.linearize(u64, m64, needs="adj"))
    rel = rel_err(proj.Js[:2].double(), J64)
    log(f"helmholtz Jacobian float32 against float64 (2 samples): max|dJ| / "
        f"max|J| {rel:.3e} (limit {JAC_TOL_F32})")
    check(rel <= JAC_TOL_F32, f"helmholtz J float32 vs float64 {rel:.3e}")
    if profile:
        profile_run(label, lambda: run(f"{label} (profiled)"))
    return {"helmholtz": launches}, (obs32, obs64, proj.samples.ms)


# the port's kernels by a part of their names in a profiler trace
KERNEL_NAMES = (("K1 chain", "banded_chain_kernel"),
                ("K1 Schur step", "schur_tile_kernel"),
                ("K2 panels", "banded_solve_kernel"),
                ("K2 streamed", "banded_stream_kernel"),
                ("K3/K4", "gj_inverse_kernel"))


def busy_line(prof, wall) -> str:
    """Device busy share of a profiled run and each port kernel's device
    time, share and launches, from the profiler's raw events (parsing them
    into ``prof.events()`` took 146 s for a 21 s run of the p2 lane)."""
    # device-side events (kernels, copies) carry their own durations; one
    # stream, so their sum is the busy time.  The GPU spans of the
    # ``annotate`` ranges are device-side too, and overlap the kernels
    events = [(e.name(), e.duration_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()
              if e.device_type().name == "CUDA" and not e.is_user_annotation()]
    device_us = sum(us for _, us in events)
    parts = []
    for key, pattern in KERNEL_NAMES:
        mine = [us for name, us in events if pattern in name]
        if mine:
            parts.append(f"{key} {sum(mine) / 1e6:.3f} s "
                         f"({100 * sum(mine) / device_us:.1f}%, {len(mine)} launches)")
    return (f"wall {wall:.3f} s, device busy {device_us / 1e6:.3f} s "
            f"({100 * device_us / 1e6 / wall:.1f}%); " + "; ".join(parts))


def profile_run(label, fn):
    """fn() once under torch.profiler (--profile): wall, device busy
    share, each port kernel's device time, share and launches, and the
    table of device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"profile {label}: {busy_line(prof, wall)}")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=25))


def phase_profile(obs32, prior32):
    """Device time by kernel over one more main-path run (--profile)."""
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = RANK, OVERSAMPLING
    params["samples_per_process"] = N_SAMPLES
    params["verbose"], params["seed"] = False, SEED + 1
    proj = ActiveSubspaceProjector(obs32, prior32, parameters=params)
    profile_run(f"main float32 nx={NX} cold start (seed {SEED + 1})",
                proj.construct_input_subspace)


def run_phases(device, argv, parent=None):
    """Phases 3-11; returns the kernels' JSON records."""
    from hippyflow_tpu_torch.applications.confusion import load_ns_velocity
    from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior

    f64, f32 = torch.float64, torch.float32
    obs64, prior64 = setup(f64, device)
    report, band64 = phase_kernels(obs64, prior64, device, parent)
    phase_rows_s65(band64)
    del band64
    sprior64 = StructuredBiLaplacianPrior(obs64.problem.Vu, gamma=0.1,
                                          delta=1.0, dtype=f64, device=device)
    obs192, sprior192 = setup(f64, device, nx=NX192)
    inv_report = phase_inverses({NX: sprior64, NX192: sprior192})
    s193_report = phase_s193(obs192, sprior192, device, parent)
    coarse = {}
    for nx, obs, prior, n in ((NX, obs64, prior64, N_SAMPLES),
                              (NX192, obs192, sprior192, CHUNK192)):
        levels = warm_start_levels(obs, load_ns_velocity(nx), nx,
                                   GRIDSEQ_DEPTH[nx], f64, device)
        coarse.update(phase_coarse(levels, prior, n, device, parent))
    del obs192, sprior192
    torch.cuda.empty_cache()
    s_helm, s516 = phase_s516(device, parent)
    torch.cuda.empty_cache()
    phase_parity(obs64, prior64)
    phase_parity(obs64, sprior64)
    del obs64, prior64, sprior64
    torch.cuda.empty_cache()

    obs32, prior32 = setup(f32, device)
    levels64 = warm_start_levels(obs32, load_ns_velocity(NX), NX,
                                 GRIDSEQ_DEPTH[NX], f32, device)
    check([p._block_size for p, _ in levels64] == [NX // 2 + 1, NX // 4 + 1],
          f"nx={NX} levels {[p._block_size for p, _ in levels64]}")
    paths, proj64, main_cold = phase_main(obs32, prior32, levels64)
    forward_utilization(obs32, prior32)
    save = argv[argv.index("--save-h1") + 1] if "--save-h1" in argv else None
    phase_training(proj64, device, "--profile" in argv, save)
    del proj64
    torch.cuda.empty_cache()
    phase_surface(obs32, prior32, levels64, N_SAMPLES, RANK)
    torch.cuda.empty_cache()
    paths["setup"] = phase_setup(obs32, prior32, device)
    torch.cuda.empty_cache()
    control_paths, control_records = phase_control(device)
    paths.update(control_paths)
    torch.cuda.empty_cache()
    models_paths, models_records = phase_models(device)
    paths.update(models_paths)
    torch.cuda.empty_cache()
    drivers_paths, drivers_records = phase_drivers(device)
    paths.update(drivers_paths)
    torch.cuda.empty_cache()
    p2_paths, p2_records = phase_p2(device)
    paths.update(p2_paths)
    torch.cuda.empty_cache()
    parallel_paths, parallel_records = phase_parallel(device, main_cold)
    paths.update(parallel_paths)
    torch.cuda.empty_cache()
    if "--profile" in argv:
        phase_profile(obs32, prior32)
    del obs32, prior32, levels64
    torch.cuda.empty_cache()
    paths.update(phase_lane192(device, "--profile" in argv))
    torch.cuda.empty_cache()
    helm_paths, helm = phase_helmholtz(device, "--profile" in argv)
    paths.update(helm_paths)
    paths.update(phase_surface_jt(device, *helm))
    paths.update(phase_surface_vector(device, *helm))

    designs = report["banded_factorize"]["designs"]
    designs.update(s193_report["designs"])
    designs.update({f"n{N_SAMPLES if s in (33, 17) else CHUNK192}_s{s}":
                    rec["designs"] for s, rec in coarse.items()})
    designs[f"n{N_BAND_HELM}_s{s_helm}"] = s516["designs"]
    schur = {**s193_report.pop("schur"), **s516["schur"]}
    k2_cl = report["banded_solve"]["clusters"]
    k2_cl.update(s193_report["banded_solve"].pop("clusters"))
    for rec in coarse.values():
        k2_cl.update(rec[f32]["k2_clusters"])
    for dtype in (f32, f64):
        k2_cl.update(s516[dtype]["k2_clusters"])
    k2_panels_rec = report["banded_solve"]["panels"]
    k2_panels_rec.update(s193_report["banded_solve"].pop("panels"))
    for dtype in (f32, f64):
        k2_panels_rec.update(s516[dtype]["k2_panels"])
    for name in ("banded_factorize", "banded_solve"):
        report[name].update(s193_report[name])
    for name, key in (("K3", "batched_inverse"), ("K4", "batched_inverse_rank1")):
        report[key] = {**inv_report[(name, NX192)],
                       **{f"{k}_s65": v for k, v in inv_report[(name, NX)].items()}}
    k3 = report["batched_inverse"]
    for tag, rec in ((f"cr_s{NX192 + 1}", inv_report[("clusters", NX192)]),
                     (f"cr_s{NX + 1}", inv_report[("clusters", NX)]),
                     *((f"cr{key[1]}_s{NX192 + 1}", r)
                       for key, r in inv_report.items()
                       if key[0] == "clusters_level"),
                     *((tag, r) for tag, r in s193_report.items()
                       if tag.startswith("rows_")),
                     (f"s{s_helm}", s516[f32]["k3_clusters"]),
                     (f"s{s_helm}_f64", s516[f64]["k3_clusters"])):
        k3.update({f"{k}_{tag}": v for k, v in rec.items()})
    schur.update(drivers_records.pop("schur"))
    schur.update(p2_records.pop("schur"))
    for name, rec in (*control_records.items(), *models_records.items(),
                      *drivers_records.items(), *p2_records.items(),
                      *parallel_records.items()):
        report[name].update(rec)
    for dtype, sfx in ((f32, f"s{s_helm}"), (f64, f"s{s_helm}_f64")):
        r = s516[dtype]
        report["banded_factorize"].update({
            f"max_abs_err_{sfx}": r["max_abs_err"], f"ms_{sfx}": r["k1"][0],
            f"plain_ms_{sfx}": r["k1"][1], **bound_keys(sfx, *r["k1_bound"]),
            f"rows_plain_ms_{sfx}": r["k1_rows_plain"]})
        report["banded_solve"].update({
            f"max_abs_err_{sfx}": max(r["k2_max_abs_err_k1"],
                                      r["k2_max_abs_err_k200"]),
            f"ms_k200_{sfx}": r["k2_k200"][0],
            f"plain_ms_k200_{sfx}": r["k2_k200"][1],
            f"ms_k1_{sfx}": r["k2_k1"][0], f"plain_ms_k1_{sfx}": r["k2_k1"][1],
            f"ms_k1_fwd_{sfx}": r["k2_k1_fwd"][0],
            f"plain_ms_k1_fwd_{sfx}": r["k2_k1_fwd"][1],
            **bound_keys(f"k200_{sfx}", *r["k2_bound"][200]),
            **bound_keys(f"k1_{sfx}", *r["k2_bound"][1])})
        # K3's time at s=516 is the cluster sweep's (ms_, inv_ms_ above);
        # this phase adds the plain version's, timed in turns with it
        report["batched_inverse"]["plain_ms_" + sfx] = r["k3"][1]
    for s, rec in sorted(coarse.items()):
        r = rec[f32]
        report["banded_factorize"].update({
            f"max_abs_err_s{s}": r["max_abs_err"], f"ms_s{s}": r["k1"][0],
            f"plain_ms_s{s}": r["k1"][1], **bound_keys(f"s{s}", *r["k1_bound"])})
        report["banded_solve"].update({
            f"max_abs_err_k1_s{s}": r["k2_max_abs_err_k1"],
            f"ms_k1_s{s}": r["k2_k1"][0], f"plain_ms_k1_s{s}": r["k2_k1"][1],
            **bound_keys(f"k1_s{s}", *r["k2_bound"][1])})
    pallas = "hippyflow_tpu/ops/pallas_kernels.py"
    sources = {
        "banded_factorize": ("banded_factorize.cu", f"{pallas}:468"),
        "banded_solve": ("banded_solve.cu", f"{pallas}:307"),
        "batched_inverse": ("batched_inverse.cu", f"{pallas}:659"),
        "batched_inverse_rank1": ("batched_inverse.cu", f"{pallas}:66"),
    }
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"hippyflow_tpu_torch/csrc/{src}", "replaces": rep,
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {path: p[name] for path, p in paths.items()},
         **report[name]}
        for name, (src, rep) in sources.items()
    ]
    # K1's two designs: their launches on each path; its Schur step's
    kernels[0]["launches_by_design"] = {
        d: {path: p[f"banded_factorize_{d}"] for path, p in paths.items()}
        for d in ("chain", "rows")}
    kernels[1]["launches_by_design"] = {
        d: {path: p[f"banded_solve_{d}"] for path, p in paths.items()}
        for d in ("panels", "streamed")}
    kernels[0]["schur"] = {
        "source": "hippyflow_tpu_torch/csrc/banded_factorize.cu",
        "replaces": f"{pallas}:445", "launches": sum(
            p["schur_step"] for p in paths.values()),
        "launches_by_path": {path: p["schur_step"] for path, p in paths.items()},
        **schur}
    return kernels


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # IEEE float32 products in the plain versions and the library yardsticks
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s)")
    log(smi)

    t0 = time.perf_counter()
    lib = hk.build_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, "
        f"{len(hk.SOURCES)} sources in parallel) -> {os.path.relpath(lib, REPO)}")

    parent = None
    if "--parent" in argv:
        parent = load_parent(argv[argv.index("--parent") + 1])
    kernels = run_phases(device, argv, parent)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
