"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tdc_tpu_torch/csrc/` and drives its
main paths through the CLI: in-memory single-GPU f32 Lloyd K-Means, with
and without sample weights, bf16 Lloyd K-Means, Fuzzy C-Means, diagonal
Gaussian Mixture EM, feature-major K-Means and Fuzzy C-Means
(--layout=features), the streamed fits (--num_batches) with the
OOM-adaptive retry, and two ranks on the one card: the K-sharded Fuzzy
C-Means tower (--shard_k), data-parallel K-Means and Gaussian Mixture EM
(--n_GPUs=2) and streamed K-Means (per batch, per pass and quantized);
four ranks as a hierarchical (2, 2) mesh; and
through the functions: the sorted stats with the row gather fused in
(sorted_cluster_stats(fuse_gather=True)) and the K-sharded K-Means tower
(kmeans_fit_sharded) on two ranks. Phases, each of which raises on
failure (nothing is caught):

1. Device: a CUDA card is required; prints its name and power limit.
2. Build: nvcc builds the kernels; prints the build seconds.
3. Kernel against plain: B1 at N=2^22, K=1024, d=128; B2 and B3 at the
   large-K shape of phase 5. Each kernel is held to its plain PyTorch
   version on the same inputs (tolerances below), run twice to check it
   is bitwise repeatable, and timed with CUDA events. B3 runs on the
   labels of the sorted route's first iteration (its timed case), on
   balanced labels, on one heavy label and on one K-shard's relative
   labels, and is held to torch.segment_reduce, the library call that
   computes the same sums, on each: timed whole, pass 1 and pass 2 apart,
   and beside the library call (B3 and B12 and their yardsticks as the
   mean of 20 back-to-back calls, `batched_ms`; one-call medians, the
   earlier method, are printed beside). The build's ptxas registers and spills
   of every kernel are printed first.
   B2 (its distance product on the tensor cores in 3xTF32, each row's
   champion scored again in f32) is held with its labels: equal to the
   plain version's but at near-ties on the blobs and on a near-tie input
   at K=16,384, d=768 (see below), its minima in both forms within
   REL_TOL of ‖x‖² + max ‖c‖², bitwise repeatable.
   Duplicated centroids check the tie rule of B1, B2 and B3 on the card,
   with copies in the same and in the next 256-centroid K tile.
   B1 and B4 (their distance product on the tensor cores in 3xTF32) are
   held with their labels: labels equal to the plain version's but at
   near-ties, counts equal and no near-tie at the route's shape, and the
   same checks on a near-tie input (2^16 points off the bisector of two
   centroids, by offsets whose true gaps straddle the near-tie limit, so
   that a product coarser than f32 flips labels beyond it and fails: the
   near-tie count, the largest flipped gap as a share of the limit and
   the rows past it are printed); each prints its fixed cost (one block
   per CTA) and the design before it (phase split, near-ties, share of
   the tolerance used) beside its own numbers.
   B6 (fuzzy stats) at N=2^22, K=1024, d=128 for m=2.0 and m=1.7, its two
   phases timed apart (the row normaliser writing the inv scratch, then μ
   and Σμx on the tensor cores) and the design before it (B7's kernel,
   then B8's one-slice kernel) beside it on the same inputs, and at a
   ragged N=2^16+37, K=300, d=19 with one point exactly on a centroid,
   which must take full membership there. B4 (weighted Lloyd stats) at
   N=2^22, K=1024, d=128 and at the ragged shape, with weights uniform in
   [0, 3) and about 5% exactly 0; B3 is also timed on the weighted sorted
   route's [w·x | w] rows (d+1 = 769 columns). The tie check runs with
   weights too: copies take no mass in B4 or the weighted sorted stats.
   B9 (the diag-GMM E-step) at N=2^22, K=1024, d=128 and at the ragged
   shape, with variances and weights from the blobs' hard-assignment
   moments, its two phases timed apart; at the ragged shape also with
   the variances 30× wider, so each row's responsibilities spread. B6's
   and B9's bound_ms is their tensor-core bound (their products on the
   tensor cores in 3xTF32), bound_f32_ms their bound on the f32 FMA pipe.
   B5 (the bf16 tensor-core Lloyd stats) at N=2^22, K=1024, d=128 and at
   the ragged shape, on f32 rows (kernel="pallas_bf16") and on bf16 rows,
   with its labels: labels equal to the plain version's except at
   near-ties in B5's own metric (c2 − 2·x̃·c̃ on the bf16-rounded
   operands), counts equal where the labels agree, sums within REL_TOL of
   Σ|x| against Σx by the kernel's own labels, SSE within REL_TOL
   relative, bitwise repeatable. Centroids that differ in f32 but round to
   the same bf16 values tie on bf16 rows: the smallest index wins.
   B10 and B11 (the feature-major Lloyd and fuzzy stats) at the reference
   sweep's largest point, N=10^8, d=5, K=15, on f32 and bf16 columns (B11
   at m=2 and m=1.7), at the ragged N=2^16+37, K=300, d=19 and at a wide
   N=2^18, K=1024, d=128; first, B10's streaming form at its edges
   (TALL_EDGES: a ring slot and one column, each CTA's ring wrapping,
   misaligned rows, K·(d+1) at its limit), each under a watchdog that
   ends the run if the kernel does not finish. B10 prints its split at
   the route's shape (the kernel's stream-only path: the columns through
   the ring and nothing else) and its time at N=10^8, K=16, d=8 beside
   its bound; the ptxas lines of its instantiations (in the [build]
   table) must show 0 spills. B10's labels equal to the plain version's except
   at near-ties in its own metric (d² of the operands as the kernel sees
   them), counts equal where the labels agree, Σx within REL_TOL of Σ|x|
   by its own labels; B11 as B6; both bitwise repeatable. B1 on
   xt.T.contiguous() at the 10^8 shape is timed beside B10 (a number, not
   a check). Duplicated centroids take 0 columns in B10 and the same
   mass, bitwise, as the original in B11. B11's bound_ms is its
   tensor-core bound (its μᵀx on the tensor cores in 3xTF32, the
   distances on the f32 pipe, or the bytes), bound_f32_ms all of it on
   the f32 pipe.
   B7 and B8 (the two-pass fuzzy kernels of the K-sharded tower) at
   N=2^19, K=16,384, d=768 for m=2.0 and m=1.7 and on bf16 rows, at the
   ragged shape and at N=2^16+37, K=37, d=768 (where the nearest
   centroids dominate s; B7's product runs on the tensor cores in 3xTF32,
   each row's champion scored again in f32): s within REL_TOL relative
   of the plain version's, B8
   (given that s) as B6, both bitwise repeatable; and the tower's
   identity on one process: s summed over two K-shards, B8 on each shard
   with it, equal to B6 on all K within B6's tolerances. B6 at that shape
   (m=2; phase 2 over six column slices, phase 1's K tiles split) is held
   to its plain version and timed beside B7 then B8. B8's design line
   gives its product count and μ scratch; its two halves (the μ kernels,
   then μᵀ·X) are timed apart, and it is also timed at K/2 = 8,192 (one
   rank's shard of the K-sharded route) beside its plain version.
   B12 (B3 with the row gather fused in) at N=2^19, K=16,384, d=768 on
   B3's three label sets, on one K-shard's relative labels of phase 12's
   K-sharded K-Means route (8,192 segments, the other shard's rows on the
   sentinel) and on bf16 rows: bitwise equal to B3 on x.index_select(0,
   order) (widened to f32), bitwise repeatable, within REL_TOL of Σ|x|
   of its plain version; timed beside its plain version, the route it
   replaces (index_select, then B3) and index_add_, the library call for
   the same function, held to the kernel like the plain version.
4. Main path, fused route: the CLI at N=2^22, d=128, K=1024,
   --kernel=pallas, 10 iterations; B1 must launch n_iter + 1 times per fit.
5. Main path, sorted route: the CLI at K=16,384, d=768, --init=random,
   past B1's limit, so B2 and B3 carry it (cuts listed at SORTED_ARGS).
   Then the fused-gather step at its shape and init: 4 Lloyd iterations
   of B2 and sorted_cluster_stats(pallas=True, fuse_gather=True) (B12),
   and of B2 and the same without the fusion (B3); each launches B2 and
   its kernel 4 times, nothing else, and the centroids are bitwise equal
   after every iteration.
6. Main path, fuzzy route: the CLI with --method_name=distributedFuzzyCMeans
   at N=2^22, d=128, K=1024, --kernel=pallas, 10 iterations; B6 must
   launch n_iter + 1 times per fit and B1, B2, B3 never.
7. Main path, weighted fused route: phase 4's CLI with --weight_file (an
   (N,) .npy made from a seeded generator); B4 must launch n_iter + 1
   times per fit and B1, B2, B3, B6 never.
8. Main path, weighted sorted route: phase 5's CLI with --weight_file;
   B2 and B3 must launch n_iter + 1 times per fit and B1, B4 never.
9. Main path, GMM route: the CLI with --method_name=gaussianMixture
   --covariance_type=diag at N=2^22, d=128, K=1024, --kernel=pallas, 10
   iterations; B9 must launch n_iter + 1 times per fit and no other
   kernel ever.
10. Main path, bf16 routes: the CLI with --dtype bfloat16 --kernel=pallas
   on a bf16 .npy data file (written as a uint16 view saved as '|V2', as
   ml_dtypes arrays are stored) and with --kernel=pallas_bf16 on f32
   points, both at N=2^22, d=128, K=1024, 10 iterations; B5 must launch
   n_iter + 1 times per fit and no other kernel ever. Then
   lloyd_stats_auto on bf16 rows at K=16,384, d=768: B2 and B3 launch,
   B5 does not, and the stats equal those of the same route on the
   widened rows and rounded centroids bitwise.
11. Main path, tall routes: the CLI with --layout=features at N=10^8,
   d=5, K=15, 20 iterations, for distributedKMeans (f32 and
   --dtype=bfloat16) and distributedFuzzyCMeans (m=2), and on a .fm.npy
   file of N=2^24 written by to_feature_major; B10 (B11 for fuzzy) must
   launch n_iter + 1 times per fit and no other kernel ever.
12. Main path, multi-GPU routes, two ranks on the one card (spawned, each
   joining from the environment as under torchrun; gloo on the card's
   tensors, since NCCL takes one rank per GPU): the K-sharded fuzzy
   route, --method_name=distributedFuzzyCMeans --kernel=pallas
   --shard_k=2 --n_GPUs=2 at N=2^19, d=768, K=16,384, 4 iterations, B7
   and B8 launching 2·(n_iter + 1) times on each rank and nothing else,
   its objective within REL_TOL of the same fit in this process on a 1x1
   grid from the same init; the K-sharded K-Means route,
   kmeans_fit_sharded(kernel="pallas") on a (1, 2) grid at the same
   shape and 4 iterations (tol < 0) from --init=random on the first 2^16
   rows, B2 and B3 launching n_iter + 1 times on each rank and nothing
   else, n_iter and its SSE (within REL_TOL) as the same fit in this
   process on a 1x1 grid, its centroids within 1e-4 of kmeans_fit on one
   GPU (the sorted route) from that init; and the data-parallel fused
   route, phase 4's CLI with --n_GPUs=2, B1 launching 2·(n_iter + 1)
   times on each rank, its SSE within REL_TOL of phase 4's. Rank 0 alone
   writes the CLI routes' rows.
13. NCCL at world size 1: kmeans_fit(mesh=make_mesh(1), kernel="pallas")
   at the fused shape and fuzzy_fit_sharded on a 1x1 grid at the
   K-sharded shape (3 iterations) against the same fits without a mesh.
14. Predict: kmeans_predict(kernel="pallas") on 2^20 points (B2) against
   the plain labels.
15. Whole-fit parity: at N=2^16 a kernel="pallas" fit and a plain
   kernel="xla" fit from the same init give the same n_iter and
   centroids (means) within tolerance, for K-Means, weighted K-Means,
   Fuzzy C-Means and diag and spherical GMM; a bf16 K-Means fit on B5
   against the same fit on the CPU (B5's plain version); and
   layout="features" K-Means (B10) and Fuzzy C-Means (B11) fits at N=2^16,
   d=5, K=15 against the same fits on the CPU.

16. Main path, streamed routes (--num_batches), through the CLI, each
   against the in-memory fit on the same points from the same init
   (--init=first_k): [stream_route] at BASELINE.json config 3's shape
   (N=10^7, d=128, K=1024, f32, 8 batches, --kernel=pallas, 10
   iterations): n_iter and converged equal, every iteration's SSE within
   1e-6 of the other's (10 steps carry near-tie label flips into the
   centroids: the rows they flip are printed), centroids within 1e-4
   after one step and after a fit from seeds near the blobs' means, B1
   launching batches x passes per fit (the passes read from the fit's
   `comms`) and nothing else; computation seconds, pt·iter/s, and a pass
   split into its copies alone and B1 alone. [stream_fuzzy] (m=2, B6) and
   [stream_gmm] (diag, B9; held to the in-memory EM loop from the
   streamed fit's first-batch start) on the same points, 4 iterations.
   [stream_ref]: the reference notebook's job (N cut from 5*10^8 to 10^8,
   d=2, K=3, 8 batches), exact and --mean_combine. [stream_dp]: two ranks
   (gloo on the card's tensors), 4 batches, one Lloyd step,
   --reduce=per_batch and per_pass, against one rank's streamed fit
   (n_iter, SSE, centroids within 1e-4). [oom]: a spawned process
   caps its own allocator below the points' bytes
   (torch.cuda.set_per_process_memory_fraction) and runs the CLI in
   memory on the stream route's points from a .npy: exit 0, num_batches
   > 1 chosen by doubling, centroids equal to the streamed fit at that
   count called directly. [minibatch]: --minibatch on the same points
   file (8 batches, 3 epochs, first_k seeds) on --kernel=pallas (B1 once
   per batch and epoch in each fit, nothing else) and on --kernel=xla
   (no kernel), every epoch's last-batch SSE within 1e-5 and shift
   within 1e-3 of the other's (relative: near-tie label flips move
   centroids apart); one step on the first batch from the same state,
   B1's labels equal the plain version's but at near-ties and the
   clusters they do not touch within 1e-4 of 'xla'; one epoch bitwise
   repeatable; the weighted step (B4 once per batch).
17. The model zoo. [seeding]: k-means++ and k-means‖ alone at N=2^22,
   d=128, K=1024 (the fused route's points), timed, twice each from one
   generator seed: K distinct rows of x, bitwise repeats, no kernel
   launched; then phase 4's CLI with --init=kmeans_parallel (B1 as in
   phase 4), its computation_time beside phase 4's. [bisecting]: the CLI
   with --method_name=bisectingKMeans in memory at N=2^22, d=128, K=32
   (K cut from the fused route's 1024: each split is a weighted 2-means
   over all N rows, one after another), no kernel launched, its fit
   bitwise equal to the function called again; streamed at N=2^20 in 4
   batches, K=4, its SSE within REL_TOL of the in-memory fit's on the
   same points. [estimators]: KMeans(kernel="pallas", init="kmeans||")
   on the fused route's points (B1 n_iter_ + 1 times, B2 once for
   labels_, which equal kmeans_predict's); FuzzyCMeans (B6),
   GaussianMixture (B9) and BisectingKMeans at N=2^16, K=32, each
   bitwise equal to its function; save_fitted then load_fitted predicts
   the same labels; silhouette, Davies-Bouldin and Calinski-Harabasz at
   N=2^16, finite and bitwise repeatable.
18. The rest of data parallel. [dp_gmm_route]: the GMM route's CLI
   (diag, K=1024, d=128) with --kernel=xla (B9 is single-device) at
   N=2^20 (cut from 2^22: the in-memory E-step's (rows, K) tensors of
   two ranks and the one-GPU fit do not fit one card at 2^22) on two
   ranks against one GPU: n_iter equal, the log-likelihood within
   REL_TOL, means within 1e-4, every rank's means bitwise equal, no
   kernel launched. [dp_relocate]: kmeans_fit(mesh, empty_policy=
   "relocate", kernel="pallas") at B1's shape on two ranks from seeds of
   which 8 are parked far from every point, after 1 and 3 steps, against
   one GPU: B1 n_iter + 1 times per rank and nothing else, n_iter equal,
   SSE within REL_TOL, after one step the relocated rows bitwise one
   GPU's and the centroids within 1e-4 (after 3, within 0.05: later
   steps flip near-tie rows). [stream_dp_q]: the stream_dp CLI over 5
   steps on two ranks with --reduce=per_pass, per_pass:bf16 and
   per_pass:int8 (and Fuzzy C-Means, m=2, per_pass and per_pass:int8):
   the quantized SSE (J_m) within 1e-3 of per_pass (the centroids moved
   past 0.05 are counted), fewer logical bytes, the strategy label
   JAX's, B1 (B6) 2 x 4 x passes per rank (k-means++ seeds: from
   first_k ones five steps carry the quantization into other label
   flips). [hier]: four ranks on the card as a (2, 2)
   make_hierarchical_mesh(2) against four flat ranks, streamed K-Means
   on the stream_dp points per_batch (one step: n_iter and SSE equal
   within REL_TOL, centroids within 1e-4, twice the flat fit's reduces)
   and per_pass:int8 (5 steps: the SSE within 1e-3 of the flat per_pass
   and per_pass:int8 fits); every rank's centroids bitwise equal in
   every fit, B1 4 x passes per rank.
19. Checkpoints ([ckpt], run inside phase 16 on its points file): the
   CLI with --ckpt_dir at the stream route's shape (4 steps, a mid-pass
   save every 3 batches; one fit, timed as the computation, B1 5 x 8);
   streamed_kmeans_fit killed in pass 3 at batch 7 and resumed from the
   save at batch 6; a spawned child with the SIGTERM handler installed
   that signals itself in pass 3 must exit 75 with a mid-pass
   checkpoint, then resumed here; fuzzy (B6) and diag GMM (B9) at
   N=2^20 with per-iteration checkpoints, killed in pass 3; two ranks
   per_batch at N=2^21 killed in pass 2 (rank 0 writes); mini-batch
   killed in epoch 2. Every resume is bitwise equal to the
   uninterrupted fit and launches its kernel once per batch it computes
   (none for the replayed prefix); every save's time and size printed.
20. Residency ([residency], run inside phase 16 on its points file and
   STREAM_ARGS): (a) the CLI with --residency=hbm: bitwise equal to
   [stream_route]'s fit (centroids, history, SSE, n_iter), B1 2 x 8 x 11,
   no batch copied to the card after each fit's first pass; (b)
   --residency=spill: bitwise, its SpillReport (bytes, copy and stall
   seconds, overlap bound, cross-pass batches); (c) residency='auto' with
   the planner's budget set between the 3-slot ring and the 5.12 GB
   cache: it picks spill (its `residency_spill` event printed), bitwise;
   (d) Fuzzy C-Means --residency=hbm at [stream_fuzzy]'s shape: bitwise,
   B6 2 x 8 x 5; (e) residency='hbm' with ckpt_dir, ckpt_every=3, 6
   iterations, resumed to 10: bitwise [stream_route]'s fit; (f) two ranks
   --reduce=per_pass --residency=hbm at [stream_dp]'s shape: bitwise its
   per_pass fit. Each fit's seconds printed; for (a) and (d) also the
   fill pass's and the mean cached pass's, timed between synchronizes.

Then it prints one JSON line with every kernel's numbers, the card's name
and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a card it exits 2 and prints no result.
"""

from __future__ import annotations

import csv
import json
import math
import multiprocessing as mp
import os
import queue as queue_lib
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tdc_tpu_torch.cli import main as cli
from tdc_tpu_torch.data import make_blobs, to_feature_major
from tdc_tpu_torch.models import (
    fuzzy_cmeans_fit,
    gmm_fit,
    kmeans_fit,
    kmeans_predict,
)
from tdc_tpu_torch.models import gmm as gm
from tdc_tpu_torch.ops import _build
from tdc_tpu_torch.ops import fuzzy_kernels as fk
from tdc_tpu_torch.ops import gmm_kernels as gk
from tdc_tpu_torch.ops import lloyd_kernels as lk
from tdc_tpu_torch.ops import sorted_stats as ss
from tdc_tpu_torch.ops import tall as tk
from tdc_tpu_torch.ops.assign import (
    SufficientStats,
    apply_centroid_update,
    fuzzy_memberships,
)
from tdc_tpu_torch.ops.init import init_random
from tdc_tpu_torch.parallel import multihost
from tdc_tpu_torch.parallel.mesh import make_mesh
from tdc_tpu_torch.parallel.sharded_k import (
    _resolve_init_sharded,
    fuzzy_fit_sharded,
    kmeans_fit_sharded,
    make_mesh_2d,
)

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): f32 on the CUDA
# cores, dense bf16 on the tensor cores and HBM3 bandwidth. bound_ms is
# the larger of ops/peak and bytes/bandwidth for the work one call needs.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

# Tolerances (float32, different summation order than the plain version):
# a sum of m terms carries error ≲ m·2^-24·Σ|terms|; over the cluster sizes
# here 1e-5 of the absolute sum bounds it with room to spare.
REL_TOL = 1e-5
# A label may differ from the plain version's only at a near-tie: where
# the two candidates' exact distances differ by less than this fraction
# of the point's squared norm plus the centroid's (f32 matmul-form error).
TIE_TOL = 1e-5

B1_SHAPE = (1 << 22, 1024, 128)
SORTED_N, SORTED_K, SORTED_D = 1 << 19, 16384, 768
TIE_N = 1 << 16  # rows of the tie check, at both routes' K and d
# The large-K regime of the JAX package (K=16,384, d=768) cut to one
# card's time budget: N from 1e9 to 2^19 rows and 4 iterations (5 stats
# calls per fit). --init=random because k-means++ would take 16,384
# sequential rounds.
SORTED_ARGS = [
    "--method_name=distributedKMeans", f"--n_obs={SORTED_N}",
    f"--n_dim={SORTED_D}", f"--K={SORTED_K}", "--kernel=pallas",
    "--n_max_iters=4", "--tol=-1", "--seed=0", "--init=random",
]
MAIN_ARGS = [
    "--method_name=distributedKMeans", f"--n_obs={B1_SHAPE[0]}",
    f"--n_dim={B1_SHAPE[2]}", f"--K={B1_SHAPE[1]}", "--kernel=pallas",
    "--n_max_iters=10", "--tol=-1", "--seed=0",
]
FUZZY_ARGS = [
    "--method_name=distributedFuzzyCMeans", *MAIN_ARGS[1:], "--fuzzifier=2.0",
]
# The diag-GMM vocabulary regime of Fisher-vector image encoding (K in the
# hundreds to thousands, d = 64-128), on the fused routes' data.
GMM_ARGS = [
    "--method_name=gaussianMixture", *MAIN_ARGS[1:],
    "--covariance_type=diag", "--init=kmeans++",
]
# The bf16 routes: --dtype bfloat16 (a bf16 data file) and pallas_bf16.
BF16_ARGS = [*MAIN_ARGS, "--dtype=bfloat16"]
MXU_ARGS = [a.replace("--kernel=pallas", "--kernel=pallas_bf16")
            for a in MAIN_ARGS]
BF16_SORTED_N = 1 << 17  # rows of the bf16 sorted-route check
FUZZY_MS = (2.0, 1.7)  # B6 is checked at both fuzzifiers
FUZZY_RAGGED = ((1 << 16) + 37, 300, 19)  # N, K, d: no multiple of a tile
SMALL_K_SHAPE = ((1 << 16) + 37, 37, 768)  # B7 where the nearest dominate
# B7 where its 3xTF32 product and the champion's f32 rescore are what
# hold s (scripts/b2_b7_phases.py): at d = 1, K = 1 s is one centroid's inv,
# all cancellation near it (without the rescore hundreds to tens of
# thousands of times the tolerance); at d = 19, K = 37 one TF32 pass
# reads 3.7 to 5.5 times it. On rows on centroids, without the rescore,
# Σμ runs past N by many orders of magnitude.
B7_EDGE_SHAPES = ((129, 1, 1), (1000, 37, 19))
# Rows equal to centroids (K, d): their nearest d² is all cancellation.
ON_CENTROIDS = (300, 768)
ZERO_SHARE = 0.05  # share of the weights set exactly to 0
# The feature-major routes: the reference sweep's largest point (n_obs =
# 100M, n_dim = 5, K in {15, 12, 9, 6, 3}; SURVEY.md), uncut.
TALL_SHAPE = (10 ** 8, 15, 5)  # N, K, d
TALL_WIDE = (1 << 18, 1024, 128)
# B10's streaming form (one CTA per SM; at K=15, d=5 12 consumer warps,
# 1536-column tiles through a ring of 2 slots on f32 columns, 5 on bf16;
# ops/tall.py `lloyd_plan`) at its edges, small and fast, before the 10^8
# shape: one tile and one column; more tiles than slots × CTAs (every
# CTA's ring wraps); rows misaligned for the bulk copies (N·itemsize % 16
# != 0: the last tiles read directly); K·(d+1) = 144 at d = 8, the form's
# limit (8 warps, 1024-column tiles), misaligned, and one of its tiles and
# one column.
TALL_EDGES = ((1537, 15, 5), (1 << 21, 15, 5), ((1 << 20) + 3, 15, 5),
              ((1 << 16) + 37, 16, 8), (1025, 16, 8))
# Past the earlier private form's limit (K·(d+1) = 96): timed with its
# bound (3.2 GB of f32 columns).
TALL_K16_D8 = (10 ** 8, 16, 8)
HANG_S = 60  # seconds a B10 edge case may take before the run ends
# B11's private form at a small N: too few columns for one TF32 pass's
# rounding of μᵀ·X to average out below REL_TOL of Σμ|x|, so its Σμx check
# fails a product that is not 3xTF32 (scripts/b11_phases.py's one_tf32).
TALL_SMALL = (1000, 15, 5)
TALL_ARGS = [
    "--method_name=distributedKMeans", f"--n_obs={TALL_SHAPE[0]}",
    f"--n_dim={TALL_SHAPE[2]}", f"--K={TALL_SHAPE[1]}", "--layout=features",
    "--n_max_iters=20", "--tol=-1", "--seed=0",
]
TALL_FUZZY_ARGS = ["--method_name=distributedFuzzyCMeans", *TALL_ARGS[1:],
                   "--fuzzifier=2.0"]
TALL_BF16_ARGS = [*TALL_ARGS, "--dtype=bfloat16"]
FM_N = 1 << 24  # points of the .fm.npy file route
TALL_STEP = 1 << 24  # columns per step of the f64 reference sums
# The multi-GPU routes: two ranks on the one card (gloo on its CUDA
# tensors: NCCL takes one rank per GPU). The K-sharded fuzzy route is the
# sorted route's large-K shape on a (1, 2) grid, B7 and B8 on each shard;
# the data-parallel fused route is the fused route on two ranks, B1 on
# each.
RANKS = 2
SHARD_ARGS = [
    "--method_name=distributedFuzzyCMeans", "--kernel=pallas",
    f"--shard_k={RANKS}", f"--n_GPUs={RANKS}", f"--n_obs={SORTED_N}",
    f"--n_dim={SORTED_D}", f"--K={SORTED_K}", "--n_max_iters=4", "--tol=-1",
    "--init=random", "--fuzzifier=2", "--seed=0",
]
DP_ARGS = [*MAIN_ARGS, f"--n_GPUs={RANKS}"]
RANK_TIMEOUT = 600  # seconds a rank may take for one route
# Lloyd iterations of the fused-gather sorted step and of the K-sharded
# K-Means route, both at the sorted route's shape (tol < 0).
SORTED_ITERS = 4
# Earlier times that this run's are printed beside (chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md): B12 before B3's redesign
# (one-call medians), B6 (m=2, m=1.7) and B9 at the routes' shape before
# their redesign, and the K-sharded fuzzy route before B8's redesign.
B12_EARLIER_MS, B12_BF16_EARLIER_MS = 1.2460, 1.3586
B6_EARLIER_MS = {2.0: 112.06, 1.7: 141.45}
B9_EARLIER_MS = 197.72
# B1 and B4 before their redesign (the product on the f32 FMA pipe), at
# the route's shape, printed beside this run's: the phase split and the
# answers measured by scripts/b1_b4_phases.py --parent on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md). near_ties: labels that differ
# from the plain version's on the near-tie input (2^16 rows at the
# route's K and d), gap_share: the largest true gap among them as a
# share of the near-tie limit; tol_share: the largest share of the sums'
# tolerance used at the route's shape.
B1_EARLIER = dict(ms=38.40, product_fold_ms=33.50, accumulate_ms=4.79,
                  zero_reduce_ms=0.21, near_ties=0, tol_share=0.4401)
B4_EARLIER = dict(ms=38.85, accumulate_ms=4.95, zero_reduce_ms=0.19,
                  near_ties=0, tol_share=0.4063)
SHARDED_FUZZY_EARLIER_S = 20.7764
# B5 and B11 before their redesign (PR 6's `wmma` kernel, PR 7's private
# form), at the routes' shapes: the phase split measured by
# scripts/b5_phases.py --parent and scripts/b11_phases.py --parent on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md); tol_share: the largest share
# of the sums' tolerance used.
B5_EARLIER = dict(ms=15.10, f32_rows_ms=15.11, staging_product_ms=8.40,
                  fold_ms=4.19, accumulate_ms=2.52, tol_share=0.4694)
B11_EARLIER = dict(ms=6.85, accumulate_ms=2.43, powers_ms=1.40,
                   rest_ms=3.02, m_1_7_ms=15.70, tol_share=0.0080)
# The streamed routes (--num_batches): BASELINE.json config 3's shape
# (N=10^7, d=128, K=1024, f32) in 8 batches, --init=first_k so the
# streamed fit and the in-memory one start alike; the same points for
# fuzzy (m=2, B6) and diag GMM (B9), 4 iterations; the reference
# notebook's 5*10^8 x 2, K=3 job with N cut to 10^8, 8 batches; two ranks
# on 4 batches at the fused route's shape (N one past a multiple of the
# ranks in every batch, so each rank's slice is padded and corrected).
STREAM_N, STREAM_D, STREAM_K = 10 ** 7, 128, 1024
STREAM_BATCHES = 8
STREAM_ARGS = [
    "--method_name=distributedKMeans", f"--n_obs={STREAM_N}",
    f"--n_dim={STREAM_D}", f"--K={STREAM_K}", "--kernel=pallas",
    "--n_max_iters=10", "--tol=-1", "--seed=0", "--init=first_k",
]
STREAM_FUZZY_ARGS = ["--method_name=distributedFuzzyCMeans",
                     *STREAM_ARGS[1:-3], "--n_max_iters=4", "--tol=-1",
                     "--seed=0", "--init=first_k", "--fuzzifier=2.0"]
STREAM_GMM_ARGS = ["--method_name=gaussianMixture", *STREAM_ARGS[1:-3],
                   "--n_max_iters=4", "--tol=-1", "--seed=0",
                   "--init=first_k", "--covariance_type=diag"]
REF_ARGS = [
    "--method_name=distributedKMeans", f"--n_obs={10 ** 8}", "--n_dim=2",
    "--K=3", "--kernel=pallas", "--n_max_iters=20", "--tol=1e-4",
    "--seed=0", "--init=first_k",
]
# The two-rank fits take one Lloyd step (and the scoring pass): from
# first_k seeds a later step flips near-tie labels between the ranks' sum
# order and one rank's (5 steps ended 0.0138 apart in a centroid with the
# SSE equal), and the centroids are held to one rank's within 1e-4.
STREAM_DP_ARGS = [
    "--method_name=distributedKMeans", f"--n_obs={(1 << 22) + 3}",
    "--n_dim=128", "--K=1024", "--kernel=pallas", "--n_max_iters=1",
    "--tol=-1", "--seed=0", "--init=first_k", "--num_batches=4",
]
# The rest of data parallel. [dp_gmm_route]: GMM_ARGS on --kernel=xla
# (the mesh E-step is the torch one: B9 is single-device), N cut from
# 2^22 to 2^20: the in-memory E-step holds several (rows, K) f32 tensors
# at once (logp, r and their temporaries, ~4 GB each at 2^20 rows), too
# many for two ranks and the one-GPU fit on one card at 2^22.
# [dp_relocate]: B1's shape on two ranks, RELOCATE_EMPTY centroids parked
# far from every point (empty after the first step, so relocated), 1 and
# RELOCATE_ITERS steps. [stream_dp_q]: STREAM_DP_ARGS over Q_ITERS steps
# from k-means++ seeds (rank 0's draw on the first batch), per_pass
# against per_pass:bf16 and per_pass:int8: the SSE within Q_SSE_TOL
# (JAX's bound, tests/test_reduce.py:304-381); the centroids past JAX's
# 0.05 (Q_CENTROID_TOL) are counted, not held: with 1024 centroids some
# share a blob and split it along near-ties, which the encoding's
# perturbation flips (on an NVIDIA H100 80GB HBM3 at 700 W one moved 0.23
# under bf16 with the SSE 9.7e-5 apart; PERF.md). From first_k seeds
# (several in one of the 1024 blobs, whose boundaries then cut it) five
# steps carried the quantization's perturbation into other label flips,
# 1.8e-3 (bf16) and 5.5e-3 (int8) off the per_pass SSE with a centroid
# 7.6 apart (same card); k-means++ seeds one blob each, nearly. [hier]:
# HIER_RANKS ranks as a (2, 2) mesh (n_hosts=2 on the one card) against
# HIER_RANKS flat ranks on the stream_dp points, per_batch (one step from
# first_k) and per_pass:int8 (Q_ITERS from k-means++).
DP_GMM_N = 1 << 20
DP_GMM_ARGS = [a.replace("--kernel=pallas", "--kernel=xla")
               .replace(f"--n_obs={B1_SHAPE[0]}", f"--n_obs={DP_GMM_N}")
               for a in GMM_ARGS]
RELOCATE_EMPTY = 8
RELOCATE_ITERS = 3
RELOCATE_SEED = 19
Q_ITERS = 5
Q_SSE_TOL = 1e-3
Q_CENTROID_TOL = 0.05
HIER_RANKS = 4
# The [oom] child's allocator may hold this share of the points' bytes;
# its fits run OOM_ITERS iterations, to keep the phase short.
OOM_SHARE = 0.5
OOM_ITERS = 1
# The 10-step streamed and in-memory stream route fits: each iteration's
# SSE within this share of the other's (measured up to 8.3e-8 on an H100:
# the f32 sums' order, and the near-tie label flips it carries).
STEP_SSE_TOL = 1e-6


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_table(log: str) -> list:
    """(source, kernel, registers, spill stores/loads) of every kernel in
    the build's `nvcc -Xptxas -v` log, names demangled by c++filt where it
    is installed."""
    rows, source, kernel, spills = [], "", "", ""
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            parts = line.split()
            spills = f"{parts[parts.index('spill') - 2]}/" + (
                f"{parts[parts.index('loads') - 3]}")
        elif "Used" in line and "registers" in line and kernel:
            regs = line.split("Used")[1].split("registers")[0].strip()
            rows.append([source, kernel, regs, spills])
            kernel = ""
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[1] for r in rows),
            capture_output=True, text=True).stdout
        for r, name in zip(rows, names.splitlines()):
            r[1] = name.replace("(anonymous namespace)::", "").split("(")[0]
    return rows


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tc_bound_ms(tc_flops: float, f32_flops: float, nbytes: float,
                passes: int = 3) -> tuple[float, str]:
    """The bound of a kernel whose products of tc_flops run on the tensor
    cores as `passes` TF32 products (3xTF32: three; two where one operand
    is exact in TF32) and the rest on the f32 pipe: the larger of that
    time and bytes/bandwidth."""
    t_ops = (passes * tc_flops / PEAK_TF32_TC_FLOPS
             + f32_flops / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def blob_data(gen, n, k, d):
    """Points around k well-separated centers, every center used: the
    centers are the centroids, so no near-ties are expected."""
    centers = (torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) * 3
    labels = torch.arange(n, device="cuda") % k
    x = torch.randn((n, d), generator=gen, device="cuda") + centers[labels]
    return x.contiguous(), centers.contiguous()


def make_weights(n: int, seed: int) -> torch.Tensor:
    """(n,) f32 weights on the card: uniform in [0, 3), about ZERO_SHARE
    of them exactly 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(n, generator=g, device="cuda") * 3.0
    return torch.where(torch.rand(n, generator=g, device="cuda") < ZERO_SHARE,
                       0.0, w).contiguous()


# The largest share of its tolerance that each check_close used, by name.
TOL_SHARES = {}
# The largest true gap between a flipped label's two candidates, as a
# share of the near-tie limit, by check_labels' name.
TIE_GAP_SHARES = {}


def check_close(name, got, want, scale):
    err = (got - want).abs()
    tol = REL_TOL * scale + 1e-6
    bad = err > tol
    require(not bool(bad.any()),
            f"{name}: {int(bad.sum())} entries beyond {REL_TOL}·scale "
            f"(max err {float(err.max())})")
    TOL_SHARES[name] = float((err / tol).max())
    return float(err.max())


def tol_shares(prefix) -> dict:
    return {k: round(v, 4) for k, v in TOL_SHARES.items()
            if k.startswith(prefix)}


def check_labels(name, x, c, got, want) -> int:
    """Labels equal except at near-ties (TIE_TOL); returns the count of
    near-tie differences."""
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        xd = x[diff].double()
        dg = ((xd - c[got[diff].long()].double()) ** 2).sum(1)
        dw = ((xd - c[want[diff].long()].double()) ** 2).sum(1)
        scale = (xd * xd).sum(1) + (c.double() ** 2).sum(1).max()
        share = (dg - dw).abs() / (TIE_TOL * scale)
        TIE_GAP_SHARES[name] = float(share.max())
        far = (share > 1).sum()
        require(int(far) == 0, f"{name}: {int(far)} labels differ from the "
                               "plain version beyond a near-tie")
    return int(diff.numel())


def near_tie_data(gen, n, k, d, ways=2):
    """Points off the point equidistant from centroids i % k .. (i + ways
    - 1) % k in their affine span (centroids as blob_data's centers; at
    ways = 2 the midpoint) by a Gaussian offset whose scale, drawn per
    row, is log-uniform over 1e-6..10^-2.5 a coordinate: the true gaps
    between the candidates' distances run from far inside the near-tie
    limit (TIE_TOL) to some ten times past it. A product as exact as f32
    flips labels only inside it; one TF32 pass (2^-11 operands) flips rows
    past it, and check_labels fails it. At ways = 3 one TF32 pass also
    drops the nearest of three candidates out of a kernel's two best, so
    that an exact decision between those two still picks past the limit."""
    c = ((torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) * 3
         ).contiguous()
    # The equidistant point of each group in f64: p0 + Σ α_i u_i with u_i
    # = p_i − p0 and (U Uᵀ) α = ‖u_i‖² / 2.
    group = (torch.arange(k, device="cuda")[:, None]
             + torch.arange(ways, device="cuda")) % k
    p = c.double()[group]
    u = p[:, 1:] - p[:, :1]
    gram = u @ u.transpose(1, 2)
    alpha = torch.linalg.solve(gram, 0.5 * gram.diagonal(dim1=1, dim2=2))
    center = (p[:, 0] + (alpha[:, None] @ u)[:, 0]).float()
    del group, p, u, gram, alpha
    x = center[torch.arange(n, device="cuda") % k]
    s = 10.0 ** (-6.0 + 3.5 * torch.rand((n, 1), generator=gen,
                                         device="cuda"))
    return (x + s * torch.randn((n, d), generator=gen, device="cuda")
            ).contiguous(), c


def tie_reach(x, c, ways=2) -> int:
    """Rows of near_tie_data's input whose group's nearest and farthest
    candidates' exact distances differ by more than the near-tie limit and
    by at most ten times it: the labels that a product coarser than f32
    flips and check_labels must then refuse. Fails unless they are a tenth
    of the rows or more."""
    n, k = x.shape[0], c.shape[0]
    group = (torch.arange(n, device=x.device)[:, None]
             + torch.arange(ways, device=x.device)) % k
    xd, cd = x.double(), c.double()
    dist = torch.stack([((xd - cd[group[:, i]]) ** 2).sum(1)
                        for i in range(ways)], 1)
    gap = dist.max(1).values - dist.min(1).values
    lim = TIE_TOL * ((xd * xd).sum(1) + (cd * cd).sum(1).max())
    reach = int(((gap > lim) & (gap <= 10 * lim)).sum())
    require(reach >= n // 10, f"near-tie input: only {reach} of {n} rows "
                              "lie past the near-tie limit")
    return reach


def check_near_ties(name, x, c, w=None) -> dict:
    """check_fused on near_tie_data's input: the near-tie count, the
    largest flipped gap as a share of the limit, and the rows past it."""
    reach = tie_reach(x, c)
    ties = check_fused(name, x, c, w)[1]
    return dict(near_ties=ties, gap_share=TIE_GAP_SHARES.get(name, 0.0),
                rows_past_limit=reach)


def check_fused(name, x, c, w=None) -> tuple[float, int]:
    """B1 (w None) or B4 against its plain version, with labels: two runs
    bitwise equal; labels equal to the plain version's but at near-ties
    (check_labels); where they all agree, counts equal (B4: the mass
    within REL_TOL relative) and the sums within REL_TOL of Σ|x| (B4:
    Σw|x|) per cluster, else the sums within REL_TOL of f64 sums by the
    kernel's own labels; the SSE within REL_TOL relative. Returns (max abs
    error of the sums, near-tie count)."""
    if w is None:
        run = lambda: lk.lloyd_stats_fused(x, c, return_labels=True)
        want, plab = lk.lloyd_stats_fused_plain(x, c, return_labels=True)
        wt = torch.ones(x.shape[0], device="cuda")
    else:
        run = lambda: lk.lloyd_stats_fused_weighted(x, c, w,
                                                    return_labels=True)
        want, plab = lk.lloyd_stats_fused_weighted_plain(
            x, c, w, return_labels=True)
        wt = w
    (got, lab), (again, lab2) = run(), run()
    repeatable(name, (*got, lab), (*again, lab2))
    ties = check_labels(name, x, c, lab, plab)
    ref_lab = lab if ties else plab
    abs_sums = torch.zeros_like(want.sums).index_add_(
        0, ref_lab.long(), wt[:, None] * x.abs())
    if ties:
        ref = torch.zeros(want.sums.shape, dtype=torch.float64,
                          device="cuda").index_add_(
            0, lab.long(), wt[:, None].double() * x.double())
        err = check_close(f"{name} sums (own labels)", got.sums.double(),
                          ref, abs_sums.double())
    else:
        if w is None:
            require(torch.equal(got.counts, want.counts),
                    f"{name}: counts differ")
        else:
            check_close(f"{name} mass", got.counts, want.counts,
                        want.counts.abs())
        err = check_close(f"{name} sums", got.sums, want.sums, abs_sums)
    check_close(f"{name} sse", got.sse, want.sse, want.sse.abs())
    return err, ties


def fused_bound(n, k, d, weighted) -> dict:
    """B1's or B4's bound: the 2·N·K·d product on the tensor cores in
    3xTF32 and the accumulate's N·d adds (B4: 2·N·d, with w·x) on the f32
    pipe (bound_ms), or all of it on the f32 pipe (bound_f32_ms); bytes:
    x (B4: and w) once, the centroids, the sums, counts and SSE."""
    rest = (2.0 if weighted else 1.0) * n * d
    nbytes = 4.0 * (n * d + (n if weighted else 0) + 2 * k * d + 2 * k + 1)
    b_ms, b_by = tc_bound_ms(2.0 * n * k * d, rest, nbytes)
    return dict(bound_ms=b_ms, bound_by=b_by,
                bound_f32_ms=bound_ms(2.0 * n * k * d + rest, nbytes)[0])


def fused_phases(x, c, w=None) -> dict:
    """B1's or B4's fixed cost at the route's grid: one 128-row block per
    CTA (the centroid pre-pass, the workspace zeroing, one block's
    product and accumulate, the slice reduce)."""
    rows = 128 * torch.cuda.get_device_properties(0).multi_processor_count
    ww = None if w is None else w[:rows]
    return dict(one_block_ms=median_ms(
        lambda: lk._fused_tc(x[:rows], c, ww, False), 5))


def repeatable(name, a, b) -> None:
    for u, v in zip(a, b):
        require(torch.equal(u, v), f"{name}: two runs differ bitwise")


def phase_kernels(gen) -> dict:
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns the per-kernel numbers (without launches)."""
    out = {}
    n, k, d = B1_SHAPE
    x, c = blob_data(gen, n, k, d)
    err, ties = check_fused("B1", x, c)
    require(ties == 0, f"B1: {ties} labels differ at the route's shape "
                       "(counts must be equal there)")
    out["B1"] = dict(
        max_abs_err=err, near_ties=ties,
        ms=median_ms(lambda: lk.lloyd_stats_fused(x, c), 5),
        plain_ms=median_ms(lambda: lk.lloyd_stats_fused_plain(x, c), 3),
        **fused_bound(n, k, d, False), **fused_phases(x, c))
    del x, c
    xn, cn = near_tie_data(gen, TIE_N, k, d)
    out["B1"]["near_tie_input"] = check_near_ties("B1 near-tie input", xn,
                                                  cn)
    del xn, cn
    print(f"[B1] N={n} K={k} d={d} (3xTF32 on the tensor cores): "
          f"{json.dumps(out['B1'])}; share of the tolerance used: "
          f"{json.dumps(tol_shares('B1'))}; before the redesign: "
          f"{json.dumps(B1_EARLIER)}", flush=True)

    n, k, d = SORTED_N, SORTED_K, SORTED_D
    x, c = blob_data(gen, n, k, d)
    lab, mind = lk.distance_argmin(x, c, return_dist=True)
    repeatable("B2", (lab, mind), lk.distance_argmin(x, c, return_dist=True))
    plab, pmind = lk.distance_argmin_plain(x, c, return_dist=True)
    ties = check_labels("B2", x, c, lab, plab)
    scale = (x * x).sum(1) + (c * c).sum(1).max()
    err = check_close("B2 min", mind, pmind, scale)
    slab, smind = lk.distance_argmin(x, c)
    err = max(err, check_close("B2 shifted min", smind,
                               lk.distance_argmin_plain(x, c)[1], scale))
    require(torch.equal(slab, lab), "B2: shifted and true forms disagree")
    # The 2·N·K·d product on the tensor cores in 3xTF32 (bound_ms) or on
    # the f32 FMA pipe (bound_f32_ms); the champion's ‖x − c‖² (2·N·d) on
    # the FMA pipe beside it.
    nbytes = 4.0 * (n * d + k * d + k) + 8.0 * n
    b_ms, b_by = tc_bound_ms(2.0 * n * k * d, 2.0 * n * d, nbytes)
    out["B2"] = dict(
        max_abs_err=err, near_ties=ties,
        ms=median_ms(lambda: lk.distance_argmin(x, c, return_dist=True), 5),
        plain_ms=median_ms(
            lambda: lk.distance_argmin_plain(x, c, return_dist=True), 3),
        bound_ms=b_ms, bound_by=b_by,
        bound_f32_ms=bound_ms(2.0 * n * k * d + 2.0 * n * d, nbytes)[0])
    del x, c, mind, plab, pmind, slab, smind, scale
    # B2 on the near-tie inputs at the route's K and d: labels may differ
    # from the plain version's only at near-ties. Two candidates a row:
    # one TF32 pass flips labels past the limit unless an f32 decision
    # between the two best follows; three: one TF32 pass also drops the
    # nearest out of the two best, so only the 3xTF32 product passes.
    for ways, key in ((2, "near_tie_input"), (3, "near_tie_input_3way")):
        xn, cn = near_tie_data(gen, TIE_N, k, d, ways)
        reach = tie_reach(xn, cn, ways)
        nlab, nmin = lk.distance_argmin(xn, cn, return_dist=True)
        name = f"B2 {key.replace('_', ' ')}"
        repeatable(name, (nlab, nmin),
                   lk.distance_argmin(xn, cn, return_dist=True))
        plab, pmin = lk.distance_argmin_plain(xn, cn, return_dist=True)
        out["B2"][key] = dict(
            near_ties=check_labels(name, xn, cn, nlab, plab),
            gap_share=TIE_GAP_SHARES.get(name, 0.0),
            rows_past_limit=reach,
            min_err=check_close(f"{name} min", nmin, pmin,
                                (xn * xn).sum(1) + (cn * cn).sum(1).max()))
        del xn, cn, nlab, nmin, plab, pmin
    print(f"[B2] N={n} K={k} d={d} (3xTF32 on the tensor cores): "
          f"{json.dumps(out['B2'])}; share of the tolerance used: "
          f"{json.dumps(tol_shares('B2'))}", flush=True)

    balanced = lab  # every center owns n/k = 32 points
    del lab

    # B3 on the labels of the sorted route's first iteration: the CLI's
    # data (make_blobs(seed + 1)) and its --init=random centroids (seed),
    # assigned by B2 — a skewed run-length distribution. Also on the
    # balanced labels above, on a stated adversarial one (half the rows in
    # label 0, the rest spread evenly) and on one K-shard's relative labels
    # (below), each beside torch.segment_reduce.
    x, _ = make_blobs(1, n, d, k, device="cuda")
    c0 = init_random(torch.Generator(device="cuda").manual_seed(0), x, k)
    cli_labels = lk.distance_argmin(x, c0)[0]
    del c0
    rows = torch.arange(n, device="cuda")
    heavy = torch.where(rows < n // 2, 0, rows % k).to(torch.int32)
    # Shard 1 of the K-sharded K-Means route's (1, 2) grid at its init:
    # the rows that the other shard's centroids win carry the sentinel.
    init = _resolve_init_sharded(
        x, k, "random", torch.Generator(device="cuda").manual_seed(0))
    shard = lk.distance_argmin(x, init)[0] - k // 2
    del init
    label_sets = {"cli": (cli_labels, k), "balanced": (balanced, k),
                  "one_heavy": (heavy, k), "k_shard": (shard, k // 2)}
    runs = {}
    for name, (labels, segs) in label_sets.items():
        order, starts = sort_segments(labels, segs)
        xs = x.index_select(0, order).contiguous()
        runs[name] = check_b3(name, xs, starts)
        if name != "cli":
            print(f"[B3] {name} N={n} segments={segs} d={d}: "
                  f"{json.dumps(runs[name])}", flush=True)
        del order, starts, xs
    # B3 on the weighted sorted route's first-iteration rows: [w·x | w]
    # sorted by the labels of its weighted --init=random centroids (the
    # CLI's weight file is make_weights(n, seed=n)): d+1 = 769 columns,
    # B3's scalar loads.
    w = make_weights(n, n)
    c0 = init_random(torch.Generator(device="cuda").manual_seed(0), x, k, w)
    order, wstarts = sort_segments(lk.distance_argmin(x, c0)[0], k)
    del c0
    xw = torch.cat([x * w[:, None], w[:, None]], dim=1).index_select(
        0, order).contiguous()
    weighted_b3 = dict(d=d + 1, **check_b3("weighted rows", xw, wstarts))
    print(f"[B3] weighted rows N={n} K={k} d={d + 1}: "
          f"{json.dumps(weighted_b3)}", flush=True)
    del w, order, wstarts, xw
    # The cli set's row for the JSON line, its plain version timed there
    # too, and the one-call medians (the earlier method) beside it.
    order, starts = sort_segments(cli_labels, k)
    xs = x.index_select(0, order).contiguous()
    offsets = starts.long()
    main = dict(
        runs["cli"],
        plain_ms=batched_ms(lambda: ss.segment_sums_plain(xs, starts), 5),
        one_call_ms=median_ms(lambda: ss.segment_sums(xs, starts), 20),
        one_call_library_ms=median_ms(lambda: torch.segment_reduce(
            xs, "sum", offsets=offsets, axis=0), 20))
    print(f"[B3] cli N={n} K={k} d={d}: {json.dumps(main)}", flush=True)
    b_ms, b_by = bound_ms(float(n * d), 4.0 * (n * d + k + 1 + k * d))
    out["B3"] = dict(
        **main, bound_ms=b_ms, bound_by=b_by,
        other_labels={name: runs[name] for name in
                      ("balanced", "one_heavy", "k_shard")},
        weighted_rows=weighted_b3)
    del runs, main, xs, starts, offsets
    out["B12"] = phase_gathered_kernel(x, label_sets)
    return out


def batched_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    """Mean time of `reps` back-to-back calls between two CUDA events, the
    median of `rounds` such runs. For sub-millisecond calls (B3, B12 and
    their yardsticks), where one call between two events also holds the
    host's time to launch it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def check_b3(name, xs, starts) -> dict:
    """B3 on one label set: bitwise repeatable, within REL_TOL of Σ|x| of
    its plain version and of torch.segment_reduce (the library call for
    the same sums, over the rows of the segments; timed here only, the
    port never calls it). Timed whole and pass by pass (pass 2 on the
    workspace pass 1 just wrote), beside the library call."""
    got = ss.segment_sums(xs, starts)
    repeatable(f"B3 ({name})", (got,), (ss.segment_sums(xs, starts),))
    abs_sums = ss.segment_sums_plain(xs.abs(), starts)
    err = check_close(f"B3 sums ({name})", got,
                      ss.segment_sums_plain(xs, starts), abs_sums)
    lo, hi = int(starts[0]), int(starts[-1])
    rows, offsets = xs[lo:hi], (starts - lo).long()
    check_close(f"B3 library ({name})", got, torch.segment_reduce(
        rows, "sum", offsets=offsets, axis=0), abs_sums)
    work = ss._workspace(xs, starts)
    ss._launch_segment_sums(xs, starts, work)
    ms = batched_ms(lambda: ss.segment_sums(xs, starts))
    lib_ms = batched_ms(lambda: torch.segment_reduce(
        rows, "sum", offsets=offsets, axis=0))
    return dict(
        max_abs_err=err, longest_run=int((starts[1:] - starts[:-1]).max()),
        ms=ms,
        pass1_ms=batched_ms(lambda: ss._launch_segment_sums(
            xs, starts, work, 1)),
        pass2_ms=batched_ms(lambda: ss._launch_segment_sums(
            xs, starts, work, 2)),
        library_ms=lib_ms, vs_library=ms / lib_ms)


def sort_segments(labels, k):
    """(order int32, starts (k+1,) int32) of the sorted stats: labels
    outside [0, k) take the sentinel k and sort last."""
    labels = torch.where((labels >= 0) & (labels < k), labels, k)
    keys, order = torch.sort(labels.to(torch.int32), stable=True)
    starts = torch.searchsorted(
        keys, torch.arange(k + 1, dtype=torch.int32, device=keys.device))
    return order.to(torch.int32), starts.to(torch.int32)


def check_b12(name, x, order, starts) -> float:
    """B12 bitwise equal to B3 on x.index_select(0, order) (rows widened
    to f32), bitwise repeatable, and within REL_TOL of its plain version
    (scale: Σ|x| per segment). Returns the largest error."""
    got = ss.gathered_segment_sums(x, order, starts)
    repeatable(f"B12 ({name})", (got,),
               (ss.gathered_segment_sums(x, order, starts),))
    xs = x.index_select(0, order).float().contiguous()
    require(torch.equal(got, ss.segment_sums(xs, starts)),
            f"B12 ({name}): not bitwise B3 on the gathered rows")
    return check_close(f"B12 sums ({name})", got,
                       ss.gathered_segment_sums_plain(x, order, starts),
                       ss.segment_sums_plain(xs.abs(), starts))


def phase_gathered_kernel(x, label_sets) -> dict:
    """B12 (B3 with the row gather fused in) on each (labels, segments)
    set, f32 rows, and on the `cli` set's rows in bf16. On the `cli` set
    also its plain version, the route it replaces (index_select, then B3)
    and the library call for the same function (index_add_ into k + 1
    rows, the sentinel's last; timed and held to the kernel here only,
    the port never calls it). Times are `batched_ms`, as B3's."""
    n, d = x.shape
    other = {}
    for name, (labels, k) in label_sets.items():
        order, starts = sort_segments(labels, k)
        err = check_b12(name, x, order, starts)
        other[name] = dict(
            max_abs_err=err, segments=k,
            longest_run=int((starts[1:] - starts[:-1]).max()),
            ms=batched_ms(lambda: ss.gathered_segment_sums(x, order, starts)))
    labels, k = label_sets["cli"]
    order, starts = sort_segments(labels, k)
    main = other.pop("cli")
    clamped = torch.where((labels >= 0) & (labels < k), labels, k).long()
    lib = torch.zeros((k + 1, d), device="cuda").index_add_(0, clamped, x)
    check_close("B12 library", ss.gathered_segment_sums(x, order, starts),
                lib[:k], ss.segment_sums_plain(
                    x.index_select(0, order).abs(), starts))
    del lib
    xb = x.to(torch.bfloat16)
    bf16_err = check_b12("cli, bf16 rows", xb, order, starts)
    b_ms, b_by = bound_ms(float(n * d),
                          4.0 * n * d + 4.0 * n + 4.0 * (k + 1) + 4.0 * k * d)
    bf16_bound = bound_ms(float(n * d), 2.0 * n * d + 4.0 * n
                          + 4.0 * (k + 1) + 4.0 * k * d)[0]
    out = dict(
        **main,
        plain_ms=batched_ms(
            lambda: ss.gathered_segment_sums_plain(x, order, starts), 5),
        route_ms=batched_ms(
            lambda: ss.segment_sums(x.index_select(0, order), starts)),
        library_ms=batched_ms(
            lambda: torch.zeros((k + 1, d), device="cuda").index_add_(
                0, clamped, x), 5),
        one_call_ms=median_ms(
            lambda: ss.gathered_segment_sums(x, order, starts), 20),
        bound_ms=b_ms, bound_by=b_by, other_labels=other,
        bf16_rows=dict(
            max_abs_err=bf16_err, bound_ms=bf16_bound,
            ms=batched_ms(lambda: ss.gathered_segment_sums(xb, order,
                                                           starts)),
            one_call_ms=median_ms(
                lambda: ss.gathered_segment_sums(xb, order, starts), 20)))
    print(f"[B12] N={n} K={k} d={d} (before B3's redesign: "
          f"{B12_EARLIER_MS} ms on f32 rows, {B12_BF16_EARLIER_MS} on bf16, "
          f"one call each): {json.dumps(out)}",
          flush=True)
    return out


def phase_weighted_kernel(gen) -> dict:
    """Phase 3, B4: at the weighted fused route's shape, then the ragged
    case."""
    n, k, d = B1_SHAPE
    x, c = blob_data(gen, n, k, d)
    w = make_weights(n, 1)
    err, ties = check_fused("B4", x, c, w)
    require(ties == 0, f"B4: {ties} labels differ at the route's shape")
    out = dict(
        max_abs_err=err, near_ties=ties,
        ms=median_ms(lambda: lk.lloyd_stats_fused_weighted(x, c, w), 5),
        plain_ms=median_ms(
            lambda: lk.lloyd_stats_fused_weighted_plain(x, c, w), 3),
        **fused_bound(n, k, d, True), library_ms=None,
        zero_weights=int((w == 0).sum()), **fused_phases(x, c, w))
    del x, c, w
    xn, cn = near_tie_data(gen, TIE_N, k, d)
    out["near_tie_input"] = check_near_ties("B4 near-tie input", xn, cn,
                                            make_weights(TIE_N, 3))
    del xn, cn
    print(f"[B4] N={n} K={k} d={d} (3xTF32 on the tensor cores): "
          f"{json.dumps(out)}; share of the tolerance used: "
          f"{json.dumps(tol_shares('B4'))}; before the redesign: "
          f"{json.dumps(B4_EARLIER)}", flush=True)
    n, k, d = FUZZY_RAGGED
    x, c = blob_data(gen, n, k, d)
    err, ties = check_fused("B4 ragged", x, c, make_weights(n, 2))
    print(f"[B4] ragged N={n} K={k} d={d}: equal to the plain version "
          f"(max abs err {err:.3g}, {ties} near-ties), bitwise repeatable",
          flush=True)
    return out


def gmm_abs_sums(x, means, var, w):
    """Σr|x| per component, the scale of the Σr·x check (row blocks)."""
    nv, muinv, bias = gk._operands(means, var, w)
    rows = max(1, (1 << 26) // means.shape[0])
    out = torch.zeros(means.shape, dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        r = torch.softmax((xb * xb) @ nv.T + xb @ muinv.T + bias, dim=1)
        out += r.T.double() @ xb.abs().double()
    return out.float()


def check_gmm(name, x, means, var, w, fn=None) -> float:
    """B9 (or `fn`, another route to its stats) against its plain version:
    two runs bitwise equal, Σr·x within REL_TOL of Σr|x| and Σr·x² of
    itself per component, nk and ll_sum within REL_TOL relative. Returns
    the larger max abs error of the two moment sums."""
    fn = fn or (lambda: gk.gmm_stats_fused(x, means, var, w))
    got = fn()
    repeatable(name, got, fn())
    want = gk.gmm_stats_fused_plain(x, means, var, w)
    err = max(check_close(f"{name} sx", got.sx, want.sx,
                          gmm_abs_sums(x, means, var, w)),
              check_close(f"{name} sxx", got.sxx, want.sxx, want.sxx))
    check_close(f"{name} nk", got.nk, want.nk, want.nk)
    check_close(f"{name} ll", got.ll_sum, want.ll_sum, want.ll_sum.abs())
    return err


def phase_gmm_kernel(gen) -> dict:
    """Phase 3, B9: at the GMM route's shape, then the ragged case. The
    variances and weights are the hard-assignment moments of the blobs
    around their centers (what gmm_fit starts from), so the log-probs have
    the magnitudes a fit sees. Phase 1 (the E-step product on the tensor
    cores and the row logsumexp, writing the log-prob scratch) and phase 2
    (the moments on the tensor cores, from the scratch) are timed apart.
    Both products run on the tensor cores, so bound_ms is the tensor-core
    bound; bound_f32_ms is the bound on the f32 FMA pipe."""
    n, k, d = B1_SHAPE
    x, c = blob_data(gen, n, k, d)
    var, w = gm._moments_from_hard_assign(x, c, 1e-6)
    ops = gk._operands(c, var, w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rc, kp, grid = fk.row_scratch_plan(n, k, fk._TC_K_TILE // 2,
                                       -(-d // fk._D_SLICE), sms)
    design = dict(rows_per_chunk=rc, chunks=-(-n // rc), row_ranges=grid,
                  k_splits=fk.phase1_k_splits(rc, k, 2 * sms),
                  scratch_bytes=4 * rc * kp,
                  scratch_budget=fk.MU_SCRATCH_BYTES,
                  estep_flops=4 * n * k * d, estep_flops_before=8 * n * k * d)
    print(f"[B9 design] N={n} K={k} d={d}: {json.dumps(design)}", flush=True)
    # The E-step and moment products (4·N·K·d each) on the tensor cores in
    # 3xTF32 (bound_ms), or on the f32 FMA pipe (bound_f32_ms); the 2·N·K
    # exps on the SFU beside them.
    nbytes = 4.0 * (n * d + 4 * k * d + 2 * k + 2)
    b_ms, b_by = tc_bound_ms(8.0 * n * k * d, 3.0 * n * d, nbytes)
    out = dict(
        max_abs_err=check_gmm("B9", x, c, var, w),
        ms=median_ms(lambda: gk.gmm_stats_fused(x, c, var, w), 5),
        normalizer_ms=median_ms(lambda: gk._launch(x, *ops, phases=1), 5),
        accumulate_ms=median_ms(lambda: gk._launch(x, *ops, phases=2), 5),
        plain_ms=median_ms(lambda: gk.gmm_stats_fused_plain(x, c, var, w),
                           3),
        bound_ms=b_ms, bound_by=b_by,
        bound_f32_ms=bound_ms(8.0 * n * k * d + 3.0 * n * d, nbytes)[0],
        library_ms=None)
    print(f"[B9] N={n} K={k} d={d} (earlier: {B9_EARLIER_MS} ms): "
          f"{json.dumps(out)}", flush=True)
    del x, c, var, w, ops
    n, k, d = FUZZY_RAGGED
    x, c = blob_data(gen, n, k, d)
    var, w = gm._moments_from_hard_assign(x, c, 1e-6)
    # "soft": the variances 30× wider, so each row's responsibilities
    # spread over several components instead of one.
    for name, scale in (("ragged", 1.0), ("ragged soft", 30.0)):
        err = check_gmm(f"B9 {name}", x, c, var * scale, w)
        print(f"[B9] {name} N={n} K={k} d={d}: equal to the plain version "
              f"(max abs err {err:.3g}), bitwise repeatable", flush=True)
    print(f"[B9] share of the tolerance used: {json.dumps(tol_shares('B9'))}",
          flush=True)
    return out


def b5_near_ties(name, x, c, got, want) -> int:
    """B5's labels equal the plain version's except at near-ties in B5's
    own metric: c2 − 2·x̃·c̃ on the bf16-rounded operands, which both
    compute (in f64 here) and which differ only in the order of the f32
    accumulation. Near: within TIE_TOL of ‖x̃‖² + max ‖c̃‖². Returns the
    count of near-tie differences."""
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        cb, c2 = lk._bf16_operands(x, c)
        xr = x[diff].to(torch.bfloat16).double()
        cr = cb.double()

        def value(lab):
            j = lab[diff].long()
            return c2[j].double() - 2.0 * (xr * cr[j]).sum(1)

        scale = (xr * xr).sum(1) + (cr * cr).sum(1).max()
        far = ((value(got) - value(want)).abs() > TIE_TOL * scale).sum()
        require(int(far) == 0, f"{name}: {int(far)} labels differ from the "
                               "plain version beyond a near-tie")
    return int(diff.numel())


def check_b5(name, x, c) -> tuple[float, int]:
    """B5 against its plain version; returns (max abs error of the sums,
    near-tie count)."""
    k = c.shape[0]
    got, lab = lk.lloyd_stats_fused_bf16(x, c, return_labels=True)
    again, lab2 = lk.lloyd_stats_fused_bf16(x, c, return_labels=True)
    repeatable(name, (*got, lab), (*again, lab2))
    want, plab = lk.lloyd_stats_fused_bf16_plain(x, c, return_labels=True)
    ties = b5_near_ties(name, x, c, lab, plab)

    def bincount(lab):
        return torch.bincount(lab.long(), minlength=k).to(torch.float32)

    other = lab != plab
    require(torch.equal(got.counts - want.counts,
                        bincount(lab[other]) - bincount(plab[other])),
            f"{name}: counts differ where the labels agree")
    xf = x.float()
    mine = torch.zeros_like(want.sums).index_add_(0, lab.long(), xf)
    abs_sums = torch.zeros_like(want.sums).index_add_(0, lab.long(),
                                                      xf.abs())
    err = check_close(f"{name} sums", got.sums, mine, abs_sums)
    if not ties:
        check_close(f"{name} sums (plain)", got.sums, want.sums, abs_sums)
    check_close(f"{name} sse", got.sse, want.sse, want.sse.abs())
    return err, ties


def b5_bound(n, k, d, itemsize) -> tuple[float, str]:
    """B5's least time: the 2·N·K·d product on the bf16 tensor cores, the
    N·d accumulate on the f32 pipe, or the bytes (x once at its own
    width, the bf16 centroids, the f32 c2, sums, counts and SSE)."""
    t_tc = 2.0 * n * k * d / PEAK_BF16_TC_FLOPS
    t_f32 = 1.0 * n * d / PEAK_F32_FLOPS
    t_bytes = (itemsize * n * d + 2 * k * d
               + 4 * (k * d + 2 * k + 1)) / PEAK_HBM_BYTES
    return 1e3 * max(t_tc, t_f32, t_bytes), (
        "bytes" if t_bytes >= max(t_tc, t_f32) else "operations")


def phase_bf16_kernel(gen) -> dict:
    """Phase 3, B5: on f32 rows (pallas_bf16) and bf16 rows at the bf16
    routes' shape, then the ragged case; the bf16 rows' numbers are the
    kernel's line in the JSON (the --dtype bfloat16 route's)."""
    n, k, d = B1_SHAPE
    x, c = blob_data(gen, n, k, d)
    per = {}
    for rows in (x, x.to(torch.bfloat16)):
        key = "bf16_rows" if rows.dtype == torch.bfloat16 else "f32_rows"
        err, ties = check_b5(f"B5 {key}", rows, c)
        b_ms, b_by = b5_bound(n, k, d, rows.element_size())
        one = 128 * torch.cuda.get_device_properties(0).multi_processor_count
        per[key] = dict(
            max_abs_err=err, near_ties=ties,
            tol_share=TOL_SHARES[f"B5 {key} sums"],
            ms=median_ms(lambda: lk.lloyd_stats_fused_bf16(rows, c), 5),
            plain_ms=median_ms(
                lambda: lk.lloyd_stats_fused_bf16_plain(rows, c), 3),
            bound_ms=b_ms, bound_by=b_by,
            # the fixed cost: one 128-row block per CTA
            one_block_ms=median_ms(
                lambda: lk.lloyd_stats_fused_bf16(rows[:one], c), 5))
        print(f"[B5] N={n} K={k} d={d} {key}: {json.dumps(per[key])}",
              flush=True)
    print(f"[B5] before the redesign (PR 6's kernel, PERF.md): "
          f"{json.dumps(B5_EARLIER)}", flush=True)
    out = dict(**per["bf16_rows"], library_ms=None, f32_rows=per["f32_rows"])
    del x, c, rows
    n, k, d = FUZZY_RAGGED
    x, c = blob_data(gen, n, k, d)
    for rows in (x, x.to(torch.bfloat16)):
        err, ties = check_b5(f"B5 ragged {rows.dtype}", rows, c)
        print(f"[B5] ragged N={n} K={k} d={d} {rows.dtype}: equal to the "
              f"plain version (max abs err {err:.3g}, {ties} near-ties), "
              "bitwise repeatable", flush=True)
    return out


def phase_bf16_ties(gen) -> None:
    """Phase 3, bf16 ties: copies of centroid 3 at 5, 67, 200 and K-1 that
    differ from it in f32 but round to the same bf16 values. On bf16 rows
    B5 rounds the centroids first, so the copies tie exactly: the smallest
    index wins, the copies take 0 rows, and the labels equal the plain
    version's."""
    for n, k, d in ((TIE_N, B1_SHAPE[1], B1_SHAPE[2]), FUZZY_RAGGED):
        x, c = blob_data(gen, n, k, d)
        copies = [5, 67, 200, k - 1]
        c = c.to(torch.bfloat16).float()
        c[copies] = c[3] * (1.0 + 2.0 ** -10)
        require(not torch.equal(c[copies[0]], c[3])
                and torch.equal(c[copies].to(torch.bfloat16),
                                c[3].expand(4, d).to(torch.bfloat16)),
                "bf16 ties: the copies must differ in f32 only")
        xb = x.to(torch.bfloat16)
        got, lab = lk.lloyd_stats_fused_bf16(xb, c, return_labels=True)
        _, plab = lk.lloyd_stats_fused_bf16_plain(xb, c, return_labels=True)
        require(torch.equal(lab, plab),
                f"bf16 ties (K={k}): labels differ from the plain version's")
        require(not bool(torch.isin(lab, torch.tensor(copies,
                                                      device="cuda")).any())
                and not bool(got.counts[copies].any()),
                f"bf16 ties (K={k}): a copy took rows")
        print(f"[ties] bf16 N={n} K={k} d={d}: copies {copies} of centroid 3 "
              "(other f32 values, the same bf16 ones) took 0 rows in B5; "
              "labels equal the plain version's", flush=True)


def phase_ties(gen) -> None:
    """Phase 3, ties: copies of centroid 3 at indices 5 (same K tile,
    another lane), 67 and 200 (the same 256-centroid K tile of B1 and B2,
    another thread; a later 64-wide tile of B6's phase 1), 256 and 300
    (the next 256-centroid tile: a later tile wins only on strict <) and
    K-1 (the last tile). Every tie goes to the smallest index: labels
    equal the plain version's exactly, no label lands on a copy, and the
    copies count 0 rows."""
    for n, k, d in ((TIE_N, B1_SHAPE[1], B1_SHAPE[2]),
                    (TIE_N, SORTED_K, SORTED_D)):
        x, c = blob_data(gen, n, k, d)
        copies = [5, 67, 200, 256, 300, k - 1]
        c[copies] = c[3].clone()
        lab = lk.distance_argmin(x, c)[0]
        require(torch.equal(lab, lk.distance_argmin_plain(x, c)[0]),
                f"ties (K={k}): B2 labels differ from the plain version's")
        require(not bool(torch.isin(lab, torch.tensor(copies,
                                                      device="cuda")).any()),
                f"ties (K={k}): a label landed on a copy")
        want = torch.bincount(lab.long(), minlength=k).to(torch.float32)
        sums, counts = ss.sorted_cluster_stats(x, lab, k, pallas=True)
        require(torch.equal(counts, want) and not bool(sums[copies].any()),
                f"ties (K={k}): sorted stats (B3) count a copy")
        if lk.fused_fits(k, d):
            got = lk.lloyd_stats_fused(x, c)
            require(torch.equal(got.counts, want),
                    f"ties (K={k}): B1 counts differ from the tie rule's")
        # With weights: the copies take no mass, and the mass follows the
        # tie rule's labels (B4 where it fits, the weighted sorted stats).
        w = make_weights(n, k)
        mass = torch.zeros(k, device="cuda").index_add_(0, lab.long(), w)
        routes = [ss.lloyd_stats_sorted_weighted(x, c, w)]
        if lk.fused_weighted_fits(k, d):
            routes.append(lk.lloyd_stats_fused_weighted(x, c, w))
        for got in routes:
            require(not bool(got.counts[copies].any())
                    and not bool(got.sums[copies].any()),
                    f"ties (K={k}): a copy took weight mass")
            check_close(f"ties (K={k}) mass", got.counts, mass, mass)
        print(f"[ties] N={n} K={k} d={d}: copies {copies} of centroid 3 "
              f"took 0 rows and 0 mass ({len(routes)} weighted routes); "
              f"labels equal the plain version's", flush=True)


def fuzzy_abs_sums(x, c, m):
    """Σμ|x| per cluster, the scale of the Σμx check (row blocks)."""
    rows = max(1, (1 << 26) // c.shape[0])
    out = torch.zeros(c.shape, dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], rows):
        mu = fuzzy_memberships(x[s:s + rows], c, m) ** m
        out += (mu.T.double() @ x[s:s + rows].abs().double())
    return out.float()


def check_fuzzy(name, x, c, m, fn=None) -> float:
    """B6 (or `fn`, another route to its stats) against its plain version:
    two runs bitwise equal, Σμx within REL_TOL of Σμ|x|, Σμ and the
    objective within REL_TOL relative."""
    fn = fn or (lambda: fk.fuzzy_stats_fused(x, c, m))
    got = fn()
    repeatable(name, got, fn())
    want = fk.fuzzy_stats_fused_plain(x, c, m)
    err = check_close(f"{name} sums", got.weighted_sums, want.weighted_sums,
                      fuzzy_abs_sums(x, c, m))
    check_close(f"{name} weights", got.weights, want.weights,
                want.weights.abs())
    check_close(f"{name} objective", got.objective, want.objective,
                want.objective.abs())
    return err


def phase_fuzzy_kernel(gen) -> dict:
    """Phase 3, B6: at the fuzzy route's shape for each fuzzifier (the
    m=2.0 numbers are the route's), then the ragged case. Phase 1 (the
    row normaliser, writing the inv scratch) and phase 2 (μ and Σμx on the
    tensor cores, from the scratch) are timed apart, and the design before
    it (B7's kernel, then B8's one-slice kernel, which computes the
    distance again, all f32 on the CUDA cores) beside them on the same
    inputs, with its error."""
    n, k, d = B1_SHAPE
    x, c = blob_data(gen, n, k, d)
    c2 = (c * c).sum(dim=1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rc, kp, grid = fk.row_scratch_plan(n, k, fk._TC_K_TILE,
                                       -(-d // fk._D_SLICE), sms)
    design = dict(rows_per_chunk=rc, chunks=-(-n // rc), row_ranges=grid,
                  k_splits=fk.phase1_k_splits(rc, k, 2 * sms),
                  scratch_bytes=4 * rc * kp,
                  scratch_budget=fk.MU_SCRATCH_BYTES,
                  distance_flops=2 * n * k * d,
                  distance_flops_before=4 * n * k * d,
                  powf_per_element_m_not_2=2, before=3)
    print(f"[B6 design] N={n} K={k} d={d}: {json.dumps(design)}", flush=True)
    per_m = {}
    for m in FUZZY_MS:
        def recompute(m=m):
            s, x2 = fk._normalize_phase(x, c, c2, m, 1e-9)
            return fk._accumulate_one_slice(x, c, c2, s, x2, m, 1e-9)

        per_m[m] = dict(
            max_abs_err=check_fuzzy(f"B6 m={m}", x, c, m),
            ms=median_ms(lambda: fk.fuzzy_stats_fused(x, c, m), 5),
            normalizer_ms=median_ms(
                lambda: fk._launch(x, c, c2, m, 1e-9, phases=1), 5),
            accumulate_ms=median_ms(
                lambda: fk._launch(x, c, c2, m, 1e-9, phases=2), 5),
            recompute_design_ms=median_ms(recompute, 5),
            recompute_design_err=check_fuzzy(
                f"B6 recompute design m={m}", x, c, m, fn=recompute),
            plain_ms=median_ms(lambda: fk.fuzzy_stats_fused_plain(x, c, m),
                               3))
        print(f"[B6] N={n} K={k} d={d} m={m} (earlier: {B6_EARLIER_MS[m]} "
              f"ms): {json.dumps(per_m[m])}", flush=True)
    # The distance product (2·N·K·d) on the FMA pipe; μᵀx (2·N·K·d) on the
    # tensor cores in 3xTF32 (bound_ms) or on the FMA pipe (bound_f32_ms);
    # the N·K powers on the SFU beside them.
    nbytes = 4.0 * (n * d + 2 * k * d + 2 * k + 1)
    b_ms, b_by = tc_bound_ms(2.0 * n * k * d, 2.0 * n * k * d, nbytes)
    out = dict(**per_m[2.0], bound_ms=b_ms, bound_by=b_by,
               bound_f32_ms=bound_ms(4.0 * n * k * d, nbytes)[0],
               library_ms=None, m_1_7=per_m[1.7])
    print(f"[B6] bounds: {b_ms} ms ({b_by}) with μᵀx on the tensor cores, "
          f"{out['bound_f32_ms']} ms on the f32 FMA pipe", flush=True)
    del x, c, c2

    n, k, d = FUZZY_RAGGED
    x, c = blob_data(gen, n, k, d)
    i, j = 12345, 77  # row i sits exactly on the integer-valued centroid j
    c[j] = torch.round(c[j])
    x[i] = c[j]
    for m in FUZZY_MS:
        check_fuzzy(f"B6 ragged m={m}", x, c, m)
        w = fk.fuzzy_stats_fused(x[i:i + 1].contiguous(), c, m).weights
        require(float(w[j]) >= 1.0 - 1e-6
                and float(w.sum() - w[j]) <= 1e-6,
                f"B6 ragged m={m}: the point on centroid {j} has "
                f"membership {float(w[j])} there")
        print(f"[B6] ragged N={n} K={k} d={d} m={m}: equal to the plain "
              f"version; the point on centroid {j} has membership "
              f"{float(w[j]):.9g} there", flush=True)
    print(f"[B6] share of the tolerance used: {json.dumps(tol_shares('B6'))}",
          flush=True)
    return out


def check_twopass(name, x, c, m) -> tuple[float, float]:
    """B7 and B8 against their plain versions on the same s: two runs
    bitwise equal (B8 also without B7's ‖x‖², which it then computes to
    the same bits); s within REL_TOL relative; B8's stats as B6's.
    Returns the largest absolute errors of s and of Σμx."""
    xw, cw = lk.widened(x, c)
    s, x2 = fk.fuzzy_normalizer(x, c, m, return_x2=True)
    repeatable(f"{name} B7", (s,), (fk.fuzzy_normalizer(x, c, m),))
    want_s = fk.fuzzy_normalizer_plain(xw, cw, m)
    err7 = check_close(f"{name} B7 s", s, want_s, want_s.abs())
    got = fk.fuzzy_accumulate(x, c, s, m, x2=x2)
    repeatable(f"{name} B8", got, fk.fuzzy_accumulate(x, c, s, m))
    want = fk.fuzzy_accumulate_plain(xw, cw, s, m)
    err8 = check_close(f"{name} B8 sums", got.weighted_sums,
                       want.weighted_sums, fuzzy_abs_sums(xw, cw, m))
    check_close(f"{name} B8 weights", got.weights, want.weights,
                want.weights.abs())
    check_close(f"{name} B8 objective", got.objective, want.objective,
                want.objective.abs())
    return err7, err8


def on_centroids_share(gen, m) -> float:
    """B7 then B8 on 128 rows equal to centroids (ON_CENTROIDS): B7's s
    must hold the inv that B8 computes for a row and its own centroid, or
    the row's μ = (inv / s)^m has no bound. Each row's memberships sum to
    at most 1, so Σμ is at most N: returns (Σμ − N) / (REL_TOL·N), the
    share of that tolerance used (below 0 within N; inf if not finite)."""
    k, d = ON_CENTROIDS
    c = ((torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) * 3
         ).contiguous()
    x = torch.cat([c[:64], c[100:164]]).contiguous()
    st = fk.fuzzy_accumulate(x, c, fk.fuzzy_normalizer(x, c, m), m)
    if not bool(torch.isfinite(st.weights).all()):
        return float("inf")
    n = x.shape[0]
    return (float(st.weights.double().sum()) - n) / (REL_TOL * n)


def check_on_centroids(name, gen, m) -> None:
    share = on_centroids_share(gen, m)
    require(share <= 1, f"{name}: Σμ past N on rows on centroids "
                        f"({share} of the tolerance)")
    TOL_SHARES[name] = share


def phase_twopass_kernel(gen) -> dict:
    """Phase 3, B7 and B8: at the K-sharded route's regime (K=16,384,
    d=768, N=2^19) for each fuzzifier and on bf16 rows, the tower's
    identity on one process against B6, then the ragged shape."""
    n, k, d = SORTED_N, SORTED_K, SORTED_D
    x, c = blob_data(gen, n, k, d)
    # B8's design at this shape: at d > 128, μ once per (row, centroid)
    # into the bounded scratch, then μᵀ·X: 2 products of 2·N·K·d (the
    # distance and the accumulate), where one kernel per 128-column slice
    # would compute the distance again in each of its ⌈d/128⌉ slices.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rc, kc, grid = fk.mu_scratch_plan(n, k, d, 2 * sms)
    design = dict(
        phase2="mu_scratch" if d > fk._D_SLICE else "one_slice",
        products=2, products_before=1 + -(-d // fk._D_SLICE),
        rows_per_chunk=rc, k_per_chunk=kc, row_ranges=grid,
        scratch_bytes=4 * rc * kc, scratch_budget=fk.MU_SCRATCH_BYTES)
    print(f"[B8 design] N={n} K={k} d={d}: {json.dumps(design)}", flush=True)
    c2 = lk._sq_norms(c)
    per_m = {}
    for m in FUZZY_MS:
        err7, err8 = check_twopass(f"B7/B8 m={m}", x, c, m)
        s, x2 = fk.fuzzy_normalizer(x, c, m, return_x2=True)
        reps, plain_reps = (5, 3) if m == 2.0 else (3, 1)
        # B8's two halves timed apart: the μ kernels, then μᵀ·X and the
        # fixed-order sums (each alone on the scratch the other left).
        per_m[m] = dict(
            b7_err=err7, b8_err=err8,
            b7_ms=median_ms(lambda: fk.fuzzy_normalizer(x, c, m), reps),
            b8_ms=median_ms(
                lambda: fk.fuzzy_accumulate(x, c, s, m, x2=x2), reps),
            b8_mu_ms=median_ms(lambda: fk._accumulate_mu(
                x, c, c2, s, x2, m, 1e-9, halves=1), 3),
            b8_mux_ms=median_ms(lambda: fk._accumulate_mu(
                x, c, c2, s, x2, m, 1e-9, halves=2), 3),
            b7_plain_ms=median_ms(
                lambda: fk.fuzzy_normalizer_plain(x, c, m), plain_reps),
            b8_plain_ms=median_ms(
                lambda: fk.fuzzy_accumulate_plain(x, c, s, m), plain_reps))
        if m == 2.0:
            # The K-sharded route's per-rank shape: one K-shard of K/2
            # centroids, s over all K (as the tower sums it).
            half = c[:k // 2].contiguous()
            per_m[m].update(
                b8_k_half_ms=median_ms(
                    lambda: fk.fuzzy_accumulate(x, half, s, m, x2=x2), 3),
                b8_k_half_plain_ms=median_ms(
                    lambda: fk.fuzzy_accumulate_plain(x, half, s, m), 1))
            del half
        del s, x2
        print(f"[B7/B8] N={n} K={k} d={d} m={m}: {json.dumps(per_m[m])}",
              flush=True)
    # The tower's identity on one process: s summed over two K-shards, B8
    # on each shard with that s, concatenated, against B6 on all K.
    halves = (c[:k // 2].contiguous(), c[k // 2:].contiguous())
    s = (fk.fuzzy_normalizer(x, halves[0], 2.0)
         + fk.fuzzy_normalizer(x, halves[1], 2.0))
    per = [fk.fuzzy_accumulate(x, h, s, 2.0) for h in halves]
    whole = fk.fuzzy_stats_fused(x, c, 2.0)
    ident = check_close("tower identity sums",
                        torch.cat([p.weighted_sums for p in per]),
                        whole.weighted_sums, fuzzy_abs_sums(x, c, 2.0))
    check_close("tower identity weights",
                torch.cat([p.weights for p in per]), whole.weights,
                whole.weights.abs())
    check_close("tower identity objective",
                per[0].objective + per[1].objective, whole.objective,
                whole.objective.abs())
    print(f"[B7/B8] two K-shards on one process: Σμx within "
          f"{ident:.3g} of B6's on all K, Σμ and J_m within {REL_TOL} "
          "relative", flush=True)
    del s, per, whole, halves
    # B6 past d = 128 (⌈d/128⌉ column slices in phase 2) and at large K (a
    # chunk of few rows, phase 1's K tiles split), against its plain
    # version and beside B7 then B8 (`fuzzy_stats_twopass`, B6's design
    # before PR 11 at this d).
    rc, _, _ = fk.row_scratch_plan(n, k, fk._TC_K_TILE,
                                   -(-d // fk._D_SLICE), sms)
    wide = dict(rows_per_chunk=rc,
                k_splits=fk.phase1_k_splits(rc, k, 2 * sms),
                max_abs_err=check_fuzzy(f"B6 d={d}", x, c, 2.0),
                ms=median_ms(lambda: fk.fuzzy_stats_fused(x, c, 2.0), 3),
                twopass_ms=median_ms(
                    lambda: fk.fuzzy_stats_twopass(x, c, 2.0), 3))
    print(f"[B6] N={n} K={k} d={d} m=2.0: {json.dumps(wide)}", flush=True)
    xb = x.to(torch.bfloat16)
    del x
    bf16 = dict(zip(("b7_err", "b8_err"),
                    check_twopass("B7/B8 bf16", xb, c, 2.0)))
    s, x2 = fk.fuzzy_normalizer(xb, c, 2.0, return_x2=True)
    bf16.update(b7_ms=median_ms(lambda: fk.fuzzy_normalizer(xb, c, 2.0), 3),
                b8_ms=median_ms(
                    lambda: fk.fuzzy_accumulate(xb, c, s, 2.0, x2=x2), 3))
    print(f"[B7/B8] bf16 rows N={n} K={k} d={d} m=2.0: {json.dumps(bf16)}",
          flush=True)
    del xb, c, c2, s, x2
    # B7: the 2·N·K·d product on the tensor cores in 3xTF32 (bound_ms) or
    # on the f32 FMA pipe (bound_f32_ms); the N·K powers and the champion's
    # ‖x − c‖² (2·N·d) on the FMA pipe beside it.
    b7_bytes = 4.0 * (n * d + k * d + k + 2 * n)
    b7 = tc_bound_ms(2.0 * n * k * d, n * k + 2.0 * n * d, b7_bytes)
    b8 = bound_ms(4.0 * n * k * d, 4.0 * (n * d + 2 * k * d + 2 * k + 2 * n
                                         + 1))
    main = per_m[2.0]
    out = {
        "B7": dict(max_abs_err=main["b7_err"], ms=main["b7_ms"],
                   plain_ms=main["b7_plain_ms"], bound_ms=b7[0],
                   bound_by=b7[1],
                   bound_f32_ms=bound_ms(2.0 * n * k * d + n * k
                                         + 2.0 * n * d, b7_bytes)[0],
                   library_ms=None, m_1_7=per_m[1.7]["b7_ms"],
                   bf16_ms=bf16["b7_ms"],
                   tol_share={m: TOL_SHARES[f"B7/B8 m={m} B7 s"]
                              for m in FUZZY_MS}),
        "B8": dict(max_abs_err=main["b8_err"], ms=main["b8_ms"],
                   plain_ms=main["b8_plain_ms"], bound_ms=b8[0],
                   bound_by=b8[1], library_ms=None,
                   m_1_7=per_m[1.7]["b8_ms"], bf16_ms=bf16["b8_ms"],
                   k_half_ms=main["b8_k_half_ms"],
                   k_half_plain_ms=main["b8_k_half_plain_ms"],
                   mu_ms=main["b8_mu_ms"], mux_ms=main["b8_mux_ms"],
                   design=design),
    }

    n, k, d = FUZZY_RAGGED
    x, c = blob_data(gen, n, k, d)
    for m in FUZZY_MS:
        check_twopass(f"B7/B8 ragged m={m}", x, c, m)
    check_twopass("B7/B8 ragged bf16", x.to(torch.bfloat16), c, 2.0)
    print(f"[B7/B8] ragged N={n} K={k} d={d}: equal to the plain versions "
          "at m=2 and 1.7, f32 and bf16 rows", flush=True)
    # B7 at the route's d with few centroids: the nearest ones dominate s,
    # where the tensor core's truncating accumulation would show.
    n, k, d = SMALL_K_SHAPE
    x, c = blob_data(gen, n, k, d)
    for m in FUZZY_MS:
        check_twopass(f"B7/B8 small K m={m}", x, c, m)
    print(f"[B7/B8] N={n} K={k} d={d}: equal to the plain versions at m=2 "
          f"and 1.7", flush=True)
    for n, k, d in B7_EDGE_SHAPES:
        x, c = blob_data(gen, n, k, d)
        for m in FUZZY_MS:
            check_twopass(f"B7/B8 {n}x{k}x{d} m={m}", x, c, m)
    for m in FUZZY_MS:
        check_on_centroids(f"B7/B8 rows on centroids m={m}", gen, m)
    print(f"[B7/B8] N x K x d {B7_EDGE_SHAPES} and rows on centroids (K, "
          f"d) = {ON_CENTROIDS}: equal to the plain versions, Σμ within N; "
          f"share of the tolerance used: {json.dumps(tol_shares('B7/B8'))}",
          flush=True)
    return out


def tall_blobs(gen, n, k, d):
    """Feature-major points (d, n) around k centers, every center used
    (column j belongs to center j % k), built in column chunks."""
    centers = (torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) * 3
    xt = torch.randn((d, n), generator=gen, device="cuda")
    ct = centers.T.contiguous()
    for s in range(0, n, TALL_STEP):
        lab = torch.arange(s, min(n, s + TALL_STEP), device="cuda") % k
        xt[:, s:s + TALL_STEP] += ct[:, lab]
    return xt, centers.contiguous()


def tall_label_sums(xt, lab, k):
    """(Σx, Σ|x|) per label of f32-widened columns, summed in f64."""
    sums = torch.zeros((k, xt.shape[0]), dtype=torch.float64, device="cuda")
    abs_sums = torch.zeros_like(sums)
    for s in range(0, xt.shape[1], TALL_STEP):
        xb = xt[:, s:s + TALL_STEP].double().T
        lb = lab[s:s + TALL_STEP].long()
        sums.index_add_(0, lb, xb)
        abs_sums.index_add_(0, lb, xb.abs())
    return sums.float(), abs_sums.float()


def tall_near_ties(name, xt, c, got, want) -> int:
    """B10's labels equal the plain version's except at near-ties in its
    own metric: d² of the columns and the centroids as the kernel sees
    them (rounded to bf16 for bf16 columns), in f64 here. Near: within
    TIE_TOL of ‖x‖² + max ‖c‖². Returns the count of near-tie
    differences."""
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        cr = tk._operands(xt, c)[0].double()
        xd = xt[:, diff].double().T

        def value(lab):
            return ((xd - cr[lab[diff].long()]) ** 2).sum(1)

        scale = (xd * xd).sum(1) + (cr * cr).sum(1).max()
        far = ((value(got) - value(want)).abs() > TIE_TOL * scale).sum()
        require(int(far) == 0, f"{name}: {int(far)} labels differ from the "
                               "plain version beyond a near-tie")
    return int(diff.numel())


def check_tall_lloyd(name, xt, c) -> tuple[float, int]:
    """B10 against its plain version: two runs bitwise equal, labels equal
    except at near-ties, counts equal where the labels agree, Σx within
    REL_TOL of Σ|x| by the kernel's own labels, SSE within REL_TOL
    relative. Returns (max abs error of the sums, near-tie count)."""
    k = c.shape[0]
    got, lab = tk.lloyd_stats_tall(xt, c, return_labels=True)
    again, lab2 = tk.lloyd_stats_tall(xt, c, return_labels=True)
    repeatable(name, (*got, lab), (*again, lab2))
    want, plab = tk.lloyd_stats_tall_plain(xt, c, return_labels=True)
    ties = tall_near_ties(name, xt, c, lab, plab)

    def bincount(lab):
        return torch.bincount(lab.long(), minlength=k).to(torch.float32)

    other = lab != plab
    require(torch.equal(got.counts - want.counts,
                        bincount(lab[other]) - bincount(plab[other])),
            f"{name}: counts differ where the labels agree")
    mine, abs_sums = tall_label_sums(xt, lab, k)
    err = check_close(f"{name} sums", got.sums, mine, abs_sums)
    if not ties:
        check_close(f"{name} sums (plain)", got.sums, want.sums, abs_sums)
    check_close(f"{name} sse", got.sse, want.sse, want.sse.abs())
    return err, ties


def tall_fuzzy_abs_sums(xt, c, m):
    """Σμ|x| per cluster, the scale of B11's Σμx check (column blocks)."""
    cr, c2 = tk._operands(xt, c)
    out = torch.zeros(c.shape, dtype=torch.float64, device="cuda")
    cols = max(1, (1 << 26) // c.shape[0])
    for s in range(0, xt.shape[1], cols):
        xb = xt[:, s:s + cols].float()
        mu = tk.tall_memberships(xb, cr, c2, m)[0]
        out += mu.double() @ xb.abs().T.double()
    return out.float()


def check_tall_fuzzy(name, xt, c, m) -> float:
    """B11 against its plain version: two runs bitwise equal, Σμx within
    REL_TOL of Σμ|x|, Σμ and the objective within REL_TOL relative."""
    got = tk.fuzzy_stats_tall(xt, c, m)
    repeatable(name, got, tk.fuzzy_stats_tall(xt, c, m))
    want = tk.fuzzy_stats_tall_plain(xt, c, m)
    err = check_close(f"{name} sums", got.weighted_sums, want.weighted_sums,
                      tall_fuzzy_abs_sums(xt, c, m))
    check_close(f"{name} weights", got.weights, want.weights,
                want.weights.abs())
    check_close(f"{name} objective", got.objective, want.objective,
                want.objective.abs())
    return err


def watched(fn, what: str):
    """fn() under a watchdog: where the card has not finished its work
    HANG_S seconds later (an mbarrier wait that never completes), the run
    ends at once with a message, without waiting on the card."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > HANG_S:
            print(f"chip_smoke: {what} did not finish in {HANG_S} s",
                  file=sys.stderr, flush=True)
            os._exit(3)
        time.sleep(0.01)
    return out


def tall_lloyd_bytes(cols, k, d) -> float:
    """B10's bytes: the columns once, the centroids and c2 in, Σx, counts
    and the SSE out."""
    return cols.element_size() * cols.shape[1] * d + 4.0 * (2 * k * d
                                                             + 2 * k + 1)


def phase_tall_edges(gen) -> None:
    """Phase 3, B10's streaming form at its edges (TALL_EDGES), f32 and
    bf16 columns, each first call watched, then held to the plain
    version."""
    for n, k, d in TALL_EDGES:
        xt, c = tall_blobs(gen, n, k, d)
        for cols in (xt, xt.to(torch.bfloat16)):
            watched(lambda: tk.lloyd_stats_tall(cols, c),
                    f"B10 N={n} K={k} d={d} {cols.dtype}")
            err, ties = check_tall_lloyd(f"B10 N={n} K={k} d={d} "
                                         f"{cols.dtype}", cols, c)
            plan = tk.lloyd_plan(k, d, cols.element_size())
            print(f"[B10] edge N={n} K={k} d={d} {cols.dtype} ({plan.warps} "
                  f"warps, {plan.slots} ring slots): equal to the plain "
                  f"version (max abs err {err:.3g}, {ties} near-ties), "
                  "bitwise repeatable", flush=True)
        del xt, c


def phase_tall_kernel(gen) -> dict:
    """Phase 3, B10 and B11: B10's edges, then at the tall routes' shape
    on f32 and bf16 columns (the f32 numbers, m=2 for B11, are the JSON
    line's), B10's split and its time at K=16, d=8, B1 on the transposed
    points timed beside B10, then the small, ragged and wide cases."""
    phase_tall_edges(gen)
    n, k, d = TALL_SHAPE
    xt, c = tall_blobs(gen, n, k, d)
    b10, b11 = {}, {}
    for cols in (xt, xt.to(torch.bfloat16)):
        key = ("bf16_columns" if cols.dtype == torch.bfloat16
               else "f32_columns")
        # Operations: the 2·N·K·d distance product on the f32 pipe; B11
        # adds the 2·N·K·d of μᵀx, on the tensor cores in 3xTF32
        # (bound_ms; two TF32 passes on bf16 columns, which are exact in
        # TF32) or on the f32 pipe too (bound_f32_ms); its powers run on
        # the SFU.
        nbytes = tall_lloyd_bytes(cols, k, d)
        err, ties = check_tall_lloyd(f"B10 {key}", cols, c)
        b_ms, b_by = bound_ms(2.0 * n * k * d, nbytes)
        ms = median_ms(lambda: tk.lloyd_stats_tall(cols, c), 5)
        # The split: the stream-only path takes the columns through the
        # ring and nothing else; the rest is the arithmetic's share.
        stream_ms = median_ms(
            lambda: tk._launch_lloyd(cols, c, stream_only=True), 5)
        b10[key] = dict(
            max_abs_err=err, near_ties=ties, ms=ms,
            plain_ms=median_ms(lambda: tk.lloyd_stats_tall_plain(cols, c), 3),
            bound_ms=b_ms, bound_by=b_by, stream_ms=stream_ms,
            stream_tb_s=cols.element_size() * n * d / stream_ms / 1e9,
            plan=tk.lloyd_plan(k, d, cols.element_size())._asdict())
        print(f"[B10] N={n} K={k} d={d} {key}: {json.dumps(b10[key])}",
              flush=True)
        print(f"[B10] split {key}: stream only {stream_ms:.4f} ms "
              f"({b10[key]['stream_tb_s']:.3f} TB/s), the arithmetic "
              f"{ms - stream_ms:.4f} ms more, of {ms:.4f} ms", flush=True)
        b_ms, b_by = tc_bound_ms(2.0 * n * k * d, 2.0 * n * k * d, nbytes,
                                 passes=2 if key == "bf16_columns" else 3)
        b_f32_ms = bound_ms(4.0 * n * k * d, nbytes)[0]
        for m in FUZZY_MS:
            b11[(key, m)] = dict(
                max_abs_err=check_tall_fuzzy(f"B11 {key} m={m}", cols, c, m),
                ms=median_ms(lambda: tk.fuzzy_stats_tall(cols, c, m), 5),
                plain_ms=median_ms(
                    lambda: tk.fuzzy_stats_tall_plain(cols, c, m), 3),
                bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_f32_ms,
                tol_share=TOL_SHARES[f"B11 {key} m={m} sums"])
            print(f"[B11] N={n} K={k} d={d} {key} m={m}: "
                  f"{json.dumps(b11[(key, m)])}", flush=True)
        del cols
    print(f"[B11] before the redesign (PR 7's private form, PERF.md): "
          f"{json.dumps(B11_EARLIER)}", flush=True)
    # B1 on the same points stored sample-major: whether the layout pays
    # on this card (timed only; B1 has its own checks above).
    xs = xt.T.contiguous()
    b1_ms = median_ms(lambda: lk.lloyd_stats_fused(xs, c), 3)
    print(f"[B10] B1 on xt.T.contiguous() N={n} K={k} d={d}: {b1_ms:.4f} ms "
          f"against B10's {b10['f32_columns']['ms']:.4f} ms", flush=True)
    del xs, xt, c
    # Past the earlier private form's limit: the streaming form at K=16,
    # d=8 (timed; TALL_EDGES checks the shape at N=2^16+37).
    n8, k8, d8 = TALL_K16_D8
    xt, c = tall_blobs(gen, n8, k8, d8)
    b_ms, b_by = bound_ms(2.0 * n8 * k8 * d8, tall_lloyd_bytes(xt, k8, d8))
    wide = dict(ms=median_ms(lambda: tk.lloyd_stats_tall(xt, c), 5),
                bound_ms=b_ms, bound_by=b_by,
                plan=tk.lloyd_plan(k8, d8, 4)._asdict())
    print(f"[B10] N={n8} K={k8} d={d8} f32_columns: {json.dumps(wide)}",
          flush=True)
    del xt, c
    out_b10 = dict(**b10["f32_columns"], library_ms=None,
                   bf16_columns=b10["bf16_columns"], b1_on_transpose_ms=b1_ms,
                   k16_d8=wide)
    out_b11 = dict(**b11[("f32_columns", 2.0)], library_ms=None,
                   m_1_7=b11[("f32_columns", 1.7)],
                   bf16_columns={str(m): b11[("bf16_columns", m)]
                                 for m in FUZZY_MS})
    for n, k, d in (TALL_SMALL, FUZZY_RAGGED, TALL_WIDE):
        xt, c = tall_blobs(gen, n, k, d)
        for cols in (xt, xt.to(torch.bfloat16)):
            err, ties = check_tall_lloyd(f"B10 N={n} {cols.dtype}", cols, c)
            errs = [check_tall_fuzzy(f"B11 N={n} {cols.dtype} m={m}", cols,
                                     c, m) for m in FUZZY_MS]
            print(f"[B10] [B11] N={n} K={k} d={d} {cols.dtype}: equal to the "
                  f"plain versions (B10 max abs err {err:.3g}, {ties} "
                  f"near-ties; B11 {max(errs):.3g}), bitwise repeatable",
                  flush=True)
        del xt, c
    return {"B10": out_b10, "B11": out_b11}


def phase_tall_ties(gen) -> None:
    """Phase 3, tall ties: copies of centroid 3 (at 5, 9 and 14 for K=15,
    B10's streaming form, across its groups of 4 centroids; at 5, 67, 200
    and K-1 for K=300, the tile form). In B10 every tie goes to the smallest index: labels equal the
    plain version's, no label lands on a copy, the copies take 0 columns
    and 0 sums. In B11 a copy takes the same Σμx and Σμ as centroid 3,
    bitwise."""
    for k, d, copies in ((TALL_SHAPE[1], TALL_SHAPE[2], [5, 9, 14]),
                         (FUZZY_RAGGED[1], FUZZY_RAGGED[2],
                          [5, 67, 200, FUZZY_RAGGED[1] - 1])):
        xt, c = tall_blobs(gen, TIE_N, k, d)
        c[copies] = c[3].clone()
        for cols in (xt, xt.to(torch.bfloat16)):
            got, lab = tk.lloyd_stats_tall(cols, c, return_labels=True)
            plab = tk.lloyd_stats_tall_plain(cols, c, return_labels=True)[1]
            require(torch.equal(lab, plab),
                    f"tall ties (K={k}): B10 labels differ from the plain "
                    "version's")
            require(not bool(torch.isin(lab, torch.tensor(
                copies, device="cuda")).any())
                and not bool(got.counts[copies].any())
                and not bool(got.sums[copies].any()),
                f"tall ties (K={k}): a copy took columns in B10")
            f = tk.fuzzy_stats_tall(cols, c, 2.0)
            require(all(torch.equal(f.weights[j], f.weights[3])
                        and torch.equal(f.weighted_sums[j],
                                        f.weighted_sums[3])
                        for j in copies),
                    f"tall ties (K={k}): B11 copies took other mass")
        print(f"[ties] tall N={TIE_N} K={k} d={d}: copies {copies} of "
              "centroid 3 took 0 columns in B10 (f32 and bf16 columns) and "
              "the same mass as centroid 3 in B11", flush=True)


WRAPPERS = {"B1": lk.lloyd_stats_fused, "B2": lk.distance_argmin,
            "B3": ss.segment_sums, "B4": lk.lloyd_stats_fused_weighted,
            "B5": lk.lloyd_stats_fused_bf16, "B6": fk.fuzzy_stats_fused,
            "B7": fk.fuzzy_normalizer, "B8": fk.fuzzy_accumulate,
            "B9": gk.gmm_stats_fused, "B10": tk.lloyd_stats_tall,
            "B11": tk.fuzzy_stats_tall, "B12": ss.gathered_segment_sums}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {key: fn.launches for key, fn in WRAPPERS.items()}


def require_launches(name, seen, **want) -> None:
    """Each kernel in `want` launched exactly that often, every other
    kernel never."""
    expect = {key: want.get(key, 0) for key in WRAPPERS}
    require(seen == expect, f"{name} launches {seen}, expected {expect}")


def run_cli(args, tmp, name) -> tuple[dict, dict]:
    """Run the port's CLI with counts reset just before; returns (CSV row,
    launch counts read just after). The row's cost column must be finite,
    and nonnegative where it is an SSE or objective (a gaussianMixture
    row's is the mean log-likelihood)."""
    log = os.path.join(tmp, f"{name}.csv")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main([*args, f"--log_file={log}"])
    seen = counts()
    require(rc == 0, f"{name}: CLI exited {rc}")
    with open(log, newline="") as f:
        row = list(csv.DictReader(f))[-1]
    print(f"[{name}] {time.perf_counter() - t0:.1f} s, launches {seen}, "
          f"row {json.dumps(row)}", flush=True)
    require(row["status"] == "ok" and row["backend"] == "cuda",
            f"{name}: row {row}")
    cost = float(row["sse"])
    require(math.isfinite(cost) and (
        cost >= 0.0 or row["method_name"] == "gaussianMixture"),
        f"{name}: cost column {cost}")
    return row, seen


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_one_rank_nccl(gen) -> None:
    """NCCL at world size 1: a process group of one rank, so every
    all_reduce and broadcast of the mesh paths runs through NCCL. The
    data-parallel fused fit and the K-sharded fuzzy fit on a 1x1 grid
    against the same fits without a mesh (B1 both; B7 + B8 against B6),
    from the same init: n_iter equal, centroids within 1e-4."""
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        n, k, d = B1_SHAPE
        x, c = blob_data(gen, n, k, d)
        init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
        reset_counts()
        a = kmeans_fit(x, k, init=init, mesh=make_mesh(1), kernel="pallas",
                       max_iters=10, tol=-1)
        require_launches("nccl kmeans", counts(), B1=a.n_iter + 1)
        b = kmeans_fit(x, k, init=init, kernel="pallas", max_iters=10,
                       tol=-1)
        cerr = (a.centroids - b.centroids).abs().max().item()
        require(a.n_iter == b.n_iter and cerr <= 1e-4,
                f"nccl kmeans: n_iter {a.n_iter} vs {b.n_iter}, centroids "
                f"differ by {cerr}")
        print(f"[nccl_1] kmeans_fit(mesh=make_mesh(1)) N={n} K={k} d={d}: "
              f"n_iter {a.n_iter} == {b.n_iter}, max centroid diff "
              f"{cerr:.3g}, sse {float(a.sse):.8g} vs {float(b.sse):.8g}",
              flush=True)
        del x, c, init, a, b
        n, k, d = SORTED_N, SORTED_K, SORTED_D
        x, c = blob_data(gen, n, k, d)
        init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
        reset_counts()
        a = fuzzy_fit_sharded(x, k, make_mesh_2d(1, 1), init=init,
                              max_iters=3, tol=-1, kernel="pallas")
        require_launches("nccl fuzzy_fit_sharded", counts(),
                         B7=a.n_iter + 1, B8=a.n_iter + 1)
        b = fuzzy_cmeans_fit(x, k, init=init, max_iters=3, tol=-1,
                             kernel="pallas")
        cerr = (a.centroids - b.centroids).abs().max().item()
        require(a.n_iter == b.n_iter and cerr <= 1e-4,
                f"nccl fuzzy_fit_sharded: n_iter {a.n_iter} vs {b.n_iter}, "
                f"centroids differ by {cerr}")
        print(f"[nccl_1] fuzzy_fit_sharded(make_mesh_2d(1, 1)) N={n} K={k} "
              f"d={d}: n_iter {a.n_iter} == {b.n_iter} (B6 fit), max "
              f"centroid diff {cerr:.3g}, objective "
              f"{float(a.objective):.8g} vs {float(b.objective):.8g}",
              flush=True)
    finally:
        dist.destroy_process_group()


def _rank_env(rank, world, port) -> None:
    """The environment torchrun gives a rank."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


# The fits of tdc_tpu_torch.models whose results a CLI rank sends back.
RANK_FITS = ("streamed_kmeans_fit", "streamed_fuzzy_fit", "kmeans_fit",
             "streamed_gmm_fit", "gmm_fit")


def _rank_cli(rank, world, port, args, queue) -> None:
    """One rank of a multi-GPU CLI run, launched as torchrun would: the
    CLI joins the process group from the environment. Sends back (rank,
    exit code, (launch counts, the computation fit's centroids or means
    as numpy and its comms tuple, or None for both)) or (rank, -1, the
    traceback)."""
    _rank_env(rank, world, port)
    try:
        reset_counts()
        with Captured(*RANK_FITS) as cap:
            rc = cli.main(args)
        seen = counts()
        fit = next((cap.last[n] for n in RANK_FITS if n in cap.last), None)
        # numpy, not a tensor: torch would share a CPU tensor's storage
        # by file descriptor, gone once the rank exits.
        c = (None if fit is None else getattr(
            fit, "means", getattr(fit, "centroids", None)).cpu().numpy())
        comms = None if fit is None or fit.comms is None else tuple(
            fit.comms)
        queue.put((rank, rc, (seen, c, comms)))
    except BaseException:
        queue.put((rank, -1, traceback.format_exc()))


def sharded_kmeans_init(x) -> torch.Tensor:
    """The K-sharded K-Means route's init: --init=random on the first
    65,536 rows, a generator seeded with 0, as the K-sharded fuzzy route
    draws it."""
    return _resolve_init_sharded(
        x, SORTED_K, "random", torch.Generator(device="cuda").manual_seed(0))


def _rank_kmeans_sharded(rank, world, port, args, queue) -> None:
    """One rank of the K-sharded K-Means route: kmeans_fit_sharded on a
    (1, world) grid, every rank making the same points and init. Sends
    back (rank, 0, {launches, n_iter, sse, seconds, centroids on rank 0})
    or (rank, -1, the traceback)."""
    _rank_env(rank, world, port)
    try:
        multihost.initialize_from_env()
        try:
            x, _ = make_blobs(1, SORTED_N, SORTED_D, SORTED_K, device="cuda")
            init = sharded_kmeans_init(x)
            mesh = make_mesh_2d(1, world)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = kmeans_fit_sharded(x, SORTED_K, mesh, init=init,
                                     max_iters=SORTED_ITERS, tol=-1,
                                     kernel="pallas")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            # numpy, not a tensor: torch would share a CPU tensor's
            # storage by file descriptor, gone once the rank exits.
            out = dict(launches=counts(), n_iter=res.n_iter,
                       sse=float(res.sse), seconds=seconds,
                       centroids=(res.centroids.cpu().numpy() if rank == 0
                                  else None))
        finally:
            multihost.shutdown()
        queue.put((rank, 0, out))
    except BaseException:
        queue.put((rank, -1, traceback.format_exc()))


def spawn_ranks(target, args, name, world=RANKS) -> list:
    """`target(rank, world, port, args, queue)` on `world` spawned ranks;
    returns each rank's result. Every rank must send (rank, 0, result)."""
    # The ranks share the card with this process: hand its allocator's
    # cached blocks back first.
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while len(got) < world:  # drain before joining
            try:
                rank, rc, result = queue.get(timeout=5)
                got[rank] = (rc, result)
            except queue_lib.Empty:
                # A rank that died without a word ends the run now, not
                # at the time limit.
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                require(not dead and time.monotonic() < deadline,
                        f"{name}: ranks {dead} exited without a result "
                        f"(exit codes {[p.exitcode for p in procs]}), or "
                        f"{RANK_TIMEOUT} s passed")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(world):
        rc, result = got[rank]
        require(rc == 0, f"{name}: rank {rank} exited {rc}: {result}")
    return [got[r][1] for r in range(world)]


def run_ranks(args, tmp, name) -> tuple[dict, list, list]:
    """The CLI on RANKS spawned ranks, counts reset in each just before;
    returns (rank 0's CSV row, each rank's launch counts, each rank's
    (centroids or means, comms) of its computation fit). Every rank must
    exit 0 and the log must hold one row: rank 0's."""
    log = os.path.join(tmp, f"{name}.csv")
    t0 = time.perf_counter()
    got = spawn_ranks(_rank_cli, [*args, f"--log_file={log}"], name)
    seen = [g[0] for g in got]
    with open(log, newline="") as f:
        rows = list(csv.DictReader(f))
    require(len(rows) == 1, f"{name}: {len(rows)} rows, expected rank 0's")
    row = rows[0]
    print(f"[{name}] {time.perf_counter() - t0:.1f} s on {RANKS} ranks, "
          f"launches {seen}, row {json.dumps(row)}", flush=True)
    require(row["status"] == "ok" and row["backend"] == "cuda"
            and row["num_GPUs"] == str(RANKS), f"{name}: row {row}")
    require(math.isfinite(float(row["sse"])) and (
        float(row["sse"]) >= 0.0 or row["method_name"] == "gaussianMixture"),
        f"{name}: cost column {row['sse']}")
    return row, seen, [g[1:] for g in got]


def phase_fused_gather_step() -> int:
    """SORTED_ITERS Lloyd iterations at the sorted route's shape from its
    --init=random draws, twice: B2, then sorted_cluster_stats(pallas=True,
    fuse_gather=True) (B12), and B2, then sorted_cluster_stats(pallas=True)
    (B3). The centroids must be bitwise equal after every iteration.
    Returns B12's launches."""
    n, k, d = SORTED_N, SORTED_K, SORTED_D
    x, _ = make_blobs(1, n, d, k, device="cuda")
    c0 = init_random(torch.Generator(device="cuda").manual_seed(0), x, k)
    trails, seen = {}, {}
    for fuse in (True, False):
        c, trail = c0, []
        reset_counts()
        for _ in range(SORTED_ITERS):
            labels = lk.distance_argmin(x, c)[0]
            sums, cnt = ss.sorted_cluster_stats(x, labels, k, pallas=True,
                                                fuse_gather=fuse)
            c = apply_centroid_update(
                SufficientStats(sums=sums, counts=cnt, sse=None), c)
            trail.append(c)
        seen[fuse] = counts()
        trails[fuse] = trail
    require_launches("fused-gather step", seen[True], B2=SORTED_ITERS,
                     B12=SORTED_ITERS)
    require_launches("unfused step", seen[False], B2=SORTED_ITERS,
                     B3=SORTED_ITERS)
    for i, (a, b) in enumerate(zip(trails[True], trails[False])):
        require(torch.equal(a, b), f"fused-gather step: centroids differ "
                                   f"from the B3 step's after iteration {i}")
    print(f"[fused_gather_step] N={n} K={k} d={d}: {SORTED_ITERS} iterations "
          f"on B2 + B12 and on B2 + B3, centroids bitwise equal after each; "
          f"launches {seen[True]} and {seen[False]}", flush=True)
    return seen[True]["B12"]


def phase_sharded_kmeans() -> None:
    """The K-sharded K-Means route: kmeans_fit_sharded(kernel="pallas") on
    a (1, 2) grid, two ranks on the one card, at the sorted route's shape:
    B2 and B3 launch n_iter + 1 times on each rank and nothing else; n_iter
    and the SSE (within REL_TOL relative) as the same fit in this process
    on a 1x1 grid; centroids within 1e-4 of the one-GPU sorted route,
    kmeans_fit(kernel="pallas"), from the same init."""
    name = "sharded_kmeans_route"
    ranks = spawn_ranks(_rank_kmeans_sharded, None, name)
    n_iter = ranks[0]["n_iter"]
    require(n_iter == SORTED_ITERS, f"{name} ran {n_iter} iterations")
    for rank, r in enumerate(ranks):
        require_launches(f"{name}, rank {rank}", r["launches"],
                         B2=n_iter + 1, B3=n_iter + 1)
        require(r["n_iter"] == n_iter and r["sse"] == ranks[0]["sse"],
                f"{name}: rank {rank} reports n_iter {r['n_iter']}, sse "
                f"{r['sse']}; rank 0 {n_iter}, {ranks[0]['sse']}")
    seconds = max(r["seconds"] for r in ranks)
    print(f"[{name}] N={SORTED_N} K={SORTED_K} d={SORTED_D} on a (1, "
          f"{RANKS}) grid: computation time {seconds:.6f} s for {n_iter} "
          f"iterations, {SORTED_N * n_iter / seconds:.1f} pt·iter/s per "
          f"chip, sse {ranks[0]['sse']!r}, launches "
          f"{[r['launches'] for r in ranks]}", flush=True)
    x, _ = make_blobs(1, SORTED_N, SORTED_D, SORTED_K, device="cuda")
    init = sharded_kmeans_init(x)
    one = kmeans_fit_sharded(x, SORTED_K, make_mesh_2d(1, 1), init=init,
                             max_iters=SORTED_ITERS, tol=-1, kernel="pallas")
    rel = abs(ranks[0]["sse"] - float(one.sse)) / abs(float(one.sse))
    require(one.n_iter == n_iter and rel <= REL_TOL,
            f"{name}: n_iter {n_iter} vs {one.n_iter} on a 1x1 grid, sse "
            f"{ranks[0]['sse']} vs {float(one.sse)}")
    del one
    fit = kmeans_fit(x, SORTED_K, init=init, max_iters=SORTED_ITERS, tol=-1,
                     kernel="pallas")
    cerr = float(np.abs(ranks[0]["centroids"]
                        - fit.centroids.cpu().numpy()).max())
    require(fit.n_iter == n_iter and cerr <= 1e-4,
            f"{name}: n_iter {n_iter} vs {fit.n_iter} on one GPU, centroids "
            f"differ by {cerr}")
    print(f"[{name}] against one process on a 1x1 grid: n_iter {n_iter}, "
          f"sse rel {rel:.3g}; against kmeans_fit on one GPU: max centroid "
          f"diff {cerr:.3g}, sse {float(fit.sse):.8g}", flush=True)


class Captured:
    """While active, records the result of each call of the named fits
    of `tdc_tpu_torch.models`, which the CLI calls: the last one of each
    is the computation fit's."""

    def __init__(self, *names):
        import tdc_tpu_torch.models as tmodels

        self.mod, self.names, self.real, self.last = tmodels, names, {}, {}

    def __enter__(self):
        for name in self.names:
            real = self.real[name] = getattr(self.mod, name)

            def wrapped(*a, _real=real, _name=name, **kw):
                out = _real(*a, **kw)
                self.last[_name] = out
                return out

            setattr(self.mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.mod, name, real)


def run_cli_captured(args, tmp, name, *fits) -> tuple[dict, dict, dict]:
    """run_cli, also returning the computation fit's result of each of
    `fits` (names in tdc_tpu_torch.models)."""
    with Captured(*fits) as cap:
        row, seen = run_cli(args, tmp, name)
    return row, seen, cap.last


def stream_points(n, d, k) -> np.ndarray:
    """The CLI's synthetic points at --seed=0 (make_blobs(seed + 1)), on
    the host."""
    x, _ = make_blobs(1, n, d, k, device="cuda")
    host = x.cpu().numpy()
    del x
    return host


def check_centroids(name, a, b, tol=1e-4) -> float:
    err = (a.cpu() - b.cpu()).abs().max().item()
    require(err <= tol, f"{name}: centroids differ by {err} (tolerance "
                        f"{tol})")
    return err


def pass_split(host, rows, c) -> dict:
    """One pass over the streamed batches split in two: each batch's copy
    to the card alone (the host's clock; the copy is synchronous), and B1
    on it alone (CUDA events), with `c` the fit's centroids; one batch on
    the card at a time, as in the fit. Launches here are not the main
    path's."""
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.data.spill import device_rows

    copy_s = kernel_ms = 0.0
    for b in NpzStream(host, rows)():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xb = device_rows(b, b.shape[0], "cuda")
        torch.cuda.synchronize()
        copy_s += time.perf_counter() - t0
        kernel_ms += median_ms(lambda: lk.lloyd_stats_fused(xb, c), 3)
        del xb
    return dict(copy_s=copy_s, kernel_ms=kernel_ms,
                copy_gb_s=host.nbytes / copy_s / 1e9)


def label_flips(x, a, b, chunk=1 << 20) -> tuple[int, float]:
    """Rows of `x` whose nearest centroid (plain f32) differs between the
    centroid sets `a` and `b`, and among them the largest gap between
    their two labels' squared distances under `a`, as a share of
    ‖x‖² + ‖c‖² (the share TIE_TOL bounds for a kernel's own ties)."""
    flips, worst = 0, 0.0
    for s in range(0, x.shape[0], chunk):
        xb = x[s:s + chunk]
        la = torch.cdist(xb, a).argmin(1)
        lb = torch.cdist(xb, b).argmin(1)
        diff = la != lb
        if not bool(diff.any()):
            continue
        xd = xb[diff]
        da = ((xd - a[la[diff]]) ** 2).sum(1)
        db = ((xd - a[lb[diff]]) ** 2).sum(1)
        scale = (xd ** 2).sum(1) + (a[la[diff]] ** 2).sum(1)
        flips += int(diff.sum())
        worst = max(worst, float(((db - da).abs() / scale).max()))
    return flips, worst


def stream_line(name, row, res, split=None) -> str:
    comp = float(row["computation_time"])
    passes = res.comms.passes
    out = (f"[{name}] computation_time {comp} s, "
           f"{row['points_per_sec_per_chip']} pt·iter/s, {passes} passes "
           f"of {row['num_batches']} batches: {comp / passes:.4f} s a pass")
    if split is not None:
        out += (f"; copies alone {split['copy_s']:.4f} s a pass "
                f"({split['copy_gb_s']:.2f} GB/s, "
                f"{split['copy_s'] / (comp / passes):.1%} of the pass), "
                f"kernel alone {split['kernel_ms']:.3f} ms a pass")
    return out


def relocate_data():
    """[dp_relocate]'s points (B1's shape) and seeds: blobs from a
    generator seeded with RELOCATE_SEED, the first RELOCATE_EMPTY seeds
    parked at 1000 + i, far from every point."""
    n, k, d = B1_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(RELOCATE_SEED)
    x, c = blob_data(gen, n, k, d)
    init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
    init[:RELOCATE_EMPTY] = 1000.0 + torch.arange(
        RELOCATE_EMPTY, device="cuda", dtype=torch.float32)[:, None]
    return x, init


def _relocate_fits(x, init, mesh) -> dict:
    """kmeans_fit with relocation after 1 and RELOCATE_ITERS steps on
    the kernel route; each fit's launches counted from 0."""
    out = {}
    for iters in (1, RELOCATE_ITERS):
        reset_counts()
        res = kmeans_fit(x, B1_SHAPE[1], init=init, mesh=mesh,
                         kernel="pallas", max_iters=iters, tol=-1,
                         empty_policy="relocate")
        out[iters] = dict(launches=counts(), n_iter=res.n_iter,
                          sse=float(res.sse),
                          centroids=res.centroids.cpu().numpy())
    return out


def _rank_relocate(rank, world, port, args, queue) -> None:
    """One rank of [dp_relocate]: the same points and seeds on every
    rank, a mesh of `world` ranks. Sends back (rank, 0, _relocate_fits)
    or (rank, -1, the traceback)."""
    _rank_env(rank, world, port)
    try:
        multihost.initialize_from_env()
        try:
            x, init = relocate_data()
            out = _relocate_fits(x, init, make_mesh(world))
        finally:
            multihost.shutdown()
        queue.put((rank, 0, out))
    except BaseException:
        queue.put((rank, -1, traceback.format_exc()))


def _rank_hier(rank, world, port, args, queue) -> None:
    """One rank of [hier]: streamed K-Means on the stream_dp points (every
    rank the same host array, first_k seeds) on a flat mesh and on a
    (2, 2) hierarchical one (n_hosts=2), per_batch for one step and
    per_pass:int8 (and per_pass, flat) for Q_ITERS from k-means++ seeds.
    Sends back (rank, 0,
    {(mesh, reduce): launches, n_iter, sse, centroids, comms})."""
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.models import streamed_kmeans_fit
    from tdc_tpu_torch.parallel.mesh import make_hierarchical_mesh

    _rank_env(rank, world, port)
    try:
        multihost.initialize_from_env()
        try:
            n, d, k = (1 << 22) + 3, 128, 1024
            host = stream_points(n, d, k)
            meshes = {"flat": make_mesh(world),
                      "hier": make_hierarchical_mesh(2)}
            out = {}
            for mesh_name, reduce, iters in (
                    ("flat", "per_batch", 1), ("hier", "per_batch", 1),
                    ("flat", "per_pass", Q_ITERS),
                    ("flat", "per_pass:int8", Q_ITERS),
                    ("hier", "per_pass:int8", Q_ITERS)):
                # One step from first_k; Q_ITERS from k-means++ (rank
                # 0's draw on the first batch, the same in every fit).
                init = (host[:k].copy() if iters == 1 else "kmeans++")
                reset_counts()
                res = streamed_kmeans_fit(
                    NpzStream(host, -(-n // 4)), k, d, init=init,
                    generator=torch.Generator(device="cuda").manual_seed(0),
                    mesh=meshes[mesh_name], kernel="pallas", reduce=reduce,
                    max_iters=iters, tol=-1)
                out[mesh_name, reduce] = dict(
                    launches=counts(), n_iter=res.n_iter,
                    sse=float(res.sse), comms=tuple(res.comms),
                    centroids=res.centroids.cpu().numpy())
        finally:
            multihost.shutdown()
        queue.put((rank, 0, out))
    except BaseException:
        queue.put((rank, -1, traceback.format_exc()))


def phase_dp_rest(tmp, card) -> None:
    """[dp_gmm_route], [dp_relocate], [stream_dp_q] and [hier] (see the
    constants above DP_GMM_N)."""
    # [dp_gmm_route]: the CLI on two ranks against one GPU, both on the
    # torch E-step (no kernel may launch).
    one, seen, fits = run_cli_captured(DP_GMM_ARGS, tmp, "dp_gmm_one",
                                       "gmm_fit")
    require_launches("dp_gmm_one", seen)
    one_means = fits["gmm_fit"].means.cpu()
    row, seen, got = run_ranks([*DP_GMM_ARGS, f"--n_GPUs={RANKS}"], tmp,
                               "dp_gmm_route")
    for rank, per_rank in enumerate(seen):
        require_launches(f"dp_gmm_route, rank {rank}", per_rank)
    for rank in range(1, RANKS):
        require(np.array_equal(got[rank][0], got[0][0]),
                f"dp_gmm_route: rank {rank}'s means differ from rank 0's")
    rel = abs(float(row["sse"]) - float(one["sse"])) / abs(float(one["sse"]))
    require(row["n_iter"] == one["n_iter"] and rel <= REL_TOL,
            f"dp_gmm_route: n_iter {row['n_iter']}, log-likelihood "
            f"{row['sse']} vs one GPU's {one['n_iter']}, {one['sse']}")
    # Ten EM steps at K=1024 carry the f32 order of the sums (one GPU's
    # against two ranks') forward through every component's mean
    # (sx / nk): the means are held within REL_TOL * 10 of their scale
    # (on an NVIDIA H100 80GB HBM3 at 700 W they were 3.09e-4 apart at a
    # scale of 4.5, the log-likelihood 7.6e-8 apart; PERF.md).
    scale = float(one_means.abs().max())
    diff = (torch.from_numpy(got[0][0]) - one_means).abs()
    worst = int(diff.max(dim=1).values.argmax())
    err = check_centroids("dp_gmm_route", torch.from_numpy(got[0][0]),
                          one_means, 10 * REL_TOL * scale)
    w1 = float(fits["gmm_fit"].weights[worst])
    print(f"[dp_gmm_route] N={DP_GMM_N} (cut from {B1_SHAPE[0]}) "
          f"K={B1_SHAPE[1]} d={B1_SHAPE[2]} diag, --kernel=xla on {RANKS} "
          f"ranks against one GPU: n_iter {row['n_iter']} == "
          f"{one['n_iter']}, log-likelihood {row['sse']} vs {one['sse']} "
          f"(rel {rel:.3g}), max mean diff {err:.3g} (scale {scale:.3g}; "
          f"at component {worst}, weight {w1:.3g} against 1/K = "
          f"{1 / B1_SHAPE[1]:.3g}); computation_time "
          f"{row['computation_time']} s (one GPU {one['computation_time']} "
          f"s); {card}", flush=True)
    # [dp_relocate]: two ranks against one GPU, the same seeds.
    t0 = time.perf_counter()
    ranks = spawn_ranks(_rank_relocate, None, "dp_relocate")
    rank_s = time.perf_counter() - t0
    x, init = relocate_data()
    t0 = time.perf_counter()
    mine = _relocate_fits(x, init, None)
    one_s = time.perf_counter() - t0
    del x, init
    for iters in (1, RELOCATE_ITERS):
        a, b = ranks[0][iters], mine[iters]
        for rank, r in enumerate(ranks):
            require_launches(f"dp_relocate {iters}, rank {rank}",
                             r[iters]["launches"], B1=r[iters]["n_iter"] + 1)
            require(np.array_equal(r[iters]["centroids"], a["centroids"]),
                    f"dp_relocate: rank {rank}'s centroids differ from "
                    "rank 0's")
        rel = abs(a["sse"] - b["sse"]) / b["sse"]
        require(a["n_iter"] == b["n_iter"] == iters and rel <= REL_TOL,
                f"dp_relocate {iters}: n_iter {a['n_iter']}, sse "
                f"{a['sse']} vs one GPU's {b['n_iter']}, {b['sse']}")
        # After the first step a relocated seed sits on a blob's outlier
        # beside the blob's own centroid, and the boundary between them
        # cuts the blob: later steps flip near-tie rows between the ranks'
        # sum order and one GPU's (a flip moves a centroid by its row over
        # the cluster's count), so only the first step is held to 1e-4.
        err = check_centroids(f"dp_relocate {iters}",
                              torch.from_numpy(a["centroids"]),
                              torch.from_numpy(b["centroids"]),
                              1e-4 if iters == 1 else Q_CENTROID_TOL)
        parked = a["centroids"][:RELOCATE_EMPTY]
        require(float(np.abs(parked).max()) < 100.0,
                f"dp_relocate {iters}: a parked seed was not relocated")
        if iters == 1:
            # The relocated centroids are data rows: the same rows, bits
            # and all, as one GPU's top_k order picks.
            require(np.array_equal(parked, b["centroids"][:RELOCATE_EMPTY]),
                    "dp_relocate: the relocated rows differ from one GPU's")
        print(f"[dp_relocate] kmeans_fit(mesh, empty_policy='relocate', "
              f"kernel='pallas') N={B1_SHAPE[0]} K={B1_SHAPE[1]} "
              f"d={B1_SHAPE[2]}, {RELOCATE_EMPTY} seeds parked, {iters} "
              f"step(s) on {RANKS} ranks: launches "
              f"{[r[iters]['launches']['B1'] for r in ranks]} B1 each, "
              f"n_iter {a['n_iter']}, sse {a['sse']:.8g} vs one GPU's "
              f"{b['sse']:.8g} (rel {rel:.3g}), max centroid diff "
              f"{err:.3g}", flush=True)
    print(f"[dp_relocate] {rank_s:.1f} s for the {RANKS} ranks' fits "
          f"(spawn and points included), {one_s:.1f} s one GPU's", flush=True)
    # [stream_dp_q]: the quantized per-pass reduces on two ranks, K-Means
    # (B1) and Fuzzy C-Means (B6, m=2).
    q_args = [*[a for a in STREAM_DP_ARGS[1:] if not a.startswith(
        ("--n_max_iters", "--init"))], f"--n_max_iters={Q_ITERS}",
        "--init=kmeans++", f"--n_GPUs={RANKS}"]
    for method, flags, key, reduces in (
            ("kmeans", ["--method_name=distributedKMeans"], "B1",
             ("per_pass", "per_pass:bf16", "per_pass:int8")),
            ("fuzzy", ["--method_name=distributedFuzzyCMeans",
                       "--fuzzifier=2.0"], "B6",
             ("per_pass", "per_pass:int8"))):
        runs = {}
        for reduce in reduces:
            name = f"stream_dp_q_{method}_{reduce.replace(':', '_')}"
            row, seen, got = run_ranks([*flags, *q_args,
                                        f"--reduce={reduce}"], tmp, name)
            comms = got[0][1]
            for rank, per_rank in enumerate(seen):
                require_launches(f"{name}, rank {rank}", per_rank,
                                 **{key: 2 * 4 * comms[3]})
                require(np.array_equal(got[rank][0], got[0][0]),
                        f"{name}: rank {rank}'s centroids differ from rank "
                        "0's")
            require(comms[0] == reduce and int(row["n_iter"]) == Q_ITERS,
                    f"{name}: strategy {comms[0]}, n_iter {row['n_iter']}")
            runs[reduce] = (row, got[0][0], comms, seen[0][key])
        f32_row, f32_c, f32_comms, _ = runs["per_pass"]
        for reduce in reduces[1:]:
            row, c, comms, launches = runs[reduce]
            rel = abs(float(row["sse"]) - float(f32_row["sse"])) / float(
                f32_row["sse"])
            moved = np.abs(c - f32_c).max(axis=1)
            require(rel <= Q_SSE_TOL and comms[2] < f32_comms[2],
                    f"stream_dp_q {method} {reduce}: cost rel {rel}, "
                    f"logical bytes {comms[2]} vs per_pass {f32_comms[2]}")
            print(f"[stream_dp_q] {method} {reduce} on {RANKS} ranks, "
                  f"{Q_ITERS} steps: cost {row['sse']} vs per_pass "
                  f"{f32_row['sse']} (rel {rel:.3g}, tolerance {Q_SSE_TOL}),"
                  f" max centroid diff {moved.max():.3g}, "
                  f"{int((moved > Q_CENTROID_TOL).sum())} of {len(moved)} "
                  f"centroids past {Q_CENTROID_TOL}; comms {comms[1]} "
                  f"reduces, {comms[2]} logical bytes vs per_pass "
                  f"{f32_comms[1]}, {f32_comms[2]} "
                  f"({comms[2] / f32_comms[2]:.3f}x); {key} {launches} a "
                  f"rank; computation_time {row['computation_time']} s vs "
                  f"{f32_row['computation_time']} s", flush=True)
    # [hier]: four ranks as a (2, 2) mesh against four flat ranks.
    t0 = time.perf_counter()
    ranks = spawn_ranks(_rank_hier, None, "hier", world=HIER_RANKS)
    hier_s = time.perf_counter() - t0
    res = ranks[0]
    for key in res:
        for rank, r in enumerate(ranks):
            require(np.array_equal(r[key]["centroids"], res[key]["centroids"])
                    and r[key]["sse"] == res[key]["sse"],
                    f"hier {key}: rank {rank}'s centroids or sse differ from "
                    "rank 0's")
            require_launches(f"hier {key}, rank {rank}", r[key]["launches"],
                             B1=4 * r[key]["comms"][3])
    a, b = res["hier", "per_batch"], res["flat", "per_batch"]
    rel = abs(a["sse"] - b["sse"]) / b["sse"]
    require(a["n_iter"] == b["n_iter"] and rel <= REL_TOL,
            f"hier per_batch: n_iter {a['n_iter']}, sse {a['sse']} vs flat "
            f"{b['n_iter']}, {b['sse']}")
    err = check_centroids("hier per_batch", torch.from_numpy(a["centroids"]),
                          torch.from_numpy(b["centroids"]))
    require(a["comms"][1] == 2 * b["comms"][1],
            f"hier per_batch: {a['comms'][1]} reduces vs flat "
            f"{b['comms'][1]} (two stages each)")
    print(f"[hier] per_batch, one step, {HIER_RANKS} ranks as (2, 2) vs "
          f"flat: n_iter {a['n_iter']}, sse {a['sse']:.8g} vs "
          f"{b['sse']:.8g} (rel {rel:.3g}), max centroid diff {err:.3g}; "
          f"comms {a['comms']} vs {b['comms']}; every rank's centroids "
          f"bitwise equal", flush=True)
    f32 = res["flat", "per_pass"]
    for mesh_name in ("flat", "hier"):
        q = res[mesh_name, "per_pass:int8"]
        refs = [("flat per_pass", f32)]
        if mesh_name == "hier":
            refs.append(("flat per_pass:int8", res["flat", "per_pass:int8"]))
        for ref_name, ref in refs:
            rel = abs(q["sse"] - ref["sse"]) / ref["sse"]
            moved = np.abs(q["centroids"] - ref["centroids"]).max(axis=1)
            require(q["n_iter"] == Q_ITERS and rel <= Q_SSE_TOL,
                    f"hier {mesh_name} int8 vs {ref_name}: sse rel {rel}")
            print(f"[hier] {mesh_name} per_pass:int8, {Q_ITERS} steps, "
                  f"against {ref_name}: sse {q['sse']:.8g} vs "
                  f"{ref['sse']:.8g} (rel {rel:.3g}), max centroid diff "
                  f"{moved.max():.3g}, {int((moved > Q_CENTROID_TOL).sum())}"
                  f" of {len(moved)} centroids past {Q_CENTROID_TOL}; comms "
                  f"{q['comms']}", flush=True)
    print(f"[hier] {hier_s:.1f} s for the {HIER_RANKS} ranks' five fits "
          f"(spawn and points included); {card}", flush=True)


def _oom_child(npy, log, fraction, queue) -> None:
    """The [oom] child: its allocator capped below the points' bytes, the
    CLI's in-memory fit (--num_batches=1) on the stream route's points,
    then the streamed fit at the count the CLI chose, called directly.
    Sends back (0, 0, {rc, row, equal, err}) or (0, -1, the traceback)."""
    try:
        from tdc_tpu_torch.data import NpzStream
        from tdc_tpu_torch.models import streamed_kmeans_fit

        torch.cuda.set_per_process_memory_fraction(fraction)
        args = [a for a in STREAM_ARGS
                if not a.startswith(("--n_obs", "--n_dim"))]
        with Captured("streamed_kmeans_fit") as cap:
            rc = cli.main([*args, f"--data_file={npy}", "--num_batches=1",
                           f"--n_max_iters={OOM_ITERS}",
                           f"--log_file={log}"])
        with open(log, newline="") as f:
            row = list(csv.DictReader(f))[-1]
        out = dict(rc=rc, row=row, equal=False, err=None)
        got = cap.last.get("streamed_kmeans_fit")
        if rc == 0 and got is not None:
            nb = int(row["num_batches"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = streamed_kmeans_fit(
                NpzStream.from_npy(npy, -(-STREAM_N // nb)), STREAM_K,
                STREAM_D, init="first_k", max_iters=OOM_ITERS, tol=-1,
                kernel="pallas")
            torch.cuda.synchronize()
            out["direct_s"] = time.perf_counter() - t0
            out["equal"] = bool(torch.equal(got.centroids, want.centroids))
            out["err"] = (got.centroids - want.centroids).abs().max().item()
        queue.put((0, 0, out))
    except BaseException:
        queue.put((0, -1, traceback.format_exc()))


def phase_oom(npy, tmp, points_bytes) -> dict:
    """[oom]: a spawned process caps its own allocator
    (torch.cuda.set_per_process_memory_fraction) at OOM_SHARE of the
    points' bytes and runs the CLI in memory on them: it must exit 0 with
    a row whose num_batches > 1 was chosen by doubling, and centroids
    equal to the streamed fit at that count called directly."""
    total = torch.cuda.mem_get_info()[1]
    fraction = OOM_SHARE * points_bytes / total
    log = os.path.join(tmp, "oom.csv")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_oom_child, args=(npy, log, fraction, queue))
    t0 = time.perf_counter()
    proc.start()
    try:
        while True:
            try:
                _, rc, out = queue.get(timeout=5)
                break
            except queue_lib.Empty:
                require(proc.exitcode is None
                        and time.perf_counter() - t0 < RANK_TIMEOUT,
                        f"[oom] child exited {proc.exitcode} without a "
                        "result, or the time ran out")
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    require(rc == 0, f"[oom] child failed: {out}")
    row = out["row"]
    nb = int(row["num_batches"])
    require(out["rc"] == 0 and row["status"] == "ok", f"[oom] row {row}")
    require(nb > 1 and nb & (nb - 1) == 0,
            f"[oom] num_batches {nb}: not a doubling of 1")
    require(out["equal"], f"[oom] centroids differ from the direct streamed "
                          f"fit at {nb} batches by {out['err']}")
    print(f"[oom] allocator capped at {fraction * total / 1e9:.3f} GB "
          f"({fraction:.5f} of {total / 1e9:.1f} GB) under the points' "
          f"{points_bytes / 1e9:.3f} GB: exit 0 after "
          f"{time.perf_counter() - t0:.1f} s, num_batches {nb} by doubling, "
          f"computation_time {row['computation_time']} s, centroids bitwise "
          f"equal to the direct streamed fit at {nb} batches (which took "
          f"{out['direct_s']:.3f} s for {OOM_ITERS + 1} passes)", flush=True)
    return row


def phase_streams(tmp) -> dict:
    """The streamed phases: [stream_route], [stream_fuzzy], [stream_gmm],
    [stream_ref], [stream_dp] and [oom]. Returns the stream route's
    numbers."""
    from tdc_tpu_torch.models import gmm as tg

    batches = ["--num_batches", str(STREAM_BATCHES)]
    # [stream_route]: in memory, then streamed, through the CLI. From
    # first_k seeds (several in one blob, whose boundary then cuts it) the
    # two fits start alike, but 10 Lloyd steps at 10^7 points carry the
    # f32 summation-order difference into label flips at near-ties: the
    # CLI fits are held to each other's SSE at every iteration
    # (STEP_SSE_TOL), and the final centroids' gap is printed with the
    # rows whose label it flips; the centroids are held (1e-4) after one
    # step from those seeds and after 10 steps from seeds near the blobs'
    # means, through the functions.
    hist = {key: os.path.join(tmp, f"stream_{key}_history.csv")
            for key in ("mem", "st")}
    row_m, seen, fits = run_cli_captured(
        [*STREAM_ARGS, f"--history_file={hist['mem']}"], tmp, "stream_mem",
        "kmeans_fit")
    mem = fits["kmeans_fit"]
    require(int(row_m["n_iter"]) == 10 and row_m["num_batches"] == "1",
            f"stream_mem: row {row_m}")
    require_launches("stream_mem", seen, B1=2 * 11)
    row, seen, fits = run_cli_captured(
        [*STREAM_ARGS, *batches, f"--history_file={hist['st']}"], tmp,
        "stream_route", "streamed_kmeans_fit")
    st = fits["streamed_kmeans_fit"]
    passes = st.comms.passes
    require(row["num_batches"] == str(STREAM_BATCHES) and passes == 11,
            f"stream_route: row {row}, {passes} passes")
    require_launches("stream_route", seen, B1=2 * STREAM_BATCHES * passes)
    require((st.n_iter, st.converged) == (mem.n_iter, mem.converged),
            f"stream_route: n_iter/converged {st.n_iter}/{st.converged} vs "
            f"{mem.n_iter}/{mem.converged} in memory")
    sse_rel = abs(float(row["sse"]) - float(row_m["sse"])) / float(
        row_m["sse"])
    require(sse_rel <= REL_TOL, f"stream_route: sse {row['sse']} vs "
                                f"{row_m['sse']} in memory")
    h_m, h_s = (np.loadtxt(hist[key], delimiter=",", skiprows=1)
                for key in ("mem", "st"))
    steps = np.abs(h_s[:, 1] / h_m[:, 1] - 1)
    require(h_s.shape == h_m.shape == (10, 3)
            and float(steps.max()) <= STEP_SSE_TOL,
            f"stream_route: per-iteration sse rel {steps.tolist()} "
            f"(tolerance {STEP_SSE_TOL})")
    host = stream_points(STREAM_N, STREAM_D, STREAM_K)
    rows = -(-STREAM_N // STREAM_BATCHES)
    npy = os.path.join(tmp, "stream_points.npy")
    np.save(npy, host)
    split = pass_split(host, rows, st.centroids)
    print(stream_line("stream_route", row, st, split) + f"; in memory "
          f"{row_m['computation_time']} s; n_iter {st.n_iter} == "
          f"{mem.n_iter}, sse {row['sse']} vs {row_m['sse']} (rel "
          f"{sse_rel:.3g}); per-iteration sse rel "
          f"{steps.round(10).tolist()} (tolerance {STEP_SSE_TOL})",
          flush=True)
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.models import kmeans_fit as fit_mem
    from tdc_tpu_torch.models import streamed_kmeans_fit as fit_st

    x = torch.from_numpy(host).cuda()
    gap = (st.centroids - mem.centroids).abs().max().item()
    flips, worst = label_flips(x, mem.centroids, st.centroids)
    print(f"[stream_route] after 10 steps the streamed and in-memory "
          f"centroids differ by at most {gap:.4g}; {flips} of {STREAM_N} "
          f"rows change label between them, the largest gap between their "
          f"two labels' distances {worst:.3g} of ‖x‖² + ‖c‖²", flush=True)
    _, y = make_blobs(1, STREAM_N, STREAM_D, STREAM_K, device="cuda")
    means = torch.zeros((STREAM_K, STREAM_D), device="cuda").index_add_(
        0, y.long(), x) / torch.bincount(y.long(), minlength=STREAM_K
                                         ).clamp_min(1)[:, None].float()
    g = torch.Generator(device="cuda").manual_seed(0)
    # tol >= 0 where the fit may stop moving: at tol < 0 the in-memory
    # fit calls a zero shift converged and the streamed one does not (the
    # JAX package's two streamed and in-memory fits' rules).
    for label, init, iters, tol in (
            ("one step from first_k", x[:STREAM_K].clone(), 1, -1.0),
            ("up to 10 steps (tol 1e-4) from the blobs' means + 0.3 noise",
             means + 0.3 * torch.randn(means.shape, generator=g,
                                       device="cuda"), 10, 1e-4)):
        a = fit_st(NpzStream(host, rows), STREAM_K, STREAM_D, init=init,
                   max_iters=iters, tol=tol, kernel="pallas")
        b = fit_mem(x, STREAM_K, init=init, max_iters=iters, tol=tol,
                    kernel="pallas")
        require((a.n_iter, a.converged) == (b.n_iter, b.converged),
                f"stream_route, {label}: n_iter {a.n_iter} vs {b.n_iter}")
        err = check_centroids(f"stream_route, {label}", a.centroids,
                              b.centroids)
        print(f"[stream_route] {label}: streamed against in memory, "
              f"n_iter {a.n_iter} == {b.n_iter}, converged {a.converged}, "
              f"max centroid diff {err:.3g}, sse {float(a.sse):.10g} vs "
              f"{float(b.sse):.10g}", flush=True)
    del x, y, means
    numbers = dict(row=row, mem_row=row_m, split=split, passes=passes)
    refs = {"route": st, "route_row": row}
    # [stream_fuzzy]: B6 per batch against the in-memory fit.
    row_m, seen_m, fits = run_cli_captured(STREAM_FUZZY_ARGS, tmp,
                                           "stream_fuzzy_mem",
                                           "fuzzy_cmeans_fit")
    mem = fits["fuzzy_cmeans_fit"]
    require_launches("stream_fuzzy_mem", seen_m, B6=2 * 5)
    row, seen, fits = run_cli_captured([*STREAM_FUZZY_ARGS, *batches], tmp,
                                       "stream_fuzzy", "streamed_fuzzy_fit")
    st = refs["fuzzy"] = fits["streamed_fuzzy_fit"]
    refs["fuzzy_row"] = row
    require_launches("stream_fuzzy", seen,
                     B6=2 * STREAM_BATCHES * st.comms.passes)
    require((st.n_iter, st.converged) == (mem.n_iter, mem.converged),
            f"stream_fuzzy: n_iter/converged {st.n_iter}/{st.converged} vs "
            f"{mem.n_iter}/{mem.converged}")
    err = check_centroids("stream_fuzzy", st.centroids, mem.centroids)
    rel = abs(float(st.objective) - float(mem.objective)) / float(
        mem.objective)
    require(rel <= REL_TOL, f"stream_fuzzy: objective rel {rel}")
    print(stream_line("stream_fuzzy", row, st) + f"; in memory "
          f"{row_m['computation_time']} s; max centroid diff {err:.3g}, "
          f"objective rel {rel:.3g}", flush=True)
    # [stream_gmm]: B9 per batch. The in-memory EM loop runs from the
    # streamed fit's start (means from the first batch's first K rows,
    # variances and weights from its hard assignment): an in-memory CLI
    # fit seeds its variances on all rows instead.
    row, seen, fits = run_cli_captured([*STREAM_GMM_ARGS, *batches], tmp,
                                       "stream_gmm", "streamed_gmm_fit")
    st = fits["streamed_gmm_fit"]
    require_launches("stream_gmm", seen,
                     B9=2 * STREAM_BATCHES * st.comms.passes)
    rows = -(-STREAM_N // STREAM_BATCHES)
    first = torch.from_numpy(host[:rows]).cuda()
    means0 = first[:STREAM_K].clone()
    var0, w0 = tg._moments_from_hard_assign(first, means0, 1e-6)
    del first
    x = torch.from_numpy(host).cuda()
    means, var, w, n_iter, ll, conv = tg._em_loop(
        x, means0, var0, w0, 4, -1.0, 1e-6, "diag", None, "pallas")
    del x
    require((st.n_iter, st.converged) == (n_iter, conv),
            f"stream_gmm: n_iter/converged {st.n_iter}/{st.converged} vs "
            f"{n_iter}/{conv} in memory")
    err = check_centroids("stream_gmm", st.means, means)
    rel = abs(float(st.log_likelihood) - float(ll)) / abs(float(ll))
    require(rel <= REL_TOL, f"stream_gmm: log-likelihood rel {rel}")
    print(stream_line("stream_gmm", row, st) + f"; max mean diff "
          f"{err:.3g} against the in-memory EM loop from the same start, "
          f"log-likelihood rel {rel:.3g}", flush=True)
    del host
    # [stream_ref]: the reference notebook's job, exact and mean-combined.
    row_m, _, fits = run_cli_captured(REF_ARGS, tmp, "stream_ref_mem",
                                      "kmeans_fit")
    mem = fits["kmeans_fit"]
    row, seen, fits = run_cli_captured([*REF_ARGS, *batches], tmp,
                                       "stream_ref", "streamed_kmeans_fit")
    st = fits["streamed_kmeans_fit"]
    require_launches("stream_ref", seen,
                     B1=2 * STREAM_BATCHES * st.comms.passes)
    require((st.n_iter, st.converged) == (mem.n_iter, mem.converged),
            f"stream_ref: n_iter/converged {st.n_iter}/{st.converged} vs "
            f"{mem.n_iter}/{mem.converged}")
    err = check_centroids("stream_ref", st.centroids, mem.centroids)
    row_c, _, _ = run_cli_captured([*REF_ARGS, *batches, "--mean_combine"],
                                   tmp, "stream_ref_mean_combine")
    require(float(row_c["sse"]) >= float(row["sse"]) * (1 - REL_TOL),
            f"stream_ref: mean_combine sse {row_c['sse']} below the exact "
            f"fit's {row['sse']}")
    print(stream_line("stream_ref", row, st) + f"; in memory "
          f"{row_m['computation_time']} s, n_iter {mem.n_iter}, max "
          f"centroid diff {err:.3g}; mean_combine computation_time "
          f"{row_c['computation_time']} s, n_iter {row_c['n_iter']}, sse "
          f"{row_c['sse']} against the exact {row['sse']}", flush=True)
    # [stream_dp]: two ranks, per batch and per pass, against one rank.
    one, seen, fits = run_cli_captured(STREAM_DP_ARGS, tmp, "stream_dp_one",
                                       "streamed_kmeans_fit")
    passes = fits["streamed_kmeans_fit"].comms.passes
    one_c = fits["streamed_kmeans_fit"].centroids.cpu()
    refs["dp"] = {}
    for reduce in ("per_batch", "per_pass"):
        name = f"stream_dp_{reduce}"
        row, seen, fits = run_ranks([*STREAM_DP_ARGS, f"--n_GPUs={RANKS}",
                                     f"--reduce={reduce}"], tmp, name)
        c = fits[0][0]
        for rank, per_rank in enumerate(seen):
            require_launches(f"{name}, rank {rank}", per_rank,
                             B1=2 * 4 * passes)
        rel = abs(float(row["sse"]) - float(one["sse"])) / float(one["sse"])
        require(row["n_iter"] == one["n_iter"] and rel <= REL_TOL,
                f"{name}: n_iter {row['n_iter']}, sse {row['sse']} vs one "
                f"rank's {one['n_iter']}, {one['sse']}")
        err = check_centroids(name, torch.from_numpy(c), one_c)
        refs["dp"][reduce] = (row, c)
        print(f"[{name}] against one rank: n_iter {row['n_iter']} == "
              f"{one['n_iter']}, sse {row['sse']} vs {one['sse']} (rel "
              f"{rel:.3g}), max centroid diff {err:.3g}; computation_time "
              f"{row['computation_time']} s (one rank "
              f"{one['computation_time']} s)", flush=True)
    phase_residency(npy, tmp, refs)
    numbers["minibatch"] = phase_minibatch(npy, tmp, smi())
    phase_ckpt(npy, tmp, smi())
    # [oom]: the stream route's points from the file.
    numbers["oom_row"] = phase_oom(npy, tmp,
                                   STREAM_N * STREAM_D * 4)
    os.remove(npy)
    return numbers


def same_fit(name, a, b, cost="sse") -> None:
    """`a` is `b` bit for bit: centroids, cost, history, n_iter and
    converged."""
    require(torch.equal(a.centroids.cpu(), b.centroids.cpu())
            and float(getattr(a, cost)) == float(getattr(b, cost))
            and np.array_equal(np.asarray(a.history), np.asarray(b.history))
            and (a.n_iter, a.converged) == (b.n_iter, b.converged),
            f"{name}: not the streamed fit's bits (n_iter {a.n_iter} vs "
            f"{b.n_iter}, {cost} {float(getattr(a, cost))!r} vs "
            f"{float(getattr(b, cost))!r}, max centroid diff "
            f"{(a.centroids.cpu() - b.centroids.cpu()).abs().max().item()})")


class StagedBytes:
    """While active, counts the bytes the streamed fits copy from the host
    to the card batch by batch (`models/streaming.device_rows`, the
    inline staging, the init's first batch included)."""

    def __init__(self):
        from tdc_tpu_torch.models import streaming as tst

        self.mod, self.real, self.bytes = tst, tst.device_rows, 0

    def __enter__(self):
        def counted(a, rows, device):
            if not (isinstance(a, torch.Tensor) and a.is_cuda):
                self.bytes += a.nbytes if isinstance(a, np.ndarray) else (
                    a.numel() * a.element_size())
            return self.real(a, rows, device)

        self.mod.device_rows = counted
        return self

    def __exit__(self, *exc):
        self.mod.device_rows = self.real


class PassTimes:
    """While active, times each pass of the streamed fits on the host
    clock between synchronizes: `_Pass.run` (a fill pass where it fills a
    cache) and `_Pass.run_cached`. `last_fit()` is (the last fill pass's
    seconds, the mean of the cached passes after it, their count)."""

    def __init__(self):
        from tdc_tpu_torch.models import streaming as tst

        self.cls = tst._Pass
        self.real = (tst._Pass.run, tst._Pass.run_cached)
        self.passes = []

    def __enter__(self):
        def timed(fn, cached):
            def wrapper(machine, params, *a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(machine, params, *a, **kw)
                torch.cuda.synchronize()
                kind = ("cached" if cached else
                        "fill" if kw.get("fill") is not None else "stream")
                self.passes.append((kind, time.perf_counter() - t0))
                return out
            return wrapper

        self.cls.run = timed(self.real[0], False)
        self.cls.run_cached = timed(self.real[1], True)
        return self

    def __exit__(self, *exc):
        self.cls.run, self.cls.run_cached = self.real

    def last_fit(self) -> tuple[float, float, int]:
        kinds = [k for k, _ in self.passes]
        i = len(kinds) - 1 - kinds[::-1].index("fill")
        cached = [t for k, t in self.passes[i + 1:] if k == "cached"]
        return self.passes[i][1], sum(cached) / len(cached), len(cached)


def phase_residency(npy, tmp, refs) -> None:
    """[residency]: the device cache and the spill ring on the stream
    route's points (phase 20 of the module docstring). `refs` holds the
    streamed fits they must equal: [stream_route]'s and [stream_fuzzy]'s
    computation fits and [stream_dp]'s two-rank rows and centroids."""
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.data import device_cache as tdc
    from tdc_tpu_torch.models import streamed_kmeans_fit as fit_st

    t_phase = time.perf_counter()
    batches = ["--num_batches", str(STREAM_BATCHES), f"--data_file={npy}"]
    rows = -(-STREAM_N // STREAM_BATCHES)
    # (a) hbm through the CLI.
    with StagedBytes() as staged, PassTimes() as passes:
        row, seen, fits = run_cli_captured(
            [*STREAM_ARGS, *batches, "--residency=hbm"], tmp,
            "residency_hbm", "streamed_kmeans_fit")
    res = fits["streamed_kmeans_fit"]
    require_launches("residency_hbm", seen, B1=2 * STREAM_BATCHES * 11)
    same_fit("residency_hbm", res, refs["route"])
    # Each fit copies the init's first batch and its first pass, no more.
    once = (rows + STREAM_N) * STREAM_D * 4
    after = staged.bytes - 2 * once
    require(after == 0, f"residency_hbm: {after} batch bytes staged after "
                        "the first pass")
    fill_s, cached_s, n_cached = passes.last_fit()
    require(n_cached == 10, f"residency_hbm: {n_cached} cached passes")
    print(f"[residency] (a) hbm: bitwise [stream_route]'s fit; "
          f"computation_time {row['computation_time']} s a fit "
          f"([stream_route] {refs['route_row']['computation_time']} s; "
          f"passes timed between synchronizes: fill pass {fill_s!r} s, "
          f"cached pass mean {cached_s!r} s over {n_cached}); "
          f"{staged.bytes} bytes staged in 2 fits, {after} after the first "
          f"pass; B1 {seen['B1']}", flush=True)
    # (b) spill through the CLI.
    row, seen, fits = run_cli_captured(
        [*STREAM_ARGS, *batches, "--residency=spill"], tmp,
        "residency_spill", "streamed_kmeans_fit")
    res = fits["streamed_kmeans_fit"]
    require_launches("residency_spill", seen, B1=2 * STREAM_BATCHES * 11)
    same_fit("residency_spill", res, refs["route"])
    h = res.h2d
    require(h is not None and h.batches >= STREAM_BATCHES * 11,
            f"residency_spill: report {h}")
    print(f"[residency] (b) spill: bitwise [stream_route]'s fit; "
          f"computation_time {row['computation_time']} s a fit, "
          f"{float(row['computation_time']) / 11:.4f} s a pass; "
          f"{h}, overlap_lower_bound {h.overlap_lower_bound:.4f}, "
          f"{h.h2d_bytes / h.copy_s / 1e9:.2f} GB/s a stage", flush=True)
    # (c) auto, with the cache over the budget and the ring under it.
    points = np.load(npy, mmap_mode="r")
    probe = tdc.plan_residency(
        "spill", hints=tdc.stream_hints(NpzStream(points, rows)),
        d=STREAM_D, k=STREAM_K, kernel="pallas", device="cuda")
    budget = (probe.spill_bytes + probe.resident_bytes) // 2 + \
        probe.reserve_bytes
    require(probe.spill_bytes + probe.reserve_bytes < budget
            < probe.resident_bytes + probe.reserve_bytes,
            f"residency_auto: budget {budget} for {probe}")
    real_budget = tdc.planner_budget_bytes
    log = os.path.join(tmp, "residency_auto.jsonl")
    os.environ["TDC_RUNLOG"] = log
    tdc.planner_budget_bytes = lambda device=None: budget
    try:
        reset_counts()
        t0 = time.perf_counter()
        res = fit_st(NpzStream(points, rows), STREAM_K, STREAM_D,
                     init=points[:STREAM_K], max_iters=10, tol=-1.0,
                     kernel="pallas", residency="auto")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seen = counts()
    finally:
        tdc.planner_budget_bytes = real_budget
        del os.environ["TDC_RUNLOG"]
    with open(log) as f:
        events = [json.loads(line) for line in f]
    spill_ev = [e for e in events if e["event"] == "residency_spill"]
    require(res.h2d is not None and len(spill_ev) == 1
            and spill_ev[0]["reason"] == "cache_over_budget",
            f"residency_auto: events {events}")
    require_launches("residency_auto", seen, B1=STREAM_BATCHES * 11)
    same_fit("residency_auto", res, refs["route"])
    print(f"[residency] (c) auto under a {budget}-byte budget picked spill, "
          f"bitwise: event {json.dumps(spill_ev[0])}; {secs:.3f} s the fit",
          flush=True)
    # (d) fuzzy hbm through the CLI.
    with PassTimes() as passes:
        row, seen, fits = run_cli_captured(
            [*STREAM_FUZZY_ARGS, *batches, "--residency=hbm"], tmp,
            "residency_fuzzy_hbm", "streamed_fuzzy_fit")
    fill_s, cached_s, n_cached = passes.last_fit()
    require_launches("residency_fuzzy_hbm", seen,
                     B6=2 * STREAM_BATCHES * 5)
    same_fit("residency_fuzzy_hbm", fits["streamed_fuzzy_fit"],
             refs["fuzzy"], "objective")
    print(f"[residency] (d) fuzzy hbm: bitwise [stream_fuzzy]'s fit; "
          f"computation_time {row['computation_time']} s a fit "
          f"([stream_fuzzy] {refs['fuzzy_row']['computation_time']} s; "
          f"fill pass {fill_s!r} s, cached pass mean {cached_s!r} s over "
          f"{n_cached}); B6 {seen['B6']}", flush=True)
    # (e) hbm with checkpoints every 3 iterations, resumed from 6.
    ck = os.path.join(tmp, "residency_ckpt")
    kw = dict(init=points[:STREAM_K], tol=-1.0, kernel="pallas",
              residency="hbm", ckpt_dir=ck, ckpt_every=3)
    reset_counts()
    t0 = time.perf_counter()
    first = fit_st(NpzStream(points, rows), STREAM_K, STREAM_D,
                   max_iters=6, **kw)
    b1_first = counts()["B1"]
    resumed = fit_st(NpzStream(points, rows), STREAM_K, STREAM_D,
                     max_iters=10, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = sorted(os.listdir(ck))
    require(first.n_iter == 6 and resumed.n_iter_run == 4
            and steps == [f"step_{i:08d}" for i in (3, 6, 9, 10)]
            and b1_first == STREAM_BATCHES * 7
            and counts()["B1"] == STREAM_BATCHES * 12,
            f"residency_ckpt: steps {steps}, n_iter_run "
            f"{resumed.n_iter_run}, launches {counts()}")
    same_fit("residency_ckpt", resumed, refs["route"])
    shutil.rmtree(ck)
    print(f"[residency] (e) hbm with ckpt_every=3: saves {steps}, resumed "
          f"from iteration 6, bitwise [stream_route]'s fit; {secs:.3f} s "
          f"both fits, B1 {b1_first} + {counts()['B1'] - b1_first}",
          flush=True)
    del points
    # (f) two ranks, per_pass, hbm.
    row, seen, fits = run_ranks([*STREAM_DP_ARGS, f"--n_GPUs={RANKS}",
                                 "--reduce=per_pass", "--residency=hbm"],
                                tmp, "residency_dp")
    want_row, want_c = refs["dp"]["per_pass"]
    for rank, per_rank in enumerate(seen):
        require_launches(f"residency_dp, rank {rank}", per_rank, B1=2 * 4 * 2)
    require(np.array_equal(fits[0][0], want_c)
            and all(np.array_equal(f[0], want_c) for f in fits)
            and (row["sse"], row["n_iter"]) == (want_row["sse"],
                                                want_row["n_iter"]),
            f"residency_dp: sse {row['sse']} vs {want_row['sse']}")
    print(f"[residency] (f) two ranks per_pass hbm: bitwise [stream_dp]'s "
          f"per_pass fit, sse {row['sse']}; computation_time "
          f"{row['computation_time']} s ([stream_dp] "
          f"{want_row['computation_time']} s)", flush=True)
    print(f"[residency] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# [ckpt]: checkpoint, preemption and resume of the streamed and mini-batch
# fits. (a) K-Means on B1 at the stream route's shape (STREAM_BATCHES
# batches, first_k seeds, CKPT_ITERS Lloyd steps, a mid-pass save every
# CKPT_EVERY_BATCHES batches): the CLI with --ckpt_dir, then the function
# killed in pass 3 (a stream that raises) and resumed. (b) A spawned
# child with the SIGTERM handler installed signals itself in pass 3: it
# must exit PREEMPTED_EXIT_CODE with a mid-pass checkpoint, which the
# parent resumes. (c) Fuzzy (B6, m=2) and diag GMM (B9) on the first
# CKPT_SMALL_N points, per-iteration checkpoints, killed in pass 3. (d)
# Two ranks per_batch (gloo on the card's tensors) on the first
# CKPT_DP_N points in 4 batches, killed in pass 2. (e) Mini-batch on the
# points file, killed in epoch 2. Every resume equals the uninterrupted
# fit bit for bit and launches its kernel once per batch it computes,
# none for the replayed prefix.
CKPT_ITERS = 4
CKPT_EVERY_BATCHES = 3
CKPT_SMALL_N = 1 << 20
CKPT_DP_N = 1 << 21
CKPT_DP_BATCHES = 4
CKPT_ARGS = ["--method_name=distributedKMeans", f"--K={STREAM_K}",
             "--kernel=pallas", f"--n_max_iters={CKPT_ITERS}", "--tol=-1",
             "--seed=0", "--init=first_k",
             f"--num_batches={STREAM_BATCHES}",
             f"--ckpt_every_batches={CKPT_EVERY_BATCHES}"]


class CrashingStream:
    """An NpzStream that raises after yielding `fuse` batches in all,
    across passes (a crash mid-pass). The explicit init's read of the
    first batch counts as one."""

    def __init__(self, host, rows, fuse):
        from tdc_tpu_torch.data import NpzStream

        self.inner = NpzStream(host, rows)
        self.fuse = fuse
        self.yielded = 0

    def __call__(self):
        for batch in self.inner():
            if self.yielded >= self.fuse:
                raise RuntimeError("injected crash")
            self.yielded += 1
            yield batch


class SaveTimes:
    """While active, times every checkpoint save (the copy of the state
    to the host, the CRCs, the write and the rename) and records the
    state.npz bytes it left."""

    def __init__(self):
        from tdc_tpu_torch.utils import checkpoint as ck

        self.ck, self.real, self.saves = ck, ck.save_checkpoint, []

    def __enter__(self):
        def timed(ckpt_dir, state, step, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = self.real(ckpt_dir, state, step, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            size = os.path.getsize(os.path.join(path, "state.npz"))
            self.saves.append((ms, size, state.batch_cursor))
            return path

        self.ck.save_checkpoint = timed
        return self

    def __exit__(self, *exc):
        self.ck.save_checkpoint = self.real

    def line(self) -> str:
        if not self.saves:
            return "no saves"
        ms = [s[0] for s in self.saves]
        mid = [s[1] for s in self.saves if s[2] > 0]
        end = [s[1] for s in self.saves if s[2] == 0]
        out = (f"{len(ms)} saves: median {statistics.median(ms):.2f} ms, "
               f"max {max(ms):.2f} ms")
        for kind, sizes in (("mid-pass", mid), ("end of iteration", end)):
            if sizes:
                out += f"; {len(sizes)} {kind}, {max(sizes)} bytes"
        return out


def _ckpt_sigterm_child(npy, ckpt_dir, fuse) -> None:
    """[ckpt] (b)'s child: the drain handler installed, the stream route's
    K-Means from the points file with a stream that sends this process
    SIGTERM as it yields batch `fuse`; Preempted exits
    PREEMPTED_EXIT_CODE. Exits 0 if no preemption came."""
    import signal

    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.models import streamed_kmeans_fit
    from tdc_tpu_torch.utils import preempt

    preempt.install_preemption_handler()
    host = np.load(npy, mmap_mode="r")
    rows = -(-STREAM_N // STREAM_BATCHES)

    class Signalling(NpzStream):
        fetched = 0

        def __call__(self):
            for b in super().__call__():
                Signalling.fetched += 1
                if Signalling.fetched == fuse:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

    streamed_kmeans_fit(Signalling(host, rows), STREAM_K, STREAM_D,
                        init=np.ascontiguousarray(host[:STREAM_K]),
                        max_iters=CKPT_ITERS, tol=-1, kernel="pallas",
                        ckpt_dir=ckpt_dir, ckpt_every=100,
                        ckpt_every_batches=CKPT_EVERY_BATCHES)


def _rank_ckpt(rank, world, port, args, queue) -> None:
    """[ckpt] (d)'s rank: streamed K-Means per_batch on a 2-rank mesh from
    the points file, uninterrupted, then killed in pass 2 after a
    mid-pass save (rank 0 writes) and resumed. Sends back (rank, 0,
    {equal, launches of the resume, n_iter_run, cursor}) or (rank, -1,
    the traceback)."""
    _rank_env(rank, world, port)
    try:
        from tdc_tpu_torch.data import NpzStream
        from tdc_tpu_torch.models import streamed_kmeans_fit
        from tdc_tpu_torch.utils.checkpoint import restore_checkpoint

        npy, ckpt_dir = args
        multihost.initialize_from_env()
        try:
            host = np.load(npy, mmap_mode="r")[:CKPT_DP_N]
            rows = -(-CKPT_DP_N // CKPT_DP_BATCHES)
            kw = dict(init=np.ascontiguousarray(host[:STREAM_K]),
                      max_iters=3, tol=-1, kernel="pallas",
                      mesh=make_mesh(world))
            full = streamed_kmeans_fit(NpzStream(host, rows), STREAM_K,
                                       STREAM_D, **kw)
            ck = dict(ckpt_dir=ckpt_dir, ckpt_every=100,
                      ckpt_every_batches=2)
            try:
                streamed_kmeans_fit(
                    CrashingStream(host, rows, 1 + CKPT_DP_BATCHES + 3),
                    STREAM_K, STREAM_D, **kw, **ck)
            except RuntimeError:
                pass
            cursor = restore_checkpoint(ckpt_dir).batch_cursor
            reset_counts()
            res = streamed_kmeans_fit(NpzStream(host, rows), STREAM_K,
                                      STREAM_D, **kw, **ck)
            out = dict(equal=bool(torch.equal(res.centroids,
                                              full.centroids)),
                       launches=counts(), n_iter_run=res.n_iter_run,
                       cursor=cursor)
        finally:
            multihost.shutdown()
        queue.put((rank, 0, out))
    except BaseException:
        queue.put((rank, -1, traceback.format_exc()))


def phase_ckpt(npy, tmp, card) -> None:
    """[ckpt] (see CKPT_ITERS): each resume bitwise equal to the
    uninterrupted fit, its launches the batches it computed, every save's
    time and size printed."""
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.models import (
        minibatch_kmeans_fit,
        streamed_fuzzy_fit,
        streamed_gmm_fit,
        streamed_kmeans_fit,
    )
    from tdc_tpu_torch.utils.checkpoint import restore_checkpoint
    from tdc_tpu_torch.utils.preempt import PREEMPTED_EXIT_CODE

    host = np.load(npy, mmap_mode="r")
    nb = STREAM_BATCHES
    rows = -(-STREAM_N // nb)
    init = np.ascontiguousarray(host[:STREAM_K])
    # (a) The CLI: one checkpointed fit, timed as the computation.
    with SaveTimes() as saves:
        row, seen, fits = run_cli_captured(
            [*CKPT_ARGS, f"--data_file={npy}",
             f"--ckpt_dir={os.path.join(tmp, 'ckpt_cli')}"], tmp,
            "ckpt_route", "streamed_kmeans_fit")
    full = fits["streamed_kmeans_fit"]
    require(row["n_iter"] == row["n_iter_run"] == str(CKPT_ITERS)
            and row["computation_time"] == row["initialization_time"],
            f"ckpt_route: row {row}")
    require_launches("ckpt_route", seen, B1=nb * (CKPT_ITERS + 1))
    print(f"[ckpt] route: the CLI with --ckpt_dir, N={STREAM_N} K={STREAM_K} "
          f"d={STREAM_D}, {nb} batches, {CKPT_ITERS} steps: "
          f"computation_time {row['computation_time']} s (one fit); "
          f"launches {seen}; {saves.line()}; {card}", flush=True)
    # (a) The function, killed in pass 3 after the save at batch 6.
    d = os.path.join(tmp, "ckpt_fn")
    ck = dict(ckpt_dir=d, ckpt_every=100,
              ckpt_every_batches=CKPT_EVERY_BATCHES)
    kw = dict(init=init, max_iters=CKPT_ITERS, tol=-1, kernel="pallas")
    reset_counts()
    t0 = time.perf_counter()
    try:
        streamed_kmeans_fit(CrashingStream(host, rows, 1 + 2 * nb + 7),
                            STREAM_K, STREAM_D, **kw, **ck)
        require(False, "ckpt: the crashing stream did not crash")
    except RuntimeError as e:
        require(str(e) == "injected crash", f"ckpt: {e}")
    crash_s = time.perf_counter() - t0
    require_launches("ckpt crash", counts(), B1=2 * nb + 7)
    saved = restore_checkpoint(d)
    require((saved.n_iter, saved.batch_cursor) == (2, 6),
            f"ckpt: saved step {saved.n_iter}, cursor {saved.batch_cursor}")
    reset_counts()
    t0 = time.perf_counter()
    with SaveTimes() as saves:
        res = streamed_kmeans_fit(NpzStream(host, rows), STREAM_K, STREAM_D,
                                  **kw, **ck)
    resume_s = time.perf_counter() - t0
    seen = counts()
    require_launches("ckpt resume", seen, B1=(nb - 6) + 2 * nb)
    require(torch.equal(res.centroids, full.centroids)
            and (res.n_iter, res.n_iter_run) == (CKPT_ITERS, 2),
            f"ckpt resume: n_iter {res.n_iter}, n_iter_run "
            f"{res.n_iter_run}, centroids bitwise "
            f"{torch.equal(res.centroids, full.centroids)}")
    print(f"[ckpt] kill in pass 3 at batch 7 ({crash_s:.2f} s), resume "
          f"from step 2 cursor 6 ({resume_s:.2f} s, launches {seen}: none "
          f"for the 6 replayed batches): centroids bitwise equal to the "
          f"uninterrupted fit, n_iter_run {res.n_iter_run}; resume "
          f"{saves.line()}; {card}", flush=True)
    # (b) SIGTERM in a child: exit 75 with a mid-pass checkpoint.
    d = os.path.join(tmp, "ckpt_sigterm")
    ctx = mp.get_context("spawn")
    child = ctx.Process(target=_ckpt_sigterm_child,
                        args=(npy, d, 1 + 2 * nb + 5))
    t0 = time.perf_counter()
    child.start()
    child.join(timeout=RANK_TIMEOUT)
    if child.is_alive():
        child.kill()
        child.join()
    require(child.exitcode == PREEMPTED_EXIT_CODE,
            f"ckpt sigterm: the child exited {child.exitcode}")
    child_s = time.perf_counter() - t0
    saved = restore_checkpoint(d)
    require((saved.n_iter, saved.batch_cursor) == (2, 5),
            f"ckpt sigterm: saved step {saved.n_iter}, cursor "
            f"{saved.batch_cursor}")
    reset_counts()
    res = streamed_kmeans_fit(NpzStream(host, rows), STREAM_K, STREAM_D,
                              **kw, **{**ck, "ckpt_dir": d})
    seen = counts()
    require_launches("ckpt sigterm resume", seen, B1=(nb - 5) + 2 * nb)
    require(torch.equal(res.centroids, full.centroids),
            "ckpt sigterm: the resume differs from the uninterrupted fit")
    print(f"[ckpt] SIGTERM in pass 3: the child exited "
          f"{child.exitcode} after {child_s:.1f} s with step 2 cursor 5; "
          f"the resume (launches {seen}) is bitwise the uninterrupted "
          f"fit; {card}", flush=True)
    # (c) Fuzzy (B6) and diag GMM (B9), per-iteration checkpoints.
    small = host[:CKPT_SMALL_N]
    srows = -(-CKPT_SMALL_N // nb)
    for name, fit, key, extra in (
            ("fuzzy", streamed_fuzzy_fit, "B6", dict(m=2.0)),
            ("gmm", streamed_gmm_fit, "B9", dict(covariance_type="diag"))):
        kw = dict(init=init, max_iters=CKPT_ITERS, tol=-1, kernel="pallas",
                  **extra)
        a = fit(NpzStream(small, srows), STREAM_K, STREAM_D, **kw)
        d = os.path.join(tmp, f"ckpt_{name}")
        try:
            fit(CrashingStream(small, srows, 1 + 2 * nb + 3), STREAM_K,
                STREAM_D, ckpt_dir=d, ckpt_every=1, **kw)
            require(False, f"ckpt {name}: the stream did not crash")
        except RuntimeError:
            pass
        reset_counts()
        with SaveTimes() as saves:
            b = fit(NpzStream(small, srows), STREAM_K, STREAM_D, ckpt_dir=d,
                    ckpt_every=1, **kw)
        seen = counts()
        require_launches(f"ckpt {name} resume", seen,
                         **{key: nb * (CKPT_ITERS - 2 + 1)})
        ca, cb = ((a.means, b.means) if name == "gmm"
                  else (a.centroids, b.centroids))
        require(torch.equal(ca, cb) and b.n_iter_run == CKPT_ITERS - 2,
                f"ckpt {name}: resume differs (n_iter_run {b.n_iter_run})")
        print(f"[ckpt] {name} N={CKPT_SMALL_N} K={STREAM_K} d={STREAM_D}: "
              f"killed in pass 3, resumed from step 2 (launches {seen}), "
              f"bitwise equal; {saves.line()}; {card}", flush=True)
    # (d) Two ranks per_batch.
    d = os.path.join(tmp, "ckpt_dp")
    got = spawn_ranks(_rank_ckpt, (npy, d), "ckpt_dp")
    for rank, out in enumerate(got):
        require(out["equal"] and out["n_iter_run"] == 2
                and out["cursor"] == 2,
                f"ckpt_dp, rank {rank}: {out}")
        require_launches(f"ckpt_dp resume, rank {rank}", out["launches"],
                         B1=(CKPT_DP_BATCHES - 2) + 2 * CKPT_DP_BATCHES)
    print(f"[ckpt] two ranks per_batch, N={CKPT_DP_N} in {CKPT_DP_BATCHES} "
          f"batches: killed in pass 2 after the save at batch 2 (rank 0 "
          f"writes), resumed bitwise on both ranks (launches "
          f"{[o['launches']['B1'] for o in got]}); {card}", flush=True)
    # (e) Mini-batch, killed in epoch 2.
    kw = dict(init="first_k", epochs=3, tol=-1.0, kernel="pallas",
              reassignment_ratio=0.01)
    a = minibatch_kmeans_fit(NpzStream(host, rows), STREAM_K, STREAM_D, **kw)
    d = os.path.join(tmp, "ckpt_mb")
    try:
        minibatch_kmeans_fit(CrashingStream(host, rows, nb + 5), STREAM_K,
                             STREAM_D, ckpt_dir=d, **kw)
        require(False, "ckpt minibatch: the stream did not crash")
    except RuntimeError:
        pass
    reset_counts()
    with SaveTimes() as saves:
        b = minibatch_kmeans_fit(NpzStream(host, rows), STREAM_K, STREAM_D,
                                 ckpt_dir=d, **kw)
    seen = counts()
    require_launches("ckpt minibatch resume", seen, B1=2 * nb)
    require(torch.equal(a.centroids, b.centroids) and b.n_iter_run == 2,
            f"ckpt minibatch: resume differs (n_iter_run {b.n_iter_run})")
    print(f"[ckpt] minibatch: killed in epoch 2, resumed from epoch 1 "
          f"(launches {seen}, the generator's state restored), bitwise "
          f"equal; {saves.line()}; {card}", flush=True)


# The model zoo's phases. [seeding]: k-means++ and k-means‖ alone at the
# fused route's points, then the fused route seeded by k-means‖.
# [minibatch]: BASELINE.json config 3's shape (the stream route's points
# file), --minibatch in STREAM_BATCHES batches, MB_EPOCHS epochs from
# first_k seeds, on the kernel route and on 'xla'. [bisecting]: in memory
# at N=2^22, d=128 with K cut to 32 (each split is a weighted 2-means over
# all N rows, one after another), and streamed at N=2^20 in 4 batches,
# K=4, against the same points in memory. [estimators]: KMeans on the
# fused route's points; the others, persistence and the metrics at
# ZOO_N rows.
MB_EPOCHS = 3
MB_ARGS = ["--method_name=distributedKMeans", f"--K={STREAM_K}",
           "--kernel=pallas", "--minibatch", f"--num_batches={STREAM_BATCHES}",
           "--init=first_k", f"--n_max_iters={MB_EPOCHS}", "--tol=-1",
           "--seed=0"]
# The kernel run against the 'xla' run, each epoch: B1 and the plain
# form break near-ties apart from the first batch on (the one-step check
# below counts them), and a flipped row moves a centroid by one row over
# its count, against shifts of ~33 an epoch; the [minibatch] line prints
# how far the final centroids end apart.
MB_SSE_TOL = 1e-5
MB_SHIFT_TOL = 1e-3
BIS_ARGS = ["--method_name=bisectingKMeans", f"--n_obs={B1_SHAPE[0]}",
            f"--n_dim={B1_SHAPE[2]}", "--K=32", "--n_max_iters=10",
            "--seed=0"]
BIS_STREAM_ARGS = ["--method_name=bisectingKMeans", f"--n_obs={1 << 20}",
                   f"--n_dim={B1_SHAPE[2]}", "--K=4", "--n_max_iters=10",
                   "--seed=0"]
ZOO_N, ZOO_K = 1 << 16, 32


def row_hashes(x, chunk=1 << 20) -> torch.Tensor:
    """Exact fingerprints of the rows of f32 x: each row's bits as int32
    times fixed coefficients below 2^24, summed in int64 (no rounding, no
    overflow at d <= 256, the same in any order)."""
    g = torch.Generator(device=x.device).manual_seed(1)
    coef = torch.randint(1, 1 << 24, (x.shape[1],), generator=g,
                         device=x.device, dtype=torch.int64)
    return torch.cat([
        (x[s:s + chunk].contiguous().view(torch.int32).to(torch.int64)
         * coef).sum(dim=1) for s in range(0, x.shape[0], chunk)])


def timed_s(fn):
    """(fn(), seconds on the host's clock between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_seeding(card, tmp, fused_row) -> dict:
    """[seeding]: each seeding alone at the fused route's points (the
    CLI's make_blobs(seed + 1)), twice from one generator seed: K
    distinct rows of x, bitwise repeats, no kernel launched; then the
    fused route through the CLI with --init=kmeans_parallel."""
    from tdc_tpu_torch.ops.init import init_kmeans_pp
    from tdc_tpu_torch.ops.kmeans_parallel import init_kmeans_parallel

    n, k, d = B1_SHAPE
    x, _ = make_blobs(1, n, d, k, device="cuda")
    hx = row_hashes(x)
    out = {}
    for name, fn in (("kmeans++", init_kmeans_pp),
                     ("kmeans||", init_kmeans_parallel)):
        runs = []
        for _ in range(2):
            gen = torch.Generator(device="cuda").manual_seed(0)
            reset_counts()
            c, secs = timed_s(lambda: fn(gen, x, k))
            require_launches(f"seeding {name}", counts())
            runs.append((c, secs))
        (a, s1), (b, s2) = runs
        require(torch.equal(a, b), f"seeding {name}: not bitwise repeatable")
        hc = row_hashes(a)
        require(int(torch.unique(hc).numel()) == k,
                f"seeding {name}: the {k} seeds are not distinct rows")
        require(bool(torch.isin(hc, hx).all()),
                f"seeding {name}: a seed is not a row of x")
        out[name] = s1
        print(f"[seeding] {name} alone, N={n} K={k} d={d}: {s1:.6f} s "
              f"(again {s2:.6f} s), {k} distinct rows of x, bitwise "
              f"repeatable, no kernel launched; {card}", flush=True)
    del x, hx
    row, seen = run_cli([*MAIN_ARGS, "--init=kmeans_parallel"], tmp,
                        "fused_route_kmeans_parallel")
    n_iter = int(row["n_iter"])
    require(n_iter == 10, f"fused route (k-means‖) ran {n_iter} iterations")
    require_launches("fused route (k-means‖)", seen, B1=2 * (n_iter + 1))
    out["route_s"] = float(row["computation_time"])
    print(f"[seeding] the fused route's computation_time: "
          f"{row['computation_time']} s seeded by k-means‖ against "
          f"{fused_row['computation_time']} s by k-means++ (sse "
          f"{row['sse']} vs {fused_row['sse']}); k-means‖ alone "
          f"{out['kmeans||']:.6f} s, k-means++ alone "
          f"{out['kmeans++']:.6f} s; {card}", flush=True)
    return out


def phase_minibatch(npy, tmp, card) -> dict:
    """[minibatch]: the CLI's --minibatch on the stream route's points
    file, on the kernel route (B1 once per batch and epoch in each of the
    CLI's two fits, no other kernel) and on 'xla' (no kernel): every
    epoch's last-batch SSE within MB_SSE_TOL and shift within
    MB_SHIFT_TOL (relative) of the other's. One step from the first_k
    state on the first batch: B1's labels equal the plain version's but
    at near-ties, and every cluster no differing label touches moves as
    on 'xla' (1e-4). The kernel fit of one epoch repeats bitwise; the
    weighted step launches B4 once per batch."""
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.models import (
        MiniBatchKMeans,
        MiniBatchState,
        minibatch_kmeans_fit,
        minibatch_step,
    )

    rows = -(-STREAM_N // STREAM_BATCHES)
    hist, res = {}, {}
    for kern in ("pallas", "xla"):
        hist[kern] = os.path.join(tmp, f"minibatch_{kern}_history.csv")
        args = [a.replace("--kernel=pallas", f"--kernel={kern}")
                for a in MB_ARGS]
        row, seen, fits = run_cli_captured(
            [*args, f"--data_file={npy}", f"--history_file={hist[kern]}"],
            tmp, f"minibatch_{kern}", "minibatch_kmeans_fit")
        require(int(row["n_iter"]) == MB_EPOCHS
                and row["num_batches"] == str(STREAM_BATCHES),
                f"minibatch_{kern}: row {row}")
        require_launches(f"minibatch_{kern}", seen, **(
            {"B1": 2 * STREAM_BATCHES * MB_EPOCHS} if kern == "pallas"
            else {}))
        res[kern] = (row, fits["minibatch_kmeans_fit"])
    h_p, h_x = (np.loadtxt(hist[k], delimiter=",", skiprows=1)
                for k in ("pallas", "xla"))
    sse_rel = np.abs(h_p[:, 1] / h_x[:, 1] - 1)
    shift_rel = np.abs(h_p[:, 2] / h_x[:, 2] - 1)
    require(h_p.shape == h_x.shape == (MB_EPOCHS, 3)
            and float(sse_rel.max()) <= MB_SSE_TOL
            and float(shift_rel.max()) <= MB_SHIFT_TOL,
            f"minibatch: per-epoch sse rel {sse_rel.tolist()} (tolerance "
            f"{MB_SSE_TOL}), shift rel {shift_rel.tolist()} (tolerance "
            f"{MB_SHIFT_TOL})")
    row = res["pallas"][0]
    gap = (res["pallas"][1].centroids
           - res["xla"][1].centroids).abs().max().item()
    comp = float(row["computation_time"])
    print(f"[minibatch] N={STREAM_N} K={STREAM_K} d={STREAM_D}, "
          f"{STREAM_BATCHES} batches of {rows} rows, {MB_EPOCHS} epochs: "
          f"computation_time {comp} s ({comp / MB_EPOCHS:.4f} s an epoch, "
          f"{row['points_per_sec_per_chip']} pt·iter/s; 'xla' "
          f"{res['xla'][0]['computation_time']} s); per-epoch sse rel "
          f"{sse_rel.round(12).tolist()}, shift rel "
          f"{shift_rel.round(8).tolist()} against 'xla', final centroids "
          f"{gap:.4g} apart; {card}", flush=True)
    host = np.load(npy, mmap_mode="r")
    xb = torch.from_numpy(np.ascontiguousarray(host[:rows])).cuda()
    c0 = xb[:STREAM_K].clone()
    _, lab = lk.lloyd_stats_fused(xb, c0, return_labels=True)
    plain = lk.distance_argmin_plain(xb, c0)[0]
    ties = check_labels("minibatch step", xb, c0, lab, plain)
    diff = lab != plain
    touched = torch.zeros(STREAM_K, dtype=torch.bool, device="cuda")
    touched[lab[diff].long()] = True
    touched[plain[diff].long()] = True
    steps = {}
    for kern in ("pallas", "xla"):
        steps[kern] = minibatch_step(
            MiniBatchState(c0.clone(), torch.zeros(STREAM_K, device="cuda"),
                           0, torch.tensor(float("inf"), device="cuda")),
            xb, kernel=kern)
    keep = ~touched
    a, b = steps["pallas"], steps["xla"]
    err = (a.centroids - b.centroids)[keep].abs().max().item()
    require(err <= 1e-4 and torch.equal(a.counts[keep], b.counts[keep]),
            f"minibatch step: untouched clusters differ by {err}")
    del xb, c0, lab, plain, steps, a, b
    one = [minibatch_kmeans_fit(NpzStream(host, rows), STREAM_K, STREAM_D,
                                init="first_k", epochs=1, tol=-1.0,
                                kernel="pallas") for _ in range(2)]
    require(torch.equal(one[0].centroids, one[1].centroids),
            "minibatch: the kernel fit is not bitwise repeatable")
    w = make_weights(STREAM_N, 5).cpu().numpy()
    mbk = MiniBatchKMeans(STREAM_K, STREAM_D, init="first_k",
                          kernel="pallas", reassignment_ratio=0.01)
    reset_counts()
    for i, b in enumerate(NpzStream(host, rows)()):
        mbk.partial_fit(b, w[i * rows:(i + 1) * rows])
    seen = counts()
    require_launches("minibatch weighted", seen, B4=STREAM_BATCHES)
    require(bool(torch.isfinite(mbk.centroids).all()),
            "minibatch weighted: centroids not finite")
    print(f"[minibatch] one step on the first batch: {ties} labels differ "
          f"from the plain version's, all at near-ties, touching "
          f"{int(touched.sum())} clusters; the other clusters within "
          f"{err:.3g} of 'xla'; one epoch repeats bitwise; weighted (B4) "
          f"launches {seen}; {card}", flush=True)
    return dict(row=row, xla_row=res["xla"][0])


def phase_bisecting(tmp, card) -> dict:
    """[bisecting]: the CLI in memory at N=2^22, K=32 (no kernel: each
    split runs on 'xla'), its computation fit bitwise equal to the
    function called again with the CLI's generator seed; streamed at
    N=2^20 in 4 batches, K=4, its SSE within REL_TOL of the in-memory
    fit's on the same points."""
    from tdc_tpu_torch.models import bisecting_kmeans_fit

    row, seen, fits = run_cli_captured(BIS_ARGS, tmp, "bisecting",
                                       "bisecting_kmeans_fit")
    require_launches("bisecting", seen)
    got = fits["bisecting_kmeans_fit"]
    n, d = B1_SHAPE[0], B1_SHAPE[2]
    x, _ = make_blobs(1, n, d, 32, device="cuda")
    again = bisecting_kmeans_fit(
        x, 32, generator=torch.Generator(device="cuda").manual_seed(0),
        max_iters=10, tol=1e-4)
    del x
    require(torch.equal(again.centroids, got.centroids)
            and float(again.sse) == float(got.sse)
            and again.n_iter == got.n_iter,
            "bisecting: the fit is not bitwise repeatable")
    print(f"[bisecting] in memory, N={n} K=32 d={d}: computation_time "
          f"{row['computation_time']} s, {row['n_iter']} Lloyd iterations "
          f"over 31 splits, sse {row['sse']}, no kernel launched, bitwise "
          f"repeatable; {card}", flush=True)
    rows = {}
    for name, extra in (("bisecting_streamed", ["--num_batches=4"]),
                        ("bisecting_small", [])):
        rows[name], seen = run_cli([*BIS_STREAM_ARGS, *extra], tmp, name)
        require_launches(name, seen)
    st, mem = rows["bisecting_streamed"], rows["bisecting_small"]
    require(st["num_batches"] == "4", f"bisecting_streamed: row {st}")
    rel = abs(float(st["sse"]) / float(mem["sse"]) - 1)
    require(rel <= REL_TOL, f"bisecting: streamed sse {st['sse']} vs "
                            f"{mem['sse']} in memory")
    print(f"[bisecting] streamed, N={1 << 20} K=4 in 4 batches: "
          f"computation_time {st['computation_time']} s (in memory "
          f"{mem['computation_time']} s), sse {st['sse']} vs {mem['sse']} "
          f"in memory (rel {rel:.3g}); {card}", flush=True)
    return dict(row=row, streamed_row=st)


def phase_estimators(tmp, card) -> None:
    """[estimators]: KMeans(kernel='pallas', init='kmeans||') on the fused
    route's points (B1 n_iter_ + 1 times, B2 once for labels_, which equal
    kmeans_predict's); FuzzyCMeans (B6), GaussianMixture (B9) and
    BisectingKMeans at ZOO_N rows, each bitwise equal to its function from
    the same generator seed; save_fitted then load_fitted predicts the
    same labels; the three metrics, bitwise repeatable."""
    from tdc_tpu_torch import (
        BisectingKMeans,
        FuzzyCMeans,
        GaussianMixture,
        KMeans,
        bisecting_kmeans_fit,
        calinski_harabasz_score,
        davies_bouldin_score,
        load_fitted,
        save_fitted,
        silhouette_score,
    )

    n, k, d = B1_SHAPE
    x, _ = make_blobs(1, n, d, k, device="cuda")
    reset_counts()
    est, secs = timed_s(lambda: KMeans(k, kernel="pallas", init="kmeans||",
                                       max_iter=10).fit(x))
    seen = counts()
    require_launches("estimators KMeans", seen, B1=est.n_iter_ + 1, B2=1)
    labels = kmeans_predict(x, est.cluster_centers_).cpu().numpy()
    require(np.array_equal(est.labels_, labels),
            "estimators KMeans: labels_ differ from kmeans_predict")
    print(f"[estimators] KMeans(kernel='pallas', init='kmeans||') N={n} "
          f"K={k} d={d}: fit {secs:.4f} s, n_iter_ {est.n_iter_}, inertia_ "
          f"{est.inertia_:.8g}, launches {seen}, labels_ equal to "
          f"kmeans_predict; {card}", flush=True)
    del x
    xs, _ = make_blobs(2, ZOO_N, d, ZOO_K, device="cuda")

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    checks = (
        ("FuzzyCMeans", lambda: FuzzyCMeans(ZOO_K, kernel="pallas",
                                            max_iter=20).fit(xs),
         lambda: fuzzy_cmeans_fit(xs, ZOO_K, generator=gen(), max_iters=20,
                                  kernel="pallas").centroids,
         "cluster_centers_", {"B6": None}),
        ("GaussianMixture", lambda: GaussianMixture(ZOO_K, kernel="pallas",
                                                    max_iter=20).fit(xs),
         lambda: gmm_fit(xs, ZOO_K, generator=gen(), max_iters=20,
                         kernel="pallas").means,
         "means_", {"B9": None}),
        ("BisectingKMeans", lambda: BisectingKMeans(ZOO_K,
                                                    max_iter=10).fit(xs),
         lambda: bisecting_kmeans_fit(xs, ZOO_K, generator=gen(),
                                      max_iters=10).centroids,
         "cluster_centers_", {}),
    )
    for name, fit_est, fit_fn, attr, kernels in checks:
        reset_counts()
        e = fit_est()
        seen = counts()
        for key in kernels:
            require(seen[key] > 0, f"estimators {name}: {key} not launched")
        want = fit_fn().cpu().numpy()
        require(np.array_equal(getattr(e, attr), want),
                f"estimators {name}: not equal to its function")
        print(f"[estimators] {name} N={ZOO_N} K={ZOO_K} d={d}: n_iter_ "
              f"{e.n_iter_}, equal to its function bitwise, launches "
              f"{seen}; {card}", flush=True)
    small = KMeans(ZOO_K, kernel="pallas", init="kmeans||").fit(xs)
    model_dir = os.path.join(tmp, "fitted")
    version = save_fitted(model_dir, model="kmeans",
                          arrays={"centroids": small.cluster_centers_})
    fm = load_fitted(model_dir)
    require(fm.version == version and np.array_equal(
        kmeans_predict(xs, fm.centroids).cpu().numpy(), small.predict(xs)),
        "persist: the loaded model predicts other labels")
    scores = {}
    for fn in (silhouette_score, davies_bouldin_score,
               calinski_harabasz_score):
        (a, secs) = timed_s(lambda: fn(xs, small.labels_))
        require(math.isfinite(a) and fn(xs, small.labels_) == a,
                f"{fn.__name__}: {a} not finite or not repeatable")
        scores[fn.__name__] = (a, secs)
    print(f"[estimators] save_fitted / load_fitted (version {version}) "
          f"predicts the same labels; metrics at N={ZOO_N} K={ZOO_K}: "
          + ", ".join(f"{name} {v:.8g} ({s:.4f} s)"
                      for name, (v, s) in scores.items())
          + f", each bitwise repeatable; {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    card = smi()
    print(f"[device] {card}", flush=True)

    kl = _build.load()
    print(f"[build] {kl.build_seconds:.1f} s -> {kl.path.name}", flush=True)
    for source, kernel, regs, spills in ptxas_table(kl.log):
        print(f"[build] {source} {kernel}: {regs} registers, spill stores/"
              f"loads {spills} bytes")
    # B10's instantiations (its streaming form, one per d, dtype and warp
    # count, and its tile form) must not spill.
    b10_rows = [r for r in ptxas_table(kl.log) if "tall_lloyd" in r[1]]
    for _, kernel, _, spills in b10_rows:
        require(spills == "0/0", f"B10: {kernel} spills {spills} bytes")
    require(bool(b10_rows) or not kl.log,
            "B10: no ptxas line for its kernels in the build log")

    gen = torch.Generator(device="cuda").manual_seed(0)
    numbers = phase_kernels(gen)
    numbers["B6"] = phase_fuzzy_kernel(gen)
    numbers["B4"] = phase_weighted_kernel(gen)
    numbers["B9"] = phase_gmm_kernel(gen)
    numbers["B5"] = phase_bf16_kernel(gen)
    numbers.update(phase_tall_kernel(gen))
    numbers.update(phase_twopass_kernel(gen))
    print(f"[kernels] {json.dumps(numbers)}", flush=True)
    phase_ties(gen)
    phase_bf16_ties(gen)
    phase_tall_ties(gen)

    with tempfile.TemporaryDirectory() as tmp:
        row, seen = run_cli(MAIN_ARGS, tmp, "fused_route")
        fused_row = row
        n_iter = int(row["n_iter"])
        require(n_iter == 10, f"fused route ran {n_iter} iterations")
        # Two fits (initialization and computation), n_iter + 1 stats each.
        require_launches("fused route", seen, B1=2 * (n_iter + 1))
        numbers["B1"]["launches"] = seen["B1"]

        row, seen = run_cli(SORTED_ARGS, tmp, "sorted_route")
        n_iter = int(row["n_iter"])
        require_launches("sorted route", seen, B2=2 * (n_iter + 1),
                         B3=2 * (n_iter + 1))
        numbers["B2"]["launches"] = seen["B2"]
        numbers["B3"]["launches"] = seen["B3"]
        numbers["B12"]["launches"] = phase_fused_gather_step()

        # The fuzzy route: its row's sse column holds the objective J_m.
        # Seeding (k-means++) runs no kernel.
        row, seen = run_cli(FUZZY_ARGS, tmp, "fuzzy_route")
        n_iter = int(row["n_iter"])
        require(n_iter == 10, f"fuzzy route ran {n_iter} iterations")
        require_launches("fuzzy route", seen, B6=2 * (n_iter + 1))
        numbers["B6"]["launches"] = seen["B6"]

        # The weighted routes: the same CLI runs with a weight file.
        for route_args, name in ((MAIN_ARGS, "weighted_fused_route"),
                                 (SORTED_ARGS, "weighted_sorted_route")):
            n_obs = int(route_args[1].split("=")[1])
            wfile = os.path.join(tmp, f"{name}_w.npy")
            np.save(wfile, make_weights(n_obs, n_obs).cpu().numpy())
            row, seen = run_cli([*route_args, f"--weight_file={wfile}"],
                                tmp, name)
            n_iter = int(row["n_iter"])
            if name == "weighted_fused_route":
                require(n_iter == 10, f"{name} ran {n_iter} iterations")
                require_launches(name, seen, B4=2 * (n_iter + 1))
                numbers["B4"]["launches"] = seen["B4"]
            else:
                require_launches(name, seen, B2=2 * (n_iter + 1),
                                 B3=2 * (n_iter + 1))

        # The GMM route: its row's sse column holds the mean
        # log-likelihood; seeding (k-means++) and the hard-assignment
        # moments run no kernel.
        row, seen = run_cli(GMM_ARGS, tmp, "gmm_route")
        n_iter = int(row["n_iter"])
        require(n_iter == 10, f"gmm route ran {n_iter} iterations")
        require_launches("gmm route", seen, B9=2 * (n_iter + 1))
        numbers["B9"]["launches"] = seen["B9"]

        # The bf16 routes: --dtype bfloat16 on a bf16 data file, written
        # without ml_dtypes as a uint16 view saved as '|V2' (how numpy
        # stores an ml_dtypes bfloat16 array), and pallas_bf16 on f32
        # points. Seeding (k-means++) runs no kernel.
        xfile = os.path.join(tmp, "bf16.npy")
        xb, _ = make_blobs(1, B1_SHAPE[0], B1_SHAPE[2], B1_SHAPE[1],
                           device="cuda", dtype=torch.bfloat16)
        np.save(xfile, xb.view(torch.int16).cpu().numpy().view(np.dtype("V2")))
        del xb
        for route_args, name in (
                ([a for a in BF16_ARGS if not a.startswith(("--n_obs",
                                                            "--n_dim"))]
                 + [f"--data_file={xfile}"], "bf16_route"),
                (MXU_ARGS, "bf16_mxu_route")):
            row, seen = run_cli(route_args, tmp, name)
            n_iter = int(row["n_iter"])
            require(n_iter == 10, f"{name} ran {n_iter} iterations")
            require_launches(name, seen, B5=2 * (n_iter + 1))
            if name == "bf16_route":
                numbers["B5"]["launches"] = seen["B5"]
        os.remove(xfile)

        # The tall routes: --layout=features at the reference sweep's
        # shape; seeding (k-means++ on the first 2^18 columns) runs no
        # kernel.
        for route_args, name, key in (
                (TALL_ARGS, "tall_route", "B10"),
                (TALL_FUZZY_ARGS, "tall_fuzzy_route", "B11"),
                (TALL_BF16_ARGS, "tall_bf16_route", "B10")):
            row, seen = run_cli(route_args, tmp, name)
            n_iter = int(row["n_iter"])
            require(n_iter == 20 and row["kernel"] == "tall",
                    f"{name}: {n_iter} iterations, kernel {row['kernel']!r}")
            require_launches(name, seen, **{key: 2 * (n_iter + 1)})
            if name != "tall_bf16_route":
                numbers[key]["launches"] = seen[key]
        # The .fm.npy file route: a sample-major .npy of the CLI's blobs,
        # converted once by to_feature_major, read back as it is.
        npy = os.path.join(tmp, "points.npy")
        fm = os.path.join(tmp, "points.fm.npy")
        xs, _ = make_blobs(1, FM_N, TALL_SHAPE[2], TALL_SHAPE[1],
                           device="cuda")
        np.save(npy, xs.cpu().numpy())
        del xs
        to_feature_major(npy, fm)
        os.remove(npy)
        row, seen = run_cli(
            [a for a in TALL_ARGS if not a.startswith(("--n_obs", "--n_dim"))]
            + [f"--data_file={fm}"], tmp, "tall_fm_file_route")
        n_iter = int(row["n_iter"])
        require(n_iter == 20 and row["kernel"] == "tall"
                and int(row["n_obs"]) == FM_N,
                f"tall_fm_file_route: row {row}")
        require_launches("tall_fm_file_route", seen, B10=2 * (n_iter + 1))
        os.remove(fm)

        # The multi-GPU routes: two ranks on the one card. First the
        # K-sharded fuzzy route, B7 and B8 on each rank's K-shard; then
        # the same fit in this process on a 1x1 grid from the same init
        # (the CLI's rank 0 draws it on the first 65,536 of its points,
        # make_blobs(seed + 1), with a generator seeded with the seed).
        row, seen, _ = run_ranks(SHARD_ARGS, tmp, "sharded_fuzzy_route")
        n_iter = int(row["n_iter"])
        require(n_iter == 4, f"sharded fuzzy route ran {n_iter} iterations")
        for rank, per_rank in enumerate(seen):
            require_launches(f"sharded fuzzy route, rank {rank}", per_rank,
                             B7=2 * (n_iter + 1), B8=2 * (n_iter + 1))
        numbers["B7"]["launches"] = seen[0]["B7"]
        numbers["B8"]["launches"] = seen[0]["B8"]
        print(f"[sharded_fuzzy_route] computation time "
              f"{row['computation_time']} s for {n_iter} iterations (before "
              f"B8's redesign: {SHARDED_FUZZY_EARLIER_S} s)", flush=True)
        x, _ = make_blobs(1, SORTED_N, SORTED_D, SORTED_K, device="cuda")
        init = _resolve_init_sharded(
            x, SORTED_K, "random", torch.Generator(device="cuda").manual_seed(0))
        one = fuzzy_fit_sharded(x, SORTED_K, make_mesh_2d(1, 1), init=init,
                                max_iters=4, tol=-1, kernel="pallas")
        rel = abs(float(row["sse"]) - float(one.objective)) / abs(
            float(one.objective))
        require(one.n_iter == n_iter and rel <= REL_TOL,
                f"sharded fuzzy route: n_iter {n_iter} vs {one.n_iter}, "
                f"objective {row['sse']} vs {float(one.objective)}")
        print(f"[sharded_fuzzy_route] against one process on a 1x1 grid: "
              f"n_iter {n_iter} == {one.n_iter}, objective {row['sse']} vs "
              f"{float(one.objective):.8g} (rel {rel:.3g})", flush=True)
        del x, init, one
        phase_sharded_kmeans()
        # The data-parallel fused route: B1 on each rank's half of the
        # rows, against the one-GPU fused route's row.
        row, seen, _ = run_ranks(DP_ARGS, tmp, "dp_fused_route")
        n_iter = int(row["n_iter"])
        for rank, per_rank in enumerate(seen):
            require_launches(f"dp fused route, rank {rank}", per_rank,
                             B1=2 * (n_iter + 1))
        rel = abs(float(row["sse"]) - float(fused_row["sse"])) / float(
            fused_row["sse"])
        require(n_iter == int(fused_row["n_iter"]) and rel <= REL_TOL,
                f"dp fused route: n_iter {n_iter}, sse {row['sse']} vs the "
                f"one-GPU route's {fused_row['sse']}")
        print(f"[dp_fused_route] against the one-GPU fused route: n_iter "
              f"{n_iter} == {fused_row['n_iter']}, sse {row['sse']} vs "
              f"{fused_row['sse']} (rel {rel:.3g})", flush=True)

        # The streamed routes (--num_batches), the mini-batch route and the
        # OOM-adaptive retry.
        phase_streams(tmp)

        # The rest of data parallel: the GMM and relocation on a mesh,
        # the quantized per-pass reduces, the hierarchical mesh.
        phase_dp_rest(tmp, card)

        # The model zoo: seeding, bisecting, the estimators.
        phase_seeding(card, tmp, fused_row)
        phase_bisecting(tmp, card)
        phase_estimators(tmp, card)

    phase_one_rank_nccl(gen)

    # The sorted route on bf16 rows: B2 on the widened rows with the
    # centroids rounded to bf16, B3 on the gathered f32 rows; the same
    # stats, bitwise, as the f32 route on those operands.
    x, c = blob_data(gen, BF16_SORTED_N, SORTED_K, SORTED_D)
    xb = x.to(torch.bfloat16)
    del x
    reset_counts()
    got = lk.lloyd_stats_auto(xb, c)
    seen = counts()
    require_launches("bf16 sorted", seen, B2=1, B3=1)
    repeatable("bf16 sorted against the widened operands", got,
               lk.lloyd_stats_auto(*lk.widened(xb, c)))
    require(math.isfinite(float(got.sse))
            and float(got.counts.sum()) == BF16_SORTED_N,
            f"bf16 sorted: sse {float(got.sse)}, counts {got.counts.sum()}")
    print(f"[bf16_sorted] N={BF16_SORTED_N} K={SORTED_K} d={SORTED_D}: "
          f"launches {seen}, stats equal to the widened f32 route's, sse "
          f"{float(got.sse):.8g}", flush=True)
    del xb, c, got

    # Phase 14: predict with B2 on 2^20 points.
    x, c = blob_data(gen, 1 << 20, SORTED_K, SORTED_D)
    before = lk.distance_argmin.launches
    lab = kmeans_predict(x, c, kernel="pallas")
    require(lk.distance_argmin.launches == before + 1, "predict: no B2 launch")
    ties = check_labels("predict", x, c, lab,
                        lk.distance_argmin_plain(x, c)[0])
    print(f"[predict] N={x.shape[0]} labels equal the plain version's "
          f"except {ties} near-ties", flush=True)
    del x, c, lab

    # Phase 15: whole fit, kernel against plain, same init.
    x, c = blob_data(gen, 1 << 16, B1_SHAPE[1], B1_SHAPE[2])
    init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
    fits = {kern: kmeans_fit(x, c.shape[0], init=init, max_iters=50,
                             tol=1e-4, kernel=kern)
            for kern in ("pallas", "xla")}
    a, b = fits["pallas"], fits["xla"]
    require(a.n_iter == b.n_iter and a.converged == b.converged,
            f"fit parity: n_iter {a.n_iter} vs {b.n_iter}")
    cerr = (a.centroids - b.centroids).abs().max().item()
    require(cerr <= 1e-4, f"fit parity: centroids differ by {cerr}")
    print(f"[fit] N=65536 K=1024 d=128: n_iter {a.n_iter} == {b.n_iter}, "
          f"converged {a.converged}, max centroid diff {cerr:.3g}, sse "
          f"{float(a.sse):.8g} vs {float(b.sse):.8g}", flush=True)
    w = make_weights(x.shape[0], 3)
    reset_counts()
    fits = {kern: kmeans_fit(x, c.shape[0], init=init, max_iters=50,
                             tol=1e-4, kernel=kern, sample_weight=w)
            for kern in ("pallas", "xla")}
    require(lk.lloyd_stats_fused_weighted.launches
            == fits["pallas"].n_iter + 1, "weighted fit: B4 did not carry it")
    a, b = fits["pallas"], fits["xla"]
    require(a.n_iter == b.n_iter and a.converged == b.converged,
            f"weighted fit parity: n_iter {a.n_iter} vs {b.n_iter}")
    cerr = (a.centroids - b.centroids).abs().max().item()
    require(cerr <= 1e-4, f"weighted fit parity: centroids differ by {cerr}")
    print(f"[weighted_fit] N=65536 K=1024 d=128: n_iter {a.n_iter} == "
          f"{b.n_iter}, converged {a.converged}, max centroid diff "
          f"{cerr:.3g}, sse {float(a.sse):.8g} vs {float(b.sse):.8g}",
          flush=True)
    fits = {kern: fuzzy_cmeans_fit(x, c.shape[0], init=init, max_iters=30,
                                   tol=1e-3, kernel=kern)
            for kern in ("pallas", "xla")}
    a, b = fits["pallas"], fits["xla"]
    require(a.n_iter == b.n_iter and a.converged == b.converged,
            f"fuzzy fit parity: n_iter {a.n_iter} vs {b.n_iter}")
    cerr = (a.centroids - b.centroids).abs().max().item()
    require(cerr <= 1e-4, f"fuzzy fit parity: centroids differ by {cerr}")
    print(f"[fuzzy_fit] N=65536 K=1024 d=128 m=2: n_iter {a.n_iter} == "
          f"{b.n_iter}, converged {a.converged}, max centroid diff "
          f"{cerr:.3g}, objective {float(a.objective):.8g} vs "
          f"{float(b.objective):.8g}", flush=True)

    # GMM: n_iter and converged equal, means within 1e-4, the mean
    # log-likelihood within 1e-5 relative (f32 sums in another order).
    for cov in ("diag", "spherical"):
        reset_counts()
        fits = {kern: gmm_fit(x, c.shape[0], init=init, max_iters=30,
                              tol=1e-4, covariance_type=cov, kernel=kern)
                for kern in ("pallas", "xla")}
        a, b = fits["pallas"], fits["xla"]
        require(gk.gmm_stats_fused.launches == a.n_iter + 1,
                f"gmm fit ({cov}): B9 did not carry it")
        require(a.n_iter == b.n_iter and a.converged == b.converged,
                f"gmm fit parity ({cov}): n_iter {a.n_iter} vs {b.n_iter}")
        merr = (a.means - b.means).abs().max().item()
        require(merr <= 1e-4, f"gmm fit parity ({cov}): means differ by "
                              f"{merr}")
        lla, llb = float(a.log_likelihood), float(b.log_likelihood)
        require(abs(lla - llb) <= 1e-5 * abs(llb),
                f"gmm fit parity ({cov}): log-likelihood {lla} vs {llb}")
        print(f"[gmm_fit] N=65536 K=1024 d=128 {cov}: n_iter {a.n_iter} == "
              f"{b.n_iter}, converged {a.converged}, max mean diff "
              f"{merr:.3g}, log-likelihood {lla:.8g} vs {llb:.8g}",
              flush=True)

    # bf16 K-Means: B5 on the card against the same fit on the CPU, where
    # the kernel route runs B5's plain version ('xla' is another function
    # on bf16 points: it promotes them against f32 centroids).
    xb = x.to(torch.bfloat16)
    reset_counts()
    a = kmeans_fit(xb, c.shape[0], init=init, max_iters=50, tol=1e-4,
                   kernel="pallas")
    require(lk.lloyd_stats_fused_bf16.launches == a.n_iter + 1,
            "bf16 fit: B5 did not carry it")
    b = kmeans_fit(xb.cpu(), c.shape[0], init=init.cpu(), max_iters=50,
                   tol=1e-4, kernel="pallas", device="cpu")
    require(a.n_iter == b.n_iter and a.converged == b.converged,
            f"bf16 fit parity: n_iter {a.n_iter} vs {b.n_iter}")
    cerr = (a.centroids.cpu() - b.centroids).abs().max().item()
    require(cerr <= 1e-4, f"bf16 fit parity: centroids differ by {cerr}")
    print(f"[bf16_fit] N=65536 K=1024 d=128 bf16 rows: n_iter {a.n_iter} == "
          f"{b.n_iter} (CPU plain), converged {a.converged}, max centroid "
          f"diff {cerr:.3g}, sse {float(a.sse):.8g} vs {float(b.sse):.8g}",
          flush=True)

    # Feature-major fits: B10 and B11 on the card against the same fits
    # on the CPU (their plain versions), from the same init.
    xt, c = tall_blobs(gen, 1 << 16, TALL_SHAPE[1], TALL_SHAPE[2])
    init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
    for fit, kw, key in ((kmeans_fit, {}, "B10"),
                         (fuzzy_cmeans_fit, {"m": 2.0}, "B11")):
        reset_counts()
        a = fit(xt, c.shape[0], init=init, max_iters=50, tol=1e-4,
                layout="features", **kw)
        require(WRAPPERS[key].launches == a.n_iter + 1,
                f"tall fit: {key} did not carry it")
        b = fit(xt.cpu(), c.shape[0], init=init.cpu(), max_iters=50,
                tol=1e-4, layout="features", device="cpu", **kw)
        require(a.n_iter == b.n_iter and a.converged == b.converged,
                f"tall fit parity ({key}): n_iter {a.n_iter} vs {b.n_iter}")
        cerr = (a.centroids.cpu() - b.centroids).abs().max().item()
        require(cerr <= 1e-4, f"tall fit parity ({key}): centroids differ "
                              f"by {cerr}")
        print(f"[tall_fit] {key} N=65536 K={c.shape[0]} d={c.shape[1]}: "
              f"n_iter {a.n_iter} == {b.n_iter} (CPU plain), converged "
              f"{a.converged}, max centroid diff {cerr:.3g}", flush=True)
    del xt, c, init

    src = "tdc_tpu_torch/csrc/"
    meta = {
        "B1": ("lloyd_stats_fused", src + "lloyd_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:484"),
        "B2": ("distance_argmin", src + "lloyd_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:226"),
        "B3": ("segment_sums", src + "segment_sums.cu",
               "tdc_tpu/ops/sorted_stats.py:134"),
        "B4": ("lloyd_stats_fused_weighted", src + "lloyd_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:613"),
        "B5": ("lloyd_stats_fused_bf16", src + "lloyd_bf16_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:405"),
        "B6": ("fuzzy_stats_fused", src + "fuzzy_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:764"),
        "B7": ("fuzzy_normalizer", src + "fuzzy_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:1160"),
        "B8": ("fuzzy_accumulate", src + "fuzzy_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:1215"),
        "B9": ("gmm_stats_fused", src + "gmm_kernels.cu",
               "tdc_tpu/ops/pallas_kernels.py:1408"),
        "B10": ("lloyd_stats_tall", src + "tall_kernels.cu",
                "tdc_tpu/ops/tall.py:172"),
        "B11": ("fuzzy_stats_tall", src + "tall_kernels.cu",
                "tdc_tpu/ops/tall.py:299"),
        "B12": ("gathered_segment_sums", src + "segment_sums.cu",
                "tdc_tpu/ops/sorted_stats.py:292"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        m = numbers[key]
        require(m["launches"] > 0, f"{key} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": m["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m.get("library_ms"),
            # B1, B2, B4, B6, B7, B9, B11: bound_ms is the tensor-core
            # bound (3xTF32), this the f32-pipe one.
            **({"bound_f32_ms": m["bound_f32_ms"], "bound_form": "3xTF32"}
               if "bound_f32_ms" in m else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
