"""Experiment CLI — the reference-parity subset of tdc_tpu/cli/main.py
for Lloyd K-Means, Fuzzy C-Means, Gaussian Mixture EM and bisecting
K-Means, on one GPU or on several.

Same flags (where ported), the same three timed phases (setup; a first fit
counted as initialization; a warm re-fit counted as computation), the
same CSV row and the same summary line, with `backend` = 'cuda' or 'cpu'
(a fuzzy row's `sse` column holds the objective J_m and a
gaussianMixture row's the mean log-likelihood, as in the JAX CLI).
Errors land in the CSV as an error row and exit 1. Every fit runs under
the OOM-adaptive retry (`data/batching.oom_adaptive`, reference
:357-360): a CUDA out-of-memory error frees the attempt's device memory
and runs the fit again, streamed, on twice the batches; the row's
`num_batches` is the count that finished. No other error is retried.

Streamed (`--num_batches` > 1, `--streamed`): the exact streamed fits
(`models/streaming.py`, `models/gmm.streamed_gmm_fit`) over
ceil(n_obs / num_batches)-row batches of host points, copied to the card
batch by batch; `--weight_file` streams alongside. `--mean_combine` runs
the reference's approximation instead (an independent fit per batch,
centroids averaged; distributedKMeans). `--reduce=per_pass` all-reduces
once per pass instead of once per batch on several GPUs, and
`--reduce=per_pass:bf16` or `:int8` also quantizes the (K, d) sums on
the wire with error feedback (kmeans, fuzzy and gaussianMixture);
`--prefetch`
reads batches on a background thread; `--history_file` writes the
per-iteration [cost, shift] CSV of a K-Means or fuzzy fit.
`--residency=hbm` (kmeans/fuzzy, streamed) keeps the batches on the card
after the first pass and runs the later iterations over them;
`--residency=spill` copies them through pinned buffers on a copy stream,
ahead of the compute; `--residency=auto` takes hbm where the card's budget
holds the dataset (the batch rows then capped to what the cache leaves,
a `residency_batch_cap` event), else spill, else streams.

Data plane (streamed kmeans/fuzzy): --data_manifest=URL streams a blob
manifest (`data/store.py`: a manifest.json over http(s)://, file:// or a
path; the geometry, dtype and batch rows are the manifest's; with
--store_base a relative URL resolves against it, --store_timeout is the
HTTP read deadline), every batch CRC-checked; --native_loader streams an
.npy --data_file through the C++ prefetch loader
(`data/native_loader.py`). Every streamed kmeans/fuzzy fit reads through
the ingest guard (`data/ingest.py`): --io_retries, --io_backoff and
--io_deadline retry transient read failures, and --max_bad_fraction is
the share of a pass's rows that quarantined batches may take before the
fit aborts (default 0: the first quarantine aborts).

Checkpoints: --ckpt_dir=DIR runs the fit streamed (the in-memory fits
take no checkpoint; one batch is the in-memory case) and saves it there
(`utils/checkpoint.py`, the JAX package's state.npz format), resuming
from the newest step a rerun finds: the streamed K-Means, fuzzy and
gaussianMixture fits per iteration, --minibatch per epoch.
--ckpt_every_batches=N (kmeans/fuzzy) also saves mid-pass every N
batches, so a resume is bit-identical; --ckpt_keep_last_n=N keeps the
newest N steps. A checkpointed run times its one fit as the computation
(a warm re-fit would resume the finished run), and its points per second
count the iterations that run ran (n_iter_run). As in the JAX CLI, no
preemption handler is installed (utils/preempt.py is the library's).

Run: python -m tdc_tpu_torch.cli.main --method_name=distributedKMeans \
     --n_obs=4194304 --n_dim=128 --K=1024 --kernel=pallas --log_file=log.csv
Streamed: add --num_batches=8 (or --data_file=x.npy, memory-mapped).
Fuzzy: --method_name=distributedFuzzyCMeans --fuzzifier=2.0
Bisecting: --method_name=bisectingKMeans (K−1 weighted 2-means splits on
'xla', each seeded by k-means++; streamed with --num_batches/--streamed).
Mini-batch: --minibatch (distributedKMeans; one Sculley step per batch,
--n_max_iters epochs over ceil(n_obs / num_batches)-row batches, or rows
from the card's memory, `auto_batch_size`, when --num_batches is 1; on
the CPU, which has no device memory to size against, one batch of every
row), with --reassignment_ratio (sklearn's low-count reseed, default
0.01). --init=kmeans_parallel seeds with k-means‖.
GMM: --method_name=gaussianMixture --covariance_type=diag (diag,
spherical, tied or full; --kernel=pallas runs the E-step kernel B9, diag
or spherical and unweighted; --init=kmeans seeds with a short K-Means)
Sample weights: --weight_file=w.npy, an (N,) .npy of nonnegative weights
(K-Means on --kernel=pallas or xla; Fuzzy C-Means and gaussianMixture on
xla). The CSV row has no weight column, as in the JAX CLI.
bf16: --dtype bfloat16 holds one 2-byte copy of the points on the device
(K-Means --kernel=pallas then runs B5, the bf16 tensor-core kernel);
--kernel=pallas_bf16 runs B5 on f32 points (K-Means only, unweighted). A
bfloat16 --data_file (ml_dtypes arrays saved with np.save/np.savez) stays
bfloat16 under either --dtype, as the JAX CLI passes it through uncast.
Feature-major: --layout=features stores the points (d, N) and runs B10
(K-Means) or B11 (Fuzzy C-Means) for every stats call, on synthetic data
or a --data_file (a `*.fm.npy` is read as it is, any other file is
transposed); the CSV row's `kernel` is then 'tall'. --layout=auto (the
default) runs the samples layout: the JAX CLI's auto picks features only
on a TPU.
Several GPUs: one process per GPU, e.g. `torchrun --nproc_per_node=4 -m
tdc_tpu_torch.cli.main --n_GPUs=4 ...` (--n_GPUs must equal the launch's
world size). distributedKMeans, distributedFuzzyCMeans and
gaussianMixture then run data parallel (each rank fits its block of rows,
the stats are all-reduced; gaussianMixture on the torch E-step, as
--kernel=pallas is single-device);
--shard_k=P shards the K centroids over an (n_GPUs/P, P) grid of ranks
(the K=16,384 regime, BASELINE config 5): distributedKMeans always runs
the streamed K-sharded tower (`parallel.sharded_k.
streamed_kmeans_fit_sharded`; in memory that is one batch; --kernel=pallas:
B2 + B3 on each shard), distributedFuzzyCMeans the in-memory tower
(`fuzzy_fit_sharded`, B7 + B8), or the streamed one with --num_batches,
--streamed or --ckpt_dir, and gaussianMixture (diag) the in-memory
tower (`gmm_fit_sharded`, plain products: no kernel) or, with
--num_batches, --streamed or --ckpt_dir, the streamed one
(`streamed_gmm_fit_sharded`). --block_rows is the rows of a block on
'xla' (-1: sized from the card's memory, 0: none); --reduce=per_pass,
--ckpt_dir, --ckpt_every_batches, --residency (each rank caches its data
coordinate's rows: the cache is replicated across the model axis) and
--data_manifest apply as in the 1-D streamed fits of kmeans and fuzzy,
and the OOM-adaptive retry doubles the batches of the streamed tower.
E.g. `torchrun --nproc_per_node=2 -m
tdc_tpu_torch.cli.main --method_name=distributedKMeans --shard_k=2
--n_GPUs=2 --n_obs=2000000 --n_dim=768 --K=16384 --num_batches=4
--dtype=bfloat16 --kernel=pallas`. Every rank builds the same points;
rank 0 alone writes the CSV row and prints the summary. --device cpu
runs the ranks on gloo.
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings

METHOD_NAMES = ("distributedKMeans", "distributedFuzzyCMeans",
                "gaussianMixture", "bisectingKMeans")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tdc_tpu_torch",
        description="K-Means, Fuzzy C-Means, Gaussian Mixture EM and "
                    "bisecting K-Means on NVIDIA GPUs "
                    "(PyTorch + CUDA kernels)",
    )
    p.add_argument("--n_obs", type=int, default=None,
                   help="number of observations (generates synthetic data "
                        "unless --data_file is given)")
    p.add_argument("--n_dim", type=int, default=None, help="dimensionality")
    p.add_argument("--K", type=int, required=True, help="number of clusters")
    p.add_argument("--n_GPUs", "--n_devices", dest="n_devices", type=int,
                   default=None,
                   help="devices to use: one rank each, so it must equal "
                        "the launch's world size (default: that size); "
                        "more than 1 needs a distributed launch "
                        "(torchrun --nproc_per_node=N)")
    p.add_argument("--shard_k", type=int, default=1,
                   help="model-axis size: shard the K centroids this many "
                        "ways over an (n_GPUs/shard_k, shard_k) grid of "
                        "ranks (the K=16,384 regime; distributedKMeans "
                        "streamed, distributedFuzzyCMeans in memory or "
                        "streamed; requires n_GPUs %% shard_k == 0 and "
                        "K %% shard_k == 0)")
    p.add_argument("--block_rows", type=int, default=-1,
                   help="N-block rows inside each shard for --shard_k "
                        "(-1 = auto from device memory, 0 = no blocking)")
    p.add_argument("--num_batches", type=int, default=1,
                   help="initial serial batch count; doubled on OOM "
                        "(reference :357-360 semantics); > 1 streams")
    p.add_argument("--streamed", action="store_true",
                   help="force exact streamed Lloyd even if data fits")
    p.add_argument("--minibatch", action="store_true",
                   help="Sculley-style mini-batch K-Means (BASELINE config 3): "
                        "one update per batch, n_max_iters epochs; batch size "
                        "from device memory unless --num_batches is given")
    p.add_argument("--reassignment_ratio", type=float, default=0.01,
                   help="mini-batch low-count-center reseed threshold "
                        "(sklearn MiniBatchKMeans parity; 0 disables)")
    p.add_argument("--mean_combine", action="store_true",
                   help="reference-parity batch mode: independent Lloyd per "
                        "batch, unweighted mean of per-batch centers "
                        "(reference :310 approximation; kmeans only)")
    p.add_argument("--reduce", type=str, default="per_batch",
                   choices=("per_batch", "per_pass", "per_pass:bf16",
                            "per_pass:int8"),
                   help="cross-GPU stats reduction of the streamed fits: "
                        "'per_pass' all-reduces once per iteration instead "
                        "of once per batch (f32 summation reorder); "
                        "':bf16'/':int8' additionally quantize the (K, d) "
                        "sums on the wire with error feedback (1-D meshes "
                        "of several GPUs only)")
    p.add_argument("--residency", type=str, default="stream",
                   choices=("stream", "auto", "hbm", "spill"),
                   help="streamed kmeans/fuzzy dataset residency "
                        "(data/device_cache.py): 'hbm' caches the padded "
                        "batches in device memory during iteration 1 and "
                        "runs iterations 2..N as an eager loop over the "
                        "cached batches, with no batch copied after pass "
                        "1; 'spill' stages each batch through pinned "
                        "buffers on a copy stream, 2 slots ahead of "
                        "compute (data/spill.py — the over-budget tier, "
                        "bit-exact with plain streaming); 'auto' picks "
                        "hbm when dataset + accumulators fit the "
                        "device's budget, spill when only "
                        "a slot ring fits, and falls back to streaming "
                        "(loudly) when neither does")
    p.add_argument("--gather", type=str, default="fp32",
                   choices=("fp32", "fp32_sharded", "bf16", "int8"),
                   help="model-axis collective strategy of the K-sharded "
                        "kmeans/fuzzy towers: 'fp32' only (the others, "
                        "parallel/gather.py, are not ported: they raise)")
    p.add_argument("--native_loader", action="store_true",
                   help="stream batches through the C++ prefetch loader "
                        "(requires --data_file pointing at an .npy)")
    p.add_argument("--data_manifest", type=str, default=None,
                   help="stream batches from a sharded object-store "
                        "manifest (data/store.py): http(s):// URL, "
                        "file:// URL, or local path of a manifest.json "
                        "(or its directory). Geometry/dtype/batching come "
                        "from the manifest — batch size is its batch_rows "
                        "(--num_batches cannot override it) — ranged blob "
                        "reads are CRC-checked and routed through the "
                        "ingest guard's retry/quarantine ladder; every "
                        "rank of a mesh opens every batch. Streamed "
                        "kmeans/fuzzy only (--streamed)")
    p.add_argument("--store_timeout", type=float, default=None,
                   help="with --data_manifest: socket deadline in seconds "
                        "per ranged read on the HTTP backend (default 10; "
                        "a stalled read surfaces as a transient timeout "
                        "the --io_retries ladder owns)")
    p.add_argument("--store_base", type=str, default=None,
                   help="base URL/directory a relative --data_manifest "
                        "resolves against (one configured bucket, many "
                        "datasets)")
    # Defaults live in one place, data/ingest.IngestPolicy: None here
    # means "not set on the command line".
    p.add_argument("--io_retries", type=int, default=None,
                   help="streamed kmeans/fuzzy: transient stream-read "
                        "failures retried per batch read with exponential "
                        "backoff + jitter (data/ingest.py; 0 disables "
                        "retry; permanent failures never retry; "
                        "default 2)")
    p.add_argument("--io_backoff", type=float, default=None,
                   help="base retry backoff seconds (attempt n sleeps "
                        "~base * 2^(n-1) with deterministic jitter; "
                        "default 0.05)")
    p.add_argument("--io_deadline", type=float, default=None,
                   help="wall-clock budget in seconds for one batch read "
                        "including retries (default: none)")
    p.add_argument("--max_bad_fraction", type=float, default=None,
                   help="largest fraction of a pass's rows the ingest "
                        "quarantine may drop before the fit aborts loudly. "
                        "The strict default 0.0 aborts on ANY quarantined "
                        "batch — raise only when bounded data loss is "
                        "acceptable and monitored")
    p.add_argument("--prefetch", type=int, default=0,
                   help="streamed modes: background-thread batch prefetch "
                        "depth (0 = off)")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="checkpoint/resume directory: runs the fit streamed, "
                        "saves centroids+iteration (the JAX package's "
                        "state.npz format) and resumes if present. "
                        "Checkpoints are size-portable (layout manifest + "
                        "full host arrays): a save taken at N GPUs resumes "
                        "at M")
    p.add_argument("--ckpt_every_batches", type=int, default=None,
                   help="with --ckpt_dir: also checkpoint mid-pass every N "
                        "batches (accumulator + batch cursor; resume is "
                        "bit-identical; kmeans/fuzzy)")
    p.add_argument("--ckpt_keep_last_n", type=int, default=None,
                   help="with --ckpt_dir (streamed kmeans/fuzzy): retain "
                        "only the newest N checkpoint steps (default all; "
                        "N >= 2 keeps the corruption-fallback step)")
    p.add_argument("--history_file", type=str, default=None,
                   help="write per-iteration (cost, shift) CSV "
                        "(kmeans/fuzzy)")
    p.add_argument("--n_max_iters", type=int, default=20,
                   help="iteration cap (reference default 20)")
    p.add_argument("--seed", type=int, default=123128,
                   help="seed of the data and init generators")
    p.add_argument("--log_file", type=str, default=None,
                   help="append-only results CSV (header auto-created)")
    p.add_argument("--method_name", type=str, default="distributedKMeans")
    p.add_argument("--data_file", type=str, default=None,
                   help=".npz (keys X,Y) or .npy points file")
    p.add_argument("--tol", type=float, default=1e-4,
                   help="convergence tolerance: centroid shift (kmeans/"
                        "fuzzy) or mean log-likelihood gain "
                        "(gaussianMixture); negative = fixed n_max_iters "
                        "(reference parity)")
    p.add_argument("--init", type=str, default="kmeans++",
                   choices=("kmeans++", "kmeans_parallel", "random",
                            "first_k", "kmeans"),
                   help="'kmeans' (gaussianMixture only): seed means with a "
                        "short multi-restart K-Means fit")
    p.add_argument("--kernel", type=str, default=None,
                   choices=("xla", "pallas", "pallas_bf16", "refined",
                            "auto", "auto:quantized"),
                   help="sufficient-stats path: 'xla' = plain PyTorch ops "
                        "(default); 'pallas' = the hand-written CUDA "
                        "kernels (K-Means: B1 fused, B5 on bf16 points, or "
                        "B2 + B3 sorted past the fused limit; fuzzy: B6; "
                        "gaussianMixture: B9, diag/spherical); "
                        "'pallas_bf16' = B5 on f32 points too: bf16 cross "
                        "operands on the tensor cores, f32 stats (K-Means "
                        "only, unweighted); 'refined' = exact-distance "
                        "champion refinement (K-Means only); 'auto' = "
                        "pallas on CUDA, xla on CPU; 'auto:quantized' = "
                        "auto, plus permission to pick pallas_bf16")
    p.add_argument("--fuzzifier", type=float, default=2.0,
                   help="fuzzy c-means m (explicit, > 1; "
                        "distributedFuzzyCMeans only)")
    p.add_argument("--covariance_type", type=str, default="diag",
                   choices=("diag", "spherical", "tied", "full"),
                   help="gaussianMixture covariance parameterization "
                        "(sklearn parity)")
    p.add_argument("--spherical", action="store_true",
                   help="cosine K-Means (normalize points and centroids)")
    p.add_argument("--empty_policy", type=str, default="keep",
                   choices=("keep", "relocate"))
    p.add_argument("--dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="device dtype of the points (bfloat16: one 2-byte "
                        "copy; the K-Means kernel route runs B5)")
    p.add_argument("--class_sep", type=float, default=1.5)
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="'cuda' (default; fails without a card) or 'cpu' "
                        "(plain PyTorch versions of the kernels)")
    p.add_argument("--run_log", type=str, default=None,
                   help="append structured JSONL run events here")
    p.add_argument("--weight_file", type=str, default=None,
                   help=".npy of (N,) nonnegative per-point sample weights "
                        "(sklearn sample_weight parity; in-memory and "
                        "streamed, single-device)")
    p.add_argument("--layout", type=str, default="auto",
                   choices=("auto", "samples", "features"),
                   help="device storage of the points: 'features' stores "
                        "them (d, N) and runs the tall kernels (B10, B11; "
                        "kmeans/fuzzy, in-memory, unweighted, default "
                        "kernel); a '*.fm.npy' --data_file is read as it "
                        "is. 'auto' = samples (the JAX CLI's auto picks "
                        "features only on a TPU)")
    return p


def _validate_weight_file(parser, args) -> None:
    """The JAX CLI's --weight_file checks, as parser errors."""
    import numpy as np

    if not os.path.exists(args.weight_file):
        parser.error(f"weight file does not exist: {args.weight_file}")
    if args.kernel == "refined":
        parser.error("--kernel=refined does not support --weight_file")
    if args.kernel == "pallas" and args.method_name != "distributedKMeans":
        parser.error("--kernel=pallas --weight_file is distributedKMeans "
                     "only (fuzzy weighted stats are the f32 plain path)")
    try:
        shape = np.load(args.weight_file, mmap_mode="r").shape
    except (ValueError, OSError, AttributeError) as e:
        parser.error(f"--weight_file must be an (N,) .npy: {e}")
    if len(shape) != 1 or (args.data_file is None
                           and shape[0] != args.n_obs):
        want = "N" if args.data_file else args.n_obs
        parser.error(f"weight file has shape {shape}; expected ({want},)")


def _streamy(args) -> bool:
    """Whether the first attempt already streams (a checkpointed fit
    always does)."""
    return (args.streamed or args.num_batches > 1 or args.mean_combine
            or args.ckpt_dir is not None)


def _validate_checkpoints(parser, args) -> None:
    """The JAX CLI's checks of the checkpoint flags, in its words, and
    the port's refusals of a flag that would be silently ignored."""
    if args.ckpt_dir and args.mean_combine:
        # mean_combine has no checkpoint support; accepting the flag would
        # silently skip checkpointing.
        parser.error("--ckpt_dir is not supported with --mean_combine")
    if args.ckpt_keep_last_n is not None:
        if args.ckpt_keep_last_n < 1:
            parser.error("--ckpt_keep_last_n must be >= 1")
        if not args.ckpt_dir:
            parser.error("--ckpt_keep_last_n requires --ckpt_dir")
        if (args.minibatch or args.shard_k > 1
                or args.method_name == "gaussianMixture"):
            parser.error("--ckpt_keep_last_n applies to the 1-D streamed "
                         "kmeans/fuzzy fits only")
    if args.ckpt_every_batches is not None:
        if args.ckpt_every_batches < 1:
            parser.error("--ckpt_every_batches must be >= 1")
        if not args.ckpt_dir:
            parser.error("--ckpt_every_batches requires --ckpt_dir")
        if args.method_name == "gaussianMixture":
            parser.error("gaussianMixture checkpoints per iteration only "
                         "(--ckpt_every_batches is kmeans/fuzzy)")
        if args.minibatch:
            parser.error("--minibatch checkpoints per epoch only "
                         "(--ckpt_every_batches is kmeans/fuzzy)")


def _validate_streaming(parser, args) -> None:
    """The JAX CLI's checks of the streamed flags, in its words; the
    options that are not ported name their ROADMAP.md item."""
    if args.num_batches < 1:
        parser.error("--num_batches must be >= 1")
    if args.prefetch < 0:
        parser.error("--prefetch must be >= 0")
    if args.minibatch and args.shard_k > 1:
        parser.error("--minibatch and --shard_k are mutually exclusive")
    if args.mean_combine:
        if args.method_name != "distributedKMeans":
            parser.error("--mean_combine supports distributedKMeans only")
        if args.minibatch or args.shard_k > 1:
            parser.error("--mean_combine excludes --minibatch/--shard_k")
    if args.empty_policy != "keep":
        for flag in ("minibatch", "streamed", "mean_combine", "ckpt_dir"):
            if getattr(args, flag):
                parser.error(f"--empty_policy=relocate is in-memory only; "
                             f"--{flag} is not supported (mini-batch has "
                             "its own --reassignment_ratio policy)")
        if args.num_batches > 1 or args.shard_k > 1:
            parser.error("--empty_policy=relocate is in-memory single-shard")
    if args.kernel == "refined":
        for flag in ("minibatch", "streamed", "mean_combine", "ckpt_dir"):
            if getattr(args, flag):
                parser.error(f"--kernel=refined is the in-memory exact-"
                             f"champion path; --{flag} is not supported")
        if args.num_batches > 1 or args.shard_k > 1:
            parser.error("--kernel=refined is in-memory single-shard "
                         "(use it for iters-to-converge parity runs)")
    if args.kernel == "pallas_bf16":
        for flag in ("minibatch", "mean_combine"):
            if getattr(args, flag):
                parser.error(f"--kernel=pallas_bf16 has no --{flag} "
                             f"plumbing (the epilogue lives in the fused "
                             f"Lloyd stats kernel)")
        if (args.num_batches > 1 and not args.streamed) or args.shard_k > 1:
            parser.error("--kernel=pallas_bf16 is single-shard (in-memory "
                         "or --streamed)")
    if args.layout == "features":
        for flag in ("streamed", "minibatch", "mean_combine", "ckpt_dir",
                     "native_loader"):
            if getattr(args, flag):
                parser.error(f"--layout=features is an in-memory device "
                             f"layout; --{flag} is not supported with it")
        if args.num_batches > 1 or args.shard_k > 1:
            parser.error("--layout=features is single-batch, single-shard "
                         "(it exists to make the full dataset fit in HBM)")
    if args.weight_file and (args.minibatch or args.mean_combine):
        parser.error("--weight_file is not supported with "
                     "--minibatch/--mean_combine/--shard_k")
    if not (0 <= args.reassignment_ratio <= 1):
        parser.error("--reassignment_ratio must be in [0, 1]")
    if args.reassignment_ratio != 0.01 and not args.minibatch:
        # Reject rather than silently ignore: the flag only drives the
        # mini-batch reseed policy.
        parser.error("--reassignment_ratio applies to --minibatch only")


def _validate_devices(parser, args) -> None:
    """--n_GPUs against the launch, and --shard_k."""
    from tdc_tpu_torch.parallel.multihost import launched_world_size

    world = launched_world_size()
    n = args.n_devices
    if n is not None and n < 1:
        parser.error("--n_GPUs must be >= 1")
    if (args.method_name == "gaussianMixture" and args.kernel == "pallas"
            and n is not None and n > 1 and args.shard_k <= 1):
        # The JAX CLI's parse-time check (the launch is checked after;
        # --shard_k has its own words below).
        parser.error("--kernel=pallas gaussianMixture is single-device")
    if n is not None and n > 1 and world == 1:
        parser.error(
            f"--n_GPUs={n} runs one process per GPU: launch them with "
            f"`torchrun --nproc_per_node={n} -m tdc_tpu_torch.cli.main "
            f"--n_GPUs={n} ...` (or set RANK, WORLD_SIZE, MASTER_ADDR and "
            "MASTER_PORT for each process)")
    if n is not None and world > 1 and n != world:
        parser.error(f"--n_GPUs={n} but this launch has {world} ranks; "
                     "they must be equal (one rank per GPU)")
    n = n or world
    if (args.shard_k > 1 and _streamy(args)
            and args.reduce.startswith("per_pass:")):
        # The JAX CLI's words (its K-sharded streamed drivers run per_batch
        # and per_pass only).
        parser.error("--reduce=per_pass:bf16|int8 applies to the 1-D "
                     "streamed fits; --shard_k supports "
                     "--reduce=per_batch|per_pass")
    if args.shard_k < 1:
        parser.error("--shard_k must be >= 1")
    if args.block_rows < -1:
        parser.error("--block_rows must be >= -1 (-1 = auto)")
    if args.block_rows != -1 and args.shard_k <= 1:
        # Refused rather than silently ignored: the 1-D fits size their
        # blocks themselves.
        parser.error("--block_rows applies to the K-sharded towers "
                     "(--shard_k)")
    if args.shard_k > 1:
        if args.K % args.shard_k != 0:
            parser.error(f"--K={args.K} not divisible by "
                         f"--shard_k={args.shard_k}")
        if args.method_name == "gaussianMixture":
            # The JAX CLI's words: the GMM shard tower is plain products,
            # seeded from a host subsample, with no history.
            if args.kernel == "pallas":
                parser.error("--shard_k --kernel=pallas is kmeans/fuzzy "
                             "only (the GMM shard tower is an XLA matmul "
                             "step)")
            if args.history_file:
                parser.error("--shard_k --history_file is kmeans/fuzzy "
                             "only (the GMM shard tower records no "
                             "per-iteration history)")
            if args.init == "kmeans":
                parser.error("--shard_k gaussianMixture seeds from a host "
                             "subsample; --init=kmeans (a full K-Means "
                             "pre-fit) is the unsharded mode")
        if args.weight_file:
            parser.error("--weight_file is not supported with "
                         "--minibatch/--mean_combine/--shard_k")
    if args.gather != "fp32":
        if args.shard_k <= 1:
            parser.error("--gather applies to the K-sharded drivers "
                         "(model-axis collectives only exist there); add "
                         "--shard_k")
        if args.method_name == "gaussianMixture":
            parser.error("--gather is kmeans/fuzzy only (the GMM shard "
                         "tower keeps the replicated M-step)")
    if (args.shard_k > 1 and args.method_name == "gaussianMixture"
            and args.covariance_type != "diag"):
        parser.error("--shard_k gaussianMixture is diag-covariance only")
    if args.kernel == "pallas_bf16" and n > 1:
        parser.error("--kernel=pallas_bf16 is single-device (no "
                     "shard_map tower; cast inputs to bf16 with "
                     "--kernel=pallas for the same MXU precision)")


def _validate_bisecting(parser, args) -> None:
    """The JAX CLI's bisectingKMeans checks, in its words: each split is
    a weighted 2-means on the plain path, seeded by k-means++."""
    for flag in ("minibatch", "mean_combine", "spherical"):
        if getattr(args, flag):
            parser.error(f"--{flag} is not supported with bisectingKMeans")
    if args.shard_k > 1:
        # The JAX CLI's shard_k check fires first for this method.
        parser.error("--shard_k supports distributedKMeans, "
                     "distributedFuzzyCMeans, and gaussianMixture")
    if args.kernel is not None:
        parser.error("bisectingKMeans has no --kernel selection (each "
                     "split is a weighted XLA-path 2-means)")
    if args.init != "kmeans++":
        parser.error("bisectingKMeans seeds every split with kmeans++; "
                     f"--init={args.init} would be silently ignored")
    if args.history_file:
        parser.error("bisectingKMeans produces no per-iteration "
                     "history (--history_file is kmeans/fuzzy)")
    if args.ckpt_dir or args.ckpt_every_batches:
        parser.error("bisectingKMeans does not checkpoint")


def _validate_data_plane(parser, args) -> None:
    """The JAX CLI's checks of the data-plane flags, in its words (the
    manifest feeds the guarded streamed kmeans/fuzzy fits only)."""
    if args.store_timeout is not None and args.store_timeout <= 0:
        parser.error("--store_timeout must be > 0 seconds")
    if ((args.store_timeout is not None or args.store_base)
            and not args.data_manifest):
        parser.error("--store_timeout/--store_base require --data_manifest")
    if args.data_manifest:
        if args.data_file or args.native_loader:
            parser.error("--data_manifest replaces --data_file/"
                         "--native_loader (the manifest names its own "
                         "blobs)")
        if args.method_name not in ("distributedKMeans",
                                    "distributedFuzzyCMeans"):
            parser.error("--data_manifest feeds the guarded streamed "
                         "kmeans/fuzzy drivers only")
        if not args.streamed:
            parser.error("--data_manifest requires --streamed (the "
                         "object-store tier is a streaming data plane; "
                         "batch size comes from the manifest)")
        if args.num_batches > 1:
            parser.error("--data_manifest takes its batching from the "
                         "manifest's batch_rows (the per-slice CRCs are "
                         "computed at that granularity); --num_batches "
                         "cannot override it")
        if args.minibatch or args.mean_combine:
            parser.error("--data_manifest supports the exact streamed "
                         "drivers only (not --minibatch/--mean_combine)")
        if args.layout == "features":
            parser.error("--data_manifest streams sample-major batches; "
                         "--layout=features is an in-memory device layout")
        if args.weight_file:
            parser.error("--data_manifest has no weight stream aligned "
                         "to manifest batches; drop --weight_file")


def _validate_ingest(parser, args) -> None:
    """--native_loader and the ingest policy's flags (the JAX CLI's
    checks; the loader is refused where it would be silently ignored)."""
    if args.native_loader:
        if not (args.data_file and args.data_file.endswith(".npy")):
            parser.error("--native_loader requires an .npy --data_file")
        # Rejected rather than silently ignored: the loader feeds the
        # streamed kmeans/fuzzy fits (mean_combine too) only.
        if (args.method_name not in ("distributedKMeans",
                                     "distributedFuzzyCMeans")
                or args.minibatch or not _streamy(args)):
            parser.error("--native_loader streams the streamed kmeans/fuzzy "
                         "fits (add --streamed/--num_batches; not "
                         "--minibatch, gaussianMixture or bisectingKMeans)")
    if args.io_retries is not None and args.io_retries < 0:
        parser.error("--io_retries must be >= 0")
    if args.io_backoff is not None and args.io_backoff < 0:
        parser.error("--io_backoff must be >= 0")
    if args.io_deadline is not None and args.io_deadline <= 0:
        parser.error("--io_deadline must be > 0 seconds")
    if args.max_bad_fraction is not None and not (
            0.0 <= args.max_bad_fraction <= 1.0):
        parser.error("--max_bad_fraction must be in [0, 1]")


def validate_args(parser, args) -> None:
    if args.method_name not in METHOD_NAMES:
        parser.error(f"unknown --method_name {args.method_name!r}")
    if (args.data_file is None and args.data_manifest is None
            and (args.n_obs is None or args.n_dim is None)):
        parser.error("either --data_file, --data_manifest, or both "
                     "--n_obs and --n_dim required")
    if args.data_file is not None and not os.path.exists(args.data_file):
        parser.error(f"data file does not exist: {args.data_file}")
    _validate_data_plane(parser, args)
    for name in ("K", "n_max_iters"):
        if getattr(args, name) < 1:
            parser.error(f"--{name} must be >= 1")
    if args.n_obs is not None and args.n_obs < args.K:
        parser.error("--n_obs must be >= --K")
    if args.minibatch and args.method_name != "distributedKMeans":
        parser.error("--minibatch supports distributedKMeans only")
    if args.method_name == "bisectingKMeans":
        _validate_bisecting(parser, args)
    _validate_streaming(parser, args)
    _validate_checkpoints(parser, args)
    _validate_devices(parser, args)
    if args.method_name != "distributedKMeans" and (
            args.spherical or args.empty_policy != "keep"):
        parser.error("--spherical and --empty_policy=relocate are "
                     "distributedKMeans only")
    if args.empty_policy == "relocate" and args.layout == "features":
        parser.error("--empty_policy=relocate needs the sample-major "
                     "layout (--layout=samples)")
    if args.kernel == "refined" and args.method_name != "distributedKMeans":
        parser.error("--kernel=refined is distributedKMeans only")
    if args.kernel == "pallas_bf16":
        # The JAX CLI's parse-time rejections (the in-memory, single-device
        # ones: the port has no streamed or multi-device fit yet).
        if args.method_name != "distributedKMeans":
            parser.error("--kernel=pallas_bf16 is distributedKMeans only "
                         "(the bf16 epilogue exists for the Lloyd stats "
                         "kernel)")
        if args.weight_file:
            parser.error("--kernel=pallas_bf16 does not support "
                         "--weight_file (the weighted epilogue keeps full "
                         "precision)")
    if args.method_name == "gaussianMixture":
        # Reject rather than run the plain E-step under the kernel's name.
        if args.kernel == "pallas" and (
                args.covariance_type not in ("diag", "spherical")
                or args.weight_file):
            parser.error("--kernel=pallas gaussianMixture supports the "
                         "diag/spherical, unweighted E-step only "
                         "(spherical runs the diag kernel with the "
                         "scalar variance broadcast)")
    elif args.init == "kmeans":
        parser.error("--init=kmeans is a gaussianMixture seeding mode")
    elif args.covariance_type != "diag":
        parser.error("--covariance_type applies to gaussianMixture only")
    if args.layout == "features":
        # The JAX CLI's checks for the flags the port has.
        if args.method_name not in ("distributedKMeans",
                                    "distributedFuzzyCMeans"):
            parser.error("--layout=features supports kmeans/fuzzy only")
        if args.weight_file:
            parser.error("--layout=features does not support --weight_file")
        if args.kernel is not None:
            parser.error("--layout=features selects the tall kernel; "
                         "--kernel cannot be combined with it")
    if args.weight_file:
        _validate_weight_file(parser, args)
    _validate_ingest(parser, args)


def run_experiment(args) -> dict:
    """Load/generate data, fit twice (initialization, computation), and
    return the result row dict. Each fit runs under `oom_adaptive`; the
    points stay on the host when a fit streams them (a loaded file, or
    generated points too large for the card's budget) and are copied to
    the card inside the first in-memory fit, so an out-of-memory copy is
    retried streamed like any other out-of-memory fit."""
    import numpy as np
    import torch

    from tdc_tpu_torch.data import (
        NpzStream,
        load_points,
        load_points_feature_major,
        make_blobs,
        oom_adaptive,
    )
    from tdc_tpu_torch.data.batching import auto_batch_size, device_hbm_bytes
    from tdc_tpu_torch.parallel.mesh import make_mesh
    from tdc_tpu_torch.parallel.multihost import process_count
    from tdc_tpu_torch.parallel.sharded_k import make_mesh_2d
    from tdc_tpu_torch.utils.device import resolve_device
    from tdc_tpu_torch.utils.timing import PhaseTimers

    timers = PhaseTimers()
    fuzzy = args.method_name == "distributedFuzzyCMeans"
    gmm = args.method_name == "gaussianMixture"
    bf16 = args.dtype == "bfloat16"
    # 'auto' resolves to samples, as the JAX CLI's does off a TPU.
    features = args.layout == "features"
    with timers.phase("setup") as out:
        n_devices = args.n_devices or process_count()
        if features and n_devices > 1:
            raise ValueError(
                "--layout=features is single-device; pass --n_GPUs=1")
        if gmm and args.kernel == "pallas" and n_devices > 1:
            # The parse-time check sees only an explicit --n_GPUs.
            raise ValueError(
                "--kernel=pallas gaussianMixture is single-device "
                f"(resolved n_devices={n_devices}); pass --n_GPUs=1")
        mesh = mesh2d = None
        if args.shard_k > 1:
            if n_devices % args.shard_k != 0:
                raise ValueError(f"n_devices={n_devices} not divisible by "
                                 f"shard_k={args.shard_k}")
            mesh2d = make_mesh_2d(n_devices // args.shard_k, args.shard_k)
        elif n_devices > 1:
            mesh = make_mesh(n_devices)
        dev = resolve_device(args.device)
        gen_dtype = torch.bfloat16 if bf16 else torch.float32
        manifest = manifest_url = None
        if args.data_manifest:
            # The object-store tier: geometry, dtype and batching come from
            # the manifest; the dataset never lands in host memory.
            from tdc_tpu_torch.data.store import fetch_manifest, resolve_url

            manifest_url = resolve_url(args.data_manifest, args.store_base)
            manifest = fetch_manifest(
                manifest_url,
                **({} if args.store_timeout is None
                   else {"timeout": args.store_timeout}))
            x = None
            n_obs, n_dim = manifest.n_rows, manifest.d
            bf16 = bf16 or manifest.dtype.kind == "V"
        elif args.data_file and features:
            x, _ = load_points_feature_major(args.data_file)
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))
            x = x.to(device=dev, dtype=torch.bfloat16
                     if bf16 or x.dtype == torch.bfloat16 else torch.float32)
            n_dim, n_obs = x.shape
        elif args.data_file:
            # Host points (a .npy is memory-mapped): copied to the card by
            # the first in-memory fit, or batch by batch when streamed. A
            # bf16 file stays bf16 under --dtype float32 too (the JAX CLI
            # hands it to the fit uncast).
            x, _ = load_points(args.data_file)
            bf16 = bf16 or x.dtype == torch.bfloat16
            n_obs, n_dim = x.shape
        else:
            n_obs, n_dim = args.n_obs, args.n_dim
            # Points past 40% of the card's memory are generated on the
            # host (the JAX CLI's rule), where the streamed retry reads
            # them; below it, on the card, as the in-memory fit wants them.
            big = (dev.type == "cuda" and n_obs * n_dim
                   * (2 if bf16 else 4) > 0.4 * device_hbm_bytes(dev))
            x, _ = make_blobs(args.seed + 1, n_obs, n_dim, max(args.K, 2),
                              class_sep=args.class_sep,
                              device="cpu" if big else dev, dtype=gen_dtype,
                              layout="features" if features else "samples")
            if features:
                n_dim, n_obs = x.shape
        out["block_on"] = x if isinstance(x, torch.Tensor) else None
        weights = None
        if args.weight_file:
            weights = np.load(args.weight_file)
            if weights.shape != (n_obs,):
                raise ValueError(f"weight file has shape {weights.shape}; "
                                 f"expected ({n_obs},)")

    # The points live only in `state` from here: a streamed retry after an
    # out-of-memory in-memory fit must be able to drop every copy on the
    # card.
    state = {"x": x, "features": features, "device_x": None,
             "stream": None}
    del x

    def host_points():
        """The points on the host, for a streamed fit. The in-memory fits'
        copy on the card is dropped, and points that were on the card come
        back (feature-major ones sample-major), so a streamed fit, a retry
        after an out-of-memory in-memory fit included, keeps no copy of the
        whole dataset on the card."""
        state["device_x"] = None
        xx = state["x"]
        if isinstance(xx, torch.Tensor) and xx.device.type != "cpu":
            xx = xx.cpu()
            if state["features"]:
                xx = xx.T.contiguous()
                state["features"] = False
            state["x"] = xx
        return xx

    def device_points():
        """The points on the card at the fit's dtype, copied once and kept
        for the computation fit."""
        if state["device_x"] is None:
            xx = state["x"]
            if not isinstance(xx, torch.Tensor):
                # A memory map is read-only: the CPU fit gets a copy, the
                # card's copy reads it directly.
                xx = np.array(xx) if dev.type == "cpu" else xx
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    xx = torch.from_numpy(xx)
            dtype = (torch.bfloat16 if bf16 or xx.dtype == torch.bfloat16
                     else torch.float32)
            state["device_x"] = xx.to(device=dev, dtype=dtype)
        return state["device_x"]

    def stream_itemsize() -> int:
        """The bytes of one element of the streamed points: 2 for bf16
        points (a bf16 file, or --dtype bfloat16), which the streamed fits
        copy and cache as they are; 4 for any other, which they stage as
        f32."""
        if manifest is not None:
            return 2 if manifest.dtype.kind == "V" else 4
        xx = state["x"]
        return 2 if getattr(xx, "dtype", None) == torch.bfloat16 else 4

    def residency_rows(rows: int, itemsize: int,
                       n_cache_devices: int | None = None) -> int:
        """The batch rows under --residency=auto|hbm: a cache that holds
        the whole dataset for the fit leaves the batches' working set only
        the rest of the budget, so rows above what the rest holds are
        capped (a `residency_batch_cap` event); otherwise the fill pass
        runs out of memory and the retry halves batches against a budget
        that never fits. The JAX CLI's rule: the cache and the model-state
        copies `plan_residency` reserves come out of the budget first; no
        cap where they do not fit (the plan then streams, or forces the
        cache and abandons it loudly), nor under 'spill' (its ring holds
        (slots + 1) batches, not the dataset). The cache bytes here are
        unpadded: the planner, which sees the padded batches, decides.
        `n_cache_devices` is how many ways the cache divides: the
        K-sharded towers' is replicated across the model axis, so they
        pass the data axis, n_devices // shard_k."""
        if args.residency in ("stream", "spill"):
            return rows
        from tdc_tpu_torch.data.batching import (
            planner_budget_bytes,
            rows_in_budget,
        )
        from tdc_tpu_torch.data.device_cache import state_reserve_bytes
        from tdc_tpu_torch.utils.structlog import emit

        pinned = (-(-n_obs * n_dim * itemsize
                    // max(n_cache_devices or n_devices, 1))
                  + state_reserve_bytes(args.K, n_dim))
        budget = planner_budget_bytes(dev)
        if pinned >= budget:
            return rows
        cap = rows_in_budget(
            budget, n_dim, args.K, n_devices=n_devices, itemsize=itemsize,
            kernel="pallas" if args.kernel == "pallas" else "xla",
            resident_bytes=pinned)
        if rows > cap:
            emit("residency_batch_cap", rows=rows, cap=cap,
                 resident_bytes=pinned)
            return cap
        return rows

    def make_stream(rows: int):
        """The streamed kmeans/fuzzy fits' batch source: the manifest
        (`rows` ignored: the manifest fixes batch_rows, the CRCs'
        granularity; every rank opens every batch), the C++ loader over
        the .npy, or the host points."""
        if manifest is not None:
            from tdc_tpu_torch.data.store import open_manifest_stream

            return open_manifest_stream(
                manifest_url, spec=mesh,
                **({} if args.store_timeout is None
                   else {"timeout": args.store_timeout}))
        if args.native_loader:
            from tdc_tpu_torch.data.native_loader import NativePrefetchStream

            return NativePrefetchStream(args.data_file, rows)
        return NpzStream(host_points(), rows)

    def fit(num_batches: int):
        from tdc_tpu_torch.models import (
            bisecting_kmeans_fit,
            fuzzy_cmeans_fit,
            gmm_fit,
            kmeans_fit,
            mean_combine_fit,
            minibatch_kmeans_fit,
            streamed_bisecting_kmeans_fit,
            streamed_fuzzy_fit,
            streamed_gmm_fit,
            streamed_kmeans_fit,
        )
        streamed = (args.streamed or num_batches > 1 or args.mean_combine
                    or args.ckpt_dir is not None)
        bisecting = args.method_name == "bisectingKMeans"
        if args.reduce != "per_batch" and (
                not streamed or args.mean_combine or args.minibatch
                or bisecting or (mesh2d is not None and gmm)):
            # Fail fast instead of silently ignoring the knob (the JAX
            # CLI's words).
            raise SystemExit(
                f"--reduce={args.reduce} applies to the streamed "
                "kmeans/fuzzy/gaussianMixture drivers (add "
                "--streamed/--num_batches); in-memory fits already "
                "reduce once per iteration, and mean_combine/minibatch/"
                "bisecting/--shard_k gaussianMixture take no strategy")
        if args.residency != "stream":
            # The JAX CLI's refusals: no resident loop on these paths.
            if (not streamed or args.mean_combine or args.minibatch
                    or args.method_name in ("bisectingKMeans",
                                            "gaussianMixture")):
                raise SystemExit(
                    f"--residency={args.residency} applies to the streamed "
                    "kmeans/fuzzy drivers (add --streamed/--num_batches); "
                    "in-memory fits are already device-resident, and "
                    "gaussianMixture/bisecting/mean_combine/minibatch "
                    "have no resident loop")
            if args.residency == "hbm" and args.ckpt_every_batches:
                raise SystemExit(
                    "--residency=hbm is incompatible with "
                    "--ckpt_every_batches: the compiled on-device loop has "
                    "no mid-pass boundaries to checkpoint at — drop one, "
                    "or use --residency=auto to prefer mid-pass durability")
        from tdc_tpu_torch.data.ingest import IngestPolicy

        overrides = {name: val for name, val in (
            ("io_retries", args.io_retries),
            ("io_backoff", args.io_backoff),
            ("io_deadline", args.io_deadline),
            ("max_bad_fraction", args.max_bad_fraction)) if val is not None}
        if overrides and (not streamed or args.mean_combine
                          or args.minibatch or args.method_name in (
                              "bisectingKMeans", "gaussianMixture")):
            # Fail fast instead of silently ignoring knobs on a path that
            # never routes through the ingest guard (the JAX CLI's words).
            raise SystemExit(
                "--io_retries/--io_backoff/--io_deadline/"
                "--max_bad_fraction apply to the streamed kmeans/fuzzy "
                "drivers (add --streamed/--num_batches); "
                "gaussianMixture/bisecting/mean_combine/minibatch "
                "streams are not routed through the ingest guard")
        ingest = IngestPolicy(**overrides)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        kernel = args.kernel or "xla"
        history = args.history_file is not None
        if mesh2d is not None:
            return sharded_fit(num_batches, streamed, gen, ingest)
        if args.minibatch:
            # Batches of the host points: ceil(n_obs / num_batches) rows,
            # or as many as the card's working-set budget holds (the whole
            # set on the CPU, which has no device memory to size against).
            if num_batches > 1 or dev.type == "cpu":
                rows = -(-n_obs // num_batches)
            else:
                rows = min(auto_batch_size(n_dim, args.K,
                                           n_devices=n_devices,
                                           kernel=kernel, device=dev),
                           n_obs)
            stream = NpzStream(host_points(), rows)
            state["stream"] = stream
            return minibatch_kmeans_fit(
                stream, args.K, n_dim, init=args.init, generator=gen,
                epochs=args.n_max_iters, tol=args.tol, mesh=mesh,
                prefetch=args.prefetch,
                reassignment_ratio=args.reassignment_ratio,
                ckpt_dir=args.ckpt_dir, kernel=kernel, device=dev)
        if streamed:
            rows = (manifest.batch_rows if manifest is not None
                    else residency_rows(-(-n_obs // num_batches),
                                        stream_itemsize()))
            stream = (make_stream(rows) if not (bisecting or gmm)
                      else NpzStream(host_points(), rows))
            state["stream"] = stream
            wstream = (None if weights is None
                       else NpzStream(np.asarray(weights, np.float32), rows))
            if bisecting:
                return streamed_bisecting_kmeans_fit(
                    stream, args.K, n_dim, generator=gen,
                    max_iters=args.n_max_iters, tol=args.tol,
                    prefetch=args.prefetch, sample_weight_batches=wstream,
                    mesh=mesh, device=dev)
            common = dict(generator=gen, max_iters=args.n_max_iters,
                          tol=args.tol, mesh=mesh, prefetch=args.prefetch,
                          kernel=kernel, device=dev)
            if args.mean_combine:
                return mean_combine_fit(stream, args.K, n_dim,
                                        init=args.init,
                                        spherical=args.spherical, **common)
            common.update(sample_weight_batches=wstream, reduce=args.reduce,
                          ckpt_dir=args.ckpt_dir)
            if gmm:
                return streamed_gmm_fit(
                    stream, args.K, n_dim, init=args.init,
                    covariance_type=args.covariance_type, **common)
            common.update(ckpt_every_batches=args.ckpt_every_batches,
                          ckpt_keep_last_n=args.ckpt_keep_last_n,
                          residency=args.residency, ingest=ingest)
            if fuzzy:
                return streamed_fuzzy_fit(stream, args.K, n_dim,
                                          m=args.fuzzifier, init=args.init,
                                          **common)
            return streamed_kmeans_fit(stream, args.K, n_dim,
                                       init=args.init,
                                       spherical=args.spherical, **common)
        state["stream"] = None
        xx = device_points()
        if bisecting:
            return bisecting_kmeans_fit(
                xx, args.K, generator=gen, max_iters=args.n_max_iters,
                tol=args.tol, sample_weight=weights, mesh=mesh, device=dev)
        if gmm:
            return gmm_fit(
                xx, args.K, init=args.init, generator=gen,
                max_iters=args.n_max_iters, tol=args.tol, mesh=mesh,
                covariance_type=args.covariance_type, sample_weight=weights,
                kernel=kernel, device=dev,
            )
        layout = "features" if state["features"] else "samples"
        if fuzzy:
            return fuzzy_cmeans_fit(
                xx, args.K, m=args.fuzzifier, init=args.init, generator=gen,
                max_iters=args.n_max_iters, tol=args.tol, kernel=kernel,
                sample_weight=weights, layout=layout, mesh=mesh,
                history=history, device=dev,
            )
        return kmeans_fit(
            xx, args.K, init=args.init, generator=gen,
            max_iters=args.n_max_iters, tol=args.tol,
            spherical=args.spherical, kernel=kernel, sample_weight=weights,
            empty_policy=args.empty_policy, layout=layout, mesh=mesh,
            history=history, device=dev,
        )

    def shard_block(rows_per_pass: int) -> int:
        """The K-sharded towers' N-block: --block_rows, or (-1) the size
        that bounds the (block, K/P) intermediates of a data shard's
        rows in the card's memory (0 where they fit whole)."""
        from tdc_tpu_torch.models.kmeans import auto_block_rows

        if args.block_rows >= 0:
            return args.block_rows
        return auto_block_rows(
            -(-rows_per_pass // (n_devices // args.shard_k)),
            args.K // args.shard_k, device=dev)

    def sharded_fit(num_batches: int, streamed: bool, gen, ingest):
        """--shard_k (the JAX CLI's routes): distributedKMeans always
        streams (in memory: one batch); distributedFuzzyCMeans and
        gaussianMixture stream with --num_batches, --streamed or
        --ckpt_dir, else run the in-memory tower. The points stay on the
        host for a streamed fit (an out-of-memory retry's too), cast to
        bf16 batch by batch under --dtype bfloat16. Under --residency
        hbm|auto the batch rows are capped as the cache, replicated
        across the model axis, leaves room (`residency_rows`)."""
        from tdc_tpu_torch.models.kmeans import _not_ported
        from tdc_tpu_torch.parallel.sharded_k import (
            fuzzy_fit_sharded,
            gmm_fit_sharded,
            streamed_fuzzy_fit_sharded,
            streamed_gmm_fit_sharded,
            streamed_kmeans_fit_sharded,
        )

        if args.gather != "fp32":
            raise _not_ported(f"--gather={args.gather}",
                              "Queue A, A9: parallel/gather.py")
        kernel = args.kernel or "xla"
        shard_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
        if gmm:
            common = dict(init=args.init, generator=gen,
                          max_iters=args.n_max_iters, tol=args.tol,
                          dtype=shard_dtype, device=dev)
            if streamed:
                rows = -(-n_obs // num_batches)
                stream = NpzStream(host_points(), rows)
                state["stream"] = stream
                return streamed_gmm_fit_sharded(
                    stream, args.K, n_dim, mesh2d,
                    block_rows=shard_block(rows), prefetch=args.prefetch,
                    ckpt_dir=args.ckpt_dir, **common)
            state["stream"] = None
            return gmm_fit_sharded(device_points(), args.K, mesh2d,
                                   block_rows=shard_block(n_obs), **common)
        if fuzzy and not streamed:
            state["stream"] = None
            return fuzzy_fit_sharded(
                device_points(), args.K, mesh2d, m=args.fuzzifier,
                init=args.init, generator=gen, max_iters=args.n_max_iters,
                tol=args.tol, block_rows=shard_block(n_obs), kernel=kernel,
                device=dev)
        rows = (manifest.batch_rows if manifest is not None
                else residency_rows(-(-n_obs // num_batches),
                                    2 if bf16 else 4,
                                    n_cache_devices=n_devices // args.shard_k))
        stream = make_stream(rows)
        state["stream"] = stream
        common = dict(
            init=args.init, generator=gen, max_iters=args.n_max_iters,
            tol=args.tol, kernel=kernel, block_rows=shard_block(rows),
            dtype=shard_dtype,
            prefetch=args.prefetch, ckpt_dir=args.ckpt_dir,
            ckpt_every_batches=args.ckpt_every_batches, reduce=args.reduce,
            residency=args.residency, ingest=ingest, device=dev)
        if fuzzy:
            return streamed_fuzzy_fit_sharded(
                stream, args.K, n_dim, mesh2d, m=args.fuzzifier, **common)
        return streamed_kmeans_fit_sharded(
            stream, args.K, n_dim, mesh2d, spherical=args.spherical,
            **common)

    def centers(result):
        return result.means if gmm else result.centroids

    # Initialization = the first fit, including the kernels' first-use
    # build and an in-memory fit's copy of the points to the card;
    # computation = a warm re-fit at the batch count that finished, what
    # steady-state clustering costs. A checkpointed fit wrote its last
    # step: a re-fit would resume it and run next to nothing, so its
    # computation is the first fit's time.
    with timers.phase("initialization") as out:
        result, num_batches = oom_adaptive(
            fit, initial_num_batches=args.num_batches)
        out["block_on"] = centers(result)
    if args.ckpt_dir:
        timers.set("computation", timers.get("initialization"))
    else:
        with timers.phase("computation") as out:
            result = fit(num_batches)
            out["block_on"] = centers(result)

    if args.history_file and getattr(result, "history", None) is not None:
        import csv

        with open(args.history_file, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["iteration", "objective" if fuzzy else "sse",
                        "shift"])
            for i, (cost_i, shift_i) in enumerate(
                    np.asarray(result.history), 1):
                w.writerow([i, cost_i, shift_i])

    n_iter = int(result.n_iter)
    n_iter_run = (n_iter if getattr(result, "n_iter_run", None) is None
                  else int(result.n_iter_run))
    comp = timers.get("computation")
    pps = (n_obs * n_iter_run / comp / n_devices) if comp > 0 else float(
        "inf")
    row = {
        "method_name": args.method_name,
        "seed": args.seed,
        "num_GPUs": n_devices,
        "K": args.K,
        "n_obs": n_obs,
        "n_dim": n_dim,
        "setup_time": round(timers.get("setup"), 6),
        "initialization_time": round(timers.get("initialization"), 6),
        "computation_time": round(comp, 6),
        "n_iter": n_iter,
        "n_iter_run": n_iter_run,
        "backend": dev.type,
        "n_chips": n_devices,
        "points_per_sec_per_chip": round(pps, 1),
        "sse": float(result.log_likelihood if gmm
                     else result.objective if fuzzy else result.sse),
        "converged": bool(result.converged),
        "num_batches": num_batches,
        "tol": args.tol,
        "kernel": "tall" if state["features"] else (args.kernel or ""),
        "status": "ok",
    }
    comms = getattr(result, "comms", None)
    if state["stream"] is not None:
        # For the run log, not the CSV: the computation fit's geometry.
        row["_stream"] = {
            "batches": state["stream"].num_batches,
            "passes": None if comms is None else comms.passes,
            "reduces": None if comms is None else comms.reduces}
    return row


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    validate_args(parser, args)

    import torch.distributed as dist

    from tdc_tpu_torch.parallel import multihost

    # A torchrun launch: _run joins its process group, and it is left at
    # the end; a group the caller made stays the caller's.
    owned = not dist.is_initialized()
    try:
        return _run(args)
    finally:
        if owned:
            multihost.shutdown()


def _run(args) -> int:
    """Join the launch's process group (if any) and run the experiment;
    rank 0 alone writes the CSV row (an error row too) and prints the
    summary."""
    from tdc_tpu_torch.parallel import multihost
    from tdc_tpu_torch.utils.logging import append_result_row, error_row
    from tdc_tpu_torch.utils.structlog import RunLog

    runlog = RunLog(args.run_log)
    runlog.event("run_start", method=args.method_name, K=args.K,
                 n_obs=args.n_obs, n_dim=args.n_dim, seed=args.seed,
                 n_devices=args.n_devices)
    base = {
        "method_name": args.method_name,
        "seed": args.seed,
        "num_GPUs": args.n_devices or "",
        "n_chips": args.n_devices or "",
        "K": args.K,
        "n_obs": args.n_obs or "",
        "n_dim": args.n_dim or "",
        "num_batches": args.num_batches,
    }
    rank = int(os.environ.get("RANK", "0"))
    try:
        rank, _ = multihost.initialize_from_env(device=args.device)
        row = run_experiment(args)
    except Exception as e:  # reference :362-377: capture into the CSV, exit 1
        if args.log_file and rank == 0:
            append_result_row(args.log_file, error_row(base, e))
        runlog.event("run_error", error=type(e).__name__, message=str(e)[:500])
        print(f"FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    multihost.barrier()
    if rank != 0:
        return 0
    stream = row.pop("_stream", None)
    if args.log_file:
        append_result_row(args.log_file, row)
    runlog.event("run_ok", **{k: row[k] for k in
                              ("n_iter", "sse", "converged", "computation_time",
                               "points_per_sec_per_chip", "num_batches")},
                 **({} if stream is None else {"stream": stream}))
    print(
        f"{row['method_name']}: n_iter={row['n_iter']} "
        f"sse={row['sse']:.6g} converged={row['converged']} "
        f"computation_time={row['computation_time']}s "
        f"({row['points_per_sec_per_chip']:.3g} pt·iter/s/chip)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
