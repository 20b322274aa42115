"""Where the time of k-means‖ seeding goes on the card, and what its
block form saves.

    python3 scripts/seeding_phases.py [--n N] [--k K] [--d D]

At the fused route's points (make_blobs(1, N, D, K): the CLI's points at
--seed=0; default N=2^22, D=128, K=1024) it times
`ops.kmeans_parallel.init_kmeans_parallel` whole and by part (the rounds'
min-distance passes, the owner pass, the owner mass and the weighted
k-means++ reduce step; host clock between synchronizes) in two forms, in
turns (blocks, masked, masked, blocks) after one untimed run of each:

- blocks: the module as it is (one `addmm` per block with ‖c‖² in its
  epilogue, ‖x‖² and the clamp in place, over the valid candidates);
- masked: every block through `ops.distance.pairwise_sq_dist`, the
  invalid pool slots masked to +inf, ‖x‖² computed per block (the form
  first written).

Both forms must give the same seeds, bitwise. k-means++
(`ops.init.init_kmeans_pp`) is timed beside them. Every seeding draws
from a generator seeded with 0. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tdc_tpu_torch.data import make_blobs  # noqa: E402
from tdc_tpu_torch.ops import kmeans_parallel as kp  # noqa: E402
from tdc_tpu_torch.ops.distance import pairwise_sq_dist  # noqa: E402
from tdc_tpu_torch.ops.init import init_kmeans_pp  # noqa: E402

PARTS = ("_min_sq_dist", "_owner", "segment_sum", "_weighted_kmeans_pp")


def _masked_min(x, x_sq, c, valid, block_rows):
    starts, rows = kp._blocks(x.shape[0], c.shape[0], block_rows)
    out = []
    for s in starts:
        d2 = pairwise_sq_dist(x[s:s + rows], c)
        if valid is not None:
            d2 = d2.masked_fill(~valid, float("inf"))
        out.append(d2.min(dim=1).values)
    return torch.cat(out)


def _masked_owner(x, x_sq, pool, valid, block_rows):
    starts, rows = kp._blocks(x.shape[0], pool.shape[0], block_rows)
    return torch.cat([
        torch.argmin(pairwise_sq_dist(x[s:s + rows], pool).masked_fill(
            ~valid, float("inf")), dim=1) for s in starts])


FORMS = {"blocks": {},
         "masked": {"_min_sq_dist": _masked_min, "_owner": _masked_owner}}


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run(form: str, x, k: int):
    """(seeds, total seconds, seconds by part) of one seeding in `form`."""
    real = {name: getattr(kp, name) for name in PARTS}
    parts = dict.fromkeys(PARTS, 0.0)

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            out, secs = synced(lambda: fn(*args, **kwargs))
            parts[name] += secs
            return out
        return wrapped

    for name in PARTS:
        setattr(kp, name, timed(name, FORMS[form].get(name, real[name])))
    try:
        seeds, total = synced(lambda: kp.init_kmeans_parallel(
            torch.Generator(device="cuda").manual_seed(0), x, k))
    finally:
        for name, fn in real.items():
            setattr(kp, name, fn)
    return seeds, total, parts


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=1 << 22)
    p.add_argument("--k", type=int, default=1024)
    p.add_argument("--d", type=int, default=128)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("seeding_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x, _ = make_blobs(1, args.n, args.d, args.k, device="cuda")
    for form in FORMS:  # warm-up: the allocator's blocks, the libraries'
        run(form, x, args.k)
    seeds = {}
    for form in ("blocks", "masked", "masked", "blocks"):
        c, total, parts = run(form, x, args.k)
        if form in seeds and not torch.equal(seeds[form], c):
            raise AssertionError(f"{form}: seeds not bitwise repeatable")
        seeds[form] = c
        print(f"[seeding] k-means‖ {form} N={args.n} K={args.k} "
              f"d={args.d}: {total:.4f} s; rounds {parts['_min_sq_dist']:.4f}"
              f", owner {parts['_owner']:.4f}, owner mass "
              f"{parts['segment_sum']:.4f}, reduce "
              f"{parts['_weighted_kmeans_pp']:.4f}; {card}", flush=True)
    if not torch.equal(seeds["blocks"], seeds["masked"]):
        rows = int((seeds["blocks"] != seeds["masked"]).any(dim=1).sum())
        raise AssertionError(f"the two forms' seeds differ in {rows} rows")
    _, secs = synced(lambda: init_kmeans_pp(
        torch.Generator(device="cuda").manual_seed(0), x, args.k))
    print(f"[seeding] k-means++ N={args.n} K={args.k} d={args.d}: "
          f"{secs:.4f} s; both k-means‖ forms give the same seeds; {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
