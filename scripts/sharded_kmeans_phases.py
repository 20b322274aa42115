"""Where the time of the K-sharded K-Means fit goes on one NVIDIA GPU.

    python3 scripts/sharded_kmeans_phases.py

Times `kmeans_fit_sharded(kernel="pallas")` of the PyTorch/CUDA port
(tdc_tpu_torch/parallel/sharded_k.py) at N=2^19, K=16,384, d=768, 4
iterations (tol < 0), from chip_smoke.py's init for this route: twice in
this process on a 1x1 grid, then twice on each of two spawned ranks
sharing the card on a (1, 2) grid (gloo on the card's tensors), after
the kernels are built in this process. Within each fit it sums, with a
device synchronise before and after each call, the time of B2
(`distance_argmin`), of the sorted stats (sort, gather and B3), of every
all_reduce (`Mesh.psum`: the champion buffers, the stats, the shift, Σ‖x‖²)
and of the set-up collectives (`replicate`, `shard_points`,
`_whole_centroids`). On two ranks each part also holds its waits for
the other rank's work on the shared card, so the parts bound each share
from above. B2 at K/2 alone is timed too (three calls). Prints one line per
fit, then the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tdc_tpu_torch.ops import _build  # noqa: E402
from tdc_tpu_torch.ops import lloyd_kernels as lk  # noqa: E402
from tdc_tpu_torch.ops import sorted_stats as ss  # noqa: E402
from tdc_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from tdc_tpu_torch.parallel import sharded_k as sk  # noqa: E402

PARTS: dict = {}


def timed(name, fn):
    """fn with its synchronised wall time added to PARTS[name]."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        PARTS[name] = PARTS.get(name, 0.0) + time.perf_counter() - t0
        PARTS[name + "_calls"] = PARTS.get(name + "_calls", 0) + 1
        return out
    run.launches = 0  # the kernel wrapper counts through its module name
    return run


# Module attributes, so the spawned ranks (which import this file as
# their main module) time the same calls.
lk.distance_argmin = timed("B2", lk.distance_argmin)
ss.sorted_cluster_stats = timed("sorted_stats", ss.sorted_cluster_stats)
tmesh.Mesh.psum = timed("all_reduce", tmesh.Mesh.psum)
for _name in ("replicate", "shard_points", "_whole_centroids"):
    setattr(sk, _name, timed("setup", getattr(sk, _name)))


def fit(x, init, mesh) -> tuple[float, dict]:
    PARTS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk.kmeans_fit_sharded(x, cs.SORTED_K, mesh, init=init,
                          max_iters=cs.SORTED_ITERS, tol=-1, kernel="pallas")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(PARTS)


def rank_main(rank, world, port, args, queue) -> None:
    cs._rank_env(rank, world, port)
    try:
        cs.multihost.initialize_from_env()
        try:
            x, _ = cs.make_blobs(1, cs.SORTED_N, cs.SORTED_D, cs.SORTED_K,
                                 device="cuda")
            init = cs.sharded_kmeans_init(x)
            mesh = sk.make_mesh_2d(1, world)
            out = [fit(x, init, mesh) for _ in range(2)]
        finally:
            cs.multihost.shutdown()
        queue.put((rank, 0, out))
    except BaseException:
        queue.put((rank, -1, traceback.format_exc()))


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_kmeans_phases: no CUDA device", file=sys.stderr)
        return 2
    _build.load()  # the ranks load this build instead of compiling
    x, _ = cs.make_blobs(1, cs.SORTED_N, cs.SORTED_D, cs.SORTED_K,
                         device="cuda")
    init = cs.sharded_kmeans_init(x)
    for rep in range(2):
        seconds, parts = fit(x, init, sk.make_mesh_2d(1, 1))
        print(json.dumps({"grid": [1, 1], "rep": rep, "seconds": seconds,
                          "parts": parts}), flush=True)
    c = init[:cs.SORTED_K // 2].contiguous()
    alone = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk.distance_argmin(x, c)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t0)
    print(json.dumps({"B2_half_K_seconds": alone}), flush=True)
    del x, c, init
    for rank, runs in enumerate(cs.spawn_ranks(rank_main, None, "phases")):
        for rep, (seconds, parts) in enumerate(runs):
            print(json.dumps({"grid": [1, cs.RANKS], "rank": rank,
                              "rep": rep, "seconds": seconds,
                              "parts": parts}), flush=True)
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
