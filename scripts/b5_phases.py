"""Where the time of B5 goes on one NVIDIA GPU.

    python3 scripts/b5_phases.py [--out DIR]

B5 is the bf16 tensor-core Lloyd stats kernel of the PyTorch/CUDA port
(tdc_tpu_torch/csrc/lloyd_bf16_kernels.cu). This script times it at
N=2^22, K=1024, d=128 on f32 and on bf16 rows in three builds:

- full: the kernel as it is;
- no_accumulate: without the phase that adds each row into its
  champion's workspace slice;
- no_fold: without the champion fold as well (no row gets a label, so
  nothing is accumulated): the staging, the tensor-core product and the
  stores of the cross tile are left.

So accumulate = full − no_accumulate, fold = no_accumulate − no_fold, and
no_fold is the rest. Each build is a copy of tdc_tpu_torch/ under DIR
(default scratch_trees/b5_phases, which .gitignore lists) with that
source removed, built by its own ops/_build.py and timed in its own
process with CUDA events (median of 7 after a warm-up), in the order
full, no_accumulate, no_fold, full. The cut builds compute wrong stats;
only their times are read. Prints one JSON line per run, then the card's
name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = "csrc/lloyd_bf16_kernels.cu"
ACCUMULATE = ("    for (int j = tid; j < d; j += kThreads) {\n"
              "      for (int r0 = 0; r0 < rows; r0 += kGroup) {",
              "    if (tid == 0) {\n"
              "      for (int r = 0; r < rows; ++r) sse +=")
FOLD = ("          if (better(v, j, best, barg)) {\n"
        "            best = v;\n"
        "            barg = j;\n"
        "          }\n", "          (void)v;\n")


def cut_accumulate(text: str) -> str:
    start, end = text.index(ACCUMULATE[0]), text.index(ACCUMULATE[1])
    return text[:start] + text[end:]


def cut_fold(text: str) -> str:
    if FOLD[0] not in text:
        raise ValueError("the fold's source is not where this script expects")
    return text.replace(FOLD[0], FOLD[1])


BUILDS = {
    "full": lambda text: text,
    "no_accumulate": cut_accumulate,
    "no_fold": lambda text: cut_fold(cut_accumulate(text)),
}


def make_build(out: Path, name: str) -> Path:
    root = out / name
    pkg = root / "tdc_tpu_torch"
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(REPO / "tdc_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = pkg / SOURCE
    src.write_text(BUILDS[name](src.read_text()))
    return root


def time_build(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from tdc_tpu_torch.ops import lloyd_kernels as lk

    if not lk.__file__.startswith(root):
        raise RuntimeError(f"imported {lk.__file__}, not the copy in {root}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, k, d = 1 << 22, 1024, 128
    centers = (torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) * 3
    x = (torch.randn((n, d), generator=gen, device="cuda")
         + centers[torch.arange(n, device="cuda") % k])
    out = {"build": Path(root).name}
    for rows in (x, x.to(torch.bfloat16)):
        lk.lloyd_stats_fused_bf16(rows, centers)
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            lk.lloyd_stats_fused_bf16(rows, centers)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[f"{str(rows.dtype).removeprefix('torch.')}_ms"] = (
            statistics.median(times))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(REPO / "scratch_trees" / "b5_phases"))
    p.add_argument("--time", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.time:
        print(json.dumps(time_build(args.time)), flush=True)
        return 0
    out = Path(args.out)
    roots = {name: make_build(out, name) for name in BUILDS}
    for name in ("full", "no_accumulate", "no_fold", "full"):
        subprocess.run([sys.executable, __file__, "--time", str(roots[name])],
                       check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
