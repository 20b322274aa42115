"""What the phase scripts (b1_b4_phases.py, b2_b7_phases.py, b5_phases.py,
b6_b9_phases.py, b10_phases.py, b11_phases.py) share: copy the port's
package into one tree per build, cut a phase out of its kernel sources by
text markers, and run a timer program in each build's own process, so
that each build compiles its own kernels.

A cut is a tuple of edits (source, spans, swaps) of
tdc_tpu_torch/<source>: the text from each span's start marker up to its
end marker is removed, and each (old, new) swap puts new in place of old.
Every marker must appear exactly once. Cuts join with +. A script's
BUILDS maps a build's name to (root, cut, runs): root is "repo" (this
checkout) or "parent" (--parent TREE, the tdc_tpu_torch/ of an earlier
commit, e.g. unpacked with `git archive <commit> tdc_tpu_torch`), runs
the parts of the timer program that the build runs.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def edit(source: str, spans=(), swaps=()) -> tuple:
    """A cut of one source file."""
    return ((source, tuple(spans), tuple(swaps)),)


def cut(tree: Path, edits) -> None:
    """Applies the edits to tree/tdc_tpu_torch/; raises where a marker is
    not found exactly once."""
    for source, spans, swaps in edits:
        path = tree / "tdc_tpu_torch" / source
        text = path.read_text()
        for marker in [s for span in spans for s in span] + [o for o, _ in
                                                            swaps]:
            if text.count(marker) != 1:
                raise ValueError(f"a cut's source is not where the script "
                                 f"expects in {source}: "
                                 f"{marker.strip()[:60]!r}")
        for start, end in spans:
            a = text.index(start)
            text = text[:a] + text[text.index(end, a):]
        for old, new in swaps:
            text = text.replace(old, new)
        path.write_text(text)


# The start of every timer program: argv is (build, runs), and
# median_ms(fn) is the median of REPS timings by CUDA events after a
# warm-up.
TIMER_HEAD = r"""
import json, statistics, sys, time
import torch

def median_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)

build, runs = sys.argv[1], sys.argv[2].split(",")
"""


def main(name: str, builds: dict, timer: str, order: list,
         parent_order: list, reps: int, repeat_runs=("time",)) -> int:
    """The scripts' command line. Without --builds it runs `order`, then
    with --parent `parent_order`, then order[0] once more with only
    `repeat_runs`; with --builds, the builds named, in that order. Each
    build is a copy of tdc_tpu_torch/ and chip_smoke.py under --out
    (default scratch_trees/<name>, which .gitignore lists). Ends with the
    card's name and power limit."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "scratch_trees" / name))
    ap.add_argument("--parent", default=None,
                    help="a directory holding an earlier tdc_tpu_torch/")
    ap.add_argument("--builds", default=None,
                    help="comma-separated builds to run, in order")
    args = ap.parse_args()
    out = Path(args.out)
    if args.builds:
        order = args.builds.split(",")
    else:
        order = [*order, *(parent_order if args.parent else ()), order[0]]
    roots = {"repo": REPO, "parent": Path(args.parent) if args.parent
             else None}
    for build in dict.fromkeys(order):
        root, edits, _ = builds[build]
        if roots[root] is None:
            raise SystemExit(f"build {build} needs --parent")
        tree = out / build
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(roots[root] / "tdc_tpu_torch",
                        tree / "tdc_tpu_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", tree / "chip_smoke.py")
        cut(tree, edits)
    program = TIMER_HEAD.replace("REPS", str(reps)) + timer
    seen = set()
    for build in order:
        runs = builds[build][2] if build not in seen else repeat_runs
        seen.add(build)
        done = subprocess.run([sys.executable, "-c", program, build,
                               ",".join(runs)], cwd=out / build)
        if done.returncode:
            raise SystemExit(f"build {build}: exit {done.returncode}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0
