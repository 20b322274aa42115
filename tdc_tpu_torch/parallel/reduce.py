"""Cross-rank reduction of sufficient statistics (counterpart:
tdc_tpu/parallel/reduce.py: `reduced_tree_stats`, the reduce strategies
`ReduceStrategy` / `resolve_reduce`, the comms accounting `CommsCounter` /
`CommsReport`, and the per-pass deferred reduce).

Each rank computes the stats of its own rows; every field is then summed
over the data axis, so every rank holds the stats of all rows. The fields
travel as one f32 buffer in one `all_reduce`.

A streamed fit reduces either once per batch ("per_batch", the default)
or once per pass ("per_pass"): the per-pass mode accumulates each rank's
stats locally in f32 across the pass (`make_deferred_fns`,
`zero_deferred`) and all-reduces once (`deferred_reduce`), O(1)
collectives per iteration instead of O(num_batches). It reorders the f32
sums, so the two modes agree to accumulation tolerance, not bitwise.

Not ported: the quantized per-pass reduces with error feedback
("per_pass:bf16", "per_pass:int8"; ROADMAP.md Queue A, A7) and the
two-stage `tree_psum` of a hierarchical mesh (A4).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import NamedTuple

import torch

from tdc_tpu_torch.parallel.mesh import Mesh, data_axes

_QUANT_MODES = (None, "bf16", "int8")
_MODES = ("per_batch", "per_pass")


def _quantized_not_ported(quantize) -> NotImplementedError:
    return NotImplementedError(
        f"the quantized per-pass reduce (per_pass:{quantize}, with error "
        "feedback) is not ported to tdc_tpu_torch yet (ROADMAP.md Queue A, "
        "A7)")


@dataclass(frozen=True)
class ReduceStrategy:
    """How a streamed fit reduces its sufficient statistics across ranks.

    mode: "per_batch" (one reduce per streamed batch) or "per_pass"
      (rank-local accumulation, one reduce per iteration).
    quantize: None | "bf16" | "int8", the JAX package's wire encodings of
      the (K, d) sums; accepted here and refused by the streamed fits,
      naming ROADMAP.md A7.
    """

    mode: str = "per_batch"
    quantize: str | None = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"reduce mode must be one of {_MODES}, got {self.mode!r}"
            )
        if self.quantize not in _QUANT_MODES:
            raise ValueError(
                f"quantize must be one of {_QUANT_MODES}, "
                f"got {self.quantize!r}"
            )
        if self.quantize is not None and self.mode != "per_pass":
            raise ValueError(
                "quantized stats reduce requires mode='per_pass' (the "
                "error-feedback residual is carried across passes; a "
                "per-batch residual would be meaningless)"
            )

    @property
    def deferred(self) -> bool:
        return self.mode == "per_pass"

    def label(self) -> str:
        return (self.mode if self.quantize is None
                else f"{self.mode}:{self.quantize}")


def resolve_reduce(reduce) -> ReduceStrategy:
    """A ReduceStrategy, or one of the shorthands "per_batch", "per_pass",
    "per_pass:bf16", "per_pass:int8"."""
    if isinstance(reduce, ReduceStrategy):
        return reduce
    if not isinstance(reduce, str):
        raise TypeError(
            f"reduce must be a str or ReduceStrategy, got {type(reduce)}"
        )
    mode, _, quant = reduce.partition(":")
    return ReduceStrategy(mode=mode, quantize=quant or None)


class CommsCounter:
    """Host-side tally of the cross-rank stats reduces a fit issued and
    the logical payload bytes they moved (the f32 size of the reduced
    stats per reduce stage). Thread-safe. Every per-fit counter also adds
    into `GLOBAL_COMMS`."""

    def __init__(self, _mirror=None):
        self._lock = threading.Lock()
        self._mirror = _mirror
        self.reduces = 0
        self.gathers = 0
        self.logical_bytes = 0
        self.data_bytes = 0
        self.model_bytes = 0

    def add(self, reduces: int, nbytes: int, *, axis: str = "data",
            gathers: int = 0) -> None:
        """axis="data" books a stats reduce; axis="model" the K-sharded
        towers' gathers. logical_bytes is the total over both."""
        with self._lock:
            self.reduces += int(reduces)
            self.gathers += int(gathers)
            self.logical_bytes += int(nbytes)
            if axis == "model":
                self.model_bytes += int(nbytes)
            else:
                self.data_bytes += int(nbytes)
        if self._mirror is not None:
            self._mirror.add(reduces, nbytes, axis=axis, gathers=gathers)

    def snapshot(self) -> dict:
        with self._lock:
            return {"reduces": self.reduces, "gathers": self.gathers,
                    "logical_bytes": self.logical_bytes,
                    "data_bytes": self.data_bytes,
                    "model_bytes": self.model_bytes}

    def reset(self) -> None:
        with self._lock:
            self.reduces = self.gathers = self.logical_bytes = 0
            self.data_bytes = self.model_bytes = 0


# The process-wide counter every per-fit counter mirrors into.
GLOBAL_COMMS = CommsCounter()


class CommsReport(NamedTuple):
    """Per-fit communication summary attached to the streamed fits'
    results."""

    strategy: str  # ReduceStrategy.label()
    reduces: int  # cross-rank stats reduces issued by this fit
    logical_bytes: int  # total logical payload bytes (both axes)
    passes: int  # full passes over the stream (iterations + final scoring)
    data_bytes: int = 0  # logical bytes of the data-axis stats reduces
    model_bytes: int = 0  # logical bytes of the model-axis gathers
    gathers: int = 0  # model-axis all_gathers issued by this fit

    @property
    def reduces_per_pass(self) -> float:
        return self.reduces / max(self.passes, 1)


def tree_reduce_cost(shapes, axes) -> tuple[int, int]:
    """(reduces, logical_bytes) of ONE f32 reduce of a stats tree whose
    fields have the logical `shapes` (e.g. sums (K, d), counts (K,), sse
    ()), over mesh `axes`: one reduce per axis, each moving the whole
    payload."""
    payload = sum(4 * math.prod(s) for s in shapes)
    return len(axes), len(axes) * payload


def tree_all_reduce(stats, mesh: Mesh, axes: tuple[str, ...], extra=None):
    """The NamedTuple `stats` with every field summed over `axes`: one
    all_reduce of the fields packed into one f32 buffer (each element's
    sum is the same as a reduce of its own field). `extra`, a 1-D f32
    tensor, rides in the same buffer and comes back summed as a second
    return value (the streamed fits' pad-row and bad-batch counts)."""
    fields = [t.float() for t in stats]
    parts = [t.reshape(-1) for t in fields]
    if extra is not None:
        parts.append(extra.float().reshape(-1))
    flat = torch.cat(parts)
    mesh.psum(flat, *axes)
    out, at = [], 0
    for t in fields:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    red = type(stats)(*out)
    return red if extra is None else (red, flat[at:])


def reduced_tree_stats(mesh: Mesh, local_fn, axis_name: str | None = None):
    """fn(*args) → `local_fn(*args)`'s stats summed over the mesh's data
    axis (`axis_name` overrides it). The rows in `args` are this rank's
    own (`mesh.shard_points`); the JAX version shards its global
    arguments itself, which a rank that holds only its rows does not
    need."""
    axes = (axis_name,) if axis_name is not None else data_axes(mesh)

    def run(*args):
        return tree_all_reduce(local_fn(*args), mesh, axes)

    return run


def tree_add(acc, stats):
    """`acc` + `stats`, field by field, in f32."""
    return type(acc)(*[a + b.float() for a, b in zip(acc, stats)])


def zero_deferred(example, device) -> tuple:
    """f32 zeros for a stats tree whose fields have the logical shapes in
    `example` (a NamedTuple of shapes): the per-pass accumulator. Each
    rank is a process of its own, so the accumulator is rank-local and
    needs no leading device axis (the JAX version's sharded layout)."""
    return type(example)(*[torch.zeros(tuple(s), dtype=torch.float32,
                                       device=device) for s in example])


def deferred_reduce(mesh: Mesh, quantize: str | None = None):
    """The ONE cross-rank reduce of a per-pass accumulator:
    fn(acc, extra=None) → the reduced tree (and the summed `extra`, as
    `tree_all_reduce`)."""
    if quantize is not None:
        raise _quantized_not_ported(quantize)
    axes = data_axes(mesh)

    def run(acc, extra=None):
        return tree_all_reduce(acc, mesh, axes, extra)

    return run


def make_deferred_fns(mesh: Mesh, example, tower, quantize: str | None,
                      device):
    """(zero_acc, acc_add, reduce) for a per-pass streamed fit:
    acc_add(acc, *args) adds `tower(*args)`, one batch's stats of this
    rank's rows, into the rank-local accumulator in f32 (no collective);
    reduce is `deferred_reduce`."""
    reducer = deferred_reduce(mesh, quantize)

    def acc_add(acc, *args):
        return tree_add(acc, tower(*args))

    return (lambda: zero_deferred(example, device)), acc_add, reducer
