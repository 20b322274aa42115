"""Cross-rank reduction of sufficient statistics (counterpart:
tdc_tpu/parallel/reduce.py: `reduced_tree_stats`, the reduce strategies
`ReduceStrategy` / `resolve_reduce`, the comms accounting `CommsCounter` /
`CommsReport`, the two-stage and quantized `tree_psum` and the per-pass
deferred reduce).

Each rank computes the stats of its own rows; every field is then summed
over the data axes, so every rank holds the stats of all rows. The f32
fields travel as one buffer in one `all_reduce` per mesh axis.

A streamed fit reduces either once per batch ("per_batch", the default)
or once per pass ("per_pass"): the per-pass mode accumulates each rank's
stats locally in f32 across the pass (`make_deferred_fns`,
`zero_deferred`) and all-reduces once (`deferred_reduce`), O(1)
collectives per iteration instead of O(num_batches). It reorders the f32
sums, so the two modes agree to accumulation tolerance, not bitwise.

On a hierarchical (dcn, ici) mesh (`mesh.make_hierarchical_mesh`) every
reduce runs in two stages, the ici axis first (`Mesh.psum`'s order).

"per_pass:bf16" and "per_pass:int8" also encode the rank-≥2 float fields
(the (K, d) sums, the GMM's second moments) on the last stage of the
reduce (`tree_psum`): bf16, or int8 codes on a per-row scale that the
ranks agree by a MAX all_reduce. Each rank keeps what the encoding lost
(its residual) and adds it into the next pass's reduce (error feedback),
so the error is deferred, not dropped. The int8 codes travel as int32: a
sum of int8 codes overflows int8 at two ranks (JAX carries them as f32).
The bf16 values travel as their two bytes, every rank's in its own row
of one buffer, and are added in f32 and rounded once, as JAX's psum of bf16
adds them (`_bf16_sum`). The logical bytes count both as the JAX
package's model does: two bytes a bf16 value, one an int8 code. Counts
and scalars stay f32.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist

from tdc_tpu_torch.parallel.mesh import Mesh, data_axes

_QUANT_MODES = (None, "bf16", "int8")
_MODES = ("per_batch", "per_pass")


@dataclass(frozen=True)
class ReduceStrategy:
    """How a streamed fit reduces its sufficient statistics across ranks.

    mode: "per_batch" (one reduce per streamed batch) or "per_pass"
      (rank-local accumulation, one reduce per iteration).
    quantize: None | "bf16" | "int8", the wire encoding of the rank-≥2
      stats fields, per-pass mode only, with error feedback.

    The two-stage reduce is not a flag: a mesh from
    `make_hierarchical_mesh` makes every strategy reduce in two stages.
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


def _quantized_shape(shape) -> bool:
    """Fields that ride the quantized wire: the rank-≥2 ones (every stats
    field here is f32). Counts and scalars stay f32."""
    return len(shape) >= 2


def tree_reduce_cost(shapes, axes, quantize: str | None = None
                     ) -> tuple[int, int]:
    """(reduces, logical_bytes) of ONE reduce of a stats tree whose
    fields have the logical `shapes` (e.g. sums (K, d), counts (K,), sse
    ()), over mesh `axes`: one reduce per axis, each moving the whole f32
    payload, but the last stage moves the quantized fields at 2 (bf16) or
    1 (int8) bytes an element, int8 with a 4-byte scale a row and one
    scale-agreement reduce per quantized field."""
    f32_payload = sum(4 * math.prod(s) for s in shapes)
    n_stages = len(axes)
    if quantize is None:
        return n_stages, n_stages * f32_payload
    q_elem = 1 if quantize == "int8" else 2
    q_shapes = [s for s in shapes if _quantized_shape(s)]
    q_payload = sum(4 * math.prod(s) for s in shapes
                    if not _quantized_shape(s))
    q_payload += sum(q_elem * math.prod(s) for s in q_shapes)
    reduces = n_stages
    nbytes = (n_stages - 1) * f32_payload + q_payload
    if quantize == "int8":
        scales = sum(4 * math.prod(s[:-1]) for s in q_shapes)
        reduces += len(q_shapes)
        nbytes += 2 * scales  # the scales on the wire, then their MAX
    return reduces, nbytes


def _split(flat: torch.Tensor, like: list) -> list:
    """`flat` cut into the shapes of the tensors in `like`, in order."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _psum_parts(mesh: Mesh, parts: list, *axes: str,
                op=dist.ReduceOp.SUM) -> list:
    """`parts` (tensors of one dtype) reduced over `axes` in one packed
    all_reduce a stage, each back in its own shape."""
    if not parts:
        return []
    return _split(mesh.psum(torch.cat([t.reshape(-1) for t in parts]),
                            *axes, op=op), parts)


def _rebuild(like, fields):
    """`fields` in the container type of `like` (a NamedTuple or a
    tuple)."""
    return (type(like)(*fields) if hasattr(like, "_fields")
            else type(like)(fields))


def tree_all_reduce(stats, mesh: Mesh, axes: tuple[str, ...], extra=None):
    """The NamedTuple `stats` with every field summed over `axes` (ici
    before dcn): one all_reduce a stage of the fields packed into one f32
    buffer (each element's sum is the same as a reduce of its own field).
    `extra`, a 1-D f32 tensor, rides in the same buffer and comes back
    summed as a second return value (the streamed fits' pad-row and
    bad-batch counts)."""
    fields = [t.float() for t in stats]
    parts = fields + ([] if extra is None else [extra.float()])
    out = _psum_parts(mesh, parts, *axes)
    red = _rebuild(stats, out[:len(fields)])
    return red if extra is None else (red, out[-1])


def _bf16_sum(qs, mesh: Mesh, axis: str) -> list:
    """The ranks' bf16 fields `qs` summed over one mesh axis as JAX's
    psum of bf16 sums them: added in f32, rounded to bf16 once. The bf16
    values travel in one all_reduce of a zero-filled (ranks, n) bf16
    buffer in which each rank fills its own row, summed as bytes (uint8:
    adding zero bytes leaves every bit as it was; a bf16 all_reduce would
    round after every addition, and gloo on CUDA tensors has no
    all_gather); every rank then adds the rows in rank order, so every
    rank holds the same bits."""
    if not qs:
        return []
    n = sum(q.numel() for q in qs)
    rows = torch.zeros((mesh.axis_size(axis), n), dtype=torch.bfloat16,
                       device=qs[0].device)
    rows[mesh.axis_index(axis)] = torch.cat([q.reshape(-1) for q in qs])
    mesh.psum(rows.view(torch.uint8), axis)
    total = rows[0].float()
    for row in rows[1:]:
        total = total + row.float()
    return _split(total.to(torch.bfloat16).float(), qs)


def _q_psum(ys, mesh: Mesh, axis: str, quantize: str):
    """The last stage of a quantized reduce of the fields `ys` over one
    mesh axis (JAX's `_q_psum_leaf`, the fields packed into one
    all_reduce): (the reduced f32 fields, this rank's residuals y −
    decode(encode(y)))."""
    if quantize == "bf16":
        qs = [y.to(torch.bfloat16) for y in ys]
        return (_bf16_sum(qs, mesh, axis),
                [y - q.float() for y, q in zip(ys, qs)])
    # int8: one scale a row, the MAX of every rank's row max, so every
    # rank's codes decode alike; the codes are summed exactly as int32.
    amax = [y.abs().amax(dim=-1, keepdim=True) for y in ys]
    amax = _psum_parts(mesh, amax, axis, op=dist.ReduceOp.MAX)
    scales = [torch.clamp_min(a, 1e-30) / 127.0 for a in amax]
    qs = [torch.clamp(torch.round(y / sc), -127.0, 127.0)
          for y, sc in zip(ys, scales)]
    out = _psum_parts(mesh, [q.to(torch.int32) for q in qs], axis)
    return ([o.float() * sc for o, sc in zip(out, scales)],
            [y - q * sc for y, q, sc in zip(ys, qs, scales)])


def tree_psum(stats, mesh: Mesh, axes: tuple[str, ...], *,
              quantize: str | None = None, err=None, extra=None):
    """Reduce a stats NamedTuple over mesh `axes`, innermost first (ici,
    then dcn). Returns (reduced, new_err), and the summed `extra` third
    when it is given (see `tree_all_reduce`); new_err is None when
    quantize is None.

    quantize encodes the rank-≥2 fields on the LAST stage; `err` (the
    same structure, this rank's residual from the previous reduce) is
    added to them before the first stage, so on a hierarchical mesh the
    encoder sees a value that is the same at every ici position (and
    agrees the same int8 scale). The new residual is then the same
    within an ici group; it is kept divided by the group size, so the
    next reduce's ici stage puts back exactly one copy of it."""
    if quantize is None:
        out = tree_all_reduce(stats, mesh, axes, extra)
        return (out, None) if extra is None else (out[0], None, out[1])
    order = sorted(axes, key=mesh.axis_names.index, reverse=True)
    early, last = order[:-1], order[-1]
    fields = [t.float() for t in stats]
    if err is None:
        err = [torch.zeros_like(t) for t in fields]
    q_idx = [i for i, t in enumerate(fields) if _quantized_shape(t.shape)]
    f_idx = [i for i in range(len(fields)) if i not in q_idx]
    plain = [fields[i] for i in f_idx]
    plain += [] if extra is None else [extra.float()]
    ys = [fields[i] + err[i].float() for i in q_idx]
    group = 1
    if early:
        # The early stages in f32, plain fields and ys in one buffer.
        both = _psum_parts(mesh, plain + ys, *early)
        plain, ys = both[:len(plain)], both[len(plain):]
        group = math.prod(mesh.axis_size(a) for a in early)
    plain = _psum_parts(mesh, plain, last)
    q_out, q_err = _q_psum(ys, mesh, last, quantize)
    out = [None] * len(fields)
    new_err = [torch.zeros_like(t) for t in fields]
    for i, t in zip(f_idx, plain):
        out[i] = t
    for i, t, e in zip(q_idx, q_out, q_err):
        out[i] = t
        new_err[i] = e / group
    red, new_err = _rebuild(stats, out), _rebuild(stats, new_err)
    return (red, new_err) if extra is None else (red, new_err, plain[-1])


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
    """The ONE cross-rank reduce of a per-pass accumulator. Without
    quantize: fn(acc, extra=None) → the reduced tree (and the summed
    `extra`, as `tree_all_reduce`). With quantize: fn(acc, err,
    extra=None) → (the reduced tree, new_err[, the summed extra]), err
    being this rank's error-feedback tree (`tree_psum`)."""
    axes = data_axes(mesh)
    if quantize is None:
        def run(acc, extra=None):
            return tree_all_reduce(acc, mesh, axes, extra)

        return run

    def run_q(acc, err, extra=None):
        return tree_psum(acc, mesh, axes, quantize=quantize, err=err,
                         extra=extra)

    return run_q


def make_deferred_fns(mesh: Mesh, example, tower, quantize: str | None,
                      device):
    """(zero_acc, acc_add, reduce) for a per-pass streamed fit:
    acc_add(acc, *args) adds `tower(*args)`, one batch's stats of this
    rank's rows, into the rank-local accumulator in f32 (no collective);
    reduce is `deferred_reduce`. zero_acc also makes the quantized modes'
    first error-feedback tree."""
    reducer = deferred_reduce(mesh, quantize)

    def acc_add(acc, *args):
        return tree_add(acc, tower(*args))

    return (lambda: zero_deferred(example, device)), acc_add, reducer
