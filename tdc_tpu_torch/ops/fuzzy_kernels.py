"""The fuzzy kernels B6, B7 and B8 (counterpart:
tdc_tpu/ops/pallas_kernels.py, the `_fuzzy_fold_for`, `fuzzy_stats_fused`,
`fuzzy_stats_auto`, `fuzzy_normalizer`, `fuzzy_accumulate` and
`fuzzy_stats_twopass` parts).

As in `ops/lloyd_kernels.py`, each kernel has three parts here:

- the wrapper `fuzzy_stats_fused`, which checks its inputs, allocates every
  output and workspace with `torch.empty`, and on a CUDA tensor launches
  the hand-written kernel from `csrc/fuzzy_kernels.cu` on the current
  stream or raises;
- the plain PyTorch version `fuzzy_stats_fused_plain`, the same function
  with the same formula (d² from ‖x‖² + ‖c‖² − 2x·c clamped at 0,
  u = (d² + eps)^(−1/(m−1)) normalised over K, μ = u^m). The wrapper uses
  it only for a CPU tensor; the tests hold it to the JAX package and
  `chip_smoke.py` holds the kernel to it on the card;
- a launch counter, `fuzzy_stats_fused.launches`, which only the kernel
  launch increments.

The kernel is two phases per row chunk (the row normaliser, which writes
the chunk's inv = (d² + eps)^(−1/(m−1)) to a scratch of at most
MU_SCRATCH_BYTES, `row_scratch_plan`; then μ and Σμx on the tensor cores
from that scratch), so it takes every (K, d) and computes each distance
once: there is no route limit and no fallback. See the note in
`csrc/fuzzy_kernels.cu` and PERF.md.

B7 (`fuzzy_normalizer`) and B8 (`fuzzy_accumulate`) are two phases of
their own, for the K-sharded tower (`parallel/sharded_k.py`): B7 gives
s = Σ_k (d² + eps)^(−1/(m−1)) over the centroids it is given (its
distance product on the tensor cores in 3xTF32, each row's nearest
centroid scored again in f32), the tower sums s over the model axis, and B8
takes that s from outside and computes the distance again: at d <= 128
in one kernel, past it through a μ scratch of at most MU_SCRATCH_BYTES
(`mu_scratch_plan`) to a μᵀ·X kernel. `fuzzy_stats_twopass` is B7 then
B8. Each wrapper counts only its own launches, so a route's launch counts
name the kernels it really ran.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.ops import _build
from tdc_tpu_torch.ops.assign import FuzzyStats
from tdc_tpu_torch.ops.lloyd_kernels import (
    _PLAIN_TILE_ELEMS,
    ROW_DTYPES,
    _check,
    _sq_norms,
    _stream,
    fused_tc_grid,
    widened,
)
from tdc_tpu_torch.utils.structlog import emit


def _check_m(name: str, m: float) -> None:
    if not m > 1.0:
        raise ValueError(f"{name}: fuzzifier m must be > 1, got {m}")


def fuzzy_stats_fused_plain(x: torch.Tensor, centroids: torch.Tensor,
                            m: float = 2.0, eps: float = 1e-9) -> FuzzyStats:
    """Plain version of B6, over row blocks of at most _PLAIN_TILE_ELEMS
    (rows, K) elements. Memberships are f32 as in the kernel; the three
    sums are taken in f64 and rounded once, so the plain version is the
    accurate side of the kernel check. Objective clamped at 0."""
    _check_m("fuzzy_stats_fused_plain", m)
    k, d = centroids.shape
    c2 = _sq_norms(centroids)
    p = -1.0 / (m - 1.0)
    wsums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    weights = torch.zeros(k, dtype=torch.float64, device=x.device)
    objective = torch.zeros((), dtype=torch.float64, device=x.device)
    rows = max(1, _PLAIN_TILE_ELEMS // k)
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        x2 = (xb * xb).sum(dim=1, keepdim=True)
        d2 = torch.clamp_min(x2 + c2 - 2.0 * (xb @ centroids.T), 0.0)
        inv = (d2 + eps) ** p
        mu = (inv / inv.sum(dim=1, keepdim=True)) ** m
        wsums += mu.T.double() @ xb.double()
        weights += mu.sum(dim=0, dtype=torch.float64)
        objective += (mu * d2).sum(dtype=torch.float64)
    return FuzzyStats(weighted_sums=wsums.float(), weights=weights.float(),
                      objective=torch.clamp_min(objective, 0.0).float())


def _normalize_phase(x, centroids, c2, m, eps):
    """B7's kernel on CUDA tensors: (s, ‖x‖²), each (N,) f32, on
    `fused_tc_grid` CTAs with a scratch for the centroids split into TF32
    halves and ‖c‖². c2 is ‖c‖² as B8 takes it: each row's nearest
    centroid is scored again with B8's arithmetic. Counts no launch:
    `fuzzy_normalizer` is the kernel's entry point."""
    n, d = x.shape
    k = centroids.shape[0]
    s = torch.empty(max(n, 1), dtype=torch.float32, device=x.device)
    x2 = torch.empty(max(n, 1), dtype=torch.float32, device=x.device)
    lib = _build.load().lib
    scratch = torch.empty(lib.tdc_lloyd_scratch_floats(k, d),
                          dtype=torch.float32, device=x.device)
    _build.check(lib.tdc_fuzzy_normalizer(
        x.data_ptr(), centroids.data_ptr(), c2.data_ptr(), n, k, d,
        -1.0 / (m - 1.0), eps,
        fused_tc_grid(x.device, n), scratch.data_ptr(), s.data_ptr(),
        x2.data_ptr(), _stream(x),
    ), "fuzzy_normalizer")
    return s, x2


# The phases' geometry, as `csrc/fuzzy_kernels.cu`, `csrc/champion.cuh`
# and `csrc/tf32_accum.cuh` fix it: centroids per K tile of the phase-1
# kernels and of the μᵀ·X kernel (kFuzzyBN), of B6's phase 2 (kTcK) and
# of the μ kernel (kMuBN, which a K chunk is a multiple of), rows per row
# block (BM) and columns per d slice (kDC, kTcC). At d <= _D_SLICE, B8's
# phase 2 is one kernel that computes each distance tile once; past it, μ
# goes through a scratch.
_K_TILE = 64
_MU_K_TILE = 128
_TC_K_TILE = 128  # B6's phase-2 K tile (B9's: half of it)
_ROW_BLOCK = 128
_D_SLICE = 128
# The scratch of B8's phase 2 at d > _D_SLICE, and of B6's and B9's
# phases: at most this many bytes, whatever N and K (each process
# allocates its own).
MU_SCRATCH_BYTES = 512 << 20


def mu_scratch_plan(n: int, k: int, d: int,
                    target_ctas: int) -> tuple[int, int, int]:
    """(rows per chunk, centroids per chunk, row ranges G) of phase 2 at
    d > _D_SLICE. The scratch holds μ for one (row chunk, K chunk) pair,
    rows per chunk x centroids per chunk f32 within MU_SCRATCH_BYTES:
    every row in one chunk where the budget allows (the widest K chunk
    then), else one μ-kernel K tile and as many row blocks as fit; both
    multiples of their tiles, at least one tile each. G splits a row
    chunk's row blocks so that about `target_ctas` CTAs run the μᵀ·X
    kernel over its (K tile, d slice) pairs."""
    cap = MU_SCRATCH_BYTES // 4  # f32 elements
    rows_all = max(1, -(-n // _ROW_BLOCK)) * _ROW_BLOCK
    k_all = -(-k // _MU_K_TILE) * _MU_K_TILE
    kc = min(k_all, max(_MU_K_TILE, cap // rows_all // _MU_K_TILE
                        * _MU_K_TILE))
    rc = min(rows_all, max(_ROW_BLOCK, cap // kc // _ROW_BLOCK * _ROW_BLOCK))
    tiles = (kc // _K_TILE) * (-(-d // _D_SLICE))
    grid = max(1, min(target_ctas // tiles, rc // _ROW_BLOCK, 65535))
    return rc, kc, grid


def row_scratch_plan(n: int, k: int, comps: int, slices: int,
                     target_ctas: int) -> tuple[int, int, int]:
    """(rows per chunk, scratch values a row kp, row ranges G) of the
    two-phase kernels that pass phase 1's (row, component) values to phase
    2 through a scratch (B6: inv; B9: the log-probs). Phase 1 needs whole
    K rows, so the scratch holds rows per chunk x kp f32 within
    MU_SCRATCH_BYTES, kp = K rounded up to phase 2's K tile of `comps`
    components: every row in one chunk where the budget allows, else as
    many 128-row blocks as fit, at least one. G splits a chunk's row
    blocks so that about `target_ctas` CTAs run phase 2 over its (K tile,
    column slice) pairs, `slices` column slices each."""
    kp = -(-k // comps) * comps
    rows_all = max(1, -(-n // _ROW_BLOCK)) * _ROW_BLOCK
    rc = min(rows_all, max(_ROW_BLOCK, MU_SCRATCH_BYTES // 4 // kp
                           // _ROW_BLOCK * _ROW_BLOCK))
    tiles = (kp // comps) * slices
    grid = max(1, min(target_ctas // tiles, rc // _ROW_BLOCK, 65535))
    return rc, kp, grid


def phase1_k_splits(rows_per_chunk: int, k: int, target_ctas: int) -> int:
    """K splits of each 128-row block in phase 1 of the two-phase kernels
    (B6, B9): as many as bring a row chunk's launch to about `target_ctas`
    CTAs, at most one 64-wide K tile a split, at least 1. A split's CTA
    takes a contiguous range of the block's K tiles; a merge kernel adds
    the splits' row sums in split order. One split wherever a chunk's row
    blocks fill the card (the fuzzy and GMM routes' shape); more where the
    scratch holds few rows (8,192 at K = 16,384)."""
    blocks = max(1, rows_per_chunk // _ROW_BLOCK)
    return max(1, min(-(-k // _K_TILE), -(-target_ctas // blocks)))


def _stats_buffers(k, d, dev):
    return (torch.empty((k, d), dtype=torch.float32, device=dev),
            torch.empty(k, dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.float32, device=dev))


def _accumulate_one_slice(x, centroids, c2, s, x2, m, eps) -> FuzzyStats:
    """Phase 2 as one kernel (d <= _D_SLICE: one d slice, so each distance
    tile is computed once), and the fixed-order sum of its partials."""
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    lib = _build.load().lib
    # About two CTAs per SM.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = lib.tdc_fuzzy_grid(n, k, d, 2 * sms)
    ntk = -(-k // lib.tdc_fuzzy_k_tile())
    ws = torch.empty((grid, k, d), dtype=torch.float32, device=dev)
    wpart = torch.empty((grid, k), dtype=torch.float64, device=dev)
    opart = torch.empty((grid, ntk), dtype=torch.float64, device=dev)
    wsums, weights, objective = _stats_buffers(k, d, dev)
    _build.check(lib.tdc_fuzzy_accumulate(
        x.data_ptr(), centroids.data_ptr(), c2.data_ptr(), s.data_ptr(),
        x2.data_ptr(), n, k, d, -1.0 / (m - 1.0), m, eps, grid,
        ws.data_ptr(), wpart.data_ptr(), opart.data_ptr(), wsums.data_ptr(),
        weights.data_ptr(), objective.data_ptr(), _stream(x),
    ), "fuzzy_stats_fused (accumulate)")
    return FuzzyStats(weighted_sums=wsums, weights=weights,
                      objective=objective)


def _accumulate_mu(x, centroids, c2, s, x2, m, eps,
                   halves: int = 3) -> FuzzyStats:
    """Phase 2 through the μ scratch (design (a), csrc/fuzzy_kernels.cu):
    μ once per (row, centroid) into the bounded scratch of
    `mu_scratch_plan`, then μᵀ·X. `halves` 1 or 2 runs the μ or the μᵀ·X
    kernels alone, for timing them apart (chip_smoke.py); its outputs are
    then not the stats."""
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    lib = _build.load().lib
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rc, kc, grid = mu_scratch_plan(n, k, d, 2 * sms)
    nb = -(-n // _ROW_BLOCK)
    mu = torch.empty(rc * kc, dtype=torch.float32, device=dev)
    ws = torch.empty((-(-n // rc) * grid, kc, d), dtype=torch.float32,
                     device=dev)
    wpart = torch.empty((ws.shape[0], kc), dtype=torch.float64, device=dev)
    opart = torch.empty((-(-k // kc), nb), dtype=torch.float64, device=dev)
    wsums, weights, objective = _stats_buffers(k, d, dev)
    _build.check(lib.tdc_fuzzy_accumulate_mu(
        x.data_ptr(), centroids.data_ptr(), c2.data_ptr(), s.data_ptr(),
        x2.data_ptr(), n, k, d, -1.0 / (m - 1.0), m, eps, rc, kc, grid,
        mu.data_ptr(), ws.data_ptr(), wpart.data_ptr(), opart.data_ptr(),
        wsums.data_ptr(), weights.data_ptr(), objective.data_ptr(), halves,
        _stream(x),
    ), "fuzzy_stats_fused (accumulate, μ scratch)")
    return FuzzyStats(weighted_sums=wsums, weights=weights,
                      objective=objective)


def _launch(x, centroids, c2, m, eps, phases: int = 3) -> FuzzyStats:
    """B6 on CUDA tensors, one row chunk of the inv scratch at a time
    (`row_scratch_plan`): phase 1 (the row normaliser, writing the chunk's
    inv = (d² + eps)^(−1/(m−1)), its K tiles split `phase1_k_splits`
    ways), then phase 2 (μ and Σμx on the tensor cores), then the
    fixed-order sum of the partials. `phases` 1 or 2 runs
    one phase alone, for timing them apart (chip_smoke.py); the outputs
    are then not the stats. Counts no launch: `fuzzy_stats_fused` is the
    kernel's entry point."""
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    # One phase-2 CTA per SM, two phase-1 CTAs.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rc, kp, grid = row_scratch_plan(n, k, _TC_K_TILE, -(-d // _D_SLICE),
                                    sms)
    splits = phase1_k_splits(rc, k, 2 * sms)
    f32, f64 = torch.float32, torch.float64
    scr = torch.empty(rc * kp, dtype=f32, device=dev)
    spart = torch.empty(splits * rc, dtype=f32, device=dev)
    s = torch.empty(max(n, 1), dtype=f32, device=dev)
    q = torch.empty(max(n, 1), dtype=f32, device=dev)
    ws = torch.empty((grid, k, d), dtype=f64, device=dev)
    wpart = torch.empty((grid, k), dtype=f64, device=dev)
    opart = torch.empty((grid, kp // _TC_K_TILE), dtype=f64, device=dev)
    wsums, weights, objective = _stats_buffers(k, d, dev)
    _build.check(_build.load().lib.tdc_fuzzy_stats(
        x.data_ptr(), centroids.data_ptr(), c2.data_ptr(), n, k, d,
        -1.0 / (m - 1.0), m, eps, rc, kp, grid, splits, scr.data_ptr(),
        spart.data_ptr(), s.data_ptr(), q.data_ptr(), ws.data_ptr(),
        wpart.data_ptr(), opart.data_ptr(), wsums.data_ptr(),
        weights.data_ptr(), objective.data_ptr(), phases, _stream(x),
    ), "fuzzy_stats_fused")
    return FuzzyStats(weighted_sums=wsums, weights=weights,
                      objective=objective)


def _accumulate_phase(x, centroids, c2, s, x2, m, eps) -> FuzzyStats:
    """Phase 2 of B8 on CUDA tensors, given B7's (s, ‖x‖²):
    the one-slice kernel at d <= _D_SLICE, the μ scratch past it, so the
    distance is computed once per (row, centroid) pair at every d."""
    if x.shape[1] <= _D_SLICE:
        return _accumulate_one_slice(x, centroids, c2, s, x2, m, eps)
    return _accumulate_mu(x, centroids, c2, s, x2, m, eps)


def fuzzy_stats_fused(x: torch.Tensor, centroids: torch.Tensor,
                      m: float = 2.0, eps: float = 1e-9) -> FuzzyStats:
    """B6: fuzzy C-means sufficient stats, no (N, K) buffer. Returns
    FuzzyStats(weighted_sums (K, d), weights (K,), objective ()) in f32,
    the objective clamped at 0. Takes every (K, d). bf16 rows run widened
    (`lloyd_kernels.widened`), as the JAX kernel rounds the centroids to
    the rows' dtype."""
    _check("fuzzy_stats_fused", x, centroids, ROW_DTYPES)
    _check_m("fuzzy_stats_fused", m)
    x, centroids = widened(x, centroids)
    if x.device.type == "cpu":
        return fuzzy_stats_fused_plain(x, centroids, m=m, eps=eps)
    out = _launch(x, centroids, _sq_norms(centroids), m, eps)
    fuzzy_stats_fused.launches += 1
    return out


fuzzy_stats_fused.launches = 0


def fuzzy_stats_for(k: int, d: int, *, label: str = ""):
    """The kernel route's fuzzy stats function for (K, d): B6 at every
    (K, d), since its two phases have no K·d limit. One `kernel_selected`
    event names the choice; a fit asks once and reuses the function."""
    emit("kernel_selected", kernel="fused", model="fuzzy", k=int(k),
         d=int(d), reason=(
             "two-phase fused kernel (row normaliser, then K-tiled "
             "accumulate): no (N, K) buffer and no K·d limit"),
         label=label or "fuzzy_stats_auto")
    return fuzzy_stats_fused


def fuzzy_stats_auto(x: torch.Tensor, centroids: torch.Tensor,
                     m: float = 2.0) -> FuzzyStats:
    """Fuzzy stats on the kernel route (tests and the fit loop share it)."""
    return fuzzy_stats_for(*centroids.shape)(x, centroids, m)


def _check_s(name: str, x: torch.Tensor, s: torch.Tensor) -> None:
    if s.shape != (x.shape[0],):
        raise ValueError(f"{name}: s must be ({x.shape[0]},), one normaliser "
                         f"per row, got {tuple(s.shape)}")
    if s.dtype != torch.float32:
        raise TypeError(f"{name}: s must be float32, got {s.dtype}")
    if s.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, s on {s.device}")


def _twopass_operands(name: str, x: torch.Tensor, centroids: torch.Tensor,
                      m: float):
    """Checked kernel operands of B7 and B8: bf16 rows widened and the
    centroids rounded to bf16 before ‖c‖², as `_twopass_prep` casts them
    to x.dtype."""
    _check(name, x, centroids, ROW_DTYPES)
    _check_m(name, m)
    return widened(x, centroids)


def _plain_inv(x, centroids, m, eps):
    """(row slice, rows, clamped d², inv) over row blocks of at most
    _PLAIN_TILE_ELEMS (rows, K) elements, f32 as in the kernels."""
    c2 = _sq_norms(centroids)
    p = -1.0 / (m - 1.0)
    rows = max(1, _PLAIN_TILE_ELEMS // centroids.shape[0])
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        x2 = (xb * xb).sum(dim=1, keepdim=True)
        d2 = torch.clamp_min(x2 + c2 - 2.0 * (xb @ centroids.T), 0.0)
        yield slice(s, s + rows), xb, d2, (d2 + eps) ** p


def fuzzy_normalizer_plain(x: torch.Tensor, centroids: torch.Tensor,
                           m: float = 2.0, eps: float = 1e-9) -> torch.Tensor:
    """Plain version of B7: s (N,) f32, Σ_k (d² + eps)^(−1/(m−1)) over
    these centroids only, each row's sum taken in f64 and rounded once."""
    _check_m("fuzzy_normalizer_plain", m)
    s = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for rows, _, _, inv in _plain_inv(x, centroids, m, eps):
        s[rows] = inv.sum(dim=1, dtype=torch.float64).float()
    return s


def fuzzy_accumulate_plain(x: torch.Tensor, centroids: torch.Tensor,
                           s: torch.Tensor, m: float = 2.0,
                           eps: float = 1e-9) -> FuzzyStats:
    """Plain version of B8: with u = inv / s and μ = u^m, Σμx (K, d),
    Σμ (K,) and Σμd² (clamped at 0), the sums in f64 rounded once. s is
    taken as given: in the K-sharded tower it sums other centroids too."""
    _check_m("fuzzy_accumulate_plain", m)
    k, d = centroids.shape
    wsums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    weights = torch.zeros(k, dtype=torch.float64, device=x.device)
    objective = torch.zeros((), dtype=torch.float64, device=x.device)
    for rows, xb, d2, inv in _plain_inv(x, centroids, m, eps):
        mu = (inv / s[rows, None]) ** m
        wsums += mu.T.double() @ xb.double()
        weights += mu.sum(dim=0, dtype=torch.float64)
        objective += (mu * d2).sum(dtype=torch.float64)
    return FuzzyStats(weighted_sums=wsums.float(), weights=weights.float(),
                      objective=torch.clamp_min(objective, 0.0).float())


def fuzzy_normalizer(x: torch.Tensor, centroids: torch.Tensor,
                     m: float = 2.0, eps: float = 1e-9, *,
                     return_x2: bool = False):
    """B7: the row normaliser s (N,) f32 = Σ_k (d² + eps)^(−1/(m−1)) over
    THESE centroids, with no (N, K) buffer. With return_x2, also ‖x‖²
    (N,) f32 as the kernel computed it, for `fuzzy_accumulate(x2=...)`."""
    x, centroids = _twopass_operands("fuzzy_normalizer", x, centroids, m)
    if x.device.type == "cpu":
        s = fuzzy_normalizer_plain(x, centroids, m, eps)
        return (s, (x * x).sum(dim=1)) if return_x2 else s
    s, x2 = _normalize_phase(x, centroids, _sq_norms(centroids), m, eps)
    fuzzy_normalizer.launches += 1
    return (s, x2) if return_x2 else s


fuzzy_normalizer.launches = 0


def fuzzy_accumulate(x: torch.Tensor, centroids: torch.Tensor,
                     s: torch.Tensor, m: float = 2.0, eps: float = 1e-9, *,
                     x2: torch.Tensor | None = None) -> FuzzyStats:
    """B8: FuzzyStats of THESE centroids given the row normaliser s (N,)
    f32, from `fuzzy_normalizer` or, in the K-sharded tower, its sum over
    the model shards: Σμx (K, d), Σμ (K,) and Σμd² clamped at 0, with
    u = inv / s and μ = u^m. x2 (‖x‖², as B7 returns it) saves the
    kernel a pass over x; the plain version recomputes it."""
    x, centroids = _twopass_operands("fuzzy_accumulate", x, centroids, m)
    _check_s("fuzzy_accumulate", x, s)
    if x.device.type == "cpu":
        return fuzzy_accumulate_plain(x, centroids, s, m, eps)
    if x2 is None:
        x2 = torch.empty(max(x.shape[0], 1), dtype=torch.float32,
                         device=x.device)
        _build.check(_build.load().lib.tdc_row_sq_norms(
            x.data_ptr(), x.shape[0], x.shape[1], x2.data_ptr(), _stream(x),
        ), "fuzzy_accumulate (row norms)")
    else:
        _check_s("fuzzy_accumulate (x2)", x, x2)
    out = _accumulate_phase(x, centroids, _sq_norms(centroids),
                            s.contiguous(), x2.contiguous(), m, eps)
    fuzzy_accumulate.launches += 1
    return out


fuzzy_accumulate.launches = 0


def fuzzy_stats_twopass(x: torch.Tensor, centroids: torch.Tensor,
                        m: float = 2.0, eps: float = 1e-9) -> FuzzyStats:
    """B7 then B8 on the same centroids: the fuzzy stats of B6, as the
    K-sharded tower computes them on one shard."""
    s, x2 = fuzzy_normalizer(x, centroids, m, eps, return_x2=True)
    return fuzzy_accumulate(x, centroids, s, m, eps, x2=x2)
