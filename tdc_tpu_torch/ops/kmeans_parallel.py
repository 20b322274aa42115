"""k-means‖ (k-means parallel) seeding (counterpart:
tdc_tpu/ops/kmeans_parallel.py).

The oversampling scheme of Bahmani et al.: a few rounds, each sampling
~ℓ candidates independently per point with probability ℓ·d²(x)/Σd², then
a weighted k-means++ over the small candidate pool. The rounds, the pool
of rounds·ℓ + 1 slots (ℓ = 2K by default), the validity masks, the owner
mass and the reduce step are the JAX version's.

Two things differ in form, not in result:

- Memory. The JAX version materialises an (N, ℓ) distance matrix every
  round and an (N, pool) one for the owner pass: at N=2^22, K=1024 that
  is 32 GiB a round and 160 GiB at the end. Here both run in row blocks
  of at most 2^27 elements (`block_rows`) over the valid candidates only;
  every quantity taken from them is a per-row min or argmin, so neither
  changes a result. ‖x‖² is computed once per seeding.
- Draws. JAX's threefry and torch's generators never agree, so every
  draw goes through `_draw`, in the order the JAX version splits its key:
  the first center's index (or its Gumbel keys with weights), each
  round's (N,) uniforms, then the reduce step's Gumbel keys. A test can
  replace `_draw` with JAX's own draws.

Ties follow JAX: candidates are ranked by a stable sort, and argmin and
argmax take the first index among equals. The owner mass is summed in a
fixed order (`ops/assign.segment_sum`), so the seeding repeats bitwise on
the card. It runs no kernel: the products are plain f32 matmuls, as the
JAX version computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.ops.assign import segment_sum
from tdc_tpu_torch.ops.distance import pairwise_sq_dist
from tdc_tpu_torch.ops.init import _gumbel, _log_mass

# Elements of one (rows, columns) distance block: 512 MiB of f32.
BLOCK_ELEMS = 1 << 27


def _draw(generator: torch.Generator, kind: str, n: int,
          device: torch.device) -> torch.Tensor:
    """Every random draw of the seeding: 'index', one index uniform in
    [0, n) (a 0-d int64 tensor); 'gumbel', (n,) standard Gumbel keys;
    'uniform', (n,) uniforms in [0, 1)."""
    if kind == "index":
        return torch.randint(0, n, (), generator=generator, device=device)
    if kind == "gumbel":
        return _gumbel(generator, n, device)
    if kind == "uniform":
        return torch.rand(n, generator=generator, device=device)
    raise ValueError(f"unknown draw {kind!r}")


def _blocks(n: int, cols: int, block_rows: int | None):
    rows = block_rows or max(1, BLOCK_ELEMS // max(cols, 1))
    return range(0, n, rows), rows


def _sq_dist(xb, xb_sq, c, c_sq):
    """(rows, cols) ‖x‖² − 2x·c + ‖c‖², clamped at 0 (the matmul form of
    `pairwise_sq_dist`): one product with ‖c‖² added in its epilogue,
    then ‖x‖² and the clamp in place, so each block is written once and
    read twice."""
    d2 = torch.addmm(c_sq, xb, c.T, alpha=-2.0)
    return d2.add_(xb_sq[:, None]).clamp_min_(0.0)


def _valid_columns(c, valid):
    """The valid rows of c and their indices, in order (one host read of
    the mask's count)."""
    idx = torch.nonzero(valid)[:, 0]
    return c.index_select(0, idx), idx


def _min_sq_dist(x, x_sq, c, valid, block_rows):
    """(N,) min over the valid rows of c of the squared distance, in row
    blocks (+inf where no row of c is valid)."""
    if valid is not None:
        c = _valid_columns(c, valid)[0]
    if c.shape[0] == 0:
        return torch.full_like(x_sq, float("inf"))
    c_sq = (c * c).sum(dim=-1)
    starts, rows = _blocks(x.shape[0], c.shape[0], block_rows)
    return torch.cat([
        _sq_dist(x[s:s + rows], x_sq[s:s + rows], c, c_sq).min(dim=1).values
        for s in starts])


def _owner(x, x_sq, pool, valid, block_rows):
    """(N,) index of each row's nearest valid pool slot (the first among
    equals), in row blocks."""
    c, idx = _valid_columns(pool, valid)
    c_sq = (c * c).sum(dim=-1)
    starts, rows = _blocks(x.shape[0], c.shape[0], block_rows)
    return idx[torch.cat([
        torch.argmin(_sq_dist(x[s:s + rows], x_sq[s:s + rows], c, c_sq),
                     dim=1) for s in starts])]


def init_kmeans_parallel(
    generator: torch.Generator,
    x: torch.Tensor,
    k: int,
    *,
    rounds: int = 5,
    oversample: int | None = None,
    sample_weight=None,
    block_rows: int | None = None,
) -> torch.Tensor:
    """k-means‖ seeding: returns (K, d) f32 centers on x's device.

    The candidate pool has rounds·oversample + 1 slots (slot 0 the first
    center); a round that chooses fewer than `oversample` points leaves
    its other slots invalid. Default oversampling 2K per round. With
    sample_weight, sampling probabilities use w·d² and candidates are
    weighted by the point mass they attract (zero-weight points never
    seed). `block_rows` sets the row blocks of the distance passes (None:
    at most BLOCK_ELEMS elements a block).
    """
    n, d = x.shape
    if oversample is None:
        oversample = 2 * k
    dev = x.device
    xf = x.to(torch.float32)
    sw = (None if sample_weight is None
          else torch.as_tensor(sample_weight, dtype=torch.float32,
                               device=dev))
    pool_size = rounds * oversample + 1

    if sw is None:
        first_idx = _draw(generator, "index", n, dev).reshape(1)
    else:
        first_idx = torch.argmax(
            _log_mass(sw) + _draw(generator, "gumbel", n, dev)).reshape(1)
    first = xf.index_select(0, first_idx)  # (1, d)

    pool = torch.zeros((pool_size, d), dtype=torch.float32, device=dev)
    pool[:1] = first
    pool_valid = torch.zeros(pool_size, dtype=torch.bool, device=dev)
    pool_valid[0] = True
    x_sq = (xf * xf).sum(dim=-1)
    d2 = _min_sq_dist(xf, x_sq, first, None, block_rows)
    for r in range(rounds):
        wd2 = d2 if sw is None else sw * d2
        cost = wd2.sum()
        # Bernoulli per point: p = min(1, l·(w·)d² / cost).
        p = torch.clamp_max(oversample * wd2 / torch.clamp_min(cost, 1e-30),
                            1.0)
        u = _draw(generator, "uniform", n, dev)
        chosen = u < p
        # At most `oversample` chosen points, ranked by u/p (uniform among
        # the chosen), the smallest first.
        score = torch.where(chosen, u / torch.clamp_min(p, 1e-30),
                            float("inf"))
        order = torch.argsort(score, stable=True)[:oversample]
        valid = chosen[order]
        cands = xf.index_select(0, order)
        start = 1 + r * oversample
        pool[start:start + order.shape[0]] = cands
        pool_valid[start:start + order.shape[0]] = valid
        # The running min distance moves for the valid candidates only.
        d2 = torch.minimum(d2, _min_sq_dist(xf, x_sq, cands, valid,
                                            block_rows))

    # Weight each candidate by the mass it attracts, then a weighted
    # k-means++ over the pool picks the K centers.
    owner = _owner(xf, x_sq, pool, pool_valid, block_rows)
    mass = torch.ones(n, dtype=torch.float32, device=dev) if sw is None \
        else sw
    weights = torch.where(pool_valid, segment_sum(mass, owner, pool_size),
                          0.0)
    return _weighted_kmeans_pp(generator, pool, weights, k)


def _weighted_kmeans_pp(generator: torch.Generator, pts: torch.Tensor,
                        weights: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ over a small weighted candidate set (the k-means‖ reduce
    step): the first center ∝ weight, each later one ∝ weight·D², by a
    Gumbel top-1 over the log mass."""
    m, d = pts.shape
    dev = pts.device
    first = torch.argmax(_log_mass(weights)
                         + _draw(generator, "gumbel", m, dev)).reshape(1)
    centers = torch.zeros((k, d), dtype=torch.float32, device=dev)
    c = pts.index_select(0, first)
    centers[:1] = c
    d2 = pairwise_sq_dist(pts, c)[:, 0]
    for i in range(1, k):
        lw = _log_mass(weights * d2)
        nxt = torch.argmax(lw + _draw(generator, "gumbel", m, dev)
                           ).reshape(1)
        c = pts.index_select(0, nxt)
        centers[i:i + 1] = c
        d2 = torch.minimum(d2, pairwise_sq_dist(pts, c)[:, 0])
    return centers


__all__ = ["init_kmeans_parallel"]
