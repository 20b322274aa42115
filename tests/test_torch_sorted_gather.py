"""B12 (`gathered_segment_sums`, the sort-based stats with the row gather
fused in) through `sorted_cluster_stats(..., pallas=True,
fuse_gather=True)` on CPU tensors, where the wrapper runs its plain
version, against the JAX package's `_gathered_windowed_stats_pallas` in
interpret mode (automatic off-TPU) on the same seeded inputs.

Cases: a ragged N with labels past k (the K-sharded tower's sentinel) and
negative ones, d not a multiple of 128, bf16 rows, and empty clusters.

Tolerances: counts exactly equal; sums within rtol 1e-5 and atol 1e-4
(float32 summation in another order; |sums| ≲ 100 here, and bf16 rows
are widened exactly in both packages). Within the port, fuse_gather=True
and False give bitwise-equal results on the CPU (both gather x[order]
and sum it in the same order), as B12 and B3 do on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_tpu.ops import sorted_stats as jss
from tdc_tpu_torch.ops import sorted_stats as tss

RTOL, ATOL = 1e-5, 1e-4
CASES = {  # name: (N, K, d, dtype)
    "ragged_sentinel": (1000, 37, 19, "float32"),
    "wide": (2048, 300, 130, "float32"),
    "bf16": (1500, 50, 64, "bfloat16"),
    "empty": (900, 40, 24, "float32"),
}


def _case(name):
    """(x as float32 numpy, labels int32 numpy, k, dtype) for one case."""
    n, k, d, dtype = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.normal(size=(n, d)).astype(np.float32)
    if name == "empty":
        # Only the even clusters own rows: every odd cluster is empty.
        labels = 2 * rng.integers(0, k // 2, size=n)
    else:
        labels = rng.integers(0, k, size=n)
    if name == "ragged_sentinel":
        # The K-sharded tower's sentinel (k) and stray labels both drop.
        labels[rng.random(n) < 0.3] = k
        labels[rng.random(n) < 0.05] = -1
        labels[rng.random(n) < 0.05] = k + 7
    return x, labels.astype(np.int32), k, dtype


def _port_rows(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("name", list(CASES))
def test_fused_gather_matches_the_jax_kernel(name):
    x, labels, k, dtype = _case(name)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    want_sums, want_counts = jss.sorted_cluster_stats(
        jx, labels, k, pallas=True, fuse_gather=True)
    sums, counts = tss.sorted_cluster_stats(
        _port_rows(x, dtype), torch.from_numpy(labels), k, pallas=True,
        fuse_gather=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums),
                               rtol=RTOL, atol=ATOL)
    if name == "empty":
        assert not sums[1::2].any() and not counts[1::2].any()


@pytest.mark.parametrize("name", list(CASES))
def test_fused_and_unfused_are_bitwise_equal(name):
    x, labels, k, dtype = _case(name)
    xt, lt = _port_rows(x, dtype), torch.from_numpy(labels)
    fused = tss.sorted_cluster_stats(xt, lt, k, pallas=True, fuse_gather=True)
    for pallas in (True, False):
        other = tss.sorted_cluster_stats(xt, lt, k, pallas=pallas)
        assert all(torch.equal(a, b) for a, b in zip(fused, other))
    # fuse_gather applies with pallas=True only, as in the JAX package.
    plain = tss.sorted_cluster_stats(xt, lt, k, fuse_gather=True)
    assert all(torch.equal(a, b) for a, b in zip(fused, plain))


def test_gathered_segment_sums_is_b3_on_the_gathered_rows():
    # Rows past the last segment (the sentinel) and empty segments; the
    # plain versions run here and count no launch.
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(200, 33)).astype(np.float32))
    order = torch.from_numpy(rng.permutation(200).astype(np.int32))
    starts = torch.tensor([0, 0, 50, 120, 120, 170], dtype=torch.int32)
    before = (tss.gathered_segment_sums.launches, tss.segment_sums.launches)
    got = tss.gathered_segment_sums(x, order, starts)
    want = tss.segment_sums(x.index_select(0, order).contiguous(), starts)
    assert torch.equal(got, want)
    assert not got[0].any() and not got[3].any()
    assert (tss.gathered_segment_sums.launches,
            tss.segment_sums.launches) == before
    xb = x.to(torch.bfloat16)
    assert torch.equal(tss.gathered_segment_sums(xb, order, starts),
                       tss.segment_sums(xb.index_select(0, order).float(),
                                        starts))


def test_gathered_segment_sums_checks_inputs():
    x = torch.zeros((10, 4))
    order = torch.arange(10, dtype=torch.int32)
    starts = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        tss.gathered_segment_sums(x.double(), order, starts)
    with pytest.raises(TypeError):
        tss.gathered_segment_sums(x, order.long(), starts)
    with pytest.raises(TypeError):
        tss.gathered_segment_sums(x, order[:9], starts)
    with pytest.raises(TypeError):
        tss.gathered_segment_sums(x, order, starts.long())
