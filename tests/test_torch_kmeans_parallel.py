"""k-means‖ seeding of the port against the JAX package's, on the CPU.

JAX's threefry and torch's generators never agree, so the port's draws
are replaced by JAX's own (`JaxDraws` replays `init_kmeans_parallel`'s
key splits: the first index or Gumbel keys, each round's uniforms, the
reduce step's Gumbel keys) and the seeds must then be the same rows,
bitwise (each center is a row of x). The port's row blocks must change
nothing: blocked and unblocked runs from one generator seed give equal
centers. `cosine_similarity` within rtol 1e-6 and atol 1e-6.

The helpers here (`JaxDraws`, `inject`) also serve the other port tests
that seed with 'kmeans||'.
"""

import jax
import numpy as np
import pytest
import torch

from tdc_tpu.models import fuzzy as jfz
from tdc_tpu.models import kmeans as jkm
from tdc_tpu.ops import distance as jdist
from tdc_tpu.ops import kmeans_parallel as jkp
from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.ops import distance as tdist
from tdc_tpu_torch.ops import kmeans_parallel as tkp

RTOL = 1e-5


class JaxDraws:
    """The draws of the JAX package's `init_kmeans_parallel(key, x, k)`,
    in its key-split order, served to the port's `_draw`. Every call of
    the port's `init_kmeans_parallel` starts the sequence again (a fit
    seeded twice with one key draws alike twice)."""

    def __init__(self, key, n, k, *, rounds=5, oversample=None,
                 weighted=False):
        oversample = 2 * k if oversample is None else oversample
        m = rounds * oversample + 1
        key, k0 = jax.random.split(key)
        draws = [("gumbel", jax.random.gumbel(k0, (n,))) if weighted
                 else ("index", jax.random.randint(k0, (), 0, n))]
        for _ in range(rounds):
            key, kr = jax.random.split(key)
            draws.append(("uniform", jax.random.uniform(kr, (n,))))
        key, kf = jax.random.split(key)
        kf, k0 = jax.random.split(kf)
        draws.append(("gumbel", jax.random.gumbel(k0, (m,))))
        for _ in range(1, k):
            kf, ki = jax.random.split(kf)
            draws.append(("gumbel", jax.random.gumbel(ki, (m,))))
        self.draws = [(kind, np.asarray(v)) for kind, v in draws]
        self.i = 0

    def __call__(self, generator, kind, n, device):
        want, value = self.draws[self.i]
        self.i += 1
        assert kind == want and (value.shape == () or value.shape == (n,)),\
            (kind, want, n, value.shape)
        return torch.as_tensor(np.array(value)).to(device)


def inject(monkeypatch, draws: JaxDraws):
    """Serve `draws` to every port k-means‖ call, from the start each
    time."""
    real = tkp.init_kmeans_parallel

    def seeded(*args, **kwargs):
        draws.i = 0
        return real(*args, **kwargs)

    monkeypatch.setattr(tkp, "_draw", draws)
    monkeypatch.setattr(tkp, "init_kmeans_parallel", seeded)


def _blobs(seed=0, n=2000, k=12, d=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    w = rng.uniform(0, 3, size=n).astype(np.float32)
    w[rng.choice(n, n // 10, replace=False)] = 0.0
    return x, w


def _duplicates(seed=1, distinct=9, repeat=40, d=3):
    """Few distinct rows, each repeated: after a round or two almost every
    d² is 0, so a round chooses fewer points than `oversample`."""
    rng = np.random.default_rng(seed)
    rows = rng.uniform(-5, 5, size=(distinct, d)).astype(np.float32)
    return np.repeat(rows, repeat, axis=0)[rng.permutation(distinct
                                                          * repeat)]


CASES = {
    "unweighted": dict(data=_blobs, k=12),
    "weighted": dict(data=_blobs, k=12, weighted=True),
    "few_chosen": dict(data=_duplicates, k=4, oversample=16),
    "few_chosen_weighted": dict(data=_duplicates, k=4, oversample=16,
                                weighted=True),
    # N below one round's oversample: a round fills N slots of its 2K.
    "n_below_oversample": dict(data=lambda: _blobs(3, n=50)[0], k=40),
}


@pytest.mark.parametrize("case", CASES)
def test_same_rows_as_jax_with_its_draws(monkeypatch, case):
    spec = dict(CASES[case])
    data = spec.pop("data")()
    x, w = data if isinstance(data, tuple) else (data, None)
    k, weighted = spec.pop("k"), spec.pop("weighted", False)
    if weighted and w is None:
        w = np.random.default_rng(4).uniform(0, 2, x.shape[0]).astype(
            np.float32)
        w[::7] = 0.0
    sw = w if weighted else None
    key = jax.random.PRNGKey(11)
    want = np.asarray(jkp.init_kmeans_parallel(key, x, k, sample_weight=sw,
                                               **spec))
    draws = JaxDraws(key, x.shape[0], k, weighted=weighted, **spec)
    chosen = []
    real_min = tkp._min_sq_dist

    def spy(x_, x_sq, c, valid, block_rows):
        if valid is not None:
            chosen.append(int(valid.sum()))
        return real_min(x_, x_sq, c, valid, block_rows)

    monkeypatch.setattr(tkp, "_draw", draws)
    monkeypatch.setattr(tkp, "_min_sq_dist", spy)
    got = tkp.init_kmeans_parallel(torch.Generator(), torch.from_numpy(x),
                                   k, sample_weight=sw, **spec)
    assert draws.i == len(draws.draws)
    np.testing.assert_array_equal(got.numpy(), want)
    if case.startswith("few_chosen"):
        assert min(chosen) < spec["oversample"], chosen
    if case == "weighted":
        # Zero-weight rows (all rows distinct here) never seed.
        assert not {r.tobytes() for r in got.numpy()} & {
            r.tobytes() for r in x[w == 0]}


@pytest.mark.parametrize("weighted", [False, True])
def test_row_blocks_change_nothing(weighted):
    x, w = _blobs(5, n=1500, k=10, d=6)
    sw = w if weighted else None
    runs = [tkp.init_kmeans_parallel(torch.Generator().manual_seed(3),
                                     torch.from_numpy(x), 10,
                                     sample_weight=sw, block_rows=rows)
            for rows in (None, 7, 256)]
    for other in runs[1:]:
        assert torch.equal(runs[0], other)
    # K distinct rows of x.
    assert len({r.tobytes() for r in runs[0].numpy()}) == 10
    assert {r.tobytes() for r in runs[0].numpy()} <= {
        r.tobytes() for r in x}


def test_generator_on_another_device_and_unknown_draw():
    x, _ = _blobs()
    with pytest.raises(ValueError, match="unknown draw"):
        tkp._draw(torch.Generator(), "normal", 3, torch.device("cpu"))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkm.kmeans_fit(x, 4, init="kmeans||")


def test_cosine_similarity_against_jax():
    x, _ = _blobs(6, n=300, k=5, d=7)
    x[3] = 0.0  # a zero row: clamped norm, similarity 0
    c = x[10:15] * 2.5
    np.testing.assert_allclose(
        tdist.cosine_similarity(torch.from_numpy(x),
                                torch.from_numpy(c)).numpy(),
        np.asarray(jdist.cosine_similarity(x, c)), rtol=1e-6, atol=1e-6)


def _fit_pair(monkeypatch, fit_j, fit_t, x, k, w=None, mesh=None, **kw):
    key = jax.random.PRNGKey(2)
    inject(monkeypatch, JaxDraws(key, x.shape[0], k, weighted=w is not None))
    j = fit_j(x, k, key=key, sample_weight=w, **kw)
    t = fit_t(x, k, sample_weight=w, mesh=mesh, device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("init", ["kmeans||", "k-means||",
                                  "kmeans_parallel"])
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_fit_seeded_by_kmeans_parallel_against_jax(monkeypatch, init,
                                                          weighted):
    x, w = _blobs(7)
    j, t = _fit_pair(monkeypatch, jkm.kmeans_fit, tkm.kmeans_fit, x, 12,
                     w if weighted else None, init=init, max_iters=10,
                     tol=1e-4)
    assert t.n_iter == int(j.n_iter) and t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(t.sse), float(j.sse), rtol=RTOL)


def test_fuzzy_fit_seeded_by_kmeans_parallel_against_jax(monkeypatch):
    x, _ = _blobs(8)
    j, t = _fit_pair(monkeypatch, jfz.fuzzy_cmeans_fit, tfz.fuzzy_cmeans_fit,
                     x, 12, init="kmeans||", max_iters=10, tol=1e-4)
    assert t.n_iter == int(j.n_iter)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)


def test_seeding_script_forms_give_the_same_seeds(monkeypatch):
    # scripts/seeding_phases.py times k-means‖ in its block form and in
    # the masked form first written; on the CPU too both pick the same
    # rows.
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "seeding_phases.py"
    spec = importlib.util.spec_from_file_location("seeding_phases", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    x, w = _blobs(9, n=1200, k=10, d=6)
    seeds = {}
    for form, parts in script.FORMS.items():
        with monkeypatch.context() as m:
            for name, fn in parts.items():
                m.setattr(tkp, name, fn)
            seeds[form] = tkp.init_kmeans_parallel(
                torch.Generator().manual_seed(4), torch.from_numpy(x), 10,
                sample_weight=w)
    assert set(seeds) == {"blocks", "masked"}
    assert torch.equal(seeds["blocks"], seeds["masked"])
