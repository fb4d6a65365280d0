"""The port's retrieval ops and store against the JAX package's.

Inputs come from numpy seeds and go to both packages.  ``ivf_score_plain``
(what ``ivf_search`` runs on CPU tensors) with the top-k after it is held
against ``_ivf_search_pallas`` in interpret mode at a tile-aligned int8
layout, and against ``_ivf_search_xla`` at ragged shapes in f32, bf16 and
int8, with ``cbias``, k > cap, nprobe = nlist, empty slots and Q > 1: ids
equal where the scores are distinct, scores within 1e-5 of their scale (f32
sums in another order).  k-means, given the indices JAX drew
(``init_idx``), gives centroids and bias within 1e-5 of their scale; the
IVF build, the streamed builder (spill included), the chunked ground
truth and the store are equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.ops import retrieval as JR
from ai00_server_tpu.retrieval_store import RetrievalStore as JStore

from ai00_server_tpu_torch.ops import retrieval as TR
from ai00_server_tpu_torch.retrieval_store import RetrievalStore as TStore

TOL = 1e-5


def T(x):
    """numpy / JAX array -> torch CPU tensor, dtype kept (bf16 included)."""
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def clustered(n, d, modes=16, spread=0.2, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((modes, d)).astype(np.float32)
    x = centers[rng.integers(0, modes, n)] + spread * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale


def same_hits(ts, ti, js, ji):
    """Scores close; -inf exactly where JAX has -inf; ids equal wherever
    the score is finite and distinct from the other scores of its row."""
    ts, js = np.asarray(ts, np.float64), np.asarray(js, np.float64)
    ti, ji = np.asarray(ti), np.asarray(ji)
    assert ts.shape == js.shape and ti.shape == ji.shape
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    close(ts[fin], js[fin])
    np.testing.assert_array_equal(ti[~fin], ji[~fin])
    for r in range(js.shape[0]):
        for c in range(js.shape[1]):
            if fin[r, c] and np.sum(np.abs(js[r] - js[r, c]) < 1e-6) == 1:
                assert ti[r, c] == ji[r, c], (r, c)


def jax_init(key_seed, n, nlist):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(key_seed), n,
                                        (nlist,), replace=False))


# ---------------------------------------------------------------------------
# ivf_score + top-k against the two JAX probe paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nprobe", [1, 4])
def test_ivf_search_equals_pallas_interpret(nprobe):
    """The tile-aligned int8 layout ``bench_ivf`` builds (cap % 128 == 0),
    as tests/test_retrieval.py pins the Pallas kernel."""
    rng = np.random.default_rng(3)
    N, D, nlist = 4096, 128, 8
    data = rng.standard_normal((N, D)).astype(np.float32)
    idx = JR.build_ivf(data, nlist=nlist, iters=5, quant="int8")
    cap = -(-idx.cap // 128) * 128
    packed = jnp.zeros((nlist, cap, D), jnp.int8).at[:, :idx.cap].set(
        idx.packed)
    pids = jnp.full((nlist, cap), -1, jnp.int32).at[:, :idx.cap].set(
        idx.packed_ids)
    ps = jnp.zeros((nlist, cap), jnp.float32).at[:, :idx.cap].set(
        idx.pscale)
    q = rng.standard_normal((6, D)).astype(np.float32)
    js, ji = JR._ivf_search_pallas(idx.centroids, packed, pids,
                                   jnp.asarray(q), k=10, nprobe=nprobe,
                                   pscale=ps, interpret=True)
    before = TR.ivf_score.launches
    ts, ti = TR.ivf_search(T(idx.centroids), T(packed), T(pids), T(q),
                           k=10, nprobe=nprobe, pscale=T(ps))
    assert TR.ivf_score.launches == before  # CPU tensors: the plain version
    same_hits(ts, ti, js, ji)


def _ragged_index(quant, seed, n=300, d=24, nlist=8, empty=False):
    """A host-built IVF (cap ragged, D ragged) in bf16, f32 or int8; with
    ``empty`` one cluster's rows are all turned into empty slots."""
    x = clustered(n, d, seed=seed)
    kw = ({"quant": "int8"} if quant == "int8"
          else {"dtype": jnp.float32 if quant == "f32" else jnp.bfloat16})
    idx = JR.build_ivf(x, nlist=nlist, iters=4, seed=seed, **kw)
    if empty:
        pids = np.asarray(idx.packed_ids).copy()
        pids[2] = -1
        idx.packed_ids = jnp.asarray(pids)
    return x, idx


SEARCH_CASES = {
    # name: (quant, Q, k, nprobe, cbias, empty)
    "f32": ("f32", 5, 10, 3, False, False),
    "bf16": ("bf16", 5, 10, 3, False, False),
    "int8": ("int8", 5, 10, 3, False, False),
    "f32-k-over-cap": ("f32", 3, 120, 2, False, False),
    "int8-k-over-cap": ("int8", 3, 120, 1, False, False),
    "int8-full-probe": ("int8", 4, 10, 8, False, False),
    "bf16-full-probe": ("bf16", 4, 10, 8, False, False),
    "f32-cbias": ("f32", 5, 7, 3, True, False),
    "int8-cbias": ("int8", 5, 7, 3, True, False),
    "int8-empty-slots": ("int8", 6, 12, 4, False, True),
    "f32-one-query": ("f32", 1, 4, 2, False, False),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_ivf_search_equals_xla(case):
    quant, Q, k, nprobe, with_bias, empty = SEARCH_CASES[case]
    x, idx = _ragged_index(quant, seed=len(case), empty=empty)
    rng = np.random.default_rng(7)
    q = x[rng.integers(0, len(x), Q)] + 0.05 * rng.standard_normal(
        (Q, x.shape[1])).astype(np.float32)
    cbias = (rng.standard_normal(idx.nlist).astype(np.float32) * 0.2
             if with_bias else None)
    js, ji = JR._ivf_search_xla(
        idx.centroids, idx.packed, idx.packed_ids, jnp.asarray(q), k=k,
        nprobe=nprobe, pscale=idx.pscale,
        cbias=None if cbias is None else jnp.asarray(cbias))
    ts, ti = TR.ivf_search(
        T(idx.centroids), T(idx.packed), T(idx.packed_ids), T(q), k=k,
        nprobe=nprobe, pscale=None if idx.pscale is None else T(idx.pscale),
        cbias=None if cbias is None else T(cbias))
    assert ti.dtype == torch.int32
    same_hits(ts, ti, js, ji)


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_ivf_score_plain_table(quant):
    """The dense (Q, nprobe, cap) tables: pads -inf with id -1, every other
    entry the f32 dot of the query (bf16-rounded for int8) with the row,
    times its scale."""
    x, idx = _ragged_index(quant, seed=4, empty=True)
    q = T(x[:3])
    probe = torch.tensor([[2, 0], [1, 2], [5, 5]], dtype=torch.int32)
    ps = None if idx.pscale is None else T(idx.pscale)
    s, i = TR.ivf_score_plain(T(idx.packed), T(idx.packed_ids), ps, q, probe)
    assert s.shape == i.shape == (3, 2, idx.cap)
    packed = T(idx.packed).float().numpy()
    pids = np.asarray(idx.packed_ids)
    qd = q.bfloat16().float().numpy() if quant == "int8" else q.numpy()
    for qi in range(3):
        for r in range(2):
            c = int(probe[qi, r])
            want = packed[c] @ qd[qi]
            if ps is not None:
                want = want * ps[c].numpy()
            want = np.where(pids[c] >= 0, want, -np.inf)
            np.testing.assert_array_equal(i[qi, r].numpy(), pids[c])
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(s[qi, r].numpy()), fin)
            assert fin.any() == (c != 2)  # cluster 2 is all empty slots
            if fin.any():
                close(s[qi, r].numpy()[fin], want[fin])


def test_ivf_score_launches_only_on_cuda_tensors():
    x, idx = _ragged_index("int8", seed=5)
    before = TR.ivf_score.launches
    TR.ivf_score(T(idx.packed), T(idx.packed_ids), T(idx.pscale),
                 T(x[:2]), torch.zeros((2, 1), dtype=torch.int32))
    assert TR.ivf_score.launches == before


# ---------------------------------------------------------------------------
# Exact search, k-means, the IVF build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_exact_search_equals_jax(dtype):
    x = clustered(500, 32, seed=1)
    q = x[:7] + 0.01
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    js, ji = JR.exact_search(jnp.asarray(x, jdt), jnp.asarray(q, jdt), k=6)
    ts, ti = TR.exact_search(T(x).to(tdt), T(q).to(tdt), k=6)
    same_hits(ts, ti, js, ji)
    np.testing.assert_array_equal(ti[:, 0].numpy(), np.arange(7))


@pytest.mark.parametrize("iters", [1, 6])
def test_kmeans_equals_jax_given_its_draw(iters):
    x = clustered(512, 24, seed=2)
    init = jax_init(3, 512, 8)
    jc = JR.kmeans(jax.random.PRNGKey(3), jnp.asarray(x), 8, iters)
    tc = TR.kmeans(T(x), 8, iters, init_idx=init)
    close(tc, jc)


@pytest.mark.parametrize("balance", [False, True])
def test_kmeans_blocked_equals_jax_given_its_draw(balance):
    x = clustered(512, 24, seed=3)
    init = jax_init(4, 512, 8)
    jo = JR.kmeans_blocked(jax.random.PRNGKey(4), jnp.asarray(x), 8,
                           iters=5, blk=128, balance=balance)
    to = TR.kmeans_blocked(T(x), 8, iters=5, blk=128, balance=balance,
                           init_idx=init)
    if balance:
        close(to[0], jo[0])
        close(to[1], jo[1])
    else:
        close(to, jo)


def test_kmeans_blocked_rounds_counts_as_jax():
    """A block with more than 256 rows in one cluster: JAX's bf16 one-hot
    sum rounds the block's count (601 -> 600, 301 -> 300), and so does the
    port.  Three well-separated modes, one under each row JAX draws as a
    seed, so no assignment is near a tie."""
    rng = np.random.default_rng(9)
    init = jax_init(0, 1024, 3)
    label = np.full(1024, -1)
    label[init] = [0, 1, 2]
    rest = np.repeat([0, 1, 2], [600, 300, 121])
    label[label < 0] = rng.permutation(rest)
    modes = 3.0 * np.eye(3, 4, dtype=np.float32)
    x = modes[label] + 0.01 * rng.standard_normal((1024, 4)).astype(
        np.float32)
    jc = JR.kmeans_blocked(jax.random.PRNGKey(0), jnp.asarray(x), 3,
                           iters=1, blk=1024)
    tc = TR.kmeans_blocked(T(x), 3, iters=1, blk=1024, init_idx=init)
    close(tc, jc)
    exact = np.stack([x.astype(jnp.bfloat16).astype(np.float32)[
        label == m].mean(0) for m in range(3)])
    assert np.abs(tc.numpy()[0] - exact[0]).max() > 1e-3  # 601 / 600


def test_kmeans_draws_from_its_generator():
    x = T(clustered(256, 8, seed=4))
    a = TR.kmeans(x, 4, 2, generator=torch.Generator().manual_seed(1))
    b = TR.kmeans(x, 4, 2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


@pytest.mark.parametrize("quant", ["bf16", "f32", "int8"])
def test_build_ivf_equals_jax(quant):
    x = clustered(600, 20, seed=5)
    kw = ({"quant": "int8"} if quant == "int8"
          else {"dtype": jnp.float32 if quant == "f32" else jnp.bfloat16})
    j = JR.build_ivf(x, nlist=8, iters=5, seed=0, **kw)
    t = TR.build_ivf(x, nlist=8, iters=5, seed=0, device="cpu",
                     init_idx=jax_init(0, 600, 8),
                     **({"quant": "int8"} if quant == "int8" else
                        {"dtype": torch.float32 if quant == "f32"
                         else torch.bfloat16}))
    close(t.centroids, j.centroids)
    assert (t.nlist, t.cap) == (j.nlist, j.cap)
    assert t.packed.dtype == {"bf16": torch.bfloat16, "f32": torch.float32,
                              "int8": torch.int8}[quant]
    np.testing.assert_array_equal(t.packed_ids.numpy(), j.packed_ids)
    np.testing.assert_array_equal(t.packed.float().numpy(),
                                  np.asarray(j.packed, np.float32))
    if quant == "int8":
        np.testing.assert_array_equal(t.pscale.numpy(), j.pscale)
    else:
        assert t.pscale is None and j.pscale is None


def test_build_ivf_subsamples_like_jax():
    """N > train_sample: both draw the same training rows with numpy."""
    x = clustered(400, 16, seed=6)
    j = JR.build_ivf(x, nlist=4, iters=3, seed=2, train_sample=300)
    t = TR.build_ivf(x, nlist=4, iters=3, seed=2, train_sample=300,
                     device="cpu", init_idx=jax_init(2, 300, 4))
    close(t.centroids, j.centroids)
    np.testing.assert_array_equal(t.packed_ids.numpy(), j.packed_ids)


def test_assign_chunked_equals_jax():
    x = clustered(700, 12, seed=7)
    cent = clustered(9, 12, seed=8)
    np.testing.assert_array_equal(
        TR._assign_chunked(x, T(cent), chunk=256),
        JR._assign_chunked(x, cent, chunk=256))


def test_ivf_index_from_numpy():
    x, j = _ragged_index("bf16", seed=9)
    t = TR.IVFIndex.from_numpy(j, "cpu")
    assert t.packed.dtype == torch.bfloat16 and (t.nlist, t.cap) == (
        j.nlist, j.cap)
    np.testing.assert_array_equal(t.packed.float().numpy(),
                                  np.asarray(j.packed, np.float32))
    np.testing.assert_array_equal(t.packed_ids.numpy(), j.packed_ids)
    assert t.pscale is None and t.cbias is None
    _, j8 = _ragged_index("int8", seed=9)
    t8 = TR.IVFIndex.from_numpy(j8, "cpu")
    np.testing.assert_array_equal(t8.pscale.numpy(), j8.pscale)


# ---------------------------------------------------------------------------
# Streamed build and ground truth
# ---------------------------------------------------------------------------

STREAM_CASES = {
    # cap, spill, chunk, cbias
    "no-spill": (96, 3, 128, False),
    "spill": (40, 4, 96, False),
    "drops": (20, 2, 96, False),
    "cbias": (48, 3, 64, True),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_builder_equals_jax(case):
    cap, spill, chunk, with_bias = STREAM_CASES[case]
    x = clustered(256, 32, modes=3, spread=0.3, seed=10)
    cent = JR.kmeans_blocked(jax.random.PRNGKey(1), jnp.asarray(x), nlist=8,
                             iters=4, blk=256)
    rng = np.random.default_rng(11)
    cbias = (rng.standard_normal(8).astype(np.float32) * 0.1
             if with_bias else None)
    jb = JR.StreamedIVFBuilder(
        cent, cap=cap, dim=32, spill=spill,
        cbias=None if cbias is None else jnp.asarray(cbias))
    tb = TR.StreamedIVFBuilder(T(cent), cap=cap, dim=32, spill=spill,
                               cbias=None if cbias is None else T(cbias))
    for i in range(0, 256, chunk):
        jb.add(jnp.asarray(x[i:i + chunk]), i)
        tb.add(T(x[i:i + chunk]), i)
    assert int(tb.dropped) == int(jb.dropped)
    if case == "drops":
        assert int(tb.dropped) > 0
    jv, tv = jb.finish(), tb.finish()
    for name in ("packed", "packed_ids", "pscale"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(jv, name)))
    np.testing.assert_array_equal(tb.fill.numpy(), np.asarray(jb.fill))
    if with_bias:
        np.testing.assert_array_equal(tv.cbias.numpy(), cbias)
    # The streamed index searches like JAX's.
    q = x[:5] + 0.01
    js, ji = JR._ivf_search_xla(jv.centroids, jv.packed, jv.packed_ids,
                                jnp.asarray(q), k=5, nprobe=3,
                                pscale=jv.pscale, cbias=jv.cbias)
    ts, ti = TR.ivf_search(tv.centroids, tv.packed, tv.packed_ids, T(q),
                           k=5, nprobe=3, pscale=tv.pscale, cbias=tv.cbias)
    same_hits(ts, ti, js, ji)


def test_topk_merge_chunk_equals_jax():
    x = clustered(256, 16, seed=12)
    q = x[:6] + 0.01
    js = jnp.full((6, 10), -np.inf, jnp.float32)
    ji = jnp.full((6, 10), -1, jnp.int32)
    ts = torch.full((6, 10), -np.inf)
    ti = torch.full((6, 10), -1, dtype=torch.int32)
    for i in range(0, 256, 100):
        js, ji = JR.topk_merge_chunk(js, ji, jnp.asarray(x[i:i + 100]),
                                     jnp.int32(i), jnp.asarray(q), k=10)
        ts, ti = TR.topk_merge_chunk(ts, ti, T(x[i:i + 100]), i, T(q), k=10)
    same_hits(ts, ti, js, ji)


def test_exact_search_chunked_equals_jax():
    x = clustered(1000, 16, seed=13)
    q = x[:8] + 0.01
    js, ji = JR.exact_search_chunked(x, q, k=10, chunk=333)
    ts, ti = TR.exact_search_chunked(x, q, k=10, chunk=333, device="cpu")
    same_hits(ts, ti, js, ji)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["exact", "ivf", "ivf-int8"])
def test_retrieval_store_equals_jax(mode):
    x = clustered(200, 16, seed=14)
    texts = [f"doc{i}" for i in range(200)]
    stores = (JStore(), TStore(device="cpu"))
    for s in stores:
        s.create("docs", 16)
        assert s.add("docs", x[:150], texts[:150]) == 150
        assert s.add("docs", x[150:], texts[150:]) == 200
    q = x[[3, 77, 160]] + 0.01
    if mode != "exact":
        quant = "int8" if mode == "ivf-int8" else None
        stores[0].build_ivf("docs", nlist=8, iters=5, quant=quant)
        # Same centroids: the port's index is the JAX one carried across.
        stores[1].get("docs").ivf = TR.IVFIndex.from_numpy(
            stores[0].get("docs").ivf, "cpu")
    (js, ji, jt), (ts, ti, tt) = (s.search("docs", q, top_k=5, nprobe=3)
                                  for s in stores)
    same_hits(ts, ti, js, ji)
    assert [r[0] for r in tt] == ["doc3", "doc77", "doc160"]
    assert tt == jt
    assert stores[1].list() == stores[0].list()
    stores[1].drop("docs")
    assert stores[1].list() == []


def test_retrieval_store_builds_its_own_ivf():
    store = TStore(device="cpu")
    store.create("docs", 16)
    x = clustered(100, 16, seed=15)
    store.add("docs", x, [f"doc{i}" for i in range(100)])
    store.build_ivf("docs", nlist=8)
    assert store.list()[0]["ivf"] is True
    _, _, hits = store.search("docs", x[:3], top_k=1, nprobe=8)
    assert [h[0] for h in hits] == ["doc0", "doc1", "doc2"]
    with pytest.raises(KeyError):
        store.search("nope", x[:1])
