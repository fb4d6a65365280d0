"""The cluster-by-cluster IVF scoring of ``csrc/ivf.cu`` on the CPU: the
plain grouping (``ops/retrieval.ivf_group_plain``) and the PyTorch mirror
of the scoring (``ivf_score_clusters``).

The grouping is held against its contract - every (query, rank) pair
exactly once, runs of one cluster in ascending pair order, runs in
ascending cluster order with probe ids off the index last (cluster -1),
groups of ``IVF_GROUP`` pairs apart - and against an independent numpy
grouping, exactly, on real probes, every query on the same clusters (runs
longer than a pass of ``IVF_PASS`` queries), one pass's worth of pairs on
one cluster, every pair on a cluster of its own, ids off the index, and
more pairs than a group.  The mirror is held against ``ivf_score_plain``
(ids and empty slots exactly, scores within 1e-5 of their scale) and,
with the top-k of ``ivf_search`` after it, against the JAX package's
``_ivf_search_pallas`` in interpret mode (tile-aligned int8) and
``_ivf_search_xla`` (int8, bf16, f32; ragged D, empty slots) on queries
that share clusters: ids equal where the scores are distinct, scores
within 1e-5 of their scale (f32 sums in another order), as
``tests/test_torch_retrieval.py`` holds the plain version.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai00_server_tpu.ops import retrieval as JR
from ai00_server_tpu_torch.ops import retrieval as TR
from ai00_server_tpu_torch.testing import cpu_test_threads

from test_torch_retrieval import T, clustered, close, same_hits

cpu_test_threads()


# ---------------------------------------------------------------------------
# The grouping
# ---------------------------------------------------------------------------


def probes(case):
    """(probe (Q, nprobe) int32, nlist, group) of a named case."""
    rng = np.random.default_rng(len(case))
    if case == "real":
        return rng.integers(0, 1024, (64, 8)), 1024, TR.IVF_GROUP
    if case == "shared":  # runs of 80 > a pass of IVF_PASS queries
        return np.tile(rng.permutation(50)[:8], (80, 1)), 50, TR.IVF_GROUP
    if case == "one-pass":  # IVF_PASS pairs on cluster 3, the rest apart
        p = np.arange(TR.IVF_PASS * 4).reshape(TR.IVF_PASS, 4) + 4
        p[:, 2] = 3
        return p, 200, TR.IVF_GROUP
    if case == "distinct":
        return rng.permutation(512).reshape(64, 8), 512, TR.IVF_GROUP
    if case == "off-index":
        p = rng.integers(-3, 13, (20, 5))
        return p, 10, TR.IVF_GROUP
    if case == "groups":  # 3 groups of 16 pairs and a ragged one
        return rng.integers(-1, 7, (13, 4)), 6, 16
    raise KeyError(case)


CASES = ["real", "shared", "one-pass", "distinct", "off-index", "groups"]


def numpy_grouping(flat, nlist, group):
    """An independent grouping: per group, a lexsort by (cluster key,
    position), runs by np.unique."""
    P = flat.size
    runs = np.zeros((P, 4), np.int32)
    runs[:, 2] = -1
    order = np.zeros(P, np.int32)
    for base in range(0, P, group):
        c = flat[base:base + group]
        key = np.where((c >= 0) & (c < nlist), c, nlist)
        pos = np.lexsort((np.arange(c.size), key))
        order[base:base + c.size] = base + pos
        vals, first, counts = np.unique(key[pos], return_index=True,
                                        return_counts=True)
        k = vals.size
        runs[base:base + k, 0] = base + first
        runs[base:base + k, 1] = counts
        runs[base:base + k, 2] = np.where(vals < nlist, vals, -1)
    return runs, order


@pytest.mark.parametrize("case", CASES)
def test_grouping_holds_its_contract(case):
    probe, nlist, group = probes(case)
    flat = probe.reshape(-1)
    runs, order = TR.ivf_group_plain(torch.from_numpy(probe.astype(np.int32)),
                                     nlist, group=group)
    runs, order = runs.numpy(), order.numpy()
    P = flat.size
    assert sorted(order.tolist()) == list(range(P))  # each pair once
    for base in range(0, P, group):
        n = min(group, P - base)
        rs = runs[base:base + n]
        live = rs[rs[:, 1] > 0]
        assert (rs[len(live):] == [0, 0, -1, 0]).all()  # compact
        assert live[:, 1].sum() == n  # the runs tile the group
        assert (live[1:, 0] == live[:-1, 0] + live[:-1, 1]).all()
        assert live[0, 0] == base
        keys = []
        for start, length, c, _ in live:
            members = order[start:start + length]
            assert (np.diff(members) > 0).all()  # stable
            assert ((members >= base) & (members < base + n)).all()
            got = flat[members]
            if c >= 0:
                assert (got == c).all()
                keys.append(c)
            else:  # ids off the index: one run, last
                assert ((got < 0) | (got >= nlist)).all()
                keys.append(nlist)
        assert keys == sorted(set(keys))
    if case == "shared":
        assert (runs[:8, 1] == 80).all() and 80 > TR.IVF_PASS
    if case == "one-pass":
        assert runs[0, 1] == TR.IVF_PASS and runs[0, 2] == 3


@pytest.mark.parametrize("case", CASES)
def test_grouping_equals_numpy(case):
    probe, nlist, group = probes(case)
    runs, order = TR.ivf_group_plain(torch.from_numpy(probe.astype(np.int32)),
                                     nlist, group=group)
    want_runs, want_order = numpy_grouping(probe.reshape(-1), nlist, group)
    np.testing.assert_array_equal(runs.numpy(), want_runs)
    np.testing.assert_array_equal(order.numpy(), want_order)


# ---------------------------------------------------------------------------
# The mirror of the scoring against the plain version
# ---------------------------------------------------------------------------


def operands(dtype, Q, nprobe, nlist, cap, D, skew, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        packed = torch.randint(-127, 128, (nlist, cap, D), generator=gen,
                               dtype=torch.int32).to(torch.int8)
        pscale = torch.rand(nlist, cap, generator=gen) / 127
    else:
        packed = torch.randn(nlist, cap, D, generator=gen).to(dtype)
        pscale = None
    ids = torch.arange(nlist * cap, dtype=torch.int32).reshape(nlist, cap)
    ids[:, cap - cap // 3:] = -1
    ids[1] = -1
    q = torch.randn(Q, D, generator=gen)
    probe = torch.randint(0, nlist, (Q, nprobe), generator=gen,
                          dtype=torch.int32)
    if skew == "shared":
        probe = probe[:1].expand(Q, nprobe).contiguous()
    elif skew == "off-index":
        probe[0, 0], probe[1, 1], probe[2, 0] = -1, nlist, 1
    return packed, ids, pscale, q, probe


MIRROR_CASES = {
    # name: (Q, nprobe, nlist, cap, D, skew)
    "off-index": (7, 3, 9, 150, 37, "off-index"),
    "long-runs": (80, 3, 9, 40, 24, "shared"),
    "groups": (300, 4, 40, 20, 16, "random"),
}


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_mirror_equals_plain(dtype, case):
    Q, nprobe, nlist, cap, D, skew = MIRROR_CASES[case]
    args = operands(dtype, Q, nprobe, nlist, cap, D, skew, Q + D)
    s_m, i_m = TR.ivf_score_clusters(*args)
    s_p, i_p = TR.ivf_score_plain(*args)
    assert torch.equal(i_m, i_p)
    fin = torch.isfinite(s_p)
    assert torch.equal(torch.isfinite(s_m), fin)
    close(s_m[fin].numpy(), s_p[fin].numpy())
    if case == "off-index":
        assert (i_m[0, 0] == -1).all() and (i_m[1, 1] == -1).all()
        assert not fin[2, 0].any()  # cluster 1 is all empty slots


# ---------------------------------------------------------------------------
# The mirror, with the top-k after it, against the JAX probe paths
# ---------------------------------------------------------------------------


def mirror_search(centroids, packed, packed_ids, queries, k, nprobe,
                  pscale=None):
    """``ivf_search`` with the mirror in place of ``ivf_score``."""
    q, probe = TR._ivf_probe(centroids, queries, nprobe)
    scores, ids = TR.ivf_score_clusters(packed, packed_ids, pscale, q, probe)
    Q = q.shape[0]
    top, pos = torch.topk(scores.reshape(Q, -1), k, dim=-1)
    out = torch.gather(ids.reshape(Q, -1), 1, pos)
    return top, torch.where(torch.isfinite(top), out, -1), probe


def shared_queries(x, Q, seed, spread):
    """Q queries around two of the data's rows: most share their probes."""
    rng = np.random.default_rng(seed)
    base = x[rng.integers(0, len(x), 2)]
    return (base[np.arange(Q) % 2] + spread * rng.standard_normal(
        (Q, x.shape[1]))).astype(np.float32)


@pytest.mark.parametrize("nprobe", [2, 4])
def test_mirror_search_equals_pallas_interpret(nprobe):
    """The tile-aligned int8 layout (cap and D multiples of 128)."""
    rng = np.random.default_rng(30 + nprobe)
    N, D, nlist = 2048, 128, 8
    data = rng.standard_normal((N, D)).astype(np.float32)
    idx = JR.build_ivf(data, nlist=nlist, iters=4, quant="int8")
    cap = -(-idx.cap // 128) * 128
    packed = jnp.zeros((nlist, cap, D), jnp.int8).at[:, :idx.cap].set(
        idx.packed)
    pids = jnp.full((nlist, cap), -1, jnp.int32).at[:, :idx.cap].set(
        idx.packed_ids)
    ps = jnp.zeros((nlist, cap), jnp.float32).at[:, :idx.cap].set(
        idx.pscale)
    q = shared_queries(data, 6, nprobe, 0.05)
    js, ji = JR._ivf_search_pallas(idx.centroids, packed, pids,
                                   jnp.asarray(q), k=10, nprobe=nprobe,
                                   pscale=ps, interpret=True)
    ts, ti, probe = mirror_search(T(idx.centroids), T(packed), T(pids),
                                  T(q), 10, nprobe, pscale=T(ps))
    runs, _ = TR.ivf_group_plain(probe, nlist)
    assert int(runs[:, 1].max()) > 1  # queries share clusters
    same_hits(ts, ti, js, ji)


@pytest.mark.parametrize("spread", [0.02, 0.3])
@pytest.mark.parametrize("quant", ["int8", "bf16", "f32"])
def test_mirror_search_equals_xla(quant, spread):
    """Ragged D (24) and cap, a cluster of empty slots; queries close
    together (spread 0.02: nearly every probe shared) or apart."""
    x = clustered(300, 24, seed=40)
    kw = ({"quant": "int8"} if quant == "int8"
          else {"dtype": jnp.float32 if quant == "f32" else jnp.bfloat16})
    idx = JR.build_ivf(x, nlist=8, iters=4, seed=40, **kw)
    pids = np.asarray(idx.packed_ids).copy()
    pids[2] = -1
    idx.packed_ids = jnp.asarray(pids)
    q = shared_queries(x, 6, 41, spread)
    js, ji = JR._ivf_search_xla(idx.centroids, idx.packed, idx.packed_ids,
                                jnp.asarray(q), k=10, nprobe=3,
                                pscale=idx.pscale)
    ts, ti, probe = mirror_search(
        T(idx.centroids), T(idx.packed), T(idx.packed_ids), T(q), 10, 3,
        pscale=None if idx.pscale is None else T(idx.pscale))
    runs, _ = TR.ivf_group_plain(probe, idx.nlist)
    assert int(runs[:, 1].max()) > 1  # queries share clusters
    same_hits(ts, ti, js, ji)
