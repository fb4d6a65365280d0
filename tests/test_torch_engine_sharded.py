"""The port's ``Engine(mesh=...)`` on meshes of CPU places, against the
unsharded port engine and the JAX package's mesh engine.

The CPU stands for every place (``make_mesh(devices=[cpu] * n)``): each
sharded code path runs — the per-rank engines at the local batch, the tp
layer path on H / tp heads with its partial sums added in f32, the vocab
slices of the head gathered — on one device.  Models are tiny f32 RWKV-7
(C = 256, head 64, 2 layers, vocabulary 512), plain, all-int8 and all-nf4
(the JAX comparison plain and int8).

Tolerances (f32): a tp split changes only the order of the f32 sums of the
output projection, the FFN's value and nothing else, so logits and states
agree with the unsharded engine to 1e-5 of their scale and greedy tokens
are equal; against the JAX engine the port's existing engine-vs-JAX
tolerance, 2e-4 of the scale.  The JAX mesh engine skips the int8 LM head
that the port gives every quantized model: the int8 cases draw the head on
the int8 grid (every 128-row block column holds +-127 steps of 2^-7), on
which the port's int8 head is the plain head exactly, so the two engines
compute the same function and differ only in that recorded way.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.parallel import make_mesh as jmake_mesh
from ai00_server_tpu.testing import make_params as jmake_params
from ai00_server_tpu.testing import make_raw_weights, tiny_info

from ai00_server_tpu_torch.engine import Engine
from ai00_server_tpu_torch.loader import LoadedModel, params_from_numpy
from ai00_server_tpu_torch.ops import fused_decode, sampling
from ai00_server_tpu_torch.parallel import make_mesh
from ai00_server_tpu_torch.parallel.mesh_engine import MeshEngine, TPShard
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

B, CHUNK, K = 8, 8, 4
CPU = torch.device("cpu")
QUANT = {"plain": None, "int8": {0: "int8", 1: "int8"},
         "nf4": {0: "nf4", 1: "nf4"}}
JAX_CASES = ("plain", "int8")  # the JAX mesh engine's cases
GREEDY = {"kind": sampling.KIND_GREEDY}


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rtol * scale


def cpu_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=[CPU] * (dp * tp))


def int8_grid_head(raw, seed=5):
    """The head drawn on the int8 grid: integers in [-127, 127] times 2^-7,
    each 128-row block column holding one +-127 (its scale is 2^-7)."""
    rng = np.random.default_rng(seed)
    C, V = raw["head.weight"].shape
    q = rng.integers(-126, 127, (C, V))
    q[::128] = np.where(rng.random((C // 128, V)) < 0.5, -127, 127)
    raw["head.weight"] = (q * 2.0 ** -7).astype(np.float32)
    return raw


def model_inputs(case, version=ModelVersion.V7, seed=92):
    info = tiny_info(version, num_layer=2, num_emb=256, head_size=64,
                     num_vocab=512)
    raw = make_raw_weights(info, seed=seed, dtype=np.float32)
    if QUANT[case]:
        raw = int8_grid_head(raw)
    jparams = jmake_params(info, raw, dtype=np.float32, quant=QUANT[case])
    return info, jparams


def port_engine(info, jparams, mesh, max_batch=B):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return Engine(LoadedModel(info=info, params=params), max_batch=max_batch,
                  token_chunk_size=CHUNK, device="cpu", mesh=mesh)


PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11], [3] * 8, [40, 41],
           [5, 6, 7, 8, 9], [100, 200, 300], [], [17] * 6]


def drive(eng, sampler=GREEDY):
    """A ragged prefill step (an idle row), a K-token decode chunk with
    budgets, and its successor chained from the device tokens: (step
    tokens, step logits, chunk tokens, successor tokens, row states)."""
    for b in range(B):
        eng.load_row_state(b, None)
        eng.set_row_sampler(b, sampler, prompt_tokens=PROMPTS[b])
    toks = np.zeros((B, CHUNK), np.int32)
    lens = np.zeros(B, np.int32)
    for b, p in enumerate(PROMPTS):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    res = eng.step(toks, lens, lens > 0, want_logits=True)
    active = lens > 0
    budget = np.where(np.arange(B) == 2, 2, K).astype(np.int32)
    seq, _ = eng.decode_chunk(res.tokens, active, K, budget=budget)
    nxt, _ = eng.decode_chunk(torch.from_numpy(seq[-1].copy()), active, 3,
                              host_first=(np.arange(B) == 6,
                                          np.full(B, 9, np.int32)))
    states = [eng.read_row_state(b) for b in range(B)]
    return (res.tokens[active], np.asarray(res.logits)[active], seq, nxt,
            states)


def assert_runs_equal(got, want, rtol):
    np.testing.assert_array_equal(got[0], want[0])
    close(got[1], want[1], rtol)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[4], want[4]):
        for k in w:
            close(g[k], w[k], rtol)


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded port engine's run of each case, once per module."""
    out = {}
    for case in QUANT:
        info, jparams = model_inputs(case)
        out[case] = drive(port_engine(info, jparams, None))
    return out


@pytest.mark.parametrize("dp,tp", [(4, 2), (4, 1), (2, 2)])
@pytest.mark.parametrize("case", sorted(QUANT))
def test_mesh_engine_equals_unsharded(unsharded, case, dp, tp):
    info, jparams = model_inputs(case)
    eng = port_engine(info, jparams, cpu_mesh(dp, tp))
    assert isinstance(eng, MeshEngine) and len(eng.shards) == dp
    assert eng.local_batch == B // dp
    assert all(isinstance(s, TPShard) == (tp > 1) for s in eng.shards)
    if tp > 1:  # H / tp heads a place, no decode stack
        s = eng.shards[-1]
        assert s.state_pool[-1]["wkv"].shape[2] == info.num_head // tp
        assert s.stack is None and s._graph is None
    assert ("_head_q" in eng.shards[0].model.params) == (case != "plain")
    assert_runs_equal(drive(eng), unsharded[case], 1e-5)


@pytest.fixture(scope="module")
def jax_mesh_runs():
    """The JAX engine on make_mesh(dp=4, tp=2) over the 8 virtual CPU
    devices, each case compiled and run once per module."""
    assert len(jax.devices()) >= 8
    out = {}
    for case in JAX_CASES:
        info, jparams = model_inputs(case)
        eng = JEngine(JLoaded(info=info, params=jparams, init_wkv=None),
                      max_batch=B, token_chunk_size=CHUNK,
                      state_dtype=jnp.float32,
                      mesh=jmake_mesh(dp=4, tp=2))
        assert "_head_q" not in eng.model.params  # none on a mesh
        out[case] = drive(eng, {"kind": sampling.KIND_GREEDY})
    return out


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_engine_equals_jax_mesh_engine(jax_mesh_runs, case):
    info, jparams = model_inputs(case)
    eng = port_engine(info, jparams, cpu_mesh(4, 2))
    got = drive(eng)
    assert_runs_equal(got, jax_mesh_runs[case], 2e-4)
    if case == "int8":  # the port's int8 head, on the grid: exact
        hq = eng.shards[0].part_params[0]["_head_q"]
        assert float(hq.scale.max()) == float(hq.scale.min()) == 2.0 ** -7


@pytest.mark.parametrize("version", ["V7", "V6", "V5", "V4"])
def test_dp_mesh_runs_the_fused_stack_per_shard(monkeypatch, version):
    """A (4, 1) mesh: every rank installs the fused layout (once: the ranks
    on one device share one params tree) and takes its fused T=1 stack at
    the local batch of 2 rows; tokens, logits and states equal the
    unsharded engine's (1e-5: the products' batch differs)."""
    info, jparams = model_inputs("plain", ModelVersion(version), seed=93)
    want = drive(port_engine(info, jparams, None))
    fd = fused_decode.module_for(version)
    batches = []
    real = fd.forward_t1
    monkeypatch.setattr(fd, "forward_t1", lambda p, s, t, ln: (
        batches.append(t.shape[0]), real(p, s, t, ln))[1])
    eng = port_engine(info, jparams, cpu_mesh(4, 1))
    params = eng.shards[0].model.params
    assert all(s.model.params is params for s in eng.shards)
    assert all(s.stack is fd for s in eng.shards)
    assert fd.FUSED_KEY in params and fd.supports(params)
    assert_runs_equal(drive(eng), want, 1e-5)
    assert batches and set(batches) == {2}
    assert len(batches) == 4 * (K + 3)


def test_dp_mesh_takes_the_stack_of_the_local_batch():
    """16 rows on one device take the phased stack; on a (2, 1) mesh each
    rank's 8 rows take the fused one, as the JAX engine's local_batch."""
    from ai00_server_tpu_torch.ops import v7_decode, v7_phased

    info, jparams = model_inputs("plain")
    assert port_engine(info, jparams, None, 16).stack is v7_phased
    eng = port_engine(info, jparams, cpu_mesh(2, 1), 16)
    assert [s.stack for s in eng.shards] == [v7_decode, v7_decode]


def test_nucleus_with_given_uniforms_equals_unsharded():
    """Each dp rank draws from its own generator, so a sharded run equals
    the unsharded one under given uniforms: every draw of the unsharded
    engine takes a (B,) row of U, rank d of the (4, 2) engine its rows."""
    info, jparams = model_inputs("plain")
    nucleus = {"kind": sampling.KIND_NUCLEUS, "top_p": 0.9,
               "temperature": 1.5}
    U = np.random.default_rng(8).random((1 + K + 3, B)).astype(np.float32)

    def given(eng, rows):
        it = iter(U[:, rows])
        eng._uniforms = lambda n: torch.from_numpy(next(it))

    ref = port_engine(info, jparams, None)
    given(ref, slice(None))
    eng = port_engine(info, jparams, cpu_mesh(4, 2))
    for d, s in enumerate(eng.shards):
        given(s, slice(2 * d, 2 * d + 2))
    want, got = drive(ref, nucleus), drive(eng, nucleus)
    assert_runs_equal(got, want, 1e-5)
    assert len(set(got[2].ravel().tolist())) > 4  # not a greedy walk


@pytest.mark.parametrize("dp,tp", [(2, 2), (2, 1)])
def test_rollback_and_restore_on_the_second_shard(dp, tp):
    """Row 5 lives in rank 1: rollback_row there equals the unsharded
    engine's; restore_last_chunk brings every rank back to its snapshot;
    the row reads (embedding, scores, hidden sums) equal the unsharded
    ones."""
    info, jparams = model_inputs("plain")
    ref = port_engine(info, jparams, None)
    eng = port_engine(info, jparams, cpu_mesh(dp, tp))
    out = [drive(e) for e in (ref, eng)]
    feed = [int(out[0][2][0, 5]), int(out[0][2][1, 5])]
    for e in (ref, eng):
        e.rollback_row(5, feed, depth=-2)
    for k, v in ref.read_row_state(5).items():
        close(eng.read_row_state(5)[k], v, 1e-5)

    before = eng.read_row_state(6)
    eng.decode_chunk(out[1][3][-1], np.ones(B, np.bool_), 3)
    assert not np.array_equal(eng.read_row_state(6)["wkv"], before["wkv"])
    eng.restore_last_chunk()
    for k, v in eng.read_row_state(6).items():
        np.testing.assert_array_equal(v, before[k])

    close(eng.read_row_embed(5), ref.read_row_embed(5), 1e-5)
    close(eng.position_logps([4, 5, 6], b=5),
          ref.position_logps([4, 5, 6], b=5), 1e-5)
    close(eng.position_logps([4, 5, 6], state=ref.read_row_state(3)),
          ref.position_logps([4, 5, 6], state=ref.read_row_state(3)), 1e-5)
    for e in (ref, eng):
        e.load_row_state(7, None, hidden_sums=True)
    serial = eng.hsum_serial
    toks = np.zeros((B, CHUNK), np.int32)
    toks[7, :3] = [8, 9, 10]
    lens = (np.arange(B) == 7).astype(np.int32) * 3
    for e in (ref, eng):
        e.step(toks, lens, np.zeros(B, np.bool_))
    assert eng.hsum_serial == serial + 1  # the rank of row 7 summed
    close(eng.read_hidden_sums(), ref.read_hidden_sums(), 1e-5)
    close(eng.read_row_hidden_sum(7), ref.read_row_hidden_sum(7), 1e-5)
    close(eng.mean_hidden_embed([8, 9, 10]), ref.mean_hidden_embed(
        [8, 9, 10]), 1e-5)
