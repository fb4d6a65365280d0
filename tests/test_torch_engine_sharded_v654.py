"""The port's tensor parallel for RWKV-6, -5 and -4 on meshes of CPU
places, against the unsharded port engine and the JAX package's mesh
engine (``tests/test_torch_engine_sharded.py`` holds RWKV-7 and dp).

A tp place holds H / tp heads (RWKV-4: C / tp channels, its ``aa`` /
``bb`` / ``pp`` split on them) and the slices of the projections; the
output projection's and the FFN value's partial sums are added in f32 and
rounded once, and the receptance gate of the v4-v6 FFN multiplies the
rounded sum (``models/common.forward_tp``).  Models are tiny f32 (C = 256,
head 64, 2 layers, vocabulary 512), plain, all-int8 and all-nf4 (the JAX
comparison plain and int8, the int8 head drawn on the int8 grid as in the
RWKV-7 file).

Tolerances (f32): a tp split changes only the order of f32 sums, so logits
and states agree with the unsharded engine to 1e-5 of their scale and
greedy tokens are equal - but for the recurrent WKV state (v6's ``wkv``,
v4's ``aa`` / ``bb``), held to 3e-5: its second layer carries the first
layer's sum order through a data-dependent decay (v6: ``exp(-exp(ww))``
moves by ``exp(ww)`` times ``ww``'s error) or a running exponent (v4), and
reads up to 1.5e-5 for these seeds where every other leaf reads under
5e-6.  Against the JAX engine the port's engine-vs-JAX tolerance, 2e-4 of
the scale.
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

from ai00_server_tpu_torch.loader import stack_params
from ai00_server_tpu_torch.models import get_version_module
from ai00_server_tpu_torch.ops import sampling
from ai00_server_tpu_torch.parallel import (make_mesh, shard_params,
                                            shard_state, unshard_state)
from ai00_server_tpu_torch.parallel.mesh_engine import MeshEngine, TPShard
from ai00_server_tpu_torch.testing import (cpu_test_threads,
                                           make_raw_weights,
                                           tiny_info)

from test_torch_engine_sharded import (B, JAX_CASES, QUANT, assert_runs_equal,
                                       close, cpu_mesh, drive, model_inputs,
                                       port_engine)

cpu_test_threads()

VERSIONS = ("V6", "V5", "V4")
MESHES = [(4, 2), (2, 2), (1, 2)]
WKV_TOL = 3e-5  # the recurrent WKV state against the unsharded engine


def assert_runs_close(got, want):
    """:func:`assert_runs_equal` at 1e-5, the WKV state at WKV_TOL."""
    assert_runs_equal(got[:4] + ([],), want[:4] + ([],), 1e-5)
    for g, w in zip(got[4], want[4]):
        for k in w:
            close(g[k], w[k], WKV_TOL if k in ("wkv", "aa", "bb") else 1e-5)


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded port engine's run of each (version, case), once per
    module."""
    out = {}
    for version in VERSIONS:
        for case in QUANT:
            info, jparams = model_inputs(case, ModelVersion(version))
            out[version, case] = drive(port_engine(info, jparams, None))
    return out


@pytest.mark.parametrize("dp,tp", MESHES)
@pytest.mark.parametrize("case", sorted(QUANT))
@pytest.mark.parametrize("version", VERSIONS)
def test_mesh_engine_equals_unsharded(unsharded, version, case, dp, tp):
    info, jparams = model_inputs(case, ModelVersion(version))
    eng = port_engine(info, jparams, cpu_mesh(dp, tp))
    assert isinstance(eng, MeshEngine) and len(eng.shards) == dp
    assert all(isinstance(s, TPShard) for s in eng.shards)
    s = eng.shards[-1]
    assert s.stack is None and s._graph is None
    for pool in s.state_pool:  # each place's heads or channels
        if version == "V4":
            for k in ("aa", "bb", "pp"):
                assert pool[k].shape == (2, B // dp, info.num_emb // tp)
                assert pool[k].is_contiguous()
        else:
            assert pool["wkv"].shape[2] == info.num_head // tp
    assert ("_head_q" in s.model.params) == (case != "plain")
    assert_runs_close(drive(eng), unsharded[version, case])


@pytest.fixture(scope="module")
def jax_mesh_runs():
    """The JAX engine on make_mesh(dp=4, tp=2) over the 8 virtual CPU
    devices, each (version, case) compiled and run once per module."""
    assert len(jax.devices()) >= 8
    out = {}
    for version in VERSIONS:
        for case in JAX_CASES:
            info, jparams = model_inputs(case, ModelVersion(version))
            eng = JEngine(JLoaded(info=info, params=jparams, init_wkv=None),
                          max_batch=B, token_chunk_size=8,
                          state_dtype=jnp.float32,
                          mesh=jmake_mesh(dp=4, tp=2))
            out[version, case] = drive(eng, {"kind": sampling.KIND_GREEDY})
    return out


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("version", VERSIONS)
def test_mesh_engine_equals_jax_mesh_engine(jax_mesh_runs, version, case):
    info, jparams = model_inputs(case, ModelVersion(version))
    got = drive(port_engine(info, jparams, cpu_mesh(4, 2)))
    assert_runs_equal(got, jax_mesh_runs[version, case], 2e-4)


@pytest.mark.parametrize("version", VERSIONS)
def test_forward_tp_rounds_the_gated_sum_before_the_gate(version):
    """``forward_tp`` on two places against ``forward`` in bf16 (tiny, 2
    layers, a ragged chunk of 8): each rounding of the unsharded path is
    kept, so only where an f32 sum of another order rounds the other way
    does an element differ (0.07-1.1% of the hidden's elements for these
    seeds), and by a few bf16 steps.  Multiplying the gate by the
    un-rounded f32 sum of the FFN's value rounds once where the unsharded
    path rounds twice, and moves 65-69% of them."""
    info = tiny_info(ModelVersion(version), num_layer=2, num_emb=256,
                     head_size=64, num_vocab=512)
    raw = make_raw_weights(info, seed=3, dtype=np.float32)
    params = stack_params(info, raw, torch.bfloat16, "cpu")
    module = get_version_module(info.version)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 512, (3, 8))).int()
    lengths = torch.tensor([8, 5, 1], dtype=torch.int32)
    state = module.init_state(info, 3)
    want, want_state = module.forward(params, state, tokens, lengths)
    mesh = make_mesh(dp=1, tp=2, devices=["cpu"] * 2)
    got, parts = module.forward_tp(shard_params(params, mesh)[0],
                                   shard_state(state, mesh)[0], tokens,
                                   lengths)
    assert got.dtype == want.dtype == torch.bfloat16
    moved = float((got != want).float().mean())
    assert moved <= 0.05, moved
    close(got.float(), want.float(), 2 ** -7)
    joined = unshard_state([parts], "cpu")
    for k, v in want_state.items():
        close(joined[k].float(), v.float(), 2 ** -6)


@pytest.mark.parametrize("version", VERSIONS)
def test_rollback_restore_and_row_reads_on_the_second_shard(version):
    """Row 5 lives in rank 1 of a (2, 2) mesh: rollback_row there, the
    restore of the last chunk, the row reads (embedding, scores), a state
    given to ``position_logps`` and the mean-hidden embedding go through
    the split state (RWKV-4's channels) and equal the unsharded
    engine's."""
    info, jparams = model_inputs("plain", ModelVersion(version))
    ref = port_engine(info, jparams, None)
    eng = port_engine(info, jparams, cpu_mesh(2, 2))
    out = [drive(e) for e in (ref, eng)]
    feed = [int(out[0][2][0, 5]), int(out[0][2][1, 5])]
    for e in (ref, eng):
        e.rollback_row(5, feed, depth=-2)
    for k, v in ref.read_row_state(5).items():
        close(eng.read_row_state(5)[k], v,
              WKV_TOL if k in ("wkv", "aa", "bb") else 1e-5)

    before = eng.read_row_state(6)
    eng.decode_chunk(out[1][3][-1], np.ones(B, np.bool_), 3)
    key = "aa" if version == "V4" else "wkv"
    assert not np.array_equal(eng.read_row_state(6)[key], before[key])
    eng.restore_last_chunk()
    for k, v in eng.read_row_state(6).items():
        np.testing.assert_array_equal(v, before[k])

    close(eng.read_row_embed(5), ref.read_row_embed(5), 1e-5)
    close(eng.position_logps([4, 5, 6], b=5),
          ref.position_logps([4, 5, 6], b=5), 1e-5)
    close(eng.position_logps([4, 5, 6], state=ref.read_row_state(3)),
          ref.position_logps([4, 5, 6], state=ref.read_row_state(3)), 1e-5)
    close(eng.mean_hidden_embed([8, 9, 10]),
          ref.mean_hidden_embed([8, 9, 10]), 1e-5)
