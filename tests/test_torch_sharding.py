"""``ai00_server_tpu_torch/parallel/sharding.py`` against the JAX package's
``parallel/sharding.py`` on the CPU.

* Every leaf of the port's params splits on the dim the JAX
  ``param_specs`` puts "tp" on (less the leading layer axis of its stacked
  groups), for RWKV-7, -6, -5 and -4, plain and int8, on the same
  ``make_raw_weights``.  A quantized leaf is a divergence: the JAX package
  keeps every one whole (``P()``), the port splits it like its plain
  weight; the test holds the port's dim to the JAX spec of the plain
  weight and records that the JAX quantized spec is whole.
* The state's dp and tp dims equal the JAX ``state_specs``, the sampler
  state's and the data's dp dims equal theirs - but RWKV-4's per-channel
  WKV ``aa`` / ``bb`` / ``pp``, a recorded divergence: JAX keeps it whole
  on every tp place, the port splits its channels (each place updates
  only its own, so whole copies would part).
* Shard then unshard gives the tree back bit for bit; places on one
  device share one tree and the whole leaves share the source's tensors.
* ``make_mesh`` refuses a device count that is not dp x tp.
* A quantized ``in`` slice that does not fall on whole scale blocks stays
  whole (``QuantizedRows``) and multiplies its rows exactly.
"""

import numpy as np
import pytest

import jax
import torch

from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import get_version_module as jversion
from ai00_server_tpu.ops import quant as jquant
from ai00_server_tpu.ops import sampling as jsampling
from ai00_server_tpu.parallel import sharding as jsh
from ai00_server_tpu.testing import make_params as jmake_params
from ai00_server_tpu.testing import make_raw_weights, tiny_info

from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import get_version_module
from ai00_server_tpu_torch.ops import quant, sampling
from ai00_server_tpu_torch.parallel import sharding as sh
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

VERSIONS = {"v7": ModelVersion.V7, "v6": ModelVersion.V6,
            "v5": ModelVersion.V5, "v4": ModelVersion.V4}
CPU = torch.device("cpu")


def _info(version, num_emb=256):
    return tiny_info(VERSIONS[version], num_layer=2, num_emb=num_emb,
                     head_size=64, num_vocab=512)


def _jax_params(version, quant_mode=None, seed=90):
    info = _info(version)
    raw = make_raw_weights(info, seed=seed, dtype=np.float32)
    qmap = {0: quant_mode, 1: quant_mode} if quant_mode else None
    return info, jmake_params(info, raw, dtype=np.float32, quant=qmap)


def _tp_dim(spec, ndim):
    """The port's form of a JAX spec of a stacked leaf: the negative dim of
    "tp", or None."""
    spec = tuple(spec)
    if "tp" not in spec:
        return None
    return spec.index("tp") - ndim


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("mode", [None, "int8"], ids=["plain", "int8"])
@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_param_specs_equal_jax(version, mode):
    info, jparams = _jax_params(version, mode)
    _, jplain = _jax_params(version)
    jspecs, jplain_specs = jsh.param_specs(jparams), jsh.param_specs(jplain)
    specs = sh.param_specs(_port_params(jparams))

    for k in ("emb", "ln_out_w", "ln_out_b", "head"):
        assert specs[k] == _tp_dim(jspecs[k], np.ndim(jparams[k])), k
    assert specs["head"] == sh.OUT

    checked = 0
    for g, group in enumerate(jparams["groups"]):
        index = np.asarray(group["layer_index"])

        def walk(node, jspec, jplain_spec, plain, port):
            nonlocal checked
            if isinstance(node, dict):
                assert set(port) == set(node)
                for k in node:
                    walk(node[k], jspec[k], jplain_spec[k], plain[k], port[k])
                return
            if isinstance(node, jquant.QuantizedLinear):
                # The JAX package keeps a quantized leaf whole; the port
                # splits it like its plain weight.
                assert tuple(jspec.q) == () and tuple(jspec.scale) == ()
                want = _tp_dim(jplain_spec, np.ndim(plain))
            else:
                want = _tp_dim(jspec, np.ndim(node))
            assert port == want
            checked += 1

        for i in index:
            walk(group["layers"], jspecs["groups"][g]["layers"],
                 jplain_specs["groups"][g]["layers"],
                 jplain["groups"][g]["layers"], specs["layers"][int(i)])
    assert checked > 20 * info.num_layer // 2
    # Some leaves split, on both dims, in every version.
    dims = {d for p in specs["layers"] for part in ("att", "ffn")
            for d in p[part].values()}
    assert dims == {None, sh.OUT, sh.IN}


@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_state_and_data_specs_equal_jax(version):
    info = _info(version)
    jstate = jversion(info.version).init_state(info, 4, np.float32)
    state = get_version_module(info.version).init_state(info, 4)
    jspecs, specs = jsh.state_specs(jstate), sh.state_specs(state)
    assert set(specs) == set(jspecs)
    for k, (dp, tp) in specs.items():
        spec = tuple(jspecs[k])
        assert spec.index("dp") == dp
        if version == "v4" and k in ("aa", "bb", "pp"):
            # The recorded divergence: whole in JAX, on channels here.
            assert "tp" not in spec and tp == 2
            continue
        assert (spec.index("tp") if "tp" in spec else None) == tp
    # The sampler state and the data: the batch rows on dp.
    jss = jsampling.init_sampler_state(4, info.num_vocab)
    ss = sampling.init_sampler_state(4, info.num_vocab, CPU)
    jss_specs = jsh.sampler_state_specs(jss)
    assert sh.sampler_state_specs(ss) == {
        k: tuple(jss_specs[k]).index("dp") for k in ss}
    assert sh.data_specs() == tuple(tuple(s).index("dp")
                                    for s in jsh.data_specs())


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


def _assert_same(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if quant.is_quantized(w):
            assert (g.mode, tuple(g.shape)) == (w.mode, tuple(w.shape)), path
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale)
            assert getattr(g, "idx", None) == getattr(w, "idx", None)
        else:
            assert torch.equal(g, w), path


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (2, 4), (4, 1)])
@pytest.mark.parametrize("mode", [None, "int8", "nf4"],
                         ids=["plain", "int8", "nf4"])
def test_shard_unshard_round_trip(mode, dp, tp):
    _round_trip("v7", mode, dp, tp)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
@pytest.mark.parametrize("mode", [None, "int8", "nf4"],
                         ids=["plain", "int8", "nf4"])
def test_shard_unshard_round_trip_v4(mode, dp, tp):
    """RWKV-4: its ``aa`` / ``bb`` / ``pp`` split on their channels."""
    _round_trip("v4", mode, dp, tp)


def _round_trip(version, mode, dp, tp):
    _, jparams = _jax_params(version, mode)
    params = _port_params(jparams)
    if mode:  # the engine's int8 head splits on the vocabulary too
        params["_head_q"] = quant.quantize_int8(params.pop("head"))
    mesh = sh.make_mesh(dp=dp, tp=tp, devices=[CPU] * (dp * tp))
    grid = sh.shard_params(params, mesh)
    _assert_same(sh.unshard_params(grid, CPU), params)
    for d in range(dp):  # one device: each tp slice once
        for j in range(tp):
            assert grid[d][j] is grid[0][j]
    att = grid[0][tp - 1]["layers"][1]["att"]
    src = params["layers"][1]["att"]
    mix = "x_r" if version == "v7" else "time_mix_r"
    assert att[mix] is src[mix]  # a whole leaf is the source's tensor
    head = grid[0][tp - 1]["_head_q" if mode else "head"]
    assert head.shape[-1] == 512 // tp
    if tp > 1:
        k = att["key"]
        assert k.shape[-1] == 256 // tp
        assert not quant.is_quantized(k) or k.q.is_contiguous()

    info = _info(version)
    state = get_version_module(info.version).init_state(info, 8)
    for k, v in state.items():
        v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(
            len(k))))
    sgrid = sh.shard_state(state, mesh)
    last = sgrid[dp - 1][tp - 1]
    if version == "v4":
        for k in ("aa", "bb", "pp"):
            assert last[k].shape == (2, 8 // dp, 256 // tp)
            assert last[k].is_contiguous()
        assert last["att_x"].shape == (2, 8 // dp, 256)
    else:
        assert last["wkv"].shape == (2, 8 // dp, 4 // tp, 64, 64)
    for k, v in sh.unshard_state(sgrid, CPU).items():
        assert torch.equal(v, state[k])
    ss = sampling.init_sampler_state(8, 512, CPU)
    ss["max_surprise"].copy_(torch.arange(8.0))
    parts = sh.shard_sampler_state(ss, mesh)
    for k, v in ss.items():
        assert torch.equal(torch.cat([p[k] for p in parts]), v)


def test_make_mesh_checks():
    cpus = [CPU] * 8
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        sh.make_mesh(dp=16, tp=1, devices=cpus)
    with pytest.raises(ValueError, match="needs 6 devices, have 8"):
        sh.make_mesh(dp=3, devices=cpus)   # tp = 8 // 3 = 2
    with pytest.raises(ValueError, match="devices"):
        sh.make_mesh(dp=0, tp=2, devices=cpus[:2])
    assert sh.make_mesh(devices=cpus).shape == {"dp": 8, "tp": 1}
    assert sh.make_mesh(tp=2, devices=cpus).shape == {"dp": 4, "tp": 2}
    m = sh.make_mesh(n_devices=4, dp=2, devices=cpus)
    assert m.shape == {"dp": 2, "tp": 2} and m.size == 4
    assert m.devices[1][1] == CPU


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantized_in_split_not_whole_blocks_stays_whole(mode):
    """At C = 256 over tp = 4 the output projection's ``in`` slice is 64
    rows: whole 4-bit blocks (64 rows), not whole int8 blocks (128).  The
    int8 slice stays whole on every place as rows of it; the FFN's value
    (1024 / 4 = 256 rows) is sliced in both modes.  Each place's product of
    its input slice equals the same rows of the whole weight: f32 on the
    CPU, tolerance 1e-6 of the scale (another summation order)."""
    _, jparams = _jax_params("v7", mode)
    params = _port_params(jparams)
    mesh = sh.make_mesh(dp=1, tp=4, devices=[CPU] * 4)
    grid = sh.shard_params(params, mesh)
    src = params["layers"][0]
    rng = np.random.default_rng(3)
    for key, part, rows in (("output", "att", 256), ("value", "ffn", 1024)):
        whole = src[part][key].layer().dequant(torch.float32)
        x = torch.from_numpy(rng.standard_normal((3, rows)).astype(
            np.float32))
        want = x @ whole
        total = torch.zeros_like(want)
        for j in range(4):
            leaf = grid[0][j]["layers"][0][part][key]
            kept = mode == "int8" and key == "output"
            assert isinstance(leaf, quant.QuantizedRows) == kept
            if kept:  # the whole codes, not a copy
                assert leaf.whole.qlin.q is src[part][key].qlin.q
            else:
                assert leaf.q.shape[-3] * (128 if mode == "int8" else 64) \
                    == rows // 4
            xs = x[:, j * rows // 4:(j + 1) * rows // 4]
            total += leaf.matmul(xs, torch.float32)
        scale = float(want.abs().max())
        assert float((total - want).abs().max()) <= 1e-6 * scale


def test_collectives_are_peer_copies_summed_in_f32():
    """``all_reduce_sum`` adds bf16 partial sums in f32 (exact here: each
    part is a multiple of 2^-8 under 2^8) and hands the same tensor to
    places of one device; ``all_gather`` joins on one place; ``broadcast``
    copies nothing to the device a tensor is on."""
    from ai00_server_tpu_torch.parallel.collectives import (
        all_gather, all_reduce_sum, broadcast)

    rng = np.random.default_rng(7)
    parts = [torch.from_numpy(rng.integers(-2**15, 2**15, (3, 5)) / 2.0**8
                              ).to(torch.bfloat16) for _ in range(4)]
    total = all_reduce_sum(parts)
    want = sum(p.double() for p in parts)
    assert all(t.dtype == torch.float32 for t in total)
    assert all(t is total[0] for t in total)
    assert torch.equal(total[0].double(), want)
    whole = all_gather(parts, -1, CPU)
    assert whole.shape == (3, 20) and torch.equal(whole[:, 5:10], parts[1])
    t = torch.ones(2)
    assert all(b is t for b in broadcast(t, [CPU] * 3))
