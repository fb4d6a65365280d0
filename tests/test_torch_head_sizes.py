"""The port at head sizes other than 64 against the JAX package, on the CPU.

RWKV-7, -6 and -5 at N = 32, 40 and 128 (H = 2, 2 and 1: C = 64, 80,
128; 2 layers, vocab 64; weights and tokens from numpy seeds):

* the layer path (``models/v*.forward``): a ragged prefill, then two T = 1
  steps with an idle row, against ``ai00_server_tpu.models.v*.forward`` with
  its Pallas WKV kernels in interpret mode (``AI00_WKV_IMPL=
  pallas_interpret``); tolerance 2e-4 of each tensor's scale in f32, as
  ``tests/test_torch_models_v7.py`` (the frameworks sum the products in
  other orders; the JAX v5/v6 chunk folds a masked step into w = 1, k = 0,
  so hidden states are compared at valid steps only);
* the fused stacks' plain versions (``ops/v*_decode.forward_t1`` on CPU
  tensors) against ``v*_decode_pallas.forward_t1(..., interpret=True)``:
  three chained steps from a prefilled state, an idle row; the hidden at
  the tolerances of ``tests/test_fused_decode.py``, rtol / atol 2e-4 on the
  first step and 5e-4 on the chain; the state at 2e-4 of its largest
  magnitude, as the layer path (its entries reach ~90 at N = 128, where an
  element-wise rtol fails on the entries near zero: the frameworks' f32
  sums run in other orders);
* ``can_fuse`` and ``can_phase`` against the JAX package's: the same head
  sizes in ``N % 8 == 0``, ``8 <= N <= 128``; outside it the WKV kernels
  raise ``ValueError`` naming N (above 128 the JAX package still fuses:
  ROADMAP's intended divergence);
* ``params_from_numpy`` carries JAX params of head size 128 across;
* the per-N libraries' names and ``nvcc`` flags (``ops/_build``), as pure
  functions: no ``nvcc`` runs here.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v5 as jv5
from ai00_server_tpu.models import v6 as jv6
from ai00_server_tpu.models import v7 as jv7
from ai00_server_tpu.ops import v5_decode_pallas as jfd5
from ai00_server_tpu.ops import v6_decode_pallas as jfd6
from ai00_server_tpu.ops import v7_decode_pallas as jfd7
from ai00_server_tpu.ops import v7_phased_pallas as jpd7
from ai00_server_tpu.ops import v56_phased_pallas as jpd56
from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import get_version_module
from ai00_server_tpu_torch.ops import _build, fused_decode, v56_phased
from ai00_server_tpu_torch.ops import v7_phased
from ai00_server_tpu_torch.ops import v5_decode as tfd5
from ai00_server_tpu_torch.ops import v6_decode as tfd6
from ai00_server_tpu_torch.ops import v7_decode as tfd7
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

L, V = 2, 64
HEADS = {32: 2, 40: 2, 128: 1}  # N: H
VERSIONS = {"V7": (jv7, jfd7, tfd7), "V6": (jv6, jfd6, tfd6),
            "V5": (jv5, jfd5, tfd5)}
RTOL = 2e-4


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (
        float(np.abs(got - want).max()), scale)


def make_pair(version, N, num_layer=L, H=None):
    """(info, JAX params, the port's params carried across) in f32."""
    H = HEADS[N] if H is None else H
    info = tiny_info(ModelVersion(version), num_layer=num_layer,
                     num_emb=H * N, head_size=N, num_vocab=V)
    raw = make_raw_weights(info, seed=N, dtype=np.float32)
    jparams = make_params(info, raw, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return info, jparams, tparams


def torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


CASES = [(v, N) for v in VERSIONS for N in HEADS]
IDS = [f"{v}-N{N}" for v, N in CASES]


@pytest.mark.parametrize("version,N", CASES, ids=IDS)
def test_layer_path_equals_jax(version, N, monkeypatch):
    monkeypatch.setenv("AI00_WKV_IMPL", "pallas_interpret")
    jmod, _, _ = VERSIONS[version]
    tmod = get_version_module(ModelVersion(version))
    info, jparams, tparams = make_pair(version, N)
    rng = np.random.default_rng(N)
    B, T = 3, 20
    toks = rng.integers(1, V, (B, T)).astype(np.int32)
    lens = np.array([T, 9, 0], np.int32)
    jh, js = jmod.forward(jparams, jmod.init_state(info, B),
                          jnp.asarray(toks), jnp.asarray(lens))
    th, ts = tmod.forward(tparams, tmod.init_state(info, B),
                          torch.from_numpy(toks), torch.from_numpy(lens))
    valid = np.arange(T)[None, :] < lens[:, None]
    close(th.numpy()[valid], np.asarray(jh)[valid])
    for k in js:
        close(ts[k].numpy(), np.asarray(js[k]))
    for _ in range(2):  # T = 1 with row 2 idle: its state must not move
        t1 = rng.integers(1, V, (B, 1)).astype(np.int32)
        l1 = np.array([1, 1, 0], np.int32)
        jh, js = jmod.forward(jparams, js, jnp.asarray(t1), jnp.asarray(l1))
        idle = {k: v[:, 2].clone() for k, v in ts.items()}
        th, ts = tmod.forward(tparams, ts, torch.from_numpy(t1),
                              torch.from_numpy(l1))
        close(th.numpy()[:2], np.asarray(jh)[:2])
        for k in js:
            close(ts[k].numpy(), np.asarray(js[k]))
            assert torch.equal(ts[k][:, 2], idle[k])


@pytest.mark.parametrize("version,N", CASES, ids=IDS)
def test_fused_plain_equals_pallas(version, N):
    jmod, jfd, tfd = VERSIONS[version]
    info, jparams, tparams = make_pair(version, N)
    assert jfd.can_fuse(jparams) and tfd.can_fuse(tparams)
    jparams = dict(jparams)
    jparams[jfd.FUSED_KEY] = jfd.make_fused_layout(jparams)
    tparams[tfd.FUSED_KEY] = tfd.make_fused_layout(tparams)
    B = 3
    rng = np.random.default_rng(N + 1)
    plain = {k: v for k, v in jparams.items() if k != jfd.FUSED_KEY}
    _, js = jmod.forward(plain, jmod.init_state(info, B),
                         jnp.asarray(rng.integers(0, V, (B, 5)), jnp.int32),
                         jnp.full((B,), 5, jnp.int32))
    ts = torch_state(jax.tree.map(np.asarray, js))
    for step in range(3):
        t1 = rng.integers(0, V, (B, 1)).astype(np.int32)
        l1 = np.array([1, 0, 1] if step else [1, 1, 1], np.int32)
        jh, js = jfd.forward_t1(jparams, js, jnp.asarray(t1),
                                jnp.asarray(l1), interpret=True)
        idle = {k: v[:, 1].clone() for k, v in ts.items()}
        th, _ = tfd.forward_t1_plain(tparams, ts, torch.from_numpy(t1),
                                     torch.from_numpy(l1))
        act = l1 > 0
        tol = 5e-4 if step else 2e-4
        np.testing.assert_allclose(th.numpy()[act], np.asarray(jh)[act],
                                   rtol=tol, atol=tol)
        for k in js:
            close(ts[k].numpy(), np.asarray(js[k]))
            if step:
                assert torch.equal(ts[k][:, 1], idle[k])


JAX_FUSE = {"V7": jfd7, "V6": jfd6, "V5": jfd5}


@pytest.mark.parametrize("version", sorted(VERSIONS))
@pytest.mark.parametrize("N", [8, 12, 16, 24, 36, 40, 56, 72, 96, 120, 128,
                               136])
def test_can_fuse_admits_the_jax_head_sizes(version, N):
    """The same answer as the JAX package's ``can_fuse`` at every N in the
    range; outside it the port's kernels raise and its gate says no (the
    JAX package fuses N = 136, a multiple of 8: ROADMAP's intended
    divergence, served there by its XLA scan)."""
    _, jparams, tparams = make_pair(version, N, num_layer=1, H=2)
    tfd = VERSIONS[version][2]
    want = JAX_FUSE[version].can_fuse(jparams)
    got = tfd.can_fuse(tparams)
    if _build.head_size_ok(N):
        assert got == want is True
        _build.check_head_size(N)
        assert tfd.can_fuse(tparams) and fused_decode.stack_for(
            version, tparams, 8) is tfd
    else:
        assert got is False and want is (N % 8 == 0)
        with pytest.raises(ValueError, match=f"head size {N}:"):
            _build.check_head_size(N)
        assert fused_decode.stack_for(version, tparams, 8) is None


@pytest.mark.parametrize("version", sorted(VERSIONS))
@pytest.mark.parametrize("N", [16, 32, 64, 128])
def test_can_phase_admits_the_jax_head_sizes(version, N):
    """At C = 512, where the JAX phased kernel finds its tiling, both
    packages take a 16-row step of every such N in the range."""
    _, jparams, tparams = make_pair(version, N, num_layer=1, H=512 // N)
    if version == "V7":
        want = jpd7.can_phase(jparams, 16)
        got = v7_phased.can_phase(tparams, 16)
    else:
        want = jpd56.can_phase(jparams, 16, version)
        got = v56_phased.can_phase(tparams, 16, version)
    assert got is want is True
    assert not (v7_phased.can_phase(tparams, 8) if version == "V7"
                else v56_phased.can_phase(tparams, 8, version))


@pytest.mark.parametrize("N", [0, 4, 12, 36, 100, 136, 256])
def test_head_sizes_outside_the_range_raise(N):
    assert not _build.head_size_ok(N)
    with pytest.raises(ValueError, match=rf"head size {N}: .* N % 8 == 0 "
                                         r"with 8 <= N <= 128"):
        _build.check_head_size(N)
    for name in _build.HEAD_SOURCES:
        with pytest.raises(ValueError, match=f"head size {N}:"):
            _build.library(name, N)


def test_params_from_numpy_carries_head_size_128():
    for version in VERSIONS:
        info, jparams, tparams = make_pair(version, 128)
        flat_j = jax.tree_util.tree_leaves_with_path(jparams)
        assert flat_j
        layer = tparams["layers"][0]["att"]
        key = "r_k" if version == "V7" else (
            "first" if version == "V6" else "time_first")
        assert tuple(layer[key].shape[-2:]) == (1, 128)
        jl = jparams["groups"][0]["layers"]["att"]
        jkey = {"V7": "r_k", "V6": "time_faaaa", "V5": "time_faaaa"}
        got = layer[key].numpy()
        want = None
        for name in (jkey[version], key, "time_first", "first"):
            if name in jl:
                want = np.asarray(jl[name])[0]
                break
        assert want is not None
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_head_size_libraries_are_named_and_flagged_per_size():
    """Each WKV source has one library per head size, its flags carrying
    ``-DHEAD_N``; the other sources one library whatever N."""
    assert set(_build.HEAD_SOURCES) == {"wkv7", "wkv56", "v7_wkv_gn",
                                        "v6_decode"}
    assert set(_build.HEAD_SOURCES) <= set(_build.SIGNATURES)
    for name in _build.SIGNATURES:
        paths = {N: _build.library_path(name, N) for N in (8, 40, 64, 128)}
        if name in _build.HEAD_SOURCES:
            for N, path in paths.items():
                assert _build.key(name, N) == (name, N)
                assert _build.flags(name, N) == [*_build.NVCC_FLAGS,
                                                 f"-DHEAD_N={N}"]
                assert path.name.startswith(f"lib{name}_n{N}_")
                assert path.parent == _build.BUILD
            assert len(set(paths.values())) == 4
        else:
            assert _build.key(name, 40) == (name, None)
            assert _build.flags(name, 40) == _build.NVCC_FLAGS
            assert len(set(paths.values())) == 1
    assert "v7_wkv_gn_launch" in _build.SIGNATURES["v7_wkv_gn"]
    assert "v7_wkv_gn_launch" not in _build.SIGNATURES["v7_decode"]
    assert [_build.head_tile(n) for n in (8, 24, 32, 40, 64, 72, 128)] == [
        32, 32, 32, 64, 64, 128, 128]


def write_st(path, version, N, H=2):
    """A converted ``.st`` of a 2-layer model of head size N (JAX weights)."""
    from ai00_server_tpu import loader as jloader

    from test_loader import to_converted_layout

    info = tiny_info(ModelVersion(version), num_layer=2, num_emb=H * N,
                     head_size=N, num_vocab=V)
    raw = make_raw_weights(info, seed=N, dtype=np.float32)
    jloader.save_safetensors(to_converted_layout(raw), str(path),
                             dtype=np.float32)
    return info


@pytest.mark.parametrize("version,fmt", [
    (v, f) for v in sorted(VERSIONS) for f in ("st", "pth", "prefab")]
    + [("V5", "pth-v5.1")])
def test_read_info_from_the_header(tmp_path, version, fmt):
    """``loader.read_info`` (what ``Middleware.reload`` checks on a card
    before it unloads anything) equals the info of the loaded model."""
    from ai00_server_tpu_torch import loader as tloader
    from ai00_server_tpu_torch import prefab

    if fmt.startswith("pth"):
        from test_torch_lora_pth import write_pth

        _, path = write_pth(tmp_path, version, seed=3,
                            v51=fmt == "pth-v5.1")
    else:
        path = tmp_path / "model.st"
        write_st(path, version, 40)
        path = str(path)
    model = tloader.load_model(path, dtype=torch.float32, device="cpu")
    if fmt == "prefab":
        path = str(tmp_path / "model.prefab")
        prefab.save_prefab(path, model)
    assert tloader.read_info(path) == model.info


def test_reload_refuses_a_head_size_the_card_kernels_lack(tmp_path,
                                                          monkeypatch):
    """On a card a model of head size 36 is refused by ``reload``, naming
    36, before the model in service is unloaded; a head size in the range
    passes the check."""
    import asyncio
    import json

    from ai00_server_tpu_torch import middleware as mw
    from ai00_server_tpu_torch.middleware import ReloadRequest

    good, bad = tmp_path / "good.st", tmp_path / "bad.st"
    write_st(good, "V7", 40)
    write_st(bad, "V7", 36)
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps({str(i): chr(64 + i) for i in range(1, 60)}))

    def request(path):
        return ReloadRequest(model_path=str(path), tokenizer_path=str(vocab),
                             max_batch=2, precision="Fp32", prewarm=False)

    m = mw.Middleware(device="cpu")

    async def main():
        await m.reload(request(good))
        env = m.env
        assert env is not None
        monkeypatch.setattr(m, "device", torch.device("cuda", 0))
        with pytest.raises(ValueError, match=r"head size 36: the CUDA "
                                             r"kernels take"):
            await m.reload(request(bad))
        assert m.env is env  # the model in service was not unloaded
        assert m._head_size(request(good)) == 40
        monkeypatch.setattr(m, "device", torch.device("cpu"))
        await m.unload()

    asyncio.run(main())
