"""The WKV kernels at head sizes other than 64, on the card.

Every N-dependent kernel (``csrc/wkv7.cu``, ``wkv56.cu``, ``v7_wkv_gn.cu``,
``v6_decode.cu``, one library per head size) against its plain version and
its mirror at every split it takes, at powers of two (8 and 16 laid out at
32, 32, 128), at sizes masked inside a larger tile (24, 40, 72, 120) and at
64, B = 3 with an idle row; the fused stacks' kernels against their plain
versions at N = 32 and 128; and the refusal of the sizes outside ``N % 8
== 0``, ``8 <= N <= 128``.  Marked ``cuda``: they skip without a CUDA
device and run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_heads.py``.
Tolerances as ``tests/test_torch_cuda.py``: 1e-4 of max(1, |plain|)
against the plain versions, 1e-5 against the mirrors, one bf16 ulp (2^-7)
on results rounded to bf16.
"""

import pytest
import torch

from ai00_server_tpu_torch.ops import _build, wkv_chunk, wkv_t1
from ai00_server_tpu_torch.ops import v6_decode as fd6
from ai00_server_tpu_torch.ops import v7_decode as fd

pytestmark = pytest.mark.cuda

HEADS = (8, 16, 24, 32, 40, 64, 72, 120, 128)
MIRROR_TOL = 1e-5
W_FLOOR = 0.6065306597126334  # v7: w = exp(-W_SCALE sigmoid(.))


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want, tol=1e-4):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(1.0, float(want.float().abs().max())), err


def _rnd(gen, dev):
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    return rnd


def _mask(dev, B, T=None):
    """Row 1 idle (B > 1); with T, row 0 with a masked step inside."""
    if T is None:
        mask = torch.ones(B, dtype=torch.bool, device=dev)
        mask[1:2] = False
        return mask
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[1:2] = False
    mask[0, min(2, T - 1)] = False
    return mask


def _t1_splits(N):
    return [(N, s) for s in wkv_t1.splits(N)]


def _chunk_splits(N):
    return [(N, s) for s in wkv_chunk.splits(N)]


T1_CASES = [c for N in HEADS for c in _t1_splits(N)]
CHUNK_CASES = [c for N in HEADS for c in _chunk_splits(N)]


@pytest.mark.parametrize("vec", ["f32", "layer"])
@pytest.mark.parametrize("N,slices", T1_CASES)
def test_wkv7_t1_head_size(dev, monkeypatch, N, slices, vec):
    monkeypatch.setattr(wkv_t1, "plan", lambda *a: slices)
    rnd = _rnd(torch.Generator(device=dev).manual_seed(N + slices), dev)
    B, H = 3, 2
    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, H, N, scale=0.3) for _ in range(3))
    w = torch.exp(-W_FLOOR * torch.sigmoid(rnd(B, H, N)))
    kk = rnd(B, H, N)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    a = torch.sigmoid(rnd(B, H, N))
    vecs = [r, w, k, v, kk, a]
    if vec == "layer":  # models/v7.py: w f32, the rest bf16
        vecs = [t if i == 1 else t.bfloat16() for i, t in enumerate(vecs)]
    mask = _mask(dev, B)
    torch.cuda.synchronize()  # the kernel reads S before it waits
    before = wkv_t1.wkv7_t1.launches
    S_k, y_k = wkv_t1.wkv7_t1(S, *vecs, mask)
    assert wkv_t1.wkv7_t1.launches == before + 1
    S_p, y_p = wkv_t1.wkv7_t1_plain(S, *vecs, mask)
    _close(S_k, S_p)
    _close(y_k, y_p)
    S_m, y_m = wkv_t1.wkv7_t1_mirror(S, *vecs, mask, slices=slices)
    _close(S_k, S_m, MIRROR_TOL)
    _close(y_k, y_m, MIRROR_TOL)
    assert torch.equal(S_k[1], S[1])


@pytest.mark.parametrize("static", [False, True], ids=["dense", "static"])
@pytest.mark.parametrize("N,slices", T1_CASES)
def test_wkv56_t1_head_size(dev, monkeypatch, N, slices, static):
    monkeypatch.setattr(wkv_t1, "plan56", lambda *a: slices)
    rnd = _rnd(torch.Generator(device=dev).manual_seed(2 * N + slices), dev)
    B, H = 3, 2
    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, H, N, scale=0.3) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(*((H, N) if static else (B, H, N)),
                                 scale=0.5)))
    u = rnd(H, N, scale=0.5)
    mask = _mask(dev, B)
    torch.cuda.synchronize()
    before = wkv_t1.wkv56_t1.launches
    S_k, y_k = wkv_t1.wkv56_t1(S, r, k, v, w, u, mask)
    assert wkv_t1.wkv56_t1.launches == before + 1
    S_p, y_p = wkv_t1.wkv56_t1_plain(S, r, k, v, w, u, mask)
    _close(S_k, S_p)
    _close(y_k, y_p)
    S_m, y_m = wkv_t1.wkv56_t1_mirror(S, r, k, v, w, u, mask, slices=slices)
    _close(S_k, S_m, MIRROR_TOL)
    _close(y_k, y_m, MIRROR_TOL)
    assert torch.equal(S_k[1], S[1])


@pytest.mark.parametrize("T", [5, 40])
@pytest.mark.parametrize("N,slices", CHUNK_CASES)
def test_wkv7_chunk_head_size(dev, monkeypatch, N, slices, T):
    monkeypatch.setattr(wkv_chunk, "plan", lambda *a: slices)
    rnd = _rnd(torch.Generator(device=dev).manual_seed(3 * N + T), dev)
    B, H = 3, 2
    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, T, H, N, scale=0.3) for _ in range(3))
    w = torch.exp(-W_FLOOR * torch.sigmoid(rnd(B, T, H, N)))
    if T == 40:  # the WY form's largest 1 / A: every decay at the floor
        w[:, 16:32] = float(torch.exp(torch.tensor(-W_FLOOR)))
    kk = rnd(B, T, H, N)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    a = torch.sigmoid(rnd(B, T, H, N))
    seqs = (r, w, k, v, kk, a)
    mask = _mask(dev, B, T)
    before = wkv_chunk.wkv7_chunk.launches
    S_k, y_k = wkv_chunk.wkv7_chunk(S, *seqs, mask)
    assert wkv_chunk.wkv7_chunk.launches == before + 1
    S_p, y_p = wkv_chunk.wkv7_chunk_plain(S, *seqs, mask)
    _close(S_k, S_p)
    _close(y_k, y_p)
    S_w, y_w = wkv_chunk.wkv7_chunk_wy(S, *seqs, mask)
    _close(S_k, S_w, MIRROR_TOL)
    _close(y_k, y_w, MIRROR_TOL)
    assert torch.equal(S_k[1], S[1])


@pytest.mark.parametrize("decay", ["dense", "static"])
@pytest.mark.parametrize("T", [5, 40])
@pytest.mark.parametrize("N,slices", CHUNK_CASES)
def test_wkv56_chunk_head_size(dev, monkeypatch, N, slices, T, decay):
    """T = 5 is the step-by-step kernel (one column a thread, HN threads),
    T = 40 the two chunked passes."""
    monkeypatch.setattr(wkv_chunk, "plan", lambda *a: slices)
    rnd = _rnd(torch.Generator(device=dev).manual_seed(5 * N + T), dev)
    B, H = 3, 2
    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, T, H, N, scale=0.3) for _ in range(3))
    shape = (H, N) if decay == "static" else (B, T, H, N)
    w = torch.exp(-torch.exp(rnd(*shape, scale=0.5)))
    u = rnd(H, N, scale=0.5)
    mask = _mask(dev, B, T)
    before = wkv_chunk.wkv56_chunk.launches
    S_k, y_k = wkv_chunk.wkv56_chunk(S, r, k, v, w, u, mask)
    assert wkv_chunk.wkv56_chunk.launches == before + 1
    S_p, y_p = wkv_chunk.wkv56_chunk_plain(S, r, k, v, w, u, mask)
    _close(S_k, S_p)
    _close(y_k, y_p)
    if not wkv_chunk.sequential(T):
        S_s, y_s = wkv_chunk.wkv56_chunk_ss(S, r, k, v, w, u, mask)
        _close(S_k, S_s, MIRROR_TOL)
        _close(y_k, y_s, MIRROR_TOL)
    assert torch.equal(S_k[1], S[1])


def _close_t(got, want, dtype):
    if dtype == torch.bfloat16:
        _close(got, want, 2.0 ** -7)
    else:
        _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("is_first", [True, False])
@pytest.mark.parametrize("N", HEADS)
def test_v7_wkv_gn_head_size(dev, N, is_first, dtype):
    rnd = _rnd(torch.Generator(device=dev).manual_seed(7 * N), dev)
    B, H = 3, 2
    C = H * N
    r, k, v, g, vf = (rnd(B, C, scale=0.5) for _ in range(5))
    w = torch.exp(-W_FLOOR * torch.sigmoid(rnd(B, C)))
    a, vmix = torch.sigmoid(rnd(B, C)), torch.sigmoid(rnd(B, C))
    vecs, S = rnd(8, C, scale=0.5), rnd(B, H, N, N)
    active = _mask(dev, B)
    S_k, vf_k = S.clone(), vf.clone()
    want, S_want, vf_want = fd.v7_wkv_gn_plain(
        r, k, v, w, a, g, vmix, vf, vecs, active, S, is_first, dtype)
    mirror, S_m, _ = fd.v7_wkv_gn_mirror(
        r, k, v, w, a, g, vmix, vf, vecs, active, S, is_first, dtype)
    torch.cuda.synchronize()  # S is read before the kernel waits
    before = fd.v7_wkv_gn.launches
    got = fd.v7_wkv_gn(r, k, v, w, a, g, vmix, vf_k, vecs, active, S_k,
                       is_first, dtype)
    assert fd.v7_wkv_gn.launches == before + 1
    _close_t(got, want, dtype)
    _close_t(got, mirror, dtype)
    _close(S_k, S_want)
    _close(S_k, S_m, MIRROR_TOL)
    assert torch.equal(vf_k, vf_want)
    assert torch.equal(S_k[1], S[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("static", [False, True], ids=["dense", "static"])
@pytest.mark.parametrize("N", HEADS)
def test_v6_wkv_gn_head_size(dev, N, static, dtype):
    rnd = _rnd(torch.Generator(device=dev).manual_seed(11 * N), dev)
    B, H = 3, 2
    C = H * N
    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = torch.nn.functional.silu(rnd(B, C))
    vecs, S = rnd(4, C, scale=0.5), rnd(B, H, N, N)
    vecs[0] = torch.exp(-torch.exp(vecs[0]))
    w = None if static else torch.exp(-torch.exp(rnd(B, C, scale=0.5)))
    active = _mask(dev, B)
    S_k = S.clone()
    want, S_want = fd6.v6_wkv_gn_plain(r, k, v, w, g, vecs, active, S, dtype)
    mirror, S_m = fd6.v6_wkv_gn_mirror(r, k, v, w, g, vecs, active, S, dtype)
    torch.cuda.synchronize()
    before = fd6.v6_wkv_gn.launches
    got = fd6.v6_wkv_gn(r, k, v, w, g, vecs, active, S_k, dtype)
    assert fd6.v6_wkv_gn.launches == before + 1
    _close_t(got, want, dtype)
    _close_t(got, mirror, dtype)
    _close(S_k, S_want)
    _close(S_k, S_m, MIRROR_TOL)
    assert torch.equal(S_k[1], S[1])


@pytest.mark.parametrize("version", ["V7", "V6", "V5"])
@pytest.mark.parametrize("N", [32, 40, 128])
def test_fused_stack_head_size(dev, N, version):
    """A 2-layer f32 model of head size N: the fused stack's kernels
    against its plain version, three steps with an idle row."""
    import numpy as np

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import ModelVersion, v5, v6, v7
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.testing import make_raw_weights, tiny_info

    C = 2 * N if N < 64 else N
    info = tiny_info(ModelVersion(version), num_layer=2, num_emb=C,
                     head_size=N, num_vocab=64)
    params = stack_params(info, make_raw_weights(info, 3, np.float32),
                          dtype=torch.float32, device=dev)
    m = fused_decode.module_for(version)
    assert m.can_fuse(params)
    params[m.FUSED_KEY] = m.make_fused_layout(params)
    model = {"V7": v7, "V6": v6, "V5": v5}[version]
    state = model.init_state(info, 3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(N)
    for t in state.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.3)
    plain = {k: t.clone() for k, t in state.items()}
    for _ in range(3):
        toks = torch.randint(0, 64, (3, 1), generator=gen, device=dev)
        lens = torch.tensor([1, 0, 1], device=dev)
        torch.cuda.synchronize()
        h_k, _ = m.forward_t1(params, state, toks, lens)
        h_p, _ = m.forward_t1_plain(params, plain, toks, lens)
        torch.cuda.synchronize()
        _close(h_k, h_p)
        for key in state:
            _close(state[key], plain[key])


@pytest.mark.parametrize("N", [0, 4, 36, 136, 256])
def test_head_sizes_outside_the_range_are_refused(dev, N):
    with pytest.raises(ValueError, match=f"head size {N}:"):
        _build.check_head_size(N)
    if N == 0:
        return
    S = torch.zeros(1, 1, N, N, device=dev)
    v = torch.zeros(1, 1, N, device=dev)
    mask = torch.ones(1, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match=f"head size {N}:"):
        wkv_t1.wkv7_t1(S, v, v, v, v, v, v, mask)
    with pytest.raises(ValueError, match=f"head size {N}:"):
        wkv_t1.wkv56_t1(S, v, v, v, v, v[0], mask)
    z = torch.zeros(1, N, device=dev)
    with pytest.raises(ValueError, match=f"head size {N}:"):
        fd.v7_wkv_gn(z, z, z, z, z, z, z, z, torch.zeros(8, N, device=dev),
                     mask, S, True, torch.float32)
    with pytest.raises(ValueError, match=f"head size {N}:"):
        fd6.v6_wkv_gn(z, z, z, z, z, torch.zeros(4, N, device=dev), mask, S,
                      torch.float32)
