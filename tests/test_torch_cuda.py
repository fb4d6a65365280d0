"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the CPU test run) and
run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the root conftest imports jax, which the card's
machine need not have).  Tolerance
1e-4 relative to max(1, |plain|) in f32: the kernel fuses multiply-adds
and sums in another order than the plain version.
"""

import pytest
import torch

from ai00_server_tpu_torch.ops import wkv_chunk
from ai00_server_tpu_torch.ops.wkv_chunk import (wkv7_chunk, wkv7_chunk_plain,
                                                 wkv56_chunk,
                                                 wkv56_chunk_plain)
from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1, wkv7_t1_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(gen, dev, B, T, H, N=64):
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, T, H, N, scale=0.3) for _ in range(3))
    w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, T, H, N)))
    kk = rnd(B, T, H, N)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    a = torch.sigmoid(rnd(B, T, H, N))
    return S, (r, w, k, v, kk, a)


def _close(got, want, tol=1e-4):
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


# A chunk kernel against its arithmetic in PyTorch (``wkv7_chunk_wy``,
# ``wkv56_chunk_ss``: the same chunked form, sub-chunk by sub-chunk): ten
# times tighter than against the step-by-step plain versions, so a kernel
# and its mirror that drift apart fail here first.
MIRROR_TOL = 1e-5


# The vectors' dtypes wkv7_t1 takes as they are: all f32, all bf16, and the
# layer path's mix (w f32, the other five bf16).
T1_VEC_DTYPES = {"f32": [torch.float32] * 6, "bf16": [torch.bfloat16] * 6,
                 "layer": [torch.bfloat16, torch.float32] + [torch.bfloat16] * 4}


def _t1_case(dev, B, H, seed, dtypes):
    """(S, vecs in their dtypes, mask with rows 1 and 4 idle where B > 4,
    row 1 where B > 1), the state synchronised: the kernel reads it before
    it waits for the kernel launched before it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    S, seqs = _inputs(gen, dev, B, 1, H)
    vecs = [x[:, 0].to(dt).contiguous() for x, dt in zip(seqs, dtypes)]
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    mask[1:2] = False
    mask[4:5] = False
    torch.cuda.synchronize()
    return S, vecs, mask


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("vec", sorted(T1_VEC_DTYPES))
@pytest.mark.parametrize("B", [1, 3, 8])
def test_wkv7_t1_kernel_matches_plain(dev, monkeypatch, B, vec, slices):
    """Every split of a head (``wkv_t1.plan`` forced), B = 1 / 3 / 8 with
    idle rows, f32, bf16 and mixed vectors: one launch, within 1e-4 of the
    plain version and 1e-5 of the mirror, idle rows bit for bit."""
    from ai00_server_tpu_torch.ops import wkv_t1

    monkeypatch.setattr(wkv_t1, "plan", lambda B, H, sms: slices)
    S, vecs, mask = _t1_case(dev, B, 3, 10 * B + slices, T1_VEC_DTYPES[vec])
    before = wkv7_t1.launches
    S_k, y_k = wkv7_t1(S, *vecs, mask)
    assert wkv7_t1.launches == before + 1
    S_p, y_p = wkv7_t1_plain(S, *vecs, mask)
    _close(S_k, S_p)
    _close(y_k, y_p)
    S_m, y_m = wkv_t1.wkv7_t1_mirror(S, *vecs, mask, slices=slices)
    _close(S_k, S_m, MIRROR_TOL)
    _close(y_k, y_m, MIRROR_TOL)
    for b in range(B):
        if not mask[b]:
            assert torch.equal(S_k[b], S[b])


def test_wkv7_t1_kernel_bf16_vectors_equal_their_f32_widening(dev):
    """bf16 vectors are read as the f32 they widen to: the same bits as the
    kernel on their f32 copies."""
    S, vecs, mask = _t1_case(dev, 8, 16, 3, T1_VEC_DTYPES["layer"])
    wide = [v.float() for v in vecs]
    torch.cuda.synchronize()
    S_a, y_a = wkv7_t1(S, *vecs, mask)
    S_b, y_b = wkv7_t1(S, *wide, mask)
    assert torch.equal(S_a, S_b) and torch.equal(y_a, y_b)


def test_wkv7_t1_kernel_graph_replay_equals_eager(dev):
    """The kernel captured in a CUDA graph gives the eager call's bits, and
    the same bits on every replay."""
    S, vecs, mask = _t1_case(dev, 8, 16, 4, T1_VEC_DTYPES["layer"])
    S_e, y_e = wkv7_t1(S, *vecs, mask)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wkv7_t1(S, *vecs, mask)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        S_g, y_g = wkv7_t1(S, *vecs, mask)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(S_g, S_e) and torch.equal(y_g, y_e)


def test_wkv7_t1_refuses_what_it_does_not_take(dev):
    S, vecs, mask = _t1_case(dev, 2, 2, 5, T1_VEC_DTYPES["f32"])
    odd = torch.zeros(S.numel() + 1, device=dev)[1:].view(S.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv7_t1(odd, *vecs, mask)
    odd_v = torch.zeros(vecs[0].numel() + 1, device=dev)[1:].view(
        vecs[0].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv7_t1(S, odd_v, *vecs[1:], mask)
    odd_b = torch.zeros(vecs[0].numel() + 2, device=dev,
                        dtype=torch.bfloat16)[2:].view(vecs[0].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv7_t1(S, odd_b, *vecs[1:], mask)
    with pytest.raises(ValueError, match="f32 or bf16"):
        wkv7_t1(S, vecs[0].half(), *vecs[1:], mask)
    with pytest.raises(ValueError, match="f32 or bf16"):
        wkv7_t1(S, vecs[0].transpose(0, 1).contiguous().transpose(0, 1),
                *vecs[1:], mask)
    with pytest.raises(ValueError, match="state must be"):
        wkv7_t1(S.bfloat16(), *vecs, mask)


@pytest.mark.parametrize("T", [1, 16, 37])
def test_wkv7_chunk_kernel_matches_plain(dev, T):
    gen = torch.Generator(device=dev).manual_seed(T)
    S, seqs = _inputs(gen, dev, 3, T, 2)
    lens = torch.tensor([T, T // 2, 0], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    S_k, y_k = wkv7_chunk(S, *seqs, mask)
    S_p, y_p = wkv7_chunk_plain(S, *seqs, mask)
    _close(S_k, S_p)
    _close(y_k, y_p)  # masked steps read the kept state in both
    assert torch.equal(S_k[2], S[2])


def _ragged_mask(dev, B, T):
    """Row 0 whole but for one step inside, row 1 half, the last row idle."""
    lens = torch.tensor([T, T // 2] + [T] * (B - 3) + [0], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    mask[0, min(2, T - 1)] = False
    return mask


# Every state split of the chunk kernels (ops/wkv_chunk.plan picks one from
# the card's SMs), v7's decay at its floor exp(-exp(-0.5)) (the WY form's
# precondition, its largest 1 / A), B = 1 and 4, T inside one sub-chunk and
# over three.
@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("B,T", [(4, 5), (4, 40), (1, 40)])
def test_wkv7_chunk_kernel_every_split(dev, monkeypatch, slices, floor, B, T):
    monkeypatch.setattr(wkv_chunk, "plan", lambda B, H, sms: slices)
    gen = torch.Generator(device=dev).manual_seed(10 * T + slices)
    S, seqs = _inputs(gen, dev, B, T, 3)
    if floor:
        seqs[1].fill_(float(torch.exp(torch.tensor(-0.6065306597126334))))
    mask = (_ragged_mask(dev, B, T) if B > 2
            else torch.ones(B, T, dtype=torch.bool, device=dev))
    before = wkv7_chunk.launches
    S_k, y_k = wkv7_chunk(S, *seqs, mask)
    S_p, y_p = wkv7_chunk_plain(S, *seqs, mask)
    assert wkv7_chunk.launches == before + 1
    _close(S_k, S_p)
    _close(y_k, y_p)
    S_w, y_w = wkv_chunk.wkv7_chunk_wy(S, *seqs, mask)
    _close(S_k, S_w, MIRROR_TOL)
    _close(y_k, y_w, MIRROR_TOL)
    if B > 2:
        assert torch.equal(S_k[-1], S[-1])


def _chunk56_inputs(gen, dev, B, T, H, decay):
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    S = rnd(B, H, 64, 64)
    r, k, v = (rnd(B, T, H, 64, scale=0.3) for _ in range(3))
    # v6's data-dependent decay, the extreme one of tests/test_wkv_chunked.py
    # (log w down to ~ -e^4), v5's static (H, N) one.
    shape = (H, 64) if decay == "static" else (B, T, H, 64)
    w = torch.exp(-torch.exp(rnd(*shape, scale=2.0 if decay == "extreme"
                                 else 0.5)))
    return S, (r, k, v, w), rnd(H, 64, scale=0.5)


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("decay", ["dense", "extreme", "static"])
@pytest.mark.parametrize("B,T", [(4, 5), (4, 40), (1, 40)])
def test_wkv56_chunk_kernel_every_split(dev, monkeypatch, slices, decay, B,
                                        T):
    monkeypatch.setattr(wkv_chunk, "plan", lambda B, H, sms: slices)
    gen = torch.Generator(device=dev).manual_seed(20 * T + slices)
    S, seqs, u = _chunk56_inputs(gen, dev, B, T, 3, decay)
    mask = (_ragged_mask(dev, B, T) if B > 2
            else torch.ones(B, T, dtype=torch.bool, device=dev))
    before = wkv56_chunk.launches
    S_k, y_k = wkv56_chunk(S, *seqs, u, mask)
    S_p, y_p = wkv56_chunk_plain(S, *seqs, u, mask)
    assert wkv56_chunk.launches == before + 1
    _close(S_k, S_p)
    _close(y_k, y_p)  # every step, masked ones included
    if not wkv_chunk.sequential(T):  # the chunked kernel, not step by step
        S_s, y_s = wkv_chunk.wkv56_chunk_ss(S, *seqs, u, mask)
        _close(S_k, S_s, MIRROR_TOL)
        _close(y_k, y_s, MIRROR_TOL)
    if B > 2:
        assert torch.equal(S_k[-1], S[-1])

def test_kernel_refuses_other_head_sizes(dev):
    S = torch.zeros(1, 1, 32, 32, device=dev)
    v = torch.zeros(1, 1, 32, device=dev)
    with pytest.raises(ValueError, match="head size 64"):
        wkv7_t1(S, v, v, v, v, v, v, torch.ones(1, dtype=torch.bool,
                                                device=dev))


# ---------------------------------------------------------------------------
# The fused decode step's kernels (csrc/v7_decode.cu)
# ---------------------------------------------------------------------------
#
# f32 results: 1e-4 as above.  bf16 results: 2^-7 of the largest value —
# the kernel sums in another order than the plain version, which can move a
# sum across a rounding boundary and flip one bf16 ulp.

from ai00_server_tpu_torch.ops import v7_decode as fd  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


def _close_t(got, want, dtype, rounded=True):
    if dtype == torch.bfloat16 and rounded:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -7 * max(1.0, float(want.float().abs().max())), err
    else:
        _close(got, want)


def _graphed(fn):
    """``fn()`` captured in a CUDA graph and replayed once: its outputs."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    graph.replay()
    torch.cuda.synchronize()
    return outs


# (B, C): the stacks' widths (v7 / v5 / v4 0.4B 1024, v6 1B6 2048, v7 2.9B
# 2560) at the fused stacks' batches and the phased stacks' 64.
LN_SHAPES = [(5, 1024), (1, 1024), (8, 1024), (11, 2048), (8, 2560),
             (64, 2560), (64, 1024)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_mix", [6, 1])
@pytest.mark.parametrize("B,C", LN_SHAPES)
def test_v7_ln_mix_kernel_matches_plain(dev, dtype, n_mix, B, C):
    gen = torch.Generator(device=dev).manual_seed(n_mix + B + C)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x, shift = rnd(B, C, scale=2.0), rnd(B, C)
    ln = torch.stack([1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]).to(dtype)
    mix = rnd(n_mix, C, scale=0.3).to(dtype)
    active = torch.arange(B, device=dev) % 3 != 1
    want, want_shift = fd.v7_ln_mix_plain(x, ln, shift, mix, active)
    kept = shift.clone()
    before = fd.v7_ln_mix.launches
    got = fd.v7_ln_mix(x, ln, shift, mix, active)
    assert fd.v7_ln_mix.launches == before + 1
    _close_t(got, want, dtype)
    _close(shift, want_shift)
    assert torch.equal(shift[~active], kept[~active])
    # Equal inputs give equal bits, eagerly and replayed from a graph.
    new_shift = shift.clone()
    for run in (lambda: fd.v7_ln_mix(x, ln, sh, mix, active),
                lambda: _graphed(lambda: fd.v7_ln_mix(x, ln, sh, mix,
                                                      active))):
        sh = kept.clone()
        assert torch.equal(run(), got) and torch.equal(sh, new_shift)


def _products(gen, dev, dtype, B, shapes):
    """One product per (K, N, act, bias, round_cd, out)."""
    out = []
    for K, N, act, bias, round_cd, kind in shapes:
        x = (torch.randn(B, K, generator=gen, device=dev) * 0.5).to(dtype)
        W = (torch.randn(K, N, generator=gen, device=dev)
             / K ** 0.5).to(dtype)
        out.append(fd.Product(
            x, W, act=act, round_cd=round_cd, out=kind,
            bias=torch.randn(N, generator=gen, device=dev) if bias else None,
            y=torch.randn(B, N, generator=gen, device=dev)
            if kind == "add" else None))
    return out


GROUPS = {
    "rkv": [(1024, 1024, "none", False, True, "f32")] * 3,
    "lora_down": [(1024, 64, "tanh", False, False, "cd"),
                  (1024, 64, "none", False, False, "cd"),
                  (1024, 32, "none", False, False, "cd"),
                  (1024, 128, "sigmoid", False, False, "cd")],
    "lora_up": [(64, 1024, "wdecay", True, False, "f32"),
                (64, 1024, "sigmoid", True, True, "f32"),
                (32, 1024, "sigmoid", True, True, "f32"),
                (128, 1024, "none", False, False, "f32")],
    "wo": [(1024, 1024, "none", False, False, "add")],
    "fkey": [(1024, 4096, "relu2", False, False, "cd")],
    "fval": [(4096, 1024, "none", False, False, "add")],
    # v6's narrow products: the token-shift and decay LoRA downs.
    "narrow": [(2048, 160, "tanh", False, False, "cd"),
               (2048, 64, "tanh", False, False, "cd"),
               (1024, 32, "none", True, False, "f32")],
    "ragged": [(200, 70, "tanh", True, False, "f32"),
               (1500, 42, "none", False, False, "add")],
}
BATCHES = [*range(1, 9), 11]


def _check_skinny(prods, dtype, B, counter="launches"):
    """One v7_skinny_matmul call against its plain version; launches
    counted per 8 rows; equal inputs give equal bits, eagerly and replayed
    from a CUDA graph."""
    want = fd.v7_skinny_matmul_plain(prods)
    y0 = [None if p.y is None else p.y.clone() for p in prods]

    def fresh():
        return [fd.Product(**{**p.__dict__, "y": None if y is None
                              else y.clone()}) for p, y in zip(prods, y0)]

    before = getattr(fd.v7_skinny_matmul, counter)
    got = fd.v7_skinny_matmul(prods)
    assert getattr(fd.v7_skinny_matmul, counter) == before + -(-B // 8)
    for g, w, p in zip(got, want, prods):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close_t(g, w, dtype, rounded=p.out in ("cd", "mix") or p.round_cd)
    for g, g2 in zip(got, fd.v7_skinny_matmul(fresh())):
        assert torch.equal(g, g2)
    again = fresh()
    for g, g2 in zip(got, _graphed(lambda: fd.v7_skinny_matmul(again))):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_v7_skinny_matmul_kernel_matches_plain(dev, dtype, B, group):
    gen = torch.Generator(device=dev).manual_seed(B)
    _check_skinny(_products(gen, dev, dtype, B, GROUPS[group]), dtype, B)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("is_first", [True, False])
def test_v7_wkv_gn_kernel_matches_plain(dev, dtype, is_first):
    gen = torch.Generator(device=dev).manual_seed(int(is_first))
    B, H, N = 5, 3, 64
    C = H * N

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    r, k, v, g, vf = (rnd(B, C, scale=0.5) for _ in range(5))
    w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, C)))
    a, vmix = torch.sigmoid(rnd(B, C)), torch.sigmoid(rnd(B, C))
    vecs, S = rnd(8, C, scale=0.5), rnd(B, H, N, N)
    active = torch.tensor([True, False, True, True, False], device=dev)
    S_k, vf_k = S.clone(), vf.clone()  # before other launches: S is read
    want, S_want, vf_want = fd.v7_wkv_gn_plain(  # before the kernel waits
        r, k, v, w, a, g, vmix, vf, vecs, active, S, is_first, dtype)
    got = fd.v7_wkv_gn(r, k, v, w, a, g, vmix, vf_k, vecs, active, S_k,
                       is_first, dtype)
    _close_t(got, want, dtype)
    _close(S_k, S_want)
    assert torch.equal(vf_k, vf_want)
    assert torch.equal(S_k[1], S[1]) and torch.equal(S_k[4], S[4])


def _tiny_fused(dev, dtype, L=2, C=128, V=64):
    import numpy as np

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import v7
    from ai00_server_tpu_torch.testing import make_raw_weights, tiny_info

    info = tiny_info(num_layer=L, num_emb=C, head_size=64, num_vocab=V)
    params = stack_params(info, make_raw_weights(info, 5, np.float32),
                          dtype=dtype, device=dev)
    params[fd.FUSED_KEY] = fd.make_fused_layout(params)
    return info, params, v7


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_t1_kernels_graph_and_plain_agree(dev, dtype):
    info, params, v7 = _tiny_fused(dev, dtype)
    B = 4
    gen = torch.Generator(device=dev).manual_seed(3)
    base = v7.init_state(info, B, device=dev)
    for t in base.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.3)
    steps = [(torch.randint(0, 64, (B,), generator=gen, device=dev),
              torch.tensor(l, device=dev))
             for l in ([1, 1, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1])]
    runs = {}
    for how in ("plain", "eager", "graph"):
        state = {k: t.clone() for k, t in base.items()}
        graph = fd.DecodeGraph(params, state, B) if how == "graph" else None
        hs = []
        for toks, lens in steps:
            if how == "graph":
                hs.append(graph.replay(toks, lens).clone())
            else:
                fwd = fd.forward_t1 if how == "eager" else fd.forward_t1_plain
                hs.append(fwd(params, state, toks[:, None], lens)[0][:, 0])
        runs[how] = (hs, state)
    (h_e, s_e), (h_g, s_g), (h_p, s_p) = (runs[k] for k in
                                          ("eager", "graph", "plain"))
    for a, b in zip(h_e, h_g):  # the graph replays the same kernels
        assert torch.equal(a, b)
    for k in s_e:
        assert torch.equal(s_e[k], s_g[k])
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = float((s_e[k] - s_p[k]).abs().max())
        assert err <= tol * max(1.0, float(s_p[k].abs().max())), (k, err)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(h_e, h_p):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(1.0, float(b.float().abs().max())), err
    # Row 2 sat out the first step only in the first step's mask; row 1 the
    # second: check an idle row's state directly on a fresh step.
    state = {k: t.clone() for k, t in base.items()}
    fd.forward_t1(params, state, steps[0][0][:, None], steps[0][1])
    for k in state:
        assert torch.equal(state[k][:, 2], base[k][:, 2])


def test_v7_decode_kernels_refuse_what_they_do_not_take(dev):
    z = torch.zeros(2, 32, device=dev)
    with pytest.raises(ValueError, match="head size 64"):
        fd.v7_wkv_gn(z, z, z, z, z, z, z, z, torch.zeros(8, 32, device=dev),
                     torch.ones(2, dtype=torch.bool, device=dev),
                     torch.zeros(2, 1, 32, 32, device=dev), True,
                     torch.float32)
    x = torch.zeros(2, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 2"):
        fd.v7_skinny_matmul([fd.Product(
            x, torch.zeros(16, 13, device=dev, dtype=torch.bfloat16))])
    with pytest.raises(ValueError, match="16-byte and the rows"):
        fd.v7_skinny_matmul([fd.Product(
            torch.zeros(2, 17, device=dev, dtype=torch.bfloat16)[:, :16],
            torch.zeros(16, 16, device=dev, dtype=torch.bfloat16))])
    with pytest.raises(ValueError, match="contiguous"):
        fd.v7_skinny_matmul([fd.Product(
            x, torch.zeros(16, 16, device=dev, dtype=torch.bfloat16).t())])
    with pytest.raises(ValueError, match="CUDA graph needs CUDA"):
        fd.DecodeGraph({}, {"wkv": torch.zeros(1)}, 1)


# ---------------------------------------------------------------------------
# The int8 kernels (csrc/quant.cu) and the int8 mode of v7_skinny_matmul
# ---------------------------------------------------------------------------
#
# The kernel and its plain version dequantize identically (the scale rounded
# to the activation dtype, then the product) and differ in the order of the
# f32 sums: 1e-4 of max(1, |plain|) on f32 results, one bf16 ulp (2^-7) on
# results rounded to bf16.

from ai00_server_tpu_torch.ops import quant  # noqa: E402
from ai00_server_tpu_torch.ops.ffn import (ffn7_t1_l,  # noqa: E402
                                           ffn7_t1_l_plain)
from ai00_server_tpu_torch.ops.quant_matmul import (  # noqa: E402
    matmul_int8, matmul_int8_l, matmul_int8_l_plain, matmul_int8_plain)


def _planned(dev, K, N, R, mode="int8"):
    """The launches ``ops/quant_matmul.plan`` gives a (R, K) @ (K, N)
    product on this card: the count the wrappers add to ``.launches``."""
    from ai00_server_tpu_torch.ops.device import sm_count
    from ai00_server_tpu_torch.ops.quant_matmul import plan

    return len(plan(K, N, R, mode, sm_count(dev.index)))


def _codes(gen, dev, *shape):
    """Random weights (..., K, N) quantized on the card."""
    K = shape[-2]
    w = torch.randn(*shape, generator=gen, device=dev) / K ** 0.5
    return quant.quantize_int8(w)


def test_quantize_int8_on_the_card_equals_the_host(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(3, 256, 72, generator=gen, device=dev)
    on_card = quant.quantize_int8(w)
    on_host = quant.quantize_int8(w.cpu().numpy(), device=dev)
    assert torch.equal(on_card.q, on_host.q)
    assert torch.equal(on_card.scale, on_host.scale)
    assert on_card.shape == on_host.shape == (256, 72)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("R,K,N", [(1, 128, 128), (3, 256, 384), (8, 1024, 1024),
                                   (8, 1024, 4096), (8, 4096, 1024),
                                   (11, 384, 200), (29, 1024, 65536)])
def test_matmul_int8_kernel_matches_plain(dev, dtype, out_f32, R, K, N):
    gen = torch.Generator(device=dev).manual_seed(R + K)
    ql = _codes(gen, dev, K, N)
    x = (torch.randn(R, K, generator=gen, device=dev) * 0.5).to(dtype)
    out_dtype = torch.float32 if out_f32 else None
    want = matmul_int8_plain(x, ql.q, ql.scale, out_dtype)
    before = matmul_int8.launches
    got = matmul_int8(x, ql.q, ql.scale, out_dtype)
    assert matmul_int8.launches == before + _planned(dev, K, N, R)
    assert got.dtype == want.dtype and got.shape == (R, N)
    _close_t(got, want, got.dtype)
    assert torch.equal(got, matmul_int8(x, ql.q, ql.scale, out_dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 5, 13])
def test_matmul_int8_l_kernel_matches_plain(dev, dtype, R):
    gen = torch.Generator(device=dev).manual_seed(R)
    L, K, N = 3, 256, 320
    ql = _codes(gen, dev, L, K, N)
    x = (torch.randn(R, 1, K, generator=gen, device=dev) * 0.5).to(dtype)
    for l in range(L):
        want = matmul_int8_l_plain(x, ql.q, ql.scale, l)
        before = matmul_int8_l.launches
        got = matmul_int8_l(x, ql.q, ql.scale, l)
        assert matmul_int8_l.launches == before + _planned(dev, K, N, R)
        assert got.shape == (R, 1, N) and got.dtype == dtype
        _close_t(got, want, dtype)
        view = quant.QuantizedLayerView(ql, l)
        assert torch.equal(view.matmul(x), got)
        assert view.q.data_ptr() == ql.q[l].data_ptr()  # a view, no copy


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,C,F", [(8, 1024, 4096), (3, 128, 512),
                                   (11, 256, 640)])
def test_ffn7_t1_l_kernel_matches_plain(dev, dtype, B, C, F):
    gen = torch.Generator(device=dev).manual_seed(B)
    L, l = 2, 1
    key, val = _codes(gen, dev, L, C, F), _codes(gen, dev, L, F, C)
    xf = torch.randn(B, C, generator=gen, device=dev).to(dtype)
    shift = torch.randn(B, C, generator=gen, device=dev)
    mix = (torch.randn(C, generator=gen, device=dev) * 0.3).to(dtype)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[1] = False
    args = (xf, shift, mix, active, key.q, key.scale, val.q, val.scale, l)
    want, want_shift = ffn7_t1_l_plain(*args)
    kept = shift.clone()
    before = ffn7_t1_l.launches
    got, got_shift = ffn7_t1_l(*args)
    assert ffn7_t1_l.launches == before + _planned(dev, C, F, B)
    assert got.dtype == torch.float32 and got_shift.dtype == torch.float32
    # hk is rounded to the activation dtype between the two products: a
    # flipped bf16 ulp of hk moves the f32 output by that ulp times a weight.
    if dtype == torch.bfloat16:
        _close_t(got, want, dtype)
    else:
        _close(got, want)
    assert torch.equal(got_shift, want_shift)
    assert torch.equal(got_shift[1], kept[1]) and torch.equal(shift, kept)
    assert torch.equal(got, ffn7_t1_l(*args)[0])


INT8_GROUPS = {
    "rkv": [(1024, 1024, "none", False, True, "f32")] * 3,
    "wo": [(1024, 1024, "none", False, False, "add")],
    "fkey": [(1024, 4096, "relu2", False, False, "cd")],
    "fval": [(4096, 1024, "none", False, False, "add")],
    "ragged": [(256, 72, "tanh", True, False, "f32"),
               (1536, 44, "none", False, False, "add")],
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("group", sorted(INT8_GROUPS))
def test_v7_skinny_matmul_int8_matches_plain(dev, dtype, B, group):
    gen = torch.Generator(device=dev).manual_seed(B)
    prods = _products(gen, dev, dtype, B, INT8_GROUPS[group])
    for p in prods:
        ql = quant.quantize_int8(p.W.float())
        p.W, p.scale = ql.q, ql.scale
    _check_skinny(prods, dtype, B, "int8_launches")


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_t1_int8_kernels_graph_and_plain_agree(dev, dtype):
    import numpy as np

    from ai00_server_tpu_torch.models import v7
    from ai00_server_tpu_torch.testing import (make_params, make_raw_weights,
                                               tiny_info)

    L, B = 2, 4
    info = tiny_info(num_layer=L, num_emb=128, head_size=64, num_vocab=64)
    params = make_params(info, make_raw_weights(info, 5, np.float32), dtype,
                         quant={i: "int8" for i in range(L)}, device=dev)
    assert fd.can_fuse(params)
    params[fd.FUSED_KEY] = fd.make_fused_layout(params)
    gen = torch.Generator(device=dev).manual_seed(3)
    base = v7.init_state(info, B, device=dev)
    for t in base.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.3)
    steps = [(torch.randint(0, 64, (B,), generator=gen, device=dev),
              torch.tensor(l, device=dev))
             for l in ([1, 1, 0, 1], [1, 0, 1, 1])]
    runs = {}
    for how in ("plain", "eager", "graph"):
        state = {k: t.clone() for k, t in base.items()}
        graph = fd.DecodeGraph(params, state, B) if how == "graph" else None
        hs = []
        for toks, lens in steps:
            if how == "graph":
                hs.append(graph.replay(toks, lens).clone())
            else:
                fwd = fd.forward_t1 if how == "eager" else fd.forward_t1_plain
                hs.append(fwd(params, state, toks[:, None], lens)[0][:, 0])
        runs[how] = (hs, state)
    (h_e, s_e), (h_g, s_g), (h_p, s_p) = (runs[k] for k in
                                          ("eager", "graph", "plain"))
    for a, b in zip(h_e, h_g):
        assert torch.equal(a, b)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for k in s_e:
        assert torch.equal(s_e[k], s_g[k])
        err = float((s_e[k] - s_p[k]).abs().max())
        assert err <= tol * max(1.0, float(s_p[k].abs().max())), (k, err)
    for a, b in zip(h_e, h_p):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(1.0, float(b.float().abs().max())), err
    state = {k: t.clone() for k, t in base.items()}
    fd.forward_t1(params, state, steps[0][0][:, None], steps[0][1])
    for k in state:
        assert torch.equal(state[k][:, 2], base[k][:, 2])


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    ql = _codes(torch.Generator(device=dev).manual_seed(0), dev, 128, 64)
    x = torch.zeros(2, 128, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        matmul_int8(x, ql.q[..., :63].contiguous(),
                    ql.scale[..., :63].contiguous())
    with pytest.raises(ValueError, match="activation dtype"):
        matmul_int8(x.half(), ql.q, ql.scale)
    with pytest.raises(ValueError, match="features"):
        matmul_int8(x[:, :64].contiguous(), ql.q, ql.scale)
    with pytest.raises(ValueError, match="all plain or all int8"):
        fd.v7_skinny_matmul([
            fd.Product(x, ql.q, scale=ql.scale),
            fd.Product(x, torch.zeros(128, 64, device=dev))])


# ---------------------------------------------------------------------------
# The 4-bit kernels (csrc/quant.cu) and the 4-bit mode of v7_skinny_matmul
# ---------------------------------------------------------------------------
#
# As for int8: kernel and plain version dequantize identically (the scale
# rounded to the activation dtype, then level x scale) and differ in the
# order of the f32 sums: 1e-4 of max(1, |plain|) on f32 results, one bf16 ulp
# (2^-7) on results rounded to bf16.

from ai00_server_tpu_torch.ops.quant_matmul import (  # noqa: E402
    matmul_4bit, matmul_4bit_l, matmul_4bit_l_plain, matmul_4bit_plain)

MODES4 = ["nf4", "sf4", "int4"]


def _codes4(gen, dev, mode, *shape):
    """Random weights (..., K, N) quantized to 4 bits on the card."""
    K = shape[-2]
    w = torch.randn(*shape, generator=gen, device=dev) / K ** 0.5
    return quant.quantize_4bit(w, mode)


@pytest.mark.parametrize("mode", MODES4)
def test_quantize_4bit_on_the_card_equals_the_host(dev, mode):
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(3, 256, 72, generator=gen, device=dev)
    w[:, :64, 5] = 0.0  # an all-zero block: the floor of the absmax
    on_card = quant.quantize_4bit(w, mode)
    on_host = quant.quantize_4bit(w.cpu().numpy(), mode, device=dev)
    assert on_card.q.dtype == torch.uint8
    assert torch.equal(on_card.q, on_host.q)
    assert torch.equal(on_card.scale, on_host.scale)
    assert on_card.shape == on_host.shape == (256, 72)
    assert torch.equal(on_card.dequant(), on_host.dequant())


@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,K,N", [(1, 64, 128), (3, 192, 384),
                                   (8, 1024, 1024), (8, 1024, 4096),
                                   (8, 4096, 1024), (11, 320, 200),
                                   (29, 1024, 8192)])
def test_matmul_4bit_kernel_matches_plain(dev, mode, dtype, R, K, N):
    gen = torch.Generator(device=dev).manual_seed(R + K)
    ql = _codes4(gen, dev, mode, K, N)
    x = (torch.randn(R, K, generator=gen, device=dev) * 0.5).to(dtype)
    want = matmul_4bit_plain(x, ql.q, ql.scale, mode)
    before = matmul_4bit.launches
    got = matmul_4bit(x, ql.q, ql.scale, mode=mode)
    assert matmul_4bit.launches == before + _planned(dev, K, N, R, mode)
    assert got.dtype == want.dtype == dtype and got.shape == (R, N)
    _close_t(got, want, dtype)
    assert torch.equal(got, matmul_4bit(x, ql.q, ql.scale, mode=mode))
    assert torch.equal(ql.matmul(x), got)  # the weight's own dispatch


@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 5, 13])
def test_matmul_4bit_l_kernel_matches_plain(dev, mode, dtype, R):
    gen = torch.Generator(device=dev).manual_seed(R)
    L, K, N = 3, 256, 320
    ql = _codes4(gen, dev, mode, L, K, N)
    x = (torch.randn(R, 1, K, generator=gen, device=dev) * 0.5).to(dtype)
    for l in range(L):
        want = matmul_4bit_l_plain(x, ql.q, ql.scale, l, mode)
        before = matmul_4bit_l.launches
        got = matmul_4bit_l(x, ql.q, ql.scale, l, mode=mode)
        assert matmul_4bit_l.launches == before + _planned(dev, K, N, R, mode)
        assert got.shape == (R, 1, N) and got.dtype == dtype
        _close_t(got, want, dtype)
        view = quant.QuantizedLayerView(ql, l)
        assert torch.equal(view.matmul(x), got)
        assert view.q.data_ptr() == ql.q[l].data_ptr()  # a view, no copy


@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,C,F", [(8, 1024, 4096), (3, 128, 512),
                                   (11, 192, 640)])
def test_ffn7_t1_l_4bit_kernel_matches_plain(dev, mode, dtype, B, C, F):
    gen = torch.Generator(device=dev).manual_seed(B)
    L, l = 2, 1
    key = _codes4(gen, dev, mode, L, C, F)
    val = _codes4(gen, dev, mode, L, F, C)
    xf = torch.randn(B, C, generator=gen, device=dev).to(dtype)
    shift = torch.randn(B, C, generator=gen, device=dev)
    mix = (torch.randn(C, generator=gen, device=dev) * 0.3).to(dtype)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[1] = False
    args = (xf, shift, mix, active, key.q, key.scale, val.q, val.scale, l)
    want, want_shift = ffn7_t1_l_plain(*args, qmode=mode)
    kept = shift.clone()
    before = ffn7_t1_l.launches
    got, got_shift = ffn7_t1_l(*args, qmode=mode)
    assert ffn7_t1_l.launches == before + _planned(dev, C, F, B, mode)
    assert got.dtype == torch.float32 and got_shift.dtype == torch.float32
    if dtype == torch.bfloat16:  # hk is rounded between the two products
        _close_t(got, want, dtype)
    else:
        _close(got, want)
    assert torch.equal(got_shift, want_shift)
    assert torch.equal(got_shift[1], kept[1]) and torch.equal(shift, kept)
    assert torch.equal(got, ffn7_t1_l(*args, qmode=mode)[0])


# Every row tile of the plan (8, 16, 32, 64 rows; 65, 256 and 511 rows are
# several launches, the last one ragged) on stacked codes, and the channel
# mix at the same row counts.
QUANT_ROWS = [*range(1, 9), 11, 64, 65, 256, 511]


@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", QUANT_ROWS)
def test_quant_matmul_every_row_tile(dev, mode, dtype, R):
    gen = torch.Generator(device=dev).manual_seed(R)
    L, K, N = 2, 1024, 384
    ql = (_codes(gen, dev, L, K, N) if mode == "int8"
          else _codes4(gen, dev, mode, L, K, N))
    fn, plain = ((matmul_int8_l, matmul_int8_l_plain) if mode == "int8"
                 else (matmul_4bit_l, matmul_4bit_l_plain))
    extra = {} if mode == "int8" else {"mode": mode}
    x = (torch.randn(R, K, generator=gen, device=dev) * 0.5).to(dtype)
    want = plain(x, ql.q, ql.scale, 1, **extra)
    before = fn.launches
    got = fn(x, ql.q, ql.scale, 1, **extra)
    assert fn.launches == before + _planned(dev, K, N, R, mode)
    assert got.shape == (R, N) and got.dtype == dtype
    _close_t(got, want, dtype)
    assert torch.equal(got, fn(x, ql.q, ql.scale, 1, **extra))


@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", QUANT_ROWS)
def test_ffn7_t1_l_every_row_tile(dev, mode, dtype, B):
    gen = torch.Generator(device=dev).manual_seed(B)
    L, l, C, F = 2, 1, 256, 1024
    codes = ((lambda *sh: _codes(gen, dev, *sh)) if mode == "int8"
             else (lambda *sh: _codes4(gen, dev, mode, *sh)))
    key, val = codes(L, C, F), codes(L, F, C)
    xf = torch.randn(B, C, generator=gen, device=dev).to(dtype)
    shift = torch.randn(B, C, generator=gen, device=dev)
    mix = (torch.randn(C, generator=gen, device=dev) * 0.3).to(dtype)
    active = torch.rand(B, generator=gen, device=dev) < 0.8
    args = (xf, shift, mix, active, key.q, key.scale, val.q, val.scale, l)
    want, want_shift = ffn7_t1_l_plain(*args, qmode=mode)
    before = ffn7_t1_l.launches
    got, got_shift = ffn7_t1_l(*args, qmode=mode)
    assert ffn7_t1_l.launches == before + _planned(dev, C, F, B, mode)
    if dtype == torch.bfloat16:  # hk is rounded between the two products
        _close_t(got, want, dtype)
    else:
        _close(got, want)
    assert torch.equal(got_shift, want_shift)
    assert torch.equal(got, ffn7_t1_l(*args, qmode=mode)[0])


def test_quant_kernels_equal_bits_under_a_graph_replay(dev):
    """The K split adds in rank order (no atomics): a CUDA-graph replay of
    the head product (no K split) and of a layer product and the channel
    mix (K split over a cluster) gives the eager call's bits."""
    gen = torch.Generator(device=dev).manual_seed(7)
    head = _codes(gen, dev, 256, 32768)
    stack = _codes4(gen, dev, "nf4", 2, 1024, 1024)
    key, val = _codes(gen, dev, 2, 256, 1024), _codes(gen, dev, 2, 1024, 256)
    x = (torch.randn(64, 256, generator=gen, device=dev) * 0.5).bfloat16()
    x3 = (torch.randn(11, 1024, generator=gen, device=dev) * 0.5).bfloat16()
    shift = torch.randn(64, 256, generator=gen, device=dev)
    mix = (torch.randn(256, generator=gen, device=dev) * 0.3).bfloat16()
    active = torch.ones(64, dtype=torch.bool, device=dev)

    def run():
        return (matmul_int8(x, head.q, head.scale, torch.float32),
                matmul_4bit_l(x3, stack.q, stack.scale, 1, mode="nf4"),
                *ffn7_t1_l(x, shift, mix, active, key.q, key.scale, val.q,
                           val.scale, 0))

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, eager):
            assert torch.equal(a, b)


def test_quant_kernels_refuse_misaligned_codes(dev):
    """The kernel copies codes and scales in 16-byte pieces: codes that do
    not start on 16 bytes are refused, not read."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.zeros(2, 128, device=dev)
    for ql in (_codes(gen, dev, 128, 64), _codes4(gen, dev, "nf4", 128, 64)):
        buf = torch.empty(ql.q.numel() + 16, dtype=ql.q.dtype, device=dev)
        off = buf[4:4 + ql.q.numel()].view(ql.q.shape)
        off.copy_(ql.q)
        fn = matmul_int8 if ql.mode == "int8" else matmul_4bit
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(x, off, ql.scale)


Q4_GROUPS = {
    **{k: v for k, v in INT8_GROUPS.items() if k != "ragged"},
    "ragged": [(192, 72, "tanh", True, False, "f32"),
               (1600, 44, "none", False, False, "add")],
}


@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("group", sorted(Q4_GROUPS))
def test_v7_skinny_matmul_4bit_matches_plain(dev, mode, dtype, B, group):
    gen = torch.Generator(device=dev).manual_seed(B)
    prods = _products(gen, dev, dtype, B, Q4_GROUPS[group])
    for p in prods:
        ql = quant.quantize_4bit(p.W.float(), mode)
        p.W, p.scale, p.mode = ql.q, ql.scale, mode
    before = fd.v7_skinny_matmul.int8_launches
    _check_skinny(prods, dtype, B, "q4_launches")
    assert fd.v7_skinny_matmul.int8_launches == before


@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_t1_4bit_kernels_graph_and_plain_agree(dev, mode, dtype):
    import numpy as np

    from ai00_server_tpu_torch.models import v7
    from ai00_server_tpu_torch.testing import (make_params, make_raw_weights,
                                               tiny_info)

    L, B = 2, 4
    info = tiny_info(num_layer=L, num_emb=128, head_size=64, num_vocab=64)
    params = make_params(info, make_raw_weights(info, 5, np.float32), dtype,
                         quant={i: mode for i in range(L)}, device=dev)
    assert fd.can_fuse(params)
    params[fd.FUSED_KEY] = fd.make_fused_layout(params)
    gen = torch.Generator(device=dev).manual_seed(3)
    base = v7.init_state(info, B, device=dev)
    for t in base.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.3)
    steps = [(torch.randint(0, 64, (B,), generator=gen, device=dev),
              torch.tensor(l, device=dev))
             for l in ([1, 1, 0, 1], [1, 0, 1, 1])]
    runs = {}
    for how in ("plain", "eager", "graph"):
        state = {k: t.clone() for k, t in base.items()}
        graph = fd.DecodeGraph(params, state, B) if how == "graph" else None
        hs = []
        for toks, lens in steps:
            if how == "graph":
                hs.append(graph.replay(toks, lens).clone())
            else:
                fwd = fd.forward_t1 if how == "eager" else fd.forward_t1_plain
                hs.append(fwd(params, state, toks[:, None], lens)[0][:, 0])
        runs[how] = (hs, state)
    (h_e, s_e), (h_g, s_g), (h_p, s_p) = (runs[k] for k in
                                          ("eager", "graph", "plain"))
    for a, b in zip(h_e, h_g):
        assert torch.equal(a, b)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for k in s_e:
        assert torch.equal(s_e[k], s_g[k])
        err = float((s_e[k] - s_p[k]).abs().max())
        assert err <= tol * max(1.0, float(s_p[k].abs().max())), (k, err)
    for a, b in zip(h_e, h_p):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(1.0, float(b.float().abs().max())), err
    state = {k: t.clone() for k, t in base.items()}
    fd.forward_t1(params, state, steps[0][0][:, None], steps[0][1])
    for k in state:
        assert torch.equal(state[k][:, 2], base[k][:, 2])


def test_4bit_kernels_refuse_what_they_do_not_take(dev):
    ql = _codes4(torch.Generator(device=dev).manual_seed(0), dev, "nf4", 128,
                 64)
    x = torch.zeros(2, 128, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        matmul_4bit(x, ql.q[..., :63].contiguous(),
                    ql.scale[..., :63].contiguous())
    with pytest.raises(ValueError, match="unknown 4-bit mode"):
        matmul_4bit(x, ql.q, ql.scale, mode="int8")
    with pytest.raises(ValueError, match="nf4 codes must be contiguous"):
        matmul_4bit(x, ql.q.to(torch.int8), ql.scale)
    with pytest.raises(ValueError, match="features"):
        matmul_4bit(x[:, :64].contiguous(), ql.q, ql.scale)
    i8 = _codes(torch.Generator(device=dev).manual_seed(0), dev, 128, 64)
    with pytest.raises(ValueError, match="one 4-bit mode"):
        fd.v7_skinny_matmul([
            fd.Product(x, ql.q, scale=ql.scale, mode="nf4"),
            fd.Product(x, i8.q, scale=i8.scale)])
    with pytest.raises(ValueError, match="one 4-bit mode"):
        fd.v7_skinny_matmul([
            fd.Product(x, ql.q, scale=ql.scale, mode="nf4"),
            fd.Product(x, ql.q, scale=ql.scale, mode="sf4")])


# ---------------------------------------------------------------------------
# RWKV-6: the v5/v6 WKV kernels (csrc/wkv56.cu), the fused v6 step's own
# kernels (csrc/v6_decode.cu) and the v6 epilogues of v7_skinny_matmul
# ---------------------------------------------------------------------------
#
# Tolerances as above: 1e-4 of max(1, |plain|) on f32 results, one bf16 ulp
# (2^-7) on results rounded to bf16.

from ai00_server_tpu_torch.ops import v6_decode as fd6  # noqa: E402
from ai00_server_tpu_torch.ops.wkv_chunk import (  # noqa: E402
    wkv56_chunk, wkv56_chunk_plain)
from ai00_server_tpu_torch.ops.wkv_t1 import (  # noqa: E402
    wkv56_t1, wkv56_t1_plain)


def _inputs56(gen, dev, B, T, H, N=64):
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, T, H, N, scale=0.3) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(B, T, H, N, scale=0.5)))
    return S, (r, k, v, w), rnd(H, N, scale=0.5)


def test_wkv56_t1_kernel_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    S, seqs, u = _inputs56(gen, dev, 5, 1, 3)
    vecs = [x[:, 0].contiguous() for x in seqs]
    mask = torch.tensor([True, False, True, True, False], device=dev)
    before = wkv56_t1.launches
    S_k, y_k = wkv56_t1(S, *vecs, u, mask)
    S_p, y_p = wkv56_t1_plain(S, *vecs, u, mask)
    assert wkv56_t1.launches == before + 1
    _close(S_k, S_p)
    _close(y_k, y_p)  # every row gets its y, inactive ones included
    assert torch.equal(S_k[1], S[1]) and torch.equal(S_k[4], S[4])


@pytest.mark.parametrize("T", [1, 16, 37])
def test_wkv56_chunk_kernel_matches_plain(dev, T):
    gen = torch.Generator(device=dev).manual_seed(100 + T)
    S, seqs, u = _inputs56(gen, dev, 3, T, 2)
    lens = torch.tensor([T, T // 2, 0], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    before = wkv56_chunk.launches
    S_k, y_k = wkv56_chunk(S, *seqs, u, mask)
    S_p, y_p = wkv56_chunk_plain(S, *seqs, u, mask)
    assert wkv56_chunk.launches == before + 1
    _close(S_k, S_p)
    _close(y_k, y_p)  # masked steps follow wkv_scan in both
    assert torch.equal(S_k[2], S[2])


@pytest.mark.parametrize("T", [1, 16, 37])
def test_wkv56_static_decay_matches_dense(dev, T):
    """RWKV-5's static (H, N) decay, read with a stride of 0, against the
    plain version and against the kernel given the broadcast written out."""
    gen = torch.Generator(device=dev).manual_seed(300 + T)
    S, (r, k, v, _), u = _inputs56(gen, dev, 3, T, 2)
    w = torch.exp(-torch.exp(torch.randn(2, 64, generator=gen, device=dev)))
    lens = torch.tensor([T, T // 2, 0], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    dense = w[None, None].expand(3, T, 2, 64).contiguous()
    if T == 1:
        args = (r[:, 0], k[:, 0], v[:, 0])
        S_k, y_k = wkv56_t1(S, *args, w, u, mask[:, 0])
        S_p, y_p = wkv56_t1_plain(S, *args, w, u, mask[:, 0])
        S_d, y_d = wkv56_t1(S, *args, dense[:, 0], u, mask[:, 0])
    else:
        S_k, y_k = wkv56_chunk(S, r, k, v, w, u, mask)
        S_p, y_p = wkv56_chunk_plain(S, r, k, v, w, u, mask)
        S_d, y_d = wkv56_chunk(S, r, k, v, dense, u, mask)
    _close(S_k, S_p)
    _close(y_k, y_p)
    assert torch.equal(S_k, S_d) and torch.equal(y_k, y_d)
    assert torch.equal(S_k[2], S[2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [5, 64])
def test_v6_ln_mix_kernel_matches_plain(dev, dtype, B):
    gen = torch.Generator(device=dev).manual_seed(6)
    C = 2048

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x, shift = rnd(B, C, scale=2.0), rnd(B, C)
    ln = torch.stack([1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]).to(dtype)
    mix = rnd(1, C, scale=0.3).to(dtype)
    active = torch.arange(B, device=dev) % 3 != 1
    active[4] = False
    want, want_shift = fd.v7_ln_mix_plain(x, ln, shift, mix, active,
                                          with_xa_dx=True)
    kept = shift.clone()
    before = fd.v7_ln_mix.launches
    got = fd.v7_ln_mix(x, ln, shift, mix, active, with_xa_dx=True)
    assert fd.v7_ln_mix.launches == before + 1
    assert got.shape == (3, B, C)
    _close_t(got, want, dtype)
    _close(shift, want_shift)
    assert torch.equal(shift[1], kept[1]) and torch.equal(shift[4], kept[4])


def _v6_products(gen, dev, dtype, B, kind, C=2048, D=32):
    """The v6 launches of a layer that use the new epilogues: the five
    token-shift combines on strided stages, r/k/v/g (SiLU), the decay,
    the gated residual."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def weight(K, N):
        return (rnd(K, N) / K ** 0.5).to(dtype)

    if kind == "shift_combine":
        h = rnd(B, 5 * D).to(dtype)
        xa, dx = rnd(B, C).to(dtype), rnd(B, C).to(dtype)
        mix = rnd(5, C, scale=0.3).to(dtype)
        return [fd.Product(h[:, i * D:(i + 1) * D], weight(D, C), out="mix",
                           xa=xa, dx=dx, mix=mix[i]) for i in range(5)]
    x = rnd(B, C, scale=0.5).to(dtype)
    if kind == "rkvg":
        return [fd.Product(x, weight(C, C), round_cd=True, out="f32")] * 3 \
            + [fd.Product(x, weight(C, C), act="silu", out="f32")]
    if kind == "decay":
        return [fd.Product(rnd(B, 64).to(dtype), weight(64, C),
                           act="expexp", bias=rnd(C, scale=0.5), out="f32")]
    return [fd.Product(rnd(B, 7168, scale=0.5).to(dtype), weight(7168, C),
                       out="gadd", y=rnd(B, C),
                       gate=torch.sigmoid(rnd(B, C)))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("kind", ["shift_combine", "rkvg", "decay",
                                  "gated_residual"])
def test_v7_skinny_matmul_v6_epilogues_match_plain(dev, dtype, B, kind):
    gen = torch.Generator(device=dev).manual_seed(B)
    _check_skinny(_v6_products(gen, dev, dtype, B, kind), dtype, B)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_v7_skinny_matmul_v6_epilogues_on_codes(dev, mode, dtype):
    """SiLU and the gated residual on quantized big projections."""
    from ai00_server_tpu_torch.ops.quant import QUANTIZERS

    gen = torch.Generator(device=dev).manual_seed(4)
    B, C, F = 8, 2048, 7168

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    qg = QUANTIZERS[mode](rnd(C, C) / C ** 0.5)
    qv = QUANTIZERS[mode](rnd(F, C) / F ** 0.5)
    y = rnd(B, C)
    prods = [fd.Product(rnd(B, C).to(dtype), qg.q, scale=qg.scale, mode=mode,
                        act="silu", out="f32"),
             fd.Product(rnd(B, F).to(dtype), qv.q, scale=qv.scale, mode=mode,
                        out="gadd", y=y, gate=torch.sigmoid(rnd(B, C)))]
    want = fd.v7_skinny_matmul_plain(prods)
    got = fd.v7_skinny_matmul(prods[:1]) + fd.v7_skinny_matmul(prods[1:])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_v6_wkv_gn_kernel_matches_plain(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(8)
    B, H, N = 5, 3, 64
    C = H * N

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = torch.nn.functional.silu(rnd(B, C))
    w = torch.exp(-torch.exp(rnd(B, C, scale=0.5)))
    vecs, S = rnd(4, C, scale=0.5), rnd(B, H, N, N)
    active = torch.tensor([True, False, True, True, False], device=dev)
    S_k = S.clone()  # before other launches: S is read before the wait
    want, S_want = fd6.v6_wkv_gn_plain(r, k, v, w, g, vecs, active, S, dtype)
    before = fd6.v6_wkv_gn.launches
    got = fd6.v6_wkv_gn(r, k, v, w, g, vecs, active, S_k, dtype)
    assert fd6.v6_wkv_gn.launches == before + 1
    _close_t(got, want, dtype)
    _close(S_k, S_want)
    assert torch.equal(S_k[1], S[1]) and torch.equal(S_k[4], S[4])


@pytest.mark.parametrize("quant", [None, "int8", "nf4"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_v6_forward_t1_kernels_graph_and_plain_agree(dev, dtype, quant):
    import numpy as np

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import ModelVersion, v6
    from ai00_server_tpu_torch.testing import make_raw_weights, tiny_info

    info = tiny_info(ModelVersion.V6, num_layer=2, num_emb=128, head_size=64,
                     num_vocab=64)
    params = stack_params(info, make_raw_weights(info, 5, np.float32),
                          dtype=dtype, device=dev,
                          quant={0: quant, 1: quant} if quant else None)
    assert fd6.can_fuse(params)
    params[fd6.FUSED_KEY] = fd6.make_fused_layout(params)
    B = 4
    gen = torch.Generator(device=dev).manual_seed(3)
    base = v6.init_state(info, B, device=dev)
    for t in base.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.3)
    steps = [(torch.randint(0, 64, (B,), generator=gen, device=dev),
              torch.tensor(l, device=dev))
             for l in ([1, 1, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1])]
    runs = {}
    for how in ("plain", "eager", "graph"):
        state = {k: t.clone() for k, t in base.items()}
        graph = fd6.DecodeGraph(params, state, B) if how == "graph" else None
        hs = []
        for toks, lens in steps:
            if how == "graph":
                hs.append(graph.replay(toks, lens).clone())
            else:
                fwd = (fd6.forward_t1 if how == "eager"
                       else fd6.forward_t1_plain)
                hs.append(fwd(params, state, toks[:, None], lens)[0][:, 0])
        runs[how] = (hs, state)
        if graph is not None:
            assert sum(graph.launches_per_replay) == 11 * 2
    (h_e, s_e), (h_g, s_g), (h_p, s_p) = (runs[k] for k in
                                          ("eager", "graph", "plain"))
    for a, b in zip(h_e, h_g):  # the graph replays the same kernels
        assert torch.equal(a, b)
    for k in s_e:
        assert torch.equal(s_e[k], s_g[k])
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = float((s_e[k] - s_p[k]).abs().max())
        assert err <= tol * max(1.0, float(s_p[k].abs().max())), (k, err)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(h_e, h_p):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(1.0, float(b.float().abs().max())), err
    state = {k: t.clone() for k, t in base.items()}
    fd6.forward_t1(params, state, steps[0][0][:, None], steps[0][1])
    for k in state:
        assert torch.equal(state[k][:, 2], base[k][:, 2])


def test_v6_kernels_refuse_what_they_do_not_take(dev):
    z = torch.zeros(2, 32, device=dev)
    act = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="head size 64"):
        fd6.v6_wkv_gn(z, z, z, z, z, torch.zeros(6, 32, device=dev), act,
                      torch.zeros(2, 1, 32, 32, device=dev), torch.float32)
    S = torch.zeros(1, 1, 32, 32, device=dev)
    v = torch.zeros(1, 1, 32, device=dev)
    with pytest.raises(ValueError, match="head size 64"):
        wkv56_t1(S, v, v, v, v, torch.zeros(1, 32, device=dev), act[:1])
    x = torch.zeros(2, 64, device=dev, dtype=torch.bfloat16)
    W = torch.zeros(64, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs xa, dx and mix"):
        fd.v7_skinny_matmul([fd.Product(x, W, out="mix")])
    with pytest.raises(ValueError, match="needs gate"):
        fd.v7_skinny_matmul([fd.Product(x, W, out="gadd",
                                        y=torch.zeros(2, 64, device=dev))])
    with pytest.raises(ValueError, match="1 to 5 products"):
        fd.v7_skinny_matmul([fd.Product(x, W)] * 6)


# ---------------------------------------------------------------------------
# RWKV-5 and RWKV-4: v6_wkv_gn's static-decay mode, v4_wkv, wkv4_chunk and
# the two fused stacks
# ---------------------------------------------------------------------------

from ai00_server_tpu_torch.ops import v4_decode as fd4  # noqa: E402
from ai00_server_tpu_torch.ops import v5_decode as fd5  # noqa: E402
from ai00_server_tpu_torch.ops import wkv4  # noqa: E402
from ai00_server_tpu_torch.ops.wkv4 import (  # noqa: E402
    wkv4_chunk, wkv4_chunk_plain)


@pytest.mark.parametrize("dtype", DTYPES)
def test_v6_wkv_gn_static_decay_matches_plain(dev, dtype):
    """``w=None``: every row decays by vecs row 0 (RWKV-5)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    B, H, N = 5, 3, 64
    C = H * N

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = torch.nn.functional.silu(rnd(B, C))
    vecs, S = rnd(4, C, scale=0.5), rnd(B, H, N, N)
    vecs[0] = torch.exp(-torch.exp(vecs[0]))
    active = torch.tensor([True, False, True, True, False], device=dev)
    want, S_want = fd6.v6_wkv_gn_plain(r, k, v, None, g, vecs, active, S,
                                       dtype)
    dense, _ = fd6.v6_wkv_gn_plain(r, k, v, vecs[0].expand(B, C).clone(), g,
                                   vecs, active, S, dtype)
    assert torch.equal(want, dense)  # the mode is the broadcast decay
    S_k = S.clone()
    torch.cuda.synchronize()  # S is read before the kernel waits
    before = fd6.v6_wkv_gn.launches
    got = fd6.v6_wkv_gn(r, k, v, None, g, vecs, active, S_k, dtype)
    assert fd6.v6_wkv_gn.launches == before + 1
    _close_t(got, want, dtype)
    _close(S_k, S_want)
    assert torch.equal(S_k[1], S[1]) and torch.equal(S_k[4], S[4])


def _v4_state(gen, dev, B, C, fresh_rows=()):
    """An advanced-looking (aa, bb, pp); ``fresh_rows`` start at PP_INIT."""
    from ai00_server_tpu_torch.models.v4 import PP_INIT

    aa = torch.randn(B, C, generator=gen, device=dev)
    bb = torch.rand(B, C, generator=gen, device=dev) + 0.5
    pp = torch.randn(B, C, generator=gen, device=dev)
    for b in fresh_rows:
        aa[b], bb[b], pp[b] = 0.0, 0.0, PP_INIT
    return aa, bb, pp


@pytest.mark.parametrize("C", [768, 1000, 1024, 2048])
@pytest.mark.parametrize("B", [1, 5, 8, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_v4_wkv_kernel_matches_plain(dev, dtype, B, C):
    """Four channels a thread (C = 1000: a ragged last block); rows 0 and 1
    fresh at PP_INIT, rows 1 and 4 inactive (their state bit for bit): row
    0 steps from PP_INIT, row 1 keeps it."""
    gen = torch.Generator(device=dev).manual_seed(10 + B)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    r = torch.sigmoid(rnd(B, C))
    k, v = rnd(B, C), rnd(B, C)
    vecs = torch.stack([-torch.exp(rnd(C, scale=0.5)), rnd(C, scale=0.5)])
    active = torch.ones(B, dtype=torch.bool, device=dev)
    idle = [b for b in (1, 4) if b < B]
    active[idle] = False
    state = _v4_state(gen, dev, B, C, fresh_rows=range(min(B, 2)))
    want, *want_state = fd4.v4_wkv_plain(r, k, v, vecs, active, *state,
                                         dtype)
    got_state = [t.clone() for t in state]
    torch.cuda.synchronize()  # the state is read before the kernel waits
    before = fd4.v4_wkv.launches
    got = fd4.v4_wkv(r, k, v, vecs, active, *got_state, dtype)
    assert fd4.v4_wkv.launches == before + 1
    assert got.dtype == dtype
    _close_t(got, want, dtype)
    for g, w, s in zip(got_state, want_state, state):
        fresh = w.abs() >= 1e29  # PP_INIT kept exactly
        assert torch.equal(g[fresh], w[fresh])
        _close(g[~fresh], w[~fresh])
        for b in idle:
            assert torch.equal(g[b], s[b])
        assert bool(torch.isfinite(g).all())


def _wkv4_chunk_inputs(gen, dev, B, T, C, kv_dtype):
    """k, v, a decay from time_decay in [-5, 5) (w down to -148), u, a state
    with rows 0 and B - 1 fresh, and a mask with holes inside the rows (not
    a suffix): the last row idle where B > 1 (its PP_INIT kept exactly)."""
    k = torch.randn(B, T, C, generator=gen, device=dev).to(kv_dtype)
    v = torch.randn(B, T, C, generator=gen, device=dev).to(kv_dtype)
    w = -torch.exp(torch.rand(C, generator=gen, device=dev) * 10 - 5)
    u = torch.randn(C, generator=gen, device=dev) * 0.5
    state = _v4_state(gen, dev, B, C, fresh_rows={0, B - 1})
    mask = torch.rand(B, T, generator=gen, device=dev) > 0.25
    if B > 1:
        mask[-1] = False
    return state, k, v, w, u, mask


def _wkv4_chunk_held(got, want, state, idle, tol=1e-4):
    (aa, bb, pp), y = got
    (aa_p, bb_p, pp_p), y_p = want
    _close(y, y_p, tol)  # masked steps read the kept state in both
    for g, p, s in zip((aa, bb, pp), (aa_p, bb_p, pp_p), state):
        fresh = p.abs() >= 1e29  # PP_INIT kept exactly
        assert torch.equal(g[fresh], p[fresh])
        _close(g[~fresh], p[~fresh], tol)
        if idle:
            assert torch.equal(g[-1], s[-1])  # the idle row keeps its bits
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 16, 23, 255, 256, 257])
@pytest.mark.parametrize("B", [1, 8])
def test_wkv4_chunk_kernel_matches_plain(dev, B, T, kv_dtype):
    """k and v in either activation dtype: the kernel widens them in
    registers, the plain version with ``.float()``.  At the 0.4B width,
    with the plan ``wkv4.plan`` picks."""
    gen = torch.Generator(device=dev).manual_seed(T + B)
    state, k, v, w, u, mask = _wkv4_chunk_inputs(gen, dev, B, T, 1024,
                                                 kv_dtype)
    before = wkv4_chunk.launches
    got = wkv4_chunk(*state, k, v, w, u, mask)
    assert wkv4_chunk.launches == before + 1
    want = wkv4_chunk_plain(*state, k, v, w, u, mask)
    _wkv4_chunk_held(got, want, state, B > 1)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [17, 23, 64, 100, 257, 600])
def test_wkv4_chunk_kernel_every_plan(dev, T, kv_dtype):
    """Every block shape ``wkv4.plan`` gives the chunked kernel (NS = 4, 8,
    16 and 32 runs of 8 steps), against its arithmetic in PyTorch
    (``wkv4_chunk_mirror``) at MIRROR_TOL and the plain version at 1e-4;
    C = 100 leaves ragged blocks, T = 257 and 600 take two and three
    windows."""
    B, C = 3, 100
    gen = torch.Generator(device=dev).manual_seed(T)
    state, k, v, w, u, mask = _wkv4_chunk_inputs(gen, dev, B, T, C, kv_dtype)
    got = wkv4_chunk(*state, k, v, w, u, mask)
    mirror = wkv4.wkv4_chunk_mirror(*state, k, v, w, u, mask, wkv4.RUN_STEPS)
    _wkv4_chunk_held(got, mirror, state, True, MIRROR_TOL)
    _wkv4_chunk_held(got, wkv4_chunk_plain(*state, k, v, w, u, mask), state,
                     True)


def _fused_agree(dev, version, dtype, quant, per_layer):
    """The fused v5 / v4 stack on the card: kernels called eagerly, the
    same replayed from its CUDA graph, and the plain stack, over three steps
    from a random state (an idle row in the first two)."""
    import numpy as np

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import ModelVersion, get_version_module
    from ai00_server_tpu_torch.testing import make_raw_weights, tiny_info

    ver = ModelVersion(version)
    mod = get_version_module(ver)
    f = fd5 if version == "V5" else fd4
    info = tiny_info(ver, num_layer=2, num_emb=128, head_size=64,
                     num_vocab=64)
    params = stack_params(info, make_raw_weights(info, 5, np.float32),
                          dtype=dtype, device=dev,
                          quant={0: quant, 1: quant} if quant else None)
    assert f.can_fuse(params)
    params[f.FUSED_KEY] = f.make_fused_layout(params)
    B = 4
    gen = torch.Generator(device=dev).manual_seed(3)
    base = mod.init_state(info, B, device=dev)
    for name, t in base.items():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.3)
    if version == "V4":
        base["bb"].abs_().add_(0.5)
    steps = [(torch.randint(0, 64, (B,), generator=gen, device=dev),
              torch.tensor(l, device=dev))
             for l in ([1, 1, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1])]
    runs = {}
    for how in ("plain", "eager", "graph"):
        state = {k: t.clone() for k, t in base.items()}
        graph = f.DecodeGraph(params, state, B) if how == "graph" else None
        hs = []
        for toks, lens in steps:
            if how == "graph":
                hs.append(graph.replay(toks, lens).clone())
            else:
                fwd = f.forward_t1 if how == "eager" else f.forward_t1_plain
                hs.append(fwd(params, state, toks[:, None], lens)[0][:, 0])
        runs[how] = (hs, state)
        if graph is not None:
            assert sum(graph.launches_per_replay) == per_layer * 2
    (h_e, s_e), (h_g, s_g), (h_p, s_p) = (runs[k] for k in
                                          ("eager", "graph", "plain"))
    for a, b in zip(h_e, h_g):  # the graph replays the same kernels
        assert torch.equal(a, b)
    for k in s_e:
        assert torch.equal(s_e[k], s_g[k])
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = float((s_e[k] - s_p[k]).abs().max())
        assert err <= tol * max(1.0, float(s_p[k].abs().max())), (k, err)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(h_e, h_p):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(1.0, float(b.float().abs().max())), err
    state = {k: t.clone() for k, t in base.items()}
    f.forward_t1(params, state, steps[0][0][:, None], steps[0][1])
    for k in state:
        assert torch.equal(state[k][:, 2], base[k][:, 2])


@pytest.mark.parametrize("quant", [None, "int8", "nf4"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_v5_forward_t1_kernels_graph_and_plain_agree(dev, dtype, quant):
    _fused_agree(dev, "V5", dtype, quant, per_layer=7)


@pytest.mark.parametrize("quant", [None, "int8", "nf4"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_v4_forward_t1_kernels_graph_and_plain_agree(dev, dtype, quant):
    _fused_agree(dev, "V4", dtype, quant, per_layer=7)


def test_v4_kernels_refuse_what_they_do_not_take(dev):
    z = torch.zeros(2, 32, device=dev)
    act = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="vecs must be contiguous"):
        fd4.v4_wkv(z, z, z, torch.zeros(3, 32, device=dev), act, z.clone(),
                   z.clone(), z.clone(), torch.float32)
    with pytest.raises(ValueError, match="unsupported activation dtype"):
        fd4.v4_wkv(z, z, z, torch.zeros(2, 32, device=dev), act, z.clone(),
                   z.clone(), z.clone(), torch.float16)
    z30 = torch.zeros(2, 30, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        fd4.v4_wkv(z30, z30, z30, torch.zeros(2, 30, device=dev), act,
                   z30.clone(), z30.clone(), z30.clone(), torch.float32)
    off = torch.zeros(2 * 32 + 1, device=dev)[1:].view(2, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fd4.v4_wkv(z, z, z, torch.zeros(2, 32, device=dev), act, off,
                   z.clone(), z.clone(), torch.float32)
    k = torch.zeros(2, 3, 32, device=dev)
    mask = torch.ones(2, 3, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="w must be contiguous"):
        wkv4_chunk(z, z, z, k, k, torch.zeros(16, device=dev),
                   torch.zeros(32, device=dev), mask)
    with pytest.raises(ValueError, match="v must be contiguous"):
        wkv4_chunk(z, z, z, k, k.bfloat16(), torch.zeros(32, device=dev),
                   torch.zeros(32, device=dev), mask)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wkv4_chunk(z, z, z, k.half(), k.half(), torch.zeros(32, device=dev),
                   torch.zeros(32, device=dev), mask)


# ---------------------------------------------------------------------------
# The IVF probe kernel (csrc/ivf.cu)
# ---------------------------------------------------------------------------

from ai00_server_tpu_torch.ops import _build  # noqa: E402
from ai00_server_tpu_torch.ops import retrieval as R  # noqa: E402


def _ivf_operands(dev, dtype, nlist, cap, D, Q, nprobe, seed, pad_cluster):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(nlist, cap, D, generator=gen, device=dev)
    if dtype == torch.int8:
        packed = torch.randint(-127, 128, (nlist, cap, D), generator=gen,
                               device=dev, dtype=torch.int32).to(torch.int8)
        pscale = torch.rand(nlist, cap, generator=gen, device=dev) / 127
    else:
        packed, pscale = x.to(dtype), None
    ids = torch.arange(nlist * cap, device=dev, dtype=torch.int32).reshape(
        nlist, cap)
    ids[:, cap - cap // 3:] = -1                    # ragged fill
    if pad_cluster:
        ids[1] = -1                                 # a cluster of pads
    q = torch.randn(Q, D, generator=gen, device=dev)
    probe = torch.randint(0, nlist, (Q, nprobe), generator=gen, device=dev,
                          dtype=torch.int32)
    probe[0, 0] = 1
    return packed, ids, pscale, q, probe


def _skewed(probe, skew, nlist):
    """probe rewritten to a skew: "shared" - every query probes the same
    clusters (each run as long as Q); "distinct" - every pair its own
    cluster (runs of one; needs nlist >= Q * nprobe); "mixed" the random
    draw with an id off the index (-1 and nlist)."""
    Q, nprobe = probe.shape
    if skew == "shared":
        return probe[:1].expand(Q, nprobe).contiguous()
    if skew == "distinct":
        return torch.arange(Q * nprobe, device=probe.device,
                            dtype=torch.int32).reshape(Q, nprobe) % nlist
    probe = probe.clone()
    probe[1, 0], probe[-1, -1] = -1, nlist
    return probe


@pytest.mark.parametrize("skew", ["mixed", "shared", "distinct"])
@pytest.mark.parametrize("D", [64, 37, 1024, 3072, 40003])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_ivf_score_kernel_matches_plain(dev, dtype, D, skew):
    """Aligned rows (D = 64, 1024, 3072: a pooling="state" vector at
    C = 1024) take the 16-byte copies; D = 37 (and for bf16 and int8
    40003) unaligned rows, element by element; D = 40003 near the limit.
    Cluster 1 is all pads; a third of every cluster is empty slots; cap 70
    is one row tile and a ragged one.  Skews: every query on the same
    clusters (runs of Q = 40 > a pass of 32 queries), every pair on its own
    cluster, and a random draw with ids off the index."""
    Q, nprobe, nlist = (40, 3, 120) if D <= 1024 else (9, 3, 30)
    packed, ids, pscale, q, probe = _ivf_operands(
        dev, dtype, nlist=nlist, cap=70, D=D, Q=Q, nprobe=nprobe, seed=D,
        pad_cluster=True)
    probe = _skewed(probe, skew, nlist)
    before = R.ivf_score.launches
    s_k, i_k = R.ivf_score(packed, ids, pscale, q, probe)
    assert R.ivf_score.launches == before + 1
    s_p, i_p = R.ivf_score_plain(packed, ids, pscale, q, probe)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    fin = torch.isfinite(s_p)
    assert torch.equal(torch.isfinite(s_k), fin)
    if skew == "mixed":
        assert not fin[0, 0].any()  # the pad cluster
        assert not fin[1, 0].any() and not fin[-1, -1].any()
    _close(s_k[fin], s_p[fin])


@pytest.mark.parametrize("Q,nprobe,nlist", [(64, 8, 1024), (64, 16, 40),
                                            (300, 8, 500), (1, 1, 3)])
def test_ivf_group_kernel_equals_plain(dev, Q, nprobe, nlist):
    """The grouping kernel's runs and sorted pairs equal
    ``ivf_group_plain``'s, one group (1024 pairs), and more (300 x 8), ids
    off the index among them."""
    gen = torch.Generator(device=dev).manual_seed(Q + nprobe)
    probe = torch.randint(-1, nlist + 1, (Q, nprobe), generator=gen,
                          device=dev, dtype=torch.int32)
    runs, order = R.ivf_group(probe, nlist)
    runs_p, order_p = R.ivf_group_plain(probe.cpu(), nlist)
    assert torch.equal(runs.cpu(), runs_p) and torch.equal(order.cpu(),
                                                           order_p)


def test_ivf_score_graph_replay_equals_eager(dev):
    """ivf_score captured in a CUDA graph (a synchronisation in the wrapper
    would fail the capture) gives the eager call's bits on every replay."""
    packed, ids, pscale, q, probe = _ivf_operands(
        dev, torch.int8, nlist=60, cap=130, D=256, Q=32, nprobe=4, seed=9,
        pad_cluster=True)
    probe[:8] = probe[8:16]  # shared clusters
    s_e, i_e = R.ivf_score(packed, ids, pscale, q, probe)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        R.ivf_score(packed, ids, pscale, q, probe)  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s_g, i_g = R.ivf_score(packed, ids, pscale, q, probe)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(s_g, s_e) and torch.equal(i_g, i_e)


def test_ivf_search_launches_the_kernel_for_any_shape(dev):
    """cap and D off the TPU's 128 tiling still take the kernel."""
    gen = torch.Generator(device=dev).manual_seed(5)
    packed, ids, pscale, q, _ = _ivf_operands(
        dev, torch.int8, nlist=7, cap=13, D=50, Q=4, nprobe=2, seed=5,
        pad_cluster=False)
    cent = torch.randn(7, 50, generator=gen, device=dev)
    before = R.ivf_score.launches
    s, i = R.ivf_search(cent, packed, ids, q, k=30, nprobe=2, pscale=pscale)
    assert R.ivf_score.launches == before + 1
    s_c, i_c = R.ivf_search(cent.cpu(), packed.cpu(), ids.cpu(), q.cpu(),
                            k=30, nprobe=2, pscale=pscale.cpu())
    assert s.shape == (4, 30)
    assert torch.equal(torch.isfinite(s).cpu(), torch.isfinite(s_c))
    assert torch.equal((i == -1).cpu(), i_c == -1)


def test_ivf_score_refuses_what_it_does_not_take(dev):
    ids = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    probe = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    big = _build.library("ivf").ivf_max_d() + 1
    with pytest.raises(ValueError, match="D <="):
        R.ivf_score(torch.zeros(2, 3, big, device=dev), ids, None,
                    torch.zeros(1, big, device=dev), probe)
    with pytest.raises(ValueError, match="int8, bfloat16 or float32"):
        R.ivf_score(torch.zeros(2, 3, 8, device=dev).half(), ids, None,
                    torch.zeros(1, 8, device=dev), probe)
    with pytest.raises(ValueError, match="q must be contiguous"):
        R.ivf_score(torch.zeros(2, 3, 8, device=dev), ids, None,
                    torch.zeros(1, 8, device=dev).bfloat16(), probe)
    with pytest.raises(ValueError, match="pscale must be contiguous"):
        R.ivf_score(torch.zeros(2, 3, 8, device=dev, dtype=torch.int8), ids,
                    torch.zeros(3, 2, device=dev).t(),
                    torch.zeros(1, 8, device=dev), probe)
    with pytest.raises(ValueError, match="packed_ids must be contiguous"):
        R.ivf_score(torch.zeros(2, 3, 8, device=dev), ids.long(), None,
                    torch.zeros(1, 8, device=dev), probe)


# ---------------------------------------------------------------------------
# The [embed] sidecar on the server's device (server/embed.py)
# ---------------------------------------------------------------------------

from ai00_server_tpu_torch.server import embed as embed_mod  # noqa: E402


class _CharTokenizer:
    """A stand-in tokenizer: one id a character, padded, as CPU tensors
    (what a HuggingFace tokenizer returns)."""

    def __call__(self, texts, **_):
        n = max(len(t) for t in texts)
        ids = torch.tensor([[ord(c) % 64 for c in t] + [0] * (n - len(t))
                            for t in texts])
        mask = torch.tensor([[1] * len(t) + [0] * (n - len(t))
                             for t in texts])
        return {"input_ids": ids, "attention_mask": mask}


class _Encoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(64, 24)
        self.proj = torch.nn.Linear(24, 24)

    def forward(self, input_ids, attention_mask):
        from types import SimpleNamespace

        assert input_ids.device == self.emb.weight.device
        return SimpleNamespace(
            last_hidden_state=torch.tanh(self.proj(self.emb(input_ids))))


def test_text_embedder_runs_on_the_card(dev):
    """The encoder and the tokenizer's tensors go to the server's device;
    the vectors equal the same encoder's on the CPU."""
    torch.manual_seed(0)
    enc, texts = _Encoder(), ["hello world", "ab"]
    want = embed_mod.TextEmbedder(enc, _CharTokenizer(), "x",
                                  device="cpu").embed(texts)
    emb = embed_mod.TextEmbedder(enc, _CharTokenizer(), "x", device=dev)
    assert {p.device.type for p in emb.model.parameters()} == {"cuda"}
    got = emb.embed(texts)
    assert got.shape == (2, 24)
    _close(torch.as_tensor(got), torch.as_tensor(want))


def test_embed_sidecar_bert_on_the_card(dev, tmp_path):
    """A tiny random BertModel through load_embedder onto the card, against
    the same checkpoint on the CPU."""
    tf = pytest.importorskip("transformers")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        list("abcdefghijklmnopqrstuvwxyz") + ["hello", "world"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    torch.manual_seed(1)
    tf.BertModel(tf.BertConfig(
        vocab_size=len(vocab), hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=64)).save_pretrained(str(tmp_path))
    tf.BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(
        str(tmp_path))
    import asyncio

    cfg = {"model": str(tmp_path)}
    emb = asyncio.run(embed_mod.load_embedder(cfg, device=dev))
    cpu = asyncio.run(embed_mod.load_embedder(cfg, device="cpu"))
    assert {p.device.type for p in emb.model.parameters()} == {"cuda"}
    texts = ["hello world", "abc z"]
    _close(torch.as_tensor(emb.embed(texts)),
           torch.as_tensor(cpu.embed(texts)))


# ---------------------------------------------------------------------------
# phased_matmul (csrc/phased.cu): the wide-batch products
# ---------------------------------------------------------------------------

from ai00_server_tpu_torch.ops import phased_matmul as pm  # noqa: E402

PHASED_GROUPS = {
    **{k: GROUPS[k] for k in ("rkv", "lora_down", "lora_up", "wo", "fkey",
                              "fval")},
    # N below one 256-column tile of the bf16 kernel, one of them ragged.
    "narrow": [(1024, 32, "tanh", False, False, "cd"),
               (1024, 96, "none", True, True, "f32"),
               (512, 320, "sigmoid", False, False, "cd")],
    # v5's channel-mix key and receptance: one launch, two widths.
    "v5_ffn": [(1024, 3584, "relu2", False, False, "cd"),
               (1024, 1024, "sigmoid", False, False, "f32")],
}


def _coded(prods, mode):
    """``prods`` with their weights as ``mode`` codes and scales."""
    if mode == "none":
        return prods
    return [fd.Product(**{**p.__dict__, "mode": mode,
                          "W": q.q, "scale": q.scale})
            for p, q in ((p, quant.QUANTIZERS[mode](p.W.float()))
                         for p in prods)]


@pytest.mark.parametrize("mode,group", [
    (mode, group) for group in sorted(PHASED_GROUPS)
    for mode in ("none", "int8", "int4")
    # codes take K in whole scale blocks
    if mode == "none" or all(K % 128 == 0 for K, *_ in PHASED_GROUPS[group])])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [9, 16, 64, 100, 128])
def test_phased_matmul_kernel_matches_plain(dev, mode, group, dtype, B):
    """One launch per 64 rows; equal inputs give equal bits."""
    shapes = PHASED_GROUPS[group]
    gen = torch.Generator(device=dev).manual_seed(B)
    prods = _coded(_products(gen, dev, dtype, B, shapes), mode)
    want = pm.phased_matmul_plain(prods)
    again = [fd.Product(**{**p.__dict__, "y": None if p.y is None
                           else p.y.clone()}) for p in prods]
    before = pm.phased_matmul.launches
    got = pm.phased_matmul(prods)
    assert pm.phased_matmul.launches == before + -(-B // pm.ROWS)
    for g, w, p in zip(got, want, prods):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close_t(g, w, dtype, rounded=p.out == "cd" or p.round_cd)
    for g, g2 in zip(got, pm.phased_matmul(again)):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("B", [9, 64, 128])
def test_phased_matmul_graph_replay_equals_eager(dev, mode, B):
    """Two eager launches and a CUDA graph's replay give equal bits."""
    gen = torch.Generator(device=dev).manual_seed(B + 1)
    prods = _coded(_products(gen, dev, torch.bfloat16, B,
                             PHASED_GROUPS["v5_ffn"]), mode)
    eager = pm.phased_matmul(prods)
    for a, b in zip(eager, pm.phased_matmul(prods)):
        assert torch.equal(a, b)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        pm.phased_matmul(prods)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = pm.phased_matmul(prods)
    graph.replay()
    torch.cuda.synchronize()
    for o, e in zip(outs, eager):
        assert torch.equal(o, e)


def test_phased_matmul_kernel_refuses_what_it_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    (p,) = _products(gen, dev, torch.bfloat16, 16,
                     [(1024, 1024, "none", False, False, "cd")])
    q = quant.QUANTIZERS["nf4"](p.W.float())
    with pytest.raises(ValueError, match="weight mode"):
        pm.phased_matmul([fd.Product(p.x, q.q, scale=q.scale, mode="nf4")])
    (odd,) = _products(gen, dev, torch.bfloat16, 16,
                       [(1024, 40, "none", False, False, "cd")])
    with pytest.raises(ValueError, match="multiple of 16"):
        pm.phased_matmul([odd])


# ---------------------------------------------------------------------------
# The decode WKV stages, v7_wkv_gn and v6_wkv_gn, at the batches the stacks
# serve
# ---------------------------------------------------------------------------
#
# Against their arithmetic in PyTorch (v7_wkv_gn_mirror, v6_wkv_gn_mirror)
# at MIRROR_TOL on f32 results and one bf16 ulp on bf16 ones, and against
# the plain versions as above.  The kernels read S before they wait for the
# launch before them, so each test lets launches without PDL (the plain
# version's PyTorch ops) or a synchronisation come between filling S and
# the kernel.

WKV_GN_KINDS = ["v7", "v7 first", "v6", "v6 f32 gate", "v5"]
WKV_GN_BS = [1, 5, 8, 16, 64]


def _wkv_gn_io(kind, B, H, dtype, dev, seed):
    """(S, kernel(S_, vf_) -> out, plain() -> (out, S, vf), mirror() ->
    (out, S, vf), v_first or None, active) for one case; v_first is None
    for v5/v6."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    C = H * 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    S = rnd(B, H, 64, 64)
    active = torch.arange(B, device=dev) % 3 != 1
    if kind.startswith("v7"):
        r, k, v, g, vf = (rnd(B, C, scale=0.5) for _ in range(5))
        w = torch.exp(-fd.W_SCALE * torch.sigmoid(rnd(B, C)))
        a, vmix = torch.sigmoid(rnd(B, C)), torch.sigmoid(rnd(B, C))
        vecs = rnd(8, C, scale=0.5)
        first = kind == "v7 first"
        args = (r, k, v, w, a, g, vmix)
        return (S,
                lambda S_, vf_: fd.v7_wkv_gn(*args, vf_, vecs, active, S_,
                                             first, dtype),
                lambda: fd.v7_wkv_gn_plain(*args, vf, vecs, active, S, first,
                                           dtype),
                lambda: fd.v7_wkv_gn_mirror(*args, vf, vecs, active, S,
                                            first, dtype),
                vf, active)
    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = torch.nn.functional.silu(rnd(B, C))
    vecs = rnd(4, C, scale=0.5)
    if kind == "v5":
        vecs[0] = torch.exp(-torch.exp(vecs[0]))
        w = None
    else:
        w = torch.exp(-torch.exp(rnd(B, C, scale=0.5)))
    rnd_yf = kind != "v6 f32 gate"
    args = (r, k, v, w, g, vecs, active)
    return (S,
            lambda S_, vf_: fd6.v6_wkv_gn(*args, S_, dtype, rnd_yf),
            lambda: (*fd6.v6_wkv_gn_plain(*args, S, dtype, rnd_yf), None),
            lambda: (*fd6.v6_wkv_gn_mirror(*args, S, dtype, rnd_yf), None),
            None, active)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", WKV_GN_BS)
@pytest.mark.parametrize("kind", WKV_GN_KINDS)
def test_wkv_gn_kernels_match_mirror_and_plain(dev, kind, B, dtype):
    S, kernel, plain, mirror, vf, active = _wkv_gn_io(kind, B, 5, dtype,
                                                      dev, 100 * B)
    S_k = S.clone()
    vf_k = None if vf is None else vf.clone()
    want, S_want, vf_want = plain()
    got_m, S_m, vf_m = mirror()
    launcher = fd.v7_wkv_gn if vf is not None else fd6.v6_wkv_gn
    before = launcher.launches
    got = kernel(S_k, vf_k)
    assert launcher.launches == before + 1
    _close(S_k, S_m, MIRROR_TOL)
    if dtype == torch.bfloat16:
        _close_t(got, got_m, dtype)
    else:
        _close(got, got_m, MIRROR_TOL)
    _close(S_k, S_want)
    _close_t(got, want, dtype)
    idle = ~active
    assert torch.equal(S_k[idle], S[idle])  # an inactive row bit for bit
    if vf is not None:
        assert torch.equal(vf_k, vf_want) and torch.equal(vf_m, vf_want)


@pytest.mark.parametrize("B", [5, 64])
@pytest.mark.parametrize("kind", WKV_GN_KINDS)
def test_wkv_gn_kernels_same_bits(dev, kind, B):
    """A repeat and a CUDA graph's replay give equal bits: each sum has one
    order."""
    S, kernel, _, _, vf, _ = _wkv_gn_io(kind, B, 5, torch.bfloat16, dev, B)
    runs = []
    for _ in range(2):
        S_k = S.clone()
        vf_k = None if vf is None else vf.clone()
        torch.cuda.synchronize()
        runs.append((kernel(S_k, vf_k), S_k, vf_k))
    S_g = S.clone()
    vf_g = None if vf is None else vf.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        kernel(S.clone(), None if vf is None else vf.clone())
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = kernel(S_g, vf_g)
    S_g.copy_(S)
    if vf is not None:
        vf_g.copy_(vf)
    torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    runs.append((out_g, S_g, vf_g))
    for out, S_k, vf_k in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert torch.equal(S_k, runs[0][1])
        if vf is not None:
            assert torch.equal(vf_k, runs[0][2])


def test_wkv_gn_kernels_refuse_what_they_do_not_take(dev):
    """Operands the kernels read with 16-byte loads must be 16-byte
    aligned: the state and vecs in both modes."""
    B, H = 2, 2
    C = H * 64
    S, _, _, _, _, _ = _wkv_gn_io("v6", B, H, torch.float32, dev, 0)
    z = torch.zeros(B, C, device=dev)
    act = torch.ones(B, dtype=torch.bool, device=dev)
    vecs4 = torch.zeros(4, C, device=dev)
    vecs8 = torch.zeros(8, C, device=dev)
    odd4 = torch.zeros(4 * C + 1, device=dev)[1:].view(4, C)
    odd8 = torch.zeros(8 * C + 1, device=dev)[1:].view(8, C)
    odd_S = torch.zeros(S.numel() + 1, device=dev)[1:].view(S.shape)
    for w in (None, z):  # static decay, dense decay
        with pytest.raises(ValueError, match="16-byte aligned"):
            fd6.v6_wkv_gn(z, z, z, w, z, odd4, act, S.clone(), torch.float32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fd6.v6_wkv_gn(z, z, z, w, z, vecs4, act, odd_S, torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fd.v7_wkv_gn(z, z, z, z, z, z, z, z.clone(), odd8, act, S.clone(),
                     False, torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fd.v7_wkv_gn(z, z, z, z, z, z, z, z.clone(), vecs8, act, odd_S,
                     False, torch.float32)
