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

from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk, wkv7_chunk_plain
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


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


def test_wkv7_t1_kernel_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    S, seqs = _inputs(gen, dev, 5, 1, 3)
    vecs = [x[:, 0].contiguous() for x in seqs]
    mask = torch.tensor([True, False, True, True, False], device=dev)
    before = wkv7_t1.launches
    S_k, y_k = wkv7_t1(S, *vecs, mask)
    S_p, y_p = wkv7_t1_plain(S, *vecs, mask)
    assert wkv7_t1.launches == before + 1
    _close(S_k, S_p)
    _close(y_k, y_p)
    assert torch.equal(S_k[1], S[1]) and torch.equal(S_k[4], S[4])


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


def test_kernel_refuses_other_head_sizes(dev):
    S = torch.zeros(1, 1, 32, 32, device=dev)
    v = torch.zeros(1, 1, 32, device=dev)
    with pytest.raises(ValueError, match="head size 64"):
        wkv7_t1(S, v, v, v, v, v, v, torch.ones(1, dtype=torch.bool,
                                                device=dev))
