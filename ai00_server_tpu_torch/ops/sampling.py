"""Batched samplers on the device: nucleus / typical / mirostat / greedy.

Port of ``ai00_server_tpu/ops/sampling.py``.  The uniforms come in from
outside (:func:`sample_with_rand`), so for given uniforms the sampled
tokens equal the JAX package's exactly; the engine draws them from a
``torch.Generator`` on the device.

* nucleus: probs sorted desc, top-k cut, keep while the cumulative sum
  *before* an element is <= top_p, temperature as ``p ** (1/T)``
  renormalised, CDF-inverse draw with find-or-first.
* typical: rank by |ln(1/p) - entropy| ascending, then the same machinery
  with tau.
* mirostat: keep tokens with surprise <= max_surprise plus the first
  crossing element, draw proportional to p, then adapt max_surprise.
* penalties: presence/frequency with per-step decay, kept densely as a
  ``(B, V)`` penalty vector plus a "seen" mask.

The ranked top-k width is ``k_cap`` (powers of two up to ``TOP_K_CAP``,
the fast path) or the full vocabulary when a row asks for ``top_k`` beyond
the cap or 0 (unbounded).  Ranking keeps the lower index first among
equal values, as ``lax.top_k`` does.
"""

from __future__ import annotations

import numpy as np
import torch

KIND_NUCLEUS = 0
KIND_TYPICAL = 1
KIND_MIROSTAT = 2
KIND_GREEDY = 3

TOP_K_CAP = 1024

DEFAULTS = dict(
    top_p=0.5,
    tau=0.5,
    top_k=128,
    temperature=1.0,
    presence_penalty=0.3,
    frequency_penalty=0.3,
    penalty_decay=0.99654026,
    miro_tau=3.0,
    miro_rate=0.1,
)

TINY = 1e-38


def make_params(batch: int) -> dict:
    """Default per-row sampler params (host-side numpy, set by the
    scheduler as requests come and go, uploaded when they change)."""
    d = DEFAULTS
    return {
        "kind": np.full(batch, KIND_NUCLEUS, np.int32),
        "top_p": np.full(batch, d["top_p"], np.float32),
        "top_k": np.full(batch, d["top_k"], np.int32),
        "temperature": np.full(batch, d["temperature"], np.float32),
        "presence": np.full(batch, d["presence_penalty"], np.float32),
        "frequency": np.full(batch, d["frequency_penalty"], np.float32),
        "decay": np.full(batch, d["penalty_decay"], np.float32),
        "miro_tau": np.full(batch, d["miro_tau"], np.float32),
        "miro_rate": np.full(batch, d["miro_rate"], np.float32),
    }


def init_sampler_state(batch: int, vocab: int, device="cpu") -> dict:
    """Fresh sampler state on ``device``."""
    return {
        "penalties": torch.zeros((batch, vocab), dtype=torch.float32,
                                 device=device),
        "seen": torch.zeros((batch, vocab), dtype=torch.bool, device=device),
        "max_surprise": torch.full((batch,), 2.0 * DEFAULTS["miro_tau"],
                                   dtype=torch.float32, device=device),
    }


def init_penalties_host(prompt_tokens, vocab: int, presence: float,
                        frequency: float, decay: float):
    """Host-side penalty init from prompt tokens: reversed iteration,
    ``penalty = prev_or_presence + frequency * decay**index``.
    Returns (penalties (V,), seen (V,))."""
    pen = np.zeros(vocab, np.float32)
    seen = np.zeros(vocab, np.bool_)
    for index, token in enumerate(reversed(prompt_tokens)):
        prev = pen[token] if seen[token] else presence
        pen[token] = prev + frequency * (decay ** index)
        seen[token] = True
    return pen, seen


def transform_logits(logits, state, bias=None, allowed_mask=None):
    """Penalties, then the allowed mask, then logit bias.

    logits: (B, V); bias: (B, V) or None; allowed_mask: (B, V) bool or None
    (True = token allowed).
    """
    x = logits.float() - state["penalties"]
    if allowed_mask is not None:
        x = torch.where(allowed_mask, x, float("-inf"))
    if bias is not None:
        x = x + bias
    return x


def _rank(x, K: int):
    """(values, indices) of the K largest along the last axis, descending;
    equal values keep the lower index first."""
    if K < x.shape[-1]:
        # topk's order among equal values is unspecified: rank its picks
        # again with a stable sort on (value desc, index asc).
        vals, idx = torch.topk(x, K, dim=-1, sorted=True)
        order = torch.argsort(idx, dim=-1)
        vals, idx = torch.gather(vals, -1, order), torch.gather(idx, -1, order)
        srt = torch.sort(vals, dim=-1, descending=True, stable=True)
        return srt.values, torch.gather(idx, -1, srt.indices)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals, idx


def _first_true(m):
    """Index of the first True along the last axis, 0 when none is."""
    return torch.argmax(m.to(torch.uint8), dim=-1)


def _topk_cut_sample(probs_sorted, rand, cut_param, top_k, temperature):
    """Shared nucleus/typical machinery on ranked (B, K) probs.
    ``top_k <= 0`` means unbounded (no positional cut)."""
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    pos = torch.arange(probs_sorted.shape[-1], device=probs_sorted.device)
    keep = (cum_before <= cut_param[:, None]) & (
        (top_k[:, None] <= 0) | (pos[None, :] < top_k[:, None]))
    t = torch.clamp(temperature, min=1e-4)
    w = torch.where(keep, torch.pow(torch.clamp(probs_sorted, min=TINY),
                                    (1.0 / t)[:, None]), 0.0)
    total = torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(w, dim=-1) / torch.clamp(total, min=TINY)
    return _first_true(rand[:, None] <= cdf)


def _typical(probs, rand, p, K: int):
    logp = torch.log(torch.clamp(probs, min=TINY))
    entropy = -torch.sum(torch.where(probs > 0, probs * logp, 0.0), dim=-1,
                         keepdim=True)
    score = -torch.abs(-logp - entropy)
    score = torch.where(probs > 0, score, float("-inf"))
    _, idx = _rank(score, K)
    vals = torch.gather(probs, -1, idx)
    sel = _topk_cut_sample(vals, rand, p["top_p"], p["top_k"],
                           p["temperature"])
    return torch.gather(idx, -1, sel[:, None])[:, 0]


def _mirostat(probs, rand, max_surprise):
    """Threshold form: keep ``p >= 2**-max_surprise`` plus the single
    largest p below the threshold; sample within the kept set."""
    thresh = torch.exp2(-max_surprise)[:, None]
    above = probs >= thresh
    below = torch.where(above, float("-inf"), probs)
    crossing = torch.argmax(below, dim=-1)
    any_below = torch.any(~above, dim=-1)
    rows = torch.arange(probs.shape[0], device=probs.device)
    keep = above.clone()
    keep[rows, crossing] = above[rows, crossing] | any_below

    w = torch.where(keep, probs, 0.0)
    total = torch.sum(w, dim=-1)
    cdf = torch.cumsum(w, dim=-1)
    hit = (rand * total)[:, None] <= cdf
    hk = hit & keep
    token = torch.where(torch.any(hk, dim=-1), _first_true(hk),
                        torch.argmax(w, dim=-1))
    token_prob = torch.clamp(probs[rows, token], min=TINY)
    surprise = (torch.log2(torch.clamp(total, min=TINY))
                - torch.log2(token_prob))
    return token, surprise


def sample_with_rand(rand, logits, params, state, bias=None,
                     allowed_mask=None, kinds=None, k_cap=None):
    """One batched sampling step given uniform draws ``rand`` (B,) in
    [0, 1).  ``params``: per-row tensors on the logits' device (keys of
    :func:`make_params`).  ``kinds``: the sampler kinds present (only those
    branches run).  ``k_cap``: ranked top-k width (default TOP_K_CAP).

    Returns (tokens (B,) int32, prob of each sampled token (B,), new_state).
    """
    B, V = logits.shape
    if kinds is None:
        kinds = (KIND_NUCLEUS, KIND_TYPICAL, KIND_MIROSTAT, KIND_GREEDY)
    kinds = tuple(sorted(set(int(k) for k in kinds)))
    K = min(int(k_cap or TOP_K_CAP), V)
    rand = rand.float()

    x = transform_logits(logits, state, bias, allowed_mask)
    lse = torch.logsumexp(x, dim=-1)
    kind = params["kind"]
    ms = state["max_surprise"]

    need_full = (KIND_TYPICAL in kinds) or (KIND_MIROSTAT in kinds)
    probs_full = torch.exp(x - lse[:, None]) if need_full else None

    tokens = torch.zeros(B, dtype=torch.int64, device=logits.device)
    new_ms = ms

    if KIND_NUCLEUS in kinds:
        vals, idx = _rank(x, K)
        pk = torch.exp(vals - lse[:, None])
        sel = _topk_cut_sample(pk, rand, params["top_p"], params["top_k"],
                               params["temperature"])
        nuc = torch.gather(idx, -1, sel[:, None])[:, 0]
        tokens = torch.where(kind == KIND_NUCLEUS, nuc, tokens)

    if KIND_TYPICAL in kinds:
        typ = _typical(probs_full, rand, params, K)
        tokens = torch.where(kind == KIND_TYPICAL, typ, tokens)

    if KIND_MIROSTAT in kinds:
        mir, surprise = _mirostat(probs_full, rand, ms)
        tokens = torch.where(kind == KIND_MIROSTAT, mir, tokens)
        err = surprise - params["miro_tau"]
        upd = torch.minimum(ms - params["miro_rate"] * err,
                            4.0 * params["miro_tau"])
        new_ms = torch.where(kind == KIND_MIROSTAT, upd, new_ms)

    if KIND_GREEDY in kinds:
        greedy = torch.argmax(x, dim=-1)
        tokens = torch.where(kind == KIND_GREEDY, greedy, tokens)

    rows = torch.arange(B, device=logits.device)
    sp = torch.exp(x[rows, tokens] - lse)

    # Penalty update: decay all, then bump the sampled token:
    # seen ? decayed + frequency : presence.
    pen = state["penalties"] * params["decay"][:, None]
    tok_seen = state["seen"][rows, tokens]
    new_val = torch.where(tok_seen, pen[rows, tokens] + params["frequency"],
                          params["presence"])
    pen[rows, tokens] = new_val
    seen = state["seen"].clone()
    seen[rows, tokens] = True

    new_state = {"penalties": pen, "seen": seen, "max_surprise": new_ms}
    return tokens.to(torch.int32), sp, new_state


def kinds_key(kind_array) -> tuple:
    """The sampler kinds present in a host batch."""
    return tuple(sorted({int(k) for k in kind_array}))


def k_cap_key(top_k_array, vocab: int | None = None) -> int:
    """Ranked top-k width: powers of two from 128 to TOP_K_CAP for the fast
    path; the FULL VOCAB when any row asks for top_k beyond the cap or 0
    (= unbounded)."""
    ks = [int(k) for k in top_k_array]
    if vocab and any(k <= 0 or k > TOP_K_CAP for k in ks):
        return vocab
    need = int(max(1, min(TOP_K_CAP, max(ks))))
    cap = 128
    while cap < need:
        cap *= 2
    return min(cap, TOP_K_CAP)
