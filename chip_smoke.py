#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``ai00_server_tpu_torch`` (never ``jax`` or ``ai00_server_tpu``) on
the card, in four phases, and exits non-zero at the first failure:

1. Card and build: the card's name and power limit, then ``nvcc`` builds
   every kernel of the port from ``ai00_server_tpu_torch/csrc/``.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with times from CUDA events and the
   least time the card could take (the larger of bytes over 3.35 TB/s and
   f32 operations over 67 TFLOP/s, from this run's inputs).
3. Model parity: the full-width RWKV-7 0.4B shape at 2 layers in f32 on
   the card (kernels) against the same weights on the CPU (plain
   versions), after a ragged prefill and T=1 steps.
4. Serving: the 0.4B shape at all 24 layers in bf16 from a seed, with a
   synthetic 65,536-entry vocabulary, behind the port's HTTP server on
   localhost: concurrent greedy completions and a streamed chat.  The
   kernels' launch counters are zeroed just before and read just after.

The last two lines of standard output are the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# RWKV-7 World 0.4B (the published config): L=24, C=1024, head 64,
# FFN 4096, vocab 65536, LoRA ranks w 64, a 64, v 32, g 128.
L_FULL, C, HEAD, FFN, VOCAB = 24, 1024, 64, 4096, 65536
LORA = {"w": 64, "a": 64, "v": 32, "g": 128}
MAX_BATCH, CHUNK = 8, 256
SEED = 20261016

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
KERNEL_TOL = 1e-4           # max |kernel - plain| / max(1, max |plain|)
MODEL_TOL = 1e-3            # max |card - cpu| / max |cpu|, f32, 2 layers


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int) -> float:
    """Per-call time of back-to-back calls from Python (host + device)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so no host time
    enters the reading."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that error relative to max(1, max |want|))."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def wkv_inputs(gen, B, T, H, N, dev):
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, T, H, N, scale=0.3) for _ in range(3))
    w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, T, H, N)))
    kk = rnd(B, T, H, N)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    a = torch.sigmoid(rnd(B, T, H, N))
    return S, (r, w, k, v, kk, a)


def phase_kernels(dev) -> dict:
    import torch

    from ai00_server_tpu_torch.ops.wkv_chunk import (wkv7_chunk,
                                                     wkv7_chunk_plain)
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1, wkv7_t1_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, H, N = MAX_BATCH, C // HEAD, HEAD
    rows = {}

    # wkv7_t1 at the decode shape, row 5 inactive.
    S, seqs = wkv_inputs(gen, B, 1, H, N, dev)
    vecs = [x[:, 0].contiguous() for x in seqs]
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    mask[5] = False
    S_k, y_k = wkv7_t1(S, *vecs, mask)
    S_p, y_p = wkv7_t1_plain(S, *vecs, mask)
    torch.cuda.synchronize()
    err_s, rel_s = rel_err(S_k, S_p)
    err_y, rel_y = rel_err(y_k, y_p)
    check(rel_s <= KERNEL_TOL and rel_y <= KERNEL_TOL,
          f"wkv7_t1 disagrees with its plain version: {rel_s} {rel_y}")
    check(torch.equal(S_k[5], S[5]), "wkv7_t1 changed an inactive row")
    elems = B * H * N * N
    nbytes = 2 * elems * 4 + 7 * B * H * N * 4 + B
    flops = 9 * B * H * N * N  # S.kk 2, update 5, S'.r 2 per element
    b_ms, b_by = bound(nbytes, flops)
    rows["wkv7_t1"] = {
        "name": "wkv7_t1", "route": "cuda",
        "source": "ai00_server_tpu_torch/csrc/wkv7.cu",
        "replaces": "ai00_server_tpu/ops/wkv_t1.py:108",
        "max_abs_err": max(err_s, err_y),
        "ms": device_ms(lambda: wkv7_t1(S, *vecs, mask), 100),
        "plain_ms": device_ms(lambda: wkv7_t1_plain(S, *vecs, mask), 20),
        "call_ms": call_ms(lambda: wkv7_t1(S, *vecs, mask), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"wkv7_t1 B={B} H={H} N={N}: max_abs_err state {err_s:.3e} "
          f"y {err_y:.3e} (tolerance {KERNEL_TOL} x max(1, |plain|)); "
          "inactive row bit-identical", flush=True)

    # wkv7_chunk at the prefill shape (T = token_chunk_size), and ragged.
    worst = 0.0
    for T, lengths in ((CHUNK, [CHUNK] * B),
                       (23, [23, 17, 1, 0, 23, 5, 12, 23])):
        S, seqs = wkv_inputs(gen, B, T, H, N, dev)
        lens = torch.tensor(lengths, device=dev)
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
        S_k, y_k = wkv7_chunk(S, *seqs, mask)
        S_p, y_p = wkv7_chunk_plain(S, *seqs, mask)
        torch.cuda.synchronize()
        err_s, rel_s = rel_err(S_k, S_p)
        err_y, rel_y = rel_err(y_k[mask], y_p[mask])
        check(rel_s <= KERNEL_TOL and rel_y <= KERNEL_TOL,
              f"wkv7_chunk T={T} disagrees with its plain version: "
              f"{rel_s} {rel_y}")
        if lengths[3] == 0:
            check(torch.equal(S_k[3], S[3]), "wkv7_chunk changed an idle row")
        worst = max(worst, err_s, err_y)
        print(f"wkv7_chunk B={B} T={T} H={H} N={N}: max_abs_err state "
              f"{err_s:.3e} y(valid) {err_y:.3e} (tolerance {KERNEL_TOL} x "
              "max(1, |plain|))", flush=True)
        if T == CHUNK:
            n_valid = int(mask.sum())
            n_masked = B * T - n_valid
            nbytes = (2 * B * H * N * N * 4 + 7 * B * T * H * N * 4
                      + B * T)
            flops = H * N * N * (9 * n_valid + 2 * n_masked)
            b_ms, b_by = bound(nbytes, flops)
            args = (S, *seqs, mask)
            rows["wkv7_chunk"] = {
                "name": "wkv7_chunk", "route": "cuda",
                "source": "ai00_server_tpu_torch/csrc/wkv7.cu",
                "replaces": "ai00_server_tpu/ops/wkv_pallas.py:174",
                "ms": device_ms(lambda: wkv7_chunk(*args), 20),
                "plain_ms": device_ms(lambda: wkv7_chunk_plain(*args), 1,
                                      replays=3),
                "call_ms": call_ms(lambda: wkv7_chunk(*args), 50),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
    rows["wkv7_chunk"]["max_abs_err"] = worst
    for r in rows.values():
        print(f"{r['name']}: {r['ms']:.5f} ms on the device (plain "
              f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}); {r['call_ms']:.5f} ms per call from "
              "Python", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: model parity, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------


def model_info(num_layer: int):
    from ai00_server_tpu_torch.testing import tiny_info

    return tiny_info(num_layer=num_layer, num_emb=C, head_size=HEAD,
                     num_vocab=VOCAB, hidden_mult=FFN // C)


def phase_parity(dev) -> None:
    import numpy as np
    import torch

    from ai00_server_tpu_torch.engine import head_logits
    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import v7
    from ai00_server_tpu_torch.models.common import take_last_valid
    from ai00_server_tpu_torch.testing import make_raw_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = model_info(2)
    math = make_raw_weights(info, seed=SEED, dtype=np.float32,
                            lora_dims=LORA)
    params = {d: stack_params(info, math, dtype=torch.float32, device=d)
              for d in (dev, "cpu")}
    rng = np.random.default_rng(SEED)
    B, T = 4, 40
    lengths = np.array([40, 33, 1, 0], np.int32)
    steps = [(rng.integers(1, VOCAB, (B, T)), lengths)] + [
        (rng.integers(1, VOCAB, (B, 1)), np.array([1, 1, 0, 1], np.int32))
        for _ in range(3)]
    state = {d: v7.init_state(info, B, device=d) for d in (dev, "cpu")}
    worst = 0.0
    for toks, lens in steps:
        out = {}
        for d in (dev, "cpu"):
            lt = torch.as_tensor(lens, device=d)
            h, state[d] = v7.forward(params[d], state[d],
                                     torch.as_tensor(toks, device=d), lt)
            logits = head_logits(params[d], take_last_valid(h, lt))
            out[d] = (h.cpu(), logits.cpu())
        m = torch.arange(toks.shape[1])[None, :] < torch.as_tensor(
            lens)[:, None]
        pairs = [(out[dev][0][m], out["cpu"][0][m]),
                 (out[dev][1][lens > 0], out["cpu"][1][lens > 0])]
        pairs += [(state[dev][k].cpu(), state["cpu"][k])
                  for k in state["cpu"]]
        for got, want in pairs:
            check(bool(torch.isfinite(got).all()), "non-finite output")
            err = float((got.double() - want.double()).abs().max())
            rel = err / max(float(want.abs().max()), 1e-6)
            worst = max(worst, rel)
    check(worst <= MODEL_TOL,
          f"card and CPU disagree: {worst:.3e} > {MODEL_TOL}")
    print(f"model parity (C={C}, 2 layers, f32, ragged prefill T={T} + 3 "
          f"decode steps): max |card - cpu| / max |cpu| = {worst:.3e} "
          f"(tolerance {MODEL_TOL})", flush=True)


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------


def synthetic_vocab() -> dict[str, str]:
    """65,535 distinct printable tokens (ids 1..65535; id 0 is
    end-of-text): the printable ASCII characters, then letter pairs,
    triples and quadruples, every other one with a leading space.  No
    token holds a newline, so the default "\\n\\n" stop never fires."""
    import itertools
    import string

    toks = [chr(c) for c in range(32, 127)]
    for n in (2, 3, 4):
        for i, t in enumerate(itertools.product(string.ascii_lowercase,
                                                repeat=n)):
            toks.append(("" if i % 2 else " ") + "".join(t))
            if len(toks) == VOCAB - 1:
                return {str(i + 1): t for i, t in enumerate(toks)}
    raise AssertionError("vocab too small")


def write_site(tmp: Path) -> Path:
    import numpy as np

    from ai00_server_tpu_torch.loader import save_safetensors
    from ai00_server_tpu_torch.testing import (make_raw_weights,
                                               to_converted_layout)

    t0 = time.monotonic()
    raw = make_raw_weights(model_info(L_FULL), seed=SEED, dtype=np.float32,
                           lora_dims=LORA)
    save_safetensors(to_converted_layout(raw), str(tmp / "rwkv7-0.4b.st"))
    del raw
    (tmp / "vocab.json").write_text(json.dumps(synthetic_vocab()))
    cfg = tmp / "Config.toml"
    cfg.write_text(f"""
[model]
name = "rwkv7-0.4b.st"
path = "{tmp}"
max_batch = {MAX_BATCH}
token_chunk_size = {CHUNK}
precision = "Fp16"

[tokenizer]
path = "{tmp / 'vocab.json'}"

[listen]
ip = "127.0.0.1"
port = 0
""")
    print(f"wrote the random 0.4B-shape checkpoint and vocabulary in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return cfg


PROMPT = ("the quick brown fox jumps over the lazy dog while a model "
          "decodes tokens on the card ")
NO_EOS = {"0": -1e4}  # random weights: keep end-of-text out of greedy picks


async def profiled(coro) -> str:
    """Await one request under torch.profiler: the device's busy share of
    the request's wall time and the kernels that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.monotonic()
    with profile(activities=acts) as prof:
        out = await coro
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        return "device time not measured (the profiler saw no CUDA events)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    n = out["usage"]["completion"]
    return (f"{n} tokens in {wall_us / 1e6:.3f} s (profiled), "
            f"{n_kernels} device kernels ({n_kernels / n:.0f} per token); "
            f"device busy {busy / 1e6:.4f} s = "
            f"{100 * busy / wall_us:.2f}% of wall; top kernels: "
            + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms" for n, t in top))


async def serve(cfg: Path, device="cuda") -> dict:
    import aiohttp
    from aiohttp import web

    from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1
    from ai00_server_tpu_torch.server.app import Server
    from ai00_server_tpu_torch.server.config import Config

    config = Config.from_toml(str(cfg))
    server = Server(config, device=device)
    t0 = time.monotonic()
    await server.middleware.reload(config.to_reload_request())
    load_s = time.monotonic() - t0
    runner = web.AppRunner(server.app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    port = runner.addresses[0][1]
    base = f"http://127.0.0.1:{port}"
    print(f"model loaded in {load_s:.1f} s; serving on {base}", flush=True)

    async def completion(http, prompt, max_tokens):
        async with http.post(f"{base}/api/oai/completions", json={
                "prompt": prompt, "max_tokens": max_tokens,
                "sampler": {"type": "Nucleus", "top_k": 1},
                "logit_bias": NO_EOS}) as r:
            check(r.status == 200, f"completions answered {r.status}")
            return await r.json()

    async def streamed_chat(http, content, max_tokens):
        t0 = time.monotonic()
        ttft, events = None, []
        async with http.post(f"{base}/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": content}],
                "max_tokens": max_tokens, "stream": True,
                "sampler": {"type": "Nucleus", "top_k": 1},
                "logit_bias": NO_EOS}) as r:
            check(r.status == 200, f"chat answered {r.status}")
            async for line in r.content:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                events.append(line[6:])
                if ttft is None and '"content"' in line:
                    ttft = time.monotonic() - t0
        check(events and events[-1] == "[DONE]",
              "the SSE stream did not end in data: [DONE]")
        text = "".join(json.loads(e)["choices"][0].get("delta", {})
                       .get("content", "") for e in events[:-1])
        check(bool(text), "the streamed chat returned no text")
        return ttft, text

    result = {}
    try:
        async with aiohttp.ClientSession() as http:
            await completion(http, "warm up", 8)  # first-call set-up

            prompts = [PROMPT * 20, PROMPT * 20, PROMPT * 11 + "alpha",
                       PROMPT * 11 + "alpha"]
            wkv7_t1.launches = 0
            wkv7_chunk.launches = 0
            t0 = time.monotonic()
            *outs, (ttft_load, _chat) = await asyncio.gather(
                *[completion(http, p, 128) for p in prompts],
                streamed_chat(http, PROMPT * 8, 64))
            wall = time.monotonic() - t0
            launches = {"wkv7_t1": wkv7_t1.launches,
                        "wkv7_chunk": wkv7_chunk.launches}
            texts = [o["choices"][0]["text"] for o in outs]
            check(all(texts), "a completion returned no text")
            check(texts[0] == texts[1] and texts[2] == texts[3],
                  "identical greedy requests returned different text")
            n_tokens = sum(o["usage"]["completion"] for o in outs)
            prompt_tokens = sum(o["usage"]["prompt"] for o in outs)
            ttft_solo, _ = await streamed_chat(
                http, "once more, " + PROMPT * 8, 16)
            profile = await profiled(
                completion(http, "and a profiled one: " + PROMPT * 8, 64))
        result = {
            "launches": launches, "wall_s": wall,
            "completion_tokens": n_tokens, "prompt_tokens": prompt_tokens,
            "tokens_per_s": n_tokens / wall, "ttft_s_under_load": ttft_load,
            "ttft_s_alone": ttft_solo, "sample": texts[0][:60],
            "profile": profile,
        }
    finally:
        await server.middleware.unload()
        await runner.cleanup()
    return result


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    if not (ROOT / "ai00_server_tpu_torch" / "csrc").is_dir():
        fail(f"the port's package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)

    from ai00_server_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build_all()
    print(f"built {sorted(_build.SIGNATURES)} in {time.monotonic() - t0:.1f}"
          " s (nvcc sm_90a)", flush=True)
    for name, info in _build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.monotonic()
    rows = phase_kernels(dev)
    print(f"phase 2 (kernels) {time.monotonic() - t0:.1f} s", flush=True)

    t0 = time.monotonic()
    phase_parity(dev)
    print(f"phase 3 (parity) {time.monotonic() - t0:.1f} s", flush=True)

    t0 = time.monotonic()
    tmp_root = ROOT / "chip_smoke_tmp"
    tmp_root.mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
            cfg = write_site(Path(tmp))
            served = asyncio.run(serve(cfg))
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)
    for name, n in served["launches"].items():
        check(n > 0, f"the serving path never launched {name}")
        rows[name]["launches"] = n
    print(f"serving (24 layers, bf16, max_batch {MAX_BATCH}, chunk {CHUNK}) "
          f"on {card}: 4 greedy completions + 1 streamed chat in "
          f"{served['wall_s']:.2f} s, {served['completion_tokens']} "
          f"completion tokens ({served['prompt_tokens']} prompt) -> "
          f"{served['tokens_per_s']:.1f} tokens/s; TTFT "
          f"{served['ttft_s_under_load']:.3f} s under load, "
          f"{served['ttft_s_alone']:.3f} s alone; sample "
          f"{served['sample']!r}", flush=True)
    print(f"profile of one 64-token completion alone: {served['profile']}",
          flush=True)
    print(f"phase 4 (serving) {time.monotonic() - t0:.1f} s", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
