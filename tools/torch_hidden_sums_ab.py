#!/usr/bin/env python3
"""A/B of the port's hidden-sum accumulation on the served v7 bf16 burst.

    python3 tools/torch_hidden_sums_ab.py [--rounds 3] [--device cuda]

Serves ``chip_smoke.py``'s random 24-layer RWKV-7 0.4B-shape bf16
checkpoint with ``ai00_server_tpu_torch`` and runs its burst (4 greedy
completions of 128 tokens and 1 streamed chat of 64, all at once; each
burst's prompts new, so each is prefilled) in rounds ordered off, on, on,
off:

* off: the server as it runs.  Only rows loaded with ``hidden_sums=True``
  (mean-hidden ``/embeddings``) add to ``Engine.hsum_pool``, so a
  completion's ``step()`` adds nothing.
* on: every row is loaded with ``hidden_sums=True``, so every ``step()``
  (prefill chunks and T=1 steps) adds the masked sums of all rows, as the
  engine did before the accumulation was limited to embed rows.

Then ``Engine.step`` alone, on a full (8, 256) prefill chunk and on an
(8, 1) step, in each mode (wall time per call, which includes the head,
the sampler and the host copy of the tokens).  Prints the card's line and
one JSON object with every reading.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


async def burst(http, base, tag: str) -> dict:
    """The burst, its prompts led by ``tag`` so that no prefix-cache entry
    of an earlier burst is hit and every prompt is prefilled by step()."""
    async def completion(prompt):
        async with http.post(f"{base}/api/oai/completions", json={
                "prompt": prompt, "max_tokens": 128,
                "sampler": {"type": "Nucleus", "top_k": 1},
                "logit_bias": cs.NO_EOS}) as r:
            cs.check(r.status == 200, f"completions answered {r.status}")
            return await r.json()

    async def chat():
        t0 = time.monotonic()
        ttft = None
        async with http.post(f"{base}/api/oai/chat/completions", json={
                "messages": [{"role": "user",
                              "content": tag + cs.PROMPT * 8}],
                "max_tokens": 64, "stream": True,
                "sampler": {"type": "Nucleus", "top_k": 1},
                "logit_bias": cs.NO_EOS}) as r:
            cs.check(r.status == 200, f"chat answered {r.status}")
            async for line in r.content:
                if ttft is None and b'"content"' in line:
                    ttft = time.monotonic() - t0
        return ttft

    prompts = [tag + cs.PROMPT * 20, tag + cs.PROMPT * 20,
               tag + cs.PROMPT * 11 + "alpha", tag + cs.PROMPT * 11 + "alpha"]
    t0 = time.monotonic()
    *outs, ttft = await asyncio.gather(*[completion(p) for p in prompts],
                                       chat())
    wall = time.monotonic() - t0
    n = sum(o["usage"]["completion"] for o in outs)
    return {"wall_s": wall, "tokens_per_s": n / wall, "ttft_s": ttft}


def set_mode(eng, orig_load, on: bool) -> None:
    """on: every row is (re)loaded with hidden_sums=True from now on."""
    eng.load_row_state = (functools.partial(orig_load, hidden_sums=True)
                          if on else orig_load)
    eng.hsum_rows[:] = on


def time_steps(eng, orig_load, T: int, iters: int) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(cs.SEED)
    B = eng.max_batch
    out = {}
    for on in (False, True, True, False):
        set_mode(eng, orig_load, on)
        for b in range(B):
            eng.load_row_state(b, None)
        toks = rng.integers(1, cs.VOCAB, (B, T)).astype(np.int32)
        lens = np.full(B, T, np.int32)
        mask = np.ones(B, np.bool_)
        eng.step(toks, lens, mask)  # warm-up
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.step(toks, lens, mask)
        ms = (time.perf_counter() - t0) / iters * 1e3
        out.setdefault("on" if on else "off", []).append(ms)
    set_mode(eng, orig_load, False)
    return out


async def run(args) -> dict:
    import aiohttp
    from aiohttp import web

    from ai00_server_tpu_torch.server.app import Server
    from ai00_server_tpu_torch.server.config import Config

    with tempfile.TemporaryDirectory() as tmp:
        cfg = cs.write_site(Path(tmp))["bf16"]
        config = Config.from_toml(str(cfg))
        server = Server(config, device=args.device)
        await server.middleware.reload(config.to_reload_request())
    runner = web.AppRunner(server.app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    eng = server.middleware.env.engine
    orig_load = eng.load_row_state
    result = {"burst": {"off": [], "on": []}}
    try:
        async with aiohttp.ClientSession() as http:
            await burst(http, base, "warm up ")  # first-call set-up
            for i in range(args.rounds):
                for j, on in enumerate((False, True, True, False)):
                    set_mode(eng, orig_load, on)
                    serial = eng.hsum_serial
                    r = await burst(http, base, f"round {i}.{j}: ")
                    # Steps that added sums (each load also counts one).
                    r["hsum_serial_delta"] = eng.hsum_serial - serial
                    result["burst"]["on" if on else "off"].append(r)
            set_mode(eng, orig_load, False)
        result["step_ms_T256"] = time_steps(eng, orig_load, cs.CHUNK, 10)
        result["step_ms_T1"] = time_steps(eng, orig_load, 1, 100)
    finally:
        await server.middleware.unload()
        await runner.cleanup()
    for mode in ("off", "on"):
        runs = result["burst"][mode]
        result[f"tokens_per_s_{mode}"] = sorted(r["tokens_per_s"]
                                                for r in runs)
        result[f"ttft_s_{mode}"] = sorted(r["ttft_s"] for r in runs)
    return result


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.device == "cuda":
        print(cs.card_line(), flush=True)
    print(json.dumps(asyncio.run(run(args))), flush=True)


if __name__ == "__main__":
    main()
