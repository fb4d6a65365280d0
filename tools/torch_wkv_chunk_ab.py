#!/usr/bin/env python3
"""A/B of the prefill WKV kernels, ``wkv7_chunk``, ``wkv56_chunk`` and
``wkv4_chunk``: an earlier checkout of the port against this one, on one
card, in turns.

    mkdir -p chip_smoke_tmp/parent        # any directory git ignores
    git archive d64f725 ai00_server_tpu_torch chip_smoke.py \\
        | tar -x -C chip_smoke_tmp/parent
    python3 tools/torch_wkv_chunk_ab.py --old chip_smoke_tmp/parent \\
        [--out results.json] [--slices] [--plans] [--no-model]

``--old`` is a directory holding an earlier ``ai00_server_tpu_torch/`` and
its ``chip_smoke.py``.  Each turn is a process of its own that imports one
tree, builds its kernels and times, with CUDA events around launches
captured in a CUDA graph (``chip_smoke.device_ms``) on inputs that rotate
past the 50 MB L2:

- the kernels at B = 8 and 1, T = 16 and 256: ``wkv7_chunk`` at the RWKV-7
  0.4B width (H = 16), ``wkv56_chunk`` at the RWKV-6 1B6 width (H = 32,
  dense decay) and at the RWKV-5 0.4B width (H = 16, static decay); and
  ``wkv4_chunk`` at the RWKV-4 0.4B width (C = 1024, bf16 k and v) at B = 8
  and 1, T = 1, 23 and 256; each also held against its plain version (max
  |kernel - plain| / max(1, |plain|));
- unless ``--no-model``, one 4096-token prompt prefilled through
  ``models/v7.forward`` and ``models/v4.forward`` at 24 layers in bf16 and
  through ``models/v6.forward`` at ``chip_smoke.L6`` layers, in chunks of
  ``chip_smoke.CHUNK`` tokens as the server runs it (random weights from a
  seed; ms from the first chunk's launch to the last chunk's end).

Turns run old, new, new, old.  With ``--slices`` the new tree's v7 / v5 /
v6 kernels are also timed at each state split (1, 2 and 4 blocks per
head), and with ``--plans`` its ``wkv4_chunk`` at every (G, NS) launch
shape of ``ops/wkv4.plan`` (its choice marked), each in one more
process.  Prints the card's line (``nvidia-smi``) and one JSON object (also
written to ``--out``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = [("wkv7_chunk", "v7 0.4B", 16, False),
           ("wkv56_chunk", "v6 1B6", 32, False),
           ("wkv56_chunk", "v5 0.4B", 16, True)]
BATCHES = (8, 1)
STEPS = (16, 256)
V4_STEPS = (1, 23, 256)
V4_C = 1024
PROMPT = 4096


def kernel_inputs(name, B, T, H, static, gen, dev):
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    S = rnd(B, H, 64, 64)
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    if name == "wkv7_chunk":
        r, k, v = (rnd(B, T, H, 64, scale=0.3) for _ in range(3))
        w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, T, H, 64)))
        kk = rnd(B, T, H, 64)
        kk = kk / kk.norm(dim=-1, keepdim=True)
        a = torch.sigmoid(rnd(B, T, H, 64))
        return (S, r, w, k, v, kk, a, mask)
    r, k, v = (rnd(B, T, H, 64, scale=0.3) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(*((H, 64) if static else (B, T, H, 64)),
                                 scale=0.5)))
    return (S, r, k, v, w, rnd(H, 64, scale=0.5), mask)


def v4_inputs(B, T, gen, dev):
    """wkv4_chunk's operands: an advanced state, bf16 k and v, w from
    ``time_decay`` ~ N(0, 0.5), every step valid."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    C = V4_C
    bb = torch.rand(B, C, generator=gen, device=dev) + 0.5
    return (rnd(B, C), bb, rnd(B, C), rnd(B, T, C).to(torch.bfloat16),
            rnd(B, T, C).to(torch.bfloat16), -torch.exp(rnd(C, scale=0.5)),
            rnd(C, scale=0.5), torch.ones(B, T, dtype=torch.bool, device=dev))


def time_v4(cs, dev, steps=V4_STEPS) -> dict:
    """``wkv4_chunk`` at ``steps`` x BATCHES on inputs rotating past the L2,
    held against its plain version on the first set."""
    import torch

    from ai00_server_tpu_torch.ops.wkv4 import wkv4_chunk, wkv4_chunk_plain

    out = {}
    for B in BATCHES:
        for T in steps:
            gen = torch.Generator(device=dev)
            gen.manual_seed(cs.SEED + 24)
            first = v4_inputs(B, T, gen, dev)
            each = sum(t.numel() * t.element_size() for t in first)
            each += 4 * B * (3 + T) * V4_C  # the outputs
            n = int(2 * cs.L2_BYTES // each) + 1
            sets = [first] + [v4_inputs(B, T, gen, dev)
                              for _ in range(n - 1)]
            got, want = wkv4_chunk(*first), wkv4_chunk_plain(*first)
            torch.cuda.synchronize()
            err = max(cs.rel_err(g, p)[1]
                      for g, p in zip((*got[0], got[1]), (*want[0], want[1])))
            ms = cs.device_ms(cs.rotating(lambda i: wkv4_chunk(*sets[i]), n),
                              max(20, n))
            out[f"wkv4_chunk v4 0.4B B={B} T={T}"] = {"ms": ms,
                                                      "rel_err": err,
                                                      "sets": n}
            del sets, first
            torch.cuda.empty_cache()
    return out


def time_kernels(cs, dev) -> dict:
    import torch

    from ai00_server_tpu_torch.ops import wkv_chunk as wc

    out = {}
    for name, width, H, static in KERNELS:
        kernel, plain = getattr(wc, name), getattr(wc, name + "_plain")
        for B in BATCHES:
            for T in STEPS:
                gen = torch.Generator(device=dev)
                gen.manual_seed(cs.SEED + 21)
                first = kernel_inputs(name, B, T, H, static, gen, dev)
                each = sum(t.numel() * t.element_size() for t in first)
                n = int(2 * cs.L2_BYTES // each) + 1
                sets = [first] + [kernel_inputs(name, B, T, H, static, gen,
                                                dev) for _ in range(n - 1)]
                got, want = kernel(*first), plain(*first)
                torch.cuda.synchronize()
                err = max(cs.rel_err(g, p)[1] for g, p in zip(got, want))
                ms = cs.device_ms(cs.rotating(lambda i: kernel(*sets[i]), n),
                                  max(20, n))  # every set once a replay
                out[f"{name} {width} B={B} T={T}"] = {"ms": ms, "rel_err": err,
                                                      "sets": n}
                del sets, first
                torch.cuda.empty_cache()
    return out


def model_params(cs, version: str, L: int, dev):
    """``L`` layers of the ``version`` shape in bf16: one layer of random
    weights from the seed, its big projections drawn anew on the card for
    every layer (v6 fan-in scaled, as chip_smoke's parity models)."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.testing import make_raw_weights

    one = cs.model_info(1, version)
    raw = make_raw_weights(one, seed=cs.SEED + 22, dtype=np.float32,
                           lora_dims=cs.lora_dims(version))
    if version != "v7":
        raw = cs.fan_in_scaled(raw)
    params = stack_params(one, raw, dtype=torch.bfloat16, device=dev)
    fd = fused_decode.module_for(one.version.value)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 22)
    base = params["layers"][0]
    layers = []
    for _ in range(L):
        layer = {**base, "att": dict(base["att"]), "ffn": dict(base["ffn"])}
        for part, key in fd._BIG_SRC.values():
            K, Nout = layer[part][key].shape
            layer[part][key] = (torch.randn(K, Nout, generator=gen,
                                            device=dev)
                                / K ** 0.5).to(torch.bfloat16)
        layers.append(layer)
    params["layers"] = layers
    return cs.model_info(L, version), params


def time_prefill(cs, dev) -> dict:
    """ms of one PROMPT-token prefill, in chunks of CHUNK tokens, at B = 1."""
    import torch

    from ai00_server_tpu_torch.models import get_version_module

    out = {}
    for version, L in (("v7", cs.L_FULL), ("v4", cs.L_FULL), ("v6", cs.L6)):
        info, params = model_params(cs, version, L, dev)
        module = get_version_module(info.version)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED + 23)
        tokens = torch.randint(0, info.num_vocab, (1, PROMPT),
                               generator=gen, device=dev)
        lengths = torch.full((1,), cs.CHUNK, dtype=torch.int64, device=dev)

        def prefill():
            state = module.init_state(info, 1, device=dev)
            for t0 in range(0, PROMPT, cs.CHUNK):
                hidden, state = module.forward(
                    params, state, tokens[:, t0:t0 + cs.CHUNK], lengths)
            return hidden

        with torch.no_grad():
            prefill()  # warm-up
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                prefill()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        out[f"{version} bf16 L={L} prefill {PROMPT}"] = {"ms": min(times),
                                                         "all_ms": times}
        del params
        torch.cuda.empty_cache()
    return out


def child(slices: bool, plans: bool, model: bool) -> dict:
    import torch

    import chip_smoke as cs
    from ai00_server_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    if plans:
        return time_plans(cs, dev)
    if not slices:
        return {**time_kernels(cs, dev), **time_v4(cs, dev),
                **(time_prefill(cs, dev) if model else {})}
    from ai00_server_tpu_torch.ops import wkv_chunk as wc

    out = {}
    for n in (1, 2, 4):
        wc.plan = lambda *a, n=n: n
        out.update({f"{k} slices={n}": v
                    for k, v in time_kernels(cs, dev).items()})
    return out


def time_plans(cs, dev) -> dict:
    """``wkv4_chunk`` (this tree) at every NS the plan gives (4 to 32 runs
    of 8 steps, 256 / NS channels a block) for each shape of
    :func:`time_v4` but T = 1 (the step-by-step kernel), ``plan``'s own
    choice marked."""
    from ai00_server_tpu_torch.ops import wkv4

    chosen = wkv4.plan
    out = {}
    for T in V4_STEPS[1:]:
        for NS in (4, 8, 16, 32):
            shape = (wkv4.THREADS // NS, NS)
            wkv4.plan = lambda T, p=shape: p
            for name, r in time_v4(cs, dev, (T,)).items():
                mark = " (plan)" if chosen(T) == shape else ""
                out[f"{name} G={shape[0]} NS={NS}{mark}"] = r
    wkv4.plan = chosen
    return out


def run(tree: Path, *flags: str) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(tree.resolve()), *flags], capture_output=True, text=True,
        cwd=str(tree.resolve()))
    if proc.returncode != 0:
        sys.exit(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(child("--slices" in sys.argv, "--plans" in sys.argv,
                               "--no-model" not in sys.argv)))
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--slices", action="store_true")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--no-model", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    flags = ["--no-model"] if args.no_model else []
    turns = {"old": [], "new": []}
    for turn, tree in (("old", args.old), ("new", ROOT), ("new", ROOT),
                       ("old", args.old)):
        turns[turn].append(run(Path(tree), *flags))
    rows = {}
    for name in turns["new"][0]:
        old = [t[name]["ms"] for t in turns["old"]]
        new = [t[name]["ms"] for t in turns["new"]]
        rows[name] = {"old_ms": old, "new_ms": new,
                      "old_rel_err": turns["old"][0][name].get("rel_err"),
                      "new_rel_err": turns["new"][0][name].get("rel_err")}
        mo, mn = sum(old) / 2, sum(new) / 2
        print(f"{name}: old {mo:.5f} new {mn:.5f} ms ({mo / mn:.2f}x; turns "
              f"{old[0]:.5f} {new[0]:.5f} {new[1]:.5f} {old[1]:.5f})",
              flush=True)
    result = {"card": card, "rows": rows}
    for flag in ("slices", "plans"):
        if getattr(args, flag):
            result[flag] = run(ROOT, f"--{flag}")
            for name, r in result[flag].items():
                print(f"{name}: {r['ms']:.5f} ms (rel err "
                      f"{r['rel_err']:.2e})", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
