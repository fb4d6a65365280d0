#!/usr/bin/env python3
"""A/B of the dequantizing products (``csrc/quant.cu``: ``matmul_int8``,
``matmul_int8_l``, ``matmul_4bit``, ``matmul_4bit_l``, ``ffn7_t1_l``): an
earlier checkout of the port against this one, on one card, in turns; and
the row count where ``dequant()`` plus one ``torch.matmul`` overtakes the
kernel.

    mkdir -p chip_smoke_tmp/parent        # any directory git ignores
    git archive 9a0e2dd ai00_server_tpu_torch chip_smoke.py \\
        | tar -x -C chip_smoke_tmp/parent
    python3 tools/torch_quant_ab.py --old chip_smoke_tmp/parent \\
        [--out results.json] [--no-model] [--no-crossover]
    python3 tools/torch_quant_ab.py --trees DIR [DIR ...] [--out f.json]

``--old`` is a directory holding an earlier ``ai00_server_tpu_torch/`` and
its ``chip_smoke.py``.  Each turn is a process of its own that imports one
tree, builds its kernels and times, with CUDA events around launches
captured in a CUDA graph (``chip_smoke.device_ms``) on codes that rotate
past the 50 MB L2 (random int8 codes or packed bytes and positive scales
made on the card from a seed), bf16 activations, at the RWKV-7 0.4B width:

- the int8 LM head (1024 x 65536, f32 logits), ``matmul_int8_l`` and
  nf4 ``matmul_4bit_l`` on a (1024, 1024) layer, nf4 ``matmul_4bit`` on an
  unstacked (1024, 4096) weight, ``ffn7_t1_l`` in int8 and nf4 (C = 1024,
  F = 4096), each at B = 1, 8 and 64, and ``matmul_int8_l`` /
  ``matmul_4bit_l`` on a (1024, 4096) layer at 256 rows (a prefill chunk's
  rows, in four launches), each also held against its plain version
  (max |kernel - plain| / max(1, |plain|)) and counted in launches;
- unless ``--no-model``, one 4096-token prompt prefilled at B = 1 through
  ``models/v7.forward`` at 24 layers, all quantized (``quant = 24``) in
  int8 and in nf4, in chunks of ``chip_smoke.CHUNK`` tokens as the server
  runs it (random weights from a seed; ms from the first chunk's launch to
  the last chunk's end; the wrappers' launches during one prefill).

Turns run old, new, new, old.  ``--trees`` times the kernels alone (no
model, no crossover) of each listed tree - variants of this one, each a
copy of ``ai00_server_tpu_torch/`` and ``chip_smoke.py`` with its
``csrc/quant.cu`` edited - in turns, forward then backward.  Unless
``--no-crossover``, one more process
of this tree times the kernel against ``dequant()`` and one
``torch.matmul`` (what ``ops/quant.py`` runs from ``KERNEL_ROWS`` rows on)
at R = 64, 128, 256, 512, 1024 and 2048 on the v7 0.4B (1024, 1024), (1024,
4096), (4096, 1024), the head (1024, 65536, int8 only, f32 logits) and the
v6 1B6 (2048, 7168), (7168, 2048), in int8 and nf4.  Prints the card's line
(``nvidia-smi``) and one JSON object (also written to ``--out``).  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCHES = (1, 8, 64)
C, F, V = 1024, 4096, 65536
PROMPT = 4096
CROSS_ROWS = (64, 128, 256, 512, 1024, 2048)
CROSS_SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 65536),
                (2048, 7168), (7168, 2048)]


def codes(gen, dev, mode: str, n: int, K: int, N: int):
    """n stacked random (K, N) weights of ``mode`` codes: a
    ``QuantizedLinear`` of codes (n, nb, block, N) and scales (n, nb, 1,
    N)."""
    import torch

    from ai00_server_tpu_torch.ops import quant

    if mode == "int8":
        q = torch.randint(-127, 128, (n, K // 128, 128, N), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.int8)
        nb = K // 128
    else:
        q = torch.randint(0, 256, (n, K // 64, 32, N), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)
        nb = K // 64
    s = (torch.rand(n, nb, 1, N, generator=gen, device=dev) + 0.5) / (
        127 * K ** 0.5)
    return quant.QuantizedLinear(mode, q, s, (K, N))


def sets_over_l2(cs, nbytes: int) -> int:
    return int(2 * cs.L2_BYTES // nbytes) + 1


def kernel_cases(cs, dev):
    """name -> (kernel call(i), plain call(i), sets, counter)."""
    import torch

    from ai00_server_tpu_torch.ops import ffn
    from ai00_server_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 31)

    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cases = {}
    n = sets_over_l2(cs, C * V)
    head = codes(gen, dev, "int8", n, C, V)
    for B in BATCHES:
        x = rnd(B, C).bfloat16()
        cases[f"matmul_int8 head (1024, 65536) B={B}"] = (
            lambda i, x=x: qm.matmul_int8(x, head.q[i], head.scale[i],
                                          torch.float32),
            lambda i, x=x: qm.matmul_int8_plain(x, head.q[i], head.scale[i],
                                                torch.float32),
            n, qm.matmul_int8)
    n = sets_over_l2(cs, C * C)
    s8, s4 = codes(gen, dev, "int8", n, C, C), codes(gen, dev, "nf4", n, C, C)
    n4 = sets_over_l2(cs, C * F // 2)
    u4 = codes(gen, dev, "nf4", n4, C, F)
    for B in BATCHES:
        x = rnd(B, C).bfloat16()
        cases[f"matmul_int8_l (1024, 1024) B={B}"] = (
            lambda i, x=x: qm.matmul_int8_l(x, s8.q, s8.scale, i),
            lambda i, x=x: qm.matmul_int8_l_plain(x, s8.q, s8.scale, i),
            n, qm.matmul_int8_l)
        cases[f"matmul_4bit_l nf4 (1024, 1024) B={B}"] = (
            lambda i, x=x: qm.matmul_4bit_l(x, s4.q, s4.scale, i, "nf4"),
            lambda i, x=x: qm.matmul_4bit_l_plain(x, s4.q, s4.scale, i,
                                                  "nf4"),
            n, qm.matmul_4bit_l)
        cases[f"matmul_4bit nf4 (1024, 4096) B={B}"] = (
            lambda i, x=x: qm.matmul_4bit(x, u4.q[i], u4.scale[i], "nf4"),
            lambda i, x=x: qm.matmul_4bit_plain(x, u4.q[i], u4.scale[i],
                                                "nf4"),
            n4, qm.matmul_4bit)
    for mode in ("int8", "nf4"):
        per = C * F * (2 if mode == "int8" else 1)
        nf = sets_over_l2(cs, per)
        key, val = codes(gen, dev, mode, nf, C, F), codes(gen, dev, mode,
                                                          nf, F, C)
        for B in BATCHES:
            xf, shift = rnd(B, C, scale=1.0).bfloat16(), rnd(B, C)
            mix = rnd(C, scale=0.3).bfloat16()
            active = torch.ones(B, dtype=torch.bool, device=dev)

            def args(i, xf=xf, shift=shift, mix=mix, active=active,
                     key=key, val=val):
                return (xf, shift, mix, active, key.q, key.scale, val.q,
                        val.scale, i)

            cases[f"ffn7_t1_l {mode} B={B}"] = (
                lambda i, args=args, mode=mode: ffn.ffn7_t1_l(*args(i),
                                                              qmode=mode),
                lambda i, args=args, mode=mode: ffn.ffn7_t1_l_plain(
                    *args(i), qmode=mode),
                nf, ffn.ffn7_t1_l)
    n = sets_over_l2(cs, C * F)
    w8 = codes(gen, dev, "int8", n, C, F)
    w4 = codes(gen, dev, "nf4", n, C, F)
    x = rnd(256, C).bfloat16()
    cases["matmul_int8_l (1024, 4096) R=256"] = (
        lambda i: qm.matmul_int8_l(x, w8.q, w8.scale, i),
        lambda i: qm.matmul_int8_l_plain(x, w8.q, w8.scale, i),
        n, qm.matmul_int8_l)
    cases["matmul_4bit_l nf4 (1024, 4096) R=256"] = (
        lambda i: qm.matmul_4bit_l(x, w4.q, w4.scale, i, "nf4"),
        lambda i: qm.matmul_4bit_l_plain(x, w4.q, w4.scale, i, "nf4"),
        n, qm.matmul_4bit_l)
    return cases


def time_kernels(cs, dev) -> dict:
    import torch

    out = {}
    for name, (kernel, plain, n, counter) in kernel_cases(cs, dev).items():
        got, want = kernel(0), plain(0)
        if isinstance(got, tuple):
            got, want = got[0], want[0]
        torch.cuda.synchronize()
        err = cs.rel_err(got.float(), want.float())[1]
        before = counter.launches
        kernel(0)
        launches = counter.launches - before
        ms = cs.device_ms(cs.rotating(kernel, n), max(20, n))
        out[name] = {"ms": ms, "rel_err": err, "launches": launches,
                     "sets": n}
    torch.cuda.empty_cache()
    return out


def model_params(cs, mode: str, dev):
    """The v7 0.4B shape at ``chip_smoke.L_FULL`` layers, every layer's
    big projections drawn anew on the card from the seed and quantized in
    ``mode`` (``chip_smoke.quantized_params``)."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.testing import make_raw_weights

    one = cs.model_info(1, "v7")
    raw = make_raw_weights(one, seed=cs.SEED + 32, dtype=np.float32,
                           lora_dims=cs.lora_dims("v7"))
    params = stack_params(one, raw, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 32)
    base = params["layers"][0]
    layers = []
    for _ in range(cs.L_FULL):
        layer = {**base, "att": dict(base["att"]), "ffn": dict(base["ffn"])}
        for part, key in fd._BIG_SRC.values():
            K, Nout = layer[part][key].shape
            layer[part][key] = (torch.randn(K, Nout, generator=gen,
                                            device=dev)
                                / K ** 0.5).to(torch.bfloat16)
        layers.append(layer)
    params["layers"] = layers
    return cs.model_info(cs.L_FULL, "v7"), cs.quantized_params(params, "V7",
                                                                mode)


def time_prefill(cs, dev) -> dict:
    """ms of one PROMPT-token prefill at B = 1, in chunks of CHUNK tokens,
    on the all-int8 and all-nf4 0.4B models."""
    import torch

    from ai00_server_tpu_torch.models import v7
    from ai00_server_tpu_torch.ops import ffn
    from ai00_server_tpu_torch.ops import quant_matmul as qm

    out = {}
    counters = (qm.matmul_int8_l, qm.matmul_4bit_l, ffn.ffn7_t1_l)
    for mode in ("int8", "nf4"):
        info, params = model_params(cs, mode, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED + 33)
        tokens = torch.randint(0, info.num_vocab, (1, PROMPT),
                               generator=gen, device=dev)
        lengths = torch.full((1,), cs.CHUNK, dtype=torch.int64, device=dev)

        def prefill():
            state = v7.init_state(info, 1, device=dev)
            for t0 in range(0, PROMPT, cs.CHUNK):
                hidden, state = v7.forward(
                    params, state, tokens[:, t0:t0 + cs.CHUNK], lengths)
            return hidden

        with torch.no_grad():
            before = [c.launches for c in counters]
            prefill()  # warm-up
            torch.cuda.synchronize()
            launches = sum(c.launches - b for c, b in zip(counters, before))
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                prefill()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        out[f"v7 0.4B {mode} L={cs.L_FULL} prefill {PROMPT}"] = {
            "ms": min(times), "all_ms": times, "launches": launches}
        del params
        torch.cuda.empty_cache()
    return out


def crossover(cs, dev) -> dict:
    """Kernel against dequant() + one torch.matmul at CROSS_ROWS rows."""
    import torch

    from ai00_server_tpu_torch.ops import quant
    from ai00_server_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 34)
    out = {}
    for K, N in CROSS_SHAPES:
        head = N == V
        for mode in ("int8",) if head else ("int8", "nf4"):
            per = K * N if mode == "int8" else K * N // 2
            n = sets_over_l2(cs, per)
            w = codes(gen, dev, mode, n, K, N)
            for R in CROSS_ROWS:
                x = (torch.randn(R, K, generator=gen, device=dev)
                     * 0.5).bfloat16()
                if head:
                    def kernel(i, x=x):
                        return qm.matmul_int8(x, w.q[i], w.scale[i],
                                              torch.float32)

                    def dense(i, x=x):
                        wd = quant.QuantizedLinear(
                            mode, w.q[i], w.scale[i], (K, N)).dequant(
                                torch.bfloat16)
                        return torch.mm(x, wd, out_dtype=torch.float32)
                else:
                    fn = (qm.matmul_int8_l if mode == "int8" else
                          lambda *a: qm.matmul_4bit_l(*a, mode=mode))

                    def kernel(i, x=x, fn=fn):
                        return fn(x, w.q, w.scale, i)

                    def dense(i, x=x):
                        wd = quant.QuantizedLinear(
                            mode, w.q[i], w.scale[i], (K, N)).dequant(
                                x.dtype)
                        return torch.matmul(x, wd)
                iters = max(4, n)
                k_ms = cs.device_ms(cs.rotating(kernel, n), iters)
                d_ms = cs.device_ms(cs.rotating(dense, n), iters)
                out[f"({K}, {N}) {mode} R={R}"] = {"kernel_ms": k_ms,
                                                   "dequant_ms": d_ms}
                print(f"crossover ({K}, {N}) {mode} R={R}: kernel "
                      f"{k_ms:.5f} ms, dequant + matmul {d_ms:.5f} ms",
                      file=sys.stderr, flush=True)
            del w
            torch.cuda.empty_cache()
    return out


def child(model: bool, cross: bool) -> dict:
    import torch

    import chip_smoke as cs
    from ai00_server_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    if model or cross:
        _build.build_all()
    else:  # the kernels alone: only csrc/quant.cu
        _build._libs["quant"] = _build._load("quant", _build._compile("quant"))
    if cross:
        return crossover(cs, dev)
    return {**time_kernels(cs, dev), **(time_prefill(cs, dev)
                                        if model else {})}


def run(tree: Path, *flags: str) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(tree.resolve()), *flags], capture_output=True, text=True,
        cwd=str(tree.resolve()))
    if proc.returncode != 0:
        sys.exit(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def variants(card: str, trees: list, out) -> None:
    """Each tree's kernel times, in turns forward then backward."""
    runs = {str(t): [] for t in trees}
    for tree in trees + trees[::-1]:
        runs[str(tree)].append(run(tree, "--no-model"))
    rows = {}
    for name in runs[str(trees[0])][0]:
        rows[name] = {t: [r[name]["ms"] for r in rs] for t, rs in runs.items()}
        print(f"{name}: " + "; ".join(
            f"{Path(t).name} {sum(ms) / len(ms):.5f}"
            for t, ms in rows[name].items()), flush=True)
    result = {"card": card, "variants": rows}
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(child("--no-model" not in sys.argv,
                               "--crossover" in sys.argv)))
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--no-model", action="store_true")
    ap.add_argument("--no-crossover", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    if args.trees:
        variants(card, args.trees, args.out)
        return
    if args.old is None:
        ap.error("--old or --trees is required")
    flags = ["--no-model"] if args.no_model else []
    turns = {"old": [], "new": []}
    for turn, tree in (("old", args.old), ("new", ROOT), ("new", ROOT),
                       ("old", args.old)):
        turns[turn].append(run(Path(tree), *flags))
    rows = {}
    for name in turns["new"][0]:
        old = [t[name]["ms"] for t in turns["old"]]
        new = [t[name]["ms"] for t in turns["new"]]
        rows[name] = {
            "old_ms": old, "new_ms": new,
            "old_launches": turns["old"][0][name].get("launches"),
            "new_launches": turns["new"][0][name].get("launches"),
            "old_rel_err": turns["old"][0][name].get("rel_err"),
            "new_rel_err": turns["new"][0][name].get("rel_err")}
        mo, mn = sum(old) / 2, sum(new) / 2
        print(f"{name}: old {mo:.5f} new {mn:.5f} ms ({mo / mn:.2f}x; turns "
              f"{old[0]:.5f} {new[0]:.5f} {new[1]:.5f} {old[1]:.5f}; "
              f"launches {rows[name]['old_launches']} -> "
              f"{rows[name]['new_launches']})", flush=True)
    result = {"card": card, "rows": rows}
    if not args.no_crossover:
        result["crossover"] = run(ROOT, "--crossover")
        for name, r in result["crossover"].items():
            print(f"crossover {name}: kernel {r['kernel_ms']:.5f} ms, "
                  f"dequant + matmul {r['dequant_ms']:.5f} ms "
                  f"({r['dequant_ms'] / r['kernel_ms']:.2f}x)", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
