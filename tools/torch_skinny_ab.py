#!/usr/bin/env python3
"""A/B of ``v7_skinny_matmul`` and ``v7_ln_mix`` (``csrc/v7_decode.cu``,
``csrc/decode_common.cuh``) against an earlier version of their kernels,
on one card, in turns.

    mkdir -p chip_smoke_tmp/old        # any directory git ignores
    for f in v7_decode.cu decode_common.cuh matmul_common.cuh \\
             wkv7_common.cuh; do
        git show 76b1c9c:ai00_server_tpu_torch/csrc/$f > chip_smoke_tmp/old/$f
    done
    python3 tools/torch_skinny_ab.py --old chip_smoke_tmp/old \\
        [--out results.json] [--modes none,int8] [--stacks "v7 0.4B"]

``--old`` is a directory holding an earlier ``v7_decode.cu`` and the
headers it includes, with the earlier C interface of the product kernel
(``v7_skinny_matmul_launch(desc, n_prob, B, dtype, wbits, levels,
scratch, scratch_floats, counters, n_counters, stream)``: the split planned
in C, a device work space); it is built with ``nvcc`` (the port's flags)
into ``--build``.  Every ``v7_skinny_matmul`` launch of a layer of each
fused stack - RWKV-7 0.4B, RWKV-6 1B6 (token-shift LoRA 32 with its five
strided offsets, decay LoRA 64), RWKV-5 and RWKV-4 0.4B - with its big
projections plain bf16, int8, nf4, sf4 and int4 (the LoRA launches always
bf16), and each stack's two ``v7_ln_mix`` launches and the phased stacks'
``v7_ln_mix`` at B = 64, is timed at B = 8 in the order old, new, new, old
(CUDA events around a CUDA graph of launches whose weights rotate through
more than the 50 MB L2), beside ``torch.matmul`` on the bf16 products and
the bytes bound (each input read once, each output written once, over 3.35
TB/s).  Both kernels are first held to the plain versions.  Prints the
card's line, one line per launch and per layer, and one JSON object, which
it also writes to ``--out`` when given.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

B = 8
MODES = ("none", "int8", "nf4", "sf4", "int4")
# Epilogue kinds: (act, out, round_cd, output bytes per element).
KINDS = {"f32r": ("none", "f32", True, 4), "f32": ("none", "f32", False, 4),
         "cd": ("none", "cd", False, 2), "tanh": ("tanh", "cd", False, 2),
         "sigmoid_cd": ("sigmoid", "cd", False, 2),
         "wdecay": ("wdecay", "f32", False, 4),
         "sigmoid": ("sigmoid", "f32", True, 4),
         "silu": ("silu", "f32", False, 4), "expexp": ("expexp", "f32",
                                                       False, 4),
         "relu2": ("relu2", "cd", False, 2), "add": ("none", "add", False, 8),
         "gadd": ("none", "gadd", False, 12), "mix": ("none", "mix", False, 6),
         "sig_f32": ("sigmoid", "f32", False, 4)}


def stacks():
    """{stack: ({group: [(K, N, kind)]}, [(n_mix, with_xa_dx)], C)}: every
    product launch and ``v7_ln_mix`` launch of a layer; ``lora`` groups
    hold plain weights in every mode."""
    C, F = cs.C, cs.FFN
    lw = cs.LORA
    v7 = {"rkv": [(C, C, "f32r")] * 3,
          "lora_down": [(C, lw["w"], "tanh"), (C, lw["a"], "cd"),
                        (C, lw["v"], "cd"), (C, lw["g"], "sigmoid_cd")],
          "lora_up": [(lw["w"], C, "wdecay"), (lw["a"], C, "sigmoid"),
                      (lw["v"], C, "sigmoid"), (lw["g"], C, "f32")],
          "wo": [(C, C, "add")], "fkey": [(C, F, "relu2")],
          "fval": [(F, C, "add")]}

    def v56(C, F, first):
        return {"tm": first, "wo": [(C, C, "add")],
                "fkey_frec": [(C, F, "relu2"), (C, C, "sig_f32")],
                "fval": [(F, C, "gadd")]}

    C6, tm, td = cs.C6, cs.LORA6["tm"], cs.LORA6["td"]
    v6 = {"lora_mw1": [(C6, 5 * tm, "tanh")],
          "lora_mw2": [(tm, C6, "mix")] * 5,
          "lora_dw1": [(C6, td, "tanh")],
          **v56(C6, cs.F6, [(C6, C6, "f32r")] * 3 + [(C6, C6, "silu")]),
          "lora_dw2": [(td, C6, "expexp")]}
    return {
        "v7 0.4B": (v7, [(6, False), (1, False)], C),
        "v6 1B6": (v6, [(1, True), (2, False)], C6),
        "v5 0.4B": (v56(C, cs.F5, [(C, C, "f32r")] * 3 + [(C, C, "silu")]),
                    [(4, False), (2, False)], C),
        "v4 0.4B": (v56(C, cs.F4, [(C, C, "sig_f32")]
                        + [(C, C, "f32r")] * 2), [(3, False), (2, False)], C),
    }


def build_old(src: Path, out_dir: Path) -> ctypes.CDLL:
    from ai00_server_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libv7_decode_old.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o", str(lib),
         str(src / "v7_decode.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.v7_skinny_matmul_launch.argtypes = [P, I, I, I, I, P, P, I, P, I, P]
    dll.v7_ln_mix_launch.argtypes = [P] * 6 + [I] * 5 + [P]
    for f in (dll.v7_skinny_matmul_launch, dll.v7_ln_mix_launch):
        f.restype = I
    return dll


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--build", type=Path,
                    default=ROOT / "chip_smoke_tmp" / "ab_build")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--modes", default=",".join(MODES),
                    help="weight modes of the big projections to time")
    ap.add_argument("--stacks", default=None,
                    help="comma-separated stacks to time (default: all)")
    args = ap.parse_args()
    modes = [m for m in MODES if m in args.modes.split(",")]

    import torch

    from ai00_server_tpu_torch.ops import _build, quant
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.quant_matmul import levels_table

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    old_lib = build_old(args.old, args.build)
    _build.build_all()
    cd = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 10)
    scratch = torch.empty(1 << 23, dtype=torch.float32, device=dev)
    counters = torch.zeros(1 << 14, dtype=torch.int32, device=dev)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def old_matmul(products):
        table, outs, mode, rows, dev_ = fd.launch_table(
            products, ("none", *quant.MODES))
        four = mode in quant.LEVELS
        levels = levels_table(mode) if four else None
        status = old_lib.v7_skinny_matmul_launch(
            ctypes.addressof(table), len(products), rows, fd._DTYPE_CODE[cd],
            4 if four else 8 if mode != "none" else 0,
            ctypes.addressof(levels) if four else None, scratch.data_ptr(),
            scratch.numel(), counters.data_ptr(), counters.numel(),
            fd._stream(dev_))
        _build.check(status, "v7_skinny_matmul (old)")
        return outs

    def old_ln_mix(x, ln, shift, mix, active, with_xa_dx=False):
        base = 2 if with_xa_dx else 0
        Bx, Cx = x.shape
        out = torch.empty((base + mix.shape[0], Bx, Cx), dtype=cd, device=dev)
        status = old_lib.v7_ln_mix_launch(
            x.data_ptr(), ln.data_ptr(), shift.data_ptr(), mix.data_ptr(),
            active.data_ptr(), out.data_ptr(), Bx, Cx, mix.shape[0], base,
            fd._DTYPE_CODE[cd], fd._stream(dev))
        _build.check(status, "v7_ln_mix (old)")
        return out

    def close(got, want, rounded, what):
        err = float((got.float() - want.float()).abs().max())
        tol = cs.BF16_TOL if rounded else cs.KERNEL_TOL
        if err > tol * max(1.0, float(want.float().abs().max())):
            sys.exit(f"FAIL: {what} disagrees with its plain version: "
                     f"{err:.3e}")

    def turns(old, new, iters):
        t = {}
        for turn, fn in (("old", old), ("new", new), ("new", new),
                         ("old", old)):
            t.setdefault(turn, []).append(cs.device_ms(fn, iters))
        return t

    rows, layers = [], []
    for stack, (groups, ln_launches, C) in stacks().items():
        if args.stacks and stack not in args.stacks.split(","):
            continue
        for mode in modes:
            layer = {"stack": stack, "mode": mode, "old_ms": 0.0,
                     "new_ms": 0.0, "matmul_ms": 0.0, "bound_ms": 0.0}
            for gname, specs in groups.items():
                gmode = "none" if gname.startswith("lora") else mode
                wbytes = sum(K * N * (2 if gmode == "none" else 1 if
                                      gmode == "int8" else 0.5)
                             for K, N, _ in specs)
                n_sets = int(2 * cs.L2_BYTES // wbytes) + 1
                sets = []
                for _ in range(n_sets):
                    ws = [(rnd(K, N) / K ** 0.5) for K, N, _ in specs]
                    sets.append([dict(W=w.to(cd)) if gmode == "none" else
                                 (lambda q: dict(W=q.q, scale=q.scale,
                                                 mode=gmode))(
                                     quant.QUANTIZERS[gmode](w))
                                 for w in ws])
                    del ws
                if gname == "lora_mw2":  # five strided stages of one product
                    h = rnd(B, 5 * specs[0][0], scale=0.5).to(cd)
                    xs = [h[:, i * specs[0][0]:(i + 1) * specs[0][0]]
                          for i in range(5)]
                else:
                    xs = [rnd(B, K, scale=0.5).to(cd) for K, _, _ in specs]
                ys = [rnd(B, N) for _, N, _ in specs]
                ops = [dict(gate=torch.sigmoid(rnd(B, N)),
                            xa=rnd(B, N).to(cd), dx=rnd(B, N).to(cd),
                            mix=rnd(N, scale=0.3).to(cd)) for _, N, _ in specs]
                bias = [rnd(N, scale=0.5) for _, N, _ in specs]

                def prods(i, fresh=False, _sets=sets, _xs=xs, _ys=ys,
                          _ops=ops, _bias=bias, _specs=specs):
                    out = []
                    for j, (_, _, kind) in enumerate(_specs):
                        act, to, round_cd, _ = KINDS[kind]
                        y = _ys[j].clone() if fresh else _ys[j]
                        o = _ops[j]
                        out.append(fd.Product(
                            _xs[j], act=act, round_cd=round_cd, out=to,
                            bias=_bias[j] if act in ("wdecay", "expexp")
                            else None,
                            y=y if to in ("add", "gadd") else None,
                            gate=o["gate"] if to == "gadd" else None,
                            xa=o["xa"] if to == "mix" else None,
                            dx=o["dx"] if to == "mix" else None,
                            mix=o["mix"] if to == "mix" else None,
                            **_sets[i][j]))
                    return out

                what = f"{stack} {gname} {gmode}"
                want = fd.v7_skinny_matmul_plain(prods(0, True))
                for fn, tag in ((fd.v7_skinny_matmul, ""),
                                (old_matmul, " (old)")):
                    got = fn(prods(0, True))
                    torch.cuda.synchronize()
                    for g, w, (_, _, kind) in zip(got, want, specs):
                        _, to, round_cd, _ = KINDS[kind]
                        close(g, w, round_cd or to in ("cd", "mix"),
                              what + tag)
                t = turns(cs.rotating(lambda i: old_matmul(prods(i)), n_sets),
                          cs.rotating(lambda i: fd.v7_skinny_matmul(
                              prods(i)), n_sets), 40)
                lib_ms = (cs.device_ms(cs.rotating(
                    lambda i: [torch.matmul(x, s["W"]) for x, s in
                               zip(xs, sets[i])], n_sets), 40)
                    if gmode == "none" else None)
                s0 = sets[0]
                nb = sum(cs.nbytes(x, s["W"], s.get("scale"))
                         + B * N * KINDS[kind][3]
                         for x, s, (_, N, kind) in zip(xs, s0, specs))
                flops = sum(2 * B * K * N for K, N, _ in specs)
                b_ms, b_by = cs.bound(nb, flops, cs.BF16_FLOPS)
                shapes = [(K, N) for K, N, _ in specs]
                ln = fd.plan(shapes, B, gmode, cd)[0]
                mo, mn = sum(t["old"]) / 2, sum(t["new"]) / 2
                row = {"stack": stack, "group": gname, "mode": gmode,
                       "layer_mode": mode, "kernel": "v7_skinny_matmul",
                       "old_ms": t["old"], "new_ms": t["new"],
                       "matmul_ms": lib_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "bytes": nb, "cs": ln.cs,
                       "blocks": ln.cs * ln.clusters}
                rows.append(row)
                layer["old_ms"] += mo
                layer["new_ms"] += mn
                layer["bound_ms"] += b_ms
                if layer["matmul_ms"] is not None:
                    layer["matmul_ms"] = (layer["matmul_ms"] + lib_ms
                                          if lib_ms is not None else None)
                lib = f"{lib_ms:.5f}" if lib_ms is not None else "-"
                print(f"{what} {shapes}: old {mo:.5f} new {mn:.5f} ms "
                      f"({mo / mn:.2f}x; turns {t['old'][0]:.5f} "
                      f"{t['new'][0]:.5f} {t['new'][1]:.5f} "
                      f"{t['old'][1]:.5f}), torch.matmul {lib}, bound "
                      f"{b_ms:.5f} by {b_by} ({nb / mn / 1e6:.0f} GB/s); "
                      f"cs {ln.cs} x {ln.clusters} clusters", flush=True)
                del sets
            # The layer's two v7_ln_mix launches (the same in every mode).
            if mode == modes[0]:
                for n_mix, xa_dx in ln_launches:
                    rows.append(ln_mix_row(
                        stack, C, B, n_mix, xa_dx, rnd, old_ln_mix, fd,
                        close, turns))
            ln_rows = [r for r in rows if r["stack"] == stack
                       and r["kernel"] == "v7_ln_mix" and r["B"] == B]
            for r in ln_rows:
                layer["old_ms"] += sum(r["old_ms"]) / 2
                layer["new_ms"] += sum(r["new_ms"]) / 2
                layer["bound_ms"] += r["bound_ms"]
            layers.append(layer)
            mm = layer["matmul_ms"]
            print(f"LAYER {stack} {mode}: skinny + ln_mix old "
                  f"{layer['old_ms']:.5f} new {layer['new_ms']:.5f} ms "
                  f"({layer['old_ms'] / layer['new_ms']:.2f}x), "
                  f"torch.matmul on the products "
                  f"{'-' if mm is None else f'{mm:.5f}'}, bound "
                  f"{layer['bound_ms']:.5f}", flush=True)
    # The phased stacks' v7_ln_mix at B = 64.
    for C, n_mix, xa_dx in ((cs.C, 6, False), (cs.C6, 1, True),
                            (cs.C29, 6, False)):
        rows.append(ln_mix_row(f"B=64 C={C}", C, 64, n_mix, xa_dx, rnd,
                               old_ln_mix, fd, close, turns))
    result = {"card": card, "B": B, "rows": rows, "layers": layers}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


def ln_mix_row(stack, C, Bx, n_mix, xa_dx, rnd, old_ln_mix, fd, close,
               turns) -> dict:
    """One ``v7_ln_mix`` launch, old and new against the plain version
    (row 5 inactive), timed in turns."""
    import torch

    cd = torch.bfloat16
    dev = torch.device("cuda", 0)
    x, shift0 = rnd(Bx, C, scale=2.0), rnd(Bx, C)
    ln = torch.stack([1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]).to(cd)
    mix = rnd(n_mix, C, scale=0.3).to(cd)
    active = torch.ones(Bx, dtype=torch.bool, device=dev)
    active[5] = False
    want, want_shift = fd.v7_ln_mix_plain(x, ln, shift0, mix, active, xa_dx)
    what = f"{stack} v7_ln_mix({n_mix}{', xa dx' if xa_dx else ''})"
    for fn, tag in ((fd.v7_ln_mix, ""), (old_ln_mix, " (old)")):
        shift = shift0.clone()
        got = fn(x, ln, shift, mix, active, xa_dx)
        torch.cuda.synchronize()
        close(got, want, True, what + tag)
        close(shift, want_shift, False, what + tag + " shift")
    shift = shift0.clone()
    t = turns(lambda: old_ln_mix(x, ln, shift, mix, active, xa_dx),
              lambda: fd.v7_ln_mix(x, ln, shift, mix, active, xa_dx), 100)
    nb = (cs.nbytes(x, ln, mix, active) + 2 * cs.nbytes(shift)
          + (n_mix + 2 * xa_dx) * Bx * C * 2)
    b_ms, b_by = cs.bound(nb, (12 + 4 * (n_mix + 2 * xa_dx)) * Bx * C)
    mo, mn = sum(t["old"]) / 2, sum(t["new"]) / 2
    print(f"{what} B={Bx} C={C}: old {mo:.5f} new {mn:.5f} ms "
          f"({mo / mn:.2f}x; turns {t['old'][0]:.5f} {t['new'][0]:.5f} "
          f"{t['new'][1]:.5f} {t['old'][1]:.5f}), bound {b_ms:.5f} by "
          f"{b_by}", flush=True)
    return {"stack": stack, "group": f"ln_mix({n_mix})", "mode": "none",
            "kernel": "v7_ln_mix", "B": Bx, "C": C, "old_ms": t["old"],
            "new_ms": t["new"], "matmul_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nb}


if __name__ == "__main__":
    main()
