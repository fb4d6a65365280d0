#!/usr/bin/env python3
"""A/B of ``phased_matmul`` (``csrc/phased.cu``) against an earlier version
of its kernel, on one card, in turns.

    git show 1bdc8c9:ai00_server_tpu_torch/csrc/phased.cu \\
        > chip_smoke_tmp/old/phased.cu        # any directory git ignores
    python3 tools/torch_phased_ab.py --old chip_smoke_tmp/old/phased.cu \\
        [--out results.json]

``--old`` is a ``phased.cu`` with the earlier C interface
(``phased_matmul_launch(desc, n_prob, B, dtype, wbits, stream)``, the
launch planned in C); it is built with ``nvcc`` beside the current one
(the same flags and shared headers) into ``--build``.  Every launch of a
layer - the big projections in bf16, int8 and int4, the LoRA products
(always bf16) - at the RWKV-7 0.4B (C=1024, F=4096) and 2.9B (C=2560,
F=10240) widths, RWKV-5 0.4B (C=1024, F=3584) and the RWKV-6 1B6 layer
(C=2048, F=7168, token-shift LoRA 32 with its five strided offsets, decay
LoRA 64), at B = 16 and 64, is timed in the order old, new, new, old
(CUDA events around a CUDA graph of launches whose weights rotate through
more than the 50 MB L2), beside ``torch.matmul`` on the bf16 products, the
bytes bound (each input read once, each output written once, over 3.35
TB/s) and the x and weight bytes the current kernel's TMA boxes stage.
Both kernels are first held to the plain version.  Prints the card's line
and one JSON object, and writes it to ``--out`` when given.  Imports
nothing of JAX.
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

L2_BYTES = 50e6
MAX_SETS = 400


def layers():
    """{model: {group: [(K, N, epilogue)]}}: every product launch of a
    layer; ``lora`` groups hold plain weights in every mode."""
    def v7(C, F, lora):
        return {
            "rkv": [(C, C, "f32")] * 3,
            "lora_down": [(C, lora[k], "cd") for k in "wavg"],
            "lora_up": [(lora[k], C, "f32") for k in "wavg"],
            "wo": [(C, C, "add")], "fkey": [(C, F, "relu2")],
            "fval": [(F, C, "add")]}

    def v56(C, F):
        return {"rkvg": [(C, C, "f32")] * 4, "wo": [(C, C, "add")],
                "fkey_frec": [(C, F, "relu2"), (C, C, "f32")],
                "fval": [(F, C, "gadd")]}

    tm, td = cs.LORA6["tm"], cs.LORA6["td"]
    return {
        "v7 0.4B": v7(1024, 4096, {"w": 64, "a": 64, "v": 32, "g": 128}),
        "v7 2.9B": v7(cs.C29, cs.F29, cs.LORA29),
        "v5 0.4B": v56(1024, cs.F5),
        "v6 1B6": {"lora_mw1": [(cs.C6, 5 * tm, "cd")],
                   "lora_mw2": [(tm, cs.C6, "mix")] * 5,
                   "lora_dw1": [(cs.C6, td, "cd")],
                   "lora_dw2": [(td, cs.C6, "f32")],
                   **v56(cs.C6, cs.F6)},
    }


def build_old(src: Path, out_dir: Path) -> ctypes.CDLL:
    from ai00_server_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libphased_old.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.phased_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    dll.phased_matmul_launch.restype = ctypes.c_int
    return dll


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--build", type=Path,
                    default=ROOT / "chip_smoke_tmp" / "ab_build")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import torch

    from ai00_server_tpu_torch.ops import _build
    from ai00_server_tpu_torch.ops import phased_matmul as pm
    from ai00_server_tpu_torch.ops import quant
    from ai00_server_tpu_torch.ops import v7_decode as fd

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    old_lib = build_old(args.old, args.build)
    _build.build_all()
    cd = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 9)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def old_matmul(products):
        table, outs, mode, B, dev_ = fd.launch_table(products, pm.MODES)
        status = old_lib.phased_matmul_launch(
            ctypes.addressof(table), len(products), B, fd._DTYPE_CODE[cd],
            {"none": 0, "int8": 8, "int4": 4}[mode], fd._stream(dev_))
        _build.check(status, "phased_matmul (old)")
        return outs

    def close(got, want, specs, what):
        # Results rounded through bf16 (all but the in-place sums) are held
        # to one bf16 ulp of their largest value, as chip_smoke.py does.
        for g, w, (_, _, kind) in zip(got, want, specs):
            err = float((g.float() - w.float()).abs().max())
            tol = cs.KERNEL_TOL if kind in ("add", "gadd") else cs.BF16_TOL
            cs.check(err <= tol * max(1.0, float(w.float().abs().max())),
                     f"{what} disagrees with the plain version: {err:.3e}")

    rows = []
    for model, groups in layers().items():
        for gname, specs in groups.items():
            lora = gname.startswith("lora")
            for mode in ("bf16",) if lora else ("bf16", "int8", "int4"):
                pmode = "none" if mode == "bf16" else mode
                wbytes = sum(K * N * 2 for K, N, _ in specs)
                n_sets = min(MAX_SETS, int(2 * L2_BYTES // wbytes) + 1)
                iters = max(20, n_sets)
                sets = []
                for _ in range(n_sets):
                    ws = [(rnd(K, N) / K ** 0.5).to(cd) for K, N, _ in specs]
                    codes = (None if pmode == "none" else
                             [quant.QUANTIZERS[pmode](w) for w in ws])
                    sets.append((ws, codes))
                shapes = [(K, N) for K, N, _ in specs]
                for B in cs.PHASED_BS:
                    # The five token-shift offsets read strided views of one
                    # (B, 5 tm) tensor, as the v6 stack gives them.
                    if gname == "lora_mw2":
                        h = rnd(B, 5 * specs[0][0], scale=0.5).to(cd)
                        xs = [h[:, i * specs[0][0]:(i + 1) * specs[0][0]]
                              for i in range(5)]
                    else:
                        xs = [rnd(B, K, scale=0.5).to(cd) for K, _, _ in specs]
                    ys = [rnd(B, N) for _, N, _ in specs]
                    gate = [rnd(B, N) for _, N, _ in specs]
                    xa = [rnd(B, N).to(cd) for _, N, _ in specs]
                    dx = [rnd(B, N).to(cd) for _, N, _ in specs]
                    mix = [rnd(N).to(cd) for _, N, _ in specs]

                    def prods(i, fresh=False, _xs=xs, _ys=ys, _g=gate,
                              _xa=xa, _dx=dx, _mix=mix):
                        ws, codes = sets[i]
                        out = []
                        for j, (_, _, kind) in enumerate(specs):
                            w = dict(W=ws[j]) if codes is None else dict(
                                W=codes[j].q, scale=codes[j].scale,
                                mode=pmode)
                            y = _ys[j].clone() if fresh else _ys[j]
                            out.append(fd.Product(
                                _xs[j], act="relu2" if kind == "relu2" else
                                "none", round_cd=kind == "f32",
                                out="cd" if kind == "relu2" else kind,
                                y=y if kind in ("add", "gadd") else None,
                                gate=_g[j] if kind == "gadd" else None,
                                xa=_xa[j] if kind == "mix" else None,
                                dx=_dx[j] if kind == "mix" else None,
                                mix=_mix[j] if kind == "mix" else None,
                                **w))
                        return out

                    what = f"{model} {gname} {mode} B={B}"
                    want = pm.phased_matmul_plain(prods(0, True))
                    close(pm.phased_matmul(prods(0, True)), want, specs, what)
                    close(old_matmul(prods(0, True)), want, specs,
                          what + " (old)")
                    torch.cuda.synchronize()
                    new = lambda i: pm.phased_matmul(prods(i))  # noqa: E731
                    old = lambda i: old_matmul(prods(i))  # noqa: E731
                    t = {}
                    for turn, fn in (("old", old), ("new", new),
                                     ("new", new), ("old", old)):
                        t.setdefault(turn, []).append(cs.device_ms(
                            cs.rotating(fn, n_sets), iters))
                    lib_ms = cs.device_ms(cs.rotating(
                        lambda i: [torch.matmul(x, w) for x, w in
                                   zip(xs, sets[i][0])], n_sets), iters)
                    ws0, codes0 = sets[0]
                    nb = sum(
                        cs.nbytes(x) + (cs.nbytes(c.q, c.scale) if codes0
                                        else cs.nbytes(w))
                        + B * N * {"add": 8, "gadd": 12, "f32": 4,
                                   "mix": 6, "cd": 2, "relu2": 2}[kind]
                        for x, w, c, (_, N, kind) in zip(
                            xs, ws0, codes0 or ws0, specs))
                    flops = sum(2 * B * K * N for K, N, _ in specs)
                    b_ms, b_by = cs.bound(nb, flops, cs.BF16_FLOPS)
                    plan = pm.plan(shapes, B, pmode)
                    x_st, w_st = map(sum, zip(*(pm.staged_bytes(
                        ln, shapes, pmode) for ln in plan)))
                    row = {"model": model, "group": gname, "mode": mode,
                           "B": B, "old_ms": t["old"], "new_ms": t["new"],
                           "matmul_ms": lib_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "x_staged_bytes": x_st,
                           "w_staged_bytes": w_st, "cs": plan[0].cs,
                           "clusters": plan[0].clusters}
                    rows.append(row)
                    mo = sum(t["old"]) / 2
                    mn = sum(t["new"]) / 2
                    print(f"{what}: old {mo:.5f} new {mn:.5f} ms "
                          f"({mo / mn:.2f}x; turns {t['old'][0]:.5f} "
                          f"{t['new'][0]:.5f} {t['new'][1]:.5f} "
                          f"{t['old'][1]:.5f}), torch.matmul {lib_ms:.5f}, "
                          f"bound {b_ms:.5f} by {b_by}; cs {plan[0].cs} x "
                          f"{plan[0].clusters} clusters, x staged "
                          f"{x_st / w_st:.3f} of the weight boxes",
                          flush=True)
                del sets
    result = {"card": card, "rows": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
