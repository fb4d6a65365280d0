#!/usr/bin/env python3
"""A/B of the decode WKV kernels, ``v7_wkv_gn``, ``v6_wkv_gn``, ``v4_wkv``
and the layer path's ``wkv7_t1``: an earlier checkout of the port against
this one, on one card, in turns.

    mkdir -p chip_smoke_tmp/parent        # any directory git ignores
    git archive 8526b30 ai00_server_tpu_torch chip_smoke.py \\
        | tar -x -C chip_smoke_tmp/parent
    python3 tools/torch_wkv_gn_ab.py --old chip_smoke_tmp/parent \\
        [--only t1] [--layer] [--splits] [--out results.json]

``--old`` is a directory holding an earlier ``ai00_server_tpu_torch/`` and
its ``chip_smoke.py``.  Each turn is a process of its own that imports one
tree, builds its kernels and times them in bf16 with every row active, with
CUDA events around launches captured in a CUDA graph
(``chip_smoke.device_ms``) on states that rotate past the 50 MB L2, at B =
1, 8, 16 and 64: ``v7_wkv_gn`` at the RWKV-7 0.4B width (H = 16) and the
2.9B one (H = 40), ``v6_wkv_gn`` at the RWKV-6 1B6 width (H = 32, dense
decay, rounding ``ln_x`` as the fused stacks do) and at the RWKV-5 0.4B one
(H = 16, static decay), ``v4_wkv`` at the RWKV-4 0.4B one (C = 1024; its
(aa, bb, pp) is small, so each call takes the next of the states and a
graph walks them all once).  ``wkv7_t1`` at H = 16 and B = 1, 8 and 64
twice: ``t1 f32`` the kernel alone on f32 vectors, ``t1 call`` the whole
call on the vectors the layer path holds (r, k, v, kk, a bf16, w f32;
an earlier wrapper casts them first), timed in the graph on states that
rotate through twice the L2 (``chip_smoke.py``'s rotation) and on one
state and, as ``call_ms``, back to back from Python.  Each is also held against its
plain version on the first state set, one row idle (max |kernel - plain| /
max(1, |plain|) over the state and the output).  Turns run old, new, new,
old.  ``--only t1`` (or ``gn``) narrows the kernels; ``--layer`` adds the
v7 layer path's decode step (``models/v7.forward`` at B = 1, T = 1, the
0.4B shape at 24 layers, the first 12 int8 as ``quant = 12`` serves it;
host clock, a reading: the path is host-bound); ``--splits`` times this
tree's ``wkv7_t1`` at each split of a head (``ops/wkv_t1.plan`` forced)
after the turns.

Prints the card's line (``nvidia-smi``) and one JSON object (also written
to ``--out``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (kind, H): v4 has no heads, H = 16 gives its width C = 1024.
KERNELS = [("v7", 16), ("v7", 40), ("v6", 32), ("v5", 16), ("v4", 16)]
BATCHES = (1, 8, 16, 64)
T1_BATCHES = (1, 8, 64)
# The layer path's vector dtypes, r w k v kk a: w stays f32 (models/v7.py).
T1_LAYER = ("bf16", "f32", "bf16", "bf16", "bf16", "bf16")


def case(kind, B, H, dev, seed):
    """(kernel(S) -> out, plain(S) -> (out, S_new), bytes, the state's
    bytes, active, the state's shape) for one shape: every row active but
    row 1 where B > 1 for the held check (``active`` is returned for the
    caller to reset).  v4's state S is (3, B, C): aa, bb, pp."""
    import torch

    from ai00_server_tpu_torch.ops import v4_decode as fd4
    from ai00_server_tpu_torch.ops import v6_decode as fd6
    from ai00_server_tpu_torch.ops import v7_decode as fd

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    C, cd = H * 64, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    active = torch.ones(B, dtype=torch.bool, device=dev)
    if kind == "v4":
        r = torch.sigmoid(rnd(B, C))
        k, v = rnd(B, C), rnd(B, C)
        vecs = torch.stack([-torch.exp(rnd(C, scale=0.5)),
                            rnd(C, scale=0.5)])

        def kernel(S):
            return fd4.v4_wkv(r, k, v, vecs, active, *S, cd)

        def plain(S):
            out, *new = fd4.v4_wkv_plain(r, k, v, vecs, active, *S, cd)
            return out, torch.stack(new)
        state_bytes = 3 * B * C * 4
        return (kernel, plain, 3 * B * C * 4 + 2 * C * 4 + B * C * 2 + B,
                state_bytes, active, (3, B, C))
    if kind == "v7":
        r, k, v, g, vf = (rnd(B, C, scale=0.5) for _ in range(5))
        w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, C)))
        a, vmix = torch.sigmoid(rnd(B, C)), torch.sigmoid(rnd(B, C))
        vecs = rnd(8, C, scale=0.5)
        args = (r, k, v, w, a, g, vmix, vf, vecs, active)

        def kernel(S):
            return fd.v7_wkv_gn(*args, S, False, cd)

        def plain(S):
            return fd.v7_wkv_gn_plain(*args, S, False, cd)[:2]
        vec_bytes = 8 * B * C * 4 + 5 * C * 4
    else:
        r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
        g = torch.nn.functional.silu(rnd(B, C))
        vecs = rnd(4, C, scale=0.5)
        w = None
        if kind == "v5":
            vecs[0] = torch.exp(-torch.exp(vecs[0]))
        else:
            w = torch.exp(-torch.exp(rnd(B, C, scale=0.5)))
        args = (r, k, v, w, g, vecs, active)

        def kernel(S):
            return fd6.v6_wkv_gn(*args, S, cd)

        def plain(S):
            return fd6.v6_wkv_gn_plain(*args, S, cd)
        vec_bytes = (5 if w is not None else 4) * B * C * 4 + 3 * C * 4
    state_bytes = B * H * 64 * 64 * 4
    return (kernel, plain, vec_bytes + B * C * 2, state_bytes, active,
            (B, H, 64, 64))


def time_case(cs, kind, B, H, dev) -> dict:
    import torch

    kernel, plain, other_bytes, state_bytes, active, shape = case(
        kind, B, H, dev, 1000 * B + H)
    n = max(3, int(cs.L2_BYTES // state_bytes) + 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(B + H)
    states = [torch.randn(*shape, generator=gen, device=dev)
              for _ in range(n)]
    if kind == "v4":
        for S in states:
            S[1].abs_().add_(0.5)  # bb > 0
    # The batch row of a state: v4's is its second dimension.
    row = (lambda S, b: S[:, b]) if kind == "v4" else (lambda S, b: S[b])
    out = {}
    if B > 1:
        active[1] = False
    S = states[0].clone()
    want, S_want = plain(S)
    torch.cuda.synchronize()  # the state is read before the kernel waits
    got = kernel(S)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in ((got, want), (S, S_want)):
        e = float((a.float() - b.float()).abs().max())
        err = max(err, e / max(1.0, float(b.float().abs().max())))
    if B > 1 and not torch.equal(row(S, 1), row(states[0], 1)):
        err = float("inf")  # an idle row's state moved
    out["rel_err"] = err
    active.fill_(True)
    # v4's graph walks all its states once (n is ~L2 / 12 KB at B = 1).
    iters = n if kind == "v4" else max(100, min(n, 400))
    out["ms"] = cs.device_ms(cs.rotating(lambda i: kernel(states[i]), n),
                             iters)
    flops = 25 * B * H * 64 if kind == "v4" else 9 * state_bytes / 4
    out["bound_ms"], out["bound_by"] = cs.bound(
        2 * state_bytes + other_bytes, flops)
    del states
    torch.cuda.empty_cache()
    return out


def time_t1(cs, B, vec_dtypes, dev, call: bool) -> dict:
    """``wkv7_t1`` at H = 16 on ``vec_dtypes``, every row active: device
    ms in a graph on states rotating past the L2 and on one state, with
    ``call`` also ms back to back from Python; held first against its
    plain version on the first state with row 1 idle (the state
    synchronised: the kernel reads it before it waits)."""
    import torch

    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1, wkv7_t1_plain

    H = 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(7 * B + len(vec_dtypes))
    S, seqs = cs.wkv_inputs(gen, B, 1, H, 64, dev)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    vecs = [x[:, 0].to(dts[d]).contiguous() for x, d in zip(seqs, vec_dtypes)]
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    if B > 1:
        mask[1] = False
    state_bytes = B * H * 64 * 64 * 4
    n = int(2 * cs.L2_BYTES // state_bytes) + 1  # chip_smoke.py's rotation
    states = [S] + [torch.randn(S.shape, generator=gen, device=dev)
                    for _ in range(n - 1)]
    torch.cuda.synchronize()
    S_k, y_k = wkv7_t1(S, *vecs, mask)
    S_p, y_p = wkv7_t1_plain(S, *vecs, mask)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in ((S_k, S_p), (y_k, y_p)):
        e = float((a - b).abs().max())
        err = max(err, e / max(1.0, float(b.abs().max())))
    if B > 1 and not torch.equal(S_k[1], S[1]):
        err = float("inf")  # an idle row's state moved
    mask.fill_(True)  # timed with every row active
    out = {"rel_err": err,
           "ms": cs.device_ms(cs.rotating(
               lambda i: wkv7_t1(states[i], *vecs, mask), n),
               max(100, min(n, 400))),
           "same_state_ms": cs.device_ms(lambda: wkv7_t1(S, *vecs, mask),
                                         100)}
    if call:
        out["call_ms"] = cs.call_ms(lambda: wkv7_t1(S, *vecs, mask), 400)
    vec_bytes = sum(v.numel() * v.element_size() for v in vecs)
    out["bound_ms"], out["bound_by"] = cs.bound(
        2 * state_bytes + vec_bytes + B + B * H * 64 * 4,
        9 * state_bytes / 4)
    del states
    torch.cuda.empty_cache()
    return out


def time_layer_path(cs, dev) -> dict:
    """ms per decode step of ``models/v7.forward`` on the layer path: the
    0.4B shape at 24 layers, layers 0-11 int8, B = 1, T = 1, 40 steps after
    5 warm-up ones, host clock around each synchronised step."""
    import time

    import numpy as np
    import torch

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import v7
    from ai00_server_tpu_torch.testing import make_raw_weights

    info = cs.model_info(24, "v7")
    math = make_raw_weights(info, seed=cs.SEED, dtype=np.float32,
                            lora_dims=cs.LORA)
    params = stack_params(info, math, torch.bfloat16, dev,
                          quant={i: "int8" for i in range(12)})
    del math
    state = v7.init_state(info, 1, device=dev)
    tok = torch.ones((1, 1), dtype=torch.long, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    times = []
    for step in range(45):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = v7.forward(params, state, tok, lengths)
        torch.cuda.synchronize()
        if step >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"median_ms": times[len(times) // 2], "min_ms": times[0],
            "tokens_per_s": 1e3 / times[len(times) // 2]}


def child(only: str, layer: bool) -> dict:
    import torch

    import chip_smoke as cs

    from ai00_server_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    out = {"ptxas": [line.strip() for name in ("v7_decode", "v6_decode",
                                               "wkv4", "wkv7")
                     for line in _build.ptxas_info.get(name, "").splitlines()
                     if "wkv" in line or "registers" in line]}
    if only != "t1":
        for kind, H in KERNELS:
            for B in BATCHES:
                out[f"{kind} H={H} B={B}"] = time_case(cs, kind, B, H, dev)
    if only != "gn":
        for B in T1_BATCHES:
            out[f"t1 f32 B={B}"] = time_t1(cs, B, ("f32",) * 6, dev, False)
            out[f"t1 call B={B}"] = time_t1(cs, B, T1_LAYER, dev, True)
    if layer:
        out["layer path"] = time_layer_path(cs, dev)
    return out


def splits() -> dict:
    """This tree's ``wkv7_t1`` at each split of a head, f32 vectors."""
    import torch

    import chip_smoke as cs

    from ai00_server_tpu_torch.ops import wkv_t1

    dev = torch.device("cuda", 0)
    out = {}
    for slices in wkv_t1.SPLITS:
        wkv_t1.plan = lambda B, H, sms, s=slices: s
        for B in T1_BATCHES:
            out[f"t1 f32 B={B} slices={slices}"] = time_t1(
                cs, B, ("f32",) * 6, dev, False)
    return out


def run_child(tree: Path, *flags: str) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(tree.resolve()), *flags],
        capture_output=True, text=True, cwd=str(tree.resolve()))
    if proc.returncode != 0:
        sys.exit(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.path.insert(0, sys.argv[2])
        if "--splits" in sys.argv[3:]:
            print(json.dumps(splits()))
            return
        only = sys.argv[3]
        print(json.dumps(child(only, "--layer" in sys.argv[4:])))
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--only", choices=("all", "gn", "t1"), default="all")
    ap.add_argument("--layer", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    flags = [args.only] + (["--layer"] if args.layer else [])
    turns = {"old": [], "new": []}
    for turn, tree in (("old", args.old), ("new", ROOT), ("new", ROOT),
                       ("old", args.old)):
        turns[turn].append(run_child(Path(tree), *flags))
    rows = {}
    for name in [n for n in turns["new"][0]
                 if n not in ("ptxas", "layer path")]:
        old = [t[name]["ms"] for t in turns["old"]]
        new = [t[name]["ms"] for t in turns["new"]]
        errs = [t[name]["rel_err"] for t in turns["old"] + turns["new"]]
        rows[name] = {"old_ms": old, "new_ms": new,
                      "bound_ms": turns["new"][0][name]["bound_ms"],
                      "bound_by": turns["new"][0][name]["bound_by"],
                      "rel_err_old_new": errs}
        extra = ""
        if "same_state_ms" in turns["new"][0][name]:
            rows[name]["old_same_state_ms"] = [t[name]["same_state_ms"]
                                               for t in turns["old"]]
            rows[name]["new_same_state_ms"] = [t[name]["same_state_ms"]
                                               for t in turns["new"]]
            extra = (f"; one state old {rows[name]['old_same_state_ms']} "
                     f"new {rows[name]['new_same_state_ms']}")
        if "call_ms" in turns["new"][0][name]:
            rows[name]["old_call_ms"] = [t[name]["call_ms"]
                                         for t in turns["old"]]
            rows[name]["new_call_ms"] = [t[name]["call_ms"]
                                         for t in turns["new"]]
            extra += (f"; back to back old {rows[name]['old_call_ms']} new "
                      f"{rows[name]['new_call_ms']}")
        mo, mn = sum(old) / 2, sum(new) / 2
        print(f"{name}: old {mo:.5f} new {mn:.5f} ms ({mo / mn:.2f}x; turns "
              f"{old[0]:.5f} {new[0]:.5f} {new[1]:.5f} {old[1]:.5f}), bound "
              f"{rows[name]['bound_ms']:.5f} by {rows[name]['bound_by']}; "
              f"max rel err vs plain {max(errs):.2e}{extra}", flush=True)
    if args.layer:
        rows["layer path"] = {"old": [t["layer path"] for t in turns["old"]],
                              "new": [t["layer path"] for t in turns["new"]]}
        print("layer path (24 layers, 12 int8, B=1): ms a step old "
              + ", ".join(f"{t['median_ms']:.3f}" for t in
                          rows["layer path"]["old"]) + " new "
              + ", ".join(f"{t['median_ms']:.3f}" for t in
                          rows["layer path"]["new"]), flush=True)
    if args.splits:
        rows["splits"] = run_child(ROOT, "--splits")
        for name, r in rows["splits"].items():
            print(f"{name}: {r['ms']:.5f} ms (bound {r['bound_ms']:.5f})",
                  flush=True)
    result = {"card": card, "rows": rows,
              "ptxas": {"old": turns["old"][0]["ptxas"],
                        "new": turns["new"][0]["ptxas"]}}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
