#!/usr/bin/env python3
"""A/B of the decode WKV kernels, ``v7_wkv_gn``, ``v6_wkv_gn`` and
``v4_wkv``: an earlier checkout of the port against this one, on one card,
in turns.

    mkdir -p chip_smoke_tmp/parent        # any directory git ignores
    git archive d64f725 ai00_server_tpu_torch chip_smoke.py \\
        | tar -x -C chip_smoke_tmp/parent
    python3 tools/torch_wkv_gn_ab.py --old chip_smoke_tmp/parent \\
        [--out results.json]

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
graph walks them all once).  Each is also held against its plain version
on the first state set, one row idle (max |kernel - plain| / max(1,
|plain|) over the state and the output).  Turns run old, new, new, old.

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


def child() -> dict:
    import torch

    import chip_smoke as cs

    from ai00_server_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    _build.build_all()
    out = {"ptxas": [line.strip() for name in ("v7_decode", "v6_decode",
                                               "wkv4")
                     for line in _build.ptxas_info.get(name, "").splitlines()
                     if "wkv" in line or "registers" in line]}
    for kind, H in KERNELS:
        for B in BATCHES:
            out[f"{kind} H={H} B={B}"] = time_case(cs, kind, B, H, dev)
    return out


def run_child(tree: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(tree.resolve())],
        capture_output=True, text=True, cwd=str(tree.resolve()))
    if proc.returncode != 0:
        sys.exit(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(child()))
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    turns = {"old": [], "new": []}
    for turn, tree in (("old", args.old), ("new", ROOT), ("new", ROOT),
                       ("old", args.old)):
        turns[turn].append(run_child(Path(tree)))
    rows = {}
    for name in [n for n in turns["new"][0] if n != "ptxas"]:
        old = [t[name]["ms"] for t in turns["old"]]
        new = [t[name]["ms"] for t in turns["new"]]
        errs = [t[name]["rel_err"] for t in turns["old"] + turns["new"]]
        rows[name] = {"old_ms": old, "new_ms": new,
                      "bound_ms": turns["new"][0][name]["bound_ms"],
                      "bound_by": turns["new"][0][name]["bound_by"],
                      "rel_err_old_new": errs}
        mo, mn = sum(old) / 2, sum(new) / 2
        print(f"{name}: old {mo:.5f} new {mn:.5f} ms ({mo / mn:.2f}x; turns "
              f"{old[0]:.5f} {new[0]:.5f} {new[1]:.5f} {old[1]:.5f}), bound "
              f"{rows[name]['bound_ms']:.5f} by {rows[name]['bound_by']}; "
              f"max rel err vs plain {max(errs):.2e}", flush=True)
    result = {"card": card, "rows": rows,
              "ptxas": {"old": turns["old"][0]["ptxas"],
                        "new": turns["new"][0]["ptxas"]}}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
