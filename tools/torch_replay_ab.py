#!/usr/bin/env python3
"""A/B of the fused decode stacks' CUDA-graph replay: an earlier checkout of
the port against this one, on one card, in turns.

    mkdir -p chip_smoke_tmp/parent        # any directory git ignores
    git archive d64f725 ai00_server_tpu_torch chip_smoke.py \\
        | tar -x -C chip_smoke_tmp/parent
    python3 tools/torch_replay_ab.py --old chip_smoke_tmp/parent \\
        [--out results.json]

``--old`` is a directory holding an earlier ``ai00_server_tpu_torch/`` and
its ``chip_smoke.py``.  Each turn is a process of its own that imports one
tree, builds its kernels, and times one step of every fused stack at B = 8
with all rows active (``chip_smoke.time_replay``: CUDA events around 20
replays of the stack's ``DecodeGraph``): RWKV-7 0.4B at 24 layers in bf16,
int8 and nf4, RWKV-5 0.4B at 24 layers in bf16, RWKV-4 0.4B at 24 layers
in bf16, int8 and nf4, RWKV-6 1B6 at ``chip_smoke.L6`` layers in bf16, int8
and nf4; and the phased stacks
(``ops/v7_phased``, ``ops/v56_phased``) at B = 64: RWKV-7 0.4B in int8 and
bf16, RWKV-5 0.4B and RWKV-6 1B6 in bf16 (``--batches`` picks 8, 64 or
both).  Weights are random from a
seed, one layer drawn on the host and the big projections of every layer
drawn anew on the card (the v6 / v5 / v4 ones scaled by their fan-in);
codes are quantized on the card.  Turns run old, new, new, old.  Prints
the card's line and one JSON object (also written to ``--out``).  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (version, weight mode, B): B = 8 the fused stacks, 64 the phased ones.
STACKS = [("v7", None, 8), ("v7", "int8", 8), ("v7", "nf4", 8),
          ("v5", None, 8), ("v4", None, 8), ("v4", "int8", 8),
          ("v4", "nf4", 8), ("v6", None, 8), ("v6", "int8", 8),
          ("v6", "nf4", 8),
          ("v7", "int8", 64), ("v7", None, 64), ("v5", None, 64),
          ("v6", None, 64)]


def child(batches) -> dict:
    """Time every stack of ``STACKS`` at ``batches`` with the tree on
    sys.path[0]."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import get_version_module
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.testing import make_raw_weights

    dev = torch.device("cuda", 0)
    out = {}
    built = {}
    for version, mode, B in STACKS:
        if B not in batches:
            continue
        L = cs.L6 if version == "v6" else 24
        info = cs.model_info(L, version)
        fd = fused_decode.module_for(info.version.value)
        if version not in built:
            one = cs.model_info(1, version)
            raw = make_raw_weights(one, seed=cs.SEED + 11, dtype=np.float32,
                                   lora_dims=cs.lora_dims(version))
            if version != "v7":
                raw = cs.fan_in_scaled(raw)
            params = stack_params(one, raw, dtype=torch.bfloat16, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(cs.SEED + 11)
            base = params["layers"][0]
            layers = []
            for _ in range(L):
                layer = {**base, "att": dict(base["att"]),
                         "ffn": dict(base["ffn"])}
                for part, key in fd._BIG_SRC.values():
                    K, N = layer[part][key].shape
                    layer[part][key] = (torch.randn(
                        K, N, generator=gen, device=dev) / K ** 0.5).to(
                        torch.bfloat16)
                layers.append(layer)
            params["layers"] = layers
            params[fd.FUSED_KEY] = fd.make_fused_layout(params)
            built = {version: params}
        params = built[version]
        p = params if mode is None else cs.quantized_params(
            params, info.version.value, mode)
        state = get_version_module(info.version).init_state(info, B,
                                                            device=dev)
        for t in state.values():
            t.copy_(torch.randn(t.shape, generator=torch.Generator(
                device=dev).manual_seed(3), device=dev) * 0.3)
        stack = fused_decode.stack_for(info.version.value, p, B)
        graph = stack.DecodeGraph(p, state, B)
        r = cs.time_replay(stack, p, state, graph, B, fd.FUSED_KEY)
        out[f"{version} {mode or 'bf16'} L={L} B={B}"] = {
            "replay_ms": r["replay_ms"], "bound_ms": r["bound_ms"],
            "kernels": r["kernels_per_replay"],
            "launch_sum_ms": r.get("launch_sum_ms"),
            "busy_ms": r.get("busy_ms")}
        del graph, state, p
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if len(sys.argv) > 3 and sys.argv[1] == "--child":
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(child([int(b) for b in sys.argv[3].split(",")])))
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--batches", default="8,64",
                    help="8 (fused stacks), 64 (phased) or 8,64")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    turns = {"old": [], "new": []}
    for turn, tree in (("old", args.old), ("new", ROOT), ("new", ROOT),
                       ("old", args.old)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(Path(tree).resolve()), args.batches], capture_output=True,
            text=True,
            cwd=str(Path(tree).resolve()))
        if proc.returncode != 0:
            sys.exit(f"the {turn} turn failed:\n{proc.stderr[-4000:]}")
        turns[turn].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    rows = {}
    for name in turns["new"][0]:
        old = [t[name]["replay_ms"] for t in turns["old"]]
        new = [t[name]["replay_ms"] for t in turns["new"]]
        rows[name] = {"old_ms": old, "new_ms": new,
                      "bound_ms": turns["new"][0][name]["bound_ms"],
                      "kernels": turns["new"][0][name]["kernels"],
                      "launch_sum_ms": turns["new"][0][name]["launch_sum_ms"],
                      "busy_ms": turns["new"][0][name]["busy_ms"]}
        mo, mn = sum(old) / 2, sum(new) / 2
        print(f"{name}: old {mo:.5f} new {mn:.5f} ms per replay "
              f"({mo / mn:.2f}x; turns {old[0]:.5f} {new[0]:.5f} "
              f"{new[1]:.5f} {old[1]:.5f}), bound "
              f"{rows[name]['bound_ms']:.5f}", flush=True)
    result = {"card": card, "rows": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
