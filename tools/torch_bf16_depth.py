#!/usr/bin/env python3
"""How far a deep RWKV-7 stack in bf16 carries its roundings, per weight
recipe, and how much a custom initial state moves its logits.

    python3 tools/torch_bf16_depth.py [--layers 24] [--width 256]
        [--device cpu] [--out depth.json]

For random weights (``testing.make_raw_weights``, every matrix at std
0.4) and for ``chip_smoke.lasting`` (the matrices scaled by their fan-in,
``w0`` at -6), builds an RWKV-7 of ``--layers`` layers and ``--width``
channels (head 64, FFN 4x, vocabulary 4096) in f32 and in bf16, feeds both
a 40-token prompt from a state of 0.3 x standard normal (the smoke's
tuned state) and from zeros, and prints per recipe: max |bf16 - f32| /
max |f32| of the last logits and of the state (the bf16 roundings the
stack carries), and the same between the logits from the tuned state and
from zeros (how much the state steers).  The plain layer path
(``models/v7.forward``); on the CPU by default, at a narrow width: a
full-width check belongs on the card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out")
    args = ap.parse_args()

    import numpy as np
    import torch

    from ai00_server_tpu_torch.engine import head_logits
    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import v7
    from ai00_server_tpu_torch.models.common import take_last_valid
    from ai00_server_tpu_torch.models.info import ModelInfo, ModelVersion
    from ai00_server_tpu_torch.testing import make_raw_weights
    from chip_smoke import lasting

    L, C, V, T = args.layers, args.width, 4096, 40
    info = ModelInfo(version=ModelVersion("V7"), num_layer=L, num_emb=C,
                     num_hidden=4 * C, num_vocab=V, num_head=C // 64,
                     head_size=64)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, V, (1, T))).to(args.device)
    tuned = torch.from_numpy(rng.standard_normal(
        (L, 1, C // 64, 64, 64)).astype(np.float32) * 0.3).to(args.device)
    lens = torch.tensor([T], device=args.device)
    out = {}
    for name, recipe in (("random", lambda raw: raw), ("lasting", lasting)):
        raw = recipe(make_raw_weights(
            info, seed=3, dtype=np.float32,
            lora_dims={"w": 16, "a": 16, "v": 8, "g": 32}))
        runs = {}
        for dtype in (torch.float32, torch.bfloat16):
            p = stack_params(info, raw, dtype=dtype, device=args.device)
            for init in ("zero", "tuned"):
                st = v7.init_state(info, 1, device=args.device)
                if init == "tuned":
                    st["wkv"] = tuned.clone()
                h, st = v7.forward(p, st, toks, lens)
                runs[dtype, init] = (head_logits(
                    p, take_last_valid(h, lens)).float().cpu(),
                    {k: t.float().cpu() for k, t in st.items()})
        f32, b16 = runs[torch.float32, "tuned"], runs[torch.bfloat16, "tuned"]
        out[name] = {
            "bf16_logits": rel(b16[0], f32[0]),
            "bf16_state": max(rel(b16[1][k], f32[1][k]) for k in f32[1]),
            "state_steers_logits": rel(f32[0],
                                       runs[torch.float32, "zero"][0]),
        }
        r = out[name]
        print(f"{name} (L={L}, C={C}, {args.device}): bf16 against f32 "
              f"logits {r['bf16_logits']:.3e}, state {r['bf16_state']:.3e};"
              f" the tuned state against zeros moves the logits "
              f"{r['state_steers_logits']:.3e}", flush=True)
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
