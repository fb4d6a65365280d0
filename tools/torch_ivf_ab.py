#!/usr/bin/env python3
"""A/B of the IVF probe kernel ``ivf_score``: an earlier checkout of the
port against this one, on one card, in turns.

    mkdir -p chip_smoke_tmp/parent        # any directory git ignores
    git archive 8526b30 ai00_server_tpu_torch chip_smoke.py \\
        | tar -x -C chip_smoke_tmp/parent
    python3 tools/torch_ivf_ab.py --old chip_smoke_tmp/parent \\
        [--out results.json]

``--old`` is a directory holding an earlier ``ai00_server_tpu_torch/`` and
its ``chip_smoke.py``.  Each turn is a process of its own that imports one
tree, builds its kernels and ``chip_smoke.py``'s int8 index on the card
(``chip_smoke.ivf_data``: 2^20 x 1024 bf16 vectors from its seed, balanced
``kmeans_blocked`` with nlist 1024, ``StreamedIVFBuilder`` with cap 1296)
and times ``ivf_score`` with CUDA events around 10 calls captured in a CUDA
graph (``chip_smoke.device_ms``) at Q = 64 on four probe tables: the
queries' own probes at nprobe 8 and 16 (``_ivf_probe``), every query on
query 0's 8 clusters (``shared``: runs of 64), and every pair on a cluster
of its own (``distinct``: 512 clusters, no sharing).  Each is held against
``ivf_score_plain`` (ids and empty slots equal, scores within 1e-4 of
max(1, |plain|)).  Beside each time: its bound (the distinct probed
clusters' filled rows once, their ids and scales, the queries, the probe
table and the output over 3.35 TB/s) and the DRAM bytes each design
reads: one (query, probe) block at a time (every pair's filled rows, its
ids and scales) against a cluster at a time (the distinct clusters of each
group of 1024 pairs once).  Turns run old, new, new, old.

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
Q = 64
GROUP = 1024  # pairs a grouping block sorts (csrc/ivf.cu: GROUP)


def design_bytes(fill, probe, cap, D) -> dict:
    """DRAM bytes of the two designs on an int8 index: per pair (every
    pair reads its cluster's filled rows with their scales, and all cap
    ids: the parent's kernel) and per cluster (each distinct cluster of a group
    of GROUP pairs: its filled rows, every slot's id and scale), plus the
    outputs and the queries."""
    flat = probe.reshape(-1).long().cpu()
    fill = fill.cpu()
    per7 = fill.double() * (D + 4) + cap * 4  # scales of filled rows
    per = fill.double() * D + cap * 8         # every slot's id and scale
    common = flat.numel() * cap * 8 + probe.shape[0] * D * 4
    grouped = sum(float(per[flat[i:i + GROUP].unique()].sum())
                  for i in range(0, flat.numel(), GROUP))
    return {"pair_bytes": float(per7[flat].sum()) + common,
            "cluster_bytes": grouped + common}


def child() -> dict:
    import torch

    import chip_smoke as cs

    from ai00_server_tpu_torch.ops import _build
    from ai00_server_tpu_torch.ops import retrieval as R

    dev = torch.device("cuda", 0)
    _build.build_all()
    out = {"ptxas": [line.strip() for line in _build.ptxas_info.get(
        "ivf", "").splitlines() if "registers" in line or "smem" in line]}
    data, q, gen = cs.ivf_data(dev)
    cent, cbias = R.kmeans_blocked(data[:cs.IVF_TRAIN * cs.IVF_CHUNK],
                                   cs.IVF_NLIST, iters=8, blk=cs.IVF_CHUNK,
                                   balance=True, generator=gen)
    mean = cs.IVF_N / cs.IVF_NLIST
    cap = int(mean + 8.0 * mean ** 0.5 + 16)
    builder = R.StreamedIVFBuilder(cent, cap=cap, dim=cs.IVF_D, spill=8,
                                   cbias=cbias)
    for i in range(0, cs.IVF_N, cs.IVF_CHUNK):
        builder.add(data[i:i + cs.IVF_CHUNK], i)
    ivf = builder.finish()
    del data, builder
    fill = (ivf.packed_ids >= 0).sum(-1)
    qf8, probe8 = R._ivf_probe(ivf.centroids, q[:Q], 8, ivf.cbias)
    _, probe16 = R._ivf_probe(ivf.centroids, q[:Q], 16, ivf.cbias)
    cases = {
        "nprobe 8": probe8, "nprobe 16": probe16,
        "shared": probe8[:1].expand(Q, 8).contiguous(),
        "distinct": torch.arange(Q * 8, device=dev,
                                 dtype=torch.int32).reshape(Q, 8),
    }
    for name, probe in cases.items():
        args = (ivf.packed, ivf.packed_ids, ivf.pscale, qf8, probe)
        s_k, i_k = R.ivf_score(*args)
        s_p, i_p = R.ivf_score_plain(*args)
        torch.cuda.synchronize()
        fin = torch.isfinite(s_p)
        ok = torch.equal(i_k, i_p) and torch.equal(torch.isfinite(s_k), fin)
        err = float((s_k[fin] - s_p[fin]).abs().max()) / max(
            1.0, float(s_p[fin].abs().max()))
        b = cs.ivf_bound(ivf, probe, 1, cs.IVF_D)
        out[name] = {"ms": cs.device_ms(lambda: R.ivf_score(*args), 10),
                     "rel_err": err if ok else float("inf"),
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                     "distinct": b["distinct"],
                     **design_bytes(fill, probe, cap, cs.IVF_D)}
        if hasattr(R, "ivf_group"):  # the grouping launch alone
            out[name]["group_ms"] = cs.device_ms(
                lambda: R.ivf_group(probe, cs.IVF_NLIST), 10)
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
        new0 = turns["new"][0][name]
        old = [t[name]["ms"] for t in turns["old"]]
        new = [t[name]["ms"] for t in turns["new"]]
        errs = [t[name]["rel_err"] for t in turns["old"] + turns["new"]]
        rows[name] = {"old_ms": old, "new_ms": new, "rel_err_old_new": errs,
                      **{k: new0[k] for k in ("bound_ms", "bound_by",
                                              "distinct", "pair_bytes",
                                              "cluster_bytes")}}
        mo, mn = sum(old) / 2, sum(new) / 2
        if "group_ms" in new0:
            rows[name]["group_ms"] = new0["group_ms"]
        print(f"ivf_score {name}: old {mo:.5f} new {mn:.5f} ms "
              f"({mo / mn:.2f}x; turns {old[0]:.5f} {new[0]:.5f} "
              f"{new[1]:.5f} {old[1]:.5f}); bound {new0['bound_ms']:.5f} by "
              f"{new0['bound_by']} ({new0['distinct']} distinct clusters); "
              f"bytes a pair at a time {new0['pair_bytes'] / 1e6:.1f} MB, a "
              f"cluster at a time {new0['cluster_bytes'] / 1e6:.1f} MB; max "
              f"rel err vs plain {max(errs):.2e}; the grouping alone "
              f"{new0.get('group_ms', float('nan')):.5f} ms", flush=True)
    result = {"card": card, "rows": rows,
              "ptxas": {"old": turns["old"][0]["ptxas"],
                        "new": turns["new"][0]["ptxas"]}}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
