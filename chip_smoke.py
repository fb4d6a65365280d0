#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``ai00_server_tpu_torch`` (never ``jax`` or ``ai00_server_tpu``) on
the card, in four phases, and exits non-zero at the first failure (every
kernel's source is built first, one ``nvcc`` each, all started together):

1. Card and build: the card's name and power limit, then ``nvcc`` builds
   every kernel of the port from ``ai00_server_tpu_torch/csrc/``, and
   ``tools/torch_sass_loads.py`` reads the loads of ``v4_wkv_kernel``,
   ``wkv7_t1_kernel`` and ``wkv56_t1_kernel`` (programmatic dependents) in
   their machine code: only v4's two weight rows may go through
   ``ld.global.nc``.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with times from CUDA events and the
   least time the card could take (the larger of bytes over 3.35 TB/s and
   operations over the peak for their type: 67 TFLOP/s f32, 989 TFLOP/s
   bf16 products; from this run's inputs).  The WKV kernels (``wkv7_t1``
   on states rotating past the L2, and on one state, held and timed at
   B = 8 and 1 on f32 vectors and on the layer path's bf16 ones; the prefill
   chunk also with every decay at v7's floor, and timed at B = 8 and 1,
   T = 256 and 16), then the three kernels of the fused decode step
   (``csrc/v7_decode.cu``) on weights that rotate through more than the L2
   cache holds, then three ways to take the LM head's f32 logits, then the
   int8 kernels
   (``csrc/quant.cu``: ``matmul_int8`` on the LM head, ``matmul_int8_l`` and
   ``ffn7_t1_l`` on stacked codes, each held at every row tile of its plan,
   ``HELD_ROWS``; the head timed at B = 8 and 64, a 256-row product) and
   the int8 mode of ``v7_skinny_matmul``, on codes that rotate the same
   way, then the 4-bit kernels (``matmul_4bit`` on unstacked codes,
   ``matmul_4bit_l`` and the 4-bit mode of ``ffn7_t1_l`` on stacked codes,
   at ``HELD_ROWS``, the 4-bit mode of ``v7_skinny_matmul``) in nf4, sf4
   and int4, f32 and bf16.  Then
   RWKV-6 at the 1B6 width (C=2048, H=32, F=7168): ``wkv56_t1`` (held at
   every split of a head on f32 vectors and on the layer path's bf16 ones,
   timed alone and as the whole call on the latter) and
   ``wkv56_chunk`` (``csrc/wkv56.cu``; the chunk also at T = 16, its
   step-by-step kernel, with extreme decays, and timed as v7's), and the
   kernels of the fused v6 step: ``v6_wkv_gn`` (``csrc/v6_decode.cu``),
   the two ``v7_ln_mix`` launches of a v6 layer (the first also writes
   ``xa`` and ``dx``), and
   the eight ``v7_skinny_matmul`` launches of a v6 layer with its
   epilogues.  Then RWKV-5 and RWKV-4 at the 0.4B width (C=1024, F=3584 /
   4096): ``v6_wkv_gn`` in its static-decay mode, ``wkv56_t1`` and
   ``wkv56_chunk`` on v5's static (H, N) decay, ``v4_wkv`` and
   ``wkv4_chunk`` (``csrc/wkv4.cu``, on bf16 k and v; timed at B = 8 and
   1, T = 256, 23, 16 and 1, and held with large decays and holes in the
   mask),
   and each stack's two
   ``v7_ln_mix`` and four ``v7_skinny_matmul`` launches of a layer.  Then
   the wide-batch products, ``phased_matmul`` (``csrc/phased.cu``), on a
   v7 layer's four big launches at the 0.4B and the RWKV-7 2.9B widths in
   bf16, int8 and int4 and on a v5 layer's in bf16, at B = 16 and 64,
   beside ``torch.matmul`` and the 8-row ``v7_skinny_matmul``.  Last,
   the IVF probe ``ivf_score`` (``csrc/ivf.cu``) on an int8 index of 2^20
   vectors of D = 1024 (a mixture of 16,384 unit modes made on the card,
   balanced k-means with nlist = 1024, the streamed builder), held against
   its plain version there and on bf16 and f32 indexes of 65,536 vectors,
   timed at 64 queries with nprobe 8 and 16 and at two skews (every query
   on the same clusters, every pair on a cluster of its own), each time
   beside its bound and the bytes the kernel reads, with recall@10 against
   exact search printed as a reading.
3. Model parity: the full-width RWKV-7 0.4B shape at 2 layers in f32 on
   the card (kernels) against the same weights on the CPU (plain
   versions), after a ragged prefill and T=1 steps — on the
   layer-by-layer path (where ``wkv7_t1`` is launched and counted), on the
   fused decode path called eagerly, and on the fused path replayed from
   its CUDA graph.  Then the fused kernels against ``forward_t1_plain`` on
   the card in bf16.  The same for an all-int8 model (fused, eager and
   graphed, int8 LM head) and for a mixed one (layer 0 int8, layer 1 plain:
   the layer path through ``matmul_int8_l``, ``ffn7_t1_l`` and ``wkv7_t1``).
   Then 4-bit: all-nf4 (fused, eager and graphed), layer 0 nf4 (the layer
   path through ``matmul_4bit_l`` and ``ffn7_t1_l``), the same with
   unstacked per-layer codes (``linear`` reaches ``matmul_4bit``), and
   all-int4 and all-sf4 on the fused path.  Then RWKV-6 at the 1B6 width,
   2 layers: plain (layer path with ``wkv56_t1``, fused eagerly and under
   its graph), all-int8 and all-nf4 fused, layer 0 int8 (the layer path
   through ``matmul_int8_l`` and ``wkv56_t1``; the plain layer path once
   more with the prefill's WKV through ``wkv56_chunk_plain``), and the bf16
   fused kernels against ``forward_t1_plain`` on the card, with two
   known-wrong plain stacks that the same check must reject.  The same
   cases for RWKV-5 and RWKV-4 at the 0.4B width (v5's mixed model runs
   ``wkv56_t1``, v4's ``wkv4_chunk`` at T=1).  The v6, v5 and v4 matrices
   are scaled by their fan-in (``fan_in_scaled``).  Then the phased stacks
   (``ops/v7_phased``, ``ops/v56_phased``) at 2 layers and B = 16 and 64:
   v7 at the 2.9B widths (bf16, int8, int4), v6 at 1B6 (bf16, int8), v5 at
   0.4B, each against ``forward_t1_plain``, in lockstep and under its CUDA
   graph, launching ``phased_matmul`` and no ``v7_skinny_matmul``.
   Then head sizes other than 64 (``HEAD_SIZES``: N = 32, 40 and 128 at
   the 0.4B width; their WKV libraries, one per head size, built in a
   thread beside phases 2 and 3): each of the seven N-dependent kernels
   (``wkv7_t1``, ``wkv7_chunk``, ``v7_wkv_gn``, ``wkv56_t1``,
   ``wkv56_chunk``, ``v6_wkv_gn`` with v6's dense and v5's static decay)
   held against its plain version at every split of a head, B = 8 and 64,
   and timed beside its bound and its N = 64 row; then v7, v6 and v5 of
   each N at 2 layers in f32 on the layer path and the fused stack against
   the CPU, and at N = 128 the phased stack at B = 16 in bf16 against
   ``forward_t1_plain`` and in lockstep.
4. Serving: the 0.4B shape at all 24 layers in bf16 from a seed, with a
   synthetic 65,536-entry vocabulary, behind the port's HTTP server on
   localhost: concurrent greedy completions and a streamed chat.  The
   kernels' launch counters are zeroed just before and read just after;
   every decode step there is one replay of the engine's CUDA graph.  The
   listener wants a JWT for the admin routes (``force_pass = false``): an
   admin request without one answers 401, ``/api/auth/exchange`` gives
   one.  After each burst ``/api/metrics`` counts the requests sent as
   finished, no slot busy and a positive mean step time.  Then one request
   traced through ``/admin/profile/start`` and ``/stop`` (the Chrome trace
   the route writes is read back: kernels a token, the device's busy share,
   host ops by thread; it must hold each fused v7 kernel), and the time of
   one replay of the 24-layer stack beside its bound.  The same checkpoint
   is then served with ``quant = 24, quant_type = "Int8"`` (the same burst,
   every decode step a replay of the int8 stack's graph and an int8 LM
   head) and with
   ``quant = 12`` (a short greedy completion on the layer-by-layer path),
   and the same two ways with ``quant_type = "NF4"`` (packed 4-bit codes:
   the fused stack in its 4-bit mode under the graph; ``matmul_4bit_l``,
   ``ffn7_t1_l`` in its 4-bit mode and ``wkv7_t1`` on the layer path), each
   with the launch counts zeroed before and read after.  Last, a random
   12-layer RWKV-6 checkpoint of the 1B6 shape (f16 on disk) served in bf16
   with the same burst: prefill through ``wkv56_chunk``, every decode step
   one replay of the fused v6 stack's graph; its stack is also timed with
   every layer quantized int8 and nf4 on the card.  The bf16 v7 server
   also answers a batch of ``/embeddings`` (each held against the
   mean-hidden recipe computed in the serving shape), ``pooling="state"``,
   ``/chooses``, the retrieval routes (an IVF index built from texts on the
   card, searched by text and by vector, the hits held against the plain
   version on the CPU) and a RAG chat, with ``ivf_score``'s count zeroed
   before and read after, then BNF-constrained requests (``bnf_flow``: a
   completion under a regular grammar on the device token DFA, a chat
   under a non-regular one on the native Earley engine and the chunk
   replay, each text held by the port's ``GrammarEngine``; a constrained
   burst with the fused kernels' counts zeroed before and read after; a
   16-step chunk with every row on the DFA timed in turns beside an
   unconstrained one, its tokens walked through the table on the host),
   then ``prewarm_pools``: ``Engine.prewarm`` on a fresh engine over the
   served model must leave every pool, host flag and the snapshot ring
   bit-equal (so must ``decode_chunk(snapshot=False)``), and
   ``restore_last_chunk`` after it must bring back the pre-chunk pools.
   Every served
   model but the two mixed ones (a host-bound layer path) prewarms at
   load, awaited before its first request.  Then the bf16 server
   reloads with a ``[[state]]``, a ``[[lora]]`` and a checkpoint on
   which a state lasts and 24 bf16 layers do not carry a flipped rounding
   far (``state_flow``: the blend against the host's, ``/api/oai/states``
   and a step replayed right after a state install against the plain
   forward at every layer, the state by id, inline and by path, default /
   tuned / default each a fresh slot's answer, the kernels' counts zeroed
   before its requests and read after),
   and streams one 4077-token prompt alone (its
   TTFT), as the ``quant = 24`` Int8 server does too (its 256-row prefill
   chunks above ``ops/quant.py:KERNEL_ROWS``: each int8 weight dequantized
   for one ``torch.matmul``).  The Int8 and NF4 servers save a prefab and
   reload from it through ``/admin/models/save``, ``/unload`` and
   ``/load`` with the JWT (``prefab_flow``: the same greedy tokens, the
   same device memory as a reload from the ``.st``).  Then random 12-layer RWKV-5 and RWKV-4
   checkpoints of the 0.4B shape, served the same way (prefill through
   ``wkv56_chunk`` / ``wkv4_chunk``, decode one replay of the fused v5 / v4
   stack), and a random 12-layer RWKV-7 of head size 128 (H = 8) at the
   0.4B width in bf16 (prefill through ``wkv7_chunk`` and every decode
   step one replay of the fused stack's graph, at N = 128).  The 0.4B v7
   checkpoint at ``quant = 24`` Int8 and the v5 one in bf16 are also served at
   ``max_batch = 64`` with 64 concurrent completions (every step one replay of
   the phased stack's graph; ``v7_skinny_matmul`` must launch 0 times), and
   the phased and fused stacks are timed at B = 16 and 64 on those models, on
   the v6 model and on 16 layers of the RWKV-7 2.9B shape built on the card in
   bf16 and int8.  After the v7 serves, ``mesh_flow`` runs logical
   (dp, tp) meshes whose places are all the one card: the 2-layer 0.4B
   width in bf16, int8 and nf4 on ``[2, 1]`` (each dp rank's own decode
   graph at 4 rows, held within ``BF16_MODEL_TOL`` to the unsharded
   engine), ``[1, 2]`` and ``[2, 2]`` (``wkv7_t1`` /
   ``wkv7_chunk`` on 8 heads, the quantized products on sliced codes, held
   to the unsharded engine's layer path), the 24-layer bf16 checkpoint
   served through ``Runtime`` and ``Server`` on a ``[2, 2]`` engine, and the
   middleware's refusal of ``mesh = [2, 1]`` on one card; on a machine of
   two or more cards the parity again on distinct cards.  Each phase
   prints its seconds.

The last two lines of standard output are the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# RWKV-7 World 0.4B (the published config): L=24, C=1024, head 64,
# FFN 4096, vocab 65536, LoRA ranks w 64, a 64, v 32, g 128.
L_FULL, C, HEAD, FFN, VOCAB = 24, 1024, 64, 4096, 65536
LORA = {"w": 64, "a": 64, "v": 32, "g": 128}
MAX_BATCH, CHUNK = 8, 256
SEED = 20261016
# RWKV-6 World 1B6 (RWKV-x060-World-1B6-v2.1, RWKV-LM's RWKV_Tmix_x060): L=24,
# C=2048, head 64 (H=32), FFN int(3.5 C) // 32 * 32 = 7168, vocab 65536,
# token-shift LoRA rank 32 (time_mix_w1 is (C, 160)), decay LoRA rank 64.
# Served at 12 of the 24 layers: the 3.2 GB checkpoint's write and load
# were the script's longest step, and the whole script passed ~700 s once
# the wide-batch phases came.
L6, C6, F6 = 12, 2048, 7168
LORA6 = {"tm": 32, "td": 64}
# RWKV-5 World 0.4B (RWKV-5-World-0.4B-v2; RWKV-LM x052: dim_ffn =
# int(3.5 C) // 32 * 32) and RWKV-4 World 0.4B (RWKV-4-World-0.4B-v1: dim_ffn
# = 4 C): L=24, C=1024, vocab 65536; v5 head 64 (H=16), v4 one WKV per
# channel.  The v7 smoke model's width, so their rows compare with its rows.
# Served at 12 of the 24 layers, as v6 is: the cut that made room for the
# prewarm flow's two fresh server processes (their writes and loads were
# ~20 s each of the script's host-bound setup).
L54, F5, F4 = 12, 3584, 4096
# RWKV-7 World 2.9B (BlinkDL's RWKV-x070-World-2.9B): L=32, C=2560, head 64
# (H=40), FFN 4 C = 10240, vocab 65536; LoRA ranks w 96, a 96, v 64, g 320,
# as RWKV-LM's v7 model.py sizes them for C=2560.  The wide-batch phases'
# large shape (the LoRA ranks are under 1% of its bytes).  Its stacks are
# built and timed at 16 of the 32 layers (the prewarm flow's cut, with
# L54's): a replay is the layers' launches in turn, each layer the same
# shapes.
L29, C29, F29 = 16, 2560, 10240
LORA29 = {"w": 96, "a": 96, "v": 64, "g": 320}
# Wide batches: the phased stacks (ops/v7_phased, ops/v56_phased) serve
# max_batch above the 8 rows of the fused products; 64 is the third
# configuration the repo was built for (BASELINE.json "configs"[2]).
WIDE_BATCH = 64
PHASED_BS = (16, WIDE_BATCH)
PHASED_VOCAB = 4096  # the parity models' vocabulary: no T=1 stack reads it

# Head sizes other than 64 (RWKV-LM's --head_size_a): the WKV
# kernels are built once per head size N.  At the 0.4B width C = H N: 1024
# for N = 32 (H = 32) and N = 128 (H = 8), 640 for N = 40 (H = 16).  A
# random RWKV-7 of H = 8, N = 128 at the 0.4B width is served at L128 of
# its 24 layers, as v5 and v4 are (L54).
HEAD_SIZES = {32: 1024, 40: 640, 128: 1024}
HEAD_BS = (MAX_BATCH, WIDE_BATCH)
L128 = 12

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 (the products' type)
KERNEL_TOL = 1e-4           # max |kernel - plain| / max(1, max |plain|)
# Rows at which the dequantizing products are held: each row tile of
# ops/quant_matmul.plan (8, 16, 32, 64) and 256 rows in four launches.
HELD_ROWS = (1, 8, 11, 32, 64, 256)
W_FLOOR = 0.545239211892605  # v7's least decay, exp(-exp(-0.5))
# The same for a value rounded to bf16: one bf16 ulp of the largest value.
# The kernel sums in another order than the plain version, which can move
# an f32 sum across a bf16 rounding boundary.
BF16_TOL = 2.0 ** -7
MODEL_TOL = 1e-3            # max |card - cpu| / max |cpu|, f32, 2 layers
# The v7 WKV state in lockstep at the wide shapes: v7_wkv_gn rounds the
# L2-normalised removal key kk to bf16, and at B = 64 and C = 2560 some of
# those roundings flip when kk's norm is summed in another order, moving
# whole state rows (two plain versions that differ only in the order of
# their 64-term sums over a head read 1.06 x KERNEL_TOL on the state of
# the 2.9B int4 case).  16 x KERNEL_TOL there; a wrong update reads
# thousands.
V7_WIDE_STATE_TOL = 16 * KERNEL_TOL
# Fused kernels vs forward_t1_plain on the card in bf16, 2 layers, relative
# to max |plain|: single-ulp flips (above) are carried through the next
# LayerNorms and products, so a few ulps on the hidden; the f32 state sees
# them through k, v and the decay.
BF16_MODEL_TOL = 3e-2
# A served mean-hidden /embeddings vector against the recipe (the masked
# mean of the final hidden states from a fresh state) computed in the
# serving prefill's shape, (MAX_BATCH, CHUNK): the same products and sums,
# so max abs over a unit vector of C = 1024 (typical component ~0.03) is
# ~1e-7.  The recipe at batch 1 (mean_hidden_embed) takes other GEMM
# shapes, whose bf16 roundings 24 random layers carry to ~2.5e-2: held to
# BF16_MODEL_TOL only.
EMBED_TOL = 1e-4
L2_BYTES = 50e6             # H100 L2: timed weights rotate through more


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int) -> float:
    """Per-call time of back-to-back calls from Python (host + device)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so no host time
    enters the reading."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, flops: float,
          flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that error relative to max(1, max |want|))."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def sass_loads() -> None:
    """``tools/torch_sass_loads.py`` on the built kernels: prints its
    ``v4_wkv_kernel``, ``wkv7_t1_kernel`` and ``wkv56_t1_kernel`` lines and
    fails if the first programmatic dependent reads anything but its two
    weight rows (w, u: one 16-byte load each an instantiation), or the
    others anything at all, through the non-coherent path
    (``LDG.E...CONSTANT``): every operand of ``wkv7_t1`` and ``wkv56_t1``
    (r, k, v, w - RWKV-5's static decay too - u and the mask) may have
    been written by a kernel before it."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_sass_loads.py")],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    check(out.returncode == 0, f"torch_sass_loads.py failed: "
                               f"{out.stderr[-2000:]}")
    loads = json.loads(out.stdout.strip().splitlines()[-1])["loads"]
    row = loads.get("wkv4:v4_wkv_kernel")
    check(row is not None, "no v4_wkv_kernel in the SASS")
    print("SASS loads, wkv4:v4_wkv_kernel: " + ", ".join(
        f"{k} {v}" for k, v in sorted(row.items())), flush=True)
    nc = sum(v for k, v in row.items() if "CONSTANT" in k)
    check(nc <= 2 * row["instantiations"],
          f"v4_wkv_kernel reads {nc} values through ld.global.nc: only its "
          "weight rows may be")
    for name in ("wkv7:wkv7_t1_kernel", "wkv56:wkv56_t1_kernel"):
        row = loads.get(name)
        check(row is not None, f"no {name} in the SASS")
        print(f"SASS loads, {name}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(row.items())), flush=True)
        nc = sum(v for k, v in row.items() if "CONSTANT" in k)
        check(nc == 0, f"{name} reads {nc} values through ld.global.nc: a "
                       "kernel before it may have written them")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def wkv_inputs(gen, B, T, H, N, dev):
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    S = rnd(B, H, N, N)
    r, k, v = (rnd(B, T, H, N, scale=0.3) for _ in range(3))
    w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, T, H, N)))
    kk = rnd(B, T, H, N)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    a = torch.sigmoid(rnd(B, T, H, N))
    return S, (r, w, k, v, kk, a)


def phase_kernels(dev) -> dict:
    import torch

    from ai00_server_tpu_torch.ops.wkv_chunk import (wkv7_chunk,
                                                     wkv7_chunk_plain)
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1, wkv7_t1_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, H, N = MAX_BATCH, C // HEAD, HEAD
    rows = {}

    # wkv7_t1 at the decode shape, row 5 inactive, and at B = 1; on f32
    # vectors and on the layer path's (w f32, the other five bf16).
    held_t1, shapes_t1, worst_t1 = None, {}, 0.0
    for b_t1 in (B, 1):
        S, seqs = wkv_inputs(gen, b_t1, 1, H, N, dev)
        mask = torch.ones(b_t1, dtype=torch.bool, device=dev)
        mask[5:6] = False
        elems = b_t1 * H * N * N
        n_states = int(2 * L2_BYTES // (elems * 4)) + 1
        states = [S] + [torch.randn(S.shape, generator=gen, device=dev)
                        for _ in range(n_states - 1)]
        for vec, dts in (("f32", (torch.float32,) * 6),
                         ("layer", (torch.bfloat16, torch.float32)
                          + (torch.bfloat16,) * 4)):
            vecs = [x[:, 0].to(dt).contiguous() for x, dt in zip(seqs, dts)]
            # The kernel reads S before it waits for the launch before it.
            torch.cuda.synchronize()
            S_k, y_k = wkv7_t1(S, *vecs, mask)
            S_p, y_p = wkv7_t1_plain(S, *vecs, mask)
            torch.cuda.synchronize()
            err_s, rel_s = rel_err(S_k, S_p)
            err_y, rel_y = rel_err(y_k, y_p)
            check(rel_s <= KERNEL_TOL and rel_y <= KERNEL_TOL,
                  f"wkv7_t1 B={b_t1} {vec} disagrees with its plain version: "
                  f"{rel_s} {rel_y}")
            if b_t1 > 5:
                check(torch.equal(S_k[5], S[5]),
                      "wkv7_t1 changed an inactive row")
            worst_t1 = max(worst_t1, err_s, err_y)
            vec_bytes = sum(v.numel() * v.element_size() for v in vecs)
            # Timed with every row active on states that rotate past the
            # L2, as a layer-path step finds them (its bound counts the
            # state's HBM bytes).
            active = torch.ones_like(mask)
            ms = device_ms(rotating(lambda i: wkv7_t1(states[i], *vecs,
                                                      active), n_states),
                           max(100, n_states))
            b_ms, b_by = bound(2 * elems * 4 + vec_bytes + b_t1 * H * N * 4
                               + b_t1, 9 * elems)
            shapes_t1[f"{vec} B={b_t1}"] = {"ms": ms, "bound_ms": b_ms}
            idle = "; inactive row bit-identical" if b_t1 > 5 else ""
            print(f"wkv7_t1 B={b_t1} H={H} N={N} {vec} vectors: max_abs_err "
                  f"state {err_s:.3e} y {err_y:.3e} (tolerance {KERNEL_TOL} x "
                  f"max(1, |plain|)){idle}; {ms:.5f} ms on {n_states} states "
                  f"rotating past the L2 (bound {b_ms:.5f})", flush=True)
            if b_t1 == B and vec == "f32":
                held_t1 = (S, vecs, active, b_ms, b_by)
        del states
    S, vecs, mask, b_ms, b_by = held_t1
    rows["wkv7_t1"] = {
        "name": "wkv7_t1", "route": "cuda",
        "source": "ai00_server_tpu_torch/csrc/wkv7.cu",
        "replaces": "ai00_server_tpu/ops/wkv_t1.py:108",
        "max_abs_err": worst_t1,
        "ms": shapes_t1[f"f32 B={B}"]["ms"],
        "same_state_ms": device_ms(lambda: wkv7_t1(S, *vecs, mask), 100),
        "plain_ms": device_ms(lambda: wkv7_t1_plain(S, *vecs, mask), 20),
        "call_ms": call_ms(lambda: wkv7_t1(S, *vecs, mask), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shapes_ms": shapes_t1,
    }
    print(f"wkv7_t1 B={B}: {rows['wkv7_t1']['same_state_ms']:.5f} ms on one "
          "state", flush=True)

    # wkv7_chunk at the prefill shape (T = token_chunk_size), and ragged.
    worst = 0.0
    for T, lengths in ((CHUNK, [CHUNK] * B),
                       (23, [23, 17, 1, 0, 23, 5, 12, 23])):
        S, seqs = wkv_inputs(gen, B, T, H, N, dev)
        lens = torch.tensor(lengths, device=dev)
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
        S_k, y_k = wkv7_chunk(S, *seqs, mask)
        S_p, y_p = wkv7_chunk_plain(S, *seqs, mask)
        torch.cuda.synchronize()
        err_s, rel_s = rel_err(S_k, S_p)
        err_y, rel_y = rel_err(y_k[mask], y_p[mask])
        check(rel_s <= KERNEL_TOL and rel_y <= KERNEL_TOL,
              f"wkv7_chunk T={T} disagrees with its plain version: "
              f"{rel_s} {rel_y}")
        if lengths[3] == 0:
            check(torch.equal(S_k[3], S[3]), "wkv7_chunk changed an idle row")
        worst = max(worst, err_s, err_y)
        print(f"wkv7_chunk B={B} T={T} H={H} N={N}: max_abs_err state "
              f"{err_s:.3e} y(valid) {err_y:.3e} (tolerance {KERNEL_TOL} x "
              "max(1, |plain|))", flush=True)
        if T == CHUNK:
            n_valid = int(mask.sum())
            n_masked = B * T - n_valid
            nbytes = (2 * B * H * N * N * 4 + 7 * B * T * H * N * 4
                      + B * T)
            flops = H * N * N * (9 * n_valid + 2 * n_masked)
            b_ms, b_by = bound(nbytes, flops)
            args = (S, *seqs, mask)
            rows["wkv7_chunk"] = {
                "name": "wkv7_chunk", "route": "cuda",
                "source": "ai00_server_tpu_torch/csrc/wkv7.cu",
                "replaces": "ai00_server_tpu/ops/wkv_pallas.py:174",
                "ms": device_ms(lambda: wkv7_chunk(*args), 20),
                "plain_ms": device_ms(lambda: wkv7_chunk_plain(*args), 1,
                                      replays=3),
                "call_ms": call_ms(lambda: wkv7_chunk(*args), 50),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
    # Every decay at v7's floor exp(-exp(-0.5)): the WY form's
    # precondition, its largest 1 / A (1.6e4 over a sub-chunk); row 3 idle.
    S, seqs = wkv_inputs(gen, B, CHUNK, H, N, dev)
    seqs[1].fill_(W_FLOOR)
    mask = torch.ones(B, CHUNK, dtype=torch.bool, device=dev)
    mask[3] = False
    S_k, y_k = wkv7_chunk(S, *seqs, mask)
    S_p, y_p = wkv7_chunk_plain(S, *seqs, mask)
    torch.cuda.synchronize()
    err_s, rel_s = rel_err(S_k, S_p)
    err_y, rel_y = rel_err(y_k, y_p)
    check(rel_s <= KERNEL_TOL and rel_y <= KERNEL_TOL,
          f"wkv7_chunk at the decay floor disagrees with its plain version: "
          f"{rel_s} {rel_y}")
    check(torch.equal(S_k[3], S[3]), "wkv7_chunk changed an idle row")
    worst = max(worst, err_s, err_y)
    print(f"wkv7_chunk B={B} T={CHUNK} H={H} N={N}, every w at the floor "
          f"{W_FLOOR:.4f}: max_abs_err state {err_s:.3e} y {err_y:.3e} "
          f"(tolerance {KERNEL_TOL} x max(1, |plain|)); idle row "
          "bit-identical", flush=True)

    def make(b, t):
        S, seqs = wkv_inputs(gen, b, t, H, N, dev)
        return (S, *seqs, torch.ones(b, t, dtype=torch.bool, device=dev))

    worst = max(worst, held_every_split(wkv7_chunk, wkv7_chunk_plain, make,
                                        H))
    rows["wkv7_chunk"]["shapes_ms"], err = chunk_shapes_ms(
        wkv7_chunk, wkv7_chunk_plain, make)
    rows["wkv7_chunk"]["max_abs_err"] = max(worst, err)
    print_shapes("wkv7_chunk", H, rows["wkv7_chunk"]["shapes_ms"])
    print_rows(rows)
    return rows


def chunk_shapes_ms(kernel, plain, make) -> tuple[dict, float]:
    """Device ms of a chunk kernel at B = MAX_BATCH and 1, T = CHUNK and 16,
    on ``make(B, T)``'s argument tuples rotating through more than the L2
    holds; the first tuple of each shape held against ``plain`` at
    KERNEL_TOL (state, and y at every step).  Also the worst max abs
    error."""
    out, worst = {}, 0.0
    for B in (MAX_BATCH, 1):
        for T in (CHUNK, 16):
            first = make(B, T)
            err, _ = held(kernel, plain, first,
                          f"{kernel.__name__} B={B} T={T}")
            worst = max(worst, err)
            each = nbytes(*(a for a in first if hasattr(a, "numel")))
            n = int(2 * L2_BYTES // each) + 1
            sets = [first] + [make(B, T) for _ in range(n - 1)]
            out[(B, T)] = device_ms(rotating(lambda i: kernel(*sets[i]), n),
                                    max(20, n))
    return out, worst


def held(kernel, plain, args, what: str):
    """``kernel(*args)`` against ``plain(*args)`` at KERNEL_TOL, the state
    and y at every step: the max abs error and the kernel's state."""
    import torch

    (S_k, y_k), (S_p, y_p) = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err_s, rel_s = rel_err(S_k, S_p)
    err_y, rel_y = rel_err(y_k, y_p)
    check(rel_s <= KERNEL_TOL and rel_y <= KERNEL_TOL,
          f"{what} disagrees with its plain version: {rel_s} {rel_y}")
    return max(err_s, err_y), S_k


def held_every_split(kernel, plain, make, H: int) -> float:
    """A chunk kernel against its plain version (:func:`held`) at the least
    B at which ``ops/wkv_chunk.plan`` splits each head's state over each of
    its block counts on this card, T = CHUNK: row 0 with a masked step
    inside, row 1 half, the last row idle where B > 1 (its state bit for
    bit).  ``make(B, T)`` gives the arguments, the mask last (replaced
    here).  The worst max abs error."""
    import torch

    from ai00_server_tpu_torch.ops.device import sm_count
    from ai00_server_tpu_torch.ops.wkv_chunk import plan

    least = {}
    for B in range(1, MAX_BATCH + 1):
        least.setdefault(plan(B, H, sm_count(0)), B)
    worst, name = 0.0, kernel.__name__
    for slices, B in sorted(least.items()):
        *args, ones = make(B, CHUNK)
        lens = [CHUNK] * B
        if B > 1:
            lens[-1] = 0
        if B > 2:
            lens[1] = CHUNK // 2
        mask = (torch.arange(CHUNK, device=ones.device)[None, :]
                < torch.tensor(lens, device=ones.device)[:, None])
        mask[0, CHUNK // 3] = False
        err, S_k = held(kernel, plain, (*args, mask),
                        f"{name} B={B} ({slices} blocks a head)")
        if B > 1:
            check(torch.equal(S_k[-1], args[0][-1]),
                  f"{name} B={B} changed an idle row")
        worst = max(worst, err)
        print(f"{name} B={B} T={CHUNK} H={H}, {slices} block(s) a head, "
              f"ragged{', last row idle' if B > 1 else ''}: max_abs_err "
              f"{err:.3e} (tolerance {KERNEL_TOL} x max(1, |plain|))"
              f"{'; idle row bit-identical' if B > 1 else ''}", flush=True)
    return worst


# The vectors ``models/v6.py`` / ``v5.py`` hand ``wkv56_t1`` on a bf16
# model, r k v w u: the products' r, k, v and the parameter u bf16, the
# decay f32.
T56_LAYER = ("bf16", "bf16", "bf16", "f32", "bf16")


def t56_layer(args):
    """``wkv56_t1``'s vectors (r, k, v, w, u) in the layer path's dtypes."""
    import torch

    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    return [t.to(dts[d]) for t, d in zip(args, T56_LAYER)]


def held_t56(S, args, mask, what: str) -> float:
    """``wkv56_t1(S, *args, mask)`` against ``wkv56_t1_plain`` at KERNEL_TOL
    (:func:`rel_err` over the state and y) at ``plan56``'s split and at each
    split of a head forced (1, 2, 4 blocks), every idle row's state bit for
    bit.  The worst max abs error."""
    import torch

    from ai00_server_tpu_torch.ops import wkv_t1

    S_p, y_p = wkv_t1.wkv56_t1_plain(S, *args, mask)
    plan, worst = wkv_t1.plan56, 0.0
    try:
        for slices in (None, *wkv_t1.SPLITS):
            if slices is not None:
                wkv_t1.plan56 = lambda *a, s=slices: s
            torch.cuda.synchronize()  # the kernel reads S before it waits
            S_k, y_k = wkv_t1.wkv56_t1(S, *args, mask)
            torch.cuda.synchronize()
            split = f"{slices} block(s) a head" if slices else "planned split"
            for got, want, part in ((S_k, S_p, "state"), (y_k, y_p, "y")):
                err, rel = rel_err(got, want)
                check(rel <= KERNEL_TOL, f"{what} ({split}) {part} disagrees "
                      f"with its plain version: {rel:.3e} of max(1, |plain|)")
                worst = max(worst, err)
            for b in torch.nonzero(~mask).flatten().tolist():
                check(torch.equal(S_k[b], S[b]),
                      f"{what} ({split}) changed idle row {b}")
    finally:
        wkv_t1.plan56 = plan
    return worst


def print_shapes(name: str, H: int, shapes: dict) -> None:
    print(f"{name} H={H}, device ms on inputs rotating past the L2: "
          + "; ".join(f"B={B} T={T} {ms:.5f}" for (B, T), ms in
                      shapes.items()), flush=True)


def print_rows(rows) -> None:
    for r in rows.values():
        lib = ("" if r["library_ms"] is None
               else f", library {r['library_ms']:.5f} ms")
        print(f"{r['name']}: {r['ms']:.5f} ms on the device (plain "
              f"{r['plain_ms']:.5f} ms{lib}, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}); {r['call_ms']:.5f} ms per call from "
              "Python", flush=True)


def rotating(call, n: int):
    """``call(i)`` with i cycling through range(n), one step per call."""
    import itertools

    it = itertools.count()
    return lambda: call(next(it) % n)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def phase_decode_kernels(dev) -> dict:
    """The three kernels of the fused decode step at the 0.4B shape (B=8,
    bf16, row 5 inactive), each against its plain version, timed on
    weights and states that rotate through more than the L2 holds, as the
    24-layer stack finds them."""
    import torch

    from ai00_server_tpu_torch.ops import v7_decode as fd

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    B, H, N, cd = MAX_BATCH, C // HEAD, HEAD, torch.bfloat16
    SRC = "ai00_server_tpu_torch/csrc/v7_decode.cu"
    REPLACES = "ai00_server_tpu/ops/v7_decode_pallas.py:274"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def weight(K, Nout):
        return (rnd(K, Nout) / K ** 0.5).to(cd)

    def close(got, want, rounded, what):
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if rounded else KERNEL_TOL
        check(err <= tol * max(1.0, float(want.float().abs().max())),
              f"{what} disagrees with its plain version: {err:.3e}")
        return err

    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[5] = False
    rows = {}

    # ---- v7_ln_mix: 6 mixes (time mix) and 1 (channel mix) ----
    x, shift0 = rnd(B, C, scale=2.0), rnd(B, C)
    ln = torch.stack([1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]).to(cd)
    mix = rnd(6, C, scale=0.3).to(cd)
    worst = 0.0
    for n_mix in (6, 1):
        shift = shift0.clone()
        want, want_shift = fd.v7_ln_mix_plain(x, ln, shift, mix[:n_mix],
                                              active)
        got = fd.v7_ln_mix(x, ln, shift, mix[:n_mix].contiguous(), active)
        torch.cuda.synchronize()
        worst = max(worst, close(got, want, True, f"v7_ln_mix({n_mix})"),
                    close(shift, want_shift, False, "v7_ln_mix shift"))
        check(torch.equal(shift[5], shift0[5]),
              "v7_ln_mix changed an inactive row's shift state")
    shift = shift0.clone()
    b_ms, b_by = bound(nbytes(x, ln, mix, active) + 2 * nbytes(shift)
                       + 6 * B * C * 2, 12 * B * C + 12 * B * C)
    rows["v7_ln_mix"] = {
        "name": "v7_ln_mix", "route": "cuda", "source": SRC,
        "replaces": REPLACES, "max_abs_err": worst,
        "ms": device_ms(lambda: fd.v7_ln_mix(x, ln, shift, mix, active), 100),
        "plain_ms": device_ms(
            lambda: fd.v7_ln_mix_plain(x, ln, shift, mix, active), 20),
        "call_ms": call_ms(lambda: fd.v7_ln_mix(x, ln, shift, mix, active),
                           200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"v7_ln_mix B={B} C={C} bf16, 6 and 1 mixes: max_abs_err "
          f"{worst:.3e} (tolerance {BF16_TOL:.2e} x max(1, |plain|) on the "
          f"bf16 mixes, {KERNEL_TOL} on the f32 shift); inactive row "
          "bit-identical", flush=True)

    # ---- v7_skinny_matmul: the six launches of a layer ----
    D = LORA
    shapes = {
        "rkv": [(C, C, "none", False, True, "f32")] * 3,
        "lora_down": [(C, D["w"], "tanh", False, False, "cd"),
                      (C, D["a"], "none", False, False, "cd"),
                      (C, D["v"], "none", False, False, "cd"),
                      (C, D["g"], "sigmoid", False, False, "cd")],
        "lora_up": [(D["w"], C, "wdecay", True, False, "f32"),
                    (D["a"], C, "sigmoid", True, True, "f32"),
                    (D["v"], C, "sigmoid", True, True, "f32"),
                    (D["g"], C, "none", False, False, "f32")],
        "wo": [(C, C, "none", False, False, "add")],
        "fkey": [(C, FFN, "relu2", False, False, "cd")],
        "fval": [(FFN, C, "none", False, False, "add")],
    }
    layer_bytes = sum(K * Nout * 2 for g in shapes.values()
                      for K, Nout, *_ in g)
    n_sets = int(2 * L2_BYTES // layer_bytes) + 1
    total = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "call_ms")}
    tot_bytes = tot_flops = 0.0
    worst = 0.0
    for gname, specs in shapes.items():
        sets = []
        for _ in range(n_sets):
            sets.append([fd.Product(
                rnd(B, K, scale=0.5).to(cd), weight(K, Nout), act=act,
                bias=rnd(Nout) if bias else None, round_cd=round_cd, out=out,
                y=rnd(B, Nout) if out == "add" else None)
                for K, Nout, act, bias, round_cd, out in specs])
        prods = sets[0]
        want = fd.v7_skinny_matmul_plain(prods)
        got = fd.v7_skinny_matmul(prods)
        torch.cuda.synchronize()
        for g, w, pr in zip(got, want, prods):
            worst = max(worst, close(g, w, pr.out == "cd" or pr.round_cd,
                                     f"v7_skinny_matmul[{gname}]"))
        gb = sum(nbytes(pr.x, pr.W, pr.bias) + B * pr.W.shape[1]
                 * {"cd": 2, "f32": 4, "add": 8}[pr.out] for pr in prods)
        gf = sum(2 * B * pr.W.shape[0] * pr.W.shape[1] for pr in prods)
        tot_bytes += gb
        tot_flops += gf
        t = {
            "ms": device_ms(rotating(
                lambda i: fd.v7_skinny_matmul(sets[i]), n_sets), 40),
            "plain_ms": device_ms(rotating(
                lambda i: fd.v7_skinny_matmul_plain(sets[i]), n_sets), 8),
            "library_ms": device_ms(rotating(
                lambda i: [torch.matmul(pr.x, pr.W) for pr in sets[i]],
                n_sets), 40),
            "call_ms": call_ms(rotating(
                lambda i: fd.v7_skinny_matmul(sets[i]), n_sets), 100),
        }
        gb_ms, _ = bound(gb, gf, BF16_FLOPS)
        print(f"v7_skinny_matmul[{gname}] "
              f"{[tuple(pr.W.shape) for pr in prods]}: {t['ms']:.5f} ms "
              f"(plain {t['plain_ms']:.5f}, torch.matmul "
              f"{t['library_ms']:.5f}, bound {gb_ms:.5f} by bytes; "
              f"{gb / t['ms'] / 1e6:.0f} GB/s)", flush=True)
        for k in total:
            total[k] += t[k]
        del sets
    b_ms, b_by = bound(tot_bytes, tot_flops, BF16_FLOPS)
    rows["v7_skinny_matmul"] = {
        "name": "v7_skinny_matmul", "route": "cuda", "source": SRC,
        "replaces": REPLACES, "max_abs_err": worst, **total,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    print(f"v7_skinny_matmul B={B} bf16, the six launches of a layer (14 "
          f"products, {layer_bytes / 1e6:.1f} MB of weights, {n_sets} "
          f"rotating sets): max_abs_err {worst:.3e} (tolerance "
          f"{BF16_TOL:.2e} x max(1, |plain|) on bf16-rounded results, "
          f"{KERNEL_TOL} on f32 ones); times are the sum of the six",
          flush=True)

    # ---- v7_wkv_gn ----
    r, k, v, g, vf = (rnd(B, C, scale=0.5) for _ in range(5))
    w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, C)))
    a, vmix = torch.sigmoid(rnd(B, C)), torch.sigmoid(rnd(B, C))
    vecs = rnd(8, C, scale=0.5)
    n_states = int(L2_BYTES // (B * H * N * N * 4)) + 2
    states = [rnd(B, H, N, N) for _ in range(n_states)]
    worst = 0.0
    for is_first in (True, False):
        S = states[0].clone()
        vf_k = vf.clone()
        want, S_want, vf_want = fd.v7_wkv_gn_plain(
            r, k, v, w, a, g, vmix, vf, vecs, active, S, is_first, cd)
        got = fd.v7_wkv_gn(r, k, v, w, a, g, vmix, vf_k, vecs, active, S,
                           is_first, cd)
        torch.cuda.synchronize()
        worst = max(worst, close(got, want, True, "v7_wkv_gn"),
                    close(S, S_want, False, "v7_wkv_gn state"))
        check(torch.equal(S[5], states[0][5]),
              "v7_wkv_gn changed an inactive row's state")
        check(torch.equal(vf_k, vf_want), "v7_wkv_gn v_first")
    n_act = int(active.sum())
    elems = H * N * N
    b_ms, b_by = bound(
        (B + n_act) * elems * 4 + nbytes(r, k, v, w, a, g, vmix, vf, active)
        + 5 * C * 4 + B * C * 2,
        elems * (9 * n_act + 2 * (B - n_act)) + 30 * B * C)

    def wkv(i, fn):
        return fn(r, k, v, w, a, g, vmix, vf, vecs, active, states[i],
                  False, cd)

    rows["v7_wkv_gn"] = {
        "name": "v7_wkv_gn", "route": "cuda", "source": SRC,
        "replaces": REPLACES, "max_abs_err": worst,
        "ms": device_ms(rotating(lambda i: wkv(i, fd.v7_wkv_gn), n_states),
                        100),
        "plain_ms": device_ms(rotating(
            lambda i: wkv(i, fd.v7_wkv_gn_plain), n_states), 20),
        "call_ms": call_ms(rotating(lambda i: wkv(i, fd.v7_wkv_gn),
                                    n_states), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"v7_wkv_gn B={B} H={H} N={N} bf16 ({n_states} rotating states): "
          f"max_abs_err {worst:.3e} (tolerance {BF16_TOL:.2e} x max(1, "
          f"|plain|) on the bf16 output, {KERNEL_TOL} on the f32 state); "
          "inactive row bit-identical", flush=True)
    print_rows(rows)
    return rows


def phase_head(dev) -> float:
    """Returns the time of the chosen (last) way.  Three ways to the LM head's f32-accumulated f32 logits from a bf16
    head (B=8): converting the head every step, an f32 copy cached at
    load, and one product with an f32 output type (engine.head_logits)."""
    import torch

    from ai00_server_tpu_torch.engine import head_logits

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    x = torch.randn(MAX_BATCH, C, generator=gen, device=dev).bfloat16()
    head = (torch.randn(C, VOCAB, generator=gen, device=dev)
            / C ** 0.5).bfloat16()
    head32 = head.float()
    want = torch.matmul(x.float(), head32)
    got = head_logits({"head": head}, x)
    torch.cuda.synchronize()
    check(got.dtype == torch.float32, "head_logits must return f32")
    err, rel = rel_err(got, want)
    check(rel <= KERNEL_TOL, f"head_logits disagrees with the f32 product: "
          f"{rel:.3e}")
    t_conv = device_ms(lambda: torch.matmul(x.float(), head.float()), 10)
    t_f32 = device_ms(lambda: torch.matmul(x.float(), head32), 10)
    t_out = device_ms(lambda: head_logits({"head": head}, x), 10)
    b_ms, _ = bound(nbytes(head, x) + MAX_BATCH * VOCAB * 4,
                    2 * MAX_BATCH * C * VOCAB, BF16_FLOPS)
    print(f"LM head B={MAX_BATCH} C={C} V={VOCAB}, bf16 head -> f32 logits: "
          f"converted every step {t_conv:.5f} ms; f32 head cached at load "
          f"{t_f32:.5f} ms (+{nbytes(head32) / 1e6:.0f} MB of device "
          f"memory); one product with an f32 output type {t_out:.5f} ms "
          f"(no extra memory; bound {b_ms:.5f} ms by bytes); max_abs_err of "
          f"the last against the f32 product {err:.3e}", flush=True)
    return t_out


def phase_int8_kernels(dev, bf16_head_ms: float) -> dict:
    """The int8 kernels at the 0.4B serving shape (B=8, bf16 activations,
    row 5 inactive where there are rows to skip), each against its plain
    version, timed on codes that rotate through more than the L2 holds:
    ``matmul_int8`` as the LM head takes it (f32 logits), ``matmul_int8_l``
    and ``ffn7_t1_l`` on stacked codes as the layer path takes them, and the
    four int8 launches of a layer of the fused decode step."""
    import torch

    from ai00_server_tpu_torch.ops import quant
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.ffn import ffn7_t1_l, ffn7_t1_l_plain
    from ai00_server_tpu_torch.ops.quant_matmul import (
        matmul_int8, matmul_int8_l, matmul_int8_l_plain, matmul_int8_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    B, cd = MAX_BATCH, torch.bfloat16
    SRC = "ai00_server_tpu_torch/csrc/quant.cu"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def codes(*shape):
        """Random (..., K, N) weights quantized on the card, one leading
        slice at a time (the f32 copy never exceeds one slice)."""
        if len(shape) == 2:
            return quant.quantize_int8(rnd(*shape) / shape[0] ** 0.5)
        parts = [codes(*shape[1:]) for _ in range(shape[0])]
        return quant.QuantizedLinear(
            "int8", torch.stack([p.q for p in parts]),
            torch.stack([p.scale for p in parts]), shape[-2:])

    def close(got, want, rounded, what):
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if rounded else KERNEL_TOL
        check(err <= tol * max(1.0, float(want.float().abs().max())),
              f"{what} disagrees with its plain version: {err:.3e}")
        return err

    def sets_over_l2(bytes_each: int) -> int:
        return int(2 * L2_BYTES // bytes_each) + 1

    rows = {}

    # The quantizer on the card gives the host's codes and scales.
    w = rnd(2, 256, 1024) / 16
    on_card = quant.quantize_int8(w)
    on_host = quant.quantize_int8(w.cpu().numpy(), device=dev)
    check(torch.equal(on_card.q, on_host.q)
          and torch.equal(on_card.scale, on_host.scale),
          "quantize_int8 on the card and on the host disagree")

    # ---- matmul_int8: the LM head, f32 logits ----
    n = sets_over_l2(C * VOCAB)
    heads = [codes(C, VOCAB) for _ in range(n)]
    err = 0.0
    for R in HELD_ROWS:  # every row tile of the plan, and 4 launches
        xr = rnd(R, C, scale=0.5).to(cd)
        want = matmul_int8_plain(xr, heads[0].q, heads[0].scale,
                                 torch.float32)
        got = matmul_int8(xr, heads[0].q, heads[0].scale, torch.float32)
        torch.cuda.synchronize()
        check(got.dtype == torch.float32,
              "matmul_int8 must return f32 logits")
        err = max(err, close(got, want, False, f"matmul_int8 R={R}"))
        check(torch.equal(got, matmul_int8(xr, heads[0].q, heads[0].scale,
                                           torch.float32)),
              "matmul_int8 gave different bits for equal inputs")
    x = rnd(B, C, scale=0.5).to(cd)
    x64 = rnd(WIDE_BATCH, C, scale=0.5).to(cd)
    b_ms, b_by = bound(nbytes(x, heads[0].q, heads[0].scale) + B * VOCAB * 4,
                       2 * B * C * VOCAB, BF16_FLOPS)
    b64_ms, _ = bound(nbytes(x64, heads[0].q, heads[0].scale)
                      + WIDE_BATCH * VOCAB * 4, 2 * WIDE_BATCH * C * VOCAB,
                      BF16_FLOPS)

    def head(i, fn, xs=x):
        return fn(xs, heads[i].q, heads[i].scale, torch.float32)

    rows["matmul_int8"] = {
        "name": "matmul_int8", "route": "cuda", "source": SRC,
        "replaces": "ai00_server_tpu/ops/quant_pallas.py:118",
        "max_abs_err": err,
        "ms": device_ms(rotating(lambda i: head(i, matmul_int8), n), 10),
        "plain_ms": device_ms(rotating(
            lambda i: head(i, matmul_int8_plain), n), 2),
        "call_ms": call_ms(rotating(lambda i: head(i, matmul_int8), n), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_b64": device_ms(rotating(
            lambda i: head(i, matmul_int8, x64), n), 10),
    }
    print(f"matmul_int8 C={C} V={VOCAB}, bf16 x, f32 logits ({n} rotating "
          f"heads of {nbytes(heads[0].q, heads[0].scale) / 1e6:.1f} MB), "
          f"held at R = {HELD_ROWS}: max_abs_err {err:.3e} (tolerance "
          f"{KERNEL_TOL} x max(1, |plain|)); equal inputs give equal bits; "
          f"B={B} {rows['matmul_int8']['ms']:.5f} ms, B={WIDE_BATCH} "
          f"{rows['matmul_int8']['ms_b64']:.5f} ms (one launch; bound "
          f"{b64_ms:.5f}); the bf16 head's torch.mm in this run: "
          f"{bf16_head_ms:.5f} ms", flush=True)
    del heads

    # ---- matmul_int8_l: the time mix's (C, C) products on stacked codes ----
    n = sets_over_l2(C * C)
    stack = codes(n, C, C)
    x3 = rnd(B, 1, C, scale=0.5).to(cd)
    worst = 0.0
    for l in (0, n // 2, n - 1):
        for R in HELD_ROWS:
            xr = x3 if R == B else rnd(R, 1, C, scale=0.5).to(cd)
            got = matmul_int8_l(xr, stack.q, stack.scale, l)
            worst = max(worst, close(
                got, matmul_int8_l_plain(xr, stack.q, stack.scale, l), True,
                f"matmul_int8_l[{l}] R={R}"))
            check(torch.equal(got, matmul_int8_l(xr, stack.q, stack.scale,
                                                 l)),
                  "matmul_int8_l gave different bits for equal inputs")
    torch.cuda.synchronize()
    b_ms, b_by = bound(nbytes(x3, stack.q[0], stack.scale[0]) + B * C * 2,
                       2 * B * C * C, BF16_FLOPS)
    rows["matmul_int8_l"] = {
        "name": "matmul_int8_l", "route": "cuda", "source": SRC,
        "replaces": "ai00_server_tpu/ops/quant_pallas.py:242",
        "max_abs_err": worst,
        "ms": device_ms(rotating(
            lambda l: matmul_int8_l(x3, stack.q, stack.scale, l), n), 100),
        "plain_ms": device_ms(rotating(
            lambda l: matmul_int8_l_plain(x3, stack.q, stack.scale, l), n),
            20),
        "call_ms": call_ms(rotating(
            lambda l: matmul_int8_l(x3, stack.q, stack.scale, l), n), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    del stack
    # A prefill chunk's 256 rows in four launches (the layer path sends
    # them to dequant() + torch.matmul: above KERNEL_ROWS).
    n = sets_over_l2(C * FFN)
    stack = codes(n, C, FFN)
    x256 = rnd(CHUNK, C, scale=0.5).to(cd)
    rows["matmul_int8_l"]["ms_r256"] = device_ms(rotating(
        lambda l: matmul_int8_l(x256, stack.q, stack.scale, l), n), 20)
    print(f"matmul_int8_l B={B} ({C}, {C}) on layer l of stacked layers, "
          f"bf16, held at R = {HELD_ROWS}: max_abs_err {worst:.3e} "
          f"(tolerance {BF16_TOL:.2e} x max(1, |plain|) on the bf16 result), "
          f"equal bits on a repeat; {CHUNK} rows at ({C}, {FFN}): "
          f"{rows['matmul_int8_l']['ms_r256']:.5f} ms", flush=True)
    del stack

    # ---- ffn7_t1_l: the channel mix on stacked codes ----
    n = sets_over_l2(2 * C * FFN)
    key, val = codes(n, C, FFN), codes(n, FFN, C)
    xf, shift = rnd(B, C).to(cd), rnd(B, C)
    mix = rnd(C, scale=0.3).to(cd)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[5] = False

    def ffn(l, fn):
        return fn(xf, shift, mix, active, key.q, key.scale, val.q, val.scale,
                  l)

    worst = 0.0
    for l in (0, n - 1):
        (got, got_shift), (want, want_shift) = (ffn(l, ffn7_t1_l),
                                                ffn(l, ffn7_t1_l_plain))
        torch.cuda.synchronize()
        # hk is rounded to bf16 between the two products, so a flipped ulp
        # of hk reaches the f32 output: the bf16 tolerance.
        worst = max(worst, close(got, want, True, f"ffn7_t1_l[{l}]"))
        check(torch.equal(got_shift, want_shift)
              and torch.equal(got_shift[5], shift[5]),
              "ffn7_t1_l: wrong new shift state, or an inactive row moved")
    for R in HELD_ROWS:  # every row tile of the plan
        args = (rnd(R, C).to(cd), rnd(R, C), mix,
                torch.rand(R, generator=gen, device=dev) < 0.8, key.q,
                key.scale, val.q, val.scale, 1)
        (got, got_shift), (want, want_shift) = (ffn7_t1_l(*args),
                                                ffn7_t1_l_plain(*args))
        worst = max(worst, close(got, want, True, f"ffn7_t1_l R={R}"))
        check(torch.equal(got_shift, want_shift)
              and torch.equal(got, ffn7_t1_l(*args)[0]),
              f"ffn7_t1_l R={R}: wrong new shift state, or other bits on a "
              "repeat")
    b_ms, b_by = bound(
        nbytes(xf, shift, mix, active, key.q[0], key.scale[0], val.q[0],
               val.scale[0]) + 2 * B * C * 4, 4 * B * C * FFN, BF16_FLOPS)
    rows["ffn7_t1_l"] = {
        "name": "ffn7_t1_l", "route": "cuda", "source": SRC,
        "replaces": "ai00_server_tpu/ops/ffn_pallas.py:76",
        "max_abs_err": worst,
        "ms": device_ms(rotating(lambda l: ffn(l, ffn7_t1_l), n), 40),
        "plain_ms": device_ms(rotating(lambda l: ffn(l, ffn7_t1_l_plain), n),
                              8),
        "call_ms": call_ms(rotating(lambda l: ffn(l, ffn7_t1_l), n), 100),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"ffn7_t1_l B={B} C={C} F={FFN} on layer l of {n} stacked layers, "
          f"bf16 (two launches, the value product a programmatic dependent),"
          f" held at B = {HELD_ROWS}: max_abs_err {worst:.3e} "
          f"(tolerance {BF16_TOL:.2e} x max(1, |plain|)); new shift state "
          "equal, inactive row bit-identical", flush=True)
    del key, val

    # ---- v7_skinny_matmul on int8 codes: the four big launches of a layer --
    shapes = {
        "rkv": [(C, C, "none", True, "f32")] * 3,
        "wo": [(C, C, "none", False, "add")],
        "fkey": [(C, FFN, "relu2", False, "cd")],
        "fval": [(FFN, C, "none", False, "add")],
    }
    layer_bytes = sum(K * Nout for g in shapes.values() for K, Nout, *_ in g)
    n = sets_over_l2(layer_bytes)
    total = {k: 0.0 for k in ("ms", "plain_ms", "call_ms")}
    tot_bytes = tot_flops = 0.0
    worst = 0.0
    for gname, specs in shapes.items():
        sets = []
        for _ in range(n):
            prods = []
            for K, Nout, act, round_cd, out in specs:
                ql = codes(K, Nout)
                prods.append(fd.Product(
                    rnd(B, K, scale=0.5).to(cd), ql.q, scale=ql.scale,
                    act=act, round_cd=round_cd, out=out,
                    y=rnd(B, Nout) if out == "add" else None))
            sets.append(prods)
        prods = sets[0]
        want = fd.v7_skinny_matmul_plain(prods)
        got = fd.v7_skinny_matmul(prods)
        torch.cuda.synchronize()
        for g, w, pr in zip(got, want, prods):
            worst = max(worst, close(g, w, pr.out == "cd" or pr.round_cd,
                                     f"v7_skinny_matmul int8 [{gname}]"))
        gb = sum(nbytes(pr.x, pr.W, pr.scale) + B * pr.KN[1]
                 * {"cd": 2, "f32": 4, "add": 8}[pr.out] for pr in prods)
        gf = sum(2 * B * pr.KN[0] * pr.KN[1] for pr in prods)
        tot_bytes += gb
        tot_flops += gf
        t = {
            "ms": device_ms(rotating(
                lambda i: fd.v7_skinny_matmul(sets[i]), n), 40),
            "plain_ms": device_ms(rotating(
                lambda i: fd.v7_skinny_matmul_plain(sets[i]), n), 8),
            "call_ms": call_ms(rotating(
                lambda i: fd.v7_skinny_matmul(sets[i]), n), 100),
        }
        gb_ms, _ = bound(gb, gf, BF16_FLOPS)
        print(f"v7_skinny_matmul int8 [{gname}] "
              f"{[pr.KN for pr in prods]}: {t['ms']:.5f} ms (plain "
              f"{t['plain_ms']:.5f}, bound {gb_ms:.5f} by bytes; "
              f"{gb / t['ms'] / 1e6:.0f} GB/s)", flush=True)
        for k in total:
            total[k] += t[k]
        del sets
    b_ms, b_by = bound(tot_bytes, tot_flops, BF16_FLOPS)
    rows["v7_skinny_matmul (int8)"] = {
        "name": "v7_skinny_matmul (int8)", "route": "cuda",
        "source": "ai00_server_tpu_torch/csrc/v7_decode.cu",
        "replaces": "ai00_server_tpu/ops/v7_decode_pallas.py:274",
        "max_abs_err": worst, **total, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }
    print(f"v7_skinny_matmul B={B} bf16 activations on int8 codes, the four "
          f"big launches of a layer (6 products, {layer_bytes / 1e6:.1f} MB "
          f"of codes, {n} rotating sets): max_abs_err {worst:.3e} (tolerance "
          f"{BF16_TOL:.2e} x max(1, |plain|) on bf16-rounded results, "
          f"{KERNEL_TOL} on f32 ones); times are the sum of the four",
          flush=True)
    print_rows(rows)
    return rows


def phase_4bit_kernels(dev) -> dict:
    """The 4-bit kernels at the 0.4B serving shape, in nf4, sf4 and int4,
    each against its plain version in f32 and bf16 (B=8 with row 5 inactive
    where there are rows to skip, and B=11: a second launch), equal bits on
    a repeated call; timed at B=8 in bf16 on codes that rotate through more
    than the L2 holds.  The timed codes are nf4-quantized; the other modes
    are timed on the same bytes (a mode is a table, any byte decodes) and
    printed beside; the rows carry nf4's times."""
    import torch

    from ai00_server_tpu_torch.ops import quant
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.ffn import ffn7_t1_l, ffn7_t1_l_plain
    from ai00_server_tpu_torch.ops.quant_matmul import (
        matmul_4bit, matmul_4bit_l, matmul_4bit_l_plain, matmul_4bit_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    B = MAX_BATCH
    MODES = tuple(quant.LEVELS)
    SRC = "ai00_server_tpu_torch/csrc/quant.cu"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def codes(mode, *shape):
        """Random (..., K, N) weights quantized on the card, one leading
        slice at a time (the f32 copy never exceeds one slice)."""
        if len(shape) == 2:
            return quant.quantize_4bit(rnd(*shape) / shape[0] ** 0.5, mode)
        parts = [codes(mode, *shape[1:]) for _ in range(shape[0])]
        return quant.QuantizedLinear(
            mode, torch.stack([p.q for p in parts]),
            torch.stack([p.scale for p in parts]), shape[-2:])

    def close(got, want, rounded, what):
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if rounded else KERNEL_TOL
        check(err <= tol * max(1.0, float(want.float().abs().max())),
              f"{what} disagrees with its plain version: {err:.3e}")
        return err

    def sets_over_l2(bytes_each: int) -> int:
        return int(2 * L2_BYTES // bytes_each) + 1

    def times(call, n, iters, plain_iters):
        """nf4's device, plain and Python-call times of ``call(mode, fn
        kind, i)``, and the device time of the other modes."""
        t = {"ms": device_ms(rotating(
                 lambda i: call("nf4", "kernel", i), n), iters),
             "plain_ms": device_ms(rotating(
                 lambda i: call("nf4", "plain", i), n), plain_iters),
             "call_ms": call_ms(rotating(
                 lambda i: call("nf4", "kernel", i), n), 2 * iters)}
        others = {m: device_ms(rotating(
            lambda i: call(m, "kernel", i), n), iters) for m in MODES[1:]}
        return t, others

    def others_text(others):
        return ", ".join(f"{m} {t:.5f}" for m, t in others.items())

    # The quantizers on the card give the host's codes and scales, ties and
    # all-zero blocks included.
    w = rnd(2, 256, 1024) / 16
    w[:, :64, 7] = 0.0
    for mode in MODES:
        on_card = quant.quantize_4bit(w, mode)
        on_host = quant.quantize_4bit(w.cpu().numpy(), mode, device=dev)
        check(torch.equal(on_card.q, on_host.q)
              and torch.equal(on_card.scale, on_host.scale),
              f"quantize_{mode} on the card and on the host disagree")

    rows = {}
    cds = (torch.float32, torch.bfloat16)

    # ---- matmul_4bit: an unstacked (C, FFN) weight ----
    worst = 0.0
    for mode in MODES:
        ql = codes(mode, C, FFN)
        for cd in cds:
            for R in HELD_ROWS:
                x = rnd(R, C, scale=0.5).to(cd)
                got = matmul_4bit(x, ql.q, ql.scale, mode=mode)
                want = matmul_4bit_plain(x, ql.q, ql.scale, mode)
                torch.cuda.synchronize()
                worst = max(worst, close(got, want, cd == torch.bfloat16,
                                         f"matmul_4bit {mode} {cd} R={R}"))
                check(torch.equal(got, matmul_4bit(x, ql.q, ql.scale,
                                                   mode=mode)),
                      "matmul_4bit gave different bits for equal inputs")
    n = sets_over_l2(C * FFN // 2)
    sets = [codes("nf4", C, FFN) for _ in range(n)]
    x = rnd(B, C, scale=0.5).to(torch.bfloat16)
    b_ms, b_by = bound(nbytes(x, sets[0].q, sets[0].scale) + B * FFN * 2,
                       2 * B * C * FFN, BF16_FLOPS)
    t, others = times(
        lambda m, kind, i: (matmul_4bit if kind == "kernel"
                            else matmul_4bit_plain)(
            x, sets[i].q, sets[i].scale, mode=m), n, 40, 8)
    rows["matmul_4bit"] = {
        "name": "matmul_4bit", "route": "cuda", "source": SRC,
        "replaces": "ai00_server_tpu/ops/quant_pallas.py:167",
        "max_abs_err": worst, **t, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }
    print(f"matmul_4bit R = {HELD_ROWS}, ({C}, {FFN}) unstacked, {MODES}, f32 "
          f"and bf16: max_abs_err {worst:.3e} (tolerance {KERNEL_TOL} x "
          f"max(1, |plain|) in f32, {BF16_TOL:.2e} on bf16 results); equal "
          f"inputs give equal bits; {n} rotating weights of "
          f"{nbytes(sets[0].q, sets[0].scale) / 1e6:.1f} MB; ms on the same "
          f"bytes in the other modes: {others_text(others)}", flush=True)
    del sets

    # ---- matmul_4bit_l: the time mix's (C, C) products on stacked codes ----
    worst = 0.0
    for mode in MODES:
        stack = codes(mode, 3, C, C)
        for cd in cds:
            for R in HELD_ROWS:
                x3 = rnd(R, 1, C, scale=0.5).to(cd)
                for l in (0, 2):
                    got = matmul_4bit_l(x3, stack.q, stack.scale, l,
                                        mode=mode)
                    worst = max(worst, close(
                        got, matmul_4bit_l_plain(x3, stack.q, stack.scale, l,
                                                 mode),
                        cd == torch.bfloat16,
                        f"matmul_4bit_l[{l}] {mode} {cd} R={R}"))
                    check(torch.equal(got, matmul_4bit_l(
                        x3, stack.q, stack.scale, l, mode=mode)),
                        "matmul_4bit_l gave different bits for equal inputs")
    torch.cuda.synchronize()
    n = sets_over_l2(C * C // 2)
    stack = codes("nf4", n, C, C)
    x3 = rnd(B, 1, C, scale=0.5).to(torch.bfloat16)
    b_ms, b_by = bound(nbytes(x3, stack.q[0], stack.scale[0]) + B * C * 2,
                       2 * B * C * C, BF16_FLOPS)
    t, others = times(
        lambda m, kind, l: (matmul_4bit_l if kind == "kernel"
                            else matmul_4bit_l_plain)(
            x3, stack.q, stack.scale, l, mode=m), n, 100, 20)
    rows["matmul_4bit_l"] = {
        "name": "matmul_4bit_l", "route": "cuda", "source": SRC,
        "replaces": "ai00_server_tpu/ops/quant_pallas.py:292",
        "max_abs_err": worst, **t, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }
    del stack
    # A prefill chunk's 256 rows in four launches.
    n = sets_over_l2(C * FFN // 2)
    stack = codes("nf4", n, C, FFN)
    x256 = rnd(CHUNK, C, scale=0.5).to(torch.bfloat16)
    rows["matmul_4bit_l"]["ms_r256"] = device_ms(rotating(
        lambda l: matmul_4bit_l(x256, stack.q, stack.scale, l, mode="nf4"),
        n), 20)
    print(f"matmul_4bit_l R = {HELD_ROWS}, ({C}, {C}) on layer l of stacked "
          f"codes, {MODES}, f32 and bf16: max_abs_err {worst:.3e} (same "
          f"tolerances), equal bits on a repeat; timed at B={B}; ms in the "
          f"other modes: {others_text(others)}; nf4 {CHUNK} rows at ({C}, "
          f"{FFN}): {rows['matmul_4bit_l']['ms_r256']:.5f} ms", flush=True)
    del stack

    # ---- ffn7_t1_l on stacked 4-bit codes ----
    worst = 0.0
    for mode in MODES:
        key, val = codes(mode, 2, C, FFN), codes(mode, 2, FFN, C)
        for cd in cds:
            for R in HELD_ROWS:
                xf, shift = rnd(R, C).to(cd), rnd(R, C)
                mix = rnd(C, scale=0.3).to(cd)
                active = torch.ones(R, dtype=torch.bool, device=dev)
                idle = R // 2
                active[idle] = R == 1  # one inactive row (none when R = 1)
                args = (xf, shift, mix, active, key.q, key.scale, val.q,
                        val.scale, 1)
                got, got_shift = ffn7_t1_l(*args, qmode=mode)
                want, want_shift = ffn7_t1_l_plain(*args, qmode=mode)
                torch.cuda.synchronize()
                # hk is rounded to cd between the two products, so in bf16 a
                # flipped ulp of hk reaches the f32 output.
                worst = max(worst, close(got, want, cd == torch.bfloat16,
                                         f"ffn7_t1_l {mode} {cd} R={R}"))
                check(torch.equal(got_shift, want_shift)
                      and (R == 1 or torch.equal(got_shift[idle],
                                                 shift[idle])),
                      "ffn7_t1_l (4-bit): wrong new shift state, or an "
                      "inactive row moved")
                check(torch.equal(got, ffn7_t1_l(*args, qmode=mode)[0]),
                      "ffn7_t1_l (4-bit) gave different bits for equal "
                      "inputs")
    n = sets_over_l2(C * FFN)
    key, val = codes("nf4", n, C, FFN), codes("nf4", n, FFN, C)
    xf, shift = rnd(B, C).to(torch.bfloat16), rnd(B, C)
    mix = rnd(C, scale=0.3).to(torch.bfloat16)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[5] = False
    b_ms, b_by = bound(
        nbytes(xf, shift, mix, active, key.q[0], key.scale[0], val.q[0],
               val.scale[0]) + 2 * B * C * 4, 4 * B * C * FFN, BF16_FLOPS)
    t, others = times(
        lambda m, kind, l: (ffn7_t1_l if kind == "kernel"
                            else ffn7_t1_l_plain)(
            xf, shift, mix, active, key.q, key.scale, val.q, val.scale, l,
            qmode=m), n, 40, 8)
    rows["ffn7_t1_l (4-bit)"] = {
        "name": "ffn7_t1_l (4-bit)", "route": "cuda", "source": SRC,
        "replaces": "ai00_server_tpu/ops/ffn_pallas.py:76",
        "max_abs_err": worst, **t, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }
    print(f"ffn7_t1_l B = {HELD_ROWS}, C={C} F={FFN} on layer l of stacked "
          f"4-bit codes, {MODES}, f32 and bf16 (two launches per 64 rows): "
          f"max_abs_err {worst:.3e} (same tolerances); new shift state "
          f"equal, inactive row bit-identical, equal bits on a repeated "
          f"call; timed over {n} stacked layers; ms in the other modes: "
          f"{others_text(others)}", flush=True)
    del key, val

    # ---- v7_skinny_matmul on 4-bit codes: the four big launches of a layer -
    shapes = {
        "rkv": [(C, C, "none", True, "f32")] * 3,
        "wo": [(C, C, "none", False, "add")],
        "fkey": [(C, FFN, "relu2", False, "cd")],
        "fval": [(FFN, C, "none", False, "add")],
    }
    layer_bytes = sum(K * Nout // 2 for g in shapes.values()
                      for K, Nout, *_ in g)
    n = sets_over_l2(layer_bytes)

    def products(mode, specs, cd, R):
        prods = []
        for K, Nout, act, round_cd, out in specs:
            ql = codes(mode, K, Nout)
            prods.append(fd.Product(
                rnd(R, K, scale=0.5).to(cd), ql.q, scale=ql.scale, mode=mode,
                act=act, round_cd=round_cd, out=out,
                y=rnd(R, Nout) if out == "add" else None))
        return prods

    def in_mode(prods, mode):
        return [fd.Product(**{**pr.__dict__, "mode": mode}) for pr in prods]

    total = {k: 0.0 for k in ("ms", "plain_ms", "call_ms")}
    total_others = {m: 0.0 for m in MODES[1:]}
    tot_bytes = tot_flops = 0.0
    worst = 0.0
    for gname, specs in shapes.items():
        for mode in MODES:
            for cd in cds:
                for R in (B, 11):
                    prods = products(mode, specs, cd, R)
                    again = [fd.Product(**{
                        **pr.__dict__, "y": None if pr.y is None
                        else pr.y.clone()}) for pr in prods]
                    want = fd.v7_skinny_matmul_plain(prods)
                    got = fd.v7_skinny_matmul(prods)
                    torch.cuda.synchronize()
                    for g, w, pr in zip(got, want, prods):
                        worst = max(worst, close(
                            g, w, cd == torch.bfloat16
                            and (pr.out == "cd" or pr.round_cd),
                            f"v7_skinny_matmul {mode} {cd} [{gname}]"))
                    for g, g2 in zip(got, fd.v7_skinny_matmul(again)):
                        check(torch.equal(g, g2), "v7_skinny_matmul (4-bit) "
                              "gave different bits for equal inputs")
        sets = [products("nf4", specs, torch.bfloat16, B) for _ in range(n)]
        by_mode = {m: [in_mode(prods, m) for prods in sets] for m in MODES}
        prods = sets[0]
        gb = sum(nbytes(pr.x, pr.W, pr.scale) + B * pr.KN[1]
                 * {"cd": 2, "f32": 4, "add": 8}[pr.out] for pr in prods)
        gf = sum(2 * B * pr.KN[0] * pr.KN[1] for pr in prods)
        tot_bytes += gb
        tot_flops += gf
        t, others = times(
            lambda m, kind, i: (
                fd.v7_skinny_matmul(by_mode[m][i]) if kind == "kernel"
                else fd.v7_skinny_matmul_plain(by_mode[m][i])), n, 40, 8)
        gb_ms, _ = bound(gb, gf, BF16_FLOPS)
        print(f"v7_skinny_matmul 4-bit [{gname}] "
              f"{[pr.KN for pr in prods]}: nf4 {t['ms']:.5f} ms (plain "
              f"{t['plain_ms']:.5f}, bound {gb_ms:.5f} by bytes; "
              f"{gb / t['ms'] / 1e6:.0f} GB/s), {others_text(others)}",
              flush=True)
        for k in total:
            total[k] += t[k]
        for m in others:
            total_others[m] += others[m]
        del sets, by_mode
    b_ms, b_by = bound(tot_bytes, tot_flops, BF16_FLOPS)
    rows["v7_skinny_matmul (4-bit)"] = {
        "name": "v7_skinny_matmul (4-bit)", "route": "cuda",
        "source": "ai00_server_tpu_torch/csrc/v7_decode.cu",
        "replaces": "ai00_server_tpu/ops/v7_decode_pallas.py:274",
        "max_abs_err": worst, **total, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }
    print(f"v7_skinny_matmul B={B} and 11 on 4-bit codes, {MODES}, f32 and "
          f"bf16, the four big launches of a layer (6 products, "
          f"{layer_bytes / 1e6:.1f} MB of codes, {n} rotating sets): "
          f"max_abs_err {worst:.3e} (tolerance {BF16_TOL:.2e} x max(1, "
          f"|plain|) on bf16-rounded results, {KERNEL_TOL} on f32 ones); "
          f"equal inputs give equal bits; times are nf4's, the sum of the "
          f"four; the other modes: {others_text(total_others)}", flush=True)
    print_rows(rows)
    return rows


def ln_mix_row(fd, rnd, close, active, C, cd, launches, name, replaces):
    """The ``v7_ln_mix`` launches of one layer of a stack, ``launches`` =
    [(n_mix, with_xa_dx)], each against its plain version (row 5 inactive);
    the row's times, bytes and operations are the sums over the launches."""
    import torch

    B = active.shape[0]
    x, shift0 = rnd(B, C, scale=2.0), rnd(B, C)
    ln = torch.stack([1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]).to(cd)
    total = {k: 0.0 for k in ("ms", "plain_ms", "call_ms")}
    tot_bytes = tot_flops = worst = 0.0
    for n_mix, with_xa_dx in launches:
        mix = rnd(n_mix, C, scale=0.3).to(cd)
        kw = {"with_xa_dx": with_xa_dx}
        shift = shift0.clone()
        want, want_shift = fd.v7_ln_mix_plain(x, ln, shift, mix, active, **kw)
        got = fd.v7_ln_mix(x, ln, shift, mix, active, **kw)
        torch.cuda.synchronize()
        what = f"{name} ({got.shape[0]} outputs)"
        err = max(close(got, want, True, what),
                  close(shift, want_shift, False, f"{what} shift"))
        worst = max(worst, err)
        check(torch.equal(shift[5], shift0[5]),
              f"{what} changed an inactive row's shift state")
        tot_bytes += nbytes(x, ln, mix, active) + 2 * nbytes(shift) \
            + got.numel() * 2
        tot_flops += 12 * B * C + 4 * got.numel()
        t = {"ms": device_ms(
                 lambda: fd.v7_ln_mix(x, ln, shift, mix, active, **kw), 100),
             "plain_ms": device_ms(
                 lambda: fd.v7_ln_mix_plain(x, ln, shift, mix, active, **kw),
                 20),
             "call_ms": call_ms(
                 lambda: fd.v7_ln_mix(x, ln, shift, mix, active, **kw), 200)}
        for k in total:
            total[k] += t[k]
        print(f"{what} B={B} C={C} bf16: {t['ms']:.5f} ms (plain "
              f"{t['plain_ms']:.5f}); max_abs_err {err:.3e} (tolerance "
              f"{BF16_TOL:.2e} x max(1, |plain|) on the bf16 outputs, "
              f"{KERNEL_TOL} on the f32 shift); inactive row bit-identical",
              flush=True)
    b_ms, b_by = bound(tot_bytes, tot_flops)
    return {"name": name, "route": "cuda",
            "source": "ai00_server_tpu_torch/csrc/decode_common.cuh",
            "replaces": replaces, "max_abs_err": worst, **total,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def skinny_row(fd, launch, groups, close, name, replaces, tag):
    """The ``v7_skinny_matmul`` launches of one layer of a stack, each of
    ``groups`` built by ``launch(group)`` (fresh weights and inputs a
    call), against its plain version, timed on sets of weights rotating
    through more than the L2 holds, beside ``torch.matmul`` of the same
    products; the row's times, bytes and operations are the sums."""
    import torch

    total = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "call_ms")}
    tot_bytes = tot_flops = layer_bytes = worst = 0.0
    n_products = 0
    for gname in groups:
        prods = launch(gname)
        B = prods[0].x.shape[0]
        n_products += len(prods)
        gbytes = sum(nbytes(p.W) for p in prods)
        layer_bytes += gbytes
        n = int(2 * L2_BYTES // gbytes) + 1
        sets = [prods] + [launch(gname) for _ in range(n - 1)]
        want = fd.v7_skinny_matmul_plain(prods)
        ys = [p.y.clone() if p.y is not None else None for p in prods]
        got = fd.v7_skinny_matmul(prods)
        torch.cuda.synchronize()
        for g, w, p in zip(got, want, prods):
            worst = max(worst, close(g, w, p.out in ("cd", "mix")
                                     or p.round_cd,
                                     f"v7_skinny_matmul[{tag} {gname}]"))
        for p, y in zip(prods, ys):
            if y is not None:
                p.y.copy_(y)
        gb = sum(nbytes(p.x, p.W, p.bias, p.gate, p.xa, p.dx, p.mix)
                 + B * p.W.shape[1] * {"cd": 2, "mix": 2, "f32": 4, "add": 8,
                                       "gadd": 8}[p.out] for p in prods)
        gf = sum(2 * B * p.W.shape[0] * p.W.shape[1] for p in prods)
        tot_bytes += gb
        tot_flops += gf
        t = {
            "ms": device_ms(rotating(
                lambda i: fd.v7_skinny_matmul(sets[i]), n), 40),
            "plain_ms": device_ms(rotating(
                lambda i: fd.v7_skinny_matmul_plain(sets[i]), n), 8),
            "library_ms": device_ms(rotating(
                lambda i: [torch.matmul(p.x, p.W) for p in sets[i]], n), 40),
            "call_ms": call_ms(rotating(
                lambda i: fd.v7_skinny_matmul(sets[i]), n), 100),
        }
        gb_ms, _ = bound(gb, gf, BF16_FLOPS)
        print(f"v7_skinny_matmul[{tag} {gname}] "
              f"{[tuple(p.W.shape) for p in prods]} ({n} rotating sets): "
              f"{t['ms']:.5f} ms (plain {t['plain_ms']:.5f}, torch.matmul "
              f"{t['library_ms']:.5f}, bound {gb_ms:.5f} by bytes; "
              f"{gb / t['ms'] / 1e6:.0f} GB/s)", flush=True)
        for k in total:
            total[k] += t[k]
        del sets
    b_ms, b_by = bound(tot_bytes, tot_flops, BF16_FLOPS)
    print(f"v7_skinny_matmul B={B} bf16, the {len(groups)} launches of a "
          f"{tag} layer ({n_products} products, {layer_bytes / 1e6:.1f} MB "
          f"of weights): max_abs_err {worst:.3e} (tolerance "
          f"{BF16_TOL:.2e} x max(1, |plain|) on bf16-rounded results, "
          f"{KERNEL_TOL} on f32 ones); times are the sum of the launches",
          flush=True)
    return {"name": name, "route": "cuda",
            "source": "ai00_server_tpu_torch/csrc/v7_decode.cu",
            "replaces": replaces, "max_abs_err": worst, **total,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_v6_kernels(dev) -> dict:
    """The RWKV-6 kernels at the 1B6 serving shape (B=8, C=2048, H=32,
    N=64, F=7168, bf16 activations, row 5 inactive), each against its plain
    version: ``wkv56_t1`` and ``wkv56_chunk`` (T=256, and ragged), then the
    kernels of the fused v6 step — the two ``v7_ln_mix`` launches of a layer
    (with ``xa``, ``dx`` and one mix; with the channel mix's two mixes), the
    eight ``v7_skinny_matmul`` launches with the v6 epilogues, ``v6_wkv_gn``
    — timed on weights and states that rotate through more than the L2
    holds."""
    import torch

    from ai00_server_tpu_torch.ops import v6_decode as fd6
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.wkv_chunk import (wkv56_chunk,
                                                     wkv56_chunk_plain)
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv56_t1, wkv56_t1_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    B, C, H, N, F, cd = MAX_BATCH, C6, C6 // HEAD, HEAD, F6, torch.bfloat16
    D, Dw = LORA6["tm"], LORA6["td"]
    WKV_SRC = "ai00_server_tpu_torch/csrc/wkv56.cu"
    SRC = "ai00_server_tpu_torch/csrc/v6_decode.cu"
    REPLACES = "ai00_server_tpu/ops/v6_decode_pallas.py:236"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def close(got, want, rounded, what):
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if rounded else KERNEL_TOL
        check(err <= tol * max(1.0, float(want.float().abs().max())),
              f"{what} disagrees with its plain version: {err:.3e}")
        return err

    def sets_over_l2(bytes_each: int) -> int:
        return int(2 * L2_BYTES // bytes_each) + 1

    def inputs(T):
        r, k, v = (rnd(B, T, H, N, scale=0.3) for _ in range(3))
        w = torch.exp(-torch.exp(rnd(B, T, H, N, scale=0.5)))
        return r, k, v, w

    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[5] = False
    n_act = int(active.sum())
    elems = H * N * N
    u = rnd(H, N, scale=0.5)
    n_states = max(3, sets_over_l2(B * elems * 4))
    states = [rnd(B, H, N, N) for _ in range(n_states)]
    rows = {}

    # ---- wkv56_t1 at the decode shape, row 5 inactive, at every split of
    # a head, on f32 vectors and on the layer path's (r, k, v, u bf16, w
    # f32: one launch, no casts) ----
    vecs = [*(t[:, 0].contiguous() for t in inputs(1)), u]
    layer = t56_layer(vecs)
    err = max(held_t56(states[0], vecs, active, f"wkv56_t1 B={B} H={H} f32"),
              held_t56(states[0], layer, active,
                       f"wkv56_t1 B={B} H={H} layer-path vectors"))
    flops = elems * (7 * n_act + 5 * (B - n_act))
    b_ms, b_by = bound(2 * B * elems * 4 + 5 * B * H * N * 4 + H * N * 4
                       + B, flops)
    lb_ms, _ = bound(2 * B * elems * 4 + nbytes(*layer) + B * H * N * 4 + B,
                     flops)

    def t1(i, fn, args=vecs):
        return fn(states[i], *args, active)

    rows["wkv56_t1"] = {
        "name": "wkv56_t1", "route": "cuda", "source": WKV_SRC,
        "replaces": "ai00_server_tpu/ops/wkv_t1.py:123", "max_abs_err": err,
        "ms": device_ms(rotating(lambda i: t1(i, wkv56_t1), n_states), 100),
        "same_state_ms": device_ms(lambda: t1(0, wkv56_t1), 100),
        "layer_ms": device_ms(rotating(lambda i: t1(i, wkv56_t1, layer),
                                       n_states), 100),
        "layer_bound_ms": lb_ms,
        "plain_ms": device_ms(rotating(lambda i: t1(i, wkv56_t1_plain),
                                       n_states), 20),
        "call_ms": call_ms(rotating(lambda i: t1(i, wkv56_t1), n_states), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"wkv56_t1 B={B} H={H} N={N} ({n_states} rotating states): "
          f"max_abs_err {err:.3e} (tolerance {KERNEL_TOL} x max(1, |plain|)) "
          f"at each split, f32 and layer-path vectors; inactive row "
          f"bit-identical; {rows['wkv56_t1']['ms']:.5f} ms on the rotating "
          f"states, {rows['wkv56_t1']['same_state_ms']:.5f} ms on one state, "
          f"the whole call on the layer path's vectors "
          f"{rows['wkv56_t1']['layer_ms']:.5f} ms (bound {lb_ms:.5f}); "
          f"{card_line()}", flush=True)

    # ---- wkv56_chunk at the prefill shape (T = token_chunk_size), ragged,
    # and T = 16 (the step-by-step kernel: ops/wkv_chunk.sequential) ----
    worst = 0.0
    for T, lengths in ((CHUNK, [CHUNK] * B),
                       (23, [23, 17, 1, 0, 23, 5, 12, 23]),
                       (16, [16, 9, 1, 0, 16, 5, 12, 16])):
        seqs = inputs(T)
        S = states[1]
        lens = torch.tensor(lengths, device=dev)
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
        S_k, y_k = wkv56_chunk(S, *seqs, u, mask)
        S_p, y_p = wkv56_chunk_plain(S, *seqs, u, mask)
        torch.cuda.synchronize()
        worst = max(worst, close(S_k, S_p, False, f"wkv56_chunk T={T} state"),
                    close(y_k, y_p, False, f"wkv56_chunk T={T} y"))
        if lengths[3] == 0:
            check(torch.equal(S_k[3], S[3]), "wkv56_chunk changed an idle row")
        if T == CHUNK:
            n_valid = int(mask.sum())
            b_ms, b_by = bound(2 * B * elems * 4 + 5 * B * T * H * N * 4
                               + H * N * 4 + B * T,
                               elems * (7 * n_valid + 5 * (B * T - n_valid)))
            args = (S, *seqs, u, mask)
            rows["wkv56_chunk"] = {
                "name": "wkv56_chunk", "route": "cuda", "source": WKV_SRC,
                "replaces": "ai00_server_tpu/ops/wkv_pallas.py:209",
                "ms": device_ms(lambda: wkv56_chunk(*args), 20),
                "plain_ms": device_ms(lambda: wkv56_chunk_plain(*args), 1,
                                      replays=3),
                "call_ms": call_ms(lambda: wkv56_chunk(*args), 50),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
    # The extreme decays of tests/test_wkv_chunked.py (log w down to
    # ~ -e^4 and up to ~ -e^-4): the suffix-sum form's exponents stay <= 0.
    r_, k_, v_ = inputs(CHUNK)[:3]
    w_ = torch.exp(-torch.exp(rnd(B, CHUNK, H, N, scale=2.0)))
    lens = torch.tensor([CHUNK, 100, 1, 0, CHUNK, 37, 200, CHUNK],
                        device=dev)
    mask = torch.arange(CHUNK, device=dev)[None, :] < lens[:, None]
    S = states[1]
    S_k, y_k = wkv56_chunk(S, r_, k_, v_, w_, u, mask)
    S_p, y_p = wkv56_chunk_plain(S, r_, k_, v_, w_, u, mask)
    torch.cuda.synchronize()
    worst = max(worst, close(S_k, S_p, False, "wkv56_chunk extreme state"),
                close(y_k, y_p, False, "wkv56_chunk extreme y"))
    check(torch.equal(S_k[3], S[3]), "wkv56_chunk changed an idle row")
    print(f"wkv56_chunk B={B} H={H} N={N}, T={CHUNK}, ragged T=23 and T=16 "
          f"(step by step), T={CHUNK} ragged with extreme decays: "
          f"max_abs_err {worst:.3e} "
          f"(tolerance {KERNEL_TOL} x max(1, |plain|), y at every step: the "
          "same masked semantics); idle row bit-identical", flush=True)

    def make(b, t):
        return (rnd(b, H, N, N), *(rnd(b, t, H, N, scale=0.3)
                                   for _ in range(3)),
                torch.exp(-torch.exp(rnd(b, t, H, N, scale=0.5))), u,
                torch.ones(b, t, dtype=torch.bool, device=dev))

    worst = max(worst, held_every_split(wkv56_chunk, wkv56_chunk_plain,
                                        make, H))
    rows["wkv56_chunk"]["shapes_ms"], err = chunk_shapes_ms(
        wkv56_chunk, wkv56_chunk_plain, make)
    rows["wkv56_chunk"]["max_abs_err"] = max(worst, err)
    print_shapes("wkv56_chunk", H, rows["wkv56_chunk"]["shapes_ms"])

    # ---- v7_ln_mix: the two launches of a v6 layer ----
    # LayerNorm 1 with xa, dx and xxx (with_xa_dx), LayerNorm 2 with the
    # channel mix's two mixes.
    rows["v7_ln_mix (v6)"] = ln_mix_row(fd, rnd, close, active, C, cd,
                                        ((1, True), (2, False)),
                                        "v7_ln_mix (v6)", REPLACES)

    # ---- v7_skinny_matmul: the eight launches of a v6 layer ----
    def weight(K, Nout):
        return (rnd(K, Nout) / K ** 0.5).to(cd)

    def launch(gname):
        """One set of a launch's products, fresh weights and inputs."""
        xa, dx = rnd(B, C).to(cd), rnd(B, C).to(cd)
        xs = rnd(B, max(C, F), scale=0.5).to(cd)
        P = fd.Product
        if gname == "maa_down":
            return [P(xs[:, :C], weight(C, 5 * D), act="tanh")]
        if gname == "maa_up":
            h, mix = rnd(B, 5 * D).to(cd), rnd(5, C, scale=0.3).to(cd)
            return [P(h[:, i * D:(i + 1) * D], weight(D, C), out="mix",
                      xa=xa, dx=dx, mix=mix[i]) for i in range(5)]
        if gname == "decay_down":
            return [P(xs[:, :C].contiguous(), weight(C, Dw), act="tanh")]
        if gname == "rkvg":
            return [P(xs[:, :C].contiguous(), weight(C, C), round_cd=True,
                      out="f32") for _ in range(3)] + [
                P(xs[:, :C].contiguous(), weight(C, C), act="silu",
                  out="f32")]
        if gname == "decay_up":
            return [P(rnd(B, Dw).to(cd), weight(Dw, C), act="expexp",
                      bias=rnd(C, scale=0.5), out="f32")]
        if gname == "wo":
            return [P(xs[:, :C].contiguous(), weight(C, C), out="add",
                      y=rnd(B, C))]
        if gname == "fkey_frec":
            return [P(xs[:, :C].contiguous(), weight(C, F), act="relu2"),
                    P(xs[:, :C].contiguous(), weight(C, C), act="sigmoid",
                      out="f32")]
        return [P(xs[:, :F].contiguous(), weight(F, C), out="gadd",
                  y=rnd(B, C), gate=torch.sigmoid(rnd(B, C)))]

    rows["v7_skinny_matmul (v6)"] = skinny_row(
        fd, launch, ("maa_down", "maa_up", "decay_down", "rkvg", "decay_up",
                     "wo", "fkey_frec", "fval"), close,
        "v7_skinny_matmul (v6)", REPLACES, "v6")

    # ---- v6_wkv_gn ----
    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = torch.nn.functional.silu(rnd(B, C))
    w = torch.exp(-torch.exp(rnd(B, C, scale=0.5)))
    vecs6 = rnd(4, C, scale=0.5)
    S = states[2].clone()
    want, S_want = fd6.v6_wkv_gn_plain(r, k, v, w, g, vecs6, active, S, cd)
    got = fd6.v6_wkv_gn(r, k, v, w, g, vecs6, active, S, cd)
    torch.cuda.synchronize()
    err = max(close(got, want, True, "v6_wkv_gn"),
              close(S, S_want, False, "v6_wkv_gn state"))
    check(torch.equal(S[5], states[2][5]),
          "v6_wkv_gn changed an inactive row's state")
    b_ms, b_by = bound((B + n_act) * elems * 4 + nbytes(r, k, v, w, g, active)
                       + 3 * C * 4 + B * C * 2,
                       elems * (7 * n_act + 5 * (B - n_act)) + 12 * B * C)

    def wkv(i, fn):
        return fn(r, k, v, w, g, vecs6, active, states[i], cd)

    rows["v6_wkv_gn"] = {
        "name": "v6_wkv_gn", "route": "cuda", "source": SRC,
        "replaces": REPLACES, "max_abs_err": err,
        "ms": device_ms(rotating(lambda i: wkv(i, fd6.v6_wkv_gn), n_states),
                        100),
        "plain_ms": device_ms(rotating(
            lambda i: wkv(i, fd6.v6_wkv_gn_plain), n_states), 20),
        "call_ms": call_ms(rotating(lambda i: wkv(i, fd6.v6_wkv_gn),
                                    n_states), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"v6_wkv_gn B={B} H={H} N={N} bf16 ({n_states} rotating states): "
          f"max_abs_err {err:.3e} (tolerance {BF16_TOL:.2e} x max(1, "
          f"|plain|) on the bf16 output, {KERNEL_TOL} on the f32 state); "
          "inactive row bit-identical", flush=True)
    print_rows(rows)
    return rows


def phase_v54_kernels(dev) -> dict:
    """The RWKV-5 and RWKV-4 kernels at the 0.4B serving shape (B=8,
    C=1024, v5 H=16 N=64, bf16 activations, row 5 inactive), each against
    its plain version: ``v6_wkv_gn`` in its static-decay mode (v5),
    ``v4_wkv`` and ``wkv4_chunk`` (T=256, ragged, 16 and 1; a fresh
    PP_INIT row in each), then each stack's two ``v7_ln_mix`` launches of a layer and
    its four ``v7_skinny_matmul`` launches, timed on weights, states and
    chunk inputs that rotate through more than the L2 holds (v4's per-layer
    state is 96 KB, so ``v4_wkv`` rotates through about a thousand, one a
    call, as a replay finds them after its weights have streamed through
    the L2)."""
    import torch

    from ai00_server_tpu_torch.models.v4 import PP_INIT
    from ai00_server_tpu_torch.ops import v4_decode as fd4
    from ai00_server_tpu_torch.ops import v6_decode as fd6
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops import wkv4
    from ai00_server_tpu_torch.ops.wkv4 import wkv4_chunk, wkv4_chunk_plain
    from ai00_server_tpu_torch.ops.wkv_chunk import (wkv56_chunk,
                                                     wkv56_chunk_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    B, H, N, cd = MAX_BATCH, C // HEAD, HEAD, torch.bfloat16
    REPLACES = {"v5": "ai00_server_tpu/ops/v5_decode_pallas.py:213",
                "v4": "ai00_server_tpu/ops/v4_decode_pallas.py:190"}
    SRC4 = "ai00_server_tpu_torch/csrc/wkv4.cu"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def close(got, want, rounded, what):
        got, want = off_pp_init(got, want, what)
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if rounded else KERNEL_TOL
        check(err <= tol * max(1.0, float(want.float().abs().max())),
              f"{what} disagrees with its plain version: {err:.3e}")
        return err

    def sets_over_l2(bytes_each: int) -> int:
        return int(2 * L2_BYTES // bytes_each) + 1

    def timed(kernel, plain, n, iters=100, plain_iters=20):
        return {"ms": device_ms(rotating(kernel, n), iters),
                "plain_ms": device_ms(rotating(plain, n), plain_iters),
                "call_ms": call_ms(rotating(kernel, n), 200)}

    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[5] = False
    n_act = int(active.sum())
    rows = {}

    # ---- v6_wkv_gn in its static-decay mode (v5) ----
    elems = H * N * N
    n_states = max(3, sets_over_l2(B * elems * 4))
    states = [rnd(B, H, N, N) for _ in range(n_states)]
    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = torch.nn.functional.silu(rnd(B, C))
    vecs5 = rnd(4, C, scale=0.5)
    vecs5[0] = torch.exp(-torch.exp(vecs5[0]))
    S = states[0].clone()
    want, S_want = fd6.v6_wkv_gn_plain(r, k, v, None, g, vecs5, active, S,
                                       cd)
    got = fd6.v6_wkv_gn(r, k, v, None, g, vecs5, active, S, cd)
    torch.cuda.synchronize()
    err = max(close(got, want, True, "v6_wkv_gn (v5)"),
              close(S, S_want, False, "v6_wkv_gn (v5) state"))
    check(torch.equal(S[5], states[0][5]),
          "v6_wkv_gn (v5) changed an inactive row's state")
    b_ms, b_by = bound((B + n_act) * elems * 4 + nbytes(r, k, v, g, active)
                       + 4 * C * 4 + B * C * 2,
                       elems * (7 * n_act + 5 * (B - n_act)) + 12 * B * C)
    rows["v6_wkv_gn (v5)"] = {
        "name": "v6_wkv_gn (v5, static decay)", "route": "cuda",
        "source": "ai00_server_tpu_torch/csrc/v6_decode.cu",
        "replaces": REPLACES["v5"], "max_abs_err": err,
        **timed(lambda i: fd6.v6_wkv_gn(r, k, v, None, g, vecs5, active,
                                        states[i], cd),
                lambda i: fd6.v6_wkv_gn_plain(r, k, v, None, g, vecs5,
                                              active, states[i], cd),
                n_states),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"v6_wkv_gn (v5, static decay) B={B} H={H} N={N} bf16 "
          f"({n_states} rotating states): max_abs_err {err:.3e} (tolerance "
          f"{BF16_TOL:.2e} x max(1, |plain|) on the bf16 output, "
          f"{KERNEL_TOL} on the f32 state); inactive row bit-identical",
          flush=True)

    # ---- wkv56_t1 / wkv56_chunk on v5's static (H, N) decay ----
    # The v5 layer path's WKV (prefill, and T=1 for a partly quantized
    # model); the kernels' rows are timed on the v6 shape above.
    w5, u5 = vecs5[0].reshape(H, N), vecs5[1].reshape(H, N)
    # T = 1 at every split of a head, f32 and the layer path's vectors.
    t1v = [*(rnd(B, H, N, scale=0.3) for _ in range(3)), w5, u5]
    err56 = max(held_t56(states[0], t1v, active,
                         f"wkv56_t1 static decay B={B} H={H} f32"),
                held_t56(states[0], t56_layer(t1v), active,
                         f"wkv56_t1 static decay B={B} H={H} layer-path "
                         "vectors"))
    r_, k_, v_ = (rnd(B, CHUNK, H, N, scale=0.3) for _ in range(3))
    mask = active[:, None].expand(B, CHUNK).contiguous()
    args = (states[0], r_, k_, v_, w5, u5, mask)
    got, want = wkv56_chunk(*args), wkv56_chunk_plain(*args)
    torch.cuda.synchronize()
    err56 = max(err56, *(close(a, b_, False,
                               f"wkv56 static decay T={CHUNK}")
                         for a, b_ in zip(got, want)))
    check(torch.equal(got[0][5], states[0][5]),
          f"wkv56 static decay T={CHUNK} changed an inactive row's state")
    err56 = max(err56, held_every_split(
        wkv56_chunk, wkv56_chunk_plain,
        lambda b, t: (rnd(b, H, N, N), *(rnd(b, t, H, N, scale=0.3)
                                         for _ in range(3)), w5, u5,
                      torch.ones(b, t, dtype=torch.bool, device=dev)), H))
    print(f"wkv56_t1 (T=1, each split, f32 and layer-path vectors) and "
          f"wkv56_chunk (T={CHUNK}) on v5's static (H, N) decay, B={B} "
          f"H={H} N={N}: max_abs_err {err56:.3e} (tolerance {KERNEL_TOL} x "
          "max(1, |plain|)); inactive row bit-identical", flush=True)

    # ---- v4_wkv ----
    def v4_state(fresh_row):
        aa, pp = rnd(B, C), rnd(B, C)
        bb = torch.rand(B, C, generator=gen, device=dev) + 0.5
        aa[fresh_row], bb[fresh_row], pp[fresh_row] = 0.0, 0.0, PP_INIT
        return aa, bb, pp

    r4 = torch.sigmoid(rnd(B, C))
    k4, v4 = rnd(B, C), rnd(B, C)
    vecs4 = torch.stack([-torch.exp(rnd(C, scale=0.5)), rnd(C, scale=0.5)])
    n_states4 = sets_over_l2(3 * B * C * 4)
    states4 = [v4_state(2) for _ in range(n_states4)]
    state = [t.clone() for t in states4[0]]
    want, *want_state = fd4.v4_wkv_plain(r4, k4, v4, vecs4, active, *state,
                                         cd)
    got = fd4.v4_wkv(r4, k4, v4, vecs4, active, *state, cd)
    torch.cuda.synchronize()
    err = close(got, want, True, "v4_wkv")
    for name, g_, w_, s_ in zip(("aa", "bb", "pp"), state, want_state,
                                states4[0]):
        err = max(err, close(g_, w_, False, f"v4_wkv {name}"))
        check(torch.equal(g_[5], s_[5]),
              f"v4_wkv changed an inactive row's {name}")
    b_ms, b_by = bound(nbytes(r4, k4, v4, vecs4, active) + 3 * B * C * 4
                       + 3 * n_act * C * 4 + B * C * 2, 25 * B * C)
    rows["v4_wkv"] = {
        "name": "v4_wkv", "route": "cuda", "source": SRC4,
        "replaces": REPLACES["v4"], "max_abs_err": err,
        **timed(lambda i: fd4.v4_wkv(r4, k4, v4, vecs4, active,
                                     *states4[i], cd),
                lambda i: fd4.v4_wkv_plain(r4, k4, v4, vecs4, active,
                                           *states4[i], cd), n_states4,
                iters=n_states4),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"v4_wkv B={B} C={C} bf16 ({n_states4} rotating states, row 2 "
          "fresh at "
          f"PP_INIT): max_abs_err {err:.3e} (tolerance {BF16_TOL:.2e} x "
          f"max(1, |plain|) on the bf16 output, {KERNEL_TOL} on the f32 "
          "state); inactive row bit-identical", flush=True)

    # ---- wkv4_chunk at the prefill shape, ragged, short, and at B = 1 ----
    # k and v in bf16, as the path's projections give them.  T = CHUNK and
    # 23 through the chunked kernel and the plan ops/wkv4.plan picks, T = 1
    # (the layer path) and 16 through the step-by-step kernel; each held
    # against the plain version (a fresh PP_INIT row where B > 1, an idle
    # row at B = 8) and timed on inputs rotating past the L2; then large
    # decays (w down to -exp(5)) with holes in the mask and an idle row.
    w4, u4 = vecs4[0].contiguous(), vecs4[1].contiguous()
    worst, shapes = 0.0, {}
    for B_, T, lengths in ((B, CHUNK, [CHUNK] * B),
                           (B, 23, [23, 17, 1, 0, 23, 5, 12, 23]),
                           (B, 16, [16, 9, 1, 0, 16, 5, 12, 16]),
                           (B, 1, [1, 1, 1, 0, 1, 1, 1, 1]),
                           (1, CHUNK, [CHUNK]), (1, 23, [23]),
                           (1, 16, [16]), (1, 1, [1])):
        lens = torch.tensor(lengths, device=dev)
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
        one = 2 * 3 * B_ * C * 4 + 2 * B_ * T * C * 2 + B_ * T * C * 4
        n_sets = sets_over_l2(one)

        def chunk_set():
            aa, bb, pp = v4_state(2)
            return ((aa[:B_], bb[:B_], pp[:B_]), rnd(B_, T, C).to(cd),
                    rnd(B_, T, C).to(cd))

        sets = [chunk_set() for _ in range(n_sets)]
        st, k_, v_ = sets[0]
        got, y_k = wkv4_chunk(*st, k_, v_, w4, u4, mask)
        want, y_p = wkv4_chunk_plain(*st, k_, v_, w4, u4, mask)
        torch.cuda.synchronize()
        worst = max(worst, close(y_k, y_p, False, f"wkv4_chunk B={B_} "
                                                  f"T={T} y"),
                    *(close(a, b_, False, f"wkv4_chunk B={B_} T={T} state")
                      for a, b_ in zip(got, want)))
        if 0 in lengths:
            i = lengths.index(0)
            check(all(torch.equal(a[i], b_[i]) for a, b_ in zip(got, st)),
                  "wkv4_chunk changed an idle row")

        def call(i, fn=wkv4_chunk):
            st_, k_i, v_i = sets[i]
            return fn(*st_, k_i, v_i, w4, u4, mask)

        n_valid = int(mask.sum())
        # State in and out, bf16 k and v, f32 y, w, u, mask.
        b_ms, b_by = bound(one + 2 * C * 4 + B_ * T,
                           C * (25 * n_valid + 13 * (B_ * T - n_valid)))
        shapes[(B_, T)] = {
            "ms": device_ms(rotating(call, n_sets), 4 * n_sets),
            "bound_ms": b_ms, "bound_by": b_by,
            "plan": "steps" if wkv4.sequential(T) else wkv4.plan(T)}
        if (B_, T) == (B, CHUNK):
            rows["wkv4_chunk"] = {
                "name": "wkv4_chunk", "route": "cuda", "source": SRC4,
                "replaces": "ai00_server_tpu/models/v4.py:49 (_wkv_scan, "
                            "a lax.scan: no Pallas kernel)",
                "ms": shapes[(B_, T)]["ms"],
                "plain_ms": device_ms(
                    lambda: call(0, wkv4_chunk_plain), 1, replays=3),
                "call_ms": call_ms(rotating(call, n_sets), 50),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
        del sets
    st = v4_state(2)
    k_, v_ = rnd(B, CHUNK, C).to(cd), rnd(B, CHUNK, C).to(cd)
    w_hard = -torch.exp(torch.rand(C, generator=gen, device=dev) * 10 - 5)
    mask = torch.rand(B, CHUNK, generator=gen, device=dev) > 0.25
    mask[3] = False
    got, y_k = wkv4_chunk(*st, k_, v_, w_hard, u4, mask)
    want, y_p = wkv4_chunk_plain(*st, k_, v_, w_hard, u4, mask)
    torch.cuda.synchronize()
    worst = max(worst, close(y_k, y_p, False, "wkv4_chunk large decays y"),
                *(close(a, b_, False, "wkv4_chunk large decays state")
                  for a, b_ in zip(got, want)))
    check(all(torch.equal(a[3], b_[3]) for a, b_ in zip(got, st)),
          "wkv4_chunk changed an idle row")
    rows["wkv4_chunk"]["max_abs_err"] = worst
    rows["wkv4_chunk"]["shapes_ms"] = shapes
    print(f"wkv4_chunk C={C} bf16 k and v, T={CHUNK}, ragged T=23, T=16 and "
          f"T=1 at B={B} and 1 (rotating inputs; a fresh PP_INIT row), and "
          f"T={CHUNK} "
          "with time_decay in [-5, 5) and holes in the mask: max_abs_err "
          f"{worst:.3e} (tolerance {KERNEL_TOL} x max(1, |plain|), y at "
          "every step); idle rows bit-identical", flush=True)
    print("wkv4_chunk device ms (plan (G, NS), or steps; bound): "
          + "; ".join(f"B={b_} T={t} {r['ms']:.5f} ({r['plan']}; "
                      f"{r['bound_ms']:.5f} by {r['bound_by']})"
                      for (b_, t), r in shapes.items()), flush=True)

    # ---- each stack's v7_ln_mix and v7_skinny_matmul launches ----
    def weight(K, Nout):
        return (rnd(K, Nout) / K ** 0.5).to(cd)

    def launch(F, gname):
        """One set of a launch's products, fresh weights and inputs."""
        xs = rnd(B, max(C, F), scale=0.5).to(cd)
        P = fd.Product

        def x_(K):
            return xs[:, :K].contiguous()

        if gname == "rkvg":  # v5: r, k, v rounded, g SiLU
            return [P(x_(C), weight(C, C), round_cd=True, out="f32")
                    for _ in range(3)] + [
                P(x_(C), weight(C, C), act="silu", out="f32")]
        if gname == "rkv":  # v4: sigmoid(r), k, v rounded
            return [P(x_(C), weight(C, C), act="sigmoid", out="f32")] + [
                P(x_(C), weight(C, C), round_cd=True, out="f32")
                for _ in range(2)]
        if gname == "wo":
            return [P(x_(C), weight(C, C), out="add", y=rnd(B, C))]
        if gname == "fkey_frec":
            return [P(x_(C), weight(C, F), act="relu2"),
                    P(x_(C), weight(C, C), act="sigmoid", out="f32")]
        return [P(x_(F), weight(F, C), out="gadd", y=rnd(B, C),
                  gate=torch.sigmoid(rnd(B, C)))]

    for version, F, n_mix, first in (("v5", F5, 4, "rkvg"),
                                     ("v4", F4, 3, "rkv")):
        # LayerNorm 1 with the time mix's mixes, LayerNorm 2 with the
        # channel mix's two.
        rows[f"v7_ln_mix ({version})"] = ln_mix_row(
            fd, rnd, close, active, C, cd, ((n_mix, False), (2, False)),
            f"v7_ln_mix ({version})", REPLACES[version])
        rows[f"v7_skinny_matmul ({version})"] = skinny_row(
            fd, functools.partial(launch, F),
            (first, "wo", "fkey_frec", "fval"), close,
            f"v7_skinny_matmul ({version})", REPLACES[version], version)
    print_rows(rows)
    return rows


# The retrieval north star's shape cut to about a minute on one H100
# (BASELINE.json's "Full RAG serve", bench.py:bench_ivf): a mixture of IVF_MODES unit modes
# with noise of norm IVF_SIGMA, D = 1024, int8 codes in nlist = 1024
# clusters, 2^20 vectors (the TPU bench's 10M cut to 1/10).
IVF_N, IVF_D, IVF_CHUNK = 1 << 20, 1024, 1 << 16
IVF_MODES, IVF_SIGMA, IVF_NLIST, IVF_TRAIN = 16384, 0.35, 1024, 4
IVF_Q, IVF_CHECK_Q, IVF_RECALL_Q = 64, 16, 256
IVF_SMALL_N, IVF_SMALL_NLIST = 1 << 16, 64  # the bf16 and f32 indexes


# The decode WKV stages at the widths the stacks serve them: v7 and v5 0.4B
# (H = 16), v6 1B6 (H = 32), v7 2.9B (H = 40; the phased stacks at B = 64).
# (row of the kernels line, kind, H)
WKV_GN_WIDTHS = (("v7_wkv_gn", "v7", C // HEAD),
                 ("v7_wkv_gn", "v7", C29 // HEAD),
                 ("v6_wkv_gn", "v6", C6 // HEAD),
                 ("v6_wkv_gn (v5)", "v5", C // HEAD))
# The batches they are held at: the fused stacks' 1 ... 8 (5: a ragged
# one) and the phased stacks' 16 and 64.
WKV_GN_HELD_BS = (1, 5, MAX_BATCH, 16, WIDE_BATCH)


def wkv_gn_case(kind: str, B: int, H: int, dev, seed: int, mode: bool,
                N: int = HEAD):
    """One call of a decode WKV stage in bf16 at (B, H, N), every row active:
    ``mode`` is ``is_first`` for v7 and ``round_yf`` for v5 / v6.  Returns
    (kernel(S, vf) -> out, plain(S, vf) -> (out, S_new, vf_new), mirror(S,
    vf) -> the same in the kernel's order (``*_wkv_gn_mirror``), v_first or
    None, active, bytes besides the state)."""
    import torch

    from ai00_server_tpu_torch.ops import v6_decode as fd6
    from ai00_server_tpu_torch.ops import v7_decode as fd

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    Cw, cd = H * N, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    active = torch.ones(B, dtype=torch.bool, device=dev)
    if kind == "v7":
        r, k, v, g, vf = (rnd(B, Cw, scale=0.5) for _ in range(5))
        w = torch.exp(-0.6065306597126334 * torch.sigmoid(rnd(B, Cw)))
        a, vmix = torch.sigmoid(rnd(B, Cw)), torch.sigmoid(rnd(B, Cw))
        vecs = rnd(8, Cw, scale=0.5)
        args = (r, k, v, w, a, g, vmix)
        return (lambda S, vf_: fd.v7_wkv_gn(*args, vf_, vecs, active, S,
                                            mode, cd),
                lambda S, vf_: fd.v7_wkv_gn_plain(*args, vf_, vecs, active,
                                                  S, mode, cd),
                lambda S, vf_: fd.v7_wkv_gn_mirror(*args, vf_, vecs, active,
                                                   S, mode, cd),
                vf, active, nbytes(*args, vf, active) + 5 * Cw * 4
                + B * Cw * 2)
    r, k, v = (rnd(B, Cw, scale=0.5) for _ in range(3))
    g = torch.nn.functional.silu(rnd(B, Cw))
    vecs = rnd(4, Cw, scale=0.5)
    w = None
    if kind == "v5":
        vecs[0] = torch.exp(-torch.exp(vecs[0]))
    else:
        w = torch.exp(-torch.exp(rnd(B, Cw, scale=0.5)))
    args = (r, k, v, w, g, vecs, active)
    return (lambda S, vf_: fd6.v6_wkv_gn(*args, S, cd, mode),
            lambda S, vf_: (*fd6.v6_wkv_gn_plain(*args, S, cd, mode), None),
            lambda S, vf_: (*fd6.v6_wkv_gn_mirror(*args, S, cd, mode), None),
            None, active, nbytes(r, k, v, w, g, active)
            + (4 if w is None else 3) * Cw * 4 + B * Cw * 2)


def phase_wkv_gn_batches(dev, rows: dict) -> None:
    """``v7_wkv_gn`` (``is_first`` both ways) and ``v6_wkv_gn`` (v6's dense
    decay and v5's static one, ``ln_x`` rounded as the fused stacks do and
    gated in f32 as the phased ones do) at every width of
    ``WKV_GN_WIDTHS`` and batch of ``WKV_GN_HELD_BS``, against the PyTorch
    mirror of its order (the state at KERNEL_TOL) and its plain version
    (the state at KERNEL_TOL; v7 above the fused stacks' 8 rows at
    ``V7_WIDE_STATE_TOL``, where the plain version's other order of the
    removal key's norm flips some bf16 roundings of kk), the bf16 output at
    BF16_TOL against both, all x max(1, |reference|); row 1 idle where B >
    1, its state bit for bit; ``v_first`` equal.  Then each width timed at
    B = 64, every row active, on states rotating past the L2:
    ``rows[row]["b64"]``."""
    import torch

    for row, kind, H in WKV_GN_WIDTHS:
        worst = 0.0
        for B in WKV_GN_HELD_BS:
            for mode in (True, False):
                kernel, plain, mirror, vf, active, _ = wkv_gn_case(
                    kind, B, H, dev, SEED + 40 + B + H, mode)
                if B > 1:
                    active[1] = False
                gen = torch.Generator(device=dev)
                gen.manual_seed(SEED + 41 + B)
                S = torch.randn(B, H, HEAD, HEAD, generator=gen, device=dev)
                S_k = S.clone()
                vf_k = None if vf is None else vf.clone()
                want, S_want, vf_want = plain(S, vf)  # between: S is read
                got_m, S_m, _ = mirror(S, vf)         # before the wait
                got = kernel(S_k, vf_k)
                torch.cuda.synchronize()
                what = f"{row} H={H} B={B} (mode {mode})"
                wide = kind == "v7" and B > MAX_BATCH
                for a, b, tol, ref in (
                        (got, want, BF16_TOL, "plain version"),
                        (S_k, S_want, V7_WIDE_STATE_TOL if wide
                         else KERNEL_TOL, "plain version"),
                        (got, got_m, BF16_TOL, "mirror"),
                        (S_k, S_m, KERNEL_TOL, "mirror")):
                    err, rel = rel_err(a.float(), b.float())
                    check(rel <= tol, f"{what} disagrees with its {ref}: "
                          f"{err:.3e}")
                    worst = max(worst, err)
                if B > 1:
                    check(torch.equal(S_k[1], S[1]),
                          f"{what} changed an inactive row's state")
                if vf is not None:
                    check(torch.equal(vf_k, vf_want), f"{what} v_first")
                del S, S_k, S_want
        wide = ("" if kind != "v7" else f", {V7_WIDE_STATE_TOL:.1e} "
                "against the plain version above B=8")
        print(f"{row} H={H}, B = {', '.join(map(str, WKV_GN_HELD_BS))}, "
              f"both modes, row 1 "
              f"idle: max_abs_err {worst:.3e} against the plain version "
              f"and the mirror (tolerance {BF16_TOL:.2e} x max(1, |ref|) "
              f"on the bf16 output, {KERNEL_TOL} on the f32 state{wide}); "
              "idle row bit-identical", flush=True)
        rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], worst)

        B = WIDE_BATCH
        kernel, _, _, vf, _, other = wkv_gn_case(kind, B, H, dev,
                                                 SEED + 42 + H, True)
        state_bytes = B * H * HEAD * HEAD * 4
        n = max(3, int(L2_BYTES // state_bytes) + 2)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 43)
        states = [torch.randn(B, H, HEAD, HEAD, generator=gen, device=dev)
                  for _ in range(n)]
        ms = device_ms(rotating(lambda i: kernel(states[i], vf), n), 100)
        b_ms, b_by = bound(2 * state_bytes + other, 9 * B * H * HEAD * HEAD)
        rows[row].setdefault("b64", {})[f"H={H}"] = {
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by}
        print(f"{row} B={B} H={H} bf16 ({n} rotating states, every row "
              f"active): {ms:.5f} ms on the device, bound {b_ms:.5f} ms by "
              f"{b_by}", flush=True)
        del states
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Head sizes other than 64: the WKV kernels built once per head size
# ---------------------------------------------------------------------------

HEAD_ROWS = (
    # (row, kernel source, the TPU kernel it replaces)
    ("wkv7_t1", "ai00_server_tpu_torch/csrc/wkv7.cu",
     "ai00_server_tpu/ops/wkv_t1.py:108"),
    ("wkv7_chunk", "ai00_server_tpu_torch/csrc/wkv7.cu",
     "ai00_server_tpu/ops/wkv_pallas.py:174"),
    ("v7_wkv_gn", "ai00_server_tpu_torch/csrc/v7_wkv_gn.cu",
     "ai00_server_tpu/ops/v7_decode_pallas.py:274"),
    ("wkv56_t1", "ai00_server_tpu_torch/csrc/wkv56.cu",
     "ai00_server_tpu/ops/wkv_t1.py:123"),
    ("wkv56_chunk", "ai00_server_tpu_torch/csrc/wkv56.cu",
     "ai00_server_tpu/ops/wkv_pallas.py:209"),
    ("v6_wkv_gn", "ai00_server_tpu_torch/csrc/v6_decode.cu",
     "ai00_server_tpu/ops/v6_decode_pallas.py:236"),
    ("v6_wkv_gn (v5)", "ai00_server_tpu_torch/csrc/v6_decode.cu",
     "ai00_server_tpu/ops/v5_decode_pallas.py:213"),
)


def head_row(row: str, N: int) -> str:
    """The kernels line's name of ``row`` at head size N."""
    return (f"{row[:-1]}, N={N})" if row.endswith(")")
            else f"{row} (N={N})")


def start_head_build() -> dict:
    """The WKV sources for every N of HEAD_SIZES, built in a thread (one
    ``nvcc`` each, all started together) while phases 2 and 3 run;
    :func:`join_head_build` waits for them."""
    import threading

    from ai00_server_tpu_torch.ops import _build

    box = {"started": time.monotonic()}

    def run():
        try:
            _build.build_all(heads=tuple(HEAD_SIZES))
        except Exception as e:  # noqa: BLE001 - reported by the join
            box["error"] = e
        box["seconds"] = time.monotonic() - box["started"]

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def join_head_build(box: dict) -> None:
    """Waits for :func:`start_head_build`'s thread; fails on its error and
    prints its time and each kernel's registers and spills."""
    from ai00_server_tpu_torch.ops import _build

    t0 = time.monotonic()
    box["thread"].join()
    if "error" in box:
        fail(f"the head-size build failed: {box['error']}")
    print(f"built the WKV sources {list(_build.HEAD_SOURCES)} for head "
          f"sizes {list(HEAD_SIZES)} in {box['seconds']:.1f} s beside phases "
          f"2-3 (waited {time.monotonic() - t0:.1f} s for them)", flush=True)
    for name, info in sorted(_build.ptxas_info.items()):
        if "(N=" not in name:
            continue
        fn = None
        for line in info.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1][:48]
            if "registers" in line or ("spill" in line and
                                       " 0 bytes spill stores" not in line):
                print(f"  {name} {fn}: {line.strip()}", flush=True)


def head_wkv_case(kind: str, B: int, H: int, N: int, dev, seed: int,
                  T: int = 1):
    """(kernel, plain, args without the state and mask, bytes besides the
    state, operations per state element and step) of a WKV kernel at head
    size N: "wkv7_t1", "wkv56_t1", "wkv56_t1 static", "wkv7_chunk",
    "wkv56_chunk"; f32 vectors, T steps for the chunks."""
    import torch

    from ai00_server_tpu_torch.ops import wkv_chunk, wkv_t1

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (B, H, N) if T == 1 and "chunk" not in kind else (B, T, H, N)
    if kind.startswith("wkv7"):
        _, seqs = wkv_inputs(gen, B, T, H, N, dev)
        seqs = [x[:, 0].contiguous() for x in seqs] if "t1" in kind else seqs
        kernel, plain = ((wkv_t1.wkv7_t1, wkv_t1.wkv7_t1_plain)
                         if "t1" in kind else
                         (wkv_chunk.wkv7_chunk, wkv_chunk.wkv7_chunk_plain))
        return kernel, plain, list(seqs), nbytes(*seqs), 9

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    r, k, v = (rnd(*shape, scale=0.3) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(*((H, N) if "static" in kind else shape),
                                 scale=0.5)))
    u = rnd(H, N, scale=0.5)
    kernel, plain = ((wkv_t1.wkv56_t1, wkv_t1.wkv56_t1_plain)
                     if "t1" in kind else
                     (wkv_chunk.wkv56_chunk, wkv_chunk.wkv56_chunk_plain))
    return kernel, plain, [r, k, v, w, u], nbytes(r, k, v, w, u), 7


def head_splits(kind: str, N: int):
    """The splits of a head the kernel takes at N, and the module attribute
    (the plan) that picks one."""
    from ai00_server_tpu_torch.ops import wkv_chunk, wkv_t1

    if "chunk" in kind:
        return wkv_chunk.splits(N), (wkv_chunk, "plan")
    return wkv_t1.splits(N), (wkv_t1, "plan56" if "56" in kind else "plan")


def head_held(kind: str, B: int, H: int, N: int, dev, T: int) -> float:
    """The kernel against its plain version at every split of a head
    (the plan forced), row 1 idle (its state bit for bit), T steps for the
    chunks with a masked step inside row 0: the worst max abs error."""
    import torch

    kernel, plain, args, _, _ = head_wkv_case(kind, B, H, N, dev,
                                              SEED + 60 + N + B, T)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 61 + N)
    S = torch.randn(B, H, N, N, generator=gen, device=dev)
    if "chunk" in kind:
        mask = torch.ones(B, T, dtype=torch.bool, device=dev)
        mask[0, T // 3] = False
    else:
        mask = torch.ones(B, dtype=torch.bool, device=dev)
    mask[1] = False
    S_p, y_p = plain(S, *args, mask)
    splits, (mod, attr) = head_splits(kind, N)
    planned, worst = getattr(mod, attr), 0.0
    try:
        for s in splits:
            setattr(mod, attr, lambda *a, s=s: s)
            torch.cuda.synchronize()  # the one-step kernels read S first
            S_k, y_k = kernel(S, *args, mask)
            torch.cuda.synchronize()
            what = f"{kind} N={N} B={B} H={H} ({s} block(s) a head)"
            for got, want, part in ((S_k, S_p, "state"), (y_k, y_p, "y")):
                err, rel = rel_err(got, want)
                check(rel <= KERNEL_TOL, f"{what} {part} disagrees with its "
                      f"plain version: {rel:.3e} of max(1, |plain|)")
                worst = max(worst, err)
            check(torch.equal(S_k[1], S[1]), f"{what} changed an idle row")
    finally:
        setattr(mod, attr, planned)
    return worst


def phase_head_kernels(dev, rows64: dict) -> dict:
    """Every WKV kernel of HEAD_ROWS at each N of HEAD_SIZES (C = H N),
    B = 8 and 64: held against its plain version at every split of a head
    (the chunks at T = 64, a masked step inside), then timed with every row
    active on states rotating past the L2 at the planned split (the chunks
    at T = CHUNK, B = 8, and T = 64, B = 64), beside its bound and the
    N = 64 row of phase 2.  Returns the kernels line's rows."""
    import torch

    rows = {}
    for N, Cn in HEAD_SIZES.items():
        H = Cn // N
        for row, source, replaces in HEAD_ROWS:
            t0 = time.monotonic()
            name, worst, shapes = head_row(row, N), 0.0, {}
            gn = "wkv_gn" in row
            for B in HEAD_BS:
                T = CHUNK if B == HEAD_BS[0] else 64
                if gn:
                    kind = "v7" if row == "v7_wkv_gn" else (
                        "v5" if "(v5)" in row else "v6")
                    for mode in (True, False):
                        worst = max(worst, head_gn_held(kind, B, H, N, dev,
                                                        mode))
                    kernel, plain, _, vf, _, other = wkv_gn_case(
                        kind, B, H, dev, SEED + 62 + N, True, N)
                    flops, step = 9 * B * H * N * N, (vf,)
                else:
                    kind, tt = row, (T if "chunk" in row else 1)
                    worst = max(worst, head_held(kind, B, H, N, dev,
                                                 64 if tt > 1 else 1))
                    if row == "wkv56_t1":
                        worst = max(worst, head_held("wkv56_t1 static", B,
                                                     H, N, dev, 1))
                    kernel, plain, args, other, ops = head_wkv_case(
                        kind, B, H, N, dev, SEED + 63 + N, tt)
                    mask = torch.ones((B, tt) if tt > 1 else (B,),
                                      dtype=torch.bool, device=dev)
                    step = (*args, mask)
                    other += mask.numel() + B * tt * H * N * 4  # + y
                    flops = ops * B * tt * H * N * N
                state_bytes = B * H * N * N * 4
                n = max(3, int(2 * L2_BYTES // state_bytes) + 1)
                gen = torch.Generator(device=dev)
                gen.manual_seed(SEED + 64 + N)
                states = [torch.randn(B, H, N, N, generator=gen, device=dev)
                          for _ in range(n)]
                iters = 20 if "chunk" in row else 100
                ms = device_ms(rotating(lambda i: kernel(states[i], *step),
                                        n), max(iters, n))
                b_ms, b_by = bound(2 * state_bytes + other, flops)
                shapes[B] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
                if B == HEAD_BS[0]:
                    plain_ms = device_ms(
                        lambda: plain(states[0], *step), 1 if "chunk" in row
                        else 20, replays=3)
                del states
            r64 = rows64.get(row, {})
            b8, b64 = shapes[HEAD_BS[0]], shapes[HEAD_BS[-1]]
            rows[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": worst,
                "ms": b8["ms"], "plain_ms": plain_ms,
                "bound_ms": b8["bound_ms"], "bound_by": b8["bound_by"],
                "library_ms": None, "b64": b64, "H": H,
            }
            t_desc = ("T=256 at B=8, T=64 at B=64" if "chunk" in row
                      else "T=1")
            held_at = "in both modes" if gn else "at every split"
            print(f"{name} H={H} C={Cn} ({t_desc}): held {held_at}, "
                  f"B={HEAD_BS[0]} and {HEAD_BS[-1]}, row 1 idle: max_abs_err "
                  f"{worst:.3e} (tolerance {KERNEL_TOL} x max(1, |plain|) on "
                  f"f32, {BF16_TOL:.2e} on bf16 outputs); idle row "
                  f"bit-identical; B={HEAD_BS[0]} {b8['ms']:.5f} ms (bound "
                  f"{b8['bound_ms']:.5f} by {b8['bound_by']}; plain "
                  f"{plain_ms:.5f}), B={HEAD_BS[-1]} {b64['ms']:.5f} ms "
                  f"(bound {b64['bound_ms']:.5f}); N=64 row "
                  + (f"{r64['ms']:.5f} ms (bound {r64['bound_ms']:.5f})"
                     if r64 else "-")
                  + f"; {time.monotonic() - t0:.1f} s", flush=True)
            torch.cuda.empty_cache()
    return rows


def head_gn_held(kind: str, B: int, H: int, N: int, dev,
                 mode: bool) -> float:
    """A decode WKV stage (``wkv_gn_case``) at head size N against its plain
    version and its mirror, row 1 idle: the worst max abs error."""
    import torch

    kernel, plain, mirror, vf, active, _ = wkv_gn_case(
        kind, B, H, dev, SEED + 65 + N + B, mode, N)
    active[1] = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 66 + B)
    S = torch.randn(B, H, N, N, generator=gen, device=dev)
    S_k = S.clone()
    vf_k = None if vf is None else vf.clone()
    want, S_want, vf_want = plain(S, vf)  # between: S is read
    got_m, S_m, _ = mirror(S, vf)         # before the wait
    got = kernel(S_k, vf_k)
    torch.cuda.synchronize()
    what, worst = f"{kind}_wkv_gn N={N} H={H} B={B} (mode {mode})", 0.0
    wide = kind == "v7" and B > MAX_BATCH
    for a, b, tol, ref in (
            (got, want, BF16_TOL, "plain version"),
            (S_k, S_want, V7_WIDE_STATE_TOL if wide else KERNEL_TOL,
             "plain version"),
            (got, got_m, BF16_TOL, "mirror"),
            (S_k, S_m, KERNEL_TOL, "mirror")):
        err, rel = rel_err(a.float(), b.float())
        check(rel <= tol, f"{what} disagrees with its {ref}: {err:.3e}")
        worst = max(worst, err)
    check(torch.equal(S_k[1], S[1]), f"{what} changed an idle row's state")
    if vf is not None:
        check(torch.equal(vf_k, vf_want), f"{what} v_first")
    return worst


def head_info(version: str, N: int, num_layer: int = 2,
              vocab: int = PHASED_VOCAB):
    """A model of head size N at HEAD_SIZES[N]'s width: FFN 4 C (v7) or
    int(3.5 C) // 32 * 32 (v6, v5: RWKV-LM's x052 / x060)."""
    from ai00_server_tpu_torch.models.info import ModelInfo, ModelVersion

    Cn = HEAD_SIZES[N]
    F = 4 * Cn if version == "v7" else int(3.5 * Cn) // 32 * 32
    return ModelInfo(version=ModelVersion(version.upper()),
                     num_layer=num_layer, num_emb=Cn, num_hidden=F,
                     num_vocab=vocab, num_head=Cn // N, head_size=N)


def phase_head_parity(dev) -> dict:
    """v7, v6 and v5 at every N of HEAD_SIZES, 2 layers, f32: a ragged
    prefill (T = 40) and three decode steps (row 2 idle) on the layer path
    and on the fused stack (eager ``forward_t1``), each on the card against
    the same path on the CPU (MODEL_TOL), the idle row's state bit for bit;
    at N = 128 also the phased stack at B = 16 in bf16 (``forward_t1``
    against ``forward_t1_plain`` on the card at BF16_MODEL_TOL, every launch
    in lockstep with its plain version).  The WKV kernels' launches on
    these paths, by the kernels line's row names."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import get_version_module
    from ai00_server_tpu_torch.ops import fused_decode, wkv_chunk, wkv_t1
    from ai00_server_tpu_torch.ops import v6_decode as fd6
    from ai00_server_tpu_torch.ops import v7_decode as fd7
    from ai00_server_tpu_torch.testing import make_raw_weights

    counted = {"wkv7_t1": wkv_t1.wkv7_t1, "wkv7_chunk": wkv_chunk.wkv7_chunk,
               "wkv56_t1": wkv_t1.wkv56_t1,
               "wkv56_chunk": wkv_chunk.wkv56_chunk,
               "v7_wkv_gn": fd7.v7_wkv_gn, "v6_wkv_gn": fd6.v6_wkv_gn}
    launches = {}
    rng = np.random.default_rng(SEED + 70)
    B, T = 4, 40
    lengths = np.array([40, 33, 1, 0], np.int32)
    steps = [(rng.integers(1, PHASED_VOCAB, (B, T)), lengths)] + [
        (rng.integers(1, PHASED_VOCAB, (B, 1)),
         np.array([1, 1, 0, 1], np.int32)) for _ in range(3)]

    def counts(version):
        got = {}
        for name, k in counted.items():
            row = "v6_wkv_gn (v5)" if (name == "v6_wkv_gn"
                                       and version == "v5") else name
            got[row] = k.launches
        return got

    for N in HEAD_SIZES:
        for version in ("v7", "v6", "v5"):
            t0 = time.monotonic()
            info = head_info(version, N)
            module = get_version_module(info.version)
            fd = fused_decode.module_for(info.version.value)
            math = make_raw_weights(info, seed=SEED + N, dtype=np.float32,
                                    lora_dims=lora_dims(version))
            if version != "v7":
                math = fan_in_scaled(math)
            cpu = stack_params(info, math, dtype=torch.float32, device="cpu")
            check(fd.can_fuse(cpu), f"the {version} N={N} model does not "
                  "fuse")
            params = {"cpu": cpu, dev: params_to(cpu, dev)}

            def run(p, d):
                state = module.init_state(info, B, device=d)
                outs = []
                for toks, lens in steps:
                    lt = torch.as_tensor(lens, device=d)
                    h, new = module.forward(p, state,
                                            torch.as_tensor(toks, device=d),
                                            lt)
                    if new is not state:
                        for k, t in state.items():
                            t.copy_(new[k])
                    outs.append((h.float().cpu(),
                                 {k: t.cpu().clone()
                                  for k, t in state.items()}))
                return outs

            line = []
            for how in ("layer", "fused"):
                p = {d: (q if how == "layer" else
                         {**q, fd.FUSED_KEY: fd.make_fused_layout(q)})
                     for d, q in params.items()}
                ref = run(p["cpu"], "cpu")
                for k in counted.values():
                    k.launches = 0
                got = run(p[dev], dev)
                torch.cuda.synchronize()
                for row, n in counts(version).items():
                    key = head_row(row, N)
                    launches[key] = launches.get(key, 0) + n
                worst = 0.0
                for (toks, lens), (h, st), (h_r, st_r) in zip(steps, got,
                                                              ref):
                    m = (torch.arange(toks.shape[1])[None, :]
                         < torch.as_tensor(lens)[:, None])
                    for a, b in [(h[m], h_r[m])] + [(st[k], st_r[k])
                                                    for k in st_r]:
                        check(bool(torch.isfinite(a).all()),
                              f"{version} N={N} {how}: non-finite output")
                        worst = max(worst, float((a.double() - b.double())
                                                 .abs().max())
                                    / max(float(b.abs().max()), 1e-6))
                check(worst <= MODEL_TOL, f"{version} N={N} {how} path: card "
                      f"and CPU disagree, {worst:.3e} > {MODEL_TOL}")
                for k, t in got[0][1].items():
                    check(torch.equal(got[-1][1][k][:, 2], t[:, 2]),
                          f"{version} N={N} {how} path changed an idle row")
                line.append(f"{how} {worst:.3e}")
            phased = ""
            if N == max(HEAD_SIZES):
                phased = head_phased(dev, info, math, version, launches)
            print(f"head-size parity {version} N={N} (C={info.num_emb}, "
                  f"H={info.num_head}, 2 layers, f32, ragged prefill T={T} + "
                  f"3 decode steps, row 2 idle): max |card - cpu| / max "
                  f"|cpu| {', '.join(line)} (tolerance {MODEL_TOL}); idle "
                  f"row bit-identical{phased}; {time.monotonic() - t0:.1f} s",
                  flush=True)
            del params, math
            gc.collect()
            torch.cuda.empty_cache()
    return launches


def head_phased(dev, info, math, version: str, launches: dict) -> str:
    """The phased stack of a bf16 model at B = 16 on the card: three decode
    steps from a ragged prefill, ``forward_t1`` against
    ``forward_t1_plain`` (BF16_MODEL_TOL) and in lockstep; adds its WKV
    launches to ``launches``.  A line for the printout."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import get_version_module
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.ops import v6_decode as fd6
    from ai00_server_tpu_torch.ops import v7_decode as fd7

    B, N = PHASED_BS[0], info.head_size
    module = get_version_module(info.version)
    p16 = stack_params(info, math, dtype=torch.bfloat16, device=dev)
    fd = fused_decode.module_for(info.version.value)
    p16[fd.FUSED_KEY] = fd.make_fused_layout(p16)
    pd = fused_decode.stack_for(info.version.value, p16, B)
    check(pd is not None and pd is not fd,
          f"the {version} N={N} model does not take a phased stack at B={B}")
    rng = np.random.default_rng(SEED + 71)
    lens = rng.integers(1, 9, B).astype(np.int32)
    lens[2] = 0
    _, s0 = module.forward(
        p16, module.init_state(info, B, device=dev),
        torch.as_tensor(rng.integers(1, info.num_vocab, (B, 8)), device=dev),
        torch.as_tensor(lens, device=dev))
    l1 = np.ones(B, np.int32)
    l1[2] = 0
    steps = [rng.integers(1, info.num_vocab, (B, 1)) for _ in range(3)]

    def decode(fwd) -> list:
        state = {k: t.clone() for k, t in s0.items()}
        outs = []
        for t1 in steps:
            h = fwd(p16, state, torch.as_tensor(t1, device=dev),
                    torch.as_tensor(l1, device=dev))[0]
            outs.append([h[l1 > 0].float().clone()]
                        + [state[k].clone() for k in s0])
        return outs

    gn = fd7.v7_wkv_gn if version == "v7" else fd6.v6_wkv_gn
    gn.launches = 0
    got = decode(pd.forward_t1)
    torch.cuda.synchronize()
    row = head_row({"v7": "v7_wkv_gn", "v6": "v6_wkv_gn",
                    "v5": "v6_wkv_gn (v5)"}[version], N)
    launches[row] = launches.get(row, 0) + gn.launches
    plain = decode(pd.forward_t1_plain)
    per_step = [max(float((a.double() - b.double()).abs().max())
                    / max(float(b.abs().max()), 1e-6) for a, b in zip(o, r))
                for o, r in zip(got, plain)]
    check(max(per_step) <= BF16_MODEL_TOL,
          f"the phased {version} N={N} stack at B={B} and forward_t1_plain "
          f"disagree: {per_step}")
    for i, k in enumerate(s0):
        check(torch.equal(got[-1][1 + i][:, 2], s0[k][:, 2]),
              f"the phased {version} N={N} stack changed an idle row")
    lock = {}
    decode(functools.partial(pd._forward, lockstep(
        pd._OPS, pd._PLAIN_OPS, lock,
        {"wkv_gn": V7_WIDE_STATE_TOL} if version == "v7" else {})))
    check(max(lock.values()) <= 1.0,
          f"a launch of the phased {version} N={N} stack at B={B} "
          f"disagrees with its plain version: {lock}")
    return (f"; phased stack bf16 B={B}: max |kernels - plain| / max "
            f"|plain| per step " + " / ".join(f"{x:.3e}" for x in per_step)
            + f" (tolerance {BF16_MODEL_TOL}), in lockstep worst error / "
            "tolerance " + ", ".join(f"{k} {v:.3g}" for k, v in lock.items()))


def write_site_head(tmp: Path):
    """The random RWKV-7 of head size 128 (H = 8) at the 0.4B width, L128
    layers (f16 on disk), and its bf16 config, beside the vocabulary
    ``write_site`` left in ``tmp``."""
    import numpy as np

    from ai00_server_tpu_torch.loader import save_safetensors
    from ai00_server_tpu_torch.testing import (make_raw_weights,
                                               to_converted_layout)

    t0 = time.monotonic()
    N = max(HEAD_SIZES)
    raw = make_raw_weights(head_info("v7", N, L128, VOCAB), seed=SEED,
                           dtype=np.float32, lora_dims=LORA)
    conv = to_converted_layout(raw)
    del raw
    path = tmp / f"rwkv7-0.4b-n{N}.st"
    save_safetensors(conv, str(path))
    del conv
    cfg = tmp / "Config-v7-n128.toml"
    cfg.write_text(f"""
[model]
name = "{path.name}"
path = "{tmp}"
max_batch = {MAX_BATCH}
token_chunk_size = {CHUNK}
precision = "Fp16"
quant = 0
prewarm = false

[tokenizer]
path = "{tmp / 'vocab.json'}"

[listen]
ip = "127.0.0.1"
port = 0
""")
    print(f"wrote the random {L128}-layer v7 0.4B-width checkpoint of head "
          f"size {N} (H={HEAD_SIZES[N] // N}; "
          f"{path.stat().st_size / 1e9:.2f} GB) in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return cfg, path


# The layer path's WKV kernels at the shapes a tp place gives them
# (mesh_flow's RWKV-6 / -5 / -4 at tp = 2): v6 1B6 on H / 2 = 16 heads
# (dense decay), v5 0.4B on 8 (static decay), v4 0.4B on C / 2 = 512
# channels; B = 8 rows (a [1, 2] mesh) and 4 (a dp rank of [2, 2]).
TP_BS = (MAX_BATCH, MAX_BATCH // 2)


def phase_tp_kernels(dev, rows: dict) -> None:
    """Rows 10 (``wkv56_t1``), 11 (``wkv56_chunk``) and 15d
    (``wkv4_chunk``) at their tp shapes: each held against its plain
    version at KERNEL_TOL (the chunks at T = CHUNK with a ragged row, v4
    at T = 1 too; ``wkv56_t1`` at every split with an idle row, on f32
    and on the layer path's vectors) and timed on inputs rotating past the
    L2, beside its bound (``wkv56_t1`` also as the whole call on the layer
    path's vectors); kept as ``rows[name]["tp"]``."""
    import torch

    from ai00_server_tpu_torch.ops.wkv4 import wkv4_chunk, wkv4_chunk_plain
    from ai00_server_tpu_torch.ops.wkv_chunk import (wkv56_chunk,
                                                     wkv56_chunk_plain)
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv56_t1, wkv56_t1_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    N, card = HEAD, card_line()

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def flat(outs):
        return [t for o in outs for t in (o if isinstance(o, tuple) else (o,))]

    def case(kernel, plain, make, nbytes_, flops, what, t56=False):
        """``t56``: ``wkv56_t1``, held at every split on f32 and on the
        layer path's vectors (:func:`held_t56`, an idle row) and also timed
        on the latter as ``layer_ms``."""
        first = make()
        if t56:
            S, *vecs, ones = first
            idle = ones.clone()
            idle[1] = False
            err = max(held_t56(S, vecs, idle, f"{what} f32"),
                      held_t56(S, t56_layer(vecs), idle,
                               f"{what} layer-path vectors"))
        else:
            got, want = flat(kernel(*first)), flat(plain(*first))
            torch.cuda.synchronize()
            err = 0.0
            for a, b in zip(got, want):
                e, rel = rel_err(a, b)
                check(rel <= KERNEL_TOL, f"{what} disagrees with its plain "
                      f"version: {rel:.3e} of max(1, |plain|)")
                err = max(err, e)
        n = int(2 * L2_BYTES // nbytes_) + 1
        sets = [first] + [make() for _ in range(n - 1)]
        ms = device_ms(rotating(lambda i: kernel(*sets[i]), n), max(20, n))
        b_ms, b_by = bound(nbytes_, flops)
        out = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": err}
        extra = ""
        if t56:
            lsets = [(S_, *t56_layer(v_), m_) for S_, *v_, m_ in sets]
            out["layer_ms"] = device_ms(
                rotating(lambda i: kernel(*lsets[i]), n), max(20, n))
            extra = (f"; the whole call on the layer path's vectors "
                     f"{out['layer_ms']:.5f} ms")
        print(f"{what}: max_abs_err {err:.3e} (tolerance {KERNEL_TOL} x "
              f"max(1, |plain|)); {ms:.5f} ms on the device over {n} "
              f"rotating input sets, bound {b_ms:.5f} ms by {b_by}{extra}; "
              f"{card}", flush=True)
        return out

    def mask(B, T):
        lens = torch.full((B,), T, device=dev)
        lens[1] = T // 2  # a ragged row
        return torch.arange(T, device=dev)[None, :] < lens[:, None]

    tp = {"wkv56_t1": {}, "wkv56_chunk": {}, "wkv4_chunk": {}}
    for version, H, static in (("v6", C6 // HEAD // 2, False),
                               ("v5", C // HEAD // 2, True)):
        u = rnd(H, N, scale=0.5)
        w_static = torch.exp(-torch.exp(rnd(H, N, scale=0.5)))
        for B in TP_BS:
            elems = B * H * N * N
            ones = torch.ones(B, dtype=torch.bool, device=dev)

            def make_t1():
                w = w_static if static else torch.exp(
                    -torch.exp(rnd(B, H, N, scale=0.5)))
                return (rnd(B, H, N, N), *(rnd(B, H, N, scale=0.3)
                                           for _ in range(3)), w, u, ones)

            vec = B * H * N * 4
            tp["wkv56_t1"][f"{version} B={B} H={H}"] = case(
                wkv56_t1, wkv56_t1_plain, make_t1,
                2 * elems * 4 + (4 if static else 5) * vec
                + (2 if static else 1) * H * N * 4 + B, 7 * elems,
                f"wkv56_t1 at a tp place ({version}, B={B}, H={H}, "
                f"{'static' if static else 'dense'} decay)", t56=True)
            m, T = mask(B, CHUNK), CHUNK

            def make_chunk():
                w = w_static if static else torch.exp(
                    -torch.exp(rnd(B, T, H, N, scale=0.5)))
                return (rnd(B, H, N, N), *(rnd(B, T, H, N, scale=0.3)
                                           for _ in range(3)), w, u, m)

            n_valid = int(m.sum())
            tp["wkv56_chunk"][f"{version} B={B} H={H} T={T}"] = case(
                wkv56_chunk, wkv56_chunk_plain, make_chunk,
                2 * elems * 4 + (4 if static else 5) * vec * T
                + (2 if static else 1) * H * N * 4 + B * T,
                H * N * N * (7 * n_valid + 5 * (B * T - n_valid)),
                f"wkv56_chunk at a tp place ({version}, B={B}, H={H}, "
                f"T={T}, {'static' if static else 'dense'} decay)")
    C4 = C // 2
    w4 = -torch.exp(rnd(C4, scale=0.5))
    u4 = rnd(C4, scale=0.5)
    for B in TP_BS:
        for T in (CHUNK, 1):
            m = mask(B, T) if T > 1 else torch.ones(B, 1, dtype=torch.bool,
                                                    device=dev)

            def make4():
                bb = torch.rand(B, C4, generator=gen, device=dev) + 0.5
                return (rnd(B, C4), bb, rnd(B, C4),
                        rnd(B, T, C4).to(torch.bfloat16),
                        rnd(B, T, C4).to(torch.bfloat16), w4, u4, m)

            n_valid = int(m.sum())
            tp["wkv4_chunk"][f"v4 B={B} C={C4} T={T}"] = case(
                wkv4_chunk, wkv4_chunk_plain, make4,
                2 * 3 * B * C4 * 4 + 2 * B * T * C4 * 2 + B * T * C4 * 4
                + 2 * C4 * 4 + B * T,
                C4 * (25 * n_valid + 13 * (B * T - n_valid)),
                f"wkv4_chunk at a tp place (v4, B={B}, C={C4}, T={T}, bf16 "
                "k and v)")
    for name, shapes in tp.items():
        rows[name]["tp"] = shapes


def phase_phased_kernels(dev) -> dict:
    """``phased_matmul`` (``csrc/phased.cu``) against its plain version on
    the four big launches of a v7 layer (r/k/v, Wo, fkey, fval) at the 0.4B
    and the 2.9B widths, B = 16 and 64, on bf16 weights and on int8, int4,
    nf4 and sf4 codes, on a v5 0.4B layer's four in the same modes, and on
    all eight launches of a v6 1B6 layer (its four LoRA launches - the five
    strided token-shift offsets among them - on bf16 weights, the four big
    ones in every mode), each launch timed on weights that rotate through
    more than the L2 holds; beside it ``torch.matmul`` on the same bf16
    products, ``v7_skinny_matmul`` (8 rows a launch) on the same weights,
    and the x and weight bytes the kernel's TMA boxes stage.  Returns the
    kernels line's rows: the shapes the model paths launch (v7 0.4B per
    mode, v5 0.4B bf16 and sf4) at B = 64."""
    import torch

    from ai00_server_tpu_torch.ops import phased_matmul as pm
    from ai00_server_tpu_torch.ops import quant
    from ai00_server_tpu_torch.ops import v7_decode as fd

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    cd = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def close(got, want, rounded, what):
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if rounded else KERNEL_TOL
        check(err <= tol * max(1.0, float(want.float().abs().max())),
              f"{what} disagrees with its plain version: {err:.3e}")
        return err

    def v7_layer(Cw, Fw):
        return {"rkv": [(Cw, Cw, "f32")] * 3, "wo": [(Cw, Cw, "add")],
                "fkey": [(Cw, Fw, "relu2")], "fval": [(Fw, Cw, "add")]}

    def v56_layer(Cw, Fw, out_ffn):
        # r, k, v, g; Wo; the channel mix's key and receptance; its value.
        return {"rkvg": [(Cw, Cw, "f32")] * 4, "wo": [(Cw, Cw, "add")],
                "fkey_frec": [(Cw, Fw, "relu2"), (Cw, Cw, "f32")],
                "fval": [(Fw, Cw, out_ffn)]}

    # Epilogue of each kind: (act, out, round_cd), and its output bytes a
    # row and column (what it writes, and reads besides the sum).
    kinds = {"f32": ("none", "f32", True, 4), "add": ("none", "add", False, 8),
             "relu2": ("relu2", "cd", False, 2),
             "tanh": ("tanh", "cd", False, 2),
             "expexp": ("expexp", "f32", False, 4),
             "gadd": ("none", "gadd", False, 12),
             "mix": ("none", "mix", False, 6)}
    tm, td = LORA6["tm"], LORA6["td"]
    # (width, the launches of a layer, weight modes, the kernels line's
    # row per mode at B = WIDE_BATCH): the served shapes give the rows.
    # `lora` launches hold bf16 weights in every mode: timed in bf16 only.
    every = ("bf16", "int8", "int4", "nf4", "sf4")
    cases = [
        ("0.4B", v7_layer(C, FFN), every,
         {"bf16": "phased_matmul", "int8": "phased_matmul (int8)",
          "int4": "phased_matmul (int4)", "nf4": "phased_matmul (nf4)"}),
        ("2.9B", v7_layer(C29, F29), every, {}),
        ("v5 0.4B", v56_layer(C, F5, "add"), every,
         {"bf16": "phased_matmul (v5)", "sf4": "phased_matmul (v5, sf4)"}),
        ("v6 1B6", {"lora_mw1": [(C6, 5 * tm, "tanh")],
                    "lora_mw2": [(tm, C6, "mix")] * 5,
                    "lora_dw1": [(C6, td, "tanh")],
                    "lora_dw2": [(td, C6, "expexp")],
                    **v56_layer(C6, F6, "gadd")},
         every, {}),
    ]
    rows = {}
    for width, groups, modes, row_names in cases:
        for mode in modes:
            total = {B: dict.fromkeys(("ms", "plain_ms", "library_ms",
                                       "skinny_ms", "bytes", "flops",
                                       "x_staged", "w_staged"), 0.0)
                     for B in PHASED_BS}
            worst = 0.0
            timed = [g for g in groups
                     if mode == "bf16" or not g.startswith("lora")]
            for gname in timed:
                specs = groups[gname]
                lora = gname.startswith("lora")
                pmode = "none" if mode == "bf16" or lora else mode
                wbytes = sum(K * Nout * 2 for K, Nout, _ in specs)
                n_sets = int(2 * L2_BYTES // wbytes) + 1
                sets = []  # [(bf16 weights, codes or None)] per set
                for _ in range(n_sets):
                    ws_ = [(rnd(K, Nout) / K ** 0.5).to(cd)
                           for K, Nout, _ in specs]
                    codes = ([quant.QUANTIZERS[pmode](w) for w in ws_]
                             if pmode != "none" else None)
                    sets.append((ws_, codes))
                for B in PHASED_BS:
                    if gname == "lora_mw2":
                        # The five offsets read strided views of one
                        # (B, 5 tm) tensor, as the v6 stack gives them.
                        h = rnd(B, 5 * tm, scale=0.5).to(cd)
                        xs = [h[:, i * tm:(i + 1) * tm] for i in range(5)]
                    else:
                        xs = [rnd(B, K, scale=0.5).to(cd)
                              for K, _, _ in specs]
                    ys = [rnd(B, Nout) for _, Nout, _ in specs]
                    # gadd's gate, mix's xa, dx and mix.
                    ops = [(rnd(B, Nout), rnd(B, Nout).to(cd),
                            rnd(B, Nout).to(cd), rnd(Nout).to(cd))
                           for _, Nout, _ in specs]

                    def prods(i, y=None, _xs=xs, _ys=ys, _ops=ops):
                        ws_, codes = sets[i]
                        out = []
                        for j, (x, (_, Nout, kind)) in enumerate(zip(
                                _xs, specs)):
                            w = dict(W=ws_[j]) if codes is None else dict(
                                W=codes[j].q, scale=codes[j].scale,
                                mode=pmode)
                            act, to, round_cd, _ = kinds[kind]
                            gate, xa, dx, mix = _ops[j]
                            out.append(fd.Product(
                                x, act=act, round_cd=round_cd, out=to,
                                y=(_ys[j] if y is None else y[j])
                                if to in ("add", "gadd") else None,
                                gate=gate if to == "gadd" else None,
                                xa=xa if to == "mix" else None,
                                dx=dx if to == "mix" else None,
                                mix=mix if to == "mix" else None, **w))
                        return out

                    shapes = [(K, Nout) for K, Nout, _ in specs]
                    want = pm.phased_matmul_plain(prods(0))
                    got = pm.phased_matmul(
                        prods(0, [y.clone() for y in ys]))
                    torch.cuda.synchronize()
                    for g, w, (_, _, kind) in zip(got, want, specs):
                        _, to, round_cd, _ = kinds[kind]
                        worst = max(worst, close(
                            g, w, round_cd or to in ("cd", "mix"),
                            f"phased_matmul[{width} {mode} {gname} B={B}]"))
                    t = total[B]
                    ms = device_ms(rotating(
                        lambda i: pm.phased_matmul(prods(i)), n_sets), 20)
                    t["ms"] += ms
                    t.setdefault("per_launch", {})[gname] = ms
                    t["plain_ms"] += device_ms(rotating(
                        lambda i: pm.phased_matmul_plain(prods(i)), n_sets),
                        3)
                    t["library_ms"] += device_ms(rotating(
                        lambda i: [torch.matmul(x, w) for x, w in
                                   zip(xs, sets[i][0])], n_sets), 20)
                    t["skinny_ms"] += device_ms(rotating(
                        lambda i: fd.v7_skinny_matmul(prods(i)),
                        n_sets), 20)
                    code = sets[0][1]
                    t["bytes"] += sum(
                        nbytes(x) + (nbytes(c.q, c.scale) if code else
                                     nbytes(w)) + B * Nout * kinds[kind][3]
                        for x, w, c, (_, Nout, kind) in zip(
                            xs, sets[0][0], code or sets[0][0], specs))
                    t["flops"] += sum(2 * B * K * Nout
                                      for K, Nout, _ in specs)
                    for ln in pm.plan(shapes, B, pmode):
                        x_st, w_st = pm.staged_bytes(ln, shapes, pmode)
                        t["x_staged"] += x_st
                        t["w_staged"] += w_st
                del sets
            for B in PHASED_BS:
                t = total[B]
                b_ms, b_by = bound(t["bytes"], t["flops"], BF16_FLOPS)
                print(f"phased_matmul {width} {mode} B={B}, the "
                      f"{len(timed)} launches of a layer: {t['ms']:.5f} ms ("
                      + ", ".join(f"{g} {v:.5f}"
                                  for g, v in t["per_launch"].items())
                      + f"; {t['bytes'] / t['ms'] / 1e6:.0f} GB/s; plain "
                      f"{t['plain_ms']:.5f}, torch.matmul on the bf16 "
                      f"products {t['library_ms']:.5f}, v7_skinny_matmul "
                      f"(8 rows a launch) {t['skinny_ms']:.5f}; bound "
                      f"{b_ms:.5f} by {b_by}; TMA stages "
                      f"{t['x_staged'] / 1e6:.2f} MB of x beside "
                      f"{t['w_staged'] / 1e6:.2f} MB of weight boxes, "
                      f"{t['x_staged'] / t['w_staged']:.3f} of them)",
                      flush=True)
                if mode in row_names and B == WIDE_BATCH:
                    name = row_names[mode]
                    rows[name] = {
                        "name": name, "route": "cuda",
                        "source": "ai00_server_tpu_torch/csrc/phased.cu",
                        "replaces": (
                            "ai00_server_tpu/ops/v56_phased_pallas.py:439"
                            if width.startswith("v5") else
                            "ai00_server_tpu/ops/v7_phased_pallas.py:780"),
                        "max_abs_err": worst, "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "library_ms": t["library_ms"],
                        "bound_ms": b_ms,
                        "bound_by": b_by}
            print(f"phased_matmul {width} {mode}: max_abs_err {worst:.3e} "
                  f"(tolerance {BF16_TOL:.2e} x max(1, |plain|) on "
                  f"bf16-rounded results, {KERNEL_TOL} on f32 ones)",
                  flush=True)
    return rows


def ivf_bound(ivf, probe, elem: int, D: int) -> dict:
    """The least time of one ``ivf_score`` call: the filled rows of each
    DISTINCT probed cluster read once (ids and scales of all its slots),
    the queries, the probe table and the (Q, nprobe, cap) outputs, over
    3.35 TB/s; or its multiply-adds over the peak of their type (int8
    codes: bf16 products on the tensor cores; floats: f32).  Beside it the
    DRAM bytes the kernel reads (``read_bytes``: the filled rows, scales
    and ids of the distinct clusters of each group of ``IVF_GROUP`` pairs,
    the queries and the probe table; it writes the outputs) and those of a
    design that reads one (query, probe) block at a time (``pair_bytes``,
    the first kernel of ``csrc/ivf.cu``: the same for every pair)."""
    import torch

    from ai00_server_tpu_torch.ops.retrieval import IVF_GROUP

    Q, nprobe = probe.shape
    cap = ivf.cap
    fill = (ivf.packed_ids >= 0).sum(-1)
    flat = probe.reshape(-1).long()
    distinct = torch.unique(flat)
    filled = int(fill[distinct].sum())
    out_bytes = Q * nprobe * cap * 8
    common = Q * D * 4 + Q * nprobe * 4 + out_bytes
    n_bytes = filled * D * elem + len(distinct) * cap * 8 + common
    flops = 2 * D * int(fill[flat].sum())
    b_ms, b_by = bound(n_bytes, flops, BF16_FLOPS if elem == 1
                       else F32_FLOPS)
    # A cluster's reads: every slot's id and scale, then the filled rows;
    # the one-block-a-pair design read the scales of filled rows only.
    per = fill.double() * D * elem + cap * 8
    per7 = fill.double() * (D * elem + 4) + cap * 4
    read = sum(float(per[flat[i:i + IVF_GROUP].unique()].sum())
               for i in range(0, flat.numel(), IVF_GROUP)) + common
    return {"bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "distinct": len(distinct), "read_bytes": read,
            "pair_bytes": float(per7[flat].sum()) + common}


def ivf_data(dev):
    """The bf16 corpus (IVF_N, IVF_D) made on the card from SEED, one
    IVF_CHUNK-row chunk at a time (as bench_ivf makes it), and queries:
    perturbed copies of its first IVF_RECALL_Q rows (noise norm 0.1)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    modes = torch.randn(IVF_MODES, IVF_D, generator=gen, device=dev)
    modes /= modes.norm(dim=-1, keepdim=True)
    data = torch.empty((IVF_N, IVF_D), dtype=torch.bfloat16, device=dev)
    for i in range(0, IVF_N, IVF_CHUNK):
        cid = torch.randint(0, IVF_MODES, (IVF_CHUNK,), generator=gen,
                            device=dev)
        x = modes[cid] + (IVF_SIGMA / IVF_D ** 0.5) * torch.randn(
            IVF_CHUNK, IVF_D, generator=gen, device=dev)
        data[i:i + IVF_CHUNK] = (x / x.norm(dim=-1, keepdim=True)).bfloat16()
    q = data[:IVF_RECALL_Q].float() + (0.1 / IVF_D ** 0.5) * torch.randn(
        IVF_RECALL_Q, IVF_D, generator=gen, device=dev)
    return data, q, gen


def phase_ivf_kernels(dev) -> dict:
    """Row 16, ``ivf_score`` (``csrc/ivf.cu``): an int8 IVF of IVF_N
    vectors built on the card (``kmeans_blocked(balance=True)`` on an
    IVF_TRAIN-chunk sample, then ``StreamedIVFBuilder`` chunk by chunk,
    spill 8, the placement bias kept), the kernel against
    ``ivf_score_plain`` on IVF_CHECK_Q queries at full index size, then on
    bf16 and f32 indexes of IVF_SMALL_N vectors (``build_ivf``); timed at
    IVF_Q queries with nprobe 8 (the row) and 16, and held and timed at two
    skews of nprobe 8 (every query on query 0's clusters; every pair on a
    cluster of its own), each beside its bound and the bytes the kernel
    reads (``ivf_bound``); recall@10 of ``ivf_search`` against
    ``exact_search`` on the bf16 corpus, printed as a reading."""
    import torch

    from ai00_server_tpu_torch.ops import retrieval as R

    t0 = time.monotonic()
    data, q, gen = ivf_data(dev)
    cent, cbias = R.kmeans_blocked(data[:IVF_TRAIN * IVF_CHUNK], IVF_NLIST,
                                   iters=8, blk=IVF_CHUNK, balance=True,
                                   generator=gen)
    mean = IVF_N / IVF_NLIST
    cap = int(mean + 8.0 * mean ** 0.5 + 16)
    builder = R.StreamedIVFBuilder(cent, cap=cap, dim=IVF_D, spill=8,
                                   cbias=cbias)
    for i in range(0, IVF_N, IVF_CHUNK):
        builder.add(data[i:i + IVF_CHUNK], i)
    ivf = builder.finish()
    torch.cuda.synchronize()
    dropped = int(builder.dropped)
    print(f"IVF: {IVF_N} x {IVF_D} bf16 corpus ({IVF_MODES} modes, sigma "
          f"{IVF_SIGMA}) made, balanced k-means (nlist {IVF_NLIST}) and the "
          f"streamed int8 build (cap {cap}, {ivf.packed.numel() / 1e9:.2f} "
          f"GB of codes, {dropped} dropped) in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    check(dropped < IVF_N // 100, f"the IVF build dropped {dropped} rows")

    worst = 0.0

    def held(index, qs, nprobe, what):
        nonlocal worst
        qf, probe = R._ivf_probe(index.centroids, qs, nprobe, index.cbias)
        s_k, i_k = R.ivf_score(index.packed, index.packed_ids, index.pscale,
                               qf, probe)
        s_p, i_p = R.ivf_score_plain(index.packed, index.packed_ids,
                                     index.pscale, qf, probe)
        torch.cuda.synchronize()
        check(torch.equal(i_k, i_p), f"ivf_score {what}: ids differ")
        fin = torch.isfinite(s_p)
        check(torch.equal(torch.isfinite(s_k), fin),
              f"ivf_score {what}: empty slots differ")
        err, rel = rel_err(s_k[fin], s_p[fin])
        check(rel <= KERNEL_TOL, f"ivf_score {what} disagrees with its "
              f"plain version: {rel}")
        worst = max(worst, err)
        print(f"ivf_score {what} Q={qs.shape[0]} nprobe={nprobe} "
              f"cap={index.cap} D={qs.shape[1]}: max_abs_err {err:.3e} "
              f"(tolerance {KERNEL_TOL} x max(1, |plain|)); ids and empty "
              "slots equal", flush=True)

    held(ivf, q[:IVF_CHECK_Q], 16, "int8")
    small = data[:IVF_SMALL_N].float().cpu().numpy()
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        index = R.build_ivf(small, nlist=IVF_SMALL_NLIST, iters=4,
                            seed=SEED, dtype=dtype, device=dev)
        held(index, q[:IVF_CHECK_Q], 8, name)
        del index
    del small

    # Times at IVF_Q queries: nprobe 8 (the row) and 16 on the queries' own
    # probes, and two skews of nprobe 8 held first: every query on query
    # 0's clusters (runs of IVF_Q), every pair on a cluster of its own.
    qf, probe8 = R._ivf_probe(ivf.centroids, q[:IVF_Q], 8, ivf.cbias)
    probes = {
        "nprobe 8": probe8,
        "nprobe 16": R._ivf_probe(ivf.centroids, q[:IVF_Q], 16,
                                  ivf.cbias)[1],
        "shared": probe8[:1].expand(IVF_Q, 8).contiguous(),
        "distinct": torch.arange(IVF_Q * 8, device=dev,
                                 dtype=torch.int32).reshape(IVF_Q, 8)
        % IVF_NLIST,
    }
    row, skews = None, {}
    for name, probe in probes.items():
        args = (ivf.packed, ivf.packed_ids, ivf.pscale, qf, probe)
        if name in ("shared", "distinct"):
            s_k, i_k = R.ivf_score(*args)
            s_p, i_p = R.ivf_score_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(i_k, i_p), f"ivf_score {name}: ids differ")
            fin = torch.isfinite(s_p)
            check(torch.equal(torch.isfinite(s_k), fin),
                  f"ivf_score {name}: empty slots differ")
            err, rel = rel_err(s_k[fin], s_p[fin])
            check(rel <= KERNEL_TOL, f"ivf_score {name} disagrees with its "
                  f"plain version: {rel}")
            worst = max(worst, err)
        ms = device_ms(lambda: R.ivf_score(*args), 10)
        b = ivf_bound(ivf, probe, 1, IVF_D)
        held_txt = (f" held (max_abs_err {err:.3e}, ids and empty slots "
                    "equal);" if name in ("shared", "distinct") else "")
        print(f"ivf_score int8 Q={IVF_Q} {name}:{held_txt} {ms:.5f} ms; "
              f"bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
              f"({b['distinct']} distinct clusters, {b['bytes'] / 1e6:.1f} "
              f"MB); the kernel reads {b['read_bytes'] / 1e6:.1f} MB "
              f"({b['read_bytes'] / (ms * 1e9):.3f} TB/s), a (query, probe) "
              f"block at a time would read {b['pair_bytes'] / 1e6:.1f} MB",
              flush=True)
        if name == "nprobe 8":
            row = {
                "name": "ivf_score", "route": "cuda",
                "source": "ai00_server_tpu_torch/csrc/ivf.cu",
                "replaces": "ai00_server_tpu/ops/retrieval.py:289",
                "ms": ms,
                "plain_ms": device_ms(lambda: R.ivf_score_plain(*args), 1,
                                      replays=3),
                "call_ms": call_ms(lambda: R.ivf_score(*args), 20),
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": None,
            }
        else:
            skews[name] = {"ms": ms, "bound_ms": b["bound_ms"],
                           "read_bytes": b["read_bytes"]}
    row["shapes_ms"] = skews

    # recall@10 against exact search on the bf16 corpus (a reading).
    _, gt = R.exact_search(data, q.bfloat16(), k=10)
    gt = gt.cpu().numpy()
    for nprobe in sorted({min(n, IVF_NLIST) for n in (8, 16, 32)}):
        ids = torch.cat([R.ivf_search(
            ivf.centroids, ivf.packed, ivf.packed_ids, q[j:j + IVF_Q], k=10,
            nprobe=nprobe, pscale=ivf.pscale, cbias=ivf.cbias)[1]
            for j in range(0, IVF_RECALL_Q, IVF_Q)]).cpu().numpy()
        recall = sum(len(set(ids[r]) & set(gt[r]))
                     for r in range(IVF_RECALL_Q)) / (10 * IVF_RECALL_Q)
        print(f"IVF recall@10 against exact search, nprobe={nprobe}: "
              f"{recall:.4f} ({IVF_RECALL_Q} queries)", flush=True)
    row["max_abs_err"] = worst
    del data, ivf, builder
    gc.collect()
    torch.cuda.empty_cache()
    rows = {"ivf_score": row}
    print_rows(rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: model parity, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------


def model_info(num_layer: int, version: str = "v7"):
    from ai00_server_tpu_torch.models.info import ModelInfo, ModelVersion

    width, ffn = {"v7": (C, FFN), "v6": (C6, F6), "v5": (C, F5),
                  "v4": (C, F4)}[version]
    head = 1 if version == "v4" else HEAD
    return ModelInfo(version=ModelVersion(version.upper()),
                     num_layer=num_layer, num_emb=width, num_hidden=ffn,
                     num_vocab=VOCAB, num_head=width // head, head_size=head)


def lora_dims(version: str) -> dict:
    return LORA if version == "v7" else LORA6


@functools.lru_cache(maxsize=None)
def parity_math(version: str) -> dict:
    """The 2-layer parity model of ``version`` (math layout, f32; v6 / v5 /
    v4 scaled by their fan-in), drawn once for the parity phase and the
    mesh phase, which hold the same model (the draw is seconds of host
    time a version).  Callers read it and never write to it."""
    import numpy as np

    from ai00_server_tpu_torch.testing import make_raw_weights

    math = make_raw_weights(model_info(2, version), seed=SEED,
                            dtype=np.float32, lora_dims=lora_dims(version))
    return math if version == "v7" else fan_in_scaled(math)


def fan_in_scaled(raw: dict) -> dict:
    """RWKV-6 / -5 / -4 weights with every matrix but the embedding (and
    the per-head bonus ``time_first`` and v5's per-head ``time_decay``)
    divided IN PLACE by the square root of its fan-in, the second-last axis
    in the math layout.  Drawn at std 0.4 and left so, a product at C = 2048
    spreads ~0.4 sqrt(C) = 18 wide: the decay exp(-exp(.)) and the sigmoids
    saturate, single bf16 ulps move the decay far, and no bf16 stack can be
    held to its plain version."""
    import numpy as np

    for k, v in raw.items():
        if v.ndim >= 2 and k != "emb.weight" \
                and not k.endswith(("time_first", "time_decay")):
            v /= np.sqrt(v.shape[-2]).astype(v.dtype)
    return raw


def wrong_v6_stacks() -> dict:
    """Known-wrong plain v6 decode stacks, each one slip a kernel could
    make, as ``ops`` for ``v6_decode._forward``: the bf16 checks must tell
    them from the plain stack."""
    import dataclasses

    import torch

    from ai00_server_tpu_torch.ops import v6_decode as fd6

    ln_mix, matmul, wkv_gn = fd6._PLAIN_OPS

    def g_rounded_first(products):
        silu = [p.act == "silu" for p in products]
        outs = matmul([dataclasses.replace(p, act="none", round_cd=True)
                       if g else p for p, g in zip(products, silu)])
        return [torch.nn.functional.silu(o) if g else o
                for o, g in zip(outs, silu)]

    def r_k_swapped(products):
        outs = matmul(products)
        if products[-1].act == "silu":  # the r, k, v, g launch
            outs[0], outs[1] = outs[1], outs[0]
        return outs

    return {"g rounded before its SiLU": (ln_mix, g_rounded_first, wkv_gn),
            "r and k swapped": (ln_mix, r_k_swapped, wkv_gn)}


def off_pp_init(got, want, what: str):
    """``(got, want)`` without the entries where ``want`` holds v4's
    ``PP_INIT`` (-1e30: a row that has not yet taken a token), which must
    be equal in ``got``: a relative error scaled by them would say
    nothing."""
    init = want.abs() >= 1e29
    check(bool((got[init] == want[init]).all()),
          f"{what}: PP_INIT entries changed")
    return got[~init], want[~init]


def lockstep(kernels, plains, worst: dict,
             state_tol: dict | None = None) -> tuple:
    """The ops (ln_mix, matmul, wkv_gn) of a fused stack that run the plain
    versions and, on copies of the same inputs, ``kernels``: every launch's
    results against the plain ones, as phase 2 holds them (``BF16_TOL`` on a
    value rounded to bf16, ``KERNEL_TOL`` on f32, both x max(1, |plain|);
    ``state_tol[op]`` in place of ``KERNEL_TOL`` on the f32 operands an op
    updates in place), the worst error / tolerance per op kept in ``worst``
    (above 1: out of tolerance).  The plain results drive the stack, so the
    two never drift apart and one slip in one launch shows at its own
    size."""
    import dataclasses

    import torch

    def ratio(got, want, rounded, f32_tol=KERNEL_TOL):
        tol = BF16_TOL if rounded else f32_tol
        got, want = off_pp_init(got, want, "lockstep")
        err = float((got.float() - want.float()).abs().max())
        return err / (tol * max(1.0, float(want.float().abs().max())))

    def wrap(name, kernel, plain):
        def op(*args, **kw):
            if name == "matmul":
                prods = args[0]
                k_args = ([dataclasses.replace(
                    p, y=None if p.y is None else p.y.clone())
                    for p in prods], *args[1:])
            else:
                k_args = [a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args]
            # The plain version first: its launches come between the
            # copies and the kernel, which reads its state before it waits.
            want = plain(*args, **kw)
            got = kernel(*k_args, **kw)
            if name == "matmul":
                pairs = [(g, w, p.out in ("cd", "mix") or p.round_cd)
                         for g, w, p in zip(got, want, prods)]
            else:  # the output, then every f32 operand (the state in place)
                pairs = [(got, want, want.dtype != torch.float32)] + [
                    (a, b, False, (state_tol or {}).get(name, KERNEL_TOL))
                    for a, b in zip(k_args, args)
                    if isinstance(b, torch.Tensor)
                    and b.dtype == torch.float32]
            worst[name] = max([worst.get(name, 0.0)]
                              + [ratio(*pair) for pair in pairs])
            return want
        return op

    return tuple(wrap(name, k, p) for name, k, p in
                 zip(("ln_mix", "matmul", "wkv_gn"), kernels, plains))


PARITY_CASES = {
    # weights: (quant map, the paths driven)
    "plain": (None, ("layer", "fused", "graph")),
    "int8": ({0: "int8", 1: "int8"}, ("fused", "graph")),
    "mixed": ({0: "int8"}, ("layer",)),
    "nf4": ({0: "nf4", 1: "nf4"}, ("fused", "graph")),
    "mixed nf4": ({0: "nf4"}, ("layer",)),
    # The same with per-layer QuantizedLinear nodes in place of the views
    # into stacked codes: linear() reaches matmul_4bit.
    "unstacked nf4": ({0: "nf4"}, ("layer",)),
    "int4": ({0: "int4", 1: "int4"}, ("fused",)),
    "sf4": ({0: "sf4", 1: "sf4"}, ("fused",)),
}
# The RWKV-6 cases: the 1B6 width; the mixed one runs wkv56_t1 on its layer
# path.  RWKV-5 and RWKV-4 (the 0.4B width) take the same cases: v5's mixed
# model runs wkv56_t1, v4's wkv4_chunk at T=1.
PARITY_CASES_V6 = {
    "plain": (None, ("layer", "fused", "graph")),
    "int8": ({0: "int8", 1: "int8"}, ("fused", "graph")),
    "nf4": ({0: "nf4", 1: "nf4"}, ("fused", "graph")),
    "mixed": ({0: "int8"}, ("layer",)),
}


def unstack_codes(node):
    """A copy of the params tree with every view into stacked codes
    replaced by an unstacked QuantizedLinear of that layer's codes."""
    from ai00_server_tpu_torch.ops import quant

    if isinstance(node, dict):
        return {k: unstack_codes(v) for k, v in node.items()}
    if isinstance(node, list):
        return [unstack_codes(v) for v in node]
    if isinstance(node, quant.QuantizedLayerView):
        return quant.QuantizedLinear(node.mode, node.q, node.scale,
                                     node.shape)
    return node


def params_to(node, dev, moved=None):
    """A copy of a params tree on ``dev``; the views into one stacked
    group's codes stay views into one copy of them."""
    from ai00_server_tpu_torch.ops import quant

    moved = {} if moved is None else moved
    if isinstance(node, dict):
        return {k: params_to(v, dev, moved) for k, v in node.items()}
    if isinstance(node, list):
        return [params_to(v, dev, moved) for v in node]
    if isinstance(node, quant.QuantizedLayerView):
        return quant.QuantizedLayerView(params_to(node.qlin, dev, moved),
                                        node.idx)
    if isinstance(node, quant.QuantizedLinear):
        if id(node) not in moved:
            moved[id(node)] = quant.QuantizedLinear(
                node.mode, node.q.to(dev), node.scale.to(dev), node.shape)
        return moved[id(node)]
    return node.to(dev) if hasattr(node, "to") else node


def phase_parity(dev, version: str = "v7") -> dict:
    """Returns the fused path's worst absolute bf16 error on the hidden per
    kind of weights, and the launches of ``matmul_4bit`` (v7: the unstacked
    nf4 case) or of ``wkv56_t1`` (v6 and v5: the mixed case) on their model
    path."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.engine import head_logits
    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import get_version_module
    from ai00_server_tpu_torch.models.common import take_last_valid
    from ai00_server_tpu_torch.ops import fused_decode, quant
    from ai00_server_tpu_torch.ops import v4_decode as fd4
    from ai00_server_tpu_torch.ops import v6_decode as fd6
    from ai00_server_tpu_torch.ops import v7_decode as fd7
    from ai00_server_tpu_torch.ops.ffn import ffn7_t1_l
    from ai00_server_tpu_torch.ops.quant_matmul import (matmul_4bit,
                                                        matmul_4bit_l,
                                                        matmul_int8,
                                                        matmul_int8_l)
    from ai00_server_tpu_torch.ops.wkv4 import wkv4_chunk
    from ai00_server_tpu_torch.ops.wkv_chunk import wkv56_chunk_plain
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1, wkv56_t1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = model_info(2, version)
    module = get_version_module(info.version)
    fd = fused_decode.module_for(info.version.value)
    # The WKV kernel of the layer path at T=1: v4's serves every T.
    C_, t1 = info.num_emb, {"v7": wkv7_t1, "v4": wkv4_chunk}.get(version,
                                                                 wkv56_t1)
    math = parity_math(version)
    rng = np.random.default_rng(SEED)
    B, T = 4, 40
    lengths = np.array([40, 33, 1, 0], np.int32)
    steps = [(rng.integers(1, VOCAB, (B, T)), lengths)] + [
        (rng.integers(1, VOCAB, (B, 1)), np.array([1, 1, 0, 1], np.int32))
        for _ in range(3)]
    counted = {"wkv7_t1": wkv7_t1, "wkv56_t1": wkv56_t1,
               "wkv4_chunk": wkv4_chunk, "matmul_int8": matmul_int8,
               "matmul_int8_l": matmul_int8_l, "ffn7_t1_l": ffn7_t1_l,
               "matmul_4bit": matmul_4bit, "matmul_4bit_l": matmul_4bit_l,
               **{k.__name__: k for k in fd7.KERNELS + fd6.KERNELS
                  + fd4.KERNELS}}
    # (v4's prefill chunk launches wkv4_chunk on every path)
    fused_names = {k.__name__ for k in fd.KERNELS} | (
        {"wkv4_chunk"} if version == "v4" else set())

    def expect(label, quant_map, path) -> set:
        """Which kernels a (weights, path) must launch; the others must
        not.  Any quantized model has the int8 LM head (matmul_int8)."""
        if not quant_map:
            return {t1.__name__} if path == "layer" else fused_names
        by_layer = ("matmul_int8_l" if quant_map[0] == "int8"
                    else "matmul_4bit_l")
        if path == "fused":
            # (its prefill chunk goes layer by layer: B * T = 160 rows, more
            # than quant.KERNEL_ROWS, each weight dequantized for one
            # torch.matmul; by_layer runs only under the threshold)
            return {"matmul_int8"} | fused_names | (
                {by_layer} if B * T <= quant.KERNEL_ROWS else set())
        if label.startswith("unstacked"):
            return {"wkv7_t1", "matmul_int8", "matmul_4bit"}
        # v7's quantized channel mix at T=1 is ffn7_t1_l; v6's goes through
        # linear (matmul_*_l).
        return {t1.__name__, "matmul_int8", by_layer} | (
            {"ffn7_t1_l"} if version == "v7" else set())

    def run(p, how, d):
        """The steps on device d: 'layer' (no layout), 'fused' (eager
        forward_t1 at T=1) or 'graph' (T=1 replayed from a DecodeGraph)."""
        state = module.init_state(info, B, device=d)
        graph = fd.DecodeGraph(p, state, B) if how == "graph" else None
        outs = []
        for toks, lens in steps:
            lt = torch.as_tensor(lens, device=d)
            tt = torch.as_tensor(toks, device=d)
            if graph is not None and toks.shape[1] == 1:
                h = graph.replay(tt[:, 0], lt)[:, None]
            else:
                h, new = module.forward(p, state, tt, lt)
                if new is not state:
                    for k, t in state.items():
                        t.copy_(new[k])
            logits = head_logits(p, take_last_valid(h, lt))
            outs.append((h.cpu(), logits.cpu(),
                         {k: t.cpu().clone() for k, t in state.items()}))
        return outs

    def errors(got, ref) -> dict:
        """Per tensor, max |got - ref| / max |ref| over the steps."""
        per = {}
        for (toks, lens), (h, lg, st), (h_r, lg_r, st_r) in zip(steps, got,
                                                                 ref):
            m = torch.arange(toks.shape[1])[None, :] < torch.as_tensor(
                lens)[:, None]
            pairs = [("hidden", h[m], h_r[m]),
                     ("logits", lg[lens > 0], lg_r[lens > 0])]
            pairs += [(k, st[k], st_r[k]) for k in st_r]
            for name, a, b in pairs:
                check(bool(torch.isfinite(a).all()), "non-finite output")
                a, b = off_pp_init(a, b, name)
                err = float((a.double() - b.double()).abs().max())
                per[name] = max(per.get(name, 0.0),
                                err / max(float(b.abs().max()), 1e-6))
        return per

    def fmt(per) -> str:
        return str({k: f"{v:.2e}" for k, v in per.items()})

    result = {}
    cases = PARITY_CASES if version == "v7" else PARITY_CASES_V6
    shape = {"v7": "0.4B", "v6": "v6 1B6", "v5": "v5 0.4B",
             "v4": "v4 0.4B"}[version]
    for label, (quant_map, hows) in cases.items():
        t_case = time.monotonic()
        # Built once on the host and copied to the card: the same values
        # stack_params builds there (it works on the host either way).
        cpu = stack_params(info, math, dtype=torch.float32, device="cpu",
                           quant=quant_map)
        params = {dev: params_to(cpu, dev), "cpu": cpu}
        if label.startswith("unstacked"):
            params = {d: unstack_codes(p) for d, p in params.items()}
        if quant_map:
            # The int8 LM head, quantized where the params lie, as the
            # engine does: the card gives the CPU's codes.
            for p in params.values():
                p["_head_q"] = quant.quantize_int8(p.pop("head"))
            hq = {d: p["_head_q"] for d, p in params.items()}
            check(torch.equal(hq[dev].q.cpu(), hq["cpu"].q)
                  and torch.equal(hq[dev].scale.cpu(), hq["cpu"].scale),
                  "the int8 head quantized on the card differs from the "
                  "CPU's")
        check(fd.can_fuse(params["cpu"]) == ("fused" in hows),
              f"can_fuse is wrong for the {label} {shape}-shape model")
        fused = {d: {**p, fd.FUSED_KEY: fd.make_fused_layout(p)}
                 for d, p in params.items()} if "fused" in hows else None
        ref = {how: run(params["cpu"] if how == "layer" else fused["cpu"],
                        how, "cpu") for how in hows if how != "graph"}
        for how in hows:
            for k in counted.values():
                k.launches = 0
            got = run(params[dev] if how == "layer" else fused[dev], how, dev)
            torch.cuda.synchronize()
            delta = {name: k.launches for name, k in counted.items()}
            want = expect(label, quant_map,
                          "fused" if how == "graph" else how)
            check(all((delta[name] > 0) == (name in want) for name in delta),
                  f"the {label} {how} path launched {delta}")
            if label.startswith("unstacked"):
                result["matmul_4bit_launches"] = delta["matmul_4bit"]
            if version in ("v6", "v5") and label == "mixed":
                result["wkv56_t1_launches"] = delta["wkv56_t1"]
            ref_how = ref["layer" if how == "layer" else "fused"]
            per = errors(got, ref_how)
            worst = max(per.values())
            check(worst <= MODEL_TOL,
                  f"card and CPU disagree on the {label} {how} path: "
                  f"{worst:.3e} > {MODEL_TOL} ({fmt(per)})")
            if version == "v6" and label == "plain" and how == "layer":
                # A second witness: the same run with the prefill's WKV
                # through wkv56_chunk_plain on the card.  What stays is the
                # products' (torch.matmul on both sides), not the kernel's.
                chunk, module.wkv56_chunk = (module.wkv56_chunk,
                                             wkv56_chunk_plain)
                try:
                    per_w = errors(run(params[dev], how, dev), ref_how)
                finally:
                    module.wkv56_chunk = chunk
                print(f"model parity, {shape} {label} weights, layer path "
                      "with the prefill's WKV through wkv56_chunk_plain on "
                      f"the card: max |card - cpu| / max |cpu| = "
                      f"{max(per_w.values()):.3e} (per tensor {fmt(per_w)}; "
                      f"through the kernel {fmt(per)})", flush=True)
            # Row 2 sits out the three decode steps: its state keeps the
            # bits the prefill left.
            for k, t in got[0][2].items():
                check(torch.equal(got[-1][2][k][:, 2], t[:, 2]),
                      f"the {label} {how} path changed an inactive row's {k}")
            print(f"model parity, {shape} {label} weights, {how} path "
                  f"(C={C_}, 2 "
                  f"layers, f32, ragged prefill T={T} + 3 decode steps; "
                  f"launches {delta}): max |card - cpu| / max |cpu| = "
                  f"{worst:.3e} (tolerance {MODEL_TOL}; per tensor "
                  f"{fmt(per)}); inactive row bit-identical", flush=True)

        if "fused" not in hows:
            print(f"model parity, {shape} {label} weights: "
                  f"{time.monotonic() - t_case:.1f} s", flush=True)
            continue
        # bf16 on the card: the fused kernels against forward_t1_plain.
        p16 = stack_params(info, math, dtype=torch.bfloat16, device=dev,
                           quant=quant_map)
        p16[fd.FUSED_KEY] = fd.make_fused_layout(p16)
        toks, lens = steps[0]
        _, s0 = module.forward(p16, module.init_state(info, B, device=dev),
                               torch.as_tensor(toks, device=dev),
                               torch.as_tensor(lens, device=dev))

        def decode(fwd) -> list:
            """The three decode steps through ``fwd`` from the prefill's
            state: per step the active rows' hidden (f32), then the state."""
            state = {k: t.clone() for k, t in s0.items()}
            outs = []
            for toks, lens in steps[1:]:
                h = fwd(p16, state, torch.as_tensor(toks, device=dev),
                        torch.as_tensor(lens, device=dev))[0]
                outs.append([h[lens > 0].float()]
                            + [state[k].clone() for k in s0])
            return outs

        def rel_steps(outs, ref) -> list:
            """Per step, max over hidden and state of max |out - ref| /
            max |ref|."""
            return [max(float((a.double() - b.double()).abs().max())
                        / max(float(b.abs().max()), 1e-6)
                        for a, b in (off_pp_init(*ab, "bf16 decode")
                                     for ab in zip(o, r)))
                    for o, r in zip(outs, ref)]

        got, plain = decode(fd.forward_t1), decode(fd.forward_t1_plain)
        for o in got:
            check(all(bool(torch.isfinite(a).all()) for a in o),
                  "non-finite bf16 output")
        for i, k in enumerate(s0):
            check(torch.equal(got[-1][1 + i][:, 2], s0[k][:, 2]),
                  "the fused path changed an inactive row's state")
        per_step = rel_steps(got, plain)
        worst = max(per_step)
        worst_abs = max(float((o[0].double() - r[0].double()).abs().max())
                        for o, r in zip(got, plain))
        check(worst <= BF16_MODEL_TOL,
              f"fused kernels and forward_t1_plain disagree in bf16 "
              f"({shape} {label}): {worst:.3e} > {BF16_MODEL_TOL}")
        # Every launch of the stack on the stack's own inputs, in lockstep.
        lock = {}
        decode(functools.partial(fd._forward,
                                 lockstep(fd.KERNELS, fd._PLAIN_OPS, lock)))
        check(max(lock.values()) <= 1.0,
              f"a launch of the bf16 {shape} {label} stack disagrees with "
              f"its plain version on the stack's inputs: error / tolerance "
              f"{lock}")
        wrong = ""
        if version == "v6" and label == "plain":
            # The checks' bite: known-wrong stacks against the same plain.
            # End to end a rounding slip sits in the noise of the summation
            # order; in lockstep it shows at once.
            for name, ops in wrong_v6_stacks().items():
                e = rel_steps(decode(functools.partial(fd6._forward, ops)),
                              plain)
                lock_w = {}
                decode(functools.partial(fd6._forward, lockstep(
                    ops, fd6._PLAIN_OPS, lock_w)))
                check(lock_w["matmul"] > 1.0,
                      f"the lockstep check cannot tell a known-wrong stack "
                      f"({name}: {lock_w}) from the plain one")
                if name.startswith("r and k"):
                    check(max(e) > BF16_MODEL_TOL,
                          f"the bf16 check cannot tell a known-wrong stack "
                          f"({name}: {max(e):.3e}) from the plain one")
                wrong += (f"; known-wrong '{name}': end to end "
                          + " / ".join(f"{x:.3e}" for x in e)
                          + f", in lockstep {lock_w['matmul']:.3g} x its "
                          "tolerance")
        print(f"fused decode in bf16 on the card, {shape} {label} weights "
              f"(C={C_}, 2 layers, 3 steps): max |kernels - plain| / max "
              f"|plain| over hidden and state = {worst:.3e} (per step "
              + " / ".join(f"{x:.3e}" for x in per_step)
              + f"; tolerance {BF16_MODEL_TOL}: the two sum in different "
              "orders, which flips single bf16 roundings that later layers "
              f"carry on), {worst_abs:.3e} absolute on the hidden; in "
              "lockstep every launch within its tolerance of its plain "
              "version (worst error / tolerance "
              + ", ".join(f"{k} {v:.3g}" for k, v in lock.items())
              + f"){wrong}; inactive row bit-identical", flush=True)
        result[f"fused_{label}_bf16_max_abs_err"] = worst_abs
        print(f"model parity, {shape} {label} weights: "
              f"{time.monotonic() - t_case:.1f} s", flush=True)
    return result


# The phased stacks' parity cases: (version, width, weight mode).
PHASED_CASES = [("v7", "2.9B", None), ("v7", "2.9B", "int8"),
                ("v7", "2.9B", "int4"), ("v7", "2.9B", "nf4"),
                ("v6", "1B6", None), ("v6", "1B6", "int8"),
                ("v6", "1B6", "nf4"), ("v5", "0.4B", None),
                ("v5", "0.4B", "sf4")]


def phased_info(version: str, width: str, num_layer: int,
                vocab: int = PHASED_VOCAB):
    from ai00_server_tpu_torch.models.info import ModelInfo, ModelVersion

    Cw, Fw = {"2.9B": (C29, F29), "1B6": (C6, F6), "0.4B": (C, F5)}[width]
    return ModelInfo(version=ModelVersion(version.upper()),
                     num_layer=num_layer, num_emb=Cw, num_hidden=Fw,
                     num_vocab=vocab, num_head=Cw // HEAD, head_size=HEAD)


def phased_engine_run(info, params, mode: str, dev) -> dict:
    """An ``Engine`` over a 2-layer nf4 / sf4 parity model at ``max_batch =
    WIDE_BATCH``, as a server's reload builds one: its decode stack must be
    the phased one under its graph (``stack_for`` at WIDE_BATCH rows).
    Then ``Engine.prewarm(PREWARM_K)`` (the serving buckets), a ragged
    greedy prefill of every row and a PREWARM_K-step decode chunk, with
    the launch counts zeroed before the prewarm and read after the chunk:
    ``phased_matmul`` must launch on the model's codes, ``v7_skinny_matmul``
    never.  Returns the counts and the graph replays."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.engine import Engine
    from ai00_server_tpu_torch.loader import LoadedModel
    from ai00_server_tpu_torch.ops import fused_decode, sampling
    from ai00_server_tpu_torch.ops import phased_matmul as pm
    from ai00_server_tpu_torch.ops import v7_decode as fd7

    B, T = WIDE_BATCH, 16
    tag = f"the {info.version.value} {mode}"
    eng = Engine(LoadedModel(info=info, params=params), max_batch=B,
                 token_chunk_size=T, device=dev)
    pd = fused_decode.stack_for(info.version.value, params, B)
    check(eng.stack is pd and isinstance(eng._graph, pd.DecodeGraph)
          and pd is not fused_decode.module_for(info.version.value),
          f"{tag} engine at max_batch {B} did not take the phased stack")
    for k in (pm.phased_matmul, fd7.v7_skinny_matmul):
        k.launches = 0
    pm.phased_matmul.lut4_launches = 0
    replays0 = fused_decode.DecodeGraph.total_replays
    eng.prewarm(PREWARM_K)
    rng = np.random.default_rng(SEED + 23)
    for b in range(B):
        eng.load_row_state(b, None)
        eng.set_row_sampler(b, {"kind": sampling.KIND_GREEDY,
                                "presence": 0.0, "frequency": 0.0})
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    toks = rng.integers(1, info.num_vocab, (B, T)).astype(np.int32)
    res = eng.step(toks, lens, np.ones(B, np.bool_))
    seq, _ = eng.decode_chunk(res.tokens, np.ones(B, np.bool_), PREWARM_K)
    torch.cuda.synchronize()
    out = {"lut4_launches": pm.phased_matmul.lut4_launches,
           "launches": pm.phased_matmul.launches,
           "skinny": fd7.v7_skinny_matmul.launches,
           "replays": fused_decode.DecodeGraph.total_replays - replays0}
    seq = np.asarray(seq)
    check(out["lut4_launches"] > 0 and out["skinny"] == 0
          and out["replays"] > 0,
          f"{tag} engine at max_batch {B} launched phased_matmul on codes "
          f"{out['lut4_launches']} times and v7_skinny_matmul "
          f"{out['skinny']} times in {out['replays']} graph replays")
    check(seq.size == B * PREWARM_K
          and bool(((seq >= 0) & (seq < info.num_vocab)).all()),
          f"{tag} engine's decode chunk gave tokens {seq.shape}")
    del eng
    return out


def phase_phased_parity(dev) -> dict:
    """The phased stacks on the card at 2 layers, bf16, B = 16 and 64: v7 at
    the 2.9B widths (plain, int8, int4, nf4), v6 at the 1B6 widths (plain,
    int8, nf4), v5 at the 0.4B widths (plain, sf4), the matrices scaled by
    their fan-in.  From a ragged 8-token prefill (one row idle), three decode
    steps through ``forward_t1`` against ``forward_t1_plain`` on the card
    (``BF16_MODEL_TOL``), every launch in lockstep with its plain version,
    and the same steps replayed from the stack's CUDA graph (equal to the
    eager kernels bit for bit); ``stack_for`` must pick the phased stack at
    B and the fused one at 8, and the eager steps must launch
    ``phased_matmul`` (on codes: the launches of their mode) and no
    ``v7_skinny_matmul``; an nf4 / sf4 stack's replay is timed
    (:func:`time_replay`).  Returns per case the worst absolute error on
    the hidden, the launches per replay and those timings, and the int4
    launches of ``phased_matmul`` and its nf4 / sf4 ones by mode."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.models import get_version_module
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.ops import phased_matmul as pm
    from ai00_server_tpu_torch.ops import v7_decode as fd7
    from ai00_server_tpu_torch.testing import make_raw_weights

    result = {"int4_launches": 0, "lut4_launches": {"nf4": 0, "sf4": 0},
              "engine": {}}
    lora = {"v7": LORA29, "v6": LORA6, "v5": LORA6}
    for version, width, mode in PHASED_CASES:
        info = phased_info(version, width, 2)
        tag = f"{version} {width} {mode or 'bf16'}"
        module = get_version_module(info.version)
        fd = fused_decode.module_for(info.version.value)
        math = fan_in_scaled(make_raw_weights(
            info, seed=SEED + 9, dtype=np.float32,
            lora_dims=lora[version]))
        p16 = stack_params(info, math, dtype=torch.bfloat16, device=dev,
                           quant={0: mode, 1: mode} if mode else None)
        del math
        p16[fd.FUSED_KEY] = fd.make_fused_layout(p16)
        check(fused_decode.stack_for(info.version.value, p16, 8) is fd,
              f"the {tag} model does not take its fused "
              "stack at 8 rows")
        for B in PHASED_BS:
            pd = fused_decode.stack_for(info.version.value, p16, B)
            check(pd is not fd and pd is not None,
                  f"the {tag} model does not take a "
                  f"phased stack at B={B}")
            rng = np.random.default_rng(SEED + B)
            lens = rng.integers(1, 9, B).astype(np.int32)
            lens[2] = 0
            toks = rng.integers(1, info.num_vocab, (B, 8))
            _, s0 = module.forward(
                p16, module.init_state(info, B, device=dev),
                torch.as_tensor(toks, device=dev),
                torch.as_tensor(lens, device=dev))
            steps = []
            for _ in range(3):
                l1 = np.ones(B, np.int32)
                l1[2] = 0
                steps.append((rng.integers(1, info.num_vocab, (B, 1)), l1))

            def decode(fwd, graph_state=None) -> list:
                state = graph_state or {k: t.clone() for k, t in s0.items()}
                outs = []
                for t1, l1 in steps:
                    h = fwd(p16, state, torch.as_tensor(t1, device=dev),
                            torch.as_tensor(l1, device=dev))[0]
                    outs.append([h[l1 > 0].float().clone()]
                                + [state[k].clone() for k in s0])
                return outs

            for k in (pm.phased_matmul, fd7.v7_skinny_matmul):
                k.launches = 0
            pm.phased_matmul.int4_launches = 0
            pm.phased_matmul.lut4_launches = 0
            got = decode(pd.forward_t1)
            torch.cuda.synchronize()
            check(pm.phased_matmul.launches > 0
                  and fd7.v7_skinny_matmul.launches == 0,
                  f"the {tag} phased stack at B={B} "
                  f"launched phased_matmul {pm.phased_matmul.launches} "
                  f"and v7_skinny_matmul {fd7.v7_skinny_matmul.launches} "
                  "times")
            coded = {"int4": pm.phased_matmul.int4_launches,
                     **dict.fromkeys(pm.TABLE_MODES,
                                     pm.phased_matmul.lut4_launches)}
            check(mode not in coded or coded[mode] > 0,
                  f"the {tag} phased stack at B={B} launched phased_matmul "
                  f"on {mode} codes {coded.get(mode)} times")
            result["int4_launches"] += pm.phased_matmul.int4_launches
            if mode in pm.TABLE_MODES:
                result["lut4_launches"][mode] += (
                    pm.phased_matmul.lut4_launches)
            plain = decode(pd.forward_t1_plain)
            for o in got:
                check(all(bool(torch.isfinite(a).all()) for a in o),
                      "non-finite bf16 output")
            for i, k in enumerate(s0):
                check(torch.equal(got[-1][1 + i][:, 2], s0[k][:, 2]),
                      f"the phased {version} stack changed an inactive "
                      "row's state")
            per_step = [max(float((a.double() - b.double()).abs().max())
                            / max(float(b.abs().max()), 1e-6)
                            for a, b in zip(o, r))
                        for o, r in zip(got, plain)]
            worst_abs = max(float((o[0].double() - r[0].double()).abs()
                                  .max()) for o, r in zip(got, plain))
            check(max(per_step) <= BF16_MODEL_TOL,
                  f"the phased {tag} stack at B={B} and "
                  f"forward_t1_plain disagree: {per_step}")
            lock = {}
            decode(functools.partial(pd._forward, lockstep(
                pd._OPS, pd._PLAIN_OPS, lock,
                {"wkv_gn": V7_WIDE_STATE_TOL} if version == "v7" else {})))
            check(max(lock.values()) <= 1.0,
                  f"a launch of the phased {tag} stack "
                  f"at B={B} disagrees with its plain version: {lock}")
            gstate = {k: t.clone() for k, t in s0.items()}
            graph = pd.DecodeGraph(p16, gstate, B)

            def replay(params, state, t1, lengths, _g=graph):
                return _g.replay(t1[:, 0], lengths)[:, None], state

            replayed = decode(replay, gstate)
            check(all(torch.equal(a, b) for o, r in zip(replayed, got)
                      for a, b in zip(o, r)),
                  f"the phased {tag} stack's graph "
                  f"replays differ from its eager launches at B={B}")
            label = f"{tag} B={B}"
            result[label] = {"max_abs_err": worst_abs,
                             "per_replay": graph.launches_per_replay}
            if mode in pm.TABLE_MODES:
                # The nf4 / sf4 stacks' replay beside its plain version and
                # bound (2 layers): no served model holds the v6 / v5 ones.
                st = time_replay(pd, p16, {k: t.clone()
                                           for k, t in s0.items()},
                                 graph, B, fd.FUSED_KEY)
                result[label]["stack"] = st
                print_wide(f"2 layers {tag} (parity model)",
                           {f"phased B={B}": st})
            print(f"phased decode in bf16 on the card, {label} (2 layers, "
                  f"3 steps, row 2 idle): max |kernels - plain| / max "
                  f"|plain| over hidden and state per step "
                  + " / ".join(f"{x:.3e}" for x in per_step)
                  + f" (tolerance {BF16_MODEL_TOL}), {worst_abs:.3e} "
                  "absolute on the hidden; in lockstep worst error / "
                  "tolerance " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in lock.items())
                  + f"; graph replays equal the eager launches bit for bit; "
                  f"launches per replay {graph.launches_per_replay} "
                  "(v7_ln_mix, phased_matmul, WKV), no v7_skinny_matmul; "
                  "inactive row bit-identical", flush=True)
            del graph, gstate, s0
        if mode in pm.TABLE_MODES and version != "v7":
            # The v6 / v5 4-bit models through an Engine (v7's: the nf4
            # wide server).
            run = phased_engine_run(info, p16, mode, dev)
            result["engine"][tag] = run
            print(f"Engine over the 2-layer {tag} parity model at max_batch "
                  f"{WIDE_BATCH}: phased stack; prewarm, a ragged prefill "
                  f"and a {PREWARM_K}-step greedy chunk launched "
                  f"phased_matmul {run['launches']} times "
                  f"({run['lut4_launches']} on {mode} codes) in "
                  f"{run['replays']} graph replays, v7_skinny_matmul "
                  f"{run['skinny']}", flush=True)
        del p16
        gc.collect()
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------


def synthetic_vocab() -> dict[str, str]:
    """65,535 distinct printable tokens (ids 1..65535; id 0 is
    end-of-text): the printable ASCII characters, then letter pairs,
    triples and quadruples, every other one with a leading space.  No
    token holds a newline, so the default "\\n\\n" stop never fires."""
    import itertools
    import string

    toks = [chr(c) for c in range(32, 127)]
    for n in (2, 3, 4):
        for i, t in enumerate(itertools.product(string.ascii_lowercase,
                                                repeat=n)):
            toks.append(("" if i % 2 else " ") + "".join(t))
            if len(toks) == VOCAB - 1:
                return {str(i + 1): t for i, t in enumerate(toks)}
    raise AssertionError("vocab too small")


# kind: (quant = N, quant_type).  "bf16", "int8" and "nf4" take the fused
# path under its graph and get the burst; the mixed ones the layer path.
SERVED = {"bf16": (0, "Int8"), "int8": (L_FULL, "Int8"),
          "mixed": (L_FULL // 2, "Int8"), "nf4": (L_FULL, "NF4"),
          "mixed nf4": (L_FULL // 2, "NF4")}
# RWKV-6 (the 1B6 shape, L6 layers), RWKV-5 and RWKV-4 (the 0.4B shapes,
# L54 layers): bf16, with the burst.
SERVED_FAMILIES = {"v6 bf16": (0, "Int8"), "v5 bf16": (0, "Int8"),
                   "v4 bf16": (0, "Int8")}
# max_batch = WIDE_BATCH: the phased stacks under their graphs, with a burst
# of WIDE_BATCH concurrent completions.  v7 with every layer int8 or nf4,
# v5 bf16.
SERVED_WIDE = {"int8 wide": (L_FULL, "Int8"), "nf4 wide": (L_FULL, "NF4"),
               "v5 bf16 wide": (0, "Int8")}
# RWKV-7 of head size 128 (H = 8) at the 0.4B width, L128 layers, bf16.
HEAD_SERVED = "v7 N=128 bf16"
ALL_SERVED = {**SERVED, **SERVED_FAMILIES, **SERVED_WIDE,
              HEAD_SERVED: (0, "Int8")}
WIDE_TOKENS = 48  # per completion of the wide burst
# The nf4 server's prefab (prefab_flow): the nf4 wide model loads it, the
# same codes without quantizing the checkpoint on the host again.
NF4_PREFAB = "rwkv7-0.4b-nf4.prefab"
MIXED_TOKENS = 8  # per completion on the (eager, host-bound) layer path


def served_layers(kind: str) -> int:
    """The depth of a served kind's checkpoint."""
    if kind == HEAD_SERVED:
        return L128
    family = kind[:2]
    return {"v6": L6, "v5": L54, "v4": L54}.get(family, L_FULL)


def write_site(tmp: Path) -> dict:
    """The checkpoint, the vocabulary and one config per served model:
    plain bf16, then ``quant = L`` and ``quant = L / 2`` (mixed) in int8 and
    in nf4, and ``quant = L`` int8 and nf4 at ``max_batch = WIDE_BATCH``
    (nf4 from ``NF4_PREFAB``, which the nf4 server's prefab flow writes)."""
    import numpy as np

    from ai00_server_tpu_torch.loader import save_safetensors
    from ai00_server_tpu_torch.testing import (make_raw_weights,
                                               to_converted_layout)

    t0 = time.monotonic()
    raw = make_raw_weights(model_info(L_FULL), seed=SEED, dtype=np.float32,
                           lora_dims=LORA)
    save_safetensors(to_converted_layout(raw), str(tmp / "rwkv7-0.4b.st"))
    del raw
    (tmp / "vocab.json").write_text(json.dumps(synthetic_vocab()))
    cfgs = {}
    for kind in (*SERVED, "int8 wide", "nf4 wide"):
        quant, quant_type = ALL_SERVED[kind]
        cfgs[kind] = tmp / f"Config-{kind.replace(' ', '-')}.toml"
        # The mixed models' layer path is host-bound (~0.28 s a step): a
        # prewarm's 82 steps there would take ~20 s, so they load without.
        cfgs[kind].write_text(f"""
[model]
name = "{NF4_PREFAB if kind == 'nf4 wide' else 'rwkv7-0.4b.st'}"
path = "{tmp}"
max_batch = {WIDE_BATCH if kind.endswith('wide') else MAX_BATCH}
token_chunk_size = {CHUNK}
precision = "Fp16"
quant = {quant}
quant_type = "{quant_type}"
prewarm = {'false' if kind.startswith('mixed') else 'true'}

[tokenizer]
path = "{tmp / 'vocab.json'}"

[listen]
ip = "127.0.0.1"
port = 0
force_pass = false
slot = "{SMOKE_SLOT}"

[[listen.app_keys]]
app_id = "{SMOKE_KEY['app_id']}"
secret_key = "{SMOKE_KEY['app_secret']}"
""")
    print(f"wrote the random 0.4B-shape checkpoint and vocabulary in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return cfgs


def write_site_family(tmp: Path, version: str) -> dict:
    """The random checkpoint of the RWKV-6 1B6 shape (``L6`` layers) or the
    RWKV-5 / RWKV-4 0.4B shape (f16 on disk, as ``write_site`` writes v7's;
    the matrices scaled by their fan-in, as in the parity phase) and its
    config, beside the vocabulary ``write_site`` left in ``tmp``."""
    import numpy as np

    from ai00_server_tpu_torch.loader import save_safetensors
    from ai00_server_tpu_torch.testing import (make_raw_weights,
                                               to_converted_layout)

    t0 = time.monotonic()
    layers = L6 if version == "v6" else L54
    shape = "1b6" if version == "v6" else "0.4b"
    raw = fan_in_scaled(make_raw_weights(
        model_info(layers, version), seed=SEED, dtype=np.float32,
        lora_dims=lora_dims(version)))
    conv = to_converted_layout(raw)
    del raw
    path = tmp / f"rwkv{version[1]}-{shape}.st"
    save_safetensors(conv, str(path))
    del conv
    cfgs = {}
    for kind in (f"{version} bf16", f"{version} bf16 wide"):
        if kind not in ALL_SERVED:
            continue
        quant, quant_type = ALL_SERVED[kind]
        cfgs[kind] = tmp / f"Config-{kind.replace(' ', '-')}.toml"
        cfgs[kind].write_text(f"""
[model]
name = "{path.name}"
path = "{tmp}"
max_batch = {WIDE_BATCH if kind.endswith('wide') else MAX_BATCH}
token_chunk_size = {CHUNK}
precision = "Fp16"
quant = {quant}
quant_type = "{quant_type}"

[tokenizer]
path = "{tmp / 'vocab.json'}"

[listen]
ip = "127.0.0.1"
port = 0
""")
    print(f"wrote the random {layers}-layer {version} {shape}-shape "
          f"checkpoint ({path.stat().st_size / 1e9:.2f} GB) in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return cfgs, path


PROMPT = ("the quick brown fox jumps over the lazy dog while a model "
          "decodes tokens on the card ")
NO_EOS = {"0": -1e4}  # random weights: keep end-of-text out of greedy picks
# One long prompt alone on the v7 bf16 and quant = 24 Int8 servers: 4,077
# tokens of text (16 prefill chunks), where the prefill kernels' share of
# TTFT is largest.
LONG_PROMPT = "a long one: " + PROMPT * 110


RAG_WORDS = ("river stone lamp orbit cedar violet harbor quartz ember meadow "
             "falcon copper lantern glacier tundra saffron willow basalt "
             "comet thistle").split()


def rag_texts(n: int) -> list[str]:
    """n distinct short documents from a fixed word list."""
    import random

    rs = random.Random(SEED)
    return [f"note {i}: " + " ".join(rs.choice(RAG_WORDS) for _ in range(12))
            for i in range(n)]


def embed_recipe(engine, token_lists):
    """Mean-hidden vectors of up to ``max_batch`` texts from ONE (B, CHUNK)
    forward from fresh states, the shape of the serving prefill step: the
    masked mean of the final hidden states, L2-normalized.  Independent of
    the runtime's install, the engine's hidden sums and the HTTP path."""
    import numpy as np
    import torch

    B, T, dev = engine.max_batch, engine.token_chunk_size, engine.device
    toks = np.zeros((B, T), np.int32)
    lens = np.zeros(B, np.int32)
    for i, t in enumerate(token_lists):
        toks[i, :len(t)], lens[i] = t, len(t)
    lens_t = torch.as_tensor(lens, device=dev)
    with engine._lock:
        hidden, _ = engine.module.forward(
            engine.model.params,
            engine.module.init_state(engine.info, B, device=dev),
            torch.as_tensor(toks, device=dev), lens_t)
        mask = torch.arange(T, device=dev)[None, :, None] < lens_t[:, None,
                                                                   None]
        sums = (hidden.float() * mask).sum(1).cpu().numpy()
    n = len(token_lists)
    v = sums[:n].astype(np.float64) / np.maximum(lens[:n, None], 1)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


async def rag_flow(http, base, server) -> dict:
    """Embeddings, /chooses, retrieval and a RAG chat on a served model:
    a batch of ``/embeddings`` (timed), each held against
    ``embed_recipe`` of its own text, and the ``pooling="state"`` readout;
    ``/chooses`` both ways; ``/api/retrieval/index`` from texts with
    ``nlist`` (an IVF built on the card), ``add`` and ``search`` by text and
    by vector (the IVF hits held against ``ivf_search`` on CPU copies of
    the index: the kernel's plain version); a RAG chat beside the same chat
    without retrieval.  ``ivf_score``'s count is zeroed just before and
    read just after."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.ops import retrieval as R

    env = server.middleware.env
    C = env.model.info.num_emb
    texts = rag_texts(64)

    async def post(path, **body):
        async with http.post(f"{base}{path}", json=body) as r:
            check(r.status == 200, f"{path} answered {r.status}: "
                  f"{await r.text()}")
            return await r.json()

    R.ivf_score.launches = 0
    t0 = time.monotonic()
    emb = await post("/api/oai/embeddings", input=texts[:32])
    emb_s = time.monotonic() - t0
    vecs = np.array([d["embedding"] for d in emb["data"]], np.float32)
    check(vecs.shape == (32, C) and emb["dimensions"] == C,
          f"/embeddings gave shape {vecs.shape}")
    check(bool(np.isfinite(vecs).all()), "/embeddings gave non-finite values")
    check(bool(np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-4)),
          "/embeddings vectors are not unit vectors")
    # Every served vector against the recipe in the serving shape; what a
    # fault would read: the text without its last token, or the next row's
    # text.  The limit must sit between the two.
    eng, B = env.engine, env.engine.max_batch
    enc = [env.tokenizer.encode(t) for t in texts[:32]]
    check(max(map(len, enc)) <= eng.token_chunk_size,
          "an /embeddings text is longer than one prefill chunk")
    ref = np.concatenate([embed_recipe(eng, enc[i:i + B])
                          for i in range(0, 32, B)])
    short = np.concatenate([embed_recipe(eng, [e[:-1] for e in enc[i:i + B]])
                            for i in range(0, 32, B)])
    own = np.abs(vecs - ref).max(1)
    emb_err = float(own.max())
    wrong = float(min(np.abs(vecs - short).max(1).min(),
                      np.abs(vecs - np.roll(ref, 1, 0)).max(1).min()))
    check(emb_err <= EMBED_TOL, f"a served embedding is {emb_err} off the "
          f"recipe in the serving shape (per text: {own})")
    check(wrong > EMBED_TOL, f"a wrong vector reads {wrong}, inside the "
          f"limit {EMBED_TOL}: the check cannot tell it")
    solo = max(float(np.abs(vecs[i] - eng.mean_hidden_embed(enc[i])).max())
               for i in (0, 1, 7))
    check(solo <= BF16_MODEL_TOL, f"a served embedding is {solo} off the "
          "engine's batch-1 mean_hidden_embed")
    st = await post("/api/oai/embeddings", input=texts[:2], pooling="state")
    svec = np.array([d["embedding"] for d in st["data"]], np.float32)
    check(svec.shape == (2, 3 * C) and bool(np.isfinite(svec).all()),
          f"pooling='state' gave shape {svec.shape}")

    ppl = {}
    for calibrate in (False, True):
        out = await post("/api/oai/chooses", input=PROMPT,
                         choices=[" the", " a", " dog", " card"],
                         calibrate=calibrate)
        p = [d["perplexity"] for d in out["data"]]
        check(len(p) == 4 and all(np.isfinite(p)) and p == sorted(p),
              f"/chooses gave {p}")
        ppl[calibrate] = p

    made = await post("/api/retrieval/index", name="kb", texts=texts[:48],
                      nlist=8)
    check(made["size"] == 48 and made["dim"] == C,
          f"/api/retrieval/index gave {made}")
    added = await post("/api/retrieval/add", name="kb", texts=texts[48:])
    check(added["size"] == 64, f"/api/retrieval/add gave {added}")
    by_text = await post("/api/retrieval/search", name="kb",
                         queries=texts[:4], top_k=3, nprobe=4)
    check(all(len(d["hits"]) == 3 for d in by_text["data"]),
          "a text search returned fewer than 3 hits")
    by_vec = await post("/api/retrieval/search", name="kb",
                        vectors=vecs[:8].tolist(), top_k=5, nprobe=4)
    ivf = server.retrieval.get("kb").ivf
    cpu = R.IVFIndex(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                        for k, v in vars(ivf).items()})
    s_ref, i_ref = R.ivf_search(cpu.centroids, cpu.packed, cpu.packed_ids,
                                torch.as_tensor(vecs[:8]), k=5, nprobe=4,
                                pscale=cpu.pscale)
    for d, s_r, i_r in zip(by_vec["data"], s_ref.numpy(), i_ref.numpy()):
        got = [h["id"] for h in d["hits"]]
        check(np.allclose([h["score"] for h in d["hits"]], s_r[:len(got)],
                          atol=1e-4), "IVF scores on the card differ from "
              "the plain version's on the CPU")
        distinct = [i for j, i in enumerate(i_r[:len(got)])
                    if np.sum(np.abs(s_r - s_r[j]) < 1e-4) == 1]
        check(all(i in got for i in distinct),
              f"IVF hits {got} differ from the plain version's {i_r}")

    chat = {"messages": [{"role": "user", "content": texts[5]}],
            "max_tokens": 16, "sampler": {"type": "Nucleus", "top_k": 1},
            "logit_bias": NO_EOS}
    rag = await post("/api/oai/chat/completions",
                     retrieval={"index": "kb", "top_k": 2, "nprobe": 4},
                     **chat)
    plain = await post("/api/oai/chat/completions", **chat)
    check(bool(rag["choices"][0]["message"]["content"]),
          "the RAG chat returned no text")
    check(rag["usage"]["prompt"] > plain["usage"]["prompt"],
          "the RAG chat's prompt holds no retrieved document")
    launches = R.ivf_score.launches
    check(launches > 0, "the retrieval requests never launched ivf_score")
    return {"embed_s": emb_s, "embeddings_per_s": 32 / emb_s,
            "embed_err": emb_err, "embed_wrong": wrong, "embed_solo": solo,
            "ppl": ppl, "ivf_launches": launches,
            "rag_prompt": rag["usage"]["prompt"],
            "plain_prompt": plain["usage"]["prompt"],
            "rag_text": rag["choices"][0]["message"]["content"][:60]}


# The fused v7 step's CUDA kernels (csrc/decode_common.cuh, v7_decode.cu):
# the trace of a bf16 decode must hold each.
FUSED_V7_KERNELS = ("ln_mix_kernel", "skinny_tc_kernel", "wkv_gn_kernel")


async def profiled(http, base, auth, trace_dir: Path, request,
                   worker_tids) -> str:
    """Await one request between ``/admin/profile/start`` and ``/stop`` (a
    torch.profiler trace, written as Chrome JSON by the route) and read the
    trace: its CUDA kernels a token (the graph replays' included), the
    device's busy share of the request's wall time (the union of the
    kernels' intervals: programmatic dependents overlap, so the sum of
    their times overstates it), the kernels that took most of it, and the
    host ops by thread (``worker_tids``: the runtime's engine thread).
    Fails without a kernel event, or without each of the fused v7 step's
    kernels."""
    from ai00_server_tpu_torch.server.app import PROFILE_TRACE

    async with http.post(f"{base}/admin/profile/start", headers=auth,
                         json={"dir": str(trace_dir)}) as r:
        check(r.status == 200, f"/admin/profile/start answered {r.status}: "
              f"{(await r.text())[:200]}")
    t0 = time.monotonic()
    out = await request
    wall_us = (time.monotonic() - t0) * 1e6
    t0 = time.monotonic()
    async with http.post(f"{base}/admin/profile/stop", headers=auth) as r:
        check(r.status == 200, f"/admin/profile/stop answered {r.status}: "
              f"{(await r.text())[:200]}")
    stop_s = time.monotonic() - t0
    path = trace_dir / PROFILE_TRACE
    size = path.stat().st_size
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict[str, float] = {}
    spans = []
    for e in events:
        if e.get("cat") == "kernel":
            spans.append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    n_kernels = len(spans)
    check(n_kernels > 0, "the trace of /admin/profile holds no CUDA kernel")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    missing = [k for k in FUSED_V7_KERNELS
               if not any(k in name for name in by_name)]
    check(not missing, f"the trace of /admin/profile holds no {missing} of "
          "the fused v7 step")
    summed = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ops: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ops[e["tid"]] = ops.get(e["tid"], 0) + 1
    on_worker = sum(n for tid, n in ops.items() if tid in worker_tids)
    n = out["usage"]["completion"]
    return (f"{n} tokens in {wall_us / 1e6:.3f} s (traced through "
            f"/admin/profile; stop and export {stop_s:.2f} s, "
            f"{size / 1e6:.1f} MB of JSON), "
            f"{n_kernels} device kernels ({n_kernels / n:.1f} per token); "
            f"device busy {busy / 1e6:.4f} s = "
            f"{100 * busy / wall_us:.2f}% of wall (kernel times summed "
            f"{summed / 1e6:.4f} s); host ops "
            f"{sum(ops.values())} on {len(ops)} threads, {on_worker} of them "
            "on the engine's worker thread; top kernels: "
            + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms" for n, t in top))


# The listener of every write_site config: admin routes want a JWT.
SMOKE_SLOT = "smoke-slot"
SMOKE_KEY = {"app_id": "smoke", "app_secret": "smoke-secret"}


async def admin_token(http, base, server) -> dict:
    """A JWT from ``/api/auth/exchange`` as the ``Authorization`` header;
    an admin request without one answers 401 and leaves the model."""
    async with http.get(f"{base}/admin/models/unload") as r:
        check(r.status == 401, f"an admin request without a token answered "
              f"{r.status}")
    check(server.middleware.env is not None,
          "an admin request without a token unloaded the model")
    async with http.post(f"{base}/api/auth/exchange", json=SMOKE_KEY) as r:
        check(r.status == 200, f"/api/auth/exchange answered {r.status}")
        return {"Authorization": f"Bearer {(await r.json())['token']}"}


async def read_metrics(http, base, sent: int) -> dict:
    """``/api/metrics`` once every slot is free (a slot frees just after
    its stream ends): ``requests_finished`` equals the requests ``sent``,
    no slot busy, a positive mean step time."""
    for _ in range(200):
        async with http.get(f"{base}/api/metrics") as r:
            check(r.status == 200, f"/api/metrics answered {r.status}")
            m = dict(line.split(" ", 1)
                     for line in (await r.text()).strip().splitlines())
        if m.get("ai00_slots_busy") == "0":
            break
        await asyncio.sleep(0.01)
    check(int(m["ai00_runtime_requests_finished"]) == sent,
          f"/api/metrics counts {m['ai00_runtime_requests_finished']} "
          f"finished requests, {sent} were sent")
    check(m["ai00_slots_busy"] == "0",
          f"/api/metrics: {m['ai00_slots_busy']} slots busy after the burst")
    check(float(m["ai00_step_seconds_avg"]) > 0,
          "/api/metrics: no mean step time")
    return m


# BNF-constrained generation on the bf16 server: a regular grammar (the
# device token DFA), the same with a free-text region (the constrained
# burst and the timed chunk: every row stays on the DFA for long walks) and
# a non-regular one (the native Earley engine and the chunk replay).
BNF_REGULAR = 'start ::= "answer: " ("yes" | "no") ".";'
BNF_STICKY = 'start ::= "answer: " #"[a-z ]+" ".";'
BNF_NESTED = 'start ::= "(" start ")" | "x";'
BNF_TOKENS = 64  # per completion of the constrained burst
BNF_K = 16       # steps of the timed chunk


async def bnf_flow(http, base, server) -> dict:
    """BNF on a served model: one completion under ``BNF_REGULAR`` (the
    device DFA) and one chat under ``BNF_NESTED`` (Earley replay), each
    text held by the port's Python ``GrammarEngine`` (accepted whole when
    the grammar stopped it, else a live prefix); a burst of ``MAX_BATCH``
    completions under ``BNF_STICKY`` with the fused stack's launch counts
    zeroed before and read after; then, on an engine of its own over the
    served weights, ``BNF_K``-step chunks with every row on the DFA beside
    unconstrained ones, in turns, each DFA chunk's tokens walked through
    the table on the host (every token allowed by its row's table row, the
    final ``dfa_state`` the walk's), and the DFA step's ops alone."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.engine import Engine, dfa_advance, dfa_mask
    from ai00_server_tpu_torch.grammar import GrammarEngine, token_dfa_table
    from ai00_server_tpu_torch.ops import v7_decode as fd

    env = server.middleware.env
    metrics = env.runtime.metrics
    m0 = dict(metrics)

    async def post(path, **body):
        async with http.post(f"{base}{path}", json={
                "sampler": {"type": "Nucleus", "top_k": 1},
                "logit_bias": NO_EOS, **body}) as r:
            check(r.status == 200, f"{path} under a grammar answered "
                  f"{r.status}: {await r.text()}")
            return await r.json()

    def held(schema, text, reason, what):
        g = GrammarEngine(schema)
        check(bool(text) and g.advance(text.encode()),
              f"{what}: {text!r} leaves the grammar {schema!r}")
        check(reason == "length" or (reason == "stop" and g.can_finish()),
              f"{what}: {text!r} ended ({reason}) where {schema!r} cannot")

    c = (await post("/api/oai/completions", prompt=PROMPT, max_tokens=16,
                    bnf_schema=BNF_REGULAR))["choices"][0]
    held(BNF_REGULAR, c["text"], c["finish_reason"], "the DFA completion")
    out = {"regular": (c["text"], c["finish_reason"])}
    c = (await post("/api/oai/chat/completions", max_tokens=24,
                    messages=[{"role": "user", "content": PROMPT}],
                    bnf_schema=BNF_NESTED))["choices"][0]
    held(BNF_NESTED, c["message"]["content"], c["finish_reason"],
         "the Earley chat")
    out["nested"] = (c["message"]["content"], c["finish_reason"])
    check(metrics["bnf_dfa_requests"] - m0["bnf_dfa_requests"] == 1
          and metrics["bnf_replay_requests"]
          - m0["bnf_replay_requests"] == 1,
          f"the grammars did not take the DFA and the replay: {metrics}")

    for k in fd.KERNELS:
        k.launches = 0
    replays0 = fd.DecodeGraph.total_replays
    t0 = time.monotonic()
    outs = await asyncio.gather(*[post(
        "/api/oai/completions", prompt=PROMPT * (1 + i),
        max_tokens=BNF_TOKENS, bnf_schema=BNF_STICKY)
        for i in range(MAX_BATCH)])
    wall = time.monotonic() - t0
    out["burst_launches"] = {k.__name__: k.launches for k in fd.KERNELS}
    out["burst_replays"] = fd.DecodeGraph.total_replays - replays0
    for name, n in out["burst_launches"].items():
        check(n > 0, f"the constrained burst never launched {name}")
    check(out["burst_replays"] > 0, "the constrained burst replayed no graph")
    for o in outs:
        c = o["choices"][0]
        held(BNF_STICKY, c["text"], c["finish_reason"],
             "a completion of the constrained burst")
    n_tokens = sum(o["usage"]["completion"] for o in outs)
    out.update(burst_wall_s=wall, burst_tokens=n_tokens,
               burst_tokens_per_s=n_tokens / wall,
               sample=outs[0]["choices"][0]["text"][:60])
    out["metrics"] = {k: v - m0[k] for k, v in metrics.items()
                      if k.startswith("bnf_")}

    # The DFA chunk against an unconstrained one, on an engine of its own.
    eng = Engine(env.model, max_batch=MAX_BATCH, token_chunk_size=CHUNK,
                 device=env.engine.device)
    B, H = MAX_BATCH, eng.dfa_height - 1
    table, _ = token_dfa_table(BNF_STICKY, env.tokenizer, eng.vocab,
                               max_states=H)
    first = np.full(B, env.tokenizer.encode(" the")[0], np.int32)
    active = np.ones(B, np.bool_)

    def chunk(dfa: bool) -> float:
        for b in range(B):
            if dfa:
                eng.set_row_dfa(b, table, 0, key=BNF_STICKY)
            else:
                eng.clear_row_dfa(b)
        torch.cuda.synchronize()
        replays = fd.DecodeGraph.total_replays
        t = time.perf_counter()
        toks, _ = eng.decode_chunk(first, active, BNF_K)  # ends in a sync
        ms = (time.perf_counter() - t) * 1e3
        check(fd.DecodeGraph.total_replays - replays == BNF_K,
              f"a {BNF_K}-step chunk replayed "
              f"{fd.DecodeGraph.total_replays - replays} graphs")
        if dfa:
            ds = eng.dfa_state.cpu().numpy()
            for b in range(B):
                s, prev = 0, int(first[b])
                for i in range(BNF_K):
                    t = int(toks[i, b])
                    if s == H:
                        check(t == prev, f"row {b} moved after its grammar "
                              f"halted, step {i}")
                    else:
                        check(table[s, t] >= 0, f"row {b} sampled token {t} "
                              f"at step {i}, which table row {s} disallows")
                        s = int(table[s, t])
                    prev = t
                check(int(ds[b]) == s, f"row {b}: dfa_state {int(ds[b])}, "
                      f"the table walk {s}")
        return ms

    times = {False: [], True: []}
    for dfa in (False, True, True, False, False, True, True, False, False,
                True):
        times[dfa].append(chunk(dfa))
    out["chunk_ms"] = float(np.median(times[False]))
    out["chunk_dfa_ms"] = float(np.median(times[True]))
    # The DFA step's ops alone (those of decode_chunk's step), every row
    # on the DFA.
    toks = torch.as_tensor(first, device=eng.device)
    act = torch.ones(B, dtype=torch.bool, device=eng.device)

    ds = eng.dfa_state.long()
    on = ds >= 0
    logits = torch.zeros(B, eng.vocab, device=eng.device)

    def step():
        srow, mask = dfa_mask(eng.dfa_pool, eng._rows, ds, on, eng.mask_pool)
        act & (ds != H)
        torch.where(mask, logits, float("-inf"))  # the sampler's mask op
        dfa_advance(ds, on, srow, toks, act)

    out["dfa_step_ms"] = device_ms(step, 100)
    # The same ops back to back from Python: their host cost a step.
    out["dfa_step_host_ms"] = call_ms(step, 200)
    # Read: each row's table row (B x V int8), mask_pool (B x V bool), the
    # logits (B x V f32), the states and tokens; written: the (B, V) mask,
    # the masked logits and the states.
    nbytes = 3 * B * eng.vocab + 8 * B * eng.vocab + 3 * 8 * B
    out["dfa_step_bound_ms"], _ = bound(nbytes, 0)
    out["dfa_step_bytes"] = nbytes
    out["pool_mb"] = eng.dfa_pool.numel() / 1e6
    out["pool_shape"] = tuple(eng.dfa_pool.shape)
    del eng
    return out


# Custom initial states, LoRA and prefabs on the served 0.4B shape.
STATE_ID = "5e1f0a2b-7c3d-4e5f-8a9b-0c1d2e3f4a5b"
STATE_SCALE = 0.3            # the tuned WKV: 0.3 x standard normal
LORA_RANK, LORA_ALPHA = 16, 16.0
LORA_KEYS = {"att.receptance.weight": (C, C), "att.output.weight": (C, C),
             "ffn.value.weight": (FFN, C)}
# /api/oai/states reads the state after ONE token: a T=1 step, the graph
# replay right after the install, held against forward_t1_plain (the same
# recipe); the prompts of (e) and (f) prefill from the state (wkv7_chunk).
STATE_TOKEN = 300
STATE_DELTA_TOL = 1e-3       # (c): f32 roundings of the state update only
STATE_TOKENS = 32            # greedy tokens of each state / prefab answer
INSTALL_REPS = 5
LASTING_ST = "rwkv7-0.4b-lasting.st"
L_STATE = 6                  # its layers (a quarter of the 0.4B's, for time)


def lasting(raw: dict) -> dict:
    """RWKV-7 weights scaled by their fan-in (``fan_in_scaled``, IN PLACE)
    with the decay bias ``w0`` at -6, a decay of ~0.9985 a step: a state
    lasts through a prompt and 24 bf16 layers do not carry a flipped
    rounding far (``tools/torch_bf16_depth.py`` reads both)."""
    for k, v in fan_in_scaled(raw).items():
        if k.endswith("att.w0"):
            v[...] = -6.0
    return raw


def write_state_site(tmp: Path) -> tuple[Path, Path, Path]:
    """A 0.4B-shape checkpoint on which a state lasts (``LASTING_ST``,
    :func:`lasting` weights, f16 on disk), a
    state-tuned ``tuned.state`` (per-layer ``time_state``, stored
    transposed as the converter stores it) and a rank-``LORA_RANK`` LoRA
    over every layer's ``att.receptance``, ``att.output`` and
    ``ffn.value`` (``lora.0`` stored transposed), both f32, from seeded
    generators."""
    import numpy as np

    from ai00_server_tpu_torch.loader import save_safetensors
    from ai00_server_tpu_torch.testing import (make_raw_weights,
                                               to_converted_layout)

    info = model_info(L_STATE)
    raw = lasting(make_raw_weights(info, seed=SEED + 18, dtype=np.float32,
                                   lora_dims=LORA))
    save_safetensors(to_converted_layout(raw), str(tmp / LASTING_ST))
    del raw
    H, N = info.num_head, info.head_size
    rng = np.random.default_rng(SEED + 17)
    state = {f"blocks.{i}.att.time_state": np.swapaxes(
        rng.standard_normal((H, N, N), dtype=np.float32) * STATE_SCALE,
        -1, -2) for i in range(L_STATE)}
    save_safetensors(state, str(tmp / "tuned.state"), dtype=np.float32)
    lora = {}
    for i in range(L_STATE):
        for k, (n_in, n_out) in LORA_KEYS.items():
            a = rng.standard_normal((LORA_RANK, n_in), dtype=np.float32)
            b = rng.standard_normal((n_out, LORA_RANK), dtype=np.float32)
            lora[f"blocks.{i}.{k}.lora.0"] = (a * 0.05).T
            lora[f"blocks.{i}.{k}.lora.1"] = b * 0.05
    save_safetensors(lora, str(tmp / "lora.st"), dtype=np.float32)
    return tmp / LASTING_ST, tmp / "tuned.state", tmp / "lora.st"


async def greedy_text(http, base, prompt, state=None,
                      n=STATE_TOKENS) -> str:
    body = {"prompt": prompt, "max_tokens": n, "logit_bias": NO_EOS,
            "sampler": {"type": "Nucleus", "top_k": 1}}
    if state is not None:
        body["state"] = state
    async with http.post(f"{base}/api/oai/completions", json=body) as r:
        check(r.status == 200, f"a completion under state {str(state)[:40]}"
              f" answered {r.status}: {(await r.text())[:200]}")
        out = await r.json()
    check(out["usage"]["completion"] == n,
          f"a greedy completion stopped after {out['usage']['completion']}"
          " tokens")
    return out["choices"][0]["text"]


def plain_row(params, state, tokens, dev):
    """``tokens`` fed one at a time through ``forward_t1_plain`` (the
    stack's plain versions, eagerly, on the card) from the batch-1
    ``state`` (numpy or tensors, left untouched): (the state after them,
    the logits of the last)."""
    import torch

    from ai00_server_tpu_torch.engine import head_logits
    from ai00_server_tpu_torch.ops import v7_decode as fd

    st = {k: torch.as_tensor(v).to(dev, torch.float32).clone()
          for k, v in state.items()}
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for t in tokens:
        h = fd.forward_t1_plain(params, st, torch.tensor(
            [[int(t)]], dtype=torch.int32, device=dev), one)[0]
    return st, head_logits(params, h[:, -1])


def rel(got, want) -> float:
    import torch

    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-6)


def replay_turns(engines: dict, n: int = 20) -> dict:
    """Device ms of one graph replay (every row active) of each engine,
    in turns a, b, b, a, a, b (CUDA events around ``n`` replays); the
    engines' rows advance."""
    import torch

    out = {k: [] for k in engines}
    keys = list(engines)
    order = [keys[0], keys[1], keys[1], keys[0], keys[0], keys[1]]
    for key in order:
        eng = engines[key]
        B = eng.max_batch
        toks = torch.arange(1, B + 1, dtype=torch.int32, device=eng.device)
        ones = torch.ones(B, dtype=torch.int32, device=eng.device)
        with eng._lock:
            eng._graph.replay(toks, ones)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                eng._graph.replay(toks, ones)
            end.record()
            torch.cuda.synchronize()
        out[key].append(start.elapsed_time(end) / n)
    return {k: sorted(v)[len(v) // 2] for k, v in out.items()}


async def state_flow(http, base, server, tmp: Path, base_engine) -> dict:
    """Custom initial states and LoRA on the bf16 0.4B server: reload it
    with the ``LASTING_ST`` checkpoint (``L_STATE`` layers, weights under
    which bf16 layers do not carry one flipped rounding far, so the whole
    depth is held to the plain forward), a ``[[state]]`` entry
    (``tuned.state``) and a ``[[lora]]`` entry (``lora.st``), then (a) a
    blended weight on the card equals the host blend of the same files
    cast to bf16; (b)
    ``/api/models/info`` lists the state; (c) ``/api/oai/states`` under the
    state returns the packed state after one token, held per part at every
    layer against the plain forward from the unpacked file (and the same
    from the model's own state); (e) a greedy completion under the state id equals the same
    request with the state inline (``{data, shape}``) and as ``{path}``;
    (f) default, tuned, default on one prompt, each equal to a fresh
    slot's answer (an inline state: no cache, no continue); (g)
    ``/embeddings`` under the state echoes ``pooling: "state"``; the
    launch counts are zeroed before these requests and read after.  Then,
    on an engine of its own over the served weights, (d) the first logits
    of a step replayed right after a state is installed in row 3 while the
    other rows decode, held against the same kernels launched eagerly from
    that state after a synchronize, and the logits and the state of every
    layer after it against the plain forward from that state (a row not
    installed the same way; the other rows bit-identical to the same step
    without the install), the install's time, and the replay beside
    ``base_engine``'s (the write_site checkpoint: no LoRA, no custom
    state), in turns."""
    import numpy as np
    import torch
    from safetensors import safe_open

    from ai00_server_tpu_torch.engine import Engine, head_logits
    from ai00_server_tpu_torch.loader import (apply_lora, load_safetensors,
                                              to_math_layout)
    from ai00_server_tpu_torch.models import packing
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk

    model_path, state_path, lora_path = write_state_site(tmp)
    env = server.middleware.env
    req = dataclasses.replace(
        env.reload, model_path=str(model_path),
        lora=[{"path": str(lora_path), "alpha": LORA_ALPHA}],
        state=[{"path": str(state_path), "name": "tuned", "id": STATE_ID}])
    t0 = time.monotonic()
    await server.middleware.reload(req)
    out = {"load_s": time.monotonic() - t0}
    env = server.middleware.env
    if env.prewarm_future is not None:  # none of its work in the readings
        await env.prewarm_future
    info, dev, params = env.model.info, env.engine.device, env.model.params

    # (a) the blend on the card against the host blend of the same files.
    layer = L_STATE - 1
    key = f"blocks.{layer}.att.receptance.weight"
    with safe_open(str(model_path), framework="numpy") as f:
        raw = {key: f.get_tensor(key).astype(np.float32)}
    math = to_math_layout(raw)
    unblended = torch.from_numpy(math[key].copy()).to(torch.bfloat16)
    apply_lora(math, load_safetensors(str(lora_path)), LORA_ALPHA)
    got = params["layers"][layer]["att"]["receptance"].cpu()
    check(got.dtype == torch.bfloat16 and torch.equal(
        got, torch.from_numpy(math[key]).to(torch.bfloat16)),
        "the LoRA-blended weight on the card differs from the host blend")
    check(not torch.equal(got, unblended), "the LoRA changed no weight")
    out["blend_changed"] = float((got.float() - unblended.float()).abs()
                                 .max())

    # (b)
    async with http.get(f"{base}/api/models/info") as r:
        listed = (await r.json())["states"]
    check(listed == [{"name": "tuned", "id": STATE_ID, "default": False}],
          f"/api/models/info lists {listed}")

    counted = {"wkv7_chunk": wkv7_chunk,
               **{k.__name__: k for k in fd.KERNELS}}
    for k in counted.values():
        k.launches = 0
    replays0 = fd.DecodeGraph.total_replays

    # (c)
    file_state = packing.load_state_file(info, str(state_path))
    text = env.tokenizer.token_to_bytes(STATE_TOKEN).decode()
    toks = list(env.tokenizer.encode(text))
    check(toks == [STATE_TOKEN], f"{text!r} encodes to {toks}")
    shape = [L_STATE, HEAD + 2, C, 1]
    served = {}
    for which in ("tuned", "default"):
        body = {"input": text}
        if which == "tuned":
            body["state"] = STATE_ID
        t0 = time.monotonic()
        async with http.post(f"{base}/api/oai/states", json=body) as r:
            check(r.status == 200, f"/api/oai/states answered {r.status}")
            d = (await r.json())["data"][0]
        out[f"states_s_{which}"] = time.monotonic() - t0
        check(d["shape"] == shape, f"/api/oai/states shape {d['shape']}")
        served[which] = np.asarray(d["data"], np.float32).reshape(shape[:3])
    zero = env.engine.module.init_state(info, 1, device=dev)
    parts = {"att_x": slice(0, 1), "wkv": slice(1, HEAD + 1),
             "ffn_x": slice(HEAD + 1, HEAD + 2)}
    # Per part, layer 0 (its inputs: the token and the state) and every
    # layer, from the file and from the model's own state.
    errs, want = {}, {}
    for which, init in (("tuned", file_state), ("default", zero)):
        st, _ = plain_row(params, init, toks, dev)
        want[which] = packing.pack_state(info, st)
        errs[which] = {f"{p}{' L0' if l0 else ''}": rel(
            served[which][:1 if l0 else L_STATE, sl],
            want[which][:1 if l0 else L_STATE, sl])
            for p, sl in parts.items() for l0 in (True, False)}
    out["states_err"] = errs
    check(max(max(e.values()) for e in errs.values()) <= BF16_MODEL_TOL,
          f"/api/oai/states and the plain forward disagree: {errs} "
          f"(tolerance {BF16_MODEL_TOL})")
    # What the installed state adds to layer 0's WKV: the update is linear
    # in the state and layer 0's r, k, v, w, a are the token's alone, so
    # the bf16 roundings cancel and the served and plain additions agree
    # to f32 rounding; a state read wrong (or not at all) misses by ~1.
    wkv = parts["wkv"]
    out["states_delta_err"] = rel(
        served["tuned"][0, wkv] - served["default"][0, wkv],
        want["tuned"][0, wkv] - want["default"][0, wkv])
    check(out["states_delta_err"] <= STATE_DELTA_TOL,
          f"/api/oai/states: what the tuned state adds to layer 0's WKV "
          f"misses the plain forward's by {out['states_delta_err']:.3e} "
          f"(tolerance {STATE_DELTA_TOL})")

    # (e)
    flat = packing.pack_state(info, file_state).reshape(-1).tolist()
    prompt = "under the tuned state: " + PROMPT
    keyed = await greedy_text(http, base, prompt, STATE_ID)
    inline = await greedy_text(http, base, prompt,
                               {"data": flat, "shape": shape})
    by_path = await greedy_text(http, base, prompt,
                                {"path": str(state_path)})
    check(keyed == inline == by_path,
          f"the state by id, inline and by path answer differently: "
          f"{keyed!r} / {inline!r} / {by_path!r}")
    out["keyed"] = keyed

    # (f)
    zeros = {"data": [0.0] * len(flat), "shape": shape}
    p2 = PROMPT * 2
    seq = [await greedy_text(http, base, p2, s)
           for s in (None, STATE_ID, None)]
    fresh = [await greedy_text(http, base, p2, s)
             for s in (zeros, {"data": flat, "shape": shape})]
    check(seq[0] == seq[2] == fresh[0] and seq[1] == fresh[1],
          f"a state crossed to another state's slot or cache: default / "
          f"tuned / default {seq}, fresh default / tuned {fresh}")
    # Else a crossing would go unseen: the state must steer the answer.
    check(seq[1] != seq[0], f"the tuned state left the answer {seq[0]!r}")
    out["installs"] = env.runtime.metrics["state_installs"]

    # (g)
    async with http.post(f"{base}/api/oai/embeddings", json={
            "input": [text], "state": STATE_ID}) as r:
        check(r.status == 200, f"/embeddings under a state: {r.status}")
        emb = await r.json()
    check(emb["pooling"] == "state" and emb["dimensions"] == 3 * C,
          f"/embeddings under a state echoed {emb['pooling']}, "
          f"{emb['dimensions']} dims")
    torch.cuda.synchronize()
    out["launches"] = {name: k.launches for name, k in counted.items()}
    out["replays"] = fd.DecodeGraph.total_replays - replays0
    check(all(n > 0 for n in out["launches"].values())
          and out["replays"] > 0,
          f"the state flow's requests launched {out['launches']}, "
          f"{out['replays']} replays")

    # (d) trouble spot 1, on an engine of its own over the served weights.
    eng = Engine(env.model, max_batch=MAX_BATCH, token_chunk_size=CHUNK,
                 device=dev)
    B, row = MAX_BATCH, 3
    p = env.tokenizer.encode(PROMPT)[:CHUNK]
    block = np.zeros((B, CHUNK), np.int32)
    block[:, :len(p)] = p
    for b in range(B):
        eng.load_row_state(b)
    res = eng.step(block, np.full(B, len(p), np.int32), np.ones(B, np.bool_))
    seq_t, _ = eng.decode_chunk(res.tokens, np.ones(B, np.bool_), 4)
    last = seq_t[-1]
    pre = {k: v.clone() for k, v in eng.state_pool.items()}
    ones = np.ones(B, np.int32)
    everyone = np.ones(B, np.bool_)
    eng.load_row_state(row, file_state)
    replays = fd.DecodeGraph.total_replays
    with_install = eng.step(last[:, None], ones, everyone,
                            want_logits=True).logits.cpu()
    post = {k: v[:, row].clone() for k, v in eng.state_pool.items()}
    post_ctrl = {k: v[:, 0].clone() for k, v in eng.state_pool.items()}
    check(fd.DecodeGraph.total_replays == replays + 1,
          "the step after the install was not a graph replay")
    for k, v in eng.state_pool.items():
        v.copy_(pre[k])
    without = eng.step(last[:, None], ones, everyone,
                       want_logits=True).logits.cpu()
    others = [b for b in range(B) if b != row]
    check(torch.equal(with_install[others], without[others]),
          "installing a state in one row changed the other rows' logits")

    def eager(installed: bool):
        """The same step through the same kernels launched eagerly, on a
        copy of the pre-install pool (row 3 the file's state where
        ``installed``), after a synchronize: nothing written just before
        the WKV kernels fetch their state."""
        st = {k: v.clone() for k, v in pre.items()}
        if installed:
            for k, v in st.items():
                v[:, row] = torch.as_tensor(file_state[k][:, 0], device=dev)
        torch.cuda.synchronize()
        h, _ = fd.forward_t1(params, st, torch.as_tensor(
            last[:, None], device=dev), torch.as_tensor(ones, device=dev))
        return head_logits(params, h[:, 0]).cpu()

    ref, stale = eager(True), eager(False)
    out["install_err"] = rel(with_install[row], ref[row])
    out["install_ctrl"] = rel(with_install[0], ref[0])
    out["install_stale"] = rel(with_install[row], stale[row])
    check(max(out["install_err"], out["install_ctrl"]) <= KERNEL_TOL
          < out["install_stale"],
          f"the step replayed right after an install and the same kernels "
          f"from the installed state after a synchronize disagree: "
          f"{out['install_err']:.3e} (tolerance {KERNEL_TOL}; a row not "
          f"installed {out['install_ctrl']:.3e}; against the state before "
          f"the install {out['install_stale']:.3e})")
    # The plain forward from the installed state (and, the control, from
    # row 0's state): the state of every layer after the step, and the
    # logits; each also against the plain forward from the row's state
    # before the install, which a state read stale would match.
    st_plain, lg_plain = plain_row(params, file_state, [last[row]], dev)
    st_stale, lg_stale = plain_row(params, {k: v[:, row:row + 1]
                                            for k, v in pre.items()},
                                   [last[row]], dev)
    st_ctrl, lg_ctrl = plain_row(params, {k: v[:, :1]
                                          for k, v in pre.items()},
                                 [last[0]], dev)
    out["layer0_err"] = max(rel(post[k][0], st_plain[k][0, 0])
                            for k in post)
    for name, st_ref, got in (("state_err", st_plain, post),
                              ("state_stale", st_stale, post),
                              ("state_ctrl", st_ctrl, post_ctrl)):
        out[name] = max(rel(got[k], st_ref[k][:, 0]) for k in got)
    out["plain_logits_err"] = rel(with_install[row], lg_plain[0].cpu())
    out["plain_logits_stale"] = rel(with_install[row], lg_stale[0].cpu())
    out["plain_logits_ctrl"] = rel(with_install[0], lg_ctrl[0].cpu())
    check(max(out["state_err"], out["state_ctrl"], out["plain_logits_err"],
              out["plain_logits_ctrl"]) <= BF16_MODEL_TOL
          < min(out["state_stale"], out["plain_logits_stale"]),
          f"the step replayed right after the install and the plain "
          f"forward disagree: state {out['state_err']:.3e}, logits "
          f"{out['plain_logits_err']:.3e} (a row not installed "
          f"{out['state_ctrl']:.3e} / {out['plain_logits_ctrl']:.3e}; "
          f"tolerance {BF16_MODEL_TOL}; against the plain forward from the "
          f"state before the install {out['state_stale']:.3e} / "
          f"{out['plain_logits_stale']:.3e})")
    times = []
    for _ in range(INSTALL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.load_row_state(row, file_state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["install_ms"] = sorted(times)[len(times) // 2]
    out["install_mb"] = sum(v.nbytes for v in file_state.values()) / 1e6
    out["replay_ms"] = replay_turns({"base": base_engine, "lora": eng})
    del eng
    return out


async def admin(http, base, auth, method: str, route: str,
                body=None) -> dict:
    """One admin request with the JWT; fails unless it answers 200 (a
    ``.st`` reload quantizing on the host takes up to ~30 s)."""
    import aiohttp

    async with http.request(method, f"{base}{route}", headers=auth,
                            json=body,
                            timeout=aiohttp.ClientTimeout(total=600)) as r:
        check(r.status == 200, f"{route} answered {r.status}: "
              f"{(await r.text())[:300]}")
        return await r.json()


async def prefab_flow(http, base, server, tmp: Path, kind: str,
                      st_load_s: float, auth: dict) -> dict:
    """``/admin/models/save`` of the served quantized model to a
    ``.prefab`` (a name: the route puts it in the model directory), then
    ``/admin/models/unload`` and ``/admin/models/load`` in turns from its
    ``.st`` and from the prefab, each from the same state (unloaded,
    collected), all with the JWT ``auth``: the device memory the two loads
    allocate agrees within 1 MB, and the prefab's greedy completion
    repeats the one taken before the save token for token (launch counts
    zeroed before it and read after).  Returns the prefab's size, the save
    seconds and both loads' seconds and bytes."""
    import torch

    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.quant_matmul import matmul_int8

    prompt = "prefab check: " + PROMPT
    before = await greedy_text(http, base, prompt)
    name = f"rwkv7-0.4b-{kind}.prefab"
    t0 = time.monotonic()
    saved = await admin(http, base, auth, "POST", "/admin/models/save",
                        {"path": name})
    path = Path(saved["path"])
    check(path == tmp / name, f"/admin/models/save wrote {path}, not into "
          f"the model directory {tmp}")
    out = {"save_s": time.monotonic() - t0, "bytes": path.stat().st_size,
           "st_load_s": st_load_s}
    # No prewarm in the reloads: its work would land in the memory reading.
    st_body = {**server.middleware.env.reload.to_json(), "prewarm": False}
    for which, body in (("st", st_body),
                        ("prefab", {**st_body, "model_path": name})):
        await admin(http, base, auth, "GET", "/admin/models/unload")
        check(server.middleware.env is None,
              "/admin/models/unload left the model loaded")
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        await admin(http, base, auth, "POST", "/admin/models/load", body)
        out[f"{which}_reload_s"] = time.monotonic() - t0
        out[f"{which}_memory_bytes"] = torch.cuda.memory_allocated() - mem0
        check(server.middleware.env.reload.model_path.endswith(
            name if which == "prefab" else "rwkv7-0.4b.st"),
            f"/admin/models/load served "
            f"{server.middleware.env.reload.model_path}")
        check(server.middleware.env.prewarm_future is None,
              "a reload body with prewarm = false started a prewarm")
    check(abs(out["prefab_memory_bytes"] - out["st_memory_bytes"]) <= 1e6,
          f"the {kind} prefab's load allocated {out['prefab_memory_bytes']} "
          f"bytes, the .st load's {out['st_memory_bytes']}")
    attr = "int8_launches" if kind == "int8" else "q4_launches"
    counted = {"matmul_int8": (matmul_int8, "launches"),
               f"v7_skinny_matmul ({attr})": (fd.v7_skinny_matmul, attr),
               **{k.__name__: (k, "launches") for k in fd.KERNELS}}
    for k, a in counted.values():
        setattr(k, a, 0)
    after = await greedy_text(http, base, prompt)
    torch.cuda.synchronize()
    out["launches"] = {n: getattr(k, a) for n, (k, a) in counted.items()}
    check(all(n > 0 for n in out["launches"].values()),
          f"the {kind} prefab's requests launched {out['launches']}")
    check(after == before, f"the {kind} prefab answers {after!r}, the "
          f"model before the save {before!r}")
    if name != NF4_PREFAB:  # the nf4 wide model loads that one
        path.unlink()
    return out


def replay_kernels(graph, toks, ones, n: int = 5):
    """Per replay, the sum of the device times of its kernels and the time
    the device was busy with any of them (the union of their intervals),
    from torch.profiler over ``n`` replays; (None, None) where the profiler
    saw no CUDA events.  Kernels that overlap (programmatic dependent
    launches kept by the capture) make the sum exceed the busy time; gaps
    between launches make the replay exceed it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph.replay(toks, ones)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, None
    total = sum(b - a for a, b in spans)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return total / n / 1e3, busy / n / 1e3


def time_replay(fd, params, state, graph, B: int, key=None) -> dict:
    """One decode step of a loaded stack, every row active: its CUDA graph
    replayed (device time between CUDA events), the same stack launched
    eagerly from Python and composed of the plain versions (host clock
    around a synchronise), and the least time the card could take for the
    bytes the stack must move.  ``fd``: the stack's module; ``key``: its
    layout's (the fused module's ``FUSED_KEY``, which the phased stacks
    read).  Leaves ``state`` advanced."""
    import torch

    dev = state[next(iter(state))].device
    layout = params[key or fd.FUSED_KEY]
    toks = torch.arange(1, B + 1, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    graph.replay(toks, ones)
    torch.cuda.synchronize()
    n = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay(toks, ones)
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / n
    state = {k: t.clone() for k, t in state.items()}

    def host_ms(fwd, reps):
        fwd(params, state, toks[:, None], ones)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            fwd(params, state, toks[:, None], ones)
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / reps * 1e3

    launch_sum_ms, busy_ms = replay_kernels(graph, toks, ones)
    eager_ms = host_ms(fd.forward_t1, 5)
    plain_ms = host_ms(fd.forward_t1_plain, 2)
    weights = [t for v in layout.values()
               for t in (v if isinstance(v, list) else [v])]
    n_bytes = (nbytes(*weights) + 2 * nbytes(*state.values())
               + 2 * B * params["emb"].shape[1] * 2)
    flops = 2 * B * sum(t.numel() for k, v in layout.items()
                        if isinstance(v, list) and not k.endswith("_s")
                        for t in v)
    b_ms, b_by = bound(n_bytes, flops, BF16_FLOPS)
    return {"replay_ms": replay_ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "launch_sum_ms": launch_sum_ms, "busy_ms": busy_ms,
            "bytes": n_bytes, "kernels_per_replay": sum(
                graph.launches_per_replay)}


def overlap_text(st) -> str:
    if st["launch_sum_ms"] is None:
        return "launch device times not measured (no CUDA profiler events)"
    return (f"its launches' device times sum to {st['launch_sum_ms']:.5f} "
            f"ms, the device busy {st['busy_ms']:.5f} ms of the replay "
            "(torch.profiler)")


def time_stack(engine) -> dict:
    """:func:`time_replay` of the engine's own graph over its state pool.
    Runs after the requests, on the idle engine, and leaves its rows'
    states advanced."""
    from ai00_server_tpu_torch.ops import fused_decode

    version = engine.info.version.value
    stack = fused_decode.stack_for(version, engine.model.params,
                                   engine.max_batch)
    with engine._lock:
        check(engine._graph is not None,
              "the engine captured no decode graph")
        return time_replay(stack, engine.model.params, engine.state_pool,
                           engine._graph, engine.max_batch,
                           fused_decode.module_for(version).FUSED_KEY)


def quantized_params(params, version: str, mode: str) -> dict:
    """A copy of ``params`` with the big projections of every layer
    quantized in ``mode`` on the card (one stacked group, as the loader
    builds it from a checkpoint) and the fused layout installed."""
    import torch

    from ai00_server_tpu_torch.ops import fused_decode, quant

    fd = fused_decode.module_for(version)
    layers = [{**p, "att": dict(p["att"]), "ffn": dict(p["ffn"])}
              for p in params["layers"]]
    for part, keys in (("att", quant.QUANT_KEYS_ATT),
                       ("ffn", quant.QUANT_KEYS_FFN)):
        for key in keys:
            if key not in layers[0][part]:
                continue
            qlin = quant.QUANTIZERS[mode](torch.stack(
                [p[part][key] for p in params["layers"]]))
            for i, p in enumerate(layers):
                p[part][key] = quant.QuantizedLayerView(qlin, i)
    qparams = {k: v for k, v in params.items()
               if k not in (fd.FUSED_KEY, "layers")}
    qparams["layers"] = layers
    check(fd.can_fuse(qparams), f"the {mode} stack cannot fuse")
    qparams[fd.FUSED_KEY] = fd.make_fused_layout(qparams)
    return qparams


def time_quant_stack(engine, mode: str) -> dict:
    """The engine's model quantized in ``mode`` on the card
    (:func:`quantized_params`) and a graph of its fused stack over a copy
    of the state pool: :func:`time_replay`.  The codes are dropped
    after."""
    import torch

    from ai00_server_tpu_torch.ops import fused_decode

    fd = fused_decode.module_for(engine.info.version.value)
    qparams = quantized_params(engine.model.params,
                               engine.info.version.value, mode)
    state = {k: t.clone() for k, t in engine.state_pool.items()}
    B = engine.max_batch
    with engine._lock:
        out = time_replay(fd, qparams, state, fd.DecodeGraph(qparams, state,
                                                             B), B)
    del qparams, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_wide_stacks(params, version: str, pool) -> dict:
    """The phased stack and, beside it, the fused one (8-row products: every
    weight read again for each 8 rows) of a model with its fused layout,
    each captured in its own graph over a copy of the first B rows of
    ``pool`` and timed by :func:`time_replay`, at B = 16 and 64.  Keys
    ``"phased B=16"`` ... ``"fused B=64"``."""
    import torch

    from ai00_server_tpu_torch.ops import fused_decode

    fd = fused_decode.module_for(version)
    out = {}
    for B in PHASED_BS:
        pd = fused_decode.stack_for(version, params, B)
        check(pd is not fd and pd is not None,
              f"no phased stack for the {version} model at B={B}")
        for name, stack in (("phased", pd), ("fused", fd)):
            state = {k: t[:, :B].clone() for k, t in pool.items()}
            out[f"{name} B={B}"] = time_replay(
                stack, params, state, stack.DecodeGraph(params, state, B), B,
                fd.FUSED_KEY)
            del state
            gc.collect()
            torch.cuda.empty_cache()
    return out


def wide_v7_params(dev):
    """The RWKV-7 2.9B shape at ``L29`` layers in bf16 on the
    card, with its fused layout: one layer of random fan-in-scaled weights
    from the seed (vocabulary ``PHASED_VOCAB``: no T=1 stack reads it) whose
    six big projections are drawn anew on the card for every layer.
    Returns (info, params)."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.loader import stack_params
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.testing import make_raw_weights

    one = phased_info("v7", "2.9B", 1)
    params = stack_params(one, fan_in_scaled(make_raw_weights(
        one, seed=SEED + 10, dtype=np.float32, lora_dims=LORA29)),
        dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    base = params["layers"][0]
    layers = []
    for _ in range(L29):
        layer = {**base, "att": dict(base["att"]), "ffn": dict(base["ffn"])}
        for part, key in fd._BIG_SRC.values():
            K, Nout = layer[part][key].shape
            layer[part][key] = (torch.randn(K, Nout, generator=gen,
                                            device=dev)
                                / K ** 0.5).to(torch.bfloat16)
        layers.append(layer)
    params["layers"] = layers
    params[fd.FUSED_KEY] = fd.make_fused_layout(params)
    return phased_info("v7", "2.9B", L29), params


def phase_wide_stacks(dev) -> dict:
    """The 2.9B v7 stacks (``L29`` layers) on the card, bf16, int8 and nf4
    (codes quantized on the card), phased beside fused at B = 16 and 64
    (:func:`time_wide_stacks` over a fresh state pool of 64 rows)."""
    import torch

    from ai00_server_tpu_torch.models import v7

    info, params = wide_v7_params(dev)
    pool = v7.init_state(info, WIDE_BATCH, device=dev)
    out = {"bf16": time_wide_stacks(params, "V7", pool)}
    for mode in ("int8", "nf4"):
        qparams = quantized_params(params, "V7", mode)
        out[mode] = time_wide_stacks(qparams, "V7", pool)
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    del params, pool
    gc.collect()
    torch.cuda.empty_cache()
    return out


def print_wide(label: str, stacks: dict) -> None:
    for name, st in stacks.items():
        print(f"forward_t1 {label}, {name} (all rows active): "
              f"{st['replay_ms']:.5f} ms per graph replay "
              f"({st['kernels_per_replay']} kernels; "
              f"{st['bytes'] / st['replay_ms'] / 1e6:.0f} GB/s), "
              f"{st['eager_ms']:.3f} ms launched eagerly, "
              f"{st['plain_ms']:.3f} ms as plain versions; bound "
              f"{st['bound_ms']:.5f} ms by {st['bound_by']} "
              f"({st['bytes'] / 1e6:.1f} MB)", flush=True)


# The mesh phase (mesh_flow): logical (dp, tp) meshes whose places are all
# the one card, so every sharded code path runs on it: per-rank decode
# graphs at max_batch / dp rows, the tp layer path on H / tp heads with its
# partial sums added, the vocab slices of the head gathered.
MESHES = ((2, 1), (1, 2), (2, 2))
MESH_TOKENS = 16   # greedy tokens of the parity chunk and each completion
# The v7 [2, 2] server's depth: the first 6 of the 24-layer checkpoint's
# layers (12 until the head-size phase came), which leaves the time limit
# room for the RWKV-6 / -5 / -4 tp cases, the v6 [2, 2] server and the
# head-size phase.
MESH_SERVE_LAYERS = L_FULL // 4
MESH_CHUNK = 64    # the parity prefill's token_chunk_size
MESH_LENGTHS = (64, 40, 17, 1, 64, 33, 8, 50)  # the parity prompts' tokens


def mesh_prefill_and_chunk(engine, prompts):
    """Every row fresh and greedy, one prefill step, a MESH_TOKENS-token
    decode_chunk, then restore_last_chunk (back to the state after the
    prefill).  Returns (prefill tokens, prefill logits, chunk tokens)."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.ops import sampling

    B = engine.max_batch
    toks = np.zeros((B, MESH_CHUNK), np.int32)
    lens = np.zeros(B, np.int32)
    for b, p in enumerate(prompts):
        engine.load_row_state(b, None)
        # No penalties: each pick is the argmax of the raw logits.
        engine.set_row_sampler(b, {"kind": sampling.KIND_GREEDY,
                                   "presence": 0.0, "frequency": 0.0})
        toks[b, :len(p)], lens[b] = p, len(p)
    res = engine.step(toks, lens, np.ones(B, np.bool_), want_logits=True)
    seq, _ = engine.decode_chunk(res.tokens, np.ones(B, np.bool_),
                                 MESH_TOKENS)
    engine.restore_last_chunk()
    torch.cuda.synchronize()
    return res.tokens, res.logits.float().cpu(), seq


def mesh_forced(engine, first, seq):
    """``first`` then ``seq[:-1]`` fed one T=1 step at a time from the state
    after the prefill: each step's (B, V) logits, stacked."""
    import numpy as np
    import torch

    B = engine.max_batch
    out = []
    for t in [first, *seq[:-1]]:
        r = engine.step(np.asarray(t, np.int32)[:, None],
                        np.ones(B, np.int32), np.ones(B, np.bool_),
                        want_logits=True)
        out.append(r.logits.float().cpu())
    return torch.stack(out)


# RWKV-6 / -5 / -4 at tp > 1 (their parity models: v6 at the 1B6 width, v5
# and v4 at the 0.4B width, 2 layers): every weight mode on [2, 2], bf16
# and int8 on [1, 2] as well.
FAMILY_MESHES = {"bf16": ((1, 2), (2, 2)), "int8": ((1, 2), (2, 2)),
                 "nf4": ((2, 2),)}
# The layer path's WKV kernels of each version.
TP_WKV = {"v7": ("wkv7_t1", "wkv7_chunk"), "v6": ("wkv56_t1", "wkv56_chunk"),
          "v5": ("wkv56_t1", "wkv56_chunk"), "v4": ("wkv4_chunk",)}


def mesh_cases(version: str, max_places: int = 4) -> dict:
    """{weight mode: the meshes of ``phase_mesh_parity``} for a version,
    those of at most ``max_places`` places."""
    cases = ({mode: MESHES for mode in ("bf16", "int8", "nf4")}
             if version == "v7" else FAMILY_MESHES)
    return {mode: [m for m in ms if m[0] * m[1] <= max_places]
            for mode, ms in cases.items()}


def phase_mesh_parity(dev, places=None, version: str = "v7",
                      max_places: int = 4) -> dict:
    """The 2-layer parity model of ``version`` (v7 and v5 / v4 at the 0.4B
    width, v6 at the 1B6 width; bf16, all-int8 and all-nf4) on each mesh of
    ``mesh_cases`` at max_batch = MAX_BATCH against the unsharded engine on
    the same card: the prefill step's logits, and each step of the
    reference's greedy chunk fed to both (teacher-forced logits), held to
    BF16_MODEL_TOL; each engine's own chunk tokens are its own greedy picks
    on those logits, so two chunks part only at a near tie.  ``places``:
    the devices of the places (default: the one card, repeated).  Checks
    each dp rank's own decode graph at B / dp rows (v7), the tp layer
    path's WKV kernels on H / tp heads (v4: C / tp channels), and the
    kernels each run launched."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.engine import Engine
    from ai00_server_tpu_torch.loader import LoadedModel, stack_params
    from ai00_server_tpu_torch.models import get_version_module
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.ops import v7_decode as v7d
    from ai00_server_tpu_torch.ops.ffn import ffn7_t1_l
    from ai00_server_tpu_torch.ops.quant import QuantizedRows
    from ai00_server_tpu_torch.ops.quant_matmul import (matmul_4bit_l,
                                                        matmul_int8,
                                                        matmul_int8_l)
    from ai00_server_tpu_torch.ops.wkv4 import wkv4_chunk
    from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk, wkv56_chunk
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1, wkv56_t1
    from ai00_server_tpu_torch.parallel import make_mesh

    info = model_info(2, version)
    module = get_version_module(info.version)
    fd = fused_decode.module_for(info.version.value)
    math = parity_math(version)
    rng = np.random.default_rng(SEED + 19)
    prompts = [rng.integers(1, VOCAB, n).tolist() for n in MESH_LENGTHS]
    wkv_names = TP_WKV[version]
    kernels = {"wkv7_t1": wkv7_t1, "wkv7_chunk": wkv7_chunk,
               "wkv56_t1": wkv56_t1, "wkv56_chunk": wkv56_chunk,
               "wkv4_chunk": wkv4_chunk}
    counted = {"matmul_int8": (matmul_int8, "launches"),
               "matmul_int8_l": (matmul_int8_l, "launches"),
               "matmul_4bit_l": (matmul_4bit_l, "launches"),
               **{name: (kernels[name], "launches") for name in wkv_names},
               **{k.__name__: (k, "launches") for k in fd.KERNELS}}
    if version == "v7":
        counted.update({
            "ffn7_t1_l": (ffn7_t1_l, "launches"),
            "v7_skinny_matmul (int8)": (v7d.v7_skinny_matmul,
                                        "int8_launches"),
            "v7_skinny_matmul (4-bit)": (v7d.v7_skinny_matmul,
                                         "q4_launches")})
    heads = {name: set() for name in wkv_names}

    def heads_of(name):
        def call(*args):
            # v4: aa (B, C / tp); v5-v7: r (B, [T,] H / tp, N).
            heads[name].add(int(args[0].shape[-1] if name == "wkv4_chunk"
                                else args[1].shape[-2]))
            return kernels[name](*args)
        return call

    tag = "" if version == "v7" else f"{version} "
    result = {}
    for name in wkv_names:
        setattr(module, name, heads_of(name))
    try:
        for mode, meshes in mesh_cases(version, max_places).items():
            quant_map = None if mode == "bf16" else {0: mode, 1: mode}
            t0 = time.monotonic()
            params = params_to(stack_params(info, math, torch.bfloat16, "cpu",
                                            quant=quant_map), dev)
            four = mode == "nf4"
            by_layer = "matmul_4bit_l" if four else "matmul_int8_l"
            stack = f"v7_skinny_matmul ({'4-bit' if four else 'int8'})"

            def engine(mesh):
                return Engine(LoadedModel(info=info, params=params),
                              max_batch=MAX_BATCH,
                              token_chunk_size=MESH_CHUNK, device=dev,
                              mesh=mesh)

            # The references: the unsharded engine as it serves (T = 1
            # through the fused stack's graph), held to the dp meshes, and
            # the same engine with its fused layout taken out, on the layer
            # path at T = 1 like the tp shards (the fused stack keeps the
            # residual in f32, the layer path rounds it to bf16 each layer).
            ref = engine(None)
            layer = Engine(LoadedModel(info=info, params={
                k: v for k, v in params.items() if k != fd.FUSED_KEY}),
                max_batch=MAX_BATCH, token_chunk_size=MESH_CHUNK,
                device=dev)
            layer.model.params.pop(fd.FUSED_KEY)
            layer._graph = layer.stack = None
            refs = {}
            paths = ({"fused": ref} if any(tp == 1 for _, tp in meshes)
                     else {}) | {"layer": layer}
            for path, eng in paths.items():
                r_first, r_logits, r_seq = mesh_prefill_and_chunk(eng,
                                                                  prompts)
                r_forced = mesh_forced(eng, r_first, r_seq)
                check(torch.equal(r_forced.argmax(-1), torch.as_tensor(
                    r_seq).long()), f"{tag}{mode}: the unsharded {path} "
                    "path's chunk tokens are not its own greedy picks")
                refs[path] = (r_first, r_logits, r_seq, r_forced)
            if version == "v7":  # a reading: the layer path, fused tokens
                f_first, _, f_seq, f_forced = refs["fused"]
                mesh_prefill_and_chunk(layer, prompts)
                paths_err = float((mesh_forced(layer, f_first, f_seq)
                                   - f_forced).abs().max()) / float(
                    f_forced.abs().max())
                result[f"{mode} layer vs fused"] = paths_err
                print(f"mesh parity {mode}: the unsharded engine's layer path "
                      f"against its fused path on the same tokens, "
                      f"{MESH_TOKENS} steps: {paths_err:.3e} of max |fused| "
                      "(a reading)", flush=True)
            del layer
            for dp, tp in meshes:
                r_first, r_logits, r_seq, r_forced = refs[
                    "fused" if tp == 1 else "layer"]
                scale = float(r_forced.abs().max())
                label = f"{tag}{mode} [{dp}, {tp}]"
                n = dp * tp
                mesh = make_mesh(dp=dp, tp=tp, devices=(
                    [dev] * n if places is None else places[:n]))
                for k, attr in counted.values():
                    setattr(k, attr, 0)
                for seen in heads.values():
                    seen.clear()
                replays0 = fd.DecodeGraph.total_replays
                eng = engine(mesh)
                first, logits, seq = mesh_prefill_and_chunk(eng, prompts)
                forced = mesh_forced(eng, r_first, r_seq)
                launches = {k: getattr(f, a) for k, (f, a) in counted.items()}
                replays = fd.DecodeGraph.total_replays - replays0
                for what, a in (("prefill", logits), ("forced", forced)):
                    check(bool(torch.isfinite(a).all()),
                          f"{label}: non-finite {what} logits")
                err_pre = float((logits - r_logits).abs().max()) / float(
                    r_logits.abs().max())
                err = float((forced - r_forced).abs().max()) / scale
                check(max(err_pre, err) <= BF16_MODEL_TOL,
                      f"{label}: logits {err_pre:.3e} / {err:.3e} from the "
                      f"unsharded engine's {'fused' if tp == 1 else 'layer'}"
                      f" path (limit {BF16_MODEL_TOL})")
                check(np.array_equal(first, logits.argmax(-1).numpy()),
                      f"{label}: the prefill's tokens are not its greedy "
                      "picks")
                seq_t = torch.as_tensor(seq).long()
                own = forced.argmax(-1)
                same = torch.as_tensor(seq == r_seq)
                for b in range(MAX_BATCH):
                    # Up to the first token where the chunks part, the
                    # inputs are the reference's: the picks must be its own.
                    k = int(same[:, b].long().cumprod(0).sum())
                    upto = min(k + 1, MESH_TOKENS)
                    check(torch.equal(seq_t[:upto, b], own[:upto, b]),
                          f"{label}: row {b}'s chunk is not its greedy "
                          "walk")
                if tp == 1:
                    graphs = [s._graph for s in eng.shards]
                    check(all(g is not None
                              and g.tokens.shape[0] == MAX_BATCH // dp
                              for g in graphs)
                          and len({id(g) for g in graphs}) == dp,
                          f"{label}: not one decode graph a rank at "
                          f"{MAX_BATCH // dp} rows")
                    check(replays == dp * 2 * MESH_TOKENS,
                          f"{label}: {replays} graph replays, want "
                          f"{dp * 2 * MESH_TOKENS}")
                    want = [k.__name__ for k in fd.KERNELS]
                else:
                    H = info.num_head // tp  # v4: num_head = C
                    check(heads == {name: {H} for name in wkv_names},
                          f"{label}: the WKV kernels ran at heads {heads}, "
                          f"want {H}")
                    check(replays == 0, f"{label}: {replays} graph replays")
                    want = list(wkv_names)
                    if quant_map:
                        want += [by_layer] + (["ffn7_t1_l"]
                                              if version == "v7" else [])
                        # The in-split products: codes sliced on whole
                        # scale blocks, or kept whole as QuantizedRows.
                        part = eng.shards[0].part_params[-1]["layers"][0]
                        in_split = {
                            f"{p_}.{k_}": ("rows of the whole codes"
                                           if isinstance(part[p_][k_],
                                                         QuantizedRows)
                                           else "sliced codes "
                                           f"{tuple(part[p_][k_].shape)}")
                            for p_, k_ in (("att", "output"),
                                           ("ffn", "value"))}
                        print(f"{label}: the in-split products of a place: "
                              f"{in_split}", flush=True)
                if quant_map:  # the int8 head; the stack in its mode
                    want += ["matmul_int8"] + ([stack] if tp == 1 else [])
                for k in want:
                    check(launches[k] > 0, f"{label}: {k} never launched")
                bit_equal = (torch.equal(logits, r_logits)
                             and torch.equal(forced, r_forced)
                             and bool(same.all()))
                result[label] = {
                    "prefill_err": err_pre, "forced_err": err,
                    "tokens_equal": int(same.sum()),
                    "bit_equal": bit_equal, "replays": replays,
                    "launches": {k: launches[k] for k in want},
                    "heads": sorted(heads[wkv_names[0]])}
                print(f"mesh parity {label} (places {mesh}): against the "
                      f"unsharded {'fused' if tp == 1 else 'layer'} path, "
                      f"prefill logits {err_pre:.3e}, teacher-forced logits "
                      f"over {MESH_TOKENS} steps {err:.3e} of max "
                      f"|unsharded| (limit {BF16_MODEL_TOL}); chunk tokens "
                      "equal "
                      f"{int(same.sum())} / {same.numel()}; bit-equal "
                      f"{bit_equal}; {replays} graph replays; WKV at "
                      f"{'channels' if version == 'v4' else 'heads'} "
                      f"{sorted(heads[wkv_names[0]]) or '-'}; launches "
                      f"{result[label]['launches']}", flush=True)
                del eng
            print(f"mesh parity {tag}{mode}: {time.monotonic() - t0:.1f} s",
                  flush=True)
            del ref, params
    finally:
        for name in wkv_names:
            setattr(module, name, kernels[name])
    return result


async def mesh_serve(cfg: Path, dev, version: str = "v7",
                     layers: int | None = None) -> dict:
    """The checkpoint of ``cfg`` (v7: ``write_site``'s 24-layer bf16 one,
    v6: ``write_site_family``'s 1B6 one at L6 layers), its first ``layers``
    layers (default: all), served through the
    port's Runtime and Server on an Engine built with a [2, 2] mesh of
    places on the one card: four concurrent greedy completions of
    MESH_TOKENS tokens (the WKV kernels' counts zeroed before and read
    after), one ``/api/oai/states`` read and ``/api/models/info``'s mesh.
    First (v7) the middleware itself must refuse ``mesh = [2, 1]`` on a
    machine of one card."""
    import aiohttp
    import torch
    from aiohttp import web

    from ai00_server_tpu_torch.engine import Engine
    from ai00_server_tpu_torch.loader import load_model
    from ai00_server_tpu_torch.middleware import Environment, Middleware
    from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk, wkv56_chunk
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1, wkv56_t1
    from ai00_server_tpu_torch.parallel import make_mesh
    from ai00_server_tpu_torch.runtime import Runtime
    from ai00_server_tpu_torch.server.app import Server
    from ai00_server_tpu_torch.server.config import Config
    from ai00_server_tpu_torch.tokenizer import Tokenizer

    counted = ((wkv7_t1, wkv7_chunk) if version == "v7"
               else (wkv56_t1, wkv56_chunk))
    config = Config.from_toml(str(cfg))
    req = config.to_reload_request()
    server = Server(config, device=dev)
    n_cards = torch.cuda.device_count()
    if version == "v7":
        try:
            await server.middleware.reload(dataclasses.replace(req,
                                                               mesh=[2, 1]))
            refusal = None
        except ValueError as e:
            refusal = str(e)
        check(n_cards >= 2
              or refusal == "mesh [2, 1] needs 2 devices, have 1",
              f"the middleware's answer to mesh = [2, 1] on {n_cards} "
              f"card(s): {refusal!r}")
        check(server.middleware.env is None, "a refused mesh left a model")

    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    model = load_model(req.model_path, dtype=torch.bfloat16, device=dev)
    if layers is not None and layers < model.info.num_layer:
        model = dataclasses.replace(
            model, info=dataclasses.replace(model.info, num_layer=layers),
            params={**model.params,
                    "layers": model.params["layers"][:layers]})
    mesh = make_mesh(dp=2, tp=2, devices=[dev] * 4)
    engine = Engine(model, max_batch=MAX_BATCH, token_chunk_size=CHUNK,
                    device=dev, mesh=mesh)
    tokenizer = Tokenizer.from_file(req.tokenizer_path)
    request = dataclasses.replace(req, mesh=[2, 2])
    entries, states = Middleware._load_states(request, model)
    # Chunks of 4 steps (16 with no request waiting, the runtime's 4x):
    # the completions' 16 tokens, where the default 16 (64) would run
    # three idle quarters of each chunk on the host-bound layer path.
    runtime = Runtime(engine, tokenizer, states=states, decode_chunk_size=4)
    runtime.start()
    server.middleware.env = Environment(
        reload=request, model=model, engine=engine, runtime=runtime,
        tokenizer=tokenizer, states=entries)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    mem = torch.cuda.memory_allocated() - mem0
    runner = web.AppRunner(server.app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"

    async def completion(http, prompt):
        async with http.post(f"{base}/api/oai/completions", json={
                "prompt": prompt, "max_tokens": MESH_TOKENS,
                "sampler": {"type": "Nucleus", "top_k": 1},
                "logit_bias": NO_EOS}) as r:
            check(r.status == 200, f"completions answered {r.status}")
            return await r.json()

    result = {"load_s": load_s, "memory_bytes": mem}
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{base}/api/models/info") as r:
                info = await r.json()
            check(info["mesh"] == {"dp": 2, "tp": 2, "devices": 4},
                  f"/api/models/info's mesh: {info['mesh']}")
            await completion(http, "warm up")
            for k in counted:
                k.launches = 0
            prompts = [PROMPT * 3, PROMPT * 3, PROMPT + "beta",
                       PROMPT + "beta"]
            t0 = time.monotonic()
            outs = await asyncio.gather(*[completion(http, p)
                                          for p in prompts])
            wall = time.monotonic() - t0
            result["launches"] = {k.__name__: k.launches for k in counted}
            for name, n in result["launches"].items():
                check(n > 0, f"the {version} [2, 2] server's requests never "
                      f"launched {name}")
            texts = [o["choices"][0]["text"] for o in outs]
            check(all(texts), "a completion on the mesh returned no text")
            check(texts[0] == texts[1] and texts[2] == texts[3],
                  "identical greedy requests on the mesh returned "
                  "different text")
            n_tokens = sum(o["usage"]["completion"] for o in outs)
            check(n_tokens == 4 * MESH_TOKENS,
                  f"{n_tokens} completion tokens on the mesh")
            t0 = time.monotonic()
            async with http.post(f"{base}/api/oai/states",
                                 json={"input": PROMPT}) as r:
                check(r.status == 200, f"/api/oai/states answered "
                      f"{r.status}")
                st = (await r.json())["data"][0]
            values = st["data"]
            check(len(values) > 0 and all(
                v == v and abs(v) != float("inf") for v in values),
                "/api/oai/states on the mesh returned no finite state")
            result.update(
                wall_s=wall, completion_tokens=n_tokens,
                tokens_per_s=n_tokens / wall, sample=texts[0][:60],
                states_s=time.monotonic() - t0, states_shape=st["shape"],
                rows=[s.local_batch if hasattr(s, "local_batch")
                      else s.max_batch for s in engine.shards])
    finally:
        await server.middleware.unload()
        await runner.cleanup()
    return result


def print_mesh_served(version: str, served: dict, layers: int,
                      seconds: float) -> None:
    print(f"mesh serving ({version}, [2, 2] over the card four times, "
          f"{layers} layers bf16, max_batch {MAX_BATCH}, chunk {CHUNK}) on "
          f"{card_line()}: loaded in {served['load_s']:.1f} s, "
          f"{served['memory_bytes'] / 1e6:.1f} MB of device memory "
          f"allocated by the load; 4 concurrent greedy completions of "
          f"{MESH_TOKENS} tokens in {served['wall_s']:.2f} s, "
          f"{served['completion_tokens']} completion tokens -> "
          f"{served['tokens_per_s']:.1f} tokens/s; /api/oai/states "
          f"{served['states_shape']} in {served['states_s']:.3f} s; "
          f"launches {served['launches']}; sample {served['sample']!r}; "
          f"{seconds:.1f} s", flush=True)


def mesh_flow(dev, cfg: Path) -> dict:
    """Parity on logical meshes (v7, then RWKV-6, -5 and -4 at tp > 1), the
    v7 [2, 2] server, and distinct cards where the machine has them."""
    import torch

    t0 = time.monotonic()
    parity = {}
    for version in ("v7", "v6", "v5", "v4"):
        t1 = time.monotonic()
        parity[version] = phase_mesh_parity(dev, version=version)
        print(f"mesh parity {version}: {time.monotonic() - t1:.1f} s",
              flush=True)
    print(f"mesh parity: {time.monotonic() - t0:.1f} s", flush=True)
    t1 = time.monotonic()
    served = asyncio.run(mesh_serve(cfg, dev, layers=MESH_SERVE_LAYERS))
    print_mesh_served("v7", served, MESH_SERVE_LAYERS, time.monotonic() - t1)
    n = torch.cuda.device_count()
    if n >= 2:
        cards = [torch.device("cuda", i) for i in range(n)]
        t1 = time.monotonic()
        distinct = {version: phase_mesh_parity(dev, places=cards,
                                               version=version, max_places=n)
                    for version in ("v7", "v6", "v5", "v4")}
        print(f"mesh parity on {n} distinct cards: "
              f"{time.monotonic() - t1:.1f} s", flush=True)
    else:
        distinct = None
        print(f"mesh on distinct cards: not run: this machine has {n} card "
              "(torch.cuda.device_count()); peer copies between cards need "
              "2 or more", flush=True)
    print(f"mesh_flow {time.monotonic() - t0:.1f} s", flush=True)
    return {"parity": parity, "served": served, "distinct": distinct}


# Prewarm (prewarm_pools, in the bf16 serve): the pools a prewarm must leave
# as they were.  Every served model but the mixed ones prewarms at load.
PREWARM_K = 16           # prewarm's decode_chunk_size: the served configs'


def engine_pools(eng) -> dict:
    """Every pool, host flag and the snapshot ring of ``eng``, cloned."""
    import numpy as np
    import torch

    def clone(tree):
        if isinstance(tree, torch.Tensor):
            return tree.clone()
        if isinstance(tree, np.ndarray):
            return tree.copy()
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [clone(v) for v in tree]
        return tree

    return clone({
        "state": eng.state_pool, "sampler": eng.sampler_state,
        "bias": eng.bias_pool, "mask": eng.mask_pool,
        "dfa_pool": eng.dfa_pool, "dfa_state": eng.dfa_state,
        "hsum": eng.hsum_pool, "bias_active": eng.bias_active,
        "mask_active": eng.mask_active, "dfa_rows": eng.dfa_rows,
        "hsum_rows": eng.hsum_rows, "ring": eng._chunk_snaps})


def moved(got, want, where: str = "") -> list[str]:
    """The leaves of two :func:`engine_pools` trees that are not
    bit-equal."""
    import numpy as np
    import torch

    if isinstance(want, torch.Tensor):
        same = got.dtype == want.dtype and torch.equal(got, want)
        return [] if same else [where]
    if isinstance(want, np.ndarray):
        return [] if np.array_equal(got, want) else [where]
    if isinstance(want, dict):
        return [m for k in want for m in moved(got[k], want[k],
                                               f"{where}.{k}")]
    if isinstance(want, list):
        if len(got) != len(want):
            return [f"{where} (length {len(got)}, was {len(want)})"]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in moved(g, w, f"{where}[{i}]")]
    return [] if got == want else [where]


def prewarm_pools(model, dev) -> dict:
    """A fresh engine (``max_batch`` 8, its own decode graph) on the served
    bf16 model: random states in every row (row 1 with its hidden sums
    tracked), nucleus samplers with penalties, a bias, a mask and a token
    DFA, a ragged prefill and one 4-token decode chunk.  Then
    ``decode_chunk(snapshot=False)`` with no active row and
    ``Engine.prewarm(PREWARM_K)``: each must leave every pool, host flag
    and the snapshot ring bit-equal, while the prewarm launches the live
    path (two prefill chunks through ``wkv7_chunk``, 2 + 5 x PREWARM_K
    graph replays); then ``restore_last_chunk`` must bring back the
    pre-chunk state, sampler state and DFA state.  Returns the prewarm's
    seconds on this warm process and its launches."""
    import numpy as np
    import torch

    from ai00_server_tpu_torch.engine import Engine
    from ai00_server_tpu_torch.ops import sampling
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk

    eng = Engine(model, max_batch=MAX_BATCH, token_chunk_size=CHUNK,
                 device=dev)
    check(eng._graph is not None, "the prewarm check's engine has no graph")
    rng = np.random.default_rng(SEED + 21)
    B, V = MAX_BATCH, eng.vocab
    for b in range(B):
        row = {k: (rng.standard_normal(tuple(v.shape)) * 0.5).astype(
                   np.float32) for k, v in eng.fresh_row_state().items()}
        eng.load_row_state(b, row, hidden_sums=(b == 1))
        eng.set_row_sampler(b, {"kind": sampling.KIND_NUCLEUS, "top_p": 0.8,
                                "temperature": 0.9, "presence": 0.5,
                                "frequency": 0.2},
                            prompt_tokens=[1 + b, 5, 7])
    eng.set_row_bias(2, rng.standard_normal(V).astype(np.float32))
    allowed = rng.random(V) < 0.5
    allowed[1:64] = True
    eng.set_row_mask(3, allowed)
    table = np.full((3, V), -1, np.int8)
    table[0, 1:64], table[1, 64:128] = 1, 0
    eng.set_row_dfa(0, table, 0)
    toks = rng.integers(1, V, (B, CHUNK)).astype(np.int32)
    lens = np.array([CHUNK, CHUNK // 6, 0, CHUNK // 15, CHUNK, 3,
                     CHUNK * 2 // 5, 1], np.int32)
    res = eng.step(toks, lens, lens > 0)
    pre = engine_pools(eng)
    eng.decode_chunk(res.tokens, lens > 0, 4)
    after = engine_pools(eng)
    check(len(after["ring"]) == 1, "the decode chunk pushed no snapshot")
    eng.decode_chunk(np.zeros(B, np.int32), np.zeros(B, np.bool_), PREWARM_K,
                     snapshot=False)
    bad = moved(engine_pools(eng), after)
    check(not bad, f"decode_chunk(snapshot=False) moved {bad}")
    wkv7_chunk.launches = 0
    replays0 = fd.DecodeGraph.total_replays
    torch.cuda.synchronize()
    t0 = time.monotonic()
    eng.prewarm(PREWARM_K)
    torch.cuda.synchronize()
    out = {"warm_prewarm_s": time.monotonic() - t0,
           "replays": fd.DecodeGraph.total_replays - replays0,
           "wkv7_chunk": wkv7_chunk.launches}
    bad = moved(engine_pools(eng), after)
    check(not bad, f"Engine.prewarm moved {bad}")
    check(out["replays"] == 2 + 5 * PREWARM_K
          and out["wkv7_chunk"] == 2 * L_FULL,
          f"the prewarm ran {out['replays']} graph replays and "
          f"{out['wkv7_chunk']} wkv7_chunk launches, not {2 + 5 * PREWARM_K}"
          f" and {2 * L_FULL}")
    eng.restore_last_chunk()
    now = engine_pools(eng)
    for key in ("state", "sampler", "dfa_state", "dfa_rows"):
        bad = moved(now[key], pre[key], key)
        check(not bad, f"restore_last_chunk after the prewarm left {bad} "
              "unlike the pre-chunk pools")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


async def stream_chat(http, base: str, content: str, max_tokens: int):
    """One streamed greedy chat: (seconds to the first content event,
    seconds to ``[DONE]``, text)."""
    t0 = time.monotonic()
    ttft, events = None, []
    async with http.post(f"{base}/api/oai/chat/completions", json={
            "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "stream": True,
            "sampler": {"type": "Nucleus", "top_k": 1},
            "logit_bias": NO_EOS}) as r:
        check(r.status == 200, f"chat answered {r.status}")
        async for line in r.content:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            events.append(line[6:])
            if ttft is None and '"content"' in line:
                ttft = time.monotonic() - t0
    check(events and events[-1] == "[DONE]",
          "the SSE stream did not end in data: [DONE]")
    text = "".join(json.loads(e)["choices"][0].get("delta", {})
                   .get("content", "") for e in events[:-1])
    check(bool(text), "the streamed chat returned no text")
    return ttft, time.monotonic() - t0, text


def print_prewarm(pw: dict, card: str) -> None:
    print(f"prewarm check on the bf16 server ({card}; {pw['seconds']:.1f} "
          f"s): Engine.prewarm({PREWARM_K}) on a fresh 8-row engine over the "
          f"served model left every pool, host flag and the snapshot ring "
          f"bit-equal ({pw['replays']} graph replays, {pw['wkv7_chunk']} "
          f"wkv7_chunk launches, {pw['warm_prewarm_s']:.3f} s in this warm "
          "process), so did decode_chunk(snapshot=False), and "
          "restore_last_chunk brought back the pre-chunk pools", flush=True)


async def serve(cfg: Path, kind: str, device="cuda") -> dict:
    """Serve one config over HTTP on localhost.  ``kind``: "bf16", "int8",
    "nf4", "v6 bf16", "v5 bf16" and "v4 bf16" get the burst (4 greedy
    completions of 128 tokens + 1 streamed chat), a lone streamed chat and
    the time of one replay of the stack and ``/api/metrics`` after the
    burst, "bf16" also one request traced through ``/admin/profile``, "v6
    bf16" also the time of its stack quantized int8 and nf4 on the card;
    the mixed kinds get one short greedy completion, twice.  The launch
    counts are zeroed just before the burst (the completions) and read just
    after.  A config whose listener wants a JWT (``write_site``'s) gets one
    from ``/api/auth/exchange`` after an admin request without one answers
    401."""
    import aiohttp
    import torch
    from aiohttp import web

    from ai00_server_tpu_torch.ops import fused_decode, v7_phased, v56_phased
    from ai00_server_tpu_torch.ops import v7_decode as fd
    from ai00_server_tpu_torch.ops.ffn import ffn7_t1_l
    from ai00_server_tpu_torch.ops.phased_matmul import phased_matmul
    from ai00_server_tpu_torch.ops.quant_matmul import (matmul_4bit_l,
                                                        matmul_int8,
                                                        matmul_int8_l)
    from ai00_server_tpu_torch.ops.wkv4 import wkv4_chunk
    from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk, wkv56_chunk
    from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1
    from ai00_server_tpu_torch.server.app import Server
    from ai00_server_tpu_torch.server.config import Config

    config = Config.from_toml(str(cfg))
    server = Server(config, device=device)
    gc.collect()  # the model served before this one is gone
    mem0 = torch.cuda.memory_allocated() if device != "cpu" else 0
    t0 = time.monotonic()
    await server.middleware.reload(config.to_reload_request())
    load_s = time.monotonic() - t0
    mem = torch.cuda.memory_allocated() - mem0 if device != "cpu" else 0
    # The load's background prewarm, awaited: none of its launches or
    # device time lands in the readings below.
    prewarm_s = None
    if server.middleware.env.prewarm_future is not None:
        t0 = time.monotonic()
        await server.middleware.env.prewarm_future
        prewarm_s = time.monotonic() - t0
    runner = web.AppRunner(server.app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    port = runner.addresses[0][1]
    base = f"http://127.0.0.1:{port}"
    print(f"{kind} model (quant = {ALL_SERVED[kind][0]}, quant_type = "
          f"{ALL_SERVED[kind][1]}) loaded in {load_s:.1f} s, "
          f"{mem / 1e6:.1f} MB of device memory allocated by the load "
          f"(weights, state pool, sampler pools, graph); prewarm "
          f"{'off' if prewarm_s is None else f'{prewarm_s:.3f} s'}; "
          f"serving on {base}", flush=True)

    async def completion(http, prompt, max_tokens):
        async with http.post(f"{base}/api/oai/completions", json={
                "prompt": prompt, "max_tokens": max_tokens,
                "sampler": {"type": "Nucleus", "top_k": 1},
                "logit_bias": NO_EOS}) as r:
            check(r.status == 200, f"completions answered {r.status}")
            return await r.json()

    mixed = kind.startswith("mixed")
    wide = kind.endswith("wide")
    counted = {"wkv7_chunk": (wkv7_chunk, "launches")}
    family = kind.split()[0] if kind[:2] in ("v6", "v5", "v4") else None
    version = (family or "v7").upper()
    if family:
        chunk = wkv4_chunk if family == "v4" else wkv56_chunk
        counted = {chunk.__name__: (chunk, "launches")}
    if wide:
        # The phased stack's kernels, and v7_skinny_matmul apart: a wide
        # step must run none of its 8-row launches.
        stack = v56_phased if family else v7_phased
        counted.update({k.__name__: (k, "launches") for k in stack.KERNELS})
    elif family:
        counted.update({k.__name__: (k, "launches") for k in
                        fused_decode.module_for(version).KERNELS})
    elif mixed:
        by_layer = matmul_int8_l if kind == "mixed" else matmul_4bit_l
        counted.update({k.__name__: (k, "launches") for k in (
            wkv7_t1, by_layer, ffn7_t1_l, matmul_int8)})
    else:
        counted.update({k.__name__: (k, "launches") for k in fd.KERNELS})
    if kind in ("int8", "nf4", "int8 wide", "nf4 wide"):
        counted["matmul_int8"] = (matmul_int8, "launches")
    if kind == "int8 wide":
        counted["phased_matmul (int8)"] = (phased_matmul, "int8_launches")
    if kind == "nf4 wide":
        counted["phased_matmul (nf4)"] = (phased_matmul, "lut4_launches")
    if kind == "int8":
        counted["v7_skinny_matmul (int8)"] = (fd.v7_skinny_matmul,
                                              "int8_launches")
    if kind == "nf4":
        counted["v7_skinny_matmul (4-bit)"] = (fd.v7_skinny_matmul,
                                               "q4_launches")

    def zero_counts():
        for k, attr in counted.values():
            setattr(k, attr, 0)
        fd.v7_skinny_matmul.launches = 0
        return fd.DecodeGraph.total_replays

    def read_counts():
        return {name: getattr(k, attr) for name, (k, attr) in counted.items()}

    result = {"kind": kind, "load_s": load_s, "memory_bytes": mem,
              "prewarm_s": prewarm_s}
    try:
        async with aiohttp.ClientSession() as http:
            await completion(http, "warm up", 8)  # first-call set-up
            auth = (None if config.listen.force_pass
                    else await admin_token(http, base, server))
            engine = server.middleware.env.engine
            if mixed:
                check(engine._graph is None,
                      "a mixed model must not capture a decode graph")
                replays0 = zero_counts()
                t0 = time.monotonic()
                outs = [await completion(http, PROMPT * 4, MIXED_TOKENS)
                        for _ in range(2)]
                wall = time.monotonic() - t0
                result.update(
                    launches=read_counts(),
                    burst_replays=fd.DecodeGraph.total_replays - replays0,
                    skinny_launches=fd.v7_skinny_matmul.launches)
                texts = [o["choices"][0]["text"] for o in outs]
                check(all(texts), "a completion returned no text")
                check(texts[0] == texts[1],
                      "identical greedy requests returned different text")
                n_tokens = sum(o["usage"]["completion"] for o in outs)
                result.update(wall_s=wall, completion_tokens=n_tokens,
                              tokens_per_s=n_tokens / wall,
                              sample=texts[0][:60])
                return result

            if wide:
                check(isinstance(engine._graph, stack.DecodeGraph),
                      f"the {kind} engine did not capture the phased stack")
                # WIDE_BATCH completions, every two alike, of 2 to 13
                # prompt repeats; the streamed chat waits for a free row.
                prompts = [PROMPT * (2 + (i // 2) % 12) + f"request {i // 2}"
                           for i in range(WIDE_BATCH)]
                max_tokens = WIDE_TOKENS
            else:
                prompts = [PROMPT * 20, PROMPT * 20, PROMPT * 11 + "alpha",
                           PROMPT * 11 + "alpha"]
                max_tokens = 128
            replays0 = zero_counts()
            t0 = time.monotonic()
            *outs, (ttft_load, _, _chat) = await asyncio.gather(
                *[completion(http, p, max_tokens) for p in prompts],
                stream_chat(http, base, PROMPT * 8, 64))
            wall = time.monotonic() - t0
            result.update(
                launches=read_counts(),
                burst_replays=fd.DecodeGraph.total_replays - replays0,
                skinny_launches=fd.v7_skinny_matmul.launches,
                burst=f"{len(prompts)} greedy completions of {max_tokens} "
                      "tokens + 1 streamed chat")
            # The warm-up, the completions and the chat.
            result["metrics"] = await read_metrics(http, base,
                                                   len(prompts) + 2)
            if wide:
                check(fd.v7_skinny_matmul.launches == 0,
                      f"the {kind} burst ran {fd.v7_skinny_matmul.launches} "
                      "8-row v7_skinny_matmul launches")
            texts = [o["choices"][0]["text"] for o in outs]
            check(all(texts), "a completion returned no text")
            check(all(texts[i] == texts[i + 1]
                      for i in range(0, len(texts), 2)),
                  "identical greedy requests returned different text")
            n_tokens = sum(o["usage"]["completion"] for o in outs)
            ttft_solo, _, _ = await stream_chat(
                http, base, "once more, " + PROMPT * 8, 16)
            result.update(
                wall_s=wall, completion_tokens=n_tokens,
                prompt_tokens=sum(o["usage"]["prompt"] for o in outs),
                tokens_per_s=n_tokens / wall, ttft_s_under_load=ttft_load,
                ttft_s_alone=ttft_solo, sample=texts[0][:60])
            if kind in ("bf16", "int8"):
                result["ttft_s_long"], _, _ = await stream_chat(
                    http, base, LONG_PROMPT, 16)
            if kind == "bf16":
                replays0 = fd.DecodeGraph.total_replays
                t0 = time.monotonic()
                profile = await profiled(
                    http, base, auth, cfg.parent / "profile",
                    completion(http, "and a profiled one: " + PROMPT * 8, 64),
                    {t.native_id for t in
                     server.middleware.env.runtime._device_pool._threads})
                result["profile_s"] = time.monotonic() - t0
                result["profile"] = profile + (
                    f"; {fd.DecodeGraph.total_replays - replays0} graph "
                    "replays for its 64 tokens")
                t0 = time.monotonic()
                result["rag"] = await rag_flow(http, base, server)
                result["rag"]["seconds"] = time.monotonic() - t0
                t0 = time.monotonic()
                result["bnf"] = await bnf_flow(http, base, server)
                result["bnf"]["seconds"] = time.monotonic() - t0
                t0 = time.monotonic()
                env = server.middleware.env
                result["prewarm"] = prewarm_pools(env.model, env.engine.device)
                result["prewarm"]["seconds"] = time.monotonic() - t0
                # Reloads the server with a state and a LoRA: last.
                t0 = time.monotonic()
                result["state"] = await state_flow(http, base, server,
                                                   cfg.parent, engine)
                result["state"]["seconds"] = time.monotonic() - t0
            if kind in ("int8", "nf4"):
                # Reloads the server from its prefab: after its requests.
                t0 = time.monotonic()
                result["prefab"] = await prefab_flow(
                    http, base, server, cfg.parent, kind, load_s, auth)
                result["prefab"]["seconds"] = time.monotonic() - t0
            result["stack"] = time_stack(engine) if device != "cpu" else None
            if wide and device != "cpu":
                with engine._lock:
                    result["wide_stacks"] = time_wide_stacks(
                        engine.model.params, version, engine.state_pool)
            if kind == "v6 bf16" and device != "cpu":
                result["quant_stacks"] = {
                    mode: time_quant_stack(engine, mode)
                    for mode in ("int8", "nf4")}
                # The served model's phased stack beside its fused one at
                # wide batches, over a fresh state pool of WIDE_BATCH rows.
                with engine._lock:
                    result["wide_stacks"] = time_wide_stacks(
                        engine.model.params, version,
                        engine.module.init_state(engine.info, WIDE_BATCH,
                                                 device=engine.device))
    finally:
        await server.middleware.unload()
        await runner.cleanup()
    return result


def timed_serve(cfg: Path, kind: str) -> dict:
    t0 = time.monotonic()
    run = asyncio.run(serve(cfg, kind))
    print(f"serve {kind}: {time.monotonic() - t0:.1f} s", flush=True)
    return run


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    if not (ROOT / "ai00_server_tpu_torch" / "csrc").is_dir():
        fail(f"the port's package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))

    started = time.monotonic()
    card = card_line()
    print(f"card: {card}; Python {sys.version.split()[0]}, PyTorch "
          f"{torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    dev = torch.device("cuda", 0)

    from ai00_server_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build_all()
    print(f"built {sorted(_build.SIGNATURES)} in {time.monotonic() - t0:.1f}"
          " s (nvcc sm_90a)", flush=True)
    for name, info in _build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    head_build = start_head_build()

    sass_loads()

    t0 = time.monotonic()
    rows = phase_kernels(dev)
    rows.update(phase_decode_kernels(dev))
    bf16_head_ms = phase_head(dev)
    rows.update(phase_int8_kernels(dev, bf16_head_ms))
    rows.update(phase_4bit_kernels(dev))
    rows.update(phase_v6_kernels(dev))
    rows.update(phase_v54_kernels(dev))
    phase_wkv_gn_batches(dev, rows)
    phase_tp_kernels(dev, rows)
    rows.update(phase_phased_kernels(dev))
    rows.update(phase_ivf_kernels(dev))
    print(f"phase 2 (kernels) {time.monotonic() - t0:.1f} s", flush=True)

    # The v7 0.4B and RWKV-6 checkpoints are written on a thread of their
    # own (host work: numpy and the disk) while phases 3 and 3b run, the
    # RWKV-5 / -4 and head-size ones each while the models before it are
    # served; at most two on disk.
    tmp_root = ROOT / "chip_smoke_tmp"
    tmp_root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=tmp_root))
    writer = ThreadPoolExecutor(max_workers=1)
    try:
        site = writer.submit(write_site, tmp)
        writes = [functools.partial(write_site_family, tmp, v)
                  for v in ("v6", "v5", "v4")]
        writes.append(functools.partial(write_site_head, tmp))
        pending = writer.submit(writes[0])

        t0 = time.monotonic()
        parities = {version: phase_parity(dev, version)
                    for version in ("v7", "v6", "v5", "v4")}
        parity, parity_v6 = parities["v7"], parities["v6"]
        phased = phase_phased_parity(dev)
        print(f"phase 3 (parity) {time.monotonic() - t0:.1f} s", flush=True)

        t0 = time.monotonic()
        join_head_build(head_build)
        head_rows = phase_head_kernels(dev, rows)
        head_launches = phase_head_parity(dev)
        print(f"phase 3b (head sizes {list(HEAD_SIZES)}) "
              f"{time.monotonic() - t0:.1f} s", flush=True)

        t0 = time.monotonic()
        cfgs = site.result()
        served = {kind: timed_serve(cfgs[kind], kind) for kind in cfgs}
        (tmp / NF4_PREFAB).unlink()
        mesh_flow(dev, cfgs["bf16"])
        (tmp / "rwkv7-0.4b.st").unlink()
        for i, version in enumerate(("v6", "v5", "v4")):
            cfgs, path = pending.result()
            pending = writer.submit(writes[i + 1])
            served.update({kind: timed_serve(cfgs[kind], kind)
                           for kind in cfgs})
            if version == "v6":  # RWKV-6 tensor parallel over HTTP
                t1 = time.monotonic()
                mesh_v6 = asyncio.run(mesh_serve(cfgs["v6 bf16"], dev, "v6"))
                print_mesh_served("v6", mesh_v6, L6, time.monotonic() - t1)
            path.unlink()
        cfg, path = pending.result()
        served[HEAD_SERVED] = timed_serve(cfg, HEAD_SERVED)
        path.unlink()
    finally:
        writer.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp_root, ignore_errors=True)
    t1 = time.monotonic()
    wide_29 = phase_wide_stacks(dev)
    print(f"2.9B wide stacks {time.monotonic() - t1:.1f} s", flush=True)

    # Every kernel's launches on its main path: the bf16 burst for the WKV
    # chunk and the fused decode kernels, the int8 / nf4 burst for the int8
    # head and the int8 / 4-bit mode of the fused step, the mixed models'
    # completions for the layer path's kernels.  Serving keeps codes
    # stacked, so matmul_4bit's model path is the parity phase's unstacked
    # model: its count comes from there.
    for kind, names in (("bf16", {"wkv7_chunk": "wkv7_chunk",
                                  "v7_ln_mix": "v7_ln_mix",
                                  "v7_skinny_matmul": "v7_skinny_matmul",
                                  "v7_wkv_gn": "v7_wkv_gn"}),
                        ("int8", {"matmul_int8": "matmul_int8",
                                  "v7_skinny_matmul (int8)":
                                  "v7_skinny_matmul (int8)"}),
                        ("mixed", {"wkv7_t1": "wkv7_t1",
                                   "matmul_int8_l": "matmul_int8_l",
                                   "ffn7_t1_l": "ffn7_t1_l"}),
                        ("nf4", {"v7_skinny_matmul (4-bit)":
                                 "v7_skinny_matmul (4-bit)"}),
                        ("mixed nf4", {"matmul_4bit_l": "matmul_4bit_l",
                                       "ffn7_t1_l (4-bit)": "ffn7_t1_l"}),
                        ("v6 bf16", {"wkv56_chunk": "wkv56_chunk",
                                     "v7_ln_mix (v6)": "v7_ln_mix",
                                     "v7_skinny_matmul (v6)":
                                     "v7_skinny_matmul",
                                     "v6_wkv_gn": "v6_wkv_gn"}),
                        ("v5 bf16", {"v7_ln_mix (v5)": "v7_ln_mix",
                                     "v7_skinny_matmul (v5)":
                                     "v7_skinny_matmul",
                                     "v6_wkv_gn (v5)": "v6_wkv_gn"}),
                        ("v4 bf16", {"wkv4_chunk": "wkv4_chunk",
                                     "v7_ln_mix (v4)": "v7_ln_mix",
                                     "v7_skinny_matmul (v4)":
                                     "v7_skinny_matmul",
                                     "v4_wkv": "v4_wkv"}),
                        ("v5 bf16 wide", {"phased_matmul (v5)":
                                          "phased_matmul"}),
                        ("int8 wide", {"phased_matmul (int8)":
                                       "phased_matmul (int8)"}),
                        ("nf4 wide", {"phased_matmul (nf4)":
                                      "phased_matmul (nf4)"})):
        for row, counter in names.items():
            rows[row]["launches"] = served[kind]["launches"][counter]
    # The WKV kernels at the other head sizes: the launches of the head-size
    # parity's layer, fused and phased paths, and at N = 128 the served
    # model's prefill chunks and fused decode steps.
    n_top = max(HEAD_SIZES)
    for row in ("wkv7_chunk", "v7_wkv_gn"):
        head_launches[head_row(row, n_top)] = \
            served[HEAD_SERVED]["launches"][row]
    for name, row in head_rows.items():
        row["launches"] = head_launches.get(name, 0)
        check(row["launches"] > 0, f"no model path launched {name}")
    rows.update(head_rows)
    # phased_matmul on bf16 weights at v7's widths: the int8 burst's LoRA
    # launches.  On int4 codes: no served model holds them; their model
    # path is the parity phase's int4 2.9B phased stack.  On sf4 codes at
    # v5's widths: the Engine over the sf4 v5 parity model.
    wide_int8 = served["int8 wide"]["launches"]
    rows["phased_matmul"]["launches"] = (wide_int8["phased_matmul"]
                                         - wide_int8["phased_matmul (int8)"])
    rows["phased_matmul (int4)"]["launches"] = phased["int4_launches"]
    rows["phased_matmul (v5, sf4)"]["launches"] = \
        phased["engine"]["v5 0.4B sf4"]["lut4_launches"]
    for mode, n in (("int4", phased["int4_launches"]),
                    *phased["lut4_launches"].items()):
        check(n > 0, f"no model path launched phased_matmul on {mode} "
              "codes")
    # ivf_score's main path: the retrieval requests of the bf16 server.
    rag = served["bf16"]["rag"]
    rows["ivf_score"]["launches"] = rag["ivf_launches"]
    print(f"RAG on the bf16 server ({rag['seconds']:.1f} s): 32 "
          f"/embeddings in {rag['embed_s']:.3f} s "
          f"({rag['embeddings_per_s']:.1f} embeddings/s; max |served - "
          f"recipe| over the 32 {rag['embed_err']:.3e}, limit {EMBED_TOL}; "
          f"a dropped token or the next row's text reads "
          f"{rag['embed_wrong']:.3e} or more; against the batch-1 "
          f"mean_hidden_embed {rag['embed_solo']:.3e}); /chooses "
          f"perplexities {rag['ppl'][False]} (calibrated "
          f"{rag['ppl'][True]}); ivf_score launched {rag['ivf_launches']} "
          f"times; RAG chat prompt {rag['rag_prompt']} tokens against "
          f"{rag['plain_prompt']} without retrieval, text "
          f"{rag['rag_text']!r}", flush=True)
    bnf = served["bf16"]["bnf"]
    print(f"bnf ({card}; {bnf['seconds']:.1f} s): regular grammar "
          f"completion {bnf['regular'][0]!r} ({bnf['regular'][1]}, device "
          f"DFA), non-regular chat {bnf['nested'][0]!r} "
          f"({bnf['nested'][1]}, Earley replay); constrained burst of "
          f"{MAX_BATCH} completions of {BNF_TOKENS} tokens, every row on the "
          f"DFA: {bnf['burst_tokens']} tokens in {bnf['burst_wall_s']:.3f} s "
          f"-> {bnf['burst_tokens_per_s']:.1f} tokens/s, "
          f"{bnf['burst_replays']} graph replays, launches "
          f"{bnf['burst_launches']}, sample {bnf['sample']!r}; "
          f"{BNF_K}-step chunk at B={MAX_BATCH} (median of 5, in turns): "
          f"{bnf['chunk_dfa_ms']:.3f} ms every row on the DFA against "
          f"{bnf['chunk_ms']:.3f} ms unconstrained; the DFA step's ops "
          f"alone {bnf['dfa_step_ms']:.5f} ms a step on the device, "
          f"{bnf['dfa_step_host_ms']:.5f} ms back to back from Python (bound "
          f"{bnf['dfa_step_bound_ms']:.5f} ms, {bnf['dfa_step_bytes']} "
          f"bytes); dfa_pool {bnf['pool_shape']} int8 = "
          f"{bnf['pool_mb']:.1f} MB; {bnf['metrics']['bnf_table_builds']} "
          f"token-DFA table builds in {bnf['metrics']['bnf_table_s']:.3f} "
          "s; counters "
          f"{bnf['metrics']}", flush=True)
    print_prewarm(served["bf16"]["prewarm"], card)
    st = served["bf16"]["state"]
    print(f"state flow on the bf16 server ({card}; {st['seconds']:.1f} s): "
          f"reload with {LASTING_ST}, a [[state]] and a rank-{LORA_RANK} "
          f"[[lora]] over "
          f"{len(LORA_KEYS)} matrices of each of {L_STATE} layers in "
          f"{st['load_s']:.2f} s; (a) a blended weight on the card equals "
          f"the host blend cast to bf16 (the blend moved it by up to "
          f"{st['blend_changed']:.3e}); (b) /api/models/info lists the "
          f"state; (c) /api/oai/states {[L_STATE, HEAD + 2, C, 1]} in "
          f"{st['states_s_tuned']:.3f} s under the state, "
          f"{st['states_s_default']:.3f} s without; max |served - plain "
          f"forward| / max |plain| per part from the file "
          f"{ {k: f'{v:.3e}' for k, v in st['states_err']['tuned'].items()} }"
          f", from the model's own state (control) "
          f"{ {k: f'{v:.3e}' for k, v in st['states_err']['default'].items()} }"
          f" (tolerance {BF16_MODEL_TOL}); what the state adds to "
          f"layer 0's WKV against the plain forward's "
          f"{st['states_delta_err']:.3e} (tolerance {STATE_DELTA_TOL}); "
          f"(d) a state of "
          f"{st['install_mb']:.2f} MB installed from the host in "
          f"{st['install_ms']:.3f} ms (median of {INSTALL_REPS}); the "
          f"first logits of the step replayed right after it against the "
          f"same kernels launched eagerly from the state after a "
          f"synchronize {st['install_err']:.3e} (a row not installed "
          f"{st['install_ctrl']:.3e}; from the state before the install "
          f"{st['install_stale']:.3e}; tolerance {KERNEL_TOL}); against "
          f"the plain forward from the installed state, the state of every "
          f"layer after it {st['state_err']:.3e} (layer 0 "
          f"{st['layer0_err']:.3e}) and the logits "
          f"{st['plain_logits_err']:.3e} (a row not installed "
          f"{st['state_ctrl']:.3e} / {st['plain_logits_ctrl']:.3e}; from "
          f"the state before the install {st['state_stale']:.3e} / "
          f"{st['plain_logits_stale']:.3e}; tolerance {BF16_MODEL_TOL}); "
          f"the other rows "
          f"bit-identical to the same step without the install; (e) the "
          f"state by id, inline and by path: one greedy answer "
          f"{st['keyed'][:40]!r}; (f) default / tuned / default each equal "
          f"to a fresh slot's answer, tuned unlike default "
          f"({st['installs']} state installs); (g) "
          f"/embeddings echoes pooling 'state'; launches {st['launches']}, "
          f"{st['replays']} graph replays; the decode replay "
          f"{st['replay_ms']['lora']:.5f} ms with the LoRA and a custom "
          f"state ({L_STATE} layers) against "
          f"{st['replay_ms']['base']:.5f} ms without ({L_FULL}; median "
          "of 3, in turns)", flush=True)
    for kind in ("int8", "nf4"):
        pf = served[kind]["prefab"]
        print(f"prefab flow on the {kind} server ({card}; "
              f"{pf['seconds']:.1f} s; every step through the admin routes "
              f"with a JWT): /admin/models/save wrote "
              f"{pf['bytes'] / 1e6:.1f} MB in {pf['save_s']:.2f} s; "
              f"reloaded in turns from the .st in {pf['st_reload_s']:.2f} s "
              f"(quantizing included; {pf['st_load_s']:.2f} s at the first "
              f"load) and from the prefab in {pf['prefab_reload_s']:.2f} s; "
              f"device memory {pf['st_memory_bytes'] / 1e6:.3f} / "
              f"{pf['prefab_memory_bytes'] / 1e6:.3f} MB (the first load "
              f"{served[kind]['memory_bytes'] / 1e6:.3f} MB); the prefab's "
              f"{STATE_TOKENS}-token greedy answer repeats the one before "
              f"the save; launches {pf['launches']}", flush=True)
    rows["matmul_4bit"]["launches"] = parity["matmul_4bit_launches"]
    check(parity["matmul_4bit_launches"] > 0,
          "no model path launched matmul_4bit")
    # wkv56_t1's model path is the layer path of a partly quantized v6: the
    # parity phase's mixed v6 model.
    rows["wkv56_t1"]["launches"] = parity_v6["wkv56_t1_launches"]
    check(parity_v6["wkv56_t1_launches"] > 0,
          "no model path launched wkv56_t1")
    for kind, run in served.items():
        for name, n in run["launches"].items():
            check(n > 0, f"the {kind} model's requests never launched {name}")
        check((run["burst_replays"] > 0) == (not kind.startswith("mixed")),
              f"the {kind} model replayed {run['burst_replays']} decode "
              "graphs")
    # v5's mixed model launches wkv56_t1 on its layer path as well.
    check(parities["v5"]["wkv56_t1_launches"] > 0,
          "the mixed v5 model's layer path never launched wkv56_t1")
    stack_src = {"v7": ("ai00_server_tpu_torch/csrc/v7_decode.cu",
                        "ai00_server_tpu/ops/v7_decode_pallas.py:274"),
                 "v6": ("ai00_server_tpu_torch/csrc/v6_decode.cu",
                        "ai00_server_tpu/ops/v6_decode_pallas.py:236"),
                 "v5": ("ai00_server_tpu_torch/csrc/v6_decode.cu",
                        "ai00_server_tpu/ops/v5_decode_pallas.py:213"),
                 "v4": ("ai00_server_tpu_torch/csrc/wkv4.cu",
                        "ai00_server_tpu/ops/v4_decode_pallas.py:190")}
    for kind, label in (("bf16", "plain"), ("int8", "int8"), ("nf4", "nf4"),
                        ("v6 bf16", "plain"), ("v5 bf16", "plain"),
                        ("v4 bf16", "plain")):
        stack = served[kind]["stack"]
        version = kind.split()[0] if kind[:2] in ("v6", "v5", "v4") else "v7"
        source, replaces = stack_src[version]
        rows[f"forward_t1 {kind}"] = {
            "name": f"forward_t1 ({'' if kind == 'bf16' else kind + ', '}"
                    f"{served_layers(kind)} layers, "
                    f"{stack['kernels_per_replay']} kernels "
                    "in one CUDA graph)",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": served[kind]["burst_replays"],
            "max_abs_err": parities[version][
                f"fused_{label}_bf16_max_abs_err"],
            "ms": stack["replay_ms"], "plain_ms": stack["plain_ms"],
            "bound_ms": stack["bound_ms"], "bound_by": stack["bound_by"],
            "library_ms": None,
        }
        stacks = [(kind, stack)] + [
            (f"v6 {mode} (codes built on the card, not served)", st)
            for mode, st in served[kind].get("quant_stacks", {}).items()]
        for what, st in stacks:
            print(f"forward_t1, {served_layers(kind)} layers "
                  f"{what} B={MAX_BATCH}, all "
                  f"rows active: {st['replay_ms']:.5f} ms per graph replay "
                  f"({st['kernels_per_replay']} kernels; "
                  f"{st['bytes'] / st['replay_ms'] / 1e6:.0f} GB/s), "
                  f"{st['eager_ms']:.3f} ms launched eagerly from Python, "
                  f"{st['plain_ms']:.3f} ms as plain versions; bound "
                  f"{st['bound_ms']:.5f} ms by {st['bound_by']} "
                  f"({st['bytes'] / 1e6:.1f} MB); {overlap_text(st)}",
                  flush=True)
    st = served[HEAD_SERVED]["stack"]
    print(f"forward_t1, {L128} layers {HEAD_SERVED} B={MAX_BATCH}, all rows "
          f"active: {st['replay_ms']:.5f} ms per graph replay "
          f"({st['kernels_per_replay']} kernels; "
          f"{st['bytes'] / st['replay_ms'] / 1e6:.0f} GB/s), "
          f"{st['eager_ms']:.3f} ms launched eagerly from Python, "
          f"{st['plain_ms']:.3f} ms as plain versions; bound "
          f"{st['bound_ms']:.5f} ms by {st['bound_by']} "
          f"({st['bytes'] / 1e6:.1f} MB); {overlap_text(st)}", flush=True)
    # The phased stacks served at max_batch = WIDE_BATCH; their bf16 error
    # is the parity phase's at the same B (v7: the 2.9B int8 stack).
    for kind, version, label, replaces in (
            ("int8 wide", "v7", "v7 2.9B int8 B=64",
             "ai00_server_tpu/ops/v7_phased_pallas.py:780"),
            ("nf4 wide", "v7", "v7 2.9B nf4 B=64",
             "ai00_server_tpu/ops/v7_phased_pallas.py:780"),
            ("v5 bf16 wide", "v5", "v5 0.4B bf16 B=64",
             "ai00_server_tpu/ops/v56_phased_pallas.py:439")):
        stack = served[kind]["stack"]
        rows[f"forward_t1 {kind}"] = {
            "name": f"forward_t1 (phased, {kind[:-5]}, "
                    f"{served_layers(kind)} layers, "
                    f"B={WIDE_BATCH}, {stack['kernels_per_replay']} kernels "
                    "in one CUDA graph)",
            "route": "cuda", "source": "ai00_server_tpu_torch/csrc/phased.cu",
            "replaces": replaces, "launches": served[kind]["burst_replays"],
            "max_abs_err": phased[label]["max_abs_err"],
            "ms": stack["replay_ms"], "plain_ms": stack["plain_ms"],
            "bound_ms": stack["bound_ms"], "bound_by": stack["bound_by"],
            "library_ms": None,
        }
        print_wide(f"{served_layers(kind)} layers, {kind} model served",
                   served[kind]["wide_stacks"])
    print_wide(f"{L6} layers, v6 bf16 model served at max_batch {MAX_BATCH}",
               served["v6 bf16"]["wide_stacks"])
    for mode, stacks in wide_29.items():
        print_wide(f"{L29} layers 2.9B {mode} (built on the card, not "
                   "served)", stacks)
    for kind, run in served.items():
        print(f"launches on the {kind} model's requests: {run['launches']}; "
              f"{run['burst_replays']} graph replays; "
              f"{run['skinny_launches']} v7_skinny_matmul launches",
              flush=True)
        if kind.startswith("mixed"):
            print(f"serving ({L_FULL} layers, the first {SERVED[kind][0]} "
                  f"{SERVED[kind][1]}, layer-by-layer path) on {card}: 2 "
                  f"greedy completions of {MIXED_TOKENS} tokens one "
                  f"after the other in {run['wall_s']:.2f} s, "
                  f"{run['completion_tokens']} completion tokens -> "
                  f"{run['tokens_per_s']:.1f} tokens/s; "
                  f"{run['memory_bytes'] / 1e6:.1f} MB allocated by the "
                  f"load; sample {run['sample']!r}", flush=True)
            continue
        print(f"serving ({served_layers(kind)} layers, "
              f"{kind}, max_batch "
              f"{WIDE_BATCH if kind.endswith('wide') else MAX_BATCH}, chunk "
              f"{CHUNK}) on {card}: {run['burst']} in {run['wall_s']:.2f} s, "
              f"{run['completion_tokens']} "
              f"completion tokens ({run['prompt_tokens']} prompt) -> "
              f"{run['tokens_per_s']:.1f} tokens/s; TTFT "
              f"{run['ttft_s_under_load']:.3f} s under load, "
              f"{run['ttft_s_alone']:.3f} s alone; "
              f"{run['memory_bytes'] / 1e6:.1f} MB allocated by the load; "
              f"sample {run['sample']!r}", flush=True)
    from ai00_server_tpu_torch.tokenizer import Tokenizer

    n_long = len(Tokenizer.from_json(json.dumps(synthetic_vocab()))
                 .encode(LONG_PROMPT))
    print(f"TTFT of one {n_long}-token prompt (its text) streamed alone to "
          f"the bf16 server ({L_FULL} layers, chunk {CHUNK}): "
          f"{served['bf16']['ttft_s_long']:.3f} s; to the quant = {L_FULL} "
          f"Int8 server: {served['int8']['ttft_s_long']:.3f} s", flush=True)
    print(f"profile of one 64-token completion alone (bf16; {card}; "
          f"{served['bf16']['profile_s']:.1f} s): "
          f"{served['bf16']['profile']}", flush=True)
    for kind, run in served.items():
        if "metrics" in run:
            m = run["metrics"]
            print(f"/api/metrics after the {kind} burst: " + ", ".join(
                f"{k.removeprefix('ai00_runtime_')} {m[k]}" for k in (
                    "ai00_runtime_requests_started",
                    "ai00_runtime_requests_finished",
                    "ai00_runtime_cache_hits", "ai00_runtime_steps",
                    "ai00_runtime_merged_steps",
                    "ai00_runtime_chunk_launches",
                    "ai00_runtime_prefill_tokens",
                    "ai00_runtime_decode_tokens",
                    "ai00_runtime_step_seconds",
                    "ai00_runtime_chunk_wait_s", "ai00_runtime_launch_s",
                    "ai00_slots_busy", "ai00_step_seconds_avg")),
                  flush=True)
    print(f"phase 4 (serving) {time.monotonic() - t0:.1f} s", flush=True)

    print(f"chip_smoke.py: {time.monotonic() - started:.1f} s, the kernels' "
          "build included", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
