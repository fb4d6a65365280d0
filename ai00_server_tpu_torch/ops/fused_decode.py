"""Dispatch table of the fused whole-network T=1 decode paths.

Port of ``ai00_server_tpu/ops/fused_decode.py:module_for``.  One module per
RWKV version, all with the same surface: ``FUSED_KEY``, ``can_fuse(params)``,
``make_fused_layout(params)``, ``supports(params)``, ``forward_t1(...)`` and
``DecodeGraph``, a subclass of :class:`DecodeGraph` here that names the
module's ``forward_t1`` and launch counters.

``group_mode`` and ``big_layout_entries`` (the JAX module's lines 34 and 67)
let a kernel module take the big projections as plain weights or as codes +
scales (int8, nf4, sf4, int4); here they look at ONE layer's dict, since the
port keeps a dict per layer, and ``uniform_mode`` asks it of every layer.
The JAX module's ``make_W`` (the in-kernel dequantize) is the weight decode
of ``v7_skinny_matmul`` in ``csrc/v7_decode.cu``.  Its ``mode_packs`` hands
the Pallas kernel a 4-bit mode's levels as four packed constants for a
select tree; the card's kernel gathers from a 16-entry table in shared
memory instead, so the counterpart is the plain tuple
``ops.quant.LEVELS[mode]``.
"""

from __future__ import annotations

import torch

from .quant import MODES, is_quantized


def module_for(version: str):
    """The fused-decode module for a ModelVersion value string."""
    from . import v4_decode, v5_decode, v6_decode, v7_decode

    modules = {"V7": v7_decode, "V6": v6_decode, "V5": v5_decode,
               "V4": v4_decode}
    if version not in modules:
        raise ValueError(f"unknown model version {version!r}")
    return modules[version]


def stack_for(version: str, params, batch: int):
    """The module whose ``forward_t1`` / ``DecodeGraph`` a T=1 step of
    ``batch`` rows takes, mirroring the JAX engine's "phased where fused
    does not apply": the phased stack (``ops/v7_phased``,
    ``ops/v56_phased``) when its ``can_phase`` holds (a batch above the 8
    rows of the fused products, plain / int8 / int4 weights), else the
    fused one (:func:`module_for`) when its ``can_fuse`` holds, else None
    (the layer-by-layer path).  Either stack reads the fused module's
    layout.  RWKV-4 has no phased stack and keeps its fused one at any
    batch."""
    from . import v56_phased, v7_phased

    fd = module_for(version)
    if version == "V7" and v7_phased.can_phase(params, batch):
        return v7_phased
    if version in ("V6", "V5") and v56_phased.can_phase(params, batch,
                                                         version):
        return v56_phased
    return fd if fd.can_fuse(params) else None


def group_mode(layer: dict, big_src: dict):
    """``"none"`` / ``"int8"`` / ``"nf4"`` / ``"sf4"`` / ``"int4"`` when the
    layer's big projections are uniformly plain or uniformly quantized in
    one mode; None otherwise."""
    modes = {layer[part][key].mode if is_quantized(layer[part][key])
             else "none" for part, key in big_src.values()}
    return modes.pop() if len(modes) == 1 else None


def uniform_mode(layers: list, big_src: dict, dtype) -> bool:
    """Whether the big projections of ALL layers are plain in ``dtype`` or
    quantized in ONE mode: what a fused stack takes (a model whose layers
    are partly quantized keeps to the layer path, as a model of several
    layer groups does in the reference)."""
    modes = {group_mode(p, big_src) for p in layers}
    if modes == {"none"}:
        return all(p[part][key].dtype == dtype
                   for p in layers for part, key in big_src.values())
    return len(modes) == 1 and modes <= set(MODES)


def big_layout_entries(layer: dict, big_src: dict) -> dict:
    """The fused-layout entries of one layer's big projections: ``name``
    for a plain weight, ``name_q`` + ``name_s`` (codes and scales, views
    into the group's stacked tensors) for a quantized one."""
    out = {}
    for name, (part, key) in big_src.items():
        leaf = layer[part][key]
        if is_quantized(leaf):
            out[f"{name}_q"] = leaf.q
            out[f"{name}_s"] = leaf.scale
        else:
            out[name] = leaf
    return out


def big_products(f: dict, layer: dict, big_src: dict):
    """``big(x, name, l, **kw)``: the ``ops.v7_decode.Product`` of big
    projection ``name`` of layer ``l`` in the fused layout ``f``: the plain
    weight, or its codes and scales in the stack's one mode (read off
    ``layer``, one of the model's layers; the codes do not name it)."""
    from .v7_decode import Product

    mode = group_mode(layer, big_src)
    quant = mode != "none"

    def big(x, name, l, **kw):
        if quant:
            return Product(x, f[name + "_q"][l], scale=f[name + "_s"][l],
                           mode=mode, **kw)
        return Product(x, f[name][l], **kw)

    return big


def gated_channel_mix(ln_mix, matmul, big, f, x, shift, l, active):
    """The receptance-gated channel mix of a v6 / v5 / v4 layer in three
    launches: LayerNorm 2 with the layout's two ``fmix`` rows (``shift``
    updated in place), the key (squared ReLU) and receptance (sigmoid,
    f32) products, and the value gated by the receptance and added into the
    f32 residual ``x``."""
    fxk, fxr = ln_mix(x, f["ln2"][l], shift, f["fmix"][l], active)
    hk, rf = matmul([big(fxk, "fkey", l, act="relu2"),
                     big(fxr, "frec", l, act="sigmoid", out="f32")])
    matmul([big(hk, "fval", l, out="gadd", y=x, gate=rf)])


class DecodeGraph:
    """A version's ``forward_t1`` captured once in a ``torch.cuda.CUDAGraph``
    over static buffers — ``tokens`` (B,) int32, ``lengths`` (B,) int32, the
    state pool it was given, ``hidden`` (B, C) — and replayed per decode
    step.  A failure to capture raises; there is no eager retry.

    A subclass names what it captures: ``forward`` (the module's
    ``forward_t1``), ``kernels`` (its wrappers, in the order of
    :attr:`launches_per_replay`) and ``counts`` (every ``(wrapper,
    attribute)`` launch count a replay has to keep up to date).  A replay
    launches every kernel the capture recorded, so it adds the captured
    count to each of them (the capture itself launches nothing and leaves
    the counts as they were).
    """

    total_replays = 0
    forward = None
    kernels: tuple = ()
    counts: tuple = ()

    def __init__(self, params, state, batch: int):
        dev = next(iter(state.values())).device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
        self.tokens = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.lengths = torch.zeros(batch, dtype=torch.int32, device=dev)
        forward = type(self).forward

        def run():
            hidden, _ = forward(params, state, self.tokens[:, None],
                                self.lengths)
            return hidden[:, 0]

        # Warm up on a side stream with every row idle (the state keeps
        # its bits): builds and loads the kernels outside the capture.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [getattr(k, a) for k, a in self.counts]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.hidden = run()
        self._per_replay = [getattr(k, a) - n
                            for (k, a), n in zip(self.counts, before)]
        self.launches_per_replay = self._per_replay[:len(self.kernels)]
        for (k, a), n in zip(self.counts, before):
            setattr(k, a, n)

    def replay(self, tokens, lengths) -> torch.Tensor:
        """One decode step: tokens (B,) int, lengths (B,) int or bool.
        Returns the static ``hidden`` (B, C), overwritten by the next
        replay."""
        self.tokens.copy_(tokens)
        self.lengths.copy_(lengths)
        self.graph.replay()
        for (k, a), n in zip(self.counts, self._per_replay):
            setattr(k, a, getattr(k, a) + n)
        DecodeGraph.total_replays += 1
        return self.hidden
