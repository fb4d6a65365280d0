"""Sharding layouts for serving on a (dp, tp) mesh of places.

Port of ``ai00_server_tpu/parallel/sharding.py``.  Mesh axes:

* ``dp`` — data parallel over the continuous-batching slot axis (the state
  pool's batch dim): each dp rank owns ``max_batch / dp`` rows and a whole
  copy of the weights.  No traffic between dp ranks on the decode path.
* ``tp`` — tensor parallel over heads, channels and the vocabulary:
  projections split on their ``out`` dim, the output projection and the
  FFN's value on their ``in`` dim (their partial sums are added across the
  tp places), the LM head on the vocabulary, the WKV state on its heads
  (RWKV-4's on its channels).

A *place* is a ``torch.device``.  The JAX mesh is one controller over its
local devices with XLA placing the collectives; the port keeps the one
controller and calls its collectives itself (``parallel/collectives.py``).
A place may repeat: the CPU tests use the CPU eight times and
``chip_smoke.py`` one card four times, which runs every sharded code path
on one device.  Where two places are the same device and hold the same
slice they share one tensor, so a logical mesh on one card holds the
weights once per tp slice, not once per place.

A spec here is, per leaf, the dim that splits on ``"tp"`` (negative, from
the end: ``-1`` is a weight's ``out``, ``-2`` its ``in``) or None for a leaf
whole on every place; for the state, the dims that split on ``"dp"`` and
on ``"tp"``.  Quantized weights (``ops/quant``) split like their plain
ones where the slice falls on whole scale blocks (an ``out`` slice always
does); an ``in`` slice that does not is kept whole on every place of its
dp rank as :class:`~ai00_server_tpu_torch.ops.quant.QuantizedRows`.  The
JAX package keeps every quantized leaf whole (``P()``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import quant

# Weight leaves split on their output feature dim under tp; the output
# projection and the FFN's value (Megatron-style pairing with key) contract
# the split dim, so they split on their input.
_TP_OUT_KEYS = {"receptance", "key", "value", "gate", "w2", "a2", "g2", "v2"}
_TP_IN_KEYS = {"output"}
OUT, IN = -1, -2


@dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of places: ``devices[d][j]`` is tp place ``j`` of
    dp rank ``d``."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["tp"]

    def __str__(self) -> str:
        return (f"[{self.shape['dp']}, {self.shape['tp']}] over "
                + ", ".join(str(p) for row in self.devices for p in row))


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, devices=None) -> Mesh:
    """A (dp, tp) mesh.  Defaults: the distinct cards ``cuda:0 ..
    cuda:{n-1}``, tp = 1, dp = all of them.  ``devices`` may repeat a
    device (the CPU tests, a logical mesh on one card)."""
    if devices is None:
        n = n_devices or torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices:
        devices = list(devices)[:n_devices]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if tp is None and dp is None:
        dp, tp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"mesh [{dp}, {tp}] needs {dp * tp} devices, have "
                         f"{n}")
    return Mesh(tuple(tuple(devices[d * tp:(d + 1) * tp])
                      for d in range(dp)))


def _leaf_spec(name, part, leaf):
    """The tp split dim of one layer leaf named ``name`` in ``part``: only
    matrices split (a quantized weight is one)."""
    if getattr(leaf, "ndim", 2) < 2:
        return None
    if part == "ffn" and name == "value":
        return IN
    if name in _TP_OUT_KEYS:
        return OUT
    if name in _TP_IN_KEYS:
        return IN
    return None


def param_specs(params) -> dict:
    """The tp split dim (or None) of every leaf of a params tree, the same
    tree of dicts and lists.  A leaf's dim is the one the JAX ``param_specs``
    gives its stacked form, less the leading layer axis.  Derived
    ``"_"``-prefixed entries are left out (the engine rebuilds them per
    shard), except the int8 LM head ``_head_q``, which splits on the
    vocabulary like ``head``."""
    if "head" not in params and "_head_q" not in params:
        raise ValueError("params have no 'head' and no '_head_q'")

    def layer_specs(layer):
        return {part: ({k: _leaf_spec(k, part, v) for k, v in sub.items()}
                       if isinstance(sub, dict) else None)
                for part, sub in layer.items()}

    specs = {"emb": None, "layers": [layer_specs(p) for p in params["layers"]],
             "ln_out_w": None, "ln_out_b": None}
    for k in ("head", "_head_q"):
        if k in params:
            specs[k] = OUT
    return specs


# RWKV-4's per-channel WKV ``(L, B, C)``: split on its channels under tp,
# where the JAX ``state_specs`` keeps it whole (each place updates only its
# channels, so whole copies would part).
_TP_CHANNEL_STATE = {"aa", "bb", "pp"}


def state_specs(state) -> dict:
    """``{key: (dp dim, tp dim or None)}``: every leaf ``(L, B, ...)`` splits
    its batch on dp; the 5-D WKV ``(L, B, H, N, N)`` also its heads on tp,
    RWKV-4's ``aa`` / ``bb`` / ``pp`` their channels."""
    return {k: (1, 2 if v.ndim == 5 or k in _TP_CHANNEL_STATE else None)
            for k, v in state.items()}


def sampler_state_specs(ss) -> dict:
    """The sampler state's rows ``(B, ...)`` split on dp."""
    return {k: 0 for k in ss}


def data_specs() -> tuple:
    """The dp dims of (tokens (B, T), lengths (B,), sample_mask (B,))."""
    return 0, 0, 0


def split(t: torch.Tensor, dim: int, part: int, parts: int) -> torch.Tensor:
    """Part ``part`` of ``parts`` equal slices of ``t`` along ``dim``."""
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {parts}")
    return t.narrow(dim, part * (n // parts), n // parts)


class _Placer:
    """Moves leaves to places, one copy per (leaf, device, slice)."""

    def __init__(self, tp: int):
        self.tp = tp
        self.memo: dict = {}

    def tensor(self, t, dim, j, place):
        key = (id(t), str(place), dim, j if dim is not None else None)
        if key not in self.memo:
            s = t if dim is None else split(t, dim, j, self.tp).contiguous()
            self.memo[key] = (s.to(place), t)  # t kept: ids stay unique
        return self.memo[key][0]

    def qlin(self, q, dim, j, place):
        """A QuantizedLinear's slice on ``place``, or None where an ``in``
        slice does not fall on whole blocks."""
        key = (id(q), str(place), dim, j if dim is not None else None)
        if key not in self.memo:
            s = q if dim is None else q.sliced(dim, j, self.tp)
            self.memo[key] = (None if s is None else s.to(place), q)
        return self.memo[key][0]

    def leaf(self, leaf, dim, j, place):
        if dim is not None and self.tp == 1:
            dim = None
        if isinstance(leaf, quant.QuantizedLayerView):
            q = self.qlin(leaf.qlin, dim, j, place)
            if q is not None:
                return quant.QuantizedLayerView(q, leaf.idx)
            whole = quant.QuantizedLayerView(
                self.qlin(leaf.qlin, None, j, place), leaf.idx)
        elif isinstance(leaf, quant.QuantizedLinear):
            q = self.qlin(leaf, dim, j, place)
            if q is not None:
                return q
            whole = self.qlin(leaf, None, j, place)
        else:
            return self.tensor(leaf, dim, j, place)
        rows = leaf.shape[0] // self.tp
        return quant.QuantizedRows(whole, j * rows, (j + 1) * rows)


def _place_tree(node, spec, fn):
    if isinstance(node, dict):
        return {k: _place_tree(v, spec[k], fn) for k, v in node.items()
                if k in spec}
    if isinstance(node, list):
        return [_place_tree(v, s, fn) for v, s in zip(node, spec)]
    return fn(node, spec)


def shard_params(params, mesh: Mesh) -> list:
    """The params on every place: ``grid[d][j]`` is place ``(d, j)``'s
    tree, each tp-split leaf sliced to its part.  Places on one device with
    the same tp index share one tree (and so one set of tensors).  Derived
    ``"_"``-prefixed entries other than ``_head_q`` are dropped."""
    specs = param_specs(params)
    tp = mesh.shape["tp"]
    placer = _Placer(tp)
    trees: dict = {}
    grid = []
    for row in mesh.devices:
        out = []
        for j, place in enumerate(row):
            key = (str(place), j)
            if key not in trees:
                trees[key] = _place_tree(
                    params, specs,
                    lambda leaf, dim: placer.leaf(leaf, dim, j, place))
            out.append(trees[key])
        grid.append(out)
    return grid


def _cat_quant(parts, dim, memo):
    """QuantizedLinear parts of one leaf joined along logical ``dim``."""
    key = tuple(id(p) for p in parts)
    if key not in memo:
        axis = -1 if dim == OUT else -3
        shape = list(parts[0].shape)
        shape[dim] = sum(p.shape[dim] for p in parts)
        memo[key] = quant.QuantizedLinear(
            parts[0].mode, torch.cat([p.q for p in parts], axis),
            torch.cat([p.scale for p in parts], axis), shape)
    return memo[key]


def _to(leaf, device, memo):
    if isinstance(leaf, quant.QuantizedLayerView):
        return quant.QuantizedLayerView(_to(leaf.qlin, device, memo),
                                        leaf.idx)
    if id(leaf) not in memo:
        memo[id(leaf)] = (leaf.to(device), leaf)
    return memo[id(leaf)][0]


def _join(parts, dim, memo):
    """One leaf's tp parts joined along ``dim`` (already on one device)."""
    first = parts[0]
    if dim is None or len(parts) == 1:
        return first
    if isinstance(first, quant.QuantizedLayerView):
        return quant.QuantizedLayerView(
            _cat_quant([p.qlin for p in parts], dim, memo), first.idx)
    if isinstance(first, quant.QuantizedLinear):
        return _cat_quant(parts, dim, memo)
    return torch.cat(parts, dim)


def unshard_params(grid: list, device) -> dict:
    """The whole params on ``device``, gathered from dp rank 0's tp places
    of a :func:`shard_params` grid (the inverse of it, ``_head_q``
    included)."""
    row = grid[0]
    specs = param_specs(row[0])
    moved: dict = {}
    joined: dict = {}

    def walk(nodes, spec):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], spec[k])
                    for k in nodes[0] if k in spec}
        if isinstance(nodes[0], list):
            return [walk([n[i] for n in nodes], spec[i])
                    for i in range(len(nodes[0]))]
        if isinstance(nodes[0], quant.QuantizedRows):  # kept whole
            return _to(nodes[0].whole, device, moved)
        return _join([_to(n, device, moved) for n in nodes], spec, joined)

    return walk(row, specs)


def shard_state(state, mesh: Mesh) -> list:
    """A state tree ``(L, B, ...)`` on every place: ``grid[d][j]`` holds
    dp rank ``d``'s rows and, for the WKV, tp place ``j``'s heads or
    channels (each a contiguous tensor of its own)."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    specs = state_specs(state)
    grid = []
    for d, row in enumerate(mesh.devices):
        out = []
        for j, place in enumerate(row):
            part = {}
            for k, v in state.items():
                bd, hd = specs[k]
                s = split(v, bd, d, dp)
                if hd is not None:
                    s = split(s, hd, j, tp)
                part[k] = s.to(place).clone()
            out.append(part)
        grid.append(out)
    return grid


def unshard_state(grid: list, device) -> dict:
    """The inverse of :func:`shard_state`: the whole state on ``device``
    (the batch from every dp rank, the WKV heads or channels from every tp
    place, the other leaves from each rank's first place)."""
    specs = state_specs(grid[0][0])
    out = {}
    for k, (bd, hd) in specs.items():
        rows = []
        for row in grid:
            if hd is None:
                rows.append(row[0][k].to(device))
            else:
                rows.append(torch.cat([p[k].to(device) for p in row], hd))
        out[k] = torch.cat(rows, bd)  # a tensor of its own, even of one
    return out


def shard_sampler_state(ss, mesh: Mesh) -> list:
    """The sampler state's rows of each dp rank, on its first place."""
    dp = mesh.shape["dp"]
    return [{k: split(v, 0, d, dp).to(row[0]).clone()
             for k, v in ss.items()}
            for d, row in enumerate(mesh.devices)]
