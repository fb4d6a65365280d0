"""Model metadata and version detection from safetensors key sets.

Port of ``ai00_server_tpu/models/info.py`` (framework-free; kept as this
package's own copy so the port imports nothing of the JAX package).

Mirrors the contract of the reference engine's ``Loader::info`` /
``ModelInfo`` (consumed at crates/ai00-core/src/lib.rs:587 and the
version detection heuristics of assets/scripts/convert_safetensors.py:36-59),
re-derived for the converted (.st) key naming:

* v7: ``blocks.0.att.w0`` present (vector-valued dynamic decay + delta rule)
* v6: ``blocks.0.att.time_mix_x`` present (data-dependent token shift)
* v5: ``blocks.0.att.ln_x.weight`` present (multi-head matrix state)
* v4: otherwise (scalar-channel WKV)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class ModelVersion(str, enum.Enum):
    V4 = "V4"
    V5 = "V5"
    V6 = "V6"
    V7 = "V7"


@dataclass(frozen=True)
class ModelInfo:
    version: ModelVersion
    num_layer: int
    num_emb: int
    num_hidden: int          # FFN hidden size
    num_vocab: int           # logits width (padded to the head rows)
    num_head: int            # v5+: number of WKV heads; v4: num_emb
    head_size: int           # v5+: per-head dim (usually 64); v4: 1
    custom: dict = field(default_factory=dict)

    @property
    def state_rows_per_layer(self) -> int:
        """Rows of the packed per-layer state (see models/packing.py)."""
        if self.version == ModelVersion.V4:
            return 5  # att shift, aa, bb, pp, ffn shift
        return self.head_size + 2  # att shift, wkv (head_size rows), ffn shift


def detect_info(shapes: dict[str, tuple[int, ...]]) -> ModelInfo:
    """Derive a ModelInfo from converted-safetensors tensor shapes.

    ``shapes`` maps tensor name -> shape, e.g. from
    ``safetensors.safe_open(...).get_slice(name).get_shape()``.
    """
    keys = set(shapes)
    if "emb.weight" not in keys:
        raise ValueError("not an RWKV checkpoint: missing emb.weight")
    num_vocab, num_emb = shapes["emb.weight"]

    if "blocks.0.att.w0" in keys:
        version = ModelVersion.V7
    elif "blocks.0.att.time_mix_x" in keys or "blocks.0.att.time_mix_w1" in keys:
        version = ModelVersion.V6
    elif "blocks.0.att.ln_x.weight" in keys or "blocks.0.att.gate.weight" in keys:
        version = ModelVersion.V5
    else:
        version = ModelVersion.V4

    num_layer = 0
    for k in keys:
        if k.startswith("blocks."):
            num_layer = max(num_layer, int(k.split(".")[1]) + 1)

    num_hidden = shapes["blocks.0.ffn.key.weight"][0]

    if version == ModelVersion.V7:
        num_head, head_size = shapes["blocks.0.att.r_k"]
    elif version in (ModelVersion.V5, ModelVersion.V6):
        tf = shapes["blocks.0.att.time_first"]
        if len(tf) == 2:
            num_head, head_size = tf
        else:
            # v5.1 converted files repeat to (H, N); fall back to 64.
            head_size = 64
            num_head = num_emb // head_size
    else:
        num_head, head_size = num_emb, 1

    return ModelInfo(
        version=version,
        num_layer=num_layer,
        num_emb=num_emb,
        num_hidden=num_hidden,
        num_vocab=num_vocab,
        num_head=num_head,
        head_size=head_size,
    )
