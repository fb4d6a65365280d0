"""External embedding sidecar: the ``[embed]`` section's encoder.

Port of ``ai00_server_tpu/server/embed.py`` (its own copy: the port imports
nothing of the JAX package).  The reference downloads BERT-style ONNX
models and runs them on the CPU; this loads any local HuggingFace-format
encoder with transformers + torch on the server's device (the card unless
the server runs with ``--device cpu``) and embeds with mean pooling + L2
normalization (fastembed's default).  ``[embed]`` config:

    [embed]
    model = "assets/models/hf/bge-small-en-v1.5"   # local dir or HF id
    home = "assets/models/hf"                       # cache (HF id case)
    max_tokens = 510                                # default chunk size

Without an ``[embed]`` model, ``/api/oai/embeds`` answers 400.
"""

from __future__ import annotations

import asyncio
import logging
import os

import numpy as np
import torch

log = logging.getLogger(__name__)


# The fastembed model zoo: enum name -> HF repo id, so a config whose
# [embed] names a zoo model resolves here unchanged.  Quantized variants
# ("...Q") are ONNX artifacts of the same checkpoints; this build runs the
# fp32 torch weights for them.
ZOO = {
    "AllMiniLML6V2": "sentence-transformers/all-MiniLM-L6-v2",
    "AllMiniLML6V2Q": "sentence-transformers/all-MiniLM-L6-v2",
    "AllMiniLML12V2": "sentence-transformers/all-MiniLM-L12-v2",
    "AllMiniLML12V2Q": "sentence-transformers/all-MiniLM-L12-v2",
    "BGEBaseENV15": "BAAI/bge-base-en-v1.5",
    "BGEBaseENV15Q": "BAAI/bge-base-en-v1.5",
    "BGELargeENV15": "BAAI/bge-large-en-v1.5",
    "BGELargeENV15Q": "BAAI/bge-large-en-v1.5",
    "BGESmallENV15": "BAAI/bge-small-en-v1.5",
    "BGESmallENV15Q": "BAAI/bge-small-en-v1.5",
    "NomicEmbedTextV1": "nomic-ai/nomic-embed-text-v1",
    "NomicEmbedTextV15": "nomic-ai/nomic-embed-text-v1.5",
    "NomicEmbedTextV15Q": "nomic-ai/nomic-embed-text-v1.5",
    "ParaphraseMLMiniLML12V2":
        "sentence-transformers/paraphrase-MiniLM-L6-v2",
    "ParaphraseMLMiniLML12V2Q":
        "sentence-transformers/paraphrase-MiniLM-L6-v2",
    "ParaphraseMLMpnetBaseV2":
        "sentence-transformers/paraphrase-mpnet-base-v2",
    "BGESmallZHV15": "BAAI/bge-small-zh-v1.5",
    "MultilingualE5Small": "intfloat/multilingual-e5-small",
    "MultilingualE5Base": "intfloat/multilingual-e5-base",
    "MultilingualE5Large": "intfloat/multilingual-e5-large",
    "MxbaiEmbedLargeV1": "mixedbread-ai/mxbai-embed-large-v1",
    "MxbaiEmbedLargeV1Q": "mixedbread-ai/mxbai-embed-large-v1",
    "GTEBaseENV15": "Alibaba-NLP/gte-base-en-v1.5",
    "GTEBaseENV15Q": "Alibaba-NLP/gte-base-en-v1.5",
    "GTELargeENV15": "Alibaba-NLP/gte-large-en-v1.5",
    "GTELargeENV15Q": "Alibaba-NLP/gte-large-en-v1.5",
    "ClipVitB32": "Qdrant/clip-ViT-B-32-text",
    "JinaEmbeddingsV2BaseCode": "jinaai/jina-embeddings-v2-base-code",
}


def resolve_zoo(name: str) -> str:
    """Map a fastembed zoo enum name to its HF repo id; other names
    (local paths, HF ids) pass through unchanged."""
    return ZOO.get(str(name), name)


class TextEmbedder:
    """BERT-style sentence embedder: mean-pool over valid tokens + L2
    normalization (fastembed's pooling for the reference's default
    models).  The encoder runs on ``device``; only the vectors come back
    to the host."""

    def __init__(self, model, tokenizer, name: str, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.tokenizer = tokenizer
        self.name = name

    def embed(self, texts: list[str]) -> np.ndarray:
        enc = self.tokenizer(texts, padding=True, truncation=True,
                             max_length=512, return_tensors="pt")
        enc = {k: v.to(self.device) for k, v in enc.items()}
        with torch.no_grad():
            out = self.model(**enc)
        hidden = out.last_hidden_state            # (B, T, C)
        mask = enc["attention_mask"].unsqueeze(-1).to(hidden.dtype)
        summed = (hidden * mask).sum(dim=1)
        counts = mask.sum(dim=1).clamp(min=1)
        mean = summed / counts
        vecs = torch.nn.functional.normalize(mean, dim=-1)
        return vecs.cpu().numpy().astype(np.float32)

    def split_chunks(self, text: str, max_tokens: int) -> list[str]:
        """Token-budgeted splitter: greedy windows of at most
        ``max_tokens`` tokens of the model's tokenizer, decoded back to
        text."""
        max_tokens = max(1, min(int(max_tokens), 510))
        ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
        if not ids:
            return []
        chunks = []
        for i in range(0, len(ids), max_tokens):
            piece = self.tokenizer.decode(ids[i: i + max_tokens],
                                          skip_special_tokens=True).strip()
            if piece:
                chunks.append(piece)
        return chunks


async def load_embedder(cfg: dict, device="cuda") -> TextEmbedder | None:
    """Load the `[embed]` model off the event loop onto ``device`` (the
    server's).  Returns None (with a log line) when no model is named."""
    name = cfg.get("model") or cfg.get("name")
    if not name:
        log.warning("[embed] section present but no model configured")
        return None
    name = resolve_zoo(name)
    home = cfg.get("home")
    if home:
        os.environ.setdefault("HF_HOME", str(home))

    def _load():
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(name)
        model = AutoModel.from_pretrained(name)
        model.eval()
        return TextEmbedder(model, tokenizer, str(name), device=device)

    loop = asyncio.get_event_loop()
    return await loop.run_in_executor(None, _load)
