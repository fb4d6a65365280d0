"""Server config schema (TOML).

Port of ``ai00_server_tpu/server/config.py``: the same sections and keys
as ``assets/configs/Config.toml``, converted to a ``ReloadRequest`` with
the same path sandboxing (model, LoRA and state paths must live under the
configured model directory).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from typing import Any

from ..middleware import DEFAULT_TOKENIZER, ReloadRequest


class PathNotPermitted(PermissionError):
    pass


def check_path_permitted(path: str, permitted: list[str]) -> None:
    """The canonical path must live under one of the permitted roots."""
    real = os.path.realpath(path)
    for root in permitted:
        if real.startswith(os.path.realpath(root) + os.sep) \
                or real == os.path.realpath(root):
            return
    raise PathNotPermitted(f"path {path!r} not in permitted dirs {permitted}")


@dataclass
class ListenerOption:
    domain: str = "local"
    ip: str = "0.0.0.0"
    port: int = 65530
    acme: bool = False
    tls: bool = False


@dataclass
class Config:
    model: dict = field(default_factory=dict)
    lora: list[dict] = field(default_factory=list)
    state: list[dict] = field(default_factory=list)
    tokenizer: dict = field(default_factory=dict)
    bnf: dict = field(default_factory=dict)
    adapter: Any = field(default_factory=dict)
    listen: ListenerOption = field(default_factory=ListenerOption)
    embed: dict | None = None   # the [embed] sidecar (server/embed.py)

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        c = cls()
        c.model = raw.get("model", {})
        c.lora = raw.get("lora", [])
        c.state = raw.get("state", [])
        c.tokenizer = raw.get("tokenizer", {})
        c.bnf = raw.get("bnf", {})
        c.adapter = raw.get("adapter", {"Auto": {}})
        c.embed = raw.get("embed")
        lst = raw.get("listen", {})
        lo = ListenerOption()
        for k in ("domain", "ip", "port", "acme", "tls"):
            if k in lst:
                setattr(lo, k, lst[k])
        c.listen = lo
        return c

    def to_reload_request(self, sandbox: bool = True) -> ReloadRequest:
        """Config -> ReloadRequest with path sandboxing."""
        m = self.model
        model_dir = m.get("path", "assets/models")
        model_path = os.path.join(model_dir, m.get("name", ""))
        if sandbox:
            check_path_permitted(model_path, [model_dir])
            for entry in self.lora + self.state:
                p = entry["path"]
                check_path_permitted(
                    p if os.path.isabs(p) else os.path.join(model_dir, p),
                    [model_dir])
        return ReloadRequest(
            model_path=model_path,
            lora=list(self.lora),
            state=list(self.state),
            quant=int(m.get("quant", 0)),
            quant_type=m.get("quant_type", "Int8"),
            precision=m.get("precision", "Fp16"),
            token_chunk_size=int(m.get("token_chunk_size", 128)),
            max_batch=int(m.get("max_batch", 8)),
            tokenizer_path=self.tokenizer.get("path", DEFAULT_TOKENIZER),
            bnf=self.bnf,
            adapter=self.adapter,
            decode_chunk_size=int(m.get("decode_chunk_size", 16)),
            mesh=[int(x) for x in m["mesh"]] if m.get("mesh") else None,
        )
