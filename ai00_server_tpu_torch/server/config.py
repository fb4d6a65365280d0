"""Server config schema (TOML).

Port of ``ai00_server_tpu/server/config.py``: the same sections and keys
as ``assets/configs/Config.toml`` (``listen`` with its auth, TLS and ACME
fields, ``web`` and ``embed``), converted to a ``ReloadRequest`` with the
same path sandboxing (model, LoRA and state paths must live under the
configured model directory), and written back as TOML (``dump_toml``).
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
class AppKey:
    app_id: str = "admin"
    secret_key: str = "ai00_is_good"


@dataclass
class ListenerOption:
    """One listener.  A ``domain`` other than ``"local"`` forces TLS, and
    with ``acme`` its certificate comes from an ACME directory (RFC 8555
    http-01, ``server/acme.py``; empty ``acme_directory``: Let's Encrypt).
    Unless ``force_pass``, ``/admin/*`` wants a JWT signed with ``slot``,
    got from ``/api/auth/exchange`` for one of ``app_keys``.  ``quic`` is
    accepted and warned about: HTTP/3 is not served."""
    domain: str = "local"
    ip: str = "0.0.0.0"
    port: int = 65530
    acme: bool = False
    tls: bool = False
    force_pass: bool = True
    slot: str = "permisionkey"
    expire_sec: int = 86400
    app_keys: list[AppKey] = field(default_factory=lambda: [AppKey()])
    tls_cert: str = "assets/certs/cert.pem"
    tls_key: str = "assets/certs/key.pem"
    acme_directory: str = ""
    acme_contact: str = ""
    quic: bool = False


LISTEN_KEYS = ("domain", "ip", "port", "acme", "tls", "force_pass", "slot",
               "expire_sec", "tls_cert", "tls_key", "acme_directory",
               "acme_contact", "quic")


@dataclass
class Config:
    model: dict = field(default_factory=dict)
    lora: list[dict] = field(default_factory=list)
    state: list[dict] = field(default_factory=list)
    tokenizer: dict = field(default_factory=dict)
    bnf: dict = field(default_factory=dict)
    adapter: Any = field(default_factory=dict)
    listen: ListenerOption = field(default_factory=ListenerOption)
    web: dict | None = None     # the WebUI zip (main.py)
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
        c.web = raw.get("web")
        c.embed = raw.get("embed")
        lst = raw.get("listen", {})
        lo = ListenerOption()
        for k in LISTEN_KEYS:
            if k in lst:
                setattr(lo, k, lst[k])
        if "app_keys" in lst:
            lo.app_keys = [AppKey(k.get("app_id", ""), k.get("secret_key", ""))
                           for k in lst["app_keys"]]
        c.listen = lo
        return c

    def to_dict(self) -> dict:
        """The TOML's tables (``from_dict`` reads them back)."""
        # The JAX dict's order: app_keys right after expire_sec.
        listen = {k: getattr(self.listen, k) for k in LISTEN_KEYS[:8]}
        listen["app_keys"] = [{"app_id": k.app_id, "secret_key": k.secret_key}
                              for k in self.listen.app_keys]
        listen.update({k: getattr(self.listen, k) for k in LISTEN_KEYS[8:]})
        out: dict = {"model": self.model, "tokenizer": self.tokenizer,
                     "bnf": self.bnf, "adapter": self.adapter,
                     "listen": listen}
        for k in ("lora", "state"):
            if getattr(self, k):
                out[k] = getattr(self, k)
        for k in ("web", "embed"):
            if getattr(self, k) is not None:
                out[k] = getattr(self, k)
        return out

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


# ---------------------------------------------------------------------------
# A TOML writer for the config's shapes (tomllib only reads).
# ---------------------------------------------------------------------------


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n") + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot TOML-encode {type(v)}")


def dump_toml(data: dict) -> str:
    """``data`` as TOML: scalars first, then a table per dict and an array
    of tables per list of dicts (nested ones as dotted tables)."""
    lines: list[str] = []

    def emit_table(name: str, tbl: dict, array: bool = False):
        lines.append(f"[[{name}]]" if array else f"[{name}]")
        subtables = []
        for k, v in tbl.items():
            if isinstance(v, dict):
                subtables.append((f"{name}.{k}", v, False))
            elif isinstance(v, list) and v and isinstance(v[0], dict):
                subtables += [(f"{name}.{k}", item, True) for item in v]
            else:
                lines.append(f"{k} = {_toml_value(v)}")
        lines.append("")
        for sub_name, sub, arr in subtables:
            emit_table(sub_name, sub, arr)

    top = {k: v for k, v in data.items() if not isinstance(v, (dict, list))}
    for k, v in top.items():
        lines.append(f"{k} = {_toml_value(v)}")
    if top:
        lines.append("")
    for k, v in data.items():
        if isinstance(v, dict):
            emit_table(k, v)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            for item in v:
                emit_table(k, item, array=True)
    return "\n".join(lines)
