"""The port imports neither ``jax`` nor the JAX package, and its entry
points do not fall back to the CPU quietly.

The import check runs in a subprocess: this test process has already
imported jax (conftest.py forces the JAX CPU platform).
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "ai00_server_tpu_torch",
    "ai00_server_tpu_torch.bnf",
    "ai00_server_tpu_torch.device",
    "ai00_server_tpu_torch.engine",
    "ai00_server_tpu_torch.grammar",
    "ai00_server_tpu_torch.loader",
    "ai00_server_tpu_torch.main",
    "ai00_server_tpu_torch.middleware",
    "ai00_server_tpu_torch.native",
    "ai00_server_tpu_torch.models",
    "ai00_server_tpu_torch.models.common",
    "ai00_server_tpu_torch.models.info",
    "ai00_server_tpu_torch.models.packing",
    "ai00_server_tpu_torch.models.v4",
    "ai00_server_tpu_torch.models.v5",
    "ai00_server_tpu_torch.models.v6",
    "ai00_server_tpu_torch.models.v7",
    "ai00_server_tpu_torch.ops",
    "ai00_server_tpu_torch.ops._build",
    "ai00_server_tpu_torch.ops.ffn",
    "ai00_server_tpu_torch.ops.fused_decode",
    "ai00_server_tpu_torch.ops.quant",
    "ai00_server_tpu_torch.ops.quant_matmul",
    "ai00_server_tpu_torch.ops.retrieval",
    "ai00_server_tpu_torch.ops.sampling",
    "ai00_server_tpu_torch.ops.v4_decode",
    "ai00_server_tpu_torch.ops.v5_decode",
    "ai00_server_tpu_torch.ops.v6_decode",
    "ai00_server_tpu_torch.ops.v7_decode",
    "ai00_server_tpu_torch.ops.wkv4",
    "ai00_server_tpu_torch.ops.wkv_chunk",
    "ai00_server_tpu_torch.ops.wkv_t1",
    "ai00_server_tpu_torch.parallel",
    "ai00_server_tpu_torch.parallel.collectives",
    "ai00_server_tpu_torch.parallel.mesh_engine",
    "ai00_server_tpu_torch.parallel.sharding",
    "ai00_server_tpu_torch.prefab",
    "ai00_server_tpu_torch.retrieval_store",
    "ai00_server_tpu_torch.runtime",
    "ai00_server_tpu_torch.server",
    "ai00_server_tpu_torch.server.acme",
    "ai00_server_tpu_torch.server.app",
    "ai00_server_tpu_torch.server.auth",
    "ai00_server_tpu_torch.server.config",
    "ai00_server_tpu_torch.server.embed",
    "ai00_server_tpu_torch.server.files",
    "ai00_server_tpu_torch.server.openapi",
    "ai00_server_tpu_torch.server.webui",
    "ai00_server_tpu_torch.testing",
    "ai00_server_tpu_torch.tokenizer",
]


def test_port_imports_no_jax_and_no_jax_package():
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {MODULES!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "ai00_server_tpu"
                     or m.startswith("ai00_server_tpu."))
        assert not bad, bad
        print("ok", len({MODULES!r}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_import_without_cryptography():
    """``cryptography`` is imported only inside the ACME functions that
    sign: ``main`` and ``server.app`` (and ``server.acme`` itself) import
    with it blocked, as on a machine that lacks it."""
    code = textwrap.dedent("""
        import importlib, sys
        sys.modules["cryptography"] = None
        for m in ("ai00_server_tpu_torch.main",
                  "ai00_server_tpu_torch.server.app",
                  "ai00_server_tpu_torch.server.acme"):
            importlib.import_module(m)
        try:
            import cryptography  # noqa: F401
        except ImportError:
            print("ok blocked")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok blocked"


def test_default_device_raises_without_cuda():
    from ai00_server_tpu_torch.device import resolve_device
    from ai00_server_tpu_torch.engine import Engine
    from ai00_server_tpu_torch.loader import LoadedModel
    from ai00_server_tpu_torch.middleware import Middleware
    from ai00_server_tpu_torch.testing import tiny_info

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Middleware()
    model = LoadedModel(info=tiny_info(),
                        params={"emb": torch.zeros(2, 2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model)
    assert resolve_device("cpu") == torch.device("cpu")


def test_smoke_and_tools_import_no_jax_and_no_jax_package():
    """``chip_smoke.py`` and ``tools/torch_*.py`` run on the card without
    JAX: no import statement of theirs names ``jax`` or the JAX package
    (read from their source; importing them wants a card)."""
    import ast
    import glob

    paths = [os.path.join(REPO, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(REPO, "tools", "torch_*.py")))
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "ai00_server_tpu")]
    assert len(paths) > 1 and not bad, bad
