"""The port's state packing (``ai00_server_tpu_torch/models/packing.py``)
against the JAX package's (``ai00_server_tpu/models/packing.py``) on the
CPU: ``pack_state``, ``unpack_state`` and ``load_state_file`` (a
state-tuning file of per-layer ``time_state`` tensors and a packed
``state`` file) give equal arrays, exactly, for RWKV-4 to -7; a packed
state round-trips; a row state on the device packs as its host copy does.

One divergence, recorded here: an RWKV-4 state-tuning file (v4 has no
``time_state``) raises ``ValueError`` naming the file, where the JAX
package builds a ``wkv`` entry that RWKV-4's state has no room for.
"""

import numpy as np
import pytest
import torch

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.models import ModelVersion as JVersion
from ai00_server_tpu.models import packing as jpacking
from ai00_server_tpu.testing import tiny_info as jtiny_info

from ai00_server_tpu_torch.models import ModelVersion, get_version_module
from ai00_server_tpu_torch.models import packing
from ai00_server_tpu_torch.testing import cpu_test_threads, tiny_info

cpu_test_threads()

VERSIONS = ("V4", "V5", "V6", "V7")
SHAPE = dict(num_layer=2, num_emb=32, head_size=16, num_vocab=64)


def infos(version: str):
    return (tiny_info(ModelVersion(version), **SHAPE),
            jtiny_info(JVersion(version), **SHAPE))


def random_state(info, seed: int) -> dict:
    """A batch-3 row state of the port's keys and shapes, drawn from a
    seed (f32)."""
    rng = np.random.default_rng(seed)
    init = get_version_module(info.version).init_state(info, 3)
    return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in init.items()}


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("b", [0, 2])
def test_pack_equals_jax(version, b):
    info, jinfo = infos(version)
    state = random_state(info, seed=1 + b)
    got = packing.pack_state(info, state, batch_index=b)
    want = jpacking.pack_state(jinfo, state, batch_index=b)
    assert got.shape == packing.state_shape(info)[:3] == want.shape
    np.testing.assert_array_equal(got, want)
    # Tensors (a row state as the engine holds it) pack the same.
    torch_state = {k: torch.from_numpy(v) for k, v in state.items()}
    np.testing.assert_array_equal(
        packing.pack_state(info, torch_state, batch_index=b), want)


@pytest.mark.parametrize("version", VERSIONS)
def test_unpack_equals_jax_and_round_trips(version):
    info, jinfo = infos(version)
    rng = np.random.default_rng(5)
    flat = rng.standard_normal(packing.state_shape(info)).astype(np.float32)
    got = packing.unpack_state(info, flat.reshape(-1))
    want = jpacking.unpack_state(jinfo, flat)
    init = get_version_module(info.version).init_state(info, 1)
    assert set(got) == set(want) == set(init)
    for k in got:
        assert got[k].shape == tuple(init[k].shape), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(packing.pack_state(info, got),
                                  flat[..., 0])


@pytest.mark.parametrize("version", ["V5", "V6", "V7"])
@pytest.mark.parametrize("key", ["blocks.{i}.att.time_state",
                                 "blocks.{i}.time_state"])
def test_state_tuning_file_equals_jax(tmp_path, version, key):
    info, jinfo = infos(version)
    H, N = info.num_head, info.head_size
    rng = np.random.default_rng(7)
    ts = rng.standard_normal((info.num_layer, H, N, N)).astype(
        np.float32) * 0.3
    path = str(tmp_path / "tuned.state")
    # Stored transposed, as the converter stores time_state.
    jloader.save_safetensors(
        {key.format(i=i): np.swapaxes(ts[i], -1, -2)
         for i in range(info.num_layer)}, path, dtype=np.float32)
    got = packing.load_state_file(info, path)
    want = jpacking.load_state_file(jinfo, path)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    wkv = ts if version != "V7" else np.swapaxes(ts, -1, -2)
    np.testing.assert_array_equal(got["wkv"][:, 0], wkv)
    assert not got["att_x"].any() and not got["ffn_x"].any()


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("ext", [".state", ".pth"])
def test_packed_state_file_equals_jax(tmp_path, version, ext):
    info, jinfo = infos(version)
    rng = np.random.default_rng(11)
    flat = rng.standard_normal(packing.state_shape(info)[:3]).astype(
        np.float32)
    path = str(tmp_path / f"packed{ext}")
    if ext == ".pth":
        torch.save({"state": torch.from_numpy(flat)}, path)
    else:
        jloader.save_safetensors({"state": flat}, path, dtype=np.float32)
    got = packing.load_state_file(info, path)
    want = jpacking.load_state_file(jinfo, path)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(packing.pack_state(info, got), flat)


def test_state_file_without_a_state_is_refused(tmp_path):
    info, _ = infos("V7")
    path = str(tmp_path / "empty.state")
    jloader.save_safetensors({"blocks.0.att.time_state": np.zeros(
        (16, 16, 2), np.float32)}, path, dtype=np.float32)
    with pytest.raises(ValueError, match="missing time_state for layer 1"):
        packing.load_state_file(info, path)


def test_v4_state_tuning_file_is_refused(tmp_path):
    """Divergence: RWKV-4 has no time_state; the port refuses such a file
    instead of building a ``wkv`` entry."""
    info, _ = infos("V4")
    path = str(tmp_path / "v4.state")
    jloader.save_safetensors({f"blocks.{i}.att.time_state": np.zeros(
        (1, 1, 32), np.float32) for i in range(2)}, path, dtype=np.float32)
    with pytest.raises(ValueError, match="v4.state"):
        packing.load_state_file(info, path)
