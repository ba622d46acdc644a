"""The port's checkpoint manager and the substrate behaviours of
``tests/test_substrates.py`` (optimizer, schedule, compression,
checkpoints), on the CPU.

The checkpoint contract is the reference's: atomic tmp-then-rename saves,
a CRC per leaf in the manifest, fall-back to the previous valid checkpoint,
async save from a host snapshot, ``keep``; bf16 leaves round-trip bit for
bit.
"""

import json

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, compress_int8,
                               decompress_int8, warmup_cosine)


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.3, weight_decay=0.0)
    for _ in range(200):
        params, state, _ = adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert params["w"].abs().max().item() < 0.1
    assert int(state["step"]) == 200


def test_grad_clip_applies():
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    new, _, m = adamw_update(params, {"w": torch.ones(3) * 1e6}, state,
                             AdamWConfig(lr=0.0, grad_clip=1.0))
    assert m["grad_norm"].item() > 1e5  # the raw norm is reported
    assert torch.equal(new["w"], params["w"])


@given(st.integers(0, 5000))
@settings(max_examples=20, deadline=None)
def test_warmup_cosine_bounds(step):
    v = warmup_cosine(step, warmup=100, total=5000, min_ratio=0.1)
    assert 0.0 <= v <= 1.0


def test_compress_int8_error_feedback_reduces_bias():
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 0.01
    q, s, err = compress_int8(g)
    est1 = decompress_int8(q, s)
    q2, s2, _ = compress_int8(g, err)
    est2 = (est1 + decompress_int8(q2, s2)) / 2
    assert (est2 - g).abs().mean().item() < (est1 - g).abs().mean().item()


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3), "b/c": torch.ones(4),
            "h": (torch.randn(5, 7, generator=torch.Generator().manual_seed(1)) * 1e3
                  ).to(torch.bfloat16),
            "step": torch.tensor(17, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (10, 20, 30):
        mgr.save(s, tree, metadata={"loss": s * 1.0})
    assert mgr.steps() == [20, 30]  # keep=2 collected step 10
    restored, step, meta = mgr.restore(tree)
    assert step == 30 and meta["loss"] == 30.0
    for k, t in tree.items():
        assert restored[k].dtype == t.dtype and restored[k].shape == t.shape
        assert torch.equal(restored[k], t), k
    assert not list(tmp_path.glob("tmp.*"))


def test_checkpoint_bf16_is_lossless_and_crc_in_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    manifest = json.loads((tmp_path / "ckpt_00000001" / "manifest.json").read_text())
    leaves = {leaf["name"]: leaf for leaf in manifest["leaves"]}
    assert leaves["h"]["dtype"] == "bfloat16" and leaves["h"]["shape"] == [5, 7]
    assert all(isinstance(leaf["crc"], int) for leaf in leaves.values())
    restored, _, _ = mgr.restore({"h": torch.zeros(5, 7, dtype=torch.bfloat16)})
    assert torch.equal(restored["h"].view(torch.int16), tree["h"].view(torch.int16))


def test_checkpoint_corruption_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    tree = {"a": torch.arange(4.0)}
    mgr.save(1, tree)
    mgr.save(2, tree)
    (tmp_path / "ckpt_00000002" / "arrays.npz").write_bytes(b"garbage")
    _, step, _ = mgr.restore(tree)
    assert step == 1


def test_checkpoint_crc_and_shape_mismatch_fall_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"a": torch.arange(4.0)})
    mgr.save(2, {"a": torch.arange(4.0) + 1})
    manifest = tmp_path / "ckpt_00000002" / "manifest.json"
    doc = json.loads(manifest.read_text())
    doc["leaves"][0]["crc"] ^= 1
    manifest.write_text(json.dumps(doc))
    restored, step, _ = mgr.restore({"a": torch.zeros(4)})
    assert step == 1 and torch.equal(restored["a"], torch.arange(4.0))
    assert mgr.restore({"a": torch.zeros(5)}) is None  # no checkpoint has that shape
    assert mgr.restore({"missing": torch.zeros(4)}) is None


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = torch.ones((32, 32))
    mgr.save_async(5, {"a": t})
    t.mul_(3)  # after the snapshot: not in the checkpoint
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _, _ = mgr.restore({"a": torch.zeros(32, 32)})
    assert torch.equal(restored["a"], torch.ones(32, 32))


def test_checkpoint_restore_step_and_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "new"))
    assert mgr.latest_step() is None and mgr.restore({"a": torch.zeros(1)}) is None
    for s in (3, 4):
        mgr.save(s, {"a": torch.full((1,), float(s))})
    restored, step, _ = mgr.restore({"a": torch.zeros(1)}, step=3)
    assert step == 3 and restored["a"].item() == 3.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.int8])
def test_checkpoint_dtypes_roundtrip(tmp_path, dtype):
    mgr = CheckpointManager(str(tmp_path))
    t = (torch.arange(-6, 6) * 3).to(dtype)
    mgr.save(1, {"x": t})
    restored, _, _ = mgr.restore({"x": torch.zeros(12, dtype=dtype)})
    assert restored["x"].dtype == dtype and torch.equal(restored["x"], t)
