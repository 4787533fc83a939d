"""The port's tree checkpoint API (``save_checkpoint``, ``load_checkpoint``,
``CheckpointManager``) on its own and against the JAX package's store:
JAX-written checkpoints (bf16 ``|V2`` leaves among them) load into the
port bit for bit, port-written fp32 ones load into the JAX package, and
both packages write a bf16 leaf as the same bytes.  The JAX
``load_checkpoint`` cannot read any bf16 leaf, its own included
(ROADMAP reference caveat 11)."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro.checkpoint import store as ref_store
from repro_torch import optim as PO
from repro_torch.checkpoint.store import (ArtifactCorruption,
                                          CheckpointManager, latest_step,
                                          load_arrays, load_checkpoint,
                                          save_arrays, save_checkpoint)
from repro_torch.convert import stack_layers
from repro_torch.tree import flatten_with_paths, tree_map
from torch_parity import family_models


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(8, 16, generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32),
                   "c": torch.tensor(3.5),
                   "d": torch.randn(3, 5, generator=g).to(torch.bfloat16)},
        "mom": (torch.randn(4, generator=g), None),
    }


def _like(t):
    return tree_map(lambda x: torch.empty_like(x, device="meta"), t)


def _bits(x) -> np.ndarray:
    """A leaf of either package as its raw bits (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _assert_same_bits(got, want):
    """Equal keys (``flatten_with_paths`` walks JAX trees alike) and equal
    bits, leaf by leaf."""
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert list(g) == list(w)
    assert [k for k, _ in ref_store._flatten_with_paths(want)[0]] == list(w)
    for k in w:
        assert np.array_equal(_bits(g[k]), _bits(w[k])), k


# ---------------------------------------------------------------------------
# the port on its own (the JAX package's substrate cases among them)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 5, t, extra_meta={"note": "x"})
    restored, step, meta = load_checkpoint(tmp_path, _like(t), device="cpu")
    assert step == 5 and meta["note"] == "x"
    assert restored["mom"][1] is None
    for (k, a), (_, b) in zip(flatten_with_paths(restored),
                              flatten_with_paths(t)):
        assert a.dtype == b.dtype and a.device.type == "cpu", k
        assert torch.equal(a, b), k


def test_checkpoint_keys_and_bf16_encoding(tmp_path):
    p = save_checkpoint(tmp_path, 1, _tree())
    manifest = json.loads((p / "manifest.json").read_text())
    assert list(manifest["leaf_to_shard"]) == [
        "a", "mom/0", "nested/b", "nested/c", "nested/d"]
    assert manifest["bf16_keys"] == []
    arrays, _, _, _ = load_arrays(tmp_path)
    assert arrays["nested/d"].dtype == np.dtype("V2")


def test_checkpoint_casts_to_like_dtype(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 2, t)
    like = _like(t)
    like["a"] = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")
    like["nested"]["d"] = torch.empty(3, 5, device="meta")
    restored, _, _ = load_checkpoint(tmp_path, like, device="cpu")
    assert torch.equal(restored["a"], t["a"].to(torch.bfloat16))
    assert torch.equal(restored["nested"]["d"], t["nested"]["d"].float())


def test_checkpoint_reads_the_artifact_bf16_keys_encoding(tmp_path):
    w = torch.randn(4, 6).to(torch.bfloat16)
    save_arrays(tmp_path, 3, {"w": w.view(torch.int16).numpy()},
                bf16_keys=("w",))
    restored, _, _ = load_checkpoint(tmp_path, {"w": w}, device="cpu")
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))


def test_checkpoint_missing_leaf_and_corrupt_shard(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    like = {**_like(t), "extra": torch.empty(2, device="meta")}
    with pytest.raises(KeyError, match="extra"):
        load_checkpoint(tmp_path, like, device="cpu")
    shard = tmp_path / "step_00000001" / "shard_00000.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(ArtifactCorruption):
        load_checkpoint(tmp_path, _like(t), device="cpu")


def test_checkpoint_shards_split_and_load(tmp_path):
    t = {"x": torch.randn(300, 1024), "y": torch.randn(300, 1024),
         "z": torch.randn(7)}
    p = save_checkpoint(tmp_path, 4, t, shard_mb=1)
    manifest = json.loads((p / "manifest.json").read_text())
    assert manifest["n_shards"] == 3
    restored, _, _ = load_checkpoint(tmp_path, _like(t), device="cpu")
    for k in t:
        assert torch.equal(restored[k], t[k])


def test_checkpoint_latest_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=1)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, t)
    assert latest_step(tmp_path) == 4
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert CheckpointManager(str(tmp_path), save_every=3).maybe_save(
        4, t) is None
    restored, step, _ = mgr.restore_latest(_like(t), device="cpu")
    assert step == 4 and torch.equal(restored["a"], t["a"])


def test_checkpoint_crashed_writer_ignored(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    # a crashed writer: a stale tmp dir and a final dir without a manifest
    (tmp_path / "step_00000009.tmp-123").mkdir()
    (tmp_path / "step_00000007").mkdir()
    assert latest_step(tmp_path) == 1
    _, step, _ = load_checkpoint(tmp_path, _like(t), device="cpu")
    assert step == 1
    CheckpointManager(str(tmp_path), keep=3).gc()
    assert not list(tmp_path.glob("*.tmp-*"))
    assert (tmp_path / "step_00000001").exists()


def test_checkpoint_atomicity_no_partial_state(tmp_path):
    p = save_checkpoint(tmp_path, 3, _tree())
    assert (p / "manifest.json").exists()
    assert not list(tmp_path.glob("*.tmp-*"))


def test_restore_of_an_empty_directory_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore_latest(_like(_tree()),
                                                        device="cpu")


def test_load_to_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    save_checkpoint(tmp_path, 1, _tree())
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint(tmp_path, _like(_tree()))


# ---------------------------------------------------------------------------
# between the packages: the smoke train state in the stacked layout
# ---------------------------------------------------------------------------


def _states(dtype: str, opt: str):
    """The JAX smoke init and optimizer state, beside the port's state
    converted from it (the same values, stacked)."""
    _, rp, _, pp = family_models("qwen3-14b", dtype=dtype)
    ro, po = getattr(RO, opt)(1e-2), getattr(PO, opt)(1e-2)
    pp = stack_layers(pp)
    return {"params": rp, "opt": ro.init(rp)}, {"params": pp,
                                                "opt": po.init(pp)}


def _perturb(port_state):
    """Non-trivial state values (a fresh state's moments are zeros)."""
    g = torch.Generator().manual_seed(5)
    for _, x in flatten_with_paths(port_state):
        if x.is_floating_point():
            x.copy_(torch.randn(x.shape, generator=g).to(x.dtype))
    return port_state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_jax_checkpoint_loads_into_the_port_bit_for_bit(tmp_path, dtype,
                                                         opt):
    ref_state, port_state = _states(dtype, opt)
    ref_state = jax.tree.map(
        lambda x: (x + jnp.asarray(0.25, x.dtype)) * jnp.asarray(1.5, x.dtype),
        ref_state)  # moments away from zero
    ref_store.save_checkpoint(tmp_path, 7, ref_state, extra_meta={"k": 1})
    arrays, _, _ = ref_store.load_arrays(tmp_path)
    if dtype == "bfloat16":
        assert arrays["params/layers/attn/wq"].dtype == np.dtype("V2")
    got, step, meta = load_checkpoint(tmp_path, _like(port_state),
                                      device="cpu")
    assert step == 7 and meta == {"k": 1}
    assert got["params"]["layers"]["attn"]["wq"].dtype == getattr(torch,
                                                                  dtype)
    _assert_same_bits(got, ref_state)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_port_fp32_checkpoint_loads_into_jax(tmp_path, opt):
    ref_state, port_state = _states("float32", opt)
    port_state = _perturb(port_state)
    save_checkpoint(tmp_path, 3, port_state)
    got, step, _ = ref_store.load_checkpoint(tmp_path, ref_state)
    assert step == 3
    _assert_same_bits(port_state, got)


def test_both_packages_write_bf16_leaves_as_the_same_bytes(tmp_path):
    ref_state, port_state = _states("bfloat16", "adamw")
    ref_store.save_checkpoint(tmp_path / "jax", 1, ref_state)
    save_checkpoint(tmp_path / "port", 1, port_state)
    a, _, _ = ref_store.load_arrays(tmp_path / "jax")
    b, _, _, _ = load_arrays(tmp_path / "port")
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_reference_caveat_11_jax_cannot_load_bf16(tmp_path):
    """The JAX ``load_checkpoint`` casts each leaf with ``astype``, which
    numpy refuses for a ``|V2`` array — on the JAX package's own bf16
    checkpoints too; the port reads them."""
    ref_state, port_state = _states("bfloat16", "adamw")
    ref_store.save_checkpoint(tmp_path, 1, ref_state)
    with pytest.raises(ValueError, match="cast"):
        ref_store.load_checkpoint(tmp_path, ref_state)
    got, _, _ = load_checkpoint(tmp_path, _like(port_state), device="cpu")
    _assert_same_bits(got, ref_state)
