"""Checkpoint store: atomic npz shards + manifest with per-shard SHA-256.

Layout per step (the JAX package's format)::

    <dir>/step_000123.tmp-<nonce>/   (write everything, fsync)
        shard_00000.npz ... shard_NNNNN.npz
        manifest.json                (leaf->shard map, digests, meta)
    <dir>/step_000123/               (atomic rename when complete)

numpy I/O only, and numpy has no bfloat16.  Two encodings of a bf16 leaf
exist, both its raw 16 bits:

* :func:`save_arrays` (the port's artifacts) stores int16 and lists the
  key in the manifest under ``bf16_keys``; :func:`load_arrays` hands back
  int16 for it and the caller reinterprets
  (``torch.from_numpy(a).view(torch.bfloat16)``);
* :func:`save_checkpoint` (train state) stores a ``|V2`` array, the bytes
  that the JAX package's ``np.savez`` of an ``ml_dtypes`` bf16 leaf
  writes, so a bf16 leaf reads the same from either package's files.

:func:`load_checkpoint` reads both.  fp32 checkpoints move both ways
between the packages; bf16 ones only from the JAX package to the port,
because the JAX ``load_checkpoint`` cannot cast a ``|V2`` leaf (it raises
``No cast function available``, on its own bf16 checkpoints too).

The tree API (:func:`save_checkpoint`, :func:`load_checkpoint`,
:class:`CheckpointManager`) keys every leaf as the JAX package does
(``repro_torch.tree.flatten_with_paths``: ``/``-joined sorted dict keys
and sequence indices, ``None`` skipped), so a train state in the JAX
package's stacked layout round-trips between the packages leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.tree import flatten_with_paths, unflatten

__all__ = ["ArtifactCorruption", "CheckpointManager", "save_arrays",
           "load_arrays", "save_checkpoint", "load_checkpoint",
           "latest_step"]

_MANIFEST = "manifest.json"


class ArtifactCorruption(ValueError):
    """A checkpoint shard's bytes do not match its manifest digest."""

    def __init__(self, shard: int, path, expected: str, actual: str):
        self.shard = shard
        self.path = str(path)
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"checkpoint shard {shard} corrupt: {path} sha256 "
            f"{actual[:12]}… does not match manifest {expected[:12]}…")


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_arrays(
    directory,
    step: int,
    arrays: dict[str, np.ndarray],
    *,
    shard_mb: int = 512,
    extra_meta: Optional[dict] = None,
    bf16_keys: tuple = (),
) -> pathlib.Path:
    """Write one checkpoint of flat ``path -> array`` leaves atomically;
    returns the final path."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp-{os.getpid()}-{int(time.time()*1e3)}"
    tmp.mkdir(parents=True)

    shard_bytes = shard_mb * 1024 * 1024
    shards: list[dict] = []
    cur: dict = {}
    cur_size = 0
    leaf_to_shard: dict = {}
    for key, arr in arrays.items():
        arr = np.asarray(arr)
        if cur_size + arr.nbytes > shard_bytes and cur:
            shards.append(cur)
            cur, cur_size = {}, 0
        cur[key] = arr
        cur_size += arr.nbytes
        leaf_to_shard[key] = len(shards)
    if cur:
        shards.append(cur)

    for i, shard in enumerate(shards):
        # npz keys cannot contain '/': encode
        enc = {k.replace("/", "::"): v for k, v in shard.items()}
        path = tmp / f"shard_{i:05d}.npz"
        with open(path, "wb") as f:
            np.savez(f, **enc)
            f.flush()
            os.fsync(f.fileno())

    manifest = {
        "step": step,
        "format": 1,
        "n_shards": len(shards),
        "leaf_to_shard": leaf_to_shard,
        "shard_digests": [
            _sha256(tmp / f"shard_{i:05d}.npz") for i in range(len(shards))
        ],
        "bf16_keys": sorted(bf16_keys),
        "time": time.time(),
        "meta": extra_meta or {},
    }
    with open(tmp / _MANIFEST, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and ".tmp" not in p.name:
            if (p / _MANIFEST).exists():  # complete checkpoints only
                steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _manifest(directory, step: Optional[int]):
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step:08d}"
    return path, step, json.loads((path / _MANIFEST).read_text())


def _shards(path: pathlib.Path, manifest: dict, verify: bool,
            corrupt=()):
    """Each shard's ``{key: array}`` in turn, its digest checked first."""
    digests = manifest.get("shard_digests")
    if verify and digests is None:
        warnings.warn(
            f"{path} manifest predates shard checksums; loading unverified",
            stacklevel=3)
    for i in range(manifest["n_shards"]):
        spath = path / f"shard_{i:05d}.npz"
        if verify and digests is not None:
            actual = _sha256(spath)
            if i in corrupt:
                actual = "0" * 64
            if actual != digests[i]:
                raise ArtifactCorruption(i, spath, digests[i], actual)
        with np.load(spath) as z:
            yield {k.replace("::", "/"): z[k] for k in z.files}


def load_arrays(
    directory, *, step: Optional[int] = None, verify: bool = True,
    _corrupt_shards=(),
) -> tuple[dict[str, np.ndarray], int, dict, set]:
    """Load a checkpoint as a flat ``path -> array`` dict.

    ``verify``: check each shard's SHA-256 against the manifest and raise
    :class:`ArtifactCorruption` on mismatch; manifests written before
    digests existed load with a warning.  ``_corrupt_shards`` is the
    fault-injection hook: listed shard indices are treated as if their
    bytes had rotted (see serve/faults.py).  Returns (arrays, step, meta,
    bf16_keys)."""
    path, step, manifest = _manifest(directory, step)
    arrays: dict[str, np.ndarray] = {}
    for shard in _shards(path, manifest, verify, _corrupt_shards):
        arrays.update(shard)
    return (arrays, step, manifest.get("meta", {}),
            set(manifest.get("bf16_keys", ())))


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _from_numpy(key: str, a: np.ndarray, raw_bf16: bool) -> torch.Tensor:
    if raw_bf16 or a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise ValueError(f"leaf {key!r}: raw {a.dtype} is not a bf16 "
                             f"leaf")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(directory, step: int, tree: Any, *, shard_mb: int = 512,
                    extra_meta: Optional[dict] = None) -> pathlib.Path:
    """Write one train-state checkpoint atomically (leaves keyed as the JAX
    package keys them, bf16 as ``|V2``); returns the final path."""
    arrays = {k: _to_numpy(v) for k, v in flatten_with_paths(tree)}
    return save_arrays(directory, step, arrays, shard_mb=shard_mb,
                       extra_meta=extra_meta)


def load_checkpoint(directory, like: Any, *, step: Optional[int] = None,
                    device=DEFAULT_DEVICE, block=None) -> tuple[Any, int, dict]:
    """Restore a tree of ``like``'s structure (tensors, or ``meta``
    tensors: only their dtypes are read), each leaf cast to its ``like``
    leaf's dtype on ``device``; a bf16 leaf stored as raw 16 bits comes
    back bit for bit.  ``step`` None takes the newest complete step.
    ``block(key, array)``, if given, cuts each logical leaf to the part
    this process keeps (a mesh rank's block) before it leaves the host;
    the shards are read one at a time.  Returns (tree, step, meta)."""
    device = resolve_device(device)
    path, step, manifest = _manifest(directory, step)
    bf16_keys = set(manifest.get("bf16_keys", ()))
    want = dict(flatten_with_paths(like))
    leaves = {}
    for shard in _shards(path, manifest, verify=True):
        for key, a in shard.items():
            if key not in want:
                continue
            if block is not None:
                a = block(key, a).copy()  # drops the rest of the leaf
            t = _from_numpy(key, a, key in bf16_keys)
            leaves[key] = t.to(device=device, dtype=want[key].dtype)
    missing = [k for k in want if k not in leaves]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]!r}")
    return unflatten(like, leaves), step, manifest.get("meta", {})


@dataclasses.dataclass
class CheckpointManager:
    """keep-k policy + convenience wrapper used by the train driver."""

    directory: str
    keep: int = 3
    save_every: int = 50

    def due(self, step: int) -> bool:
        return step % self.save_every == 0

    def maybe_save(self, step: int, tree: Any,
                   **meta) -> Optional[pathlib.Path]:
        if not self.due(step):
            return None
        return self.save(step, tree, **meta)

    def save(self, step: int, tree: Any, **meta) -> pathlib.Path:
        p = save_checkpoint(self.directory, step, tree, extra_meta=meta)
        self.gc()
        return p

    def gc(self):
        d = pathlib.Path(self.directory)
        if not d.exists():
            return
        steps = sorted(
            int(p.name.split("_")[1])
            for p in d.iterdir()
            if p.is_dir() and p.name.startswith("step_") and ".tmp" not in p.name
            and (p / _MANIFEST).exists()
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(d / f"step_{s:08d}", ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for p in d.iterdir():
            if ".tmp-" in p.name:
                shutil.rmtree(p, ignore_errors=True)

    def restore_latest(self, like: Any, device=DEFAULT_DEVICE, block=None):
        return load_checkpoint(self.directory, like, device=device,
                               block=block)
