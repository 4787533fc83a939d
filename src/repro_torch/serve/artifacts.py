"""Persistent quantized artifacts in the port's format.

The layout is the JAX package's (``<dir>/step_00000000/shard_*.npz +
manifest.json``, array keys ``embed/tok``, ``final_norm/scale``,
``blocks/<i>/<ln1|ln2|q_norm|k_norm>...`` and
``blocks/<i>/<linear>/{packed,s,D}``) plus the materialized transform
factors ``blocks/<i>/<linear>/<U|V>/{A,B,signs,perm}``: the JAX package
stores only ``(kind, n, seed)`` and regenerates the factors with
``jax.random``, which torch cannot reproduce.  A JAX-package artifact
therefore goes through :mod:`repro_torch.convert` first.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import ArtifactCorruption, load_arrays, save_arrays
from repro_torch.configs.base import ArchConfig
from repro_torch.core import incoherence as inc
from repro_torch.core.quantizer import QuantizedLinear
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.quantize import QuantizedModel

__all__ = [
    "save_quantized",
    "load_quantized",
    "linear_from_arrays",
    "ArtifactCorruption",
    "ARTIFACT_FORMAT",
]

# the JAX package writes format 1 (transforms as seeds); the port's format
# carries the factors
ARTIFACT_FORMAT = "repro_torch/1"
_NORM_KEYS = ("ln1", "ln2", "q_norm", "k_norm")


def _np(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), True
    return t.numpy(), False


def save_quantized(directory, qm: QuantizedModel, quip_config, *,
                   extra_meta: Optional[dict] = None) -> pathlib.Path:
    """Persist a :class:`QuantizedModel` whose linears are
    :class:`QuantizedLinear`.  ``quip_config`` (a ``QuipConfig``, recorded
    field by field as the JAX package records it, or a dict recorded as
    given) and ``extra_meta`` (the quantize driver passes ``stats``,
    ``seed``, ``smoke`` and the ``quality`` section) go into the
    manifest."""
    arrays: dict[str, torch.Tensor] = {}
    for k, v in qm.embed.items():
        arrays[f"embed/{k}"] = v
    for k, v in qm.final_norm.items():
        arrays[f"final_norm/{k}"] = v
    linear_meta: dict[str, dict] = {}
    for i, blk in enumerate(qm.blocks):
        for name, val in blk.items():
            if isinstance(val, QuantizedLinear):
                pre = f"blocks/{i}/{name}"
                arrays[f"{pre}/packed"] = val.packed
                arrays[f"{pre}/s"] = val.s
                if val.D is not None:
                    arrays[f"{pre}/D"] = val.D
                meta = {"bits": val.bits, "m": val.m, "n": val.n,
                        "maxq": val.maxq, "use_kernel": val.use_kernel}
                for side in ("U", "V"):
                    t = val.transform(side)
                    meta[side] = {"kind": t.kind, "n": t.n}
                    for key, arr in t.tensors().items():
                        arrays[f"{pre}/{side}/{key}"] = arr
                linear_meta[f"{i}/{name}"] = meta
            elif isinstance(val, dict):
                for k, v in val.items():
                    arrays[f"blocks/{i}/{name}/{k}"] = v
            else:
                arrays[f"blocks/{i}/{name}"] = val
    out, bf16 = {}, []
    for key, t in arrays.items():
        out[key], is_bf16 = _np(t)
        if is_bf16:
            bf16.append(key)
    meta = {
        "kind": "quip_quantized_model",
        "format": ARTIFACT_FORMAT,
        "arch_config": dataclasses.asdict(qm.cfg),
        "quip_config": (dataclasses.asdict(quip_config)
                        if dataclasses.is_dataclass(quip_config)
                        else dict(quip_config)),
        "n_blocks": len(qm.blocks),
        "linears": linear_meta,
        **(extra_meta or {}),
    }
    return save_arrays(directory, 0, out, extra_meta=meta,
                       bf16_keys=tuple(bf16))


def linear_from_arrays(arrays: dict, meta: dict) -> QuantizedLinear:
    """Rebuild a QuantizedLinear from its arrays (torch) and metadata."""

    def transform(side: str) -> inc.OrthogonalTransform:
        tm = meta[side]
        get = lambda k: arrays.get(f"{side}/{k}")
        perm = get("perm")
        return inc.OrthogonalTransform(
            tm["kind"], tm["n"], get("A"), get("B"), get("signs"),
            None if perm is None else perm.to(torch.int64),
        )

    state = inc.PreprocessState(
        U=transform("U"), V=transform("V"), D=arrays.get("D"),
        s=arrays["s"], maxq=meta["maxq"],
    )
    return QuantizedLinear(arrays["packed"], meta["bits"], meta["m"],
                           meta["n"], state,
                           use_kernel=meta.get("use_kernel", False))


def load_quantized(directory, *, device=DEFAULT_DEVICE, verify: bool = True,
                   faults=None, placer=None):
    """-> (QuantizedModel, meta), every tensor on ``device`` (the card
    unless the caller asks for ``"cpu"``).  ``verify`` checks shard SHA-256
    digests (mismatch: :class:`ArtifactCorruption`).  ``faults``: an
    optional :class:`~repro_torch.serve.faults.FaultPlan` whose armed
    ``corrupt_shard`` rules force digest mismatches.  ``placer(key,
    host_tensor)``, if given, places each leaf instead (the tensor-parallel
    loader keeps packed codes on the host to slice them there)."""
    device = resolve_device(device)
    corrupt = faults.corrupt_shards() if faults is not None else ()
    arrays, _step, meta, bf16_keys = load_arrays(
        directory, verify=verify, _corrupt_shards=corrupt)
    if meta.get("kind") != "quip_quantized_model":
        raise ValueError(
            f"{directory} is not a quantized artifact "
            f"(manifest kind={meta.get('kind')!r})"
        )
    if meta.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"{directory} has artifact format {meta.get('format')!r}, not "
            f"{ARTIFACT_FORMAT!r}: a JAX-package artifact stores its "
            "transforms as seeds; convert it with repro_torch.convert"
        )
    cfg = ArchConfig.from_dict(meta["arch_config"])

    def tensor(key: str) -> torch.Tensor:
        t = torch.from_numpy(arrays[key])
        if key in bf16_keys:
            t = t.view(torch.bfloat16)
        return t.to(device) if placer is None else placer(key, t)

    def subtree(prefix: str) -> dict:
        plen = len(prefix)
        return {k[plen:]: tensor(k) for k in arrays if k.startswith(prefix)}

    blocks = []
    for i in range(meta["n_blocks"]):
        blk: dict = {}
        for norm in _NORM_KEYS:
            sub = subtree(f"blocks/{i}/{norm}/")
            if sub:
                blk[norm] = sub
            elif f"blocks/{i}/{norm}" in arrays:  # bare array (q/k_norm)
                blk[norm] = tensor(f"blocks/{i}/{norm}")
        for lkey, lmeta in meta["linears"].items():
            idx, name = lkey.split("/", 1)
            if int(idx) == i:
                blk[name] = linear_from_arrays(
                    subtree(f"blocks/{i}/{name}/"), lmeta)
        blocks.append(blk)
    qm = QuantizedModel(
        cfg=cfg, embed=subtree("embed/"), final_norm=subtree("final_norm/"),
        blocks=blocks, stats=meta.get("stats", []),
    )
    return qm, meta
