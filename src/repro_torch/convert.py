"""Turn JAX-package state, given as numpy arrays, into the port's objects.

The JAX package regenerates its incoherence transforms from seeds with
``jax.random``; the port cannot, so a caller that has the reference
objects extracts their arrays — packed codes, ``s``, ``D``, norms, the
embedding and every transform's ``A``/``B``/``signs``/``perm`` — as numpy
and hands them here.  Nothing in this module imports JAX.

Quantized state (:func:`quantized_model_from_numpy`) is a tree::

    {"embed": {"tok": ..., "head": ...}, "final_norm": {"scale": ...},
     "blocks": [{"ln1": {"scale": ...}, "ln2": {...}, "q_norm": ...,
                 "k_norm": ..., "attn.wq": LINEAR, ...}, ...]}

with ``LINEAR = {"packed", "s", "D" (optional), "bits", "m", "n", "maxq",
"U": TRANSFORM, "V": TRANSFORM}`` and ``TRANSFORM = {"kind", "n", "A",
"B", "signs", "perm"}`` (absent factors as None).  fp params
(:func:`fp_params_from_numpy`) are the JAX package's ``model.init`` tree
of any ported family, layers stacked along axis 0.

Training keeps that stacked layout: :func:`stack_layers` turns the port's
per-layer lists into one tensor per leaf with a leading layer axis (the
JAX package's ``model.init`` tree, so optimizer state and checkpoints
have its leaves, keys and shapes), and :func:`layer_views` hands the
forward per-layer views of it without copying.  :func:`stack_axes`,
:func:`stack_cache` and :func:`stack_cache_axes` do the same for a
param-axes tree, a cache and a cache-axes tree (the dry run's byte
accounting, and the comparison with the JAX package's ``eval_shape``s).
:func:`shard_params` and :func:`gather_params` move a stacked tree between
its logical tensors and one rank's blocks under a spec tree (a training
mesh's storage layout, ``runtime/train_mesh.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import incoherence as inc
from repro_torch.core.quantizer import QuantizedLinear
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.quantize import QuantizedModel

__all__ = [
    "transform_from_numpy",
    "linear_from_numpy",
    "quantized_model_from_numpy",
    "fp_params_from_numpy",
    "stack_layers",
    "stack_shard",
    "layer_views",
    "stack_axes",
    "stack_cache",
    "stack_cache_axes",
    "local_block",
    "shard_params",
    "gather_params",
    "write_port_artifact",
]


def _t(a, device, dtype=None):
    if a is None:
        return None
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through fp32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return (t if dtype is None else t.to(dtype)).to(device)


def transform_from_numpy(d: dict,
                         device=DEFAULT_DEVICE) -> inc.OrthogonalTransform:
    device = resolve_device(device)
    return inc.OrthogonalTransform(
        d["kind"], int(d["n"]),
        _t(d.get("A"), device, torch.float32),
        _t(d.get("B"), device, torch.float32),
        _t(d.get("signs"), device, torch.float32),
        _t(d.get("perm"), device, torch.int64),
    )


def linear_from_numpy(d: dict, device=DEFAULT_DEVICE) -> QuantizedLinear:
    device = resolve_device(device)
    state = inc.PreprocessState(
        U=transform_from_numpy(d["U"], device),
        V=transform_from_numpy(d["V"], device),
        D=_t(d.get("D"), device, torch.float32),
        s=_t(d["s"], device, torch.float32),
        maxq=int(d["maxq"]),
    )
    return QuantizedLinear(
        _t(d["packed"], device, torch.int32), int(d["bits"]), int(d["m"]),
        int(d["n"]), state, use_kernel=bool(d.get("use_kernel", False)),
    )


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _t(x, device)


def quantized_model_from_numpy(arch_config: dict, tree: dict,
                               device=DEFAULT_DEVICE) -> QuantizedModel:
    device = resolve_device(device)
    cfg = ArchConfig.from_dict(arch_config)
    blocks = []
    for blk in tree["blocks"]:
        out = {}
        for name, val in blk.items():
            if isinstance(val, dict) and "packed" in val:
                out[name] = linear_from_numpy(val, device)
            else:
                out[name] = _tree(val, device)
        blocks.append(out)
    return QuantizedModel(cfg=cfg, embed=_tree(tree["embed"], device),
                          final_norm=_tree(tree["final_norm"], device),
                          blocks=blocks)


# the JAX package's layer stacks (leading axis = layer), unstacked here
_STACKED = ("layers", "mamba_layers", "enc_layers", "dec_layers",
            "self_layers", "cross_layers")


def fp_params_from_numpy(params: dict, device=DEFAULT_DEVICE) -> dict:
    """The JAX package's ``model.init`` tree of any ported family -> the
    port's tree: ``layers`` (dense, moe, rwkv), ``mamba_layers``
    (hybrid), ``enc_layers`` and ``dec_layers`` (encdec), ``self_layers``
    and ``cross_layers`` (vlm) become lists of per-layer dicts, everything
    else keeps its shape.  A packed ``weight_bits`` leaf ``{"packed", "scale"}`` keeps its
    int32 words and fp32 scale."""
    device = resolve_device(device)
    out = {}
    for key, val in params.items():
        if key in _STACKED:
            n = len(next(iter(_leaves(val))))
            out[key] = [_index(val, i, device) for i in range(n)]
        else:
            out[key] = _tree(val, device)
    return out


def stack_layers(params: dict) -> dict:
    """The port's param tree -> the JAX package's layout: each key of
    ``_STACKED`` (a list of per-layer dicts) becomes one dict whose every
    leaf is the layers' leaves stacked along a new axis 0 (one copy);
    everything else is kept as it is."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lp[k] for lp in layers]) for k in layers[0]}
        return torch.stack(layers)

    return {k: stack(v) if k in _STACKED else v for k, v in params.items()}


def layer_views(params: dict) -> dict:
    """The stacked layout -> the port's: each key of ``_STACKED`` becomes
    a list of per-layer dicts of views ``t[i]`` (``torch.unbind``: no copy,
    and autograd stacks the layers' gradients into the stacked leaf in
    one step)."""
    def unstack(x):
        if isinstance(x, dict):
            cols = {k: unstack(v) for k, v in x.items()}
            n = len(next(iter(cols.values())))
            return [{k: c[i] for k, c in cols.items()} for i in range(n)]
        return torch.unbind(x)

    return {k: unstack(v) if k in _STACKED else v for k, v in params.items()}


def _prefix_layers(axes):
    if isinstance(axes, dict):
        return {k: _prefix_layers(v) for k, v in axes.items()}
    return ("layers", *axes)


def stack_axes(axes: dict) -> dict:
    """The port's param axes (one per-layer dict for each key of
    ``_STACKED``) -> the JAX package's: a leading ``"layers"`` axis on
    every leaf of those keys."""
    return {k: _prefix_layers(v) if k in _STACKED else v
            for k, v in axes.items()}


def stack_cache(cache):
    """The port's cache (per-layer lists of dicts, or a dict of such
    lists) -> the JAX package's stacked layout: each list becomes one
    dict whose leaves are the layers' stacked along a new axis 0 (one
    copy; meant for ``meta`` caches and small ones)."""
    if isinstance(cache, list):
        return {k: torch.stack([c[k] for c in cache]) for k in cache[0]}
    return {k: stack_cache(v) for k, v in cache.items()}


def stack_cache_axes(axes: dict) -> dict:
    """The port's cache axes (one layer's) -> the JAX package's: every
    cache leaf is stacked, so every leaf gains a leading ``"layers"``."""
    return _prefix_layers(axes)


def _blocks(tree, specs, fn):
    if tree is None:  # no leaf (adafactor's column moment of a 1-D leaf)
        return None
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks(v, specs[i], fn) for i, v in enumerate(tree))
    return fn(tree, specs)


def local_block(a, spec, ctx):
    """This rank's block of ``a`` (a tensor or a numpy array; a view)
    under ``spec``: each dim a mesh axis shards cut to
    ``ctx.local_range``."""
    for d, ax in enumerate(spec):
        if ax is not None:
            lo, hi = ctx.local_range(a.shape[d], ax)
            a = a[(slice(None),) * d + (slice(lo, hi),)]
    return a


def shard_params(tree, ctx, specs):
    """Each logical leaf of ``tree`` -> this rank's block of it (a copy)
    under its spec in ``specs`` (``runtime.sharding.param_shardings``)."""
    return _blocks(tree, specs,
                   lambda t, spec: local_block(t, spec, ctx).clone())


def stack_shard(params: dict, ctx, specs) -> dict:
    """``shard_params(stack_layers(params), ctx, specs)`` one leaf at a
    time, each whole leaf (and its layers' slices) released as its block
    is cut: a rank drawing the whole init holds it once, not twice.
    Consumes ``params`` (its entries are removed)."""
    def take(src, spec):
        if isinstance(src, dict):
            return {k: take(src.pop(k), spec[k]) for k in sorted(src)}
        if isinstance(src, list):  # a layer list: stack one leaf at a time
            if isinstance(src[0], dict):
                return {k: take([lp.pop(k) for lp in src], spec[k])
                        for k in sorted(src[0])}
            whole = torch.stack(src)
            src.clear()
        else:
            whole = src
        return local_block(whole, spec, ctx).clone()

    return {k: take(params.pop(k), specs[k]) for k in sorted(params)}


def gather_params(tree, ctx, specs, *, to=None):
    """Each block of ``tree`` (this rank's, under ``specs``) -> the logical
    leaf, all-gathered over the mesh axes of its spec (``ctx.comm`` for
    ``model``, ``ctx.data_comm`` for ``data``): every rank takes part and
    every rank gets it.  ``to`` moves each gathered leaf as it is made
    (``"cpu"``; ``"meta"`` keeps only its shape)."""
    def whole(t, spec):
        for d, ax in enumerate(spec):
            if ax is not None:
                comm = ctx.comm if ax == "model" else ctx.data_comm
                t = comm.gather_dim(t, d)
        return t if to is None else t.to(to)

    return _blocks(tree, specs, whole)


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def _index(x, i, device):
    if isinstance(x, dict):
        return {k: _index(v, i, device) for k, v in x.items()}
    return _t(np.asarray(x)[i], device)


def write_port_artifact(directory, arch_config: dict, tree: dict,
                        quip_config: dict, extra_meta=None):
    """Convert quantized numpy state and write it as a port artifact (the
    conversion stays on the host: the arrays go straight to disk)."""
    from repro_torch.serve.artifacts import save_quantized

    qm = quantized_model_from_numpy(arch_config, tree, device="cpu")
    return save_quantized(directory, qm, quip_config, extra_meta=extra_meta)
