"""One rank of a ``(data, model)`` training mesh, and the plan that places
a model's train state on it.

**Storage layout.**  Parameters, gradients and optimizer state are stored
sharded by the mesh's rules (``default_rules``): each leaf of the stacked
train state (``convert.stack_layers``) is this rank's block under its spec
(``param_shardings``, with the divisibility fallback on the fused dims);
adafactor's row and column moments take the leaf's spec without its last
and without its next-to-last dim (:meth:`ShardPlan.state_specs`).

**Compute layout** (:meth:`ShardPlan.compute`, per microbatch, through
``runtime/collectives.py``).  The step computes Megatron-style over
``model`` only on whole heads, whole ``ff`` columns, whole experts and
whole vocab rows.  A leaf's region is the module that holds it
(:func:`_region`), the same in every family's tree:

  * ``act_heads`` — attention (``attn``, ``xattn``: every family's
    self-attention, whisper's and the vlm's cross attention, zamba2's
    shared block) is head-parallel where the query heads divide the axis:
    each rank attends its heads ``[r·H/mp, (r+1)·H/mp)`` and query head
    ``h`` meets KV head ``h // G``.  A KV shard of whole heads that are
    exactly those is used as it is; otherwise (a shard that splits a head,
    or KV heads that replicate) the rank's KV heads are taken from the
    whole ``wk``/``wv``.  RWKV6's time mix is head-parallel the same way
    (``wr wk wv wg`` columns and ``wo`` rows of its heads), its per-channel
    ``w0``, ``ln_x``, ``decay_B`` columns and per-head ``bonus`` sliced to
    the rank's heads;
  * ``act_ff`` — the MLP (``mlp``, the MoE's ``dense`` residual) and the
    channel mix's ``wk``/``wv`` are ``ff``-parallel;
  * ``act_experts`` — the MoE's ``wi wg wo`` are expert-parallel: each
    rank stores and computes its experts ``[r·E/mp, (r+1)·E/mp)``
    (``layers.moe_apply``); every rank routes every token (``router``);
  * ``vocab`` — the embedding and LM head are vocab-parallel;
  * a leaf outside these regions (norms, Mamba2, the gates applied after a
    sum: ``xattn.gate``, ``mlp_gate``, ``mlp.bo``, the channel mix's
    ``d_model``-wide ``wr`` gate and its token-shift mixes) computes whole
    on every rank.

Any other sharded dim is all-gathered for compute and its gradient goes
back as this rank's block: reduce-scattered where the ranks' uses were
parts of one computation (every ``data`` dim, whose ranks see different
rows; a ``model`` dim of a parallel region), sliced where every rank
computed the whole (a ``model`` dim of a replicated region or of a fused
output that cuts across its parts: Mamba2's ``in_proj`` ``[z, xBC, dt]``,
the channel mix's ``wr``).  A leaf that replicates computes whole on every
rank; in a parallel region its gradient is summed over ``model``.

The model code marks where activations change layout with
``runtime/sharding.py``'s ``constrain``, which asks the active plan
(:meth:`ShardPlan.parallel`).  Every family is planned on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.runtime import collectives as C
from repro_torch.runtime.process_group import Communicator, process_group
from repro_torch.runtime.sharding import (MeshContext, default_rules,
                                          param_shardings)

__all__ = ["TrainMesh", "ShardPlan", "connect_train_mesh", "spec_items"]

# module (the key that holds a leaf) -> the region it computes in
_REGIONS = {"attn": "act_heads", "xattn": "act_heads",
            "time_mix": "act_heads", "mlp": "act_ff", "dense": "act_ff",
            "channel_mix": "act_ff", "moe": "act_experts", "embed": "vocab"}
# leaves of those modules that act outside the parallel part: applied
# after its sum (the gates, ``bo``), or before the point where its input
# feeds it (the channel mix's token-shift mixes and its whole-width gate)
_OUTSIDE = {("attn", "gate"), ("xattn", "gate"), ("mlp", "bo"),
            ("dense", "bo"), ("channel_mix", "mu_k"),
            ("channel_mix", "mu_r"), ("channel_mix", "wr")}
# the attention's K/V leaves: whole heads of their own, or taken from the
# whole leaf for the rank's query heads
_ATTN = ("attn", "xattn")
_KV = ("wk", "wv", "bk", "bv")
# the time mix's whole leaves used on the rank's channels only: the dim
# cut to the rank's heads
_SLICED = {"w0": -1, "ln_x": -1, "decay_B": -1, "bonus": -2}


def _region(path: tuple) -> Optional[str]:
    """The split dim of the computation a leaf takes part in, or None
    (computed whole on every rank), from the module that holds it."""
    module, leaf = str(path[-2]), str(path[-1])
    if (module, leaf) in _OUTSIDE:
        return None
    return _REGIONS.get(module)


@dataclasses.dataclass(eq=False)
class TrainMesh(MeshContext):
    """One process's view of a ``(data, model)`` training mesh: ``comm``
    over its model row, ``data_comm`` over its data column, ``control`` a
    communicator on host tensors over every rank, gloo, for barriers and
    host values (its timeout is long: rank 0 writes checkpoints while the
    others wait)."""

    rules: dict = dataclasses.field(default_factory=default_rules)
    data_comm: Any = None
    control: Any = None
    backend: str = "gloo"
    staged: bool = False
    _aborted: bool = False

    def sum_over_mesh(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over every rank: over the model row, then over the data
        column, each in rank order (every rank holds the same bits)."""
        for comm in (self.comm, self.data_comm):
            if comm is not None and comm.size > 1:
                t = comm.all_reduce_sum([t])[0]
        return t

    def barrier(self) -> None:
        if self.control.pg is not None:
            self.control.pg.barrier().wait()

    def close(self) -> None:
        """End rank 0's NCCL groups while their store exists, once the
        other ranks have exited (one left to the interpreter's exit holds
        it for minutes; the other ranks end theirs with ``os._exit``)."""
        if self._aborted:
            return
        for comm in (self.comm, self.data_comm):
            if comm is not None and self.backend == "nccl" and comm.pg:
                pg, comm.pg = comm.pg, None
                (getattr(pg, "shutdown", None) or pg._shutdown)()

    def abort(self) -> None:
        """Abort this rank's NCCL groups (a peer is gone): pending
        collectives end with an error instead of waiting for the
        timeout."""
        self._aborted = True
        for comm in (self.comm, self.data_comm):
            if comm is not None and self.backend == "nccl" and comm.pg:
                comm.pg.abort()


def connect_train_mesh(spec: dict, rank: int) -> TrainMesh:
    """Join the training mesh ``spec`` describes as ``rank`` (data-major:
    rank = d·mp + m)."""
    import torch.distributed as dist

    dp, mp = spec["dp"], spec["mp"]
    device = torch.device(spec["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(spec["store"], dp * mp)
    d, m = divmod(rank, mp)
    mesh = TrainMesh(dp=dp, mp=mp, rank=rank, device=device,
                     backend=spec["backend"], staged=spec["staged"])
    mesh.control = Communicator(process_group(
        dist.PrefixStore("control", store), rank, dp * mp, "gloo",
        spec["control_timeout_s"]), dp * mp, torch.device("cpu"), False, rank)

    def comm(name, r, n):
        pg = None
        if n > 1:
            pg = process_group(dist.PrefixStore(name, store), r, n,
                               spec["backend"], spec["timeout_s"])
        return Communicator(pg, n, device, spec["staged"], r)

    mesh.comm = comm(f"model{d}", m, mp)
    mesh.data_comm = comm(f"data{m}", d, dp)
    return mesh


def spec_items(tree, specs, path: tuple = ()):
    """``(path, leaf, spec)`` for every tensor of ``tree`` beside its spec
    tree (a spec is a tuple, so the walk goes by the tree, not the specs),
    in :func:`repro_torch.tree.flatten_with_paths`'s order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree, specs
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_items(tree[k], specs[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from spec_items(v, specs[i], path + (i,))


def _map(fn, tree, specs, path: tuple = ()):
    if isinstance(tree, torch.Tensor):
        return fn(path, tree, specs)
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k], path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, specs[i], path + (i,))
                          for i, v in enumerate(tree))
    return tree


class ShardPlan:
    """Where a model's train state lives on ``mesh`` and how its step
    computes there (module docstring).  ``specs`` is the stacked param
    tree's spec tree (``spec_by_key``: by ``flatten_with_paths`` key);
    ``local_cfg`` the config of the rank's compute (its query and KV head
    counts); :meth:`parallel` answers ``constrain``."""

    def __init__(self, cfg, mesh: TrainMesh):
        from repro_torch.convert import stack_axes, stack_layers
        from repro_torch.models.lm import build_model

        self.cfg, self.mesh = cfg, mesh
        model = build_model(cfg)
        aparams = stack_layers(model.abstract_params())
        self.specs = param_shardings(mesh, aparams,
                                     stack_axes(model.param_axes()))
        self.spec_by_key = {"/".join(map(str, p)): s
                            for p, _, s in spec_items(aparams, self.specs)}
        mp, H, KV = mesh.mp, cfg.n_heads, cfg.n_kv_heads
        if cfg.family == "rwkv":  # the time mix's heads
            H = cfg.d_model // cfg.rwkv_head_size
        # a region computes in parallel where its leaves' split dim is
        # sharded over 'model' in whole units: the query heads (attention
        # or the time mix), the ff columns, the experts, the vocab rows
        split = {"act_heads": set(), "act_ff": set(), "act_experts": set(),
                 "vocab": set()}
        for path, _, spec in spec_items(aparams, self.specs):
            module, leaf = path[-2], path[-1]
            if (module, leaf) in (("attn", "wq"), ("xattn", "wq"),
                                  ("time_mix", "wr")):
                split["act_heads"].add(spec[-1] == "model" and H % mp == 0)
            elif (module, leaf) in (("mlp", "wi"), ("dense", "wi"),
                                    ("channel_mix", "wk")):
                split["act_ff"].add(spec[-1] == "model")
            elif (module, leaf) == ("moe", "wi"):
                split["act_experts"].add(spec[1] == "model")
            elif (module, leaf) == ("embed", "tok"):
                split["vocab"].add(spec[0] == "model")
        if any(len(v) > 1 for v in split.values()):
            raise ValueError(f"{cfg.name}: the modules of one region shard "
                             f"differently on mesh {mesh.dp}x{mesh.mp}")
        self._parallel = {k: bool(v) and v.pop() for k, v in split.items()}
        attn = next((s for k, s in self.spec_by_key.items()
                     if k.endswith("attn/wk")), None)
        self.kv_local = (self._parallel["act_heads"] and attn is not None
                         and attn[-1] == "model" and KV % mp == 0)
        self.kv_heads = None  # KV heads to take from the whole wk / wv
        self.local_cfg = cfg
        if self._parallel["act_heads"] and attn is not None:
            hl = H // mp
            heads = range(mesh.model_rank * hl, (mesh.model_rank + 1) * hl)
            kv = [h // (H // KV) for h in heads]
            uniq = sorted(set(kv))
            if all(kv.count(u) == hl // len(uniq) for u in uniq) \
                    and hl % len(uniq) == 0:
                kvl = len(uniq)
                self.kv_heads = None if self.kv_local else uniq
            else:  # ragged groups: one KV head (repeated) a query head
                kvl, self.kv_heads = hl, kv
            self.local_cfg = dataclasses.replace(cfg, n_heads=hl,
                                                 n_kv_heads=kvl)

    # ---- what constrain asks ----

    def parallel(self, name: str) -> bool:
        return self._parallel[name]

    @property
    def comm(self):
        return self.mesh.comm

    @property
    def model_rank(self) -> int:
        return self.mesh.model_rank

    @property
    def data_comm(self):
        return self.mesh.data_comm

    def axis_comm(self, axis: str):
        """The communicator over the mesh axis ``axis``."""
        if axis not in ("model", "data"):
            raise ValueError(f"the training mesh has no axis {axis!r}")
        return self.mesh.comm if axis == "model" else self.mesh.data_comm

    # ---- the step ----

    def data_slice(self, micro: dict) -> dict:
        """This data rank's rows of every microbatch ((n_micro, Bm, ...)
        leaves): the data ranks' rows, put together in rank order, are
        the microbatch."""
        bm = micro["tokens"].shape[1]
        if bm % self.mesh.dp:
            raise ValueError(f"a microbatch of {bm} rows does not split over "
                             f"{self.mesh.dp} data ranks")
        lo, hi = self.mesh.local_range(bm, "data")
        return {k: v[:, lo:hi] for k, v in micro.items()}

    def compute(self, params: dict) -> dict:
        """The compute-layout tree of this rank's stored blocks."""
        return _map(self._compute_leaf, params, self.specs)

    def _compute_leaf(self, path, t, spec):
        mesh = self.mesh
        region = _region(path)
        par = region is not None and self._parallel[region]
        kv = par and path[-2] in _ATTN and path[-1] in _KV
        keep = par and not (kv and not self.kv_local)
        for d, ax in enumerate(spec):
            if ax == "data":
                t = C.gather(t, mesh.data_comm, d, partial=True)
            elif ax == "model":
                if not keep:
                    t = C.gather(t, mesh.comm, d, partial=par)
            elif ax is not None:
                raise ValueError(f"leaf {'/'.join(map(str, path))}: spec "
                                 f"{spec} shards over several mesh axes")
        if par and "model" not in spec:
            t = C.grad_sum_over(t, mesh.comm)
            if path[-2] == "time_mix" and path[-1] in _SLICED:
                d = _SLICED[path[-1]]
                lo, hi = mesh.local_range(t.shape[d], "model")
                t = t.narrow(d, lo, hi - lo)
        if kv and self.kv_heads is not None:
            hd = self.cfg.head_dim
            cols = torch.tensor([h * hd + i for h in self.kv_heads
                                 for i in range(hd)], device=t.device)
            t = t.index_select(-1, cols)
        return t

    def reduce_grads(self, keys: list, grads: list) -> None:
        """Sum over ``data``, in place, the gradient of every leaf that is
        not sharded over it (a ``data``-sharded leaf's is summed by the
        gather's backward)."""
        if self.mesh.dp == 1:
            return
        for k, g in zip(keys, grads):
            if "data" not in self.spec_by_key[k]:
                g.copy_(self.mesh.data_comm.all_reduce_sum([g])[0])

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ``data`` of a per-rank metric (the caller divides
        by ``dp``)."""
        if self.mesh.dp == 1:
            return t
        return self.mesh.data_comm.all_reduce_sum([t])[0]

    def sum_squares(self, tree) -> torch.Tensor:
        """Σ x² over the logical leaves of ``tree`` (the params' tree):
        each rank sums its blocks, a block replicated over an axis counted
        only by the ranks at coordinate 0 of that axis, and the ranks'
        sums are added over the mesh."""
        mesh = self.mesh
        total = torch.zeros((), dtype=torch.float32, device=mesh.device)
        for _, t, spec in spec_items(tree, self.specs):
            if ("model" in spec or mesh.model_rank == 0) and (
                    "data" in spec or mesh.data_rank == 0):
                total = total + torch.sum(torch.square(t.to(torch.float32)))
        return mesh.sum_over_mesh(total)

    def state_specs(self, state: dict) -> dict:
        """The spec tree of a train state ``{"params", "opt"}``: each tree
        of the optimizer state param-shaped (adamw's, sgd's, adafactor's
        ``master``) or adafactor's ``moments``, a leaf's ``(row, col)``
        taking its spec without the last dim and without the next-to-last
        (``(row, None)`` for a 1-D leaf)."""
        def factored(path, t, spec):
            if t.ndim < 2:
                return (spec, None)
            return (spec[:-1], spec[:-2] + spec[-1:])

        moments = _map(factored, state["params"], self.specs)
        return {"params": self.specs,
                "opt": {k: moments if k == "moments" else self.specs
                        for k in state["opt"]}}

