"""Logical-axis sharding rules with the divisibility fallback.

The port's copy of the JAX package's ``runtime/sharding.py``: arrays are
annotated with *logical* axis names ("batch", "embed", "heads", ...), and
a rule table maps each name to a mesh axis, a tuple of mesh axes, or
nothing.  :func:`logical_to_pspec` resolves one array's names to a spec —
a tuple with, per dim, a mesh axis name, a tuple of them, or ``None`` —
under two rules: of a rule's axes only the greedy prefix whose product
divides the dim is kept (the array replicates where none does), and one
mesh axis shards at most one dim.

The training tables (:func:`default_rules`, :func:`serving_rules`,
:func:`context_rules`, :func:`fsdp2d_rules`, :data:`RULE_SETS`) equal the
JAX package's key for key; the dry run (``launch/dryrun.py``) resolves
them on an :class:`AbstractMesh` through a :class:`ShardingContext`.  The
tensor-parallel serving mesh (``serve/distributed.py``) keeps its own
table, :func:`tp_serving_rules`.

Plain functions on shapes: nothing here touches ``torch.distributed`` or
a device.  A :class:`MeshContext` adds what one process of a mesh knows —
the mesh shape ``(dp, mp)``, its rank, its place on each axis, its device
and its model-axis communicator.

:func:`mesh_context` and :func:`constrain` are the JAX package's: model
code names the layout of an activation by logical axes, and without a
context ``constrain`` does nothing.  Under a training mesh
(``runtime/train_mesh.py``'s ``ShardPlan``) it is where the layout
changes and autograd must know it (``runtime/collectives.py``):
``summed=`` a partial sum leaving a row-parallel product, summed over
``model``; ``feeds=`` a whole activation entering a column-parallel one,
whose gradient is summed over ``model``.  Both act only where the named
dim is computed in parallel on that mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Union

__all__ = ["default_rules", "serving_rules", "context_rules", "fsdp2d_rules",
           "RULE_SETS", "tp_serving_rules", "logical_to_pspec", "local_shape",
           "param_shardings", "AbstractMesh", "ShardingContext",
           "MeshContext", "mesh_context", "current_mesh_context",
           "constrain"]

MeshAxes = Union[str, tuple, None]
LogicalAxes = Sequence[Optional[str]]


def default_rules(multi_pod: bool = False) -> dict:
    """Baseline rule table for the (pod?, data, model) production mesh:
    FSDP over 'data' (weights sharded on their non-TP dim), Megatron TP
    over 'model', the 'pod' axis extending data parallelism."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        # --- activations ---
        "batch": batch,
        "seq": None,               # context parallelism: opt-in per shape
        "seq_kv": "model",         # decode KV-cache seq
        "act_embed": None,
        "act_heads": "model",
        "act_ff": "model",
        "act_experts": "model",
        # --- weights (FSDP dim first, TP dim second by convention) ---
        "embed": "data",           # d_model dim of weight matrices
        "heads": "model",          # fused q/k/v head*head_dim output dims
        "kv_heads": "model",
        "ff": "model",             # MLP hidden
        "vocab": "model",          # embedding / lm-head vocab dim
        "experts": "model",        # expert parallelism
        "expert_embed": "data",    # expert matrices: EP x FSDP
        "expert_ff": None,
        "layers": None,            # stacked layer axis: never sharded
        "pages": None,             # page pool: shards on KV heads only
        "conv": None,
        "state": None,
        "norm": None,
    }


def serving_rules(multi_pod: bool = False) -> dict:
    """Serving layout: weight-stationary TP + pure DP — no FSDP dim on
    weights ('embed' replicates over 'data')."""
    r = default_rules(multi_pod)
    r["embed"] = None
    return r


def context_rules(multi_pod: bool = False) -> dict:
    """Sequence / context parallelism: activation time over 'model' in
    place of the attention heads."""
    r = default_rules(multi_pod)
    r["seq"] = "model"
    r["act_heads"] = None
    return r


def fsdp2d_rules(multi_pod: bool = False) -> dict:
    """2D weight sharding on the non-contraction dims: the output / TP
    dims over (model, data), no FSDP on the contraction dim."""
    r = default_rules(multi_pod)
    r["embed"] = None
    data = ("data", "pod") if multi_pod else ("data",)
    for name in ("ff", "heads", "kv_heads", "vocab", "experts"):
        r[name] = ("model", *data)
    return r


RULE_SETS = {
    "default": default_rules,
    "serving": serving_rules,
    "context": context_rules,
    "fsdp2d": fsdp2d_rules,
}


def tp_serving_rules() -> dict:
    """The tensor-parallel serving mesh's table (``serve/distributed.py``):
    weight-stationary tensor parallelism over 'model', replication over
    'data'.  Heads, KV heads and the MLP hidden dim shard; the model dim of
    weights ('embed'), the layer axis and the page axis of the KV pool
    never do (block tables must resolve locally on every rank).  It
    departs from the JAX :func:`serving_rules` table, whose 'vocab' shards
    over 'model' and whose activation names map too: the serving mesh
    resolves only the packed codes' and the pool's axes (as the JAX serving
    mesh resolves only ``PACKED_AXES`` / ``POOL_AXES``), and its embedding
    and LM head replicate, so 'vocab' has no rule here."""
    return {
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "embed": None,
        "layers": None,
        "pages": None,
        "norm": None,
    }


def logical_to_pspec(mesh_shape: Mapping[str, int], rules: Mapping[str, Any],
                     logical: LogicalAxes,
                     shape: Optional[Sequence[int]] = None) -> tuple:
    """Resolve logical axis names to a spec: per dim a mesh axis name, a
    tuple of them, or ``None``.  With ``shape``, only the greedy prefix of
    a rule's axes whose product divides the dim is kept (the divisibility
    fallback); a mesh axis already used by an earlier dim, or absent from
    the mesh, is dropped."""
    spec: list = []
    used: set = set()
    for i, name in enumerate(logical):
        axes = None if name is None else rules.get(name)
        if axes is None:
            spec.append(None)
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if a not in used and a in mesh_shape)
        if shape is not None:
            keep, size = [], 1
            for a in axes:
                if shape[i] % (size * mesh_shape[a]) == 0:
                    keep.append(a)
                    size *= mesh_shape[a]
            axes = tuple(keep)
        if not axes:
            spec.append(None)
            continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def _spec_size(mesh_shape: Mapping[str, int], entry: MeshAxes) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh_shape[entry]
    return math.prod(mesh_shape[a] for a in entry)


def local_shape(spec: Sequence[MeshAxes], shape: Sequence[int],
                mesh_shape: Mapping[str, int]) -> tuple:
    """One device's block of an array of ``shape`` sharded by ``spec``:
    each dim divided by the product of its mesh axes (rounded up, the
    padded block, where the spec was resolved without the shape)."""
    return tuple(-(-n // _spec_size(mesh_shape, e))
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in v)


def param_shardings(ctx, abstract_params, logical_axes):
    """A tree of specs for a tree of tensors: ``logical_axes`` has the
    tree's structure with a tuple of logical names at each leaf (the JAX
    function's pairing), or one per-layer axes dict against a list of
    per-layer dicts (the port's unstacked layers).  ``ctx`` is anything
    with ``pspec(logical, shape)``."""
    if _is_axes(logical_axes):
        return ctx.pspec(logical_axes, tuple(abstract_params.shape))
    if isinstance(logical_axes, dict) and isinstance(abstract_params, list):
        return [param_shardings(ctx, a, logical_axes)
                for a in abstract_params]
    if isinstance(logical_axes, dict):
        return {k: param_shardings(ctx, abstract_params[k], v)
                for k, v in logical_axes.items()}
    if isinstance(abstract_params, (list, tuple)) and isinstance(
            logical_axes, (list, tuple)):
        return [param_shardings(ctx, a, ax)
                for a, ax in zip(abstract_params, logical_axes)]
    raise TypeError(f"axes {logical_axes!r} do not pair with the tree")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device mesh as a description: ordered ``(name, size)`` pairs and
    an optional device list — no process group, nothing allocated (a
    256-chip production mesh is a shape, as ``jax.make_mesh`` under the
    JAX dry run's fake devices is)."""

    axes: tuple  # ((name, size), ...)
    devices: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(n for n, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)


@dataclasses.dataclass
class ShardingContext:
    """A (mesh, rules) pair that resolves logical shardings to specs (the
    JAX package's ``MeshContext``)."""

    mesh: AbstractMesh
    rules: dict

    def pspec(self, logical: LogicalAxes, shape=None) -> tuple:
        return logical_to_pspec(self.mesh.shape, self.rules, logical, shape)


@dataclasses.dataclass
class MeshContext:
    """One process's view of a ``(data, model)`` mesh.

    ``rank`` counts data-major (rank = d·mp + m); ``model_rank`` is m, this
    process's place on the model axis.  ``comm`` is the model-axis
    communicator (``serve/distributed.py``), ``None`` in a plain layout
    computation."""

    dp: int
    mp: int
    rank: int = 0
    device: Any = "cpu"
    rules: dict = dataclasses.field(default_factory=tp_serving_rules)
    comm: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def model_rank(self) -> int:
        return self.rank % self.mp

    @property
    def data_rank(self) -> int:
        return self.rank // self.mp

    def pspec(self, logical: Sequence[Optional[str]], shape=None) -> tuple:
        return logical_to_pspec(self.shape, self.rules, logical, shape)

    def local_range(self, n: int, axis: Optional[str]) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dim of size ``n`` that ``axis``
        shards (the whole dim for ``None``)."""
        if axis is None:
            return 0, n
        k = self.shape[axis]
        r = self.model_rank if axis == "model" else self.data_rank
        return r * n // k, (r + 1) * n // k


# the active training context: process-wide, not thread-local, because
# autograd runs a remat'd block's forward again inside the backward, on a
# device thread for CUDA tensors, and that forward must issue the same
# collectives as the first
_ACTIVE: list = []


@contextlib.contextmanager
def mesh_context(ctx):
    """Activate ``ctx`` (a ``ShardPlan``: ``parallel(name)`` and the
    model-axis ``comm``) for :func:`constrain` calls in model code."""
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def current_mesh_context():
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x, logical: LogicalAxes, *, summed: Optional[str] = None,
              feeds: Optional[str] = None):
    """``x`` laid out as ``logical``; a no-op without a context.

    ``summed=name``: ``x`` is this rank's partial sum of a product
    contracted over the logical dim ``name`` (row-parallel); it is summed
    over ``model`` (its gradient passes through).  ``feeds=name``: ``x``
    is whole on every rank and feeds this rank's part of a product whose
    ``name`` dim is split; its gradient is summed over ``model``.  Either
    acts only where the context computes ``name`` in parallel; otherwise,
    and with neither, ``x`` already has the layout (a rank's heads, its
    ``ff`` columns) and is returned as it is."""
    ctx = current_mesh_context()
    name = summed or feeds
    if ctx is None or name is None or not ctx.parallel(name):
        return x
    from repro_torch.runtime import collectives

    if summed:
        return collectives.sum_over(x, ctx.comm)
    return collectives.grad_sum_over(x, ctx.comm)
