"""Logical-axis sharding rules with the divisibility fallback.

The port's copy of what serving needs from the JAX package's
``runtime/sharding.py``: arrays are annotated with *logical* axis names
("heads", "ff", "pages", ...), and a rule table maps each name to a mesh
axis or to nothing.  :func:`logical_to_pspec` resolves one array's names
to a spec (a tuple with one mesh axis or ``None`` per dim) under two
rules: a mesh axis that does not divide the dim is dropped (the array
stays replicated on that dim), and one mesh axis shards at most one dim.

Plain functions on shapes: nothing here touches ``torch.distributed``.
A :class:`MeshContext` adds what one process of a serving mesh knows —
the mesh shape ``(dp, mp)``, its rank, its place on the model axis, its
device and its model-axis communicator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

__all__ = ["serving_rules", "logical_to_pspec", "MeshContext"]


def serving_rules() -> dict:
    """Serving layout: weight-stationary tensor parallelism over 'model',
    replication over 'data'.  Heads, KV heads and the MLP hidden dim shard;
    the model dim of weights ('embed'), the layer axis and the page axis of
    the KV pool never do (block tables must resolve locally on every
    rank).  'vocab' has no rule: the embedding and the LM head replicate."""
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
                     logical: Sequence[Optional[str]],
                     shape: Optional[Sequence[int]] = None) -> tuple:
    """Resolve logical axis names to a spec: per dim a mesh axis name or
    ``None``.  With ``shape``, an assignment whose dim the mesh axis does not
    divide is dropped (the divisibility fallback); a mesh axis already used
    by an earlier dim is dropped too."""
    spec: list = []
    used: set = set()
    for i, name in enumerate(logical):
        axis = None if name is None else rules.get(name)
        if axis is not None and (axis in used or axis not in mesh_shape):
            axis = None
        if (axis is not None and shape is not None
                and shape[i] % mesh_shape[axis] != 0):
            axis = None
        if axis is not None:
            used.add(axis)
        spec.append(axis)
    return tuple(spec)


@dataclasses.dataclass
class MeshContext:
    """One process's view of a ``(data, model)`` serving mesh.

    ``rank`` counts data-major (rank = d·mp + m); ``model_rank`` is m, this
    process's place on the model axis.  ``comm`` is the model-axis
    communicator (``serve/distributed.py``), ``None`` in a plain layout
    computation."""

    dp: int
    mp: int
    rank: int = 0
    device: Any = "cpu"
    rules: dict = dataclasses.field(default_factory=serving_rules)
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
