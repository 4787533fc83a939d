"""Op-level step analysis: FLOPs, bytes, peak live bytes and collectives.

The port's counterpart of the JAX package's ``runtime/hlo_analysis.py``.
There is no HLO here: :func:`analyze_step` runs the step itself under a
``TorchDispatchMode`` — on ``meta`` tensors (nothing allocated, nothing
computed) or on real tensors on the card — and records every op the
dispatcher sees: each aten op and each ``torch.ops.repro_torch.*`` kernel.
Only ops that touch a tensor on the step's device (the device of its
tensor arguments) are counted, so host-side scalars (an optimizer's step
counter, a checkpoint's saved RNG state) count in neither a ``meta`` nor a
card trace, and the two traces of one step count the same ops.

  * **FLOPs**: ``torch.utils.flop_counter``'s formulas for the matmul,
    convolution and attention families (``2·m·n·k`` for a matmul, as
    ``hlo_analysis`` counts a ``dot``); the port's own operators carry
    formulas registered beside their wrappers (``kernels/*/ops.py``,
    :func:`register_kernel`), e.g. ``quant_matmul`` ``2·B·K·M`` plus its
    affine epilogue, ``kron_mul`` ``2·N·(p+q)·p·q``.  Where the work
    depends on the data (paged attention over each lane's context), a
    card trace counts what the data needs and a ``meta`` trace the
    capacity.  Elementwise ops count no FLOPs (nor do they in
    ``hlo_analysis``).
  * **Bytes**: operand plus result bytes of every op that is not a view.
    In eager PyTorch every op is its own round trip to device memory, so
    the op boundary is the counterpart of XLA's fusion boundary; a view
    (``view``, ``t``, ``unbind``, ``expand``, ...) moves nothing.
  * **Peak live bytes**: the arguments' storages plus the most that
    storages created during the step held at once (each storage counted
    from the op that made it until it is freed), exact in bytes: the
    caching allocator rounds each block up to 512 B, and kernels'
    internal workspaces are not seen.
  * **Collectives**: a :class:`CollectiveStats` over the ``c10d`` ops the
    traced code issues (trace one rank under ``torch.distributed``'s
    ``fake`` backend), with the JAX module's per-device link-byte
    conventions: all-reduce ``2·B·(g−1)/g``, all-gather
    ``B_result·(g−1)/g``, reduce-scatter and all-to-all
    ``B_operand·(g−1)/g``, a point-to-point send or broadcast
    ``B_operand``; ``g`` is the group's size.
  * **Loops**: eager tracing unrolls every Python loop (layers,
    microbatches, query chunks), so the loop weighting that
    ``hlo_analysis`` exists for (XLA's cost analysis counts a ``while``
    body once) comes for free.

All numbers are of the traced program: one process's step.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpStats", "CollectiveStats", "analyze_step", "register_kernel",
           "KERNEL_FORMULAS"]

# "repro_torch.<op>" -> (launch-count name, flops(args) -> float,
# launched(args) -> bool): filled by the kernels' ops.py modules
KERNEL_FORMULAS: dict = {}
_KERNEL_MODULES = ("quant_matmul", "paged_attention", "ldlq", "kron_mul",
                   "hadamard")


def register_kernel(op: str, count_as: str, *, launched: Callable):
    """Register the FLOP formula of ``torch.ops.repro_torch.<op>`` (the
    decorated function takes the op's arguments) and the kernel launch
    count it adds to (``count_as``, a ``COUNTS`` key) where
    ``launched(*args)`` holds, as the launch wrapper counts it."""
    def deco(fn):
        KERNEL_FORMULAS[f"repro_torch.{op}"] = (count_as, fn, launched)
        return fn

    return deco


def _load_kernel_formulas() -> None:
    import importlib

    for name in _KERNEL_MODULES:
        importlib.import_module(f"repro_torch.kernels.{name}.ops")


# ---- collectives ----------------------------------------------------------

# c10d / functional-collective op -> its kind
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "collective-permute",
    "broadcast": "collective-permute",
    "send": "collective-permute",
}
# where the operand / result tensors sit in each schema: (operand arg,
# result arg); None = the op's return value
_C10D_ARGS = {
    "allgather_": (1, 0), "_allgather_base_": (1, 0),
    "allgather_into_tensor_coalesced_": (1, 0),
    "allgather_coalesced_": (1, 0),
    "reduce_scatter_": (1, 0), "_reduce_scatter_base_": (1, 0),
    "reduce_scatter_tensor_coalesced_": (1, 0),
    "alltoall_": (1, 0), "alltoall_base_": (1, 0),
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def summary(self) -> dict:
        return {"total_bytes": self.total_bytes,
                "by_kind": dict(self.bytes_by_kind),
                "counts": dict(self.count_by_kind)}


def _group_size(args, default: int) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                from torch.distributed import ProcessGroup

                return int(ProcessGroup.unbox(a).size())
            except Exception:  # noqa: BLE001 - not a ProcessGroup
                continue
    for a in reversed(args):
        if isinstance(a, str):  # functional collectives: the group name
            try:
                from torch.distributed.distributed_c10d import (
                    _resolve_process_group,
                )

                return int(_resolve_process_group(a).size())
            except Exception:  # noqa: BLE001 - not a group name
                continue
    return default


# ---- bytes ----------------------------------------------------------------


def _tensors(x, out=None) -> list:
    """The tensors in nested lists / tuples / dicts (an op's arguments)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# metadata-only ops whose schema declares no alias
_FREE = {"aten._unsafe_view", "aten.detach", "aten.lift_fresh",
         "aten.alias", "aten.empty", "aten.empty_strided",
         "aten.empty_like", "aten.new_empty", "aten.new_empty_strided",
         "aten.resize_"}


def _is_view(func) -> bool:
    schema = getattr(func, "_schema", None)
    if schema is None:
        return False
    for r in schema.returns:
        info = r.alias_info
        if info is not None and not info.is_write:
            return True
    return False


# ---- the recorder ---------------------------------------------------------

# func -> (name, collective short name or None, moves no bytes, flop
# formula or None, kernel spec or None)
_FUNCS: dict = {}


def _func_info(func) -> tuple:
    from torch.utils.flop_counter import flop_registry

    name = str(func.overloadpacket)
    ns, _, short = name.partition(".")
    collective = short if ns in ("c10d", "_c10d_functional") else None
    free = name in _FREE or _is_view(func)
    return (name, collective, free, flop_registry.get(func.overloadpacket),
            KERNEL_FORMULAS.get(name))


@dataclasses.dataclass
class OpStats:
    """One traced step: FLOPs and bytes of the counted ops, peak live
    bytes, collectives, the per-op table (name -> count, flops, bytes)
    and the port's kernel launches by ``COUNTS`` name."""

    flops: float
    bytes_accessed: float
    peak_live_bytes: int
    arg_bytes: int
    collectives: CollectiveStats
    ops: dict
    kernel_launches: dict
    device: str


class _Recorder(TorchDispatchMode):
    def __init__(self, device_type: str, n_devices: int):
        super().__init__()
        self.device_type = device_type
        self.n_devices = n_devices
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = defaultdict(lambda: [0, 0.0, 0.0])
        self.launches = defaultdict(int)
        self.coll_bytes = defaultdict(float)
        self.coll_count = defaultdict(int)
        self.seen: set = set()  # storages alive (by StorageImpl address)
        self.live = 0
        self.peak = 0

    def track_existing(self, ts) -> int:
        """Mark the arguments' storages as seen; returns their bytes."""
        total = 0
        for t in ts:
            st = t.untyped_storage()
            if t.device.type == self.device_type and st._cdata not in \
                    self.seen:
                self.seen.add(st._cdata)
                total += st.nbytes()
        return total

    def _freed(self, key: int, n: int) -> None:
        self.seen.discard(key)
        self.live -= n

    def _new_storages(self, outs) -> None:
        for t in outs:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                continue
            n = st.nbytes()
            self.seen.add(key)
            self.live += n
            weakref.finalize(st, self._freed, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(kwargs, _tensors(args))
        outs = _tensors(out)
        dt = self.device_type
        if not any(t.device.type == dt for t in ins) and \
                not any(t.device.type == dt for t in outs):
            return out
        self._new_storages(outs)
        info = _FUNCS.get(func)
        if info is None:
            info = _FUNCS[func] = _func_info(func)
        name, collective, free, flop_fn, kernel = info
        row = self.ops[name]
        row[0] += 1
        if collective:
            self._collective(collective, args, ins, outs)
            return out
        flops = 0.0
        if flop_fn is not None:
            flops = float(flop_fn(*args, **kwargs, out_val=out))
        elif kernel is not None:
            count_as, formula, launched = kernel
            if launched(*args):
                self.launches[count_as] += 1
            flops = float(formula(*args))
        nbytes = 0 if free else _nbytes(ins) + _nbytes(outs)
        self.flops += flops
        self.bytes += nbytes
        row[1] += flops
        row[2] += nbytes
        return out

    def _collective(self, short, args, ins, outs) -> None:
        kind = _C10D.get(short)
        if kind is None:
            return
        g = _group_size(args, self.n_devices)
        if short in _C10D_ARGS:
            i_op, i_res = _C10D_ARGS[short]
            op_b = _nbytes(_tensors(args[i_op]))
            res_b = _nbytes(_tensors(args[i_res]))
        else:
            op_b = _nbytes(_tensors(args[0]))
            res_b = _nbytes(outs) or op_b
        scale = (g - 1) / g if g > 1 else 0.0
        if kind == "all-reduce":
            b = 2.0 * op_b * scale
        elif kind == "all-gather":
            b = res_b * scale
        elif kind in ("reduce-scatter", "all-to-all"):
            b = op_b * scale
        else:
            b = float(op_b)
        self.coll_bytes[kind] += b
        self.coll_count[kind] += 1


def _device_type(args, kwargs) -> str:
    for t in _tensors((args, kwargs)):
        if t.device.type != "cpu":
            return t.device.type
    return "cpu"


def analyze_step(fn: Callable, *args, n_devices: int = 1,
                 device: Optional[str] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the recorder; returns ``(OpStats,
    fn's result)``.  ``device`` is the device type whose ops count (the
    first non-CPU device among the tensor arguments by default);
    ``n_devices`` is the group size of a collective whose group cannot be
    read."""
    _load_kernel_formulas()
    dev = device or _device_type(args, kwargs)
    rec = _Recorder(dev, n_devices)
    arg_bytes = rec.track_existing(_tensors((args, kwargs)))
    with rec:
        result = fn(*args, **kwargs)
    stats = OpStats(
        flops=rec.flops, bytes_accessed=rec.bytes,
        peak_live_bytes=arg_bytes + rec.peak, arg_bytes=arg_bytes,
        collectives=CollectiveStats(dict(rec.coll_bytes),
                                    dict(rec.coll_count)),
        ops={k: {"count": c, "flops": f, "bytes": b}
             for k, (c, f, b) in rec.ops.items()},
        kernel_launches=dict(rec.launches), device=dev)
    return stats, result
