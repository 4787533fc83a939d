"""Shared helpers of the port's parity tests (not a test module).

The ``*_numpy`` helpers extract JAX-package objects as the numpy trees
``repro_torch.convert`` takes; ``reference_transforms`` builds the port's
transform factory that hands the port the JAX package's own factors, so a
port run and a reference run see the same U and V.
"""
from __future__ import annotations

import numpy as np

from repro.core import incoherence as ref_inc
from repro.core.quantizer import QuantizedLinear as RefLinear
from repro_torch import convert


def _arr(x):
    return None if x is None else np.asarray(x)


def transform_numpy(t) -> dict:
    return {"kind": t.kind, "n": t.n, "A": _arr(t.A), "B": _arr(t.B),
            "signs": _arr(t.signs), "perm": _arr(t.perm)}


def linear_numpy(ql) -> dict:
    st = ql.state
    return {"packed": np.asarray(ql.packed), "s": np.asarray(st.s),
            "D": _arr(st.D), "bits": ql.bits, "m": ql.m, "n": ql.n,
            "maxq": st.maxq, "use_kernel": ql.use_kernel,
            "U": transform_numpy(st.U), "V": transform_numpy(st.V)}


def quantized_tree_numpy(qm) -> dict:
    """A reference QuantizedModel as the numpy tree convert takes."""
    blocks = []
    for blk in qm.blocks:
        out = {}
        for name, val in blk.items():
            if isinstance(val, RefLinear):
                out[name] = linear_numpy(val)
            elif isinstance(val, dict):
                out[name] = {k: np.asarray(v) for k, v in val.items()}
            else:
                out[name] = np.asarray(val)
        blocks.append(out)
    return {"embed": {k: np.asarray(v) for k, v in qm.embed.items()},
            "final_norm": {k: np.asarray(v) for k, v in qm.final_norm.items()},
            "blocks": blocks}


def reference_transforms(kind, n, seed, permute):
    """Port transform factory: the JAX package's ``make_transform(kind, n,
    seed)`` factors, converted (pass as ``transforms=``)."""
    t = ref_inc.make_transform(kind, n, seed, permute=permute)
    return convert.transform_from_numpy(transform_numpy(t), device="cpu")
