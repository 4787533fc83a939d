"""The artifact manifest's per-layer quality section.

``build_quality_section`` folds ``QuantizedModel.stats`` (one dict per
block, keyed by linear name, each ``quantize_layer``'s report) into the
manifest's ``quality`` section exactly as the JAX package writes it::

    {"format": 1,
     "layers": {"<block>/<linear>": <quantize_layer stats dict>},
     "aggregate": {...}}

Canary probes and shadow sampling are not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["QUALITY_FORMAT", "build_quality_section", "aggregate_quality"]

QUALITY_FORMAT = 1


def build_quality_section(stats: list) -> dict:
    layers = {
        f"{i}/{name}": dict(st)
        for i, blk in enumerate(stats)
        for name, st in blk.items()
        if st  # collect_stats=False layers carry no report
    }
    return {
        "format": QUALITY_FORMAT,
        "layers": layers,
        "aggregate": aggregate_quality(layers),
    }


def aggregate_quality(layers: dict) -> dict:
    """Model-level rollup of the per-layer reports."""
    if not layers:
        return {}
    vals = lambda k: [st[k] for st in layers.values() if k in st]
    return {
        "n_layers": len(layers),
        "total_proxy_loss": float(np.sum(vals("proxy_loss"))),
        "mean_proxy_rel": float(np.mean(vals("proxy_rel"))),
        "max_proxy_rel": float(np.max(vals("proxy_rel"))),
        "max_mu_w_post": float(np.max(vals("mu_w_post"))),
        "max_mu_h_post": float(np.max(vals("mu_h_post"))),
        "max_h_cond": float(np.max(vals("h_cond"))),
        "max_frob_rel_err": float(np.max(vals("frob_rel_err"))),
        "total_wall_s": float(np.sum(vals("wall_s"))),
    }
