"""Quantization-quality observability, as the JAX package has it.

Performance telemetry (serve/telemetry.py) answers "how fast is the
engine"; this module answers "is the model it serves still the model we
audited".  Three layers share it:

  * **quantize time** — :func:`build_quality_section` folds the per-layer
    quality reports ``quantize_layer`` emits into the artifact manifest's
    ``quality`` section, exactly as the JAX package writes it::

        {"format": 1,
         "layers": {"<block>/<linear>": <quantize_layer stats dict>},
         "aggregate": {...}}

  * **load time** — :func:`check_artifact_quality` compares a loaded
    artifact's quality section with a stored baseline (written by
    ``launch/quality_report.py --write-baseline``) and returns the layers
    whose proxy loss regressed beyond a threshold ratio.

  * **serve time** — :func:`canary_probe` runs a teacher-forced forward
    over a pinned canary prompt set through the adapter's dense trunk
    (``CachedDecoder.activation_probe``: out of band, the KV pool is never
    touched) and returns the canary NLL plus per-layer activation absmax
    and saturation; :class:`ShadowSampler` re-scores a deterministic
    fraction of finished requests against the same trunk.

The NLL is float64 on the host, the JAX package's formula, so the online
gauge equals an offline recomputation from the same logits bit for bit.
Shadow selection hashes ``(seed, rid)`` with crc32, never ``hash()``, so
the port picks the requests the JAX package picks.
"""
from __future__ import annotations

import json
import pathlib
import warnings
import zlib
from typing import Optional

import numpy as np

__all__ = [
    "QUALITY_FORMAT",
    "SAT_THRESHOLD",
    "ShadowSampler",
    "aggregate_quality",
    "build_quality_section",
    "canary_probe",
    "check_artifact_quality",
    "load_baseline",
    "teacher_forced_logits",
    "teacher_forced_nll",
    "write_baseline",
]

QUALITY_FORMAT = 1

# activation saturation: fraction of hidden-state elements at or beyond
# this magnitude — an early-warning overflow canary for fp16-class serving
# dtypes (float16 max is 65504)
SAT_THRESHOLD = 3.0e4


# ---------------------------------------------------------------------------
# quality manifest section (quantize time)
# ---------------------------------------------------------------------------


def build_quality_section(stats: list) -> dict:
    """Fold ``QuantizedModel.stats`` (one dict per block, keyed by linear
    name) into the manifest ``quality`` section."""
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


# ---------------------------------------------------------------------------
# baselines (load time)
# ---------------------------------------------------------------------------


def write_baseline(path, quality: dict, *, source: Optional[str] = None) -> dict:
    """Persist the per-layer proxy losses of ``quality`` as a baseline."""
    obj = {
        "kind": "quip_quality_baseline",
        "format": QUALITY_FORMAT,
        "source": source,
        "proxy_loss": {
            key: st["proxy_loss"] for key, st in quality["layers"].items()
        },
        "aggregate": quality.get("aggregate", {}),
    }
    pathlib.Path(path).write_text(json.dumps(obj, indent=1))
    return obj


def load_baseline(path) -> dict:
    obj = json.loads(pathlib.Path(path).read_text())
    if obj.get("kind") != "quip_quality_baseline":
        raise ValueError(
            f"{path} is not a quality baseline "
            f"(kind={obj.get('kind')!r}); write one with "
            f"launch/quality_report.py --write-baseline"
        )
    return obj


def check_artifact_quality(
    quality: Optional[dict], baseline: dict, *, threshold: float = 1.2
) -> list:
    """Compare an artifact's quality section against a baseline.

    Returns one regression record per layer whose proxy loss exceeds
    ``threshold ×`` its baseline value (and one for each layer the
    baseline knows but the artifact lacks).  An artifact with no quality
    section warns and compares clean.
    """
    if threshold <= 0:
        raise ValueError(f"threshold must be > 0, got {threshold}")
    if not quality or "layers" not in quality:
        warnings.warn(
            "artifact manifest has no quality section (saved before "
            "quality manifests existed); baseline comparison skipped — "
            "re-quantize to audit proxy loss",
            stacklevel=2,
        )
        return []
    regressions = []
    for key, base in baseline["proxy_loss"].items():
        st = quality["layers"].get(key)
        if st is None:
            regressions.append({
                "layer": key, "baseline": base, "current": None,
                "ratio": None, "reason": "missing_layer",
            })
            continue
        cur = st["proxy_loss"]
        if cur > base * threshold:
            regressions.append({
                "layer": key, "baseline": base, "current": cur,
                "ratio": cur / base if base > 0 else float("inf"),
                "reason": "proxy_loss",
            })
    return regressions


# ---------------------------------------------------------------------------
# serve-time canaries
# ---------------------------------------------------------------------------


def teacher_forced_logits(adapter, tokens: np.ndarray) -> np.ndarray:
    """Full-sequence causal logits through the adapter's dense probe trunk
    (``CachedDecoder.activation_probe``).  One code path serves the canary
    gauge, the shadow oracle and any offline recomputation, which is what
    makes "online gauge == offline value" an equality.

    ``tokens`` (B, S) int32; returns logits (B, S, V) float32 on the host.
    """
    return adapter.activation_probe(tokens)[0]


def _nll_from_logits(logits: np.ndarray, tokens: np.ndarray) -> float:
    """−mean log p(t_i | t_<i) in float64 on the host."""
    z = logits[:, :-1].astype(np.float64)
    z = z - z.max(axis=-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
    tgt = np.asarray(tokens, np.int64)[:, 1:]
    picked = np.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    return float(-picked.mean())


def teacher_forced_nll(adapter, tokens: np.ndarray) -> float:
    """Teacher-forced NLL of ``tokens`` under the adapter's dense trunk."""
    return _nll_from_logits(teacher_forced_logits(adapter, tokens), tokens)


def canary_probe(adapter, tokens: np.ndarray) -> tuple[float, dict]:
    """One canary tick: teacher-forced NLL over the pinned prompt set plus
    per-layer activation absmax / saturation from the same forward.  Out
    of band: nothing touches the KV pool."""
    logits, act = adapter.activation_probe(tokens)
    return _nll_from_logits(logits, np.asarray(tokens, np.int32)), act


# ---------------------------------------------------------------------------
# shadow drift sampling
# ---------------------------------------------------------------------------


class ShadowSampler:
    """Always-on sampled generalization of ``serve.py --check``.

    A deterministic fraction of requests (crc32 of ``(seed, rid)``) record
    their per-emission logits; when such a request FINISHES, the adapter's
    dense trunk re-scores its ``prompt + output`` and the sampler observes
    ``shadow_max_abs_logit_diff`` and ``shadow_flip_rate`` (histograms),
    ``shadow_token_flips``, ``shadow_samples`` and ``shadow_tokens``
    (counters).  On the fp gather-dense path the serving forward IS the
    oracle, so the flip rate is zero.
    """

    def __init__(self, adapter, rate: float, *, seed: int = 0,
                 metrics=None, tracer=None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"shadow rate must be in [0, 1], got {rate}")
        self.adapter = adapter
        self.rate = rate
        self.seed = seed
        self.metrics = metrics
        self.tracer = tracer

    def selects(self, rid: int) -> bool:
        if self.rate <= 0.0:
            return False
        h = zlib.crc32(f"{self.seed}:{rid}".encode())
        return h / 2**32 < self.rate

    def observe(self, req) -> Optional[dict]:
        """Re-score one finished shadow request; returns the drift record
        (also pushed into the metrics registry / tracer when wired)."""
        if not req.out_tokens or len(req.step_logits) != len(req.out_tokens):
            return None  # logits missing: nothing honest to score
        full = np.concatenate(
            [req.prompt, np.asarray(req.out_tokens, np.int32)]
        )
        oracle = teacher_forced_logits(self.adapter, full[None])[0]
        # emission i's logits predict out_tokens[i]: oracle row P-1+i
        rows = oracle[len(req.prompt) - 1 : len(req.prompt) - 1
                      + len(req.out_tokens)]
        served = np.stack(
            [np.asarray(l, np.float32) for l in req.step_logits]
        )
        diff = float(np.max(np.abs(served - rows)))
        flips = int(np.sum(
            np.argmax(served, axis=-1) != np.argmax(rows, axis=-1)
        ))
        rec = {
            "rid": req.rid,
            "tokens": len(req.out_tokens),
            "max_abs_logit_diff": diff,
            "token_flips": flips,
            "flip_rate": flips / len(req.out_tokens),
        }
        if self.metrics is not None:
            m = self.metrics
            m.inc("shadow_samples")
            m.inc("shadow_tokens", rec["tokens"])
            m.inc("shadow_token_flips", flips)
            m.histogram("shadow_max_abs_logit_diff").observe(diff)
            m.histogram("shadow_flip_rate").observe(rec["flip_rate"])
        if self.tracer is not None:
            self.tracer.event("shadow_drift", **rec)
        return rec
