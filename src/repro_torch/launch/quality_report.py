"""Render the quality section of a quantized artifact, as the JAX
package's ``launch/quality_report.py`` does (same table text), on the
port's artifacts.

The quantize driver folds every layer's quality report (incoherence µ
before/after preprocessing, Hessian spectrum, absolute + H-relative proxy
loss, error norms, wall-clock) into the artifact manifest; this CLI is
the human surface over that section::

    python -m repro_torch.launch.quality_report <artifact-dir>
    python -m repro_torch.launch.quality_report <dir> --write-baseline base.json
    python -m repro_torch.launch.quality_report <dir> --baseline base.json [--threshold 1.2]

``--write-baseline`` persists the per-layer proxy losses as the reference
a later ``serve.py --quality-baseline`` (or this CLI's ``--baseline``)
compares against; with ``--baseline`` the exit status is the number of
regressed layers, so CI can gate on it directly.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.checkpoint.store import latest_step
from repro_torch.serve.quality import (
    check_artifact_quality,
    load_baseline,
    write_baseline,
)

__all__ = ["load_manifest", "main", "render_quality"]


def load_manifest(directory) -> dict:
    """Artifact metadata of the newest complete checkpoint under
    ``directory`` (the manifest's ``meta`` block — quality section,
    quip/arch configs) — no weight shards are touched."""
    directory = pathlib.Path(directory)
    step = latest_step(directory)
    if step is None:
        raise SystemExit(f"no complete checkpoint under {directory}")
    manifest = json.loads(
        (directory / f"step_{step:08d}" / "manifest.json").read_text()
    )
    return manifest.get("meta", {})


_COLS = (  # (header, stats key, format)
    ("proxy", "proxy_loss", "{:.4g}"),
    ("proxy_rel", "proxy_rel", "{:.3g}"),
    ("mu_w pre>post", None, None),  # rendered as a pair
    ("mu_h pre>post", None, None),
    ("h_cond", "h_cond", "{:.3g}"),
    ("frob_rel", "frob_rel_err", "{:.3g}"),
    ("wall_s", "wall_s", "{:.2f}"),
)


def render_quality(quality: dict) -> str:
    """Fixed-width per-layer table + aggregate footer."""
    layers = quality.get("layers", {})
    rows = [["layer"] + [h for h, _, _ in _COLS]]
    for key in sorted(layers, key=lambda k: (int(k.split("/")[0]), k)):
        st = layers[key]
        row = [key]
        for head, skey, fmt in _COLS:
            if skey is not None:
                row.append(fmt.format(st[skey]))
            elif head.startswith("mu_w"):
                row.append(f"{st['mu_w_pre']:.2f}>{st['mu_w_post']:.2f}")
            else:
                row.append(f"{st['mu_h_pre']:.2f}>{st['mu_h_post']:.2f}")
        rows.append(row)
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in rows
    ]
    agg = quality.get("aggregate", {})
    if agg:
        lines.append("")
        lines.append(
            "aggregate: "
            + "  ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in agg.items()
            )
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render / baseline the quality section of a quantized "
                    "artifact manifest"
    )
    ap.add_argument("artifact", help="artifact directory (--out-dir of "
                                     "launch/quantize.py)")
    ap.add_argument("--baseline", default=None,
                    help="quality baseline JSON to compare against; exit "
                         "status = number of regressed layers")
    ap.add_argument("--threshold", type=float, default=1.2,
                    help="regression ratio: flag layers whose proxy loss "
                         "exceeds baseline x this (default 1.2)")
    ap.add_argument("--write-baseline", default=None,
                    help="persist this artifact's per-layer proxy losses "
                         "as a baseline JSON")
    ap.add_argument("--json", action="store_true",
                    help="dump the raw quality section instead of a table")
    args = ap.parse_args(argv)

    meta = load_manifest(args.artifact)
    quality = meta.get("quality")
    if not quality:
        raise SystemExit(
            f"{args.artifact} has no quality section (saved before quality "
            "manifests existed) — re-quantize with launch/quantize.py"
        )
    if args.json:
        print(json.dumps(quality, indent=1))
    else:
        print(f"[quality] {args.artifact}  "
              f"method={meta.get('quip_config', {}).get('method', '?')} "
              f"bits={meta.get('quip_config', {}).get('bits', '?')}")
        print(render_quality(quality))

    if args.write_baseline:
        write_baseline(args.write_baseline, quality, source=str(args.artifact))
        print(f"[quality] baseline written to {args.write_baseline}")

    if args.baseline:
        base = load_baseline(args.baseline)
        regressions = check_artifact_quality(
            quality, base, threshold=args.threshold
        )
        for r in regressions:
            if r["reason"] == "missing_layer":
                print(f"[quality] REGRESSION {r['layer']}: layer missing "
                      f"from artifact (baseline proxy={r['baseline']:.4g})")
            else:
                print(f"[quality] REGRESSION {r['layer']}: proxy "
                      f"{r['baseline']:.4g} -> {r['current']:.4g} "
                      f"({r['ratio']:.2f}x > {args.threshold:.2f}x)")
        if not regressions:
            print(f"[quality] OK: no layer regressed beyond "
                  f"{args.threshold:.2f}x baseline proxy loss")
        return len(regressions)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
