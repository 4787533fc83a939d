"""Per-op breakdown of a dry-run record (the profiling view of a cell).

The port's counterpart of the JAX package's ``runtime/hlo_breakdown.py``:
ranks the ops of a traced step by bytes and FLOPs per device.  It reads
the per-op table (``op_table``: op -> count, flops, bytes of the whole
traced step) that ``launch/dryrun.py`` writes into each record, in place
of an archived HLO file.  Usage:

    PYTHONPATH=src python -m repro_torch.runtime.op_breakdown \\
        build/dryrun/qwen3-14b__train_4k__pod1.json --top 25
"""
from __future__ import annotations

import argparse
import json

__all__ = ["breakdown", "main"]


def breakdown(record: dict) -> tuple[dict, dict]:
    """(op -> bytes per device, op -> FLOPs per device) of a record."""
    chips = record.get("chips", 1)
    by_bytes, by_flops = {}, {}
    for op, row in record["op_table"].items():
        if row["bytes"]:
            by_bytes[op] = row["bytes"] / chips
        if row["flops"]:
            by_flops[op] = row["flops"] / chips
    return by_bytes, by_flops


def _print_top(title: str, d: dict, counts: dict, top: int, unit: float,
               suffix: str) -> None:
    total = sum(d.values())
    print(f"\n== {title} (total {total / unit:.2f} {suffix}) ==")
    for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {v / unit:10.2f} {suffix}  {100 * v / max(total, 1e-9):5.1f}%"
              f"  {counts[k]:8d}x  {k}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="a dry-run record (JSON)")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    with open(args.path) as f:
        record = json.load(f)
    by_bytes, by_flops = breakdown(record)
    counts = {k: v["count"] for k, v in record["op_table"].items()}
    _print_top("bytes (per device)", by_bytes, counts, args.top, 1e9, "GB")
    _print_top("FLOPs (per device)", by_flops, counts, args.top, 1e12, "TF")
    coll = record.get("collectives")
    print("\n== collectives (per device) ==")
    print(json.dumps(coll) if coll is not None
          else f"null: {record.get('collectives_note', '')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
