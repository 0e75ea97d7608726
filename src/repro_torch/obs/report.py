"""Run-summary renderer for telemetry JSONL artifacts.

    python -m repro_torch.obs.report run-events.jsonl [--ledger ledger.jsonl]

Renders the span tree (aggregated by path: count, total seconds), hot
counters, gauges, histogram percentiles, and — when the artifact carries
ledger events (or ``--ledger`` names a ledger JSONL) — the per-tenant
ε-spend audit table, replay-verified.

This module is an explicit output sink: it is the one place in
``repro_torch.obs`` that prints.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple


def _span_tree(records: List[dict]) -> List[Tuple[Tuple[str, ...], int, float]]:
    """Aggregate spans by name-path → (path, count, total seconds).

    Paths are rebuilt from id/parent links (spans are recorded at close, so
    the full record list resolves every parent).  Sibling order is
    first-seen; each node precedes its children."""
    spans = {r["id"]: r for r in records if r.get("ev") == "span"}

    def path_of(r) -> Tuple[str, ...]:
        names = [r["name"]]
        while r["parent"] in spans:
            r = spans[r["parent"]]
            names.append(r["name"])
        return tuple(reversed(names))

    # nested {name: [count, total_s, children]} in first-seen order
    root: Dict[str, list] = {}
    for r in records:
        if r.get("ev") != "span":
            continue
        node, children = None, root
        for name in path_of(r):
            node = children.setdefault(name, [0, 0.0, {}])
            children = node[2]
        node[0] += 1
        node[1] += r["dur_s"]

    out: List[Tuple[Tuple[str, ...], int, float]] = []

    def walk(children: Dict[str, list], prefix: Tuple[str, ...]) -> None:
        for name, (n, total, kids) in children.items():
            path = prefix + (name,)
            out.append((path, n, total))
            walk(kids, path)

    walk(root, ())
    return out


def render(records: List[dict],
           ledger_entries: Optional[List[dict]] = None,
           top: int = 20) -> str:
    """The human-readable run summary of one telemetry JSONL artifact."""
    lines: List[str] = []
    meta = next((r for r in records if r.get("ev") == "meta"), {})
    extra = {k: v for k, v in meta.items()
             if k not in ("ev", "wall_start_unix", "duration_s")}
    lines.append("=== telemetry run summary ===")
    if meta:
        lines.append(f"run duration: {meta.get('duration_s', 0.0):.3f}s"
                     + (f"  meta: {extra}" if extra else ""))

    tree = _span_tree(records)
    if tree:
        lines.append("")
        lines.append("span tree (count, total seconds):")
        for path, n, total in tree:
            indent = "  " * len(path)
            lines.append(f"{indent}{path[-1]:<40s} {n:>6d}x {total:>10.4f}s")

    events: Dict[str, int] = {}
    for r in records:
        if r.get("ev") == "event":
            events[r["name"]] = events.get(r["name"], 0) + 1
    if events:
        lines.append("")
        lines.append("events:")
        for name, n in sorted(events.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<46s} {n:>6d}")

    metrics = [r for r in records if r.get("ev") == "metric"]
    counters = [m for m in metrics if m["type"] == "counter"]
    gauges = [m for m in metrics if m["type"] == "gauge"]
    hists = [m for m in metrics if m["type"] == "histogram"]

    def label_str(m) -> str:
        lbl = ",".join(f"{k}={v}" for k, v in sorted(m["labels"].items()))
        return f"{m['name']}{{{lbl}}}" if lbl else m["name"]

    if counters:
        lines.append("")
        lines.append(f"hot counters (top {top}):")
        for m in sorted(counters, key=lambda m: -m["value"])[:top]:
            lines.append(f"  {label_str(m):<52s} {m['value']:>10d}")
    if gauges:
        lines.append("")
        lines.append("gauges:")
        for m in gauges:
            lines.append(f"  {label_str(m):<52s} {m['value']:>14.6g}")
    if hists:
        lines.append("")
        lines.append("histograms (count / p50 / p90 / p99 / max):")
        for m in hists:
            lines.append(
                f"  {label_str(m):<44s} {m['count']:>6d}  "
                f"{m['p50']:.6g} / {m['p90']:.6g} / {m['p99']:.6g} / "
                f"{m['max']:.6g}")

    if ledger_entries is None:
        ledger_entries = [dict(r["attrs"]) for r in records
                          if r.get("ev") == "event" and r["name"] == "ledger"]
    if ledger_entries:
        from repro_torch.obs.ledger import AuditLedger
        lines.append("")
        lines.append("tenant ε-spend ledger (replay-verified):")
        lines.append(f"  {'tenant':<16s} {'charges':>8s} {'refused':>8s} "
                     f"{'steps':>8s} {'spent ε':>12s}")
        for tenant, rec in sorted(AuditLedger.replay(ledger_entries).items()):
            eps = rec["spent_epsilon"]
            lines.append(
                f"  {tenant:<16s} {rec['charges']:>8d} "
                f"{rec['refusals']:>8d} {rec['spent_steps']:>8d} "
                f"{eps if eps is None else format(eps, '>12.6g')}")
    return "\n".join(lines)


def render_path(path: str, ledger_path: Optional[str] = None,
                top: int = 20) -> str:
    from repro_torch.obs.exporters import read_jsonl
    from repro_torch.obs.ledger import AuditLedger
    ledger = AuditLedger.load(ledger_path) if ledger_path else None
    return render(read_jsonl(path), ledger_entries=ledger, top=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a telemetry JSONL artifact as a run summary")
    ap.add_argument("events", help="telemetry JSONL (obs.write_jsonl output)")
    ap.add_argument("--ledger", default=None,
                    help="ε-spend ledger JSONL (defaults to ledger events "
                         "embedded in the artifact)")
    ap.add_argument("--top", type=int, default=20,
                    help="how many hot counters to show")
    args = ap.parse_args(argv)
    print(render_path(args.events, args.ledger, args.top))  # noqa: T201
    return 0


if __name__ == "__main__":
    sys.exit(main())
