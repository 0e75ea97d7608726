"""Exporters (copy of ``repro.obs.exporters``): JSONL event log and
Prometheus-style text exposition, the same records and series names.

The JSONL log is the durable artifact (what CI uploads next to the
BENCH_*.json files and what ``python -m repro_torch.obs.report`` renders): one
meta line, every span/event in close order, then one line per metric
instrument.  The Prometheus text form is for scrape-style consumption —
counters as ``_total`` series, histograms as summary quantiles.
"""
from __future__ import annotations

import json
import re
from typing import List, Optional

from repro_torch.obs.core import Telemetry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def to_records(tel: Telemetry) -> List[dict]:
    """The full run as ordered JSON-ready records (meta, events, metrics)."""
    out = [{"ev": "meta", "wall_start_unix": tel.wall_start,
            "duration_s": round(tel.now(), 6), **tel.meta}]
    out.extend(tel.events)
    for rec in tel.metrics.snapshot():
        out.append({"ev": "metric", **rec})
    return out


def write_jsonl(tel: Telemetry, path: str) -> str:
    with open(path, "w") as f:
        for rec in to_records(tel):
            f.write(json.dumps(rec) + "\n")
    return path


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _prom_name(name: str, suffix: str = "") -> str:
    return "repro_" + _NAME_RE.sub("_", name) + suffix


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{_NAME_RE.sub("_", k)}="{v}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def prometheus_text(tel: Telemetry) -> str:
    """Counters/gauges/histograms in the Prometheus text format (0.0.4).

    Histograms expose the summary form: interpolated p50/p90/p99 quantile
    series plus ``_sum``/``_count`` — matching what ``FitService.stats()``
    reports, because both go through the same estimator.
    """
    lines: List[str] = []
    seen_types = set()
    for rec in tel.metrics.snapshot():
        kind, name, labels = rec["type"], rec["name"], rec["labels"]
        if kind == "counter":
            pname = _prom_name(name, "_total")
            if pname not in seen_types:
                seen_types.add(pname)
                lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname}{_prom_labels(labels)} {rec['value']}")
        elif kind == "gauge":
            pname = _prom_name(name)
            if pname not in seen_types:
                seen_types.add(pname)
                lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname}{_prom_labels(labels)} {rec['value']}")
        else:
            pname = _prom_name(name)
            if pname not in seen_types:
                seen_types.add(pname)
                lines.append(f"# TYPE {pname} summary")
            for q_key, q in (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99")):
                lines.append(
                    f"{pname}{_prom_labels(labels, {'quantile': q})} "
                    f"{rec[q_key]}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} {rec['sum']}")
            lines.append(f"{pname}_count{_prom_labels(labels)} "
                         f"{rec['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
