"""Host-side telemetry of the port (copy of ``repro.obs``): spans, metrics,
the DP audit ledger.

Telemetry is host-side only and a true no-op when disabled (docs/DESIGN.md
§12): instrumentation sits on per-solve and per-chunk host paths, never
inside a step's kernel launches, never touches a PRNG key, and never changes
a control-flow decision, so solver iterates are bit-identical with telemetry
on or off (``tests/test_torch_obs.py``).

    from repro_torch import obs

    with obs.session(jsonl_path="run-events.jsonl"):
        res = solve(X, y, config)          # spans/counters recorded
    obs.count("my.counter", 3, kind="demo")
    with obs.span("my.phase", size=n):
        ...
    obs.observe("my.latency_s", dt)        # histogram w/ interpolated p50/90/99

The record formats (JSONL events, Prometheus text, the ledger's JSONL and
its accountant checkpoints) are the JAX package's, so either package reads
what the other wrote; ``python -m repro_torch.obs.report`` renders a run.
"""
from repro_torch.obs.core import (Telemetry, count, disable, enable,  # noqa: F401
                            enabled, event, gauge, get, observe, session,
                            span)
from repro_torch.obs.exporters import prometheus_text, write_jsonl  # noqa: F401
from repro_torch.obs.ledger import AuditLedger  # noqa: F401
from repro_torch.obs.metrics import quantile  # noqa: F401
