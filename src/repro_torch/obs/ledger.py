"""Append-only per-tenant ε-spend audit ledger (copy of ``repro.obs.ledger``;
docs/DESIGN.md §12).

A DP system's observability obligation is domain-specific: every charge
against a tenant's privacy budget, and every charge-free refusal, must
leave an auditable trail (the same concern that makes Khanna et al. account
explicitly for screening queries).  The ledger records, per entry, the
accountant state *before and after*, so the whole spend history is
replayable: ``replay()`` re-walks the chain, checks every transition
(``after.spent_steps == before.spent_steps + steps``, monotone, gap-free),
and recomputes each tenant's composed ε **through the accountant's own
formula** — the audit cannot drift from the implementation because it runs
the implementation.

Entry kinds (JSONL, one object per line, ``ev: "ledger"``):

  * ``open``    — accountant attached: its parameters + current state
                  (the chain base, so pre-spent accountants audit cleanly);
  * ``charge``  — ε-budget consumed: steps charged, request facts
                  (uid, ε, δ, T, queue, backend), state before/after;
  * ``refusal`` — request refused charge-free: the reason, and the state
                  (unchanged) when the tenant has an accountant.

The ledger is always-on (it is the DP audit trail, not diagnostics); when
the obs collector is active each entry is mirrored as a ``ledger`` event so
one artifact can carry the whole run.  Accountant state snapshots persist
through ``repro_torch.checkpoint`` (atomic npz + metadata, the JAX
package's layout) so a restarted service resumes from audited state instead
of resetting spent ε; a ledger or a checkpoint either package wrote replays
and restores in the other.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Mapping, Optional

from repro_torch.core.dp.accountant import PrivacyAccountant


def _acct_params(acct: PrivacyAccountant) -> dict:
    return {"epsilon": acct.epsilon, "delta": acct.delta,
            "total_steps": acct.total_steps}


def _acct_state(acct: PrivacyAccountant) -> dict:
    return {"spent_steps": acct.spent_steps,
            "remaining_steps": acct.remaining_steps,
            "spent_epsilon": acct.spent_epsilon()}


class AuditLedger:
    """Append-only ε-spend ledger, optionally mirrored to a JSONL file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: List[dict] = []
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            # append-only contract: an existing ledger is continued, never
            # truncated (a restarted service keeps one audit trail)
            self.entries = self.load(path) if os.path.exists(path) else []

    # ------------------------------------------------------------- appenders
    def _append(self, entry: dict) -> None:
        entry = {"ev": "ledger", "wall_unix": time.time(), **entry}
        self.entries.append(entry)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        from repro_torch import obs
        if obs.enabled():
            obs.event("ledger", **{k: v for k, v in entry.items()
                                   if k != "ev"})
            obs.count("ledger.entries", kind=entry["kind"])

    def open_tenant(self, tenant: str, acct: PrivacyAccountant) -> None:
        """Record the chain base for ``tenant`` (called once at attach)."""
        self._append({"kind": "open", "tenant": tenant,
                      "acct": _acct_params(acct), "state": _acct_state(acct)})

    def charge(self, *, tenant: str, uid: int, steps: int, before: dict,
               acct: PrivacyAccountant,
               request: Optional[dict] = None) -> None:
        """One budget charge: ``before`` is ``state_of(acct)`` captured just
        before ``acct.spend(steps)``; the after-state is read live."""
        self._append({"kind": "charge", "tenant": tenant, "uid": uid,
                      "steps": steps, "before": before,
                      "after": _acct_state(acct),
                      "acct": _acct_params(acct),
                      "request": request or {}})

    def refusal(self, *, tenant: str, uid: int, reason: str,
                acct: Optional[PrivacyAccountant] = None,
                request: Optional[dict] = None) -> None:
        """A charge-free rejection; state recorded when the tenant has an
        accountant (unknown tenants have no state to attest)."""
        entry = {"kind": "refusal", "tenant": tenant, "uid": uid,
                 "reason": reason, "steps": 0, "request": request or {}}
        if acct is not None:
            entry["acct"] = _acct_params(acct)
            entry["state"] = _acct_state(acct)
        self._append(entry)

    state_of = staticmethod(_acct_state)

    # --------------------------------------------------------------- replay
    @staticmethod
    def load(path: str) -> List[dict]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    @staticmethod
    def replay(entries: List[dict]) -> Dict[str, dict]:
        """Re-walk the ledger; per-tenant totals with chain verification.

        Returns ``{tenant: {"spent_steps", "spent_epsilon", "charges",
        "refusals", "charged_steps"}}`` where ``spent_epsilon`` is
        *recomputed* from the accountant parameters via
        ``PrivacyAccountant.spent_epsilon`` — bit-identical to what the live
        accountant reports, or the ledger is corrupt.  Raises ``ValueError``
        on any broken transition (skipped/negative/inconsistent spend).
        """
        out: Dict[str, dict] = {}
        last_spent: Dict[str, int] = {}
        params: Dict[str, dict] = {}
        for i, e in enumerate(entries):
            if e.get("ev") not in (None, "ledger") or "kind" not in e:
                continue
            t = e["tenant"]
            rec = out.setdefault(t, {"charges": 0, "refusals": 0,
                                     "charged_steps": 0})
            if e["kind"] == "open":
                params[t] = e["acct"]
                last_spent[t] = int(e["state"]["spent_steps"])
            elif e["kind"] == "charge":
                params.setdefault(t, e["acct"])
                before = int(e["before"]["spent_steps"])
                after = int(e["after"]["spent_steps"])
                base = last_spent.get(t, before)
                if before != base:
                    raise ValueError(
                        f"ledger entry {i}: tenant {t!r} before-state "
                        f"{before} != last known spend {base}")
                if after != before + int(e["steps"]):
                    raise ValueError(
                        f"ledger entry {i}: tenant {t!r} charge of "
                        f"{e['steps']} steps moved {before} -> {after}")
                last_spent[t] = after
                rec["charges"] += 1
                rec["charged_steps"] += int(e["steps"])
            elif e["kind"] == "refusal":
                rec["refusals"] += 1
                if "state" in e:
                    st = int(e["state"]["spent_steps"])
                    base = last_spent.setdefault(t, st)
                    if st != base:
                        raise ValueError(
                            f"ledger entry {i}: refusal for tenant {t!r} "
                            f"attests spend {st} != last known {base}")
        for t, rec in out.items():
            spent = last_spent.get(t, 0)
            rec["spent_steps"] = spent
            if t in params:
                acct = PrivacyAccountant(spent_steps=spent, **params[t])
                rec["spent_epsilon"] = acct.spent_epsilon()
            else:
                rec["spent_epsilon"] = None
        return out

    def totals(self) -> Dict[str, dict]:
        return self.replay(self.entries)

    def verify(self, accountants: Mapping[str, PrivacyAccountant]
               ) -> Dict[str, dict]:
        """Audit the ledger against live accountants.

        Exactness contract: for every tenant with ledger entries, the
        replayed ``spent_steps`` must equal the accountant's, and the
        recomputed ε must equal ``spent_epsilon()`` bit-for-bit.  Raises
        ``ValueError`` on the first mismatch; returns the per-tenant audit
        report otherwise.
        """
        totals = self.totals()
        for tenant, rec in totals.items():
            acct = accountants.get(tenant)
            if acct is None:
                raise ValueError(f"ledger names unknown tenant {tenant!r}")
            if rec["spent_steps"] != acct.spent_steps:
                raise ValueError(
                    f"tenant {tenant!r}: ledger replays {rec['spent_steps']} "
                    f"spent steps, accountant holds {acct.spent_steps}")
            live_eps = acct.spent_epsilon()
            if rec["spent_epsilon"] != live_eps:
                raise ValueError(
                    f"tenant {tenant!r}: ledger ε {rec['spent_epsilon']} != "
                    f"accountant ε {live_eps}")
            rec["accountant_epsilon"] = live_eps
            rec["exact"] = True
        return totals

    # ----------------------------------------------------------- checkpoint
    def checkpoint(self, directory: str,
                   accountants: Mapping[str, PrivacyAccountant]) -> str:
        """Persist accountant state atomically via ``repro_torch.checkpoint``.

        The snapshot is keyed by ledger length (monotone, so rotation keeps
        the newest) and carries the ledger path in its metadata; a restart
        restores accountants that agree with the audit trail instead of
        silently resetting spent ε.
        """
        import numpy as np

        from repro_torch.checkpoint.checkpointer import save_pytree
        tree = {t: {k: np.asarray(v) for k, v in a.to_state().items()}
                for t, a in accountants.items()}
        path = os.path.join(directory, f"accountants_{len(self.entries)}.npz")
        save_pytree(tree, path, metadata={
            "ledger_entries": len(self.entries),
            "ledger_path": self.path or "", "kind": "privacy_accountants"})
        return path

    @staticmethod
    def restore_accountants(path: str) -> Dict[str, PrivacyAccountant]:
        """Rebuild ``{tenant: PrivacyAccountant}`` from a checkpoint file."""
        import numpy as np
        out: Dict[str, Dict[str, float]] = {}
        with np.load(path) as z:
            for key in z.files:
                tenant, field = key.rsplit("/", 1)
                out.setdefault(tenant, {})[field] = z[key].item()
        return {t: PrivacyAccountant.from_state(state)
                for t, state in out.items()}
