"""Donation-safety verdicts and the use-after-donate sanitizer (the host
half of ``materialize_tpu/analysis/donation.py``, ``:68-290``).

One contract: a buffer handed over by donation is dead after dispatch,
and nothing on the host may read it, re-dispatch it or keep it in
history.

1. **The prover** (:func:`view_verdict`): turns the buffer-provenance
   scan (``analysis/provenance.py``) into a per-part verdict. A
   span-carry part (states / output / err_output / time_dev) is
   donatable iff no device leaf reachable from it is also reachable
   from a root outside that carry (an ``IndexSource`` base snapshot, a
   multiversion-history entry, a plain rollback checkpoint, another
   dataflow).

2. **The sanitizer** (:class:`DonationLedger`, dyncfg
   ``buffer_sanitizer``): a donated dispatch records the killed carry
   leaves (weak references: the ledger never extends a buffer's life)
   with the chain that owned them; guarded read sites (``guard_read``:
   ``IndexSource`` snapshots and fetches, multiversion rewinds, span
   operand packing) raise :class:`UseAfterDonateError` naming the holder
   that still read the dead buffer.

Eager torch has no donation: a step returns fresh state tensors and a
span that requests donation only clones its window's rollback
checkpoint (``render/span_exec.py``). So the port's verdict always
reports ``wired=false`` with nothing in ``donated``, as the reference's
CPU backend does by default, and nothing records into the ledger on the
main path. The lowering cross-check and the donated-leaf AST rule
(reference ``:305-510``) read XLA programs and wait for a counterpart
over torch programs (ROADMAP Queue 1).
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

from .provenance import (
    CARRY_PARTS,
    ProvenanceReport,
    leaf_key,
    leaves_with_path,
    scan_view,
)

USE_AFTER_DONATE = "use-after-donate"
UNSOUND_DONATION = "unsound-donation"


@dataclass
class LintFinding:
    """One analysis finding (the reference's ``jaxpr_lint.LintFinding``)."""

    lint_id: str
    where: str
    message: str

    def __str__(self):
        return f"[{self.lint_id}] at {self.where or '<top>'}: {self.message}"


class UseAfterDonateError(RuntimeError):
    """A buffer donated to a span was read (or re-dispatched) after the
    dispatch that killed it."""


def sanitizer_enabled() -> bool:
    from ..utils.dyncfg import BUFFER_SANITIZER, COMPUTE_CONFIGS

    return bool(BUFFER_SANITIZER(COMPUTE_CONFIGS))


# ---------------------------------------------------------------------------
# the runtime ledger
# ---------------------------------------------------------------------------


class DonationLedger:
    """Registry of dead (donated) device buffers, keyed by storage
    identity (``provenance.leaf_key``) and validated by a weak reference
    to the recorded tensor: a storage address reused after the donated
    tensor was freed can never be a false positive."""

    def __init__(self):
        self._lock = threading.Lock()
        # leaf key -> (weakref to the recorded tensor, provenance chain)
        self._entries: dict = {}
        self.recorded = 0
        self.caught = 0

    def record(self, tree, chain: str) -> int:
        """Mark every device leaf of ``tree`` as donated (dead).
        ``chain`` names the dispatch that killed it. Returns the number
        of leaves recorded."""
        n = 0
        with self._lock:
            if len(self._entries) > 65536:
                self._entries = {
                    k: v for k, v in self._entries.items() if v[0]() is not None
                }
            for _path, leaf in leaves_with_path(tree):
                self._entries[leaf_key(leaf)] = (weakref.ref(leaf), chain)
                n += 1
            self.recorded += n
        return n

    def check(self, tree, who: str) -> None:
        """Raise UseAfterDonateError if any device leaf of ``tree`` was
        donated. ``who`` names the reader (the alias holder)."""
        with self._lock:
            for path, leaf in leaves_with_path(tree):
                key = leaf_key(leaf)
                entry = self._entries.get(key)
                if entry is None:
                    continue
                dead = entry[0]()
                if dead is None or leaf_key(dead) != key:
                    continue  # freed, and the address reused
                self.caught += 1
                raise UseAfterDonateError(
                    f"use-after-donate: {who}{path or '.'} reads a "
                    f"buffer that was donated by {entry[1]} — the "
                    "reader still held an alias into the donated carry "
                    "(resolve by cloning at the sharing boundary, or "
                    "exclude the part from donation)"
                )

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


LEDGER = DonationLedger()


def record_donated(tree, chain: str) -> None:
    """Ledger write gated on the ``buffer_sanitizer`` dyncfg (no leaf
    walk when off)."""
    if sanitizer_enabled():
        LEDGER.record(tree, chain)


def guard_read(tree, who: str) -> None:
    """Read-site guard: validates ``tree`` against the donated-buffer
    ledger when the sanitizer is on. Wired at the reads the provenance
    analysis names as alias-capable: ``IndexSource`` base snapshots and
    pending fetches, multiversion-history rewinds, span operand
    packing."""
    if sanitizer_enabled():
        LEDGER.check(tree, who)


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------


@dataclass
class DonationVerdict:
    """Per-part donation safety for one dataflow's span carry."""

    name: str
    requested: bool
    donatable: dict = field(default_factory=dict)  # part -> bool
    reasons: list = field(default_factory=list)
    provenance: dict = field(default_factory=dict)  # class -> leaf count
    findings: list = field(default_factory=list)  # LintFindings (unsound)

    @property
    def safe(self) -> bool:
        return all(self.donatable.get(p, False) for p in CARRY_PARTS)

    def donate_parts(self) -> tuple:
        """The provably safe subset of the carry to donate (empty tuple:
        do not donate)."""
        return tuple(p for p in CARRY_PARTS if self.donatable.get(p))

    def describe(self) -> str:
        parts = ",".join(self.donate_parts()) or "none"
        prov = " ".join(
            f"{k}={v}" for k, v in sorted(self.provenance.items())
        )
        head = (
            f"donation: safe={str(self.safe).lower()} "
            f"donatable=[{parts}] provenance({prov})"
        )
        if self.reasons:
            head += "\n  " + "\n  ".join(self.reasons)
        return head

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "safe": self.safe,
            "requested": self.requested,
            "donatable": dict(self.donatable),
            "reasons": list(self.reasons),
            "provenance": {
                k: int(v) for k, v in self.provenance.items()
            },
        }


def verdict_display(v: dict) -> tuple:
    """(donated, provenance) display strings for one reported verdict
    dict: the one formatter behind EXPLAIN ANALYSIS's donation block and
    the mz_donation rows, so the two surfaces cannot disagree."""
    donated = ",".join(v.get("donated", [])) or "none"
    prov = " ".join(
        f"{k}={n}"
        for k, n in sorted((v.get("provenance") or {}).items())
    )
    return donated, prov


def view_verdict(
    name: str,
    view,
    requested: bool = True,
    report: ProvenanceReport | None = None,
) -> DonationVerdict:
    """Prove (or refute) donation safety for one MaintainedView's span
    train: each carry part is donatable iff nothing outside the carry
    aliases it. An aliased part of the current window's donated set is
    additionally an UNSOUND finding."""
    if report is None:
        report = ProvenanceReport()
        scan_view(report, name, view)
    v = DonationVerdict(
        name=name,
        requested=bool(requested),
        provenance=report.class_census(),
    )
    donated_window = getattr(view.df, "_defer_donated", ())
    for part in CARRY_PARTS:
        shared = report.shared_leaves(name, part)
        v.donatable[part] = not shared
        for rec in shared:
            reason = (
                f"{part}: leaf {rec.dtype}{list(rec.shape)} aliased by "
                f"{rec.chain()}"
            )
            v.reasons.append(reason)
            if part in donated_window:
                v.findings.append(
                    LintFinding(
                        UNSOUND_DONATION,
                        f"{name}/{part}",
                        f"donated carry part is aliased: {reason}",
                    )
                )
    return v


def dataflow_verdict(name: str, df, requested: bool = True):
    """Verdict for a bare rendered Dataflow (no view-level retentions):
    a freshly rendered, subscriber-less dataflow proves fully
    donatable."""
    from .provenance import scan_dataflow

    report = ProvenanceReport()
    scan_dataflow(report, name, df)
    return view_verdict(name, _BareDataflowView(df), requested, report=report)


class _BareDataflowView:
    """A bare Dataflow with the view surface view_verdict touches (no
    history, no subscribers)."""

    def __init__(self, df):
        self.df = df
        self._history = ()
        self._subscribers = ()
