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

3. **The write-side check** (:func:`donation_lowering_findings`): the
   reference lowers a donated step and checks that every aliased
   output sits on a carry leaf. Eager torch donates nothing, so the
   port reads the write side of one real recorded step
   (``analysis/step_lint.py``) instead: every in-place or ``out=``
   write lands in storage the step allocated, never in an input
   batch's or in the rollback checkpoint's.

4. **The reuse rule** (:func:`lint_donated_reuse`): an AST rule over the
   registered dispatch sites: after a step call, a read of a carry
   attribute before its re-assignment is a use-after-donate, unless its
   line carries ``# donated: ok(<why>)``.

Eager torch has no donation: a step returns fresh state tensors and a
span that requests donation only clones its window's rollback
checkpoint (``render/span_exec.py``). So the port's verdict always
reports ``wired=false`` with nothing in ``donated``, as the reference's
CPU backend does by default, and nothing records into the ledger on the
main path.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
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


# ---------------------------------------------------------------------------
# cross-check 1: a recorded step writes only what it allocated
# ---------------------------------------------------------------------------


def _storages(tree, path: str, out: dict) -> None:
    """storage key -> the first path that reaches it, over tensors,
    sequences, dicts and dataclasses (batches, arrangements, spines)."""
    import dataclasses

    import torch

    from .step_lint import storage_key

    if isinstance(tree, torch.Tensor):
        key = storage_key(tree)
        if key is not None:
            out.setdefault(key, path)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _storages(x, f"{path}[{i}]", out)
    elif isinstance(tree, dict):
        for k, x in tree.items():
            _storages(x, f"{path}[{k!r}]", out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _storages(getattr(tree, f.name), f"{path}.{f.name}", out)


def write_findings(record, inputs: dict, checkpoint) -> list:
    """The write side of one recorded step (``step_lint.record_step``):
    a finding for every write, by an operation whose schema marks an
    argument as written, into an input batch's storage, into the
    rollback checkpoint's (the carry as the step found it), or into
    storage that no operation of the step produced."""
    forbidden: dict = {}
    _storages(inputs, "inputs", forbidden)
    ck: dict = {}
    _storages(checkpoint, "checkpoint", ck)
    for k, v in ck.items():
        forbidden.setdefault(k, v)
    allocated = {k for op in record.ops for k in op.out_storages} - set(forbidden)
    findings: list = []
    for op in record.ops:
        for key in op.writes:
            if key in forbidden:
                what = f"writes in place into {forbidden[key]}"
            elif key not in allocated:
                what = "writes into storage the step did not allocate"
            else:
                continue
            findings.append(
                LintFinding(
                    UNSOUND_DONATION,
                    f"step-writes/{op.site}",
                    f"{op.name} {what}: a rollback replays the step from "
                    "its inputs and its checkpoint, so neither may change "
                    "under it",
                )
            )
    findings.sort(key=lambda f: (f.where, f.message))
    return findings


def donation_lowering_findings(device=None) -> list:
    """Record one real step of a tiny ``Get`` dataflow (the reference's
    fixture) and check its write side (:func:`write_findings`). The
    reference's second condition, that the bulk of the carry aliases,
    has no meaning without donation (ROADMAP Queue 3)."""
    import numpy as np

    from .. import resolve_device
    from ..expr import relation as mir
    from ..render.dataflow import Dataflow
    from ..repr.batch import Batch
    from ..repr.schema import Column, ColumnType, Schema
    from .step_lint import record_step

    device = resolve_device(device)
    sch = Schema((Column("k", ColumnType.INT64), Column("v", ColumnType.INT64)))
    df = Dataflow(mir.Get("src", sch), name="donation-xcheck", device=device)
    rng = np.random.default_rng(5)
    n = 16
    inputs = {
        "src": Batch.from_numpy(
            sch,
            [rng.integers(0, 8, n).astype(np.int64),
             rng.integers(0, 100, n).astype(np.int64)],
            np.zeros(n, np.uint64),
            rng.choice(np.asarray([1, 1, -1]), n).astype(np.int64),
            capacity=256, device=device,
        )
    }
    checkpoint = df._checkpoint()
    _out, record = record_step(df, inputs)
    return write_findings(record, inputs, checkpoint)


# ---------------------------------------------------------------------------
# cross-check 2: carry attributes never re-read after a step call
# ---------------------------------------------------------------------------

# The host attributes that hold the carry between dispatches. The port
# has no ``_time_dev`` (its time is a host int); the tuple stays the
# reference's so that both rules read a function alike.
CARRY_ATTRS = ("states", "output", "err_output", "_time_dev")

# Names a call's function must end in (or contain) to count as a step
# dispatch: the reference's, and the port's step call.
_DISPATCH_NAMES = ("jitfn", "step_fn", "_step_jit", "_step_core")

# (module, qualname) of every function that dispatches steps.
DONATED_DISPATCH_SITES = (
    ("materialize_tpu_torch.render.dataflow", "Dataflow._dispatch"),
    ("materialize_tpu_torch.render.dataflow", "Dataflow.run_span"),
    ("materialize_tpu_torch.render.dataflow", "ShardedDataflow._dispatch"),
    ("materialize_tpu_torch.render.dataflow", "ShardedDataflow.run_span"),
)


def _is_dispatch_call(node: ast.Call) -> bool:
    f = node.func
    name = None
    if isinstance(f, ast.Name):
        name = f.id
    elif isinstance(f, ast.Attribute):
        name = f.attr
    if name is None:
        return False
    return any(name.endswith(d) or d in name for d in _DISPATCH_NAMES)


def lint_donated_reuse_function(fn, where: str | None = None) -> list:
    """AST rule: after a step dispatch call, a read of a carry attribute
    (``self.states`` / ``self.output`` / ``self.err_output`` /
    ``self._time_dev``) before that attribute is re-assigned is a
    use-after-donate: under donation those buffers died at the dispatch.
    Lines carrying ``# donated: ok(<why>)`` are sanctioned. Lexical
    (line) order, as the reference's: loop back-edges re-enter through
    the re-assignments."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return []
    src_lines = src.splitlines()
    tree = ast.parse(src)
    name = where or getattr(fn, "__qualname__", str(fn))
    findings: list = []

    dispatch_lines = [
        node.lineno
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and _is_dispatch_call(node)
    ]
    if not dispatch_lines:
        return []

    def sanctioned(lineno: int) -> bool:
        if 1 <= lineno <= len(src_lines):
            line = src_lines[lineno - 1]
            if "#" in line:
                return line.split("#", 1)[1].strip().startswith("donated: ok")
        return False

    for attr in CARRY_ATTRS:
        loads, stores = [], []
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Attribute)
                and node.attr == attr
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                (
                    stores
                    if isinstance(node.ctx, (ast.Store, ast.Del))
                    else loads
                ).append(node.lineno)
        for d in dispatch_lines:
            # The dangerous window: (dispatch line, first store after].
            later_stores = [s for s in stores if s > d]
            window_end = min(later_stores) if later_stores else 10**9
            for line in loads:
                if d < line <= window_end and not sanctioned(line):
                    findings.append(
                        LintFinding(
                            USE_AFTER_DONATE,
                            f"{name}:{line}",
                            f"`self.{attr}` read after the dispatch at "
                            f"line {d} and before its re-assignment: "
                            "under donation that buffer is dead the "
                            "moment the dispatch returns. Re-assign "
                            "the carry first, or mark an intentional "
                            "pre-donation read with `# donated: "
                            "ok(<why>)`.",
                        )
                    )
    findings.sort(key=lambda f: (f.where, f.message))
    return findings


def lint_donated_reuse(extra=()) -> list:
    """Lint every registered dispatch function (plus ``extra``
    (module, qualname) pairs). Zero findings is the gate."""
    from .host_sync import _resolve

    findings: list = []
    for module_path, qualname in tuple(DONATED_DISPATCH_SITES) + tuple(extra):
        fn = _resolve(module_path, qualname)
        findings.extend(lint_donated_reuse_function(fn, where=qualname))
    findings.sort(key=lambda f: (f.where, f.message))
    return findings
