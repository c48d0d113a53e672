"""Buffer-provenance analysis over the render-layer state trees (the
port's copy of ``materialize_tpu/analysis/provenance.py``).

The pass walks every registered root of a dataflow's or a view's device
state:

- the span carry (operator states, the output ``Spine``, the err
  arrangement; the port keeps no device time scalar),
- rollback checkpoints and the deferred-span input log,
- ``MaintainedView`` multiversion history entries (device-resident),
- ``IndexSource`` subscriber base snapshots and pending delta queues,

and assigns each device leaf a set of provenance classes plus the list
of holders (root, path) that reach it. Two holders reaching one leaf is
the sharing graph; a leaf reachable from a carry part and from any root
outside that carry makes the part un-donatable (``analysis/donation.py``
turns this into the verdict).

A leaf is a ``torch.Tensor``, identified by its storage (device and
``untyped_storage().data_ptr()``), not by ``id()``: a view shares its
base's buffer, and the port's render layer hands out views (the rows of
a stacked accumulator, a sliced batch). Tensors over one storage are one
leaf, so the port can count fewer leaves than the reference, which
counts array objects; the sharing verdicts are the same. A tensor with
no storage bytes has no buffer to share and is keyed by its object.
The pass is pure host work: no device transfers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

# Provenance classes -------------------------------------------------------

PROV_CARRY = "span-carry-owned"
PROV_SHARED = "shared-across-dataflows"
PROV_HOST = "host-retained"
PROV_CACHE = "cache-retained"

# Roots whose class is PROV_CARRY, keyed by carry part name, in the
# reference's order (its span program's donated argnums); the donation
# verdict is per entry.
CARRY_PARTS = ("states", "output", "err_output", "time_dev")


def leaf_key(t: torch.Tensor) -> tuple:
    """Identity of the buffer under ``t``: (device, storage address);
    a tensor without storage bytes is keyed by its object."""
    st = t.untyped_storage()
    if st.nbytes() == 0:
        return ("empty", id(t))
    return (str(t.device), st.data_ptr())


def leaves_with_path(tree, path: str = ""):
    """(path, tensor) for every tensor under ``tree``: tuples, lists,
    dicts and dataclass instances (batches, arrangements, spines) are
    walked; anything else is not a leaf."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from leaves_with_path(x, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k, x in tree.items():
            yield from leaves_with_path(x, f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if f.name == "schema":
                continue  # column metadata, never a tensor
            yield from leaves_with_path(getattr(tree, f.name), f"{path}.{f.name}")


@dataclass
class LeafRecord:
    """One device buffer's provenance: every (root, path) holder that
    can reach it, and the classes those holders imply."""

    leaf_id: tuple
    shape: tuple
    dtype: str
    nbytes: int
    classes: set = field(default_factory=set)
    holders: list = field(default_factory=list)  # [(root, path_str)]

    def chain(self) -> str:
        """Human-readable provenance chain (who holds this buffer)."""
        return " ; ".join(f"{root}{path}" for root, path in self.holders)


@dataclass
class ProvenanceReport:
    """The scan result over a set of named dataflows/views."""

    leaves: dict = field(default_factory=dict)  # leaf key -> LeafRecord
    # producer dataflow -> {consumer root names aliasing its carry}
    sharing: dict = field(default_factory=dict)
    # dataflow -> carry part -> [leaf keys]
    carries: dict = field(default_factory=dict)

    # -- scan helpers --------------------------------------------------------
    def add_root(self, root: str, cls: str, tree) -> list:
        """Record every device leaf under ``tree`` as reachable from
        ``root`` with class ``cls``; returns the leaf keys."""
        ids = []
        for path, leaf in leaves_with_path(tree):
            key = leaf_key(leaf)
            rec = self.leaves.get(key)
            if rec is None:
                rec = LeafRecord(
                    key,
                    tuple(leaf.shape),
                    str(leaf.dtype),
                    int(leaf.untyped_storage().nbytes()),
                )
                self.leaves[key] = rec
            rec.classes.add(cls)
            rec.holders.append((root, path or "."))
            ids.append(key)
        return ids

    # -- queries -------------------------------------------------------------
    def class_census(self) -> dict:
        out: dict = {}
        for rec in self.leaves.values():
            for c in rec.classes:
                out[c] = out.get(c, 0) + 1
        return out

    def shared_leaves(self, df_name: str, part: str) -> list:
        """Leaf records under ``df_name``'s carry ``part`` that some
        holder OUTSIDE that carry also reaches (the un-donatable set)."""
        carry_root = f"{df_name}/carry"
        out = []
        for lid in dict.fromkeys(self.carries.get(df_name, {}).get(part, ())):
            rec = self.leaves[lid]
            if any(
                not root.startswith(carry_root)
                for root, _ in rec.holders
            ):
                out.append(rec)
        return out


def _carry_tree(df) -> dict:
    """The span's carry, keyed by part name."""
    return {
        "states": tuple(df.states),
        "output": df.output,
        "err_output": df.err_output,
        "time_dev": getattr(df, "_time_dev", None),
    }


def scan_dataflow(report: ProvenanceReport, name: str, df) -> None:
    """Scan one rendered dataflow's device roots into ``report``."""
    carry = _carry_tree(df)
    parts: dict = {}
    for part in CARRY_PARTS:
        parts[part] = report.add_root(
            f"{name}/carry/{part}", PROV_CARRY, carry[part]
        )
    report.carries[name] = parts
    # Rollback retention: the deferred-window checkpoint and input log.
    # A window that requested donation clones its checkpoint to fresh
    # tensors; the port's plain checkpoint holds the carry's own tensors
    # (its steps never update them in place).
    ck = getattr(df, "_defer_ck", None)
    if ck is not None:
        report.add_root(f"{name}/defer_ck", PROV_HOST, ck)
    for i, (inputs, _flush) in enumerate(getattr(df, "_defer_log", ())):
        report.add_root(f"{name}/defer_log[{i}]", PROV_HOST, inputs)


def scan_view(report: ProvenanceReport, name: str, view) -> None:
    """Scan one MaintainedView: its dataflow's roots plus the
    view-level retentions (multiversion history, subscriber handoffs)."""
    scan_dataflow(report, name, view.df)
    for t, upd in getattr(view, "_history", ()):
        if not isinstance(upd, tuple):  # device-resident entry
            report.add_root(f"{name}/history[t={t}]", PROV_HOST, upd)
    carry_ids = set()
    for ids in report.carries.get(name, {}).values():
        carry_ids.update(ids)
    for si, sub in enumerate(getattr(view, "_subscribers", ())):
        if not getattr(sub, "_device", False):
            continue  # host-path subscribers copy through numpy
        sroot = f"{name}/subscriber[{si}]"
        base = getattr(sub, "base_batch", None)
        base_ids = (
            report.add_root(f"{sroot}/base", PROV_SHARED, base)
            if base is not None
            else []
        )
        pend_ids = []
        for t, upd in getattr(sub, "_pending", ()):
            pend_ids.extend(
                report.add_root(f"{sroot}/pending[t={t}]", PROV_SHARED, upd)
            )
        # Sharing graph: does this subscriber alias the publisher's
        # carry? (The base snapshot is the publisher's output base, so
        # it does; pending deltas are step outputs and should not.)
        if carry_ids.intersection(base_ids + pend_ids):
            report.sharing.setdefault(name, set()).add(sroot)


def scan_replica(views: dict) -> ProvenanceReport:
    """Scan every installed view of a replica (name -> MaintainedView):
    cross-dataflow aliasing (one view's IndexSource holding another
    view's spine) falls out of the shared leaf table."""
    report = ProvenanceReport()
    for name, view in sorted(views.items()):
        scan_view(report, name, view)
    # Cross-dataflow sharing: a leaf under view A's carry that any root
    # of a different view reaches.
    for name in views:
        carry_ids = set()
        for ids in report.carries.get(name, {}).values():
            carry_ids.update(ids)
        for lid in carry_ids:
            for root, _ in report.leaves[lid].holders:
                owner = root.split("/", 1)[0]
                if owner != name:
                    report.sharing.setdefault(name, set()).add(root)
                    report.leaves[lid].classes.add(PROV_SHARED)
    return report
