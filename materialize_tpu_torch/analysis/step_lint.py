"""Hazard linter over one recorded eager step (the port's counterpart of
``materialize_tpu/analysis/jaxpr_lint.py``).

The reference compiles each dataflow to one jitted step program and
lints its jaxpr. The port's step is an eager train: it has no program
to read, but it has the exact sequence of aten operations that one step
dispatches, and a ``TorchDispatchMode`` sees each of them with its
dtypes, shapes, devices and bytes. That record is the port's program.
``record_step(df, inputs)`` runs one real step of a ``Dataflow`` or a
``ShardedDataflow`` under the mode and returns the step's output with
the record; recording changes no result.

The eager train's work depends on the data (a quiet side is skipped, a
LetRec stops early, a slot can be empty), so a record is of a given
tick, not of empty abstract inputs as the reference's
``trace_dataflow_step`` is. What the dispatcher cannot see is added
from where the work is counted:

- the hand kernel launches through ``ctypes`` (``ops/merge_kernel.py``):
  the record takes its launches, in all and by shape, from
  ``merge_kernel.LAUNCHES`` / ``LAUNCHES_BY_SHAPE``, and the census
  names it ``merge_path``;
- a LetRec's binding deltas, which the render pads to the site's tier
  every evaluation: it reports each evaluation's signature to the
  recorder (``_RenderContext.carry_probe``).

Collectives reach the dispatcher as ``c10d`` operations on the gloo and
NCCL backends alike; the census gives them the reference's kind names
(``all_to_all``, ``psum``) and their bytes per device, as
``parallel/mesh.py`` logs them.

The finding kinds and ``LintFinding`` are the reference's, read over
the record:

- ``f64-leak``: float64 tensors in a step whose plan has no FLOAT64
  column (an untyped float that became a double). The card computes
  doubles natively, so a plan that declares a FLOAT64 column is not
  flagged for it;
- ``host-callback``: the step's device-to-host reads:
  ``_local_scalar_dense`` (``.item()``, ``int()``, ``bool()``), blocking
  copies to the CPU, and the operations that read a size back
  (``nonzero``, ``masked_select``, ``unique``, boolean-mask indexing).
  A call site whose source line carries the host-sync linter's
  ``# host-sync: ok(<why>)`` pragma is sanctioned, as there;
- ``dyn-shape``: operations whose output shape depends on the data;
- ``carry-vary``: a state or LetRec binding whose shape or dtype
  changed across the step with no tier growth recorded by the render;
- ``big-const``: tensors made from host data inside the step (uploads,
  ``torch.tensor`` of host values) of ``DEFAULT_MAX_CONST_BYTES`` or
  more.

Each finding's ``where`` is the call site (``path:line``, relative to
the repository) of the operations it names; a carry's is its path in
the state tree. ``op_census``, ``kernel_count`` and
``intermediate_bytes`` read the same record: ``kernel_count`` is the
device operations the step issues (every dispatched operation that is
not a view and touches the step's device, the merge kernel's launches
and the collectives).

    from materialize_tpu_torch.analysis.step_lint import lint_dataflow
    findings, record = lint_dataflow(df, inputs)   # steps df one tick
"""

from __future__ import annotations

import dataclasses
import linecache
import os
import sys
from collections import Counter
from dataclasses import dataclass, field

import torch

F64_LEAK = "f64-leak"
HOST_CALLBACK = "host-callback"
DYN_SHAPE = "dyn-shape"
CARRY_VARY = "carry-vary"
BIG_CONST = "big-const"

# Default threshold for big-const: anything >= 1 MiB made from host data
# inside the step is a real per-step upload.
DEFAULT_MAX_CONST_BYTES = 1 << 20

# Paths in the record are relative to the repository root.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_THIS = os.path.abspath(__file__)

# Operations whose output size is read back from the device.
_DYN_SHAPE_OPS = frozenset({
    "aten.nonzero.default",
    "aten.masked_select.default",
    "aten.unique_dim.default",
    "aten.unique_consecutive.default",
    "aten.unique_dim_consecutive.default",
    "aten._unique.default",
    "aten._unique2.default",
    "aten.repeat_interleave.Tensor",
    "aten.repeat_interleave.self_Tensor",
})
# Operations that return a host value.
_SCALAR_READ_OPS = frozenset({
    "aten._local_scalar_dense.default",
    "aten.equal.default",
    "aten.is_nonzero.default",
})
_LIFT_OPS = frozenset({"aten.lift_fresh.default", "aten.lift_fresh_copy.default"})
_INDEX_OPS = frozenset({
    "aten.index.Tensor", "aten.index_put_.default", "aten.index_put.default",
    "aten._index_put_impl_.default",
})
# c10d operations under the census's kind names: (kind, argument
# position of the tensors whose bytes one device sends).
_COLLECTIVES = {
    "c10d.allreduce_.default": ("psum", 0),
    "c10d.alltoall_base_.default": ("all_to_all", 1),
}


@dataclass(frozen=True)
class LintFinding:
    lint_id: str
    where: str  # call site "path:line", or a carry's path
    message: str

    def __str__(self):
        return f"[{self.lint_id}] at {self.where or '<top>'}: {self.message}"


@dataclass(frozen=True)
class OpRecord:
    """One dispatched aten (or c10d) operation."""

    name: str  # "aten.cat.default"
    in_dtypes: tuple
    in_shapes: tuple
    in_devices: tuple
    out_dtypes: tuple
    out_shapes: tuple
    out_devices: tuple
    in_nbytes: tuple  # bytes of each input tensor
    out_bytes: int
    site: str  # innermost caller outside torch: "path:line"
    view: bool
    non_blocking: bool = False
    # An indexing operation with a boolean mask among its indices.
    mask_index: bool = False

    @property
    def in_bytes(self) -> int:
        return sum(self.in_nbytes)

    def device_op(self, device: str) -> bool:
        """Whether it issues work on ``device`` (the step's): a view
        issues none, and on a card an operation on host tensors only
        (a CPU scalar, a host copy's staging) runs on the host."""
        if self.view:
            return False
        return device == "cpu" or any(
            d != "cpu" for d in self.in_devices + self.out_devices)

    def upload_bytes(self, device: str) -> int:
        """Bytes of host data this operation puts into a tensor on
        ``device`` (the step's): a tensor made there from host values
        (``torch.tensor``, ``torch.from_numpy``), a copy from the CPU, a
        host scalar stored into a tensor."""
        src, dst = self._copy_ends()
        if self.name in _LIFT_OPS:
            return self.out_bytes if self.out_devices[:1] == (device,) else 0
        if src == "cpu" and dst not in (None, "cpu"):
            return self.in_nbytes[1] if self.name == "aten.copy_.default" else self.in_nbytes[0]
        if self.name in _INDEX_OPS and self.in_devices[0] != "cpu":
            return sum(n for n, d in zip(self.in_nbytes[1:], self.in_devices[1:])
                       if d == "cpu")
        return 0

    def _copy_ends(self) -> tuple:
        """(source device, destination device) of a copy, else
        (None, None)."""
        if self.name == "aten.copy_.default":  # copy_(dst, src)
            return self.in_devices[1], self.in_devices[0]
        if self.name == "aten._copy_from.default":  # _copy_from(src, dst)
            return self.in_devices[0], self.in_devices[1]
        if self.name == "aten._to_copy.default" and self.out_devices:
            return self.in_devices[0], self.out_devices[0]
        return None, None

    def host_read(self) -> str | None:
        """Why this operation reads device data back to the host, or
        None."""
        if self.name in _SCALAR_READ_OPS:
            return "a scalar read back to the host"
        if self.name in _DYN_SHAPE_OPS:
            return "an output size read back to the host"
        if self.mask_index:
            return "a boolean mask's row count read back to the host"
        src, dst = self._copy_ends()
        if dst == "cpu" and src not in (None, "cpu") and not self.non_blocking:
            return "a blocking copy to the host"
        return None

    def dyn_shape(self) -> bool:
        return self.name in _DYN_SHAPE_OPS or (
            self.name == "aten.index.Tensor" and self.mask_index)


@dataclass
class StepRecord:
    """Everything one recorded step did: its operations in order, the
    hand kernel's launches, its collectives, and its carries' signatures
    before and after."""

    ops: list = field(default_factory=list)
    merge_launches: int = 0
    merge_by_shape: dict = field(default_factory=dict)
    carries_before: dict = field(default_factory=dict)
    carries_after: dict = field(default_factory=dict)
    # LetRec site -> binding signatures, one per evaluation.
    letrec_carries: dict = field(default_factory=dict)
    grown: list = field(default_factory=list)
    plan_has_f64: bool = False
    # The step's device type: "cuda" where any operation touched a card.
    device: str = "cpu"
    # Call sites whose source line carries ``# host-sync: ok(<why>)``.
    sanctioned_sites: set = field(default_factory=set)

    @property
    def collectives(self) -> list:
        """[(kind, bytes per device)] in dispatch order, as
        ``parallel/mesh.py`` records them."""
        out = []
        for op in self.ops:
            kind = _COLLECTIVES.get(op.name)
            if kind is not None:
                out.append((kind[0], op.in_bytes))
        return out

    def device_ops(self) -> list:
        """The recorded operations that issued work on the step's
        device."""
        return [op for op in self.ops if op.device_op(self.device)]

    def h2d_bytes(self) -> int:
        """Bytes of host data the step put into tensors on its device."""
        return sum(op.upload_bytes(self.device) for op in self.ops)

    def sync_sites(self) -> Counter:
        """Call site -> operations there that read back to the host or
        upload host data blocking (sanctioned ones included)."""
        return Counter(op.site for op in self.ops if op.host_read() is not None
                       or (op.upload_bytes(self.device) and not op.non_blocking))


def _site() -> tuple:
    """(site, absolute path, line) of the innermost caller outside torch
    and this module."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(_TORCH_DIR) and fn != _THIS:
            return f"{os.path.relpath(fn, ROOT)}:{f.f_lineno}", fn, f.f_lineno
        f = f.f_back
    return "<torch>", "", 0


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _describe(ts) -> tuple:
    return (tuple(str(t.dtype) for t in ts), tuple(tuple(t.shape) for t in ts),
            tuple(t.device.type for t in ts),
            tuple(t.numel() * t.element_size() for t in ts))


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Appends an ``OpRecord`` for every operation dispatched while it is
    the active mode; runs each operation unchanged."""

    def __init__(self, ops: list):
        super().__init__()
        self.ops = ops
        self.sanctioned: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        kind = _COLLECTIVES.get(name)
        ins = (_tensors(args[kind[1]]) if kind is not None
               else _tensors((args, kwargs)))
        outs = [] if kind is not None else _tensors(out)
        idt, ish, idev, ib = _describe(ins)
        odt, osh, odev, ob = _describe(outs)
        ob = sum(ob)
        site, path, line = _site()
        if path and site not in self.sanctioned:
            text = linecache.getline(path, line)
            self.sanctioned[site] = (
                "#" in text and text.split("#", 1)[1].strip().startswith("host-sync: ok"))
        nb = bool(kwargs.get("non_blocking", False)) or (
            name == "aten.copy_.default" and len(args) > 2 and bool(args[2]))
        mask = name in _INDEX_OPS and any(
            t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1]))
        self.ops.append(OpRecord(
            name, idt, ish, idev, odt, osh, odev, ib, ob, site,
            bool(getattr(func, "is_view", False)), nb, mask))
        return out


def _carry_signature(tree, path: str, out: dict) -> None:
    """path -> (shape, dtype) of every tensor of a state tree (tuples and
    lists of arrangements, spines, batches and tensors)."""
    if isinstance(tree, torch.Tensor):
        out[path] = (tuple(tree.shape), str(tree.dtype))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _carry_signature(x, f"{path}[{i}]", out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _carry_signature(getattr(tree, f.name), f"{path}.{f.name}", out)


def _carries(df) -> dict:
    out: dict = {}
    _carry_signature(list(getattr(df, "states", ())), "states", out)
    for name in ("output", "err_output"):
        if hasattr(df, name):
            _carry_signature(getattr(df, name), name, out)
    return out


def _plan_has_f64(expr) -> bool:
    if expr is None:
        return False
    stack, seen = [expr], set()
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if any(c.ctype.value == "float64" for c in e.schema().columns):
            return True
        stack.extend(e.children())
    return False


def record_call(fn, *args, ctx=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the recorder: (its result, a
    ``StepRecord`` of its operations and merge launches). ``ctx``: a
    render context whose LetRec evaluations report their binding deltas
    to the record."""
    from ..ops import merge_kernel

    rec = StepRecord()
    launches0 = merge_kernel.LAUNCHES
    shapes0 = Counter(merge_kernel.LAUNCHES_BY_SHAPE)
    probe0 = None
    if ctx is not None:
        probe0 = ctx.carry_probe

        def probe(site, deltas):
            sig: dict = {}
            _carry_signature(deltas, "bindings", sig)
            rec.letrec_carries.setdefault(site, []).append(sig)

        ctx.carry_probe = probe
    mode = _Recorder(rec.ops)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        if ctx is not None:
            ctx.carry_probe = probe0
    rec.merge_launches = merge_kernel.LAUNCHES - launches0
    rec.merge_by_shape = dict(Counter(merge_kernel.LAUNCHES_BY_SHAPE) - shapes0)
    rec.sanctioned_sites = {s for s, ok in mode.sanctioned.items() if ok}
    if any(d != "cpu" for op in rec.ops for d in op.in_devices + op.out_devices):
        rec.device = "cuda"
    return out, rec


def record_step(df, inputs: dict):
    """One real step of ``df`` (``df.step(inputs)``) under the recorder:
    (the step's output delta, its ``StepRecord``). The dataflow advances
    one tick, exactly as an unrecorded step would advance it."""
    before = _carries(df)
    grown0 = len(getattr(df, "_grown", ()))
    out, rec = record_call(df.step, inputs, ctx=getattr(df, "_ctx", None))
    rec.carries_before = before
    rec.carries_after = _carries(df)
    rec.grown = list(getattr(df, "_grown", ())[grown0:])
    rec.plan_has_f64 = _plan_has_f64(getattr(df, "expr", None))
    return out, rec


def _by_site(ops) -> dict:
    out: dict = {}
    for op in ops:
        out.setdefault(op.site, []).append(op)
    return out


def _names(ops) -> str:
    return ", ".join(f"{n} x{c}" for n, c in sorted(Counter(o.name for o in ops).items()))


def lint_record(record: StepRecord,
                max_const_bytes: int = DEFAULT_MAX_CONST_BYTES) -> list:
    """Every hazard finding of one recorded step, deterministically
    ordered."""
    findings: list = []
    sanctioned = record.sanctioned_sites
    if not record.plan_has_f64:
        f64 = [o for o in record.ops if "torch.float64" in o.in_dtypes + o.out_dtypes]
        for site, ops in _by_site(f64).items():
            findings.append(LintFinding(
                F64_LEAK, site,
                f"{len(ops)} float64 operation(s) ({_names(ops)}) in a step whose "
                "plan has no FLOAT64 column: an untyped Python float became a "
                "double. Type the literal, or use a DECIMAL (scaled int64) "
                "column where it serves exactly",
            ))
    reads = [o for o in record.ops if o.host_read() is not None and o.site not in sanctioned]
    for site, ops in _by_site(reads).items():
        why = sorted({o.host_read() for o in ops})
        findings.append(LintFinding(
            HOST_CALLBACK, site,
            f"{len(ops)} device->host read(s) on the hot path ({_names(ops)}: "
            f"{'; '.join(why)}): every step waits for the device there and "
            "cannot be captured in a CUDA graph; keep the value on the device "
            "or read it at the span boundary",
        ))
    dyn = [o for o in record.ops if o.dyn_shape()]
    for site, ops in _by_site(dyn).items():
        findings.append(LintFinding(
            DYN_SHAPE, site,
            f"{len(ops)} data-dependent output shape(s) ({_names(ops)}): the "
            "step's shapes follow its data, so no fixed program can replay it; "
            "use a static capacity tier with an overflow flag "
            "(render/dataflow.py's tier scheme)",
        ))
    if not record.grown:
        b, a = record.carries_before, record.carries_after
        for path in sorted(set(b) | set(a)):
            if b.get(path) != a.get(path):
                findings.append(LintFinding(
                    CARRY_VARY, path,
                    f"carried value changed from {b.get(path)} to {a.get(path)} "
                    "across the step with no tier growth recorded: pad every "
                    "carried value to a static capacity tier and carry a row "
                    "count, as the render does for LetRec binding deltas",
                ))
        for site, sigs in sorted(record.letrec_carries.items()):
            if any(s != sigs[0] for s in sigs[1:]):
                findings.append(LintFinding(
                    CARRY_VARY, f"letrec[{site[1]}]",
                    f"LetRec binding deltas changed shape or dtype between its "
                    f"{len(sigs)} evaluations with no tier growth recorded: pad "
                    "them to the site's tier every evaluation",
                ))
    big = [o for o in record.ops if o.upload_bytes(record.device) >= max_const_bytes]
    for site, ops in _by_site(big).items():
        nb = max(o.upload_bytes(record.device) for o in ops)
        findings.append(LintFinding(
            BIG_CONST, site,
            f"{nb} bytes of host data ({_names(ops)}) made into a tensor "
            "inside the step: the upload repeats every step; keep device "
            "state in the carried state",
        ))
    findings.sort(key=lambda f: (f.lint_id, f.where, f.message))
    return findings


def op_census(record: StepRecord) -> dict:
    """Operation name -> count of the device operations one recorded step
    issued: every dispatched operation that is not a view and touches the
    step's device (collectives under their census kinds), and the hand
    kernel as ``merge_path``."""
    counts: Counter = Counter()
    for op in record.device_ops():
        kind = _COLLECTIVES.get(op.name)
        counts[kind[0] if kind is not None else op.name] += 1
    if record.merge_launches:
        counts["merge_path"] += record.merge_launches
    return dict(counts)


def kernel_count(record: StepRecord) -> int:
    """The device operations one step issues: the census's total."""
    return sum(op_census(record).values())


def intermediate_bytes(record: StepRecord) -> int:
    """Bytes of every device operation's outputs: the step's work proxy,
    as the reference's sums its equations' output sizes."""
    return sum(op.out_bytes for op in record.device_ops())


def lint_step_fn(fn, *args, max_const_bytes: int = DEFAULT_MAX_CONST_BYTES):
    """Record ``fn(*args)`` and lint it: (findings, record)."""
    _out, rec = record_call(fn, *args)
    return lint_record(rec, max_const_bytes), rec


def lint_dataflow(df, inputs: dict, max_const_bytes: int = DEFAULT_MAX_CONST_BYTES):
    """Step ``df`` one tick on ``inputs`` under the recorder and lint the
    record: (findings, record)."""
    _out, rec = record_step(df, inputs)
    return lint_record(rec, max_const_bytes), rec


def summary(record: StepRecord, findings: list | None = None) -> dict:
    """The numbers a report prints for one recorded step."""
    findings = lint_record(record) if findings is None else findings
    by = Counter()
    for f in findings:
        by[f.lint_id] += 1
    return {
        "kernel_count": kernel_count(record),
        "ops_dispatched": len(record.ops),
        "intermediate_bytes": intermediate_bytes(record),
        "merge_launches": record.merge_launches,
        "merge_by_shape": {",".join(map(str, k)): v
                           for k, v in sorted(record.merge_by_shape.items())},
        "collectives": dict(Counter(k for k, _b in record.collectives)),
        "h2d_bytes": record.h2d_bytes(),
        "host_callback_sites": {f.where: int(f.message.split(" ", 1)[0])
                                for f in findings if f.lint_id == HOST_CALLBACK},
        "dyn_shape_ops": sum(1 for o in record.ops if o.dyn_shape()),
        "findings": dict(sorted(by.items())),
    }
