"""Host-sync hazard linter over the per-span hot path (the port of
``materialize_tpu/analysis/host_sync.py``).

The pipelined control plane's contract is ONE device->host readback per
span: overflow flags accumulate on the device and are read once at the
span boundary while the next span executes. A sync point on the
dispatch path (an ``.item()``, a ``.cpu()``, an ``np.asarray`` of a
device tensor, a blocking upload from pageable memory) serializes the
pipeline, and a step with one cannot be captured in a CUDA graph. These
are host Python constructs, so this pass lints the *source* of the
registered hot-path functions (AST walk), and pairs it with
``step_lint``'s ``host-callback`` findings over one recorded step.

Sanctioned sync points carry the reference's pragmas on the offending
line:

    ``# host-sync: ok(<why>)`` — an intentional boundary readback (the
    flags read that IS the protocol's one readback);
    ``# h2d: <why>``          — an intentional staging upload.

The hazards, in torch:

- syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``np.asarray`` / ``np.array`` (of a potentially device value),
  ``.synchronize()`` (``torch.cuda.synchronize``, an event's), and
  ``int()`` / ``float()`` / ``bool()`` of a tensor expression (an
  implicit ``.item()``);
- uploads: ``torch.tensor(..., device=...)`` / ``torch.as_tensor``,
  ``.to(<device>)``, ``.cuda()``, and a host scalar stored into a tensor
  (``t[i] = True``), each a blocking copy from pageable memory.

The registry maps the reference's ``DEFAULT_HOT_PATH`` and
``RECORDER_PATH`` onto the port's names. Where the reference's function
has no counterpart:

- ``_dispatch_span`` / ``_dispatch_compact``: the port dispatches a span
  tick by tick (``Dataflow._dispatch``) and its folds in
  ``Dataflow._compact``;
- ``_pack_flags`` / ``_or_acc``: ``Dataflow._step_core`` stacks a step's
  flags, ``Dataflow._or`` accumulates them;
- ``_stack_packed``: none. The reference stacks a span's input batches
  into one array for its scan; the eager train feeds each tick's batches
  as they are;
- ``LedgeredJit.__call__`` and ``tier_vector``: none. Nothing is jitted,
  so no dispatch passes through the compile ledger; it records the
  kernel's and the native library's builds (``CompileLedger.record``).

The reference's step program is a jaxpr, which its callback scan reads.
The port's step is host Python, so the registry adds ``EAGER_PATH``: the
functions of the served tick (fetch, step, sink append, frontier
report) where the card's sync probe (``chip_smoke.py``'s
``_host_sync_probe``) counts a sync. Their findings are the port's
known sync debt, pinned by ``tests/test_torch_host_sync.py``.
"""

from __future__ import annotations

import ast
import inspect
import os
import textwrap
from dataclasses import dataclass

from .step_lint import HOST_CALLBACK, ROOT, LintFinding, lint_record, record_step

HOST_SYNC = "host-sync"

_SYNC_ATTR_CALLS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
_SYNC_FUNC_CALLS = frozenset({"asarray", "array"})  # np.asarray/np.array
_SCALAR_CASTS = frozenset({"int", "float", "bool"})
_TENSOR_CTORS = frozenset({"tensor", "as_tensor"})
_NUMPY_NAMES = frozenset({"np", "numpy", "_np"})

_DF = "materialize_tpu_torch.render.dataflow"
_SPAN = "materialize_tpu_torch.render.span_exec"
_OPS = "materialize_tpu_torch.storage.persist.operators"

# The per-span hot path: everything between two span boundaries. The
# boundary readback itself (read_flags_snapshot) is the protocol's
# sanctioned sync point and is pragma'd there.
DEFAULT_HOT_PATH = (
    (_DF, "Dataflow._dispatch"),
    (_DF, "Dataflow._compact"),
    (_DF, "Dataflow.run_span"),
    (_DF, "Dataflow._step_core"),
    (_DF, "Dataflow.flags_snapshot"),
    (_DF, "Dataflow.read_flags_snapshot"),
    (_DF, "Dataflow._or"),
    (_SPAN, "SpanExecutor.submit"),
    (_SPAN, "SpanExecutor._stage"),
    (_OPS, "MaintainedView._step_span_pipelined"),
    (_OPS, "MaintainedView._record_history"),
    (_OPS, "MaintainedView._publish"),
)

# The observability recorder path: trace-span recording, the compile
# ledger, the span-commit cadence records and the freshness plane all
# sit on the per-span hot path and must be pure host bookkeeping.
RECORDER_PATH = (
    ("materialize_tpu_torch.utils.trace", "Tracer.record"),
    ("materialize_tpu_torch.utils.trace", "Tracer._append"),
    ("materialize_tpu_torch.utils.trace", "Tracer.span"),
    ("materialize_tpu_torch.utils.compile_ledger", "CompileLedger.record"),
    (_OPS, "MaintainedView._commit_span"),
    (_SPAN, "SpanExecutor._complete"),
    ("materialize_tpu_torch.coord.freshness", "lag_ms"),
    ("materialize_tpu_torch.coord.freshness", "FreshnessRecorder.record"),
    ("materialize_tpu_torch.coord.freshness", "FreshnessRecorder._check_slo"),
    (_OPS, "MaintainedView._record_freshness"),
)

# The eager step's body on the served tick, where the card's probe
# counts syncs: the source fetch's upload, the step's own scalar
# uploads and flags readback, the sink's readback, the frontier report.
EAGER_PATH = (
    ("materialize_tpu_torch.repr.batch", "Batch.from_numpy"),
    ("materialize_tpu_torch.repr.batch", "Batch.to_columns"),
    (_OPS, "updates_to_batch"),
    (_OPS, "MaintainedView.step"),
    (_OPS, "MaintainedView._step_span_sync"),
    (_OPS, "MaintainedView._append"),
    (_DF, "Dataflow.run_steps"),
    (_DF, "Dataflow.check_flags"),
    (_DF, "Dataflow._read_flags"),
    (_DF, "Dataflow.output_records"),
    ("materialize_tpu_torch.ops.consolidate", "_segment_totals"),
    ("materialize_tpu_torch.ops.sort", "concat_batches"),
)

DEFAULT_HOT_PATH = DEFAULT_HOT_PATH + RECORDER_PATH + EAGER_PATH


@dataclass(frozen=True)
class HostSyncFinding(LintFinding):
    """A source finding: ``where`` is ``qualname:line``; ``site`` the
    same line as ``path:line`` (relative to the repository, as a
    step record's and the card's sync probe's call sites are), and
    ``construct`` the hazard."""

    site: str = ""
    construct: str = ""


def debt_key(f: HostSyncFinding) -> tuple:
    """(file, function, construct): a finding without its line, the
    shape the port's known sync debt is pinned in."""
    return (f.site.rsplit(":", 1)[0], f.where.rsplit(":", 1)[0], f.construct)


def _resolve(module_path: str, qualname: str):
    import importlib

    obj = importlib.import_module(module_path)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _line_pragma(line: str) -> str:
    return line.split("#", 1)[1].strip() if "#" in line else ""


def _is_numpy_value(node: ast.expr) -> bool:
    return (
        isinstance(node, ast.Name) and node.id in _NUMPY_NAMES
    ) or (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in _NUMPY_NAMES
    )


def _is_torch(node: ast.expr) -> bool:
    return isinstance(node, ast.Name) and node.id == "torch"


def _names_device(node: ast.expr) -> bool:
    """Whether ``.to``'s argument names a device (not a dtype)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Name):
        return "dev" in node.id
    if isinstance(node, ast.Attribute):
        return "dev" in node.attr
    return False


def _tensor_expr(node: ast.expr) -> bool:
    """An argument of ``int()``/``float()``/``bool()`` that may be a
    tensor: an attribute, a subscript, or a method call's result (not
    one this linter flags already, such as ``.item()``)."""
    return isinstance(node, (ast.Attribute, ast.Subscript)) or (
        isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and not _is_numpy_value(node.func.value)
        and node.func.attr not in _SYNC_ATTR_CALLS
    )


def _positional(node: ast.expr) -> bool:
    """A subscript that addresses tensor positions (``-1``, ``3``,
    ``a:b``), not a mapping's key."""
    if isinstance(node, ast.Tuple):
        return all(_positional(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Slice) or (
        isinstance(node, ast.Constant) and type(node.value) is int)


def _hazard(node: ast.AST):
    """(construct, why) of a hazard node, or None."""
    if isinstance(node, ast.Assign):
        if (isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, (bool, int, float))
                and any(isinstance(t, ast.Subscript) and _positional(t.slice)
                        for t in node.targets)):
            return ("`t[...] = <scalar>`",
                    "a host scalar stored into a device tensor is a blocking "
                    "upload from pageable memory")
        return None
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_ATTR_CALLS and not _is_numpy_value(f.value):
            return (f"`.{f.attr}()`",
                    "it blocks until the device work queued so far finishes "
                    "and transfers device data to the host")
        if f.attr in _SYNC_FUNC_CALLS and _is_numpy_value(f.value):
            return (f"`np.{f.attr}`",
                    "of a device tensor it is a device->host transfer that "
                    "serializes the pipeline")
        if f.attr in _TENSOR_CTORS and _is_torch(f.value) and any(
                k.arg == "device" for k in node.keywords):
            return (f"`torch.{f.attr}(device=)`",
                    "host data copied to the device from pageable memory "
                    "blocks the host")
        if f.attr == "to" and (
                any(k.arg == "device" for k in node.keywords)
                or (node.args and _names_device(node.args[0]))):
            return ("`.to(<device>)`",
                    "host data copied to the device from pageable memory "
                    "blocks the host")
        if f.attr == "cuda":
            return ("`.cuda()`",
                    "host data copied to the device from pageable memory "
                    "blocks the host")
    elif isinstance(f, ast.Name):
        if f.id in _SCALAR_CASTS and len(node.args) == 1 and _tensor_expr(node.args[0]):
            return (f"`{f.id}()`",
                    "of a device tensor it is an implicit `.item()`: a "
                    "device->host read")
    return None


def lint_function(fn, where: str | None = None) -> list:
    """AST-lint one hot-path function's source for host-sync hazards.
    Returns ``HostSyncFinding``s; lines carrying a ``host-sync: ok`` /
    ``h2d:`` pragma are sanctioned and skipped."""
    try:
        lines, first = inspect.getsourcelines(fn)
        path = inspect.getsourcefile(fn)
    except (OSError, TypeError):
        return []
    src_lines = [ln.rstrip("\n") for ln in lines]
    tree = ast.parse(textwrap.dedent("".join(lines)))
    name = where or getattr(fn, "__qualname__", str(fn))
    rel = os.path.relpath(os.path.abspath(path), ROOT)
    findings: list = []
    for node in ast.walk(tree):
        hit = _hazard(node)
        if hit is None:
            continue
        pragma = _line_pragma(src_lines[node.lineno - 1])
        if pragma.startswith("host-sync: ok") or pragma.startswith("h2d:"):
            continue
        construct, why = hit
        line = first + node.lineno - 1
        findings.append(HostSyncFinding(
            HOST_SYNC, f"{name}:{line}",
            f"{construct} on the per-span hot path: {why}. Move it to a span "
            "boundary (read_flags_snapshot is the one sanctioned readback per "
            "span) or mark an intentional boundary with `# host-sync: ok(<why>)`.",
            site=f"{rel}:{line}", construct=construct,
        ))
    findings.sort(key=lambda f: (int(f.where.rsplit(":", 1)[1]), f.construct))
    return findings


def lint_hot_path(extra=()) -> list:
    """Lint every registered hot-path function (plus ``extra``
    (module, qualname) pairs). The reference's gate is zero findings;
    the port's findings are its known sync debt."""
    findings: list = []
    for module_path, qualname in tuple(DEFAULT_HOT_PATH) + tuple(extra):
        findings.extend(lint_function(_resolve(module_path, qualname), where=qualname))
    findings.sort(key=lambda f: (f.where.rsplit(":", 1)[0],
                                 int(f.where.rsplit(":", 1)[1]), f.construct))
    return findings


def host_sync_findings_dataflow(df, inputs: dict) -> list:
    """Host-sync verdict for one dataflow's STEP: the record half of the
    rule (a device->host read inside the step is a per-step round trip,
    the same hazard expressed in the step instead of its host code). Steps
    ``df`` one tick on ``inputs`` under ``step_lint``'s recorder and
    returns only its ``host-callback`` findings; the source half is
    global (``lint_hot_path``)."""
    _out, rec = record_step(df, inputs)
    return [f for f in lint_record(rec) if f.lint_id == HOST_CALLBACK]
