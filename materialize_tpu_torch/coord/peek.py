"""Reads served straight from the maintained output spine (the port of
the device cores of ``materialize_tpu/coord/peek.py``).

- **scan**: concatenate every run's and slot's valid rows — the result
  is the maintained multiset, read without the compaction cascade.
- **lookup** (a column subset bound, e.g. ``WHERE l_orderkey = k``):
  per probe an equality mask over the concatenated runs, a cumsum, and
  a searchsorted over the running count picks the first ``span`` match
  positions; the reference's ``jax.vmap`` over probes is a batch
  dimension here, walked in chunks of probes to bound the ``[B, rows]``
  mask memory.
- **point** (every column bound): the probes' hash pair is
  binary-searched against each run's cached key lanes, the candidate
  range is gathered and raw-verified, and the net multiplicity comes
  back per probe.

``scan_rows``/``lookup_groups``/``point_net`` are the host glue a caller
uses on a port ``Dataflow``; ``serve_peek_groups`` is the replica's entry
point for the controller's batched fast-path peeks, and chooses between
the device cores and the host filter exactly as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..arrangement.spine import lookup_range
from ..ops.lanes import stack_lanes
from ..repr.batch import Batch
from ..repr.schema import DIFF_DTYPE, TIME_DTYPE, decode_result_rows, torch_dtype

class ServerBusy(RuntimeError):
    """Admission control shed a read: the peek queue is full or too
    many gather batches are in flight. Surfaced as SQLSTATE 53400 at
    pgwire — a clean, retryable overload signal instead of an unbounded
    backlog."""


class PeekTimedOut(ServerBusy):
    """A peek (or batched gather) wait exhausted its budget
    (``retry_policy_peek``). A ServerBusy subclass on purpose: the
    client should RETRY, so the front end sheds it exactly like an
    admission-control rejection (SQLSTATE 53400)."""


_MIN_SPAN = 8
_MIN_BATCH = 8
# Probes per lookup chunk: bounds the [chunk, rows] mask + cumsum.
LOOKUP_CHUNK = 8


def _pow2(n: int, minimum: int) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


# -- device cores --------------------------------------------------------------


def _concat_spine(spine):
    """Every run's and slot's columns concatenated, plus a validity mask
    (row < count and diff != 0)."""
    batches = list(spine.runs_b) + list(spine.slots)
    arity = len(batches[0].cols)
    dev = batches[0].device
    cols, nulls = [], []
    for j in range(arity):
        cols.append(torch.cat([b.cols[j] for b in batches]))
        if any(b.nulls[j] is not None for b in batches):
            nulls.append(
                torch.cat(
                    [
                        b.nulls[j] if b.nulls[j] is not None
                        else torch.zeros(b.capacity, dtype=torch.bool, device=dev)
                        for b in batches
                    ]
                )
            )
        else:
            nulls.append(None)
    time = torch.cat([b.time for b in batches])
    diff = torch.cat([b.diff for b in batches])
    valid = torch.cat(
        [
            (torch.arange(b.capacity, dtype=torch.int32, device=dev) < b.count)
            & (b.diff != 0)
            for b in batches
        ]
    )
    return cols, nulls, time, diff, valid


def _scan_core(spine):
    """The peek-scan program."""
    return _concat_spine(spine)


def _make_lookup_core(bound_cols: tuple, span: int, chunk: int = LOOKUP_CHUNK):
    """Masked-compaction gather for a partial column binding. ``core(
    spine, probes, ok)`` with ``probes`` one [B] tensor per bound column
    returns ([B, span] cols, nulls, time, diff, [B] match counts)."""

    def core(spine, probes, ok):
        cols, nulls, time, diff, valid = _concat_spine(spine)
        total = valid.shape[0]
        dev = valid.device
        targets = torch.arange(1, span + 1, dtype=torch.int32, device=dev)
        tgts, cnts = [], []
        for s in range(0, ok.shape[0], chunk):
            pk = [p[s:s + chunk] for p in probes]
            m = valid[None, :] & ok[s:s + chunk, None]
            for k, j in enumerate(bound_cols):
                mj = cols[j][None, :] == pk[k][:, None]
                if nulls[j] is not None:
                    mj = mj & ~nulls[j][None, :]
                m = m & mj
            csum = torch.cumsum(m, 1, dtype=torch.int32)
            cnts.append(csum[:, -1])
            tgt = torch.searchsorted(
                csum, targets[None, :].expand(csum.shape[0], span).contiguous()
            )
            tgts.append(torch.clamp(tgt, 0, total - 1))
        tgt = torch.cat(tgts)
        out_cols = tuple(c[tgt] for c in cols)
        out_nulls = tuple(None if nl is None else nl[tgt] for nl in nulls)
        return out_cols, out_nulls, time[tgt], diff[tgt], torch.cat(cnts)

    return core


def _make_point_core(schema, span: int):
    """Hash-lane point lookup for a full column binding. ``core(spine,
    probes, ok)`` returns ([B] net multiplicity, [B] widest candidate
    range)."""
    arity = schema.arity

    def core(spine, probes, ok):
        B = probes[0].shape[0]
        dev = probes[0].device
        pb = Batch(
            cols=tuple(probes),
            nulls=tuple(None for _ in range(arity)),
            time=torch.zeros(B, dtype=torch_dtype(TIME_DTYPE), device=dev),
            diff=torch.ones(B, dtype=torch_dtype(DIFF_DTYPE), device=dev),
            count=torch.tensor(B, dtype=torch.int32, device=dev),
            schema=schema,
        )
        runs = spine.runs()
        q2d = stack_lanes(runs[0].probe_lanes(pb, list(range(arity))))
        net = torch.zeros(B, dtype=torch.int64, device=dev)
        need = torch.zeros(B, dtype=torch.int32, device=dev)
        offs = torch.arange(span, dtype=torch.int32, device=dev)[None, :]
        for arr in runs:
            lo, hi = lookup_range(arr, q2d)
            cap = arr.batch.capacity
            pos = lo[:, None] + offs
            eq = pos < hi[:, None]
            posc = torch.clamp(pos, 0, cap - 1).to(torch.int64)
            for j in range(arity):
                mj = arr.batch.cols[j][posc] == probes[j][:, None]
                if arr.batch.nulls[j] is not None:
                    mj = mj & ~arr.batch.nulls[j][posc]
                eq = eq & mj
            d = arr.batch.diff[posc]
            net = net + torch.where(eq, d, torch.zeros_like(d)).sum(1)
            need = torch.maximum(need, hi - lo)
        net = torch.where(ok, net, torch.zeros_like(net))
        need = torch.where(ok, need, torch.zeros_like(need))
        return net, need

    return core


# -- host glue -----------------------------------------------------------------


def _probe_arrays(schema, bound_cols, probes, batch: int, device):
    """Stack probe tuples into per-column tensors padded to the pow2
    batch lane, plus the validity mask."""
    n = len(probes)
    ok = np.zeros(batch, dtype=bool)
    ok[:n] = True
    by_col = list(zip(*probes)) if probes else [() for _ in bound_cols]
    arrays = []
    for k, j in enumerate(bound_cols):
        dt = schema.columns[j].dtype
        a = np.zeros(batch, dtype=dt)
        if n:
            a[:n] = np.asarray(by_col[k], dtype=dt)
        arrays.append(torch.from_numpy(a).to(device))
    return tuple(arrays), torch.from_numpy(ok).to(device)


def _decode(schema, cols, nulls, time, diff) -> list:
    return decode_result_rows(schema, cols, nulls, time, diff)


def scan_arrays(df) -> tuple:
    """Host (cols, nulls, time, diff) of every valid row of every run
    and slot — not consolidated across runs."""
    df.check_flags()
    cols, nulls, time, diff, valid = _scan_core(df.output)
    mask = valid.cpu().numpy()
    return (
        [c.cpu().numpy()[mask] for c in cols],
        [None if nl is None else nl.cpu().numpy()[mask] for nl in nulls],
        time.cpu().numpy().view(np.uint64)[mask],
        diff.cpu().numpy()[mask],
    )


def scan_rows(df) -> list:
    """Decoded rows of a full scan (SELECT * FROM the index)."""
    return _decode(df.out_schema, *scan_arrays(df))


def lookup_arrays(df, bound_cols: tuple, probes: list) -> list:
    """Per probe, host (cols, nulls, time, diff) of the matching rows of
    every run, retrying at a wider span when a probe matches more."""
    df.check_flags()
    schema = df.out_schema
    B = _pow2(max(len(probes), 1), _MIN_BATCH)
    arrays, ok = _probe_arrays(schema, bound_cols, probes, B, df.device)
    span = _MIN_SPAN
    while True:
        cols, nulls, time, diff, cnt = _make_lookup_core(bound_cols, span)(
            df.output, arrays, ok
        )
        cnt = cnt.cpu().numpy()
        mx = int(cnt.max()) if len(probes) else 0
        if mx <= span:
            break
        span = _pow2(mx, _MIN_SPAN)
    h_cols = [c.cpu().numpy() for c in cols]
    h_nulls = [None if nl is None else nl.cpu().numpy() for nl in nulls]
    h_time = time.cpu().numpy().view(np.uint64)
    h_diff = diff.cpu().numpy()
    out = []
    for i in range(len(probes)):
        k = int(cnt[i])
        out.append(
            (
                [c[i, :k] for c in h_cols],
                [None if nl is None else nl[i, :k] for nl in h_nulls],
                h_time[i, :k],
                h_diff[i, :k],
            )
        )
    return out


def lookup_groups(df, bound_cols: tuple, probes: list) -> list:
    """Decoded matching rows per probe."""
    return [_decode(df.out_schema, *g) for g in lookup_arrays(df, bound_cols, probes)]


def point_net(df, probes: list) -> np.ndarray:
    """Net multiplicity of each full-row probe tuple in the index."""
    df.check_flags()
    schema = df.out_schema
    arity = schema.arity
    B = _pow2(max(len(probes), 1), _MIN_BATCH)
    arrays, ok = _probe_arrays(schema, tuple(range(arity)), probes, B, df.device)
    span = _MIN_SPAN
    while True:
        net, need = _make_point_core(schema, span)(df.output, arrays, ok)
        need = need.cpu().numpy()
        mx = int(need.max()) if len(probes) else 0
        if mx <= span:
            break
        span = _pow2(mx, _MIN_SPAN)
    return net.cpu().numpy()[: len(probes)]


# -- the replica's batched fast path ----------------------------------------


def _point_groups(df, bound_cols: tuple, probes: list, served_t: int) -> list:
    """Every column bound: one row group per probe, holding the probe
    tuple itself at its net multiplicity (empty when absent)."""
    schema = df.out_schema
    arity = schema.arity
    # Reorder each probe tuple into schema column order.
    order = {j: k for k, j in enumerate(bound_cols)}
    full = [tuple(p[order[j]] for j in range(arity)) for p in probes]
    net = point_net(df, full)
    hits = [i for i in range(len(full)) if int(net[i]) != 0]
    rows = []
    if hits:
        cols = [
            np.asarray([full[i][j] for i in hits], dtype=c.dtype)
            for j, c in enumerate(schema.columns)
        ]
        rows = _decode(
            schema, cols, [None] * arity,
            np.full(len(hits), served_t, np.uint64),
            net[hits].astype(np.int64),
        )
    groups = [[] for _ in full]
    for pos, i in enumerate(hits):
        groups[i] = [rows[pos]]
    return groups


def _host_filter_groups(view, bound_cols: tuple, probes: list,
                        scan: bool) -> list:
    """Fallback for dataflows without the single-device gather path
    (basic-aggregate finalizers): read the result batch once and filter
    host-side. Still no transient dataflow, still one read amortized
    over the whole batch."""
    from ..storage.persist.operators import _host_updates

    df = view.df
    schema = df.out_schema
    cols, nulls, time, diff = _host_updates(view.result_batch())

    def decode(cols, nulls, time, diff):
        # Basic-aggregate digests become their groups' strings: only the
        # rows this read returns are finalized.
        if getattr(df, "_basic_finalizers", None):
            cols = df.finalize_basic_columns(cols, nulls)
        return decode_result_rows(schema, cols, nulls, time, diff)

    if scan:
        return [decode(cols, nulls, time, diff)]
    groups = []
    for p in probes:
        mask = np.ones(len(diff), dtype=bool)
        for k, j in enumerate(bound_cols):
            v = np.asarray(p[k]).astype(schema.columns[j].dtype)
            mask &= np.asarray(cols[j]) == v
            if nulls[j] is not None:
                mask &= ~np.asarray(nulls[j])
        groups.append(
            decode(
                [np.asarray(c)[mask] for c in cols],
                [None if nl is None else np.asarray(nl)[mask] for nl in nulls],
                time[mask],
                diff[mask],
            )
        )
    return groups


def serve_peek_groups(view, spec: dict) -> list:
    """Serve one batched fast-path peek against an installed dataflow's
    maintained arrangement. ``spec``: {"scan": bool, "bound_cols":
    tuple, "probes": [probe tuple, ...]} with probe values in INTERNAL
    representation (the same values MIR literals carry). Returns
    rows-groups: one decoded row list per probe (a single shared group
    for scans). Never renders, never compacts the spine."""
    df = view.df
    probes = [tuple(p) for p in (spec.get("probes") or [])]
    bound_cols = tuple(spec.get("bound_cols") or ())
    scan = bool(spec.get("scan"))
    from ..render.dataflow import Dataflow as _SingleDevice

    if type(df) is not _SingleDevice or getattr(df, "_basic_finalizers", None):
        return _host_filter_groups(view, bound_cols, probes, scan)
    if scan:
        return [scan_rows(df)]
    if len(bound_cols) == df.out_schema.arity:
        return _point_groups(df, bound_cols, probes, view.upper - 1)
    return lookup_groups(df, bound_cols, probes)
