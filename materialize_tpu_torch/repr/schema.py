"""Relation schemas and column types (the port's copy of
``materialize_tpu/repr/schema.py``).

A relation is a struct-of-arrays: each column one fixed-width tensor.
Strings are dictionary-encoded on the host into order-preserving int64
codes. Dtypes stay numpy (the host side speaks numpy); ``torch_dtype``
maps them to the tensor dtypes the port stores.
"""

from __future__ import annotations

import bisect
import enum
import threading
from dataclasses import dataclass

import numpy as np
import torch


class ColumnType(enum.Enum):
    """Device-representable scalar types (same set as the reference)."""

    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT64 = "float64"
    DATE = "date"  # days since the UNIX epoch
    TIMESTAMP = "timestamp"  # milliseconds since the UNIX epoch
    DECIMAL = "decimal"  # scaled int64; the scale lives in the Column
    STRING = "string"  # order-preserving dictionary code (int64)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(_DTYPES[self])


_DTYPES = {
    ColumnType.BOOL: np.bool_,
    ColumnType.INT32: np.int32,
    ColumnType.INT64: np.int64,
    ColumnType.FLOAT64: np.float64,
    ColumnType.DATE: np.int32,
    ColumnType.TIMESTAMP: np.int64,
    ColumnType.DECIMAL: np.int64,
    ColumnType.STRING: np.int64,
}

# Virtual-time timestamps are u64 on the host. The port stores them as
# int64 tensors holding the same 64 bits (torch has no usable uint64).
TIME_DTYPE = np.uint64
DIFF_DTYPE = np.int64

_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.int64,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The tensor dtype the port stores a numpy dtype in (u64 -> int64
    bits)."""
    return _TORCH[np.dtype(np_dtype)]


@dataclass(frozen=True)
class Column:
    name: str
    ctype: ColumnType
    nullable: bool = False
    scale: int = 0  # decimal scale: value = unscaled / 10**scale

    @property
    def dtype(self) -> np.dtype:
        return self.ctype.dtype


@dataclass(frozen=True)
class Schema:
    """Column layout of a collection."""

    columns: tuple

    def __init__(self, columns):
        object.__setattr__(self, "columns", tuple(columns))

    @property
    def names(self) -> tuple:
        return tuple(c.name for c in self.columns)

    @property
    def arity(self) -> int:
        return len(self.columns)

    def __len__(self) -> int:
        return len(self.columns)

    def __getitem__(self, i: int) -> Column:
        return self.columns[i]

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)

    def project(self, indices) -> "Schema":
        return Schema([self.columns[i] for i in indices])

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.columns + other.columns)

    def rename(self, names) -> "Schema":
        assert len(names) == len(self.columns)
        return Schema(
            [Column(n, c.ctype, c.nullable, c.scale) for n, c in zip(names, self.columns)]
        )


class DictExhausted(RuntimeError):
    """A gap in the label space ran out between two dense neighbours.
    Recoverable: callers that own device-resident state catch this,
    call ``rebalance()``, remap host-side literals (``expr/remap.py``),
    and rebuild their dataflows (durable state is safe — persist parts
    store the actual strings)."""


class DictSnapshot:
    """An epoch-coherent read view of the dictionary
    (``StringDictionary.snapshot``): it decodes codes of ITS generation
    even after a later rebalance has relabelled the live dictionary."""

    __slots__ = ("_codes", "_by_code", "_sorted", "epoch")

    def __init__(self, codes, by_code, sorted_, epoch):
        self._codes = codes
        self._by_code = by_code
        self._sorted = sorted_
        self.epoch = epoch

    def decode(self, code: int) -> str:
        return self._by_code[int(code)]

    def decode_many(self, codes) -> list:
        return [self._by_code[int(c)] for c in np.asarray(codes)]

    def items_sorted(self) -> list:
        return [(self._codes[s], s) for s in list(self._sorted)]


class StringDictionary:
    """Host-side string dictionary: str <-> order-preserving int64 code,
    assigned by content-interpolated gap labelling in a 2^63-wide label
    space (integer order of codes == lexicographic order of strings).
    Codes depend on what was encoded before in the process, so two
    processes (or the port and the reference) only agree on codes for
    data they exchange as codes. A gap that runs dry raises
    ``DictExhausted``; ``rebalance`` then relabels every string evenly
    (order kept) and tells the registered listeners the {old: new}
    remap."""

    MIN_LABEL = -(1 << 62)
    MAX_LABEL = 1 << 62

    def __init__(self):
        self._sorted: list = []
        self._codes: dict = {}
        self._by_code: dict = {}
        self.version = 0  # bumped on every insert (the string tables' key)
        # Relabeling epoch: bumped by rebalance(). Every holder of codes
        # outside this object (string tables, device arrangements, MIR
        # literals) must treat a changed epoch as total invalidation.
        self.epoch = 0
        self._lock = threading.RLock()
        # Process-wide recovery hooks: called (with the old->new remap)
        # inside rebalance() so in-process holders of codes (controller
        # command history, replica dataflows) can remap and rebuild.
        self._listeners: list = []

    def snapshot(self) -> DictSnapshot:
        """An epoch-coherent read view. rebalance() REBINDS the internal
        maps (never mutates them in place), so a snapshot taken before a
        rebalance keeps decoding pre-rebalance codes while the live
        dictionary serves the new labelling; inserts of the same epoch
        are visible to it."""
        with self._lock:
            return DictSnapshot(self._codes, self._by_code, self._sorted, self.epoch)

    def lock(self):
        """The dictionary's reentrant lock, held by rebalance() for the
        whole relabel-and-listeners cycle."""
        return self._lock

    def add_rebalance_listener(self, fn) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_rebalance_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def rebalance(self) -> dict:
        """Reassign every code evenly across the label space (order
        preserved) after gap exhaustion. Returns the {old: new} remap.

        Device-resident arrangements and host caches keyed by code
        become garbage: registered listeners fire synchronously (under
        the lock) so the process's holders can remap host literals and
        schedule dataflow rebuilds. Another process's dictionary (a
        subprocess replica's) is not reached: it meets its own
        exhaustion on its own."""
        with self._lock:
            n = len(self._sorted)
            span = self.MAX_LABEL - self.MIN_LABEL
            remap: dict = {}
            new_codes: dict = {}
            new_by_code: dict = {}
            for i, s in enumerate(self._sorted):
                new = self.MIN_LABEL + (i + 1) * span // (n + 1)
                remap[self._codes[s]] = new
                new_codes[s] = new
                new_by_code[new] = s
            # REBIND (never mutate) so pre-rebalance snapshots stay
            # coherent: _sorted is rebound too because encode() inserts
            # into it in place.
            self._codes = new_codes
            self._by_code = new_by_code
            self._sorted = list(self._sorted)
            self.version += 1
            self.epoch += 1
            for fn in list(self._listeners):
                fn(remap)
            return remap

    @staticmethod
    def _frac(lo_s, hi_s, s: str) -> float:
        """Approximate fractional position of ``s`` in (lo_s, hi_s),
        read from the 6 bytes after the neighbours' common prefix."""
        lb = lo_s.encode() if lo_s is not None else b""
        hb = hi_s.encode() if hi_s is not None else None
        sb = s.encode()
        i = 0
        if hb is not None:
            while i < len(lb) and i < len(hb) and lb[i] == hb[i]:
                i += 1

        def val(b) -> int:
            v = 0
            for k in range(6):
                v = (v << 8) | (b[i + k] if i + k < len(b) else 0)
            return v

        lv = val(lb)
        hv = val(hb) if hb is not None else 1 << 48
        sv = val(sb)
        if hv <= lv:
            return 0.5
        f = (sv - lv) / (hv - lv)
        return min(max(f, 1e-4), 1.0 - 1e-4)

    def encode(self, s: str) -> int:
        with self._lock:
            code = self._codes.get(s)
            if code is not None:
                return code
            i = bisect.bisect_left(self._sorted, s)
            lo_s = self._sorted[i - 1] if i > 0 else None
            hi_s = self._sorted[i] if i < len(self._sorted) else None
            lo = self._codes[lo_s] if lo_s is not None else self.MIN_LABEL
            hi = self._codes[hi_s] if hi_s is not None else self.MAX_LABEL
            gap = hi - lo
            if gap < 2:
                raise DictExhausted(
                    f"label space exhausted between {lo_s!r} and {hi_s!r}"
                )
            code = lo + max(1, min(gap - 1, int(gap * self._frac(lo_s, hi_s, s))))
            self._sorted.insert(i, s)
            self._codes[s] = code
            self._by_code[code] = s
            self.version += 1
            return code

    def encode_bulk(self, strings) -> None:
        """Insert a set of new strings with positional gap division: each
        run of new strings between two existing neighbours divides that
        gap evenly (content interpolation, ``encode``, packs a family of
        long common prefixes into a sliver of the gap). The string
        tables' builds use it."""
        with self._lock:
            new = sorted({s for s in strings if s not in self._codes})
            if not new:
                return
            runs = []
            k = 0
            while k < len(new):
                i = bisect.bisect_left(self._sorted, new[k])
                hi_s = self._sorted[i] if i < len(self._sorted) else None
                lo = self._codes[self._sorted[i - 1]] if i > 0 else self.MIN_LABEL
                hi = self._codes[hi_s] if hi_s is not None else self.MAX_LABEL
                run = [new[k]]
                k += 1
                while k < len(new) and (hi_s is None or new[k] < hi_s):
                    run.append(new[k])
                    k += 1
                runs.append((lo, hi, run))
            # Every run is validated before anything is inserted.
            for lo, hi, run in runs:
                if hi - lo <= len(run):
                    raise DictExhausted(
                        f"bulk insert of {len(run)} strings does not fit in gap "
                        f"{hi - lo} at {run[0]!r}"
                    )
            for lo, hi, run in runs:
                for j, s in enumerate(run, 1):
                    code = lo + j * (hi - lo) // (len(run) + 1)
                    self._codes[s] = code
                    self._by_code[code] = s
            self._sorted = sorted(self._codes)
            self.version += 1

    def items_sorted(self) -> list:
        """(code, string) pairs in lexicographic (== code) order."""
        return [(self._codes[s], s) for s in self._sorted]

    def encode_many(self, strings) -> np.ndarray:
        return np.asarray([self.encode(s) for s in strings], dtype=np.int64)

    def decode(self, code: int) -> str:
        return self._by_code[int(code)]

    def decode_many(self, codes) -> list:
        return [self._by_code[int(c)] for c in np.asarray(codes)]

    def __len__(self) -> int:
        return len(self._sorted)


GLOBAL_DICT = StringDictionary()


def days_to_date(days: int):
    import datetime as _dt

    return _dt.date(1970, 1, 1) + _dt.timedelta(days=int(days))


def date_to_days(d) -> int:
    import datetime as _dt

    return (d - _dt.date(1970, 1, 1)).days


def ms_to_ts(ms: int):
    import datetime as _dt

    return _dt.datetime(1970, 1, 1) + _dt.timedelta(milliseconds=int(ms))


def ts_to_ms(ts) -> int:
    import datetime as _dt

    return int((ts - _dt.datetime(1970, 1, 1)).total_seconds() * 1000)


def decode_result_rows(schema: Schema, cols, nulls, time, diff) -> list:
    """Host update arrays -> rows (vals..., time, diff): STRING codes
    decoded through GLOBAL_DICT, DECIMAL to ``decimal.Decimal``, DATE and
    TIMESTAMP to ``datetime``, NULLs as None."""
    import decimal as _dec

    out = []
    # Edge-finalized basic-aggregate columns arrive as Python strings (an
    # object array, ``finalize_basic_columns``): they never enter the
    # dictionary.
    pre_decoded = [getattr(c, "dtype", None) == np.dtype(object) for c in cols]
    for i in range(len(diff)):
        vals = []
        for j, col in enumerate(schema.columns):
            if nulls[j] is not None and bool(nulls[j][i]):
                vals.append(None)
            elif pre_decoded[j]:
                vals.append(cols[j][i])
            elif col.ctype is ColumnType.STRING:
                vals.append(GLOBAL_DICT.decode(int(cols[j][i])))
            elif col.ctype is ColumnType.DECIMAL and col.scale:
                vals.append(
                    _dec.Decimal(int(cols[j][i])) / (10 ** col.scale)
                )
            elif col.ctype is ColumnType.DATE:
                vals.append(days_to_date(cols[j][i]))
            elif col.ctype is ColumnType.TIMESTAMP:
                vals.append(ms_to_ts(cols[j][i]))
            else:
                vals.append(cols[j][i].item())
        out.append(tuple(vals) + (int(time[i]), int(diff[i])))
    return out


def parse_text_value(raw: str, col: Column):
    """pg COPY text-format field -> python value for the column type."""
    import datetime as _dt
    import decimal as _dec

    t = col.ctype
    try:
        if t is ColumnType.BOOL:
            s = raw.strip().lower()
            if s in ("t", "true", "1", "yes", "on"):
                return True
            if s in ("f", "false", "0", "no", "off"):
                return False
            raise ValueError(raw)
        if t in (ColumnType.INT32, ColumnType.INT64):
            return int(raw)
        if t is ColumnType.FLOAT64:
            return float(raw)
        if t is ColumnType.DECIMAL:
            return _dec.Decimal(raw)
        if t is ColumnType.DATE:
            s = raw.strip()
            if s.lstrip("-").isdigit():
                return int(s)  # days-since-epoch shorthand
            return (_dt.date.fromisoformat(s) - _dt.date(1970, 1, 1)).days
        if t is ColumnType.TIMESTAMP:
            s = raw.strip()
            if s.lstrip("-").isdigit():
                return int(s)  # ms-since-epoch shorthand
            dt = _dt.datetime.fromisoformat(s.replace("T", " "))
            return int((dt - _dt.datetime(1970, 1, 1)).total_seconds() * 1000)
        return raw
    except (ValueError, _dec.InvalidOperation) as exc:
        # the SQL layer surfaces it as a statement failure
        raise ValueError(
            f"invalid {t.value} value {raw!r} for column {col.name!r}"
        ) from exc


# The error-stream schema (one column: the error code).
ERR_SCHEMA = Schema([Column("err_code", ColumnType.INT64)])
