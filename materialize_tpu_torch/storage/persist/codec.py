"""Batch-part codec: host columnar updates <-> self-contained bytes.

Analog of the reference's columnar (Arrow/Parquet) batch parts in Blob
(``persist-client/src/batch.rs``). Parts are self-contained: string
columns are stored as a local dense dictionary (codes remapped through
the process-global dictionary on decode), so a shard can be read by a
fresh process. Layout:

    magic "MTPB" | u32 version | u32 header_len | header JSON
    | column/null/time/diff buffers | u32 crc32 (of all preceding bytes)

Column statistics (min/max per column) ride in the header for filter
pushdown, mirroring persist's part stats (``persist-client/src/stats.rs``
consumed by the abstract interpreter, ``expr/src/interpret.rs``).
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from ...repr.schema import (
    DIFF_DTYPE,
    GLOBAL_DICT,
    TIME_DTYPE,
    Column,
    ColumnType,
    Schema,
)

MAGIC = b"MTPB"
VERSION = 1


class PartCorruptError(RuntimeError):
    pass


def _enc_buffer(a: np.ndarray) -> tuple[bytes, str]:
    """Encode one buffer; integer columns get native zigzag-varint delta
    compression when it wins (sorted time columns shrink ~8x)."""
    from ... import native

    raw = np.ascontiguousarray(a).tobytes()
    if a.dtype in (np.int64, np.uint64, np.int32):
        v = native.vbyte_encode_i64(
            a.astype(np.int64) if a.dtype != np.int64 else a
        )
        if len(v) < len(raw):
            return v, "vbyte"
    return raw, "raw"


def _dec_buffer(data: bytes, enc: str, dtype: np.dtype, n: int) -> np.ndarray:
    from ... import native

    if enc == "vbyte":
        return native.vbyte_decode_i64(data, n).astype(dtype)
    if enc == "raw":
        return np.frombuffer(data, dtype=dtype, count=n).copy()
    raise PartCorruptError(f"unknown buffer encoding {enc!r}")


def _col_stats(a: np.ndarray, nulls: np.ndarray | None):
    """Min/max over non-null rows, JSON-safe; None when empty/all-null."""
    if nulls is not None:
        a = a[~nulls]
    if a.size == 0 or a.dtype == np.bool_:
        return None
    lo, hi = a.min(), a.max()
    if np.issubdtype(a.dtype, np.floating):
        return [float(lo), float(hi)]
    return [int(lo), int(hi)]


def encode_part(
    schema: Schema,
    cols: list[np.ndarray],
    nulls: list[np.ndarray | None],
    time: np.ndarray,
    diff: np.ndarray,
) -> bytes:
    """Encode one part. Inputs are tight host arrays (no padding)."""
    n = len(diff)
    buffers: list[bytes] = []
    col_meta = []
    # One dictionary snapshot for the whole part: codes in `cols` were
    # assigned under the current (or an earlier same-epoch) labeling; a
    # rebalance concurrent with this encode must not relabel mid-part.
    # The NULL-placeholder "" is ensured BEFORE the snapshot so the
    # snapshot always covers it.
    empty_code = GLOBAL_DICT.encode("")
    gdict = GLOBAL_DICT.snapshot()
    for i, (c, a) in enumerate(zip(schema.columns, cols)):
        a = np.asarray(a)
        assert len(a) == n, f"column {c.name}: {len(a)} rows != {n}"
        nl = nulls[i] if nulls else None
        local_strings = None
        if c.ctype is ColumnType.STRING:
            # Remap process-global codes to a local dense dictionary so
            # the part is self-contained. NULL rows carry placeholder
            # codes that are not dictionary labels — normalize them to
            # a real label first (their value is masked by the null
            # column on decode).
            codes = np.asarray(a, dtype=np.int64).copy()
            if nl is not None:
                codes[np.asarray(nl, bool)] = empty_code
            uniq, inv = np.unique(codes, return_inverse=True)
            local_strings = [gdict.decode(u) for u in uniq]
            a = inv.astype(np.int64)
        buf, enc = _enc_buffer(a)
        buffers.append(buf)
        has_nulls = nl is not None
        if has_nulls:
            buffers.append(
                np.ascontiguousarray(np.asarray(nl, np.bool_)).tobytes()
            )
        col_meta.append(
            {
                "name": c.name,
                "ctype": c.ctype.value,
                "nullable": c.nullable,
                "scale": c.scale,
                "has_nulls": has_nulls,
                "enc": enc,
                "strings": local_strings,
                # Dictionary codes are not order-preserving: no stats for
                # string columns (schema.py is_orderable_on_device).
                "stats": None
                if c.ctype is ColumnType.STRING
                else _col_stats(
                    a, np.asarray(nl, bool) if has_nulls else None
                ),
            }
        )
    tbuf, tenc = _enc_buffer(np.asarray(time, TIME_DTYPE))
    dbuf, denc = _enc_buffer(np.asarray(diff, DIFF_DTYPE))
    buffers.append(tbuf)
    buffers.append(dbuf)
    header = json.dumps(
        {
            "n": int(n),
            "columns": col_meta,
            "buf_lens": [len(b) for b in buffers],
            "time_enc": tenc,
            "diff_enc": denc,
        }
    ).encode()
    body = b"".join(
        [MAGIC, struct.pack("<II", VERSION, len(header)), header, *buffers]
    )
    return body + struct.pack("<I", zlib.crc32(body))


def decode_part(data: bytes):
    """Decode a part -> (schema, cols, nulls, time, diff) host arrays.
    String columns come back as process-global dictionary codes."""
    if len(data) < 12 or data[:4] != MAGIC:
        raise PartCorruptError("bad magic")
    (crc,) = struct.unpack("<I", data[-4:])
    if zlib.crc32(data[:-4]) != crc:
        raise PartCorruptError("crc mismatch")
    version, header_len = struct.unpack("<II", data[4:12])
    if version != VERSION:
        raise PartCorruptError(f"unknown version {version}")
    header = json.loads(data[12 : 12 + header_len])
    n = header["n"]
    off = 12 + header_len
    bufs = []
    for blen in header["buf_lens"]:
        bufs.append(data[off : off + blen])
        off += blen
    cols, nulls, columns = [], [], []
    bi = 0
    for m in header["columns"]:
        ctype = ColumnType(m["ctype"])
        columns.append(Column(m["name"], ctype, m["nullable"], m["scale"]))
        a = _dec_buffer(bufs[bi], m.get("enc", "raw"), ctype.dtype, n)
        bi += 1
        if m["strings"] is not None:
            remap = GLOBAL_DICT.encode_many(m["strings"])
            a = (
                remap[a]
                if len(remap)
                else np.zeros(n, np.int64)
            )
        cols.append(a)
        if m["has_nulls"]:
            nulls.append(np.frombuffer(bufs[bi], dtype=np.bool_, count=n).copy())
            bi += 1
        else:
            nulls.append(None)
    time = _dec_buffer(
        bufs[bi], header.get("time_enc", "raw"), np.dtype(TIME_DTYPE), n
    )
    diff = _dec_buffer(
        bufs[bi + 1], header.get("diff_enc", "raw"), np.dtype(DIFF_DTYPE), n
    )
    return Schema(columns), cols, nulls, time, diff


def concat_update_parts(parts: list, arity: int):
    """Concatenate decoded update parts [(cols, nulls, time, diff), ...]
    into one (cols, nulls, time, diff). Null masks are backfilled with
    all-False where absent; a column whose combined mask has no set bit
    collapses back to None. Shared by ReadHandle.snapshot/fetch and
    compaction so the three read paths cannot diverge."""
    if not parts:
        return (
            [],
            [],
            np.zeros(0, TIME_DTYPE),
            np.zeros(0, DIFF_DTYPE),
        )
    cols = [
        np.concatenate([p[0][i] for p in parts]) for i in range(arity)
    ]
    nulls: list[np.ndarray | None] = []
    for i in range(arity):
        if all(p[1][i] is None for p in parts):
            nulls.append(None)
            continue
        combined = np.concatenate(
            [
                p[1][i]
                if p[1][i] is not None
                else np.zeros(len(p[3]), np.bool_)
                for p in parts
            ]
        )
        nulls.append(combined if combined.any() else None)
    time = np.concatenate([p[2] for p in parts])
    diff = np.concatenate([p[3] for p in parts])
    return cols, nulls, time, diff


def part_stats(data: bytes) -> dict:
    """Header-only read: per-column min/max stats for filter pushdown
    without fetching/decoding column buffers."""
    if data[:4] != MAGIC:
        raise PartCorruptError("bad magic")
    _version, header_len = struct.unpack("<II", data[4:12])
    header = json.loads(data[12 : 12 + header_len])
    return {
        m["name"]: m["stats"] for m in header["columns"]
    }
