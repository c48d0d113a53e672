"""From-scratch Avro binary codec.

Analog of the reference's from-scratch ``avro`` crate (src/avro, 13k
LoC Rust: reader/writer/schema resolution); this covers the subset the
streaming pipeline needs: schema JSON parsing, binary encode/decode of
null/boolean/int/long/float/double/string/bytes/record/enum/array/map/
union, and the logical types pgwire-visible columns map onto
(date, timestamp-millis, decimal-as-bytes).

Confluent Schema Registry wire framing (magic 0 + 4-byte schema id) is
in decode.py; this module is pure Avro.

The port's copy of ``materialize_tpu/storage/kafka/avro.py``: the
same bytes out for the same records.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass


class AvroError(ValueError):
    pass


@dataclass
class AvroSchema:
    """Parsed schema node. kind is the Avro type name; for records
    ``fields`` is [(name, AvroSchema)], for unions ``options`` is the
    branch list, for enums ``symbols``, for array/map ``items``."""

    kind: str
    name: str = ""
    fields: list = None
    options: list = None
    symbols: list = None
    items: "AvroSchema" = None
    logical: str = ""
    scale: int = 0

    @staticmethod
    def parse(src) -> "AvroSchema":
        if isinstance(src, (str, bytes)):
            src = json.loads(src)
        return _parse_schema(src)


_PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "string",
    "bytes",
}


def _parse_schema(node) -> AvroSchema:
    if isinstance(node, str):
        if node not in _PRIMITIVES:
            raise AvroError(f"unknown type {node!r}")
        return AvroSchema(node)
    if isinstance(node, list):
        return AvroSchema(
            "union", options=[_parse_schema(n) for n in node]
        )
    if not isinstance(node, dict):
        raise AvroError(f"bad schema node {node!r}")
    t = node["type"]
    logical = node.get("logicalType", "")
    if t == "record":
        return AvroSchema(
            "record",
            name=node.get("name", ""),
            fields=[
                (f["name"], _parse_schema(f["type"]))
                for f in node["fields"]
            ],
        )
    if t == "enum":
        return AvroSchema(
            "enum", name=node.get("name", ""), symbols=node["symbols"]
        )
    if t == "array":
        return AvroSchema("array", items=_parse_schema(node["items"]))
    if t == "map":
        return AvroSchema("map", items=_parse_schema(node["values"]))
    if t == "fixed":
        return AvroSchema("bytes", name=node.get("name", ""))
    if t in _PRIMITIVES:
        return AvroSchema(
            t, logical=logical, scale=int(node.get("scale", 0))
        )
    raise AvroError(f"unknown type {t!r}")


# -- binary primitives -------------------------------------------------------


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(out: bytearray, n: int) -> None:
    z = _zigzag_encode(n) & ((1 << 64) - 1)
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read_long(self) -> int:
        shift, acc = 0, 0
        while True:
            if self.pos >= len(self.buf):
                raise AvroError("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                raise AvroError("varint too long")
        return _zigzag_decode(acc)

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise AvroError("truncated data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


# -- decode ------------------------------------------------------------------


def decode(schema: AvroSchema, buf: bytes, pos: int = 0):
    r = _Reader(buf, pos)
    v = _decode(schema, r)
    return v


def _decode(s: AvroSchema, r: _Reader):
    k = s.kind
    if k == "null":
        return None
    if k == "boolean":
        return r.read(1) != b"\x00"
    if k in ("int", "long"):
        n = r.read_long()
        return n  # logical date = days, timestamp-millis = ms: both raw
    if k == "float":
        return struct.unpack("<f", r.read(4))[0]
    if k == "double":
        return struct.unpack("<d", r.read(8))[0]
    if k == "string":
        return r.read(r.read_long()).decode()
    if k == "bytes":
        raw = r.read(r.read_long())
        if s.logical == "decimal":
            unscaled = int.from_bytes(raw, "big", signed=True)
            import decimal

            return decimal.Decimal(unscaled) / (10 ** s.scale)
        return raw
    if k == "record":
        return {name: _decode(fs, r) for name, fs in s.fields}
    if k == "enum":
        i = r.read_long()
        if not 0 <= i < len(s.symbols):
            raise AvroError(f"enum index {i} out of range")
        return s.symbols[i]
    if k == "union":
        i = r.read_long()
        if not 0 <= i < len(s.options):
            raise AvroError(f"union branch {i} out of range")
        return _decode(s.options[i], r)
    if k == "array":
        out = []
        while True:
            n = r.read_long()
            if n == 0:
                return out
            if n < 0:  # block with byte size
                n = -n
                r.read_long()
            for _ in range(n):
                out.append(_decode(s.items, r))
    if k == "map":
        out = {}
        while True:
            n = r.read_long()
            if n == 0:
                return out
            if n < 0:
                n = -n
                r.read_long()
            for _ in range(n):
                key = r.read(r.read_long()).decode()
                out[key] = _decode(s.items, r)
    raise AvroError(f"cannot decode {k}")


# -- encode ------------------------------------------------------------------


def encode(schema: AvroSchema, value) -> bytes:
    out = bytearray()
    _encode(schema, value, out)
    return bytes(out)


def _encode(s: AvroSchema, v, out: bytearray) -> None:
    k = s.kind
    if k == "null":
        if v is not None:
            raise AvroError(f"non-null {v!r} for null schema")
        return
    if k == "boolean":
        out.append(1 if v else 0)
        return
    if k in ("int", "long"):
        _write_long(out, int(v))
        return
    if k == "float":
        out += struct.pack("<f", float(v))
        return
    if k == "double":
        out += struct.pack("<d", float(v))
        return
    if k == "string":
        b = str(v).encode()
        _write_long(out, len(b))
        out += b
        return
    if k == "bytes":
        if s.logical == "decimal":
            import decimal

            unscaled = int(
                (decimal.Decimal(str(v)) * (10 ** s.scale)).to_integral_value()
            )
            blen = max(1, (unscaled.bit_length() + 8) // 8)
            b = unscaled.to_bytes(blen, "big", signed=True)
        else:
            b = bytes(v)
        _write_long(out, len(b))
        out += b
        return
    if k == "record":
        for name, fs in s.fields:
            _encode(fs, v.get(name) if isinstance(v, dict) else None, out)
        return
    if k == "enum":
        _write_long(out, s.symbols.index(v))
        return
    if k == "union":
        for i, opt in enumerate(s.options):
            if _union_matches(opt, v):
                _write_long(out, i)
                _encode(opt, v, out)
                return
        raise AvroError(f"no union branch for {v!r}")
    if k == "array":
        if v:
            _write_long(out, len(v))
            for item in v:
                _encode(s.items, item, out)
        _write_long(out, 0)
        return
    if k == "map":
        if v:
            _write_long(out, len(v))
            for key, item in v.items():
                kb = str(key).encode()
                _write_long(out, len(kb))
                out += kb
                _encode(s.items, item, out)
        _write_long(out, 0)
        return
    raise AvroError(f"cannot encode {k}")


def _union_matches(s: AvroSchema, v) -> bool:
    if s.kind == "null":
        return v is None
    if v is None:
        return False
    if s.kind == "boolean":
        return isinstance(v, bool)
    if s.kind in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if s.kind in ("float", "double"):
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if s.kind == "string":
        return isinstance(v, str)
    if s.kind == "bytes":
        import decimal

        if s.logical == "decimal":
            return isinstance(v, (int, float, decimal.Decimal))
        return isinstance(v, (bytes, bytearray))
    if s.kind == "record":
        return isinstance(v, dict)
    if s.kind == "enum":
        return isinstance(v, str) and v in s.symbols
    if s.kind == "array":
        return isinstance(v, list)
    if s.kind == "map":
        return isinstance(v, dict)
    return False
