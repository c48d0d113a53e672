"""Record decode/encode: bytes <-> row values for a declared Schema.

Analog of the reference's ``storage/src/decode`` (avro/csv/json/text
decoders selected by FORMAT) and ``src/interchange`` (Avro/JSON
encoding of rows for sinks, Debezium envelope semantics). A decoder
turns a broker Record's key/value bytes into python user-space values
matching the declared relation columns (the same value convention as
COPY FROM text: repr/schema.py parse_text_value).

Avro uses the Confluent wire format (magic 0x00 + big-endian 4-byte
schema id) against a ``FileSchemaRegistry`` (the ccsr analog): a json
file mapping id -> schema, usable by out-of-process producers.

The port's copy of ``materialize_tpu/storage/kafka/decode.py``.
"""

from __future__ import annotations

import csv as _csv
import io
import json
import struct

from ...repr.schema import Column, ColumnType, Schema, parse_text_value
from .avro import AvroSchema, decode as avro_decode, encode as avro_encode


class DecodeError(ValueError):
    pass


def _coerce(v, col: Column):
    """JSON/Avro value -> column value (user space)."""
    if v is None:
        return None
    if isinstance(v, str) and col.ctype not in (ColumnType.STRING,):
        return parse_text_value(v, col)
    if col.ctype is ColumnType.STRING and not isinstance(v, str):
        return json.dumps(v) if isinstance(v, (dict, list)) else str(v)
    if col.ctype is ColumnType.BOOL:
        return bool(v)
    if col.ctype in (ColumnType.INT32, ColumnType.INT64,
                     ColumnType.DATE, ColumnType.TIMESTAMP):
        return int(v)
    if col.ctype is ColumnType.FLOAT64:
        return float(v)
    if col.ctype is ColumnType.DECIMAL:
        import decimal

        # normalize to the column scale so upsert-state comparisons
        # (including state recovered from the shard) are exact
        q = decimal.Decimal(1).scaleb(-col.scale)
        return decimal.Decimal(str(v)).quantize(
            q, rounding=decimal.ROUND_HALF_UP
        )
    return v


_INTEGRAL = (ColumnType.INT32, ColumnType.INT64, ColumnType.DATE,
             ColumnType.TIMESTAMP)


def coercer(col: Column):
    """``_coerce`` for one column as a function of the value alone: the
    column's common case (an int for an integral column, a str for a
    STRING, decimal text for a DECIMAL) without the type dispatch, every
    other value through ``_coerce``. The same result for every value;
    the decoders' per-field cost is most of a source's host time."""
    import decimal

    t = col.ctype
    if t is ColumnType.STRING:
        def f(v):
            return v if v is None or type(v) is str else _coerce(v, col)
    elif t in _INTEGRAL:
        def f(v):
            return v if v is None or type(v) is int else _coerce(v, col)
    elif t is ColumnType.DECIMAL:
        def f(v):
            if type(v) is str:
                try:
                    return decimal.Decimal(v)  # parse_text_value's
                except decimal.InvalidOperation:
                    pass  # _coerce raises its error
            return _coerce(v, col)
    else:
        def f(v):
            return _coerce(v, col)
    return f


class Decoder:
    """value bytes -> row (list of user-space values, one per column)."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.fields = [(c.name, coercer(c)) for c in schema.columns]

    def decode(self, data: bytes) -> list:
        raise NotImplementedError


class JsonDecoder(Decoder):
    def decode(self, data: bytes) -> list:
        try:
            obj = json.loads(data)
        except json.JSONDecodeError as e:
            raise DecodeError(f"bad json record: {e}") from e
        if not isinstance(obj, dict):
            raise DecodeError("json record must be an object")
        return [f(obj.get(name)) for name, f in self.fields]


class CsvDecoder(Decoder):
    def decode(self, data: bytes) -> list:
        row = next(_csv.reader(io.StringIO(data.decode())))
        if len(row) != self.schema.arity:
            raise DecodeError(
                f"csv row has {len(row)} fields, expected "
                f"{self.schema.arity}"
            )
        return [
            None if f == "" and c.ctype is not ColumnType.STRING
            else parse_text_value(f, c)
            for f, c in zip(row, self.schema.columns)
        ]


class TextDecoder(Decoder):
    """FORMAT TEXT: the whole value as one text column."""

    def decode(self, data: bytes) -> list:
        if self.schema.arity != 1:
            raise DecodeError("FORMAT TEXT requires a single column")
        return [data.decode()]


class BytesDecoder(Decoder):
    """FORMAT BYTES: value bytes surfaced as latin-1 text (no BYTEA
    device type; the reference surfaces bytea)."""

    def decode(self, data: bytes) -> list:
        if self.schema.arity != 1:
            raise DecodeError("FORMAT BYTES requires a single column")
        return [data.decode("latin-1")]


class FileSchemaRegistry:
    """ccsr analog: id -> Avro schema json, stored in one json file so
    external producers and this process agree on ids."""

    def __init__(self, path: str):
        self.path = path
        self._cache: dict[int, AvroSchema] = {}

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def get(self, schema_id: int) -> AvroSchema:
        if schema_id not in self._cache:
            reg = self._load()
            if str(schema_id) not in reg:
                raise DecodeError(
                    f"schema id {schema_id} not in registry {self.path}"
                )
            self._cache[schema_id] = AvroSchema.parse(reg[str(schema_id)])
        return self._cache[schema_id]

    def register(self, schema_json: str) -> int:
        import os

        reg = self._load()
        for k, v in reg.items():
            if v == schema_json:
                return int(k)
        new_id = 1 + max((int(k) for k in reg), default=0)
        reg[str(new_id)] = schema_json
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(reg, f)
        os.replace(tmp, self.path)
        return new_id


class AvroDecoder(Decoder):
    """Confluent-framed Avro records decoded against the registry; the
    record's fields map to columns by name."""

    def __init__(self, schema: Schema, registry: FileSchemaRegistry):
        super().__init__(schema)
        self.registry = registry

    def decode(self, data: bytes) -> list:
        if len(data) < 5 or data[0] != 0:
            raise DecodeError("bad confluent avro framing")
        (schema_id,) = struct.unpack("!I", data[1:5])
        avsc = self.registry.get(schema_id)
        obj = avro_decode(avsc, data, 5)
        if not isinstance(obj, dict):
            raise DecodeError("avro record must be a record type")
        return [f(obj.get(name)) for name, f in self.fields]


def make_decoder(
    fmt: str, schema: Schema, registry_path: str | None = None
) -> Decoder:
    fmt = fmt.lower()
    if fmt == "json":
        return JsonDecoder(schema)
    if fmt == "csv":
        return CsvDecoder(schema)
    if fmt == "text":
        return TextDecoder(schema)
    if fmt == "bytes":
        return BytesDecoder(schema)
    if fmt == "avro":
        if registry_path is None:
            raise DecodeError("FORMAT AVRO requires a schema registry")
        return AvroDecoder(schema, FileSchemaRegistry(registry_path))
    raise DecodeError(f"unknown format {fmt!r}")


# -- encoding (sink side; interchange/src analog) ---------------------------


def _json_value(v):
    import decimal

    if isinstance(v, decimal.Decimal):
        return float(v)
    return v


class Encoder:
    def __init__(self, schema: Schema):
        self.schema = schema

    def encode(self, row: tuple) -> bytes:
        raise NotImplementedError


class JsonEncoder(Encoder):
    def encode(self, row) -> bytes:
        return json.dumps(
            {
                c.name: _json_value(v)
                for c, v in zip(self.schema.columns, row)
            },
            sort_keys=True,
        ).encode()


_AVRO_TYPES = {
    ColumnType.BOOL: "boolean",
    ColumnType.INT32: "int",
    ColumnType.INT64: "long",
    ColumnType.FLOAT64: "double",
    ColumnType.DATE: {"type": "int", "logicalType": "date"},
    ColumnType.TIMESTAMP: {
        "type": "long", "logicalType": "timestamp-millis"
    },
    ColumnType.STRING: "string",
}


def avro_schema_for(schema: Schema, name: str = "row") -> str:
    """Relation schema -> Avro record schema json (the schema the sink
    publishes to the registry; interchange/src/avro.rs analog)."""
    fields = []
    for c in schema.columns:
        if c.ctype is ColumnType.DECIMAL:
            t = {
                "type": "bytes",
                "logicalType": "decimal",
                "precision": 38,
                "scale": c.scale,
            }
        else:
            t = _AVRO_TYPES[c.ctype]
        fields.append(
            {
                "name": c.name,
                "type": ["null", t] if c.nullable else t,
            }
        )
    return json.dumps(
        {"type": "record", "name": name, "fields": fields}
    )


class AvroEncoder(Encoder):
    def __init__(self, schema: Schema, registry: FileSchemaRegistry,
                 name: str = "row"):
        super().__init__(schema)
        schema_json = avro_schema_for(schema, name)
        self.schema_id = registry.register(schema_json)
        self.avsc = AvroSchema.parse(schema_json)

    def encode(self, row) -> bytes:
        obj = {c.name: v for c, v in zip(self.schema.columns, row)}
        return (
            b"\x00"
            + struct.pack("!I", self.schema_id)
            + avro_encode(self.avsc, obj)
        )


def make_encoder(
    fmt: str, schema: Schema, registry_path: str | None = None,
    name: str = "row",
) -> Encoder:
    fmt = fmt.lower()
    if fmt == "json":
        return JsonEncoder(schema)
    if fmt == "avro":
        if registry_path is None:
            raise DecodeError("FORMAT AVRO requires a schema registry")
        return AvroEncoder(
            schema, FileSchemaRegistry(registry_path), name
        )
    raise DecodeError(f"unknown sink format {fmt!r}")
