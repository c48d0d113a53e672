"""Port parity for the broker-backed streaming layer
(``materialize_tpu_torch/storage/kafka/``): both packages fed the same
seeded inputs, every comparison exact.

- Avro: ``encode`` byte-equal to the reference's over seeded records of
  every type (unions, nullables, arrays, maps, enums, nested records,
  the logical types); ``decode`` round-trips; varint edges, truncated
  and out-of-range inputs raise as the reference's.
- The broker: a topic either package's ``FileBroker`` wrote, a torn
  segment tail and a transaction journal left unapplied included, reads
  back equal through the other's; ``append_txn`` is all or nothing.
- The decoders and ``_coerce`` equal the reference's over seeded JSON,
  CSV, text, bytes and Avro payloads with NULLs, DECIMAL halves at the
  rounding edge included.
- The sources: ``tests/test_kafka.py``'s cases (JSON into an MV, UPSERT
  with a tombstone and a restart, DEBEZIUM, Avro with a registry)
  through both packages' coordinators on the same broker content; the
  SELECT results, the ``_progress`` rows and every subsource shard's
  updates equal.
- The sinks: both packages sink the same table updates (ENVELOPE NONE
  and DEBEZIUM); the topics' records are byte-equal, and after a
  restart neither republishes.
- The port's coordinator boots from the data and broker directories
  the reference's wrote (a Kafka source, an MV and a sink), takes new
  records and answers as a reference run that never stopped; the sink
  publishes nothing twice.
"""

from __future__ import annotations

import decimal
import json
import os
import struct

import numpy as np
import pytest

from tests.torch_dict import reference_dict_restored  # noqa: F401
from tests.torch_serving import Cluster, deadline, mod, one_torch_thread  # noqa: F401

PKGS = ("ref", "port")


def avro(pkg):
    return mod(pkg, "storage.kafka.avro")


def broker_mod(pkg):
    return mod(pkg, "storage.kafka.broker")


def decode_mod(pkg):
    return mod(pkg, "storage.kafka.decode")


# -- Avro -----------------------------------------------------------------------

EVERY_TYPE = {
    "type": "record",
    "name": "row",
    "fields": [
        {"name": "b", "type": "boolean"},
        {"name": "i", "type": "int"},
        {"name": "l", "type": "long"},
        {"name": "f", "type": "float"},
        {"name": "d", "type": "double"},
        {"name": "s", "type": "string"},
        {"name": "raw", "type": "bytes"},
        {"name": "fx", "type": {"type": "fixed", "name": "fx4", "size": 4}},
        {"name": "dec", "type": {"type": "bytes", "logicalType": "decimal",
                                 "precision": 12, "scale": 3}},
        {"name": "day", "type": {"type": "int", "logicalType": "date"}},
        {"name": "ts", "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "color", "type": {"type": "enum", "name": "c",
                                   "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "ns", "type": ["null", "string"]},
        {"name": "nl", "type": ["null", "long"]},
        {"name": "u", "type": ["null", "boolean", "long", "double", "string"]},
        {"name": "arr", "type": {"type": "array", "items": "long"}},
        {"name": "m", "type": {"type": "map", "values": ["null", "double"]}},
        {"name": "sub", "type": {"type": "record", "name": "sub", "fields": [
            {"name": "x", "type": "long"},
            {"name": "tags", "type": {"type": "array", "items": "string"}},
        ]}},
        {"name": "nsub", "type": ["null", {"type": "record", "name": "nsub",
                                           "fields": [{"name": "y", "type": "string"}]}]},
    ],
}


def _word(rng) -> str:
    n = int(rng.integers(0, 9))
    return "".join(rng.choice(list("abcxyzé中 _-"), n))


def seeded_avro_records(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        u_kind = int(rng.integers(0, 5))
        u = [None, bool(rng.integers(0, 2)), int(rng.integers(-2**40, 2**40)),
             float(rng.normal() * 1e3), _word(rng)][u_kind]
        out.append({
            "b": bool(rng.integers(0, 2)),
            "i": int(rng.integers(-2**31, 2**31)),
            "l": int(rng.integers(-2**63, 2**63 - 1, dtype=np.int64)),
            "f": float(np.float32(rng.normal() * 100)),
            "d": float(rng.normal() * 1e9),
            "s": _word(rng),
            "raw": bytes(rng.integers(0, 256, int(rng.integers(0, 6))).astype(np.uint8)),
            "fx": bytes(rng.integers(0, 256, 4).astype(np.uint8)),
            "dec": decimal.Decimal(int(rng.integers(-10**9, 10**9))) / 1000,
            "day": int(rng.integers(-1000, 20000)),
            "ts": int(rng.integers(0, 2**41)),
            "color": ["RED", "GREEN", "BLUE"][int(rng.integers(0, 3))],
            "ns": None if rng.random() < 0.4 else _word(rng),
            "nl": None if rng.random() < 0.4 else int(rng.integers(-99, 99)),
            "u": u,
            "arr": [int(x) for x in rng.integers(-2**62, 2**62, int(rng.integers(0, 4)))],
            "m": {_word(rng) + str(k): (None if rng.random() < 0.3 else float(rng.normal()))
                  for k in range(int(rng.integers(0, 3)))},
            "sub": {"x": int(rng.integers(-5, 5)), "tags": [_word(rng) for _ in range(int(rng.integers(0, 3)))]},
            "nsub": None if rng.random() < 0.5 else {"y": _word(rng)},
        })
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_avro_encode_bytes_equal_and_decode_round_trips(seed):
    records = seeded_avro_records(seed, 64)
    ref_s, port_s = avro("ref").AvroSchema.parse(json.dumps(EVERY_TYPE)), \
        avro("port").AvroSchema.parse(json.dumps(EVERY_TYPE))
    for rec in records:
        want = avro("ref").encode(ref_s, rec)
        got = avro("port").encode(port_s, rec)
        assert got == want
        back = avro("port").decode(port_s, got)
        assert back == avro("ref").decode(ref_s, want)
        assert back == rec


@pytest.mark.parametrize("schema,values", [
    ('"long"', [0, 1, -1, 63, -64, 64, -65, 2**31, -(2**31), 2**62, -(2**62),
                2**63 - 1, -(2**63)]),
    ('"int"', [0, 2**31 - 1, -(2**31)]),
    ('"string"', ["", "x" * 200, "é"]),
    ('{"type": "bytes", "logicalType": "decimal", "scale": 2}',
     [decimal.Decimal("0.00"), decimal.Decimal("-0.01"), decimal.Decimal("1.27"),
      decimal.Decimal("1.28"), decimal.Decimal("-1.28"), decimal.Decimal("-1.29"),
      decimal.Decimal("123456789012.34")]),
])
def test_avro_varint_and_decimal_edges(schema, values):
    ref_s, port_s = avro("ref").AvroSchema.parse(schema), avro("port").AvroSchema.parse(schema)
    for v in values:
        b = avro("port").encode(port_s, v)
        assert b == avro("ref").encode(ref_s, v)
        assert avro("port").decode(port_s, b) == v


def _outcome(fn, *args):
    """The call's result as its repr (so that NaN equals NaN), or its
    error's type and text."""
    try:
        return ("ok", repr(fn(*args)))
    except Exception as e:  # noqa: BLE001 - the error IS the outcome
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("schema,data", [
    (EVERY_TYPE, b"\x02"),
    ('"long"', b""),
    ('"long"', b"\xff" * 10 + b"\x01"),  # more than 63 bits
    ('"long"', b"\x80\x80"),  # truncated varint
    ('"string"', b"\x10abc"),  # truncated data
    ('"double"', b"\x00\x00"),
    ('{"type": "enum", "name": "e", "symbols": ["A"]}', b"\x02"),  # index 1
    ('["null", "long"]', b"\x04"),  # branch 2
    ('{"type": "array", "items": "long"}', b"\x03\x04\x02"),  # block with size
    ('{"type": "map", "values": "long"}', b"\x02\x02k\x04\x00"),
])
def test_avro_bad_inputs_raise_as_the_reference(schema, data):
    if isinstance(schema, dict):
        schema = json.dumps(schema)
    ref = _outcome(avro("ref").decode, avro("ref").AvroSchema.parse(schema), data)
    port = _outcome(avro("port").decode, avro("port").AvroSchema.parse(schema), data)
    assert port == ref


@pytest.mark.parametrize("schema,value", [
    ('"null"', 1),
    ('["null", "long"]', "x"),
    ('{"type": "enum", "name": "e", "symbols": ["A"]}', "B"),
    ('{"type": "bogus"}', None),
    ('"bogus"', None),
    ('7', None),
])
def test_avro_bad_schemas_and_values_raise_as_the_reference(schema, value):
    def run(pkg):
        a = avro(pkg)
        return a.encode(a.AvroSchema.parse(schema), value)

    assert _outcome(run, "port") == _outcome(run, "ref")


# -- the broker -----------------------------------------------------------------


def _write_topics(pkg: str, root: str, seed: int) -> None:
    """Seeded appends and transactions, then the residue of two crashes:
    a transaction whose index updates were lost after its journal commit,
    and a torn segment tail past the last committed record."""
    bm = broker_mod(pkg)
    rng = np.random.default_rng(seed)
    b = bm.FileBroker(root)
    b.create_topic("data", 3)
    b.create_topic("progress", 1)

    def rec():
        key = None if rng.random() < 0.3 else bytes(rng.integers(0, 256, 3).astype(np.uint8))
        val = None if rng.random() < 0.2 else json.dumps({"v": int(rng.integers(0, 99))}).encode()
        return bm.Record(key, val, timestamp=int(rng.integers(0, 2**40)))

    for i in range(12):
        p = int(rng.integers(0, 3))
        b.append("data", p, [rec() for _ in range(int(rng.integers(1, 5)))])
        if i % 3 == 2:
            b.append_txn([
                ("data", int(rng.integers(0, 3)), [rec() for _ in range(2)]),
                ("progress", 0, [bm.Record(None, json.dumps({"frontier": i}).encode())]),
            ])
    # A transaction committed in the journal whose index lines never
    # landed: the next open replays it.
    b.append_txn([("data", 1, [rec(), rec()]),
                  ("progress", 0, [bm.Record(None, b'{"frontier": 99}')])])
    for topic, p in (("data", 1), ("progress", 0)):
        idx = os.path.join(root, topic, f"p{p}.idx")
        with open(idx) as f:
            lines = f.readlines()
        with open(idx, "w") as f:
            f.writelines(lines[:-1])
    # A torn segment tail and a torn journal line: never surfaced.
    with open(os.path.join(root, "data", "p2.log"), "ab") as f:
        f.write(b"\xde\xad\xbe\xef")
    with open(os.path.join(root, "txn.journal"), "a") as f:
        f.write('{"entries": [["data", 0, 999')


def _read_topics(pkg: str, root: str) -> dict:
    b = broker_mod(pkg).FileBroker(root)
    out = {"topics": b.topics()}
    for topic, n in b.topics().items():
        for p in range(n):
            end = b.end_offset(topic, p)
            recs = b.fetch(topic, p, 0, 10_000)
            mid = b.fetch(topic, p, end // 2, 3)
            out[(topic, p)] = (end, [(r.key, r.value, r.offset, r.timestamp) for r in recs],
                               [r.offset for r in mid])
    return out


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_broker_files_read_back_equal_both_ways(tmp_path, writer, reader):
    root = str(tmp_path / "broker")
    _write_topics(writer, root, seed=5)
    want = _read_topics(writer, str(root))
    assert want[("data", 1)][0] > 0 and want[("progress", 0)][0] == 5
    assert _read_topics(reader, root) == want
    # The same appends through the other package leave the same files.
    other = str(tmp_path / "other")
    _write_topics(reader, other, seed=5)
    assert _read_topics(reader, other) == want  # reopened: the journal replayed
    assert _tree(other) == _tree(root)


def test_append_txn_is_all_or_nothing(tmp_path):
    for pkg in PKGS:
        bm = broker_mod(pkg)
        root = str(tmp_path / pkg)
        b = bm.FileBroker(root)
        b.create_topic("data")
        b.create_topic("progress")
        b.append_txn([("data", 0, [bm.Record(None, b"r1"), bm.Record(None, b"r2")]),
                      ("progress", 0, [bm.Record(None, b'{"frontier": 5}')])])
        # A crash after the segment writes, before the journal commit:
        # the staged bytes are invisible.
        with open(os.path.join(root, "data", "p0.log"), "ab") as f:
            f.write(bm._enc_record(bm.Record(None, b"r3")))
        for p_idx in ("data", "progress"):
            os.truncate(os.path.join(root, p_idx, "p0.idx"), 0)
        b2 = bm.FileBroker(root)  # replays the committed transaction only
        assert (b2.end_offset("data", 0), b2.end_offset("progress", 0)) == (2, 1)
        assert [r.value for r in b2.fetch("data", 0, 0, 10)] == [b"r1", b"r2"]
        # The next append overwrites the uncommitted bytes.
        b2.append("data", 0, [bm.Record(None, b"r4")])
        assert [r.value for r in bm.FileBroker(root).fetch("data", 0, 0, 10)] == [
            b"r1", b"r2", b"r4"]
    assert _tree(str(tmp_path / "ref")) == _tree(str(tmp_path / "port"))


def test_mem_broker_like_the_reference():
    outs = []
    for pkg in PKGS:
        bm = broker_mod(pkg)
        b = bm.MemBroker()
        b.create_topic("t", 2)
        b.append("t", 1, [bm.Record(b"k", b"v", timestamp=3), bm.Record(None, None)])
        b.append_txn([("t", 0, [bm.Record(None, b"x")]), ("t", 1, [bm.Record(b"y", None)])])
        outs.append((b.topics(), [b.end_offset("t", p) for p in (0, 1)],
                     [b.fetch("t", p, 0, 9) for p in (0, 1)], b.fetch("t", 1, 1, 1)))
    ref, port = outs
    assert repr(port) == repr(ref).replace("materialize_tpu.", "materialize_tpu_torch.")


# -- the decoders -----------------------------------------------------------------

COLUMNS = [
    ("b", "BOOL", 0, True), ("i32", "INT32", 0, True), ("i64", "INT64", 0, True),
    ("f", "FLOAT64", 0, True), ("d", "DATE", 0, True), ("ts", "TIMESTAMP", 0, True),
    ("dec", "DECIMAL", 2, True), ("dec4", "DECIMAL", 4, True), ("s", "STRING", 0, True),
]


def schema(pkg: str, cols=COLUMNS):
    sch = mod(pkg, "repr.schema")
    return sch.Schema([
        sch.Column(n, getattr(sch.ColumnType, t), scale=sc, nullable=nl)
        for n, t, sc, nl in cols])


# Values for each column: NULLs, strings parsed as COPY text, numbers,
# DECIMAL halves at the rounding edge (ROUND_HALF_UP at the scale).
VALUES = {
    "b": [None, True, False, 0, 1, "t", "false", "yes", "maybe"],
    "i32": [None, 0, -7, 2**31 - 1, "42", " 5", "x", 3.9],
    "i64": [None, 2**62, -(2**63), "-9", 7.0],
    "f": [None, 0.1, -2, "1e300", "nan", "-inf", "abc"],
    "d": [None, 0, 19000, "2024-02-29", "-5", "2024-13-01"],
    "ts": [None, 1_600_000_000_000, "2024-01-02 03:04:05.678", "2024-01-02T03:04:05", "99"],
    "dec": [None, 2.675, "2.675", "-2.675", 0.005, "0.005", "-0.005", 1.005, "1.005",
            0.125, "0.125", 2.665, 1e-9, 12, "12.345", "-0", "1e3", "x", True],
    "dec4": [None, "0.00005", "-0.00005", 2.675, "1.23455", 0.1],
    "s": [None, "", "hello", 7, 2.5, True, [1, "a"], {"k": None}, "2.675"],
}


def _coerce_all(pkg: str):
    d = decode_mod(pkg)
    out = {}
    for col in schema(pkg).columns:
        for v in VALUES[col.name]:
            out[(col.name, repr(v))] = _outcome(d._coerce, v, col)
    return out


def test_coerce_equals_the_reference():
    ref, port = _coerce_all("ref"), _coerce_all("port")
    assert port == ref
    # ROUND_HALF_UP at the column's scale, float or text alike.
    assert port[("dec", "2.675")] == ("ok", repr(decimal.Decimal("2.68")))
    # Text is parsed as COPY text is, not quantized (as the reference's).
    assert port[("dec", "'-2.675'")] == ("ok", repr(decimal.Decimal("-2.675")))
    assert port[("dec4", "2.675")] == ("ok", repr(decimal.Decimal("2.6750")))
    assert port[("dec", "0.005")] == ("ok", repr(decimal.Decimal("0.01")))


def _json_payloads(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        obj = {}
        for name, values in VALUES.items():
            if rng.random() < 0.15:
                continue  # an absent field is a NULL
            v = values[int(rng.integers(0, len(values)))]
            obj[name] = v
        out.append(json.dumps(obj).encode())
    out += [b"{", b"[1, 2]", b"null", b'{"i32": "zz"}']
    return out


def _csv_payloads(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    texts = {k: [v for v in vs if isinstance(v, str)] + [""] for k, vs in VALUES.items()}
    for _ in range(n):
        fields = []
        for name in VALUES:
            t = texts[name][int(rng.integers(0, len(texts[name])))]
            fields.append('"' + t.replace('"', '""') + '"' if "," in t or " " in t else t)
        out.append(",".join(fields).encode())
    out += [b"1,2", b""]
    return out


def _decode_all(pkg: str, fmt: str, payloads: list, sch, registry=None) -> list:
    d = decode_mod(pkg).make_decoder(fmt, sch, registry)
    return [_outcome(d.decode, p) for p in payloads]


@pytest.mark.parametrize("seed", [0, 1])
def test_json_and_csv_decoders_equal_the_reference(seed):
    js, cs = _json_payloads(seed, 200), _csv_payloads(seed, 200)
    for fmt, payloads in (("json", js), ("csv", cs)):
        ref = _decode_all("ref", fmt, payloads, schema("ref"))
        port = _decode_all("port", fmt, payloads, schema("port"))
        assert port == ref
        assert sum(o[0] == "ok" for o in ref) > len(payloads) // 4


def test_text_and_bytes_decoders_equal_the_reference():
    one = [("v", "STRING", 0, True)]
    payloads = [b"", b"plain", "é中".encode(), b"\xff\xfe", b"a,b\n"]
    for fmt in ("text", "bytes"):
        for cols in (one, COLUMNS):
            ref = _decode_all("ref", fmt, payloads, schema("ref", cols))
            port = _decode_all("port", fmt, payloads, schema("port", cols))
            assert port == ref


def test_unknown_formats_raise_as_the_reference():
    for fmt, reg in (("protobuf", None), ("avro", None)):
        ref = _outcome(decode_mod("ref").make_decoder, fmt, schema("ref"), reg)
        port = _outcome(decode_mod("port").make_decoder, fmt, schema("port"), reg)
        assert port == ref and port[0] == "error"
        ref = _outcome(decode_mod("ref").make_encoder, fmt, schema("ref"), reg)
        port = _outcome(decode_mod("port").make_encoder, fmt, schema("port"), reg)
        assert port == ref and port[0] == "error"


def test_avro_decoder_and_registry_equal_the_reference(tmp_path):
    reg_path = str(tmp_path / "registry.json")
    avsc = json.dumps({"type": "record", "name": "m", "fields": [
        {"name": "i64", "type": "long"},
        {"name": "s", "type": ["null", "string"]},
        {"name": "dec", "type": ["null", {"type": "bytes", "logicalType": "decimal",
                                          "precision": 9, "scale": 3}]},
        {"name": "f", "type": ["null", "double"]},
        {"name": "b", "type": "boolean"},
        {"name": "d", "type": {"type": "int", "logicalType": "date"}},
    ]})
    # Ids agree whichever package registers: the file is the registry.
    sid = decode_mod("ref").FileSchemaRegistry(reg_path).register(avsc)
    assert decode_mod("port").FileSchemaRegistry(reg_path).register(avsc) == sid
    other = json.dumps({"type": "record", "name": "o", "fields": []})
    assert decode_mod("port").FileSchemaRegistry(reg_path).register(other) == sid + 1
    assert decode_mod("ref").FileSchemaRegistry(reg_path).register(other) == sid + 1
    rng = np.random.default_rng(3)
    s = avro("ref").AvroSchema.parse(avsc)
    payloads = []
    for _ in range(100):
        obj = {
            "i64": int(rng.integers(-2**40, 2**40)),
            "s": None if rng.random() < 0.3 else _word(rng),
            # 3-digit decimals reach the scale-2 column: halves round up.
            "dec": None if rng.random() < 0.3 else decimal.Decimal(int(rng.integers(-9999, 9999))) / 1000,
            "f": None if rng.random() < 0.3 else float(rng.normal()),
            "b": bool(rng.integers(0, 2)),
            "d": int(rng.integers(0, 20000)),
        }
        payloads.append(b"\x00" + struct.pack("!I", sid) + avro("ref").encode(s, obj))
    payloads += [b"\x01\x00\x00\x00\x01", b"\x00\x00", b"\x00\x00\x00\x00\x63" + b"\x00",
                 b"\x00" + struct.pack("!I", sid + 1) + b""]
    ref = _decode_all("ref", "avro", payloads, schema("ref"), reg_path)
    port = _decode_all("port", "avro", payloads, schema("port"), reg_path)
    assert port == ref
    assert sum(o[0] == "ok" for o in ref) == 101


def test_encoders_equal_the_reference(tmp_path):
    reg_path = str(tmp_path / "registry.json")
    rng = np.random.default_rng(9)
    cols = [c for c in COLUMNS if c[0] != "dec4"]
    rows = []
    for _ in range(50):
        rows.append((
            None if rng.random() < 0.2 else bool(rng.integers(0, 2)),
            int(rng.integers(-2**31, 2**31)), int(rng.integers(-2**62, 2**62)),
            float(rng.normal()), int(rng.integers(0, 20000)), int(rng.integers(0, 2**41)),
            None if rng.random() < 0.2 else decimal.Decimal(int(rng.integers(-10**6, 10**6))) / 100,
            None if rng.random() < 0.2 else _word(rng),
        ))
    for fmt in ("json", "avro"):
        encs = {pkg: decode_mod(pkg).make_encoder(fmt, schema(pkg, cols), reg_path, "row")
                for pkg in PKGS}
        for r in rows:
            assert encs["port"].encode(r) == encs["ref"].encode(r)
    assert decode_mod("port").avro_schema_for(schema("port", cols), "x") == \
        decode_mod("ref").avro_schema_for(schema("ref", cols), "x")


# -- the sources through both coordinators ----------------------------------------


def _put(pkg, root, topic, records, partitions=1, partition=0):
    bm = broker_mod(pkg)
    b = bm.FileBroker(os.path.join(root, "broker"))
    b.create_topic(topic, partitions)
    b.append(topic, partition, [bm.Record(k, v) for k, v in records])


def _shard_rows(coord, source: str) -> dict:
    """Every subsource shard's updates, decoded: what the source emitted."""
    src = coord.sources[source]
    out = {}
    for sub, shard in sorted(src.shards.items()):
        w = src.writers[sub]
        reader = coord.persist.open_reader(shard, "test-read")
        try:
            _sch, cols, nulls, time_, diff = reader.snapshot(w.upper - 1)
        finally:
            reader.expire()
        sch = src.adapter.subsources[sub]
        rows = mod("ref" if type(coord).__module__.startswith("materialize_tpu.") else "port",
                   "repr.schema").decode_result_rows(sch, cols, nulls, time_, diff)
        out[sub] = sorted(rows, key=repr)
    return out


def _js(obj) -> bytes:
    return json.dumps(obj).encode()


def case_json_to_mv(pkg, root, c, restart):
    b = os.path.join(root, "broker")
    _put(pkg, root, "events", [(None, _js(r)) for r in (
        {"user": "a", "amount": 10}, {"user": "b", "amount": 5}, {"user": "a", "amount": 7},
        {"user": None, "amount": 1}, {"user": "c", "amount": "3"}, {"user": "d"})],
        partitions=2)
    _put(pkg, root, "events", [(None, _js({"user": "e", "amount": 2}))], partitions=2, partition=1)
    out = [c.execute(
        "CREATE SOURCE ev (user text, amount bigint) FROM KAFKA (BROKER "
        f"'{b}', TOPIC 'events', FORMAT 'json')").kind]
    c.execute("CREATE MATERIALIZED VIEW totals AS SELECT user, sum(amount) AS total, "
              "count(*) AS n FROM ev GROUP BY user")
    out.append(sorted(c.execute("SELECT * FROM totals").rows, key=repr))
    _put(pkg, root, "events", [(None, _js({"user": "b", "amount": 1}))], partitions=2)
    c.sources["ev"].tick_once()
    out.append(sorted(c.execute("SELECT * FROM totals").rows, key=repr))
    out.append(sorted(c.execute("SELECT * FROM ev_progress").rows))
    return out, "ev"


def case_upsert_and_resume(pkg, root, c, restart):
    b = os.path.join(root, "broker")

    def put(k, v):
        _put(pkg, root, "kv", [(_js(k), None if v is None else _js({"k": k, "v": v}))])

    put("x", 1)
    put("y", 2)
    put("x", 3)  # overwrite
    put("x", 3)  # an equal value: no update
    put("w", None)  # a tombstone for an absent key
    out = [c.execute(
        "CREATE SOURCE kvs (k text NOT NULL, v bigint) FROM KAFKA "
        f"(BROKER '{b}', TOPIC 'kv', FORMAT 'json', ENVELOPE 'upsert')").kind]
    out.append(sorted(c.execute("SELECT * FROM kvs").rows))
    put("y", None)  # tombstone delete
    c.sources["kvs"].tick_once()
    out.append(sorted(c.execute("SELECT * FROM kvs").rows))
    out.append(sorted(c.execute("SELECT * FROM kvs_progress").rows))
    # Restart: offsets from the progress shard, UPSERT state from the
    # emitted collection.
    c = restart()
    put("z", 9)
    put("x", 4)
    c.sources["kvs"].tick_once()
    out.append(sorted(c.execute("SELECT * FROM kvs").rows))
    out.append(sorted(c.execute("SELECT * FROM kvs_progress").rows))
    return out, "kvs"


def case_debezium(pkg, root, c, restart):
    b = os.path.join(root, "broker")

    def change(before, after):
        _put(pkg, root, "dbz", [(None, _js({"payload": {"before": before, "after": after}}))])

    change(None, {"id": 1, "v": 10, "p": "2.675"})
    change(None, {"id": 2, "v": 20, "p": 0.005})
    change({"id": 1, "v": 10, "p": "2.675"}, {"id": 1, "v": 11, "p": 1.005})  # update
    change({"id": 2, "v": 20, "p": 0.005}, None)  # delete
    _put(pkg, root, "dbz", [(None, _js({"before": None, "after": {"id": 3, "v": 30, "p": None}}))])
    out = [c.execute(
        "CREATE SOURCE dz (id bigint NOT NULL, v bigint NOT NULL, p numeric(10,2)) "
        f"FROM KAFKA (BROKER '{b}', TOPIC 'dbz', FORMAT 'json', ENVELOPE 'debezium')").kind]
    out.append(sorted(c.execute("SELECT * FROM dz").rows, key=repr))
    change({"id": 3, "v": 30, "p": None}, {"id": 3, "v": 31, "p": "-2.675"})
    c.sources["dz"].tick_once()
    out.append(sorted(c.execute("SELECT * FROM dz").rows, key=repr))
    out.append(c.execute("SELECT sum(p), count(*) FROM dz").rows)
    return out, "dz"


def case_avro(pkg, root, c, restart):
    dm = decode_mod(pkg)
    b = os.path.join(root, "broker")
    reg_path = os.path.join(root, "registry.json")
    avsc = json.dumps({"type": "record", "name": "m", "fields": [
        {"name": "id", "type": "long"}, {"name": "who", "type": ["null", "string"]}]})
    sid = dm.FileSchemaRegistry(reg_path).register(avsc)
    s = avro(pkg).AvroSchema.parse(avsc)
    frame = b"\x00" + struct.pack("!I", sid)
    _put(pkg, root, "av", [(None, frame + avro(pkg).encode(s, o))
                           for o in ({"id": 1, "who": "ada"}, {"id": 2, "who": None})])
    out = [c.execute(
        "CREATE SOURCE av (id bigint NOT NULL, who text) FROM KAFKA "
        f"(BROKER '{b}', TOPIC 'av', FORMAT 'avro', REGISTRY '{reg_path}')").kind]
    out.append(sorted(c.execute("SELECT * FROM av").rows, key=repr))
    _put(pkg, root, "av", [(None, frame + avro(pkg).encode(s, {"id": 3, "who": "bob"}))])
    c.sources["av"].tick_once()
    out.append(sorted(c.execute("SELECT * FROM av").rows, key=repr))
    out.append(sorted(c.execute("SELECT * FROM av_progress").rows))
    return out, "av"


def run_source_case(pkg: str, root: str, case) -> tuple:
    clusters = [Cluster(pkg, root)]
    coord = [clusters[0].coordinator()]

    def restart():
        clusters[-1].shutdown()
        clusters.append(Cluster(pkg, root))
        coord.append(clusters[-1].coordinator())
        return coord[-1]

    try:
        out, source = case(pkg, root, coord[0], restart)
        return out, _shard_rows(coord[-1], source)
    finally:
        clusters[-1].shutdown()


SOURCE_CASES = [case_json_to_mv, case_upsert_and_resume, case_debezium, case_avro]


@pytest.mark.parametrize("case", SOURCE_CASES, ids=lambda f: f.__name__[5:])
def test_source_results_progress_and_batches_equal_the_reference(tmp_path, case):
    ref = run_source_case("ref", str(tmp_path / "ref"), case)
    port = run_source_case("port", str(tmp_path / "port"), case)
    assert port == ref
    assert ref[0][1]  # the first SELECT saw rows


def test_source_adapter_batches_equal_the_reference(tmp_path):
    """Both adapters over one broker, tick by tick: the emitted batches'
    columns, null masks, times and diffs (strings decoded), the progress
    rows, and ``MAX_RECORDS_PER_TICK`` binding the same offsets."""
    root = str(tmp_path / "broker")
    bm = broker_mod("ref")
    b = bm.FileBroker(root)
    b.create_topic("li", 2)
    rng = np.random.default_rng(4)
    for p in (0, 1):
        b.append("li", p, [bm.Record(None, _js({
            "k": int(rng.integers(0, 50)), "s": None if rng.random() < 0.2 else _word(rng),
            "dec": None if rng.random() < 0.2 else VALUES["dec"][int(rng.integers(1, 15))],
            "d": int(rng.integers(0, 20000)), "b": bool(rng.integers(0, 2)),
            "f": float(rng.normal())})) for _ in range(150)])
    cols = [("k", "INT64", 0, False), ("s", "STRING", 0, True), ("dec", "DECIMAL", 2, True),
            ("d", "DATE", 0, False), ("b", "BOOL", 0, False), ("f", "FLOAT64", 0, False)]
    got = {}
    for pkg in PKGS:
        src = mod(pkg, "storage.kafka.source")
        src.MAX_RECORDS_PER_TICK, saved = 100, src.MAX_RECORDS_PER_TICK
        sch = mod(pkg, "repr.schema")
        try:
            ad = src.KafkaSourceAdapter(
                {"broker": root, "topic": "li", "_name": "li"}, schema(pkg, cols))
            ticks = [ad.snapshot()] + [ad.tick(t, t) for t in range(1, 5)]
        finally:
            src.MAX_RECORDS_PER_TICK = saved
        out = []
        for batches in ticks:
            per = {}
            for name, bt in sorted(batches.items()):
                n = int(np.asarray(bt.count))
                cs = [np.asarray(c)[:n] for c in bt.cols]
                ns = [None if m is None else np.asarray(m)[:n] for m in bt.nulls]
                per[name] = sch.decode_result_rows(
                    bt.schema, cs, ns, np.asarray(bt.time)[:n], np.asarray(bt.diff)[:n])
            out.append(per)
        got[pkg] = (out, ad.offsets)
    assert got["port"] == got["ref"]
    assert got["ref"][1] == [150, 150]
    assert [sorted(t) for t in got["ref"][0]] == [["li", "li_progress"]] * 3 + [[]] * 2


# -- the sinks through both coordinators --------------------------------------------


def _sinks_until(c, base_sink: str, *names) -> None:
    """Run each sink up to the table's upper (the frontier of the sink on
    the table itself), so that a sink on a view waits for the view."""
    upper = c.sinks[base_sink].reader.machine.reload().upper
    for name in names:
        c.sinks[name].run_until(upper, timeout=30)


def run_sink(pkg: str, root: str) -> tuple:
    b = os.path.join(root, "broker")
    cl = Cluster(pkg, root)
    topics = ("out_none", "out_dbz")
    try:
        c = cl.coordinator()
        c.execute("CREATE TABLE st (k text NOT NULL, v bigint NOT NULL, p numeric(8,2))")
        c.execute("INSERT INTO st VALUES ('a', 1, 1.25), ('b', 2, NULL), ('a', 1, 1.25)")
        c.execute("CREATE MATERIALIZED VIEW sv AS SELECT k, sum(v) AS s, count(*) AS n FROM st GROUP BY k")
        c.execute(f"CREATE SINK snk FROM st INTO KAFKA (BROKER '{b}', TOPIC 'out_none', FORMAT 'json')")
        c.execute(f"CREATE SINK dbz FROM sv INTO KAFKA (BROKER '{b}', TOPIC 'out_dbz', "
                  "FORMAT 'json', ENVELOPE 'debezium')")
        _sinks_until(c, "snk", "snk", "dbz")
        c.execute("DELETE FROM st WHERE k = 'a'")
        c.execute("UPDATE st SET v = v + 10, p = 0.5 WHERE k = 'b'")
        c.execute("INSERT INTO st VALUES ('c', 3, -2.5)")
        _sinks_until(c, "snk", "snk", "dbz")
        broker = broker_mod(pkg).FileBroker(b)
        ends = {t: broker.end_offset(t, 0) for t in topics}
        records = {}
        for t in topics:
            recs = [(r.timestamp, r.value, r.key) for r in broker.fetch(t, 0, 0, 1000)]
            # Published in time order; within a time the order follows how
            # the shard's parts were read, so the records compare sorted.
            assert [r[0] for r in recs] == sorted(r[0] for r in recs)
            records[t] = sorted(recs)
        # Each sink's last progress record: its resume frontier.
        frontiers = sorted(
            json.loads(broker.fetch(t, 0, broker.end_offset(t, 0) - 1, 1)[0].value)["frontier"]
            for t in broker.topics() if t.startswith("__progress_"))
    finally:
        cl.shutdown()
    # Restart: the progress topics stop every republication.
    cl = Cluster(pkg, root)
    try:
        c = cl.coordinator()
        _sinks_until(c, "snk", "snk", "dbz")
        c.execute("INSERT INTO st VALUES ('d', 4, 4.00)")
        _sinks_until(c, "snk", "snk", "dbz")
        broker = broker_mod(pkg).FileBroker(b)
        after = {t: sorted(r.value for r in broker.fetch(t, 0, ends[t], 1000)) for t in topics}
    finally:
        cl.shutdown()
    return records, frontiers, after


def test_sink_records_byte_equal_and_never_republished(tmp_path):
    ref = run_sink("ref", str(tmp_path / "ref"))
    port = run_sink("port", str(tmp_path / "port"))
    assert port == ref
    records, frontiers, after = port
    assert frontiers == [5, 5]
    # Three inserts, two retractions, an update's pair, one insert.
    assert len(records["out_none"]) == 8 and records["out_dbz"]
    # After the restart only the new row's updates appear.
    assert [json.loads(v)["row"]["k"] for v in after["out_none"]] == ["d"]
    assert [json.loads(v)["payload"]["after"]["k"] for v in after["out_dbz"]] == ["d"]


# -- the port booting from the reference's directories --------------------------------

BOOT_SOURCE = (
    "CREATE SOURCE dz (id bigint NOT NULL, v bigint NOT NULL, w text) FROM KAFKA "
    "(BROKER '{b}', TOPIC 'dbz', FORMAT 'json', ENVELOPE 'debezium')")
BOOT_MV = "CREATE MATERIALIZED VIEW agg AS SELECT w, sum(v) AS s, count(*) AS n FROM dz GROUP BY w"
BOOT_SINK = ("CREATE SINK out FROM agg INTO KAFKA (BROKER '{b}', TOPIC 'agg.out', "
             "FORMAT 'json', ENVELOPE 'debezium')")


def _boot_stream() -> list:
    """Three steps of Debezium changes over ids 0-7: inserts, updates
    (the current row before, a new one after) and deletes, each ``before``
    a row the stream inserted earlier."""
    rng = np.random.default_rng(100)
    current: dict = {}
    steps = []
    for _ in range(3):
        out = []
        for _ in range(6):
            k = int(rng.integers(0, 8))
            after = {"id": k, "v": int(rng.integers(0, 99)),
                     "w": ["x", "y", None][int(rng.integers(0, 3))]}
            if k in current and rng.random() < 0.3:
                after = None
            before = current.pop(k, None)
            if after is not None:
                current[k] = after
            if before is not None or after is not None:
                out.append(_js({"payload": {"before": before, "after": after}}))
        steps.append(out)
    return steps


def _boot_changes(step: int) -> list:
    return _boot_stream()[step]


def _boot_put(root: str, step: int) -> None:
    _put("ref", root, "dbz", [(None, v) for v in _boot_changes(step)])


def _sink_until(c, name: str) -> None:
    """Run the sink up to the source's upper: the view's output follows."""
    c.sinks[name].run_until(c.sources["dz"].writers["dz"].upper, timeout=30)


def test_port_boots_from_the_reference_kafka_directories(tmp_path):
    stopped, never = str(tmp_path / "stopped"), str(tmp_path / "never")
    reads = ["SELECT * FROM agg", "SELECT * FROM dz", "SELECT * FROM dz_progress"]

    def consolidated(root):
        b = broker_mod("ref").FileBroker(os.path.join(root, "broker"))
        vals = [json.loads(r.value)["payload"] for r in b.fetch("agg.out", 0, 0, 10_000)]
        acc = {}
        for v in vals:
            for side, d in (("before", -1), ("after", 1)):
                if v[side] is not None:
                    key = (tuple(sorted(v[side].items())), v["ts"])
                    acc[key] = acc.get(key, 0) + d
        return len(vals), {k: n for k, n in acc.items() if n}

    # The reference's deployment: a source, an MV and a sink, then a stop.
    for root in (stopped, never):
        _boot_put(root, 0)
    cl = Cluster("ref", stopped)
    try:
        c = cl.coordinator()
        for sql in (BOOT_SOURCE, BOOT_MV, BOOT_SINK):
            c.execute(sql.format(b=os.path.join(stopped, "broker")))
        _boot_put(stopped, 1)
        c.sources["dz"].tick_once()
        _sink_until(c, "out")
    finally:
        cl.shutdown()
    published_before = consolidated(stopped)[0]
    # The port boots from those directories and takes new records.
    _boot_put(stopped, 2)
    cl = Cluster("port", stopped)
    try:
        c = cl.coordinator()
        assert c.recovery["replay_failures"] == 0
        c.sources["dz"].tick_once()
        _sink_until(c, "out")
        port_reads = [sorted(c.execute(r).rows, key=repr) for r in reads]
    finally:
        cl.shutdown()
    # A reference run that never stopped, over the same records.
    cl = Cluster("ref", never)
    try:
        c = cl.coordinator()
        for sql in (BOOT_SOURCE, BOOT_MV, BOOT_SINK):
            c.execute(sql.format(b=os.path.join(never, "broker")))
        _boot_put(never, 1)
        c.sources["dz"].tick_once()
        _boot_put(never, 2)
        c.sources["dz"].tick_once()
        _sink_until(c, "out")
        ref_reads = [sorted(c.execute(r).rows, key=repr) for r in reads]
    finally:
        cl.shutdown()
    assert port_reads == ref_reads and port_reads[0]
    # The sink published each (row, time) once: the topic equals the
    # never-stopped run's, record for record, after the boot's additions.
    n_stopped, acc_stopped = consolidated(stopped)
    n_never, acc_never = consolidated(never)
    assert n_stopped > published_before
    assert (n_stopped, acc_stopped) == (n_never, acc_never)


# -- faults of the reference the port does not copy -----------------------------


def test_source_keeps_ticking_beside_readers_and_compaction(tmp_path):
    """A Kafka source ticking fast beside readers of its shards and the
    background compactor (whose state GC truncates consensus below the
    head): the reference's consensus check-then-insert let a shard's
    upper go back, and the source stalled on ``UpperMismatch`` within a
    few hundred ticks. The port's ticks all land."""
    import threading
    import time

    sources = mod("port", "coord.sources")
    persist = mod("port", "storage.persist")
    bm = broker_mod("port")
    b = bm.FileBroker(str(tmp_path / "broker"))
    b.create_topic("t", 4)
    sch = schema("port", [("k", "INT64", 0, False), ("v", "INT64", 0, False)])
    client = persist.PersistClient(persist.FileBlob(str(tmp_path / "blob")),
                                   persist.SqliteConsensus(str(tmp_path / "c.db")),
                                   auto_compaction=True)
    src = sources.GeneratorSource(
        client, "s", "kafka", {"broker": str(tmp_path / "broker"), "topic": "t",
                               "_schema": sch, "_name": "s", "envelope": "debezium"},
        "u1", tick_interval=0.002)
    stop = threading.Event()

    def produce():
        i = 0
        while not stop.is_set():
            b.append_txn([("t", p, [bm.Record(None, _js(
                {"payload": {"before": None, "after": {"k": i, "v": p}}}))]) for p in range(4)])
            i += 1
            time.sleep(0.001)

    def read():
        while not stop.is_set():
            for sub, shard in src.shards.items():
                r = client.open_reader(shard, "rd")
                try:
                    up = src.writers[sub].machine.reload().upper
                    if up > 0:
                        r.snapshot(up - 1)
                finally:
                    r.expire()

    threads = [threading.Thread(target=f, daemon=True) for f in (produce,) + (read,) * 4]
    configs = mod("port", "utils.dyncfg").COMPUTE_CONFIGS
    configs.update({"arrangement_compaction_batches": 2})  # a compaction and GC often
    src.start()
    for t in threads:
        t.start()
    try:
        t0 = time.monotonic()
        while src.t < 300 and src.status == "running" and time.monotonic() - t0 < 60:
            time.sleep(0.05)
    finally:
        stop.set()
        src.stop()
        for t in threads:
            t.join(10)
        configs.update({"arrangement_compaction_batches": None})
    assert src.last_error == "" and src.t >= 300, (src.t, src.last_error)
    uppers = {w.machine.reload().upper for w in src.writers.values()}
    assert uppers == {src.t}


def test_a_failed_tick_append_is_retried_with_its_records(tmp_path):
    """A tick whose append fails is retried with the batches it drew: the
    Kafka adapter had already moved its offsets past their records (the
    reference draws the tick again, and those records are lost)."""
    sources = mod("port", "coord.sources")
    persist = mod("port", "storage.persist")
    root = str(tmp_path)
    _put("port", root, "t", [(None, _js({"k": i, "v": i})) for i in range(3)])
    sch = schema("port", [("k", "INT64", 0, False), ("v", "INT64", 0, False)])
    client = persist.PersistClient(persist.FileBlob(str(tmp_path / "blob")),
                                   persist.SqliteConsensus(str(tmp_path / "c.db")))
    src = sources.GeneratorSource(
        client, "s", "kafka", {"broker": os.path.join(root, "broker"), "topic": "t",
                               "_schema": sch, "_name": "s"}, "u1", tick_interval=None)
    _put("port", root, "t", [(None, _js({"k": 7, "v": 70}))])
    w = src.writers["s"]
    real = w.compare_and_append
    calls = []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("injected append failure")
        return real(*args, **kw)

    w.compare_and_append = flaky
    with pytest.raises(OSError, match="injected"):
        src.tick_once()
    assert src.tick_once() == 2 and len(calls) == 2
    reader = client.open_reader(src.shards["s"], "check")
    try:
        _sch, cols, _nulls, time_, diff = reader.snapshot(1)
    finally:
        reader.expire()
    got = sorted(zip(cols[0].tolist(), cols[1].tolist(), diff.tolist()))
    assert got == [(0, 0, 1), (1, 1, 1), (2, 2, 1), (7, 70, 1)]
