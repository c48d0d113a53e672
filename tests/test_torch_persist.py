"""Port parity for persist and its native library.

- The port's ``native`` (its own copy of ``mtnative.cpp``, built with g++
  at first use) against ``materialize_tpu.native`` and against its own
  plain versions: CRC32C, the zigzag varint codec at the int64 ends,
  ``consolidate_i64``.
- ``encode_part`` byte for byte equal across the packages on equal
  inputs, and ``decode_part`` of each other's parts.
- The cases of ``tests/test_persist.py`` that need only this slice's
  modules, each one parametrised test run against both packages
  (``TestMaintainedView`` and the device-resident index sharing over the
  port's ``Dataflow`` on the CPU).
- A shard written by one package's ``PersistClient`` read by the other's,
  with string, decimal, date and nullable columns.
- ``MaintainedView.step_span`` over a dataflow whose state tier
  overflows inside the span: the sink shard gets the replayed deltas
  exactly once.
- A reload that read a shard's head before another thread's append
  landed leaves the shared ``Machine`` at the newer state, so the writer
  goes on appending at the shard's upper (the port's alone).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from tests.oracle import as_multiset
from tests.torch_serving import deadline, mod, one_torch_thread  # noqa: F401

PKGS = ["ref", "port"]


class Pkg:
    """One package's persist surface, plus what the view tests render."""

    def __init__(self, name: str):
        self.name = name
        self.persist = mod(name, "storage.persist")
        self.codec = mod(name, "storage.persist.codec")
        sch = mod(name, "repr.schema")
        self.Column, self.ColumnType, self.Schema = sch.Column, sch.ColumnType, sch.Schema
        self.GLOBAL_DICT = sch.GLOBAL_DICT
        self.mir = mod(name, "expr.relation")
        self.col = mod(name, "expr.scalar").col
        self._Dataflow = mod(name, "render.dataflow").Dataflow
        self.KV = self.Schema([
            self.Column("k", self.ColumnType.INT64),
            self.Column("v", self.ColumnType.INT64),
        ])

    def dataflow(self, expr, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self._Dataflow(expr, **kw)

    def client(self, blob=None, cons=None):
        p = self.persist
        return p.PersistClient(blob or p.MemBlob(), cons or p.MemConsensus())

    def sum_by_k(self):
        """SUM(v) GROUP BY k over the kv source."""
        m = self.mir
        return m.Get("kv", self.KV).reduce(
            (0,), (m.AggregateExpr(m.AggregateFunc.SUM_INT, self.col(1)),)
        )


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


def _updates(pairs, t=0):
    """pairs: [(k, v, diff)] -> (cols, nulls, time, diff) host arrays."""
    k = np.array([p[0] for p in pairs], np.int64)
    v = np.array([p[1] for p in pairs], np.int64)
    d = np.array([p[2] for p in pairs], np.int64)
    return [k, v], [None, None], np.full(len(pairs), t, np.uint64), d


def _content(reader, t):
    _sch, cols, _n, _t, diff = reader.snapshot(t)
    out: dict = {}
    for i in range(len(diff)):
        key = (int(cols[0][i]), int(cols[1][i]))
        out[key] = out.get(key, 0) + int(diff[i])
    return {k: n for k, n in out.items() if n}


# -- native -------------------------------------------------------------------


def _native():
    from materialize_tpu import native as jn
    from materialize_tpu_torch import native as tn

    return jn, tn


@pytest.mark.parametrize("size", [0, 1, 1 << 20])
def test_crc32c(size):
    jn, tn = _native()
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    got = tn.crc32c(data)
    assert got == jn.crc32c(data)
    if size <= 1:
        assert got == tn.crc32c_plain(data)
    else:  # the plain version is a Python loop: check a 64 KiB prefix
        assert tn.crc32c(data[: 1 << 16]) == tn.crc32c_plain(data[: 1 << 16])


def test_varint_codec_at_the_ends():
    jn, tn = _native()
    ends = [0, 1, -1, 2, -2, 1 << 62, -(1 << 62), (1 << 63) - 1, -(1 << 63)]
    rng = np.random.default_rng(7)
    vals = np.array(ends + list(rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64))
                    + ends[::-1], np.int64)
    for a in (vals, np.array(ends, np.int64), np.zeros(0, np.int64)):
        enc = tn.vbyte_encode_i64(a)
        assert enc == jn.vbyte_encode_i64(a)
        assert enc == tn.vbyte_encode_i64_plain(a)
        np.testing.assert_array_equal(tn.vbyte_decode_i64(enc, len(a)), a)
        np.testing.assert_array_equal(tn.vbyte_decode_i64_plain(enc, len(a)), a)
    with pytest.raises(ValueError, match="malformed"):
        tn.vbyte_decode_i64(b"\x80", 1)


def test_consolidate_i64():
    jn, tn = _native()
    rng = np.random.default_rng(3)
    n = 4000
    keys = [rng.integers(0, 40, n), rng.integers(-3, 3, n), rng.integers(0, 2, n)]
    diffs = rng.choice([-2, -1, 1, 2], n).astype(np.int64)
    rows, sums = tn.consolidate_i64(keys, diffs)
    jrows, jsums = jn.consolidate_i64(keys, diffs)
    prows, psums = tn.consolidate_i64_plain(keys, diffs)

    def as_map(rows, sums):
        return {tuple(int(k[r]) for k in keys): int(s) for r, s in zip(rows, sums)}

    assert as_map(rows, sums) == as_map(jrows, jsums) == as_map(prows, psums)
    assert all(s != 0 for s in sums)
    e = tn.consolidate_i64([np.zeros(0, np.int64)], np.zeros(0, np.int64))
    assert len(e[0]) == len(e[1]) == 0


# -- codec ----------------------------------------------------------------------


def _mixed_part(p: Pkg):
    """Strings, a scaled decimal, a date and a nullable int, coded in
    ``p``'s dictionary."""
    C, T = p.Column, p.ColumnType
    schema = p.Schema([
        C("s", T.STRING, nullable=True), C("dec", T.DECIMAL, scale=2),
        C("d", T.DATE), C("x", T.INT64, nullable=True),
    ])
    strs = ["foo", "bar", "", "foo", "zed"]
    cols = [
        p.GLOBAL_DICT.encode_many(strs),
        np.array([150, -5, 0, 123456, 7], np.int64),
        np.array([0, 19000, 10957, 1, 20000], np.int32),
        np.array([1, 2, 3, 4, 1 << 40], np.int64),
    ]
    nulls = [np.array([False, False, True, False, False]), None, None,
             np.array([False, True, False, False, True])]
    time = np.array([0, 0, 1, 1, 2], np.uint64)
    diff = np.array([1, -1, 2, 1, 1], np.int64)
    return schema, cols, nulls, time, diff


def _decoded(p: Pkg, data: bytes):
    """A part decoded by ``p``, string codes back to strings."""
    sch, cols, nulls, time, diff = p.codec.decode_part(data)
    out = []
    for c, a in zip(sch.columns, cols):
        out.append(p.GLOBAL_DICT.decode_many(a) if c.ctype.name == "STRING" else a.tolist())
    return ([(c.name, c.ctype.name, c.nullable, c.scale) for c in sch.columns], out,
            [None if n is None else n.tolist() for n in nulls], time.tolist(), diff.tolist())


def test_encode_part_byte_equal_and_cross_decode():
    jp, tp = Pkg("ref"), Pkg("port")
    jdata = jp.codec.encode_part(*_mixed_part(jp))
    tdata = tp.codec.encode_part(*_mixed_part(tp))
    assert jdata == tdata
    assert _decoded(tp, jdata) == _decoded(jp, jdata) == _decoded(jp, tdata)
    assert jp.codec.part_stats(jdata) == tp.codec.part_stats(tdata)


@pytest.mark.parametrize("p", PKGS)
def test_codec_roundtrip_with_nulls_and_strings(p):
    p = Pkg(p)
    C, T = p.Column, p.ColumnType
    schema = p.Schema([C("s", T.STRING), C("x", T.INT64, nullable=True)])
    codes = p.GLOBAL_DICT.encode_many(["foo", "bar", "foo"])
    cols = [codes, np.array([1, 2, 3], np.int64)]
    nulls = [None, np.array([False, True, False])]
    time = np.array([0, 0, 1], np.uint64)
    diff = np.array([1, -1, 2], np.int64)
    data = p.codec.encode_part(schema, cols, nulls, time, diff)
    sch2, c2, n2, t2, d2 = p.codec.decode_part(data)
    assert [c.name for c in sch2.columns] == ["s", "x"]
    assert p.GLOBAL_DICT.decode_many(c2[0]) == ["foo", "bar", "foo"]
    np.testing.assert_array_equal(c2[1], cols[1])
    np.testing.assert_array_equal(n2[1], nulls[1])
    np.testing.assert_array_equal(t2, time)
    np.testing.assert_array_equal(d2, diff)


def test_codec_stats_and_corruption(pkg):
    data = pkg.codec.encode_part(pkg.KV, *_updates([(5, 50, 1), (9, 90, 1)]))
    stats = pkg.codec.part_stats(data)
    assert stats["k"] == [5, 9] and stats["v"] == [50, 90]
    with pytest.raises(pkg.codec.PartCorruptError):
        pkg.codec.decode_part(data[:-1] + bytes([data[-1] ^ 0xFF]))


# -- the machine ------------------------------------------------------------------


def test_machine_append_and_snapshot(pkg):
    c = pkg.client()
    w = c.open_writer("s1", pkg.KV)
    w.compare_and_append(*_updates([(1, 10, 1), (2, 20, 1)], t=0), 0, 1)
    w.compare_and_append(*_updates([(1, 10, -1)], t=1), 1, 2)
    assert _content(c.open_reader("s1"), 1) == {(2, 20): 1}


def test_machine_upper_mismatch_and_empty_advance(pkg):
    w = pkg.client().open_writer("s1", pkg.KV)
    w.compare_and_append(*_updates([(1, 1, 1)]), 0, 5)
    with pytest.raises(pkg.persist.UpperMismatch):
        w.compare_and_append(*_updates([(2, 2, 1)], t=3), 3, 6)
    w.compare_and_append([np.zeros(0, np.int64)] * 2, [None, None],
                         np.zeros(0, np.uint64), np.zeros(0, np.int64), 5, 10)
    assert w.upper == 10


def test_machine_writer_fencing(pkg):
    c = pkg.client()
    w1 = c.open_writer("s1", pkg.KV)
    w2 = c.open_writer("s1", pkg.KV)  # newer epoch fences w1
    with pytest.raises(pkg.persist.Fenced):
        w1.compare_and_append(*_updates([(1, 1, 1)]), 0, 1)
    w2.compare_and_append(*_updates([(1, 1, 1)]), 0, 1)


def test_machine_since_holds_and_compaction(pkg):
    c = pkg.client()
    w = c.open_writer("s1", pkg.KV)
    for t in range(12):
        ups = [(7, t, 1)] + ([(7, t - 1, -1)] if t else [])
        w.compare_and_append(*_updates(ups, t=t), t, t + 1)
    r = c.open_reader("s1", "rA")
    m = c.machine("s1")
    r.downgrade_since(10)
    assert m.reload().since == 10
    assert m.maybe_compact(max_batches=2) > 0
    assert len(m.reload().batches) <= 2
    with pytest.raises(ValueError):
        r.snapshot(9)
    _sch, cols, _n, time, diff = r.snapshot(10)
    rows = [(int(cols[0][i]), int(cols[1][i]), int(time[i]), int(diff[i]))
            for i in range(len(diff))]
    assert as_multiset(rows) == {(7, 10): 1}
    m.gc_consensus()
    c2 = pkg.persist.PersistClient(c.blob, c.consensus)
    assert c2.machine("s1").state.upper == 12


def test_machine_concurrent_compaction_loses_cleanly(pkg):
    blob, cons = pkg.persist.MemBlob(), pkg.persist.MemConsensus()
    cA, cB = pkg.client(blob, cons), pkg.client(blob, cons)
    w = cA.open_writer("s1", pkg.KV)
    for t in range(10):
        w.compare_and_append(*_updates([(t % 3, t, 1)], t=t), t, t + 1)
    mA, mB = cA.machine("s1"), cB.machine("s1")
    stA = mA.reload()
    mA._merge_parts(stA)
    mB.maybe_compact(max_batches=1)
    w.compare_and_append(*_updates([(9, 9, 1)], t=10), 10, 11)
    prefix = stA.batches

    def f(cur):
        if cur.batches[: len(prefix)] != prefix:
            return None, 0
        raise AssertionError("stale prefix should not match")

    assert mA._apply(f) == 0
    _sch, _c, _n, _t, diff = cA.open_reader("s1").snapshot(10)
    assert int(diff.sum()) == 11


def test_machine_compaction_of_all_empty_batches(pkg):
    c = pkg.client()
    w = c.open_writer("s1", pkg.KV)
    empty = ([np.zeros(0, np.int64)] * 2, [None, None],
             np.zeros(0, np.uint64), np.zeros(0, np.int64))
    for t in range(10):
        w.compare_and_append(*empty, t, t + 1)
    m = c.machine("s1")
    m.maybe_compact(max_batches=2)
    assert len(m.reload().batches) <= 3 and m.reload().upper == 10


def test_machine_fileblob_rejects_escaping_keys(pkg, tmp_path):
    with pytest.raises(ValueError):
        pkg.persist.FileBlob(str(tmp_path / "blob")).set("../escape", b"x")


def test_machine_multiple_reader_holds(pkg):
    c = pkg.client()
    w = c.open_writer("s1", pkg.KV)
    w.compare_and_append(*_updates([(1, 1, 1)]), 0, 5)
    rA, rB = c.open_reader("s1", "rA"), c.open_reader("s1", "rB")
    rA.downgrade_since(4)
    assert c.machine("s1").reload().since == 0
    rB.expire()
    rA.downgrade_since(4)
    assert c.machine("s1").reload().since == 4


def test_machine_concurrent_cas_total_order(pkg):
    cons = pkg.persist.MemConsensus()
    oks = []

    def contend(i):
        oks.append(cons.compare_and_set("k", None, pkg.persist.VersionedData(0, f"w{i}".encode())))

    ts = [threading.Thread(target=contend, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert sum(oks) == 1


def test_stale_reload_keeps_the_newer_cached_state():
    # A table's writer and its SUBSCRIBE tail share the shard's Machine.
    # The tail reads the head, the writer's append lands, then the
    # tail's reload finishes with the head it read before the append.
    pkg = Pkg("port")
    c = pkg.client()
    w = c.open_writer("s1", pkg.KV)
    w.compare_and_append(*_updates([(1, 1, 1)]), 0, 1)
    before = w.machine.consensus.head("s1")
    w.compare_and_append(*_updates([(2, 2, 1)], t=1), 1, 2)
    head = w.machine.consensus.head
    w.machine.consensus.head = lambda key: before
    try:
        assert w.machine.reload().upper == 2
    finally:
        w.machine.consensus.head = head
    assert w.upper == 2
    w.compare_and_append(*_updates([(3, 3, 1)], t=2), w.upper, 3)
    assert _content(c.open_reader("s1"), 2) == {(1, 1): 1, (2, 2): 1, (3, 3): 1}


def test_reference_stale_reload_puts_the_older_state_back():
    # The same interleaving in the reference: its Machine caches the
    # head the tail read, the writer's cached upper goes back, and its
    # next append raises UpperMismatch. A reference cluster beside the
    # port's under load fails so (tests/test_torch_subscribe.py,
    # tests/test_subscribe.py); ROADMAP Queue 3.
    pkg = Pkg("ref")
    c = pkg.client()
    w = c.open_writer("s1", pkg.KV)
    w.compare_and_append(*_updates([(1, 1, 1)]), 0, 1)
    before = w.machine.consensus.head("s1")
    w.compare_and_append(*_updates([(2, 2, 1)], t=1), 1, 2)
    head = w.machine.consensus.head
    w.machine.consensus.head = lambda key: before
    try:
        assert w.machine.reload().upper == 1
    finally:
        w.machine.consensus.head = head
    assert w.upper == 1
    with pytest.raises(pkg.persist.UpperMismatch):
        w.compare_and_append(*_updates([(3, 3, 1)], t=1), w.upper, 3)


def test_sqlite_consensus_cas_across_connections(pkg, tmp_path):
    path = str(tmp_path / "consensus.db")
    VD = pkg.persist.VersionedData
    c1, c2 = pkg.persist.SqliteConsensus(path), pkg.persist.SqliteConsensus(path)
    assert c1.compare_and_set("k", None, VD(0, b"a"))
    assert not c2.compare_and_set("k", None, VD(0, b"b"))
    assert c2.compare_and_set("k", 0, VD(1, b"c"))
    assert c1.head("k").data == b"c"
    assert [v.seqno for v in c1.scan("k", 0)] == [0, 1]
    c1.truncate("k", 1)
    assert [v.seqno for v in c2.scan("k", 0)] == [1]


def test_file_blob_roundtrip(pkg, tmp_path):
    b = pkg.persist.FileBlob(str(tmp_path / "blob"))
    b.set("shard/part-1", b"hello")
    b.set("shard/part-2", b"world")
    assert b.get("shard/part-1") == b"hello"
    assert b.list_keys("shard/") == ["shard/part-1", "shard/part-2"]
    b.delete("shard/part-1")
    assert b.get("shard/part-1") is None


# -- fault injection ------------------------------------------------------------


def test_writer_retries_unreliable_blob(pkg):
    blob = pkg.persist.UnreliableBlob(pkg.persist.MemBlob(), fail_every=2)
    c = pkg.client(blob)
    w = c.open_writer("s1", pkg.KV)
    for t in range(6):
        w.compare_and_append(*_updates([(t, t, 1)], t=t), t, t + 1)
    blob.fail_every = 0
    _sch, _c, _n, _t, diff = c.open_reader("s1").snapshot(5)
    assert int(diff.sum()) == 6


@pytest.mark.parametrize("fail_every", [2, 3, 5])
def test_acked_writes_survive_reload_under_faults(pkg, fail_every):
    blob, cons = pkg.persist.MemBlob(), pkg.persist.MemConsensus()
    c = pkg.client(pkg.persist.UnreliableBlob(blob, fail_every=fail_every), cons)
    w = c.open_writer("s1", pkg.KV)
    acked: dict = {}
    for t in range(20):
        ups = [(t % 4, t, 1)] + ([(t % 4, t - 4, -1)] if t >= 4 else [])
        w.compare_and_append(*_updates(ups, t=t), t, t + 1)
        for k, v, d in ups:
            acked[(k, v)] = acked.get((k, v), 0) + d
    acked = {k: n for k, n in acked.items() if n}
    c2 = pkg.client(blob, cons)
    assert c2.machine("s1").reload().upper == 20
    assert _content(c2.open_reader("s1"), 19) == acked


def test_failed_write_invisible_after_reload(pkg):
    blob, cons = pkg.persist.MemBlob(), pkg.persist.MemConsensus()
    ub = pkg.persist.UnreliableBlob(blob, fail_every=0)
    c = pkg.client(ub, cons)
    w = c.open_writer("s1", pkg.KV)
    w.compare_and_append(*_updates([(1, 10, 1)], t=0), 0, 1)
    ub.fail_every = 1
    with pytest.raises(pkg.persist.ExternalDurabilityError):
        w.compare_and_append(*_updates([(2, 20, 1)], t=1), 1, 2)
    ub.fail_every = 0
    c2 = pkg.client(blob, cons)
    st = c2.machine("s1").reload()
    assert st.upper == 1
    for b in st.batches:
        for key in b.keys:
            assert blob.get(key) is not None
    assert _content(c2.open_reader("s1"), 0) == {(1, 10): 1}
    w2 = c2.open_writer("s1", pkg.KV)
    w2.compare_and_append(*_updates([(2, 20, 1)], t=1), 1, 2)
    assert w2.upper == 2


def test_compaction_under_faults_preserves_content(pkg):
    blob, cons = pkg.persist.MemBlob(), pkg.persist.MemConsensus()
    ub = pkg.persist.UnreliableBlob(blob, fail_every=4)
    c = pkg.client(ub, cons)
    w = c.open_writer("s1", pkg.KV)
    for t in range(12):
        w.compare_and_append(*_updates([(t % 3, t, 1)], t=t), t, t + 1)
    m = c.machine("s1")
    c.open_reader("s1", "hold").downgrade_since(11)
    before = _content(c.open_reader("s1", "chk"), 11)
    m.maybe_compact(max_batches=2)
    assert len(m.reload().batches) <= 2
    assert _content(c.open_reader("s1", "chk"), 11) == before
    ub.fail_every = 0
    assert _content(pkg.client(blob, cons).open_reader("s1"), 11) == before


# -- shards across packages -----------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_shard_written_by_one_package_read_by_the_other(tmp_path, writer, reader):
    w, r = Pkg(writer), Pkg(reader)
    schema, cols, nulls, time, diff = _mixed_part(w)
    wc = w.client(w.persist.FileBlob(str(tmp_path / "blob")),
                  w.persist.SqliteConsensus(str(tmp_path / "c.db")))
    h = wc.open_writer("mixed", schema)
    h.compare_and_append(cols, nulls, np.zeros(5, np.uint64), diff, 0, 1)
    h.compare_and_append([c[:2] for c in cols], [None if n is None else n[:2] for n in nulls],
                         np.ones(2, np.uint64), -diff[:2], 1, 2)
    rc = r.client(r.persist.FileBlob(str(tmp_path / "blob")),
                  r.persist.SqliteConsensus(str(tmp_path / "c.db")))
    rd = rc.open_reader("mixed")
    assert rd.upper == 2
    for t in (0, 1):
        sch, rcols, rnulls, rtime, rdiff = rd.snapshot(t)
        rows = mod(reader, "repr.schema").decode_result_rows(sch, rcols, rnulls, rtime, rdiff)
        exp = mod(writer, "repr.schema").decode_result_rows(
            schema, cols, nulls, np.full(5, t, np.uint64), diff)
        if t == 1:
            exp = exp[2:]  # the first two rows are retracted at t=1
        assert as_multiset(rows) == as_multiset(exp)


# -- maintained views -----------------------------------------------------------


def _feed(w, t, ups):
    w.compare_and_append(*_updates(ups, t=t), t, t + 1)


def test_maintained_view_and_restart(pkg, tmp_path):
    P = pkg.persist
    blob = P.FileBlob(str(tmp_path / "blob"))
    c = P.PersistClient(blob, P.SqliteConsensus(str(tmp_path / "consensus.db")))
    w = c.open_writer("kv", pkg.KV)
    _feed(w, 0, [(1, 10, 1), (2, 20, 1)])
    _feed(w, 1, [(1, 5, 1)])
    mv = P.MaintainedView(c, pkg.dataflow(pkg.sum_by_k()), {"kv": ("kv", pkg.KV)}, "mv_out")
    _feed(w, 2, [(2, 20, -1), (3, 7, 1)])
    mv.run_until(3)
    assert as_multiset(mv.peek()) == {(1, 15): 1, (3, 7): 1}
    assert _content(c.open_reader("mv_out"), 2) == {(1, 15): 1, (3, 7): 1}
    del mv
    c2 = P.PersistClient(blob, P.SqliteConsensus(str(tmp_path / "consensus.db")))
    mv2 = P.MaintainedView(c2, pkg.dataflow(pkg.sum_by_k()), {"kv": ("kv", pkg.KV)}, "mv_out")
    assert as_multiset(mv2.peek()) == {(1, 15): 1, (3, 7): 1}
    w2 = c2.open_writer("kv", pkg.KV)
    _feed(w2, 3, [(1, 100, 1)])
    mv2.run_until(4)
    assert as_multiset(mv2.peek()) == {(1, 115): 1, (3, 7): 1}
    with pytest.raises(P.Fenced):
        _feed(w, 4, [(9, 9, 1)])


def test_maintained_view_hydration_from_nonzero_since(pkg):
    c = pkg.client()
    w = c.open_writer("kv", pkg.KV)
    for t in range(6):
        _feed(w, t, [(1, 1, 1)])
    c.open_reader("kv", "holdr").downgrade_since(4)
    c.machine("kv").maybe_compact(max_batches=1)
    mv = pkg.persist.MaintainedView(
        c, pkg.dataflow(pkg.sum_by_k()), {"kv": ("kv", pkg.KV)}, "mv_out2")
    mv.run_until(6)
    assert as_multiset(mv.peek()) == {(1, 6): 1}


def test_device_resident_index_sharing(pkg):
    P = pkg.persist
    c = pkg.client()
    w = c.open_writer("kv", pkg.KV)
    for t, ups in enumerate([[(1, 10, 1), (2, 20, 1)], [(1, 5, 1)], [(2, 20, -1)]]):
        w.compare_and_append(*_updates(ups, t=t), t, t + 1)
    pub = P.MaintainedView(c, pkg.dataflow(pkg.sum_by_k()), {"kv": ("kv", pkg.KV)}, None)
    pub.run_until(3)
    assert as_multiset(pub.peek()) == {(1, 15): 1}
    sub_schema = pub.df.out_schema
    isrc = P.IndexSource(pub, sub_schema)
    sub_expr = pkg.mir.Get("agg", sub_schema).filter([pkg.col(1).gte(pkg.col(1))])
    sub = P.MaintainedView(c, pkg.dataflow(sub_expr), {}, None, index_sources={"agg": isrc})
    assert isrc._device and isrc.host_transfers == 0
    assert as_multiset(sub.peek()) == as_multiset(pub.peek())
    w.compare_and_append(*_updates([(3, 7, 1)], t=3), 3, 4)
    pub.run_until(4)
    sub.run_until(4)
    assert isrc.host_transfers == 0
    assert as_multiset(sub.peek()) == as_multiset(pub.peek())
    assert as_multiset(sub.peek())[(3, 7)] == 1


def test_step_span_overflow_sends_the_replayed_deltas_once():
    """The port's sinked span path over a reduce whose state tier (256
    rows) overflows on the span's sixth tick: ``check_flags`` rolls the
    span back, grows the tier and replays it, and the sink shard must
    get the replayed deltas, each tick's once."""
    p = Pkg("port")
    c = p.client()
    w = c.open_writer("kv", p.KV)
    _feed(w, 0, [(0, 1, 1)])
    mv = p.persist.MaintainedView(
        c, p.dataflow(p.sum_by_k(), state_cap=256), {"kv": ("kv", p.KV)}, "sink")
    assert mv.upper == 0  # nothing compacted: the view replays from time 0
    expect: dict = {0: 1}
    for t in range(1, 9):
        # Ticks 1-4 stay inside 256 groups; tick 5 brings 400 new keys;
        # ticks 6-8 add to keys of tick 5, whose groups the provisional
        # (overflowed) state lost.
        n = 400 if t == 5 else 40
        ups = [(k, t, 1) for k in range(1000 * t, 1000 * t + n)]
        if t > 5:
            ups += [(k, t, 1) for k in range(5000 + 7 * t, 5400, 50)]
        _feed(w, t, ups)
        for k, v, _d in ups:
            expect[k] = expect.get(k, 0) + v
    readbacks = mv.df._readbacks
    assert mv.step_span(max_ticks=16, timeout=5.0)  # ticks 0-8, one span
    assert mv.upper == 9
    assert mv.df._grown, "the span should have overflowed the state tier"
    assert mv.df._readbacks - readbacks >= 2  # the span's, then the replay's
    want = {(k, v): 1 for k, v in expect.items()}
    assert as_multiset(mv.peek()) == want
    got = _content(c.open_reader("sink"), 8)
    assert got == want  # every row once: no provisional delta in the sink
    # Each tick's chunk of the sink holds exactly that tick's groups.
    _sch, cols, _n, time, diff = c.open_reader("sink").snapshot(8)
    assert int(diff.sum()) == len(want)
