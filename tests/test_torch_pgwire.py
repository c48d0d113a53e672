"""Port parity for the PostgreSQL wire protocol front end.

The exchanges of ``tests/test_server.py``'s ``TestPgwire`` (all but
SUBSCRIBE, which the port does not serve yet) run against the port's
``PgServer`` and the reference's, each over its own in-process cluster;
columns, rows, command tags, message tags and error codes (SQLSTATE and
message) must be equal, and the reference test's own assertions hold on
the port's side. SUBSCRIBE over the port's wire ends in the
coordinator's error, and the session lives on.
"""

from __future__ import annotations

import struct

import pytest

from tests.torch_serving import Cluster, MiniPg, deadline, mod, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{package: PgServer port}, each over its own cluster."""
    up: dict = {}
    try:
        for pkg in ("ref", "port"):
            cl = Cluster(pkg, str(tmp_path_factory.mktemp(pkg)))
            up[pkg] = (cl, mod(pkg, "server.pgwire").PgServer(cl.coordinator()).start())
        yield {pkg: pg.port for pkg, (_cl, pg) in up.items()}
    finally:
        for cl, pg in up.values():
            pg.stop()
            pg._thread.join(10)
            cl.shutdown()


def both(servers, exchange):
    """Run one exchange on a fresh connection to each server; the
    transcripts must be equal. Returns the port's."""
    out = {}
    for pkg, port in servers.items():
        c = MiniPg(port)
        try:
            out[pkg] = exchange(c)
        finally:
            c.close()
    assert out["port"] == out["ref"]
    return out["port"]


def test_handshake_and_basic_flow(servers):
    def ex(c):
        return [
            c.params.get("server_name"),
            c.query("CREATE TABLE t (x bigint NOT NULL, s text)"),
            c.query("INSERT INTO t VALUES (1, 'one'), (2, NULL)"),
            c.query("SELECT x, s FROM t"),
        ]

    name, create, insert, select = both(servers, ex)
    assert name == "materialize_tpu"
    assert create[2] is None and create[3] == "CREATE"
    assert insert[2] is None and insert[3] == "INSERT 0 2"
    assert select == (["x", "s"], [("1", "one"), ("2", None)], None, "SELECT 2")


def test_errors_and_multi_statement(servers):
    def ex(c):
        return [
            c.query("SELECT * FROM does_not_exist"),
            c.query("SELECT 1"),  # the session survives errors
            c.query("CREATE TABLE mt (a bigint NOT NULL)"),
            c.query("INSERT INTO mt VALUES (1); INSERT INTO mt VALUES (2)"),
            c.query("SELECT count(*) FROM mt"),
            c.query("INSERT INTO mt VALUES (3); SELECT nope FROM mt; INSERT INTO mt VALUES (4)"),
            c.query("SELECT a FROM mt ORDER BY a"),
        ]

    bad, one, _c, multi, count, mid_error, after = both(servers, ex)
    assert bad[2][0] == "XX000" and "does_not_exist" in bad[2][1]
    assert one[1] == [("1",)] and one[2] is None
    assert multi[2] is None and count[1] == [("2",)]
    assert mid_error[2] is not None and "nope" in mid_error[2][1]
    assert after[1][:3] == [("1",), ("2",), ("3",)]


def test_explain_over_wire(servers):
    def ex(c):
        c.query("CREATE TABLE et (a bigint NOT NULL)")
        return c.query("EXPLAIN OPTIMIZED PLAN FOR SELECT count(*) FROM et")

    cols, rows, err, tag = both(servers, ex)
    assert err is None and tag == "EXPLAIN"
    assert any("Reduce" in r[0] for r in rows)


def test_extended_protocol_prepared_statement(servers):
    def ex(c):
        c.query("CREATE TABLE ep (a bigint NOT NULL, b text NOT NULL)")
        c.query("INSERT INTO ep VALUES (1,'x'), (2,'y'), (3,'x')")
        first = c.extended("SELECT a FROM ep WHERE b = $1 ORDER BY a", ["x"])
        numeric = c.extended("SELECT b FROM ep WHERE a = $1", ["2"])
        c.query("INSERT INTO ep VALUES (9, '123')")
        text = c.extended("SELECT a FROM ep WHERE b = $1", ["123"], param_oids=(25,))
        return [first, numeric, text]

    (tags, rows, err), numeric, text = both(servers, ex)
    assert err is None
    assert b"1" in tags and b"2" in tags and b"T" in tags
    assert [r[0] for r in rows] == ["1", "3"]
    assert numeric[2] is None and numeric[1] == [("y",)]
    assert text[2] is None and text[1] == [("9",)]


def test_extended_protocol_maxrows_suspend(servers):
    def ex(c):
        c.query("CREATE TABLE ms (v bigint NOT NULL)")
        c.query("INSERT INTO ms VALUES (1), (2), (3), (4)")
        cstr = lambda s: s.encode() + b"\x00"  # noqa: E731
        c.send(b"P", cstr("") + cstr("SELECT v FROM ms ORDER BY v") + struct.pack("!h", 0))
        c.send(b"B", cstr("") + cstr("") + struct.pack("!hhh", 0, 0, 0))
        c.send(b"E", cstr("") + struct.pack("!i", 3))  # limit 3
        c.send(b"E", cstr("") + struct.pack("!i", 0))  # the rest
        c.send(b"S", b"")
        return [(t, p) for t, p in c._read_until_ready()]

    msgs = both(servers, ex)
    tags = [t for t, _ in msgs]
    assert tags.count(b"D") == 4
    assert b"s" in tags and b"C" in tags
    assert tags.index(b"s") < tags.index(b"C")


def _copy_in(c, sql: str, body: bytes):
    c.send(b"Q", sql.encode() + b"\x00")
    tag, _ = c.read_msg()
    assert tag == b"G", tag  # CopyInResponse
    c.send(b"d", body)
    c.send(b"c", b"")
    tags, complete, err = [], None, None
    while True:
        tag, data = c.read_msg()
        tags.append(tag)
        if tag == b"C":
            complete = data[:-1].decode()
        if tag == b"E":
            err = MiniPg._error(data)
        if tag == b"Z":
            return tags, complete, err


def test_copy_in_and_out(servers):
    def ex(c):
        c.query("CREATE TABLE ct (a bigint NOT NULL, b text, d date NOT NULL)")
        copied = _copy_in(c, "COPY ct FROM STDIN",
                          b"1\thello\t2024-01-15\n2\t\\N\t1970-01-01\n")
        sel = c.query("SELECT a, b, extract(year FROM d) FROM ct ORDER BY a")
        c.send(b"Q", b"COPY (SELECT a, b FROM ct) TO STDOUT\x00")
        tag, _ = c.read_msg()
        out = b""
        while True:
            t, data = c.read_msg()
            if t == b"d":
                out += data
            if t == b"Z":
                break
        return [copied, sel, tag, sorted(out.decode().strip().split("\n"))]

    (tags, complete, err), sel, out_tag, lines = both(servers, ex)
    assert complete == "COPY 2" and err is None, (complete, tags)
    assert sel[2] is None and sel[1] == [("1", "hello", "2024"), ("2", None, "1970")]
    assert out_tag == b"H"  # CopyOutResponse
    assert lines == ["1\thello", "2\t\\N"]


def test_copy_in_empty_string_row_and_bad_bool(servers):
    def ex(c):
        c.query("CREATE TABLE ce (s text NOT NULL)")
        three = _copy_in(c, "COPY ce FROM STDIN", b"a\n\nb\n")  # middle row = ''
        c.query("CREATE TABLE cb (b bool NOT NULL)")
        bad = _copy_in(c, "COPY cb FROM STDIN", b"flase\n")
        return [three, bad, c.query("SELECT s FROM ce ORDER BY s")]

    three, bad, sel = both(servers, ex)
    assert three[1] == "COPY 3"
    assert bad[2] is not None and "bool" in bad[2][1]
    assert sel[1] == [("",), ("a",), ("b",)]


def test_extended_protocol_error_skips_to_sync(servers):
    def ex(c):
        return [c.extended("SELECT nope FROM missing", []), c.query("SELECT 1")]

    (tags, _rows, err), after = both(servers, ex)
    assert err is not None and b"E" in tags
    assert after[2] is None and after[1] == [("1",)]


def test_port_subscribe_surfaces_the_coordinators_error(servers):
    c = MiniPg(servers["port"])
    try:
        c.query("CREATE TABLE st (v bigint NOT NULL)")
        cols, rows, err, tag = c.query("SUBSCRIBE st")
        assert err is not None and err[0] == "XX000"
        assert "SUBSCRIBE is not ported" in err[1] and "item 6b" in err[1]
        assert c.query("SELECT 1")[1] == [("1",)]
    finally:
        c.close()
