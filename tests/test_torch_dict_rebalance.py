"""Port parity for the string-dictionary rebalance (``repr/schema.py``
``StringDictionary.rebalance``, ``expr/remap.py``, the coordinator's
replan and the replica's rebuild): the cases of
``tests/test_dict_rebalance.py`` through both packages.

- Fresh dictionaries of both packages take the same inserts and the same
  squeezed gap: both raise ``DictExhausted``, and both rebalances give
  the same {old: new} remap, order and later codes.
- ``remap_relation`` rewrites the same literals and constant rows.
- A maintained view over strings on a cluster of each package: a
  SELECT whose string table runs a squeezed gap dry makes the replica
  rebalance, remap and rebuild; a SELECT whose literal lands in a
  squeezed gap makes the coordinator rebalance and replan. Every answer
  equals the reference's, and the view still maintains.
- ``strings.slt`` over a dictionary polluted with catalog-JSON strings
  passes on the port's cluster (the file's expected results are the
  oracle the reference is held to in ``tests/test_dict_rebalance.py``).
- Snapshots: coherent across a rebalance, sharing same-epoch inserts,
  blind to later ones, in both packages.

The clusters run in this process, so both packages' ``GLOBAL_DICT`` are
given back as the file found them (``tests/torch_dict.py``).
"""

from __future__ import annotations

import json
import os

import pytest

from materialize_tpu.repr import schema as jschema
from materialize_tpu_torch.repr import schema as tschema
from tests.torch_dict import port_dict_restored, reference_dict_restored  # noqa: F401
from tests.torch_serving import Cluster, deadline, mod, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_dict_restored")

PKGS = ("ref", "port")
SCHEMA = {"ref": jschema, "port": tschema}


def _squeeze_gap(d, a: str, b: str):
    """Force the labels of two (new) strings adjacent, so any encode that
    lands between them runs the gap dry (``tests/test_dict_rebalance.py``'s
    recipe)."""
    ca, cb = d.encode(a), d.encode(b)
    assert ca < cb
    with d._lock:
        del d._by_code[cb]
        d._codes[b] = ca + 1
        d._by_code[ca + 1] = b
        d.version += 1


def _fresh(pkg: str, strings=()):
    d = SCHEMA[pkg].StringDictionary()
    for s in strings:
        d.encode(s)
    return d


SEED_STRINGS = [f"w{i:03d}-{'x' * (i % 7)}" for i in range(200)] + ["zzgapa", "zzgapb"]


def test_encode_raises_then_rebalance_recovers():
    mid = "zzgapaa"  # lands strictly between zzgapa and zzgapb
    out = {}
    for pkg in PKGS:
        d = _fresh(pkg, SEED_STRINGS)
        _squeeze_gap(d, "zzgapa", "zzgapb")
        with pytest.raises(SCHEMA[pkg].DictExhausted):
            d.encode(mid)
        old_order = [s for _, s in d.items_sorted()]
        heard = []
        d.add_rebalance_listener(heard.append)
        remap = d.rebalance()
        assert heard == [remap] and d.epoch == 1
        assert [s for _, s in d.items_sorted()] == old_order
        codes = [c for c, _ in d.items_sorted()]
        assert codes == sorted(codes)
        c = d.encode(mid)
        assert d.encode("zzgapa") < c < d.encode("zzgapb")
        d.remove_rebalance_listener(heard.append)
        d.rebalance()
        assert len(heard) == 1
        out[pkg] = (remap, codes, c)
    assert out["port"] == out["ref"]


def test_remap_relation_rewrites_literals_and_constants():
    got = {}
    for pkg in PKGS:
        mir = mod(pkg, "expr.relation")
        ms = mod(pkg, "expr.scalar")
        remap_relation = mod(pkg, "expr.remap").remap_relation
        S = SCHEMA[pkg]
        sch = S.Schema((S.Column("s", S.ColumnType.STRING), S.Column("n", S.ColumnType.INT64)))
        expr = mir.Filter(
            mir.Union((mir.Get("t", sch), mir.Constant((((17, 7), 1),), sch))),
            (ms.CallBinary(ms.BinaryFunc.EQ, ms.ColumnRef(0),
                           ms.Literal(5, S.ColumnType.STRING)),),
        )
        out = remap_relation(expr, {5: 111, 17: 222, 7: 999})
        assert remap_relation(expr, {}) is expr
        got[pkg] = (out.predicates[0].right.value, out.input.inputs[1].rows)
    # Integer values are untouched (7 stays 7).
    assert got["port"] == got["ref"] == (111, (((222, 7), 1),))


def _squeeze_where(pkg: str, lo: str, hi: str) -> None:
    _squeeze_gap(SCHEMA[pkg].GLOBAL_DICT, lo, hi)


def _exhaustion_scenario(pkg: str, root: str) -> list:
    cl = Cluster(pkg, root)
    try:
        c = cl.coordinator()
        out = []

        def rows(sql):
            out.append(sorted(c.execute(sql).rows))
            return out[-1]

        c.execute("CREATE TABLE rb (s text NOT NULL)")
        c.execute("INSERT INTO rb VALUES ('rbza'), ('rbzc')")
        c.execute("CREATE MATERIALIZED VIEW rbv AS SELECT s FROM rb WHERE s <> 'rbzx'")
        rows("SELECT s FROM rbv")
        epoch = SCHEMA[pkg].GLOBAL_DICT.epoch
        # upper('rbza') = 'RBZA' lands between RBZ and RBZB: the replica's
        # string table runs the gap dry, rebalances and rebuilds.
        _squeeze_where(pkg, "RBZ", "RBZB")
        rows("SELECT upper(s) FROM rb")
        assert SCHEMA[pkg].GLOBAL_DICT.epoch > epoch, pkg
        rows("SELECT s FROM rbv")  # the view survived the rebuild
        c.execute("INSERT INTO rb VALUES ('rbzb')")
        rows("SELECT s FROM rbv")  # and still maintains
        # A literal in a squeezed gap: planning runs it dry, and the
        # coordinator rebalances and replans.
        epoch = SCHEMA[pkg].GLOBAL_DICT.epoch
        _squeeze_where(pkg, "rbzq", "rbzr")
        rows("SELECT s FROM rbv WHERE s < 'rbzqa'")
        assert SCHEMA[pkg].GLOBAL_DICT.epoch > epoch, pkg
        rows("SELECT s FROM rbv")
        return out
    finally:
        cl.shutdown()


def test_exhaustion_during_query_recovers_end_to_end(tmp_path):
    got = {pkg: _exhaustion_scenario(pkg, str(tmp_path / pkg)) for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"] == [
        [("rbza",), ("rbzc",)], [("RBZA",), ("RBZC",)], [("rbza",), ("rbzc",)],
        [("rbza",), ("rbzb",), ("rbzc",)], [("rbza",), ("rbzb",), ("rbzc",)],
        [("rbza",), ("rbzb",), ("rbzc",)],
    ]


def test_strings_slt_survives_polluted_dictionary(tmp_path):
    """The dense regime that once exhausted a gap under reverse()'s table
    build: catalog-JSON strings and their reverses, then all of
    ``strings.slt`` against the port's cluster."""
    from materialize_tpu.testing.slt import run_slt_file

    for i in range(400):
        s = json.dumps({"id": 1, "name": f"tbl{i:03d}",
                        "sql": f"create table tbl{i:03d} (x bigint not null)"},
                       sort_keys=True)
        tschema.GLOBAL_DICT.encode(s)
        tschema.GLOBAL_DICT.encode(s[::-1])
    cl = Cluster("port", str(tmp_path))
    try:
        path = os.path.join(os.path.dirname(__file__), "slt", "strings.slt")
        assert run_slt_file(path, cl.coordinator()) > 0
    finally:
        cl.shutdown()


def test_snapshot_survives_rebalance():
    out = {}
    for pkg in PKGS:
        d = _fresh(pkg, SEED_STRINGS)
        code_a = d.encode("snapcoh-a")
        snap = d.snapshot()
        assert snap.decode(code_a) == "snapcoh-a"
        remap = d.rebalance()
        new_a = remap[code_a]
        assert d.decode(new_a) == "snapcoh-a"
        assert snap.decode(code_a) == "snapcoh-a"
        assert snap.epoch == d.epoch - 1
        out[pkg] = (code_a, new_a)
    assert out["port"] == out["ref"]


def test_same_epoch_inserts_visible_to_snapshot():
    for pkg in PKGS:
        d = _fresh(pkg, SEED_STRINGS)
        snap = d.snapshot()
        c = d.encode("snapcoh-late-insert")
        assert snap.decode(c) == "snapcoh-late-insert"
        assert dict((s, k) for k, s in snap.items_sorted())["snapcoh-late-insert"] == c


def test_post_rebalance_inserts_invisible_to_snapshot():
    for pkg in PKGS:
        d = _fresh(pkg, SEED_STRINGS)
        snap = d.snapshot()
        d.rebalance()
        c = d.encode("snapcoh-after-rebalance")
        with pytest.raises(KeyError):
            snap.decode(c)
        for k, s in snap.items_sorted():
            assert snap.decode(k) == s
