"""Port parity for buffer provenance and donation verdicts
(``analysis/provenance.py``, the host half of ``analysis/donation.py``)
and the sharding report of a single device (``analysis/shard_prop.py``).

- An index view (a sum by key over a persist shard) with an
  ``IndexSource`` subscriber view, in both packages, with
  ``span_donation`` off and on: the publisher's ``safe``, ``requested``
  and ``wired`` verdicts (and the donatable parts) equal the
  reference's, before and after the subscriber attaches, and so do the
  provenance classes present. A leaf is a tensor's storage in the port
  (an array object in the reference), so the leaf counts are not
  compared. A fresh dataflow proves fully donatable in both.
- With ``buffer_sanitizer`` on, ``guard_read`` raises
  ``UseAfterDonateError`` naming the holder after a recorded donation:
  the subscriber's snapshot, a multiversion-history rewind and span
  operands.
- On a port cluster: EXPLAIN ANALYSIS has a well-formed donation and
  sharding line for every installed view, and ``mz_donation`` and
  ``mz_sharding`` rows have the reference's column types and agree with
  it (one formatter serves both surfaces).
"""

from __future__ import annotations

import pytest

from tests.test_torch_persist import Pkg, _feed, _updates
from tests.torch_serving import deadline, mod, one_torch_thread  # noqa: F401

PKGS = ("ref", "port")


def _views(p: Pkg, donation: str):
    """(publisher view, IndexSource, subscriber view) after 3 ticks."""
    cfg = mod(p.name, "utils.dyncfg").COMPUTE_CONFIGS
    cfg.update({"span_donation": donation})
    P = p.persist
    c = p.client()
    w = c.open_writer("kv", p.KV)
    for t, ups in enumerate([[(1, 10, 1), (2, 20, 1)], [(1, 5, 1)], [(2, 20, -1)]]):
        _feed(w, t, ups)
    pub = P.MaintainedView(c, p.dataflow(p.sum_by_k(), name="pub"),
                           {"kv": ("kv", p.KV)}, None)
    pub.run_until(3)
    before = pub.donation_info()
    isrc = P.IndexSource(pub, pub.df.out_schema)
    sub_expr = p.mir.Get("agg", pub.df.out_schema).filter([p.col(1).gte(p.col(1))])
    sub = P.MaintainedView(c, p.dataflow(sub_expr, name="sub"), {}, None,
                           index_sources={"agg": isrc})
    return pub, isrc, sub, w, before


def _verdict(v) -> tuple:
    return (v.safe, v.requested, v.donate_parts(), sorted(v.provenance))


@pytest.mark.parametrize("donation", ["off", "on"])
def test_index_view_verdicts_match_reference(donation):
    got, reasons = {}, []
    for name in PKGS:
        p = Pkg(name)
        donation_mod = mod(name, "analysis.donation")
        try:
            pub, isrc, sub, _w, before = _views(p, donation)
            after = donation_mod.view_verdict("pub", pub, requested=pub.donation_requested())
            fresh = donation_mod.dataflow_verdict("fresh", p.dataflow(p.sum_by_k()))
            got[name] = (
                {k: before[k] for k in ("safe", "requested", "wired")},
                _verdict(after), isrc.base_cloned, _verdict(fresh),
                sorted(mod(name, "analysis.provenance").scan_replica(
                    {"pub": pub, "sub": sub}).sharing.get("pub", ())),
            )
            reasons = after.reasons
        finally:
            mod(name, "utils.dyncfg").COMPUTE_CONFIGS.update({"span_donation": None})
    assert got["port"] == got["ref"]
    before, after, cloned, fresh, _sharing = got["port"]
    assert before["wired"] is False and fresh[0] is True
    # Requested donation clones the subscriber's base: the publisher
    # stays safe; without the request the subscriber aliases its output,
    # and the port's reasons name that holder.
    assert after[0] is (donation == "on") and cloned is (donation == "on")
    assert (not reasons) if donation == "on" else any(
        "pub/subscriber[0]/base" in r for r in reasons)


def test_guard_read_names_the_holder_after_a_recorded_donation():
    p = Pkg("port")
    donation = mod("port", "analysis.donation")
    cfg = mod("port", "utils.dyncfg").COMPUTE_CONFIGS
    cfg.update({"buffer_sanitizer": True})
    try:
        pub, isrc, _sub, w, _b = _views(p, "off")
        donation.LEDGER.clear()
        # Nothing donated: the guards pass.
        isrc.snapshot(pub.upper - 1)
        # A donation of the publisher's output spine, recorded as a
        # donated dispatch would: the subscriber's snapshot still holds
        # the base, an alias into it.
        donation.record_donated(pub.df.output, "pub.run_steps span")
        with pytest.raises(donation.UseAfterDonateError,
                           match=r"IndexSource\(subscriber of 'pub'\).*pub\.run_steps span"):
            isrc.snapshot(pub.upper - 1)
        # A multiversion-history entry recorded as donated.
        _feed(w, 3, [(3, 7, 1)])
        pub.run_until(4)
        t, entry = pub._history[-1]
        donation.record_donated(entry, "history test")
        ops = mod("port", "storage.persist.operators")
        with pytest.raises(donation.UseAfterDonateError, match="multiversion-history"):
            ops._hist_host(entry)
        # Span operands: a donated input batch re-dispatched.
        cols, nulls, time, diff = _updates([(9, 9, 1)], t=4)
        inputs = {"kv": mod("port", "repr.batch").Batch.from_numpy(
            p.KV, cols, time, diff, nulls=nulls, device="cpu")}
        donation.record_donated(inputs, "an earlier span")
        df = p.dataflow(p.sum_by_k(), name="spanop")
        with pytest.raises(donation.UseAfterDonateError, match="spanop.run_steps operands"):
            df.run_steps([inputs], defer_check=True, donate=True)
        assert donation.LEDGER.caught == 3
    finally:
        cfg.update({"buffer_sanitizer": None})
        donation.LEDGER.clear()


def test_explain_analysis_and_introspection_rows_are_well_formed(tmp_path):
    from tests.torch_serving import Cluster

    jintro = mod("ref", "coord.introspection").INTROSPECTION_SCHEMAS
    tintro = mod("port", "coord.introspection").INTROSPECTION_SCHEMAS
    for rel in ("mz_donation", "mz_sharding"):
        assert [(c.name, c.ctype.value) for c in tintro[rel].columns] == [
            (c.name, c.ctype.value) for c in jintro[rel].columns]
    cl = Cluster("port", str(tmp_path))
    try:
        c = cl.coordinator()
        c.execute("CREATE TABLE t (k bigint NOT NULL, s text)")
        c.execute("INSERT INTO t VALUES (1, 'a'), (1, 'b'), (2, 'c')")
        c.execute("CREATE MATERIALIZED VIEW fm AS SELECT k, string_agg(s, ',') AS f "
                  "FROM t GROUP BY k")
        c.execute("CREATE VIEW kv AS SELECT k, count(*) AS n FROM t GROUP BY k")
        c.execute("CREATE INDEX kvx ON kv (k)")
        assert sorted(c.execute("SELECT * FROM fm").rows) == [(1, "a,b"), (2, "c")]
        text = c.execute("EXPLAIN ANALYSIS SELECT * FROM fm").text
        lines = text.splitlines()
        assert lines[0] == "typecheck: ok (arity=2, types=[int64, string])"
        block = lines[lines.index("donation:") + 1: lines.index("sharding:")]
        shard = lines[lines.index("sharding:") + 1: lines.index("recovery:")]
        assert [ln.split("@")[0].strip() for ln in block] == ["fm", "kvx"]
        assert all("safe=true requested=false wired=false donated=[none] "
                   "provenance(span-carry-owned=" in ln for ln in block), block
        assert all("spmd=false workers=1 ingest=merge safe=true "
                   "comm(0 collective(s), 0 B)" in ln for ln in shard), shard
        don = {r[0]: r for r in c.execute("SELECT * FROM mz_donation").rows}
        sh = {r[0]: r for r in c.execute("SELECT * FROM mz_sharding").rows}
        for name in ("fm", "kvx"):
            assert don[name][1:6] == ("r0", 1, 0, 0, "none")
            assert don[name][6].startswith("span-carry-owned=")
            assert f"{name}@r0: safe=true" in text and don[name][6] in text
            assert sh[name][1:] == ("r0", 0, 1, "merge", 1, 0, 0, "")
    finally:
        cl.shutdown()
