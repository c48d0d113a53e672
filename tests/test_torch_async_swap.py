"""Async install and hot swap (``compile/worker.py`` and the replica's
swap), the reference's ``TestAsyncCompileHotSwap`` scenario run in both
packages: with ``SET program_bank_path`` and ``SET enable_async_compile
= true``, a fresh materialized view serves ``[(1, 10), (2, 20)]`` at
once in its generic layout, reaches ``swapped``, and after ``INSERT (1,
5), (3, 7)`` both packages answer ``[(1, 15), (2, 20), (3, 7)]``, with
``('swmv', 'swapped')`` in ``mz_program_bank``. In the port alone: with
``arrangement_ingest_mode = 'append_slot'`` the generic layout has no
slot ring and the swapped one has the synchronous build's; a warm-up
that raises leaves ``swap-failed`` and the generic view exact.
"""

from __future__ import annotations

import time as _time

from tests.torch_serving import Cluster, deadline, mod, one_torch_thread  # noqa: F401

WANT_FIRST = [(1, 10), (2, 20)]
WANT_AFTER = [(1, 15), (2, 20), (3, 7)]


def _poll(fn, timeout: float = 90.0, every: float = 0.05):
    t_end = _time.monotonic() + timeout
    while _time.monotonic() < t_end:
        v = fn()
        if v:
            return v
        _time.sleep(every)
    raise AssertionError(f"condition never became true: {fn}")


def _swap_state(c):
    entry = c.controller.swap_states.get("swmv", {}).get("r0", {})
    return entry.get("state") in ("swapped", "swap-failed") and entry


def _scenario(pkg: str, root: str, settings=(), on_generic=None) -> dict:
    """The reference's scenario on one package's cluster; ``on_generic``
    sees the replica worker before the swap lands."""
    cl = Cluster(pkg, root)
    try:
        c = cl.coordinator()
        c.execute(f"SET program_bank_path = '{root}/bank'")
        c.execute("SET enable_async_compile = true")
        for sql in settings:
            c.execute(sql)
        c.execute("CREATE TABLE swt (k BIGINT NOT NULL, v BIGINT NOT NULL)")
        c.execute("INSERT INTO swt VALUES (1, 10), (2, 20)")
        c.execute("CREATE MATERIALIZED VIEW swmv AS SELECT k, sum(v) FROM swt GROUP BY k")
        out = {"first": sorted(c.execute("SELECT * FROM swmv").rows)}
        if on_generic is not None:
            out["generic"] = on_generic(cl._handle[0])
        out["entry"] = _poll(lambda: _swap_state(c))
        c.execute("INSERT INTO swt VALUES (1, 5), (3, 7)")
        out["after"] = sorted(c.execute("SELECT * FROM swmv").rows)
        out["bank"] = c.execute(
            "SELECT dataflow, state FROM mz_program_bank WHERE kind = 'swap'").rows
        out["worker"] = cl._handle[0]
        return out
    finally:
        cl.shutdown()
        mod(pkg, "utils.dyncfg").COMPUTE_CONFIGS.update(
            {"enable_async_compile": None, "program_bank_path": None,
             "arrangement_ingest_mode": None})
        mod(pkg, "compile.bank").configure_bank(None)


def test_fresh_ddl_serves_generic_then_swaps_in_both_packages(tmp_path):
    got = {pkg: _scenario(pkg, str(tmp_path / pkg)) for pkg in ("ref", "port")}
    for pkg, out in got.items():
        assert out["first"] == WANT_FIRST, pkg
        assert out["entry"]["state"] == "swapped", (pkg, out["entry"])
        assert out["after"] == WANT_AFTER, pkg
        assert ("swmv", "swapped") in out["bank"], pkg
    entry = got["port"]["entry"]
    assert entry["rebuild_s"] > 0 and entry["warm_s"] > 0
    assert not got["port"]["worker"].dataflows["swmv"].view.df.force_merge_ingest


def _layout(worker):
    df = worker.dataflows["swmv"].view.df
    return df.force_merge_ingest, len(df.output.slots)


def test_swap_takes_the_synchronous_build_layout(tmp_path):
    """With slot-ring ingest forced, the generic layout merges and the
    swapped one carries the synchronous build's ring."""
    out = _scenario("port", str(tmp_path),
                    settings=("SET arrangement_ingest_mode = 'append_slot'",),
                    on_generic=_layout)
    assert out["generic"] == (True, 0)
    assert out["entry"]["state"] == "swapped"
    assert out["after"] == WANT_AFTER
    forced, slots = _layout(out["worker"])
    assert not forced and slots > 0


def test_a_warm_up_that_raises_leaves_the_generic_view_serving(tmp_path, monkeypatch):
    def boom(desc, device):
        raise RuntimeError("warm-up refused")

    monkeypatch.setattr(mod("port", "compile.worker"), "warm_programs", boom)
    out = _scenario("port", str(tmp_path))
    assert out["first"] == WANT_FIRST
    assert out["entry"]["state"] == "swap-failed"
    assert "warm-up refused" in out["entry"]["error"]
    assert out["after"] == WANT_AFTER
    assert ("swmv", "swap-failed") in out["bank"]
    assert _layout(out["worker"]) == (True, 0)
