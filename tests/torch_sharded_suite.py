"""The body of the sharded-dataflow parity tests, for one world size and
some cases of ``tests/torch_sharded_cases.py``: ``ops`` in
``test_torch_sharded.py`` (2 ranks) and ``test_torch_sharded_4.py`` (4),
``agg`` in ``test_torch_sharded{,_4}_letrec.py``, ``minmax`` and
``index`` in ``test_torch_sharded{,_4}_minmax.py``; split so that
``--dist loadfile`` spreads them over the test workers.

Each file spawns its gloo ranks once (a module fixture, joined under the
per-test deadline of ``tests/torch_serving.py``); every rank runs the
file's cases through the port's ``ShardedDataflow``. A second module fixture runs each case through the
reference's ``ShardedDataflow`` on a mesh of the same size (the suite's
8 virtual CPU devices) and through the port's single-device
``Dataflow``; each test holds one case's net peek after every tick
equal across the three, exactly. Beside the peeks: the sharding
reports' ingest mode and communication census against the reference's.
"""

from __future__ import annotations

import pytest

from tests import torch_sharded_cases as C
from tests.torch_serving import DEADLINE_S, _arm, _disarm


def _reference(name: str, world: int) -> dict:
    from materialize_tpu.parallel.mesh import make_mesh
    from materialize_tpu.render.dataflow import ShardedDataflow

    make, kw, ticks = C.CASES[name]
    sdf = ShardedDataflow(make("ref"), make_mesh(world), name=name, **kw)
    peeks = []
    for t, tick in enumerate(ticks(world)):
        sdf.step(C.batches("ref", tick, t, inputs=C.INPUTS[name]))
        peeks.append(C.net(sdf.peek()))
    return {"peeks": peeks, "errors": sdf.peek_errors(), "report": sdf.sharding_report()}


def _single_device(name: str, world: int) -> list:
    from materialize_tpu_torch.render.dataflow import Dataflow

    make, kw, ticks = C.CASES[name]
    kw = {k: v for k, v in kw.items() if k != "output_cap"}
    df = Dataflow(make("port"), device="cpu", **kw)
    peeks = []
    for t, tick in enumerate(ticks(world)):
        df.step(C.batches("port", tick, t, device="cpu", inputs=C.INPUTS[name]))
        peeks.append(C.net(df.peek()))
    return peeks


def _letrec_census(ref: dict, evals: int) -> dict:
    """The census the port's last ``agg`` step issues, from the
    reference's. The reference counts its step program: the outer join
    and reduce (3 exchanges), the LetRec value traced twice (the first
    evaluation and the loop body, 3 exchanges each), the step's flags
    and the loop condition's pending count (one ``psum`` each). The
    port counts what ran: the first evaluation's 3 exchanges, 2 for
    each later one (the edges side of the recursive join is quiet and
    skips its exchange), and one pending count per check, ``evals`` of
    them. Every exchange moves the same 5 fields."""
    per_a2a = ref["kinds"]["all_to_all"] // 9
    assert per_a2a * 9 == ref["kinds"]["all_to_all"]
    exchanges = 6 + 2 * (evals - 1)
    return {
        "all_to_all": exchanges * per_a2a,
        "psum": exchanges + 1 + evals,
    }


def make_suite(world: int, names: tuple) -> dict:
    """The module fixtures and the tests of one world size over the
    cases ``names``, by name, for the test file's globals."""

    @pytest.fixture(scope="module")
    def port_runs():
        from materialize_tpu_torch.parallel.multihost import spawn_workers

        old = _arm(f"spawn {world} ranks")
        try:
            runs = spawn_workers(C.run_port_rank, world, device="cpu",
                                 args=(names,), timeout=DEADLINE_S - 10)
        finally:
            _disarm(old)
        # Every read is gathered: every rank returns the same answers.
        for r in runs[1:]:
            for name in names:
                assert r[name]["peeks"] == runs[0][name]["peeks"]
        return runs[0]

    @pytest.fixture(scope="module")
    def reference_runs():
        """Each case through the reference's ``ShardedDataflow`` and the
        port's single-device ``Dataflow``, once for the module: the
        reference's step programs compile for tens of seconds on a cold
        cache, which is compute, not a hang, so it runs outside the
        per-test deadline (the ranks above run under it)."""
        return {name: (_reference(name, world), _single_device(name, world))
                for name in names}

    @pytest.mark.parametrize("name", names)
    def test_peeks_equal_reference_and_single_device(name, port_runs, reference_runs):
        """The port's sharded peeks after every tick equal the
        reference's sharded ones and the port's single-device ones; the
        MIN/MAX case replays a tick after an exchange slot overflow."""
        got = port_runs[name]
        ref, single = reference_runs[name]
        assert got["peeks"] == ref["peeks"]
        assert got["peeks"] == single
        assert got["errors"] == ref["errors"] == []
        if name == "minmax":
            assert ("x", 0) in got["grown"]
        rep, ref_rep = got["report"], ref["report"]
        assert rep["ingest_mode"] == ref_rep["ingest_mode"]
        assert {k: rep[k] for k in ("spmd", "workers", "axis", "safe", "error")} == {
            k: ref_rep[k] for k in ("spmd", "workers", "axis", "safe", "error")}
        if name == "agg":
            # The LetRec census is a recorded deviation (ROADMAP): the
            # port counts the evaluations that ran.
            want = _letrec_census(ref_rep["census"], got["letrec_evals"])
            assert rep["census"]["kinds"] == want
        else:
            assert rep["census"] == ref_rep["census"]

    def test_constant_emits_once(port_runs):
        """The Constant under a Reduce emits its rows once, on rank 0:
        its sums are the literal rows' (1: 30, 2: 5) at every tick."""
        for peek in port_runs["ops"]["peeks"]:
            assert [r[1:3] for r in peek if r[0] == 7] == [(1, 30), (2, 5)]

    def test_index_cursors_are_shard_local(port_runs):
        """The index's slot-ring cursor reports shard-local."""
        cur = port_runs["index"]["report"]["cursors"]
        assert [c["leaf"] for c in cur] == ["output.cursor"]
        assert all(c["safe"] and c["class"] == "shard-local" for c in cur)

    out = {
        "port_runs": port_runs,
        "reference_runs": reference_runs,
        "test_peeks_equal_reference_and_single_device":
            test_peeks_equal_reference_and_single_device,
    }
    if "ops" in names:
        out["test_constant_emits_once"] = test_constant_emits_once
    if "index" in names:
        out["test_index_cursors_are_shard_local"] = test_index_cursors_are_shard_local
    return out
