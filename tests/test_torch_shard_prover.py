"""The port's SPMD prover over recorded steps (``analysis/shard_prop.py``:
``comm_census``, ``spmd_safety``, ``sharded_step_report``) on 2 gloo
ranks, against the reference's prover over its step program on a
2-device mesh: a SUM by key whose output index runs a slot ring, so
that the step exchanges and carries a cursor. The report's census (collectives, bytes,
kinds) and every cursor's verdict equal the reference's, the census
equals the one the last real step logged, and the recording leaves the
dataflow as it was. A rank made to issue an extra ``psum`` refutes every
verdict, naming the collective where the ranks part.

The rank function lives here, and this module imports no JAX at its
top: the spawned ranks import it and load the port only.
"""

from __future__ import annotations

import pytest

from tests import torch_sharded_cases as C
from tests.torch_serving import DEADLINE_S, _arm, _disarm, deadline, one_torch_thread  # noqa: F401

WORLD = 2
KW = C.INDEX_KW  # state tier 2^14 and 8 output slots


def sum_expr(pkg: str):
    rel, sc = C._m(pkg, "expr.relation"), C._m(pkg, "expr.scalar")
    A, F = rel.AggregateExpr, rel.AggregateFunc
    return rel.Get("idx", C.schemas(pkg)["idx"]).reduce((0,), (A(F.SUM_INT, sc.col(1)),))


def prover_rank(mesh) -> dict:
    """One rank: the ticks, the report, then the report again with rank 1
    issuing one psum more inside its recorded step (rank 0 issues the
    matching one after its recording, so that neither waits)."""
    import torch

    torch.set_num_threads(1)
    from materialize_tpu_torch.analysis import shard_prop, step_lint
    from materialize_tpu_torch.render.dataflow import ShardedDataflow

    sdf = ShardedDataflow(sum_expr("port"), mesh, name="prover", **KW)
    for t, tick in enumerate(C.index_ticks()):
        sdf.step(C.batches("port", tick, t, device="cpu", inputs=("idx",)))
    logged = shard_prop.census_of(sdf._census)
    time0, peek0 = sdf.time, C.net(sdf.peek())
    report = shard_prop.sharded_step_report(sdf)
    after = {"time": sdf.time, "peek": C.net(sdf.peek()),
             "logged": shard_prop.census_of(sdf._census)}
    extra = torch.zeros(1, dtype=torch.int32)
    if mesh.rank == 1:
        core = sdf._step_core

        def one_more(*a, **k):
            out = core(*a, **k)
            mesh.psum(extra)
            return out

        sdf._step_core = one_more
    else:
        record = step_lint.record_step

        def then_psum(*a, **k):
            out = record(*a, **k)
            mesh.psum(extra)
            return out

        step_lint.record_step = then_psum
    refuted = shard_prop.sharded_step_report(sdf)
    return {"report": report, "logged": logged, "before": {"time": time0, "peek": peek0,
            "logged": logged}, "after": after, "refuted": refuted}


@pytest.fixture(scope="module")
def runs():
    from materialize_tpu_torch.parallel.multihost import spawn_workers

    old = _arm(f"spawn {WORLD} ranks")
    try:
        return spawn_workers(prover_rank, WORLD, device="cpu", timeout=DEADLINE_S - 10)
    finally:
        _disarm(old)


@pytest.fixture(scope="module")
def reference():
    """The reference's prover report of the same dataflow and ticks (its
    step program compiles once for the module, outside the deadline)."""
    from materialize_tpu.parallel.mesh import make_mesh
    from materialize_tpu.render.dataflow import ShardedDataflow

    sdf = ShardedDataflow(sum_expr("ref"), make_mesh(WORLD), name="prover", **KW)
    for t, tick in enumerate(C.index_ticks()):
        sdf.step(C.batches("ref", tick, t, inputs=("idx",)))
    return sdf.sharding_report()


def test_census_and_verdicts_equal_the_reference(runs, reference):
    for r in runs:
        rep = r["report"]
        assert rep["census"] == reference["census"]
        assert rep["census"] == r["logged"]
        assert rep["cursors"] == reference["cursors"]
        assert [c["leaf"] for c in rep["cursors"]] == ["output.cursor"]
        assert all(c["class"] == "shard-local" for c in rep["cursors"])
        keys = ("spmd", "workers", "axis", "ingest_mode", "safe", "error")
        assert {k: rep[k] for k in keys} == {k: reference[k] for k in keys}
        assert rep["safe"] and rep["error"] is None


def test_recording_leaves_the_dataflow_as_it_was(runs):
    for r in runs:
        assert r["after"] == r["before"]
    assert runs[0]["after"]["peek"] == runs[1]["after"]["peek"]


def test_an_extra_psum_on_one_rank_refutes_every_verdict(runs):
    for r in runs:
        rep = r["refuted"]
        assert not rep["safe"]
        n = rep["census"]["collectives"]
        assert n == r["report"]["census"]["collectives"]  # rank 0's census
        for cur in rep["cursors"]:
            assert not cur["safe"] and cur["class"] == "cross-worker"
            [blame] = cur["blame"]
            assert f"rank 0: collective #{n} none" in blame
            assert f"rank 1: collective #{n} psum[(1,)]" in blame
