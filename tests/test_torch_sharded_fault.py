"""A fault of the reference's ``ShardedDataflow`` that the port does not
copy (ROADMAP Queue 3): in a Union of a SUM/COUNT Reduce and a MIN/MAX
Reduce by the same key over one input, the reference's sharded
dataflow loses part of the SUM/COUNT branch's output delta from the
second tick on (a group's old row retracted without its new row, or the
new row inserted without the old one's retraction), where its
single-device ``Dataflow`` is right. Each Reduce alone, or the
SUM/COUNT one beside the other operators, shards correctly
(``test_torch_sharded.py``). The port's ``ShardedDataflow`` on 2 gloo
ranks gives the single-device answer of both packages at every tick."""

import pytest

from tests import torch_sharded_cases as C
from tests.torch_serving import DEADLINE_S, deadline, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    """The plan through both packages in this process, once: the
    reference's sharded and single-device peeks and the port's
    single-device peeks after every tick. The reference's compiles are
    compute, not a hang: they run outside the per-test deadline."""
    from materialize_tpu.parallel.mesh import make_mesh
    from materialize_tpu.render.dataflow import Dataflow as JDataflow
    from materialize_tpu.render.dataflow import ShardedDataflow as JSharded
    from materialize_tpu_torch.render.dataflow import Dataflow

    make, _kw, ticks = C.FAULT
    jsharded = JSharded(make("ref"), make_mesh(2), name="fault")
    jsingle = JDataflow(make("ref"))
    single = Dataflow(make("port"), device="cpu")
    out = {"sharded": [], "single": [], "port": []}
    for t, tick in enumerate(ticks(2)):
        jb = C.batches("ref", tick, t, inputs=C.INPUTS["fault"])
        jsharded.step(jb)
        jsingle.step(jb)
        single.step(C.batches("port", tick, t, device="cpu", inputs=C.INPUTS["fault"]))
        out["sharded"].append(C.net(jsharded.peek()))
        out["single"].append(C.net(jsingle.peek()))
        out["port"].append(C.net(single.peek()))
    return out


def test_two_reduces_over_one_input(reference):
    from materialize_tpu_torch.parallel.multihost import spawn_workers

    runs = spawn_workers(C.run_port_rank, 2, device="cpu", args=(("fault",),),
                         timeout=DEADLINE_S - 10)
    want = reference["single"]
    assert reference["port"] == want
    for r in runs:
        assert r["fault"]["peeks"] == want
    assert [a != b for a, b in zip(reference["sharded"], want)] == [False, True, True]
