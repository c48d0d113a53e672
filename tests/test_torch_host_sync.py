"""The host-sync linter (``materialize_tpu_torch/analysis/host_sync.py``).

- The reference's seeded-hazard fixture, rewritten for torch, is
  flagged once a hazard, and its pragmas are honoured; the port's other
  hazards (``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()`` of a
  tensor, ``.to(<device>)``, ``.cuda()``, a host scalar stored into a
  tensor) are flagged, and their look-alikes are not.
- The hot path's findings equal the pinned list of the port's known
  sync debt: (file, function, construct), each as often as it occurs. A
  new sync fails here; the change that removes one shortens the list.
- The record half: the index's and Q1's steps hold no host read, in both
  packages.
"""

from __future__ import annotations

import importlib.util
import textwrap
from collections import Counter

import numpy as np
import pytest

from tests.torch_serving import deadline, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.analysis

_BAD_FIXTURE = textwrap.dedent(
    """
    import numpy as np
    import torch

    def bad_hot_fn(x, dev):
        h = np.asarray(x)
        n = x.count.item()
        torch.cuda.synchronize()
        y = torch.tensor(h, device=dev)
        return n

    def sanctioned_fn(x, dev):
        ok = np.asarray(x)  # host-sync: ok(test boundary)
        up = torch.tensor(ok, device=dev)  # h2d: staging upload
        return ok, up

    def port_hazards(x, dev, host):
        a = x.tolist()
        b = x.cpu()
        c = b.numpy()
        n = int(x.count)
        y = host.to(dev)
        z = host.cuda()
        x.flags[-1] = True
        return a, c, n, y, z

    def look_alikes(x, n, table):
        y = x.to(torch.int32)
        table["k"] = 0
        m = int(n)
        return y, m
    """
)


@pytest.fixture
def fixture_module(tmp_path):
    p = tmp_path / "hs_torch_fixture.py"
    p.write_text(_BAD_FIXTURE)
    spec = importlib.util.spec_from_file_location("hs_torch_fixture", p)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_seeded_hazards_are_flagged(fixture_module):
    from materialize_tpu_torch.analysis.host_sync import HOST_SYNC, lint_function

    bad = lint_function(fixture_module.bad_hot_fn)
    assert len(bad) == 4
    assert all(f.lint_id == HOST_SYNC for f in bad)
    assert [f.construct for f in bad] == [
        "`np.asarray`", "`.item()`", "`.synchronize()`", "`torch.tensor(device=)`"]
    assert [int(f.site.rsplit(":", 1)[1]) for f in bad] == [6, 7, 8, 9]
    assert lint_function(fixture_module.sanctioned_fn) == []


def test_port_hazards_are_flagged(fixture_module):
    from materialize_tpu_torch.analysis.host_sync import lint_function

    got = [f.construct for f in lint_function(fixture_module.port_hazards)]
    assert got == ["`.tolist()`", "`.cpu()`", "`.numpy()`", "`int()`",
                   "`.to(<device>)`", "`.cuda()`", "`t[...] = <scalar>`"]
    assert lint_function(fixture_module.look_alikes) == []


# The port's known sync debt on the hot path: (file, function, construct)
# -> occurrences. ``np.asarray`` is flagged as in the reference, whatever
# its argument holds.
KNOWN_DEBT = {
    ("materialize_tpu_torch/repr/batch.py", "Batch.from_numpy", "`np.asarray`"): 2,
    ("materialize_tpu_torch/repr/batch.py", "Batch.from_numpy", "`.to(<device>)`"): 1,
    ("materialize_tpu_torch/repr/batch.py", "Batch.from_numpy", "`torch.tensor(device=)`"): 1,
    ("materialize_tpu_torch/repr/batch.py", "Batch.to_columns", "`int()`"): 1,
    ("materialize_tpu_torch/repr/batch.py", "Batch.to_columns", "`.cpu()`"): 3,
    ("materialize_tpu_torch/repr/batch.py", "Batch.to_columns", "`.numpy()`"): 3,
    ("materialize_tpu_torch/render/dataflow.py", "Dataflow.output_records", "`.item()`"): 1,
    ("materialize_tpu_torch/storage/persist/operators.py", "MaintainedView._append",
     "`.cpu()`"): 1,
    ("materialize_tpu_torch/storage/persist/operators.py", "MaintainedView._append",
     "`.numpy()`"): 1,
    ("materialize_tpu_torch/storage/persist/operators.py", "MaintainedView._append",
     "`np.asarray`"): 1,
    ("materialize_tpu_torch/ops/consolidate.py", "_segment_totals",
     "`t[...] = <scalar>`"): 1,
    ("materialize_tpu_torch/ops/sort.py", "concat_batches", "`torch.tensor(device=)`"): 1,
}


def test_hot_path_findings_equal_the_known_debt():
    from materialize_tpu_torch.analysis.host_sync import debt_key, lint_hot_path

    findings = lint_hot_path()
    assert Counter(debt_key(f) for f in findings) == Counter(KNOWN_DEBT), "\n".join(
        f"{f.site} {f.where} {f.construct}" for f in findings)
    # Every finding names its line as the card's sync probe names it.
    for f in findings:
        path, line = f.site.rsplit(":", 1)
        assert f.where.endswith(f":{line}") and path.startswith("materialize_tpu_torch/")


def test_registry_resolves_and_maps_the_reference():
    """Every registered function exists; the reference's hot path and
    recorder path map onto the port's names (the functions the module
    says have no counterpart excepted)."""
    from materialize_tpu.analysis import host_sync as ref
    from materialize_tpu_torch.analysis import host_sync as port

    for module, qualname in port.DEFAULT_HOT_PATH:
        assert callable(port._resolve(module, qualname)), qualname
    mapped = {"_DataflowBase._dispatch_span": "Dataflow._dispatch",
              "_DataflowBase._dispatch_compact": "Dataflow._compact",
              "_DataflowBase._pack_flags": "Dataflow._step_core",
              "_DataflowBase._or_acc": "Dataflow._or"}
    none = {"_DataflowBase._stack_packed", "LedgeredJit.__call__", "tier_vector"}
    port_names = {q for _m, q in port.DEFAULT_HOT_PATH}
    for _module, qualname in ref.DEFAULT_HOT_PATH:
        if qualname in none:
            continue
        want = mapped.get(qualname, qualname.replace("_DataflowBase.", "Dataflow."))
        assert want in port_names, qualname


def test_boundary_readbacks_carry_the_pragma():
    """The span's one flags readback (and the step's, in the reference's
    ``_read_flags`` place) are the only sanctioned syncs."""
    import inspect

    from materialize_tpu_torch.analysis.host_sync import lint_function
    from materialize_tpu_torch.render.dataflow import Dataflow

    for fn in (Dataflow.read_flags_snapshot, Dataflow._read_flags):
        assert lint_function(fn) == []
        assert "# host-sync: ok(" in inspect.getsource(fn)


def test_index_and_q1_steps_hold_no_host_read():
    """The record half, in both packages: the reference's index step
    program carries no callback, and neither the port's index nor its
    Q1 step reads anything back on the CPU (the flags readback is the
    sanctioned boundary)."""
    from materialize_tpu.analysis import host_sync_findings_dataflow as ref_findings
    from materialize_tpu.expr import relation as rmir
    from materialize_tpu.render.dataflow import Dataflow as RefDataflow
    from materialize_tpu.storage.generator.tpch import LINEITEM_SCHEMA as REF_LINEITEM
    from materialize_tpu_torch.analysis.host_sync import host_sync_findings_dataflow
    from materialize_tpu_torch.expr import relation as mir
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA, TpchGenerator
    from materialize_tpu_torch.workloads.tpch import q1_plan

    assert ref_findings(RefDataflow(rmir.Get("lineitem", REF_LINEITEM), name="index",
                                    out_levels=4, out_slots=4)) == []
    gen = TpchGenerator(sf=0.002)
    index = Dataflow(mir.Get("lineitem", LINEITEM_SCHEMA), name="index", out_levels=4,
                     out_slots=8, device="cpu")
    q1 = Dataflow(q1_plan(), name="q1", device="cpu")
    for t, df in enumerate((index, q1)):
        tick = {"lineitem": gen.churn_lineitem_batch(8, t + 1, 0, device="cpu")}
        assert host_sync_findings_dataflow(df, tick) == []
    assert np.asarray(index.output_records()) > 0
