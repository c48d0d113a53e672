"""The interleaving explorer (``materialize_tpu_torch/analysis/interleave.py``)
against the reference's (``materialize_tpu/analysis/interleave.py``).

- Every model of ``MODELS``, and each unsafe variant, explored by both
  packages: the same verdict, state-space counts, violation kinds,
  minimised traces and the same wall-clock fault plan from
  ``Violation.to_trace()`` through each package's chaos harness.
- The port's versions of ``tests/test_interleave.py``'s cases: the
  real ``hard_close`` is wedge-free, the bare close wedges in one step,
  the unlocked hub double-drops; each model runs the port's own
  control-plane code.
- A trace of the port's explorer replays through the port's
  ``run_chaos(replay_trace=)`` on the CPU.
"""

from __future__ import annotations

import json

import pytest

from tests.torch_serving import deadline, mod, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.analysis

# (model, constructor kwargs, crash branching): every registered model
# as the registry builds it, then each unsafe variant.
CASES = [
    ("fencing", {}, True),
    ("set-crash-window", {}, True),
    ("set-crash-window", {"retract_first": True}, True),
    ("close-wedge", {}, False),
    ("close-wedge", {"hard_close": False}, False),
    ("reconcile", {}, True),
    ("peek-batcher", {}, False),
    ("subscribe-drop", {}, False),
    ("subscribe-drop", {"locked": False}, False),
    ("replica-drain-peek", {}, False),
    ("replica-drain-peek", {"dedup": False}, False),
    ("autoscale-band", {}, False),
    ("autoscale-band", {"action": "drain", "first": "autoscaler"}, False),
    ("autoscale-band", {"locked": False, "action": "spawn"}, False),
    ("autoscale-band", {"locked": False, "action": "drain"}, False),
    ("compactor-lease-swap", {}, True),
    ("compactor-lease-swap", {"delete_before_swap": True}, True),
]

UNSAFE = {"retract_first": True, "hard_close": False, "locked": False,
          "dedup": False, "delete_before_swap": True}


def explore(pkg: str, name: str, kw: dict, crash: bool):
    il = mod(pkg, "analysis.interleave")
    return il.explore(lambda: il.MODELS[name](**kw), crash=crash)


def test_cases_cover_every_model():
    port = mod("port", "analysis.interleave")
    ref = mod("ref", "analysis.interleave")
    assert list(port.MODELS) == list(ref.MODELS)
    assert {n for n, _kw, _c in CASES} == set(port.MODELS)


@pytest.mark.parametrize(
    "name,kw,crash", CASES,
    ids=[f"{n}-{','.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"
         for n, kw, _c in CASES])
def test_port_explorer_matches_the_reference(name, kw, crash):
    ref = explore("ref", name, kw, crash)
    port = explore("port", name, kw, crash)
    unsafe = any(UNSAFE.get(k) == v for k, v in kw.items())
    assert port.ok == ref.ok == (not unsafe), port.summary()
    assert not port.truncated
    counts = ("schedules", "terminals", "crash_branches", "steps")
    assert ({c: getattr(port, c) for c in counts}
            == {c: getattr(ref, c) for c in counts})
    assert [v.kind for v in port.violations] == [v.kind for v in ref.violations]
    assert ([len(v.schedule) for v in port.violations]
            == [len(v.schedule) for v in ref.violations])
    traces = [json.loads(json.dumps(v.to_trace())) for v in port.violations]
    assert traces == [v.to_trace() for v in ref.violations]
    ref_chaos, port_chaos = mod("ref", "testing.chaos"), mod("port", "testing.chaos")
    for trace in traces:
        assert port_chaos.trace_seed(trace) == ref_chaos.trace_seed(trace)
        assert (port_chaos.fault_plan_from_trace(trace, 60)
                == ref_chaos.fault_plan_from_trace(trace, 60))


def test_models_run_the_ports_own_code():
    from materialize_tpu_torch.analysis import interleave
    from materialize_tpu_torch.coord.controller import _NonceSource
    from materialize_tpu_torch.storage.persist import PersistClient

    assert isinstance(interleave.FencingModel().src, _NonceSource)
    m = interleave.CompactorLeaseSwapModel()
    assert isinstance(m.client, PersistClient)
    assert type(m.machine).__module__.startswith("materialize_tpu_torch.")
    assert interleave.registry_objects() == mod("port", "utils.lockcheck").registered_names()


def test_hard_close_is_wedge_free():
    from materialize_tpu_torch.analysis.interleave import WedgeModel, explore

    res = explore(lambda: WedgeModel(hard_close=True), crash=False)
    assert res.ok, "\n".join(v.format() for v in res.violations)


def test_bare_close_wedges_with_minimal_trace():
    from materialize_tpu_torch.analysis.interleave import WedgeModel, explore

    res = explore(lambda: WedgeModel(hard_close=False), crash=False)
    assert not res.ok
    v = res.violations[0]
    assert v.kind == "wedge"
    assert len(v.schedule) == 1, v.format()
    assert "reader" in v.message


def test_unlocked_hub_double_drops():
    from materialize_tpu_torch.analysis.interleave import HubModel, explore

    assert explore(lambda: HubModel(locked=True), crash=False).ok
    res = explore(lambda: HubModel(locked=False), crash=False)
    assert not res.ok
    assert any("drop" in v.message for v in res.violations)


def test_crash_trace_marks_its_crash_point():
    from materialize_tpu_torch.analysis.interleave import SetCrashModel, explore

    res = explore(lambda: SetCrashModel(retract_first=True))
    v = next(v for v in res.violations if v.kind == "crash")
    assert v.crash_after is not None
    assert "CRASH HERE" in v.format()


def test_port_trace_replays_through_run_chaos(tmp_path):
    """A crash trace of the port's explorer pins the port's storm: its
    seed and its fault plan (the crash point lands as ``kill_conns``),
    and ``run_chaos(replay_trace=)`` runs that storm to a clean verify."""
    from materialize_tpu_torch.analysis.interleave import SetCrashModel, explore
    from materialize_tpu_torch.testing import chaos

    res = explore(lambda: SetCrashModel(retract_first=True))
    trace = json.loads(json.dumps(
        next(v for v in res.violations if v.kind == "crash").to_trace()))
    ticks = 12
    plan = chaos.fault_plan_from_trace(trace, ticks)
    actions = [a for acts in plan.values() for a in acts]
    assert "kill_conns" in actions
    rep = chaos.run_chaos(str(tmp_path / "replay"), seed=0, ticks=ticks,
                          replay_trace=trace, device="cpu")
    assert rep.ok, rep.failures
    assert rep.conn_kills >= 1
