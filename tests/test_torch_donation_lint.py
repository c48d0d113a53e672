"""The program-reading halves of the port's ``analysis/donation.py``
against the reference's: the reuse rule over the registered dispatch
sites (zero findings), the reference's seeded fixture
(``tests/test_donation.py``: bad, sanctioned, ok) through both packages'
``lint_donated_reuse_function`` with equal findings, and the write side
of one recorded step of the tiny ``Get`` dataflow: clean as rendered,
flagged once a step writes into its input batch or its rollback
checkpoint in place."""

from __future__ import annotations

import importlib.util
import textwrap

from tests.torch_serving import deadline, one_torch_thread  # noqa: F401

FIXTURE = """
def bad(self, jitfn, args):
    carry = jitfn(*args)
    snap = self.output  # the dead buffer!
    self.output = carry[1]
    return snap

def sanctioned(self, jitfn, args):
    carry = jitfn(*args)
    snap = self.output  # donated: ok(test boundary)
    self.output = carry[1]
    return snap

def ok(self, jitfn, args):
    carry = jitfn(*args)
    self.output = carry[1]
    return self.output
"""


def _fixture(tmp_path):
    p = tmp_path / "donated_fixture.py"
    p.write_text(textwrap.dedent(FIXTURE))
    spec = importlib.util.spec_from_file_location("donated_fixture", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_registered_dispatch_sites_lint_clean_and_map_the_reference():
    """Zero findings over the port's dispatch sites; the reference's
    sites map onto them, as the host-sync registry maps its hot path."""
    from materialize_tpu.analysis import donation as ref
    from materialize_tpu_torch.analysis import donation as port
    from materialize_tpu_torch.analysis.host_sync import _resolve

    findings = port.lint_donated_reuse()
    assert findings == [], "\n".join(str(f) for f in findings)
    sites = {q for _m, q in port.DONATED_DISPATCH_SITES}
    for module, qualname in port.DONATED_DISPATCH_SITES:
        assert callable(_resolve(module, qualname)), qualname
    mapped = {"_DataflowBase._dispatch_span": "Dataflow._dispatch",
              "_DataflowBase.run_span": "Dataflow.run_span"}
    for _module, qualname in ref.DONATED_DISPATCH_SITES:
        assert mapped[qualname] in sites
        assert "Sharded" + mapped[qualname] in sites
    assert port.CARRY_ATTRS == ref.CARRY_ATTRS
    assert set(ref._DISPATCH_NAMES) < set(port._DISPATCH_NAMES)


def test_seeded_fixture_gives_equal_findings(tmp_path):
    """The rule bites alike in both packages: one finding for ``bad``,
    none for the sanctioned read or the re-assigned carry."""
    from materialize_tpu.analysis import donation as ref
    from materialize_tpu_torch.analysis import donation as port

    mod = _fixture(tmp_path)
    for name in ("bad", "sanctioned", "ok"):
        fn = getattr(mod, name)
        got = [(f.lint_id, f.where, f.message)
               for f in port.lint_donated_reuse_function(fn, name)]
        want = [(f.lint_id, f.where, f.message)
                for f in ref.lint_donated_reuse_function(fn, name)]
        assert got == want, name
        assert len(got) == (1 if name == "bad" else 0), name
    bad = port.lint_donated_reuse_function(mod.bad, "bad")
    assert bad[0].lint_id == port.USE_AFTER_DONATE and "self.output" in bad[0].message


def test_recorded_step_writes_only_what_it_allocated():
    """The write-side check of the port and the reference's lowering
    check are both clean on their tiny ``Get`` dataflow."""
    from materialize_tpu.analysis.donation import donation_lowering_findings as ref_check
    from materialize_tpu_torch.analysis.donation import donation_lowering_findings

    assert donation_lowering_findings(device="cpu") == []
    assert ref_check() == []


def test_a_step_writing_in_place_into_its_input_or_checkpoint_is_flagged(monkeypatch):
    """A step monkeypatched to write into its input batch, then into the
    err arrangement it was handed (which the rollback checkpoint holds),
    is flagged at the writing operation."""
    from materialize_tpu_torch.analysis.donation import (
        UNSOUND_DONATION,
        donation_lowering_findings,
    )
    from materialize_tpu_torch.render.dataflow import Dataflow

    core = Dataflow._step_core

    def writes_input(self, states, output, err_output, inputs):
        inputs["src"].diff.mul_(1)
        return core(self, states, output, err_output, inputs)

    monkeypatch.setattr(Dataflow, "_step_core", writes_input)
    found = donation_lowering_findings(device="cpu")
    assert [f.lint_id for f in found] == [UNSOUND_DONATION]
    assert "aten.mul_.Tensor writes in place into inputs['src'].diff" in found[0].message
    assert found[0].where.startswith("step-writes/tests/test_torch_donation_lint.py:")

    def writes_checkpoint(self, states, output, err_output, inputs):
        err_output.batch.diff.add_(0)
        return core(self, states, output, err_output, inputs)

    monkeypatch.setattr(Dataflow, "_step_core", writes_checkpoint)
    found = donation_lowering_findings(device="cpu")
    assert len(found) == 1
    assert "writes in place into checkpoint[2].batch.diff" in found[0].message
