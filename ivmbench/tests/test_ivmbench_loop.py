"""The harness's loop against its reference on the CPU, at a tiny size:
a sound run is correct, each control is not, and a run whose timed path
is broken underneath comes out not correct. The look for a card is the
command's (``run.py``); these call the loop with ``device="cpu"``."""

import time
import types

import numpy as np
import pytest
import torch

from ivmbench import loop, manifest
from ivmbench.tests import tiny

SEED = 2**31 + 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, device="cpu", seconds=4.0):
    cell = tiny.cell(name)
    rec, out, handed, _ = loop.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                                        device=device)
    return cell, rec, out, handed


@pytest.fixture(scope="module", params=tiny.CELLS)
def sound(request):
    return _run(request.param)


def test_sound_run_is_correct(sound):
    cell, rec, out, handed = sound
    checks = loop.judge(cell, out, handed)
    assert loop.correct(checks), str(checks)
    assert rec.ticks == handed.ticks - handed.span_ticks and len(rec.committed()) >= 2
    assert {c for c in checks} == set(loop.CHECKS)
    for m in manifest.metrics_for(manifest.load(), cell.name, False):
        assert manifest.reader(m["name"])(rec) > 0


def _paced(w):
    """An open loop as a later traffic kind would bring it: a span due
    every 0.2 s, ready at its due time, handed no earlier."""
    due = 0.0
    while due < w.seconds:
        while w.elapsed() < due:
            time.sleep(0.005)
        sp, inputs = w.ingest_span()
        sp.ready = due
        w.submit(sp, inputs)
        due += 0.2


def test_a_kind_of_loop_is_its_module():
    cell = tiny.cell(tiny.CELLS[0])
    cell.loop = types.SimpleNamespace(window=_paced)
    rec, out, handed, _ = loop.run_cell(cell, SEED + 1, 1.0, False, time.perf_counter(),
                                        device="cpu")
    assert loop.correct(loop.judge(cell, out, handed))
    assert [sp.ready for sp in rec.spans] == pytest.approx([0.2 * i for i in range(5)])
    assert all(sp.handed >= sp.ready for sp in rec.spans)


@pytest.mark.parametrize("control", ["duplicate_tick", "stale_read"])
def test_control_is_not_correct(sound, control):
    cell, _, out, handed = sound
    checks = loop.judge(cell, out, handed, control=control)
    assert not loop.correct(checks)
    assert checks["rows_off"]["value"] > 0


def _state_unchanged(monkeypatch):
    from materialize_tpu_torch.render.dataflow import Dataflow

    core = Dataflow._step_core

    def step(self, states, output, err_output, inputs):
        out, _, _, _, flags = core(self, states, output, err_output, inputs)
        return out, list(states), output, err_output, flags

    monkeypatch.setattr(Dataflow, "_step_core", step)


def _half_batch(monkeypatch):
    from materialize_tpu_torch.storage.persist import operators

    ingest = operators.updates_to_batch

    def half(schema, cols, nulls, time, diff, as_of, capacity=None, device=None):
        n = len(diff) // 2
        return ingest(schema, [c[:n] for c in cols], nulls, time, diff[:n], as_of,
                      capacity=capacity, device=device)

    monkeypatch.setattr(operators, "updates_to_batch", half)


def _answer_altered(monkeypatch):
    from materialize_tpu_torch.coord import peek
    from materialize_tpu_torch.render.dataflow import Dataflow

    scan, read = peek.scan_arrays, Dataflow.peek

    def scan_altered(df):
        cols, nulls, time, diff = scan(df)
        cols[4] = cols[4].copy()
        cols[4][np.flatnonzero(diff > 0)[0]] += 1
        return cols, nulls, time, diff

    def peek_altered(self):
        rows = read(self)
        rows[0] = (*rows[0][:2], rows[0][2] + 1, *rows[0][3:])
        return rows

    monkeypatch.setattr(peek, "scan_arrays", scan_altered)
    monkeypatch.setattr(Dataflow, "peek", peek_altered)


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    cell, _, out, handed = _run(name)
    checks = loop.judge(cell, out, handed)
    assert checks["spans_unchecked"]["value"] == 0
    assert checks["rows_off"]["value"] > 0 or checks["delta_rows_off"]["value"] > 0, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_on_the_card(card, name):
    cell, rec, out, handed = _run(name, device=card)
    assert loop.correct(loop.judge(cell, out, handed, device=card))
