"""The reference's process-global string dictionary, given back.

Port test files run the reference (``materialize_tpu``) beside the port,
and the reference encodes every string it meets into its one
``materialize_tpu.repr.schema.GLOBAL_DICT``. Its order-preserving labels
come from gaps that a crowded dictionary can run dry, so a port file
that leaves thousands of strings behind can make a later reference test
in the same worker fail (``DictExhausted``). Two pieces:

- ``reference_dict_restored``: a module fixture; a port file that
  imports it gives the dictionary back as it found it (the strings, their
  codes and the relabeling epoch, which it then bumps together with the
  version, so no cache built on the file's codes stays valid).
- ``-p tests.torch_dict_probe``: a pytest plugin that fails the run
  when a ``test_torch_*`` file left the dictionary changed.
- ``port_dict_restored``: the same for the port's own ``GLOBAL_DICT``,
  for a file that rebalances it (a rebalance relabels every string the
  process coded before).
"""

from __future__ import annotations

import contextlib

import pytest


def _dict():
    from materialize_tpu.repr.schema import GLOBAL_DICT

    return GLOBAL_DICT


def dict_state(d=None) -> dict:
    """The dictionary's content: string -> code."""
    d = d or _dict()
    with d._lock:
        return dict(d._codes)


@contextlib.contextmanager
def restored_reference_dict(d=None):
    d = d or _dict()
    with d._lock:
        saved = (list(d._sorted), dict(d._codes), dict(d._by_code), d.epoch)
    try:
        yield
    finally:
        with d._lock:
            # Rebind, as the dictionary's own rebalance does: snapshots
            # taken meanwhile keep the maps they read.
            d._sorted, d._codes, d._by_code = saved[0], saved[1], saved[2]
            d.epoch = max(d.epoch, saved[3]) + 1
            d.version += 1


@pytest.fixture(autouse=True, scope="module")
def reference_dict_restored():
    with restored_reference_dict():
        yield


@pytest.fixture(scope="module")
def port_dict_restored():
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT

    with restored_reference_dict(GLOBAL_DICT):
        yield
