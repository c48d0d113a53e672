"""A pytest plugin (``-p tests.torch_dict_probe``): fails the run when a
``test_torch_*`` file left the reference's ``GLOBAL_DICT`` changed,
checked when the next file starts and at the end of the session. Kept
apart from ``tests/torch_dict.py``: a plugin's fixtures apply to every
file, and the probe must see what each file leaves.
"""

from __future__ import annotations

import os

import pytest

from tests.torch_dict import dict_state

_WATCH: dict = {"file": None, "state": None, "changed": []}


def _is_port_file(path) -> bool:
    return os.path.basename(str(path)).startswith("test_torch_")


def _close_file() -> None:
    f = _WATCH["file"]
    if f is not None and _is_port_file(f) and dict_state() != _WATCH["state"]:
        _WATCH["changed"].append(os.path.basename(str(f)))


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    path = item.path
    if path != _WATCH["file"]:
        _close_file()
        _WATCH["file"], _WATCH["state"] = path, dict_state()


def pytest_sessionfinish(session, exitstatus):
    _close_file()
    _WATCH["file"] = None
    if _WATCH["changed"]:
        print(f"\nreference GLOBAL_DICT left changed by: {_WATCH['changed']}")
        session.exitstatus = 1
