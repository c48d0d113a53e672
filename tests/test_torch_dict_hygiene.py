"""Port test files give the reference's string dictionary back.

``tests/test_torch_scalar.py`` encoded thousands of strings into the
reference's process-global ``GLOBAL_DICT`` and, in the same test worker,
left ``tests/test_dataflow.py::TestNestedStringCalls::test_concat_chain``
without a label gap. The port files now restore it through
``tests/torch_dict.py``'s module fixture; ``tests/torch_dict_probe.py`` fails a run in
which a ``test_torch_*`` file left it changed.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from tests.torch_dict import dict_state, restored_reference_dict
from tests.torch_serving import deadline, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# Port files that encode into the reference's dictionary, each of which
# must use the fixture.
PORT_FILES = (
    "test_torch_scalar.py",
    "test_torch_subscribe.py",
    "test_torch_server.py",
    "test_torch_freshness.py",
)


def test_restore_gives_back_strings_codes_and_invalidates_caches():
    from materialize_tpu.repr.schema import GLOBAL_DICT

    before = dict_state()
    version, epoch = GLOBAL_DICT.version, GLOBAL_DICT.epoch
    with restored_reference_dict():
        codes = [GLOBAL_DICT.encode(f"hygiene-{i:04d}") for i in range(500)]
        assert len(set(codes)) == 500 and dict_state() != before
    assert dict_state() == before
    assert GLOBAL_DICT.version > version and GLOBAL_DICT.epoch > epoch
    # The dictionary still encodes, in order, after the restore.
    with restored_reference_dict():
        assert GLOBAL_DICT.encode("hygiene-a") < GLOBAL_DICT.encode("hygiene-b")


def test_port_files_use_the_fixture():
    for name in PORT_FILES:
        text = (ROOT / "tests" / name).read_text()
        assert "reference_dict_restored" in text, name


def test_scalar_file_leaves_the_dictionary_and_concat_chain_passes():
    """The order that failed: the scalar file, then the reference's
    string-call chain, in one process. The plugin fails the run if the
    port file left the dictionary changed."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "tests.torch_dict_probe",
         "tests/test_torch_scalar.py",
         "tests/test_dataflow.py::TestNestedStringCalls::test_concat_chain"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "left changed" not in proc.stdout
