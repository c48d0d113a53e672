"""The port's program bank (``compile/bank.py``) over its native
libraries: a store and a lookup serve a library that loads; a corrupt
entry is unlinked and counted as a miss; a version-skewed entry is
skipped and kept; a missing entry is a plain miss; a bank that cannot be
read raises; the compile ledger counts bank hits and misses as the
reference's does; and a CPU deployment recovered over its data directory
loads ``mtnative`` from the bank with no fresh build, its rows equal to
the first boot's and to the reference's on the same SQL
(``tests/test_program_bank.py::TestRecoverFromBank``).

Every library is built into the test's own directory, never into the
repository's ``_build/``.
"""

from __future__ import annotations

import ctypes
import json
import os

import pytest

from tests.torch_serving import deadline, mod, one_torch_thread  # noqa: F401

SYMBOL = "mtn_crc32c"

RECOVER_SQL = [
    "CREATE TABLE rp (k BIGINT NOT NULL, v BIGINT NOT NULL, w BIGINT NOT NULL)",
    "INSERT INTO rp VALUES (1, 10, 100), (2, 20, 200), (1, 5, 50)",
    "CREATE MATERIALIZED VIEW rpmv AS SELECT k, v + w FROM rp WHERE k >= 1",
]


@pytest.fixture(autouse=True)
def _bank_off_after():
    """Every test leaves both packages' process-global bank off."""
    yield
    mod("port", "compile.bank").configure_bank(None)
    mod("ref", "compile.bank").configure_bank(None)


@pytest.fixture()
def fresh_native(tmp_path, monkeypatch):
    """The port's ``native`` module with no library loaded and its build
    directory in the test's own directory."""
    native = mod("port", "native")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    return native


@pytest.fixture()
def stored(tmp_path, fresh_native):
    """A bank holding mtnative, stored by the library's first load."""
    bank = mod("port", "compile.bank").configure_bank(str(tmp_path / "bank"))
    fresh_native.lib()
    assert bank.stats["stores"] == 1
    kind, fp, tier = fresh_native.build_key()
    return bank, (kind, fp, tier)


def test_store_and_lookup_serve_a_library_that_loads(stored, fresh_native):
    bank, key = stored
    fresh = type(bank)(bank.root)
    got = fresh.lookup(*key, SYMBOL, "g++")
    assert got is not None
    path, meta = got
    assert path.startswith(bank.root) and meta["seconds"] > 0
    assert (meta["kind"], meta["fingerprint"], meta["tier"]) == key
    lib = ctypes.CDLL(path)
    lib.mtn_crc32c.restype = ctypes.c_uint32
    lib.mtn_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    assert lib.mtn_crc32c(b"materialize", 11) == fresh_native.crc32c(b"materialize")
    assert fresh.stats["hits"] == 1 and fresh.stats["misses"] == 0
    assert fresh.stats["seconds_recovered"] == meta["seconds"]
    [entry] = fresh.entries()
    assert (entry["kind"], entry["fingerprint"], entry["tier"]) == key
    assert entry["bytes"] == os.path.getsize(path)
    # The next load in a process goes through the bank: a hit.
    ledger = mod("port", "utils.compile_ledger").LEDGER
    n0 = len(ledger.records())
    fresh_native._lib = None
    fresh_native.lib()
    [rec] = ledger.records()[n0:]
    assert rec.cache == "bank_hit" and rec.attrs["recovered_seconds"] == meta["seconds"]


def test_corrupt_entry_is_unlinked_and_a_miss(stored):
    bank, key = stored
    lib = os.path.join(bank.path_for(*key), "lib.so")
    with open(lib, "r+b") as f:
        f.truncate(64)
    fresh = type(bank)(bank.root)
    assert fresh.lookup(*key, SYMBOL, "g++") is None
    assert not os.path.exists(bank.path_for(*key))
    assert (fresh.stats["misses"], fresh.stats["damaged"], fresh.stats["hits"]) == (1, 1, 0)


def test_version_skewed_entry_is_skipped_not_unlinked(stored):
    bank, key = stored
    meta_path = os.path.join(bank.path_for(*key), "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["torch"] = "0.0.0-stale"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    fresh = type(bank)(bank.root)
    assert fresh.lookup(*key, SYMBOL, "g++") is None
    assert os.path.exists(meta_path), "a skewed entry must not be unlinked"
    assert (fresh.stats["misses"], fresh.stats["skipped"], fresh.stats["damaged"]) == (1, 1, 0)


def test_missing_entry_is_a_plain_miss_and_an_unreadable_bank_raises(tmp_path):
    bank = mod("port", "compile.bank").ProgramBank(str(tmp_path / "bank"))
    assert bank.lookup("g++", "cafebabe", "x86_64", SYMBOL, "g++") is None
    assert bank.stats["misses"] == 1
    assert bank.stats["damaged"] == bank.stats["skipped"] == bank.stats["hits"] == 0
    # An entry that cannot be read is not a miss: it raises.
    with open(bank.path_for("g++", "deadbeef", "x86_64"), "w") as f:
        f.write("not a directory")
    with pytest.raises(OSError):
        bank.lookup("g++", "deadbeef", "x86_64", SYMBOL, "g++")


def test_ledger_bank_counts_equal_the_reference():
    """bank_hit records are not compiles; the bank counts and the
    recovered seconds are the reference's for the same records."""
    summaries = []
    for pkg in ("ref", "port"):
        led = mod(pkg, "utils.compile_ledger").CompileLedger()
        led.record("step", "df", "aa", "t", 1.0, cache="miss", bank="miss")
        led.record("step", "df", "aa", "t", 0.01, cache="bank_hit", recovered_seconds=1.0)
        summaries.append(led.summary())
    keys = ("compiles", "misses", "hits", "bank_hits", "bank_misses",
            "bank_seconds_recovered")
    assert {k: summaries[1][k] for k in keys} == {k: summaries[0][k] for k in keys}
    assert (summaries[1]["compiles"], summaries[1]["bank_hits"],
            summaries[1]["bank_seconds_recovered"]) == (1, 1, 1.0)


def _boot(pkg: str, data: str):
    env_mod = mod(pkg, "server.environmentd")
    kw = {"device": "cpu"} if pkg == "port" else {}
    return env_mod.Environment(data, n_replicas=1, tick_interval=None,
                               in_process_replicas=True, **kw)


def test_recovery_loads_mtnative_from_the_bank(tmp_path, fresh_native):
    """Boot, install a projection MV, shut down; a second boot over the
    same data directory, whose process loads its libraries anew, loads
    mtnative from the bank and builds nothing. The reference's first
    boot over the same SQL gives the same rows."""
    ledger = mod("port", "utils.compile_ledger").LEDGER
    data = str(tmp_path / "envd")
    env1 = _boot("port", data)
    try:
        for sql in RECOVER_SQL:
            env1.coord.execute(sql)
        rows1 = sorted(env1.coord.execute("SELECT * FROM rpmv").rows)
        r1 = env1.recovery_report()["compiles"]
        assert r1["bank"]["stores"] >= 1 and r1["fresh_compiles"] >= 1, r1
    finally:
        env1.shutdown()
    assert mod("port", "compile.bank").get_bank() is None
    # The second boot stands for a new process: no library is loaded and
    # the ledger holds only what the recovery records.
    ledger.clear()
    fresh_native._lib = None
    env2 = _boot("port", data)
    try:
        c = env2.await_recovery()["compiles"]
        assert c["bank_hits"] >= 1 and c["bank_misses"] == 0, c
        assert c["fresh_compiles"] == 0 and c["compile_seconds_recovered"] > 0, c
        assert any(r.cache == "bank_hit" and r.name == "mtnative.cpp"
                   for r in ledger.records())
        assert sorted(env2.coord.execute("SELECT * FROM rpmv").rows) == rows1
        got = dict(env2.coord.execute(
            "SELECT metric, value FROM mz_recovery WHERE scope = 'compile'").rows)
        assert got["bank_hits"] >= 1 and got["bank_misses"] == 0
        stored = env2.coord.execute(
            "SELECT kind, tier FROM mz_program_bank WHERE state = 'stored'").rows
        assert ("g++", fresh_native.build_key()[2]) in stored
    finally:
        env2.shutdown()
    ref_env = _boot("ref", str(tmp_path / "ref-envd"))
    try:
        for sql in RECOVER_SQL:
            ref_env.coord.execute(sql)
        assert sorted(ref_env.coord.execute("SELECT * FROM rpmv").rows) == rows1
    finally:
        ref_env.shutdown()
