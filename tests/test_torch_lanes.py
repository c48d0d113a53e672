"""Port parity: key lanes and the hash pair (materialize_tpu_torch.ops.lanes
against materialize_tpu.ops.lanes and the numpy hash_pair_host).

Bit-identity is required, not approximate: host generators presort their
batches with hash_pair_host and stamp them hash_consolidated, so the
device must reproduce the order exactly. Lanes are compared after
mapping the port's int64 storage form back to u64."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from materialize_tpu.ops import lanes as jl
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import Column as JColumn
from materialize_tpu.repr.schema import ColumnType as JType
from materialize_tpu.repr.schema import Schema as JSchema
from materialize_tpu_torch.ops import lanes as tl
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.repr.schema import Column as TColumn
from materialize_tpu_torch.repr.schema import ColumnType as TType
from materialize_tpu_torch.repr.schema import Schema as TSchema


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# The lineitem column types (INT64, INT32, DECIMAL, STRING codes, DATE)
# plus BOOL, each nullable and not.
_SPEC = [
    ("k", "INT64", False),
    ("q", "DECIMAL", True),
    ("s", "STRING", False),
    ("d", "DATE", True),
    ("n", "INT32", False),
    ("b", "BOOL", True),
    ("x", "INT64", True),
]
_NP = {"INT64": np.int64, "DECIMAL": np.int64, "STRING": np.int64,
       "DATE": np.int32, "INT32": np.int32, "BOOL": np.bool_}


def _schemas():
    js = JSchema([JColumn(n, JType[t], nullable=nl) for n, t, nl in _SPEC])
    ts = TSchema([TColumn(n, TType[t], nullable=nl) for n, t, nl in _SPEC])
    return js, ts


def _rand(rng, n):
    cols, nulls = [], []
    for _, t, nl in _SPEC:
        if t == "BOOL":
            c = rng.integers(0, 2, n).astype(bool)
        elif t in ("INT32", "DATE"):
            c = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64).astype(np.int32)
        else:
            c = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
            c[: n // 4] = rng.integers(-5, 5, n // 4)  # small and negative
        cols.append(c)
        nulls.append(rng.random(n) < 0.3 if nl else None)
    return cols, nulls


@pytest.mark.parametrize("seed,n", [(0, 300), (1, 1000), (2, 17)])
def test_key_lanes_and_hash_pair_match_reference(seed, n):
    rng = np.random.default_rng(seed)
    js, ts = _schemas()
    cols, nulls = _rand(rng, n)
    time = rng.integers(0, 1 << 40, n).astype(np.uint64)
    diff = np.ones(n, np.int64)
    jb = JBatch.from_numpy(js, cols, time, diff, nulls=nulls)
    tb = TBatch.from_numpy(ts, cols, time, diff, nulls=nulls, device="cpu")
    assert jb.capacity == tb.capacity
    for key in ([0], [1, 3], list(range(len(_SPEC))), []):
        jlanes = jl.key_lanes(jb, key)
        tlanes = tl.key_lanes(tb, key)
        assert len(jlanes) == len(tlanes) == tl.key_lane_width(ts, key)
        for a, b in zip(jlanes, tlanes):
            assert np.array_equal(np.asarray(a), tl.to_u64(b)), key
        jh = jl.hash_pair(jlanes)
        th = tl.hash_pair(tlanes)
        for a, b in zip(jh, th):
            assert np.array_equal(np.asarray(a), tl.to_u64(b)), key
        # the scan-free single-chain form agrees too
        assert np.array_equal(
            np.asarray(jl.hash_lanes(jlanes)), tl.to_u64(tl.hash_lanes(tlanes))
        )
    # row lanes with time, and the numpy host replica
    jr = jl.row_lanes(jb, include_time=True)
    tr = tl.row_lanes(tb, include_time=True)
    for a, b in zip(jr, tr):
        assert np.array_equal(np.asarray(a), tl.to_u64(b))
    host = []
    for c, col, nl in zip(cols, ts.columns, nulls):
        host.extend(tl.host_lane_encode(np.asarray(c), col, nl))
    h1, h2 = tl.hash_pair_host(host)
    t1, t2 = tl.hash_pair(tl.key_lanes(tb, range(len(_SPEC))))
    assert np.array_equal(h1, tl.to_u64(t1)[:n])
    assert np.array_equal(h2, tl.to_u64(t2)[:n])
    # the port's host replica is the reference's, bit for bit
    r1, r2 = jl.hash_pair_host(host)
    assert np.array_equal(r1, h1) and np.array_equal(r2, h2)


def test_stored_form_orders_like_u64():
    rng = np.random.default_rng(3)
    u = rng.integers(0, 1 << 63, 2000, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, 2000).astype(np.uint64)
    u[:4] = [0, 1 << 63, (1 << 63) - 1, (1 << 64) - 1]
    s = torch.from_numpy(tl.from_u64(u))
    assert np.array_equal(tl.to_u64(s), u)
    assert np.array_equal(np.argsort(u, kind="stable"), torch.sort(s, stable=True).indices.numpy())
