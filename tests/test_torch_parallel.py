"""The port's exchange (``materialize_tpu_torch/parallel/``) against the
reference's (``materialize_tpu/parallel/exchange.py``).

- ``shard_of`` and ``partition`` in process, over seeded numpy batches
  with NULL keys, a FLOAT64 key and an empty key, ``null_aware`` both
  ways and 2-8 workers: destinations, send buffers, counts and the
  overflow flag bit for bit.
- ``exchange`` on 2 and 4 gloo ranks (each spawned set joined under the
  per-test deadline): every rank's received rows equal, in order, that
  worker's output of the reference's ``exchange`` under ``shard_map``
  on a mesh of the same size; every row reaches its key's owner and the
  multiset of rows is conserved; the overflow flag is false at exactly
  ``slot_cap`` rows to one destination and true on every rank at one
  more (``tests/test_parallel.py``'s cases).
- The mesh and the launcher refuse what they cannot place: NCCL on the
  CPU, more CPU ranks than 8, a world size that is not the group's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_sharded_cases as C
from tests.torch_serving import DEADLINE_S, deadline, one_torch_thread  # noqa: F401


def _schema(mod):
    C_, T = mod.Column, mod.ColumnType
    return mod.Schema([C_("k", T.INT64, True), C_("f", T.FLOAT64), C_("s", T.INT32)])


def _pair(n=300, seed=3):
    from materialize_tpu.repr import schema as js
    from materialize_tpu.repr.batch import Batch as JB
    from materialize_tpu_torch.repr import schema as ts
    from materialize_tpu_torch.repr.batch import Batch as TB

    rng = np.random.default_rng(seed)
    k = rng.integers(-5, 50, n)
    f = rng.normal(size=n)
    f[:4] = [0.0, -0.0, np.inf, np.nan]
    s = rng.integers(0, 9, n).astype(np.int32)
    nl = rng.random(n) < 0.2
    d = rng.choice(np.asarray([1, -1]), n)
    args = ([k, f, s], np.zeros(n, np.uint64), d)
    jb = JB.from_numpy(_schema(js), *args, nulls=[nl, None, None], capacity=512)
    tb = TB.from_numpy(_schema(ts), *args, nulls=[nl, None, None], capacity=512, device="cpu")
    return jb, tb


@pytest.mark.parametrize("workers", [2, 3, 4, 8])
def test_shard_of_and_partition_bit_identical(workers):
    from materialize_tpu.parallel.exchange import partition as jpartition
    from materialize_tpu.parallel.exchange import shard_of as jshard_of
    from materialize_tpu_torch.parallel.exchange import partition, shard_of

    jb, tb = _pair()
    for key in [(0,), (1,), (0, 2), (), (2,)]:
        for null_aware in (True, False):
            want = np.asarray(jshard_of(jb, key, workers, null_aware))
            got = shard_of(tb, key, workers, null_aware).numpy()
            np.testing.assert_array_equal(got, want)
    route = np.asarray(jshard_of(jb, (0,), workers))
    for slot_cap in (16, 64, 512):
        jf, jc, jo = jpartition(jb, route, workers, slot_cap)
        tf, tc, to = partition(tb, torch.from_numpy(route.copy()), workers, slot_cap)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert bool(to) == bool(jo)
        for a, b in zip(list(jf["cols"]) + [jf["time"], jf["diff"]],
                        list(tf["cols"]) + [tf["time"], tf["diff"]]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype)
                                          if np.asarray(a).dtype != np.uint64
                                          else np.asarray(a).view(np.int64))
        for a, b in zip(jf["nulls"], tf["nulls"]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _reference_exchange(world, inputs, slot_cap, null_aware):
    """Each worker's received rows under the reference's ``exchange``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from materialize_tpu.parallel import compat
    from materialize_tpu.parallel.exchange import exchange
    from materialize_tpu.parallel.mesh import make_mesh, worker_sharding
    from materialize_tpu.repr.batch import Batch

    mesh = make_mesh(world)
    cap = C.EXCHANGE_CAP

    def pack(i, dtype):
        out = np.zeros((world, cap), dtype=dtype)
        for p, rows in enumerate(inputs):
            out[p, : len(rows[i])] = rows[i]
        return jax.device_put(out.reshape(world * cap), worker_sharding(mesh))

    counts = np.asarray([len(r[3]) for r in inputs], np.int32)
    gb = Batch(
        cols=(pack(0, np.int64), pack(2, np.int64)),
        nulls=(pack(1, np.bool_), None),
        time=jax.device_put(np.zeros(world * cap, np.uint64), worker_sharding(mesh)),
        diff=pack(3, np.int64),
        count=jax.device_put(counts, worker_sharding(mesh)),
        schema=C.exchange_schema("ref"),
    )

    def per_worker(b):
        b = b.replace(count=b.count.reshape(()))
        routed, ovf = exchange(b, (0,), "workers", world, slot_cap, null_aware)
        return routed.replace(count=routed.count.reshape((1,))), ovf.reshape((1,))

    routed, ovf = jax.jit(compat.shard_map(
        per_worker, mesh=mesh, in_specs=(P("workers"),),
        out_specs=(P("workers"), P("workers")), check_vma=False))(gb)
    got_counts = np.asarray(routed.count)
    out_cap = world * slot_cap
    res = []
    for p in range(world):
        sl = slice(p * out_cap, p * out_cap + got_counts[p])
        res.append((np.asarray(routed.cols[0])[sl], np.asarray(routed.nulls[0])[sl],
                    np.asarray(routed.cols[1])[sl], np.asarray(routed.diff)[sl],
                    bool(np.asarray(ovf)[p])))
    return res


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_on_gloo_ranks_equals_reference(world):
    from materialize_tpu_torch.parallel.exchange import shard_of
    from materialize_tpu_torch.parallel.multihost import spawn_workers
    from materialize_tpu_torch.repr.batch import Batch

    trials = [(C.exchange_inputs(world, seed), C.EXCHANGE_CAP, na)
              for seed, na in ((0, True), (1, False), (2, True))]
    slot = 8
    trials += [(C.boundary_inputs(world, slot), slot, True),
               (C.boundary_inputs(world, slot + 1), slot, True)]
    ranks = spawn_workers(C.exchange_rank, world, device="cpu", args=(trials,),
                          timeout=DEADLINE_S - 10)
    sch = C.exchange_schema("port")
    for t, (inputs, slot_cap, null_aware) in enumerate(trials):
        want = _reference_exchange(world, inputs, slot_cap, null_aware)
        for p in range(world):
            got = ranks[p][t]
            for a, b in zip(got, want[p]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            if got[4]:
                continue
            # Every received row is owned by this rank.
            k, nl = got[0], got[1]
            b = Batch.from_numpy(sch, [k, np.zeros_like(k)], np.zeros(len(k), np.uint64),
                                 np.ones(len(k), np.int64), nulls=[nl, None], device="cpu")
            assert (shard_of(b, (0,), world, null_aware)[: len(k)].numpy() == p).all()
        overflow = [ranks[p][t][4] for p in range(world)]
        assert overflow == [t == len(trials) - 1] * world
        if not overflow[0]:
            sent = sorted((int(k), bool(n), int(v), int(d)) for rows in inputs
                          for k, n, v, d in zip(*rows))
            recv = sorted((int(k), bool(n), int(v), int(d)) for p in range(world)
                          for k, n, v, d in zip(*ranks[p][t][:4]))
            assert recv == sent


def test_mesh_refuses_what_it_cannot_place():
    from materialize_tpu_torch.parallel.mesh import CPU_MAX_RANKS, check_backend
    from materialize_tpu_torch.parallel.multihost import host_local_device_count, spawn_workers

    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", cpu, 2)
    with pytest.raises(ValueError, match="at most 8"):
        check_backend("gloo", cpu, CPU_MAX_RANKS + 1)
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend("mpi", cpu, 2)
    assert host_local_device_count("cpu") == CPU_MAX_RANKS
    with pytest.raises(ValueError):
        spawn_workers(C.exchange_rank, 2, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="cuda"):
        spawn_workers(C.exchange_rank, 2)
    # A rank that fails fails the launch, naming the rank.
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn_workers(C.failing_rank, 2, device="cpu", timeout=DEADLINE_S - 10)
