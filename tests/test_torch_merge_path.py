"""Port parity for the merge-path kernel's outputs, on the CPU.

- ``merge_source_map_torch`` (the kernel's plain version: ``src`` and the
  merged lanes) against the reference merge
  (``materialize_tpu/ops/merge.py:merge_sorted_cached``): a batch whose one
  column holds each row's index into ``concat(a, b)`` comes out of the
  reference merge as the source map itself. Covers overflow, ``a_count``
  and ``b_count`` 0, ``cap_a`` 0, unsorted ``b`` padding, heavy duplicates
  on both sides of 2^63.
- ``merge_path_partition_torch``, a plain-torch mirror of the CUDA
  kernel's steps (``materialize_tpu_torch/csrc/merge_path.cu``: the warp's
  32-probe co-rank search per tile, the per-thread split and serial merge,
  the padding formula), against ``merge_source_map_torch`` over random
  tile sizes and thread counts, including tie runs longer than a tile.
  The kernel itself is held against the plain version on a card in
  ``tests/test_torch_kernel.py``."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from materialize_tpu.ops.merge import merge_sorted_cached as j_merge
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import Column as JColumn
from materialize_tpu.repr.schema import ColumnType as JType
from materialize_tpu.repr.schema import Schema as JSchema
from materialize_tpu_torch.ops.lanes import from_u64, to_u64
from materialize_tpu_torch.ops.merge import merge_source_map_torch, search_right_torch
from materialize_tpu_torch.ops.search import lex_less_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_POOL = np.array(
    [0, 1, 2, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 1], dtype=np.uint64
)
_J_MERGE = jax.jit(j_merge, static_argnums=4)
_ID_SCHEMA = JSchema([JColumn("id", JType.INT64, nullable=False)])


def _lanes(rng, cap, count, L, pool=_POOL):
    """[cap, L] u64 lanes: a sorted valid prefix of ``count`` rows drawn
    from ``pool`` (heavy duplicates), then unsorted garbage padding."""
    valid = pool[rng.integers(0, len(pool), (count, L))]
    valid = valid[np.lexsort(valid.T[::-1])]
    pad = rng.integers(0, 1 << 63, (cap - count, L), dtype=np.uint64) * np.uint64(2)
    return np.concatenate([valid, pad]).reshape(cap, L)


def _count(n, one_element):
    t = torch.tensor(n, dtype=torch.int32)
    return t.reshape(1) if one_element else t


# (cap_a, a_count, cap_b, b_count, out_capacity, L)
_REF_CASES = [
    (64, 50, 32, 20, 128, 4),   # padding slots past the merge
    (64, 50, 32, 30, 64, 4),    # overflow: b's tail dropped
    (64, 0, 32, 20, 128, 4),    # a_count 0
    (64, 50, 32, 0, 128, 4),    # b_count 0
    (0, 0, 32, 20, 64, 4),      # cap_a 0: slot padding comes from b
    (48, 40, 48, 40, 96, 1),    # one lane
]


@pytest.mark.parametrize("cap_a,a_count,cap_b,b_count,out,L", _REF_CASES)
def test_source_map_matches_reference(cap_a, a_count, cap_b, b_count, out, L):
    rng = np.random.default_rng(cap_a * 7 + a_count + b_count * 3 + out + L)
    a = _lanes(rng, cap_a, a_count, L)
    b = _lanes(rng, cap_b, b_count, L)
    ids = np.arange(cap_a + cap_b, dtype=np.int64)
    if cap_a:
        ja = JBatch.from_numpy(_ID_SCHEMA, [ids[:a_count]], np.uint64(0),
                               np.ones(a_count, np.int64), capacity=cap_a)
        jb = JBatch.from_numpy(_ID_SCHEMA, [ids[cap_a:cap_a + b_count]], np.uint64(0),
                               np.ones(b_count, np.int64), capacity=cap_b)
        # the reference gathers padding rows too: give them their own ids
        ja = ja.replace(cols=(jax.numpy.asarray(ids[:cap_a]),))
        jb = jb.replace(cols=(jax.numpy.asarray(ids[cap_a:]),))
        jm, jml, _ = _J_MERGE(ja, jax.numpy.asarray(a), jb, jax.numpy.asarray(b), out)
        assert int(jm.count) == min(a_count + b_count, out)
        want_src = np.asarray(jm.cols[0])
        want_lanes = np.asarray(jml)
    else:
        # The reference's search cannot gather from an empty a: the spec
        # is b's valid rows in order, then the padding source row 0.
        want_src = np.zeros(out, np.int64)
        want_src[:min(b_count, out)] = ids[:min(b_count, out)]
        want_lanes = b[want_src]

    src, lanes = merge_source_map_torch(
        torch.from_numpy(from_u64(a)), _count(a_count, False), cap_a,
        torch.from_numpy(from_u64(b)), _count(b_count, True), cap_b, out,
    )
    assert src.dtype == torch.int64 and src.shape == (out,)
    assert lanes.dtype == torch.int64 and lanes.shape == (out, L)
    assert np.array_equal(src.numpy(), want_src)
    assert np.array_equal(to_u64(lanes), want_lanes)
    concat = np.concatenate([a, b])
    assert np.array_equal(to_u64(lanes), concat[src.numpy()])


# -- the kernel's steps in plain torch ----------------------------------------


def _le(x, y):
    return ~lex_less_rows(y, x)


def _rows(x, idx):
    """Rows ``x[idx]`` with the index clamped into range (the values of
    clamped probes are never used); zeros when ``x`` has no rows."""
    if x.shape[0] == 0:
        return torch.zeros((idx.numel(), x.shape[1]), dtype=x.dtype)
    return x[idx.clamp(0, x.shape[0] - 1).flatten()]


def _corank_warp(a, na, b, nb, d):
    """The kernel's ``corank_warp`` over diagonals ``d`` ([t] int64): each
    step evaluates a[i] <= b[d-1-i] at 32 points of [lo, hi) and keeps
    the gap where it turns false."""
    lo = torch.clamp(d - nb, min=0)
    hi = torch.minimum(d, torch.full_like(d, na))
    probe = torch.arange(1, 33, dtype=torch.int64)
    while bool((lo < hi).any()):
        active = lo < hi
        r = hi - lo
        i = lo[:, None] + (probe[None, :] * r[:, None]) // 33
        j = d[:, None] - 1 - i
        p = _le(_rows(a, i), _rows(b, j)).view(-1, 32)
        c = p.sum(1)
        prefix = torch.arange(32)[None, :] < c[:, None]
        assert torch.equal(p[active], prefix[active]), "ballot is not a prefix"
        last_true = lo + (c * r) // 33
        new_lo = torch.where(c == 0, lo, last_true + 1)
        new_hi = torch.where(c == 0, lo + r // 33,
                             torch.where(c < 32, lo + ((c + 1) * r) // 33, hi))
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
    return lo


def merge_path_partition_torch(a, a_count, cap_a, b, b_count, out_capacity,
                               tile, threads):
    """The CUDA kernel's algorithm step by step in plain torch (tiles of
    ``tile`` slots, ``threads`` threads per block): returns (src, merged
    lanes, pos), pos -1 for b rows the output does not place."""
    m, n = a.shape[0], b.shape[0]
    na = min(max(int(a_count), 0), m)
    nb = min(max(int(b_count), 0), n)
    total = min(na + nb, out_capacity)
    src = torch.full((out_capacity,), -7, dtype=torch.int64)
    pos = torch.full((n,), -1, dtype=torch.int32)

    k0 = torch.arange(0, out_capacity, tile, dtype=torch.int64)
    k0 = k0[k0 < total]
    k1 = torch.clamp(k0 + tile, max=total)
    i0 = _corank_warp(a, na, b, nb, k0)
    i1 = _corank_warp(a, na, b, nb, k1)
    j0, j1 = k0 - i0, k1 - i1
    na_t, nb_t, nk = i1 - i0, j1 - j0, k1 - k0

    # per (tile, thread): its slots [d0, d1) of the tile
    v = -(-tile // threads)
    t = torch.arange(threads, dtype=torch.int64)
    d0 = torch.minimum(t[None, :] * v, nk[:, None])
    d1 = torch.minimum(d0 + v, nk[:, None])
    I0, J0 = i0[:, None].expand_as(d0), j0[:, None].expand_as(d0)
    NA, NB = na_t[:, None].expand_as(d0), nb_t[:, None].expand_as(d0)
    lo = torch.clamp(d0 - NB, min=0)
    hi = torch.minimum(d0, NA)
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) // 2
        go = _le(_rows(a, I0 + mid), _rows(b, J0 + d0 - 1 - mid)).view(d0.shape)
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    ii, jj = lo, d0 - lo
    K0 = k0[:, None].expand_as(d0)
    for step in range(v):
        k = d0 + step
        live = k < d1
        a_le_b = _le(_rows(a, I0 + ii), _rows(b, J0 + jj)).view(d0.shape)
        take_a = (jj >= NB) | ((ii < NA) & a_le_b)
        slot_src = torch.where(take_a, I0 + ii, cap_a + J0 + jj)
        src[(K0 + k)[live]] = slot_src[live]
        placed_b = live & ~take_a
        pos[(J0 + jj)[placed_b]] = (I0 + ii)[placed_b].to(torch.int32)
        ii = torch.where(live & take_a, ii + 1, ii)
        jj = torch.where(placed_b, jj + 1, jj)

    pad = torch.arange(total, out_capacity, dtype=torch.int64)
    src[total:] = torch.clamp(pad - nb, max=max(cap_a - 1, 0))
    return src, torch.cat([a, b])[src], pos


def _tie_lanes(rng, cap, count, L):
    """Two distinct rows only: runs of equal rows far longer than a tile."""
    pool = np.array([5, 1 << 63], dtype=np.uint64)
    valid = np.sort(pool[rng.integers(0, 2, count)])[:, None].repeat(L, axis=1)
    pad = rng.integers(0, 1 << 62, (cap - count, L), dtype=np.uint64)
    return np.concatenate([valid, pad]).reshape(cap, L)


@pytest.mark.parametrize("seed", range(8))
def test_partition_mirror_matches_source_map(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        L = int(rng.choice([1, 2, 3, 4, 5, 8]))
        cap_a = int(rng.choice([0, 1, 7, 40, 130]))
        cap_b = int(rng.choice([1, 9, 40, 130]))
        a_count = int(rng.integers(0, cap_a + 1))
        b_count = int(rng.integers(0, cap_b + 1))
        out = int(rng.choice([a_count + b_count, cap_a + cap_b, 64, 256]))
        out = max(out, 1)
        make = _tie_lanes if rng.random() < 0.4 else _lanes
        a = torch.from_numpy(from_u64(make(rng, cap_a, a_count, L)))
        b = torch.from_numpy(from_u64(make(rng, cap_b, b_count, L)))
        tile = int(rng.choice([4, 8, 16, 64]))
        threads = int(rng.choice([1, 2, 3, 8]))
        got_src, got_lanes, got_pos = merge_path_partition_torch(
            a, a_count, cap_a, b, b_count, out, tile, threads
        )
        want_src, want_lanes = merge_source_map_torch(
            a, _count(a_count, seed % 2 == 0), cap_a, b, _count(b_count, seed % 2 == 1),
            cap_b, out,
        )
        case = (L, cap_a, a_count, cap_b, b_count, out, tile, threads)
        assert torch.equal(got_src, want_src), case
        assert torch.equal(got_lanes, want_lanes), case
        ins = search_right_torch(a, torch.tensor(a_count, dtype=torch.int32), b)
        want_pos = torch.full((cap_b,), -1, dtype=torch.int32)
        # b row j is placed when its slot j + ins[j] lies inside the output
        keep = (torch.arange(cap_b) < b_count) & (torch.arange(cap_b) + ins < out)
        want_pos[keep] = ins[keep]
        assert torch.equal(got_pos, want_pos), case
