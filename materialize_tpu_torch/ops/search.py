"""Vectorised lexicographic binary search over row-stacked lanes (the
port of ``materialize_tpu/ops/search.py:lex_searchsorted_2d``).

Plain torch: every query row steps in lockstep, one ``[n, L]`` row
gather per iteration. Lanes are in the stored int64 form
(``ops/lanes.py``), so the signed compare is the reference's u64
compare.
"""

from __future__ import annotations

import torch


def lex_less_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b on ``[n, L]`` lanes (lexicographic over L)."""
    n, L = a.shape
    lt = torch.zeros(n, dtype=torch.bool, device=a.device)
    eq = torch.ones(n, dtype=torch.bool, device=a.device)
    for j in range(L):
        lt = lt | (eq & (a[:, j] < b[:, j]))
        eq = eq & (a[:, j] == b[:, j])
    return lt


def _row_before(rows: torch.Tensor, query: torch.Tensor, side: str) -> torch.Tensor:
    """Row-wise ``rows < query`` (side 'left') or ``rows <= query``
    (side 'right'), lexicographic over L, folded from the last lane:
    3 ops a lane after the first."""
    L = rows.shape[1]
    last = rows[:, L - 1]
    res = last < query[:, L - 1] if side == "left" else last <= query[:, L - 1]
    for j in range(L - 2, -1, -1):
        res = (rows[:, j] < query[:, j]) | ((rows[:, j] == query[:, j]) & res)
    return res


def lex_searchsorted_2d(
    sorted_2d: torch.Tensor, count, query_2d: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """For each query row, its insertion point (int32) in the valid
    prefix ``[0, count)`` of ``sorted_2d``.

    side='left' : first index i with sorted[i] >= q
    side='right': first index i with sorted[i] >  q

    The reference's lo/hi bisection, written as binary lifting: ``pos``
    counts the prefix rows before ``q`` and grows by each power of two
    (largest first) whose last row still lies before ``q``, so a step is
    one row gather and ~8 eager ops (L = 1) for the same
    ``m.bit_length()`` steps and the same result. The gather index is
    clamped by hand where ``pos + step`` passes ``m`` (jnp's gathers
    clamp, torch's raise); such a step is inert, as it passes ``count``.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    m, L = sorted_2d.shape
    n = query_2d.shape[0]
    if query_2d.shape[1] != L:
        raise ValueError(f"lane widths differ: {sorted_2d.shape} vs {query_2d.shape}")
    dev = query_2d.device
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    if m == 0:
        return pos.to(torch.int32)
    count = torch.as_tensor(count, device=dev).to(torch.int64)
    step = 1 << (m.bit_length() - 1)
    while step:
        cand = pos + step
        rows = sorted_2d[torch.clamp(cand - 1, max=m - 1)]
        go = _row_before(rows, query_2d, side) & (cand <= count)
        pos = torch.where(go, cand, pos)
        step >>= 1
    return pos.to(torch.int32)
