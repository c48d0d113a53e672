"""The port's TPC-H Q21 alone in Q9's slotted layout (``q21_config``: 14
spines with a ring of 8 slots each, tiers from ``q21_tiers``), at SF
0.003 (seed 17: the view holds two suppliers), against the numpy oracle
of ``test_torch_q21.py`` over 6 hydrate ticks of 896 orders (no tier
overflows) and 2 churn ticks, the second flushing every ring. A tick of
this layout costs the CPU ~7 s (some 10^5 eager operations), so the
test stops at 8 ticks. Integers: tolerance 0. Split from
``test_torch_q21.py`` so that parallel test workers spread the two."""

from __future__ import annotations

from materialize_tpu_torch.arrangement.spine import Spine
from materialize_tpu_torch.workloads.tpch import apply_tiers, q21_config, q21_tiers
from tests.test_torch_q21 import SEED, _one_torch_thread, _peek_multiset, q21_oracle  # noqa: F401


SLOT_SF, SLOT_HYDRATE = 0.003, 896


def test_q21_slotted_layout_matches_oracle():
    df, hydrate, churn = q21_config(sf=SLOT_SF, n_orders_per_tick=16,
                                    hydrate_orders=SLOT_HYDRATE, seed=SEED, device="cpu")
    h = hydrate()
    assert len(h) == 6 and df._ctx.ingest_slots == 8
    apply_tiers(df, q21_tiers(df, h, 16, 2))
    before = df._readbacks
    df.run_steps(h, defer_check=True)
    assert df.check_flags() is False and df._readbacks - before == 1
    # 2 churn ticks: the eighth tick flushes every ring into run 0.
    c = [churn(i, len(h) + i)[0] for i in range(2)]
    df.run_steps(c, defer_check=True)
    assert df.check_flags() is False
    assert all(sp.cursor == 0 for parts in df.states for sp in parts if isinstance(sp, Spine))
    want = q21_oracle([x["lineitem"] for x in h + c], h[0])
    assert _peek_multiset(df.peek()) == want and len(want) >= 2
    assert df.peek_errors() == []
