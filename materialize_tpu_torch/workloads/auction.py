"""The auction workload: per-auction TOP-K and the DISTINCT winning
bidders over the churning bid stream (the port of
``materialize_tpu/workloads/auction.py``), and ``auction_config``, the
port's counterpart of the reference bench's ``config_auction``
(``bench.py:316-344``).

``auction_plan(k)`` is the plan the reference renders,
``optimize(auction_winning_bidders_mir(k))``, built directly with the
port's MIR classes (the port carries no optimizer): the optimizer fuses
the projection into the Reduce's input and leaves
``Reduce(Project(TopK(Get bids, group (auction_id,), amount DESC,
limit k), (buyer,)), group (0,), no aggregates)``. A test converts the
reference's optimizer output and asserts the trees equal.

``auction_window_plan(k, window)`` keeps the same TopK and Distinct over
a sliding window of the insert-only bid stream, Materialize's temporal
filter pattern ``WHERE mz_now() < bid_time + window``: the filter, not
the generator, retracts each bid ``window`` ticks after it was placed.
``auction_window_config`` drives it as ``auction_config`` drives the
retract-mode auction.
"""

from __future__ import annotations

from ..expr import relation as mir
from ..expr.scalar import MzNow, col, lit
from ..render.dataflow import Dataflow
from ..repr.schema import ColumnType
from ..storage.generator.auction import BIDS_SCHEMA, AuctionGenerator


def auction_topk_mir(k: int = 3) -> mir.RelationExpr:
    """Top-k bids per auction: group by auction_id, order amount DESC."""
    bids = mir.Get("bids", BIDS_SCHEMA)
    return mir.TopK(bids, group_key=(2,), order_by=((3, True, False),), limit=k)


def auction_winning_bidders_mir(k: int = 3) -> mir.RelationExpr:
    """DISTINCT buyers holding a top-k bid on any auction."""
    return auction_topk_mir(k).project((1,)).distinct()


def auction_plan(k: int = 3) -> mir.RelationExpr:
    """``optimize(auction_winning_bidders_mir(k))`` as the reference's
    optimizer gives it."""
    return mir.Reduce(auction_topk_mir(k).project((1,)), (0,), ())


def auction_config(seed: int = 42, n_users: int = 512, auctions_per_tick: int = 128,
                   bids_per_auction: int = 8, retract_after: int = 4,
                   state_cap: int = 1 << 13, k: int = 3, device=None):
    """The bench's auction configuration (its defaults are the bench's
    sizes). Returns (df, hydrate, churn): ``hydrate()`` gives the 8 hydrate ticks' inputs (retractions
    flowing by then), ``churn(i, t)`` the inputs of churn tick ``i`` at
    time ``t`` and its row count. Ticks must be drawn in order: the
    generator is one random stream."""
    gen = AuctionGenerator(seed=seed, n_users=n_users, auctions_per_tick=auctions_per_tick,
                           bids_per_auction=bids_per_auction, retract_after=retract_after,
                           device=device)
    df = Dataflow(auction_plan(k), state_cap=state_cap, device=device)

    def hydrate():
        return [{"bids": gen.tick(i, i)["bids"]} for i in range(8)]

    def churn(i: int, t: int):
        b = gen.tick(8 + i, t)["bids"]
        return {"bids": b}, b._host_count

    return df, hydrate, churn


def auction_window_plan(k: int = 3, window: int = 4) -> mir.RelationExpr:
    """The auction's TopK and Distinct over the bids placed in the last
    ``window`` ticks: ``Filter(Get bids, mz_now() < bid_time + window)``
    in place of the generator's retractions."""
    bids = mir.Filter(mir.Get("bids", BIDS_SCHEMA),
                      (MzNow().lt(col(4) + lit(window, ColumnType.INT64)),))
    topk = mir.TopK(bids, group_key=(2,), order_by=((3, True, False),), limit=k)
    return mir.Reduce(topk.project((1,)), (0,), ())


def auction_window_config(seed: int = 42, n_users: int = 512, auctions_per_tick: int = 128,
                          bids_per_auction: int = 8, window: int = 4,
                          state_cap: int = 1 << 13, k: int = 3, device=None):
    """The auction under a temporal window: ``auction_window_plan`` over
    the insert-only generator (``retract_after=None``), with the sizes
    and returns of ``auction_config``. Tick ``i`` runs at time ``i``:
    ``bid_time`` holds the tick's time and ``mz_now()`` is the step's,
    so a bid leaves the window ``window`` ticks after it was placed,
    exactly when the retract-mode generator (``retract_after=window``)
    retracts it, and both give the same peek at every tick. Time must
    step by 1 a tick for that: ``churn(i, t)`` needs ``t == 8 + i`` and
    the dataflow at time ``t``. ``churn`` returns the inserts' row count;
    the retractions the filter releases at that tick are the inserts of
    ``window`` ticks earlier."""
    gen = AuctionGenerator(seed=seed, n_users=n_users, auctions_per_tick=auctions_per_tick,
                           bids_per_auction=bids_per_auction, retract_after=None,
                           device=device)
    df = Dataflow(auction_window_plan(k, window), state_cap=state_cap, device=device)

    def hydrate():
        return [{"bids": gen.tick(i, i)["bids"]} for i in range(8)]

    def churn(i: int, t: int):
        if t != 8 + i:
            raise ValueError(f"churn tick {i} must run at time {8 + i}, not {t}")
        b = gen.tick(8 + i, t)["bids"]
        return {"bids": b}, b._host_count

    return df, hydrate, churn
