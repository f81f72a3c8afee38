"""Linear assignment as a jit-friendly device op.

The reference solves min-cost assignment with a Hungarian solver on a
square matrix zero-padded from the (trackers x detections) cost matrix
(reference: cova-rs/sort/src/lib.rs:25-56 `linear_assignment`).  On the
accelerator we use the auction algorithm (Bertsekas) with epsilon scaling — fully
vectorizable (every unassigned row bids in parallel each round, column
winners resolved with an argmax) and optimal once eps < gap/S.

Auction iteration counts scale with (cost range) / eps, so callers must
keep costs in a small range (SORT uses [0, 3]: real costs in [0, 2],
forced-overflow padding at 3 — never use huge sentinel costs here).

All shapes are static: pass an (S, S) cost matrix (pad yourself, the
padding convention is the caller's contract).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_NEG = -1e9


def _auction_phase(profit, row_to_col, col_to_row, prices, eps, max_iters):
    s = profit.shape[0]

    def cond(state):
        row_to_col, _, _, it = state
        return jnp.logical_and(jnp.any(row_to_col < 0), it < max_iters)

    def body(state):
        row_to_col, col_to_row, prices, it = state
        unassigned = row_to_col < 0  # (S,)

        # Every unassigned row bids for its best column.
        value = profit - prices[None, :]  # (S, S)
        best_j = jnp.argmax(value, axis=1)  # (S,)
        best_v = jnp.max(value, axis=1)
        masked = value.at[jnp.arange(s), best_j].set(_NEG)
        second_v = jnp.max(masked, axis=1)
        bid = prices[best_j] + (best_v - second_v) + eps  # (S,)

        # Resolve per-column winner: highest bid wins.
        bid_matrix = jnp.where(
            unassigned[:, None]
            & (jax.lax.broadcasted_iota(jnp.int32, (s, s), 1) == best_j[:, None]),
            bid[:, None],
            _NEG,
        )
        col_best_bid = jnp.max(bid_matrix, axis=0)  # (S,)
        col_winner = jnp.argmax(bid_matrix, axis=0)
        has_bid = col_best_bid > _NEG / 2

        # Previous owners of re-bid columns lose them (bidders are all
        # unassigned, so winners and owners are disjoint).
        prev_owner = col_to_row
        lost = (
            jnp.zeros((s,), bool)
            .at[jnp.where(has_bid & (prev_owner >= 0), prev_owner, s)]
            .set(True, mode="drop")
        )
        row_to_col = jnp.where(lost, -1, row_to_col)
        row_to_col = row_to_col.at[jnp.where(has_bid, col_winner, s)].set(
            jnp.arange(s, dtype=jnp.int32), mode="drop"
        )
        col_to_row = jnp.where(has_bid, col_winner, col_to_row).astype(jnp.int32)
        prices = jnp.where(has_bid, col_best_bid, prices)
        return row_to_col, col_to_row, prices, it + 1

    return jax.lax.while_loop(
        cond, body, (row_to_col, col_to_row, prices, jnp.zeros((), jnp.int32))
    )


@functools.partial(jax.jit, static_argnames=("max_iters", "phases"))
def solve_assignment(
    cost: jnp.ndarray,
    eps: float = 1e-2,
    max_iters: int = 512,
    phases: int = 1,
) -> jnp.ndarray:
    """Solve the square min-cost assignment problem.

    Default is a single auction phase at the target eps: under vmap a
    while_loop runs until EVERY lane converges, and the multi-phase eps
    ladder made lanes converge at staggered rates — measured 55x slower
    than one phase inside the vmapped SORT scan. The result is optimal
    whenever cost gaps exceed S*eps; the default eps=1e-2 trades
    sub-0.16-IoU tie-breaking fidelity for far fewer auction rounds on
    real video — the exact-optimal production tracker is
    the host-side min-cost flow (csrc/cctrack.cc); this op serves the
    all-device multi-chip program and still passes every ported
    reference Hungarian case. Pass eps=1e-4 for near-exact optima. Any
    rows still unassigned at max_iters (tie-group churn) are completed
    by rank-matching free rows to free columns — for SORT those rows
    are dead/padding slots whose pairing is immaterial.

    Returns row_to_col: (S,) int32 — a complete permutation, like the
    reference's square Hungarian.
    """
    s = cost.shape[0]
    assert cost.shape == (s, s), "solve_assignment expects a square matrix"
    profit = -cost.astype(jnp.float32)

    cost_range = jnp.maximum(jnp.max(profit) - jnp.min(profit), 1.0)
    row_to_col = jnp.full((s,), -1, jnp.int32)
    col_to_row = jnp.full((s,), -1, jnp.int32)
    prices = jnp.zeros((s,), jnp.float32)

    if phases > 1:
        # eps ladder: range/4 -> ... -> eps
        for p in range(phases - 1):
            frac = (p + 1) / phases
            cur_eps = cost_range / 4.0 * (4.0 * eps / cost_range) ** frac
            row_to_col, col_to_row, prices, _ = _auction_phase(
                profit,
                jnp.full((s,), -1, jnp.int32),
                jnp.full((s,), -1, jnp.int32),
                prices,
                cur_eps,
                max_iters,
            )
    row_to_col, col_to_row, prices, _ = _auction_phase(
        profit,
        jnp.full((s,), -1, jnp.int32),
        jnp.full((s,), -1, jnp.int32),
        prices,
        eps,
        max_iters * 2,
    )
    # Greedy completion: rank-match any still-unassigned rows to the
    # free columns (ascending index), guaranteeing a full permutation.
    unassigned = row_to_col < 0
    owned = (
        jnp.zeros((s,), bool)
        .at[jnp.where(~unassigned, row_to_col, s)]
        .set(True, mode="drop")
    )
    row_rank = jnp.cumsum(unassigned) - 1
    free_cols = jax.lax.top_k(-jnp.where(~owned, jnp.arange(s), s), s)[1]
    fill = jnp.take(free_cols, jnp.clip(row_rank, 0, s - 1))
    return jnp.where(unassigned, fill, row_to_col)


@functools.partial(jax.jit, static_argnames=("max_iters",))
def solve_assignment_overflow(
    cost: jnp.ndarray,  # (MT, MD) real-pair costs
    row_mask: jnp.ndarray,  # (MT,) bool — rows that must be assigned
    col_mask: jnp.ndarray,  # (MD,) bool — columns that exist
    overflow_cost: float,
    eps: float = 1e-2,
    max_iters: int = 2048,
) -> jnp.ndarray:
    """Rectangular min-cost assignment with an OVERFLOW option.

    Solves: match each masked row to a distinct masked column (paying
    `cost[i, j]`) or to overflow (paying `overflow_cost`, unlimited
    capacity), minimizing the total. This is exactly the square
    zero-padded LAP sort_step used to build (dead-slot rows cost 0
    everywhere -> any completion is optimal -> they can be dropped;
    padding columns all cost `overflow_cost` for live rows and are
    interchangeable -> they collapse into one unlimited column), but
    the auction no longer spends iterations spreading ~48 immaterial
    dead rows over ~48 identical padding columns (examples/
    profile_device.py times the SORT scan).

    Same eps-optimality contract as solve_assignment: exact whenever
    distinct-total cost gaps exceed (assigned rows)*eps; ties may
    resolve differently from the host Hungarian (documented device
    behavior, tests/test_cctrack.py).

    max_iters must cover the contested price climb — when more rows
    than columns see real profit above the overflow value, prices rise
    by ~eps per iteration until the surplus rows' best real value
    drops to overflow, i.e. up to (overflow_cost / eps) iterations
    (~300 for SORT's range-3 costs at the 1e-2 default; typical video
    frames converge in far fewer). Rows still unassigned at the bound
    fall to overflow — keep the bound comfortably above the climb.

    Returns (MT,) int32: the matched column for real matches, -1 for
    overflow or masked-out rows.
    """
    mt, md = cost.shape
    profit = jnp.where(
        row_mask[:, None] & col_mask[None, :], -cost.astype(jnp.float32), _NEG
    )
    ovf_v = -jnp.asarray(overflow_cost, jnp.float32)
    ovf_col = jnp.int32(md)  # sentinel: parked on overflow
    row_to_col = jnp.where(row_mask, -1, ovf_col)
    col_to_row = jnp.full((md,), -1, jnp.int32)
    prices = jnp.zeros((md,), jnp.float32)

    def cond(state):
        r2c, _, _, it = state
        return jnp.logical_and(jnp.any(r2c < 0), it < max_iters)

    def body(state):
        r2c, c2r, prices, it = state
        unassigned = r2c < 0
        value = profit - prices[None, :]  # (MT, MD)
        best_j = jnp.argmax(value, axis=1)
        best_v = jnp.max(value, axis=1)
        masked = value.at[jnp.arange(mt), best_j].set(_NEG)
        # Overflow is always available, so it caps the second-best:
        # bids stay large when the only alternative is overflow.
        second_v = jnp.maximum(jnp.max(masked, axis=1), ovf_v)

        # Rows for which overflow beats every remaining real column
        # exit permanently (prices only rise, so overflow stays
        # optimal for them — the auction's reservation-value rule).
        exit_ovf = unassigned & (best_v <= ovf_v)
        r2c = jnp.where(exit_ovf, ovf_col, r2c)
        bidder = unassigned & ~exit_ovf

        bid = prices[best_j] + (best_v - second_v) + eps
        bid_matrix = jnp.where(
            bidder[:, None]
            & (
                jax.lax.broadcasted_iota(jnp.int32, (mt, md), 1)
                == best_j[:, None]
            ),
            bid[:, None],
            _NEG,
        )
        col_best = jnp.max(bid_matrix, axis=0)
        col_winner = jnp.argmax(bid_matrix, axis=0)
        has_bid = col_best > _NEG / 2

        lost = (
            jnp.zeros((mt,), bool)
            .at[jnp.where(has_bid & (c2r >= 0), c2r, mt)]
            .set(True, mode="drop")
        )
        r2c = jnp.where(lost, -1, r2c)
        r2c = r2c.at[jnp.where(has_bid, col_winner, mt)].set(
            jnp.arange(md, dtype=jnp.int32), mode="drop"
        )
        c2r = jnp.where(has_bid, col_winner, c2r).astype(jnp.int32)
        prices = jnp.where(has_bid, col_best, prices)
        return r2c, c2r, prices, it + 1

    row_to_col, _, _, _ = jax.lax.while_loop(
        cond, body, (row_to_col, col_to_row, prices, jnp.zeros((), jnp.int32))
    )
    # max_iters backstop: still-unassigned rows go to overflow.
    return jnp.where(
        (row_to_col >= 0) & (row_to_col < md), row_to_col, -1
    )
