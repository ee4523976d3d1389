"""Device-side compaction of chain-DP path emissions.

Turns the sparse [W+1, blocks, K] emission grids of
``device_chain.chain_matches`` into flat path arrays (fixed budget) without
leaving the device — the glue that keeps the device-taxonomer composition
on-chip (cumsum + scatter, same pattern as the match compaction in
classify/pipeline.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

INT32_MAX = np.int32(2**31 - 1)  # np literal: a module-level jax scalar takes the first shard_map mesh into its cached aval and poisons later traces under a different mesh


class FlatPaths(NamedTuple):
    read: jax.Array     # [P] int32 (INT32_MAX padding)
    species: jax.Array  # [P] int32
    start: jax.Array    # [P] int32
    end: jax.Array      # [P] int32
    score: jax.Array    # [P] float32
    ham: jax.Array      # [P] int32
    sh16: jax.Array     # [P] int32
    eh16: jax.Array     # [P] int32
    valid: jax.Array    # [P] bool
    n_paths: jax.Array  # [] int32 (may exceed P: overflow signal)


@functools.partial(jax.jit, static_argnames=("budget",))
def compact_paths(chain_result, *, budget: int) -> FlatPaths:
    res = chain_result
    em = res.emit_mask  # [W1, K, NB] (block axis minor, see device_chain)
    w1, k, nb = em.shape
    flat = em.reshape(-1)
    n_paths = jnp.sum(flat.astype(jnp.int32))
    # partition sort: (emitted ? slot : MAX) moves emitted slots to the
    # front in slot order — byte-identical to a stable scatter compaction
    # (same pattern as pipeline._classify_core)
    slot = jnp.arange(w1 * nb * k, dtype=jnp.int32)
    rows = jax.lax.sort(jnp.where(flat, slot, INT32_MAX))
    if rows.shape[0] < budget:  # budget may exceed the grid capacity
        rows = jnp.pad(rows, (0, budget - rows.shape[0]),
                       constant_values=2**31 - 1)
    rows = rows[:budget]
    pad = rows == INT32_MAX
    safe = jnp.minimum(rows, w1 * nb * k - 1)
    b_idx = safe % nb

    def take(grid, fill):
        v = grid.reshape(-1)[safe]
        return jnp.where(pad, fill, v)

    return FlatPaths(
        read=jnp.where(pad, INT32_MAX, res.block_read[b_idx]),
        species=jnp.where(pad, INT32_MAX, res.block_species[b_idx]),
        start=take(res.start, 0),
        end=take(res.end, -1),
        score=take(res.score, jnp.float32(0)),
        ham=take(res.hamming, 0),
        sh16=take(res.start_h16, 0),
        eh16=take(res.end_h16, 0),
        valid=~pad,
        n_paths=n_paths,
    )


class FlatGroups(NamedTuple):
    read: jax.Array     # [G] int32 (INT32_MAX padding)
    species: jax.Array  # [G] int32
    score: jax.Array    # [G] float32
    n_groups: jax.Array # [] int32


@functools.partial(jax.jit, static_argnames=("budget",))
def compact_groups(comb_result, *, budget: int) -> FlatGroups:
    """Compact CombineResult's valid groups to a small fixed budget."""
    ok = comb_result.group_valid
    n = ok.shape[0]
    pos = jnp.cumsum(ok.astype(jnp.int32)) - 1
    n_groups = pos[-1] + 1
    scatter_idx = jnp.where(ok & (pos < budget), pos, jnp.int32(budget))
    rows = (
        jnp.full(budget, n, jnp.int32)
        .at[scatter_idx]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    )
    pad = rows >= n
    safe = jnp.minimum(rows, n - 1)
    return FlatGroups(
        read=jnp.where(pad, INT32_MAX, comb_result.group_read[safe]),
        species=jnp.where(pad, INT32_MAX, comb_result.group_species[safe]),
        score=jnp.where(pad, jnp.float32(0), comb_result.score[safe]),
        n_groups=n_groups,
    )
