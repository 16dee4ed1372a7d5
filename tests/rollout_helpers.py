"""Shared assertions for the XLA auto-reset rollout (core/engine.py)."""

import jax
import numpy as np

from game_engine_tpu.core.engine import make_rollout
from game_engine_tpu.core.state import init_state


def states_equal(a, b, skip_seed=False):
    """Every GameState field bit-identical."""
    for name, fa, fb in zip(a._fields, a, b):
        if skip_seed and name == "seed":
            continue
        np.testing.assert_array_equal(
            np.asarray(fa), np.asarray(fb), err_msg=f"field {name}"
        )


def assert_batch_split_invariant(lowered, n_players, steps, batch=8,
                                 expect_episodes=True):
    """rollout(rooms) == concat(rollout(first half), rollout(second half)),
    bit for bit, episode counts included: no room's trajectory may depend
    on the batch it is stepped in (auto-reset included)."""
    roll = jax.jit(make_rollout(lowered, steps, auto_reset=True))
    seeds = np.arange(batch, dtype=np.uint32)
    half = batch // 2
    whole, eps = roll(init_state(lowered, batch, n_players, seeds))
    lo, eps_lo = roll(init_state(lowered, half, n_players, seeds[:half]))
    hi, eps_hi = roll(init_state(lowered, batch - half, n_players, seeds[half:]))
    joined = jax.tree_util.tree_map(
        lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]), lo, hi)
    states_equal(whole, joined)
    assert int(eps) == int(eps_lo) + int(eps_hi)
    if expect_episodes:
        assert int(eps) > 0, "no episode completed inside the window"
