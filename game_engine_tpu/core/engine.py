"""Batched rollout engine: scripted policy, scan-based rollouts, auto-reset.

The reference runs one room per LangGraph thread at ~4 LLM round-trips per
turn (reference: SURVEY.md §3.2); here thousands of rooms advance per fused
step under ``lax.scan``, with per-room deterministic policies drawn from the
same splitmix32 stream as policies/scripted.py (bit-identical to the oracle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from game_engine_tpu.core.state import GameState, init_state
from game_engine_tpu.core.step import _alive, make_step, splitmix32_jax
from game_engine_tpu.gamespec.mechanics import ChoiceKind
from game_engine_tpu.gamespec.tables import Lowered

_U32 = jnp.uint32
_GOLDEN = 0x9E3779B9
_MIX = 0x85EBCA6B


def scripted_actions(lowered: Lowered, state: GameState) -> jax.Array:
    """(B, P) int32 choices — vectorized twin of policies.scripted.oracle_policy.

    Uses (state.seed, state.t, player_id) as the decision-stream key; the
    engine's acceptance logic filters non-targeted/illegal emissions exactly
    like the oracle ignores them.
    """
    B, P = state.present.shape
    pid = jnp.arange(1, P + 1, dtype=jnp.uint32)[None, :]
    h0 = splitmix32_jax(state.seed * _U32(_MIX) + state.t.astype(_U32))
    h = splitmix32_jax(h0[:, None] ^ (pid * _U32(_GOLDEN)))  # (B, P)

    from game_engine_tpu.core.step import _table_select

    kind = _table_select(lowered.choice_kind, state.phase)[:, None]  # (B,1)
    kmax = _table_select(lowered.choice_max, state.phase)[:, None]
    n_present = jnp.sum(state.present, axis=1, dtype=jnp.int32)[:, None]

    # TARGET: k-th alive player with k = h % n_alive (pick_from_mask twin)
    alive = _alive(lowered, state)
    n_alive = jnp.sum(alive, axis=1, dtype=jnp.uint32)[:, None]
    k = jnp.where(n_alive > 0, h % jnp.maximum(n_alive, 1), 0).astype(jnp.int32)
    cum = jnp.cumsum(alive.astype(jnp.int32), axis=1)
    # per-chooser k over the candidate axis: hit[b, chooser, candidate]
    hit = alive[:, None, :] & (cum[:, None, :] == (k + 1)[:, :, None])
    tgt = jnp.argmax(hit, axis=2).astype(jnp.int32) + 1
    target_choice = jnp.where(n_alive > 0, tgt, 0)

    hi = jnp.where(kmax > 0, kmax, n_present).astype(jnp.uint32)
    option_choice = (1 + (h % jnp.maximum(hi, 1)).astype(jnp.int32))

    choice = jnp.where(
        kind == ChoiceKind.TARGET.value,
        target_choice,
        jnp.where(
            kind == ChoiceKind.OPTION.value,
            option_choice,
            jnp.where(kind == ChoiceKind.SUBMIT.value, 1, 0),
        ),
    )
    return jnp.where(state.present, choice, 0)


def make_rollout(lowered: Lowered, num_steps: int, auto_reset: bool = True):
    """Build rollout(state) -> (state, metrics): num_steps fused steps.

    auto_reset: finished rooms restart with a bumped seed so throughput
    benchmarks measure sustained env-steps/sec.
    """
    step = make_step(lowered)

    def rollout(state: GameState):
        def body(st: GameState, _):
            actions = scripted_actions(lowered, st)
            new = step(st, actions)
            # completions this step (under auto-reset st.done is always
            # False here, so this equals sum(new.done))
            episodes = jnp.sum((new.done & ~st.done).astype(jnp.int32))
            st = new
            if auto_reset:
                fresh = init_state_like(lowered, st)
                st = jax.tree_util.tree_map(
                    lambda n, old: jnp.where(
                        st.done.reshape((-1,) + (1,) * (old.ndim - 1)), n, old
                    ),
                    fresh,
                    st,
                )
            return st, episodes

        state, eps = jax.lax.scan(body, state, None, length=num_steps)
        return state, jnp.sum(eps)

    return rollout


def init_state_like(lowered: Lowered, state: GameState) -> GameState:
    """Fresh rooms preserving room size, with seed bumped (for auto-reset)."""
    B, P = state.present.shape
    n = jnp.sum(state.present, axis=1, dtype=jnp.int32)
    new_seed = splitmix32_jax(state.seed ^ _U32(0xDECAF000))
    return init_state(lowered, B, n, new_seed)


def compiled_rollout(lowered: Lowered, num_steps: int, auto_reset: bool = True):
    return jax.jit(make_rollout(lowered, num_steps, auto_reset), donate_argnums=(0,))


class BatchedEngine:
    """Convenience wrapper: compile once, then step/rollout batches of rooms."""

    def __init__(self, lowered: Lowered):
        self.lowered = lowered
        self.step_fn = jax.jit(make_step(lowered))
        # eager scripted_actions costs tens of ms per call at serving batch
        # sizes (hundreds of tiny op dispatches); jitted it is one fused
        # program — the interactive jax backend calls this every step
        self._bot_fn = jax.jit(
            lambda state: scripted_actions(lowered, state))
        self._rollouts: dict = {}

    def init(self, batch: int, n_players, seeds) -> GameState:
        return init_state(self.lowered, batch, n_players, seeds)

    def step(self, state: GameState, actions) -> GameState:
        return self.step_fn(state, actions)

    def bot_actions(self, state: GameState) -> jax.Array:
        return self._bot_fn(state)

    def rollout(self, state: GameState, num_steps: int, auto_reset: bool = True):
        key = (num_steps, auto_reset)
        if key not in self._rollouts:
            self._rollouts[key] = compiled_rollout(self.lowered, num_steps, auto_reset)
        return self._rollouts[key](state)

    def phase_dsl_ids(self, state: GameState) -> np.ndarray:
        return np.asarray(jnp.take(jnp.asarray(self.lowered.phase_dsl_id), state.phase))
