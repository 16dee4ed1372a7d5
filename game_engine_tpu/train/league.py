"""League self-play: checkpoint pool + opponent sampling (BASELINE config 5).

The learner trains against a pool of frozen past snapshots instead of pure
mirror self-play — the standard league recipe to avoid strategy collapse.
Per update: an opponent is sampled from the pool (uniform over recent K),
rooms are split so the learner controls the minority team in even rooms and
the majority team in odd rooms (so both sides are learned), and only
learner-controlled seats contribute to the policy loss. Snapshots join the
pool on a fixed cadence; a win-rate EMA per snapshot drives prioritized
sampling (losing opponents are sampled more).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from game_engine_tpu.core.engine import init_state_like, scripted_actions
from game_engine_tpu.core.state import GameState
from game_engine_tpu.core.step import make_step
from game_engine_tpu.gamespec.tables import Lowered
from game_engine_tpu.policies import net as N
from game_engine_tpu.train.ppo import (
    PPOConfig,
    Rollout,
    actor_mask,
    gae,
    team_masks,
    terminal_rewards,
)



@dataclasses.dataclass
class League:
    """Host-side snapshot pool with prioritized opponent sampling.

    Snapshots carry STABLE monotonically-assigned ids: once the pool is
    full, every snapshot evicts the oldest entry, so raw list positions
    shift under the caller — sample_opponent therefore hands back the id,
    and record_result resolves by id (a result for an already-evicted
    snapshot is dropped, never misapplied to a shifted neighbor)."""

    ANCHOR_ID = -1  # the scripted baseline's permanent pool id

    max_size: int = 8
    snapshot_every: int = 50
    # keep the SCRIPTED policy in the pool as a permanent weak anchor.
    # Measured in an earlier 600-update werewolf run: a snapshot-only pool converges to
    # uniformly-strong copies of the learner's own majority play, minority
    # rooms become hopeless, and the minority side RESIGNS (werewolf
    # learned-as-minority 0.69 -> 0.02 between u300 and u350, episodes
    # shortening, entropy 0.81 -> 0.41). The anchor is self-balancing:
    # resignation tanks the learner's winrate vs scripted, which raises
    # the anchor's sampling weight and restores the recovery gradient.
    anchor: bool = True
    pool: list = dataclasses.field(default_factory=list)  # {id, params, winrate}
    _updates: int = 0
    _next_id: int = 0
    _anchor_winrate: float = 0.5

    @property
    def params_pool(self) -> list:
        return [e["params"] for e in self.pool]

    @property
    def learner_winrate(self) -> list:
        return [e["winrate"] for e in self.pool]

    def ids(self) -> list:
        return [e["id"] for e in self.pool]

    def maybe_snapshot(self, params) -> bool:
        self._updates += 1
        if (self._updates - 1) % self.snapshot_every == 0:
            self.pool.append({
                "id": self._next_id,
                "params": jax.tree_util.tree_map(jnp.copy, params),
                "winrate": 0.5,  # EMA of learner win-rate (sample losers more)
            })
            self._next_id += 1
            if len(self.pool) > self.max_size:
                self.pool.pop(0)
            return True
        return False

    def sample_opponent(self, rng: np.random.Generator) -> tuple[int, Any]:
        """Returns (id, params); (ANCHOR_ID, None) means the scripted anchor."""
        assert self.pool, "snapshot before sampling"
        # prioritize opponents the learner loses to
        w = [max(1e-3, 1.0 - e["winrate"]) for e in self.pool]
        ids = [(e["id"], e["params"]) for e in self.pool]
        if self.anchor:
            w.append(max(1e-3, 1.0 - self._anchor_winrate))
            ids.append((self.ANCHOR_ID, None))
        w = np.asarray(w)
        pos = int(rng.choice(len(w), p=w / w.sum()))
        return ids[pos]

    def record_result(self, sid: int, learner_win_rate: float, ema: float = 0.1) -> None:
        if sid == self.ANCHOR_ID:
            self._anchor_winrate = ((1 - ema) * self._anchor_winrate
                                    + ema * learner_win_rate)
            return
        for e in self.pool:
            if e["id"] == sid:
                e["winrate"] = (1 - ema) * e["winrate"] + ema * learner_win_rate
                return
        # snapshot evicted between sampling and recording — drop the stale
        # result rather than shifting it onto a neighbor


def make_league_train_step(lowered: Lowered, cfg: PPOConfig, tx: optax.GradientTransformation,
                           scripted_opponent: bool = False):
    """One league update: unroll vs a frozen opponent, PPO on learner seats.

    Returns train_step(params, opp_params, opt_state, state, key) ->
    (params, opt_state, state, key, metrics) — metrics include the
    learner's episode win-rate for pool bookkeeping. With
    `scripted_opponent`, opponent seats play the deterministic scripted
    policy and `opp_params` is ignored (the League.anchor arm — compile
    this as a SECOND jitted program alongside the snapshot one).
    """
    step = make_step(lowered)

    def learner_controls(state: GameState) -> jax.Array:
        """(B, P): even rooms -> learner plays the minority side."""
        B = state.present.shape[0]
        side = team_masks(lowered, state)  # (B, P) minority-team members
        even = (jnp.arange(B, dtype=jnp.int32) % 2 == 0)[:, None]
        return jnp.where(even, side, ~side) & state.present

    def unroll(params, opp_params, state, key):
        def body(carry, _):
            st, k = carry
            k, sk1, sk2 = jax.random.split(k, 3)
            obs = N.observe(lowered, st).astype(jnp.bfloat16)
            a, logp, v, legal = N.sample_actions(lowered, params, st, sk1, cfg.net,
                                                 obs=obs)
            if scripted_opponent:
                oa = scripted_actions(lowered, st)
            else:
                oa, _, _, _ = N.sample_actions(lowered, opp_params, st, sk2, cfg.net,
                                               obs=obs)
            ctrl = learner_controls(st)
            am = actor_mask(lowered, st)
            actions = jnp.where(am & ctrl, a, jnp.where(am, oa, 0))
            nxt = step(st, actions)
            ended = nxt.done & ~st.done
            reward = terminal_rewards(lowered, nxt, ended)
            # learner's win: any learner-controlled seat got +1 at episode end
            learner_won = ended & jnp.any(ctrl & (reward > 0), axis=1)
            fresh = init_state_like(lowered, nxt)
            nxt = jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    nxt.done.reshape((-1,) + (1,) * (old.ndim - 1)), new, old
                ),
                fresh,
                nxt,
            )
            traj = Rollout(obs, actions, logp, v, reward, ended, am & ctrl, legal)
            return (nxt, k), (traj, learner_won)

        (state, key), (traj, won) = jax.lax.scan(body, (state, key), None, length=cfg.horizon)
        return state, key, traj, won

    def loss_fn(params, traj: Rollout, adv, ret):
        from game_engine_tpu.train.ppo import ppo_loss

        total, metrics = ppo_loss(params, traj, adv, ret, cfg, lowered)
        return total, (metrics["v_loss"], metrics["entropy"])

    def train_step(params, opp_params, opt_state, state, key):
        state, key, traj, won = unroll(params, opp_params, state, key)
        _, last_v = N.apply_net(params, N.observe(lowered, state), cfg.net, lowered)
        adv, ret = gae(traj, last_v, cfg)
        loss = v_loss = entropy = jnp.float32(0)
        for _ in range(cfg.epochs):
            (loss, (v_loss, entropy)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, traj, adv, ret)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        episodes = jnp.sum(traj.done.astype(jnp.int32))
        wins = jnp.sum(won.astype(jnp.int32))
        metrics = {
            "loss": loss,
            "v_loss": v_loss,
            "entropy": entropy,
            "episodes": episodes,
            "learner_win_rate": wins / jnp.maximum(episodes, 1),
        }
        return params, opt_state, state, key, metrics

    return train_step
