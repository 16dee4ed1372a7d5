"""PPO self-play over batched rooms (BASELINE.json configs 4-5).

Zero-sum terminal rewards: in team games every player whose team wins gets
+1, losers -1, paid on the episode-end step; in score games the winning
player gets +1. Only players whose action was *relevant* this step (targeted
in a player_action phase) contribute to the policy loss — everyone
contributes to the value loss.

The train step is one jitted program: unroll T env steps with the learned
policy (lax.scan), compute GAE, one clipped-PPO update. Rooms shard over the
'data' mesh axis, hidden layers over 'model' (see parallel/mesh.py); under
pjit/GSPMD the gradient all-reduce and activation collectives are inserted
automatically.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
import optax

from game_engine_tpu.core.engine import init_state_like
from game_engine_tpu.core.state import GameState
from game_engine_tpu.core.step import PredEval, make_step
from game_engine_tpu.gamespec.tables import Lowered, LGameOver
from game_engine_tpu.policies import net as N


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    horizon: int = 32
    epochs: int = 4  # PPO epochs over each rollout (ratios move after ep 1)
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    # timesteps recomputed per remat chunk in the deepsets/attn loss (the
    # set-encoder activations are too big to hold for the whole horizon;
    # chunk>1 trades peak memory for fewer, larger kernels)
    loss_chunk: int = 1
    # remat policy for the chunked recompute: 'full' recomputes everything
    # in the backward pass (minimum memory); 'dots' saves matmul outputs
    # (jax.checkpoint_policies.checkpoint_dots) so the backward pass skips
    # re-running the encoder contractions at the cost of holding one
    # chunk's activations
    remat: str = "full"
    net: N.NetConfig = dataclasses.field(default_factory=N.NetConfig)


def _game_over_mech(lowered: Lowered) -> LGameOver | None:
    return lowered.game_overs[0] if lowered.game_overs else None


def terminal_rewards(lowered: Lowered, state: GameState, ended: jax.Array) -> jax.Array:
    """(B, P) float32 rewards paid on the step an episode ends."""
    go = _game_over_mech(lowered)
    B, P = state.present.shape
    if go is None:
        return jnp.zeros((B, P), jnp.float32)
    if go.mode == "team" and go.team_str_slot >= 0 and go.team_codes:
        team = state.strs[..., go.team_str_slot]
        # unrolled select over the tiny static table, not a jnp.take: a
        # dynamic gather in the rollout scan's hot path (invariant 3)
        from game_engine_tpu.core.step import _table_select

        win_code = _table_select(
            np.asarray(go.team_codes, np.int32),
            jnp.clip(state.winner - 1, 0, len(go.team_codes) - 1))
        r = jnp.where(team == win_code[:, None], 1.0, -1.0)
    elif go.mode == "score":
        pidx = jnp.arange(1, P + 1, dtype=jnp.int32)[None, :]
        # zero-sum per room: losers split -1 across the room's actual seats
        n = jnp.sum(state.present, axis=1, dtype=jnp.float32)[:, None]
        r = jnp.where(pidx == state.winner[:, None], 1.0, -1.0 / jnp.maximum(n - 1, 1))
    else:
        r = jnp.zeros((B, P), jnp.float32)
    return jnp.where(ended[:, None] & state.present, r, 0.0)


def actor_mask(lowered: Lowered, state: GameState) -> jax.Array:
    """(B, P) — players whose decision this step is policy-relevant."""
    from game_engine_tpu.core.step import _table_select

    pe = PredEval(lowered, state)
    target = jnp.zeros(state.present.shape, bool)
    by_pred: dict[int, list[int]] = {}
    for i, pi in enumerate(lowered.phase_target_pred):
        by_pred.setdefault(int(pi), []).append(i)
    for pi, phase_idxs in by_pred.items():
        hit = jnp.zeros(state.phase.shape, bool)
        for i in phase_idxs:
            hit = hit | (state.phase == i)
        target = jnp.where(hit[:, None], pe.pred(pi), target)
    is_action = _table_select(lowered.phase_is_action.astype(int), state.phase)[:, None] != 0
    return target & state.present & is_action & ~state.acted & ~state.done[:, None]


class Rollout(NamedTuple):
    obs: jax.Array  # (T, B, P, F)
    actions: jax.Array  # (T, B, P) 1-based
    logp: jax.Array  # (T, B, P)
    value: jax.Array  # (T, B, P)
    reward: jax.Array  # (T, B, P)
    done: jax.Array  # (T, B) episode ended at this step
    mask: jax.Array  # (T, B, P) actor mask
    legal: jax.Array  # (T, B, P, A) legal-action mask used at sampling


def make_unroll(lowered: Lowered, cfg: PPOConfig):
    step = make_step(lowered)

    def unroll(params, state: GameState, key):
        def body(carry, _):
            st, k = carry
            k, sk = jax.random.split(k)
            # bf16 storage: apply_net consumes bf16 anyway; halves the
            # rollout buffer (the dominant HBM cost at 16k+ rooms)
            obs = N.observe(lowered, st).astype(jnp.bfloat16)
            a, logp, v, legal = N.sample_actions(lowered, params, st, sk, cfg.net,
                                                 obs=obs)
            mask = actor_mask(lowered, st)
            actions = jnp.where(mask, a, 0)
            nxt = step(st, actions)
            ended = nxt.done & ~st.done
            reward = terminal_rewards(lowered, nxt, ended)
            fresh = init_state_like(lowered, nxt)
            nxt = jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    nxt.done.reshape((-1,) + (1,) * (old.ndim - 1)), new, old
                ),
                fresh,
                nxt,
            )
            return (nxt, k), Rollout(obs, actions, logp, v, reward, ended, mask, legal)

        (state, key), traj = jax.lax.scan(body, (state, key), None, length=cfg.horizon)
        return state, key, traj

    return unroll


def gae(traj: Rollout, last_value: jax.Array, cfg: PPOConfig):
    """(T, B, P) advantages + returns; bootstrap cut at episode ends."""

    def body(carry, x):
        adv_next, v_next = carry
        v, r, ended = x
        nonterm = 1.0 - ended[:, None].astype(jnp.float32)
        delta = r + cfg.gamma * v_next * nonterm - v
        adv = delta + cfg.gamma * cfg.lam * nonterm * adv_next
        return (adv, v), adv

    (_, _), advs = jax.lax.scan(
        body,
        (jnp.zeros_like(last_value), last_value),
        (traj.value, traj.reward, traj.done),
        reverse=True,
    )
    return advs, advs + traj.value


def ppo_loss(params, traj: Rollout, adv, ret, cfg: PPOConfig,
             lowered: Lowered | None = None):
    """Clipped-PPO loss shared by mirror self-play and league training."""
    if cfg.net.arch in ("deepsets", "attn"):
        # chunk the recompute over T with remat inside: the set encoder's
        # (T, B, P, P, hp) phi activations would otherwise be held (or
        # rematerialized whole) for the backward pass — 8 GB at 16k rooms.
        # lax.map + checkpoint keeps the peak at one timestep's worth.
        pol = (jax.checkpoint_policies.checkpoint_dots
               if cfg.remat == "dots" else None)
        inner = jax.checkpoint(
            lambda o: N.apply_net(params, o, cfg.net, lowered), policy=pol)
        T = traj.obs.shape[0]
        C = max(1, min(cfg.loss_chunk, T))
        while T % C:  # largest divisor of T not above the requested chunk
            C -= 1
        if C > 1:
            obs_c = traj.obs.reshape((T // C, C) + traj.obs.shape[1:])
            logits, value = jax.lax.map(inner, obs_c)
            logits = logits.reshape((T,) + logits.shape[2:])
            value = value.reshape((T,) + value.shape[2:])
        else:
            logits, value = jax.lax.map(inner, traj.obs)
    else:
        logits, value = N.apply_net(params, traj.obs, cfg.net, lowered)
    # the same legal-action masking as at sampling time — without it the
    # recomputed log-probs (and hence PPO ratios) are wrong
    logits = jnp.where(traj.legal, logits, jnp.float32(-1e9))
    logp_all = jax.nn.log_softmax(logits, axis=-1)
    a_idx = jnp.clip(traj.actions - 1, 0, logits.shape[-1] - 1)
    # one-hot contraction, not take_along_axis: the same no-gather rule
    # as the engine's player-axis selects (CLAUDE.md invariant 3); whether
    # a gather is cheaper on the GPU is an open measurement (ROADMAP)
    aoh = jax.nn.one_hot(a_idx, logits.shape[-1], dtype=logp_all.dtype)
    logp = jnp.sum(logp_all * aoh, axis=-1)
    ratio = jnp.exp(logp - traj.logp)

    m = traj.mask.astype(jnp.float32)
    msum = jnp.maximum(jnp.sum(m), 1.0)
    mean = jnp.sum(adv * m) / msum
    adv_n = (adv - mean) / (jnp.sqrt(jnp.sum(m * (adv - mean) ** 2) / msum) + 1e-8)
    pg = -jnp.minimum(
        ratio * adv_n, jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv_n
    )
    pg_loss = jnp.sum(pg * m) / msum
    v_loss = 0.5 * jnp.mean((value - ret) ** 2)
    ent = -jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1)
    ent_loss = -jnp.sum(ent * m) / msum
    total = pg_loss + cfg.vf_coef * v_loss + cfg.ent_coef * ent_loss
    return total, {
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": -ent_loss,
        "ratio_mean": jnp.sum(ratio * m) / msum,
    }


def team_masks(lowered: Lowered, state) -> jax.Array:
    """(B, P) — the 'protagonist' side for cross-play eval: the minority
    ('evil') team, speakers for speaker games, or SEAT 1 in free-for-all
    score games (auction/market FFAs have no teams; the meaningful
    cross-play question is 'does the learned seat beat a scripted field',
    and winner==1 is exactly seat 1's victory in score mode)."""
    go = next(iter(lowered.game_overs), None)
    if go is not None and go.mode == "team" and go.team_codes:
        return state.strs[..., go.team_str_slot] == go.team_codes[0]
    if lowered.game.layout.get("is_speaker") is not None:
        slot = lowered.game.layout.bool_index("is_speaker")
        return state.bools[..., slot]
    P = state.present.shape[1]
    seat1 = jnp.arange(P, dtype=jnp.int32)[None, :] == 0
    return jnp.broadcast_to(seat1, state.present.shape) & state.present


def make_train_step(lowered: Lowered, cfg: PPOConfig, tx: optax.GradientTransformation):
    unroll = make_unroll(lowered, cfg)

    def loss_fn(params, traj, adv, ret):
        return ppo_loss(params, traj, adv, ret, cfg, lowered)

    def train_step(params, opt_state, state: GameState, key):
        state, key, traj = unroll(params, state, key)
        _, last_v = N.apply_net(params, N.observe(lowered, state), cfg.net, lowered)
        adv, ret = gae(traj, last_v, cfg)
        loss, metrics = jnp.float32(0.0), {}  # epochs=0: rollout-only run
        for _ in range(cfg.epochs):
            (loss, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, traj, adv, ret)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["reward_per_step"] = jnp.mean(jnp.sum(traj.reward, axis=-1))
        metrics["episodes"] = jnp.sum(traj.done.astype(jnp.int32))
        return params, opt_state, state, key, metrics

    return train_step


def init_training(lowered: Lowered, cfg: PPOConfig, key):
    in_dim = N.obs_dim(lowered)
    n_actions = N.action_space(lowered)
    params = N.init_params(key, in_dim, n_actions, cfg.net, lowered)
    tx = optax.adam(cfg.lr)
    opt_state = tx.init(params)
    return params, opt_state, tx
