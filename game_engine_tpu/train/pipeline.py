"""Pipelined ("async") PPO learner: overlap rollout collection with the
PPO update by running them as two independently-dispatched device programs
with one update of parameter staleness.

A lever for the attn arch's throughput: the sync train step serializes
unroll -> GAE -> epochs in ONE program, so a chip alternates between the rollout's engine-step
kernels and the update's gradient matmuls. Here the stages become:

    actor  device: traj_{k+1} = unroll(theta_k, state_k)      (stale by 1)
    learner device: theta_{k+1} = ppo_epochs(theta_k, traj_k)

Both dispatches leave the host without blocking (jax async dispatch), so
on DIFFERENT devices they genuinely overlap; params hop learner->actor
and trajectories actor->learner as device-to-device copies each round.
The PPO ratio machinery already prices the staleness: traj_k stores the
behavior policy's log-probs, and the first epoch's clipped ratios treat
theta_k exactly as they treat any post-epoch params in the sync step.

The honest throughput algebra for an ON-DEVICE environment (the engine
IS a device program, unlike host-env RL where async hides environment
latency): with rollout time r and update time u per round,

    2-device pipeline:        1 / max(r, u)   rounds/s
    2-device data-parallel:   2 / (r + u)     rounds/s

pipeline/DP = (r+u)/(2*max(r,u)) <= 1 — equality ONLY at r == u. A
data-parallel mesh is never slower and is bit-stable (no staleness), so
the pipeline is the right tool only when DP is unavailable (e.g. two
heterogeneous chips, or a reserved inference chip that would otherwise
idle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from game_engine_tpu.gamespec.tables import Lowered
from game_engine_tpu.policies import net as N
from game_engine_tpu.train.ppo import PPOConfig, gae, make_unroll, ppo_loss


def make_pipeline(lowered: Lowered, cfg: PPOConfig,
                  tx: optax.GradientTransformation):
    """Build (collect, update) as separately-jitted programs.

    collect(params, state, key) -> (state', key', traj, last_obs)
    update(params, opt_state, traj, last_obs) -> (params', opt_state', metrics)

    Placement is NOT decided here: run_pipelined places each call by
    device_put-ing committed inputs (derive-placement-from-operands), so
    the same pair overlaps on two devices or degenerates to the sync
    split on one.
    """
    unroll = make_unroll(lowered, cfg)

    def collect(params, state, key):
        state, key, traj = unroll(params, state, key)
        # the bootstrap observation rides with the trajectory so the
        # learner program never touches engine state
        last_obs = N.observe(lowered, state).astype(jnp.bfloat16)
        return state, key, traj, last_obs

    def update(params, opt_state, traj, last_obs):
        _, last_v = N.apply_net(params, last_obs, cfg.net, lowered)
        adv, ret = gae(traj, last_v, cfg)

        def loss_fn(p):
            return ppo_loss(p, traj, adv, ret, cfg, lowered)

        loss = jnp.float32(0)
        metrics = {}
        for _ in range(cfg.epochs):
            (loss, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["episodes"] = jnp.sum(traj.done.astype(jnp.int32))
        return params, opt_state, metrics

    # placement flows from the arguments: run_pipelined commits state/params
    # to the actor device and the trajectory to the learner device with
    # device_put, and jax runs each compiled program where its (committed)
    # inputs live — no deprecated jit(device=...) needed
    return jax.jit(collect), jax.jit(update)


def run_pipelined(lowered: Lowered, cfg: PPOConfig, tx, params, opt_state,
                  state, key, n_updates: int,
                  actor_device=None, learner_device=None, pipeline=None):
    """Drive the two-stage pipeline for n_updates rounds.

    Round k dispatches collect(theta_k, ...) — producing traj_{k+1} with
    one update of staleness — and update(theta_k, traj_k) back-to-back
    WITHOUT host syncs between them: jax's async dispatch lets both
    programs be in flight at once, so on two devices they overlap. The
    host only pays the device-to-device hops (params learner->actor,
    trajectory actor->learner) each round. Returns
    (params, opt_state, state, key, last_metrics).

    Pass a prebuilt ``pipeline=(collect, update)`` to reuse compiled
    programs across calls (timing harnesses); by default the pair is
    built (and compiled) fresh."""
    collect, update = pipeline if pipeline is not None else make_pipeline(
        lowered, cfg, tx)

    def to_a(t):
        return jax.device_put(t, actor_device) if actor_device is not None else t

    def to_l(t):
        return jax.device_put(t, learner_device) if learner_device is not None else t

    a_params = to_a(params)
    state, key = to_a(state), to_a(key)
    # priming rollout: the pipeline consumes traj_k while producing
    # traj_{k+1}, so round 0 starts with one already-collected buffer
    state, key, traj, last_obs = collect(a_params, state, key)
    metrics = {}
    for _ in range(n_updates):
        # enqueue the NEXT rollout under the current (stale) actor params
        # first, then the update — neither call blocks the host, so the
        # two programs are concurrently in flight on their devices
        nxt = collect(a_params, state, key)
        params, opt_state, metrics = update(
            params, opt_state, to_l(traj), to_l(last_obs))
        a_params = to_a(params)  # theta hops learner -> actor
        state, key, traj, last_obs = nxt
    return params, opt_state, state, key, metrics


# ---------------------------------------------------------------------------
# Disaggregated submesh pipeline: the scale form of the two-device split —
# the actor half of the chips runs the environment+sampling SPMD over its
# own ('data','model') mesh while the learner half runs the PPO epochs over
# its mesh, with trajectory/parameter resharding hops between them. This is
# the on-device shape of an actor/learner service split (device-to-device
# transfers instead of a replay-buffer network); the same 1/max(r,u) vs 2/(r+u)
# algebra in the module docstring decides when it beats plain DP.
# ---------------------------------------------------------------------------


def submeshes(n_actor: int, n_learner: int) -> tuple[Mesh, Mesh]:
    """Two disjoint ('data','model') meshes over the visible devices:
    devices [0, n_actor) collect, [n_actor, n_actor+n_learner) update."""
    devs = jax.devices()
    assert n_actor + n_learner <= len(devs), (
        f"need {n_actor}+{n_learner} devices, have {len(devs)}")
    actor = Mesh(np.array(devs[:n_actor]).reshape(n_actor, 1),
                 axis_names=("data", "model"))
    learner = Mesh(
        np.array(devs[n_actor:n_actor + n_learner]).reshape(n_learner, 1),
        axis_names=("data", "model"))
    return actor, learner


def _replicated(mesh: Mesh, tree):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, P(*([None] * jnp.ndim(x))))), tree)


def _batch_sharded(mesh: Mesh, tree, batch_axis: int):
    """Shard each leaf's batch axis over the mesh's 'data' axis (axis 0 for
    engine state / bootstrap obs, axis 1 for (T, B, ...) trajectories)."""
    def put(x):
        spec = [None] * x.ndim
        spec[batch_axis] = "data"
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return jax.tree_util.tree_map(put, tree)


def run_pipelined_sharded(lowered: Lowered, cfg: PPOConfig, tx, params,
                          opt_state, state, key, n_updates: int,
                          actor_mesh: Mesh, learner_mesh: Mesh,
                          pipeline=None):
    """run_pipelined over device GROUPS: rooms shard over the actor mesh's
    'data' axis during collection; the trajectory reshards onto the learner
    mesh for the update; fresh params reshard back. Same math, same one
    update of staleness — GSPMD keeps each stage SPMD within its mesh, and
    the cross-mesh device_put is the only inter-group traffic."""
    collect, update = pipeline if pipeline is not None else make_pipeline(
        lowered, cfg, tx)
    a_params = _replicated(actor_mesh, params)
    state = _batch_sharded(actor_mesh, state, 0)
    key = _replicated(actor_mesh, key)
    params = _replicated(learner_mesh, params)
    opt_state = _replicated(learner_mesh, opt_state)

    state, key, traj, last_obs = collect(a_params, state, key)
    metrics = {}
    for _ in range(n_updates):
        nxt = collect(a_params, state, key)
        params, opt_state, metrics = update(
            params, opt_state,
            _batch_sharded(learner_mesh, traj, 1),
            _batch_sharded(learner_mesh, last_obs, 0))
        a_params = _replicated(actor_mesh, params)
        state, key, traj, last_obs = nxt
    return params, opt_state, state, key, metrics
