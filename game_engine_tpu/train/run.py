"""PPO self-play training runner (BASELINE.json configs 4-5).

Usage:
    python -m game_engine_tpu.train.run --game werewolf --batch 4096 \
        --updates 200 --eval-every 25

Self-play PPO over batched rooms with periodic cross-play evaluation:
the learned policy controls one team while the scripted policy controls
the rest, in both directions — win-rate deltas against the scripted
baseline are the learning signal (zero-sum self-play rewards alone don't
show progress). Checkpoints via utils.checkpoint.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from game_engine_tpu.core.engine import init_state_like, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.core.step import make_step
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import Lowered, lower, LGameOver
from game_engine_tpu.policies import net as N
from game_engine_tpu.train.ppo import PPOConfig, actor_mask, init_training, make_train_step, team_masks
from game_engine_tpu.utils.checkpoint import save_tree
from game_engine_tpu.utils.runtime import enable_compile_cache


def make_eval(lowered: Lowered, cfg: PPOConfig, learned_side: bool, n_steps: int = 256):
    """Cross-play: learned policy for one side, scripted for the other.
    Returns jitted fn(params, state, key) -> (wins_side, done_count)."""
    step = make_step(lowered)

    def run(params, state, key):
        def body(carry, _):
            st, k = carry
            k, sk = jax.random.split(k)
            la, _, _, _ = N.sample_actions(lowered, params, st, sk, cfg.net)
            sa = scripted_actions(lowered, st)
            side = team_masks(lowered, st)
            use_learned = side if learned_side else ~side
            am = actor_mask(lowered, st)
            actions = jnp.where(am & use_learned, la, jnp.where(am, sa, 0))
            nxt = step(st, actions)
            ended = nxt.done & ~st.done
            side_won = ended & (nxt.winner == 1)  # minority team / side 1
            fresh = init_state_like(lowered, nxt)
            nxt = jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    nxt.done.reshape((-1,) + (1,) * (old.ndim - 1)), new, old
                ),
                fresh,
                nxt,
            )
            return (nxt, k), (jnp.sum(side_won), jnp.sum(ended))

        (state, _), (wins, dones) = jax.lax.scan(body, (state, key), None, length=n_steps)
        return jnp.sum(wins), jnp.sum(dones)

    return jax.jit(run)


def main(argv=None):
    """Run training; returns (params, the last printed train metrics)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--game", default="werewolf")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--players", type=int, default=6)
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=4, help="PPO epochs per rollout")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--arch", default="mlp", choices=["mlp", "deepsets", "attn"])
    ap.add_argument("--loss-chunk", type=int, default=1,
                    help="timesteps per remat chunk in the deepsets/attn "
                         "loss recompute (memory vs dispatch overhead)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-batch", type=int, default=1024)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--resume", default="", help="checkpoint path to resume params from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--league", action="store_true",
                    help="train against a pool of frozen snapshots "
                         "(prioritized opponent sampling) instead of mirror self-play")
    ap.add_argument("--league-snapshot-every", type=int, default=50)
    ap.add_argument("--no-league-anchor", dest="league_anchor",
                    action="store_false", default=True,
                    help="drop the scripted policy from the opponent pool. "
                         "With no weak anchor a long run's minority side can "
                         "RESIGN once the pool is uniformly strong "
                         "(measured: werewolf 0.69 -> 0.02 by u350)")
    ap.add_argument("--league-dir", default="",
                    help="also save each league snapshot here (for the "
                         "evaluate --matchup win-rate matrix)")
    args = ap.parse_args(argv)
    enable_compile_cache()

    lowered = lower(compile_game(load_builtin(args.game)))
    net_cfg = N.NetConfig(hidden=args.hidden, arch=args.arch)
    cfg = PPOConfig(horizon=args.horizon, epochs=args.epochs, lr=args.lr,
                    loss_chunk=args.loss_chunk, net=net_cfg)
    key = jax.random.PRNGKey(args.seed)
    params, opt_state, tx = init_training(lowered, cfg, key)
    if args.resume:
        from game_engine_tpu.utils.checkpoint import load_tree

        params = load_tree(args.resume, params)
        print(json.dumps({"event": "resume", "from": args.resume}))
    state = init_state(lowered, args.batch, args.players,
                       np.arange(args.batch, dtype=np.uint32))
    # every program the loop runs is compiled here, so the timed window
    # below holds no compilation
    t_compile = time.perf_counter()
    league = rng = league_step = anchor_step = train_step = None
    if args.league:
        from game_engine_tpu.train.league import League, make_league_train_step

        league = League(snapshot_every=args.league_snapshot_every,
                        anchor=args.league_anchor)
        league.maybe_snapshot(params)
        league_step = jax.jit(make_league_train_step(lowered, cfg, tx)).lower(
            params, params, opt_state, state, key).compile()
        if args.league_anchor:
            anchor_step = jax.jit(make_league_train_step(
                lowered, cfg, tx, scripted_opponent=True)).lower(
                params, params, opt_state, state, key).compile()
        rng = np.random.default_rng(args.seed)
    else:
        # donation keeps params/opt/state/key in place across updates
        train_step = jax.jit(make_train_step(lowered, cfg, tx),
                             donate_argnums=(0, 1, 2, 3)).lower(
            params, opt_state, state, key).compile()
    compile_s = time.perf_counter() - t_compile
    evals = {
        "learned_as_minority": make_eval(lowered, cfg, learned_side=True),
        "learned_as_majority": make_eval(lowered, cfg, learned_side=False),
    }

    def run_evals():
        if args.eval_batch <= 0:
            return {}
        out = {}
        for name, ev in evals.items():
            es = init_state(lowered, args.eval_batch, args.players,
                            np.arange(args.eval_batch, dtype=np.uint32) + 777)
            wins, dones = ev(params, es, jax.random.PRNGKey(123))
            rate = float(wins) / max(float(dones), 1.0)
            out[name] = {"minority_win_rate": round(rate, 4), "episodes": int(dones)}
        return out

    print(json.dumps({"event": "eval", "update": 0, **run_evals()}))
    t0 = None  # the steady window opens once update 1 is done
    last = {}
    for u in range(1, args.updates + 1):
        if league is not None:
            opp_idx, opp = league.sample_opponent(rng)
            if opp_idx == league.ANCHOR_ID:
                params, opt_state, state, key, metrics = anchor_step(
                    params, params, opt_state, state, key
                )
            else:
                params, opt_state, state, key, metrics = league_step(
                    params, opp, opt_state, state, key
                )
            if float(metrics["episodes"]) > 0:  # no-episode updates carry no signal
                league.record_result(opp_idx, float(metrics["learner_win_rate"]))
            if league.maybe_snapshot(params) and args.league_dir:
                import os

                os.makedirs(args.league_dir, exist_ok=True)
                save_tree(os.path.join(args.league_dir, f"snap_u{u:05d}"),
                          params, meta={"attn_heads": cfg.net.attn_heads})
            metrics = dict(metrics)
            metrics["opponent"] = opp_idx
            metrics["pool_size"] = len(league.params_pool)
        else:
            params, opt_state, state, key, metrics = train_step(params, opt_state, state, key)
        if u == 1:
            jax.block_until_ready(metrics)
            t0 = time.perf_counter()
        if u % 10 == 0 or u == args.updates:
            m = {k: round(float(v), 4) for k, v in metrics.items()}  # host sync
            # steps_per_sec: the steady rate over the updates after the first
            m.update(event="train", update=u, compile_s=round(compile_s, 3))
            if u > 1:
                m["steps_per_sec"] = round((u - 1) * args.horizon * args.batch
                                           / (time.perf_counter() - t0), 1)
            print(json.dumps(m))
            last = m
        if u % args.eval_every == 0 or u == args.updates:
            print(json.dumps({"event": "eval", "update": u, **run_evals()}))
            if args.checkpoint:
                save_tree(f"{args.checkpoint}_u{u}", params,
                          meta={"attn_heads": cfg.net.attn_heads})
    return params, last


if __name__ == "__main__":
    main()
