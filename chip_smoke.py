#!/usr/bin/env python
"""Bring-up check on an NVIDIA GPU: the engine, the trainer and the room
server run through the entry points a user calls, at the sizes users run,
and their results are checked against the repo's references.

    python chip_smoke.py               # every one-card phase, one GPU
    python chip_smoke.py --four-cards  # only the four-card phase, four GPUs

One-card phases (any failure exits non-zero; nothing falls back to the CPU):
  1 device gate    JAX's default backend must be a GPU.
  2 engine         werewolf 4096 rooms x 1024 steps through
                   core.engine.compiled_rollout (auto-reset), bit-identical
                   to the C++ simulator on every room; every games/*.yaml at
                   256 rooms likewise. Integer state: tolerance zero.
  3 policy         bench.py's --policy path at 16,384 rooms, hidden 256.
  4 trainer        train.run.main(): attn, attn --league, deepsets at 16,384
                   rooms x horizon 16; losses finite.
  5 net reference  policies.net.apply_net and the ppo_loss gradient on the
                   card vs the same params on the CPU at float32 "highest".
  6 served rooms   server.api.make_server(backend="jax") with a learned
                   werewolf bot and the chat LM, played over HTTP to a
                   winner, then one room restored from its journal.
  7 driver entry   __graft_entry__.entry(), jitted on the card.

The four-card phase shards a 16,384-room scripted rollout over
parallel.mesh.make_mesh(4) (bit-identical to one card); the ppo_loss value
and gradient on one fixed 16,384-room trajectory over data=4 and over a 2x2
data x model mesh (within FOUR_CARD_TOL of one card); and one whole league
update on each mesh (finite, rooms spread over every card).

Prints the card's name and power limit, the JAX version, every phase's
compile seconds and steady rate (a warmed-up window ended by
block_until_ready), the largest step's memory analysis, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from game_engine_tpu.utils.runtime import (
    REPO_ROOT,
    device_info,
    enable_compile_cache,
    require_gpu,
)

# Published peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit).
# A GPU not listed here is an error, not a default.
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                                   "bf16_flops_per_s": 989e12}}

SINGLE_CARD_PHASES = ("device_gate", "engine", "policy", "trainer",
                      "net_reference", "served_rooms", "driver_entry")

# Phase 5 tolerances. The net rounds its activations to bf16 (one rounding
# step is 2^-8 = 0.4% relative) around float32-accumulated dots, so any
# other correct evaluation (another accumulation order, other exp/tanh/rsqrt
# approximations) flips some roundings and lands a little off. How far
# depends on the arch: the attn block amplifies such flips more than the
# others. So each tolerance is measured in the same run: the noise floor is
# how far the CPU reference itself moves when every param is perturbed by a
# relative NOISE_REL (~8 float32 ulps, the size of an accumulation-order
# difference in a sum of a few hundred terms), the larger of two draws; the
# card may deviate by NOISE_FACTOR floors, and never less than MIN_TOL.
# The max errors catch one gross outlier; the rms errors a small error in
# every row.
NOISE_REL = 1e-6
NOISE_FACTOR = 4.0
MIN_TOL = {"logits_err": 2e-3,  # max |card - ref| / max(1, max |ref|)
           "value_err": 2e-3,
           "logits_rms": 1e-4,  # rms(card - ref) / rms(ref)
           "value_rms": 1e-4,
           "loss_err": 1e-5,    # |card - ref| / max(1, |ref|)
           "grad_err": 1e-2}    # max over params of ||card - ref|| / ||ref||
GREEDY_MIN = 0.95  # argmax agreement where the reference has one best action

# Four cards: the ppo_loss value and gradient on one fixed trajectory,
# sharded vs one card. Only the order of the reductions differs (the batch
# sum is split over cards, and over 'model' the hidden dots too), so both
# agree to float32 rounding amplified by a few bf16 flips: about 1e-4. A
# sharded loss that saw only part of the batch is off by tens of percent.
FOUR_CARD_TOL = {"loss_err": 1e-4,  # |sharded - one| / max(1, |one|)
                 "grad_err": 1e-2}  # ||sharded - one|| / ||one||, all params


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def _now() -> float:
    return time.perf_counter()


def _lowered(game: str):
    from game_engine_tpu.gamespec.compile import compile_game
    from game_engine_tpu.gamespec.parser import load_builtin
    from game_engine_tpu.gamespec.tables import lower

    return lower(compile_game(load_builtin(game)))


def _memory(compiled) -> dict:
    """compiled.memory_analysis() as a dict of byte counts."""
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def _catalog_games() -> list[str]:
    from game_engine_tpu.gamespec.parser import games_dir

    return sorted(fn[:-5] for fn in os.listdir(games_dir())
                  if fn.endswith(".yaml"))


# ---------------------------------------------------------------------------
# 2. engine parity
# ---------------------------------------------------------------------------


def _check_rows(game: str, jax_state, cpp_rows: np.ndarray) -> None:
    from game_engine_tpu.native import state_rows

    rows = state_rows(jax_state)
    if rows.shape != cpp_rows.shape:
        raise AssertionError(f"{game}: state layout {rows.shape} vs C++ "
                             f"{cpp_rows.shape}")
    bad = np.nonzero(np.any(rows != cpp_rows, axis=1))[0]
    if bad.size:
        raise AssertionError(f"{game}: {bad.size} of {len(rows)} rooms differ "
                             f"from the C++ simulator (first: room {bad[0]})")


def phase_engine(rooms: int = 4096, steps: int = 1024, iters: int = 3,
                 catalog_rooms: int = 256, catalog_steps: int = 256,
                 games: list[str] | None = None) -> dict:
    """The scripted auto-reset rollout (bench.py's path) against the C++
    simulator's batched self-play, every room's final state bit for bit."""
    from game_engine_tpu.core.engine import compiled_rollout
    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.native import CppGame, available

    if not available():
        raise RuntimeError("the C++ simulator did not build (g++)")
    lowered = _lowered("werewolf")
    n = 8
    seeds = np.arange(rooms, dtype=np.uint32)
    roll = compiled_rollout(lowered, steps, auto_reset=True)
    t0 = _now()
    compiled = roll.lower(init_state(lowered, rooms, n, seeds)).compile()
    compile_s = _now() - t0
    state, eps = compiled(init_state(lowered, rooms, n, seeds))
    jax.block_until_ready(state)
    t0 = _now()
    cpp_eps, cpp_rows = CppGame(lowered).selfplay_states(rooms, n, 0, steps)
    cpp_s = _now() - t0
    _check_rows("werewolf", state, cpp_rows)
    if int(eps) != cpp_eps or cpp_eps <= 0:
        raise AssertionError(f"werewolf episodes {int(eps)} vs C++ {cpp_eps}")
    t0 = _now()
    for _ in range(iters):
        state, eps = compiled(state)
    jax.block_until_ready(state)
    dt = _now() - t0
    out = {"rooms": rooms, "steps": steps, "episodes": cpp_eps,
           "compile_s": round(compile_s, 3),
           "env_steps_per_s": rooms * steps * iters / dt,
           "cpp_env_steps_per_s": rooms * steps / cpp_s,
           "memory": _memory(compiled), "rooms_bit_identical": rooms}
    log("engine", game="werewolf", **out)

    # the catalog: trace each rollout here, compile them side by side
    names = _catalog_games() if games is None else list(games)
    built = []
    for name in names:
        lw = _lowered(name)
        cseeds = np.arange(catalog_rooms, dtype=np.uint32)
        st = init_state(lw, catalog_rooms, lw.P, cseeds)
        built.append((name, lw, compiled_rollout(lw, catalog_steps).lower(st)))
    t0 = _now()
    with ThreadPoolExecutor(max_workers=8) as ex:
        execs = list(ex.map(lambda b: b[2].compile(), built))
    catalog_compile_s = _now() - t0
    episodes = {}
    for (name, lw, _), ex_ in zip(built, execs):
        cseeds = np.arange(catalog_rooms, dtype=np.uint32)
        st, ceps = ex_(init_state(lw, catalog_rooms, lw.P, cseeds))
        c_eps, c_rows = CppGame(lw).selfplay_states(
            catalog_rooms, lw.P, 0, catalog_steps)
        _check_rows(name, st, c_rows)
        if int(ceps) != c_eps:
            raise AssertionError(f"{name}: episodes {int(ceps)} vs C++ {c_eps}")
        episodes[name] = c_eps
    log("engine", catalog_games=len(names), rooms=catalog_rooms,
        steps=catalog_steps, compile_s=round(catalog_compile_s, 3),
        episodes=episodes, rooms_bit_identical=catalog_rooms * len(names))
    return out


# ---------------------------------------------------------------------------
# 3. policy in the loop
# ---------------------------------------------------------------------------


def phase_policy(rooms: int = 16384, hidden: int = 256, inner_steps: int = 128,
                 iters: int = 3) -> dict:
    """bench.py --policy: observe -> net -> legal sampling -> step -> reset."""
    import bench

    roll, state, key = bench.make_policy_rollout(rooms, inner_steps, hidden)
    t0 = _now()
    compiled = roll.lower(state, key).compile()
    compile_s = _now() - t0
    state, key, eps = compiled(state, key)
    total = int(eps)
    t0 = _now()
    for _ in range(iters):
        state, key, eps = compiled(state, key)
    jax.block_until_ready(eps)
    dt = _now() - t0
    total += int(eps)
    if total <= 0:
        raise AssertionError("policy rollout completed no episode")
    out = {"rooms": rooms, "hidden": hidden, "inner_steps": inner_steps,
           "compile_s": round(compile_s, 3),
           "env_steps_per_s": rooms * inner_steps * iters / dt,
           "episodes_last_window": int(eps), "memory": _memory(compiled)}
    log("policy", **out)
    return out


# ---------------------------------------------------------------------------
# 4. trainer
# ---------------------------------------------------------------------------


def phase_trainer(batch: int = 16384, hidden: int = 256, horizon: int = 16,
                  epochs: int = 2, updates: int = 3, eval_batch: int = 1024,
                  players: int = 8) -> dict:
    """python -m game_engine_tpu.train.run, through main(argv)."""
    from game_engine_tpu.train import run
    from game_engine_tpu.train.ppo import PPOConfig, init_training, make_train_step
    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.policies import net as N

    base = ["--batch", str(batch), "--hidden", str(hidden), "--horizon",
            str(horizon), "--epochs", str(epochs), "--players", str(players)]
    runs = [
        ("attn", base + ["--arch", "attn", "--updates", str(updates),
                         "--eval-batch", str(eval_batch),
                         "--eval-every", str(updates)]),
        ("attn_league", base + ["--arch", "attn", "--league", "--updates",
                                str(updates), "--eval-batch", "0"]),
        ("deepsets", base + ["--arch", "deepsets", "--updates", "2",
                             "--eval-batch", "0"]),
    ]
    results = {}
    for name, argv in runs:
        _params, last = run.main(argv)
        loss = last.get("loss")
        if loss is None or not np.isfinite(loss):
            raise AssertionError(f"trainer {name}: loss {loss!r} not finite")
        results[name] = {"loss": loss, "compile_s": last["compile_s"],
                         "train_env_steps_per_s": last.get("steps_per_sec")}
        log("trainer", run=name, batch=batch, hidden=hidden, horizon=horizon,
            epochs=epochs, **results[name])

    for arch in ("attn", "deepsets"):
        set_encoder_roofline(arch, batch, hidden, players,
                             results[arch]["train_env_steps_per_s"]
                             if arch in results else None)

    # memory of the largest step (the attn update); the persistent compile
    # cache already holds this program from the run above
    lowered = _lowered("werewolf")
    cfg = PPOConfig(horizon=horizon, epochs=epochs,
                    net=N.NetConfig(hidden=hidden, arch="attn"))
    params, opt_state, tx = init_training(lowered, cfg, jax.random.PRNGKey(0))
    state = init_state(lowered, batch, players,
                       np.arange(batch, dtype=np.uint32))
    step = jax.jit(make_train_step(lowered, cfg, tx), donate_argnums=(0, 1, 2, 3))
    t0 = _now()
    compiled = step.lower(params, opt_state, state,
                          jax.random.PRNGKey(0)).compile()
    log("trainer", largest_step="attn train_step",
        compile_or_cache_s=round(_now() - t0, 3), memory=_memory(compiled))
    return results


def set_encoder_roofline(arch: str, batch: int, hidden: int, players: int,
                         train_rate, iters: int = 10) -> dict:
    """One timestep of the PPO loss's inner step, the rematerialized
    deepsets/attn forward + backward over (batch, players) viewers, each
    encoding (players, hp) targets: XLA's own FLOP and byte counts for the
    compiled program (no loops in it), its time on the card, and its share
    of the card's HBM and bf16 bounds."""
    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.policies import net as N
    from game_engine_tpu.train.ppo import PPOConfig, init_training

    lowered = _lowered("werewolf")
    cfg = PPOConfig(net=N.NetConfig(hidden=hidden, arch=arch))
    params, _, _ = init_training(lowered, cfg, jax.random.PRNGKey(0))
    state = init_state(lowered, batch, players,
                       np.arange(batch, dtype=np.uint32))
    obs = N.observe(lowered, state).astype(jnp.bfloat16)

    def step(p, o):
        def out(q):
            logits, value = jax.checkpoint(
                lambda x: N.apply_net(q, x, cfg.net, lowered))(o)
            return jnp.sum(logits) + jnp.sum(value)
        return jax.grad(out)(p)

    compiled = jax.jit(step).lower(params, obs).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    flops, nbytes = float(cost["flops"]), float(cost["bytes accessed"])
    jax.block_until_ready(compiled(params, obs))
    t0 = _now()
    for _ in range(iters):
        g = compiled(params, obs)
    jax.block_until_ready(g)
    dt = (_now() - t0) / iters
    out = {"arch": arch, "viewers": batch * players, "hp": max(32, hidden // 2),
           "flops": flops, "bytes_accessed": nbytes, "seconds": dt,
           "hbm_share": None, "bf16_share": None}
    info = device_info()
    if info["platform"] == "gpu":
        if info["kind"] not in PEAKS:
            raise KeyError(f"no published peaks for {info['kind']!r}")
        peak = PEAKS[info["kind"]]
        out["hbm_share"] = nbytes / dt / peak["hbm_bytes_per_s"]
        out["bf16_share"] = flops / dt / peak["bf16_flops_per_s"]
    if train_rate:
        out["train_env_steps_per_s"] = train_rate
    log("trainer", set_encoder_step=out)
    return out


# ---------------------------------------------------------------------------
# 5. net vs reference
# ---------------------------------------------------------------------------


def _rel_max(a, r) -> float:
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    return float(np.max(np.abs(a - r)) / max(1.0, float(np.max(np.abs(r)))))


def _rel_rms(a, r) -> float:
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    return float(np.sqrt(np.mean((a - r) ** 2))
                 / max(float(np.sqrt(np.mean(r ** 2))), 1e-12))


def _grad_err(g, r) -> float:
    return max(
        float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
              / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-12))
        for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(r)))


def _global_grad_err(g, r) -> float:
    """||g - r|| / ||r|| over all params as one vector."""
    flat = [np.concatenate([np.asarray(x, np.float64).ravel()
                            for x in jax.tree_util.tree_leaves(t)])
            for t in (g, r)]
    return float(np.linalg.norm(flat[0] - flat[1])
                 / max(np.linalg.norm(flat[1]), 1e-12))


def _errors(out, ref) -> dict:
    """out/ref: (logits, value, loss, grads) on the host."""
    return {"logits_err": _rel_max(out[0], ref[0]),
            "value_err": _rel_max(out[1], ref[1]),
            "logits_rms": _rel_rms(out[0], ref[0]),
            "value_rms": _rel_rms(out[1], ref[1]),
            "loss_err": abs(float(out[2]) - float(ref[2]))
            / max(1.0, abs(float(ref[2]))),
            "grad_err": _grad_err(out[3], ref[3])}


def _perturbed(params, seed: int):
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tree, [
        x * (1 + NOISE_REL * jax.random.normal(k, x.shape, x.dtype))
        for x, k in zip(leaves, keys)])


def net_evaluator(cfg, lowered):
    """(params, traj, adv, ret) -> (logits, value, loss, grads): the
    forward on the trajectory's observations and the ppo_loss gradient."""
    from game_engine_tpu.policies import net as N
    from game_engine_tpu.train.ppo import ppo_loss

    def evaluate(p, t, a, r):
        logits, value = N.apply_net(p, t.obs, cfg.net, lowered)
        loss, grads = jax.value_and_grad(
            lambda q: ppo_loss(q, t, a, r, cfg, lowered)[0])(p)
        return logits, value, loss, grads

    return evaluate


def compare_to_reference(evaluate, inputs, out) -> tuple[dict, dict, tuple]:
    """Errors of `out` (evaluate(*inputs) computed elsewhere, on the host)
    against evaluate on the CPU at float32 "highest", and the tolerances
    measured from that reference's own noise floor. Returns
    (errors, tolerances, reference outputs)."""
    ref_in = jax.device_put(inputs, jax.devices("cpu")[0])
    with jax.default_matmul_precision("highest"):
        ref_fn = jax.jit(evaluate)
        ref = jax.device_get(ref_fn(*ref_in))
        floors = [_errors(jax.device_get(ref_fn(
            _perturbed(ref_in[0], seed), *ref_in[1:])), ref)
            for seed in (1, 2)]
    res = _errors(out, ref)
    tol = {k: max(NOISE_FACTOR * max(f[k] for f in floors), MIN_TOL[k])
           for k in res}
    return res, tol, ref


def greedy_agreement(logits, ref_logits, legal, rows) -> tuple[float, int]:
    """Share of `rows` whose best legal action under `logits` is the
    reference's, counting only rows where the reference has one best legal
    action: seats with identical observations tie exactly, and which of
    them argmax picks is arbitrary. Returns (share, rows counted)."""
    ref_l = np.where(legal, ref_logits, -np.inf)
    top2 = np.sort(ref_l, -1)[..., -2:]
    decisive = rows & (top2[..., 1] > top2[..., 0])
    if not decisive.any():
        return 1.0, 0
    pick = np.argmax(np.where(legal, logits, -np.inf), -1)
    same = pick[decisive] == np.argmax(ref_l, -1)[decisive]
    return float(np.mean(same)), int(decisive.sum())


def phase_net_reference(rooms: int = 1024, horizon: int = 4, hidden: int = 256,
                        archs=("mlp", "deepsets", "attn")) -> dict:
    """apply_net and the ppo_loss gradient on the default device vs the
    same params and inputs on the CPU under float32 "highest" precision:
    each arch at random init, and the served werewolf bot's trained attn
    checkpoint."""
    from game_engine_tpu.core.engine import compiled_rollout
    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.policies import net as N
    from game_engine_tpu.policies.serve import load_policy
    from game_engine_tpu.train.ppo import PPOConfig, init_training

    lowered = _lowered("werewolf")
    # real mid-game observations: a scripted rollout spreads rooms over phases
    state0, _ = compiled_rollout(lowered, 11)(
        init_state(lowered, rooms, 8, np.arange(rooms, dtype=np.uint32)))
    nets = []
    for arch in archs:
        cfg = PPOConfig(horizon=horizon, epochs=1,
                        net=N.NetConfig(hidden=hidden, arch=arch))
        nets.append((arch, cfg,
                     init_training(lowered, cfg, jax.random.PRNGKey(3))[0]))
    trained, net_cfg = load_policy(BOT_CKPT.split("=", 1)[1])
    nets.append(("attn_trained", PPOConfig(horizon=horizon, epochs=1,
                                           net=net_cfg),
                 jax.tree_util.tree_map(jnp.asarray, trained)))
    out = {}
    for name, cfg, params in nets:
        inputs = jax.device_get(
            (params,) + fixed_trajectory(lowered, cfg, params, state0))
        evaluate = net_evaluator(cfg, lowered)
        card = jax.device_get(jax.jit(evaluate)(*jax.device_put(inputs)))
        res, tol, ref = compare_to_reference(evaluate, inputs, card)
        legal = np.asarray(inputs[1].legal)
        rows = legal.any(-1) & np.asarray(inputs[1].mask)
        res["greedy_agree"], decisive = greedy_agreement(card[0], ref[0],
                                                         legal, rows)
        log("net_reference", net=name, hidden=cfg.net.hidden,
            obs_rows=int(np.prod(legal.shape[:-1])), greedy_rows=int(rows.sum()),
            decisive_rows=decisive, **res, tolerance=tol)
        fails = [k for k in tol if not res[k] <= tol[k]]
        if (not np.isfinite(float(card[2])) or fails
                or res["greedy_agree"] < GREEDY_MIN):
            raise AssertionError(f"net {name} off its reference in {fails}: {res}")
        res["tolerance"] = tol
        out[name] = res
    return out


def fixed_trajectory(lowered, cfg, params, state, seed: int = 5):
    """(traj, adv, ret): one mirror self-play unroll from `state`, on the
    default device."""
    from game_engine_tpu.policies import net as N
    from game_engine_tpu.train.ppo import gae, make_unroll

    _, _, traj = jax.jit(make_unroll(lowered, cfg))(
        params, state, jax.random.PRNGKey(seed))
    last_v = jax.jit(lambda p, o: N.apply_net(p, o, cfg.net, lowered)[1])(
        params, traj.obs[-1])
    adv, ret = gae(traj, last_v, cfg)
    return traj, adv, ret


# ---------------------------------------------------------------------------
# 6. served rooms
# ---------------------------------------------------------------------------

BOT_CKPT = "werewolf=" + os.path.join(REPO_ROOT, "docs", "checkpoints",
                                      "attn_werewolf_u120.npz")
CHAT_LM = os.path.join(REPO_ROOT, "docs", "checkpoints", "chat_lm.npz")


def _http(port: int, method: str, path: str, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def _play_room(port: int, game: str, bots: int, seed: int, name: str,
               chat: bool, lat: list) -> tuple[str, dict]:
    out = _http(port, "POST", "/api/rooms/create",
                {"gameName": game, "playerName": name})
    rid = out["room"]["roomId"]
    for _ in range(bots):
        _http(port, "POST", "/api/rooms/add-bot", {"roomId": rid})
    _http(port, "POST", f"/api/rooms/{rid}/start", {"seed": seed})
    if chat:
        msgs = _http(port, "POST", f"/api/rooms/{rid}/chat",
                     {"playerId": 1, "message": "to Bot 2: hello there"})
        if not any(m["playerId"] != "1" for m in msgs["messages"]):
            raise AssertionError(f"no bot answered in room {rid}: {msgs}")
    for _ in range(400):
        t0 = _now()
        snap = _http(port, "POST", f"/api/rooms/{rid}/continue")
        lat.append(_now() - t0)
        if snap["done"]:
            if not snap.get("winner"):
                raise AssertionError(f"{game} room {rid} ended with no winner")
            return rid, snap
        for pid in snap["waiting_on"]:
            _http(port, "POST", f"/api/rooms/{rid}/action",
                  {"playerId": pid, "choice": 1, "text": "one\ntwo\nthree"})
    raise AssertionError(f"{game} room {rid} did not finish in 400 turns")


def _room_view(host, rid: str) -> dict:
    snap = host.snapshot(rid)
    view = {k: snap[k] for k in ("stateVersion", "current_phase_id",
                                 "player_states", "phase_history", "done",
                                 "winner")}
    view["chat"] = [(m["playerId"], m["message"])
                    for m in host.chat_messages(rid, 1)]
    return view


def phase_served_rooms(storage_dir: str, werewolf_rooms: int = 2,
                       twotruths_rooms: int = 2) -> dict:
    """The room server on the jax backend: learned werewolf bots, the chat
    LM, HTTP play to a winner, then a journal restore in this process."""
    from game_engine_tpu.server.api import make_server
    from game_engine_tpu.server.manager import GameHost

    if os.path.isdir(storage_dir):
        shutil.rmtree(storage_dir)
    os.makedirs(storage_dir)
    sp = os.path.join(storage_dir, "rooms.json")
    t0 = _now()
    srv = make_server(port=0, storage_path=sp, backend="jax",
                      bot_ckpts=[BOT_CKPT], chat_lm=CHAT_LM)
    setup_s = _now() - t0
    host = srv.ctx.host
    lm = host._chat_lm_hook
    lm_calls = []

    def counted(ctx):
        lm_calls.append(ctx)
        return lm(ctx)

    counted.__dict__.update(lm.__dict__)  # grounded/personas/... flags
    host._chat_lm_hook = counted
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    lat: list[float] = []
    try:
        t0 = _now()
        played = []
        for i in range(werewolf_rooms):
            played.append(_play_room(port, "werewolf", 5, 100 + i, f"W{i}",
                                     chat=(i == 0), lat=lat))
        for i in range(twotruths_rooms):
            played.append(_play_room(port, "two-truths", 3, 200 + i, f"T{i}",
                                     chat=False, lat=lat))
        play_s = _now() - t0
        if not lm_calls:
            raise AssertionError("the chat LM never decoded a reply")
        rid = played[0][0]
        ref = _room_view(host, rid)
        host2 = GameHost(backend="jax", persist_dir=sp + ".rooms",
                         bot_ckpts=[BOT_CKPT], chat_lm=CHAT_LM)
        if not host2.restore_room(rid):
            raise AssertionError(f"room {rid} did not restore from its journal")
        got = _room_view(host2, rid)
        if got != ref:
            diff = [k for k in ref if ref[k] != got[k]]
            raise AssertionError(f"restored room {rid} differs in {diff}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    lat.sort()
    out = {"rooms": len(played), "setup_s": round(setup_s, 3),
           "play_s": round(play_s, 3),
           "games_per_min": len(played) / play_s * 60.0,
           "continue_p50_ms": lat[len(lat) // 2] * 1e3,
           "continue_p95_ms": lat[int(0.95 * (len(lat) - 1))] * 1e3,
           "chat_lm_decodes": len(lm_calls), "restored_equal": True,
           "winners": [s["winner"] for _, s in played]}
    log("served_rooms", **out)
    return out


# ---------------------------------------------------------------------------
# 7. driver entry
# ---------------------------------------------------------------------------


def phase_driver_entry() -> dict:
    sys.path.insert(0, REPO_ROOT)
    import __graft_entry__ as g

    fn, args = g.entry()
    t0 = _now()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = _now() - t0
    state, logits, value = compiled(*args)
    jax.block_until_ready(value)
    if not (np.isfinite(np.asarray(logits)).all()
            and np.isfinite(np.asarray(value)).all()):
        raise AssertionError("entry() produced non-finite logits or values")
    out = {"compile_s": round(compile_s, 3), "logits_shape": list(logits.shape)}
    log("driver_entry", **out)
    return out


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _placed_on(tree, devices) -> None:
    """Every array spans exactly `devices`: nothing silently stays on one."""
    want = set(devices)
    for leaf in jax.tree_util.tree_leaves(tree):
        have = set(leaf.sharding.device_set)
        if have != want:
            raise AssertionError(f"array {leaf.shape} lives on {sorted(d.id for d in have)}, "
                                 f"expected {sorted(d.id for d in want)}")


def _rooms_on_data(mesh, tree, axis: int):
    """Shard every array's rooms `axis` over 'data'."""
    from jax.sharding import NamedSharding, PartitionSpec

    def put(x):
        spec = [None] * x.ndim
        spec[axis] = "data"
        return jax.device_put(x, NamedSharding(mesh, PartitionSpec(*spec)))

    return jax.tree_util.tree_map(put, tree)


def phase_four_cards(rooms: int = 16384, steps: int = 1024, hidden: int = 256,
                     horizon: int = 16, n_devices: int = 4) -> dict:
    """Data-parallel rollout, loss-gradient and league update over n_devices
    cards vs one. Every program is traced first and all are compiled side
    by side."""
    import optax

    from game_engine_tpu.core.engine import make_rollout
    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.parallel.mesh import (make_mesh, params_sharding,
                                               replicate, state_sharding)
    from game_engine_tpu.policies import net as N
    from game_engine_tpu.train.league import make_league_train_step
    from game_engine_tpu.train.ppo import PPOConfig, init_training, ppo_loss

    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(jax.devices())}")
    lowered = _lowered("werewolf")
    seeds = np.arange(rooms, dtype=np.uint32)

    def rooms0():
        return init_state(lowered, rooms, 8, seeds)

    cfg = PPOConfig(horizon=horizon, epochs=1,
                    net=N.NetConfig(hidden=hidden, arch="attn"))
    params, opt_state, tx = init_training(lowered, cfg, jax.random.PRNGKey(0))
    meshes = {"data4": make_mesh(n_devices),
              "data2_model2": make_mesh(n_devices, model_parallel=2)}
    # one trajectory, made on one card, for every loss-gradient program
    traj_one = jax.device_put(
        fixed_trajectory(lowered, cfg, params,
                         jax.device_put(rooms0(), devs[0])), devs[0])

    roll = jax.jit(make_rollout(lowered, steps))
    loss_vg = jax.jit(jax.value_and_grad(
        lambda p, t, a, r: ppo_loss(p, t, a, r, cfg, lowered)[0]))
    step = jax.jit(make_league_train_step(lowered, cfg, tx))
    runs = {  # name -> (jitted, args)
        "roll_one": (roll, (jax.device_put(rooms0(), devs[0]),)),
        "roll_data4": (roll, (state_sharding(meshes["data4"], rooms0()),)),
        "loss_one": (loss_vg, (jax.device_put(params, devs[0]),) + traj_one),
    }
    for k, m in meshes.items():
        runs[f"loss_{k}"] = (loss_vg, (params_sharding(m, params),)
                             + _rooms_on_data(m, jax.device_get(traj_one), 1))
        runs[f"league_{k}"] = (step, (
            params_sharding(m, params), params_sharding(m, params),
            replicate(m, opt_state), state_sharding(m, rooms0()),
            replicate(m, jax.random.PRNGKey(1))))
    traced = {k: f.lower(*a) for k, (f, a) in runs.items()}
    t0 = _now()
    with ThreadPoolExecutor(max_workers=len(traced)) as ex:
        compiled = dict(zip(traced, ex.map(lambda t: t.compile(),
                                           traced.values())))
    log("four_cards", programs=len(compiled), compile_s=round(_now() - t0, 3))

    def run(name):
        out = compiled[name](*runs[name][1])
        jax.block_until_ready(out)
        return out

    one, eps1 = run("roll_one")
    many, eps4 = run("roll_data4")
    t0 = _now()
    run("roll_one")
    rate1 = rooms * steps / (_now() - t0)
    t0 = _now()
    run("roll_data4")
    rate4 = rooms * steps / (_now() - t0)
    _placed_on(many, devs)
    for f in one._fields:
        if not np.array_equal(np.asarray(getattr(one, f)),
                              np.asarray(getattr(many, f))):
            raise AssertionError(f"sharded rollout differs in field {f}")
    if int(eps1) != int(eps4) or int(eps1) <= 0:
        raise AssertionError(f"episodes {int(eps1)} vs sharded {int(eps4)}")
    log("four_cards", rollout_rooms=rooms, steps=steps, bit_identical=True,
        episodes=int(eps1), one_card_env_steps_per_s=rate1,
        four_card_env_steps_per_s=rate4)

    loss1, g1 = jax.device_get(run("loss_one"))
    if not np.isfinite(loss1):
        raise AssertionError(f"one-card loss {loss1}")
    results = {}
    for name in meshes:
        loss, g = jax.device_get(run(f"loss_{name}"))
        res = {"loss": float(loss),
               "loss_err": abs(float(loss - loss1)) / max(1.0, abs(float(loss1))),
               "grad_err": _global_grad_err(g, g1)}
        log("four_cards", loss_grad=name, rooms=rooms, horizon=horizon,
            one_card_loss=float(loss1), tolerance=FOUR_CARD_TOL, **res)
        if not all(res[k] <= FOUR_CARD_TOL[k] for k in FOUR_CARD_TOL):
            raise AssertionError(f"sharded loss-gradient {name} off one card: "
                                 f"{res} (tolerance {FOUR_CARD_TOL})")
        # the whole league update: finite, and the rooms stay spread over
        # every card (its sampled actions, so its trajectories, may differ)
        new_params, _, state, _, m = run(f"league_{name}")
        _placed_on(state, devs)
        res["league_loss"] = float(m["loss"])
        res["league_episodes"] = int(m["episodes"])
        if not (np.isfinite(res["league_loss"]) and all(
                np.isfinite(np.asarray(x)).all()
                for x in jax.tree_util.tree_leaves(new_params))):
            raise AssertionError(f"league update {name} not finite: {res}")
        log("four_cards", league_update=name,
            loss=res["league_loss"], episodes=res["league_episodes"])
        results[name] = res
    return results


# ---------------------------------------------------------------------------


def phases_for(four_cards: bool) -> tuple[str, ...]:
    return ("four_cards",) if four_cards else SINGLE_CARD_PHASES


def _card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs four GPUs)")
    args = ap.parse_args(argv)
    info = require_gpu()  # phase 1: never a CPU fallback
    enable_compile_cache()
    print(_card_name_and_limit(), flush=True)  # "name, power limit" per card
    print(f"jax {jax.__version__}; devices {info}", flush=True)
    t_all = _now()
    for name in phases_for(args.four_cards):
        t0 = _now()
        if name == "device_gate":
            log(name, device=info)
        elif name == "engine":
            phase_engine()
        elif name == "policy":
            phase_policy()
        elif name == "trainer":
            phase_trainer()
        elif name == "net_reference":
            phase_net_reference()
        elif name == "served_rooms":
            phase_served_rooms(os.path.join(REPO_ROOT, "chiprun_out", "smoke_rooms"))
        elif name == "driver_entry":
            phase_driver_entry()
        elif name == "four_cards":
            phase_four_cards()
        log(name, wall_s=round(_now() - t0, 3))
    stats = jax.devices()[0].memory_stats() or {}
    log("done", wall_s=round(_now() - t_all, 3),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
