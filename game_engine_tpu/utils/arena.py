"""Round-robin arena over mixed bot tiers, with Elo ratings.

`train/evaluate.py --matchup` compares LEARNED checkpoints on the device
batch path; this arena compares ANY serving tiers — scripted, lookahead
search, information-set (determinized) search, and learned checkpoints —
pairwise on the native backend, the way rooms actually serve them. Every
ordered pair (row plays the minority side / seat 1, column the rest)
plays `rooms` fixed-seed rooms; the win matrix feeds the same Elo fit
(train.evaluate.elo_fit: ratings + a minority-side handicap term) as the
checkpoint matchups, giving one leaderboard across tier kinds — the
engine-native counterpart of the reference's "which bot prompt plays
better" question, answered with measured games instead of vibes.

    python -m game_engine_tpu.utils.arena [game] [rooms] [tier ...]

Tiers (repeatable, order = table order):
    scripted            the splitmix32 baseline policy
    search              full-information lookahead (rollouts=32, horizon=200)
    search-detD         information-set search over D determinizations
    <path>.npz          a learned checkpoint (policies/serve.py greedy)

Defaults: werewolf, 100 rooms, tiers = scripted search search-det8.
Runs on the CPU platform (host-side eval; set ARENA_ON_DEVICE=1 to put
the learned forward on the accelerator). Deterministic: fixed seeds throughout.
"""

from __future__ import annotations

import json
import os
import re
import sys

ROLLOUTS = 32
HORIZON = 200


def _make_tier(spec: str, lowered):
    """(name, actor-or-None): actor exposes native_actions(read, n, seed)."""
    from game_engine_tpu.policies.search import SearchBots

    if spec == "scripted":
        return "scripted", None
    if spec == "search":
        return "search", SearchBots(lowered, rollouts=ROLLOUTS, horizon=HORIZON)
    m = re.fullmatch(r"search-det(\d+)", spec)
    if m:
        return spec, SearchBots(lowered, rollouts=ROLLOUTS, horizon=HORIZON,
                                determinize=int(m.group(1)))
    if spec.endswith(".npz") or "/" in spec:
        from game_engine_tpu.policies.serve import PolicyBots, load_policy

        params, cfg = load_policy(spec)
        name = os.path.basename(spec).replace(".npz", "")
        return name, PolicyBots(lowered, params, cfg, spec)
    raise SystemExit(f"unknown tier spec {spec!r} (scripted | search | "
                     f"search-detD | checkpoint.npz)")


def run_arena(game: str, rooms: int, tier_specs: list[str]) -> dict:
    from game_engine_tpu.gamespec.compile import compile_game
    from game_engine_tpu.gamespec.parser import load_builtin
    from game_engine_tpu.gamespec.tables import lower
    from game_engine_tpu.native.lib import CppGame
    from game_engine_tpu.train.evaluate import elo_fit

    lw = lower(compile_game(load_builtin(game)))
    go = lw.game_overs[0] if lw.game_overs else None
    if go is None:
        raise SystemExit(f"game {game!r} declares no terminal winner rule")
    eng = CppGame(lw)
    n = min(6, lw.P)
    tiers = [_make_tier(s, lw) for s in tier_specs]

    if go.mode == "team":
        slot, min_code = go.team_str_slot, go.team_codes[0]

        def is_protag(pid, r):
            return int(r["strs"][pid - 1, slot]) == min_code
    else:
        def is_protag(pid, r):
            return pid == 1

    def play(actor_min, actor_maj) -> float:
        wins = 0
        for i in range(rooms):
            room = eng.room(n, 11000 + i)
            for _ in range(600):
                r = room.read()
                if r["done"]:
                    break
                acts = room.policy_actions()
                a_min = (actor_min.native_actions(r, n, seed=11000 + i)
                         if actor_min is not None else {})
                a_maj = (actor_maj.native_actions(r, n, seed=11000 + i)
                         if actor_maj is not None else {})
                for pid in range(1, n + 1):
                    src = a_min if is_protag(pid, r) else a_maj
                    if pid in src:
                        acts[pid] = src[pid]
                room.step(acts)
            wins += room.read()["winner"] == 1
        return wins / rooms

    table: dict[str, dict[str, float]] = {}
    for ni, ai in tiers:
        table[ni] = {}
        for nj, aj in tiers:
            table[ni][nj] = round(play(ai, aj), 4)
            print(json.dumps({"event": "pair", "minority": ni,
                              "majority": nj, "win": table[ni][nj]}),
                  file=sys.stderr, flush=True)
    elo = elo_fit(table)
    return {"game": game, "rooms": rooms, "n_players": n, "mode": go.mode,
            "rows_play": "minority side" if go.mode == "team" else "seat 1",
            "rollouts": ROLLOUTS, "horizon": HORIZON,
            "table": table, "elo": elo}


def main() -> None:
    if os.environ.get("ARENA_ON_DEVICE") != "1":
        import jax

        jax.config.update("jax_platforms", "cpu")
    game = sys.argv[1] if len(sys.argv) > 1 else "werewolf"
    rooms = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    specs = sys.argv[3:] or ["scripted", "search", "search-det8"]
    out = run_arena(game, rooms, specs)
    print(json.dumps(out))
    names = list(out["table"])
    width = max(len(x) for x in names) + 2
    print("\nminority-side win rate (row vs column):", file=sys.stderr)
    print(" " * width + "  ".join(f"{x[:12]:>12}" for x in names),
          file=sys.stderr)
    for r in names:
        print(f"{r:<{width}}" + "  ".join(
            f"{out['table'][r][c]:>12.3f}" for c in names), file=sys.stderr)
    print(f"\nElo (minority handicap "
          f"{out['elo']['minority_side_elo']:+.0f}):", file=sys.stderr)
    for nm, rt in out["elo"]["ratings"].items():
        print(f"  {nm:<{width}} {rt:+8.1f}", file=sys.stderr)


if __name__ == "__main__":
    main()
