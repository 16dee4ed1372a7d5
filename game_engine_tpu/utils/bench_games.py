"""Per-game rollout throughput breadth.

Benches any catalog list in ONE process with chained fused rollouts and
median-of-iters timing, defaulting to the IR-only games + the adversarial
storm-forge program (the games exercising the interpreter hardest) + the
werewolf anchor.

    python -m game_engine_tpu.utils.bench_games [batch] [steps] [iters] [game ...]

Prints one JSON line per game plus a final summary JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

DEFAULT_GAMES = (
    "werewolf",            # headline anchor (night/vote/roles)
    "gift-circle",         # incoming-transfer chains
    "handshake-pact",      # mutual-pact eqcount
    "speed-track",         # rank/collision
    "relic-draft",         # eqcount pool split
    "tide-pool",           # conditional reset press-your-luck
    "cult-of-the-depths",  # string-write conversion
    "raven-moot",          # llm-seam demo game
    "storm-forge",         # adversarial 6-block ~40-statement program
    "masquerade-gala",     # ST_DEAL every round (P10-as-IR hot path)
    "potlatch",            # declared composite terminal (ST_OVER chains)
)


def bench_game(game: str, batch: int, steps: int, iters: int) -> dict:
    from game_engine_tpu.core.engine import compiled_rollout
    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.gamespec.compile import compile_game
    from game_engine_tpu.gamespec.parser import load_builtin
    from game_engine_tpu.gamespec.tables import lower

    spec = load_builtin(game)
    compiled = compile_game(spec)
    lowered = lower(compiled)
    # declared min_players, else the full table width (werewolf headline = 8)
    n_players = (getattr(spec.declaration, "min_players", 0) or
                 compiled.config.max_players)
    n_players = min(max(n_players, 4), compiled.config.max_players)

    roll = compiled_rollout(lowered, steps, auto_reset=True)
    state = init_state(lowered, batch, n_players,
                       np.arange(batch, dtype=np.uint32))
    t0 = time.perf_counter()
    state, eps = roll(state)
    total_eps = int(eps)  # hard host sync; includes the jit build
    compile_s = time.perf_counter() - t0

    durations = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, eps = roll(state)
        total_eps += int(eps)
        durations.append(time.perf_counter() - t0)
    durations.sort()
    med = durations[len(durations) // 2]
    return {
        "game": game,
        "n_players": n_players,
        "n_phases": compiled.n_phases,
        "msteps_per_s": round(batch * steps / med / 1e6, 1),
        "us_per_step": round(med / steps * 1e6, 1),
        "episodes": total_eps,
        "compile_s": round(compile_s, 1),
    }


def main() -> None:
    argv = sys.argv[1:]
    batch = int(argv[0]) if len(argv) > 0 else 4096
    steps = int(argv[1]) if len(argv) > 1 else 1024
    iters = int(argv[2]) if len(argv) > 2 else 5
    games = argv[3:] or list(DEFAULT_GAMES)

    rows = []
    for g in games:
        row = bench_game(g, batch, steps, iters)
        rows.append(row)
        print(json.dumps(row), flush=True)
    anchor = next((r for r in rows if r["game"] == "werewolf"), rows[0])
    print(json.dumps({
        "batch": batch, "steps": steps, "iters": iters,
        "anchor": anchor["game"],
        "rel_to_anchor": {r["game"]: round(
            r["msteps_per_s"] / anchor["msteps_per_s"], 2) for r in rows},
    }))


if __name__ == "__main__":
    main()
