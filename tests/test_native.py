"""Differential tests: the C++ simulator vs the Python oracle — bit-identical
full games on all three game DSLs (shipped + generated)."""

import numpy as np
import pytest

from game_engine_tpu.gamespec.compile import GameConfig, compile_game
from game_engine_tpu.gamespec.layout import BANK_BOOL, BANK_NUM, BANK_ODICT, BANK_PDICT, BANK_STR
from game_engine_tpu.gamespec.parser import load_builtin, parse_game_spec
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.native import CppGame, available
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy

pytestmark = pytest.mark.skipif(not available(), reason="g++ build unavailable")


def assert_cpp_matches_oracle(lowered, room, cpp, t):
    s = cpp.read()
    ctx = f"[t={t}]"
    assert s["phase_id"] == room.phase.dsl_id, f"{ctx} phase"
    assert s["done"] == room.done, f"{ctx} done"
    assert s["winner"] == room.winner, f"{ctx} winner"
    layout = lowered.game.layout
    for p in range(room.n):
        orow = room.players[p + 1]
        assert bool(s["acted"][p]) == ((p + 1) in room.acted), f"{ctx} acted p{p+1}"
        for f in lowered.game.spec.declaration.fields:
            slot = layout.slot(f.name)
            ov = orow.get(f.name)
            if slot.bank == BANK_BOOL:
                assert bool(s["bools"][p, slot.index]) == bool(ov), f"{ctx} p{p+1}.{f.name}"
            elif slot.bank == BANK_NUM:
                assert int(s["nums"][p, slot.index]) == int(ov or 0), f"{ctx} p{p+1}.{f.name}"
            elif slot.bank == BANK_STR and f.name != "name":
                assert int(s["strs"][p, slot.index]) == slot.encode(ov), f"{ctx} p{p+1}.{f.name}"
            elif slot.bank == BANK_PDICT:
                for q in range(room.n):
                    want = slot.encode((ov or {}).get(str(q + 1), ""))
                    assert int(s["pdict"][p, slot.index, q]) == want, f"{ctx} p{p+1}.{f.name}[{q+1}]"
            elif slot.bank == BANK_ODICT:
                assert (int(s["odict"][p, slot.index]) != 0) == bool(ov), f"{ctx} p{p+1}.{f.name}"


def run_differential(lowered, n_players, seed, max_steps=300):
    game = CppGame(lowered)
    room = OracleRoom(lowered.game, n_players=n_players, seed=seed)
    cpp = game.room(n_players, seed)
    assert_cpp_matches_oracle(lowered, room, cpp, -1)
    for t in range(max_steps):
        oa = oracle_policy(room, t, seed)
        ca = cpp.policy_actions()
        assert ca == oa, f"t={t}: policy mismatch {ca} != {oa}"
        room.step(oa)
        cpp.step(ca)
        assert_cpp_matches_oracle(lowered, room, cpp, t)
        if room.done:
            break
    assert room.done


@pytest.mark.parametrize("seed", range(5))
def test_werewolf_cpp_parity(seed):
    lowered = lower(compile_game(load_builtin("werewolf")))
    run_differential(lowered, n_players=4 + seed % 4, seed=seed)


@pytest.mark.parametrize("seed", range(5))
def test_twotruths_cpp_parity(seed):
    lowered = lower(compile_game(load_builtin("two-truths-and-a-lie"), GameConfig()))
    run_differential(lowered, n_players=3 + seed % 3, seed=seed + 50)


def test_generated_game_cpp_parity():
    from game_engine_tpu.dslgen.generate import generate_from_description

    doc = generate_from_description("assassins", "hidden-role night elimination game")
    lowered = lower(compile_game(parse_game_spec(doc, name="assassins")))
    run_differential(lowered, n_players=5, seed=9)


def test_cpp_selfplay_throughput():
    lowered = lower(compile_game(load_builtin("werewolf")))
    game = CppGame(lowered)
    import time

    rooms, steps = 256, 2000
    t0 = time.perf_counter()
    episodes = game.selfplay(rooms, 8, 0, steps)
    dt = time.perf_counter() - t0
    sps = rooms * steps / dt
    assert episodes > 100
    # CPU baseline sanity: the native sim should do >100k steps/s single-core
    assert sps > 100_000, f"cpp selfplay too slow: {sps:.0f} steps/s"
    print(f"\ncpp selfplay: {sps/1e6:.2f}M steps/s, {episodes/dt:.0f} episodes/s")


@pytest.mark.parametrize("game,n_players,steps", [
    ("werewolf", 8, 300), ("storm-forge", 5, 200), ("masquerade-gala", 6, 200)])
def test_batched_rollout_matches_cpp_selfplay(game, n_players, steps):
    """The XLA auto-reset rollout and the C++ batched self-play agree on
    every room's final state (seed included) and on the episode count."""
    import jax

    from game_engine_tpu.core.engine import make_rollout
    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.native import state_rows

    lowered = lower(compile_game(load_builtin(game)))
    rooms = 16
    state, eps = jax.jit(make_rollout(lowered, steps, auto_reset=True))(
        init_state(lowered, rooms, n_players, np.arange(rooms, dtype=np.uint32)))
    cpp_eps, cpp_rows = CppGame(lowered).selfplay_states(rooms, n_players, 0, steps)
    assert int(eps) == cpp_eps > 0
    np.testing.assert_array_equal(state_rows(state), cpp_rows)


def _catalog_games():
    import os

    from game_engine_tpu.gamespec.parser import games_dir

    return sorted(fn[:-5] for fn in os.listdir(games_dir())
                  if fn.endswith(".yaml"))


@pytest.mark.parametrize("game", _catalog_games())
def test_every_catalog_game_cpp_parity(game):
    """Catalog-wide guard: EVERY shipped game runs one full episode with
    bit-identical C++/oracle state (new games land with native parity by
    construction, not by remembering to add a test)."""
    spec = load_builtin(game)
    lowered = lower(compile_game(spec))
    n = max(getattr(spec.declaration, "min_players", 0) or 4, 4)
    n = min(n, lowered.P)
    run_differential(lowered, n_players=n, seed=17, max_steps=600)
