"""Conversion mechanics (VERDICT r3 item 3): team flips and per-player
dict memory exist ONLY through the effect IR's new write surface —
`team = 'cult' where ...` (vocab-coded string write) and
`cult_marks[choice] = 'claimed'` (player-keyed dict entry write).

The reference referee performs these as free-form update_player_state
writes (reference: agent/tools/backend_tools.py:204-225; cult/traitor
conversion is the canonical prompt example in
agent/prompt/referee_system_prompt_1.txt:6-88). cult-of-the-depths is the
catalog game that exercises them end to end with four-executor parity.
"""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches


@pytest.fixture(scope="module")
def cult():
    return lower(compile_game(load_builtin("cult-of-the-depths")))


@pytest.mark.parametrize("seed", range(4))
def test_oracle_engine_parity_with_conversions(cult, seed):
    lowered = cult
    room = OracleRoom(lowered.game, n_players=6, seed=seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, 6, np.uint32(seed))
    for t in range(400):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done
    assert 1 <= room.winner <= 2


def test_conversion_flips_team_and_records_memory(cult):
    """At least one seed must show a Diver converted to cult AND a pdict
    mark recorded by a recruiter; and both teams must be able to win."""
    lowered = cult
    winners = set()
    saw_conversion = saw_mark = False
    for seed in range(8):
        room = OracleRoom(lowered.game, n_players=6, seed=seed)
        for t in range(600):
            room.step(oracle_policy(room, t, seed))
            if room.done:
                break
        assert room.done
        winners.add(room.winner)
        for p in room.players.values():
            if p.get("role") == "Diver" and p.get("team") == "cult":
                saw_conversion = True
            marks = p.get("cult_marks") or {}
            if any(v == "claimed" for v in marks.values()):
                saw_mark = True
    assert saw_conversion, "no Diver was ever converted"
    assert saw_mark, "no cult_marks entry was ever written"
    assert winners == {1, 2}, f"only teams {winners} ever won"


def test_cpp_parity(cult):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 3, 5):
        run_differential(cult, n_players=6, seed=seed, max_steps=600)


def test_cult_batch_split_invariance(cult):
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(cult, n_players=6, steps=80)
