"""ADVICE r3 regressions: the effect IR's pinned int32 value domain.

All three executors must agree BIT-IDENTICALLY even when a DSL-declared
program overflows int32 (the oracle previously computed in unbounded
Python ints), and the max/argmax reductions must be exact for ALL int32
keys including INT32_MIN (the XLA adapter previously used a
narrowed -(2**31)+1 sentinel). Also pins the loud ceilings: out-of-int32
literals and >=63-phase chose() masks refuse to compile, and a malformed
effects program fails GAME COMPILATION (the serving path runs no
validator) instead of silently attaching nothing.

Reference contract: the LLM referee writes arbitrary values
(/root/reference/agent/tools/backend_tools.py:204-225); SEMANTICS.md P20
pins our determinized equivalent to wrapping int32.
"""

import os

import numpy as np
import pytest
import yaml

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec import effects as FX
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import games_dir, load_builtin, parse_game_spec
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches

INT32_MIN = -(2**31)

# One block per line group; block snapshots mean later blocks read the
# earlier blocks' writes. Exercises: int32 sub chain to the exact
# INT32_MIN, RED_MAX and ARG_MAX over keys == INT32_MIN with a masked-out
# lane (seat 2), mul overflow (46341^2 > 2^31), and += wrap
# (INT32_MIN + INT32_MIN -> 0).
WRAP_PROGRAM = [
    "gifts_received = 0 - 2147483647 - 1",
    "---",
    "coins = reduce_max(gifts_received, seat != 2)",
    "rounds = argmax(gifts_received, seat != 2)",
    "---",
    "gifts_received = 46341 * 46341",
    "---",
    "coins += coins",
]
EXPECT = {
    "gifts_received": 46341 * 46341 - 2**32,  # mul wraps negative
    "coins": 0,  # INT32_MIN + INT32_MIN wraps to 0
    "rounds": 1,  # argmax over all-INT32_MIN keys -> lowest masked-in seat
}


def _wrap_lowered():
    doc = yaml.safe_load(open(os.path.join(games_dir(), "gift-circle.yaml")))
    doc["phases"][2]["mechanics"] = [{"effects": list(WRAP_PROGRAM)}]
    # neutral prose so the keyword analyzer attaches nothing besides the
    # declared program (gift-circle's description otherwise mines income)
    doc["phases"][2]["name"] = "Resolution"
    doc["phases"][2]["description"] = "Effects apply."
    doc["phases"][1]["next_phase"]["name"] = "Resolution"
    issues, spec = validate_doc(doc, name="wrap-test")
    assert spec is not None and not errors(issues), [str(i) for i in issues]
    return lower(compile_game(spec))


@pytest.fixture(scope="module")
def wrap_game():
    return _wrap_lowered()


def test_oracle_engine_overflow_parity(wrap_game):
    lowered = wrap_game
    n = 4
    room = OracleRoom(lowered.game, n_players=n, seed=3)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, n, np.uint32(3))
    saw_program = False
    for t in range(24):
        room.step(oracle_policy(room, t, 3))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        row = room.players[1]
        if row.get("rounds") == EXPECT["rounds"] and row.get("coins") == EXPECT["coins"]:
            saw_program = True
            for f, want in EXPECT.items():
                assert row[f] == want, (f, row[f], want)
            assert INT32_MIN <= row["gifts_received"] <= 2**31 - 1
    assert saw_program, "the wrapping program never executed"


def test_cpp_overflow_parity(wrap_game):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from game_engine_tpu.native.lib import CppGame
    from tests.test_native import assert_cpp_matches_oracle

    lowered = wrap_game
    room = OracleRoom(lowered.game, n_players=4, seed=3)
    cpp = CppGame(lowered).room(4, 3)
    for t in range(24):
        oa = oracle_policy(room, t, 3)
        assert cpp.policy_actions() == oa
        room.step(oa)
        cpp.step(oa)
        assert_cpp_matches_oracle(lowered, room, cpp, t)


def test_out_of_range_literal_rejected():
    spec = load_builtin("gold-rush")
    game = compile_game(spec)
    with pytest.raises(FX.EffectError, match="outside int32"):
        FX.check_program(
            FX.parse_program(["coins += 3000000000"]),
            game.layout, frozenset(spec.phases), has_alive=True)


def test_malformed_effects_fail_game_compilation():
    """The serving path (GameHost -> compile_game) never runs the
    validator; a bad program must fail compilation loudly, not attach
    nothing (ADVICE r3 medium)."""
    doc = yaml.safe_load(open(os.path.join(games_dir(), "gift-circle.yaml")))
    doc["phases"][2]["mechanics"] = [{"effects": ["coins += bogus_field"]}]
    spec = parse_game_spec(doc, name="broken")
    with pytest.raises(FX.EffectError, match="effects program rejected"):
        compile_game(spec)


def test_phase_mask_ceiling_is_loud():
    """chose() membership packs into two 32-bit words; a >=63-phase game
    must refuse to lower instead of silently dropping membership bits in
    the jitted executors (ADVICE r3 low)."""
    doc = yaml.safe_load(open(os.path.join(games_dir(), "gift-circle.yaml")))
    phases = {0: doc["phases"][0], 1: doc["phases"][1]}
    # splice 66 auto-advance filler phases between exchange and game over
    for i in range(2, 68):
        phases[i] = {
            "name": f"Interlude {i}",
            "description": "filler",
            "actions": [{"description": "clear", "tools": ["clearCanvas"]}],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": f"Interlude {i} has been displayed."},
            "next_phase": {"id": i + 1, "name": f"Interlude {i + 1}"},
        }
    phases[68] = dict(doc["phases"][2])
    phases[68]["mechanics"] = [{"effects": ["coins += 1 where chose(67)"]}]
    phases[68]["next_phase"] = {"id": 99, "name": "Game Over"}
    phases[99] = doc["phases"][99]
    doc["phases"] = phases
    spec = parse_game_spec(doc, name="tall")
    with pytest.raises(ValueError, match="63 phases"):
        lower(compile_game(spec))


def test_overflow_batch_split_invariance(wrap_game):
    """The wrapping program's rooms step identically in any batch split."""
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(wrap_game, n_players=4, steps=16,
                                 expect_episodes=False)
