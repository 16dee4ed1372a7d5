"""P11/P17 terminal rules through the effect IR (VERDICT r4 item 4).

The bespoke winner kernels are deleted from all four executors: every
terminal GameOver lowers to a one-statement IR program
(effects.game_over_program), and a DSL phase can declare its OWN terminal
rule with the `over EXPR` statement — potlatch's winner is
argmax(gifts_received * 2 - coins), a composite key no P17 single-field
score mode could express (reference analogue: the LLM referee computing a
free-form final standing, agent/prompt/referee_system_prompt_2.txt).
"""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.gamespec import effects as FX
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches


@pytest.fixture(scope="module")
def potlatch():
    return lower(compile_game(load_builtin("potlatch")))


def test_no_bespoke_winner_kernels_remain():
    """Every executor's terminal path is the IR interpreter: lowering a
    game emits NO executable LGameOver (metadata only), and the oracle
    has no _game_over method left."""
    from game_engine_tpu.gamespec.tables import LGameOver

    ww = lower(compile_game(load_builtin("werewolf")))
    assert not any(isinstance(m, LGameOver) for m in ww.mechanics)
    assert ww.game_overs and ww.game_overs[0].mode == "team"  # metadata kept
    assert not hasattr(OracleRoom, "_game_over")


def test_declared_over_suppresses_default_game_over(potlatch):
    term = next(cp for cp in potlatch.game.phases if cp.dsl_id == 99)
    assert not any(isinstance(m, M.GameOver) for m in term.program.on_enter)
    fx = [m for m in term.program.on_enter if isinstance(m, M.Effects)]
    assert fx and any(isinstance(s, FX.SOver)
                      for b in fx[0].program for s in b)
    # and no LGameOver metadata was fabricated for the declared rule
    assert potlatch.game_overs == ()


def test_winner_hint_plus_declared_over_is_loud():
    import os

    import yaml

    from game_engine_tpu.dslgen.validate import errors, validate_doc
    from game_engine_tpu.gamespec.parser import games_dir

    doc = yaml.safe_load(open(os.path.join(games_dir(), "potlatch.yaml")))
    doc["phases"][99]["mechanics"].append({"winner": "survivor"})
    issues, spec = validate_doc(doc, name="conflicted")
    assert any("overridden by a declared `over`" in str(e)
               for e in errors(issues)), [str(i) for i in issues]


@pytest.mark.parametrize("seed", range(4))
def test_oracle_engine_parity(potlatch, seed):
    lowered = potlatch
    n = 4 + seed % 3
    room = OracleRoom(lowered.game, n_players=n, seed=seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, n, np.uint32(seed))
    for t in range(400):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done
    # the declared composite rule decided the winner
    standing = {p: 2 * room.players[p].get("gifts_received", 0)
                - room.players[p].get("coins", 0) for p in room.players}
    best = max(standing.values())
    assert room.winner == min(p for p, s in standing.items() if s == best)


def test_cpp_parity(potlatch):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 2):
        run_differential(potlatch, n_players=5, seed=seed, max_steps=400)


def test_potlatch_batch_split_invariance(potlatch):
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(potlatch, n_players=4, steps=60)
