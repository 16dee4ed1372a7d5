"""Batch-split invariance of the XLA auto-reset rollout (core/engine.py):
rolling a batch out equals rolling its two halves out and concatenating,
bit for bit. Rooms share no state, so where a room sits in the batch (and
which rooms it is stepped beside) must not change its trajectory. The
per-mechanic cases live beside each family's other executor tests."""

import pytest

from game_engine_tpu.gamespec.compile import GameConfig, compile_game
from game_engine_tpu.gamespec.parser import load_builtin, parse_game_spec
from game_engine_tpu.gamespec.tables import lower
from tests.rollout_helpers import assert_batch_split_invariant


@pytest.fixture(scope="module")
def ww():
    return lower(compile_game(load_builtin("werewolf")))


@pytest.mark.parametrize("steps", [40, 130])
def test_werewolf_batch_split_invariance(ww, steps):
    assert_batch_split_invariant(ww, n_players=6, steps=steps)


def test_twotruths_batch_split_invariance():
    """Rotation/scoring mechanics (two-truths)."""
    lw = lower(compile_game(load_builtin("two-truths-and-a-lie"), GameConfig()))
    assert_batch_split_invariant(lw, n_players=4, steps=90)


def test_generated_game_batch_split_invariance():
    """A generated DSL (different phase graph)."""
    from game_engine_tpu.dslgen.generate import generate_from_description

    doc = generate_from_description("assassins", "hidden-role night elimination game")
    lw = lower(compile_game(parse_game_spec(doc, name="assassins")))
    assert_batch_split_invariant(lw, n_players=5, steps=80, expect_episodes=False)
