"""Mechanic MIXES (round 2+): archetypes composed into one phase graph.

The reference generates arbitrary games via gpt-5 and executes any mix of
mechanics through its LLM referee (reference: agent/dsl_agent.py:157-371,
agent/prompt/referee_system_prompt_1.txt); the deterministic generator
composes mechanic families structurally instead — here elimination+market
(werewolf with a coin economy: P12 income each morning, a P13 raid round
each day, and a second terminal won by the richest purse via P17
per-terminal winner modes). Four-executor bit-parity plus pins for the
composition-specific rules.
"""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.dslgen.generate import (
    Blueprint,
    RoleDef,
    generate,
    generate_from_description,
)
from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.layout import build_layout
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches

GOLD_RUSH_DESC = (
    "A village of prospectors hides two bandits who kill at night; a healer "
    "protects and a sheriff investigates. Each morning survivors collect gold "
    "coins, and each day players raid a rival's purse. Eliminate the bandits, "
    "survive, or strike it rich."
)


@pytest.fixture(scope="module")
def goldrush():
    doc = generate_from_description("gold-rush", GOLD_RUSH_DESC)
    issues, spec = validate_doc(doc, name="gold-rush")
    assert spec is not None and not errors(issues)
    assert not issues, [str(i) for i in issues]  # zero warnings
    return lower(compile_game(spec))


def test_description_mining_composes_the_mix(goldrush):
    """Elimination + market vocabulary in one description -> one composed
    phase graph with the cast mined (two bandits, healer, sheriff)."""
    decl = goldrush.game.spec.declaration
    assert "coins" in decl.field_names()
    assert "is_alive" in decl.field_names()
    names = [r.name for r in decl.roles]
    assert names.count("Bandit") == 1  # declaration lists each role once
    phase_names = {ph.name for ph in goldrush.game.spec.phases.values()}
    assert {"Raid Selection", "Raid Resolution"} <= phase_names


def test_mix_attaches_all_mechanic_families(goldrush):
    spec = goldrush.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    kinds = {type(m).__name__ for pp in progs.values() for m in pp.on_enter}
    assert {"RoleAssign", "NightResolve", "VoteElim", "ResourceIncome",
            "ResourceRaid", "GameOver"} <= kinds


def test_per_terminal_winner_modes(goldrush):
    """P17: the team terminal and the richest-purse terminal coexist."""
    spec = goldrush.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    modes = {}
    for pid, pp in progs.items():
        for m in pp.on_enter:
            if isinstance(m, M.GameOver):
                modes[pid] = (m.mode, m.score_field or m.team_field)
    assert modes[99] == ("team", "team")
    assert modes[98] == ("score", "coins")


def test_role_multiset_keeps_mined_cast_sizes(goldrush):
    """'two bandits' stays exactly two at every table size: surplus seats
    become fillers (example-table padding), and duplicate declaration
    entries no longer double-count (regression: 7-bandit tables)."""
    from game_engine_tpu.gamespec.mechanics import role_multiset

    spec = goldrush.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    ra = next(m for pp in progs.values() for m in pp.on_enter
              if isinstance(m, M.RoleAssign))
    for n in (5, 6, 8):
        ms = role_multiset(ra, n)
        assert ms.count("Bandit") == 2, (n, ms)
        assert ms.count("Healer") == 1 and ms.count("Sheriff") == 1
        assert ms.count("Civilian") == n - 4


def test_duplicate_declared_roles_are_deduped():
    """A DSL that declares the same role twice must behave as if declared
    once (the analyzer counts example rows, not declaration entries)."""
    doc = generate(Blueprint(
        name="dup", description="d", archetype="elimination",
        roles=(
            RoleDef("Civilian", "town", "", "filler"),
            # killer duplicated in the blueprint = duplicated example rows
            RoleDef("Vampire", "vampires", "kill", "kills"),
            RoleDef("Vampire", "vampires", "kill", "kills"),
        )))
    # hand-inject the duplicate into the declaration list as a hostile DSL would
    doc["declaration"]["roles"].append({"name": "Vampire", "description": "kills"})
    issues, spec = validate_doc(doc, name="dup")
    assert spec is not None and not errors(issues)
    progs = M.analyze(spec, build_layout(spec.declaration))
    from game_engine_tpu.gamespec.mechanics import role_multiset
    ra = next(m for pp in progs.values() for m in pp.on_enter
              if isinstance(m, M.RoleAssign))
    ms = role_multiset(ra, 6)
    assert ms.count("Vampire") == 2, ms


def _run_oracle_vs_engine(lowered, n, seed, max_steps=600):
    room = OracleRoom(lowered.game, n_players=n, seed=seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, n, np.uint32(seed))
    for t in range(max_steps):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done, f"did not terminate (phase {room.phase.dsl_id})"
    return room


@pytest.mark.parametrize("seed", range(4))
def test_mix_oracle_engine_parity(goldrush, seed):
    n = min(5 + seed, goldrush.P)
    room = _run_oracle_vs_engine(goldrush, n, seed)
    assert room.phase.dsl_id in (98, 99)


def test_mix_coin_victory_end(goldrush):
    """Seed 1 @ 8 players ends at the richest-purse terminal: winner is the
    lowest-id player holding the max purse (P11 tie-break under P17)."""
    room = _run_oracle_vs_engine(goldrush, 8, 1)
    assert room.phase.dsl_id == 98
    coins = [room.players[p]["coins"] for p in range(1, 9)]
    assert max(coins) >= 6
    assert room.winner == coins.index(max(coins)) + 1


def test_mix_team_victory_end(goldrush):
    room = _run_oracle_vs_engine(goldrush, 6, 0)
    assert room.phase.dsl_id == 99
    assert room.winner in (1, 2)  # team index, minority (bandits) first


def test_cpp_parity_mix(goldrush):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 1, 3):
        run_differential(goldrush, n_players=min(8, goldrush.P), seed=seed,
                         max_steps=600)


BOUNTY_ARENA_DESC = (
    "Gladiators vote one of their own out of the arena each round, collect "
    "bounty coins, and raid each other's purses; be the last one standing "
    "or the first to strike it rich."
)


@pytest.fixture(scope="module")
def bounty():
    doc = generate_from_description("bounty-arena", BOUNTY_ARENA_DESC)
    issues, spec = validate_doc(doc, name="bounty-arena")
    assert spec is not None and not errors(issues)
    assert not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


def test_battle_market_mix_modes(bounty):
    """Battle+market: the coins field would flip the P11 default to score
    mode; P17 keeps the survivor terminal survivor-won."""
    spec = bounty.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    modes = {pid: m.mode for pid, pp in progs.items() for m in pp.on_enter
             if isinstance(m, M.GameOver)}
    assert modes == {99: "survivor", 98: "score"}
    kinds = {type(m).__name__ for pp in progs.values() for m in pp.on_enter}
    assert {"VoteElim", "ResourceIncome", "ResourceRaid"} <= kinds


@pytest.mark.parametrize("seed", range(3))
def test_battle_market_oracle_engine_parity(bounty, seed):
    n = min(5 + seed, bounty.P)
    room = _run_oracle_vs_engine(bounty, n, seed, max_steps=800)
    assert room.phase.dsl_id in (98, 99)


def test_battle_market_both_endings_reachable(bounty):
    """4 players race to extinction first (survivor end); 8 players bank
    bounty faster than they eliminate (richest end)."""
    room = _run_oracle_vs_engine(bounty, 4, 0, max_steps=800)
    assert room.phase.dsl_id == 99
    alive = [room.players[p].get("is_alive") for p in range(1, 5)]
    assert alive.count(True) == 1 and room.winner == alive.index(True) + 1
    room = _run_oracle_vs_engine(bounty, 8, 0, max_steps=800)
    assert room.phase.dsl_id == 98
    coins = [room.players[p]["coins"] for p in range(1, 9)]
    assert room.winner == coins.index(max(coins)) + 1 and max(coins) >= 8


def test_cpp_parity_battle_market(bounty):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 2):
        run_differential(bounty, n_players=min(6, bounty.P), seed=seed,
                         max_steps=800)


def test_catalog_bounty_arena_matches_generator():
    import os
    import yaml

    from game_engine_tpu.gamespec.parser import games_dir

    path = os.path.join(games_dir(), "bounty-arena.yaml")
    on_disk = yaml.safe_load(open(path))
    assert on_disk == generate_from_description("bounty-arena", BOUNTY_ARENA_DESC)


def test_catalog_gold_rush_matches_generator():
    """games/gold-rush.yaml is the generator's output for its description —
    the catalog copy can't drift from the blueprint."""
    import os
    import yaml

    from game_engine_tpu.gamespec.parser import games_dir

    path = os.path.join(games_dir(), "gold-rush.yaml")
    on_disk = yaml.safe_load(open(path))
    assert on_disk == generate_from_description("gold-rush", GOLD_RUSH_DESC)


# ---------------------------------------------------------------------------
# elimination + auction mix (P19 woven into the night cycle)
# ---------------------------------------------------------------------------

RELIC_AUCTION_DESC = (
    "Werewolf-style hidden roles: two smugglers strike at night, a "
    "warden shields, a seer investigates; each dawn the village holds a "
    "sealed-bid auction for relic lots until the house closes"
)


@pytest.fixture(scope="module")
def relic():
    doc = generate_from_description("relic-auction", RELIC_AUCTION_DESC)
    issues, spec = validate_doc(doc, name="relic-auction")
    assert not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


def test_auction_mix_attaches_both_families(relic):
    from game_engine_tpu.gamespec import mechanics as M

    mechs = [m for cp in relic.game.phases for m in cp.program.on_enter]
    assert any(isinstance(m, M.NightResolve) for m in mechs)
    assert any(isinstance(m, M.VoteElim) for m in mechs)
    assert any(isinstance(m, M.AuctionScore) for m in mechs)
    assert any(isinstance(m, M.ResourceIncome) for m in mechs)
    # P17: team terminal (99) and most-lots terminal (97) coexist
    modes = {cp.dsl_id: m.mode for cp in relic.game.phases
             for m in cp.program.on_enter if isinstance(m, M.GameOver)}
    assert modes[99] == "team" and modes[97] == "score"


@pytest.mark.parametrize("seed", range(4))
def test_auction_mix_oracle_engine_parity(relic, seed):
    room = _run_oracle_vs_engine(relic, 7, seed, max_steps=900)
    assert room.phase.dsl_id in (97, 99)


def test_auction_mix_both_endings_reachable(relic):
    import collections

    ends = collections.Counter()
    for seed in range(12):
        room = OracleRoom(relic.game, n_players=7, seed=seed)
        for t in range(900):
            room.step(oracle_policy(room, t, seed))
            if room.done:
                break
        assert room.done
        ends[room.phase.dsl_id] += 1
    assert ends[97] > 0 and ends[99] > 0, dict(ends)


def test_cpp_parity_auction_mix(relic):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 2):
        run_differential(relic, n_players=7, seed=seed, max_steps=900)


def test_catalog_relic_auction_matches_generator():
    import os

    import yaml

    from game_engine_tpu.gamespec.parser import games_dir

    path = os.path.join(games_dir(), "relic-auction.yaml")
    on_disk = yaml.safe_load(open(path))
    assert on_disk == generate_from_description("relic-auction", RELIC_AUCTION_DESC)


# ---------------------------------------------------------------------------
# battle + auction mix
# ---------------------------------------------------------------------------

TROPHY_ARENA_DESC = (
    "Gladiators vote one of their own out of the arena each round and "
    "bid in a sealed-bid auction for trophy lots; survive to the end or "
    "collect the most lots when the house closes"
)


@pytest.fixture(scope="module")
def trophy():
    doc = generate_from_description("trophy-arena", TROPHY_ARENA_DESC)
    issues, spec = validate_doc(doc, name="trophy-arena")
    assert not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


@pytest.mark.parametrize("seed", range(3))
def test_battle_auction_oracle_engine_parity(trophy, seed):
    room = _run_oracle_vs_engine(trophy, 6, seed, max_steps=900)
    assert room.phase.dsl_id in (97, 99)


def test_battle_auction_both_endings_reachable(trophy):
    import collections

    ends = collections.Counter()
    for seed in range(14):
        room = OracleRoom(trophy.game, n_players=6, seed=seed)
        for t in range(900):
            room.step(oracle_policy(room, t, seed))
            if room.done:
                break
        assert room.done
        ends[room.phase.dsl_id] += 1
    assert ends[97] > 0 and ends[99] > 0, dict(ends)


def test_catalog_trophy_arena_matches_generator():
    import os

    import yaml

    from game_engine_tpu.gamespec.parser import games_dir

    path = os.path.join(games_dir(), "trophy-arena.yaml")
    on_disk = yaml.safe_load(open(path))
    assert on_disk == generate_from_description("trophy-arena", TROPHY_ARENA_DESC)


def test_cpp_parity_battle_auction(trophy):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 2):
        run_differential(trophy, n_players=6, seed=seed, max_steps=900)


@pytest.mark.parametrize("fixture,n_players", [
    ("goldrush", 6), ("bounty", 6), ("relic", 7), ("trophy", 6)])
def test_mix_batch_split_invariance(fixture, n_players, request):
    from tests.rollout_helpers import assert_batch_split_invariant

    lowered = request.getfixturevalue(fixture)
    assert_batch_split_invariant(lowered, min(n_players, lowered.P), steps=48)
