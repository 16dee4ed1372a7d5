"""Round-4 mechanic-mix matrix extension: the market/auction families now
weave into the rounds, bluff, and racing base archetypes (previously only
elimination/battle). The reference composes arbitrary mechanics through its
LLM referee (reference: agent/dsl_agent.py:157-371,
agent/prompt/referee_system_prompt_1.txt); the deterministic generator
widens its structural composition matrix instead: 8 (base, extra) pairs,
each spliced into the base's own check/continue loop with P17 per-terminal
winner modes keeping both endings live.

New in this extension (and pinned here):
- weaves parameterize WHO acts (bases without an ``is_alive`` field pass a
  vacuously-true predicate in their own action-phase style);
- the woven terminal declares its winner explicitly (P18
  ``{winner: {score: ...}}``) — bases with a score-like field (rounds'
  total_score) would otherwise capture the "Richest" terminal;
- income can ride an explicit ``{income: {coins: n}}`` hint for bases whose
  resolution phase carries a P20 effects program (racing), where text
  income mining is disabled by design (mechanics.py P12 rule).
"""

import collections
import os

import pytest
import yaml

from game_engine_tpu.dslgen.generate import (
    Blueprint,
    generate,
    generate_from_description,
)
from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.layout import build_layout
from game_engine_tpu.gamespec.parser import games_dir
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_mix import _run_oracle_vs_engine

STORY_POT_DESC = (
    "Storytellers tell three statements and the table guesses which one is "
    "the lie; at each round start every player collects 1 coin from the "
    "story pot and raids a rival purse. Guess true, speak well, and the "
    "richest storyteller wins."
)
GILDED_COURT_DESC = (
    "Courtiers claim the Duke, Captain or Inquisitor roles and challenge "
    "each other's bluffs; at each showdown the court treasury pays out "
    "coins and holds a sealed-bid auction for gilded lots until the house "
    "closes. Outlast the court or collect the most lots."
)
SCRAP_RALLY_DESC = (
    "Racers pick a speed each sprint and collide when they overtake on the "
    "same line; every movement pays a sponsorship coin, and racers raid a "
    "rival pit before the next lap. Reach the finish line or get rich "
    "trying."
)


def _lowered(name, desc):
    report = []
    doc = generate_from_description(name, desc, report=report)
    assert not report, report  # full-coverage descriptions: no warnings
    issues, spec = validate_doc(doc, name=name)
    assert spec is not None and not errors(issues)
    assert not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


@pytest.fixture(scope="module")
def storypot():
    return _lowered("story-pot", STORY_POT_DESC)


@pytest.fixture(scope="module")
def gilded():
    return _lowered("gilded-court", GILDED_COURT_DESC)


@pytest.fixture(scope="module")
def rally():
    return _lowered("scrap-rally", SCRAP_RALLY_DESC)


@pytest.fixture(scope="module")
def courtraid():
    doc = generate(Blueprint(name="court-raid", description="d",
                             archetype="bluff", extras=("market",)))
    issues, spec = validate_doc(doc, name="court-raid")
    assert spec is not None and not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


# ---------------------------------------------------------------------------
# routing: descriptions pick the base AND compose the extra
# ---------------------------------------------------------------------------


def test_story_market_routes_to_rounds_mix(storypot):
    spec = storypot.game.spec
    names = {ph.name for ph in spec.phases.values()}
    # base rounds loop + woven raid round + both terminals
    assert {"Round Start", "Voting Phase", "Raid Selection",
            "Raid Resolution"} <= names
    assert "coins" in spec.declaration.field_names()
    assert "total_score" in spec.declaration.field_names()


def test_court_auction_routes_to_bluff_mix_and_mines_the_court(gilded):
    spec = gilded.game.spec
    names = {ph.name for ph in spec.phases.values()}
    assert {"Declarations", "Challenges", "Sealed Bids",
            "Auction Resolution"} <= names
    assert [r.name for r in spec.declaration.roles][:3] == [
        "Duke", "Captain", "Inquisitor"]


def test_race_market_routes_to_racing_mix(rally):
    spec = rally.game.spec
    names = {ph.name for ph in spec.phases.values()}
    assert {"Speed Selection", "Movement Resolution", "Raid Selection",
            "Raid Resolution"} <= names
    assert {"position", "coins"} <= set(spec.declaration.field_names())


# ---------------------------------------------------------------------------
# mechanics + P17 terminal modes per pair
# ---------------------------------------------------------------------------


def _modes_and_kinds(lowered):
    spec = lowered.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    kinds = {type(m).__name__ for pp in progs.values() for m in pp.on_enter}
    modes = {pid: (m.mode, m.score_field or m.team_field)
             for pid, pp in progs.items() for m in pp.on_enter
             if isinstance(m, M.GameOver)}
    return modes, kinds


def test_rounds_market_terminals_keep_base_score_field(storypot):
    """The P18 winner declaration on the woven terminal: without it, the
    'Richest' terminal text resolves generically to the base's score-like
    field (total_score) and the coin race would award round points."""
    modes, kinds = _modes_and_kinds(storypot)
    assert modes[99] == ("score", "total_score")
    assert modes[98] == ("score", "coins")
    assert {"GuessScore", "SpeakerRotate", "ResourceIncome",
            "ResourceRaid"} <= kinds


def test_bluff_auction_terminals(gilded):
    modes, kinds = _modes_and_kinds(gilded)
    assert modes[99] == ("survivor", "")
    assert modes[97] == ("score", "points")
    assert {"BluffChallenge", "RoleAssign", "AuctionScore",
            "ResourceIncome"} <= kinds


def test_bluff_market_terminals(courtraid):
    """bluff's influence is a lives field: it blocks the resource fallback,
    so the base terminal stays survivor-won even with a coins field."""
    modes, kinds = _modes_and_kinds(courtraid)
    assert modes[99] == ("survivor", "")
    assert modes[98] == ("score", "coins")
    assert {"BluffChallenge", "ResourceIncome", "ResourceRaid"} <= kinds


def test_racing_market_income_rides_the_hint(rally):
    """Movement Resolution carries the P20 movement program, which disables
    text income mining — the income must attach from the explicit
    {income: {coins: 1}} hint, alongside the effects program."""
    spec = rally.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    move = next(pid for pid, ph in spec.phases.items()
                if ph.name == "Movement Resolution")
    kinds = [type(m).__name__ for m in progs[move].on_enter]
    assert "ResourceIncome" in kinds and "Effects" in kinds
    inc = next(m for m in progs[move].on_enter
               if isinstance(m, M.ResourceIncome))
    assert inc.gains == (("coins", 1),)
    modes, _ = _modes_and_kinds(rally)
    assert modes[99] == ("score", "position")  # base winner hint survives
    assert modes[98] == ("score", "coins")


# ---------------------------------------------------------------------------
# four-way executor parity + both endings reachable per pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_rounds_market_oracle_engine_parity(storypot, seed):
    room = _run_oracle_vs_engine(storypot, 4 + seed, seed, max_steps=900)
    assert room.phase.dsl_id in (98, 99)


@pytest.mark.parametrize("seed", range(3))
def test_bluff_auction_oracle_engine_parity(gilded, seed):
    room = _run_oracle_vs_engine(gilded, 4 + seed, seed, max_steps=900)
    assert room.phase.dsl_id in (97, 99)


@pytest.mark.parametrize("seed", range(3))
def test_racing_market_oracle_engine_parity(rally, seed):
    room = _run_oracle_vs_engine(rally, 4 + seed, seed, max_steps=900)
    assert room.phase.dsl_id in (98, 99)


@pytest.mark.parametrize("seed", (0, 2))
def test_bluff_market_oracle_engine_parity(courtraid, seed):
    room = _run_oracle_vs_engine(courtraid, 5, seed, max_steps=900)
    assert room.phase.dsl_id in (98, 99)


def _endings(lowered, sizes, seeds, max_steps=900):
    ends = collections.Counter()
    for n in sizes:
        for seed in range(seeds):
            room = OracleRoom(lowered.game, n_players=n, seed=seed)
            for t in range(max_steps):
                room.step(oracle_policy(room, t, seed))
                if room.done:
                    break
            assert room.done
            ends[room.phase.dsl_id] += 1
    return ends


def test_rounds_market_both_endings_reachable(storypot):
    ends = _endings(storypot, (4, 6), 12)
    assert ends[98] > 0 and ends[99] > 0, dict(ends)


def test_bluff_auction_both_endings_reachable(gilded):
    ends = _endings(gilded, (4, 6), 12)
    assert ends[97] > 0 and ends[99] > 0, dict(ends)


def test_racing_market_both_endings_reachable(rally):
    ends = _endings(rally, (4, 6), 12)
    assert ends[98] > 0 and ends[99] > 0, dict(ends)


def test_bluff_market_both_endings_reachable(courtraid):
    ends = _endings(courtraid, (4, 6), 12)
    assert ends[98] > 0 and ends[99] > 0, dict(ends)


# ---------------------------------------------------------------------------
# catalog witnesses are byte-exact generator output
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,desc", [
    ("story-pot", STORY_POT_DESC),
    ("gilded-court", GILDED_COURT_DESC),
    ("scrap-rally", SCRAP_RALLY_DESC),
])
def test_catalog_witness_matches_generator(name, desc):
    path = os.path.join(games_dir(), name + ".yaml")
    on_disk = yaml.safe_load(open(path))
    assert on_disk == generate_from_description(name, desc)


# ---------------------------------------------------------------------------
# native parity and batch-split spot checks
# ---------------------------------------------------------------------------


def test_cpp_parity_new_mixes(storypot, gilded):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    run_differential(storypot, n_players=5, seed=1, max_steps=900)
    run_differential(gilded, n_players=6, seed=0, max_steps=900)


def test_rally_batch_split_invariance(rally):
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(rally, n_players=5, steps=48)
