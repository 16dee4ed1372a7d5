"""STACKED mechanic mixes (round-4 continuation): two extra families on one
base phase graph — elimination/battle + market + auction, with THREE live
terminals (base rule, richest purse 98, first-to-N-lots 97). The reference
composes arbitrary mechanic subsets through its LLM referee (reference:
agent/dsl_agent.py:157-371); the generator now composes registered stacks
structurally: the raid round rides the night-continue edge, the lot round
the day-continue edge, the stacked auction skips its own income (the
market already pays) and triggers on lots rather than a second
coins-threshold key that first-match-wins would shadow.
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

HARBOR_LOTS_DESC = (
    "A harbor town hides two bandits who kill at night; a healer protects "
    "and a sheriff investigates. Each morning survivors collect coins, "
    "raid a rival purse at dawn, and bid in a sealed-bid auction for dusk "
    "lots. Eliminate the bandits, strike it rich, or corner the lots."
)


@pytest.fixture(scope="module")
def harbor():
    report = []
    doc = generate_from_description("harbor-lots", HARBOR_LOTS_DESC,
                                    report=report)
    assert not report, report
    issues, spec = validate_doc(doc, name="harbor-lots")
    assert spec is not None and not errors(issues)
    assert not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


@pytest.fixture(scope="module")
def brawl():
    doc = generate(Blueprint(name="brawl", description="d",
                             archetype="battle",
                             extras=("market", "auction")))
    issues, spec = validate_doc(doc, name="brawl")
    assert spec is not None and not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


def test_description_mining_composes_the_stack(harbor):
    spec = harbor.game.spec
    names = {ph.name for ph in spec.phases.values()}
    assert {"Raid Selection", "Raid Resolution", "Sealed Bids",
            "Auction Resolution"} <= names
    assert {"coins", "bid_choice", "points"} <= set(
        spec.declaration.field_names())
    roles = [r.name for r in spec.declaration.roles]
    assert "Bandit" in roles and "Healer" in roles and "Sheriff" in roles


def test_stack_attaches_every_family_once(harbor):
    spec = harbor.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    mechs = [m for pp in progs.values() for m in pp.on_enter]
    kinds = collections.Counter(type(m).__name__ for m in mechs)
    assert kinds["ResourceRaid"] == 1 and kinds["AuctionScore"] == 1
    assert {"RoleAssign", "NightResolve", "VoteElim",
            "ResourceIncome"} <= set(kinds)
    # the stacked auction must NOT double the income: every income phase
    # (the base's First Morning + Morning) keeps the market weave's single
    # (coins, 1) gain — a second sentence would have attached (coins, 2)
    incomes = [m.gains for m in mechs if isinstance(m, M.ResourceIncome)]
    assert incomes and all(g == (("coins", 1),) for g in incomes)


def test_stack_three_terminal_modes(harbor):
    spec = harbor.game.spec
    progs = M.analyze(spec, build_layout(spec.declaration))
    modes = {pid: (m.mode, m.score_field or m.team_field)
             for pid, pp in progs.items() for m in pp.on_enter
             if isinstance(m, M.GameOver)}
    assert modes[99] == ("team", "team")
    assert modes[98] == ("score", "coins")
    assert modes[97] == ("score", "points")


def test_stack_lot_trigger_is_points_not_a_second_coins_key(harbor):
    """The shadowing hazard the solo guard warned about: the 97 edge keys
    on points, so the 98 coins key cannot shadow it (first-match-wins)."""
    spec = harbor.game.spec
    check = next(ph for ph in spec.phases.values()
                 if ph.name == "Check Win Conditions")
    keys = [b.condition for b in check.branches]
    coin_keys = [k for k in keys if "coins" in k]
    point_keys = [k for k in keys if "points" in k]
    assert len(coin_keys) == 1 and len(point_keys) == 1


@pytest.mark.parametrize("seed", range(3))
def test_stack_oracle_engine_parity(harbor, seed):
    room = _run_oracle_vs_engine(harbor, 5 + seed, seed, max_steps=900)
    assert room.phase.dsl_id in (97, 98, 99)


@pytest.mark.parametrize("seed", (0, 1))
def test_battle_stack_oracle_engine_parity(brawl, seed):
    room = _run_oracle_vs_engine(brawl, 5, seed, max_steps=900)
    assert room.phase.dsl_id in (97, 98, 99)


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


def test_stack_all_three_endings_reachable(harbor):
    ends = _endings(harbor, (7, 8), 40)
    assert ends[97] > 0 and ends[98] > 0 and ends[99] > 0, dict(ends)


def test_battle_stack_all_three_endings_reachable(brawl):
    ends = _endings(brawl, (4, 6), 18)
    assert ends[97] > 0 and ends[98] > 0 and ends[99] > 0, dict(ends)


def test_unregistered_stacks_reject_loudly():
    with pytest.raises(ValueError, match="no stacked mix"):
        generate(Blueprint("g", "d", "rounds",
                           extras=("market", "auction")))
    with pytest.raises(ValueError, match="duplicate extras"):
        generate(Blueprint("g", "d", "elimination",
                           extras=("market", "market")))


def test_stack_order_is_canonical():
    """extras order must not matter — ('market','auction') and
    ('auction','market') produce the identical doc."""
    a = generate(Blueprint("g", "d", "elimination",
                           extras=("market", "auction")))
    b = generate(Blueprint("g", "d", "elimination",
                           extras=("auction", "market")))
    assert a == b


def test_catalog_harbor_lots_matches_generator():
    path = os.path.join(games_dir(), "harbor-lots.yaml")
    on_disk = yaml.safe_load(open(path))
    assert on_disk == generate_from_description("harbor-lots",
                                                HARBOR_LOTS_DESC)


def test_cpp_parity_stack(harbor):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 15):
        run_differential(harbor, n_players=7, seed=seed, max_steps=900)


def test_harbor_batch_split_invariance(harbor):
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(harbor, n_players=7, steps=48)
