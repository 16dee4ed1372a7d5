"""New mechanic families (round 2): bluff-challenge (P14), resource
income/raids (P12/P13), and role-reveal-on-death (P15) — three-executor
bit-parity (oracle <-> XLA <-> C++) on the generated bluff and
market archetypes, plus unit pins for the resolution rules."""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.dslgen.generate import Blueprint, generate
from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches


@pytest.fixture(scope="module")
def bluff():
    doc = generate(Blueprint(name="t-bluff", description="a bluff game",
                             archetype="bluff"))
    issues, spec = validate_doc(doc, name="t-bluff")
    assert spec is not None and not errors(issues)
    assert not issues, [str(i) for i in issues]  # zero warnings
    return lower(compile_game(spec))


@pytest.fixture(scope="module")
def market():
    doc = generate(Blueprint(name="t-market", description="a market game",
                             archetype="market"))
    issues, spec = validate_doc(doc, name="t-market")
    assert spec is not None and not errors(issues)
    assert not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


def _run_oracle_vs_engine(lowered, n, seed, max_steps=500):
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
def test_bluff_oracle_engine_parity(bluff, seed):
    n = min(4 + seed, bluff.P)
    room = _run_oracle_vs_engine(bluff, n, seed)
    # winner 0 is the pinned mutual-annihilation draw; otherwise a survivor
    assert 0 <= room.winner <= n


@pytest.mark.parametrize("seed", range(4))
def test_market_oracle_engine_parity(market, seed):
    n = min(4 + seed, market.P)
    room = _run_oracle_vs_engine(market, n, seed)
    assert 1 <= room.winner <= n
    coins = [room.players[p]["coins"] for p in range(1, n + 1)]
    assert max(coins) >= 10  # the any-player-has-N-coins branch fired
    assert coins[room.winner - 1] == max(coins)


@pytest.mark.parametrize("game", ["bluff", "market"])
def test_cpp_parity_new_mechanics(game, bluff, market):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    lowered = bluff if game == "bluff" else market
    for seed in (0, 3):
        run_differential(lowered, n_players=min(5, lowered.P), seed=seed,
                         max_steps=500)


@pytest.mark.parametrize("game", ["bluff", "market"])
def test_batch_split_invariance_new_mechanics(game, bluff, market):
    from tests.rollout_helpers import assert_batch_split_invariant

    lowered = bluff if game == "bluff" else market
    assert_batch_split_invariant(lowered, min(5, lowered.P), steps=40)


def test_role_revealed_on_death_werewolf():
    """P15: werewolf eliminations set role_revealed on the victim, in both
    the oracle and the engine (previously a silent gap flagged by the
    validator)."""
    from game_engine_tpu.gamespec.parser import load_builtin

    lowered = lower(compile_game(load_builtin("werewolf")))
    room = OracleRoom(lowered.game, n_players=6, seed=5)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, 6, np.uint32(5))
    saw_reveal = False
    for t in range(300):
        room.step(oracle_policy(room, t, 5))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        for p in range(1, 7):
            alive = room.players[p].get("is_alive", True)
            revealed = room.players[p].get("role_revealed", False)
            if not alive:
                assert revealed, f"p{p} died unrevealed at t={t}"
                saw_reveal = True
            else:
                assert not revealed
        if room.done:
            break
    assert room.done and saw_reveal


def test_bluff_resolution_pins():
    """Unit pins for P14 on a hand-driven oracle room: caught bluffer loses,
    honest claim costs the lowest-id challenger, losses are simultaneous."""
    doc = generate(Blueprint(name="pin-bluff", description="b", archetype="bluff"))
    _, spec = validate_doc(doc, name="pin-bluff")
    lowered = lower(compile_game(spec))
    room = OracleRoom(lowered.game, n_players=4, seed=0)
    room.step({})  # intro -> role assignment
    room.step({})  # role assignment -> declarations
    assert room.phase.name == "Declarations"
    roles = [r.name for r in lowered.game.spec.declaration.roles]
    role_idx = {p: roles.index(room.players[p]["role"]) + 1 for p in range(1, 5)}
    # p1 claims truthfully, p2 lies, p3/p4 claim truthfully
    claims = {p: role_idx[p] for p in range(1, 5)}
    claims[2] = role_idx[2] % len(roles) + 1  # a different role = a lie
    room.step(claims)
    assert room.phase.name == "Challenges"
    # p3 and p4 both challenge p1 (honest); p1 challenges p2 (liar);
    # p2 challenges p2... self-challenge is void -> challenge p3 instead
    room.step({1: 2, 2: 3, 3: 1, 4: 1})
    assert room.phase.name == "Showdown" or room.phase.name == "Check the Court"
    inf = {p: room.players[p]["influence"] for p in range(1, 5)}
    assert inf[1] == 2  # honest claim: p1 loses nothing
    # p2 loses twice in one showdown (simultaneous accumulation): caught
    # lying by p1's challenge, AND failed their own challenge of honest p3
    assert inf[2] == 0
    assert not room.players[2]["is_alive"]  # zero influence = eliminated
    assert inf[3] == 1  # lowest-id challenger of honest p1 pays
    assert inf[4] == 2  # higher-id challenger of p1 pays nothing


def test_raid_resolution_pins():
    """Unit pins for P13: loss = min(coins, raiders); lowest-id raiders gain;
    self-raid void; all simultaneous from pre-phase values."""
    doc = generate(Blueprint(name="pin-market", description="m", archetype="market"))
    _, spec = validate_doc(doc, name="pin-market")
    lowered = lower(compile_game(spec))
    room = OracleRoom(lowered.game, n_players=4, seed=0)
    room.step({})  # intro -> income
    room.step({})  # income applied -> raid selection
    assert room.phase.name == "Raid Selection"
    coins0 = {p: room.players[p]["coins"] for p in range(1, 5)}
    assert all(c == 4 for c in coins0.values())  # 3 template + 1 income
    # everyone raids p4; p4 raids p1
    room.step({1: 4, 2: 4, 3: 4, 4: 1})
    # resolution: p4 loses min(4, 3)=3 -> gains 1 from raiding p1 -> 4-3+1=2
    # p1 loses 1 to p4's raid, gains 1 (rank 0 of 3 raiders) -> 4
    # p2 gains 1 (rank 1) -> 5 ; p3 gains 1 (rank 2) -> 5
    assert room.players[4]["coins"] == 2
    assert room.players[1]["coins"] == 4
    assert room.players[2]["coins"] == 5
    assert room.players[3]["coins"] == 5


def test_generate_from_description_picks_new_archetypes():
    from game_engine_tpu.dslgen.generate import generate_from_description

    doc = generate_from_description("court", "a bluffing game of challenges and influence")
    assert "influence" in doc["declaration"]["player_states"]
    doc = generate_from_description("bazaar", "collect coins and raid your rivals")
    assert "coins" in doc["declaration"]["player_states"]


def test_reveal_on_death_without_is_alive_four_way():
    """P15 with no is_alive field: reveal flags still set on the plurality
    victim in ALL executors (review finding: the jax path skipped
    them when alive_bool < 0 while oracle/C++ set them)."""
    from tests.test_fuzz_alien import _council_doc

    doc = _council_doc()
    # no is_alive: deaths become reveal-only marks
    del doc["declaration"]["player_states"]["is_alive"]
    del doc["declaration"]["player_states_template"]["player_states"]["1"]["is_alive"]
    doc["declaration"]["player_states"]["role_revealed"] = {
        "type": "boolean", "example": False,
        "description": "Set when the member's role is revealed on expulsion."}
    doc["declaration"]["player_states_template"]["player_states"]["1"][
        "role_revealed"] = False
    doc["phases"][2]["completion_criteria"]["target_players"]["condition"] = \
        "player.role_revealed == false"
    doc["phases"][4]["next_phase"] = {
        "If no living members remain, the game ends.": {"id": 99, "name": "Game Over"},
        "Otherwise, the council continues.": {"id": 1, "name": "Council Discussion"},
    }
    from game_engine_tpu.dslgen.validate import errors, validate_doc

    issues, spec = validate_doc(doc, name="revealers")
    assert spec is not None and not errors(issues), [str(i) for i in issues]
    lowered = lower(compile_game(spec))
    assert lowered.alive_bool < 0  # the premise of the regression
    n, seed = 4, 2
    room = OracleRoom(lowered.game, n_players=n, seed=seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, n, np.uint32(seed))
    saw_reveal = False
    for t in range(60):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if any(room.players[p].get("role_revealed") for p in range(1, n + 1)):
            saw_reveal = True
            break
    assert saw_reveal, "no reveal ever happened — the regression is untested"
    # C++ parity on the same doc
    from game_engine_tpu.native import available

    if available():
        from tests.test_native import run_differential

        run_differential(lowered, n_players=n, seed=seed, max_steps=60)


def test_income_requires_everyone_subject():
    """'The winner receives 3 coins' must NOT pay the whole room (review
    finding: P12's regex lacked the each/all/every-players gate)."""
    from game_engine_tpu.dslgen.generate import Blueprint, generate
    from game_engine_tpu.gamespec import mechanics as M

    doc = generate(Blueprint(name="m", description="m", archetype="market"))
    doc["phases"][3]["description"] = (
        "Resolve the raids: the winner receives 3 coins from the losers.")
    from game_engine_tpu.dslgen.validate import validate_doc

    _, spec = validate_doc(doc, name="m")
    game = compile_game(spec)
    for cp in game.phases:
        if cp.dsl_id == 3:
            kinds = [type(m).__name__ for m in cp.program.on_enter]
            assert "ResourceIncome" not in kinds, kinds
    # the real income phase still attaches
    for cp in game.phases:
        if cp.dsl_id == 1:
            kinds = [type(m).__name__ for m in cp.program.on_enter]
            assert "ResourceIncome" in kinds, kinds


@pytest.fixture(scope="module")
def minority():
    doc = generate(Blueprint(name="t-minority", description="odd one out",
                             archetype="minority"))
    issues, spec = validate_doc(doc, name="t-minority")
    assert spec is not None and not errors(issues)
    assert not issues, [str(i) for i in issues]
    return lower(compile_game(spec))


@pytest.mark.parametrize("seed", range(3))
def test_minority_oracle_engine_parity(minority, seed):
    n = min(3 + seed, minority.P)
    room = _run_oracle_vs_engine(minority, n, seed)
    pts = [room.players[p]["points"] for p in range(1, n + 1)]
    assert max(pts) >= 5 and pts[room.winner - 1] == max(pts)


def test_minority_cpp_and_pallas_parity(minority):
    from game_engine_tpu.native import available

    if available():
        from tests.test_native import run_differential

        run_differential(minority, n_players=4, seed=1, max_steps=500)
    B, steps = 8, 60
    s0 = init_state(minority, B, 4, np.arange(B, dtype=np.uint32))
    _ref_state, ref_eps = compiled_rollout(minority, steps)(s0)
    assert int(ref_eps) > 0


def test_minority_resolution_pins(minority):
    """Unit pins for P16: smallest non-empty group scores; ties to lowest
    option; a lone group has no minority; picks reset after the reveal."""
    room = OracleRoom(minority.game, n_players=5, seed=0)
    room.step({})  # intro -> picks
    assert room.phase.name == "Secret Picks"
    room.step({1: 1, 2: 1, 3: 2, 4: 2, 5: 3})  # door 3 is the minority
    pts = {p: room.players[p]["points"] for p in range(1, 6)}
    assert pts == {1: 0, 2: 0, 3: 0, 4: 0, 5: 1}
    assert all(room.players[p]["pick_choice"] == 0 for p in range(1, 6))  # reset
    # tie between two smallest groups -> lowest option index wins
    while room.phase.name != "Secret Picks":
        room.step({})
    room.step({1: 1, 2: 2, 3: 3, 4: 3, 5: 3})  # doors 1 and 2 tie at 1 pick
    pts = {p: room.players[p]["points"] for p in range(1, 6)}
    assert pts[1] == 1 and pts[2] == 0  # door 1 (lowest index) scored
    # everyone on one door: no minority, nobody scores
    while room.phase.name != "Secret Picks":
        room.step({})
    before = {p: room.players[p]["points"] for p in range(1, 6)}
    room.step({p: 2 for p in range(1, 6)})
    after = {p: room.players[p]["points"] for p in range(1, 6)}
    assert after == before
