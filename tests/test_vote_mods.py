"""P6p/P6w: parameterized vote/night resolution (protection + vote weight).

Round-5 mechanic families (VERDICT r4 item 4). The reference referee can
apply any described immunity or weighted-vote house rule as free-form
state writes (reference: agent/tools/backend_tools.py:204-225,
agent/prompt/referee_system_prompt_1.txt); here they are DECLARED hint
args lowered into the existing effect-IR vote/night programs
(gamespec/effects.py vote_elim_program / night_resolve_program) — no new
executor code, all four executors inherit via the shared lowering.
"""

import copy

import numpy as np
import pytest
import yaml

from game_engine_tpu.core.engine import (BatchedEngine, compiled_rollout,
                                         scripted_actions)
from game_engine_tpu.core.state import init_state
from game_engine_tpu.dslgen import rules as RU
from game_engine_tpu.dslgen.generate import generate_from_description
from game_engine_tpu.dslgen.validate import validate_doc
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches

SHIELD_WALL_DESC = (
    "A last-one-standing elimination battle: discuss, vote someone out "
    "every round, survive to the end. At the start of the game, each "
    "player receives 5 coins. Every round, the richest player gives 1 "
    "coin to the poorest player. Players with 8 or more coins cannot be "
    "eliminated. The vote of a player with 6 or more coins counts double.")


# ---------------------------------------------------------------------------
# grammar
# ---------------------------------------------------------------------------


def test_mine_rules_v2_families():
    rules = {r.kind: r for r in RU.mine_rules(SHIELD_WALL_DESC)}
    assert set(rules) == {"one_shot", "transfer", "protection",
                          "vote_weight"}
    assert rules["one_shot"].amount == 5
    t = rules["transfer"]
    assert (t.src_sel, t.dst_sel, t.amount) == ("max", "min", 1)
    assert rules["protection"].amount == 8
    assert rules["vote_weight"].amount == 6


def test_mine_steal_reverses_direction():
    (r,) = RU.mine_rules(
        "Each round, the poorest player steals 2 coins from the richest "
        "player.")
    assert r.kind == "transfer"
    # the poorest ACTS, but the richest pays: src is the argmax side
    assert (r.src_sel, r.dst_sel, r.amount) == ("max", "min", 2)


def test_same_selector_transfer_is_not_mined():
    assert RU.mine_rules(
        "Each round, the richest player gives 1 coin to the "
        "wealthiest player.") == []


# ---------------------------------------------------------------------------
# controlled-vote semantics (oracle, explicit ballots)
# ---------------------------------------------------------------------------


def _mini_vote_doc(protect: str = "", weight: str = ""):
    """last-stand + a shields field granted by seat in the discussion
    phase; vote_elimination optionally parameterized."""
    doc = yaml.safe_load(open("games/last-stand.yaml"))
    doc["declaration"]["player_states"]["shields"] = {
        "type": "num", "example": 0, "description": "Protection tokens."}
    doc["declaration"]["player_states_template"]["player_states"]["1"][
        "shields"] = 0
    for row in doc["declaration"]["players_example"][
            "player_states"].values():
        row["shields"] = 0
    doc["phases"][1].setdefault("mechanics", []).append(
        {"effects": ["shields = 3 where seat == 1",
                     "shields = 1 where seat == 5"]})
    args = {}
    if protect:
        args["protect"] = protect
    if weight:
        args["weight"] = weight
    if args:
        doc["phases"][3]["mechanics"] = [{"vote_elimination": args}]
    issues, spec = validate_doc(doc, name="mini-vote")
    assert not [i for i in issues if i.severity == "error"], issues
    return compile_game(spec)


def _run_one_vote(game, ballots: dict[int, int]):
    """Advance an oracle room to the first vote, cast `ballots`, resolve,
    and return the room."""
    room = OracleRoom(game, n_players=5, seed=0)
    from game_engine_tpu.gamespec.schema import CompletionType

    for _ in range(20):
        if room.phase.completion is CompletionType.PLAYER_ACTION:
            break
        room.step(None)
    assert room.phase.completion is CompletionType.PLAYER_ACTION
    room.step(ballots)           # cast + resolve (phase advances when full)
    for _ in range(3):           # land on/after the announce phase
        if any(not p.get("is_alive", True) for p in room.players.values()):
            break
        room.step(None)
    return room


def _alive_map(room):
    return {p: bool(r.get("is_alive", True)) for p, r in room.players.items()}


def test_protect_blocks_plurality_victim():
    # everyone votes seat 1 (3 shields). Unprotected: seat 1 dies.
    ballots = {p: 1 for p in range(1, 6)}
    base = _run_one_vote(_mini_vote_doc(), ballots)
    assert _alive_map(base)[1] is False
    prot = _run_one_vote(_mini_vote_doc(protect="shields >= 3"), ballots)
    alive = _alive_map(prot)
    assert alive[1] is True, "3-shield seat must be immune"
    assert all(alive.values()), "nobody else may die in their place"


WEIGHT_SEAT5 = "if(shields == 1, 2, 1)"  # doubles exactly seat 5's ballot


def test_weight_flips_the_winner():
    # Ballots: 1->4, 2->3, 5->3, 3->1, 4->1.
    # Unweighted counts: seat 1: 2, seat 3: 2, seat 4: 1 -> tie breaks to
    # the LOWEST candidate seat (1). With seat 5's ballot doubled, seat 3
    # takes 3 outright — a different victim.
    ballots = {1: 4, 2: 3, 5: 3, 3: 1, 4: 1}
    base = _run_one_vote(_mini_vote_doc(), ballots)
    alive = _alive_map(base)
    assert alive[1] is False and alive[3] is True
    wt = _run_one_vote(_mini_vote_doc(weight=WEIGHT_SEAT5), ballots)
    alive = _alive_map(wt)
    assert alive[3] is False and alive[1] is True


def test_weight_makes_a_minority_ballot_tie():
    # Ballots: 1->4, 2->4, 5->3, 3->5, 4->5. Unweighted: seats 4 and 5
    # tie at 2 (seat 3 has 1) -> lowest candidate seat 4 dies. Weighted:
    # seat 3 joins the tie at 2 and is now the lowest candidate.
    ballots = {1: 4, 2: 4, 5: 3, 3: 5, 4: 5}
    base = _run_one_vote(_mini_vote_doc(), ballots)
    alive = _alive_map(base)
    assert alive[4] is False and alive[3] is True
    wt = _run_one_vote(_mini_vote_doc(weight=WEIGHT_SEAT5), ballots)
    alive = _alive_map(wt)
    assert alive[3] is False and alive[4] is True


# ---------------------------------------------------------------------------
# night protection (werewolf + hint arg)
# ---------------------------------------------------------------------------


def _werewolf_with_night_protect(protect: str):
    doc = yaml.safe_load(open("games/werewolf-(mafia).yaml"))
    doc = copy.deepcopy(doc)
    # morning phases carry the text-matched night_resolution; add the
    # parameterized hint explicitly on every morning phase
    for pid, ph in doc["phases"].items():
        text = (ph.get("name", "") + " " + ph.get("description", "")).lower()
        if "morning" in text and "announce" in text:
            ph["mechanics"] = [{"night_resolution": {"protect": protect}}]
    issues, spec = validate_doc(doc, name="ww-protect")
    assert not [i for i in issues if i.severity == "error"], issues
    return compile_game(spec)


def test_night_protect_blocks_night_kills_only():
    game = _werewolf_with_night_protect("seat == 2")
    baseline = compile_game(
        validate_doc(yaml.safe_load(open("games/werewolf-(mafia).yaml")),
                     name="ww-base")[1])
    saw_discriminating_seed = False
    for seed in range(8):
        rooms = {}
        for label, g in (("prot", game), ("base", baseline)):
            room = OracleRoom(g, n_players=6, seed=seed)
            died_in = None
            alive_prev = True
            for t in range(400):
                if room.done:
                    break
                room.step(oracle_policy(room, t, seed))
                alive_now = bool(room.players[2].get("is_alive", True))
                if alive_prev and not alive_now:
                    died_in = room.phase.name.lower()
                alive_prev = alive_now
            rooms[label] = died_in
        if rooms["prot"] is not None:
            # protected seat 2 may die only from a day vote
            assert "voting" in rooms["prot"] or "result" in rooms["prot"], (
                seed, rooms["prot"])
        if rooms["base"] is not None and "morning" in rooms["base"]:
            saw_discriminating_seed = True
    assert saw_discriminating_seed, (
        "no seed night-killed seat 2 in the baseline — test cannot "
        "discriminate; widen the seed range")


# ---------------------------------------------------------------------------
# four-executor parity on the generated witness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shield_wall():
    from game_engine_tpu.gamespec.tables import lower

    doc = generate_from_description("shield-wall", SHIELD_WALL_DESC)
    issues, spec = validate_doc(doc, name="shield-wall")
    assert not [i for i in issues if i.severity == "error"], issues
    return lower(compile_game(spec))


@pytest.mark.parametrize("seed", range(3))
def test_oracle_engine_parity(shield_wall, seed):
    lowered = shield_wall
    room = OracleRoom(lowered.game, n_players=5, seed=seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, 5, np.uint32(seed))
    for t in range(400):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done


def test_cpp_parity(shield_wall):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 2):
        run_differential(shield_wall, n_players=5, seed=seed, max_steps=400)


# ---------------------------------------------------------------------------
# validator discipline
# ---------------------------------------------------------------------------


def test_validator_rejects_bad_guard_field():
    doc = yaml.safe_load(open("games/last-stand.yaml"))
    doc["phases"][3]["mechanics"] = [
        {"vote_elimination": {"protect": "nosuchfield >= 3"}}]
    issues, _ = validate_doc(doc, name="bad")
    assert any("protect expression rejected" in str(i) for i in issues
               if i.severity == "error")


def test_validator_rejects_unknown_hint_arg():
    doc = yaml.safe_load(open("games/last-stand.yaml"))
    doc["phases"][3]["mechanics"] = [{"vote_elimination": {"wat": "1"}}]
    issues, _ = validate_doc(doc, name="bad2")
    assert any("unknown" in str(i) for i in issues
               if i.severity == "error")


def test_shield_wall_batch_split_invariance(shield_wall):
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(shield_wall, n_players=5, steps=80)
