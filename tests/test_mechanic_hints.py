"""P18 explicit mechanic declarations: the `mechanics:` phase key forces
analyzer attachment regardless of vocabulary, with a loud-or-correct
validator contract (unknown / unanchorable hints are errors).

This closes the synonym frontier the alien-fuzz corpus exposes: a game
written with out-of-vocabulary verbs ("expel", "ritual") can pin its
mechanics explicitly instead of relying on keyword detection. The
reference needs no such escape hatch because its referee is an LLM
(reference: agent/prompt/referee_system_prompt_1.txt); here the hints are
part of the DSL contract (SEMANTICS.md P18)."""

import numpy as np

from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import parse_game_spec
from tests.test_fuzz_alien import _council_doc, _run_contract


def _phase_mechs(spec_doc, name, pid):
    issues, spec = validate_doc(spec_doc, name=name)
    assert not errors(issues), [str(i) for i in issues]
    game = compile_game(spec)
    cp = next(c for c in game.phases if c.dsl_id == pid)
    return cp.program.on_enter, issues


def test_synonym_game_with_hint_runs_clean():
    """'Expel' vocabulary + an explicit vote_elimination hint validates
    clean and runs to termination with oracle<->engine parity (without the
    hint this exact doc only warns — test_synonym_elimination_is_loud)."""
    doc = _council_doc(elim_verb="expelled", vote_verb="expel",
                       resolve_name="Expulsion Rite")
    doc["phases"][3]["mechanics"] = ["vote_elimination"]
    outcome, issues = _run_contract(doc, "council-expel-hinted")
    assert outcome == "ran", [str(i) for i in issues]


def test_hinted_program_equals_keyword_program():
    """The hinted synonym game attaches the SAME VoteElim program as the
    keyword game — hints change detection, never semantics."""
    kw = _council_doc()
    hinted = _council_doc(elim_verb="expelled", vote_verb="expel",
                          resolve_name="Expulsion Rite")
    hinted["phases"][3]["mechanics"] = ["vote_elimination"]
    m_kw, _ = _phase_mechs(kw, "kw", 3)
    m_hint, _ = _phase_mechs(hinted, "hint", 3)
    assert m_kw == m_hint
    assert any(isinstance(m, M.VoteElim) for m in m_hint)


def test_ritual_night_with_kill_anchor_runs():
    """'Midnight Ritual' resolution + 'secretly marks' kill phase — both
    out-of-vocabulary — run once night_resolution + kill hints pin them."""
    doc = _council_doc()
    doc["phases"][2]["description"] = "Each member secretly marks one target."
    doc["phases"][2]["mechanics"] = ["kill"]
    doc["phases"][3]["name"] = "The Midnight Ritual"
    doc["phases"][3]["description"] = (
        "Perform the ritual: the marked member leaves the circle.")
    doc["phases"][3]["mechanics"] = ["night_resolution"]
    outcome, issues = _run_contract(doc, "ritual-hinted")
    assert outcome == "ran", [str(i) for i in issues]
    mechs, _ = _phase_mechs(doc, "ritual-hinted", 3)
    nr = next(m for m in mechs if isinstance(m, M.NightResolve))
    assert 2 in nr.kill_phases


def test_unknown_hint_is_error():
    doc = _council_doc()
    doc["phases"][3]["mechanics"] = ["telepathy"]
    issues, _ = validate_doc(doc, name="unknown-hint")
    errs = [str(i) for i in errors(issues)]
    assert any("unknown mechanic 'telepathy'" in e for e in errs), errs


def test_unanchored_hint_is_error():
    """vote_elimination hinted on a phase with no preceding TARGET action
    phase cannot attach — hard error, not a silent no-op."""
    doc = _council_doc()
    doc["phases"][1]["mechanics"] = ["vote_elimination"]
    issues, _ = validate_doc(doc, name="unanchored-hint")
    errs = [str(i) for i in errors(issues)]
    assert any("could not be attached" in e for e in errs), errs


def test_unconsumed_kill_anchor_is_error():
    doc = _council_doc()
    doc["phases"][2]["mechanics"] = ["kill"]  # no night_resolution downstream
    issues, _ = validate_doc(doc, name="dangling-kill")
    errs = [str(i) for i in errors(issues)]
    assert any("anchor 'kill' is not consumed" in e for e in errs), errs


def test_winner_hint_survivor_and_mode_mismatch():
    doc = _council_doc()
    doc["phases"][99]["mechanics"] = [{"winner": "survivor"}]
    issues, spec = validate_doc(doc, name="winner-survivor")
    assert not errors(issues), [str(i) for i in errors(issues)]
    mechs, _ = _phase_mechs(doc, "winner-survivor", 99)
    go = next(m for m in mechs if isinstance(m, M.GameOver))
    assert go.mode == "survivor"

    # requesting a score winner in a game with no num fields must be loud
    bad = _council_doc()
    bad["phases"][99]["mechanics"] = [{"winner": "richest"}]
    issues, _ = validate_doc(bad, name="winner-impossible")
    errs = [str(i) for i in errors(issues)]
    assert any("winner hint requested 'score'" in e for e in errs), errs


def test_income_hint_with_params_runs_and_pays():
    """{income: {coins: 2}} on the discussion phase attaches a declared
    ResourceIncome and the oracle actually pays it out."""
    from game_engine_tpu.gamespec.tables import lower
    from game_engine_tpu.oracle.interp import OracleRoom
    from game_engine_tpu.policies.scripted import oracle_policy

    doc = _council_doc()
    doc["declaration"]["player_states"]["coins"] = {
        "type": "num", "example": 0, "description": "Purse."}
    doc["declaration"]["player_states_template"]["player_states"]["1"]["coins"] = 0
    doc["phases"][1]["mechanics"] = [{"income": {"coins": 2}}]
    outcome, issues = _run_contract(doc, "income-hinted")
    assert outcome == "ran", [str(i) for i in issues]

    mechs, _ = _phase_mechs(doc, "income-hinted", 1)
    inc = next(m for m in mechs if isinstance(m, M.ResourceIncome))
    assert inc.gains == (("coins", 2),)

    issues, spec = validate_doc(doc, name="income-hinted")
    lowered = lower(compile_game(spec))
    room = OracleRoom(lowered.game, n_players=4, seed=9)
    for t in range(60):
        room.step(oracle_policy(room, t, 9))
        if room.phase.dsl_id == 2:  # just left discussion at least once
            break
    assert any(row.get("coins", 0) >= 2 for row in room.players.values())


def test_hint_overrides_text_trigger():
    """A hinted phase whose text ALSO matches another family's regex gets
    exactly the declared mechanic (declaration outranks vocabulary)."""
    doc = _council_doc()
    # text says "eliminated ... at night" (night vocabulary) but the hint
    # pins vote_elimination
    doc["phases"][3]["description"] = (
        "When night falls the chosen member is eliminated; resolve night "
        "actions now.")
    doc["phases"][3]["mechanics"] = ["vote_elimination"]
    mechs, _ = _phase_mechs(doc, "override", 3)
    assert any(isinstance(m, M.VoteElim) for m in mechs)
    assert not any(isinstance(m, M.NightResolve) for m in mechs)


def test_hints_parse_and_normalize():
    doc = _council_doc()
    doc["phases"][3]["mechanics"] = [
        "Vote-Elimination", {"income": {"coins": 1}}, {"winner": "richest"}]
    spec = parse_game_spec(doc, name="norm")
    hints = spec.phases[3].mechanic_hints
    assert hints[0] == ("vote_elimination", None)
    assert hints[1] == ("income", (("coins", 1),))
    assert hints[2] == ("winner", "richest")


def test_income_hint_overrides_text_amount():
    """A parameterized income hint REPLACES text-mined gains (declaration
    outranks vocabulary) — merging would pay hint + prose amounts."""
    doc = _council_doc()
    doc["declaration"]["player_states"]["coins"] = {
        "type": "num", "example": 0, "description": "Purse."}
    doc["declaration"]["player_states_template"]["player_states"]["1"]["coins"] = 0
    doc["phases"][1]["description"] += " Each player collects 1 coin."
    doc["phases"][1]["mechanics"] = [{"income": {"coins": 2}}]
    mechs, _ = _phase_mechs(doc, "income-override", 1)
    inc = next(m for m in mechs if isinstance(m, M.ResourceIncome))
    assert inc.gains == (("coins", 2),)  # the declared amount, not 2+1


def test_reveal_hint_bad_field_is_error():
    """{reveal: bad_field} must not be masked by a same-class SetBoolAll
    attached from text — the declared field itself must be revealed."""
    doc = _council_doc()
    # no SetBoolAll at all on the phase: the generic attach error is loud
    doc["phases"][3]["mechanics"] = [{"reveal": "no_such_field"}]
    issues, _ = validate_doc(doc, name="reveal-bad-unanchored")
    assert errors(issues)

    # the masking case: a text-attached SetBoolAll('exposed') on the same
    # phase must NOT satisfy a hint naming a different (bad) field
    doc = _council_doc()
    doc["declaration"]["player_states"]["exposed"] = {
        "type": "boolean", "example": False, "description": "Publicly shown."}
    doc["declaration"]["player_states_template"]["player_states"]["1"]["exposed"] = False
    doc["phases"][3]["completion_criteria"]["description"] = (
        "Result shown (exposed set to true).")
    doc["phases"][3]["mechanics"] = [{"reveal": "no_such_field"}]
    issues, _ = validate_doc(doc, name="reveal-bad-masked")
    errs = [str(i) for i in errors(issues)]
    assert any("reveal hint names 'no_such_field'" in e for e in errs), errs


def test_winner_named_score_field_mismatch_is_error():
    doc = _council_doc()
    doc["declaration"]["player_states"]["points"] = {
        "type": "num", "example": 0, "description": "Total score points."}
    doc["declaration"]["player_states_template"]["player_states"]["1"]["points"] = 0
    doc["phases"][1]["mechanics"] = [{"income": {"points": 1}}]  # touch it
    doc["phases"][99]["mechanics"] = [{"winner": {"score": "no_such_field"}}]
    issues, _ = validate_doc(doc, name="winner-named-bad")
    errs = [str(i) for i in errors(issues)]
    assert any("winner hint named score field" in e for e in errs), errs


def test_option_hint_bad_arg_is_error():
    doc = _council_doc()
    doc["phases"][2]["mechanics"] = [{"option": "lots"}]
    issues, _ = validate_doc(doc, name="option-bad")
    errs = [str(i) for i in errors(issues)]
    assert any("not an integer choice maximum" in e for e in errs), errs


def test_malformed_hint_entry_is_loud():
    """mechanics: [3] (a YAML typo) must surface as an unknown-mechanic
    error, not vanish at parse time."""
    doc = _council_doc()
    doc["phases"][3]["mechanics"] = [3]
    issues, _ = validate_doc(doc, name="typo-hint")
    errs = [str(i) for i in errors(issues)]
    assert any("unknown mechanic '3'" in e for e in errs), errs


# ---------------------------------------------------------------------------
# games/midnight-circle.yaml — the hand-written catalog game whose every
# resolution phase is out-of-vocabulary and pinned by P18 hints
# ---------------------------------------------------------------------------

import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches


@pytest.fixture(scope="module")
def circle():
    import yaml

    import os

    from game_engine_tpu.dslgen.validate import validate_doc
    from game_engine_tpu.gamespec.parser import games_dir

    with open(os.path.join(games_dir(), "midnight-circle.yaml")) as f:
        doc = yaml.safe_load(f)
    issues, spec = validate_doc(doc, name="midnight-circle")
    assert not issues, [str(i) for i in issues]  # clean, not just error-free
    return lower(compile_game(spec))


@pytest.mark.parametrize("seed", range(4))
def test_circle_oracle_engine_parity(circle, seed):
    room = OracleRoom(circle.game, n_players=6, seed=seed)
    eng = BatchedEngine(circle)
    state = init_state(circle, 1, 6, np.uint32(seed))
    for t in range(400):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(circle, state))
        assert_state_matches(circle, room, state, 0, t)
        if room.done:
            break
    assert room.done and room.winner in (1, 2)


def test_circle_cpp_parity(circle):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 2):
        run_differential(circle, n_players=6, seed=seed, max_steps=400)


@pytest.mark.parametrize("archetype,desc,extras", [
    ("elimination", "hidden-role night elimination game", ()),
    ("rounds", "turn-based storytelling guessing game", ()),
    ("battle", "last one standing battle", ()),
    ("bluff", "coup-style bluffing", ()),
    ("market", "collect coins and raid", ()),
    ("minority", "odd one out", ()),
    ("auction", "sealed-bid auction", ()),
    ("elimination", "werewolves collect coins and raid purses", ("market",)),
])
def test_generator_output_is_hint_annotated(archetype, desc, extras):
    """generate() writes P18 hints mirroring the analyzer back into its
    output: every generated doc is self-documenting, every hint re-attaches
    (validator-enforced), and annotation is idempotent."""
    import copy

    from game_engine_tpu.dslgen.generate import (Blueprint,
                                                 WEREWOLF_LIKE_ROLES,
                                                 annotate_mechanics, generate)

    roles = WEREWOLF_LIKE_ROLES if archetype == "elimination" else ()
    doc = generate(Blueprint("g", desc, archetype, roles=roles, extras=extras))
    issues, spec = validate_doc(doc, name="annotated")
    assert not errors(issues), [str(i) for i in issues]
    hinted = [p for p in doc["phases"].values() if p.get("mechanics")]
    assert hinted, "no phase carries mechanics hints"
    assert annotate_mechanics(copy.deepcopy(doc)) == doc  # fixed point


def test_builtin_games_unaffected():
    """No builtin/catalog game uses hints; their programs are unchanged
    (guard against accidental default-on behavior)."""
    from game_engine_tpu.gamespec.parser import load_builtin

    for g in ("werewolf", "two-truths-and-a-lie"):
        spec = load_builtin(g)
        assert all(not ph.mechanic_hints for ph in spec.phases.values())


def test_circle_batch_split_invariance(circle):
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(circle, n_players=6, steps=48)
