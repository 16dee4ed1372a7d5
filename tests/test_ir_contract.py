"""Regression tests for the round-4 interpreter-contract review fixes:
oracle int32 parity on incoming(), reset canonicalization, loud let/field
shadowing, cross-field string compares, INT32_MIN literals, deal filler
vocabulary, and non-numeric num defaults. Each was a reviewer-found hole
in the loud-or-correct / four-way-parity contract (SEMANTICS.md P20)."""

import copy

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec import effects as FX
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_fuzz_ir import _fuzz_doc
from tests.test_parity import assert_state_matches


def _lockstep(doc, seeds=(0, 1), n=5, steps=300):
    issues, spec = validate_doc(doc, name="ir-contract")
    assert spec is not None and not errors(issues), \
        [str(i) for i in errors(issues)]
    lowered = lower(compile_game(spec))
    for seed in seeds:
        room = OracleRoom(lowered.game, n_players=n, seed=seed)
        eng = BatchedEngine(lowered)
        state = init_state(lowered, 1, n, np.uint32(seed))
        for t in range(steps):
            room.step(oracle_policy(room, t, seed))
            state = eng.step(state, scripted_actions(lowered, state))
            assert_state_matches(lowered, room, state, 0, t)
            if room.done:
                break
        assert room.done
        yield room


def test_incoming_overflow_wraps_identically():
    """5 seats each sending 2e9 to seat 1 overflows int32; the oracle must
    wrap exactly like the XLA/C++ executors (it used to return the
    unbounded Python sum)."""
    doc = _fuzz_doc([
        "score = 2000000000",
        "---",
        "aux = incoming(score, 1, 1)",
    ])
    for room in _lockstep(doc):
        v = room.players[1]["aux"]
        assert -(2**31) <= v <= 2**31 - 1
        # 5 * 2e9 mod 2^32, signed
        assert v == ((5 * 2000000000 + 2**31) % 2**32) - 2**31


def test_reset_restores_canonical_vocab_casing():
    """Template default 'ash' vs vocab-canonical 'Ash': reset must restore
    the canonical casing in the oracle exactly like the coded banks."""
    doc = copy.deepcopy(_fuzz_doc(["reset badge"]))
    decl = doc["declaration"]
    decl["player_states_template"]["player_states"]["1"]["badge"] = "ash"
    for room in _lockstep(doc, seeds=(0,)):
        for p in range(1, 6):
            assert room.players[p]["badge"] in ("Ash", ""), \
                room.players[p]["badge"]


def test_let_shadowing_declared_field_is_loud():
    with pytest.raises(FX.EffectError, match="shadows a declared state"):
        FX.parse_program(["let score = 5", "aux += score"],
                         reserved=frozenset({"score", "aux"}))
    # non-colliding lets still fine
    prog = FX.parse_program(["let tmp = 5", "aux += tmp"],
                            reserved=frozenset({"score", "aux"}))
    assert prog
    # the analyzer path enforces it end to end
    doc = _fuzz_doc(["let score = 1", "aux += score"])
    issues, spec = validate_doc(doc, name="shadow")
    assert spec is None or errors(issues), "validator accepted a shadowing let"


def test_cross_field_string_compare_rejected():
    doc = _fuzz_doc(["flag = (badge == name)"])
    issues, _spec = validate_doc(doc, name="xfield")
    assert errors(issues), "different-vocab string compare not rejected"
    # string field vs num field is loud too
    doc = _fuzz_doc(["flag = (badge == score)"])
    issues, _spec = validate_doc(doc, name="xbank")
    assert errors(issues), "string-vs-num field compare not rejected"
    # same field on both sides stays legal
    doc = _fuzz_doc(["flag = (badge == badge)"])
    issues, spec = validate_doc(doc, name="same")
    assert spec is not None and not errors(issues)


def test_int32_min_literal_parses():
    st = FX.parse_statement("score = -2147483648", {})
    assert isinstance(st.value, FX.EConst) and st.value.value == -(2**31)
    doc = _fuzz_doc(["score = -2147483648 where seat == 1"])
    issues, spec = validate_doc(doc, name="i32min")
    assert spec is not None and not errors(issues), \
        [str(i) for i in errors(issues)]
    # and it executes in lockstep (stored value is INT32_MIN everywhere)
    for room in _lockstep(doc, seeds=(0,)):
        assert room.players[1]["score"] == -(2**31)


def test_deal_filler_outside_vocab_rejected():
    from game_engine_tpu.gamespec.layout import build_layout
    from game_engine_tpu.gamespec.parser import parse_game_spec

    spec = parse_game_spec(_fuzz_doc(["score = 1"]), name="filler")
    layout = build_layout(spec.declaration)
    prog = ((FX.SDeal("badge", counts=(("Ash", 2),), filler="Ghost"),),)
    with pytest.raises(FX.EffectError, match="not in the vocabulary"):
        FX.check_program(prog, layout, frozenset(spec.phases), has_alive=True)


def test_non_numeric_num_default_resets_to_zero():
    """A num field whose template default is garbage must lower to a
    reset-to-0 (every executor reads the coded bank as 0), not crash."""
    doc = copy.deepcopy(_fuzz_doc(["aux = 7", "---", "reset aux"]))
    decl = doc["declaration"]
    decl["player_states_template"]["player_states"]["1"]["aux"] = "n/a"
    issues, spec = validate_doc(doc, name="badnum")
    assert spec is not None and not errors(issues), \
        [str(i) for i in errors(issues)]
    for room in _lockstep(doc, seeds=(0,)):
        for p in range(1, 6):
            assert room.players[p]["aux"] == 0


def test_instant_end_rooms_count_episodes_identically():
    """A start phase whose on-enter program ends the game instantly makes
    every room 'born done'. The engine counts episodes as done
    transitioning false->true, so such rooms count ZERO episodes, not the
    carried done flag once per iteration."""
    from game_engine_tpu.core.engine import compiled_rollout

    doc = copy.deepcopy(_fuzz_doc(["score += 1"]))
    doc["phases"][0]["mechanics"] = [{"effects": ["over 1"]}]
    issues, spec = validate_doc(doc, name="instant-end")
    assert spec is not None and not errors(issues), \
        [str(i) for i in errors(issues)]
    lowered = lower(compile_game(spec))
    B, steps = 8, 12
    state = init_state(lowered, B, 5, np.arange(B, dtype=np.uint32))
    assert bool(state.done.all()), "start-phase over should make rooms born done"
    ref_state, ref_eps = compiled_rollout(lowered, steps)(state)
    assert int(ref_eps) == 0, int(ref_eps)
    assert bool(np.asarray(ref_state.done).all())


def test_gated_deal_four_way():
    """`deal ... where ...` through the oracle, the jitted engine and the
    C++ sim (the gating semantics were previously pinned only at the
    oracle level): rank over ALL present seats, writes gated."""

    doc = _fuzz_doc([
        "deal badge salt rounds where seat != 2",
        "---",
        "score += 1 where badge == 'Ash'",
    ])
    issues, spec = validate_doc(doc, name="gated-deal")
    assert spec is not None and not errors(issues), \
        [str(i) for i in errors(issues)]
    lowered = lower(compile_game(spec))

    # oracle vs engine lockstep; seat 2's badge must keep its default
    for seed in (0, 2):
        room = OracleRoom(lowered.game, n_players=5, seed=seed)
        eng = BatchedEngine(lowered)
        state = init_state(lowered, 1, 5, np.uint32(seed))
        for t in range(300):
            room.step(oracle_policy(room, t, seed))
            state = eng.step(state, scripted_actions(lowered, state))
            assert_state_matches(lowered, room, state, 0, t)
            if room.done:
                break
        assert room.done
        assert room.players[2]["badge"] == "", "gated seat was dealt"
        assert any(room.players[p]["badge"] for p in (1, 3, 4, 5)), \
            "no ungated seat was ever dealt"

    # C++ full-episode differential
    from game_engine_tpu.native import available
    if available():
        from tests.test_native import run_differential
        for seed in (0, 4):
            run_differential(lowered, n_players=5, seed=seed, max_steps=300)


def test_native_rejects_retired_mech_blob():
    """A blob carrying a retired mech id (pre-round-4 MECH_ROLES) must be
    rejected loudly by gs_create, not simulated with roles never dealt."""
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    import ctypes

    from game_engine_tpu.gamespec.parser import load_builtin
    from game_engine_tpu.native import lib as NL
    from game_engine_tpu.native.pack import MECH_ROLES, SEC_MECHS, pack

    lowered = lower(compile_game(load_builtin("werewolf")))
    blob = np.ascontiguousarray(pack(lowered)).copy()
    # rewrite the first mech row's id to the retired MECH_ROLES
    i = 1
    while i + 2 <= len(blob):
        sid, n = int(blob[i]), int(blob[i + 1])
        if sid == SEC_MECHS:
            blob[i + 2] = MECH_ROLES
            break
        i += 2 + n
    else:
        raise AssertionError("no SEC_MECHS section found")
    h = NL._lib.gs_create(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(blob))
    assert not h, "gs_create accepted a blob with a retired mech id"
    # the unmodified blob still loads (CppGame raises on rejection)
    NL.CppGame(lowered)
