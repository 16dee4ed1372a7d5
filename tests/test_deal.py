"""The `deal` statement (P10 as IR, round 4): RNG-permuted multiset
assignment of a string field is an effect-IR statement, and the bespoke
role-assignment kernels are deleted from all four executors.

Pinned semantics (SEMANTICS.md P10): seat q (0-based) draws the u32 key
splitmix32(seed*256 + q + u32(salt_q)*0x9E3779B9); absent seats key
0xFFFFFFFF; rank = stable ascending order (ties to the lower seat); the
written value is deal_multiset(counts, filler, n)[rank]. Salt 0
reproduces the retired LRoleAssign kernel bit-for-bit (the golden
fixture pins this across the whole catalog); a nonzero per-seat salt
expression re-deals mid-game — the capability the bespoke kernel could
never express (reference: role assignment fires once from
agent/prompt/referee_system_prompt_1.txt's Role Assignment phase; the
reference referee has no re-deal, this is a superset).

masquerade-gala is the catalog game that exercises mid-game re-deals
(`deal mask salt rounds`) end to end with four-executor parity.
"""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.gamespec import effects as FX
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.layout import build_layout
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches


# ---------------------------------------------------------------------------
# parser / checker / resolver units
# ---------------------------------------------------------------------------


def test_parse_deal_forms():
    env: dict = {}
    st = FX.parse_statement("deal role", env)
    assert isinstance(st, FX.SDeal)
    assert st.field == "role" and st.salt == FX.ZERO and st.where == FX.ONE
    assert st.counts is None  # unresolved until resolve_deals

    st = FX.parse_statement("deal mask salt rounds where is_alive", env)
    assert isinstance(st, FX.SDeal)
    assert st.field == "mask"
    assert isinstance(st.salt, FX.EField) and st.salt.name == "rounds"
    assert isinstance(st.where, FX.EField) and st.where.name == "is_alive"


def test_parse_deal_named_field_still_assignable():
    # a game may declare a num field literally named `deal`
    st = FX.parse_statement("deal = 5", {})
    assert isinstance(st, FX.SSet) and st.field == "deal"
    st = FX.parse_statement("deal += 1", {})
    assert isinstance(st, FX.SAdd) and st.field == "deal"


def test_deal_multiset_replicate_extend_trim():
    counts = (("Werewolf", 2), ("Seer", 1), ("Villager", 3))
    # exact
    assert FX.deal_multiset(counts, "Villager", 6) == [
        "Werewolf", "Werewolf", "Seer", "Villager", "Villager", "Villager"]
    # extend with filler
    assert FX.deal_multiset(counts, "Villager", 8) == [
        "Werewolf", "Werewolf", "Seer"] + ["Villager"] * 5
    # trim filler copies first (keep at least one), then from the end
    assert FX.deal_multiset(counts, "Villager", 4) == [
        "Werewolf", "Werewolf", "Seer", "Villager"]
    assert FX.deal_multiset(counts, "Villager", 3) == [
        "Werewolf", "Werewolf", "Seer"]
    assert FX.deal_multiset(counts, "Villager", 2) == [
        "Werewolf", "Werewolf"]


def _gala_layout():
    spec = load_builtin("masquerade-gala")
    return spec, build_layout(spec.declaration)


def test_check_rejects_deal_on_num_field():
    spec, layout = _gala_layout()
    prog = ((FX.SDeal("coins", counts=(("Fox", 1),), filler="Fox"),),)
    with pytest.raises(FX.EffectError, match="must be a string field"):
        FX.check_program(prog, layout, frozenset(spec.phases), has_alive=False)


def test_check_rejects_unresolved_deal():
    spec, layout = _gala_layout()
    prog = ((FX.SDeal("mask"),),)
    with pytest.raises(FX.EffectError, match="players_example"):
        FX.check_program(prog, layout, frozenset(spec.phases), has_alive=False)


def test_check_rejects_out_of_vocab_multiset():
    spec, layout = _gala_layout()
    prog = ((FX.SDeal("mask", counts=(("Dragon", 2),), filler="Dragon"),),)
    with pytest.raises(FX.EffectError, match="not in the vocabulary"):
        FX.check_program(prog, layout, frozenset(spec.phases), has_alive=False)


def test_resolve_deals_from_example_counts():
    spec, layout = _gala_layout()
    prog = ((FX.SDeal("mask"),),)
    resolved = M.resolve_deals(prog, spec, layout)
    (st,) = resolved[0]
    # first-appearance order, counts from the 4 example rows
    assert st.counts == (("Fox", 1), ("Owl", 2), ("Crane", 1))
    assert st.filler == "Owl"  # most-common example value takes surplus


def test_resolve_deals_role_uses_declared_roles():
    spec = load_builtin("werewolf-(mafia)")
    layout = build_layout(spec.declaration)
    prog = ((FX.SDeal("role"),),)
    resolved = M.resolve_deals(prog, spec, layout)
    (st,) = resolved[0]
    names = [n for n, _ in st.counts]
    assert "Werewolf" in names and "Villager" in names
    ra = M._build_role_assign(spec, layout)
    assert st.counts == ra.role_counts and st.filler == ra.filler_role


# ---------------------------------------------------------------------------
# salt-0 bit-identity with the retired kernel's formula
# ---------------------------------------------------------------------------


def test_salt0_matches_retired_role_permutation():
    """role_assign_program (deal + guarded settings) must reproduce the
    retired kernel's multiset[perm[p]] assignment exactly."""
    spec = load_builtin("werewolf-(mafia)")
    lw = lower(compile_game(spec))
    layout = lw.game.layout
    ra = M._build_role_assign(spec, layout)
    for seed in range(12):
        for n in (5, 6, 8):
            room = OracleRoom(lw.game, n_players=n, seed=seed)
            room.apply_mechanic(ra)
            multiset = M.role_multiset(ra, n)
            perm = M.role_permutation(seed, n)
            for p in range(n):
                assert room.players[p + 1]["role"] == multiset[perm[p]], (
                    seed, n, p)


# ---------------------------------------------------------------------------
# masquerade-gala: mid-game re-deals, four-executor parity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gala():
    return lower(compile_game(load_builtin("masquerade-gala")))


@pytest.mark.parametrize("seed", range(4))
def test_oracle_engine_parity_with_redeal(gala, seed):
    lowered = gala
    room = OracleRoom(lowered.game, n_players=5, seed=seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, 5, np.uint32(seed))
    for t in range(500):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done


def test_redeal_changes_permutation(gala):
    """The salt makes rounds distinct: across a full game the mask
    permutation must change between rounds (a salt-free deal would pin
    one permutation per seed for the whole game)."""
    lowered = gala
    for seed in range(4):
        room = OracleRoom(lowered.game, n_players=5, seed=seed)
        perms, prev = [], 0
        for t in range(900):
            room.step(oracle_policy(room, t, seed))
            r0 = room.players[1].get("rounds")
            if r0 != prev:
                perms.append(tuple(room.players[p]["mask"]
                                   for p in range(1, 6)))
                prev = r0
            if room.done:
                break
        assert room.done
        assert len(set(perms)) > 1, f"seed {seed}: deal never re-dealt"
        # every deal is the n=5 multiset: 1 Fox, 1 Crane, 3 Owl
        for pm in perms:
            assert sorted(pm) == ["Crane", "Fox", "Owl", "Owl", "Owl"]


def test_cpp_parity(gala):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    for seed in (0, 2, 7):
        run_differential(gala, n_players=5, seed=seed, max_steps=500)


def test_deal_where_gates_writes_not_rank(gala):
    """Pinned: rank is computed over ALL present seats; `where` only gates
    which writes land — a guarded seat keeps its old value but still
    occupies its rank in the permutation (so the ungated seats see exactly
    the same masks they would with no guard)."""
    lowered = gala
    layout = lowered.game.layout
    spec_counts = (("Fox", 1), ("Owl", 2), ("Crane", 1))
    ungated = ((FX.SDeal("mask", counts=spec_counts, filler="Owl"),),)
    gated = ((FX.SDeal("mask", counts=spec_counts, filler="Owl",
                       where=FX.ECmp("ne", FX.ESeat(), FX.EConst(2))),),)
    for seed in range(6):
        a = OracleRoom(lowered.game, n_players=5, seed=seed)
        b = OracleRoom(lowered.game, n_players=5, seed=seed)
        a._apply_effects(ungated, ())
        b._apply_effects(gated, ())
        for p in range(1, 6):
            if p == 2:
                assert b.players[p]["mask"] == "", "guarded seat was written"
            else:
                assert b.players[p]["mask"] == a.players[p]["mask"], (
                    "guard changed another seat's deal")


def test_deal_salt_changes_permutation_deterministically(gala):
    """Same salt -> same permutation; different salts -> (eventually)
    different permutations; salt 0 equals the retired-kernel formula."""
    lowered = gala
    counts = (("Fox", 1), ("Owl", 2), ("Crane", 1))
    def masks_with_salt(seed, salt):
        room = OracleRoom(lowered.game, n_players=5, seed=seed)
        prog = ((FX.SDeal("mask", counts=counts, filler="Owl",
                          salt=FX.EConst(salt)),),)
        room._apply_effects(prog, ())
        return tuple(room.players[p]["mask"] for p in range(1, 6))
    for seed in range(4):
        assert masks_with_salt(seed, 3) == masks_with_salt(seed, 3)
        distinct = {masks_with_salt(seed, s) for s in range(8)}
        assert len(distinct) > 1, f"seed {seed}: salts never changed the deal"
        # salt 0 == retired formula: multiset[perm[p]]
        ms = FX.deal_multiset(counts, "Owl", 5)
        perm = M.role_permutation(seed, 5)
        assert masks_with_salt(seed, 0) == tuple(ms[perm[p]] for p in range(5))


def test_gala_batch_split_invariance(gala):
    from tests.rollout_helpers import assert_batch_split_invariant

    assert_batch_split_invariant(gala, n_players=5, steps=80)
