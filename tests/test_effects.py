"""P20 effect IR: the declarative language, its loud-or-correct validation,
and four-executor bit-parity on the catalog games that only the IR can
express — gift-circle (player-to-player transfers), handshake-pact
(choice-of-choice reciprocity), speed-track (eqcount collision racing),
relic-draft (shrinking-pool draft), tide-pool (`reset`-statement busts).

The reference's referee applies arbitrary describable rules via LLM state
writes (reference: agent/tools/backend_tools.py:204-225,
agent/prompt/referee_system_prompt_1.txt:6-88); these tests pin the
determinized equivalent."""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec import effects as FX
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches

EFFECT_GAMES = ["gift-circle", "handshake-pact", "speed-track",
                "relic-draft", "tide-pool", "storm-forge"]


@pytest.fixture(scope="module", params=EFFECT_GAMES)
def effect_game(request):
    lowered = lower(compile_game(load_builtin(request.param)))
    return request.param, lowered


# ---------------------------------------------------------------------------
# The language: parser + static checking
# ---------------------------------------------------------------------------


def test_parser_precedence_and_shapes():
    env = {}
    st = FX.parse_statement("coins += 1 + 2 * 3 where coins > 0 and seat != 2", env)
    assert isinstance(st, FX.SAdd) and st.field == "coins"
    # 1 + (2*3), not (1+2)*3
    assert st.value == FX.EBin("add", FX.EConst(1),
                               FX.EBin("mul", FX.EConst(2), FX.EConst(3)))
    assert isinstance(st.where, FX.EAnd)

    assert FX.parse_statement("let g = chose(4, 7) and alive", env) is None
    st2 = FX.parse_statement("coins -= if(g, 1, 0)", env)
    # let-substitution inlines the binding; -= negates
    assert isinstance(st2, FX.SAdd)
    inner = st2.value
    assert isinstance(inner, FX.EBin) and inner.op == "sub"
    assert isinstance(inner.b, FX.EWhere)
    assert inner.b.c == FX.EAnd(FX.EChoseIn(frozenset({4, 7})), FX.EAlive())

    st3 = FX.parse_statement("kill where trust < 0", env)
    assert isinstance(st3, FX.SKill)


def test_parser_blocks_split_on_dashes():
    prog = FX.parse_program(["coins += 1", "---", "coins += 2"])
    assert len(prog) == 2 and len(prog[0]) == 1 and len(prog[1]) == 1


@pytest.mark.parametrize("bad", [
    "coins +=",                      # missing expression
    "coins ** 2",                    # unknown operator
    "frobnicate(coins)",             # unknown function
    "let seat = 1",                  # shadows a builtin
    "kill coins",                    # malformed kill
    "chose(coins) and coins > 0",    # statement must be an assignment
])
def test_parser_rejects_malformed(bad):
    with pytest.raises(FX.EffectError):
        FX.parse_program([bad])


def test_checker_is_loud():
    """check_program rejects every reference the engine cannot execute."""
    spec = load_builtin("gold-rush")
    game = compile_game(spec)
    layout, phases = game.layout, frozenset(spec.phases)

    def check(lines, has_alive=True):
        FX.check_program(FX.parse_program(lines), layout, phases,
                         has_alive=has_alive)

    check(["coins += 1 where is_alive"])  # sane program passes
    with pytest.raises(FX.EffectError, match="unknown field"):
        check(["mana += 1"])
    with pytest.raises(FX.EffectError, match="num field"):
        check(["is_alive += 1"])  # += targets must be numeric
    with pytest.raises(FX.EffectError, match="quoted literal"):
        check(["name = 1"])  # string fields take vocab literals only
    with pytest.raises(FX.EffectError, match="vocabulary"):
        check(["team = 'wizards'"])  # write literal must round-trip
    check(["team = 'bandits' where coins > 3"])  # in-vocab write passes
    with pytest.raises(FX.EffectError, match="player-keyed dict"):
        check(["coins[choice] = 'bandits'"])  # keyed write needs a pdict
    with pytest.raises(FX.EffectError, match="quoted literal"):
        check(["investigated_alignments[choice] = 7"])
    check(["investigated_alignments[choice] = 'bandits' where is_alive"])
    with pytest.raises(FX.EffectError, match="no phase with id"):
        check(["coins += 1 where chose(55)"])
    with pytest.raises(FX.EffectError, match="is_alive"):
        check(["kill where coins > 99"], has_alive=False)
    with pytest.raises(FX.EffectError, match="vocabulary"):
        # 'wizard' is not in the team vocab -> could never be true
        check(["coins += 1 where team == 'wizard'"])
    check(["coins += 1 where team == 'bandits'"])  # in-vocab passes


def test_reset_statement_surface():
    """`reset FIELD` restores the declared template default — the only IR
    write permitted on string and dict banks (P9 round-scoped resets ride
    on it; two-truths' speaker rotation exercises the dict-bank path in
    the four-way parity suites)."""
    env = {}
    st = FX.parse_statement("reset coins", env)
    assert st == FX.SReset("coins")
    st2 = FX.parse_statement("reset coins where seat == 1", env)
    assert isinstance(st2, FX.SReset) and isinstance(st2.where, FX.ECmp)

    spec = load_builtin("gold-rush")
    game = compile_game(spec)
    layout, phases = game.layout, frozenset(spec.phases)
    FX.check_program(FX.parse_program(["reset coins"]), layout, phases,
                     has_alive=True)
    # string fields: = rejected, reset allowed
    FX.check_program(FX.parse_program(["reset team"]), layout, phases,
                     has_alive=True)
    with pytest.raises(FX.EffectError, match="unknown field"):
        FX.check_program(FX.parse_program(["reset mana"]), layout, phases,
                         has_alive=True)

    # oracle semantics: value returns to the declared default, others keep
    prog = FX.parse_program(["reset coins where seat == 1"])
    room = OracleRoom(game, n_players=3, seed=0)
    default = room.players[2]["coins"]
    room.players[1]["coins"] = 7
    room.players[2]["coins"] = 9
    room.apply_mechanic(M.Effects(program=prog))
    assert room.players[1]["coins"] == default
    assert room.players[2]["coins"] == 9


def test_reset_statement_engine_parity():
    """reset lowers to the jitted engine identically to the oracle: run
    two-truths (speaker rotation = argmin + `reset` statements incl. the
    pdict/odict banks) to completion with per-step parity, asserting the
    rotation actually fired — the speaker changed AND a populated
    dict-bank field was observed cleared by a reset."""
    from game_engine_tpu.gamespec.compile import GameConfig

    lowered = lower(compile_game(load_builtin("two-truths-and-a-lie"),
                                 GameConfig(rounds_per_player=1)))
    rot = next(m for cp in lowered.game.phases
               for m in cp.program.on_enter
               if isinstance(m, M.SpeakerRotate))
    assert rot.reset_pdicts or rot.reset_odicts  # the dict-bank path
    dict_fields = (*rot.reset_pdicts, *rot.reset_odicts)
    eng = BatchedEngine(lowered)
    room = OracleRoom(lowered.game, n_players=3, seed=5)
    state = init_state(lowered, 1, 3, np.uint32(5))
    speakers = set()
    saw_dict_cleared = False
    had_dict_value = {f: False for f in dict_fields}
    for t in range(200):
        room.step(oracle_policy(room, t, 5))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        for p, row in room.players.items():
            if row.get(rot.speaker_field):
                speakers.add(p)
            for f in dict_fields:
                if row.get(f):
                    had_dict_value[f] = True
                elif had_dict_value[f]:
                    saw_dict_cleared = True
        if room.done:
            break
    assert room.done
    assert len(speakers) >= 2, "rotation never changed the speaker"
    assert saw_dict_cleared, "no populated dict field was ever reset"


def test_validator_surfaces_effect_errors():
    """A malformed effects hint becomes an ERROR Issue with the parse
    detail, never a silently dropped mechanic (P18 loud-or-correct)."""
    import yaml

    from game_engine_tpu.gamespec.parser import games_dir
    import os

    doc = yaml.safe_load(open(os.path.join(games_dir(), "gift-circle.yaml")))
    doc["phases"][2]["mechanics"] = [
        {"effects": ["coins += bogus_field"]}]
    issues, spec = validate_doc(doc, name="broken")
    errs = [str(e) for e in errors(issues)]
    assert any("effects program rejected" in e and "bogus_field" in e
               for e in errs), errs


def test_effects_hint_attaches_mechanic(effect_game):
    name, lowered = effect_game
    from game_engine_tpu.gamespec.tables import LEffect

    fx = [m for m in lowered.mechanics if isinstance(m, LEffect)]
    assert fx, f"{name} lowered no LEffect"
    mechs = [m for cp in lowered.game.phases for m in cp.program.on_enter]
    assert any(isinstance(m, M.Effects) for m in mechs)


# ---------------------------------------------------------------------------
# Pinned semantics (oracle hand-checks on crafted states)
# ---------------------------------------------------------------------------


def _craft(name, n=4, seed=0):
    game = compile_game(load_builtin(name))
    room = OracleRoom(game, n_players=n, seed=seed)
    fx = None
    for cp in game.phases:
        for m in cp.program.on_enter:
            if isinstance(m, M.Effects):
                fx = m
    assert fx is not None
    return room, fx


def test_gift_transfer_semantics():
    """Givers with a coin pay 1 to their target; the most-gifted player
    collects +2 from the bank; broke givers give nothing."""
    room, fx = _craft("gift-circle")
    for p, (coins, tgt) in {1: (3, 2), 2: (0, 1), 3: (3, 2), 4: (3, 2)}.items():
        room.players[p]["coins"] = coins
        room.choice[p] = tgt
        room.choice_phase[p] = 1
    room.apply_mechanic(fx)
    # p2 got 3 gifts (+3) and the popularity bonus (+2); broke, gave nothing
    assert room.players[2]["coins"] == 0 + 3 + 2
    assert room.players[1]["coins"] == 3 - 1  # gave 1, received 0 (p2 broke)
    assert room.players[3]["coins"] == 2 and room.players[4]["coins"] == 2
    assert room.players[2]["gifts_received"] == 3
    # total conserved + bank bonus of 2
    assert sum(room.players[p]["coins"] for p in range(1, 5)) == 9 + 2


def test_handshake_mutual_and_lonely():
    room, fx = _craft("handshake-pact")
    # 1<->2 mutual; 3 picks 1; 4 picks 3. Nobody picks 4 -> lonely.
    for p, tgt in {1: 2, 2: 1, 3: 1, 4: 3}.items():
        room.choice[p] = tgt
        room.choice_phase[p] = 1
        room.players[p]["trust"] = 5
    room.apply_mechanic(fx)
    assert room.players[1]["trust"] == 7 and room.players[2]["trust"] == 7
    assert room.players[3]["trust"] == 5  # picked, not mutual
    assert room.players[4]["trust"] == 4  # lonely
    # lonely floor: trust never goes below zero
    room2, fx2 = _craft("handshake-pact")
    for p, tgt in {1: 2, 2: 1, 3: 1, 4: 3}.items():
        room2.choice[p] = tgt
        room2.choice_phase[p] = 1
        room2.players[p]["trust"] = 0
    room2.apply_mechanic(fx2)
    assert room2.players[4]["trust"] == 0


def test_speed_track_collision():
    room, fx = _craft("speed-track")
    # p1 and p2 both pick 3 (collision); p3 picks 2 (unique); p4 picks 1.
    for p, pick in {1: 3, 2: 3, 3: 2, 4: 1}.items():
        room.players[p]["speed_pick"] = pick
        room.choice[p] = pick
        room.choice_phase[p] = 1
    room.apply_mechanic(fx)
    assert room.players[1]["position"] == 0 and room.players[2]["position"] == 0
    assert room.players[3]["position"] == 2 and room.players[4]["position"] == 1
    assert all(room.players[p]["speed_pick"] == 0 for p in range(1, 5))


def test_relic_draft_claims():
    """Exclusive claims from a shared pool: the lowest-seated collector wins
    a contested relic, an already-claimed relic goes to nobody, and the
    collection value / pool count derive from the claim flags."""
    room, fx = _craft("relic-draft")
    room.players[4]["has5"] = True  # relic 5 claimed in an earlier round
    for p, pick in {1: 3, 2: 3, 3: 5, 4: 6}.items():
        room.choice[p] = pick
        room.choice_phase[p] = 1
    room.apply_mechanic(fx)
    assert room.players[1]["has3"] and not room.players[2]["has3"]  # seat order
    assert not room.players[3]["has5"]  # already claimed -> nothing
    assert room.players[4]["has6"]
    assert room.players[1]["gold"] == 3 and room.players[2]["gold"] == 0
    assert room.players[4]["gold"] == 5 + 6
    assert all(room.players[p]["pool_left"] == 3 for p in range(1, 5))


def test_block_snapshot_semantics():
    """Within a block all reads see the block-entry snapshot; across a
    '---' separator the second block reads the first block's writes."""
    spec = load_builtin("gift-circle")
    game = compile_game(spec)
    layout, phases = game.layout, frozenset(spec.phases)
    # one block: both statements read coins=3 -> 3+1=4 then doubled FROM
    # SNAPSHOT would be 6; sequential-with-snapshot-reads means the second
    # write overrides computed from snapshot: coins = 3*2 = 6
    prog = FX.parse_program(["coins += 1", "coins = coins * 2"])
    FX.check_program(prog, layout, phases, has_alive=False)
    room = OracleRoom(game, n_players=2, seed=0)
    room.players[1]["coins"] = 3
    room.apply_mechanic(M.Effects(program=prog))
    assert room.players[1]["coins"] == 6  # snapshot read: 3*2, overriding +1
    # two blocks: second block sees 4
    prog2 = FX.parse_program(["coins += 1", "---", "coins = coins * 2"])
    room2 = OracleRoom(game, n_players=2, seed=0)
    room2.players[1]["coins"] = 3
    room2.apply_mechanic(M.Effects(program=prog2))
    assert room2.players[1]["coins"] == 8


def test_tide_pool_bust_and_bank():
    """tide-pool: the bust rule is a conditional `reset` overriding the
    same block's `+=` from snapshot reads — banking (pick 3) converts the
    stash to pearls; a dive that would push the stash past 5 sweeps it to
    the template default instead of adding."""
    game = compile_game(load_builtin("tide-pool"))
    room = OracleRoom(game, n_players=4, seed=0)
    fx = next(m for cp in game.phases if cp.dsl_id == 2
              for m in cp.program.on_enter if isinstance(m, M.Effects))

    def round_with(picks):
        for p, c in picks.items():
            room.players[p]["dive_pick"] = c
            room.choice[p] = c
            room.choice_phase[p] = 1
        room.apply_mechanic(fx)

    room.players[1]["stash"] = 4
    room.players[2]["stash"] = 4
    room.players[3]["stash"] = 3
    round_with({1: 2, 2: 3, 3: 2, 4: 1})
    assert room.players[1]["stash"] == 0          # 4+2 > 5: swept
    assert room.players[1]["pearls"] == 0
    assert room.players[2]["stash"] == 0          # banked
    assert room.players[2]["pearls"] == 4
    assert room.players[3]["stash"] == 5          # 3+2 = 5: exactly safe
    assert room.players[4]["stash"] == 1
    assert all(room.players[p]["dive_pick"] == 0 for p in room.players)


# ---------------------------------------------------------------------------
# Four-executor bit-parity on the effect-only games
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_oracle_engine_parity(effect_game, seed):
    name, lowered = effect_game
    n = min(4 + seed, lowered.P)
    room = OracleRoom(lowered.game, n_players=n, seed=seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, n, np.uint32(seed))
    for t in range(400):
        room.step(oracle_policy(room, t, seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done, f"{name} did not terminate"
    assert 1 <= room.winner <= n


def test_cpp_parity(effect_game):
    from game_engine_tpu.native import available

    if not available():
        pytest.skip("native backend unavailable")
    from tests.test_native import run_differential

    name, lowered = effect_game
    for seed in (0, 3):
        run_differential(lowered, n_players=min(5, lowered.P), seed=seed,
                         max_steps=400)


def test_batch_split_invariance(effect_game):
    from tests.rollout_helpers import assert_batch_split_invariant

    _name, lowered = effect_game
    assert_batch_split_invariant(lowered, min(5, lowered.P), steps=60)


# ---------------------------------------------------------------------------
# Generator integration: the gifting archetype is the first generator family
# resolved entirely through the P20 effect IR
# ---------------------------------------------------------------------------


def test_gifting_archetype_generates_and_plays():
    from game_engine_tpu.dslgen.generate import generate_from_description
    from game_engine_tpu.dslgen.validate import errors, validate_doc

    report = []
    doc = generate_from_description(
        "gift-party",
        "players secretly gift coins to each other each round; the most "
        "popular player earns a bonus and the richest wins",
        report=report,
    )
    issues, spec = validate_doc(doc, name="gift-party")
    assert spec is not None and not errors(issues), [str(i) for i in issues]
    assert not report, report  # transfer vocabulary is fully covered now
    assert any("Gift Exchange" == p["name"] for p in doc["phases"].values())
    # the annotator preserved the effects program verbatim
    fx = [h for h in doc["phases"][2]["mechanics"]
          if isinstance(h, dict) and "effects" in h]
    assert fx, doc["phases"][2]["mechanics"]

    lowered = lower(compile_game(spec))
    for seed in (0, 2):
        n = 4 + seed
        room = OracleRoom(lowered.game, n_players=n, seed=seed)
        eng = BatchedEngine(lowered)
        state = init_state(lowered, 1, n, np.uint32(seed))
        for t in range(400):
            room.step(oracle_policy(room, t, seed))
            state = eng.step(state, scripted_actions(lowered, state))
            assert_state_matches(lowered, room, state, 0, t)
            if room.done:
                break
        assert room.done and 1 <= room.winner <= n


def test_gifting_generated_over_http(tmp_path):
    """POST /api/generate-dsl with transfer vocabulary produces a playable
    effect-IR game, warning-free, playable to completion."""
    import shutil
    import threading

    from game_engine_tpu.gamespec.parser import games_dir
    from game_engine_tpu.server.api import make_server
    from tests.test_server import req

    gdir = tmp_path / "games"
    shutil.copytree(games_dir(), gdir)
    srv = make_server(port=0, games_path=str(gdir), backend="native")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, data = req(srv, "POST", "/api/generate-dsl",
                         {"gameName": "Gift Party",
                          "gameDescription": "players gift coins to each "
                          "other, most popular earns a bonus, richest wins"})
        assert code == 200, data
        assert not any("description coverage" in w for w in data["warnings"])
        code, d = req(srv, "POST", "/api/rooms/create",
                      {"gameName": "gift-party", "playerName": "G"})
        rid = d["room"]["roomId"]
        req(srv, "POST", "/api/rooms/add-bot", {"roomId": rid})
        code, snap = req(srv, "POST", f"/api/rooms/{rid}/start", {"seed": 6})
        assert code == 200, snap
        for _ in range(120):
            code, snap = req(srv, "POST", f"/api/rooms/{rid}/continue")
            if snap["done"]:
                break
            for pid in snap.get("waiting_on", []):
                req(srv, "POST", f"/api/rooms/{rid}/vote",
                    {"playerId": pid, "option": 1})
        assert snap["done"] and snap["winner"] >= 1
    finally:
        srv.shutdown()
