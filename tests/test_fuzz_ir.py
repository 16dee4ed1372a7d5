"""Differential fuzzing of the effect-IR interpreter itself.

Round 4 made the P20 interpreter the ONLY execution path for every
mechanic family (the bespoke kernels are all deleted), so this harness
generates random typed programs over a game declaring every bank type
(bool / num / string-vocab / player-keyed dict) and checks all three
executors stay in lockstep: oracle vs jitted engine step-for-step and
the C++ simulator over full episodes; one program also checks that the
XLA rollout is invariant to how rooms are batched. It covers the statement surface the archetype fuzzer
(test_fuzz.py) only reaches through fixed blueprints: deal-with-salt,
vocab string writes, dict entry writes, kill/reset interleavings, `over`
mid-game, multi-block snapshot chains, and int32 wraparound arithmetic.

The reference has no equivalent of this (its referee is an LLM); the
contract being protected is SEMANTICS.md P20's bit-identical four-way
execution.
"""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine, compiled_rollout, scripted_actions
from game_engine_tpu.core.state import init_state
from game_engine_tpu.dslgen.validate import errors, validate_doc
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from tests.test_parity import assert_state_matches

MAX_ROUNDS = 6


def _fuzz_doc(program_lines):
    """A game declaring every bank type whose resolution phase runs the
    fuzzed program; rounds-capped so every episode terminates."""
    tmpl = {"name": "", "is_alive": True, "flag": False, "score": 0,
            "aux": 0, "badge": "", "pick": 0, "rounds": 0, "marks": {}}
    def row(name, badge):
        return {**tmpl, "name": name, "badge": badge}
    return {
        "declaration": {
            "description": "IR fuzz arena: random declared resolution rules.",
            "is_multiplayer": True,
            "min_players": 4,
            "roles": [],
            "player_states": {
                "name": {"type": "string", "example": "Player A",
                         "description": "Public display name."},
                "is_alive": {"type": "boolean", "example": True,
                             "description": "Alive flag (kill target)."},
                "flag": {"type": "boolean", "example": False,
                         "description": "Scratch boolean."},
                "score": {"type": "num", "example": 0,
                          "description": "Scratch counter A."},
                "aux": {"type": "num", "example": 0,
                        "description": "Scratch counter B."},
                "badge": {"type": "string", "example": "Ash",
                          "description": "Vocab string (Ash/Birch/Cedar)."},
                "pick": {"type": "num", "example": 0,
                         "description": "This round's target pick."},
                "rounds": {"type": "num", "example": 0,
                           "description": "Completed rounds (cap 6)."},
                "marks": {"type": "dict", "example": {"2": "seen"},
                          "description": "Player-keyed scratch memory."},
            },
            "player_states_template": {"player_states": {"1": dict(tmpl)}},
            "players_example": {
                "tools": ["clearCanvas", "createPhaseIndicator",
                          "createVotingPanel", "createResultDisplay"],
                "player_states": {
                    "1": row("Alpha", "Ash"),
                    "2": {**row("Beta", "Birch"),
                          "marks": {"3": "seen"}},
                    "3": row("Gamma", "Cedar"),
                    "4": row("Delta", "Birch"),
                },
            },
            "audience_groups": {},
        },
        "phases": {
            0: {
                "name": "Game Introduction",
                "description": "Introduce the arena.",
                "actions": [
                    {"description": "Clear all previous UI elements",
                     "tools": ["clearCanvas"]},
                    {"description": "Create phase indicator",
                     "tools": ["createPhaseIndicator"]},
                ],
                "completion_criteria": {
                    "type": "UI_displayed",
                    "description": "Game Introduction has been displayed "
                                   "to all players."},
                "next_phase": {"id": 1, "name": "Target Pick"},
            },
            1: {
                "name": "Target Pick",
                "description": "Every living player targets another player.",
                "actions": [
                    {"description": "Clear previous UI",
                     "tools": ["clearCanvas"]},
                    {"description": "Create the target panel",
                     "tools": ["createVotingPanel"]},
                ],
                "completion_criteria": {
                    "type": "player_action",
                    "description": "All living players have targeted and "
                                   "pick set for each.",
                    "wait_for": "all_players_action",
                    "target_players": {
                        "description": "All living players",
                        "condition": "player.is_alive == true"},
                },
                "next_phase": {"id": 2, "name": "Resolution"},
                "mechanics": ["target"],
            },
            2: {
                "name": "Resolution",
                "description": "Apply the fuzzed resolution rules.",
                "actions": [
                    {"description": "Clear pick UI", "tools": ["clearCanvas"]},
                    {"description": "Show the outcome",
                     "tools": ["createResultDisplay"]},
                ],
                "completion_criteria": {
                    "type": "UI_displayed",
                    "description": "Resolution has been displayed to all "
                                   "players."},
                "next_phase": {
                    f"If any player has {MAX_ROUNDS} or more rounds":
                        {"id": 99, "name": "Game Over"},
                    "Otherwise the arena continues":
                        {"id": 1, "name": "Target Pick"},
                },
                "mechanics": [{"effects": list(program_lines)
                               + ["---", "pick = 0", "rounds += 1"]}],
            },
            99: {
                "name": "Game Over",
                "description": "Congratulate the best score.",
                "actions": [
                    {"description": "Clear non-persistent UI",
                     "tools": ["clearCanvas"]},
                    {"description": "Display the winner",
                     "tools": ["createResultDisplay"]},
                ],
                "completion_criteria": {
                    "type": "UI_displayed",
                    "description": "Game Over has been displayed to all "
                                   "players."},
                "next_phase": None,
                "mechanics": [{"winner": {"score": "score"}}],
            },
        },
    }


# ---------------------------------------------------------------------------
# typed random program generator (emits the textual language)
# ---------------------------------------------------------------------------

_NUM_LEAVES = ("score", "aux", "pick", "rounds", "seat", "n_players",
               "choice", "-2", "0", "1", "3", "7")
_BOOL_LEAVES = ("flag", "alive", "chose(1)", "badge == 'Ash'",
                "badge != 'Birch'", "badge == 'Cedar'", "not flag")
_CMPS = ("==", "!=", ">=", "<=", ">", "<")
_VOCAB = ("'Ash'", "'Birch'", "'Cedar'", "''")


def _num(rng, depth, lets):
    if depth <= 0 or rng.random() < 0.3:
        if lets and rng.random() < 0.25:
            return str(rng.choice(lets))
        return str(rng.choice(_NUM_LEAVES))
    r = rng.random()
    a = _num(rng, depth - 1, lets)
    b = _num(rng, depth - 1, lets)
    c = _bool(rng, depth - 1, lets)
    if r < 0.30:
        op = rng.choice(["+", "-", "*"])
        return f"({a} {op} {b})"
    if r < 0.40:
        return f"{rng.choice(['min', 'max'])}({a}, {b})"
    if r < 0.45:
        return f"abs({a})"
    if r < 0.50:
        return f"clamp({a}, -5, 9)"
    if r < 0.58:
        return f"if({c}, {a}, {b})"
    if r < 0.66:
        return f"{rng.choice(['sum', 'reduce_max', 'reduce_min'])}({a}, {c})"
    if r < 0.72:
        return f"count({c})"
    if r < 0.78:
        return f"{rng.choice(['argmax', 'argmin'])}({a}, {c})"
    if r < 0.84:
        return f"at({a}, {_num(rng, 0, lets)})"
    if r < 0.90:
        return f"incoming({a}, choice, {c})"
    if r < 0.95:
        return f"eqcount({a}, {c})"
    return f"rank({a}, {c})"


def _bool(rng, depth, lets):
    if depth <= 0 or rng.random() < 0.35:
        return str(rng.choice(_BOOL_LEAVES))
    r = rng.random()
    if r < 0.55:
        return (f"({_num(rng, depth - 1, lets)} {rng.choice(_CMPS)} "
                f"{_num(rng, depth - 1, lets)})")
    a = _bool(rng, depth - 1, lets)
    b = _bool(rng, depth - 1, lets)
    if r < 0.75:
        return f"({a} and {b})"
    if r < 0.9:
        return f"({a} or {b})"
    return f"(not {a})"


def _where(rng, lets):
    return f" where {_bool(rng, 2, lets)}" if rng.random() < 0.6 else ""


def _statement(rng, lets):
    r = rng.random()
    if r < 0.08 and len(lets) < 3:
        name = f"v{len(lets)}"
        stmt = f"let {name} = {_num(rng, 2, lets)}"
        lets.append(name)
        return stmt
    if r < 0.30:
        f = rng.choice(["score", "aux"])
        op = rng.choice(["=", "+=", "-="])
        return f"{f} {op} {_num(rng, 2, lets)}{_where(rng, lets)}"
    if r < 0.38:
        return f"flag = {_bool(rng, 2, lets)}{_where(rng, lets)}"
    if r < 0.48:
        return f"badge = {rng.choice(_VOCAB)}{_where(rng, lets)}"
    if r < 0.56:
        key = rng.choice(["choice", "seat", _num(rng, 1, lets)])
        return f"marks[{key}] = 'seen'{_where(rng, lets)}"
    if r < 0.64:
        return f"reset {rng.choice(['score', 'aux', 'badge', 'marks', 'flag'])}{_where(rng, lets)}"
    if r < 0.72:
        salt = rng.choice(["rounds", "0", _num(rng, 1, lets)])
        return f"deal badge salt {salt}{_where(rng, lets)}"
    if r < 0.78:
        # rare, guarded kill — unguarded kills empty the room instantly
        return f"kill where ({_bool(rng, 2, lets)} and {_num(rng, 1, lets)} > 2)"
    if r < 0.83:
        # rare early game-over
        return (f"over argmax(score, alive) where "
                f"(count(alive) <= 1 and {_bool(rng, 1, lets)})")
    f = rng.choice(["score", "aux"])
    return f"{f} += {_num(rng, 2, lets)}{_where(rng, lets)}"


def _random_program(seed):
    rng = np.random.default_rng(seed)
    lines, lets = [], []
    n_blocks = int(rng.integers(1, 4))
    for b in range(n_blocks):
        if b:
            lines.append("---")
            lets = []  # let bindings are block-scoped snapshots
        for _ in range(int(rng.integers(2, 6))):
            lines.append(_statement(rng, lets))
    return lines


def _compiled(seed):
    """Generate until the validator accepts (bounded rerolls); the typed
    generator should land quickly — assert it does."""
    for sub in range(10):
        lines = _random_program(seed * 1000 + sub)
        doc = _fuzz_doc(lines)
        issues, spec = validate_doc(doc, name=f"ir-fuzz-{seed}")
        if spec is not None and not errors(issues):
            return lower(compile_game(spec)), lines, sub
    raise AssertionError(
        f"seed {seed}: 10 consecutive programs rejected; last: {lines} "
        f"/ {[str(i) for i in errors(issues)]}")


@pytest.mark.parametrize("fuzz_seed", range(6))
def test_random_ir_program_four_way_parity(fuzz_seed):
    lowered, lines, sub = _compiled(fuzz_seed)
    assert sub <= 5, f"generator rerolled {sub} times for {fuzz_seed}"

    # oracle vs jitted engine, step-for-step
    n = 5
    room = OracleRoom(lowered.game, n_players=n, seed=fuzz_seed)
    eng = BatchedEngine(lowered)
    state = init_state(lowered, 1, n, np.uint32(fuzz_seed))
    for t in range(300):
        room.step(oracle_policy(room, t, fuzz_seed))
        state = eng.step(state, scripted_actions(lowered, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done, f"episode did not terminate; program: {lines}"

    # C++ full-episode differential
    from game_engine_tpu.native import available
    if available():
        from tests.test_native import run_differential
        for seed in (fuzz_seed, fuzz_seed + 17):
            run_differential(lowered, n_players=n, seed=seed, max_steps=300)


@pytest.mark.parametrize("fuzz_seed", range(8, 12))
def test_random_ir_program_grouping_bit_identity(fuzz_seed):
    """GROUP_STMTS (statement reordering by write-target component) must
    be the identity on RANDOM typed programs — a harsher witness than the
    catalog games in tests/test_effects_grouping.py: random blocks
    interleave kills, deals, dict writes, resets and `over` with shared
    slots, so any flaw in the component analysis shows up here."""
    import jax

    from game_engine_tpu.core import step as S

    lowered, lines, _ = _compiled(fuzz_seed)
    B, steps = 16, 120

    def run(group):
        S.GROUP_STMTS = group
        try:
            st, eps = compiled_rollout(lowered, steps)(
                init_state(lowered, B, 5, np.arange(B, dtype=np.uint32)))
            return jax.tree_util.tree_map(np.asarray, st), int(eps)
        finally:
            S.GROUP_STMTS = False

    (st_a, eps_a), (st_b, eps_b) = run(False), run(True)
    assert eps_a == eps_b, lines
    for a, b in zip(jax.tree_util.tree_flatten(st_a)[0],
                    jax.tree_util.tree_flatten(st_b)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(lines))


def test_random_ir_program_batch_split_invariance():
    """One representative program: the XLA rollout is invariant to how
    rooms are batched."""
    from tests.rollout_helpers import assert_batch_split_invariant

    lowered, _lines, _ = _compiled(3)
    assert_batch_split_invariant(lowered, n_players=5, steps=60)
