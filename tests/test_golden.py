"""Golden oracle traces: pin the observable semantics of every shipped
game across code changes.

The 3-way parity suite (tests/test_parity.py, test_native.py) proves
the executors agree with EACH OTHER — but a semantic change applied
uniformly to all three (e.g. re-expressing a
bespoke mechanic family as an effect-IR program) would slip through it.
This fixture pins the oracle's full per-step trace hashes for every
catalog game so any such drift is loud: a mechanics migration must
reproduce these hashes bit-for-bit or consciously regenerate them with a
SEMANTICS.md note.

Regenerate (only for an intentional, documented semantic change):

    python tests/test_golden.py --regen
"""

import hashlib
import json
import os

import pytest

from game_engine_tpu.gamespec.compile import GameConfig, compile_game
from game_engine_tpu.gamespec.parser import games_dir, load_game_spec
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_oracle.json")

# keep the rounds-per-speaker games short so the capture stays fast
_CONFIG = {"two-truths-and-a-lie": GameConfig(rounds_per_player=1)}

_SEEDS = (0, 1, 7, 23)


def _game_files():
    return sorted(fn for fn in os.listdir(games_dir())
                  if fn.endswith((".yaml", ".yml")))


def _canon(v):
    """Canonical JSON-able form of an oracle player-field value."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, dict):
        return {str(k): _canon(x) for k, x in sorted(v.items())}
    if v is None:
        return ""
    return v


def trace_hash(game_file: str, n_players: int, seed: int,
               max_steps: int = 600) -> str:
    """SHA256 over the full per-step observable trace of one oracle room."""
    name = os.path.splitext(game_file)[0]
    spec = load_game_spec(os.path.join(games_dir(), game_file))
    game = compile_game(spec, _CONFIG.get(name, GameConfig()))
    room = OracleRoom(game, n_players=n_players, seed=seed)
    h = hashlib.sha256()

    def record():
        step = {
            "phase": room.phase.dsl_id,
            "done": room.done,
            "winner": room.winner,
            "players": {
                str(p): {k: _canon(v) for k, v in sorted(row.items())
                         if k != "name"}  # cosmetic, parity-exempt
                for p, row in room.players.items()
            },
        }
        h.update(json.dumps(step, sort_keys=True).encode())

    record()
    for t in range(max_steps):
        room.step(oracle_policy(room, t, seed))
        record()
        if room.done:
            break
    assert room.done, f"{game_file} n={n_players} seed={seed}: no finish"
    return h.hexdigest()


def _cases():
    out = []
    for fn in _game_files():
        spec = load_game_spec(os.path.join(games_dir(), fn))
        lo = int(spec.declaration.min_players)
        for n in (lo, min(lo + 2, 12)):
            for seed in _SEEDS:
                out.append((fn, n, seed))
    return out


def _capture() -> dict:
    traces = {}
    for fn, n, seed in _cases():
        traces[f"{fn}|n={n}|seed={seed}"] = trace_hash(fn, n, seed)
    return traces


@pytest.fixture(scope="module")
def golden():
    assert os.path.exists(FIXTURE), (
        "missing tests/fixtures/golden_oracle.json — run "
        "`python tests/test_golden.py --regen`")
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("game_file", _game_files())
def test_golden_traces(golden, game_file):
    mine = {k: trace_hash(*k.split("|")[0:1],
                          int(k.split("|")[1][2:]), int(k.split("|")[2][5:]))
            for k in golden if k.startswith(game_file + "|")}
    assert mine, f"no golden entries for {game_file} — regenerate"
    for k, want in ((k, golden[k]) for k in mine):
        assert mine[k] == want, (
            f"semantic drift: {k} trace hash changed — if intentional, "
            "document in SEMANTICS.md and regen the fixture")


def test_fixture_covers_every_game(golden):
    covered = {k.split("|")[0] for k in golden}
    assert covered == set(_game_files())


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
        traces = _capture()
        with open(FIXTURE, "w") as f:
            json.dump(traces, f, indent=0, sort_keys=True)
        print(f"wrote {len(traces)} trace hashes to {FIXTURE}")
    else:
        print(__doc__)
