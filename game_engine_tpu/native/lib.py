"""ctypes bindings + lazy build of the C++ simulator (libgamesim.so)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Any, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gamesim.cpp")
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get("GAMESIM_CACHE") or os.path.join(
        tempfile.gettempdir(), "gamesim_cache"
    )
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"libgamesim_{digest}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    so = _so_path()
    if not os.path.exists(so):
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", so + ".tmp"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
            os.replace(so + ".tmp", so)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
            _build_error = getattr(e, "stderr", str(e)) or str(e)
            return None
    lib = ctypes.CDLL(so)
    lib.gs_create.restype = ctypes.c_void_p
    lib.gs_create.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.gs_destroy.argtypes = [ctypes.c_void_p]
    lib.gs_room_new.restype = ctypes.c_void_p
    lib.gs_room_new.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32]
    lib.gs_room_destroy.argtypes = [ctypes.c_void_p]
    lib.gs_room_step.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.gs_room_policy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.gs_state_size.restype = ctypes.c_int64
    lib.gs_state_size.argtypes = [ctypes.c_void_p]
    lib.gs_room_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.gs_room_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.gs_selfplay.restype = ctypes.c_int64
    lib.gs_selfplay.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gs_room_search.restype = ctypes.c_int32
    lib.gs_room_search.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_uint32,
    ]
    lib.gs_room_search_scores.restype = ctypes.c_int32
    lib.gs_room_search_scores.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
    ]
    return lib


def available() -> bool:
    global _lib
    if _lib is None and _build_error is None:
        _lib = _build()
    return _lib is not None


class CppGame:
    """A compiled game loaded into the native simulator."""

    def __init__(self, lowered):
        from game_engine_tpu.native.pack import pack

        if not available():
            raise RuntimeError(f"gamesim build failed: {_build_error}")
        self.lowered = lowered
        self._blob = np.ascontiguousarray(pack(lowered))
        self._h = _lib.gs_create(
            self._blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(self._blob)
        )
        if not self._h:
            raise RuntimeError("gs_create rejected blob")
        self.state_size = _lib.gs_state_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            _lib.gs_destroy(self._h)
            self._h = None

    def room(self, n_players: int, seed: int) -> "CppRoom":
        return CppRoom(self, n_players, seed)

    def selfplay(self, rooms: int, n_players: int, seed0: int, steps: int) -> int:
        """Scripted self-play over many rooms; returns completed episodes."""
        return int(_lib.gs_selfplay(self._h, rooms, n_players, seed0, steps, None))

    def selfplay_states(self, rooms: int, n_players: int, seed0: int,
                        steps: int) -> tuple[int, np.ndarray]:
        """selfplay() that also returns every room's final state: an int32
        (rooms, state_size + 1) array of CppRoom.read() images, each row
        ending in the room's seed (compare with `state_rows`)."""
        out = np.zeros((rooms, self.state_size + 1), np.int32)
        eps = _lib.gs_selfplay(self._h, rooms, n_players, seed0, steps,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return int(eps), out


class CppRoom:
    """One native room with the same step/read semantics as the oracle."""

    def __init__(self, game: CppGame, n_players: int, seed: int):
        self.game = game
        self.n = n_players
        self._h = _lib.gs_room_new(game._h, n_players, seed)

    def __del__(self):
        if getattr(self, "_h", None):
            _lib.gs_room_destroy(self._h)
            self._h = None

    def step(self, actions: Optional[dict[int, int]] = None) -> None:
        P = self.game.lowered.P
        buf = np.zeros(P, np.int32)
        for pid, c in (actions or {}).items():
            if 1 <= pid <= P:
                buf[pid - 1] = int(c)
        _lib.gs_room_step(self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    def search(self, pid: int, rollouts: int, max_steps: int, mode: int,
               team_slot: int, team_codes: "list[int] | tuple[int, ...]",
               salt: int) -> int:
        """Flat Monte-Carlo lookahead for one seat (gs_room_search); returns
        the chosen 1-based action or 0 when this seat has no decision /
        the game has no searchable terminal reward."""
        codes = np.asarray(team_codes or [0], np.int32)
        return int(_lib.gs_room_search(
            self._h, pid, rollouts, max_steps, mode, team_slot,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(codes),
            ctypes.c_uint32(salt & 0xFFFFFFFF)))

    def search_scores(self, pid: int, rollouts: int, max_steps: int,
                      mode: int, team_slot: int,
                      team_codes: "list[int] | tuple[int, ...]",
                      salt: int, cap: int = 1024) -> Optional[dict[int, int]]:
        """Per-candidate rollout score totals for one seat
        (gs_room_search_scores — the information-set search tier's
        primitive). Returns {candidate: total}, {1: 0} for a forced
        submit, or None when this seat has no decision. argmax over the
        dict in ascending candidate order reproduces search() exactly."""
        codes = np.asarray(team_codes or [0], np.int32)
        cands = np.zeros(cap, np.int32)
        scores = np.zeros(cap, np.int64)
        n = int(_lib.gs_room_search_scores(
            self._h, pid, rollouts, max_steps, mode, team_slot,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(codes),
            ctypes.c_uint32(salt & 0xFFFFFFFF),
            cands.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap))
        if n < 0:
            return {1: 0}
        if n == 0:
            return None
        return {int(cands[j]): int(scores[j]) for j in range(n)}

    def policy_actions(self) -> dict[int, int]:
        P = self.game.lowered.P
        buf = np.zeros(P, np.int32)
        _lib.gs_room_policy(self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return {p + 1: int(buf[p]) for p in range(P) if buf[p] != 0}

    def write(self, state: dict[str, Any]) -> None:
        """Inverse of read(): restore the room from a serialized state dict
        (journal-compaction snapshots)."""
        lw = self.game.lowered
        P = lw.P
        lay = lw.game.layout
        buf = np.concatenate([
            np.asarray([state["phase_index"], int(state["done"]),
                        state["winner"], state["prev_index"], state["t"]],
                       np.int32),
            np.asarray(state["bools"], np.int32).reshape(-1),
            np.asarray(state["nums"], np.int32).reshape(-1),
            np.asarray(state["strs"], np.int32).reshape(-1),
            np.asarray(state["pdict"], np.int32).reshape(-1),
            np.asarray(state["odict"], np.int32).reshape(-1),
            np.asarray(state["acted"], np.int32).reshape(-1),
            np.asarray(state["choice"], np.int32).reshape(-1),
            np.asarray(state["choice_phase"], np.int32).reshape(-1),
        ])
        assert len(buf) == self.game.state_size, (len(buf), self.game.state_size)
        _lib.gs_room_write(self._h,
                           buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    def read(self) -> dict[str, Any]:
        lw = self.game.lowered
        P = lw.P
        lay = lw.game.layout
        buf = np.zeros(self.game.state_size, np.int32)
        _lib.gs_room_read(self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        k = 5
        NB, NN, NS = lay.n_bool, lay.n_num, lay.n_str
        NPD, NOD = lay.n_pdict, lay.n_odict
        out = {
            "phase_index": int(buf[0]),
            "phase_id": int(lw.phase_dsl_id[buf[0]]),
            "done": bool(buf[1]),
            "winner": int(buf[2]),
            "prev_index": int(buf[3]),
            "t": int(buf[4]),
        }
        out["bools"] = buf[k : k + P * NB].reshape(P, NB).astype(bool); k += P * NB
        out["nums"] = buf[k : k + P * NN].reshape(P, NN); k += P * NN
        out["strs"] = buf[k : k + P * NS].reshape(P, NS); k += P * NS
        out["pdict"] = buf[k : k + P * NPD * P].reshape(P, NPD, P); k += P * NPD * P
        out["odict"] = buf[k : k + P * NOD].reshape(P, NOD); k += P * NOD
        out["acted"] = buf[k : k + P].astype(bool); k += P
        out["choice"] = buf[k : k + P]; k += P
        out["choice_phase"] = buf[k : k + P]
        return out


def state_rows(state) -> np.ndarray:
    """A batched GameState as the int32 (rooms, state_size + 1) layout of
    `CppGame.selfplay_states`: the gs_room_read image, then the seed."""
    def flat(x):
        x = np.asarray(x)
        return x.reshape(x.shape[0], -1).astype(np.int64)

    cols = [flat(state.phase), flat(state.done), flat(state.winner),
            flat(state.prev_phase), flat(state.t), flat(state.bools),
            flat(state.nums), flat(state.strs), flat(state.pdict),
            flat(state.odict), flat(state.acted), flat(state.choice),
            flat(state.choice_phase), flat(state.seed)]
    # uint32 seeds wrap into int32 exactly as the C side stores them
    return np.concatenate(cols, axis=1).astype(np.uint32).view(np.int32)
