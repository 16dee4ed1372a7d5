"""Checkpoint / resume + deterministic replay.

The reference persists in-flight game state in LangGraph platform threads
(reference: agent/game_agent_v2.py:1586-1587) and lobby state in
temp-rooms.json (reference: src/lib/storage/memory.ts:48-127). The
equivalents here:

  * ``save_state``/``load_state`` — device->host checkpoint of the GameState
    pytree as npz, step-indexed; also used for PPO training state via
    ``save_tree``/``load_tree`` (orbax-compatible layout is overkill for
    fixed-shape int banks; npz keeps checkpoints dependency-free and
    inspectable).
  * ``ActionLog`` + ``replay`` — deterministic recovery from
    (seed, DSL, action log): because the engine is a pure function of
    (state, actions), re-running the logged actions from init reproduces
    any state bit-exactly (SURVEY.md §2.5 fault-handling row).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from game_engine_tpu.core.state import GameState, init_state
from game_engine_tpu.gamespec.tables import Lowered

_FIELDS = GameState._fields


def save_state(path: str, state: GameState, step: Optional[int] = None) -> str:
    """Write a GameState checkpoint; returns the final path."""
    if step is not None:
        base, ext = os.path.splitext(path)
        path = f"{base}_step{step}{ext or '.npz'}"
    if not path.endswith(".npz"):
        path += ".npz"
    arrays = {f: np.asarray(getattr(state, f)) for f in _FIELDS}
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_state(path: str) -> GameState:
    with np.load(path) as z:
        return GameState(**{f: jnp.asarray(z[f]) for f in _FIELDS})


def save_tree(path: str, tree, meta: dict | None = None) -> None:
    """Checkpoint an arbitrary pytree (params, opt_state) as npz + treedef.

    ``meta`` rides in the .tree.json (e.g. the attn head count, which is
    not recoverable from parameter shapes). The sidecar name derives from
    the STEM so save_tree('x.npz') and load_policy('x.npz') agree (it
    used to write 'x.npz.tree.json', which load_policy never found —
    the host then silently served scripted bots)."""
    stem = path[:-4] if path.endswith(".npz") else path
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    np.savez_compressed(stem + ".npz", **arrays)
    with open(stem + ".tree.json", "w", encoding="utf-8") as f:
        json.dump({"treedef": str(treedef), "n": len(leaves),
                   **({"meta": meta} if meta else {})}, f)


def load_tree(path: str, like) -> object:
    """Restore a pytree saved by save_tree, using ``like`` for structure."""
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as z:
        leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(len(z.files))]
    treedef = jax.tree_util.tree_structure(like)
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# Action log + replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ActionLog:
    """Sparse per-step action record for deterministic replay."""

    game_name: str
    batch: int
    n_players: list[int]
    seeds: list[int]
    # steps[t] = {"b,p": choice} sparse nonzero actions
    steps: list[dict[str, int]] = dataclasses.field(default_factory=list)

    def record(self, actions: np.ndarray) -> None:
        nz = {}
        bs, ps = np.nonzero(actions)
        for b, p in zip(bs.tolist(), ps.tolist()):
            nz[f"{b},{p}"] = int(actions[b, p])
        self.steps.append(nz)

    def actions_at(self, t: int, P: int) -> np.ndarray:
        a = np.zeros((self.batch, P), np.int32)
        for key, c in self.steps[t].items():
            b, p = key.split(",")
            a[int(b), int(p)] = c
        return a

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "ActionLog":
        with open(path, "r", encoding="utf-8") as f:
            return cls(**json.load(f))


def replay(lowered: Lowered, log: ActionLog, until: Optional[int] = None) -> GameState:
    """Re-run a logged run from init; bit-identical by purity."""
    from game_engine_tpu.core.step import jit_step

    step = jit_step(lowered)
    state = init_state(
        lowered, log.batch, np.asarray(log.n_players, np.int32),
        np.asarray(log.seeds, np.uint32),
    )
    T = len(log.steps) if until is None else min(until, len(log.steps))
    for t in range(T):
        state = step(state, jnp.asarray(log.actions_at(t, lowered.P)))
    return state
