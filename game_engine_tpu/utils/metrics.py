"""Metrics + tracing.

The reference's observability is verbose per-node logging to a hardcoded
directory (reference: agent/game_agent_v2.py:60-93) plus optional LangSmith.
Equivalents here: on-device metric reduction (cheap sums over the
rooms axis, psum-ready under pjit), a host-side throughput meter, and a
``jax.profiler`` trace context for real timeline profiling.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from game_engine_tpu.core.state import GameState
from game_engine_tpu.gamespec.tables import Lowered


def room_metrics(lowered: Lowered, state: GameState) -> dict[str, jax.Array]:
    """On-device scalar metrics over the batch (jit-safe; under pjit these
    reduce across chips automatically since rooms are sharded on 'data')."""
    alive_slot = lowered.alive_bool
    alive = (
        state.bools[..., alive_slot] & state.present if alive_slot >= 0 else state.present
    )
    out: dict[str, jax.Array] = {
        "rooms": jnp.int32(state.present.shape[0]),
        "done_rooms": jnp.sum(state.done.astype(jnp.int32)),
        "mean_step": jnp.mean(state.t.astype(jnp.float32)),
        "mean_alive": jnp.mean(jnp.sum(alive, axis=1).astype(jnp.float32)),
    }
    # win counts by winner code (team index+1 or player id)
    done = state.done
    for w in (1, 2):
        out[f"wins_{w}"] = jnp.sum((state.winner == w) & done)
    # phase occupancy histogram
    out["phase_hist"] = jnp.sum(
        jax.nn.one_hot(state.phase, lowered.NP, dtype=jnp.int32), axis=0
    )
    return out


class Throughput:
    """Host-side steps/sec + episodes/sec meter."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.episodes = 0

    def add(self, steps: int, episodes: int = 0) -> None:
        self.steps += steps
        self.episodes += episodes

    def report(self) -> dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "steps_per_sec": self.steps / dt,
            "episodes_per_sec": self.episodes / dt,
            "wall_s": dt,
        }


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def phase_names(lowered: Lowered) -> list[str]:
    return [p.name for p in lowered.game.phases]


def summarize(lowered: Lowered, state: GameState) -> dict[str, Any]:
    """Host-side readable summary (pulls device metrics once)."""
    m = {k: np.asarray(v) for k, v in room_metrics(lowered, state).items()}
    hist = m.pop("phase_hist")
    top = np.argsort(-hist)[:3]
    names = phase_names(lowered)
    return {
        **{k: v.item() for k, v in m.items()},
        "top_phases": {names[i]: int(hist[i]) for i in top if hist[i] > 0},
    }
