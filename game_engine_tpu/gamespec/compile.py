"""Assemble a CompiledGame: the full IR-level compilation of a game DSL.

CompiledGame is consumed by two executors with pinned-identical semantics:
  * oracle/interp.py  — plain-Python per-room interpreter (the oracle)
  * gamespec/tables.py + core/step.py — dense-table lowering for the
    jitted, batched device engine

Golden-parity tests assert bit-identical phase/vote/win traces between the
two (SURVEY.md §4 / BASELINE.json north star).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from game_engine_tpu.gamespec import conditions as C
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.expr import Pred, PredicateError, TRUE, parse_predicate
from game_engine_tpu.gamespec.layout import StateLayout, build_layout
from game_engine_tpu.gamespec.schema import CompletionType, GameSpec

DEFAULT_MAX_PLAYERS = 8


@dataclasses.dataclass(frozen=True)
class CompiledBranch:
    cond: C.Cond
    next_index: int  # dense phase index
    recognized: bool
    condition_text: str


@dataclasses.dataclass(frozen=True)
class CompiledPhase:
    index: int  # dense index
    dsl_id: int
    name: str
    completion: CompletionType
    target_pred: Pred  # who must act (player_action phases)
    program: M.PhaseProgram
    branches: tuple[CompiledBranch, ...]  # empty => static next or terminal
    next_index: Optional[int]  # static next (dense) or None
    terminal: bool


@dataclasses.dataclass(frozen=True)
class GameConfig:
    max_players: int = DEFAULT_MAX_PLAYERS
    rounds_per_player: int = 1  # the "agreed number of speaking turns"


@dataclasses.dataclass(frozen=True)
class CompiledGame:
    spec: GameSpec
    layout: StateLayout
    config: GameConfig
    phases: tuple[CompiledPhase, ...]  # dense-indexed
    id_to_index: dict[int, int]
    start_index: int

    @property
    def n_phases(self) -> int:
        return len(self.phases)

    def phase_by_id(self, dsl_id: int) -> CompiledPhase:
        return self.phases[self.id_to_index[dsl_id]]


def compile_game(spec: GameSpec, config: Optional[GameConfig] = None) -> CompiledGame:
    config = config or GameConfig()
    layout = build_layout(spec.declaration)
    programs = M.analyze(spec, layout)
    ctx = C.ConditionContext(spec, rounds_per_player=config.rounds_per_player)

    ids = spec.phase_ids
    id_to_index = {pid: i for i, pid in enumerate(ids)}

    phases: list[CompiledPhase] = []
    for pid in ids:
        ph = spec.phases[pid]
        try:
            target = parse_predicate(ph.completion.target_condition)
        except PredicateError:
            target = TRUE

        branches: list[CompiledBranch] = []
        for b in ph.branches:
            cond, ok = C.compile_branch_condition(b.condition, ctx)
            branches.append(
                CompiledBranch(
                    cond=cond,
                    next_index=id_to_index[b.phase_id],
                    recognized=ok,
                    condition_text=b.condition,
                )
            )
        # P5 fallback: force the last branch to Always so an unmatched round
        # always progresses (the reference's progression bias).
        if branches and not isinstance(branches[-1].cond, C.AlwaysTrue):
            last = branches[-1]
            branches.append(
                CompiledBranch(
                    cond=C.AlwaysTrue(),
                    next_index=last.next_index,
                    recognized=False,
                    condition_text="<fallback: repeat last branch>",
                )
            )

        next_index = id_to_index[ph.next_id] if ph.next_id is not None else None
        phases.append(
            CompiledPhase(
                index=id_to_index[pid],
                dsl_id=pid,
                name=ph.name,
                completion=ph.completion.type,
                target_pred=target,
                program=programs[pid],
                branches=tuple(branches),
                next_index=next_index,
                terminal=ph.is_terminal,
            )
        )

    return CompiledGame(
        spec=spec,
        layout=layout,
        config=config,
        phases=tuple(phases),
        id_to_index=id_to_index,
        start_index=id_to_index[spec.start_phase_id],
    )
