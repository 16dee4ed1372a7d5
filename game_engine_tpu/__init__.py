"""game_engine_tpu — a batched game-simulation framework for accelerators.

Re-implements the capabilities of the reference "Full-Stack AI Game Engine"
(games described in a YAML DSL; see SURVEY.md) as a compiled,
pure-functional, jittable state-transition FSM over a struct-of-arrays room
state, batched with vmap/pjit over thousands of rooms per chip.

Layers (mirrors SURVEY.md §7 build plan):
  gamespec/  DSL compiler: YAML -> GameSpec -> CompiledGame IR -> SpecTables
  core/      pure-functional jittable engine: GameState pytree + step()
  oracle/    plain-Python reference interpreter (pinned deterministic semantics)
  policies/  scripted + learned bot policies
  parallel/  mesh / sharding / multi-chip rollout
  view/      canvas projection (items[] / AgentState contract)
  server/    rooms & lobby host service
  train/     PPO self-play
  dslgen/    DSL generation pipeline
"""

__version__ = "0.1.0"

from game_engine_tpu.gamespec.parser import load_game_spec, parse_game_spec
from game_engine_tpu.gamespec.compile import compile_game

__all__ = ["load_game_spec", "parse_game_spec", "compile_game", "__version__"]
