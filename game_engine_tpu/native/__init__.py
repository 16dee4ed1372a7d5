"""Native (C++) runtime components: the table-driven room simulator."""

from game_engine_tpu.native.lib import CppGame, CppRoom, available, state_rows

__all__ = ["CppGame", "CppRoom", "available", "state_rows"]
