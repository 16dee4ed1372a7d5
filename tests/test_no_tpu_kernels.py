"""Guard: no program file reaches the Mosaic-TPU Pallas backend."""

import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TPU_PALLAS = re.compile(
    r"pallas\.tpu|pallas\s+import\s+tpu|\bpltpu\b|\bVMEM\b|libtpu")


def test_no_program_file_imports_pallas_tpu():
    files = sorted((ROOT / "game_engine_tpu").rglob("*.py")) + [
        ROOT / "bench.py", ROOT / "__graft_entry__.py", ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if TPU_PALLAS.search(line)]
    assert not hits, hits
