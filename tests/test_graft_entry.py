"""Driver-contract tests: __graft_entry__.entry() compiles and runs;
dryrun_multichip executes the full dp+tp train step on the virtual mesh."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest


def test_entry_compiles_and_runs():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    state, logits, value = out
    assert logits.shape[0] == 256 and logits.ndim == 3
    assert value.shape == logits.shape[:2]
    assert int(state.t[0]) == 1


def test_dryrun_multichip_8():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as g

    out = g.dryrun_multichip(8)  # raises on failure
    assert out["episodes"] > 0  # whole games complete under the sharded program
