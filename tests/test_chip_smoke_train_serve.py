"""chip_smoke.py's trainer, net-reference and served-room phases at a tiny
size on the CPU."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402


def test_phase_trainer_tiny():
    res = C.phase_trainer(batch=16, hidden=32, horizon=4, epochs=1, updates=2,
                          eval_batch=16)
    assert set(res) == {"attn", "attn_league", "deepsets"}
    assert all(np.isfinite(r["loss"]) for r in res.values())


def test_phase_net_reference_tiny():
    """The phase function end to end: every random-init arch and the served
    bot's trained checkpoint within their measured tolerances, with the
    greedy agreement counted on rows the reference decides."""
    res = C.phase_net_reference(rooms=16, horizon=2, hidden=32)
    assert set(res) == {"mlp", "deepsets", "attn", "attn_trained"}
    for name, r in res.items():
        assert all(r[k] <= r["tolerance"][k] for k in r["tolerance"]), name
        assert r["greedy_agree"] >= C.GREEDY_MIN


def test_greedy_agreement_skips_exact_ties():
    legal = np.array([[True, True, True], [True, True, False],
                      [True, False, False], [True, True, True]])
    rows = np.array([True, True, True, False])
    ref = np.array([[1.0, 1.0, 0.0],   # tie: not counted
                    [2.0, 1.0, 9.0],   # decisive, best legal is 0
                    [0.0, 5.0, 5.0],   # one legal action
                    [3.0, 1.0, 1.0]])  # not a row
    same = C.greedy_agreement(ref, ref, legal, rows)
    assert same == (1.0, 2)
    flipped = ref.copy()
    flipped[0] = [0.0, 2.0, 0.0]     # the tie resolved the other way
    assert C.greedy_agreement(flipped, ref, legal, rows) == (1.0, 2)
    flipped[1] = [1.0, 2.0, 9.0]     # a decisive row flipped
    assert C.greedy_agreement(flipped, ref, legal, rows) == (0.5, 2)


def test_phase_served_rooms_tiny(tmp_path):
    out = C.phase_served_rooms(str(tmp_path / "rooms"), werewolf_rooms=1,
                               twotruths_rooms=1)
    assert out["restored_equal"] and out["chat_lm_decodes"] >= 1
    assert all(w >= 1 for w in out["winners"])
