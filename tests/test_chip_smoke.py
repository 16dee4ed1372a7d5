"""chip_smoke.py: the GPU gate, phase selection, and each phase's logic run
at a tiny size on the CPU (on the card the same functions run at full size).
The CPU here is both the "card" and the reference, so parity checks that
are exact on the card's integer paths are exact here too."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as C  # noqa: E402


def test_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as e:
        C.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_without_the_repo(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    the script exits non-zero and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_four_cards_selects_only_its_phase():
    assert C.phases_for(four_cards=True) == ("four_cards",)
    single = C.phases_for(four_cards=False)
    assert single[0] == "device_gate" and "four_cards" not in single
    assert set(single) == {"device_gate", "engine", "policy", "trainer",
                           "net_reference", "served_rooms", "driver_entry"}


def test_phase_engine_tiny():
    out = C.phase_engine(rooms=16, steps=64, iters=1, catalog_rooms=8,
                         catalog_steps=48, games=["tide-pool", "storm-forge"])
    assert out["rooms_bit_identical"] == 16 and out["episodes"] > 0


def test_phase_policy_tiny():
    out = C.phase_policy(rooms=16, hidden=32, inner_steps=16, iters=1)
    assert out["env_steps_per_s"] > 0


def test_phase_driver_entry():
    out = C.phase_driver_entry()
    assert out["logits_shape"][0] == 256


def test_phase_four_cards_on_virtual_devices():
    """The four-card phase on four of the eight virtual CPU devices: the
    sharded rollout is bit-identical, the sharded loss-gradient matches one
    device and the sharded league updates are finite."""
    import numpy as np

    res = C.phase_four_cards(rooms=32, steps=64, hidden=32, horizon=4)
    for name in ("data4", "data2_model2"):
        assert res[name]["loss_err"] <= C.FOUR_CARD_TOL["loss_err"]
        assert res[name]["grad_err"] <= C.FOUR_CARD_TOL["grad_err"]
        assert np.isfinite(res[name]["league_loss"])


def test_four_card_tolerance_catches_a_partial_batch():
    """The four-card bound has power: the loss-gradient of a quarter of the
    batch (what a sharded update that kept one card's share would give)
    is far outside it."""
    import jax
    import numpy as np

    from game_engine_tpu.core.state import init_state
    from game_engine_tpu.policies import net as N
    from game_engine_tpu.train.ppo import PPOConfig, init_training, ppo_loss

    lowered = C._lowered("werewolf")
    cfg = PPOConfig(horizon=4, epochs=1,
                    net=N.NetConfig(hidden=32, arch="attn"))
    params, _, _ = init_training(lowered, cfg, jax.random.PRNGKey(0))
    state = init_state(lowered, 32, 8, np.arange(32, dtype=np.uint32))
    traj, adv, ret = C.fixed_trajectory(lowered, cfg, params, state)
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, a, r: ppo_loss(p, t, a, r, cfg, lowered)[0]))
    loss, g = vg(params, traj, adv, ret)
    quarter = jax.tree_util.tree_map(lambda x: x[:, :8], (traj, adv, ret))
    loss_q, g_q = vg(params, *quarter)
    assert C._global_grad_err(g_q, g) > 10 * C.FOUR_CARD_TOL["grad_err"]
    assert C._global_grad_err(g, g) == 0.0
