"""The policy net (bf16 dots, float32 accumulation) against a float32
"highest"-precision reference, per arch, forward and loss gradient.

The compared side runs op by op (no jit: another fusion and accumulation
order than the compiled program); the reference is the jitted program on
the CPU under jax.default_matmul_precision("highest"), with the tolerances
chip_smoke.py holds the card to (measured from the reference's own noise
floor, see chip_smoke.NOISE_REL)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from game_engine_tpu.core.state import init_state
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.policies import net as N
from game_engine_tpu.train.ppo import PPOConfig, gae, init_training, make_unroll

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402

ARCHS = ["mlp", "deepsets", "attn"]


@pytest.fixture(scope="module")
def compared():
    """arch -> (errors, tolerances, eager outputs) for a real rollout."""
    lowered = lower(compile_game(load_builtin("werewolf")))
    out = {}
    for arch in ARCHS:
        cfg = PPOConfig(horizon=2, epochs=1,
                        net=N.NetConfig(hidden=32, arch=arch))
        params, _, _ = init_training(lowered, cfg, jax.random.PRNGKey(1))
        state = init_state(lowered, 8, 6, np.arange(8, dtype=np.uint32))
        _, _, traj = jax.jit(make_unroll(lowered, cfg))(
            params, state, jax.random.PRNGKey(2))
        _, last_v = N.apply_net(params, traj.obs[-1], cfg.net, lowered)
        adv, ret = gae(traj, last_v, cfg)
        inputs = jax.device_get((params, traj, adv, ret))
        evaluate = C.net_evaluator(cfg, lowered)
        with jax.disable_jit():
            eager = jax.device_get(evaluate(*inputs))
        res, tol, _ = C.compare_to_reference(evaluate, inputs, eager)
        out[arch] = (res, tol, eager)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_net_matches_highest_reference(arch, compared):
    res, tol, (logits, value, _, _) = compared[arch]
    assert np.isfinite(logits).all() and np.isfinite(value).all()
    assert logits.shape[:-1] == value.shape
    assert res["logits_err"] <= tol["logits_err"], (res, tol)
    assert res["value_err"] <= tol["value_err"], (res, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_ppo_loss_grad_matches_highest_reference(arch, compared):
    res, tol, (_, _, loss, grads) = compared[arch]
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(g)).all() for g in grads.values())
    assert res["loss_err"] <= tol["loss_err"], (res, tol)
    assert res["grad_err"] <= tol["grad_err"], (res, tol)
