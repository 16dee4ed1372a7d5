"""The tiny on-device chat LM (policies/chat_lm.py): encoding round-trips,
training signal, deterministic decoding, and the ChatRoom lm_hook seam —
the learned tier of the reference's ChatBotNode (reference:
agent/game_agent_v2.py:351-466)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from game_engine_tpu.policies import chat_lm as C
from game_engine_tpu.server.chat import ChatRoom, lm_context

# max_len must fit the full context (the Ns= roster pushed real
# contexts to ~190 chars) plus the reply — a clipped SEP would
# zero the loss mask
CFG = C.LMConfig(d_model=32, n_layers=1, n_heads=2, max_len=288)


def test_encode_decode_roundtrip():
    s = "Hey Max! We're in Day Voting - 4 of us still in it."
    assert C.decode_tokens(C.encode_text(s)) == s
    toks, mask = C.encode_pair("K=vote|Q=hi", "my reply", CFG)
    assert toks[0] == C.BOS and C.SEP in toks.tolist() and C.EOS in toks.tolist()
    sep = toks.tolist().index(C.SEP)
    # loss positions cover exactly the reply + EOS predictions
    assert mask[sep] == 1.0 and mask.sum() == len("my reply") + 1


def test_corpus_is_deterministic_and_grounded():
    a = C.build_corpus(games=("werewolf",), seeds=range(4), max_pairs=60)
    b = C.build_corpus(games=("werewolf",), seeds=range(4), max_pairs=60)
    assert a == b and len(a) == 60
    ctx, reply = a[0]
    assert ctx.startswith("K=") and "|P=" in ctx and "|Q=" in ctx
    assert reply


def test_training_reduces_loss_and_decodes_deterministically():
    pairs = C.build_corpus(games=("werewolf",), seeds=range(2), max_pairs=80)
    toks, masks = zip(*(C.encode_pair(c, r, CFG) for c, r in pairs))
    toks, masks = np.stack(toks), np.stack(masks)
    params = C.init_params(jax.random.PRNGKey(0), CFG)
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, t, m):
        loss, g = jax.value_and_grad(C.loss_fn)(p, t, m, CFG)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    rng = np.random.default_rng(0)
    first = last = None
    for s in range(60):
        idx = rng.integers(0, len(toks), size=32)
        params, opt, loss = step(params, opt, jnp.asarray(toks[idx]),
                                 jnp.asarray(masks[idx]))
        if s == 0:
            first = float(loss)
        last = float(loss)
    assert last < first * 0.75, (first, last)
    r1 = C.greedy_reply(params, CFG, pairs[0][0], max_new=24)
    r2 = C.greedy_reply(params, CFG, pairs[0][0], max_new=24)
    assert r1 == r2  # greedy = deterministic = journal-replay safe


def test_save_load_roundtrip(tmp_path):
    params = C.init_params(jax.random.PRNGKey(1), CFG)
    path = str(tmp_path / "lm.npz")
    C.save(path, params, CFG)
    params2, cfg2 = C.load(path)
    assert cfg2 == CFG
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(params2[k]))
    hook = C.make_lm_hook(path)
    out = hook("K=greeting|P=Day|B=2|N=Bo|S=Al|A=1,2|D=|V=0|Q=hi")
    assert out is None or isinstance(out, str)


def _snapshot():
    return {
        "player_states": {
            "1": {"name": "Al", "is_alive": True},
            "2": {"name": "Bo", "is_alive": True},
            "3": {"name": "Cy", "is_alive": False},
        },
        "current_phase_name": "Day Voting",
        "deadPlayers": [3],
    }


def test_chatroom_lm_hook_seam():
    """The hook receives the lm_context string and its reply is posted by
    the bot; host rules (bot selection, dead silent, visibility) stay."""
    seen = []

    def hook(ctx):
        seen.append(ctx)
        return "I am the learned bot."

    room = ChatRoom("r", seed=3, lm_hook=hook)
    room.post(1, "Al", "to Bot 2: who looks guilty?")
    msg = room.bot_reply(1, "Al", "to Bot 2: who looks guilty?", _snapshot())
    assert msg.message == "I am the learned bot."
    assert msg.playerId == "2" and msg.visibility == "private"
    # the context carries the composer's style roll (seed=3, 1 message, bot 2)
    from game_engine_tpu.gamespec.mechanics import splitmix32

    h2 = splitmix32((3 + 1 * 7 + 2) & 0xFFFFFFFF)
    assert seen and seen[0] == lm_context(
        "suspicion", 2, "Al", "who looks guilty?", _snapshot(), variant=h2)
    # dead bots never speak, hook or not
    assert room.bot_reply(1, "Al", "to Bot 3: hi", _snapshot()) is None


def test_chatroom_lm_hook_falls_back_on_empty():
    room = ChatRoom("r", seed=3, lm_hook=lambda ctx: None)
    msg = room.bot_reply(1, "Al", "hello there", _snapshot())
    assert msg is not None and msg.message  # template fallback


def test_shipped_checkpoint_if_present():
    """Decode an IN-DISTRIBUTION context (a held-out corpus pair, i.e.
    what lm_context actually emits in serving — full Ns=/X=/L=/F=/Pe=
    segment list). Earlier revisions used a minimal v1-style context; the
    richer-context students (r4c+) correctly treat that as
    out-of-vocabulary and emit EOS immediately, which the serving path
    maps to the template fallback — not a defect, so don't test it."""
    import os

    path = os.path.join(os.path.dirname(__file__), "..",
                        "docs", "checkpoints", "chat_lm.npz")
    if not os.path.exists(path):
        pytest.skip("no shipped chat LM checkpoint")
    hook = C.make_lm_hook(path)
    ctx = C.build_corpus(games=("werewolf",), seeds=range(330, 331),
                         max_pairs=1)[0][0]
    out = hook(ctx)
    assert out and out == hook(ctx)  # non-empty and deterministic

def test_shipped_checkpoint_copies_default_numbered_handles():
    """The live-HTTP garble regression: rooms created without custom names
    get the server's default near-duplicate handles ("player2" / "Bot 3"),
    and the round-2 model collapsed roster listings into repeats
    ("player2, player2, player2"). A third of the training corpus now uses
    those default styles; roster-listing replies must copy the numbered
    names verbatim."""
    import os
    import re

    path = os.path.join(os.path.dirname(__file__), "..",
                        "docs", "checkpoints", "chat_lm.npz")
    if not os.path.exists(path):
        pytest.skip("no shipped chat LM checkpoint")
    params, cfg = C.load(path)
    # held-out rooms (train corpus uses seeds 0..259), drawn from the query
    # distribution THIS checkpoint trained on (pre-kinds2 ckpts trained on
    # the v1 query tuple; the v2 list reshuffles every draw)
    pairs = C.build_corpus(games=("werewolf",), seeds=range(300, 312),
                           max_pairs=3000,
                           queries=None if cfg.kinds2 else C._QUERIES_V1)
    cases = []
    for ctx, ref in pairs:
        m = re.search(r"\|Ns=([^|]*)", ctx)
        if not m or ("player" not in m.group(1) and "Bot " not in m.group(1)):
            continue
        if "standing" not in ref:
            continue
        cases.append((ctx, ref, m.group(1)))
        if len(cases) >= 6:
            break
    assert cases, "no default-handle roster-listing pairs found"
    oblig = met = 0
    for ctx, ref, ns in cases:
        out = C.greedy_reply(params, cfg, ctx)
        roster = [e.split(":", 1)[1] for e in ns.split(",") if ":" in e]
        for nm in roster:
            if re.search(rf"(?<!\w){re.escape(nm)}(?!\w)", ref):
                oblig += 1
                met += int(bool(re.search(rf"(?<!\w){re.escape(nm)}(?!\w)", out)))
        # the garble mode: the same numbered handle repeated more often
        # than the reference mentions it
        for nm in set(roster):
            assert out.count(nm) <= ref.count(nm) + 1, (ctx, out, ref)
    assert oblig >= 10
    assert met / oblig >= 0.8, f"name copy {met}/{oblig} on numbered handles"


def test_pair_fits_guards_silent_truncation():
    """encode_pair silently clips over-long pairs (reply loses its EOS);
    pair_fits is the trainer's drop predicate for exactly those pairs."""
    cfg = C.LMConfig(d_model=32, n_layers=1, n_heads=2, max_len=64)
    ctx, reply = "K=greeting|Q=hi", "Hello there, friend."
    assert C.pair_fits(ctx, reply, cfg)
    tok, mask = C.encode_pair(ctx, reply, cfg)
    # the full reply+EOS carries loss when the pair fits
    assert int(mask.sum()) == len(C.encode_text(reply)) + 1
    long_reply = "x" * 100
    assert not C.pair_fits(ctx, long_reply, cfg)
    tok2, mask2 = C.encode_pair(ctx, long_reply, cfg)
    assert int(mask2.sum()) < len(C.encode_text(long_reply)) + 1  # clipped
