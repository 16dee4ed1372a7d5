"""Tiny on-device chat language model: a byte-level causal transformer that
roleplays the in-game chat bot.

The reference's ChatBotNode is a gpt-4.1-mini call per chat message
(reference: agent/game_agent_v2.py:351-466); the engine's default responder
is the deterministic state-grounded template composer in server/chat.py.
This module is the LEARNED tier of that seam: a ~1M-param transformer
(rotary position encoding — see _rope — which is what lets a model this
small learn to COPY roster names from its context instead of
hallucinating name-shaped strings) trained by self-distillation — the
template composer plays teacher over thousands of simulated rooms with
unique-per-room synthetic handles — and served on the device behind
``ChatRoom(lm_hook=...)`` (``--chat-lm`` on the server CLI). Conditioning is
the exact ``server.chat.lm_context`` string, so serving inputs match the
training distribution; decoding is greedy and therefore deterministic
(journal replay reproduces chats bit-for-bit).

Pure-jax dict params in the house style (policies/net.py): bfloat16
matmuls with float32 accumulation, no framework dependencies.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

PAD, BOS, SEP, EOS = 0, 1, 2, 3
_NSPECIAL = 4
_LO, _HI = 32, 126  # printable ASCII
VOCAB = _NSPECIAL + (_HI - _LO + 1)  # 99


@dataclasses.dataclass(frozen=True)
class LMConfig:
    d_model: int = 160
    n_layers: int = 3
    n_heads: int = 4
    # ctx incl. roster + quoted boards + the round-4 G=/Pe= grounded and
    # persona segments (p99 ctx+reply ≈ 510 bytes over a 30-seed corpus;
    # 448 silently clipped the training target of ~16% of pairs, teaching
    # truncated replies with no EOS)
    max_len: int = 576
    # trained on grounded field Q&A (the context's G= fact segment)?
    # gates whether the serving tier may answer state questions
    # (server.chat.lm_may_serve); old checkpoints load as False
    grounded: bool = False
    # trained with the Pe= persona segment (server.chat personas)? gates
    # whether serving contexts carry the persona id; old checkpoints load
    # as False and keep byte-identical contexts
    personas: bool = False
    # trained on the v2 intents (rules/history/advice) and their Gd=/Hn=/
    # Wt= context segments? gates whether the serving tier may answer them
    # (server.chat lm_may_serve); old checkpoints load as False
    kinds2: bool = False
    # trained with the suspicion Am=/Dn= segments (accused-me flag + dead
    # count — the r4b residual's conditioning holes)? gates whether serving
    # emits them (server.chat _sus_extra); old checkpoints load as False
    sus2: bool = False


_FOLD = str.maketrans({"—": "-", "–": "-", "’": "'", "“": '"', "”": '"'})


def encode_text(s: str) -> list[int]:
    s = s.translate(_FOLD)
    return [_NSPECIAL + (ord(c) - _LO) for c in s if _LO <= ord(c) <= _HI]


def decode_tokens(toks) -> str:
    return "".join(
        chr(int(t) - _NSPECIAL + _LO) for t in toks
        if _NSPECIAL <= int(t) < VOCAB
    )


def pair_fits(ctx: str, reply: str, cfg: LMConfig) -> bool:
    """True when BOS+ctx+SEP+reply+EOS fits max_len — encode_pair silently
    truncates otherwise, which trains the student on a clipped reply with
    no EOS (run-on decodes). Trainers drop (and count) misfits."""
    return 3 + len(encode_text(ctx)) + len(encode_text(reply)) <= cfg.max_len


def encode_pair(ctx: str, reply: str, cfg: LMConfig) -> tuple[np.ndarray, np.ndarray]:
    """(tokens (L,), loss_mask (L,)) — next-token loss only on the reply+EOS."""
    toks = [BOS] + encode_text(ctx) + [SEP] + encode_text(reply) + [EOS]
    toks = toks[: cfg.max_len]
    sep_at = toks.index(SEP) if SEP in toks else len(toks) - 1
    out = np.full((cfg.max_len,), PAD, np.int32)
    out[: len(toks)] = toks
    # mask[i] marks positions whose NEXT token is a reply/EOS token
    mask = np.zeros((cfg.max_len,), np.float32)
    mask[sep_at: len(toks) - 1] = 1.0
    return out, mask


def init_params(key, cfg: LMConfig) -> dict[str, Any]:
    if cfg.d_model % cfg.n_heads != 0:
        raise ValueError(
            f"d_model={cfg.d_model} must be divisible by n_heads={cfg.n_heads}")
    D, H = cfg.d_model, 4 * cfg.d_model
    keys = jax.random.split(key, 2 + 4 * cfg.n_layers)

    def lin(k, i, o):
        return jax.random.normal(k, (i, o), jnp.float32) / np.sqrt(i)

    p: dict[str, Any] = {
        "tok": jax.random.normal(keys[0], (VOCAB, D), jnp.float32) * 0.02,
        "pos": jax.random.normal(keys[1], (cfg.max_len, D), jnp.float32) * 0.02,
        "lnf_s": jnp.ones((D,), jnp.float32),
        "lnf_b": jnp.zeros((D,), jnp.float32),
    }
    for i in range(cfg.n_layers):
        k = keys[2 + 4 * i: 6 + 4 * i]
        p[f"ln1_s{i}"] = jnp.ones((D,), jnp.float32)
        p[f"ln1_b{i}"] = jnp.zeros((D,), jnp.float32)
        p[f"wqkv{i}"] = lin(k[0], D, 3 * D)
        p[f"wo{i}"] = lin(k[1], D, D)
        p[f"ln2_s{i}"] = jnp.ones((D,), jnp.float32)
        p[f"ln2_b{i}"] = jnp.zeros((D,), jnp.float32)
        p[f"w1{i}"] = lin(k[2], D, H)
        p[f"b1{i}"] = jnp.zeros((H,), jnp.float32)
        p[f"w2{i}"] = lin(k[3], H, D)
        p[f"b2{i}"] = jnp.zeros((D,), jnp.float32)
    return p


def _ln(x, s, b):
    m = jnp.mean(x, axis=-1, keepdims=True)
    v = jnp.mean(jnp.square(x - m), axis=-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-5) * s + b


def _dot(a, b):
    return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _rope(x, pos, hd: int):
    """Rotary position encoding on the last dim (head dim).

    x: (..., hd); pos: broadcastable int positions. Content-based relative
    addressing is what lets a tiny model grow the induction/copy circuit —
    with learned absolute positions alone the roster-copy task never
    converged (it hallucinated name-shaped strings instead of copying)."""
    half = hd // 2
    freqs = 1.0 / (10000.0 ** (jnp.arange(half, dtype=jnp.float32) / half))
    ang = pos[..., None].astype(jnp.float32) * freqs  # (..., half)
    cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def forward(params: dict[str, Any], tokens: jax.Array, cfg: LMConfig) -> jax.Array:
    """tokens (B, L) int32 -> logits (B, L, V). Causal; PAD keys masked."""
    B, L = tokens.shape
    D, nh = cfg.d_model, cfg.n_heads
    hd = D // nh
    # embedding via one-hot matmul instead of a per-element gather over the
    # tiny vocab axis (the engine's no-gather rule, CLAUDE.md invariant 3):
    # (B,L,V)x(V,D) is one matrix product
    x = _dot(jax.nn.one_hot(tokens, VOCAB, dtype=jnp.bfloat16), params["tok"])
    x = x + params["pos"][None, :L]
    causal = jnp.tril(jnp.ones((L, L), bool))
    keymask = (tokens != PAD)[:, None, None, :]  # (B,1,1,L)
    for i in range(cfg.n_layers):
        h = _ln(x, params[f"ln1_s{i}"], params[f"ln1_b{i}"])
        qkv = _dot(h, params[f"wqkv{i}"]).reshape(B, L, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B,L,nh,hd)
        pos = jnp.arange(L, dtype=jnp.float32)[None, :, None]  # (1,L,1)
        q = _rope(q, pos, hd)
        k = _rope(k, pos, hd)
        att = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        att = jnp.where(causal[None, None] & keymask, att, -1e9)
        att = jax.nn.softmax(att, axis=-1)
        o = jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)
        x = x + _dot(o, params[f"wo{i}"])
        h = _ln(x, params[f"ln2_s{i}"], params[f"ln2_b{i}"])
        h = jax.nn.gelu(_dot(h, params[f"w1{i}"]) + params[f"b1{i}"])
        x = x + _dot(h, params[f"w2{i}"]) + params[f"b2{i}"]
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    return _dot(x, params["tok"].T)  # tied embedding head


def loss_fn(params, tokens, mask, cfg: LMConfig):
    """Next-token cross-entropy over masked (reply) positions."""
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    # one-hot contraction, not take_along_axis (CLAUDE.md invariant 3 —
    # the PPO loss had this exact gather cliff on the action axis)
    nll = -jnp.sum(logp * jax.nn.one_hot(targets, VOCAB, dtype=logp.dtype), -1)
    m = mask[:, : nll.shape[1]]
    return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)


# ---------------------------------------------------------------------------
# corpus: self-distillation from the template composer
# ---------------------------------------------------------------------------

# the round-3 query distribution — held-out evaluation of a checkpoint must
# use the distribution it TRAINED on (the shipped-checkpoint tests pin this
# tuple for pre-kinds2 checkpoints; a longer list reshuffles every draw)
_QUERIES_V1 = (
    "hello there", "hi everyone", "what's the status?", "who is still alive?",
    "what's happening?", "what's the score?", "who is winning?",
    "any statements yet?", "which one is the lie?", "who do you vote for?",
    "how will you vote?", "I suspect player 2", "player 3 is suspicious",
    "are you the werewolf?", "I think you're lying", "accuse someone",
    "tell me something", "what should we do?",
    # extra status-flavored draws: the alive/fallen roster lines are the
    # hardest copies (long, state-dependent), so they get more corpus share
    "who is left?", "who died?", "status report", "who remains?",
)

_QUERIES = _QUERIES_V1 + (
    # v2 intents (rules/history/advice): replies quote the Gd=/Hn= context
    # segments, so the copy circuit must learn them like the boards
    "what are the rules?", "how do i win?", "what happens in this phase?",
    "what happened?", "catch me up", "who should i vote for?",
    "any advice?", "what should i do?",
)

# sender names rotate so the model learns to COPY the S= field rather than
# memorize literals (serving names are arbitrary registered handles). A few
# hundred synthetic names force the attention-copy circuit to generalize —
# a dozen was too few (the model just memorized the pool).
def _sender_names() -> tuple[str, ...]:
    from game_engine_tpu.gamespec.mechanics import splitmix32

    heads = ("Al", "Bo", "Cy", "Da", "El", "Fi", "Gus", "Hana", "Ira", "Jo",
             "Kai", "Lu", "Mira", "Nox", "Oz", "Pia", "Quinn", "Rex", "Sol",
             "Tia", "Uma", "Vik", "Wyn", "Xan", "Yara", "Zed")
    tails = ("", "ra", "den", "lo", "mi", "ta", "vik", "sh", "na", "rik",
             "el", "issa")
    out = dict.fromkeys(["Viewer", "V"] + [f"player{k}" for k in range(2, 13)])
    for j, h in enumerate(heads):
        for k, t in enumerate(tails):
            name = h + t
            if (j + k) % 3 == 1:
                name = name.lower()
            out.setdefault(name)
    # uniformly random letter strings: syllable names alone let the model
    # memorize the pool's bigrams instead of learning the attention-copy
    # circuit; these force copying to work for ANY registered handle
    for i in range(300):
        h = splitmix32(0xC0FFEE + i)
        ln = 3 + h % 7
        cs = []
        for k in range(ln):
            h = splitmix32(h)
            cs.append(chr(ord("a") + h % 26))
        name = "".join(cs)
        h = splitmix32(h)
        if h % 3 == 0:
            name = name.capitalize()
        elif h % 3 == 1:
            name += str(h % 10)
        out.setdefault(name)
    return tuple(out)


_SENDERS = _sender_names()


def _rand_name(h: int) -> str:
    """Collision-rich synthetic handle from a hash — roster names must be
    effectively unique across the corpus, otherwise the student memorizes
    pool bigrams ('Zeddmi, aden, ...') instead of learning to COPY the
    roster from its context (the round-3 diagnosis)."""
    from game_engine_tpu.gamespec.mechanics import splitmix32

    ln = 3 + h % 7
    cs = []
    for _ in range(ln):
        h = splitmix32(h)
        cs.append(chr(ord("a") + h % 26))
    name = "".join(cs)
    h = splitmix32(h)
    if h % 3 == 0:
        name = name.capitalize()
    elif h % 4 == 0:
        name += str(h % 10)
    return name


def _grounded_query(fields: list[str], players: dict, h: int) -> str:
    """A state question naming a declared field (and sometimes a subject
    player), phrased so server.chat._field_answer resolves it — the
    grounded slice of the corpus (round-4: the learned tier now trains on
    exactly the queries the lm_ok gate used to route away from it)."""
    from game_engine_tpu.gamespec.mechanics import splitmix32

    f = fields[h % len(fields)]
    fw = f.replace("_", " ")
    h = splitmix32(h)
    pids = sorted(int(p) for p in players)
    subj = pids[h % len(pids)]
    subj_name = str(players.get(str(subj), {}).get("name") or f"Player {subj}")
    h = splitmix32(h)
    forms = (
        f"what is your {fw}?",
        f"what is {subj_name}'s {fw}?",
        f"how many {fw} do you have?",
        f"tell me your {fw}",
        f"what's player {subj}'s {fw}?",
        f"do you have {fw}?",
    )
    return forms[h % len(forms)]


def build_corpus(games=("werewolf", "two-truths-and-a-lie"), seeds=range(150),
                 max_pairs: int = 30000,
                 queries: Optional[tuple] = None) -> list[tuple[str, str]]:
    """(context, reply) pairs harvested by playing oracle rooms and asking
    the template composer at every phase step. Deterministic.

    Pairs come from plan_reply directly (context and composed reply are
    both in the plan), so grounded field answers — which bot_reply's
    lm_ok gate routes away from the hook — are trained too: one of the
    four per-step draws asks about a declared state field, with the
    room's real field visibility so hidden-field refusals are learned."""
    from game_engine_tpu.gamespec.compile import compile_game
    from game_engine_tpu.gamespec.parser import load_builtin
    from game_engine_tpu.gamespec.tables import lower
    from game_engine_tpu.oracle.interp import OracleRoom
    from game_engine_tpu.policies.net import field_visibility
    from game_engine_tpu.policies.scripted import oracle_policy
    from game_engine_tpu.server.chat import ChatRoom

    pairs: list[tuple[str, str]] = []
    # per-game quota: the outer game loop used to let the first game eat
    # the whole cap; with a multi-game catalog corpus (round 5) each game
    # gets an equal share so field vocabularies all get learned
    quota = max(1, max_pairs // len(tuple(games)))
    for gname in games:
        game_cap = min(max_pairs, len(pairs) + quota)
        game = compile_game(load_builtin(gname))
        vis = dict(field_visibility(lower(game)))
        for seed in seeds:
            room = OracleRoom(game, n_players=5 + seed % 4, seed=seed)
            # unique-per-room roster names: real rooms carry arbitrary
            # registered handles, and a finite pool lets the student
            # memorize plausible rosters instead of copying from context
            from game_engine_tpu.gamespec.mechanics import splitmix32 as _smx

            ghash = sum(ord(c) for c in gname)
            # a third of rooms keep the SERVER'S default handle styles
            # ("player2" / "Bot 3") — near-duplicate numbered names are the
            # most common serving case and the copy circuit must not
            # confuse them (live-HTTP garble: "player2, player2, player2")
            style = _smx((seed * 771 + ghash) & 0xFFFFFFFF) % 6
            for p in room.players:
                if "name" in room.players[p]:
                    if style == 0 and p != 1:  # human creator + default bots
                        room.players[p]["name"] = f"player{p}"
                    elif style == 1 and p != 1:
                        room.players[p]["name"] = f"Bot {p}"
                    else:
                        room.players[p]["name"] = _rand_name(
                            _smx((seed * 9176 + p * 331 + ghash) & 0xFFFFFFFF))
            from game_engine_tpu.server.chat import phase_guide_from_spec

            chat = ChatRoom("corpus", seed=seed, visibility=vis,
                            phase_guide=phase_guide_from_spec(game.spec))
            # the student trains on the Pe= persona segment so its decodes
            # can reproduce each bot's tics (serving emits Pe= only for
            # persona-trained checkpoints — hook.personas)
            chat.persona_ctx = True
            chat.sus_ctx = True
            fields = sorted(f for f in room.players[1] if f != "name")
            for t in range(400):
                room.step(oracle_policy(room, t, seed))
                # who must act next (serving: manager's waiting_on carries
                # the human seats the host blocks on; seat 1 is the corpus
                # sender) — grounds the advice intent's Wt= flag
                nxt = {} if room.done else oracle_policy(room, t + 1, seed)
                snap = {
                    "player_states": {str(p): dict(row) for p, row in room.players.items()},
                    "current_phase_name": room.phase.name,
                    "deadPlayers": [
                        p for p, row in room.players.items()
                        if not row.get("is_alive", True)
                    ],
                    "waiting_on": [1] if 1 in nxt else [],
                }
                # several queries per simulated step: the oracle stepping
                # dominates corpus cost, extra (sender, query) draws are
                # free. Draw 3 is a grounded field question — the slice
                # the lm_ok gate used to hide from the student entirely.
                for j in range(4):
                    if j == 3 and fields:
                        from game_engine_tpu.gamespec.mechanics import splitmix32 as _s

                        q = _grounded_query(
                            fields, snap["player_states"],
                            _s((seed * 131 + t * 17 + 5) & 0xFFFFFFFF))
                    else:
                        qs = queries or _QUERIES
                        q = qs[(seed * 7 + t + j * 5) % len(qs)]
                    who = _SENDERS[(seed * 5 + t * 3 + j * 101) % len(_SENDERS)]
                    chat.post(1, who, q)
                    plan = chat.plan_reply(1, who, q, snap)
                    if plan is not None:
                        # a pinned `queries` tuple means a LEGACY-
                        # distribution eval (pre-kinds2 checkpoint): drop
                        # pairs the CURRENT keyword table classifies into
                        # v2 kinds ("who died?" -> history) — their
                        # Gd=/Hn=/Wt= contexts and replies never existed
                        # in that checkpoint's training distribution. The
                        # reply is still committed so the message stream
                        # (and the accusation tracker reading it) evolves
                        # the same way serving would.
                        if not (queries is not None and re.search(
                                r"\|(Gd|Hn|Wt)=", plan["context"])):
                            pairs.append((plan["context"], plan["composed"]))
                        chat.commit_reply(plan, None)
                    if len(pairs) >= game_cap:
                        break
                if room.done or len(pairs) >= game_cap:
                    break
            if len(pairs) >= game_cap:
                break
        if len(pairs) >= max_pairs:
            break
    return pairs


# ---------------------------------------------------------------------------
# greedy decoding + serving hook
# ---------------------------------------------------------------------------


def _make_decoder(params, cfg: LMConfig, sample: bool = False):
    """One jitted KV-cache scan decoding a WHOLE reply in a single device
    dispatch. The old path re-ran the full (1, max_len) forward per token —
    up to 128 sequential dispatches per chat reply (ADVICE r2); this is one
    program whose total FLOPs equal ~two full forwards.

    ``sample=True`` builds the top-p/temperature variant for the roleplay
    tier: the next token is drawn by inverse-CDF over the nucleus (the
    smallest prefix of the sorted distribution whose mass reaches top_p)
    from a caller-provided uniform stream — randomness stays host-derived
    (splitmix32 over the context) so a decode is a pure function of
    (checkpoint, ctx, seed), replayable like everything else."""
    D, nh = cfg.d_model, cfg.n_heads
    hd = D // nh
    L = cfg.max_len

    def decode(buf, n0, u=None, inv_temp=None, top_p=None):
        caches = tuple(
            (jnp.zeros((L, nh, hd), jnp.float32),
             jnp.zeros((L, nh, hd), jnp.float32))
            for _ in range(cfg.n_layers)
        )

        def body(carry, pos):
            buf, caches = carry
            tok = jax.lax.dynamic_index_in_dim(buf, pos, 0, keepdims=False)
            x = _dot(jax.nn.one_hot(tok[None], VOCAB, dtype=jnp.bfloat16),
                     params["tok"])[0]
            x = x + jax.lax.dynamic_index_in_dim(params["pos"], pos, 0,
                                                 keepdims=False)
            new_caches = []
            valid = (jnp.arange(L) <= pos)[None, :]  # (1, L) over keys
            for i, (kc, vc) in enumerate(caches):
                h = _ln(x, params[f"ln1_s{i}"], params[f"ln1_b{i}"])
                qkv = _dot(h[None], params[f"wqkv{i}"]).reshape(3, nh, hd)
                q, k, v = qkv[0], qkv[1], qkv[2]
                posf = pos.astype(jnp.float32)[None]  # (1,) broadcast to heads
                q = _rope(q, posf, hd)
                k = _rope(k, posf, hd)
                kc = jax.lax.dynamic_update_index_in_dim(kc, k, pos, 0)
                vc = jax.lax.dynamic_update_index_in_dim(vc, v, pos, 0)
                att = jnp.einsum("hd,khd->hk", q, kc) / np.sqrt(hd)
                att = jnp.where(valid, att, -1e9)
                att = jax.nn.softmax(att, axis=-1)
                o = jnp.einsum("hk,khd->hd", att, vc).reshape(D)
                x = x + _dot(o[None], params[f"wo{i}"])[0]
                h = _ln(x, params[f"ln2_s{i}"], params[f"ln2_b{i}"])
                h = jax.nn.gelu(_dot(h[None], params[f"w1{i}"])[0]
                                + params[f"b1{i}"])
                x = x + _dot(h[None], params[f"w2{i}"])[0] + params[f"b2{i}"]
                new_caches.append((kc, vc))
            xf = _ln(x, params["lnf_s"], params["lnf_b"])
            logits = _dot(xf[None], params["tok"].T)[0]
            if sample:
                lg = logits.astype(jnp.float32) * inv_temp
                order = jnp.argsort(-lg)  # descending
                ps = jax.nn.softmax(lg)[order]
                cps = jnp.cumsum(ps)
                # nucleus: tokens whose preceding mass is < top_p (always
                # keeps the argmax token)
                keep = (cps - ps) < top_p
                kept = jnp.where(keep, ps, 0.0)
                ck = jnp.cumsum(kept)
                uv = jax.lax.dynamic_index_in_dim(u, pos, 0, keepdims=False)
                idx = jnp.sum((ck < uv * ck[-1]).astype(jnp.int32))
                nxt = order[jnp.minimum(idx, VOCAB - 1)].astype(jnp.int32)
            else:
                nxt = jnp.argmax(logits).astype(jnp.int32)
            # teacher-force inside the prompt, generate after it
            wpos = jnp.minimum(pos + 1, L - 1)
            cur = jax.lax.dynamic_index_in_dim(buf, wpos, 0, keepdims=False)
            gen = (pos + 1 >= n0) & (pos + 1 <= L - 1)
            buf = jax.lax.dynamic_update_index_in_dim(
                buf, jnp.where(gen, nxt, cur), wpos, 0)
            return (buf, tuple(new_caches)), ()

        (buf, _), _ = jax.lax.scan(body, (buf, caches), jnp.arange(L - 1))
        return buf

    return jax.jit(decode)


# bounded: each entry pins a params dict + compiled executable; unbounded
# growth leaked every previously-loaded checkpoint for process lifetime
_DECODER_CACHE: dict[tuple, Any] = {}
_DECODER_CACHE_MAX = 4


def _decoder_for(params, cfg: LMConfig, sample: bool):
    key = (id(params), dataclasses.astuple(cfg), sample)
    dec = _DECODER_CACHE.get(key)
    if dec is None:
        while len(_DECODER_CACHE) >= _DECODER_CACHE_MAX:
            _DECODER_CACHE.pop(next(iter(_DECODER_CACHE)))
        dec = _DECODER_CACHE[key] = (
            _make_decoder(params, cfg, sample=sample), params)
    return dec[0]


def _prompt_buf(cfg: LMConfig, ctx: str) -> tuple[np.ndarray, int]:
    # keep the FULL context (training saw it untruncated — encode_pair only
    # clips at max_len total); generation just uses whatever room is left
    toks = [BOS] + encode_text(ctx)[: cfg.max_len - 2] + [SEP]
    buf = np.full((cfg.max_len,), PAD, np.int32)
    buf[: len(toks)] = toks
    return buf, len(toks)


def _finish_reply(out_buf: np.ndarray, n0: int, max_new: int) -> str:
    gen = out_buf[n0:].tolist()
    hit_eos = False
    reply_toks = []
    for t in gen[:max_new]:
        if t == EOS or t < _NSPECIAL:
            hit_eos = True
            break
        reply_toks.append(t)
    out = decode_tokens(reply_toks).strip()
    if not hit_eos:
        # budget exhausted before EOS: keep only COMPLETE sentences — a
        # mid-list clip ("Still standing: A, B," missing seats) would
        # misreport the board; with no finished sentence at all, hand the
        # turn to the template tier ("" -> hook returns None)
        cut = max(out.rfind("."), out.rfind("!"), out.rfind("?"))
        return out[: cut + 1] if cut > 0 else ""
    return out


def greedy_reply(params, cfg: LMConfig, ctx: str, max_new: int = 320) -> str:
    """Deterministic greedy decode of a reply for a context string.

    Returns "" (caller falls back to the template tier) when the decode
    runs out of token budget before EOS — a truncated roster/status reply
    would factually misreport the board. The 320 budget covers the longest
    composed kind (rules: prefix + a ~230-char guide digest + persona
    tail); 192 silently clipped every two-sentence rules reply to its
    first sentence (r4b first-eval artifact)."""
    dec = _decoder_for(params, cfg, sample=False)
    buf, n0 = _prompt_buf(cfg, ctx)
    out_buf = np.asarray(dec(jnp.asarray(buf), jnp.int32(n0)))
    return _finish_reply(out_buf, n0, max_new)


def _ctx_uniforms(ctx: str, length: int, salt: int = 0) -> np.ndarray:
    """(length,) uniforms in [0,1) derived from the context by splitmix32 —
    the roleplay tier's randomness is a pure function of (ctx, salt), so a
    journal replay or a re-served identical message reproduces the same
    words (the determinism invariant holds even for flavor text)."""
    from game_engine_tpu.gamespec.mechanics import splitmix32

    h = (2166136261 ^ salt) & 0xFFFFFFFF
    for ch in ctx:
        h = ((h ^ ord(ch)) * 16777619) & 0xFFFFFFFF  # FNV-1a fold
    out = np.empty((length,), np.float64)
    for i in range(length):
        h = splitmix32((h + 0x9E3779B9) & 0xFFFFFFFF)
        out[i] = h / 4294967296.0
    return out.astype(np.float32)


def sampled_reply(params, cfg: LMConfig, ctx: str, *, temperature: float = 0.8,
                  top_p: float = 0.9, salt: int = 0,
                  max_new: int = 320) -> str:
    """Top-p/temperature decode for the roleplay tier — varied, in-persona
    smalltalk instead of the single greedy mode. Deterministic per
    (checkpoint, ctx, salt): randomness comes from a splitmix32 stream over
    the context, not a stateful RNG. Same truncation discipline as
    greedy_reply ("" on budget exhaustion without a complete sentence)."""
    dec = _decoder_for(params, cfg, sample=True)
    buf, n0 = _prompt_buf(cfg, ctx)
    u = jnp.asarray(_ctx_uniforms(ctx, cfg.max_len, salt))
    # floor only guards div-by-zero: temperature -> 0 must actually
    # concentrate the nucleus on the argmax (the greedy-equivalence pin in
    # tests/test_chat_sample.py); a 1e-3 floor left near-ties sampled
    out_buf = np.asarray(dec(jnp.asarray(buf), jnp.int32(n0), u,
                             jnp.float32(1.0 / max(temperature, 1e-6)),
                             jnp.float32(top_p)))
    return _finish_reply(out_buf, n0, max_new)


def save(path: str, params: dict[str, Any], cfg: LMConfig) -> None:
    # np.savez silently appends '.npz' to a bare path; normalize so that
    # save(p) and load(p) always agree on the file name
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, __config__=json.dumps(dataclasses.asdict(cfg)),
             **{k: np.asarray(v) for k, v in params.items()})


def load(path: str) -> tuple[dict[str, Any], LMConfig]:
    z = np.load(path, allow_pickle=False)
    cfg = LMConfig(**json.loads(str(z["__config__"])))
    params = {k: jnp.asarray(z[k]) for k in z.files if k != "__config__"}
    return params, cfg


# kinds with no factual payload: the only kinds the roleplay tier may
# sample. Everything that reports state (status/score/vote/field/v2
# intents/suspicion's named suspect) stays greedy — variety is never worth
# a misreported board.
SAMPLE_KINDS = frozenset({"greeting", "default"})
_CTX_KIND_RX = re.compile(r"^K=([a-z0-9_]+)\|")


def _ctx_names(ctx: str) -> list[str]:
    """Player names a reply might address: the sender (S=) plus the roster
    (Ns=). Used by the sampled tier's name guard."""
    names = []
    m = re.search(r"\|S=([^|]+)", ctx)
    if m:
        names.append(m.group(1))
    m = re.search(r"\|Ns=([^|]*)", ctx)
    if m:
        names += [e.split(":", 1)[1] for e in m.group(1).split(",")
                  if ":" in e]
    return [n for n in {n.strip() for n in names} if len(n) >= 3]


def names_intact(out: str, ctx: str) -> bool:
    """True when every word in ``out`` that shares a >=3-char prefix with a
    known player name IS that name exactly. Char-level sampling can wander
    mid-copy ("Vee" -> "Veee"); a reply that misspells who it's talking to
    reads broken even in smalltalk, so the roleplay tier regenerates (new
    salt) or falls back to greedy instead of shipping it."""
    words = set(re.findall(r"[A-Za-z0-9_']+", out))
    for nm in _ctx_names(ctx):
        for w in words:
            # case-sensitive containment: a garble extends the copied name
            # verbatim ("Vee" -> "Veee"/"Veec"); an unrelated word that
            # happens to share letters ("veer") differs in case and passes
            if w != nm and nm in w:
                return False
    return True


def make_lm_hook(ckpt_path: str, sample_temp: float = 0.0,
                 sample_top_p: float = 0.9):
    """Load a checkpoint and return the ChatRoom lm_hook callable.

    ``sample_temp > 0`` enables the roleplay tier: smalltalk kinds
    (SAMPLE_KINDS — greeting and open chatter, parsed from the context's
    ``K=`` prefix) decode with top-p/temperature sampling for varied
    in-persona replies, deterministically seeded from the context; an
    empty sampled decode falls back to greedy, then (via None) to the
    template composer. State-reporting kinds always decode greedy.

    Warms the jitted forward with one dummy decode so the first real chat
    message never pays the compile inside the GameHost
    lock, where it would stall every room's requests."""
    params, cfg = load(ckpt_path)
    greedy_reply(params, cfg, "K=greeting|P=warmup|B=1|N=P|S=V|A=1|D=|V=0"
                 "|R=0|Q=hi", max_new=2)
    if sample_temp > 0:
        sampled_reply(params, cfg, "K=greeting|P=warmup|B=1|N=P|S=V|A=1|D=|"
                      "V=0|R=0|Q=hi", temperature=sample_temp,
                      top_p=sample_top_p, max_new=2)

    def hook(ctx: str) -> Optional[str]:
        if sample_temp > 0:
            m = _CTX_KIND_RX.match(ctx)
            if m and m.group(1) in SAMPLE_KINDS:
                # deterministic retry schedule: a decode that garbles a
                # player name re-samples with the next salt, then yields
                # to greedy — replay still reproduces the same words
                for salt in (0, 1, 2):
                    out = sampled_reply(params, cfg, ctx,
                                        temperature=sample_temp,
                                        top_p=sample_top_p, salt=salt)
                    if out and names_intact(out, ctx):
                        return out
        return greedy_reply(params, cfg, ctx) or None

    # grounded-trained checkpoints may serve field questions (the commit
    # path still verifies the value before trusting the decode)
    hook.grounded = bool(cfg.grounded)
    hook.personas = bool(cfg.personas)
    hook.kinds2 = bool(cfg.kinds2)
    hook.sus2 = bool(cfg.sus2)
    hook.sampling = sample_temp > 0
    return hook
