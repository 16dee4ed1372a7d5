"""Learned bot policy: per-player actor-critic heads over room observations.

Replaces the scripted policy for PPO/league self-play (BASELINE.json configs
4-5). The reference has no learned policies — bots are LLM calls (reference:
agent/game_agent_v2.py:468-617); this is the batched on-device substitute: a shared
MLP trunk with tensor-parallel-shardable hidden layers, producing per-player
action logits over the unified choice space {1..P targets / options} plus a
value head.

Observation design (``obs_dim`` static per compiled game):
  per player: [bool bank, num bank (scaled), one-hot str banks,
               phase one-hot, acted flag, alive-count fraction]
observe() defaults to the MASKED hidden-role view (field_visibility:
self-only bookkeeping, team-visible roles for the coordinating minority,
P15 reveal flags re-publicizing a dead seat's role); every trainer uses
it. masked=False gives the full-information centralized view for
debug/ablation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from game_engine_tpu.core.state import GameState
from game_engine_tpu.core.step import _alive
from game_engine_tpu.gamespec.tables import Lowered


import re as _re

_PRIVATE_RE = _re.compile(r"\bprivate\b|\bhidden\b|\bsecret\b", _re.IGNORECASE)

VIS_PUBLIC, VIS_SELF, VIS_TEAM = 0, 1, 2


def field_visibility(lowered: Lowered) -> dict[str, int]:
    """Per-field observation visibility, derived from the DSL itself.

    Fields whose declaration description says private/hidden/secret are
    SELF-only. The team field (and role, which determines it) is TEAM —
    visible to same-team viewers — when an audience group selects by team
    (the reference's werewolves-coordinate-secretly contract,
    games/werewolf-(mafia).yaml:138-143). Everything else is PUBLIC.
    """
    decl = lowered.game.spec.declaration
    team_grouped = any(
        _re.search(r"\bteam\b", g.selection_criteria) for g in decl.audience_groups
    )
    out: dict[str, int] = {}
    for f in decl.fields:
        if _PRIVATE_RE.search(f.description) or _PRIVATE_RE.search(f.name):
            out[f.name] = VIS_SELF
        else:
            out[f.name] = VIS_PUBLIC
    # action bookkeeping is the actors' own information exactly when the
    # phase SELECTS its actors by hidden fields (a public night_action
    # flag would leak who holds a night role). A phase whose target
    # predicate reads only PUBLIC fields (day votes: can_vote/is_alive)
    # keeps its writes public — the game's central public signal. (The
    # old isinstance(pred, Const) carve-out was dead: every catalog
    # action phase has a non-trivial predicate, so even day-vote
    # bookkeeping was masked VIS_SELF.)
    from game_engine_tpu.gamespec.expr import collect_atoms

    base_vis = dict(out)
    if team_grouped:
        for name in ("team", "role"):
            if name in base_vis:
                base_vis[name] = VIS_TEAM

    for cp in lowered.game.phases:
        try:
            atoms = list(collect_atoms(cp.target_pred))
        except Exception:  # noqa: BLE001 — unknown pred shape: be private
            atoms = None
        if atoms is not None and all(
                base_vis.get(a.field, VIS_PUBLIC) == VIS_PUBLIC
                for a in atoms):
            continue  # selected by public info only: writes stay public
        rp = cp.program.record
        for name in rp.set_bool_true + rp.set_bool_false:
            out[name] = VIS_SELF
        for name in (rp.write_choice_num, rp.mark_odict):
            if name:
                out[name] = VIS_SELF
        if rp.write_pdict:
            out[rp.write_pdict[0]] = VIS_SELF
    if team_grouped:
        for name in ("team", "role"):
            if name in out:
                out[name] = VIS_TEAM
    return out


_REVEAL_RE = _re.compile(r"reveal", _re.IGNORECASE)


def _phase_public_acting(lowered: Lowered) -> np.ndarray:
    """(NP,) bool — whether WHO-has-acted in each phase is public info
    (the phase selects actors by public fields only). In a night phase a
    public acted flag leaks who holds a night role the moment the phase
    sits partially complete (bots acted, human hasn't)."""
    from game_engine_tpu.gamespec.expr import collect_atoms

    vis = field_visibility(lowered)
    out = np.zeros((lowered.NP,), dtype=bool)
    for cp in lowered.game.phases:
        try:
            atoms = list(collect_atoms(cp.target_pred))
        except Exception:  # noqa: BLE001
            atoms = None
        out[cp.index] = atoms is not None and all(
            vis.get(a.field, VIS_PUBLIC) == VIS_PUBLIC for a in atoms)
    return out


def minority_team_code(lowered: Lowered):
    """String code of the coordinating (minority/'evil') team, or None."""
    for m in lowered.game_overs:
        if m.mode == "team" and m.team_codes:
            return int(m.team_codes[0])
    return None


def _obs_fields(lowered: Lowered):
    """Declared fields that enter the observation. 'name' is cosmetic
    (display text, never read by any rule) — its one-hot would waste ~20%
    of the feature dim on noise."""
    return [f for f in lowered.game.spec.declaration.fields if f.name != "name"]


def _per_player_dim(lowered: Lowered) -> int:
    lay = lowered.game.layout
    d = 2  # acted + alive
    for f in _obs_fields(lowered):
        s = lay.slot(f.name)
        if s.bank in ("bool", "num"):
            d += 1
        elif s.bank == "str":
            d += max(2, len(s.vocab))
    return d


def obs_dim(lowered: Lowered) -> int:
    P = lowered.P
    # full-room view + viewer one-hot + phase + count
    return P * _per_player_dim(lowered) + P + lowered.NP + 1


def observe(lowered: Lowered, state: GameState, masked: bool = True) -> jax.Array:
    """(B, P, F) float32 — each viewer sees the room through the game's
    information rules.

    masked=True (default): hidden-role observation — SELF fields are zeroed
    on other players' rows, TEAM fields visible only when the viewer shares
    the target's team (wolves see each other; villagers see nothing).
    masked=False: the full-information centralized view (debug/ablation).
    """
    B, P = state.present.shape
    lay = lowered.game.layout
    vis = field_visibility(lowered)
    team_slot = lay.get("team")
    if masked and team_slot is not None and team_slot.bank == "str":
        team = state.strs[..., team_slot.index]
        same_team = (team[:, :, None] == team[:, None, :]) & (team[:, :, None] != 0)
        # only the coordinating (minority) team sees its teammates — the
        # reference reveals wolves to wolves via the werewolves audience
        # group, but villagers never learn who else is a villager
        code = minority_team_code(lowered)
        if code is not None:
            same_team = same_team & (team[:, :, None] == code)
    else:
        same_team = jnp.zeros((B, P, P), bool)
    is_self = jnp.broadcast_to(jnp.eye(P, dtype=bool)[None], (B, P, P))

    # P15: a seat whose reveal flag is set (death announcements) has its
    # role/team PUBLICLY revealed — static masking alone would hide "the
    # lynched player was a Villager" forever, a core public signal
    revealed = None
    if masked:
        for f in lowered.game.spec.declaration.fields:
            if _REVEAL_RE.search(f.name):
                rs = lay.get(f.name)
                if rs is not None and rs.bank == "bool":
                    revealed = state.bools[..., rs.index]  # (B, P) targets
                    break

    def mask_for(field: str) -> jax.Array:
        """(B, viewer P, target P) — may the viewer see this field?"""
        if not masked:
            return jnp.ones((B, P, P), bool)
        v = vis.get(field, VIS_PUBLIC)
        if v == VIS_SELF:
            m = is_self
        elif v == VIS_TEAM:
            m = is_self | same_team
        else:
            return jnp.ones((B, P, P), bool)
        if revealed is not None and field in ("role", "team"):
            m = m | revealed[:, None, :]
        return m

    # per-field feature blocks, expanded to (B, viewer, target, width) —
    # computed in bfloat16: the net consumes bf16 and these (B,P,P,F0)
    # tensors dominate the unroll's HBM traffic at 16k+ rooms
    dt = jnp.bfloat16
    blocks = []
    for f in _obs_fields(lowered):
        s = lay.slot(f.name)
        if s.bank == "bool":
            feat = state.bools[..., s.index, None].astype(dt)
        elif s.bank == "num":
            feat = state.nums[..., s.index, None].astype(dt) / dt(P)
        elif s.bank == "str":
            width = max(2, len(s.vocab))
            feat = jax.nn.one_hot(state.strs[..., s.index], width, dtype=dt)
        else:
            continue  # dict banks enter via their recorded scalar effects
        m = mask_for(f.name)[..., None]  # (B, V, T, 1)
        blocks.append(jnp.where(m, feat[:, None, :, :], dt(0)))
    alive = _alive(lowered, state)
    acted = state.acted
    if masked:
        # who-acted is public only in publicly-targeted phases; elsewhere
        # each viewer sees their own acted bit (partial night completion
        # used to broadcast exactly which seats hold night roles)
        from game_engine_tpu.core.step import _table_select

        pub = _table_select(
            _phase_public_acting(lowered).astype(np.int32), state.phase) != 0
        acted_vt = acted[:, None, :] & (pub[:, None, None] | is_self)
        blocks.append(acted_vt.astype(dt)[..., None])
    else:
        blocks.append(jnp.broadcast_to(
            acted.astype(dt)[:, None, :, None], (B, P, P, 1)))
    blocks.append(jnp.broadcast_to(alive.astype(dt)[:, None, :, None], (B, P, P, 1)))
    room = jnp.concatenate(blocks, axis=-1).reshape(B, P, -1)  # (B, V, T*F0)

    viewer = jnp.broadcast_to(jnp.eye(P, dtype=dt)[None], (B, P, P))
    phase_oh = jnp.broadcast_to(
        jax.nn.one_hot(state.phase, lowered.NP, dtype=dt)[:, None, :],
        (B, P, lowered.NP),
    )
    n_alive = jnp.broadcast_to(
        (jnp.sum(alive, axis=1).astype(dt) / dt(P))[:, None, None], (B, P, 1)
    )
    return jnp.concatenate([room, viewer, phase_oh, n_alive], axis=-1)


def action_space(lowered: Lowered) -> int:
    """Unified discrete choice space: 1..A (0 reserved for no-op)."""
    return max(lowered.P, int(lowered.choice_max.max()) if lowered.choice_max.size else 0)


@dataclasses.dataclass(frozen=True)
class NetConfig:
    hidden: int = 256
    layers: int = 2
    # 'mlp': flat trunk over the whole room observation;
    # 'deepsets': a shared per-seat encoder phi pooled over targets, with a
    # pointer head scoring each seat — the trunk width stays constant as
    # rooms grow (the MLP's input scales as P * per-player features), and
    # target actions are scored by the target's own embedding.
    # 'attn': deepsets + self-attention over the seat axis before pooling —
    # seats exchange information (who is voting whom, who is protected)
    # instead of pooling independently; all param shapes stay room-size
    # independent. Default is ONE head: with P<=12 seats, splitting the
    # embedding into tiny per-head dims (hd=8 at 4 heads) gives the matrix
    # units slivers; single-head keeps the full width in one product.
    arch: str = "mlp"
    attn_heads: int = 1


def _bf16_dot(x, w):
    return jnp.dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def init_params(key, in_dim: int, n_actions: int, cfg: NetConfig,
                lowered: Lowered | None = None) -> dict[str, Any]:
    """Plain-pytree params; hidden layers sized for tensor-parallel sharding
    over a 'model' mesh axis (see parallel/mesh.py). The deepsets arch needs
    ``lowered`` for the static seat/feature dims."""
    params = {}
    keys = jax.random.split(key, cfg.layers + 6)

    def lin(k, i, o):
        return jax.random.normal(k, (i, o), jnp.float32) / np.sqrt(i)

    if cfg.arch in ("deepsets", "attn"):
        assert lowered is not None, "deepsets/attn init needs the lowered game"
        F0, NP = _per_player_dim(lowered), lowered.NP
        hp = max(32, cfg.hidden // 2)
        params["w_phi0"] = lin(keys[-3], F0, hp)
        params["b_phi0"] = jnp.zeros((hp,), jnp.float32)
        params["w_phi1"] = lin(keys[-4], hp, hp)
        params["b_phi1"] = jnp.zeros((hp,), jnp.float32)
        params["w_ptr"] = lin(keys[-5], cfg.hidden, hp)
        if cfg.arch == "attn":
            if hp % cfg.attn_heads != 0:
                raise ValueError(
                    f"attn arch needs max(32, hidden//2)={hp} divisible by "
                    f"attn_heads={cfg.attn_heads}; pick a hidden size whose "
                    "half is a multiple of the head count")
            ak = jax.random.split(keys[-6], 2)
            params["w_qkv"] = lin(ak[0], hp, 3 * hp)
            params["w_ao"] = lin(ak[1], hp, hp)
            params["ln_s"] = jnp.ones((hp,), jnp.float32)
            params["ln_b"] = jnp.zeros((hp,), jnp.float32)
        # EVERY param shape is ROOM-SIZE INDEPENDENT: the trunk consumes
        # pooled + self embedding + phase one-hot + alive fraction (the
        # viewer one-hot is dropped — self_phi already identifies the
        # viewer's seat), target-action logits come from the pointer head
        # (per-seat embeddings), and the option head is sized by the game's
        # option range only. Params trained at one max_players therefore
        # load unchanged for a bigger-room compile.
        trunk_in = 2 * hp + NP + 1
        dims = [trunk_in] + [cfg.hidden] * cfg.layers
        n_actions = max(1, int(lowered.choice_max.max()))  # option head only
    else:
        dims = [in_dim] + [cfg.hidden] * cfg.layers
    for i in range(cfg.layers):
        params[f"w{i}"] = lin(keys[i], dims[i], dims[i + 1])
        params[f"b{i}"] = jnp.zeros((dims[i + 1],), jnp.float32)
    params["w_pi"] = lin(keys[-2], cfg.hidden, n_actions)
    params["b_pi"] = jnp.zeros((n_actions,), jnp.float32)
    params["w_v"] = lin(keys[-1], cfg.hidden, 1)
    params["b_v"] = jnp.zeros((1,), jnp.float32)
    return params


def _trunk_and_heads(params, x, n_targets: int, ptr=None):
    i = 0
    while f"w{i}" in params:
        x = jax.nn.gelu(_bf16_dot(x, params[f"w{i}"]) + params[f"b{i}"])
        x = x.astype(jnp.bfloat16)
        i += 1
    logits = _bf16_dot(x, params["w_pi"]) + params["b_pi"]
    if ptr is not None:
        # pointer scores for the first P (target) actions come from the
        # target seats' own embeddings; the option head (whose width is
        # room-size independent) overlays the low action indices. The
        # combined width is the game's unified action space max(P, options).
        g = _bf16_dot(x, params["w_ptr"]).astype(jnp.bfloat16)
        scores = jnp.sum(ptr * g[..., None, :], axis=-1,
                         dtype=jnp.float32)  # (..., P)
        a = max(n_targets, logits.shape[-1])

        def pad_to(t, width):
            extra = width - t.shape[-1]
            if extra <= 0:
                return t
            return jnp.concatenate(
                [t, jnp.zeros(t.shape[:-1] + (extra,), t.dtype)], -1)

        logits = pad_to(logits.astype(jnp.float32), a) + pad_to(scores, a)
    value = (_bf16_dot(x, params["w_v"]) + params["b_v"])[..., 0]
    return logits, value


def apply_net(params: dict[str, Any], obs: jax.Array, cfg: NetConfig,
              lowered: Lowered | None = None):
    """obs (..., F) -> (logits (..., A), value (...,)). bfloat16 matmuls
    with float32 accumulation (preferred_element_type)."""
    if cfg.arch not in ("deepsets", "attn"):
        return _trunk_and_heads(params, obs.astype(jnp.bfloat16),
                                obs.shape[-1])
    assert lowered is not None, "deepsets/attn apply needs the lowered game"
    P, F0, NP = lowered.P, _per_player_dim(lowered), lowered.NP
    x = obs.astype(jnp.bfloat16)
    lead = x.shape[:-1]
    room = x[..., : P * F0].reshape(lead + (P, F0))  # (..., target, F0)
    viewer_oh = x[..., P * F0: P * F0 + P]
    globals_ = x[..., P * F0 + P:]  # phase one-hot + n_alive (P-independent)
    phi = jax.nn.gelu(_bf16_dot(room, params["w_phi0"]) + params["b_phi0"])
    phi = jax.nn.gelu(_bf16_dot(phi.astype(jnp.bfloat16), params["w_phi1"])
                      + params["b_phi1"]).astype(jnp.bfloat16)  # (..., P, hp)
    if cfg.arch == "attn":
        # one residual multi-head self-attention block over the seat axis:
        # seats attend to each other before pooling, so the embedding a
        # pointer scores already reflects room-wide relations. P is tiny
        # (<=12) so the (P, P) attention is small next to the dots.
        hp = phi.shape[-1]
        nh = cfg.attn_heads
        hd = hp // nh
        h = phi.astype(jnp.float32)
        m = jnp.mean(h, axis=-1, keepdims=True)
        v = jnp.mean(jnp.square(h - m), axis=-1, keepdims=True)
        h = ((h - m) * jax.lax.rsqrt(v + 1e-5) * params["ln_s"]
             + params["ln_b"]).astype(jnp.bfloat16)
        qkv = _bf16_dot(h, params["w_qkv"]).reshape(lead + (P, 3, nh, hd))
        q, k, w = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        att = jnp.einsum("...qhd,...khd->...hqk", q, k) / np.sqrt(hd)
        att = jax.nn.softmax(att, axis=-1).astype(jnp.bfloat16)
        o = jnp.einsum("...hqk,...khd->...qhd", att, w).reshape(lead + (P, hp))
        phi = (phi + _bf16_dot(o, params["w_ao"])).astype(jnp.bfloat16)
    pooled = jnp.mean(phi.astype(jnp.float32), axis=-2)
    self_phi = jnp.sum(phi * viewer_oh[..., None].astype(jnp.bfloat16),
                       axis=-2, dtype=jnp.float32)
    trunk_in = jnp.concatenate(
        [pooled, self_phi, globals_.astype(jnp.float32)], axis=-1
    ).astype(jnp.bfloat16)
    return _trunk_and_heads(params, trunk_in, P, ptr=phi)


def legal_action_mask(lowered: Lowered, state: GameState) -> jax.Array:
    """(B, P, A) bool — which choices the engine would accept (P2), so the
    policy never wastes probability mass on rejected actions."""
    from game_engine_tpu.core.step import _table_select
    from game_engine_tpu.gamespec.mechanics import ChoiceKind

    B, P = state.present.shape
    A = action_space(lowered)
    kind = _table_select(lowered.choice_kind, state.phase)[:, None, None]  # (B,1,1)
    kmax = _table_select(lowered.choice_max, state.phase)[:, None, None]
    n_present = jnp.sum(state.present, axis=1, dtype=jnp.int32)[:, None, None]
    cidx = jnp.arange(1, A + 1, dtype=jnp.int32)[None, None, :]

    alive = _alive(lowered, state)
    alive_pad = jnp.pad(alive, ((0, 0), (0, max(0, A - P))))[:, None, :]  # (B,1,A)
    target_ok = (cidx <= P) & alive_pad
    hi = jnp.where(kmax > 0, kmax, n_present)
    option_ok = cidx <= hi
    submit_ok = cidx == 1
    mask = jnp.where(
        kind == ChoiceKind.TARGET.value,
        target_ok,
        jnp.where(kind == ChoiceKind.OPTION.value, option_ok, submit_ok),
    )
    return jnp.broadcast_to(mask, (B, P, A))


def sample_actions(lowered: Lowered, params, state: GameState, key, cfg: NetConfig,
                   obs=None):
    """Sample per-player choices.

    Returns (actions (B,P) 1-based, logp (B,P), value (B,P),
    legal-action mask (B,P,A)). Pass a precomputed ``obs`` to avoid
    rebuilding the (expensive) masked observation tensor."""
    if obs is None:
        obs = observe(lowered, state)
    logits, value = apply_net(params, obs, cfg, lowered)
    mask = legal_action_mask(lowered, state)
    neg = jnp.float32(-1e9)
    logits = jnp.where(mask, logits, neg)
    a = jax.random.categorical(key, logits, axis=-1)  # (B, P) in [0, A)
    # one-hot contraction instead of take_along_axis (the no-gather rule;
    # see ppo_loss)
    logp_all = jax.nn.log_softmax(logits, axis=-1)
    aoh = jax.nn.one_hot(a, logits.shape[-1], dtype=logp_all.dtype)
    logp = jnp.sum(logp_all * aoh, axis=-1)
    return (a + 1).astype(jnp.int32), logp, value, mask
