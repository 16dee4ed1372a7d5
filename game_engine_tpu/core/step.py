"""The jittable engine step: one fused XLA program per game turn.

Replaces the reference's 4-LLM-call pipeline per turn — BotBehavior ingest,
PhaseNode transition, RefereeNode resolution (reference:
agent/game_agent_v2.py:468-1241) — with branch-free data flow:

  atoms -> predicate values -> action acceptance -> record writes ->
  completion gate -> first-match branch select -> transition ->
  masked on-enter mechanics

Everything is elementwise ops and tiny reductions over the player axis,
batched over rooms on axis 0. No lax.switch / lax.cond: per-phase structure
is folded at trace time (compute-all, select-by-phase), which XLA fuses into
a handful of elementwise kernels. Semantics are pinned P1..P15
(gamespec/mechanics.py) and must stay bit-identical to oracle/interp.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from game_engine_tpu.core.state import GameState
from game_engine_tpu.gamespec import effects as FX
from game_engine_tpu.gamespec import tables as T
from game_engine_tpu.gamespec.mechanics import ChoiceKind
from game_engine_tpu.gamespec.tables import (
    AB_BOOL,
    AB_CONST,
    AB_NUM,
    Lowered,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_NE,
)

_U32 = jnp.uint32

# Effect-IR write-combining. When True, _EffectOps
# accumulates each statement's bank write into a per-slot effective column
# and flushes ONE update per touched slot at block end, instead of a
# dynamic-update-slice per statement — shorter live ranges for the banks
# and one select chain per slot for XLA to fuse. Bit-identical by
# construction (the pending column IS the statement-ordered select chain);
# pinned by the golden fixture.
DEFERRED_WRITES = True
# With deferred writes on, emit flush updates in ascending slot order
# instead of first-touch order — a pure HLO-emission-order lever for the
# compiler's scheduler (statement reordering reduced to its only observable
# residue once writes are combined). Bit-identical by construction: the
# per-slot columns are unchanged, only the order the independent
# .at[slot].set updates are emitted in changes. Off: no gain measured yet.
SORTED_FLUSH = False
# Reorder each block's statements so all writes to one slot (one union-find
# component of write targets) are emitted contiguously, preserving declared
# order within a component — the full statement-reordering lever.
# Bit-identical by construction: block reads come from the snapshot, so
# statements only interfere through the slots they write
# (core/effects_exec.grouped_stmt_order; pinned by test_effects_grouping).
GROUP_STMTS = False


def splitmix32_jax(x):
    """uint32 splitmix — must match gamespec.mechanics.splitmix32 exactly."""
    x = (x + _U32(0x9E3779B9)).astype(_U32)
    z = x
    z = (z ^ (z >> 16)) * _U32(0x85EBCA6B)
    z = (z ^ (z >> 13)) * _U32(0xC2B2AE35)
    return z ^ (z >> 16)


class PredEval:
    """Lazily evaluates lowered predicates over the current state banks."""

    def __init__(self, lowered: Lowered, state: GameState):
        self.lw = lowered
        self.state = state
        self._atom_cache: dict[int, jax.Array] = {}
        self._pred_cache: dict[int, jax.Array] = {}
        B, P = state.present.shape
        self._shape = (B, P)

    def atom(self, idx: int) -> jax.Array:
        if idx in self._atom_cache:
            return self._atom_cache[idx]
        a = self.lw.atoms[idx]
        if a.bank == AB_CONST:
            v = jnp.full(self._shape, bool(a.const))
        else:
            if a.bank == AB_BOOL:
                x = self.state.bools[..., a.slot].astype(jnp.int32)
            elif a.bank == AB_NUM:
                x = self.state.nums[..., a.slot]
            else:
                x = self.state.strs[..., a.slot]
            c = jnp.int32(a.value)
            if a.op == OP_EQ:
                v = x == c
            elif a.op == OP_NE:
                v = x != c
            elif a.op == OP_GE:
                v = x >= c
            elif a.op == OP_LE:
                v = x <= c
            elif a.op == OP_GT:
                v = x > c
            else:
                v = x < c
        self._atom_cache[idx] = v
        return v

    def pred(self, idx: int) -> jax.Array:
        """(B, P) bool — does each player satisfy predicate idx."""
        if idx in self._pred_cache:
            return self._pred_cache[idx]
        terms = self.lw.preds[idx]
        if not terms:
            v = jnp.zeros(self._shape, bool)
        else:
            tvals = []
            for term in terms:
                if not term:
                    tvals.append(jnp.ones(self._shape, bool))
                else:
                    tv = self.atom(term[0])
                    for ai in term[1:]:
                        tv = tv & self.atom(ai)
                    tvals.append(tv)
            v = tvals[0]
            for tv in tvals[1:]:
                v = v | tv
        self._pred_cache[idx] = v
        return v

    def count(self, idx: int) -> jax.Array:
        """(B,) int32 — present players satisfying predicate idx."""
        return jnp.sum(self.pred(idx) & self.state.present, axis=1, dtype=jnp.int32)


def _alive(lowered: Lowered, state: GameState) -> jax.Array:
    """(B, P) — is_alive if declared, else present."""
    if lowered.alive_bool >= 0:
        return state.bools[..., lowered.alive_bool] & state.present
    return state.present


# All indexing along the tiny player axis is done as one-hot contractions
# instead of per-element gathers: P is static and small, and elementwise +
# reduce fuses with its neighbours where a dynamic-index gather may not.
# Whether a gather is cheaper on the GPU at P <= 12 is an open measurement
# (ROADMAP); both forms are bit-identical.


def _player_onehot(idx0: jax.Array, P: int) -> jax.Array:
    """(..., P) bool one-hot of a 0-based player index; out-of-range -> all-false."""
    return idx0[..., None] == jnp.arange(P, dtype=jnp.int32)


def _gather_by_choice(vals: jax.Array, choice: jax.Array) -> jax.Array:
    """vals (B, P), choice (B, P) 1-based -> out[b, p] = vals[b, choice[b,p]-1]."""
    oh = _player_onehot(choice - 1, vals.shape[1])  # (B, P, P)
    if vals.dtype == jnp.bool_:
        return jnp.any(oh & vals[:, None, :], axis=-1)
    return jnp.sum(jnp.where(oh, vals[:, None, :], 0), axis=-1)


def _select_slot(bank: jax.Array, slot: jax.Array) -> jax.Array:
    """bank (B, P, S), slot (B,) static-small S -> (B, P) unrolled select."""
    S = bank.shape[-1]
    out = jnp.zeros(bank.shape[:-1], bank.dtype)
    for s in range(S):
        out = jnp.where((slot == s)[:, None], bank[..., s], out)
    return out


def _table_select(table: np.ndarray, idx: jax.Array) -> jax.Array:
    """Static-table row lookup by per-room index, as unrolled selects.

    Avoids a dynamic gather from a tiny table; grouping rows by distinct
    value keeps this to a handful of selects.
    table: (N,) scalars or (N, K) rows; idx: (B,) -> (B,) or (B, K)."""
    table = np.asarray(table)
    if table.ndim == 1:
        out = jnp.full(idx.shape, table[0].item(), dtype=jnp.asarray(table).dtype)
        for v in np.unique(table)[::-1]:
            members = np.nonzero(table == v)[0]
            hit = jnp.zeros(idx.shape, bool)
            for i in members:
                hit = hit | (idx == int(i))
            out = jnp.where(hit, v.item(), out)
        return out
    # row table: dedupe identical rows
    uniq, inv = np.unique(table, axis=0, return_inverse=True)
    out = jnp.broadcast_to(jnp.asarray(uniq[0]), idx.shape + (table.shape[1],))
    for u in range(len(uniq)):
        members = np.nonzero(inv == u)[0]
        hit = jnp.zeros(idx.shape, bool)
        for i in members:
            hit = hit | (idx == int(i))
        out = jnp.where(hit[..., None], jnp.asarray(uniq[u]), out)
    return out


def _phase_mask_lookup(mask_np: np.ndarray, idx: jax.Array) -> jax.Array:
    """Membership of a (dense index, -1 allowed) array in a static phase set.

    Unrolled equality ORs over the (few) set members — avoids a dynamic
    gather entirely."""
    members = np.nonzero(mask_np)[0] - 1  # back to dense indices
    out = jnp.zeros(idx.shape, bool)
    for m in members:
        out = out | (idx == int(m))
    return out


# ---------------------------------------------------------------------------
# On-enter mechanics (P6-P11), each applied masked by `active` (B,)
# ---------------------------------------------------------------------------


def _apply_death(lw: Lowered, bools: jax.Array, death: jax.Array,
                 reveal_slots) -> jax.Array:
    """death: (B, P) mask — clear is_alive and set P15 reveal flags."""
    if lw.alive_bool >= 0:
        bools = bools.at[..., lw.alive_bool].set(bools[..., lw.alive_bool] & ~death)
    for slot in reveal_slots:
        bools = bools.at[..., slot].set(bools[..., slot] | death)
    return bools


class _EffectOps:
    """Ops adapter binding the generic effect interpreter (P20,
    core/effects_exec.py) to the (rooms, players) batch layout.

    Dtype discipline: truthy intermediates stay jnp.bool_ (comparisons,
    logic, masks) and numerics int32, converting only at arithmetic /
    write boundaries — XLA fuses the bool predicate chains, where the
    shared evaluator's int32-select defaults cost one select per node."""

    def __init__(self, lw: Lowered, st: GameState):
        self.lw = lw
        self.st = st
        B, P = st.present.shape
        self.B, self.P = B, P
        self._seat = jnp.broadcast_to(
            jnp.arange(1, P + 1, dtype=jnp.int32)[None, :], (B, P))

    def snapshot(self):
        st = self.st
        self.sb, self.sn, self.ss = st.bools, st.nums, st.strs
        self.pe = PredEval(self.lw, st)
        # deferred write-combining: slot -> effective (B, P) column, seeded
        # from the snapshot on first touch; flush() lands them all at once
        self._pend = {"b": {}, "n": {}, "s": {}}

    @property
    def group_stmts(self):
        return GROUP_STMTS

    @property
    def alive_slot(self):
        return self.lw.alive_bool

    # -- dtype helpers ------------------------------------------------------

    @staticmethod
    def _b(x):
        """truthy -> bool array (no-op when already bool)."""
        x = jnp.asarray(x)
        return x if x.dtype == jnp.bool_ else x != 0

    @staticmethod
    def _i(x):
        """-> int32 array (bools become 0/1)."""
        x = jnp.asarray(x)
        return x.astype(jnp.int32) if x.dtype == jnp.bool_ else x

    def _bp(self, x):
        """broadcast to (B, P), preserving bool/int32 dtype."""
        return jnp.broadcast_to(jnp.asarray(x), (self.B, self.P))

    # -- leaf reads ---------------------------------------------------------

    def field(self, bank, slot):
        if bank == FX.FXB_BOOL:
            return self.sb[..., slot]  # bool
        if bank == FX.FXB_NUM:
            return self.sn[..., slot]
        return self.ss[..., slot].astype(jnp.int32)

    def seat(self):
        return self._seat

    def nplayers(self):
        return jnp.sum(self.st.present, axis=1, dtype=jnp.int32)[:, None]

    def choice(self):
        return self.st.choice

    def chosein(self, lo, hi):
        bits = (int(lo) & 0xFFFFFFFF) | ((int(hi) & 0xFFFFFFFF) << 32)
        out = jnp.zeros((self.B, self.P), bool)
        for i in range(64):
            if (bits >> i) & 1:
                out = out | (self.st.choice_phase == i - 1)
        return out

    def alive(self):
        if self.lw.alive_bool >= 0:
            return self.sb[..., self.lw.alive_bool] & self.st.present
        return self.st.present

    def present_i(self):
        return self.st.present

    def pred(self, idx):
        return self.pe.pred(idx)

    # -- scalar ops (bool-native overrides of the evaluator defaults) -------

    def bin(self, op, a, b):
        a, b = self._i(a), self._i(b)
        if op == FX.BIN_ADD:
            return a + b
        if op == FX.BIN_SUB:
            return a - b
        if op == FX.BIN_MUL:
            return a * b
        if op == FX.BIN_MIN:
            return jnp.minimum(a, b)
        return jnp.maximum(a, b)

    def cmp(self, op, a, b):
        # op is static — trace only the one comparison
        a, b = self._i(a), self._i(b)
        return (a == b if op == 0 else a != b if op == 1
                else a >= b if op == 2 else a <= b if op == 3
                else a > b if op == 4 else a < b)

    def not_(self, a):
        return ~self._b(a)

    def and_(self, a, b):
        return self._b(a) & self._b(b)

    def or_(self, a, b):
        return self._b(a) | self._b(b)

    def where_(self, c, a, b):
        a, b = jnp.asarray(a), jnp.asarray(b)
        if a.dtype != b.dtype:
            a, b = self._i(a), self._i(b)
        return jnp.where(self._b(c), a, b)

    # -- cross-player aggregations -----------------------------------------

    def at(self, val, idx):
        idx = self._bp(self._i(idx))
        ok = _gather_by_choice(self.st.present, idx)  # absent/invalid -> False
        val = jnp.asarray(val)
        got = _gather_by_choice(self._bp(val), idx)
        if val.dtype == jnp.bool_:
            return got & ok
        return jnp.where(ok, got, 0)

    def incoming(self, val, key, mask):
        m = self._b(self._bp(mask)) & self.st.present  # (B, q)
        oh = self._bp(self._i(key))[:, :, None] == jnp.arange(
            1, self.P + 1, dtype=jnp.int32)[None, None, :]  # (B, q, p)
        val = jnp.asarray(val)
        if val.ndim == 0:  # constant weight: one bool contraction + scale
            n = jnp.sum((oh & m[:, :, None]).astype(jnp.int32), axis=1)
            return n * self._i(val)
        contrib = jnp.where(oh & m[:, :, None],
                            self._bp(self._i(val))[:, :, None], 0)
        return jnp.sum(contrib, axis=1)

    def eqcount(self, key, mask):
        key = self._bp(self._i(key))
        m = self._b(self._bp(mask)) & self.st.present  # (B, q)
        eq = key[:, :, None] == key[:, None, :]  # (B, p, q)
        return jnp.sum((eq & m[:, None, :]).astype(jnp.int32), axis=2)

    def rank(self, key, mask):
        key = self._bp(self._i(key))
        m = self._b(self._bp(mask)) & self.st.present
        eq = key[:, :, None] == key[:, None, :]  # (B, p, q)
        earlier = jnp.arange(self.P)[None, None, :] < jnp.arange(self.P)[None, :, None]
        return jnp.sum((eq & earlier & m[:, None, :]).astype(jnp.int32), axis=2)

    def reduce(self, kind, val, mask):
        m = self._b(self._bp(mask)) & self.st.present
        if kind == FX.RED_COUNT:
            return jnp.sum(m.astype(jnp.int32), axis=1, keepdims=True)
        val = self._bp(self._i(val))
        if kind == FX.RED_SUM:
            return jnp.sum(jnp.where(m, val, 0), axis=1, keepdims=True)
        any_m = jnp.any(m, axis=1, keepdims=True)
        if kind == FX.RED_MAX:
            # exact INT32_MIN sentinel: the oracle/C++ reduce is a true max
            # over masked-in lanes, so even all-INT32_MIN inputs must agree
            best = jnp.max(jnp.where(m, val, jnp.int32(-(2**31))),
                           axis=1, keepdims=True)
        else:
            best = jnp.min(jnp.where(m, val, jnp.int32(2**31 - 1)),
                           axis=1, keepdims=True)
        return jnp.where(any_m, best, 0)

    def argbest(self, kind, key, mask):
        # exact for ALL int32 keys: the win mask is re-ANDed with m so a
        # legitimate key equal to the sentinel can neither fake an empty
        # mask nor let a masked-out seat win (a 2-reduce sentinel-only
        # variant silently narrowed the key domain)
        m = self._b(self._bp(mask)) & self.st.present
        key = self._bp(self._i(key))
        any_m = jnp.any(m, axis=1, keepdims=True)
        if kind == FX.ARG_MAX:
            best = jnp.max(jnp.where(m, key, jnp.int32(-(2**31))),
                           axis=1, keepdims=True)
        else:
            best = jnp.min(jnp.where(m, key, jnp.int32(2**31 - 1)),
                           axis=1, keepdims=True)
        win = m & (key == best)
        w = jnp.min(jnp.where(win, self._seat, self.P + 1), axis=1, keepdims=True)
        return jnp.where(any_m, w, 0)

    def argbest_ranged(self, kind, key, mask, key_range):
        """Packed single-reduce argbest, used when the static range
        analysis (effects_exec.static_ranges) proves the shifted key and
        the seat tie-break pack into one int32: z = (key - lo) * (P + 2)
        ± seat, so ONE masked max/min yields both the winning key and the
        P6 lowest-seat tie-break. Replaces the generic 3-reduce argbest
        on every analyzer plurality (vote/night kill targets: key =
        incoming(1, choice, voter) ∈ [0, P]), which the werewolf IR
        programs run every step. Bit-identical to argbest by
        construction; the golden fixture enforces it."""
        lo, hi = key_range
        P = self.P
        span = hi - lo
        if span < 0 or span > (2 ** 31 - 2 - P) // (P + 2):
            return self.argbest(kind, key, mask)  # could wrap: generic path
        m = self._b(self._bp(mask)) & self.st.present
        k2 = self._bp(self._i(key)) - jnp.int32(lo)
        if kind == FX.ARG_MAX:
            # equal keys: larger (P - seat) = lower seat wins the max
            z = jnp.where(m, k2 * (P + 2) + (P - self._seat), jnp.int32(-1))
            zbest = jnp.max(z, axis=1, keepdims=True)
            win = P - zbest % (P + 2)
            return jnp.where(zbest >= 0, win, 0)
        # ARG_MIN: equal keys: smaller (seat - 1) = lower seat wins the min
        z = jnp.where(m, k2 * (P + 2) + (self._seat - 1),
                      jnp.int32(2 ** 31 - 1))
        zbest = jnp.min(z, axis=1, keepdims=True)
        win = zbest % (P + 2) + 1
        return jnp.where(zbest < 2 ** 31 - 1, win, 0)

    def deal(self, table, salt):
        """ST_DEAL (P10 as IR): per-seat value code from the multiset
        table, RNG-permuted by splitmix32 keys. salt 0 reproduces the
        retired LRoleAssign kernel bit-for-bit; a nonzero salt re-deals.

        Stable rank via O(P^2) comparisons — equals argsort-of-stable-
        argsort but stays elementwise (a sort is paid every step, even
        when masked out); identical math in the C++ sim and the oracle."""
        st = self.st
        B, P = self.B, self.P
        pids = jnp.arange(P, dtype=jnp.uint32)[None, :]
        saltu = self._bp(self._i(salt)).astype(jnp.uint32)
        keys = splitmix32_jax(st.seed[:, None] * _U32(0x100) + pids
                              + saltu * _U32(0x9E3779B9))
        keys = jnp.where(st.present, keys, jnp.uint32(0xFFFFFFFF))
        lt = keys[:, None, :] < keys[:, :, None]  # (B, q, p): key_q < key_p
        tie = (keys[:, None, :] == keys[:, :, None]) & (
            jnp.arange(P)[None, :, None] > jnp.arange(P)[None, None, :]
        )
        rank = jnp.sum((lt | tie).astype(jnp.int32), axis=2)  # (B, P)
        n = jnp.sum(st.present, axis=1, dtype=jnp.int32)
        codes_rows = _table_select(np.asarray(table, dtype=np.int32), n)
        return _gather_by_choice(codes_rows, rank + 1)  # (B, P) codes

    # -- statement writes ---------------------------------------------------

    def stmt_mask(self, wval, active):
        return self._b(self._bp(wval)) & self.st.present & active[:, None]

    def _cur(self, bank, slot):
        """Effective current column: pending write-combined value if this
        slot was already written since the snapshot, else the live bank."""
        pend = self._pend[bank]
        if slot in pend:
            return pend[slot]
        arr = {"b": self.st.bools, "n": self.st.nums, "s": self.st.strs}[bank]
        return arr[..., slot]

    def write_bool(self, slot, val, w):
        cur = self._cur("b", slot)
        new = jnp.where(w, self._bp(self._b(val)), cur)
        if DEFERRED_WRITES:
            self._pend["b"][slot] = new
        else:
            self.st = self.st._replace(
                bools=self.st.bools.at[..., slot].set(new))

    def write_num(self, slot, val, w, add):
        cur = self._cur("n", slot)
        val = self._bp(self._i(val))
        new = jnp.where(w, cur + val if add else val, cur)
        if DEFERRED_WRITES:
            self._pend["n"][slot] = new
        else:
            self.st = self.st._replace(
                nums=self.st.nums.at[..., slot].set(new))

    def write_str(self, slot, val, w):
        cur = self._cur("s", slot)
        new = jnp.where(w, self._bp(self._i(val)).astype(cur.dtype), cur)
        if DEFERRED_WRITES:
            self._pend["s"][slot] = new
        else:
            self.st = self.st._replace(
                strs=self.st.strs.at[..., slot].set(new))

    def flush(self):
        """Land every pending column with one update per touched slot."""
        st = self.st
        pb, pn, ps = self._pend["b"], self._pend["n"], self._pend["s"]
        if SORTED_FLUSH:
            pb, pn, ps = dict(sorted(pb.items())), dict(sorted(pn.items())), \
                dict(sorted(ps.items()))
        bools, nums, strs = st.bools, st.nums, st.strs
        for slot, col in pb.items():
            bools = bools.at[..., slot].set(col)
        for slot, col in pn.items():
            nums = nums.at[..., slot].set(col)
        for slot, col in ps.items():
            strs = strs.at[..., slot].set(col)
        if pb or pn or ps:
            self.st = st._replace(bools=bools, nums=nums, strs=strs)
        self._pend = {"b": {}, "n": {}, "s": {}}

    def write_pdict(self, slot, key, val, w):
        """pdict[seat][key] = val for masked seats; one-hot over the tiny
        key axis (no dynamic scatter — invariant 3). Keys naming absent
        seats write nothing (the pinned 1..n_players domain, matching the
        oracle/C++ bound)."""
        cur = self.st.pdict[:, :, slot, :]  # (B, P, P)
        key = self._bp(self._i(key))  # (B, P) target seat ids, 1-based
        hot = (jnp.arange(1, self.P + 1, dtype=jnp.int32)[None, None, :]
               == key[:, :, None])  # (B, P, P); False everywhere if key=0
        hot = hot & self.st.present[:, None, :]
        val = self._bp(self._i(val)).astype(cur.dtype)
        new = jnp.where(hot & w[:, :, None], val[:, :, None], cur)
        self.st = self.st._replace(
            pdict=self.st.pdict.at[:, :, slot, :].set(new))

    def reset_dict(self, bank, slot, w):
        if bank == FX.FXB_ODICT:
            cur = self.st.odict[..., slot]
            self.st = self.st._replace(
                odict=self.st.odict.at[..., slot].set(
                    jnp.where(w, 0, cur).astype(cur.dtype)))
        else:
            cur = self.st.pdict[:, :, slot, :]
            self.st = self.st._replace(
                pdict=self.st.pdict.at[:, :, slot, :].set(
                    jnp.where(w[..., None], 0, cur).astype(cur.dtype)))

    def kill(self, w, reveal_slots):
        if DEFERRED_WRITES:
            # same statement-ordered semantics as _apply_death, composed
            # into the pending columns: alive &= ~death, reveals |= death
            if self.lw.alive_bool >= 0:
                cur = self._cur("b", self.lw.alive_bool)
                self._pend["b"][self.lw.alive_bool] = cur & ~w
            for slot in reveal_slots:
                cur = self._cur("b", slot)
                self._pend["b"][slot] = cur | w
            return
        self.st = self.st._replace(
            bools=_apply_death(self.lw, self.st.bools, w, reveal_slots))

    def game_over(self, val, w):
        """ST_OVER (P11/P17): done + winner from the lowest-seat lane
        (terminal expressions are room-uniform aggregations; seat 1 is
        always present, so lane 0 carries the room's trigger/value)."""
        trigger = w[:, 0]
        v0 = self._bp(self._i(val))[:, 0]
        self.st = self.st._replace(
            done=self.st.done | trigger,
            winner=jnp.where(trigger, v0, self.st.winner))


def _mech_effects(lw: Lowered, st: GameState, active, m: T.LEffect) -> GameState:
    """P20: one generic interpreter for effect programs — income (P12),
    raids (P13), auctions (P19) and DSL-declared `effects:` all run here."""
    from game_engine_tpu.core.effects_exec import run_effect

    ops = _EffectOps(lw, st)
    run_effect(m, ops, active)
    return ops.st


_MECH_FNS = {
    T.LEffect: _mech_effects,
}


def apply_on_enter(lowered: Lowered, state: GameState, entered: jax.Array, new_phase: jax.Array) -> GameState:
    """Apply every mechanic masked by (entered & phase match).

    Predicates used by mechanics are evaluated on the state at entry time;
    mechanics within one phase are independent by construction (the
    analyzer never emits intra-phase pred dependencies).

    Consecutive single-block effect programs on pairwise-DISTINCT phases
    share one snapshot and one statement pass: a room is in exactly one
    phase, so their active masks are disjoint and sequential execution
    equals merged execution — but sequential snapshots create an
    array-level write->read chain that splits the step into extra fused
    kernels (the programs' banks alias even though their rooms don't).
    Merging removes the false dependency; parity is enforced by the
    golden fixture and the 4-way differential suites.
    """
    from game_engine_tpu.core.effects_exec import run_effects_merged

    mechs = lowered.mechanics
    i = 0
    while i < len(mechs):
        m = mechs[i]
        if isinstance(m, T.LEffect) and len(m.blocks) == 1:
            group = [m]
            phases = {m.phase_index}
            j = i + 1
            while (j < len(mechs) and isinstance(mechs[j], T.LEffect)
                   and len(mechs[j].blocks) == 1
                   and mechs[j].phase_index not in phases):
                group.append(mechs[j])
                phases.add(mechs[j].phase_index)
                j += 1
            ops = _EffectOps(lowered, state)
            run_effects_merged(
                group, ops,
                [entered & (new_phase == g.phase_index) for g in group])
            state = ops.st
            i = j
        else:
            active = entered & (new_phase == m.phase_index)
            state = _MECH_FNS[type(m)](lowered, state, active, m)
            i += 1
    return state


# ---------------------------------------------------------------------------
# Branch conditions (room level)
# ---------------------------------------------------------------------------


def _eval_cond(cond, pe: PredEval, st: GameState) -> jax.Array:
    if isinstance(cond, T.LAlways):
        return jnp.ones((st.present.shape[0],), bool)
    if isinstance(cond, T.LAnd):
        v = _eval_cond(cond.items[0], pe, st)
        for c in cond.items[1:]:
            v = v & _eval_cond(c, pe, st)
        return v
    if isinstance(cond, T.LPrevPhaseIn):
        return _phase_mask_lookup(cond.mask, st.prev_phase)
    if isinstance(cond, T.LAllPresent):
        n = jnp.sum(st.present, axis=1, dtype=jnp.int32)
        return pe.count(cond.pred) == n
    if isinstance(cond, T.LCountCmp):
        lhs = pe.count(cond.left_pred)
        rhs = jnp.int32(cond.right_const) if cond.right_pred < 0 else pe.count(cond.right_pred)
        return {
            "eq": lhs == rhs,
            "ne": lhs != rhs,
            "ge": lhs >= rhs,
            "le": lhs <= rhs,
            "gt": lhs > rhs,
            "lt": lhs < rhs,
        }[cond.op]
    raise TypeError(cond)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def make_step(lowered: Lowered):
    """Build step(state, actions) -> state. actions: (B, P) int32, 0 = none."""
    NP, P = lowered.NP, lowered.P

    def step(state: GameState, actions: jax.Array) -> GameState:
        B = state.present.shape[0]
        pe_pre = PredEval(lowered, state)

        # --- per-room phase gathers (unrolled selects; see _table_select) ---
        ph = state.phase
        is_action = _table_select(lowered.phase_is_action, ph)  # (B,)
        kind = _table_select(lowered.choice_kind, ph)
        kmax = _table_select(lowered.choice_max, ph)
        n_present = jnp.sum(state.present, axis=1, dtype=jnp.int32)

        # target predicate of the current phase, per room (P3): select over
        # the distinct predicates only (no (B, P, NP) stack materialized)
        target = jnp.zeros(state.present.shape, bool)
        by_pred: dict[int, list[int]] = {}
        for i, pi in enumerate(lowered.phase_target_pred):
            by_pred.setdefault(int(pi), []).append(i)
        for pi, phase_idxs in by_pred.items():
            hit = jnp.zeros(ph.shape, bool)
            for i in phase_idxs:
                hit = hit | (ph == i)
            target = jnp.where(hit[:, None], pe_pre.pred(pi), target)
        targeted = target & state.present

        # --- action legality (P1/P2) ---
        c = actions.astype(jnp.int32)
        alive = _alive(lowered, state)
        tgt_alive = _gather_by_choice(alive, c)  # all-false when c out of range
        in_players = (c >= 1) & (c <= P)
        target_ok = in_players & tgt_alive
        hi = jnp.where(kmax > 0, kmax, n_present)[:, None]
        option_ok = (c >= 1) & (c <= hi)
        kind_b = kind[:, None]
        legal = jnp.where(
            kind_b == ChoiceKind.TARGET.value,
            target_ok,
            jnp.where(
                kind_b == ChoiceKind.OPTION.value,
                option_ok,
                kind_b == ChoiceKind.SUBMIT.value,  # SUBMIT: any nonzero
            ),
        )
        accept = (
            is_action[:, None]
            & ~state.done[:, None]
            & targeted
            & ~state.acted
            & (c != 0)
            & legal
        )
        c_norm = jnp.where(kind_b == ChoiceKind.SUBMIT.value, 1, c)

        # --- record writes ---
        rec_t = _table_select(lowered.rec_bool_true, ph)[:, None, :]  # (B,1,NB)
        rec_f = _table_select(lowered.rec_bool_false, ph)[:, None, :]
        am = accept[..., None]
        bools = jnp.where(am & rec_t, True, state.bools)
        bools = jnp.where(am & rec_f, False, bools)

        NN = state.nums.shape[-1]
        num_sel = jax.nn.one_hot(_table_select(lowered.rec_num_slot, ph), NN, dtype=bool)[:, None, :]
        nums = jnp.where(am & num_sel, c_norm[..., None], state.nums)

        # pdict write: field[target] = target's source-string value
        pd_slot = _table_select(lowered.rec_pdict_slot, ph)  # (B,)
        pd_src = _table_select(lowered.rec_pdict_src, ph)
        NPD = state.pdict.shape[2]
        # target's value of the per-room source slot (unrolled selects,
        # not a dynamic player-axis gather: invariant 3)
        src_bank = _select_slot(state.strs, pd_src)  # (B, P)
        src_val = _gather_by_choice(src_bank, c)  # (B, P) target's code
        # translate source string codes into the pdict field's value vocab
        trans_rows = _table_select(lowered.rec_pdict_trans, ph)  # (B, MAXV)
        MAXV = trans_rows.shape[1]
        src_tr = jnp.zeros_like(src_val)
        for v in range(MAXV):
            src_tr = jnp.where(src_val == v, trans_rows[:, v][:, None], src_tr)
        src_val = jnp.where(pd_src[:, None] >= 0, src_tr, 0)
        pd_oh = jax.nn.one_hot(pd_slot, NPD, dtype=bool)[:, None, :, None]  # (B,1,NPD,1)
        tgt_oh = _player_onehot(c - 1, P)[:, :, None, :]
        pd_mask = am[..., None] & pd_oh & tgt_oh & (pd_slot >= 0)[:, None, None, None]
        pdict = jnp.where(pd_mask, src_val.astype(state.pdict.dtype)[..., None, None], state.pdict)

        NOD = state.odict.shape[2]
        od_oh = jax.nn.one_hot(_table_select(lowered.rec_odict_slot, ph), NOD, dtype=bool)[:, None, :]
        odict = jnp.where(am & od_oh, 1, state.odict)

        acted = state.acted | accept
        choice = jnp.where(accept, c_norm, state.choice)
        choice_phase = jnp.where(accept, ph[:, None], state.choice_phase)

        state = state._replace(
            bools=bools, nums=nums, pdict=pdict, odict=odict,
            acted=acted, choice=choice, choice_phase=choice_phase,
        )

        # --- completion (P3) on post-ingest state ---
        pe = PredEval(lowered, state)
        need = targeted & ~acted
        complete = jnp.where(is_action, ~jnp.any(need, axis=1), True) & ~state.done

        # --- next-phase select (P4/P5): static map + branch overrides ---
        next_idx = _table_select(lowered.phase_static_next, ph)
        for i in range(NP):
            if lowered.branches[i]:
                nxt = jnp.full((B,), lowered.branches[i][-1][1], jnp.int32)  # P5 fallback
                for cond, tgt_idx in reversed(lowered.branches[i]):
                    nxt = jnp.where(_eval_cond(cond, pe, state), jnp.int32(tgt_idx), nxt)
                next_idx = jnp.where(ph == i, nxt, next_idx)

        trans = complete & (next_idx != ph)
        prev_phase = jnp.where(trans, ph, state.prev_phase)
        new_phase = jnp.where(trans, next_idx, ph)
        acted = jnp.where(trans[:, None], False, state.acted)
        state = state._replace(
            phase=new_phase, prev_phase=prev_phase, acted=acted, t=state.t + 1
        )

        # --- on-enter mechanics of the newly-entered phase ---
        return apply_on_enter(lowered, state, trans, new_phase)

    return step


def jit_step(lowered: Lowered):
    """jit-compiled step for a lowered game, cached ON the Lowered object
    (an id()-keyed module dict would pin every Lowered + executable for
    process lifetime)."""
    fn = getattr(lowered, "_jit_step", None)
    if fn is None:
        fn = jax.jit(make_step(lowered), donate_argnums=(0,))
        object.__setattr__(lowered, "_jit_step", fn)
    return fn
