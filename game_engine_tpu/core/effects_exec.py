"""Generic effect-IR interpreter for the jitted executors (P20).

The evaluator reaches core/step.py's (rooms, players) batch layout through
a small ops adapter (step._EffectOps) kept next to that layout code.
The expression DAG is walked in pool order (children strictly before
parents), so evaluation is a single pass appending one traced value per
node; XLA dead-code-eliminates anything a statement never consumes.

Every stored value is int32; booleans exist only transiently as comparison
masks feeding `jnp.where` selects with typed int32 scalar branches.

The ops protocol (see step._EffectOps):
  snapshot()                 capture the read-state for the next block
  field(bank, slot) -> i32   FXB_BOOL / FXB_NUM / FXB_STR bank read
  seat() nplayers() choice() chosein(lo, hi) alive() present_i() pred(i)
  at(val, idx)  incoming(val, key, mask)  eqcount(key, mask)  rank(key, mask)
  reduce(kind, val, mask)  argbest(kind, key, mask)
  stmt_mask(where_val, active) -> write mask (AND present AND active)
  write_bool(slot, val, mask)  write_num(slot, val, mask, add)
  kill(mask, reveal_slots)
"""

from __future__ import annotations

import jax.numpy as jnp

from game_engine_tpu.gamespec import effects as FX

def _nz(x):
    """nonzero -> int32 0/1 (typed int32 scalar select branches, created
    at trace time inside the caller)."""
    return jnp.where(x != 0, jnp.int32(1), jnp.int32(0))


_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
_FULL_RANGE = (_I32_MIN, _I32_MAX)


def static_ranges(nodes, P: int) -> list:
    """Abstract int32 value range per node (trace-time Python ints).

    A tiny forward abstract interpretation over the node pool: constants,
    seat/count builtins and aggregation arities give tight bounds; field
    and choice reads are unknown (full int32). Feeds the packed
    single-reduce argbest emission (ops.argbest_ranged): a plurality's
    key (`incoming(1, choice, voter)` ∈ [0, P]) packs with the seat
    tie-break into ONE reduce, replacing the 3-reduce generic argbest in
    the werewolf night/vote programs.
    Overflowing bounds widen to full range, so packing is never tried
    where it could wrap."""
    out: list = []
    for kind, p0, p1, p2 in nodes:
        if kind == FX.NK_CONST:
            r = (p0, p0)
        elif kind == FX.NK_SEAT:
            r = (1, P)
        elif kind == FX.NK_NPLAYERS:
            r = (0, P)
        elif kind in (FX.NK_CHOSEIN, FX.NK_ALIVE, FX.NK_PRESENT,
                      FX.NK_PRED, FX.NK_CMP, FX.NK_NOT, FX.NK_AND,
                      FX.NK_OR):
            r = (0, 1)
        elif kind == FX.NK_BIN:
            (alo, ahi), (blo, bhi) = out[p1], out[p2]
            if p0 == FX.BIN_ADD:
                cand = (alo + blo, ahi + bhi)
            elif p0 == FX.BIN_SUB:
                cand = (alo - bhi, ahi - blo)
            elif p0 == FX.BIN_MUL:
                prods = (alo * blo, alo * bhi, ahi * blo, ahi * bhi)
                cand = (min(prods), max(prods))
            elif p0 == FX.BIN_MIN:
                cand = (min(alo, blo), min(ahi, bhi))
            else:
                cand = (max(alo, blo), max(ahi, bhi))
            r = cand if _I32_MIN <= cand[0] and cand[1] <= _I32_MAX \
                else _FULL_RANGE
        elif kind == FX.NK_WHERE:
            (alo, ahi), (blo, bhi) = out[p1], out[p2]
            r = (min(alo, blo), max(ahi, bhi))
        elif kind == FX.NK_AT:
            lo, hi = out[p0]
            r = (min(lo, 0), max(hi, 0))  # invalid index reads 0
        elif kind == FX.NK_INCOMING:
            lo, hi = out[p0]
            cand = (min(0, P * lo), max(0, P * hi))
            r = cand if _I32_MIN <= cand[0] and cand[1] <= _I32_MAX \
                else _FULL_RANGE
        elif kind in (FX.NK_EQCOUNT, FX.NK_RANK):
            r = (0, P)
        elif kind == FX.NK_REDUCE:
            if p0 == FX.RED_COUNT:
                r = (0, P)
            elif p0 == FX.RED_SUM:
                lo, hi = out[p1]
                cand = (min(0, P * lo), max(0, P * hi))
                r = cand if _I32_MIN <= cand[0] and cand[1] <= _I32_MAX \
                    else _FULL_RANGE
            else:  # masked max/min; empty reduces to 0
                lo, hi = out[p1]
                r = (min(lo, 0), max(hi, 0))
        elif kind == FX.NK_ARGBEST:
            r = (0, P)
        else:  # NK_FIELD, NK_CHOICE: unknown
            r = _FULL_RANGE
        out.append(r)
    return out


def _eval_node(kind: int, p0: int, p1: int, p2: int, vals: list, ops,
               ranges=None):
    if kind == FX.NK_CONST:
        return jnp.int32(p0)
    if kind == FX.NK_FIELD:
        return ops.field(p0, p1)
    if kind == FX.NK_SEAT:
        return ops.seat()
    if kind == FX.NK_NPLAYERS:
        return ops.nplayers()
    if kind == FX.NK_CHOICE:
        return ops.choice()
    if kind == FX.NK_CHOSEIN:
        return ops.chosein(p0, p1)
    if kind == FX.NK_ALIVE:
        return ops.alive()
    if kind == FX.NK_PRESENT:
        return ops.present_i()
    if kind == FX.NK_PRED:
        return ops.pred(p0)
    # scalar ops delegate to the adapter when it defines them (step.py's
    # bool-native versions dodge the int32 select chains that defeat XLA's
    # predicate fusion); the defaults below keep the plain int32
    # select discipline
    if kind == FX.NK_BIN:
        if hasattr(ops, "bin"):
            return ops.bin(p0, vals[p1], vals[p2])
        a, b = vals[p1], vals[p2]
        if p0 == FX.BIN_ADD:
            return a + b
        if p0 == FX.BIN_SUB:
            return a - b
        if p0 == FX.BIN_MUL:
            return a * b
        if p0 == FX.BIN_MIN:
            return jnp.minimum(a, b)
        return jnp.maximum(a, b)
    if kind == FX.NK_CMP:
        if hasattr(ops, "cmp"):
            return ops.cmp(p0, vals[p1], vals[p2])
        a, b = vals[p1], vals[p2]
        # p0 is static — trace only the one comparison (a list literal
        # would trace all six and leave five dead ops for DCE)
        cond = (a == b if p0 == 0 else a != b if p0 == 1
                else a >= b if p0 == 2 else a <= b if p0 == 3
                else a > b if p0 == 4 else a < b)
        return jnp.where(cond, jnp.int32(1), jnp.int32(0))
    if kind == FX.NK_NOT:
        if hasattr(ops, "not_"):
            return ops.not_(vals[p0])
        return jnp.int32(1) - _nz(vals[p0])
    if kind == FX.NK_AND:
        if hasattr(ops, "and_"):
            return ops.and_(vals[p0], vals[p1])
        return _nz(vals[p0]) * _nz(vals[p1])
    if kind == FX.NK_OR:
        if hasattr(ops, "or_"):
            return ops.or_(vals[p0], vals[p1])
        return _nz(_nz(vals[p0]) + _nz(vals[p1]))
    if kind == FX.NK_WHERE:
        if hasattr(ops, "where_"):
            return ops.where_(vals[p0], vals[p1], vals[p2])
        return jnp.where(vals[p0] != 0, vals[p1], vals[p2])
    if kind == FX.NK_AT:
        return ops.at(vals[p0], vals[p1])
    if kind == FX.NK_INCOMING:
        return ops.incoming(vals[p0], vals[p1], vals[p2])
    if kind == FX.NK_EQCOUNT:
        return ops.eqcount(vals[p0], vals[p1])
    if kind == FX.NK_RANK:
        return ops.rank(vals[p0], vals[p1])
    if kind == FX.NK_REDUCE:
        return ops.reduce(p0, vals[p1], vals[p2])
    if kind == FX.NK_ARGBEST:
        if ranges is not None and hasattr(ops, "argbest_ranged"):
            return ops.argbest_ranged(p0, vals[p1], vals[p2], ranges[p1])
        return ops.argbest(p0, vals[p1], vals[p2])
    raise ValueError(f"unknown effect node kind {kind}")


def run_effect(mech, ops, active) -> None:
    """Apply a T.LEffect through the ops adapter, masked by `active`.

    Each block reads the snapshot ops.snapshot() captures at its start;
    writes land in statement order (P20)."""
    flush = getattr(ops, "flush", None)
    for block in mech.blocks:
        ops.snapshot()
        _apply_block(block, mech.reveal_bool_slots, ops, active,
                     mech.deal_tables)
        if flush is not None:
            flush()


def run_effects_merged(mechs, ops, actives) -> None:
    """Apply several SINGLE-BLOCK programs from ONE shared snapshot.

    Only valid when the programs' active masks are disjoint (mechanics on
    pairwise-distinct phases): each room executes at most one of them, so
    the merged pass is bit-identical to sequential run_effect calls while
    letting XLA fuse the programs' reads and writes together instead of
    serializing them through the banks (core/step.py apply_on_enter).

    With ops.group_stmts, statements are reordered by write-target
    component ACROSS the merged programs — the merged pass is where the
    long multi-program select chains live, so per-program grouping alone
    would miss the hot case. Validity is the same snapshot argument as
    grouped_stmt_order, plus disjoint actives (same-slot writes from
    different programs commute room-wise; their declared order is kept
    anyway)."""
    ops.snapshot()
    if getattr(ops, "group_stmts", False):
        entries = []  # (stmt, vals, active, reveal_slots, deal_tables)
        for mech, active in zip(mechs, actives):
            ((nodes, stmts),) = mech.blocks
            ranges = (static_ranges(nodes, ops.P)
                      if getattr(ops, "P", 0) else None)
            vals: list = []
            for kind, p0, p1, p2 in nodes:
                vals.append(_eval_node(kind, p0, p1, p2, vals, ops,
                                       ranges))
            for s in stmts:
                entries.append((s, vals, active, mech.reveal_bool_slots,
                                mech.deal_tables))
        order = grouped_stmt_order(
            [e[0] for e in entries], [e[3] for e in entries],
            getattr(ops, "alive_slot", -1))
        for i in order:
            stmt, vals, active, reveals, deals = entries[i]
            _emit_stmt(stmt, vals, ops, active, reveals, deals)
    else:
        for mech, active in zip(mechs, actives):
            (block,) = mech.blocks
            _apply_block(block, mech.reveal_bool_slots, ops, active,
                         mech.deal_tables)
    flush = getattr(ops, "flush", None)
    if flush is not None:
        flush()


def _stmt_write_keys(stmt, reveal_bool_slots, alive_slot):
    """The (bank-tag, slot) keys a statement row writes."""
    skind, bank, slot, _vnode, _wnode, _knode = stmt
    if skind == FX.ST_KILL:
        keys = [("b", s) for s in reveal_bool_slots]
        if alive_slot >= 0:
            keys.append(("b", alive_slot))
        return keys
    if skind == FX.ST_OVER:
        return [("over", 0)]  # done/winner: all terminal rules one group
    if skind == FX.ST_RESET:
        return [("od" if bank == FX.FXB_ODICT else "pd", slot)]
    if skind == FX.ST_SETD:
        return [("pd", slot)]
    if skind == FX.ST_DEAL or (skind == FX.ST_SET and bank == FX.FXB_STR):
        return [("s", slot)]
    if skind == FX.ST_SET and bank == FX.FXB_BOOL:
        return [("b", slot)]
    return [("n", slot)]  # ST_SET num / ST_ADD


def grouped_stmt_order(stmts, reveal_bool_slots, alive_slot):
    """Permutation of range(len(stmts)) grouping statements whose write
    targets are connected, preserving declared order inside each group.

    Valid because every read inside a block comes from the block's
    snapshot (P20): two statements can only interfere through the slots
    they WRITE, so any interleaving that keeps same-slot (transitively:
    same union-find component) statements in declared order is
    bit-identical. Groups are emitted in first-appearance order. This is
    the statement-reordering lever — traced-op emission order is XLA's
    initial HLO schedule, so packing each slot's select chain contiguously
    shortens the chains' live ranges as the scheduler first sees them.

    ``reveal_bool_slots`` is one tuple shared by every statement (the
    per-block case) or a per-statement list (the merged cross-program
    case, where each kill reveals its OWN program's slots)."""
    per_stmt = bool(reveal_bool_slots) and isinstance(
        reveal_bool_slots, list)
    keys = []
    for i, stmt in enumerate(stmts):
        rs = reveal_bool_slots[i] if per_stmt else reveal_bool_slots
        ks = _stmt_write_keys(stmt, rs, alive_slot)
        keys.append(ks if ks else [("stmt", i)])  # slotless kill: free

    parent: dict = {}

    def find(k):
        while parent[k] != k:
            parent[k] = parent[parent[k]]
            k = parent[k]
        return k

    for ks in keys:
        for k in ks:
            parent.setdefault(k, k)
        for a, b in zip(ks, ks[1:]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
    groups: dict = {}  # root -> stmt indices (insertion order = first touch)
    for i, ks in enumerate(keys):
        groups.setdefault(find(ks[0]), []).append(i)
    return [i for g in groups.values() for i in g]


def _apply_block(block, reveal_bool_slots, ops, active, deal_tables=()) -> None:
    nodes, stmts = block
    if getattr(ops, "group_stmts", False) and len(stmts) > 1:
        order = grouped_stmt_order(stmts, reveal_bool_slots,
                                   getattr(ops, "alive_slot", -1))
        stmts = [stmts[i] for i in order]
    ranges = static_ranges(nodes, ops.P) if getattr(ops, "P", 0) else None
    vals: list = []
    for kind, p0, p1, p2 in nodes:
        vals.append(_eval_node(kind, p0, p1, p2, vals, ops, ranges))
    for stmt in stmts:
        _emit_stmt(stmt, vals, ops, active, reveal_bool_slots, deal_tables)


def _emit_stmt(stmt, vals, ops, active, reveal_bool_slots, deal_tables) -> None:
    skind, bank, slot, vnode, wnode, knode = stmt
    w = ops.stmt_mask(vals[wnode], active)
    if skind == FX.ST_DEAL:
        # P10: vnode indexes the mech's multiset table; knode is the
        # salt expression. Rank/assignment in ops.deal; the write
        # rides the standard string path (write-combining included).
        ops.write_str(slot, ops.deal(deal_tables[vnode], vals[knode]), w)
    elif skind == FX.ST_KILL:
        ops.kill(w, reveal_bool_slots)
    elif skind == FX.ST_RESET:
        # dict banks: clear to empty (bool/num/str resets lower to
        # ST_SET const-default rows instead)
        ops.reset_dict(bank, slot, w)
    elif skind == FX.ST_SETD:
        # player-keyed dict entry write; key 0 / out-of-range = no-op
        ops.write_pdict(slot, vals[knode], vals[vnode], w)
    elif skind == FX.ST_OVER:
        # terminal winner rule (P11/P17): evaluated at the lowest seat
        ops.game_over(vals[vnode], w)
    elif skind == FX.ST_SET and bank == FX.FXB_BOOL:
        ops.write_bool(slot, vals[vnode], w)
    elif skind == FX.ST_SET and bank == FX.FXB_STR:
        ops.write_str(slot, vals[vnode], w)
    elif skind == FX.ST_SET:
        ops.write_num(slot, vals[vnode], w, add=False)
    else:
        ops.write_num(slot, vals[vnode], w, add=True)
