"""Lower a CompiledGame into trace-time structures for the jitted engine.

Design: the compiled game is *static* per program — so rather than runtime
tables with dynamic indexing, most structure lowers to Python-level lists
that core/step.py unrolls at trace time into one straight-line XLA program:

  * every distinct predicate atom (field <op> const) becomes one vectorized
    comparison over a state bank -> an (B, P, A) atom tensor;
  * predicates are DNF formulas over atom indices (folded at trace time);
  * per-phase scalars/masks (kind, choice rules, record writes) are small
    numpy arrays gathered by the per-room phase index;
  * branch conditions and on-enter mechanics stay as typed lowered objects,
    applied masked-by-phase (compute-all-select, no lax.switch fan-out).

This keeps the hot step branch-free and fully fusible: the whole FSM is
elementwise ops + tiny reductions over the player axis over a (rooms,
players) batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from game_engine_tpu.gamespec import conditions as C
from game_engine_tpu.gamespec import effects as FX
from game_engine_tpu.gamespec import mechanics as M
from game_engine_tpu.gamespec.compile import CompiledGame
from game_engine_tpu.gamespec.expr import Pred, to_dnf
from game_engine_tpu.gamespec.layout import BANK_BOOL, BANK_NUM, BANK_STR, StateLayout
from game_engine_tpu.gamespec.schema import CompletionType

# atom ops
OP_EQ, OP_NE, OP_GE, OP_LE, OP_GT, OP_LT = range(6)
_OP_CODE = {"eq": OP_EQ, "ne": OP_NE, "ge": OP_GE, "le": OP_LE, "gt": OP_GT, "lt": OP_LT}

# banks for atoms
AB_BOOL, AB_NUM, AB_STR, AB_CONST = range(4)


@dataclasses.dataclass(frozen=True)
class LoweredAtom:
    bank: int  # AB_*
    slot: int
    op: int  # OP_*
    value: int
    const: Optional[bool] = None  # for AB_CONST (missing field semantics)


# a pred is a list of terms; a term is a list of atom indices (all positive
# after in/notin expansion and NNF); empty term list => const False,
# term == [] => const True.
LoweredPred = list  # list[list[int]]


@dataclasses.dataclass(frozen=True)
class LCountCmp:
    left_pred: int
    op: str
    right_pred: int  # -1 if constant
    right_const: int


@dataclasses.dataclass(frozen=True)
class LAllPresent:
    pred: int


@dataclasses.dataclass(frozen=True)
class LPrevPhaseIn:
    mask: np.ndarray  # (NP+1,) bool indexed by prev_dense+1


@dataclasses.dataclass(frozen=True)
class LAlways:
    pass


@dataclasses.dataclass(frozen=True)
class LAnd:
    items: tuple


LoweredCond = Union[LCountCmp, LAllPresent, LPrevPhaseIn, LAlways, LAnd]


@dataclasses.dataclass(frozen=True)
class LEffect:
    """P20: a lowered effect program (gamespec/effects.py lower_program).

    One generic interpreter per executor runs these — the lowered form of
    P12 income, P13 raids, P19 auctions and any DSL-declared
    `mechanics: [{effects: [...]}]` program."""

    phase_index: int
    # tuple of (nodes, stmts) blocks; see effects.lower_program
    blocks: tuple
    reveal_bool_slots: tuple[int, ...] = ()  # P15 flags applied by `kill`
    # ST_DEAL multiset tables, (P+1, P) int tuples indexed by the stmt
    # row's value slot (P10 as IR — effects.SDeal)
    deal_tables: tuple = ()


@dataclasses.dataclass(frozen=True)
class LGameOver:
    """Terminal winner METADATA (P11/P17) — mode/team/score slots for
    policy observation shaping and reward assignment. Never executed:
    the winner rule itself lowers into Lowered.mechanics as an effect-IR
    program (effects.game_over_program)."""

    phase_index: int
    mode: str
    team_str_slot: int  # -1
    team_codes: tuple[int, ...]  # minority-first
    alive_bool: int  # -1 when no is_alive field
    score_num: int  # -1


LoweredMech = LEffect  # every mechanic family lowers to the P20 IR


@dataclasses.dataclass
class Lowered:
    """Everything core/step.py needs, all static."""

    game: CompiledGame
    P: int
    NP: int
    atoms: list[LoweredAtom]
    preds: list[LoweredPred]  # pred index -> DNF over atom indices
    # per-phase numpy arrays (dense phase index)
    phase_is_action: np.ndarray  # (NP,) bool
    phase_target_pred: np.ndarray  # (NP,) int32 pred index
    phase_terminal: np.ndarray  # (NP,) bool
    phase_static_next: np.ndarray  # (NP,) int32 (self for terminal/branchy)
    phase_has_branches: np.ndarray  # (NP,) bool
    phase_dsl_id: np.ndarray  # (NP,) int32
    choice_kind: np.ndarray  # (NP,) int32 ChoiceKind values
    choice_max: np.ndarray  # (NP,) int32 (0 => n_present)
    rec_bool_true: np.ndarray  # (NP, NB) bool
    rec_bool_false: np.ndarray  # (NP, NB) bool
    rec_num_slot: np.ndarray  # (NP,) int32, -1 none
    rec_pdict_slot: np.ndarray  # (NP,) int32 -1
    rec_pdict_src: np.ndarray  # (NP,) int32 str slot, -1
    rec_pdict_trans: np.ndarray  # (NP, MAXV) int32: src str code -> pdict value code
    rec_odict_slot: np.ndarray  # (NP,) int32 -1
    # branches: per phase list of (LoweredCond, next_index)
    branches: list[list[tuple[LoweredCond, int]]]
    mechanics: list[LoweredMech]  # in application order
    # terminal winner metadata (P11/P17) for observation/reward shaping;
    # the EXECUTABLE winner rule lowers into `mechanics` as an effect-IR
    # program (game_over_program)
    game_overs: tuple
    alive_bool: int  # is_alive slot or -1
    # bank defaults
    bool_defaults: np.ndarray  # (NB,)
    num_defaults: np.ndarray  # (NN,)
    str_defaults: np.ndarray  # (NS,)
    name_str_slot: int  # -1 if no 'name' field (cosmetic, skipped in parity)


class _PredPool:
    def __init__(self, layout: StateLayout):
        self.layout = layout
        self.atoms: list[LoweredAtom] = []
        self.atom_index: dict = {}
        self.preds: list[LoweredPred] = []
        self.pred_index: dict = {}

    def _lower_atom(self, field: str, op: str, value) -> int:
        slot = self.layout.get(field)
        if slot is None:
            # missing field: eq -> const False, ne -> const True, cmp -> False
            const = op == "ne"
            key = ("const", const)
            if key not in self.atom_index:
                self.atom_index[key] = len(self.atoms)
                self.atoms.append(LoweredAtom(bank=AB_CONST, slot=0, op=OP_EQ, value=0, const=const))
            return self.atom_index[key]
        if slot.bank == BANK_BOOL:
            bank, sidx, val = AB_BOOL, slot.index, 1 if value else 0
        elif slot.bank == BANK_NUM:
            bank, sidx, val = AB_NUM, slot.index, int(value)
        elif slot.bank == BANK_STR:
            bank, sidx = AB_STR, slot.index
            sl = str(value).lower()
            val = -1
            for i, v in enumerate(slot.vocab):
                if v.lower() == sl:
                    val = i
                    break
        else:
            # dict/array fields can't be atom operands; treat as missing
            return self._lower_atom("__missing__", op, value)
        key = (bank, sidx, _OP_CODE[op], val)
        if key not in self.atom_index:
            self.atom_index[key] = len(self.atoms)
            self.atoms.append(LoweredAtom(bank=bank, slot=sidx, op=_OP_CODE[op], value=val))
        return self.atom_index[key]

    def add_pred(self, pred: Pred) -> int:
        key = repr(pred)
        if key in self.pred_index:
            return self.pred_index[key]
        terms = []
        for term in to_dnf(pred):
            terms.append([self._lower_atom(a.field, a.op, a.value) for a in term])
        idx = len(self.preds)
        self.preds.append(terms)
        self.pred_index[key] = idx
        return idx


def _phase_mask(game: CompiledGame, dsl_ids) -> np.ndarray:
    """(NP+1,) bool indexed by dense_index+1 (slot 0 = 'no phase'/-1)."""
    m = np.zeros(game.n_phases + 1, dtype=bool)
    for pid in dsl_ids:
        m[game.id_to_index[pid] + 1] = True
    return m


def _lower_cond(cond: C.Cond, pool: _PredPool, game: CompiledGame) -> LoweredCond:
    if isinstance(cond, C.AlwaysTrue):
        return LAlways()
    if isinstance(cond, C.CondAnd):
        return LAnd(tuple(_lower_cond(c, pool, game) for c in cond.items))
    if isinstance(cond, C.PrevPhaseIn):
        return LPrevPhaseIn(mask=_phase_mask(game, cond.phase_ids))
    if isinstance(cond, C.AllPresent):
        return LAllPresent(pred=pool.add_pred(cond.pred))
    if isinstance(cond, C.CountCmp):
        left = pool.add_pred(cond.left)
        if isinstance(cond.right, int):
            return LCountCmp(left_pred=left, op=cond.op, right_pred=-1, right_const=cond.right)
        return LCountCmp(left_pred=left, op=cond.op, right_pred=pool.add_pred(cond.right), right_const=0)
    raise TypeError(cond)


def lower(game: CompiledGame) -> Lowered:
    layout = game.layout
    P = game.config.max_players
    NP = game.n_phases
    pool = _PredPool(layout)
    decl = game.spec.declaration

    def bool_default(f: str) -> bool:
        return bool(decl.field(f).default)

    def num_default(f: str) -> int:
        try:
            return int(decl.field(f).default)
        except (TypeError, ValueError):
            return 0

    def _pmask_words(ids) -> tuple[int, int]:
        """DSL phase ids -> 64-bit choice_phase membership words (bit =
        dense_index + 1, matching the (NP+1,) masks used elsewhere).

        Loud ceiling: the jitted/Pallas/C++ executors test chose()
        membership against these two 32-bit words, while the oracle's
        EChoseIn uses an unbounded frozenset — a >=63-phase game would
        silently drop membership bits and break parity, so refuse to
        lower it (ADVICE r3)."""
        bits = 0
        for pid in ids:
            bit = game.id_to_index[pid] + 1
            if bit >= 64:
                raise ValueError(
                    f"chose()/IR phase membership is limited to 63 phases: "
                    f"phase id {pid} lowers to membership bit {bit}"
                )
            bits |= 1 << bit
        return bits & 0xFFFFFFFF, (bits >> 32) & 0xFFFFFFFF

    def _lower_fx(prog, i: int, reveal=()) -> "LEffect":
        dts: list = []
        blocks = FX.lower_program(
            prog, layout, pool.add_pred, _pmask_words,
            has_alive=layout.get("is_alive") is not None,
            deal_tables=dts, max_players=P,
        )
        return LEffect(
            phase_index=i,
            blocks=blocks,
            reveal_bool_slots=tuple(layout.bool_index(f) for f in reveal),
            deal_tables=tuple(dts),
        )

    phase_is_action = np.zeros(NP, dtype=bool)
    phase_target_pred = np.zeros(NP, dtype=np.int32)
    phase_terminal = np.zeros(NP, dtype=bool)
    phase_static_next = np.arange(NP, dtype=np.int32)
    phase_has_branches = np.zeros(NP, dtype=bool)
    phase_dsl_id = np.zeros(NP, dtype=np.int32)
    choice_kind = np.zeros(NP, dtype=np.int32)
    choice_max = np.zeros(NP, dtype=np.int32)
    NB, NN = layout.n_bool, layout.n_num
    rec_bool_true = np.zeros((NP, NB), dtype=bool)
    rec_bool_false = np.zeros((NP, NB), dtype=bool)
    rec_num_slot = np.full(NP, -1, dtype=np.int32)
    rec_pdict_slot = np.full(NP, -1, dtype=np.int32)
    rec_pdict_src = np.full(NP, -1, dtype=np.int32)
    # categorical banks are stored int8 on-device (GameState.strs/pdict);
    # DSL vocabularies are tiny — assert the assumption rather than corrupt
    from game_engine_tpu.gamespec.layout import BANK_PDICT as _BPD

    for s in layout.slots.values():
        if s.bank in (BANK_STR, _BPD) and len(s.vocab) >= 127:
            raise ValueError(
                f"categorical field {s.field!r} has {len(s.vocab)} vocabulary "
                "entries; the int8 categorical banks support at most 126"
            )
    max_vocab = max([len(s.vocab) for s in layout.slots.values() if s.bank == BANK_STR] + [1])
    rec_pdict_trans = np.zeros((NP, max_vocab), dtype=np.int32)
    rec_odict_slot = np.full(NP, -1, dtype=np.int32)
    branches: list[list[tuple[LoweredCond, int]]] = [[] for _ in range(NP)]
    mechanics: list[LoweredMech] = []
    game_overs: list[LGameOver] = []  # metadata only (never executed)

    for cp in game.phases:
        i = cp.index
        phase_dsl_id[i] = cp.dsl_id
        phase_is_action[i] = cp.completion is CompletionType.PLAYER_ACTION
        phase_target_pred[i] = pool.add_pred(cp.target_pred)
        phase_terminal[i] = cp.terminal
        if cp.next_index is not None:
            phase_static_next[i] = cp.next_index
        phase_has_branches[i] = bool(cp.branches)
        rp = cp.program.record
        choice_kind[i] = rp.choice_kind.value
        choice_max[i] = rp.choice_max
        for f in rp.set_bool_true:
            rec_bool_true[i, layout.bool_index(f)] = True
        for f in rp.set_bool_false:
            rec_bool_false[i, layout.bool_index(f)] = True
        if rp.write_choice_num:
            rec_num_slot[i] = layout.num_index(rp.write_choice_num)
        if rp.write_pdict:
            field, src = rp.write_pdict
            pslot = layout.slot(field)
            rec_pdict_slot[i] = pslot.index
            if src:
                sslot = layout.slot(src)
                rec_pdict_src[i] = sslot.index
                # translate source-field string codes into the pdict field's
                # own value vocabulary (they are mined independently)
                for code, word in enumerate(sslot.vocab):
                    rec_pdict_trans[i, code] = pslot.encode(word)
        if rp.mark_odict:
            rec_odict_slot[i] = layout.slot(rp.mark_odict).index

        for b in cp.branches:
            branches[i].append((_lower_cond(b.cond, pool, game), b.next_index))

        for mech in cp.program.on_enter:
            if isinstance(mech, M.NightResolve):
                mechanics.append(_lower_fx(
                    FX.night_resolve_program(
                        mech.kill_phases, mech.protect_phases,
                        mech.kill_pred, mech.protect_pred,
                        (*mech.reset_bools, *mech.reset_nums),
                        protect=(FX.parse_expr(mech.protect)
                                 if mech.protect else None)),
                    i, mech.reveal_bools))
            elif isinstance(mech, M.VoteElim):
                mechanics.append(_lower_fx(
                    FX.vote_elim_program(
                        mech.vote_phases, mech.voter_pred,
                        protect=(FX.parse_expr(mech.protect)
                                 if mech.protect else None),
                        weight=(FX.parse_expr(mech.weight)
                                if mech.weight else None)),
                    i, mech.reveal_bools))
            elif isinstance(mech, M.ResourceIncome):
                mechanics.append(_lower_fx(FX.income_program(mech.gains), i))
            elif isinstance(mech, M.ResourceRaid):
                mechanics.append(_lower_fx(
                    FX.raid_program(mech.raid_phases, mech.raider_pred,
                                    mech.res_field), i))
            elif isinstance(mech, M.AuctionScore):
                mechanics.append(_lower_fx(
                    FX.auction_program(mech.bid_field, mech.bidder_pred,
                                       mech.res_field, mech.prize_field,
                                       num_default(mech.bid_field)), i))
            elif isinstance(mech, M.Effects):
                mechanics.append(_lower_fx(mech.program, i, mech.reveal_bools))
            elif isinstance(mech, M.MinorityScore):
                mechanics.append(_lower_fx(
                    FX.minority_program(
                        mech.pick_field, mech.picker_pred, mech.score_field,
                        int(mech.n_options)),
                    i))
            elif isinstance(mech, M.BluffChallenge):
                mechanics.append(_lower_fx(
                    FX.bluff_challenge_program(
                        mech.claim_field, mech.challenge_phases,
                        mech.claimant_pred, mech.challenger_pred,
                        mech.role_field,
                        tuple(r.name for r in decl.roles),
                        mech.lives_field),
                    i, mech.reveal_bools))
            elif isinstance(mech, M.GuessScore):
                mechanics.append(_lower_fx(
                    FX.guess_score_program(
                        mech.speaker_field, mech.lie_field, mech.vote_field,
                        mech.voted_field or None, mech.score_field,
                        mech.rounds_field or None),
                    i))
            elif isinstance(mech, M.SpeakerRotate):
                mechanics.append(_lower_fx(
                    FX.speaker_rotate_program(
                        mech.speaker_field, mech.rounds_field,
                        mech.can_vote_field or None,
                        (*mech.reset_bools, *mech.reset_nums,
                         *mech.reset_odicts, *mech.reset_pdicts)),
                    i))
            elif isinstance(mech, M.RoleAssign):
                # P10 lowers to the generic IR (round 4): a `deal` block
                # plus guarded constant-per-role writes — the bespoke
                # LRoleAssign kernels are deleted from all four executors
                mechanics.append(_lower_fx(
                    M.role_assign_program(mech, layout), i))
            elif isinstance(mech, M.SetBoolAll):
                mechanics.append(_lower_fx(
                    FX.set_bool_all_program(mech.fields), i))
            elif isinstance(mech, M.GameOver):
                # P11/P17: the terminal winner rule EXECUTES as an effect-IR
                # program (game_over_program — the bespoke kernels are
                # deleted); LGameOver survives as pure metadata for policy
                # observation shaping and reward assignment (policies/net.py,
                # train/ppo.py)
                team_slot = layout.get(mech.team_field) if mech.team_field else None
                game_overs.append(
                    LGameOver(
                        phase_index=i,
                        mode=mech.mode,
                        team_str_slot=team_slot.index if team_slot else -1,
                        team_codes=tuple(team_slot.encode(t) for t in mech.team_order) if team_slot else (),
                        alive_bool=layout.bool_index("is_alive") if layout.get("is_alive") else -1,
                        score_num=layout.num_index(mech.score_field) if mech.score_field else -1,
                    )
                )
                mechanics.append(_lower_fx(
                    FX.game_over_program_for(mech, layout), i))

    bool_defaults = np.zeros(NB, dtype=bool)
    num_defaults = np.zeros(NN, dtype=np.int32)
    str_defaults = np.zeros(layout.n_str, dtype=np.int32)
    name_str_slot = -1
    for f in decl.fields:
        s = layout.slot(f.name)
        if s.bank == BANK_BOOL:
            bool_defaults[s.index] = bool(f.default)
        elif s.bank == BANK_NUM:
            try:
                num_defaults[s.index] = int(f.default)
            except (TypeError, ValueError):
                pass
        elif s.bank == BANK_STR:
            str_defaults[s.index] = s.encode(f.default)
            if f.name == "name":
                name_str_slot = s.index

    return Lowered(
        game=game,
        P=P,
        NP=NP,
        atoms=pool.atoms,
        preds=pool.preds,
        phase_is_action=phase_is_action,
        phase_target_pred=phase_target_pred,
        phase_terminal=phase_terminal,
        phase_static_next=phase_static_next,
        phase_has_branches=phase_has_branches,
        phase_dsl_id=phase_dsl_id,
        choice_kind=choice_kind,
        choice_max=choice_max,
        rec_bool_true=rec_bool_true,
        rec_bool_false=rec_bool_false,
        rec_num_slot=rec_num_slot,
        rec_pdict_slot=rec_pdict_slot,
        rec_pdict_src=rec_pdict_src,
        rec_pdict_trans=rec_pdict_trans,
        rec_odict_slot=rec_odict_slot,
        branches=branches,
        mechanics=mechanics,
        game_overs=tuple(game_overs),
        alive_bool=layout.bool_index("is_alive") if layout.get("is_alive") else -1,
        bool_defaults=bool_defaults,
        num_defaults=num_defaults,
        str_defaults=str_defaults,
        name_str_slot=name_str_slot,
    )
