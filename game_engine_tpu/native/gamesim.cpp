// gamesim — native C++ implementation of the table-driven room simulator.
//
// Third implementation of the pinned P1..P11 semantics (see
// gamespec/mechanics.py): consumes the packed blob from native/pack.py and
// must produce bit-identical traces to oracle/interp.py and core/step.py —
// enforced by tests/test_native.py differential tests. Used as the
// low-latency host-side step for interactive rooms (no device dispatch) and
// as a CPU throughput baseline.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC gamesim.cpp -o libgamesim.so

#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>
#include <algorithm>

namespace {

constexpr int32_t MAGIC = 0x47534D31;
enum Sections {
  SEC_HEADER = 1, SEC_ATOMS, SEC_PRED_OFF, SEC_TERM_OFF, SEC_LITS, SEC_PHASE,
  SEC_RECTRUE, SEC_RECFALSE, SEC_PDTRANS, SEC_CONDS, SEC_BRANCH_OFF,
  SEC_BRANCHES, SEC_MECHS, SEC_POOL, SEC_DEFAULTS,
  SEC_ROLETAB /* retired r4: deals ride the pool */,
};
enum CondType { COND_ALWAYS, COND_COUNTCMP, COND_ALLPRESENT, COND_PREVIN, COND_AND };
// MECH_NIGHT (P7), MECH_VOTE (P6), MECH_SCORE (P8), MECH_ROTATE (P9),
// MECH_SETBOOL, MECH_BLUFF (P14) and MECH_MINORITY (P16) are retired ids:
// those families now lower to MECH_EFFECTS programs (gamespec/effects.py).
// Numbering stays stable for the pack ABI (native/pack.py).
enum MechType { MECH_NIGHT, MECH_VOTE, MECH_SCORE, MECH_ROTATE, MECH_ROLES,
                MECH_SETBOOL, MECH_OVER, MECH_BLUFF, MECH_MINORITY,
                MECH_EFFECTS };
// P20 effect-IR node kinds — mirror gamespec/effects.py NK_* exactly
enum FxNode { FX_CONST, FX_FIELD, FX_SEAT, FX_NPLAYERS, FX_CHOICE,
              FX_CHOSEIN, FX_ALIVE, FX_PRESENT, FX_PRED, FX_BIN, FX_CMP,
              FX_NOT, FX_AND, FX_OR, FX_WHERE, FX_AT, FX_INCOMING,
              FX_EQCOUNT, FX_RANK, FX_REDUCE, FX_ARGBEST };
enum FxBin { FXBIN_ADD, FXBIN_SUB, FXBIN_MUL, FXBIN_MIN, FXBIN_MAX };
enum FxRed { FXRED_SUM, FXRED_MAX, FXRED_MIN, FXRED_COUNT };
enum FxStmt { FXST_SET, FXST_ADD, FXST_KILL, FXST_RESET, FXST_SETD,
              FXST_OVER, FXST_DEAL };
enum FxBank { FXB_BOOL, FXB_NUM, FXB_STR, FXB_ODICT, FXB_PDICT };
enum Bank { AB_BOOL, AB_NUM, AB_STR, AB_CONST };
enum Op { OP_EQ, OP_NE, OP_GE, OP_LE, OP_GT, OP_LT };
enum Kind { K_NONE = 0, K_TARGET = 1, K_OPTION = 2, K_SUBMIT = 3 };
constexpr int MECH_PARAMS = 16;
constexpr int PHASE_ROW = 11;

uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  uint32_t z = x;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

uint32_t action_hash(uint32_t seed, uint32_t step, uint32_t pid) {
  uint32_t h = splitmix32(seed * 0x85EBCA6Bu + step);
  return splitmix32(h ^ (pid * 0x9E3779B9u));
}

struct Game {
  int P, NP, NB, NN, NS, NPD, NOD;
  int alive_slot, start_index, name_slot, n_atoms, n_preds, maxv;
  std::vector<int32_t> atoms;      // n_atoms x 5
  std::vector<int32_t> pred_off;   // n_preds+1 (into term_off)
  std::vector<int32_t> term_off;   // n_terms+1 (into lits)
  std::vector<int32_t> lits;
  std::vector<int32_t> phase;      // NP x PHASE_ROW
  std::vector<int32_t> rec_true;   // NP x NB
  std::vector<int32_t> rec_false;  // NP x NB
  std::vector<int32_t> pdtrans;    // NP x maxv
  std::vector<int32_t> conds;      // n x 5
  std::vector<int32_t> branch_off; // NP+1
  std::vector<int32_t> branches;   // n x 2
  std::vector<int32_t> mechs;      // n x (2 + MECH_PARAMS)
  std::vector<int32_t> pool;
  std::vector<int32_t> bool_def, num_def, str_def;

  int ph(int i, int field) const { return phase[i * PHASE_ROW + field]; }
};

struct Room {
  const Game* g;
  int n;
  uint32_t seed;
  std::vector<uint8_t> bools;   // P x NB
  std::vector<int32_t> nums;    // P x NN
  std::vector<int32_t> strs;    // P x NS
  std::vector<int32_t> pdict;   // P x NPD x P
  std::vector<int32_t> odict;   // P x NOD
  std::vector<uint8_t> acted;   // P
  std::vector<int32_t> choice;  // P
  std::vector<int32_t> choice_phase;  // P (dense index, -1)
  int phase = 0, prev = -1, winner = 0, t = 0;
  bool done = false;
};

bool atom_eval(const Game& g, const Room& r, int ai, int p) {
  const int32_t* a = &g.atoms[ai * 5];
  int bank = a[0], slot = a[1], op = a[2];
  int32_t val = a[3];
  if (bank == AB_CONST) return a[4] == 1;
  int32_t x;
  if (bank == AB_BOOL) x = r.bools[p * g.NB + slot];
  else if (bank == AB_NUM) x = r.nums[p * g.NN + slot];
  else x = r.strs[p * g.NS + slot];
  switch (op) {
    case OP_EQ: return x == val;
    case OP_NE: return x != val;
    case OP_GE: return x >= val;
    case OP_LE: return x <= val;
    case OP_GT: return x > val;
    default: return x < val;
  }
}

bool pred_eval(const Game& g, const Room& r, int pi, int p) {
  int t0 = g.pred_off[pi], t1 = g.pred_off[pi + 1];
  if (t0 == t1) return false;  // no terms => const False
  for (int t = t0; t < t1; ++t) {
    bool ok = true;
    for (int l = g.term_off[t]; l < g.term_off[t + 1]; ++l)
      if (!atom_eval(g, r, g.lits[l], p)) { ok = false; break; }
    if (ok) return true;
  }
  return false;
}

// memo: per-branch-decision cache of pred counts (index = pred id,
// -1 = unevaluated). Room state is frozen for the whole first-match-wins
// branch scan, so counts are constant within it — werewolf's win-check
// branches count the same alive-team preds 3-4x without it (gprof:
// pred_eval was 15% of selfplay).
int count_pred(const Game& g, const Room& r, int pi, int32_t* memo = nullptr) {
  if (memo && memo[pi] >= 0) return memo[pi];
  int c = 0;
  for (int p = 0; p < r.n; ++p) c += pred_eval(g, r, pi, p);
  if (memo) memo[pi] = c;
  return c;
}

bool mask64_has(int32_t lo, int32_t hi, int idx_plus1) {
  uint64_t bits = (uint64_t)(uint32_t)lo | ((uint64_t)(uint32_t)hi << 32);
  return idx_plus1 >= 0 && idx_plus1 < 64 && ((bits >> idx_plus1) & 1);
}

bool cond_eval(const Game& g, const Room& r, int ci, int32_t* memo = nullptr) {
  const int32_t* c = &g.conds[ci * 5];
  switch (c[0]) {
    case COND_ALWAYS: return true;
    case COND_COUNTCMP: {
      int lhs = count_pred(g, r, c[1], memo);
      int rhs = c[3] >= 0 ? count_pred(g, r, c[3], memo) : c[4];
      switch (c[2]) {
        case OP_EQ: return lhs == rhs;
        case OP_NE: return lhs != rhs;
        case OP_GE: return lhs >= rhs;
        case OP_LE: return lhs <= rhs;
        case OP_GT: return lhs > rhs;
        default: return lhs < rhs;
      }
    }
    case COND_ALLPRESENT: return count_pred(g, r, c[1], memo) == r.n;
    case COND_PREVIN: return mask64_has(c[1], c[2], r.prev + 1);
    case COND_AND: {
      for (int k = 0; k < c[2]; ++k)
        if (!cond_eval(g, r, g.pool[c[1] + k], memo)) return false;
      return true;
    }
  }
  return false;
}

bool alive(const Game& g, const Room& r, int p) {
  if (p < 0 || p >= r.n) return false;
  if (g.alive_slot < 0) return true;
  return r.bools[p * g.NB + g.alive_slot] != 0;
}

// P15: death clears is_alive and sets the reveal flags (pool slice).
void kill_player(const Game& g, Room& r, int target, int rv_off = 0, int rv_n = 0) {
  if (target < 1 || target > r.n) return;
  if (g.alive_slot >= 0)
    r.bools[(target - 1) * g.NB + g.alive_slot] = 0;
  for (int k = 0; k < rv_n; ++k)
    r.bools[(target - 1) * g.NB + g.pool[rv_off + k]] = 1;
}

void apply_on_enter(const Game& g, Room& r);

void do_transition(const Game& g, Room& r, int next) {
  if (next == r.phase) return;
  r.prev = r.phase;
  r.phase = next;
  std::fill(r.acted.begin(), r.acted.end(), 0);
  apply_on_enter(g, r);
}

void apply_on_enter(const Game& g, Room& r) {
  int n_mech = (int)g.mechs.size() / (2 + MECH_PARAMS);
  for (int mi = 0; mi < n_mech; ++mi) {
    const int32_t* m = &g.mechs[mi * (2 + MECH_PARAMS)];
    if (m[1] != r.phase) continue;
    const int32_t* q = m + 2;
    switch (m[0]) {
      // MECH_ROLES retired (round 4): P10 role assignment arrives as a
      // MECH_EFFECTS program whose first block is an FXST_DEAL statement
      case MECH_EFFECTS: {  // P20: the generic effect-IR interpreter
        int off = q[0], n_blocks = q[1], rv_off = q[2], rv_n = q[3];
        int n = r.n;
        for (int blk = 0; blk < n_blocks; ++blk) {
          int n_nodes = g.pool[off], n_stmts = g.pool[off + 1];
          const int32_t* nodes = &g.pool[off + 2];
          const int32_t* stmts = nodes + (int64_t)n_nodes * 4;
          off += 2 + n_nodes * 4 + n_stmts * 6;
          // block-entry snapshot: every expression reads it (simultaneous
          // resolution); statement writes land on the live room in order.
          // thread_local + assign reuses capacity — per-block heap churn
          // halved the sim's steps/s when the IR became the only path
          static thread_local std::vector<uint8_t> sb;
          static thread_local std::vector<int32_t> sn, ss;
          sb.assign(r.bools.begin(), r.bools.end());
          sn.assign(r.nums.begin(), r.nums.end());
          ss.assign(r.strs.begin(), r.strs.end());
          auto fx_atom = [&](int ai, int p) -> bool {
            const int32_t* a = &g.atoms[ai * 5];
            if (a[0] == AB_CONST) return a[4] == 1;
            int32_t x = a[0] == AB_BOOL ? sb[p * g.NB + a[1]]
                      : a[0] == AB_NUM ? sn[p * g.NN + a[1]]
                                       : ss[p * g.NS + a[1]];
            switch (a[2]) {
              case OP_EQ: return x == a[3];
              case OP_NE: return x != a[3];
              case OP_GE: return x >= a[3];
              case OP_LE: return x <= a[3];
              case OP_GT: return x > a[3];
              default: return x < a[3];
            }
          };
          auto fx_pred = [&](int pi, int p) -> bool {
            int t0 = g.pred_off[pi], t1 = g.pred_off[pi + 1];
            if (t0 == t1) return false;
            for (int t = t0; t < t1; ++t) {
              bool ok = true;
              for (int l = g.term_off[t]; l < g.term_off[t + 1]; ++l)
                if (!fx_atom(g.lits[l], p)) { ok = false; break; }
              if (ok) return true;
            }
            return false;
          };
          // node values: ONE flat reused buffer (node-major), not a
          // vector-of-vectors — vals(k)[p] is value of node k at seat p.
          // resize, not assign: every node writes all n lanes before any
          // later node reads it (pool order), so zero-filling is pure
          // memset cost (11% of werewolf selfplay, gprof)
          static thread_local std::vector<int32_t> vbuf;
          vbuf.resize((size_t)n_nodes * n);
          auto vals = [&](int k) -> int32_t* { return &vbuf[(size_t)k * n]; };
          for (int ni = 0; ni < n_nodes; ++ni) {
            const int32_t* nd = &nodes[ni * 4];
            int kind = nd[0], a = nd[1], b = nd[2], c = nd[3];
            int32_t* out = vals(ni);
            switch (kind) {
              case FX_CONST: for (int p = 0; p < n; ++p) out[p] = a; break;
              case FX_FIELD:
                for (int p = 0; p < n; ++p)
                  out[p] = a == FXB_BOOL ? sb[p * g.NB + b]
                         : a == FXB_NUM ? sn[p * g.NN + b]
                                        : ss[p * g.NS + b];
                break;
              case FX_SEAT: for (int p = 0; p < n; ++p) out[p] = p + 1; break;
              case FX_NPLAYERS: for (int p = 0; p < n; ++p) out[p] = n; break;
              case FX_CHOICE: for (int p = 0; p < n; ++p) out[p] = r.choice[p]; break;
              case FX_CHOSEIN:
                for (int p = 0; p < n; ++p)
                  out[p] = mask64_has(a, b, r.choice_phase[p] + 1) ? 1 : 0;
                break;
              case FX_ALIVE:
                for (int p = 0; p < n; ++p)
                  out[p] = g.alive_slot < 0 ? 1 : (sb[p * g.NB + g.alive_slot] ? 1 : 0);
                break;
              case FX_PRESENT: for (int p = 0; p < n; ++p) out[p] = 1; break;
              case FX_PRED:
                for (int p = 0; p < n; ++p) out[p] = fx_pred(a, p) ? 1 : 0;
                break;
              case FX_BIN:
                // wrap via uint32: signed overflow is UB, but the pinned IR
                // semantics (SEMANTICS.md P20) are int32 two's-complement
                // wrapping in all four executors
                for (int p = 0; p < n; ++p) {
                  int32_t x = vals(b)[p], y = vals(c)[p];
                  switch (a) {
                    case FXBIN_ADD:
                      out[p] = (int32_t)((uint32_t)x + (uint32_t)y); break;
                    case FXBIN_SUB:
                      out[p] = (int32_t)((uint32_t)x - (uint32_t)y); break;
                    case FXBIN_MUL:
                      out[p] = (int32_t)((uint32_t)x * (uint32_t)y); break;
                    case FXBIN_MIN: out[p] = std::min(x, y); break;
                    default: out[p] = std::max(x, y);
                  }
                }
                break;
              case FX_CMP:
                for (int p = 0; p < n; ++p) {
                  int32_t x = vals(b)[p], y = vals(c)[p];
                  bool v;
                  switch (a) {
                    case OP_EQ: v = x == y; break;
                    case OP_NE: v = x != y; break;
                    case OP_GE: v = x >= y; break;
                    case OP_LE: v = x <= y; break;
                    case OP_GT: v = x > y; break;
                    default: v = x < y;
                  }
                  out[p] = v ? 1 : 0;
                }
                break;
              case FX_NOT:
                for (int p = 0; p < n; ++p) out[p] = vals(a)[p] == 0 ? 1 : 0;
                break;
              case FX_AND:
                for (int p = 0; p < n; ++p)
                  out[p] = (vals(a)[p] != 0 && vals(b)[p] != 0) ? 1 : 0;
                break;
              case FX_OR:
                for (int p = 0; p < n; ++p)
                  out[p] = (vals(a)[p] != 0 || vals(b)[p] != 0) ? 1 : 0;
                break;
              case FX_WHERE:
                for (int p = 0; p < n; ++p)
                  out[p] = vals(a)[p] != 0 ? vals(b)[p] : vals(c)[p];
                break;
              case FX_AT:
                for (int p = 0; p < n; ++p) {
                  int32_t i = vals(b)[p];
                  out[p] = (i >= 1 && i <= n) ? vals(a)[i - 1] : 0;
                }
                break;
              case FX_INCOMING:
                for (int p = 0; p < n; ++p) {
                  int32_t s = 0;
                  for (int qq = 0; qq < n; ++qq)
                    if (vals(c)[qq] != 0 && vals(b)[qq] == p + 1) s += vals(a)[qq];
                  out[p] = s;
                }
                break;
              case FX_EQCOUNT:
                for (int p = 0; p < n; ++p) {
                  int32_t s = 0;
                  for (int qq = 0; qq < n; ++qq)
                    if (vals(b)[qq] != 0 && vals(a)[qq] == vals(a)[p]) s++;
                  out[p] = s;
                }
                break;
              case FX_RANK:
                for (int p = 0; p < n; ++p) {
                  int32_t s = 0;
                  for (int qq = 0; qq < p; ++qq)
                    if (vals(b)[qq] != 0 && vals(a)[qq] == vals(a)[p]) s++;
                  out[p] = s;
                }
                break;
              case FX_REDUCE: {
                int32_t acc = 0;
                bool any = false;
                for (int qq = 0; qq < n; ++qq) {
                  if (vals(c)[qq] == 0) continue;
                  int32_t v = vals(b)[qq];
                  if (!any) { acc = (a == FXRED_COUNT) ? 1 : v; any = true; }
                  else if (a == FXRED_SUM)
                    acc = (int32_t)((uint32_t)acc + (uint32_t)v);  // int32 wrap
                  else if (a == FXRED_MAX) acc = std::max(acc, v);
                  else if (a == FXRED_MIN) acc = std::min(acc, v);
                  else acc += 1;  // FXRED_COUNT
                }
                if (!any) acc = 0;  // empty max/min pins to 0 (P20)
                for (int p = 0; p < n; ++p) out[p] = acc;
                break;
              }
              case FX_ARGBEST: {
                int win = 0;
                int32_t best = 0;
                bool any = false;
                for (int qq = 0; qq < n; ++qq) {
                  if (vals(c)[qq] == 0) continue;
                  int32_t v = vals(b)[qq];
                  // ties resolve to the LOWEST seat (strict compare)
                  if (!any || (a == 0 ? v > best : v < best)) {
                    best = v; win = qq + 1; any = true;
                  }
                }
                for (int p = 0; p < n; ++p) out[p] = win;
                break;
              }
            }
          }
          for (int si = 0; si < n_stmts; ++si) {
            const int32_t* st = &stmts[si * 6];
            if (st[0] == FXST_DEAL) {
              // P10 as IR: rank ALL seats by splitmix32 key (salt node
              // st[5]; salt 0 = the retired MECH_ROLES permutation, ties
              // to the lower seat); `where` (st[4]) only gates writes.
              // st[3] is the pool offset of the (P+1, P) multiset table.
              // O(P^2) stable rank — the same math as step.py/pallas
              // (rank = #{q: key_q < key_p, or equal with q < p}); a
              // stable_sort here was 11% of werewolf selfplay (gprof)
              // and equals sorted-position exactly
              static thread_local std::vector<uint32_t> keys;
              keys.resize(n);
              for (int p = 0; p < n; ++p)
                keys[p] = splitmix32(r.seed * 0x100u + (uint32_t)p +
                                     (uint32_t)vals(st[5])[p] * 0x9E3779B9u);
              for (int p = 0; p < n; ++p) {
                if (vals(st[4])[p] == 0) continue;
                int rank = 0;
                for (int qq = 0; qq < n; ++qq)
                  if (keys[qq] < keys[p] || (keys[qq] == keys[p] && qq < p))
                    rank++;
                r.strs[p * g.NS + st[2]] = g.pool[st[3] + n * g.P + rank];
              }
              continue;
            }
            for (int p = 0; p < n; ++p) {
              if (vals(st[4])[p] == 0) continue;
              switch (st[0]) {
                case FXST_KILL:
                  kill_player(g, r, p + 1, rv_off, rv_n);
                  break;
                case FXST_SET:
                  if (st[1] == FXB_BOOL)
                    r.bools[p * g.NB + st[2]] = (uint8_t)(vals(st[3])[p] != 0);
                  else if (st[1] == FXB_STR)
                    r.strs[p * g.NS + st[2]] = vals(st[3])[p];
                  else
                    r.nums[p * g.NN + st[2]] = vals(st[3])[p];
                  break;
                case FXST_RESET:  // dict banks clear to empty
                  if (st[1] == FXB_ODICT)
                    r.odict[p * g.NOD + st[2]] = 0;
                  else
                    std::fill_n(&r.pdict[(p * g.NPD + st[2]) * g.P], g.P, 0);
                  break;
                case FXST_SETD: {  // pdict[key] = code; bad key = no-op
                  int32_t k = vals(st[5])[p];
                  if (k >= 1 && k <= n)
                    r.pdict[(p * g.NPD + st[2]) * g.P + (k - 1)] =
                        vals(st[3])[p];
                  break;
                }
                case FXST_OVER:  // P11/P17: winner from the lowest seat
                  if (p == 0) { r.done = true; r.winner = vals(st[3])[0]; }
                  break;
                default:  // FXST_ADD (int32 wrap, not UB)
                  r.nums[p * g.NN + st[2]] = (int32_t)(
                      (uint32_t)r.nums[p * g.NN + st[2]]
                      + (uint32_t)vals(st[3])[p]);
              }
            }
          }
        }
        break;
      }
      // MECH_OVER retired: P11/P17 terminal winner rules now arrive as
      // MECH_EFFECTS programs ending in FXST_OVER (one IR interpreter)
    }
  }
}

// P1/P2 acceptance + record writes.
bool accept_action(const Game& g, Room& r, int p, int c) {
  int i = r.phase;
  if (!g.ph(i, 0)) return false;           // not a player_action phase
  if (r.acted[p]) return false;
  if (!pred_eval(g, r, g.ph(i, 1), p)) return false;
  int kind = g.ph(i, 4);
  if (kind == K_TARGET) {
    if (c < 1 || c > r.n || !alive(g, r, c - 1)) return false;
  } else if (kind == K_OPTION) {
    int hi = g.ph(i, 5) > 0 ? g.ph(i, 5) : r.n;
    if (c < 1 || c > hi) return false;
  } else if (kind == K_SUBMIT) {
    c = 1;
  } else {
    return false;
  }
  for (int b = 0; b < g.NB; ++b) {
    if (g.rec_true[i * g.NB + b]) r.bools[p * g.NB + b] = 1;
    if (g.rec_false[i * g.NB + b]) r.bools[p * g.NB + b] = 0;
  }
  if (g.ph(i, 6) >= 0) r.nums[p * g.NN + g.ph(i, 6)] = c;
  int pd = g.ph(i, 7), src = g.ph(i, 8);
  if (pd >= 0 && c >= 1 && c <= r.n) {
    int code = 0;
    if (src >= 0) {
      int raw = r.strs[(c - 1) * g.NS + src];
      if (raw >= 0 && raw < g.maxv) code = g.pdtrans[i * g.maxv + raw];
    }
    r.pdict[(p * g.NPD + pd) * g.P + (c - 1)] = code;
  }
  if (g.ph(i, 9) >= 0) r.odict[p * g.NOD + g.ph(i, 9)] = 1;
  r.acted[p] = 1;
  r.choice[p] = c;
  r.choice_phase[p] = i;
  return true;
}

void room_step(const Game& g, Room& r, const int32_t* actions) {
  r.t += 1;
  if (r.done) return;
  if (actions) {
    for (int p = 0; p < r.n; ++p)
      if (actions[p] != 0) accept_action(g, r, p, actions[p]);
  }
  int i = r.phase;
  bool complete = true;
  if (g.ph(i, 0)) {  // player_action: all targeted have acted (P3)
    for (int p = 0; p < r.n; ++p)
      if (pred_eval(g, r, g.ph(i, 1), p) && !r.acted[p]) { complete = false; break; }
  }
  if (!complete) return;
  if (g.ph(i, 2)) return;  // terminal stays
  int next;
  int b0 = g.branch_off[i], b1 = g.branch_off[i + 1];
  if (b1 > b0) {
    static thread_local std::vector<int32_t> memo;
    memo.assign((size_t)g.n_preds, -1);
    next = g.branches[(b1 - 1) * 2 + 1];  // P5 fallback: last branch
    for (int b = b0; b < b1; ++b) {
      if (cond_eval(g, r, g.branches[b * 2], memo.data())) {
        next = g.branches[b * 2 + 1];
        break;
      }
    }
  } else {
    next = g.ph(i, 3);
  }
  do_transition(g, r, next);
}

// deterministic scripted policy (identical stream to policies/scripted.py)
void room_policy(const Game& g, const Room& r, int32_t* out) {
  std::fill_n(out, g.P, 0);
  if (r.done) return;
  int i = r.phase;
  if (!g.ph(i, 0)) return;
  int kind = g.ph(i, 4);
  for (int p = 0; p < r.n; ++p) {
    if (r.acted[p] || !pred_eval(g, r, g.ph(i, 1), p)) continue;
    uint32_t h = action_hash(r.seed, (uint32_t)r.t, (uint32_t)(p + 1));
    if (kind == K_TARGET) {
      int n_alive = 0;
      for (int q = 0; q < r.n; ++q) n_alive += alive(g, r, q);
      if (n_alive == 0) continue;
      int k = (int)(h % (uint32_t)n_alive), seen = 0;
      for (int q = 0; q < r.n; ++q) {
        if (alive(g, r, q)) {
          if (seen == k) { out[p] = q + 1; break; }
          seen++;
        }
      }
    } else if (kind == K_OPTION) {
      int hi = g.ph(i, 5) > 0 ? g.ph(i, 5) : r.n;
      out[p] = 1 + (int)(h % (uint32_t)hi);
    } else if (kind == K_SUBMIT) {
      out[p] = 1;
    }
  }
}

void room_init(const Game& g, Room& r, int n, uint32_t seed) {
  r.g = &g;
  r.n = n;
  r.seed = seed;
  r.bools.assign(g.P * g.NB, 0);
  r.nums.assign(g.P * g.NN, 0);
  r.strs.assign(g.P * g.NS, 0);
  r.pdict.assign(g.P * g.NPD * g.P, 0);
  r.odict.assign(g.P * g.NOD, 0);
  r.acted.assign(g.P, 0);
  r.choice.assign(g.P, 0);
  r.choice_phase.assign(g.P, -1);
  r.phase = g.start_index;
  r.prev = -1;
  r.winner = 0;
  r.t = 0;
  r.done = false;
  for (int p = 0; p < g.P; ++p) {
    for (int b = 0; b < g.NB; ++b) r.bools[p * g.NB + b] = (uint8_t)g.bool_def[b];
    for (int b = 0; b < g.NN; ++b) r.nums[p * g.NN + b] = g.num_def[b];
    for (int b = 0; b < g.NS; ++b) r.strs[p * g.NS + b] = g.str_def[b];
  }
  apply_on_enter(g, r);
}

}  // namespace

extern "C" {

void* gs_create(const int32_t* blob, int64_t len) {
  if (len < 1 || blob[0] != MAGIC) return nullptr;
  auto* g = new Game();
  int64_t i = 1;
  while (i + 2 <= len) {
    int sid = blob[i], n = blob[i + 1];
    if (n < 0 || i + 2 + n > len) {  // truncated/corrupt section
      delete g;
      return nullptr;
    }
    const int32_t* d = blob + i + 2;
    std::vector<int32_t> v(d, d + n);
    switch (sid) {
      case SEC_HEADER:
        g->P = v[0]; g->NP = v[1]; g->NB = v[2]; g->NN = v[3]; g->NS = v[4];
        g->NPD = v[5]; g->NOD = v[6]; g->alive_slot = v[7]; g->start_index = v[8];
        g->name_slot = v[9]; g->n_atoms = v[10]; g->n_preds = v[11]; g->maxv = v[12];
        break;
      case SEC_ATOMS: g->atoms = v; break;
      case SEC_PRED_OFF: g->pred_off = v; break;
      case SEC_TERM_OFF: g->term_off = v; break;
      case SEC_LITS: g->lits = v; break;
      case SEC_PHASE: g->phase = v; break;
      case SEC_RECTRUE: g->rec_true = v; break;
      case SEC_RECFALSE: g->rec_false = v; break;
      case SEC_PDTRANS: g->pdtrans = v; break;
      case SEC_CONDS: g->conds = v; break;
      case SEC_BRANCH_OFF: g->branch_off = v; break;
      case SEC_BRANCHES: g->branches = v; break;
      case SEC_MECHS: g->mechs = v; break;
      case SEC_POOL: g->pool = v; break;
      case SEC_DEFAULTS:
        g->bool_def.assign(v.begin(), v.begin() + g->NB);
        g->num_def.assign(v.begin() + g->NB, v.begin() + g->NB + g->NN);
        g->str_def.assign(v.begin() + g->NB + g->NN, v.end());
        break;
      default: break;
    }
    i += 2 + n;
  }
  // loud-or-correct: every mechanic family lowers to MECH_EFFECTS since
  // round 4 — a blob carrying a retired mech id (e.g. MECH_ROLES from a
  // pre-round-4 pack.py) would otherwise simulate visibly wrong with no
  // error (roles never assigned)
  {
    int n_mech = (int)g->mechs.size() / (2 + MECH_PARAMS);
    for (int mi = 0; mi < n_mech; ++mi) {
      if (g->mechs[mi * (2 + MECH_PARAMS)] != MECH_EFFECTS) {
        delete g;
        return nullptr;
      }
    }
  }
  return g;
}

void gs_destroy(void* h) { delete (Game*)h; }

void* gs_room_new(void* gh, int n, uint32_t seed) {
  auto* g = (Game*)gh;
  auto* r = new Room();
  room_init(*g, *r, n, seed);
  return r;
}

void gs_room_destroy(void* rh) { delete (Room*)rh; }

void gs_room_step(void* rh, const int32_t* actions) {
  auto* r = (Room*)rh;
  room_step(*r->g, *r, actions);
}

void gs_room_policy(void* rh, int32_t* out) {
  auto* r = (Room*)rh;
  room_policy(*r->g, *r, out);
}

// Flat Monte-Carlo lookahead for ONE seat — the search-bot tier
// (policies/search.py). The reference's bots decide contextually via an
// LLM call (reference: agent/game_agent_v2.py:468-617 BotBehaviorNode);
// this is the native-engine answer: try each legal choice, roll
// `rollouts` scripted continuations of the whole room to termination,
// score terminal outcomes exactly like train/ppo.py terminal_rewards,
// and return the choice with the best total (ties to the LOWEST choice).
//
// Deterministic in (room state, salt, rollouts, max_steps): rollout k
// re-seeds the copy from splitmix32(salt ^ t-mix ^ k-mix) — common
// random numbers, so the k-th rollout of every candidate replays the
// same opponent stream (paired comparison, lower variance). Never
// mutates the live room.
//   mode: 1 = team game (team_codes[winner-1] vs my final team slot),
//         2 = score game (winner is a 1-based seat), else returns 0 and
//         the caller falls back to the scripted policy.
// Returns the chosen 1-based action, or 0 when this seat has no decision.
//
// The candidate enumeration + common-random-number scoring lives in
// search_scores_core so gs_room_search_scores (the determinized /
// information-set tier's per-candidate totals, policies/search.py) shares
// it statement-for-statement — the argmax here stays bit-identical to the
// pre-refactor build (first strictly-greater total wins; candidates are
// enumerated in ascending order, so ties go to the LOWEST choice).
// Core return: -1 = forced submit (caller answers 1), 0 = no decision /
// unsearchable, N>0 = candidate count written to out_cands/out_scores
// (single candidate: score 0, no rollouts — same fast path as before).
static int32_t search_scores_core(Room* r0, int32_t pid, int32_t rollouts,
                                  int32_t max_steps, int32_t mode,
                                  int32_t team_slot, const int32_t* team_codes,
                                  int32_t n_codes, uint32_t salt,
                                  int32_t* out_cands, int64_t* out_scores,
                                  int32_t cap) {
  const Game& g = *r0->g;
  int p = pid - 1;
  if (r0->done || p < 0 || p >= r0->n) return 0;
  int i = r0->phase;
  if (!g.ph(i, 0) || r0->acted[p]) return 0;
  if (!pred_eval(g, *r0, g.ph(i, 1), p)) return 0;
  int kind = g.ph(i, 4);
  std::vector<int32_t> cands;
  if (kind == K_TARGET) {
    for (int q = 0; q < r0->n; ++q)
      if (alive(g, *r0, q)) cands.push_back(q + 1);
  } else if (kind == K_OPTION) {
    int hi = g.ph(i, 5) > 0 ? g.ph(i, 5) : r0->n;
    for (int c = 1; c <= hi; ++c) cands.push_back(c);
  } else if (kind == K_SUBMIT) {
    return -1;  // submit carries no choice
  } else {
    return 0;
  }
  if (cands.empty()) return 0;
  if (mode != 1 && mode != 2) return 0;  // no terminal reward to search for
  if ((int32_t)cands.size() > cap) return 0;  // caller buffer too small
  if (cands.size() == 1) {
    out_cands[0] = cands[0];
    out_scores[0] = 0;
    return 1;
  }
  if (mode == 1 && (team_slot < 0 || n_codes <= 0)) return 0;
  static thread_local Room sim;
  static thread_local std::vector<int32_t> acts;
  acts.resize(g.P);
  int32_t nc = 0;
  for (int32_t c : cands) {
    int64_t score = 0;
    for (int k = 0; k < rollouts; ++k) {
      sim = *r0;
      sim.seed = splitmix32(salt ^ ((uint32_t)r0->t * 0x85EBCA6Bu)
                            ^ (0x9E3779B9u * (uint32_t)(k + 1)));
      for (int t = 0; t < max_steps && !sim.done; ++t) {
        room_policy(g, sim, acts.data());
        if (t == 0) acts[p] = c;  // the candidate under evaluation
        room_step(g, sim, acts.data());
      }
      if (!sim.done) continue;  // horizon truncation scores 0
      if (mode == 1) {
        int wi = sim.winner - 1;
        wi = wi < 0 ? 0 : (wi >= n_codes ? n_codes - 1 : wi);
        score += sim.strs[p * g.NS + team_slot] == team_codes[wi] ? 1 : -1;
      } else {  // score mode: zero-sum per room, scaled to integers
        score += sim.winner == pid ? (sim.n - 1) : -1;
      }
    }
    out_cands[nc] = c;
    out_scores[nc] = score;
    ++nc;
  }
  return nc;
}

int32_t gs_room_search(void* rh, int32_t pid, int32_t rollouts,
                       int32_t max_steps, int32_t mode, int32_t team_slot,
                       const int32_t* team_codes, int32_t n_codes,
                       uint32_t salt) {
  auto* r0 = (Room*)rh;
  static thread_local std::vector<int32_t> cbuf;
  static thread_local std::vector<int64_t> sbuf;
  int cap = r0->g->P > 64 ? r0->g->P : 64;
  // K_OPTION games can declare more options than seats
  {
    const Game& g = *r0->g;
    int i = r0->phase;
    if (g.ph(i, 4) == K_OPTION && g.ph(i, 5) > cap) cap = g.ph(i, 5);
  }
  cbuf.resize(cap);
  sbuf.resize(cap);
  int32_t n = search_scores_core(r0, pid, rollouts, max_steps, mode,
                                 team_slot, team_codes, n_codes, salt,
                                 cbuf.data(), sbuf.data(), cap);
  if (n < 0) return 1;  // forced submit
  if (n == 0) return 0;
  if (n == 1) return cbuf[0];
  int32_t best_c = 0;
  int64_t best_s = 0;
  bool any = false;
  for (int32_t j = 0; j < n; ++j) {
    if (!any || sbuf[j] > best_s) { best_s = sbuf[j]; best_c = cbuf[j]; any = true; }
  }
  return best_c;
}

// Per-candidate score totals for the information-set (determinized)
// search tier: policies/search.py samples hidden-state determinizations,
// scores every candidate in each sampled world with THIS call, and
// argmaxes the cross-world total. out_cands/out_scores are caller buffers
// of capacity cap. Returns the candidate count, 0 when this seat has no
// decision (or cap is too small), or -1 for a forced submit.
int32_t gs_room_search_scores(void* rh, int32_t pid, int32_t rollouts,
                              int32_t max_steps, int32_t mode,
                              int32_t team_slot, const int32_t* team_codes,
                              int32_t n_codes, uint32_t salt,
                              int32_t* out_cands, int64_t* out_scores,
                              int32_t cap) {
  return search_scores_core((Room*)rh, pid, rollouts, max_steps, mode,
                            team_slot, team_codes, n_codes, salt,
                            out_cands, out_scores, cap);
}

int64_t gs_state_size(void* gh) {
  auto* g = (Game*)gh;
  return 5 + (int64_t)g->P * (g->NB + g->NN + g->NS + g->NPD * g->P + g->NOD + 3);
}

void gs_room_read(void* rh, int32_t* out) {
  auto* r = (Room*)rh;
  const Game& g = *r->g;
  int64_t k = 0;
  out[k++] = r->phase; out[k++] = r->done ? 1 : 0; out[k++] = r->winner;
  out[k++] = r->prev; out[k++] = r->t;
  for (int p = 0; p < g.P; ++p) for (int b = 0; b < g.NB; ++b) out[k++] = r->bools[p * g.NB + b];
  for (int p = 0; p < g.P; ++p) for (int b = 0; b < g.NN; ++b) out[k++] = r->nums[p * g.NN + b];
  for (int p = 0; p < g.P; ++p) for (int b = 0; b < g.NS; ++b) out[k++] = r->strs[p * g.NS + b];
  for (int64_t x = 0; x < (int64_t)g.P * g.NPD * g.P; ++x) out[k++] = r->pdict[x];
  for (int64_t x = 0; x < (int64_t)g.P * g.NOD; ++x) out[k++] = r->odict[x];
  for (int p = 0; p < g.P; ++p) out[k++] = r->acted[p];
  for (int p = 0; p < g.P; ++p) out[k++] = r->choice[p];
  for (int p = 0; p < g.P; ++p) out[k++] = r->choice_phase[p];
}

// inverse of gs_room_read: restore a room from a serialized state buffer
// (journal-compaction snapshots restore rooms without replaying history).
void gs_room_write(void* rh, const int32_t* in) {
  auto* r = (Room*)rh;
  const Game& g = *r->g;
  int64_t k = 0;
  r->phase = in[k++];
  r->done = in[k++] != 0;
  r->winner = in[k++];
  r->prev = in[k++];
  r->t = in[k++];
  for (int p = 0; p < g.P; ++p) for (int b = 0; b < g.NB; ++b) r->bools[p * g.NB + b] = (uint8_t)in[k++];
  for (int p = 0; p < g.P; ++p) for (int b = 0; b < g.NN; ++b) r->nums[p * g.NN + b] = in[k++];
  for (int p = 0; p < g.P; ++p) for (int b = 0; b < g.NS; ++b) r->strs[p * g.NS + b] = in[k++];
  for (int64_t x = 0; x < (int64_t)g.P * g.NPD * g.P; ++x) r->pdict[x] = in[k++];
  for (int64_t x = 0; x < (int64_t)g.P * g.NOD; ++x) r->odict[x] = in[k++];
  for (int p = 0; p < g.P; ++p) r->acted[p] = (uint8_t)in[k++];
  for (int p = 0; p < g.P; ++p) r->choice[p] = in[k++];
  for (int p = 0; p < g.P; ++p) r->choice_phase[p] = in[k++];
}

// batched scripted self-play (auto-reset with the engine's seed bump);
// returns episodes. When out_states is non-null, each room's final
// gs_room_read image followed by its seed is written there: rooms rows of
// gs_state_size + 1 int32 (the differential check against the XLA rollout).
int64_t gs_selfplay(void* gh, int rooms, int n_players, uint32_t seed0, int steps,
                    int32_t* out_states) {
  auto* g = (Game*)gh;
  std::vector<Room> rs(rooms);
  for (int b = 0; b < rooms; ++b) room_init(*g, rs[b], n_players, seed0 + (uint32_t)b);
  std::vector<int32_t> acts(g->P);
  int64_t episodes = 0;
  for (int t = 0; t < steps; ++t) {
    for (int b = 0; b < rooms; ++b) {
      Room& r = rs[b];
      room_policy(*g, r, acts.data());
      room_step(*g, r, acts.data());
      if (r.done) {
        episodes++;
        room_init(*g, r, n_players, splitmix32(r.seed ^ 0xDECAF000u));
      }
    }
  }
  if (out_states) {
    const int64_t row = gs_state_size(gh) + 1;
    for (int b = 0; b < rooms; ++b) {
      gs_room_read(&rs[b], out_states + b * row);
      out_states[b * row + row - 1] = (int32_t)rs[b].seed;
    }
  }
  return episodes;
}

}  // extern "C"
