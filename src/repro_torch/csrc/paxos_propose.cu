// paxos_propose: the issuer select network of the batched serve path, one
// thread per session lane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paxos_propose/kernel.py:_paxos_propose_kernel
//   (launcher paxos_propose, pallas_call at :109),
// whose body is repro.core.proposer_vector.proposer_core; the plain PyTorch
// version here is repro_torch.core.proposer_vector.proposer_core, and the
// two must agree bit for bit (chip_smoke.py checks it on the card).
//
// One network, two entries.  propose_lane() is the network for one lane:
// the tally folds, the first-match-wins decision cascade (_prio order kept
// exactly: if/else chains in the reference's case order) and the emission
// muxes as straight-line code.  It reads 4 quorum parameters, 13 reply
// values and the table planes, and returns the 14 action values and the 44
// planes proposer_core changes (ChangedPlane); the other 21 (kPassThrough)
// it never changes.  Both kernels call it, so they cannot drift.
//
// * paxos_propose_kernel (paxos_propose_launch) is the whole-stack step the
//   TPU kernel is: (65, n) table + (13, n) replies + (4, M) parameters ->
//   (65, n) new table + (14, n) actions, out of place.  Bound: bytes (628 B
//   a lane), but at the serve path's 4000 lanes (2.5 MB, 0.75 us at 3.35
//   TB/s) launch latency sets its time.
// * paxos_propose_staged_kernel (paxos_propose_staged_launch) is what the
//   serve path runs.  proposer_core gates every update on rep.kind >= 0, so
//   an idle lane's table is unchanged and its decision is WAIT: only the
//   lanes a wave stages can change.  The kernel takes the wave's packed
//   (2 + 13, L) buffer (machine row, session lane, the 13 reply planes),
//   updates those L columns of the resident (65, M*S) table in place and
//   writes a compact (14 + 44, L) output (actions, then the changed
//   planes), so the whole issuer wave is one upload, this launch and one
//   download.  Bound: bytes (716 B a lane: coordinates, replies, the 62
//   planes read, 44 written back, 58 out), a few ns at a wave's ~19 lanes,
//   so launch latency and the coordinate -> table load chain set its time.
//   One thread a staged lane, blocks of 64 so a wave's few
//   lanes spread over SMs.  The table aliases the update, so it cannot be
//   __restrict__: every load is issued before any store.  At most one
//   staged entry per (row, lane): the wrapper checks the host coordinates
//   before the launch.
//
// Bit-exactness: lth_counter + 1 wraps through uint32_t like jnp int32;
// the per-source bit is 1 << clip(src, 0, 7); popcount8 is __popc of the
// low byte, which equals the reference's shift-and-mask sum for any int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Field order of repro_torch.core.proposer_vector.ProposerTable (and
// repro's); pinned by tests/test_torch_kernel_layout.py.
enum ProposerTable {
  TAB_phase, TAB_lid, TAB_aboard, TAB_helping, TAB_lth_counter,
  TAB_key, TAB_ts_v, TAB_ts_m, TAB_log_no,
  TAB_rmw_cnt, TAB_rmw_sess, TAB_value, TAB_has_value,
  TAB_base_v, TAB_base_m, TAB_val_log,
  TAB_rep_bits, TAB_ack_bits,
  TAB_rmw_flag, TAB_rmw_nb_flag, TAB_lth_flag,
  TAB_sh_has, TAB_sh_v, TAB_sh_m,
  TAB_ltl_has, TAB_ltl_log, TAB_ltl_cnt, TAB_ltl_sess,
  TAB_ltl_val, TAB_ltl_base_v, TAB_ltl_base_m, TAB_ltl_vlog,
  TAB_la_has, TAB_la_ts_v, TAB_la_ts_m, TAB_la_cnt,
  TAB_la_sess, TAB_la_val, TAB_la_base_v, TAB_la_base_m,
  TAB_la_vlog,
  TAB_fr_has, TAB_fr_val, TAB_fr_base_v, TAB_fr_base_m,
  TAB_fr_log,
  TAB_abd_phase, TAB_abd_lid, TAB_abd_key, TAB_abd_value,
  TAB_abd_rep_bits, TAB_abd_ack_bits, TAB_abd_store_bits,
  TAB_abd_maxb_v, TAB_abd_maxb_m,
  TAB_abd_sent_base_v, TAB_abd_sent_base_m, TAB_abd_sent_vlog,
  TAB_best_base_v, TAB_best_base_m, TAB_best_vlog,
  TAB_best_val, TAB_best_log, TAB_best_cnt, TAB_best_sess
};
constexpr int N_TAB = 65;

// Field order of IssuerReplyBatch.
enum IssuerReplyBatch {
  IRP_kind, IRP_opcode, IRP_src, IRP_lid, IRP_ts_v, IRP_ts_m, IRP_log_no,
  IRP_rmw_cnt, IRP_rmw_sess, IRP_value, IRP_base_v, IRP_base_m, IRP_val_log
};
constexpr int N_IRP = 13;

// Field order of ActionBatch.
enum ActionBatch {
  ACT_decision, ACT_bcast_kind, ACT_key, ACT_sh_has, ACT_ts_v, ACT_ts_m,
  ACT_log_no, ACT_rmw_cnt, ACT_rmw_sess, ACT_value, ACT_has_value,
  ACT_base_v, ACT_base_m, ACT_val_log
};
constexpr int N_ACT = 14;

// Quorum parameter rows of the (4, M) block.
enum Params { PAR_n_machines, PAR_majority, PAR_commit_need,
              PAR_log_too_high_threshold };
constexpr int N_PAR = 4;

static_assert(TAB_best_sess + 1 == N_TAB, "ProposerTable plane count");
static_assert(IRP_val_log + 1 == N_IRP, "IssuerReplyBatch plane count");
static_assert(ACT_val_log + 1 == N_ACT, "ActionBatch plane count");
static_assert(PAR_log_too_high_threshold + 1 == N_PAR, "param count");

// Values from repro_torch.core.types / repro_torch.core.proposer.
enum MsgKind {
  MK_COMMIT = 2, MK_PROP_REPLY = 3, MK_ACC_REPLY = 4, MK_COMMIT_ACK = 5,
  MK_WRITE_QUERY_REPLY = 7, MK_WRITE = 8, MK_WRITE_ACK = 9,
  MK_READ_QUERY_REPLY = 11, MK_READ_COMMIT = 12
};

enum Rep {
  REP_ACK = 0, REP_ACK_BASE_TS_STALE = 1, REP_RMW_ID_COMMITTED = 2,
  REP_RMW_ID_COMMITTED_NO_BCAST = 3, REP_LOG_TOO_LOW = 4,
  REP_LOG_TOO_HIGH = 5, REP_SEEN_HIGHER_PROP = 6, REP_SEEN_HIGHER_ACC = 7,
  REP_SEEN_LOWER_ACC = 8, REP_CARSTAMP_TOO_LOW = 9, REP_CARSTAMP_EQUAL = 10,
  REP_CARSTAMP_TOO_HIGH = 11
};

enum Phase { PH_IDLE = 0, PH_PROPOSED = 1, PH_ACCEPTED = 2,
             PH_COMMITTED = 3, PH_PAUSED = 4 };

// AbdPhase codes plus the ABD_PAUSED plane sentinel.
enum AbdPhase { AP_IDLE = 0, AP_W_QUERY = 1, AP_W_WRITE = 2,
                AP_R_QUERY = 3, AP_R_COMMIT = 4, AP_PAUSED = 9 };

enum Decision {
  D_WAIT = 0, D_LEARNED = 1, D_LEARNED_NO_BCAST = 2, D_LOG_TOO_LOW = 3,
  D_RETRY = 4, D_LOCAL_ACCEPT = 5, D_HELP = 6, D_HELP_SELF = 7,
  D_RETRY_LOG_TOO_HIGH = 8, D_RECOMMIT = 9, D_COMMIT_BCAST = 10,
  D_STOP_HELP = 11, D_COMMIT_DONE = 12, D_ABD_W2 = 13, D_ABD_W_DONE = 14,
  D_ABD_R_DONE = 15, D_ABD_R_WB = 16, D_ABD_RC_DONE = 17
};

// Planes the network passes through unchanged (ProposerTable._replace in
// proposer_core touches the other 44); pinned by
// tests/test_torch_kernel_layout.py against ops.PASS_THROUGH_FIELDS.
__constant__ int kPassThrough[] = {
  TAB_lid, TAB_aboard, TAB_helping, TAB_lth_counter, TAB_key, TAB_ts_v,
  TAB_ts_m, TAB_log_no, TAB_rmw_cnt, TAB_rmw_sess, TAB_value,
  TAB_has_value, TAB_base_v, TAB_base_m, TAB_val_log, TAB_abd_lid,
  TAB_abd_key, TAB_abd_value, TAB_abd_sent_base_v, TAB_abd_sent_base_m,
  TAB_abd_sent_vlog
};
constexpr int N_PASS = 21;

// The planes the network changes, in ProposerTable order: the order of the
// staged entry's compact output after the 14 actions (ops.CHANGED_FIELDS).
enum ChangedPlane {
  CHG_phase, CHG_rep_bits, CHG_ack_bits,
  CHG_rmw_flag, CHG_rmw_nb_flag, CHG_lth_flag,
  CHG_sh_has, CHG_sh_v, CHG_sh_m,
  CHG_ltl_has, CHG_ltl_log, CHG_ltl_cnt, CHG_ltl_sess,
  CHG_ltl_val, CHG_ltl_base_v, CHG_ltl_base_m, CHG_ltl_vlog,
  CHG_la_has, CHG_la_ts_v, CHG_la_ts_m, CHG_la_cnt,
  CHG_la_sess, CHG_la_val, CHG_la_base_v, CHG_la_base_m,
  CHG_la_vlog,
  CHG_fr_has, CHG_fr_val, CHG_fr_base_v, CHG_fr_base_m,
  CHG_fr_log,
  CHG_abd_phase,
  CHG_abd_rep_bits, CHG_abd_ack_bits, CHG_abd_store_bits,
  CHG_abd_maxb_v, CHG_abd_maxb_m,
  CHG_best_base_v, CHG_best_base_m, CHG_best_vlog,
  CHG_best_val, CHG_best_log, CHG_best_cnt, CHG_best_sess
};
constexpr int N_CHG = 44;
static_assert(CHG_best_sess + 1 == N_CHG, "changed plane count");
static_assert(N_CHG + N_PASS == N_TAB, "every plane changed or passed");

// ChangedPlane -> ProposerTable plane.
__constant__ int kChanged[] = {
  TAB_phase, TAB_rep_bits, TAB_ack_bits,
  TAB_rmw_flag, TAB_rmw_nb_flag, TAB_lth_flag,
  TAB_sh_has, TAB_sh_v, TAB_sh_m,
  TAB_ltl_has, TAB_ltl_log, TAB_ltl_cnt, TAB_ltl_sess,
  TAB_ltl_val, TAB_ltl_base_v, TAB_ltl_base_m, TAB_ltl_vlog,
  TAB_la_has, TAB_la_ts_v, TAB_la_ts_m, TAB_la_cnt,
  TAB_la_sess, TAB_la_val, TAB_la_base_v, TAB_la_base_m,
  TAB_la_vlog,
  TAB_fr_has, TAB_fr_val, TAB_fr_base_v, TAB_fr_base_m,
  TAB_fr_log,
  TAB_abd_phase,
  TAB_abd_rep_bits, TAB_abd_ack_bits, TAB_abd_store_bits,
  TAB_abd_maxb_v, TAB_abd_maxb_m,
  TAB_best_base_v, TAB_best_base_m, TAB_best_vlog,
  TAB_best_val, TAB_best_log, TAB_best_cnt, TAB_best_sess
};

__device__ __forceinline__ bool ts_gt(int av, int am, int bv, int bm) {
  return (bv < av) || ((bv == av) && (bm < am));
}

__device__ __forceinline__ bool cs_gt(int abv, int abm, int alog,
                                      int bbv, int bbm, int blog) {
  const bool base_eq = (abv == bbv) && (abm == bbm);
  return ts_gt(abv, abm, bbv, bbm) || (base_eq && (alog > blog));
}

__device__ __forceinline__ int popcount8(int x) { return __popc(x & 0xff); }

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) +
                          static_cast<uint32_t>(b));
}

// The select network of one lane.  p: quorum parameters (Params order),
// r: the steered reply (IssuerReplyBatch), t: the table (ProposerTable;
// the network never reads ts_v, ts_m or has_value).  Writes the actions
// (ActionBatch) and the changed planes (ChangedPlane).  Every index is a
// constant, so after inlining the arrays live in registers.
__device__ __forceinline__ void propose_lane(const int (&p)[N_PAR],
                                             const int (&r)[N_IRP],
                                             const int (&t)[N_TAB],
                                             int (&act)[N_ACT],
                                             int (&chg)[N_CHG]) {
  const int n_machines = p[PAR_n_machines];
  const int majority = p[PAR_majority];
  const int commit_need = p[PAR_commit_need];
  const int lth_threshold = p[PAR_log_too_high_threshold];

#define LD_T(f) const int t_##f = t[TAB_##f]
#define LD_R(f) const int r_##f = r[IRP_##f]
  LD_R(kind); LD_R(opcode); LD_R(src); LD_R(lid); LD_R(ts_v); LD_R(ts_m);
  LD_R(log_no); LD_R(rmw_cnt); LD_R(rmw_sess); LD_R(value); LD_R(base_v);
  LD_R(base_m); LD_R(val_log);
  LD_T(phase); LD_T(lid); LD_T(aboard); LD_T(helping); LD_T(lth_counter);
  LD_T(abd_phase); LD_T(abd_lid);

  // ---- steering (§3.1.2): lid + phase gates, COMMIT_ACK disambiguation
  const bool active = r_kind >= 0;
  const bool is_prop_rep = r_kind == MK_PROP_REPLY;
  const bool is_acc_rep = r_kind == MK_ACC_REPLY;
  const bool is_cack = r_kind == MK_COMMIT_ACK;
  const bool rmw_lid_ok = r_lid == t_lid;
  const bool to_prop = active && is_prop_rep && (t_phase == PH_PROPOSED) &&
                       rmw_lid_ok;
  const bool to_acc = active && is_acc_rep && (t_phase == PH_ACCEPTED) &&
                      rmw_lid_ok;
  const bool to_cmt = active && is_cack && (t_phase == PH_COMMITTED) &&
                      rmw_lid_ok;
  const bool abd_lid_ok = r_lid == t_abd_lid;
  const bool to_wq = active && (r_kind == MK_WRITE_QUERY_REPLY) &&
                     (t_abd_phase == AP_W_QUERY) && abd_lid_ok;
  const bool to_w = active && (r_kind == MK_WRITE_ACK) &&
                    (t_abd_phase == AP_W_WRITE) && abd_lid_ok;
  const bool to_rq = active && (r_kind == MK_READ_QUERY_REPLY) &&
                     (t_abd_phase == AP_R_QUERY) && abd_lid_ok;
  const bool to_rc = active && is_cack && !to_cmt &&
                     (t_abd_phase == AP_R_COMMIT) && abd_lid_ok;
  const bool to_rmw = to_prop || to_acc || to_cmt;

  const int src_c = r_src < 0 ? 0 : (r_src > 7 ? 7 : r_src);
  const int bit = 1 << src_c;

  // ---- RMW tally fold (Tally.note, vectorized)
  LD_T(rep_bits); LD_T(ack_bits);
  const bool is_ack_op =
      (r_opcode == REP_ACK) || (r_opcode == REP_ACK_BASE_TS_STALE);
  const int rep_bits = to_rmw ? (t_rep_bits | bit) : t_rep_bits;
  const int ack_bits = (to_rmw && is_ack_op) ? (t_ack_bits | bit) : t_ack_bits;

  LD_T(fr_has); LD_T(fr_val); LD_T(fr_base_v); LD_T(fr_base_m); LD_T(fr_log);
  const bool fr_upd = to_rmw && (r_opcode == REP_ACK_BASE_TS_STALE) &&
                      cs_gt(r_base_v, r_base_m, r_val_log,
                            t_fr_base_v, t_fr_base_m, t_fr_log);
  const int fr_has = fr_upd ? 1 : t_fr_has;
  const int fr_val = fr_upd ? r_value : t_fr_val;
  const int fr_base_v = fr_upd ? r_base_v : t_fr_base_v;
  const int fr_base_m = fr_upd ? r_base_m : t_fr_base_m;
  const int fr_log = fr_upd ? r_val_log : t_fr_log;

  LD_T(rmw_flag); LD_T(rmw_nb_flag); LD_T(lth_flag);
  const bool is_rmw_c = r_opcode == REP_RMW_ID_COMMITTED;
  const bool is_rmw_nb = r_opcode == REP_RMW_ID_COMMITTED_NO_BCAST;
  const int rmw_flag = (to_rmw && (is_rmw_c || is_rmw_nb)) ? 1 : t_rmw_flag;
  const int rmw_nb_flag = (to_rmw && is_rmw_nb) ? 1 : t_rmw_nb_flag;
  const int lth_flag =
      (to_rmw && (r_opcode == REP_LOG_TOO_HIGH)) ? 1 : t_lth_flag;

  LD_T(ltl_has); LD_T(ltl_log); LD_T(ltl_cnt); LD_T(ltl_sess);
  LD_T(ltl_val); LD_T(ltl_base_v); LD_T(ltl_base_m); LD_T(ltl_vlog);
  const bool ltl_upd = to_rmw && (r_opcode == REP_LOG_TOO_LOW) &&
                       ((t_ltl_has == 0) || (r_log_no > t_ltl_log));
  const int ltl_has = ltl_upd ? 1 : t_ltl_has;
  const int ltl_log = ltl_upd ? r_log_no : t_ltl_log;
  const int ltl_cnt = ltl_upd ? r_rmw_cnt : t_ltl_cnt;
  const int ltl_sess = ltl_upd ? r_rmw_sess : t_ltl_sess;
  const int ltl_val = ltl_upd ? r_value : t_ltl_val;
  const int ltl_base_v = ltl_upd ? r_base_v : t_ltl_base_v;
  const int ltl_base_m = ltl_upd ? r_base_m : t_ltl_base_m;
  const int ltl_vlog = ltl_upd ? r_val_log : t_ltl_vlog;

  LD_T(sh_has); LD_T(sh_v); LD_T(sh_m);
  const bool sh_upd = to_rmw &&
                      ((r_opcode == REP_SEEN_HIGHER_PROP) ||
                       (r_opcode == REP_SEEN_HIGHER_ACC)) &&
                      ((t_sh_has == 0) || ts_gt(r_ts_v, r_ts_m, t_sh_v, t_sh_m));
  const int sh_has = sh_upd ? 1 : t_sh_has;
  const int sh_v = sh_upd ? r_ts_v : t_sh_v;
  const int sh_m = sh_upd ? r_ts_m : t_sh_m;

  LD_T(la_has); LD_T(la_ts_v); LD_T(la_ts_m); LD_T(la_cnt); LD_T(la_sess);
  LD_T(la_val); LD_T(la_base_v); LD_T(la_base_m); LD_T(la_vlog);
  const bool la_upd = to_rmw && (r_opcode == REP_SEEN_LOWER_ACC) &&
                      ((t_la_has == 0) ||
                       ts_gt(r_ts_v, r_ts_m, t_la_ts_v, t_la_ts_m));
  const int la_has = la_upd ? 1 : t_la_has;
  const int la_ts_v = la_upd ? r_ts_v : t_la_ts_v;
  const int la_ts_m = la_upd ? r_ts_m : t_la_ts_m;
  const int la_cnt = la_upd ? r_rmw_cnt : t_la_cnt;
  const int la_sess = la_upd ? r_rmw_sess : t_la_sess;
  const int la_val = la_upd ? r_value : t_la_val;
  const int la_base_v = la_upd ? r_base_v : t_la_base_v;
  const int la_base_m = la_upd ? r_base_m : t_la_base_m;
  const int la_vlog = la_upd ? r_val_log : t_la_vlog;

  // ---- ABD fold (abd_fold, vectorized; §10–§11)
  LD_T(abd_rep_bits); LD_T(abd_ack_bits); LD_T(abd_store_bits);
  LD_T(abd_maxb_v); LD_T(abd_maxb_m);
  const int abd_rep_bits =
      (to_wq || to_rq) ? (t_abd_rep_bits | bit) : t_abd_rep_bits;
  const int abd_ack_bits =
      (to_w || to_rc) ? (t_abd_ack_bits | bit) : t_abd_ack_bits;
  const bool maxb_upd =
      to_wq && ts_gt(r_base_v, r_base_m, t_abd_maxb_v, t_abd_maxb_m);
  const int abd_maxb_v = maxb_upd ? r_base_v : t_abd_maxb_v;
  const int abd_maxb_m = maxb_upd ? r_base_m : t_abd_maxb_m;

  // §11 three-way carstamp fold
  LD_T(best_base_v); LD_T(best_base_m); LD_T(best_vlog); LD_T(best_val);
  LD_T(best_log); LD_T(best_cnt); LD_T(best_sess);
  LD_T(abd_sent_base_v); LD_T(abd_sent_base_m); LD_T(abd_sent_vlog);
  const bool rq_low = to_rq && (r_opcode == REP_CARSTAMP_TOO_LOW);
  const bool cs_better = cs_gt(r_base_v, r_base_m, r_val_log,
                               t_best_base_v, t_best_base_m, t_best_vlog);
  const bool cs_equal = (r_base_v == t_best_base_v) &&
                        (r_base_m == t_best_base_m) &&
                        (r_val_log == t_best_vlog);
  const bool new_best = rq_low && cs_better;
  const bool add_store = rq_low && !cs_better && cs_equal;
  const bool best_is_sent = (t_best_base_v == t_abd_sent_base_v) &&
                            (t_best_base_m == t_abd_sent_base_m) &&
                            (t_best_vlog == t_abd_sent_vlog);
  const bool eq_store =
      to_rq && (r_opcode == REP_CARSTAMP_EQUAL) && best_is_sent;
  const int best_base_v = new_best ? r_base_v : t_best_base_v;
  const int best_base_m = new_best ? r_base_m : t_best_base_m;
  const int best_vlog = new_best ? r_val_log : t_best_vlog;
  const int best_val = new_best ? r_value : t_best_val;
  const int best_log = new_best ? r_log_no : t_best_log;
  const int best_cnt = new_best ? r_rmw_cnt : t_best_cnt;
  const int best_sess = new_best ? r_rmw_sess : t_best_sess;
  const int abd_store_bits =
      new_best ? bit
               : ((add_store || eq_store) ? (t_abd_store_bits | bit)
                                          : t_abd_store_bits);

  // ---- decisions (decide_propose / decide_accept / decide_commit)
  LD_T(rmw_cnt); LD_T(rmw_sess);
  const int acks = popcount8(ack_bits);
  const int total = popcount8(rep_bits);
  const bool any_rmw = rmw_flag == 1;
  const bool any_ltl = ltl_has == 1;
  const bool any_sh = sh_has == 1;
  const bool any_lth = lth_flag == 1;
  const int learned = (rmw_nb_flag == 1) ? D_LEARNED_NO_BCAST : D_LEARNED;

  const bool p_trig =
      to_prop && (any_rmw || any_ltl || any_sh || (total >= majority));
  const bool help_self = (la_cnt == t_rmw_cnt) && (la_sess == t_rmw_sess);
  const int help_d = help_self ? D_HELP_SELF : D_HELP;
  const int lth_d = (wrap_add(t_lth_counter, 1) >= lth_threshold)
                        ? D_RECOMMIT : D_RETRY_LOG_TOO_HIGH;
  int p_decision = D_WAIT;
  if (p_trig && any_rmw) p_decision = learned;
  else if (p_trig && any_ltl) p_decision = D_LOG_TOO_LOW;
  else if (p_trig && any_sh) p_decision = D_RETRY;
  else if (p_trig && (acks >= majority)) p_decision = D_LOCAL_ACCEPT;
  else if (p_trig && (la_has == 1)) p_decision = help_d;
  else if (p_trig && any_lth) p_decision = lth_d;

  const bool helping = t_helping == 1;
  const bool aboard = t_aboard == 1;
  const bool any_nack = any_rmw || any_ltl || any_sh || any_lth;
  const bool a_trig = to_acc && (any_rmw || any_ltl || (total >= majority) ||
                                 ((helping || aboard) && any_nack));
  const int need = aboard ? n_machines : majority;
  const int a_learned = helping ? D_STOP_HELP : learned;
  const int a_nack_d = helping ? D_STOP_HELP : D_RETRY;
  int a_decision = D_WAIT;
  if (a_trig && any_rmw) a_decision = a_learned;
  else if (a_trig && any_ltl) a_decision = D_LOG_TOO_LOW;
  else if (a_trig && (acks >= need)) a_decision = D_COMMIT_BCAST;
  else if (a_trig && any_nack) a_decision = a_nack_d;

  const bool c_done = to_cmt && (acks >= commit_need);

  const int abd_reps = popcount8(abd_rep_bits);
  const int abd_acks = popcount8(abd_ack_bits);
  const int stores = popcount8(abd_store_bits);
  const bool w2 = to_wq && (abd_reps >= majority);
  const bool w_done = to_w && (abd_acks + 1 >= majority);
  const bool r_maj = to_rq && (abd_reps >= majority);
  const bool r_done = r_maj && (stores >= majority);
  const bool r_wb = r_maj && !r_done;
  const bool rc_done = to_rc && (abd_acks + 1 >= majority);

  int decision = D_WAIT;
  if (to_prop) decision = p_decision;
  else if (to_acc) decision = a_decision;
  else if (c_done) decision = D_COMMIT_DONE;
  else if (w2) decision = D_ABD_W2;
  else if (w_done) decision = D_ABD_W_DONE;
  else if (r_done) decision = D_ABD_R_DONE;
  else if (r_wb) decision = D_ABD_R_WB;
  else if (rc_done) decision = D_ABD_RC_DONE;
  const bool rmw_decided = (to_prop || to_acc || to_cmt) && (decision != D_WAIT);
  const bool abd_decided =
      (to_wq || to_w || to_rq || to_rc) && (decision != D_WAIT);

  // ---- actions (the emission muxes; first match wins as in _prio)
  LD_T(key); LD_T(log_no); LD_T(value); LD_T(base_v); LD_T(base_m);
  LD_T(val_log); LD_T(abd_key); LD_T(abd_value);
  const bool is_retry = decision == D_RETRY;
  const bool is_ltl_d = decision == D_LOG_TOO_LOW;
  const bool is_help = (decision == D_HELP) || (decision == D_HELP_SELF);
  const bool is_cb = decision == D_COMMIT_BCAST;
  const bool is_w2 = decision == D_ABD_W2;
  const bool is_rwb = decision == D_ABD_R_WB;
  const bool thin = is_cb && (acks >= n_machines);   // §8.6 thin commit

  const int bcast_kind = is_cb ? MK_COMMIT
                       : is_w2 ? MK_WRITE
                       : is_rwb ? MK_READ_COMMIT : -1;
  const int act_key = is_cb ? t_key : ((is_w2 || is_rwb) ? t_abd_key : 0);
  const int act_sh_has = is_retry ? sh_has : 0;
  const int act_ts_v = (is_retry && (sh_has == 1)) ? sh_v
                     : is_help ? la_ts_v : 0;
  const int act_ts_m = is_retry ? ((sh_has == 1) ? sh_m : -1)
                     : is_help ? la_ts_m : 0;
  const int act_log = is_ltl_d ? ltl_log : is_cb ? t_log_no
                    : is_rwb ? best_log : 0;
  const int act_rmw_cnt = is_ltl_d ? ltl_cnt : is_help ? la_cnt
                        : is_cb ? t_rmw_cnt : is_rwb ? best_cnt : 0;
  const int act_rmw_sess = is_ltl_d ? ltl_sess : is_help ? la_sess
                         : is_cb ? t_rmw_sess : is_rwb ? best_sess : 0;
  const int act_value = is_ltl_d ? ltl_val : is_help ? la_val
                      : is_cb ? (thin ? 0 : t_value)
                      : is_w2 ? t_abd_value : is_rwb ? best_val : 0;
  const int act_has_value = is_cb ? (thin ? 0 : 1) : 0;
  const int act_base_v = is_ltl_d ? ltl_base_v : is_help ? la_base_v
                       : is_cb ? t_base_v : is_w2 ? abd_maxb_v
                       : is_rwb ? best_base_v : 0;
  const int act_base_m = is_ltl_d ? ltl_base_m : is_help ? la_base_m
                       : is_cb ? t_base_m : is_w2 ? abd_maxb_m
                       : is_rwb ? best_base_m : 0;
  const int act_val_log = is_ltl_d ? ltl_vlog : is_help ? la_vlog
                        : is_cb ? t_val_log : is_rwb ? best_vlog : 0;
#undef LD_T
#undef LD_R


#define ST_A(f, v) act[ACT_##f] = (v)
  ST_A(decision, decision); ST_A(bcast_kind, bcast_kind);
  ST_A(key, act_key); ST_A(sh_has, act_sh_has); ST_A(ts_v, act_ts_v);
  ST_A(ts_m, act_ts_m); ST_A(log_no, act_log); ST_A(rmw_cnt, act_rmw_cnt);
  ST_A(rmw_sess, act_rmw_sess); ST_A(value, act_value);
  ST_A(has_value, act_has_value); ST_A(base_v, act_base_v);
  ST_A(base_m, act_base_m); ST_A(val_log, act_val_log);
#undef ST_A

  // ---- park decided lanes until the host starts their next round
#define ST_T(f, v) chg[CHG_##f] = (v)
  ST_T(phase, rmw_decided ? PH_PAUSED : t_phase);
  ST_T(abd_phase, abd_decided ? AP_PAUSED : t_abd_phase);
  ST_T(rep_bits, rep_bits); ST_T(ack_bits, ack_bits);
  ST_T(rmw_flag, rmw_flag); ST_T(rmw_nb_flag, rmw_nb_flag);
  ST_T(lth_flag, lth_flag);
  ST_T(sh_has, sh_has); ST_T(sh_v, sh_v); ST_T(sh_m, sh_m);
  ST_T(ltl_has, ltl_has); ST_T(ltl_log, ltl_log); ST_T(ltl_cnt, ltl_cnt);
  ST_T(ltl_sess, ltl_sess); ST_T(ltl_val, ltl_val);
  ST_T(ltl_base_v, ltl_base_v); ST_T(ltl_base_m, ltl_base_m);
  ST_T(ltl_vlog, ltl_vlog);
  ST_T(la_has, la_has); ST_T(la_ts_v, la_ts_v); ST_T(la_ts_m, la_ts_m);
  ST_T(la_cnt, la_cnt); ST_T(la_sess, la_sess); ST_T(la_val, la_val);
  ST_T(la_base_v, la_base_v); ST_T(la_base_m, la_base_m);
  ST_T(la_vlog, la_vlog);
  ST_T(fr_has, fr_has); ST_T(fr_val, fr_val); ST_T(fr_base_v, fr_base_v);
  ST_T(fr_base_m, fr_base_m); ST_T(fr_log, fr_log);
  ST_T(abd_rep_bits, abd_rep_bits); ST_T(abd_ack_bits, abd_ack_bits);
  ST_T(abd_store_bits, abd_store_bits);
  ST_T(abd_maxb_v, abd_maxb_v); ST_T(abd_maxb_m, abd_maxb_m);
  ST_T(best_base_v, best_base_v); ST_T(best_base_m, best_base_m);
  ST_T(best_vlog, best_vlog); ST_T(best_val, best_val);
  ST_T(best_log, best_log); ST_T(best_cnt, best_cnt);
  ST_T(best_sess, best_sess);
#undef ST_T
}

// The whole-stack step: every lane of the (65, n) stack, out of place.
__global__ void __launch_bounds__(256)
paxos_propose_kernel(const int32_t* __restrict__ tab,
                     const int32_t* __restrict__ rep,
                     const int32_t* __restrict__ params,
                     int32_t* __restrict__ tab_out,
                     int32_t* __restrict__ act_out,
                     int64_t n, int64_t lanes_per_row) {
  const int64_t m_rows = n / lanes_per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t row = i / lanes_per_row;
    int p[N_PAR], r[N_IRP], t[N_TAB], act[N_ACT], chg[N_CHG];
#pragma unroll
    for (int k = 0; k < N_PAR; ++k) p[k] = params[k * m_rows + row];
#pragma unroll
    for (int k = 0; k < N_IRP; ++k) r[k] = rep[k * n + i];
#pragma unroll
    for (int f = 0; f < N_TAB; ++f) t[f] = tab[f * n + i];
    propose_lane(p, r, t, act, chg);
#pragma unroll
    for (int k = 0; k < N_ACT; ++k) act_out[k * n + i] = act[k];
#pragma unroll
    for (int k = 0; k < N_CHG; ++k) tab_out[kChanged[k] * n + i] = chg[k];
#pragma unroll
    for (int k = 0; k < N_PASS; ++k) {
      const int64_t off = static_cast<int64_t>(kPassThrough[k]) * n + i;
      tab_out[off] = tab[off];
    }
  }
}

constexpr int kStagedThreads = 64;

// The staged step: L lanes of the resident (65, m_rows * lanes_per_row)
// table, in place; staged (2 + 13, L), out (14 + 44, L).
__global__ void __launch_bounds__(kStagedThreads)
paxos_propose_staged_kernel(int32_t* tab,
                            const int32_t* __restrict__ staged,
                            const int32_t* __restrict__ params,
                            int32_t* __restrict__ out,
                            int64_t m_rows, int64_t lanes_per_row,
                            int64_t n_staged) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n_staged) return;
  const int64_t n = m_rows * lanes_per_row;
  const int mi = staged[j];
  const int64_t i = static_cast<int64_t>(mi) * lanes_per_row +
                    staged[n_staged + j];
  // every load before any store: tab is written in place, so a load the
  // compiler left behind a store to it would wait for that store
  int p[N_PAR], r[N_IRP], t[N_TAB], act[N_ACT], chg[N_CHG];
#pragma unroll
  for (int k = 0; k < N_IRP; ++k) r[k] = staged[(2 + k) * n_staged + j];
#pragma unroll
  for (int k = 0; k < N_PAR; ++k) p[k] = params[k * m_rows + mi];
#pragma unroll
  for (int f = 0; f < N_TAB; ++f) t[f] = tab[f * n + i];
  propose_lane(p, r, t, act, chg);
#pragma unroll
  for (int k = 0; k < N_ACT; ++k) out[k * n_staged + j] = act[k];
#pragma unroll
  for (int k = 0; k < N_CHG; ++k) {
    out[(N_ACT + k) * n_staged + j] = chg[k];
    tab[kChanged[k] * n + i] = chg[k];
  }
}

}  // namespace

// Plain C entry for ctypes.  tab (65,n), rep (13,n), params (4, n/S) ->
// tab_out (65,n), act_out (14,n), all contiguous int32 on the device, lane
// i reading parameter column i / S; launched on `stream`.  Returns
// cudaGetLastError() of the launch.
extern "C" int paxos_propose_launch(const void* tab, const void* rep,
                                    const void* params, void* tab_out,
                                    void* act_out, int64_t n,
                                    int64_t lanes_per_row, void* stream) {
  if (n <= 0) return 0;
  if (lanes_per_row <= 0 || n % lanes_per_row != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  paxos_propose_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), static_cast<const int32_t*>(rep),
      static_cast<const int32_t*>(params), static_cast<int32_t*>(tab_out),
      static_cast<int32_t*>(act_out), n, lanes_per_row);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry for ctypes.  tab (65, m_rows * lanes_per_row), updated in
// place at the staged lanes; staged (2 + 13, n_staged): machine row, session
// lane, then the 13 reply planes; params (4, m_rows); out (14 + 44,
// n_staged): the actions, then the changed planes.  All contiguous int32 on
// the device, at most one staged entry per (row, lane), rows and lanes in
// range (the caller checks); launched on `stream`.  n_staged == 0 launches
// nothing.  Returns cudaGetLastError() of the launch.
extern "C" int paxos_propose_staged_launch(void* tab, const void* staged,
                                           const void* params, void* out,
                                           int64_t m_rows,
                                           int64_t lanes_per_row,
                                           int64_t n_staged, void* stream) {
  if (n_staged <= 0) return 0;
  if (m_rows <= 0 || lanes_per_row <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_staged + kStagedThreads - 1) / kStagedThreads;
  paxos_propose_staged_kernel<<<static_cast<unsigned>(blocks),
                                kStagedThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(tab), static_cast<const int32_t*>(staged),
      static_cast<const int32_t*>(params), static_cast<int32_t*>(out),
      m_rows, lanes_per_row, n_staged);
  return static_cast<int>(cudaGetLastError());
}
