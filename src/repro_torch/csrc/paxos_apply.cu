// paxos_apply: the receiver select network of the batched serve path, one
// thread per key lane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paxos_apply/kernel.py:_paxos_apply_kernel (launcher
//   paxos_apply, pallas_call at :93),
// whose body is repro.core.vector.apply_batch; the plain PyTorch version
// here is repro_torch.core.vector.apply_batch, and the two must agree bit
// for bit (chip_smoke.py checks it on the card).
//
// Bound: memory.  Per lane the kernel reads 18 KV planes + 11 message
// planes + the is_registered plane (120 B) and writes 18 KV planes + 11
// reply planes + the register mask (120 B): 240 B a lane against a few
// hundred integer operations.  At M=5 replicas x K=2^20 key lanes a call
// moves 1.26 GB, 0.38 ms at the H100's 3.35 TB/s.
//
// Design: the planes stay in the fused engine's packed (F, n) stacks
// (field stride n = M*K), so the kernel reads the resident (18,M,K) KV
// stack and the (12,M,K) message+registry staging stack in place, with no
// per-plane pointers and no padding: the grid-stride loop masks the ragged
// end by the lane index.  Each thread loads its 30 inputs with coalesced
// 4-byte loads (neighbouring threads, neighbouring lanes), runs
// apply_batch's network as straight-line selects and stores its 30
// outputs.  The output stacks are distinct buffers (no in-place update).
//
// Bit-exactness: jnp int32 arithmetic wraps, C++ signed overflow is
// undefined, so the one increment (last_log + 1) goes through uint32_t.
// The bool/int distinction of the reference is kept: predicates are bool,
// planes are int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Field order of repro_torch.core.vector.KVTable (and repro's); pinned by
// tests/test_torch_kernel_layout.py.
enum KVTable {
  KV_state, KV_log_no, KV_last_log, KV_prop_v, KV_prop_m, KV_acc_v,
  KV_acc_m, KV_acc_val, KV_acc_base_v, KV_acc_base_m, KV_rmw_cnt,
  KV_rmw_sess, KV_value, KV_base_v, KV_base_m, KV_val_log,
  KV_last_rmw_cnt, KV_last_rmw_sess
};
constexpr int N_KV = 18;

// Field order of MsgBatch; the staging stack carries is_registered as a
// 12th plane right after the message planes.
enum MsgBatch {
  MSG_kind, MSG_ts_v, MSG_ts_m, MSG_log_no, MSG_rmw_cnt, MSG_rmw_sess,
  MSG_value, MSG_base_v, MSG_base_m, MSG_val_log, MSG_has_value
};
constexpr int N_MSG = 11;
constexpr int MSGREG_is_registered = N_MSG;

// Field order of ReplyBatch.
enum ReplyBatch {
  RPL_kind, RPL_opcode, RPL_ts_v, RPL_ts_m, RPL_log_no, RPL_rmw_cnt,
  RPL_rmw_sess, RPL_value, RPL_base_v, RPL_base_m, RPL_val_log
};
constexpr int N_RPL = 11;

static_assert(KV_last_rmw_sess + 1 == N_KV, "KVTable plane count");
static_assert(MSG_has_value + 1 == N_MSG, "MsgBatch plane count");
static_assert(RPL_val_log + 1 == N_RPL, "ReplyBatch plane count");

// Vector lane kinds (repro_torch.core.vector NOOP..READ_COMMIT).
enum LaneKind {
  LK_NOOP = 0, LK_PROPOSE = 1, LK_ACCEPT = 2, LK_COMMIT = 3,
  LK_WRITE_QUERY = 4, LK_WRITE = 5, LK_READ_QUERY = 6, LK_READ_COMMIT = 7
};

// KVState, Rep and MsgKind values from repro_torch.core.types.
enum KVState { KVS_INVALID = 0, KVS_PROPOSED = 1, KVS_ACCEPTED = 2 };

enum Rep {
  REP_ACK = 0, REP_ACK_BASE_TS_STALE = 1, REP_RMW_ID_COMMITTED = 2,
  REP_RMW_ID_COMMITTED_NO_BCAST = 3, REP_LOG_TOO_LOW = 4,
  REP_LOG_TOO_HIGH = 5, REP_SEEN_HIGHER_PROP = 6, REP_SEEN_HIGHER_ACC = 7,
  REP_SEEN_LOWER_ACC = 8, REP_CARSTAMP_TOO_LOW = 9, REP_CARSTAMP_EQUAL = 10,
  REP_CARSTAMP_TOO_HIGH = 11
};

enum MsgKind {
  MK_PROP_REPLY = 3, MK_ACC_REPLY = 4, MK_COMMIT_ACK = 5,
  MK_WRITE_QUERY_REPLY = 7, MK_WRITE_ACK = 9, MK_READ_QUERY_REPLY = 11
};

__device__ __forceinline__ bool ts_lt(int av, int am, int bv, int bm) {
  return (av < bv) || ((av == bv) && (am < bm));
}

__device__ __forceinline__ bool ts_gt(int av, int am, int bv, int bm) {
  return ts_lt(bv, bm, av, am);
}

__device__ __forceinline__ bool cs_gt(int abv, int abm, int alog,
                                      int bbv, int bbm, int blog) {
  const bool base_eq = (abv == bbv) && (abm == bbm);
  return ts_gt(abv, abm, bbv, bbm) || (base_eq && (alog > blog));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) +
                          static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(256)
paxos_apply_kernel(const int32_t* __restrict__ kv,
                   const int32_t* __restrict__ msgreg,
                   int32_t* __restrict__ kv_out,
                   int32_t* __restrict__ rep_out,
                   int32_t* __restrict__ mask_out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
#define LD_KV(f) const int k_##f = kv[static_cast<int64_t>(KV_##f) * n + i]
#define LD_MSG(f) const int m_##f = msgreg[static_cast<int64_t>(MSG_##f) * n + i]
    LD_KV(state); LD_KV(log_no); LD_KV(last_log); LD_KV(prop_v);
    LD_KV(prop_m); LD_KV(acc_v); LD_KV(acc_m); LD_KV(acc_val);
    LD_KV(acc_base_v); LD_KV(acc_base_m); LD_KV(rmw_cnt); LD_KV(rmw_sess);
    LD_KV(value); LD_KV(base_v); LD_KV(base_m); LD_KV(val_log);
    LD_KV(last_rmw_cnt); LD_KV(last_rmw_sess);
    LD_MSG(kind); LD_MSG(ts_v); LD_MSG(ts_m); LD_MSG(log_no);
    LD_MSG(rmw_cnt); LD_MSG(rmw_sess); LD_MSG(value); LD_MSG(base_v);
    LD_MSG(base_m); LD_MSG(val_log); LD_MSG(has_value);
#undef LD_KV
#undef LD_MSG
    const bool is_reg =
        msgreg[static_cast<int64_t>(MSGREG_is_registered) * n + i] != 0;

    const bool is_prop_msg = m_kind == LK_PROPOSE;
    const bool is_acc_msg = m_kind == LK_ACCEPT;
    const bool is_commit = (m_kind == LK_COMMIT) || (m_kind == LK_READ_COMMIT);
    const bool is_wq = m_kind == LK_WRITE_QUERY;
    const bool is_w = m_kind == LK_WRITE;
    const bool is_rq = m_kind == LK_READ_QUERY;
    const bool active = m_kind != LK_NOOP;
    const bool pa = is_prop_msg || is_acc_msg;

    // ---- common prefix: rmw-id + log window checks (§4.2)
    const bool registered = pa && is_reg;
    const bool committed_no_bcast = registered && (k_last_log >= m_log_no);
    const bool r_rmw_committed = registered && !committed_no_bcast;
    const bool not_reg = pa && !registered;
    const bool r_log_too_low = not_reg && (m_log_no <= k_last_log);
    const bool r_log_too_high = not_reg && !r_log_too_low &&
                                (m_log_no > wrap_add(k_last_log, 1));
    const bool in_window = not_reg && !r_log_too_low && !r_log_too_high;

    const bool st_prop = k_state == KVS_PROPOSED;
    const bool st_acc = k_state == KVS_ACCEPTED;

    // proposes block on >=, accepts only on > (§4.5)
    const bool prop_blocks_prop = !ts_lt(k_prop_v, k_prop_m, m_ts_v, m_ts_m);
    const bool prop_blocks_acc = ts_gt(k_prop_v, k_prop_m, m_ts_v, m_ts_m);

    // ---- propose path (§4.2, §8.3, §10.3)
    const bool p = in_window && is_prop_msg;
    const bool p_seen_higher_prop = p && st_prop && prop_blocks_prop;
    const bool p_seen_higher_acc = p && st_acc && prop_blocks_prop;
    const bool same_rmw = (k_rmw_cnt == m_rmw_cnt) && (k_rmw_sess == m_rmw_sess);
    const bool p_fast = p && st_acc && !prop_blocks_prop && same_rmw &&
                        ts_lt(k_acc_v, k_acc_m, m_ts_v, m_ts_m);
    const bool p_seen_lower_acc = p && st_acc && !prop_blocks_prop && !p_fast;
    const bool p_ack_fresh = p && !st_prop && !st_acc;
    const bool p_ack_prop = p && st_prop && !prop_blocks_prop;
    const bool p_ack = p_ack_fresh || p_ack_prop || p_fast;
    const bool base_stale =
        cs_gt(k_base_v, k_base_m, k_val_log, m_base_v, m_base_m, m_val_log);
    const bool p_ack_stale = p_ack && base_stale;

    // ---- accept path (§4.5)
    const bool a = in_window && is_acc_msg;
    const bool a_seen_higher_prop = a && st_prop && prop_blocks_acc;
    const bool a_aboard_conflict = a && (m_ts_v == 2) && st_acc &&
                                   (k_acc_v == 2) && !same_rmw &&
                                   !prop_blocks_acc;
    const bool a_seen_higher_acc =
        (a && st_acc && prop_blocks_acc) || a_aboard_conflict;
    const bool a_ack = a && !(a_seen_higher_prop || a_seen_higher_acc);

    // ---- commit path (§4.7, §8.6 thin commits)
    const bool c = is_commit;
    const bool thin = c && (m_has_value == 0);
    const bool thin_resolvable =
        thin && st_acc && same_rmw && (k_log_no == m_log_no);
    const int c_value = thin ? k_acc_val : m_value;
    const int c_base_v = thin ? k_acc_base_v : m_base_v;
    const int c_base_m = thin ? k_acc_base_m : m_base_m;
    const bool c_has_value = c && (!thin || thin_resolvable);
    const bool c_log_adv = c && (m_log_no > k_last_log);
    const bool c_install = c_has_value && cs_gt(c_base_v, c_base_m, m_val_log,
                                                k_base_v, k_base_m, k_val_log);
    const bool c_release = c && (k_state != KVS_INVALID) && (k_log_no <= m_log_no);

    // ---- ABD write lane (§10)
    const bool w_install =
        is_w && cs_gt(m_base_v, m_base_m, 0, k_base_v, k_base_m, k_val_log);

    // ---- ABD read-query lane (§11)
    const bool rq_low =
        is_rq && cs_gt(k_base_v, k_base_m, k_val_log, m_base_v, m_base_m, m_val_log);
    const bool rq_eq = is_rq && (m_base_v == k_base_v) && (m_base_m == k_base_m) &&
                       (m_val_log == k_val_log);
    const bool rq_high = is_rq && !rq_low && !rq_eq;

    // ---- new KV state
    const bool grab = p_ack_fresh || p_ack_prop;
    const bool adv_prop_ts = grab || p_seen_lower_acc || p_fast || a_ack;
    int new_state = k_state;
    if (grab) new_state = KVS_PROPOSED;
    if (a_ack) new_state = KVS_ACCEPTED;
    if (c_release) new_state = KVS_INVALID;

    const int new_log_no = (grab || a_ack) ? m_log_no : k_log_no;
    int new_prop_v = adv_prop_ts ? m_ts_v : k_prop_v;
    int new_prop_m = adv_prop_ts ? m_ts_m : k_prop_m;
    int new_acc_v = a_ack ? m_ts_v : k_acc_v;
    int new_acc_m = a_ack ? m_ts_m : k_acc_m;
    const bool clr = c_release && c_has_value;
    if (clr) {
      new_prop_v = 0;
      new_prop_m = -1;
      new_acc_v = 0;
      new_acc_m = -1;
    }
    const int new_acc_val = a_ack ? m_value : k_acc_val;
    const int new_acc_base_v = a_ack ? m_base_v : k_acc_base_v;
    const int new_acc_base_m = a_ack ? m_base_m : k_acc_base_m;
    const int new_rmw_cnt = (grab || a_ack) ? m_rmw_cnt : k_rmw_cnt;
    const int new_rmw_sess = (grab || a_ack) ? m_rmw_sess : k_rmw_sess;

    int new_value = c_install ? c_value : k_value;
    int new_base_v = c_install ? c_base_v : k_base_v;
    int new_base_m = c_install ? c_base_m : k_base_m;
    int new_val_log = c_install ? m_val_log : k_val_log;
    if (w_install) {
      new_value = m_value;
      new_base_v = m_base_v;
      new_base_m = m_base_m;
      new_val_log = 0;
    }
    const int new_last_log = c_log_adv ? m_log_no : k_last_log;
    const int new_last_rmw_cnt = c_log_adv ? m_rmw_cnt : k_last_rmw_cnt;
    const int new_last_rmw_sess = c_log_adv ? m_rmw_sess : k_last_rmw_sess;

#define ST_KV(f, v) kv_out[static_cast<int64_t>(KV_##f) * n + i] = (v)
    ST_KV(state, new_state); ST_KV(log_no, new_log_no);
    ST_KV(last_log, new_last_log); ST_KV(prop_v, new_prop_v);
    ST_KV(prop_m, new_prop_m); ST_KV(acc_v, new_acc_v);
    ST_KV(acc_m, new_acc_m); ST_KV(acc_val, new_acc_val);
    ST_KV(acc_base_v, new_acc_base_v); ST_KV(acc_base_m, new_acc_base_m);
    ST_KV(rmw_cnt, new_rmw_cnt); ST_KV(rmw_sess, new_rmw_sess);
    ST_KV(value, new_value); ST_KV(base_v, new_base_v);
    ST_KV(base_m, new_base_m); ST_KV(val_log, new_val_log);
    ST_KV(last_rmw_cnt, new_last_rmw_cnt);
    ST_KV(last_rmw_sess, new_last_rmw_sess);
#undef ST_KV

    // ---- replies: later assignments win, as the reference's where-chain
    int op = -1;
    if (r_rmw_committed) op = REP_RMW_ID_COMMITTED;
    if (committed_no_bcast) op = REP_RMW_ID_COMMITTED_NO_BCAST;
    if (r_log_too_low) op = REP_LOG_TOO_LOW;
    if (r_log_too_high) op = REP_LOG_TOO_HIGH;
    if (p_seen_higher_prop || a_seen_higher_prop) op = REP_SEEN_HIGHER_PROP;
    if (p_seen_higher_acc || a_seen_higher_acc) op = REP_SEEN_HIGHER_ACC;
    if (p_seen_lower_acc) op = REP_SEEN_LOWER_ACC;
    if (p_ack || a_ack) op = REP_ACK;
    if (p_ack_stale) op = REP_ACK_BASE_TS_STALE;
    if (c || is_wq || is_w) op = REP_ACK;
    if (rq_low) op = REP_CARSTAMP_TOO_LOW;
    if (rq_eq) op = REP_CARSTAMP_EQUAL;
    if (rq_high) op = REP_CARSTAMP_TOO_HIGH;
    if (!active) op = -1;

    int rep_kind = -1;
    switch (m_kind) {
      case LK_PROPOSE: rep_kind = MK_PROP_REPLY; break;
      case LK_ACCEPT: rep_kind = MK_ACC_REPLY; break;
      case LK_COMMIT: rep_kind = MK_COMMIT_ACK; break;
      case LK_WRITE_QUERY: rep_kind = MK_WRITE_QUERY_REPLY; break;
      case LK_WRITE: rep_kind = MK_WRITE_ACK; break;
      case LK_READ_QUERY: rep_kind = MK_READ_QUERY_REPLY; break;
      case LK_READ_COMMIT: rep_kind = MK_COMMIT_ACK; break;
      default: break;
    }

    const bool seen_higher = p_seen_higher_prop || p_seen_higher_acc ||
                             a_seen_higher_prop || a_seen_higher_acc;
    const int rep_ts_v =
        seen_higher ? k_prop_v : (p_seen_lower_acc ? k_acc_v : 0);
    const int rep_ts_m =
        seen_higher ? k_prop_m : (p_seen_lower_acc ? k_acc_m : 0);
    const bool local_val = r_log_too_low || p_ack_stale || rq_low;
    const bool ltl_or_rq = r_log_too_low || rq_low;
    const int rep_log = ltl_or_rq ? k_last_log : 0;
    const int rep_rmw_cnt =
        ltl_or_rq ? k_last_rmw_cnt : (p_seen_lower_acc ? k_rmw_cnt : 0);
    const int rep_rmw_sess =
        ltl_or_rq ? k_last_rmw_sess : (p_seen_lower_acc ? k_rmw_sess : -1);
    const int rep_value =
        local_val ? k_value : (p_seen_lower_acc ? k_acc_val : 0);
    const int rep_base_v = (local_val || is_wq)
                               ? k_base_v
                               : (p_seen_lower_acc ? k_acc_base_v : 0);
    const int rep_base_m = (local_val || is_wq)
                               ? k_base_m
                               : (p_seen_lower_acc ? k_acc_base_m : 0);
    const int rep_val_log =
        local_val ? k_val_log : (p_seen_lower_acc ? m_log_no : 0);

#define ST_RPL(f, v) rep_out[static_cast<int64_t>(RPL_##f) * n + i] = (v)
    ST_RPL(kind, rep_kind); ST_RPL(opcode, op); ST_RPL(ts_v, rep_ts_v);
    ST_RPL(ts_m, rep_ts_m); ST_RPL(log_no, rep_log);
    ST_RPL(rmw_cnt, rep_rmw_cnt); ST_RPL(rmw_sess, rep_rmw_sess);
    ST_RPL(value, rep_value); ST_RPL(base_v, rep_base_v);
    ST_RPL(base_m, rep_base_m); ST_RPL(val_log, rep_val_log);
#undef ST_RPL

    mask_out[i] = (c && (m_rmw_sess >= 0)) ? 1 : 0;
  }
}

}  // namespace

// Plain C entry for ctypes.  kv (18,n), msgreg (12,n) -> kv_out (18,n),
// rep_out (11,n), mask_out (n,), all contiguous int32 on the device;
// launched on `stream`.  Returns cudaGetLastError() of the launch.
extern "C" int paxos_apply_launch(const void* kv, const void* msgreg,
                                  void* kv_out, void* rep_out,
                                  void* mask_out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // grid-stride: enough blocks to fill 132 SMs many times over
  if (blocks > 132 * 32) blocks = 132 * 32;
  paxos_apply_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(kv), static_cast<const int32_t*>(msgreg),
      static_cast<int32_t*>(kv_out), static_cast<int32_t*>(rep_out),
      static_cast<int32_t*>(mask_out), n);
  return static_cast<int>(cudaGetLastError());
}
