// The lane engine's eight kernels for Hopper (sm_90a), the threefry draw and
// the lane-TCP stream law they share.  The hybrid backend (managed hosts on
// the host CPU, their packets here) adds kernel H (the injection merge), an
// external arm in A whose egress candidates D compacts as a third instance,
// and a hybrid mode of C (the turn's window law and its packed readback),
// with a fused mode for the k-window law (up to k windows a dispatch).
//
// Plain C interface, bound from shadow_tpu_torch/backend/kernels.py with
// ctypes.  Every lane launcher takes an array of S LaneBufs blocks, one per
// scenario (the device pointers of that scenario's state, tables and
// workspace, built and checked on the Python side), twice: in host memory,
// where the launcher reads the launch shape from scenario 0 (equal across
// the scenarios of a sweep), and in device memory.  The scenario is
// blockIdx.y; kernels C and D launch thread-block clusters along x (C's
// head reduction, D's compaction of each instance), through
// cudaLaunchKernelEx.  Each kernel is one template over where a block finds
// its scenario's block (`scenario` below): in the kernel's __grid_constant__
// parameter up to S = 8 (the one block of every serial run, or up to eight
// side by side), in the device array past that.  Each launcher takes
// PyTorch's current stream, launches without synchronising, and returns
// cudaGetLastError().
//
// Arithmetic: the lane state keeps the JAX reference's int32 (hi, lo) time
// pairs in memory; the kernels join them to int64 in registers.  Within the
// engine's guarded ranges (kernels.py / gpu_engine.py) that gives the same
// integers as the reference's pair arithmetic.  Where the reference relies
// on int32 width (counters, token counts, k*rate) the kernels use int32.
// The stream law is the exception: it repeats the reference's int32 pair
// arithmetic step by step, with every sum and product that may wrap done in
// uint32 (signed overflow is undefined in C++, and wraps in XLA and
// PyTorch) and every division floored as theirs are.
//
// Every kernel is gated on its scenario's ctl[0] (the `live` flag that
// queue_min_window writes; the host arms it before a run or a segment): a
// block whose scenario is done returns before any store, so steps after a
// scenario's end leave every word of it unchanged while the others run on.
// Each block indexes only its own scenario's buffers: no offset across
// scenarios is ever formed.
//
// Three observation planes ride the kernels, each behind a flag of LaneBufs
// that is uniform over a launch: pcap (a capturing lane's sends become
// PCAP_TX records, at their departure, before the loss draw), netobs (the
// nb_* counters, the tier's TV_NB_* rows, and the window histogram that C
// folds at each window advance) and flowtrace (the lifecycle events of the
// sampled flows: A's sends, arrivals and stream sends, B's and E's queue
// sheds, as flow records that D appends to the [FL, 10] ring).  Off, the
// record groups and the counters do not exist and nothing is written for
// them.
//
// The merges (B, E, H) sort a row by (key, index) with a bitonic network:
// B's rows of at most 32 entries in one warp's registers (lanes
// .merge_in_warp), every other row in one block's shared memory, opted in
// past 48 KB up to the device's sharedMemPerBlockOptin; a row beyond that
// (a size rule the wrapper fixes before the run, lanes.merge_in_shared)
// sorts in global memory instead, in the workspace's m_scratch, by the
// same code.  G merges a row a warp: the queue's run and the candidates'
// runs of 32, each entry ranked by binary searches of the other runs, in
// shared memory or m_scratch by the same size rule.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t NEVER32 = 0x7FFFFFFF;
constexpr int64_t NEVER64 = 0x7FFFFFFFFFFFFFFFLL;
constexpr int64_t MASK31 = 0x7FFFFFFFLL;
constexpr int32_t CD_UNSET = -2147483647;  // -(1 << 31) + 1
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;  // every lane of a warp

constexpr int32_t PACKET = 0, LOCAL = 1, DELIVERY = 2;
constexpr int32_t M_NONE = 0, M_PHOLD = 1, M_TGEN_MESH = 2, M_TGEN_CLIENT = 3,
                  M_TGEN_SERVER = 4, M_PING_CLIENT = 5, M_PING_SERVER = 6,
                  M_STREAM_CLIENT = 7, M_STREAM_SERVER = 8;
constexpr int AUX_SRC_SHIFT = 12, AUX_KIND_SHIFT = 29;
constexpr int32_t SRC_MASK = (1 << 17) - 1;

constexpr int64_t TARGET_NS = 10000000LL;     // CoDel target, 10 ms
constexpr int64_t INTERVAL_NS = 100000000LL;  // CoDel interval, 100 ms
constexpr int32_t DIV_LAST = 1024;            // codel_div has 1025 entries
constexpr int32_t FRAME_OVERHEAD_BYTES = 24;

constexpr int64_t DELIVERED = 0, DROP_LOSS = 1, DROP_CODEL = 2,
                  DROP_QUEUE = 3, PCAP_TX = 4;
constexpr int32_t NB_HIST_BUCKETS = 24;  // netobs window histogram

// flowtrace (obs/flowtrace.py): event kinds, drop causes, bucket sides; a
// flow record's words in the workspace (t_hi, t_lo, kind, src, dst, seq,
// size, aux) and a ring row's columns (the window stamp after the time)
constexpr int32_t FT_SEND = 0, FT_TB_WAIT = 1, FT_QUEUE_ENTER = 2,
                  FT_DROP = 3, FT_RETRANSMIT = 4, FT_DELIVERY = 5;
constexpr int32_t CAUSE_LOSS = 0, CAUSE_CODEL = 1, CAUSE_QUEUE = 2;
constexpr int32_t TB_UP = 0, TB_DN = 1;
constexpr int FL_WORDS = 8, FT_COLS = 10;

// threefry stream ids (core/rng.py)
constexpr uint32_t LOSS_STREAM = 1u << 30, APP_STREAM = 2u << 30;

}  // namespace

// Field order must match kernels.py's LaneArgs: LaneState fields, then
// LaneTables fields, then Workspace fields, then the sizes.
struct LaneBufs {
  // LaneState
  int32_t *q_thi, *q_tlo, *q_auxh, *q_auxl, *q_size, *q_phi, *q_plo;
  int32_t *send_seq, *local_seq, *app_draws;
  int32_t *up_tokens, *up_nr_hi, *up_nr_lo, *up_ld_hi, *up_ld_lo;
  int32_t *dn_tokens, *dn_nr_hi, *dn_nr_lo, *dn_ld_hi, *dn_ld_lo;
  int32_t *cd_fat_hi, *cd_fat_lo, *cd_dnext_hi, *cd_dnext_lo, *cd_drop_count;
  uint8_t *cd_dropping;
  int32_t *m_sent, *m_peer_offset;
  int32_t *n_delivered, *n_loss, *n_codel, *n_queue, *recv_bytes, *n_sends,
      *n_hops;
  int64_t *log;
  int32_t *log_count, *log_lost, *stream, *rounds, *iters, *now_we_hi,
      *now_we_lo, *min_used_lat;
  // the netobs block (empty when netobs is off)
  int32_t *nb_txb, *nb_rxb, *nb_thr, *nb_shed, *nb_hist, *nb_win;
  // the flowtrace ring [FL, FT_COLS], its count and its losses (empty when
  // flowtrace is off)
  int32_t *fl_buf, *fl_count, *fl_lost;
  // the hybrid backend's egress buffer [E, 6], its count, losses and the
  // earliest DELIVERED time as a pair (empty off the hybrid backend)
  int64_t *egress;
  int32_t *egress_count, *egress_lost, *egress_min_hi, *egress_min_lo;
  // LaneTables
  int32_t *node_of, *lat;
  int64_t *thresh;
  int32_t *up_rate, *up_burst, *up_kfull, *up_kfi;
  int32_t *dn_rate, *dn_burst, *dn_kfull, *dn_kfi;
  int32_t *model, *recv_mult, *p_size, *p_int_hi, *p_int_lo, *p_peer,
      *p_count, *p_stride, *codel_div;
  int32_t *flow_lanes, *flow_peers, *flow_clid, *flow_lat;
  int64_t *flow_thresh;
  int32_t *flow_segs, *flow_mss, *flow_last, *flow_cc, *flow_up_rate,
      *flow_up_burst, *flow_up_kfull, *flow_up_kfi, *flow_dn_rate,
      *flow_dn_burst, *flow_dn_kfull, *flow_dn_kfi;
  uint8_t *lane_stream;
  int32_t *lane_ep_start, *lane_ep_rows;
  uint8_t *lane_pcap, *flow_pcap;
  // the hybrid backend's external lanes [N] (empty off it)
  uint8_t *lane_external;
  // Workspace
  int32_t *ctl, *self_blk, *out_blk, *sx_blk;
  int64_t *recs;
  int32_t *rec_valid, *x_cnt, *x_start, *x_fill, *x_order, *x_done,
      *tier_blk;
  // the iteration's flow records [R_f, FL_WORDS] and their flags; the
  // merges' rows where they do not fit shared memory
  int32_t *fl_recs, *fl_valid, *m_scratch;
  // the hybrid backend: A's egress candidates [K*N, 6] and their flags, and
  // the turn's packed readback (HYB_*: [5], or [6 + k_cap + 1] on the fused
  // law); the fused law's schedule [ext_slots] and its registers (pointer,
  // windows consumed, live steps)
  int64_t *eg_recs;
  int32_t *eg_valid;
  int64_t *hyb, *ext;
  int32_t *fz;
  // the tier's queues [7, 2S, C2] and vectors [TV_COUNT, 2S] (tiered runs)
  int32_t *tier_q, *tier_v;
  // sizes (sw: self block width, K or 2K; words: 5, or 7 with the stream
  // payload words) and run constants
  int64_t n, c, k, cx, sw, g, log_cap, stop, runahead, interval;
  int64_t seed_lo, seed_hi, bootstrap_end, has_loss, all_passive,
      dyn_runahead, runahead_floor, words;
  // streams: S flows, the wide co-pop rule and the pairing it takes,
  // exchanged entries, and where the record groups start
  int64_t s_flows, wide_pop, one_to_one, n_x, rec_slots, rec_srec, rec_brec,
      n_rec;
  // the tiered stream pass (tier_s = S, 0 when not tiered; on a tiered run
  // the lanes' s_flows above is 0): K_s pops, C2 queue width, its wide pop
  // rule, the tier block's width and where the tier's record groups start
  int64_t tier_s, ks, c2, tier_wide, tier_n, rec_tier;
  // the observation planes: netobs; pcap records of the lanes' sends, of
  // the [N] lanes' stream endpoints and of the tier's; where their record
  // groups start, and where the tier merge's tail starts after them
  int64_t netobs, pcap, stream_pcap, tier_pcap, rec_pc, rec_spc, rec_bpc,
      rec_tspc, rec_tbpc, rec_ttail;
  // flowtrace: the flag, the ring's rows, the sampling law (u32 threshold,
  // all flows, the seed mod 2**32), where the flow groups start (B's at 0:
  // E's split tail, A's [N] groups, its stream sends' and bursts'), the
  // buffer's end
  int64_t flowtrace, ft_cap, ft_thresh, ft_all, ft_seed, fl_split, fl_slots,
      fl_ss, fl_bs, n_fl;
  // the merges whose rows run in m_scratch (B, E, G)
  int64_t merge_global, split_global, tier_global;
  // the hybrid backend: the flag, the egress buffer's rows and the count a
  // turn stops at, A's egress candidates (K*N), the injection block's rows,
  // the injected rows a lane takes from one, and whether H's rows run in
  // m_scratch
  int64_t ext_any, eg_cap, room_floor, n_eg, inj_b, cxi, inject_global;
  // the fused hybrid law: the most windows a dispatch consumes (0: the
  // one-window law) and the schedule's slots
  int64_t k_cap, ext_slots;
  // B's merge form: a warp per lane (rows of at most 32 entries) or a block
  int64_t merge_warp;
  // kernel C's cluster: the blocks its head reduction spreads over
  // (lanes.heads_blocks)
  int64_t c_blocks;
  // kernel A's threads a lane (lanes.slot_group)
  int64_t slot_group;
};

// Up to PARAM_SCENARIOS blocks side by side, passed as one kernel parameter
// (8 x 1,512 bytes; Hopper takes up to 32,764).
constexpr int PARAM_SCENARIOS = 8;
struct ParamBufs {
  LaneBufs b[PARAM_SCENARIOS];
};

namespace {

// A block's scenario, by the kernel's parameter: one LaneBufs (S = 1), a
// ParamBufs (S <= 8) or the [S] array in device memory.  From the parameter
// a field is read from the constant bank where it is used; through the
// array it is a load whose value the compiler keeps in a register (kernel
// A's instance for runs with streams: 216 registers at S = 1, 242 at S <=
// 8, 254 past that).
__device__ __forceinline__ const LaneBufs& scenario(const LaneBufs& one,
                                                    unsigned) {
  return one;
}

__device__ __forceinline__ const LaneBufs& scenario(const ParamBufs& few,
                                                    unsigned s) {
  return few.b[s];
}

__device__ __forceinline__ const LaneBufs& scenario(const LaneBufs* all,
                                                    unsigned s) {
  return all[s];
}

__device__ __forceinline__ int64_t join_raw(int32_t hi, int32_t lo) {
  return (static_cast<int64_t>(hi) << 31) | static_cast<int64_t>(lo);
}

// a time pair: (NEVER32, *) is NEVER
__device__ __forceinline__ int64_t join_t(int32_t hi, int32_t lo) {
  return hi == NEVER32 ? NEVER64 : join_raw(hi, lo);
}

__device__ __forceinline__ void split(int64_t v, int32_t* hi, int32_t* lo) {
  if (v == NEVER64) {
    *hi = NEVER32;
    *lo = NEVER32;
  } else {
    *hi = static_cast<int32_t>(v >> 31);
    *lo = static_cast<int32_t>(v & MASK31);
  }
}

// ---- threefry-2x32, 20 rounds (core/rng.py threefry2x32) ---------------------
// Returns the first output word.  The rotations are funnel shifts; every add
// wraps mod 2**32 as the reference's uint32 arithmetic does.
__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

__device__ __forceinline__ uint32_t threefry2x32_x0(uint32_t ks0, uint32_t ks1,
                                                   uint32_t c0, uint32_t c1) {
  const uint32_t ks2 = ks0 ^ ks1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + ks0, x1 = c1 + ks1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
#define TF_GROUP_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_GROUP_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_GROUP_A x0 += ks1; x1 += ks2 + 1u;
  TF_GROUP_B x0 += ks2; x1 += ks0 + 2u;
  TF_GROUP_A x0 += ks0; x1 += ks1 + 3u;
  TF_GROUP_B x0 += ks1; x1 += ks2 + 4u;
  TF_GROUP_A x0 += ks2; x1 += ks0 + 5u;
#undef TF_GROUP_B
#undef TF_GROUP_A
#undef TF_ROUND
  return x0;
}

// The lane engine's draw (lanes.py rand_u32_lane): key (seed lo, stream ^
// seed hi), counter (counter, 0).
__device__ __forceinline__ uint32_t lane_draw(uint32_t seed_lo,
                                              uint32_t seed_hi,
                                              uint32_t stream,
                                              uint32_t counter) {
  return threefry2x32_x0(seed_lo, stream ^ seed_hi, counter, 0u);
}

struct Bucket {
  int32_t tokens;
  int64_t nr, ld;  // next_refill, last_depart
};

// The token-bucket charge (the reference's bucket_charge_vec); returns the
// departure time and counts a charge that had to wait for tokens into
// `waits` (netobs' throttle count).  Refill by elapsed intervals, exact
// within the k_full horizon and saturated + grid-realigned beyond it; FIFO
// charge clock.
__device__ int64_t bucket_charge(Bucket& b, int32_t rate, int32_t burst,
                                 int32_t k_full, int32_t kfi, int64_t t,
                                 int32_t bits, bool active, int32_t interval,
                                 int32_t& waits) {
  const bool act = active && rate != 0;
  const int64_t te = t > b.ld ? t : b.ld;
  const bool do_refill = act && te >= b.nr;
  int32_t diff = 0;
  if (te >= b.nr) {
    const int64_t d = te - b.nr;
    diff = d < kfi ? static_cast<int32_t>(d) : kfi;
  }
  const bool full = diff >= kfi;
  if (do_refill) {
    int32_t k = diff / interval + 1;
    k = k < k_full ? k : k_full;
    const int32_t refilled = b.tokens + k * rate;
    b.tokens = refilled < burst ? refilled : burst;
    b.nr = full ? te - te % interval + interval
                : b.nr + static_cast<int64_t>(k * interval);
  }
  const bool have = b.tokens >= bits;
  const bool wait = act && !have;
  const int32_t r1 = rate > 1 ? rate : 1;
  int32_t w = 1;
  if (wait) {
    const int32_t need = bits - b.tokens;  // >= 1 here
    w = (need + r1 - 1) / r1;
  }
  const int64_t dep =
      wait ? b.nr + static_cast<int64_t>((w - 1) * interval) : te;
  if (act) {
    if (have) {
      b.tokens -= bits;
    } else {
      const int32_t cap = burst / r1 + 1;
      const int32_t w_r = w < cap ? w : cap;
      const int32_t filled = b.tokens + w_r * rate;
      const int32_t left = (filled < burst ? filled : burst) - bits;
      b.tokens = left > 0 ? left : 0;
    }
    b.ld = dep;
  }
  if (wait) {
    b.nr += static_cast<int64_t>(w * interval);
    waits += 1;
  }
  return dep;
}

// One RFC 8289 CoDel offer at delivery time td (the reference's
// codel_offer_arrays); returns the drop decision.
__device__ bool codel_offer(int32_t& fat_hi, int32_t& fat_lo, int64_t& dn,
                            int32_t& dcount, uint8_t& dropping, int64_t td,
                            int64_t sojourn, bool active,
                            const int32_t* codel_div) {
  const bool unset = fat_hi == CD_UNSET;
  const int64_t fat = unset ? 0 : join_raw(fat_hi, fat_lo);
  const bool below = sojourn < TARGET_NS;
  const int64_t fatn = below ? 0 : (unset ? td + INTERVAL_NS : fat);
  const bool ok = active && !below && !unset && td >= fat;
  const bool was_dropping = dropping != 0;

  const bool drop_in_dropping = active && was_dropping && ok && td >= dn;
  const int32_t dcount_d = dcount + (drop_in_dropping ? 1 : 0);
  const int64_t dnd =
      drop_in_dropping
          ? dn + codel_div[dcount_d < DIV_LAST ? dcount_d : DIV_LAST]
          : dn;
  const bool recent = td < dn + INTERVAL_NS;
  const bool enter = active && !was_dropping && ok &&
                     (recent || td >= fatn + INTERVAL_NS);
  const int32_t dcount_e = (dcount > 2 && recent) ? 2 : 1;

  if (active) {
    if (below) {
      fat_hi = CD_UNSET;
      fat_lo = 0;
    } else if (unset) {
      split(fatn, &fat_hi, &fat_lo);
    }
    dropping = ((was_dropping && ok) || enter) ? 1 : 0;
  }
  if (enter) {
    dcount = dcount_e;
    dn = td + codel_div[dcount_e];
  } else {
    if (drop_in_dropping) dcount = dcount_d;
    dn = dnd;
  }
  return drop_in_dropping || enter;
}

// ---- the lane-TCP stream law (backend/lanes_stream.py) ----------------------
// One flow endpoint in registers.  Every time is an int32 (hi, lo) pair and
// the pair helpers are the reference's lanes_pairs.py; wrap-prone sums and
// products go through uint32, divisions are floored.

constexpr int32_t F_SYN = 1, F_ACK = 2, F_FIN = 4, F_DATA = 8;
constexpr int32_t CLOSED = 0, SYN_SENT = 1, SYN_RCVD = 2, ESTAB = 3,
                  FIN_WAIT = 4, LAST_ACK = 5, DONE = 6;
constexpr int32_t SENDER = 0, RECEIVER = 1;
constexpr int32_t FP = 1024, MIN_SSTHRESH_FP = 2 * FP, DUP_THRESH = 3;
constexpr int32_t CC_CUBIC = 1;
constexpr int32_t CUBIC_BETA_MUL = 717, CUBIC_FC_MUL = 870, CUBIC_C_MUL = 410,
                  CUBIC_K_MUL = 40960, CUBIC_D_MAX = 8192;
constexpr int32_t RWND_SEGS = 24, MAX_CWND_FP = 2 * RWND_SEGS * FP;
constexpr int PUMP_BURST = RWND_SEGS;
constexpr int32_t HDR_BYTES = 40;
constexpr int32_t SZ_RTO = -3;
constexpr int PAY_SEQ_BITS = 26;
constexpr int32_t PAY_SEQ_MASK = (1 << PAY_SEQ_BITS) - 1;
constexpr int N_COLS = 33;
constexpr int32_t M31 = 0x7FFFFFFF;
// RTO_MIN 200 ms, RTO_MAX 60 s and the 1 ms granularity floor, as pairs
constexpr int32_t RTO_MIN_HI = 0, RTO_MIN_LO = 200000000;
constexpr int32_t RTO_MAX_HI = 27, RTO_MAX_LO = 2017941504;
constexpr int32_t GRAN_HI = 0, GRAN_LO = 1000000;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wshl(int32_t a, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << s);
}
// Python's // on int32 (floor); b != 0
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  if (b == -1) return wsub(0, a);  // INT_MIN / -1 wraps, as XLA's does
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

struct Pair {
  int32_t hi, lo;
};
__device__ __forceinline__ bool p_lt(Pair a, Pair b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}
__device__ __forceinline__ Pair p_add(Pair a, Pair b) {
  const int32_t t = wadd(a.lo, b.lo);
  return {wadd(wadd(a.hi, b.hi), t < 0 ? 1 : 0), t & M31};
}
__device__ __forceinline__ Pair p_sub(Pair a, Pair b) {
  const int32_t t = wsub(a.lo, b.lo);
  return {wsub(wsub(a.hi, b.hi), t < 0 ? 1 : 0), t & M31};
}
__device__ __forceinline__ Pair p_max(Pair a, Pair b) { return p_lt(a, b) ? b : a; }
__device__ __forceinline__ Pair p_abs_diff(Pair a, Pair b) {
  return p_lt(a, b) ? p_sub(b, a) : p_sub(a, b);
}
__device__ __forceinline__ Pair p_div_pow2(Pair a, int k) {
  const int32_t mask = (1 << k) - 1;
  return {a.hi >> k, wadd(wshl(a.hi & mask, 31 - k), a.lo >> k)};
}
__device__ __forceinline__ Pair p_mul_small(Pair a, int32_t c) {
  const int32_t lh = a.lo >> 16, ll = a.lo & 0xFFFF;
  const int32_t mid = wmul(lh, c);
  const int32_t q = mid >> 15, s = mid & 0x7FFF;
  const int32_t t = wadd(wshl(s, 16), wmul(ll, c));
  return {wadd(wadd(wmul(a.hi, c), q), t < 0 ? 1 : 0), t & M31};
}

// one endpoint's flow state: the 33 columns of lanes_stream.py, then the
// row's static shape
struct Flow {
  int32_t state, snd_una, snd_nxt, rcv_nxt, cwnd, ssthresh, dup_acks, in_rec,
      recover, max_sent, rtt_seq;
  Pair srtt, rttvar, rto, rtt_ts, rtodl, rtoev;
  int32_t tx_segs, retransmits, completed, rx_segs, rx_bytes, w_max, origin;
  Pair epoch;
  int32_t k_q;
  int32_t role, segs, mss, last_bytes, cc;
};

__device__ void flow_load(Flow& f, const int32_t* r) {
  f.state = r[0]; f.snd_una = r[1]; f.snd_nxt = r[2]; f.rcv_nxt = r[3];
  f.cwnd = r[4]; f.ssthresh = r[5]; f.dup_acks = r[6]; f.in_rec = r[7];
  f.recover = r[8]; f.max_sent = r[9]; f.rtt_seq = r[10];
  f.srtt = {r[11], r[12]}; f.rttvar = {r[13], r[14]}; f.rto = {r[15], r[16]};
  f.rtt_ts = {r[17], r[18]}; f.rtodl = {r[19], r[20]}; f.rtoev = {r[21], r[22]};
  f.tx_segs = r[23]; f.retransmits = r[24]; f.completed = r[25];
  f.rx_segs = r[26]; f.rx_bytes = r[27]; f.w_max = r[28]; f.origin = r[29];
  f.epoch = {r[30], r[31]}; f.k_q = r[32];
}

__device__ void flow_store(const Flow& f, int32_t* r) {
  r[0] = f.state; r[1] = f.snd_una; r[2] = f.snd_nxt; r[3] = f.rcv_nxt;
  r[4] = f.cwnd; r[5] = f.ssthresh; r[6] = f.dup_acks; r[7] = f.in_rec;
  r[8] = f.recover; r[9] = f.max_sent; r[10] = f.rtt_seq;
  r[11] = f.srtt.hi; r[12] = f.srtt.lo; r[13] = f.rttvar.hi;
  r[14] = f.rttvar.lo; r[15] = f.rto.hi; r[16] = f.rto.lo;
  r[17] = f.rtt_ts.hi; r[18] = f.rtt_ts.lo; r[19] = f.rtodl.hi;
  r[20] = f.rtodl.lo; r[21] = f.rtoev.hi; r[22] = f.rtoev.lo;
  r[23] = f.tx_segs; r[24] = f.retransmits; r[25] = f.completed;
  r[26] = f.rx_segs; r[27] = f.rx_bytes; r[28] = f.w_max; r[29] = f.origin;
  r[30] = f.epoch.hi; r[31] = f.epoch.lo; r[32] = f.k_q;
}

// what one stimulus emits: the control send and the RTO arm
struct Emit {
  bool send_valid, send_retx, rto_valid, completed_now;
  int32_t send_flags, send_seq, send_ack, send_size;
  Pair rto_t;
};

__device__ __forceinline__ int32_t seg_wire_size(const Flow& f, int32_t unit) {
  if (unit >= 1 && unit <= f.segs)
    return HDR_BYTES + (unit == f.segs ? f.last_bytes : f.mss);
  return HDR_BYTES;
}

__device__ __forceinline__ int32_t seg_flags(const Flow& f, int32_t unit) {
  if (unit == 0) return f.role == SENDER ? F_SYN : (F_SYN | F_ACK);
  if (f.role == SENDER && unit >= 1 && unit <= f.segs) return F_DATA | F_ACK;
  return F_FIN | F_ACK;
}

__device__ __forceinline__ int32_t flight(const Flow& f) {
  return wsub(f.snd_nxt, f.snd_una);
}

// ltcp.icbrt32: the 11-iteration bitwise floor cube root
__device__ int32_t icbrt32(int32_t x) {
  int32_t y = 0;
  for (int s = 30; s >= 0; s -= 3) {
    y = wadd(y, y);
    const int32_t b = wadd(wmul(wmul(3, y), wadd(y, 1)), 1);
    if ((x >> s) >= b) {
      x = wsub(x, wshl(b, s));
      y = wadd(y, 1);
    }
  }
  return y;
}

__device__ void cc_on_loss(Flow& f) {
  if (f.cc == CC_CUBIC) {
    f.w_max = f.cwnd < f.w_max ? wmul(f.cwnd, CUBIC_FC_MUL) >> 10 : f.cwnd;
    f.epoch = {NEVER32, NEVER32};
    f.ssthresh = imax(wmul(f.cwnd, CUBIC_BETA_MUL) >> 10, MIN_SSTHRESH_FP);
  } else {
    const int32_t fl_fp = wmul(imin(flight(f), 1 << 15), FP);
    f.ssthresh = imax(floordiv(fl_fp, 2), MIN_SSTHRESH_FP);
  }
}

__device__ void cc_grow_ca(Flow& f, Pair now) {
  const bool cub = f.cc == CC_CUBIC;
  if (cub && f.epoch.hi == NEVER32) {
    const bool below = f.cwnd < f.w_max;
    f.epoch = now;
    f.origin = below ? f.w_max : f.cwnd;
    f.k_q = below ? wmul(4, icbrt32(wmul(wsub(f.w_max, f.cwnd), CUBIC_K_MUL))) : 0;
  }
  int32_t grow;
  if (cub) {
    const Pair d = p_sub(now, f.epoch);
    const int32_t d_q =
        imin(wadd(wmul(imin(d.hi, 1 << 19), 1 << 11), d.lo >> 20), CUBIC_D_MAX);
    int32_t offs = wsub(d_q, f.k_q);
    const bool neg = offs < 0;
    offs = imin(neg ? wsub(0, offs) : offs, CUBIC_D_MAX);
    const int32_t delta =
        wmul(wmul(wmul(offs, offs) >> 10, offs) >> 10, CUBIC_C_MUL) >> 10;
    const int32_t target = neg ? wsub(f.origin, delta) : wadd(f.origin, delta);
    const int32_t safe = imax(f.cwnd, 1);
    grow = target > f.cwnd
               ? imax(1, floordiv(wmul(wsub(target, f.cwnd), FP), safe))
               : imax(1, floordiv(FP * FP, wmul(100, safe)));
  } else {
    grow = imax(1, floordiv(FP * FP, imax(f.cwnd, 1)));
  }
  f.cwnd = wadd(f.cwnd, grow);
}

__device__ void rtt_sample(Flow& f, Pair now) {
  Pair r = p_lt(now, f.rtt_ts) ? Pair{0, 0} : p_sub(now, f.rtt_ts);
  const bool first = f.srtt.hi < 0;
  const Pair s = p_div_pow2(p_add(p_mul_small(f.srtt, 7), r), 3);
  const Pair srtt1 = first ? r : s;
  const Pair d = p_abs_diff(f.srtt, r);
  const Pair v = p_div_pow2(p_add(p_mul_small(f.rttvar, 3), d), 2);
  const Pair var1 = first ? p_div_pow2(r, 1) : v;
  const Pair v4 = p_max(p_mul_small(var1, 4), Pair{GRAN_HI, GRAN_LO});
  Pair to = p_add(srtt1, v4);
  if (p_lt(to, Pair{RTO_MIN_HI, RTO_MIN_LO})) to = {RTO_MIN_HI, RTO_MIN_LO};
  if (p_lt(Pair{RTO_MAX_HI, RTO_MAX_LO}, to)) to = {RTO_MAX_HI, RTO_MAX_LO};
  f.srtt = srtt1;
  f.rttvar = var1;
  f.rto = to;
}

// (re)start the retransmission timer: arm a new RTO event only when none
// is queued or the new deadline is earlier (the dedup law)
__device__ void restart_rto(Flow& f, Pair now, Emit& em) {
  const Pair dl = p_add(now, f.rto);
  f.rtodl = dl;
  if (f.rtoev.hi == NEVER32 || p_lt(dl, f.rtoev)) {
    f.rtoev = dl;
    em.rto_valid = true;
    em.rto_t = dl;
  }
}

__device__ void emit_unit(Flow& f, int32_t unit, bool retransmit, Emit& em) {
  f.tx_segs = wadd(f.tx_segs, 1);
  if (retransmit) {
    f.retransmits = wadd(f.retransmits, 1);
    if (f.rtt_seq >= 0 && unit <= f.rtt_seq) f.rtt_seq = -1;
  } else if (f.rtt_seq < 0) {
    f.rtt_seq = unit;
  }
  if (wadd(unit, 1) > f.max_sent) f.max_sent = wadd(unit, 1);
  em.send_valid = true;
  em.send_flags = seg_flags(f, unit);
  em.send_seq = unit;
  em.send_ack = f.rcv_nxt;
  em.send_size = seg_wire_size(f, unit);
  em.send_retx = retransmit;
}

__device__ __forceinline__ void control(Emit& em, int32_t seq, int32_t ack) {
  em.send_valid = true;
  em.send_flags = F_ACK;
  em.send_seq = seq;
  em.send_ack = ack;
  em.send_size = HDR_BYTES;
}

// go-back-N loss response (the epilogue pump re-streams the rest)
__device__ void pull_back(Flow& f, Pair now, Emit& em) {
  f.snd_nxt = wadd(f.snd_una, 1);
  if (f.role == SENDER && f.state == FIN_WAIT) f.state = ESTAB;
  emit_unit(f, f.snd_una, true, em);
  restart_rto(f, now, em);
}

__device__ void open_flow(Flow& f, Pair now, Emit& em) {
  f.state = SYN_SENT;
  f.snd_nxt = 1;
  emit_unit(f, 0, false, em);
  f.rtt_ts = now;
  restart_rto(f, now, em);
}

__device__ void on_rto(Flow& f, Pair now, Emit& em) {
  // ownership law: only the event at time rto_evt speaks for the timer
  if (now.hi != f.rtoev.hi || now.lo != f.rtoev.lo) return;
  f.rtoev = {NEVER32, NEVER32};
  if (f.rtodl.hi == NEVER32 || flight(f) <= 0) return;
  if (p_lt(now, f.rtodl)) {  // the deadline moved later: re-arm there
    f.rtoev = f.rtodl;
    em.rto_valid = true;
    em.rto_t = f.rtodl;
    return;
  }
  Pair r2 = p_mul_small(f.rto, 2);
  if (p_lt(Pair{RTO_MAX_HI, RTO_MAX_LO}, r2)) r2 = {RTO_MAX_HI, RTO_MAX_LO};
  cc_on_loss(f);
  f.cwnd = FP;
  f.dup_acks = 0;
  f.in_rec = 0;
  f.rto = r2;
  pull_back(f, now, em);
}

// the scalar law's on_segment: its early returns become `live` turning off
__device__ void on_segment(Flow& f, Pair now, int32_t flags, int32_t seq,
                           int32_t ack, int32_t size, Emit& em) {
  const bool is_syn = flags & F_SYN, is_ack = flags & F_ACK,
             is_fin = flags & F_FIN, is_data = flags & F_DATA;
  bool live = true;
  if (f.state == DONE) {  // a dup FIN from a peer that missed our last ACK
    if (f.role == SENDER && is_fin) control(em, f.snd_nxt, f.rcv_nxt);
    live = false;
  }
  if (live && f.role == RECEIVER && f.state == CLOSED) {  // passive open
    if (is_syn && !is_ack) {
      f.state = SYN_RCVD;
      f.rcv_nxt = 1;
      f.snd_nxt = 1;
      emit_unit(f, 0, false, em);
      f.rtt_ts = now;
      restart_rto(f, now, em);
    }
    live = false;
  }
  if (live && f.role == RECEIVER && f.state == SYN_RCVD && is_syn && !is_ack) {
    emit_unit(f, 0, true, em);  // a retransmitted SYN: resend the SYN-ACK
    restart_rto(f, now, em);
    live = false;
  }

  // ACK processing
  const bool new_ack = live && is_ack && ack > f.snd_una;
  const int32_t acked = imin(wsub(ack, f.snd_una), 1 << 15);
  const int32_t pre_snd_una = f.snd_una;
  const bool pre_in_rec = f.in_rec != 0;
  if (new_ack) {
    const bool was_syn_sent = f.state == SYN_SENT;
    const bool was_syn_rcvd = f.state == SYN_RCVD;
    f.snd_una = ack;
    if (f.snd_nxt < f.snd_una) f.snd_nxt = f.snd_una;
    if (was_syn_sent || was_syn_rcvd) f.state = ESTAB;
    if (was_syn_sent) f.rcv_nxt = 1;  // the SYN-ACK consumed unit 0
    if (pre_in_rec && ack >= f.recover) {  // full ACK: recovery exit
      f.cwnd = f.ssthresh;
      f.in_rec = 0;
      f.dup_acks = 0;
    }
    if (!pre_in_rec) {
      f.dup_acks = 0;
      if (f.cwnd < f.ssthresh) {
        f.cwnd = wadd(f.cwnd, wmul(acked, FP));  // slow start
      } else {
        cc_grow_ca(f, now);
      }
      f.cwnd = imin(f.cwnd, MAX_CWND_FP);
    }
    if (f.rtt_seq >= 0 && ack > f.rtt_seq) {
      rtt_sample(f, now);
      f.rtt_seq = -1;
    }
    if (flight(f) > 0) {
      restart_rto(f, now, em);
    } else {
      f.rtodl = {NEVER32, NEVER32};
    }
  }
  // a pure duplicate ACK
  if (live && is_ack && ack == pre_snd_una && !new_ack && flight(f) > 0 &&
      !(is_data || is_syn || is_fin)) {
    if (f.in_rec) {
      f.cwnd = wadd(f.cwnd, FP);
    } else {
      f.dup_acks = wadd(f.dup_acks, 1);
      if (f.dup_acks == DUP_THRESH) {  // fast retransmit
        f.in_rec = 1;
        f.recover = f.snd_nxt;
        cc_on_loss(f);
        f.cwnd = wadd(f.ssthresh, DUP_THRESH * FP);
        pull_back(f, now, em);
      }
    }
  }

  // the sender's teardown (a window this ACK opened is streamed by the pump)
  if (live && f.role == SENDER) {
    if (is_fin && f.snd_una == wadd(f.segs, 2)) {
      f.rcv_nxt = 2;
      control(em, f.snd_nxt, f.rcv_nxt);
      em.completed_now = true;
      f.state = DONE;
      f.rtodl = {NEVER32, NEVER32};
    }
    live = false;
  }

  // the receiver's data path
  if (live && (f.state == SYN_RCVD || f.state == ESTAB) && is_syn && is_ack)
    live = false;  // a stray SYN-ACK
  const bool est = live && (f.state == ESTAB || f.state == SYN_RCVD);
  if (est && is_data) {
    if (seq == f.rcv_nxt) {
      f.rcv_nxt = wadd(f.rcv_nxt, 1);
      f.rx_segs = wadd(f.rx_segs, 1);
      f.rx_bytes = wadd(f.rx_bytes, wsub(size, HDR_BYTES));
    }
    control(em, f.snd_nxt, f.rcv_nxt);  // ACK everything
  }
  if (est && !is_data && is_fin) {
    if (seq == f.rcv_nxt) {
      const int32_t unit = f.snd_nxt;
      const bool fresh_ts = f.rtt_seq < 0;
      f.rcv_nxt = wadd(f.rcv_nxt, 1);
      f.snd_nxt = wadd(f.snd_nxt, 1);
      if (fresh_ts) f.rtt_ts = now;
      emit_unit(f, unit, false, em);
      f.state = LAST_ACK;
      restart_rto(f, now, em);
    } else {
      control(em, f.snd_nxt, f.rcv_nxt);
    }
  }
  // LAST_ACK (a flow the branch above just moved there is not re-examined)
  if (live && !est && f.state == LAST_ACK) {
    if (f.snd_una >= 2) {
      f.state = DONE;
      f.rtodl = {NEVER32, NEVER32};
      em.completed_now = true;
    } else if ((is_data || is_fin) && seq < f.rcv_nxt) {
      emit_unit(f, f.snd_una, true, em);  // a stale retransmission
      restart_rto(f, now, em);
    }
  }
}

// the transmission-opportunity epilogue, in closed form: up to PUMP_BURST
// window-permitted units u0 .. u0 + count - 1, the first n_re of them
// retransmissions; returns count
__device__ int32_t pump_epilogue(Flow& f, Pair now, Emit& em, int32_t& n_re) {
  const int32_t u0 = f.snd_nxt;
  int32_t cnt = 0;
  if (f.role == SENDER && f.state == ESTAB) {
    const int32_t lim_w =
        wsub(imin(floordiv(f.cwnd, FP), RWND_SEGS), wsub(u0, f.snd_una));
    const int32_t lim_fin = wsub(wadd(f.segs, 2), u0);
    cnt = imax(imin(imin(lim_w, lim_fin), PUMP_BURST), 0);
  }
  n_re = imin(imax(wsub(f.max_sent, u0), 0), cnt);
  const bool cleared = n_re > 0 && f.rtt_seq >= 0 && u0 <= f.rtt_seq;
  const bool take_ts = cnt > n_re && (f.rtt_seq < 0 || cleared);
  if (take_ts) {
    f.rtt_ts = now;
    f.rtt_seq = wadd(u0, n_re);
  } else if (cleared) {
    f.rtt_seq = -1;
  }
  f.tx_segs = wadd(f.tx_segs, cnt);
  f.retransmits = wadd(f.retransmits, n_re);
  if (cnt > 0) {
    f.max_sent = imax(f.max_sent, wadd(u0, cnt));
    if (wadd(u0, cnt) == wadd(f.segs, 2)) f.state = FIN_WAIT;
  }
  f.snd_nxt = wadd(u0, cnt);
  if (cnt > 0) restart_rto(f, now, em);
  return cnt;
}

// one charge of an intra-instant chain, for burst units after the first
// (the reference's bucket_charge_chained_vec): the wait machinery only
__device__ int64_t bucket_charge_chained(Bucket& b, int32_t rate, int32_t burst,
                                         int64_t t, int32_t bits,
                                         int32_t interval, int32_t& waits) {
  const bool act = rate != 0;
  const bool have = b.tokens >= bits;
  const bool wait = act && !have;
  const int32_t r1 = rate > 1 ? rate : 1;
  int32_t w = 1;
  if (wait) w = (bits - b.tokens + r1 - 1) / r1;
  const int64_t te = t > b.ld ? t : b.ld;
  const int64_t dep =
      wait ? b.nr + static_cast<int64_t>((w - 1) * interval) : te;
  if (act) {
    if (have) {
      b.tokens -= bits;
    } else {
      const int32_t cap = burst / r1 + 1;
      const int32_t w_r = w < cap ? w : cap;
      const int32_t filled = b.tokens + w_r * rate;
      const int32_t left = (filled < burst ? filled : burst) - bits;
      b.tokens = left > 0 ? left : 0;
    }
    b.ld = dep;
  }
  if (wait) {
    b.nr += static_cast<int64_t>(w * interval);
    waits += 1;
  }
  return dep;
}

// the up bucket and the counters a stimulus charges: the lane's in A, the
// endpoint row's in F (nb_txb, nb_thr: netobs' bytes sent and waits)
struct StreamLane {
  Bucket& up;
  int32_t &send_seq, &local_seq, &n_sends, &n_loss, &min_lat, &nb_txb,
      &nb_thr;
};

// one entry's seven words (time pair, aux pair, size, payload pair), words
// `stride` apart: the entry if valid, else the canonical empty entry
__device__ __forceinline__ void put_words(int32_t* x, int64_t stride,
                                          bool valid, int64_t t, int32_t auxh,
                                          int32_t auxl, int32_t size,
                                          int32_t phi, int32_t plo) {
  int32_t hi = NEVER32, lo = NEVER32;
  if (valid) split(t, &hi, &lo);
  x[0] = hi;
  x[stride] = lo;
  x[2 * stride] = valid ? auxh : 0;
  x[3 * stride] = valid ? auxl : 0;
  x[4 * stride] = valid ? size : 0;
  x[5 * stride] = valid ? phi : 0;
  x[6 * stride] = valid ? plo : 0;
}

// a stream block entry: its destination (N when empty), then its words
__device__ void put_entry(const LaneBufs& b, int64_t n_ent, int64_t idx,
                          bool valid, int32_t dst, int64_t t, int32_t auxh,
                          int32_t auxl, int32_t size, int32_t phi,
                          int32_t plo) {
  int32_t* x = b.sx_blk + idx;
  x[0] = valid ? dst : static_cast<int32_t>(b.n);
  put_words(x + n_ent, n_ent, valid, t, auxh, auxl, size, phi, plo);
}

// record slot r of the iteration's records: the record if valid, else zeros
__device__ void put_rec(const LaneBufs& b, int64_t r, bool valid, int64_t t,
                        int32_t src, int32_t dst, int32_t seq, int32_t size,
                        int64_t outcome) {
  if (b.log_cap <= 0) return;
  int64_t* row = b.recs + r * 6;
  row[0] = valid ? t : 0;
  row[1] = valid ? src : 0;
  row[2] = valid ? dst : 0;
  row[3] = valid ? seq : 0;
  row[4] = valid ? size : 0;
  row[5] = valid ? outcome : 0;
  b.rec_valid[r] = valid ? 1 : 0;
}

__device__ __forceinline__ void put_loss(const LaneBufs& b, int64_t r,
                                         bool lost, int64_t t, int32_t src,
                                         int32_t dst, int32_t seq,
                                         int32_t size) {
  put_rec(b, r, lost, t, src, dst, seq, size, DROP_LOSS);
}

// ---- flowtrace: the sampling hash and the flow records ----------------------

// murmur3-fmix32 of the flow's (src, dst) under the seed (obs/flowtrace.py
// flow_hash with fid 0; the reference's lanes.py flow_hash_lane): every
// step wraps mod 2**32, as uint32 arithmetic does
__device__ __forceinline__ uint32_t flow_hash(uint32_t src, uint32_t dst,
                                              uint32_t seed) {
  uint32_t h = src * 2654435761u + dst * 2246822519u + seed * 668265263u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// does the flow (src, dst) record its events?  Every flow at sample 1 and
// none at 0, with no hash evaluated
__device__ __forceinline__ bool flow_sampled(const LaneBufs& b, int32_t src,
                                             int32_t dst) {
  if (b.ft_all) return true;
  if (b.ft_thresh == 0) return false;
  return static_cast<int64_t>(flow_hash(static_cast<uint32_t>(src),
                                        static_cast<uint32_t>(dst),
                                        static_cast<uint32_t>(b.ft_seed))) <
         b.ft_thresh;
}

// flow record slot r: its flag always, its words only when valid (D copies
// the valid ones alone)
__device__ __forceinline__ void put_flow(const LaneBufs& b, int64_t r,
                                         bool valid, int64_t t, int32_t kind,
                                         int32_t src, int32_t dst,
                                         int32_t seq, int32_t size,
                                         int32_t aux) {
  b.fl_valid[r] = valid ? 1 : 0;
  if (!valid) return;
  int32_t* row = b.fl_recs + r * FL_WORDS;
  split(t, &row[0], &row[1]);
  row[2] = kind;
  row[3] = src;
  row[4] = dst;
  row[5] = seq;
  row[6] = size;
  row[7] = aux;
}

// a send's four flow groups, slot r of the first and `gw` apart: the send
// (or retransmit: `kind`) at the stimulus time t, the up bucket's wait at
// the departure, the loss at t, the queue entry at the arrival; `smp`: the
// send was made and its flow is sampled
__device__ void send_flows(const LaneBufs& b, int64_t r, int64_t gw, bool smp,
                           bool lost, int64_t t, int64_t dep, int64_t arr,
                           int32_t kind, int32_t src, int32_t dst,
                           int32_t seq, int32_t size) {
  put_flow(b, r, smp, t, kind, src, dst, seq, size, 0);
  put_flow(b, r + gw, smp && dep != t, dep, FT_TB_WAIT, src, dst, seq, size,
           TB_UP);
  put_flow(b, r + 2 * gw, smp && lost, t, FT_DROP, src, dst, seq, size,
           CAUSE_LOSS);
  put_flow(b, r + 3 * gw, smp && !lost, arr, FT_QUEUE_ENTER, src, dst, seq,
           size, 0);
}

// a row's up-bucket and send tables, read once: the walk's stores would
// keep the compiler from hoisting the reads out of the slot and burst loops
struct UpRow {
  int32_t rate, burst, kfull, kfi, lat, lane;
  int64_t thresh;
};

__device__ __forceinline__ UpRow up_row(const LaneBufs& b, int64_t e) {
  return UpRow{b.flow_up_rate[e],  b.flow_up_burst[e], b.flow_up_kfull[e],
               b.flow_up_kfi[e],   b.flow_lat[e],      b.flow_lanes[e],
               b.flow_thresh[e]};
}

// one stimulus's control send and RTO arm, as stream_stimulus hands them on
struct Sends {
  Emit em{};
  int32_t cnt = 0;   // burst units sent
  int32_t n_re = 0;  // ... the first n_re of them retransmissions
  int32_t seq = 0;   // the control send's sequence number
  int32_t lseq = 0;  // the RTO arm's local sequence number
  bool lost = false;
  int64_t dep = 0;   // the control send's departure (its pcap time)
  int64_t arr = 0;   // the control send's arrival
};

// the loss draw of a stimulus's v-th send, at counter seq + v, where it is
// needed
struct SerialDraw {
  const LaneBufs& b;
  const UpRow& r;
  int32_t seq;
  __device__ __forceinline__ bool operator()(int32_t v) const {
    const uint32_t u = lane_draw(static_cast<uint32_t>(b.seed_lo),
                                 static_cast<uint32_t>(b.seed_hi),
                                 static_cast<uint32_t>(r.lane) | LOSS_STREAM,
                                 static_cast<uint32_t>(wadd(seq, v)));
    return static_cast<int64_t>(u) < r.thresh;
  }
};

// ... read from a warp's ballot of the draws at seq + lane (a stimulus sends
// at most 1 + PUMP_BURST <= 32 times)
struct WarpDraw {
  uint32_t lost;
  __device__ __forceinline__ bool operator()(int32_t v) const {
    return (lost >> v) & 1u;
  }
};

// The law and the sends of one stimulus at an endpoint row, shared by A's
// stream arm and F's walk: stim 1 opens a client flow, 2 fires the RTO, 3
// runs on_segment on the event's payload words, at `now` (= t); the pump
// burst follows.  The control send and the burst charge `sl.up` in order
// (the burst after its first unit by the chained law), each drawing its
// loss at counter = its send sequence number; the RTO arm takes the local
// sequence.  Burst unit u goes to burst(u, valid, lost, dep, arr, seq, size,
// phi, plo, retx); the control send and the arm are returned.  Every charge and
// every byte sent is counted into sl.nb_thr and sl.nb_txb.  The loss draws
// come from `lost_at(v)`, the draw of the stimulus's v-th send (counter =
// the control send's sequence number + v): SerialDraw computes each where
// it is needed (A), WarpDraw reads it from draws a warp made beforehand (F).
template <class BurstSink, class LostAt>
__device__ __forceinline__ Sends stream_stimulus(
    const LaneBufs& b, Flow& f, int stim, Pair now, int64_t t, int32_t phi,
    int32_t plo, int32_t size, int64_t we, const UpRow& r, StreamLane sl,
    BurstSink burst, LostAt lost_at) {
  Sends s;
  if (stim == 1) {
    open_flow(f, now, s.em);
  } else if (stim == 2) {
    on_rto(f, now, s.em);
  } else {
    on_segment(f, now, phi >> PAY_SEQ_BITS, phi & PAY_SEQ_MASK, plo, size,
               s.em);
  }
  if (s.em.completed_now) f.completed = 1;  // latched once
  const int32_t u0 = f.snd_nxt;
  s.cnt = pump_epilogue(f, now, s.em, s.n_re);

  const int32_t interval = static_cast<int32_t>(b.interval);
  const bool draw = b.has_loss && t >= b.bootstrap_end;
  // the control send: up bucket, loss draw, arrival
  s.seq = sl.send_seq;
  if (s.em.send_valid) {
    const int64_t dep =
        bucket_charge(sl.up, r.rate, r.burst, r.kfull, r.kfi, t,
                      (s.em.send_size + FRAME_OVERHEAD_BYTES) * 8, true,
                      interval, sl.nb_thr);
    sl.nb_txb = wadd(sl.nb_txb, s.em.send_size);
    s.dep = dep;
    s.lost = draw && lost_at(0);
    if (s.lost) sl.n_loss = wadd(sl.n_loss, 1);
    if (b.dyn_runahead) sl.min_lat = imin(sl.min_lat, r.lat);
    s.arr = dep + r.lat;
    if (s.arr < we) s.arr = we;
  }
  s.lseq = sl.local_seq;
  if (s.em.rto_valid) sl.local_seq = wadd(sl.local_seq, 1);

  // the burst (client rows: the law's role gate empties server bursts)
  const int32_t sent0 = s.em.send_valid ? 1 : 0;
  for (int32_t u = 0; u < s.cnt; ++u) {
    const int32_t unit = wadd(u0, u);
    const int32_t bsize = seg_wire_size(f, unit);
    const int32_t bits = (bsize + FRAME_OVERHEAD_BYTES) * 8;
    const int64_t dep =
        u == 0 ? bucket_charge(sl.up, r.rate, r.burst, r.kfull, r.kfi, t,
                               bits, true, interval, sl.nb_thr)
               : bucket_charge_chained(sl.up, r.rate, r.burst, t, bits,
                                       interval, sl.nb_thr);
    sl.nb_txb = wadd(sl.nb_txb, bsize);
    const int32_t bseq = wadd(s.seq, sent0 + u);
    const bool lost = draw && lost_at(sent0 + u);
    if (lost) sl.n_loss = wadd(sl.n_loss, 1);
    if (b.dyn_runahead) sl.min_lat = imin(sl.min_lat, r.lat);
    int64_t arr = dep + r.lat;
    if (arr < we) arr = we;
    burst(u, !lost, lost, dep, arr, bseq, bsize,
          wshl(seg_flags(f, unit), PAY_SEQ_BITS) | unit, f.rcv_nxt,
          u < s.n_re);
  }
  sl.send_seq = wadd(sl.send_seq, wadd(sent0, s.cnt));
  sl.n_sends = wadd(sl.n_sends, wadd(sent0, s.cnt));
  return s;
}

// The stream arm of slot j for lane i (the reference's _process_slot stream
// tier and compacted channels), run by the lane's warp in lockstep: every
// warp lane holds the same popped event and the same lane state.  The
// lane's endpoint row that the event stimulates — a start marker opens a
// client flow, an RTO local owned by the row's flow fires its timer, a
// stream segment (non-zero payload; at a server row only from its own
// client) runs on_segment — takes stream_stimulus on the lane's up bucket
// and counters, its loss draws made beforehand one a warp lane (counters
// send_seq + lane, as F's walk draws them).  Every entry of the stream block
// and every stream loss record (and with stream_pcap every capture record,
// with flowtrace every flow record flag of the control-send and burst
// groups) of the lane's rows for slot j is written, valid or not: a row's
// control send and RTO arm by warp lane (row - r0) % 32, and on a client row
// burst unit u — its entry or the canonical empty, its loss record, capture
// row and flow flags — by warp lane u.  [r0, r1): the lane's rows in
// lane_ep_rows.
__device__ void stream_slot_warp(const LaneBufs& b, int64_t i, int64_t j,
                                 int32_t r0, int32_t r1, bool act,
                                 int32_t kind, int32_t src, int32_t size,
                                 int32_t phi, int32_t plo, int32_t thi,
                                 int32_t tlo, int64_t we, StreamLane sl) {
  const int ln = threadIdx.x & 31;
  const int64_t sf = b.s_flows, s2 = 2 * sf, k = b.k;
  const int64_t n_ent = 4 * k * sf + k * PUMP_BURST * sf;
  const int32_t lane = static_cast<int32_t>(i);
  const int64_t t = join_raw(thi, tlo);
  const bool ft = b.flowtrace != 0;
  const int64_t gw_s = k * s2, gw_b = k * PUMP_BURST * sf;  // flow groups
  const int32_t auxh_pkt = (PACKET << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  const int32_t auxh_loc = (LOCAL << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);

  // the stimulated row (at most one per lane and slot): the first of the
  // lane's rows the event stimulates, the rows tested a warp lane each
  int32_t e = -1, stim = 0;  // 1 open, 2 RTO, 3 segment
  for (int32_t rb = r0; act && rb < r1 && e < 0; rb += 32) {
    int32_t row = 0, st = 0;
    if (rb + ln < r1) {
      row = b.lane_ep_rows[rb + ln];
      const bool cl = row < sf;
      if (kind == LOCAL && size == -1 && cl) {
        st = 1;
      } else if (kind == LOCAL && size == SZ_RTO && plo == b.flow_clid[row]) {
        st = 2;
      } else if (kind == DELIVERY && (phi | plo) != 0 &&
                 (cl || src == b.flow_clid[row])) {
        st = 3;
      }
    }
    const unsigned hit = __ballot_sync(FULL_MASK, st != 0);
    if (hit) {
      const int at = __ffs(hit) - 1;
      e = __shfl_sync(FULL_MASK, row, at);
      stim = __shfl_sync(FULL_MASK, st, at);
    }
  }

  // burst unit ln of the stimulated row, as the law hands it to the sink
  bool u_valid = false, u_lost = false, u_retx = false;
  int64_t u_dep = 0, u_arr = 0;
  int32_t u_seq = 0, u_size = 0, u_phi = 0, u_plo = 0;
  Sends sd;
  bool smp = false, capture = false;
  if (e >= 0) {
    int32_t* frow = b.stream + static_cast<int64_t>(e) * N_COLS;
    Flow f;
    flow_load(f, frow);
    f.role = e < sf ? SENDER : RECEIVER;
    f.segs = b.flow_segs[e];
    f.mss = b.flow_mss[e];
    f.last_bytes = b.flow_last[e];
    f.cc = b.flow_cc[e];
    capture = b.flow_pcap[e] != 0;
    smp = ft && flow_sampled(b, lane, b.flow_peers[e]);
    const UpRow ur = up_row(b, e);
    uint32_t lost = 0;  // the draws of the stimulus's sends
    if (b.has_loss && t >= b.bootstrap_end) {
      const uint32_t d = lane_draw(static_cast<uint32_t>(b.seed_lo),
                                   static_cast<uint32_t>(b.seed_hi),
                                   static_cast<uint32_t>(lane) | LOSS_STREAM,
                                   static_cast<uint32_t>(wadd(sl.send_seq, ln)));
      lost = __ballot_sync(FULL_MASK, static_cast<int64_t>(d) < ur.thresh);
    }
    sd = stream_stimulus(
        b, f, stim, Pair{thi, tlo}, t, phi, plo, size, we, ur, sl,
        [&](int32_t u, bool valid, bool lost_u, int64_t dep, int64_t arr,
            int32_t bseq, int32_t bsize, int32_t bphi, int32_t bplo,
            bool retx) {
          if (u != ln) return;
          u_valid = valid;
          u_lost = lost_u;
          u_dep = dep;
          u_arr = arr;
          u_seq = bseq;
          u_size = bsize;
          u_phi = bphi;
          u_plo = bplo;
          u_retx = retx;
        },
        WarpDraw{lost});
    if (ln == 0) flow_store(f, frow);
  }
  const Emit& em = sd.em;

  // the lane's rows, a warp lane each: control sends, their loss records
  // (and captures, flow groups), RTO arms; then each client row's bursts
  for (int32_t rb = r0; rb < r1; rb += 32) {
    const int32_t r = rb + ln;
    int32_t row = 0, peer = 0;
    if (r < r1) {
      row = b.lane_ep_rows[r];
      peer = b.flow_peers[row];
      const bool se_v = row == e && em.send_valid;
      put_entry(b, n_ent, j * s2 + row, se_v && !sd.lost, peer, sd.arr,
                auxh_pkt, sd.seq, em.send_size,
                wshl(em.send_flags, PAY_SEQ_BITS) | em.send_seq, em.send_ack);
      put_loss(b, b.rec_srec + j * s2 + row, se_v && sd.lost, t, lane, peer,
               sd.seq, em.send_size);
      if (b.stream_pcap)
        put_rec(b, b.rec_spc + j * s2 + row, se_v && b.flow_pcap[row] != 0,
                sd.dep, lane, peer, sd.seq, em.send_size, PCAP_TX);
      if (ft)
        send_flows(b, b.fl_ss + j * s2 + row, gw_s,
                   se_v && flow_sampled(b, lane, peer), sd.lost, t, sd.dep,
                   sd.arr, em.send_retx ? FT_RETRANSMIT : FT_SEND, lane, peer,
                   sd.seq, em.send_size);
      put_entry(b, n_ent, k * s2 + j * s2 + row, row == e && em.rto_valid,
                lane, join_raw(em.rto_t.hi, em.rto_t.lo), auxh_loc, sd.lseq,
                SZ_RTO, 0, b.flow_clid[row]);
    }
    for (unsigned cl = __ballot_sync(FULL_MASK, r < r1 && row < sf); cl;
         cl &= cl - 1) {
      const int at = __ffs(cl) - 1;
      const int32_t crow = __shfl_sync(FULL_MASK, row, at);
      const int32_t cpeer = __shfl_sync(FULL_MASK, peer, at);
      if (ln < PUMP_BURST) {  // burst unit ln of this client row
        const bool mine = crow == e && ln < sd.cnt;
        const int64_t slot = j * PUMP_BURST + ln;
        put_entry(b, n_ent, 4 * k * sf + slot * sf + crow, mine && u_valid,
                  cpeer, u_arr, auxh_pkt, u_seq, u_size, u_phi, u_plo);
        put_loss(b, b.rec_brec + slot * sf + crow, mine && u_lost, t, lane,
                 cpeer, u_seq, u_size);
        if (b.stream_pcap)
          put_rec(b, b.rec_bpc + slot * sf + crow, mine && capture, u_dep,
                  lane, cpeer, u_seq, u_size, PCAP_TX);
        if (ft)
          send_flows(b, b.fl_bs + slot * sf + crow, gw_b, mine && smp, u_lost,
                     t, u_dep, u_arr, u_retx ? FT_RETRANSMIT : FT_SEND, lane,
                     cpeer, u_seq, u_size);
      }
    }
  }
}

// the sum of v over the block, added to *dst by one atomic (an integer sum:
// the order of the blocks does not matter); every thread of the block calls
// it
__device__ __forceinline__ void block_add(int32_t v, int32_t* dst) {
  __shared__ int32_t part[32];
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t sum = 0;
    for (unsigned w = 0; w < (blockDim.x + 31) / 32; ++w) sum += part[w];
    if (sum != 0) atomicAdd(dst, sum);
  }
}

// ---- kernel A: lane_slots ---------------------------------------------------
// Each lane pops its first K queue columns under the co-pop rule and runs
// the slot law on each popped column: down bucket + CoDel for PACKET pops,
// delivered inline on passive lanes or as a DELIVERY self-insert on active
// ones; the app sends (tgen ticks, phold hops to a threefry peer, ping
// requests and echoes) with the up bucket, the latency gather and the
// threefry loss draw, and with pcap a capturing lane's PCAP_TX record at the
// send's departure; the timer re-arms; and on stream lanes the stream arm.
// With netobs the lane's byte and throttle counters follow every charge, and
// the block's popped PACKETs join the window's count (one atomic a block).
// With flowtrace each slot writes the flags of its seven [N] flow groups —
// the send, its up-bucket wait, loss and queue entry; the arrival's
// down-bucket wait, CoDel drop or delivery — and the records of the sampled
// flows.
//
// Decide, then walk.  A lane's walk is a group of L threads of one warp
// (L = lanes.slot_group(K): about K / 2, at most 32), thread gl taking the
// columns gl, gl + L, ... a round each, SLOT_THREADS a block, so the lanes
// spread over every SM.  Every thread of the group loads the lane's state
// and table row (one request a sector) and its round's column, all before
// any use.  What a column does depends only on its words and on counters
// that step with the popped kinds — whether it acts (the co-pop prefixes),
// whether it sends and to whom (the mesh peer at m_peer_offset, the phold
// peer's APP_STREAM draw at app_draws, ping's budget m_sent), its send
// sequence number and its re-arm's local sequence — so each thread decides
// its column at once from the group's ballots (exclusive prefix counts),
// and issues its gathers (node_of, lat, thresh) and its draws (APP, LOSS)
// beside the others': a round's threefry evaluations in flight together,
// not in a row.  Only the two buckets and CoDel chain from column to
// column: the group walks them over the acting columns in lockstep, on
// values shuffled from each column's thread, with no load left in the chain
// but CoDel's divisor table; then each thread writes its column's emits and
// group lane 0 the lane's state.  Every counter ends where the serial walk
// ends it.
//
// A lane that owns flow endpoint rows (the stream models on an untiered
// run: b.s_flows > 0) takes a warp of its own instead, in blocks after the
// groups' (one warp per first row of a lane in lane_ep_rows): the stream arm
// shares the up bucket and the send counters with the slot law, so its warp
// walks every column in order, in lockstep, and runs the arm of each
// (stream_slot_warp) with a burst unit a warp lane.  Only the instance for
// runs with streams (STREAMS) compiles the arm; the groups never wait in a
// warp behind a stream lane.
constexpr int SLOT_THREADS = 128;
constexpr int SLOT_GROUP_MAX = 32;  // lanes.SLOT_GROUP_MAX

// a lane's group of L threads within its warp: this thread's column offset
// gl, the group's first warp lane and its lanes' mask.  Every ballot and
// shuffle is the whole warp's (each group reads its own segment), made by
// every thread at a warp-uniform point: a group's own mask would let the
// groups of a warp part at the first intrinsic and run one after another
// from there (measured: the lanes' time grew with the groups a warp)
struct Group {
  int gl, L, base;
  unsigned own;
  __device__ __forceinline__ unsigned lower() const {
    return ((1u << gl) - 1u) << base;
  }
  __device__ __forceinline__ unsigned bits(bool p) const {
    return __ballot_sync(FULL_MASK, p) & own;
  }
  template <class T>
  __device__ __forceinline__ T from(T v, int x) const {
    return __shfl_sync(FULL_MASK, v, x, L);
  }
  // the minimum over the group
  __device__ __forceinline__ int32_t min(int32_t v) const {
    for (int d = 1; d < L; d <<= 1) {
      const int32_t o = __shfl_xor_sync(FULL_MASK, v, d, L);
      v = o < v ? o : v;
    }
    return v;
  }
};

// a lane's table row and model flags
struct LaneLaw {
  int32_t dn_rate, dn_burst, dn_kfull, dn_kfi, up_rate, up_burst, up_kfull,
      up_kfi, recv_mult, p_size, p_count, p_peer, p_stride, my_node;
  int64_t p_int;
  bool passive, ext, capture, mesh, client, phold, ping_cl, ping_sv, stream;
};

__device__ __forceinline__ LaneLaw lane_law(const LaneBufs& b, int64_t i) {
  LaneLaw w;
  w.dn_rate = b.dn_rate[i];
  w.dn_burst = b.dn_burst[i];
  w.dn_kfull = b.dn_kfull[i];
  w.dn_kfi = b.dn_kfi[i];
  w.up_rate = b.up_rate[i];
  w.up_burst = b.up_burst[i];
  w.up_kfull = b.up_kfull[i];
  w.up_kfi = b.up_kfi[i];
  w.recv_mult = b.recv_mult[i];
  w.p_size = b.p_size[i];
  w.p_count = b.p_count[i];
  w.p_peer = b.p_peer[i];
  w.p_stride = b.p_stride[i];
  w.my_node = b.node_of[i];
  w.p_int = join_raw(b.p_int_hi[i], b.p_int_lo[i]);
  const int32_t model = b.model[i];
  w.passive = model == M_NONE || model == M_TGEN_MESH ||
              model == M_TGEN_CLIENT || model == M_TGEN_SERVER;
  // hybrid: an external lane's packets neither deliver inline nor insert;
  // their outcomes go to the egress candidates
  w.ext = b.ext_any && b.lane_external[i] != 0;
  w.capture = b.pcap && b.lane_pcap[i] != 0;
  w.mesh = model == M_TGEN_MESH;
  w.client = model == M_TGEN_CLIENT;
  w.phold = model == M_PHOLD;
  w.ping_cl = model == M_PING_CLIENT;
  w.ping_sv = model == M_PING_SERVER;
  w.stream = model == M_STREAM_CLIENT || model == M_STREAM_SERVER;
  return w;
}

// a lane's state words in registers
struct LaneVars {
  Bucket dn, up;
  int32_t fat_hi, fat_lo;
  int64_t cd_dn;
  int32_t dcount;
  uint8_t dropping;
  int32_t send_seq, local_seq, app_draws, m_sent, peer_off, n_del, n_codel,
      n_loss, n_hops, recv, n_sends, nb_txb, nb_rxb, nb_thr, min_lat;
};

__device__ __forceinline__ LaneVars lane_vars(const LaneBufs& b, int64_t i) {
  LaneVars v;
  v.dn = Bucket{b.dn_tokens[i], join_raw(b.dn_nr_hi[i], b.dn_nr_lo[i]),
                join_raw(b.dn_ld_hi[i], b.dn_ld_lo[i])};
  v.up = Bucket{b.up_tokens[i], join_raw(b.up_nr_hi[i], b.up_nr_lo[i]),
                join_raw(b.up_ld_hi[i], b.up_ld_lo[i])};
  v.fat_hi = b.cd_fat_hi[i];
  v.fat_lo = b.cd_fat_lo[i];
  v.cd_dn = join_raw(b.cd_dnext_hi[i], b.cd_dnext_lo[i]);
  v.dcount = b.cd_drop_count[i];
  v.dropping = b.cd_dropping[i];
  v.send_seq = b.send_seq[i];
  v.local_seq = b.local_seq[i];
  v.app_draws = b.app_draws[i];
  v.m_sent = b.m_sent[i];
  v.peer_off = b.m_peer_offset[i];
  v.n_del = b.n_delivered[i];
  v.n_codel = b.n_codel[i];
  v.n_loss = b.n_loss[i];
  v.n_hops = b.n_hops[i];
  v.recv = b.recv_bytes[i];
  v.n_sends = b.n_sends[i];
  v.nb_txb = v.nb_rxb = v.nb_thr = 0;
  if (b.netobs) {
    v.nb_txb = b.nb_txb[i];
    v.nb_rxb = b.nb_rxb[i];
    v.nb_thr = b.nb_thr[i];
  }
  v.min_lat = NEVER32;
  return v;
}

__device__ __forceinline__ void store_vars(const LaneBufs& b, int64_t i,
                                           const LaneVars& v) {
  b.dn_tokens[i] = v.dn.tokens;
  split(v.dn.nr, &b.dn_nr_hi[i], &b.dn_nr_lo[i]);
  split(v.dn.ld, &b.dn_ld_hi[i], &b.dn_ld_lo[i]);
  b.up_tokens[i] = v.up.tokens;
  split(v.up.nr, &b.up_nr_hi[i], &b.up_nr_lo[i]);
  split(v.up.ld, &b.up_ld_hi[i], &b.up_ld_lo[i]);
  b.cd_fat_hi[i] = v.fat_hi;
  b.cd_fat_lo[i] = v.fat_lo;
  split(v.cd_dn, &b.cd_dnext_hi[i], &b.cd_dnext_lo[i]);
  b.cd_drop_count[i] = v.dcount;
  b.cd_dropping[i] = v.dropping;
  b.send_seq[i] = v.send_seq;
  b.local_seq[i] = v.local_seq;
  b.m_sent[i] = v.m_sent;
  b.m_peer_offset[i] = v.peer_off;
  b.n_delivered[i] = v.n_del;
  b.n_codel[i] = v.n_codel;
  b.recv_bytes[i] = v.recv;
  b.n_sends[i] = v.n_sends;
  b.app_draws[i] = v.app_draws;
  b.n_loss[i] = v.n_loss;
  b.n_hops[i] = v.n_hops;
  if (b.netobs) {
    b.nb_txb[i] = v.nb_txb;
    b.nb_rxb[i] = v.nb_rxb;
    b.nb_thr[i] = v.nb_thr;
  }
  // the smallest latency sent over (exact: min is order-free)
  if (v.min_lat < NEVER32) atomicMin(b.min_used_lat, v.min_lat);
}

// one queue column of a lane as its thread holds it: the popped words, the
// decision, the gathers and draws, and the walk's results
struct Slot {
  int32_t thi, tlo, auxh, seq, size, phi, plo, kind, src;
  int64_t t, td, dep;
  bool act, is_pkt, do_send, rearm, lost, drop;
  int32_t dst, lat, out_size, snd_seq, arm_seq;
  int64_t thresh;
};

// Slot j's emits, by its thread: the pop, the egress candidate, the
// DELIVERY insert and the re-arm in the self block, the outbound packet,
// the slot's record, the send's capture and the slot's flow groups.
__device__ void slot_emit(const LaneBufs& b, int64_t i, int64_t j,
                          const LaneLaw& w, const Slot& s, int64_t we) {
  const int64_t n = b.n, k = b.k, sw = b.sw, nk = n * k, nsw = n * sw;
  const int32_t lane = static_cast<int32_t>(i);
  const bool streams = b.s_flows > 0;
  const bool drop = s.drop, lost = s.lost, do_send = s.do_send;
  const bool deliver = s.is_pkt && !drop;
  const int64_t qi = i * b.c + j, oi = j * n + i;
  if (s.act) {
    b.q_thi[qi] = NEVER32;
    b.q_tlo[qi] = NEVER32;
  }
  // external lanes egress (CoDel drops too), slot-major as the reference
  // appends
  if (b.ext_any) {
    const bool eg = s.is_pkt && w.ext;
    int64_t* row = b.eg_recs + oi * 6;
    row[0] = eg ? s.td : 0;
    row[1] = eg ? s.src : 0;
    row[2] = eg ? lane : 0;
    row[3] = eg ? s.seq : 0;
    row[4] = eg ? s.size : 0;
    row[5] = eg ? (drop ? DROP_CODEL : DELIVERED) : 0;
    b.eg_valid[oi] = eg ? 1 : 0;
  }
  // active lanes get a DELIVERY self-insert keyed by the packet's (src,
  // seq); passive lanes counted the delivery inline
  if (!b.all_passive) {
    const int64_t si = i * sw + j;
    const bool ins = deliver && !w.passive && !w.ext;
    int32_t ins_hi = NEVER32, ins_lo = NEVER32;
    if (ins) split(s.td, &ins_hi, &ins_lo);
    b.self_blk[0 * nsw + si] = ins_hi;
    b.self_blk[1 * nsw + si] = ins_lo;
    b.self_blk[2 * nsw + si] =
        ins ? (DELIVERY << AUX_KIND_SHIFT) | (s.src << AUX_SRC_SHIFT) : 0;
    b.self_blk[3 * nsw + si] = ins ? s.seq : 0;
    b.self_blk[4 * nsw + si] = ins ? s.size : 0;
    if (streams) {  // stream segments keep their payload words
      b.self_blk[5 * nsw + si] = ins ? s.phi : 0;
      b.self_blk[6 * nsw + si] = ins ? s.plo : 0;
    }
  }
  // the timer re-arm
  const int64_t ai = i * sw + (b.all_passive ? 0 : k) + j;
  int32_t arm_hi = NEVER32, arm_lo = NEVER32;
  if (s.rearm) split(s.t + w.p_int, &arm_hi, &arm_lo);
  b.self_blk[0 * nsw + ai] = arm_hi;
  b.self_blk[1 * nsw + ai] = arm_lo;
  b.self_blk[2 * nsw + ai] = (LOCAL << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  b.self_blk[3 * nsw + ai] = s.arm_seq;
  b.self_blk[4 * nsw + ai] = 0;
  if (streams) {
    b.self_blk[5 * nsw + ai] = 0;
    b.self_blk[6 * nsw + ai] = 0;
  }
  // outbound packet: arrival = max(depart + latency, window end), unless
  // the loss draw lost it
  int64_t arr = 0;
  if (do_send) {
    arr = s.dep + s.lat;
    if (arr < we) arr = we;
  }
  const bool out = do_send && !lost;
  int32_t a_hi = NEVER32, a_lo = NEVER32;
  if (out) split(arr, &a_hi, &a_lo);
  b.out_blk[0 * nk + oi] = out ? s.dst : static_cast<int32_t>(n);
  b.out_blk[1 * nk + oi] = a_hi;
  b.out_blk[2 * nk + oi] = a_lo;
  b.out_blk[3 * nk + oi] =
      out ? (PACKET << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT) : 0;
  b.out_blk[4 * nk + oi] = out ? s.snd_seq : 0;
  b.out_blk[5 * nk + oi] = out ? s.out_size : 0;
  // one record: the popped packet's outcome, or the send's loss
  if (b.log_cap > 0) {
    const int64_t r = b.rec_slots + oi;
    int64_t* row = b.recs + r * 6;
    if (s.is_pkt) {
      row[0] = s.td;
      row[1] = s.src;
      row[2] = lane;
      row[3] = s.seq;
      row[4] = s.size;
      row[5] = drop ? DROP_CODEL : DELIVERED;
    } else if (lost) {
      row[0] = s.t;
      row[1] = lane;
      row[2] = s.dst;
      row[3] = s.snd_seq;
      row[4] = s.out_size;
      row[5] = DROP_LOSS;
    } else {
      for (int x = 0; x < 6; ++x) row[x] = 0;
    }
    b.rec_valid[r] = (s.is_pkt || lost) ? 1 : 0;
  }
  // the send's capture, at its departure and before the loss draw
  if (b.pcap)
    put_rec(b, b.rec_pc + oi, do_send && w.capture, s.dep, lane, s.dst,
            s.snd_seq, s.out_size, PCAP_TX);
  // the slot's flow groups: the send (lane -> dst), the arrival (src ->
  // lane) at the down bucket's departure
  if (b.flowtrace) {
    const int64_t r = b.fl_slots + oi;
    send_flows(b, r, nk, do_send && flow_sampled(b, lane, s.dst), lost, s.t,
               s.dep, arr, FT_SEND, lane, s.dst, s.snd_seq, s.out_size);
    const bool ar = s.is_pkt && flow_sampled(b, s.src, lane);
    put_flow(b, r + 4 * nk, ar && s.td != s.t, s.td, FT_TB_WAIT, s.src, lane,
             s.seq, s.size, TB_DN);
    put_flow(b, r + 5 * nk, ar && drop, s.td, FT_DROP, s.src, lane, s.seq,
             s.size, CAUSE_CODEL);
    put_flow(b, r + 6 * nk, ar && !drop, s.td, FT_DELIVERY, s.src, lane, s.seq,
             s.size, 0);
  }
}

// The walk of lane i by its group g (STREAM: a stream lane's warp, the
// stream arm in every column; [r0, r1) its rows).  A group that is not
// `live` (past the last lane, or a stream lane's, walked by its warp) walks
// beside the others, storing nothing.  Returns the lane's popped PACKETs
// on group lane 0, 0 on the others.
template <bool STREAM>
__device__ int32_t lane_walk(const LaneBufs& b, int64_t i, bool live,
                             const Group& g, int32_t r0, int32_t r1) {
  const int64_t n = b.n, c = b.c, k = b.k;
  const bool streams = b.s_flows > 0;
  const int32_t interval = static_cast<int32_t>(b.interval);
  const int64_t we = join_raw(*b.now_we_hi, *b.now_we_lo);
  const int32_t lane = static_cast<int32_t>(i);
  const bool all_passive = b.all_passive != 0;
  const bool has_loss = b.has_loss != 0;
  const bool dyn = b.dyn_runahead != 0;
  const uint32_t seed_lo = static_cast<uint32_t>(b.seed_lo);
  const uint32_t seed_hi = static_cast<uint32_t>(b.seed_hi);
  const int32_t nm1 = n > 1 ? static_cast<int32_t>(n - 1) : 1;
  const LaneLaw w = lane_law(b, i);
  LaneVars v = lane_vars(b, i);
  // co-pop rule: passive lanes pop any prefix inside the window; active
  // lanes only a same-instant prefix of PACKETs, or column 0 alone; with
  // the wide rule, stream lanes also a prefix free of LOCALs (one-to-one)
  // or a PACKET-only or DELIVERY-only prefix (star).  The prefixes of the
  // columns before this round of the group:
  const bool ruled = !all_passive && !w.passive;
  const bool wide = b.wide_pop && w.stream;
  bool pkt_pre = true, nol_pre = true, del_pre = true;
  int32_t head_hi = 0, head_lo = 0, pkts = 0;

  for (int64_t j0 = 0; j0 < k; j0 += g.L) {
    const int64_t j = j0 + g.gl;
    const bool mine = j < k;
    Slot s;
    s.thi = s.tlo = NEVER32;
    s.auxh = s.seq = s.size = s.phi = s.plo = 0;
    if (mine) {  // this thread's column, loaded beside the lane's state
      const int64_t qi = i * c + j;
      s.thi = b.q_thi[qi];
      s.tlo = b.q_tlo[qi];
      s.auxh = b.q_auxh[qi];
      s.seq = b.q_auxl[qi];
      s.size = b.q_size[qi];
      if (streams) {
        s.phi = b.q_phi[qi];
        s.plo = b.q_plo[qi];
      }
    }
    s.t = join_t(s.thi, s.tlo);
    s.kind = s.auxh >> AUX_KIND_SHIFT;
    s.src = (s.auxh >> AUX_SRC_SHIFT) & SRC_MASK;
    if (j0 == 0) {
      head_hi = g.from(s.thi, 0);
      head_lo = g.from(s.tlo, 0);
    }
    const unsigned upto = g.lower() | (1u << (g.base + g.gl));
    const unsigned not_pkt = g.bits(mine && s.kind != PACKET);
    const unsigned local = g.bits(mine && s.kind == LOCAL);
    const unsigned not_del = g.bits(mine && s.kind != DELIVERY);
    bool allowed = true;
    if (ruled) {
      const bool pp = pkt_pre && !(not_pkt & upto);
      const bool nl = nol_pre && !(local & upto);
      const bool dp = del_pre && !(not_del & upto);
      allowed = j == 0 || (s.thi == head_hi && s.tlo == head_lo && pp);
      if (wide) allowed = allowed || (b.one_to_one ? nl : (pp || dp));
    }
    pkt_pre = pkt_pre && !not_pkt;
    nol_pre = nol_pre && !local;
    del_pre = del_pre && !not_del;
    s.act = mine && allowed && s.t < we;

    // decide: kinds, sends, re-arms
    const bool is_del = s.act && s.kind == DELIVERY;
    const bool is_loc = s.act && s.kind == LOCAL;
    const bool is_start = is_loc && s.size == -1;
    const bool is_timer = is_loc && s.size >= 0;
    s.is_pkt = s.act && s.kind == PACKET;
    const bool del_phold = is_del && w.phold;  // phold sends on
    const bool echo = is_del && w.ping_sv;     // the ping server echoes
    const bool mesh_tick = is_timer && w.mesh && n > 1;
    const bool client_tick = is_timer && w.client;
    // a ping tick while m_sent is under p_count: the first p_count - m_sent
    // timers of the walk
    const unsigned lo = g.lower();
    const int32_t timers_before = __popc(g.bits(is_timer) & lo);
    const bool ping_tick =
        is_timer && w.ping_cl &&
        static_cast<int64_t>(v.m_sent) + timers_before < w.p_count;
    // (phold's initial messages are size-0 timers that send)
    const bool send_phold = del_phold || (is_timer && w.phold);
    s.do_send = send_phold || echo || mesh_tick || client_tick || ping_tick;
    s.rearm = (is_start && (w.mesh || w.client || w.ping_cl)) || mesh_tick ||
              client_tick || ping_tick || (is_timer && w.mesh && n == 1);
    const unsigned m_pkt = g.bits(s.is_pkt), m_send = g.bits(s.do_send);
    const unsigned m_arm = g.bits(s.rearm), m_phold = g.bits(send_phold);
    const unsigned m_mesh = g.bits(mesh_tick);
    s.snd_seq = wadd(v.send_seq, __popc(m_send & lo));
    s.arm_seq = wadd(v.local_seq, __popc(m_arm & lo));

    // the destination: the phold peer (an APP_STREAM draw at its counter),
    // the echo's source, the mesh peer at its offset
    s.dst = w.p_peer;
    if (send_phold) {
      if (n == 1) {
        s.dst = lane;
      } else {
        const uint32_t u = lane_draw(
            seed_lo, seed_hi, static_cast<uint32_t>(lane) | APP_STREAM,
            static_cast<uint32_t>(wadd(v.app_draws, __popc(m_phold & lo))));
        const int64_t r = static_cast<int64_t>(
            (static_cast<uint64_t>(u) * static_cast<uint64_t>(nm1)) >> 32);
        s.dst = static_cast<int32_t>((i + 1 + r) % n);
      }
    } else if (echo) {
      s.dst = s.src;
    } else if (mesh_tick) {
      const int32_t off_raw =
          wadd(v.peer_off, wmul(w.p_stride, __popc(m_mesh & lo)));
      int32_t off = off_raw % nm1;
      if (off < 0) off += nm1;  // floor modulo, as the reference's %
      s.dst = static_cast<int32_t>((i + 1 + off) % n);
    }
    s.out_size = echo ? s.size : w.p_size;
    // the send's gathers and its LOSS_STREAM draw at counter snd_seq (never
    // before bootstrap_end); a stream lane draws in the walk, where its
    // sequence numbers are known
    s.lat = 0;
    s.thresh = 0;
    s.lost = false;
    const bool draw = has_loss && s.t >= b.bootstrap_end;
    if (s.do_send) {
      const int64_t pair =
          static_cast<int64_t>(w.my_node) * b.g + b.node_of[s.dst];
      s.lat = b.lat[pair];
      if (draw) s.thresh = b.thresh[pair];
      if (!STREAM && draw)
        s.lost = static_cast<int64_t>(lane_draw(
                     seed_lo, seed_hi, static_cast<uint32_t>(lane) | LOSS_STREAM,
                     static_cast<uint32_t>(s.snd_seq))) < s.thresh;
    }

    // walk the chain: the buckets and CoDel, column by column
    s.td = s.t;
    s.dep = s.t;
    s.drop = false;
    const int xn = static_cast<int>(k - j0 < g.L ? k - j0 : g.L);
    for (int x = 0; x < xn; ++x) {
      const unsigned bit = 1u << (g.base + x);
      const bool x_pkt = (m_pkt & bit) != 0, x_send = (m_send & bit) != 0;
      const int64_t xt = g.from(s.t, x);
      const int32_t xs = g.from(s.size, x), xo = g.from(s.out_size, x);
      const int32_t xl = g.from(s.lat, x);
      // a column that neither receives nor sends changes no chained word
      if (!STREAM && !x_pkt && !x_send) continue;
      int64_t td = xt, dep = xt;
      bool drop = false, lost = false;
      int32_t snd_seq = 0, arm_seq = 0;
      if (x_pkt) {
        td = bucket_charge(v.dn, w.dn_rate, w.dn_burst, w.dn_kfull, w.dn_kfi,
                           xt, (xs + FRAME_OVERHEAD_BYTES) * 8, true, interval,
                           v.nb_thr);
        int64_t sojourn = td - xt;
        if (sojourn > NEVER32) sojourn = NEVER32;
        drop = codel_offer(v.fat_hi, v.fat_lo, v.cd_dn, v.dcount, v.dropping,
                           td, sojourn, true, b.codel_div);
        if (drop) {
          v.n_codel = wadd(v.n_codel, 1);
        } else {
          v.n_del = wadd(v.n_del, 1);
          v.nb_rxb = wadd(v.nb_rxb, xs);
          // passive lanes count inline (each counting app on the host)
          if (w.passive && !w.ext) v.recv = wadd(v.recv, wmul(xs, w.recv_mult));
        }
      }
      if constexpr (STREAM) {
        snd_seq = v.send_seq;
        arm_seq = v.local_seq;
        if (x_send) {
          v.send_seq = wadd(v.send_seq, 1);
          v.n_sends = wadd(v.n_sends, 1);
        }
      }
      int64_t xth = 0;
      if constexpr (STREAM) xth = g.from(s.thresh, x);
      if (x_send) {
        dep = bucket_charge(v.up, w.up_rate, w.up_burst, w.up_kfull, w.up_kfi,
                            xt, (xo + FRAME_OVERHEAD_BYTES) * 8, true, interval,
                            v.nb_thr);
        v.nb_txb = wadd(v.nb_txb, xo);
        if constexpr (STREAM) {
          if (dyn) v.min_lat = xl < v.min_lat ? xl : v.min_lat;
          if (has_loss && xt >= b.bootstrap_end)
            lost = static_cast<int64_t>(lane_draw(
                       seed_lo, seed_hi, static_cast<uint32_t>(lane) | LOSS_STREAM,
                       static_cast<uint32_t>(snd_seq))) < xth;
          if (lost) v.n_loss = wadd(v.n_loss, 1);
        }
      }
      if (x == g.gl) {
        s.td = td;
        s.dep = dep;
        s.drop = drop;
        if constexpr (STREAM) {
          s.snd_seq = snd_seq;
          s.arm_seq = arm_seq;
          s.lost = lost;
        }
      }
      if constexpr (STREAM) {
        if (m_arm & bit) v.local_seq = wadd(v.local_seq, 1);
        const bool x_act = g.from(static_cast<int32_t>(s.act), x) != 0;
        const int32_t x_phi = g.from(s.phi, x), x_plo = g.from(s.plo, x);
        stream_slot_warp(
            b, i, j0 + x, r0, r1, x_act, g.from(s.kind, x), g.from(s.src, x),
            xs, x_act ? x_phi : 0, x_act ? x_plo : 0, g.from(s.thi, x),
            g.from(s.tlo, x), we,
            StreamLane{v.up, v.send_seq, v.local_seq, v.n_sends, v.n_loss,
                       v.min_lat, v.nb_txb, v.nb_thr});
      }
    }

    // the counters that step with the decided kinds
    pkts += __popc(m_pkt);
    v.app_draws = wadd(v.app_draws, __popc(m_phold));
    v.peer_off = wadd(v.peer_off, wmul(w.p_stride, __popc(m_mesh)));
    v.m_sent = wadd(v.m_sent, __popc(g.bits(client_tick || ping_tick)));
    v.n_hops = wadd(v.n_hops, __popc(g.bits(del_phold)));
    if constexpr (!STREAM) {
      v.send_seq = wadd(v.send_seq, __popc(m_send));
      v.n_sends = wadd(v.n_sends, __popc(m_send));
      v.local_seq = wadd(v.local_seq, __popc(m_arm));
      v.n_loss = wadd(v.n_loss, __popc(g.bits(s.lost)));
      if (dyn) {  // every send counts, lost or not
        const int32_t ml = g.min(s.do_send ? s.lat : NEVER32);
        v.min_lat = ml < v.min_lat ? ml : v.min_lat;
      }
    }
    if (live && mine) slot_emit(b, i, j, w, s, we);
  }
  if (!live || g.gl != 0) return 0;
  store_vars(b, i, v);
  return pkts;
}

// Every lane's walk: blocks [0, lane_blocks) hold the groups (one lane a
// group, a lane that owns endpoint rows skipped there when STREAMS), the
// blocks after them a warp per endpoint row r, whose lane walks there when
// r is its first row.
template <bool STREAMS, class P>
__global__ void __launch_bounds__(SLOT_THREADS)
    lane_slots_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int L = static_cast<int>(b.slot_group);
  const int ln = threadIdx.x & 31;
  const int64_t lane_blocks =
      (b.n * L + SLOT_THREADS - 1) / SLOT_THREADS;
  int32_t pkts = 0;
  if (!STREAMS || blockIdx.x < lane_blocks) {
    // every thread of the warp walks (see Group); a group past the last
    // lane walks the last lane's words, storing nothing
    int64_t i = (blockIdx.x * static_cast<int64_t>(SLOT_THREADS) +
                 threadIdx.x) / L;
    bool live = i < b.n;
    if (!live) i = b.n - 1;
    if (STREAMS && live) live = b.lane_ep_start[i] == b.lane_ep_start[i + 1];
    const int base = ln & ~(L - 1);
    const Group g{ln - base, L, base,
                  L == 32 ? FULL_MASK : ((1u << L) - 1u) << base};
    pkts = lane_walk<false>(b, i, live, g, 0, 0);
  } else if constexpr (STREAMS) {
    const int64_t r = (blockIdx.x - lane_blocks) * (SLOT_THREADS / 32) +
                      (threadIdx.x >> 5);
    if (r < 2 * b.s_flows) {
      const int64_t i = b.flow_lanes[b.lane_ep_rows[r]];
      const int32_t r0 = b.lane_ep_start[i];
      if (r0 == r)  // the whole warp
        pkts = lane_walk<true>(b, i, true, Group{ln, 32, 0, FULL_MASK}, r0,
                               b.lane_ep_start[i + 1]);
    }
  }
  if (b.netobs) block_add(pkts, b.nb_win);
}

// ---- kernel B: exchange_merge -----------------------------------------------
// A counting sort of the exchanged entries by destination (count, scan,
// place) — the outbound block, then in star stream configs the stream
// block — then one block per lane merges [queue C | self S | cross Cx] by the
// event key in shared memory and keeps the first C (S = sw: K re-arms, or K
// DELIVERY inserts then K re-arms).  Entries are `words` words: the key,
// the size and, when streams run, the two payload words.  On a tiered run
// the block of a stream-endpoint lane diverts its cross entries: it copies
// them to its endpoint row of the tier block's cross channel (G merges
// them) and gives them the NEVER time in its own merge.

// where the tier block's channels start (lanes.py LaneParams.tier_layout):
// DELIVERY fallbacks [K_s, 2S] at 0, RTO arms, control sends (emitter
// rows), bursts [K_s, B, S], the diverted cross entries [2S, Cx]
struct TierLayout {
  int64_t sa, se, bo, cx;
};
__device__ __forceinline__ TierLayout tier_layout(const LaneBufs& b) {
  const int64_t sa = b.ks * 2 * b.tier_s;
  return {sa, 2 * sa, 3 * sa, 3 * sa + b.ks * PUMP_BURST * b.tier_s};
}

__device__ __forceinline__ int64_t stream_entries(const LaneBufs& b) {
  return 4 * b.k * b.s_flows + b.k * PUMP_BURST * b.s_flows;
}

// destination of exchanged entry m: the outbound block, then the stream block
__device__ __forceinline__ int32_t x_dst(const LaneBufs& b, int64_t m) {
  const int64_t nk = b.k * b.n;
  return m < nk ? b.out_blk[m] : b.sx_blk[m - nk];
}

// Exclusive scan of x_cnt into x_start by one block (of any width that is a
// multiple of 32, up to 1024): tiles of blockDim x SCAN_ITEMS counts, each
// thread SCAN_ITEMS consecutive ones in registers (16-byte loads and stores
// where the row is aligned; loads through L2, where the counts' atomics
// landed), a warp-shuffle scan of the thread sums and one of the warp sums:
// two barriers a tile, one tile at 10k lanes (the count kernel's blocks).
constexpr int SCAN_ITEMS = 12;
constexpr int COUNT_THREADS = 1024;

__device__ void scan_counts(const LaneBufs& b) {
  __shared__ int32_t warp_sum[32];
  const int64_t n = b.n;
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool vec = ((reinterpret_cast<uintptr_t>(b.x_cnt) |
                     reinterpret_cast<uintptr_t>(b.x_start)) & 15) == 0;
  int32_t carry = 0;
  for (int64_t base = 0; base < n;
       base += static_cast<int64_t>(blockDim.x) * SCAN_ITEMS) {
    const int64_t lo = base + threadIdx.x * static_cast<int64_t>(SCAN_ITEMS);
    const bool whole = vec && lo + SCAN_ITEMS <= n;
    int32_t v[SCAN_ITEMS];
    if (whole) {
#pragma unroll
      for (int q = 0; q < SCAN_ITEMS; q += 4) {
        const int4 x = __ldcg(reinterpret_cast<const int4*>(b.x_cnt + lo + q));
        v[q] = x.x;
        v[q + 1] = x.y;
        v[q + 2] = x.z;
        v[q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < SCAN_ITEMS; ++q)
        v[q] = lo + q < n ? __ldcg(b.x_cnt + lo + q) : 0;
    }
    int32_t sum = 0;
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS; ++q) sum += v[q];
    int32_t inc = sum;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL_MASK, inc, d);
      if (ln >= d) inc += y;
    }
    if (ln == 31) warp_sum[wp] = inc;
    __syncthreads();
    if (wp == 0) {
      int32_t ws = ln < nw ? warp_sum[ln] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(FULL_MASK, ws, d);
        if (ln >= d) ws += y;
      }
      warp_sum[ln] = ws;
    }
    __syncthreads();
    int32_t run = carry + (wp > 0 ? warp_sum[wp - 1] : 0) + inc - sum;
    carry += warp_sum[nw - 1];
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS; ++q) {
      const int32_t x = v[q];
      v[q] = run;
      run += x;
    }
    if (whole) {
#pragma unroll
      for (int q = 0; q < SCAN_ITEMS; q += 4)
        *reinterpret_cast<int4*>(b.x_start + lo + q) =
            make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else {
#pragma unroll
      for (int q = 0; q < SCAN_ITEMS; ++q)
        if (lo + q < n) b.x_start[lo + q] = v[q];
    }
    __syncthreads();  // warp_sum is read before the next tile writes it
  }
}

// After a block's counts: the scenario's last block to finish (a ticket in
// x_done, reset for the next call) scans them, so no launch of its own
// waits for the counts.  Every thread of the block calls it.
__device__ __forceinline__ void scan_if_last(const LaneBufs& b) {
  __shared__ bool last;
  __threadfence();  // this thread's atomics before the block's ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(b.x_done, 1) == static_cast<int32_t>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every block's counts before the scan reads them
  scan_counts(b);
  if (threadIdx.x == 0) *b.x_done = 0;
}

// count the exchanged entries per destination (atomics), then scan (B)
template <class P>
__global__ void x_count_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;  // every block of the scenario
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m < b.n_x) {
    const int32_t d = x_dst(b, m);
    if (d < b.n) atomicAdd(&b.x_cnt[d], 1);
  }
  scan_if_last(b);
}

template <class P>
__global__ void x_place_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m >= b.n_x) return;
  const int32_t d = x_dst(b, m);
  if (d < b.n) {
    const int32_t pos = b.x_start[d] + atomicAdd(&b.x_fill[d], 1);
    b.x_order[pos] = static_cast<int32_t>(m);
  }
}

// The merges are templates on the words an entry has (W = 5, or 7 with the
// stream payload words), so every per-word loop unrolls and the queue
// pointers stay in registers.

// Load the queue row of `lane` into entries e[0, C) of W words.
template <int W>
__device__ __forceinline__ void load_queue_row(const LaneBufs& b, int32_t* e,
                                               int64_t lane) {
  int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                         b.q_phi, b.q_plo};
  for (int64_t x = threadIdx.x; x < b.c; x += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) e[W * x + w] = q[w][lane * b.c + x];
  }
}

// ---- the row sort (B, E, H) -------------------------------------------------
// A merge ranks its row by sorting it: an entry's key is its four key words,
// then its index in the row, so (key, index) is a total order and any
// correct sort gives the plain version's stable order.  A key travels as
// five unsigned words, most significant first (each int32 key word with its
// sign bit flipped, so unsigned order is the words' signed order; the index
// last), and compares as one 160-bit number: a chain of five subtractions
// whose final borrow is the answer.  Runs of 32 sort in a warp's registers
// by a bitonic network (shuffle steps, no barrier).  A block-form row of at
// most one entry a thread then merges its runs pairwise: each entry finds
// its place in the merged run by a binary search of the partner run (log2
// of the runs levels, two barriers each); a wider row (the m_scratch rows)
// runs the network's steps that cross runs over the index array instead,
// one barrier a step.  B's group selection sorts entry indices the same
// way.
constexpr int32_t PAD_INDEX = 0x7FFFFFFF;  // sorts after every entry index

struct Key {
  uint32_t th, tl, ah, al;  // the time pair and the aux pair, in key order
  uint32_t x;               // the entry's index
};

__device__ __forceinline__ uint32_t key_word(int32_t w) {
  return static_cast<uint32_t>(w) ^ 0x80000000u;
}
__device__ __forceinline__ int32_t word_of(uint32_t k) {
  return static_cast<int32_t>(k ^ 0x80000000u);
}
__device__ __forceinline__ Key make_key(int32_t k0, int32_t k1, int32_t k2,
                                        int32_t k3, int32_t x) {
  return Key{key_word(k0), key_word(k1), key_word(k2), key_word(k3),
             static_cast<uint32_t>(x)};
}

// a < b as 160-bit numbers: the borrow out of a - b
__device__ __forceinline__ bool lt(const Key& a, const Key& b) {
  uint32_t borrow;
  asm("{\n\t"
      ".reg .u32 d, z;\n\t"
      "mov.u32 z, 0;\n\t"
      "sub.cc.u32 d, %1, %6;\n\t"
      "subc.cc.u32 d, %2, %7;\n\t"
      "subc.cc.u32 d, %3, %8;\n\t"
      "subc.cc.u32 d, %4, %9;\n\t"
      "subc.cc.u32 d, %5, %10;\n\t"
      "subc.u32 %0, z, z;\n\t"
      "}"
      : "=r"(borrow)
      : "r"(a.x), "r"(a.al), "r"(a.ah), "r"(a.tl), "r"(a.th), "r"(b.x),
        "r"(b.al), "r"(b.ah), "r"(b.tl), "r"(b.th));
  return borrow != 0;
}
__device__ __forceinline__ bool lt(int32_t a, int32_t b) { return a < b; }

__device__ __forceinline__ Key shfl_xor(const Key& v, int m) {
  return Key{__shfl_xor_sync(FULL_MASK, v.th, m),
             __shfl_xor_sync(FULL_MASK, v.tl, m),
             __shfl_xor_sync(FULL_MASK, v.ah, m),
             __shfl_xor_sync(FULL_MASK, v.al, m),
             __shfl_xor_sync(FULL_MASK, v.x, m)};
}
__device__ __forceinline__ int32_t shfl_xor(int32_t v, int m) {
  return __shfl_xor_sync(FULL_MASK, v, m);
}

// the key of an entry past the row (a pad): after every entry (one whose
// words are all NEVER32 too, by index)
__device__ __forceinline__ Key pad_key(int32_t x) {
  return Key{~0u, ~0u, ~0u, ~0u, static_cast<uint32_t>(x)};
}

// The network's steps j = j_hi .. 1 of its stage k on one value a lane of a
// full warp, whose lane holds element i of the sequence: element i takes
// its partner's value (i ^ j) where that is smaller and i keeps the smaller
// (its stage ascending and i the lower, or descending and i the upper),
// or where it is not smaller and i keeps the larger.  Equal values occur
// only among pads, where either is right.
template <class T>
__device__ __forceinline__ T warp_steps(T v, int i, int k, int j_hi) {
  const bool up = (i & k) == 0;
#pragma unroll
  for (int j = j_hi; j > 0; j >>= 1) {
    const T o = shfl_xor(v, j);
    const bool keep_min = ((i & j) == 0) == up;
    if (lt(o, v) == keep_min) v = o;
  }
  return v;
}

// the stages 2 .. len (len a power of two up to 32) on lanes of element i:
// each run of len ascending where (i & len) is 0, descending elsewhere
template <class T>
__device__ __forceinline__ T warp_sort(T v, int i, int len = 32) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
    if (k <= len) v = warp_steps(v, i, k, k >> 1);
  return v;
}

// the smallest power of two >= w (lanes.sort_width)
__host__ __device__ __forceinline__ int64_t sort_width(int64_t w) {
  int64_t len = 1;
  while (len < w) len <<= 1;
  return len;
}

// Sort a[0, len) ascending by key_of(value), a Key whose x is the value
// itself; len is a power of two, and a[n, len) (n <= len) hold values that
// sort after every other and stay in place.  Every thread of the block calls
// it after a __syncthreads that completes a[], and every thread sees the
// sorted array when it returns.
template <class KeyOf>
__device__ void block_sort(int32_t* a, int len, int n, KeyOf key_of) {
  const int ln = threadIdx.x & 31, nt = blockDim.x;
  const int warps = nt >> 5, wp = threadIdx.x >> 5;
  const bool merge = n <= nt;  // one entry a thread: merge the runs
  // the network sorts every run; the merge only those holding entries
  const int runs = merge ? (n + 31) / 32 : len / 32;
  // runs of 32 in registers: ascending each (merge), or alternating as the
  // network's stage 64 takes them
  for (int r = wp; r < runs; r += warps) {
    const int i = 32 * r + ln;
    Key v = i < len ? key_of(a[i]) : pad_key(PAD_INDEX);
    v = warp_sort(v, merge ? ln : i & 63, len < 32 ? len : 32);
    if (i < len) a[i] = v.x;
  }
  __syncthreads();
  if (merge) {
    // each entry's place in the merged pair of runs: its place in its own
    // run and the count of the partner run's entries below it (at or below
    // it for an entry of the right run, so equal values keep their order)
    const int t = threadIdx.x;
    for (int w = 32; w < n; w <<= 1) {
      int32_t v = 0;
      int at = -1;
      if (t < n) {
        v = a[t];
        const Key kv = key_of(v);
        const int own = t & ~(w - 1), base = t & ~(2 * w - 1);
        const bool right = (own & w) != 0;
        int lo = own ^ w, end = lo + w;
        if (end > n) end = n;
        if (lo > n) lo = n;
        const int p0 = lo;
        while (lo < end) {
          const int mid = (lo + end) >> 1;
          const Key km = key_of(a[mid]);
          if (right ? !lt(kv, km) : lt(km, kv)) {
            lo = mid + 1;
          } else {
            end = mid;
          }
        }
        at = base + (t - own) + (lo - p0);
      }
      __syncthreads();
      if (at >= 0) a[at] = v;
      __syncthreads();
    }
    return;
  }
  for (int k = 64; k <= len; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int t = threadIdx.x; t < len / 2; t += nt) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1)), hi = lo + j;
        const int32_t x = a[lo], y = a[hi];
        const bool swap = (lo & k) == 0 ? lt(key_of(y), key_of(x))
                                        : lt(key_of(x), key_of(y));
        if (swap) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
    for (int r = wp; r < len / 32; r += warps) {
      const int i = 32 * r + ln;
      Key v = warp_steps(key_of(a[i]), i & (2 * k - 1), k, 16);
      a[i] = v.x;
    }
    __syncthreads();
  }
}

// The ranked entry p of a keyed row merge (B, E, H): the first C go to the
// queue row of `lane`; past C a real event is counted (the return value)
// and, when logging, recorded as DROP_QUEUE at recs[rec_base + p - C]; with
// flowtrace the flow slot fl_base + p - C gets its flag and, for the
// PACKETs of sampled flows, an FT_DROP (CAUSE_QUEUE) record at their pair
// times.  REC off (H): no record.
template <int W, bool REC>
__device__ __forceinline__ bool merge_out(const LaneBufs& b,
                                          const int32_t (&ex)[W], int64_t p,
                                          int64_t lane, int64_t rec_base,
                                          int64_t fl_base) {
  const int64_t c = b.c;
  if (p < c) {
    int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                           b.q_phi, b.q_plo};
#pragma unroll
    for (int w = 0; w < W; ++w) q[w][lane * c + p] = ex[w];
    return false;
  }
  const bool valid = ex[0] != NEVER32;
  if (REC && b.log_cap > 0) {
    const int64_t r = rec_base + (p - c);
    int64_t* row = b.recs + r * 6;
    if (valid) {
      row[0] = join_t(ex[0], ex[1]);
      row[1] = (ex[2] >> AUX_SRC_SHIFT) & SRC_MASK;
      row[2] = lane;
      row[3] = ex[3];
      row[4] = ex[4];
      row[5] = DROP_QUEUE;
    } else {
      for (int w = 0; w < 6; ++w) row[w] = 0;
    }
    b.rec_valid[r] = valid ? 1 : 0;
  }
  if (REC && b.flowtrace) {
    const int32_t src = (ex[2] >> AUX_SRC_SHIFT) & SRC_MASK;
    const int32_t dst = static_cast<int32_t>(lane);
    put_flow(b, fl_base + (p - c),
             valid && (ex[2] >> AUX_KIND_SHIFT) == PACKET &&
                 flow_sampled(b, src, dst),
             join_raw(ex[0], ex[1]), FT_DROP, src, dst, ex[3], ex[4],
             CAUSE_QUEUE);
  }
  return valid;
}

// The keyed row merge of the block form, shared by kernels B (wide rows),
// E and H: sort the w_all entries at e — shared memory, or the row's
// m_scratch — through the index array perm (sort_width(w_all) words beside
// the row), then hand each ranked entry to merge_out; the real events past
// C add to *n_tail.  The row must be complete (a __syncthreads) before.
template <int W, bool REC = true>
__device__ __forceinline__ void merge_row(const LaneBufs& b, const int32_t* e,
                                          int32_t* perm, int64_t w_all,
                                          int64_t lane, int64_t rec_base,
                                          int64_t fl_base, int32_t* n_tail) {
  const int n = static_cast<int>(w_all), len = static_cast<int>(sort_width(n));
  for (int x = threadIdx.x; x < len; x += blockDim.x) perm[x] = x;
  __syncthreads();
  block_sort(perm, len, n, [&](int32_t v) {
    if (v >= n) return pad_key(v);
    const int32_t* ev = e + W * v;
    return make_key(ev[0], ev[1], ev[2], ev[3], v);
  });
  int32_t local_tail = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int32_t* ev = e + W * perm[p];
    int32_t ex[W];
#pragma unroll
    for (int w = 0; w < W; ++w) ex[w] = ev[w];
    if (merge_out<W, REC>(b, ex, p, lane, rec_base, fl_base)) ++local_tail;
  }
  if (local_tail) atomicAdd(n_tail, local_tail);
}

// one exchanged entry m of W words into ex: an outbound packet (no payload)
// or a stream block entry
template <int W>
__device__ __forceinline__ void load_exchanged(const LaneBufs& b, int64_t m,
                                               int32_t (&ex)[W]) {
  const int64_t nk = b.n * b.k;
  if (m < nk) {
#pragma unroll
    for (int w = 0; w < 5; ++w) ex[w] = b.out_blk[(w + 1) * nk + m];
#pragma unroll
    for (int w = 5; w < W; ++w) ex[w] = 0;
  } else {
    const int64_t n_ent = stream_entries(b);
#pragma unroll
    for (int w = 0; w < W; ++w) ex[w] = b.sx_blk[(w + 1) * n_ent + (m - nk)];
  }
}

template <int W>
__device__ __forceinline__ void set_empty(int32_t (&ex)[W]) {
  ex[0] = NEVER32;
  ex[1] = NEVER32;
#pragma unroll
  for (int w = 2; w < W; ++w) ex[w] = 0;
}

// the divert of cross slot r (tiered runs): its five words to the endpoint
// row's cross channel of the tier block (the payload words zero), and the
// NEVER time in the lane's own merge
template <int W>
__device__ __forceinline__ void divert(const LaneBufs& b, int64_t tier_row,
                                       int64_t r, int32_t (&ex)[W]) {
  int32_t* t = b.tier_blk + tier_layout(b).cx + tier_row * b.cx + r;
#pragma unroll
  for (int w = 0; w < 5; ++w) t[w * b.tier_n] = ex[w];
  t[5 * b.tier_n] = 0;
  t[6 * b.tier_n] = 0;
  ex[0] = NEVER32;
  ex[1] = NEVER32;
}

// the endpoint row lane i's cross entries divert to (tiered runs), or -1
__device__ __forceinline__ int64_t divert_row(const LaneBufs& b, int64_t i) {
  return b.tier_s > 0 && b.lane_stream[i] ? b.lane_ep_rows[b.lane_ep_start[i]]
                                          : -1;
}

// B's selection, block form: the first min(cnt, Cx) indices of the lane's
// group (seg[0, cnt), in the atomic placement's order) in index order, into
// sel[0, Cx).  A group that fits the buffer (cap indices) sorts alone, in
// one pass; a wider one sorts [the Cx smallest so far | the next cap - Cx
// of the group] until it is consumed.
__device__ void select_group(int32_t* sel, const int32_t* seg, int32_t cnt,
                             int64_t cx, int64_t cap) {
  if (cnt == 0 || cx == 0) return;
  const auto index_key = [](int32_t m) {
    return Key{0, 0, 0, static_cast<uint32_t>(m), static_cast<uint32_t>(m)};
  };
  if (cnt <= cap) {
    const int len = static_cast<int>(sort_width(cnt));
    for (int t = threadIdx.x; t < len; t += blockDim.x)
      sel[t] = t < cnt ? seg[t] : PAD_INDEX;
    __syncthreads();
    block_sort(sel, len, cnt, index_key);
    return;
  }
  const int w = static_cast<int>(cap), keep = static_cast<int>(cx);
  for (int r0 = 0; r0 < cnt; r0 += w - keep) {
    for (int t = threadIdx.x; t < w; t += blockDim.x) {
      if (t >= keep) {
        const int r = r0 + t - keep;
        sel[t] = r < cnt ? seg[r] : PAD_INDEX;
      } else if (r0 == 0) {
        sel[t] = PAD_INDEX;
      }
    }
    __syncthreads();
    block_sort(sel, w, w, index_key);
  }
}

// Kernel B's merge, the wide form (rows of more than 32 entries): one block
// per lane.  The row: C + S + Cx entries x W words, then the sort's index
// array (sort_width of the row's entries; the group selection uses it
// first), in dynamic shared memory or (merge_global) the block's part of
// m_scratch.  The block reads the lane's exchange count and zeroes it and
// the fill cursor for the next call.
template <int W, class P>
__global__ void merge_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  extern __shared__ int32_t sm[];
  const int64_t i = blockIdx.x;
  const int64_t n = b.n, c = b.c, cx = b.cx, sw = b.sw;
  const int64_t w_all = c + sw + cx, tail = sw + cx, nsw = n * sw;
  const int64_t len = sort_width(w_all);
  int32_t* const row = b.merge_global ? b.m_scratch + i * (W * w_all + len) : sm;
  int32_t* e = row;                  // [C + S + Cx][W]
  int32_t* perm = row + W * w_all;   // [len]: the selection, then the sort
  __shared__ int32_t n_tail;

  const int32_t cnt = b.x_cnt[i];
  const int32_t take = cnt < cx ? cnt : static_cast<int32_t>(cx);
  const int32_t* seg = b.x_order + b.x_start[i];
  const int64_t tier_row = divert_row(b, i);
  if (threadIdx.x == 0) n_tail = 0;
  load_queue_row<W>(b, e, i);
  __syncthreads();  // every thread has read the count
  if (threadIdx.x == 0) {
    b.x_cnt[i] = 0;
    b.x_fill[i] = 0;
  }
  select_group(perm, seg, cnt, cx, len);

  for (int64_t x = c + threadIdx.x; x < w_all; x += blockDim.x) {
    int32_t ex[W];
    if (x < c + sw) {
      const int64_t si = i * sw + (x - c);
#pragma unroll
      for (int w = 0; w < W; ++w) ex[w] = b.self_blk[w * nsw + si];
    } else {
      const int64_t r = x - c - sw;
      if (r < take) {
        load_exchanged(b, perm[r], ex);
      } else {
        set_empty(ex);
      }
      if (tier_row >= 0) divert(b, tier_row, r, ex);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) e[W * x + w] = ex[w];
  }
  __syncthreads();
  merge_row<W>(b, e, perm, w_all, i, i * tail, i * tail, &n_tail);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t lost_pre = cnt > cx ? cnt - static_cast<int32_t>(cx) : 0;
    b.n_queue[i] += n_tail + lost_pre;
    if (b.netobs) b.nb_shed[i] += lost_pre;  // the cross sheds, apart
    if (i == 0) *b.iters += 1;
  }
}

// Kernel B's merge, the narrow form (rows of at most 32 entries, the
// lanes.merge_in_warp rule): one warp per lane, MERGE_WARPS lanes a block.
// Warp lane x holds entry x of the row [queue C | self S | cross Cx] in
// registers; the group's indices sort in registers (a group wider than 32
// in passes, Cx kept), the row by (key, index), and rank p's words come
// from their lane by shuffles.
// No shared memory and no barrier.
constexpr int MERGE_WARPS = 8;

template <int W, class P>
__global__ void merge_warp_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int ln = threadIdx.x & 31;
  const int64_t i =
      blockIdx.x * static_cast<int64_t>(MERGE_WARPS) + (threadIdx.x >> 5);
  if (i >= b.n) return;  // the whole warp
  const int64_t n = b.n, c = b.c, cx = b.cx, sw = b.sw;
  const int64_t cs = c + sw, w_all = cs + cx, tail = sw + cx;
  const int32_t cnt = b.x_cnt[i], start = b.x_start[i];
  const int64_t tier_row = divert_row(b, i);

  int32_t ex[W];  // this lane's entry; the cross slots start empty
  if (ln < c) {
    int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                           b.q_phi, b.q_plo};
#pragma unroll
    for (int w = 0; w < W; ++w) ex[w] = q[w][i * c + ln];
  } else if (ln < cs) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      ex[w] = b.self_blk[w * n * sw + i * sw + (ln - c)];
  } else {
    set_empty(ex);
  }
  __syncwarp();  // every lane has read the count
  if (ln == 0) {
    b.x_cnt[i] = 0;
    b.x_fill[i] = 0;
  }

  // the group in index order: up to 32 sort at once (a network of the
  // group's width); a wider group in passes, lanes [0, Cx) keeping the Cx
  // smallest so far and the others taking the next 32 - Cx
  int32_t sel = PAD_INDEX;
  if (cnt <= 32) {
    sel = ln < cnt ? b.x_order[start + ln] : PAD_INDEX;
    if (cnt > 1) sel = warp_sort(sel, ln, static_cast<int>(sort_width(cnt)));
  } else {
    for (int32_t r0 = 0; cx > 0 && r0 < cnt;
         r0 += static_cast<int32_t>(32 - cx)) {
      const int32_t r = r0 + ln - static_cast<int32_t>(cx);
      const int32_t v =
          ln < cx ? sel : (r < cnt ? b.x_order[start + r] : PAD_INDEX);
      sel = warp_sort(v, ln);
    }
  }
  const int64_t r = ln - cs;  // this lane's cross slot
  const int32_t m = __shfl_sync(FULL_MASK, sel, r >= 0 ? static_cast<int>(r) : 0);
  if (r >= 0 && r < cx) {
    if (r < cnt) load_exchanged(b, m, ex);
    if (tier_row >= 0) divert(b, tier_row, r, ex);
  }

  // rank p = this lane: its key, then the other words from the entry's lane
  Key kv = ln < w_all ? make_key(ex[0], ex[1], ex[2], ex[3], ln) : pad_key(ln);
  kv = warp_sort(kv, ln);
  int32_t out[W];
  out[0] = word_of(kv.th);
  out[1] = word_of(kv.tl);
  out[2] = word_of(kv.ah);
  out[3] = word_of(kv.al);
#pragma unroll
  for (int w = 4; w < W; ++w)
    out[w] = __shfl_sync(FULL_MASK, ex[w], static_cast<int>(kv.x));
  const bool shed = ln < w_all && merge_out<W, true>(b, out, ln, i, i * tail,
                                                      i * tail);
  const int32_t n_tail = __popc(__ballot_sync(FULL_MASK, shed));
  if (ln == 0) {
    const int32_t lost_pre = cnt > cx ? cnt - static_cast<int32_t>(cx) : 0;
    b.n_queue[i] += n_tail + lost_pre;
    if (b.netobs) b.nb_shed[i] += lost_pre;
    if (i == 0) *b.iters += 1;
  }
}

// ---- kernel F: stream_tier -------------------------------------------------
// The tier's pop and slot walk (the reference's _stream_tier_iter up to its
// merge), in two launches.  The fill writes the canonical empty entry to
// every slot the walk may write — the candidate block's DELIVERY
// fallbacks, RTO arms, control sends and bursts (tier_layout up to the
// cross channel) and, when logging, the tier's record groups with their
// captures ([rec_tier, rec_ttail)) — with every thread of the card, each
// word stored once, coalesced.  Then the walk, where one warp (or, when the
// launch has more rows than TIER_WARP_ROWS, one thread) per endpoint row e
// owns the row's flow, its column of the tier vectors and its queue head,
// and walks its first K_s queue columns in order; a warp's lanes run in
// lockstep on the same values (warp lane j loads column j of the row's
// seven planes; shuffles broadcast each column): the pop-prefix rule (a
// prefix free of LOCALs under the wide rule, else a same-instant prefix of
// PACKETs, or column 0 alone, inside the window); a PACKET takes the down
// bucket and CoDel and, delivered inside the window (wide rule only),
// stimulates the law at once, else becomes a DELIVERY fallback; a start
// marker opens a client flow, an owned RTO local fires the timer, a
// segment (at a server row only from its own client) runs on_segment;
// every stimulus ends with the pump burst.  The walk stops where the
// popped prefix ends: no later column acts, and a column that does not act
// leaves every state word as it was (the bucket charge and the CoDel offer
// change nothing inactive) and writes only empties, which the fill wrote.
// The control send and, on client rows, the burst charge the up bucket (the
// burst after its first unit by the chained law), each with its loss draw
// at its send sequence number: a warp draws the 32 counters from the
// control send's on at once, one a lane, before the law runs, and lane u
// stores burst unit u's entry and records; lane 0 the rest.  Only valid
// entries and records are written.  RTO arms take the row's local
// sequence.  The peer's row is never touched (G reads the control sends
// across the pair).  With netobs the row's TV_NB_* counters follow every
// charge, and the popped PACKETs join the window's count.
static_assert(1 + PUMP_BURST <= 32, "a stimulus's sends fit one warp's draws");
constexpr int TIER_WARPS = 2;  // rows (a warp each) per block of the walk
// the most rows a launch walks a warp each: two warps an SM of an H100;
// past it the walks are many enough to fill the card a thread each, and a
// warp each would spend its issue slots 32 times over
constexpr int64_t TIER_WARP_ROWS = 264;

// the fill: the candidate block's seven planes up to the cross channel,
// then the record groups' int64 words and their flags, each a grid-stride
// pass of coalesced stores
template <class P>
__global__ void tier_fill_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int64_t cx0 = tier_layout(b).cx;
  const int64_t n_rec = b.log_cap > 0 ? b.rec_ttail - b.rec_tier : 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  for (int64_t x = t0; x < cx0; x += step) {
#pragma unroll
    for (int w = 0; w < 7; ++w) b.tier_blk[w * b.tier_n + x] = w < 2 ? NEVER32 : 0;
  }
  int64_t* const recs = b.recs + 6 * b.rec_tier;
  for (int64_t x = t0; x < 6 * n_rec; x += step) recs[x] = 0;
  for (int64_t x = t0; x < n_rec; x += step) b.rec_valid[b.rec_tier + x] = 0;
}

// the tier vector rows (lanes_stream.py TV_*)
constexpr int TV_DN_TOK = 0, TV_DN_NRH = 1, TV_DN_NRL = 2, TV_DN_LDH = 3,
              TV_DN_LDL = 4, TV_CD_FATH = 5, TV_CD_FATL = 6, TV_CD_DNH = 7,
              TV_CD_DNL = 8, TV_CD_CNT = 9, TV_CD_DROP = 10, TV_UP_TOK = 11,
              TV_UP_NRH = 12, TV_UP_NRL = 13, TV_UP_LDH = 14, TV_UP_LDL = 15,
              TV_SEND_SEQ = 16, TV_LOCAL_SEQ = 17, TV_N_SENDS = 18,
              TV_N_LOSS = 19, TV_N_DEL = 20, TV_N_CODEL = 21, TV_N_QUEUE = 22,
              TV_NB_TXB = 23, TV_NB_RXB = 24, TV_NB_THR = 25;

// one candidate entry of the tier block at idx: valid, or canonical empty
__device__ __forceinline__ void tier_put(const LaneBufs& b, int64_t idx,
                                         bool valid, int64_t t, int32_t auxh,
                                         int32_t auxl, int32_t size,
                                         int32_t phi, int32_t plo) {
  put_words(b.tier_blk + idx, b.tier_n, valid, t, auxh, auxl, size, phi, plo);
}

// row e's walk by its warp (WARP) or its thread; returns its popped PACKETs
// (a warp's in lane 0, 0 in the others)
template <bool WARP>
__device__ int32_t stream_tier_row(const LaneBufs& b, int64_t e) {
  const int ln = WARP ? threadIdx.x & 31 : 0;
  const bool lead = ln == 0;
  const int64_t sf = b.tier_s, s2 = 2 * sf;
  const int64_t ks = b.ks, c2 = b.c2;
  const int32_t interval = static_cast<int32_t>(b.interval);
  const int64_t we = join_raw(*b.now_we_hi, *b.now_we_lo);
  const bool client = e < sf;
  const bool wide = b.tier_wide != 0;
  const int32_t lane = b.flow_lanes[e], peer = b.flow_peers[e];
  const int32_t clid = b.flow_clid[e];
  // the row's bucket tables, read once (as up_row does for the up bucket)
  const int32_t dn_rate = b.flow_dn_rate[e], dn_burst = b.flow_dn_burst[e],
                dn_kfull = b.flow_dn_kfull[e], dn_kfi = b.flow_dn_kfi[e];
  const UpRow ur = up_row(b, e);
  const int32_t pkt_auxh = (PACKET << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  const int32_t loc_auxh = (LOCAL << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  const TierLayout lay = tier_layout(b);
  const int64_t trec = b.rec_tier, tsrec = trec + ks * s2,
                tbrec = tsrec + ks * s2;
  const bool capture = b.tier_pcap && b.flow_pcap[e] != 0;

  // the row's queue planes, and its column of the tier vectors
  int32_t* q[7];
#pragma unroll
  for (int w = 0; w < 7; ++w) q[w] = b.tier_q + w * s2 * c2 + e * c2;
  int32_t* const tv = b.tier_v + e;
  Bucket dn{tv[TV_DN_TOK * s2],
            join_raw(tv[TV_DN_NRH * s2], tv[TV_DN_NRL * s2]),
            join_raw(tv[TV_DN_LDH * s2], tv[TV_DN_LDL * s2])};
  Bucket up{tv[TV_UP_TOK * s2],
            join_raw(tv[TV_UP_NRH * s2], tv[TV_UP_NRL * s2]),
            join_raw(tv[TV_UP_LDH * s2], tv[TV_UP_LDL * s2])};
  int32_t fat_hi = tv[TV_CD_FATH * s2], fat_lo = tv[TV_CD_FATL * s2];
  int64_t cd_dn = join_raw(tv[TV_CD_DNH * s2], tv[TV_CD_DNL * s2]);
  int32_t dcount = tv[TV_CD_CNT * s2];
  uint8_t dropping = tv[TV_CD_DROP * s2] != 0 ? 1 : 0;
  int32_t send_seq = tv[TV_SEND_SEQ * s2], local_seq = tv[TV_LOCAL_SEQ * s2];
  int32_t n_sends = tv[TV_N_SENDS * s2], n_loss = tv[TV_N_LOSS * s2];
  int32_t n_del = tv[TV_N_DEL * s2], n_codel = tv[TV_N_CODEL * s2];
  int32_t nb_txb = 0, nb_rxb = 0, nb_thr = 0;
  if (b.netobs) {
    nb_txb = tv[TV_NB_TXB * s2];
    nb_rxb = tv[TV_NB_RXB * s2];
    nb_thr = tv[TV_NB_THR * s2];
  }
  int32_t min_lat = NEVER32, pkts = 0;
  const StreamLane sl{up,     send_seq, local_seq, n_sends,
                      n_loss, min_lat,  nb_txb,    nb_thr};

  Flow f;
  int32_t* frow = b.stream + e * N_COLS;
  flow_load(f, frow);
  f.role = client ? SENDER : RECEIVER;
  f.segs = b.flow_segs[e];
  f.mss = b.flow_mss[e];
  f.last_bytes = b.flow_last[e];
  f.cc = b.flow_cc[e];

  int32_t col[7] = {};  // a warp's lane jl: column j0 + jl of each plane
  int32_t head_hi = 0, head_lo = 0;
  bool prefix = true;
  for (int64_t j = 0; j < ks; ++j) {
    int32_t cw[7];  // column j's words
    if constexpr (WARP) {
      const int jl = static_cast<int>(j & 31);
      if (jl == 0) {  // the next 32 columns, one a lane
#pragma unroll
        for (int w = 0; w < 7; ++w) col[w] = j + ln < ks ? q[w][j + ln] : 0;
      }
#pragma unroll
      for (int w = 0; w < 7; ++w) cw[w] = __shfl_sync(FULL_MASK, col[w], jl);
    } else {
#pragma unroll
      for (int w = 0; w < 7; ++w) cw[w] = q[w][j];
    }
    const int32_t thi = cw[0], tlo = cw[1], auxh = cw[2], auxl = cw[3],
                  size = cw[4], phi = cw[5], plo = cw[6];
    if (j == 0) {
      head_hi = thi;
      head_lo = tlo;
    }
    const int32_t kind = auxh >> AUX_KIND_SHIFT;
    const int32_t src = (auxh >> AUX_SRC_SHIFT) & SRC_MASK;
    prefix = prefix && (wide ? kind != LOCAL
                             : (thi == head_hi && tlo == head_lo &&
                                kind == PACKET));
    if (!prefix && j > 0) break;  // no later column acts
    const int64_t t = join_t(thi, tlo);
    if (t >= we) continue;  // does not act: empties only
    if (lead) {
      q[0][j] = NEVER32;
      q[1][j] = NEVER32;
    }

    // PACKET: the down bucket and CoDel on the compact rows
    const bool is_pkt = kind == PACKET;
    const int64_t td = bucket_charge(dn, dn_rate, dn_burst, dn_kfull, dn_kfi,
                                     t, (size + FRAME_OVERHEAD_BYTES) * 8,
                                     is_pkt, interval, nb_thr);
    if (is_pkt) pkts += 1;
    int64_t sojourn = 0;
    if (is_pkt) {
      sojourn = td - t;
      if (sojourn > NEVER32) sojourn = NEVER32;
    }
    const bool drop = codel_offer(fat_hi, fat_lo, cd_dn, dcount, dropping, td,
                                  sojourn, is_pkt, b.codel_div);
    const bool deliver = is_pkt && !drop;
    if (deliver) {
      n_del += 1;
      nb_rxb = wadd(nb_rxb, size);
    }
    if (is_pkt && drop) n_codel += 1;
    if (lead && is_pkt)
      put_rec(b, trec + j * s2 + e, true, td, src, lane, auxl, size,
              drop ? DROP_CODEL : DELIVERED);

    // delivery elision: inside the window (wide rule only) the law runs at
    // once, at the delivery time; else a DELIVERY fallback is inserted
    const bool del_now = wide && deliver && td < we;
    if (lead && deliver && !del_now)
      tier_put(b, j * s2 + e, true, td,
               (DELIVERY << AUX_KIND_SHIFT) | (src << AUX_SRC_SHIFT), auxl,
               size, phi, plo);
    const int64_t st = del_now ? td : t;

    int stim = 0;  // 1 open, 2 RTO, 3 segment
    if (kind == LOCAL && size == -1 && client) {
      stim = 1;
    } else if (kind == LOCAL && size == SZ_RTO && plo == clid) {
      stim = 2;
    } else if ((del_now || kind == DELIVERY) && (phi | plo) != 0 &&
               (client || src == clid)) {
      stim = 3;
    }
    if (!stim) continue;
    // burst unit u: stored where the sink sees it (a thread), or kept by
    // lane u until the law is done (a warp)
    bool u_valid = false, u_lost = false;
    int64_t u_dep = 0, u_arr = 0;
    int32_t u_seq = 0, u_size = 0, u_phi = 0, u_plo = 0;
    const auto put_unit = [&](int32_t u) {
      const int64_t slot = j * PUMP_BURST + u;
      if (u_valid)
        tier_put(b, lay.bo + slot * sf + e, true, u_arr, pkt_auxh, u_seq,
                 u_size, u_phi, u_plo);
      if (u_lost)
        put_rec(b, tbrec + slot * sf + e, true, st, lane, peer, u_seq, u_size,
                DROP_LOSS);
      if (capture)
        put_rec(b, b.rec_tbpc + slot * sf + e, true, u_dep, lane, peer, u_seq,
                u_size, PCAP_TX);
    };
    const auto sink = [&](int32_t u, bool valid, bool lost_u, int64_t dep,
                          int64_t arr, int32_t bseq, int32_t bsize,
                          int32_t bphi, int32_t bplo, bool /*retx*/) {
      if (WARP && u != ln) return;
      u_valid = valid;
      u_lost = lost_u;
      u_dep = dep;
      u_arr = arr;
      u_seq = bseq;
      u_size = bsize;
      u_phi = bphi;
      u_plo = bplo;
      if (!WARP) put_unit(u);
    };
    Pair now;
    split(st, &now.hi, &now.lo);
    Sends sd;
    if constexpr (WARP) {
      // the draws of the stimulus's sends, counters send_seq + lane
      uint32_t lost = 0;
      if (b.has_loss && st >= b.bootstrap_end) {
        const uint32_t d = lane_draw(
            static_cast<uint32_t>(b.seed_lo),
            static_cast<uint32_t>(b.seed_hi),
            static_cast<uint32_t>(lane) | LOSS_STREAM,
            static_cast<uint32_t>(wadd(send_seq, ln)));
        lost = __ballot_sync(FULL_MASK, static_cast<int64_t>(d) < ur.thresh);
      }
      sd = stream_stimulus(b, f, stim, now, st, phi, plo, size, we, ur, sl,
                           sink, WarpDraw{lost});
      if (ln < sd.cnt) put_unit(ln);  // client rows: the burst, a unit a lane
    } else {
      sd = stream_stimulus(b, f, stim, now, st, phi, plo, size, we, ur, sl,
                           sink, SerialDraw{b, ur, send_seq});
    }
    const Emit& em = sd.em;
    if (lead) {
      if (em.send_valid && !sd.lost)
        tier_put(b, lay.se + j * s2 + e, true, sd.arr, pkt_auxh, sd.seq,
                 em.send_size,
                 wshl(em.send_flags, PAY_SEQ_BITS) | em.send_seq,
                 em.send_ack);
      if (sd.lost)
        put_rec(b, tsrec + j * s2 + e, true, st, lane, peer, sd.seq,
                em.send_size, DROP_LOSS);
      if (em.send_valid && capture)
        put_rec(b, b.rec_tspc + j * s2 + e, true, sd.dep, lane, peer, sd.seq,
                em.send_size, PCAP_TX);
      // the RTO arm: a LOCAL self-insert at the own row
      if (em.rto_valid)
        tier_put(b, lay.sa + j * s2 + e, true,
                 join_raw(em.rto_t.hi, em.rto_t.lo), loc_auxh, sd.lseq,
                 SZ_RTO, 0, clid);
    }
  }

  if (lead) {
    flow_store(f, frow);
    tv[TV_DN_TOK * s2] = dn.tokens;
    split(dn.nr, &tv[TV_DN_NRH * s2], &tv[TV_DN_NRL * s2]);
    split(dn.ld, &tv[TV_DN_LDH * s2], &tv[TV_DN_LDL * s2]);
    tv[TV_UP_TOK * s2] = up.tokens;
    split(up.nr, &tv[TV_UP_NRH * s2], &tv[TV_UP_NRL * s2]);
    split(up.ld, &tv[TV_UP_LDH * s2], &tv[TV_UP_LDL * s2]);
    tv[TV_CD_FATH * s2] = fat_hi;
    tv[TV_CD_FATL * s2] = fat_lo;
    split(cd_dn, &tv[TV_CD_DNH * s2], &tv[TV_CD_DNL * s2]);
    tv[TV_CD_CNT * s2] = dcount;
    tv[TV_CD_DROP * s2] = dropping;
    tv[TV_SEND_SEQ * s2] = send_seq;
    tv[TV_LOCAL_SEQ * s2] = local_seq;
    tv[TV_N_SENDS * s2] = n_sends;
    tv[TV_N_LOSS * s2] = n_loss;
    tv[TV_N_DEL * s2] = n_del;
    tv[TV_N_CODEL * s2] = n_codel;
    if (b.netobs) {
      tv[TV_NB_TXB * s2] = nb_txb;
      tv[TV_NB_RXB * s2] = nb_rxb;
      tv[TV_NB_THR * s2] = nb_thr;
    }
    if (min_lat < NEVER32) atomicMin(b.min_used_lat, min_lat);
  }
  return lead ? pkts : 0;
}

template <bool WARP, class P>
__global__ void stream_tier_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int64_t e =
      WARP ? blockIdx.x * static_cast<int64_t>(TIER_WARPS) + (threadIdx.x >> 5)
           : blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int32_t pkts = e < 2 * b.tier_s ? stream_tier_row<WARP>(b, e) : 0;
  if (b.netobs) block_add(pkts, b.nb_win);
}

// ---- kernel G: tier_merge --------------------------------------------------
// The tier merge (the reference's _stream_tier_iter merge): endpoint row r
// merges its queue [C2] with its W_t = 3K_s + K_s*B + Cx candidates — its
// DELIVERY fallbacks [K_s], its RTO arms [K_s], its peer's control sends
// [K_s], on server rows its client's bursts [K_s*B] (slot-major; a client
// row's are empty), its diverted cross entries [Cx].  A warp a row, a block
// a warp (several rows a block, their candidate planes' time words staged a
// tile of rows at a time, measured slower on the H100: PERF.md).  With a
// log the warp first zeroes its row's tail records, 16 bytes a store.  It
// finds the valid entries (time word != NEVER32) 32 at a time with
// __ballot_sync (every chunk's time word loaded before any ballot), then
// gathers only those, in index order, into its working memory: shared
// memory, or (tier_global) its part of m_scratch.  Most candidates are
// empty, and the queue's valid entries are one run in key order already (F
// only pops a prefix of a row G sorted; the warp checks it): the row is the
// queue's run and the candidates in runs of 32, each sorted by (key, index)
// in registers (B's warp_sort), and an entry's rank is its place in its own
// run plus, for every other run, the count of that run's entries below it
// (a binary search).  No barrier and no all-pairs rank.  The first C2 go to
// the row, canonical empties after them; the rest are counted into
// TV_N_QUEUE and recorded as DROP_QUEUE in the tier's tail group [2S, W_t]
// at their rank past C2.
constexpr int TIER_UNROLL = 16;  // chunks of 32 a lane loads before ballots

// entry x of row r's [queue C2 | W_t candidates]: its first word and the
// stride between its words, or nullptr for a client row's (empty) burst
// entries
__device__ __forceinline__ const int32_t* tier_entry(const LaneBufs& b,
                                                     int64_t r, int64_t x,
                                                     int64_t& stride) {
  const int64_t sf = b.tier_s, s2 = 2 * sf, ks = b.ks, c2 = b.c2;
  if (x < c2) {
    stride = s2 * c2;
    return b.tier_q + r * c2 + x;
  }
  stride = b.tier_n;
  const TierLayout lay = tier_layout(b);
  x -= c2;
  if (x < ks) return b.tier_blk + x * s2 + r;
  if (x < 2 * ks) return b.tier_blk + lay.sa + (x - ks) * s2 + r;
  if (x < 3 * ks)  // the control sends, across the pair
    return b.tier_blk + lay.se + (x - 2 * ks) * s2 + (r < sf ? r + sf : r - sf);
  x -= 3 * ks;
  if (x < ks * PUMP_BURST)
    return r < sf ? nullptr : b.tier_blk + lay.bo + x * sf + (r - sf);
  return b.tier_blk + lay.cx + r * b.cx + (x - ks * PUMP_BURST);
}

// the position of the k-th (from 0) set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// the key of the compacted entry at position p: its four key words and p
// (positions are in index order, so p breaks ties as the index does)
__device__ __forceinline__ Key tier_key(const int32_t* ent, int32_t p) {
  const int32_t* e = ent + 7 * p;
  return make_key(e[0], e[1], e[2], e[3], p);
}

// the count of run [lo, hi) of ord (sorted by key) whose keys are below kv
__device__ __forceinline__ int32_t count_below(const int32_t* ent,
                                               const int32_t* ord, int32_t lo,
                                               int32_t hi, const Key& kv) {
  const int32_t p0 = lo;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (lt(tier_key(ent, ord[mid]), kv)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - p0;
}

// a row's working memory, int32 words (lanes.tier_row_words): the valid
// entries [total][7], their order [total], the chunks' valid masks and the
// valid entries before each chunk
__host__ __device__ __forceinline__ int64_t tier_row_words(int64_t total) {
  return 8 * total + 2 * ((total + 31) / 32);
}



// records [first, first + count) and their flags zeroed by a warp, 16
// bytes a store (a record is three; recs is 16-byte aligned)
__device__ __forceinline__ void zero_recs(const LaneBufs& b, int64_t first,
                                          int64_t count) {
  const int ln = threadIdx.x & 31;
  int4* const w = reinterpret_cast<int4*>(b.recs + first * 6);
  for (int64_t x = ln; x < 3 * count; x += 32) w[x] = make_int4(0, 0, 0, 0);
  for (int64_t x = ln; x < count; x += 32) b.rec_valid[first + x] = 0;
}

template <class P>
__global__ void tier_merge_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  extern __shared__ int32_t smem[];
  const int ln = threadIdx.x & 31;
  const int64_t r = blockIdx.x;
  const int64_t s2 = 2 * b.tier_s, c2 = b.c2;
  const int64_t wt = 3 * b.ks + b.ks * PUMP_BURST + b.cx, total = c2 + wt;
  const int64_t chunks = (total + 31) / 32, words = tier_row_words(total);
  int32_t* const mem = b.tier_global ? b.m_scratch + r * words : smem;
  // the row's tail group empty, before the valid records are written
  if (b.log_cap > 0) {
    zero_recs(b, b.rec_ttail + r * wt, wt);
    __syncwarp();
  }
  int32_t* const ent = mem;                   // [total][7]
  int32_t* const ord = mem + 7 * total;       // [total]
  int32_t* const vmask = ord + total;         // [chunks]
  int32_t* const cbase = vmask + chunks;      // [chunks]
  const unsigned below = (1u << ln) - 1u;

  // the valid flags, a chunk of 32 entries a ballot: every chunk's time
  // words of a pass loaded before its ballots
  for (int64_t m0 = 0; m0 < chunks; m0 += TIER_UNROLL) {
    int32_t hi[TIER_UNROLL];
#pragma unroll
    for (int u = 0; u < TIER_UNROLL; ++u) {
      const int64_t x = (m0 + u) * 32 + ln;
      hi[u] = NEVER32;
      if (x < total) {
        int64_t stride;
        const int32_t* p = tier_entry(b, r, x, stride);
        if (p) hi[u] = *p;
      }
    }
#pragma unroll
    for (int u = 0; u < TIER_UNROLL; ++u) {
      const unsigned m = __ballot_sync(FULL_MASK, hi[u] != NEVER32);
      if (ln == 0 && m0 + u < chunks) vmask[m0 + u] = static_cast<int32_t>(m);
    }
  }
  __syncwarp();
  // the valid entries before each chunk (an exclusive scan, 32 chunks a
  // pass), and those of the queue
  int32_t n_valid = 0, n_q = 0;
  for (int64_t m0 = 0; m0 < chunks; m0 += 32) {
    const int64_t m = m0 + ln;
    const unsigned bits = m < chunks ? static_cast<unsigned>(vmask[m]) : 0u;
    const int32_t cnt = __popc(bits);
    int32_t inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL_MASK, inc, d);
      if (ln >= d) inc += y;
    }
    if (m < chunks) cbase[m] = n_valid + inc - cnt;
    // the queue's entries: indices below C2
    const int64_t q_left = c2 - m * 32;
    const unsigned qbits =
        q_left >= 32 ? bits : (q_left > 0 ? bits & ((1u << q_left) - 1u) : 0u);
    n_q += __reduce_add_sync(FULL_MASK, static_cast<unsigned>(__popc(qbits)));
    n_valid += __shfl_sync(FULL_MASK, inc, 31);
  }
  __syncwarp();
  // gather the valid entries' words into ent, in index order: a lane an
  // entry, each lane's entries' words loaded before they are stored
  for (int32_t p0 = 0; p0 < n_valid; p0 += 32 * 4) {
    int32_t words7[4][7];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int32_t p = p0 + u * 32 + ln;
      if (p < n_valid) {
        int32_t lo = 0, hi = static_cast<int32_t>(chunks) - 1;
        while (lo < hi) {  // the last chunk whose base is <= p
          const int32_t mid = (lo + hi + 1) >> 1;
          if (cbase[mid] <= p) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        const int64_t x = static_cast<int64_t>(lo) * 32 +
                          nth_bit(static_cast<unsigned>(vmask[lo]),
                                  p - cbase[lo]);
        int64_t stride;
        const int32_t* e = tier_entry(b, r, x, stride);
#pragma unroll
        for (int w = 0; w < 7; ++w) words7[u][w] = e[w * stride];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int32_t p = p0 + u * 32 + ln;
      if (p < n_valid) {
#pragma unroll
        for (int w = 0; w < 7; ++w) ent[7 * p + w] = words7[u][w];
      }
    }
  }
  __syncwarp();

  // the runs: the queue's valid entries, one run if they are in key order
  // (else runs of 32 like the candidates'), then runs of 32
  bool q_sorted = true;
  for (int32_t a0 = 0; a0 + 1 < n_q; a0 += 32) {
    const int32_t a = a0 + ln;
    const bool bad = a + 1 < n_q && lt(tier_key(ent, a + 1), tier_key(ent, a));
    if (__any_sync(FULL_MASK, bad)) q_sorted = false;
  }
  const int32_t first = q_sorted ? n_q : 0;  // [0, first): one run as it is
  for (int32_t a = ln; a < first; a += 32) ord[a] = a;
  for (int32_t s0 = first; s0 < n_valid; s0 += 32) {
    const int32_t p = s0 + ln;
    if (s0 + 1 == n_valid) {  // a run of one
      if (ln == 0) ord[p] = p;
      continue;
    }
    Key kv = p < n_valid ? tier_key(ent, p) : pad_key(PAD_INDEX);
    kv = warp_sort(kv, ln);
    if (p < n_valid) ord[p] = static_cast<int32_t>(kv.x);
  }
  __syncwarp();

  // each entry's rank: its place in its run, plus the entries below it in
  // every other run; the row takes the first C2
  int32_t* q[7];
#pragma unroll
  for (int w = 0; w < 7; ++w) q[w] = b.tier_q + w * s2 * c2 + r * c2;
  const int64_t ttail = b.rec_ttail + r * wt;
  const int32_t lane = b.flow_lanes[r];
  for (int32_t p = ln; p < n_valid; p += 32) {
    const int32_t at = ord[p];
    const Key kv = tier_key(ent, at);
    const int32_t own = p < first ? 0 : first + (p - first) / 32 * 32;
    int32_t rank = p - own;
    if (own != 0 || first == 0) {
      if (first > 0) rank += count_below(ent, ord, 0, first, kv);
    }
    for (int32_t s0 = first; s0 < n_valid; s0 += 32) {
      if (s0 == own) continue;
      const int32_t s1 = s0 + 32 < n_valid ? s0 + 32 : n_valid;
      rank += count_below(ent, ord, s0, s1, kv);
    }
    const int32_t* e = ent + 7 * at;
    if (rank < c2) {
#pragma unroll
      for (int w = 0; w < 7; ++w) q[w][rank] = e[w];
    } else {
      put_rec(b, ttail + (rank - c2), true, join_raw(e[0], e[1]),
              (e[2] >> AUX_SRC_SHIFT) & SRC_MASK, lane, e[3], e[4],
              DROP_QUEUE);
    }
  }
  for (int64_t x = n_valid + ln; x < c2; x += 32) {  // canonical empties
    q[0][x] = NEVER32;
    q[1][x] = NEVER32;
#pragma unroll
    for (int w = 2; w < 7; ++w) q[w][x] = 0;
  }
  const int64_t over = n_valid > c2 ? n_valid - c2 : 0;
  if (ln == 0 && over)
    b.tier_v[TV_N_QUEUE * s2 + r] += static_cast<int32_t>(over);
}

// ---- kernels E and H: a warp a row ------------------------------------------
// E (the split stream exchange) and H (an injection block into the lane
// queues) each merge a lane's queue row [C] with a few candidates and keep
// the first C by (key, index).  Most of such a row is known before it is
// read: the queue row is one sorted run (B, E or H left it so), and most
// candidates are canonical empties (NEVER32, NEVER32, 0, 0), which form one
// run in index order by themselves.  So a warp takes a row with no
// block-wide sort: it gathers the queue row and the other candidates into
// its working memory (shared memory, or m_scratch past the opt-in limit),
// checks that the queue row is one run (else sorts it in runs of 32, as G
// does), sorts the rest in runs of 32 unless they already form one, and
// ranks each entry as its place in its own run plus the entries below it
// in every other run (binary searches; G's count_below).  The canonical
// empties are counted, not stored: every one is below an entry whose key
// words are above the canonical ones and above none other (the queue's,
// at lower indices, go first on equal keys; no other candidate has their
// key), so the j-th of them takes rank base + j, base being the entries at
// or below the canonical key.  A queue entry whose rank is its own index
// is not written again.  Every ballot and shuffle is the whole warp's, at
// warp-uniform points.
constexpr int ROW_UNROLL = 4;  // chunks of 32 a lane loads before its stores

// the canonical empty's key with the largest index: an entry's key is
// below it iff its four key words are at or below the canonical ones
__device__ __forceinline__ Key canon_probe() {
  return make_key(NEVER32, NEVER32, 0, 0, -1);
}

__device__ __forceinline__ bool canon_key(const int32_t* w) {
  return w[0] == NEVER32 && w[1] == NEVER32 && w[2] == 0 && w[3] == 0;
}

// The runs of a row's working memory ent ([n][7], an entry's index its
// position there): the queue [0, n0) and the rest [n0, n), each one run as
// it stands (one0, one1) or runs of 32 sorted through ord.
struct Runs {
  int32_t n0, n;
  bool one0, one1;
};

__device__ __forceinline__ int32_t run_start(const Runs& rs, int32_t p) {
  if (p < rs.n0) return rs.one0 ? 0 : p & ~31;
  return rs.one1 ? rs.n0 : rs.n0 + ((p - rs.n0) & ~31);
}

// the entries below kv in every run but the one starting at `own` (-1: all)
__device__ __forceinline__ int32_t below_runs(const int32_t* ent,
                                              const int32_t* ord,
                                              const Runs& rs, const Key& kv,
                                              int32_t own) {
  int32_t cnt = 0;
  for (int32_t s0 = 0; s0 < rs.n;) {
    const bool q = s0 < rs.n0;
    const int32_t end = q ? rs.n0 : rs.n;
    const int32_t s1 = (q ? rs.one0 : rs.one1) ? end : min(s0 + 32, end);
    if (s0 != own) cnt += count_below(ent, ord, s0, s1, kv);
    s0 = s1;
  }
  return cnt;
}

// are ent's entries [lo, hi) in key order?  (the whole warp)
__device__ __forceinline__ bool one_run(const int32_t* ent, int32_t lo,
                                        int32_t hi) {
  const int ln = threadIdx.x & 31;
  bool ok = true;
  for (int32_t a0 = lo; a0 + 1 < hi; a0 += 32) {
    const int32_t a = a0 + ln;
    const bool bad = a + 1 < hi && lt(tier_key(ent, a + 1), tier_key(ent, a));
    if (__any_sync(FULL_MASK, bad)) ok = false;
  }
  return ok;
}

// ord for the runs: the identity on a one-run part, each run of 32 of the
// other part sorted in registers (the whole warp)
__device__ __forceinline__ void order_runs(const int32_t* ent, int32_t* ord,
                                           const Runs& rs) {
  const int ln = threadIdx.x & 31;
  for (int part = 0; part < 2; ++part) {
    const int32_t lo = part ? rs.n0 : 0, hi = part ? rs.n : rs.n0;
    if (part ? rs.one1 : rs.one0) {
      for (int32_t a = lo + ln; a < hi; a += 32) ord[a] = a;
      continue;
    }
    for (int32_t s0 = lo; s0 < hi; s0 += 32) {
      const int32_t p = s0 + ln;
      Key kv = p < hi ? tier_key(ent, p) : pad_key(PAD_INDEX);
      kv = warp_sort(kv, ln);
      if (p < hi) ord[p] = static_cast<int32_t>(kv.x);
    }
  }
  __syncwarp();
}

// A ranked entry's words e: rank p < C to the queue row of `lane`; past C a
// valid one is counted (the return value) and, with REC, recorded as
// DROP_QUEUE at rec_base + p - C and, with flowtrace, a sampled flow's
// PACKET gets its FT_DROP (CAUSE_QUEUE) flow record at fl_base + p - C.  The
// tail's records and flow flags were zeroed before.
template <int W, bool REC>
__device__ __forceinline__ bool row_put(const LaneBufs& b, const int32_t* e,
                                        int32_t p, int64_t lane,
                                        int64_t rec_base, int64_t fl_base) {
  const int64_t c = b.c;
  if (p < c) {
    int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                           b.q_phi, b.q_plo};
#pragma unroll
    for (int w = 0; w < W; ++w) q[w][lane * c + p] = e[w];
    return false;
  }
  if (e[0] == NEVER32) return false;
  const int32_t src = (e[2] >> AUX_SRC_SHIFT) & SRC_MASK;
  const int32_t dst = static_cast<int32_t>(lane);
  if (REC && b.log_cap > 0)
    put_rec(b, rec_base + (p - c), true, join_raw(e[0], e[1]), src, dst,
            e[3], e[4], DROP_QUEUE);
  if (REC && b.flowtrace && (e[2] >> AUX_KIND_SHIFT) == PACKET &&
      flow_sampled(b, src, dst))
    put_flow(b, fl_base + (p - c), true, join_raw(e[0], e[1]), FT_DROP, src,
             dst, e[3], e[4], CAUSE_QUEUE);
  return true;
}

// Rank every stored entry of the runs (n_e canonical empties counted
// beside them) and write it out; returns this warp lane's count of valid
// entries past C.  Stores the canonical empties' base in *base.
template <int W, bool REC>
__device__ __forceinline__ int32_t place_runs(const LaneBufs& b,
                                              const int32_t* ent,
                                              const int32_t* ord,
                                              const Runs& rs, int32_t n_e,
                                              int64_t lane, int64_t rec_base,
                                              int64_t fl_base,
                                              int32_t* base) {
  const int ln = threadIdx.x & 31;
  const Key probe = canon_probe();
  *base = below_runs(ent, ord, rs, probe, -1);
  int32_t tail = 0;
  for (int32_t p = ln; p < rs.n; p += 32) {
    const int32_t at = ord[p];
    const Key kv = tier_key(ent, at);
    const int32_t own = run_start(rs, p);
    const int32_t rank = p - own + below_runs(ent, ord, rs, kv, own) +
                         (lt(probe, kv) ? n_e : 0);
    if (at < rs.n0 && rank == at) continue;  // a queue entry that stays
    if (row_put<W, REC>(b, ent + 7 * at, rank, lane, rec_base, fl_base))
      ++tail;
  }
  return tail;
}

// Load the queue row of `lane` ([C] entries of W words) into ent[0, C), a
// batch of ROW_UNROLL / 2 chunks a lane loaded before it is stored; words
// past W zero.  Returns whether it is one run.
template <int W>
__device__ __forceinline__ bool load_queue_run(const LaneBufs& b,
                                               int32_t* ent, int64_t lane) {
  const int ln = threadIdx.x & 31;
  const int64_t c = b.c;
  const int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                               b.q_phi, b.q_plo};
  constexpr int U = ROW_UNROLL / 2;
  for (int64_t x0 = 0; x0 < c; x0 += 32 * U) {
    int32_t w7[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t x = x0 + u * 32 + ln;
      if (x < c) {
#pragma unroll
        for (int w = 0; w < W; ++w) w7[u][w] = q[w][lane * c + x];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t x = x0 + u * 32 + ln;
      if (x < c) {
#pragma unroll
        for (int w = 0; w < 7; ++w) ent[7 * x + w] = w < W ? w7[u][w] : 0;
      }
    }
  }
  __syncwarp();
  return one_run(ent, 0, static_cast<int32_t>(c));
}

// ---- kernel E: stream_rows_merge ----------------------------------------------
// The split exchange of one-to-one stream configs (the reference's
// _merge_stream_rows): a warp per endpoint row r, SPLIT_ROWS rows a block,
// merges its lane's queue row [C] with the W_s = 2K + K*B candidates of the
// static layout — a client row its server's control sends [K], its own RTO
// arms [K] and K*B empties; a server row its client's control sends, its own
// RTO arms and its client's bursts [K*B], slot-major.  The candidates are
// loaded a lane each, 32 at a time: the canonical empties (their key words
// alone decide) are counted, a mask a chunk, and the rest compacted into ent
// after the queue row.  The row's tail group [rec_slots - 2S*W_s + r*W_s,
// W_s] is zeroed, records and flow flags, before its valid entries are
// written.  A canonical empty that ranks below C is written from its own
// words (the key's, then its size and payload words at their source).
// Working memory a row (split_row_words): ent [C + W_s][7], ord [C + W_s],
// the canonical masks [chunks of W_s].

// the stream block entry candidate x of row r takes, or -1 (a client row's
// padding)
__device__ __forceinline__ int64_t split_source(const LaneBufs& b, int64_t r,
                                                int64_t x) {
  const int64_t k = b.k, sf = b.s_flows, s2 = 2 * sf;
  const bool client = r < sf;
  if (x < k) return x * s2 + (client ? r + sf : r - sf);  // the peer's send
  if (x < 2 * k) return k * s2 + (x - k) * s2 + r;         // own RTO arm
  return client ? -1 : 4 * k * sf + (x - 2 * k) * sf + (r - sf);  // burst
}

// rows (a warp each) a block: two the fastest on the H100 on the untiered
// mixed mesh's states, traced or not (one 3 % slower, four 4 %, eight 20 %)
constexpr int SPLIT_ROWS = 2;

__host__ __device__ __forceinline__ int64_t split_row_words(int64_t c,
                                                            int64_t w_s) {
  return 8 * (c + w_s) + (w_s + 31) / 32;
}

template <class P>
__global__ void stream_rows_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  extern __shared__ int32_t smem[];
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + wp;
  const int64_t c = b.c, k = b.k, s2 = 2 * b.s_flows;
  if (r >= s2) return;  // the whole warp
  const int64_t w_s = 2 * k + k * PUMP_BURST, words = split_row_words(c, w_s);
  int32_t* const mem = b.split_global ? b.m_scratch + r * words
                                      : smem + wp * words;
  int32_t* const ent = mem;                  // [C + W_s][7]
  int32_t* const ord = mem + 7 * (c + w_s);  // [C + W_s]
  int32_t* const cmask = ord + (c + w_s);    // [chunks]
  const int64_t n_ent = stream_entries(b);
  const int64_t lane = b.flow_lanes[r];
  const int64_t rec_base = b.rec_slots - s2 * w_s + r * w_s;
  const int64_t fl_base = b.fl_split + r * w_s;
  const unsigned below = (1u << ln) - 1u;
  // the tail group empty, before its valid entries are written
  if (b.log_cap > 0) zero_recs(b, rec_base, w_s);
  if (b.flowtrace)
    for (int64_t x = ln; x < w_s; x += 32) b.fl_valid[fl_base + x] = 0;

  // the queue row, then the candidates, a lane each: canonical empties
  // counted, the rest after the queue
  const bool q_run = load_queue_run<7>(b, ent, lane);
  const int32_t chunks = static_cast<int32_t>((w_s + 31) / 32);
  int32_t n_rest = 0, n_canon = 0;
  for (int32_t m0 = 0; m0 < chunks; m0 += ROW_UNROLL) {
    int32_t w7[ROW_UNROLL][7];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int64_t x = (m0 + u) * 32 + ln;
      const int64_t idx = x < w_s ? split_source(b, r, x) : -1;
      if (idx >= 0) {
#pragma unroll
        for (int w = 0; w < 7; ++w) w7[u][w] = b.sx_blk[(w + 1) * n_ent + idx];
      } else {
        w7[u][0] = w7[u][1] = NEVER32;
#pragma unroll
        for (int w = 2; w < 7; ++w) w7[u][w] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      if (m0 + u >= chunks) break;  // warp-uniform
      const bool in = (m0 + u) * 32 + ln < w_s;
      const bool canon = in && canon_key(w7[u]);
      const unsigned rest = __ballot_sync(FULL_MASK, in && !canon);
      const unsigned cm = __ballot_sync(FULL_MASK, canon);
      if (ln == 0) cmask[m0 + u] = static_cast<int32_t>(cm);
      if (in && !canon) {
        int32_t* e = ent + 7 * (c + n_rest + __popc(rest & below));
#pragma unroll
        for (int w = 0; w < 7; ++w) e[w] = w7[u][w];
      }
      n_rest += __popc(rest);
      n_canon += __popc(cm);
    }
  }
  __syncwarp();
  const int32_t n0 = static_cast<int32_t>(c);
  const Runs rs{n0, n0 + n_rest, q_run, one_run(ent, n0, n0 + n_rest)};
  order_runs(ent, ord, rs);
  int32_t base;
  int32_t tail = place_runs<7, true>(b, ent, ord, rs, n_canon, lane, rec_base,
                                     fl_base, &base);
  // the canonical empties that rank below C: the j-th at base + j, with its
  // own size and payload words
  int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                         b.q_phi, b.q_plo};
  const int32_t room = n0 - base;
  for (int32_t m = 0, seen = 0; m < chunks && seen < room; ++m) {
    const unsigned cm = static_cast<unsigned>(cmask[m]);
    const int32_t j = seen + __popc(cm & below);
    if (((cm >> ln) & 1u) && j < room) {
      const int64_t idx = split_source(b, r, m * 32 + ln);
      const int64_t at = lane * c + base + j;
      q[0][at] = NEVER32;
      q[1][at] = NEVER32;
      q[2][at] = 0;
      q[3][at] = 0;
#pragma unroll
      for (int w = 4; w < 7; ++w)
        q[w][at] = idx >= 0 ? b.sx_blk[(w + 1) * n_ent + idx] : 0;
    }
    seen += __popc(cm);
  }
  tail = __reduce_add_sync(FULL_MASK, static_cast<unsigned>(tail));
  if (ln == 0 && tail) b.n_queue[lane] += tail;  // lanes are distinct
}

// ---- kernel H: inject_merge -------------------------------------------------
// One host-staged injection block ([INJ_WORDS, B] int32: valid, dst, thi,
// tlo, auxh, auxl, size) into the lane queues, a warp per lane over all N
// lanes, INJ_WARPS lanes a block, in one launch.  A lane's group — the
// block's valid rows addressed to it — comes from ballots over the block's
// valid and dst words, 32 rows a ballot, in index order, the block's words
// and the row's keys read before the first store (B's counting sort, count
// with its scan and place before a merge that reads the group, measured
// 1.6x slower: PERF.md); x_cnt, x_fill and x_order are not touched.  The
// group's first Cxi by (time, aux, index) become one sorted run: up to 32
// in one warp sort, a wider group in batches of 32, each sorted and merged
// into the Cxi smallest so far.  That run (the payload words of stream
// configs zero) and Cxi - min(cnt, Cxi) canonical empties merge with the
// queue row as E's; no record.  A lane with no group still takes Cxi
// canonical empties, which push out past C every queue entry keyed above
// them (consumed entries keep their aux words): a warp whose row is sorted
// and holds none writes nothing.  The rest of the group and the valid
// entries past C count into n_queue (the sheds into nb_shed too, with
// netobs).  Not gated on live: the host launches it only with rows to
// inject, before the turn's first step arms the turn.  Working memory a
// lane (inject_row_words): ent [C + Cxi][7], ord [C + Cxi], the group's
// masks and bases [2 x chunks of B], the selection's two runs of Cxi and
// its batch of 32 (six words an entry: the key's four, the row index, the
// size).
constexpr int INJ_WORDS = 7;
constexpr int INJ_WARPS = 4;
constexpr int INJ_BALLOTS = 16;  // chunks of 32 block rows read before ballots
constexpr int SEL_WORDS = 6;

__host__ __device__ __forceinline__ int64_t inject_row_words(int64_t c,
                                                             int64_t cxi,
                                                             int64_t nb) {
  return 8 * (c + cxi) + 2 * ((nb + 31) / 32) + SEL_WORDS * (2 * cxi + 32);
}

// a selection entry: its key (row index m as x) and size
__device__ __forceinline__ Key sel_key(const int32_t* s, int32_t j) {
  const int32_t* e = s + SEL_WORDS * j;
  return Key{static_cast<uint32_t>(e[0]), static_cast<uint32_t>(e[1]),
             static_cast<uint32_t>(e[2]), static_cast<uint32_t>(e[3]),
             static_cast<uint32_t>(e[4])};
}

__device__ __forceinline__ void sel_put(int32_t* s, int32_t j, const Key& k,
                                        int32_t size) {
  int32_t* e = s + SEL_WORDS * j;
  e[0] = static_cast<int32_t>(k.th);
  e[1] = static_cast<int32_t>(k.tl);
  e[2] = static_cast<int32_t>(k.ah);
  e[3] = static_cast<int32_t>(k.al);
  e[4] = static_cast<int32_t>(k.x);
  e[5] = size;
}

// the count of sel[0, n) (sorted) below kv
__device__ __forceinline__ int32_t sel_below(const int32_t* s, int32_t n,
                                             const Key& kv) {
  int32_t lo = 0;
  while (lo < n) {
    const int32_t mid = (lo + n) >> 1;
    if (lt(sel_key(s, mid), kv)) {
      lo = mid + 1;
    } else {
      n = mid;
    }
  }
  return lo;
}

template <int W, class P>
__global__ void inject_merge_kernel(const __grid_constant__ P bufs,
                                    const int32_t* inj) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  extern __shared__ int32_t smem[];
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + wp;
  if (i >= b.n) return;  // the whole warp
  const int64_t c = b.c, cxi = b.cxi, nb = b.inj_b;
  const int64_t words = inject_row_words(c, cxi, nb);
  int32_t* const mem = b.inject_global ? b.m_scratch + i * words
                                       : smem + wp * words;
  int32_t* const ent = mem;                      // [C + Cxi][7]
  int32_t* const ord = ent + 7 * (c + cxi);      // [C + Cxi]
  int32_t* const gmask = ord + (c + cxi);        // [chunks]
  const int32_t chunks = static_cast<int32_t>((nb + 31) / 32);
  int32_t* const gbase = gmask + chunks;         // [chunks]
  int32_t* sel = gbase + chunks;                 // [Cxi][6]
  int32_t* sel2 = sel + SEL_WORDS * cxi;         // [Cxi][6]
  int32_t* const batch = sel2 + SEL_WORDS * cxi; // [32][6]

  // whether the row moves without a group: an entry keyed above the
  // canonical empty, or the row out of order (this warp lane's part)
  const auto row_moves = [&]() {
    const Key probe = canon_probe();
    const auto key_at = [&](int64_t x) {
      const int64_t at = i * c + x;
      return make_key(b.q_thi[at], b.q_tlo[at], b.q_auxh[at], b.q_auxl[at],
                      static_cast<int32_t>(x));
    };
    bool moves = false;
    for (int64_t x = ln; x < c; x += 32) {
      const Key kx = key_at(x);
      moves |= lt(probe, kx) || (x + 1 < c && lt(key_at(x + 1), kx));
    }
    return moves;
  };
  // the group: its size, and the block row of its member r; the block's
  // words and the row's keys are read before the first store, so all are
  // in flight together
  int32_t cnt = 0;
  bool moves = false;
  for (int32_t m0 = 0; m0 < chunks; m0 += INJ_BALLOTS) {
    int32_t valid[INJ_BALLOTS], dst[INJ_BALLOTS];
#pragma unroll
    for (int u = 0; u < INJ_BALLOTS; ++u) {
      const int64_t m = (m0 + u) * 32 + ln;
      valid[u] = m < nb ? __ldg(inj + m) : 0;
      dst[u] = m < nb ? __ldg(inj + nb + m) : -1;
    }
    if (m0 == 0) moves = row_moves();
#pragma unroll
    for (int u = 0; u < INJ_BALLOTS; ++u) {
      if (m0 + u >= chunks) break;  // warp-uniform
      const unsigned g = __ballot_sync(FULL_MASK, valid[u] != 0 && dst[u] == i);
      if (ln == 0) {
        gmask[m0 + u] = static_cast<int32_t>(g);
        gbase[m0 + u] = cnt;
      }
      cnt += __popc(g);
    }
  }
  __syncwarp();
  // no group: a sorted row moves only its entries keyed above the
  // canonical empty
  if (cnt == 0 && !__any_sync(FULL_MASK, moves)) return;
  const auto member = [&](int32_t r) -> int32_t {
    int32_t lo = 0, hi = chunks - 1;
    while (lo < hi) {  // the last chunk whose base is <= r
      const int32_t mid = (lo + hi + 1) >> 1;
      if (gbase[mid] <= r) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    return lo * 32 + nth_bit(static_cast<unsigned>(gmask[lo]), r - gbase[lo]);
  };
  const int32_t take = cnt < cxi ? cnt : static_cast<int32_t>(cxi);

  // the group's first Cxi by (time, aux, index) into ent[C, C + take)
  const auto load_batch = [&](int32_t r0) {
    const int32_t r = r0 + ln;
    Key kv = pad_key(PAD_INDEX);
    if (r < cnt) {
      const int32_t m = member(r);
      kv = make_key(inj[2 * nb + m], inj[3 * nb + m], inj[4 * nb + m],
                    inj[5 * nb + m], m);
    }
    return warp_sort(kv, ln);
  };
  if (cnt <= 32) {
    const Key kv = load_batch(0);
    if (ln < take) {
      int32_t* e = ent + 7 * (c + ln);
      e[0] = word_of(kv.th);
      e[1] = word_of(kv.tl);
      e[2] = word_of(kv.ah);
      e[3] = word_of(kv.al);
      e[4] = inj[6 * nb + kv.x];
      e[5] = e[6] = 0;
    }
  } else {
    // batches of 32, each merged into the Cxi smallest so far (sel)
    int32_t kept = 0;
    for (int32_t r0 = 0; r0 < cnt; r0 += 32) {
      const Key kv = load_batch(r0);
      const int32_t nbat = min(32, cnt - r0);
      if (ln < nbat) sel_put(batch, ln, kv, inj[6 * nb + kv.x]);
      __syncwarp();
      for (int32_t j = ln; j < kept; j += 32) {
        const Key kj = sel_key(sel, j);
        const int32_t p = j + sel_below(batch, nbat, kj);
        if (p < cxi) {
          int32_t* e = sel + SEL_WORDS * j;
          sel_put(sel2, p, kj, e[5]);
        }
      }
      if (ln < nbat) {
        const int32_t p = ln + sel_below(sel, kept, kv);
        if (p < cxi) sel_put(sel2, p, kv, batch[SEL_WORDS * ln + 5]);
      }
      kept = min(kept + nbat, static_cast<int32_t>(cxi));
      int32_t* t = sel;
      sel = sel2;
      sel2 = t;
      __syncwarp();
    }
    for (int32_t j = ln; j < take; j += 32) {
      const int32_t* s = sel + SEL_WORDS * j;
      int32_t* e = ent + 7 * (c + j);
      for (int w = 0; w < 4; ++w) e[w] = word_of(static_cast<uint32_t>(s[w]));
      e[4] = s[5];
      e[5] = e[6] = 0;
    }
  }
  // (load_queue_run's barrier orders these stores before every read)
  const int32_t n0 = static_cast<int32_t>(c);
  const bool q_run = load_queue_run<W>(b, ent, i);
  const Runs rs{n0, n0 + take, q_run, true};
  order_runs(ent, ord, rs);
  const int32_t n_e = static_cast<int32_t>(cxi) - take;
  int32_t base;
  int32_t tail = place_runs<W, false>(b, ent, ord, rs, n_e, i, 0, 0, &base);
  // the canonical empties that rank below C, base + j
  int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                         b.q_phi, b.q_plo};
  const int64_t end = base + n_e < c ? base + n_e : c;
  for (int64_t x = base + ln; x < end; x += 32) {
    q[0][i * c + x] = NEVER32;
    q[1][i * c + x] = NEVER32;
#pragma unroll
    for (int w = 2; w < W; ++w) q[w][i * c + x] = 0;
  }
  tail = __reduce_add_sync(FULL_MASK, static_cast<unsigned>(tail));
  if (ln == 0) {
    const int32_t lost_pre = cnt - take;
    if (tail + lost_pre) b.n_queue[i] += tail + lost_pre;
    if (b.netobs && lost_pre) b.nb_shed[i] += lost_pre;
  }
}

// ---- kernel C: queue_min_window ---------------------------------------------
// One cluster of c_blocks blocks per scenario (grid (c_blocks, S), cluster
// (c_blocks, 1, 1)): the lexicographic minimum of the queue heads (column 0
// of every sorted row, the tier's rows too), then the window law and the
// live flag.  The heads are strided int32 pairs, two 32-byte sectors each,
// so one SM's share of the L2 traffic set the old one-block kernel's time;
// the cluster spreads them over c_blocks SMs (lanes.heads_blocks: a
// thread's worth of heads a thread, up to 16 blocks, one block where the
// heads fit one), each thread issuing all its loads (and the live word's)
// before its min.  Once every block has started, each writes its minimum
// into rank 0's shared memory (distributed shared memory); after
// cluster.sync() only rank 0 goes on, to the law.  No global scratch, no
// atomics: nothing is left for a later call to clear.
// With dynamic runahead the window is the smallest latency sent over so
// far, never below the floor (the static runahead until the first send).
// A window advance first folds the finished window into the netobs
// histogram (one thread: a scalar step).
constexpr int HEAD_THREADS = 1024;
constexpr int HEAD_CLUSTER_MAX = 16;  // lanes.HEAD_CLUSTER_MAX
constexpr int HEAD_UNROLL = 4;  // heads a thread loads before its min

// The warp's min of m: valid in lane 0.
__device__ __forceinline__ int64_t warp_min(int64_t m) {
  for (int s = 16; s > 0; s >>= 1) {
    const int64_t o = __shfl_down_sync(FULL_MASK, m, s);
    m = o < m ? o : m;
  }
  return m;
}

// The block's min of m: valid in thread 0.
__device__ __forceinline__ int64_t block_min(int64_t m) {
  __shared__ int64_t warp_mins[32];
  m = warp_min(m);
  if ((threadIdx.x & 31) == 0) warp_mins[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32)
    m = warp_min(threadIdx.x < (blockDim.x + 31) / 32 ? warp_mins[threadIdx.x]
                                                     : NEVER64);
  return m;
}

// The cluster barrier in its two halves (PTX barrier.cluster): a block
// arrives early, as soon as it has started, and waits only where it first
// touches another block's shared memory, so the wait for the cluster's
// last block overlaps the block's own loads.  Every thread of every block
// calls both, in the same order.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cluster's min head, valid in rank 0's thread 0 (`*lead` there);
// false, for the whole cluster, when `gated` and the scenario is done
// (ctl[0] 0, loaded beside the heads).  Every block of the cluster calls
// it: each pushes its block minimum into rank 0's shared memory between
// the halves of one barrier and the whole of a second.
__device__ __forceinline__ bool heads_min(const LaneBufs& b, bool gated,
                                          int64_t* out, bool* lead) {
  __shared__ int64_t blk_min[HEAD_CLUSTER_MAX];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), blocks = cluster.num_blocks();
  const int32_t live = gated ? b.ctl[0] : 1;
  const int64_t n_heads = b.n + 2 * b.tier_s;
  const int64_t tier_plane = 2 * b.tier_s * b.c2;
  const int64_t stride = static_cast<int64_t>(blocks) * blockDim.x;
  int64_t m = NEVER64;
  for (int64_t i0 = rank * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i0 < n_heads; i0 += HEAD_UNROLL * stride) {
    int32_t hi[HEAD_UNROLL], lo[HEAD_UNROLL];
#pragma unroll
    for (int u = 0; u < HEAD_UNROLL; ++u) {
      const int64_t i = i0 + u * stride;
      hi[u] = NEVER32;
      lo[u] = NEVER32;
      if (i < b.n) {
        hi[u] = b.q_thi[i * b.c];
        lo[u] = b.q_tlo[i * b.c];
      } else if (i < n_heads) {  // tiered: the tier's endpoint rows
        const int64_t r = i - b.n;
        hi[u] = b.tier_q[r * b.c2];
        lo[u] = b.tier_q[tier_plane + r * b.c2];
      }
    }
#pragma unroll
    for (int u = 0; u < HEAD_UNROLL; ++u) {
      const int64_t t = join_t(hi[u], lo[u]);
      m = t < m ? t : m;
    }
  }
  if (live == 0) return false;  // the same word for the whole cluster
  cluster_arrive_relaxed();
  m = block_min(m);
  cluster_wait();  // every block has started: rank 0's memory is there
  if (threadIdx.x == 0) cluster.map_shared_rank(blk_min, 0)[rank] = m;
  cluster.sync();  // every block minimum is in rank 0
  if (rank == 0 && threadIdx.x < 32)
    m = warp_min(threadIdx.x < blocks ? blk_min[threadIdx.x] : NEVER64);
  *lead = rank == 0 && threadIdx.x == 0;
  *out = m;
  return true;
}

// netobs: the finished window's PACKET count into the histogram, at bucket
// floor(log2) (the last bucket open-ended); windows without a packet are
// skipped.  One thread.
__device__ __forceinline__ void flush_hist(const LaneBufs& b) {
  if (b.netobs && *b.nb_win > 0) {
    const int32_t bucket = 31 - __clz(*b.nb_win);
    b.nb_hist[bucket < NB_HIST_BUCKETS ? bucket : NB_HIST_BUCKETS - 1] += 1;
    *b.nb_win = 0;
  }
}

// The window width: the static runahead, or with dynamic runahead the
// smallest latency sent over so far, never below the floor.
__device__ __forceinline__ int64_t runahead_now(const LaneBufs& b) {
  int64_t runahead = b.runahead;
  if (b.dyn_runahead) {
    const int32_t used = *b.min_used_lat;
    if (used != NEVER32)
      runahead = used > b.runahead_floor ? used : b.runahead_floor;
  }
  return runahead;
}

template <class P>
__global__ void __launch_bounds__(HEAD_THREADS)
    queue_min_kernel(const __grid_constant__ P bufs, int advance) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  // the window's end, loaded while the heads are (only this kernel's lead
  // thread writes it)
  int32_t we_hi = 0, we_lo = 0;
  if (threadIdx.x == 0) {
    we_hi = *b.now_we_hi;
    we_lo = *b.now_we_lo;
  }
  int64_t m;
  bool lead;
  if (!heads_min(b, true, &m, &lead) || !lead) return;

  const bool live = m < b.stop;
  int64_t we = join_raw(we_hi, we_lo);
  if (advance && live && m >= we) {
    flush_hist(b);
    const int64_t end = m + runahead_now(b);
    we = end < b.stop ? end : b.stop;
    split(we, b.now_we_hi, b.now_we_lo);
    *b.rounds += 1;
  }
  b.ctl[0] = live ? 1 : 0;
  b.ctl[1] = (live && m < we) ? 1 : 0;
  split(m, &b.ctl[2], &b.ctl[3]);
}

// Kernel C's hybrid mode, one step of a hybrid turn (lanes.py
// hybrid_window_plain; the reference's _build_hybrid_run): the turn's first step
// resets the egress count, losses and min, folds the host side's used
// latency in (dynamic runahead) and arms the turn.  Each step evaluates the
// stop condition on the state as it stands — room for one more iteration
// in the egress buffer, and a lane head in the current window or a fresh
// window the host takes no part in (ext_bound = min(the host's next event,
// the earliest egressed delivery)) — and either opens the next window at
// the global min, as the device loop does, or stops the turn: live 0 and
// the packed readback written (HYB_* order).  The host's inputs arrive as
// kernel parameters.
constexpr int HYB_LANE_MIN = 0, HYB_DEV_WE = 1, HYB_MIN_USED = 2,
              HYB_EGRESS_COUNT = 3, HYB_EGRESS_LOST = 4;

template <class P>
__global__ void __launch_bounds__(HEAD_THREADS)
    hybrid_window_kernel(const __grid_constant__ P bufs, int first,
                         int32_t ext_hi, int32_t ext_lo, int32_t ext_used) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  // the turn's first step is not gated: it arms the turn
  int64_t m;
  bool lead;
  if (!heads_min(b, !first, &m, &lead) || !lead) return;
  if (first) {
    if (b.dyn_runahead && ext_used < *b.min_used_lat)
      *b.min_used_lat = ext_used;
    *b.egress_count = 0;
    *b.egress_lost = 0;
    *b.egress_min_hi = NEVER32;
    *b.egress_min_lo = NEVER32;
    b.hyb[HYB_DEV_WE] = -1;
  }
  const int64_t we = join_raw(*b.now_we_hi, *b.now_we_lo);
  const int64_t ext = join_t(ext_hi, ext_lo);
  const int64_t egm = join_t(*b.egress_min_hi, *b.egress_min_lo);
  const int64_t bound = ext < egm ? ext : egm;
  const bool in_window = m < we;
  const int64_t next = m < bound ? m : bound;
  const bool fresh_ok = !(bound < we) && next < b.stop;
  const bool room = *b.egress_count < b.room_floor;
  split(m, &b.ctl[2], &b.ctl[3]);
  if (!(room && (in_window || fresh_ok))) {
    b.ctl[0] = 0;
    b.ctl[1] = 0;
    b.hyb[HYB_LANE_MIN] = m;
    b.hyb[HYB_DEV_WE] = join_t(*b.now_we_hi, *b.now_we_lo);
    b.hyb[HYB_MIN_USED] = b.dyn_runahead ? *b.min_used_lat : NEVER32;
    b.hyb[HYB_EGRESS_COUNT] = *b.egress_count;
    b.hyb[HYB_EGRESS_LOST] = *b.egress_lost;
    return;
  }
  if (next >= we) {  // a fresh window (next < stop here: the turn is live)
    flush_hist(b);
    const int64_t end = next + runahead_now(b);
    split(end < b.stop ? end : b.stop, b.now_we_hi, b.now_we_lo);
    *b.rounds += 1;
  }
  b.ctl[0] = 1;
  b.ctl[1] = in_window ? 1 : 0;
}

// Kernel C's fused mode, one step of a k-window fused dispatch (lanes.py
// hybrid_fused_window_plain; the reference's _build_hybrid_fused_run): the
// one-window law's condition against the schedule slot the dispatch has
// reached (fz[0]); when it fails, the end of a segment: a window the host
// joins below the horizon (the schedule's last slot) is consumed — its end
// recorded, the pointer set past every slot before it, egress_min re-armed
// from this dispatch's DELIVERED rows at or past it (a block min) — and the
// condition is tried again, until k_eff windows are consumed; otherwise
// the dispatch stops.  The cluster reduces the heads as in C's other modes;
// then rank 0's block alone goes on: its thread 0 runs the law and tells
// the block, through shared memory, what comes next (the refolds are few:
// at most the egress buffer's rows, k_eff times).
constexpr int HYB_K_DONE = 5, HYB_WE_BASE = 6;
constexpr int FUSED_STEP = 0, FUSED_REFOLD = 1, FUSED_REFOLD_STOP = 2,
              FUSED_STOP = 3;

// the end of a fused dispatch: live 0 and the readback
__device__ void fused_stop(const LaneBufs& b, int64_t m) {
  b.ctl[0] = 0;
  b.ctl[1] = 0;
  b.hyb[HYB_LANE_MIN] = m;
  b.hyb[HYB_DEV_WE] = join_raw(*b.now_we_hi, *b.now_we_lo);
  b.hyb[HYB_MIN_USED] = b.dyn_runahead ? *b.min_used_lat : NEVER32;
  b.hyb[HYB_EGRESS_COUNT] = *b.egress_count;
  b.hyb[HYB_EGRESS_LOST] = *b.egress_lost;
  b.hyb[HYB_K_DONE] = b.fz[1];
  b.hyb[HYB_WE_BASE + b.k_cap] = b.fz[2];
}

// thread 0: one pass of the fused law; *thr is the consumed window's end
__device__ int fused_pass(const LaneBufs& b, int64_t m, int k_eff,
                          int64_t* thr) {
  const int64_t we = join_raw(*b.now_we_hi, *b.now_we_lo);
  const int32_t ptr = b.fz[0];
  const int64_t e = b.ext[ptr < b.ext_slots - 1 ? ptr : b.ext_slots - 1];
  const int64_t egm = join_t(*b.egress_min_hi, *b.egress_min_lo);
  const int64_t bound = e < egm ? e : egm;
  const bool in_window = m < we;
  const bool host_in = bound < we;
  const int64_t next = m < bound ? m : bound;
  const bool room = *b.egress_count < b.room_floor;
  if (room && (in_window || (!host_in && next < b.stop))) {
    if (next >= we) {  // a fresh window (next < stop: the turn is live)
      flush_hist(b);
      const int64_t end = next + runahead_now(b);
      split(end < b.stop ? end : b.stop, b.now_we_hi, b.now_we_lo);
      *b.rounds += 1;
    }
    b.ctl[0] = 1;
    b.ctl[1] = in_window ? 1 : 0;
    return FUSED_STEP;
  }
  if (!(host_in && room && !in_window && bound < b.ext[b.ext_slots - 1])) {
    fused_stop(b, m);
    return FUSED_STOP;
  }
  const int32_t kd = b.fz[1];
  b.hyb[HYB_WE_BASE + (kd < b.k_cap - 1 ? kd : b.k_cap - 1)] = we;
  b.fz[1] = kd + 1;
  int32_t past = 0;  // every slot, the horizon's padding included
  for (int64_t i = 0; i < b.ext_slots; ++i) past += b.ext[i] < we ? 1 : 0;
  b.fz[0] = past;
  *thr = we;
  return kd + 1 < k_eff ? FUSED_REFOLD : FUSED_REFOLD_STOP;
}

// the earliest DELIVERED egress time at or past thr among this dispatch's
// rows (a block min; valid in thread 0)
__device__ int64_t egress_refold(const LaneBufs& b, int64_t thr) {
  int64_t m = NEVER64;
  const int64_t rows = *b.egress_count < b.eg_cap ? *b.egress_count : b.eg_cap;
  for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
    const int64_t* row = b.egress + r * 6;
    if (row[5] == DELIVERED && row[0] >= thr) m = row[0] < m ? row[0] : m;
  }
  return block_min(m);
}

template <class P>
__global__ void __launch_bounds__(HEAD_THREADS)
    hybrid_fused_kernel(const __grid_constant__ P bufs, int first, int k_eff,
                        int32_t ext_used) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  // the dispatch's first step is not gated: it arms the dispatch
  int64_t m;
  bool lead;
  if (!heads_min(b, !first, &m, &lead)) return;
  // rank 0's block runs the law (its thread 0) and the refolds
  if (cg::this_cluster().block_rank() != 0) return;
  __shared__ int cmd;
  __shared__ int64_t thr;
  if (threadIdx.x == 0) {
    if (first) {
      if (b.dyn_runahead && ext_used < *b.min_used_lat)
        *b.min_used_lat = ext_used;
      *b.egress_count = 0;
      *b.egress_lost = 0;
      *b.egress_min_hi = NEVER32;
      *b.egress_min_lo = NEVER32;
      for (int64_t i = 0; i < HYB_WE_BASE + b.k_cap + 1; ++i) b.hyb[i] = 0;
      b.hyb[HYB_DEV_WE] = -1;
      b.fz[0] = b.fz[1] = b.fz[2] = 0;
    }
    split(m, &b.ctl[2], &b.ctl[3]);
    b.fz[2] += 1;
  }
  // at most k_eff + 1 passes: each pass but the last consumes a window
  for (;;) {
    if (threadIdx.x == 0) cmd = fused_pass(b, m, k_eff, &thr);
    __syncthreads();
    const int c = cmd;
    if (c == FUSED_STEP || c == FUSED_STOP) return;
    const int64_t r = egress_refold(b, thr);
    if (threadIdx.x == 0) {
      split(r, b.egress_min_hi, b.egress_min_lo);
      if (c == FUSED_REFOLD_STOP) fused_stop(b, m);
    }
    if (c == FUSED_REFOLD_STOP) return;
    __syncthreads();  // cmd is written again by the next pass
  }
}

// ---- kernel D: append_log ---------------------------------------------------
// Compaction of the iteration's valid rows (in buffer order) into a bounded
// buffer that never wraps, in three instances of one template on the row:
// the records of recs into the [L, 6] int64 log, the flow records of
// fl_recs into the [FL, 10] int32 flowtrace ring, each stamped with the
// current window's end (C set it before A; D runs before the next C), and
// on a hybrid run A's egress candidates into the [E, 6] int64 egress
// buffer, whose earliest DELIVERED time lowers egress_min.
//
// One cluster of LOG_CLUSTER blocks per instance and scenario (grid
// (instances x LOG_CLUSTER, S)).  Each block owns one contiguous slice of
// the flags, whole runs of LOG_BITS, and a thread one run: it loads the run
// (int4 loads where the flags are 16-byte aligned, all in flight) into a
// 32-bit mask.  The block scans the masks' counts and stages its valid
// indices in shared memory.  Then, once every block of the cluster has
// started (the wait of a barrier each block arrived at as it began), each
// block writes its count (and, for the egress, its minimum) into every
// block's shared memory (distributed shared memory); after cluster.sync()
// each block forms its offset from its own copy of the counts, and rank 0
// the total (and the minimum).  Nothing is read from another block after
// that barrier, so no block waits for another to finish.  Each block then
// copies its rows from `*count` + its offset, the block's threads on
// consecutive pieces of consecutive destination rows (a log row as three
// 16-byte stores, a ring row as five 8-byte ones), rows past the capacity
// not copied but counted as lost; rank 0 writes the count, the losses and
// the egress minimum once.  A slice past one tile of LOG_TILE flags scans
// its later tiles after the barrier, one at a time.  No global ticket,
// fence, memset or workspace word: nothing is left for a later call to
// clear.
constexpr int LOG_THREADS = 1024;
constexpr int LOG_BITS = 32;  // flags a thread takes in a tile (one mask);
                              // lanes.LOG_BITS
constexpr int64_t LOG_TILE = static_cast<int64_t>(LOG_THREADS) * LOG_BITS;
// dynamic shared memory: a tile's valid flag indices
constexpr int LOG_SMEM = static_cast<int>(LOG_TILE * sizeof(uint32_t));
constexpr int LOG_CLUSTER = 16;  // lanes.LOG_CLUSTER

// the log's (and the egress's) rows: six int64 words, copied as they are,
// three 16-byte pieces a row (kernels.LaneArgs checks the alignment)
struct LogRows {
  const int64_t* src;
  int64_t* dst;
  // the rows idx[0, n) (n <= LOG_TILE) to dst rows [pos, pos + n), the
  // block's threads on consecutive pieces
  __device__ __forceinline__ void copy(const uint32_t* idx, int n,
                                      int64_t pos) const {
    const longlong2* s2 = reinterpret_cast<const longlong2*>(src);
    longlong2* d2 = reinterpret_cast<longlong2*>(dst);
    for (int q = threadIdx.x; q < 3 * n; q += blockDim.x) {
      const int j = q / 3, w = q - 3 * j;
      d2[(pos + j) * 3 + w] = s2[static_cast<int64_t>(idx[j]) * 3 + w];
    }
  }
};

// the ring's rows: a flow record's eight int32 words around the window
// stamp, five 8-byte pieces a row (the record's first pair, the stamp, its
// other three pairs; kernels.LaneArgs checks the alignment)
struct FlowRows {
  const int32_t* src;
  int32_t* dst;
  int32_t we_hi, we_lo;
  __device__ __forceinline__ void copy(const uint32_t* idx, int n,
                                      int64_t pos) const {
    const int2* s2 = reinterpret_cast<const int2*>(src);
    int2* d2 = reinterpret_cast<int2*>(dst);
    for (int q = threadIdx.x; q < 5 * n; q += blockDim.x) {
      const int j = q / 5, w = q - 5 * j;
      d2[(pos + j) * 5 + w] =
          w == 1 ? make_int2(we_hi, we_lo)
                 : s2[static_cast<int64_t>(idx[j]) * 4 + (w ? w - 1 : 0)];
    }
  }
};

// The flags [i, i + LOG_BITS) below hi as a mask (bit u: flag i + u).
__device__ __forceinline__ uint32_t flag_mask(const int32_t* valid, int64_t i,
                                              int64_t hi, bool vec) {
  uint32_t m = 0;
  if (vec && i + LOG_BITS <= hi) {
    const int4* v = reinterpret_cast<const int4*>(valid + i);
    int4 w[LOG_BITS / 4];
#pragma unroll
    for (int u = 0; u < LOG_BITS / 4; ++u) w[u] = __ldg(v + u);
#pragma unroll
    for (int u = 0; u < LOG_BITS / 4; ++u)
      m |= (w[u].x != 0 ? 1u : 0u) << (4 * u) |
           (w[u].y != 0 ? 2u : 0u) << (4 * u) |
           (w[u].z != 0 ? 4u : 0u) << (4 * u) |
           (w[u].w != 0 ? 8u : 0u) << (4 * u);
  } else {
#pragma unroll 8
    for (int u = 0; u < LOG_BITS; ++u)
      if (i + u < hi && __ldg(valid + i + u)) m |= 1u << u;
  }
  return m;
}

// The exclusive prefix of v over the block's threads in order, and the
// block's total in *total.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* total) {
  __shared__ int32_t warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = v;
  for (int s = 1; s < 32; s <<= 1) {
    const int32_t o = __shfl_up_sync(FULL_MASK, incl, s);
    if (lane >= s) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t ws = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : 0;
    for (int s = 1; s < 32; s <<= 1) {
      const int32_t o = __shfl_up_sync(FULL_MASK, ws, s);
      if (lane >= s) ws += o;
    }
    warp_sum[lane] = ws;  // inclusive prefix over the warps
  }
  __syncthreads();
  *total = warp_sum[31];
  const int32_t excl = (warp > 0 ? warp_sum[warp - 1] : 0) + incl - v;
  __syncthreads();  // warp_sum is written again by the next scan
  return excl;
}

// the thread's valid flags (mask m over [i, i + LOG_BITS)) into idx from
// position p, in order
__device__ __forceinline__ void stage(uint32_t* idx, int32_t p, uint32_t m,
                                      int64_t i) {
  while (m) {
    idx[p++] = static_cast<uint32_t>(i + __ffs(m) - 1);
    m &= m - 1;
  }
}

// of a tile's n rows, those that fit the room left (none when it is
// negative)
__device__ __forceinline__ int kept_rows(int n, int64_t room) {
  return room <= 0 ? 0 : n < room ? n : static_cast<int>(room);
}

// what a block shows the cluster: its valid count and, for the egress, the
// earliest DELIVERED time among its valid rows
struct LogPart {
  int64_t n, tmin;
};

// One instance over the cluster: the valid rows of `valid` [n_flags]
// appended in order from *count (see the head of this section); with
// `eg_rows`, the egress instance's minimum over them lowers the pair.
// Nothing, for the whole cluster, when the scenario is done (`live` 0).
template <class Rows>
__device__ __forceinline__ void append_rows(
    int32_t live, const int32_t* valid, int64_t n_flags, const Rows& rows,
    int32_t* count, int32_t* lost, int64_t cap, const int64_t* eg_rows,
    int32_t* eg_hi, int32_t* eg_lo) {
  extern __shared__ uint32_t idx[];  // [LOG_TILE]
  __shared__ LogPart parts[LOG_CLUSTER];  // every block's, by rank
  __shared__ int64_t offset, blk_tmin;
  __shared__ LogPart all;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), blocks = cluster.num_blocks();
  const int64_t start = *count;
  // this block's slice, whole runs of LOG_BITS flags
  const int64_t per = (n_flags + blocks * LOG_BITS - 1) /
                      (blocks * LOG_BITS) * LOG_BITS;
  const int64_t lo = rank * per < n_flags ? rank * per : n_flags;
  const int64_t hi = lo + per < n_flags ? lo + per : n_flags;
  // int4 loads where the flags start 16-byte aligned (a workspace row of a
  // batch may not)
  const bool vec = (reinterpret_cast<uintptr_t>(valid) & 15) == 0;
  const int64_t mine = threadIdx.x * static_cast<int64_t>(LOG_BITS);
  const uint32_t m0 = flag_mask(valid, lo + mine, hi, vec);
  if (live == 0) return;  // the same word for the whole cluster
  cluster_arrive_relaxed();
  // the first tile: the block scan and the staged indices before the
  // barrier; a later tile's flags only counted here
  int32_t n0;
  const int32_t excl0 = block_scan(__popc(m0), &n0);
  stage(idx, excl0, m0, lo + mine);
  int64_t n_blk = n0;
  for (int64_t t0 = lo + LOG_TILE; t0 < hi; t0 += LOG_TILE) {
    int32_t nt;
    block_scan(__popc(flag_mask(valid, t0 + mine, hi, vec)), &nt);
    n_blk += nt;
  }
  int64_t tmin = NEVER64;
  if (eg_rows) {  // the egress: every valid row's time, DELIVERED ones
    for (int64_t t0 = lo; t0 < hi; t0 += LOG_TILE) {
      uint32_t m = t0 == lo ? m0 : flag_mask(valid, t0 + mine, hi, vec);
      while (m) {
        const int64_t* row = eg_rows + (t0 + mine + __ffs(m) - 1) * 6;
        m &= m - 1;
        if (row[5] == DELIVERED) tmin = row[0] < tmin ? row[0] : tmin;
      }
    }
    tmin = block_min(tmin);
    if (threadIdx.x == 0) blk_tmin = tmin;  // thread 0's, to the pushers
    __syncthreads();
    tmin = blk_tmin;
  }
  cluster_wait();  // every block has started: their memory is there
  // this block's part into every block's parts[rank]
  if (threadIdx.x < blocks) {
    LogPart* to = cluster.map_shared_rank(parts, threadIdx.x) + rank;
    to->n = n_blk;
    to->tmin = tmin;
  }
  cluster.sync();  // every part in place, in every block
  if (threadIdx.x < 32) {
    const unsigned r = threadIdx.x;
    const int64_t n_r = r < blocks ? parts[r].n : 0;
    int64_t before = r < rank ? n_r : 0, sum = n_r;
    for (int s = 16; s > 0; s >>= 1) {
      before += __shfl_down_sync(FULL_MASK, before, s);
      sum += __shfl_down_sync(FULL_MASK, sum, s);
    }
    const int64_t mn = warp_min(r < blocks ? parts[r].tmin : NEVER64);
    if (r == 0) {
      offset = before;
      all.n = sum;
      all.tmin = mn;
    }
  }
  __syncthreads();
  if (rank == 0 && threadIdx.x == 0) {
    const int64_t n_valid = all.n;
    int64_t room = cap - start;
    room = room < 0 ? 0 : room;
    const int64_t kept = n_valid < room ? n_valid : room;
    *count = static_cast<int32_t>(start + n_valid);
    *lost += static_cast<int32_t>(n_valid - kept);
    if (eg_rows && all.tmin < join_t(*eg_hi, *eg_lo))
      split(all.tmin, eg_hi, eg_lo);
  }
  int64_t pos = start + offset;
  // the first tile's rows, staged before the barriers
  rows.copy(idx, kept_rows(n0, cap - pos), pos);
  pos += n0;
  for (int64_t t0 = lo + LOG_TILE; t0 < hi; t0 += LOG_TILE) {
    __syncthreads();  // idx is staged again
    const uint32_t m = flag_mask(valid, t0 + mine, hi, vec);
    int32_t nt;
    const int32_t excl = block_scan(__popc(m), &nt);
    stage(idx, excl, m, t0 + mine);
    __syncthreads();
    rows.copy(idx, kept_rows(nt, cap - pos), pos);
    pos += nt;
  }
}

// a cluster for each instance that runs, in this order: the log (when
// logging), the ring (with flowtrace), the egress (hybrid); one block an SM
// (its 128 KB of shared memory), which the launch bound says, so that
// ptxas may give a thread up to 64 registers (it spills at 32 without)
template <class P>
__global__ void __launch_bounds__(LOG_THREADS, 1)
    append_log_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  const int32_t live = b.ctl[0];  // loaded beside the first flags
  unsigned inst = blockIdx.x / LOG_CLUSTER;
  if (b.log_cap > 0) {
    if (inst == 0) {
      append_rows(live, b.rec_valid, b.n_rec, LogRows{b.recs, b.log},
                  b.log_count, b.log_lost, b.log_cap, nullptr, nullptr,
                  nullptr);
      return;
    }
    --inst;
  }
  if (b.flowtrace) {
    if (inst == 0) {
      append_rows(live, b.fl_valid, b.n_fl,
                  FlowRows{b.fl_recs, b.fl_buf, *b.now_we_hi, *b.now_we_lo},
                  b.fl_count, b.fl_lost, b.ft_cap, nullptr, nullptr, nullptr);
      return;
    }
    --inst;
  }
  append_rows(live, b.eg_valid, b.n_eg, LogRows{b.eg_recs, b.egress},
              b.egress_count, b.egress_lost, b.eg_cap, b.eg_recs,
              b.egress_min_hi, b.egress_min_lo);
}

// ---- rand_u32: the threefry draw alone, one thread per draw -----------------
// One master seed's key words; stream and counter words in, first output
// word out, all [m] uint32.
__global__ void rand_u32_kernel(uint32_t seed_lo, uint32_t seed_hi,
                                const uint32_t* stream,
                                const uint32_t* counter, uint32_t* out,
                                int64_t m) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= m) return;
  out[i] = lane_draw(seed_lo, seed_hi, stream[i], counter[i]);
}

inline unsigned blocks_for(int64_t items, unsigned threads) {
  return static_cast<unsigned>((items + threads - 1) / threads);
}

// a merge's dynamic shared memory: none on its global path; past the
// default 48 KB the kernel opts in to the size first
template <class Kernel>
cudaError_t merge_smem(Kernel* kernel, bool global, int64_t bytes,
                       int* smem) {
  *smem = global ? 0 : static_cast<int>(bytes);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

// Calls `launch` with the kernels' parameter (see `scenario`): host[0] at
// s = 1, the s blocks of host up to PARAM_SCENARIOS, else the device array.
// `launch` returns the first error it met.
template <class Launch>
int with_bufs(const LaneBufs* host, const LaneBufs* dev, int s,
              Launch launch) {
  cudaError_t err;
  if (s == 1) {
    err = launch(host[0]);
  } else if (s <= PARAM_SCENARIOS) {
    ParamBufs few{};
    std::copy(host, host + s, few.b);
    err = launch(few);
  } else {
    err = launch(dev);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// A launch of `kernel` in clusters of `cluster` blocks along x, through
// cudaLaunchKernelEx.  The first launch of each instance (*ready false)
// allows the non-portable sizes past eight blocks and opts in to `smem`
// bytes of dynamic shared memory past the default 48 KB.  A launch the
// device refuses (no room for the cluster, say) returns its error; nothing
// falls back to another form.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), bool* ready, dim3 grid,
                           unsigned threads, unsigned cluster, int smem,
                           cudaStream_t stream, Args... args) {
  if (!*ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    *ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

unsigned merge_threads(int64_t w_all) {
  int64_t threads = (w_all + 31) / 32 * 32;
  return static_cast<unsigned>(threads < 256 ? threads : 256);
}

// A warp-a-row merge's rows a block (E, H): `rows`, halved while their
// working memory passes the device's opt-in limit (any number on the
// global path)
int fit_rows(int64_t rows, int64_t row_bytes, bool global) {
  static int optin = 0;
  if (!global && optin == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
  }
  while (!global && rows > 1 && rows * row_bytes > optin) rows >>= 1;
  return static_cast<int>(rows);
}

// kernel H over one injection block `inj` ([INJ_WORDS, inj_b] int32 on the
// device): a warp a lane, INJ_WARPS lanes a block
template <int W, class P>
cudaError_t inject_launch(const LaneBufs* b, P bufs, int s, const int32_t* inj,
                          cudaStream_t stream) {
  const bool global = b->inject_global != 0;
  const int64_t bytes =
      inject_row_words(b->c, b->cxi, b->inj_b) * sizeof(int32_t);
  const int rows = fit_rows(INJ_WARPS, bytes, global);
  int smem = 0;
  const cudaError_t err =
      merge_smem(inject_merge_kernel<W, P>, global, rows * bytes, &smem);
  if (err == cudaSuccess)
    inject_merge_kernel<W, P><<<dim3(blocks_for(b->n, rows), s), 32 * rows,
                                smem, stream>>>(bufs, inj);
  return err;
}

}  // namespace

// Every lane launcher: `host` and `dev` are the same [s] LaneBufs array in
// host and in device memory (see the head of this file); the grid takes
// its shape from host[0] and a scenario coordinate of size s.

extern "C" {

// kernel A: the lanes' groups (slot_group threads a lane), then on runs
// with streams a warp per endpoint row in the instance with the stream arm
int lane_slots(const LaneBufs* host, const LaneBufs* dev, int s,
               cudaStream_t stream) {
  const unsigned lane_blocks =
      blocks_for(host->n * host->slot_group, SLOT_THREADS);
  const int64_t rows = 2 * host->s_flows;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    if (rows > 0) {
      const unsigned blocks = lane_blocks + blocks_for(rows, SLOT_THREADS / 32);
      lane_slots_kernel<true, P><<<dim3(blocks, s), SLOT_THREADS, 0, stream>>>(
          bufs);
    } else {
      lane_slots_kernel<false, P>
          <<<dim3(lane_blocks, s), SLOT_THREADS, 0, stream>>>(bufs);
    }
    return cudaSuccess;
  });
}

// Kernel B: count (its last block scans), place, merge.  The exchange
// scratch (x_cnt, x_fill, x_done) is zero at entry: the workspace starts
// zeroed, each merge block zeroes its lane's words once it has read them
// (H does not touch them), and the scanning block its ticket.  The
// merge takes its narrow or wide form by merge_warp (lanes.merge_in_warp).
int exchange_merge(const LaneBufs* host, const LaneBufs* dev, int s,
                   cudaStream_t stream) {
  const LaneBufs* b = host;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    const int64_t m = b->n_x;
    x_count_kernel<<<dim3(blocks_for(m, COUNT_THREADS), s), COUNT_THREADS, 0,
                     stream>>>(bufs);
    x_place_kernel<<<dim3(blocks_for(m, 256), s), 256, 0, stream>>>(bufs);
    if (b->merge_warp) {
      const dim3 grid(blocks_for(b->n, MERGE_WARPS), s);
      if (b->words == 7) {
        merge_warp_kernel<7, P><<<grid, 32 * MERGE_WARPS, 0, stream>>>(bufs);
      } else {
        merge_warp_kernel<5, P><<<grid, 32 * MERGE_WARPS, 0, stream>>>(bufs);
      }
      return cudaSuccess;
    }
    const int64_t w_all = b->c + b->sw + b->cx;
    const int64_t bytes = (b->words * w_all + sort_width(w_all)) * sizeof(int32_t);
    int smem = 0;
    const cudaError_t err =
        b->words == 7 ? merge_smem(merge_kernel<7, P>, b->merge_global != 0,
                                   bytes, &smem)
                      : merge_smem(merge_kernel<5, P>, b->merge_global != 0,
                                   bytes, &smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(b->n), s);
    if (b->words == 7) {
      merge_kernel<7, P><<<grid, merge_threads(w_all), smem, stream>>>(bufs);
    } else {
      merge_kernel<5, P><<<grid, merge_threads(w_all), smem, stream>>>(bufs);
    }
    return cudaSuccess;
  });
}

// kernel E: a warp a row, SPLIT_ROWS rows a block
int stream_rows_merge(const LaneBufs* host, const LaneBufs* dev, int s,
                      cudaStream_t stream) {
  const LaneBufs* b = host;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    const bool global = b->split_global != 0;
    const int64_t bytes =
        split_row_words(b->c, 2 * b->k + b->k * PUMP_BURST) * sizeof(int32_t);
    const int rows = fit_rows(SPLIT_ROWS, bytes, global);
    int smem = 0;
    const cudaError_t err =
        merge_smem(stream_rows_kernel<P>, global, rows * bytes, &smem);
    if (err != cudaSuccess) return err;
    stream_rows_kernel<<<dim3(blocks_for(2 * b->s_flows, rows), s), 32 * rows,
                         smem, stream>>>(bufs);
    return cudaSuccess;
  });
}

// kernel F: the fill, then the walk: a warp per row, TIER_WARPS rows a
// block, up to TIER_WARP_ROWS rows over the launch's scenarios; a thread per
// row, one warp a block, past that (the rows' serial walks spread over the
// SMs)
int stream_tier(const LaneBufs* host, const LaneBufs* dev, int s,
                cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    const int64_t rows = 2 * host->tier_s;
    if (rows == 0) return cudaSuccess;
    const int64_t n_rec =
        host->log_cap > 0 ? host->rec_ttail - host->rec_tier : 0;
    const int64_t cx0 = 3 * host->ks * rows + host->ks * PUMP_BURST * host->tier_s;
    const unsigned fill =
        std::min(blocks_for(cx0 > 6 * n_rec ? cx0 : 6 * n_rec, 256), 1024u);
    tier_fill_kernel<<<dim3(fill, s), 256, 0, stream>>>(bufs);
    if (rows * s <= TIER_WARP_ROWS) {
      stream_tier_kernel<true, P><<<dim3(blocks_for(rows, TIER_WARPS), s),
                                    32 * TIER_WARPS, 0, stream>>>(bufs);
    } else {
      stream_tier_kernel<false, P><<<dim3(blocks_for(rows, 32), s), 32, 0,
                                     stream>>>(bufs);
    }
    return cudaSuccess;
  });
}

// kernel G: a warp a row, its working memory in shared memory (opted in
// once past 48 KB) or in m_scratch
int tier_merge(const LaneBufs* host, const LaneBufs* dev, int s,
               cudaStream_t stream) {
  const LaneBufs* b = host;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    static int opted = 48 * 1024;  // the dynamic shared memory allowed
    if (b->tier_s == 0) return cudaSuccess;
    const int64_t total = b->c2 + 3 * b->ks + b->ks * PUMP_BURST + b->cx;
    const int smem = b->tier_global ? 0
        : static_cast<int>(tier_row_words(total) * sizeof(int32_t));
    if (smem > opted) {
      const cudaError_t err = cudaFuncSetAttribute(
          tier_merge_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
      opted = smem;
    }
    tier_merge_kernel<<<dim3(static_cast<unsigned>(2 * b->tier_s), s), 32,
                        smem, stream>>>(bufs);
    return cudaSuccess;
  });
}

// kernel C: a cluster of c_blocks blocks per scenario, each scenario with
// its own stop and window
int queue_min_window(const LaneBufs* host, const LaneBufs* dev, int s,
                     int advance, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(host->c_blocks);
  return with_bufs(host, dev, s, [&](auto bufs) {
    static bool ready = false;
    return launch_cluster(queue_min_kernel<decltype(bufs)>, &ready,
                          dim3(blocks, s), HEAD_THREADS, blocks, 0, stream,
                          bufs, advance);
  });
}

// a hybrid turn's step of C: its first step arms the turn (ungated)
int hybrid_window(const LaneBufs* host, const LaneBufs* dev, int s,
                  int first, int ext_hi, int ext_lo, int ext_used,
                  cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(host->c_blocks);
  return with_bufs(host, dev, s, [&](auto bufs) {
    static bool ready = false;
    return launch_cluster(hybrid_window_kernel<decltype(bufs)>, &ready,
                          dim3(blocks, s), HEAD_THREADS, blocks, 0, stream,
                          bufs, first, static_cast<int32_t>(ext_hi),
                          static_cast<int32_t>(ext_lo),
                          static_cast<int32_t>(ext_used));
  });
}

// a fused dispatch's step of C: its first step arms the dispatch (ungated)
int hybrid_fused_window(const LaneBufs* host, const LaneBufs* dev, int s,
                        int first, int k_eff, int ext_used,
                        cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(host->c_blocks);
  return with_bufs(host, dev, s, [&](auto bufs) {
    static bool ready = false;
    return launch_cluster(hybrid_fused_kernel<decltype(bufs)>, &ready,
                          dim3(blocks, s), HEAD_THREADS, blocks, 0, stream,
                          bufs, first, k_eff, static_cast<int32_t>(ext_used));
  });
}

// kernel H over one injection block (inject_launch)
int inject_merge(const LaneBufs* host, const LaneBufs* dev, int s,
                 const int32_t* inj, cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    return host->words == 7
               ? inject_launch<7>(host, bufs, s, inj, stream)
               : inject_launch<5>(host, bufs, s, inj, stream);
  });
}

int append_log(const LaneBufs* host, const LaneBufs* dev, int s,
               cudaStream_t stream) {
  // a cluster of LOG_CLUSTER blocks for each instance that runs: the log,
  // the flowtrace ring, the egress
  const unsigned inst = (host->log_cap > 0 ? 1u : 0u) +
                        (host->flowtrace ? 1u : 0u) +
                        (host->ext_any ? 1u : 0u);
  return with_bufs(host, dev, s, [&](auto bufs) {
    static bool ready = false;
    if (inst == 0) return cudaSuccess;
    return launch_cluster(append_log_kernel<decltype(bufs)>, &ready,
                          dim3(inst * LOG_CLUSTER, s), LOG_THREADS,
                          LOG_CLUSTER, LOG_SMEM, stream, bufs);
  });
}

int smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

int rand_u32(uint32_t seed_lo, uint32_t seed_hi, const uint32_t* stream_words,
             const uint32_t* counter, uint32_t* out, int64_t m,
             cudaStream_t stream) {
  if (m > 0)
    rand_u32_kernel<<<blocks_for(m, 256), 256, 0, stream>>>(
        seed_lo, seed_hi, stream_words, counter, out, m);
  return static_cast<int>(cudaGetLastError());
}

const char* lanes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
