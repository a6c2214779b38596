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
// blockIdx.y (blockIdx.x for the one-block-per-scenario kernels C and the
// exchange scan).  Each kernel is one template over where a block finds its
// scenario's block (`scenario` below): in the kernel's __grid_constant__
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
// The merges (B, E, G) rank a row in one block's shared memory, opted in
// past 48 KB up to the device's sharedMemPerBlockOptin; a row beyond that
// (a size rule the wrapper fixes before the run, lanes.merge_in_shared)
// is ranked in global memory instead, in the workspace's m_scratch, by the
// same code.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEVER32 = 0x7FFFFFFF;
constexpr int64_t NEVER64 = 0x7FFFFFFFFFFFFFFFLL;
constexpr int64_t MASK31 = 0x7FFFFFFFLL;
constexpr int32_t CD_UNSET = -2147483647;  // -(1 << 31) + 1

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
  int32_t *rec_valid, *x_cnt, *x_start, *x_fill, *x_order, *tier_blk;
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
};

// Up to PARAM_SCENARIOS blocks side by side, passed as one kernel parameter
// (8 x 1,496 bytes; Hopper takes up to 32,764).
constexpr int PARAM_SCENARIOS = 8;
struct ParamBufs {
  LaneBufs b[PARAM_SCENARIOS];
};

namespace {

// A block's scenario, by the kernel's parameter: one LaneBufs (S = 1), a
// ParamBufs (S <= 8) or the [S] array in device memory.  From the parameter
// a field is read from the constant bank where it is used; through the
// array it is a load whose value the compiler keeps in a register (kernel
// A: 159 registers at S = 1, 168 at S <= 8, 246 past that).
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

// The law and the sends of one stimulus at an endpoint row, shared by A's
// stream arm and F's walk: stim 1 opens a client flow, 2 fires the RTO, 3
// runs on_segment on the event's payload words, at `now` (= t); the pump
// burst follows.  The control send and the burst charge `sl.up` in order
// (the burst after its first unit by the chained law), each drawing its
// loss at counter = its send sequence number; the RTO arm takes the local
// sequence.  Burst unit u goes to burst(u, valid, lost, dep, arr, seq, size,
// phi, plo, retx); the control send and the arm are returned.  Every charge and
// every byte sent is counted into sl.nb_thr and sl.nb_txb.
template <class BurstSink>
__device__ __forceinline__ Sends stream_stimulus(
    const LaneBufs& b, Flow& f, int stim, Pair now, int64_t t, int32_t phi,
    int32_t plo, int32_t size, int64_t we, const UpRow& r, StreamLane sl,
    BurstSink burst) {
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
  const uint32_t seed_lo = static_cast<uint32_t>(b.seed_lo);
  const uint32_t seed_hi = static_cast<uint32_t>(b.seed_hi);
  const uint32_t stream = static_cast<uint32_t>(r.lane) | LOSS_STREAM;
  // the control send: up bucket, loss draw, arrival
  s.seq = sl.send_seq;
  if (s.em.send_valid) {
    const int64_t dep =
        bucket_charge(sl.up, r.rate, r.burst, r.kfull, r.kfi, t,
                      (s.em.send_size + FRAME_OVERHEAD_BYTES) * 8, true,
                      interval, sl.nb_thr);
    sl.nb_txb = wadd(sl.nb_txb, s.em.send_size);
    s.dep = dep;
    if (draw) {
      const uint32_t u = lane_draw(seed_lo, seed_hi, stream,
                                   static_cast<uint32_t>(s.seq));
      s.lost = static_cast<int64_t>(u) < r.thresh;
    }
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
    bool lost = false;
    if (draw) {
      const uint32_t d = lane_draw(seed_lo, seed_hi, stream,
                                   static_cast<uint32_t>(bseq));
      lost = static_cast<int64_t>(d) < r.thresh;
    }
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
// tier and compacted channels): the lane's endpoint row that this popped
// event stimulates — a start marker opens a client flow, an RTO local owned
// by the row's flow fires its timer, a stream segment (non-zero payload; at
// a server row only from its own client) runs on_segment — takes
// stream_stimulus on the lane's up bucket and counters.  Every entry of the
// stream block and every stream loss record (and with stream_pcap every
// capture record, with flowtrace every flow record flag of the control-send
// and burst groups) of the lane's rows for slot j is written, valid or not.
__device__ void stream_slot(const LaneBufs& b, int64_t i, int64_t j, bool act,
                            int32_t kind, int32_t src, int32_t size,
                            int32_t phi, int32_t plo, int32_t thi,
                            int32_t tlo, int64_t we, StreamLane sl) {
  const int32_t r0 = b.lane_ep_start[i], r1 = b.lane_ep_start[i + 1];
  if (r0 == r1) return;  // no flow endpoint on this lane
  const int64_t sf = b.s_flows, s2 = 2 * sf, k = b.k;
  const int64_t n_ent = 4 * k * sf + k * PUMP_BURST * sf;
  const int32_t lane = static_cast<int32_t>(i);
  const int64_t t = join_raw(thi, tlo);
  const bool ft = b.flowtrace != 0;
  const int64_t gw_s = k * s2, gw_b = k * PUMP_BURST * sf;  // flow groups

  // the stimulated row (at most one per lane and slot)
  int32_t e = -1, stim = 0;  // 1 open, 2 RTO, 3 segment
  for (int32_t r = r0; act && r < r1 && e < 0; ++r) {
    const int32_t row = b.lane_ep_rows[r];
    const bool cl = row < sf;
    if (kind == LOCAL && size == -1 && cl) {
      e = row, stim = 1;
    } else if (kind == LOCAL && size == SZ_RTO && plo == b.flow_clid[row]) {
      e = row, stim = 2;
    } else if (kind == DELIVERY && (phi | plo) != 0 &&
               (cl || src == b.flow_clid[row])) {
      e = row, stim = 3;
    }
  }

  Sends sd;
  if (e >= 0) {
    int32_t* frow = b.stream + static_cast<int64_t>(e) * N_COLS;
    Flow f;
    flow_load(f, frow);
    f.role = e < sf ? SENDER : RECEIVER;
    f.segs = b.flow_segs[e];
    f.mss = b.flow_mss[e];
    f.last_bytes = b.flow_last[e];
    f.cc = b.flow_cc[e];
    const int32_t peer = b.flow_peers[e];
    const int32_t pkt_auxh = (PACKET << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
    const bool capture = b.flow_pcap[e] != 0;
    const bool smp = ft && flow_sampled(b, lane, peer);
    sd = stream_stimulus(
        b, f, stim, Pair{thi, tlo}, t, phi, plo, size, we, up_row(b, e), sl,
        [&](int32_t u, bool valid, bool lost, int64_t dep, int64_t arr,
            int32_t bseq, int32_t bsize, int32_t bphi, int32_t bplo,
            bool retx) {
          const int64_t slot = j * PUMP_BURST + u;
          put_entry(b, n_ent, 4 * k * sf + slot * sf + e, valid, peer, arr,
                    pkt_auxh, bseq, bsize, bphi, bplo);
          put_loss(b, b.rec_brec + slot * sf + e, lost, t, lane, peer, bseq,
                   bsize);
          if (b.stream_pcap)
            put_rec(b, b.rec_bpc + slot * sf + e, capture, dep, lane, peer,
                    bseq, bsize, PCAP_TX);
          if (ft)
            send_flows(b, b.fl_bs + slot * sf + e, gw_b, smp, lost, t, dep,
                       arr, retx ? FT_RETRANSMIT : FT_SEND, lane, peer, bseq,
                       bsize);
        });
    flow_store(f, frow);
  }
  const Emit& em = sd.em;
  const int32_t cnt = sd.cnt;

  // the lane's rows: control sends, RTO arms, the rest of the bursts, and
  // the control sends' loss records
  for (int32_t r = r0; r < r1; ++r) {
    const int32_t row = b.lane_ep_rows[r];
    const bool me = row == e;
    const int32_t peer = b.flow_peers[row];
    const int32_t auxh_pkt = (PACKET << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
    const int32_t auxh_loc = (LOCAL << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
    const bool se_v = me && em.send_valid;
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
    const bool sa_v = me && em.rto_valid;
    put_entry(b, n_ent, k * s2 + j * s2 + row, sa_v, lane,
              join_raw(em.rto_t.hi, em.rto_t.lo), auxh_loc, sd.lseq, SZ_RTO,
              0, b.flow_clid[row]);
    if (row < sf) {
      for (int32_t u = me ? cnt : 0; u < PUMP_BURST; ++u) {
        const int64_t slot = j * PUMP_BURST + u;
        put_entry(b, n_ent, 4 * k * sf + slot * sf + row, false, 0, 0, 0, 0,
                  0, 0, 0);
        put_loss(b, b.rec_brec + slot * sf + row, false, 0, 0, 0, 0, 0);
        if (b.stream_pcap)
          put_rec(b, b.rec_bpc + slot * sf + row, false, 0, 0, 0, 0, 0, 0);
        if (ft)
          send_flows(b, b.fl_bs + slot * sf + row, gw_b, false, false, 0, 0,
                     0, 0, 0, 0, 0, 0);
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
// One thread per lane walks its first K queue columns in registers: the
// co-pop rule, then the slot law on each popped column — down bucket +
// CoDel for PACKET pops, delivered inline on passive lanes or as a DELIVERY
// self-insert on active ones; the app sends (tgen ticks, phold hops to a
// threefry peer, ping requests and echoes) with the up bucket, the latency
// gather and the threefry loss draw, and with pcap a capturing lane's
// PCAP_TX record at the send's departure; the timer re-arms; and on stream
// lanes the stream arm (stream_slot), whose endpoint rows the thread owns.
// With netobs the lane's byte and throttle counters follow every charge, and
// the block's popped PACKETs join the window's count (one atomic a block).
// With flowtrace each slot writes the flags of its seven [N] flow groups —
// the send, its up-bucket wait, loss and queue entry; the arrival's
// down-bucket wait, CoDel drop or delivery — and the records of the
// sampled flows.  Returns the lane's popped PACKETs.
__device__ int32_t lane_slots_lane(const LaneBufs& b, int64_t i) {
  const int64_t n = b.n;
  const int64_t c = b.c, k = b.k, sw = b.sw;
  const bool streams = b.s_flows > 0;
  const int32_t interval = static_cast<int32_t>(b.interval);
  const int64_t we = join_raw(*b.now_we_hi, *b.now_we_lo);
  const int32_t lane = static_cast<int32_t>(i);
  const bool all_passive = b.all_passive != 0;
  const bool has_loss = b.has_loss != 0;
  const bool dyn = b.dyn_runahead != 0;
  const uint32_t seed_lo = static_cast<uint32_t>(b.seed_lo);
  const uint32_t seed_hi = static_cast<uint32_t>(b.seed_hi);

  Bucket dn{b.dn_tokens[i], join_raw(b.dn_nr_hi[i], b.dn_nr_lo[i]),
            join_raw(b.dn_ld_hi[i], b.dn_ld_lo[i])};
  Bucket up{b.up_tokens[i], join_raw(b.up_nr_hi[i], b.up_nr_lo[i]),
            join_raw(b.up_ld_hi[i], b.up_ld_lo[i])};
  int32_t fat_hi = b.cd_fat_hi[i], fat_lo = b.cd_fat_lo[i];
  int64_t cd_dn = join_raw(b.cd_dnext_hi[i], b.cd_dnext_lo[i]);
  int32_t dcount = b.cd_drop_count[i];
  uint8_t dropping = b.cd_dropping[i];
  int32_t send_seq = b.send_seq[i], local_seq = b.local_seq[i];
  int32_t app_draws = b.app_draws[i];
  int32_t m_sent = b.m_sent[i], peer_off = b.m_peer_offset[i];
  int32_t n_del = b.n_delivered[i], n_codel = b.n_codel[i];
  int32_t n_loss = b.n_loss[i], n_hops = b.n_hops[i];
  int32_t recv = b.recv_bytes[i], n_sends = b.n_sends[i];
  int32_t min_lat = NEVER32;
  int32_t nb_txb = 0, nb_rxb = 0, nb_thr = 0, pkts = 0;
  if (b.netobs) {
    nb_txb = b.nb_txb[i];
    nb_rxb = b.nb_rxb[i];
    nb_thr = b.nb_thr[i];
  }
  const bool capture = b.pcap && b.lane_pcap[i] != 0;

  const int32_t model = b.model[i];
  const bool passive = model == M_NONE || model == M_TGEN_MESH ||
                       model == M_TGEN_CLIENT || model == M_TGEN_SERVER;
  // hybrid: an external lane's packets neither deliver inline nor insert;
  // their outcomes go to the egress candidates
  const bool ext = b.ext_any && b.lane_external[i] != 0;
  const int32_t recv_mult = b.recv_mult[i];
  const int32_t p_size = b.p_size[i];
  const int32_t p_count = b.p_count[i];
  const int64_t p_int = join_raw(b.p_int_hi[i], b.p_int_lo[i]);
  const int32_t my_node = b.node_of[i];
  const bool mesh = model == M_TGEN_MESH, client = model == M_TGEN_CLIENT;
  const bool phold = model == M_PHOLD;
  const bool ping_cl = model == M_PING_CLIENT;
  const bool ping_sv = model == M_PING_SERVER;
  const bool stream_lane = model == M_STREAM_CLIENT || model == M_STREAM_SERVER;
  const int32_t lane_pkt_auxh = (PACKET << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  const int32_t lane_loc_auxh = (LOCAL << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  const int64_t rec_base = b.rec_slots;
  const int64_t nk = n * k, nsw = n * sw;
  const int64_t arm0 = all_passive ? 0 : k;  // first re-arm column

  // co-pop rule: passive lanes pop any prefix inside the window; active
  // lanes only a same-instant prefix of PACKETs, or column 0 alone; with
  // the wide rule, stream lanes also a prefix free of LOCALs (one-to-one)
  // or a PACKET-only or DELIVERY-only prefix (star)
  const int32_t head_hi = b.q_thi[i * c], head_lo = b.q_tlo[i * c];
  bool pkt_prefix = true, no_local_prefix = true, del_prefix = true;
  const bool wide = b.wide_pop && stream_lane;

  for (int64_t j = 0; j < k; ++j) {
    const int64_t qi = i * c + j;
    const int32_t thi = b.q_thi[qi], tlo = b.q_tlo[qi];
    const int64_t t = join_t(thi, tlo);
    const int32_t auxh = b.q_auxh[qi], seq = b.q_auxl[qi], size = b.q_size[qi];
    const int32_t kind = auxh >> AUX_KIND_SHIFT;
    const int32_t src = (auxh >> AUX_SRC_SHIFT) & SRC_MASK;
    bool allowed = true;
    if (!all_passive && !passive) {
      pkt_prefix = pkt_prefix && kind == PACKET;
      no_local_prefix = no_local_prefix && kind != LOCAL;
      del_prefix = del_prefix && kind == DELIVERY;
      allowed = j == 0 || (thi == head_hi && tlo == head_lo && pkt_prefix);
      if (wide)
        allowed = allowed || (b.one_to_one ? no_local_prefix
                                           : (pkt_prefix || del_prefix));
    }
    const bool act = allowed && t < we;
    if (act) {
      b.q_thi[qi] = NEVER32;
      b.q_tlo[qi] = NEVER32;
    }

    // PACKET: down bucket, CoDel
    const bool is_pkt = act && kind == PACKET;
    const int64_t td = bucket_charge(dn, b.dn_rate[i], b.dn_burst[i],
                                     b.dn_kfull[i], b.dn_kfi[i], t,
                                     (size + FRAME_OVERHEAD_BYTES) * 8, is_pkt,
                                     interval, nb_thr);
    if (is_pkt) pkts += 1;
    int64_t sojourn = 0;
    if (is_pkt) {
      sojourn = td - t;
      if (sojourn > NEVER32) sojourn = NEVER32;
    }
    const bool drop = codel_offer(fat_hi, fat_lo, cd_dn, dcount, dropping, td,
                                  sojourn, is_pkt, b.codel_div);
    const bool deliver = is_pkt && !drop;
    if (is_pkt && drop) n_codel += 1;
    if (deliver) {
      n_del += 1;
      nb_rxb = wadd(nb_rxb, size);
    }
    // passive lanes count inline; active lanes get a DELIVERY self-insert
    // keyed by the packet's (src, seq); external lanes egress (CoDel drops
    // too), slot-major as the reference appends
    if (deliver && passive && !ext) recv += size * recv_mult;
    if (b.ext_any) {
      const int64_t r = j * n + i;
      const bool eg = is_pkt && ext;
      int64_t* row = b.eg_recs + r * 6;
      row[0] = eg ? td : 0;
      row[1] = eg ? src : 0;
      row[2] = eg ? lane : 0;
      row[3] = eg ? seq : 0;
      row[4] = eg ? size : 0;
      row[5] = eg ? (drop ? DROP_CODEL : DELIVERED) : 0;
      b.eg_valid[r] = eg ? 1 : 0;
    }
    if (!all_passive) {
      const int64_t si = i * sw + j;
      const bool ins = deliver && !passive && !ext;
      int32_t ins_hi = NEVER32, ins_lo = NEVER32;
      if (ins) split(td, &ins_hi, &ins_lo);
      b.self_blk[0 * nsw + si] = ins_hi;
      b.self_blk[1 * nsw + si] = ins_lo;
      b.self_blk[2 * nsw + si] =
          ins ? (DELIVERY << AUX_KIND_SHIFT) | (src << AUX_SRC_SHIFT) : 0;
      b.self_blk[3 * nsw + si] = ins ? seq : 0;
      b.self_blk[4 * nsw + si] = ins ? size : 0;
      if (streams) {  // stream segments keep their payload words
        b.self_blk[5 * nsw + si] = ins ? b.q_phi[qi] : 0;
        b.self_blk[6 * nsw + si] = ins ? b.q_plo[qi] : 0;
      }
    }

    // DELIVERY: phold sends on, the ping server echoes
    const bool is_del = act && kind == DELIVERY;
    const bool del_send_phold = is_del && phold;
    const bool del_send_echo = is_del && ping_sv;
    if (del_send_phold) n_hops += 1;

    // LOCAL: start markers, anchors, timer ticks (phold's initial messages
    // are size-0 timers that send)
    const bool is_loc = act && kind == LOCAL;
    const bool is_start = is_loc && size == -1;
    const bool is_timer = is_loc && size >= 0;
    const bool mesh_tick = is_timer && mesh && n > 1;
    const bool client_tick = is_timer && client;
    const bool ping_tick = is_timer && ping_cl && m_sent < p_count;
    const bool send_phold = del_send_phold || (is_timer && phold);
    const bool do_send =
        send_phold || del_send_echo || mesh_tick || client_tick || ping_tick;

    const int32_t nm1 = n > 1 ? static_cast<int32_t>(n - 1) : 1;
    int32_t off = peer_off % nm1;
    if (off < 0) off += nm1;  // floor modulo, as the reference's %
    int32_t dst = b.p_peer[i];
    if (send_phold) {
      // phold peer: an APP_STREAM draw at counter app_draws
      if (n == 1) {
        dst = lane;
      } else {
        const uint32_t u = lane_draw(seed_lo, seed_hi,
                                     static_cast<uint32_t>(lane) | APP_STREAM,
                                     static_cast<uint32_t>(app_draws));
        const int64_t r = static_cast<int64_t>(
            (static_cast<uint64_t>(u) * static_cast<uint64_t>(nm1)) >> 32);
        dst = static_cast<int32_t>((i + 1 + r) % n);
      }
      app_draws += 1;
    } else if (del_send_echo) {
      dst = src;
    } else if (mesh_tick) {
      dst = static_cast<int32_t>((i + 1 + off) % n);
    }
    if (mesh_tick) peer_off += b.p_stride[i];
    if (client_tick || ping_tick) m_sent += 1;
    const int32_t out_size = del_send_echo ? size : p_size;
    const int32_t snd_seq = send_seq;
    if (do_send) {
      send_seq += 1;
      n_sends += 1;
    }
    const int64_t dep = bucket_charge(up, b.up_rate[i], b.up_burst[i],
                                      b.up_kfull[i], b.up_kfi[i], t,
                                      (out_size + FRAME_OVERHEAD_BYTES) * 8,
                                      do_send, interval, nb_thr);
    if (do_send) nb_txb = wadd(nb_txb, out_size);

    // timer re-arm
    const bool rearm = (is_start && (mesh || client || ping_cl)) || mesh_tick ||
                       client_tick || ping_tick || (is_timer && mesh && n == 1);
    const int64_t ai = i * sw + arm0 + j;
    int32_t arm_hi = NEVER32, arm_lo = NEVER32;
    if (rearm) split(t + p_int, &arm_hi, &arm_lo);
    b.self_blk[0 * nsw + ai] = arm_hi;
    b.self_blk[1 * nsw + ai] = arm_lo;
    b.self_blk[2 * nsw + ai] = lane_loc_auxh;
    b.self_blk[3 * nsw + ai] = local_seq;
    b.self_blk[4 * nsw + ai] = 0;
    if (streams) {
      b.self_blk[5 * nsw + ai] = 0;
      b.self_blk[6 * nsw + ai] = 0;
    }
    if (rearm) local_seq += 1;

    // outbound packet: arrival = max(depart + latency, window end), unless
    // the LOSS_STREAM draw at counter snd_seq loses it (never before
    // bootstrap_end)
    const int64_t oi = j * n + i;
    bool lost = false;
    int64_t arr = 0;
    if (do_send) {
      const int64_t pair = static_cast<int64_t>(my_node) * b.g + b.node_of[dst];
      const int32_t lat = b.lat[pair];
      if (dyn) min_lat = lat < min_lat ? lat : min_lat;
      if (has_loss && t >= b.bootstrap_end) {
        const uint32_t u = lane_draw(seed_lo, seed_hi,
                                     static_cast<uint32_t>(lane) | LOSS_STREAM,
                                     static_cast<uint32_t>(snd_seq));
        lost = static_cast<int64_t>(u) < b.thresh[pair];
      }
      if (lost) n_loss += 1;
      arr = dep + lat;
      if (arr < we) arr = we;
      int32_t a_hi, a_lo;
      split(arr, &a_hi, &a_lo);
      b.out_blk[0 * nk + oi] = lost ? static_cast<int32_t>(n) : dst;
      b.out_blk[1 * nk + oi] = lost ? NEVER32 : a_hi;
      b.out_blk[2 * nk + oi] = lost ? NEVER32 : a_lo;
      b.out_blk[3 * nk + oi] = lost ? 0 : lane_pkt_auxh;
      b.out_blk[4 * nk + oi] = lost ? 0 : snd_seq;
      b.out_blk[5 * nk + oi] = lost ? 0 : out_size;
    } else {
      b.out_blk[0 * nk + oi] = static_cast<int32_t>(n);
      b.out_blk[1 * nk + oi] = NEVER32;
      b.out_blk[2 * nk + oi] = NEVER32;
      b.out_blk[3 * nk + oi] = 0;
      b.out_blk[4 * nk + oi] = 0;
      b.out_blk[5 * nk + oi] = 0;
    }

    // one record: the popped packet's outcome, or the send's loss
    if (b.log_cap > 0) {
      const int64_t r = rec_base + oi;
      int64_t* row = b.recs + r * 6;
      if (is_pkt) {
        row[0] = td;
        row[1] = src;
        row[2] = lane;
        row[3] = seq;
        row[4] = size;
        row[5] = drop ? DROP_CODEL : DELIVERED;
      } else if (lost) {
        row[0] = t;
        row[1] = lane;
        row[2] = dst;
        row[3] = snd_seq;
        row[4] = out_size;
        row[5] = DROP_LOSS;
      } else {
        for (int w = 0; w < 6; ++w) row[w] = 0;
      }
      b.rec_valid[r] = (is_pkt || lost) ? 1 : 0;
    }
    // the send's capture, at its departure and before the loss draw
    if (b.pcap)
      put_rec(b, b.rec_pc + oi, do_send && capture, dep, lane, dst, snd_seq,
              out_size, PCAP_TX);
    // the slot's flow groups: the send (lane -> dst), the arrival (src ->
    // lane) at the down bucket's departure
    if (b.flowtrace) {
      const int64_t r = b.fl_slots + oi;
      send_flows(b, r, nk, do_send && flow_sampled(b, lane, dst), lost, t,
                 dep, arr, FT_SEND, lane, dst, snd_seq, out_size);
      const bool ar = is_pkt && flow_sampled(b, src, lane);
      put_flow(b, r + 4 * nk, ar && td != t, td, FT_TB_WAIT, src, lane, seq,
               size, TB_DN);
      put_flow(b, r + 5 * nk, ar && drop, td, FT_DROP, src, lane, seq, size,
               CAUSE_CODEL);
      put_flow(b, r + 6 * nk, ar && !drop, td, FT_DELIVERY, src, lane, seq,
               size, 0);
    }

    if (streams)
      stream_slot(b, i, j, act, kind, src, size,
                  act ? b.q_phi[qi] : 0, act ? b.q_plo[qi] : 0, thi, tlo, we,
                  StreamLane{up, send_seq, local_seq, n_sends, n_loss,
                             min_lat, nb_txb, nb_thr});
  }

  b.dn_tokens[i] = dn.tokens;
  split(dn.nr, &b.dn_nr_hi[i], &b.dn_nr_lo[i]);
  split(dn.ld, &b.dn_ld_hi[i], &b.dn_ld_lo[i]);
  b.up_tokens[i] = up.tokens;
  split(up.nr, &b.up_nr_hi[i], &b.up_nr_lo[i]);
  split(up.ld, &b.up_ld_hi[i], &b.up_ld_lo[i]);
  b.cd_fat_hi[i] = fat_hi;
  b.cd_fat_lo[i] = fat_lo;
  split(cd_dn, &b.cd_dnext_hi[i], &b.cd_dnext_lo[i]);
  b.cd_drop_count[i] = dcount;
  b.cd_dropping[i] = dropping;
  b.send_seq[i] = send_seq;
  b.local_seq[i] = local_seq;
  b.m_sent[i] = m_sent;
  b.m_peer_offset[i] = peer_off;
  b.n_delivered[i] = n_del;
  b.n_codel[i] = n_codel;
  b.recv_bytes[i] = recv;
  b.n_sends[i] = n_sends;
  b.app_draws[i] = app_draws;
  b.n_loss[i] = n_loss;
  b.n_hops[i] = n_hops;
  if (b.netobs) {
    b.nb_txb[i] = nb_txb;
    b.nb_rxb[i] = nb_rxb;
    b.nb_thr[i] = nb_thr;
  }
  // the smallest latency sent over (exact: min is order-free)
  if (min_lat < NEVER32) atomicMin(b.min_used_lat, min_lat);
  return pkts;
}

template <class P>
__global__ void lane_slots_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int32_t pkts = i < b.n ? lane_slots_lane(b, i) : 0;
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

template <class P>
__global__ void x_count_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m >= b.n_x) return;
  const int32_t d = x_dst(b, m);
  if (d < b.n) atomicAdd(&b.x_cnt[d], 1);
}

// exclusive scan of x_cnt into x_start: one block, contiguous chunks (gated
// on live in B; not in H, which runs before a hybrid turn arms it)
template <class P, bool GATED = true>
__global__ void x_scan_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.x);
  if (GATED && b.ctl[0] == 0) return;
  __shared__ int32_t part[1024];
  const int64_t n = b.n;
  const int64_t chunk = (n + blockDim.x - 1) / blockDim.x;
  const int64_t lo = threadIdx.x * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  int32_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += b.x_cnt[i];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (unsigned s = 1; s < blockDim.x; s <<= 1) {  // Hillis-Steele
    const int32_t v = threadIdx.x >= s ? part[threadIdx.x - s] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int32_t run = part[threadIdx.x] - sum;
  for (int64_t i = lo; i < hi; ++i) {
    b.x_start[i] = run;
    run += b.x_cnt[i];
  }
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

// The rank of entry x among the n entries of W words at e, by the event
// key, ties by index: a permutation, stable for equal keys.  The entry's
// key stays in registers; an entry ranks below it when its key is smaller,
// or equal at a smaller index.
template <int W>
__device__ __forceinline__ int64_t key_rank(const int32_t* e, int64_t n,
                                            int64_t x) {
  const int32_t* ex = e + W * x;
  const int32_t k0 = ex[0], k1 = ex[1], k2 = ex[2], k3 = ex[3];
  int64_t rank = 0;
  for (int64_t y = 0; y < n; ++y) {
    const int32_t* ey = e + W * y;
    const int32_t a0 = ey[0], a1 = ey[1], a2 = ey[2], a3 = ey[3];
    const bool less = a0 != k0   ? a0 < k0
                      : a1 != k1 ? a1 < k1
                      : a2 != k2 ? a2 < k2
                                 : a3 < k3;
    const bool same = a0 == k0 && a1 == k1 && a2 == k2 && a3 == k3;
    if (less || (same && y < x)) ++rank;
  }
  return rank;
}

// The keyed row merge, shared by kernels B, E and H: rank each of the w_all
// entries at e — shared memory, or the row's m_scratch (key_rank) — write
// the first C to the queue row of `lane`, count the real events past C into
// *n_tail and, when logging, record them as DROP_QUEUE at recs[rec_base +
// rank - C]; with flowtrace, the flag of every flow slot fl_base + rank - C
// and, for the PACKETs of sampled flows among them, an FT_DROP
// (CAUSE_QUEUE) record at their pair times.  REC off (H): no record.
template <int W, bool REC = true>
__device__ __forceinline__ void merge_row(const LaneBufs& b, const int32_t* e,
                                          int64_t w_all, int64_t lane,
                                          int64_t rec_base, int64_t fl_base,
                                          int32_t* n_tail) {
  int32_t* const q[7] = {b.q_thi, b.q_tlo, b.q_auxh, b.q_auxl, b.q_size,
                         b.q_phi, b.q_plo};
  const int64_t c = b.c;
  int32_t local_tail = 0;
  for (int64_t x = threadIdx.x; x < w_all; x += blockDim.x) {
    const int32_t* ex = e + W * x;
    const int64_t rank = key_rank<W>(e, w_all, x);
    if (rank < c) {
#pragma unroll
      for (int w = 0; w < W; ++w) q[w][lane * c + rank] = ex[w];
    } else {
      const bool valid = ex[0] != NEVER32;
      if (valid) ++local_tail;
      if (REC && b.log_cap > 0) {
        const int64_t r = rec_base + (rank - c);
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
        put_flow(b, fl_base + (rank - c),
                 valid && (ex[2] >> AUX_KIND_SHIFT) == PACKET &&
                     flow_sampled(b, src, dst),
                 join_raw(ex[0], ex[1]), FT_DROP, src, dst, ex[3], ex[4],
                 CAUSE_QUEUE);
      }
    }
  }
  if (local_tail) atomicAdd(n_tail, local_tail);
}

// the row: C + S + Cx entries x W words + Cx selected entry indices, in
// dynamic shared memory or (merge_global) the block's part of m_scratch
template <int W, class P>
__global__ void merge_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  extern __shared__ int32_t sm[];
  const int64_t i = blockIdx.x;
  const int64_t n = b.n, c = b.c, k = b.k, cx = b.cx, sw = b.sw;
  const int64_t w_all = c + sw + cx, tail = sw + cx, nk = n * k, nsw = n * sw;
  const int64_t n_ent = stream_entries(b);
  int32_t* const row = b.merge_global ? b.m_scratch + i * (W * w_all + cx) : sm;
  int32_t* e = row;                  // [C + S + Cx][W]
  int32_t* sel = row + W * w_all;    // [Cx]
  __shared__ int32_t n_tail;

  const int32_t cnt = b.x_cnt[i];
  const int32_t take = cnt < cx ? cnt : static_cast<int32_t>(cx);
  const int32_t* seg = b.x_order + b.x_start[i];
  // tiered: the endpoint row this lane's cross entries divert to
  int64_t tier_row = -1;
  if (b.tier_s > 0 && b.lane_stream[i])
    tier_row = b.lane_ep_rows[b.lane_ep_start[i]];
  if (threadIdx.x == 0) {
    n_tail = 0;
    if (cnt <= cx) {
      // the whole group fits: which slot each entry takes does not change
      // the merged row (valid entries have distinct keys; empty ones are
      // identical)
      for (int32_t r = 0; r < cnt; ++r) sel[r] = seg[r];
      if (tier_row >= 0) {
        // but the divert hands the block on as it is: index order, as the
        // plain version's (the atomic placement's order is arbitrary)
        for (int32_t r = 1; r < cnt; ++r) {
          const int32_t m = sel[r];
          int32_t q = r;
          for (; q > 0 && sel[q - 1] > m; --q) sel[q] = sel[q - 1];
          sel[q] = m;
        }
      }
    } else {
      // overflow: keep the Cx earliest in index order
      int32_t prev = -1;
      for (int32_t r = 0; r < take; ++r) {
        int32_t best = 0x7FFFFFFF;
        for (int32_t q = 0; q < cnt; ++q) {
          const int32_t m = seg[q];
          if (m > prev && m < best) best = m;
        }
        sel[r] = best;
        prev = best;
      }
    }
  }
  load_queue_row<W>(b, e, i);
  __syncthreads();

  for (int64_t x = c + threadIdx.x; x < w_all; x += blockDim.x) {
    int32_t* ex = e + W * x;
    if (x < c + sw) {
      const int64_t si = i * sw + (x - c);
#pragma unroll
      for (int w = 0; w < W; ++w) ex[w] = b.self_blk[w * nsw + si];
    } else {
      const int64_t r = x - c - sw;
      if (r < take) {
        const int64_t m = sel[r];
        if (m < nk) {  // an outbound packet: no payload
#pragma unroll
          for (int w = 0; w < 5; ++w) ex[w] = b.out_blk[(w + 1) * nk + m];
#pragma unroll
          for (int w = 5; w < W; ++w) ex[w] = 0;
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w)
            ex[w] = b.sx_blk[(w + 1) * n_ent + (m - nk)];
        }
      } else {
        ex[0] = NEVER32;
        ex[1] = NEVER32;
#pragma unroll
        for (int w = 2; w < W; ++w) ex[w] = 0;
      }
      if (tier_row >= 0) {  // the divert
        int32_t* t = b.tier_blk + tier_layout(b).cx + tier_row * cx + r;
#pragma unroll
        for (int w = 0; w < 5; ++w) t[w * b.tier_n] = ex[w];
        t[5 * b.tier_n] = 0;
        t[6 * b.tier_n] = 0;
        ex[0] = NEVER32;
        ex[1] = NEVER32;
      }
    }
  }
  __syncthreads();
  merge_row<W>(b, e, w_all, i, i * tail, i * tail, &n_tail);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t lost_pre = cnt > cx ? cnt - static_cast<int32_t>(cx) : 0;
    b.n_queue[i] += n_tail + lost_pre;
    if (b.netobs) b.nb_shed[i] += lost_pre;  // the cross sheds, apart
    if (i == 0) *b.iters += 1;
  }
}

// ---- kernel H: inject_merge -------------------------------------------------
// One host-staged injection block ([INJ_WORDS, B] int32: valid, dst, thi,
// tlo, auxh, auxl, size) into the lane queues: B's counting sort groups the
// valid rows by destination (count, the ungated scan, place), then one
// block per lane ranks its group by (time, aux, index), keeps the first
// Cxi as the cross entries of its [queue C | injected Cxi] row (the
// payload words of stream configs zero) and merges the row with B's keyed
// merge, without records; the rest of the group and the tail past C count
// into n_queue (the sheds into nb_shed too, with netobs).  Not gated on
// live: the host launches it only with rows to inject, before the turn's
// first step arms the turn.
constexpr int INJ_WORDS = 7;

template <class P>
__global__ void inj_count_kernel(const __grid_constant__ P bufs,
                                 const int32_t* inj) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m >= b.inj_b || inj[m] == 0) return;
  atomicAdd(&b.x_cnt[inj[b.inj_b + m]], 1);
}

template <class P>
__global__ void inj_place_kernel(const __grid_constant__ P bufs,
                                 const int32_t* inj) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m >= b.inj_b || inj[m] == 0) return;
  const int32_t d = inj[b.inj_b + m];
  const int32_t pos = b.x_start[d] + atomicAdd(&b.x_fill[d], 1);
  b.x_order[pos] = static_cast<int32_t>(m);
}

// the row: C + Cxi entries x W words, in dynamic shared memory or
// (inject_global) the block's part of m_scratch
template <int W, class P>
__global__ void inject_merge_kernel(const __grid_constant__ P bufs,
                                    const int32_t* inj) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  extern __shared__ int32_t sm[];
  const int64_t i = blockIdx.x;
  const int64_t c = b.c, cxi = b.cxi, w_all = c + cxi, nb = b.inj_b;
  int32_t* const e = b.inject_global ? b.m_scratch + i * W * w_all : sm;
  __shared__ int32_t n_tail;
  const int32_t cnt = b.x_cnt[i];
  const int32_t* seg = b.x_order + b.x_start[i];
  if (threadIdx.x == 0) n_tail = 0;
  load_queue_row<W>(b, e, i);
  for (int64_t x = c + threadIdx.x; x < w_all; x += blockDim.x) {
    int32_t* ex = e + W * x;
    ex[0] = NEVER32;
    ex[1] = NEVER32;
#pragma unroll
    for (int w = 2; w < W; ++w) ex[w] = 0;
  }
  __syncthreads();
  // the group's rank by (time, aux, index): the first Cxi take the slots
  for (int32_t r = threadIdx.x; r < cnt; r += blockDim.x) {
    const int32_t m = seg[r];
    const int32_t k0 = inj[2 * nb + m], k1 = inj[3 * nb + m];
    const int32_t k2 = inj[4 * nb + m], k3 = inj[5 * nb + m];
    int64_t rank = 0;
    for (int32_t q = 0; q < cnt; ++q) {
      const int32_t y = seg[q];
      const int32_t a0 = inj[2 * nb + y], a1 = inj[3 * nb + y];
      const int32_t a2 = inj[4 * nb + y], a3 = inj[5 * nb + y];
      const bool less = a0 != k0   ? a0 < k0
                        : a1 != k1 ? a1 < k1
                        : a2 != k2 ? a2 < k2
                        : a3 != k3 ? a3 < k3
                                   : y < m;
      if (less) ++rank;
    }
    if (rank < cxi) {
      int32_t* ex = e + W * (c + rank);
      ex[0] = k0;
      ex[1] = k1;
      ex[2] = k2;
      ex[3] = k3;
      ex[4] = inj[6 * nb + m];
    }
  }
  __syncthreads();
  merge_row<W, false>(b, e, w_all, i, 0, 0, &n_tail);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t lost_pre = cnt > cxi ? cnt - static_cast<int32_t>(cxi) : 0;
    b.n_queue[i] += n_tail + lost_pre;
    if (b.netobs) b.nb_shed[i] += lost_pre;
  }
}

// ---- kernel E: stream_rows_merge ----------------------------------------------
// The split exchange of one-to-one stream configs (the reference's
// _merge_stream_rows): one block per endpoint row r builds [its lane's queue
// row C | W_s candidates] by the static layout — a client row takes its
// server's control sends [K], its own RTO arms [K] and K*B empty entries; a
// server row its client's control sends, its own RTO arms and its client's
// bursts [K*B], slot-major — and merges it with merge_row, in shared memory
// or (split_global) the block's part of m_scratch.
template <class P>
__global__ void stream_rows_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  constexpr int W = 7;  // stream rows always carry the payload words
  extern __shared__ int32_t smem[];
  __shared__ int32_t n_tail;
  const int64_t r = blockIdx.x;
  const int64_t c = b.c, k = b.k, sf = b.s_flows, s2 = 2 * sf;
  const int64_t w_s = 2 * k + k * PUMP_BURST, w_all = c + w_s;
  int32_t* const sm = b.split_global ? b.m_scratch + r * W * w_all : smem;
  const int64_t n_ent = stream_entries(b);
  const int64_t lane = b.flow_lanes[r];
  const bool client = r < sf;
  if (threadIdx.x == 0) n_tail = 0;
  load_queue_row<W>(b, sm, lane);
  for (int64_t x = c + threadIdx.x; x < w_all; x += blockDim.x) {
    int32_t* ex = sm + W * x;
    const int64_t q = x - c;
    int64_t idx = -1;
    if (q < k) {  // the peer endpoint's control send of slot q
      idx = q * s2 + (client ? r + sf : r - sf);
    } else if (q < 2 * k) {  // the row's own RTO arm of slot q - K
      idx = k * s2 + (q - k) * s2 + r;
    } else if (!client) {  // the client's burst entry (slot, unit)
      idx = 4 * k * sf + (q - 2 * k) * sf + (r - sf);
    }
    if (idx >= 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) ex[w] = b.sx_blk[(w + 1) * n_ent + idx];
    } else {
      ex[0] = NEVER32;
      ex[1] = NEVER32;
#pragma unroll
      for (int w = 2; w < W; ++w) ex[w] = 0;
    }
  }
  __syncthreads();
  merge_row<W>(b, sm, w_all, lane, b.rec_slots - s2 * w_s + r * w_s,
               b.fl_split + r * w_s, &n_tail);
  __syncthreads();
  if (threadIdx.x == 0) b.n_queue[lane] += n_tail;  // lanes are distinct
}

// ---- kernel F: stream_tier -------------------------------------------------
// The tier's pop and slot walk (the reference's _stream_tier_iter up to its
// merge).  One thread per endpoint row e owns the row's flow, its column of
// the tier vectors and its queue head, and walks its first K_s queue columns
// in order: the pop-prefix rule (a prefix free of LOCALs under the wide rule,
// else a same-instant prefix of PACKETs, or column 0 alone, inside the
// window); a PACKET takes the down bucket and CoDel and, delivered inside
// the window (wide rule only), stimulates the law at once, else becomes a
// DELIVERY fallback; a start marker opens a client flow, an owned RTO local
// fires the timer, a segment (at a server row only from its own client)
// runs on_segment; every stimulus ends with the pump burst.  The control
// send and, on client rows, the burst charge the up bucket (the burst after
// its first unit by the chained law), each with its loss draw at its send
// sequence number; RTO arms take the row's local sequence.  Every candidate
// entry of the row and, when logging, every record slot of the row is
// written, valid or not (with tier_pcap, the capture records of the row's
// sends too); the peer's row is never touched (G reads the control sends
// across the pair).  With netobs the row's TV_NB_* counters follow every
// charge, and the popped PACKETs join the window's count.

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

// row e's walk; returns its popped PACKETs
__device__ int32_t stream_tier_row(const LaneBufs& b, int64_t e) {
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

  const int32_t head_hi = q[0][0], head_lo = q[1][0];
  bool prefix = true;
  for (int64_t j = 0; j < ks; ++j) {
    const int32_t thi = q[0][j], tlo = q[1][j], auxh = q[2][j];
    const int32_t auxl = q[3][j], size = q[4][j], phi = q[5][j], plo = q[6][j];
    const int32_t kind = auxh >> AUX_KIND_SHIFT;
    const int32_t src = (auxh >> AUX_SRC_SHIFT) & SRC_MASK;
    prefix = prefix && (wide ? kind != LOCAL
                             : (thi == head_hi && tlo == head_lo &&
                                kind == PACKET));
    const int64_t t = join_t(thi, tlo);
    const bool act = (prefix || j == 0) && t < we;
    if (act) {
      q[0][j] = NEVER32;
      q[1][j] = NEVER32;
    }

    // PACKET: the down bucket and CoDel on the compact rows
    const bool is_pkt = act && kind == PACKET;
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
    put_rec(b, trec + j * s2 + e, is_pkt, td, src, lane, auxl, size,
            drop ? DROP_CODEL : DELIVERED);

    // delivery elision: inside the window (wide rule only) the law runs at
    // once, at the delivery time; else a DELIVERY fallback is inserted
    const bool del_now = wide && deliver && td < we;
    tier_put(b, j * s2 + e, deliver && !del_now, td,
             (DELIVERY << AUX_KIND_SHIFT) | (src << AUX_SRC_SHIFT), auxl, size,
             phi, plo);
    const int64_t st = del_now ? td : t;

    int stim = 0;  // 1 open, 2 RTO, 3 segment
    if (act && kind == LOCAL && size == -1 && client) {
      stim = 1;
    } else if (act && kind == LOCAL && size == SZ_RTO && plo == clid) {
      stim = 2;
    } else if ((del_now || (act && kind == DELIVERY)) && (phi | plo) != 0 &&
               (client || src == clid)) {
      stim = 3;
    }
    Sends sd;
    if (stim) {
      Pair now;
      split(st, &now.hi, &now.lo);
      sd = stream_stimulus(
          b, f, stim, now, st, phi, plo, size, we, ur, sl,
          [&](int32_t u, bool valid, bool lost, int64_t dep, int64_t arr,
              int32_t bseq, int32_t bsize, int32_t bphi, int32_t bplo,
              bool /*retx*/) {
            const int64_t slot = j * PUMP_BURST + u;
            tier_put(b, lay.bo + slot * sf + e, valid, arr, pkt_auxh, bseq,
                     bsize, bphi, bplo);
            put_rec(b, tbrec + slot * sf + e, lost, st, lane, peer, bseq,
                    bsize, DROP_LOSS);
            if (b.tier_pcap)
              put_rec(b, b.rec_tbpc + slot * sf + e, capture, dep, lane, peer,
                      bseq, bsize, PCAP_TX);
          });
    }
    const Emit& em = sd.em;
    tier_put(b, lay.se + j * s2 + e, em.send_valid && !sd.lost, sd.arr,
             pkt_auxh, sd.seq, em.send_size,
             wshl(em.send_flags, PAY_SEQ_BITS) | em.send_seq, em.send_ack);
    put_rec(b, tsrec + j * s2 + e, sd.lost, st, lane, peer, sd.seq,
            em.send_size, DROP_LOSS);
    if (b.tier_pcap)
      put_rec(b, b.rec_tspc + j * s2 + e, em.send_valid && capture, sd.dep,
              lane, peer, sd.seq, em.send_size, PCAP_TX);
    // the RTO arm: a LOCAL self-insert at the own row
    tier_put(b, lay.sa + j * s2 + e, em.rto_valid,
             join_raw(em.rto_t.hi, em.rto_t.lo), loc_auxh, sd.lseq, SZ_RTO, 0,
             clid);
    // the rest of the burst block (client rows), empty
    for (int32_t u = sd.cnt; client && u < PUMP_BURST; ++u) {
      const int64_t slot = j * PUMP_BURST + u;
      tier_put(b, lay.bo + slot * sf + e, false, 0, 0, 0, 0, 0, 0);
      put_rec(b, tbrec + slot * sf + e, false, 0, 0, 0, 0, 0, 0);
      if (b.tier_pcap)
        put_rec(b, b.rec_tbpc + slot * sf + e, false, 0, 0, 0, 0, 0, 0);
    }
  }

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
  return pkts;
}

template <class P>
__global__ void stream_tier_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int32_t pkts = e < 2 * b.tier_s ? stream_tier_row(b, e) : 0;
  if (b.netobs) block_add(pkts, b.nb_win);
}

// ---- kernel G: tier_merge --------------------------------------------------
// The tier merge (the reference's _stream_tier_iter merge): one block per
// endpoint row r merges its queue [C2] with its W_t = 3K_s + K_s*B + Cx
// candidates — its DELIVERY fallbacks [K_s], its RTO arms [K_s], its peer's
// control sends [K_s], on server rows its client's bursts [K_s*B]
// (slot-major; a client row's are empty), its diverted cross entries [Cx].
// Most entries are empty, so the valid ones (time word != NEVER32) are first
// compacted into shared memory in index order (per-thread counts over
// contiguous chunks, a block scan), then only those are ranked by (key,
// index).  The first C2 go to the row, canonical empties after them; the rest
// are counted into TV_N_QUEUE and recorded as DROP_QUEUE in the tier's tail
// group [2S, W_t] at their rank past C2.
constexpr int TIER_THREADS = 128;

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

template <class P>
__global__ void tier_merge_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  // the valid entries, [n_valid][7]: in shared memory, or (tier_global) the
  // block's part of m_scratch
  extern __shared__ int32_t smem[];
  __shared__ int32_t part[TIER_THREADS];
  const int64_t r = blockIdx.x;
  const int64_t s2 = 2 * b.tier_s, c2 = b.c2;
  const int64_t wt = 3 * b.ks + b.ks * PUMP_BURST + b.cx, total = c2 + wt;
  int32_t* const sm = b.tier_global ? b.m_scratch + r * 7 * total : smem;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t chunk = (total + nt - 1) / nt;
  const int64_t lo = tid * chunk;
  const int64_t hi = lo + chunk < total ? lo + chunk : total;

  // compaction: count, scan, copy in index order
  int32_t cnt = 0;
  for (int64_t x = lo; x < hi; ++x) {
    int64_t stride;
    const int32_t* p = tier_entry(b, r, x, stride);
    if (p && p[0] != NEVER32) ++cnt;
  }
  part[tid] = cnt;
  __syncthreads();
  for (int s = 1; s < nt; s <<= 1) {  // Hillis-Steele
    const int32_t v = tid >= s ? part[tid - s] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  const int64_t n_valid = part[nt - 1];
  int64_t pos = part[tid] - cnt;
  for (int64_t x = lo; x < hi; ++x) {
    int64_t stride;
    const int32_t* p = tier_entry(b, r, x, stride);
    if (p && p[0] != NEVER32) {
#pragma unroll
      for (int w = 0; w < 7; ++w) sm[7 * pos + w] = p[w * stride];
      ++pos;
    }
  }
  __syncthreads();

  // rank the valid entries by (key, index); the row takes the first C2
  int32_t* q[7];
#pragma unroll
  for (int w = 0; w < 7; ++w) q[w] = b.tier_q + w * s2 * c2 + r * c2;
  const int64_t ttail = b.rec_ttail + r * wt;
  const int32_t lane = b.flow_lanes[r];
  for (int64_t y = tid; y < n_valid; y += nt) {
    const int32_t* ey = sm + 7 * y;
    const int64_t rank = key_rank<7>(sm, n_valid, y);
    if (rank < c2) {
#pragma unroll
      for (int w = 0; w < 7; ++w) q[w][rank] = ey[w];
    } else {
      put_rec(b, ttail + (rank - c2), true, join_raw(ey[0], ey[1]),
              (ey[2] >> AUX_SRC_SHIFT) & SRC_MASK, lane, ey[3], ey[4],
              DROP_QUEUE);
    }
  }
  for (int64_t x = n_valid + tid; x < c2; x += nt) {  // canonical empties
    q[0][x] = NEVER32;
    q[1][x] = NEVER32;
#pragma unroll
    for (int w = 2; w < 7; ++w) q[w][x] = 0;
  }
  const int64_t over = n_valid > c2 ? n_valid - c2 : 0;
  for (int64_t p = over + tid; p < wt; p += nt)  // tail slots left empty
    put_rec(b, ttail + p, false, 0, 0, 0, 0, 0, 0);
  if (tid == 0 && over)
    b.tier_v[TV_N_QUEUE * s2 + r] += static_cast<int32_t>(over);
}

// ---- kernel C: queue_min_window ---------------------------------------------
// One block: the lexicographic minimum of the queue heads (column 0 of every
// sorted row, the tier's rows too), then the window law and the live flag.
// With dynamic runahead the window is the smallest latency sent over so
// far, never below the floor (the static runahead until the first send).
// A window advance first folds the finished window into the netobs
// histogram (one thread: a scalar step).
// The block's min head: valid in thread 0.
__device__ int64_t heads_min(const LaneBufs& b) {
  __shared__ int64_t warp_min[32];
  int64_t m = NEVER64;
  for (int64_t i = threadIdx.x; i < b.n; i += blockDim.x) {
    const int64_t t = join_t(b.q_thi[i * b.c], b.q_tlo[i * b.c]);
    m = t < m ? t : m;
  }
  // tiered: the heads of the tier's endpoint rows
  const int64_t tier_plane = 2 * b.tier_s * b.c2;
  for (int64_t r = threadIdx.x; r < 2 * b.tier_s; r += blockDim.x) {
    const int64_t t =
        join_t(b.tier_q[r * b.c2], b.tier_q[tier_plane + r * b.c2]);
    m = t < m ? t : m;
  }
  for (int s = 16; s > 0; s >>= 1) {
    const int64_t o = __shfl_down_sync(0xFFFFFFFFu, m, s);
    m = o < m ? o : m;
  }
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (unsigned w = 1; w < (blockDim.x + 31) / 32; ++w)
      m = warp_min[w] < m ? warp_min[w] : m;
  }
  return m;
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
__global__ void queue_min_kernel(const __grid_constant__ P bufs,
                                 int advance) {
  const LaneBufs& b = scenario(bufs, blockIdx.x);
  if (b.ctl[0] == 0) return;
  const int64_t m = heads_min(b);
  if (threadIdx.x != 0) return;

  const bool live = m < b.stop;
  int64_t we = join_raw(*b.now_we_hi, *b.now_we_lo);
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
__global__ void hybrid_window_kernel(const __grid_constant__ P bufs,
                                     int first, int32_t ext_hi,
                                     int32_t ext_lo, int32_t ext_used) {
  const LaneBufs& b = scenario(bufs, blockIdx.x);
  if (!first && b.ctl[0] == 0) return;
  const int64_t m = heads_min(b);
  if (threadIdx.x != 0) return;
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
// the dispatch stops.  Thread 0 runs the law and tells the block, through
// shared memory, what comes next.
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
  __shared__ int64_t warp_min[32];
  int64_t m = NEVER64;
  const int64_t rows = *b.egress_count < b.eg_cap ? *b.egress_count : b.eg_cap;
  for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
    const int64_t* row = b.egress + r * 6;
    if (row[5] == DELIVERED && row[0] >= thr) m = row[0] < m ? row[0] : m;
  }
  for (int s = 16; s > 0; s >>= 1) {
    const int64_t o = __shfl_down_sync(0xFFFFFFFFu, m, s);
    m = o < m ? o : m;
  }
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (unsigned w = 1; w < (blockDim.x + 31) / 32; ++w)
      m = warp_min[w] < m ? warp_min[w] : m;
  }
  return m;
}

template <class P>
__global__ void hybrid_fused_kernel(const __grid_constant__ P bufs, int first,
                                    int k_eff, int32_t ext_used) {
  const LaneBufs& b = scenario(bufs, blockIdx.x);
  if (!first && b.ctl[0] == 0) return;
  const int64_t m = heads_min(b);
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
// buffer that never wraps, in two instances of one template on the row:
// the records of recs into the [L, 6] int64 log, and the flow records of
// fl_recs into the [FL, 10] int32 flowtrace ring, each stamped with the
// current window's end (C set it before A; D runs before the next C).  One
// block an instance: tiles of ITEMS entries per thread, a block scan of the
// per-thread counts, then each thread copies its valid rows to their
// positions; rows past the end are counted as lost.
constexpr int LOG_THREADS = 1024;
constexpr int LOG_ITEMS = 8;

// the log's rows: six int64 words, copied as they are
struct LogRows {
  const int64_t* src;
  int64_t* dst;
  __device__ void copy(int64_t r, int64_t pos) const {
    for (int w = 0; w < 6; ++w) dst[pos * 6 + w] = src[r * 6 + w];
  }
};

// the ring's rows: a flow record's eight int32 words around the window stamp
struct FlowRows {
  const int32_t* src;
  int32_t* dst;
  int32_t we_hi, we_lo;
  __device__ void copy(int64_t r, int64_t pos) const {
    const int32_t* x = src + r * FL_WORDS;
    int32_t* y = dst + pos * FT_COLS;
    y[0] = x[0];
    y[1] = x[1];
    y[2] = we_hi;
    y[3] = we_lo;
    for (int w = 2; w < FL_WORDS; ++w) y[w + 2] = x[w];
  }
};

template <class Rows>
__device__ void append_rows(const int32_t* valid, int64_t n_rec,
                            const Rows& rows, int32_t* count, int32_t* lost,
                            int64_t cap) {
  __shared__ int32_t warp_sum[32];
  __shared__ int32_t tile_total;
  const int64_t start = *count;
  int64_t base = start;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t t0 = 0; t0 < n_rec; t0 += LOG_THREADS * LOG_ITEMS) {
    const int64_t e0 = t0 + threadIdx.x * static_cast<int64_t>(LOG_ITEMS);
    int32_t cnt = 0;
    for (int u = 0; u < LOG_ITEMS; ++u)
      if (e0 + u < n_rec && valid[e0 + u]) ++cnt;
    // inclusive scan within the warp, then across warps
    int32_t incl = cnt;
    for (int s = 1; s < 32; s <<= 1) {
      const int32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, s);
      if (lane >= s) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t ws = warp_sum[lane];
      for (int s = 1; s < 32; s <<= 1) {
        const int32_t v = __shfl_up_sync(0xFFFFFFFFu, ws, s);
        if (lane >= s) ws += v;
      }
      warp_sum[lane] = ws;  // inclusive prefix over warps
      if (lane == 31) tile_total = ws;
    }
    __syncthreads();
    int64_t pos = base + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - cnt;
    for (int u = 0; u < LOG_ITEMS; ++u) {
      const int64_t r = e0 + u;
      if (r < n_rec && valid[r]) {
        if (pos < cap) rows.copy(r, pos);
        ++pos;
      }
    }
    base += tile_total;
    __syncthreads();  // warp_sum / tile_total are rewritten by the next tile
  }
  if (threadIdx.x == 0) {
    const int64_t n_valid = base - start;
    int64_t room = cap - start;
    room = room < 0 ? 0 : room;
    const int64_t kept = n_valid < room ? n_valid : room;
    *count = static_cast<int32_t>(start + n_valid);
    *lost += static_cast<int32_t>(n_valid - kept);
  }
}

// The egress instance's second pass: the earliest DELIVERED time among the
// iteration's egress rows lowers egress_min (a block min).
__device__ void egress_min(const LaneBufs& b) {
  __shared__ int64_t warp_min[32];
  int64_t m = NEVER64;
  for (int64_t r = threadIdx.x; r < b.n_eg; r += blockDim.x) {
    const int64_t* row = b.eg_recs + r * 6;
    if (b.eg_valid[r] && row[5] == DELIVERED) m = row[0] < m ? row[0] : m;
  }
  for (int s = 16; s > 0; s >>= 1) {
    const int64_t o = __shfl_down_sync(0xFFFFFFFFu, m, s);
    m = o < m ? o : m;
  }
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (unsigned w = 1; w < (blockDim.x + 31) / 32; ++w)
    m = warp_min[w] < m ? warp_min[w] : m;
  if (m < join_t(*b.egress_min_hi, *b.egress_min_lo))
    split(m, b.egress_min_hi, b.egress_min_lo);
}

// one block for each instance that runs, in this order: the log (when
// logging), the ring (with flowtrace), the egress (hybrid)
template <class P>
__global__ void append_log_kernel(const __grid_constant__ P bufs) {
  const LaneBufs& b = scenario(bufs, blockIdx.y);
  if (b.ctl[0] == 0) return;
  unsigned inst = blockIdx.x;
  if (b.log_cap > 0) {
    if (inst == 0) {
      append_rows(b.rec_valid, b.n_rec, LogRows{b.recs, b.log}, b.log_count,
                  b.log_lost, b.log_cap);
      return;
    }
    --inst;
  }
  if (b.flowtrace) {
    if (inst == 0) {
      append_rows(b.fl_valid, b.n_fl,
                  FlowRows{b.fl_recs, b.fl_buf, *b.now_we_hi, *b.now_we_lo},
                  b.fl_count, b.fl_lost, b.ft_cap);
      return;
    }
    --inst;
  }
  append_rows(b.eg_valid, b.n_eg, LogRows{b.eg_recs, b.egress},
              b.egress_count, b.egress_lost, b.eg_cap);
  egress_min(b);
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

unsigned merge_threads(int64_t w_all) {
  int64_t threads = (w_all + 31) / 32 * 32;
  return static_cast<unsigned>(threads < 256 ? threads : 256);
}

}  // namespace

// Every lane launcher: `host` and `dev` are the same [s] LaneBufs array in
// host and in device memory (see the head of this file); the grid takes
// its shape from host[0] and a scenario coordinate of size s.

extern "C" {

int lane_slots(const LaneBufs* host, const LaneBufs* dev, int s,
               cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    lane_slots_kernel<<<dim3(blocks_for(host->n, 128), s), 128, 0, stream>>>(
        bufs);
    return cudaSuccess;
  });
}

// The exchange scratch (x_cnt, x_fill) of the s scenarios is one [s, N]
// block each (the Python side checks it), so two memsets clear it for all.
int exchange_merge(const LaneBufs* host, const LaneBufs* dev, int s,
                   cudaStream_t stream) {
  const LaneBufs* b = host;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    const int64_t m = b->n_x;
    const size_t scratch = static_cast<size_t>(s) * b->n * sizeof(int32_t);
    cudaError_t err = cudaMemsetAsync(b->x_cnt, 0, scratch, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(b->x_fill, 0, scratch, stream);
    if (err != cudaSuccess) return err;
    x_count_kernel<<<dim3(blocks_for(m, 256), s), 256, 0, stream>>>(bufs);
    x_scan_kernel<<<s, 1024, 0, stream>>>(bufs);
    x_place_kernel<<<dim3(blocks_for(m, 256), s), 256, 0, stream>>>(bufs);
    const int64_t w_all = b->c + b->sw + b->cx;
    const int64_t bytes = (b->words * w_all + b->cx) * sizeof(int32_t);
    int smem = 0;
    err = b->words == 7 ? merge_smem(merge_kernel<7, P>, b->merge_global != 0,
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

int stream_rows_merge(const LaneBufs* host, const LaneBufs* dev, int s,
                      cudaStream_t stream) {
  const LaneBufs* b = host;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    const int64_t w_all = b->c + 2 * b->k + b->k * PUMP_BURST;
    int smem = 0;
    const cudaError_t err =
        merge_smem(stream_rows_kernel<P>, b->split_global != 0,
                   7 * w_all * sizeof(int32_t), &smem);
    if (err != cudaSuccess) return err;
    stream_rows_kernel<<<dim3(static_cast<unsigned>(2 * b->s_flows), s),
                         merge_threads(w_all), smem, stream>>>(bufs);
    return cudaSuccess;
  });
}

int stream_tier(const LaneBufs* host, const LaneBufs* dev, int s,
                cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    // one warp per block: the rows' serial walks spread over the SMs
    const int64_t rows = 2 * host->tier_s;
    if (rows > 0)
      stream_tier_kernel<<<dim3(blocks_for(rows, 32), s), 32, 0, stream>>>(
          bufs);
    return cudaSuccess;
  });
}

int tier_merge(const LaneBufs* host, const LaneBufs* dev, int s,
               cudaStream_t stream) {
  const LaneBufs* b = host;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    const int64_t total = b->c2 + 3 * b->ks + b->ks * PUMP_BURST + b->cx;
    int smem = 0;
    const cudaError_t err =
        merge_smem(tier_merge_kernel<P>, b->tier_global != 0,
                   7 * total * sizeof(int32_t), &smem);
    if (err != cudaSuccess) return err;
    if (b->tier_s > 0)
      tier_merge_kernel<<<dim3(static_cast<unsigned>(2 * b->tier_s), s),
                          TIER_THREADS, smem, stream>>>(bufs);
    return cudaSuccess;
  });
}

// one block per scenario, each with its own stop and window
int queue_min_window(const LaneBufs* host, const LaneBufs* dev, int s,
                     int advance, cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    queue_min_kernel<<<s, 1024, 0, stream>>>(bufs, advance);
    return cudaSuccess;
  });
}

// a hybrid turn's step of C: its first step arms the turn (ungated)
int hybrid_window(const LaneBufs* host, const LaneBufs* dev, int s,
                  int first, int ext_hi, int ext_lo, int ext_used,
                  cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    hybrid_window_kernel<<<s, 1024, 0, stream>>>(bufs, first, ext_hi, ext_lo,
                                                 ext_used);
    return cudaSuccess;
  });
}

// a fused dispatch's step of C: its first step arms the dispatch (ungated)
int hybrid_fused_window(const LaneBufs* host, const LaneBufs* dev, int s,
                        int first, int k_eff, int ext_used,
                        cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    hybrid_fused_kernel<<<s, 1024, 0, stream>>>(bufs, first, k_eff, ext_used);
    return cudaSuccess;
  });
}

// kernel H over one injection block `inj` ([INJ_WORDS, inj_b] int32 on the
// device): the two memsets, count, the ungated scan, place, the merge
int inject_merge(const LaneBufs* host, const LaneBufs* dev, int s,
                 const int32_t* inj, cudaStream_t stream) {
  const LaneBufs* b = host;
  return with_bufs(host, dev, s, [&](auto bufs) {
    using P = decltype(bufs);
    const int64_t m = b->inj_b;
    const size_t scratch = static_cast<size_t>(s) * b->n * sizeof(int32_t);
    cudaError_t err = cudaMemsetAsync(b->x_cnt, 0, scratch, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(b->x_fill, 0, scratch, stream);
    if (err != cudaSuccess) return err;
    inj_count_kernel<<<dim3(blocks_for(m, 256), s), 256, 0, stream>>>(bufs,
                                                                      inj);
    x_scan_kernel<P, false><<<s, 1024, 0, stream>>>(bufs);
    inj_place_kernel<<<dim3(blocks_for(m, 256), s), 256, 0, stream>>>(bufs,
                                                                      inj);
    const int64_t w_all = b->c + b->cxi;
    const int64_t bytes = b->words * w_all * sizeof(int32_t);
    int smem = 0;
    err = b->words == 7
              ? merge_smem(inject_merge_kernel<7, P>, b->inject_global != 0,
                           bytes, &smem)
              : merge_smem(inject_merge_kernel<5, P>, b->inject_global != 0,
                           bytes, &smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(b->n), s);
    if (b->words == 7) {
      inject_merge_kernel<7, P>
          <<<grid, merge_threads(w_all), smem, stream>>>(bufs, inj);
    } else {
      inject_merge_kernel<5, P>
          <<<grid, merge_threads(w_all), smem, stream>>>(bufs, inj);
    }
    return cudaSuccess;
  });
}

int append_log(const LaneBufs* host, const LaneBufs* dev, int s,
               cudaStream_t stream) {
  return with_bufs(host, dev, s, [&](auto bufs) {
    // one block for each instance that runs: the log, the flowtrace ring,
    // the egress
    const unsigned blocks = (host->log_cap > 0 ? 1u : 0u) +
                            (host->flowtrace ? 1u : 0u) +
                            (host->ext_any ? 1u : 0u);
    if (blocks > 0)
      append_log_kernel<<<dim3(blocks, s), LOG_THREADS, 0, stream>>>(bufs);
    return cudaSuccess;
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
