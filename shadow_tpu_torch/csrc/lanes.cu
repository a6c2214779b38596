// The lane engine's four kernels for Hopper (sm_90a), and the threefry
// draw they share.
//
// Plain C interface, bound from shadow_tpu_torch/backend/kernels.py with
// ctypes.  Every lane launcher takes one LaneBufs block (the device pointers
// of the run's state, tables and workspace, built and checked once per run
// on the Python side) and PyTorch's current stream, launches without
// synchronising, and returns cudaGetLastError().
//
// Arithmetic: the lane state keeps the JAX reference's int32 (hi, lo) time
// pairs in memory; the kernels join them to int64 in registers.  Within the
// engine's guarded ranges (kernels.py / gpu_engine.py) that gives the same
// integers as the reference's pair arithmetic.  Where the reference relies
// on int32 width (counters, token counts, k*rate) the kernels use int32.
//
// Every kernel that changes state is gated on ctl[0] (the `live` flag that
// queue_min_window writes), so steps after the end of the run are no-ops.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEVER32 = 0x7FFFFFFF;
constexpr int64_t NEVER64 = 0x7FFFFFFFFFFFFFFFLL;
constexpr int64_t MASK31 = 0x7FFFFFFFLL;
constexpr int32_t CD_UNSET = -2147483647;  // -(1 << 31) + 1

constexpr int32_t PACKET = 0, LOCAL = 1, DELIVERY = 2;
constexpr int32_t M_NONE = 0, M_PHOLD = 1, M_TGEN_MESH = 2, M_TGEN_CLIENT = 3,
                  M_TGEN_SERVER = 4, M_PING_CLIENT = 5, M_PING_SERVER = 6;
constexpr int AUX_SRC_SHIFT = 12, AUX_KIND_SHIFT = 29;
constexpr int32_t SRC_MASK = (1 << 17) - 1;

constexpr int64_t TARGET_NS = 10000000LL;     // CoDel target, 10 ms
constexpr int64_t INTERVAL_NS = 100000000LL;  // CoDel interval, 100 ms
constexpr int32_t DIV_LAST = 1024;            // codel_div has 1025 entries
constexpr int32_t FRAME_OVERHEAD_BYTES = 24;

constexpr int64_t DELIVERED = 0, DROP_LOSS = 1, DROP_CODEL = 2,
                  DROP_QUEUE = 3;

// threefry stream ids (core/rng.py)
constexpr uint32_t LOSS_STREAM = 1u << 30, APP_STREAM = 2u << 30;

}  // namespace

// Field order must match kernels.py's LaneArgs: LaneState fields, then
// LaneTables fields, then Workspace fields, then the sizes.
struct LaneBufs {
  // LaneState
  int32_t *q_thi, *q_tlo, *q_auxh, *q_auxl, *q_size;
  int32_t *send_seq, *local_seq, *app_draws;
  int32_t *up_tokens, *up_nr_hi, *up_nr_lo, *up_ld_hi, *up_ld_lo;
  int32_t *dn_tokens, *dn_nr_hi, *dn_nr_lo, *dn_ld_hi, *dn_ld_lo;
  int32_t *cd_fat_hi, *cd_fat_lo, *cd_dnext_hi, *cd_dnext_lo, *cd_drop_count;
  uint8_t *cd_dropping;
  int32_t *m_sent, *m_peer_offset;
  int32_t *n_delivered, *n_loss, *n_codel, *n_queue, *recv_bytes, *n_sends,
      *n_hops;
  int64_t *log;
  int32_t *log_count, *log_lost, *rounds, *iters, *now_we_hi, *now_we_lo,
      *min_used_lat;
  // LaneTables
  int32_t *node_of, *lat;
  int64_t *thresh;
  int32_t *up_rate, *up_burst, *up_kfull, *up_kfi;
  int32_t *dn_rate, *dn_burst, *dn_kfull, *dn_kfi;
  int32_t *model, *recv_mult, *p_size, *p_int_hi, *p_int_lo, *p_peer,
      *p_count, *p_stride, *codel_div;
  // Workspace
  int32_t *ctl, *self_blk, *out_blk;
  int64_t *recs;
  int32_t *rec_valid, *x_cnt, *x_start, *x_fill, *x_order;
  // sizes (sw: self block width, K or 2K) and run constants
  int64_t n, c, k, cx, sw, g, log_cap, stop, runahead, interval;
  int64_t seed_lo, seed_hi, bootstrap_end, has_loss, all_passive,
      dyn_runahead, runahead_floor;
};

namespace {

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
// departure time.  Refill by elapsed intervals, exact within the k_full
// horizon and saturated + grid-realigned beyond it; FIFO charge clock.
__device__ int64_t bucket_charge(Bucket& b, int32_t rate, int32_t burst,
                                 int32_t k_full, int32_t kfi, int64_t t,
                                 int32_t bits, bool active, int32_t interval) {
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
  if (wait) b.nr += static_cast<int64_t>(w * interval);
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

// ---- kernel A: lane_slots ---------------------------------------------------
// One thread per lane walks its first K queue columns in registers: the
// co-pop rule, then the slot law on each popped column — down bucket +
// CoDel for PACKET pops, delivered inline on passive lanes or as a DELIVERY
// self-insert on active ones; the app sends (tgen ticks, phold hops to a
// threefry peer, ping requests and echoes) with the up bucket, the latency
// gather and the threefry loss draw; the timer re-arms.
__global__ void lane_slots_kernel(LaneBufs b) {
  if (b.ctl[0] == 0) return;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t n = b.n;
  if (i >= n) return;
  const int64_t c = b.c, k = b.k, sw = b.sw;
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

  const int32_t model = b.model[i];
  const bool passive = model == M_NONE || model == M_TGEN_MESH ||
                       model == M_TGEN_CLIENT || model == M_TGEN_SERVER;
  const int32_t recv_mult = b.recv_mult[i];
  const int32_t p_size = b.p_size[i];
  const int32_t p_count = b.p_count[i];
  const int64_t p_int = join_raw(b.p_int_hi[i], b.p_int_lo[i]);
  const int32_t my_node = b.node_of[i];
  const bool mesh = model == M_TGEN_MESH, client = model == M_TGEN_CLIENT;
  const bool phold = model == M_PHOLD;
  const bool ping_cl = model == M_PING_CLIENT;
  const bool ping_sv = model == M_PING_SERVER;
  const int32_t lane_pkt_auxh = (PACKET << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  const int32_t lane_loc_auxh = (LOCAL << AUX_KIND_SHIFT) | (lane << AUX_SRC_SHIFT);
  const int64_t rec_base = n * (sw + b.cx);
  const int64_t nk = n * k, nsw = n * sw;
  const int64_t arm0 = all_passive ? 0 : k;  // first re-arm column

  // co-pop rule: passive lanes pop any prefix inside the window; active
  // lanes only a same-instant prefix of PACKETs, or column 0 alone
  const int32_t head_hi = b.q_thi[i * c], head_lo = b.q_tlo[i * c];
  bool pkt_prefix = true;

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
      allowed = j == 0 || (thi == head_hi && tlo == head_lo && pkt_prefix);
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
                                     interval);
    int64_t sojourn = 0;
    if (is_pkt) {
      sojourn = td - t;
      if (sojourn > NEVER32) sojourn = NEVER32;
    }
    const bool drop = codel_offer(fat_hi, fat_lo, cd_dn, dcount, dropping, td,
                                  sojourn, is_pkt, b.codel_div);
    const bool deliver = is_pkt && !drop;
    if (is_pkt && drop) n_codel += 1;
    if (deliver) n_del += 1;
    // passive lanes count inline; active lanes get a DELIVERY self-insert
    // keyed by the packet's (src, seq)
    if (deliver && passive) recv += size * recv_mult;
    if (!all_passive) {
      const int64_t si = i * sw + j;
      const bool ins = deliver && !passive;
      int32_t ins_hi = NEVER32, ins_lo = NEVER32;
      if (ins) split(td, &ins_hi, &ins_lo);
      b.self_blk[0 * nsw + si] = ins_hi;
      b.self_blk[1 * nsw + si] = ins_lo;
      b.self_blk[2 * nsw + si] =
          ins ? (DELIVERY << AUX_KIND_SHIFT) | (src << AUX_SRC_SHIFT) : 0;
      b.self_blk[3 * nsw + si] = ins ? seq : 0;
      b.self_blk[4 * nsw + si] = ins ? size : 0;
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
                                      do_send, interval);

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
    if (rearm) local_seq += 1;

    // outbound packet: arrival = max(depart + latency, window end), unless
    // the LOSS_STREAM draw at counter snd_seq loses it (never before
    // bootstrap_end)
    const int64_t oi = j * n + i;
    bool lost = false;
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
      int64_t arr = dep + lat;
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
  // the smallest latency sent over (exact: min is order-free)
  if (min_lat < NEVER32) atomicMin(b.min_used_lat, min_lat);
}

// ---- kernel B: exchange_merge -----------------------------------------------
// A counting sort of the outbound block by destination (count, scan, place),
// then one block per lane merges [queue C | self S | cross Cx] by the event
// key in shared memory and keeps the first C (S = sw: K re-arms, or K
// DELIVERY inserts then K re-arms).

__global__ void x_count_kernel(LaneBufs b) {
  if (b.ctl[0] == 0) return;
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m >= b.k * b.n) return;
  const int32_t d = b.out_blk[m];
  if (d < b.n) atomicAdd(&b.x_cnt[d], 1);
}

// exclusive scan of x_cnt into x_start: one block, contiguous chunks
__global__ void x_scan_kernel(LaneBufs b) {
  if (b.ctl[0] == 0) return;
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

__global__ void x_place_kernel(LaneBufs b) {
  if (b.ctl[0] == 0) return;
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m >= b.k * b.n) return;
  const int32_t d = b.out_blk[m];
  if (d < b.n) {
    const int32_t pos = b.x_start[d] + atomicAdd(&b.x_fill[d], 1);
    b.x_order[pos] = static_cast<int32_t>(m);
  }
}

__device__ __forceinline__ bool key_less(const int32_t* a, const int32_t* b) {
  if (a[0] != b[0]) return a[0] < b[0];
  if (a[1] != b[1]) return a[1] < b[1];
  if (a[2] != b[2]) return a[2] < b[2];
  return a[3] < b[3];
}

// dynamic shared memory: W entries x 5 words + Cx selected entry indices
__global__ void merge_kernel(LaneBufs b) {
  if (b.ctl[0] == 0) return;
  extern __shared__ int32_t sm[];
  const int64_t i = blockIdx.x;
  const int64_t n = b.n, c = b.c, k = b.k, cx = b.cx, sw = b.sw;
  const int64_t w_all = c + sw + cx, tail = sw + cx, nk = n * k, nsw = n * sw;
  int32_t* e = sm;                  // [W][5]
  int32_t* sel = sm + 5 * w_all;    // [Cx]
  __shared__ int32_t n_tail;

  const int32_t cnt = b.x_cnt[i];
  const int32_t take = cnt < cx ? cnt : static_cast<int32_t>(cx);
  const int32_t* seg = b.x_order + b.x_start[i];
  if (threadIdx.x == 0) {
    n_tail = 0;
    if (cnt <= cx) {
      // the whole group fits: which slot each entry takes does not change
      // the merged row (valid entries have distinct keys; empty ones are
      // identical)
      for (int32_t r = 0; r < cnt; ++r) sel[r] = seg[r];
    } else {
      // overflow: keep the Cx earliest in (slot, source lane) order
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
  __syncthreads();

  for (int64_t x = threadIdx.x; x < w_all; x += blockDim.x) {
    int32_t* ex = e + 5 * x;
    if (x < c) {
      const int64_t qi = i * c + x;
      ex[0] = b.q_thi[qi];
      ex[1] = b.q_tlo[qi];
      ex[2] = b.q_auxh[qi];
      ex[3] = b.q_auxl[qi];
      ex[4] = b.q_size[qi];
    } else if (x < c + sw) {
      const int64_t si = i * sw + (x - c);
      for (int w = 0; w < 5; ++w) ex[w] = b.self_blk[w * nsw + si];
    } else {
      const int64_t r = x - c - sw;
      if (r < take) {
        const int64_t m = sel[r];
        for (int w = 0; w < 5; ++w) ex[w] = b.out_blk[(w + 1) * nk + m];
      } else {
        ex[0] = NEVER32;
        ex[1] = NEVER32;
        ex[2] = 0;
        ex[3] = 0;
        ex[4] = 0;
      }
    }
  }
  __syncthreads();

  // rank by (key, index): a permutation, stable for equal keys
  int32_t local_tail = 0;
  for (int64_t x = threadIdx.x; x < w_all; x += blockDim.x) {
    const int32_t* ex = e + 5 * x;
    int64_t rank = 0;
    for (int64_t y = 0; y < w_all; ++y) {
      const int32_t* ey = e + 5 * y;
      if (key_less(ey, ex) || (y < x && !key_less(ex, ey))) ++rank;
    }
    if (rank < c) {
      const int64_t qi = i * c + rank;
      b.q_thi[qi] = ex[0];
      b.q_tlo[qi] = ex[1];
      b.q_auxh[qi] = ex[2];
      b.q_auxl[qi] = ex[3];
      b.q_size[qi] = ex[4];
    } else {
      const bool valid = ex[0] != NEVER32;
      if (valid) ++local_tail;
      if (b.log_cap > 0) {
        const int64_t r = i * tail + (rank - c);
        int64_t* row = b.recs + r * 6;
        if (valid) {
          row[0] = join_t(ex[0], ex[1]);
          row[1] = (ex[2] >> AUX_SRC_SHIFT) & SRC_MASK;
          row[2] = i;
          row[3] = ex[3];
          row[4] = ex[4];
          row[5] = DROP_QUEUE;
        } else {
          for (int w = 0; w < 6; ++w) row[w] = 0;
        }
        b.rec_valid[r] = valid ? 1 : 0;
      }
    }
  }
  if (local_tail) atomicAdd(&n_tail, local_tail);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t lost_pre = cnt > cx ? cnt - static_cast<int32_t>(cx) : 0;
    b.n_queue[i] += n_tail + lost_pre;
    if (i == 0) *b.iters += 1;
  }
}

// ---- kernel C: queue_min_window ---------------------------------------------
// One block: the lexicographic minimum of the queue heads (column 0 of every
// sorted row), then the window law and the live flag.  With dynamic runahead
// the window is the smallest latency sent over so far, never below the
// floor (the static runahead until the first send).
__global__ void queue_min_kernel(LaneBufs b, int advance) {
  __shared__ int64_t warp_min[32];
  int64_t m = NEVER64;
  for (int64_t i = threadIdx.x; i < b.n; i += blockDim.x) {
    const int64_t t = join_t(b.q_thi[i * b.c], b.q_tlo[i * b.c]);
    m = t < m ? t : m;
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

  const bool live = m < b.stop;
  int64_t we = join_raw(*b.now_we_hi, *b.now_we_lo);
  if (advance && live && m >= we) {
    int64_t runahead = b.runahead;
    if (b.dyn_runahead) {
      const int32_t used = *b.min_used_lat;
      if (used != NEVER32)
        runahead = used > b.runahead_floor ? used : b.runahead_floor;
    }
    int64_t end = m + runahead;
    we = end < b.stop ? end : b.stop;
    split(we, b.now_we_hi, b.now_we_lo);
    *b.rounds += 1;
  }
  b.ctl[0] = live ? 1 : 0;
  b.ctl[1] = (live && m < we) ? 1 : 0;
  split(m, &b.ctl[2], &b.ctl[3]);
}

// ---- kernel D: append_log ---------------------------------------------------
// One block compacts the valid rows of recs (in buffer order) into the log:
// tiles of ITEMS entries per thread, a block scan of the per-thread counts,
// then each thread copies its valid rows to their positions.
constexpr int LOG_THREADS = 1024;
constexpr int LOG_ITEMS = 8;

__global__ void append_log_kernel(LaneBufs b, int64_t n_rec) {
  if (b.ctl[0] == 0) return;
  __shared__ int32_t warp_sum[32];
  __shared__ int32_t tile_total;
  const int64_t start = *b.log_count;
  int64_t base = start;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t t0 = 0; t0 < n_rec; t0 += LOG_THREADS * LOG_ITEMS) {
    const int64_t e0 = t0 + threadIdx.x * static_cast<int64_t>(LOG_ITEMS);
    int32_t cnt = 0;
    for (int u = 0; u < LOG_ITEMS; ++u)
      if (e0 + u < n_rec && b.rec_valid[e0 + u]) ++cnt;
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
      if (r < n_rec && b.rec_valid[r]) {
        if (pos < b.log_cap)
          for (int w = 0; w < 6; ++w) b.log[pos * 6 + w] = b.recs[r * 6 + w];
        ++pos;
      }
    }
    base += tile_total;
    __syncthreads();  // warp_sum / tile_total are rewritten by the next tile
  }
  if (threadIdx.x == 0) {
    const int64_t n_valid = base - start;
    int64_t room = b.log_cap - start;
    room = room < 0 ? 0 : room;
    const int64_t kept = n_valid < room ? n_valid : room;
    *b.log_count = static_cast<int32_t>(start + n_valid);
    *b.log_lost += static_cast<int32_t>(n_valid - kept);
  }
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

}  // namespace

extern "C" {

int lane_slots(const LaneBufs* b, cudaStream_t stream) {
  lane_slots_kernel<<<blocks_for(b->n, 128), 128, 0, stream>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

int exchange_merge(const LaneBufs* b, cudaStream_t stream) {
  const int64_t m = b->k * b->n;
  cudaError_t err = cudaMemsetAsync(b->x_cnt, 0, b->n * sizeof(int32_t), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(b->x_fill, 0, b->n * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  x_count_kernel<<<blocks_for(m, 256), 256, 0, stream>>>(*b);
  x_scan_kernel<<<1, 1024, 0, stream>>>(*b);
  x_place_kernel<<<blocks_for(m, 256), 256, 0, stream>>>(*b);
  const int64_t w_all = b->c + b->sw + b->cx;
  int64_t threads = (w_all + 31) / 32 * 32;
  threads = threads < 256 ? threads : 256;
  const int smem = static_cast<int>((5 * w_all + b->cx) * sizeof(int32_t));
  merge_kernel<<<static_cast<unsigned>(b->n), static_cast<unsigned>(threads),
                 smem, stream>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

int queue_min_window(const LaneBufs* b, int advance, cudaStream_t stream) {
  queue_min_kernel<<<1, 1024, 0, stream>>>(*b, advance);
  return static_cast<int>(cudaGetLastError());
}

int append_log(const LaneBufs* b, cudaStream_t stream) {
  const int64_t n_rec = b->n * (b->sw + b->cx) + b->k * b->n;
  append_log_kernel<<<1, LOG_THREADS, 0, stream>>>(*b, n_rec);
  return static_cast<int>(cudaGetLastError());
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
