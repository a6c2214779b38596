// Probes for kernels C and D of shadow_tpu_torch/csrc/lanes.cu, built and
// driven by scripts/gpu_cluster_probe.py (not part of the port):
//
// - probe_launch: the host's cost of enqueueing one launch, and the
//   device's cost of running it back to back, for an empty kernel that
//   takes a parameter the size of the lane kernels' LaneBufs, launched
//   with <<<>>>, with cudaLaunchKernelEx, or with cudaLaunchKernelEx and a
//   cluster dimension (the form C and D now use).
// - lookback_rows: D's compaction (one instance: [n] int32 flags, rows of
//   six int64 words, appended in order from *count, the rows past the
//   capacity counted in *lost, and for the egress the earliest DELIVERED
//   time lowering an (hi, lo) pair) as a single-pass scan with decoupled
//   look-back (Merrill & Garland, 2016) over a grid of tiles, in place of
//   D's one cluster.  Each tile's status word carries the call's
//   generation, so no call clears them.
//
// Plain C interface, loaded with ctypes; pointers are device pointers.

#include <cuda_runtime.h>

#include <chrono>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- the launch's cost ------------------------------------------------------

struct Fat {  // a kernel parameter the size of LaneBufs (about 110 words)
  int64_t w[112];
};

__global__ void empty_kernel(const __grid_constant__ Fat f) {
  if (f.w[0] == -1 && threadIdx.x == 0)
    *reinterpret_cast<int64_t*>(f.w[1]) = blockIdx.x;
}

__global__ void spin_kernel(int64_t ns) {
  const int64_t t0 = clock64();
  // about one cycle a nanosecond at the card's clocks; only needs to be
  // long enough to hold the launches behind it
  while (clock64() - t0 < ns) __nanosleep(1000);
}

// ---- the look-back compaction ----------------------------------------------

constexpr int LB_THREADS = 256;
constexpr int LB_ITEMS = 16;  // flags a thread
constexpr int LB_TILE = LB_THREADS * LB_ITEMS;
constexpr int64_t NEVER = 0x7FFFFFFFFFFFFFFFLL;  // lanes.cu NEVER64
constexpr int64_t DELIVERED = 0;

// status word: generation (30 bits) | flag (2 bits: 1 the tile's count, 2
// the inclusive prefix) | value (32 bits)
__device__ __forceinline__ uint64_t pack(uint32_t gen, uint32_t flag,
                                         uint32_t v) {
  return (static_cast<uint64_t>(gen & 0x3fffffffu) << 34) |
         (static_cast<uint64_t>(flag) << 32) | v;
}

__device__ __forceinline__ void publish(uint64_t* status, uint64_t w) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(status), "l"(w)
               : "memory");
}

__device__ __forceinline__ uint64_t observe(const uint64_t* status) {
  uint64_t w;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(status)
               : "memory");
  return w;
}

__global__ void __launch_bounds__(LB_THREADS)
    lookback_kernel(const int32_t* valid, int64_t n, const int64_t* src,
                    int64_t* dst, int32_t* count, int32_t* lost, int64_t cap,
                    uint64_t* status, int64_t* mins, uint32_t gen,
                    int32_t* eg_hi, int32_t* eg_lo) {
  __shared__ uint32_t idx[LB_TILE];
  __shared__ int32_t warp_sum[LB_THREADS / 32];
  __shared__ int64_t warp_min[LB_THREADS / 32];
  __shared__ int64_t tile_off;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t start = *count;
  const int64_t i0 = static_cast<int64_t>(tile) * LB_TILE +
                     threadIdx.x * static_cast<int64_t>(LB_ITEMS);
  uint32_t m = 0;
  if ((reinterpret_cast<uintptr_t>(valid) & 15) == 0 && i0 + LB_ITEMS <= n) {
    const int4* v = reinterpret_cast<const int4*>(valid + i0);
    int4 w[LB_ITEMS / 4];
#pragma unroll
    for (int u = 0; u < LB_ITEMS / 4; ++u) w[u] = __ldg(v + u);
#pragma unroll
    for (int u = 0; u < LB_ITEMS / 4; ++u)
      m |= ((w[u].x != 0) | (w[u].y != 0) << 1 | (w[u].z != 0) << 2 |
            (w[u].w != 0) << 3) << (4 * u);
  } else {
    for (int u = 0; u < LB_ITEMS; ++u)
      if (i0 + u < n && __ldg(valid + i0 + u)) m |= 1u << u;
  }
  // the block's exclusive scan of the threads' counts
  const int32_t c = __popc(m);
  int32_t incl = c;
  for (int s = 1; s < 32; s <<= 1) {
    const int32_t o = __shfl_up_sync(FULL, incl, s);
    if (lane >= s) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  int64_t tmin = NEVER;
  if (eg_hi) {
    for (uint32_t r = m; r; r &= r - 1) {
      const int64_t* row = src + (i0 + __ffs(r) - 1) * 6;
      if (row[5] == DELIVERED && row[0] < tmin) tmin = row[0];
    }
    for (int s = 16; s > 0; s >>= 1) {
      const int64_t o = __shfl_down_sync(FULL, tmin, s);
      tmin = o < tmin ? o : tmin;
    }
    if (lane == 0) warp_min[warp] = tmin;
  }
  __syncthreads();
  int32_t before = 0, agg = 0;
  for (int w = 0; w < LB_THREADS / 32; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    agg += warp_sum[w];
  }
  const int32_t excl = before + incl - c;
  for (uint32_t r = m, p = excl; r; r &= r - 1)
    idx[p++] = static_cast<uint32_t>(i0 + __ffs(r) - 1);
  if (threadIdx.x == 0) {
    if (eg_hi) {
      int64_t bm = NEVER;
      for (int w = 0; w < LB_THREADS / 32; ++w)
        bm = warp_min[w] < bm ? warp_min[w] : bm;
      mins[tile] = bm;  // before the status that announces it
    }
    int64_t off = 0;
    if (tile == 0) {
      publish(status, pack(gen, 2, agg));
    } else {
      publish(status + tile, pack(gen, 1, agg));
      for (int j = tile - 1;; ) {  // look back until an inclusive prefix
        const uint64_t w = observe(status + j);
        if ((w >> 34) != (gen & 0x3fffffffu) || ((w >> 32) & 3) == 0)
          continue;  // tile j has not published in this call yet
        off += static_cast<uint32_t>(w);
        if (((w >> 32) & 3) == 2) break;
        --j;
      }
      publish(status + tile, pack(gen, 2, static_cast<uint32_t>(off + agg)));
    }
    tile_off = off;
    if (tile == gridDim.x - 1) {  // the last tile: the totals
      const int64_t total = off + agg;
      const int64_t room = cap - start > 0 ? cap - start : 0;
      *count = static_cast<int32_t>(start + total);
      *lost += static_cast<int32_t>(total - (total < room ? total : room));
      if (eg_hi) {
        int64_t all = NEVER;
        for (int j = 0; j < static_cast<int>(gridDim.x); ++j) {
          const int64_t v = j == tile ? mins[j]
                                      : *reinterpret_cast<volatile int64_t*>(
                                            mins + j);
          all = v < all ? v : all;
        }
        const int64_t cur =
            *eg_hi == 0x7fffffff ? NEVER
                                 : (static_cast<int64_t>(*eg_hi) << 31) | *eg_lo;
        if (all < cur) {
          *eg_hi = static_cast<int32_t>(all >> 31);
          *eg_lo = static_cast<int32_t>(all & 0x7fffffff);
        }
      }
    }
  }
  __syncthreads();
  // the tile's rows to dst from start + its offset, three 16-byte pieces a
  // row, the block's threads on consecutive pieces
  const int64_t pos = start + tile_off;
  const int64_t room = cap - pos;
  const int kept = room <= 0 ? 0 : agg < room ? agg : static_cast<int>(room);
  const longlong2* s2 = reinterpret_cast<const longlong2*>(src);
  longlong2* d2 = reinterpret_cast<longlong2*>(dst);
  for (int q = threadIdx.x; q < 3 * kept; q += LB_THREADS) {
    const int j = q / 3, w = q - 3 * j;
    d2[(pos + j) * 3 + w] = s2[static_cast<int64_t>(idx[j]) * 3 + w];
  }
}

}  // namespace

extern "C" {

// Per launch, over `reps` launches of the empty kernel (grid `blocks`,
// 1,024 threads, `smem` bytes of dynamic shared memory) queued behind a
// spin kernel: the host's time to enqueue (ns) and the device's time to
// run them back to back (ns).  form 0: <<<>>>; 1: cudaLaunchKernelEx; 2:
// cudaLaunchKernelEx with clusters of `cluster` blocks.
int probe_launch(int form, int reps, int blocks, int cluster, int smem,
                 double* host_ns, double* dev_ns) {
  cudaError_t err = cudaFuncSetAttribute(
      empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Fat f = {};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = form == 2 ? attr : nullptr;
  cfg.numAttrs = form == 2 ? 1 : 0;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int pass = 0; pass < 2; ++pass) {  // the first warms up
    cudaDeviceSynchronize();
    spin_kernel<<<1, 1>>>(static_cast<int64_t>(reps) * 20000);
    cudaEventRecord(a, 0);
    const auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r) {
      if (form == 0)
        empty_kernel<<<blocks, 1024, smem>>>(f);
      else
        err = cudaLaunchKernelEx(&cfg, empty_kernel, f);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const auto t1 = std::chrono::steady_clock::now();
    cudaEventRecord(b, 0);
    err = cudaEventSynchronize(b);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    *host_ns =
        std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
    *dev_ns = static_cast<double>(ms) * 1e6 / reps;
  }
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return 0;
}

// The tiles lookback_rows takes for `n` flags (its status and minimum
// arrays' length).
int64_t lookback_tiles(int64_t n) { return n > 0 ? (n + LB_TILE - 1) / LB_TILE : 1; }

// One instance of D as a look-back scan on `stream`; eg_hi null for the
// log (no minimum).  `gen` must differ from the last call's on `status`
// and not be 0 (the status words start zeroed).
int lookback_rows(const int32_t* valid, int64_t n, const int64_t* src,
                  int64_t* dst, int32_t* count, int32_t* lost, int64_t cap,
                  uint64_t* status, int64_t* mins, uint32_t gen,
                  int32_t* eg_hi, int32_t* eg_lo, void* stream) {
  lookback_kernel<<<static_cast<unsigned>(lookback_tiles(n)), LB_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      valid, n, src, dst, count, lost, cap, status, mins, gen, eg_hi, eg_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
