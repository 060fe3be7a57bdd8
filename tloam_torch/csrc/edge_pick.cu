// Edge greedy-pick rounds on the dense (ring, position) layout.
//
// Replaces the TPU kernel `_pick_rounds_pallas` (tloam_tpu/models/edge.py:166,
// body `_pick_kernel` :102, geometry `_dense_geometry` :57) — the reference's
// extractEdgePoint / extractFromSection (segmentation.cpp:1144-1302).
//
// For every ring (one CTA per ring):
//   * 11-tap smoothness |sum_{k!=0} p_{j+k} - 10 p_j|^2 at interior columns
//     [5, len-5) of rings with len >= ring_min_num (neighbours cyclic mod W,
//     as the reference's lane roll), -1 elsewhere;
//   * squared gap to the next column, gated at <= suppress_gap_sq;
//   * num_sectors sector ids over len-10 (integer division, as edge.py:93-98);
//   * picks_per_sector greedy rounds: every sector takes the first-column
//     argmax of curvature > curv_thres among available columns, marks it an
//     edge and suppresses up to +-5 neighbours while the chained gap holds
//     (never across the row ends). All picks of a round are chosen against
//     the previous round's availability, and all suppressions land before
//     avail &= ~picked (edge.py:124-143).
//
// Exactness: the geometry keeps the reference summation order
// (acc = -10 x_j, then acc += x_{j+k} for k = -5..5 skipping 0;
// curv = ax^2 + ay^2 + az^2) with explicit round-to-nearest intrinsics and
// the file is built with -fmad=false, so no FMA contraction moves a bit and
// the outputs equal the plain PyTorch version bit for bit.
//
// Bound on an H100: the kernel reads R*W*16 B (x, y, z, valid) and writes
// R*W*6 B (edge, picked, curvature): 3.2 MB at R=64, W=2304, about 1 us at
// 3.35 TB/s. It cannot reach that: each ring's rounds are a chain of
// dependent steps (20 on the main path), and 64 CTAs fill half the SMs, so
// it is bound by latency: one trip to device memory to stage the ring, the
// geometry, then the rounds one after another. The design cuts the latency
// of each step:
//
//   1. Staged rows. The CTA copies its ring's x, y, z and valid rows into
//      shared memory with asynchronous copies (cp.async, 16 B where the rows
//      are 16-byte aligned), all in flight at once. Each thread then takes
//      runs of kRun columns with a register window of kRun + 10 columns:
//      3 shared loads a column instead of 33 taps, and the window also
//      gives every gap that the run's +-5 chains cross, so each column's
//      chain lengths are known before any round. 16 warps hide the
//      latency of the geometry's serial sums. Shared memory is dynamic
//      (21 B a column, 86 KB at W = 4096); the host raises the 48 KB cap
//      once per device.
//   2. A warp per sector. A sector is a contiguous column range (the floor
//      division of edge.py:93-98 is monotone in the column), computed in
//      closed form. kRoundWarps / num_sectors warps own each sector, each a
//      contiguous part of it. Once, each warp compacts its part's
//      candidates (curvature > curv_thres and > 0), in column order, into a
//      list of (curvature, stamp) words; a round scans only its list, one
//      64-bit load an entry (four in flight while a lane holds four more).
//   3. One reduction. Positive floats order as their bits, so redux.sync
//      max over the bits, then min over the list slots of the lanes that
//      hold it, gives the winner, first column on a tie, in every lane:
//      2 instructions, with no shuffle chain and no cross-warp pass. A
//      sector of several warps (num_sectors <= 4) combines its warps'
//      winners behind a named barrier of that group.
//   4. Parallel suppression. Lanes 0-10 mark the winner's +-5 window at
//      once, from the chain lengths of step 1.
//   5. One block barrier a round (there were three). Availability is a
//      round stamp in each list entry: the first round that picked or
//      suppressed the column (~0u: none); round r sees an entry available
//      iff its stamp >= r. A round-r mark is atomicMin(stamp, r): a round-r
//      scan of any warp reads r as available whether the mark lands before
//      or after its read, and a mark never raises an earlier round's stamp.
//      The one barrier between round r's marks and round r+1's scans makes
//      every round-r mark visible to every round-(r+1) scan, and no warp
//      marks round r+1 before every warp has finished scanning round r.
//      (Marks reach a neighbour's list through a column -> slot map, so one
//      more barrier, once, separates the compaction from round 0.) The
//      round's barrier is __syncthreads_or over "picked this round": a
//      round with no pick leaves the state as it was, so the loop ends.
//   6. No conversion kernels. edge and picked are written as 0/1 bytes
//      straight into torch.bool tensors. Rings shorter than ring_min_num
//      write their constant outputs and return before staging.
//
// What is left (PERF.md): the rounds take about 60% of the time, each a
// chain of shared-memory loads, two redux.sync, the marks and the barrier.
//
// Grid: one CTA of 512 threads per ring. A cluster per ring was not tried:
// a ring fits one SM's shared memory, and the +-5 halo never leaves the CTA.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kRoundWarps = 8;  // warps that own sectors in the rounds
constexpr int kMaxW = 4096;
constexpr int kMaxSectors = kRoundWarps;
constexpr int kRun = 5;  // columns a geometry run; odd, so lanes hit distinct banks
constexpr int kWin = kRun + 10;
constexpr unsigned kNever = 0xffffffffu;  // stamp of a column never marked
constexpr unsigned kFull = 0xffffffffu;
constexpr uint16_t kNoSlot = 0xffff;

// Dynamic shared memory per column: x, y, z and valid as staged (f32; after
// the geometry the lists reuse x and y, their columns z, the curvature
// valid), the chain lengths (u8), the column's list slot (u16), the picked
// and edge flags (u8).
__host__ __device__ constexpr int padded(int W) { return (W + 15) & ~15; }
__host__ __device__ constexpr int smem_bytes(int W) { return padded(W) * (4 * 4 + 1 + 2 + 1 + 1); }

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ int wrap(int n, int W) {
  n %= W;
  return n < 0 ? n + W : n;
}

// -10 p_j, then p_{j-5} .. p_{j+5} skipping j, in the reference's order;
// w[t + 5] is column j
__device__ __forceinline__ float tap_sum(const float (&w)[kWin], int t) {
  float a = __fmul_rn(-10.0f, w[t + 5]);
#pragma unroll
  for (int k = 0; k < 11; ++k)
    if (k != 5) a = __fadd_rn(a, w[t + k]);
  return a;
}

__device__ __forceinline__ bool better(unsigned k, unsigned p, unsigned bk, unsigned bp) {
  return k > bk || (k == bk && p < bp);
}

__global__ void __launch_bounds__(kThreads)
edge_pick_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ zs, const float* __restrict__ vs,
                 const int* __restrict__ ring_len, uint8_t* __restrict__ edge_out,
                 uint8_t* __restrict__ picked_out, float* __restrict__ curv_out,
                 int W, int num_sectors, int picks_per_sector, float curv_thres,
                 float suppress_gap_sq, int ring_min_num) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_red_key[kRoundWarps];
  __shared__ unsigned s_red_col[kRoundWarps];

  const int ring = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)ring * W;
  const int len = ring_len[ring];

  if (len < ring_min_num) {  // no interior column: nothing to pick
    for (int j = tid; j < W; j += kThreads) {
      curv_out[base + j] = -1.0f;
      edge_out[base + j] = 0;
      picked_out[base + j] = 0;
    }
    return;
  }

  const int Wp = padded(W);
  float* s_x = reinterpret_cast<float*>(smem);
  float* s_y = s_x + Wp;
  float* s_z = s_y + Wp;
  float* s_v = s_z + Wp;
  uint8_t* s_chain = reinterpret_cast<uint8_t*>(s_v + Wp);  // right << 3 | left
  uint16_t* s_slot = reinterpret_cast<uint16_t*>(s_chain + Wp);
  uint8_t* s_picked = reinterpret_cast<uint8_t*>(s_slot + Wp);
  uint8_t* s_edge = s_picked + Wp;
  // after the geometry:
  float* s_curv = s_v;  // a thread overwrites only the valid flags it read
  unsigned long long* s_list = reinterpret_cast<unsigned long long*>(s_x);  // curvature << 32 | stamp
  unsigned* s_col = reinterpret_cast<unsigned*>(s_z);  // column << 6 | chains, by slot

  // ---- 1. stage the ring's rows: every copy in flight at once ----
  {
    const float* src[4] = {xs + base, ys + base, zs + base, vs + base};
    float* dst[4] = {s_x, s_y, s_z, s_v};
    const bool vec = (W % 4 == 0) &&
                     ((reinterpret_cast<uintptr_t>(src[0]) | reinterpret_cast<uintptr_t>(src[1]) |
                       reinterpret_cast<uintptr_t>(src[2]) | reinterpret_cast<uintptr_t>(src[3])) & 15) == 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (vec)
        for (int i = tid; i < W / 4; i += kThreads) cp_async16(dst[a] + 4 * i, src[a] + 4 * i);
      else
        for (int j = tid; j < W; j += kThreads) cp_async4(dst[a] + j, src[a] + j);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __syncthreads();

  // ---- geometry: runs of kRun columns, window w[k] = column j0 - 5 + k ----
  for (int j0 = tid * kRun; j0 < W; j0 += kThreads * kRun) {
    float wx[kWin], wy[kWin], wz[kWin];
    const bool inside = j0 >= 5 && j0 + kWin - 5 <= W;  // else the window wraps
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const int n = inside ? j0 - 5 + k : wrap(j0 - 5 + k, W);
      wx[k] = s_x[n];
      wy[k] = s_y[n];
      wz[k] = s_z[n];
    }
    // bit k: a chain may step over gap p = j0 - 5 + k (p >= 0, p + 1 < W,
    // squared gap to the next column within the gate)
    unsigned links = 0;
#pragma unroll
    for (int k = 0; k < kWin - 1; ++k) {
      const int p = j0 - 5 + k;
      const float gx = __fsub_rn(wx[k + 1], wx[k]);
      const float gy = __fsub_rn(wy[k + 1], wy[k]);
      const float gz = __fsub_rn(wz[k + 1], wz[k]);
      const float gap =
          __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
      if (p >= 0 && p + 1 < W && gap <= suppress_gap_sq) links |= 1u << k;
    }
#pragma unroll
    for (int t = 0; t < kRun; ++t) {
      const int j = j0 + t;
      if (j >= W) break;
      const bool interior = (s_v[j] > 0.5f) && (j >= 5) && (j < len - 5);
      float dcurv = -1.0f;
      if (interior) {
        const float ax = tap_sum(wx, t), ay = tap_sum(wy, t), az = tap_sum(wz, t);
        dcurv = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)), __fmul_rn(az, az));
      }
      // right chain: gaps j .. j+4 (bits t+5 ..); left chain: gaps j-1 down
      // to j-5 (bits t+4 down to t)
      const int nr = __ffs(~((links >> (t + 5)) & 0x1fu)) - 1;
      const int nl = __clz(~(((links >> t) & 0x1fu) << 27));
      s_curv[j] = dcurv;
      s_chain[j] = (uint8_t)(nr << 3 | nl);
      s_slot[j] = kNoSlot;
      s_picked[j] = 0;
      s_edge[j] = 0;
    }
  }
  __syncthreads();

  // ---- 2. sectors: sec(j) = floor(ns (j-5) / total) >= s  <=>
  //         j >= 5 + ceil(s total / ns), over the interior [5, min(len-5, W));
  //         warp g of a sector's wps warps owns the g-th part of it ----
  const int wps = kRoundWarps / num_sectors;  // warps per sector
  const int sector = warp / wps;              // >= num_sectors: idle in the rounds
  const int gw = warp % wps;
  const bool active = sector < num_sectors;
  int first = 0, n_cand = 0;
  if (active) {
    const long long total = len - 10 > 1 ? len - 10 : 1;
    const int lo = 5 + (int)((sector * total + num_sectors - 1) / num_sectors);
    const int hi = min(5 + (int)(((sector + 1) * total + num_sectors - 1) / num_sectors),
                       min(len - 5, W));
    const int part = hi > lo ? (hi - lo + wps - 1) / wps : 0;
    first = lo + gw * part;
    const int last = min(first + part, hi);
    // compact the candidates, in column order, into slots first, first+1, ...
    // (the lists overwrite x, y and z, which nothing reads any more)
    const unsigned below = (1u << lane) - 1;
    for (int c0 = first; c0 < last; c0 += 64) {  // two chunks of 32 columns
      float v[2];
      unsigned chain[2], m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = c0 + 32 * h + lane;
        v[h] = j < last ? s_curv[j] : -1.0f;
        chain[h] = j < last ? s_chain[j] : 0u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = c0 + 32 * h + lane;
        const bool cand = v[h] > curv_thres && v[h] > 0.0f;  // a pick needs max > 0
        m[h] = __ballot_sync(kFull, cand);
        if (cand) {
          const int slot = first + n_cand + __popc(m[h] & below);
          s_list[slot] = (unsigned long long)__float_as_uint(v[h]) << 32 | kNever;
          s_col[slot] = (unsigned)j << 6 | chain[h];
          s_slot[j] = (uint16_t)slot;
        }
        n_cand += __popc(m[h]);
      }
    }
  }
  if (warp >= kRoundWarps)  // warps that own no sector store the curvature meanwhile
    for (int j = tid - kRoundWarps * 32; j < W; j += kThreads - kRoundWarps * 32)
      curv_out[base + j] = s_curv[j];
  __syncthreads();  // every slot is mapped before any round marks

  // ---- greedy rounds ----
  for (int r = 0; r < picks_per_sector; ++r) {
    unsigned key = 0, col = kNever;  // key 0: nothing to pick
    if (active) {
      // a lane's slots rise in column, so a strict > keeps the first max
      unsigned slot = kNever;
      int i = lane;
      for (; i + 96 < n_cand; i += 128) {  // four loads in flight
        unsigned long long e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) e[u] = s_list[first + i + 32 * u];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned k = (unsigned)(e[u] >> 32);
          if (k > key && (unsigned)e[u] >= (unsigned)r) {
            key = k;
            slot = i + 32 * u;
          }
        }
      }
      for (; i < n_cand; i += 32) {
        const unsigned long long e = s_list[first + i];
        const unsigned k = (unsigned)(e >> 32);
        if (k > key && (unsigned)e >= (unsigned)r) {
          key = k;
          slot = i;
        }
      }
      // 3. higher curvature wins, then the lower slot, which is the lower
      //    column (jnp.argmax)
      const unsigned best = __reduce_max_sync(kFull, key);
      slot = __reduce_min_sync(kFull, key == best ? slot : kNever);
      key = best;
      if (key != 0) col = s_col[first + slot];
      if (wps > 1) {
        // s_red is rewritten only after the block barrier that ends the round
        if (lane == 0) {
          s_red_key[warp] = key;
          s_red_col[warp] = col;
        }
        group_barrier(1 + sector, wps * 32);
        for (int w = sector * wps; w < (sector + 1) * wps; ++w)
          if (better(s_red_key[w], s_red_col[w], key, col)) {
            key = s_red_key[w];
            col = s_red_col[w];
          }
      }
    }
    // 4. the sector's first warp marks the pick and its chains (uniform in
    //    the warp: every lane holds the winner)
    const bool mark = active && gw == 0 && key != 0;
    if (mark) {
      const int c = (int)(col >> 6), nr = (int)(col >> 3) & 7, nl = (int)col & 7;
      const int o = lane - 5;
      if (lane <= 10 && (o > 0 ? o <= nr : -o <= nl)) {
        const int p = c + o;
        s_picked[p] = 1;
        const unsigned slot = s_slot[p];
        if (slot != kNoSlot)  // the stamp is the entry's low word
          atomicMin(reinterpret_cast<unsigned*>(s_list + slot), (unsigned)r);
      }
      if (o == 0) s_edge[c] = 1;
    }
    // 5. the round's one block barrier; a round with no pick ends the loop
    if (!__syncthreads_or(mark && lane == 5)) break;
  }

  // ---- 6. outputs (the last barrier followed every mark) ----
  for (int j = tid; j < W; j += kThreads) {
    edge_out[base + j] = s_edge[j];
    picked_out[base + j] = s_picked[j];
  }
}

// bit d: the 48 KB cap on dynamic shared memory is raised on device d
std::atomic<unsigned long long> g_smem_ready{0};

}  // namespace

extern "C" int tloam_edge_pick_smem_bytes(int W) { return smem_bytes(W); }

extern "C" int tloam_edge_pick(const void* x, const void* y, const void* z,
                               const void* valid, const void* ring_len, void* edge,
                               void* picked, void* curvature, int R, int W,
                               int num_sectors, int picks_per_sector, float curv_thres,
                               float suppress_gap_sq, int ring_min_num, void* stream) {
  if (R <= 0 || W <= 0 || W > kMaxW || num_sectors < 1 || num_sectors > kMaxSectors)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(W);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(g_smem_ready.load() & bit)) {
      err = cudaFuncSetAttribute(edge_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes(kMaxW));
      if (err != cudaSuccess) return (int)err;
      g_smem_ready.fetch_or(bit);
    }
  }
  edge_pick_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, (const float*)valid,
      (const int*)ring_len, (uint8_t*)edge, (uint8_t*)picked, (float*)curvature, W,
      num_sectors, picks_per_sector, curv_thres, suppress_gap_sq, ring_min_num);
  return (int)cudaGetLastError();
}
