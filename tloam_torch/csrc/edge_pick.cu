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
// the masks equal the plain PyTorch version bit for bit.
//
// Bound on an H100: the kernel reads R*W*16 B (x, y, z, valid) and writes
// R*W*6 B (edge, picked, curvature): 3.2 MB at R=64, W=2304, about 1 us at
// 3.35 TB/s. Its real limiter is latency: 20 dependent rounds, each a
// block-wide argmax (warp shuffles + one shared-memory pass) and two
// barriers. Every round's state lives in shared memory (about 20 KB at
// W=4096), so nothing but the inputs and outputs touches device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 4096;
constexpr int kMaxSectors = 8;

struct Best {
  float v;
  int c;
};

__device__ __forceinline__ bool better(float v, int c, float bv, int bc) {
  // higher curvature wins; a tie goes to the lower column (jnp.argmax)
  return v > bv || (v == bv && c < bc);
}

__global__ void __launch_bounds__(kThreads)
edge_pick_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ zs, const float* __restrict__ vs,
                 const int* __restrict__ ring_len, uint8_t* __restrict__ edge_out,
                 uint8_t* __restrict__ picked_out, float* __restrict__ curv_out,
                 int W, int num_sectors, int picks_per_sector, float curv_thres,
                 float suppress_gap_sq, int ring_min_num) {
  __shared__ float s_curv[kMaxW];
  __shared__ uint8_t s_gap[kMaxW];
  __shared__ int8_t s_sec[kMaxW];
  __shared__ uint8_t s_avail[kMaxW];
  __shared__ uint8_t s_picked[kMaxW];
  __shared__ uint8_t s_edge[kMaxW];
  __shared__ float s_red_v[kWarps][kMaxSectors];
  __shared__ int s_red_c[kWarps][kMaxSectors];

  const int ring = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)ring * W;
  const float* x = xs + base;
  const float* y = ys + base;
  const float* z = zs + base;
  const float* v = vs + base;
  const int len = ring_len[ring];
  const int total = max(len - 10, 1);

  // ---- geometry pass ----
  for (int j = tid; j < W; j += kThreads) {
    const bool interior =
        (v[j] > 0.5f) && (j >= 5) && (j < len - 5) && (len >= ring_min_num);
    float ax = __fmul_rn(-10.0f, x[j]);
    float ay = __fmul_rn(-10.0f, y[j]);
    float az = __fmul_rn(-10.0f, z[j]);
    for (int k = -5; k <= 5; ++k) {
      if (k == 0) continue;
      int n = j + k;
      n = n < 0 ? n + W : (n >= W ? n - W : n);
      ax = __fadd_rn(ax, x[n]);
      ay = __fadd_rn(ay, y[n]);
      az = __fadd_rn(az, z[n]);
    }
    const float curv =
        __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)), __fmul_rn(az, az));
    const float dcurv = interior ? curv : -1.0f;
    const int nx = j + 1 == W ? 0 : j + 1;
    const float gx = __fsub_rn(x[nx], x[j]);
    const float gy = __fsub_rn(y[nx], y[j]);
    const float gz = __fsub_rn(z[nx], z[j]);
    const float gap =
        __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
    int sec = -1;
    if (interior) {
      sec = (num_sectors * (j - 5)) / total;
      sec = sec < 0 ? 0 : (sec > num_sectors - 1 ? num_sectors - 1 : sec);
    }
    s_curv[j] = dcurv;
    s_gap[j] = gap <= suppress_gap_sq;
    s_sec[j] = (int8_t)sec;
    s_avail[j] = dcurv > -1.0f;
    s_picked[j] = 0;
    s_edge[j] = 0;
  }
  __syncthreads();

  // ---- greedy rounds ----
  for (int round = 0; round < picks_per_sector; ++round) {
    Best b[kMaxSectors];
#pragma unroll
    for (int s = 0; s < kMaxSectors; ++s) b[s] = {-1.0f, 0x7fffffff};
    for (int j = tid; j < W; j += kThreads) {
      const float c = s_curv[j];
      const int s = s_sec[j];
      if (s_avail[j] && c > curv_thres) {
#pragma unroll
        for (int t = 0; t < kMaxSectors; ++t)
          if (t == s && better(c, j, b[t].v, b[t].c)) b[t] = {c, j};
      }
    }
#pragma unroll
    for (int s = 0; s < kMaxSectors; ++s) {
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, b[s].v, off);
        const int oc = __shfl_down_sync(0xffffffffu, b[s].c, off);
        if (better(ov, oc, b[s].v, b[s].c)) b[s] = {ov, oc};
      }
      if (lane == 0) {
        s_red_v[warp][s] = b[s].v;
        s_red_c[warp][s] = b[s].c;
      }
    }
    __syncthreads();
    if (tid < num_sectors) {
      float bv = s_red_v[0][tid];
      int bc = s_red_c[0][tid];
      for (int w = 1; w < kWarps; ++w)
        if (better(s_red_v[w][tid], s_red_c[w][tid], bv, bc)) {
          bv = s_red_v[w][tid];
          bc = s_red_c[w][tid];
        }
      if (bv > 0.0f) {
        s_edge[bc] = 1;
        s_picked[bc] = 1;
        // right chain: column p+1 is suppressed while gap p holds
        for (int k = 0, p = bc; k < 5 && p + 1 < W && s_gap[p]; ++k) s_picked[++p] = 1;
        // left chain: column p-1 is suppressed while gap p-1 holds
        for (int k = 0, p = bc; k < 5 && p - 1 >= 0 && s_gap[p - 1]; ++k) s_picked[--p] = 1;
      }
    }
    __syncthreads();
    for (int j = tid; j < W; j += kThreads)
      if (s_picked[j]) s_avail[j] = 0;
  }
  __syncthreads();

  for (int j = tid; j < W; j += kThreads) {
    edge_out[base + j] = s_edge[j];
    picked_out[base + j] = s_picked[j];
    curv_out[base + j] = s_curv[j];
  }
}

}  // namespace

extern "C" int tloam_edge_pick(const void* x, const void* y, const void* z,
                               const void* valid, const void* ring_len, void* edge,
                               void* picked, void* curvature, int R, int W,
                               int num_sectors, int picks_per_sector, float curv_thres,
                               float suppress_gap_sq, int ring_min_num, void* stream) {
  if (R <= 0 || W <= 0 || W > kMaxW || num_sectors < 1 || num_sectors > kMaxSectors)
    return (int)cudaErrorInvalidValue;
  edge_pick_kernel<<<R, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, (const float*)valid,
      (const int*)ring_len, (uint8_t*)edge, (uint8_t*)picked, (float*)curvature, W,
      num_sectors, picks_per_sector, curv_thres, suppress_gap_sq, ring_min_num);
  return (int)cudaGetLastError();
}
