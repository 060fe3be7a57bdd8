// The hash-grid kNN's candidate search: `query_knn` (tloam_torch/ops/voxel.py)
// on a CUDA tensor.
//
// It replaces no TPU kernel. The JAX package's query_knn
// (tloam_tpu/ops/voxel.py:531) is plain XLA, and so is the port's plain
// version `_query_block`: for each query it probes the 27 cells of its
// window in the direct table, gathers 27 x C candidate points (C =
// max_per_cell) into a (F, q, 27C, 3) tensor, masks them, and sorts each
// row of 27C distances with a stable sort. At the batched GICP solve's
// covariance call (64 frames of 25,600 queries, k = 11, C = 8) that writes
// and reads back about 4.2 GB of candidates and 2.8 GB of bucket rows and
// sorts 1.64M rows of 216: the gathers and the sort were 43-47% of the
// device time of the kNN and GICP batch cells (PERF.md §5).
//
// What it computes, exactly as _query_block does, for every query (f, q):
// candidate j = o*C + c (o the window offset in voxel._OFFS order, c < C)
// is slot min(start_o + c, M - 1) of frame f, with start_o = payload >> 8
// and count_o = payload & 255 of the window cell's direct-table entry (the
// sum of the payloads of the bucket's slots whose check code matches; 0
// where none does). It is ok where the cell was found, c < min(count_o, C),
// its squared distance ((dx*dx + dy*dy) + dz*dz) <= r*r and the query is
// valid; masked = dist_sq where ok, else FLT_MAX. The outputs are the k
// smallest (masked, j) pairs in lexicographic order, which is the order a
// stable sort of masked gives: idx = src_idx[f, slot], dist = masked, ok.
// Where fewer than k candidates are ok, the rest are the lowest-j others.
//
// Exactness. Each product and sum is rounded alone (__fsub_rn, __fmul_rn,
// __fadd_rn; the file is built with -fmad=false), as PyTorch's separate
// elementwise operations round them; r*r comes rounded to float32 from the
// wrapper; the query's cell comes from PyTorch (voxel._cell_coords), so it
// lands where the plain version's does. Hashes wrap in 32 bits, as
// voxel.wrap_i32 does. So every output slot equals the plain version's bit
// for bit, the slots that are not ok included. A frame holds at most 2^20
// slots (the wrapper checks), so no sum of a bucket's payloads is negative.
//
// Bound on an H100, at the covariance call: from device memory a call reads
// each query's point, cell and flag (25 B) and writes k x 13 B of outputs,
// about 0.28 GB at k = 11: 0.08 ms at 3.35 TB/s. One frame's direct table
// and points stay in the 50 MB L2; through it a query reads 27 check rows
// of 32 B, the payloads of its hits and at most 27C points of 12 B, about
// 7 GB a call at C = 8, of the order of 1 ms. So latency and L2 traffic
// bound it, not HBM.
//
// Design: one warp a query. Lanes 0-26 each probe one window cell (two
// 16-byte loads of the bucket's check codes, then the payloads of the
// hits). The 27C candidates are dealt to the lanes in j order; a lane
// loads a point only for a candidate of a found cell within its count, and
// keeps its K smallest keys in a sorted list in registers, each key the
// (masked, j, ok) triple packed into one 64-bit word that orders as
// (masked, j). The warp then merges the lists in k rounds of a shuffle-min,
// and lane t writes the t-th neighbour. K is a template (1, 2, 4, 8, 16,
// 32): the smallest that holds min(k, the candidates a lane sees). No
// candidate tensor is written and nothing is sorted.
//
// The callers' k, all within the 32 lanes: 1 (the sphere family and GICP's
// planar and ground matches each round; cloud_ops.point_cloud_distance), 2
// (cloud_ops.nearest_neighbor_distance), 5 (the kNN mode's planar, ground
// and edge fits, GICP's edges), 11 (GICP's covariances, k_corr + 1), 20
// (the exact PCA, FeatureConfig.k), and cloud_ops' own: at least 8
// (remove_radius_outliers), at least 16 (cluster_dbscan), 30
// (estimate_normals' max_nn) and nb_neighbors + 1; the wrapper raises above
// 32.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarps = 8;  // queries a block of 256 threads
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSentinel = 0x7fffffff;  // voxel._SENTINEL: an empty table slot
constexpr unsigned long long kEmpty = ~0ull;  // above every key
constexpr int kMaxK = 32;  // one neighbour a lane

// voxel._P1-_P3 (the cell key), _Q1-_Q3 (the second hash) and _CHECK_MIX
constexpr unsigned kP1 = 73856093u, kP2 = 19349663u, kP3 = 83492791u;
constexpr unsigned kQ1 = 0x1E3779B1u, kQ2 = 0x05EBCA77u, kQ3 = 0x42B2AE3Du;
constexpr unsigned kCheckMix = 0x1E3779B1u;

// (masked, j, ok) -> one key: masked >= +0 (or FLT_MAX), whose bits order
// as the floats do, above j, above the ok bit
__device__ __forceinline__ unsigned long long pack(float masked, int j, bool ok) {
  return ((unsigned long long)__float_as_uint(masked) << 32) | ((unsigned)j << 1) | (unsigned)ok;
}

template <int K>
__device__ __forceinline__ void insert(unsigned long long (&list)[K], unsigned long long x) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const unsigned long long lo = x < list[i] ? x : list[i];
    x = x < list[i] ? list[i] : x;
    list[i] = lo;
  }
}

// the kernel's inputs and outputs, (F, ...) contiguous
struct Args {
  const float* pts;          // (F, M, 3)
  const long long* src_idx;  // (F, M)
  const int* check;          // (F, B, 8), 16-byte aligned
  const int* payload;        // (F, B, 8)
  const float* queries;      // (F, Q, 3)
  const uint8_t* qvalid;     // (F, Q)
  const int* qcell;          // (F, Q, 3)
  long long* idx;            // (F, Q, k)
  float* dist;               // (F, Q, k)
  uint8_t* ok;               // (F, Q, k)
  int F, M, B, Q, k, C;
  float rr;                  // r*r rounded to float32
};

template <int K>
__global__ void __launch_bounds__(kWarps * 32) knn_window_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long query = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (query >= (long long)a.F * a.Q) return;  // the whole warp
  const int f = (int)(query / a.Q), M = a.M, C = a.C;
  const long long frame = (long long)f * M;

  // 1. lane o < 27 probes window cell o (voxel._OFFS: x, then y, then z)
  int start = 0, count = 0;
  if (lane < 27) {
    const int* qc = a.qcell + query * 3;
    const unsigned x = (unsigned)qc[0] + (unsigned)(lane / 9 - 1);
    const unsigned y = (unsigned)qc[1] + (unsigned)(lane / 3 % 3 - 1);
    const unsigned z = (unsigned)qc[2] + (unsigned)(lane % 3 - 1);
    const unsigned h1 = x * kP1 + y * kP2 + z * kP3;
    const unsigned h2 = x * kQ1 + y * kQ2 + z * kQ3;
    int code = (int)(h2 + h1 * kCheckMix);
    if (code == kSentinel) code = kSentinel - 1;
    const long long row = ((long long)f * a.B + (h1 & (unsigned)(a.B - 1))) * 8;
    const int4 lo = reinterpret_cast<const int4*>(a.check + row)[0];
    const int4 hi = reinterpret_cast<const int4*>(a.check + row)[1];
    const int codes[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    bool found = false;
    unsigned pay = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (codes[s] == code) {
        found = true;
        pay += (unsigned)a.payload[row + s];
      }
    }
    if (found) {
      start = (int)pay >> 8;
      count = min((int)(pay & 255u), C);
    }
  }

  // 2. candidate j = r*32 + lane; every lane runs every round (shuffles)
  const bool valid = a.qvalid[query] != 0;
  const float* q = a.queries + query * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  unsigned long long list[K];
#pragma unroll
  for (int i = 0; i < K; ++i) list[i] = kEmpty;
  const int total = 27 * C;
  for (int r = 0; r < (total + 31) / 32; ++r) {
    const int j = r * 32 + lane;
    const int o = j / C, c = j - o * C;
    const int so = __shfl_sync(kAll, start, o & 31);
    const int no = __shfl_sync(kAll, count, o & 31);
    if (j >= total) continue;
    float masked = FLT_MAX;
    bool ok = false;
    if (valid && c < no) {
      const float* p = a.pts + (frame + min(so + c, M - 1)) * 3;
      const float dx = __fsub_rn(p[0], qx), dy = __fsub_rn(p[1], qy), dz = __fsub_rn(p[2], qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      ok = d <= a.rr;
      if (ok) masked = d;
    }
    insert(list, pack(masked, j, ok));
  }

  // 3. k rounds: the warp's least head goes to lane t, its lane pops it
  unsigned long long mine = kEmpty;
  for (int t = 0; t < a.k; ++t) {
    unsigned long long m = list[0];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kAll, m, s);
      m = other < m ? other : m;
    }
    if (list[0] == m) {
#pragma unroll
      for (int i = 0; i + 1 < K; ++i) list[i] = list[i + 1];
      list[K - 1] = kEmpty;
    }
    if (lane == t) mine = m;
  }

  const unsigned low = (unsigned)mine;
  const int j = (int)(low >> 1);
  const int o = j / C, c = j - o * C;
  const int so = __shfl_sync(kAll, start, o & 31);
  if (lane < a.k) {
    const long long at = query * a.k + lane;
    a.idx[at] = a.src_idx[frame + min(so + c, M - 1)];
    a.dist[at] = __uint_as_float((unsigned)(mine >> 32));
    a.ok[at] = (uint8_t)(low & 1u);
  }
}

}  // namespace

// k neighbours of each of F*Q queries into idx (int64), dist (float32) and
// ok (bool), each (F, Q, k) contiguous; 1 <= k <= min(32, 27*C).
extern "C" int tloam_knn_window(const void* pts, const void* src_idx, const void* check,
                                const void* payload, const void* queries, const void* qvalid,
                                const void* qcell, void* idx, void* dist, void* ok, int F, int M,
                                int B, int Q, int k, int C, float rr, void* stream) {
  if (F < 0 || Q < 0 || M < 1 || M > (1 << 20) || B < 1 || (B & (B - 1)) != 0 || C < 1 ||
      C > (1 << 20) || k < 1 || k > kMaxK || k > 27 * C)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)F * Q;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)pts, (const long long*)src_idx, (const int*)check, (const int*)payload,
               (const float*)queries, (const uint8_t*)qvalid, (const int*)qcell, (long long*)idx,
               (float*)dist, (uint8_t*)ok, F, M, B, Q, k, C, rr};
  const int rounds = (27 * C + 31) / 32;
  const int seen = k < rounds ? k : rounds;  // the most a lane's list must hold
  const dim3 grid((unsigned)blocks), block(kWarps * 32);
  const auto s = (cudaStream_t)stream;
  if (seen <= 1) knn_window_kernel<1><<<grid, block, 0, s>>>(a);
  else if (seen <= 2) knn_window_kernel<2><<<grid, block, 0, s>>>(a);
  else if (seen <= 4) knn_window_kernel<4><<<grid, block, 0, s>>>(a);
  else if (seen <= 8) knn_window_kernel<8><<<grid, block, 0, s>>>(a);
  else if (seen <= 16) knn_window_kernel<16><<<grid, block, 0, s>>>(a);
  else knn_window_kernel<32><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
