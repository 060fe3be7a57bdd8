// Per-cell moment records of a Morton-block cell store: the accumulation
// step of `block_window_moments` (tloam_torch/ops/voxel.py).
//
// It replaces no TPU kernel. The JAX package sums these records with an
// XLA scatter-add (tloam_tpu/ops/voxel.py:877, `block_window_moments`), and
// the port's plain version with an accumulating `index_put_`. On the card
// that `index_put_` sorts all F*n row indices and then walks each run of
// equal indices serially, one thread a column. Every point in no cell goes
// to one drop row, so all the padding slots of a batch form one run of
// hundreds of thousands of entries, summed one at a time: 45% of the
// device time of a batched solve at F = 64 (PERF.md §5).
//
// What it computes, for every store row r that some point's cell maps to
// (row cell_store[f, v] + f*V*8 of the (F*V*8 + 8, 16) store, which the
// caller zero-fills): lanes 0-9 are the sums over the points p of r, in
// input order, of (1, q, q q^T upper triangle) with q = p - anchor and
// anchor = (cx, cy, cz) * cell_size of the point's cell row; lanes 10-15
// stay 0. A point counts where valid[f, p] and point_cell[f, p] >= 0.
// xyz, valid and the table's per-point and per-row tensors are contiguous;
// cx, cy, cz may be columns of one array (one stride for all three).
//
// Exactness. The sums run serially, in input order, in float32, from +0:
// ((0 + v1) + v2) + ..., with explicit round-to-nearest intrinsics, and the
// file is built with -fmad=false. That is the order and the arithmetic of
// the accumulating `index_put_` (a stable sort of the row indices, then a
// serial sum of each run), so the store equals the plain version's bit for
// bit on the card, and every run repeats it. No float atomics: their order
// changes from run to run, and the solve carries that noise.
//
// Design. build_block_table already sorts each frame's points stably by
// cell key (BlockTable.point_order); in that order every cell row's points
// form one run, kept in input order, and the rows of one key form one
// group of consecutive runs. One thread per sorted position: the thread at
// the first point of a row's run walks the rest of the row's key group and
// sums the points whose row has its store row; every other thread returns
// after two loads. So there is no second sort, points in no cell are never
// touched, and there is no drop row to sum or to clear.
//
// A cell-key collision (two cells with one hash; tloam_tpu/ops/voxel.py
// sorts the same way) interleaves the cells' points within one key group,
// which splits a cell into several runs, hence several cell rows that share
// one store row. The first row of the group with store row r sums r over
// the group, in sorted order, which within a group is input order; the
// other rows of r write nothing. A row alone in its group ends its walk at
// the first point of the next row. Keys are recomputed from the rows'
// coordinates (voxel._hash_coords, wrapping in 32 bits). A row that holds
// no cell, like a point that is not valid, has the key 0x7fffffff; that
// group (the last of the frame) is walked to the frame's end, since its
// invalid points carry no row.
//
// Bound on an H100, for the batched solve's ground table (64 frames of 8192
// slots, two thirds of them points, 0.5 m cells): the kernel reads each
// slot's order and row index (8 B), each counted point's xyz and valid flag
// (13 B) and each occupied cell's row (17 B), and writes one 64 B record per
// occupied cell: about 30 MB, 9 us at 3.35 TB/s. The caller's zero fill of
// the store (F*V*8 records of 64 B, 268 MB there) costs more than the
// kernel. The kernel is bound by latency: the longest run is a chain of
// dependent loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kNoCellKey = 0x7fffffff;  // the key of an invalid point

__device__ __forceinline__ int cell_key(int x, int y, int z) {
  return (int)((unsigned)x * 73856093u + (unsigned)y * 19349663u + (unsigned)z * 83492791u);
}

// The cell rows of one frame.
struct Rows {
  const int* cx;
  const int* cy;
  const int* cz;
  long long stride;  // elements between rows of cx, cy, cz
  const uint8_t* valid;
  const int* store;

  __device__ int key(int u) const {
    if (!valid[u]) return kNoCellKey;
    const long long o = u * stride;
    return cell_key(cx[o], cy[o], cz[o]);
  }
};

struct Moments {
  float s[10];

  __device__ void add(float x, float y, float z, float ax, float ay, float az) {
    const float qx = __fsub_rn(x, ax), qy = __fsub_rn(y, ay), qz = __fsub_rn(z, az);
    const float v[10] = {1.0f, qx, qy, qz,
                         __fmul_rn(qx, qx), __fmul_rn(qx, qy), __fmul_rn(qx, qz),
                         __fmul_rn(qy, qy), __fmul_rn(qy, qz), __fmul_rn(qz, qz)};
#pragma unroll
    for (int k = 0; k < 10; ++k) s[k] = __fadd_rn(s[k], v[k]);
  }
};

__global__ void __launch_bounds__(kThreads)
window_moments_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
                      const int* __restrict__ point_cell,
                      const int* __restrict__ point_order,
                      const int* cx, const int* cy, const int* cz, long long frame_stride,
                      long long row_stride, const uint8_t* cell_valid, const int* cell_store,
                      float* __restrict__ store, int F, int n, int V, float cell_size) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)F * n) return;
  const int f = (int)(t / n);
  const int i = (int)(t - (long long)f * n);
  const int* order = point_order + (long long)f * n;
  const int* pc = point_cell + (long long)f * n;
  const float* pts = xyz + (long long)f * n * 3;
  const uint8_t* ok = valid + (long long)f * n;

  const int v = pc[order[i]];
  if (v < 0) return;
  if (i > 0 && pc[order[i - 1]] == v) return;  // not the first point of row v's run

  const Rows rows{cx + f * frame_stride, cy + f * frame_stride, cz + f * frame_stride, row_stride,
                  cell_valid + (long long)f * V, cell_store + (long long)f * V};
  const long long o = v * row_stride;
  // the anchor as the plain version forms it: float(cell coord) * cell_size
  const float ax = __fmul_rn((float)rows.cx[o], cell_size);
  const float ay = __fmul_rn((float)rows.cy[o], cell_size);
  const float az = __fmul_rn((float)rows.cz[o], cell_size);
  const int r = rows.store[v];
  const int key = rows.key(v);

  // an earlier row of the key group with the same store row sums it
  for (int u = v - 1; u >= 0 && rows.key(u) == key; --u)
    if (rows.valid[u] && rows.store[u] == r) return;

  Moments m;
#pragma unroll
  for (int k = 0; k < 10; ++k) m.s[k] = 0.0f;
  for (int j = i; j < n; ++j) {
    const int p = order[j];
    const int c = pc[p];
    if (c < 0) {
      if (key == kNoCellKey) continue;  // invalid points of the last group
      break;                            // rows past max_cells: no row of r follows
    }
    if (c != v && rows.key(c) != key) break;  // the next key group
    if (rows.store[c] != r || !ok[p]) continue;
    m.add(pts[p * 3], pts[p * 3 + 1], pts[p * 3 + 2], ax, ay, az);
  }

  float4* rec = reinterpret_cast<float4*>(store + ((long long)f * V * 8 + r) * 16);
  rec[0] = make_float4(m.s[0], m.s[1], m.s[2], m.s[3]);
  rec[1] = make_float4(m.s[4], m.s[5], m.s[6], m.s[7]);
  rec[2] = make_float4(m.s[8], m.s[9], 0.0f, 0.0f);
  rec[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

extern "C" int tloam_window_moments(const void* xyz, const void* valid, const void* point_cell,
                                    const void* point_order, const void* cx, const void* cy,
                                    const void* cz, long long frame_stride, long long row_stride,
                                    const void* cell_valid, const void* cell_store, void* store,
                                    int F, int n, int V, float cell_size, void* stream) {
  if (F < 0 || n < 0 || V < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)F * n;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_moments_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const uint8_t*)valid, (const int*)point_cell, (const int*)point_order,
      (const int*)cx, (const int*)cy, (const int*)cz, frame_stride, row_stride,
      (const uint8_t*)cell_valid, (const int*)cell_store, (float*)store, F, n, V, cell_size);
  return (int)cudaGetLastError();
}
