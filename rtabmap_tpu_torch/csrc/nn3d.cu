// Exact 3-D nearest neighbour by squared L2 (the ICP correspondence search).
//
// Replaces rtabmap_tpu/ops/pallas/nn3d.py::pallas_nn3d (the TPU kernel behind
// ops/icp.py::_nn_blocked). Contract, shared bit for bit with the plain
// PyTorch version (rtabmap_tpu_torch/ops/cuda/nn3d.py::nn3d_reference):
//   d = (dx*dx + dy*dy) + dz*dz, dx = qx - bx etc., each operation rounded
//   on its own (__fsub_rn/__fmul_rn/__fadd_rn: nvcc would otherwise
//   contract a*b+c into one FMA), over the valid destination points only;
//   the result is the (d, idx) lexicographic minimum: ties go to the lowest
//   index; a query with no valid point gets (+inf, 0); a query whose flag
//   is false gets (+inf, 0) and no search; any Q, N >= 1.
//
// What bounds it on an H100: each (valid query, valid point) pair costs 8
// FP32-pipe instructions (3 subtractions, 3 multiplications, 2 additions;
// the contract forbids FMA contraction, so the data-sheet 67 TFLOP/s,
// which counts an FMA as two, gives 33.5e12 of them a second), plus the
// compare and two selects of the running minimum, with no product the
// tensor cores could take, against 16 bytes a point and 12 a query read
// once. At the ICP shapes the instructions dominate by two orders of
// magnitude, so the design spends no instruction on a pair that no caller
// reads:
// - nn3d_compact runs once per destination (once per icp() call): its
//   blocks stream-compact the valid points, in order, into (x, y, z, 0)
//   float4s with their original indices, and partition the query mask
//   into the valid queries, in order, then the masked ones. The two
//   counts stay in device memory; nothing syncs with the host.
// - nn3d_chunks reads the counts, splits the valid work over its grid
//   (the host sizes the grid from Q and N only) and exits where there is
//   none. Each thread holds kR queries in registers, so one shared-memory
//   broadcast of a point serves kR pairs; the destination tiles are
//   double-buffered with cp.async. Each thread visits its points in
//   increasing index order and keeps a running (d, idx) with a strict <.
// - nn3d_merge merges the per-chunk minima of each query in chunk order
//   (no atomics, so nothing depends on scheduling), maps the compacted
//   index back to the original one, and writes (+inf, 0) for the masked
//   queries. Compaction keeps order, so "lowest index wins" still holds.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;   // threads of a search block
constexpr int kR = 4;           // queries a thread
constexpr int kBQ = kThreads * kR;
constexpr int kTile = 256;      // destination points a shared tile
constexpr int kMinChunk = 256;  // fewest points a chunk takes
constexpr int kScanThreads = 256;           // threads of a compaction block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kPer = 8;                      // flags a compaction thread
constexpr int kSeg = kPer * kScanThreads;    // flags a compaction block

__device__ __forceinline__ float pair_dist2(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  const float xy = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  return __fadd_rn(xy, __fmul_rn(dz, dz));
}

// Inclusive prefix sum of one int a thread over the block (kScanThreads
// threads); warp_sums[kScanWarps - 1] then holds the block's total.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kScanWarps; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < kScanWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// The block's total of one int a thread (kScanThreads threads).
__device__ int block_sum(int v, int* warp_sums) {
  block_inclusive_scan(v, warp_sums);
  const int total = warp_sums[kScanWarps - 1];
  __syncthreads();  // warp_sums is reused
  return total;
}

// Blocks [0, point_blocks): dst4[0, np) = the valid points in order, dlist
// = their indices, counts[0] = np. The blocks after them (only with a
// query mask): qlist = the valid queries in order then the masked ones in
// order, counts[1] = nq. Each block takes one segment of kSeg flags, each
// thread kPer consecutive flags of it, so the order is kept; a block first
// counts the valid flags before its segment (and, for the queries, all of
// them), which needs no pass across blocks. Flags of a torch bool tensor
// are bytes 0 or 1.
__global__ void __launch_bounds__(kScanThreads)
nn3d_compact(const float* __restrict__ dst, const uint8_t* __restrict__ dst_valid,
             int N, const uint8_t* __restrict__ src_valid, int Q, int point_blocks,
             float4* __restrict__ dst4, int* __restrict__ dlist,
             int* __restrict__ qlist, int* __restrict__ counts) {
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x;
  const bool points = blockIdx.x < point_blocks;
  const uint8_t* flags = points ? dst_valid : src_valid;
  const int n = points ? N : Q;
  const int seg0 = (points ? blockIdx.x : blockIdx.x - point_blocks) * kSeg;
  int before = 0, all = 0;
  for (int e = tid * kPer; e < n; e += kSeg) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) c += e + k < n ? flags[e + k] : 0;
    all += c;
    if (e < seg0) before += c;
  }
  before = block_sum(before, warp_sums);
  all = block_sum(all, warp_sums);
  if (seg0 == 0 && tid == 0) counts[points ? 0 : 1] = all;

  const int lo = seg0 + tid * kPer;
  bool on[kPer];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    on[k] = lo + k < n && flags[lo + k];
    mine += on[k];
  }
  int pos = before + block_inclusive_scan(mine, warp_sums) - mine;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = lo + k;
    if (points) {
      if (!on[k]) continue;
      dst4[pos] = make_float4(dst[3 * (size_t)e], dst[3 * (size_t)e + 1],
                              dst[3 * (size_t)e + 2], 0.f);
      dlist[pos++] = e;
    } else if (e < n) {
      if (on[k]) qlist[pos++] = e;
      else qlist[all + e - pos] = e;  // e - pos masked queries before e
    }
  }
}

// The split of the valid work, computed alike by both search phases from
// the counts in device memory: qt query tiles of kBQ, n_chunks chunks of
// chunk_pts compacted points, at most `grid` (query tile, chunk) items.
struct Split {
  int nq, np, qt, n_chunks, chunk_pts;
};

__device__ __forceinline__ Split split_work(const int* counts, bool masked, int Q,
                                            int grid) {
  Split s;
  s.np = counts[0];
  s.nq = masked ? counts[1] : Q;
  s.qt = (s.nq + kBQ - 1) / kBQ;
  const int by_points = (s.np + kMinChunk - 1) / kMinChunk;
  s.n_chunks = max(1, min(s.qt > 0 ? grid / s.qt : 1, by_points));
  s.chunk_pts = (s.np + s.n_chunks - 1) / s.n_chunks;
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Phase 1: each (query tile, chunk) item -> per-chunk (d, compacted idx)
// of each valid query in scratch[chunk * nq + j]; an empty chunk reports
// (+inf, INT_MAX). Items are walked grid-stride, query tiles fastest.
__global__ void __launch_bounds__(kThreads)
nn3d_chunks(const float* __restrict__ src, const int* __restrict__ qlist,
            const float4* __restrict__ dst4, const int* __restrict__ counts, int Q,
            int2* __restrict__ scratch) {
  __shared__ __align__(16) float4 tile[2][kTile];
  const Split s = split_work(counts, qlist != nullptr, Q, gridDim.x);
  const int tid = threadIdx.x;
  for (int item = blockIdx.x; item < s.qt * s.n_chunks; item += gridDim.x) {
    const int t = item % s.qt, c = item / s.qt;
    const int begin = c * s.chunk_pts;
    const int end = min(begin + s.chunk_pts, s.np);

    float qx[kR], qy[kR], qz[kR], bd[kR];
    int bi[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int j = t * kBQ + r * kThreads + tid;
      qx[r] = qy[r] = qz[r] = 0.f;
      if (j < s.nq) {
        const size_t q = qlist ? qlist[j] : j;
        qx[r] = src[3 * q];
        qy[r] = src[3 * q + 1];
        qz[r] = src[3 * q + 2];
      }
      bd[r] = CUDART_INF_F;
      bi[r] = INT_MAX;
    }

    const int n_tiles = end > begin ? (end - begin + kTile - 1) / kTile : 0;
    auto issue = [&](int k) {
      const int base = begin + k * kTile;
      const int n = min(kTile, end - base);
      for (int e = tid; e < n; e += kThreads) cp_async16(&tile[k & 1][e], &dst4[base + e]);
      cp_async_commit();
    };
    if (n_tiles > 0) issue(0);
    for (int k = 0; k < n_tiles; ++k) {
      if (k + 1 < n_tiles) {
        issue(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int base = begin + k * kTile;
      const int n = min(kTile, end - base);
      const float4* p = tile[k & 1];
#pragma unroll 4
      for (int e = 0; e < n; ++e) {
        const float4 pt = p[e];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float d = pair_dist2(qx[r], qy[r], qz[r], pt);
          if (d < bd[r]) {
            bd[r] = d;
            bi[r] = base + e;
          }
        }
      }
      __syncthreads();  // the buffer is consumed before it is refilled
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int j = t * kBQ + r * kThreads + tid;
      if (j < s.nq) scratch[(size_t)c * s.nq + j] = make_int2(__float_as_int(bd[r]), bi[r]);
    }
  }
}

// Phase 2: one thread a query position j in [0, Q). A valid query merges
// its chunks in increasing order (every index of a later chunk is larger,
// so a strict < keeps the lexicographic minimum) and maps the compacted
// index back; a masked one gets (+inf, 0).
__global__ void nn3d_merge(const int2* __restrict__ scratch, const int* __restrict__ qlist,
                           const int* __restrict__ dlist, const int* __restrict__ counts,
                           int Q, int grid1, float* __restrict__ out_d,
                           int* __restrict__ out_i) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Q) return;
  const Split s = split_work(counts, qlist != nullptr, Q, grid1);
  const int q = qlist ? qlist[j] : j;
  float best_d = CUDART_INF_F;
  int best = INT_MAX;
  if (j < s.nq) {
    for (int c = 0; c < s.n_chunks; ++c) {
      const int2 v = scratch[(size_t)c * s.nq + j];
      const float d = __int_as_float(v.x);
      if (d < best_d) {
        best_d = d;
        best = v.y;
      }
    }
  }
  out_d[q] = best_d;
  out_i[q] = best == INT_MAX ? 0 : dlist[best];
}

}  // namespace

extern "C" {

// Shapes the wrapper sizes its buffers and grid by.
int nn3d_block_queries() { return kBQ; }
int nn3d_min_chunk() { return kMinChunk; }

// dst (N,3) float32, dst_valid (N,) bool, src_valid (Q,) bool or null;
// dst4 holds N float4, dlist N int32, qlist Q int32 (unused without a
// query mask), counts 2 int32. Returns the CUDA error code of the launch.
int nn3d_compact_launch(const void* dst, const void* dst_valid, int N,
                        const void* src_valid, int Q, void* dst4, void* dlist,
                        void* qlist, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int point_blocks = (N + kSeg - 1) / kSeg;
  const int query_blocks = src_valid ? (Q + kSeg - 1) / kSeg : 0;
  nn3d_compact<<<point_blocks + query_blocks, kScanThreads, 0, s>>>(
      static_cast<const float*>(dst), static_cast<const uint8_t*>(dst_valid), N,
      static_cast<const uint8_t*>(src_valid), Q, point_blocks,
      static_cast<float4*>(dst4), static_cast<int*>(dlist), static_cast<int*>(qlist),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// src (Q,3) float32; qlist/counts/dst4/dlist from nn3d_compact_launch
// (qlist null: every query is valid); `grid` search blocks; scratch holds
// max(grid, ceil(Q/kBQ)) * kBQ int2; out_d (Q,) float32, out_i (Q,) int32.
// Returns the CUDA error code of the launches (0 = success).
int nn3d_search(const void* src, const void* qlist, const void* dst4,
                const void* dlist, const void* counts, int Q, int grid,
                void* scratch, void* out_d, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nn3d_chunks<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(src), static_cast<const int*>(qlist),
      static_cast<const float4*>(dst4), static_cast<const int*>(counts), Q,
      static_cast<int2*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn3d_merge<<<(Q + 255) / 256, 256, 0, s>>>(
      static_cast<const int2*>(scratch), static_cast<const int*>(qlist),
      static_cast<const int*>(dlist), static_cast<const int*>(counts), Q, grid,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

const char* nn3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
