// Exact 3-D nearest neighbour by squared L2 (the ICP correspondence search).
//
// Replaces rtabmap_tpu/ops/pallas/nn3d.py::pallas_nn3d (the TPU kernel behind
// ops/icp.py::_nn_blocked). Contract, shared bit for bit with the plain
// PyTorch version (rtabmap_tpu_torch/ops/cuda/nn3d.py::nn3d_reference):
//   d = ((dx*dx + dy*dy) + dz*dz) + pen, dx = qx - bx etc., each operation
//   rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn: nvcc would otherwise
//   contract a*b+c into one FMA); pen = 0 for a valid point, +inf otherwise;
//   the result is the (d, idx) lexicographic minimum: ties go to the lowest
//   index; a query with no valid point gets (+inf, 0); any Q, N >= 1.
//
// What bounds it on an H100: each (query, point) pair costs 8 float32
// operations (3 subtractions, 3 multiplications, 2 additions) with no
// product the tensor cores could take, against 16 bytes a point and 12 a
// query read once. At the ICP shapes (28800 queries against a 2048-point
// local map or a 28800-point scan) the operations dominate by two orders
// of magnitude: the kernel is bound by how fast the CUDA cores issue them.
// This first version keeps one query per thread in registers and streams
// the destination through shared memory as (x, y, z, pen) float4 tiles,
// read by every thread of the block at the same address (a broadcast, no
// bank conflict). Each thread visits its points in increasing index order
// and keeps a running (d, idx) with a strict <. To fill the 132 SMs at
// N = 2048 as well as at N = 28800, the destination is cut into chunks:
// phase 1 writes one partial (d, idx) per (query, chunk) to scratch, phase
// 2 merges the chunks in order. No atomics, so the result does not depend
// on scheduling. Several queries a thread, tensor-core forms of the
// expanded distance and TMA tiles are later work.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kBQ = 128;    // queries per block, one per thread
constexpr int kTile = 512;  // destination points per shared tile

__device__ __forceinline__ float pair_dist2(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  const float xy = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  return __fadd_rn(__fadd_rn(xy, __fmul_rn(dz, dz)), p.w);
}

// Phase 1: block (query tile, destination chunk) -> per-chunk (d, idx) of
// each query; an all-invalid chunk reports (+inf, INT_MAX). With a single
// chunk it writes the outputs directly.
__global__ void __launch_bounds__(kBQ)
nn3d_chunks(const float* __restrict__ src, const float* __restrict__ dst,
            const uint8_t* __restrict__ valid, int Q, int N, int chunk_pts,
            int2* __restrict__ scratch, float* __restrict__ out_d,
            int* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * kBQ + threadIdx.x;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int begin = chunk * chunk_pts;
  const int end = min(begin + chunk_pts, N);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < Q) {
    qx = src[3 * (size_t)q];
    qy = src[3 * (size_t)q + 1];
    qz = src[3 * (size_t)q + 2];
  }
  float best_d = CUDART_INF_F;
  int best_i = INT_MAX;

  for (int base = begin; base < end; base += kTile) {
    const int n = min(kTile, end - base);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < n; e += kBQ) {
      const size_t g = (size_t)base + e;
      tile[e] = make_float4(dst[3 * g], dst[3 * g + 1], dst[3 * g + 2],
                            valid[g] ? 0.f : CUDART_INF_F);
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < n; ++e) {
      const float d = pair_dist2(qx, qy, qz, tile[e]);
      if (d < best_d) {
        best_d = d;
        best_i = base + e;
      }
    }
  }
  if (q >= Q) return;
  if (n_chunks == 1) {
    out_d[q] = best_d;
    out_i[q] = best_i == INT_MAX ? 0 : best_i;
  } else {
    scratch[(size_t)q * n_chunks + chunk] = make_int2(__float_as_int(best_d), best_i);
  }
}

// Phase 2: merge each query's chunks in increasing order. Every index of a
// later chunk is larger, so a strict < keeps the lexicographic minimum.
__global__ void nn3d_merge(const int2* __restrict__ scratch, int Q, int n_chunks,
                           float* __restrict__ out_d, int* __restrict__ out_i) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int2 v = scratch[(size_t)q * n_chunks + c];
    const float d = __int_as_float(v.x);
    if (d < best_d) {
      best_d = d;
      best_i = v.y;
    }
  }
  out_d[q] = best_d;
  out_i[q] = best_i;
}

}  // namespace

extern "C" {

// Block shape the wrapper sizes its chunks by.
int nn3d_block_queries() { return kBQ; }
int nn3d_tile_points() { return kTile; }

// src (Q,3) float32, dst (N,3) float32, valid (N,) bool, all contiguous;
// scratch holds Q*n_chunks int2 (unused when n_chunks == 1); out_d (Q,)
// float32, out_i (Q,) int32. Returns the CUDA error code of the launches
// (0 = success). Enqueues on `stream`.
int nn3d(const void* src, const void* dst, const void* valid, int Q, int N,
         int chunk_pts, int n_chunks, void* scratch, void* out_d, void* out_i,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((Q + kBQ - 1) / kBQ, n_chunks);
  nn3d_chunks<<<grid1, kBQ, 0, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(dst),
      static_cast<const uint8_t*>(valid), Q, N, chunk_pts,
      static_cast<int2*>(scratch), static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  nn3d_merge<<<(Q + 255) / 256, 256, 0, s>>>(
      static_cast<const int2*>(scratch), Q, n_chunks,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

const char* nn3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
