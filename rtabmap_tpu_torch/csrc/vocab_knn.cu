// Exact Hamming 2-NN of +-1 int8 descriptors against the vocabulary slab.
//
// Replaces rtabmap_tpu/ops/pallas/vocab_knn.py::pallas_knn2 (the TPU kernel
// behind VWDictionary quantization). Contract, shared bit for bit with the
// plain PyTorch version (rtabmap_tpu_torch/ops/matching.py::knn_blocked):
//   dist = (256 - sum q*s) / 2, exact in int32, returned as float32;
//   invalid words are excluded; a missing neighbour reads (1e9, idx 0);
//   ranks follow the (dist, idx) lexicographic order.
//
// What bounds it on an H100: the work is 2*Q*W*256 int8 operations against
// one read of the W*256-byte slab. At the main path's shape (Q=400,
// W=262144) both bounds are a few tens of microseconds (dense int8 tensor
// rate; 3.35 TB/s for the 67 MB slab), so the kernel is bound by how fast
// it issues the products. This first version stays on the CUDA cores:
// __dp4a over packed int8x4 words, a 4x4 register tile of (query, row) dot
// products per thread, both operand tiles staged k-major in shared memory
// (padded stride: conflict-free stores and reads). The grid runs query
// tiles fastest so the blocks sharing a slab chunk are resident together
// and read it once from L2. No atomics: phase 1 writes a per-chunk top-2
// to scratch, phase 2 merges the chunks in order, so results do not depend
// on scheduling. Tensor-core (mma/wgmma int8) and TMA versions come later.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWords = 64;          // 256 int8 = 64 packed int32 words
constexpr int kBQ = 64;             // queries per block
constexpr int kBR = 64;             // slab rows per shared tile
constexpr int kQR = 4;              // queries per thread
constexpr int kRR = 4;              // slab rows per thread
constexpr int kTQ = kBQ / kQR;      // 16 thread columns over queries
constexpr int kTR = kBR / kRR;      // 16 thread rows over slab rows
constexpr int kThreads = kTQ * kTR; // 256
constexpr int kStride = 65;         // padded k-major row (64 + 1 words)
constexpr int kNone = INT_MAX;      // "no neighbour" distance

struct Top2 {
  int d0, i0, d1, i1;
};

__device__ __forceinline__ bool lex_less(int da, int ia, int db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ void push(Top2& t, int d, int i) {
  if (lex_less(d, i, t.d0, t.i0)) {
    t.d1 = t.d0; t.i1 = t.i0; t.d0 = d; t.i0 = i;
  } else if (lex_less(d, i, t.d1, t.i1)) {
    t.d1 = d; t.i1 = i;
  }
}

// Phase 1: block (query tile, slab chunk) -> per-chunk top-2 of every query.
// Distances are kept doubled (2*hamming = 256 - dot) so they stay integers.
__global__ void __launch_bounds__(kThreads)
knn2_chunks(const int* __restrict__ query, const int* __restrict__ slab,
            const uint8_t* __restrict__ valid, int Q, int W, int chunk_rows,
            int4* __restrict__ scratch) {
  __shared__ int q_t[kWords * kStride];
  __shared__ __align__(16) int s_t[kWords * kStride];

  const int tid = threadIdx.x;
  const int tr = tid % kTR;
  const int tq = tid / kTR;
  const int q_base = blockIdx.x * kBQ;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(row_begin + chunk_rows, W);

  for (int e = tid; e < kBQ * kWords; e += kThreads) {
    const int r = e / kWords, k = e % kWords;
    const int q = q_base + r;
    q_t[k * kStride + r] = q < Q ? query[(size_t)q * kWords + k] : 0;
  }

  Top2 best[kQR];
#pragma unroll
  for (int a = 0; a < kQR; ++a) best[a] = {kNone, 0, kNone, 0};

  for (int row0 = row_begin; row0 < row_end; row0 += kBR) {
    __syncthreads();  // the previous tile is consumed (query tile staged)
    for (int e = tid; e < kBR * kWords; e += kThreads) {
      const int r = e / kWords, k = e % kWords;
      const int g = row0 + r;
      s_t[k * kStride + r] = g < row_end ? slab[(size_t)g * kWords + k] : 0;
    }
    __syncthreads();

    int acc[kQR][kRR];
#pragma unroll
    for (int a = 0; a < kQR; ++a)
#pragma unroll
      for (int b = 0; b < kRR; ++b) acc[a][b] = 0;

#pragma unroll 8
    for (int k = 0; k < kWords; ++k) {
      int qv[kQR], sv[kRR];
#pragma unroll
      for (int a = 0; a < kQR; ++a) qv[a] = q_t[k * kStride + tq + kTQ * a];
#pragma unroll
      for (int b = 0; b < kRR; ++b) sv[b] = s_t[k * kStride + tr + kTR * b];
#pragma unroll
      for (int a = 0; a < kQR; ++a)
#pragma unroll
        for (int b = 0; b < kRR; ++b) acc[a][b] = __dp4a(qv[a], sv[b], acc[a][b]);
    }

    // rows reach each thread in increasing index order
#pragma unroll
    for (int b = 0; b < kRR; ++b) {
      const int g = row0 + tr + kTR * b;
      if (g < row_end && valid[g]) {
#pragma unroll
        for (int a = 0; a < kQR; ++a) push(best[a], 256 - acc[a][b], g);
      }
    }
  }

  // merge the kTR partial top-2s of each query through shared memory
  __syncthreads();
  int4* cand = reinterpret_cast<int4*>(s_t);  // kBQ * kTR int4 <= s_t
#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const Top2& t = best[a];
    cand[(tq + kTQ * a) * kTR + tr] = make_int4(t.d0, t.i0, t.d1, t.i1);
  }
  __syncthreads();
  if (tid < kBQ) {
    const int q = q_base + tid;
    Top2 t = {kNone, 0, kNone, 0};
    for (int j = 0; j < kTR; ++j) {
      const int4 c = cand[tid * kTR + j];
      push(t, c.x, c.y);
      push(t, c.z, c.w);
    }
    if (q < Q) scratch[(size_t)q * n_chunks + chunk] = make_int4(t.d0, t.i0, t.d1, t.i1);
  }
}

// Phase 2: merge the per-chunk top-2s of each query, in chunk order.
__global__ void knn2_merge(const int4* __restrict__ scratch, int Q,
                           int n_chunks, float* __restrict__ out_d,
                           int* __restrict__ out_i) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  Top2 t = {kNone, 0, kNone, 0};
  for (int c = 0; c < n_chunks; ++c) {
    const int4 v = scratch[(size_t)q * n_chunks + c];
    push(t, v.x, v.y);
    push(t, v.z, v.w);
  }
  out_d[2 * q] = t.d0 == kNone ? 1e9f : 0.5f * t.d0;
  out_d[2 * q + 1] = t.d1 == kNone ? 1e9f : 0.5f * t.d1;
  out_i[2 * q] = t.i0;
  out_i[2 * q + 1] = t.i1;
}

}  // namespace

extern "C" {

// Block shape the wrapper sizes its chunks by.
int vocab_knn2_block_queries() { return kBQ; }
int vocab_knn2_block_rows() { return kBR; }

// query (Q,256) int8, slab (W,256) int8, valid (W,) bool; scratch holds
// Q*n_chunks int4; out_d (Q,2) float32, out_i (Q,2) int32. Returns the
// CUDA error code of the launches (0 = success). Enqueues on `stream`.
int vocab_knn2(const void* query, const void* slab, const void* valid, int Q,
               int W, int chunk_rows, int n_chunks, void* scratch,
               void* out_d, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((Q + kBQ - 1) / kBQ, n_chunks);
  knn2_chunks<<<grid1, kThreads, 0, s>>>(
      static_cast<const int*>(query), static_cast<const int*>(slab),
      static_cast<const uint8_t*>(valid), Q, W, chunk_rows,
      static_cast<int4*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  knn2_merge<<<(Q + 127) / 128, 128, 0, s>>>(
      static_cast<const int4*>(scratch), Q, n_chunks,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

const char* vocab_knn2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
