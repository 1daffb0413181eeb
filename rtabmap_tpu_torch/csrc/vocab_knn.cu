// Exact Hamming 2-NN of +-1 int8 descriptors against the vocabulary slab.
//
// Replaces rtabmap_tpu/ops/pallas/vocab_knn.py::pallas_knn2 (the TPU kernel
// behind VWDictionary quantization). Contract, shared bit for bit with the
// plain PyTorch version (rtabmap_tpu_torch/ops/matching.py::knn_blocked):
//   dist = (256 - sum q*s) / 2, exact in int32, returned as float32;
//   invalid words are excluded; a missing neighbour reads (1e9, idx 0);
//   ranks follow the (dist, idx) lexicographic order; any Q, W >= 1.
//
// What bounds it on an H100: the work is 2*Q*W*256 int8 operations against
// one read of the W*256-byte slab. At the main path's shape (Q=400 against
// a slab prefix of up to 262144 rows) both bounds are tens of microseconds
// (1979 TOP/s dense int8 tensor rate; 3.35 TB/s), so the products go to the
// int8 tensor cores: mma.sync m16n8k32 s8.s8.s32, whose int32 sums are
// exact. The layout:
// - queries are the A operand (M). Each warp owns 32 queries (two 16-row
//   m-blocks) and keeps their A fragments in registers for the whole
//   block: 64 registers a thread, loaded once from global memory, so the
//   query tile stays on chip and only the slab streams;
// - slab rows are the B operand (N), streamed through a kStages-deep
//   cp.async ring of 64-row tiles (rows padded to 320 bytes: the 16-byte
//   fragment loads below hit 32 distinct banks), beside each tile's
//   64 validity bytes;
// - the k order inside each 64-byte group is permuted alike for A and B
//   (a dot product does not depend on it), so that one 16-byte shared
//   load gives a thread its B fragments of two k-steps;
// - epilogue: from the accumulator fragments, the doubled distance
//   256 - dot; each thread keeps a (dist, idx) top-2 for each of its four
//   query rows, fed in increasing row order, so a strict < on the distance
//   is the lexicographic order; invalid rows are skipped. The four lanes
//   that share a query merge by shuffles; one writes the block's top-2 of
//   the chunk to scratch.
// A second kernel merges the chunks of each query (one warp a query, then
// shuffles; the (dist, idx) order is total, so nothing depends on
// scheduling). No atomics.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kDim = 256;           // bytes of a descriptor
constexpr int kMaxWarps = 16;       // warps of a block, 32 queries each
constexpr int kBQ = 32 * kMaxWarps; // queries a block at most
constexpr int kRows = 64;           // slab rows of a tile
constexpr int kStride = 320;        // padded bytes of a tile row
constexpr int kStages = 4;          // depth of the cp.async ring
constexpr int kStageBytes = kRows * kStride + kRows;  // rows, then flags
constexpr int kSmem = kStages * kStageBytes;
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

// push for an index larger than every index already held
__device__ __forceinline__ void push_later(Top2& t, int d, int i) {
  if (d < t.d1) {
    if (d < t.d0) {
      t.d1 = t.d0; t.i1 = t.i0; t.d0 = d; t.i0 = i;
    } else {
      t.d1 = d; t.i1 = i;
    }
  }
}

__device__ __forceinline__ void merge_lanes(Top2& t, int xor_mask) {
  const int d0 = __shfl_xor_sync(0xffffffffu, t.d0, xor_mask);
  const int i0 = __shfl_xor_sync(0xffffffffu, t.i0, xor_mask);
  const int d1 = __shfl_xor_sync(0xffffffffu, t.d1, xor_mask);
  const int i1 = __shfl_xor_sync(0xffffffffu, t.i1, xor_mask);
  push(t, d0, i0);
  push(t, d1, i1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phase 1: block (query tile, slab chunk) -> per-chunk top-2 of each query
// in scratch[q * n_chunks + chunk]. Distances are kept doubled
// (2*hamming = 256 - dot) so they stay integers.
__global__ void __launch_bounds__(kBQ, 1)
knn2_chunks(const int8_t* __restrict__ query, const int8_t* __restrict__ slab,
            const uint8_t* __restrict__ valid, int Q, int W, int chunk_rows,
            int4* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n_threads = blockDim.x;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(row_begin + chunk_rows, W);
  const int q_warp = blockIdx.x * kBQ + warp * 32;
  const bool active = q_warp < Q;

  // A fragments of the warp's two m-blocks over all eight k-steps. For
  // k-step ks, a[0]/a[2] hold row g's bytes (ks/2)*64 + tig*16 + (ks%2)*8
  // + [0,4) / [4,8), a[1]/a[3] the same of row g+8 (see the B loads).
  int a[2][8][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q_warp + mb * 16 + h * 8 + g;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        int4 v = make_int4(0, 0, 0, 0);
        if (q < Q)
          v = *reinterpret_cast<const int4*>(query + (size_t)q * kDim + s * 64 + tig * 16);
        a[mb][2 * s][h] = v.x;
        a[mb][2 * s][2 + h] = v.y;
        a[mb][2 * s + 1][h] = v.z;
        a[mb][2 * s + 1][2 + h] = v.w;
      }
    }
  }

  // top-2 of query rows (mb, h): q_warp + mb*16 + h*8 + g
  Top2 best[2][2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) best[mb][h] = {kNone, 0, kNone, 0};

  const int n_tiles = (row_end - row_begin + kRows - 1) / kRows;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = smem + (t % kStages) * kStageBytes;
      const int row0 = row_begin + t * kRows;
      for (int c = tid; c < kRows * (kDim / 16); c += n_threads) {
        const int r = c >> 4, ch = c & 15;
        const bool in = row0 + r < row_end;
        cp_async16(st + r * kStride + ch * 16,
                   in ? slab + (size_t)(row0 + r) * kDim + ch * 16 : slab, in ? 16 : 0);
      }
      if (tid < kRows / 16) {
        const int f0 = row0 + tid * 16;
        const int bytes = max(0, min(16, row_end - f0));
        cp_async16(st + kRows * kStride + tid * 16, bytes ? valid + f0 : valid, bytes);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();             // tile t landed; tile t-1 is consumed
    issue(t + kStages - 1);
    if (!active) continue;
    const unsigned char* st = smem + (t % kStages) * kStageBytes;
    const unsigned char* flags = st + kRows * kStride;
    const int row0 = row_begin + t * kRows;
#pragma unroll
    for (int np = 0; np < kRows / 16; ++np) {   // pairs of 8-row n-blocks
      int acc[2][2][4];                          // [n-block][m-block][frag]
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[n][mb][f] = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int4 b = *reinterpret_cast<const int4*>(
              st + (np * 16 + n * 8 + g) * kStride + s * 64 + tig * 16);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            mma_s8(acc[n][mb], a[mb][2 * s], b.x, b.y);
            mma_s8(acc[n][mb], a[mb][2 * s + 1], b.z, b.w);
          }
        }
      }
      // rows reach each thread in increasing index order
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = np * 16 + n * 8 + tig * 2 + c;
          if (!flags[r]) continue;
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              push_later(best[mb][h], 256 - acc[n][mb][2 * h + c], row0 + r);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2& b = best[mb][h];
      merge_lanes(b, 1);
      merge_lanes(b, 2);
      const int q = q_warp + mb * 16 + h * 8 + g;
      if (tig == 0 && q < Q)
        scratch[(size_t)q * n_chunks + chunk] = make_int4(b.d0, b.i0, b.d1, b.i1);
    }
}

// Phase 2: one warp a query merges its per-chunk top-2s (lanes stride the
// chunks, then shuffles; the (dist, idx) order is total).
__global__ void knn2_merge(const int4* __restrict__ scratch, int Q, int n_chunks,
                           float* __restrict__ out_d, int* __restrict__ out_i) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;
  Top2 t = {kNone, 0, kNone, 0};
  for (int c = lane; c < n_chunks; c += 32) {
    const int4 v = scratch[(size_t)q * n_chunks + c];
    push(t, v.x, v.y);
    push(t, v.z, v.w);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) merge_lanes(t, m);
  if (lane == 0) {
    out_d[2 * q] = t.d0 == kNone ? 1e9f : 0.5f * t.d0;
    out_d[2 * q + 1] = t.d1 == kNone ? 1e9f : 0.5f * t.d1;
    out_i[2 * q] = t.i0;
    out_i[2 * q + 1] = t.i1;
  }
}

}  // namespace

extern "C" {

// Block shape the wrapper sizes its chunks by.
int vocab_knn2_block_queries() { return kBQ; }
int vocab_knn2_block_rows() { return kRows; }

// query (Q,256) int8, slab (W,256) int8, valid (W,) bool, all 16-byte
// aligned; chunk_rows a multiple of the block rows; scratch holds
// Q*n_chunks int4; out_d (Q,2) float32, out_i (Q,2) int32. Returns the
// CUDA error code of the launches (0 = success). Enqueues on `stream`.
int vocab_knn2(const void* query, const void* slab, const void* valid, int Q,
               int W, int chunk_rows, int n_chunks, void* scratch,
               void* out_d, void* out_i, void* stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      knn2_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = (min(Q, kBQ) + 31) / 32;
  const dim3 grid1((Q + kBQ - 1) / kBQ, n_chunks);
  knn2_chunks<<<grid1, 32 * warps, kSmem, s>>>(
      static_cast<const int8_t*>(query), static_cast<const int8_t*>(slab),
      static_cast<const uint8_t*>(valid), Q, W, chunk_rows,
      static_cast<int4*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  knn2_merge<<<(Q + 7) / 8, 256, 0, s>>>(
      static_cast<const int4*>(scratch), Q, n_chunks,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

const char* vocab_knn2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
