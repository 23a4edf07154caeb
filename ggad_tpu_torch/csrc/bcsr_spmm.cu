// Block-sparse (BCSR) SpMM for Hopper: out = M · H over tile-COO tiles.
//
// Replaces the Pallas TPU kernel K1, ggad_tpu/ops/pallas_spmm.py
// `_bcsr_matmul_kernel` (launched by `_bcsr_matmul_raw`). M is stored as T
// tiles of tr × 128 values, sorted by (tile_row, tile_col); tile t covers
// rows tile_rows[t]·tr .. +tr and columns tile_cols[t]·128 .. +128.
//
// Design. The Pallas grid walks the tiles in order on one core and carries
// the accumulator from one grid step to the next. Here the host builds a
// tile-row pointer array (tile_ptr[r] .. tile_ptr[r+1] are the tiles of
// tile row r) and each CTA owns one (64-row block of a tile row, 64-column
// block of d) output block. The CTA walks its tile row's tiles in order,
// stages a 64×32 slice of the A tile and the matching 32×64 slice of the
// H slab in shared memory, and accumulates in fp32 registers (4×4 outputs
// a thread, 256 threads). It writes its block once: no atomics, and the
// JAX accumulation order over tiles is kept. A tile row with no tiles
// writes zeros, so every output element is written.
//
// Numerics. f32 mode uses IEEE fp32 FMAs (no TF32), matching the
// Precision.HIGHEST product of the TPU kernel. bf16 mode reads bf16 tiles
// and an H the wrapper has cast to bf16 (as pallas_spmm.py:135-140 does);
// each bf16 × bf16 product is exact in fp32 and the sum is fp32.
//
// What bounds it on the card. On the photo-shaped graph the whole tile
// store is multiplied (2·T·tr·128·d = 37.1 GFLOP) although only 0.75% of
// it is non-zero (0.28 GFLOP of useful work). For the work the data needs
// the bound is bytes: the 247.5 MB f32 store read once at 3.35 TB/s,
// ≈0.08 ms (≈0.04 ms for the bf16 store). This dense-tile design instead
// is bound by operations: ≈0.55 ms at the 67 TFLOP/s fp32 rate of the
// CUDA cores, and its simple shared-memory tiling reaches a fraction of
// that rate. bf16 also runs fp32 FMAs on the CUDA cores. Skipping
// all-zero sub-blocks, wgmma and TMA pipelining are later work.
//
// Offsets into the tile store are 64-bit: t·tr·128 passes 2^31 at 16,384
// tiles of height 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 128;  // tile width: columns of A, rows of an H slab
constexpr int kBM = 64;         // output rows per CTA
constexpr int kBN = 64;         // output columns per CTA
constexpr int kBK = 32;         // depth staged in shared memory per step
constexpr int kThreads = 256;   // 16 × 16 threads, 4 × 4 outputs each
constexpr int kTM = 4;
constexpr int kTN = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bcsr_spmm_kernel(const T* __restrict__ values,
                 const int32_t* __restrict__ tile_cols,
                 const int32_t* __restrict__ tile_ptr,
                 const T* __restrict__ h, float* __restrict__ out,
                 int tr, int d, int h_rows, int out_rows) {
  // As is stored k-major with one pad column so that the transposing
  // store (consecutive threads on consecutive k) hits distinct banks.
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Hs[kBK][kBN];

  const int blocks_per_tile_row = tr / kBM;
  const int tile_row = blockIdx.x / blocks_per_tile_row;
  const int m0 = (blockIdx.x % blocks_per_tile_row) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int t_begin = tile_ptr[tile_row];
  const int t_end = tile_ptr[tile_row + 1];
  for (int t = t_begin; t < t_end; ++t) {
    const T* a_blk = values + (int64_t)t * tr * kTileCols
                     + (int64_t)m0 * kTileCols;
    const int64_t h_row0 = (int64_t)tile_cols[t] * kTileCols;
    for (int k0 = 0; k0 < kTileCols; k0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int m = i / kBK;
        const int k = i % kBK;
        As[k][m] = to_f32(a_blk[(int64_t)m * kTileCols + k0 + k]);
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int k = i / kBN;
        const int n = i % kBN;
        const int64_t hr = h_row0 + k0 + k;
        const int hc = n0 + n;
        Hs[k][n] = (hr < h_rows && hc < d) ? to_f32(h[hr * d + hc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM];
        float b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Hs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int64_t row0 = (int64_t)tile_row * tr + m0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    if (r >= out_rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < d) out[r * d + c] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* values, const void* tile_cols, const void* tile_ptr,
           const void* h, void* out, int n_tile_rows, int tr, int d,
           int h_rows, int out_rows, void* stream) {
  if (tr <= 0 || tr % kBM != 0 || d <= 0 || n_tile_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tile_rows * (tr / kBM),
                  (unsigned)((d + kBN - 1) / kBN));
  bcsr_spmm_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)values, (const int32_t*)tile_cols, (const int32_t*)tile_ptr,
      (const T*)h, (float*)out, tr, d, h_rows, out_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers; the stream is
// PyTorch's current stream. Each returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int bcsr_spmm_f32(const void* values, const void* tile_cols,
                             const void* tile_ptr, const void* h, void* out,
                             int n_tile_rows, int tr, int d, int h_rows,
                             int out_rows, void* stream) {
  return launch<float>(values, tile_cols, tile_ptr, h, out, n_tile_rows, tr,
                       d, h_rows, out_rows, stream);
}

extern "C" int bcsr_spmm_bf16(const void* values, const void* tile_cols,
                              const void* tile_ptr, const void* h, void* out,
                              int n_tile_rows, int tr, int d, int h_rows,
                              int out_rows, void* stream) {
  return launch<__nv_bfloat16>(values, tile_cols, tile_ptr, h, out,
                               n_tile_rows, tr, d, h_rows, out_rows, stream);
}
