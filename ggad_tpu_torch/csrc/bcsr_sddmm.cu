// Block-sparse SDDMM row sums for Hopper:
//   out[r] = Σ_c M[r,c]·⟨E_r[r], E_c[c]⟩.
//
// Replaces the Pallas TPU kernel K2, ggad_tpu/ops/pallas_sddmm.py
// `_sddmm_colsum_kernel` (launched by `_sddmm_colsum_raw`). M is stored as T
// tiles of tr × 128 values, sorted by (tile_row, tile_col); tile t covers
// rows tile_rows[t]·tr .. +tr and columns tile_cols[t]·128 .. +128. On the
// transposed tile set of an adjacency the row sums are the adjacency's
// column sums: GGAD's affinity numerator Σ_i a_ij⟨n_i, n_j⟩.
//
// Design. The Pallas grid walks the tiles in order and adds each tile's row
// sums into an output block it zeroes when the tile row changes. Here each
// CTA owns a 64-row slice of one tile row and walks that row's tiles through
// the host-built tile_ptr (tile_ptr[r] .. tile_ptr[r+1]). For each tile it
// stages 64 × 32 of E_r and 128 × 32 of E_c in shared memory, chunk by chunk
// over d, and forms the 64 × 128 block of dot products in fp32 registers
// (4 × 8 a thread, 256 threads). It then multiplies by the tile's entries,
// sums each thread's 8 columns and reduces the 16 threads of a row with warp
// shuffles. Each row's sum over tiles stays in a register and is written
// once at the end: no atomics, and the JAX order over tiles is kept. A row
// with no tiles writes 0, so the output can be torch.empty. Rows of E_r or
// E_c past their real count read as zero, and d is masked in the kernel, so
// the wrapper needs no padded copies.
//
// Numerics. f32 uses IEEE fp32 FMAs (no TF32), matching the
// Precision.HIGHEST product of the TPU kernel. bf16 reads bf16 tiles and
// E_r, E_c that the wrapper cast to bf16 (as pallas_sddmm.py:79-83 does);
// each bf16 × bf16 product is exact in fp32 and the sums are fp32.
//
// What bounds it on the card. The work the data needs is one dot product of
// length d per non-zero of M (2·nnz·d operations) and each input read once;
// on GGAD's labeled-column subset of the photo-shaped graph that is bound by
// bytes (the tile store). This dense-tile design instead multiplies every
// stored entry, zero or not (2·T·tr·128·d operations on the CUDA cores), and
// only (n_rows / 64) CTAs run, so it is bound by operations on a fraction of
// the card. Skipping all-zero sub-blocks, wgmma and TMA are later work.
//
// Offsets into the tile store and the operands are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 128;  // tile width: columns of M, rows of E_c
constexpr int kBM = 64;         // rows of a tile row per CTA
constexpr int kBK = 32;         // depth of d staged in shared memory per step
constexpr int kThreads = 256;   // 16 × 16 threads
constexpr int kTM = 4;          // rows per thread: ty + 16·i
constexpr int kTN = 8;          // columns per thread: tx + 16·j

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bcsr_sddmm_kernel(const T* __restrict__ values,
                  const int32_t* __restrict__ tile_cols,
                  const int32_t* __restrict__ tile_ptr,
                  const T* __restrict__ e_row, const T* __restrict__ e_col,
                  float* __restrict__ out, int tr, int d, int er_rows,
                  int ec_rows, int out_rows) {
  // k-major with one pad column, so that the transposing stores
  // (consecutive threads on consecutive k) hit distinct banks.
  __shared__ float Rs[kBK][kBM + 1];
  __shared__ float Cs[kBK][kTileCols + 1];

  const int blocks_per_tile_row = tr / kBM;
  const int tile_row = blockIdx.x / blocks_per_tile_row;
  const int m0 = (blockIdx.x % blocks_per_tile_row) * kBM;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int64_t row0 = (int64_t)tile_row * tr + m0;

  float row_sum[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) row_sum[i] = 0.f;

  const int t_begin = tile_ptr[tile_row];
  const int t_end = tile_ptr[tile_row + 1];
  for (int t = t_begin; t < t_end; ++t) {
    const int64_t c0 = (int64_t)tile_cols[t] * kTileCols;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int m = i / kBK;
        const int k = i % kBK;
        const int64_t r = row0 + m;
        Rs[k][m] = (r < er_rows && k0 + k < d)
                       ? to_f32(e_row[r * d + k0 + k]) : 0.f;
      }
      for (int i = tid; i < kTileCols * kBK; i += kThreads) {
        const int c = i / kBK;
        const int k = i % kBK;
        const int64_t r = c0 + c;
        Cs[k][c] = (r < ec_rows && k0 + k < d)
                       ? to_f32(e_col[r * d + k0 + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM];
        float b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = Rs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Cs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // M ∘ (E_r E_cᵀ), summed over the tile's 128 columns. The 16 threads
    // of a row are 16 consecutive lanes of one warp (tid = 16·ty + tx).
    const T* m_blk = values + (int64_t)t * tr * kTileCols
                     + (int64_t)m0 * kTileCols;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const T* m_row = m_blk + (int64_t)(ty + 16 * i) * kTileCols;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        s = __fmaf_rn(to_f32(m_row[tx + 16 * j]), acc[i][j], s);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off, 16);
      row_sum[i] += s;
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int64_t r = row0 + ty + 16 * i;
      if (r < out_rows) out[r] = row_sum[i];
    }
  }
}

template <typename T>
int launch(const void* values, const void* tile_cols, const void* tile_ptr,
           const void* e_row, const void* e_col, void* out, int n_tile_rows,
           int tr, int d, int er_rows, int ec_rows, int out_rows,
           void* stream) {
  if (tr <= 0 || tr % kBM != 0 || d <= 0 || n_tile_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tile_rows * (tr / kBM));
  bcsr_sddmm_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)values, (const int32_t*)tile_cols, (const int32_t*)tile_ptr,
      (const T*)e_row, (const T*)e_col, (float*)out, tr, d, er_rows, ec_rows,
      out_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers; the stream is
// PyTorch's current stream. Each returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int bcsr_sddmm_f32(const void* values, const void* tile_cols,
                              const void* tile_ptr, const void* e_row,
                              const void* e_col, void* out, int n_tile_rows,
                              int tr, int d, int er_rows, int ec_rows,
                              int out_rows, void* stream) {
  return launch<float>(values, tile_cols, tile_ptr, e_row, e_col, out,
                       n_tile_rows, tr, d, er_rows, ec_rows, out_rows,
                       stream);
}

extern "C" int bcsr_sddmm_bf16(const void* values, const void* tile_cols,
                               const void* tile_ptr, const void* e_row,
                               const void* e_col, void* out, int n_tile_rows,
                               int tr, int d, int er_rows, int ec_rows,
                               int out_rows, void* stream) {
  return launch<__nv_bfloat16>(values, tile_cols, tile_ptr, e_row, e_col,
                               out, n_tile_rows, tr, d, er_rows, ec_rows,
                               out_rows, stream);
}
