// CSR-walk SDDMM row sums for Hopper:
//   out[r] = Σ_c M[r,c]·⟨E_r[r], E_c[c]⟩ over the non-zeros of a tile store.
//
// Replaces the Pallas TPU kernel K2, ggad_tpu/ops/pallas_sddmm.py
// `_sddmm_colsum_kernel` (launched by `_sddmm_colsum_raw`). On the
// transposed tile set of an adjacency the row sums are the adjacency's
// column sums: GGAD's affinity numerator Σ_i a_ij⟨n_i, n_j⟩. The TPU kernel
// forms the dense tr × 128 block of dot products of every stored tile on
// the MXU. Here the kernel walks only the stored non-zeros, kept beside the
// tiles in compressed rows (row_ptr, col, val; ops/bcsr_spmm.py::tile_csr,
// derived from the stored values when the tiles are built).
//
// What bounds it on the H100. The work is one dot product of length d per
// non-zero (2·nnz·d: 38 MFLOP on the photo-shaped graph's labeled-column
// [U × N] set, 62,993 non-zeros); a tensor-core tile of M would hold about
// one useful entry in 130, so tensor cores do not help. The walk gathers
// one row of E_c per non-zero (nnz·d·item: 76 MB f32, 38 MB bf16 there)
// from L2, where E_c stays (9.0 / 4.5 MB), and that set has only U = 1,027
// rows: with one warp a row that is 8 warps an SM, too few to hide the
// gathers' latency.
//
// Design. One CTA of kRowWarps = 4 warps per row of M; the row's non-zeros
// are split into 4 contiguous parts, one a warp (on an H100 at photo
// shapes, faster than one, two or eight warps a row on the [U × N] set
// and than one warp a row on the square set). Each warp keeps
// its lanes' slice of E_r[r] in registers as 16-byte chunks (4 f32 or 8
// bf16 columns a lane), stages its part's (column, value) pairs 32 at a
// time and broadcasts them with __shfl_sync, gathers the E_c rows of
// kUnroll non-zeros at once with 16-byte __ldg loads, and adds
// m · ⟨E_r slice, E_c slice⟩ into one f32 accumulator a lane. Each warp
// reduces its lanes once, with shuffles; warp 0's first lane adds the 4
// warp sums from shared memory in order and writes the row once: no
// atomics. A row with no non-zeros, and a row past E_r's count, writes 0,
// so the output can be torch.empty. Columns ≥ ec_rows read as zero. Rows
// ≥ out_rows are not written.
//
// Numerics. f32: IEEE FMAs, no TF32. bf16: bf16 values and E_r, E_c that
// the wrapper rounded to bf16 (as pallas_sddmm.py:79-83 does); each product
// is exact in f32 and every sum is f32. The sums run in another order than
// the TPU kernel's and the plain version's (lane slices, then non-zeros,
// then lanes and warps), hence the stated tolerances: 1e-5 f32, 1e-4 bf16.

#include "csr_walk.cuh"

namespace {

using namespace csr_walk;

constexpr int kRowWarps = 4;  // warps per row of M (one CTA)

template <typename T, int NC>
__global__ void __launch_bounds__(32 * kRowWarps)
csr_sddmm_kernel(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ col, const T* __restrict__ val,
                 const T* __restrict__ e_row, const T* __restrict__ e_col,
                 float* __restrict__ out, int d, int ld, int er_rows,
                 int ec_rows) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kGroup = NC * 32 * V;  // columns a pass over the row covers
  __shared__ float warp_sum[kRowWarps];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;

  const int begin = row_ptr[r];
  const int len = row_ptr[r + 1] - begin;
  const int part = (len + kRowWarps - 1) / kRowWarps;
  const int wb = begin + min(len, w * part);
  const int we = begin + min(len, (w + 1) * part);

  float lane_acc = 0.f;
  if (r < er_rows) {
    for (int g0 = 0; g0 < ld; g0 += kGroup) {
      const int c_lane = g0 + lane * V;
      float a[NC][V];
      load_row<T, NC>(e_row, r, ld, c_lane, a);
      for (int k0 = wb; k0 < we; k0 += 32) {
        int my_c;
        float my_v;
        stage(col, val, k0, we, lane, ec_rows, my_c, my_v);
        const int cnt = min(32, we - k0);
        for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
          float x[kUnroll][NC][V];
          float v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int c = __shfl_sync(kFull, my_c, j0 + u);
            v[u] = __shfl_sync(kFull, my_v, j0 + u);
            load_row<T, NC>(e_col, c, ld, c_lane, x[u]);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            float p = 0.f;
#pragma unroll
            for (int j = 0; j < NC; ++j)
#pragma unroll
              for (int e = 0; e < V; ++e)  // columns d .. ld are unset
                if (c_lane + j * 32 * V + e < d)
                  p = __fmaf_rn(a[j][e], x[u][j][e], p);
            lane_acc = __fmaf_rn(v[u], p, lane_acc);
          }
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lane_acc += __shfl_xor_sync(kFull, lane_acc, off);
  if (lane == 0) warp_sum[w] = lane_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kRowWarps; ++i) s += warp_sum[i];
    out[r] = s;
  }
}

template <typename T, int NC>
int launch_nc(const void* row_ptr, const void* col, const void* val,
              const void* e_row, const void* e_col, void* out, int out_rows,
              int d, int ld, int er_rows, int ec_rows,
              cudaStream_t stream) {
  static bool carveout_set = false;  // give the SM's memory to L1
  if (!carveout_set) {
    cudaFuncSetAttribute(csr_sddmm_kernel<T, NC>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    carveout_set = true;
  }
  csr_sddmm_kernel<T, NC><<<(unsigned)out_rows, 32 * kRowWarps, 0, stream>>>(
      (const int32_t*)row_ptr, (const int32_t*)col, (const T*)val,
      (const T*)e_row, (const T*)e_col, (float*)out, d, ld, er_rows,
      ec_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* row_ptr, const void* col, const void* val,
           const void* e_row, const void* e_col, void* out, int out_rows,
           int d, int ld, int er_rows, int ec_rows, void* stream) {
  constexpr int kChunk = 32 * Vec16<T>::kN;
  if (out_rows <= 0 || d <= 0 || ld < d || ld % Vec16<T>::kN != 0 ||
      ((uintptr_t)e_row & 15) != 0 || ((uintptr_t)e_col & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // all of a row's chunks in one pass where there are at most 4
  const int n_chunks = (ld + kChunk - 1) / kChunk;
  switch (n_chunks < 4 ? n_chunks : 4) {
    case 1: return launch_nc<T, 1>(row_ptr, col, val, e_row, e_col, out, out_rows, d, ld, er_rows, ec_rows, s);
    case 2: return launch_nc<T, 2>(row_ptr, col, val, e_row, e_col, out, out_rows, d, ld, er_rows, ec_rows, s);
    case 3: return launch_nc<T, 3>(row_ptr, col, val, e_row, e_col, out, out_rows, d, ld, er_rows, ec_rows, s);
    default: return launch_nc<T, 4>(row_ptr, col, val, e_row, e_col, out, out_rows, d, ld, er_rows, ec_rows, s);
  }
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers; the stream is
// PyTorch's current stream. e_row is [er_rows, ld] and e_col [ec_rows, ld]
// in the store's dtype, d columns each (ld ≥ d, a whole number of 16-byte
// vectors; columns d .. ld are not read as values); out is [out_rows] f32.
// Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bcsr_sddmm_f32(const void* row_ptr, const void* col,
                              const void* val, const void* e_row,
                              const void* e_col, void* out, int out_rows,
                              int d, int ld, int er_rows, int ec_rows,
                              void* stream) {
  return launch<float>(row_ptr, col, val, e_row, e_col, out, out_rows, d,
                       ld, er_rows, ec_rows, stream);
}

extern "C" int bcsr_sddmm_bf16(const void* row_ptr, const void* col,
                               const void* val, const void* e_row,
                               const void* e_col, void* out, int out_rows,
                               int d, int ld, int er_rows, int ec_rows,
                               void* stream) {
  return launch<__nv_bfloat16>(row_ptr, col, val, e_row, e_col, out,
                               out_rows, d, ld, er_rows, ec_rows, stream);
}
