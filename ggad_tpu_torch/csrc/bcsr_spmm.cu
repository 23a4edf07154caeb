// CSR-walk SpMM for Hopper: out = M · H over the non-zeros of a tile store.
//
// Replaces the Pallas TPU kernel K1, ggad_tpu/ops/pallas_spmm.py
// `_bcsr_matmul_kernel` (launched by `_bcsr_matmul_raw`), and its study
// copy scripts/tile_rows_study.py `make_matmul.kernel`. The TPU kernel
// multiplies every stored tr × 128 tile on the MXU. Here the kernel walks
// only the stored non-zeros: the tile store keeps them beside the tiles in
// compressed rows (row_ptr, col, val; ops/bcsr_spmm.py::tile_csr), derived
// from the stored values once, when the tiles are built, so the kernel
// reads exactly the values the tiles hold (duplicates summed, bf16-rounded)
// and, within a row, the columns ascend.
//
// What bounds it on the H100. At the 0.75% density of the photo-shaped
// graph a 64-row wgmma/mma tile of M holds about one useful product in
// 130, so tensor cores would spend almost all their work on zeros; the
// useful work (2·nnz·d, 0.28 GFLOP) is microseconds on the CUDA cores and
// the bytes the function must move are a few MB. What bounds a walk over
// the non-zeros is the gather of one row of H per non-zero, nnz·d·item
// bytes (557 MB f32, 278 MB bf16 on photo), which come from L2 (H is
// 9.0 MB f32 / 4.5 MB bf16 and stays in the 50 MB L2), and the latency of
// those gathers, hidden only by the warps and loads in flight.
//
// Design. One warp per (output row, column chunk); a chunk is one 16-byte
// load a lane (4 f32 or 8 bf16 columns), 128 / 256 columns a warp, so d 300
// is 3 warps a row in f32 and 2 in bf16, and even the 1,027 rows of a
// labeled-column set make thousands of warps. The warp stages its row's
// (column, value) pairs 32 at a time with coalesced loads and broadcasts
// each with __shfl_sync; it gathers the H rows of kUnroll non-zeros at
// once with 16-byte __ldg loads and keeps its accumulators in registers.
// (On an H100 at photo shapes one chunk a warp was faster than a whole row
// a warp, in both types.) No shared memory (the SM's memory goes to L1,
// which catches gathers that repeat), no atomics: each output element is
// written once. A row with
// no non-zeros (cover and padding tiles, empty tile rows) writes zeros, so
// the output can be torch.empty. Columns ≥ h_rows read as zero
// (rectangular sets).
//
// Numerics. f32: IEEE __fmaf_rn in ascending column order, no TF32. For
// finite inputs this is the per-element FMA chain of the dense-tile loop,
// since fma(0, b, acc) = acc. bf16: bf16 values times H rounded to bf16 by
// the wrapper (as pallas_spmm.py:135-140 does); each product is exact in
// f32 and the sums are f32.
//
// Offsets into H and out are 64-bit; nnz and row counts fit int32 (the
// wrapper checks).

#include "csr_walk.cuh"

namespace {

using namespace csr_walk;

constexpr int kWarps = 8;  // warps per CTA
constexpr int kThreads = 32 * kWarps;

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col, const T* __restrict__ val,
                const T* __restrict__ h, float* __restrict__ out,
                int out_rows, int d, int ld, int h_rows, int n_chunks) {
  constexpr int V = Vec16<T>::kN;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (int64_t)out_rows * n_chunks) return;  // whole warps
  const int r = (int)(warp / n_chunks);
  const int c_lane = (int)(warp % n_chunks) * 32 * V + lane * V;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;

  const int begin = row_ptr[r];
  const int end = row_ptr[r + 1];
  for (int k0 = begin; k0 < end; k0 += 32) {
    int my_c;
    float my_v;
    stage(col, val, k0, end, lane, h_rows, my_c, my_v);
    const int cnt = min(32, end - k0);
    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      float x[kUnroll][1][V];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // entries past cnt come from lanes whose my_c is -1
        const int c = __shfl_sync(kFull, my_c, j0 + u);
        v[u] = __shfl_sync(kFull, my_v, j0 + u);
        load_row<T, 1>(h, c, ld, c_lane, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = __fmaf_rn(v[u], x[u][0][e], acc[e]);
    }
  }

  if (c_lane >= d) return;
  float* o = out + (int64_t)r * d + c_lane;
  if ((d & 3) == 0 && c_lane + V <= d) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(o)[q] = make_float4(
          acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c_lane + e < d) o[e] = acc[e];
  }
}

template <typename T>
int launch(const void* row_ptr, const void* col, const void* val,
           const void* h, void* out, int out_rows, int d, int ld, int h_rows,
           void* stream) {
  constexpr int kChunk = 32 * Vec16<T>::kN;
  if (out_rows <= 0 || d <= 0 || ld < d || ld % Vec16<T>::kN != 0 ||
      h_rows < 0 || ((uintptr_t)h & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (ld + kChunk - 1) / kChunk;
  const int64_t blocks = ((int64_t)out_rows * n_chunks + kWarps - 1) / kWarps;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  static bool carveout_set = false;  // give the SM's memory to L1
  if (!carveout_set) {
    cudaFuncSetAttribute(csr_spmm_kernel<T>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    carveout_set = true;
  }
  csr_spmm_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)row_ptr, (const int32_t*)col, (const T*)val,
      (const T*)h, (float*)out, out_rows, d, ld, h_rows, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers; the stream is
// PyTorch's current stream. out is [out_rows, d] f32; h is [h_rows, ld] in
// the store's dtype (ld ≥ d, a whole number of 16-byte vectors; columns
// d .. ld are read but never written). Each returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int bcsr_spmm_f32(const void* row_ptr, const void* col,
                             const void* val, const void* h, void* out,
                             int out_rows, int d, int ld, int h_rows,
                             void* stream) {
  return launch<float>(row_ptr, col, val, h, out, out_rows, d, ld, h_rows,
                       stream);
}

extern "C" int bcsr_spmm_bf16(const void* row_ptr, const void* col,
                              const void* val, const void* h, void* out,
                              int out_rows, int d, int ld, int h_rows,
                              void* stream) {
  return launch<__nv_bfloat16>(row_ptr, col, val, h, out, out_rows, d, ld,
                               h_rows, stream);
}
