// Pieces shared by the two CSR-walk kernels (bcsr_spmm.cu, bcsr_sddmm.cu).
//
// A warp walks one row of a tile store's non-zeros, kept beside the tiles
// in compressed rows (ggad_tpu_torch/ops/bcsr_spmm.py::tile_csr: row_ptr,
// col, val). It stages the row's (column, value) pairs 32 at a time, one
// coalesced load a lane, and broadcasts each with __shfl_sync. Dense rows
// (H, E_r, E_c) are read as 16-byte vectors: the wrapper gives them a row
// stride `ld` that is a whole number of vectors and a 16-byte aligned start
// (ops/bcsr_spmm.py::vector_rows), so lane l of chunk j holds columns
// j·32·V + l·V .. +V, with V = 4 (f32) or 8 (bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace csr_walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;   // non-zeros whose rows are loaded together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a dense row, widened to f32 (bf16 → f32 is exact).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Lane `lane`'s share of the non-zeros k0 .. k0+31 of [k0, end): its
// column, or -1 where the entry is past `end` or its column is past
// `n_dense` (rows past a dense operand's count read as zero), and its
// value as f32 (0 where the column is -1).
template <typename T>
__device__ __forceinline__ void stage(const int32_t* __restrict__ col,
                                      const T* __restrict__ val, int k0,
                                      int end, int lane, int n_dense,
                                      int& my_c, float& my_v) {
  my_c = -1;
  my_v = 0.f;
  if (k0 + lane < end) {
    const int c = __ldg(col + k0 + lane);
    if (c < n_dense) {
      my_c = c;
      my_v = to_f32(val[k0 + lane]);
    }
  }
}

// The lane's NC chunks of dense row `c` (zeros for c = -1 and for chunks
// past the row stride), starting at column c_lane.
template <typename T, int NC>
__device__ __forceinline__ void load_row(const T* __restrict__ x, int c,
                                         int ld, int c_lane,
                                         float (&out)[NC][Vec16<T>::kN]) {
  constexpr int V = Vec16<T>::kN;
  const T* row = x + (int64_t)(c < 0 ? 0 : c) * ld;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c0 = c_lane + j * 32 * V;
    if (c >= 0 && c0 < ld) {
      Vec16<T>::load(row + c0, out[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) out[j][e] = 0.f;
    }
  }
}

}  // namespace csr_walk
