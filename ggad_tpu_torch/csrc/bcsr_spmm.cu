// SpMM for Hopper: out = M · H over the non-zeros of a tile store, on one
// of two routes fixed by the store's shape when it is built
// (ops/bcsr_spmm.py::k1_route): the staged route below, and the CSR walk
// of the previous design, kept for stores whose tiles are too sparse for
// staging to pay.
//
// Replaces the Pallas TPU kernel K1, ggad_tpu/ops/pallas_spmm.py
// `_bcsr_matmul_kernel` (launched by `_bcsr_matmul_raw`), and its study
// copy scripts/tile_rows_study.py `make_matmul.kernel`. The TPU kernel
// multiplies every stored tr × 128 tile on the MXU and reads each tile's
// 128-row slab of H once for the tile's tr output rows. Both routes here
// touch only the stored non-zeros, derived from the stored values when the
// tiles are built, so they read exactly the values the tiles hold
// (duplicates summed, bf16-rounded).
//
// What bounds it on the H100. At the 0.75% density of the photo-shaped
// graph a 64-row wgmma/mma tile of M holds about one useful product in
// 130, so tensor cores would spend almost all their work on zeros (and f32
// parity needs TF32 off); the useful work (2·nnz·d, 0.28 GFLOP on photo)
// is microseconds on the CUDA cores and the bytes the function must move
// are a few MB. What bounds the walk is its gather of one row of H per
// non-zero, nnz·d·item bytes (557 MB f32 on photo), from L2: on the photo
// and TAM shapes it reads them at 7.2-7.75 TB/s, the L2's rate, and on the
// sparse rect sets, with a few dozen non-zeros a warp, at 3-4 TB/s. The
// staged route reads each staged slab of H from L2 once and serves the
// tile's non-zeros from shared memory: its bound is the shared-memory
// traffic, 256 bytes (f32; 128 bf16) of slab for each non-zero and 64
// columns plus an 8-byte entry, at up to 128 B a clock an SM (≈33 TB/s),
// and the slab copies. That pays only where a staged slab row serves
// several non-zeros: a warp keeps its rows' sums in registers, so a block
// can hold only 128 rows × 64 columns, and each (row, tile) pair costs a
// run-length read and a loop however few non-zeros it has. On the H100
// (chip_smoke.py times both routes on each K1 shape of the main paths)
// the staged route took 1.1-2.1× the walk's time where a staged slab row
// serves about one non-zero of a 128-row band (photo, TAM, the halo's
// remote and subset sets: reuse 0.46-1.04), 0.81-0.87× on the
// single-device Amazon-shaped graph (reuse 3.45) and 0.55× on its halo's
// local sets (reuse 12.1). So each store takes the staged route where a
// staged slab row serves at least 3 non-zeros (ops/bcsr_spmm.py::
// k1_route), the walk elsewhere.
//
// Staged design (namespace staged). A block owns a band of 128 rows of
// one tile row and a chunk of 64 columns of H; its output, 128 × 64 f32,
// is held in registers: one producer warp and 16 consumer warps, each
// holding 8 rows ("slots"), two columns a lane. The producer keeps a ring
// of kStages stages in flight in dynamic shared memory: each stage is one
// [128 × 64] slab of H under one tile, copied with a TMA 2-D tensor copy
// (cp.async.bulk.tensor; the tensor map's rows are h_rows and its columns
// d, so rows past h_rows and columns past d arrive as zeros: the rect sets
// rely on it), and the band's entries for that tile (a 1-D bulk copy,
// cp.async.bulk), both completing on one mbarrier. Each consumer waits for
// a stage, reads its entry offset and its slots' run lengths from the
// stage's header, walks each slot's entries four at a time (their slab
// reads in flight together) and releases the stage on the ring's empty
// barrier. A warp reads one contiguous slab row for each non-zero, two
// elements a lane: no bank conflicts. Rows go to warps by their non-zero
// count over the band (ops/bcsr_spmm.py::tile_view deals them heaviest
// first), so warps get equal work. No float atomics, no partials: each
// output element is accumulated by one lane and written once; a row with
// no non-zeros writes zeros, so the output can be torch.empty.
//
// Numerics (both routes). f32: IEEE __fmaf_rn in ascending column order
// (tiles in ascending tile column, columns ascending within a tile), no
// TF32, from 0. For finite inputs this is the per-element FMA chain of
// the dense-tile loop, since fma(0, b, acc) = acc, and the two routes give
// the same bits, but on the walk's heavy rows (below): there each of
// eight contiguous pieces of the row is such a chain, and the eight sums
// are added in piece order, the same terms re-associated at seven points
// (within TOL of the plain version, whose tile loop re-associates too).
// bf16: bf16 values times H rounded to bf16 by the wrapper
// (as pallas_spmm.py:135-140 does); the staged slab holds those bf16
// values and widens them exactly; each product is exact in f32 and the
// sums are f32.
//
// Walk design (namespace walk). One warp per (output row, column chunk);
// a chunk is one 16-byte load a lane (4 f32 or 8 bf16 columns), 128 / 256
// columns a warp. The warp stages its row's (column, value) pairs 32 at a
// time with coalesced loads and broadcasts each with __shfl_sync; it
// gathers the H rows of kUnroll non-zeros at once with 16-byte __ldg loads
// and keeps its accumulators in registers. It asks for the SM's memory to
// go to L1, which catches gathers that repeat. Columns ≥ h_rows read as
// zero. A warp walks its row's non-zeros in order, so a launch lasts as
// long as its longest row's chain: on the Amazon-shaped halo's remote set
// (rows of 33 non-zeros on average, the longest 290) the time followed the
// longest rows, and the same non-zeros in rows of at most 64 took 0.62 of
// it. So a row longer than heavy_min (ops/bcsr_spmm.py::heavy_rows: twice
// the store's mean non-empty row, at least 64) is a heavy row, walked by a
// block of its own after the warps' blocks: each of its 8 warps walks an
// eighth of the row and warp 0 adds the eight sums in order, through a
// scratch buffer in global memory (shared memory would take the SM's
// memory from L1). A store with no such row launches the walk as before.
//
// Offsets into H and out are 64-bit; nnz and row counts fit int32 (the
// wrapper checks).

#include <cuda.h>

#include "csr_walk.cuh"

namespace walk {

using namespace csr_walk;

constexpr int kWarps = 8;  // warps per CTA
constexpr int kThreads = 32 * kWarps;

// acc += the row's non-zeros k0 .. end of [begin, end) times H, lane's
// columns c_lane .. +V: the walk's loop (columns ≥ h_rows read as zero).
template <typename T>
__device__ __forceinline__ void walk_range(const int32_t* __restrict__ col,
                                           const T* __restrict__ val,
                                           const T* __restrict__ h, int begin,
                                           int end, int ld, int h_rows,
                                           int c_lane, int lane,
                                           float (&acc)[Vec16<T>::kN]) {
  constexpr int V = Vec16<T>::kN;
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
}

// out[r, c_lane .. +V] = acc, within the row's d columns.
template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ out, int r,
                                          int d, int c_lane,
                                          const float (&acc)[V]) {
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

// Blocks 0 .. light_blocks-1: a warp per (row, chunk), skipping rows of
// more than heavy_min non-zeros. The blocks after them: one block per
// (heavy row, chunk), its warps each walking an eighth of the row; the
// eight sums go through `part` (global memory: the walk keeps the SM's
// memory for L1) and warp 0 adds them in warp order. One call site of
// walk_range, so both kinds of block take its registers once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col, const T* __restrict__ val,
                const T* __restrict__ h,
                const int32_t* __restrict__ heavy_rows, float* part,
                float* __restrict__ out, int out_rows, int d, int ld,
                int h_rows, int n_chunks, int light_blocks, int heavy_min) {
  constexpr int V = Vec16<T>::kN;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool heavy = (int)blockIdx.x >= light_blocks;
  int r, chunk, begin, end;
  if (!heavy) {
    const int64_t warp = (int64_t)blockIdx.x * kWarps + w;
    if (warp >= (int64_t)out_rows * n_chunks) return;  // whole warps
    r = (int)(warp / n_chunks);
    chunk = (int)(warp % n_chunks);
    begin = row_ptr[r];
    end = row_ptr[r + 1];
    if (end - begin > heavy_min) return;  // a heavy block's row
  } else {
    const int item = (int)blockIdx.x - light_blocks;
    r = heavy_rows[item / n_chunks];
    if (r >= out_rows) return;  // the whole block
    chunk = item % n_chunks;
    const int first = row_ptr[r];
    const int64_t len = row_ptr[r + 1] - first;
    begin = first + (int)(len * w / kWarps);
    end = first + (int)(len * (w + 1) / kWarps);
  }
  const int c_lane = chunk * 32 * V + lane * V;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  walk_range<T>(col, val, h, begin, end, ld, h_rows, c_lane, lane, acc);
  if (heavy) {
    float* mine = part + ((int64_t)(blockIdx.x - light_blocks) * kWarps) *
                             (32 * V) + lane * V;
#pragma unroll
    for (int e = 0; e < V; ++e) mine[(int64_t)w * 32 * V + e] = acc[e];
    __syncthreads();  // the block's writes to `part` are visible after it
    if (w != 0) return;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float sum = mine[e];
      for (int q = 1; q < kWarps; ++q) sum += mine[(int64_t)q * 32 * V + e];
      acc[e] = sum;
    }
  }
  store_row<V>(out, r, d, c_lane, acc);
}

template <typename T>
int launch(const void* row_ptr, const void* col, const void* val,
           const void* h, const void* heavy_rows, void* part, void* out,
           int out_rows, int d, int ld, int h_rows, int n_heavy,
           int heavy_min, void* stream) {
  constexpr int kChunk = 32 * Vec16<T>::kN;
  if (out_rows <= 0 || d <= 0 || ld < d || ld % Vec16<T>::kN != 0 ||
      h_rows < 0 || n_heavy < 0 || heavy_min < 0 ||
      ((uintptr_t)h & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (ld + kChunk - 1) / kChunk;
  const int64_t light =
      ((int64_t)out_rows * n_chunks + kWarps - 1) / kWarps;
  const int64_t blocks = light + (int64_t)n_heavy * n_chunks;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  static bool carveout_set = false;  // give the SM's memory to L1
  if (!carveout_set) {
    cudaFuncSetAttribute(csr_spmm_kernel<T>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    carveout_set = true;
  }
  csr_spmm_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)row_ptr, (const int32_t*)col, (const T*)val,
      (const T*)h, (const int32_t*)heavy_rows, (float*)part, (float*)out,
      out_rows, d, ld, h_rows, n_chunks, (int)light, heavy_min);
  return (int)cudaGetLastError();
}

}  // namespace walk

namespace staged {

constexpr int kSlots = 8;        // rows a consumer warp holds
constexpr int kChunk = 64;       // columns of H a block covers: two a lane
constexpr int kSlabRows = 128;   // rows of H under one tile (the tile width)
constexpr int kWarps = 16;       // consumer warps: a band of 128 rows
constexpr int kBand = kWarps * kSlots;
constexpr int kStages = 3;       // stages in flight
constexpr int kBlockWords = 4096;  // int32 words of a stage's entry block
constexpr int kHead = kWarps * (1 + kSlots / 4);  // a block's header words
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__host__ __device__ constexpr int slab_bytes() {
  return kSlabRows * kChunk * (int)sizeof(T);
}

// The ring (slabs at a 1024-byte boundary, then the entry blocks), its
// barriers, and 1 KB to align.
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (slab_bytes<T>() + 4 * kBlockWords) + 2 * kStages * 8 +
         1024;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::
               "r"(shared_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
               "r"(shared_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::
               "r"(shared_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// The [kSlabRows × kChunk] box of H at column x, row y, into dst; its
// bytes complete on `bar`. Rows and columns outside the tensor arrive as
// zeros.
__device__ __forceinline__ void load_slab(void* dst, const CUtensorMap* map,
                                          int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::
      "r"(shared_addr(dst)), "l"((uint64_t)map), "r"(x), "r"(y),
      "r"(shared_addr(bar)) : "memory");
}

// `bytes` (a multiple of 16) from src to dst, both 16-byte aligned;
// they complete on `bar`.
__device__ __forceinline__ void load_block(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::
      "r"(shared_addr(dst)), "l"((uint64_t)src), "r"(bytes),
      "r"(shared_addr(bar)) : "memory");
}

// A lane's two consecutive slab elements `offset` bytes past `base` (its
// own column pair of the slab row), as f32 (bf16 widened exactly).
template <typename T>
__device__ __forceinline__ float2 slab_pair(const unsigned char* base,
                                            uint32_t offset);

template <>
__device__ __forceinline__ float2 slab_pair<float>(const unsigned char* base,
                                                   uint32_t offset) {
  return *reinterpret_cast<const float2*>(base + offset);
}

template <>
__device__ __forceinline__ float2 slab_pair<__nv_bfloat16>(
    const unsigned char* base, uint32_t offset) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(base + offset);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// Block (band g, chunk): band g's stages, columns chunk·64 .. +64, two a
// lane. Warps 0 .. kWarps-1 consume, warp kWarps produces. A stage is
// (tile column, word offset, words) of its entry block in `blocks`; a
// block is a header (each warp's entry offset, then each warp's kSlots
// run lengths, a byte each) and the warps' segments of entries (byte
// offset of the column's slab row, value bits), ordered by slot, then
// column.
template <typename T>
__global__ void __launch_bounds__(32 * (kWarps + 1))
staged_csr_spmm_kernel(const __grid_constant__ CUtensorMap h_map,
                       const int32_t* __restrict__ stage_ptr,
                       const int4* __restrict__ stages,
                       const int32_t* __restrict__ blocks,
                       const int32_t* __restrict__ slot_rows,
                       float* __restrict__ out, int out_rows, int d,
                       int n_chunks) {
  extern __shared__ unsigned char smem_raw[];
  // the ring at a 1024-byte boundary (pointer arithmetic on smem_raw keeps
  // the compiler's knowledge that it is shared memory)
  unsigned char* base =
      smem_raw + ((1024u - (shared_addr(smem_raw) & 1023u)) & 1023u);
  int32_t* words =
      reinterpret_cast<int32_t*>(base + kStages * slab_bytes<T>());
  uint64_t* full = reinterpret_cast<uint64_t*>(words + kStages * kBlockWords);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x % n_chunks;
  const int g = blockIdx.x / n_chunks;
  const int s0 = stage_ptr[g];
  const int n_s = stage_ptr[g + 1] - s0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_s; ++i) {
        const int s = i % kStages;
        const int4 st = stages[s0 + i];
        if (i >= kStages) bar_wait(&empty[s], ((i / kStages) - 1) & 1);
        bar_expect_tx(&full[s], slab_bytes<T>() + 4 * st.z);
        load_slab(base + s * slab_bytes<T>(), &h_map, chunk * kChunk,
                  st.x * kSlabRows, &full[s]);
        load_block(words + s * kBlockWords, blocks + st.y, 4 * st.z,
                   &full[s]);
      }
    }
    return;
  }

  float2 acc[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) acc[j] = make_float2(0.f, 0.f);

  for (int i = 0; i < n_s; ++i) {
    const int s = i % kStages;
    const int32_t* blk = words + s * kBlockWords;
    const unsigned char* slab =
        base + s * slab_bytes<T>() + lane * 2 * (int)sizeof(T);
    bar_wait(&full[s], (i / kStages) & 1);
    const uint2* ent = reinterpret_cast<const uint2*>(blk + kHead) +
                       blk[warp];
    const uint2 runs =
        *reinterpret_cast<const uint2*>(blk + kWarps + 2 * warp);
    const uint32_t run_words[2] = {runs.x, runs.y};
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      // slot j's non-zeros of this stage, columns ascending: n entries
      int n = (run_words[j / 4] >> (8 * (j % 4))) & 0xff;
      float2 a = acc[j];
      // four entries at a time: their slab reads are in flight together
#pragma unroll 1
      for (; n >= 4; n -= 4, ent += 4) {
        uint2 e[4];
        float2 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) e[u] = ent[u];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = slab_pair<T>(slab, e[u].x);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = __uint_as_float(e[u].y);
          a.x = __fmaf_rn(v, x[u].x, a.x);
          a.y = __fmaf_rn(v, x[u].y, a.y);
        }
      }
#pragma unroll 1
      for (; n > 0; --n, ++ent) {
        const uint2 e = *ent;
        const float2 x = slab_pair<T>(slab, e.x);
        const float v = __uint_as_float(e.y);
        a.x = __fmaf_rn(v, x.x, a.x);
        a.y = __fmaf_rn(v, x.y, a.y);
      }
      acc[j] = a;
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }

  const int c = chunk * kChunk + 2 * lane;
  const int my_row = lane < kSlots ? slot_rows[(g * kWarps + warp) * kSlots + lane] : 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int r = g * kBand + __shfl_sync(kFull, my_row, j);
    if (r < out_rows) {
      float* o = out + (int64_t)r * d + c;
      if (c < d) o[0] = acc[j].x;
      if (c + 1 < d) o[1] = acc[j].y;
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (this
// library does not link libcuda); null where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kErrorEncode = 1000;  // + the CUresult of a refused map

// What a launch for out_rows × d asks of the card: a block per (band,
// column chunk), 32 · (kWarps + 1) threads, smem_bytes<T>() a block.
struct Shape {
  int n_chunks;
  int64_t blocks;
  int threads;
  int smem;
};

template <typename T>
Shape shape(int out_rows, int d) {
  const int n_chunks = (d + kChunk - 1) / kChunk;
  return {n_chunks, (int64_t)((out_rows + kBand - 1) / kBand) * n_chunks,
          32 * (kWarps + 1), smem_bytes<T>()};
}

template <typename T>
int launch(const void* stage_ptr, const void* stages, const void* blocks,
           const void* slot_rows, const void* h, void* out, int out_rows,
           int d, int ld, int h_rows, void* stream) {
  if (out_rows <= 0 || d <= 0 || ld < d || (ld * sizeof(T)) % 16 != 0 ||
      h_rows <= 0 || ((uintptr_t)h & 15) != 0 ||
      ((uintptr_t)blocks & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Shape grid = shape<T>(out_rows, d);
  if (grid.blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)h_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)kSlabRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult made = encode(
      &map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(h), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (made != CUDA_SUCCESS) return kErrorEncode + (int)made;

  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        staged_csr_spmm_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, grid.smem);
    if (rc != cudaSuccess) return (int)rc;
    smem_set = true;
  }
  staged_csr_spmm_kernel<T><<<(unsigned)grid.blocks, grid.threads, grid.smem,
                              (cudaStream_t)stream>>>(
      map, (const int32_t*)stage_ptr, (const int4*)stages,
      (const int32_t*)blocks, (const int32_t*)slot_rows, (float*)out,
      out_rows, d, grid.n_chunks);
  return (int)cudaGetLastError();
}

// The layout the wrapper builds tile views for, and the shape of a launch
// for out_rows × d, into out[0 .. 9): kSlots, kBand, kChunk, kStages,
// kBlockWords, kSlabRows, blocks, threads, dynamic shared memory a block.
template <typename T>
int describe(int out_rows, int d, int64_t* out) {
  const Shape grid = shape<T>(out_rows, d);
  const int64_t v[9] = {kSlots,      kBand,       kChunk,
                        kStages,     kBlockWords, kSlabRows,
                        grid.blocks, grid.threads, grid.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 9;
}

}  // namespace staged

// Plain C entries for ctypes. Pointers are device pointers; the stream is
// PyTorch's current stream. out is [out_rows, d] f32; h is [h_rows, ld] in
// the store's dtype (ld ≥ d, a whole number of 16-byte vectors; columns
// d .. ld are read but never written). heavy_rows: the n_heavy rows of
// more than heavy_min non-zeros, ascending (ops/bcsr_spmm.py::heavy_rows);
// part: f32 scratch of n_heavy · ceil(ld / chunk) · 8 · chunk values
// (chunk = 128 f32, 256 bf16), unread when n_heavy is 0. Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bcsr_spmm_f32(const void* row_ptr, const void* col,
                             const void* val, const void* h,
                             const void* heavy_rows, void* part, void* out,
                             int out_rows, int d, int ld, int h_rows,
                             int n_heavy, int heavy_min, void* stream) {
  return walk::launch<float>(row_ptr, col, val, h, heavy_rows, part, out,
                             out_rows, d, ld, h_rows, n_heavy, heavy_min,
                             stream);
}

extern "C" int bcsr_spmm_bf16(const void* row_ptr, const void* col,
                              const void* val, const void* h,
                              const void* heavy_rows, void* part, void* out,
                              int out_rows, int d, int ld, int h_rows,
                              int n_heavy, int heavy_min, void* stream) {
  return walk::launch<__nv_bfloat16>(row_ptr, col, val, h, heavy_rows, part,
                                     out, out_rows, d, ld, h_rows, n_heavy,
                                     heavy_min, stream);
}

// The staged route. stage_ptr, stages, blocks, slot_rows: the store's tile
// view (ops/bcsr_spmm.py::TileView); h, out, out_rows, d, ld, h_rows as
// above (h_rows ≥ 1). Returns cudaGetLastError() after the
// launch, or an error code without one (1000 + the CUresult when the
// tensor map is refused).
extern "C" int bcsr_spmm_staged_f32(const void* stage_ptr,
                                    const void* stages, const void* blocks,
                                    const void* slot_rows, const void* h,
                                    void* out, int out_rows, int d, int ld,
                                    int h_rows, void* stream) {
  return staged::launch<float>(stage_ptr, stages, blocks, slot_rows, h, out,
                               out_rows, d, ld, h_rows, stream);
}

extern "C" int bcsr_spmm_staged_bf16(const void* stage_ptr,
                                     const void* stages, const void* blocks,
                                     const void* slot_rows, const void* h,
                                     void* out, int out_rows, int d, int ld,
                                     int h_rows, void* stream) {
  return staged::launch<__nv_bfloat16>(stage_ptr, stages, blocks, slot_rows,
                                       h, out, out_rows, d, ld, h_rows,
                                       stream);
}

// The staged route's layout and launch shape (staged::describe) for a
// store of `item`-byte values (4: f32, 2: bf16), into out[0 .. n): returns
// the number of values written (9), or -1 for another item size or n < 9.
extern "C" int bcsr_spmm_staged_describe(int item, int out_rows, int d,
                                         int64_t* out, int n) {
  if (n < 9 || out_rows < 0 || d < 0) return -1;
  if (item == 4) return staged::describe<float>(out_rows, d, out);
  if (item == 2) return staged::describe<__nv_bfloat16>(out_rows, d, out);
  return -1;
}
