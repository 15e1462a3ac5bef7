// Decode of (window, term) cells into dense docid-major frequency tiles.
// Counterpart of trinity_tpu/ops/postings.py:materialize_freq_tiles; see
// trinity_tpu_torch/ops/postings.py for the contract and the source note.
#include <cuda_pipeline.h>

#include "decode.cuh"

namespace {

constexpr int DECODE_THREADS = 256;
constexpr int DECODE_WARPS = DECODE_THREADS / 32;
constexpr int RANGE = 2048;  // docs a block owns
constexpr int NRANGE = trin::WINDOW / RANGE;
constexpr int META_TILE = 128;  // metadata rows a block reads at once
// postings blocks that can meet a range: a block holds 128 distinct docs,
// so at most RANGE / 128 lie inside it, plus one at each edge
constexpr int RANGE_ROWS = RANGE / 128 + 2;
// plane rows a block stages: the span of those blocks' plane rows (a
// dense term's 18 blocks take ~8); a wider span reads the rows directly
constexpr int SPAN_ROWS = 24;

// One block per (cell, range of RANGE docs). The range's freq tile (and
// offsets tile) is built in shared memory, zeroed first. The cell's
// metadata rows come in tiles of META_TILE, a row a thread, into shared
// memory; two block-wide counts give the rows that meet the range
// (consecutive: a term's blocks are sorted and disjoint). The span of
// plane rows those blocks read is copied into shared memory with
// asynchronous 16-byte copies, all issued before the first is waited for,
// so the block pays one memory round trip for its planes, not one per
// decode round. The warps decode the rows, a row a warp in turn, and
// store the valid postings in the range's tile (a term holds a doc at most
// once, so the stores never collide). Then each 16-byte word of the range
// is written to the cell once.
__global__ void __launch_bounds__(DECODE_THREADS)
decode_tiles_kernel(const int* __restrict__ bmeta,
                    const int* __restrict__ planes,
                    const int* __restrict__ cell_start,
                    const int* __restrict__ cell_nblocks,
                    const int* __restrict__ window_base, int T,
                    float* __restrict__ tiles, long long stride_w,
                    long long stride_t, int* __restrict__ offs) {
  __shared__ float4 sfreq4[RANGE / 4];
  __shared__ int4 soff4[RANGE / 4];
  __shared__ int4 smeta[META_TILE][2];  // a tile of metadata rows
  __shared__ int4 splanes[SPAN_ROWS][32];  // plane rows span0, span0 + 1, ...
  __shared__ int sspan[2];  // the staged span: first row, count (0: none)
  float* sfreq = reinterpret_cast<float*>(sfreq4);
  int* soff = reinterpret_cast<int*>(soff4);
  const int cell = blockIdx.x / NRANGE;  // w * T + t
  const int r0 = (blockIdx.x % NRANGE) * RANGE;
  const int w = cell / T;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int i = tid; i < RANGE / 4; i += blockDim.x) {
    sfreq4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (offs) soff4[i] = make_int4(0, 0, 0, 0);
  }
  const int b0 = cell_start[cell];
  const int n = cell_nblocks[cell];
  const int wdoc = window_base[w] * trin::WINDOW;
  const uint32_t lo = wdoc + r0, hi = wdoc + r0 + RANGE;
  for (int t0 = 0; t0 < n; t0 += META_TILE) {
    bool below = false, meets = false;
    if (tid < META_TILE && t0 + tid < n) {
      int4 m0, m1;
      trin::load_meta(bmeta, b0 + t0 + tid, m0, m1);
      smeta[tid][0] = m0;
      smeta[tid][1] = m1;
      below = static_cast<uint32_t>(m1.z) < lo;  // C_LAST
      meets = !below && static_cast<uint32_t>(m0.w) < hi;  // C_FIRST
    }
    // (the counts are barriers too: the zero fill and smeta are visible)
    const int j0 = __syncthreads_count(below);
    const int j1 = j0 + __syncthreads_count(meets);
    for (int g0 = j0; g0 < j1; g0 += RANGE_ROWS) {  // one pass in practice
      const int rows = min(RANGE_ROWS, j1 - g0);
      if (warp == 0) {  // the span of the rows' plane rows (3 each)
        uint32_t first = 0xffffffffu, last = 0u;
        if (lane < rows) {
          const uint32_t r = static_cast<uint32_t>(smeta[g0 + lane][0].x) >> 5;
          first = r;
          last = r + 2;
        }
        first = __reduce_min_sync(trin::FULL, first);
        last = __reduce_max_sync(trin::FULL, last);
        if (lane == 0) {
          sspan[0] = static_cast<int>(first);
          sspan[1] = last - first + 1 <= SPAN_ROWS ? last - first + 1 : 0;
        }
      }
      __syncthreads();
      const int span0 = sspan[0], nspan = sspan[1];
      // the span's rows in shared memory: asynchronous 16-byte copies, all
      // issued before the first is waited for
      for (int c = tid; c < nspan * 32; c += blockDim.x)
        __pipeline_memcpy_async(
            &splanes[c / 32][c % 32],
            reinterpret_cast<const int4*>(
                planes + static_cast<size_t>(span0 + c / 32) * trin::TILE) +
                c % 32,
            sizeof(int4));
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      for (int row = warp; row < rows; row += DECODE_WARPS) {
        trin::RawBlock r;
        trin::set_meta(r, smeta[g0 + row][0], smeta[g0 + row][1]);
        if (nspan) {
          const int k = static_cast<int>(r.poff >> 5) - span0;
          r.a = splanes[k][lane];
          r.b = splanes[k + 1][lane];
          r.c = splanes[k + 2][lane];
        } else {
          trin::load_rows(planes, r);
        }
        trin::Lanes4 o;
        trin::decode_loaded(r, wdoc, r0, r0 + RANGE, o);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!o.valid[i]) continue;
          sfreq[o.local[i] - r0] = o.freq[i];
          if (offs) soff[o.local[i] - r0] = o.off[i];
        }
      }
      __syncthreads();
    }
  }
  float4* dst = reinterpret_cast<float4*>(
      tiles + w * stride_w + (cell - w * T) * stride_t + r0);
  int4* odst = offs ? reinterpret_cast<int4*>(
                          offs + static_cast<size_t>(cell) * trin::WINDOW + r0)
                    : nullptr;
  for (int i = tid; i < RANGE / 4; i += blockDim.x) {
    dst[i] = sfreq4[i];
    if (odst) odst[i] = soff4[i];
  }
}

}  // namespace

// tiles: the (W, T, 128, 128) freq destination, given by its base pointer
// and its window and term strides in elements (each cell's tile contiguous,
// 16-byte aligned), so a strided view of a larger cache takes the tiles
// directly; offs: a contiguous (W, T, 128, 128) i32 tensor, or NULL.
extern "C" int trin_decode_tiles(const int* bmeta, const int* planes,
                                 const int* cell_start,
                                 const int* cell_nblocks,
                                 const int* window_base, int W, int T,
                                 float* tiles, long long stride_w,
                                 long long stride_t, int* offs,
                                 cudaStream_t stream) {
  decode_tiles_kernel<<<W * T * NRANGE, DECODE_THREADS, 0, stream>>>(
      bmeta, planes, cell_start, cell_nblocks, window_base, T, tiles,
      stride_w, stride_t, offs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
