// Per-doc position-presence words of (window, member) cells.
// Counterpart of trinity_tpu/ops/posmask.py:materialize_posmask_tiles; see
// trinity_tpu_torch/ops/posmask.py for the contract and the source note.
#include "decode.cuh"

namespace {

constexpr int POSMASK_THREADS = 256;
constexpr int SLAB = 8;  // output words a thread holds in registers at once

// Position element e of the plane-packed positions stream
// (utils/bitpack.py pack_value_groups): group e >> 7, lane e & 127, the
// b-bit field at plane offset hit_off[g] across two words of the lane
// (the caller's guard rows keep the second word in bounds).
__device__ __forceinline__ uint32_t position_at(const int* __restrict__ hit_pw,
                                                const int* __restrict__ hit_off,
                                                uint32_t e) {
  const uint32_t g = e >> 7;
  const uint32_t lane = e & 127u;
  const int p0 = __ldg(hit_off + g);
  const int b = __ldg(hit_off + g + 1) - p0;
  const size_t row = static_cast<size_t>(static_cast<uint32_t>(p0) >> 5);
  const uint32_t lo = static_cast<uint32_t>(__ldg(hit_pw + row * trin::TILE + lane));
  const uint32_t hi =
      static_cast<uint32_t>(__ldg(hit_pw + (row + 1) * trin::TILE + lane));
  return trin::bitfield(lo, hi, p0 & 31, b);
}

// One block per (window, member) cell: zero the cell's PW words per doc,
// then each warp decodes every 8th postings block of the cell; the thread
// that owns a posting walks its run of positions, ORs each position's bit
// into registers (SLAB words per pass) and stores the doc's words. A term
// holds a doc once, so no two threads write one doc's words.
__global__ void __launch_bounds__(POSMASK_THREADS)
posmask_tiles_kernel(const int* __restrict__ bmeta,
                     const int* __restrict__ planes,
                     const int* __restrict__ hit_pw,
                     const int* __restrict__ hit_off,
                     const int* __restrict__ cell_start,
                     const int* __restrict__ cell_nblocks, int M, int PW,
                     int* __restrict__ out) {
  const int cell = blockIdx.x;  // w * M + m
  const int w = cell / M;
  int* words = out + static_cast<size_t>(cell) * PW * trin::WINDOW;
  const int n4 = PW * (trin::WINDOW / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<int4*>(words)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int b0 = cell_start[cell];
  const int n = cell_nblocks[cell];
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = warp; j < n; j += nwarps) {
    trin::Lanes4 o;
    trin::decode_block_warp(bmeta, planes, b0 + j, w * trin::WINDOW, 0,
                            trin::WINDOW, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!o.valid[i]) continue;
      const uint32_t e0 = static_cast<uint32_t>(o.off[i]);
      const int f = static_cast<int>(o.freq[i]);
      for (int k0 = 0; k0 < PW; k0 += SLAB) {
        uint32_t acc[SLAB];
#pragma unroll
        for (int s = 0; s < SLAB; ++s) acc[s] = 0u;
        for (int x = 0; x < f; ++x) {
          const uint32_t p = position_at(hit_pw, hit_off, e0 + x);
          const int word = static_cast<int>(p >> 5) - k0;
          const uint32_t bit = 1u << (p & 31u);
#pragma unroll
          for (int s = 0; s < SLAB; ++s) acc[s] |= word == s ? bit : 0u;
        }
#pragma unroll
        for (int s = 0; s < SLAB; ++s) {
          if (k0 + s < PW)
            words[static_cast<size_t>(k0 + s) * trin::WINDOW + o.local[i]] =
                static_cast<int>(acc[s]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int trin_posmask_tiles(const int* bmeta, const int* planes,
                                  const int* hit_pw, const int* hit_off,
                                  const int* cell_start,
                                  const int* cell_nblocks, int W, int M,
                                  int PW, int* out, cudaStream_t stream) {
  posmask_tiles_kernel<<<W * M, POSMASK_THREADS, 0, stream>>>(
      bmeta, planes, hit_pw, hit_off, cell_start, cell_nblocks, M, PW, out);
  return static_cast<int>(cudaGetLastError());
}
