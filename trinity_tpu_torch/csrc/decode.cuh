// Block decode shared by the kernels (postings.cu, fusedscore.cu,
// posmask.cu).
//
// Postings layout (trinity_tpu/utils/bitpack.py): a 128-posting block's
// values are bit planes stacked in a (rows, 128) u32 plane matrix, so the
// bits of lane l form a contiguous bit-field of the 96-bit value
// (planes[r][l] | planes[r+1][l] << 32 | planes[r+2][l] << 64), with
// r = poff / 32 and the doc-delta field at [poff % 32, +bd) followed by the
// freq-1 field of bf bits. Block metadata is block-major: block b, column c
// at bmeta[b * 8 + c] (ops/postings.py pack_block_meta).
//
// One warp decodes one block: thread i owns lanes 4i..4i+3, reads each
// plane row as one 16-byte load, and a shuffle scan over the warp turns
// the deltas into docids (and the freqs into hits offsets).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace trin {

constexpr int TILE = 128;
constexpr int WINDOW = TILE * TILE;  // docs per window (one tile)
constexpr int META_COLS = 8;
enum { C_POFF, C_BD, C_BF, C_FIRST, C_COUNT, C_HITS, C_LAST, C_MAXF };
constexpr unsigned FULL = 0xffffffffu;

// One thread's four lanes of a decoded block.
struct Lanes4 {
  int local[4];   // docid minus the window's first docid
  float freq[4];  // stored freq-1, plus 1
  int off[4];     // offset of the posting's hits (C_HITS + exclusive sum)
  bool valid[4];  // lane < count and local in [lo, hi)
};

// Bits [sh, sh + width) of (hi << 32 | lo); sh in [0, 32), width in
// [0, 32]. A 32-bit shift by 32 is undefined in C++, so the field is taken
// from a 64-bit value and width 32 is masked explicitly.
__device__ __forceinline__ uint32_t bitfield(uint32_t lo, uint32_t hi,
                                             int sh, int width) {
  const uint64_t v = ((static_cast<uint64_t>(hi) << 32) | lo) >> sh;
  const uint32_t mask = width >= 32 ? FULL : ((1u << width) - 1u);
  return static_cast<uint32_t>(v) & mask;
}

// A block's metadata row (the columns the decode reads) and this lane's
// 16-byte words of its three plane rows.
struct RawBlock {
  uint32_t poff, first, hits;
  int bd, bf, count;
  int4 a, b, c;
};

// The metadata row of block `blk`, as two 16-byte words (rows are 32-byte
// aligned): x..w = C_POFF, C_BD, C_BF, C_FIRST, then C_COUNT, C_HITS,
// C_LAST, C_MAXF.
__device__ __forceinline__ void load_meta(const int* __restrict__ bmeta,
                                          int blk, int4& m0, int4& m1) {
  const int4* m = reinterpret_cast<const int4*>(
      bmeta + static_cast<size_t>(blk) * META_COLS);
  m0 = __ldg(m);
  m1 = __ldg(m + 1);
}

__device__ __forceinline__ void set_meta(RawBlock& r, int4 m0, int4 m1) {
  r.poff = static_cast<uint32_t>(m0.x);
  r.bd = m0.y;
  r.bf = m0.z;
  r.first = static_cast<uint32_t>(m0.w);
  r.count = m1.x;
  r.hits = static_cast<uint32_t>(m1.y);
}

// This lane's words of the block's three plane rows (needs r.poff).
__device__ __forceinline__ void load_rows(const int* __restrict__ planes,
                                          RawBlock& r) {
  const int4* row = reinterpret_cast<const int4*>(
                        planes + static_cast<size_t>(r.poff >> 5) * TILE) +
                    (threadIdx.x & 31);
  r.a = __ldg(row);
  r.b = __ldg(row + TILE / 4);
  r.c = __ldg(row + 2 * (TILE / 4));
}

// The decode of a loaded block by the whole warp (every lane must call
// it). wdoc: the window's first docid; [lo, hi): the doc range (relative
// to wdoc) whose postings count as valid.
__device__ __forceinline__ void decode_loaded(const RawBlock& r, int wdoc,
                                              int lo, int hi, Lanes4& o) {
  const int lane = threadIdx.x & 31;
  const uint32_t poff = r.poff, first = r.first, hits = r.hits;
  const int bd = r.bd, bf = r.bf, count = r.count;
  const int4 a = r.a, b = r.b, c = r.c;
  const uint32_t w0[4] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z,
                          (uint32_t)a.w};
  const uint32_t w1[4] = {(uint32_t)b.x, (uint32_t)b.y, (uint32_t)b.z,
                          (uint32_t)b.w};
  const uint32_t w2[4] = {(uint32_t)c.x, (uint32_t)c.y, (uint32_t)c.z,
                          (uint32_t)c.w};
  const int q = static_cast<int>(poff & 31u);
  const int s2 = q + bd;  // freq field start, < 64
  const bool in_lo = s2 < 32;
  uint32_t d[4], f[4], dsum = 0, fsum = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = bitfield(w0[i], w1[i], q, bd);
    f[i] = bitfield(in_lo ? w0[i] : w1[i], in_lo ? w1[i] : w2[i], s2 & 31,
                    bf) + 1u;
    dsum += d[i];
    fsum += f[i];
  }
  // inclusive warp scans of the per-thread sums (u32: wraps like the
  // reference's int32 arithmetic)
  uint32_t dinc = dsum, finc = fsum;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t dt = __shfl_up_sync(FULL, dinc, s);
    const uint32_t ft = __shfl_up_sync(FULL, finc, s);
    if (lane >= s) {
      dinc += dt;
      finc += ft;
    }
  }
  uint32_t doc = first + (dinc - dsum);
  uint32_t off = hits + (finc - fsum);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    doc += d[i];  // inclusive: lane 0's delta is part of its docid
    const int local = static_cast<int>(doc - static_cast<uint32_t>(wdoc));
    o.local[i] = local;
    o.freq[i] = static_cast<float>(f[i]);
    o.off[i] = static_cast<int>(off);
    off += f[i];
    o.valid[i] = (4 * lane + i < count) && local >= lo && local < hi;
  }
}

// Decode block `blk` with the whole warp (every lane must call it).
__device__ __forceinline__ void decode_block_warp(
    const int* __restrict__ bmeta, const int* __restrict__ planes, int blk,
    int wdoc, int lo, int hi, Lanes4& o) {
  RawBlock r;
  int4 m0, m1;
  load_meta(bmeta, blk, m0, m1);
  set_meta(r, m0, m1);
  load_rows(planes, r);
  decode_loaded(r, wdoc, lo, hi, o);
}

// Rows [first, second) of a cell's n postings blocks b0..b0+n-1 whose
// [C_FIRST, C_LAST] docids meet [lo, hi). A term's blocks are sorted by
// docid and disjoint, so the rows ending below lo and the rows starting
// below hi are both prefixes: their lengths are the bounds. One load pair
// per row, spread over the thread block; every thread must call it (the
// counts are __syncthreads_count, so no shared scratch is reused).
__device__ __forceinline__ int2 overlap_rows(const int* __restrict__ bmeta,
                                             int b0, int n, uint32_t lo,
                                             uint32_t hi) {
  int below = 0, upto = 0;
  for (int j0 = 0; j0 < n; j0 += blockDim.x) {
    const int j = j0 + static_cast<int>(threadIdx.x);
    uint32_t first = hi, last = lo;  // rows past n count in neither
    if (j < n) {
      const int* m = bmeta + static_cast<size_t>(b0 + j) * META_COLS;
      first = static_cast<uint32_t>(__ldg(m + C_FIRST));
      last = static_cast<uint32_t>(__ldg(m + C_LAST));
    }
    below += __syncthreads_count(last < lo);
    upto += __syncthreads_count(first < hi);
  }
  return make_int2(below, upto);
}

// overlap_rows by one warp, a lane a row, with ballots for the counts
// (every lane of the warp must call it, with the same b0 and n).
__device__ __forceinline__ int2 overlap_rows_warp(const int* __restrict__ bmeta,
                                                  int b0, int n, uint32_t lo,
                                                  uint32_t hi) {
  int below = 0, upto = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + static_cast<int>(threadIdx.x & 31);
    uint32_t first = hi, last = lo;  // rows past n count in neither
    if (j < n) {
      const int* m = bmeta + static_cast<size_t>(b0 + j) * META_COLS;
      first = static_cast<uint32_t>(__ldg(m + C_FIRST));
      last = static_cast<uint32_t>(__ldg(m + C_LAST));
    }
    below += __popc(__ballot_sync(FULL, last < lo));
    upto += __popc(__ballot_sync(FULL, first < hi));
  }
  return make_int2(below, upto);
}

// Per-doc similarity, f32, in the reference's operation order
// (trinity_tpu/models/similarity.py). The _rn intrinsics keep each step
// IEEE round-to-nearest and stop FMA contraction.
__device__ __forceinline__ float score_tile(int scorer, float f, float w) {
  switch (scorer) {
    case 0:  // bm25: (w * f) / (f + K1)
      return __fdiv_rn(__fmul_rn(w, f), __fadd_rn(f, 1.2f));
    case 1:  // tfidf: sqrt(f) * w
      return __fmul_rn(__fsqrt_rn(f), w);
    default:  // trivial: f
      return f;
  }
}

}  // namespace trin
