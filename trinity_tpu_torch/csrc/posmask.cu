// Per-doc position-presence words of (window, member) cells.
// Counterpart of trinity_tpu/ops/posmask.py:materialize_posmask_tiles; see
// trinity_tpu_torch/ops/posmask.py for the contract and the source note.
#include "decode.cuh"

namespace {

constexpr int POSMASK_THREADS = 256;
constexpr int POSMASK_WARPS = POSMASK_THREADS / 32;
constexpr int RANGE_WORDS = 8192;  // position words a block builds (32 KiB)

// Group g of the plane-packed positions stream (utils/bitpack.py
// pack_value_groups): 128 b-bit fields at plane offset hit_off[g], lane l
// holding fields 4l..4l+3 of the group's row (and of the next row, only
// when the fields cross a word; the caller's guard rows keep it in bounds).
struct GroupRow {
  int b, sh;
  int4 lo, hi;
};

__device__ __forceinline__ GroupRow load_group(const int* __restrict__ hit_pw,
                                               const int* __restrict__ hit_off,
                                               uint32_t g, int lane) {
  GroupRow r;
  const int p0 = __ldg(hit_off + g);
  r.b = __ldg(hit_off + g + 1) - p0;
  r.sh = p0 & 31;
  const int4* row = reinterpret_cast<const int4*>(
      hit_pw + static_cast<size_t>(static_cast<uint32_t>(p0) >> 5) * trin::TILE);
  r.lo = __ldg(row + lane);
  r.hi = r.sh + r.b > 32 ? __ldg(row + trin::TILE / 4 + lane)  // uniform
                         : make_int4(0, 0, 0, 0);
  return r;
}

// One block per (cell, range of R docs); the range's PW words per doc are
// built in shared memory ([PW][R], zeroed first) and written to the cell
// once, with 16-byte stores. The block counts the cell's postings blocks
// that meet its range (overlap_rows) and its warps take them in turn: a
// warp decodes a block (decode_block_warp), which leaves each lane with
// four postings' docs and run starts, then walks the positions groups
// (load_group) that the range's postings cover, one group at a time, the
// next group's loads in flight: a broadcast of the group's offsets, a
// 16-byte load of four fields a lane, and the group's run starts as a
// 128-bit map in shared memory ORed together by the warp, so lane l finds
// the posting of its elements 4l..4l+3 by counting map bits. The bit of
// each position is ORed into the doc's word with a shared-memory
// atomicOr.
__global__ void __launch_bounds__(POSMASK_THREADS)
posmask_tiles_kernel(const int* __restrict__ bmeta,
                     const int* __restrict__ planes,
                     const int* __restrict__ hit_pw,
                     const int* __restrict__ hit_off,
                     const int* __restrict__ cell_start,
                     const int* __restrict__ cell_nblocks, int M, int PW,
                     int R, long long stride_w, long long stride_m,
                     int* __restrict__ out) {
  extern __shared__ int4 words4[];
  uint32_t* words = reinterpret_cast<uint32_t*>(words4);  // [PW][R]
  __shared__ int pdoc[POSMASK_WARPS][trin::TILE];  // doc in range, or -1
  __shared__ __align__(16) uint32_t smaps[POSMASK_WARPS][4];  // run starts
  const int nsplit = trin::WINDOW / R;
  const int cell = blockIdx.x / nsplit;  // w * M + m
  const int r0 = (blockIdx.x % nsplit) * R;
  const int w = cell / M;
  const int wdoc = w * trin::WINDOW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < PW * R / 4; i += blockDim.x)
    words4[i] = make_int4(0, 0, 0, 0);
  const int b0 = cell_start[cell];
  // (its __syncthreads_count also orders the zero fill before the ORs)
  const int2 rows = trin::overlap_rows(bmeta, b0, cell_nblocks[cell],
                                       static_cast<uint32_t>(wdoc + r0),
                                       static_cast<uint32_t>(wdoc + r0 + R));
  int* pd = pdoc[warp];
  uint32_t* smap = smaps[warp];
  for (int j = rows.x + warp; j < rows.y; j += POSMASK_WARPS) {
    trin::Lanes4 o;
    trin::decode_block_warp(bmeta, planes, b0 + j, wdoc, r0, r0 + R, o);
    // the range's postings are consecutive lanes, so their runs form one
    // stretch [eb, ee) of the positions stream
    uint32_t eb = 0xffffffffu, ee = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pd[4 * lane + i] = o.valid[i] ? o.local[i] - r0 : -1;
      if (o.valid[i]) {
        eb = min(eb, static_cast<uint32_t>(o.off[i]));
        ee = max(ee, static_cast<uint32_t>(o.off[i]) +
                         static_cast<uint32_t>(o.freq[i]));
      }
    }
    eb = __reduce_min_sync(trin::FULL, eb);
    ee = __reduce_max_sync(trin::FULL, ee);
    __syncwarp();
    // groups [g, gend), each one's offsets and rows loaded one group ahead
    // (the loads of group g + 1 are in flight while group g is ORed in)
    uint32_t g = eb >> 7;
    const uint32_t gend = (ee + 127u) >> 7;
    GroupRow nx{};
    if (g < gend) nx = load_group(hit_pw, hit_off, g, lane);
    for (; g < gend; ++g) {
      const GroupRow cur = nx;
      if (g + 1 < gend) nx = load_group(hit_pw, hit_off, g + 1, lane);
      const uint32_t c = g << 7;  // the group's first element
      const int b = cur.b;
      const int sh = cur.sh;
      const int4 lo = cur.lo;
      const int4 hi = cur.hi;
      // the map: bit (start - c) for each posting whose run starts in
      // (c, c + 128), ORed in by the postings' lanes; `before` counts those
      // starting at or before c, the last of which owns element c
      if (lane < 4) smap[lane] = 0u;
      __syncwarp();
      uint32_t before = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t start = static_cast<uint32_t>(o.off[i]);
        const uint32_t q = start - c;
        before += start <= c;
        if (start > c && q < 128u) atomicOr(smap + (q >> 5), 1u << (q & 31u));
      }
      __syncwarp();
      const uint4 m4 = *reinterpret_cast<const uint4*>(smap);
      __syncwarp();
      // lane l's elements c + 4l .. c + 4l + 3 lie in map word l / 8; the
      // owner of the first is `before` - 1 plus the map bits up to it
      const int wd = lane >> 3;
      const uint32_t mw = wd == 0 ? m4.x : wd == 1 ? m4.y : wd == 2 ? m4.z : m4.w;
      const int x0 = 4 * lane;
      int own = static_cast<int>(__reduce_add_sync(trin::FULL, before)) - 1 +
                (wd > 0 ? __popc(m4.x) : 0) + (wd > 1 ? __popc(m4.y) : 0) +
                (wd > 2 ? __popc(m4.z) : 0) +
                __popc(mw & (0xffffffffu >> (31 - (x0 & 31))));
      const uint32_t field = b >= 32 ? 0xffffffffu : (1u << b) - 1u;
      const uint32_t lv[4] = {static_cast<uint32_t>(lo.x), static_cast<uint32_t>(lo.y),
                              static_cast<uint32_t>(lo.z), static_cast<uint32_t>(lo.w)};
      const uint32_t hv[4] = {static_cast<uint32_t>(hi.x), static_cast<uint32_t>(hi.y),
                              static_cast<uint32_t>(hi.z), static_cast<uint32_t>(hi.w)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k) own += (mw >> ((x0 + k) & 31)) & 1u;  // a run starts here
        const uint32_t e = c + static_cast<uint32_t>(x0 + k);
        if (e >= eb && e < ee) {
          const int d = pd[own];
          const uint32_t p = __funnelshift_r(lv[k], hv[k], sh) & field;
          if (d >= 0 && (p >> 5) < static_cast<uint32_t>(PW))
            atomicOr(words + (p >> 5) * R + d, 1u << (p & 31u));
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  int* dst = out + w * stride_w + (cell - w * M) * stride_m + r0;
  for (int k = 0; k < PW; ++k) {
    int4* d4 = reinterpret_cast<int4*>(dst + static_cast<size_t>(k) * trin::WINDOW);
    for (int i = tid; i < R / 4; i += blockDim.x) d4[i] = words4[k * (R / 4) + i];
  }
}

}  // namespace

// out: the (W, M, PW, 128, 128) destination, given by its base pointer and
// its window and member strides in elements (each member's PW words per
// doc contiguous, 16-byte aligned), so a strided view of a larger cache
// takes the words directly.
extern "C" int trin_posmask_tiles(const int* bmeta, const int* planes,
                                  const int* hit_pw, const int* hit_off,
                                  const int* cell_start,
                                  const int* cell_nblocks, int W, int M,
                                  int PW, int* out, long long stride_w,
                                  long long stride_m, cudaStream_t stream) {
  if (PW < 1 || PW * 128 > RANGE_WORDS)
    return static_cast<int>(cudaErrorInvalidValue);
  int R = trin::WINDOW;  // docs a block owns: a power of two, >= 128
  while (R * PW > RANGE_WORDS) R >>= 1;
  const int smem = PW * R * static_cast<int>(sizeof(int));
  posmask_tiles_kernel<<<W * M * (trin::WINDOW / R), POSMASK_THREADS, smem,
                         stream>>>(bmeta, planes, hit_pw, hit_off, cell_start,
                                   cell_nblocks, M, PW, R, stride_w, stride_m,
                                   out);
  return static_cast<int>(cudaGetLastError());
}
