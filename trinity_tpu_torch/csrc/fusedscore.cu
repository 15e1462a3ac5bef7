// Fused decode + boolean eval + similarity + sub-block maxima.
// Counterpart of trinity_tpu/ops/fusedscore.py (fused_flat_score_tiles,
// fused_score_tiles); see trinity_tpu_torch/ops/fusedscore.py for the
// contract and the source note.
//
// Outputs, both kernels: scores (B, W, 128, 128) f32, -inf where the doc
// does not match, is past n_docs or is deleted; rmax (B, W, 16, 128) f32,
// the max of each 1024-doc sub-block broadcast over the 128 lanes.
#include <math.h>

#include "decode.cuh"

namespace {

constexpr int NSUB = 16;
constexpr int SUB_DOCS = trin::WINDOW / NSUB;  // 1024

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(trin::FULL, v, s));
  return v;
}

// ------------------------------------------------------------------ flat
// One block of 256 threads per (half window, query), the query fastest in
// the grid, so the queries of a window run side by side and a hot-term
// plane that several of them read comes from L2. Per-doc running state
// for the block's 8192 docs lives in shared memory (40 KiB, so 4 blocks an
// SM): the f32 score sum and a byte holding the required-present count
// (bits 0-6) and the negated-present flag (bit 7). Thread i owns docs
// 4(i + 256k), k < 8, in every dense step, so cached slots (a thread
// reads its docs' freqs from the hot-term plane, all 8 16-byte loads
// issued before the first update) follow one another with no barrier. A
// decoded slot is a scatter into other threads' docs, so it sits between
// two barriers; its postings blocks are decoded up front, at block start,
// all decoded slots' at once (warp t finds which of slot t's blocks meet
// the half window, trin::overlap_rows_warp, and only those are decoded;
// warp k decodes and holds flattened row k of them), so their metadata and
// plane loads overlap instead of costing a round trip per slot. Slots are
// applied in slot order, so each doc's sum is taken in the reference's
// order (absent slots add nothing, where the reference adds an exact
// +0.0). A padding row (no slot, kmin > 0) writes -inf directly. Scores go
// out as 16-byte words, written once; the sub-block maxima from a warp max
// and a max over the sub-block's 8 warp-words.
constexpr int FLAT_SPLIT = 2;  // blocks a (window, query) is cut into
constexpr int FLAT_DOCS = trin::WINDOW / FLAT_SPLIT;  // docs a block owns
constexpr int FLAT_THREADS = 512 / FLAT_SPLIT;
constexpr int FLAT_WARPS = FLAT_THREADS / 32;
constexpr int FLAT_WORDS = FLAT_DOCS / 4 / FLAT_THREADS;  // 8 a thread
constexpr int FLAT_SUBS = NSUB / FLAT_SPLIT;  // sub-blocks a block owns
constexpr int FLAT_SMEM = FLAT_DOCS * (sizeof(float) + 1);
static_assert(FLAT_SUBS == FLAT_WARPS, "a warp a row of maxima");
constexpr int FLAT_MAX_SLOTS = 8;  // slots a query has (the executor's cap)
static_assert(FLAT_WARPS >= FLAT_MAX_SLOTS, "a warp a slot");

__global__ void __launch_bounds__(FLAT_THREADS, 2 * FLAT_SPLIT)
flat_score_kernel(const int* __restrict__ bmeta,
                  const int* __restrict__ planes,
                  const int* __restrict__ cell_start,
                  const int* __restrict__ cell_nblocks,
                  const float* __restrict__ weights,
                  const int* __restrict__ flags,
                  const int* __restrict__ kmin,
                  const int* __restrict__ cids,
                  const float* __restrict__ tf_planes, int W_tf, int n_docs,
                  const float* __restrict__ deleted, int W, int B, int T,
                  int scorer, float* __restrict__ scores,
                  float* __restrict__ rmax) {
  extern __shared__ float4 smem4[];
  float* ssum = reinterpret_cast<float*>(smem4);
  uint32_t* st4 = reinterpret_cast<uint32_t*>(ssum + FLAT_DOCS);
  unsigned char* st = reinterpret_cast<unsigned char*>(st4);
  __shared__ int sfl[FLAT_MAX_SLOTS], scid[FLAT_MAX_SLOTS];
  __shared__ int sb0[FLAT_MAX_SLOTS], sn[FLAT_MAX_SLOTS];
  __shared__ float swt[FLAT_MAX_SLOTS];
  __shared__ float red[FLAT_SUBS][SUB_DOCS / 128];  // [sub-block][its warp word]
  const int b = blockIdx.x;
  const int w = blockIdx.y / FLAT_SPLIT;
  const int p0 = (blockIdx.y % FLAT_SPLIT) * FLAT_DOCS;  // the block's docs
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wdoc = w * trin::WINDOW;
  float* out = scores + (static_cast<size_t>(b) * W + w) * trin::WINDOW + p0;
  float* rrow =
      rmax + ((static_cast<size_t>(b) * W + w) * NSUB + p0 / SUB_DOCS) * trin::TILE;

  if (warp < FLAT_MAX_SLOTS) {  // warp t reads slot t (past T: padding)
    int fl = 0, cid = -1, s0 = 0, n = 0;
    float wt = 0.f;
    if (warp < T) {
      const int slot = b * T + warp;
      const size_t cell = static_cast<size_t>(w) * B * T + slot;
      fl = flags[slot];
      cid = cids[slot];
      wt = weights[slot];
      s0 = cell_start[cell];
      n = fl != 0 && cid < 0 ? cell_nblocks[cell] : 0;
    }
    // a decoded slot's rows that meet the block's docs (overlap_rows_warp)
    const int2 rows = trin::overlap_rows_warp(bmeta, s0, n, wdoc + p0,
                                              wdoc + p0 + FLAT_DOCS);
    if (lane == 0) {
      sfl[warp] = fl;
      scid[warp] = cid;
      swt[warp] = wt;
      sb0[warp] = s0 + rows.x;
      sn[warp] = rows.y - rows.x;
    }
  }
  const int km = kmin[b];
  __syncthreads();
  bool any = false;
  for (int t = 0; t < T; ++t) any |= sfl[t] != 0;
  if (!any && km > 0) {  // a padding row matches nothing
    const float4 ninf =
        make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    for (int i = tid; i < FLAT_DOCS / 4; i += FLAT_THREADS)
      reinterpret_cast<float4*>(out)[i] = ninf;
    for (int i = tid; i < FLAT_SUBS * trin::TILE / 4; i += FLAT_THREADS)
      reinterpret_cast<float4*>(rrow)[i] = ninf;
    return;
  }

  // the decoded slots' rows, flattened in slot order; warp k decodes row
  // k now and holds it
  int hslot = -1, hblk = 0;  // the slot and the postings block of the held row
#pragma unroll
  for (int t = 0, base = 0; t < FLAT_MAX_SLOTS; base += sn[t], ++t)
    if (warp >= base && warp < base + sn[t]) {
      hslot = t;
      hblk = sb0[t] + warp - base;
    }
  // zero this thread's docs while the held row's loads are in flight
#pragma unroll
  for (int k = 0; k < FLAT_WORDS; ++k) {
    const int i = tid + k * FLAT_THREADS;
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    st4[i] = 0u;
  }
  trin::Lanes4 held;
  if (hslot >= 0)
    trin::decode_block_warp(bmeta, planes, hblk, wdoc, p0, p0 + FLAT_DOCS,
                            held);

  // base: the flattened index of slot t's first decoded row
  for (int t = 0, base = 0; t < T; base += sn[t], ++t) {
    const int fl = sfl[t];
    if (fl == 0) continue;  // a padding slot changes no doc's state
    const bool req = fl & 1, neg = fl & 2, scored = fl & 5;
    const float wt = swt[t];
    auto apply = [&](int d, float f) {
      if (scored)
        ssum[d] = __fadd_rn(ssum[d], trin::score_tile(scorer, f, wt));
      unsigned char s = st[d];
      if (req) s += 1;
      if (neg) s |= 0x80;
      st[d] = s;
    };
    const int cid = scid[t];
    if (cid >= 0) {  // hot-term plane: this thread's docs, no barrier
      const float4* src = reinterpret_cast<const float4*>(
          tf_planes + (static_cast<size_t>(cid) * W_tf + w) * trin::WINDOW +
          p0);
      float4 v[FLAT_WORDS];
#pragma unroll
      for (int k = 0; k < FLAT_WORDS; ++k)
        v[k] = __ldg(src + tid + k * FLAT_THREADS);
#pragma unroll
      for (int k = 0; k < FLAT_WORDS; ++k) {
        const int d = 4 * (tid + k * FLAT_THREADS);
        if (v[k].x > 0.f) apply(d, v[k].x);
        if (v[k].y > 0.f) apply(d + 1, v[k].y);
        if (v[k].z > 0.f) apply(d + 2, v[k].z);
        if (v[k].w > 0.f) apply(d + 3, v[k].w);
      }
    } else if (sn[t]) {  // decoded: a scatter between two barriers
      __syncthreads();
      if (hslot == t) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (held.valid[i]) apply(held.local[i] - p0, held.freq[i]);
      }
      // rows past the warps' held ones: decoded here
      for (int r = max(base, FLAT_WARPS) + warp; r < base + sn[t];
           r += FLAT_WARPS) {
        trin::Lanes4 o;
        trin::decode_block_warp(bmeta, planes, sb0[t] + r - base, wdoc, p0,
                                p0 + FLAT_DOCS, o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (o.valid[i]) apply(o.local[i] - p0, o.freq[i]);
      }
      __syncthreads();
    }
  }

  // this thread's docs: scores as 16-byte words; the sub-block maxima from
  // a warp max (a warp's words lie in one sub-block) and a max over the
  // sub-block's 8 warps
  const int nd_local = n_docs - wdoc - p0;  // the block's docs in the segment
  const float* del =
      deleted ? deleted + static_cast<size_t>(w) * trin::WINDOW + p0 : nullptr;
#pragma unroll
  for (int k = 0; k < FLAT_WORDS; ++k) {
    const int i = tid + k * FLAT_THREADS;
    const int d = 4 * i;
    const float4 s4 = smem4[i];
    const uint32_t sw = st4[i];
    const float4 dl = del ? __ldg(reinterpret_cast<const float4*>(del + d))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float dv[4] = {dl.x, dl.y, dl.z, dl.w};
    float o[4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t s = (sw >> (8 * j)) & 0xffu;
      const bool m = static_cast<int>(s & 0x7f) >= km && !(s & 0x80) &&
                     d + j < nd_local && dv[j] == 0.f;
      o[j] = m ? sv[j] : -INFINITY;
      mx = fmaxf(mx, o[j]);
    }
    reinterpret_cast<float4*>(out)[i] = make_float4(o[0], o[1], o[2], o[3]);
    mx = warp_max(mx);
    // word i lies in the block's sub-block i / 256, as warp word i % 256 / 32
    if (lane == 0) red[i / (SUB_DOCS / 4)][i % (SUB_DOCS / 4) / 32] = mx;
  }
  __syncthreads();
  {  // warp s writes sub-block s's row of maxima
    float mx = red[warp][0];
#pragma unroll
    for (int i = 1; i < SUB_DOCS / 128; ++i) mx = fmaxf(mx, red[warp][i]);
    reinterpret_cast<float4*>(rrow + warp * trin::TILE)[lane] =
        make_float4(mx, mx, mx, mx);
  }
}

int launch_flat(const int* bmeta, const int* planes, const int* cell_start,
                const int* cell_nblocks, const float* weights,
                const int* flags, const int* kmin, const int* cids,
                const float* tf_planes, int W_tf, int n_docs,
                const float* deleted, int W, int B, int T, int scorer,
                float* scores, float* rmax, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flat_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FLAT_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flat_score_kernel<<<dim3(B, W * FLAT_SPLIT), FLAT_THREADS, FLAT_SMEM,
                      stream>>>(
      bmeta, planes, cell_start, cell_nblocks, weights, flags, kmin, cids,
      tf_planes, W_tf, n_docs, deleted, W, B, T, scorer, scores, rmax);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ tape
// One block per (window, 2048-doc chunk, query). Each used slot's freqs
// for the chunk are staged in shared memory (8 KiB a slot), all slots at
// once: cached slots copy their hot-term planes while the block counts,
// over every decoded slot's cell together, the postings blocks that meet
// the chunk; then the warps decode those blocks. Then every thread
// evaluates the tape's register program (ops/fusedscore.py encode_tape)
// for 8 docs, D at a time: the op loop runs over the program once per D
// docs, each op unrolled over the NR registers and the D docs, so the
// registers stay in the register file (no stack in local memory). A
// register is D f32 scores and one word of D match bytes (0/1, or a
// k-of-n count).
constexpr int TAPE_THREADS = 256;
constexpr int NCHUNK = 8;
constexpr int CHUNK = trin::WINDOW / NCHUNK;  // 2048 = 2 sub-blocks
constexpr int DOCS_PER_THREAD = CHUNK / TAPE_THREADS;  // 8
constexpr int MAX_PROG = 64;
constexpr int MAX_USED = 8;
// register ops (op, dst, a, b); binary ops read dst and dst + 1
enum {
  OP_TOK,    // r = staged tile a scored with weight b
  OP_AND,    // r = r AND r+1, scores summed
  OP_OR,     // r = r OR r+1, scores summed
  OP_NOT,    // r = r AND NOT r+1, r's score
  OP_UNOT,   // r = NOT r, score 0
  OP_OPT,    // r = true, r's score where r matched
  OP_SACC,   // k-of-n: r's count += r+1's match, r's sum += r+1's score
  OP_SFIN,   // k-of-n: r = (count >= a), the sum where it holds
  OP_FALSE,  // r = false
};

// Stage the used slots' freqs for docs [c0, c0 + CHUNK) of window w into
// tiles[U][CHUNK]; ends with the block synchronised.
__device__ __forceinline__ void stage_slots(
    const int* __restrict__ bmeta, const int* __restrict__ planes,
    const int* __restrict__ cell_start, const int* __restrict__ cell_nblocks,
    const int* __restrict__ cids, const int* __restrict__ used, int U,
    const float* __restrict__ tf_planes, int W_tf, int w, int c0, int b,
    int B, int T, float* tiles) {
  __shared__ int scid[MAX_USED];  // hot plane of slot u, or -1: decoded
  __shared__ int sb0[MAX_USED];   // decoded: the cell's first block
  __shared__ int sn[MAX_USED];    // decoded: the cell's block count
  __shared__ int sbelow[MAX_USED], supto[MAX_USED];  // overlap_rows' counts
  const int tid = threadIdx.x;
  const int wdoc = w * trin::WINDOW;
  float4* tiles4 = reinterpret_cast<float4*>(tiles);
  for (int i = tid; i < U * CHUNK / 4; i += blockDim.x)
    tiles4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < U) {
    const int slot = b * T + used[tid];
    const size_t cell = static_cast<size_t>(w) * B * T + slot;
    const int cid = cids[slot];
    scid[tid] = cid;
    sb0[tid] = cell_start[cell];
    sn[tid] = cid >= 0 ? 0 : cell_nblocks[cell];
    sbelow[tid] = supto[tid] = 0;
  }
  __syncthreads();
  for (int i = tid; i < U * CHUNK / 4; i += blockDim.x) {
    const int u = i / (CHUNK / 4);
    if (scid[u] >= 0)
      tiles4[i] = __ldg(reinterpret_cast<const float4*>(
                            tf_planes +
                            (static_cast<size_t>(scid[u]) * W_tf + w) *
                                trin::WINDOW +
                            c0) +
                        (i - u * (CHUNK / 4)));
  }
  // the rows of every decoded cell, flattened: row t is block t - base of
  // the slot u whose rows start at base (see trin::overlap_rows)
  const uint32_t lo = wdoc + c0, hi = wdoc + c0 + CHUNK;
  for (int t = tid, u = 0, base = 0;; t += blockDim.x) {
    while (u < U && t >= base + sn[u]) {
      base += sn[u];
      ++u;
    }
    if (u >= U) break;
    const int* m = bmeta + static_cast<size_t>(sb0[u] + t - base) * trin::META_COLS;
    if (static_cast<uint32_t>(__ldg(m + trin::C_LAST)) < lo) atomicAdd(sbelow + u, 1);
    if (static_cast<uint32_t>(__ldg(m + trin::C_FIRST)) < hi) atomicAdd(supto + u, 1);
  }
  __syncthreads();
  // the blocks that meet the chunk, flattened the same way, a warp each
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp, u = 0, base = 0;; t += nwarps) {
    while (u < U && t >= base + supto[u] - sbelow[u]) {
      base += supto[u] - sbelow[u];
      ++u;
    }
    if (u >= U) break;
    trin::Lanes4 o;
    trin::decode_block_warp(bmeta, planes, sb0[u] + sbelow[u] + t - base, wdoc,
                            c0, c0 + CHUNK, o);
    float* tu = tiles + u * CHUNK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (o.valid[i]) tu[o.local[i] - c0] = o.freq[i];
  }
  __syncthreads();
}

template <int NR, int D>
__global__ void __launch_bounds__(TAPE_THREADS)
tape_score_kernel(const int* __restrict__ bmeta,
                  const int* __restrict__ planes,
                  const int* __restrict__ cell_start,
                  const int* __restrict__ cell_nblocks,
                  const float* __restrict__ weights, int NW,
                  const int* __restrict__ cids,
                  const int4* __restrict__ prog, int L,
                  const int* __restrict__ used, int U,
                  const float* __restrict__ tf_planes, int W_tf, int n_docs,
                  const float* __restrict__ deleted, int W, int B, int T,
                  int scorer, float* __restrict__ scores,
                  float* __restrict__ rmax) {
  static_assert(D == 1 || D == 2 || D == 4, "a word holds D match bytes");
  constexpr uint32_t ONES = D == 4 ? 0x01010101u : D == 2 ? 0x0101u : 0x01u;
  extern __shared__ float4 tiles4[];
  float* tiles = reinterpret_cast<float*>(tiles4);  // [U][CHUNK]
  __shared__ int4 sprog[MAX_PROG];
  __shared__ float red[TAPE_THREADS / 32];
  const int w = blockIdx.x / NCHUNK;
  const int c0 = (blockIdx.x % NCHUNK) * CHUNK;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wdoc = w * trin::WINDOW;

  for (int i = tid; i < L; i += blockDim.x) sprog[i] = prog[i];
  stage_slots(bmeta, planes, cell_start, cell_nblocks, cids, used, U,
              tf_planes, W_tf, w, c0, b, B, T, tiles);
  const float* wrow = weights + static_cast<size_t>(b) * NW;

  const int half = tid / trin::TILE;  // sub-block within the chunk
  const int l = tid % trin::TILE;
  const int nd_local = n_docs - wdoc;
  const float* del =
      deleted ? deleted + static_cast<size_t>(w) * trin::WINDOW + c0 : nullptr;
  float* out = scores + (static_cast<size_t>(b) * W + w) * trin::WINDOW + c0;
  float mx = -INFINITY;
  for (int p = 0; p < DOCS_PER_THREAD / D; ++p) {
    uint32_t mc[NR];  // byte i: doc i's match (0/1) or k-of-n count
    float s[NR][D];
    int d[D];  // docs within the chunk
#pragma unroll
    for (int i = 0; i < D; ++i)
      d[i] = half * SUB_DOCS + (p * D + i) * trin::TILE + l;
    for (int pc = 0; pc < L; ++pc) {
      const int4 op = sprog[pc];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (op.y != r) continue;  // uniform: every thread runs one program
        const int r1 = r + 1 < NR ? r + 1 : r;  // binary ops have r < NR-1
        switch (op.x) {
          case OP_TOK: {
            const float* tu = tiles + op.z * CHUNK;
            const float wt = __ldg(wrow + op.w);
            mc[r] = 0u;
#pragma unroll
            for (int i = 0; i < D; ++i) {
              const float f = tu[d[i]];
              mc[r] |= static_cast<uint32_t>(f > 0.f) << (8 * i);
              s[r][i] = f > 0.f ? trin::score_tile(scorer, f, wt) : 0.f;
            }
            break;
          }
          case OP_AND:
          case OP_OR:
            mc[r] = op.x == OP_AND ? mc[r] & mc[r1] : mc[r] | mc[r1];
#pragma unroll
            for (int i = 0; i < D; ++i)
              s[r][i] = ((mc[r] >> (8 * i)) & 1u) ? __fadd_rn(s[r][i], s[r1][i]) : 0.f;
            break;
          case OP_NOT:
            mc[r] &= ~mc[r1];
#pragma unroll
            for (int i = 0; i < D; ++i) s[r][i] = ((mc[r] >> (8 * i)) & 1u) ? s[r][i] : 0.f;
            break;
          case OP_UNOT:
            mc[r] ^= ONES;
#pragma unroll
            for (int i = 0; i < D; ++i) s[r][i] = 0.f;
            break;
          case OP_OPT:
#pragma unroll
            for (int i = 0; i < D; ++i) s[r][i] = ((mc[r] >> (8 * i)) & 1u) ? s[r][i] : 0.f;
            mc[r] = ONES;
            break;
          case OP_SACC:
            mc[r] += mc[r1];  // bytewise: a count stays below 256
#pragma unroll
            for (int i = 0; i < D; ++i) s[r][i] = __fadd_rn(s[r][i], s[r1][i]);
            break;
          case OP_SFIN:
            mc[r] = __vcmpgeu4(mc[r], static_cast<uint32_t>(op.z) * 0x01010101u) & ONES;
#pragma unroll
            for (int i = 0; i < D; ++i) s[r][i] = ((mc[r] >> (8 * i)) & 1u) ? s[r][i] : 0.f;
            break;
          default:  // OP_FALSE
            mc[r] = 0u;
#pragma unroll
            for (int i = 0; i < D; ++i) s[r][i] = 0.f;
            break;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const bool in_seg =
          c0 + d[i] < nd_local && (del == nullptr || del[d[i]] == 0.f);
      const float sc = (((mc[0] >> (8 * i)) & 1u) && in_seg) ? s[0][i] : -INFINITY;
      out[d[i]] = sc;
      mx = fmaxf(mx, sc);
    }
  }
  mx = warp_max(mx);
  if ((tid & 31) == 0) red[warp] = mx;
  __syncthreads();
  const int wpb = trin::TILE / 32;  // warps per sub-block
  float mxs = red[half * wpb];
  for (int i = 1; i < wpb; ++i) mxs = fmaxf(mxs, red[half * wpb + i]);
  const int sub = c0 / SUB_DOCS + half;
  rmax[((static_cast<size_t>(b) * W + w) * NSUB + sub) * trin::TILE + l] = mxs;
}

template <int NR, int D>
int launch_tape(const int* bmeta, const int* planes, const int* cell_start,
                const int* cell_nblocks, const float* weights, int NW,
                const int* cids, const int* prog, int L, const int* used,
                int U, const float* tf_planes, int W_tf, int n_docs,
                const float* deleted, int W, int B, int T, int scorer,
                float* scores, float* rmax, cudaStream_t stream) {
  static_assert(NR * D == 16 && DOCS_PER_THREAD % D == 0, "register file");
  cudaError_t e = cudaFuncSetAttribute(
      tape_score_kernel<NR, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_USED * CHUNK * static_cast<int>(sizeof(float)));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = U * CHUNK * static_cast<int>(sizeof(float));
  tape_score_kernel<NR, D><<<dim3(W * NCHUNK, B), TAPE_THREADS, smem, stream>>>(
      bmeta, planes, cell_start, cell_nblocks, weights, NW, cids,
      reinterpret_cast<const int4*>(prog), L, used, U, tf_planes, W_tf,
      n_docs, deleted, W, B, T, scorer, scores, rmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int trin_flat_score(const int* bmeta, const int* planes,
                               const int* cell_start, const int* cell_nblocks,
                               const float* weights, const int* flags,
                               const int* kmin, const int* cids,
                               const float* tf_planes, int W_tf, int n_docs,
                               const float* deleted, int W, int B, int T,
                               int scorer, float* scores, float* rmax,
                               cudaStream_t stream) {
  if (T < 1 || T > FLAT_MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  return launch_flat(bmeta, planes, cell_start, cell_nblocks, weights, flags,
                     kmin, cids, tf_planes, W_tf, n_docs, deleted, W, B, T,
                     scorer, scores, rmax, stream);
}

// prog: (L, 4) i32 register program using nreg registers (at most 16);
// used: the U term slots it reads, in the order of its staged tiles.
extern "C" int trin_tape_score(const int* bmeta, const int* planes,
                               const int* cell_start, const int* cell_nblocks,
                               const float* weights, int NW, const int* cids,
                               const int* prog, int L, int nreg,
                               const int* used, int U, const float* tf_planes,
                               int W_tf, int n_docs, const float* deleted,
                               int W, int B, int T, int scorer, float* scores,
                               float* rmax, cudaStream_t stream) {
  if (U < 1 || U > MAX_USED || L < 1 || L > MAX_PROG || nreg < 1 || nreg > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = nreg <= 4 ? launch_tape<4, 4>
                       : nreg <= 8 ? launch_tape<8, 2> : launch_tape<16, 1>;
  return run(bmeta, planes, cell_start, cell_nblocks, weights, NW, cids, prog,
             L, used, U, tf_planes, W_tf, n_docs, deleted, W, B, T, scorer,
             scores, rmax, stream);
}
