// Phrase score tiles of a posmask group: phrase frequency from the members'
// position words, the similarity, liveness and sub-block maxima in one
// pass. Counterpart of the loop that trinity_tpu/exec/executor.py
// _build_phrase_pos_fused ran inside one XLA program; see
// trinity_tpu_torch/ops/posmask.py (phrase_score_tiles) for the contract.
#include <math.h>

#include "decode.cuh"

namespace {

constexpr int PHRASE_THREADS = 256;
constexpr int PHRASE_WARPS = PHRASE_THREADS / 32;
constexpr int SUB_DOCS = PHRASE_THREADS * 4;  // a block's docs: 4 a thread
constexpr int NSUB = trin::WINDOW / SUB_DOCS;  // 16 sub-blocks a window
constexpr int PLANE4 = trin::WINDOW / 4;       // int4s of one word plane

__device__ __forceinline__ uint4 load4(const int4* p) {
  const int4 v = __ldg(p);
  return make_uint4(static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                    static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w));
}

// Word pw of member m >= 1 shifted right by m across the word axis: bits
// of word pw + 1 (`nxt`, zero past the last word) move into the top m bits.
__device__ __forceinline__ uint32_t shifted(uint32_t cur, uint32_t nxt,
                                            int m) {
  return (cur >> m) | (nxt << (32 - m));
}

// One block per (window, sub-block, query), the query fastest, so the
// words of a member that several queries share (a hot term) come from L2.
// Thread t owns docs 4t..4t+3 of the sub-block and reads each member's
// words with 16-byte loads, streaming pw upwards with only words pw and
// pw + 1 of each member held (cur[] in registers: K is a template
// argument, so every index into it is known at compile time). The AND of
// the shifted words is popcounted per word and summed; a doc lives where
// that count is above 0 and it is not deleted; the score is taken in the
// plain version's f32 order (trin::score_tile); the block's maximum is
// its sub-block's entry of rmax.
template <int K>
__global__ void __launch_bounds__(PHRASE_THREADS)
phrase_score_kernel(const int* __restrict__ masks,
                    const int* __restrict__ cache,
                    const int* __restrict__ members,
                    const float* __restrict__ weights,
                    const float* __restrict__ deleted, int W, int B, int M,
                    int C, int PW, int scorer, float* __restrict__ scores,
                    float* __restrict__ rmax) {
  __shared__ const int4* base[K];
  __shared__ float red[PHRASE_WARPS];
  const int b = blockIdx.x % B;
  const int ws = blockIdx.x / B;  // w * NSUB + sub
  const int w = ws / NSUB;
  const int sub = ws % NSUB;
  const int tid = threadIdx.x;
  if (tid < K) {  // member tid's word 0 at this window: K4's column or a
                  // cache row (-1 - v)
    const int v = __ldg(members + b * K + tid);
    const int* p =
        v >= 0 ? masks + (static_cast<size_t>(w) * M + v) * PW * trin::WINDOW
               : cache + (static_cast<size_t>(w) * C + (-1 - v)) * PW *
                             trin::WINDOW;
    base[tid] = reinterpret_cast<const int4*>(p);
  }
  __syncthreads();
  const int q = sub * (SUB_DOCS / 4) + tid;  // this thread's int4 of a plane

  uint4 cur[K];
#pragma unroll
  for (int m = 0; m < K; ++m) cur[m] = load4(base[m] + q);
  int f[4] = {0, 0, 0, 0};
  for (int pw = 0; pw < PW; ++pw) {
    const bool more = pw + 1 < PW;
    const size_t off = static_cast<size_t>(pw + 1) * PLANE4 + q;
    uint4 nxt[K];
#pragma unroll
    for (int m = 0; m < K; ++m)
      nxt[m] = more ? load4(base[m] + off) : make_uint4(0u, 0u, 0u, 0u);
    uint4 acc = cur[0];
#pragma unroll
    for (int m = 1; m < K; ++m) {
      acc.x &= shifted(cur[m].x, nxt[m].x, m);
      acc.y &= shifted(cur[m].y, nxt[m].y, m);
      acc.z &= shifted(cur[m].z, nxt[m].z, m);
      acc.w &= shifted(cur[m].w, nxt[m].w, m);
    }
#pragma unroll
    for (int m = 0; m < K; ++m) cur[m] = nxt[m];
    f[0] += __popc(acc.x);
    f[1] += __popc(acc.y);
    f[2] += __popc(acc.z);
    f[3] += __popc(acc.w);
  }

  const size_t doc = static_cast<size_t>(w) * trin::WINDOW + sub * SUB_DOCS +
                     4 * tid;  // this thread's first doc in the window
  float4 dead = make_float4(0.f, 0.f, 0.f, 0.f);
  if (deleted != nullptr) dead = __ldg(reinterpret_cast<const float4*>(deleted + doc));
  const float dv[4] = {dead.x, dead.y, dead.z, dead.w};
  const float wt = __ldg(weights + b);
  float s[4];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = f[i] > 0 && dv[i] == 0.f
               ? trin::score_tile(scorer, __int2float_rn(f[i]), wt)
               : -INFINITY;
    mx = fmaxf(mx, s[i]);
  }
  *reinterpret_cast<float4*>(scores + static_cast<size_t>(b) * W * trin::WINDOW +
                             doc) = make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(trin::FULL, mx, o));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    float r = red[0];
#pragma unroll
    for (int i = 1; i < PHRASE_WARPS; ++i) r = fmaxf(r, red[i]);
    rmax[(static_cast<size_t>(b) * W + w) * NSUB + sub] = r;
  }
}

template <int K>
int launch_phrase(const int* masks, const int* cache, const int* members,
                  const float* weights, const float* deleted, int W, int B,
                  int M, int C, int PW, int scorer, float* scores,
                  float* rmax, cudaStream_t stream) {
  phrase_score_kernel<K><<<W * NSUB * B, PHRASE_THREADS, 0, stream>>>(
      masks, cache, members, weights, deleted, W, B, M, C, PW, scorer, scores,
      rmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// masks: the (W, M, PW, 128, 128) words of K4's columns, or NULL (M = 0);
// cache: the (W, C, PW, 128, 128) posmask hot cache, or NULL (C = 0);
// members: (B, K) i32, v >= 0 column v of masks, v < 0 cache row -1 - v;
// weights (B,) f32; deleted (W, 128, 128) f32 (1.0 = masked) or NULL.
// Writes scores (B, W, 128, 128) f32 (-inf outside the match) and rmax
// (B, W, 16) f32. Every tensor contiguous and 16-byte aligned.
extern "C" int trin_phrase_score(const int* masks, const int* cache,
                                 const int* members, const float* weights,
                                 const float* deleted, int W, int B, int K,
                                 int M, int C, int PW, int scorer,
                                 float* scores, float* rmax,
                                 cudaStream_t stream) {
  if (PW < 1) return static_cast<int>(cudaErrorInvalidValue);
#define TRIN_PHRASE_CASE(k)                                                 \
  case k:                                                                   \
    return launch_phrase<k>(masks, cache, members, weights, deleted, W, B, M, \
                            C, PW, scorer, scores, rmax, stream);
  switch (K) {
    TRIN_PHRASE_CASE(1) TRIN_PHRASE_CASE(2) TRIN_PHRASE_CASE(3)
    TRIN_PHRASE_CASE(4) TRIN_PHRASE_CASE(5) TRIN_PHRASE_CASE(6)
    TRIN_PHRASE_CASE(7) TRIN_PHRASE_CASE(8) TRIN_PHRASE_CASE(9)
    TRIN_PHRASE_CASE(10) TRIN_PHRASE_CASE(11) TRIN_PHRASE_CASE(12)
    TRIN_PHRASE_CASE(13) TRIN_PHRASE_CASE(14) TRIN_PHRASE_CASE(15)
    TRIN_PHRASE_CASE(16)
  }
#undef TRIN_PHRASE_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // K outside 1..16
}
