// The split loop shared by the two decode-attention kernels for Hopper
// (sm_90a): csrc/paged_decode.cu (per-lane block tables over a shared pool,
// bf16 or int8) and csrc/dense_decode.cu (a dense [B, S, KV, D] cache with
// one shared position). Dense addressing is paged addressing with the
// identity table `row = b*S + ki*bs` and one position for every lane, so
// both kernels are instantiations of `decode_splits` below; each source
// wraps it in a __global__ function of its own name.
//
// One block per (KV head, lane, query row); the block handles all G = H/KV
// query heads of its KV head, so each KV row is read once for G heads.
// The TPU kernels' sequential split axis is a loop inside the block. Query
// row j of SQ sits at absolute position pos - (SQ-1) + j (right-aligned;
// pos is the LAST row's position) and rows j < SQ - q_len are padding.
// Split ki runs while ki*bs <= the row's own position: later splits are
// fully masked for it and would change nothing (p = 0, correction 1), so
// stopping there gives the same bits. A padding row has every logit at the
// finite NEG_INF, so each probability is exp(0) = 1 and it emits the mean
// of V over the splits up to pos: finite, bounded by max|V|, read by no
// caller. The table index is clamped to min(ki, pos/bs, NB-1), which
// bounds a dead lane's stale position inside its table.
//
// Per split: warps compute the G logits of a key each (lanes over D,
// warp-shuffle sums), then one warp per head updates the running max and
// denominator, then thread d folds bf16(p) * v[:, d] into its G fp32
// accumulators.
//
// Numerics follow the TPU kernels: int8 -> fp32, times the fp32 scale, cast
// to bf16, then products summed in fp32; logits times 1/sqrt(D); masked
// keys take NEG_INF = -1e30; p cast to bf16 before the P·V product; a zero
// denominator replaced by 1; output in bf16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace decode_split {

constexpr float NEG_INF = -1e30f;

struct Params {
  const __nv_bfloat16* q;  // [B, SQ, H, D]
  const void* k;           // [NT, KV, D] bf16 or int8 (dense: NT = B*S)
  const void* v;
  const float* ks;         // [NT, KV] fp32 scales (int8 pools only)
  const float* vs;
  const int* tables;       // [B, NB] (paged only)
  const int* pos;          // [B] (paged) or [1] (dense)
  const int* q_lens;       // [B] or null: every row real (paged only)
  __nv_bfloat16* o;        // [B, SQ, H, D]
  int H, KV, NB, bs, grid_k, SQ;
  float scale;
};

template <bool QUANT>
__device__ __forceinline__ float load_kv(const void* pool, const float* sc,
                                         long long row_kv, long long idx) {
  if (QUANT) {
    const float x = static_cast<float>(static_cast<const int8_t*>(pool)[idx]);
    return __bfloat162float(__float2bfloat16_rn(x * sc[row_kv]));
  }
  return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[idx]);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Launched with D threads, grid (KV, B, SQ) and G*bs floats of dynamic
// shared memory.
template <int D, int G, bool QUANT, bool DENSE>
__device__ __forceinline__ void decode_splits(const Params& p) {
  constexpr int NW = D / 32;
  constexpr int PER = D / 32;
  extern __shared__ float sl[];  // [G, bs] logits, then probabilities
  __shared__ float qs[G * D];
  __shared__ float m_s[G], l_s[G], c_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y, j = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bs = p.bs;
  const int pos = DENSE ? p.pos[0] : p.pos[b];
  const int q_len = (DENSE || p.q_lens == nullptr) ? p.SQ : p.q_lens[b];
  const bool pad = j < p.SQ - q_len;
  const int last = pad ? pos : pos - (p.SQ - 1) + j;

  const long long q_off =
      ((static_cast<long long>(b) * p.SQ + j) * p.H + kvh * G) * D;
  const __nv_bfloat16* qb = p.q + q_off;
#pragma unroll
  for (int g = 0; g < G; ++g) qs[g * D + tid] = __bfloat162float(qb[g * D + tid]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int ki = 0; ki < p.grid_k; ++ki) {
    if (ki * bs > last) break;
    long long row0;
    if (DENSE) {
      row0 = (static_cast<long long>(b) * p.NB + ki) * bs;
    } else {
      const int blk = min(ki, min(pos / bs, p.NB - 1));
      row0 = static_cast<long long>(
                 p.tables[static_cast<long long>(b) * p.NB + blk]) * bs;
    }
    // Keys this row attends in this split, and rows of V it folds in: a
    // padding row attends none and averages all bs.
    const int live = pad ? 0 : min(bs, last - ki * bs + 1);
    const int n_v = pad ? bs : live;

    // Logits: one key per warp at a time, lanes over D.
    for (int r = warp; r < bs; r += NW) {
      if (r >= live) {
        if (lane < G) sl[lane * bs + r] = NEG_INF;
        continue;
      }
      const long long row_kv = (row0 + r) * p.KV + kvh;
      float kv[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i)
        kv[i] = load_kv<QUANT>(p.k, p.ks, row_kv, row_kv * D + lane + 32 * i);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) sum += qs[g * D + lane + 32 * i] * kv[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) sl[g * bs + r] = sum * p.scale;
      }
    }
    __syncthreads();

    // Online softmax statistics, one warp per head.
    for (int g = warp; g < G; g += NW) {
      float mc = NEG_INF;
      for (int r = lane; r < bs; r += 32) mc = fmaxf(mc, sl[g * bs + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m_s[g], mc);
      float ps = 0.f;
      for (int r = lane; r < bs; r += 32) {
        const float pe = expf(sl[g * bs + r] - m_new);
        sl[g * bs + r] = pe;
        ps += pe;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        const float corr = expf(m_s[g] - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g] = acc[g] * corr[g] + sum_r bf16(p[g, r]) * v[r, d]. Masked
    // keys of a real row have p = 0 exactly, so they are skipped.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= c_s[g];
    for (int r = 0; r < n_v; ++r) {
      const long long row_kv = (row0 + r) * p.KV + kvh;
      const float vv = load_kv<QUANT>(p.v, p.vs, row_kv, row_kv * D + tid);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += round_bf16(sl[g * bs + r]) * vv;
    }
    __syncthreads();  // sl and c_s are rewritten by the next split
  }

  __nv_bfloat16* ob = p.o + q_off;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float denom = l_s[g] == 0.f ? 1.f : l_s[g];
    ob[g * D + tid] = __float2bfloat16_rn(acc[g] / denom);
  }
}

}  // namespace decode_split
