// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` in
// kata_xpu_device_plugin_tpu/ops/decode_attn.py (launched by
// `pallas_paged_decode_attention`), in its single-query (SQ = 1), unsharded
// form, over a bf16 pool or an int8 pool with fp32 per-vector scales that
// is dequantized in registers. Each lane's query attends its block-table
// view of the shared pool in place: no gather to a dense view.
//
// What bounds it: decode attention reads every live KV byte once and does
// ~2 flops per byte per query head, far below the ~295 flop/byte ridge, so
// it is bound by device-memory bytes: the int8 (or bf16) K and V rows up
// to each lane's position plus their scales.
//
// Design: one block per (KV head, lane); the block handles all G = H/KV
// query heads of its KV head, so each KV row is read once for G heads.
// The TPU's sequential split axis is a loop inside the block over the
// lane's table, which the block reads from device memory itself (there is
// no scalar prefetch). Split ki runs only while ki*bs <= pos[b], so traffic
// scales with the lane's length; the table index is clamped to
// min(ki, pos[b]/bs, NB-1) as on the TPU. Per split: warps compute the
// G logits of a key each (lanes over D, warp-shuffle sums), then one warp
// per head updates the running max and denominator, then thread d folds
// bf16(p) * v[:, d] into its G fp32 accumulators.
//
// Known weakness: with B = 8 lanes and KV = 1 this launches 8 blocks on a
// 132-SM card, and each block walks its splits in order, so it cannot
// reach the memory rate. The fix is the split-K form with a separate
// combine pass (ROADMAP Queue 2), a later PR.
//
// Numerics follow the TPU kernel: int8 -> fp32, times the fp32 scale, cast
// to bf16, then products summed in fp32; logits times 1/sqrt(D); keys past
// pos[b] masked with the finite NEG_INF = -1e30; p cast to bf16 before the
// P·V product; a zero denominator replaced by 1; output in bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const __nv_bfloat16* q;  // [B, 1, H, D]
  const void* k;           // [NT, KV, D] bf16 or int8
  const void* v;
  const float* ks;         // [NT, KV] fp32 scales (int8 pools only)
  const float* vs;
  const int* tables;       // [B, NB]
  const int* pos;          // [B]
  __nv_bfloat16* o;        // [B, 1, H, D]
  int H, KV, NB, bs, grid_k;
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

template <int D, int G, bool QUANT>
__global__ void __launch_bounds__(D) paged_decode_kernel(const Params p) {
  constexpr int NW = D / 32;
  constexpr int PER = D / 32;
  extern __shared__ float sl[];  // [G, bs] logits, then probabilities
  __shared__ float qs[G * D];
  __shared__ float m_s[G], l_s[G], c_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bs = p.bs;
  const int last = p.pos[b];

  const __nv_bfloat16* qb =
      p.q + (static_cast<long long>(b) * p.H + kvh * G) * D;
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
    const int blk = min(ki, min(last / bs, p.NB - 1));
    const long long row0 =
        static_cast<long long>(p.tables[static_cast<long long>(b) * p.NB + blk]) * bs;
    const int live = min(bs, last - ki * bs + 1);  // keys <= pos in this split

    // Logits: one key per warp at a time, lanes over D.
    for (int r = warp; r < bs; r += NW) {
      if (r >= live) {
        if (lane < G) sl[lane * bs + r] = NEG_INF;
        continue;
      }
      const long long row_kv = (row0 + r) * p.KV + kvh;
      float kv[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j)
        kv[j] = load_kv<QUANT>(p.k, p.ks, row_kv, row_kv * D + lane + 32 * j);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < PER; ++j) sum += qs[g * D + lane + 32 * j] * kv[j];
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

    // acc[g] = acc[g] * corr[g] + sum_r bf16(p[g, r]) * v[r, d]. Keys past
    // pos have p = 0 exactly, so they are skipped.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= c_s[g];
    for (int r = 0; r < live; ++r) {
      const long long row_kv = (row0 + r) * p.KV + kvh;
      const float vv = load_kv<QUANT>(p.v, p.vs, row_kv, row_kv * D + tid);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += round_bf16(sl[g * bs + r]) * vv;
    }
    __syncthreads();  // sl and c_s are rewritten by the next split
  }

  __nv_bfloat16* ob = p.o + (static_cast<long long>(b) * p.H + kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float denom = l_s[g] == 0.f ? 1.f : l_s[g];
    ob[g * D + tid] = __float2bfloat16_rn(acc[g] / denom);
  }
}

template <int D, int G>
int launch(const Params& p, int B, int quantized, cudaStream_t stream) {
  const dim3 grid(p.KV, B);
  const size_t smem = static_cast<size_t>(G) * p.bs * sizeof(float);
  if (quantized) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          paged_decode_kernel<D, G, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    paged_decode_kernel<D, G, true><<<grid, D, smem, stream>>>(p);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          paged_decode_kernel<D, G, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    paged_decode_kernel<D, G, false><<<grid, D, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_g(const Params& p, int B, int G, int quantized, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(p, B, quantized, s);
    case 2: return launch<D, 2>(p, B, quantized, s);
    case 4: return launch<D, 4>(p, B, quantized, s);
    case 8: return launch<D, 8>(p, B, quantized, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). q and o are contiguous
// [B, 1, H, D] bf16; the pools contiguous [NT, KV, D] (bf16, or int8 with
// contiguous fp32 scales [NT, KV]); tables [B, NB] and pos [B] int32.
extern "C" int paged_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* pos, void* o,
                                 int B, int H, int KV, int D, int NB, int bs,
                                 int grid_k, int quantized, float scale,
                                 void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.KV = KV;
  p.NB = NB;
  p.bs = bs;
  p.grid_k = grid_k;
  p.scale = scale;
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_g<64>(p, B, G, quantized, s);
    case 128: return launch_g<128>(p, B, G, quantized, s);
    case 256: return launch_g<256>(p, B, G, quantized, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
