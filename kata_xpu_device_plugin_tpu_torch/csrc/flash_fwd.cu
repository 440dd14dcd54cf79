// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel `_flash_kernel` in
// kata_xpu_device_plugin_tpu/ops/flash.py (launched by `_fwd_call`): causal
// (or full) GQA self-attention with an online softmax, so the [S, S] score
// matrix never reaches device memory. Optional sliding window and the
// Gemma-2 logit softcap cap*tanh(s/cap), applied before the mask.
//
// What bounds it: at prefill lengths (S >= 512, D = 256) the two products
// do ~4*S*S*D/2 flops per head against ~4*S*D bytes, far above the card's
// ~295 flop/byte ridge, so it is bound by tensor-core throughput. This
// first version uses warp-level mma.sync (m16n8k16, bf16 -> fp32), which
// reaches a fraction of the rate wgmma would; wgmma, TMA and a pipelined
// K/V ring are the later step.
//
// Design: one block per (q tile of 64 rows, q head, batch row); four warps,
// each owning 16 query rows. The TPU's sequential key-block grid axis is a
// loop inside the block over 32-key tiles, stopping at the causal frontier
// (and starting at the window's lower edge), so fully masked tiles are never
// loaded. GQA reads KV head h / (H/KV) directly; KV is never repeated. The
// S accumulator lives in registers in the mma C layout, which is exactly
// the A layout the P·V product needs, so P never leaves registers. Shared
// memory holds the Q tile and one K and V tile with rows padded by 16 bytes
// (conflict-free fragment loads): 66 KB at D = 256, within the 227 KB a
// block may use.
//
// Numerics follow the TPU kernel: fp32 logits times 1/sqrt(D), finite
// NEG_INF = -1e30 for masked keys, p cast to bf16 before the P·V product,
// fp32 accumulators, a zero denominator replaced by 1.
//
// Training asks for the per-row logsumexp as well (`lse`, fp32 [B, H, Sq],
// m + log(l) with the same zero-denominator rule, as `_finalize` writes
// it); the backward kernels in flash_bwd.cu recompute p from it. The write
// is a template parameter: a null `lse` launches the instantiation without
// it, so inference runs the kernel it ran before the lse existed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [B, H, Sq] or null
  int Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float softcap, scale;
};

template <int D, bool LSE>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const Params p) {
  constexpr int LDS = D + 8;  // padded smem row, in elements
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NT_O = D / 8; // n8 tiles of the output row
  constexpr int NT_S = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDS;
  __nv_bfloat16* Vs = Ks + BK * LDS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BQ * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.Sq)
      val = *reinterpret_cast<const uint4*>(qbase + (q0 + r) * p.q_ss + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * LDS + c * 8) = val;
  }

  int k_end = p.Sk;
  int k_begin = 0;
  if (p.causal) {
    k_end = min(p.Sk, q0 + BQ);
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;
      if (lo > 0) k_begin = (lo / BK) * BK;
    }
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * CH; i += NTHREADS) {
      const int r = i / CH, c = i % CH;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.Sk) {
        kv = *reinterpret_cast<const uint4*>(kbase + (k0 + r) * p.k_ss + c * 8);
        vv = *reinterpret_cast<const uint4*>(vbase + (k0 + r) * p.v_ss + c * 8);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDS + c * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDS + c * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 32 keys.
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * LDS + kk * 16 + t4 * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LDS);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LDS + 8);
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * LDS + kk * 16 + t4 * 2;
        mma_bf16(s[n], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    // Scale, softcap, mask; running max.
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        bool ok = kpos < p.Sk;
        if (p.causal) {
          ok = ok && kpos <= qpos[half];
          if (p.window > 0) ok = ok && kpos > qpos[half] - p.window;
        }
        x = ok ? x : NEG_INF;
        s[n][e] = x;
        mc[half] = fmaxf(mc[half], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float m_new = fmaxf(m[r], mc[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[n][e] - m[e >> 1]);
        s[n][e] = pe;
        ps[e >> 1] += pe;
      }
    }
    l[0] = l[0] * corr[0] + ps[0];
    l[1] = l[1] * corr[1] + ps[1];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += bf16(P) V: the C layout of two adjacent key tiles is the A
    // fragment of one k16 step.
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t a0 = pack_f32(s[2 * ks][0], s[2 * ks][1]);
      const uint32_t a1 = pack_f32(s[2 * ks][2], s[2 * ks][3]);
      const uint32_t a2 = pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      const uint32_t a3 = pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const __nv_bfloat16* vr = Vs + (ks * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[LDS]);
        const uint32_t b1 = pack_bf16(vc[8 * LDS], vc[9 * LDS]);
        mma_bf16(o[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
  if (LSE && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] < p.Sq)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qpos[r]] =
            m[r] + logf(l[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.Sq) continue;
    __nv_bfloat16* orow =
        p.o + ((static_cast<long long>(b) * p.Sq + qpos[r]) * p.H + h) * D +
        t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    }
  }
}

template <int D, bool LSE>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = (BQ + 2 * BK) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd_kernel<D, LSE><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t (0 on success). Strides are in elements; every
// pointer is 16-byte aligned and every stride a multiple of 8 (the wrapper
// checks). The output is contiguous [B, Sq, H, D]; `lse` is null or a
// contiguous fp32 [B, H, Sq].
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk, int H,
                              int KV,
                              int D, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, int causal, int window,
                              float softcap, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return lse ? launch<64, true>(p, B, s) : launch<64, false>(p, B, s);
    case 128: return lse ? launch<128, true>(p, B, s) : launch<128, false>(p, B, s);
    case 256: return lse ? launch<256, true>(p, B, s) : launch<256, false>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
