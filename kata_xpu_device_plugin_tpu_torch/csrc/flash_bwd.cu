// Flash attention backward for Hopper (sm_90a): dq, and dk/dv per KV head.
// bf16 q, k, v, out-gradient; fp32 logsumexp and delta; bf16 gradients.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` in
// kata_xpu_device_plugin_tpu/ops/flash.py (launched by `_bwd_call`), and the
// `_group_kv_grads` sum that follows them. FlashAttention-2 recompute: the
// [Sq, Sk] probabilities are rebuilt tile by tile from the forward's
// logsumexp, p = exp(s - lse), so they never reach device memory;
// delta = rowsum(dO * O) comes in precomputed (it is an XLA-side reduction
// in the JAX package too).
//
//   ds = p * (dp - delta) * scale * (1 - t^2)     dp = dO V^T, t = tanh(s/cap)
//   dq = ds K        dk = ds^T Q        dv = p^T dO
//
// What bounds it: the products. Per (q row, key) pair the backward does
// five D-long products (S and dP twice, once in each kernel, then dq, dk,
// dv) against the forward's two; at training lengths (S = 2048, D = 128)
// that is far above the card's ~295 flop/byte ridge, so tensor-core
// throughput bounds it. This first version uses warp-level mma.sync
// (m16n8k16, bf16 -> fp32), as flash_fwd.cu does; wgmma, TMA and pipelined
// tile loads are the later step.
//
// Design:
// - dq: one block per (64-row q tile, q head, batch row); four warps of 16
//   rows. A loop over 32-key tiles from the window's lower edge up to the
//   causal frontier takes the place of the TPU's sequential key axis and
//   its `live` skip. dq accumulates in fp32 registers and is written once.
// - dk/dv: one block per (64-row key tile, KV head, batch row); four warps
//   of 16 key rows. The block loops over the G q heads of its KV head and,
//   for each, over the 32-row q tiles at or below the frontier and inside
//   the window band. The TPU kernel writes fp32 partials per q head
//   ([B, H, Sk, D]) that XLA then sums over the group; here the group sum
//   stays in the fp32 accumulators, so each K/V tile is read once for G
//   heads and the fp32 intermediate is never written. One cast at the end,
//   as in JAX.
// - Both compute the transposed products in registers in the mma C layout,
//   which is the A layout of the next product, so p and ds never leave
//   registers. They are rounded to bf16 right there, as the TPU kernels
//   round them to the input dtype before their products.
// - Registers are the tight resource of dk/dv at D = 128: the two fp32
//   [64, D] accumulators take 128 registers a thread on four warps, so the
//   inner q tile is 32 rows (16 more registers each for s and dp).
// - Positions enter only through `live()` and the loop bounds, so the ring
//   API's global offsets are one more pair of arguments there.
//
// Numerics follow the TPU kernels: fp32 logits times 1/sqrt(D), the
// softcap recomputed from the raw logits, masked p set to 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int DQ_BQ = 64;  // dq: q rows per block
constexpr int DQ_BK = 32;  // dq: keys per inner tile
constexpr int KV_BK = 64;  // dk/dv: key rows per block
constexpr int KV_BQ = 32;  // dk/dv: q rows per inner tile

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
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  __nv_bfloat16* dq;   // [B, Sq, H, D] contiguous
  __nv_bfloat16* dk;   // [B, Sk, KV, D] contiguous
  __nv_bfloat16* dv;   // [B, Sk, KV, D] contiguous
  int Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long dout_sb, dout_ss, dout_sh;
  int causal, window;
  float softcap, scale;
};

// Whether key kpos is attended to by query qpos.
__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = qpos < p.Sq && kpos < p.Sk;
  if (p.causal) {
    ok = ok && kpos <= qpos;
    if (p.window > 0) ok = ok && kpos > qpos - p.window;
  }
  return ok;
}

// Rows row0 .. row0+nrows-1 of a strided [S, D] slice into a padded smem
// tile, 16 bytes a thread; rows at or past `limit` read as zeros.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int nrows, int limit, int tid) {
  constexpr int CH = D / 8;
  constexpr int LDS = D + 8;
  for (int i = tid; i < nrows * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(base + (row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

// c[16, 8 NT] += A[16, D] B[8 NT, D]^T for one warp: A's rows start at
// `a`, B's at `b`, both padded row-major smem tiles.
template <int D, int NT>
__device__ __forceinline__ void mma_rows_rows_t(float c[NT][4],
                                                const __nv_bfloat16* a,
                                                const __nv_bfloat16* b,
                                                int g, int t4) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* ap = a + g * LDS + kk * 16 + t4 * 2;
    const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * LDS);
    const uint32_t a2 = ld32(ap + 8), a3 = ld32(ap + 8 * LDS + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* bp = b + (n * 8 + g) * LDS + kk * 16 + t4 * 2;
      mma_bf16(c[n], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
    }
  }
}

// c[16, D] += bf16(x)[16, 8 NT] B[8 NT, D] for one warp: x is held in the
// mma C layout (which is the A layout of a k16 step over two n8 tiles), B
// is a padded row-major smem tile.
template <int D, int NT>
__device__ __forceinline__ void mma_regs_rows(float c[D / 8][4],
                                              float x[NT][4],
                                              const __nv_bfloat16* b,
                                              int g, int t4) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    const uint32_t a0 = pack_f32(x[2 * ks][0], x[2 * ks][1]);
    const uint32_t a1 = pack_f32(x[2 * ks][2], x[2 * ks][3]);
    const uint32_t a2 = pack_f32(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    const uint32_t a3 = pack_f32(x[2 * ks + 1][2], x[2 * ks + 1][3]);
    const __nv_bfloat16* br = b + (ks * 16 + t4 * 2) * LDS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* bc = br + n * 8;
      mma_bf16(c[n], a0, a1, a2, a3, pack_bf16(bc[0], bc[LDS]),
               pack_bf16(bc[8 * LDS], bc[9 * LDS]));
    }
  }
}

// The softcapped, scaled logit of a raw q.k product, and d(logit)/d(raw
// scaled logit) = 1 - tanh^2 (1 without a cap).
__device__ __forceinline__ float logit(const Params& p, float raw,
                                       float* dcap) {
  float x = raw * p.scale;
  *dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = t * p.softcap;
    *dcap = 1.f - t * t;
  }
  return x;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LDS = D + 8;
  constexpr int NT_S = DQ_BK / 8;
  constexpr int NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + DQ_BQ * LDS;  // dO
  __nv_bfloat16* Ks = Gs + DQ_BQ * LDS;
  __nv_bfloat16* Vs = Ks + DQ_BK * LDS;

  const int q0 = blockIdx.x * DQ_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
  load_rows<D>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, DQ_BQ, p.Sq, tid);
  load_rows<D>(Gs, p.dout + b * p.dout_sb + h * p.dout_sh, p.dout_ss, q0,
               DQ_BQ, p.Sq, tid);

  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < p.Sq;
    lse[r] = in ? p.lse[rows + qpos[r]] : 0.f;
    delta[r] = in ? p.delta[rows + qpos[r]] : 0.f;
  }

  int k_begin = 0, k_end = p.Sk;
  if (p.causal) {
    k_end = min(p.Sk, q0 + DQ_BQ);
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;
      if (lo > 0) k_begin = (lo / DQ_BK) * DQ_BK;
    }
  }

  float dq[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += DQ_BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(Ks, kbase, p.k_ss, k0, DQ_BK, p.Sk, tid);
    load_rows<D>(Vs, vbase, p.v_ss, k0, DQ_BK, p.Sk, tid);
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    mma_rows_rows_t<D, NT_S>(s, Qs + warp * 16 * LDS, Ks, g, t4);
    mma_rows_rows_t<D, NT_S>(dp, Gs + warp * 16 * LDS, Vs, g, t4);

    // ds, in place of s.
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
        float dcap;
        const float x = logit(p, s[n][e], &dcap);
        const float pe = live(p, qpos[r], kpos) ? expf(x - lse[r]) : 0.f;
        s[n][e] = pe * (dp[n][e] - delta[r]) * p.scale * dcap;
      }
    }
    mma_regs_rows<D, NT_S>(dq, s, Ks, g, t4);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.Sq) continue;
    __nv_bfloat16* row =
        p.dq + ((static_cast<long long>(b) * p.Sq + qpos[r]) * p.H + h) * D +
        t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LDS = D + 8;
  constexpr int NT_S = KV_BQ / 8;
  constexpr int NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + KV_BK * LDS;
  __nv_bfloat16* Qs = Vs + KV_BK * LDS;
  __nv_bfloat16* Gs = Qs + KV_BQ * LDS;  // dO
  float* lse_s = reinterpret_cast<float*>(Gs + KV_BQ * LDS);
  float* delta_s = lse_s + KV_BQ;

  const int k0 = blockIdx.x * KV_BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  load_rows<D>(Ks, p.k + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0, KV_BK, p.Sk, tid);
  load_rows<D>(Vs, p.v + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0, KV_BK, p.Sk, tid);
  const int kpos[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  // q rows that can see a key of this tile: at or past the causal
  // frontier, and before the window's upper reach.
  int q_begin = 0, q_end = p.Sq;
  if (p.causal) {
    q_begin = (k0 / KV_BQ) * KV_BQ;
    if (p.window > 0) q_end = min(p.Sq, k0 + KV_BK - 1 + p.window);
  }

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* gbase = p.dout + b * p.dout_sb + h * p.dout_sh;
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += KV_BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<D>(Qs, qbase, p.q_ss, q0, KV_BQ, p.Sq, tid);
      load_rows<D>(Gs, gbase, p.dout_ss, q0, KV_BQ, p.Sq, tid);
      for (int i = tid; i < KV_BQ; i += NTHREADS) {
        const bool in = q0 + i < p.Sq;
        lse_s[i] = in ? p.lse[rows + q0 + i] : 0.f;
        delta_s[i] = in ? p.delta[rows + q0 + i] : 0.f;
      }
      __syncthreads();

      // Transposed tiles: rows are this warp's keys, columns the q rows.
      float s[NT_S][4], dp[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      mma_rows_rows_t<D, NT_S>(s, Ks + warp * 16 * LDS, Qs, g, t4);
      mma_rows_rows_t<D, NT_S>(dp, Vs + warp * 16 * LDS, Gs, g, t4);

      // p^T in place of s, ds^T in place of dp.
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + t4 * 2 + (e & 1);
          float dcap;
          const float x = logit(p, s[n][e], &dcap);
          const float pe =
              live(p, q0 + qi, kpos[e >> 1]) ? expf(x - lse_s[qi]) : 0.f;
          s[n][e] = pe;
          dp[n][e] = pe * (dp[n][e] - delta_s[qi]) * p.scale * dcap;
        }
      }
      mma_regs_rows<D, NT_S>(dv, s, Gs, g, t4);
      mma_regs_rows<D, NT_S>(dk, dp, Qs, g, t4);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= p.Sk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Sk + kpos[r]) * p.KV + kvh) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + n * 8) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + n * 8) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_dq(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = (2 * DQ_BQ + 2 * DQ_BK) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + DQ_BQ - 1) / DQ_BQ, p.H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = (2 * KV_BK + 2 * KV_BQ) * (D + 8) * 2 + 2 * KV_BQ * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sk + KV_BK - 1) / KV_BK, p.KV, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int Sq, int Sk, int H, int KV, const long long* strides,
                   int causal, int window, float softcap, float scale) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.dout_sb = strides[9]; p.dout_ss = strides[10]; p.dout_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  return p;
}

}  // namespace

// Both return a cudaError_t (0 on success). `strides` holds the batch,
// sequence and head strides, in elements, of q, k, v and dout (12 values);
// every pointer is 16-byte aligned and every stride a multiple of 8 (the
// wrapper checks). lse and delta are contiguous fp32 [B, H, Sq]; dq is a
// contiguous [B, Sq, H, D], dk and dv contiguous [B, Sk, KV, D].
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int Sq,
                                 int Sk, int H, int KV, int D,
                                 const long long* strides, int causal,
                                 int window, float softcap, float scale,
                                 void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, Sq, Sk, H, KV, strides,
                         causal, window, softcap, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dq<64>(p, B, s);
    case 128: return launch_dq<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int Sq, int Sk, int H, int KV, int D,
                                  const long long* strides, int causal,
                                  int window, float softcap, float scale,
                                  void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, Sq, Sk, H, KV, strides,
                         causal, window, softcap, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dkv<64>(p, B, s);
    case 128: return launch_dkv<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
