// Flash attention backward for Hopper (sm_90a): dq, and dk/dv per KV head.
// bf16 q, k, v, out-gradient; fp32 logsumexp and delta; bf16 gradients.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` in
// kata_xpu_device_plugin_tpu/ops/flash.py (launched by `_bwd_call`), and the
// `_group_kv_grads` sum that follows them. FlashAttention-2 recompute: the
// [Sq, Sk] probabilities are rebuilt tile by tile from the forward's
// logsumexp, p = exp(s - lse), so they never reach device memory;
// delta = rowsum(dO * O) comes in precomputed (an XLA-side reduction in
// the JAX package) or is formed by the dq kernel.
//
//   ds = p * (dp - delta) * scale * (1 - t^2)     dp = dO V^T, t = tanh(s/cap)
//   dq = ds K        dk = ds^T Q        dv = p^T dO
//
// The ring block API (`flash_block_attention`) differentiates through the
// block's logsumexp too: its cotangent dlse joins the bracket as
// ds = p * (dp - (delta - dlse)) * ..., so the dq kernel, when it forms
// delta, subtracts dlse from it once and hands delta - dlse to dk/dv.
//
// What bounds it: the products. Per (q row, key) pair the two kernels do
// seven D-long products (S and dP once in each, then dq, dk, dv) against
// the forward's two; at training lengths (S = 2048, D = 128) that is far
// above the card's ~295 flop/byte ridge, so tensor-core throughput bounds
// it, and only wgmma reaches the card's full tensor-core rate. Next comes
// the elementwise work between the products (an accurate expf, the mask,
// ds for every pair): on the card it cost more than the products until it
// was made branch-free with the cap and the mask chosen once a tile.
//
// Design (one warpgroup of 128 threads a block):
// - Every product is a wgmma m64nNk16 (csrc/wgmma.cuh). The first two of a
//   tile (S = Q K^T and dP = dO V^T in dq; S^T = K Q^T and dP^T = V dO^T
//   in dk/dv) read both operands from shared memory, K-major. p and ds are
//   formed in the fp32 accumulators, rounded to bf16 there (as the TPU
//   kernels round them to the input dtype before their products), and the
//   accumulator layout of a 64-row warpgroup product is the A-fragment
//   layout of the next, so p^T and ds^T (ds) go straight from registers
//   into dV += p^T dO and dK += ds^T Q (dQ += ds K), with the shared tile
//   read MN-major through the descriptor's transpose bit.
// - Tiles sit in shared memory in the layout wgmma's 128-byte swizzle
//   reads (and TMA's would write): column blocks of 64 bf16 in 128-byte
//   rows, 16-byte chunk c of row r stored at chunk c ^ (r % 8), so neither
//   the copies nor the products meet bank conflicts. They are filled by
//   16-byte cp.async copies (zero-filled past the sequence) into a ring of
//   stages: the copy of the next tile is in flight while this tile's
//   products and exponentials run, behind one barrier a tile. The copies,
//   the layout and the descriptors are csrc/smem_tiles.cuh, shared with
//   the forward.
// - dq: one block per (q head, batch row, 64-row q tile); a ring of K/V
//   tiles (64 keys; 32 at D = 256, where dQ takes 128 registers a thread)
//   from the window's lower edge up to the causal frontier. The grid puts
//   the q tiles with the longest key range first (a shorter tail) and the
//   q heads of one KV head side by side (their K/V tiles come from L2).
//   Given the forward's output, the block also forms delta = rowsum(dO O)
//   of its rows (each once in the grid) and writes it for dk/dv, so the
//   separate reduction goes away.
// - dk/dv: one block per (KV head, batch row, 64-key tile), heaviest tile
//   first; a ring of (Q, dO, lse, delta) tiles of 32 q rows (64 at D = 64:
//   at D = 128 the 64-row form needs 20 bytes of spills) over the G q heads
//   of the group and, for each, the q tiles at or below the frontier and
//   inside the window band. The group sum stays in the fp32 accumulators:
//   each K/V tile is read once for G heads, the TPU's fp32 [B, H, Sk, D]
//   partials never exist, and one cast at the end, as in JAX. Where that
//   grid is small (MQA at a small batch: 128 blocks at the Gemma-2B train
//   shape, whose heaviest key tile set the time), the wrapper splits the
//   G heads into the fewest groups that give 512 blocks (ops/flash.py
//   `dkv_splits`); each block then writes its group's fp32 partial and a
//   combine pass adds the groups up in order and casts once.
// - At D = 256 dK and dV would take 256 registers a thread, past the 255 a
//   thread can have, so a key tile gets two blocks side by side in the
//   grid: one sums dV (S^T, p^T dO), the other dK (S^T, dP^T, ds^T Q). S^T
//   and p are formed by both: five products a pair in place of four, 25%
//   more operations for dk/dv at D = 256 (and twice its exponentials).
// - Determinism: each output element is summed by the one block that owns
//   it, in a fixed order, with no atomics, so a relaunch gives the same
//   bits; hence two passes (dq over q tiles, dk/dv over key tiles) as on
//   the TPU, and no dq accumulated by atomics.
// - Positions enter only through `live()`, `tile_live()` and the loop
//   bounds, judged on global positions (q row i at q_off + i, key j at
//   k_off + j; 0 and 0 for self-attention), so a ring block pair wholly
//   below the diagonal takes no mask on any tile, and one the window does
//   not reach visits no tile. The plain-Python model of these loop bounds
//   and of the grid order is ops/flash.py `bwd_schedule`.
//
// Per instantiation, registers (nvcc 12.8 -Xptxas -v, sm_90a; no spills)
// and dynamic shared memory (Cfg below), and so blocks an SM:
//   dq<64>  194 regs, 66560 B, 2      dk/dv<64>  202 regs,  68096 B, 2
//   dq<128> 244 regs, 99328 B, 2      dk/dv<128> 232 regs,  84480 B, 2
//   dq<256> 254 regs, 132096 B, 1     dk/dv<256> 250 regs, 133120 B, 1
//   the combine pass 32 regs, no shared memory.
// (Tried on the card and dropped: two warpgroups handing p^T over in
// shared memory, slower; 64-row dk/dv stages at D = 128, 12% faster but
// spilling 8 bytes even with the fragments formed a k-step at a time;
// dq's S and dP in 32-key halves so that one half's exponentials overlap
// the other's products, 9% slower at D = 128.)
//
// Numerics follow the TPU kernels: fp32 logits times 1/sqrt(D), the
// softcap recomputed from the raw logits, masked p set to 0 (so a row
// with no live key in a block pair, whose lse is NEG_INF, adds nothing).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem_tiles.cuh"
#include "wgmma.cuh"

namespace {

using namespace tiles;

constexpr int BQ = 64;  // q rows of a tile (a warpgroup product's M)
constexpr int BK = 64;  // keys of a dk/dv block

// What a dk/dv block sums: at D = 256 a key tile gets one block for each.
enum Grads { kDV = 1, kDK = 2, kDKV = 3 };

template <int D>
struct Cfg {
  static constexpr int THREADS = 128;  // one warpgroup
  static constexpr int STAGES = D == 64 ? 3 : 2;
  // dq: keys a ring stage (32 at D = 256, where the dQ accumulators take
  // 128 registers a thread and 64-key S and dP would spill).
  static constexpr int DQ_BK = D == 256 ? 32 : 64;
  // dk/dv: q rows a ring stage (32 unless D = 64, so that dK, dV, S^T and
  // dP^T fit the registers); three stages but at D = 256.
  static constexpr int KV_BQ = D == 64 ? 64 : 32;
  static constexpr int KV_STAGES = D == 256 ? 2 : 3;
  static constexpr int TILE = 64 * D * 2;  // bytes of a [64, D] bf16 tile
  static constexpr int KTILE = DQ_BK * D * 2;
  static constexpr int QTILE = KV_BQ * D * 2;
  // Shared memory, with 1 KB to align the base to the swizzle's period.
  static constexpr int DQ_SMEM = 1024 + 2 * TILE + STAGES * 2 * KTILE;
  // dk/dv: K, V, then stages of (Q, dO) with their lse and delta at the
  // end (512 B a stage).
  static constexpr int KV_VEC = 2 * TILE + KV_STAGES * 2 * QTILE;
  static constexpr int DKV_SMEM = 1024 + KV_VEC + KV_STAGES * 512;
};

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
  // With `out`, the dq kernel forms delta = rowsum(dO * O) of its rows
  // itself and writes it to delta_out (the buffer `delta` then points to).
  // With `out` and `dlse` ([B, H, Sq], the cotangent of the forward's
  // logsumexp), delta_out gets delta - dlse instead.
  const __nv_bfloat16* out;
  const float* dlse;
  float* delta_out;
  long long out_sb, out_ss, out_sh;
  // dk/dv: the G q heads of a KV head in `nsplit` groups of blocks; with
  // more than one, each block writes fp32 partials [2 (dk, dv), nsplit, B,
  // Sk, KV, D] to `part` and a combine pass sums them in order.
  int B, nsplit;
  float* part;
  int causal, window;
  int q_off, k_off;  // global positions of q row 0 and key 0
  float softcap, scale;
};

// Whether key kpos is attended to by query qpos (local rows; the mask is
// judged on global positions, q_off + qpos against k_off + kpos).
__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = qpos < p.Sq && kpos < p.Sk;
  if (p.causal) {
    const int d = p.q_off - p.k_off;
    ok = ok && kpos <= qpos + d;
    if (p.window > 0) ok = ok && kpos > qpos + d - p.window;
  }
  return ok;
}

// Whether every pair of the tile (NQ rows from q0, NK keys from k0) is
// live: no mask to apply.
template <int NQ, int NK>
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int k0) {
  bool ok = q0 + NQ <= p.Sq && k0 + NK <= p.Sk;
  if (p.causal) {
    const int d = p.q_off - p.k_off;
    ok = ok && k0 + NK - 1 <= q0 + d;
    if (p.window > 0) ok = ok && k0 > q0 + NQ - 1 + d - p.window;
  }
  return ok;
}

// Keys [k_begin, k_end) that q tile q0 visits, from the window's lower
// edge (rounded down to a key tile of NK) up to the causal frontier;
// empty when the tile's rows attend to no key.
template <int NK>
__device__ __forceinline__ void dq_keys(const Params& p, int q0, int* k_begin,
                                        int* k_end) {
  *k_begin = 0;
  *k_end = p.Sk;
  if (p.causal) {
    const int d = p.q_off - p.k_off;
    *k_end = max(0, min(p.Sk, q0 + BQ + d));
    if (p.window > 0) {
      const int lo = q0 + d - p.window + 1;
      if (lo >= *k_end) *k_end = 0;
      else if (lo > 0) *k_begin = (lo / NK) * NK;
    }
  }
}

// Query rows [q_begin, q_end) that can see a key of tile k0: at or past the
// causal frontier (rounded down to a q tile of NQ), before the window's
// upper reach; empty when no row sees one.
template <int NQ>
__device__ __forceinline__ void dkv_queries(const Params& p, int k0,
                                            int* q_begin, int* q_end) {
  *q_begin = 0;
  *q_end = p.Sq;
  if (p.causal) {
    const int d = p.q_off - p.k_off;
    if (p.window > 0) *q_end = max(0, min(p.Sq, k0 + BK - 1 + p.window - d));
    const int first = max(0, k0 - d);  // the first row that sees key k0
    *q_begin = first < *q_end ? (first / NQ) * NQ : *q_end;
  }
}

// N fp32 values row0 .. row0+N-1 of a row of lse or delta, 16 bytes by each
// thread whose `i` is below N / 4; zeros past limit.
template <int N>
__device__ __forceinline__ void load_vec(uint32_t dst, const float* row,
                                         int row0, int limit, int i) {
  if (static_cast<unsigned>(i) < N / 4u) {
    const int r = row0 + i * 4;
    const int bytes = max(0, min(16, (limit - r) * 4));
    cp_async16(dst + i * 16, row + (bytes ? r : 0), bytes);
  }
}

// p = exp(logit - lse) of a raw q.k product, and d(logit)/d(raw scaled
// logit) in *dcap: the logit is the raw product times 1/sqrt(D), through
// the cap when CAP (1 - tanh^2 then, else 1); a masked pair gets
// exp(-inf) = 0, with no branch.
template <bool CAP>
__device__ __forceinline__ float prob(const Params& p, float raw, float lse,
                                      bool ok, float* dcap) {
  float x = raw * p.scale;
  *dcap = 1.f;
  if (CAP) {
    const float t = tanhf(x / p.softcap);
    x = t * p.softcap;
    *dcap = 1.f - t * t;
  }
  return expf(ok ? x - lse : __int_as_float(0xff800000));
}

// dq's tile: ds = p (dp - delta) scale (1 - t^2) in place of s. Rows are
// the thread's q rows (qpos, with their lse and delta), columns keys
// kcol + 8 j + {0, 1}. MASK applies live(); a tile of live pairs skips it.
template <bool CAP, bool MASK, int R>
__device__ __forceinline__ void dq_tile_ds(const Params& p, float (&s)[R],
                                           const float (&dp)[R],
                                           const int (&qpos)[2], int kcol,
                                           const float (&lse)[2],
                                           const float (&delta)[2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool ok = !MASK || live(p, qpos[r], kcol + 8 * j + (e & 1));
      float dcap;
      const float pe = prob<CAP>(p, s[4 * j + e], lse[r], ok, &dcap);
      s[4 * j + e] = pe * (dp[4 * j + e] - delta[r]) * p.scale * dcap;
    }
  }
}

// dk/dv's transposed tile, straight to the A fragments of dV += p^T dO
// (fp, with DV) and dK += ds^T Q (fs, with DK), rounded to bf16 one k-step
// (16 q columns) at a time, so that the fp32 tiles die as they go. Rows
// are the thread's keys (kpos), columns q rows q0 + qi, qi = 8 j + 2 t4 +
// {0, 1}, whose lse and delta are in shared memory.
template <bool CAP, bool MASK, bool DV, bool DK, int R, int RD, int KS>
__device__ __forceinline__ void dkv_tile_frags(
    const Params& p, const float (&s)[R], const float (&dp)[RD],
    const int (&kpos)[2], int q0, int t4, const float* lse_s,
    const float* delta_s, uint32_t (&fp)[KS][4], uint32_t (&fs)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float pv[8], dsv[8];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * ks + jj;
      const int qi = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qi);
      float2 d2 = make_float2(0.f, 0.f);
      if (DK) d2 = *reinterpret_cast<const float2*>(delta_s + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        const bool ok = !MASK || live(p, q0 + qi + c, kpos[e >> 1]);
        float dcap;
        const float pe = prob<CAP>(p, s[4 * j + e], c ? l2.y : l2.x, ok, &dcap);
        pv[4 * jj + e] = pe;
        if constexpr (DK)
          dsv[4 * jj + e] =
              pe * (dp[4 * j + e] - (c ? d2.y : d2.x)) * p.scale * dcap;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (DV) fp[ks][r] = pack_f32(pv[2 * r], pv[2 * r + 1]);
      if constexpr (DK) fs[ks][r] = pack_f32(dsv[2 * r], dsv[2 * r + 1]);
    }
  }
}

// Rows g and g + 8 of a warp's 16 accumulator rows, written as bf16 to
// contiguous rows of D values (null: past the end, not written).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* row0,
                                           __nv_bfloat16* row8,
                                           const float (&acc)[D / 2], int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0)
      *reinterpret_cast<__nv_bfloat162*>(row0 + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (row8)
      *reinterpret_cast<__nv_bfloat162*>(row8 + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// grid (H, B, q tiles), q tile gridDim.z - 1 - blockIdx.z: the longest key
// range first, the q heads of a KV head side by side.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, D == 256 ? 1 : 2)
flash_bwd_dq_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int NS = C::STAGES, TILE = C::TILE, KTILE = C::KTILE;
  constexpr int NK = C::DQ_BK, NT = C::THREADS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t Qs = base, Gs = base + TILE;  // Gs: dO
  // Ring stage s: K at base + 2 TILE + 2 s KTILE, V one KTILE on.

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
  int k_begin, k_end;
  dq_keys<NK>(p, q0, &k_begin, &k_end);
  const int nt = (k_end - k_begin + NK - 1) / NK;
  auto load_kv = [&](int t, int s) {
    const uint32_t st = base + 2 * TILE + 2 * s * KTILE;
    const int kn = k_begin + t * NK;
    load_tile<D, NK, NT>(st, kbase, p.k_ss, kn, p.Sk, tid);
    load_tile<D, NK, NT>(st + KTILE, vbase, p.v_ss, kn, p.Sk, tid);
  };

  // Q and dO join the first stage's group.
  load_tile<D, BQ, NT>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, tid);
  load_tile<D, BQ, NT>(Gs, p.dout + b * p.dout_sb + h * p.dout_sh, p.dout_ss,
                       q0, p.Sq, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nt) load_kv(s, s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }

  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < p.Sq;
    lse[r] = in ? p.lse[rows + qpos[r]] : 0.f;
    if (p.out) {
      // delta of row qpos[r]: the quad's four threads each sum every
      // fourth 8-value chunk of dO * O in fp32, then the quad adds up.
      float acc = 0.f;
      if (in) {
        const __nv_bfloat16* o =
            p.out + b * p.out_sb + qpos[r] * p.out_ss + h * p.out_sh;
        const __nv_bfloat16* d =
            p.dout + b * p.dout_sb + qpos[r] * p.dout_ss + h * p.dout_sh;
#pragma unroll
        for (int c = t4; c < D / 8; c += 4) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + 8 * c);
          const uint4 dv = *reinterpret_cast<const uint4*>(d + 8 * c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            acc = fmaf(df.x, of.x, acc);
            acc = fmaf(df.y, of.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p.dlse && in) acc -= p.dlse[rows + qpos[r]];
      delta[r] = acc;
      if (in && t4 == 0) p.delta_out[rows + qpos[r]] = acc;
    } else {
      delta[r] = in ? p.delta[rows + qpos[r]] : 0.f;
    }
  }

  float dq[D / 2];
  zero(dq);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<NS - 2>();
    fence_proxy_async();
    __syncthreads();  // tile t landed; every reader of tile t - 1 is done
    if (t + NS - 1 < nt) load_kv(t + NS - 1, (t + NS - 1) % NS);
    cp_async_commit();

    const int k0 = k_begin + t * NK;
    const uint32_t Ks = base + 2 * TILE + 2 * (t % NS) * KTILE;
    const uint32_t Vs = Ks + KTILE;
    float s[NK / 2], dp[NK / 2];
    zero(s);
    zero(dp);
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_ss<NK>(s, desc_k<BQ>(Qs, kk), desc_k<NK>(Ks, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_ss<NK>(dp, desc_k<BQ>(Gs, kk), desc_k<NK>(Vs, kk));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // ds, in place of s; the cap and the mask chosen once a tile.
    const int kcol = k0 + 2 * t4;
    const bool all_live = tile_live<BQ, NK>(p, q0, k0);
    if (p.softcap > 0.f) {
      if (all_live) dq_tile_ds<true, false>(p, s, dp, qpos, kcol, lse, delta);
      else dq_tile_ds<true, true>(p, s, dp, qpos, kcol, lse, delta);
    } else {
      if (all_live) dq_tile_ds<false, false>(p, s, dp, qpos, kcol, lse, delta);
      else dq_tile_ds<false, true>(p, s, dp, qpos, kcol, lse, delta);
    }
    uint32_t f[NK / 16][4];
    to_frags(s, f);
#pragma unroll
    for (int ks = 0; ks < NK / 16; ++ks) wg::fence_regs(f[ks]);
    wg::fence_regs(dq);
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NK / 16; ++ks)
      wg::wgmma_rs<D>(dq, f[ks], desc_mn<NK>(Ks, ks));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dq);
#pragma unroll
    for (int ks = 0; ks < NK / 16; ++ks) wg::fence_regs(f[ks]);
  }

  __nv_bfloat16* out[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    out[r] = qpos[r] < p.Sq
                 ? p.dq + ((static_cast<long long>(b) * p.Sq + qpos[r]) * p.H + h) * D
                 : nullptr;
  store_rows<D>(out[0], out[1], dq, t4);
}

// fp32 rows g and g + 8 of a warp's accumulators (null: not written).
template <int D>
__device__ __forceinline__ void store_rows_f32(float* row0, float* row8,
                                               const float (&acc)[D / 2],
                                               int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0)
      *reinterpret_cast<float2*>(row0 + 8 * j + 2 * t4) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row8)
      *reinterpret_cast<float2*>(row8 + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// One dk/dv block: key tile kt of KV head kvh, batch row b, head group
// `split` of p.nsplit, summing the gradients in WANT.
template <int D, int WANT>
__device__ __forceinline__ void dkv_block(const Params& p,
                                          unsigned char* smem_raw, int kt,
                                          int split, int kvh, int b) {
  using C = Cfg<D>;
  constexpr int NS = C::KV_STAGES, TILE = C::TILE, QTILE = C::QTILE;
  constexpr int NQ = C::KV_BQ, NT = C::THREADS;
  constexpr bool DV = WANT & kDV, DK = WANT & kDK;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t Ks = base, Vs = base + TILE;
  // Ring stage s: Q at base + 2 TILE + 2 s QTILE, dO one QTILE on; lse at
  // KV_VEC + 512 s, delta 256 B on.
  auto stage = [&](int s) { return base + 2 * TILE + 2 * s * QTILE; };
  auto vec = [&](int s) {
    return reinterpret_cast<const float*>(smem_raw + (base - raw) + C::KV_VEC +
                                          512 * s);
  };

  const int k0 = kt * BK;
  const int G = p.H / p.KV, Gs = G / p.nsplit;
  const int h0 = kvh * G + split * Gs;  // the block's first q head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  int q_begin, q_end;
  dkv_queries<NQ>(p, k0, &q_begin, &q_end);
  const int n_qt = max(0, (q_end - q_begin + NQ - 1) / NQ);
  const int n_items = Gs * n_qt;  // (head, q tile), head-major

  auto load_item = [&](int i, int s) {
    const int h = h0 + i / n_qt;
    const int q0 = q_begin + (i % n_qt) * NQ;
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
    const uint32_t st = stage(s);
    load_tile<D, NQ, NT>(st, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, tid);
    load_tile<D, NQ, NT>(st + QTILE, p.dout + b * p.dout_sb + h * p.dout_sh,
                         p.dout_ss, q0, p.Sq, tid);
    const uint32_t v = base + C::KV_VEC + 512 * s;
    load_vec<NQ>(v, p.lse + rows, q0, p.Sq, tid);
    if (DK) load_vec<NQ>(v + 256, p.delta + rows, q0, p.Sq, tid - 32);
  };

  // K and V join the first stage's group.
  load_tile<D, BK, NT>(Ks, p.k + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0, p.Sk, tid);
  if (DK)
    load_tile<D, BK, NT>(Vs, p.v + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0, p.Sk, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_items) load_item(s, s);
    cp_async_commit();
  }

  const int kpos[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[DK ? D / 2 : 1], dv[DV ? D / 2 : 1];
  zero(dk);
  zero(dv);

  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<NS - 2>();
    fence_proxy_async();
    __syncthreads();  // item i landed; every reader of item i - 1 is done
    if (i + NS - 1 < n_items) load_item(i + NS - 1, (i + NS - 1) % NS);
    cp_async_commit();

    const int q0 = q_begin + (i % n_qt) * NQ;
    const uint32_t Qs = stage(i % NS), Gs = Qs + QTILE;
    const float* lse_s = vec(i % NS);
    const float* delta_s = lse_s + 64;

    // Transposed tiles: rows are this warp's keys, columns the q rows.
    float s[NQ / 2], dp[DK ? NQ / 2 : 1];
    zero(s);
    zero(dp);
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_ss<NQ>(s, desc_k<BK>(Ks, kk), desc_k<NQ>(Qs, kk));
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::wgmma_ss<NQ>(dp, desc_k<BK>(Vs, kk), desc_k<NQ>(Gs, kk));
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // p^T and ds^T, as the A fragments of the next products; the cap and
    // the mask chosen once a tile.
    uint32_t fp[NQ / 16][4], fs[NQ / 16][4];
    const bool all_live = tile_live<NQ, BK>(p, q0, k0);
    if (p.softcap > 0.f) {
      if (all_live)
        dkv_tile_frags<true, false, DV, DK>(p, s, dp, kpos, q0, t4, lse_s, delta_s, fp, fs);
      else
        dkv_tile_frags<true, true, DV, DK>(p, s, dp, kpos, q0, t4, lse_s, delta_s, fp, fs);
    } else {
      if (all_live)
        dkv_tile_frags<false, false, DV, DK>(p, s, dp, kpos, q0, t4, lse_s, delta_s, fp, fs);
      else
        dkv_tile_frags<false, true, DV, DK>(p, s, dp, kpos, q0, t4, lse_s, delta_s, fp, fs);
    }

    // dV += p^T dO, dK += ds^T Q.
#pragma unroll
    for (int ks = 0; ks < NQ / 16; ++ks) {
      if constexpr (DV) wg::fence_regs(fp[ks]);
      if constexpr (DK) wg::fence_regs(fs[ks]);
    }
    wg::fence_regs(dv);
    wg::fence_regs(dk);
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NQ / 16; ++ks) {
      if constexpr (DV) wg::wgmma_rs<D>(dv, fp[ks], desc_mn<NQ>(Gs, ks));
      if constexpr (DK) wg::wgmma_rs<D>(dk, fs[ks], desc_mn<NQ>(Qs, ks));
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dv);
    wg::fence_regs(dk);
#pragma unroll
    for (int ks = 0; ks < NQ / 16; ++ks) {
      if constexpr (DV) wg::fence_regs(fp[ks]);
      if constexpr (DK) wg::fence_regs(fs[ks]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  long long off[2];
  bool in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    off[r] = ((static_cast<long long>(b) * p.Sk + kpos[r]) * p.KV + kvh) * D;
    in[r] = kpos[r] < p.Sk;
  }
  if (p.nsplit == 1) {  // the whole group sum: cast once
    if constexpr (DK)
      store_rows<D>(in[0] ? p.dk + off[0] : nullptr,
                    in[1] ? p.dk + off[1] : nullptr, dk, t4);
    if constexpr (DV)
      store_rows<D>(in[0] ? p.dv + off[0] : nullptr,
                    in[1] ? p.dv + off[1] : nullptr, dv, t4);
  } else {  // this head group's fp32 partial
    const long long n = static_cast<long long>(p.B) * p.Sk * p.KV * D;
    float* dk_part = p.part + split * n;
    float* dv_part = p.part + (p.nsplit + split) * n;
    if constexpr (DK)
      store_rows_f32<D>(in[0] ? dk_part + off[0] : nullptr,
                        in[1] ? dk_part + off[1] : nullptr, dk, t4);
    if constexpr (DV)
      store_rows_f32<D>(in[0] ? dv_part + off[0] : nullptr,
                        in[1] ? dv_part + off[1] : nullptr, dv, t4);
  }
}

// dk and dv from the head groups' fp32 partials: each element summed over
// the groups in order, then cast once. 4 elements a thread.
__global__ void __launch_bounds__(256)
flash_bwd_dkv_combine_kernel(const Params p, long long n) {
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x);
  if (i >= n) return;
#pragma unroll
  for (int grad = 0; grad < 2; ++grad) {
    const float* part = p.part + grad * p.nsplit * n + i;
    float4 acc = *reinterpret_cast<const float4*>(part);
    for (int s = 1; s < p.nsplit; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part + s * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    __nv_bfloat16* out = (grad == 0 ? p.dk : p.dv) + i;
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc.x, acc.y);
    *reinterpret_cast<__nv_bfloat162*>(out + 2) = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// grid (KV, B, key tiles x head groups x blocks a tile), the heaviest
// (lowest) key tile first, then its head groups; at D = 256 two blocks a
// (key tile, head group), the even one for dV, the odd one for dK.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, D == 256 ? 1 : 2)
flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int MODES = D == 256 ? 2 : 1;
  const int z = blockIdx.z / MODES;
  const int kt = z / p.nsplit, split = z % p.nsplit;
  if constexpr (D == 256) {
    if (blockIdx.z & 1)
      dkv_block<D, kDK>(p, smem_raw, kt, split, blockIdx.x, blockIdx.y);
    else
      dkv_block<D, kDV>(p, smem_raw, kt, split, blockIdx.x, blockIdx.y);
  } else {
    dkv_block<D, kDKV>(p, smem_raw, kt, split, blockIdx.x, blockIdx.y);
  }
}

template <int D>
int launch_dq(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::DQ_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, B, (p.Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, Cfg<D>::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::DKV_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.Sk + BK - 1) / BK;
  const dim3 grid(p.KV, B, tiles * p.nsplit * (D == 256 ? 2 : 1));
  flash_bwd_dkv_kernel<D><<<grid, Cfg<D>::THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * p.Sk * p.KV * D;
  flash_bwd_dkv_combine_kernel<<<static_cast<unsigned>((n / 4 + 255) / 256),
                                 256, 0, stream>>>(p, n);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int Sq, int Sk, int H, int KV, const long long* strides,
                   int causal, int window, int q_off, int k_off,
                   float softcap, float scale) {
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
  p.out_sb = strides[12]; p.out_ss = strides[13]; p.out_sh = strides[14];
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.k_off = k_off;
  p.softcap = softcap;
  p.scale = scale;
  return p;
}

}  // namespace

// Both return a cudaError_t (0 on success). `strides` holds the batch,
// sequence and head strides, in elements, of q, k, v, dout and out (15
// values; out's only read by dq when `out` is given); every pointer is
// 16-byte aligned and every stride a multiple of 8 (the wrapper checks).
// lse and delta are contiguous fp32 [B, H, Sq] with Sq a multiple of 4; dq
// is a contiguous [B, Sq, H, D], dk and dv contiguous [B, Sk, KV, D]. With
// `out` non-null, dq forms delta = rowsum(dout * out) itself (minus `dlse`,
// a contiguous fp32 [B, H, Sq], when that is non-null) and writes it to
// `delta`, for the dk/dv launch that follows on the same stream. q_off and
// k_off are the global positions of q row 0 and key 0. dk/dv
// splits each KV head's q heads into `nsplit` groups (a divisor of H / KV);
// with more than one, `part` is fp32 scratch of 2 nsplit B Sk KV D values.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, const void* out,
                                 const void* dlse, int B, int Sq,
                                 int Sk, int H, int KV, int D,
                                 const long long* strides, int causal,
                                 int window, int q_off, int k_off,
                                 float softcap, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, Sq, Sk, H, KV, strides,
                         causal, window, q_off, k_off, softcap, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.B = B;
  p.nsplit = 1;
  p.out = static_cast<const __nv_bfloat16*>(out);
  if (out) {
    p.delta_out = const_cast<float*>(p.delta);
    p.dlse = static_cast<const float*>(dlse);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dq<64>(p, B, s);
    case 128: return launch_dq<128>(p, B, s);
    case 256: return launch_dq<256>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  void* part, int B, int Sq, int Sk, int H,
                                  int KV, int D, int nsplit,
                                  const long long* strides, int causal,
                                  int window, int q_off, int k_off,
                                  float softcap, float scale, void* stream) {
  if (nsplit < 1 || (H / KV) % nsplit || (nsplit > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, dout, lse, delta, Sq, Sk, H, KV, strides,
                         causal, window, q_off, k_off, softcap, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B;
  p.nsplit = nsplit;
  p.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dkv<64>(p, B, s);
    case 128: return launch_dkv<128>(p, B, s);
    case 256: return launch_dkv<256>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
