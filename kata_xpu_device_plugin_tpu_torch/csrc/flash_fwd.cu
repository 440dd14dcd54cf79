// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel `_flash_kernel` in
// kata_xpu_device_plugin_tpu/ops/flash.py (launched by `_fwd_call`): causal
// (or full) GQA attention with an online softmax, so the [Sq, Sk] score
// matrix never reaches device memory. Optional sliding window (keys in
// (q - window, q]) and the Gemma-2 logit softcap cap*tanh(s/cap), applied
// before the mask. Positions are global: q row i sits at q_off + i, key j
// at k_off + j (both 0 for self-attention; the ring block API,
// `flash_block_attention`, passes a block pair's offsets), and only their
// difference enters the mask and the loop bounds.
//
// What bounds it: at prefill and training lengths (S >= 512) the two
// products do 4 D flops per (q row, key) pair against ~4 S D bytes a head,
// far above the card's ~295 flop/byte ridge, so tensor-core throughput
// bounds it, and only wgmma reaches the card's full tensor-core rate. Next
// come the elementwise work between the products (scale, cap, mask, an
// accurate expf for every pair) and the tile copies, which cost the most
// where threads issue them between the products.
//
// Design (a block: 128 q rows of one head; two consumer warpgroups and a
// producer warpgroup, 384 threads):
// - Both products are wgmma m64nNk16 (csrc/wgmma.cuh). S = Q K^T reads both
//   operands from shared memory, K-major. p is formed in the fp32 S
//   accumulators and rounded to bf16 there; the accumulator layout of a
//   64-row warpgroup product is the A-fragment layout of the next, so p goes
//   straight from registers into O += p V, with V read MN-major through the
//   descriptor's transpose bit.
// - Each consumer warpgroup owns 64 of the block's q rows and its own Q
//   tile (16-byte cp.async copies); both read one stream of K/V tiles, so a
//   K/V tile in shared memory serves 128 q rows.
// - One thread of the producer warpgroup keeps a ring of K/V stages full by
//   TMA (cp.async.bulk.tensor over (D, KV, Sk, B) tensor maps of the strided
//   k and v, boxes of 64 columns in the 128-byte swizzle that the
//   descriptors read, csrc/smem_tiles.cuh), with a full and an empty
//   mbarrier a stage: the consumers wait for a stage's bytes and release it
//   when their products are done, so copies run ahead with no thread of
//   the consumers issuing them and no block-wide barrier in the loop. Rows
//   past Sk are zero-filled; the ring stops at the causal frontier of the
//   block's last row (a tile edge in self-attention). The producer gives its
//   registers up (setmaxnreg 24) and the consumers take them (240): O, S
//   and p fit without spills at every width.
// - Keys a stage: 128 (64 at D = 256, where O takes 128 fp32 registers a
//   thread). Stages: 2 (4 at D = 64). Shared memory: 161 KB at D = 128,
//   193 KB at D = 256, 145 KB at D = 64; one block an SM.
// - The block walks the key tiles from the window's lower edge (rounded
//   down to a tile) up to the causal frontier of its last row; a warpgroup
//   skips the tiles where none of its pairs is live (a block pair of the
//   ring wholly above the frontier or below the window visits none; one
//   wholly below the diagonal takes no mask on any tile). The cap is a
//   template parameter, chosen once a launch, and the mask is chosen once a
//   warpgroup tile: tiles inside the causal band, the window and the
//   sequence take no mask at all; only the diagonal tiles, the window's
//   lower-edge tiles and the sequence's last tile select NEG_INF for the
//   masked pairs before the max and the exponential, with no branch inside
//   the element loop.
// - Grid (H, B, q tiles), q tile gridDim.z - 1 - blockIdx.z: the longest
//   causal key ranges launch first (a shorter tail), the q heads of one KV
//   head side by side (their K/V tiles come from L2). The plain-Python model
//   of the loop bounds, the masked tiles and the grid order is ops/flash.py
//   `fwd_schedule`.
// - Epilogue: O / l, rounded to bf16, goes through the warpgroup's Q tile in
//   shared memory, so that each thread stores 16 contiguous bytes of a row.
// (Measured on the card, one H100, and dropped: all 256 consumer threads
// issuing 16-byte cp.async copies behind a block barrier a tile, 1.1-1.25x
// slower; the two warpgroups taking turns at their products through named
// barriers, no faster; issuing S of the next tile beside p V of this one in
// a warpgroup, which ptxas serialized or spilled for, 1.2-1.4x slower;
// 64-key stages at D = 128, or 3 stages, no faster. Left out, the
// elementwise work takes 43% of the time with it at D = 128 and the S
// product under 10%, so the former is the critical path; __expf would cut
// 9% but changes the numerics the checks are derived for. The variants:
// scripts/torch_flash_fwd_variants.py.)
//
// Numerics follow the TPU kernel: fp32 logits times 1/sqrt(D), finite
// NEG_INF = -1e30 for masked keys, p = expf(s - m_new) rounded to bf16
// before the P.V product, l summed from the fp32 p, fp32 accumulators, a
// zero denominator replaced by 1. A row with no live key in a block pair
// (a window's reach ends inside the pair) so stays finite: its warpgroup
// either visits no tile (out 0, l 1) or only masked ones, where m stays
// NEG_INF and every masked key weighs exp(0) = 1, as in the TPU kernel;
// either way lse = NEG_INF + log(l) = NEG_INF, so the ring's merge gives
// the row's out a weight of exactly 0.
//
// Training asks for the per-row logsumexp as well (`lse`, fp32 [B, H, Sq],
// m + log(l) with the same zero-denominator rule, as `_finalize` writes
// it); the backward kernels in flash_bwd.cu recompute p from it. The write
// is a template parameter: a null `lse` launches the instantiation without
// it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem_tiles.cuh"
#include "wgmma.cuh"

namespace {

using namespace tiles;

constexpr int WG_ROWS = 64;        // q rows of a warpgroup (a product's M)
constexpr int NWG = 2;             // consumer warpgroups a block
constexpr int BQ = NWG * WG_ROWS;  // q rows of a block
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  // Keys a ring stage: 64 at D = 256, where O takes 128 registers a thread.
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int QTILE = WG_ROWS * D * 2;  // bytes of a warpgroup's Q
  static constexpr int KTILE = BK * D * 2;       // bytes of a stage's K or V
  // Shared memory: 1 KB to align the base to the swizzle's period, the Q
  // tiles, the ring, then a full and an empty barrier a stage.
  static constexpr int SMEM =
      1024 + NWG * QTILE + STAGES * 2 * KTILE + 16 * STAGES;
};

struct Params {
  CUtensorMap tk, tv;  // k and v as (D, KV, Sk, B), boxes of 64 x BK
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  float* lse;  // [B, H, Sq] or null
  int Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;
  int causal, window;
  int q_off, k_off;  // global positions of q row 0 and key 0
  float softcap, scale;
};

// mbarriers in shared memory: a stage's `full` barrier completes when the
// producer has armed it and its tile's bytes have landed, its `empty`
// barrier when every consumer thread is done with the tile.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives and arms the barrier for `bytes` more of TMA transactions.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One box of a (D, KV, Sk, B) tensor map into shared memory at dst; its
// bytes complete a transaction of the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Whether key kpos is attended to by query qpos (local rows; the mask is
// judged on global positions, q_off + qpos against k_off + kpos).
__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) {
    const int d = p.q_off - p.k_off;
    ok = ok && kpos <= qpos + d;
    if (p.window > 0) ok = ok && kpos > qpos + d - p.window;
  }
  return ok;
}

// Keys [lo, hi) that the q rows [q0, q0 + n) below Sq attend to: from the
// first row's window edge up to the last row's causal frontier; [0, 0)
// when they attend to none.
__device__ __forceinline__ void key_range(const Params& p, int q0, int n,
                                          int* lo, int* hi) {
  *lo = 0;
  *hi = p.Sk;
  if (p.causal) {
    const int d = p.q_off - p.k_off;
    *hi = max(0, min(p.Sk, min(p.Sq, q0 + n) + d));
    if (p.window > 0) *lo = max(0, q0 + d - p.window + 1);
    if (*lo >= *hi) *lo = *hi = 0;
  }
}

// Whether every pair of a warpgroup tile (its rows from qw below Sq, NK
// keys from k0) is live: no mask to apply.
template <int NK>
__device__ __forceinline__ bool tile_live(const Params& p, int qw, int k0) {
  const int q_last = min(qw + WG_ROWS, p.Sq) - 1;
  bool ok = k0 + NK <= p.Sk;
  if (p.causal) {
    const int d = p.q_off - p.k_off;
    ok = ok && k0 + NK - 1 <= qw + d;
    if (p.window > 0) ok = ok && k0 > q_last + d - p.window;
  }
  return ok;
}

// One tile's online softmax. The raw products s (rows qpos, keys kcol + 8 j
// + {0, 1}) become logits (times the scale, through the cap when CAP, the
// masked pairs NEG_INF when MASK: a select, no branch), then p = exp(logit
// - m_new) in their place; m moves to m_new, l (this thread's columns)
// takes the tile's p, and corr gets exp(m_old - m_new) for O.
template <bool CAP, bool MASK, int R>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[R],
                                             const int (&qpos)[2], int kcol,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = s[4 * j + e] * p.scale;
      if (CAP) x = tanhf(x / p.softcap) * p.softcap;
      if (MASK) x = live(p, qpos[r], kcol + 8 * j + (e & 1)) ? x : NEG_INF;
      s[4 * j + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = expf(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = expf(s[4 * j + e] - m[e >> 1]);
      s[4 * j + e] = pe;
      sum[e >> 1] += pe;
    }
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

__device__ __forceinline__ void warpgroup_barrier(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

template <int D, bool LSE, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D>;
  constexpr int NS = C::STAGES, NK = C::BK, QTILE = C::QTILE;
  constexpr int KTILE = C::KTILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // Warpgroup w's Q at base + w QTILE; ring stage s: K at ring + 2 s KTILE,
  // V one KTILE on; full[s] at bars + 8 s, empty[s] at bars + 8 (NS + s).
  const uint32_t ring = base + NWG * QTILE;
  const uint32_t bars = ring + NS * 2 * KTILE;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int tid = threadIdx.x;
  int lo, hi;
  key_range(p, q0, BQ, &lo, &hi);
  const int t_begin = lo / NK;
  const int nt = max(0, (hi + NK - 1) / NK - t_begin);

  if (tid == CONSUMERS) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NS + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // The producer warpgroup: one thread keeps the ring full by TMA.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      const int kvh = h / (p.H / p.KV);
      for (int t = 0; t < nt; ++t) {
        const int s = t % NS;
        if (t >= NS) mbar_wait(bars + 8 * (NS + s), ((t / NS) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect(full, 2 * KTILE);
        const uint32_t st = ring + 2 * s * KTILE;
        const int kn = (t_begin + t) * NK;
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(st + cb * (NK * 128), &p.tk, 64 * cb, kvh, kn, b, full);
          tma_load(st + KTILE + cb * (NK * 128), &p.tv, 64 * cb, kvh, kn, b,
                   full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = tid >> 7, warp = (tid >> 5) & 3;
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int qw = q0 + w * WG_ROWS;  // warpgroup w's first q row
    const uint32_t Qs = base + w * QTILE;
    int wlo, whi;
    key_range(p, qw, WG_ROWS, &wlo, &whi);
    const bool active = qw < p.Sq;

    load_tile<D, WG_ROWS, 128>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, qw,
                               p.Sq, tid & 127);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    warpgroup_barrier(w);

    float o[D / 2];
    zero(o);
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's columns; the quad adds up last
    const int qpos[2] = {qw + warp * 16 + g, qw + warp * 16 + g + 8};

    for (int t = 0; t < nt; ++t) {
      const int s = t % NS;
      const int k0 = (t_begin + t) * NK;
      const uint32_t Ks = ring + 2 * s * KTILE, Vs = Ks + KTILE;
      mbar_wait(bars + 8 * s, (t / NS) & 1);  // tile t landed
      // A warpgroup with no live pair in the tile skips it (uniform in it).
      if (active && k0 < whi && k0 + NK > wlo) {
        float sc[NK / 2];
        zero(sc);
        wg::fence_regs(sc);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wg::wgmma_ss<NK>(sc, desc_k<WG_ROWS>(Qs, kk), desc_k<NK>(Ks, kk));
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(sc);

        float corr[2];
        if (tile_live<NK>(p, qw, k0))
          softmax_tile<CAP, false>(p, sc, qpos, k0 + 2 * t4, m, l, corr);
        else
          softmax_tile<CAP, true>(p, sc, qpos, k0 + 2 * t4, m, l, corr);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }

        // O += bf16(p) V.
        uint32_t f[NK / 16][4];
        to_frags(sc, f);
#pragma unroll
        for (int ks = 0; ks < NK / 16; ++ks) wg::fence_regs(f[ks]);
        wg::fence_regs(o);
        wg::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < NK / 16; ++ks)
          wg::wgmma_rs<D>(o, f[ks], desc_mn<NK>(Vs, ks));
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(o);
#pragma unroll
        for (int ks = 0; ks < NK / 16; ++ks) wg::fence_regs(f[ks]);
      }
      mbar_arrive(bars + 8 * (NS + s));  // this thread is done with tile t
    }
    if (active) {
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
      unsigned char* tile = smem_raw + (Qs - raw);
      const int row = warp * 16 + g;
      warpgroup_barrier(w);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(
            tile + chunk_offset<WG_ROWS>(row, j) + 4 * t4) =
            __floats2bfloat162_rn(o[4 * j] / l[0], o[4 * j + 1] / l[0]);
        *reinterpret_cast<__nv_bfloat162*>(
            tile + chunk_offset<WG_ROWS>(row + 8, j) + 4 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
      }
      warpgroup_barrier(w);
      constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
      for (int i = tid & 127; i < WG_ROWS * CH; i += 128) {
        const int r = i / CH, c = i % CH;
        if (qw + r < p.Sq)
          *reinterpret_cast<uint4*>(
              p.o + ((static_cast<long long>(b) * p.Sq + qw + r) * p.H + h) * D +
              c * 8) =
              *reinterpret_cast<const uint4*>(tile + chunk_offset<WG_ROWS>(r, c));
      }
    }
  }
}

template <int D, bool LSE, bool CAP>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::SMEM;
  static bool allowed = false;  // per instantiation: the limit its launch needs
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, LSE, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = true;
  }
  const dim3 grid(p.H, B, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D, LSE, CAP><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (so the
// build links no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// k or v: the base and the batch, sequence and head strides in elements.
struct Operand {
  const void* ptr;
  long long sb, ss, sh;
};

// The (D, KV, Sk, B) tensor map of k or v: boxes of 64 columns by `rows`
// rows in the 128-byte swizzle, rows past Sk zero-filled.
bool encode_kv(CUtensorMap* map, const Operand& t, int D, int KV, int Sk,
               int B, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(Sk),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(t.sh) * 2,
                                 static_cast<cuuint64_t>(t.ss) * 2,
                                 static_cast<cuuint64_t>(t.sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t.ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps, then the instantiation for the launch: with or without
// the lse, with or without the cap.
template <int D>
int launch_d(Params& p, const Operand& k, const Operand& v, int B, bool lse,
             cudaStream_t s) {
  if (!encode_kv(&p.tk, k, D, p.KV, p.Sk, B, Cfg<D>::BK) ||
      !encode_kv(&p.tv, v, D, p.KV, p.Sk, B, Cfg<D>::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.softcap > 0.f)
    return lse ? launch<D, true, true>(p, B, s) : launch<D, false, true>(p, B, s);
  return lse ? launch<D, true, false>(p, B, s) : launch<D, false, false>(p, B, s);
}

}  // namespace

// Returns a cudaError_t (0 on success). Strides are in elements; every
// pointer is 16-byte aligned and every stride a multiple of 8 (the wrapper
// checks). The output is contiguous [B, Sq, H, D]; `lse` is null or a
// contiguous fp32 [B, H, Sq]. q_off and k_off are the global positions of
// q row 0 and key 0 (0 and 0 for self-attention).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk, int H,
                              int KV,
                              int D, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, int causal, int window,
                              int q_off, int k_off,
                              float softcap, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.k_off = k_off;
  p.softcap = softcap;
  p.scale = scale;
  const Operand kt = {k, k_sb, k_ss, k_sh}, vt = {v, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_d<64>(p, kt, vt, B, lse != nullptr, s);
    case 128: return launch_d<128>(p, kt, vt, B, lse != nullptr, s);
    case 256: return launch_d<256>(p, kt, vt, B, lse != nullptr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
