// Split-K decode attention for Hopper (sm_90a), shared by the two decode
// kernels: csrc/paged_decode.cu (per-lane block tables over a shared pool,
// bf16 or int8) and csrc/dense_decode.cu (a dense [B, S, KV, D] cache with
// one shared position). Dense addressing is paged addressing with the
// identity table `row = b*S + t*bs` and one position for every lane, so both
// kernels are instantiations of the two passes below; each source wraps them
// in __global__ functions of its own name.
//
// The TPU kernels walk a lane's KV tiles one after another (the split grid
// axis is sequential there). Here the tiles are cut into CHUNKS of T
// consecutive tiles, T = max(1, ceil(128 / bs)) (ops/decode_attn.py
// `decode_chunks`, passed in by the wrapper), and the chunks run in parallel:
//
// 1. Split pass, grid (n_chunks, B*KV, SQ), 128 threads. A block takes one
//    chunk of one lane for all G = H/KV query heads (any G from 1 to 8) of
//    one KV head and one query row. Query row j of SQ sits at absolute position pos - (SQ-1) + j
//    (right-aligned; pos is the LAST row's position) and rows j < SQ - q_len
//    are padding. A block whose chunk starts past its row's last key exits
//    at once. It visits the chunk's tiles up to the one holding that key
//    (never past grid_k), with the table index clamped to min(t, pos/bs,
//    NB-1), which bounds a dead lane's stale position inside its table. Its
//    K and V rows stream through a ring of NS stages of SUB keys with
//    16-byte cp.async copies (zero-filled past the visited keys), issued
//    ahead of the arithmetic. QK^T and P.V are mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate) with the G heads as the M rows, padded to 16. int8
//    rows are dequantized as each fragment is built: int8 -> fp32, times the
//    fp32 scale, rounded to bf16. Logits are fp32 times 1/sqrt(D); keys past
//    the row's position take the finite NEG_INF = -1e30; m_c is the
//    chunk-local max and p = exp(s - m_c), rounded to bf16 once (at a scale
//    <= 1) before the P.V product; l_c sums the unrounded p in fp32. The
//    block writes the unnormalised partials (acc_c [G, D], m_c, l_c), fp32,
//    to the wrapper's scratch. A padding row attends no key: every logit is
//    NEG_INF, so m_c = NEG_INF and p = 1 on every visited key.
//    A block holds the logits of at most PIECE keys. A chunk longer than
//    that (a tile of more than PIECE keys) is walked in pieces with the
//    online rescale of the TPU kernels inside the block: p at the running
//    max, the accumulator and l times exp(m_old - m_new) in fp32, so shared
//    memory stays bounded for every tile. With one piece the rescale
//    multiplies zeros, and the partials are those above.
// 2. Combine pass, grid (H, SQ, B), D threads. Over the row's live chunks
//    c <= last / (T*bs), M = max m_c, w_c = exp(m_c - M) in fp32, and each
//    thread forms sum_c acc_c[d] w_c / sum_c l_c w_c in ascending c, a zero
//    denominator replaced by 1, then rounds to bf16. A padding row gets the
//    mean of V over its visited keys: finite, within max|V|, read by no
//    caller. No atomics: the output is the same bits on every launch.
//
// The partition and the pieces depend on bs and the row's position alone,
// so a span row and a single-query launch at the row's position, the dense
// kernel and the slotted re-view (both tile 128), and a paged and a slotted
// server at one tile, cut the same keys into the same chunks and give the
// same bits.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace decode_split {

constexpr float NEG_INF = -1e30f;
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int SUB = 32;     // keys per pipeline stage
constexpr int PIECE = 512;  // keys whose logits a block holds at once
constexpr int MAX_T = 16;   // tiles in a chunk: ceil(128 / bs) for bs >= 8

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
  float* acc;              // [B, SQ, H, n_chunks, D] partials
  float* m;                // [B, SQ, H, n_chunks]
  float* l;                // [B, SQ, H, n_chunks]
  int B, H, KV, NB, bs, grid_k, SQ;
  int T, n_chunks;         // tiles per chunk, chunks per lane
  int lk;                  // keys of logits held: min(T*bs, PIECE), rounded
                           // up to a multiple of SUB (set by launch_passes)
  float scale;
};

// One stage of the ring: SUB rows of K or V (rows padded by 16 bytes, so
// the fragment loads below are free of bank conflicts), then, for int8, the
// rows' SUB fp32 scales. The ring holds NS stages (NS - 1 copies in
// flight); int8 stages are half as large, so more of them fit.
template <int D, bool QUANT>
struct Stage {
  static constexpr int LD = QUANT ? D + 16 : (D + 8) * 2;  // row bytes
  static constexpr int BYTES = SUB * LD + (QUANT ? SUB * 4 : 0);
  static constexpr int NS = QUANT ? 6 : 4;
};

// Dynamic shared memory of the split pass: the ring, then the logits (and,
// in place, the probabilities) [G, lk + 4] fp32.
template <int D, int G, bool QUANT>
inline size_t split_smem(int lk) {
  using S = Stage<D, QUANT>;
  return static_cast<size_t>(S::NS) * S::BYTES +
         static_cast<size_t>(G) * (lk + 4) * 4;
}

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

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte `i` of `w` as an exact fp32, where `w` holds int8 values XOR 0x80
// (x + 128 as an unsigned byte): under the exponent of 2^23 the byte reads
// 2^23 + x + 128. A byte permute and an add in place of a conversion.
__device__ __forceinline__ float s8_f32(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + i)) -
         8388736.f;
}

// 16 (or 4) bytes global -> shared, asynchronously; `src_bytes` 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A query row's position and the last key it attends (a padding row: the
// lane's position, with every key masked).
struct Row {
  int pos, last;
  bool pad;
};

template <bool DENSE>
__device__ __forceinline__ Row row_of(const Params& p, int b, int j) {
  Row r;
  r.pos = DENSE ? p.pos[0] : p.pos[b];
  const int q_len = (DENSE || p.q_lens == nullptr) ? p.SQ : p.q_lens[b];
  r.pad = j < p.SQ - q_len;
  r.last = r.pad ? r.pos : r.pos - (p.SQ - 1) + j;
  return r;
}

// Where a block's chunk lies in the pool.
struct Chunk {
  const int* tbl;  // shared: the table entries of the chunk's tiles (paged)
  long long row0;  // the chunk's first cache row (dense)
  int vis, kvh;
};

// Pool row times KV plus the head of the chunk's key `r`, or -1 past the
// visited keys.
template <bool DENSE>
__device__ __forceinline__ int key_row(const Params& p, const Chunk& ch,
                                       int r) {
  if (r >= ch.vis) return -1;
  long long prow;
  if (DENSE) {
    prow = ch.row0 + r;
  } else {
    const int t = r / p.bs;
    prow = static_cast<long long>(ch.tbl[t]) * p.bs + (r - t * p.bs);
  }
  return static_cast<int>(prow * p.KV + ch.kvh);
}

// Issue the copies of a K (or V) stage into `st`; `rows(r)` is key_row of
// the stage's key r.
template <int D, bool QUANT, class Rows>
__device__ __forceinline__ void load_stage(unsigned char* st, const Params& p,
                                           Rows rows, bool k_side) {
  using S = Stage<D, QUANT>;
  constexpr int ELEM = QUANT ? 1 : 2;
  constexpr int CPR = D * ELEM / 16;  // 16-byte copies per row
  const unsigned char* base =
      static_cast<const unsigned char*>(k_side ? p.k : p.v);
  for (int i = threadIdx.x; i < SUB * CPR; i += NTHREADS) {
    const int r = i / CPR, cc = i % CPR;
    const int rk = rows(r);
    const unsigned char* src =
        rk < 0 ? base : base + static_cast<long long>(rk) * D * ELEM + cc * 16;
    cp_async16(st + r * S::LD + cc * 16, src, rk < 0 ? 0 : 16);
  }
  if (QUANT && threadIdx.x < SUB) {
    const float* sc = k_side ? p.ks : p.vs;
    const int rk = rows(threadIdx.x);
    float* dst = reinterpret_cast<float*>(st + SUB * S::LD);
    cp_async4(dst + threadIdx.x, rk < 0 ? sc : sc + rk, rk < 0 ? 0 : 4);
  }
}

// bf16 pair (row r; columns d, d+1) of a staged K tile, dequantized.
template <int D, bool QUANT>
__device__ __forceinline__ uint32_t k_pair(const unsigned char* st, int r,
                                           int d) {
  using S = Stage<D, QUANT>;
  if (QUANT) {
    const uint32_t x =
        *reinterpret_cast<const unsigned short*>(st + r * S::LD + d) ^ 0x8080u;
    const float s = reinterpret_cast<const float*>(st + SUB * S::LD)[r];
    return pack_f32(s8_f32(x, 0) * s, s8_f32(x, 1) * s);
  }
  return ld32(st + r * S::LD + d * 2);
}

// bf16 pair (rows r, r+1; column d) of a staged V tile, dequantized.
template <int D, bool QUANT>
__device__ __forceinline__ uint32_t v_pair(const unsigned char* st, int r,
                                           int d) {
  using S = Stage<D, QUANT>;
  if (QUANT) {
    const int8_t* x = reinterpret_cast<const int8_t*>(st + r * S::LD + d);
    const float* s = reinterpret_cast<const float*>(st + SUB * S::LD) + r;
    return pack_f32(static_cast<float>(x[0]) * s[0],
                    static_cast<float>(x[S::LD]) * s[1]);
  }
  const __nv_bfloat16* x =
      reinterpret_cast<const __nv_bfloat16*>(st + r * S::LD) + d;
  __nv_bfloat162 v;
  v.x = x[0];
  v.y = x[S::LD / 2];
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int G, bool QUANT, bool DENSE>
__device__ __forceinline__ void split_pass(const Params& p) {
  static_assert(G >= 1 && G <= 8, "the G heads are the M rows of one m16 tile");
  using S = Stage<D, QUANT>;
  constexpr int NS = S::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[G], l_s[G], c_s[G];  // running max, sum, rescale
  __shared__ int tbl_s[MAX_T];               // the chunk's table entries
  __shared__ int rows_s[NS][SUB];            // each stage's key_row values
  float* sl = reinterpret_cast<float*>(smem + NS * S::BYTES);
  const int ldl = p.lk + 4;

  const int c = blockIdx.x;
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV, j = blockIdx.z;
  const Row row = row_of<DENSE>(p, b, j);
  const int ck = p.T * p.bs;
  if (row.last < c * ck) return;  // the chunk starts past the row's last key
  const int tile0 = c * p.T;
  Chunk ch;
  ch.vis = min(min(p.T, p.grid_k - tile0), (row.last - c * ck) / p.bs + 1)
           * p.bs;
  ch.kvh = kvh;
  ch.tbl = tbl_s;
  ch.row0 = (static_cast<long long>(b) * p.NB + tile0) * p.bs;
  const int n_sub = (ch.vis + SUB - 1) / SUB;
  const int PS = p.lk / SUB;  // stages of a piece
  const int n_pieces = (n_sub + PS - 1) / PS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // Stage s of the block: piece i's K stages, then its V stages.
  auto stage_of = [&](int s, bool& kst) {
    const int i = min(s / (2 * PS), n_pieces - 1);
    const int w = s - 2 * PS * i;
    const int np = min(PS, n_sub - i * PS);
    kst = w < np;
    return i * PS + (kst ? w : w - np);
  };
  // Paged: the chunk's table entries come in once, and each stage's rows
  // are planned a stage ahead of its copies (one division a key, by the
  // first warp), so no copy waits on a table read. Dense rows are a sum.
  auto plan = [&](int s) {
    if (!DENSE && tid < SUB) {
      bool kst;
      rows_s[s % NS][tid] =
          s < 2 * n_sub ? key_row<DENSE>(p, ch, stage_of(s, kst) * SUB + tid)
                        : -1;
    }
  };
  auto issue = [&](int s) {
    if (s < 2 * n_sub) {
      bool kst;
      const int sub = stage_of(s, kst);
      unsigned char* st = smem + (s % NS) * S::BYTES;
      if constexpr (DENSE)
        load_stage<D, QUANT>(st, p, [&](int r) {
          return key_row<DENSE>(p, ch, sub * SUB + r);
        }, kst);
      else
        load_stage<D, QUANT>(st, p, [&](int r) { return rows_s[s % NS][r]; },
                             kst);
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };
  if constexpr (!DENSE) {
    if (tid < ch.vis / p.bs) {
      const int blk_max = min(row.pos / p.bs, p.NB - 1);
      tbl_s[tid] = p.tables[static_cast<long long>(b) * p.NB +
                            min(tile0 + tid, blk_max)];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NS; ++s) plan(s);
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // Q as the A operand: head g's row; rows 8-15 (a1, a3) are padding.
  const long long head0 = (static_cast<long long>(b) * p.SQ + j) * p.H + kvh * G;
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = qa[kk][1] = 0u;
    if (g < G) {
      const __nv_bfloat16* qr = p.q + (head0 + g) * D + kk * 16 + t4 * 2;
      qa[kk][0] = ld32(qr);
      qa[kk][1] = ld32(qr + 8);
    }
  }

  // acc[g, d] = sum_r bf16(p[g, r]) v[r, d]; each warp owns D/4 columns.
  constexpr int NTO = D / 32;
  const int d0 = warp * (D / 4);
  float o[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const long long stat0 = head0 * p.n_chunks + c;

  for (int i = 0; i < n_pieces; ++i) {
    const int sub0 = i * PS, np = min(PS, n_sub - sub0), s0 = 2 * sub0;

    // Logits: each warp takes 8 of a stage's 32 keys.
    for (int u = 0; u < np; ++u) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      issue(s0 + u + NS - 1);
      plan(s0 + u + NS);  // into the slot of stage s0 + u, issued long ago
      const unsigned char* st = smem + ((s0 + u) % NS) * S::BYTES;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      const int kr = warp * 8 + g;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(sc, qa[kk][0], 0u, qa[kk][1], 0u,
                 k_pair<D, QUANT>(st, kr, kk * 16 + t4 * 2),
                 k_pair<D, QUANT>(st, kr, kk * 16 + 8 + t4 * 2));
      }
      if (g < G) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = u * SUB + warp * 8 + t4 * 2 + e;  // in the piece
          const bool live = !row.pad && c * ck + sub0 * SUB + r <= row.last;
          sl[g * ldl + r] = live ? sc[e] * p.scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // Softmax statistics, one warp per head; p = 0 past the visited keys.
    const int n_vis = min(np * SUB, ch.vis - sub0 * SUB);
    for (int h = warp; h < G; h += NWARPS) {
      float* srow = sl + h * ldl;
      float mc = NEG_INF;
      for (int r = lane; r < n_vis; r += 32) mc = fmaxf(mc, srow[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mc);
      float ls = 0.f;
      for (int r = lane; r < np * SUB; r += 32) {
        const float pe = r < n_vis ? expf(srow[r] - m_new) : 0.f;
        srow[r] = pe;
        ls += pe;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        const float l_new = l_s[h] * corr + ls;
        c_s[h] = corr;
        m_s[h] = m_new;
        l_s[h] = l_new;
        if (i == n_pieces - 1) {
          p.m[stat0 + h * p.n_chunks] = m_new;
          p.l[stat0 + h * p.n_chunks] = l_new;
        }
      }
    }

    // P.V over the piece's V stages.
    for (int u = 0; u < np; ++u) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // also publishes p and the rescale
      issue(s0 + np + u + NS - 1);
      plan(s0 + np + u + NS);
      if (u == 0 && g < G) {
        const float corr = c_s[g];
#pragma unroll
        for (int n = 0; n < NTO; ++n) {
          o[n][0] *= corr;
          o[n][1] *= corr;
        }
      }
      const unsigned char* st = smem + ((s0 + np + u) % NS) * S::BYTES;
#pragma unroll
      for (int kstep = 0; kstep < SUB / 16; ++kstep) {
        uint32_t a0 = 0u, a2 = 0u;
        if (g < G) {
          const float* pr = sl + g * ldl + u * SUB + kstep * 16 + t4 * 2;
          a0 = pack_f32(pr[0], pr[1]);
          a2 = pack_f32(pr[8], pr[9]);
        }
        const int vr = kstep * 16 + t4 * 2;
#pragma unroll
        for (int n = 0; n < NTO; ++n) {
          const int d = d0 + n * 8 + g;
          mma_bf16(o[n], a0, 0u, a2, 0u, v_pair<D, QUANT>(st, vr, d),
                   v_pair<D, QUANT>(st, vr + 8, d));
        }
      }
    }
  }

  if (g < G) {
    float* ob = p.acc + (stat0 + g * p.n_chunks) * D + d0 + t4 * 2;
#pragma unroll
    for (int n = 0; n < NTO; ++n)
      *reinterpret_cast<float2*>(ob + n * 8) = make_float2(o[n][0], o[n][1]);
  }
}

// Launched with D threads and grid (H, SQ, B). Its shared memory is static:
// the weights of a window of D chunks at a time, so its launch needs no
// attribute set for any n_chunks.
template <int D, bool DENSE>
__device__ __forceinline__ void combine_pass(const Params& p) {
  __shared__ float cw[2][D];  // a window's weights, then l_c * weight
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const Row row = row_of<DENSE>(p, b, j);
  const int ck = p.T * p.bs;
  const int n_live = row.last < 0 ? 0 : min(row.last / ck, p.n_chunks - 1) + 1;
  const long long head = (static_cast<long long>(b) * p.SQ + j) * p.H + h;
  const float* m = p.m + head * p.n_chunks;
  const float* l = p.l + head * p.n_chunks;
  const float* acc = p.acc + head * p.n_chunks * D + threadIdx.x;
  const int tid = threadIdx.x;
  float mx = NEG_INF;  // every warp forms M itself
  for (int c = tid % 32; c < n_live; c += 32) mx = fmaxf(mx, m[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float num = 0.f, den = 0.f;
  for (int c0 = 0; c0 < n_live; c0 += D) {
    const int n = min(D, n_live - c0);
    if (tid < n) {
      const float w = expf(m[c0 + tid] - mx);
      cw[0][tid] = w;
      cw[1][tid] = l[c0 + tid] * w;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < n; ++c) {  // in order: unrolling keeps the bits
      num += acc[(c0 + c) * D] * cw[0][c];
      den += cw[1][c];
    }
    __syncthreads();
  }
  p.o[head * D + tid] = __float2bfloat16_rn(num / (den == 0.f ? 1.f : den));
}

// Both passes on `stream`; the first non-zero cudaError, or 0. The split
// kernel's dynamic shared memory limit is raised once, to its largest size
// (logits of PIECE keys), so no launch can find it lowered under its size
// by another. `static`: both decode libraries instantiate it, and the
// static local of an inline function is one object across the process.
template <int D, int G, bool QUANT>
static int launch_passes(void (*split)(Params), void (*combine)(Params),
                         Params p, cudaStream_t stream) {
  static bool allowed = false;  // per instantiation, as is `split`
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(split_smem<D, G, QUANT>(PIECE)));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = true;
  }
  p.lk = min((p.T * p.bs + SUB - 1) / SUB * SUB, PIECE);
  split<<<dim3(p.n_chunks, p.B * p.KV, p.SQ), NTHREADS,
          split_smem<D, G, QUANT>(p.lk), stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine<<<dim3(p.H, p.SQ, p.B), D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_split
