// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` in
// kata_xpu_device_plugin_tpu/ops/decode_attn.py (launched by
// `pallas_paged_decode_attention`), in its unsharded form, single-query
// (SQ = 1) and multi-query (SQ > 1 with per-lane query lengths), over a
// bf16 pool or an int8 pool with fp32 per-vector scales that is
// dequantized as the tensor-core fragments are built. Each lane's queries
// attend its block-table view of the shared pool in place: no gather to a
// dense view. The block reads its lane's table from device memory itself
// (there is no scalar prefetch). The split-K passes, their masking and
// their numerics are in decode_split.cuh.
//
// What bounds it: decode attention reads every live KV byte once and does
// ~2 flops per byte per query head, far below the ~295 flop/byte ridge, so
// it is bound by device-memory bytes: the int8 (or bf16) K and V rows up
// to each lane's position plus their scales. The split pass spreads a
// lane's chunks of 128 keys over the SMs, so the longest lane no longer
// sets the launch's length, and streams each chunk through cp.async stages.
//
// Known weaknesses: the query row is a grid dimension, so a span of SQ rows
// reads its lane's KV SQ times (from L2 after the first); the partials make
// a round trip through device memory (fp32, D + 2 floats per head and
// chunk); the combine is a second launch; at G < 8 most of the m16 tile is
// padding; the copies are cp.async issued by every thread, not TMA, and
// the block waits for each stage instead of specialising a producer warp;
// a tile of more than PIECE keys is one chunk, so it does not spread.

#include "decode_split.cuh"

namespace {

using decode_split::Params;

template <int D, int G, bool QUANT>
__global__ void __launch_bounds__(decode_split::NTHREADS)
    paged_decode_split_kernel(const Params p) {
  decode_split::split_pass<D, G, QUANT, false>(p);
}

template <int D>
__global__ void __launch_bounds__(D) paged_decode_combine_kernel(const Params p) {
  decode_split::combine_pass<D, false>(p);
}

template <int D, int G>
int launch(const Params& p, int quantized, cudaStream_t s) {
  return quantized
             ? decode_split::launch_passes<D, G, true>(
                   paged_decode_split_kernel<D, G, true>,
                   paged_decode_combine_kernel<D>, p, s)
             : decode_split::launch_passes<D, G, false>(
                   paged_decode_split_kernel<D, G, false>,
                   paged_decode_combine_kernel<D>, p, s);
}

// Every group G = H / KV from 1 to 8 (the G heads are the M rows of one
// m16 tile, so nothing in the passes asks for a power of two).
template <int D>
int launch_g(const Params& p, int G, int quantized, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(p, quantized, s);
    case 2: return launch<D, 2>(p, quantized, s);
    case 3: return launch<D, 3>(p, quantized, s);
    case 4: return launch<D, 4>(p, quantized, s);
    case 5: return launch<D, 5>(p, quantized, s);
    case 6: return launch<D, 6>(p, quantized, s);
    case 7: return launch<D, 7>(p, quantized, s);
    case 8: return launch<D, 8>(p, quantized, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). q and o are contiguous
// [B, SQ, H, D] bf16; the pools contiguous [NT, KV, D] (bf16, or int8 with
// contiguous fp32 scales [NT, KV]), 16-byte aligned; tables [B, NB], pos
// [B] (the last query row's position) and q_lens [B] (or null: all SQ rows
// real) int32. `part` is fp32 scratch of B*SQ*H*n_chunks*(D + 2) floats:
// the partial accumulators, then the chunk maxima, then the denominators.
// T and n_chunks are the wrapper's `decode_chunks(bs, grid_k)`.
extern "C" int paged_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* pos,
                                 const void* q_lens, void* o, void* part, int B,
                                 int SQ, int H, int KV, int D, int NB, int bs,
                                 int grid_k, int T, int n_chunks, int quantized,
                                 float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.q_lens = static_cast<const int*>(q_lens);
  p.o = static_cast<__nv_bfloat16*>(o);
  const long long rows = static_cast<long long>(B) * SQ * H * n_chunks;
  p.acc = static_cast<float*>(part);
  p.m = p.acc + rows * D;
  p.l = p.m + rows;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.NB = NB;
  p.bs = bs;
  p.grid_k = grid_k;
  p.SQ = SQ;
  p.T = T;
  p.n_chunks = n_chunks;
  p.scale = scale;
  if (H % KV || n_chunks < 1 || T < 1 || T > decode_split::MAX_T)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_g<64>(p, G, quantized, s);
    case 128: return launch_g<128>(p, G, quantized, s);
    case 256: return launch_g<256>(p, G, quantized, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
