// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` in
// kata_xpu_device_plugin_tpu/ops/decode_attn.py (launched by
// `pallas_paged_decode_attention`), in its unsharded form, single-query
// (SQ = 1) and multi-query (SQ > 1 with per-lane query lengths), over a
// bf16 pool or an int8 pool with fp32 per-vector scales that is
// dequantized in registers. Each lane's queries attend its block-table
// view of the shared pool in place: no gather to a dense view. The block
// reads its lane's table from device memory itself (there is no scalar
// prefetch). The split loop, its masking and its numerics are in
// decode_split.cuh.
//
// What bounds it: decode attention reads every live KV byte once and does
// ~2 flops per byte per query head, far below the ~295 flop/byte ridge, so
// it is bound by device-memory bytes: the int8 (or bf16) K and V rows up
// to each lane's position plus their scales.
//
// Known weaknesses: with B = 8 lanes and KV = 1 a single-query call
// launches 8 blocks on a 132-SM card, and each block walks its splits in
// order, so it cannot reach the memory rate; the fix is the split-K form
// with a separate combine pass (ROADMAP Queue 2). The multi-query form is
// one more grid dimension over the query row, so it reads a lane's KV once
// per row instead of once per lane.

#include "decode_split.cuh"

namespace {

using decode_split::Params;

template <int D, int G, bool QUANT>
__global__ void __launch_bounds__(D) paged_decode_kernel(const Params p) {
  decode_split::decode_splits<D, G, QUANT, false>(p);
}

template <int D, int G, bool QUANT>
int launch_q(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.KV, B, p.SQ);
  const size_t smem = static_cast<size_t>(G) * p.bs * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<D, G, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_decode_kernel<D, G, QUANT><<<grid, D, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G>
int launch(const Params& p, int B, int quantized, cudaStream_t stream) {
  return quantized ? launch_q<D, G, true>(p, B, stream)
                   : launch_q<D, G, false>(p, B, stream);
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
// [B, SQ, H, D] bf16; the pools contiguous [NT, KV, D] (bf16, or int8 with
// contiguous fp32 scales [NT, KV]); tables [B, NB], pos [B] (the last
// query row's position) and q_lens [B] (or null: all SQ rows real) int32.
extern "C" int paged_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* pos,
                                 const void* q_lens, void* o, int B, int SQ,
                                 int H, int KV, int D, int NB, int bs,
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
  p.q_lens = static_cast<const int*>(q_lens);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.KV = KV;
  p.NB = NB;
  p.bs = bs;
  p.grid_k = grid_k;
  p.SQ = SQ;
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
