// Lock-step dense decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` in
// kata_xpu_device_plugin_tpu/ops/decode_attn.py (launched by
// `pallas_decode_attention`): single-token GQA attention into a dense bf16
// KV cache [B, S, KV, D] read in place, with ONE position shared by the
// whole batch (the decode loop of `generate` advances every row in
// lock-step). The position is a device scalar the kernel reads itself, so
// the host never waits for it. Blocks of 128 keys past the position are
// skipped, so traffic scales with the position, not with S.
//
// It shares the split loop of the paged kernel (decode_split.cuh): dense
// addressing is paged addressing with the identity table and one position.
// What bounds it: bytes, as for the paged kernel: K and V of every live
// position read once. Known weakness, as there: one block per (KV head,
// batch row) walks its splits in order, so B = 8, KV = 1 occupies 8 of 132
// SMs; the split-K form with a combine pass is the fix (ROADMAP Queue 2).

#include "decode_split.cuh"

namespace {

using decode_split::Params;

constexpr int BLOCK_K = 128;

template <int D, int G>
__global__ void __launch_bounds__(D) dense_decode_kernel(const Params p) {
  decode_split::decode_splits<D, G, false, true>(p);
}

template <int D, int G>
int launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.KV, B, 1);
  const size_t smem = static_cast<size_t>(G) * BLOCK_K * sizeof(float);
  dense_decode_kernel<D, G><<<grid, D, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_g(const Params& p, int B, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(p, B, s);
    case 2: return launch<D, 2>(p, B, s);
    case 4: return launch<D, 4>(p, B, s);
    case 8: return launch<D, 8>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). q and o are contiguous [B, 1, H, D]
// bf16; k and v the contiguous [B, S, KV, D] bf16 cache, S a multiple of
// 128; pos one int32 on the device.
extern "C" int dense_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* pos, void* o, int B, int S, int H,
                                 int KV, int D, float scale, void* stream) {
  if (S % BLOCK_K) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = nullptr;
  p.vs = nullptr;
  p.tables = nullptr;
  p.pos = static_cast<const int*>(pos);
  p.q_lens = nullptr;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.KV = KV;
  p.NB = S / BLOCK_K;
  p.bs = BLOCK_K;
  p.grid_k = S / BLOCK_K;
  p.SQ = 1;
  p.scale = scale;
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_g<64>(p, B, G, s);
    case 128: return launch_g<128>(p, B, G, s);
    case 256: return launch_g<256>(p, B, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
