// Lock-step dense decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` in
// kata_xpu_device_plugin_tpu/ops/decode_attn.py (launched by
// `pallas_decode_attention`): single-token GQA attention into a dense bf16
// KV cache [B, S, KV, D] read in place, with ONE position shared by the
// whole batch (the decode loop of `generate` advances every row in
// lock-step). The position is a device scalar the kernel reads itself, so
// the host never waits for it. Chunks of 128 keys past the position exit
// at once, so traffic scales with the position, not with S.
//
// It shares the split-K passes of the paged kernel (decode_split.cuh):
// dense addressing is paged addressing with the identity table and one
// position, and its 128-key tile is one chunk, as for the slotted arena's
// re-view, so both routes of `generate` give the same bits. What bounds
// it: bytes, as for the paged kernel: K and V of every live position read
// once. Known weaknesses, as there: the partials' round trip through device
// memory, the second launch for the combine, the m16 tile's padding rows
// at G < 8, and cp.async copies where TMA with a producer warp would free
// the other warps from address arithmetic.

#include "decode_split.cuh"

namespace {

using decode_split::Params;

constexpr int BLOCK_K = 128;

template <int D, int G>
__global__ void __launch_bounds__(decode_split::NTHREADS)
    dense_decode_split_kernel(const Params p) {
  decode_split::split_pass<D, G, false, true>(p);
}

template <int D>
__global__ void __launch_bounds__(D) dense_decode_combine_kernel(const Params p) {
  decode_split::combine_pass<D, true>(p);
}

template <int D, int G>
int launch(const Params& p, cudaStream_t s) {
  return decode_split::launch_passes<D, G, false>(
      dense_decode_split_kernel<D, G>, dense_decode_combine_kernel<D>, p, s);
}

// Every group G = H / KV from 1 to 8, as for the paged kernel.
template <int D>
int launch_g(const Params& p, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(p, s);
    case 2: return launch<D, 2>(p, s);
    case 3: return launch<D, 3>(p, s);
    case 4: return launch<D, 4>(p, s);
    case 5: return launch<D, 5>(p, s);
    case 6: return launch<D, 6>(p, s);
    case 7: return launch<D, 7>(p, s);
    case 8: return launch<D, 8>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). q and o are contiguous [B, 1, H, D]
// bf16; k and v the contiguous, 16-byte aligned [B, S, KV, D] bf16 cache,
// S a multiple of 128; pos one int32 on the device. `part` is fp32 scratch
// of B*H*n_chunks*(D + 2) floats; T and n_chunks are the wrapper's
// `decode_chunks(128, S / 128)`.
extern "C" int dense_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* pos, void* o, void* part, int B,
                                 int S, int H, int KV, int D, int T,
                                 int n_chunks, float scale, void* stream) {
  if (S % BLOCK_K || H % KV || n_chunks < 1 || T < 1 ||
      T > decode_split::MAX_T)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const long long rows = static_cast<long long>(B) * H * n_chunks;
  p.acc = static_cast<float*>(part);
  p.m = p.acc + rows * D;
  p.l = p.m + rows;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.NB = S / BLOCK_K;
  p.bs = BLOCK_K;
  p.grid_k = S / BLOCK_K;
  p.SQ = 1;
  p.T = T;
  p.n_chunks = n_chunks;
  p.scale = scale;
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_g<64>(p, G, s);
    case 128: return launch_g<128>(p, G, s);
    case 256: return launch_g<256>(p, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
