// Ray-major NeRF field forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/mlp_kernel.py::_fused_ray_forward /
// _ray_fwd_kernel, the TPU kernel that evaluates the reference field at
// every (ray, sample) pair of a render chunk. For each sample row it
// computes the point o + t*d, the float32 positional encoding of the point
// (60) and of the direction (24), the 8x256 skip MLP with its heads, and
// writes four dense (B, N) float32 planes: sigma, r, g, b. It runs in
// float32 or in the TPU kernel's bf16 form (field_common.cuh, the precision
// note).
//
// What bounds it: FLOPs. A row costs 2 * 591,488 = 1,182,976 FLOP and moves
// 20 bytes (t in; sigma, r, g, b out), so at any real B*N the work is far
// above the card's FLOP-per-byte ridge. The weights (2.38 MB in float32,
// 1.19 MB packed in bf16) do not fit in a block's shared memory, as they
// fit in a TPU core's VMEM; they stay warm in the 50 MB L2 and are streamed
// through shared memory.
//
// Design:
// - one block of 256 threads takes TILE_M = 64 consecutive sample rows of
//   the flat B*N index, masking the ragged end instead of padding;
// - the tile's encodings and its 64 x 256 activations live in shared
//   memory for the whole network, and each layer's weights stream through
//   a shared K-tile from L2;
// - fp32 (field_common.cuh, network_fwd): each thread holds an 8-row x
//   (OUT/32)-column register tile, accumulated with float32 FMA, and the
//   weights stream through a 16-row K-tile;
// - bf16 (field_tc.cuh, network_tc): the weights are packed into bf16 once
//   a call (pack_weights, into the caller's `packed` buffer), and every
//   product runs on the tensor cores (mma.sync m16n8k16, f32 accumulation),
//   the weights streaming through a double-buffered 32-row K-tile with
//   cp.async;
// - bias and ReLU are fused into the store; the heads (sigma: abs, color:
//   sigmoid) are float32 warp reductions;
// - 103 KB of shared memory a block (the bf16 tile uses 85 KB of it) lets
//   two blocks share an SM, so one block's weight loads overlap the
//   other's products.

#include "field_tc.cuh"
#include "launch_cache.cuh"

namespace {

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
field_rays_fwd_kernel(const float* __restrict__ origins,
                      const float* __restrict__ dirs,
                      const float* __restrict__ ts, Params p,
                      float* __restrict__ sigma_out, float* __restrict__ r_out,
                      float* __restrict__ g_out, float* __restrict__ b_out,
                      int n_samples, int total) {
  extern __shared__ float4 smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int base = blockIdx.x * TILE_M;
  field_tile<BF16>(s, p, RayCoord{origins, dirs, ts, n_samples}, base, total,
                   [&](int m, int ch, float v) {
                     (ch == 0 ? r_out : ch == 1 ? g_out : ch == 2 ? b_out : sigma_out)[m] = v;
                   });
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes.
int field_rays_fwd_smem_bytes() { return (int)sizeof(FwdSmem); }

// bf16 elements of the `packed` buffer the bf16 form takes.
int field_packed_weights_elems() { return PK_ELEMS; }

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// all float32, contiguous, on the current device. params: 25 device
// pointers: the 12 weights, the 12 biases (layer order in
// field_common.cuh), then the 14 frequencies. bf16: nonzero for the bf16
// form, which packs the weights into `packed` (field_packed_weights_elems()
// bf16, 16-byte aligned; null for fp32). Launches on `stream` and returns
// the first launch error, or 0.
int field_rays_fwd(const float* origins, const float* dirs, const float* ts,
                   const void* const* params, float* sigma, float* r, float* g,
                   float* b, void* packed, int n_rays, int n_samples, int bf16,
                   void* stream) {
  Params p = unpack_params(params);
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  if (total > 0x7fffffffLL - TILE_M) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(packed);
    p.wb = wb;
    const int e = pack_weights(p, wb, static_cast<cudaStream_t>(stream), false);
    if (e != 0) return e;
  }
  auto kernel = bf16 ? &field_rays_fwd_kernel<true> : &field_rays_fwd_kernel<false>;
  cudaError_t err = launch_cache::allow_smem(kernel, sizeof(FwdSmem));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((total + TILE_M - 1) / TILE_M);
  kernel<<<blocks, THREADS, sizeof(FwdSmem), static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, ts, p, sigma, r, g, b, n_samples, (int)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
