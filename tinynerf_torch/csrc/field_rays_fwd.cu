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
// above the card's FLOP-per-byte ridge. The weights (2.38 MB) do not fit in
// a block's shared memory, as they fit in a TPU core's VMEM; they stay warm
// in the 50 MB L2 and are streamed through shared memory. The bf16 form's
// products could run on the tensor cores; here they run as the same float32
// FMAs (bf16 operands, exact products), which is later work.
//
// Design (a simple first kernel; wgmma, TMA and 3xTF32 are later work):
// - one block of 256 threads takes TILE_M = 64 consecutive sample rows of
//   the flat B*N index, masking the ragged end instead of padding;
// - the tile's encodings and its 64 x 256 activations live in shared
//   memory for the whole network; each layer's weights stream through a
//   16-row shared K-tile, read from L2 (field_common.cuh, network_fwd);
// - each thread holds an 8-row x (OUT/32)-column register tile and
//   accumulates it with float32 FMA, then fuses bias and ReLU into the
//   store; heads (sigma: abs, color: sigmoid) are warp reductions;
// - 103 KB of shared memory per block lets two blocks share an SM, so one
//   block's weight loads overlap the other's FMAs.

#include "field_common.cuh"

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
  encode_tile(RayCoord{origins, dirs, ts, n_samples}, p.freqs, base, total,
              s.enc_pt, s.enc_dir);
  network_fwd<BF16>(s, p, base, total, [&](int m, int ch, float v) {
    (ch == 0 ? r_out : ch == 1 ? g_out : ch == 2 ? b_out : sigma_out)[m] = v;
  });
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes.
int field_rays_fwd_smem_bytes() { return (int)sizeof(FwdSmem); }

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// all float32, contiguous, on the current device. params: 25 device
// pointers: the 12 weights, the 12 biases (layer order in
// field_common.cuh), then the 14 frequencies. bf16: nonzero for the bf16
// form. Launches on `stream` and returns cudaGetLastError().
int field_rays_fwd(const float* origins, const float* dirs, const float* ts,
                   const void* const* params, float* sigma, float* r, float* g,
                   float* b, int n_rays, int n_samples, int bf16, void* stream) {
  const Params p = unpack_params(params);
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  if (total > 0x7fffffffLL - TILE_M) return (int)cudaErrorInvalidValue;
  auto kernel = bf16 ? &field_rays_fwd_kernel<true> : &field_rays_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(FwdSmem));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((total + TILE_M - 1) / TILE_M);
  kernel<<<blocks, THREADS, sizeof(FwdSmem), static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, ts, p, sigma, r, g, b, n_samples, (int)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
