// Ray-major proposal MLP forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/proposal_kernel.py::_prop_ray_forward /
// _prop_ray_fwd_kernel, the TPU kernel that evaluates the proposal field at
// every (ray, sample) pair of the coarse pass (PROP_PALLAS). For each sample
// row it computes the point o + t*d, the float32 positional encoding of the
// point (60) and of the direction (24), the depth x width ReLU trunk and
// both heads (prop_common.cuh), and writes four dense (B, N) float32 planes:
// sigma, r, g, b. It runs in float32 or in the TPU kernel's bf16 form
// (field_common.cuh, the precision note).
//
// What bounds it: FLOPs. At 128 x 4 a row costs 114,832 FLOP and moves 20
// bytes (t in; sigma, r, g, b out); the 84 sines and cosines of the
// encoding are the rest of its work. The weights (232 KB at 128 x 4) stay
// warm in L2 and stream through shared memory.
//
// Design (a simple first kernel; wgmma and TMA are later work): one block
// of 256 threads takes 64 consecutive sample rows of the flat B*N index,
// masking the ragged end; the tile's encodings and activations stay in
// shared memory for the whole network (the forward kernels' FwdSmem, 103
// KB, two blocks an SM); each layer's weights stream through a 16-row
// K-tile; the heads are warp reductions. The width is a template parameter
// (NC = width / 32 columns a thread), so every thread works at every width.

#include "prop_common.cuh"

namespace {

template <int NC, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
prop_rays_fwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const float* __restrict__ ts, PropParams p,
                     float* __restrict__ sigma_out, float* __restrict__ r_out,
                     float* __restrict__ g_out, float* __restrict__ b_out, int n_samples,
                     int total) {
  extern __shared__ float4 smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int base = blockIdx.x * TILE_M;
  encode_tile(RayCoord{origins, dirs, ts, n_samples}, p.freqs, base, total, s.enc_pt,
              s.enc_dir);
  trunk_fwd<NC, BF16>(p, s.enc_pt, &s.act[0][0], WIDTH, s.wt, nullptr);
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + i, m = base + r;
    float sigma_pre, x[3];
    heads<NC, BF16>(p, s.act[r], s.enc_dir[r], sigma_pre, x);
    if (lane == 0 && m < total) {
      sigma_out[m] = fabsf(sigma_pre);
      r_out[m] = sigmoid(x[0]);
      g_out[m] = sigmoid(x[1]);
      b_out[m] = sigmoid(x[2]);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes.
int prop_rays_fwd_smem_bytes() { return (int)sizeof(FwdSmem); }

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// all float32, contiguous, on the current device. params: 2 * depth + 5
// device pointers (prop_common.cuh, unpack_prop). width: a multiple of 32
// up to 256; depth: 1..64. bf16: nonzero for the bf16 form. Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// shapes it does not take.
int prop_rays_fwd(const float* origins, const float* dirs, const float* ts,
                  const void* const* params, float* sigma, float* r, float* g, float* b,
                  int n_rays, int n_samples, int width, int depth, int bf16, void* stream) {
  if (!dims_ok(width, depth)) return (int)cudaErrorInvalidValue;
  const PropParams p = unpack_prop(params, depth);
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  if (total > 0x7fffffffLL - TILE_M) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((total + TILE_M - 1) / TILE_M);
  return dispatch(width, bf16, [&](auto nc, auto is_bf16) {
    auto kernel = &prop_rays_fwd_kernel<decltype(nc)::value, decltype(is_bf16)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(FwdSmem));
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, THREADS, sizeof(FwdSmem), static_cast<cudaStream_t>(stream)>>>(
        origins, dirs, ts, p, sigma, r, g, b, n_samples, (int)total);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
