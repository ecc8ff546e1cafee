// Ray-major NeRF field forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/mlp_kernel.py::_fused_ray_forward /
// _ray_fwd_kernel, the TPU kernel that evaluates the reference field at
// every (ray, sample) pair of a render chunk. For each sample row it
// computes the point o + t*d, the float32 positional encoding of the point
// (60) and of the direction (24), the 8x256 skip MLP with its heads, and
// writes four dense (B, N) float32 planes: sigma, r, g, b.
//
// What bounds it: float32 FLOPs. A row costs 2 * 591,488 = 1,182,976 FLOP
// and moves 20 bytes (t in; sigma, r, g, b out), so at any real B*N the
// work is far above the card's FMA-per-byte ridge. The weights (2.38 MB)
// do not fit in a block's shared memory, as they fit in a TPU core's VMEM;
// they stay warm in the 50 MB L2 and are streamed through shared memory.
//
// Design (a simple first kernel; wgmma, TMA and 3xTF32 are later work):
// - one block of 256 threads takes TILE_M = 64 consecutive sample rows of
//   the flat B*N index, masking the ragged end instead of padding;
// - the tile's encodings and its 64 x 256 activations live in shared
//   memory for the whole network; each layer's weights stream through a
//   16-row shared K-tile, read from L2 (field_common.cuh);
// - each thread holds an 8-row x (OUT/32)-column register tile and
//   accumulates it with float32 FMA, then fuses bias and ReLU into the
//   store; heads (sigma: abs, color: sigmoid) are warp reductions;
// - 103 KB of shared memory per block lets two blocks share an SM, so one
//   block's weight loads overlap the other's FMAs.

#include "field_common.cuh"

namespace {

struct Smem {
  float act[TILE_M][WIDTH];
  float enc_pt[TILE_M][PT_ENC];
  float enc_dir[TILE_M][DIR_ENC];
  float wt[KT * WIDTH];
};

__global__ void __launch_bounds__(THREADS, 2)
field_rays_fwd_kernel(const float* __restrict__ origins,
                      const float* __restrict__ dirs,
                      const float* __restrict__ ts, Params p,
                      float* __restrict__ sigma_out, float* __restrict__ r_out,
                      float* __restrict__ g_out, float* __restrict__ b_out,
                      int n_samples, int total) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int base = blockIdx.x * TILE_M;

  encode_tile(origins, dirs, ts, p.freqs, base, total, n_samples, s.enc_pt,
              s.enc_dir);

  // ---- trunk: 8 x 256, input skip at layer 4 (hidden first) ----
  float acc[ROWS][8];
  zero(acc);
  gemm_segment<8>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC, p.w[0], s.wt);
  store<8, true>(acc, p.b[0], s.act);
  for (int layer = 1; layer < 8; ++layer) {
    zero(acc);
    gemm_segment<8>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[layer], s.wt);
    if (layer == 4)
      gemm_segment<8>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC,
                      p.w[4] + WIDTH * WIDTH, s.wt);
    store<8, true>(acc, p.b[layer], s.act);
  }

  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;

  // ---- sigma = |h . w_sigma + b| (reads act before point_info's store) ----
  for (int i = 0; i < ROWS; ++i) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < WIDTH / 32; ++q)
      v = fmaf(s.act[row0 + i][lane + 32 * q], __ldg(p.w[SIGMA] + lane + 32 * q), v);
    v = warp_sum(v);
    const int m = base + row0 + i;
    if (lane == 0 && m < total) sigma_out[m] = fabsf(v + __ldg(p.b[SIGMA]));
  }

  // ---- point_info = h W + b, no activation ----
  zero(acc);
  gemm_segment<8>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[POINT_INFO], s.wt);
  store<8, false>(acc, p.b[POINT_INFO], s.act);

  // ---- dir branch: relu([dir_enc, point_info] W + b), 280 -> 128 ----
  float acc4[ROWS][4];
  zero(acc4);
  gemm_segment<4>(acc4, &s.enc_dir[0][0], DIR_ENC, DIR_ENC, p.w[DIR_INFO], s.wt);
  gemm_segment<4>(acc4, &s.act[0][0], WIDTH, WIDTH,
                  p.w[DIR_INFO] + DIR_ENC * (WIDTH / 2), s.wt);
  store<4, true>(acc4, p.b[DIR_INFO], s.act);

  // ---- color = sigmoid(h_dir W + b), 128 -> 3 ----
  for (int i = 0; i < ROWS; ++i) {
    float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < WIDTH / 2 / 32; ++q) {
      const int k = lane + 32 * q;
      const float h = s.act[row0 + i][k];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = fmaf(h, __ldg(p.w[COLOR] + 3 * k + c), v[c]);
    }
    const int m = base + row0 + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = warp_sum(v[c]) + __ldg(p.b[COLOR] + c);
      if (lane == 0 && m < total) {
        const float y = 1.f / (1.f + expf(-x));
        (c == 0 ? r_out : c == 1 ? g_out : b_out)[m] = y;
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes.
int field_rays_fwd_smem_bytes() { return (int)sizeof(Smem); }

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// all float32, contiguous, on the current device. params: 25 device
// pointers: the 12 weights, the 12 biases (layer order above), then the 14
// frequencies. Launches on `stream` and returns cudaGetLastError().
int field_rays_fwd(const float* origins, const float* dirs, const float* ts,
                   const void* const* params, float* sigma, float* r, float* g,
                   float* b, int n_rays, int n_samples, void* stream) {
  const Params p = unpack_params(params);
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  if (total > 0x7fffffffLL - TILE_M) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      field_rays_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((total + TILE_M - 1) / TILE_M);
  field_rays_fwd_kernel<<<blocks, THREADS, sizeof(Smem),
                          static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, ts, p, sigma, r, g, b, n_samples, (int)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
