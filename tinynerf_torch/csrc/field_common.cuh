// Building blocks shared by the ray-major field kernels for Hopper (sm_90a):
// field_rays_fwd.cu (the forward) and field_rays_bwd.cu (its recompute
// backward). Both evaluate the reference field, the 8x256 skip MLP with its
// heads over the float32 positional encoding of o + t*d and of d.
//
// A block of THREADS threads takes TILE_M consecutive sample rows; warp w
// owns rows 8w .. 8w+7 and each thread holds an 8-row x (OUT/32)-column
// register tile (row_i = 8*warp + i, col_j = lane + 32*j), accumulated with
// float32 FMA (no tensor cores, no TF32). A layer's weights, (fan_in,
// fan_out) row-major, stream through a KT-row shared K-tile from L2.
//
// Numerics follow the plain PyTorch version: o + t*d and freq*x use
// __fmul_rn/__fadd_rn so that nvcc cannot contract them into an FMA, and
// the encoding uses the accurate sinf/cosf (never __sinf/__cosf or
// --use_fast_math, whose argument reduction is wrong at |arg| ~ 6e3).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE_M = 64;   // sample rows per tile
constexpr int THREADS = 256; // 8 warps; warp w owns rows 8w .. 8w+7
constexpr int ROWS = 8;      // rows per thread
constexpr int KT = 16;       // weight rows per shared K-tile
constexpr int WIDTH = 256;
constexpr int L_PT = 10;
constexpr int L_DIR = 4;
constexpr int PT_ENC = 3 * 2 * L_PT;   // 60
constexpr int DIR_ENC = 3 * 2 * L_DIR; // 24
constexpr int N_LAYERS = 12;

// Layer order (tinynerf_torch.core.mlp.layer_dims): trunk_0..trunk_7,
// sigma, point_info, dir_info, color. Weights are (fan_in, fan_out)
// row-major.
enum { SIGMA = 8, POINT_INFO = 9, DIR_INFO = 10, COLOR = 11 };

struct Params {
  const float* w[N_LAYERS];
  const float* b[N_LAYERS];
  const float* freqs;  // L_PT point frequencies, then L_DIR direction ones
};

// params: the 12 weights, the 12 biases (layer order above), then the 14
// frequencies, as device pointers.
inline Params unpack_params(const void* const* params) {
  Params p;
  for (int i = 0; i < N_LAYERS; ++i) {
    p.w[i] = static_cast<const float*>(params[i]);
    p.b[i] = static_cast<const float*>(params[N_LAYERS + i]);
  }
  p.freqs = static_cast<const float*>(params[2 * N_LAYERS]);
  return p;
}

// Encode rows base .. base+TILE_M-1 of the flat (ray, sample) index into
// enc_pt / enc_dir, interleaved [sin f0 x, cos f0 x, ...] per channel. Rows
// at or past row_end encode x = 0. Ends with a barrier.
__device__ __forceinline__ void encode_tile(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ ts, const float* __restrict__ freqs, int base,
    int row_end, int n_samples, float (*enc_pt)[PT_ENC],
    float (*enc_dir)[DIR_ENC]) {
  for (int idx = threadIdx.x; idx < TILE_M * 3 * (L_PT + L_DIR);
       idx += THREADS) {
    const int r = idx / (3 * (L_PT + L_DIR));
    const int rem = idx % (3 * (L_PT + L_DIR));
    const int m = base + r;
    const bool is_pt = rem < 3 * L_PT;
    const int L = is_pt ? L_PT : L_DIR;
    const int e = is_pt ? rem : rem - 3 * L_PT;
    const int c = e / L, l = e % L;
    float x = 0.f;
    if (m < row_end) {
      const int ray = m / n_samples;
      const float d = dirs[3 * ray + c];
      x = is_pt ? __fadd_rn(origins[3 * ray + c], __fmul_rn(ts[m], d)) : d;
    }
    const float arg = __fmul_rn(x, freqs[is_pt ? l : L_PT + l]);
    float* out = is_pt ? &enc_pt[r][c * 2 * L + 2 * l]
                       : &enc_dir[r][c * 2 * L + 2 * l];
    out[0] = sinf(arg);
    out[1] = cosf(arg);
  }
  __syncthreads();
}

// acc[i][j] += sum_k src[row_i][k] * W[k][col_j] over one input segment
// (K rows of W). OUT = 32*NC. src rows are 16-byte aligned and K is a
// multiple of 4. Ends with a barrier, so the caller may overwrite src.
template <int NC>
__device__ __forceinline__ void gemm_segment(float (&acc)[ROWS][NC],
                                             const float* src, int src_stride,
                                             int K, const float* __restrict__ w,
                                             float* wt) {
  constexpr int OUT = 32 * NC;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    const float4* g = reinterpret_cast<const float4*>(w + (size_t)k0 * OUT);
    float4* s = reinterpret_cast<float4*>(wt);
    for (int i = threadIdx.x; i < kt * OUT / 4; i += THREADS) s[i] = __ldg(g + i);
    __syncthreads();
    for (int kk = 0; kk < kt; kk += 4) {
      float a[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            src + (row0 + i) * src_stride + k0 + kk);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) b[j] = wt[(kk + q) * OUT + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with wt and src
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[ROWS][NC]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }
}

// act[row_i][col_j] = (relu)(acc + bias), then a barrier. With `save`, rows
// below `valid` are also written to save[row * save_stride + col].
template <int NC, bool RELU>
__device__ __forceinline__ void store(float (&acc)[ROWS][NC],
                                      const float* __restrict__ bias,
                                      float (*act)[WIDTH],
                                      float* __restrict__ save = nullptr,
                                      int save_stride = 0, int valid = 0) {
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float bj = __ldg(bias + lane + 32 * j);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float v = acc[i][j] + bj;
      const float y = RELU ? fmaxf(v, 0.f) : v;
      act[row0 + i][lane + 32 * j] = y;
      if (save != nullptr && row0 + i < valid)
        save[(size_t)(row0 + i) * save_stride + lane + 32 * j] = y;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
