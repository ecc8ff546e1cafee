// Building blocks shared by the NeRF field kernels for Hopper (sm_90a):
// field_rays_fwd.cu (the ray-major forward), field_rays_bwd.cu (its
// recompute backward) and field_flat_fwd.cu (the forward over flat rows of
// points). All evaluate the reference field, the 8x256 skip MLP with its
// heads over the float32 positional encoding of the point and of the
// direction.
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
//
// Precision: every kernel is a template over BF16. With BF16 it rounds to
// bfloat16 (round to nearest even) where the TPU kernel casts to its
// compute dtype: the weights as they enter the K-tile (and the head weights
// as they are read), the encoding as a product reads it, and every
// activation as it is written to shared memory (the backward also rounds
// each pre-activation gradient). The encoding itself stays float32 in
// shared memory, for the backward's chain through sin/cos. A product of two
// bfloat16 values is exact in float32 and the sums stay float32, so this is
// the TPU's bf16 matrix unit with f32 accumulation, up to summation order.
// Biases stay float32 and are added after the sum.

#pragma once

#include <cuda_bf16.h>
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

// x rounded to the nearest bfloat16 with BF16, x itself without.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <bool BF16>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<BF16>(v.x), rnd<BF16>(v.y), rnd<BF16>(v.z), rnd<BF16>(v.w));
}

// The coordinates of a ray-major row m = ray * n_samples + sample: channel c
// of the point o + t*d, or of the direction d.
struct RayCoord {
  const float* __restrict__ origins;
  const float* __restrict__ dirs;
  const float* __restrict__ ts;
  int n_samples;
  __device__ __forceinline__ float operator()(int m, int c, bool is_pt) const {
    const int ray = m / n_samples;
    const float d = dirs[3 * ray + c];
    return is_pt ? __fadd_rn(origins[3 * ray + c], __fmul_rn(ts[m], d)) : d;
  }
};

// Encode rows base .. base+TILE_M-1 into enc_pt / enc_dir, interleaved
// [sin f0 x, cos f0 x, ...] per channel, in float32; coord(m, c, is_pt)
// gives channel c of row m's point or direction. Rows at or past row_end
// encode x = 0. Ends with a barrier.
template <class Coord>
__device__ __forceinline__ void encode_tile(Coord coord,
                                            const float* __restrict__ freqs,
                                            int base, int row_end,
                                            float (*enc_pt)[PT_ENC],
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
    const float x = m < row_end ? coord(m, c, is_pt) : 0.f;
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
// multiple of 4. With BF16 the weights are rounded as they enter the
// K-tile, and with ROUND_SRC the src values as they are read (the float32
// encoding; activations are stored rounded already). Ends with a barrier,
// so the caller may overwrite src.
template <int NC, bool BF16, bool ROUND_SRC = false>
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
    for (int i = threadIdx.x; i < kt * OUT / 4; i += THREADS) s[i] = rnd4<BF16>(__ldg(g + i));
    __syncthreads();
    for (int kk = 0; kk < kt; kk += 4) {
      float a[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float4 v = *reinterpret_cast<const float4*>(
            src + (row0 + i) * src_stride + k0 + kk);
        if constexpr (ROUND_SRC) v = rnd4<BF16>(v);
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

// act[row_i][col_j] = (relu)(acc + bias), rounded with BF16, then a barrier.
// With `save`, rows below `valid` are also written to save[row *
// save_stride + col].
template <int NC, bool RELU, bool BF16>
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
      const float y = rnd<BF16>(RELU ? fmaxf(v, 0.f) : v);
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

// Shared memory of the forward kernels: 103 KB, so two blocks share an SM.
struct FwdSmem {
  float act[TILE_M][WIDTH];
  float enc_pt[TILE_M][PT_ENC];
  float enc_dir[TILE_M][DIR_ENC];
  float wt[KT * WIDTH];
};

// The network over rows base .. base+TILE_M-1, whose encodings are in s:
// the trunk (8 x 256, input skip at layer 4, hidden first), sigma = |h .
// w_sigma + b|, point_info, the view branch relu([dir_enc, point_info] W +
// b) and color = sigmoid(h_dir W + b). For each row m < total it calls
// out(m, ch, value) with ch 0, 1, 2 for r, g, b and 3 for sigma.
template <bool BF16, class Out>
__device__ __forceinline__ void network_fwd(FwdSmem& s, const Params& p,
                                            int base, int total, Out out) {
  float acc[ROWS][8];
  zero(acc);
  gemm_segment<8, BF16, true>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC, p.w[0], s.wt);
  store<8, true, BF16>(acc, p.b[0], s.act);
  for (int layer = 1; layer < 8; ++layer) {
    zero(acc);
    gemm_segment<8, BF16>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[layer], s.wt);
    if (layer == 4)
      gemm_segment<8, BF16, true>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC,
                                  p.w[4] + WIDTH * WIDTH, s.wt);
    store<8, true, BF16>(acc, p.b[layer], s.act);
  }

  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;

  // sigma (reads act before point_info's store)
  for (int i = 0; i < ROWS; ++i) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < WIDTH / 32; ++q)
      v = fmaf(s.act[row0 + i][lane + 32 * q],
               rnd<BF16>(__ldg(p.w[SIGMA] + lane + 32 * q)), v);
    v = warp_sum(v);
    const int m = base + row0 + i;
    if (lane == 0 && m < total) out(m, 3, fabsf(v + __ldg(p.b[SIGMA])));
  }

  // point_info = h W + b, no activation
  zero(acc);
  gemm_segment<8, BF16>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[POINT_INFO], s.wt);
  store<8, false, BF16>(acc, p.b[POINT_INFO], s.act);

  // the view branch, 280 -> 128
  float acc4[ROWS][4];
  zero(acc4);
  gemm_segment<4, BF16, true>(acc4, &s.enc_dir[0][0], DIR_ENC, DIR_ENC,
                              p.w[DIR_INFO], s.wt);
  gemm_segment<4, BF16>(acc4, &s.act[0][0], WIDTH, WIDTH,
                        p.w[DIR_INFO] + DIR_ENC * (WIDTH / 2), s.wt);
  store<4, true, BF16>(acc4, p.b[DIR_INFO], s.act);

  // color, 128 -> 3
  for (int i = 0; i < ROWS; ++i) {
    float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < WIDTH / 2 / 32; ++q) {
      const int k = lane + 32 * q;
      const float h = s.act[row0 + i][k];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = fmaf(h, rnd<BF16>(__ldg(p.w[COLOR] + 3 * k + c)), v[c]);
    }
    const int m = base + row0 + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = warp_sum(v[c]) + __ldg(p.b[COLOR] + c);
      if (lane == 0 && m < total) out(m, c, 1.f / (1.f + expf(-x)));
    }
  }
}

}  // namespace
