// Building blocks shared by the CP grid field kernels for Hopper (sm_90a):
// grid_rays_fwd.cu (the ray-major forward) and grid_rays_bwd.cu (its
// recompute backward). Both evaluate the factorized field of
// tinynerf_torch/core/gridfield.py at the points o + t*d of a ray batch:
//
//   xg_a  = clip((p_a + E) / 2E, 0, 1) * (R - 1)           a in {x, y, z}
//   f_a   = w0 * T_a[i0] + w1 * T_a[i1]     i0 = floor(xg_a), i1 = i0 + 1
//   prod  = f_x * f_y * f_z                                  (F = Fd + Fa)
//   sigma = |sum prod[:Fd]|
//   h     = relu([dir_enc, prod[Fd:]] W1 + b1)
//   rgb   = sigmoid(h W2 + b2)
//
// with the hat weights w = relu(1 - |xg - idx|) computed in float32, the
// upper tap clamped at R - 1 (where its weight is 0). The TPU kernel writes
// the lerp as a hat-basis matmul over all R rows (its MXU has no gather);
// here it is two row reads per axis from tables that stay in L2.
//
// Numerics follow the plain PyTorch version (kernels/grid_kernel.py): o + t*d,
// the coordinate's division and the lerp use __fmul_rn/__fadd_rn/__fdiv_rn,
// so that nvcc cannot contract them into an FMA or a reciprocal multiply.
//
// Precision: each kernel is a template over BF16. With BF16 it rounds to
// bfloat16 where the TPU kernel casts to its compute dtype: the hat weights
// and the tables, each line feature (the two-tap sum, taken in float32), each
// CP product, the direction encoding and W1 as they enter the hidden layer,
// h and W2 as they enter the color head. The sigma sum, the decoder's sums
// and every bias add stay float32.
//
// Row layout in shared memory: x[r] = [dir_enc (24) | prod (F)], so the
// hidden layer's input [dir_enc, prod[Fd:]] is x[r][k] for k < 24 and
// x[r][k + Fd] after. W1 is staged transposable: row k at k * (W + 1), so
// that a warp reading a row (fixed k) or a column (fixed j) hits 32 banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int TILE = 32;      // sample rows per tile
constexpr int DIR_ENC = 24;   // the direction encoding's width
constexpr int RQ = 4;         // rows per thread in the hidden layer

struct Dims {
  int res, nd, na, width;
  __host__ __device__ int F() const { return nd + na; }
  __host__ __device__ int K() const { return DIR_ENC + na; }
  __host__ __device__ int XS() const { return DIR_ENC + nd + na; }
};

struct GridParams {
  const float* table[3];  // (res, F) each, density columns first
  const float* w1;        // (K, width)
  const float* b1;        // (width,)
  const float* w2;        // (width, 3)
  const float* b2;        // (3,)
  const float* ext;       // the grid's half-extent, one float on the device
};

// params: the 8 device pointers tx, ty, tz, w1, b1, w2, b2, extent.
inline GridParams unpack_grid_params(const void* const* params) {
  GridParams p;
  for (int a = 0; a < 3; ++a) p.table[a] = static_cast<const float*>(params[a]);
  p.w1 = static_cast<const float*>(params[3]);
  p.b1 = static_cast<const float*>(params[4]);
  p.w2 = static_cast<const float*>(params[5]);
  p.b2 = static_cast<const float*>(params[6]);
  p.ext = static_cast<const float*>(params[7]);
  return p;
}

// Host-side checks of what the kernels take: 0, or cudaErrorInvalidValue.
inline int check_dims(const Dims& dm) {
  if (dm.res < 2 || dm.nd < 1 || dm.na < 0 || dm.width < 1 || dm.width > THREADS ||
      THREADS % dm.width != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

struct Rays {
  const float* __restrict__ origins;  // (B, 3)
  const float* __restrict__ dirs;     // (B, 3)
  const float* __restrict__ ts;       // (B, N)
  const float* __restrict__ de;       // (B, 24), the direction encoding
  int n_samples;
};

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One axis of one point: the two taps and what the backward needs of them.
struct Tap {
  int i0, i1;       // rows; i1 = min(i0 + 1, res - 1)
  float w0, w1;     // hat weights relu(1 - |xg - idx|), float32
  float m0, m1;     // 1 where 1 - |xg - idx| > 0 (relu'(0) = 0), else 0
  float clip_grad;  // d clip / d raw: 1 inside, 0.5 at 0 or 1 exactly, 0 outside
};

__device__ __forceinline__ Tap make_tap(float p, float ext, int res) {
  const float raw = __fdiv_rn(__fadd_rn(p, ext), __fmul_rn(2.f, ext));
  const float xg = __fmul_rn(fminf(fmaxf(raw, 0.f), 1.f), (float)(res - 1));
  const float lower = floorf(xg);
  const float pre0 = __fsub_rn(1.f, fabsf(__fsub_rn(xg, lower)));
  const float pre1 = __fsub_rn(1.f, fabsf(__fsub_rn(xg, lower + 1.f)));
  Tap t;
  t.i0 = (int)lower;
  t.i1 = min(t.i0 + 1, res - 1);
  t.w0 = fmaxf(pre0, 0.f);
  t.w1 = fmaxf(pre1, 0.f);
  t.m0 = pre0 > 0.f ? 1.f : 0.f;
  t.m1 = pre1 > 0.f ? 1.f : 0.f;
  t.clip_grad = 0.5f * ((raw >= 0.f && raw <= 1.f) ? 1.f : 0.f) +
                0.5f * ((raw > 0.f && raw < 1.f) ? 1.f : 0.f);
  return t;
}

// The taps of one tile, TILE rows x 3 axes; index r * 3 + a.
struct TileTaps {
  int* i0;
  int* i1;
  float* w0;     // rounded with BF16 (the hat weights' cast)
  float* w1;
  float* m0;     // only with the backward's extras
  float* m1;
  float* clip_grad;
};

// Stage the decoder into shared memory, rounded with BF16: w1s[k * (W + 1)
// + j] = W1[k][j], w2s[j * 3 + c] = W2[j][c]. Ends with a barrier.
template <bool BF16>
__device__ __forceinline__ void stage_decoder(const GridParams& p, const Dims& dm,
                                              float* w1s, float* w2s) {
  const int W = dm.width, K = dm.K();
  for (int idx = threadIdx.x; idx < K * W; idx += THREADS)
    w1s[(idx / W) * (W + 1) + idx % W] = rnd<BF16>(__ldg(p.w1 + idx));
  for (int idx = threadIdx.x; idx < W * 3; idx += THREADS)
    w2s[idx] = rnd<BF16>(__ldg(p.w2 + idx));
  __syncthreads();
}

// Rows base .. base+TILE-1 (rows at or past row_end are zero): the taps,
// the rounded direction encoding into x[r][0:24], the CP product into
// x[r][24:24+F] and, with feats, each line feature at feats[(a * TILE + r)
// * F + f]. Ends with a barrier.
template <bool BF16, bool EXTRAS>
__device__ __forceinline__ void load_tile(const Rays& rays, const GridParams& p,
                                          const Dims& dm, float ext, long long base,
                                          long long row_end, float* x,
                                          const TileTaps& tp, float* feats) {
  const int F = dm.F(), XS = dm.XS();
  for (int idx = threadIdx.x; idx < TILE * 3; idx += THREADS) {
    const int r = idx / 3, a = idx % 3;
    const long long m = base + r;
    Tap t{0, 0, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < row_end) {
      const long long ray = m / rays.n_samples;
      const float pt = __fadd_rn(__ldg(rays.origins + 3 * ray + a),
                                 __fmul_rn(__ldg(rays.ts + m), __ldg(rays.dirs + 3 * ray + a)));
      t = make_tap(pt, ext, dm.res);
    }
    tp.i0[idx] = t.i0;
    tp.i1[idx] = t.i1;
    tp.w0[idx] = rnd<BF16>(t.w0);
    tp.w1[idx] = rnd<BF16>(t.w1);
    if constexpr (EXTRAS) {
      tp.m0[idx] = t.m0;
      tp.m1[idx] = t.m1;
      tp.clip_grad[idx] = t.clip_grad;
    }
  }
  for (int idx = threadIdx.x; idx < TILE * DIR_ENC; idx += THREADS) {
    const int r = idx / DIR_ENC, k = idx % DIR_ENC;
    const long long m = base + r;
    x[r * XS + k] = m < row_end
        ? rnd<BF16>(__ldg(rays.de + (m / rays.n_samples) * DIR_ENC + k)) : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * F; idx += THREADS) {
    const int r = idx / F, f = idx % F;
    float fa[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int t = r * 3 + a;
      const float* tab = p.table[a];
      const float v0 = rnd<BF16>(__ldg(tab + (size_t)tp.i0[t] * F + f));
      const float v1 = rnd<BF16>(__ldg(tab + (size_t)tp.i1[t] * F + f));
      fa[a] = rnd<BF16>(__fadd_rn(__fmul_rn(tp.w0[t], v0), __fmul_rn(tp.w1[t], v1)));
      if constexpr (EXTRAS) feats[(a * TILE + r) * F + f] = fa[a];
    }
    x[r * XS + DIR_ENC + f] = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(fa[0], fa[1])), fa[2]));
  }
  __syncthreads();
}

// sum prod[:Fd] of row r, one warp, float32 (every lane gets it).
__device__ __forceinline__ float row_sigma_pre(const Dims& dm, const float* x, int r) {
  const int lane = threadIdx.x & 31;
  const float* row = x + r * dm.XS() + DIR_ENC;
  float s = 0.f;
  for (int f = lane; f < dm.nd; f += 32) s += row[f];
  return warp_sum(s);
}

// hp[r * W + j] = [dir_enc, prod[Fd:]] . W1[:, j] + b1[j] for the tile's
// rows (float32 sums of the staged, rounded operands). Thread t takes
// column t % W and rows t / W + (THREADS / W) * q. Ends with a barrier.
__device__ __forceinline__ void hidden_layer(const GridParams& p, const Dims& dm,
                                             const float* x, const float* w1s,
                                             float* hp) {
  const int W = dm.width, K = dm.K(), XS = dm.XS(), S = THREADS / W;
  const int j = threadIdx.x % W;
  const float bj = __ldg(p.b1 + j);
  for (int r0 = threadIdx.x / W; r0 < TILE; r0 += S * RQ) {
    int off[RQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q) off[q] = min(r0 + S * q, TILE - 1) * XS;
    float acc[RQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q) acc[q] = 0.f;
    for (int k = 0; k < DIR_ENC; ++k) {
      const float w = w1s[k * (W + 1) + j];
#pragma unroll
      for (int q = 0; q < RQ; ++q) acc[q] = fmaf(x[off[q] + k], w, acc[q]);
    }
    for (int k = DIR_ENC; k < K; ++k) {
      const float w = w1s[k * (W + 1) + j];
#pragma unroll
      for (int q = 0; q < RQ; ++q) acc[q] = fmaf(x[off[q] + k + dm.nd], w, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < RQ; ++q)
      if (r0 + S * q < TILE) hp[(r0 + S * q) * W + j] = acc[q] + bj;
  }
  __syncthreads();
}

// The color of row r, one warp: sigmoid(rnd(relu(hp[r])) . W2[:, c] + b2[c]).
template <bool BF16>
__device__ __forceinline__ void row_color(const GridParams& p, const Dims& dm,
                                          const float* hp, const float* w2s, int r,
                                          float (&col)[3]) {
  const int lane = threadIdx.x & 31, W = dm.width;
  float v[3] = {0.f, 0.f, 0.f};
  for (int j = lane; j < W; j += 32) {
    const float h = rnd<BF16>(fmaxf(hp[r * W + j], 0.f));
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = fmaf(h, w2s[j * 3 + c], v[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = warp_sum(v[c]) + __ldg(p.b2 + c);
    col[c] = 1.f / (1.f + expf(-s));
  }
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The next n floats of a shared-memory buffer at offset q (advanced). With a
// null base only the offsets count: the host sizes the buffer that way.
__host__ __device__ __forceinline__ float* carve(float* base, size_t& q, size_t n) {
  float* at = base == nullptr ? nullptr : base + q;
  q += n;
  return at;
}

}  // namespace
