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
// Two forms of one tile (Form<BF16>):
// - fp32: 32-row tiles, the decoder's products on the float32 FMA path, the
//   activations float32 in shared memory;
// - bf16: 64-row tiles, the decoder's products on the tensor cores
//   (mma.sync.m16n8k16, bf16 x bf16 with float32 sums, mma_common.cuh), the
//   activations that enter a product bf16 in shared memory (they are bf16
//   values already), the hidden layer's input padded to a multiple of 16
//   columns (KP) and its width to at least 16 (WP) with zeros, which add
//   nothing; the tables packed to bf16 once a call (pack_tables: exact, the
//   form rounds every table read), which halves the gathers' L2 bytes.
//   Each k16 step's product is summed on the tensor cores from zero and
//   added to the running sum in float32 (mma_unit), the nearest the tensor
//   cores come to the plain version's float32 sum.
//
// Row layout of a tile: hin[r] = [dir_enc (24) | prod[Fd:] (Fa) | zeros]
// (the hidden layer's input), sig[r] = sum prod[:Fd]; W1 staged as [k][j].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int MAX_THREADS = 512;  // a block: 256 or 512 threads (threads_for)
constexpr int MAX_WIDTH = 256;  // the decoder width must divide it
constexpr int DIR_ENC = 24;   // the direction encoding's width
constexpr int RQ = 4;         // rows per thread in the fp32 hidden layer
constexpr int MAX_F = 256;    // table columns the kernels take (the backward's column owners)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may take

template <bool BF16>
struct Form {
  static constexpr int TILE = BF16 ? 64 : 32;  // sample rows a tile
  using Act = std::conditional_t<BF16, bf16, float>;  // activations in shared memory
};

struct Dims {
  int res, nd, na, width;
  __host__ __device__ int F() const { return nd + na; }
  __host__ __device__ int K() const { return DIR_ENC + na; }
  __host__ __device__ int KP() const { return (K() + 15) / 16 * 16; }
  __host__ __device__ int WP() const { return width < 16 ? 16 : width; }
};

// Row strides (elements) and padded sizes of a form's tile buffers.
template <bool BF16>
struct Strides {
  int kin;   // columns of hin the hidden layer reads: KP (bf16) or K
  int wout;  // columns of the hidden layer: WP (bf16) or width
  int hin;   // hin's row stride
  int w1;    // the staged W1's row stride
  int hp;    // h_pre's row stride (float32)
  int gh;    // g_h's row stride
  __host__ __device__ explicit Strides(const Dims& dm) {
    kin = BF16 ? dm.KP() : dm.K();
    wout = BF16 ? dm.WP() : dm.width;
    hin = BF16 ? kin + 8 : kin + 1;  // bf16: ldmatrix rows 16-byte aligned, banks apart
    w1 = BF16 ? wout + 8 : wout + 1;
    hp = BF16 ? wout + 4 : wout;
    gh = BF16 ? wout + 8 : wout;
  }
};

struct GridParams {
  const float* table[3];  // (res, F) each, density columns first
  const bf16* tab16;      // bf16 forms: the three tables packed to bf16 (pack_tables)
  const float* w1;        // (K, width)
  const float* b1;        // (width,)
  const float* w2;        // (width, 3)
  const float* b2;        // (3,)
  const float* ext;       // the grid's half-extent, one float on the device
};

// params: the 8 device pointers tx, ty, tz, w1, b1, w2, b2, extent.
inline GridParams unpack_grid_params(const void* const* params, const bf16* tab16) {
  GridParams p;
  for (int a = 0; a < 3; ++a) p.table[a] = static_cast<const float*>(params[a]);
  p.tab16 = tab16;
  p.w1 = static_cast<const float*>(params[3]);
  p.b1 = static_cast<const float*>(params[4]);
  p.w2 = static_cast<const float*>(params[5]);
  p.b2 = static_cast<const float*>(params[6]);
  p.ext = static_cast<const float*>(params[7]);
  return p;
}

// A block's threads: 512 where a 256-thread block would give the backward's
// table-gradient owners more than one column each (the fine grid: its
// latency-bound phases want the warps), else 256 (the proposal grid: its
// small tiles want fewer idle threads a barrier).
inline int threads_for(const Dims& dm) { return 3 * dm.F() > 256 ? 512 : 256; }

__device__ __forceinline__ int nthreads() { return blockDim.x; }
__device__ __forceinline__ int nwarps() { return blockDim.x >> 5; }

// Host-side checks of what the kernels take: 0, or cudaErrorInvalidValue.
// (The wrappers also check that a block's shared memory fits.)
inline int check_dims(const Dims& dm) {
  if (dm.res < 2 || dm.nd < 1 || dm.na < 0 || dm.F() > MAX_F || dm.width < 1 ||
      dm.width > MAX_WIDTH || MAX_WIDTH % dm.width != 0)
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn(x);
  else return x;
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

// Shared memory carved from one buffer in 16-byte-aligned pieces (`base`
// null: offsets only, for the size).
struct Carver {
  char* base;
  size_t q = 0;
  __host__ __device__ explicit Carver(void* b) : base(static_cast<char*>(b)) {}
  template <class T>
  __host__ __device__ T* take(size_t n) {
    T* at = base == nullptr ? nullptr : reinterpret_cast<T*>(base + q);
    q += (n * sizeof(T) + 15) / 16 * 16;
    return at;
  }
};

// The buffers of a tile that both kernels use.
template <bool BF16>
struct TileBufs {
  using Act = typename Form<BF16>::Act;
  static constexpr int TILE = Form<BF16>::TILE;
  Act* w1s;    // W1 [kin][w1 stride], rounded with BF16, zero-padded
  float* w2s;  // W2 [wout][3], rounded with BF16, zero-padded
  Act* hin;    // [TILE][hin stride]
  float* hp;   // h_pre [TILE][hp stride]
  float* sig;  // sigma_pre [TILE]
  TileTaps tp;
  __host__ __device__ TileBufs(const Dims& dm, Carver& c, bool extras) {
    const Strides<BF16> s(dm);
    w1s = c.take<Act>((size_t)s.kin * s.w1);
    w2s = c.take<float>((size_t)s.wout * 3);
    hin = c.take<Act>((size_t)TILE * s.hin);
    hp = c.take<float>((size_t)TILE * s.hp);
    sig = c.take<float>(TILE);
    tp.i0 = c.take<int>(TILE * 3);
    tp.i1 = c.take<int>(TILE * 3);
    tp.w0 = c.take<float>(TILE * 3);
    tp.w1 = c.take<float>(TILE * 3);
    tp.m0 = extras ? c.take<float>(TILE * 3) : nullptr;
    tp.m1 = extras ? c.take<float>(TILE * 3) : nullptr;
    tp.clip_grad = extras ? c.take<float>(TILE * 3) : nullptr;
  }
};

// Stage the decoder into shared memory, rounded with BF16 and zero-padded to
// the form's strides. Ends with a barrier.
template <bool BF16>
__device__ __forceinline__ void stage_decoder(const GridParams& p, const Dims& dm,
                                              const TileBufs<BF16>& L) {
  using Act = typename Form<BF16>::Act;
  const Strides<BF16> s(dm);
  const int W = dm.width, K = dm.K();
  for (int idx = threadIdx.x; idx < s.kin * s.w1; idx += nthreads()) {
    const int k = idx / s.w1, j = idx % s.w1;
    L.w1s[idx] = from_f<Act>(k < K && j < W ? rnd<BF16>(__ldg(p.w1 + k * W + j)) : 0.f);
  }
  for (int idx = threadIdx.x; idx < s.wout * 3; idx += nthreads())
    L.w2s[idx] = idx < W * 3 ? rnd<BF16>(__ldg(p.w2 + idx)) : 0.f;
  __syncthreads();
}

// The tables as a tile reads them: the packed bf16 copy, or float32.
template <bool BF16>
struct Tables {
  const float* f32[3];
  const bf16* b16[3];
  bool pairs;  // two columns a load: F even, and float32 tables 8-byte aligned
  __device__ Tables(const GridParams& p, const Dims& dm) : pairs(dm.F() % 2 == 0) {
    for (int a = 0; a < 3; ++a) {
      f32[a] = p.table[a];
      b16[a] = BF16 ? p.tab16 + (size_t)a * dm.res * dm.F() : nullptr;
      if (!BF16 && reinterpret_cast<size_t>(f32[a]) % 8 != 0) pairs = false;
    }
  }
  __device__ __forceinline__ float at(int a, size_t i) const {
    if constexpr (BF16) return __bfloat162float(__ldg(b16[a] + i));
    else return __ldg(f32[a] + i);
  }
  // Columns i and i + 1 in one load (i even, with pairs).
  __device__ __forceinline__ float2 at2(int a, size_t i) const {
    if constexpr (BF16)
      return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(b16[a] + i)));
    else return __ldg(reinterpret_cast<const float2*>(f32[a] + i));
  }
};

// body(f, v0, v1) for each column f of a table row pair that lane `lane`
// takes: v0[a], v1[a] = T_a[i0[a]][f], T_a[i1[a]][f], rounded with BF16.
// With tabs.pairs a lane takes two neighbouring columns a load, and the
// loads of two such steps go out together.
template <bool BF16, class Body>
__device__ __forceinline__ void for_columns(const Tables<BF16>& tabs, int F, const int (&i0)[3],
                                            const int (&i1)[3], int lane, Body body) {
  if (tabs.pairs) {
    for (int f = 2 * lane; f < F; f += 128) {
      const bool two = f + 64 < F;
      float2 v0[2][3], v1[2][3];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int g = u == 0 ? f : (two ? f + 64 : f);
          v0[u][a] = tabs.at2(a, (size_t)i0[a] * F + g);
          v1[u][a] = tabs.at2(a, (size_t)i1[a] * F + g);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
        float x0[3], x1[3], y0[3], y1[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          x0[a] = rnd<BF16>(v0[u][a].x);
          x1[a] = rnd<BF16>(v1[u][a].x);
          y0[a] = rnd<BF16>(v0[u][a].y);
          y1[a] = rnd<BF16>(v1[u][a].y);
        }
        body(f + 64 * u, x0, x1);
        body(f + 64 * u + 1, y0, y1);
      }
    }
  } else {
    for (int f = lane; f < F; f += 32) {
      float x0[3], x1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        x0[a] = rnd<BF16>(tabs.at(a, (size_t)i0[a] * F + f));
        x1[a] = rnd<BF16>(tabs.at(a, (size_t)i1[a] * F + f));
      }
      body(f, x0, x1);
    }
  }
}

// Rows base .. base+TILE-1 (rows at or past row_end are zero): the taps,
// the rounded direction encoding into hin[r][0:24], the appearance products
// into hin[r][24:24+Fa] (zeros after, to the padded width), sigma_pre into
// sig[r] and, with feats, each line feature at feats[(a * TILE + r) * F +
// f]. One warp a row for the features: its lanes read consecutive columns
// of the six table rows, and sum the density products. Ends with a barrier.
template <bool BF16, bool EXTRAS>
__device__ __forceinline__ void load_tile(const Rays& rays, const Tables<BF16>& tabs,
                                          const Dims& dm, float ext, long long base,
                                          long long row_end, const TileBufs<BF16>& L,
                                          typename Form<BF16>::Act* feats) {
  using Act = typename Form<BF16>::Act;
  constexpr int TILE = Form<BF16>::TILE;
  const Strides<BF16> s(dm);
  const int F = dm.F(), nd = dm.nd, K = dm.K();
  for (int idx = threadIdx.x; idx < TILE * 3; idx += nthreads()) {
    const int r = idx / 3, a = idx % 3;
    const long long m = base + r;
    Tap t{0, 0, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < row_end) {
      const long long ray = m / rays.n_samples;
      const float pt = __fadd_rn(__ldg(rays.origins + 3 * ray + a),
                                 __fmul_rn(__ldg(rays.ts + m), __ldg(rays.dirs + 3 * ray + a)));
      t = make_tap(pt, ext, dm.res);
    }
    L.tp.i0[idx] = t.i0;
    L.tp.i1[idx] = t.i1;
    L.tp.w0[idx] = rnd<BF16>(t.w0);
    L.tp.w1[idx] = rnd<BF16>(t.w1);
    if constexpr (EXTRAS) {
      L.tp.m0[idx] = t.m0;
      L.tp.m1[idx] = t.m1;
      L.tp.clip_grad[idx] = t.clip_grad;
    }
  }
  const int pad = s.kin - K;  // zero columns after the appearance products
  for (int idx = threadIdx.x; idx < TILE * (DIR_ENC + pad); idx += nthreads()) {
    const int r = idx / (DIR_ENC + pad), k = idx % (DIR_ENC + pad);
    const long long m = base + r;
    if (k < DIR_ENC)
      L.hin[r * s.hin + k] = from_f<Act>(
          m < row_end ? rnd<BF16>(__ldg(rays.de + (m / rays.n_samples) * DIR_ENC + k)) : 0.f);
    else
      L.hin[r * s.hin + K + k - DIR_ENC] = from_f<Act>(0.f);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TILE; r += nwarps()) {
    int i0[3], i1[3];
    float w0[3], w1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      i0[a] = L.tp.i0[r * 3 + a];
      i1[a] = L.tp.i1[r * 3 + a];
      w0[a] = L.tp.w0[r * 3 + a];
      w1[a] = L.tp.w1[r * 3 + a];
    }
    float sig = 0.f;
    for_columns<BF16>(tabs, F, i0, i1, lane, [&](int f, const float (&v0)[3],
                                                 const float (&v1)[3]) {
      float fa[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        fa[a] = rnd<BF16>(__fadd_rn(__fmul_rn(w0[a], v0[a]), __fmul_rn(w1[a], v1[a])));
        if constexpr (EXTRAS) feats[(a * TILE + r) * F + f] = from_f<Act>(fa[a]);
      }
      const float pr = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(fa[0], fa[1])), fa[2]));
      if (f < nd) sig += pr;
      else L.hin[r * s.hin + DIR_ENC + f - nd] = from_f<Act>(pr);
    });
    sig = warp_sum(sig);
    if (lane == 0) L.sig[r] = sig;
  }
  __syncthreads();
}

// acc (n8 tiles n0 .. n0+7 and n0+8 .. n0+15 of the m16 rows m0 .. m0+15)
// += A B over k = 0 .. 16 nk, bf16 operands in shared memory:
// - A_T false: A[m][k] at a[m * lda + k]; true: at a[k * lda + m];
// - B_T true: B[k][n] at b[k * ldb + n]; false: at b[n * ldb + k].
// Each k16 step is summed on the tensor cores from zero, then added in
// float32. Row addresses must be 16-byte aligned (strides multiples of 8).
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_unit(float (&acc)[2][4], const bf16* a, int lda, int m0,
                                         const bf16* b, int ldb, int n0, int nk) {
  const int lane = threadIdx.x & 31;
  for (int ks = 0; ks < nk; ++ks) {
    const int k0 = 16 * ks;
    uint32_t af[4], bf[4];
    if constexpr (A_T)
      ldsm_x4_trans(af, a + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * lda + m0 +
                            ((lane >> 3) & 1) * 8);
    else
      ldsm_x4(af, a + (m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
    if constexpr (B_T)
      ldsm_x4_trans(bf, b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n0 +
                            (lane >> 4) * 8);
    else
      ldsm_x4(bf, b + (n0 + (lane & 7) + (lane >> 4) * 8) * ldb + k0 + ((lane >> 3) & 1) * 8);
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(t0, af, bf[0], bf[1]);
    mma_bf16(t1, af, bf[2], bf[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[0][q] += t0[q];
      acc[1][q] += t1[q];
    }
  }
}

// The accumulator element (h, q) of mma_unit sits at row m0 + unit_row(q),
// column n0 + unit_col(h, q).
__device__ __forceinline__ int unit_row(int q) {
  return ((threadIdx.x & 31) >> 2) + 8 * (q >> 1);
}
__device__ __forceinline__ int unit_col(int h, int q) {
  return 8 * h + 2 * (threadIdx.x & 3) + (q & 1);
}

// hp[r][j] = hin[r] . W1[:, j] + b1[j] for the tile's rows (j < the form's
// width; padded columns get 0). bf16: mma units of 16 rows x 16 columns,
// warp w taking units w, w + warps, ...; fp32: float32 FMAs in k order, thread
// t taking column t % W and rows t / W + (threads / W) q. Ends with a
// barrier.
template <bool BF16>
__device__ __forceinline__ void hidden_layer(const GridParams& p, const Dims& dm,
                                             const TileBufs<BF16>& L) {
  constexpr int TILE = Form<BF16>::TILE;
  const Strides<BF16> s(dm);
  const int W = dm.width;
  if constexpr (BF16) {
    const int warp = threadIdx.x >> 5, mt = TILE / 16, units = mt * (s.wout / 16);
    for (int u = warp; u < units; u += nwarps()) {
      const int m0 = (u % mt) * 16, n0 = (u / mt) * 16;
      float acc[2][4] = {};
      mma_unit<false, true>(acc, L.hin, s.hin, m0, L.w1s, s.w1, n0, s.kin / 16);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = n0 + unit_col(h, q);
          L.hp[(m0 + unit_row(q)) * s.hp + j] = acc[h][q] + (j < W ? __ldg(p.b1 + j) : 0.f);
        }
    }
  } else {
    const int K = dm.K(), S = nthreads() / W;
    const int j = threadIdx.x % W;
    const float bj = __ldg(p.b1 + j);
    for (int r0 = threadIdx.x / W; r0 < TILE; r0 += S * RQ) {
      int off[RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q) off[q] = min(r0 + S * q, TILE - 1) * s.hin;
      float acc[RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q) acc[q] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float w = L.w1s[k * s.w1 + j];
#pragma unroll
        for (int q = 0; q < RQ; ++q) acc[q] = fmaf(L.hin[off[q] + k], w, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < RQ; ++q)
        if (r0 + S * q < TILE) L.hp[(r0 + S * q) * s.hp + j] = acc[q] + bj;
    }
  }
  __syncthreads();
}

// The color of row r, one warp: sigmoid(rnd(relu(hp[r])) . W2[:, c] + b2[c]).
template <bool BF16>
__device__ __forceinline__ void row_color(const GridParams& p, const Dims& dm,
                                          const TileBufs<BF16>& L, int r, float (&col)[3]) {
  const Strides<BF16> s(dm);
  const int lane = threadIdx.x & 31, W = dm.width;
  float v[3] = {0.f, 0.f, 0.f};
  for (int j = lane; j < W; j += 32) {
    const float h = rnd<BF16>(fmaxf(L.hp[r * s.hp + j], 0.f));
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = fmaf(h, L.w2s[j * 3 + c], v[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sum = warp_sum(v[c]) + __ldg(p.b2 + c);
    col[c] = 1.f / (1.f + expf(-sum));
  }
}

// out[a * n + i] = bf16(table_a[i]), round to nearest even: the bf16 forms'
// tables, packed once a call.
__global__ void pack_tables_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
                                   const float* __restrict__ t2, bf16* __restrict__ out,
                                   long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < 3 * n;
       i += (long long)gridDim.x * blockDim.x) {
    const float* t = i < n ? t0 : (i < 2 * n ? t1 : t2);
    out[i] = __float2bfloat16_rn(__ldg(t + i % n));
  }
}

inline int pack_tables(const void* const* params, const Dims& dm, bf16* out,
                       cudaStream_t st) {
  const long long n = (long long)dm.res * dm.F();
  const int blocks = (int)std::min<long long>((3 * n + 255) / 256, 528);
  pack_tables_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(params[0]), static_cast<const float*>(params[1]),
      static_cast<const float*>(params[2]), out, n);
  return (int)cudaGetLastError();
}

// bf16 elements of the packed tables, rounded up to whole 16-byte chunks.
inline long long packed_table_elems(const Dims& dm) {
  return (3LL * dm.res * dm.F() + 7) / 8 * 8;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Phase clocks of the backward, only in a variant build (-DGRID_PHASE_CLOCKS,
// a separate library that a measurement loads; the main path's library has
// none of it): at each mark the block meets at a barrier and its thread 0
// adds the clock64() cycles since the last mark to phase_clocks[block][i].
#ifdef GRID_PHASE_CLOCKS
constexpr int N_PHASES = 6;
constexpr int MAX_PHASE_BLOCKS = 1024;
__device__ long long phase_clocks[MAX_PHASE_BLOCKS * N_PHASES];
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
struct PhaseClock {
  long long t;
  __device__ PhaseClock() : t(clock_now()) {}
  __device__ void mark(int i) {
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < MAX_PHASE_BLOCKS) {
      const long long now = clock_now();
      phase_clocks[blockIdx.x * N_PHASES + i] += now - t;
      t = now;
    }
  }
};
#else
struct PhaseClock {
  __device__ void mark(int) {}
};
#endif

}  // namespace
