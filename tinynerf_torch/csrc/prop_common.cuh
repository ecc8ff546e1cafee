// Building blocks shared by the proposal MLP's kernels for Hopper (sm_90a):
// prop_rays_fwd.cu (the ray-major forward) and prop_rays_bwd.cu (its
// recompute backward). Both evaluate tinynerf's proposal field: a depth x
// width ReLU trunk over the float32 positional encoding of the point (60),
// sigma = |h . w_sigma + b| and color = sigmoid(enc_dir . w_ce + h . w_ch +
// b), where w_ce and w_ch are the first 24 and the last `width` rows of the
// color weight (the concat [dir_enc, h], direction first). The width is a
// template parameter, NC = width / 32 (1..8), so every thread works at every
// width.
//
// Two forms:
// - fp32: fma_common.cuh's float32 FMA tile (gemm_f32; the weights stream
//   through a double-buffered cp.async K-tile): a warp owns 8 rows and a
//   thread width / 32 columns, except in the forward up to width 128,
//   where 16 threads own 8 rows and a thread width / 16 columns (8 x 8 at
//   128: 64 FMAs a k for four 16-byte shared loads); the encoding is
//   float32 (encode_f32) and the heads are warp reductions (HeadWeights).
//   Shared memory is sized by the width: a row is max(width, 64) floats.
// - bf16: every trunk product (act W, the backward's g W^T and X^T G) is
//   bf16 x bf16 with float32 accumulation on mma.sync.m16n8k16
//   (mma_common.cuh), as the TPU kernel's jnp.dot with
//   preferred_element_type=float32. An M-row tile has 4M threads: warp w
//   owns rows 32 (w % (M/32)) .. +31 and columns (OUT/4) (w / (M/32)) .. of a
//   product OUT wide, NT = OUT / 32 n8-tiles, so 2 x NT m16n8 accumulators a
//   thread. Activations and the zero-padded point encoding live in shared
//   memory as bf16, each row padded by 8 elements so that ldmatrix's eight
//   row addresses fall in distinct banks. The weights, packed into bf16 once
//   a call (pack_prop), stream from L2 through a double-buffered shared
//   K-tile with cp.async: the forward product reads PWK rows of W a tile
//   (ldmatrix.trans gives the col-major B fragments), g W^T reads PWK
//   columns of W a tile (W's rows are then B^T, read without .trans, so no
//   transposed copy of W is streamed). Each K-tile's two k16 steps are
//   summed on the tensor cores from zero and added in float32
//   (mma_bf16_k32). The heads (width -> 1, 24 + width -> 3), the encoding
//   (float32 sinf/cosf, __fmul_rn) and every bias add stay float32, and the
//   rounding points are the fp32 form's: weights, encodings and
//   activations are bf16 values, biases are added after the sum.

#pragma once

#include <atomic>
#include <type_traits>

#include "fma_common.cuh"

namespace {

constexpr int MAX_DEPTH = 64;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can use (sm_90)
// Ray slices of the backward's weight-gradient partials: an H100 SXM's 132
// SMs x 2. A constant, so that the slices, and with them the weight
// gradients' last bits, follow from the shapes alone, whatever card runs
// the call.
constexpr int PROP_SLOTS = 132 * 2;

struct PropParams {
  const float* w[MAX_DEPTH];  // trunk_i.w, (fan_in, width) row-major; fan_in 60 at i = 0
  const float* b[MAX_DEPTH];  // trunk_i.b, (width,)
  const float* w_sigma;       // (width, 1)
  const float* b_sigma;       // (1,)
  const float* w_color;       // (24 + width, 3): the direction's 24 rows first
  const float* b_color;       // (3,)
  const float* freqs;         // L_PT point frequencies, then L_DIR direction ones
  const bf16* wb;             // the bf16 form's packed weights (pack_prop), else null
  int depth;
};

// params: 2 * depth + 5 device pointers, layer by layer weight then bias
// (trunk_0 .. trunk_{depth-1}, sigma, color), then the 14 frequencies.
inline PropParams unpack_prop(const void* const* params, int depth) {
  PropParams p;
  auto at = [&](int i) { return static_cast<const float*>(params[i]); };
  for (int i = 0; i < depth; ++i) {
    p.w[i] = at(2 * i);
    p.b[i] = at(2 * i + 1);
  }
  p.w_sigma = at(2 * depth);
  p.b_sigma = at(2 * depth + 1);
  p.w_color = at(2 * depth + 2);
  p.b_color = at(2 * depth + 3);
  p.freqs = at(2 * depth + 4);
  p.wb = nullptr;
  p.depth = depth;
  return p;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// ---------------------------------------------------------------- fp32 form

// The fp32 forms' row of activations, in floats: the width, at least 64 so
// that a row also holds the point encoding (60 columns and 4 zeros).
__host__ __device__ constexpr int f32_ld(int width) { return width < 64 ? 64 : width; }


// Encode rows base .. base+M-1 as encode_tile does (float32 sin/cos) with NT
// threads: the point's into pt (row stride ld; columns 60..63 zero, so that
// gemm_f32 may read a 64-column K-tile), and the direction's into dir (row
// stride DIR_ENC) unless it is null. Rows at or past row_end encode x = 0.
// Ends with a barrier.
template <int M, int NT>
__device__ __forceinline__ void encode_f32(RayCoord coord, const float* __restrict__ freqs,
                                           int base, int row_end, float* pt, int ld,
                                           float* dir) {
  const int per_row = dir != nullptr ? 3 * (L_PT + L_DIR) : 3 * L_PT;
  for (int idx = threadIdx.x; idx < M * per_row; idx += NT) {
    const int r = idx / per_row, rem = idx % per_row, m = base + r;
    const bool is_pt = rem < 3 * L_PT;
    const int L = is_pt ? L_PT : L_DIR;
    const int e = is_pt ? rem : rem - 3 * L_PT;
    const int c = e / L, l = e % L;
    const float x = m < row_end ? coord(m, c, is_pt) : 0.f;
    const float arg = __fmul_rn(x, freqs[is_pt ? l : L_PT + l]);
    float* out = is_pt ? pt + r * ld + c * 2 * L + 2 * l : dir + r * DIR_ENC + c * 2 * L + 2 * l;
    out[0] = sinf(arg);
    out[1] = cosf(arg);
  }
  for (int idx = threadIdx.x; idx < M * (64 - PT_ENC); idx += NT)
    pt[(idx / (64 - PT_ENC)) * ld + PT_ENC + idx % (64 - PT_ENC)] = 0.f;
  __syncthreads();
}

// act[row_i][col_j] = relu(acc + bias) (row stride ld) over the thread's
// rows and columns (gemm_f32's, groups of CW threads), a group of V columns
// a store; with `save`, also to save[row_i * CW NC + col_j] in L2 (rows
// below `valid`). Ends with a barrier.
template <int NC, int CW>
__device__ __forceinline__ void put_relu_f32(const float (&acc)[ROWS][NC],
                                             const float* __restrict__ bias, float* act, int ld,
                                             float* __restrict__ save, int valid) {
  constexpr int V = vec_of<NC>(), W = CW * NC;
  const int row0 = (threadIdx.x / CW) * ROWS;
#pragma unroll
  for (int g = 0; g < NC / V; ++g) {
    const int c = col_of<NC, CW>(g * V);
    float b[V];
#pragma unroll
    for (int v = 0; v < V; ++v) b[v] = __ldg(bias + c + v);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v) y[v] = fmaxf(acc[i][g * V + v] + b[v], 0.f);
      store_v<V>(act + (row0 + i) * ld + c, y);
      if (save != nullptr && row0 + i < valid) store_v<V>(save + (row0 + i) * W + c, y);
    }
  }
  __syncthreads();
}

// The head weights and biases a lane reads in heads, loaded once for many
// rows: w_sigma[k] and w_ch[k][c] of its columns k = lane + 32 q, and
// w_ce[lane][c] (0 past lane 23).
template <int NC>
struct HeadWeights {
  float s[NC], ch[NC][3], ce[3], b_sigma, b_color[3];
  __device__ explicit HeadWeights(const PropParams& p) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int k = lane + 32 * q;
      s[q] = __ldg(p.w_sigma + k);
#pragma unroll
      for (int c = 0; c < 3; ++c) ch[q][c] = __ldg(p.w_color + 3 * (DIR_ENC + k) + c);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ce[c] = lane < DIR_ENC ? __ldg(p.w_color + 3 * lane + c) : 0.f;
      b_color[c] = __ldg(p.b_color + c);
    }
    b_sigma = __ldg(p.b_sigma);
  }
};

// One row's heads, summed over a warp (every lane gets the sums): h is the
// row's last hidden layer, dir_enc its float32 direction encoding.
// sigma_pre = h . w_sigma + b_sigma; x[c] = enc_dir . w_ce[:, c] + h .
// w_ch[:, c] + b_color[c], the TPU kernel's order.
template <int NC>
__device__ __forceinline__ void heads(const HeadWeights<NC>& hw, const float* h,
                                      const float* dir_enc, float& sigma_pre, float (&x)[3]) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, vh[3] = {0.f, 0.f, 0.f}, vd[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const float hk = h[lane + 32 * q];
    s = fmaf(hk, hw.s[q], s);
#pragma unroll
    for (int c = 0; c < 3; ++c) vh[c] = fmaf(hk, hw.ch[q][c], vh[c]);
  }
  if (lane < DIR_ENC) {
    const float e = dir_enc[lane];
#pragma unroll
    for (int c = 0; c < 3; ++c) vd[c] = e * hw.ce[c];
  }
  sigma_pre = warp_sum(s) + hw.b_sigma;
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = warp_sum(vd[c]) + warp_sum(vh[c]) + hw.b_color[c];
}

// ---------------------------------------------------------------- bf16 form

constexpr int PT_PAD = 64;         // the point encoding: 60 columns + 4 zeros
constexpr int PT_LD = PT_PAD + 8;  // its row stride in shared memory (bf16)
constexpr int PWK = 32;            // weight rows (forward) or columns (g W^T) a K-tile
constexpr int FWD_M = 64;          // rows a tile of the forward (kernel 7)
constexpr int BWD_M = 128;         // rows a tile of the backward (kernel 8)

// ---- the packed bf16 weights: trunk_l, (K_l, width) row-major, K_0 = PT_PAD
// (rows 60..63 zero), K_l = width; then, for the backward's fix-up, each
// again transposed ((width, K_l) row-major, at pk_elems + its offset); then
// the float32 column norms of each (depth x width) ----
__host__ __device__ constexpr long long pk_offset(int layer, int width) {
  return layer == 0 ? 0 : (long long)PT_PAD * width + (long long)(layer - 1) * width * width;
}
__host__ __device__ constexpr long long pk_elems(int width, int depth) {
  return pk_offset(depth, width);
}
// bf16 elements of the packing with the fix-up's copy and norms
__host__ __device__ constexpr long long pk_fixup_elems(int width, int depth) {
  return 2 * pk_elems(width, depth) + 2LL * depth * width;
}

// out[pk_offset(l) + r * width + c] = bf16(trunk_l.w[r][c]) (round to
// nearest even; 0 for the padding rows of layer 0) and, with `transposed`,
// also out[pk_elems + pk_offset(l) + c * K_l + r]. Layer l = blockIdx.y.
__global__ void pack_prop_kernel(PropParams p, int width, bf16* __restrict__ out,
                                 int transposed) {
  const int layer = blockIdx.y;
  const int k_real = layer == 0 ? PT_ENC : width, k_pad = layer == 0 ? PT_PAD : width;
  const long long at = pk_offset(layer, width), tr = pk_elems(width, p.depth) + at;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k_pad * width;
       i += gridDim.x * blockDim.x) {
    const int r = i / width, c = i % width;
    const bf16 v = __float2bfloat16_rn(r < k_real ? __ldg(p.w[layer] + i) : 0.f);
    out[at + i] = v;
    if (transposed) out[tr + (long long)c * k_pad + r] = v;
  }
}

// norms[l * width + c] = |column c of the packed trunk_l.w|, float32, one
// thread a column.
__global__ void wnorm_prop_kernel(PropParams p, int width, float* __restrict__ norms) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.depth * width) return;
  const int layer = i / width, c = i % width;
  const int k_real = layer == 0 ? PT_ENC : width;
  float s = 0.f;
  for (int r = 0; r < k_real; ++r) {
    const float w = rnd<true>(__ldg(p.w[layer] + (size_t)r * width + c));
    s = fmaf(w, w, s);
  }
  norms[i] = sqrtf(s);
}

// Pack p's trunk weights into `out` (16-byte aligned) on `st`: pk_elems bf16;
// with `fixup`, pk_fixup_elems: also the transposed copy and the column
// norms. Returns the first launch error, or 0.
inline int pack_prop(const PropParams& p, int width, bf16* out, cudaStream_t st, bool fixup) {
  pack_prop_kernel<<<dim3(16, p.depth), 256, 0, st>>>(p, width, out, fixup);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !fixup) return (int)err;
  wnorm_prop_kernel<<<(p.depth * width + 255) / 256, 256, 0, st>>>(
      p, width, reinterpret_cast<float*>(out + 2 * pk_elems(width, p.depth)));
  return (int)cudaGetLastError();
}

// The head weights rounded to bf16, into shared memory (no barrier): hw[k *
// 4 + o] = w_sigma[k] (o = 0) or w_ch[k][o - 1]; wce[e * 3 + c] = w_ce[e][c].
template <int NC>
__device__ __forceinline__ void load_head_weights(const PropParams& p, float* hw, float* wce) {
  for (int i = threadIdx.x; i < 32 * NC * 4; i += blockDim.x) {
    const int k = i >> 2, o = i & 3;
    hw[i] = rnd<true>(__ldg(o == 0 ? p.w_sigma + k : p.w_color + 3 * (DIR_ENC + k) + o - 1));
  }
  for (int i = threadIdx.x; i < 3 * DIR_ENC; i += blockDim.x)
    wce[i] = rnd<true>(__ldg(p.w_color + i));
}

// Encode rows base .. base+M-1 as encode_tile does (float32 sin/cos), each
// value rounded to bf16, into enc_pt (row stride PT_LD, its pad columns
// zero) and enc_dir (row stride DIR_ENC). Rows at or past row_end encode x =
// 0. 4M threads; ends with a barrier.
template <int M>
__device__ __forceinline__ void encode_prop_tc(RayCoord coord, const float* __restrict__ freqs,
                                               int base, int row_end, bf16* enc_pt,
                                               bf16* enc_dir) {
  for (int idx = threadIdx.x; idx < M * 3 * (L_PT + L_DIR); idx += 4 * M) {
    const int r = idx / (3 * (L_PT + L_DIR));
    const int rem = idx % (3 * (L_PT + L_DIR));
    const int m = base + r;
    const bool is_pt = rem < 3 * L_PT;
    const int L = is_pt ? L_PT : L_DIR;
    const int e = is_pt ? rem : rem - 3 * L_PT;
    const int c = e / L, l = e % L;
    const float x = m < row_end ? coord(m, c, is_pt) : 0.f;
    const float arg = __fmul_rn(x, freqs[is_pt ? l : L_PT + l]);
    bf16* out = is_pt ? enc_pt + r * PT_LD + c * 2 * L + 2 * l
                      : enc_dir + r * DIR_ENC + c * 2 * L + 2 * l;
    out[0] = __float2bfloat16_rn(sinf(arg));
    out[1] = __float2bfloat16_rn(cosf(arg));
  }
  for (int idx = threadIdx.x; idx < M * (PT_PAD - PT_ENC); idx += 4 * M)
    enc_pt[(idx / 4) * PT_LD + PT_ENC + idx % 4] = __float2bfloat16_rn(0.f);
  __syncthreads();
}

// This thread's accumulator (mi, j, q) of an M-row tile sits at row
// tc_row<M>(mi, q), column tc_col<M, NT>(j, q) of the product.
template <int M>
__device__ __forceinline__ int tc_row(int mi, int q) {
  return ((threadIdx.x >> 5) % (M / 32)) * 32 + mi * 16 + ((threadIdx.x & 31) >> 2) + 8 * (q >> 1);
}

template <int M, int NT>
__device__ __forceinline__ int tc_col(int j, int q) {
  return ((threadIdx.x >> 5) / (M / 32)) * 8 * NT + j * 8 + 2 * (threadIdx.x & 3) + (q & 1);
}

template <int NT>
__device__ __forceinline__ void zero_tc(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;
}

// Copy K-tile t of the weights w (row stride ldw) into wbuf as one cp.async
// group, with 4M threads: FWD, rows t*PWK .. +PWK (32 NT wide; shared row
// stride 32 NT + 8); else, columns t*PWK .. +PWK of its 32 NT rows (shared
// row stride PWK + 8).
template <int M, int NT, bool FWD>
__device__ __forceinline__ void load_wtile(bf16* wbuf, const bf16* __restrict__ w, int ldw,
                                           int t) {
  constexpr int OUT = 32 * NT;
  if constexpr (FWD) {
    constexpr int CH = OUT / 8;  // 16-byte chunks a row
    const bf16* src = w + (size_t)t * PWK * ldw;
    for (int i = threadIdx.x; i < PWK * CH; i += 4 * M)
      cp_async16(wbuf + (i / CH) * (OUT + 8) + (i % CH) * 8,
                 src + (size_t)(i / CH) * ldw + (i % CH) * 8);
  } else {
    constexpr int CH = PWK / 8;
    for (int i = threadIdx.x; i < OUT * CH; i += 4 * M)
      cp_async16(wbuf + (i / CH) * (PWK + 8) + (i % CH) * 8,
                 w + (size_t)(i / CH) * ldw + t * PWK + (i % CH) * 8);
  }
  cp_async_commit();
}

// acc += a[:, k0 .. k0+PWK] B_tile, the tile in wt (see load_wtile): its two
// k16 steps summed on the tensor cores, then added in float32. NT may be
// odd: the last n8-tile's B fragments then come from an x2 ldmatrix.
template <int M, int NT, bool FWD>
__device__ __forceinline__ void mma_wtile(float (&acc)[2][NT][4], const bf16* a, int lda,
                                          int k0, const bf16* wt) {
  constexpr int OUT = 32 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp % (M / 32)) * 32, n0 = (warp / (M / 32)) * 8 * NT;
  uint32_t af[2][2][4];  // [k16 step][mi]
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(af[s][mi], a + (m0 + mi * 16 + (lane & 15)) * lda + k0 + 16 * s + (lane >> 4) * 8);
#pragma unroll
  for (int nj = 0; nj < NT / 2; ++nj) {
    uint32_t b[2][4];  // [k16 step]: n8-tiles 2 nj and 2 nj + 1
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if constexpr (FWD)
        ldsm_x4_trans(b[s], wt + (16 * s + (lane & 7) + ((lane >> 3) & 1) * 8) * (OUT + 8) + n0 +
                                nj * 16 + (lane >> 4) * 8);
      else
        ldsm_x4(b[s], wt + (n0 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * (PWK + 8) + 16 * s +
                          ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_bf16_k32(acc[mi][2 * nj], af[0][mi], b[0][0], b[0][1], af[1][mi], b[1][0], b[1][1]);
      mma_bf16_k32(acc[mi][2 * nj + 1], af[0][mi], b[0][2], b[0][3], af[1][mi], b[1][2],
                   b[1][3]);
    }
  }
  if constexpr (NT % 2 == 1) {
    constexpr int j = NT - 1;
    uint32_t b[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if constexpr (FWD)
        ldsm_x2_trans(b[s], wt + (16 * s + (lane & 7) + ((lane >> 3) & 1) * 8) * (OUT + 8) + n0 +
                                j * 8);
      else
        ldsm_x2(b[s], wt + (n0 + j * 8 + (lane & 7)) * (PWK + 8) + 16 * s + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      mma_bf16_k32(acc[mi][j], af[0][mi], b[0][0], b[0][1], af[1][mi], b[1][0], b[1][1]);
  }
}

// acc[M x 32 NT] += a[M x K] B over K (a multiple of PWK), a in shared memory
// (row stride lda). FWD: B = w, (K x 32 NT) with row stride ldw; else B =
// w^T, w (32 NT x K) with row stride ldw. wbuf holds two K-tiles: each step
// waits for its tile, then starts the copy of the next one into the other
// buffer, which every thread is done with once past the step's barrier.
// Ends with a barrier, so the caller may overwrite a.
template <int M, int NT, bool FWD>
__device__ __forceinline__ void gemm_tc(float (&acc)[2][NT][4], const bf16* a, int lda, int K,
                                        const bf16* __restrict__ w, int ldw, bf16* wbuf) {
  constexpr int STAGE = FWD ? PWK * (32 * NT + 8) : 32 * NT * (PWK + 8);
  const int n = K / PWK;
  load_wtile<M, NT, FWD>(wbuf, w, ldw, 0);
  for (int t = 0; t < n; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in, for every thread, and tile t - 1 is done with
    if (t + 1 < n) load_wtile<M, NT, FWD>(wbuf + ((t + 1) & 1) * STAGE, w, ldw, t + 1);
    mma_wtile<M, NT, FWD>(acc, a, lda, t * PWK, wbuf + (t & 1) * STAGE);
  }
  __syncthreads();  // every thread is done with the tiles and with a
}

// act[r][c] = bf16(relu(acc + bias)) (row stride ld), then a barrier.
template <int M, int NT>
__device__ __forceinline__ void store_relu_tc(const float (&acc)[2][NT][4],
                                              const float* __restrict__ bias, bf16* act,
                                              int ld) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = tc_col<M, NT>(j, 0);
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(act + tc_row<M>(mi, 2 * h) * ld + c) =
            pack_bf16x2(fmaxf(acc[mi][j][2 * h] + b0, 0.f), fmaxf(acc[mi][j][2 * h + 1] + b1, 0.f));
  }
  __syncthreads();
}

// The trunk's layer l on the tensor cores: acc = x W_l (x: K_l columns in
// shared memory, row stride ldx). Ends with a barrier.
template <int M, int NC>
__device__ __forceinline__ void layer_product(float (&acc)[2][NC][4], const PropParams& p,
                                              int layer, const bf16* x, int ldx, bf16* wt) {
  constexpr int W = 32 * NC;
  zero_tc(acc);
  gemm_tc<M, NC, true>(acc, x, ldx, layer == 0 ? PT_PAD : W, p.wb + pk_offset(layer, W), W, wt);
}

// Row r = threadIdx.x / 4's pre-activation o = threadIdx.x % 4 of the
// heads: o = 0 sigma's, h . w_sigma + b_sigma; o = 1..3 color channel o -
// 1's, enc_dir . w_ce + h . w_ch + b_color (the TPU kernel's order). h: the
// last hidden layer (bf16, row stride ld); enc_dir: bf16, row stride
// DIR_ENC; hw, wce: load_head_weights'.
template <int NC>
__device__ __forceinline__ float head_pre(const PropParams& p, const bf16* h, int ld,
                                          const bf16* enc_dir, const float* hw,
                                          const float* wce) {
  const int r = threadIdx.x >> 2, o = threadIdx.x & 3;
  float v = 0.f;
#pragma unroll
  for (int k8 = 0; k8 < 4 * NC; ++k8) {
    const uint4 hv = *reinterpret_cast<const uint4*>(h + r * ld + 8 * k8);
    const uint32_t hw2[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v = fmaf(__uint_as_float(hw2[q] << 16), hw[(8 * k8 + 2 * q) * 4 + o], v);
      v = fmaf(__uint_as_float(hw2[q] & 0xffff0000u), hw[(8 * k8 + 2 * q + 1) * 4 + o], v);
    }
  }
  if (o == 0) return v + __ldg(p.b_sigma);
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < DIR_ENC; ++e)
    d = fmaf(__bfloat162float(enc_dir[r * DIR_ENC + e]), wce[3 * e + o - 1], d);
  return d + v + __ldg(p.b_color + o - 1);
}

// Dispatch a kernel template over the width (NC = width / 32):
// launch(integral_constant<NC>).
template <class Launch>
int dispatch(int width, Launch launch) {
  switch (width) {
    case 32: return launch(std::integral_constant<int, 1>{});
    case 64: return launch(std::integral_constant<int, 2>{});
    case 96: return launch(std::integral_constant<int, 3>{});
    case 128: return launch(std::integral_constant<int, 4>{});
    case 160: return launch(std::integral_constant<int, 5>{});
    case 192: return launch(std::integral_constant<int, 6>{});
    case 224: return launch(std::integral_constant<int, 7>{});
    case 256: return launch(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

inline bool dims_ok(int width, int depth) {
  return width % 32 == 0 && width >= 32 && width <= 256 && depth >= 1 && depth <= MAX_DEPTH;
}

// Allow `kernel` MAX_SMEM bytes of dynamic shared memory on the current
// device, once a device: `ready` is a static of the caller's, one per
// kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, std::atomic<bool>* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && ready[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) ready[dev].store(true);
  return err;
}

}  // namespace
