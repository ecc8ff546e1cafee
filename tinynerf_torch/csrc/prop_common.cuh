// Building blocks shared by the proposal MLP's kernels for Hopper (sm_90a):
// prop_rays_fwd.cu (the ray-major forward) and prop_rays_bwd.cu (its
// recompute backward). Both evaluate tinynerf's proposal field: a depth x
// width ReLU trunk over the float32 positional encoding of the point (60),
// sigma = |h . w_sigma + b| and color = sigmoid(enc_dir . w_ce + h . w_ch +
// b), where w_ce and w_ch are the first 24 and the last `width` rows of the
// color weight (the concat [dir_enc, h], direction first).
//
// They reuse field_common.cuh: the encoding (encode_tile), the streamed
// K-tile GEMM (gemm_segment), the bf16 rounding (rnd) and the 64-row tile
// with its thread layout (warp w owns rows 8w .. 8w+7, a thread the columns
// lane + 32 j, j < NC). The width is a template parameter, NC = width / 32
// (1..8), so every thread works at every width.

#pragma once

#include <type_traits>

#include "field_common.cuh"

namespace {

constexpr int MAX_DEPTH = 64;

struct PropParams {
  const float* w[MAX_DEPTH];  // trunk_i.w, (fan_in, width) row-major; fan_in 60 at i = 0
  const float* b[MAX_DEPTH];  // trunk_i.b, (width,)
  const float* w_sigma;       // (width, 1)
  const float* b_sigma;       // (1,)
  const float* w_color;       // (24 + width, 3): the direction's 24 rows first
  const float* b_color;       // (3,)
  const float* freqs;         // L_PT point frequencies, then L_DIR direction ones
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
  p.depth = depth;
  return p;
}

// act[row_i * stride + col_j] = rnd(relu(acc + bias)), also written to
// save[row_i * 32 NC + col_j] when save is given; then a barrier.
template <int NC, bool BF16>
__device__ __forceinline__ void store_relu(float (&acc)[ROWS][NC],
                                           const float* __restrict__ bias, float* act,
                                           int stride, float* __restrict__ save) {
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    const float bj = __ldg(bias + c);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float y = rnd<BF16>(fmaxf(acc[i][j] + bj, 0.f));
      act[(row0 + i) * stride + c] = y;
      if (save != nullptr) save[(row0 + i) * 32 * NC + c] = y;
    }
  }
  __syncthreads();
}

// The trunk over a tile whose point encodings are in enc_pt: h_depth-1 ends
// in act (row stride `stride`); with `save`, h_i for i < depth - 1 is also
// written to save + i * TILE_M * width (the backward's layer inputs).
template <int NC, bool BF16>
__device__ __forceinline__ void trunk_fwd(const PropParams& p, float (*enc_pt)[PT_ENC],
                                          float* act, int stride, float* wt,
                                          float* __restrict__ save) {
  constexpr int W = 32 * NC;
  float acc[ROWS][NC];
  zero(acc);
  gemm_segment<NC, BF16, true>(acc, &enc_pt[0][0], PT_ENC, PT_ENC, p.w[0], wt);
  store_relu<NC, BF16>(acc, p.b[0], act, stride,
                       save != nullptr && p.depth > 1 ? save : nullptr);
  for (int layer = 1; layer < p.depth; ++layer) {
    zero(acc);
    gemm_segment<NC, BF16>(acc, act, stride, W, p.w[layer], wt);
    store_relu<NC, BF16>(acc, p.b[layer], act, stride,
                         save != nullptr && layer < p.depth - 1
                             ? save + (size_t)layer * TILE_M * W : nullptr);
  }
}

// One row's heads, summed over a warp (every lane gets the sums): h is the
// row's last hidden layer (rounded with BF16 already), dir_enc its float32
// direction encoding. sigma_pre = h . w_sigma + b_sigma; x[c] = enc_dir .
// w_ce[:, c] + h . w_ch[:, c] + b_color[c], the TPU kernel's order.
template <int NC, bool BF16>
__device__ __forceinline__ void heads(const PropParams& p, const float* h,
                                      const float* dir_enc, float& sigma_pre, float (&x)[3]) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, vh[3] = {0.f, 0.f, 0.f}, vd[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int k = lane + 32 * q;
    const float hk = h[k];
    s = fmaf(hk, rnd<BF16>(__ldg(p.w_sigma + k)), s);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      vh[c] = fmaf(hk, rnd<BF16>(__ldg(p.w_color + 3 * (DIR_ENC + k) + c)), vh[c]);
  }
  if (lane < DIR_ENC) {
    const float e = rnd<BF16>(dir_enc[lane]);
#pragma unroll
    for (int c = 0; c < 3; ++c) vd[c] = e * rnd<BF16>(__ldg(p.w_color + 3 * lane + c));
  }
  sigma_pre = warp_sum(s) + __ldg(p.b_sigma);
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = warp_sum(vd[c]) + warp_sum(vh[c]) + __ldg(p.b_color + c);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Dispatch a kernel template over the width (NC = width / 32) and the
// precision: launch(integral_constant<NC>, integral_constant<BF16>).
template <class Launch>
int dispatch(int width, int bf16, Launch launch) {
  auto with_nc = [&](auto nc) {
    return bf16 ? launch(nc, std::true_type{}) : launch(nc, std::false_type{});
  };
  switch (width) {
    case 32: return with_nc(std::integral_constant<int, 1>{});
    case 64: return with_nc(std::integral_constant<int, 2>{});
    case 96: return with_nc(std::integral_constant<int, 3>{});
    case 128: return with_nc(std::integral_constant<int, 4>{});
    case 160: return with_nc(std::integral_constant<int, 5>{});
    case 192: return with_nc(std::integral_constant<int, 6>{});
    case 224: return with_nc(std::integral_constant<int, 7>{});
    case 256: return with_nc(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

inline bool dims_ok(int width, int depth) {
  return width % 32 == 0 && width >= 32 && width <= 256 && depth >= 1 && depth <= MAX_DEPTH;
}

}  // namespace
