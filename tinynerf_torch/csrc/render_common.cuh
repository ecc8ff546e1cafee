// Building blocks shared by the fused renderer's kernels for Hopper
// (sm_90a): render_fused_fwd.cu (its forward) and render_fused_bwd.cu (its
// recompute backward). Both evaluate the whole per-ray renderer of
// tinynerf_torch.kernels.render_kernel.render_fused_plain: the field at the
// coarse samples, the coarse weights and composite, the inverse-CDF
// resample, the field at the fine samples and the merged composite of the
// two sorted lists.
//
// A block owns `rpb` whole rays. Their per-sample state (t, sigma, r, g, b
// at every coarse and fine sample, the coarse weights and cdf) lives in
// shared memory after the field's FwdSmem, so device memory sees only the
// rays in and the colors out. The field passes run field_tc.cuh's
// field_tile on the block's rows (ray-major, coarse then fine: fp32 through
// field_common.cuh's encode_tile / network_fwd, bf16 on the tensor cores
// in the same shared memory); the tail between them runs one thread per
// ray (the sums, the merge) or one thread per fine sample (the resample).
//
// Numerics follow the plain PyTorch version: every product, sum and
// quotient of the tail is a rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn), so nvcc contracts nothing and the backward's recompute of
// the tail gives the forward's bits; exp is the accurate expf.

#pragma once

#include <algorithm>

#include "field_tc.cuh"

namespace {

constexpr float TAIL_DELTA = 1e-4f;   // the merged pass's last delta
constexpr float EPSILON = 1e-7f;      // the resampler's slope epsilon
constexpr size_t MAX_SMEM = 232448;   // 227 KB, a block's dynamic shared memory

// A block's per-ray state in shared memory, each array ray-major.
struct Tail {
  float *t_co, *sig_co, *col_co[3], *w_co, *cdf;   // (rpb, nc)
  float *t_fi, *sig_fi, *col_fi[3];                // (rpb, nf)
  float *near, *far;                               // (rpb)
  // the merge's backward only: the merged order (coarse sample n as n, fine
  // sample m as nc + m), weights and transmittances (rpb, nc + nf), and the
  // fine samples' t cotangents (rpb, nf)
  int* order;
  float *wm, *em, *gt;
};

inline int tail_floats(int rpb, int nc, int nf, bool merge) {
  return rpb * (7 * nc + 5 * nf + 2 + (merge ? 3 * (nc + nf) + nf : 0));
}

__device__ inline Tail carve_tail(float* f, int rpb, int nc, int nf, bool merge) {
  Tail t;
  const int c = rpb * nc, n = rpb * nf, k = rpb * (nc + nf);
  t.t_co = f; f += c;
  t.sig_co = f; f += c;
  for (int ch = 0; ch < 3; ++ch) { t.col_co[ch] = f; f += c; }
  t.w_co = f; f += c;
  t.cdf = f; f += c;
  t.t_fi = f; f += n;
  t.sig_fi = f; f += n;
  for (int ch = 0; ch < 3; ++ch) { t.col_fi[ch] = f; f += n; }
  t.near = f; f += rpb;
  t.far = f; f += rpb;
  t.order = nullptr;
  t.wm = t.em = t.gt = nullptr;
  if (merge) {
    t.order = reinterpret_cast<int*>(f); f += k;
    t.wm = f; f += k;
    t.em = f; f += k;
    t.gt = f;
  }
  return t;
}

inline size_t render_smem_bytes(int rpb, int nc, int nf, bool merge) {
  return sizeof(FwdSmem) + sizeof(float) * (size_t)tail_floats(rpb, nc, nf, merge);
}

// Rays per block: enough to fill a 64-row tile with coarse samples, fewer
// where their state would not fit in shared memory.
inline int rays_per_block(int nc, int nf, bool merge) {
  int rpb = std::max(1, TILE_M / nc);
  while (rpb > 1 && render_smem_bytes(rpb, nc, nf, merge) > MAX_SMEM) --rpb;
  return rpb;
}

// Channel c of row m's point o + t*d (or direction d), t from the block's
// shared array of `n_samples` a ray, the block's first ray being ray0.
struct TileCoord {
  const float* __restrict__ origins;
  const float* __restrict__ dirs;
  const float* ts;
  int n_samples, ray0;
  __device__ __forceinline__ float operator()(int m, int c, bool is_pt) const {
    const int ray = ray0 + m / n_samples;
    const float d = dirs[3 * ray + c];
    return is_pt ? __fadd_rn(origins[3 * ray + c], __fmul_rn(ts[m], d)) : d;
  }
};

// The field at the block's `rows` rows (64 at a time) into sig and col[3],
// in shared memory. Ends with a barrier.
template <bool BF16>
__device__ void field_pass(FwdSmem& s, const Params& p, TileCoord coord, int rows,
                           float* sig, float* const* col) {
  for (int base = 0; base < rows; base += TILE_M)
    field_tile<BF16>(s, p, coord, base, rows,
                     [&](int m, int ch, float v) { (ch == 3 ? sig : col[ch])[m] = v; });
  __syncthreads();
}

// One ray's coarse weights with the inclusive cumsum (Q5): sd = sigma * dc,
// w = exp(-cumsum(sd)) (1 - exp(-sd)); their cdf, the cumsum of w; with `e`
// also exp(-cumsum(sd)). One thread.
__device__ inline void coarse_weights(const float* sig, int nc, float dc, float* w,
                                      float* cdf, float* e = nullptr) {
  float a = 0.f, c = 0.f;
  for (int n = 0; n < nc; ++n) {
    const float sd = __fmul_rn(sig[n], dc);
    a = __fadd_rn(a, sd);
    const float en = expf(-a);
    const float wn = __fmul_rn(en, __fsub_rn(1.f, expf(-sd)));
    w[n] = wn;
    c = __fadd_rn(c, wn);
    cdf[n] = c;
    if (e != nullptr) e[n] = en;
  }
}

// Fine sample m of one ray by inverse-CDF resampling (sampling.resample):
// the level u_m = cdf_0 + (cdf_last - cdf_0) (m + 1) / (nf + 1), its bin
// idx = clip(#(cdf < u) - 1, 0, nc - 1), the bin's slope dl / (w_{idx+1} +
// 1e-7) (0 for the last bin) and t = t_co[idx] + (u - cdf[idx]) * slope.
struct FineSample {
  float t, u, slope, c_lo;
  int idx;
};

__device__ inline FineSample resample_one(const float* t_co, const float* w,
                                          const float* cdf, int nc, int nf, int m,
                                          float dl) {
  const float low = cdf[0], high = cdf[nc - 1];
  const float frac = __fdiv_rn((float)(m + 1), (float)(nf + 1));
  FineSample f;
  f.u = __fadd_rn(low, __fmul_rn(__fsub_rn(high, low), frac));
  int cnt = 0;
  for (int k = 0; k < nc; ++k) cnt += cdf[k] < f.u;
  f.idx = min(max(cnt - 1, 0), nc - 1);
  f.slope = f.idx == nc - 1 ? 0.f : __fdiv_rn(dl, __fadd_rn(w[f.idx + 1], EPSILON));
  f.c_lo = cdf[f.idx];
  f.t = __fadd_rn(t_co[f.idx], __fmul_rn(__fsub_rn(f.u, f.c_lo), f.slope));
  return f;
}

__device__ inline float coarse_delta(float near, float far, int nc) {
  return __fdiv_rn(__fsub_rn(far, near), (float)nc);
}

__device__ inline float linspace_delta(float near, float far, int nc) {
  return __fdiv_rn(__fsub_rn(far, near), (float)(nc - 1));
}

// Everything before the merge, for the block's nr rays from ray0: load the
// rays' coarse t's and bounds, the field at the coarse samples, the coarse
// weights and cdf (and, with c_co, the coarse color to device memory), the
// fine t's, the field at the fine samples. Ends with a barrier.
template <bool BF16>
__device__ void render_front(FwdSmem& s, const Tail& tl, const Params& p,
                             const float* __restrict__ origins,
                             const float* __restrict__ dirs,
                             const float* __restrict__ t_co,
                             const float* __restrict__ near,
                             const float* __restrict__ far, int ray0, int nr, int nc,
                             int nf, bool white, float* __restrict__ c_co) {
  for (int i = threadIdx.x; i < nr * nc; i += THREADS)
    tl.t_co[i] = t_co[(size_t)ray0 * nc + i];
  for (int r = threadIdx.x; r < nr; r += THREADS) {
    tl.near[r] = near[ray0 + r];
    tl.far[r] = far[ray0 + r];
  }
  __syncthreads();
  field_pass<BF16>(s, p, TileCoord{origins, dirs, tl.t_co, nc, ray0}, nr * nc,
                   tl.sig_co, tl.col_co);

  for (int r = threadIdx.x; r < nr; r += THREADS) {
    const int o = r * nc;
    coarse_weights(tl.sig_co + o, nc, coarse_delta(tl.near[r], tl.far[r], nc),
                   tl.w_co + o, tl.cdf + o);
    if (c_co != nullptr) {
      float c[3] = {0.f, 0.f, 0.f}, wsum = 0.f;
      for (int n = 0; n < nc; ++n) {
        const float w = tl.w_co[o + n];
        for (int ch = 0; ch < 3; ++ch)
          c[ch] = __fadd_rn(c[ch], __fmul_rn(w, tl.col_co[ch][o + n]));
        wsum = __fadd_rn(wsum, w);
      }
      for (int ch = 0; ch < 3; ++ch)
        c_co[3 * (ray0 + r) + ch] = white ? __fadd_rn(c[ch], __fsub_rn(1.f, wsum)) : c[ch];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nr * nf; i += THREADS) {
    const int r = i / nf, o = r * nc;
    tl.t_fi[i] = resample_one(tl.t_co + o, tl.w_co + o, tl.cdf + o, nc, nf, i % nf,
                              linspace_delta(tl.near[r], tl.far[r], nc)).t;
  }
  __syncthreads();
  field_pass<BF16>(s, p, TileCoord{origins, dirs, tl.t_fi, nf, ray0}, nr * nf,
                   tl.sig_fi, tl.col_fi);
}

// The merged composite of block ray r's two sorted lists (a coarse sample
// before a fine one at an equal t; each sample's delta is the distance to
// the next sample of the merged set, the last one's TAIL_DELTA; inclusive
// cumsum weights) into out[3]. With `record` it also keeps the merged
// order, weights and transmittances for the backward. One thread.
__device__ inline void merge_fwd(const Tail& tl, int r, int nc, int nf, bool white,
                                 float out[3], bool record) {
  const float* tc = tl.t_co + r * nc;
  const float* tf = tl.t_fi + r * nf;
  const int K = nc + nf;
  int i = 0, j = 0;
  auto take = [&]() { return (i < nc && (j >= nf || tc[i] <= tf[j])) ? i++ : nc + j++; };
  auto t_of = [&](int k) { return k < nc ? tc[k] : tf[k - nc]; };
  float a = 0.f, wsum = 0.f, c[3] = {0.f, 0.f, 0.f};
  int cur = take();
  for (int k = 0; k < K; ++k) {
    const int nxt = k + 1 < K ? take() : -1;
    const float delta = nxt < 0 ? TAIL_DELTA : __fsub_rn(t_of(nxt), t_of(cur));
    const bool co = cur < nc;
    const int at = co ? r * nc + cur : r * nf + cur - nc;
    const float sd = __fmul_rn(delta, co ? tl.sig_co[at] : tl.sig_fi[at]);
    a = __fadd_rn(a, sd);
    const float e = expf(-a);
    const float w = __fmul_rn(e, __fsub_rn(1.f, expf(-sd)));
    for (int ch = 0; ch < 3; ++ch)
      c[ch] = __fadd_rn(c[ch], __fmul_rn(w, co ? tl.col_co[ch][at] : tl.col_fi[ch][at]));
    wsum = __fadd_rn(wsum, w);
    if (record) {
      tl.order[r * K + k] = cur;
      tl.wm[r * K + k] = w;
      tl.em[r * K + k] = e;
    }
    cur = nxt;
  }
  for (int ch = 0; ch < 3; ++ch)
    out[ch] = white ? __fadd_rn(c[ch], __fsub_rn(1.f, wsum)) : c[ch];
}

}  // namespace
