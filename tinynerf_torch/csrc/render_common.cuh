// Building blocks shared by the fused renderer's kernels for Hopper
// (sm_90a): render_fused_fwd.cu (its forward) and render_fused_bwd.cu (its
// backward). The forward evaluates the whole per-ray renderer of
// tinynerf_torch.kernels.render_kernel.render_fused_plain: the field at the
// coarse samples, the coarse weights and composite, the inverse-CDF
// resample, the field at the fine samples and the merged composite of the
// two sorted lists. The backward starts from the forward's per-ray state
// (its residuals, Res) and calls the tail's functions again on it.
//
// A block owns `rpb` whole rays. Their per-sample state (t, sigma, r, g, b
// at every coarse and fine sample, the coarse weights and cdf, the merged
// order) lives in shared memory after the field's tile, so device memory
// sees only the rays in and the colors out. The field passes run on the
// block's rows (ray-major, coarse then fine) in tiles of Geo<BF16>::M rows:
// the fp32 form 64-row tiles of 256 threads through field_common.cuh's
// encode_tile / network_fwd (two blocks an SM); the bf16 form 128-row
// tiles of 512 threads on the tensor cores (field_tc.cuh, M = 128: one
// block an SM, each weight K-tile read from L2 once per 128 rows, half the
// traffic of the 64-row tile).
//
// The tail between the passes is parallel: one warp a ray for the sums (the
// coarse weights, their cdf and color, the merged composite), one thread a
// fine sample for the resample (a binary search over the ray's cdf), one
// thread a sample for the merge's ranks (binary searches over the other
// list). Every sum of the tail runs in one order fixed by its length
// (warp_scan; field_common.cuh's warp_sum, whose xor butterfly leaves the
// same bits on every lane), so the backward's recompute from the residuals
// (render_fused_bwd.cu: merge_bwd_kernel's merge and coarse weights,
// resample_bwd_kernel's coarse weights and bins) gives the forward's bits.
//
// Numerics follow the plain PyTorch version: every product, sum and
// quotient of the tail is a rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn), so nvcc contracts nothing; exp is the accurate expf.

#pragma once

#include <algorithm>

#include "field_tc.cuh"

namespace {

constexpr float TAIL_DELTA = 1e-4f;   // the merged pass's last delta
constexpr float EPSILON = 1e-7f;      // the resampler's slope epsilon
constexpr size_t MAX_SMEM = 232448;   // 227 KB, a block's dynamic shared memory
constexpr unsigned FULL_MASK = 0xffffffffu;

// A form's block: field tiles of M rows, THREADS threads, BLOCKS resident
// blocks an SM, and the tile's shared memory; the bf16 tile's products sum
// as KS says (field_tc.cuh).
template <bool BF16>
struct Geo;
template <>
struct Geo<false> {  // float32 FMA (field_common.cuh)
  static constexpr int M = TILE_M, THREADS = 256, BLOCKS = 2;
  using Smem = FwdSmem;
};
template <>
struct Geo<true> {  // bf16 tensor cores (field_tc.cuh)
  static constexpr int M = 128, THREADS = 4 * 128, BLOCKS = 1;
  static constexpr KSum KS = KSum::WHOLE_K;
  using Smem = TcSmemT<128>;
};
static_assert(Geo<false>::THREADS == THREADS, "the fp32 tile runs THREADS threads");

// A block's per-ray state in shared memory, each array ray-major.
struct Tail {
  float *t_co, *sig_co, *col_co[3], *w_co, *cdf;   // (rpb, nc)
  float *t_fi, *sig_fi, *col_fi[3];                // (rpb, nf)
  float *near, *far;                               // (rpb)
  int* order;  // (rpb, nc + nf): the merged order, coarse sample n as n, fine m as nc + m
  // the merge's backward only (merge_fwd's `record`): the merged weights and
  // transmittances (rpb, nc + nf)
  float *wm, *em;
};

inline int tail_floats(int rpb, int nc, int nf) { return rpb * (8 * nc + 6 * nf + 2); }

__device__ inline Tail carve_tail(float* f, int rpb, int nc, int nf) {
  Tail t;
  const int c = rpb * nc, n = rpb * nf;
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
  t.order = reinterpret_cast<int*>(f);
  t.wm = t.em = nullptr;
  return t;
}

inline size_t render_smem_bytes(bool bf16, int rpb, int nc, int nf) {
  return (bf16 ? sizeof(Geo<true>::Smem) : sizeof(Geo<false>::Smem)) +
         sizeof(float) * (size_t)tail_floats(rpb, nc, nf);
}

// Rays per block: enough to fill an M-row tile with coarse samples, fewer
// where their state would not fit in shared memory; 0 where one ray's does
// not.
inline int rays_per_block(bool bf16, int nc, int nf) {
  int rpb = std::max(1, (bf16 ? Geo<true>::M : Geo<false>::M) / nc);
  while (rpb > 1 && render_smem_bytes(bf16, rpb, nc, nf) > MAX_SMEM) --rpb;
  return render_smem_bytes(bf16, rpb, nc, nf) > MAX_SMEM ? 0 : rpb;
}

// The forward's per-ray state that the backward starts from (its
// residuals), planes of one float32 buffer of residual_floats(B, nc, nf):
// the fine t's (B, nf), the coarse sigma (B, nc) and color (3, B, nc), the
// fine sigma (B, nf) and color (3, B, nf); color channel ch at col + ch *
// B * n.
struct Res {
  float *t_fi, *sig_co, *col_co, *sig_fi, *col_fi;
};

inline long long residual_floats(long long b, int nc, int nf) { return b * (4 * nc + 5 * nf); }

__host__ __device__ inline Res carve_res(float* f, long long b, int nc, int nf) {
  Res r;
  r.t_fi = f; f += b * nf;
  r.sig_co = f; f += b * nc;
  r.col_co = f; f += 3 * b * nc;
  r.sig_fi = f; f += b * nf;
  r.col_fi = f;
  return r;
}

// Phase clocks of the forward, only in a variant build (-DRENDER_PHASE_CLOCKS,
// a separate library that a measurement loads; the main path's library has
// none of it). At each phase's end the block meets at a barrier: thread 0
// adds the block's clock64() cycles since the last mark to
// phase_clocks[block][i], and each warp's lane 0 adds to
// phase_busy[block][i] the cycles its warp worked before it reached the
// barrier, so that 1 - busy / (warps x cycles) is the share of the block's
// warps that waited through the phase. Without the flag, sync() is a plain
// barrier and mark() nothing.
enum { PH_COARSE_FIELD, PH_COARSE_WEIGHTS, PH_RESAMPLE, PH_FINE_FIELD, PH_MERGE, N_PHASES };
#ifdef RENDER_PHASE_CLOCKS
constexpr int MAX_PHASE_BLOCKS = 4096;
__device__ long long phase_clocks[MAX_PHASE_BLOCKS * N_PHASES];
__device__ long long phase_busy[MAX_PHASE_BLOCKS * N_PHASES];
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
struct PhaseClock {
  long long t;
  __device__ PhaseClock() : t(clock_now()) {}
  __device__ void sync(int i) {
    const long long arrive = clock_now();
    const bool counted = blockIdx.x < MAX_PHASE_BLOCKS;
    if (counted && (threadIdx.x & 31) == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(&phase_busy[blockIdx.x * N_PHASES + i]),
                (unsigned long long)(arrive - t));
    __syncthreads();
    const long long now = clock_now();
    if (counted && threadIdx.x == 0) phase_clocks[blockIdx.x * N_PHASES + i] += now - t;
    t = now;
  }
  __device__ void mark(int i) { sync(i); }
};
#else
struct PhaseClock {
  __device__ void sync(int) { __syncthreads(); }
  __device__ void mark(int) {}
};
#endif

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

// The field at the block's `rows` rows (Geo<BF16>::M at a time) into sig
// and col[3], in shared memory. No barrier after the last tile.
template <bool BF16>
__device__ void field_pass(typename Geo<BF16>::Smem& s, const Params& p, TileCoord coord,
                           int rows, float* sig, float* const* col) {
  const auto out = [&](int m, int ch, float v) { (ch == 3 ? sig : col[ch])[m] = v; };
  for (int base = 0; base < rows; base += Geo<BF16>::M) {
    if constexpr (BF16) {
      encode_tile_tc<Geo<true>::M>(coord, p.freqs, base, rows, s.enc_pt, s.enc_dir);
      network_tc<Geo<true>::M, Geo<true>::KS>(s, p, base, rows, out);
    } else {
      field_tile<false>(s, p, coord, base, rows, out);
    }
  }
}

// Inclusive prefix sums of x(0), ..., x(n - 1) by one warp, in an order
// that n alone fixes: lane l sums its run [l c, l c + c), c = ceil(n / 32),
// left to right; a Hillis-Steele scan of the 32 run sums (shuffles) gives
// each run the sum E of the runs before it; element i's prefix is E + (its
// run's sum up to i), passed to out(i, prefix) by the run's lane, in order.
// x is read twice and must give the same value both times. For x >= 0 the
// prefixes rise within a run, and may fall by an ulp where two runs meet.
template <class X, class Out>
__device__ __forceinline__ void warp_scan(int n, X x, Out out) {
  const int lane = threadIdx.x & 31, c = (n + 31) >> 5;
  const int lo = min(lane * c, n), hi = min(lo + c, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) run = __fadd_rn(run, x(i));
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, y);
  }
  float before = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) before = 0.f;
  float s = 0.f;
  for (int i = lo; i < hi; ++i) {
    s = __fadd_rn(s, x(i));
    out(i, __fadd_rn(before, s));
  }
}

// #{k < n : pred(k)} for a predicate that holds on a prefix of 0 .. n - 1
// (a comparison against a sorted list): a binary search.
template <class P>
__device__ __forceinline__ int prefix_count(int n, P pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One ray's coarse weights by one warp, with the inclusive cumsum (Q5): sd =
// sigma * dc, w = exp(-cumsum(sd)) (1 - exp(-sd)); with `e` also
// exp(-cumsum(sd)). Their cdf is the cumsum of w, each value raised to the
// largest before it (a max scan, exact), so that the cdf never falls where
// two runs of warp_scan meet: the resampler's binary search and its levels
// (the cdf's min and max, its first and last values) need a cdf that does
// not fall. Ends with __syncwarp.
__device__ inline void coarse_weights(const float* sig, int nc, float dc, float* w,
                                      float* cdf, float* e = nullptr) {
  const auto sd = [&](int n) { return __fmul_rn(sig[n], dc); };
  warp_scan(nc, sd, [&](int n, float a) {
    const float en = expf(-a);
    w[n] = __fmul_rn(en, __fsub_rn(1.f, expf(-sd(n))));
    if (e != nullptr) e[n] = en;
  });
  float top = 0.f;  // the lane's largest prefix: its run's last
  warp_scan(nc, [&](int n) { return w[n]; }, [&](int n, float c) {
    cdf[n] = c;
    top = c;
  });
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL_MASK, top, o);
    if (lane >= o) top = fmaxf(top, y);
  }
  float below = __shfl_up_sync(FULL_MASK, top, 1);
  if (lane == 0) below = 0.f;
  const int c = (nc + 31) >> 5;
  for (int n = min(lane * c, nc); n < min(lane * c + c, nc); ++n) cdf[n] = fmaxf(cdf[n], below);
  __syncwarp();
}

// Fine sample m of one ray by inverse-CDF resampling (sampling.resample):
// the level u_m = cdf_0 + (cdf_last - cdf_0) (m + 1) / (nf + 1), its bin
// idx = clip(#(cdf < u) - 1, 0, nc - 1) (a binary search: the cdf does not
// fall), the bin's slope dl / (w_{idx+1} + 1e-7) (0 for the last bin) and t
// = t_co[idx] + (u - cdf[idx]) * slope.
struct FineSample {
  float t, u, slope, c_lo;
  int idx;
};

__device__ __forceinline__ float fine_level(const float* cdf, int nc, int nf, int m) {
  const float low = cdf[0], high = cdf[nc - 1];
  const float frac = __fdiv_rn((float)(m + 1), (float)(nf + 1));
  return __fadd_rn(low, __fmul_rn(__fsub_rn(high, low), frac));
}

__device__ inline FineSample resample_one(const float* t_co, const float* w,
                                          const float* cdf, int nc, int nf, int m,
                                          float dl) {
  FineSample f;
  f.u = fine_level(cdf, nc, nf, m);
  const int cnt = prefix_count(nc, [&](int k) { return cdf[k] < f.u; });
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
// weights and cdf (and, with c_co, the coarse color to device memory; a
// warp a ray), the fine t's (a thread a fine sample), the field at the fine
// samples. Ends with a barrier.
template <bool BF16>
__device__ void render_front(typename Geo<BF16>::Smem& s, const Tail& tl, const Params& p,
                             const float* __restrict__ origins,
                             const float* __restrict__ dirs,
                             const float* __restrict__ t_co,
                             const float* __restrict__ near,
                             const float* __restrict__ far, int ray0, int nr, int nc,
                             int nf, bool white, float* __restrict__ c_co, PhaseClock& clk) {
  constexpr int NTH = Geo<BF16>::THREADS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nr * nc; i += NTH) tl.t_co[i] = t_co[(size_t)ray0 * nc + i];
  for (int r = threadIdx.x; r < nr; r += NTH) {
    tl.near[r] = near[ray0 + r];
    tl.far[r] = far[ray0 + r];
  }
  __syncthreads();
  field_pass<BF16>(s, p, TileCoord{origins, dirs, tl.t_co, nc, ray0}, nr * nc, tl.sig_co,
                   tl.col_co);
  clk.sync(PH_COARSE_FIELD);

  for (int r = warp; r < nr; r += NTH / 32) {
    const int o = r * nc;
    coarse_weights(tl.sig_co + o, nc, coarse_delta(tl.near[r], tl.far[r], nc), tl.w_co + o,
                   tl.cdf + o);
    if (c_co == nullptr) continue;
    float c[3] = {0.f, 0.f, 0.f}, wsum = 0.f;
    for (int n = lane; n < nc; n += 32) {
      const float w = tl.w_co[o + n];
      for (int ch = 0; ch < 3; ++ch)
        c[ch] = __fadd_rn(c[ch], __fmul_rn(w, tl.col_co[ch][o + n]));
      wsum = __fadd_rn(wsum, w);
    }
    wsum = warp_sum(wsum);
    for (int ch = 0; ch < 3; ++ch) {
      c[ch] = warp_sum(c[ch]);
      if (lane == ch)
        c_co[3 * (ray0 + r) + ch] = white ? __fadd_rn(c[ch], __fsub_rn(1.f, wsum)) : c[ch];
    }
  }
  clk.sync(PH_COARSE_WEIGHTS);

  for (int i = threadIdx.x; i < nr * nf; i += NTH) {
    const int r = i / nf, o = r * nc;
    tl.t_fi[i] = resample_one(tl.t_co + o, tl.w_co + o, tl.cdf + o, nc, nf, i % nf,
                              linspace_delta(tl.near[r], tl.far[r], nc)).t;
  }
  clk.sync(PH_RESAMPLE);
  field_pass<BF16>(s, p, TileCoord{origins, dirs, tl.t_fi, nf, ray0}, nr * nf, tl.sig_fi,
                   tl.col_fi);
  clk.sync(PH_FINE_FIELD);
}

// The merged order of block ray r's two lists: a coarse sample before a fine
// one at an equal t (coarse_first), each list in its own order at equal t's
// (a stable sort of concat([coarse, fine]), as render.merged_composite). A
// sample's place is its rank in its own list plus the number of the other
// list's samples before it: by binary searches where both lists are sorted
// (the kernels' inputs and resample_one's t's), by counts over the lists
// where one is not (an ulp of the cdf can put a fine t a hair above the
// next). One warp, a thread a sample; ends with __syncwarp.
__device__ __forceinline__ bool coarse_first(float t_coarse, float t_fine) {
  return t_coarse <= t_fine;
}

__device__ inline void merge_order(const Tail& tl, int r, int nc, int nf) {
  const float* tc = tl.t_co + r * nc;
  const float* tf = tl.t_fi + r * nf;
  int* order = tl.order + r * (nc + nf);
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int k = lane; k + 1 < nc; k += 32) ok &= tc[k] <= tc[k + 1];
  for (int k = lane; k + 1 < nf; k += 32) ok &= tf[k] <= tf[k + 1];
  const bool sorted = __all_sync(FULL_MASK, ok);
  // #{k < n : pred(k)}, pred holding on a prefix where the lists are sorted
  const auto count = [&](int n, auto pred) {
    if (sorted) return prefix_count(n, pred);
    int c = 0;
    for (int k = 0; k < n; ++k) c += pred(k);
    return c;
  };
  // i's rank in its own list t: the samples below t[i], then the equal ones before it
  const auto own = [&](const float* t, int n, int i) {
    return sorted ? i : count(n, [&](int k) { return t[k] < t[i] || (t[k] == t[i] && k < i); });
  };
  for (int i = lane; i < nc; i += 32)
    order[own(tc, nc, i) + count(nf, [&](int j) { return !coarse_first(tc[i], tf[j]); })] = i;
  for (int j = lane; j < nf; j += 32)
    order[own(tf, nf, j) + count(nc, [&](int i) { return coarse_first(tc[i], tf[j]); })] = nc + j;
  __syncwarp();
}

// The merged composite of block ray r's two lists (each sample's delta is
// the distance to the next sample of the merged set, the last one's
// TAIL_DELTA; inclusive cumsum weights) into out[3] on every lane. With
// `record` it also keeps the merged weights and transmittances for the
// backward. One warp: merge_order, then warp_scan over the merged samples.
__device__ inline void merge_fwd(const Tail& tl, int r, int nc, int nf, bool white,
                                 float out[3], bool record) {
  merge_order(tl, r, nc, nf);
  const int K = nc + nf;
  const int* order = tl.order + r * K;
  const auto t_of = [&](int k) {
    return k < nc ? tl.t_co[r * nc + k] : tl.t_fi[r * nf + k - nc];
  };
  const auto sig_of = [&](int k) {
    return k < nc ? tl.sig_co[r * nc + k] : tl.sig_fi[r * nf + k - nc];
  };
  const auto sd = [&](int k) {
    const float delta = k + 1 < K ? __fsub_rn(t_of(order[k + 1]), t_of(order[k])) : TAIL_DELTA;
    return __fmul_rn(delta, sig_of(order[k]));
  };
  float c[3] = {0.f, 0.f, 0.f}, wsum = 0.f;
  warp_scan(K, sd, [&](int k, float a) {
    const float e = expf(-a);
    const float w = __fmul_rn(e, __fsub_rn(1.f, expf(-sd(k))));
    const int cur = order[k];
    for (int ch = 0; ch < 3; ++ch) {
      const float col = cur < nc ? tl.col_co[ch][r * nc + cur] : tl.col_fi[ch][r * nf + cur - nc];
      c[ch] = __fadd_rn(c[ch], __fmul_rn(w, col));
    }
    wsum = __fadd_rn(wsum, w);
    if (record) {
      tl.wm[r * K + k] = w;
      tl.em[r * K + k] = e;
    }
  });
  wsum = warp_sum(wsum);
  for (int ch = 0; ch < 3; ++ch) {
    c[ch] = warp_sum(c[ch]);
    out[ch] = white ? __fadd_rn(c[ch], __fsub_rn(1.f, wsum)) : c[ch];
  }
  if (record) __syncwarp();
}

}  // namespace
