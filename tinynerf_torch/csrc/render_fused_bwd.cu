// The fused renderer's backward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/render_kernel.py::_fused_render_backward /
// _bwd_fine_kernel + _bwd_coarse_kernel (TPU kernel 10): given the rays of
// render_fused_fwd.cu, the forward's residuals (Res, render_common.cuh: the
// fine t's and both passes' sigma and color, which kernel 9 writes where a
// backward can follow) and the cotangents g_cco, g_cfi (B, 3) of C_coarse
// and C_fine, it returns the gradients of every weight and bias (float32).
// Ray geometry is data and gets none. The chain: the merged composite's
// backward (fine and coarse sigma and color cotangents, and each fine t's
// through the deltas), the fine field's backward with its d_ts (through pts
// = o + t*d), the resampler's (through the gathered cdf and slope; the
// levels are detached, Q8), the coarse composite's and the density's, then
// the coarse field's backward without d_ts; the two gradient sets summed.
//
// What bounds it: FLOPs, three times the forward's (the two field
// backwards, kernel 2's recompute, input and weight products).
//
// Design. The TPU kernel re-runs both field passes before its tail only
// because its tail state does not stay in Mosaic's VMEM between the
// kernels; here kernel 9 hands that state over (14.7 MB at B = 4096, 64 +
// 128 samples), so no launch here runs the forward's field. A 64-row
// tile's activations (512 KB) do not fit in shared memory either, so each
// field pass's backward is kernel 2's own device code
// (field_bwd_common.cuh: recompute into a workspace, weight gradients over
// fixed row slices, an ordered reduce). One call is, all on `stream`:
// 1. merge_bwd_kernel, one warp a ray, no field tile: the coarse weights
//    (coarse_weights), the merged order, weights and transmittances
//    (merge_fwd with `record`) from the residuals with kernel 9's own
//    functions, so kernel 9's bits (its C_fine too, written for checks);
//    then the merge's backward: each place's weight cotangent (a lane a
//    place), the suffix sums of -w gw as a reversed warp_scan, each fine
//    t's cotangent by its rank (no atomics, no per-ray array of sums). It
//    writes the hand-off planes: the fine samples' (sigma, r, g, b)
//    cotangents and their t cotangents from the merge (B, N_f); the coarse
//    color term of the weight cotangent and the coarse (sigma, r, g, b)
//    cotangents from both composites (B, N_c);
// 2. kernel 2 over the fine samples at the residual t's: its weight
//    gradients into `grads`, and d_ts (B, N_f);
// 3. resample_bwd_kernel, one warp a ray: the coarse weights, cdf and
//    fine-sample bins recomputed from the coarse sigma with kernel 9's
//    functions (the forward's bits), the resampler's, composite's and
//    density's backward, into the coarse sigma cotangent;
// 4. kernel 2 over the coarse samples, its weight gradients added to
//    `grads` in the same fixed order.
// No atomics: two calls are bit-identical.
//
// merge_bwd_kernel copies each ray's residual planes into shared memory
// first (a warp its own ray, coalesced): on the card that ran a little
// faster than reading them where they lie, through L1 and L2, in less
// shared memory a ray and more rays an SM (PERF.md).

#include "field_bwd_common.cuh"
#include "render_common.cuh"

namespace {

// The hand-off planes between the launches, ray-major.
struct Hand {
  const float *t_fi, *sig_co;                            // the residuals'
  float *gs_fi, *gr_fi, *gg_fi, *gb_fi, *gt_fi;          // (B, nf)
  float *gw_co, *gs_co, *gr_co, *gg_co, *gb_co;          // (B, nc)
};

// merge_bwd_kernel's rays a block (a warp each), where they fit.
constexpr int MERGE_RAYS = 8;

// Floats of shared memory merge_bwd_kernel takes a ray: the merged order
// and its inverse (ints), the merged weights, transmittances, weight
// cotangents, sigma cotangents and delta cotangents, the coarse weights and
// cdf, and the ray's t's and its residual sigma and color.
inline int merge_floats(int nc, int nf) { return 12 * (nc + nf) + 2 * nc; }

inline int merge_rays_per_block(int nc, int nf) {
  int rpb = MERGE_RAYS;
  while (rpb > 0 && sizeof(float) * (size_t)rpb * merge_floats(nc, nf) > MAX_SMEM) --rpb;
  return rpb;
}

// One warp a ray (block ray r, device ray `ray`): kernel 9's merge from its
// residuals, then the merge's backward into the hand-off planes. From the
// last place K - 1 down: g_A_k = -w_k g_w_k, g_sd_k = e_k exp(-sd_k) g_w_k +
// rev_k with rev_k = sum_{k' >= k} g_A_k', g_sigma = delta g_sd, g_delta =
// sigma g_sd; delta_k = t_{k+1} - t_k gives fine sample m at place k_m the
// t cotangent (0 - g_delta_{k_m}) + g_delta_{k_m - 1}, each term where its
// place exists, in that order. c_fi: null, or (B, 3) for the merge's C_fine.
__global__ void __launch_bounds__(32 * MERGE_RAYS)
merge_bwd_kernel(const float* __restrict__ t_co, const float* __restrict__ near,
                 const float* __restrict__ far, const float* __restrict__ g_cco,
                 const float* __restrict__ g_cfi, Res res, Hand h,
                 float* __restrict__ c_fi, int n_rays, int nc, int nf, int rpb, int white) {
  extern __shared__ float4 smem_raw[];
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * rpb + r;
  if (ray >= n_rays) return;
  const int K = nc + nf;
  const size_t cp = (size_t)n_rays * nc, fp = (size_t)n_rays * nf;
  // the block's Tail, ray r's at r * n: the merge's arrays, and the ray's
  // residual planes staged
  float* f = reinterpret_cast<float*>(smem_raw);
  Tail tl;
  tl.order = reinterpret_cast<int*>(f); f += rpb * K;
  int* pos = reinterpret_cast<int*>(f) + r * K; f += rpb * K;
  tl.wm = f; f += rpb * K;
  tl.em = f; f += rpb * K;
  float* gw = f + r * K; f += rpb * K;
  float* gs = f + r * K; f += rpb * K;
  float* gd = f + r * K; f += rpb * K;
  tl.w_co = f; f += rpb * nc;
  tl.cdf = f; f += rpb * nc;
  tl.t_co = f; f += rpb * nc;
  tl.sig_co = f; f += rpb * nc;
  for (int ch = 0; ch < 3; ++ch) { tl.col_co[ch] = f; f += rpb * nc; }
  tl.t_fi = f; f += rpb * nf;
  tl.sig_fi = f; f += rpb * nf;
  for (int ch = 0; ch < 3; ++ch) { tl.col_fi[ch] = f; f += rpb * nf; }
  for (int i = lane; i < nc; i += 32) {
    const size_t at = (size_t)ray * nc + i;
    tl.t_co[r * nc + i] = t_co[at];
    tl.sig_co[r * nc + i] = res.sig_co[at];
    for (int ch = 0; ch < 3; ++ch) tl.col_co[ch][r * nc + i] = res.col_co[ch * cp + at];
  }
  for (int i = lane; i < nf; i += 32) {
    const size_t at = (size_t)ray * nf + i;
    tl.t_fi[r * nf + i] = res.t_fi[at];
    tl.sig_fi[r * nf + i] = res.sig_fi[at];
    for (int ch = 0; ch < 3; ++ch) tl.col_fi[ch][r * nf + i] = res.col_fi[ch * fp + at];
  }
  __syncwarp();

  // kernel 9's coarse weights, merged order, weights and transmittances
  const int oc = r * nc, of = r * nf;
  coarse_weights(tl.sig_co + oc, nc, coarse_delta(near[ray], far[ray], nc), tl.w_co + oc,
                 tl.cdf + oc);
  float c[3];
  merge_fwd(tl, r, nc, nf, white != 0, c, true);
  if (c_fi != nullptr)
    for (int ch = 0; ch < 3; ++ch)
      if (lane == ch) c_fi[3 * ray + ch] = c[ch];

  const float g[3] = {g_cfi[3 * ray], g_cfi[3 * ray + 1], g_cfi[3 * ray + 2]};
  const float gc[3] = {g_cco[3 * ray], g_cco[3 * ray + 1], g_cco[3 * ray + 2]};
  // the white term (1 - sum w) adds -sum(g) to every weight's cotangent
  const float gsum = white ? __fadd_rn(__fadd_rn(g[0], g[1]), g[2]) : 0.f;
  const float gcsum = white ? __fadd_rn(__fadd_rn(gc[0], gc[1]), gc[2]) : 0.f;
  const int* order = tl.order + r * K;
  const float *wm = tl.wm + r * K, *em = tl.em + r * K;
  const auto t_of = [&](int i) { return i < nc ? tl.t_co[oc + i] : tl.t_fi[of + i - nc]; };
  const auto sig_of = [&](int i) { return i < nc ? tl.sig_co[oc + i] : tl.sig_fi[of + i - nc]; };
  // each place's weight cotangent, and each sample's place
  for (int k = lane; k < K; k += 32) {
    const int cur = order[k];
    float gwk = -gsum;
    for (int ch = 0; ch < 3; ++ch)
      gwk = __fadd_rn(gwk, __fmul_rn(cur < nc ? tl.col_co[ch][oc + cur]
                                              : tl.col_fi[ch][of + cur - nc], g[ch]));
    gw[k] = gwk;
    pos[cur] = k;
  }
  __syncwarp();
  // rev_k, a reversed warp_scan; then each place's sigma and delta cotangents
  warp_scan(K, [&](int i) { return -__fmul_rn(wm[K - 1 - i], gw[K - 1 - i]); },
            [&](int i, float rev) {
              const int k = K - 1 - i, cur = order[k];
              const float sig = sig_of(cur);
              const float delta =
                  k + 1 < K ? __fsub_rn(t_of(order[k + 1]), t_of(cur)) : TAIL_DELTA;
              const float sd = __fmul_rn(delta, sig);
              const float gsd = __fadd_rn(__fmul_rn(__fmul_rn(em[k], expf(-sd)), gw[k]), rev);
              gs[k] = __fmul_rn(delta, gsd);
              gd[k] = __fmul_rn(sig, gsd);
            });
  __syncwarp();
  // a thread a sample: its place's cotangents into the hand-off planes
  for (int m = lane; m < nf; m += 32) {
    const int k = pos[nc + m];
    const float w = wm[k];
    const size_t at = (size_t)ray * nf + m;
    h.gs_fi[at] = gs[k];
    h.gr_fi[at] = __fmul_rn(w, g[0]);
    h.gg_fi[at] = __fmul_rn(w, g[1]);
    h.gb_fi[at] = __fmul_rn(w, g[2]);
    float gt = 0.f;
    if (k + 1 < K) gt = __fsub_rn(gt, gd[k]);
    if (k > 0) gt = __fadd_rn(gt, gd[k - 1]);
    h.gt_fi[at] = gt;
  }
  for (int n = lane; n < nc; n += 32) {
    const int k = pos[n];
    const float w = wm[k], wc = tl.w_co[oc + n];
    const size_t at = (size_t)ray * nc + n;
    // the coarse color's cotangent from both composites, and the coarse
    // composite's cotangent of the coarse weight
    h.gs_co[at] = gs[k];
    h.gr_co[at] = __fadd_rn(__fmul_rn(wc, gc[0]), __fmul_rn(w, g[0]));
    h.gg_co[at] = __fadd_rn(__fmul_rn(wc, gc[1]), __fmul_rn(w, g[1]));
    h.gb_co[at] = __fadd_rn(__fmul_rn(wc, gc[2]), __fmul_rn(w, g[2]));
    float gwc = -gcsum;
    for (int ch = 0; ch < 3; ++ch) gwc = __fadd_rn(gwc, __fmul_rn(tl.col_co[ch][oc + n], gc[ch]));
    h.gw_co[at] = gwc;
  }
}

// One warp a ray: the fine t's cotangents (the merge's plus the fine
// field's d_ts) back through the resampler to the coarse weights, plus
// their composite cotangent, back through the density into the coarse
// sigma cotangent (added to the merge's in h.gs_co). The coarse weights,
// cdf and the fine samples' bins are kernel 9's (coarse_weights,
// resample_one: its bits). Each bin's lane sums its fine samples' terms in
// m's order (a bin's samples are consecutive: the levels rise), and the
// reversed cumsums are warp_scans. The scratch holds five (B, nc) planes:
// w, cdf (then the reversed cumsum of g_cdf), exp(-cumsum sd), g_cdf (then
// g_w), g_slope.
__global__ void resample_bwd_kernel(const float* __restrict__ t_co,
                                    const float* __restrict__ near,
                                    const float* __restrict__ far,
                                    const float* __restrict__ d_ts, Hand h,
                                    float* __restrict__ scratch, int n_rays, int nc,
                                    int nf) {
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= n_rays) return;
  const int lane = threadIdx.x & 31;
  const size_t o = (size_t)ray * nc, plane = (size_t)n_rays * nc;
  float *w = scratch + o, *cdf = w + plane, *e = cdf + plane, *gcdf = e + plane,
        *gslope = gcdf + plane;
  const float* sig = h.sig_co + o;
  const float dc = coarse_delta(near[ray], far[ray], nc);
  const float dl = linspace_delta(near[ray], far[ray], nc);
  coarse_weights(sig, nc, dc, w, cdf, e);
  // the first fine sample whose bin is n or later: u_m > cdf[n] (n > 0)
  const auto first = [&](int n) {
    if (n == 0) return 0;
    if (n == nc) return nf;
    return prefix_count(nf, [&](int m) { return !(cdf[n] < fine_level(cdf, nc, nf, m)); });
  };
  // t = t_co[idx] + (u - cdf[idx]) slope[idx], u and idx fixed
  for (int n = lane; n < nc; n += 32) {
    float gc = 0.f, gs = 0.f;
    for (int m = first(n), end = first(n + 1); m < end; ++m) {
      const FineSample f = resample_one(t_co + o, w, cdf, nc, nf, m, dl);
      const size_t i = (size_t)ray * nf + m;
      const float g = __fadd_rn(h.gt_fi[i], d_ts[i]);
      gc = __fsub_rn(gc, __fmul_rn(f.slope, g));
      gs = __fadd_rn(gs, __fmul_rn(__fsub_rn(f.u, f.c_lo), g));
    }
    gcdf[n] = gc;
    gslope[n] = gs;
  }
  __syncwarp();
  // rc_n = sum_{k >= n} g_cdf_k, into the cdf's plane
  float* rc = cdf;
  warp_scan(nc, [&](int k) { return gcdf[nc - 1 - k]; },
            [&](int k, float v) { rc[nc - 1 - k] = v; });
  __syncwarp();
  // g_w_n = composite term + rc_n + d slope_{n-1} / d w_n, into g_cdf's plane
  for (int n = lane; n < nc; n += 32) {
    float gw = __fadd_rn(h.gw_co[o + n], rc[n]);
    if (n > 0) {
      const float x = __fadd_rn(w[n], EPSILON);
      gw = __fadd_rn(gw, -__fmul_rn(__fdiv_rn(dl, __fmul_rn(x, x)), gslope[n - 1]));
    }
    gcdf[n] = gw;
  }
  __syncwarp();
  // then the density: g_sd_n = e_n exp(-sd_n) g_w_n + sum_{k >= n} -w_k g_w_k
  const float* gwn = gcdf;
  warp_scan(nc, [&](int k) { return -__fmul_rn(w[nc - 1 - k], gwn[nc - 1 - k]); },
            [&](int k, float rev) {
              const int n = nc - 1 - k;
              const float sd = __fmul_rn(sig[n], dc);
              const float gsd = __fadd_rn(__fmul_rn(__fmul_rn(e[n], expf(-sd)), gwn[n]), rev);
              h.gs_co[o + n] = __fadd_rn(h.gs_co[o + n], __fmul_rn(dc, gsd));
            });
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Floats of workspace that kernel 2 takes for the larger of the two passes.
long long field_ws_floats(int n_rays, int nc, int nf) {
  return std::max(field_bwd_workspace_floats(n_rays, nc),
                  field_bwd_workspace_floats(n_rays, nf));
}

// merge_bwd_kernel on `st` (its arguments, checked by the callers).
int launch_merge(const float* t_co, const float* near, const float* far, const float* g_cco,
                 const float* g_cfi, const Res& res, const Hand& h, float* c_fi, int n_rays,
                 int nc, int nf, int white, cudaStream_t st) {
  const int rpb = merge_rays_per_block(nc, nf);
  if (rpb == 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(float) * (size_t)rpb * merge_floats(nc, nf));
  cudaError_t err =
      cudaFuncSetAttribute(merge_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  merge_bwd_kernel<<<(n_rays + rpb - 1) / rpb, 32 * rpb, smem, st>>>(
      t_co, near, far, g_cco, g_cfi, res, h, c_fi, n_rays, nc, nf, rpb, white);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rays a block of the merge's backward takes, or 0 where one ray's state
// does not fit in a block's shared memory (the wrapper refuses those shapes
// by name). The same in both forms: the tail is float32.
int render_fused_bwd_rays_per_block(int n_coarse, int n_fine) {
  if (n_coarse < 2 || n_fine < 1) return 0;
  return merge_rays_per_block(n_coarse, n_fine);
}

// Bytes of dynamic shared memory one block of the merge's backward takes.
int render_fused_bwd_smem_bytes(int n_coarse, int n_fine) {
  const int rpb = render_fused_bwd_rays_per_block(n_coarse, n_fine);
  return (int)(sizeof(float) * (size_t)rpb * merge_floats(n_coarse, n_fine));
}

// Float32 elements of workspace render_fused_bwd needs for these shapes.
long long render_fused_bwd_workspace_floats(int n_rays, int n_coarse, int n_fine) {
  if (n_rays <= 0) return 0;
  const long long b = n_rays, nm = std::max(n_coarse, n_fine);
  return field_ws_floats(n_rays, n_coarse, n_fine) + 5 * round4(b * n_fine) +
         10 * round4(b * n_coarse) + round4(b * nm) + 2 * round4(3 * b);
}

// The merge's backward alone (launch 1 of render_fused_bwd), for checks:
// t_co (n_rays, n_coarse), near, far (n_rays,), g_cco, g_cfi (n_rays, 3);
// the residuals as five planes: t_fi, sig_fi (n_rays, n_fine), sig_co
// (n_rays, n_coarse), col_co (3, n_rays, n_coarse), col_fi (3, n_rays,
// n_fine). Writes g_fi (4, n_rays, n_fine) and g_co (4, n_rays, n_coarse),
// the (sigma, r, g, b) cotangents, gt_fi (n_rays, n_fine), gw_co (n_rays,
// n_coarse) and c_fi (n_rays, 3), the merge's C_fine. All float32,
// contiguous, on the current device. Launches on `stream` and returns the
// launch error, or 0.
int render_fused_merge_bwd(const float* t_co, const float* near, const float* far,
                           const float* g_cco, const float* g_cfi, const float* t_fi,
                           const float* sig_co, const float* col_co, const float* sig_fi,
                           const float* col_fi, float* g_fi, float* gt_fi, float* g_co,
                           float* gw_co, float* c_fi, int n_rays, int n_coarse, int n_fine,
                           int white, void* stream) {
  if (n_rays <= 0) return 0;
  const Res res{const_cast<float*>(t_fi), const_cast<float*>(sig_co),
                const_cast<float*>(col_co), const_cast<float*>(sig_fi),
                const_cast<float*>(col_fi)};
  const size_t cp = (size_t)n_rays * n_coarse, fp = (size_t)n_rays * n_fine;
  const Hand h{t_fi, sig_co, g_fi, g_fi + fp, g_fi + 2 * fp, g_fi + 3 * fp, gt_fi,
               gw_co, g_co, g_co + cp, g_co + 2 * cp, g_co + 3 * cp};
  return launch_merge(t_co, near, far, g_cco, g_cfi, res, h, c_fi, n_rays, n_coarse, n_fine,
                      white, static_cast<cudaStream_t>(stream));
}

// origins, dirs, g_cco, g_cfi: (n_rays, 3); t_co: (n_rays, n_coarse); near,
// far: (n_rays,); res: the residuals that render_fused_fwd wrote for these
// rays (render_fused_residual_floats(...) floats); grads: the 593,924
// weight and bias gradients in kernel 2's order (field_rays_bwd.cu);
// workspace: render_fused_bwd_workspace_floats(...) floats. All float32,
// contiguous, 16-byte aligned, on the current device. params, white, bf16:
// as for render_fused_fwd. Launches on `stream` and returns the first
// launch error, or 0.
int render_fused_bwd(const float* origins, const float* dirs, const float* t_co,
                     const float* near, const float* far, const float* g_cco,
                     const float* g_cfi, const void* const* params, const float* res,
                     float* grads, float* workspace, int n_rays, int n_coarse, int n_fine,
                     int white, int bf16, void* stream) {
  if (n_rays <= 0) return 0;
  if (render_fused_bwd_rays_per_block(n_coarse, n_fine) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = unpack_params(params);
  const long long b = n_rays, nm = std::max(n_coarse, n_fine);
  const Res r = carve_res(const_cast<float*>(res), b, n_coarse, n_fine);
  float* f = workspace + field_ws_floats(n_rays, n_coarse, n_fine);
  auto take = [&](long long n) { float* out = f; f += round4(n); return out; };
  Hand h;
  h.t_fi = r.t_fi;
  h.sig_co = r.sig_co;
  h.gs_fi = take(b * n_fine);
  h.gr_fi = take(b * n_fine);
  h.gg_fi = take(b * n_fine);
  h.gb_fi = take(b * n_fine);
  h.gt_fi = take(b * n_fine);
  h.gw_co = take(b * n_coarse);
  h.gs_co = take(b * n_coarse);
  h.gr_co = take(b * n_coarse);
  h.gg_co = take(b * n_coarse);
  h.gb_co = take(b * n_coarse);
  float* scratch = take(5 * b * n_coarse);
  float* d_ts = take(b * nm);
  float* d_o = take(3 * b);
  float* d_d = take(3 * b);

  // 1. the merge's backward from the residuals
  int e = launch_merge(t_co, near, far, g_cco, g_cfi, r, h, nullptr, n_rays, n_coarse, n_fine,
                       white, st);
  if (e != 0) return e;
  // 2. the fine field's backward at the residual t's, with d_ts
  e = field_bwd_run(origins, dirs, h.t_fi, h.gs_fi, h.gr_fi, h.gg_fi, h.gb_fi, p, d_o, d_d,
                    d_ts, grads, workspace, n_rays, n_fine, bf16 != 0, false, st);
  if (e != 0) return e;
  // 3. the resampler, the coarse composite and the density
  resample_bwd_kernel<<<(n_rays + 3) / 4, 128, 0, st>>>(t_co, near, far, d_ts, h, scratch,
                                                         n_rays, n_coarse, n_fine);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 4. the coarse field's backward, added to the fine one's
  return field_bwd_run(origins, dirs, t_co, h.gs_co, h.gr_co, h.gg_co, h.gb_co, p, d_o,
                       d_d, d_ts, grads, workspace, n_rays, n_coarse, bf16 != 0, true, st);
}

}  // extern "C"
