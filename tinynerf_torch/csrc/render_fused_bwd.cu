// The fused renderer's recompute backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces tinynerf/kernels/render_kernel.py::_fused_render_backward /
// _bwd_fine_kernel + _bwd_coarse_kernel (TPU kernel 10): given the rays of
// render_fused_fwd.cu and the cotangents g_cco, g_cfi (B, 3) of C_coarse
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
// Design. The TPU splits its backward in two launches only because one
// kernel overflowed Mosaic's VMEM stack; on Hopper a 64-row tile's
// activations (512 KB) do not fit in shared memory either, so the field's
// backward is kernel 2's own device code (field_bwd_common.cuh: recompute
// into a workspace, weight gradients over fixed row slices, an ordered
// reduce). One call is, all on `stream`:
// 1. tail_bwd_kernel, per block of whole rays: render_common.cuh's forward
//    (both field passes and the tail in shared memory, in kernel 9's blocks
//    and order, so its bits: the fine t's among them), then one thread a
//    ray for the merge's backward. It writes the hand-off planes: the fine
//    t's, the fine samples' (sigma, r, g, b) cotangents and their t
//    cotangents from the merge (B, N_f); the coarse sigma, the coarse color
//    term of the weight cotangent, and the coarse (sigma, r, g, b)
//    cotangents from both composites (B, N_c);
// 2. kernel 2 over the fine samples: its weight gradients into `grads`, and
//    d_ts (B, N_f);
// 3. resample_bwd_kernel, one warp a ray: the coarse weights, cdf and
//    fine-sample bins recomputed from the coarse sigma with kernel 9's
//    functions (the forward's bits), the resampler's, composite's and
//    density's backward, into the coarse sigma cotangent;
// 4. kernel 2 over the coarse samples, its weight gradients added to
//    `grads` in the same fixed order.
// No atomics: two calls are bit-identical.

#include "field_bwd_common.cuh"
#include "render_common.cuh"

namespace {

// The hand-off planes between the launches, ray-major.
struct Hand {
  float *t_fi, *gs_fi, *gr_fi, *gg_fi, *gb_fi, *gt_fi;   // (B, nf)
  float *sig_co, *gw_co, *gs_co, *gr_co, *gg_co, *gb_co; // (B, nc)
};

// The merge's backward for block ray r (device ray `ray`), after merge_fwd
// with `record`: the merged pass last sample first, into the hand-off
// planes. One thread.
__device__ void merge_bwd(const Tail& tl, const Hand& h, int r, int ray, int nc, int nf,
                          const float* __restrict__ g_cco, const float* __restrict__ g_cfi,
                          bool white) {
  const int K = nc + nf;
  const float g[3] = {g_cfi[3 * ray], g_cfi[3 * ray + 1], g_cfi[3 * ray + 2]};
  const float gc[3] = {g_cco[3 * ray], g_cco[3 * ray + 1], g_cco[3 * ray + 2]};
  // the white term (1 - sum w) adds -sum(g) to every weight's cotangent
  const float gsum = white ? __fadd_rn(__fadd_rn(g[0], g[1]), g[2]) : 0.f;
  const float gcsum = white ? __fadd_rn(__fadd_rn(gc[0], gc[1]), gc[2]) : 0.f;
  float* gt = tl.gt + r * nf;
  for (int m = 0; m < nf; ++m) gt[m] = 0.f;

  // merged pass, last sample first: g_A = -w g_w, g_sd = e exp(-sd) g_w
  // + sum_{k' >= k} g_A, g_sigma = delta g_sd, g_delta = sigma g_sd
  const int* order = tl.order + r * K;
  auto t_of = [&](int k) {
    return k < nc ? tl.t_co[r * nc + k] : tl.t_fi[r * nf + k - nc];
  };
  float rev = 0.f;
  for (int k = K - 1; k >= 0; --k) {
    const int cur = order[k];
    const bool co = cur < nc;
    const int at = co ? r * nc + cur : r * nf + cur - nc;
    const float sig = co ? tl.sig_co[at] : tl.sig_fi[at];
    const float delta = k + 1 < K ? __fsub_rn(t_of(order[k + 1]), t_of(cur)) : TAIL_DELTA;
    const float sd = __fmul_rn(delta, sig);
    const float w = tl.wm[r * K + k], e = tl.em[r * K + k];
    float gw = -gsum;
    for (int ch = 0; ch < 3; ++ch)
      gw = __fadd_rn(gw, __fmul_rn(co ? tl.col_co[ch][at] : tl.col_fi[ch][at], g[ch]));
    rev = __fadd_rn(rev, -__fmul_rn(w, gw));
    const float gsd = __fadd_rn(__fmul_rn(__fmul_rn(e, expf(-sd)), gw), rev);
    const float gsig = __fmul_rn(delta, gsd);
    if (k + 1 < K) {
      // delta = t_next - t_cur: only fine t's take a cotangent
      const float gdelta = __fmul_rn(sig, gsd);
      const int nxt = order[k + 1];
      if (nxt >= nc) gt[nxt - nc] = __fadd_rn(gt[nxt - nc], gdelta);
      if (!co) gt[cur - nc] = __fsub_rn(gt[cur - nc], gdelta);
    }
    const size_t gi = co ? (size_t)ray * nc + cur : (size_t)ray * nf + cur - nc;
    if (co) {
      // the coarse color's cotangent from both composites
      const float wc = tl.w_co[at];
      h.gs_co[gi] = gsig;
      h.gr_co[gi] = __fadd_rn(__fmul_rn(wc, gc[0]), __fmul_rn(w, g[0]));
      h.gg_co[gi] = __fadd_rn(__fmul_rn(wc, gc[1]), __fmul_rn(w, g[1]));
      h.gb_co[gi] = __fadd_rn(__fmul_rn(wc, gc[2]), __fmul_rn(w, g[2]));
    } else {
      h.gs_fi[gi] = gsig;
      h.gr_fi[gi] = __fmul_rn(w, g[0]);
      h.gg_fi[gi] = __fmul_rn(w, g[1]);
      h.gb_fi[gi] = __fmul_rn(w, g[2]);
    }
  }
  for (int m = 0; m < nf; ++m) {
    h.t_fi[(size_t)ray * nf + m] = tl.t_fi[r * nf + m];
    h.gt_fi[(size_t)ray * nf + m] = gt[m];
  }
  // the coarse composite's cotangent of each coarse weight
  for (int n = 0; n < nc; ++n) {
    const int at = r * nc + n;
    float gw = -gcsum;
    for (int ch = 0; ch < 3; ++ch) gw = __fadd_rn(gw, __fmul_rn(tl.col_co[ch][at], gc[ch]));
    h.sig_co[(size_t)ray * nc + n] = tl.sig_co[at];
    h.gw_co[(size_t)ray * nc + n] = gw;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(Geo<BF16>::THREADS, Geo<BF16>::BLOCKS)
tail_bwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const float* __restrict__ t_co, const float* __restrict__ near,
                const float* __restrict__ far, const float* __restrict__ g_cco,
                const float* __restrict__ g_cfi, Params p, Hand h, int n_rays,
                int nc, int nf, int rpb, int white) {
  using G = Geo<BF16>;
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<typename G::Smem*>(smem_raw);
  const Tail tl = carve_tail(reinterpret_cast<float*>(&s + 1), rpb, nc, nf, true);
  const int ray0 = blockIdx.x * rpb;
  const int nr = min(rpb, n_rays - ray0);
  PhaseClock clk;
  render_front<BF16>(s, tl, p, origins, dirs, t_co, near, far, ray0, nr, nc, nf,
                     white != 0, nullptr, clk);

  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += G::THREADS / 32) {
    float c[3];
    merge_fwd(tl, r, nc, nf, white != 0, c, true);
    if (lane == 0) merge_bwd(tl, h, r, ray0 + r, nc, nf, g_cco, g_cfi, white != 0);
    __syncwarp();
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

}  // namespace

extern "C" {

// Rays a block of the tail kernel's form takes, or 0 where one ray's state
// (the forward's and the merge's backward's) does not fit in a block's
// shared memory (the wrapper refuses those shapes by name).
int render_fused_bwd_rays_per_block(int n_coarse, int n_fine, int bf16) {
  if (n_coarse < 2 || n_fine < 1) return 0;
  return rays_per_block(bf16 != 0, n_coarse, n_fine, true);
}

// Bytes of dynamic shared memory one block of the tail kernel takes.
int render_fused_bwd_smem_bytes(int n_coarse, int n_fine, int bf16) {
  const int rpb = render_fused_bwd_rays_per_block(n_coarse, n_fine, bf16);
  return rpb == 0 ? 0 : (int)render_smem_bytes(bf16 != 0, rpb, n_coarse, n_fine, true);
}

// Float32 elements of workspace render_fused_bwd needs for these shapes.
long long render_fused_bwd_workspace_floats(int n_rays, int n_coarse, int n_fine) {
  if (n_rays <= 0) return 0;
  const long long b = n_rays, nm = std::max(n_coarse, n_fine);
  return field_ws_floats(n_rays, n_coarse, n_fine) + 6 * round4(b * n_fine) +
         11 * round4(b * n_coarse) + round4(b * nm) + 2 * round4(3 * b);
}

// origins, dirs, g_cco, g_cfi: (n_rays, 3); t_co: (n_rays, n_coarse); near,
// far: (n_rays,); grads: the 593,924 weight and bias gradients in kernel 2's
// order (field_rays_bwd.cu); workspace:
// render_fused_bwd_workspace_floats(...) floats; t_fi: null, or (n_rays,
// n_fine) for the fine t's that the tail hands to the fine field's backward
// (for checks). All float32, contiguous, 16-byte aligned, on the current
// device. params, white, bf16: as for render_fused_fwd. Launches on
// `stream` and returns the first launch error, or 0.
int render_fused_bwd(const float* origins, const float* dirs, const float* t_co,
                     const float* near, const float* far, const float* g_cco,
                     const float* g_cfi, const void* const* params, float* grads,
                     float* workspace, float* t_fi, int n_rays, int n_coarse, int n_fine,
                     int white, int bf16, void* stream) {
  if (n_rays <= 0) return 0;
  const int rpb = render_fused_bwd_rays_per_block(n_coarse, n_fine, bf16);
  if (rpb == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = render_smem_bytes(bf16 != 0, rpb, n_coarse, n_fine, true);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p = unpack_params(params);
  if (bf16) {
    // the tail's forward reads the packed weights where kernel 2 packs them
    __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(workspace);
    p.wb = wb;
    const int e = pack_weights(p, wb, st, false);
    if (e != 0) return e;
  }

  const long long b = n_rays, nm = std::max(n_coarse, n_fine);
  float* f = workspace + field_ws_floats(n_rays, n_coarse, n_fine);
  auto take = [&](long long n) { float* out = f; f += round4(n); return out; };
  Hand h;
  h.t_fi = take(b * n_fine);
  h.gs_fi = take(b * n_fine);
  h.gr_fi = take(b * n_fine);
  h.gg_fi = take(b * n_fine);
  h.gb_fi = take(b * n_fine);
  h.gt_fi = take(b * n_fine);
  h.sig_co = take(b * n_coarse);
  h.gw_co = take(b * n_coarse);
  h.gs_co = take(b * n_coarse);
  h.gr_co = take(b * n_coarse);
  h.gg_co = take(b * n_coarse);
  h.gb_co = take(b * n_coarse);
  float* scratch = take(5 * b * n_coarse);
  float* d_ts = take(b * nm);
  float* d_o = take(3 * b);
  float* d_d = take(3 * b);

  // 1. the forward and the merge's backward
  auto tail = bf16 ? &tail_bwd_kernel<true> : &tail_bwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(tail, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = bf16 ? Geo<true>::THREADS : Geo<false>::THREADS;
  tail<<<(n_rays + rpb - 1) / rpb, threads, smem, st>>>(origins, dirs, t_co, near, far,
                                                       g_cco, g_cfi, p, h, n_rays,
                                                       n_coarse, n_fine, rpb, white);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (t_fi != nullptr &&
      (err = cudaMemcpyAsync(t_fi, h.t_fi, sizeof(float) * b * n_fine,
                             cudaMemcpyDeviceToDevice, st)) != cudaSuccess)
    return (int)err;
  // 2. the fine field's backward, with d_ts
  int e = field_bwd_run(origins, dirs, h.t_fi, h.gs_fi, h.gr_fi, h.gg_fi, h.gb_fi, p, d_o,
                        d_d, d_ts, grads, workspace, n_rays, n_fine, bf16 != 0, false, st);
  if (e != 0) return e;
  // 3. the resampler, the coarse composite and the density
  resample_bwd_kernel<<<(n_rays + 3) / 4, 128, 0, st>>>(t_co, near, far, d_ts, h, scratch,
                                                         n_rays, n_coarse, n_fine);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. the coarse field's backward, added to the fine one's
  return field_bwd_run(origins, dirs, t_co, h.gs_co, h.gr_co, h.gg_co, h.gb_co, p, d_o,
                       d_d, d_ts, grads, workspace, n_rays, n_coarse, bf16 != 0, true, st);
}

}  // extern "C"
