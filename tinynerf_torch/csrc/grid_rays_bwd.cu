// Ray-major CP grid field backward (recompute VJP) for Hopper (sm_90a), plain
// C interface.
//
// Replaces tinynerf/kernels/grid_kernel.py::_fused_ray_backward / _bwd_kernel,
// the TPU kernel behind the custom VJP of grid_field_pallas_rays
// (GRID_PALLAS). Given the rays (origins, dirs (B, 3), ts (B, N)), the
// direction encoding de (B, 24) and the four (B, N) cotangents of (sigma, r,
// g, b), it recomputes the forward of grid_rays_fwd.cu and returns, all
// float32: d_origins, d_dirs (B, 3; the direction's share through the point
// only, the encoding's comes back as d_de), d_ts (B, N), d_de (B, 24), and
// the gradients of the three line tables, W1, b1, W2 and b2. The extent gets
// none (frozen geometry; the caller gives it zeros).
//
// The VJP, with JAX's sub-gradient conventions (abs'(0) = +1, relu'(0) = 0,
// clip's 0.5 at an exact boundary) and, with BF16, the TPU kernel's casts
// (g_h, g_app, the sigma cotangent, each pair product and each d f_a rounded;
// every weight and table gradient accumulated in float32):
//   gp_c   = g_c * c * (1 - c);  dW2 += h^T gp;  db2 += sum gp
//   g_h    = rnd((gp . W2^T) * [h_pre > 0]);  dW1 += hin^T g_h;  db1 += sum g_h
//   g_in   = g_h W1^T;  d_de = sum over the ray's samples of g_in[:, :24]
//   dprod  = [rnd(g_sigma * sign(sigma_pre)) x Fd, rnd(g_in[:, 24:])]
//   df_a   = rnd(dprod * rnd(f_b * f_c));  dT_a[i0] += w0 df_a, dT_a[i1] += w1 df_a
//   d xg_a = -(df_a . T_a[i0]) [1 - |xg - i0| > 0] + (df_a . T_a[i1]) [1 - |xg - i1| > 0]
//   d p_a  = d xg_a * clip'(raw) * (R - 1) / 2E
//   d_ts   = d p . d;  d_o = sum_n d p;  d_d = sum_n d p * t
//
// What bounds it: at the card's rates, FLOPs (three times the forward's; in
// the bf16 form the decoder's products on the tensor cores and the rest at
// the float32 FMA rate). What holds it is latency: the table gathers (L2,
// twice a row: the recompute and the coordinates), the table gradient's
// read-modify-writes of the block's partial (L2 at the fine geometry), and
// the chains of shared-memory sums.
//
// Design, two launches on `stream` (three with the bf16 form's table
// packing), no atomics, so a call is deterministic:
// 1. `slices` blocks (132 per block a multiprocessor holds at once: a
//    function of the dimensions and the build), block s owning a fixed
//    slice of whole rays. Each stages W1/W2, zeroes its partial of the
//    table gradients, and walks its rows in tiles (grid_common.cuh: 64 rows
//    bf16, 32 fp32): recompute (keeping the line features), then the chain
//    above.
//    - The decoder's gradients (dW1, db1, dW2, db2) stay in shared memory,
//      float32, over the whole slice, and go to the block's partial once at
//      the end. bf16: dW1 += hin^T g_h and g_in = g_h W1^T on the tensor
//      cores (mma_unit), each warp owning fixed 16 x 16 output units; fp32:
//      FMAs, each element by its owner thread, rows in order.
//    - The table gradient: thread t owns the columns (axis, f) t and t +
//      threads (one at the proposal grid and the fine grid: threads_for)
//      and walks the tile's rows in order. Along a ray i0 is monotonic, so
//      a run of rows in one cell sums in registers (Run), the run's upper
//      tap carried into the next cell's lower tap; a run reads its two
//      partial rows when it starts and writes them when it ends. The
//      partial is in shared memory where it fits (the proposal grid's 24
//      KB), else in the workspace (393 KB a block at the fine geometry).
//    - Per-row d p and g_in[:, :24] go to the workspace; at the end the block
//      sums them per ray, in sample order, into d_o, d_d and d_de.
// 2. reduce: the slices' partials summed in slice order.

#include "grid_common.cuh"

namespace {

constexpr int SLICES = 132;        // blocks of the first launch per resident block an SM
constexpr int MAX_COLS = (3 * MAX_F + MAX_THREADS - 1) / MAX_THREADS;  // table-gradient columns a thread owns (threads_for)

// Gradient layout (flat, float32): tx, ty, tz (res * F each), W1 (K * W),
// b1 (W), W2 (W * 3), b2 (3).
struct GradLayout {
  long long table, w1, b1, w2, b2, total;
  __host__ __device__ explicit GradLayout(const Dims& dm) {
    const long long RF = (long long)dm.res * dm.F(), W = dm.width;
    table = 0;
    w1 = 3 * RF;
    b1 = w1 + (long long)dm.K() * W;
    w2 = b1 + W;
    b2 = w2 + 3 * W;
    total = b2 + 3;
  }
};

template <bool BF16>
struct BwdLayout {
  using Act = typename Form<BF16>::Act;
  static constexpr int TILE = Form<BF16>::TILE;
  TileBufs<BF16> t;
  Act* gh;      // g_h [TILE][gh stride]
  Act* feats;   // [3][TILE][F]
  Act* dprod;   // [TILE][F], in h_pre's place where it fits there
  float *gsig, *gp, *dpt;
  float* dw1;   // dW1 [kin][wout]
  float* db1;   // [wout]
  float* dw2;   // [wout * 3]
  float* db2;   // [3]
  float* dtab;  // the table gradients' partial [3][res][F] when it fits, else null
  size_t bytes;
  __host__ __device__ BwdLayout(const Dims& dm, Carver c) : t(dm, c, true) {
    const Strides<BF16> s(dm);
    const int F = dm.F();
    // h_pre is read for the last time before dprod is written
    dprod = (size_t)F * sizeof(Act) <= (size_t)s.hp * sizeof(float)
                ? reinterpret_cast<Act*>(t.hp) : c.take<Act>((size_t)TILE * F);
    gh = c.take<Act>((size_t)TILE * s.gh);
    feats = c.take<Act>((size_t)3 * TILE * F);
    gsig = c.take<float>(TILE);
    gp = c.take<float>(TILE * 3);
    dpt = c.take<float>(TILE * 3);
    dw1 = c.take<float>((size_t)s.kin * s.wout);
    db1 = c.take<float>(s.wout);
    dw2 = c.take<float>((size_t)s.wout * 3);
    db2 = c.take<float>(3);
    const size_t q = c.q, n_tab = (size_t)3 * dm.res * F;
    dtab = c.take<float>(n_tab);
    if (c.q > (size_t)MAX_SMEM) {  // the partial goes to the workspace
      c.q = q;
      dtab = nullptr;
    }
    bytes = c.q;
  }
};

template <bool BF16>
size_t bwd_smem(const Dims& dm) {
  return BwdLayout<BF16>(dm, Carver(nullptr)).bytes;
}

// The table-gradient partial of one column (axis, f): its run of rows with
// the same cell, summed in registers. A run's two partial rows are read when
// it starts, so the reads are in flight while the run lasts, and written
// back when it ends (the same thread, so a later read sees the write).
// `col` points at the column's row 0; rows are F floats apart.
struct Run {
  int lo, hi;        // the run's cell: its lower and upper tap rows (-1: none)
  float a_lo, a_hi;  // their sums so far
  float o_lo, o_hi;  // the partial's values at lo and hi when the run started

  __device__ void init() {
    lo = hi = -1;
    a_lo = a_hi = o_lo = o_hi = 0.f;
  }
  __device__ __forceinline__ void flush(float* col, int F) {
    if (lo < 0) return;
    if (lo == hi) {  // the clamped cell at R - 1: one row
      col[(size_t)lo * F] = o_lo + (a_lo + a_hi);
    } else {
      col[(size_t)lo * F] = o_lo + a_lo;
      col[(size_t)hi * F] = o_hi + a_hi;
    }
  }
  // One sample row's taps (i0, i1 = min(i0 + 1, R - 1)) with the
  // contributions c0, c1.
  __device__ __forceinline__ void add(float* col, int F, int i0, int i1, float c0, float c1) {
    if (i0 == lo) {  // the same cell
      a_lo += c0;
      a_hi += c1;
    } else if (i0 == hi) {  // the next cell: the upper tap row becomes the lower
      col[(size_t)lo * F] = o_lo + a_lo;  // the finished lower row
      lo = hi;
      o_lo = o_hi;
      a_lo = a_hi + c0;
      hi = i1;
      a_hi = c1;
      o_hi = i1 != i0 ? col[(size_t)i1 * F] : 0.f;
    } else {
      flush(col, F);
      lo = i0;
      hi = i1;
      a_lo = c0;
      a_hi = c1;
      o_lo = col[(size_t)i0 * F];
      o_hi = i1 != i0 ? col[(size_t)i1 * F] : 0.f;
    }
  }
  __device__ void finish(float* col, int F) {
    flush(col, F);
    init();
  }
};

struct Cotangents {
  const float* __restrict__ sigma;
  const float* __restrict__ c[3];  // r, g, b
};

struct Outputs {
  float* d_o;     // (B, 3)
  float* d_d;     // (B, 3)
  float* d_ts;    // (B, N)
  float* d_de;    // (B, 24)
};

// Workspace: the slices' partial gradients, then per sample row d p (3) and
// g_in[:, :24] (24), then the bf16 form's packed tables.
struct Workspace {
  float* partials;
  float* dpt;
  float* gde;
};

template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
grid_rays_bwd_kernel(Rays rays, Cotangents cot, GridParams p, Dims dm, Outputs out,
                     Workspace ws, int n_rays) {
  using Act = typename Form<BF16>::Act;
  constexpr int TILE = Form<BF16>::TILE;
  extern __shared__ float4 smem_raw[];
  const BwdLayout<BF16> L(dm, Carver(smem_raw));
  const TileBufs<BF16>& T = L.t;
  const Strides<BF16> S(dm);
  const GradLayout G(dm);
  const int N = rays.n_samples, F = dm.F(), W = dm.width, K = dm.K();
  const int nd = dm.nd, res = dm.res;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray0 = (long long)n_rays * blockIdx.x / gridDim.x;
  const long long ray1 = (long long)n_rays * (blockIdx.x + 1) / gridDim.x;
  const long long row_begin = ray0 * N, row_end = ray1 * N;
  float* part = ws.partials + (long long)blockIdx.x * G.total;
  float* dtab = L.dtab != nullptr ? L.dtab : part;

  PhaseClock clk;
  for (long long i = threadIdx.x; i < 3LL * res * F; i += nthreads()) dtab[i] = 0.f;
  for (int i = threadIdx.x; i < S.kin * S.wout; i += nthreads()) L.dw1[i] = 0.f;
  for (int i = threadIdx.x; i < S.wout * 4 + 3; i += nthreads())
    (i < S.wout ? L.db1[i] : i < S.wout * 4 ? L.dw2[i - S.wout] : L.db2[i - S.wout * 4]) = 0.f;
  Run runs[MAX_COLS];
  int pair[MAX_COLS];  // this thread's table-gradient columns, a * F + f
#pragma unroll
  for (int s = 0; s < MAX_COLS; ++s) {
    runs[s].init();
    pair[s] = threadIdx.x + s * nthreads();
  }

  stage_decoder<BF16>(p, dm, T);  // ends with a barrier: the zeroes are in
  const Tables<BF16> tabs(p, dm);
  const float ext = __ldg(p.ext);
  const float scale = __fdiv_rn((float)(res - 1), __fmul_rn(2.f, ext));

  for (long long base = row_begin; base < row_end; base += TILE) {
    const int valid = row_end - base < TILE ? (int)(row_end - base) : TILE;

    // ---- recompute the forward ----
    load_tile<BF16, true>(rays, tabs, dm, ext, base, row_end, T, L.feats);
    for (int r = threadIdx.x; r < TILE; r += nthreads()) {
      const float s = T.sig[r];
      const float sgn = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
      L.gsig[r] = r < valid ? __ldg(cot.sigma + base + r) * sgn : 0.f;
    }
    hidden_layer<BF16>(p, dm, T);
    for (int r = warp; r < TILE; r += nwarps()) {
      float col[3];
      row_color<BF16>(p, dm, T, r, col);
      if (lane < 3) {
        const float y = col[lane];
        L.gp[r * 3 + lane] = r < valid ? (__ldg(cot.c[lane] + base + r) * y) * (1.f - y) : 0.f;
      }
    }
    __syncthreads();
    clk.mark(0);

    // ---- the color head: dW2, db2 (each element by its owner, rows in order) ----
    for (int e = threadIdx.x; e < W * 3 + 3; e += nthreads()) {
      float s = 0.f;
      if (e < W * 3) {
        const int j = e / 3, c = e % 3;
        for (int r = 0; r < valid; ++r) s = fmaf(fmaxf(T.hp[r * S.hp + j], 0.f), L.gp[r * 3 + c], s);
        L.dw2[e] += s;
      } else {
        for (int r = 0; r < valid; ++r) s += L.gp[r * 3 + e - W * 3];
        L.db2[e - W * 3] += s;
      }
    }
    // ---- the hidden layer's relu: g_h ----
    for (int idx = threadIdx.x; idx < TILE * S.wout; idx += nthreads()) {
      const int r = idx / S.wout, j = idx % S.wout;
      float g = L.gp[r * 3] * T.w2s[j * 3];
      g += L.gp[r * 3 + 1] * T.w2s[j * 3 + 1];
      g += L.gp[r * 3 + 2] * T.w2s[j * 3 + 2];
      L.gh[r * S.gh + j] = from_f<Act>(T.hp[r * S.hp + j] > 0.f ? rnd<BF16>(g) : 0.f);
    }
    __syncthreads();
    // ---- db1, dW1 += hin^T g_h ----
    for (int j = threadIdx.x; j < W; j += nthreads()) {
      float s = 0.f;
      for (int r = 0; r < valid; ++r) s += to_f(L.gh[r * S.gh + j]);
      L.db1[j] += s;
    }
    if constexpr (BF16) {
      const int mt = S.kin / 16, units = mt * (S.wout / 16);
      for (int u = warp; u < units; u += nwarps()) {
        const int m0 = (u % mt) * 16, n0 = (u / mt) * 16;
        float acc[2][4] = {};
        mma_unit<true, true>(acc, T.hin, S.hin, m0, L.gh, S.gh, n0, TILE / 16);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            L.dw1[(m0 + unit_row(q)) * S.wout + n0 + unit_col(h, q)] += acc[h][q];
      }
    } else {
      for (int e = threadIdx.x; e < K * W; e += nthreads()) {
        const int k = e / W, j = e % W;
        float s = 0.f;
        for (int r = 0; r < valid; ++r) s = fmaf(T.hin[r * S.hin + k], L.gh[r * S.gh + j], s);
        L.dw1[e] += s;
      }
    }
    __syncthreads();  // h_pre and hin are read for the last time above
    clk.mark(1);

    // ---- into the CP product: g_in = g_h W1^T ----
    if constexpr (BF16) {
      const int mt = TILE / 16, units = mt * (S.kin / 16);
      for (int u = warp; u < units; u += nwarps()) {
        const int m0 = (u % mt) * 16, n0 = (u / mt) * 16;
        float acc[2][4] = {};
        mma_unit<false, false>(acc, L.gh, S.gh, m0, T.w1s, S.w1, n0, S.wout / 16);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = m0 + unit_row(q), k = n0 + unit_col(h, q);
            if (k < DIR_ENC) {
              if (r < valid) ws.gde[(base + r) * DIR_ENC + k] = acc[h][q];
            } else if (k < K) {
              L.dprod[r * F + nd + k - DIR_ENC] = from_f<Act>(rnd<BF16>(acc[h][q]));
            }
          }
      }
    } else {
      for (int idx = threadIdx.x; idx < TILE * K; idx += nthreads()) {
        const int r = idx / K, k = idx % K;
        float s = 0.f;
        for (int j = 0; j < W; ++j) s = fmaf(L.gh[r * S.gh + j], T.w1s[k * S.w1 + j], s);
        if (k < DIR_ENC) {
          if (r < valid) ws.gde[(base + r) * DIR_ENC + k] = s;
        } else {
          L.dprod[r * F + nd + k - DIR_ENC] = s;
        }
      }
    }
    for (int idx = threadIdx.x; idx < TILE * nd; idx += nthreads())
      L.dprod[(idx / nd) * F + idx % nd] = from_f<Act>(rnd<BF16>(L.gsig[idx / nd]));
    __syncthreads();
    clk.mark(2);

    // ---- the table gradients: column (axis, f) by its owner, rows in order ----
#pragma unroll
    for (int s = 0; s < MAX_COLS; ++s) {
      if (pair[s] < 3 * F) {
        const int a = pair[s] / F, f = pair[s] % F;
        const Act* fb = L.feats + ((a == 0 ? 1 : 0) * TILE) * F + f;
        const Act* fc = L.feats + ((a == 2 ? 1 : 2) * TILE) * F + f;
        float* col = dtab + (long long)a * res * F + f;
        for (int r = 0; r < valid; ++r) {
          const float dfa = rnd<BF16>(to_f(L.dprod[r * F + f]) *
                                      rnd<BF16>(to_f(fb[r * F]) * to_f(fc[r * F])));
          const int t = r * 3 + a;
          runs[s].add(col, F, T.tp.i0[t], T.tp.i1[t], T.tp.w0[t] * dfa, T.tp.w1[t] * dfa);
        }
      }
    }
    clk.mark(3);

    // ---- the coordinates: one warp a row, its three axes together ----
    for (int r = warp; r < valid; r += nwarps()) {
      int i0[3], i1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        i0[a] = T.tp.i0[r * 3 + a];
        i1[a] = T.tp.i1[r * 3 + a];
      }
      float du0[3] = {0.f, 0.f, 0.f}, du1[3] = {0.f, 0.f, 0.f};
      for_columns<BF16>(tabs, F, i0, i1, lane, [&](int f, const float (&v0)[3],
                                                   const float (&v1)[3]) {
        const float fa0 = to_f(L.feats[r * F + f]);
        const float fa1 = to_f(L.feats[(TILE + r) * F + f]);
        const float fa2 = to_f(L.feats[(2 * TILE + r) * F + f]);
        const float dp = to_f(L.dprod[r * F + f]);
        const float pairs[3] = {rnd<BF16>(fa1 * fa2), rnd<BF16>(fa0 * fa2),
                                rnd<BF16>(fa0 * fa1)};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float dfa = rnd<BF16>(dp * pairs[a]);
          du0[a] = fmaf(dfa, v0[a], du0[a]);
          du1[a] = fmaf(dfa, v1[a], du1[a]);
        }
      });
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        du0[a] = warp_sum(du0[a]);
        du1[a] = warp_sum(du1[a]);
      }
      if (lane < 3) {
        const int ra = r * 3 + lane;
        const float u0 = lane == 0 ? du0[0] : lane == 1 ? du0[1] : du0[2];
        const float u1 = lane == 0 ? du1[0] : lane == 1 ? du1[1] : du1[2];
        const float dxg = -u0 * T.tp.m0[ra] + u1 * T.tp.m1[ra];
        L.dpt[ra] = __fmul_rn(__fmul_rn(dxg, T.tp.clip_grad[ra]), scale);
      }
    }
    __syncthreads();

    // ---- to the ray: d_ts = d p . d; d p kept for the per-ray sums ----
    for (int r = threadIdx.x; r < valid; r += nthreads()) {
      const long long m = base + r, ray = m / N;
      const float* d = rays.dirs + 3 * ray;
      out.d_ts[m] = __fadd_rn(__fadd_rn(__fmul_rn(L.dpt[r * 3], __ldg(d)),
                                        __fmul_rn(L.dpt[r * 3 + 1], __ldg(d + 1))),
                              __fmul_rn(L.dpt[r * 3 + 2], __ldg(d + 2)));
      for (int a = 0; a < 3; ++a) ws.dpt[m * 3 + a] = L.dpt[r * 3 + a];
    }
    __syncthreads();  // the next tile overwrites the shared tile
    clk.mark(4);
  }

  // the runs' last rows, then the decoder's (and a shared partial's) sums
#pragma unroll
  for (int s = 0; s < MAX_COLS; ++s)
    if (pair[s] < 3 * F)
      runs[s].finish(dtab + (long long)(pair[s] / F) * res * F + pair[s] % F, F);
  __syncthreads();
  if (L.dtab != nullptr)
    for (long long i = threadIdx.x; i < 3LL * res * F; i += nthreads()) part[i] = L.dtab[i];
  for (int e = threadIdx.x; e < K * W; e += nthreads())
    part[G.w1 + e] = L.dw1[(e / W) * S.wout + e % W];
  for (int j = threadIdx.x; j < W; j += nthreads()) part[G.b1 + j] = L.db1[j];
  for (int e = threadIdx.x; e < W * 3; e += nthreads()) part[G.w2 + e] = L.dw2[e];
  if (threadIdx.x < 3) part[G.b2 + threadIdx.x] = L.db2[threadIdx.x];

  // per-ray sums over the block's own rows, in sample order (written above
  // by this block: read through L2)
  const int per_ray = 6 + DIR_ENC;
  for (long long task = threadIdx.x; task < (ray1 - ray0) * per_ray; task += nthreads()) {
    const long long ray = ray0 + task / per_ray;
    const int c = (int)(task % per_ray);
    float s = 0.f;
    for (int n0 = 0; n0 < N; n0 += 8) {  // eight loads in flight, summed in order
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long m = ray * N + n0 + i;
        v[i] = n0 + i >= N ? 0.f
             : c < 3 ? __ldcg(ws.dpt + m * 3 + c)
             : c < 6 ? __ldcg(ws.dpt + m * 3 + c - 3) * __ldg(rays.ts + m)
                     : __ldcg(ws.gde + m * DIR_ENC + c - 6);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (n0 + i < N) s += v[i];
    }
    if (c < 3) out.d_o[ray * 3 + c] = s;
    else if (c < 6) out.d_d[ray * 3 + c - 3] = s;
    else out.d_de[ray * DIR_ENC + c - 6] = s;
  }
  clk.mark(5);
}

// grads[i] = sum over slices, in slice order, of partials[slice][i].
__global__ void reduce_kernel(const float* __restrict__ partials, int slices,
                              long long n, float* __restrict__ grads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = partials[i];
  for (int s = 1; s < slices; ++s) v += partials[(long long)s * n + i];
  grads[i] = v;
}

// Blocks of the first launch: SLICES for each block a multiprocessor holds
// at once (its shared memory and registers; a function of the dimensions
// and the build, so two calls slice alike), at most one a ray. Returns
// -1 on a CUDA error.
int slices_for(const Dims& dm, int n_rays, int use_bf16) {
  const size_t smem = use_bf16 ? bwd_smem<true>(dm) : bwd_smem<false>(dm);
  auto kernel = use_bf16 ? &grid_rays_bwd_kernel<true> : &grid_rays_bwd_kernel<false>;
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads_for(dm), smem) !=
          cudaSuccess)
    return -1;
  return std::max(1, std::min(n_rays, SLICES * std::max(per_sm, 1)));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the first launch takes.
int grid_rays_bwd_smem_bytes(int res, int nd, int na, int width, int use_bf16) {
  const Dims dm{res, nd, na, width};
  return (int)(use_bf16 ? bwd_smem<true>(dm) : bwd_smem<false>(dm));
}

// Float32 elements of the flat gradient: 3 * res * F + K * W + W + 3 W + 3.
long long grid_rays_bwd_grad_floats(int res, int nd, int na, int width) {
  return GradLayout(Dims{res, nd, na, width}).total;
}

// Float32 elements of workspace grid_rays_bwd needs for these shapes (-1
// where it does not take them, or on a CUDA error).
long long grid_rays_bwd_workspace_floats(int n_rays, int n_samples, int res, int nd,
                                         int na, int width, int use_bf16) {
  if (n_rays <= 0 || n_samples <= 0) return 0;
  const Dims dm{res, nd, na, width};
  if (check_dims(dm) != 0 || (use_bf16 ? bwd_smem<true>(dm) : bwd_smem<false>(dm)) >
                                 (size_t)MAX_SMEM)
    return -1;
  const int slices = slices_for(dm, n_rays, use_bf16);
  if (slices < 0) return -1;
  const long long front = (long long)slices * GradLayout(dm).total +
                          (long long)n_rays * n_samples * (3 + DIR_ENC);
  return (front + 3) / 4 * 4 + (use_bf16 ? packed_table_elems(dm) / 2 : 0);
}

// origins, dirs, d_o, d_d: (n_rays, 3); ts, the cotangents g_* and d_ts:
// (n_rays, n_samples); de, d_de: (n_rays, 24); grads: the flat gradient
// (grid_rays_bwd_grad_floats: tx, ty, tz, W1, b1, W2, b2); workspace:
// grid_rays_bwd_workspace_floats(...) floats, 16-byte aligned. All float32,
// contiguous, on the current device. params, dims, use_bf16: as for
// grid_rays_fwd. Launches on `stream` and returns the first launch error,
// or 0.
int grid_rays_bwd(const float* origins, const float* dirs, const float* ts,
                  const float* de, const float* g_sigma, const float* g_r,
                  const float* g_g, const float* g_b, const void* const* params,
                  float* d_o, float* d_d, float* d_ts, float* d_de, float* grads,
                  float* workspace, int n_rays, int n_samples, int res, int nd, int na,
                  int width, int use_bf16, void* stream) {
  const Dims dm{res, nd, na, width};
  if (int bad = check_dims(dm)) return bad;
  if (n_rays <= 0 || n_samples <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = use_bf16 ? bwd_smem<true>(dm) : bwd_smem<false>(dm);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = use_bf16 ? &grid_rays_bwd_kernel<true> : &grid_rays_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = slices_for(dm, n_rays, use_bf16);
  if (slices < 0) return (int)cudaGetLastError();
  const long long n_grad = GradLayout(dm).total;
  Workspace ws;
  ws.partials = workspace;
  ws.dpt = workspace + slices * n_grad;
  ws.gde = ws.dpt + (long long)n_rays * n_samples * 3;
  const long long front = slices * n_grad + (long long)n_rays * n_samples * (3 + DIR_ENC);
  auto* tab16 = reinterpret_cast<__nv_bfloat16*>(workspace + (front + 3) / 4 * 4);
  if (use_bf16) {
    if (int e = pack_tables(params, dm, tab16, st)) return e;
  }
  const GridParams p = unpack_grid_params(params, tab16);
  kernel<<<slices, threads_for(dm), smem, st>>>(
      Rays{origins, dirs, ts, de, n_samples}, Cotangents{g_sigma, {g_r, g_g, g_b}}, p,
      dm, Outputs{d_o, d_d, d_ts, d_de}, ws, n_rays);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<(int)ceil_div(n_grad, 256), 256, 0, st>>>(
      workspace, slices, n_grad, grads);
  return (int)cudaGetLastError();
}

#ifdef GRID_PHASE_CLOCKS
// Copy the phase clocks (MAX_PHASE_BLOCKS x N_PHASES int64) to host memory
// and zero them. Returns a CUDA error, or 0.
int grid_rays_bwd_phase_clocks(long long* out) {
  const size_t bytes = sizeof(long long) * MAX_PHASE_BLOCKS * N_PHASES;
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_clocks, bytes);
  if (err != cudaSuccess) return (int)err;
  static long long zeros[MAX_PHASE_BLOCKS * N_PHASES];
  return (int)cudaMemcpyToSymbol(phase_clocks, zeros, bytes);
}
#endif

}  // extern "C"
