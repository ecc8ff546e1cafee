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
// What bounds it: at the card's rates, FLOPs (three times the forward's);
// what holds this kernel is the same shared-memory and L2 traffic as the
// forward's, plus the table gradient: a scatter-add of two rows per axis per
// sample row, which is latency-bound read-modify-write in L2.
//
// Design (a simple first kernel), two launches on `stream`, no atomics, so
// a call is deterministic:
// 1. SLICES = 132 blocks, block s owning a fixed slice of whole rays. Each
//    stages W1/W2, zeroes its own float32 partial of every parameter
//    gradient in the workspace, and walks its rows in 32-row tiles:
//    recompute (grid_common.cuh, keeping the line features), then the
//    chain above. Each thread owns fixed gradient elements (table
//    gradients: an (axis, feature) column over every row of the table;
//    decoder gradients: fixed elements), so no two threads add to one
//    address and every sum runs in row order. Per-row d p and g_in[:, :24]
//    go to the workspace; at the end the block sums them per ray, in
//    sample order, into d_o, d_d and d_de.
// 2. reduce: the slices' partials summed in slice order.
// Keeping the partial tables in shared memory (they do not fit at the fine
// geometry: 393 KB), or merging a run of rows before each read-modify-write,
// is later work.

#include <algorithm>

#include "grid_common.cuh"

namespace {

constexpr int SLICES = 132;  // blocks of the first launch (fixed: deterministic sums)

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

struct BwdLayout {
  float *w1s, *w2s, *x, *feats, *hp, *gh, *gsig, *gp, *dpt;
  TileTaps tp;
  size_t bytes;
  __host__ __device__ BwdLayout(const Dims& dm, float* base) {
    const int W = dm.width, F = dm.F();
    size_t q = 0;
    w1s = carve(base, q, (size_t)dm.K() * (W + 1));
    w2s = carve(base, q, (size_t)W * 3);
    x = carve(base, q, (size_t)TILE * dm.XS());
    feats = carve(base, q, (size_t)3 * TILE * F);
    hp = carve(base, q, (size_t)TILE * (W > F ? W : F));  // h_pre, later dprod
    gh = carve(base, q, (size_t)TILE * W);
    gsig = carve(base, q, TILE);
    gp = carve(base, q, TILE * 3);
    dpt = carve(base, q, TILE * 3);
    tp.w0 = carve(base, q, TILE * 3);
    tp.w1 = carve(base, q, TILE * 3);
    tp.m0 = carve(base, q, TILE * 3);
    tp.m1 = carve(base, q, TILE * 3);
    tp.clip_grad = carve(base, q, TILE * 3);
    tp.i0 = reinterpret_cast<int*>(carve(base, q, TILE * 3));
    tp.i1 = reinterpret_cast<int*>(carve(base, q, TILE * 3));
    bytes = q * sizeof(float);
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

// Workspace: SLICES partial gradients, then per sample row d p (3) and
// g_in[:, :24] (24).
struct Workspace {
  float* partials;
  float* dpt;
  float* gde;
};

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
grid_rays_bwd_kernel(Rays rays, Cotangents cot, GridParams p, Dims dm, Outputs out,
                     Workspace ws, int n_rays) {
  extern __shared__ float4 smem_raw[];
  BwdLayout L(dm, reinterpret_cast<float*>(smem_raw));
  const GradLayout G(dm);
  const int N = rays.n_samples, F = dm.F(), W = dm.width, K = dm.K(), XS = dm.XS();
  const int nd = dm.nd, res = dm.res;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray0 = (long long)n_rays * blockIdx.x / gridDim.x;
  const long long ray1 = (long long)n_rays * (blockIdx.x + 1) / gridDim.x;
  const long long row_begin = ray0 * N, row_end = ray1 * N;
  float* part = ws.partials + (long long)blockIdx.x * G.total;
  const long long n_dec = G.total - G.w1;

  // zero this slice's partial: every element by the thread that owns it
  for (int pair = threadIdx.x; pair < 3 * F; pair += THREADS)
    for (int i = 0; i < res; ++i) part[((long long)(pair / F) * res + i) * F + pair % F] = 0.f;
  for (long long e = threadIdx.x; e < n_dec; e += THREADS) part[G.w1 + e] = 0.f;

  stage_decoder<BF16>(p, dm, L.w1s, L.w2s);
  const float ext = __ldg(p.ext);
  const float scale = __fdiv_rn((float)(res - 1), __fmul_rn(2.f, ext));

  for (long long base = row_begin; base < row_end; base += TILE) {
    const int valid = row_end - base < TILE ? (int)(row_end - base) : TILE;

    // ---- recompute the forward ----
    load_tile<BF16, true>(rays, p, dm, ext, base, row_end, L.x, L.tp, L.feats);
    for (int r = warp; r < TILE; r += THREADS / 32) {
      const float s = row_sigma_pre(dm, L.x, r);
      if (lane == 0) {
        const float sgn = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
        L.gsig[r] = r < valid ? __ldg(cot.sigma + base + r) * sgn : 0.f;
      }
    }
    hidden_layer(p, dm, L.x, L.w1s, L.hp);
    for (int r = warp; r < TILE; r += THREADS / 32) {
      float col[3];
      row_color<BF16>(p, dm, L.hp, L.w2s, r, col);
      if (lane < 3) {
        const float y = col[lane];
        L.gp[r * 3 + lane] = r < valid ? (__ldg(cot.c[lane] + base + r) * y) * (1.f - y) : 0.f;
      }
    }
    __syncthreads();

    // ---- the color head and the hidden layer's relu ----
    for (int idx = threadIdx.x; idx < TILE * W; idx += THREADS) {
      const int r = idx / W, j = idx % W;
      float g = L.gp[r * 3] * L.w2s[j * 3];
      g += L.gp[r * 3 + 1] * L.w2s[j * 3 + 1];
      g += L.gp[r * 3 + 2] * L.w2s[j * 3 + 2];
      L.gh[idx] = L.hp[idx] > 0.f ? rnd<BF16>(g) : 0.f;
    }
    __syncthreads();

    // ---- the decoder's gradients, each element by its owner, rows in order ----
    for (long long e = threadIdx.x; e < n_dec; e += THREADS) {
      float s = 0.f;
      if (e < G.b1 - G.w1) {                       // W1[k][j]: sum hin[k] g_h[j]
        const int k = (int)(e / W), j = (int)(e % W);
        const int col = k < DIR_ENC ? k : k + nd;
        for (int r = 0; r < valid; ++r) s = fmaf(L.x[r * XS + col], L.gh[r * W + j], s);
      } else if (e < G.w2 - G.w1) {                // b1[j]: sum g_h[j]
        const int j = (int)(e - (G.b1 - G.w1));
        for (int r = 0; r < valid; ++r) s += L.gh[r * W + j];
      } else if (e < G.b2 - G.w1) {                // W2[j][c]: sum h[j] gp[c]
        const int jc = (int)(e - (G.w2 - G.w1)), j = jc / 3, c = jc % 3;
        for (int r = 0; r < valid; ++r) s = fmaf(fmaxf(L.hp[r * W + j], 0.f), L.gp[r * 3 + c], s);
      } else {                                     // b2[c]: sum gp[c]
        const int c = (int)(e - (G.b2 - G.w1));
        for (int r = 0; r < valid; ++r) s += L.gp[r * 3 + c];
      }
      part[G.w1 + e] += s;
    }
    __syncthreads();  // h_pre is read for the last time above: dprod takes its place

    // ---- into the CP product: g_in = g_h W1^T ----
    float* dprod = L.hp;
    for (int idx = threadIdx.x; idx < TILE * K; idx += THREADS) {
      const int r = idx / K, k = idx % K;
      float s = 0.f;
      for (int j = 0; j < W; ++j) s = fmaf(L.gh[r * W + j], L.w1s[k * (W + 1) + j], s);
      if (k < DIR_ENC) {
        if (r < valid) ws.gde[(base + r) * DIR_ENC + k] = s;
      } else {
        dprod[r * F + nd + k - DIR_ENC] = rnd<BF16>(s);
      }
    }
    for (int idx = threadIdx.x; idx < TILE * nd; idx += THREADS)
      dprod[(idx / nd) * F + idx % nd] = rnd<BF16>(L.gsig[idx / nd]);
    __syncthreads();

    // ---- the table gradients: column (axis, f) by its owner, rows in order ----
    for (int pair = threadIdx.x; pair < 3 * F; pair += THREADS) {
      const int a = pair / F, f = pair % F;
      const float* fb = L.feats + ((a == 0 ? 1 : 0) * TILE) * F + f;
      const float* fc = L.feats + ((a == 2 ? 1 : 2) * TILE) * F + f;
      float* col = part + (long long)a * res * F + f;
      for (int r = 0; r < valid; ++r) {
        const float dfa = rnd<BF16>(dprod[r * F + f] * rnd<BF16>(fb[r * F] * fc[r * F]));
        const int t = r * 3 + a;
        float* c0 = col + (long long)L.tp.i0[t] * F;
        *c0 += L.tp.w0[t] * dfa;
        float* c1 = col + (long long)L.tp.i1[t] * F;
        *c1 += L.tp.w1[t] * dfa;
      }
    }

    // ---- the coordinates: one warp per (row, axis) ----
    for (int ra = warp; ra < valid * 3; ra += THREADS / 32) {
      const int r = ra / 3, a = ra % 3;
      const float* fb = L.feats + ((a == 0 ? 1 : 0) * TILE + r) * F;
      const float* fc = L.feats + ((a == 2 ? 1 : 2) * TILE + r) * F;
      const float* t0 = p.table[a] + (size_t)L.tp.i0[ra] * F;
      const float* t1 = p.table[a] + (size_t)L.tp.i1[ra] * F;
      float du0 = 0.f, du1 = 0.f;
      for (int f = lane; f < F; f += 32) {
        const float dfa = rnd<BF16>(dprod[r * F + f] * rnd<BF16>(fb[f] * fc[f]));
        du0 = fmaf(dfa, rnd<BF16>(__ldg(t0 + f)), du0);
        du1 = fmaf(dfa, rnd<BF16>(__ldg(t1 + f)), du1);
      }
      du0 = warp_sum(du0);
      du1 = warp_sum(du1);
      if (lane == 0) {
        const float dxg = -du0 * L.tp.m0[ra] + du1 * L.tp.m1[ra];
        L.dpt[ra] = __fmul_rn(__fmul_rn(dxg, L.tp.clip_grad[ra]), scale);
      }
    }
    __syncthreads();

    // ---- to the ray: d_ts = d p . d; d p kept for the per-ray sums ----
    for (int r = threadIdx.x; r < valid; r += THREADS) {
      const long long m = base + r, ray = m / N;
      const float* d = rays.dirs + 3 * ray;
      out.d_ts[m] = __fadd_rn(__fadd_rn(__fmul_rn(L.dpt[r * 3], __ldg(d)),
                                        __fmul_rn(L.dpt[r * 3 + 1], __ldg(d + 1))),
                              __fmul_rn(L.dpt[r * 3 + 2], __ldg(d + 2)));
      for (int a = 0; a < 3; ++a) ws.dpt[m * 3 + a] = L.dpt[r * 3 + a];
    }
    __syncthreads();  // the next tile overwrites the shared tile
  }

  // per-ray sums over the block's own rows, in sample order (written above
  // by this block: read through L2)
  const int per_ray = 6 + DIR_ENC;
  for (long long task = threadIdx.x; task < (ray1 - ray0) * per_ray; task += THREADS) {
    const long long ray = ray0 + task / per_ray;
    const int c = (int)(task % per_ray);
    float s = 0.f;
    for (int n = 0; n < N; ++n) {
      const long long m = ray * N + n;
      if (c < 3) s += __ldcg(ws.dpt + m * 3 + c);
      else if (c < 6) s += __ldcg(ws.dpt + m * 3 + c - 3) * __ldg(rays.ts + m);
      else s += __ldcg(ws.gde + m * DIR_ENC + c - 6);
    }
    if (c < 3) out.d_o[ray * 3 + c] = s;
    else if (c < 6) out.d_d[ray * 3 + c - 3] = s;
    else out.d_de[ray * DIR_ENC + c - 6] = s;
  }
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

int slices_for(int n_rays) { return std::max(1, std::min(n_rays, SLICES)); }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the first launch takes.
int grid_rays_bwd_smem_bytes(int res, int nd, int na, int width) {
  return (int)BwdLayout(Dims{res, nd, na, width}, nullptr).bytes;
}

// Float32 elements of the flat gradient: 3 * res * F + K * W + W + 3 W + 3.
long long grid_rays_bwd_grad_floats(int res, int nd, int na, int width) {
  return GradLayout(Dims{res, nd, na, width}).total;
}

// Float32 elements of workspace grid_rays_bwd needs for these shapes.
long long grid_rays_bwd_workspace_floats(int n_rays, int n_samples, int res, int nd,
                                         int na, int width) {
  if (n_rays <= 0 || n_samples <= 0) return 0;
  return (long long)slices_for(n_rays) * GradLayout(Dims{res, nd, na, width}).total +
         (long long)n_rays * n_samples * (3 + DIR_ENC);
}

// origins, dirs, d_o, d_d: (n_rays, 3); ts, the cotangents g_* and d_ts:
// (n_rays, n_samples); de, d_de: (n_rays, 24); grads: the flat gradient
// (grid_rays_bwd_grad_floats: tx, ty, tz, W1, b1, W2, b2); workspace:
// grid_rays_bwd_workspace_floats(...) floats. All float32, contiguous, on
// the current device. params, dims, bf16: as for grid_rays_fwd. Launches on
// `stream` and returns the first launch error, or 0.
int grid_rays_bwd(const float* origins, const float* dirs, const float* ts,
                  const float* de, const float* g_sigma, const float* g_r,
                  const float* g_g, const float* g_b, const void* const* params,
                  float* d_o, float* d_d, float* d_ts, float* d_de, float* grads,
                  float* workspace, int n_rays, int n_samples, int res, int nd, int na,
                  int width, int bf16, void* stream) {
  const Dims dm{res, nd, na, width};
  if (int bad = check_dims(dm)) return bad;
  if (n_rays <= 0 || n_samples <= 0) return 0;
  const GridParams p = unpack_grid_params(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = BwdLayout(dm, nullptr).bytes;
  auto kernel = bf16 ? &grid_rays_bwd_kernel<true> : &grid_rays_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = slices_for(n_rays);
  const long long n_grad = GradLayout(dm).total;
  Workspace ws;
  ws.partials = workspace;
  ws.dpt = workspace + slices * n_grad;
  ws.gde = ws.dpt + (long long)n_rays * n_samples * 3;
  kernel<<<slices, THREADS, smem, st>>>(
      Rays{origins, dirs, ts, de, n_samples}, Cotangents{g_sigma, {g_r, g_g, g_b}}, p,
      dm, Outputs{d_o, d_d, d_ts, d_de}, ws, n_rays);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<(int)ceil_div(n_grad, THREADS), THREADS, 0, st>>>(
      workspace, slices, n_grad, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
