// Kernel 2's device code and host orchestration (the field's recompute
// backward), shared by field_rays_bwd.cu and render_fused_bwd.cu, and, read
// through RowCoord, kernel 4's (field_flat_bwd.cu: flat rows of points, one
// sample a "ray"). Its fp32 form runs float32 FMA (field_common.cuh's
// gemm_segment), its bf16 form the tensor cores (field_tc.cuh). The design
// note is in field_rays_bwd.cu.

#pragma once

#include <algorithm>

#include "field_tc.cuh"

namespace {

// ---- workspace A: each layer's input, per sample row ----
constexpr int A_ENC_PT = 4 * WIDTH;            // after h0..h3, so [h3, enc_pt]
constexpr int A_H4 = A_ENC_PT + PT_ENC;        // (trunk_4's input) is contiguous
constexpr int A_ENC_DIR = A_H4 + 4 * WIDTH;    // [enc_dir, point_info] likewise
constexpr int A_PI = A_ENC_DIR + DIR_ENC;
constexpr int A_HD = A_PI + WIDTH;
constexpr int A_STRIDE = A_HD + WIDTH / 2;     // 2516 floats

__host__ __device__ constexpr int a_hidden(int i) {  // h_i, trunk layer i's output
  return i < 4 ? i * WIDTH : A_H4 + (i - 4) * WIDTH;
}

// ---- workspace G: each layer's pre-activation gradient, per sample row ----
constexpr int G_PI = 8 * WIDTH;                // trunk i's at i * WIDTH
constexpr int G_HD = G_PI + WIDTH;
constexpr int G_SIGMA = G_HD + WIDTH / 2;
constexpr int G_COLOR = G_SIGMA + 1;
constexpr int G_ENC4 = G_COLOR + 3;            // scratch: trunk_4's share of g_enc_pt
constexpr int G_STRIDE = G_ENC4 + PT_ENC;      // 2496 floats

// ---- transposed weights: (fan_out, padded fan_in) row-major ----
constexpr int T_TRUNK = 0;                     // trunk i (1..7, hidden rows) at (i-1)*W*W
constexpr int T_PI = 7 * WIDTH * WIDTH;
constexpr int T_DP = T_PI + WIDTH * WIDTH;     // dir_info's point_info rows: 128 x 256
constexpr int T_0 = T_DP + WIDTH / 2 * WIDTH;  // trunk_0: 256 x 64
constexpr int T_4E = T_0 + WIDTH * 64;         // trunk_4's encoding rows: 256 x 64
constexpr int T_DE = T_4E + WIDTH * 64;        // dir_info's encoding rows: 128 x 32
constexpr int WT_FLOATS = T_DE + WIDTH / 2 * 32;
constexpr int N_TRANSPOSE = 12;

constexpr int N_GRAD = 593924;       // all weights and biases, layer order, w then b
constexpr int CHUNK_ROWS = 65536;    // sample rows per chunk (whole rays)
constexpr int SPLIT_ROWS = 4096;     // rows per weight-gradient partial sum
constexpr int WG_TILE = 64;          // weight-gradient output tile
constexpr int WG_RT = 32;            // rows per weight-gradient step
constexpr int MAX_TILES = 160;

const int FAN_IN[N_LAYERS] = {PT_ENC, WIDTH, WIDTH, WIDTH, WIDTH + PT_ENC, WIDTH,
                              WIDTH, WIDTH, WIDTH, WIDTH, WIDTH + DIR_ENC, WIDTH / 2};
const int FAN_OUT[N_LAYERS] = {WIDTH, WIDTH, WIDTH, WIDTH, WIDTH, WIDTH,
                               WIDTH, WIDTH, 1, WIDTH, WIDTH / 2, 3};

struct Transpose {
  const float* src[N_TRANSPOSE];
  int src_ld[N_TRANSPOSE];   // src row length
  int rows[N_TRANSPOSE];     // src rows used (the fan-in slice)
  int cols[N_TRANSPOSE];     // src cols (fan_out)
  int dst[N_TRANSPOSE];      // offset in the transposed buffer
  int dst_ld[N_TRANSPOSE];   // rows padded to a multiple of 32
};

struct WGrad {
  int k[N_LAYERS], out[N_LAYERS], a_col[N_LAYERS], g_col[N_LAYERS],
      goff[N_LAYERS];
  int n_tiles;
  int tile[MAX_TILES];  // layer << 16 | k-tile << 8 | out-tile
};

// dst[j][k] = src[k][j] for k < rows, 0 for rows <= k < dst_ld.
__global__ void transpose_kernel(Transpose t, float* __restrict__ wt) {
  const int job = blockIdx.y;
  const int n = t.cols[job] * t.dst_ld[job];
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    const int j = idx / t.dst_ld[job], k = idx % t.dst_ld[job];
    wt[t.dst[job] + idx] =
        k < t.rows[job] ? __ldg(t.src[job] + (size_t)k * t.src_ld[job] + j) : 0.f;
  }
}

struct Smem {
  float act[TILE_M][WIDTH];
  float enc_pt[TILE_M][PT_ENC];
  float enc_dir[TILE_M][DIR_ENC];
  float genc_dir[TILE_M][DIR_ENC];
  float wt[KT * WIDTH];
  float gsig[TILE_M];        // g_sigma * sign(sigma_pre)
  float gcol[TILE_M][4];     // g_c * c * (1 - c)
  float dpt[TILE_M][3];      // d loss / d point
  float ddir[TILE_M][3];     // d loss / d direction, through its encoding
  float ray_do[TILE_M][3];   // per-ray sums of the block's rays (ray form)
  float ray_dd[TILE_M][3];
};

// act[row_i][col_j] = acc (times the ReLU mask h > 0 read from `mask`, the
// tile's saved activation, when given); rows below `valid` are also saved to
// save[row * G_STRIDE + col]. Ends with a barrier. The mask was written
// earlier in this launch, so it is read through L2 (__ldcg), never through
// the non-coherent read-only path.
template <int NC>
__device__ __forceinline__ void store_grad(float (&acc)[ROWS][NC],
                                           float (*act)[WIDTH],
                                           float* __restrict__ save,
                                           const float* mask, int valid) {
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + i;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      float v = acc[i][j];
      if (mask != nullptr)
        v = (r < valid && __ldcg(mask + (size_t)r * A_STRIDE + c) > 0.f) ? v : 0.f;
      act[r][c] = v;
      if (r < valid) save[(size_t)r * G_STRIDE + c] = v;
    }
  }
  __syncthreads();
}

// The fp32 form. Coord is RayCoord (kernel 2: rows are (ray, sample)
// pairs; d_o, d_d are per-ray sums and d_ts per sample) or RowCoord (kernel
// 4: flat rows with n_samples = 1; d_o, d_d are each row's d_points, d_dirs
// and d_ts is not written).
template <class Coord>
__global__ void __launch_bounds__(THREADS, 2)
field_bwd_kernel(Coord coord, const float* __restrict__ g_sigma,
                 const float* __restrict__ g_r,
                 const float* __restrict__ g_g,
                 const float* __restrict__ g_b, Params p,
                 const float* __restrict__ wt, float* __restrict__ ws_a,
                 float* __restrict__ ws_g, float* __restrict__ d_o,
                 float* __restrict__ d_d, float* __restrict__ d_ts,
                 int n_samples, int ray_begin, int ray_end,
                 int rays_per_block) {
  constexpr bool FLAT = Coord::kFlat;
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
  const int r0 = ray_begin + blockIdx.x * rays_per_block;
  const int r1 = min(r0 + rays_per_block, ray_end);
  const int row_begin = r0 * n_samples, row_end = r1 * n_samples;
  const int ws_base = ray_begin * n_samples;

  for (int idx = threadIdx.x; idx < TILE_M * 3; idx += THREADS) {
    (&s.ray_do[0][0])[idx] = 0.f;
    (&s.ray_dd[0][0])[idx] = 0.f;
  }

  for (int base = row_begin; base < row_end; base += TILE_M) {
    const int valid = min(TILE_M, row_end - base);
    float* a_tile = ws_a + (size_t)(base - ws_base) * A_STRIDE;
    float* g_tile = ws_g + (size_t)(base - ws_base) * G_STRIDE;

    // ================= recompute the forward, saving inputs =================
    encode_tile(coord, p.freqs, base, row_end, s.enc_pt, s.enc_dir);
    for (int idx = threadIdx.x; idx < valid * PT_ENC; idx += THREADS)
      a_tile[(size_t)(idx / PT_ENC) * A_STRIDE + A_ENC_PT + idx % PT_ENC] =
          s.enc_pt[idx / PT_ENC][idx % PT_ENC];
    for (int idx = threadIdx.x; idx < valid * DIR_ENC; idx += THREADS)
      a_tile[(size_t)(idx / DIR_ENC) * A_STRIDE + A_ENC_DIR + idx % DIR_ENC] =
          s.enc_dir[idx / DIR_ENC][idx % DIR_ENC];

    float acc[ROWS][8];
    zero(acc);
    gemm_segment<8, false>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC, p.w[0], s.wt);
    store<8, true>(acc, p.b[0], s.act, a_tile + a_hidden(0), A_STRIDE, valid);
    for (int layer = 1; layer < 8; ++layer) {
      zero(acc);
      gemm_segment<8, false>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[layer], s.wt);
      if (layer == 4)
        gemm_segment<8, false>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC, p.w[4] + WIDTH * WIDTH,
                               s.wt);
      store<8, true>(acc, p.b[layer], s.act, a_tile + a_hidden(layer), A_STRIDE, valid);
    }

    // sigma = |pre|: its gradient is g_sigma * sign(pre), sign(0) = 0
    for (int i = 0; i < ROWS; ++i) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < WIDTH / 32; ++q)
        v = fmaf(s.act[row0 + i][lane + 32 * q],
                 __ldg(p.w[SIGMA] + lane + 32 * q), v);
      v = warp_sum(v);
      if (lane == 0) {
        const int r = row0 + i;
        const float pre = v + __ldg(p.b[SIGMA]);
        const float sgn = pre > 0.f ? 1.f : (pre < 0.f ? -1.f : 0.f);
        const float gs = r < valid ? g_sigma[base + r] * sgn : 0.f;
        s.gsig[r] = gs;
        if (r < valid) g_tile[(size_t)r * G_STRIDE + G_SIGMA] = gs;
      }
    }

    zero(acc);
    gemm_segment<8, false>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[POINT_INFO], s.wt);
    store<8, false>(acc, p.b[POINT_INFO], s.act, a_tile + A_PI, A_STRIDE, valid);

    float acc4[ROWS][4];
    zero(acc4);
    gemm_segment<4, false>(acc4, &s.enc_dir[0][0], DIR_ENC, DIR_ENC, p.w[DIR_INFO], s.wt);
    gemm_segment<4, false>(acc4, &s.act[0][0], WIDTH, WIDTH,
                           p.w[DIR_INFO] + DIR_ENC * (WIDTH / 2), s.wt);
    store<4, true>(acc4, p.b[DIR_INFO], s.act, a_tile + A_HD, A_STRIDE, valid);

    // color = sigmoid(x): its gradient is g_c * c * (1 - c)
    for (int i = 0; i < ROWS; ++i) {
      float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < WIDTH / 2 / 32; ++q) {
        const int k = lane + 32 * q;
        const float h = s.act[row0 + i][k];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[c] = fmaf(h, __ldg(p.w[COLOR] + 3 * k + c), v[c]);
      }
      const int r = row0 + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = warp_sum(v[c]) + __ldg(p.b[COLOR] + c);
        if (lane == 0) {
          const float y = 1.f / (1.f + expf(-x));
          const float* gin = c == 0 ? g_r : c == 1 ? g_g : g_b;
          const float gc =
              r < valid ? (gin[base + r] * y) * (1.f - y) : 0.f;
          s.gcol[r][c] = gc;
          if (r < valid) g_tile[(size_t)r * G_STRIDE + G_COLOR + c] = gc;
        }
      }
    }
    __syncthreads();

    // ================= backward =================
    // the view branch: g_hd = relu'(hd) * sum_c gc_c W_color[k][c]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = lane + 32 * j;
      const float w0 = __ldg(p.w[COLOR] + 3 * k), w1 = __ldg(p.w[COLOR] + 3 * k + 1),
                  w2 = __ldg(p.w[COLOR] + 3 * k + 2);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = row0 + i;
        float g = s.gcol[r][0] * w0;
        g += s.gcol[r][1] * w1;
        g += s.gcol[r][2] * w2;
        g = s.act[r][k] > 0.f ? g : 0.f;
        s.act[r][k] = g;
        if (r < valid) g_tile[(size_t)r * G_STRIDE + G_HD + k] = g;
      }
    }
    __syncthreads();

    // its inputs [dir_enc, point_info]: g_enc_dir (24 of 32 columns), g_pi
    {
      float acc1[ROWS][1];
      zero(acc1);
      gemm_segment<1, false>(acc1, &s.act[0][0], WIDTH, WIDTH / 2, wt + T_DE, s.wt);
      if (lane < DIR_ENC)
        for (int i = 0; i < ROWS; ++i) s.genc_dir[row0 + i][lane] = acc1[i][0];
    }
    zero(acc);
    gemm_segment<8, false>(acc, &s.act[0][0], WIDTH, WIDTH / 2, wt + T_DP, s.wt);
    store_grad<8>(acc, s.act, g_tile + G_PI, nullptr, valid);

    // into h7: gs * w_sigma + g_pi W_pi^T, then relu'(h7)
    zero(acc);
    gemm_segment<8, false>(acc, &s.act[0][0], WIDTH, WIDTH, wt + T_PI, s.wt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ws = __ldg(p.w[SIGMA] + lane + 32 * j);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i][j] += s.gsig[row0 + i] * ws;
    }
    store_grad<8>(acc, s.act, g_tile + 7 * WIDTH, a_tile + a_hidden(7), valid);

    // down the trunk, layers 7..1; the skip layer 4 also feeds g_enc_pt
    for (int layer = 7; layer >= 1; --layer) {
      if (layer == 4) {
        float acc2[ROWS][2];
        zero(acc2);
        gemm_segment<2, false>(acc2, &s.act[0][0], WIDTH, WIDTH, wt + T_4E, s.wt);
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = lane + 32 * j;
            if (c < PT_ENC && row0 + i < valid)
              g_tile[(size_t)(row0 + i) * G_STRIDE + G_ENC4 + c] = acc2[i][j];
          }
      }
      zero(acc);
      gemm_segment<8, false>(acc, &s.act[0][0], WIDTH, WIDTH,
                             wt + T_TRUNK + (layer - 1) * WIDTH * WIDTH, s.wt);
      store_grad<8>(acc, s.act, g_tile + (layer - 1) * WIDTH, a_tile + a_hidden(layer - 1),
                    valid);
    }

    // layer 0: g_enc_pt = (layer 4's share) + g_pre0 W0^T, into act[:, :60]
    {
      float acc2[ROWS][2];
      zero(acc2);
      gemm_segment<2, false>(acc2, &s.act[0][0], WIDTH, WIDTH, wt + T_0, s.wt);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = row0 + i, c = lane + 32 * j;
          if (c < PT_ENC) {
            const float g4 =
                r < valid ? __ldcg(g_tile + (size_t)r * G_STRIDE + G_ENC4 + c) : 0.f;
            s.act[r][c] = g4 + acc2[i][j];
          }
        }
    }
    __syncthreads();

    // through the encoding (float32 sin/cos): d x_c = sum_l f_l (g_sin cos - g_cos sin)
    for (int idx = threadIdx.x; idx < TILE_M * 3; idx += THREADS) {
      const int r = idx / 3, c = idx % 3;
      float dp = 0.f, dd = 0.f;
#pragma unroll
      for (int l = 0; l < L_PT; ++l) {
        const int k = c * 2 * L_PT + 2 * l;
        const float g = __fsub_rn(__fmul_rn(s.act[r][k], s.enc_pt[r][k + 1]),
                                  __fmul_rn(s.act[r][k + 1], s.enc_pt[r][k]));
        dp = fmaf(g, p.freqs[l], dp);
      }
#pragma unroll
      for (int l = 0; l < L_DIR; ++l) {
        const int k = c * 2 * L_DIR + 2 * l;
        const float g = __fsub_rn(__fmul_rn(s.genc_dir[r][k], s.enc_dir[r][k + 1]),
                                  __fmul_rn(s.genc_dir[r][k + 1], s.enc_dir[r][k]));
        dd = fmaf(g, p.freqs[L_PT + l], dd);
      }
      s.dpt[r][c] = dp;
      s.ddir[r][c] = dd;
    }
    __syncthreads();

    if constexpr (FLAT) {
      // each row's own d_points and d_dirs
      for (int idx = threadIdx.x; idx < valid * 3; idx += THREADS) {
        d_o[3 * (size_t)base + idx] = (&s.dpt[0][0])[idx];
        d_d[3 * (size_t)base + idx] = (&s.ddir[0][0])[idx];
      }
    } else {
      // to the ray: d_ts = d_pts . d; per-ray sums in sample order
      const float* dirs = coord.dirs;
      const float* ts = coord.ts;
      for (int r = threadIdx.x; r < valid; r += THREADS) {
        const int m = base + r, ray = m / n_samples;
        float v = s.dpt[r][0] * dirs[3 * ray];
        v += s.dpt[r][1] * dirs[3 * ray + 1];
        v += s.dpt[r][2] * dirs[3 * ray + 2];
        d_ts[m] = v;
      }
      for (int idx = threadIdx.x; idx < (r1 - r0) * 3; idx += THREADS) {
        const int rr = idx / 3, c = idx % 3, ray = r0 + rr;
        const int lo = max(base, ray * n_samples);
        const int hi = min(base + valid, (ray + 1) * n_samples);
        float so = s.ray_do[rr][c], sd = s.ray_dd[rr][c];
        for (int m = lo; m < hi; ++m) {
          so += s.dpt[m - base][c];
          sd += s.dpt[m - base][c] * ts[m] + s.ddir[m - base][c];
        }
        s.ray_do[rr][c] = so;
        s.ray_dd[rr][c] = sd;
      }
    }
    __syncthreads();
  }

  if constexpr (!FLAT) {
    for (int idx = threadIdx.x; idx < (r1 - r0) * 3; idx += THREADS) {
      d_o[3 * r0 + idx] = (&s.ray_do[0][0])[idx];
      d_d[3 * r0 + idx] = (&s.ray_dd[0][0])[idx];
    }
  }
}

// partials[split][goff + k * out + j] = sum over the split's rows of
// A[row][a_col + k] * G[row][g_col + j]; the k-tile-0 blocks also write the
// bias gradient, sum G[row][g_col + j], at goff + K * out + j.
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const float* __restrict__ ws_a, const float* __restrict__ ws_g,
             int rows, WGrad t, float* __restrict__ partials) {
  __shared__ __align__(16) float as[WG_RT][WG_TILE];
  __shared__ __align__(16) float gs[WG_RT][WG_TILE];
  const int packed = t.tile[blockIdx.x];
  const int layer = packed >> 16, kt = (packed >> 8) & 0xff, jt = packed & 0xff;
  const int K = t.k[layer], OUT = t.out[layer];
  const int a_col = t.a_col[layer] + kt * WG_TILE;
  const int g_col = t.g_col[layer] + jt * WG_TILE;
  const int k_n = min(WG_TILE, K - kt * WG_TILE), j_n = min(WG_TILE, OUT - jt * WG_TILE);
  const int m0 = blockIdx.y * SPLIT_ROWS, m1 = min(rows, m0 + SPLIT_ROWS);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool bias = kt == 0 && ty == 0;

  float acc[4][4], bsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int m = m0; m < m1; m += WG_RT) {
    for (int idx = threadIdx.x; idx < WG_RT * WG_TILE; idx += THREADS) {
      const int r = idx / WG_TILE, c = idx % WG_TILE, mm = m + r;
      as[r][c] = (mm < m1 && c < k_n) ? ws_a[(size_t)mm * A_STRIDE + a_col + c] : 0.f;
      gs[r][c] = (mm < m1 && c < j_n) ? ws_g[(size_t)mm * G_STRIDE + g_col + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WG_RT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&as[r][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&gs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
      if (bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += gv[j];
      }
    }
    __syncthreads();
  }

  float* out = partials + (size_t)blockIdx.y * N_GRAD + t.goff[layer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = tx * 4 + j;
      if (k < k_n && jj < j_n)
        out[(size_t)(kt * WG_TILE + k) * OUT + jt * WG_TILE + jj] = acc[i][j];
    }
  }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = tx * 4 + j;
      if (jj < j_n) out[(size_t)K * OUT + jt * WG_TILE + jj] = bsum[j];
    }
  }
}

// grads[i] (+)= sum over splits, in split order, of partials[split][i].
__global__ void reduce_kernel(const float* __restrict__ partials, int splits,
                              float* __restrict__ grads, int accumulate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N_GRAD) return;
  float v = partials[i];
  for (int s = 1; s < splits; ++s) v += partials[(size_t)s * N_GRAD + i];
  grads[i] = accumulate ? grads[i] + v : v;
}

int chunk_rays(int n_rays, int n_samples) {
  return std::max(1, std::min(n_rays, CHUNK_ROWS / n_samples));
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }


// ---------------------------------------------------------------- bf16 form
//
// The bf16 form's workspaces hold bf16 where the value stored is a bf16
// value (every layer input, every rounded pre-activation gradient): halved
// traffic, and direct mma operands for the weight-gradient launch. Rows
// are 16-byte aligned. A, each layer's input: field_tc.cuh (AB_STRIDE).
// G, each layer's rounded pre-activation gradient, bf16: trunk i's at i * WIDTH
constexpr int GB_PI = 8 * WIDTH;
constexpr int GB_HD = GB_PI + WIDTH;
constexpr int GB_STRIDE = GB_HD + WIDTH / 2;          // 2432
// S, float32 a row: the heads' pre-activation gradients (float32 in the ray
// form) and trunk_4's share of g_enc_pt
constexpr int GS_SIGMA = 0;
constexpr int GS_COLOR = 1;
constexpr int GS_ENC4 = 4;
constexpr int GS_STRIDE = GS_ENC4 + PT_ENC;           // 64

constexpr int WB_SPLIT = 1024;   // rows per weight-gradient partial sum: a split's A
                                 // and G rows (10 MB) stay in L2 while its tiles run
constexpr int WB_TILE = 128;     // weight-gradient output tile, (fan-in) x (fan-out)
constexpr int WB_RT = 64;        // rows a step
constexpr int WB_LD = WB_TILE + 8;
// two stages of A and G rows, then the bias sums: 70,656 bytes
constexpr int WB_SMEM =
    2 * 2 * WB_RT * WB_LD * (int)sizeof(bf16) + THREADS * (int)sizeof(float);
constexpr int N_SEG = 12;        // products by (layer, fan-in slice); the heads apart
constexpr int HEADS_TILE = -1;

// Float32 elements of workspace field_bwd_run needs for these shapes, in
// either form: the fp32 form's transposed weights, A and G, or the bf16
// form's packed weights, A, G and S; then the weight gradients' partials.
inline long long field_bwd_workspace_floats(int n_rays, int n_samples) {
  if (n_rays <= 0 || n_samples <= 0) return 0;
  const long long rows = (long long)chunk_rays(n_rays, n_samples) * n_samples;
  return std::max(WT_FLOATS + rows * (A_STRIDE + G_STRIDE) +
                      (long long)ceil_div(rows, SPLIT_ROWS) * N_GRAD,
                  PK_SCRATCH / 2 + rows * ((AB_STRIDE + GB_STRIDE) / 2 + GS_STRIDE) +
                      (long long)ceil_div(rows, WB_SPLIT) * N_GRAD);
}

struct WGradTc {
  int a_col[N_SEG], k[N_SEG], g_col[N_SEG], out[N_SEG];
  int goff[N_SEG];   // the segment's first weight in the gradient buffer
  int bias[N_SEG];   // its layer's bias gradient, or -1
  int goff_sigma, goff_color;
  int n_tiles;
  int tile[MAX_TILES];  // HEADS_TILE, or segment << 16 | k-tile << 8 | n-tile
};

struct TcBwdSmem {
  bf16 act[TILE_M * ACT_LD];     // activations, then pre-activation gradients
  bf16 enc_pt[TILE_M * ENC_PT_LD];
  bf16 enc_dir[TILE_M * ENC_DIR_LD];
  bf16 wt[2 * BWD_STAGE];        // K-tiles; after the last product, g_enc_pt (f32)
  float genc_dir[TILE_M][DIR_ENC];
  float gsig[TILE_M];            // g_sigma * sign(sigma_pre)
  float gcol[TILE_M][4];         // g_c * c * (1 - c)
  float dpt[TILE_M][3];          // d loss / d point
  float ddir[TILE_M][3];         // d loss / d direction, through its encoding
  float ray_do[TILE_M][3];       // per-ray sums of the block's rays (ray form)
  float ray_dd[TILE_M][3];
  FixSmem fx;
};
static_assert(TILE_M * ENC_PT_PAD * sizeof(float) <= sizeof(TcBwdSmem::wt),
              "g_enc_pt must fit in the K-tiles");

// Rows below `valid` of src[:, :cols] (bf16, row stride ld) to dst (row
// stride dst_ld), 16 bytes a thread. No barrier: it only reads src.
__device__ __forceinline__ void save_rows(const bf16* src, int ld, int cols, bf16* dst,
                                          int dst_ld, int valid) {
  const int ch = cols / 8;
  for (int i = threadIdx.x; i < valid * ch; i += THREADS)
    *reinterpret_cast<uint4*>(dst + (size_t)(i / ch) * dst_ld + (i % ch) * 8) =
        *reinterpret_cast<const uint4*>(src + (i / ch) * ld + (i % ch) * 8);
}

// act[r][c] = bf16(acc), times the ReLU mask h > 0 of the tile's saved
// activation `mask` (row stride AB_STRIDE) when given, which also zeroes
// rows at or past `valid`. Ends with a barrier. The mask was written
// earlier in this launch, so it is read through L2 (__ldcg), never through
// the non-coherent read-only path.
template <int NT>
__device__ __forceinline__ void store_grad_tc(const float (&acc)[2][NT][4], bf16* act,
                                              const bf16* mask, int valid) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tc_row(mi, 2 * h), c = tc_col<NT>(j, 0);
        float v0 = acc[mi][j][2 * h], v1 = acc[mi][j][2 * h + 1];
        if (mask != nullptr) {
          const uint32_t m =
              r < valid ? __ldcg(reinterpret_cast<const unsigned int*>(
                              mask + (size_t)r * AB_STRIDE + c))
                        : 0u;
          v0 = __uint_as_float(m << 16) > 0.f ? v0 : 0.f;
          v1 = __uint_as_float(m & 0xffff0000u) > 0.f ? v1 : 0.f;
        }
        *reinterpret_cast<uint32_t*>(act + r * ACT_LD + c) = pack_bf16x2(v0, v1);
      }
  __syncthreads();
}

// The bf16 form of field_bwd_kernel (same rows, same outputs), its products
// on the tensor cores: the forward recomputed with field_tc.cuh's tiles,
// saving each layer's input to A, the heads' gradients to S, then the chain
// down the trunk, g_{l-1} = relu'(h_{l-1}) (g_l W_l^T) read with W_l
// untransposed, saving each rounded gradient to G; then the encoding's
// backward, its sin and cos recomputed, and the per-ray sums. As the TPU
// kernels, the ray form keeps the heads' gradients float32 and the flat
// form (_bwd_core) rounds them to bf16.
template <class Coord>
__global__ void __launch_bounds__(THREADS, 2)
field_bwd_tc_kernel(Coord coord, const float* __restrict__ g_sigma,
                    const float* __restrict__ g_r, const float* __restrict__ g_g,
                    const float* __restrict__ g_b, Params p, bf16* __restrict__ ws_a,
                    bf16* __restrict__ ws_g, float* __restrict__ ws_s,
                    float* __restrict__ d_o, float* __restrict__ d_d,
                    float* __restrict__ d_ts, int n_samples, int ray_begin, int ray_end,
                    int rays_per_block) {
  constexpr bool FLAT = Coord::kFlat;
  extern __shared__ float4 smem_raw[];
  TcBwdSmem& s = *reinterpret_cast<TcBwdSmem*>(smem_raw);
  float* genc_pt = reinterpret_cast<float*>(s.wt);  // 64 x 64, after the last product
  const bf16* wb = p.wb;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
  const int r0 = ray_begin + blockIdx.x * rays_per_block;
  const int r1 = min(r0 + rays_per_block, ray_end);
  const int row_begin = r0 * n_samples, row_end = r1 * n_samples;
  const int ws_base = ray_begin * n_samples;

  for (int idx = threadIdx.x; idx < TILE_M * 3; idx += THREADS) {
    (&s.ray_do[0][0])[idx] = 0.f;
    (&s.ray_dd[0][0])[idx] = 0.f;
  }

  for (int base = row_begin; base < row_end; base += TILE_M) {
    const int valid = min(TILE_M, row_end - base);
    bf16* a_tile = ws_a + (size_t)(base - ws_base) * AB_STRIDE;
    bf16* g_tile = ws_g + (size_t)(base - ws_base) * GB_STRIDE;
    float* s_tile = ws_s + (size_t)(base - ws_base) * GS_STRIDE;

    // ================= recompute the forward, saving inputs =================
    encode_tile_tc(coord, p.freqs, base, row_end, s.enc_pt, s.enc_dir);
    enc_norms(s.enc_pt, s.enc_dir, s.fx);
    save_rows(s.enc_pt, ENC_PT_LD, ENC_PT_PAD, a_tile + AB_ENC_PT, AB_STRIDE, valid);
    save_rows(s.enc_dir, ENC_DIR_LD, ENC_DIR_PAD, a_tile + AB_ENC_DIR, AB_STRIDE, valid);
    trunk_tc(p, s.act, s.enc_pt, s.wt, 2 * BWD_STAGE, s.fx, a_tile, valid, [&](int layer) {
      save_rows(s.act, ACT_LD, WIDTH, a_tile + ab_hidden(layer), AB_STRIDE, valid);
    });

    // sigma = |pre|: its gradient is g_sigma * sign(pre), sign(0) = 0
    for (int i = 0; i < ROWS; ++i) {
      const int r = row0 + i;
      const float pre = sigma_pre_tc(p, s.act, r);
      if (lane == 0) {
        const float sgn = pre > 0.f ? 1.f : (pre < 0.f ? -1.f : 0.f);
        const float gs = r < valid ? rnd<FLAT>(g_sigma[base + r] * sgn) : 0.f;
        s.gsig[r] = gs;
        if (r < valid) s_tile[(size_t)r * GS_STRIDE + GS_SIGMA] = gs;
      }
    }

    view_tc(p, s.act, s.enc_dir, s.wt, 2 * BWD_STAGE, s.fx, a_tile, valid, [&](int layer) {
      if (layer == POINT_INFO)
        save_rows(s.act, ACT_LD, WIDTH, a_tile + AB_PI, AB_STRIDE, valid);
      else
        save_rows(s.act, ACT_LD, WIDTH / 2, a_tile + AB_HD, AB_STRIDE, valid);
    });

    // color = sigmoid(x): its gradient is g_c * c * (1 - c)
    for (int i = 0; i < ROWS; ++i) {
      const int r = row0 + i;
      float x[3];
      color_pre_tc(p, s.act, r, x);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float y = 1.f / (1.f + expf(-x[c]));
          const float* gin = c == 0 ? g_r : c == 1 ? g_g : g_b;
          const float gc = r < valid ? rnd<FLAT>((gin[base + r] * y) * (1.f - y)) : 0.f;
          s.gcol[r][c] = gc;
          if (r < valid) s_tile[(size_t)r * GS_STRIDE + GS_COLOR + c] = gc;
        }
      }
    }
    __syncthreads();

    // ================= backward =================
    // the view branch: g_hd = relu'(hd) * sum_c gc_c W_color[k][c], rounded
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = lane + 32 * j;
      const float w0 = rnd<true>(__ldg(p.w[COLOR] + 3 * k)),
                  w1 = rnd<true>(__ldg(p.w[COLOR] + 3 * k + 1)),
                  w2 = rnd<true>(__ldg(p.w[COLOR] + 3 * k + 2));
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = row0 + i;
        float g = s.gcol[r][0] * w0;
        g += s.gcol[r][1] * w1;
        g += s.gcol[r][2] * w2;
        bf16& a = s.act[r * ACT_LD + k];
        a = __float2bfloat16_rn(bf(a) > 0.f ? g : 0.f);
      }
    }
    __syncthreads();
    save_rows(s.act, ACT_LD, WIDTH / 2, g_tile + GB_HD, GB_STRIDE, valid);

    // its inputs [dir_enc, point_info]: g_enc_dir (24 of 32 columns), g_pi
    {
      float acc1[2][1][4];
      zero_tc(acc1);
      gemm_tc<1, false>(acc1, s.act, ACT_LD, WIDTH / 2, wb + PK_DE, WIDTH / 2, s.wt);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (tc_col<1>(0, q) < DIR_ENC)
            s.genc_dir[tc_row(mi, q)][tc_col<1>(0, q)] = acc1[mi][0][q];
    }
    float acc[2][8][4];
    zero_tc(acc);
    gemm_tc<8, false>(acc, s.act, ACT_LD, WIDTH / 2, wb + PK_DP, WIDTH / 2, s.wt);
    store_grad_tc<8>(acc, s.act, nullptr, valid);
    save_rows(s.act, ACT_LD, WIDTH, g_tile + GB_PI, GB_STRIDE, valid);

    // into h7: gs * w_sigma + g_pi W_pi^T, then relu'(h7)
    zero_tc(acc);
    gemm_tc<8, false>(acc, s.act, ACT_LD, WIDTH, wb + PK_PI, WIDTH, s.wt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ws = rnd<true>(__ldg(p.w[SIGMA] + tc_col<8>(j, q)));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) acc[mi][j][q] += s.gsig[tc_row(mi, q)] * ws;
      }
    store_grad_tc<8>(acc, s.act, a_tile + ab_hidden(7), valid);
    save_rows(s.act, ACT_LD, WIDTH, g_tile + 7 * WIDTH, GB_STRIDE, valid);

    // down the trunk, layers 7..1; the skip layer 4 also feeds g_enc_pt
    for (int layer = 7; layer >= 1; --layer) {
      if (layer == 4) {
        float acc2[2][2][4];
        zero_tc(acc2);
        gemm_tc<2, false>(acc2, s.act, ACT_LD, WIDTH, wb + PK_4E, WIDTH, s.wt);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = tc_row(mi, q), c = tc_col<2>(j, q);
              if (c < PT_ENC && r < valid)
                s_tile[(size_t)r * GS_STRIDE + GS_ENC4 + c] = acc2[mi][j][q];
            }
      }
      zero_tc(acc);
      gemm_tc<8, false>(acc, s.act, ACT_LD, WIDTH, wb + pk_hidden(layer), WIDTH, s.wt);
      store_grad_tc<8>(acc, s.act, a_tile + ab_hidden(layer - 1), valid);
      save_rows(s.act, ACT_LD, WIDTH, g_tile + (layer - 1) * WIDTH, GB_STRIDE, valid);
    }

    // layer 0: g_enc_pt = (layer 4's share) + g_pre0 W0^T, float32 into genc_pt
    {
      float acc2[2][2][4];
      zero_tc(acc2);
      gemm_tc<2, false>(acc2, s.act, ACT_LD, WIDTH, wb + PK_W0, WIDTH, s.wt);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = tc_row(mi, q), c = tc_col<2>(j, q);
            if (c < PT_ENC) {
              const float g4 =
                  r < valid ? __ldcg(s_tile + (size_t)r * GS_STRIDE + GS_ENC4 + c) : 0.f;
              genc_pt[r * ENC_PT_PAD + c] = g4 + acc2[mi][j][q];
            }
          }
    }
    __syncthreads();

    // through the encoding (float32 sin/cos, recomputed as encode_tile_tc
    // computed them): d x_c = sum_l f_l (g_sin cos - g_cos sin)
    for (int idx = threadIdx.x; idx < TILE_M * 3; idx += THREADS) {
      const int r = idx / 3, c = idx % 3, m = base + r;
      const float xp = m < row_end ? coord(m, c, true) : 0.f;
      const float xd = m < row_end ? coord(m, c, false) : 0.f;
      float dp = 0.f, dd = 0.f;
#pragma unroll
      for (int l = 0; l < L_PT; ++l) {
        const int k = c * 2 * L_PT + 2 * l;
        const float arg = __fmul_rn(xp, p.freqs[l]);
        const float g = __fsub_rn(__fmul_rn(genc_pt[r * ENC_PT_PAD + k], cosf(arg)),
                                  __fmul_rn(genc_pt[r * ENC_PT_PAD + k + 1], sinf(arg)));
        dp = fmaf(g, p.freqs[l], dp);
      }
#pragma unroll
      for (int l = 0; l < L_DIR; ++l) {
        const int k = c * 2 * L_DIR + 2 * l;
        const float arg = __fmul_rn(xd, p.freqs[L_PT + l]);
        const float g = __fsub_rn(__fmul_rn(s.genc_dir[r][k], cosf(arg)),
                                  __fmul_rn(s.genc_dir[r][k + 1], sinf(arg)));
        dd = fmaf(g, p.freqs[L_PT + l], dd);
      }
      s.dpt[r][c] = dp;
      s.ddir[r][c] = dd;
    }
    __syncthreads();

    if constexpr (FLAT) {
      // each row's own d_points and d_dirs
      for (int idx = threadIdx.x; idx < valid * 3; idx += THREADS) {
        d_o[3 * (size_t)base + idx] = (&s.dpt[0][0])[idx];
        d_d[3 * (size_t)base + idx] = (&s.ddir[0][0])[idx];
      }
    } else {
      // to the ray: d_ts = d_pts . d; per-ray sums in sample order
      const float* dirs = coord.dirs;
      const float* ts = coord.ts;
      for (int r = threadIdx.x; r < valid; r += THREADS) {
        const int m = base + r, ray = m / n_samples;
        float v = s.dpt[r][0] * dirs[3 * ray];
        v += s.dpt[r][1] * dirs[3 * ray + 1];
        v += s.dpt[r][2] * dirs[3 * ray + 2];
        d_ts[m] = v;
      }
      for (int idx = threadIdx.x; idx < (r1 - r0) * 3; idx += THREADS) {
        const int rr = idx / 3, c = idx % 3, ray = r0 + rr;
        const int lo = max(base, ray * n_samples);
        const int hi = min(base + valid, (ray + 1) * n_samples);
        float so = s.ray_do[rr][c], sd = s.ray_dd[rr][c];
        for (int m = lo; m < hi; ++m) {
          so += s.dpt[m - base][c];
          sd += s.dpt[m - base][c] * ts[m] + s.ddir[m - base][c];
        }
        s.ray_do[rr][c] = so;
        s.ray_dd[rr][c] = sd;
      }
    }
    __syncthreads();
  }

  if constexpr (!FLAT) {
    for (int idx = threadIdx.x; idx < (r1 - r0) * 3; idx += THREADS) {
      d_o[3 * r0 + idx] = (&s.ray_do[0][0])[idx];
      d_d[3 * r0 + idx] = (&s.ray_dd[0][0])[idx];
    }
  }
}

// The sigma and color heads' weight and bias gradients over rows m0 .. m1
// (float32 FMA): dW_sigma[k] = sum h7[k] g_sigma, dW_color[k][c] = sum
// h_dir[k] g_c. Thread k takes row k of both.
__device__ __forceinline__ void heads_wgrad(const bf16* __restrict__ ws_a,
                                            const float* __restrict__ ws_s, int m0, int m1,
                                            const WGradTc& t, float* out) {
  const int k = threadIdx.x;
  float ws = 0.f, bs = 0.f, wc[3] = {0.f, 0.f, 0.f}, bc[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
  for (int m = m0; m < m1; ++m) {
    const float* sr = ws_s + (size_t)m * GS_STRIDE;
    const bf16* ar = ws_a + (size_t)m * AB_STRIDE;
    const float gs = __ldg(sr + GS_SIGMA);
    ws = fmaf(bf(ar[ab_hidden(7) + k]), gs, ws);
    bs += gs;
    if (k < WIDTH / 2) {
      const float h = bf(ar[AB_HD + k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gc = __ldg(sr + GS_COLOR + c);
        wc[c] = fmaf(h, gc, wc[c]);
        bc[c] += gc;
      }
    }
  }
  out[t.goff_sigma + k] = ws;
  if (k < WIDTH / 2)
    for (int c = 0; c < 3; ++c) out[t.goff_color + 3 * k + c] = wc[c];
  if (k == 0) {
    out[t.goff_sigma + WIDTH] = bs;
    for (int c = 0; c < 3; ++c) out[t.goff_color + 3 * (WIDTH / 2) + c] = bc[c];
  }
}

// The bf16 form's weight gradients: partials[split][goff + k * out + n] =
// sum over the split's rows of A[row][a_col + k] G[row][g_col + n], one
// 128 x 128 output tile a block, on the tensor cores (A^T and G both read
// with ldmatrix.trans from row-major tiles that cp.async double-buffers);
// the k-tile-0 blocks of a layer's first segment also write its bias
// gradient, sum G[row][g_col + n]; the HEADS_TILE block, the heads'. Rows
// past `rows` are zero-filled. Warp w owns k rows 64 (w % 2) .. +63 and n
// columns 32 (w / 2) .. +31 of the tile.
__global__ void __launch_bounds__(THREADS)
wgrad_tc_kernel(const bf16* __restrict__ ws_a, const bf16* __restrict__ ws_g,
                const float* __restrict__ ws_s, int rows, WGradTc t,
                float* __restrict__ partials) {
  extern __shared__ float4 smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // two stages of A rows, then of G rows
  bf16* gs = as + 2 * WB_RT * WB_LD;
  float* bsum = reinterpret_cast<float*>(gs + 2 * WB_RT * WB_LD);
  const int m0 = blockIdx.y * WB_SPLIT, m1 = min(rows, m0 + WB_SPLIT);
  float* out = partials + (size_t)blockIdx.y * N_GRAD;
  const int packed = t.tile[blockIdx.x];
  if (packed == HEADS_TILE) {
    heads_wgrad(ws_a, ws_s, m0, m1, t, out);
    return;
  }
  const int seg = packed >> 16, kt = (packed >> 8) & 0xff, nt = packed & 0xff;
  const int N = t.out[seg];
  const int k_base = kt * WB_TILE, n_base = nt * WB_TILE;
  const int k_n = min(WB_TILE, t.k[seg] - k_base);  // rows of the tile that exist
  const int k_ld = (k_n + 15) / 16 * 16;            // columns of A read (pads are zero)
  const int a_ch = k_ld / 8;
  const bf16* a_src = ws_a + t.a_col[seg] + k_base;
  const bf16* g_src = ws_g + t.g_col[seg] + n_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const bool bias = t.bias[seg] >= 0 && kt == 0;

  auto load = [&](int stage, int m) {
    const int per_row = a_ch + WB_TILE / 8;
    for (int i = threadIdx.x; i < WB_RT * per_row; i += THREADS) {
      const int r = i / per_row, c = i % per_row;
      const bool ok = m + r < m1;
      const size_t row = ok ? m + r : m0;  // a valid address when zero-filling
      if (c < a_ch)
        cp_async16(as + (stage * WB_RT + r) * WB_LD + c * 8, a_src + row * AB_STRIDE + c * 8,
                   ok);
      else
        cp_async16(gs + (stage * WB_RT + r) * WB_LD + (c - a_ch) * 8,
                   g_src + row * GB_STRIDE + (c - a_ch) * 8, ok);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
  float bacc = 0.f;
  const int steps = (m1 - m0 + WB_RT - 1) / WB_RT;
  load(0, m0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load((step + 1) & 1, m0 + (step + 1) * WB_RT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* A = as + (step & 1) * WB_RT * WB_LD;
    const bf16* G = gs + (step & 1) * WB_RT * WB_LD;
    if (bias) {
      const int c = threadIdx.x & (WB_TILE - 1), h = threadIdx.x / WB_TILE;
#pragma unroll
      for (int r = 0; r < WB_RT / 2; ++r) bacc += bf(G[(h * WB_RT / 2 + r) * WB_LD + c]);
    }
    // the step's rows in pairs of k16 steps, each pair summed on the tensor
    // cores, then added in float32
#pragma unroll
    for (int kp = 0; kp < WB_RT; kp += 32) {
      uint32_t b[2][4][2];  // [k16 step][n8-tile]
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t q[4];
          ldsm_x4_trans(q, G + (kp + 16 * st + (lane & 7) + ((lane >> 3) & 1) * 8) * WB_LD +
                               wn + nj * 16 + (lane >> 4) * 8);
          b[st][2 * nj][0] = q[0];
          b[st][2 * nj][1] = q[1];
          b[st][2 * nj + 1][0] = q[2];
          b[st][2 * nj + 1][1] = q[3];
        }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (wk + mi * 16 >= k_ld) continue;  // the same for the whole warp
        uint32_t a[2][4];
#pragma unroll
        for (int st = 0; st < 2; ++st)
          ldsm_x4_trans(a[st], A + (kp + 16 * st + (lane & 7) + (lane >> 4) * 8) * WB_LD + wk +
                                   mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16_k32(acc[mi][nj], a[0], b[0][nj][0], b[0][nj][1], a[1], b[1][nj][0],
                       b[1][nj][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = wk + mi * 16 + (lane >> 2) + 8 * h;
      if (k >= k_n) continue;
      float* o = out + t.goff[seg] + (size_t)(k_base + k) * N + n_base + wn + 2 * (lane & 3);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        o[nj * 8] = acc[mi][nj][2 * h];
        o[nj * 8 + 1] = acc[mi][nj][2 * h + 1];
      }
    }
  if (bias) {
    bsum[threadIdx.x] = bacc;
    __syncthreads();
    if (threadIdx.x < WB_TILE)
      out[t.bias[seg] + n_base + threadIdx.x] = bsum[threadIdx.x] + bsum[threadIdx.x + WB_TILE];
  }
}

// The bf16 form of field_bwd_launch (its arguments, checked there): the
// weights packed into the workspace's front; then per chunk of whole rays
// the recompute + input-gradient launch (field_bwd_tc_kernel), the weight
// gradients (wgrad_tc_kernel, fixed WB_SPLIT slices) and the ordered
// reduce, as the fp32 form. Needs no more workspace than the fp32 form.
template <class Coord>
inline int field_bwd_tc_launch(Coord coord, const float* g_sigma, const float* g_r,
                               const float* g_g, const float* g_b, Params p, float* d_o,
                               float* d_d, float* d_ts, float* grads, float* workspace,
                               int n_rays, int n_samples, bool accumulate,
                               cudaStream_t st) {
  auto kernel = &field_bwd_tc_kernel<Coord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(TcBwdSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WB_SMEM);
  if (err != cudaSuccess) return (int)err;
  bf16* wb = reinterpret_cast<bf16*>(workspace);
  const int e = pack_weights(p, wb, st, true);
  if (e != 0) return e;
  p.wb = wb;

  // ---- the weight-gradient tiles: the heads, then every segment ----
  WGradTc wg;
  int goff[N_LAYERS], off = 0;
  for (int l = 0; l < N_LAYERS; ++l) {
    goff[l] = off;
    off += (FAN_IN[l] + 1) * FAN_OUT[l];
  }
  int n = 0;
  auto seg = [&](int layer, int a_col, int k, int row0, int g_col, bool bias) {
    wg.a_col[n] = a_col; wg.k[n] = k; wg.g_col[n] = g_col; wg.out[n] = FAN_OUT[layer];
    wg.goff[n] = goff[layer] + row0 * FAN_OUT[layer];
    wg.bias[n] = bias ? goff[layer] + FAN_IN[layer] * FAN_OUT[layer] : -1;
    ++n;
  };
  seg(0, AB_ENC_PT, PT_ENC, 0, 0, true);
  for (int l = 1; l < 8; ++l) {
    seg(l, ab_hidden(l - 1), WIDTH, 0, l * WIDTH, true);
    if (l == 4) seg(4, AB_ENC_PT, PT_ENC, WIDTH, 4 * WIDTH, false);
  }
  seg(POINT_INFO, ab_hidden(7), WIDTH, 0, GB_PI, true);
  seg(DIR_INFO, AB_ENC_DIR, DIR_ENC, 0, GB_HD, true);
  seg(DIR_INFO, AB_PI, WIDTH, DIR_ENC, GB_HD, false);
  wg.goff_sigma = goff[SIGMA];
  wg.goff_color = goff[COLOR];
  wg.n_tiles = 0;
  wg.tile[wg.n_tiles++] = HEADS_TILE;
  for (int i = 0; i < n; ++i)
    for (int kt = 0; kt < ceil_div(wg.k[i], WB_TILE); ++kt)
      for (int nt = 0; nt < wg.out[i] / WB_TILE; ++nt)
        wg.tile[wg.n_tiles++] = i << 16 | kt << 8 | nt;
  if (off != N_GRAD || n != N_SEG || wg.n_tiles > MAX_TILES)
    return (int)cudaErrorInvalidValue;

  // ---- per chunk of whole rays ----
  const int c_rays = chunk_rays(n_rays, n_samples);
  const long long c_rows = (long long)c_rays * n_samples;
  bf16* ws_a = wb + PK_SCRATCH;
  bf16* ws_g = ws_a + c_rows * AB_STRIDE;
  float* ws_s = reinterpret_cast<float*>(ws_g + c_rows * GB_STRIDE);
  float* partials = ws_s + c_rows * GS_STRIDE;
  const int rays_per_block = std::max(1, TILE_M / n_samples);
  for (int ray0 = 0; ray0 < n_rays; ray0 += c_rays) {
    const int ray1 = std::min(n_rays, ray0 + c_rays);
    const int rows = (ray1 - ray0) * n_samples;
    kernel<<<ceil_div(ray1 - ray0, rays_per_block), THREADS, sizeof(TcBwdSmem), st>>>(
        coord, g_sigma, g_r, g_g, g_b, p, ws_a, ws_g, ws_s, d_o, d_d, d_ts, n_samples,
        ray0, ray1, rays_per_block);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int splits = ceil_div(rows, WB_SPLIT);
    wgrad_tc_kernel<<<dim3(wg.n_tiles, splits), THREADS, WB_SMEM, st>>>(ws_a, ws_g, ws_s,
                                                                        rows, wg, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_kernel<<<ceil_div(N_GRAD, THREADS), THREADS, 0, st>>>(
        partials, splits, grads, accumulate || ray0 > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The field's recompute backward on `st`, over rows read through `coord`:
// kernel 2 with a RayCoord (see field_rays_bwd.cu for the arguments),
// kernel 4 with a RowCoord (field_flat_bwd.cu; n_rays rows, n_samples =
// 1); fp32 with field_bwd_kernel, bf16 with field_bwd_tc_launch. With
// `accumulate` the weight gradients are added to `grads` (in the same
// fixed order), else they overwrite it. Returns the first launch error, or
// 0.
template <class Coord>
inline int field_bwd_launch(Coord coord, const float* g_sigma, const float* g_r,
                            const float* g_g, const float* g_b, const Params& p,
                            float* d_o, float* d_d, float* d_ts, float* grads,
                            float* workspace, int n_rays, int n_samples, bool bf16,
                            bool accumulate, cudaStream_t st) {
  if (n_rays <= 0 || n_samples <= 0) return 0;
  if ((long long)n_rays * n_samples > 0x7fffffffLL - TILE_M)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return field_bwd_tc_launch(coord, g_sigma, g_r, g_g, g_b, p, d_o, d_d, d_ts, grads,
                               workspace, n_rays, n_samples, accumulate, st);
  auto kernel = &field_bwd_kernel<Coord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;

  // ---- 1. transposed weights ----
  Transpose tr;
  int n = 0;
  auto add = [&](const float* src, int src_ld, int rows, int cols, int dst,
                 int dst_ld) {
    tr.src[n] = src; tr.src_ld[n] = src_ld; tr.rows[n] = rows;
    tr.cols[n] = cols; tr.dst[n] = dst; tr.dst_ld[n] = dst_ld; ++n;
  };
  for (int i = 1; i < 8; ++i)
    add(p.w[i], WIDTH, WIDTH, WIDTH, T_TRUNK + (i - 1) * WIDTH * WIDTH, WIDTH);
  add(p.w[POINT_INFO], WIDTH, WIDTH, WIDTH, T_PI, WIDTH);
  add(p.w[DIR_INFO] + DIR_ENC * (WIDTH / 2), WIDTH / 2, WIDTH, WIDTH / 2, T_DP, WIDTH);
  add(p.w[0], WIDTH, PT_ENC, WIDTH, T_0, 64);
  add(p.w[4] + WIDTH * WIDTH, WIDTH, PT_ENC, WIDTH, T_4E, 64);
  add(p.w[DIR_INFO], WIDTH / 2, DIR_ENC, WIDTH / 2, T_DE, 32);
  float* wt = workspace;
  transpose_kernel<<<dim3(64, N_TRANSPOSE), THREADS, 0, st>>>(tr, wt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // ---- the weight-gradient tiles of every layer ----
  WGrad wg;
  const int a_cols[N_LAYERS] = {A_ENC_PT, a_hidden(0), a_hidden(1), a_hidden(2),
                                a_hidden(3), a_hidden(4), a_hidden(5), a_hidden(6),
                                a_hidden(7), a_hidden(7), A_ENC_DIR, A_HD};
  const int g_cols[N_LAYERS] = {0, WIDTH, 2 * WIDTH, 3 * WIDTH, 4 * WIDTH,
                                5 * WIDTH, 6 * WIDTH, 7 * WIDTH, G_SIGMA, G_PI,
                                G_HD, G_COLOR};
  int goff = 0;
  wg.n_tiles = 0;
  for (int l = 0; l < N_LAYERS; ++l) {
    wg.k[l] = FAN_IN[l]; wg.out[l] = FAN_OUT[l];
    wg.a_col[l] = a_cols[l]; wg.g_col[l] = g_cols[l]; wg.goff[l] = goff;
    goff += (FAN_IN[l] + 1) * FAN_OUT[l];
    for (int kt = 0; kt < ceil_div(FAN_IN[l], WG_TILE); ++kt)
      for (int jt = 0; jt < ceil_div(FAN_OUT[l], WG_TILE); ++jt)
        wg.tile[wg.n_tiles++] = l << 16 | kt << 8 | jt;
  }
  if (goff != N_GRAD || wg.n_tiles > MAX_TILES) return (int)cudaErrorInvalidValue;

  // ---- per chunk of whole rays: 2. recompute + input grads, 3. weight
  // grads, 4. reduce ----
  const int c_rays = chunk_rays(n_rays, n_samples);
  const long long c_rows = (long long)c_rays * n_samples;
  float* ws_a = wt + WT_FLOATS;
  float* ws_g = ws_a + c_rows * A_STRIDE;
  float* partials = ws_g + c_rows * G_STRIDE;
  const int rays_per_block = std::max(1, TILE_M / n_samples);
  for (int ray0 = 0; ray0 < n_rays; ray0 += c_rays) {
    const int ray1 = std::min(n_rays, ray0 + c_rays);
    const int rows = (ray1 - ray0) * n_samples;
    kernel<<<ceil_div(ray1 - ray0, rays_per_block), THREADS, sizeof(Smem), st>>>(
        coord, g_sigma, g_r, g_g, g_b, p, wt, ws_a, ws_g, d_o, d_d, d_ts,
        n_samples, ray0, ray1, rays_per_block);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int splits = ceil_div(rows, SPLIT_ROWS);
    wgrad_kernel<<<dim3(wg.n_tiles, splits), THREADS, 0, st>>>(ws_a, ws_g, rows,
                                                               wg, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_kernel<<<ceil_div(N_GRAD, THREADS), THREADS, 0, st>>>(
        partials, splits, grads, accumulate || ray0 > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// Kernel 2 on `st`: see field_rays_bwd.cu for the arguments.
inline int field_bwd_run(const float* origins, const float* dirs, const float* ts,
                         const float* g_sigma, const float* g_r, const float* g_g,
                         const float* g_b, const Params& p, float* d_o, float* d_d,
                         float* d_ts, float* grads, float* workspace, int n_rays,
                         int n_samples, bool bf16, bool accumulate, cudaStream_t st) {
  return field_bwd_launch(RayCoord{origins, dirs, ts, n_samples}, g_sigma, g_r, g_g,
                          g_b, p, d_o, d_d, d_ts, grads, workspace, n_rays, n_samples,
                          bf16, accumulate, st);
}

}  // namespace
