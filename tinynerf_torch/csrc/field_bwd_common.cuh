// Kernel 2's device code and host orchestration (the field's recompute
// backward), shared by field_rays_bwd.cu and render_fused_bwd.cu, and, read
// through RowCoord, kernel 4's (field_flat_bwd.cu: flat rows of points, one
// sample a "ray"). Its fp32 form runs float32 FMA on its own tiles
// (fma_common.cuh's gemm_f32 for the recompute and the input gradients,
// wgrad_kernel here for the weight gradients), its bf16 form the tensor
// cores (field_tc.cuh). The design note is in field_rays_bwd.cu.

#pragma once

#include <algorithm>
#include <atomic>
#include <cmath>

#include "field_tc.cuh"
#include "fma_common.cuh"

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
constexpr int G_ENC4 = G_COLOR + 3;            // scratch: trunk_4's share of g_enc_pt,
constexpr int G_DPT = G_ENC4;                  // then (ray form) d_pts and d_dir, 6 floats
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
constexpr int SPLIT_ROWS = 4096;     // most rows of a weight-gradient partial sum
constexpr int WG_STAGES = 2;         // K-slab stages of the weight-gradient tiles
constexpr int WG_TILE = 128;         // weight-gradient output tile, (fan-in) x (fan-out)
constexpr int WG_RT = 32;            // rows a weight-gradient K-slab
constexpr int WG_SMEM = WG_STAGES * 2 * WG_RT * WG_TILE * (int)sizeof(float);  // 65,536 bytes
// resident wgrad_kernel blocks the row-slice count is chosen for: an H100
// SXM's 132 SMs x the 2 blocks an SM of its __launch_bounds__. A constant,
// so that the slices, and with them the gradients' bits, follow from the
// shapes alone, whatever card runs the call.
constexpr int WG_SLOTS = 132 * 2;
constexpr int MAX_DEVICES = 64;
constexpr int HEADS_TILE = -1;       // the weight-gradient launch's heads block
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
  int split_rows;       // rows a partial sum (blockIdx.y's slice)
  int n_tiles;
  int tile[MAX_TILES];  // HEADS_TILE, or layer << 16 | k-tile << 8 | out-tile
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

// 220 KB: one block an SM. gemm_f32 reads an encoding row up to K rounded
// up to BWD_KT (see there), the last row's past its end: enc_pt's into
// enc_dir, enc_dir's into enc_pad (zeros).
struct Smem {
  float act[BT_M][WIDTH];
  float enc_pt[BT_M][PT_ENC];
  float enc_dir[BT_M][DIR_ENC];
  float enc_pad[8];
  float genc_dir[BT_M][DIR_ENC];
  float wt[BWD_STAGES * BWD_KT * WIDTH];  // the K-tile stages
  float gsig[BT_M];        // g_sigma * sign(sigma_pre)
  float gcol[BT_M][4];     // g_c * c * (1 - c)
  float dpt[BT_M][3];      // d loss / d point
  float ddir[BT_M][3];     // d loss / d direction, through its encoding
};
static_assert(BWD_KT - DIR_ENC % BWD_KT <= 8, "enc_pad holds enc_dir's last overrun");

// act[r][c] = (relu)(acc + bias[c]) over the thread's rows and columns;
// rows below `valid` are also saved to save[r * A_STRIDE + c]. Ends with a
// barrier.
template <int NC, bool RELU>
__device__ __forceinline__ void put_act(const float (&acc)[ROWS][NC],
                                        const float* __restrict__ bias, float (*act)[WIDTH],
                                        float* __restrict__ save, int valid) {
  static_assert(NC % 4 == 0, "16-byte groups");
  const int row0 = (threadIdx.x >> 5) * ROWS;
#pragma unroll
  for (int g = 0; g < NC / 4; ++g) {
    const int c = col_of<NC>(4 * g);
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c));
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float* a = acc[i] + 4 * g;
      float4 y = make_float4(a[0] + b.x, a[1] + b.y, a[2] + b.z, a[3] + b.w);
      if (RELU) y = make_float4(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f), fmaxf(y.z, 0.f), fmaxf(y.w, 0.f));
      const int r = row0 + i;
      *reinterpret_cast<float4*>(&act[r][c]) = y;
      if (r < valid) *reinterpret_cast<float4*>(save + (size_t)r * A_STRIDE + c) = y;
    }
  }
  __syncthreads();
}

// act[r][c] = acc, times the ReLU mask h > 0 read from `mask` (the tile's
// saved activation) when given; rows below `valid` are also saved to
// save[r * G_STRIDE + c]. Ends with a barrier. The mask was written earlier
// in this launch, so it is read through L2 (__ldcg), never through the
// non-coherent read-only path.
__device__ __forceinline__ void put_grad(const float (&acc)[ROWS][8], float (*act)[WIDTH],
                                         float* __restrict__ save, const float* mask,
                                         int valid) {
  const int row0 = (threadIdx.x >> 5) * ROWS;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c = col_of<8>(4 * g);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = row0 + i;
      const float* a = acc[i] + 4 * g;
      float4 v = make_float4(a[0], a[1], a[2], a[3]);
      if (mask) {
        const float4 m = r < valid
            ? __ldcg(reinterpret_cast<const float4*>(mask + (size_t)r * A_STRIDE + c))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        v = make_float4(m.x > 0.f ? v.x : 0.f, m.y > 0.f ? v.y : 0.f, m.z > 0.f ? v.z : 0.f,
                        m.w > 0.f ? v.w : 0.f);
      }
      *reinterpret_cast<float4*>(&act[r][c]) = v;
      if (r < valid) *reinterpret_cast<float4*>(save + (size_t)r * G_STRIDE + c) = v;
    }
  }
  __syncthreads();
}

// The fp32 form, over rows chunk_begin .. chunk_begin + rows - 1 of the
// call: block b takes an even share of them (rows * b / gridDim.x onward),
// in BT_M-row tiles. Coord is RayCoord (kernel 2: rows are (ray, sample)
// pairs; it writes d_ts and leaves each row's d_pts and d_dir in G for
// ray_sums_kernel) or RowCoord (kernel 4: flat rows; d_o, d_d are each
// row's d_points, d_dirs).
template <class Coord>
__global__ void __launch_bounds__(BT_THREADS, 1)
field_bwd_kernel(Coord coord, const float* __restrict__ g_sigma,
                 const float* __restrict__ g_r,
                 const float* __restrict__ g_g,
                 const float* __restrict__ g_b, Params p,
                 const float* __restrict__ wt, float* __restrict__ ws_a,
                 float* __restrict__ ws_g, float* __restrict__ d_o,
                 float* __restrict__ d_d, float* __restrict__ d_ts,
                 int n_samples, int chunk_begin, int rows) {
  constexpr bool FLAT = Coord::kFlat;
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
  const int row_begin = chunk_begin + (int)((long long)rows * blockIdx.x / gridDim.x);
  const int row_end = chunk_begin + (int)((long long)rows * (blockIdx.x + 1) / gridDim.x);

  if (threadIdx.x < 8) s.enc_pad[threadIdx.x] = 0.f;
  for (int base = row_begin; base < row_end; base += BT_M) {
    const int valid = min(BT_M, row_end - base);
    float* a_tile = ws_a + (size_t)(base - chunk_begin) * A_STRIDE;
    float* g_tile = ws_g + (size_t)(base - chunk_begin) * G_STRIDE;

    // ================= recompute the forward, saving inputs =================
    encode_tile<Coord, BT_M, BT_THREADS>(coord, p.freqs, base, row_end, s.enc_pt, s.enc_dir);
    for (int idx = threadIdx.x; idx < valid * PT_ENC; idx += BT_THREADS)
      a_tile[(size_t)(idx / PT_ENC) * A_STRIDE + A_ENC_PT + idx % PT_ENC] =
          s.enc_pt[idx / PT_ENC][idx % PT_ENC];
    for (int idx = threadIdx.x; idx < valid * DIR_ENC; idx += BT_THREADS)
      a_tile[(size_t)(idx / DIR_ENC) * A_STRIDE + A_ENC_DIR + idx % DIR_ENC] =
          s.enc_dir[idx / DIR_ENC][idx % DIR_ENC];

    float acc[ROWS][8];
    zero(acc);
    gemm_f32<8>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC, p.w[0], s.wt, valid);
    put_act<8, true>(acc, p.b[0], s.act, a_tile + a_hidden(0), valid);
    for (int layer = 1; layer < 8; ++layer) {
      zero(acc);
      gemm_f32<8>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[layer], s.wt, valid);
      if (layer == 4)
        gemm_f32<8>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC, p.w[4] + WIDTH * WIDTH, s.wt,
                    valid);
      put_act<8, true>(acc, p.b[layer], s.act, a_tile + a_hidden(layer), valid);
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
    gemm_f32<8>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[POINT_INFO], s.wt, valid);
    put_act<8, false>(acc, p.b[POINT_INFO], s.act, a_tile + A_PI, valid);

    float acc4[ROWS][4];
    zero(acc4);
    gemm_f32<4>(acc4, &s.enc_dir[0][0], DIR_ENC, DIR_ENC, p.w[DIR_INFO], s.wt, valid);
    gemm_f32<4>(acc4, &s.act[0][0], WIDTH, WIDTH, p.w[DIR_INFO] + DIR_ENC * (WIDTH / 2),
                s.wt, valid);
    put_act<4, true>(acc4, p.b[DIR_INFO], s.act, a_tile + A_HD, valid);

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
      gemm_f32<1>(acc1, &s.act[0][0], WIDTH, WIDTH / 2, wt + T_DE, s.wt, valid);
      if (lane < DIR_ENC)
        for (int i = 0; i < ROWS; ++i) s.genc_dir[row0 + i][lane] = acc1[i][0];
    }
    zero(acc);
    gemm_f32<8>(acc, &s.act[0][0], WIDTH, WIDTH / 2, wt + T_DP, s.wt, valid);
    put_grad(acc, s.act, g_tile + G_PI, nullptr, valid);

    // into h7: gs * w_sigma + g_pi W_pi^T, then relu'(h7)
    zero(acc);
    gemm_f32<8>(acc, &s.act[0][0], WIDTH, WIDTH, wt + T_PI, s.wt, valid);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ws = __ldg(p.w[SIGMA] + col_of<8>(j));
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i][j] += s.gsig[row0 + i] * ws;
    }
    put_grad(acc, s.act, g_tile + 7 * WIDTH, a_tile + a_hidden(7), valid);

    // down the trunk, layers 7..1; the skip layer 4 also feeds g_enc_pt
    for (int layer = 7; layer >= 1; --layer) {
      if (layer == 4) {
        float acc2[ROWS][2];
        zero(acc2);
        gemm_f32<2>(acc2, &s.act[0][0], WIDTH, WIDTH, wt + T_4E, s.wt, valid);
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = col_of<2>(j);
            if (c < PT_ENC && row0 + i < valid)
              g_tile[(size_t)(row0 + i) * G_STRIDE + G_ENC4 + c] = acc2[i][j];
          }
      }
      zero(acc);
      gemm_f32<8>(acc, &s.act[0][0], WIDTH, WIDTH,
                  wt + T_TRUNK + (layer - 1) * WIDTH * WIDTH, s.wt, valid);
      put_grad(acc, s.act, g_tile + (layer - 1) * WIDTH, a_tile + a_hidden(layer - 1),
               valid);
    }

    // layer 0: g_enc_pt = (layer 4's share) + g_pre0 W0^T, into act[:, :60]
    {
      float acc2[ROWS][2];
      zero(acc2);
      gemm_f32<2>(acc2, &s.act[0][0], WIDTH, WIDTH, wt + T_0, s.wt, valid);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = row0 + i, c = col_of<2>(j);
          if (c < PT_ENC) {
            const float g4 =
                r < valid ? __ldcg(g_tile + (size_t)r * G_STRIDE + G_ENC4 + c) : 0.f;
            s.act[r][c] = g4 + acc2[i][j];
          }
        }
    }
    __syncthreads();

    // through the encoding (float32 sin/cos): d x_c = sum_l f_l (g_sin cos - g_cos sin)
    for (int idx = threadIdx.x; idx < BT_M * 3; idx += BT_THREADS) {
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
      for (int idx = threadIdx.x; idx < valid * 3; idx += BT_THREADS) {
        d_o[3 * (size_t)base + idx] = (&s.dpt[0][0])[idx];
        d_d[3 * (size_t)base + idx] = (&s.ddir[0][0])[idx];
      }
    } else {
      // d_ts = d_pts . d; d_pts and d_dir to G for the per-ray sums (G_DPT:
      // trunk_4's share was read above)
      const float* dirs = coord.dirs;
      for (int r = threadIdx.x; r < valid; r += BT_THREADS) {
        const int m = base + r, ray = m / n_samples;
        float v = s.dpt[r][0] * dirs[3 * ray];
        v += s.dpt[r][1] * dirs[3 * ray + 1];
        v += s.dpt[r][2] * dirs[3 * ray + 2];
        d_ts[m] = v;
      }
      for (int idx = threadIdx.x; idx < valid * 6; idx += BT_THREADS) {
        const int r = idx / 6, c = idx % 6;
        g_tile[(size_t)r * G_STRIDE + G_DPT + c] = c < 3 ? s.dpt[r][c] : s.ddir[r][c - 3];
      }
    }
    __syncthreads();
  }
}

// Per ray of rays ray0 .. ray1 - 1 (the chunk), from each sample's d_pts and
// d_dir in G: d_o = sum_n d_pts, d_d = sum_n (d_pts t_n + d_dir), in sample
// order. One thread a (ray, channel).
__global__ void ray_sums_kernel(const float* __restrict__ ws_g, const float* __restrict__ ts,
                                float* __restrict__ d_o, float* __restrict__ d_d,
                                int n_samples, int ray0, int ray1) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (ray1 - ray0) * 3) return;
  const int ray = ray0 + idx / 3, c = idx % 3;
  const float* g = ws_g + (size_t)(idx / 3) * n_samples * G_STRIDE + G_DPT + c;
  const float* t = ts + (size_t)ray * n_samples;
  float so = 0.f, sd = 0.f;
#pragma unroll 8
  for (int n = 0; n < n_samples; ++n) {
    const float dp = __ldg(g + (size_t)n * G_STRIDE);
    so += dp;
    sd += dp * t[n] + __ldg(g + (size_t)n * G_STRIDE + 3);
  }
  d_o[3 * ray + c] = so;
  d_d[3 * ray + c] = sd;
}

// The heads' weight and bias gradients over rows m0 .. m1 - 1: dW_sigma[k] =
// sum h7[k] g_sigma, dW_color[k][c] = sum h_dir[k] g_c, and the bias sums.
// Warp w takes rows m0 + w, m0 + w + 8, ..., lane l columns l + 32 q; the
// warps' sums are then added in warp order through `red` (8 x 644 floats).
__device__ __forceinline__ void heads_wgrad_f32(const float* __restrict__ ws_a,
                                                const float* __restrict__ ws_g, int m0,
                                                int m1, int goff_sigma, int goff_color,
                                                float* out, float* red) {
  constexpr int HR = WIDTH + 3 * (WIDTH / 2) + 4;  // 644: sigma w, color w, the biases
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ws[8], wc[4][3], bs = 0.f, bc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) ws[q] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) wc[q][0] = wc[q][1] = wc[q][2] = 0.f;
  for (int m = m0 + warp; m < m1; m += THREADS / 32) {
    const float* a = ws_a + (size_t)m * A_STRIDE;
    const float* g = ws_g + (size_t)m * G_STRIDE;
    const float gs = __ldg(g + G_SIGMA);
    const float gc[3] = {__ldg(g + G_COLOR), __ldg(g + G_COLOR + 1), __ldg(g + G_COLOR + 2)};
#pragma unroll
    for (int q = 0; q < 8; ++q) ws[q] = fmaf(__ldg(a + a_hidden(7) + lane + 32 * q), gs, ws[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float h = __ldg(a + A_HD + lane + 32 * q);
#pragma unroll
      for (int c = 0; c < 3; ++c) wc[q][c] = fmaf(h, gc[c], wc[q][c]);
    }
    bs += gs;
#pragma unroll
    for (int c = 0; c < 3; ++c) bc[c] += gc[c];
  }
  float* r = red + warp * HR;
#pragma unroll
  for (int q = 0; q < 8; ++q) r[lane + 32 * q] = ws[q];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c) r[WIDTH + 3 * (lane + 32 * q) + c] = wc[q][c];
  if (lane == 0) {
    r[HR - 4] = bs;
    for (int c = 0; c < 3; ++c) r[HR - 3 + c] = bc[c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HR; i += THREADS) {
    float v = red[i];
    for (int w = 1; w < THREADS / 32; ++w) v += red[w * HR + i];
    if (i < WIDTH) out[goff_sigma + i] = v;                   // sigma.w (256 x 1)
    else if (i < HR - 4) out[goff_color + i - WIDTH] = v;     // color.w (128 x 3)
    else if (i == HR - 4) out[goff_sigma + WIDTH] = v;        // sigma.b
    else out[goff_color + 3 * (WIDTH / 2) + i - (HR - 3)] = v;  // color.b
  }
}

// partials[split][goff + k * out + j] = sum over the split's rows (blockIdx.y's
// slice of t.split_rows) of A[row][a_col + k] * G[row][g_col + j], one
// 128 x 128 output tile a block; the k-tile-0 blocks also write the bias
// gradient, sum G[row][g_col + j], at goff + K * out + j; the HEADS_TILE
// block, the heads'. A and G come in WG_RT-row K-slabs that cp.async
// double-buffers (rows past the slice and A columns past the layer's
// fan-in zero-filled). Thread (tx, ty) = (t % 16, t / 16) holds the 8 x 8
// outputs k in {4 ty .. +3, 64 + 4 ty .. +3} x j in {4 tx .. +3, 64 + 4 tx
// .. +3}: two 16-byte reads of A and two of G a row for 64 FMAs. Rows
// ascend, one FMA a term.
__global__ void __launch_bounds__(THREADS, 2)
wgrad_kernel(const float* __restrict__ ws_a, const float* __restrict__ ws_g,
             int rows, WGrad t, float* __restrict__ partials) {
  extern __shared__ float4 smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // [WG_STAGES][WG_RT][WG_TILE], then G's
  float* gs = as + WG_STAGES * WG_RT * WG_TILE;
  const int m0 = blockIdx.y * t.split_rows, m1 = min(rows, m0 + t.split_rows);
  const int packed = t.tile[blockIdx.x];
  if (packed == HEADS_TILE) {
    heads_wgrad_f32(ws_a, ws_g, m0, m1, t.goff[SIGMA], t.goff[COLOR],
                    partials + (size_t)blockIdx.y * N_GRAD, as);
    return;
  }
  const int layer = packed >> 16, kt = (packed >> 8) & 0xff, jt = packed & 0xff;
  const int K = t.k[layer], OUT = t.out[layer];
  const int k_in = min(WG_TILE, K - kt * WG_TILE);
  const float* a_src = ws_a + t.a_col[layer] + kt * WG_TILE;
  const float* g_src = ws_g + t.g_col[layer] + jt * WG_TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool bias = kt == 0 && ty == 0;

  // thread t copies 16 bytes, columns 4 (t % 32) .. +3, of rows t / 32 + 8 q
  // of the slab, of A and of G
  const int lc = 4 * (threadIdx.x & 31), lr = threadIdx.x >> 5;
  auto load = [&](int stage, int m) {
    float* ad = as + (stage * WG_RT + lr) * WG_TILE + lc;
    float* gd = gs + (stage * WG_RT + lr) * WG_TILE + lc;
#pragma unroll
    for (int q = 0; q < WG_RT / (THREADS / 32); ++q) {
      const int row = m + lr + q * (THREADS / 32);
      const bool ok = row < m1;
      const size_t r = ok ? row : m0;  // a valid address when zero-filling
      cp_async16(ad + q * (THREADS / 32) * WG_TILE, a_src + r * A_STRIDE + lc, ok && lc < k_in);
      cp_async16(gd + q * (THREADS / 32) * WG_TILE, g_src + r * G_STRIDE + lc, ok);
    }
    cp_async_commit();
  };

  float acc[8][8], bsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int slabs = (m1 - m0 + WG_RT - 1) / WG_RT;
  for (int st = 0; st + 1 < WG_STAGES; ++st) load(st, m0 + st * WG_RT);
  for (int slab = 0; slab < slabs; ++slab) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // this slab is in, and every thread is done with the last one
    load((slab + WG_STAGES - 1) % WG_STAGES, m0 + (slab + WG_STAGES - 1) * WG_RT);
    const float* A = as + (slab % WG_STAGES) * WG_RT * WG_TILE + 4 * ty;
    const float* G = gs + (slab % WG_STAGES) * WG_RT * WG_TILE + 4 * tx;
#pragma unroll 4
    for (int r = 0; r < WG_RT; ++r) {
      float a[8], g[8];
      load_v<4>(a, A + r * WG_TILE);
      load_v<4>(a + 4, A + r * WG_TILE + WG_TILE / 2);
      load_v<4>(g, G + r * WG_TILE);
      load_v<4>(g + 4, G + r * WG_TILE + WG_TILE / 2);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
      if (bias) {
#pragma unroll
        for (int j = 0; j < 8; ++j) bsum[j] += g[j];
      }
    }
  }

  float* out = partials + (size_t)blockIdx.y * N_GRAD + t.goff[layer];
  const int j0 = jt * WG_TILE + 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = (i / 4) * (WG_TILE / 2) + 4 * ty + i % 4;
    if (k >= k_in) continue;
    float* o = out + (size_t)(kt * WG_TILE + k) * OUT + j0;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[(j / 4) * (WG_TILE / 2) + j % 4] = acc[i][j];
  }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(size_t)K * OUT + j0 + (j / 4) * (WG_TILE / 2) + j % 4] = bsum[j];
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

// Rows a weight-gradient partial sum takes at `rows` rows, `tiles` blocks a
// slice and `slots` resident blocks (WG_SLOTS): of ceil(rows / SPLIT_ROWS)
// to twice as many slices (and at least a K-slab each), the count whose
// tiles x slices blocks fill their last wave best; the fewest on a tie.
inline int wgrad_split_rows(int rows, int tiles, int slots) {
  const int lo = ceil_div(rows, SPLIT_ROWS);
  const int hi = std::max(lo, std::min(2 * lo, ceil_div(rows, WG_RT)));
  int best = lo;
  double best_fill = 0.0;
  for (int s = lo; s <= hi; ++s) {
    const double waves = (double)s * tiles / slots;
    const double fill = waves / std::ceil(waves);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  return ceil_div(rows, best);
}


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

// Float32 elements of workspace field_bwd_run needs for these shapes, in
// either form: the fp32 form's transposed weights, A and G, or the bf16
// form's packed weights, A, G and S; then the weight gradients' partials.
inline long long field_bwd_workspace_floats(int n_rays, int n_samples) {
  if (n_rays <= 0 || n_samples <= 0) return 0;
  const long long rows = (long long)chunk_rays(n_rays, n_samples) * n_samples;
  return std::max(WT_FLOATS + rows * (A_STRIDE + G_STRIDE) +
                      2LL * ceil_div(rows, SPLIT_ROWS) * N_GRAD,
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

// The fp32 recompute grid's size, as many blocks of field_bwd_kernel as the
// current card holds at once, in `*slots`; the shared-memory limits of it and
// wgrad_kernel set. Queried once a device, then read from a cache.
template <class Coord>
inline cudaError_t fp32_bwd_slots(int* slots) {
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (*slots = cached[dev].load()) > 0) return cudaSuccess;
  auto kernel = &field_bwd_kernel<Coord>;
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WG_SMEM);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BT_THREADS,
                                                        sizeof(Smem));
  if (err != cudaSuccess) return err;
  *slots = std::max(1, per_sm) * sms;
  if (dev < MAX_DEVICES) cached[dev].store(*slots);
  return cudaSuccess;
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
  int slots = 0;
  cudaError_t err = fp32_bwd_slots<Coord>(&slots);
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

  // ---- the weight-gradient tiles: the full 128 x 128 ones first, then the
  // edge tiles (fan-in 60, 316, 280), then the heads (sigma, color) ----
  WGrad wg;
  const int a_cols[N_LAYERS] = {A_ENC_PT, a_hidden(0), a_hidden(1), a_hidden(2),
                                a_hidden(3), a_hidden(4), a_hidden(5), a_hidden(6),
                                a_hidden(7), a_hidden(7), A_ENC_DIR, A_HD};
  const int g_cols[N_LAYERS] = {0, WIDTH, 2 * WIDTH, 3 * WIDTH, 4 * WIDTH,
                                5 * WIDTH, 6 * WIDTH, 7 * WIDTH, G_SIGMA, G_PI,
                                G_HD, G_COLOR};
  int goff = 0;
  for (int l = 0; l < N_LAYERS; ++l) {
    wg.k[l] = FAN_IN[l]; wg.out[l] = FAN_OUT[l];
    wg.a_col[l] = a_cols[l]; wg.g_col[l] = g_cols[l]; wg.goff[l] = goff;
    goff += (FAN_IN[l] + 1) * FAN_OUT[l];
  }
  wg.n_tiles = 0;
  for (int edge = 0; edge < 2; ++edge)
    for (int l = 0; l < N_LAYERS; ++l) {
      if (l == SIGMA || l == COLOR) continue;
      for (int kt = 0; kt < ceil_div(FAN_IN[l], WG_TILE); ++kt)
        if ((FAN_IN[l] - kt * WG_TILE < WG_TILE) == (edge == 1))
          for (int jt = 0; jt < FAN_OUT[l] / WG_TILE; ++jt)
            wg.tile[wg.n_tiles++] = l << 16 | kt << 8 | jt;
    }
  wg.tile[wg.n_tiles++] = HEADS_TILE;
  if (goff != N_GRAD || wg.n_tiles > MAX_TILES) return (int)cudaErrorInvalidValue;

  // ---- per chunk of whole rays: 2. recompute + input grads (and, ray form,
  // the per-ray sums), 3. weight grads, 4. reduce ----
  const int c_rays = chunk_rays(n_rays, n_samples);
  const long long c_rows = (long long)c_rays * n_samples;
  float* ws_a = wt + WT_FLOATS;
  float* ws_g = ws_a + c_rows * A_STRIDE;
  float* partials = ws_g + c_rows * G_STRIDE;
  for (int ray0 = 0; ray0 < n_rays; ray0 += c_rays) {
    const int ray1 = std::min(n_rays, ray0 + c_rays);
    const int rows = (ray1 - ray0) * n_samples;
    kernel<<<std::min(ceil_div(rows, BT_M), slots), BT_THREADS, sizeof(Smem), st>>>(
        coord, g_sigma, g_r, g_g, g_b, p, wt, ws_a, ws_g, d_o, d_d, d_ts, n_samples,
        ray0 * n_samples, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if constexpr (!Coord::kFlat) {
      ray_sums_kernel<<<ceil_div(3 * (ray1 - ray0), THREADS), THREADS, 0, st>>>(
          ws_g, coord.ts, d_o, d_d, n_samples, ray0, ray1);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    wg.split_rows = wgrad_split_rows(rows, wg.n_tiles, WG_SLOTS);
    const int splits = ceil_div(rows, wg.split_rows);
    wgrad_kernel<<<dim3(wg.n_tiles, splits), THREADS, WG_SMEM, st>>>(ws_a, ws_g, rows, wg,
                                                                     partials);
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
