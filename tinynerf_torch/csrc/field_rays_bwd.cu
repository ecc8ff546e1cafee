// Ray-major NeRF field backward (recompute VJP) for Hopper (sm_90a), plain
// C interface.
//
// Replaces tinynerf/kernels/mlp_kernel.py::_fused_ray_backward /
// _ray_bwd_kernel (+ _trunk_bwd), the TPU kernel behind the custom VJP of
// field_pallas_rays. Given the rays (origins, dirs (B, 3), ts (B, N)) and
// the four (B, N) cotangents of (sigma, r, g, b), it recomputes the field
// forward and returns the gradients of all 24 weights and biases, of the
// origins and dirs (B, 3) and of ts (B, N), all float32. The chain rule to
// the ray (d_ts = d_pts . d, d_o = sum_n d_pts, d_d = sum_n d_pts t + d_dir)
// runs inside the kernel: no (B*N, 3) array reaches device memory. It runs
// in float32 or in the TPU kernel's bf16 form (field_common.cuh, the
// precision note): as there, the head gradients (sigma, color) stay float32
// and every other pre-activation gradient is rounded to bf16; the weight
// gradients and d_o, d_d, d_ts are float32.
//
// What bounds it: FLOPs. A row costs 3x the forward's 1,182,976
// FLOP (recompute, input gradients, weight gradients).
//
// Design (a simple first kernel; wgmma, TMA and 3xTF32 are later work). The
// TPU kernel keeps a 1024-row tile's eight trunk activations in VMEM and
// accumulates the weight gradients across its sequential grid. On Hopper a
// 64-row tile's activations alone (512 KB) exceed a block's 227 KB of
// shared memory, and blocks run concurrently, so one call is four launches,
// all on `stream`:
// 1. transpose: every weight matrix the input-gradient products read is
//    copied transposed (and zero-padded to a multiple of 32 columns) into
//    the workspace, so those products reuse the forward's streamed K-tile
//    GEMM (field_common.cuh) unchanged;
// 2. recompute + input gradients, per 64-row tile: the forward of
//    field_rays_fwd.cu, saving each layer's input to a workspace A, then
//    the heads' gradients and the chain down the trunk with the transposed
//    weights, saving each layer's pre-activation gradient to a workspace G;
//    then the encoding's backward and the per-ray sums. A block owns whole
//    rays (max(1, 64 / N) of them, in 64-row sub-tiles), so the per-ray
//    sums need no second pass;
// 3. weight gradients: dW = A^T G and db = sum G for all 12 layers as one
//    launch of 64 x 64 output tiles, split over the rows into fixed
//    SPLIT_ROWS slices, each slice's partial sums written to its own buffer;
// 4. reduce: the slices' partials summed in a fixed order.
// No atomics: a call is deterministic. Rows are processed in chunks of at
// most CHUNK_ROWS (whole rays), the weight gradients accumulating across
// chunks in order, which caps the workspace at about 1.3 GB.

#include <algorithm>

#include "field_common.cuh"

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
  float ray_do[TILE_M][3];   // per-ray sums of the block's rays
  float ray_dd[TILE_M][3];
};

// act[row_i][col_j] = acc (times the ReLU mask h > 0 read from `mask`, the
// tile's saved activation, when given), rounded with BF16; rows below `valid` are also saved to
// save[row * G_STRIDE + col]. Ends with a barrier. The mask was written
// earlier in this launch, so it is read through L2 (__ldcg), never through
// the non-coherent read-only path.
template <int NC, bool BF16>
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
      float v = rnd<BF16>(acc[i][j]);
      if (mask != nullptr)
        v = (r < valid && __ldcg(mask + (size_t)r * A_STRIDE + c) > 0.f) ? v : 0.f;
      act[r][c] = v;
      if (r < valid) save[(size_t)r * G_STRIDE + c] = v;
    }
  }
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
field_rays_bwd_kernel(const float* __restrict__ origins,
                      const float* __restrict__ dirs,
                      const float* __restrict__ ts,
                      const float* __restrict__ g_sigma,
                      const float* __restrict__ g_r,
                      const float* __restrict__ g_g,
                      const float* __restrict__ g_b, Params p,
                      const float* __restrict__ wt, float* __restrict__ ws_a,
                      float* __restrict__ ws_g, float* __restrict__ d_o,
                      float* __restrict__ d_d, float* __restrict__ d_ts,
                      int n_samples, int ray_begin, int ray_end,
                      int rays_per_block) {
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
    encode_tile(RayCoord{origins, dirs, ts, n_samples}, p.freqs, base,
                row_end, s.enc_pt, s.enc_dir);
    for (int idx = threadIdx.x; idx < valid * PT_ENC; idx += THREADS)
      a_tile[(size_t)(idx / PT_ENC) * A_STRIDE + A_ENC_PT + idx % PT_ENC] =
          rnd<BF16>(s.enc_pt[idx / PT_ENC][idx % PT_ENC]);
    for (int idx = threadIdx.x; idx < valid * DIR_ENC; idx += THREADS)
      a_tile[(size_t)(idx / DIR_ENC) * A_STRIDE + A_ENC_DIR + idx % DIR_ENC] =
          rnd<BF16>(s.enc_dir[idx / DIR_ENC][idx % DIR_ENC]);

    float acc[ROWS][8];
    zero(acc);
    gemm_segment<8, BF16, true>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC, p.w[0], s.wt);
    store<8, true, BF16>(acc, p.b[0], s.act, a_tile + a_hidden(0), A_STRIDE, valid);
    for (int layer = 1; layer < 8; ++layer) {
      zero(acc);
      gemm_segment<8, BF16>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[layer], s.wt);
      if (layer == 4)
        gemm_segment<8, BF16, true>(acc, &s.enc_pt[0][0], PT_ENC, PT_ENC,
                                    p.w[4] + WIDTH * WIDTH, s.wt);
      store<8, true, BF16>(acc, p.b[layer], s.act, a_tile + a_hidden(layer),
                           A_STRIDE, valid);
    }

    // sigma = |pre|: its gradient is g_sigma * sign(pre), sign(0) = 0
    for (int i = 0; i < ROWS; ++i) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < WIDTH / 32; ++q)
        v = fmaf(s.act[row0 + i][lane + 32 * q],
                 rnd<BF16>(__ldg(p.w[SIGMA] + lane + 32 * q)), v);
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
    gemm_segment<8, BF16>(acc, &s.act[0][0], WIDTH, WIDTH, p.w[POINT_INFO], s.wt);
    store<8, false, BF16>(acc, p.b[POINT_INFO], s.act, a_tile + A_PI, A_STRIDE, valid);

    float acc4[ROWS][4];
    zero(acc4);
    gemm_segment<4, BF16, true>(acc4, &s.enc_dir[0][0], DIR_ENC, DIR_ENC,
                                p.w[DIR_INFO], s.wt);
    gemm_segment<4, BF16>(acc4, &s.act[0][0], WIDTH, WIDTH,
                          p.w[DIR_INFO] + DIR_ENC * (WIDTH / 2), s.wt);
    store<4, true, BF16>(acc4, p.b[DIR_INFO], s.act, a_tile + A_HD, A_STRIDE, valid);

    // color = sigmoid(x): its gradient is g_c * c * (1 - c)
    for (int i = 0; i < ROWS; ++i) {
      float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < WIDTH / 2 / 32; ++q) {
        const int k = lane + 32 * q;
        const float h = s.act[row0 + i][k];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[c] = fmaf(h, rnd<BF16>(__ldg(p.w[COLOR] + 3 * k + c)), v[c]);
      }
      const int r = row0 + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = warp_sum(v[c]) + __ldg(p.b[COLOR] + c);
        if (lane == 0) {
          const float y = 1.f / (1.f + expf(-x));
          const float* gin = c == 0 ? g_r : c == 1 ? g_g : g_b;
          const float gc = r < valid ? (gin[base + r] * y) * (1.f - y) : 0.f;
          s.gcol[r][c] = gc;
          if (r < valid) g_tile[(size_t)r * G_STRIDE + G_COLOR + c] = gc;
        }
      }
    }
    __syncthreads();

    // ================= backward =================
    // the view branch: g_hd = relu'(hd) * sum_c gc_c W_color[k][c], rounded
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = lane + 32 * j;
      const float w0 = rnd<BF16>(__ldg(p.w[COLOR] + 3 * k)),
                  w1 = rnd<BF16>(__ldg(p.w[COLOR] + 3 * k + 1)),
                  w2 = rnd<BF16>(__ldg(p.w[COLOR] + 3 * k + 2));
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = row0 + i;
        float g = s.gcol[r][0] * w0;
        g += s.gcol[r][1] * w1;
        g += s.gcol[r][2] * w2;
        g = s.act[r][k] > 0.f ? rnd<BF16>(g) : 0.f;
        s.act[r][k] = g;
        if (r < valid) g_tile[(size_t)r * G_STRIDE + G_HD + k] = g;
      }
    }
    __syncthreads();

    // its inputs [dir_enc, point_info]: g_enc_dir (24 of 32 columns), g_pi
    {
      float acc1[ROWS][1];
      zero(acc1);
      gemm_segment<1, BF16>(acc1, &s.act[0][0], WIDTH, WIDTH / 2, wt + T_DE, s.wt);
      if (lane < DIR_ENC)
        for (int i = 0; i < ROWS; ++i) s.genc_dir[row0 + i][lane] = acc1[i][0];
    }
    zero(acc);
    gemm_segment<8, BF16>(acc, &s.act[0][0], WIDTH, WIDTH / 2, wt + T_DP, s.wt);
    store_grad<8, BF16>(acc, s.act, g_tile + G_PI, nullptr, valid);

    // into h7: gs * w_sigma + g_pi W_pi^T, then relu'(h7)
    zero(acc);
    gemm_segment<8, BF16>(acc, &s.act[0][0], WIDTH, WIDTH, wt + T_PI, s.wt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ws = rnd<BF16>(__ldg(p.w[SIGMA] + lane + 32 * j));
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i][j] += s.gsig[row0 + i] * ws;
    }
    store_grad<8, BF16>(acc, s.act, g_tile + 7 * WIDTH, a_tile + a_hidden(7), valid);

    // down the trunk, layers 7..1; the skip layer 4 also feeds g_enc_pt
    for (int layer = 7; layer >= 1; --layer) {
      if (layer == 4) {
        float acc2[ROWS][2];
        zero(acc2);
        gemm_segment<2, BF16>(acc2, &s.act[0][0], WIDTH, WIDTH, wt + T_4E, s.wt);
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
      gemm_segment<8, BF16>(acc, &s.act[0][0], WIDTH, WIDTH,
                            wt + T_TRUNK + (layer - 1) * WIDTH * WIDTH, s.wt);
      store_grad<8, BF16>(acc, s.act, g_tile + (layer - 1) * WIDTH,
                          a_tile + a_hidden(layer - 1), valid);
    }

    // layer 0: g_enc_pt = (layer 4's share) + g_pre0 W0^T, into act[:, :60]
    {
      float acc2[ROWS][2];
      zero(acc2);
      gemm_segment<2, BF16>(acc2, &s.act[0][0], WIDTH, WIDTH, wt + T_0, s.wt);
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

    // to the ray: d_ts = d_pts . d; per-ray sums in sample order
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
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < (r1 - r0) * 3; idx += THREADS) {
    d_o[3 * r0 + idx] = (&s.ray_do[0][0])[idx];
    d_d[3 * r0 + idx] = (&s.ray_dd[0][0])[idx];
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the recompute kernel takes.
int field_rays_bwd_smem_bytes() { return (int)sizeof(Smem); }

// Float32 elements of workspace field_rays_bwd needs for these shapes.
long long field_rays_bwd_workspace_floats(int n_rays, int n_samples) {
  if (n_rays <= 0 || n_samples <= 0) return 0;
  const long long rows = (long long)chunk_rays(n_rays, n_samples) * n_samples;
  return WT_FLOATS + rows * (A_STRIDE + G_STRIDE) +
         (long long)ceil_div(rows, SPLIT_ROWS) * N_GRAD;
}

// origins, dirs, d_o, d_d: (n_rays, 3); ts, the cotangents g_* and d_ts:
// (n_rays, n_samples); grads: the 593,924 gradients of the weights and
// biases, layer by layer (layer order above), each layer's weight (fan_in,
// fan_out) then its bias; workspace: field_rays_bwd_workspace_floats(...)
// floats. All float32, contiguous, 16-byte aligned, on the current device.
// params: as for field_rays_fwd. bf16: nonzero for the bf16 form. Launches
// on `stream` and returns the first launch error, or 0.
int field_rays_bwd(const float* origins, const float* dirs, const float* ts,
                   const float* g_sigma, const float* g_r, const float* g_g,
                   const float* g_b, const void* const* params, float* d_o,
                   float* d_d, float* d_ts, float* grads, float* workspace,
                   int n_rays, int n_samples, int bf16, void* stream) {
  const Params p = unpack_params(params);
  if (n_rays <= 0 || n_samples <= 0) return 0;
  if ((long long)n_rays * n_samples > 0x7fffffffLL - TILE_M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? &field_rays_bwd_kernel<true> : &field_rays_bwd_kernel<false>;
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
        origins, dirs, ts, g_sigma, g_r, g_g, g_b, p, wt, ws_a, ws_g, d_o, d_d,
        d_ts, n_samples, ray0, ray1, rays_per_block);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int splits = ceil_div(rows, SPLIT_ROWS);
    wgrad_kernel<<<dim3(wg.n_tiles, splits), THREADS, 0, st>>>(ws_a, ws_g, rows,
                                                               wg, partials);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_kernel<<<ceil_div(N_GRAD, THREADS), THREADS, 0, st>>>(
        partials, splits, grads, ray0 > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
