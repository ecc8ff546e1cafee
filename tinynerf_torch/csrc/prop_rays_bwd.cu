// Ray-major proposal MLP backward (recompute VJP) for Hopper (sm_90a), plain
// C interface.
//
// Replaces tinynerf/kernels/proposal_kernel.py::_prop_ray_backward /
// _prop_ray_bwd_kernel, the TPU kernel behind the custom VJP of
// prop_field_pallas_rays. Given the rays (origins, dirs (B, 3), ts (B, N))
// and the four (B, N) cotangents of (sigma, r, g, b), it recomputes the
// proposal field and returns the gradients of every weight and bias and,
// when asked (`rays`), of the origins and dirs (B, 3) and of ts (B, N), all
// float32. As in the TPU kernel: sigma's cotangent is multiplied by
// sign(sigma_pre) (0 at 0), the ReLU mask is h > 0, the sigmoid's derivative
// is c (1 - c); in the bf16 form every trunk pre-activation gradient is
// rounded to bf16 before its products, and the weight gradients stay
// float32. The chain rule to the ray (d_ts = d_pts . d, d_o = sum_n d_pts,
// d_d = sum_n d_pts t + d_dir, the direction's share through its encoding)
// runs inside the kernel; without `rays` the kernel skips it, with the
// layer-0 input-gradient product and the encoding's backward.
//
// What bounds it: FLOPs, 3x the forward's (recompute, input gradients,
// weight gradients): 344,496 a row at 128 x 4.
//
// Design. One call is a few launches on `stream`; a fixed number of blocks
// (`slices`, PROP_SLOTS at most: the shapes alone set it), each owning a
// fixed slice of whole rays, which it takes tile by tile (a ray that
// straddles two tiles carries its partial sums across); each block keeps
// its own float32 partial of every weight gradient (each element owned by
// one thread, added in tile order), and a last launch sums the slices'
// partials in slice order. No atomics: two calls give bit-identical
// results, and the weight gradients do not depend on `rays`.
// - fp32 (float32 FMA on fma_common.cuh's gemm_f32: 16-row weight K-tiles
//   double-buffered by cp.async; 128-row tiles of 512 threads up to width
//   160, else 64-row tiles of 256, one block an SM): every trunk weight
//   transposed into the workspace first, so that the input-gradient
//   products g W^T stream it as the recompute streams W. A tile's
//   activations stay in shared memory as float32, one buffer a layer where
//   they fit, else two (128 x 4: 164 KB), each layer's output then also
//   written to the block's spill in L2 and read back (cp.async) on the way
//   down; each pre-activation gradient overwrites its layer's output in
//   place. The weight gradients X^T G (wgrad_f32: 4 x 8 outputs a thread,
//   32 FMAs a row for three 16-byte reads) go into the block's partial in
//   L2 once per 128 rows, its earlier sums read before the FMAs so that the
//   round trip overlaps them. The heads read their weights once a tile into
//   registers and the tile's cotangents, which are loaded before the
//   recompute, from shared memory; their weight gradients accumulate over
//   the slice in registers, spread over the block's threads by row group.
// - bf16 (the tensor cores, prop_common.cuh; 128-row tiles of 512 threads,
//   one block an SM): the weights packed into bf16 once a call, with a
//   transposed copy and column norms for the fix-up below. A tile's
//   activations stay in shared memory as bf16, one buffer a layer (a net
//   whose activations do not fit keeps two and a bf16 workspace); each
//   layer's pre-activation gradient overwrites its output in place. Down the
//   trunk, per layer: the weight gradients X^T G on the tensor cores into
//   the block's partial in L2 (one read and write of it per 128 rows), then
//   g W^T with W's rows read untransposed, masked and rounded into the
//   layer input's buffer. The heads' weight gradients accumulate in the
//   threads' registers over the whole slice.
//
// The fix-up (bf16 form). A product's output is rounded to bf16 (or cut by
// a ReLU). A float32 sum in another order than the plain version's
// (cuBLAS's, k ascending, one FMA a term) differs from it by a few float32
// ulps, and where that straddles a bf16 rounding boundary (or zero) the two
// round one bf16 ulp apart; downstream that moves other pre-activations
// across their ReLU kinks, so that a row's gradient, amplified by the
// encoding's frequencies (up to 2^9), lands percents of max|plain| away. So
// the recompute lists each layer's outputs whose rounding is ambiguous,
// [v - e, v + e] straddling a boundary with e = FIX_TOL |x_r| |w_c|
// (Cauchy-Schwarz bounds sum_k |x_k w_k| by the row's and the column's
// norms), sums each again in the plain version's order on the float32 FMA
// path (its input row from shared memory, its weight column from the
// transposed copy), and stores that sum's rounding. Outputs past FIX_CAP
// keep the tensor-core sum.

#include <algorithm>

#include "prop_common.cuh"

namespace {

// ---- gradient layout: layer by layer, weight (fan_in, width) then bias ----
__host__ __device__ constexpr int trunk_offset(int layer, int width) {
  return layer == 0 ? 0 : (PT_ENC + 1) * width + (layer - 1) * (width + 1) * width;
}
__host__ __device__ constexpr int sigma_offset(int width, int depth) {
  return trunk_offset(depth, width);
}
__host__ __device__ constexpr int color_offset(int width, int depth) {
  return sigma_offset(width, depth) + width + 1;
}
__host__ __device__ constexpr int grad_floats(int width, int depth) {
  return color_offset(width, depth) + 3 * (DIR_ENC + width) + 3;
}
// a slice's partial, a multiple of 4 floats
__host__ __device__ constexpr long long partial_floats(int width, int depth) {
  return (grad_floats(width, depth) + 3) / 4 * 4;
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// grads[i] = sum over slices, in slice order, of slice s's partial[i].
__global__ void reduce_kernel(const float* __restrict__ slices_ws, long long stride,
                              long long partial_at, int slices, int n_grad,
                              float* __restrict__ grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_grad) return;
  const float* part = slices_ws + partial_at + i;
  float v = part[0];
  for (int s = 1; s < slices; ++s) v += part[(size_t)s * stride];
  grads[i] = v;
}

// Phase clocks of both forms, only in a variant build (-DPROP_PHASE_CLOCKS,
// a separate library that a measurement loads; the main path's library has
// none of it): at each mark the block meets at a barrier and its thread 0
// adds the clock64() cycles since the last mark to phase_clocks[block][i].
#ifdef PROP_PHASE_CLOCKS
constexpr int N_PHASES = 5;
constexpr int MAX_PHASE_BLOCKS = 1024;
__device__ long long phase_clocks[MAX_PHASE_BLOCKS * N_PHASES];
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
struct PhaseClock {
  long long t;
  __device__ PhaseClock() : t(clock_now()) {}
  __device__ void mark(int i) {
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < MAX_PHASE_BLOCKS) {
      const long long now = clock_now();
      phase_clocks[blockIdx.x * N_PHASES + i] += now - t;
      t = now;
    }
  }
};
#else
struct PhaseClock {
  __device__ void mark(int) {}
};
#endif
// The phases (proposal_kernel.PHASES): the bf16 form's slot 1 is its
// fix-up, the fp32 form's the heads (their forward, their weight gradients
// and the gradient into the last hidden layer).
enum { PH_RECOMPUTE, PH_FIXUP, PH_INPUT_GRADS, PH_WEIGHT_GRADS, PH_RAYS };
constexpr int PH_HEADS = PH_FIXUP;

// ---------------------------------------------------------------- fp32 form

// Rows a tile of the fp32 backward at NC = width / 32, with 4 threads a
// row: 128 where two 128-row activation buffers fit in a block's shared
// memory (width <= 160), else 64.
__host__ __device__ constexpr int bwd_f32_rows(int nc) { return nc <= 5 ? 128 : 64; }

// Shared memory of the fp32 backward at `width`, with `slots` activation
// buffers of m rows (floats from the start, each part 16-byte aligned).
struct BwdF32Layout {
  int act, enc_dir, wt, heads, dpt, ddir, carry, floats;
  __host__ __device__ BwdF32Layout(int width, int m, int slots) {
    int o = 0;
    auto take = [&o](int n) {
      const int at = o;
      o += (n + 3) / 4 * 4;
      return at;
    };
    act = take(slots * m * f32_ld(width));
    enc_dir = take(m * DIR_ENC);
    // the K-tile stages: OUT = width, or 64 for layer 0's g W^T
    wt = take(BWD_STAGES * BWD_KT * f32_ld(width));
    heads = take(m * 4);  // gsig, gcol[3] a row
    dpt = take(m * 3);
    ddir = take(m * 3);
    carry = take(2 * 6);
    floats = o;
  }
  __host__ __device__ int bytes() const { return floats * (int)sizeof(float); }
};

// Activation buffers of the fp32 backward: one a layer where they fit in a
// block's shared memory (at least two: buffer 1 also holds the point
// encoding), else two, each layer's output then also saved to the block's
// spill in L2 for the way down.
inline int bwd_f32_slots(int width, int depth) {
  const int all = depth < 2 ? 2 : depth;
  return BwdF32Layout(width, bwd_f32_rows(width / 32), all).bytes() <= MAX_SMEM ? all : 2;
}

// Floats of a slice's spill: h_0 .. h_{depth-3}, each read back once.
inline long long f32_spill_floats(int width, int depth) {
  return bwd_f32_slots(width, depth) < depth
             ? (long long)(depth - 2) * bwd_f32_rows(width / 32) * width : 0;
}

// ---- the fp32 workspace: the transposed weights, then each slice's
// partial, then each slice's spill ----
__host__ __device__ constexpr int transposed_offset(int layer, int width) {
  return layer == 0 ? 0 : width * 64 + (layer - 1) * width * width;
}

// wT[layer]: (width, fan_in padded to 64 for layer 0) row-major, the
// transpose of trunk_layer.w.
__global__ void transpose_kernel(PropParams p, int width, float* __restrict__ wt) {
  const int layer = blockIdx.y;
  const int rows = layer == 0 ? PT_ENC : width, ld = layer == 0 ? 64 : width;
  float* dst = wt + transposed_offset(layer, width);
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < width * ld;
       idx += gridDim.x * blockDim.x) {
    const int j = idx / ld, k = idx % ld;
    dst[idx] = k < rows ? __ldg(p.w[layer] + (size_t)k * width + j) : 0.f;
  }
}

// dw[k * W + j] (+)= sum over the tile's M = NT / 4 rows of x[r][k] g[r][j]
// (k < K, j < W = 32 NC) and db[j] (+)= sum_r g[r][j], rows ascending, one
// FMA a term; x and g in shared memory (row stride ld). With `first` (the
// slice's first tile) the sums are written, else added to what is there:
// each element is owned by one thread, added in tile order. Thread (tx, ty)
// = (t % 16, t / 16) holds, of each (NT / 4) x 128 output tile, k in 4 ty
// .. +3 and j in 4 tx .. +3, 64 + 4 tx .. +3: one 16-byte read of x and two
// of g a row for 32 FMAs. The partial's earlier sums are read before the
// FMAs, so that the L2 round trip overlaps them. Reads shared memory only:
// no barrier.
template <int NC, int NT>
__device__ __forceinline__ void wgrad_f32(const float* x, int K, const float* g, int ld,
                                          float* __restrict__ dw, float* __restrict__ db,
                                          bool first) {
  constexpr int W = 32 * NC, M = NT / 4, KT_OUT = NT / 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k_base = 0; k_base < K; k_base += KT_OUT)
    for (int j_base = 0; j_base < W; j_base += 128) {
      const int k0 = k_base + 4 * ty, j0 = j_base + 4 * tx;
      if (k0 >= K || j0 >= W) continue;
      const bool hi = j0 + 64 < W, bias = k0 == 0;
      float4 old[4][2], ob[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4* row = reinterpret_cast<const float4*>(dw + (size_t)(k0 + i) * W + j0);
        old[i][0] = first ? z4 : __ldcg(row);
        old[i][1] = first || !hi ? z4 : __ldcg(row + 16);
      }
      ob[0] = first || !bias ? z4 : __ldcg(reinterpret_cast<const float4*>(db + j0));
      ob[1] = first || !bias || !hi ? z4 : __ldcg(reinterpret_cast<const float4*>(db + j0 + 64));
      float acc[4][8], bs[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bs[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = 0.f;
      }
#pragma unroll 4
      for (int r = 0; r < M; ++r) {
        float a[4], gv[8];
        load_v<4>(a, x + r * ld + k0);
        load_v<4>(gv, g + r * ld + j0);
        if (hi) {
          load_v<4>(gv + 4, g + r * ld + j0 + 64);
        } else {
#pragma unroll
          for (int j = 4; j < 8; ++j) gv[j] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], gv[j], acc[i][j]);
        if (bias) {
#pragma unroll
          for (int j = 0; j < 8; ++j) bs[j] += gv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* row = reinterpret_cast<float4*>(dw + (size_t)(k0 + i) * W + j0);
        row[0] = make_float4(old[i][0].x + acc[i][0], old[i][0].y + acc[i][1],
                             old[i][0].z + acc[i][2], old[i][0].w + acc[i][3]);
        if (hi)
          row[16] = make_float4(old[i][1].x + acc[i][4], old[i][1].y + acc[i][5],
                                old[i][1].z + acc[i][6], old[i][1].w + acc[i][7]);
      }
      if (bias) {
        float4* row = reinterpret_cast<float4*>(db + j0);
        row[0] = make_float4(ob[0].x + bs[0], ob[0].y + bs[1], ob[0].z + bs[2], ob[0].w + bs[3]);
        if (hi)
          row[16] =
              make_float4(ob[1].x + bs[4], ob[1].y + bs[5], ob[1].z + bs[6], ob[1].w + bs[7]);
      }
    }
}

// x[row_i][col_j] = acc if x[row_i][col_j] > 0, else 0 (row stride ld;
// gemm_f32's rows and columns): a layer's pre-activation gradient in place
// of its output h, masked by h's ReLU. Ends with a barrier.
template <int NC>
__device__ __forceinline__ void put_grad_f32(const float (&acc)[ROWS][NC], float* x, int ld) {
  constexpr int V = vec_of<NC>();
  const int row0 = (threadIdx.x >> 5) * ROWS;
#pragma unroll
  for (int g = 0; g < NC / V; ++g) {
    const int c = col_of<NC>(g * V);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float* at = x + (row0 + i) * ld + c;
      float h[V];
      load_v<V>(h, at);
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = h[v] > 0.f ? acc[i][g * V + v] : 0.f;
      store_v<V>(at, h);
    }
  }
  __syncthreads();
}

// The fp32 recompute backward: one block a slice of whole rays, taken tile
// by tile (M rows, 4 M threads). Per tile: the encoding and the trunk
// recomputed on gemm_f32 (layer l's output in activation buffer slot(l);
// with a spill, also to L2), the heads' forward and gradients, then down
// the trunk per layer: its weight gradients into the slice's partial
// (wgrad_f32), then g_{l-1} = relu'(h_{l-1}) (g_l W_l^T) on gemm_f32 with
// the transposed weights, in place of h_{l-1}; at layer 0 the point
// encoding is recomputed into buffer 1, where the recompute read it.
template <int NC>
__global__ void __launch_bounds__(4 * bwd_f32_rows(NC), 1)
prop_rays_bwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const float* __restrict__ ts, const float* __restrict__ g_sigma,
                     const float* __restrict__ g_r, const float* __restrict__ g_g,
                     const float* __restrict__ g_b, PropParams p,
                     const float* __restrict__ w_t, float* __restrict__ partials,
                     float* __restrict__ spill_ws, float* __restrict__ d_o,
                     float* __restrict__ d_d, float* __restrict__ d_ts, int n_samples,
                     int n_rays, int rays_per_slice, int slots, int rays) {
  constexpr int W = 32 * NC, M = bwd_f32_rows(NC), NT = 4 * M, LD = f32_ld(W);
  // the heads' small gradients (w_ce, b_sigma, b_color) and their row groups
  constexpr int N_SMALL = 3 * DIR_ENC + 4, SMALL_GROUPS = NT / N_SMALL;
  const int depth = p.depth;
  const bool spill = slots < depth;
  const BwdF32Layout lay(W, M, slots);
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* act = sm + lay.act;
  float* enc_dir = sm + lay.enc_dir;
  float* wt = sm + lay.wt;
  float(*hd)[4] = reinterpret_cast<float(*)[4]>(sm + lay.heads);  // gsig, gcol[3]
  float(*dpt)[3] = reinterpret_cast<float(*)[3]>(sm + lay.dpt);
  float(*ddir)[3] = reinterpret_cast<float(*)[3]>(sm + lay.ddir);
  float(*carry)[6] = reinterpret_cast<float(*)[6]>(sm + lay.carry);
  // layer i's activation (then its pre-activation gradient)
  auto slot = [&](int i) { return act + (size_t)(spill ? (i & 1) : i) * M * LD; };
  float* enc_pt = act + (size_t)M * LD;  // buffer 1, free while layer 0 reads it

  const int tid = threadIdx.x, lane = tid & 31, row0 = (tid >> 5) * ROWS;
  const int r0 = blockIdx.x * rays_per_slice, r1 = min(r0 + rays_per_slice, n_rays);
  const int row_begin = r0 * n_samples, row_end = r1 * n_samples;
  float* partial = partials + (size_t)blockIdx.x * partial_floats(W, depth);
  float* scratch = spill ? spill_ws + (size_t)blockIdx.x * (depth - 2) * M * W : nullptr;
  const RayCoord coord{origins, dirs, ts, n_samples};

  // the heads' weight gradients over the slice: thread tid < groups * W owns
  // w_sigma[k] and w_ch[k][c] of column k = tid % W over the tile rows of
  // group tid / W; thread tid < SMALL_GROUPS * N_SMALL owns entry e = tid %
  // N_SMALL (w_ce's flat index e < 72, b_sigma 72, b_color 73..75) over the
  // tile rows of small group tid / N_SMALL; the groups are summed in order
  // at the end
  const int groups = NT / W, col = tid % W, group = tid / W;
  const int g_lo = group * M / groups, g_hi = (group + 1) * M / groups;
  const int e_small = tid % N_SMALL, s_group = tid / N_SMALL;
  const int s_lo = s_group * M / SMALL_GROUPS, s_hi = (s_group + 1) * M / SMALL_GROUPS;
  float a_sigma = 0.f, a_ch[3] = {0.f, 0.f, 0.f}, a_small = 0.f;
  PhaseClock clk;

  int par = 0;
  bool first = true;
  for (int base = row_begin; base < row_end; base += M, par ^= 1, first = false) {
    const int valid = min(M, row_end - base);
    // the tile's cotangents, thread 4 r + o row r's of output o (sigma, r,
    // g, b), read now and stored to hd after the recompute
    float cot = 0.f;
    if (tid / 4 < valid) {
      const int o = tid & 3;
      cot = (o == 0 ? g_sigma : o == 1 ? g_r : o == 2 ? g_g : g_b)[base + tid / 4];
    }

    // ================= recompute the forward =================
    encode_f32<M, NT>(coord, p.freqs, base, row_end, enc_pt, LD, enc_dir);
    for (int layer = 0; layer < depth; ++layer) {
      float acc[ROWS][NC];
      zero(acc);
      gemm_f32<NC, NT>(acc, layer == 0 ? enc_pt : slot(layer - 1), LD,
                       layer == 0 ? PT_ENC : W, p.w[layer], wt, valid);
      put_relu_f32<NC, 32>(acc, p.b[layer], slot(layer), LD,
                       spill && layer + 3 <= depth ? scratch + (size_t)layer * M * W : nullptr,
                       valid);
    }
    (&hd[0][0])[tid] = cot;
    __syncthreads();
    clk.mark(PH_RECOMPUTE);

    // ================= the heads =================
    // sigma = |pre|: its gradient g_sigma sign(pre) (sign(0) = 0); color =
    // sigmoid(x): its gradient g_c c (1 - c)
    float* h = slot(depth - 1);
    {
      const HeadWeights<NC> hw(p);
      for (int r = tid >> 5; r < M; r += NT / 32) {
        float sigma_pre, x[3];
        heads<NC>(hw, h + r * LD, enc_dir + r * DIR_ENC, sigma_pre, x);
        if (lane == 0) {  // rows past `valid` have zero cotangents
          const float sgn = sigma_pre > 0.f ? 1.f : (sigma_pre < 0.f ? -1.f : 0.f);
          hd[r][0] = hd[r][0] * sgn;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float y = sigmoid(x[c]);
            hd[r][1 + c] = (hd[r][1 + c] * y) * (1.f - y);
          }
        }
      }
    }
    __syncthreads();
    if (group < groups) {
      for (int r = g_lo; r < g_hi; ++r) {
        const float hk = h[r * LD + col];
        a_sigma = fmaf(hk, hd[r][0], a_sigma);
#pragma unroll
        for (int c = 0; c < 3; ++c) a_ch[c] = fmaf(hk, hd[r][1 + c], a_ch[c]);
      }
    }
    if (s_group < SMALL_GROUPS) {
      if (e_small < 3 * DIR_ENC) {
        const int e = e_small / 3, c = e_small % 3;
        for (int r = s_lo; r < s_hi; ++r)
          a_small = fmaf(enc_dir[r * DIR_ENC + e], hd[r][1 + c], a_small);
      } else {
        for (int r = s_lo; r < s_hi; ++r) a_small += hd[r][e_small - 3 * DIR_ENC];
      }
    }
    __syncthreads();  // h is read; its gradient overwrites it
    // into the last hidden layer: gs w_sigma + sum_c gc w_ch[:, c], then relu'
    if (group < groups) {
      const float ws = __ldg(p.w_sigma + col);
      const float w0 = __ldg(p.w_color + 3 * (DIR_ENC + col)),
                  w1 = __ldg(p.w_color + 3 * (DIR_ENC + col) + 1),
                  w2 = __ldg(p.w_color + 3 * (DIR_ENC + col) + 2);
      for (int r = group; r < M; r += groups) {
        float v = hd[r][0] * ws;
        v += hd[r][1] * w0;
        v += hd[r][2] * w1;
        v += hd[r][3] * w2;
        float& a = h[r * LD + col];
        a = a > 0.f ? v : 0.f;
      }
    }
    __syncthreads();
    clk.mark(PH_HEADS);

    // ================= down the trunk =================
    for (int layer = depth - 1; layer >= 0; --layer) {
      float* g = slot(layer);
      float* x = layer == 0 ? enc_pt : slot(layer - 1);
      const int K = layer == 0 ? PT_ENC : W;
      if (layer == 0) {
        encode_f32<M, NT>(coord, p.freqs, base, row_end, enc_pt, LD, nullptr);
      } else if (spill && layer <= depth - 2) {
        // h_{layer-1} back from the spill, rows past `valid` zero
        const float* src = scratch + (size_t)(layer - 1) * M * W;
        for (int i = tid; i < M * W / 4; i += NT) {
          const int r = i / (W / 4);
          cp_async16(x + r * LD + 4 * (i % (W / 4)), src + 4 * (r < valid ? i : 0), r < valid);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      float* dw = partial + trunk_offset(layer, W);
      wgrad_f32<NC, NT>(x, K, g, LD, dw, dw + K * W, first);
      clk.mark(PH_WEIGHT_GRADS);
      if (layer > 0) {
        // g_{layer-1} = relu'(h_{layer-1}) (g_layer W^T), in place of h_{layer-1}
        float acc[ROWS][NC];
        zero(acc);
        gemm_f32<NC, NT>(acc, g, LD, W, w_t + transposed_offset(layer, W), wt, valid);
        put_grad_f32<NC>(acc, x, LD);
        clk.mark(PH_INPUT_GRADS);
      } else if (rays) {
        // g_enc_pt = g_0 W_0^T (64 columns, the last 4 zero), in place of g_0
        float acc[ROWS][2];
        zero(acc);
        gemm_f32<2, NT>(acc, g, LD, W, w_t, wt, valid);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) store_v<2>(g + (row0 + i) * LD + col_of<2>(0), acc[i]);
        __syncthreads();
        clk.mark(PH_INPUT_GRADS);
      }
    }
    __syncthreads();  // the next tile's encoding overwrites what layer 0 read
    if (!rays) continue;

    // through the encoding (float32 sin/cos): d x_c = sum_l f_l (g_sin cos - g_cos sin)
    const float* genc = slot(0);
    for (int idx = tid; idx < M * 3; idx += NT) {
      const int r = idx / 3, c = idx % 3;
      float dp = 0.f, dd = 0.f;
#pragma unroll
      for (int l = 0; l < L_PT; ++l) {
        const int k = r * LD + c * 2 * L_PT + 2 * l;
        const float gl = __fsub_rn(__fmul_rn(genc[k], enc_pt[k + 1]),
                                   __fmul_rn(genc[k + 1], enc_pt[k]));
        dp = fmaf(gl, p.freqs[l], dp);
      }
#pragma unroll
      for (int l = 0; l < L_DIR; ++l) {
        const int k = c * 2 * L_DIR + 2 * l;
        float gs = hd[r][1] * __ldg(p.w_color + 3 * k);
        gs += hd[r][2] * __ldg(p.w_color + 3 * k + 1);
        gs += hd[r][3] * __ldg(p.w_color + 3 * k + 2);
        float gc = hd[r][1] * __ldg(p.w_color + 3 * (k + 1));
        gc += hd[r][2] * __ldg(p.w_color + 3 * (k + 1) + 1);
        gc += hd[r][3] * __ldg(p.w_color + 3 * (k + 1) + 2);
        const float gl = __fsub_rn(__fmul_rn(gs, enc_dir[r * DIR_ENC + k + 1]),
                                   __fmul_rn(gc, enc_dir[r * DIR_ENC + k]));
        dd = fmaf(gl, p.freqs[L_PT + l], dd);
      }
      dpt[r][c] = dp;
      ddir[r][c] = dd;
    }
    __syncthreads();

    // to the ray: d_ts = d_pts . d; per-ray sums in sample order, a ray that
    // began in the previous tile continuing from its carried sums
    for (int r = tid; r < valid; r += NT) {
      const int m = base + r, ray = m / n_samples;
      float v = dpt[r][0] * dirs[3 * ray];
      v += dpt[r][1] * dirs[3 * ray + 1];
      v += dpt[r][2] * dirs[3 * ray + 2];
      d_ts[m] = v;
    }
    const int first_ray = base / n_samples, last_ray = (base + valid - 1) / n_samples;
    for (int idx = tid; idx < (last_ray - first_ray + 1) * 3; idx += NT) {
      const int ray = first_ray + idx / 3, c = idx % 3;
      const int lo = max(base, ray * n_samples), hi = min(base + valid, (ray + 1) * n_samples);
      const bool begun = ray * n_samples < base;
      float so = begun ? carry[par][c] : 0.f, sd = begun ? carry[par][3 + c] : 0.f;
      for (int m = lo; m < hi; ++m) {
        so += dpt[m - base][c];
        sd += dpt[m - base][c] * ts[m] + ddir[m - base][c];
      }
      if ((ray + 1) * n_samples <= base + valid) {
        d_o[3 * ray + c] = so;
        d_d[3 * ray + c] = sd;
      } else {
        carry[par ^ 1][c] = so;
        carry[par ^ 1][3 + c] = sd;
      }
    }
    __syncthreads();
    clk.mark(PH_RAYS);
  }

  // the heads' partials: the row groups summed in group order
  float* red = act;  // 5 NT floats: (a_sigma, a_ch) a thread, then a_small
  red[4 * tid] = a_sigma;
#pragma unroll
  for (int c = 0; c < 3; ++c) red[4 * tid + 1 + c] = a_ch[c];
  red[4 * NT + tid] = a_small;
  __syncthreads();
  const int off_sigma = sigma_offset(W, depth), off_color = color_offset(W, depth);
  if (tid < W) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < groups; ++q)
      for (int o = 0; o < 4; ++o) v[o] += red[4 * (q * W + tid) + o];
    partial[off_sigma + tid] = v[0];
    for (int c = 0; c < 3; ++c) partial[off_color + 3 * (DIR_ENC + tid) + c] = v[1 + c];
  }
  if (tid < N_SMALL) {
    float v = 0.f;
    for (int q = 0; q < SMALL_GROUPS; ++q) v += red[4 * NT + q * N_SMALL + tid];
    if (tid < 3 * DIR_ENC)
      partial[off_color + tid] = v;
    else if (tid == 3 * DIR_ENC)
      partial[off_sigma + W] = v;
    else
      partial[off_color + 3 * (DIR_ENC + W) + tid - 3 * DIR_ENC - 1] = v;
  }
}

// ---------------------------------------------------------------- bf16 form

constexpr int BWD_THREADS = 4 * BWD_M;   // 16 warps
constexpr int FIX_CAP = 1024;
// 4 x 2^-24: a few times cuBLAS's own |float32 sum - exact sum| / (2^-24
// |x| |w|) over a trunk's outputs (chip_smoke.py prints the record for the
// 8x256 field, whose fix-up this is)
constexpr float FIX_TOL = 0x1p-22f;

struct FixSmem {
  float xn[BWD_M];              // the current layer input's row norms
  int wsum[BWD_THREADS / 32];   // per-warp counts of ambiguous outputs
  int n;                        // ambiguous outputs of the current layer
  int rc[FIX_CAP];              // their row << 16 | column
};

// Shared memory of the bf16 backward at `width` with `slots` activation
// buffers (bytes from the start).
struct BwdTcLayout {
  int act, enc_pt, enc_dir, wt, hw, wce, heads, gl, dpt, ddir, carry, fix, bytes;
  __host__ __device__ BwdTcLayout(int width, int slots) {
    int o = 0;
    auto take = [&o](int n) {
      const int at = o;
      o += (n + 15) / 16 * 16;
      return at;
    };
    act = take(slots * BWD_M * (width + 8) * 2);
    enc_pt = take(BWD_M * PT_LD * 2);
    enc_dir = take(BWD_M * DIR_ENC * 2);
    // two K-tiles of g W^T (OUT x (PWK + 8), OUT = width or layer 0's
    // PT_PAD), the larger kind
    wt = take(2 * (width > PT_PAD ? width : PT_PAD) * (PWK + 8) * 2);
    hw = take(width * 4 * 4);
    wce = take(3 * DIR_ENC * 4);
    heads = take(BWD_M * 4 * 4);            // gsig, gcol[3] a row
    gl = take(BWD_M * 3 * L_PT * 4);        // the point encoding's g_sin cos - g_cos sin
    dpt = take(BWD_M * 3 * 4);
    ddir = take(BWD_M * 3 * 4);
    carry = take(2 * 6 * 4);
    fix = take((int)sizeof(FixSmem));
    bytes = o;
  }
};
static_assert(BWD_THREADS * 4 * 4 <= BWD_M * 3 * L_PT * 4,
              "the heads' reduction must fit in gl");

// Activation buffers of the bf16 backward: one a layer where they fit in a
// block's shared memory, else two (and a bf16 workspace).
inline int bwd_tc_slots(int width, int depth) {
  return depth <= 2 || BwdTcLayout(width, depth).bytes <= MAX_SMEM ? depth : 2;
}

// xn[r] = |row r of x[:, :cols]|, float32; warp w takes rows 8w .. 8w+7.
// No barrier.
__device__ __forceinline__ void row_norms(const bf16* x, int ld, int cols, float* xn) {
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 8;
  for (int i = 0; i < 8; ++i) {
    float s = 0.f;
    for (int k = lane; k < cols; k += 32) {
      const float v = __bfloat162float(x[(row0 + i) * ld + k]);
      s = fmaf(v, v, s);
    }
    s = warp_sum(s);
    if (lane == 0) xn[row0 + i] = sqrtf(s);
  }
}

// act[r][c] = bf16(relu(acc + bias)), also listing the outputs of rows below
// `valid` whose bf16 rounding is ambiguous (the fix-up), in thread order (a
// block-wide scan: the list is the same every launch), into fx. The input's
// row norms are in fx.xn, the weights' column norms at wn. Ends with a
// barrier.
template <int NC>
__device__ __forceinline__ void store_collect(const float (&acc)[2][NC][4],
                                              const float* __restrict__ bias, bf16* act,
                                              const float* __restrict__ wn, FixSmem& fx,
                                              int valid) {
  constexpr int M = BWD_M, LD = 32 * NC + 8;
  float xr[2][2];  // FIX_TOL |x_r| of this thread's rows (mi, h)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) xr[mi][h] = FIX_TOL * fx.xn[tc_row<M>(mi, 2 * h)];
  uint32_t mask[2] = {0u, 0u};  // bit 4 j + q of mi's word
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tc_col<M, NC>(j, 0);
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
    const float w0 = __ldg(wn + c), w1 = __ldg(wn + c + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tc_row<M>(mi, 2 * h);
        const float v0 = acc[mi][j][2 * h] + b0, v1 = acc[mi][j][2 * h + 1] + b1;
        const float e0 = xr[mi][h] * w0, e1 = xr[mi][h] * w1;
        const uint32_t d0 = pack_bf16x2(v0 - e0, v0 + e0), d1 = pack_bf16x2(v1 - e1, v1 + e1);
        // a ReLU output is ambiguous only if v + e > 0 (else both ends are 0)
        if (r < valid && (d0 & 0xffffu) != (d0 >> 16) && v0 + e0 > 0.f)
          mask[mi] |= 1u << (4 * j + 2 * h);
        if (r < valid && (d1 & 0xffffu) != (d1 >> 16) && v1 + e1 > 0.f)
          mask[mi] |= 1u << (4 * j + 2 * h + 1);
        *reinterpret_cast<uint32_t*>(act + r * LD + c) =
            pack_bf16x2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cnt = __popc(mask[0]) + __popc(mask[1]);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) fx.wsum[warp] = incl;
  __syncthreads();
  int at = incl - cnt;
  for (int w = 0; w < warp; ++w) at += fx.wsum[w];
  if (threadIdx.x == BWD_THREADS - 1) fx.n = at + cnt;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    for (uint32_t m = mask[mi]; m; m &= m - 1) {
      const int bit = __ffs(m) - 1;
      if (at < FIX_CAP) fx.rc[at] = tc_row<M>(mi, bit & 3) << 16 | tc_col<M, NC>(bit >> 2, bit & 3);
      ++at;
    }
  __syncthreads();
}

// For each listed output (r, c): x[r] . w[:, c], k ascending, one float32
// FMA a term (the plain version's order), plus the bias, relu, rounded into
// act[r][c]. x: the layer's input in shared memory (K columns, row stride
// ldx); wT: its transposed weights, row c at c * K (a multiple of 32), read
// from L2 32 columns (four 16-byte loads) at a time. Ends with a barrier.
template <int NC, int K>
__device__ __forceinline__ void fix_apply(const bf16* x, int ldx, const bf16* __restrict__ wT,
                                          const float* __restrict__ bias, bf16* act,
                                          const FixSmem& fx) {
  constexpr int LD = 32 * NC + 8;
  const int n = min(fx.n, FIX_CAP);
  for (int i = threadIdx.x; i < n; i += BWD_THREADS) {
    const int r = fx.rc[i] >> 16, c = fx.rc[i] & 0xffff;
    const uint4* xv = reinterpret_cast<const uint4*>(x + r * ldx);
    const uint4* wv = reinterpret_cast<const uint4*>(wT + (size_t)c * K);
    float a = 0.f;
#pragma unroll
    for (int k32 = 0; k32 < K / 32; ++k32) {
      uint4 wa[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wa[q] = __ldg(wv + 4 * k32 + q);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 xa = xv[4 * k32 + q];
        const uint32_t xw[4] = {xa.x, xa.y, xa.z, xa.w};
        const uint32_t ww[4] = {wa[q].x, wa[q].y, wa[q].z, wa[q].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          a = fmaf(__uint_as_float(xw[h] << 16), __uint_as_float(ww[h] << 16), a);
          a = fmaf(__uint_as_float(xw[h] & 0xffff0000u), __uint_as_float(ww[h] & 0xffff0000u),
                   a);
        }
      }
    }
    act[r * LD + c] = __float2bfloat16_rn(fmaxf(a + __ldg(bias + c), 0.f));
  }
  __syncthreads();
}

// g_{l-1} = bf16(acc * (h_{l-1} > 0)) over the thread's outputs, in place of
// h_{l-1} in act. Ends with a barrier.
template <int NC>
__device__ __forceinline__ void store_grad(const float (&acc)[2][NC][4], bf16* act) {
  constexpr int M = BWD_M, LD = 32 * NC + 8;
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* at = reinterpret_cast<uint32_t*>(act + tc_row<M>(mi, 2 * h) * LD +
                                                   tc_col<M, NC>(j, 0));
        const uint32_t m = *at;
        *at = pack_bf16x2(__uint_as_float(m << 16) > 0.f ? acc[mi][j][2 * h] : 0.f,
                          __uint_as_float(m & 0xffff0000u) > 0.f ? acc[mi][j][2 * h + 1] : 0.f);
      }
  __syncthreads();
}

// dw[k * W + n] (+)= sum over the tile's rows r of x[r][k] g[r][n] (k <
// k_real) and db[n] (+)= sum_r g[r][n], on the tensor cores: 32 x 32 output
// blocks dealt to the warps in turn, each summed over the rows in k32 steps
// (A = x^T and B = g, both read with ldmatrix.trans), the bias sums as a
// block of ones times g. With `first` (the slice's first tile) the sums are
// written, else added to what is there: each element is owned by one thread
// and added in tile order. Reads shared memory only: no barrier.
template <int NC>
__device__ __forceinline__ void wgrad_tc(const bf16* x, int ldx, int K, int k_real,
                                         const bf16* g, float* __restrict__ dw,
                                         float* __restrict__ db, bool first) {
  constexpr int W = 32 * NC, LD = W + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t ones[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
  const int n_blocks = K / 32 * NC;
  for (int blk = warp; blk < n_blocks; blk += BWD_THREADS / 32) {
    const int k0 = blk / NC * 32, n0 = blk % NC * 32;
    const bool bias = k0 == 0;
    float acc[2][4][4], bacc[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[0][nj][q] = acc[1][nj][q] = 0.f;
        bacc[nj][q] = 0.f;
      }
    for (int rr = 0; rr < BWD_M; rr += 32) {
      uint32_t b[2][4][2];  // [k16 step][n8-tile]
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t q[4];
          ldsm_x4_trans(q, g + (rr + 16 * st + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                               nj * 16 + (lane >> 4) * 8);
          b[st][2 * nj][0] = q[0];
          b[st][2 * nj][1] = q[1];
          b[st][2 * nj + 1][0] = q[2];
          b[st][2 * nj + 1][1] = q[3];
        }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[2][4];
#pragma unroll
        for (int st = 0; st < 2; ++st)
          ldsm_x4_trans(a[st], x + (rr + 16 * st + (lane & 7) + (lane >> 4) * 8) * ldx + k0 +
                                   mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16_k32(acc[mi][nj], a[0], b[0][nj][0], b[0][nj][1],
                       a[1], b[1][nj][0], b[1][nj][1]);
      }
      if (bias) {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16_k32(bacc[nj], ones, b[0][nj][0], b[0][nj][1], ones, b[1][nj][0], b[1][nj][1]);
      }
    }
    // the partial's block: every earlier sum read first (one L2 round trip),
    // then added and written back
    float2* out[2][2];  // the thread's rows (mi, h) at column n0 + 2 (lane % 4), or null
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + mi * 16 + (lane >> 2) + 8 * h;
        out[mi][h] = k < k_real
                         ? reinterpret_cast<float2*>(dw + (size_t)k * W + n0 + 2 * (lane & 3))
                         : nullptr;
      }
    float2 sum[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          sum[mi][h][nj] = first || out[mi][h] == nullptr ? make_float2(0.f, 0.f)
                                                          : __ldcg(out[mi][h] + 4 * nj);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (out[mi][h] != nullptr) {
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            __stcg(out[mi][h] + 4 * nj, make_float2(sum[mi][h][nj].x + acc[mi][nj][2 * h],
                                                    sum[mi][h][nj].y + acc[mi][nj][2 * h + 1]));
        }
    if (bias && lane < 4) {  // every row of ones x g is the column sums: row 0's
      float2* ob = reinterpret_cast<float2*>(db + n0 + 2 * lane);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        sum[0][0][nj] = first ? make_float2(0.f, 0.f) : __ldcg(ob + 4 * nj);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        __stcg(ob + 4 * nj,
               make_float2(sum[0][0][nj].x + bacc[nj][0], sum[0][0][nj].y + bacc[nj][1]));
    }
  }
}

// The record of why the fix-up is there: a variant build (-DPROP_NO_FIXUP,
// a library of its own that only a measurement loads) keeps the tensor
// cores' roundings.
#ifdef PROP_NO_FIXUP
constexpr bool FIXUP = false;
#else
constexpr bool FIXUP = true;
#endif

template <int NC>
__global__ void __launch_bounds__(BWD_THREADS, 1)
prop_rays_bwd_tc_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                        const float* __restrict__ ts, const float* __restrict__ g_sigma,
                        const float* __restrict__ g_r, const float* __restrict__ g_g,
                        const float* __restrict__ g_b, PropParams p,
                        float* __restrict__ partials, bf16* __restrict__ spill_ws,
                        float* __restrict__ d_o, float* __restrict__ d_d,
                        float* __restrict__ d_ts, int n_samples, int n_rays,
                        int rays_per_slice, int slots, int rays) {
  constexpr int M = BWD_M, W = 32 * NC, LD = W + 8;
  const int depth = p.depth;
  const bool spill = slots < depth;
  const BwdTcLayout lay(W, slots);
  extern __shared__ float4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  bf16* act = reinterpret_cast<bf16*>(sm + lay.act);
  bf16* enc_pt = reinterpret_cast<bf16*>(sm + lay.enc_pt);
  bf16* enc_dir = reinterpret_cast<bf16*>(sm + lay.enc_dir);
  bf16* wt = reinterpret_cast<bf16*>(sm + lay.wt);
  float* hw = reinterpret_cast<float*>(sm + lay.hw);
  float* wce = reinterpret_cast<float*>(sm + lay.wce);
  float(*hd)[4] = reinterpret_cast<float(*)[4]>(sm + lay.heads);  // gsig, gcol[3]
  float* gl = reinterpret_cast<float*>(sm + lay.gl);
  float(*dpt)[3] = reinterpret_cast<float(*)[3]>(sm + lay.dpt);
  float(*ddir)[3] = reinterpret_cast<float(*)[3]>(sm + lay.ddir);
  float(*carry)[6] = reinterpret_cast<float(*)[6]>(sm + lay.carry);
  FixSmem& fx = *reinterpret_cast<FixSmem*>(sm + lay.fix);
  // layer i's activation (then its pre-activation gradient)
  auto slot = [&](int i) { return act + (size_t)(spill ? (i & 1) : i) * M * LD; };

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rays_per_slice, r1 = min(r0 + rays_per_slice, n_rays);
  const int row_begin = r0 * n_samples, row_end = r1 * n_samples;
  const long long n_pk = pk_elems(W, depth);
  const float* wnorm = reinterpret_cast<const float*>(p.wb + 2 * n_pk);
  float* partial = partials + (size_t)blockIdx.x * partial_floats(W, depth);
  bf16* scratch = spill ? spill_ws + (size_t)blockIdx.x * (depth - 1) * M * W : nullptr;
  const RayCoord coord{origins, dirs, ts, n_samples};
  load_head_weights<NC>(p, hw, wce);

  // the heads' weight gradients over the slice: thread tid < groups * W
  // owns w_sigma[k] and w_ch[k][c] of column k = tid % W over the tile rows
  // of group tid / W; threads tid < 76 also w_ce (flat index tid < 72),
  // b_sigma (72), b_color (73..75) over all rows
  const int groups = BWD_THREADS / W, col = tid % W, group = tid / W;
  const int g_lo = group * M / groups, g_hi = (group + 1) * M / groups;
  float a_sigma = 0.f, a_ch[3] = {0.f, 0.f, 0.f}, a_small = 0.f;
  PhaseClock clk;

  int par = 0;
  bool first = true;
  for (int base = row_begin; base < row_end; base += M, par ^= 1, first = false) {
    const int valid = min(M, row_end - base);

    // ================= recompute the forward, with the fix-up =================
    encode_prop_tc<M>(coord, p.freqs, base, row_end, enc_pt, enc_dir);
    row_norms(enc_pt, PT_LD, PT_PAD, fx.xn);
    for (int layer = 0; layer < depth; ++layer) {
      const bf16* x = layer == 0 ? enc_pt : slot(layer - 1);
      const int ldx = layer == 0 ? PT_LD : LD;
      float acc[2][NC][4];
      layer_product<M, NC>(acc, p, layer, x, ldx, wt);
      store_collect<NC>(acc, p.b[layer], slot(layer), wnorm + layer * W, fx, valid);
      clk.mark(PH_RECOMPUTE);
      if (FIXUP && fx.n > 0) {
        const bf16* wT = p.wb + n_pk + pk_offset(layer, W);
        if (layer == 0)
          fix_apply<NC, PT_PAD>(x, ldx, wT, p.b[0], slot(0), fx);
        else
          fix_apply<NC, W>(x, ldx, wT, p.b[layer], slot(layer), fx);
      }
      if (layer + 1 < depth) {
        // the next layer's store_collect reads these after its product's barriers
        row_norms(slot(layer), LD, W, fx.xn);
        if (spill)
          for (int i = tid; i < M * W / 8; i += BWD_THREADS)
            __stcg(reinterpret_cast<uint4*>(scratch + ((size_t)layer * M + i / (W / 8)) * W) +
                       i % (W / 8),
                   *reinterpret_cast<const uint4*>(slot(layer) + (i / (W / 8)) * LD +
                                                   8 * (i % (W / 8))));
      }
      clk.mark(PH_FIXUP);
    }

    // the heads: sigma = |pre|, its gradient g_sigma sign(pre) (sign(0) = 0);
    // color = sigmoid(x), its gradient g_c c (1 - c)
    const bf16* h = slot(depth - 1);
    {
      const float pre = head_pre<NC>(p, h, LD, enc_dir, hw, wce);
      const int r = tid >> 2, o = tid & 3, m = base + r;
      float gv = 0.f;
      if (r < valid) {
        if (o == 0) {
          gv = g_sigma[m] * (pre > 0.f ? 1.f : (pre < 0.f ? -1.f : 0.f));
        } else {
          const float y = sigmoid(pre);
          gv = ((o == 1 ? g_r : o == 2 ? g_g : g_b)[m] * y) * (1.f - y);
        }
      }
      hd[r][o] = gv;
    }
    __syncthreads();
    clk.mark(PH_RECOMPUTE);

    // ================= the heads' weight gradients =================
    if (group < groups) {
      for (int r = g_lo; r < g_hi; ++r) {
        const float hk = __bfloat162float(h[r * LD + col]);
        a_sigma = fmaf(hk, hd[r][0], a_sigma);
#pragma unroll
        for (int c = 0; c < 3; ++c) a_ch[c] = fmaf(hk, hd[r][1 + c], a_ch[c]);
      }
    }
    if (tid < 3 * DIR_ENC) {
      const int e = tid / 3, c = tid % 3;
      for (int r = 0; r < M; ++r)
        a_small = fmaf(__bfloat162float(enc_dir[r * DIR_ENC + e]), hd[r][1 + c], a_small);
    } else if (tid < 3 * DIR_ENC + 4) {
      const int o = tid - 3 * DIR_ENC;
      for (int r = 0; r < M; ++r) a_small += hd[r][o];
    }
    __syncthreads();  // h is read; its gradient overwrites it
    clk.mark(PH_WEIGHT_GRADS);

    // into the last hidden layer: gs w_sigma + sum_c gc w_ch[:, c], then relu'
    for (int i = tid; i < M * W; i += BWD_THREADS) {
      const int r = i / W, k = i % W;
      float v = hd[r][0] * hw[4 * k];
      v += hd[r][1] * hw[4 * k + 1];
      v += hd[r][2] * hw[4 * k + 2];
      v += hd[r][3] * hw[4 * k + 3];
      bf16& a = slot(depth - 1)[r * LD + k];
      a = __float2bfloat16_rn(__bfloat162float(a) > 0.f ? v : 0.f);
    }
    __syncthreads();
    clk.mark(PH_INPUT_GRADS);

    // ================= down the trunk =================
    for (int layer = depth - 1; layer >= 0; --layer) {
      bf16* x = layer == 0 ? enc_pt : slot(layer - 1);
      const int ldx = layer == 0 ? PT_LD : LD;
      if (spill && layer >= 1 && layer <= depth - 2) {  // h_{layer-1} back from the workspace
        for (int i = tid; i < M * W / 8; i += BWD_THREADS)
          *reinterpret_cast<uint4*>(x + (i / (W / 8)) * LD + 8 * (i % (W / 8))) =
              __ldcg(reinterpret_cast<const uint4*>(
                         scratch + ((size_t)(layer - 1) * M + i / (W / 8)) * W) + i % (W / 8));
        __syncthreads();
      }
      float* dw = partial + trunk_offset(layer, W);
      const int k_real = layer == 0 ? PT_ENC : W;
      wgrad_tc<NC>(x, ldx, layer == 0 ? PT_PAD : W, k_real, slot(layer), dw, dw + k_real * W,
                   first);
      clk.mark(PH_WEIGHT_GRADS);
      if (layer > 0) {
        // g_{layer-1} = relu'(h_{layer-1}) (g_layer W^T), W's rows read as B^T
        float acc[2][NC][4];
        zero_tc(acc);
        gemm_tc<M, NC, false>(acc, slot(layer), LD, W, p.wb + pk_offset(layer, W), W, wt);
        store_grad<NC>(acc, x);
        clk.mark(PH_INPUT_GRADS);
      } else if (rays) {
        // g_enc_pt = g_0 W_0^T; through the encoding (float32 sin/cos,
        // recomputed as encode_prop_tc computed them): g_sin cos - g_cos sin
        float acc[2][2][4];
        zero_tc(acc);
        gemm_tc<M, 2, false>(acc, slot(0), LD, W, p.wb, W, wt);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = tc_row<M>(mi, 2 * hh), k = tc_col<M, 2>(j, 0), m = base + r;
              if (k >= PT_ENC) continue;
              const int c = k / (2 * L_PT), l = k % (2 * L_PT) / 2;
              const float arg = __fmul_rn(m < row_end ? coord(m, c, true) : 0.f, p.freqs[l]);
              gl[r * 3 * L_PT + c * L_PT + l] =
                  __fsub_rn(__fmul_rn(acc[mi][j][2 * hh], cosf(arg)),
                            __fmul_rn(acc[mi][j][2 * hh + 1], sinf(arg)));
            }
        __syncthreads();
      }
    }
    __syncthreads();  // the next tile's encoding overwrites what layer 0 read
    if (!rays) continue;

    // d x_c = sum_l f_l (g_sin cos - g_cos sin), the point's and the
    // direction's (through the color head's w_ce)
    for (int idx = tid; idx < M * 3; idx += BWD_THREADS) {
      const int r = idx / 3, c = idx % 3, m = base + r;
      float dp = 0.f, dd = 0.f;
#pragma unroll
      for (int l = 0; l < L_PT; ++l) dp = fmaf(gl[r * 3 * L_PT + c * L_PT + l], p.freqs[l], dp);
      const float xd = m < row_end ? coord(m, c, false) : 0.f;
#pragma unroll
      for (int l = 0; l < L_DIR; ++l) {
        const int k = c * 2 * L_DIR + 2 * l;
        float gs = hd[r][1] * wce[3 * k];
        gs += hd[r][2] * wce[3 * k + 1];
        gs += hd[r][3] * wce[3 * k + 2];
        float gc = hd[r][1] * wce[3 * (k + 1)];
        gc += hd[r][2] * wce[3 * (k + 1) + 1];
        gc += hd[r][3] * wce[3 * (k + 1) + 2];
        const float arg = __fmul_rn(xd, p.freqs[L_PT + l]);
        const float g = __fsub_rn(__fmul_rn(gs, cosf(arg)), __fmul_rn(gc, sinf(arg)));
        dd = fmaf(g, p.freqs[L_PT + l], dd);
      }
      dpt[r][c] = dp;
      ddir[r][c] = dd;
    }
    __syncthreads();

    // to the ray: d_ts = d_pts . d; per-ray sums in sample order, a ray that
    // began in the previous tile continuing from its carried sums
    for (int r = tid; r < valid; r += BWD_THREADS) {
      const int m = base + r, ray = m / n_samples;
      float v = dpt[r][0] * dirs[3 * ray];
      v += dpt[r][1] * dirs[3 * ray + 1];
      v += dpt[r][2] * dirs[3 * ray + 2];
      d_ts[m] = v;
    }
    const int first_ray = base / n_samples, last_ray = (base + valid - 1) / n_samples;
    for (int idx = tid; idx < (last_ray - first_ray + 1) * 3; idx += BWD_THREADS) {
      const int ray = first_ray + idx / 3, c = idx % 3;
      const int lo = max(base, ray * n_samples), hi = min(base + valid, (ray + 1) * n_samples);
      const bool begun = ray * n_samples < base;
      float so = begun ? carry[par][c] : 0.f, sd = begun ? carry[par][3 + c] : 0.f;
      for (int m = lo; m < hi; ++m) {
        so += dpt[m - base][c];
        sd += dpt[m - base][c] * ts[m] + ddir[m - base][c];
      }
      if ((ray + 1) * n_samples <= base + valid) {
        d_o[3 * ray + c] = so;
        d_d[3 * ray + c] = sd;
      } else {
        carry[par ^ 1][c] = so;
        carry[par ^ 1][3 + c] = sd;
      }
    }
    __syncthreads();
    clk.mark(PH_RAYS);
  }

  // the heads' partials: the column groups summed in group order
  float(*red)[4] = reinterpret_cast<float(*)[4]>(gl);
  red[tid][0] = a_sigma;
  for (int c = 0; c < 3; ++c) red[tid][1 + c] = a_ch[c];
  __syncthreads();
  const int off_sigma = sigma_offset(W, depth), off_color = color_offset(W, depth);
  if (tid < W) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < groups; ++q)
      for (int o = 0; o < 4; ++o) v[o] += red[q * W + tid][o];
    partial[off_sigma + tid] = v[0];
    for (int c = 0; c < 3; ++c) partial[off_color + 3 * (DIR_ENC + tid) + c] = v[1 + c];
  }
  if (tid < 3 * DIR_ENC)
    partial[off_color + tid] = a_small;
  else if (tid == 3 * DIR_ENC)
    partial[off_sigma + W] = a_small;
  else if (tid < 3 * DIR_ENC + 4)
    partial[off_color + 3 * (DIR_ENC + W) + tid - 3 * DIR_ENC - 1] = a_small;
}

// ---- the bf16 workspace, in floats: the packing (pk_fixup_elems bf16),
// then each slice's partial, then each slice's spilled activations (when
// they do not fit in shared memory) ----
inline long long bf16_pack_floats(int width, int depth) {
  return (pk_fixup_elems(width, depth) / 2 + 3) / 4 * 4;
}
inline long long spill_floats(int width, int depth) {
  return bwd_tc_slots(width, depth) < depth ? (long long)(depth - 1) * BWD_M * width / 2 : 0;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the fp32 recompute kernel
// takes at width x depth.
int prop_rays_bwd_smem_bytes(int width, int depth) {
  if (!dims_ok(width, depth)) return 0;
  return BwdF32Layout(width, bwd_f32_rows(width / 32), bwd_f32_slots(width, depth)).bytes();
}

// The number of ray slices for n_rays: PROP_SLOTS at most. It depends on the
// shapes alone, and the weight gradients' last bits on it.
int prop_rays_bwd_slices(int n_rays) { return std::max(1, std::min(n_rays, PROP_SLOTS)); }

// Float32 elements of workspace prop_rays_bwd needs, in either form.
long long prop_rays_bwd_workspace_floats(int width, int depth, int slices) {
  if (!dims_ok(width, depth) || slices <= 0) return 0;
  return std::max((long long)transposed_offset(depth, width) +
                      slices * (partial_floats(width, depth) + f32_spill_floats(width, depth)),
                  bf16_pack_floats(width, depth) +
                      slices * (partial_floats(width, depth) + spill_floats(width, depth)));
}

// origins, dirs, d_o, d_d: (n_rays, 3); ts, the cotangents g_* and d_ts:
// (n_rays, n_samples); grads: every weight and bias gradient, layer by layer
// (trunk_0 .. trunk_{depth-1}, sigma, color), each layer's weight (fan_in,
// fan_out) then its bias; workspace: prop_rays_bwd_workspace_floats(width,
// depth, slices) floats. All float32, contiguous, 16-byte aligned, on the
// current device. params: as for prop_rays_fwd. slices:
// prop_rays_bwd_slices(n_rays). bf16: nonzero for the bf16 form. rays:
// nonzero to compute d_o, d_d and d_ts; with 0 they are not written (and
// may be null). Launches on `stream` and returns the first launch error, or
// 0.
int prop_rays_bwd(const float* origins, const float* dirs, const float* ts,
                  const float* g_sigma, const float* g_r, const float* g_g, const float* g_b,
                  const void* const* params, float* d_o, float* d_d, float* d_ts,
                  float* grads, float* workspace, int n_rays, int n_samples, int width,
                  int depth, int slices, int bf16, int rays, void* stream) {
  if (!dims_ok(width, depth) || slices <= 0) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0 || n_samples <= 0) return 0;
  if ((long long)n_rays * n_samples > 0x7fffffffLL - BWD_M) return (int)cudaErrorInvalidValue;
  PropParams p = unpack_prop(params, depth);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rays_per_slice = ceil_div(n_rays, std::min(slices, n_rays));
  const int used = ceil_div(n_rays, rays_per_slice);
  const int n_grad = grad_floats(width, depth);
  int err = 0;

  if (bf16) {
    // ---- 1. the weights packed, with the fix-up's copy and norms ----
    __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(workspace);  // `bf16` is a flag here
    if ((err = pack_prop(p, width, wb, st, true)) != 0) return err;
    p.wb = wb;
    // ---- 2. recompute + gradients, one block a slice of whole rays ----
    float* partials = workspace + bf16_pack_floats(width, depth);
    auto* spill =
        reinterpret_cast<__nv_bfloat16*>(partials + slices * partial_floats(width, depth));
    const int slots = bwd_tc_slots(width, depth);
    err = dispatch(width, [&](auto nc) {
      auto kernel = &prop_rays_bwd_tc_kernel<decltype(nc)::value>;
      static std::atomic<bool> ready[MAX_DEVICES];
      cudaError_t e = allow_smem(kernel, ready);
      if (e != cudaSuccess) return (int)e;
      kernel<<<used, BWD_THREADS, BwdTcLayout(width, slots).bytes, st>>>(
          origins, dirs, ts, g_sigma, g_r, g_g, g_b, p, partials, spill, d_o, d_d, d_ts,
          n_samples, n_rays, rays_per_slice, slots, rays);
      return (int)cudaGetLastError();
    });
    if (err != 0) return err;
    // ---- 3. the slices' partials, in order ----
    reduce_kernel<<<ceil_div(n_grad, THREADS), THREADS, 0, st>>>(
        partials, partial_floats(width, depth), 0, used, n_grad, grads);
    return (int)cudaGetLastError();
  }

  // ---- 1. transposed weights ----
  transpose_kernel<<<dim3(32, depth), THREADS, 0, st>>>(p, width, workspace);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  // ---- 2. recompute + gradients, one block a slice of whole rays ----
  float* partials = workspace + transposed_offset(depth, width);
  float* spill = partials + slices * partial_floats(width, depth);
  const int slots = bwd_f32_slots(width, depth);
  err = dispatch(width, [&](auto nc) {
    constexpr int NC = decltype(nc)::value, M = bwd_f32_rows(NC);
    const BwdF32Layout lay(32 * NC, M, slots);
    if (lay.bytes() > MAX_SMEM) return (int)cudaErrorInvalidValue;
    auto kernel = &prop_rays_bwd_kernel<NC>;
    static std::atomic<bool> ready[MAX_DEVICES];
    cudaError_t e = allow_smem(kernel, ready);
    if (e != cudaSuccess) return (int)e;
    kernel<<<used, 4 * M, lay.bytes(), st>>>(origins, dirs, ts, g_sigma, g_r, g_g, g_b, p,
                                             workspace, partials, spill, d_o, d_d, d_ts,
                                             n_samples, n_rays, rays_per_slice, slots, rays);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  // ---- 3. the slices' partials, in order ----
  reduce_kernel<<<ceil_div(n_grad, THREADS), THREADS, 0, st>>>(
      partials, partial_floats(width, depth), 0, used, n_grad, grads);
  return (int)cudaGetLastError();
}

#ifdef PROP_PHASE_CLOCKS
// Copy the backward's phase clocks (MAX_PHASE_BLOCKS x N_PHASES int64)
// to host memory and zero them. Returns a CUDA error, or 0.
int prop_rays_bwd_phase_clocks(long long* out) {
  const size_t bytes = sizeof(long long) * MAX_PHASE_BLOCKS * N_PHASES;
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_clocks, bytes);
  if (err != cudaSuccess) return (int)err;
  static long long zeros[MAX_PHASE_BLOCKS * N_PHASES];
  return (int)cudaMemcpyToSymbol(phase_clocks, zeros, bytes);
}
#endif

}  // extern "C"
