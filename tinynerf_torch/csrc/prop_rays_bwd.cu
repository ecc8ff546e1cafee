// Ray-major proposal MLP backward (recompute VJP) for Hopper (sm_90a), plain
// C interface.
//
// Replaces tinynerf/kernels/proposal_kernel.py::_prop_ray_backward /
// _prop_ray_bwd_kernel, the TPU kernel behind the custom VJP of
// prop_field_pallas_rays. Given the rays (origins, dirs (B, 3), ts (B, N))
// and the four (B, N) cotangents of (sigma, r, g, b), it recomputes the
// proposal field and returns the gradients of every weight and bias, of the
// origins and dirs (B, 3) and of ts (B, N), all float32. As in the TPU
// kernel: sigma's cotangent is multiplied by sign(sigma_pre) (0 at 0), the
// ReLU mask is h > 0, the sigmoid's derivative is c (1 - c); in the bf16
// form every trunk pre-activation gradient is rounded to bf16 before its
// products, and the weight gradients stay float32. The chain rule to the
// ray (d_ts = d_pts . d, d_o = sum_n d_pts, d_d = sum_n d_pts t + d_dir, the
// direction's share through its encoding) runs inside the kernel.
//
// What bounds it: FLOPs, 3x the forward's (recompute, input gradients,
// weight gradients): 344,496 a row at 128 x 4.
//
// Design (a simple first kernel; wgmma and TMA are later work). One call is
// three launches on `stream`:
// 1. transpose: every trunk weight, transposed (and layer 0's 60 rows padded
//    to 64 columns) into the workspace, so the input-gradient products
//    reuse the forward's streamed K-tile GEMM (field_common.cuh) unchanged;
// 2. recompute + gradients: a fixed number of blocks (`slices`, as many as
//    fit on the card at once), each owning a fixed slice of whole rays,
//    which it takes in 64-row tiles. Per tile: the encoding and the trunk
//    (each layer's output also to the block's scratch in the workspace, an
//    L2-resident 64 x width x (depth - 1) floats), the heads and their
//    cotangents, then down the trunk: the layer's input read back from the
//    scratch, its weight and bias gradients added into the block's own
//    float32 partial of every gradient (each element owned by one thread,
//    added in row order), the gradient into its input through the
//    transposed weights; the heads' weight gradients accumulate in the
//    owning threads' registers over the whole slice. Then the encoding's
//    backward and the per-ray sums (a ray that straddles two tiles carries
//    its partial sums across);
// 3. reduce: the slices' partials summed in slice order.
// No atomics: two calls give bit-identical results.

#include <algorithm>

#include "prop_common.cuh"

namespace {

template <int NC>
struct BwdSmem {
  static constexpr int W = 32 * NC;
  static constexpr int XS = W < 64 ? 64 : W;  // x also holds g_enc_pt (60 wide)
  float x[TILE_M][XS];       // a layer's input (forward: the running activation)
  float g[TILE_M][W];        // the current pre-activation gradient
  float enc_pt[TILE_M][PT_ENC];
  float enc_dir[TILE_M][DIR_ENC];
  float wt[KT * XS];         // the GEMM's K-tile (OUT = width, or 64 for layer 0's)
  float gsig[TILE_M];        // g_sigma * sign(sigma_pre)
  float gcol[TILE_M][4];     // g_c * c * (1 - c)
  float dpt[TILE_M][3];      // d loss / d point
  float ddir[TILE_M][3];     // d loss / d direction, through its encoding
  float carry[2][6];         // a straddling ray's partial d_o, d_d, by tile parity
};

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

// ---- workspace: the transposed weights, then per slice its scratch and
// its partial gradients (a multiple of 4 floats each, for float4 access) ----
__host__ __device__ constexpr int transposed_offset(int layer, int width) {
  return layer == 0 ? 0 : width * 64 + (layer - 1) * width * width;
}
__host__ __device__ constexpr long long slice_floats(int width, int depth) {
  return (long long)(depth - 1) * TILE_M * width + (grad_floats(width, depth) + 3) / 4 * 4;
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

// dw[k * W + j] += sum over the tile's rows of in[r][k] g[r][j] (k < K, j <
// W = 32 NC) and db[j] += sum_r g[r][j], in row order: 64 x 64 output tiles,
// 4 x 4 elements a thread, added to the block's partial (the same thread
// owns the same elements in every tile). With ROUND_IN the input is rounded
// as it is read (the float32 encoding).
template <int NC, bool ROUND_IN, bool BF16>
__device__ __forceinline__ void wgrad(const float* in, int in_stride, int K, const float* g,
                                      float* __restrict__ dw, float* __restrict__ db) {
  constexpr int W = 32 * NC;
  constexpr int NJT = (W + 63) / 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_tiles = (K + 63) / 64 * NJT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile / NJT * 64 + ty * 4, j0 = tile % NJT * 64 + tx * 4;
    if (k0 >= K || j0 >= W) continue;
    const bool bias = k0 == 0;
    float acc[4][4], bsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bsum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int r = 0; r < TILE_M; ++r) {
      float4 a = *reinterpret_cast<const float4*>(in + r * in_stride + k0);
      if constexpr (ROUND_IN) a = rnd4<BF16>(a);
      const float4 gv = *reinterpret_cast<const float4*>(g + r * W + j0);
      const float av[4] = {a.x, a.y, a.z, a.w}, gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gg[j], acc[i][j]);
      if (bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += gg[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* row = reinterpret_cast<float4*>(dw + (size_t)(k0 + i) * W + j0);
      float4 v = __ldcg(row);
      v.x += acc[i][0]; v.y += acc[i][1]; v.z += acc[i][2]; v.w += acc[i][3];
      *row = v;
    }
    if (bias) {
      float4* row = reinterpret_cast<float4*>(db + j0);
      float4 v = __ldcg(row);
      v.x += bsum[0]; v.y += bsum[1]; v.z += bsum[2]; v.w += bsum[3];
      *row = v;
    }
  }
}

template <int NC, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
prop_rays_bwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const float* __restrict__ ts, const float* __restrict__ g_sigma,
                     const float* __restrict__ g_r, const float* __restrict__ g_g,
                     const float* __restrict__ g_b, PropParams p,
                     const float* __restrict__ wt, float* __restrict__ slices_ws,
                     float* __restrict__ d_o, float* __restrict__ d_d,
                     float* __restrict__ d_ts, int n_samples, int n_rays,
                     int rays_per_slice) {
  constexpr int W = 32 * NC;
  using Smem = BwdSmem<NC>;
  constexpr int XS = Smem::XS;
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, row0 = (tid >> 5) * ROWS;
  const int depth = p.depth;
  const int r0 = blockIdx.x * rays_per_slice, r1 = min(r0 + rays_per_slice, n_rays);
  const int row_begin = r0 * n_samples, row_end = r1 * n_samples;
  float* scratch = slices_ws + (size_t)blockIdx.x * slice_floats(W, depth);
  float* partial = scratch + (size_t)(depth - 1) * TILE_M * W;
  const int off_sigma = sigma_offset(W, depth), off_color = color_offset(W, depth);

  for (int idx = tid; idx < grad_floats(W, depth); idx += THREADS) partial[idx] = 0.f;
  // the heads' weight gradients, owned by thread: w_sigma[tid], w_ch[tid][c]
  // (tid < W); w_ce as flat index tid (< 72), b_sigma (72), b_color (73..75)
  float a_sigma = 0.f, a_ch[3] = {0.f, 0.f, 0.f}, a_small = 0.f;
  __syncthreads();

  int par = 0;
  for (int base = row_begin; base < row_end; base += TILE_M, par ^= 1) {
    const int valid = min(TILE_M, row_end - base);

    // ================= recompute the forward =================
    encode_tile(RayCoord{origins, dirs, ts, n_samples}, p.freqs, base, row_end, s.enc_pt,
                s.enc_dir);
    trunk_fwd<NC, BF16>(p, s.enc_pt, &s.x[0][0], XS, s.wt, scratch);
    for (int i = 0; i < ROWS; ++i) {
      const int r = row0 + i, m = base + r;
      float sigma_pre, x[3];
      heads<NC, BF16>(p, s.x[r], s.enc_dir[r], sigma_pre, x);
      if (lane == 0) {
        const bool ok = r < valid;
        const float sgn = sigma_pre > 0.f ? 1.f : (sigma_pre < 0.f ? -1.f : 0.f);
        s.gsig[r] = ok ? g_sigma[m] * sgn : 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float y = sigmoid(x[c]);
          const float* gin = c == 0 ? g_r : c == 1 ? g_g : g_b;
          s.gcol[r][c] = ok ? (gin[m] * y) * (1.f - y) : 0.f;
        }
      }
    }
    __syncthreads();

    // ================= the heads' weight gradients =================
    if (tid < W) {
      for (int r = 0; r < TILE_M; ++r) {
        const float h = s.x[r][tid];
        a_sigma += h * s.gsig[r];
#pragma unroll
        for (int c = 0; c < 3; ++c) a_ch[c] += h * s.gcol[r][c];
      }
    }
    if (tid < 3 * DIR_ENC) {
      const int e = tid / 3, c = tid % 3;
      for (int r = 0; r < TILE_M; ++r) a_small += rnd<BF16>(s.enc_dir[r][e]) * s.gcol[r][c];
    } else if (tid == 3 * DIR_ENC) {
      for (int r = 0; r < TILE_M; ++r) a_small += s.gsig[r];
    } else if (tid < 3 * DIR_ENC + 4) {
      for (int r = 0; r < TILE_M; ++r) a_small += s.gcol[r][tid - 3 * DIR_ENC - 1];
    }

    // into the last hidden layer: gs w_sigma + sum_c gc w_ch[:, c], then relu'
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int k = lane + 32 * j;
      const float ws = rnd<BF16>(__ldg(p.w_sigma + k));
      const float w0 = rnd<BF16>(__ldg(p.w_color + 3 * (DIR_ENC + k))),
                  w1 = rnd<BF16>(__ldg(p.w_color + 3 * (DIR_ENC + k) + 1)),
                  w2 = rnd<BF16>(__ldg(p.w_color + 3 * (DIR_ENC + k) + 2));
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = row0 + i;
        float v = s.gsig[r] * ws;
        v += s.gcol[r][0] * w0;
        v += s.gcol[r][1] * w1;
        v += s.gcol[r][2] * w2;
        s.g[r][k] = s.x[r][k] > 0.f ? rnd<BF16>(v) : 0.f;
      }
    }
    __syncthreads();

    // ================= down the trunk =================
    for (int layer = depth - 1; layer >= 0; --layer) {
      float* dw = partial + trunk_offset(layer, W);
      if (layer > 0) {
        // the layer's input h_{layer-1}, written by this block this tile
        const float4* src =
            reinterpret_cast<const float4*>(scratch + (size_t)(layer - 1) * TILE_M * W);
        for (int idx = tid; idx < TILE_M * W / 4; idx += THREADS)
          *reinterpret_cast<float4*>(&s.x[idx / (W / 4)][4 * (idx % (W / 4))]) = __ldcg(src + idx);
        __syncthreads();
        wgrad<NC, false, BF16>(&s.x[0][0], XS, W, &s.g[0][0], dw, dw + W * W);
        float acc[ROWS][NC];
        zero(acc);
        gemm_segment<NC, BF16>(acc, &s.g[0][0], W, W, wt + transposed_offset(layer, W), s.wt);
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const int r = row0 + i, c = lane + 32 * j;
            s.g[r][c] = s.x[r][c] > 0.f ? rnd<BF16>(acc[i][j]) : 0.f;
          }
      } else {
        wgrad<NC, true, BF16>(&s.enc_pt[0][0], PT_ENC, PT_ENC, &s.g[0][0], dw, dw + PT_ENC * W);
        float acc2[ROWS][2];
        zero(acc2);
        gemm_segment<2, BF16>(acc2, &s.g[0][0], W, W, wt, s.wt);
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = lane + 32 * j;
            if (c < PT_ENC) s.x[row0 + i][c] = acc2[i][j];  // g_enc_pt
          }
      }
      __syncthreads();
    }

    // through the encoding (float32 sin/cos): d x_c = sum_l f_l (g_sin cos - g_cos sin)
    for (int idx = tid; idx < TILE_M * 3; idx += THREADS) {
      const int r = idx / 3, c = idx % 3;
      float dp = 0.f, dd = 0.f;
#pragma unroll
      for (int l = 0; l < L_PT; ++l) {
        const int k = c * 2 * L_PT + 2 * l;
        const float g = __fsub_rn(__fmul_rn(s.x[r][k], s.enc_pt[r][k + 1]),
                                  __fmul_rn(s.x[r][k + 1], s.enc_pt[r][k]));
        dp = fmaf(g, p.freqs[l], dp);
      }
#pragma unroll
      for (int l = 0; l < L_DIR; ++l) {
        const int k = c * 2 * L_DIR + 2 * l;
        float gs = s.gcol[r][0] * rnd<BF16>(__ldg(p.w_color + 3 * k));
        gs += s.gcol[r][1] * rnd<BF16>(__ldg(p.w_color + 3 * k + 1));
        gs += s.gcol[r][2] * rnd<BF16>(__ldg(p.w_color + 3 * k + 2));
        float gc = s.gcol[r][0] * rnd<BF16>(__ldg(p.w_color + 3 * (k + 1)));
        gc += s.gcol[r][1] * rnd<BF16>(__ldg(p.w_color + 3 * (k + 1) + 1));
        gc += s.gcol[r][2] * rnd<BF16>(__ldg(p.w_color + 3 * (k + 1) + 2));
        const float g = __fsub_rn(__fmul_rn(gs, s.enc_dir[r][k + 1]),
                                  __fmul_rn(gc, s.enc_dir[r][k]));
        dd = fmaf(g, p.freqs[L_PT + l], dd);
      }
      s.dpt[r][c] = dp;
      s.ddir[r][c] = dd;
    }
    __syncthreads();

    // to the ray: d_ts = d_pts . d; per-ray sums in sample order, a ray that
    // began in the previous tile continuing from its carried sums
    for (int r = tid; r < valid; r += THREADS) {
      const int m = base + r, ray = m / n_samples;
      float v = s.dpt[r][0] * dirs[3 * ray];
      v += s.dpt[r][1] * dirs[3 * ray + 1];
      v += s.dpt[r][2] * dirs[3 * ray + 2];
      d_ts[m] = v;
    }
    const int first_ray = base / n_samples, last_ray = (base + valid - 1) / n_samples;
    for (int idx = tid; idx < (last_ray - first_ray + 1) * 3; idx += THREADS) {
      const int ray = first_ray + idx / 3, c = idx % 3;
      const int lo = max(base, ray * n_samples), hi = min(base + valid, (ray + 1) * n_samples);
      const bool begun = ray * n_samples < base;
      float so = begun ? s.carry[par][c] : 0.f, sd = begun ? s.carry[par][3 + c] : 0.f;
      for (int m = lo; m < hi; ++m) {
        so += s.dpt[m - base][c];
        sd += s.dpt[m - base][c] * ts[m] + s.ddir[m - base][c];
      }
      if ((ray + 1) * n_samples <= base + valid) {
        d_o[3 * ray + c] = so;
        d_d[3 * ray + c] = sd;
      } else {
        s.carry[par ^ 1][c] = so;
        s.carry[par ^ 1][3 + c] = sd;
      }
    }
    __syncthreads();
  }

  if (tid < W) {
    partial[off_sigma + tid] = a_sigma;
#pragma unroll
    for (int c = 0; c < 3; ++c) partial[off_color + 3 * (DIR_ENC + tid) + c] = a_ch[c];
  }
  if (tid < 3 * DIR_ENC)
    partial[off_color + tid] = a_small;
  else if (tid == 3 * DIR_ENC)
    partial[off_sigma + W] = a_small;
  else if (tid < 3 * DIR_ENC + 4)
    partial[off_color + 3 * (DIR_ENC + W) + tid - 3 * DIR_ENC - 1] = a_small;
}

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

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Set the kernel's shared memory limit; with `per_sm`, also read how many
// blocks of it fit on an SM.
int configure(int width, int bf16, int* per_sm) {
  return dispatch(width, bf16, [&](auto nc, auto is_bf16) {
    constexpr int NC = decltype(nc)::value;
    auto kernel = &prop_rays_bwd_kernel<NC, decltype(is_bf16)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(BwdSmem<NC>));
    if (err == cudaSuccess && per_sm != nullptr)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS,
                                                          sizeof(BwdSmem<NC>));
    return (int)err;
  });
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the recompute kernel takes.
int prop_rays_bwd_smem_bytes(int width) {
  int bytes = 0;
  dispatch(width, 0, [&](auto nc, auto) {
    bytes = (int)sizeof(BwdSmem<decltype(nc)::value>);
    return 0;
  });
  return bytes;
}

// The number of ray slices (blocks of the recompute launch) for n_rays: as
// many blocks as fit on the current device at once, at most n_rays. The
// partial sums, and so the last bits of the weight gradients, depend on it;
// two calls with the same shapes on the same card use the same number.
int prop_rays_bwd_slices(int n_rays, int width) {
  int dev = 0, sms = 1, per_sm = 1;
  if (n_rays <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      configure(width, 0, &per_sm) != 0)
    return 1;
  return std::max(1, std::min(n_rays, std::max(1, per_sm) * sms));
}

// Float32 elements of workspace prop_rays_bwd needs.
long long prop_rays_bwd_workspace_floats(int width, int depth, int slices) {
  if (!dims_ok(width, depth) || slices <= 0) return 0;
  return (long long)transposed_offset(depth, width) + slices * slice_floats(width, depth);
}

// origins, dirs, d_o, d_d: (n_rays, 3); ts, the cotangents g_* and d_ts:
// (n_rays, n_samples); grads: every weight and bias gradient, layer by layer
// (trunk_0 .. trunk_{depth-1}, sigma, color), each layer's weight (fan_in,
// fan_out) then its bias; workspace: prop_rays_bwd_workspace_floats(width,
// depth, slices) floats. All float32, contiguous, 16-byte aligned, on the
// current device. params: as for prop_rays_fwd. slices:
// prop_rays_bwd_slices(n_rays, width). bf16: nonzero for the bf16 form.
// Launches on `stream` and returns the first launch error, or 0.
int prop_rays_bwd(const float* origins, const float* dirs, const float* ts,
                  const float* g_sigma, const float* g_r, const float* g_g, const float* g_b,
                  const void* const* params, float* d_o, float* d_d, float* d_ts,
                  float* grads, float* workspace, int n_rays, int n_samples, int width,
                  int depth, int slices, int bf16, void* stream) {
  if (!dims_ok(width, depth) || slices <= 0) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0 || n_samples <= 0) return 0;
  if ((long long)n_rays * n_samples > 0x7fffffffLL - TILE_M) return (int)cudaErrorInvalidValue;
  const PropParams p = unpack_prop(params, depth);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = configure(width, bf16, nullptr);
  if (err != 0) return err;

  // ---- 1. transposed weights ----
  transpose_kernel<<<dim3(32, depth), THREADS, 0, st>>>(p, width, workspace);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  // ---- 2. recompute + gradients, one block a slice of whole rays ----
  const int rays_per_slice = ceil_div(n_rays, std::min(slices, n_rays));
  const int used = ceil_div(n_rays, rays_per_slice);
  float* slices_ws = workspace + transposed_offset(depth, width);
  err = dispatch(width, bf16, [&](auto nc, auto is_bf16) {
    constexpr int NC = decltype(nc)::value;
    prop_rays_bwd_kernel<NC, decltype(is_bf16)::value>
        <<<used, THREADS, sizeof(BwdSmem<NC>), st>>>(
            origins, dirs, ts, g_sigma, g_r, g_g, g_b, p, workspace, slices_ws, d_o, d_d,
            d_ts, n_samples, n_rays, rays_per_slice);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;

  // ---- 3. the slices' partials, in order ----
  const int n_grad = grad_floats(width, depth);
  reduce_kernel<<<ceil_div(n_grad, THREADS), THREADS, 0, st>>>(
      slices_ws, slice_floats(width, depth),
      (long long)(depth - 1) * TILE_M * width, used, n_grad, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
