// Ray-major proposal MLP forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/proposal_kernel.py::_prop_ray_forward /
// _prop_ray_fwd_kernel, the TPU kernel that evaluates the proposal field at
// every (ray, sample) pair of the coarse pass (PROP_PALLAS). For each sample
// row it computes the point o + t*d, the float32 positional encoding of the
// point (60) and of the direction (24), the depth x width ReLU trunk and
// both heads (prop_common.cuh), and writes four dense (B, N) float32 planes:
// sigma, r, g, b. It runs in float32 or in the TPU kernel's bf16 form
// (field_common.cuh, the precision note).
//
// What bounds it: FLOPs. At 128 x 4 a row costs 114,832 FLOP and moves 20
// bytes (t in; sigma, r, g, b out); the 84 sines and cosines of the
// encoding are the rest of its work. The weights (232 KB at 128 x 4 in
// float32, 115 KB packed in bf16) stay warm in L2 and stream through shared
// memory.
//
// Design: one block takes consecutive sample rows of the flat B*N index,
// masking the ragged end; the tile's encodings and activations stay in
// shared memory for the whole network, and each layer's weights stream
// through a shared K-tile.
// - fp32: 128-row tiles on fma_common.cuh's float32 FMA tile (gemm_f32:
//   each layer's weights in 16-row K-tiles double-buffered by cp.async, a
//   thread's columns read as 16-byte groups where the width allows): up to
//   width 128, 256 threads, a thread 8 rows x width / 16 columns (8 x 8 at
//   128: 16 FMAs a shared-memory load), two blocks an SM; above it 512
//   threads, 8 rows x width / 32 columns, one block an SM. One activation
//   buffer sized by the width (128 x max(width, 64) floats), overwritten in
//   place layer by layer: 94 KB at 128 x 4, 176 KB at width 256. A 128-row
//   tile streams the weights half as often a row as the 64-row one did.
//   The heads are warp reductions.
// - bf16: the trunk on the tensor cores (prop_common.cuh), the weights
//   packed into bf16 once a call into the caller's `packed` buffer and
//   streamed through a double-buffered 32-row cp.async K-tile; one bf16
//   activation buffer, overwritten in place layer by layer (48-84 KB, so
//   two or more blocks an SM); the heads one thread a (row, output), 4
//   threads a row, with the head weights rounded once a block into shared
//   memory.

#include "prop_common.cuh"

namespace {

// Shared memory of the fp32 forward at width W: the activations (BT_M rows
// of f32_ld(W) floats, the point encoding first), the direction's encoding,
// then the K-tile stages.
__host__ __device__ constexpr int fwd_f32_floats(int width) {
  return BT_M * f32_ld(width) + BT_M * DIR_ENC + BWD_STAGES * BWD_KT * width;
}

// The fp32 forward's threads a group of 8 rows at NC = width / 32 (gemm_f32's
// CW): 16 up to width 128, so that a thread holds 2 NC columns, else 32; and
// its threads a block.
__host__ __device__ constexpr int fwd_f32_cw(int nc) { return nc <= 4 ? 16 : 32; }
__host__ __device__ constexpr int fwd_f32_threads(int nc) { return BT_M / ROWS * fwd_f32_cw(nc); }

template <int NC>
__global__ void __launch_bounds__(fwd_f32_threads(NC), fwd_f32_threads(NC) <= 256 ? 2 : 1)
prop_rays_fwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const float* __restrict__ ts, PropParams p,
                     float* __restrict__ sigma_out, float* __restrict__ r_out,
                     float* __restrict__ g_out, float* __restrict__ b_out, int n_samples,
                     int total) {
  constexpr int W = 32 * NC, LD = f32_ld(W), CW = fwd_f32_cw(NC), TC = W / CW;
  constexpr int NT = fwd_f32_threads(NC);
  extern __shared__ float4 smem_raw[];
  float* act = reinterpret_cast<float*>(smem_raw);
  float* enc_dir = act + BT_M * LD;
  float* wt = enc_dir + BT_M * DIR_ENC;
  const int base = blockIdx.x * BT_M, valid = min(BT_M, total - base);
  encode_f32<BT_M, NT>(RayCoord{origins, dirs, ts, n_samples}, p.freqs, base, total, act, LD,
                       enc_dir);
  for (int layer = 0; layer < p.depth; ++layer) {
    float acc[ROWS][TC];
    zero(acc);
    // the product ends with a barrier, so its output may overwrite its input
    gemm_f32<TC, NT, CW>(acc, act, LD, layer == 0 ? PT_ENC : W, p.w[layer], wt, valid);
    put_relu_f32<TC, CW>(acc, p.b[layer], act, LD, nullptr, 0);
  }
  const int lane = threadIdx.x & 31;
  const HeadWeights<NC> hw(p);
  for (int r = threadIdx.x >> 5; r < BT_M; r += NT / 32) {
    const int m = base + r;
    float sigma_pre, x[3];
    heads<NC>(hw, act + r * LD, enc_dir + r * DIR_ENC, sigma_pre, x);
    if (lane == 0 && m < total) {
      sigma_out[m] = fabsf(sigma_pre);
      r_out[m] = sigmoid(x[0]);
      g_out[m] = sigmoid(x[1]);
      b_out[m] = sigmoid(x[2]);
    }
  }
}

// Shared memory of the bf16 forward at width W: one activation buffer, the
// encodings, two forward K-tiles, then (float32) the rounded head weights.
struct FwdTcLayout {
  int act, enc_pt, enc_dir, wt, hw, wce, bytes;
  explicit FwdTcLayout(int width) {
    int o = 0;
    auto take = [&](int n) {
      const int at = o;
      o += (n + 15) / 16 * 16;
      return at;
    };
    act = take(FWD_M * (width + 8) * 2);
    enc_pt = take(FWD_M * PT_LD * 2);
    enc_dir = take(FWD_M * DIR_ENC * 2);
    wt = take(2 * PWK * (width + 8) * 2);
    hw = take(width * 4 * 4);
    wce = take(3 * DIR_ENC * 4);
    bytes = o;
  }
};

template <int NC>
__global__ void __launch_bounds__(4 * FWD_M, 2)
prop_rays_fwd_tc_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                        const float* __restrict__ ts, PropParams p, FwdTcLayout lay,
                        float* __restrict__ sigma_out, float* __restrict__ r_out,
                        float* __restrict__ g_out, float* __restrict__ b_out, int n_samples,
                        int total) {
  constexpr int W = 32 * NC, LD = W + 8;
  extern __shared__ float4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  bf16* act = reinterpret_cast<bf16*>(sm + lay.act);
  bf16* enc_pt = reinterpret_cast<bf16*>(sm + lay.enc_pt);
  bf16* enc_dir = reinterpret_cast<bf16*>(sm + lay.enc_dir);
  bf16* wt = reinterpret_cast<bf16*>(sm + lay.wt);
  float* hw = reinterpret_cast<float*>(sm + lay.hw);
  float* wce = reinterpret_cast<float*>(sm + lay.wce);
  const int base = blockIdx.x * FWD_M;
  load_head_weights<NC>(p, hw, wce);
  encode_prop_tc<FWD_M>(RayCoord{origins, dirs, ts, n_samples}, p.freqs, base, total, enc_pt,
                        enc_dir);
  float acc[2][NC][4];
  for (int layer = 0; layer < p.depth; ++layer) {
    // the product ends with a barrier, so its output may overwrite its input
    layer_product<FWD_M, NC>(acc, p, layer, layer == 0 ? enc_pt : act, layer == 0 ? PT_LD : LD,
                             wt);
    store_relu_tc<FWD_M, NC>(acc, p.b[layer], act, LD);
  }
  const float pre = head_pre<NC>(p, act, LD, enc_dir, hw, wce);
  const int m = base + (threadIdx.x >> 2), o = threadIdx.x & 3;
  if (m < total) {
    if (o == 0)
      sigma_out[m] = fabsf(pre);
    else
      (o == 1 ? r_out : o == 2 ? g_out : b_out)[m] = sigmoid(pre);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the fp32 form takes at `width`.
int prop_rays_fwd_smem_bytes(int width) {
  return dims_ok(width, 1) ? fwd_f32_floats(width) * (int)sizeof(float) : 0;
}

// bf16 elements of the `packed` buffer the bf16 form takes.
long long prop_packed_weights_elems(int width, int depth) {
  return dims_ok(width, depth) ? pk_elems(width, depth) : 0;
}

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// all float32, contiguous, on the current device. params: 2 * depth + 5
// device pointers (prop_common.cuh, unpack_prop). width: a multiple of 32
// up to 256; depth: 1..64. bf16: nonzero for the bf16 form, which packs the
// weights into `packed` (prop_packed_weights_elems(width, depth) bf16,
// 16-byte aligned; null for fp32). Launches on `stream` and returns the
// first launch error, or cudaErrorInvalidValue for shapes it does not take.
int prop_rays_fwd(const float* origins, const float* dirs, const float* ts,
                  const void* const* params, float* sigma, float* r, float* g, float* b,
                  void* packed, int n_rays, int n_samples, int width, int depth, int bf16,
                  void* stream) {
  if (!dims_ok(width, depth)) return (int)cudaErrorInvalidValue;
  PropParams p = unpack_prop(params, depth);
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  if (total > 0x7fffffffLL - BT_M) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    p.wb = static_cast<const __nv_bfloat16*>(packed);
    const int e = pack_prop(p, width, static_cast<__nv_bfloat16*>(packed), st, false);
    if (e != 0) return e;
    const FwdTcLayout lay(width);
    return dispatch(width, [&](auto nc) {
      auto kernel = &prop_rays_fwd_tc_kernel<decltype(nc)::value>;
      static std::atomic<bool> ready[MAX_DEVICES];
      cudaError_t err = allow_smem(kernel, ready);
      if (err != cudaSuccess) return (int)err;
      kernel<<<(int)((total + FWD_M - 1) / FWD_M), 4 * FWD_M, lay.bytes, st>>>(
          origins, dirs, ts, p, lay, sigma, r, g, b, n_samples, (int)total);
      return (int)cudaGetLastError();
    });
  }
  return dispatch(width, [&](auto nc) {
    auto kernel = &prop_rays_fwd_kernel<decltype(nc)::value>;
    static std::atomic<bool> ready[MAX_DEVICES];
    cudaError_t err = allow_smem(kernel, ready);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(int)((total + BT_M - 1) / BT_M), fwd_f32_threads(decltype(nc)::value),
             fwd_f32_floats(width) * sizeof(float), st>>>(origins, dirs, ts, p, sigma, r, g, b,
                                                           n_samples, (int)total);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
