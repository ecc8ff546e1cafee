// Ray-major NeRF field forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/mlp_kernel.py::_fused_ray_forward /
// _ray_fwd_kernel, the TPU kernel that evaluates the reference field at
// every (ray, sample) pair of a render chunk. For each sample row it
// computes the point o + t*d, the float32 positional encoding of the point
// (60) and of the direction (24), the 8x256 skip MLP with its heads, and
// writes four dense (B, N) float32 planes: sigma, r, g, b. It runs in
// float32 or in the TPU kernel's bf16 form (field_common.cuh, the precision
// note).
//
// What bounds it: FLOPs. A row costs 2 * 591,488 = 1,182,976 FLOP and moves
// 20 bytes (t in; sigma, r, g, b out), so at any real B*N the work is far
// above the card's FLOP-per-byte ridge. The weights (2.38 MB in float32,
// 1.19 MB packed in bf16) do not fit in a block's shared memory, as they
// fit in a TPU core's VMEM; they stay warm in the 50 MB L2 and are streamed
// through shared memory.
//
// Design:
// - one block of 256 threads takes TILE_M = 64 consecutive sample rows of
//   the flat B*N index, masking the ragged end instead of padding;
// - the tile's encodings and its 64 x 256 activations live in shared
//   memory for the whole network, and each layer's weights stream through
//   a shared K-tile from L2;
// - fp32 (field_common.cuh, network_fwd): each thread holds an 8-row x
//   (OUT/32)-column register tile, accumulated with float32 FMA, and the
//   weights stream through a 16-row K-tile;
// - bf16 (field_tc.cuh, network_tc): the weights are packed into bf16 once
//   a call (pack_weights, into the caller's `packed` buffer), and every
//   product runs on the tensor cores (mma.sync m16n8k16, f32 accumulation),
//   the weights streaming through a double-buffered 32-row K-tile with
//   cp.async;
// - bias and ReLU are fused into the store; the heads (sigma: abs, color:
//   sigmoid) are float32 warp reductions;
// - 103 KB of shared memory a block (the bf16 tile uses 85 KB of it) lets
//   two blocks share an SM, so one block's weight loads overlap the
//   other's products;
// - the saving form (SAVE, field_rays_fwd_res: bf16, where a backward
//   follows) runs the tile as kernel 2's recompute runs it
//   (forward_fixup_tc: the weights packed with the fix-up's transposed copy
//   and norms, the fix-up on) and keeps, for field_rays_bwd_res, each
//   layer's input (A, AB_STRIDE bf16 a row) and sign(sigma's
//   pre-activation); its planes come from the fixed-up activations. Its
//   least time is A's writes (5,056 bytes a row), not its FLOPs. Frames
//   and every call without a backward launch the form without it.

#include "field_tc.cuh"
#include "launch_cache.cuh"

namespace {

template <bool BF16, bool SAVE = false>
__global__ void __launch_bounds__(THREADS, 2)
field_rays_fwd_kernel(const float* __restrict__ origins,
                      const float* __restrict__ dirs,
                      const float* __restrict__ ts, Params p,
                      float* __restrict__ sigma_out, float* __restrict__ r_out,
                      float* __restrict__ g_out, float* __restrict__ b_out,
                      int n_samples, int total, bf16* __restrict__ res_a,
                      float* __restrict__ res_sign) {
  extern __shared__ float4 smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int base = blockIdx.x * TILE_M;
  const RayCoord coord{origins, dirs, ts, n_samples};
  if constexpr (SAVE) {
    static_assert(BF16, "the saving form is the bf16 form's");
    TcSmem& t = *reinterpret_cast<TcSmem*>(&s);
    const bool lane0 = (threadIdx.x & 31) == 0;
    forward_fixup_tc(
        coord, p, base, total, t.act, t.enc_pt, t.enc_dir, t.wt, 2 * FWD_STAGE, t.fx,
        res_a + (size_t)base * AB_STRIDE, min(TILE_M, total - base),
        [&](int r, float pre) {
          if (lane0 && base + r < total) {
            sigma_out[base + r] = fabsf(pre);
            res_sign[base + r] = pre > 0.f ? 1.f : (pre < 0.f ? -1.f : 0.f);
          }
        },
        [&](int r, const float(&x)[3]) {
          if (lane0 && base + r < total) {
            r_out[base + r] = 1.f / (1.f + expf(-x[0]));
            g_out[base + r] = 1.f / (1.f + expf(-x[1]));
            b_out[base + r] = 1.f / (1.f + expf(-x[2]));
          }
        });
  } else {
    field_tile<BF16>(s, p, coord, base, total, [&](int m, int ch, float v) {
      (ch == 0 ? r_out : ch == 1 ? g_out : ch == 2 ? b_out : sigma_out)[m] = v;
    });
  }
}

// Launches form <BF16, SAVE> over the call's rows on `stream`, the weights
// packed first for the bf16 forms.
template <bool BF16, bool SAVE>
int launch_fwd(const float* origins, const float* dirs, const float* ts, Params p,
               float* sigma, float* r, float* g, float* b, void* packed, bf16* res_a,
               float* res_sign, int n_rays, int n_samples, cudaStream_t st) {
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  if (total > 0x7fffffffLL - TILE_M) return (int)cudaErrorInvalidValue;
  if (BF16) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    bf16* wb = static_cast<bf16*>(packed);
    p.wb = wb;
    const int e = pack_weights(p, wb, st, SAVE);
    if (e != 0) return e;
  }
  auto kernel = &field_rays_fwd_kernel<BF16, SAVE>;
  cudaError_t err = launch_cache::allow_smem(kernel, sizeof(FwdSmem));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((total + TILE_M - 1) / TILE_M);
  kernel<<<blocks, THREADS, sizeof(FwdSmem), st>>>(origins, dirs, ts, p, sigma, r, g, b,
                                                   n_samples, (int)total, res_a, res_sign);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes.
int field_rays_fwd_smem_bytes() { return (int)sizeof(FwdSmem); }

// bf16 elements of the `packed` buffer the bf16 form takes.
int field_packed_weights_elems() { return PK_ELEMS; }

// bf16 elements of the saving form's `packed` buffer (with the fix-up's
// transposed copy and norms), and of a row of its A.
int field_residual_packed_elems() { return PK_SCRATCH; }
int field_residual_row_elems() { return AB_STRIDE; }

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// all float32, contiguous, on the current device. params: 25 device
// pointers: the 12 weights, the 12 biases (layer order in
// field_common.cuh), then the 14 frequencies. bf16: nonzero for the bf16
// form, which packs the weights into `packed` (field_packed_weights_elems()
// bf16, 16-byte aligned; null for fp32). Launches on `stream` and returns
// the first launch error, or 0.
int field_rays_fwd(const float* origins, const float* dirs, const float* ts,
                   const void* const* params, float* sigma, float* r, float* g,
                   float* b, void* packed, int n_rays, int n_samples, int bf16,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = unpack_params(params);
  return bf16 ? launch_fwd<true, false>(origins, dirs, ts, p, sigma, r, g, b, packed, nullptr,
                                        nullptr, n_rays, n_samples, st)
              : launch_fwd<false, false>(origins, dirs, ts, p, sigma, r, g, b, nullptr,
                                         nullptr, nullptr, n_rays, n_samples, st);
}

// The bf16 form's saving form: as field_rays_fwd with bf16, and also keeps
// the residuals that field_rays_bwd_res reads: packed
// (field_residual_packed_elems() bf16, 16-byte aligned), res_a (n_rays *
// n_samples rows of field_residual_row_elems() bf16, 16-byte aligned) and
// res_sign ((n_rays, n_samples) float32).
int field_rays_fwd_res(const float* origins, const float* dirs, const float* ts,
                       const void* const* params, float* sigma, float* r, float* g,
                       float* b, void* packed, void* res_a, float* res_sign, int n_rays,
                       int n_samples, void* stream) {
  if (res_a == nullptr || res_sign == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fwd<true, true>(origins, dirs, ts, unpack_params(params), sigma, r, g, b,
                                packed, static_cast<bf16*>(res_a), res_sign, n_rays,
                                n_samples, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
