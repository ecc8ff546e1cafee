// The fused renderer's forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/render_kernel.py::_fused_render_forward /
// _fwd_kernel (TPU kernel 9), the whole coarse -> fine renderer of a ray
// batch in one kernel: given origins, dirs (B, 3), the coarse t's (B, N_c)
// and near, far (B,), it evaluates the 8x256 field at the coarse samples,
// composites them with the inclusive-cumsum weights (delta (far - near) /
// N_c), resamples N_f fine t's by inverse CDF (slope (far - near) / (N_c -
// 1) / (w + 1e-7)), evaluates the field there and composites the merged set
// of both lists, writing C_coarse and C_fine (B, 3), float32. White
// background adds (1 - sum w) to both. It runs in float32 or in the TPU
// kernel's bf16 form (field_common.cuh, the precision note).
//
// What bounds it: FLOPs. A ray costs (N_c + N_f) x 1,182,976 FLOP in the
// field and reads 10 floats and writes 6, as on the TPU: everything between
// the two field passes (the per-sample sigma and color, weights, cdf, fine
// t's) stays in shared memory (render_common.cuh).
//
// Design (a simple first kernel; a parallel tail is later work).
// The TPU kernel's triangular-matmul cumsums, one-hot gathers, (T, N_c,
// N_f) compare masks and sentinels are lane workarounds and are not
// carried over: the lists are sorted, so the merge is a two-pointer walk.
// - a block of 256 threads owns max(1, 64 / N_c) whole rays (one ray at
//   N_c = 64): the coarse rows as 64-row tiles through the field kernels'
//   tile (field_tc.cuh's field_tile: float32 FMA, or the tensor cores at
//   bf16), then one thread a ray for the weights and the coarse color,
//   one thread a fine sample for the resample (a count over the N_c cdf
//   values), the fine rows as tiles, and one thread a ray for the merge;
// - the block's shared memory is the field's 103 KB tile plus 4.4 KB of
//   per-ray state at 64 + 128 samples, so two blocks share an SM and one
//   block's serial tail overlaps the other's products.

#include "render_common.cuh"

namespace {

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
render_fused_fwd_kernel(const float* __restrict__ origins,
                        const float* __restrict__ dirs,
                        const float* __restrict__ t_co,
                        const float* __restrict__ near,
                        const float* __restrict__ far, Params p,
                        float* __restrict__ c_co, float* __restrict__ c_fi,
                        float* __restrict__ t_fi, int n_rays, int nc, int nf, int rpb,
                        int white) {
  extern __shared__ float4 smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const Tail tl = carve_tail(reinterpret_cast<float*>(&s + 1), rpb, nc, nf, false);
  const int ray0 = blockIdx.x * rpb;
  const int nr = min(rpb, n_rays - ray0);
  render_front<BF16>(s, tl, p, origins, dirs, t_co, near, far, ray0, nr, nc, nf,
                     white != 0, c_co);
  if (t_fi != nullptr)
    for (int i = threadIdx.x; i < nr * nf; i += THREADS)
      t_fi[(size_t)ray0 * nf + i] = tl.t_fi[i];
  for (int r = threadIdx.x; r < nr; r += THREADS) {
    float c[3];
    merge_fwd(tl, r, nc, nf, white != 0, c, false);
    for (int ch = 0; ch < 3; ++ch) c_fi[3 * (ray0 + r) + ch] = c[ch];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at these sample counts.
int render_fused_fwd_smem_bytes(int n_coarse, int n_fine) {
  return (int)render_smem_bytes(rays_per_block(n_coarse, n_fine, false), n_coarse,
                                n_fine, false);
}

// bf16 elements of the `packed` buffer the bf16 form takes.
int field_packed_weights_elems() { return PK_ELEMS; }

// origins, dirs, c_co, c_fi: (n_rays, 3); t_co: (n_rays, n_coarse), sorted
// per ray; near, far: (n_rays,); t_fi: null, or (n_rays, n_fine) for the
// fine t's (for checks); all float32, contiguous, on the current device.
// params: 25 device pointers, as for field_rays_fwd. white: nonzero for the
// white-background term; bf16: nonzero for the bf16 form, which packs the
// weights into `packed` (field_packed_weights_elems() bf16, 16-byte
// aligned; null for fp32). Launches on `stream` and returns the first
// launch error, or cudaErrorInvalidValue for sample counts whose state does
// not fit in a block.
int render_fused_fwd(const float* origins, const float* dirs, const float* t_co,
                     const float* near, const float* far, const void* const* params,
                     float* c_co, float* c_fi, float* t_fi, void* packed, int n_rays,
                     int n_coarse, int n_fine, int white, int bf16, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_coarse < 2 || n_fine < 1) return (int)cudaErrorInvalidValue;
  const int rpb = rays_per_block(n_coarse, n_fine, false);
  const size_t smem = render_smem_bytes(rpb, n_coarse, n_fine, false);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p = unpack_params(params);
  if (bf16) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(packed);
    p.wb = wb;
    const int e = pack_weights(p, wb, st, false);
    if (e != 0) return e;
  }
  auto kernel = bf16 ? &render_fused_fwd_kernel<true> : &render_fused_fwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n_rays + rpb - 1) / rpb, THREADS, smem, st>>>(
      origins, dirs, t_co, near, far, p, c_co, c_fi, t_fi, n_rays, n_coarse, n_fine, rpb,
      white);
  return (int)cudaGetLastError();
}

}  // extern "C"
