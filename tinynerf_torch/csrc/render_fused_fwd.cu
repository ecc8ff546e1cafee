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
// t's) stays in shared memory (render_common.cuh). On this card the field's
// products run on mma.sync at a fraction of the tensor cores' rate; how
// much of their time goes to waiting on the weights' L2 reads rather than
// on instruction issue (fragment loads, address arithmetic, barriers) a
// probe build reads (-DFIELD_TC_WEIGHT_PROBE, field_tc.cuh; PERF.md).
// Before this design two more things stood in the way:
// - the tail (the weights, resample and merge) ran on one thread a ray
//   while the block's other threads waited at a barrier: 17% of the bf16
//   form's block cycles (its clock64 split, PERF.md);
// - at bf16, each 64-row tile streamed all 1.19 MB of packed weights from
//   L2 (14.6 GB a call at B = 4096, 64 + 128 samples, from the shapes): 64
//   FLOP per weight byte.
//
// Design. The TPU kernel's triangular-matmul cumsums, one-hot gathers,
// (T, N_c, N_f) compare masks and sentinels are lane workarounds and are
// not carried over.
// - bf16: a block of 512 threads owns max(1, 128 / N_c) whole rays (2 at
//   64 + 128 samples, 16 at 8 + 16), their coarse rows then their fine rows
//   in 128-row tensor-core tiles (field_tc.cuh at M = 128: 16 warps, 4 x 4
//   over a product's output), so each weight K-tile comes from L2 once per
//   128 rows (7.3 GB a call, from the shapes); one block an SM (132 KB of
//   tile). Alone on its SM, the tile takes one barrier a K-tile and
//   accumulates each output's whole K in the tensor core (KSum::WHOLE_K:
//   no float32 add between k16 steps), which the forward may, as no
//   fix-up re-sums its outputs.
// - fp32: a block of 256 threads owns max(1, 64 / N_c) rays in 64-row
//   float32 FMA tiles (field_common.cuh's network_fwd, gemm_segment), two
//   blocks an SM, as before.
// - the tail, both forms (render_common.cuh): a warp a ray for the coarse
//   weights, their cdf and the coarse color (warp_scan: lane-local runs,
//   then a shuffle scan, an order fixed by N_c), a thread a fine sample for
//   the resample (a binary search over the ray's cdf in shared memory), a
//   thread a sample for the merge's ranks (binary searches over the other
//   list; coarse first at an equal t), and a warp a ray for the merged
//   composite (a warp_scan over the N_c + N_f merged samples). No step of
//   it runs on one thread of a block.
// The tail's sums run in an order fixed by the shapes. Where a backward
// can follow, the kernel's RES form also writes its per-ray state (the
// residuals, Res: the fine t's and both passes' sigma and color) from
// shared memory, and the backward (render_fused_bwd.cu) starts from them:
// its merge order, weights and C_fine are these bits. Frames pass none and
// launch the form without that code.
// A clock64 variant build (-DRENDER_PHASE_CLOCKS) reads the time of each
// phase and the share of the block's warps that wait through the tail
// (render_kernel.fwd_phase_split).

#include "render_common.cuh"

namespace {

// RES: write the residuals to `res` (the wrapper's choice: where a backward
// can follow); frames launch the form without them, which holds no code for
// it.
template <bool BF16, bool RES>
__global__ void __launch_bounds__(Geo<BF16>::THREADS, Geo<BF16>::BLOCKS)
render_fused_fwd_kernel(const float* __restrict__ origins,
                        const float* __restrict__ dirs,
                        const float* __restrict__ t_co,
                        const float* __restrict__ near,
                        const float* __restrict__ far, Params p,
                        float* __restrict__ c_co, float* __restrict__ c_fi,
                        float* __restrict__ res, int n_rays, int nc, int nf, int rpb,
                        int white) {
  using G = Geo<BF16>;
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<typename G::Smem*>(smem_raw);
  const Tail tl = carve_tail(reinterpret_cast<float*>(&s + 1), rpb, nc, nf);
  const int ray0 = blockIdx.x * rpb;
  const int nr = min(rpb, n_rays - ray0);
  PhaseClock clk;
  render_front<BF16>(s, tl, p, origins, dirs, t_co, near, far, ray0, nr, nc, nf, white != 0,
                     c_co, clk);
  if (RES) {
    const Res out = carve_res(res, n_rays, nc, nf);
    const size_t cp = (size_t)n_rays * nc, fp = (size_t)n_rays * nf;
    for (int i = threadIdx.x; i < nr * nf; i += G::THREADS) {
      const size_t at = (size_t)ray0 * nf + i;
      out.t_fi[at] = tl.t_fi[i];
      out.sig_fi[at] = tl.sig_fi[i];
      for (int ch = 0; ch < 3; ++ch) out.col_fi[ch * fp + at] = tl.col_fi[ch][i];
    }
    for (int i = threadIdx.x; i < nr * nc; i += G::THREADS) {
      const size_t at = (size_t)ray0 * nc + i;
      out.sig_co[at] = tl.sig_co[i];
      for (int ch = 0; ch < 3; ++ch) out.col_co[ch * cp + at] = tl.col_co[ch][i];
    }
  }
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += G::THREADS / 32) {
    float c[3];
    merge_fwd(tl, r, nc, nf, white != 0, c, false);
    for (int ch = 0; ch < 3; ++ch)
      if (lane == ch) c_fi[3 * (ray0 + r) + ch] = c[ch];
  }
  clk.mark(PH_MERGE);
}

}  // namespace

extern "C" {

// Rays a block of the given form takes at these sample counts, or 0 where
// one ray's state does not fit in a block's shared memory (the wrapper
// refuses those shapes by name).
int render_fused_fwd_rays_per_block(int n_coarse, int n_fine, int bf16) {
  if (n_coarse < 2 || n_fine < 1) return 0;
  return rays_per_block(bf16 != 0, n_coarse, n_fine);
}

// Threads of a block of the given form, and rows of its field tile.
int render_fused_block_threads(int bf16) {
  return bf16 ? Geo<true>::THREADS : Geo<false>::THREADS;
}
int render_fused_tile_rows(int bf16) { return bf16 ? Geo<true>::M : Geo<false>::M; }

// Bytes of dynamic shared memory one block of the given form takes.
int render_fused_fwd_smem_bytes(int n_coarse, int n_fine, int bf16) {
  const int rpb = render_fused_fwd_rays_per_block(n_coarse, n_fine, bf16);
  return rpb == 0 ? 0 : (int)render_smem_bytes(bf16 != 0, rpb, n_coarse, n_fine);
}

// bf16 elements of the `packed` buffer the bf16 form takes.
int field_packed_weights_elems() { return PK_ELEMS; }

// Float32 elements of the residual buffer (Res) for these shapes.
long long render_fused_residual_floats(int n_rays, int n_coarse, int n_fine) {
  return residual_floats(n_rays, n_coarse, n_fine);
}

// origins, dirs, c_co, c_fi: (n_rays, 3); t_co: (n_rays, n_coarse); near,
// far: (n_rays,); res: null, or render_fused_residual_floats(n_rays,
// n_coarse, n_fine) floats for the residuals (Res, render_common.cuh) that
// the backward starts from; all float32, contiguous, on the current
// device. params: 25
// device pointers, as for field_rays_fwd. white: nonzero for the
// white-background term; bf16: nonzero for the bf16 form, which packs the
// weights into `packed` (field_packed_weights_elems() bf16, 16-byte
// aligned; null for fp32). Launches on `stream` and returns the first
// launch error, or cudaErrorInvalidValue for sample counts whose state does
// not fit in a block.
int render_fused_fwd(const float* origins, const float* dirs, const float* t_co,
                     const float* near, const float* far, const void* const* params,
                     float* c_co, float* c_fi, float* res, void* packed, int n_rays,
                     int n_coarse, int n_fine, int white, int bf16, void* stream) {
  if (n_rays <= 0) return 0;
  const int rpb = render_fused_fwd_rays_per_block(n_coarse, n_fine, bf16);
  if (rpb == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = render_smem_bytes(bf16 != 0, rpb, n_coarse, n_fine);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p = unpack_params(params);
  if (bf16) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(packed);
    p.wb = wb;
    const int e = pack_weights(p, wb, st, false);
    if (e != 0) return e;
  }
  auto kernel = bf16 ? (res != nullptr ? &render_fused_fwd_kernel<true, true>
                                        : &render_fused_fwd_kernel<true, false>)
                     : (res != nullptr ? &render_fused_fwd_kernel<false, true>
                                        : &render_fused_fwd_kernel<false, false>);
  const int threads = render_fused_block_threads(bf16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n_rays + rpb - 1) / rpb, threads, smem, st>>>(
      origins, dirs, t_co, near, far, p, c_co, c_fi, res, n_rays, n_coarse, n_fine, rpb,
      white);
  return (int)cudaGetLastError();
}

#ifdef RENDER_PHASE_CLOCKS
// Blocks the phase clocks count: the first MAX_PHASE_BLOCKS of a launch.
int render_fused_fwd_phase_blocks() { return MAX_PHASE_BLOCKS; }

// Copy the phase clocks and the warps' busy cycles (MAX_PHASE_BLOCKS x
// N_PHASES int64 each) to host memory, then zero them on the device.
int render_fused_fwd_phase_clocks(long long* clocks, long long* busy) {
  const size_t bytes = sizeof(long long) * MAX_PHASE_BLOCKS * N_PHASES;
  static long long zeros[MAX_PHASE_BLOCKS * N_PHASES];
  cudaError_t err = cudaMemcpyFromSymbol(clocks, phase_clocks, bytes);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(busy, phase_busy, bytes);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_clocks, zeros, bytes);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_busy, zeros, bytes);
  return (int)err;
}
#endif

}  // extern "C"
