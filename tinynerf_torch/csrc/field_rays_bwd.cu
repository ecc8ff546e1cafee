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
// runs inside the call: no (B*N, 3) array is returned. It runs
// in float32 or in the TPU kernel's bf16 form (field_common.cuh, the
// precision note): as there, the head gradients (sigma, color) stay float32
// and every other pre-activation gradient is rounded to bf16; the weight
// gradients and d_o, d_d, d_ts are float32.
//
// What bounds it: FLOPs. A row costs 3x the forward's 1,182,976
// FLOP (recompute, input gradients, weight gradients).
//
// Design. The TPU kernel keeps a 1024-row tile's eight trunk activations
// in VMEM and accumulates the weight gradients across its sequential grid.
// On Hopper a 64-row tile's activations alone (512 KB in float32) exceed a
// block's 227 KB of shared memory, and blocks run concurrently, so one call
// is a few launches, all on `stream`:
// 1. the weights, for the products' use: fp32, every weight matrix the
//    input-gradient products read is copied transposed, (fan-out, fan-in
//    zero-padded to a multiple of 32) row-major, into the workspace, so
//    that every product reads its weights as K rows of adjacent outputs;
//    bf16, all of them packed into bf16 once (field_tc.cuh's pack_weights),
//    which the input-gradient products read untransposed through ldmatrix;
// 2. recompute + input gradients, per 64-row tile: the forward of
//    field_rays_fwd.cu, saving each layer's input to a workspace A, then
//    the heads' gradients and the chain down the trunk, saving each layer's
//    pre-activation gradient to a workspace G; then the encoding's backward
//    and the per-ray sums.
//    - fp32 (fma_common.cuh's gemm_f32): float32 FMA on 8-row x
//      8-column register tiles, a thread's columns in groups of 4 adjacent
//      ones, so a weight K-tile row is read as 16-byte shared-memory loads
//      and the rows as broadcast 16-byte loads (16 FMAs a load, against
//      gemm_segment's 6.4); the weights' 16-row K-tiles double-buffered by
//      cp.async, the next in flight during the FMAs. A block takes 128-row
//      tiles with 512 threads (220 KB of shared memory, one block an SM),
//      so each K-tile brought from L2 serves twice the rows of a 64-row
//      tile: the weights' L2 traffic, 4.6 MB a tile, is what the FMAs wait
//      on. The grid is persistent, one block an SM, each an even share of
//      the chunk's rows, and the warps past a tile's last row skip their
//      FMAs, so no wave is left nearly empty (the lego step's 25,600 and
//      51,200 rows make 1.5 waves of whole-ray 64-row blocks). A ray may
//      span two blocks: each row leaves its d_pts and d_dir in G and
//      ray_sums_kernel adds them per ray, in sample order;
//    - bf16: a block owns whole rays (max(1, 64 / N) of them, in 64-row
//      sub-tiles), so the per-ray sums need no second pass; its products
//      run on the tensor cores (mma.sync, f32 accumulation) and A and G are
//      kept in bf16, the heads' gradients and trunk_4's share of the
//      encoding's gradient in a float32 side area, which halves their
//      traffic;
// 3. weight gradients: dW = A^T G and db = sum G for all 12 layers as one
//    launch of output tiles over fixed row slices, each slice's partial sums
//    written to its own buffer. fp32: 128 x 128 tiles of float32 FMA, 8 x 8
//    outputs a thread (two 16-byte reads each of A and G a row for 64
//    FMAs), A and G in 32-row K-slabs double-buffered by cp.async, so each
//    256-wide layer's A and G columns are read twice; the heads (sigma,
//    color) in a block of their own; slices of at most SPLIT_ROWS rows,
//    their count chosen so that the last wave of an H100's resident blocks
//    (WG_SLOTS, a constant) is full (wgrad_split_rows). bf16: 128 x 128 tiles on the tensor
//    cores, the heads on float32 FMA, WB_SPLIT-row slices;
// 4. reduce: the slices' partials summed in a fixed order.
// No atomics: a call is deterministic (its slices depend on the shapes
// only). Rows are processed in chunks of
// at most CHUNK_ROWS (whole rays), the weight gradients accumulating across
// chunks in order, which caps the workspace at about 1.4 GB.
//
// The device code and the launch sequence are in field_bwd_common.cuh,
// which the fused renderer's backward (render_fused_bwd.cu) shares.

#include "field_bwd_common.cuh"

extern "C" {

// Bytes of dynamic shared memory one block of the recompute kernel takes.
int field_rays_bwd_smem_bytes() { return (int)sizeof(Smem); }

// Float32 elements of workspace field_rays_bwd needs for these shapes.
long long field_rays_bwd_workspace_floats(int n_rays, int n_samples) {
  return field_bwd_workspace_floats(n_rays, n_samples);
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
  return field_bwd_run(origins, dirs, ts, g_sigma, g_r, g_g, g_b,
                       unpack_params(params), d_o, d_d, d_ts, grads, workspace,
                       n_rays, n_samples, bf16 != 0, false,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
