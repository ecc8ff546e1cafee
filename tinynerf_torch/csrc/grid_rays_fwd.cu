// Ray-major CP grid field forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/grid_kernel.py::_fused_ray_forward / _fwd_kernel
// (+ _forward_tile), the TPU kernel behind grid_field_pallas_rays
// (GRID_PALLAS). For each sample row of a ray batch it computes the point
// o + t*d, the three line lerps, the CP product, sigma and the small color
// decoder (grid_common.cuh), and writes four dense (B, N) float32 planes:
// sigma, r, g, b. The direction encoding is per ray and comes in as a
// (B, 24) input, as on the TPU. It runs in float32 or in the TPU kernel's
// bf16 form (grid_common.cuh, the precision note).
//
// What bounds it: the card's least time for this work is its FLOPs (the
// decoder's products, 2 * (24 + Fa) * W + 6 * W per row, plus the lerps) at
// the float32 FMA rate; in the bf16 form the decoder runs on the tensor
// cores and the lerps, the CP products and the sigma sum bound it at the
// FMA rate, with the bytes (t in; four planes out) close behind. What holds
// the kernel is L2 and shared-memory traffic: per row the lerps read six
// table rows of F values from L2 (bf16 tables in the bf16 form: 1.5 KB a
// row at the fine geometry, 0.8 GB per fine forward at B = 4096, N = 128).
//
// Design:
// - the bf16 form packs the tables to bf16 first (one launch, pack_tables);
// - each block stages W1 and W2 (rounded with BF16) in shared memory once,
//   then walks the flat B*N rows in tiles (grid-stride, 64 rows in the bf16
//   form, 32 in fp32), masking the ragged end instead of padding; the
//   blocks fill the card (as many a multiprocessor as its shared memory and
//   registers allow);
// - per tile (grid_common.cuh): the taps, then one warp a row reads the six
//   table rows and writes the products and sigma_pre; the hidden layer (bf16:
//   mma.sync units of 16 x 16 outputs, one warp each; fp32: FMAs); one warp
//   a row for the color head.

#include "grid_common.cuh"
#include "launch_cache.cuh"

namespace {

template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
grid_rays_fwd_kernel(Rays rays, GridParams p, Dims dm, float* __restrict__ sigma_out,
                     float* __restrict__ r_out, float* __restrict__ g_out,
                     float* __restrict__ b_out, long long total) {
  constexpr int TILE = Form<BF16>::TILE;
  extern __shared__ float4 smem_raw[];
  Carver c(smem_raw);
  const TileBufs<BF16> L(dm, c, false);
  stage_decoder<BF16>(p, dm, L);
  const Tables<BF16> tabs(p, dm);
  const float ext = __ldg(p.ext);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * TILE; base < total;
       base += (long long)gridDim.x * TILE) {
    load_tile<BF16, false>(rays, tabs, dm, ext, base, total, L, nullptr);
    for (int r = threadIdx.x; r < TILE; r += nthreads())
      if (base + r < total) sigma_out[base + r] = fabsf(L.sig[r]);
    hidden_layer<BF16>(p, dm, L);
    for (int r = warp; r < TILE; r += nwarps()) {
      float col[3];
      row_color<BF16>(p, dm, L, r, col);
      if (lane == 0 && base + r < total) {
        r_out[base + r] = col[0];
        g_out[base + r] = col[1];
        b_out[base + r] = col[2];
      }
    }
    __syncthreads();  // the next tile overwrites hin, hp and the taps
  }
}

template <bool BF16>
size_t fwd_smem(const Dims& dm) {
  Carver c(nullptr);
  TileBufs<BF16> t(dm, c, false);
  return c.q;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at these dimensions.
int grid_rays_fwd_smem_bytes(int res, int nd, int na, int width, int use_bf16) {
  const Dims dm{res, nd, na, width};
  return (int)(use_bf16 ? fwd_smem<true>(dm) : fwd_smem<false>(dm));
}

// Float32 elements of workspace grid_rays_fwd needs: the bf16 form's packed
// tables.
long long grid_rays_fwd_workspace_floats(int res, int nd, int na, int use_bf16) {
  return use_bf16 ? packed_table_elems(Dims{res, nd, na, 16}) / 2 : 0;
}

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// de: (n_rays, 24); all float32, contiguous, on the current device. params:
// 8 device pointers: the x, y, z line tables (res, nd + na), W1 (24 + na,
// width), b1 (width), W2 (width, 3), b2 (3), extent (one float). width must
// divide 256, nd + na be at most 256. use_bf16: nonzero for the bf16 form.
// workspace: grid_rays_fwd_workspace_floats(...) floats, 16-byte aligned.
// Launches on `stream` and returns the first launch error, or 0.
int grid_rays_fwd(const float* origins, const float* dirs, const float* ts,
                  const float* de, const void* const* params, float* sigma, float* r,
                  float* g, float* b, float* workspace, int n_rays, int n_samples, int res,
                  int nd, int na, int width, int use_bf16, void* stream) {
  const Dims dm{res, nd, na, width};
  if (int bad = check_dims(dm)) return bad;
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = use_bf16 ? fwd_smem<true>(dm) : fwd_smem<false>(dm);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = use_bf16 ? &grid_rays_fwd_kernel<true> : &grid_rays_fwd_kernel<false>;
  // the shared-memory limit, the card's SMs and the blocks an SM holds:
  // queried once a device and shape (launch_cache.cuh)
  int sms = 0, per_sm = 0;
  cudaError_t err = launch_cache::blocks_per_sm(kernel, threads_for(dm), smem, &per_sm);
  if (err == cudaSuccess) err = launch_cache::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  auto* tab16 = reinterpret_cast<__nv_bfloat16*>(workspace);
  if (use_bf16) {
    if (int e = pack_tables(params, dm, tab16, st)) return e;
  }
  const GridParams p = unpack_grid_params(params, tab16);
  const int tile = use_bf16 ? Form<true>::TILE : Form<false>::TILE;
  const int blocks = (int)std::min<long long>(ceil_div(total, tile),
                                              (long long)sms * std::max(per_sm, 1));
  kernel<<<blocks, threads_for(dm), smem, st>>>(Rays{origins, dirs, ts, de, n_samples}, p, dm, sigma,
                                        r, g, b, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
