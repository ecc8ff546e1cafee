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
// the float32 FMA rate, and at bf16 the bytes (t in; four planes out) are
// close behind. What this kernel is held by is shared-memory and L2 traffic:
// per row the lerps read six table rows of F floats from L2 (3 KB a row at
// the fine geometry, 1.6 GB per fine forward at B = 4096, N = 128), and the
// hidden layer reads its operands from shared memory, 1.25 loads per FMA.
//
// Design (a simple first kernel):
// - each block stages W1 (rounded with BF16, rows padded to W + 1) and W2
//   in shared memory once, then walks the flat B*N rows in 32-row tiles
//   (grid-stride), masking the ragged end instead of padding;
// - per tile: 96 threads make the taps; every thread then takes (row,
//   feature) elements, reading the two table rows per axis from L2 (float32
//   tables: 393 KB at the fine geometry, 24 KB for the proposal), and writes
//   the product next to the row's encoding; one warp per row sums sigma and,
//   after the hidden layer (each thread 4 rows x 1 column), the color head.
// - Staging the tables themselves in shared memory (bf16: 196 KB for the
//   three fine axes, under the 227 KB limit) would take the gathers off L2:
//   later work, with bf16 tensor-core products for the decoder.

#include <algorithm>

#include "grid_common.cuh"

namespace {

constexpr int MAX_BLOCKS = 1024;

// Shared memory of one block, carved from one float buffer (`base` null:
// offsets only, for the size).
struct FwdLayout {
  float *w1s, *w2s, *x, *hp;
  TileTaps tp;
  size_t bytes;
  __host__ __device__ FwdLayout(const Dims& dm, float* base) {
    const int W = dm.width;
    size_t q = 0;
    w1s = carve(base, q, (size_t)dm.K() * (W + 1));
    w2s = carve(base, q, (size_t)W * 3);
    x = carve(base, q, (size_t)TILE * dm.XS());
    hp = carve(base, q, (size_t)TILE * W);
    tp.w0 = carve(base, q, TILE * 3);
    tp.w1 = carve(base, q, TILE * 3);
    tp.i0 = reinterpret_cast<int*>(carve(base, q, TILE * 3));
    tp.i1 = reinterpret_cast<int*>(carve(base, q, TILE * 3));
    tp.m0 = tp.m1 = tp.clip_grad = nullptr;
    bytes = q * sizeof(float);
  }
};

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
grid_rays_fwd_kernel(Rays rays, GridParams p, Dims dm, float* __restrict__ sigma_out,
                     float* __restrict__ r_out, float* __restrict__ g_out,
                     float* __restrict__ b_out, long long total) {
  extern __shared__ float4 smem_raw[];
  FwdLayout L(dm, reinterpret_cast<float*>(smem_raw));
  stage_decoder<BF16>(p, dm, L.w1s, L.w2s);
  const float ext = __ldg(p.ext);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * TILE; base < total;
       base += (long long)gridDim.x * TILE) {
    load_tile<BF16, false>(rays, p, dm, ext, base, total, L.x, L.tp, nullptr);
    for (int r = warp; r < TILE; r += THREADS / 32) {
      const float s = row_sigma_pre(dm, L.x, r);
      if (lane == 0 && base + r < total) sigma_out[base + r] = fabsf(s);
    }
    hidden_layer(p, dm, L.x, L.w1s, L.hp);
    for (int r = warp; r < TILE; r += THREADS / 32) {
      float col[3];
      row_color<BF16>(p, dm, L.hp, L.w2s, r, col);
      if (lane == 0 && base + r < total) {
        r_out[base + r] = col[0];
        g_out[base + r] = col[1];
        b_out[base + r] = col[2];
      }
    }
    __syncthreads();  // the next tile overwrites x, hp and the taps
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at these dimensions.
int grid_rays_fwd_smem_bytes(int res, int nd, int na, int width) {
  return (int)FwdLayout(Dims{res, nd, na, width}, nullptr).bytes;
}

// origins, dirs: (n_rays, 3); ts and the four outputs: (n_rays, n_samples);
// de: (n_rays, 24); all float32, contiguous, on the current device. params:
// 8 device pointers: the x, y, z line tables (res, nd + na), W1 (24 + na,
// width), b1 (width), W2 (width, 3), b2 (3), extent (one float). width must
// divide 256. bf16: nonzero for the bf16 form. Launches on `stream` and
// returns the launch error, or 0.
int grid_rays_fwd(const float* origins, const float* dirs, const float* ts,
                  const float* de, const void* const* params, float* sigma, float* r,
                  float* g, float* b, int n_rays, int n_samples, int res, int nd,
                  int na, int width, int bf16, void* stream) {
  const Dims dm{res, nd, na, width};
  if (int bad = check_dims(dm)) return bad;
  const long long total = (long long)n_rays * n_samples;
  if (total <= 0) return 0;
  const GridParams p = unpack_grid_params(params);
  const size_t smem = FwdLayout(dm, nullptr).bytes;
  auto kernel = bf16 ? &grid_rays_fwd_kernel<true> : &grid_rays_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)std::min<long long>(ceil_div(total, TILE), MAX_BLOCKS);
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      Rays{origins, dirs, ts, de, n_samples}, p, dm, sigma, r, g, b, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
