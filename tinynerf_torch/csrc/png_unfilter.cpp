// png_unfilter: PNG's per-row filters reversed (ISO/IEC 15948, section 9),
// the one sequential step of tinynerf_torch's PNG reader
// (tinynerf_torch/data/imagefile.py::read_png). zlib inflates the image data
// in Python; this routine turns the inflated rows into pixels.
//
// Sub, Average and Paeth predict a byte from the byte bpp places to its left
// in the same row, already reconstructed, so a row is one pass from left to
// right; Up and the first row need no left neighbour but take the same pass.
//
// A plain C ABI, loaded from Python with ctypes (tinynerf_torch/data/native.py)
// and built there with g++ at first use. No Python.h dependency. This file is
// host code: it is not a CUDA source and kernels/build.py does not build it.

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);
  const int pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

// rows: height rows of 1 + stride bytes, each a filter type byte and the
// filtered bytes; out: height x stride reconstructed bytes; bpp: bytes a
// pixel (1 to 4 at 8 bits a sample). Returns -1, or the first row whose
// filter type is not 0-4 (out is then whole up to that row).
extern "C" int64_t png_unfilter(const uint8_t* rows, int64_t height, int64_t stride,
                                int64_t bpp, uint8_t* out) {
  const std::vector<uint8_t> zero_row(static_cast<size_t>(stride), 0);
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* in = rows + r * (stride + 1);
    const uint8_t kind = *in++;
    uint8_t* x = out + r * stride;
    const uint8_t* up = r > 0 ? x - stride : zero_row.data();
    switch (kind) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) x[i] = in[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          x[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? x[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) x[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          x[i] = static_cast<uint8_t>(in[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int c = i >= bpp ? up[i - bpp] : 0;
          x[i] = static_cast<uint8_t>(in[i] + paeth(a, up[i], c));
        }
        break;
      default:
        return r;
    }
  }
  return -1;
}
