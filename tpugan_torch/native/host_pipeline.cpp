// tpugan native host pipeline — C++ core for the input-side runtime.
//
// The reference delegates its host-side data work to PyTorch's native
// DataLoader workers and PIL's C resampling (pix2pix/pix2pix.py:89-94,
// datasets.py transforms). tpugan's equivalent is this small library: batch
// assembly (index gather), PIL-convention bicubic resampling, and a fused
// resize->crop->flip augmentation executor, all operating on uint8 HWC
// buffers (batches ship to the TPU as uint8; normalization is on-device).
//
// Randomness policy: the Python side draws crop offsets / flip flags from
// its seeded numpy Generator and passes them in, so augmentation RNG
// semantics live in exactly one place (tpugan/data/im2im.py) and this
// library stays deterministic given its arguments.
//
// Resampling convention: separable convolution with the Keys bicubic kernel
// (a = -0.5, support 2.0), scale-widened support when minifying, and PIL's
// exact 8-bit fixed-point arithmetic (22-bit weights, int32 accumulators,
// clip8 between passes) — BIT-EXACT with PIL.Image.resize(..., BICUBIC),
// asserted in tests/test_native_pipeline.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Batch assembly: dst[i] = src[idx[i]] for row-major fixed-size records.
// ---------------------------------------------------------------------------
void tg_gather_u8(const uint8_t* src, const int64_t* idx, uint8_t* dst,
                  int64_t n_idx, int64_t row_bytes) {
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

// ---------------------------------------------------------------------------
// Bicubic resampling (PIL convention).
// ---------------------------------------------------------------------------
namespace {

inline double bicubic_filter(double x) {
  // Keys kernel, a = -0.5 (PIL's BICUBIC).
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Fixed-point scheme matching PIL's 8-bit resampling exactly
// (libImaging/Resample.c): weights quantized to 1<<PRECISION_BITS, int32
// accumulators seeded with the rounding constant, clip8 on the way out.
constexpr int kPrecisionBits = 32 - 8 - 2;

struct ResampleCoeffs {
  std::vector<int> bounds_min;   // per output index: first source index
  std::vector<int> bounds_size;  // per output index: number of taps
  std::vector<int32_t> weights;  // ksize quantized taps per output index
  int ksize;
};

// Precompute the 1-D tap table the way PIL's precompute_coeffs does:
// center = (i + 0.5) * scale; support widened by the scale when minifying;
// weights normalized to sum 1, then quantized to kPrecisionBits.
ResampleCoeffs precompute(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2.0
  rc.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  rc.bounds_min.resize(out_size);
  rc.bounds_size.resize(out_size);
  rc.weights.assign(static_cast<size_t>(out_size) * rc.ksize, 0);
  std::vector<double> wbuf(rc.ksize);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double total = 0.0;
    for (int x = 0; x < n; ++x) {
      wbuf[x] = bicubic_filter((x + xmin - center + 0.5) / filterscale);
      total += wbuf[x];
    }
    int32_t* w = &rc.weights[static_cast<size_t>(i) * rc.ksize];
    for (int x = 0; x < n; ++x) {
      const double v = (total != 0.0 ? wbuf[x] / total : wbuf[x]) *
                       (1 << kPrecisionBits);
      w[x] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
    }
    rc.bounds_min[i] = xmin;
    rc.bounds_size[i] = n;
  }
  return rc;
}

inline uint8_t clip8(int32_t ss) {
  ss >>= kPrecisionBits;
  if (ss <= 0) return 0;
  if (ss >= 255) return 255;
  return static_cast<uint8_t>(ss);
}

// Horizontal pass then vertical pass, PIL order; bit-exact with PIL's
// ImagingResample 8-bit path (the intermediate rows are clipped back to
// uint8 between passes, exactly as ImagingResampleHorizontal_8bpc does).
void resize_bicubic_one(const uint8_t* src, int h, int w, int c,
                        uint8_t* dst, int oh, int ow,
                        const ResampleCoeffs& rh, const ResampleCoeffs& rv,
                        std::vector<uint8_t>& tmp) {
  constexpr int32_t kRound = 1 << (kPrecisionBits - 1);
  tmp.resize(static_cast<size_t>(h) * ow * c);
  for (int y = 0; y < h; ++y) {
    const uint8_t* __restrict srow = src + static_cast<size_t>(y) * w * c;
    uint8_t* __restrict trow = &tmp[static_cast<size_t>(y) * ow * c];
    for (int x = 0; x < ow; ++x) {
      const int xmin = rh.bounds_min[x];
      const int n = rh.bounds_size[x];
      const int32_t* __restrict wt =
          &rh.weights[static_cast<size_t>(x) * rh.ksize];
      for (int ch = 0; ch < c; ++ch) {
        int32_t acc = kRound;
        for (int t = 0; t < n; ++t)
          acc += srow[(static_cast<size_t>(xmin) + t) * c + ch] * wt[t];
        trow[static_cast<size_t>(x) * c + ch] = clip8(acc);
      }
    }
  }
  for (int y = 0; y < oh; ++y) {
    const int ymin = rv.bounds_min[y];
    const int n = rv.bounds_size[y];
    const int32_t* __restrict wt =
        &rv.weights[static_cast<size_t>(y) * rv.ksize];
    uint8_t* __restrict drow = dst + static_cast<size_t>(y) * ow * c;
    const size_t row = static_cast<size_t>(ow) * c;
    const uint8_t* __restrict base =
        tmp.data() + static_cast<size_t>(ymin) * row;
    for (size_t xc = 0; xc < row; ++xc) {
      int32_t acc = kRound;
      for (int t = 0; t < n; ++t)
        acc += base[static_cast<size_t>(t) * row + xc] * wt[t];
      drow[xc] = clip8(acc);
    }
  }
}

}  // namespace

// Batched bicubic resize: src [n, h, w, c] u8 -> dst [n, oh, ow, c] u8.
void tg_resize_bicubic_u8(const uint8_t* src, int64_t n, int h, int w, int c,
                          uint8_t* dst, int oh, int ow) {
  const ResampleCoeffs rh = precompute(w, ow);
  const ResampleCoeffs rv = precompute(h, oh);
  std::vector<uint8_t> tmp;
  const size_t in_stride = static_cast<size_t>(h) * w * c;
  const size_t out_stride = static_cast<size_t>(oh) * ow * c;
  for (int64_t i = 0; i < n; ++i) {
    resize_bicubic_one(src + i * in_stride, h, w, c, dst + i * out_stride,
                       oh, ow, rh, rv, tmp);
  }
}

// ---------------------------------------------------------------------------
// Fused augmentation: per image, bicubic-resize [h,w] -> [rh,rw], crop a
// [ch_, cw] window at (oy[i], ox[i]), horizontally flip when flip[i] != 0.
// This is the cyclegan train transform (resize 1.12x -> random crop ->
// random flip, cyclegan/cyclegan.py:111-117) executed natively; offsets and
// flip flags are drawn by the caller's seeded RNG.
// ---------------------------------------------------------------------------
void tg_augment_batch_u8(const uint8_t* src, int64_t n, int h, int w, int c,
                         int rh_, int rw, int ch_, int cw,
                         const int32_t* oy, const int32_t* ox,
                         const uint8_t* flip, uint8_t* dst) {
  const ResampleCoeffs rch = precompute(w, rw);
  const ResampleCoeffs rcv = precompute(h, rh_);
  std::vector<uint8_t> tmp;
  std::vector<uint8_t> resized(static_cast<size_t>(rh_) * rw * c);
  const size_t in_stride = static_cast<size_t>(h) * w * c;
  const size_t out_stride = static_cast<size_t>(ch_) * cw * c;
  for (int64_t i = 0; i < n; ++i) {
    resize_bicubic_one(src + i * in_stride, h, w, c, resized.data(), rh_, rw,
                       rch, rcv, tmp);
    uint8_t* out = dst + i * out_stride;
    const int y0 = oy[i], x0 = ox[i];
    for (int y = 0; y < ch_; ++y) {
      const uint8_t* srow =
          resized.data() + (static_cast<size_t>(y0 + y) * rw + x0) * c;
      uint8_t* drow = out + static_cast<size_t>(y) * cw * c;
      if (!flip[i]) {
        std::memcpy(drow, srow, static_cast<size_t>(cw) * c);
      } else {
        for (int x = 0; x < cw; ++x) {
          const uint8_t* px = srow + static_cast<size_t>(cw - 1 - x) * c;
          std::memcpy(drow + static_cast<size_t>(x) * c, px, c);
        }
      }
    }
  }
}

// Horizontal flip in place-free form: dst = flip_lr(src), [n,h,w,c] u8.
void tg_hflip_u8(const uint8_t* src, int64_t n, int h, int w, int c,
                 uint8_t* dst) {
  const size_t stride = static_cast<size_t>(h) * w * c;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* in = src + i * stride;
    uint8_t* out = dst + i * stride;
    for (int y = 0; y < h; ++y) {
      const uint8_t* srow = in + static_cast<size_t>(y) * w * c;
      uint8_t* drow = out + static_cast<size_t>(y) * w * c;
      for (int x = 0; x < w; ++x)
        std::memcpy(drow + static_cast<size_t>(x) * c,
                    srow + static_cast<size_t>(w - 1 - x) * c, c);
    }
  }
}

int tg_version() { return 1; }

}  // extern "C"
