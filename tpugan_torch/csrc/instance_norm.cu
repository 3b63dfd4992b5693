// Instance norm followed by a leaky activation or by a per-plane affine
// (AdaIN), forward and backward, on contiguous NCHW float32: one (sample,
// channel) plane of H*W values at a time.
//
// Replaces four Pallas TPU kernels of tpugan/ops/pallas_kernels.py. Three
// compute one function: instance_norm_pallas (slope 1), the fused
// instance_norm_act_pallas, and the HW-tiled two-pass instance_norm_act_tiled
// for maps above the TPU's VMEM envelope. The fourth is adain_pallas
// (_adain_fwd_kernel, _adain_bwd_kernel), whose weight and bias come per
// (sample, channel) from a style code. Here one thread block owns one plane
// and loops over all of H*W, which takes the place of the TPU's sequential
// tile axis; there is no size envelope. The affine variant is the same
// kernels with kAffine set.
//
//   forward:  mean, var = mean((x - mean)^2)  (centred, two passes: no
//             E[x^2] - mean^2 cancellation at large offsets),
//             rstd = 1/sqrt(var + eps), xh = (x - mean) * rstd,
//             y = xh >= 0 ? xh : slope * xh       (leaky)
//             y = xh * w[p] + b[p]                 (affine, p = n * C + c)
//   backward: gh = g * (xh >= 0 ? 1 : slope)      (leaky; gh = g when affine),
//             s = sum(gh), t = sum(gh * xh),
//             dx = (gh - s/HW - xh * t/HW) * rstd * a,  a = 1 or w[p];
//             affine also db[p] = s, dw[p] = t.
//   The affine dx is (w g - mean(w g) - xh mean(w g xh)) * rstd with w taken
//   out of the bracket: no division by w, so w = 0 is safe. One block owns a
//   plane and its sums, so there are no atomics and both directions repeat
//   bit for bit.
//
// Bound by memory bandwidth: the forward reads x three times (the later
// reads mostly hit L2, a plane is at most 256 KB) and writes y once; the
// backward reads g and x twice and writes dx once. The affine variant adds
// two floats a plane each way (w, b in; dw, db out). Loads are 16 bytes wide
// where H*W % 4 == 0 and the pointers are aligned.
//
// C interface for ctypes: every entry takes the CUDA stream as void*, launches
// on it without synchronising, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums a and b over the block; every thread gets both totals. `red` holds
// 2 * kMaxWarps floats. Ends with a barrier, so `red` may be reused at once.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kMaxWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < n_warps ? red[lane] : 0.f;
    b = lane < n_warps ? red[kMaxWarps + lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      red[0] = a;
      red[kMaxWarps] = b;
    }
  }
  __syncthreads();
  a = red[0];
  b = red[kMaxWarps];
  __syncthreads();
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__device__ __forceinline__ float leaky_grad(float xh, float slope) {
  return xh >= 0.f ? 1.f : slope;
}

// The forward's output from xh: leaky(slope), or the plane's affine.
template <bool kAffine>
__device__ __forceinline__ float fwd_out(float xh, float slope, float w, float b) {
  if constexpr (kAffine) {
    return xh * w + b;
  } else {
    return leaky(xh, slope);
  }
}

// The backward's gh: the activation's gradient applied, or g as it is.
template <bool kAffine>
__device__ __forceinline__ float grad_in(float g, float xh, float slope) {
  if constexpr (kAffine) {
    return g;
  } else {
    return g * leaky_grad(xh, slope);
  }
}

// w and b are read only when kAffine (one float each per plane).
template <bool kVec, bool kAffine>
__global__ void in_act_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
                                  const float* __restrict__ b_in, float* __restrict__ y,
                                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                  int64_t hw, float eps, float slope) {
  __shared__ float red[2 * kMaxWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const float w = kAffine ? w_in[blockIdx.x] : 1.f;
  const float b = kAffine ? b_in[blockIdx.x] : 0.f;
  const float* xp = x + base;
  float* yp = y + base;
  const int64_t n4 = kVec ? hw / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(xp);

  // Pass 1: mean.
  float s = 0.f, unused = 0.f;
  if (kVec) {
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = x4[i];
      s += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) s += xp[i];
  }
  block_sum2(s, unused, red);
  const float mean = s / static_cast<float>(hw);

  // Pass 2: centred sum of squares.
  float q = 0.f;
  unused = 0.f;
  if (kVec) {
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = x4[i];
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
      q += (a * a + b * b) + (c * c + d * d);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
      const float a = xp[i] - mean;
      q += a * a;
    }
  }
  block_sum2(q, unused, red);
  const float rstd = 1.f / sqrtf(q / static_cast<float>(hw) + eps);

  // Pass 3: normalise, then activate or apply the affine.
  if (kVec) {
    float4* y4 = reinterpret_cast<float4*>(yp);
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = x4[i];
      float4 o;
      o.x = fwd_out<kAffine>((v.x - mean) * rstd, slope, w, b);
      o.y = fwd_out<kAffine>((v.y - mean) * rstd, slope, w, b);
      o.z = fwd_out<kAffine>((v.z - mean) * rstd, slope, w, b);
      o.w = fwd_out<kAffine>((v.w - mean) * rstd, slope, w, b);
      y4[i] = o;
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += blockDim.x)
      yp[i] = fwd_out<kAffine>((xp[i] - mean) * rstd, slope, w, b);
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

// w_in is read, and dw/db written, only when kAffine.
template <bool kVec, bool kAffine>
__global__ void in_act_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                                  const float* __restrict__ w_in,
                                  const float* __restrict__ mean_in,
                                  const float* __restrict__ rstd_in, float* __restrict__ dx,
                                  float* __restrict__ dw, float* __restrict__ db,
                                  int64_t hw, float slope) {
  __shared__ float red[2 * kMaxWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const float* gp = g + base;
  const float* xp = x + base;
  float* dp = dx + base;
  const float mean = mean_in[blockIdx.x];
  const float rstd = rstd_in[blockIdx.x];
  const int64_t n4 = kVec ? hw / 4 : 0;
  const float4* g4 = reinterpret_cast<const float4*>(gp);
  const float4* x4 = reinterpret_cast<const float4*>(xp);

  // Pass 1: sum(gh) and sum(gh * xh), xh re-derived from the saved stats.
  float s = 0.f, t = 0.f;
  if (kVec) {
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 gv = g4[i], xv = x4[i];
      const float ha = (xv.x - mean) * rstd, hb = (xv.y - mean) * rstd;
      const float hc = (xv.z - mean) * rstd, hd = (xv.w - mean) * rstd;
      const float ga = grad_in<kAffine>(gv.x, ha, slope), gb = grad_in<kAffine>(gv.y, hb, slope);
      const float gc = grad_in<kAffine>(gv.z, hc, slope), gd = grad_in<kAffine>(gv.w, hd, slope);
      s += (ga + gb) + (gc + gd);
      t += (ga * ha + gb * hb) + (gc * hc + gd * hd);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
      const float h = (xp[i] - mean) * rstd;
      const float gh = grad_in<kAffine>(gp[i], h, slope);
      s += gh;
      t += gh * h;
    }
  }
  block_sum2(s, t, red);
  const float inv_hw = 1.f / static_cast<float>(hw);
  const float m1 = s * inv_hw;
  const float m2 = t * inv_hw;
  const float scale = kAffine ? w_in[blockIdx.x] * rstd : rstd;
  if (kAffine && threadIdx.x == 0) {
    db[blockIdx.x] = s;
    dw[blockIdx.x] = t;
  }

  // Pass 2: dx.
  if (kVec) {
    float4* d4 = reinterpret_cast<float4*>(dp);
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 gv = g4[i], xv = x4[i];
      float4 o;
      float h;
      h = (xv.x - mean) * rstd;
      o.x = (grad_in<kAffine>(gv.x, h, slope) - m1 - h * m2) * scale;
      h = (xv.y - mean) * rstd;
      o.y = (grad_in<kAffine>(gv.y, h, slope) - m1 - h * m2) * scale;
      h = (xv.z - mean) * rstd;
      o.z = (grad_in<kAffine>(gv.z, h, slope) - m1 - h * m2) * scale;
      h = (xv.w - mean) * rstd;
      o.w = (grad_in<kAffine>(gv.w, h, slope) - m1 - h * m2) * scale;
      d4[i] = o;
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
      const float h = (xp[i] - mean) * rstd;
      dp[i] = (grad_in<kAffine>(gp[i], h, slope) - m1 - h * m2) * scale;
    }
  }
}

// Threads per block: about 4 float4 loads per thread per pass, between 2 and
// 32 warps.
int threads_for(int64_t hw) {
  int t = 64;
  while (t < 1024 && static_cast<int64_t>(t) * 16 < hw) t *= 2;
  return t;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <bool kAffine>
int launch_fwd(const float* x, const float* w, const float* b, float* y, float* mean, float* rstd,
               int64_t planes, int64_t hw, float eps, float slope, void* stream) {
  if (planes <= 0 || hw <= 0 || planes > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(planes));
  const int threads = threads_for(hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hw % 4 == 0 && aligned16(x) && aligned16(y))
    in_act_fwd_kernel<true, kAffine><<<grid, threads, 0, s>>>(x, w, b, y, mean, rstd, hw, eps, slope);
  else
    in_act_fwd_kernel<false, kAffine><<<grid, threads, 0, s>>>(x, w, b, y, mean, rstd, hw, eps, slope);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAffine>
int launch_bwd(const float* g, const float* x, const float* w, const float* mean,
               const float* rstd, float* dx, float* dw, float* db, int64_t planes, int64_t hw,
               float slope, void* stream) {
  if (planes <= 0 || hw <= 0 || planes > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(planes));
  const int threads = threads_for(hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hw % 4 == 0 && aligned16(g) && aligned16(x) && aligned16(dx))
    in_act_bwd_kernel<true, kAffine><<<grid, threads, 0, s>>>(g, x, w, mean, rstd, dx, dw, db, hw,
                                                             slope);
  else
    in_act_bwd_kernel<false, kAffine><<<grid, threads, 0, s>>>(g, x, w, mean, rstd, dx, dw, db,
                                                              hw, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int in_act_fwd(const float* x, float* y, float* mean, float* rstd, int64_t planes,
                          int64_t hw, float eps, float slope, void* stream) {
  return launch_fwd<false>(x, nullptr, nullptr, y, mean, rstd, planes, hw, eps, slope, stream);
}

extern "C" int in_act_bwd(const float* g, const float* x, const float* mean, const float* rstd,
                          float* dx, int64_t planes, int64_t hw, float slope, void* stream) {
  return launch_bwd<false>(g, x, nullptr, mean, rstd, dx, nullptr, nullptr, planes, hw, slope,
                           stream);
}

// AdaIN: w and b hold one float per plane, (B, C) contiguous.
extern "C" int adain_fwd(const float* x, const float* w, const float* b, float* y, float* mean,
                         float* rstd, int64_t planes, int64_t hw, float eps, void* stream) {
  return launch_fwd<true>(x, w, b, y, mean, rstd, planes, hw, eps, 1.f, stream);
}

extern "C" int adain_bwd(const float* g, const float* x, const float* w, const float* mean,
                         const float* rstd, float* dx, float* dw, float* db, int64_t planes,
                         int64_t hw, void* stream) {
  return launch_bwd<true>(g, x, w, mean, rstd, dx, dw, db, planes, hw, 1.f, stream);
}
