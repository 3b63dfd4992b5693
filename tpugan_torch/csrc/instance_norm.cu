// Instance norm followed by a leaky activation or by a per-plane affine
// (AdaIN), forward and backward, on contiguous NCHW float32 or bfloat16: one
// (sample, channel) plane of H*W values at a time.
//
// Replaces four Pallas TPU kernels of tpugan/ops/pallas_kernels.py. Three
// compute one function: instance_norm_pallas (slope 1), the fused
// instance_norm_act_pallas, and the HW-tiled two-pass instance_norm_act_tiled
// for maps above the TPU's VMEM envelope. The fourth is adain_pallas
// (_adain_fwd_kernel, _adain_bwd_kernel), whose weight and bias come per
// (sample, channel) from a style code. The affine variant is the same
// kernels with kAffine set.
//
//   forward:  mean, var = mean((x - mean)^2)  (centred, two passes: no
//             E[x^2] - mean^2 cancellation at large offsets),
//             rstd = 1/sqrt(var + eps), xh = (x - mean) * rstd,
//             y = xh >= 0 ? xh : slope * xh       (leaky)
//             y = xh * w[n, c] + b[n, c]           (affine, plane p = n * C + c)
//   backward: gh = g * (xh >= 0 ? 1 : slope)      (leaky; gh = g when affine),
//             s = sum(gh), t = sum(gh * xh),
//             dx = (gh - s/HW - xh * t/HW) * rstd * a,  a = 1 or w[p];
//             affine also db[n, c] = s, dw[n, c] = t.
//   The affine dx is (w g - mean(w g) - xh mean(w g xh)) * rstd with w taken
//   out of the bracket: no division by w, so w = 0 is safe.
//
// Every kernel is templated on the storage type T of x, y, g and dx: float,
// or __nv_bfloat16 for --dtype bfloat16, where the convolutions hand the
// norms bf16 maps. Whatever T, the arithmetic is float32: each value is
// widened on load, the sums, mean and rstd are float32 (mean and rstd are
// stored as float32), and each output is rounded once, to nearest even,
// when it is stored. AdaIN's w and b are T too, read where they lie: (B, C)
// tensors whose rows may lie further apart than C (a column slice of the
// style MLP's (B, 4C x blocks) output, as MUNIT hands them), each widened in a
// register; dw and db are contiguous (B, C) tensors of T, each rounded once
// from its float32 sum. So an AdaIN call is one launch each way, in either
// dtype, with no conversion or copy around it.
//
// Bound by memory bandwidth: the least traffic is 2 * sizeof(T) bytes an
// element forward (x in, y out) and 3 * sizeof(T) backward (g and x in, dx
// out), plus a few floats a plane: 8 and 12 in float32, 4 and 6 in bf16.
// Tensor cores have no part here: both directions are reductions at about
// one operation a byte, far below the card's ridge point. So the design
// reads each input from device memory once, in one of two regimes that the
// caller's launch plan (tpugan_torch/ops/instance_norm.py:plan) picks:
//
//   A, H*W <= 256 (16x16 down to 2x2, and odd planes such as 1x7): one warp
//     owns a plane and several planes share a CTA. The values stay in
//     registers, at most 8 a lane; the sums are warp shuffles, with no
//     __syncthreads.
//   B, every larger plane: each CTA owns a slice of the plane and holds it in
//     dynamic shared memory (x forward; g and x backward). The slice arrives
//     by 1D bulk asynchronous copy (cp.async.bulk) in up to kChunks chunks,
//     each completing on its own mbarrier, so the first sum starts on the
//     first chunk while the rest arrive, and is read back 16 bytes at a time
//     (4 floats or 8 bf16). Where H*W is not a multiple of those 4 or 8, or a
//     base is not 16-byte aligned, the same kernel fills shared memory with a
//     scalar loop instead. Shared memory holds T, so a bf16 slice takes half
//     the bytes of a float one. Every later pass reads shared memory. A plane larger than one
//     CTA's share runs on a thread block cluster of 2, 4 or 8 CTAs: each adds
//     its slice's partial sums, and after a cluster barrier every CTA reads
//     all partials through distributed shared memory in rank order 0..c-1,
//     so all get the same statistics and both directions repeat bit for bit.
//     A last cluster barrier before exit keeps each CTA's shared memory alive
//     while a peer may still read it. Where a slice exceeds kSmemMax (planes
//     over 8 x 64 KB, beyond every map of the ported trainers), the part of it
//     past kSmemMax stays in device memory and the later passes read it again.
//
// C interface for ctypes: every entry takes the launch plan and the CUDA
// stream (void*), launches on the stream without synchronising, and returns
// the launch's CUDA error code (0 on success). A plan the kernels cannot run
// returns cudaErrorInvalidValue and launches nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;           // regime B, threads a CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kWarpVals = 8;               // regime A, values a lane holds
constexpr int kWarpCtaMax = 256;           // regime A, threads a CTA (8 planes)
constexpr int kChunks = 4;                 // regime B, bulk copies a slice arrives in, at most
constexpr int kChunkBytes = 8192;          // ... and the least bytes a chunk is split down to
constexpr int kSmemMax = 64 * 1024;        // regime B, dynamic shared memory a CTA takes
constexpr int kClusterMax = 8;             // the portable cluster size

using bf16 = __nv_bfloat16;

// Elements of T in one 16-byte vector: 4 floats or 8 bf16.
template <class T>
constexpr int kLanes = 16 / static_cast<int>(sizeof(T));

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

// Sums the block totals (a, b) over a cluster of c CTAs: each CTA puts its
// pair in `part`, and after the cluster barrier thread 0 of every CTA adds
// all c pairs in rank order, so every CTA gets the same bits. Each call site
// takes its own `part` pair, since a peer may still read the previous one.
__device__ __forceinline__ void cluster_sum2(float& a, float& b, float* part, float* bc, int c) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    part[0] = a;
    part[1] = b;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < c; ++r) {
      const float* q = cluster.map_shared_rank(part, r);
      sa += q[0];
      sb += q[1];
    }
    bc[0] = sa;
    bc[1] = sb;
  }
  __syncthreads();
  a = bc[0];
  b = bc[1];
}

// The two halves of the last cluster barrier: arrive once this CTA has read
// its peers' partials, wait before exit until every peer has read its own.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this CTA's shared memory, completing on
// `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// First vector of chunk k when nv 16-byte vectors are cut into nch chunks.
__device__ __forceinline__ int chunk_edge(int k, int nv, int nch) {
  return static_cast<int>(static_cast<int64_t>(k) * nv / nch);
}

// Thread 0 starts the copy of the first nv 16-byte vectors of src0 (and of src1,
// where it is not null) into dst0 (dst1): up to kChunks bulk copies, chunk k
// of both tensors completing on bar[k]. Every thread calls it; it returns the
// number of chunks, each of which a thread waits for before reading it.
__device__ __forceinline__ int stage_async(const uint4* src0, uint4* dst0, const uint4* src1,
                                           uint4* dst1, int nv, uint64_t* bar) {
  const int tensors = src1 ? 2 : 1;
  const int nch = min(nv, max(1, min(kChunks, nv * 16 * tensors / kChunkBytes)));
  if (threadIdx.x == 0) {
    for (int k = 0; k < nch; ++k) mbar_init(&bar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < nch; ++k) {
      const int a = chunk_edge(k, nv, nch);
      const uint32_t bytes = static_cast<uint32_t>(chunk_edge(k + 1, nv, nch) - a) * 16u;
      mbar_expect_tx(&bar[k], bytes * tensors);
      bulk_load(dst0 + a, src0 + a, bytes, &bar[k]);
      if (src1) bulk_load(dst1 + a, src1 + a, bytes, &bar[k]);
    }
  }
  __syncthreads();  // the barriers are initialised before any thread waits on them
  return nch;
}

// Loads and stores of T through float32. A bf16 is the high half of a float,
// so widening it is exact; narrowing rounds to nearest even.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f(float v, bf16& out) { out = __float2bfloat16_rn(v); }

// unpack: one element, or one 16-byte vector of 4 floats or 8 bf16, into
// floats; pack: the way back, rounding bf16 once. A vector of bf16 holds
// element 2j in the low half of word j (little-endian).
__device__ __forceinline__ void unpack(float e, float (&v)[1]) { v[0] = e; }
__device__ __forceinline__ void unpack(bf16 e, float (&v)[1]) { v[0] = __bfloat162float(e); }
__device__ __forceinline__ void unpack(uint4 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void pack(const float (&v)[1], float& out) { out = v[0]; }
__device__ __forceinline__ void pack(const float (&v)[1], bf16& out) {
  out = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void pack(const float (&v)[4], uint4& out) {
  out = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                   __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}
__device__ __forceinline__ void pack(const float (&v)[8], uint4& out) {
  out = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                   bf16_pair(v[6], v[7]));
}

// The sum of n values in a fixed pairwise order: ((v0 + v1) + (v2 + v3)) ...
template <int N>
__device__ __forceinline__ float tsum(const float (&v)[N]) {
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) t[i] = t[2 * i] + t[2 * i + 1];
  }
  return t[0];
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
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
    return xh >= 0.f ? g : g * slope;
  }
}

// Where AdaIN's w and b lie: (B, C) tensors, each row's C entries adjacent,
// rows ldw (ldb) entries apart. Unused without kAffine.
struct PerPlane {
  int ch;      // C
  int64_t ldw;  // C when contiguous; 4C x blocks for a slice of MUNIT's style params
  int64_t ldb;
};

// Plane p = n * C + c's entry v[n * ld + c], widened to float.
template <class T>
__device__ __forceinline__ float per_plane(const T* __restrict__ v, int p, int ch, int64_t ld) {
  const int n = p / ch;
  return to_f(v[static_cast<int64_t>(n) * ld + (p - n * ch)]);
}

// Regime A, forward: warp w of CTA b owns plane b * per_cta + w, H*W <= 256.
template <class T, bool kAffine>
__global__ void __launch_bounds__(kWarpCtaMax)
    in_act_fwd_warp(const T* __restrict__ x, const T* __restrict__ w_in,
                    const T* __restrict__ b_in, T* __restrict__ y,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out, int planes,
                    int hw, int per_cta, float eps, float slope, PerPlane pp) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * per_cta + (threadIdx.x >> 5);
  if (p >= planes) return;
  const T* xp = x + static_cast<int64_t>(p) * hw;
  float v[kWarpVals];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kWarpVals; ++k) {
    const int i = k * 32 + lane;
    v[k] = i < hw ? to_f(xp[i]) : 0.f;
    s += v[k];
  }
  const float mean = warp_sum(s) / static_cast<float>(hw);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kWarpVals; ++k) {
    const float d = v[k] - mean;
    if (k * 32 + lane < hw) q += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) / static_cast<float>(hw) + eps);
  const float w = kAffine ? per_plane(w_in, p, pp.ch, pp.ldw) : 1.f;
  const float b = kAffine ? per_plane(b_in, p, pp.ch, pp.ldb) : 0.f;
  T* yp = y + static_cast<int64_t>(p) * hw;
#pragma unroll
  for (int k = 0; k < kWarpVals; ++k) {
    const int i = k * 32 + lane;
    if (i < hw) from_f(fwd_out<kAffine>((v[k] - mean) * rstd, slope, w, b), yp[i]);
  }
  if (lane == 0) {
    mean_out[p] = mean;
    rstd_out[p] = rstd;
  }
}

// Regime A, backward. w_in is read, and dw and db (contiguous (B, C))
// written, only when kAffine.
template <class T, bool kAffine>
__global__ void __launch_bounds__(kWarpCtaMax)
    in_act_bwd_warp(const T* __restrict__ g, const T* __restrict__ x,
                    const T* __restrict__ w_in, const float* __restrict__ mean_in,
                    const float* __restrict__ rstd_in, T* __restrict__ dx, T* __restrict__ dw,
                    T* __restrict__ db, int planes, int hw, int per_cta, float slope,
                    PerPlane pp) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * per_cta + (threadIdx.x >> 5);
  if (p >= planes) return;
  const int64_t base = static_cast<int64_t>(p) * hw;
  const float mean = mean_in[p];
  const float rstd = rstd_in[p];
  float gv[kWarpVals], h[kWarpVals];
  float s = 0.f, t = 0.f;
#pragma unroll
  for (int k = 0; k < kWarpVals; ++k) {
    const int i = k * 32 + lane;
    // Past the plane g = 0 and x = mean, so gh = 0 and h = 0 add nothing.
    gv[k] = i < hw ? to_f(g[base + i]) : 0.f;
    h[k] = ((i < hw ? to_f(x[base + i]) : mean) - mean) * rstd;
    const float gh = grad_in<kAffine>(gv[k], h[k], slope);
    s += gh;
    t += gh * h[k];
  }
  s = warp_sum(s);
  t = warp_sum(t);
  const float inv_hw = 1.f / static_cast<float>(hw);
  const float m1 = s * inv_hw;
  const float m2 = t * inv_hw;
  const float scale = kAffine ? per_plane(w_in, p, pp.ch, pp.ldw) * rstd : rstd;
#pragma unroll
  for (int k = 0; k < kWarpVals; ++k) {
    const int i = k * 32 + lane;
    if (i < hw) {
      from_f((grad_in<kAffine>(gv[k], h[k], slope) - m1 - h[k] * m2) * scale, dx[base + i]);
    }
  }
  if (kAffine && lane == 0) {
    from_f(t, dw[p]);
    from_f(s, db[p]);
  }
}

// What regime B moves at a time: one 16-byte vector of kLanes<T> elements
// (kVec), or one element.
template <class T, bool kVec>
using Vec = std::conditional_t<kVec, uint4, T>;

// Regime B, forward: the c CTAs blockIdx.x / c of a cluster own plane p, CTA
// of rank r the elements [r * slice, min((r + 1) * slice, H*W)), of which the
// first `held` sit in shared memory.
template <class T, bool kVec, bool kAffine>
__global__ void __launch_bounds__(kMaxThreads)
    in_act_fwd_slice(const T* __restrict__ x, const T* __restrict__ w_in,
                     const T* __restrict__ b_in, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out, int64_t hw,
                     int c, int slice, int held, float eps, float slope, PerPlane pp) {
  using V = Vec<T, kVec>;
  constexpr int kW = kVec ? kLanes<T> : 1;
  extern __shared__ __align__(128) float4 dyn[];
  __shared__ __align__(8) uint64_t bar[kChunks];
  __shared__ float red[2 * kMaxWarps], part[4], bc[2];

  const int p = blockIdx.x / c;
  const int rank = blockIdx.x % c;  // the cluster is (c, 1, 1) over a 1D grid
  const int64_t lo = static_cast<int64_t>(rank) * slice;
  const int n = static_cast<int>(min(static_cast<int64_t>(slice), hw - lo));
  const int nv = n / kW;                // vectors this CTA owns
  const int hv = min(n, held) / kW;     // of them held in shared memory
  const V* __restrict__ xs = reinterpret_cast<const V*>(x + static_cast<int64_t>(p) * hw + lo);
  V* __restrict__ ys = reinterpret_cast<V*>(y + static_cast<int64_t>(p) * hw + lo);
  V* sx = reinterpret_cast<V*>(dyn);
  const int tid = threadIdx.x, nt = blockDim.x;
  float v[kW];

  // Pass 1: the slice into shared memory, and its sum.
  float s = 0.f, none = 0.f;
  if constexpr (kVec) {
    const int nch = stage_async(xs, sx, nullptr, nullptr, hv, bar);
    for (int k = 0; k < nch; ++k) {
      mbar_wait(&bar[k], 0);
      const int end = chunk_edge(k + 1, hv, nch);
      for (int i = chunk_edge(k, hv, nch) + tid; i < end; i += nt) {
        unpack(sx[i], v);
        s += tsum(v);
      }
    }
    for (int i = hv + tid; i < nv; i += nt) {
      unpack(xs[i], v);
      s += tsum(v);
    }
  } else {
    // Each thread reads back only what it wrote here: no barrier needed.
    for (int i = tid; i < nv; i += nt) {
      const V e = xs[i];
      if (i < hv) sx[i] = e;
      unpack(e, v);
      s += v[0];
    }
  }
  block_sum2(s, none, red);
  if (c > 1) cluster_sum2(s, none, part, bc, c);
  const float mean = s / static_cast<float>(hw);

  // Pass 2: centred sum of squares.
  float q = 0.f;
  for (int i = tid; i < nv; i += nt) {
    unpack(i < hv ? sx[i] : xs[i], v);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const float d = v[j] - mean;
      v[j] = d * d;
    }
    q += tsum(v);
  }
  none = 0.f;
  block_sum2(q, none, red);
  if (c > 1) cluster_sum2(q, none, part + 2, bc, c);
  const float rstd = 1.f / sqrtf(q / static_cast<float>(hw) + eps);
  if (c > 1) cluster_arrive();

  // Pass 3: normalise, then activate or apply the affine; one rounding to T.
  const float w = kAffine ? per_plane(w_in, p, pp.ch, pp.ldw) : 1.f;
  const float b = kAffine ? per_plane(b_in, p, pp.ch, pp.ldb) : 0.f;
  for (int i = tid; i < nv; i += nt) {
    unpack(i < hv ? sx[i] : xs[i], v);
#pragma unroll
    for (int j = 0; j < kW; ++j) v[j] = fwd_out<kAffine>((v[j] - mean) * rstd, slope, w, b);
    V o;
    pack(v, o);
    ys[i] = o;
  }
  if (rank == 0 && tid == 0) {
    mean_out[p] = mean;
    rstd_out[p] = rstd;
  }
  if (c > 1) cluster_wait();
}

// Regime B, backward: the slices as in the forward, g and x both held.
template <class T, bool kVec, bool kAffine>
__global__ void __launch_bounds__(kMaxThreads)
    in_act_bwd_slice(const T* __restrict__ g, const T* __restrict__ x,
                     const T* __restrict__ w_in, const float* __restrict__ mean_in,
                     const float* __restrict__ rstd_in, T* __restrict__ dx, T* __restrict__ dw,
                     T* __restrict__ db, int64_t hw, int c, int slice, int held, float slope,
                     PerPlane pp) {
  using V = Vec<T, kVec>;
  constexpr int kW = kVec ? kLanes<T> : 1;
  extern __shared__ __align__(128) float4 dyn[];
  __shared__ __align__(8) uint64_t bar[kChunks];
  __shared__ float red[2 * kMaxWarps], part[2], bc[2];

  const int p = blockIdx.x / c;
  const int rank = blockIdx.x % c;
  const int64_t lo = static_cast<int64_t>(rank) * slice;
  const int64_t base = static_cast<int64_t>(p) * hw + lo;
  const int n = static_cast<int>(min(static_cast<int64_t>(slice), hw - lo));
  const int nv = n / kW;
  const int hv = min(n, held) / kW;
  const V* __restrict__ gs = reinterpret_cast<const V*>(g + base);
  const V* __restrict__ xs = reinterpret_cast<const V*>(x + base);
  V* __restrict__ ds = reinterpret_cast<V*>(dx + base);
  V* sg = reinterpret_cast<V*>(dyn);
  V* sx = sg + held / kW;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float mean = mean_in[p];
  const float rstd = rstd_in[p];

  // Pass 1: the slices into shared memory, and sum(gh), sum(gh * xh).
  float s = 0.f, t = 0.f;
  const auto add = [&](V gr, V xr) {
    float gv[kW], h[kW];
    unpack(gr, gv);
    unpack(xr, h);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      h[j] = (h[j] - mean) * rstd;
      gv[j] = grad_in<kAffine>(gv[j], h[j], slope);
    }
    s += tsum(gv);
#pragma unroll
    for (int j = 0; j < kW; ++j) h[j] *= gv[j];
    t += tsum(h);
  };
  if constexpr (kVec) {
    const int nch = stage_async(gs, sg, xs, sx, hv, bar);
    for (int k = 0; k < nch; ++k) {
      mbar_wait(&bar[k], 0);
      const int end = chunk_edge(k + 1, hv, nch);
      for (int i = chunk_edge(k, hv, nch) + tid; i < end; i += nt) add(sg[i], sx[i]);
    }
    for (int i = hv + tid; i < nv; i += nt) add(gs[i], xs[i]);
  } else {
    for (int i = tid; i < nv; i += nt) {
      const V gv = gs[i], xv = xs[i];
      if (i < hv) {
        sg[i] = gv;
        sx[i] = xv;
      }
      add(gv, xv);
    }
  }
  block_sum2(s, t, red);
  if (c > 1) {
    cluster_sum2(s, t, part, bc, c);
    cluster_arrive();
  }
  const float inv_hw = 1.f / static_cast<float>(hw);
  const float m1 = s * inv_hw;
  const float m2 = t * inv_hw;
  const float scale = kAffine ? per_plane(w_in, p, pp.ch, pp.ldw) * rstd : rstd;
  if (kAffine && rank == 0 && tid == 0) {
    from_f(t, dw[p]);
    from_f(s, db[p]);
  }

  // Pass 2: dx, one rounding to T.
  for (int i = tid; i < nv; i += nt) {
    float gv[kW], h[kW];
    unpack(i < hv ? sg[i] : gs[i], gv);
    unpack(i < hv ? sx[i] : xs[i], h);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const float e = (h[j] - mean) * rstd;
      gv[j] = (grad_in<kAffine>(gv[j], e, slope) - m1 - e * m2) * scale;
    }
    V o;
    pack(gv, o);
    ds[i] = o;
  }
  if (c > 1) cluster_wait();
}

}  // namespace

// How a call's planes map onto the card: instance_norm.py:plan computes it,
// ctypes passes it by pointer. Regime A when slice == 0, `group` planes a CTA;
// else regime B, `group` CTAs a plane (the cluster size), `slice` elements a
// CTA, `held` of them in shared memory. The plan is made for one storage
// type: slices of whole 16-byte vectors of it.
struct LaunchPlan {
  int64_t planes;
  int64_t hw;
  int32_t group;
  int32_t slice;
  int32_t held;
  int32_t threads;
};

namespace {

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// A regime-A plan the kernels can run: `group` warps of one plane each.
bool warp_plan_ok(const LaunchPlan& lp) {
  return lp.hw <= 32 * kWarpVals && lp.group >= 1 && lp.threads == 32 * lp.group &&
         lp.threads <= kWarpCtaMax;
}

// A regime-B plan the kernels can run: a cluster of c = group CTAs, a power
// of two up to kClusterMax; slices of whole vectors of `lanes` elements that
// cover H*W with none empty; no more held than owned. Whether the shared
// memory fits is the launch's to refuse.
bool slice_plan_ok(const LaunchPlan& lp, int lanes) {
  const int c = lp.group;
  return c >= 1 && c <= kClusterMax && (c & (c - 1)) == 0 && lp.slice > 0 &&
         lp.slice % lanes == 0 && lp.held > 0 && lp.held % lanes == 0 && lp.held <= lp.slice &&
         static_cast<int64_t>(lp.slice) * c >= lp.hw &&
         static_cast<int64_t>(lp.slice) * (c - 1) < lp.hw && lp.threads >= 32 &&
         lp.threads % 32 == 0 && lp.threads <= kMaxThreads && lp.planes * c <= INT_MAX;
}

// Launches a regime-B kernel on planes * c CTAs in clusters of c = group,
// with smem bytes of dynamic shared memory. Its limit is raised once per
// kernel.
template <auto kKernel, class... Args>
int launch_slices(const LaunchPlan& lp, size_t smem, cudaStream_t stream, Args... args) {
  const int c = lp.group;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(lp.planes * c));
  cfg.blockDim = dim3(static_cast<unsigned>(lp.threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(c);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = c > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kKernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <class T, bool kAffine>
int launch_fwd(const T* x, const T* w, const T* b, T* y, float* mean, float* rstd, float eps,
               float slope, PerPlane pp, const LaunchPlan& lp, cudaStream_t s) {
  const int64_t planes = lp.planes, hw = lp.hw;
  if (planes <= 0 || hw <= 0 || planes > INT_MAX) return kInvalid;
  const int np = static_cast<int>(planes);
  if (lp.slice == 0) {
    if (!warp_plan_ok(lp)) return kInvalid;
    const unsigned grid = static_cast<unsigned>((planes + lp.group - 1) / lp.group);
    in_act_fwd_warp<T, kAffine><<<grid, lp.threads, 0, s>>>(
        x, w, b, y, mean, rstd, np, static_cast<int>(hw), lp.group, eps, slope, pp);
    return static_cast<int>(cudaGetLastError());
  }
  if (!slice_plan_ok(lp, kLanes<T>)) return kInvalid;
  const size_t smem = static_cast<size_t>(lp.held) * sizeof(T);
  if (hw % kLanes<T> == 0 && aligned16(x) && aligned16(y))
    return launch_slices<in_act_fwd_slice<T, true, kAffine>>(lp, smem, s, x, w, b, y, mean, rstd,
                                                              hw, lp.group, lp.slice, lp.held,
                                                              eps, slope, pp);
  return launch_slices<in_act_fwd_slice<T, false, kAffine>>(lp, smem, s, x, w, b, y, mean, rstd,
                                                             hw, lp.group, lp.slice, lp.held, eps,
                                                             slope, pp);
}

template <class T, bool kAffine>
int launch_bwd(const T* g, const T* x, const T* w, const float* mean, const float* rstd, T* dx,
               T* dw, T* db, float slope, PerPlane pp, const LaunchPlan& lp, cudaStream_t s) {
  const int64_t planes = lp.planes, hw = lp.hw;
  if (planes <= 0 || hw <= 0 || planes > INT_MAX) return kInvalid;
  const int np = static_cast<int>(planes);
  if (lp.slice == 0) {
    if (!warp_plan_ok(lp)) return kInvalid;
    const unsigned grid = static_cast<unsigned>((planes + lp.group - 1) / lp.group);
    in_act_bwd_warp<T, kAffine><<<grid, lp.threads, 0, s>>>(
        g, x, w, mean, rstd, dx, dw, db, np, static_cast<int>(hw), lp.group, slope, pp);
    return static_cast<int>(cudaGetLastError());
  }
  if (!slice_plan_ok(lp, kLanes<T>)) return kInvalid;
  const size_t smem = 2 * static_cast<size_t>(lp.held) * sizeof(T);
  if (hw % kLanes<T> == 0 && aligned16(g) && aligned16(x) && aligned16(dx))
    return launch_slices<in_act_bwd_slice<T, true, kAffine>>(lp, smem, s, g, x, w, mean, rstd,
                                                              dx, dw, db, hw, lp.group, lp.slice,
                                                              lp.held, slope, pp);
  return launch_slices<in_act_bwd_slice<T, false, kAffine>>(lp, smem, s, g, x, w, mean, rstd, dx,
                                                             dw, db, hw, lp.group, lp.slice,
                                                             lp.held, slope, pp);
}

// The C entries' bodies, for either storage type. w and b select AdaIN,
// and slope is then unused: (B, C) tensors of T with C = ch, rows ldw and ldb
// entries apart, every plane's row inside them (the caller's check). Null,
// IN + leaky(slope), and ch, ldw and ldb are unused.
bool per_plane_ok(const LaunchPlan* plan, int64_t ch, int64_t ldw, int64_t ldb) {
  return ch >= 1 && ch <= INT_MAX && plan->planes % ch == 0 && ldw >= 0 && ldb >= 0;
}

template <class T>
int fwd_entry(const void* x, const void* w, const void* b, void* y, float* mean, float* rstd,
              float eps, float slope, int64_t ch, int64_t ldw, int64_t ldb,
              const LaunchPlan* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (!w) {
    return launch_fwd<T, false>(xt, nullptr, nullptr, yt, mean, rstd, eps, slope,
                                PerPlane{1, 0, 0}, *plan, s);
  }
  if (!b || !per_plane_ok(plan, ch, ldw, ldb)) return kInvalid;
  return launch_fwd<T, true>(xt, static_cast<const T*>(w), static_cast<const T*>(b), yt, mean,
                             rstd, eps, 1.f, PerPlane{static_cast<int>(ch), ldw, ldb}, *plan, s);
}

// dw and db: contiguous (B, C) of T.
template <class T>
int bwd_entry(const void* g, const void* x, const void* w, const float* mean, const float* rstd,
              void* dx, void* dw, void* db, float slope, int64_t ch, int64_t ldw,
              const LaunchPlan* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (!w) {
    return launch_bwd<T, false>(gt, xt, nullptr, mean, rstd, dxt, nullptr, nullptr, slope,
                                PerPlane{1, 0, 0}, *plan, s);
  }
  if (!dw || !db || !per_plane_ok(plan, ch, ldw, 0)) return kInvalid;
  return launch_bwd<T, true>(gt, xt, static_cast<const T*>(w), mean, rstd, dxt,
                             static_cast<T*>(dw), static_cast<T*>(db), 1.f,
                             PerPlane{static_cast<int>(ch), ldw, 0}, *plan, s);
}

}  // namespace

// Forward on float32 maps. w and b select AdaIN (see fwd_entry); mean and
// rstd get one float a plane.
extern "C" int in_act_fwd(const float* x, const float* w, const float* b, float* y, float* mean,
                          float* rstd, float eps, float slope, int64_t ch, int64_t ldw,
                          int64_t ldb, const LaunchPlan* plan, void* stream) {
  return fwd_entry<float>(x, w, b, y, mean, rstd, eps, slope, ch, ldw, ldb, plan, stream);
}

// Backward on float32 maps. w selects AdaIN, whose dw and dbias go to dw and
// db; null, IN + leaky(slope), and dw, db, ch and ldw are unused.
extern "C" int in_act_bwd(const float* g, const float* x, const float* w, const float* mean,
                          const float* rstd, float* dx, float* dw, float* db, float slope,
                          int64_t ch, int64_t ldw, const LaunchPlan* plan, void* stream) {
  return bwd_entry<float>(g, x, w, mean, rstd, dx, dw, db, slope, ch, ldw, plan, stream);
}

// The same on bf16 maps: x, y, g, dx, and AdaIN's w, b, dw and db are bf16;
// mean and rstd stay float32. The plan is made for 2-byte elements.
extern "C" int in_act_fwd_bf16(const void* x, const void* w, const void* b, void* y, float* mean,
                               float* rstd, float eps, float slope, int64_t ch, int64_t ldw,
                               int64_t ldb, const LaunchPlan* plan, void* stream) {
  return fwd_entry<bf16>(x, w, b, y, mean, rstd, eps, slope, ch, ldw, ldb, plan, stream);
}

extern "C" int in_act_bwd_bf16(const void* g, const void* x, const void* w, const float* mean,
                               const float* rstd, void* dx, void* dw, void* db, float slope,
                               int64_t ch, int64_t ldw, const LaunchPlan* plan, void* stream) {
  return bwd_entry<bf16>(g, x, w, mean, rstd, dx, dw, db, slope, ch, ldw, plan, stream);
}
