// Closed-form WGAN-GP for the template-A MLP critic (flat image -> N1 -> N2 ->
// 1, LeakyReLU 0.2, no sigmoid), forward and backward, in float32.
//
// Replaces the Pallas TPU kernels of tpugan/ops/pallas_critic.py:mlp_gp_pallas:
// _gp_fwd_kernel (:151) and _gp_bwd_kernel (:165). With x the flattened
// interpolates (B, N0) and m(z) = z >= 0 ? 1 : 0.2:
//
//   forward:  z1 = x W1^T + b1, m1 = m(z1)        a1 = z1 * m1
//             z2 = a1 W2^T + b2, m2 = m(z2)       u  = m2 * w3
//             t  = (u W2) * m1                    g  = t W1
//   backward: s  = (q W1^T) * m1                  dW1 = t^T q
//             dW2 = u^T s                         dw3 = sum_b m2 * (s W2^T)
//
// All matrices are row-major and contiguous, and the weights are taken in
// torch's nn.Linear layout as they are, (out, in): W1 is (N1, N0), W2 is
// (N2, N1), w3 is the (1, N2) row. Nothing is transposed on the host; each
// product reads its operands through a compile-time transpose choice. The
// forward keeps u and t for the backward; a1 lives in t's buffer until the
// third product overwrites it. The gradients of b1, b2 and x are exactly 0
// and the penalty does not depend on b3, so they are not computed.
//
// What bounds it on this card. At B = 64, N0 = 784, N1 = 512, N2 = 256 each
// direction is 2 B (2 N0 N1 + 2 N1 N2) = 136 MFLOP, 2 us at the FP32 FFMA
// peak, on about 3-5 MB of operands that all sit in the 50 MB L2. With M = B
// = 64 rows a product, what sets the time is each CTA's own chain: about
// 1 us a launch, about 0.5-1 us a depth stage of 16 (the shared-memory
// traffic of the fragment loads and the FFMAs of one 64-row tile; a deeper
// ring or a depth of 32 a stage moved it little on the H100), and about 2 us
// of epilogue behind the cluster barriers. The design, against the four
// faults of the first version (too few CTAs, unpipelined depth loops, four
// dependent launches each way, a heavy host wrapper):
//
//  1. CTAs for 132 SMs, so that each CTA's chain is short. Each product's
//     output tile spans 64 rows (all of a batch of 64; larger batches loop or
//     tile over rows) by 16 or 32 columns, and its depth K is split over a
//     thread block cluster of up to 8 CTAs. Each CTA computes a partial tile
//     over its K range and keeps it in shared memory; after a cluster
//     barrier, rank r adds the partials of its share of the tile's rows from
//     every peer in rank order 0..ks-1 through distributed shared memory and
//     runs the epilogue on them. No atomics: every sum has a fixed order, so
//     runs repeat bit for bit. The launch plan
//     (tpugan_torch/ops/mlp_gp.py:plan) picks the tile width and the split;
//     at the slice shape each product runs 128-392 CTAs.
//  2. Pipelined staging. A and B tiles of depth 16 arrive by cp.async (16
//     bytes a copy where every row is 16-byte aligned, 4 bytes otherwise,
//     zero-filled past the edges) into a ring of 2 stages: the next stage is
//     in flight while the FFMAs of this one run, one barrier a stage. Each of
//     128 threads holds a 4 x 4 (or 2 x 4) register tile and reads its
//     operands' fragments 8 or 16 bytes at a time, bank-conflict free.
//  3. Fewer dependent launches. The backward is two launches, each running
//     two independent products side by side in one grid (the CTAs of the
//     second product after those of the first): s = (q W1^T) * m1 with
//     dW1 = t^T q, then dw3 with dW2 = u^T s. dw3's column sum is taken in
//     the cluster: each rank adds its share of the tile's rows in a fixed
//     order, rank 0 adds the ranks' column sums in rank order, and the CTAs
//     loop over row tiles past 64. Where the plan asks for it, the launches
//     after the first go out with programmatic dependent launch: each CTA
//     first prefetches the operand that the launch before does not write (a
//     weight, or u), then waits (griddepcontrol.wait) for it.
//  4. The host passes the plan by pointer, with the shapes in it; the
//     epilogue loads its operands before it stores anything.
//
// C interface for ctypes: each entry issues its launches on the given stream,
// without synchronising, and returns the first CUDA error (0 on success). A
// plan the kernels cannot run returns cudaErrorInvalidValue and launches
// nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;       // output rows a tile
constexpr int BK = 16;       // depth a stage
constexpr int kStages = 2;   // the cp.async ring
constexpr int kThreads = 128;
constexpr int kClusterMax = 8;         // the portable cluster size
constexpr int kGather = 4;             // epilogue elements a thread loads before storing
constexpr int kATile = BM * (BK + 4);  // floats of an A stage, either layout
constexpr float kSlope = 0.2f;         // LeakyReLU slope of the critic
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// Floats of a B stage: (BN, BK) or (BK, BN) rows, each padded by 4.
__host__ __device__ constexpr int b_tile(int bn) {
  return bn * (BK + 4) > BK * (bn + 4) ? bn * (BK + 4) : BK * (bn + 4);
}

// Dynamic shared memory of a launch: the ring, then the partial tile.
__host__ __device__ constexpr int smem_bytes(int bn) {
  return 4 * (kStages * (kATile + b_tile(bn)) + BM * bn);
}

enum Epi {
  kStore = 0,      // C = acc
  kBiasMask = 1,   // z = acc + bias[n]; out2 = m(z); C = z * m(z)
  kBiasMaskW3 = 2, // z = acc + bias[n]; out2 = m(z); C = m(z) * vec[n]
  kMulMask = 3,    // C = acc * mask[m, n]
  kColSumMask = 4  // C[n] = sum over all m of mask[m, n] * acc[m, n]
};

// A product's compile-time form: op(A) is A stored (M, K), or (K, M) with
// TA; op(B) is B stored (K, N), or (N, K) with TB.
template <bool kTA, bool kTB, int kEpi>
struct Op {
  static constexpr bool TA = kTA, TB = kTB;
  static constexpr int EPI = kEpi;
};
struct NoOp {};

// A product's runtime form: operands, epilogue operands, extents, and its
// share of the launch from the plan. CTA i of the product is rank i % ks of
// the cluster for tile i / ks; tile t covers columns (t % tiles_n) * BN and
// rows (t / tiles_n) * BM, or, for the column sum (tiles_m = 1), every row
// tile in turn. Rank r takes depth [r kc, min((r + 1) kc, K)) and, in the
// epilogue, tile rows [r rows, min((r + 1) rows, BM)).
struct Job {
  const float* A;
  const float* B;
  float* C;
  const float* bias;  // (N,): kBiasMask, kBiasMaskW3
  const float* vec;   // (N,): kBiasMaskW3
  const float* mask;  // (M, N) as C: kMulMask, kColSumMask
  float* out2;        // (M, N) as C: the mask written by kBiasMask*
  int M, N, K, lda, ldb, ldc;
  int ks, kc, rows, tiles_m, tiles_n, ctas;
  int pre_a;  // the operand the launch before does not write: 1 A, 0 B
};

__device__ __forceinline__ float leaky_mask(float z) { return z >= 0.f ? 1.f : kSlope; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; nothing is read and zeros are written where
// `ok` is false (src-size 0), and src is then any valid address.
template <bool kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  if constexpr (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: let the next launch start its CTAs, and
// wait for the launch before (no-ops where the launch was not made so).
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// The two halves of a cluster barrier (release on arrive, acquire on wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stages a (R, C) tile of a row-major matrix g (row stride ld): rows
// [r0, r0 + R) below rend, columns [c0, c0 + C) below cend, into s with row
// pitch `pitch`. With kVec, c0, cend, ld and g are multiples of 4 floats.
template <int R, int C, bool kVec>
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g, int ld, int r0,
                                      int rend, int c0, int cend, int pitch) {
  constexpr int W = kVec ? 4 : 1;
  constexpr int CW = C / W;
  for (int i = threadIdx.x; i < R * CW; i += kThreads) {
    const int r = i / CW, c = (i % CW) * W;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr < rend && gc < cend;
    cp_async<kVec>(s + r * pitch + c, ok ? g + static_cast<size_t>(gr) * ld + gc : g, ok);
  }
}

template <int BN, bool kVec, class O>
__device__ __forceinline__ void stage_a(float* s, const Job& j, int m0, int k0, int k_hi) {
  if constexpr (O::TA)
    stage<BK, BM, kVec>(s, j.A, j.lda, k0, k_hi, m0, j.M, BM + 4);
  else
    stage<BM, BK, kVec>(s, j.A, j.lda, m0, j.M, k0, k_hi, BK + 4);
}

template <int BN, bool kVec, class O>
__device__ __forceinline__ void stage_b(float* s, const Job& j, int n0, int k0, int k_hi) {
  if constexpr (O::TB)
    stage<BN, BK, kVec>(s, j.B, j.ldb, n0, j.N, k0, k_hi, BK + 4);
  else
    stage<BK, BN, kVec>(s, j.B, j.ldb, k0, k_hi, n0, j.N, BN + 4);
}

// CTA `idx` of product j. `dyn` is the launch's dynamic shared memory.
template <int BN, bool kVec, class O>
__device__ __forceinline__ void run(const Job& j, int idx, float* dyn, float* colred,
                                    float* colpart) {
  // Thread tile: TM rows by 4 columns (4 x 4 at BN = 32, 2 x 4 at 16). A
  // thread's rows (columns) are contiguous where the operand sits in shared
  // memory as (depth, rows) and strided where it sits as (rows, depth), so
  // that every fragment load is 8 or 16 bytes and a warp's loads hit
  // distinct banks.
  constexpr int TN = 4;
  constexpr int TXN = BN / TN;          // thread columns
  constexpr int TYN = kThreads / TXN;   // thread rows
  constexpr int TM = BM / TYN;
  constexpr int kStageF = kATile + b_tile(BN);
  float* part = dyn + kStages * kStageF;  // this CTA's partial tile, (BM, BN)
  const int ks = j.ks;
  const int rank = idx % ks;
  const int tile = idx / ks;
  const int n0 = (tile % j.tiles_n) * BN;
  const int k_lo = rank * j.kc;
  const int k_hi = min(j.K, k_lo + j.kc);
  const int nst = (k_hi - k_lo + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int tx = tid % TXN, ty = tid / TXN;
  const auto row = [&](int i) { return O::TA ? ty * TM + i : ty + i * TYN; };
  const auto col = [&](int c) { return O::TB ? tx + c * TXN : tx * TN + c; };
  const int r_lo = min(BM, rank * j.rows), r_hi = min(BM, r_lo + j.rows);
  float colacc = 0.f;  // kColSumMask: thread n < BN, column n0 + n over the row tiles
  // Element e of the tile summed over the ranks' partials in rank order: all
  // ks loads issued first, then added in order (ranks past ks add +0).
  const auto ranks_sum = [&](int e) {
    if (ks == 1) return part[e];
    cg::cluster_group cluster = cg::this_cluster();
    float p[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      p[q] = q < ks ? cluster.map_shared_rank(part, q)[e] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q) v += p[q];
    return v;
  };

  for (int m0 = (tile / j.tiles_n) * BM, it = 0; m0 < j.M; m0 += j.tiles_m * BM, ++it) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

    // Prologue: the independent operand of the first stages, the wait for
    // the launch before, then the other operand; stage s completes with
    // commit group s.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nst) {
        float* buf = dyn + s * kStageF;
        if (j.pre_a)
          stage_a<BN, kVec, O>(buf, j, m0, k_lo + s * BK, k_hi);
        else
          stage_b<BN, kVec, O>(buf + kATile, j, n0, k_lo + s * BK, k_hi);
      }
    }
    pdl_wait();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nst) {
        float* buf = dyn + s * kStageF;
        if (j.pre_a)
          stage_b<BN, kVec, O>(buf + kATile, j, n0, k_lo + s * BK, k_hi);
        else
          stage_a<BN, kVec, O>(buf, j, m0, k_lo + s * BK, k_hi);
      }
      cp_commit();
    }

    for (int st = 0; st < nst; ++st) {
      cp_wait<kStages - 2>();
      __syncthreads();  // stage st is in; every thread is past stage st - 1
      const int nx = st + kStages - 1;
      if (nx < nst) {
        float* buf = dyn + (nx % kStages) * kStageF;
        stage_a<BN, kVec, O>(buf, j, m0, k_lo + nx * BK, k_hi);
        stage_b<BN, kVec, O>(buf + kATile, j, n0, k_lo + nx * BK, k_hi);
      }
      cp_commit();
      const float* As = dyn + (st % kStages) * kStageF;
      const float* Bs = As + kATile;
      // Four depths at a time: a[i][q] = A(row i, k + q), b[q][c] = B(k + q,
      // column c), added to acc in ascending depth.
#pragma unroll
      for (int k = 0; k < BK; k += 4) {
        float a[TM][4], b[4][TN];
        if constexpr (O::TA) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* src = As + (k + q) * (BM + 4) + ty * TM;
            if constexpr (TM == 4) {
              const float4 v = *reinterpret_cast<const float4*>(src);
              a[0][q] = v.x, a[1][q] = v.y, a[2][q] = v.z, a[3][q] = v.w;
            } else {
              const float2 v = *reinterpret_cast<const float2*>(src);
              a[0][q] = v.x, a[1][q] = v.y;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(As + row(i) * (BK + 4) + k);
            a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
          }
        }
        if constexpr (O::TB) {
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + col(c) * (BK + 4) + k);
            b[0][c] = v.x, b[1][c] = v.y, b[2][c] = v.z, b[3][c] = v.w;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + (k + q) * (BN + 4) + tx * TN);
            b[q][0] = v.x, b[q][1] = v.y, b[q][2] = v.z, b[q][3] = v.w;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i][q], b[q][c], acc[i][c]);
      }
    }

    // The partial tile into shared memory, once every peer has read the
    // last one; then a barrier across the cluster (or the CTA).
    if (ks > 1 && it > 0) cluster_wait();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) part[row(i) * BN + col(c)] = acc[i][c];
    if (ks > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }

    // The epilogue loads all its operands from device memory before it
    // stores anything, so that a thread's loads overlap instead of each
    // waiting on the store before it.
    if constexpr (O::EPI == kColSumMask) {
      // Thread (grp, n) adds rows r_lo + grp, + G, ... of column n below
      // r_hi in ascending order, each summed over the ranks in order; the G
      // group sums are added in group order into the rank's column partial,
      // and rank 0 adds the ranks' partials in rank order.
      constexpr int G = kThreads / BN;
      constexpr int RPT = BM / G;  // a multiple of kGather
      const int n = tid % BN, grp = tid / BN, gn = n0 + n;
      float sum = 0.f;
      for (int t0 = 0; t0 < RPT && r_lo + t0 * G < r_hi; t0 += kGather) {
        float mk[kGather];
#pragma unroll
        for (int t = 0; t < kGather; ++t) {
          const int r = r_lo + grp + (t0 + t) * G, gm = m0 + r;
          mk[t] = r < r_hi && gm < j.M && gn < j.N ? j.mask[static_cast<size_t>(gm) * j.N + gn]
                                                    : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kGather; ++t) {
          const int r = r_lo + grp + (t0 + t) * G;
          if (r < r_hi && m0 + r < j.M && gn < j.N) sum = fmaf(mk[t], ranks_sum(r * BN + n), sum);
        }
      }
      colred[grp * BN + n] = sum;
      __syncthreads();
      if (tid < BN) {
        float rsum = 0.f;
#pragma unroll
        for (int q = 0; q < G; ++q) rsum += colred[q * BN + tid];
        colpart[tid] = rsum;
      }
      if (ks > 1) {
        cluster_arrive();
        cluster_wait();
      } else {
        __syncthreads();
      }
      if (rank == 0 && tid < BN) {
        float csum = 0.f;
        for (int q = 0; q < ks; ++q)
          csum += ks > 1 ? cg::this_cluster().map_shared_rank(colpart, q)[tid] : colpart[tid];
        colacc += csum;
      }
    } else {
      // Rank r adds its rows over the ranks in order and stores them:
      // element e = tid + t * kThreads of its rows, kGather at a time.
      const int cnt = (r_hi - r_lo) * BN;
      for (int e0 = 0; e0 < cnt; e0 += kGather * kThreads) {
        float x[kGather], y[kGather];
#pragma unroll
        for (int t = 0; t < kGather; ++t) {
          const int e = e0 + tid + t * kThreads;
          const int gm = m0 + r_lo + e / BN, gn = n0 + e % BN;
          if (e < cnt && gm < j.M && gn < j.N) {
            if constexpr (O::EPI == kBiasMask || O::EPI == kBiasMaskW3) x[t] = j.bias[gn];
            if constexpr (O::EPI == kBiasMaskW3) y[t] = j.vec[gn];
            if constexpr (O::EPI == kMulMask) x[t] = j.mask[static_cast<size_t>(gm) * j.ldc + gn];
          }
        }
#pragma unroll
        for (int t = 0; t < kGather; ++t) {
          const int e = e0 + tid + t * kThreads;
          const int r = r_lo + e / BN, gn = n0 + e % BN, gm = m0 + r;
          if (e >= cnt || gm >= j.M || gn >= j.N) continue;
          const float v = ranks_sum(r * BN + e % BN);
          const size_t o = static_cast<size_t>(gm) * j.ldc + gn;
          if constexpr (O::EPI == kStore) {
            j.C[o] = v;
          } else if constexpr (O::EPI == kBiasMask) {
            const float z = v + x[t];
            const float m = leaky_mask(z);
            j.out2[o] = m;
            j.C[o] = z * m;
          } else if constexpr (O::EPI == kBiasMaskW3) {
            const float m = leaky_mask(v + x[t]);
            j.out2[o] = m;
            j.C[o] = m * y[t];
          } else {  // kMulMask
            j.C[o] = v * x[t];
          }
        }
      }
    }
    if (ks > 1)
      cluster_arrive();  // this CTA has read its peers' partials
    else
      __syncthreads();  // ... and its own, before the next row tile writes them
  }
  if (O::EPI == kColSumMask && rank == 0 && tid < BN && n0 + tid < j.N) j.C[n0 + tid] = colacc;
  if (ks > 1) cluster_wait();  // no peer still reads this CTA's partial
}

// One launch: product j0 on CTAs [0, j0.ctas), clusters of j0.ks, and, where
// O1 is an Op, product j1 (ks = 1) on the CTAs after them.
// One CTA an SM at least: without that bound ptxas caps the registers and
// spills in the backward's paired launches.
template <int BN, bool kVec, class O0, class O1>
__global__ void __launch_bounds__(kThreads, 1) gp_gemm(const Job j0, const Job j1) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float colred[kThreads], colpart[32];
  pdl_trigger();
  const int b = static_cast<int>(blockIdx.x);
  if (b < j0.ctas) {
    run<BN, kVec, O0>(j0, b, dyn, colred, colpart);
  } else if constexpr (!std::is_same_v<O1, NoOp>) {
    if (b - j0.ctas < j1.ctas) run<BN, kVec, O1>(j1, b - j0.ctas, dyn, colred, colpart);
  }
}

}  // namespace

// A product's share of the launch plan (tpugan_torch/ops/mlp_gp.py:plan),
// as in Job.
struct GpProduct {
  int32_t ks;
  int32_t kc;
  int32_t rows;
  int32_t tiles_m;
  int32_t tiles_n;
  int32_t ctas;
};

// The launch plan, passed by pointer. Forward: launch i runs product i
// (z1, z2, t, g). Backward: launch 0 runs products 0 (s) and 1 (dW1), launch
// 1 products 2 (dw3) and 3 (dW2). pdl: launches after the first go out with
// programmatic stream serialisation.
struct GpPlan {
  int64_t b, n0, n1, n2;
  int32_t pdl;
  int32_t bn[4];    // tile columns of launch i, 16 or 32
  int32_t grid[4];  // CTAs of launch i
  int32_t smem[4];  // dynamic shared memory of launch i, bytes
  GpProduct prod[4];
};

namespace {

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Every extent positive and every matrix's index inside int.
bool shapes_ok(const GpPlan& p) {
  const int64_t lim = 0x7fffffff;
  if (p.b <= 0 || p.n0 <= 0 || p.n1 <= 0 || p.n2 <= 0) return false;
  return p.b <= lim / p.n0 && p.b <= lim / p.n1 && p.n1 <= lim / p.n0 && p.n2 <= lim / p.n1;
}

int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// Whether the kernel runs product p of an (M, N) output over depth K with
// tiles of bn columns: ranks with non-empty depth ranges that cover [0, K),
// epilogue rows that cover the tile, and the tile counts of the shape.
bool product_ok(const GpProduct& p, int64_t M, int64_t N, int64_t K, int bn, bool colsum) {
  if (p.ks < 1 || p.ks > kClusterMax || p.kc <= 0 || p.kc % BK != 0) return false;
  if (static_cast<int64_t>(p.kc) * p.ks < K || static_cast<int64_t>(p.kc) * (p.ks - 1) >= K)
    return false;
  if (p.rows < 1 || p.rows > BM || p.rows * p.ks < BM) return false;
  if (p.tiles_n != cdiv(N, bn) || p.tiles_m != (colsum ? 1 : cdiv(M, BM))) return false;
  return static_cast<int64_t>(p.ctas) == static_cast<int64_t>(p.ks) * p.tiles_n * p.tiles_m;
}

// Launch i of the plan: its tile width, shared memory and grid, the grid
// being product p0's CTAs, then p1's (ks = 1) rounded up to whole clusters.
bool launch_ok(const GpPlan& p, int i, const GpProduct& p0, const GpProduct* p1) {
  const int bn = p.bn[i];
  if ((bn != 16 && bn != 32) || p.smem[i] != (bn == 16 ? smem_bytes(16) : smem_bytes(32)))
    return false;
  int64_t grid = p0.ctas;
  if (p1) {
    if (p1->ks != 1) return false;
    grid += static_cast<int64_t>(cdiv(p1->ctas, p0.ks)) * p0.ks;
  }
  return grid == p.grid[i] && grid <= 0x7fffffff;
}

Job make_job(const float* A, const float* B, float* C, int64_t M, int64_t N, int64_t K,
             int64_t lda, int64_t ldb, int64_t ldc, const GpProduct& p, int pre_a) {
  Job j = {};
  j.A = A;
  j.B = B;
  j.C = C;
  j.M = static_cast<int>(M);
  j.N = static_cast<int>(N);
  j.K = static_cast<int>(K);
  j.lda = static_cast<int>(lda);
  j.ldb = static_cast<int>(ldb);
  j.ldc = static_cast<int>(ldc);
  j.ks = p.ks;
  j.kc = p.kc;
  j.rows = p.rows;
  j.tiles_m = p.tiles_m;
  j.tiles_n = p.tiles_n;
  j.ctas = p.ctas;
  j.pre_a = pre_a;
  return j;
}

template <int BN, bool kVec, class O0, class O1>
int launch_one(const Job& j0, const Job& j1, int grid, int smem, bool pdl, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (j0.ks > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = static_cast<unsigned>(j0.ks);
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gp_gemm<BN, kVec, O0, O1>, j0, j1);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Launch i of plan p: the kernel for its tile width and copy width.
template <class O0, class O1>
int launch(const GpPlan& p, int i, bool vec, bool pdl, const Job& j0, const Job& j1,
           cudaStream_t s) {
  const int grid = p.grid[i], smem = p.smem[i];
  if (p.bn[i] == 32)
    return vec ? launch_one<32, true, O0, O1>(j0, j1, grid, smem, pdl, s)
               : launch_one<32, false, O0, O1>(j0, j1, grid, smem, pdl, s);
  return vec ? launch_one<16, true, O0, O1>(j0, j1, grid, smem, pdl, s)
             : launch_one<16, false, O0, O1>(j0, j1, grid, smem, pdl, s);
}

}  // namespace

// g (B, N0), m1 and t (B, N1), m2 and u (B, N2); t holds a1 until the third
// product overwrites it.
extern "C" int mlp_gp_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* w3, float* g, float* m1, float* m2,
                          float* u, float* t, const GpPlan* plan, void* stream) {
  const GpPlan& p = *plan;
  if (!shapes_ok(p)) return kInvalid;
  const int64_t b = p.b, n0 = p.n0, n1 = p.n1, n2 = p.n2;
  // (M, N, K, column sum) of each product.
  const int64_t dims[4][3] = {{b, n1, n0}, {b, n2, n1}, {b, n1, n2}, {b, n0, n1}};
  for (int i = 0; i < 4; ++i)
    if (!product_ok(p.prod[i], dims[i][0], dims[i][1], dims[i][2], p.bn[i], false) ||
        !launch_ok(p, i, p.prod[i], nullptr))
      return kInvalid;
  const bool vec = n0 % 4 == 0 && n1 % 4 == 0 && n2 % 4 == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(w2) && aligned16(u) && aligned16(t);
  const bool pdl = p.pdl != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Job none = {};
  // a1 = z1 * m1 (into t), z1 = x W1^T + b1
  Job j = make_job(x, w1, t, b, n1, n0, n0, n0, n1, p.prod[0], 0);
  j.bias = b1;
  j.out2 = m1;
  int rc = launch<Op<false, true, kBiasMask>, NoOp>(p, 0, vec, false, j, none, s);
  if (rc) return rc;
  // u = m2 * w3, z2 = a1 W2^T + b2
  j = make_job(t, w2, u, b, n2, n1, n1, n1, n2, p.prod[1], 0);
  j.bias = b2;
  j.vec = w3;
  j.out2 = m2;
  rc = launch<Op<false, true, kBiasMaskW3>, NoOp>(p, 1, vec, pdl, j, none, s);
  if (rc) return rc;
  // t = (u W2) * m1
  j = make_job(u, w2, t, b, n1, n2, n2, n1, n1, p.prod[2], 0);
  j.mask = m1;
  rc = launch<Op<false, false, kMulMask>, NoOp>(p, 2, vec, pdl, j, none, s);
  if (rc) return rc;
  // g = t W1
  j = make_job(t, w1, g, b, n0, n1, n1, n0, n0, p.prod[3], 0);
  return launch<Op<false, false, kStore>, NoOp>(p, 3, vec, pdl, j, none, s);
}

// dw1 (N1, N0), dw2 (N2, N1), dw3 (N2,); s (B, N1) is scratch.
extern "C" int mlp_gp_bwd(const float* q, const float* m1, const float* m2, const float* w1,
                          const float* w2, const float* u, const float* t, float* dw1, float* dw2,
                          float* dw3, float* s_buf, const GpPlan* plan, void* stream) {
  const GpPlan& p = *plan;
  if (!shapes_ok(p)) return kInvalid;
  const int64_t b = p.b, n0 = p.n0, n1 = p.n1, n2 = p.n2;
  if (!product_ok(p.prod[0], b, n1, n0, p.bn[0], false) ||
      !product_ok(p.prod[1], n1, n0, b, p.bn[0], false) || p.prod[1].ks != 1 ||
      !product_ok(p.prod[2], b, n2, n1, p.bn[1], true) ||
      !product_ok(p.prod[3], n2, n1, b, p.bn[1], false) || p.prod[3].ks != 1 ||
      !launch_ok(p, 0, p.prod[0], &p.prod[1]) || !launch_ok(p, 1, p.prod[2], &p.prod[3]))
    return kInvalid;
  const bool vec = n0 % 4 == 0 && n1 % 4 == 0 && n2 % 4 == 0 && aligned16(q) && aligned16(w1) &&
                   aligned16(w2) && aligned16(u) && aligned16(t) && aligned16(s_buf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // s = (q W1^T) * m1, beside dW1 = t^T q: (N1, N0), depth B
  Job js = make_job(q, w1, s_buf, b, n1, n0, n0, n0, n1, p.prod[0], 0);
  js.mask = m1;
  const Job jd1 = make_job(t, q, dw1, n1, n0, b, n1, n0, n0, p.prod[1], 0);
  int rc = launch<Op<false, true, kMulMask>, Op<true, false, kStore>>(p, 0, vec, false, js, jd1, s);
  if (rc) return rc;
  // dw3 = sum_b m2 * (s W2^T) (W2 first), beside dW2 = u^T s (u first)
  Job j3 = make_job(s_buf, w2, dw3, b, n2, n1, n1, n1, n2, p.prod[2], 0);
  j3.mask = m2;
  const Job jd2 = make_job(u, s_buf, dw2, n2, n1, b, n2, n1, n1, p.prod[3], 1);
  return launch<Op<false, true, kColSumMask>, Op<true, false, kStore>>(p, 1, vec, p.pdl != 0, j3,
                                                                       jd2, s);
}
