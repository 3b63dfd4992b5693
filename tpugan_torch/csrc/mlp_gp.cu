// Closed-form WGAN-GP for the template-A MLP critic (flat image -> N1 -> N2 ->
// 1, LeakyReLU 0.2, no sigmoid), forward and backward, in float32.
//
// Replaces the Pallas TPU kernels of tpugan/ops/pallas_critic.py:mlp_gp_pallas
// (_gp_fwd_kernel and _gp_bwd_kernel). With x the flattened interpolates
// (B, N0) and m(z) = z >= 0 ? 1 : 0.2:
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
// forward keeps u and t (B x N2 and B x N1) for the backward instead of
// recomputing them, which computes the same function. The gradients of b1, b2
// and x are exactly 0 and the penalty does not depend on b3, so they are not
// computed.
//
// One templated shared-memory tiled GEMM does all eight products: a 32 x 32
// output tile per block, plain FFMA (no tensor cores, so no TF32 rounding).
// A block is four groups of 64 threads; each thread holds a 4 x 4 register
// tile, and the groups split the depth: group g takes the depth-16 stages g,
// g + 4, g + 8, ..., each in ascending k, and the four partial tiles are then
// added in group order through shared memory. The epilogues are
// compile-time: bias + mask (writing the mask and z * m), bias + mask times
// w3, times a mask, store, and a column sum for dw3. The column sum is
// deterministic: one block owns a set of columns, walks all rows itself and
// adds its threads' partial sums in a fixed order, with no atomics. Every sum
// has a fixed order, so runs repeat bit for bit.
//
// Bound on this card: operations. At B = 64, N0 = 784, N1 = 512, N2 = 256 each
// direction is 2 B (2 N0 N1 + 2 N1 N2) = 136 MFLOP on about 3-5 MB of
// operands, so FP32 FFMA rate, not HBM, sets the floor. The products with
// M = B launch only 8 to 50 blocks, far from filling 132 SMs; the depth split
// puts 8 warps instead of 2 on each of those SMs to hide the latency of the
// unpipelined stage loads. wgmma, TMA and a persistent launch are later work.
//
// C interface for ctypes: each direction issues its 4 launches on the given
// stream, without synchronising, and returns the first non-zero
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;   // output rows per block
constexpr int BN = 32;   // output columns per block
constexpr int BK = 16;   // depth per shared-memory stage of one group
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int TY = BM / TM;  // 8 thread rows
constexpr int TX = BN / TN;  // 8 thread columns
constexpr int kGroup = TX * TY;            // 64 threads own one output tile
constexpr int kSplit = 4;                  // groups per block, splitting the depth
constexpr int kThreads = kGroup * kSplit;  // 256
constexpr float kSlope = 0.2f;             // LeakyReLU slope of the critic

enum Epi {
  kStore = 0,      // C = acc
  kBiasMask = 1,   // z = acc + bias[n]; out2 = m(z); C = z * m(z)
  kBiasMaskW3 = 2, // z = acc + bias[n]; out2 = m(z); C = m(z) * vec[n]
  kMulMask = 3,    // C = acc * mask[m, n]
  kColSumMask = 4  // C[n] = sum over all m of mask[m, n] * acc[m, n]
};

struct EpiArgs {
  const float* bias;  // (N,) for kBiasMask, kBiasMaskW3
  const float* vec;   // (N,) for kBiasMaskW3
  const float* mask;  // (M, N) row-major for kMulMask, kColSumMask
  float* out2;        // (M, N) row-major, the mask written by kBiasMask*
};

__device__ __forceinline__ float leaky_mask(float z) { return z >= 0.f ? 1.f : kSlope; }

// C (M x N, row stride ldc) = op(A) (M x K) * op(B) (K x N), then the
// epilogue. op(A) is A stored (M, K) with row stride lda, or, with TA, A stored
// (K, M). op(B) is B stored (K, N) with row stride ldb, or, with TB, B stored
// (N, K). Grid: x over column tiles, y over row tiles (y = 1 for the column
// sum, whose block walks every row tile).
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
            int M, int N, int K, int lda, int ldb, int ldc, EpiArgs ep) {
  __shared__ float As[kSplit][BK][BM + 1];
  __shared__ float Bs[kSplit][BK][BN + 1];
  __shared__ float part[kSplit - 1][BM][BN];  // groups 1.. hand their tiles to group 0
  __shared__ float red[TY][BN];

  const int grp = threadIdx.x / kGroup;
  const int lt = threadIdx.x % kGroup;
  const int tx = lt % TX;
  const int ty = lt / TX;
  const int n0 = blockIdx.x * BN;
  const int stages = (K + BK * kSplit - 1) / (BK * kSplit);  // the same for every group
  float col[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) col[j] = 0.f;

  // One pass for every kernel but the column sum, which walks all row tiles.
  const int m_step = EPI == kColSumMask ? BM : M;
  for (int m0 = (EPI == kColSumMask ? 0 : blockIdx.y * BM); m0 < M; m0 += m_step) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int st = 0; st < stages; ++st) {
      const int k0 = (st * kSplit + grp) * BK;
      // Stage this group's tiles, neighbouring threads on neighbouring
      // addresses of the operand's contiguous axis; out-of-range entries
      // (past K too) are 0 and add nothing.
      for (int i = lt; i < BM * BK; i += kGroup) {
        int r, c;
        if (TA) { r = i % BM; c = i / BM; } else { c = i % BK; r = i / BK; }
        const int gm = m0 + r, gk = k0 + c;
        float v = 0.f;
        if (gm < M && gk < K)
          v = TA ? A[static_cast<size_t>(gk) * lda + gm] : A[static_cast<size_t>(gm) * lda + gk];
        As[grp][c][r] = v;
      }
      for (int i = lt; i < BK * BN; i += kGroup) {
        int n, c;
        if (TB) { c = i % BK; n = i / BK; } else { n = i % BN; c = i / BN; }
        const int gn = n0 + n, gk = k0 + c;
        float v = 0.f;
        if (gn < N && gk < K)
          v = TB ? B[static_cast<size_t>(gn) * ldb + gk] : B[static_cast<size_t>(gk) * ldb + gn];
        Bs[grp][c][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[grp][k][ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[grp][k][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Add the groups' partial tiles in group order; group 0 does the
    // epilogue. Thread (tx, ty) holds rows m0 + ty + i*TY, columns
    // n0 + tx + j*TX.
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[grp - 1][ty + i * TY][tx + j * TX] = acc[i][j];
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int g = 0; g < kSplit - 1; ++g)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += part[g][ty + i * TY][tx + j * TX];

#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty + i * TY;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gn = n0 + tx + j * TX;
          if (gn >= N) continue;
          const size_t o = static_cast<size_t>(gm) * ldc + gn;
          const float v = acc[i][j];
          if (EPI == kStore) {
            C[o] = v;
          } else if (EPI == kBiasMask) {
            const float z = v + ep.bias[gn];
            const float m = leaky_mask(z);
            ep.out2[o] = m;
            C[o] = z * m;
          } else if (EPI == kBiasMaskW3) {
            const float z = v + ep.bias[gn];
            const float m = leaky_mask(z);
            ep.out2[o] = m;
            C[o] = m * ep.vec[gn];
          } else if (EPI == kMulMask) {
            C[o] = v * ep.mask[o];
          } else {  // kColSumMask: rows in ascending order within the thread
            col[j] = fmaf(ep.mask[static_cast<size_t>(gm) * N + gn], v, col[j]);
          }
        }
      }
    }
    // `part` is written again only after the next pass's first barrier.
  }

  if (EPI == kColSumMask) {
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < TN; ++j) red[ty][tx + j * TX] = col[j];
    }
    __syncthreads();
    if (grp == 0 && ty == 0) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tx + j * TX;
        float s = 0.f;
        for (int y = 0; y < TY; ++y) s += red[y][n];
        if (n0 + n < N) C[n0 + n] = s;
      }
    }
  }
}

template <bool TA, bool TB, int EPI>
int launch(const float* A, const float* B, float* C, int64_t M, int64_t N, int64_t K, int64_t lda,
           int64_t ldb, int64_t ldc, EpiArgs ep, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  EPI == kColSumMask ? 1u : static_cast<unsigned>((M + BM - 1) / BM));
  gemm_kernel<TA, TB, EPI><<<grid, kThreads, 0, s>>>(
      A, B, C, static_cast<int>(M), static_cast<int>(N), static_cast<int>(K),
      static_cast<int>(lda), static_cast<int>(ldb), static_cast<int>(ldc), ep);
  return static_cast<int>(cudaGetLastError());
}

// Every extent positive, every index and row tile inside int and the grid.
bool shapes_ok(int64_t b, int64_t n0, int64_t n1, int64_t n2) {
  const int64_t lim = 0x7fffffff;
  if (b <= 0 || n0 <= 0 || n1 <= 0 || n2 <= 0) return false;
  if (b > lim / n0 || b > lim / n1 || n1 > lim / n0 || n2 > lim / n1) return false;
  const int64_t max_rows = 65535LL * BM;  // gridDim.y
  return b <= max_rows && n1 <= max_rows && n2 <= max_rows;
}

}  // namespace

// g (B, N0), m1 and t (B, N1), m2 and u (B, N2); a1 (B, N1) is scratch.
extern "C" int mlp_gp_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* w3, float* g, float* m1, float* m2,
                          float* u, float* t, float* a1, int64_t b, int64_t n0, int64_t n1,
                          int64_t n2, void* stream) {
  if (!shapes_ok(b, n0, n1, n2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  // a1 = z1 * m1, z1 = x W1^T + b1
  rc = launch<false, true, kBiasMask>(x, w1, a1, b, n1, n0, n0, n0, n1,
                                      EpiArgs{b1, nullptr, nullptr, m1}, s);
  if (rc) return rc;
  // u = m2 * w3, z2 = a1 W2^T + b2
  rc = launch<false, true, kBiasMaskW3>(a1, w2, u, b, n2, n1, n1, n1, n2,
                                        EpiArgs{b2, w3, nullptr, m2}, s);
  if (rc) return rc;
  // t = (u W2) * m1
  rc = launch<false, false, kMulMask>(u, w2, t, b, n1, n2, n2, n1, n1,
                                      EpiArgs{nullptr, nullptr, m1, nullptr}, s);
  if (rc) return rc;
  // g = t W1
  return launch<false, false, kStore>(t, w1, g, b, n0, n1, n1, n0, n0, EpiArgs{}, s);
}

// dw1 (N1, N0), dw2 (N2, N1), dw3 (N2,); s (B, N1) is scratch.
extern "C" int mlp_gp_bwd(const float* q, const float* m1, const float* m2, const float* w1,
                          const float* w2, const float* u, const float* t, float* dw1, float* dw2,
                          float* dw3, float* s_buf, int64_t b, int64_t n0, int64_t n1, int64_t n2,
                          void* stream) {
  if (!shapes_ok(b, n0, n1, n2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  // s = (q W1^T) * m1
  rc = launch<false, true, kMulMask>(q, w1, s_buf, b, n1, n0, n0, n0, n1,
                                     EpiArgs{nullptr, nullptr, m1, nullptr}, s);
  if (rc) return rc;
  // dW1 = t^T q: (N1, N0), depth B
  rc = launch<true, false, kStore>(t, q, dw1, n1, n0, b, n1, n0, n0, EpiArgs{}, s);
  if (rc) return rc;
  // dW2 = u^T s: (N2, N1), depth B
  rc = launch<true, false, kStore>(u, s_buf, dw2, n2, n1, b, n2, n1, n1, EpiArgs{}, s);
  if (rc) return rc;
  // dw3 = sum_b m2 * (s W2^T)
  return launch<false, true, kColSumMask>(s_buf, w2, dw3, b, n2, n1, n1, n1, n2,
                                          EpiArgs{nullptr, nullptr, m2, nullptr}, s);
}
