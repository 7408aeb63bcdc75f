// Dense tiled matmul C = A @ B, the dense systolic array, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_matmul_kernel` / `tile_matmul`
// (src/repro/kernels/tile_matmul.py): C[M,N] = A[M,K] @ B[K,N] in float32
// with a float32 accumulator, for any M, K and N.
//
// What bounds it on the H100: at the GCN's X.W shapes (M in the
// thousands, K = 128..3703, N = 3..128) a float32 product does up to 2N
// FLOP per byte of A it reads; for N = 128 that is far above the ~20
// FLOP/byte where float32 FMA (67 TFLOP/s) overtakes device memory, so
// the wide products are bound by operations and the narrow ones (N <= 7)
// by the bytes of A.
//
// Design. One block of 256 threads per kBM x BN output tile (kBM = 64, BN
// in {16, 64}, chosen by the wrapper). The block walks K in
// chunks of kBK = 32: each chunk of A (stored transposed, padded against
// bank conflicts) and of B is staged in shared memory with coalesced
// loads, and each thread accumulates a (kBM/16) x (BN/16) micro-tile in
// registers with FFMA. Every output element is one FMA chain in
// ascending k, whatever the block width, so the result is the same bit
// for bit for both widths and repeats from run to run. Rows,
// columns and k past M, N or K are masked (loaded as 0, never stored),
// which computes what the reference's zero padding computes. No tensor
// cores: the port holds float32 parity with the reference, and TF32
// keeps about three decimal digits.
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;        // k chunk staged per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBM = 64;        // output rows per block

template <int BN>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int M, int N, int K) {
  constexpr int TM = kBM / 16;
  constexpr int TN = BN / 16;
  __shared__ float as[kBK][kBM + 1];  // A chunk, transposed: as[k][m]
  __shared__ float bs[kBK][BN];      // B chunk: bs[k][n]

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;  // column lane: n0 + tx + 16 * j
  const int ty = threadIdx.x / 16;  // row lane:    m0 + ty + 16 * i
  float acc[TM][TN] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;  // consecutive threads along k
      as[k][m] = (m0 + m < M && k0 + k < K)
                     ? a[static_cast<long long>(m0 + m) * K + k0 + k]
                     : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * BN; i += kThreads) {
      const int k = i / BN, n = i % BN;  // consecutive threads along n
      bs[k][n] = (k0 + k < K && n0 + n < N)
                     ? b[static_cast<long long>(k0 + k) * N + n0 + n]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) c[static_cast<long long>(m) * N + n] = acc[i][j];
    }
  }
}

template <int BN>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  matmul_kernel<BN><<<grid, kThreads, 0, stream>>>(a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a [M,K], b [K,N] -> c [M,N], all float32 and contiguous; the block
// width bn is 64 or 16. Returns cudaErrorInvalidValue for another width.
int tile_matmul_f32(const void* a, const void* b, void* c, int M, int N,
                    int K, int bn, void* stream) {
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* pc = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch<64>(pa, pb, pc, M, N, K, s);
  if (bn == 16) return launch<16>(pa, pb, pc, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
