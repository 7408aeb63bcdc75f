// Dense tiled matmul C = A @ B, the dense systolic array, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_matmul_kernel` / `tile_matmul`
// (src/repro/kernels/tile_matmul.py): C[M,N] = A[M,K] @ B[K,N] in float32
// with a float32 accumulator, for any M, K and N.
//
// What bounds it on the H100: at the GCN's X.W shapes a float32 product
// does up to 2N FLOP per byte of A it reads. Layer 1 (M = 4096..32768,
// K = 500..3703, N = 128) is far above the ~20 FLOP/byte where float32
// FMA (67 TFLOP/s) overtakes device memory (3.35 TB/s): bound by
// operations. Layer 2 (K = 128, N = 3..7) is bound by the bytes of A.
//
// Design: the FFMA mainloop of ffma_tile.cuh (a cp.async ring of k
// chunks, register micro-tiles fed by 16-byte shared-memory reads) in
// three block configurations:
//
//   wide    64 x 128 block, 128 threads of 8 x 8: the most reuse per
//           shared-memory read, for M large enough to fill the card;
//   fill    32 x 128 block, 128 threads of 8 x 4: twice the blocks, so
//           that M = 4096, N = 128 gives 128 blocks for 132 SMs (a 64-row
//           block would leave half of them idle);
//   narrow  64 x 8 block, 128 threads each owning one row and 4 columns,
//           for N <= 16: A streams through once in coalesced copies and
//           no lane computes the 64-wide zero columns of a wide block.
//
// Long K is split across a thread-block cluster (split-K, up to 4 blocks
// on the z axis): each block of the cluster runs the mainloop over its own
// k range, and rank 0 adds the others' partial sums, read from their
// shared memory, in rank order. No atomics, no second launch. The split
// points depend on K alone (split_k), so every configuration gives the
// same bits: each output element is the sum, in rank order, of one FMA
// chain in ascending k per split.
//
// A is read in place: rows of K = 1433 or 3703 floats are not 16-byte
// aligned, so they are copied 4 bytes at a time (16 when K % 4 == 0);
// B rows of N = 3..7 floats likewise. Rows, columns and k past M, N or K
// are zero-filled by the copies and never stored. No tensor cores on
// float32: the port holds float32 parity with the reference, and TF32
// keeps about three decimal digits.
//
// bfloat16 (tile_matmul_bf16): A, B and C in bfloat16 with a float32
// accumulator, as the reference's kernel takes them, on the tensor cores
// (the m16n8k16 mainloop of mma_tile.cuh), C rounded once in the epilogue.
// K is zero-padded to a multiple of 16 by the copies, and edges are
// masked. Three block configurations of four warps, as above: "wide"
// 64 x 128 (warps of 32 x 64), "fill" 32 x 128 (16 x 64) and "narrow"
// 64 x 8 (16 x 8). No split-K: every output element is one accumulator over
// the k16 steps in ascending k, so every configuration gives the same
// bits (mma_tile.cuh). At the GCN's layer-1 shapes the bfloat16 product is
// bound by the bytes of A (about 128 operations per byte of A against the
// ~295 where the tensor cores' 989 TFLOP/s overtake 3.35 TB/s).
#include <cooperative_groups.h>

#include "ffma_tile.cuh"
#include "mma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

using Wide = ffma_tile::Tile<64, 128, 16, 8, 8, 4>;
using Fill = ffma_tile::Tile<32, 128, 32, 8, 4, 3>;
using Narrow = ffma_tile::Tile<64, 8, 32, 1, 4, 4>;

constexpr int kSplitAlign = 32;  // split points are multiples of 32
constexpr int kMaxSplits = 4;

// Elements of k per split: a function of K alone, so that every block
// configuration splits at the same points (and gives the same bits). K
// below 1152 is not split; above, one split per ~768 k, at most four.
int split_k(int K) {
  int splits = (K + 384) / 768;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  const int per = (K + splits - 1) / splits;
  return (per + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
}

// A16/B16: rows of A/B are copied 16 bytes at a time (else 4).
template <class C, bool A16, bool B16>
__global__ void __launch_bounds__(C::THREADS)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int M, int N, int K, int k_split,
              bool c16) {
  static_assert(C::STAGES * C::STAGE_FLOATS >= C::BM * C::BN,
                "the ring holds a block's partial sums");
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int tx = threadIdx.x % C::TCOLS;
  const int ty = threadIdx.x / C::TCOLS;
  const int rows = min(C::BM, M - m0);
  const int cols = min(C::BN, N - n0);
  const int kb = blockIdx.z * k_split;          // this block's k range
  const int ke = min(K, kb + k_split);
  const float* a0 = a + static_cast<long long>(m0) * K;
  const ffma_tile::Copier<C::BM, C::BK, C::ALD, C::THREADS, A16> copy_a(K);
  const ffma_tile::Copier<C::BK, C::BN, C::BLD, C::THREADS, B16> copy_b(N);
  float acc[C::TM][C::TN] = {};

  ffma_tile::pipeline<C>(
      smem, (ke - kb + C::BK - 1) / C::BK,
      [&](int q, float* as, float* bs) {
        const int k0 = kb + q * C::BK;
        copy_a.copy(as, a0 + k0, rows, ke - k0);
        copy_b.copy(bs, b + static_cast<long long>(k0) * N + n0, ke - k0,
                    cols);
      },
      [&](int q, const float* as, const float* bs) {
        ffma_tile::fma_chunk<C>(acc, as, bs, ty, tx,
                                min(C::BK, ke - kb - q * C::BK));
      });

  if (gridDim.z > 1) {
    // Split-K: the blocks of one cluster hold the partial sums of one
    // output block over consecutive k ranges. Rank 0 adds the others'
    // partials, read from their shared memory, in rank order.
    cg::cluster_group cluster = cg::this_cluster();
    float* part = smem;  // the ring, free once every thread is done
    __syncthreads();
    if (blockIdx.z > 0) {
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          part[(i * C::TN + j) * C::THREADS + threadIdx.x] = acc[i][j];
    }
    cluster.sync();
    if (blockIdx.z == 0) {
      for (int r = 1; r < static_cast<int>(gridDim.z); ++r) {
        const float* rp = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < C::TM; ++i)
#pragma unroll
          for (int j = 0; j < C::TN; ++j)
            acc[i][j] += rp[(i * C::TN + j) * C::THREADS + threadIdx.x];
      }
      ffma_tile::store<C>(acc, c + static_cast<long long>(m0) * N + n0, N,
                          rows, cols, ty, tx, c16);
    }
    cluster.sync();  // keep every partial readable until rank 0 is done
  } else {
    ffma_tile::store<C>(acc, c + static_cast<long long>(m0) * N + n0, N,
                        rows, cols, ty, tx, c16);
  }
}

template <class C, bool A16, bool B16>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           cudaStream_t stream) {
  static bool smem_allowed[64] = {};
  int err = ffma_tile::allow_smem(matmul_kernel<C, A16, B16>, C::SMEM_BYTES,
                                  smem_allowed);
  if (err) return err;
  const int k_split = K > 0 ? split_k(K) : 1;
  const int splits = K > 0 ? (K + k_split - 1) / k_split : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN,
                     splits);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool c16 = N % 4 == 0 && ffma_tile::aligned16(c);
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, matmul_kernel<C, A16, B16>, a, b, c, M, N, K, k_split, c16));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           cudaStream_t stream) {
  const bool a16 = K % 4 == 0 && ffma_tile::aligned16(a);
  const bool b16 = N % 4 == 0 && ffma_tile::aligned16(b);
  if (a16 && b16) return launch<C, true, true>(a, b, c, M, N, K, stream);
  if (a16) return launch<C, true, false>(a, b, c, M, N, K, stream);
  if (b16) return launch<C, false, true>(a, b, c, M, N, K, stream);
  return launch<C, false, false>(a, b, c, M, N, K, stream);
}

using MmaWide = mma_tile::Tile<64, 128, 32, 32, 64, 3>;
using MmaFill = mma_tile::Tile<32, 128, 32, 16, 64, 3>;
using MmaNarrow = mma_tile::Tile<64, 8, 32, 16, 8, 3>;

// A16/B16: rows of A/B are copied 16 bytes at a time (else one element).
template <class C, bool A16, bool B16>
__global__ void __launch_bounds__(C::THREADS)
mma_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ b,
                  __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  using mma_tile::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int wm = mma_tile::warp_m<C>(), wn = mma_tile::warp_n<C>();
  const int rows = min(C::BM, M - m0);
  const int cols = min(C::BN, N - n0);
  const bf16* a0 = a + static_cast<long long>(m0) * K;
  const mma_tile::Copier<C::BM, C::BK, C::ALD, C::THREADS, A16> copy_a(K);
  const mma_tile::Copier<C::BK, C::BN, C::BLD, C::THREADS, B16> copy_b(N);
  mma_tile::Acc<C> acc = {};

  mma_tile::pipeline<C>(
      smem, (K + C::BK - 1) / C::BK,
      [&](int q, bf16* as, bf16* bs) {
        const int k0 = q * C::BK;
        copy_a.copy(as, a0 + k0, rows, K - k0);
        copy_b.copy(bs, b + static_cast<long long>(k0) * N + n0, K - k0,
                    cols);
      },
      [&](int q, const bf16* as, const bf16* bs) {
        mma_tile::mma_chunk<C>(acc, as, bs, wm, wn,
                               min(C::BK, K - q * C::BK));
      });
  bf16* o = c + static_cast<long long>(m0) * N + n0;
  mma_tile::for_each<C>(acc, wm, wn, rows, cols, [&](int r, int n, float v) {
    o[static_cast<long long>(r) * N + n] = __float2bfloat16_rn(v);
  });
}

template <class C, bool A16, bool B16>
int launch_mma(const __nv_bfloat16* a, const __nv_bfloat16* b,
               __nv_bfloat16* c, int M, int N, int K, cudaStream_t stream) {
  static bool smem_allowed[64] = {};
  const int err = ffma_tile::allow_smem(mma_matmul_kernel<C, A16, B16>,
                                        C::SMEM_BYTES, smem_allowed);
  if (err) return err;
  const dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN);
  mma_matmul_kernel<C, A16, B16><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_mma(const __nv_bfloat16* a, const __nv_bfloat16* b,
               __nv_bfloat16* c, int M, int N, int K, cudaStream_t stream) {
  const bool a16 = K % 8 == 0 && mma_tile::aligned16(a);
  const bool b16 = N % 8 == 0 && mma_tile::aligned16(b);
  if (a16 && b16) return launch_mma<C, true, true>(a, b, c, M, N, K, stream);
  if (a16) return launch_mma<C, true, false>(a, b, c, M, N, K, stream);
  if (b16) return launch_mma<C, false, true>(a, b, c, M, N, K, stream);
  return launch_mma<C, false, false>(a, b, c, M, N, K, stream);
}

}  // namespace

extern "C" {

// a [M,K], b [K,N] -> c [M,N], all float32 and contiguous. config: 0 wide,
// 1 fill, 2 narrow (any M, N, K for each); cudaErrorInvalidValue else.
int tile_matmul_f32(const void* a, const void* b, void* c, int M, int N,
                    int K, int config, void* stream) {
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* pc = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch<Wide>(pa, pb, pc, M, N, K, s);
    case 1: return launch<Fill>(pa, pb, pc, M, N, K, s);
    case 2: return launch<Narrow>(pa, pb, pc, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a [M,K], b [K,N] -> c [M,N], all bfloat16 and contiguous (float32
// accumulator). config: 0 wide, 1 fill, 2 narrow; cudaErrorInvalidValue
// else.
int tile_matmul_bf16(const void* a, const void* b, void* c, int M, int N,
                     int K, int config, void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  auto* pc = static_cast<__nv_bfloat16*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch_mma<MmaWide>(pa, pb, pc, M, N, K, s);
    case 1: return launch_mma<MmaFill>(pa, pb, pc, M, N, K, s);
    case 2: return launch_mma<MmaNarrow>(pa, pb, pc, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
