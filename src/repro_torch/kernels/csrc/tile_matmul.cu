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
// accumulator, as the reference's kernel takes them, C rounded once. What
// bounds it: at the GCN's layer-1 shapes the bytes of A (about 128
// operations per byte of A, against the ~295 where the tensor cores' 989
// TFLOP/s overtake 3.35 TB/s): cora's 4096 x 1433 x 128 moves 13.1 MB, 3.9
// us. The design (wgmma_tile.cuh) keeps A's bytes streaming into every SM:
//
//   * A's copies are asynchronous at any K and any base alignment. Rows of
//     K = 1433 or 3703 elements (and pubmed's 1000-byte rows) start on any
//     2-byte boundary; each row's k window is copied with 16-byte cp.async
//     as the aligned span that covers it, and the fragments are built from
//     the span at the row's own shift.
//   * B, the same for every block, arrives by TMA: one request a 64-column
//     panel, where 16-byte cp.async from every thread of every block read
//     the same lines of L2 at once. (Multicast over a cluster of M tiles
//     was tried on the H100 and lost: each block's ring then waits for its
//     group's slowest block.)
//   * A card-filling grid: K is split across a thread-block cluster (up to
//     3 blocks on the z axis) at points that depend on K alone, so cora's
//     4096 rows in 64-row blocks make 64 x 2 = 128 blocks for 132 SMs. Rank
//     r of the cluster adds every rank's float32 partials of its r-th share
//     of the rows, read over distributed shared memory in rank order: no
//     atomics, no second launch.
//   * Hopper's tensor cores: wgmma.mma_async m64n128k16 (m64n8k16 for
//     narrow N), A from registers, B from shared memory; the next chunk's
//     copies are issued while the products run.
//
// Three block configurations, each any M, N and K: "wide" 128 x 128 (two
// warpgroups), "fill" 64 x 128 (one; the wrapper's pick for N > 16),
// "narrow" 64 x 8 (N <= 16). Every output element is the sum, in rank
// order, of one accumulator a split over the k16 steps in ascending k; the
// splits and the k16 grid depend on K alone, so every configuration gives
// the same bits.
#include <cooperative_groups.h>
#include <string.h>

#include "ffma_tile.cuh"
#include "wgmma_tile.cuh"

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

using WgWide = wgmma_tile::Tile<128, 128, 64, 4>;
using WgFill = wgmma_tile::Tile<64, 128, 64, 3>;
using WgNarrow = wgmma_tile::Tile<64, 8, 64, 4>;

constexpr int kWgSplitK = 576;     // target k of one split
constexpr int kWgSplitAlign = 64;  // split points on chunk boundaries
constexpr int kWgMaxSplits = 3;

// Elements of k per split of the bfloat16 instances: a function of K alone.
// K below 864 is not split; above, one split per ~576 k, at most 3 (on the
// H100, cora's K = 1433 ran fastest in 2 splits, citeseer's 3703 in 3).
int wg_split_k(int K) {
  int splits = (K + kWgSplitK / 2) / kWgSplitK;
  splits = splits < 1 ? 1 : (splits > kWgMaxSplits ? kWgMaxSplits : splits);
  const int per = (K + splits - 1) / splits;
  return (per + kWgSplitAlign - 1) / kWgSplitAlign * kWgSplitAlign;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// B [K, N] as a 2-D tensor map of boxes of 64 columns x box_rows rows,
// 128-byte swizzled (wgmma's N-major panels); out-of-range rows and
// columns read as zeros.
int encode_b(CUtensorMap* map, const void* b, int N, int K, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(b), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// TMA: B's chunks arrive by tensor-map copies (B's rows 16-byte aligned,
// BN = 128); else B's rows go through the staging spans. c_vec16 /
// c_vec8: C's rows take 16-byte / 8-byte stores.
template <class C, bool TMA>
__global__ void __launch_bounds__(C::THREADS, 1)
wgmma_matmul_kernel(const __grid_constant__ CUtensorMap b_map,
                    const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ c, int M, int N, int K,
                    int k_split, bool c_vec16, bool c_vec8) {
  namespace wt = wgmma_tile;
  constexpr bool STAGED = !TMA;
  constexpr int SLOT = C::slot_bytes(STAGED);
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(wg_smem) + 1023) & ~1023ull);
  // full[s] at bars + 8 s: B's chunk in slot s has landed
  const unsigned bars = wt::smem_u32(smem + S * SLOT);
  cg::cluster_group cluster = cg::this_cluster();
  const int m0 = blockIdx.x * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int rows = max(0, min(C::BM, M - m0));
  const int cols = min(C::BN, N - n0);
  const int kb = blockIdx.z * k_split;          // this block's k range
  const int ke = min(K, kb + k_split);
  const int nq = ke > kb ? (ke - kb + C::BK - 1) / C::BK : 0;
  const __nv_bfloat16* a0 = a + static_cast<long long>(m0) * K;
  const __nv_bfloat16* b0 = b + n0;
  const wt::Frag<C> frag(a0, K);
  float acc[C::NACC];
#pragma unroll
  for (int i = 0; i < C::NACC; ++i) acc[i] = 0.f;

  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) wt::mbar_init(bars + 8 * s, 1);
      wt::fence_mbar_init();
    }
    __syncthreads();
  }

  auto load = [&](int p) {
    unsigned char* slot = smem + p % S * SLOT;
    const int k0 = kb + p * C::BK, k1 = min(ke, k0 + C::BK);
    wt::copy_a<C>(slot + C::B_BYTES, a0, K, rows, k0, k1);
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        // two 64-column panels of BK rows
        const unsigned full = bars + 8 * (p % S);
        wt::mbar_expect_tx(full, C::B_BYTES);
        wt::tma_load(wt::smem_u32(slot), &b_map, full, n0, k0);
        wt::tma_load(wt::smem_u32(slot) + C::BK * 128, &b_map, full,
                     n0 + 64, k0);
      }
    } else {
      wt::copy_b_spans<C>(slot + C::B_BYTES + C::A_BYTES, b0, N, cols, k0,
                          k1);
    }
  };
  // The ring: chunk q + S - 1 is issued while chunk q is multiplied; its
  // slot is the one chunk q - 1 used, which every warpgroup's products
  // have left by the barrier.
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nq) load(s);
    wt::cp_async_commit();
  }
  for (int q = 0; q < nq; ++q) {
    unsigned char* slot = smem + q % S * SLOT;
    const int k0 = kb + q * C::BK;
    wt::cp_async_wait<S - 2>();
    if constexpr (TMA) {
      wt::mbar_wait(bars + 8 * (q % S), (q / S) & 1);
    } else {
      __syncthreads();
      wt::realign_b<C>(slot, slot + C::B_BYTES + C::A_BYTES, b0, N, k0);
      wt::fence_proxy_async();   // the realigned B, stored by threads
    }
    __syncthreads();
    // the products of chunk q run on the tensor cores while this thread
    // issues chunk q + S - 1's copies
    wt::mma_stage<C, TMA>(acc, slot + C::B_BYTES, slot, frag,
                          min(C::BK, ke - k0));
    if (q + S - 1 < nq) load(q + S - 1);
    wt::cp_async_commit();
    wt::wgmma_wait();
  }
  wt::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue's tile goes there

  __nv_bfloat16* o = c + static_cast<long long>(m0) * N + n0;
  if (gridDim.z == 1) {
    wt::store_tile<C>(acc, smem, o, N, rows, cols, c_vec16);
  } else {
    wt::reduce_tile<C, kWgMaxSplits>(
        acc, smem, o, N, rows, cols, c_vec8, static_cast<int>(blockIdx.z),
        static_cast<int>(gridDim.z), cluster);
  }
}

template <class C, bool TMA>
int launch_wgmma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                 __nv_bfloat16* c, int M, int N, int K,
                 cudaStream_t stream) {
  static bool smem_allowed[64] = {};
  constexpr int smem = C::smem_bytes(!TMA);
  int err = ffma_tile::allow_smem(wgmma_matmul_kernel<C, TMA>, smem,
                                  smem_allowed);
  if (err) return err;
  const int k_split = K > 0 ? wg_split_k(K) : 1;
  const int splits = K > 0 ? (K + k_split - 1) / k_split : 1;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (TMA) {
    err = encode_b(&map, b, N, K, C::BK);
    if (err) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN,
                     splits);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool c_vec16 = N % 8 == 0 && wgmma_tile::aligned(c, 16);
  const bool c_vec8 = N % 4 == 0 && wgmma_tile::aligned(c, 8);
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, wgmma_matmul_kernel<C, TMA>, map, a, b, c, M, N, K, k_split,
      c_vec16, c_vec8));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_wgmma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                 __nv_bfloat16* c, int M, int N, int K,
                 cudaStream_t stream) {
  if constexpr (C::BN == 128) {
    if (N % 8 == 0 && N >= 64 && K >= C::BK && wgmma_tile::aligned(b, 16))
      return launch_wgmma<C, true>(a, b, c, M, N, K, stream);
  }
  return launch_wgmma<C, false>(a, b, c, M, N, K, stream);
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

// a [M,K], b [K,N] -> c [M,N], all bfloat16 and contiguous at any
// alignment (float32 accumulator). config: 0 wide, 1 fill, 2 narrow;
// cudaErrorInvalidValue else.
int tile_matmul_bf16(const void* a, const void* b, void* c, int M, int N,
                     int K, int config, void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  auto* pc = static_cast<__nv_bfloat16*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch_wgmma<WgWide>(pa, pb, pc, M, N, K, s);
    case 1: return launch_wgmma<WgFill>(pa, pb, pc, M, N, K, s);
    case 2: return launch_wgmma<WgNarrow>(pa, pb, pc, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
