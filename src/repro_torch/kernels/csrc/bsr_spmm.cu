// BSR SpMM: the dense-tile engine of the tri-partition, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bsr_kernel` / `bsr_spmm`
// (src/repro/kernels/bsr_spmm.py). For every group member g and tile t:
//
//   out[g,t] = tiles[g,t] (T x T) @ B[g, tile_col[g,t]] (T x F)
//
// in float32 with float32 accumulation; the caller sums the products over
// tile_row. One launch covers every tile of every member of a group.
//
// What bounds it on the H100: bytes, at the main path's shapes. A 64x64
// tile against a 64-wide feature slab does 2*64 FLOP per byte of the tile
// it reads, but the output (as large as the B slab) is written back and
// the tile count is small, so moving tiles, B tiles and products
// (~4.5 MB for cora at F=128) outweighs the float32 FMA work at 67
// TFLOP/s. Tensor cores are off the table in this version: the port holds
// float32 parity with the reference, and TF32 keeps about three digits.
//
// Design. One block per (64-row block of a tile, 64-wide feature block,
// member); the block reads its own tile_col. It walks the tile's k axis
// in chunks of 32: each chunk of the tile (stored transposed, padded
// against bank conflicts) and of the B slab is staged in shared memory
// with coalesced loads, and each of the 256 threads accumulates a 4x4
// micro-tile with FFMA in ascending k, so the k order is fixed and the
// result repeats bit for bit. Rows, k and features past T or F are
// masked (loaded as 0, never stored), so F=7 or F=3 work. A later version
// can use wgmma and TMA once a lower-precision mode is allowed.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output features per block
constexpr int kBK = 32;        // k chunk staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
bsr_kernel(const float* __restrict__ tiles, const int* __restrict__ tile_col,
           const float* __restrict__ b, float* __restrict__ out, int n_t,
           int nct, int T, int F) {
  __shared__ float as[kBK][kBM + 1];  // tile chunk, transposed: as[k][m]
  __shared__ float bs[kBK][kBN];      // B chunk: bs[k][f]

  const int m_blocks = (T + kBM - 1) / kBM;
  const int t = blockIdx.x / m_blocks;
  const int m0 = (blockIdx.x % m_blocks) * kBM;
  const int f0 = blockIdx.y * kBN;
  const long long gt = static_cast<long long>(blockIdx.z) * n_t + t;
  const float* a = tiles + gt * T * T;
  const float* bt =
      b + (static_cast<long long>(blockIdx.z) * nct + tile_col[gt]) * T * F;

  const int tx = threadIdx.x % 16;  // feature lane: f0 + tx + 16 * j
  const int ty = threadIdx.x / 16;  // row lane:     m0 + ty + 16 * i
  float acc[4][4] = {};

  for (int k0 = 0; k0 < T; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;  // consecutive threads along k
      as[k][m] = (m0 + m < T && k0 + k < T)
                     ? a[static_cast<long long>(m0 + m) * T + k0 + k]
                     : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, f = i % kBN;  // consecutive threads along f
      bs[k][f] = (k0 + k < T && f0 + f < F)
                     ? bt[static_cast<long long>(k0 + k) * F + f0 + f]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + gt * T * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f < F) o[static_cast<long long>(m) * F + f] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// tiles [G,n_t,T,T], tile_col [G,n_t], b [G,nct,T,F] -> out [G,n_t,T,F];
// all contiguous, tile_col[...] < nct.
int bsr_spmm_f32(const void* tiles, const void* tile_col, const void* b,
                 void* out, int G, int n_t, int nct, int T, int F,
                 void* stream) {
  const dim3 grid(n_t * ((T + kBM - 1) / kBM), (F + kBN - 1) / kBN, G);
  bsr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tiles), static_cast<const int*>(tile_col),
      static_cast<const float*>(b), static_cast<float*>(out), n_t, nct, T, F);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
