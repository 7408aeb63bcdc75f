// Ragged ELL SpMM: the sparse engine of the tri-partition, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ragged_ell_kernel` / `ragged_ell_spmm`
// (src/repro/kernels/ell_spmm.py). For every group member g and unit u:
//
//   out[g,u,r,:] = sum_{kk < Kmax} (kk < unit_k[g,u] ? vals[g,u,r,kk] : 0)
//                  * B[g, tile_col[g,u], cols[g,u,r,kk], :]
//
// One launch covers every K width and every member of a group.
//
// What bounds it on the H100: bytes. A unit does R*Kmax multiply-adds per
// feature on R*Kmax gathered B rows, about a quarter of an operation per
// byte moved, far below the ~20 FLOP/byte where float32 FMA (67 TFLOP/s)
// would overtake device memory (3.35 TB/s).
//
// Design. One block per (unit, 64-wide feature block, member); the block
// reads its own tile_col and unit_k (the TPU's scalar prefetch has no
// counterpart). It stages the unit's [R, Kmax] cols/vals and the [T, 64]
// slab of its B tile in shared memory with coalesced loads, then each
// thread runs the chain of its (row, feature) outputs in ascending kk with
// the mask on the values, looping to Kmax as the plain version does (a
// masked lane still multiplies 0 by its B row, so a non-finite B row
// propagates exactly as in the reference). Multiply and add are rounded
// separately (__fmul_rn / __fadd_rn, no contraction into FMA), so the
// kernel is bit-identical to the plain PyTorch version. A unit with
// unit_k == 0 writes 0 * B, i.e. zeros for finite B. Staging the whole
// slab reads up to T rows where a unit needs at most R*Kmax; the slab is
// shared by the unit's R rows and the neighbouring units of the same tile
// column stay in L2, and a later version can gather only the needed rows.
#include <cuda_runtime.h>

namespace {

constexpr int kBF = 64;        // feature columns per block
constexpr int kThreads = 256;  // 4 rows x 64 features per pass

__global__ void __launch_bounds__(kThreads)
ragged_ell_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                  const int* __restrict__ tile_col,
                  const int* __restrict__ unit_k,
                  const float* __restrict__ b, float* __restrict__ out,
                  int U, int R, int Kmax, int nct, int T, int F) {
  extern __shared__ float smem[];
  float* bs = smem;                                  // [T][kBF]
  float* vs = bs + T * kBF;                          // [R][Kmax]
  int* cs = reinterpret_cast<int*>(vs + R * Kmax);   // [R][Kmax]

  const int u = blockIdx.x;
  const int f0 = blockIdx.y * kBF;
  const long long unit = static_cast<long long>(blockIdx.z) * U + u;
  const int tc = tile_col[unit];
  const int ku = unit_k[unit];
  const int rk = R * Kmax;

  for (int i = threadIdx.x; i < rk; i += blockDim.x) {
    cs[i] = cols[unit * rk + i];
    vs[i] = vals[unit * rk + i];
  }
  const float* bt =
      b + (static_cast<long long>(blockIdx.z) * nct + tc) * T * F;
  for (int i = threadIdx.x; i < T * kBF; i += blockDim.x) {
    const int row = i / kBF;
    const int c = f0 + i % kBF;
    bs[i] = c < F ? bt[static_cast<long long>(row) * F + c] : 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x % kBF;
  for (int r = threadIdx.x / kBF; r < R; r += blockDim.x / kBF) {
    float acc = 0.f;
    for (int kk = 0; kk < Kmax; ++kk) {
      const float v = kk < ku ? vs[r * Kmax + kk] : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(v, bs[cs[r * Kmax + kk] * kBF + c]));
    }
    if (f0 + c < F) out[(unit * R + r) * F + f0 + c] = acc;
  }
}

}  // namespace

extern "C" {

// cols/vals [G,U,R,Kmax], tile_col/unit_k [G,U], b [G,nct,T,F] ->
// out [G,U,R,F]; all contiguous, cols[...] < T and tile_col[...] < nct.
int ragged_ell_spmm_f32(const void* cols, const void* vals,
                        const void* tile_col, const void* unit_k,
                        const void* b, void* out, int G, int U, int R,
                        int Kmax, int nct, int T, int F, void* stream) {
  const size_t smem = (static_cast<size_t>(T) * kBF + 2 * R * Kmax) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ragged_ell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(U, (F + kBF - 1) / kBF, G);
  ragged_ell_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const int*>(tile_col), static_cast<const int*>(unit_k),
      static_cast<const float*>(b), static_cast<float*>(out), U, R, Kmax,
      nct, T, F);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
