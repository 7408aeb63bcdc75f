// Fixed-K ELL SpMM: one bucket of the sparse engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ell_kernel` / `ell_spmm`
// (src/repro/kernels/ell_spmm.py), which the "fused" and "loop" ELL
// dispatches launch once per distinct K. For every group member g and
// unit u of one bucket:
//
//   out[g,u,r,:] = sum_{kk < K} vals[g,u,r,kk] * B[g, tile_col[g,u], cols[g,u,r,kk], :]
//
// in float32. The member axis G is a grid dimension, so a group costs one
// launch per bucket.
//
// What bounds it on the H100: bytes, as for the ragged kernel: R*K
// multiply-adds per feature on R*K gathered B rows is about a quarter of
// an operation per byte moved, far below the ~20 FLOP/byte where float32
// FMA (67 TFLOP/s) would overtake device memory (3.35 TB/s).
//
// Design. The ragged kernel's (csrc/ragged_ell_spmm.cu): one block per
// (unit, 64-wide feature block, member), each block reading its own
// tile_col, the unit's [R, K] cols/vals and the [T, 64] slab of its B tile
// staged in shared memory. K is the loop bound, not a mask: lanes past K
// are never read. A bucket is a view of the ragged [U, R, Kmax] slab, so
// cols/vals arrive with the slab's strides (unit, row and member strides
// in elements, the K axis contiguous) and are read in place: no per-
// dispatch copy makes them contiguous. The output may be a unit slice of
// a larger [G, U_all, R, F] buffer (member stride out_sg), so the buckets
// of one dispatch write straight into the concatenated product.
// Multiply and add are rounded separately (__fmul_rn / __fadd_rn) in
// ascending kk from +0, so on finite B the result equals the ragged
// kernel's bit for bit: past unit_k the ragged kernel only adds +-0 to an
// accumulator that started at +0 and so is never -0.
#include <cuda_runtime.h>

namespace {

constexpr int kBF = 64;        // feature columns per block
constexpr int kThreads = 256;  // 4 rows x 64 features per pass

__global__ void __launch_bounds__(kThreads)
ell_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
           const int* __restrict__ tile_col, const float* __restrict__ b,
           float* __restrict__ out, int R, int K, int nct, int T, int F,
           long long s_g, long long s_u, long long s_r, long long tc_sg,
           long long out_sg) {
  extern __shared__ float smem[];
  float* bs = smem;                                // [T][kBF]
  float* vs = bs + T * kBF;                        // [R][K]
  int* cs = reinterpret_cast<int*>(vs + R * K);    // [R][K]

  const int u = blockIdx.x;
  const int f0 = blockIdx.y * kBF;
  const long long g = blockIdx.z;
  const long long base = g * s_g + u * s_u;
  const int tc = tile_col[g * tc_sg + u];
  const int rk = R * K;

  for (int i = threadIdx.x; i < rk; i += blockDim.x) {
    const long long at = base + (i / K) * s_r + i % K;
    cs[i] = cols[at];
    vs[i] = vals[at];
  }
  const float* bt = b + (g * nct + tc) * T * F;
  for (int i = threadIdx.x; i < T * kBF; i += blockDim.x) {
    const int row = i / kBF;
    const int c = f0 + i % kBF;
    bs[i] = c < F ? bt[static_cast<long long>(row) * F + c] : 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x % kBF;
  float* o = out + g * out_sg + static_cast<long long>(u) * R * F;
  for (int r = threadIdx.x / kBF; r < R; r += blockDim.x / kBF) {
    float acc = 0.f;
    for (int kk = 0; kk < K; ++kk)
      acc = __fadd_rn(acc, __fmul_rn(vs[r * K + kk],
                                     bs[cs[r * K + kk] * kBF + c]));
    if (f0 + c < F) o[static_cast<long long>(r) * F + f0 + c] = acc;
  }
}

}  // namespace

extern "C" {

// cols/vals [G,U,R,K] with element strides (s_g, s_u, s_r, 1), tile_col
// [G,U] with strides (tc_sg, 1), b [G,nct,T,F] contiguous -> out
// [G,U,R,F] with strides (out_sg, R*F, F, 1); cols[...] < T and
// tile_col[...] < nct.
int ell_spmm_f32(const void* cols, const void* vals, const void* tile_col,
                 const void* b, void* out, int G, int U, int R, int K,
                 int nct, int T, int F, long long s_g, long long s_u,
                 long long s_r, long long tc_sg, long long out_sg,
                 void* stream) {
  const size_t smem = (static_cast<size_t>(T) * kBF + 2 * R * K) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(U, (F + kBF - 1) / kBF, G);
  ell_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const int*>(tile_col), static_cast<const float*>(b),
      static_cast<float*>(out), R, K, nct, T, F, s_g, s_u, s_r, tc_sg,
      out_sg);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
