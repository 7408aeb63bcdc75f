// The float32 FFMA tile mainloop shared by tile_matmul.cu and bsr_spmm.cu.
//
// Both kernels form C[BM x BN] += A[BM x K] @ B[K x BN] per block in strict
// IEEE float32 (FFMA only: no tensor cores, no TF32). This header holds
// what they share:
//
//  * a multi-stage ring of k chunks in shared memory, filled with cp.async
//    so that chunk q+STAGES-1 is in flight while chunk q is multiplied.
//    Rows whose global stride is a multiple of 4 floats (and 16-byte
//    aligned) are copied 16 bytes at a time; other rows (K = 1433 or 3703,
//    B rows of 3-7 floats) 4 bytes at a time, in place, without a padded
//    copy (the kernels take the copy width as a template argument).
//    Elements past the valid rows or columns are zero-filled by the copy
//    itself (cp.async's src-size operand);
//  * a register micro-tile of TM rows x TN columns per thread. A is kept
//    row-major in shared memory (row stride BK+4 floats, free of bank
//    conflicts for 16-byte reads) and read 4 k at a time with one LDS.128
//    per row; B rows are read with one LDS.128 per 4 columns;
//  * the FMA order. Every output element is one FMA chain in ascending k
//    over the k range it is given, starting from +0:
//    acc = fmaf(a[m][k], b[k][n], acc) for k = k0, k0 + 1, ... Only the
//    valid k of the last chunk are multiplied (no zero-padded steps), so
//    the bits do not depend on BM, BN, BK, TM, TN or STAGES: every
//    configuration that a wrapper may pick gives the same result.
//
// Thread (ty, tx), ty < TROWS = BM/TM, tx < TCOLS = BN/TN, owns rows
// ty + i*TROWS (i < TM) and columns 4*(tx + j*TCOLS) + {0..3} (j < TN/4):
// neighbouring threads read neighbouring 16-byte words of a B row, and
// threads of one row read the same A words (a broadcast).
#pragma once

#include <cuda_runtime.h>

namespace ffma_tile {

template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int TROWS = BM / TM;
  static constexpr int TCOLS = BN / TN;
  static constexpr int THREADS = TROWS * TCOLS;
  static constexpr int ALD = BK + 4;  // A row stride in shared memory
  static constexpr int BLD = BN;      // B row stride in shared memory
  static constexpr int A_FLOATS = BM * ALD;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BLD;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile must split evenly");
  static_assert(TN % 4 == 0 && BK % 4 == 0, "16-byte shared-memory reads");
  static_assert(STAGES >= 2, "a ring needs two stages");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte copy; n == 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n * 4));
}

// 16-byte copy of n <= 4 floats, the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n * 4));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies a ROWS x COLS block of a row-major global matrix (row stride ld
// floats) into shared memory (row stride SLD floats), VEC ? 16 : 4 bytes
// per cp.async. Thread t copies column c = (t % CW) * W of rows
// t / CW + i * RSTEP: its offsets are worked out once per block, so a
// chunk costs a compare, an address add and a cp.async per copy. Elements
// at row >= rows or column >= cols are zero-filled. VEC needs ld % 4 == 0
// and a 16-byte aligned block origin.
template <int ROWS, int COLS, int SLD, int THREADS, bool VEC>
struct Copier {
  static constexpr int W = VEC ? 4 : 1;  // floats per copy
  static constexpr int CW = COLS / W;    // copies per row
  static constexpr int RSTEP = THREADS / CW;
  static constexpr int ITERS = (ROWS + RSTEP - 1) / RSTEP;
  static_assert(COLS % W == 0 && THREADS % CW == 0,
                "a thread keeps one column of the block");
  int r0, c;
  long long goff, gstep;

  __device__ __forceinline__ explicit Copier(long long ld)
      : r0(static_cast<int>(threadIdx.x) / CW),
        c(static_cast<int>(threadIdx.x) % CW * W),
        goff(r0 * ld + c),
        gstep(RSTEP * ld) {}

  // Copy the block at g (rows valid < rows, columns valid < cols) to s.
  __device__ __forceinline__ void copy(float* s, const float* g, int rows,
                                       int cols) const {
    const int n = max(0, min(W, cols - c));
    float* dst = s + r0 * SLD + c;
    const float* src = g + goff;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int r = r0 + it * RSTEP;
      if (ROWS % RSTEP == 0 || r < ROWS) {
        const int k = r < rows ? n : 0;
        if (VEC)
          cp_async16(dst + it * RSTEP * SLD, k ? src + it * gstep : g, k);
        else
          cp_async4(dst + it * RSTEP * SLD, k ? src + it * gstep : g, k);
      }
    }
  }
};

// Ring slot of chunk q: its A block (BM x BK), then its B block (BK x BN).
template <class C>
__device__ __forceinline__ float* slot_a(float* smem, int q) {
  return smem + (q % C::STAGES) * C::STAGE_FLOATS;
}

template <class C>
__device__ __forceinline__ float* slot_b(float* smem, int q) {
  return slot_a<C>(smem, q) + C::A_FLOATS;
}

template <class C>
__device__ __forceinline__ void b_row(float (&b)[C::TN], const float* bs,
                                      int k, int tx) {
#pragma unroll
  for (int j = 0; j < C::TN / 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(
        bs + k * C::BLD + 4 * (tx + j * C::TCOLS));
    b[4 * j] = v.x;
    b[4 * j + 1] = v.y;
    b[4 * j + 2] = v.z;
    b[4 * j + 3] = v.w;
  }
}

// acc += As[rows, :kc] @ Bs[:kc, cols] for the thread's micro-tile, one
// FMA per (row, column) per k in ascending k. kc == BK takes the unrolled
// path (LDS.128 along k for A); the last, partial chunk reads A singly.
template <class C>
__device__ __forceinline__ void fma_chunk(float (&acc)[C::TM][C::TN],
                                          const float* as, const float* bs,
                                          int ty, int tx, int kc) {
  if (kc == C::BK) {
#pragma unroll
    for (int k4 = 0; k4 < C::BK; k4 += 4) {
      float4 a[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + (ty + i * C::TROWS) * C::ALD + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[C::TN];
        b_row<C>(b, bs, k4 + kk, tx);
#pragma unroll
        for (int i = 0; i < C::TM; ++i) {
          const float av = kk == 0   ? a[i].x
                           : kk == 1 ? a[i].y
                           : kk == 2 ? a[i].z
                                     : a[i].w;
#pragma unroll
          for (int j = 0; j < C::TN; ++j)
            acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  } else {
    for (int k = 0; k < kc; ++k) {
      float b[C::TN];
      b_row<C>(b, bs, k, tx);
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        const float av = as[(ty + i * C::TROWS) * C::ALD + k];
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// Run chunks q = 0 .. n-1 through the ring: load(q, as, bs) issues chunk
// q's cp.async copies into its slot, compute(q, as, bs) consumes it.
// Chunk q+STAGES-1 is issued before chunk q is computed; its slot is the
// one chunk q-1 used, which every thread has left by the barrier.
template <class C, class Load, class Compute>
__device__ __forceinline__ void pipeline(float* smem, int n, Load&& load,
                                         Compute&& compute) {
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n) load(s, slot_a<C>(smem, s), slot_b<C>(smem, s));
    cp_async_commit();
  }
  for (int q = 0; q < n; ++q) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int nq = q + C::STAGES - 1;
    if (nq < n) load(nq, slot_a<C>(smem, nq), slot_b<C>(smem, nq));
    cp_async_commit();
    compute(q, slot_a<C>(smem, q), slot_b<C>(smem, q));
  }
  cp_async_wait<0>();
}

// Store the thread's micro-tile to rows m0.. and columns n0.. of a
// row-major [*, ld] float32 matrix, rows < rows and columns < cols only.
// vec16: ld % 4 == 0 and c 16-byte aligned (4 columns stored at once).
template <class C>
__device__ __forceinline__ void store(const float (&acc)[C::TM][C::TN],
                                      float* c, long long ld, int rows,
                                      int cols, int ty, int tx, bool vec16) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = ty + i * C::TROWS;
    if (r >= rows) continue;
    float* crow = c + r * ld;
#pragma unroll
    for (int j = 0; j < C::TN / 4; ++j) {
      const int n = 4 * (tx + j * C::TCOLS);
      if (vec16 && n + 4 <= cols) {
        *reinterpret_cast<float4*>(crow + n) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < cols) crow[n + e] = acc[i][4 * j + e];
      }
    }
  }
}

// Allow a kernel `bytes` of dynamic shared memory (above the 48 KB
// default), once per device; `done` is the caller's per-kernel record.
// Returns a cudaError_t.
template <class Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return static_cast<int>(err);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace ffma_tile
