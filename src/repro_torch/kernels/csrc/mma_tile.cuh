// The bfloat16 tensor-core tile mainloop of bsr_spmm.cu's bfloat16
// instances, as the reference's kernels take bfloat16 operands with a
// float32 accumulator (tile_matmul.cu's run on wgmma_tile.cuh).
//
// It forms C[BM x BN] += A[BM x K] @ B[K x BN] per block with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. This header holds
// its pieces:
//
//  * a multi-stage ring of k chunks (BK columns of A, BK rows of B) in
//    shared memory, filled with cp.async so that chunk q+STAGES-1 is in
//    flight while chunk q is multiplied. Rows whose global stride is a
//    multiple of 8 elements (and 16-byte aligned) are copied 16 bytes at a
//    time; other rows (K = 1433 or 3703, B rows of 3-7 features) one
//    element at a time with plain loads. Elements past the valid rows,
//    columns or k are zero-filled by the copy itself, so k is zero-padded
//    to a multiple of 16 and a zero adds nothing;
//  * warp tiles of WM x WN, as MI = WM/16 by NI = WN/8 fragments of one
//    m16n8k16 product each. Fragments are read from shared memory with
//    ldmatrix (A row-major; B row-major [k][n] through .trans). Rows are
//    padded by 8 elements (16 bytes), which keeps ldmatrix's eight 16-byte
//    rows on distinct banks;
//  * the order of the sums. Every output element is one accumulator that
//    takes the k16 steps in ascending k from +0, each step summed by the
//    tensor core in its own fixed order; a k16 step that lies wholly past
//    K is never issued. So the bits do not depend on BM, BN, BK, WM, WN or
//    STAGES: every configuration a wrapper may pick gives the same result.
//    They are not IEEE float32 sums in ascending k: the callers hold them
//    to a bound, not to the plain version's bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma_tile {

using bf16 = __nv_bfloat16;

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MI = WM / 16;  // m16 fragments per warp
  static constexpr int NI = WN / 8;   // n8 fragments per warp
  static constexpr int ALD = BK + 8;  // A row stride in shared memory
  static constexpr int BLD = BN + 8;  // B row stride in shared memory
  static constexpr int A_ELEMS = BM * ALD;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * BLD;
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
  static_assert(BM % WM == 0 && BN % WN == 0, "warps must tile the block");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 16 == 0,
                "m16n8k16 fragments");
  static_assert(STAGES >= 2, "a ring needs two stages");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy of n <= 8 elements, the rest zero-filled.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n * 2));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies a ROWS x COLS block of a row-major global matrix (row stride ld
// elements) into shared memory (row stride SLD elements): VEC, 8 elements
// per cp.async (needs ld % 8 == 0 and a 16-byte aligned block origin);
// else one element per plain load and store. Thread t copies column
// c = (t % CW) * W of rows t / CW + i * RSTEP. Elements at row >= rows or
// column >= cols are zero-filled.
template <int ROWS, int COLS, int SLD, int THREADS, bool VEC>
struct Copier {
  static constexpr int W = VEC ? 8 : 1;  // elements per copy
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
  __device__ __forceinline__ void copy(bf16* s, const bf16* g, int rows,
                                       int cols) const {
    const int n = max(0, min(W, cols - c));
    bf16* dst = s + r0 * SLD + c;
    const bf16* src = g + goff;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int r = r0 + it * RSTEP;
      if (ROWS % RSTEP == 0 || r < ROWS) {
        const int k = r < rows ? n : 0;
        if constexpr (VEC) {
          cp_async16(dst + it * RSTEP * SLD, k ? src + it * gstep : g, k);
        } else {
          dst[it * RSTEP * SLD] =
              k ? src[it * gstep] : __float2bfloat16_rn(0.f);
        }
      }
    }
  }
};

// Ring slot of chunk q: its A block (BM x BK), then its B block (BK x BN).
template <class C>
__device__ __forceinline__ bf16* slot_a(bf16* smem, int q) {
  return smem + (q % C::STAGES) * C::STAGE_ELEMS;
}

template <class C>
__device__ __forceinline__ bf16* slot_b(bf16* smem, int q) {
  return slot_a<C>(smem, q) + C::A_ELEMS;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d = a @ b + d for one m16n8k16 fragment.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's accumulators: fragment (i, j) covers rows wm + 16 i + {g, g+8}
// and columns wn + 8 j + {2t, 2t+1} of the block, g = lane / 4,
// t = lane % 4 (element e: row + 8 (e / 2), column + e % 2).
template <class C>
using Acc = float[C::MI][C::NI][4];

// acc += As[warp rows, :kc] @ Bs[:kc, warp columns], one k16 step at a
// time in ascending k; steps at or past kc are not issued.
template <class C>
__device__ __forceinline__ void mma_chunk(Acc<C>& acc, const bf16* as,
                                          const bf16* bs, int wm, int wn,
                                          int kc) {
  const int lane = threadIdx.x % 32;
  const int lr = lane % 16, lc = lane / 16 * 8;
#pragma unroll
  for (int k16 = 0; k16 < C::BK; k16 += 16) {
    if (k16 >= kc) break;
    unsigned a[C::MI][4];
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
      ldmatrix_x4(a[i], as + (wm + 16 * i + lr) * C::ALD + k16 + lc);
    if constexpr (C::NI % 2 == 0) {
#pragma unroll
      for (int j = 0; j < C::NI; j += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, bs + (k16 + lr) * C::BLD + wn + 8 * j + lc);
#pragma unroll
        for (int i = 0; i < C::MI; ++i) {
          mma(acc[i][j], a[i], b[0], b[1]);
          mma(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        unsigned b[2];
        ldmatrix_x2_trans(b, bs + (k16 + lr) * C::BLD + wn + 8 * j);
#pragma unroll
        for (int i = 0; i < C::MI; ++i) mma(acc[i][j], a[i], b[0], b[1]);
      }
    }
  }
}

// Run chunks q = 0 .. n-1 through the ring: load(q, as, bs) issues chunk
// q's copies into its slot, compute(q, as, bs) consumes it. Chunk
// q+STAGES-1 is issued before chunk q is computed; its slot is the one
// chunk q-1 used, which every thread has left by the barrier.
template <class C, class Load, class Compute>
__device__ __forceinline__ void pipeline(bf16* smem, int n, Load&& load,
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

// Each accumulator element of the warp at block row r < rows and column
// n < cols, as store(r, n, value).
template <class C, class Store>
__device__ __forceinline__ void for_each(const Acc<C>& acc, int wm, int wn,
                                         int rows, int cols, Store&& store) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + 16 * i + g + 8 * (e / 2);
        const int n = wn + 8 * j + 2 * t + e % 2;
        if (r < rows && n < cols) store(r, n, acc[i][j][e]);
      }
}

// The warp's first row and column in the block.
template <class C>
__device__ __forceinline__ int warp_m() {
  return static_cast<int>(threadIdx.x) / 32 / C::WARPS_N * C::WM;
}

template <class C>
__device__ __forceinline__ int warp_n() {
  return static_cast<int>(threadIdx.x) / 32 % C::WARPS_N * C::WN;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace mma_tile
