// The Hopper tensor-core mainloop of tile_matmul.cu's bfloat16 instances.
//
// A block forms C[BM x BN] += A[BM x K] @ B[K x BN] with
// wgmma.mma_async m64nBNk16 (one warpgroup a 64 rows; A from registers, B
// from shared memory, a float32 accumulator), fed by a ring of k chunks
// (BK columns of A, BK rows of B). This header holds the pieces:
//
//  * A's spans. A row of A whose window [k0, k1) does not start on a
//    16-byte boundary is copied with 16-byte cp.async as the aligned span
//    that covers it: BK/8 + 1 chunks from the one that holds the window's
//    first byte. The src-size operand zero-fills each chunk past the
//    window's last byte, so nothing past the tensor is read and k or rows
//    past the window land as zeros; before the first byte a chunk reaches
//    back only within its own 16-byte granule (those elements are never
//    used). The row lands shifted by its own s = (address mod 16) / 2
//    elements, 0-7 (k0 is a multiple of 8, so s does not change with k0);
//  * A fragments. Each thread builds the A fragments of its two rows (the
//    m16n8k16 register layout, per warp of the warpgroup) from two 32-bit
//    shared loads a register and one funnel shift (by 16 where s is odd):
//    ldmatrix needs 16-byte-aligned rows, register-A wgmma does not;
//  * B by TMA. Where B's rows are 16-byte aligned (N % 8 == 0, an aligned
//    base) and BN = 128, each chunk of B arrives by cp.async.bulk.tensor
//    in the 128-byte-swizzled N-major layout wgmma reads (two 64-column
//    panels of BK rows of 128 bytes), completing on an mbarrier: one
//    request a panel (16-byte cp.async from every thread of every block,
//    all reading the same lines of L2 at once, were slower);
//  * B by spans. Other B (N = 3..7, unaligned bases, BN = 8): each row's
//    span lands in a staging area by cp.async and the block realigns it
//    into the no-swizzle N-major layout: 8 x 8 core matrices of 8 k-rows
//    of 16 bytes, 128 bytes apart along k, BK * 16 bytes along n;
//  * the order of the sums. Every output element is one float32
//    accumulator that takes the k16 steps of the block's k range in
//    ascending k from +0; a k16 step that lies wholly past the range is
//    never issued. The split points of K and the k16 grid do not depend on
//    the block shape, so neither do the bits (tile_matmul.cu);
//  * the epilogue. The block's tile goes through shared memory and leaves
//    in 16-byte row-contiguous stores (bfloat16), or, split over K, as
//    float32 partials that each rank of the split adds for its share of
//    the rows, reading every rank's tile over distributed shared memory in
//    rank order.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wgmma_tile {

using bf16 = __nv_bfloat16;

template <int BM_, int BN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int THREADS = 128 * (BM / 64);  // a warpgroup a 64 rows
  static constexpr int NACC = BN / 2;              // accumulators a thread
  static constexpr int KSTEPS = BK / 16;
  static constexpr int B_BYTES = BK * BN * 2;      // wgmma's B layout
  static constexpr int A_CHUNKS = BK / 8 + 1;      // 16-byte chunks a span
  static constexpr int A_PITCH = A_CHUNKS * 16;    // bytes a row of A
  static constexpr int A_BYTES = BM * A_PITCH;
  static constexpr int S_CHUNKS = BN / 8 + 1;      // a staged B row's span
  static constexpr int S_PITCH = S_CHUNKS * 16;
  static constexpr int S_BYTES = BK * S_PITCH;
  static constexpr int C_PITCH = BN * 2 + 16;      // bf16 tile, bytes a row
  static constexpr int P_PITCH = BN * 4 + 32;      // float32 partials
  // one ring slot: B, A's spans and, for staged B, B's spans
  __host__ __device__ static constexpr int slot_bytes(bool staged) {
    return B_BYTES + A_BYTES + (staged ? S_BYTES : 0);
  }
  // the ring, an mbarrier a slot and the slack that aligns the ring to
  // 1024 bytes (the swizzle's period)
  __host__ __device__ static constexpr int smem_bytes(bool staged) {
    return STAGES * slot_bytes(staged) + 8 * STAGES + 1024;
  }
  static_assert(BM % 64 == 0 && (BN == 8 || BN == 128),
                "m64 warpgroups; n8 and n128 products");
  static_assert(BK == 64 && STAGES >= 2, "64-row swizzled panels; a ring");
  static_assert(B_BYTES % 1024 == 0 || BN == 8, "panels on 1024 bytes");
  static_assert(STAGES * (B_BYTES + A_BYTES) >= BM * P_PITCH,
                "the ring holds the epilogue's tile");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy of the chunk at src: its first `bytes` (0-16) bytes, the
// rest zero-filled; bytes == 0 reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread, ordered before later reads by the
// tensor cores (the async proxy), once a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ---- mbarriers and TMA ----
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// The barriers' initialisation, visible to the tensor copies once a
// barrier follows.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 2-D tensor map at (x, y) into shared address dst,
// completing on the barrier at bar.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(x),
      "r"(y)
      : "memory");
}

// wgmma's descriptor of an N-major B block at shared address p: no
// swizzle (core matrices 128 bytes apart along k, sbo apart along n) or
// the 128-byte swizzle (8-row groups 1024 bytes apart along k, 64-column
// panels lbo apart along n).
__device__ __forceinline__ unsigned long long desc_interleave(unsigned p,
                                                              int sbo) {
  return static_cast<unsigned long long>((p & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(128 >> 4) << 16) |
         (static_cast<unsigned long long>(sbo >> 4) << 32);
}

__device__ __forceinline__ unsigned long long desc_sw128(unsigned p,
                                                         int lbo) {
  return static_cast<unsigned long long>((p & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(lbo >> 4) << 16) |
         (static_cast<unsigned long long>(1024 >> 4) << 32) |
         (1ull << 62);
}

// Elements between the 16-byte boundary below p and p: 0-7.
__device__ __forceinline__ int shift_of(const bf16* p) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(p) & 15) >>
                          1);
}

// Copies the window [k0, k1) of rows r < rows of the row-major matrix at
// g (row stride ld elements) as spans, A_CHUNKS chunks a row, into s
// (A_PITCH bytes a row); rows at or past `rows` are zero-filled.
template <class C>
__device__ __forceinline__ void copy_a(unsigned char* s, const bf16* g,
                                       long long ld, int rows, int k0,
                                       int k1) {
  for (int idx = threadIdx.x; idx < C::BM * C::A_CHUNKS;
       idx += C::THREADS) {
    const int r = idx / C::A_CHUNKS, i = idx - r * C::A_CHUNKS;
    const long long first =
        reinterpret_cast<long long>(g + r * ld + k0);
    const long long chunk = (first & ~15ll) + 16 * i;
    const long long left = first + 2ll * (k1 - k0) - chunk;
    const int bytes = r < rows ? static_cast<int>(left < 0 ? 0 : (left > 16
                                                      ? 16 : left)) : 0;
    cp_async16(s + r * C::A_PITCH + 16 * i,
               bytes ? reinterpret_cast<const void*>(chunk) : g, bytes);
  }
}

// Copies rows [k0, k1) (columns [0, cols)) of the B block at g (row stride
// ld, any alignment) as spans, S_CHUNKS chunks a row, into the staging
// area s (S_PITCH bytes a row); rows past k1 are zero-filled.
template <class C>
__device__ __forceinline__ void copy_b_spans(unsigned char* s, const bf16* g,
                                             long long ld, int cols, int k0,
                                             int k1) {
  for (int idx = threadIdx.x; idx < C::BK * C::S_CHUNKS;
       idx += C::THREADS) {
    const int kk = idx / C::S_CHUNKS, i = idx - kk * C::S_CHUNKS;
    const long long first = reinterpret_cast<long long>(g + (k0 + kk) * ld);
    const long long chunk = (first & ~15ll) + 16 * i;
    const long long left = first + 2ll * cols - chunk;
    const int bytes = k0 + kk < k1 ? static_cast<int>(left < 0 ? 0 : (left >
                                                      16 ? 16 : left)) : 0;
    cp_async16(s + kk * C::S_PITCH + 16 * i,
               bytes ? reinterpret_cast<const void*>(chunk) : g, bytes);
  }
}

// The staged B rows of chunk k0 (copy_b_spans into st) realigned into the
// no-swizzle layout at s: chunk (k, n8) from row k's span at its shift.
template <class C>
__device__ __forceinline__ void realign_b(unsigned char* s,
                                          const unsigned char* st,
                                          const bf16* g, long long ld,
                                          int k0) {
  constexpr int NC = C::BN / 8;
  for (int idx = threadIdx.x; idx < C::BK * NC; idx += C::THREADS) {
    const int kk = idx % C::BK, nc = idx / C::BK;
    const int sh = shift_of(g + (k0 + kk) * ld);
    const unsigned* w = reinterpret_cast<const unsigned*>(
                            st + kk * C::S_PITCH) + ((sh + 8 * nc) >> 1);
    const int f = (sh & 1) * 16;
    uint4 v;
    v.x = __funnelshift_r(w[0], w[1], f);
    v.y = __funnelshift_r(w[1], w[2], f);
    v.z = __funnelshift_r(w[2], w[3], f);
    v.w = __funnelshift_r(w[3], w[4], f);
    *reinterpret_cast<uint4*>(s + (nc * (C::BK / 8) + kk / 8) * 128 +
                              kk % 8 * 16) = v;
  }
}

// This thread's two rows of A in a stage (block rows 16 * warp + lane / 4
// and 8 more): the word of its first fragment pair in the span and the
// funnel shift of each.
template <class C>
struct Frag {
  int w0, w1, f0, f1;
  __device__ __forceinline__ Frag(const bf16* a0, long long ld) {
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int r0 = threadIdx.x / 32 * 16 + lane / 4, r1 = r0 + 8;
    const int s0 = shift_of(a0 + r0 * ld), s1 = shift_of(a0 + r1 * ld);
    w0 = r0 * (C::A_PITCH / 4) + (s0 >> 1) + t;
    w1 = r1 * (C::A_PITCH / 4) + (s1 >> 1) + t;
    f0 = (s0 & 1) * 16;
    f1 = (s1 & 1) * 16;
  }
};

// d += a @ B for one m64n128k16 step: a the thread's A fragment, B
// the k16 x 128 block the descriptor points at (N-major).
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a @ B for one m64n8k16 step: a the thread's A fragment, B
// the k16 x 8 block the descriptor points at (N-major).
__device__ __forceinline__ void wgmma_n8(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const unsigned (&a)[4],
                                      unsigned long long desc) {
  if constexpr (BN == 128) {
    wgmma_n128(d, a, desc);
  } else {
    wgmma_n8(d, a, desc);
  }
}

// acc += A's stage (spans at sa) @ B's stage (at sb: swizzled panels where
// SW128, else core matrices) over the first kc (1..BK) k of the chunk:
// every fragment of the chunk first, then one wgmma a k16 step in
// ascending k, steps at or past kc not issued. Returns once the products
// are issued; wgmma_wait() returns when they are done.
template <class C, bool SW128>
__device__ __forceinline__ void mma_stage(float (&acc)[C::NACC],
                                          const unsigned char* sa,
                                          const unsigned char* sb,
                                          const Frag<C>& fr, int kc) {
  const unsigned* w = reinterpret_cast<const unsigned*>(sa);
  unsigned a[C::KSTEPS][4];
#pragma unroll
  for (int j = 0; j < C::KSTEPS; ++j) {
    a[j][0] = __funnelshift_r(w[fr.w0 + 8 * j], w[fr.w0 + 8 * j + 1], fr.f0);
    a[j][1] = __funnelshift_r(w[fr.w1 + 8 * j], w[fr.w1 + 8 * j + 1], fr.f1);
    a[j][2] = __funnelshift_r(w[fr.w0 + 8 * j + 4], w[fr.w0 + 8 * j + 5],
                              fr.f0);
    a[j][3] = __funnelshift_r(w[fr.w1 + 8 * j + 4], w[fr.w1 + 8 * j + 5],
                              fr.f1);
  }
  const unsigned b0 = smem_u32(sb);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < C::KSTEPS; ++j) {
    if (16 * j < kc) {
      wgmma<C::BN>(acc, a[j],
                   SW128 ? desc_sw128(b0 + 2048 * j, C::BK * 128)
                         : desc_interleave(b0 + 256 * j, C::BK * 16));
    }
  }
  wgmma_commit();
}

// Element (row, column) of the block that accumulator i of this thread
// holds (the m64nNk16 layout): rows 16 * warp + lane / 4 (+ 8), columns
// 8 * (i / 4) + 2 * (lane % 4) (+ 1).
__device__ __forceinline__ int acc_row(int i) {
  return static_cast<int>(threadIdx.x) / 32 * 16 +
         static_cast<int>(threadIdx.x) % 32 / 4 + 8 * (i >> 1 & 1);
}

__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (static_cast<int>(threadIdx.x) % 4) + (i & 1);
}

// The block's tile rounded to bfloat16, through shared memory s (C_PITCH
// bytes a row), to C at c (row stride ld): 16-byte chunks of 8 columns,
// each row's chunks on neighbouring threads; vec16 where C's rows are
// 16-byte aligned (N % 8 == 0 and an aligned base).
template <class C>
__device__ __forceinline__ void store_tile(const float (&acc)[C::NACC],
                                           unsigned char* s, bf16* c,
                                           long long ld, int rows,
                                           int cols, bool vec16) {
#pragma unroll
  for (int i = 0; i < C::NACC; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(s + acc_row(i) * C::C_PITCH +
                                       acc_col(i) * 2) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  __syncthreads();
  constexpr int NC = C::BN / 8;
  for (int idx = threadIdx.x; idx < C::BM * NC; idx += C::THREADS) {
    const int r = idx / NC, n = idx % NC * 8;
    if (r >= rows || n >= cols) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(s + r * C::C_PITCH +
                                                    n * 2);
    bf16* o = c + r * ld + n;
    if (vec16) {
      *reinterpret_cast<uint4*>(o) = v;
    } else {
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (n + j < cols) {
          o[j] = __ushort_as_bfloat16(static_cast<unsigned short>(
              w[j / 2] >> (16 * (j % 2))));
        }
      }
    }
  }
}

// Split-K: this block's float32 partials go to its shared memory s
// (P_PITCH bytes a row); once the cluster's barrier has passed, the block
// of cluster rank `rank` of `splits` (one output block, consecutive k
// ranges) adds every rank's partials of its share of the rows, in rank
// order, read over distributed shared memory (16 bytes a load; all of a
// thread's loads issued before its sums), and stores them rounded to
// bfloat16: 8 bytes of 4 columns where vec8 (N % 4 == 0 and an 8-byte
// aligned base).
template <class C, int MAX_SPLITS, class Cluster>
__device__ __forceinline__ void reduce_tile(const float (&acc)[C::NACC],
                                            unsigned char* s, bf16* c,
                                            long long ld, int rows,
                                            int cols, bool vec8, int rank,
                                            int splits, Cluster& cluster) {
#pragma unroll
  for (int i = 0; i < C::NACC; i += 2)
    *reinterpret_cast<float2*>(s + acc_row(i) * C::P_PITCH +
                               acc_col(i) * 4) =
        make_float2(acc[i], acc[i + 1]);
  cluster.sync();
  const unsigned char* parts[MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r)
    parts[r] = cluster.map_shared_rank(s, r < splits ? r : 0);
  constexpr int NC = C::BN / 4;                 // 16-byte words a row
  // a rank's share: at most half the tile (splits >= 2), ITERS words a
  // thread
  constexpr int ITERS = (C::BM * NC / 2 + C::THREADS - 1) / C::THREADS;
  const int w0 = rank * C::BM / splits * NC;
  const int w1 = (rank + 1) * C::BM / splits * NC;
  float4 x[ITERS][MAX_SPLITS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int w = w0 + static_cast<int>(threadIdx.x) + it * C::THREADS;
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (w < w1 && q < splits)
        x[it][q] = *reinterpret_cast<const float4*>(
            parts[q] + w / NC * C::P_PITCH + w % NC * 16);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int w = w0 + static_cast<int>(threadIdx.x) + it * C::THREADS;
    const int r = w / NC, n = w % NC * 4;
    if (w >= w1 || r >= rows || n >= cols) continue;
    float4 v = x[it][0];
#pragma unroll
    for (int q = 1; q < MAX_SPLITS; ++q) {
      if (q < splits) {
        v.x += x[it][q].x;
        v.y += x[it][q].y;
        v.z += x[it][q].z;
        v.w += x[it][q].w;
      }
    }
    bf16* o = c + r * ld + n;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    if (vec8) {
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(o) = u;
    } else {
      const bf16 e[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < cols) o[j] = e[j];
    }
  }
  cluster.sync();  // keep every partial readable until all ranks are done
}

inline bool aligned(const void* p, unsigned long long bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

}  // namespace wgmma_tile
