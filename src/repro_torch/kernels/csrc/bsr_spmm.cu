// BSR SpMM: the dense-tile engine of the tri-partition, for Hopper (sm_90a),
// with the sum over tile_row inside the kernel.
//
// Replaces the TPU kernel `_bsr_kernel` / `bsr_spmm`
// (src/repro/kernels/bsr_spmm.py) together with the segment sum over
// tile_row that the reference's `dense_tiles_matmul` applies to its
// per-tile products. For every group member g and row tile r:
//
//   out[g,r] = sum over j in [offsets[s], offsets[s+1]), s = g*n_rt + r, of
//              tiles[e] (T x T) @ B[g, tile_col[e]] (T x F),  e = order[j]
//
// in float32, where order/offsets are the host-built reduction plan of the
// dense tiles (entries stably sorted by tile_row, per-segment counts
// summed). Row tiles without a dense tile come out as zeros. With no plan
// (order = offsets = null) every tile is its own segment: out[g,t] is the
// per-tile product, which is the reference's `bsr_spmm`.
//
// What bounds it on the H100: bytes, at the main path's shapes. A 64 x 64
// tile against a 128-wide slab does 2*64 FLOP per byte of tile, but each
// tile is used once and the B tiles and the 64-row output band are as
// large as the tile or larger, so the tiles, the B tiles they use and the
// band written (~30 MB at pubmed, F = 128) outweigh the FFMA work at 67
// TFLOP/s; at F = 3..7 the tiles alone are the bytes.
//
// Design. One block per (row tile, feature slab, member) walks its row
// tile's tiles in plan order. Their indices are read once into shared memory;
// the tiles and the B tiles they use stream through the cp.async ring of
// ffma_tile.cuh, so the next chunk's loads overlap this chunk's FFMA.
// Each tile's product is one FMA chain per element in ascending k from
// +0, kept in registers, then added onto the row accumulator (from +0, one
// add per tile, in plan order): the order of torch.segment_reduce over the
// per-tile products, so the result equals per-tile products summed by
// `segment_sum` bit for bit. The band is written once. The products never
// go through device memory, and no gather or segment-sum launch follows.
//
// The block shape is picked from F alone:
//   wide    64 x 64 slab, 128 threads of 4 x 8 (F > 16). F = 128 takes
//           two slabs: the second reads each tile again, from L2. On the
//           H100 this beat one 128-wide slab of 256 threads at every main
//           path shape (twice the blocks, a third fewer registers each);
//   narrow  64 x 8 slab, 128 threads each owning one row and 4 features
//           (F <= 16): no lane works on 64-wide zero columns.
//
// B rows of F = 3, 7 or 130 floats are not 16-byte aligned and are copied
// 4 bytes at a time; tiles (T = 64) and F = 128 rows 16 bytes at a time.
// No tensor cores on float32: the port holds float32 parity with the
// reference.
//
// bfloat16 (bsr_spmm_rows_bf16): tiles and B in bfloat16, as the
// reference's dense engine takes them (its caller casts the tiles to B's
// type), multiplied on the tensor cores (the m16n8k16 mainloop of
// mma_tile.cuh) with a float32 accumulator. Each tile's product is one
// accumulator per element from +0 over the k16 steps, then added onto the
// row accumulator in plan order, as above, so the rows equal the per-tile
// products (this kernel without a plan) summed by `segment_sum`, bit for
// bit. With `round_out` (the dense engine's rows) each sum is rounded to
// bfloat16 in the epilogue and stored as float into the float32 output, the
// buffer the ELL kernel then adds onto: the reference rounds its dense rows
// to B's type before the ELL add. Without it (per-tile products) the
// float32 products are stored as they are, as the reference's kernel
// returns them. Shapes: 64 x 64 blocks of four 32 x 32 warps for F > 16,
// 64 x 8 blocks of four 16 x 8 warps for F <= 16.
#include "ffma_tile.cuh"
#include "mma_tile.cuh"

namespace {

using Wide = ffma_tile::Tile<64, 64, 16, 4, 8, 4>;
using Narrow = ffma_tile::Tile<64, 8, 16, 1, 4, 4>;

constexpr int kIndexBatch = 256;  // tile indices staged per pass
constexpr int kNarrowMaxF = 16;   // widest F the narrow shape takes

// A16/B16: tile rows / B rows are copied 16 bytes at a time (else 4).
// H > 1 (multi-head tiles [G, n_t, H, T, T]): column block h of B (F / H
// columns) is multiplied by head h's tile. blockIdx.y numbers (head, slab
// of the head's columns), so a slab never crosses a head and each block
// reads one head's tile; H = 1 is the single-tile block alone.
template <class C, bool A16, bool B16, int H>
__device__ __forceinline__ void bsr_rows(const float* __restrict__ tiles,
                                         const int* __restrict__ tile_col,
                                         const float* __restrict__ b,
                                         const long long* __restrict__ order,
                                         const long long* __restrict__ offsets,
                                         float* __restrict__ out, int n_rt,
                                         int nct, int T, int F, bool c16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long s_tile[kIndexBatch];  // tile entry e
  __shared__ long long s_b[kIndexBatch];     // B tile (member, col)
  const int row_blocks = (T + C::BM - 1) / C::BM;
  const int r = blockIdx.x / row_blocks;
  const int m0 = (blockIdx.x % row_blocks) * C::BM;
  const int fh = F / H;                       // a head's columns
  const int slabs = (fh + C::BN - 1) / C::BN;  // H > 1: slabs a head
  const int hd = H > 1 ? blockIdx.y / slabs : 0;
  const int f0 = H > 1 ? hd * fh + blockIdx.y % slabs * C::BN
                       : blockIdx.y * C::BN;
  const long long g = blockIdx.z;
  const long long s = g * n_rt + r;
  const long long begin = offsets ? offsets[s] : s;
  const long long end = offsets ? offsets[s + 1] : s + 1;
  const int tx = threadIdx.x % C::TCOLS;
  const int ty = threadIdx.x / C::TCOLS;
  const int rows = min(C::BM, T - m0);
  const int cols = H > 1 ? min(C::BN, (hd + 1) * fh - f0)
                         : min(C::BN, F - f0);
  const int k_chunks = (T + C::BK - 1) / C::BK;
  const long long tt = static_cast<long long>(T) * T;
  const long long tf = static_cast<long long>(T) * F;
  const ffma_tile::Copier<C::BM, C::BK, C::ALD, C::THREADS, A16> copy_a(T);
  const ffma_tile::Copier<C::BK, C::BN, C::BLD, C::THREADS, B16> copy_b(F);
  float prod[C::TM][C::TN] = {};
  float row[C::TM][C::TN] = {};

  for (long long b0 = begin; b0 < end; b0 += kIndexBatch) {
    const int nb = static_cast<int>(min(end - b0, (long long)kIndexBatch));
    __syncthreads();  // the previous batch's indices are no longer read
    for (int i = threadIdx.x; i < nb; i += C::THREADS) {
      const long long e = order ? order[b0 + i] : b0 + i;
      s_tile[i] = H > 1 ? e * H + hd : e;  // the tile (of this head)
      s_b[i] = g * nct + tile_col[e];
    }
    __syncthreads();
    ffma_tile::pipeline<C>(
        smem, nb * k_chunks,
        [&](int q, float* as, float* bs) {
          const int j = q / k_chunks;
          const int k0 = (q % k_chunks) * C::BK;
          copy_a.copy(as,
                      tiles + s_tile[j] * tt + static_cast<long long>(m0) * T
                          + k0,
                      rows, T - k0);
          copy_b.copy(bs, b + s_b[j] * tf + static_cast<long long>(k0) * F
                              + f0,
                      T - k0, cols);
        },
        [&](int q, const float* as, const float* bs) {
          const int kq = q % k_chunks;
          ffma_tile::fma_chunk<C>(prod, as, bs, ty, tx,
                                  min(C::BK, T - kq * C::BK));
          if (kq == k_chunks - 1) {  // the tile's product is complete
#pragma unroll
            for (int i = 0; i < C::TM; ++i)
#pragma unroll
              for (int jj = 0; jj < C::TN; ++jj) {
                row[i][jj] += prod[i][jj];
                prod[i][jj] = 0.f;
              }
          }
        });
  }
  ffma_tile::store<C>(row, out + (s * T + m0) * F + f0, F, rows, cols, ty,
                      tx, c16);
}

template <class C, bool A16, bool B16>
__global__ void __launch_bounds__(C::THREADS)
bsr_rows_kernel(const float* __restrict__ tiles,
                const int* __restrict__ tile_col,
                const float* __restrict__ b,
                const long long* __restrict__ order,
                const long long* __restrict__ offsets,
                float* __restrict__ out, int n_rt, int nct, int T, int F,
                bool c16) {
  bsr_rows<C, A16, B16, 1>(tiles, tile_col, b, order, offsets, out, n_rt,
                           nct, T, F, c16);
}

// The multi-head rows kernel: tiles [G, n_t, H, T, T], grid y (head, slab).
template <class C, bool A16, bool B16, int H>
__global__ void __launch_bounds__(C::THREADS)
bsr_heads_kernel(const float* __restrict__ tiles,
                 const int* __restrict__ tile_col,
                 const float* __restrict__ b,
                 const long long* __restrict__ order,
                 const long long* __restrict__ offsets,
                 float* __restrict__ out, int n_rt, int nct, int T, int F,
                 bool c16) {
  bsr_rows<C, A16, B16, H>(tiles, tile_col, b, order, offsets, out, n_rt,
                           nct, T, F, c16);
}

template <class C, bool A16, bool B16, int H>
int launch_heads(const float* tiles, const int* tile_col, const float* b,
                 const long long* order, const long long* offsets,
                 float* out, int G, int n_rt, int nct, int T, int F,
                 cudaStream_t stream) {
  static bool smem_allowed[64] = {};
  const int err = ffma_tile::allow_smem(bsr_heads_kernel<C, A16, B16, H>,
                                        C::SMEM_BYTES, smem_allowed);
  if (err) return err;
  const int fh = F / H;
  const dim3 grid(n_rt * ((T + C::BM - 1) / C::BM),
                  H * ((fh + C::BN - 1) / C::BN), G);
  const bool c16 = fh % 4 == 0 && ffma_tile::aligned16(out);
  bsr_heads_kernel<C, A16, B16, H>
      <<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
          tiles, tile_col, b, order, offsets, out, n_rt, nct, T, F, c16);
  return static_cast<int>(cudaGetLastError());
}

// The multi-head instance for H heads of F / H columns: the shape from a
// head's width, 16-byte B copies where a head's columns start on whole
// vectors.
template <int H>
int launch_h(const float* tiles, const int* tile_col, const float* b,
                 const long long* order, const long long* offsets,
                 float* out, int G, int n_rt, int nct, int T, int F,
                 cudaStream_t stream) {
  const bool a16 = T % 4 == 0 && ffma_tile::aligned16(tiles);
  const bool b16 = (F / H) % 4 == 0 && ffma_tile::aligned16(b);
  const bool narrow = F / H <= kNarrowMaxF;
#define BSR_HEADS(SHAPE, A, B)                                              \
  return launch_heads<SHAPE, A, B, H>(tiles, tile_col, b, order, offsets,   \
                                      out, G, n_rt, nct, T, F, stream)
  if (narrow) {
    if (a16 && b16) BSR_HEADS(Narrow, true, true);
    if (a16) BSR_HEADS(Narrow, true, false);
    if (b16) BSR_HEADS(Narrow, false, true);
    BSR_HEADS(Narrow, false, false);
  }
  if (a16 && b16) BSR_HEADS(Wide, true, true);
  if (a16) BSR_HEADS(Wide, true, false);
  if (b16) BSR_HEADS(Wide, false, true);
  BSR_HEADS(Wide, false, false);
#undef BSR_HEADS
}

template <class C, bool A16, bool B16>
int launch(const float* tiles, const int* tile_col, const float* b,
           const long long* order, const long long* offsets, float* out,
           int G, int n_rt, int nct, int T, int F, cudaStream_t stream) {
  static bool smem_allowed[64] = {};
  const int err = ffma_tile::allow_smem(bsr_rows_kernel<C, A16, B16>,
                                        C::SMEM_BYTES, smem_allowed);
  if (err) return err;
  const dim3 grid(n_rt * ((T + C::BM - 1) / C::BM), (F + C::BN - 1) / C::BN,
                  G);
  const bool c16 = F % 4 == 0 && ffma_tile::aligned16(out);
  bsr_rows_kernel<C, A16, B16><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      tiles, tile_col, b, order, offsets, out, n_rt, nct, T, F, c16);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch(const float* tiles, const int* tile_col, const float* b,
           const long long* order, const long long* offsets, float* out,
           int G, int n_rt, int nct, int T, int F, cudaStream_t stream) {
  const bool a16 = T % 4 == 0 && ffma_tile::aligned16(tiles);
  const bool b16 = F % 4 == 0 && ffma_tile::aligned16(b);
  if (a16 && b16)
    return launch<C, true, true>(tiles, tile_col, b, order, offsets, out, G,
                                 n_rt, nct, T, F, stream);
  if (a16)
    return launch<C, true, false>(tiles, tile_col, b, order, offsets, out, G,
                                  n_rt, nct, T, F, stream);
  if (b16)
    return launch<C, false, true>(tiles, tile_col, b, order, offsets, out, G,
                                  n_rt, nct, T, F, stream);
  return launch<C, false, false>(tiles, tile_col, b, order, offsets, out, G,
                                 n_rt, nct, T, F, stream);
}

using MmaWide = mma_tile::Tile<64, 64, 32, 32, 32, 3>;
using MmaNarrow = mma_tile::Tile<64, 8, 32, 16, 8, 3>;

// The bfloat16 rows kernel: grid and plan as bsr_rows_kernel. A16/B16: tile
// rows / B rows copied 16 bytes at a time (else one element); ROUND: each
// row sum rounded to bfloat16 before it is stored.
// A minimum of one block per SM: with the block size alone ptxas held the
// narrow instances that copy tiles one element at a time at 64 registers
// and spilled 4 bytes to get there.
template <class C, bool A16, bool B16, bool ROUND>
__global__ void __launch_bounds__(C::THREADS, 1)
bsr_rows_mma_kernel(const __nv_bfloat16* __restrict__ tiles,
                    const int* __restrict__ tile_col,
                    const __nv_bfloat16* __restrict__ b,
                    const long long* __restrict__ order,
                    const long long* __restrict__ offsets,
                    float* __restrict__ out, int n_rt, int nct, int T,
                    int F) {
  using mma_tile::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ long long s_tile[kIndexBatch];  // tile entry e
  __shared__ long long s_b[kIndexBatch];     // B tile (member, col)
  const int row_blocks = (T + C::BM - 1) / C::BM;
  const int r = blockIdx.x / row_blocks;
  const int m0 = (blockIdx.x % row_blocks) * C::BM;
  const int f0 = blockIdx.y * C::BN;
  const long long g = blockIdx.z;
  const long long s = g * n_rt + r;
  const long long begin = offsets ? offsets[s] : s;
  const long long end = offsets ? offsets[s + 1] : s + 1;
  const int wm = mma_tile::warp_m<C>(), wn = mma_tile::warp_n<C>();
  const int rows = min(C::BM, T - m0);
  const int cols = min(C::BN, F - f0);
  const int k_chunks = (T + C::BK - 1) / C::BK;
  const long long tt = static_cast<long long>(T) * T;
  const long long tf = static_cast<long long>(T) * F;
  const mma_tile::Copier<C::BM, C::BK, C::ALD, C::THREADS, A16> copy_a(T);
  const mma_tile::Copier<C::BK, C::BN, C::BLD, C::THREADS, B16> copy_b(F);
  mma_tile::Acc<C> prod = {};
  mma_tile::Acc<C> row = {};

  for (long long b0 = begin; b0 < end; b0 += kIndexBatch) {
    const int nb = static_cast<int>(min(end - b0, (long long)kIndexBatch));
    __syncthreads();  // the previous batch's indices are no longer read
    for (int i = threadIdx.x; i < nb; i += C::THREADS) {
      const long long e = order ? order[b0 + i] : b0 + i;
      s_tile[i] = e;
      s_b[i] = g * nct + tile_col[e];
    }
    __syncthreads();
    mma_tile::pipeline<C>(
        smem, nb * k_chunks,
        [&](int q, bf16* as, bf16* bs) {
          const int j = q / k_chunks;
          const int k0 = (q % k_chunks) * C::BK;
          copy_a.copy(as,
                      tiles + s_tile[j] * tt + static_cast<long long>(m0) * T
                          + k0,
                      rows, T - k0);
          copy_b.copy(bs, b + s_b[j] * tf + static_cast<long long>(k0) * F
                              + f0,
                      T - k0, cols);
        },
        [&](int q, const bf16* as, const bf16* bs) {
          const int kq = q % k_chunks;
          mma_tile::mma_chunk<C>(prod, as, bs, wm, wn,
                                 min(C::BK, T - kq * C::BK));
          if (kq == k_chunks - 1) {  // the tile's product is complete
#pragma unroll
            for (int i = 0; i < C::MI; ++i)
#pragma unroll
              for (int jj = 0; jj < C::NI; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  row[i][jj][e] += prod[i][jj][e];
                  prod[i][jj][e] = 0.f;
                }
          }
        });
  }
  float* o = out + (s * T + m0) * F + f0;
  mma_tile::for_each<C>(row, wm, wn, rows, cols, [&](int rr, int n, float v) {
    o[static_cast<long long>(rr) * F + n] =
        ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  });
}

template <class C, bool A16, bool B16, bool ROUND>
int launch_mma(const __nv_bfloat16* tiles, const int* tile_col,
               const __nv_bfloat16* b, const long long* order,
               const long long* offsets, float* out, int G, int n_rt, int nct,
               int T, int F, cudaStream_t stream) {
  static bool smem_allowed[64] = {};
  const int err = ffma_tile::allow_smem(
      bsr_rows_mma_kernel<C, A16, B16, ROUND>, C::SMEM_BYTES, smem_allowed);
  if (err) return err;
  const dim3 grid(n_rt * ((T + C::BM - 1) / C::BM), (F + C::BN - 1) / C::BN,
                  G);
  bsr_rows_mma_kernel<C, A16, B16, ROUND>
      <<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(tiles, tile_col, b, order,
                                                    offsets, out, n_rt, nct,
                                                    T, F);
  return static_cast<int>(cudaGetLastError());
}

template <class C, bool ROUND>
int launch_mma(const __nv_bfloat16* tiles, const int* tile_col,
               const __nv_bfloat16* b, const long long* order,
               const long long* offsets, float* out, int G, int n_rt, int nct,
               int T, int F, cudaStream_t stream) {
  const bool a16 = T % 8 == 0 && mma_tile::aligned16(tiles);
  const bool b16 = F % 8 == 0 && mma_tile::aligned16(b);
  if (a16 && b16)
    return launch_mma<C, true, true, ROUND>(tiles, tile_col, b, order,
                                            offsets, out, G, n_rt, nct, T, F,
                                            stream);
  if (a16)
    return launch_mma<C, true, false, ROUND>(tiles, tile_col, b, order,
                                             offsets, out, G, n_rt, nct, T,
                                             F, stream);
  if (b16)
    return launch_mma<C, false, true, ROUND>(tiles, tile_col, b, order,
                                             offsets, out, G, n_rt, nct, T,
                                             F, stream);
  return launch_mma<C, false, false, ROUND>(tiles, tile_col, b, order,
                                            offsets, out, G, n_rt, nct, T, F,
                                            stream);
}

template <class C>
int launch_mma(const __nv_bfloat16* tiles, const int* tile_col,
               const __nv_bfloat16* b, const long long* order,
               const long long* offsets, float* out, int G, int n_rt, int nct,
               int T, int F, bool round_out, cudaStream_t stream) {
  if (round_out)
    return launch_mma<C, true>(tiles, tile_col, b, order, offsets, out, G,
                               n_rt, nct, T, F, stream);
  return launch_mma<C, false>(tiles, tile_col, b, order, offsets, out, G,
                              n_rt, nct, T, F, stream);
}

}  // namespace

extern "C" {

// tiles [G,n_t,T,T], tile_col [G,n_t] int32, b [G,nct,T,F] -> out
// [G,n_rt,T,F]; all contiguous, tile_col[...] < nct. order [n_sel] int64
// holds entries g*n_t + i stably sorted by segment g*n_rt + tile_row, and
// offsets [G*n_rt + 1] int64 the start of each segment in order; both
// null: n_rt = n_t and tile t is segment t (per-tile products).
int bsr_spmm_rows_f32(const void* tiles, const void* tile_col, const void* b,
                      const void* order, const void* offsets, void* out,
                      int G, int n_rt, int nct, int T, int F,
                      void* stream) {
  const auto* pt = static_cast<const float*>(tiles);
  const auto* pc = static_cast<const int*>(tile_col);
  const auto* pb = static_cast<const float*>(b);
  const auto* po = static_cast<const long long*>(order);
  const auto* ps = static_cast<const long long*>(offsets);
  auto* pout = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if ((order == nullptr) != (offsets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (F <= kNarrowMaxF)
    return launch<Narrow>(pt, pc, pb, po, ps, pout, G, n_rt, nct, T, F, st);
  return launch<Wide>(pt, pc, pb, po, ps, pout, G, n_rt, nct, T, F, st);
}

// bsr_spmm_rows_f32's arguments with multi-head tiles [G,n_t,H,T,T]:
// column block h of B (F / H columns) times head h's tile; H 4 or 6 (the
// served GAT's, kernels/_build.py HEADS) dividing F, and a plan (order,
// offsets) given; else cudaErrorInvalidValue without a launch.
int bsr_spmm_rows_heads_f32(const void* tiles, const void* tile_col,
                            const void* b, const void* order,
                            const void* offsets, void* out, int G, int n_rt,
                            int nct, int T, int F, int H, void* stream) {
  const auto* pt = static_cast<const float*>(tiles);
  const auto* pc = static_cast<const int*>(tile_col);
  const auto* pb = static_cast<const float*>(b);
  const auto* po = static_cast<const long long*>(order);
  const auto* ps = static_cast<const long long*>(offsets);
  auto* pout = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (order == nullptr || offsets == nullptr || H < 2 || F % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (H) {
    case 4: return launch_h<4>(pt, pc, pb, po, ps, pout, G, n_rt, nct, T,
                                   F, st);
    case 6: return launch_h<6>(pt, pc, pb, po, ps, pout, G, n_rt, nct, T,
                                   F, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bsr_spmm_rows_f32's arguments with tiles and b bfloat16 and out float32;
// round_out != 0 rounds each output element to bfloat16 (kept as float).
int bsr_spmm_rows_bf16(const void* tiles, const void* tile_col,
                       const void* b, const void* order, const void* offsets,
                       void* out, int G, int n_rt, int nct, int T, int F,
                       int round_out, void* stream) {
  const auto* pt = static_cast<const __nv_bfloat16*>(tiles);
  const auto* pc = static_cast<const int*>(tile_col);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  const auto* po = static_cast<const long long*>(order);
  const auto* ps = static_cast<const long long*>(offsets);
  auto* pout = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if ((order == nullptr) != (offsets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (F <= kNarrowMaxF)
    return launch_mma<MmaNarrow>(pt, pc, pb, po, ps, pout, G, n_rt, nct, T,
                                 F, round_out != 0, st);
  return launch_mma<MmaWide>(pt, pc, pb, po, ps, pout, G, n_rt, nct, T, F,
                             round_out != 0, st);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
