// GAT edge coefficients for the three engines of the tri-partition, for
// Hopper (sm_90a): each row's softmax statistics over all its neighbours,
// then the unnormalised coefficient of every stored entry of each engine's
// layout, per head.
//
// It replaces no TPU kernel: the reference serves the GCN alone. A graph
// attention layer (Velickovic et al., arXiv:1710.10903) weighs the edge
// (i, j) of head h by
//
//   e_ij = LeakyReLU(s_i + t_j),   s = (X W) a_l,  t = (X W) a_r  (per head)
//   alpha_ij = exp(e_ij - m_i) / d_i,
//   m_i = max_{j in N(i)} e_ij,    d_i = sum_{j in N(i)} exp(e_ij - m_i)
//
// where N(i) holds i's neighbours in A + I. The tri-partition splits a row's
// neighbours over up to three engines (dense tiles, ELL units, COO entries),
// so no engine sees a whole row: the statistics are taken here, once a row,
// over the row's neighbour list, and every engine multiplies by the same
// exp(e_ij - m_i). The division by d_i is left to the layer's epilogue,
// after the three engines have added their rows.
//
// gat_row_stats_kernel: for every row g*P + i (member g, row i) and head h,
//
//   m = LeakyReLU(s_i + max_j t_j)   (LeakyReLU is monotone, so this is the
//                                     row's largest e_ij: one segment max of
//                                     a scalar a head)
//   d = sum_j exp(LeakyReLU(s_i + t_j) - m)
//
// over cols[offsets[row] .. offsets[row + 1]). A row without a neighbour
// (class padding) gets m = d = 0, so its epilogue reads 0 / 0 nowhere: it
// writes 0 where d is 0. A warp owns a row: each lane walks every 32nd
// entry, then a butterfly of shuffles combines the lanes (every lane ends
// with the same bits, and the order depends on the row's length alone).
//
// gat_edge_coef_kernel: for every slot of the three layouts, one thread:
// its row i and column j from the layout's indices, and
//
//   p[h] = vals != 0 ? exp(LeakyReLU(s_i[h] + t_j[h]) - m_i[h]) : +0
//
// The layouts' values are the graph's pattern (1 on a stored entry), so a
// zero marks a slot that holds no entry: a zero of a dense tile, an ELL lane
// past its unit's K or a padded unit row, class padding's COO triples. The
// outputs are the layouts the multi-head engines read: dense [G, n_t, H, T,
// T] (each head's tile contiguous, as the tile copier reads it), ELL [G, U,
// R, Kmax, H] and COO [G, nnz, H] (a slot's heads together, as a lane loads
// its head's value).
//
// What bounds them: bytes. The statistics read each neighbour's index and
// H scores twice (the second pass mostly from L1/L2) and write 2H floats a
// row; the coefficients read a slot's value and indices and two rows of H
// scores, and write H floats. Float32 throughout, expf (not __expf), each
// operation rounded on its own: no atomics, every run the same bits.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace gat_coef {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : __fmul_rn(x, slope);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
gat_row_stats_kernel(const long long* __restrict__ offsets,
                     const int* __restrict__ cols,
                     const float* __restrict__ s,
                     const float* __restrict__ t, float* __restrict__ m,
                     float* __restrict__ d, long long rows, int P,
                     long long N, float slope) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long g = row / P;
  const long long begin = offsets[row], end = offsets[row + 1];
  const float* tg = t + g * N * H;
  float mx[H];
#pragma unroll
  for (int h = 0; h < H; ++h) mx[h] = -INFINITY;
  for (long long j = begin + lane; j < end; j += 32) {
    const float* tj = tg + static_cast<long long>(cols[j]) * H;
#pragma unroll
    for (int h = 0; h < H; ++h) mx[h] = fmaxf(mx[h], tj[h]);
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
  const bool live = end > begin;
  float si[H], mi[H], sum[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    si[h] = s[row * H + h];
    mi[h] = live ? leaky(__fadd_rn(si[h], mx[h]), slope) : 0.f;
    sum[h] = 0.f;
  }
  for (long long j = begin + lane; j < end; j += 32) {
    const float* tj = tg + static_cast<long long>(cols[j]) * H;
#pragma unroll
    for (int h = 0; h < H; ++h)
      sum[h] = __fadd_rn(
          sum[h],
          expf(__fsub_rn(leaky(__fadd_rn(si[h], tj[h]), slope), mi[h])));
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], off));
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      m[row * H + h] = mi[h];
      d[row * H + h] = live ? sum[h] : 0.f;
    }
  }
}

// The three layouts' slots as the coefficient kernel reads them.
struct Layouts {
  // dense tiles: [G, n_t, T, T] values, [G, n_t] tile rows and columns
  const float* tiles;
  const int* tile_row;
  const int* tile_col;
  long long n_t;
  // ELL units: [G, U, R, K] values and tile-local columns, [G, U, R] rows,
  // [G, U] column tiles
  const float* ell_vals;
  const int* ell_cols;
  const int* ell_rows;
  const int* ell_tile_col;
  long long U;
  int R, K;
  // COO entries: [G, nnz] values, rows and columns
  const float* coo_vals;
  const int* coo_rows;
  const int* coo_cols;
  long long nnz;
  int T;
};

template <int H>
__device__ __forceinline__ void coef(const float* __restrict__ s,
                                     const float* __restrict__ t,
                                     const float* __restrict__ m,
                                     long long g, long long row,
                                     long long col, int P, long long N,
                                     float slope, bool on, float* out,
                                     long long stride) {
  if (!on) {
#pragma unroll
    for (int h = 0; h < H; ++h) out[h * stride] = 0.f;
    return;
  }
  const float* sr = s + (g * P + row) * H;
  const float* mr = m + (g * P + row) * H;
  const float* tc = t + (g * N + col) * H;
#pragma unroll
  for (int h = 0; h < H; ++h)
    out[h * stride] =
        expf(__fsub_rn(leaky(__fadd_rn(sr[h], tc[h]), slope), mr[h]));
}

// One thread a slot: slots [0, G*Sd) are the dense tiles' elements, the
// next G*Se the ELL lanes, the last G*nnz the COO entries.
template <int H>
__global__ void __launch_bounds__(kThreads)
gat_edge_coef_kernel(Layouts a, const float* __restrict__ s,
                     const float* __restrict__ t,
                     const float* __restrict__ m, float* __restrict__ dense,
                     float* __restrict__ ell, float* __restrict__ coo,
                     int G, int P, long long N, float slope) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long tt = static_cast<long long>(a.T) * a.T;
  const long long nd = G * a.n_t * tt;
  const long long se = a.U * a.R * a.K;
  const long long ne = G * se;
  if (i < nd) {
    const long long tile = i / tt;  // g * n_t + the member's tile
    const long long rc = i % tt;
    const long long g = tile / a.n_t;
    const long long row = a.tile_row[tile] * static_cast<long long>(a.T) +
                          rc / a.T;
    const long long col = a.tile_col[tile] * static_cast<long long>(a.T) +
                          rc % a.T;
    coef<H>(s, t, m, g, row, col, P, N, slope, a.tiles[i] != 0.f,
            dense + tile * H * tt + rc, tt);
    return;
  }
  const long long j = i - nd;
  if (j < ne) {
    const long long g = j / se;
    const long long unit_row = j / a.K;  // over the group: (g*U + u)*R + r
    const long long unit = unit_row / a.R;
    const bool on = a.ell_vals[j] != 0.f;
    const long long row = on ? a.ell_rows[unit_row] : 0;
    const long long col =
        on ? a.ell_tile_col[unit] * static_cast<long long>(a.T) +
                 a.ell_cols[j]
           : 0;
    coef<H>(s, t, m, g, row, col, P, N, slope, on, ell + j * H, 1);
    return;
  }
  const long long k = j - ne;
  if (k < G * a.nnz) {
    const long long g = k / a.nnz;
    const bool on = a.coo_vals[k] != 0.f;
    coef<H>(s, t, m, g, on ? a.coo_rows[k] : 0, on ? a.coo_cols[k] : 0, P,
            N, slope, on, coo + k * H, 1);
  }
}

// f(std::integral_constant<int, H>) for a built head count (4 or 6, the
// served GAT's: kernels/_build.py HEADS); else cudaErrorInvalidValue.
template <class F>
cudaError_t heads(int h, F&& f) {
  switch (h) {
    case 4: return f(std::integral_constant<int, 4>());
    case 6: return f(std::integral_constant<int, 6>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gat_coef

extern "C" {

// offsets [rows + 1] int64 (rows = G * P), cols [E] int32 (< N), s/m/d
// [G, P, H], t [G, N, H] float contiguous; H 4 or 6.
int gat_row_stats_f32(const void* offsets, const void* cols, const void* s,
                      const void* t, void* m, void* d, long long rows, int P,
                      long long N, int H, float slope, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gat_coef::heads(H, [&](auto h) {
    constexpr int kH = decltype(h)::value;
    const long long blocks =
        (rows + gat_coef::kRowsPerBlock - 1) / gat_coef::kRowsPerBlock;
    gat_coef::gat_row_stats_kernel<kH>
        <<<dim3(static_cast<unsigned>(blocks)), gat_coef::kThreads, 0, st>>>(
            static_cast<const long long*>(offsets),
            static_cast<const int*>(cols), static_cast<const float*>(s),
            static_cast<const float*>(t), static_cast<float*>(m),
            static_cast<float*>(d), rows, P, N, slope);
    return cudaGetLastError();
  }));
}

// The layouts (see gat_coef::Layouts; every array contiguous, the values
// float), s/m [G, P, H], t [G, N, H] and the outputs dense [G, n_t, H, T,
// T], ell [G, U, R, K, H], coo [G, nnz, H]; H 4 or 6.
int gat_edge_coef_f32(const void* tiles, const void* tile_row,
                      const void* tile_col, long long n_t,
                      const void* ell_vals, const void* ell_cols,
                      const void* ell_rows, const void* ell_tile_col,
                      long long U, int R, int K, const void* coo_vals,
                      const void* coo_rows, const void* coo_cols,
                      long long nnz, int T, const void* s, const void* t,
                      const void* m, void* dense, void* ell, void* coo, int G,
                      int P, long long N, int H, float slope, void* stream) {
  const gat_coef::Layouts a{
      static_cast<const float*>(tiles), static_cast<const int*>(tile_row),
      static_cast<const int*>(tile_col), n_t,
      static_cast<const float*>(ell_vals), static_cast<const int*>(ell_cols),
      static_cast<const int*>(ell_rows),
      static_cast<const int*>(ell_tile_col), U, R, K,
      static_cast<const float*>(coo_vals), static_cast<const int*>(coo_rows),
      static_cast<const int*>(coo_cols), nnz, T};
  auto st = static_cast<cudaStream_t>(stream);
  const long long slots = G * (n_t * T * T + U * R * K + nnz);
  if (slots == 0) return 0;
  return static_cast<int>(gat_coef::heads(H, [&](auto h) {
    constexpr int kH = decltype(h)::value;
    const long long blocks =
        (slots + gat_coef::kThreads - 1) / gat_coef::kThreads;
    gat_coef::gat_edge_coef_kernel<kH>
        <<<dim3(static_cast<unsigned>(blocks)), gat_coef::kThreads, 0, st>>>(
            a, static_cast<const float*>(s), static_cast<const float*>(t),
            static_cast<const float*>(m), static_cast<float*>(dense),
            static_cast<float*>(ell), static_cast<float*>(coo), G, P, N,
            slope);
    return cudaGetLastError();
  }));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
