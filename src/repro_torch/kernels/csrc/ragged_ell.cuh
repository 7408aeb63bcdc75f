// The ragged ELL row kernel (ragged_ell_spmm.cu says what it computes)
// and its launch, for every type of vals (VT) and B (BT): float or
// __nv_bfloat16. ragged_ell_spmm.cu builds the float instances, and
// ragged_ell_spmm_<vals>_<B>.cu each pair with a bfloat16 operand.
#pragma once

#include "ell_rows.cuh"

namespace ragged_ell {

// One grid row: a live segment of the plan (row mode) or a unit row (unit
// mode, `live` null), walked in MODE (kBanded or kTable); H values an entry
// (ell_rows::row).
template <int MODE, int W, int VEC, int KC, class VT, class BT, int H = 1>
__device__ __forceinline__ void rows(const ell_rows::Units<VT>& a,
                                     const BT* __restrict__ b,
                                     const long long* __restrict__ order,
                                     const long long* __restrict__ offsets,
                                     const long long* __restrict__ live,
                                     float* __restrict__ out, int slot,
                                     int n_slots, int nct, int T, int F) {
  const long long g = blockIdx.y;
  if (slot >= n_slots) return;
  long long s;
  int begin, end;
  if (live) {
    s = live[g * n_slots + slot];
    if (s < 0) return;  // past this member's last live segment
    begin = static_cast<int>(offsets[s]);
    end = static_cast<int>(offsets[s + 1]);
  } else {
    s = g * a.U * a.R + slot;
    begin = static_cast<int>(s);
    end = begin + 1;
  }
  if (live)
    ell_rows::row<W, VEC, KC, MODE, true, VT, BT, H>(a, b, order, begin, end,
                                                     g, nct, T, F,
                                                     out + s * F);
  else
    ell_rows::row<W, VEC, KC, MODE, false, VT, BT, H>(a, b, order, begin,
                                                      end, g, nct, T, F,
                                                      out + s * F);
}

// W lanes per segment, VEC features per lane, KC K lanes in flight,
// THREADS per block. `live` null = unit mode. Minimum one block per SM:
// ptxas then allocates what the row loop needs and spills nothing
// (ell_rows.cuh). ell_rows_kernel takes at most 4 bands by value (`a.bands`,
// kBanded); ell_rows_table_kernel reads each unit's band K from the [U]
// table `a.bound_k` (kTable), for a plan of more bands.
template <int W, int VEC, int KC, int THREADS, class VT, class BT>
__global__ void __launch_bounds__(THREADS, 1)
ell_rows_kernel(ell_rows::Units<VT> a, const BT* __restrict__ b,
                const long long* __restrict__ order,
                const long long* __restrict__ offsets,
                const long long* __restrict__ live, float* __restrict__ out,
                int n_slots, int nct, int T, int F) {
  rows<ell_rows::kBanded, W, VEC, KC>(
      a, b, order, offsets, live, out,
      blockIdx.x * (THREADS / W) + threadIdx.x / W, n_slots, nct, T, F);
}

template <int W, int VEC, int KC, int THREADS, class VT, class BT>
__global__ void __launch_bounds__(THREADS, 1)
ell_rows_table_kernel(ell_rows::Units<VT> a, const BT* __restrict__ b,
                      const long long* __restrict__ order,
                      const long long* __restrict__ offsets,
                      const long long* __restrict__ live,
                      float* __restrict__ out, int n_slots, int nct, int T,
                      int F) {
  rows<ell_rows::kTable, W, VEC, KC>(
      a, b, order, offsets, live, out,
      blockIdx.x * (THREADS / W) + threadIdx.x / W, n_slots, nct, T, F);
}

// The multi-head instances (float vals [G, U, R, Kmax, H] and B): row mode,
// the default launch shape, H values an entry, each unit to its band's K
// (by value, or from the [U] table past 4 bands).
template <int W, int VEC, int H>
__global__ void __launch_bounds__(ell_rows::kDefaultThreads, 1)
ell_rows_heads_kernel(ell_rows::Units<float> a, const float* __restrict__ b,
                      const long long* __restrict__ order,
                      const long long* __restrict__ offsets,
                      const long long* __restrict__ live,
                      float* __restrict__ out, int n_slots, int nct, int T,
                      int F) {
  rows<ell_rows::kBanded, W, VEC, ell_rows::kDefaultKC, float, float, H>(
      a, b, order, offsets, live, out,
      blockIdx.x * (ell_rows::kDefaultThreads / W) + threadIdx.x / W,
      n_slots, nct, T, F);
}

template <int W, int VEC, int H>
__global__ void __launch_bounds__(ell_rows::kDefaultThreads, 1)
ell_rows_heads_table_kernel(ell_rows::Units<float> a,
                            const float* __restrict__ b,
                            const long long* __restrict__ order,
                            const long long* __restrict__ offsets,
                            const long long* __restrict__ live,
                            float* __restrict__ out, int n_slots, int nct,
                            int T, int F) {
  rows<ell_rows::kTable, W, VEC, ell_rows::kDefaultKC, float, float, H>(
      a, b, order, offsets, live, out,
      blockIdx.x * (ell_rows::kDefaultThreads / W) + threadIdx.x / W,
      n_slots, nct, T, F);
}

// One launch (the C entries' arguments, ragged_ell_spmm.cu). `band_k` null:
// `bands` is a host array of 7 ints, the bands' Ks, then the offsets
// (ell_rows::Bands); else `band_k` is the [U] table of each unit's band K on
// the card and `bands` is not read.
template <class VT, class BT>
cudaError_t launch(const void* cols, const void* vals, const void* tile_col,
                   const void* unit_k, const void* b, const void* order,
                   const void* offsets, const void* live, void* out,
                   const int* bands, const void* band_k, int G, int n_slots,
                   int U, int R, int Kmax, int nct, int T, int F, int w,
                   int vec, int kc, int threads, void* stream) {
  ell_rows::Bands bd{};
  if (!band_k) {
    for (int i = 0; i < 4; ++i) bd.k[i] = bands[i];
    for (int i = 0; i < 3; ++i) bd.off[i] = bands[4 + i];
  }
  ell_rows::Units<VT> a{static_cast<const int*>(cols),
                        static_cast<const VT*>(vals),
                        static_cast<const int*>(tile_col),
                        static_cast<const int*>(unit_k),
                        static_cast<const int*>(band_k), bd, 0, 0, 0, U, R,
                        Kmax};
  const auto* bb = static_cast<const BT*>(b);
  const auto* od = static_cast<const long long*>(order);
  const auto* of = static_cast<const long long*>(offsets);
  const auto* lv = static_cast<const long long*>(live);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return ell_rows::select_shape(
      F, ell_rows::vec_aligned<BT>(b, out), w, vec, kc, threads,
      [&](auto w_, auto vec_, auto kc_, auto threads_) {
        constexpr int W = decltype(w_)::value;
        constexpr int VEC = decltype(vec_)::value;
        constexpr int KC = decltype(kc_)::value;
        constexpr int THREADS = decltype(threads_)::value;
        constexpr int per_block = THREADS / W;
        const dim3 grid((n_slots + per_block - 1) / per_block, G);
        if (band_k)
          ell_rows_table_kernel<W, VEC, KC, THREADS, VT, BT>
              <<<grid, THREADS, 0, st>>>(a, bb, od, of, lv, o, n_slots, nct,
                                         T, F);
        else
          ell_rows_kernel<W, VEC, KC, THREADS, VT, BT>
              <<<grid, THREADS, 0, st>>>(a, bb, od, of, lv, o, n_slots, nct,
                                         T, F);
        return cudaGetLastError();
      });
}

}  // namespace ragged_ell

// A source's C entries: ragged_ell_rows_<SUFFIX> for vals of type VT and B
// of type BT (the arguments are ragged_ell_rows_f32's, ragged_ell_spmm.cu;
// vec 4 needs b aligned to 4 of its elements), and cuda_error_string.
#define RAGGED_ELL_ENTRIES(SUFFIX, VT, BT)                                   \
  extern "C" {                                                               \
  int ragged_ell_rows_##SUFFIX(                                              \
      const void* cols, const void* vals, const void* tile_col,              \
      const void* unit_k, const void* b, const void* order,                  \
      const void* offsets, const void* live, void* out, const int* bands,    \
      const void* band_k, int G, int n_slots, int U, int R, int Kmax,        \
      int nct, int T, int F, int w, int vec, int kc, int threads,            \
      void* stream) {                                                        \
    return static_cast<int>(ragged_ell::launch<VT, BT>(                      \
        cols, vals, tile_col, unit_k, b, order, offsets, live, out, bands,   \
        band_k, G, n_slots, U, R, Kmax, nct, T, F, w, vec, kc, threads,      \
        stream));                                                            \
  }                                                                          \
  const char* cuda_error_string(int err) {                                   \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                \
  }                                                                          \
  }
