// The row machinery of the ELL kernels, for Hopper (sm_90a): one loop over
// a padded row's unit rows that computes each unit row's product and adds
// it onto the row's sum. Both ELL sources include it:
//
//   ragged_ell_spmm.cu  the ragged unit array [G, U, R, Kmax] (kBanded, or
//                       kTable past 4 bands): each unit to the K of its
//                       band, the values masked by the per-unit live K
//                       (`unit_k`): the main path;
//   ell_spmm.cu         the same array with each unit to the K of its fixed-K
//                       bucket (kBucketed, `bucket_k`, no value mask): the
//                       "fused"/"loop" dispatches, one launch a layer; and
//                       one bucket's view [G, U_b, R, K_b] read in place
//                       through its strides (kView, K_b the bound): the TPU
//                       kernel's own per-bucket function.
//
// For a unit row e of unit u the product is one chain from +0, in ascending
// kk < kb(u),
//
//   p_e[:] = p_e[:] + (kk < unit_k ? vals[e,kk] : 0) * B[tile_col, cols[e,kk], :]
//
// with multiply and add rounded on their own (__fmul_rn / __fadd_rn, never
// contracted into an FMA); the mask sits on the values, so a masked lane
// still multiplies 0 by its B row (a non-finite B row propagates, as in the
// reference). kb(u) is, for kBanded, the K of u's band: the partition's
// descending (K, n_units) runs merged to at most max_bands bands (the
// reference's `_bands_of`), at most 4 of them passed by value (`Bands`), u's
// band being sum(u >= off), as the TPU kernel `_ragged_ell_kernel` selects
// its chain; lanes in [band K, Kmax) are never read, exactly as there. For
// kTable (a plan of more than 4 bands) kb(u) = bound_k[u], the same band K
// read from a [U] table, with the same value mask. For kBucketed kb(u) =
// bound_k[u], the K of u's bucket, and every lane below it is live (unit_k
// <= K_b and the slab's lanes past unit_k hold 0); for kView it is the
// view's K_b. The row's sum is acc = acc + p_e over its unit rows in plan
// order, from +0.
//
// Bits. With finite B a lane past unit_k adds 0 * x = +-0 to a chain that
// starts at +0 and is never -0 (x + y is -0 only when both are), so where
// the chain stops past unit_k does not change its bits: the banded chain,
// the Kmax chain and the bucket's chain agree bit for bit on finite B, and
// so do kBanded and kTable at any number of bands.
//
// What bounds it on the H100: bytes. An entry does K multiply-adds per
// feature on K gathered B rows, about a quarter of an operation per byte,
// far below the ~20 FLOP/byte where float32 FMA (67 TFLOP/s) would
// overtake device memory (3.35 TB/s); the IEEE float32 parity path has TF32
// off, so tensor cores do not apply. B for one layer (2 MB at cora, 16 MB
// at pubmed per member) lives in the 50 MB L2, so the rows an entry
// gathers are mostly L2 hits. At the main path's shapes the work is below
// the launch floor, so the design reads only what the sums need.
//
// Design. A group of W lanes owns one padded row; lanes run over features,
// VEC contiguous elements each (one 16-byte load of 4 floats, or one
// 8-byte load of 4 bfloat16, when the row stride allows; else one
// element). For each unit row the group reads its tile_col (and unit_k,
// bound_k or both), then, W lanes of the K axis at a time up to kb(u), lane i
// loads cols/vals of K lane k1+i (one coalesced load) and passes them
// round with shuffles in chunks of KC; every lane issues a chunk's KC
// independent B-row loads before its multiply-add chain, so KC loads are
// in flight per lane and a chunk waits on one round trip, its B rows'
// (were each chunk to load its own cols/vals first, that would be two
// round trips a chunk on the entry's critical path). Only the B rows
// the entry addresses are read (no [T, F] slab is staged), and each output
// row is written once, by one thread per feature: no atomics, no shared
// memory.
//
// The launch shape: W (8, 16 or 32 lanes per row), VEC (1 or 4), KC (2, 4
// or 8) and the threads per block (128, 256 or 512) are template arguments.
// None of them changes a sum's order (each feature's chain runs in
// ascending kk from +0, and acc takes the unit rows in plan order), so
// every instance gives the same bits. The defaults: W by F (8 lanes for
// F <= 8, 16 for F <= 16, so a narrow row does not leave most of a warp
// idle, else 32), VEC 4 at W = 32 where the rows allow it, KC = 4 and 256
// threads. The ragged kernel takes all four as launch knobs (its
// autotuner sweeps them); the fixed-K kernel runs the defaults. The band
// table adds seven ints to the ragged kernel's arguments and three
// compares a unit row, read from the parameter bank, not loaded; past 4
// bands it is one 4-byte load a unit row from the [U] table instead.
//
// Types. vals (VT) and B (BT) are float or __nv_bfloat16, template
// arguments of the row loop. A bfloat16 value is widened to float where it
// is loaded (exactly: bfloat16 is the upper half of a float32), and the
// chain above runs on the widened values, so an instance that reads
// bfloat16 gives, bit for bit, what the float instance gives on the same
// values stored as float: the reference's kernels upcast both operands
// before they multiply. The sums and the output rows are float.
//
// Registers. Both kernels declare __launch_bounds__(threads, 1). With the
// block size alone, ptxas held some instances at an occupancy step (64,
// 48 or 40 registers) and spilled 4-36 bytes to get there, the defaults
// among them (a 64-bit pointer stored before the loops and reloaded
// after each row's entry loop). With a minimum of one block per SM no
// instance spills: 56-112 registers (the 16-byte KC = 8 instances the
// most), 86 at the ragged kernel's 16-byte float default (2 blocks of 256
// an SM) and 78 at the fixed-K kernel's (ptxas for sm_90a). The
// contract audit rejects any instance that spills.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace ell_rows {

constexpr int kDefaultThreads = 256;  // threads per block
constexpr int kDefaultKC = 4;  // K lanes whose B rows are in flight at once

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T load(const float* p) { return *p; }
  __device__ static void store(float* p, T v) { *p = v; }
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void set(T& v, int, float x) { v = x; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static void set(T& v, int i, float x) {
    if (i == 0) v.x = x;
    else if (i == 1) v.y = x;
    else if (i == 2) v.z = x;
    else v.w = x;
  }
};

// VEC elements of a B row of type BT, loaded at once and read as floats.
template <class BT, int VEC>
struct BLoad;
template <int VEC>
struct BLoad<float, VEC> {
  using T = typename Vec<VEC>::T;
  __device__ static T load(const float* p) { return Vec<VEC>::load(p); }
  __device__ static float get(const T& v, int i) {
    return Vec<VEC>::get(v, i);
  }
};
template <>
struct BLoad<__nv_bfloat16, 1> {
  using T = __nv_bfloat16;
  __device__ static T load(const __nv_bfloat16* p) { return *p; }
  __device__ static float get(const T& v, int) { return __bfloat162float(v); }
};
template <>
struct BLoad<__nv_bfloat16, 4> {
  using T = uint2;  // 4 bfloat16, the first in the low half of x
  __device__ static T load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ static float get(const T& v, int i) {
    const unsigned w = i < 2 ? v.x : v.y;
    return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
  }
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// How a row loop walks its unit rows (row<..., MODE, ...>).
enum Mode {
  kBanded = 0,    // the ragged array, each unit to its band's K, masked
  kBucketed = 1,  // the ragged array, each unit to its bucket's K
  kView = 2,      // one bucket's strided view, its K the bound
  kTable = 3,     // the ragged array, each unit to its band's K from a
                  // [U] table (more than 4 bands), masked
};

// The ragged kernel's K bands (at most 4), by value: the K of each band
// (0 past the last) and the first unit of bands 1..3 (INT_MAX past the
// last), so unit u's band is the number of offsets it has reached.
struct Bands {
  int k[4];
  int off[3];
  __device__ __forceinline__ int bound(int u) const {
    return u >= off[2] ? k[3] : u >= off[1] ? k[2] : u >= off[0] ? k[1] : k[0];
  }
};

// The unit array as a kernel reads it; VT is the type of vals.
template <class VT>
struct Units {
  const int* cols;      // [G, U, R, K...] tile-local columns
  const VT* vals;       // same layout as cols
  const int* tile_col;  // [G, U]
  const int* unit_k;    // kBanded, kTable: [G, U] live K per unit (the
                        // value mask)
  const int* bound_k;   // [U] the K of each unit's bucket (kBucketed) or
                        // band (kTable)
  Bands bands;          // kBanded: the band table
  long long s_g;        // kView: member stride of cols/vals (elements)
  long long tc_sg;      // kView: member stride of tile_col
  int s_r;              // kView: row stride of cols/vals; a unit's R rows
                        // are packed (unit stride R * s_r), K contiguous
  int U, R, K;          // K: Kmax (the ragged array) or the view's K
};

// Stores and adds of VEC floats at p.
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  typename Vec<VEC>::T r;
#pragma unroll
  for (int q = 0; q < VEC; ++q) Vec<VEC>::set(r, q, x[q]);
  Vec<VEC>::store(p, r);
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float (&x)[VEC]) {
  typename Vec<VEC>::T r = Vec<VEC>::load(p);
#pragma unroll
  for (int q = 0; q < VEC; ++q)
    Vec<VEC>::set(r, q, __fadd_rn(Vec<VEC>::get(r, q), x[q]));
  Vec<VEC>::store(p, r);
}

// One padded row of member g: for each block of W*VEC features, acc
// starts at +0, takes the products of the unit rows order[begin..end)
// (order null: the entries begin..end themselves) in that order, and is
// added onto dst[f..] (ADD) or stored there. KC K lanes have their B rows
// in flight at once.
// kBanded / kTable / kBucketed: entries e number the unit rows over the group
// (g*U*R + u*R + r) of a contiguous ragged array. kView: entries number
// member g's unit rows (u*R + r) of a bucket view with member stride s_g
// and row stride s_r. MODE and ADD are template arguments, not flags, so
// that no register holds them through the loop: a caller with both
// epilogues or walks instantiates both.
// H > 1 (multi-head values, the slab modes): vals holds H values a lane,
// [.., K, H], and feature f is multiplied by the value of its head f / (F /
// H); each lane loads its own head's value where the chunk's B rows are
// loaded (the lanes of a head read one address), in place of the shuffle.
// A lane's VEC features lie in one head (VEC = 1 where F / H % 4 != 0).
// H = 1 compiles to the single-value loop alone.
template <int W, int VEC, int KC, int MODE, bool ADD, class VT, class BT,
          int H = 1>
__device__ __forceinline__ void row(const Units<VT>& a, const BT* b,
                                    const long long* __restrict__ order,
                                    int begin, int end, long long g, int nct,
                                    int T, int F, float* dst) {
  static_assert(KC <= W && W % KC == 0,
                "a chunk's cols/vals are spread over the group");
  static_assert(H == 1 || MODE != kView, "heads read the slab");
  constexpr bool SLAB = MODE != kView;
  using V = BLoad<BT, VEC>;
  const int lane = threadIdx.x % W;
  const unsigned mask =
      W == 32 ? 0xffffffffu
              : ((1u << W) - 1u) << ((threadIdx.x % 32) / W * W);
  const BT* bg = b + g * nct * static_cast<long long>(T) * F;
  // the member's unit array: entry e's lanes start at e * stride
  const int* cb = SLAB ? a.cols : a.cols + g * a.s_g;
  const VT* vb = SLAB ? a.vals : a.vals + g * a.s_g;
  const int* tb = SLAB ? a.tile_col : a.tile_col + g * a.tc_sg;
  const int stride = SLAB ? a.K : a.s_r;
  const int u0 = SLAB ? static_cast<int>(g) * a.U : 0;  // member's 1st unit

  for (int fb = 0; fb < F; fb += W * VEC) {
    const int f = fb + lane * VEC;
    const bool on = f < F;
    const int hd = H > 1 && on ? f / (F / H) : 0;  // this lane's head
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    for (int j = begin; j < end; ++j) {
      // entries, units and plan positions are numbered in 32 bits (the
      // wrappers check it): a 64-bit division costs far more than a load
      const int e = order ? static_cast<int>(order[j]) : j;
      const int unit = e / a.R;
      int kb, ku;  // the chain's lanes, and the live lanes among them
      if constexpr (MODE == kBanded) {
        kb = a.bands.bound(unit - u0);
        ku = a.unit_k[unit];
      } else if constexpr (MODE == kTable) {
        kb = a.bound_k[unit - u0];
        ku = a.unit_k[unit];
      } else if constexpr (MODE == kBucketed) {
        kb = a.bound_k[unit - u0];
        ku = kb;
      } else {
        kb = ku = a.K;
      }
      const BT* bt = bg + static_cast<long long>(tb[unit]) * T * F + f;
      const int* ce = cb + static_cast<long long>(e) * stride;
      const VT* ve = vb + static_cast<long long>(e) * stride * H;
      float p[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) p[q] = 0.f;
      for (int k1 = 0; k1 < kb; k1 += W) {
        // lane i holds cols/vals of K lane k1 + i, read once (coalesced)
        // and passed round the group chunk by chunk
        int c = 0;
        float v = 0.f;
        if (k1 + lane < kb) {
          c = ce[k1 + lane];
          if constexpr (H == 1)
            v = k1 + lane < ku ? widen(ve[k1 + lane]) : 0.f;  // mask values
        }
        const int n = min(W, kb - k1);
        for (int k0 = 0; k0 < n; k0 += KC) {  // KC divides W: k0 + i < W
          typename V::T x[KC];
          float vh[KC];  // H > 1: this lane's head's values, masked
#pragma unroll
          for (int i = 0; i < KC; ++i) {
            const int ci = __shfl_sync(mask, c, k0 + i, W);
            if (on && k0 + i < n) x[i] = V::load(bt + ci * F);
            if constexpr (H > 1) {
              const int kk = k1 + k0 + i;
              vh[i] = on && k0 + i < n && kk < ku ? widen(ve[kk * H + hd])
                                                  : 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < KC; ++i) {
            float vi;
            if constexpr (H == 1)
              vi = __shfl_sync(mask, v, k0 + i, W);
            else
              vi = vh[i];
            if (on && k0 + i < n) {
#pragma unroll
              for (int q = 0; q < VEC; ++q)
                p[q] = __fadd_rn(p[q], __fmul_rn(vi, V::get(x[i], q)));
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], p[q]);
    }
    if (on) {
      if constexpr (ADD)
        add_vec<VEC>(dst + f, acc);
      else
        store_vec<VEC>(dst + f, acc);
    }
  }
}

// Lanes per row (W) and elements per lane (VEC) for a row of F features
// whose pointers are `aligned` for VEC = 4 (vec_aligned), the defaults:
// returns launch(W, VEC), the two passed as std::integral_constant.
template <class Launch>
cudaError_t pick(int F, bool aligned, Launch launch) {
  using W8 = std::integral_constant<int, 8>;
  using W16 = std::integral_constant<int, 16>;
  using W32 = std::integral_constant<int, 32>;
  using V1 = std::integral_constant<int, 1>;
  using V4 = std::integral_constant<int, 4>;
  if (F <= 8) return launch(W8(), V1());
  if (F <= 16) return launch(W16(), V1());
  if (F % 4 == 0 && aligned) return launch(W32(), V4());
  return launch(W32(), V1());
}

// f(std::integral_constant<int, v>) for the v of Vs... that equals x;
// cudaErrorInvalidValue when none does (x is not an instance).
template <int... Vs, class F>
cudaError_t select(int x, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((x == Vs ? (err = f(std::integral_constant<int, Vs>()), true)
                  : false) ||
         ...);
  return err;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// VEC = 4 reads 4 elements of B (16 bytes of float, 8 of bfloat16) and
// writes 4 floats of the output at once.
template <class BT>
inline bool vec_aligned(const void* b, const void* out) {
  return reinterpret_cast<uintptr_t>(b) % (4 * sizeof(BT)) == 0 &&
         aligned16(out);
}

// f(std::integral_constant<int, ...>) for the launch shape (w, vec, kc,
// threads), each one of the built values (0 takes the default; vec 4
// needs F % 4 == 0 and `aligned`); cudaErrorInvalidValue without a call
// where one is not.
template <class Launch>
cudaError_t select_shape(int F, bool aligned, int w, int vec, int kc,
                         int threads, Launch launch) {
  if (w == 0) w = F <= 8 ? 8 : F <= 16 ? 16 : 32;
  if (vec == 0) vec = w == 32 && F % 4 == 0 && aligned ? 4 : 1;
  if (kc == 0) kc = kDefaultKC;
  if (threads == 0) threads = kDefaultThreads;
  if (vec == 4 && (F % 4 != 0 || !aligned)) return cudaErrorInvalidValue;
  return select<8, 16, 32>(w, [&](auto w_) {
    return select<1, 4>(vec, [&](auto vec_) {
      return select<2, 4, 8>(kc, [&](auto kc_) {
        return select<128, 256, 512>(threads, [&](auto threads_) {
          return launch(w_, vec_, kc_, threads_);
        });
      });
    });
  });
}

}  // namespace ell_rows
