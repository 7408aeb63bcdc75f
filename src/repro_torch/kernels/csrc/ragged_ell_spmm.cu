// Ragged ELL SpMM: the sparse engine of the tri-partition, for Hopper
// (sm_90a), with the sum onto output rows and the add onto the dense
// engine's rows inside the kernel.
//
// Replaces the TPU kernel `_ragged_ell_kernel` / `ragged_ell_spmm`
// (src/repro/kernels/ell_spmm.py) together with the segment sum that the
// reference's `ell_matmul` applies to its per-unit products and the add of
// that sum onto the dense engine's partial product. An entry e = (g, u, r)
// of the unit array is one unit row; its product is
//
//   p_e[:] = sum_{kk < Kmax} (kk < unit_k[g,u] ? vals[e,kk] : 0)
//            * B[g, tile_col[g,u], cols[e,kk], :]
//
// Row mode (the main path, `ragged_ell_rows`): for every live segment s of
// the host-built reduction plan (entries stably sorted by output row, the
// sentinel row dropped; `live` lists, per member, the segments with at
// least one entry),
//
//   out[s,:] = out[s,:] + sum over j in [offsets[s], offsets[s+1]) of
//              p_{order[j]}
//
// where out holds the dense engine's rows on entry. Unit mode (the TPU
// kernel's own function, `ragged_ell_spmm`): no plan, every unit row is its
// own segment and out[e,:] = p_e (no addend).
//
// Order of additions (each multiply and add rounded on its own, __fmul_rn /
// __fadd_rn, never contracted into an FMA): p_e is one chain from +0 in
// ascending kk up to Kmax, with the mask on the values, as the plain version
// and the parent kernel run it (a masked lane still multiplies 0 by its B
// row, so a non-finite B row propagates as in the reference); acc is a chain
// from +0 over the segment's p_e in plan order, which is what
// torch.segment_reduce adds; then one add out = out + acc, the `yd + ye` of
// the parent. The result equals the unit-mode products summed by
// `segment_sum` and added to the dense rows, bit for bit.
//
// Rows without an ELL entry are not touched. That equals `yd + 0` bit for
// bit: yd comes from the dense engine, whose every element is a chain of
// round-to-nearest adds started from +0 (or +0 itself where a row tile has
// no tile), and such a chain is never -0 (x + y is -0 only when both are
// -0), so yd + (+0) = yd. NaN rows stay NaN.
//
// What bounds it on the H100: bytes. An entry does Kmax multiply-adds per
// feature on Kmax gathered B rows, about a quarter of an operation per byte,
// far below the ~20 FLOP/byte where float32 FMA (67 TFLOP/s) would overtake
// device memory (3.35 TB/s). B for one layer (2 MB at cora, 16 MB at pubmed
// per member) lives in the 50 MB L2, so the rows an entry gathers are
// mostly L2 hits.
//
// Design. A group of W lanes owns one live segment; lanes run over
// features, VEC contiguous floats each (one 16-byte load when the row
// stride allows, else 4 bytes). Grid: (live slots / segments per block,
// G), so one launch covers the group. For each entry of its segment the
// group reads the entry's tile_col and unit_k, then, in chunks of KC lanes
// of the Kmax axis, lane i loads cols/vals of lane k0+i (coalesced) and
// passes them round with shuffles; every lane then issues the chunk's KC
// independent B-row loads before its multiply-add chain, so KC loads are in
// flight per lane. KC = 4: with 8, the 16-byte variant needed 80 registers
// and spilled, so only 3 blocks fit an SM and a cora group of 4 (3840 live
// rows) took two waves. Only the B rows the entry addresses are read (no
// [T, F] slab is staged), and each output row is written once, by one
// thread per feature: no atomics, no shared memory. W is picked per launch
// from F: 8 lanes for F <= 8, 16 for F <= 16 (several segments per warp, so
// a narrow row does not leave most of a warp idle), else 32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int KC = 4;  // Kmax lanes whose B rows are in flight at once

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

// W lanes per segment, VEC features per lane. `live` null = unit mode.
template <int W, int VEC>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                const int* __restrict__ tile_col,
                const int* __restrict__ unit_k, const float* __restrict__ b,
                const long long* __restrict__ order,
                const long long* __restrict__ offsets,
                const long long* __restrict__ live, float* __restrict__ out,
                int n_slots, int U, int R, int Kmax, int nct, int T, int F) {
  static_assert(KC <= W, "a chunk's cols/vals are spread over the group");
  using V = Vec<VEC>;
  const int slot = blockIdx.x * (kThreads / W) + threadIdx.x / W;
  const long long g = blockIdx.y;
  if (slot >= n_slots) return;
  long long s, begin, end;
  if (live) {
    s = live[g * n_slots + slot];
    if (s < 0) return;  // past this member's last live segment
    begin = offsets[s];
    end = offsets[s + 1];
  } else {
    s = g * U * R + slot;
    begin = s;
    end = s + 1;
  }
  const int lane = threadIdx.x % W;
  const unsigned mask =
      W == 32 ? 0xffffffffu
              : ((1u << W) - 1u) << ((threadIdx.x % 32) / W * W);
  const float* bg = b + g * nct * static_cast<long long>(T) * F;

  for (int fb = 0; fb < F; fb += W * VEC) {
    const int f = fb + lane * VEC;
    const bool on = f < F;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (long long j = begin; j < end; ++j) {
      // entries and units are numbered in 32 bits (the wrapper checks
      // G*U*R < 2^31): a 64-bit division costs far more than a load
      const int e = static_cast<int>(order ? order[j] : j);
      const int unit = e / R;
      const int ku = unit_k[unit];
      const float* bt =
          bg + static_cast<long long>(tile_col[unit]) * T * F + f;
      const int* ce = cols + static_cast<long long>(e) * Kmax;
      const float* ve = vals + static_cast<long long>(e) * Kmax;
      float p[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) p[i] = 0.f;
      for (int k0 = 0; k0 < Kmax; k0 += KC) {
        int c = 0;
        float v = 0.f;
        if (lane < KC && k0 + lane < Kmax) {
          c = ce[k0 + lane];
          v = k0 + lane < ku ? ve[k0 + lane] : 0.f;  // the mask, on values
        }
        typename V::T x[KC];
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          const int ci = __shfl_sync(mask, c, i, W);
          if (on && k0 + i < Kmax) x[i] = V::load(bt + ci * F);
        }
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          const float vi = __shfl_sync(mask, v, i, W);
          if (on && k0 + i < Kmax) {
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              p[q] = __fadd_rn(p[q], __fmul_rn(vi, V::get(x[i], q)));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], p[q]);
    }
    if (on) {
      float* o = out + s * F + f;
      typename V::T r;
      if (live) {
        r = V::load(o);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          V::set(r, q, __fadd_rn(V::get(r, q), acc[q]));
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) V::set(r, q, acc[q]);
      }
      V::store(o, r);
    }
  }
}

template <int W, int VEC>
cudaError_t launch(const int* cols, const float* vals, const int* tile_col,
                   const int* unit_k, const float* b, const long long* order,
                   const long long* offsets, const long long* live,
                   float* out, int G, int n_slots, int U, int R, int Kmax,
                   int nct, int T, int F, cudaStream_t stream) {
  constexpr int per_block = kThreads / W;
  const dim3 grid((n_slots + per_block - 1) / per_block, G);
  ell_rows_kernel<W, VEC><<<grid, kThreads, 0, stream>>>(
      cols, vals, tile_col, unit_k, b, order, offsets, live, out, n_slots, U,
      R, Kmax, nct, T, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cols/vals [G,U,R,Kmax], tile_col/unit_k [G,U], b [G,nct,T,F], all
// contiguous, cols[...] < T and tile_col[...] < nct.
//   live != null (row mode): order/offsets/live are the ELL plan (entries
//     g*U*R + u*R + r onto segments g*P + row; live [G, n_slots], -1
//     padded) and out [G,P,F] holds the rows to add onto, in place;
//   live == null (unit mode): order/offsets are null, n_slots = U*R and
//     out [G,U,R,F] receives the per-unit products.
int ragged_ell_rows_f32(const void* cols, const void* vals,
                        const void* tile_col, const void* unit_k,
                        const void* b, const void* order, const void* offsets,
                        const void* live, void* out, int G, int n_slots,
                        int U, int R, int Kmax, int nct, int T, int F,
                        void* stream) {
  const auto* c = static_cast<const int*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* tc = static_cast<const int*>(tile_col);
  const auto* uk = static_cast<const int*>(unit_k);
  const auto* bb = static_cast<const float*>(b);
  const auto* od = static_cast<const long long*>(order);
  const auto* of = static_cast<const long long*>(offsets);
  const auto* lv = static_cast<const long long*>(live);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (F <= 8)
    return static_cast<int>(launch<8, 1>(c, v, tc, uk, bb, od, of, lv, o, G,
                                         n_slots, U, R, Kmax, nct, T, F, st));
  if (F <= 16)
    return static_cast<int>(launch<16, 1>(c, v, tc, uk, bb, od, of, lv, o, G,
                                          n_slots, U, R, Kmax, nct, T, F,
                                          st));
  const bool v16 = F % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (v16)
    return static_cast<int>(launch<32, 4>(c, v, tc, uk, bb, od, of, lv, o, G,
                                          n_slots, U, R, Kmax, nct, T, F,
                                          st));
  return static_cast<int>(launch<32, 1>(c, v, tc, uk, bb, od, of, lv, o, G,
                                        n_slots, U, R, Kmax, nct, T, F, st));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
