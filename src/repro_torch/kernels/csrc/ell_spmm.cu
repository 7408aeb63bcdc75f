// Fixed-K ELL SpMM: the sparse engine of the "fused"/"loop" dispatches, for
// Hopper (sm_90a), every fixed-K bucket of a layer in one launch, with the
// sum onto output rows and the add onto the dense engine's rows inside the
// kernel.
//
// Replaces the TPU kernel `_ell_kernel` / `ell_spmm`
// (src/repro/kernels/ell_spmm.py), which the "fused" and "loop" ELL
// dispatches launch once per distinct K, together with the segment sums
// that the reference applies to the buckets' products (at once for
// "fused", bucket by bucket into a running buffer for "loop") and the add
// of the result onto the dense engine's partial product. The buckets are
// the runs of the ragged [G, U, R, Kmax] slab that the partition's
// `ell_segments` give (bucket b: K_b and n_b units, K descending). For unit
// row e = (g, u, r),
//
//   p_e[:] = sum_{kk < K_b(u)} vals[e,kk] * B[g, tile_col[g,u], cols[e,kk], :]
//
// one chain from +0 in ascending kk, each multiply and add rounded on its
// own, read in place from the slab with its bucket's K as the loop bound:
// lanes past K_b are never read, and there is no value mask (the slab's
// lanes past unit_k hold 0). K_b(u) comes from `bucket_k` [U], a table
// built on the host with the plan (`ReductionPlan.ell_bucket_k`): one load
// a unit row, no search however many buckets there are (23 at the
// training partition of cora reordered by labels).
//
// Row mode (`ell_spmm_rows`, the "fused"/"loop" dispatches): the layer's
// ELL plan (the ragged kernel's: entries stably sorted by output row, the
// sentinel row dropped, `live` the grid), and for every live segment s
//
//   out[s,:] = out[s,:] + sum over j in [offsets[s], offsets[s+1]) of
//              p_{order[j]}
//
// with the row's sum in registers throughout. The plan lists a row's unit
// rows in unit order, and the buckets are runs of units in order, so a row
// takes its entries bucket after bucket, each bucket's in unit order: the
// order of the one `segment_sum` of "fused" (a stable sort of the unit rows
// by row) and of the bucket-by-bucket sums of "loop" (each adds the running
// value first, then the bucket's entries: 0 + v = v for the never -0
// running sums), started from +0 as torch.segment_reduce starts. So the
// result is the per-bucket products, summed and added onto yd, bit for
// bit, on both dispatches; and, with finite B, the ragged kernel's (a
// bucket's K is at least each of its units' unit_k, and the lanes between
// add 0 * x = +-0 to a chain that is never -0).
//
// Rows that no entry reaches are not touched. That equals `yd + 0` bit for
// bit: yd comes from the dense engine, whose every element is a chain of
// round-to-nearest adds started from +0 (or +0 itself where a row tile has
// no tile), and such a chain is never -0 (x + y is -0 only when both are
// -0), so yd + (+0) = yd. NaN rows stay NaN.
//
// Unit mode (`ell_spmm`, the TPU kernel's own function): one bucket's view
// [G, U_b, R, K_b] of the slab, read in place through its strides
// (s_g, R*s_r, s_r, 1), every unit row its own row and out[g,e,:] = p_e (no
// addend), into a buffer with member stride out_sg; one launch a bucket.
//
// What bounds it, and the design (a group of W lanes per live row, chunks
// of KC cols/vals shuffled round, KC B-row loads in flight, only the B rows
// the entries address read, no shared memory): ell_rows.cuh. Grid: (live
// rows / rows per block, G), so padding units and sentinel rows cost
// nothing and one launch covers the group and every bucket.
//
// Types: vals and B each float or bfloat16, one C entry a pair
// (ell_spmm_rows_<vals>_<B>; ell_spmm_rows_f32 where both are float). A
// bfloat16 operand is widened where it is loaded, so each instance gives,
// bit for bit, the float instance's result on the same values stored as
// float (ell_rows.cuh).
#include "ell_rows.cuh"

namespace {

constexpr int kThreads = ell_rows::kDefaultThreads;
constexpr int KC = ell_rows::kDefaultKC;

// W lanes per row, VEC features per lane, VT / BT the types of vals / B.
// `live` null = unit mode.
template <int W, int VEC, class VT, class BT>
__global__ void __launch_bounds__(kThreads, 1)  // no spill: ell_rows.cuh
ell_band_kernel(ell_rows::Units<VT> a, const BT* __restrict__ b,
                const long long* __restrict__ order,
                const long long* __restrict__ offsets,
                const long long* __restrict__ live, float* __restrict__ out,
                long long out_sg, int n_slots, int nct, int T, int F) {
  const int slot = blockIdx.x * (kThreads / W) + threadIdx.x / W;
  const long long g = blockIdx.y;
  if (slot >= n_slots) return;
  if (!live) {
    ell_rows::row<W, VEC, KC, ell_rows::kView, false>(
        a, b, nullptr, slot, slot + 1, g, nct, T, F,
        out + g * out_sg + static_cast<long long>(slot) * F);
    return;
  }
  const long long s = live[g * n_slots + slot];
  if (s < 0) return;  // past this member's last live row
  ell_rows::row<W, VEC, KC, ell_rows::kBucketed, true>(
      a, b, order, static_cast<int>(offsets[s]),
      static_cast<int>(offsets[s + 1]), g, nct, T, F, out + s * F);
}

// One launch (ell_spmm_rows_f32's arguments).
template <class VT, class BT>
cudaError_t launch(const void* cols, const void* vals, const void* tile_col,
                   const void* bucket_k, const void* b, const void* order,
                   const void* offsets, const void* live, void* out, int G,
                   int n_slots, int U, int R, int K, int nct, int T, int F,
                   long long s_g, int s_r, long long tc_sg, long long out_sg,
                   void* stream) {
  ell_rows::Units<VT> a{static_cast<const int*>(cols),
                        static_cast<const VT*>(vals),
                        static_cast<const int*>(tile_col), nullptr,
                        static_cast<const int*>(bucket_k), ell_rows::Bands{},
                        s_g, tc_sg, s_r, U, R, K};
  const auto* bb = static_cast<const BT*>(b);
  const auto* od = static_cast<const long long*>(order);
  const auto* of = static_cast<const long long*>(offsets);
  const auto* lv = static_cast<const long long*>(live);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = ell_rows::vec_aligned<BT>(b, out) && out_sg % 4 == 0;
  return ell_rows::pick(F, aligned, [&](auto w, auto vec) {
    constexpr int W = decltype(w)::value;
    constexpr int VEC = decltype(vec)::value;
    constexpr int per_block = kThreads / W;
    const dim3 grid((n_slots + per_block - 1) / per_block, G);
    ell_band_kernel<W, VEC, VT, BT><<<grid, kThreads, 0, st>>>(
        a, bb, od, of, lv, o, out_sg, n_slots, nct, T, F);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// b [G,nct,T,F] contiguous; cols[...] < T, tile_col[...] < nct.
//   live != null (row mode): cols/vals [G,U,R,K] (K = Kmax) and tile_col
//     [G,U] the contiguous ragged slab; bucket_k [U] the K of each unit's
//     bucket (each at most K); order/offsets/live the layer's ELL plan
//     (entries g*U*R + u*R + r onto segments g*P + row; live [G, n_slots],
//     -1 padded); out [G,P,F] contiguous holds the rows to add onto, in
//     place; the strides are unused;
//   live == null (unit mode): cols/vals one bucket's view [G,U,R,K] with
//     element strides (s_g, R*s_r, s_r, 1), tile_col [G,U] with strides
//     (tc_sg, 1); bucket_k and the plan null, n_slots = U*R, out [G,U,R,F]
//     with strides (out_sg, R*F, F, 1) receives the per-unit products.
// n_slots > 0 and G > 0 (the wrapper launches nothing otherwise).
#define ELL_SPMM_ROWS(SUFFIX, VT, BT)                                        \
  int ell_spmm_rows_##SUFFIX(                                                \
      const void* cols, const void* vals, const void* tile_col,              \
      const void* bucket_k, const void* b, const void* order,                \
      const void* offsets, const void* live, void* out, int G, int n_slots,  \
      int U, int R, int K, int nct, int T, int F, long long s_g, int s_r,    \
      long long tc_sg, long long out_sg, void* stream) {                     \
    return static_cast<int>(launch<VT, BT>(                                  \
        cols, vals, tile_col, bucket_k, b, order, offsets, live, out, G,     \
        n_slots, U, R, K, nct, T, F, s_g, s_r, tc_sg, out_sg, stream));      \
  }

ELL_SPMM_ROWS(f32, float, float)
// The same arguments with vals, B or both bfloat16.
ELL_SPMM_ROWS(f32_bf16, float, __nv_bfloat16)
ELL_SPMM_ROWS(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
ELL_SPMM_ROWS(bf16_f32, __nv_bfloat16, float)

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
