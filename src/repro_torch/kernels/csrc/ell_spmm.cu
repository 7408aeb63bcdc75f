// Fixed-K ELL SpMM: one class band of the sparse engine, for Hopper
// (sm_90a), with the band's sum onto output rows and the add onto the dense
// engine's rows inside the kernel.
//
// Replaces the TPU kernel `_ell_kernel` / `ell_spmm`
// (src/repro/kernels/ell_spmm.py), which the "fused" and "loop" ELL
// dispatches launch once per distinct K, together with the segment sums
// that the reference applies to the buckets' products (at once for
// "fused", bucket by bucket into a running buffer for "loop") and the add
// of the result onto the dense engine's partial product. A band is a view
// [G, U_b, R, K_b] of the ragged [G, U, R, Kmax] slab, read in place
// through its strides (s_g, R*s_r, s_r, 1): no per-dispatch copy (a band
// view keeps the slab's packed unit and row axes). For unit row
// e = (g, u, r) of the band,
//
//   p_e[:] = sum_{kk < K_b} vals[e,kk] * B[g, tile_col[g,u], cols[e,kk], :]
//
// one chain from +0 in ascending kk with K_b as the loop bound (lanes past
// K_b are never read), each multiply and add rounded on its own.
//
// Row mode (`ell_spmm_rows`, the "fused"/"loop" dispatches): the band's
// host plan lists, per member, the padded rows it reaches (`rows`, -1
// padded: the grid), the unit rows bound for each in unit order
// (`order`/`offsets`) and a carry code per row (-1: no other band reaches
// it; else (c << 2) | (in << 1) | out, its slot c in a carry buffer
// [G, n_carry, F]). For every live row p of member g:
//
//   acc = in ? carry[g,c,:] : +0
//   acc = acc + p_e, for each of the row's unit rows e in plan order
//   out ? carry[g,c,:] = acc : yd[g,p,:] = yd[g,p,:] + acc
//
// The bands run in unit order, so a row's entries are added band after
// band, each band's in unit order: the order of the one `segment_sum` of
// "fused" (a stable sort of the unit rows by row) and of the bucket-by-
// bucket sums of "loop" (each adds the running value first, then the
// bucket's entries: 0 + v = v for the never -0 running sums), started from
// +0 as torch.segment_reduce starts. So the result is the per-unit
// products, summed and added onto yd, bit for bit, on both dispatches.
//
// Rows that no band reaches are not touched. That equals `yd + 0` bit for
// bit: yd comes from the dense engine, whose every element is a chain of
// round-to-nearest adds started from +0 (or +0 itself where a row tile has
// no tile), and such a chain is never -0 (x + y is -0 only when both are
// -0), so yd + (+0) = yd. NaN rows stay NaN.
//
// Unit mode (`ell_spmm`, the TPU kernel's own function): no plan, every
// unit row is its own row and out[g,e,:] = p_e (no addend), into a buffer
// with member stride out_sg.
//
// What bounds it, and the design (a group of W lanes per live row, chunks
// of KC cols/vals shuffled round, KC B-row loads in flight, only the B rows
// the entries address read, no shared memory): ell_rows.cuh. Grid: (live
// rows of the band / rows per block, G), so padding units and sentinel rows
// cost nothing and one launch covers the group.
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
// `rows` null = unit mode.
template <int W, int VEC, class VT, class BT>
__global__ void __launch_bounds__(kThreads, 1)  // no spill: ell_rows.cuh
ell_band_kernel(ell_rows::Units<VT> a, const BT* __restrict__ b,
                const long long* __restrict__ order,
                const long long* __restrict__ offsets,
                const long long* __restrict__ rows,
                const long long* __restrict__ carry_code,
                float* __restrict__ carry, float* __restrict__ out,
                long long out_sg, int n_slots, int n_carry, int P, int nct,
                int T, int F) {
  const int slot = blockIdx.x * (kThreads / W) + threadIdx.x / W;
  const long long g = blockIdx.y;
  if (slot >= n_slots) return;
  if (!rows) {
    ell_rows::row<W, VEC, KC, false, false>(
        a, b, nullptr, slot, slot + 1, g, nct, T, F, nullptr,
        out + g * out_sg + static_cast<long long>(slot) * F);
    return;
  }
  const long long j = g * n_slots + slot;
  const long long p = rows[j];
  if (p < 0) return;  // past this member's last live row
  const long long code = carry_code[j];
  float* c = code >= 0 ? carry + (g * n_carry + (code >> 2)) * F : nullptr;
  const float* init = code >= 0 && (code & 2) ? c : nullptr;
  const int begin = static_cast<int>(offsets[j]);
  const int end = static_cast<int>(offsets[j + 1]);
  if (code >= 0 && (code & 1))
    ell_rows::row<W, VEC, KC, false, false>(a, b, order, begin, end, g, nct, T,
                                        F, init, c);
  else
    ell_rows::row<W, VEC, KC, false, true>(a, b, order, begin, end, g, nct, T, F,
                                       init, out + (g * P + p) * F);
}

// One launch (ell_spmm_rows_f32's arguments).
template <class VT, class BT>
cudaError_t launch(const void* cols, const void* vals, const void* tile_col,
                   const void* b, const void* order, const void* offsets,
                   const void* rows, const void* carry_code, void* carry,
                   void* out, int G, int n_slots, int U, int R, int K,
                   int nct, int T, int F, int P, int n_carry, long long s_g,
                   int s_r, long long tc_sg, long long out_sg,
                   void* stream) {
  ell_rows::Units<VT> a{static_cast<const int*>(cols),
                        static_cast<const VT*>(vals),
                        static_cast<const int*>(tile_col),
                        nullptr, s_g, tc_sg, s_r, U, R, K};
  const auto* bb = static_cast<const BT*>(b);
  const auto* od = static_cast<const long long*>(order);
  const auto* of = static_cast<const long long*>(offsets);
  const auto* rw = static_cast<const long long*>(rows);
  const auto* cc = static_cast<const long long*>(carry_code);
  auto* cy = static_cast<float*>(carry);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = ell_rows::vec_aligned<BT>(b, out) &&
                       ell_rows::aligned16(carry) && out_sg % 4 == 0;
  return ell_rows::pick(F, aligned, [&](auto w, auto vec) {
    constexpr int W = decltype(w)::value;
    constexpr int VEC = decltype(vec)::value;
    constexpr int per_block = kThreads / W;
    const dim3 grid(n_slots > 0 ? (n_slots + per_block - 1) / per_block : 1,
                    G);
    ell_band_kernel<W, VEC, VT, BT><<<grid, kThreads, 0, st>>>(
        a, bb, od, of, rw, cc, cy, o, out_sg, n_slots, n_carry, P, nct, T,
        F);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// cols/vals [G,U,R,K] with element strides (s_g, R*s_r, s_r, 1), tile_col
// [G,U] with strides (tc_sg, 1), b [G,nct,T,F] contiguous; cols[...] < T,
// tile_col[...] < nct.
//   rows != null (row mode): order/offsets/rows/carry_code are the band's
//     plan (rows and carry_code [G, n_slots]; order numbers member g's
//     unit rows u*R + r); out [G,P,F] contiguous holds the rows to add
//     onto, in place; carry [G, n_carry, F] contiguous (null when no row
//     carries); out_sg unused;
//   rows == null (unit mode): the plan and carry are null, n_slots = U*R,
//     out [G,U,R,F] with strides (out_sg, R*F, F, 1) receives the
//     per-unit products.
// A band that reaches no row (n_slots = 0) still launches one block per
// member, which does nothing: the dispatches launch once per band.
#define ELL_SPMM_ROWS(SUFFIX, VT, BT)                                        \
  int ell_spmm_rows_##SUFFIX(                                                \
      const void* cols, const void* vals, const void* tile_col,              \
      const void* b, const void* order, const void* offsets,                 \
      const void* rows, const void* carry_code, void* carry, void* out,      \
      int G, int n_slots, int U, int R, int K, int nct, int T, int F, int P, \
      int n_carry, long long s_g, int s_r, long long tc_sg, long long out_sg,\
      void* stream) {                                                        \
    return static_cast<int>(launch<VT, BT>(                                  \
        cols, vals, tile_col, b, order, offsets, rows, carry_code, carry,    \
        out, G, n_slots, U, R, K, nct, T, F, P, n_carry, s_g, s_r, tc_sg,    \
        out_sg, stream));                                                    \
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
