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
//   p_e[:] = sum_{kk < K_band(u)} (kk < unit_k[g,u] ? vals[e,kk] : 0)
//            * B[g, tile_col[g,u], cols[e,kk], :]
//
// where K_band(u) is the K of u's band: the partition's descending
// (K, n_units) runs merged to at most max_bands bands (any count from 1),
// the TPU kernel's band switch (`_bands_of`, `_band_tables`; one band of
// Kmax without runs). Up to 4 bands come by value (`bands`: their Ks, then
// the first unit of each band past the first; unit u's band is
// sum(u >= off), as the reference selects it); a plan of more comes as
// `band_k`, a [U] int32 table of each unit's band K on the card, one load a
// unit row (ell_rows_table_kernel). Both give the same bits on finite B
// (ell_rows.cuh).
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
// Order of additions (ell_rows.cuh): p_e is one chain from +0 in ascending
// kk up to its band's K, with the mask on the values, as the plain version
// and the TPU kernel run it; acc is a chain from +0 over the segment's p_e
// in plan order, which is what torch.segment_reduce adds; then one add
// out = out + acc, the `yd + ye` of the per-unit form. The result equals
// the unit-mode products summed by `segment_sum` and added to the dense
// rows, bit for bit.
//
// Rows without an ELL entry are not touched. That equals `yd + 0` bit for
// bit: yd comes from the dense engine, whose every element is a chain of
// round-to-nearest adds started from +0 (or +0 itself where a row tile has
// no tile), and such a chain is never -0 (x + y is -0 only when both are
// -0), so yd + (+0) = yd. NaN rows stay NaN.
//
// What bounds it, and the design (a group of W lanes per live segment,
// chunks of KC cols/vals shuffled round, KC B-row loads in flight): see
// ell_rows.cuh. Grid: (live slots / segments per block, G), so one launch
// covers the group. W, VEC, KC and the threads per block are launch knobs,
// one instance of each of the two kernels for each of their 54
// combinations; every instance gives the same bits (ell_rows.cuh).
//
// This source builds the float32 instances (float vals and B); those
// for vals or B or both in bfloat16 (widened where they are loaded:
// ell_rows.cuh) are built from ragged_ell_spmm_f32_bf16.cu,
// ragged_ell_spmm_bf16_bf16.cu and ragged_ell_spmm_bf16_f32.cu, one pair
// each, so that the four compile in parallel. The kernel itself is in
// ragged_ell.cuh.
#include "ragged_ell.cuh"

// ragged_ell_rows_f32: cols/vals [G,U,R,Kmax], tile_col/unit_k [G,U], b
// [G,nct,T,F], all contiguous, cols[...] < T and tile_col[...] < nct; vals
// and b float; band_k null: bands (host memory) the 4 band Ks (0 past the
// last, each at most Kmax) and the 3 offsets (INT_MAX past the last);
// else band_k (device memory) [U] the band K of each unit, each at most
// Kmax, and bands is not read.
//   live != null (row mode): order/offsets/live are the ELL plan (entries
//     g*U*R + u*R + r onto segments g*P + row; live [G, n_slots], -1
//     padded) and out [G,P,F] holds the rows to add onto, in place;
//   live == null (unit mode): order/offsets are null, n_slots = U*R and
//     out [G,U,R,F] receives the per-unit products.
// The launch shape: w lanes per row (8, 16, 32), vec floats per lane (1;
// 4 needs F % 4 == 0 and b, out 16-byte aligned), kc (2, 4, 8) and threads
// per block (128, 256, 512); 0 takes the default (ell_rows.cuh). Any
// other value returns cudaErrorInvalidValue without a launch.
RAGGED_ELL_ENTRIES(f32, float, float)

namespace ragged_ell {

// The head counts the multi-head instances are built for: the served
// GAT's (kernels/_build.py HEADS).
template <class F>
cudaError_t heads(int h, F&& f) {
  return ell_rows::select<4, 6>(h, f);
}

// One multi-head launch in row mode: the arguments of `launch`
// (ragged_ell.cuh) with
// the launch shape at its defaults (ell_rows::pick; VEC 4 only where a
// head's F / H features are whole vectors) and the head count H.
inline cudaError_t launch_heads(const void* cols, const void* vals,
                                const void* tile_col, const void* unit_k,
                                const void* b, const void* order,
                                const void* offsets, const void* live,
                                void* out, const int* bands,
                                const void* band_k, int G, int n_slots, int U,
                                int R, int Kmax, int nct, int T, int F, int H,
                                void* stream) {
  if (H < 2 || F % H != 0 || !live) return cudaErrorInvalidValue;
  ell_rows::Bands bd{};
  if (!band_k) {
    for (int i = 0; i < 4; ++i) bd.k[i] = bands[i];
    for (int i = 0; i < 3; ++i) bd.off[i] = bands[4 + i];
  }
  ell_rows::Units<float> a{static_cast<const int*>(cols),
                           static_cast<const float*>(vals),
                           static_cast<const int*>(tile_col),
                           static_cast<const int*>(unit_k),
                           static_cast<const int*>(band_k), bd, 0, 0, 0, U,
                           R, Kmax};
  const auto* bb = static_cast<const float*>(b);
  const auto* od = static_cast<const long long*>(order);
  const auto* of = static_cast<const long long*>(offsets);
  const auto* lv = static_cast<const long long*>(live);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ell_rows::vec_aligned<float>(b, out) && (F / H) % 4 == 0;
  return heads(H, [&](auto h_) {
    return ell_rows::pick(F, aligned, [&](auto w_, auto vec_) {
      constexpr int W = decltype(w_)::value;
      constexpr int VEC = decltype(vec_)::value;
      constexpr int HH = decltype(h_)::value;
      constexpr int per_block = ell_rows::kDefaultThreads / W;
      const dim3 grid((n_slots + per_block - 1) / per_block, G);
      if (band_k)
        ell_rows_heads_table_kernel<W, VEC, HH>
            <<<grid, ell_rows::kDefaultThreads, 0, st>>>(a, bb, od, of, lv, o,
                                                         n_slots, nct, T, F);
      else
        ell_rows_heads_kernel<W, VEC, HH>
            <<<grid, ell_rows::kDefaultThreads, 0, st>>>(a, bb, od, of, lv, o,
                                                         n_slots, nct, T, F);
      return cudaGetLastError();
    });
  });
}

}  // namespace ragged_ell

// ragged_ell_rows_heads_f32: ragged_ell_rows_f32 in row mode with H values
// an entry: vals [G,U,R,Kmax,H] float, feature f of B multiplied by the
// value of its head f / (F / H) (ell_rows.cuh); H 4 or 6 dividing F; the
// launch shape the defaults. Any other H returns cudaErrorInvalidValue
// without a launch.
extern "C" int ragged_ell_rows_heads_f32(
    const void* cols, const void* vals, const void* tile_col,
    const void* unit_k, const void* b, const void* order, const void* offsets,
    const void* live, void* out, const int* bands, const void* band_k, int G,
    int n_slots, int U, int R, int Kmax, int nct, int T, int F, int H,
    void* stream) {
  return static_cast<int>(ragged_ell::launch_heads(
      cols, vals, tile_col, unit_k, b, order, offsets, live, out, bands,
      band_k, G, n_slots, U, R, Kmax, nct, T, F, H, stream));
}
