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
// Order of additions (ell_rows.cuh): p_e is one chain from +0 in ascending
// kk up to Kmax, with the mask on the values, as the plain version and the
// TPU kernel run it; acc is a chain from +0 over the segment's p_e in plan
// order, which is what torch.segment_reduce adds; then one add
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
// one kernel instance for each of their 54 combinations; every instance
// gives the same bits (ell_rows.cuh).
#include "ell_rows.cuh"

namespace {

// W lanes per segment, VEC features per lane, KC K lanes in flight,
// THREADS per block. `live` null = unit mode. Minimum one block per SM:
// ptxas then allocates what the row loop needs and spills nothing
// (ell_rows.cuh).
template <int W, int VEC, int KC, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
ell_rows_kernel(ell_rows::Units a, const float* __restrict__ b,
                const long long* __restrict__ order,
                const long long* __restrict__ offsets,
                const long long* __restrict__ live, float* __restrict__ out,
                int n_slots, int nct, int T, int F) {
  const int slot = blockIdx.x * (THREADS / W) + threadIdx.x / W;
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
    ell_rows::row<W, VEC, KC, true, true>(a, b, order, begin, end, g, nct, T,
                                          F, nullptr, out + s * F);
  else
    ell_rows::row<W, VEC, KC, true, false>(a, b, order, begin, end, g, nct,
                                           T, F, nullptr, out + s * F);
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
// The launch shape: w lanes per row (8, 16, 32), vec floats per lane (1;
// 4 needs F % 4 == 0 and b, out 16-byte aligned), kc (2, 4, 8) and threads
// per block (128, 256, 512); 0 takes the default (ell_rows.cuh). Any
// other value returns cudaErrorInvalidValue without a launch.
int ragged_ell_rows_f32(const void* cols, const void* vals,
                        const void* tile_col, const void* unit_k,
                        const void* b, const void* order, const void* offsets,
                        const void* live, void* out, int G, int n_slots,
                        int U, int R, int Kmax, int nct, int T, int F, int w,
                        int vec, int kc, int threads, void* stream) {
  ell_rows::Units a{static_cast<const int*>(cols),
                    static_cast<const float*>(vals),
                    static_cast<const int*>(tile_col),
                    static_cast<const int*>(unit_k),
                    0, 0, 0, U, R, Kmax};
  const auto* bb = static_cast<const float*>(b);
  const auto* od = static_cast<const long long*>(order);
  const auto* of = static_cast<const long long*>(offsets);
  const auto* lv = static_cast<const long long*>(live);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = ell_rows::aligned16(b) && ell_rows::aligned16(out);
  if (w == 0) w = F <= 8 ? 8 : F <= 16 ? 16 : 32;
  if (vec == 0) vec = w == 32 && F % 4 == 0 && aligned ? 4 : 1;
  if (kc == 0) kc = ell_rows::kDefaultKC;
  if (threads == 0) threads = ell_rows::kDefaultThreads;
  if (vec == 4 && (F % 4 != 0 || !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  using ell_rows::select;
  return static_cast<int>(select<8, 16, 32>(w, [&](auto w_) {
    return select<1, 4>(vec, [&](auto vec_) {
      return select<2, 4, 8>(kc, [&](auto kc_) {
        return select<128, 256, 512>(threads, [&](auto threads_) {
          constexpr int W = decltype(w_)::value;
          constexpr int VEC = decltype(vec_)::value;
          constexpr int KC = decltype(kc_)::value;
          constexpr int THREADS = decltype(threads_)::value;
          constexpr int per_block = THREADS / W;
          const dim3 grid((n_slots + per_block - 1) / per_block, G);
          ell_rows_kernel<W, VEC, KC, THREADS><<<grid, THREADS, 0, st>>>(
              a, bb, od, of, lv, o, n_slots, nct, T, F);
          return cudaGetLastError();
        });
      });
    });
  }));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
