// COO row SpMM: the flexible engine of the tri-partition, for Hopper
// (sm_90a), with the sum onto output rows and the add onto the dense + ELL
// rows inside the kernel: one launch a layer for a whole group.
//
// It replaces no TPU kernel. The reference's flexible engine
// (src/repro/core/hybrid_spmm.py `coo_matmul`) is plain JAX, `jnp.take` of
// B's rows and `jax.ops.segment_sum` of the messages, and the port ran it as
// plain PyTorch: a gather of every entry's B row, the product, an
// `index_select` of the messages into plan order, `segment_reduce`, then
// `y + coo`, each pass writing its [G, nnz, F] result to device memory and
// the next reading it back. It was added because that chain was half the
// card's time on a Reddit-sized graph (6.5 of 13.0 device ms a request,
// where 232 609 of the 233 024 rows have COO entries).
//
// What it computes. For every output row s with at least one entry in the
// host-built COO plan (entries stably sorted by row, class padding's
// duplicate (0, 0, +0) triples dropped), in every feature f,
//
//   acc = +0;  for j in [offsets[s], offsets[s+1]) in order:
//              e = order[j];  acc = acc + vals[e] * B[g, cols[e], f]
//   out[s, f] = out[s, f] + acc
//
// with each multiply and each add rounded on its own (__fmul_rn, __fadd_rn,
// never contracted into an FMA). Entry e = g * nnz + i is member g's entry
// i: cols and vals are [G, nnz] and read flat at e; g is s / P. That is the
// unfused chain bit for bit: torch.segment_reduce sums each (segment,
// feature) sequentially from +0 in plan order, the messages were one
// float32 multiply each, and `y + coo` one add. Rows without an entry are
// not visited, which equals `y + 0` because out (the dense and ELL
// engines' rows) is never -0: both sum from +0 (ragged_ell_spmm.cu).
// bfloat16 vals or B are widened where they are loaded, so each of the
// four (vals, B) instances gives, bit for bit, the float instance's result
// on the same values stored as float.
//
// What bounds it on the H100: bytes. Each entry costs a multiply and an add
// per feature on a gathered B row: a quarter of an operation per byte,
// against the ~20 where float32 FMA (67 TFLOP/s) would overtake device
// memory (3.35 TB/s). A layer-1 B of a Reddit-sized group (4 x 233 K x 128
// float32, 477 MB) is far larger than the 50 MB L2, so the gathers come
// from HBM. The fused pass reads each live entry's B row, its index and
// value once, and each live output row once each way; nothing else.
//
// Design. The grid walks `rows`, the plan's live rows ordered by entry
// count, longest first (formats.RowOrder, built on the host with the plan):
// the longest chains start first; the order changes no sum.
//
//   Short rows (the bulk: a median of 7 entries at Reddit). A group of W
//   lanes owns a row, lanes over features, VEC elements a load (16 bytes of
//   float where F % 4 == 0), NV loads a lane where one pass of W*VEC
//   features does not cover F (F = 41). The group loads the next W entries'
//   order, cols and vals coalesced, passes them round with shuffles, and
//   each lane issues the B loads of kKC entries before it adds them in
//   order. The output row is read before the entry loop, so its load
//   overlaps the gathers. W shrinks for narrow F, as the ELL kernels'
//   defaults do: 8 lanes at F <= 8, 16 at F <= 16. A row is a chain of
//   dependent loads (its slot, its offsets, its entries, their B rows), so
//   what hides the latency is rows in flight: the kernel asks for
//   kMinBlocks blocks an SM (64 registers a thread), and kKC = 4 keeps the
//   16-byte instance inside them. Measured on the H100 at the benchmark's
//   Reddit-sized layer 1 (G = 4): one block an SM and kKC = 8, 2.33 ms;
//   four and kKC = 4, 1.72 (kKC = 8 spills at four; five or six blocks
//   spill too); with the long path below, 1.66.
//
//   Long rows (the first n_long of `rows`, at least coo_spmm.long_row
//   entries: a length the wrapper reads from the plan's size, the entries a
//   resident row group would walk were the launch spread evenly over the
//   card). A group of W lanes would walk a row of 11 308 entries in some
//   2 800 round trips, longer than the whole launch. So one block of
//   kThreads takes each (long row, chunk of W features): per stage of E
//   entries (kLoads a thread, at most kStage) every thread loads its share
//   of the stage's B rows (lanes over the chunk's features, so a warp's
//   load is whole rows of the chunk) into registers, which go to shared
//   memory while the next stage's loads are in flight; the first W threads
//   then add the stage from shared memory, each its feature's chain in plan
//   order. Entries come three stages ahead and their rows and values two,
//   so a stage waits on one round trip, and a row's chunks run on separate
//   SMs.
//
// Both paths are in the one launch (blocks [0, n_long * chunks) take the
// long rows), both read B in place through the tiles' view the ELL kernels
// get, and neither uses atomics or allocates: the launch is capturable in
// a CUDA graph and every run gives the same bits.
#include "ell_rows.cuh"

namespace coo_rows {

constexpr int kThreads = 256;  // threads per block
constexpr int kMinBlocks = 4;  // blocks an SM holds at least (64 registers)
constexpr int kKC = 4;         // a short row's entries in flight per lane
constexpr int kLoads = 16;     // B elements a thread stages a long-row stage
constexpr int kStage = 512;    // at most this many entries a long-row stage

// The COO entries and the plan, as the kernel reads them; VT is vals' type.
template <class VT>
struct Entries {
  const int* cols;           // [G * nnz] the B row of each entry
  const VT* vals;            // [G * nnz]
  const long long* order;    // the plan's entries, sorted by row
  const long long* offsets;  // [G * P + 1] where each row starts in order
  const long long* rows;     // [n_live] the live rows, longest first
};

// A short row: W lanes, NV loads of VEC features each per lane and pass.
// H > 1: vals holds H values an entry ([G, nnz, H]) and feature f takes
// the value of its head f / (F / H): each lane loads its heads' values
// beside the B rows, where H = 1 passes the one value round by shuffle; a
// lane's VEC features lie in one head (VEC = 1 where F / H % 4 != 0).
template <int W, int VEC, int NV, class VT, class BT, int H = 1>
__device__ __forceinline__ void short_row(const Entries<VT>& a, const BT* bg,
                                          float* yr, int begin, int end,
                                          int F) {
  static_assert(W % kKC == 0, "a chunk's entries are spread over the group");
  using V = ell_rows::BLoad<BT, VEC>;
  using Y = ell_rows::Vec<VEC>;
  const int lane = threadIdx.x % W;
  const unsigned mask =
      W == 32 ? 0xffffffffu
              : ((1u << W) - 1u) << ((threadIdx.x % 32) / W * W);
  for (int fb = 0; fb < F; fb += W * VEC * NV) {
    bool on[NV];
    int hv[NV];  // H > 1: the head of each load's features
    typename Y::T yv[NV];
    float acc[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      on[v] = fb + (v * W + lane) * VEC < F;
      hv[v] = H > 1 && on[v] ? (fb + (v * W + lane) * VEC) / (F / H) : 0;
      if (on[v]) yv[v] = Y::load(yr + fb + (v * W + lane) * VEC);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[v][q] = 0.f;
    }
    for (int k1 = begin; k1 < end; k1 += W) {
      // lane i holds cols/vals of entry k1 + i, read once (coalesced) and
      // passed round the group chunk by chunk
      int c = 0;
      float w = 0.f;
      int ex = 0;  // H > 1: the entry, for the lanes' own value loads
      if (k1 + lane < end) {
        const long long e = a.order[k1 + lane];
        c = a.cols[e];
        if constexpr (H == 1)
          w = ell_rows::widen(a.vals[e]);
        else
          ex = static_cast<int>(e);
      }
      const int n = min(W, end - k1);
      for (int k0 = 0; k0 < n; k0 += kKC) {  // kKC divides W: k0 + i < W
        typename V::T x[kKC][NV];
        float wh[kKC][NV];  // H > 1: each load's head's value
#pragma unroll
        for (int i = 0; i < kKC; ++i) {
          const long long ci = __shfl_sync(mask, c, k0 + i, W);
          long long eh = 0;
          if constexpr (H > 1)
            eh = static_cast<long long>(__shfl_sync(mask, ex, k0 + i, W)) *
                 H;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (on[v] && k0 + i < n) {
              x[i][v] = V::load(bg + ci * F + fb + (v * W + lane) * VEC);
              if constexpr (H > 1)
                wh[i][v] = ell_rows::widen(a.vals[eh + hv[v]]);
            }
        }
#pragma unroll
        for (int i = 0; i < kKC; ++i) {
          float wi = 0.f;
          if constexpr (H == 1) wi = __shfl_sync(mask, w, k0 + i, W);
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (on[v] && k0 + i < n) {
              if constexpr (H > 1) wi = wh[i][v];
#pragma unroll
              for (int q = 0; q < VEC; ++q)
                acc[v][q] = __fadd_rn(acc[v][q],
                                      __fmul_rn(wi, V::get(x[i][v], q)));
            }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (on[v]) {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          Y::set(yv[v], q, __fadd_rn(Y::get(yv[v], q), acc[v][q]));
        Y::store(yr + fb + (v * W + lane) * VEC, yv[v]);
      }
  }
}

// The entries of a long-row stage: ``e``, halved while a block's static
// shared memory for features ``fcw`` and ``h`` values an entry would pass
// 48 KiB (H = 1 always fits: ``e`` itself).
__host__ __device__ constexpr int fit_stage(int e, int fcw, int h) {
  return h == 1 || 4 * e * (fcw + 2 + 2 * h) <= 48 * 1024
             ? e
             : fit_stage(e / 2, fcw, h);
}

// A long row's features [f0, f0 + FCW): the whole block, stage by stage.
// H > 1: each entry's H values are staged, and a feature adds with its
// head's.
template <int FCW, class VT, class BT, int H = 1>
__device__ __forceinline__ void long_row(const Entries<VT>& a, const BT* bg,
                                         float* yr, int begin, int end,
                                         int f0, int F) {
  constexpr int RPS = kThreads / FCW;  // entries one block-wide load covers
  constexpr int E =
      fit_stage(kLoads * RPS < kStage ? kLoads * RPS : kStage, FCW, H);
  constexpr int NL = E / RPS;          // B elements a thread stages a stage
  constexpr int EPT = (E + kThreads - 1) / kThreads;  // indices a thread loads
  static_assert(kThreads % FCW == 0 && (E % kThreads == 0 || E < kThreads),
                "stage shape");
  __shared__ float sb[E * FCW];   // the stage's B chunk, [entry][feature]
  __shared__ int scol[2][E];      // two stages' B rows
  __shared__ float sval[2][E * H];  // and values ([entry][head])
  const int t = threadIdx.x;
  const int fl = t % FCW;  // the feature this thread loads
  const int jl = t / FCW;  // its first entry of a stage
  const bool fon = f0 + fl < F;
  const int n = end - begin;
  const int stages = (n + E - 1) / E;
  const BT* bf = bg + f0 + fl;

  long long e[EPT];
  int mc[EPT];
  float mv[EPT][H];
  auto order_of = [&](int k) {  // stage k's entries
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int j = k * E + i * kThreads + t;
      e[i] = i * kThreads + t < E && j < n ? a.order[begin + j] : -1;
    }
  };
  auto meta_of = [&]() {  // their B rows and values
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      mc[i] = e[i] >= 0 ? a.cols[e[i]] : 0;
#pragma unroll
      for (int h = 0; h < H; ++h)
        mv[i][h] = e[i] >= 0 ? ell_rows::widen(a.vals[e[i] * H + h]) : 0.f;
    }
  };
  auto store_meta = [&](int slot) {
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      if (i * kThreads + t < E) {
        scol[slot][i * kThreads + t] = mc[i];
#pragma unroll
        for (int h = 0; h < H; ++h)
          sval[slot][(i * kThreads + t) * H + h] = mv[i][h];
      }
  };
  float x[NL];
  auto load_b = [&](int k) {  // stage k's B chunk, into registers
    const int* col = scol[k & 1];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int j = i * RPS + jl;
      x[i] = fon && k * E + j < n
                 ? ell_rows::widen(bf[static_cast<long long>(col[j]) * F])
                 : 0.f;
    }
  };
  auto store_b = [&]() {
#pragma unroll
    for (int i = 0; i < NL; ++i) sb[i * kThreads + t] = x[i];
  };

  // stages 0 and 1's B rows and values, stage 0's B chunk, and stage 2's
  // entries in registers
  order_of(0);
  meta_of();
  store_meta(0);
  order_of(1);
  meta_of();
  store_meta(1);
  order_of(2);
  __syncthreads();
  load_b(0);
  store_b();
  __syncthreads();
  float acc = 0.f;
  for (int k = 0; k < stages; ++k) {
    // shared memory holds stage k's B chunk and values and stage k + 1's
    // B rows, registers stage k + 2's entries: stage k + 1's B loads,
    // stage k + 2's rows and values and stage k + 3's entries go out
    // together, before stage k's adds, so a stage waits on one round trip
    const bool next = k + 1 < stages, after = k + 2 < stages;
    if (next) load_b(k + 1);
    if (after) meta_of();
    if (k + 3 < stages) order_of(k + 3);
    if (t < FCW) {
      // this thread's head's values (H = 1: the one value an entry)
      const float* val =
          sval[k & 1] + (H > 1 && fon ? (f0 + t) / (F / H) : 0);
      const int cnt = min(E, n - k * E);
      for (int j = 0; j < cnt; ++j)
        acc = __fadd_rn(acc, __fmul_rn(val[j * H], sb[j * FCW + t]));
    }
    __syncthreads();
    if (next) store_b();
    if (after) store_meta(k & 1);
    __syncthreads();
  }
  if (t < FCW && fon) yr[f0 + t] = __fadd_rn(yr[f0 + t], acc);
}

// W lanes a short row (and W features a long row's block), VEC and NV as
// for short_row. Blocks [0, n_long * chunks) take (long row, chunk of W
// features); the rest take (kThreads / W) short rows each. At least
// kMinBlocks blocks an SM: 64 registers a thread, and no instance spills.
template <int W, int VEC, int NV, class VT, class BT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
coo_rows_kernel(Entries<VT> a, const BT* __restrict__ b,
                float* __restrict__ out, int n_long, int chunks, int n_live,
                int P, long long nb, int F) {
  const int long_blocks = n_long * chunks;
  const bool is_long = static_cast<int>(blockIdx.x) < long_blocks;
  int slot;
  if (is_long) {
    slot = blockIdx.x / chunks;
  } else {
    slot = n_long + (blockIdx.x - long_blocks) * (kThreads / W) +
           threadIdx.x / W;
    if (slot >= n_live) return;  // the whole group of W lanes leaves
  }
  const long long s = a.rows[slot];
  const long long g = s / P;
  const int begin = static_cast<int>(a.offsets[s]);
  const int end = static_cast<int>(a.offsets[s + 1]);
  const BT* bg = b + g * nb * F;
  float* yr = out + s * F;
  if (is_long)
    long_row<W>(a, bg, yr, begin, end, (blockIdx.x % chunks) * W, F);
  else
    short_row<W, VEC, NV>(a, bg, yr, begin, end, F);
}

// The multi-head instances (float vals [G, nnz, H] and B), H values an
// entry: the paths above with H; at least two blocks an SM (the values a
// lane keeps beside its B rows take registers past 64).
template <int W, int VEC, int NV, int H>
__global__ void __launch_bounds__(kThreads, 2)
coo_rows_heads_kernel(Entries<float> a, const float* __restrict__ b,
                      float* __restrict__ out, int n_long, int chunks,
                      int n_live, int P, long long nb, int F) {
  const int long_blocks = n_long * chunks;
  const bool is_long = static_cast<int>(blockIdx.x) < long_blocks;
  int slot;
  if (is_long) {
    slot = blockIdx.x / chunks;
  } else {
    slot = n_long + (blockIdx.x - long_blocks) * (kThreads / W) +
           threadIdx.x / W;
    if (slot >= n_live) return;
  }
  const long long s = a.rows[slot];
  const long long g = s / P;
  const int begin = static_cast<int>(a.offsets[s]);
  const int end = static_cast<int>(a.offsets[s + 1]);
  const float* bg = b + g * nb * F;
  float* yr = out + s * F;
  if (is_long)
    long_row<W, float, float, H>(a, bg, yr, begin, end,
                                 (blockIdx.x % chunks) * W, F);
  else
    short_row<W, VEC, NV, float, float, H>(a, bg, yr, begin, end, F);
}

// The instance for a row of F features whose pointers are `aligned` for
// VEC = 4 (ell_rows::vec_aligned): launch(W, VEC, NV), each passed as a
// std::integral_constant (coo_spmm.launch_shape mirrors it).
template <class Launch>
cudaError_t pick(int F, bool aligned, Launch launch) {
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using W8 = std::integral_constant<int, 8>;
  using W16 = std::integral_constant<int, 16>;
  using W32 = std::integral_constant<int, 32>;
  if (F <= 8) return launch(W8(), I1(), I1());
  if (F <= 16) return launch(W16(), I1(), I1());
  if (F % 4 == 0 && aligned) return launch(W32(), I4(), I1());
  if (F <= 32) return launch(W32(), I1(), I1());
  return launch(W32(), I1(), I2());
}

template <class VT, class BT>
cudaError_t launch(const void* cols, const void* vals, const void* b,
                   const void* order, const void* offsets, const void* rows,
                   void* out, int n_long, int n_live, int P, long long nb,
                   int F, void* stream) {
  const Entries<VT> a{static_cast<const int*>(cols),
                      static_cast<const VT*>(vals),
                      static_cast<const long long*>(order),
                      static_cast<const long long*>(offsets),
                      static_cast<const long long*>(rows)};
  const auto* bb = static_cast<const BT*>(b);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return pick(F, ell_rows::vec_aligned<BT>(b, out),
              [&](auto w, auto vec, auto nv) {
                constexpr int W = decltype(w)::value;
                constexpr int per_block = kThreads / W;
                const int chunks = (F + W - 1) / W;
                const long long blocks =
                    static_cast<long long>(n_long) * chunks +
                    (n_live - n_long + per_block - 1) / per_block;
                coo_rows_kernel<W, decltype(vec)::value, decltype(nv)::value,
                                VT, BT>
                    <<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
                       st>>>(a, bb, o, n_long, chunks, n_live, P, nb, F);
                return cudaGetLastError();
              });
}

// One multi-head launch: `launch`'s arguments for float operands, with
// the head count H (4 or 6, the served GAT's: kernels/_build.py HEADS)
// dividing F; VEC 4 only where a head's F / H features are whole vectors.
inline cudaError_t launch_heads(const void* cols, const void* vals,
                                const void* b, const void* order,
                                const void* offsets, const void* rows,
                                void* out, int n_long, int n_live, int P,
                                long long nb, int F, int H, void* stream) {
  if (H < 2 || F % H != 0) return cudaErrorInvalidValue;
  const Entries<float> a{static_cast<const int*>(cols),
                         static_cast<const float*>(vals),
                         static_cast<const long long*>(order),
                         static_cast<const long long*>(offsets),
                         static_cast<const long long*>(rows)};
  const auto* bb = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ell_rows::vec_aligned<float>(b, out) && (F / H) % 4 == 0;
  return ell_rows::select<4, 6>(H, [&](auto h) {
    return pick(F, aligned, [&](auto w, auto vec, auto nv) {
      constexpr int W = decltype(w)::value;
      constexpr int per_block = kThreads / W;
      const int chunks = (F + W - 1) / W;
      const long long blocks = static_cast<long long>(n_long) * chunks +
                               (n_live - n_long + per_block - 1) / per_block;
      coo_rows_heads_kernel<W, decltype(vec)::value, decltype(nv)::value,
                            decltype(h)::value>
          <<<dim3(static_cast<unsigned>(blocks)), kThreads, 0, st>>>(
              a, bb, o, n_long, chunks, n_live, P, nb, F);
      return cudaGetLastError();
    });
  });
}

}  // namespace coo_rows

extern "C" {

// coo_rows_f32's arguments with H values an entry (vals [G, nnz, H] float;
// feature f of B takes the value of its head f / (F / H)); H 4 or 6
// dividing F, else cudaErrorInvalidValue without a launch.
int coo_rows_heads_f32(const void* cols, const void* vals, const void* b,
                       const void* order, const void* offsets,
                       const void* rows, void* out, int n_long, int n_live,
                       int P, long long nb, int F, int H, void* stream) {
  return static_cast<int>(coo_rows::launch_heads(cols, vals, b, order,
                                                 offsets, rows, out, n_long,
                                                 n_live, P, nb, F, H,
                                                 stream));
}

// cols/vals [G, nnz] (int32 / vals of the entry's type), b [G, nb, F] (B's
// rows, contiguous; cols[...] < nb), order/offsets the COO plan (entries
// g*nnz + i onto rows g*P + row), rows [n_live] its live rows longest first
// (the first n_long of them long), out [G, P, F] float contiguous, added
// onto in place. n_live > n_long >= 0 or n_live = n_long > 0; F > 0 (the
// wrapper launches nothing otherwise).
#define COO_ROWS(SUFFIX, VT, BT)                                             \
  int coo_rows_##SUFFIX(const void* cols, const void* vals, const void* b,  \
                        const void* order, const void* offsets,              \
                        const void* rows, void* out, int n_long, int n_live, \
                        int P, long long nb, int F, void* stream) {          \
    return static_cast<int>(coo_rows::launch<VT, BT>(                        \
        cols, vals, b, order, offsets, rows, out, n_long, n_live, P, nb, F, \
        stream));                                                            \
  }

COO_ROWS(f32, float, float)
COO_ROWS(f32_bf16, float, __nv_bfloat16)
COO_ROWS(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
COO_ROWS(bf16_f32, __nv_bfloat16, float)

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
