// Ragged ELL SpMM, the instances for float vals and bfloat16 B (the
// bfloat16 GCN's main path),
// each bfloat16 operand widened to float where it is loaded, so that the
// result is, bit for bit, the float instances' on the same values stored
// as float (the reference's kernels upcast both operands before they
// multiply). What the kernel computes, its design and its launch shape:
// ragged_ell_spmm.cu and ell_rows.cuh. Each (vals, B) type pair is a
// source of its own, so that the four compile in parallel.
#include "ragged_ell.cuh"

RAGGED_ELL_ENTRIES(f32_bf16, float, __nv_bfloat16)
