"""spmm_roofline: the bound of one layer-1 SpMM over spmm_ms, in %.

The bound is max(bytes / peak bandwidth, FLOPs / float32 peak), counted
from the benchmark's generated CSR at the width spmm_ms runs (W1's
columns, the hidden width): A's values, column indices and row pointers
once, B read once, Y written once, 2 FLOPs a nonzero and column;
whatever format implements it."""
from hgcn_bench import yardstick


def read(ctx):
    ms = ctx.value("spmm_ms")
    if not ms:
        return None
    s = ctx.sess
    width = int(ctx.layer1_operands()[1].shape[-1])
    nbytes, flops = yardstick.spmm_work(s.n, s.n, s.nnz, width)
    bound = yardstick.bound_s(nbytes, flops)
    ctx.notes.append(f"spmm_roofline: bound {bound * 1e3!r} ms "
                     f"({nbytes:.0f} bytes, {flops:.0f} FLOPs)")
    return 100.0 * bound * 1e3 / ms
