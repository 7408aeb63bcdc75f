"""gat_attn_roofline: the bound of a request's softmax statistics over
``attn_dev_ms``, in %. The bound (``gat_work.attn_bound_s``) counts, each
layer, the neighbour lists' indices and row pointers once, s and t per
node and head, a maximum and a denominator written per row and head, and
five operations a stored entry and head, from the benchmark's CSR and the
configuration's heads: work any implementation must do, so the share
stays under 100 % whatever else the segment holds (the coefficients of
every stored entry)."""
from hgcn_bench import gat_work


def read(ctx):
    ms = ctx.value("attn_dev_ms")
    s = ctx.sess
    if not ms or s is None:
        return None
    bound = gat_work.attn_bound_s(ctx.cell.config, s.n, s.nnz)
    ctx.notes.append(f"gat_attn_roofline: bound {bound * 1e3!r} ms a "
                     f"request, attn {ms!r} ms")
    return 100.0 * bound * 1e3 / ms
