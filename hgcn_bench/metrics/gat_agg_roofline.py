"""gat_agg_roofline: the bound of a request's aggregation over the three
engines' device ms (``dense_dev_ms.gat`` + ``ell_dev_ms.gat`` +
``coo_dev_ms.gat``), in %. The bound (``gat_work.agg_bound_s``) is each
layer's ``yardstick.spmm_work`` at its width H * F' (1024, 1024, 246 at
the paper's widths) with no stored values, 2 FLOPs a nonzero and column,
summed over the layers."""
from hgcn_bench import gat_work


def read(ctx):
    parts = [ctx.value(f"{m}_dev_ms.gat") for m in ("dense", "ell", "coo")]
    s = ctx.sess
    if any(p is None for p in parts) or s is None or not sum(parts):
        return None
    bound = gat_work.agg_bound_s(ctx.cell.config, s.n, s.nnz)
    ctx.notes.append(f"gat_agg_roofline: bound {bound * 1e3!r} ms a "
                     f"request, engines {sum(parts)!r} ms")
    return 100.0 * bound * 1e3 / sum(parts)
