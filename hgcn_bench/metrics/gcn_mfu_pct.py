"""gcn_mfu_pct: model FLOPs of the requests completed in the window over
the window's seconds times the card's float32 peak, in %. A request's
FLOPs are the model module's ``request_flops`` on the unpadded graph:
for the GCN, dense X·W and the aggregation over A_tilde's nonzeros,
each layer."""
from hgcn_bench import yardstick


def read(ctx):
    s = ctx.sess
    if s is None or s.device.type != "cuda":
        return None
    ok = sum(1 for r in ctx.win.counted() if r["ok"])
    flops = s.model.request_flops(s.config, s.n, s.nnz)
    ctx.notes.append(f"gcn_mfu_pct: {ok} requests of {flops:.0f} FLOPs "
                     f"in {ctx.win.seconds!r} s")
    return 100.0 * ok * flops / (ctx.win.seconds * yardstick.PEAK_F32_FLOPS)
