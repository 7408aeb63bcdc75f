"""xw_ms: device ms of one layer-1 X·W (``member_matmul`` at G = 1) on
the class's padded rows, timed alone after the window; nothing where the
model module gives no layer-1 operands."""
from hgcn_bench.yardstick import device_ms


def read(ctx):
    s = ctx.sess
    if s is None or s.device.type != "cuda":
        return None
    ops = ctx.layer1_operands()
    if ops is None:
        return None
    x, w = ops
    from repro_torch.core.hybrid_spmm import member_matmul

    ms, how = device_ms(s.torch, lambda: member_matmul(x, w))
    ctx.notes.append(f"xw_ms: {ms!r} ms, {tuple(x.shape)} @ "
                     f"{tuple(w.shape)}, timed by {how}")
    return ms
