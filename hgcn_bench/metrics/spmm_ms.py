"""spmm_ms: device ms of one layer-1 hybrid SpMM (F = hidden width,
G = 1) on the registered handle, through the engine's own SpMM executor
for the class (the dispatch, partition, plan and tuning it serves
with), timed alone after the window; nothing where the model module
gives no layer-1 operands."""
from hgcn_bench.yardstick import device_ms


def read(ctx):
    s = ctx.sess
    if s is None or s.device.type != "cuda":
        return None
    from repro_torch.core.hybrid_spmm import member_matmul

    ops = ctx.layer1_operands()
    if ops is None:
        return None
    x, w = ops
    b = member_matmul(x, w)[0]
    h = s.handle
    fn = s.engine.executors.spmm(h.sclass, int(b.shape[1]))
    ms, how = device_ms(s.torch, lambda: fn(h.part, b, h.plan))
    ctx.notes.append(f"spmm_ms: {ms!r} ms, B {tuple(b.shape)}, timed by "
                     f"{how}")
    return ms
