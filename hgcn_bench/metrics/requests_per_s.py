"""requests_per_s: full-graph GCN inferences that resolved inside the
window, over the window's seconds (host clock)."""


def read(ctx):
    ok = sum(1 for r in ctx.win.counted() if r["ok"])
    return ok / ctx.win.seconds
