"""queue_wait_ms.online: the median of the tracer's ``queue`` spans
(submit to batch close), ms, over the requests submitted inside the
window; every request is traced."""
import statistics


def read(ctx):
    tr = ctx.tracer
    if tr is None:
        return None
    begin = {}
    waits = []
    for e in tr.events():
        if e["ph"] == "B" and e["name"] == "queue":
            begin[e["sid"]] = e["ts"]
        elif e["ph"] == "E" and e["sid"] in begin:
            t0 = begin.pop(e["sid"])
            if ctx.win.t_start <= t0 <= ctx.win.t_end:
                waits.append((e["ts"] - t0) * 1e3)
    return statistics.median(waits) if waits else None
