"""attn_dev_ms: device ms a request of the program's ``attn`` segments,
a GAT layer's row statistics and edge coefficients outside the engines'
launches: summed over the dispatches enqueued inside the window, over
their live requests. It pairs the tracer's ``device_segment`` spans named
``attn`` of the chains that ``devtrace`` keeps in the window; None where
the program recorded none (a program without the span)."""
from hgcn_bench import devtrace


def read(ctx):
    got = devtrace._read(ctx)
    if got is None:
        return None
    w = ctx.win
    keep = {chain: row for chain, row in got["dispatches"].items()
            if row["first"] is not None
            and w.t_start <= row["enqueued"] <= w.t_end}
    begins, total, seen = {}, 0.0, False
    for e in ctx.tracer.events():
        if e["ph"] == "B" and e["cat"] == devtrace.SEGMENT_CAT \
                and e["name"] == "attn":
            begins[e["sid"]] = e
        elif e["ph"] == "E" and e["sid"] in begins:
            b = begins.pop(e["sid"])
            if (b["args"] or {}).get("chain") in keep:
                total += e["ts"] - b["ts"]
                seen = True
    if not seen:
        return None
    return 1e3 * total / sum(row["live"] for row in keep.values())
