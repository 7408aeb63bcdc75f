"""mean_batch.online: requests completed over batches dispatched inside
the window, from the queue's ``ServerStats``."""


def read(ctx):
    w = ctx.win
    batches = w.batches1 - w.batches0
    if batches <= 0:
        return None
    return (w.completed1 - w.completed0) / batches
