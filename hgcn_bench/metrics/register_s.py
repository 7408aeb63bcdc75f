"""register_s: ``Engine.register`` of the configuration's graph (reorder,
tri-partition, class padding, placement), host clock around the call and
a synchronize."""


def read(ctx):
    return ctx.sess.register_s
