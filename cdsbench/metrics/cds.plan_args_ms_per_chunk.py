"""Plan arguments a chunk (the batch's stacked plan tensors: a cache
hit, or the wait for the warm-ahead build, its upload and K2):
``cds.planArgs.seconds`` over the window, divided by the chunks the
window completed."""


def read(ctx):
    if not ctx["chunks"]:
        return None
    return ctx["counters"]["cds.planArgs.seconds"] / ctx["chunks"] * 1e3
