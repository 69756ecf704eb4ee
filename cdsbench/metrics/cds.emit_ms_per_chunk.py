"""The engine's emit a chunk: ``cds.emit.seconds`` over the window,
divided by the chunks the window completed."""


def read(ctx):
    if not ctx["chunks"]:
        return None
    return ctx["counters"]["cds.emit.seconds"] / ctx["chunks"] * 1e3
