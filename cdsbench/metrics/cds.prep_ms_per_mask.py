"""Mask prep a mask: the engine's ``cds.prepMasks.seconds`` span (from
the first prep's start to the last one's end, overlapped with shard-0
scoring) over the window, divided by the masks whose prep it timed."""


def read(ctx):
    if not ctx["masks_prepped"]:
        return None
    return ctx["counters"]["cds.prepMasks.seconds"] / ctx["masks_prepped"] \
        * 1e3
