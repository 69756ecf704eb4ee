"""The share of the traced window in which no kernel, copy or fill ran
on the card."""


def read(ctx):
    if ctx["busy_s"] <= 0 or ctx["window_s"] <= 0:
        return None
    return (1 - ctx["busy_s"] / ctx["window_s"]) * 100
