"""K3's share of its roofline: the least time of every K3 launch in the
traced window, counted from the masks and columns (roofline.py), over
K3's device time in the trace (``union_chunk_kernel`` and
``union_finish_kernel``)."""

K3_KERNELS = ("union_chunk_kernel", "union_finish_kernel")


def read(ctx):
    k3_s = sum(ctx["kernel_s"].get(k, 0.0) for k in K3_KERNELS)
    if k3_s <= 0 or ctx["k3_least_s"] <= 0:
        return None
    return ctx["k3_least_s"] / k3_s * 100
