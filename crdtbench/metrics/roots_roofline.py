"""The roots kernel's share of the HBM roofline: N·L int64 leaves read
once and N roots written once (``crdtbench.roofline.roots_bytes``) over
3.35 TB/s, against the mean duration of the program's
``batched_roots_kernel`` launches in the trace."""

from crdtbench import roofline

KERNEL = "batched_roots"


def read(run):
    if run.trace is None or "roots_shape" not in run.work:
        return None
    return roofline.share(roofline.roots_bytes(*run.work["roots_shape"]), run.trace.kernel_mean_s(KERNEL))
