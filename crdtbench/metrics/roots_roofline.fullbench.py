"""``roots_roofline`` (N·L leaves read once and N roots written over
3.35 TB/s, against the mean ``batched_roots`` kernel duration) in the
cells that report no ``merges_per_s`` end to end."""

from crdtbench import roofline

KERNEL = "batched_roots"


def read(run):
    if run.trace is None or "roots_shape" not in run.work:
        return None
    return roofline.share(roofline.roots_bytes(*run.work["roots_shape"]), run.trace.kernel_mean_s(KERNEL))
