"""The merge's share of the HBM roofline: the least bytes the traced
calls' inputs need (``crdtbench.roofline.merge_bytes``: the rows a
delta changes read and written once, the slice read once) over
3.35 TB/s, against the device time launched in the ``merge`` span."""

from crdtbench import roofline


def read(run):
    if run.trace is None or "merge_bytes" not in run.work:
        return None
    return roofline.share(run.work["merge_bytes"], run.trace.span_device_s.get("merge", 0.0))
