"""``merge_roofline`` (the least bytes the traced calls' inputs need over
3.35 TB/s, against the device time launched in the ``merge`` span) in
the cells that report no ``merges_per_s`` end to end."""

from crdtbench import roofline


def read(run):
    if run.trace is None or "merge_bytes" not in run.work:
        return None
    return roofline.share(run.work["merge_bytes"], run.trace.span_device_s.get("merge", 0.0))
