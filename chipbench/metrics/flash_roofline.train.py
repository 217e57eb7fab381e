"""Attention's share of its roofline in a train window: the least time the
card could take for every call made at the port's attention entry
(``kernels.ops.flash_attention``) and its backward, the larger of their
operations at 989 TFLOP/s and their bytes at 3.35 TB/s (``counts``), over
the device time of the kernels those calls launched (``trace``)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None or not t["flash_device_s"]:
        return None
    return 100 * t["flash_bound_s"] / t["flash_device_s"]
