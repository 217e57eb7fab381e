"""The selective scan's share of its roofline in a train window: the least
time the card could take for every call made at the port's scan entry
(``kernels.ops.ssm_scan``) and its backward, the largest of their f32
operations at 67 TFLOP/s, their exps at 4.18 T/s and their bytes at
3.35 TB/s (``counts_hybrid``), over the device time of the kernels those
calls launched (``trace_hybrid``)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None or not t.get("scan_device_s"):
        return None
    return 100 * t["scan_bound_s"] / t["scan_device_s"]
