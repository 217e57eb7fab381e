"""HPC I/O workloads from the paper's evaluation (§6).

* :mod:`repro_torch.io.workloads` — Table 7/8 synthetic N-to-1 workloads
  (CN-W, SN-W, CC-R, CS-R) runnable under any consistency layer.
* :mod:`repro_torch.io.scr`       — the SCR multi-level checkpoint/restart case
  study (§6.2): HACC-IO data, "Partner" redundancy, single-node failure.
"""

from repro_torch.io.workloads import (
    WorkloadConfig,
    WorkloadResult,
    cc_r,
    cn_w,
    cs_r,
    pattern_bytes,
    pattern_extent,
    rn_r,
    rn_r_hot,
    rn_r_hot_set,
    run_workload,
    sn_w,
)
from repro_torch.io.scr import SCRConfig, SCRResult, run_scr

__all__ = [
    "WorkloadConfig",
    "WorkloadResult",
    "cn_w",
    "sn_w",
    "cc_r",
    "cs_r",
    "rn_r",
    "rn_r_hot",
    "rn_r_hot_set",
    "pattern_bytes",
    "pattern_extent",
    "run_workload",
    "SCRConfig",
    "SCRResult",
    "run_scr",
]
