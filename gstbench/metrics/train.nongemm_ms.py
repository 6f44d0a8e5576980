"""train.nongemm_ms: device ms a step in every other device operation
(elementwise kernels of AdamW and the clip, reductions, the pooling
kernel, copies), from the profiler's trace."""
from gstbench.trace import is_gemm


def read(rec):
    if rec["kind"] != "train" or not rec["trace"] or not rec["units"]:
        return None
    s = sum(v for k, v in rec["trace"]["device_s"].items() if not is_gemm(k))
    return 1e3 * s / rec["units"]
