"""predict.swa_roofline: the attention kernel B6 (swa_attention_kernel)
against its bound, in %: the traced launches' least time
(gstbench/flops.py::swa_bound_s, one launch a layer a request) over
their device time in the profiler's trace.  Nothing when no launch was
traced."""


def read(rec):
    if rec["kind"] != "predict" or not rec["trace"] or not rec["peaks"]:
        return None
    s = sum(v for k, v in rec["trace"]["device_s"].items()
            if "swa_attention" in k)
    if s <= 0.0:
        return None
    return 100.0 * rec["swa_bound_s"] / s
