"""predict.mfu: the traced requests' useful FLOPs (encode, causal
attention, head; gstbench/flops.py) over the traced window's seconds at
the card's TF32 peak, in %."""


def read(rec):
    if rec["kind"] != "predict" or not rec["trace"] or not rec["peaks"]:
        return None
    return 100.0 * rec["flops"] / (rec["trace"]["window_s"]
                                   * rec["peaks"]["tf32_flops"])
