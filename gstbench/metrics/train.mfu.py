"""train.mfu: the GST step's useful FLOPs (gstbench/flops.py) over the
traced window's seconds at the card's TF32 peak, in %."""


def read(rec):
    if rec["kind"] != "train" or not rec["trace"] or not rec["peaks"]:
        return None
    return 100.0 * rec["flops"] / (rec["trace"]["window_s"]
                                   * rec["peaks"]["tf32_flops"])
