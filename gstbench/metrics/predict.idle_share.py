"""predict.idle_share: the share of the traced window in which no
operation ran on the device, in %."""


def read(rec):
    if rec["kind"] != "predict" or not rec["trace"]:
        return None
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
