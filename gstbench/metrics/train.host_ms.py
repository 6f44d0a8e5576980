"""train.host_ms: host ms a step in the loop around the step
(``DeviceStore.prepare`` and the batch to the device), from the
harness's own spans over every step of the window."""


def read(rec):
    if rec["kind"] != "train" or not rec["host_s"]:
        return None
    return 1e3 * sum(rec["host_s"]) / len(rec["host_s"])
