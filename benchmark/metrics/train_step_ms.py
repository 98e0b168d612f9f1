"""The window's wall time over the training steps completed in it, the
device synchronised at its end."""


def read(rec):
    if rec["kind"] != "train" or not rec["completed"]:
        return None
    return 1e3 * rec["window_s"] / rec["completed"]
