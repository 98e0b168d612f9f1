"""Generated frames per second: B x (L - 1) frames for every call completed
in the window, over the window's wall time."""


def read(rec):
    if rec["kind"] != "generate" or rec["window_s"] <= 0:
        return None
    return rec["completed"] * rec["items_per_call"] / rec["window_s"]
