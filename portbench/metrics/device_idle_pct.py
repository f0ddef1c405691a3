"""device_idle_pct: the share of the traced window in which no operation
ran on the device (the union of the trace's device activities)."""

def read(run):
    d = run["device"]
    if not d or not d["window_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
