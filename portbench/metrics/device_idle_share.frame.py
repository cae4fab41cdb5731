"""``device_idle_share.frame``: 1 - the device's busy time (the union of its
kernel, copy and set intervals) over the wall time of the traced slice of
frames after the window (torch.profiler, CUPTI)."""


def read(run):
    t = run["trace"]
    if t is None or "frames" not in run["record"] or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
