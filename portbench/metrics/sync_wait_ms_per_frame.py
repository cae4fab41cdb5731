"""``sync_wait_ms_per_frame``: the program's span ``nof/sync_wait`` (the
strict-sync wait for a round's steps, drain and pose feedback) summed over
the window, over its frames, in ms."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("nof/sync_wait")
    if s is None or not rec.get("frames"):
        return None
    return s["total_s"] * 1e3 / rec["frames"]
