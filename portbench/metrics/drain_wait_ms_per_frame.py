"""``drain_wait_ms_per_frame``: the program's span ``nof/train_drain`` (the
host blocked until a NOF round's queued steps are done, closed by the
readback of the last step's metrics; host clock) summed over the window,
over its frames, in ms."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("nof/train_drain")
    if s is None or not rec.get("frames"):
        return None
    return s["total_s"] * 1e3 / rec["frames"]
