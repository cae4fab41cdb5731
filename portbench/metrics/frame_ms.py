"""``frame_ms``: the whole window over the frames it completed (the window
closes at the end of the frame in flight; a session's ``on_finish`` and
the next session's construction are in it), in ms."""


def read(run):
    rec = run["record"]
    if not rec.get("frames"):
        return None
    return rec["window_s"] * 1e3 / rec["frames"]
