"""``keyframe_select_ms_per_frame``: the program's span
``track/select_keyframes`` (choosing the keyframes of a frame's bundle
adjustment, covisibility included; host clock) summed over the window, over
its frames, in ms."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("track/select_keyframes")
    if s is None or not rec.get("frames"):
        return None
    return s["total_s"] * 1e3 / rec["frames"]
