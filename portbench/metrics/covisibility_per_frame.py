"""``covisibility_per_frame``: how many covisibilities the tracker computed
(the count of the program's span ``track/covisibility``; cache hits are
the counter ``track/covisibility_hit`` and not counted here) over the
window's frames."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("track/covisibility")
    if s is None or not rec.get("frames"):
        return None
    return s["count"] / rec["frames"]
