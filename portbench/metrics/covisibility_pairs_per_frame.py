"""``covisibility_pairs_per_frame``: how many frame pairs' covisibility the
tracker computed (the program's counter ``track/covisibility_pairs``: the
cache's misses, summed over its batches; hits are the counter
``track/covisibility_hit`` and not counted here) over the window's frames.
None where the program has no such counter."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("track/covisibility_pairs")
    if s is None or not rec.get("frames"):
        return None
    return s["count"] / rec["frames"]
