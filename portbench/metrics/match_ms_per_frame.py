"""``match_ms_per_frame``: the program's span ``corres/match`` (the engine's
batched call and its readback, host clock) summed over the window, over
its frames, in ms."""


def read(run):
    rec = run["record"]
    spans = rec.get("spans")
    if not spans or "corres/match" not in spans or not rec.get("frames"):
        return None
    return spans["corres/match"]["total_s"] * 1e3 / rec["frames"]
