"""``round_start_ms``: the mean of the program's span ``nof/round_start``
(host clock: a NOF round's scene bounds or cloud fusion, ray building and
upload) over the window, in ms."""


def read(run):
    s = (run["record"].get("spans") or {}).get("nof/round_start")
    if not s or not s["count"]:
        return None
    return s["total_s"] * 1e3 / s["count"]
