"""``loftr_pad_share``: the share of the engine's batch slots that carried
no real pair over the window, 1 - ``corres/pairs`` / ``corres/slots`` (the
program's counters in the host-warp correspondence path: the fresh pairs
matched, the bucket the engine ran)."""


def read(run):
    spans = run["record"].get("spans") or {}
    pairs, slots = spans.get("corres/pairs"), spans.get("corres/slots")
    if not pairs or not slots or not slots["count"]:
        return None
    return 1.0 - pairs["count"] / slots["count"]
