"""``ray_upload_mb_per_round``: the bytes the NOF runner sent from the host
to the ray pool's device (the program's counter ``nof/pool_upload_bytes``:
each round's new rows and, past the pool's cap, the draw of kept indices)
over the window's NOF rounds (the count of ``nof/round_start``), in MB;
None where the program has no such counter."""


def read(run):
    spans = run["record"].get("spans") or {}
    sent, rounds = spans.get("nof/pool_upload_bytes"), spans.get("nof/round_start")
    if sent is None or not rounds or not rounds["count"]:
        return None
    return sent["count"] / 1e6 / rounds["count"]
