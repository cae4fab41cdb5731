"""``frame_ms_p90``: the 90th percentile of the latencies of all frames in
the window (host clock around ``run``, closed by a synchronise), in ms;
``statistics.quantiles``' inclusive method."""
import statistics


def read(run):
    lat = run["record"].get("latencies_s")
    if not lat or len(lat) < 10:
        return None
    return statistics.quantiles([x * 1e3 for x in lat], n=10, method="inclusive")[8]
