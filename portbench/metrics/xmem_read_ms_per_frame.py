"""``xmem_read_ms_per_frame``: the device time of the segmenter's memory
reads over the window (the program's counter
``xmem/read_memory_device_us``: CUDA events around each read, in us), over
its frames, in ms."""


def read(run):
    rec = run["record"]
    us = (rec.get("spans") or {}).get("xmem/read_memory_device_us")
    if not us or not rec.get("frames"):
        return None
    return us["count"] * 1e-3 / rec["frames"]
