"""``xmem_memory_elements``: the memory elements a query frame read, the
program's counter ``xmem/memory_elements`` (every read's long-term and
working memory, summed) over its reads (``xmem/read_memory``) in the
window.  What the traffic asks of the memory, an invariant: it must not
move, and any movement, down as well as up, is a fault (a smaller read is
a weaker computation, not a faster one).  The schema asks every metric for
a direction; "lower" says nothing more."""


def read(run):
    spans = run["record"].get("spans") or {}
    elements, reads = spans.get("xmem/memory_elements"), spans.get("xmem/read_memory")
    if not elements or not reads or not reads["count"]:
        return None
    return elements["count"] / reads["count"]
