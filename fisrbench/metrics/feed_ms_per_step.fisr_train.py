"""The benchmark's host clock around `next(feed)` in ms a step, untraced part
of the window: the store's gather of the next batch, its pin and the
enqueue of its copy to the card (prefetch_to_device, on the loop's thread)."""


def read(r):
    host, units = r.get("host_s"), r.get("cpu_units")
    if not host or not units or not units.get("steps") or "next(feed)" not in host:
        return None
    return 1e3 * host["next(feed)"] / units["steps"]
