"""The benchmark's host clock around the train step's call in ms a step,
untraced part of the window: the eager step's dispatch, and any wait on the
card inside it."""


def read(r):
    host, units = r.get("host_s"), r.get("cpu_units")
    if not host or not units or not units.get("steps") or "train step" not in host:
        return None
    return 1e3 * host["train step"] / units["steps"]
