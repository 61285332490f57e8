"""p70 of every request's round trip in the window, at the client: the
highest percentile with some 10 requests beyond it in a 14 s window."""

from fisrbench.harness.readers import latency_pct

read = latency_pct(70)
