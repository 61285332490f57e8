"""The card's busy share under the clients' load: the window path's traced
device time a window times the windows completed a second in the window."""

from fisrbench.harness.readers import device_load_pct

read = device_load_pct("windows")
