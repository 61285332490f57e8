"""Program span `serve.lock_wait` (waits for the service's device lock) in ms
a window sent over HTTP (`serve.windows`), over the whole run."""

from fisrbench.harness.program import ms_per

read = ms_per(("serve.lock_wait",), "serve.windows")
