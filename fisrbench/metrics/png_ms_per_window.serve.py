"""Program spans `serve.unpack` and `serve.pack` (the handlers' PNG decode and
encode) in ms a window sent over HTTP (`serve.windows`), over the whole run."""

from fisrbench.harness.program import ms_per

read = ms_per(("serve.unpack", "serve.pack"), "serve.windows")
