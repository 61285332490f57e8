"""HTTP serving daemon (port of fisr_tpu/infer/daemon.py): the pair-cached
video pipeline behind a socket, standard library only.

Endpoints:

  GET  /healthz                  -> {"status": "ok"}
  GET  /v1/info                  -> model and configuration summary
  GET  /metrics                  -> Prometheus text format (counters)
  POST /v1/window                -> 3 frames in, 3 frames out: one isolated
                                    FISR window through the fused step (flow,
                                    warps and FISRnet for both pairs)
  POST /v1/stream/<id>/frame     -> 1 frame in; 202 while priming (the first
                                    two frames), then 3 frames out a frame.
                                    Pair-cached: each adjacent pair's flow and
                                    warps run once and feed two windows
  DELETE /v1/stream/<id>         -> drop the stream's state

Frame payloads are `application/x-fisr-frames`: u32 count, then per frame a
u32 length and the PNG bytes (little-endian). Frames are YUV-as-PNG by
default (the pipeline's own space, as the reference's inputs are); with
`?colorspace=rgb` they are converted at the edge. A window's outputs are
[interp1, SR, interp2] at twice the resolution.

PNGs are written and read with the port's own codec (the host runtime,
fisr_tpu_torch/native, in data/png_io's format; the card's machine has no
PIL): the same pixels as the JAX package's PIL frames, other bytes. One
`FISRService` serves one device and serializes its device calls behind a
lock; `MultiChipService` holds one a device in one process, behind
the same HTTP layer.

Hardening: `make_server(auth_token=...)` requires `Authorization: Bearer` on
every endpoint except /healthz (load-balancer probes stay open), and
`max_request_bytes` refuses larger posts with 413 before reading the body.
"""

from __future__ import annotations

import copy
import hmac
import itertools
import json
import struct
import threading
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from fisr_tpu_torch.device import f32_scope, resolve_device
from fisr_tpu_torch.infer.autotune import dtype_name
from fisr_tpu_torch.infer.video import make_fisr_window_fn, make_fused_video_step, make_pair_fn
from fisr_tpu_torch.models import fisrnet, pwcnet
from fisr_tpu_torch.native import decode_png_bytes, encode_png_bytes, yuv2rgb_ops_u8
from fisr_tpu_torch.ops.color import rgb2yuv_matlab
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.utils.profiling import assert_fits_hbm

__all__ = ["pack_frames", "unpack_frames", "FISRService", "MultiChipService", "make_server"]

CONTENT_TYPE = "application/x-fisr-frames"


# --------------------------------------------------------------------------
# protocol
# --------------------------------------------------------------------------

def pack_frames(frames: List[np.ndarray]) -> bytes:
    """[H, W, 3] u8 arrays -> framed PNG payload (u32 count, (u32 len, png)*)."""
    out = [struct.pack("<I", len(frames))]
    for f in frames:
        png = encode_png_bytes(f)
        out.append(struct.pack("<I", len(png)))
        out.append(png)
    return b"".join(out)


def unpack_frames(payload: bytes) -> List[np.ndarray]:
    """Framed PNG payload -> [H, W, 3] u8 RGB arrays (native.decode_png_bytes,
    data/png_io.decode_png's formats: 8-bit greyscale, RGB, RGBA and palette
    PNGs); ValueError when malformed."""
    if len(payload) < 4:
        raise ValueError("truncated frame payload")
    (count,) = struct.unpack_from("<I", payload, 0)
    off, frames = 4, []
    for _ in range(count):
        if off + 4 > len(payload):
            raise ValueError("truncated frame payload")
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        if off + n > len(payload):
            raise ValueError("truncated frame payload")
        frames.append(decode_png_bytes(payload[off:off + n]))
        off += n
    return frames


# --------------------------------------------------------------------------
# service: device-facing state
# --------------------------------------------------------------------------

class _StreamState:
    """Device-resident carry for one stream: last two frames + last pair."""

    __slots__ = ("prev2", "prev1", "pair")

    def __init__(self):
        self.prev2 = None   # frame k-2 [1, h, w, 3] on the device
        self.prev1 = None   # frame k-1
        self.pair = None    # (flows, warps) of (k-2, k-1)


class FISRService:
    """Owns the models, the stage functions and the stream state of one
    device; thread-safe.

    HTTP handlers call it from their own threads, and autograd's mode is per
    thread, so every device call runs under `torch.inference_mode()` here.
    Under an f32 policy every device call (and the warm-up) also runs under
    `device.exact_f32()`, inside `_lock`: TF32's flags are process-wide, and
    the scope keeps them off while any service of the process is inside one
    (two services on two cards included) and restores them after the last.
    `memory_checks` holds the warm-up's `assert_fits_hbm` results (need,
    limit and budget in bytes a stage; None on the CPU).
    """

    def __init__(self, fisr_params: fisrnet.FISRnet, pwc_params: pwcnet.PWCNet, height: int,
                 width: int, policy: Optional[Policy] = None, fisr_grid=None, upscale: int = 2,
                 sf: int = 2, warmup: bool = True, max_streams: int = 64, device="cuda"):
        if height % 32 or width % 32:
            raise ValueError(f"frame {height}x{width} must be 32-multiples")
        self.h, self.w, self.sf = height, width, sf
        self.policy = policy or F32
        self.device = resolve_device(device)
        self.fisr_params = fisr_params.to(self.device)
        self.pwc_params = pwc_params.to(self.device)
        self.fisr_grid = fisr_grid
        self._window_step = make_fused_video_step(
            pwc_params.cfg, policy=self.policy, upscale=upscale, sf=sf, fisr_grid=fisr_grid)
        self._pair_fn = make_pair_fn(pwc_params.cfg, policy=self.policy, upscale=upscale)
        self._win_fn = make_fisr_window_fn(policy=self.policy, sf=sf, fisr_grid=fisr_grid)
        # LRU-capped: each stream pins ~3 frames + 1 pair in device memory, so
        # an unbounded client population would leak it
        self._streams: "OrderedDict[str, _StreamState]" = OrderedDict()
        self.max_streams = max_streams
        self._lock = threading.Lock()       # device calls + stream state
        self.stats = {"windows": 0, "stream_frames": 0, "pair_programs": 0}
        self.memory_checks = {}
        if warmup:
            self._warmup()

    def _warmup(self) -> None:
        """Run each stage once on zeros under the pre-flight memory check: an
        over-budget geometry raises an actionable error here, not an
        allocator failure on the first real request."""
        z = torch.zeros((1, 3, self.h, self.w, 3), device=self.device)
        zf = z[:, 0]
        pair = []
        what = f"{self.h}x{self.w} serving"
        with torch.inference_mode(), f32_scope(self.policy):
            self.memory_checks = {
                "window_step": assert_fits_hbm(
                    lambda: self._quant(self._window_step(self.fisr_params, self.pwc_params, z)),
                    what=f"fused {what} window step", device=self.device),
                "pair": assert_fits_hbm(
                    lambda: pair.append(self._pair_fn(self.pwc_params, zf, zf)),
                    what=f"{what} pair stage", device=self.device),
                "window": assert_fits_hbm(
                    lambda: self._win_fn(self.fisr_params, z, pair[0], pair[0]),
                    what=f"{what} window stage", device=self.device),
            }

    # ---- helpers ----

    @staticmethod
    def _quant(pred: torch.Tensor) -> torch.Tensor:
        """[0, 1] -> u8 on the device: round half to even (as jnp.rint), clip."""
        return torch.round(pred.float() * 255.0).clamp(0.0, 255.0).to(torch.uint8)

    def _to_device(self, frame_u8: np.ndarray) -> torch.Tensor:
        if frame_u8.shape[:2] != (self.h, self.w):
            raise ValueError(
                f"frame is {frame_u8.shape[0]}x{frame_u8.shape[1]}, server "
                f"compiled for {self.h}x{self.w}")
        # u8 over the host link (a quarter of the bytes of a host-side f32
        # cast), cast on the device
        x = torch.from_numpy(np.ascontiguousarray(frame_u8, np.uint8))[None]
        return x.to(self.device).float()  # [1, h, w, 3] in [0, 255]

    def _window_out_to_u8(self, pred: torch.Tensor) -> List[np.ndarray]:
        """[1, H, W, 9] in [0, 1] -> 3 u8 frames [interp1, SR, interp2],
        quantized on the device so that u8, not f32, comes to the host."""
        out = self._quant(pred)[0].cpu().numpy()
        return [out[..., 0:3], out[..., 3:6], out[..., 6:9]]

    # ---- endpoints ----

    def info(self) -> dict:
        dev = self.device
        return {
            "model": "FISRnet",
            "frame": [self.h, self.w],
            "scale_factor": self.sf,
            "dtype": dtype_name(self.policy),
            "fisr_grid": (list(self.fisr_grid) if isinstance(self.fisr_grid, tuple)
                          else self.fisr_grid),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "streams": len(self._streams),
            "stats": dict(self.stats),
        }

    def window(self, frames: List[np.ndarray]) -> List[np.ndarray]:
        """Isolated 3-frame window -> 3 output frames (the fused step)."""
        if len(frames) != 3:
            raise ValueError(f"window needs exactly 3 frames, got {len(frames)}")
        with self._lock, torch.inference_mode(), f32_scope(self.policy):
            stack = torch.stack([self._to_device(f)[0] for f in frames])[None]
            pred = self._window_step(self.fisr_params, self.pwc_params, stack)
            out = self._window_out_to_u8(pred)
            self.stats["windows"] += 1
        return out

    def stream_frame(self, stream_id: str, frame: np.ndarray) -> Optional[List[np.ndarray]]:
        """Feed one frame to a stream; returns a window's output once primed.

        Pair-cached: frame k runs ONE pair for (k-1, k) and one window over
        (k-2, k-1, k) that reuses the cached (k-2, k-1) pair, the steady form
        of run_video_pipeline's fused loop.
        """
        with self._lock, torch.inference_mode(), f32_scope(self.policy):
            st = self._streams.get(stream_id)
            if st is None:
                st = self._streams[stream_id] = _StreamState()
                while len(self._streams) > self.max_streams:
                    self._streams.popitem(last=False)   # evict LRU
            else:
                self._streams.move_to_end(stream_id)
            dev = self._to_device(frame)
            self.stats["stream_frames"] += 1
            if st.prev1 is None:
                st.prev1 = dev
                return None
            pair_new = self._pair_fn(self.pwc_params, st.prev1, dev)
            self.stats["pair_programs"] += 1
            out = None
            if st.pair is not None:
                stack = torch.stack([st.prev2[0], st.prev1[0], dev[0]])[None]
                pred = self._win_fn(self.fisr_params, stack, st.pair, pair_new)
                out = self._window_out_to_u8(pred)
                self.stats["windows"] += 1
            st.prev2, st.prev1, st.pair = st.prev1, dev, pair_new
        return out

    def drop_stream(self, stream_id: str) -> bool:
        with self._lock:
            return self._streams.pop(stream_id, None) is not None

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service counters."""
        lines = []
        for k, v in sorted(self.stats.items()):
            name = f"fisr_{k}_total"
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {v}")
        lines.append("# TYPE fisr_active_streams gauge")
        lines.append(f"fisr_active_streams {len(self._streams)}")
        return "\n".join(lines) + "\n"


def _on(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`model` if it already lives on `device`, else a copy moved there
    (`.to` moves a module in place, and each service needs its own)."""
    if next(model.parameters()).device == device:
        return model
    return copy.deepcopy(model).to(device)


class MultiChipService:
    """One `FISRService` a device, behind the same endpoint surface.

    Routing: each stream id is pinned to a fixed device (crc32(id) % n, the
    JAX package's function, so an id lands on the same index) so that its
    device-resident carry (last two frames + cached pair) never migrates;
    isolated /v1/window requests round-robin. Each service has its own lock,
    so requests for different devices run concurrently: the in-process form
    of "one daemon a device behind a load balancer".

    `devices` defaults to every visible card (cuda:0 .. cuda:n-1); a list
    may name one device twice (two services sharing a card). The services
    are built, and warmed up, concurrently in threads; a service on another
    device than the models' takes its own copy of them. On one shared card
    the warm-ups' memory checks overlap, so each measures an upper bound.
    """

    def __init__(self, fisr_params: fisrnet.FISRnet, pwc_params: pwcnet.PWCNet, height: int,
                 width: int, devices=None, **kw):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("no devices to serve on")
        self.devices = devices
        models = {d: (_on(fisr_params, d), _on(pwc_params, d)) for d in dict.fromkeys(devices)}
        with ThreadPoolExecutor(max_workers=len(devices)) as pool:
            self.services = list(pool.map(
                lambda d: FISRService(*models[d], height, width, device=d, **kw), devices))
        self._rr = itertools.count()    # next() of a count is atomic under the GIL

    def _for_stream(self, stream_id: str) -> FISRService:
        return self.services[zlib.crc32(stream_id.encode()) % len(self.services)]

    def window(self, frames: List[np.ndarray]) -> List[np.ndarray]:
        return self.services[next(self._rr) % len(self.services)].window(frames)

    def stream_frame(self, stream_id: str, frame: np.ndarray) -> Optional[List[np.ndarray]]:
        return self._for_stream(stream_id).stream_frame(stream_id, frame)

    def drop_stream(self, stream_id: str) -> bool:
        return self._for_stream(stream_id).drop_stream(stream_id)

    def info(self) -> dict:
        base = self.services[0].info()
        base["chips"] = len(self.services)
        base["streams"] = sum(len(s._streams) for s in self.services)
        base["stats"] = {k: sum(s.stats[k] for s in self.services)
                         for k in self.services[0].stats}
        return base

    def metrics_text(self) -> str:
        """Prometheus text: the counters as per-device labelled series."""
        lines = []
        for k in sorted(self.services[0].stats):
            name = f"fisr_{k}_total"
            lines.append(f"# TYPE {name} counter")
            for i, s in enumerate(self.services):
                lines.append(f'{name}{{chip="{i}"}} {s.stats[k]}')
        lines.append("# TYPE fisr_active_streams gauge")
        for i, s in enumerate(self.services):
            lines.append(f'fisr_active_streams{{chip="{i}"}} {len(s._streams)}')
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# HTTP layer
# --------------------------------------------------------------------------

def _yuv_from(frames: List[np.ndarray], colorspace: str) -> List[np.ndarray]:
    if colorspace == "yuv":
        return frames
    # rgb2yuv_matlab is [0, 255] -> [0, 255] (MATLAB constants), f32
    return [np.clip(np.rint(rgb2yuv_matlab(torch.from_numpy(f.astype(np.float32))).numpy()),
                    0, 255).astype(np.uint8) for f in frames]


def _yuv_to(frames: List[np.ndarray], colorspace: str) -> List[np.ndarray]:
    if colorspace == "yuv":
        return frames
    return [yuv2rgb_ops_u8(f) for f in frames]


def make_server(service, host: str = "127.0.0.1", port: int = 8417,
                auth_token: Optional[str] = None,
                max_request_bytes: int = 192 * 1024 * 1024) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server of a `FISRService` or a
    `MultiChipService`; call .serve_forever() to run.

    With `auth_token` set, every endpoint except /healthz requires
    `Authorization: Bearer <token>` (constant-time compare); /healthz stays
    open so load-balancer probes need no secret. `max_request_bytes` bounds
    POST bodies: larger requests get 413 before the body is read.
    """

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            got = self.headers.get("Authorization", "")
            # compare bytes: compare_digest raises TypeError on non-ASCII
            # str input, which an unauthenticated client controls
            return (got.startswith("Bearer ")
                    and hmac.compare_digest(got[7:].encode("utf-8", "replace"),
                                            auth_token.encode()))

        def _deny(self) -> bool:
            """401 unless authorized; returns True when the request ends."""
            if self._authorized():
                return False
            body = json.dumps({"error": "unauthorized"}).encode()
            self.send_response(401)
            self.send_header("WWW-Authenticate", "Bearer")
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            # a denied POST's body was never read off the socket; keeping the
            # keep-alive connection would parse it as the next request
            self.close_connection = True
            return True

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _frames(self, frames: List[np.ndarray]):
            body = pack_frames(frames)
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _colorspace(self) -> str:
            q = self.path.split("?", 1)
            if len(q) == 2 and "colorspace=rgb" in q[1]:
                return "rgb"
            return "yuv"

        def _route(self) -> str:
            return self.path.split("?", 1)[0].rstrip("/")

        def do_GET(self):
            path = self._route()
            if path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self._deny():
                return
            elif path == "/v1/info":
                self._json(200, service.info())
            elif path == "/metrics":
                body = service.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            if self._deny():
                return
            path = self._route()
            cs = self._colorspace()
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > max_request_bytes:
                    # refuse before reading the body off the socket
                    self._json(413, {"error": f"request body {n} bytes "
                                     f"exceeds limit {max_request_bytes}"})
                    self.close_connection = True
                    return
                frames = _yuv_from(unpack_frames(self.rfile.read(n)), cs)
                if path == "/v1/window":
                    self._frames(_yuv_to(service.window(frames), cs))
                    return
                parts = path.split("/")
                if (len(parts) == 5 and parts[1] == "v1"
                        and parts[2] == "stream" and parts[4] == "frame"):
                    if len(frames) != 1:
                        raise ValueError("stream frame posts take 1 frame")
                    out = service.stream_frame(parts[3], frames[0])
                    if out is None:
                        self._json(202, {"status": "priming"})
                    else:
                        self._frames(_yuv_to(out, cs))
                    return
                self._json(404, {"error": f"unknown path {path}"})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # the server keeps running: report, don't drop
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_DELETE(self):
            if self._deny():
                return
            path = self._route()
            parts = path.split("/")
            if len(parts) == 4 and parts[1] == "v1" and parts[2] == "stream":
                gone = service.drop_stream(parts[3])
                self._json(200 if gone else 404, {"dropped": gone, "stream": parts[3]})
            else:
                self._json(404, {"error": f"unknown path {path}"})

    return ThreadingHTTPServer((host, port), Handler)
