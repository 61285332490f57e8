"""HTTP window serving traffic: `FISRService` behind `make_server` on the
loopback, in this process, as `cli/serve` builds it, under closed-loop
clients in a child process (traffic/serve_client.py).

Set-up makes the weights on the card from the seed, `windows` seeded
3-frame windows (harness/scene.clip) packed as the service's frame payload
(u32 count, then u32 length and PNG bytes a frame), the service (its own
warm-up included) and one request through HTTP, which warms up the
protocol, the PNG codec and the tiling plan. The child opens its
connections before the window. In the window the clients send bytes and
read bytes, no PNG work on their side. After it, the kept responses (drawn
from the seed) are decoded and held against the float32 reference. A traced
run then traces `trace_windows` calls of the service's window path on this
thread, back to back (the profiler loses the HTTP handler threads' device
work): its device metrics are that path's, not the loaded service's. Host
CPU, latency, the card's load and the whole step's share of the peak come
from the window.

Mix parameters: frame_hw, windows, clients, fisr_grid, pan_px, objects,
obj_radius, obj_px, check_windows, trace_windows, limits.

`control` puts the reference, at a lower precision, in the program's place
(harness/controls.py); `tiny` cuts a cell to a CPU test's size.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from fisrbench.harness import work
from fisrbench.harness.manifest import ROOT
from fisrbench.harness.runner import Outcome, RunContext, cpu_seconds, peak_bytes, sync
from fisrbench.harness.trace import Spans, traced
from fisrbench.reference import png
from fisrbench.traffic import video


TINY = dict(frame_hw=[64, 96], windows=3, clients=2, obj_radius=[5, 12], obj_px=[1.0, 3.0],
            pan_px=1.0, check_windows=2, trace_windows=1)


def tiny(config: dict, mix: dict):
    """The cell cut to a CPU test's size (as traffic/video.tiny)."""
    return video.tiny(config, mix)[0], dict(mix, **TINY)


def pack(frames) -> bytes:
    out = [struct.pack("<I", len(frames))]
    for f in frames:
        b = png.encode(f)
        out += [struct.pack("<I", len(b)), b]
    return b"".join(out)


def unpack(data: bytes):
    (n,) = struct.unpack_from("<I", data, 0)
    off, out = 4, []
    for _ in range(n):
        (k,) = struct.unpack_from("<I", data, off)
        out.append(png.decode(data[off + 4:off + 4 + k]))
        off += 4 + k
    return out


def run(ctx: RunContext) -> Outcome:
    from fisr_tpu_torch.infer.daemon import FISRService, make_server

    mix = ctx.mix
    tmp = tempfile.mkdtemp(prefix="fisrbench-serve-")
    server = child = None
    try:
        fisr, pwc, policy, fisr_p, pwc_p = video.models(ctx)
        h, w = mix["frame_hw"]
        frames = video.scene_frames(ctx, mix["windows"] + 2)
        pdir = os.path.join(tmp, "payloads")
        os.makedirs(pdir)
        payloads = [pack([frames[i], frames[i + 1], frames[i + 2]])
                    for i in range(mix["windows"])]
        for i, p in enumerate(payloads):
            with open(os.path.join(pdir, f"payload_{i:03d}.bin"), "wb") as f:
                f.write(p)
        service = FISRService(fisr, pwc, h, w, policy=policy, fisr_grid=mix["fisr_grid"],
                              upscale=ctx.config["flow_upscale"], device=ctx.device)
        server = make_server(service, "127.0.0.1", 0)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/window", data=payloads[0],
                                     headers={"Content-Type": "application/x-fisr-frames"})
        with urllib.request.urlopen(req, timeout=600) as r:
            r.read()

        out_dir = os.path.join(tmp, "kept")
        os.makedirs(out_dir)
        child = subprocess.Popen(
            [sys.executable, "-m", "fisrbench.traffic.serve_client", "--port", str(port),
             "--payloads", pdir, "--clients", str(mix["clients"]), "--seconds",
             str(ctx.seconds), "--check", str(mix["check_windows"]),
             "--pick", str(int(ctx.rng(4).integers(0, 2**62))), "--out", out_dir],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=ROOT)
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the serving clients did not start")
        sync(ctx.device)
        served0 = service.stats["windows"]
        setup_s = time.perf_counter() - ctx.t_start

        spans = Spans()
        cpu0 = cpu_seconds()
        child.stdin.write("go\n")
        child.stdin.flush()
        summary = json.loads(child.stdout.readline())
        child.wait(timeout=120)
        cpu_s = cpu_seconds() - cpu0
        served = service.stats["windows"] - served0
        elapsed = summary["last_done"] - summary["t_go"]
        lat = summary["latency_ms"]
        completed = summary["completed"]
        p50, p70, p90 = np.percentile(lat, (50, 70, 90))
        print(f"serve: {completed} windows ({served} by the service's count) in "
              f"{elapsed:.3f} s, {summary['n_errors']} errors {summary['errors']}; "
              f"latency samples {len(lat)}, p50 {p50:.1f} ms, p70 {p70:.1f} ms "
              f"({sum(x > p70 for x in lat)} beyond it), p90 {p90:.1f} ms", file=sys.stderr)
        reading = {}
        if ctx.trace:
            # after the window, the service's own window path traced on this
            # thread: the profiler loses the handler threads' device work
            # under HTTP load (PERF.md)
            k = mix["trace_windows"]

            def windows():
                for i in range(k):
                    with spans.span("FISRService.window"):
                        service.window([frames[(i + j) % len(frames)] for j in range(3)])

            tr = traced(windows, spans,
                        {"cost_volume_kernel": 2 * video.CV_LAUNCHES_PER_PAIR * k})
            reading = _reading(ctx, tr, k, cpu_s, served, lat, completed, elapsed)
        peak = peak_bytes(ctx.device)
        server.shutdown()
        server.server_close()
        server = None
        del service, fisr, pwc
        gc.collect()
        torch.cuda.empty_cache()

        checks, bad = check(ctx, frames, summary["kept"], fisr_p, pwc_p)
        attempted = len(lat)
        return Outcome(setup_s=setup_s, e2e={"serve_wps": completed / elapsed},
                       attempted=attempted, failed=summary["n_errors"] + bad, checks=checks,
                       memory_peak_bytes=peak, reading=reading)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(tmp, ignore_errors=True)


def _reading(ctx, tr, windows, cpu_s, windows_served, lat_ms, completed, elapsed) -> dict:
    cfg = ctx.config
    h, w = ctx.mix["frame_hw"]
    up = cfg["flow_upscale"]
    levels = work.pwc_level_shapes(2, h * up, w * up, cfg["pwcnet"])
    dtype = cfg["compute_dtype"]
    return {
        "trace": tr,
        "units": {"windows": windows, "pairs": 2 * windows},
        "cpu_s": cpu_s,
        "cpu_units": {"windows": windows_served},
        "flops": {"pairs": work.pwc_flops(1, h * up, w * up, cfg["pwcnet"], directions=2),
                  "windows": work.fisr_flops(1, h, w, cfg["fisrnet"])},
        "peak_flops": work.PEAK_FLOPS[dtype],
        "cv_fwd": {"kernel": "cost_volume_kernel", "launches_per_cycle": len(levels),
                   "bound_s_per_cycle": sum(work.cv_bound_s(s, dtype) for s in levels)},
        "latency_ms": lat_ms,
        # the loaded window: windows the clients completed over its length
        "load": {"units": {"windows": completed, "pairs": 2 * completed}, "seconds": elapsed},
    }


def check(ctx, frames, kept, fisr_p, pwc_p):
    """The kept responses (all three output frames, YUV), drawn from the
    completed ones by the seed, against the float32 reference of their
    windows, rounded as the service rounds: the RMS of the u8 difference. A
    response short of three well-formed frames counts as failed."""
    t0 = time.perf_counter()
    nets = video.reference_nets(ctx, fisr_p, pwc_p)
    sq = count = 0.0
    bad = 0
    for entry in kept:
        with open(entry["path"], "rb") as f:
            data = f.read()
        try:
            got = unpack(data)
        except (ValueError, struct.error) as e:
            print(f"serve: response to window {entry['payload']}: {e}", file=sys.stderr)
            bad += 1
            continue
        ref = video.reference_window(ctx, nets, frames, entry["payload"], "round")
        for s in range(3):
            want = ref[..., 3 * s:3 * s + 3]
            if len(got) != 3 or got[s].shape != want.shape:
                bad += 1
                continue
            d = got[s].astype(np.float64) - want.astype(np.float64)
            sq += float(np.sum(d * d))
            count += d.size
    rms = float(np.sqrt(sq / count)) if count else float("inf")
    print(f"serve: reference check {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return [("rms_u8", rms, ctx.mix["limits"]["rms_u8"])], bad


def control(ctx, numerics: str):
    """`check` of the reference at `numerics` in the program's place: its
    responses to `check_windows` windows drawn from the seed."""
    frames = video.scene_frames(ctx, ctx.mix["windows"] + 2)
    fisr_p, pwc_p = video.weights(ctx)
    low = video.reference_nets(ctx, fisr_p, pwc_p, numerics)
    pick, kept = ctx.rng(4), []
    tmp = tempfile.mkdtemp(prefix="fisrbench-control-")
    try:
        for k in range(ctx.mix["check_windows"]):
            i = int(pick.integers(0, ctx.mix["windows"]))
            out = video.reference_window(ctx, low, frames, i, "round")
            path = os.path.join(tmp, f"response_{k}.bin")
            with open(path, "wb") as f:
                f.write(pack([out[..., 3 * s:3 * s + 3] for s in range(3)]))
            kept.append({"path": path, "payload": i})
        return check(ctx, frames, kept, fisr_p, pwc_p)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
