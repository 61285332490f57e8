"""Port: the serving daemon (infer/daemon.py) and its CLI (cli/serve.py)
against fisr_tpu.infer.daemon, over HTTP on the loopback.

FISRnet at ch=8 and PWC-Net at the default lg-6-2 config (the only one the
JAX service takes), both on the TF-oracle generator's weights, f32, 64x64
frames, one thread. Measured (CPU): the port's window against the JAX
service's 0 u8 counts (bound 1); the port's stream window against its own
/v1/window 0 counts (bounds max 1, mean 0.02, the JAX test's); the edge colour
conversions 0 u8 counts from JAX's (bound 0); a MultiChipService stream over
two CPU services against the single service's window 0 counts (bound 1, the
JAX test's).
"""

import concurrent.futures as cf
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from fisr_tpu.convert.tf_import import (convert_fisrnet, convert_pwcnet,
                                        export_fisrnet, export_pwcnet)
from fisr_tpu.infer import daemon as jdaemon
from fisr_tpu.models import fisrnet as jfisrnet
from fisr_tpu.models import pwcnet as jpwcnet
from fisr_tpu_torch.cli import serve
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars
from fisr_tpu_torch.infer import daemon
from fisr_tpu_torch.infer.daemon import (FISRService, MultiChipService, make_server, pack_frames,
                                         unpack_frames)

torch.set_num_threads(1)
H = W = 64  # 32-multiple and PWC-Net's 64-multiple
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trees():
    fshapes = {n: a.shape for n, a in export_fisrnet(
        jfisrnet.init_params(jax.random.PRNGKey(0), ch=8)).items()}
    jcfg = jpwcnet.PWCNetConfig()
    pshapes = {n: a.shape for n, a in export_pwcnet(
        jpwcnet.init_params(jax.random.PRNGKey(1), jcfg),
        pyr_lvls=jcfg.pyr_lvls, flow_pred_lvl=jcfg.flow_pred_lvl).items()}
    return (convert_fisrnet(deterministic_tf_vars(fshapes)),
            convert_pwcnet(deterministic_tf_vars(pshapes), pyr_lvls=jcfg.pyr_lvls,
                           flow_pred_lvl=jcfg.flow_pred_lvl))


@pytest.fixture(scope="module")
def service(trees):
    ftree, ptree = trees
    return FISRService(params.fisrnet_from_jax(ftree, device="cpu"),
                       params.pwcnet_from_jax(ptree, device="cpu"), H, W, device="cpu")


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def url(service):
    server = make_server(service, "127.0.0.1", 0)
    yield _start(server)
    server.shutdown()
    server.server_close()


def _post(url, payload, ctype="application/x-fisr-frames"):
    req = urllib.request.Request(url, data=payload, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _frames(n, seed=0):
    """Smooth YUV-as-RGB pattern moving a few px a frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    fx, fy = rng.uniform(0.05, 0.2, 2)
    phase = rng.uniform(0, 6.28, 3)
    return [np.stack([127.5 + 120 * np.sin(fx * (xx - 2 * t) + fy * (yy - t) + phase[c])
                      for c in range(3)], -1).astype(np.uint8) for t in range(n)]


def _noise(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (H, W, 3), np.uint8) for _ in range(n)]


def _u8_diff(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float(d.mean())


# ---- protocol


def test_frame_protocol_roundtrip():
    frames = _noise(3)
    got = unpack_frames(pack_frames(frames))
    assert len(got) == 3
    for a, b in zip(frames, got):
        np.testing.assert_array_equal(a, b)
    for bad in (b"\x03\x00\x00\x00junk", b"\x01\x00", b"\x01\x00\x00\x00\x09\x00\x00\x00png"):
        with pytest.raises(ValueError):
            unpack_frames(bad)


def test_frame_protocol_crosses_the_jax_codec():
    """(a) The port's payload through the JAX `unpack_frames` (PIL), and the
    JAX payload (PIL-encoded) through the port's: equal pixels (bound 0)."""
    frames = _noise(2, seed=1) + _frames(1)
    for a, b in zip(frames, jdaemon.unpack_frames(pack_frames(frames))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(frames, unpack_frames(jdaemon.pack_frames(frames))):
        np.testing.assert_array_equal(a, b)


def test_protocol_through_the_host_runtime_equals_its_plain_versions(monkeypatch):
    """`pack_frames`, `unpack_frames` and `_yuv_to` on the host runtime and on
    their plain versions (png_io's codec, ops/color.yuv2rgb_matlab_u8, the
    parent's route): the same decoded frames, bit for bit, either way."""
    from fisr_tpu_torch.data import png_io
    from fisr_tpu_torch.ops import color

    frames = _noise(2, seed=4) + _frames(2, seed=5)
    payload = pack_frames(frames)
    got, rgb = unpack_frames(payload), daemon._yuv_to(frames, "rgb")
    with monkeypatch.context() as m:
        m.setattr(daemon, "encode_png_bytes", png_io.encode_png)
        m.setattr(daemon, "decode_png_bytes", png_io.decode_png)
        m.setattr(daemon, "yuv2rgb_ops_u8", color.yuv2rgb_matlab_u8)
        plain_payload = pack_frames(frames)
        want, want_rgb = unpack_frames(plain_payload), daemon._yuv_to(frames, "rgb")
        crossed = unpack_frames(payload)
    for i, f in enumerate(frames):
        for other in (got[i], want[i], crossed[i], unpack_frames(plain_payload)[i]):
            np.testing.assert_array_equal(other, f)
        np.testing.assert_array_equal(rgb[i], want_rgb[i])


def test_edge_colour_conversion_matches_jax():
    """(b) `_yuv_from` (RGB -> YUV, f32 then rint) and `_yuv_to` (YUV -> RGB,
    f64 then truncation) against the JAX package's: 0 u8 counts differ over
    these 3 x 64 x 64 x 3 values (bound 0)."""
    frames = _noise(2, seed=2) + _frames(1, seed=3)
    for fn, jfn in ((daemon._yuv_from, jdaemon._yuv_from), (daemon._yuv_to, jdaemon._yuv_to)):
        assert fn(frames, "yuv") is frames
        for a, b in zip(fn(frames, "rgb"), jfn(frames, "rgb")):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


# ---- the service


def test_window_matches_jax_service(trees, service):
    """(c) The slice as a whole: the JAX `FISRService(..., warmup=False)
    .window` and the port's on the same weights and frames give u8 outputs
    within 1 count (measured 0)."""
    jservice = jdaemon.FISRService(*trees, H, W, warmup=False)
    frames = _frames(3, seed=4)
    want = jservice.window(frames)
    got = service.window(frames)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.shape == (2 * H, 2 * W, 3) and a.dtype == np.uint8
        assert _u8_diff(a, b)[0] <= 1
    assert {k: v for k, v in service.info().items() if k not in ("device", "stats", "streams")} \
        == {k: v for k, v in jservice.info().items() if k not in ("device", "stats", "streams")}


def test_stream_matches_window_and_counts_pairs(service):
    """(d) The pair-cached stream's first window against the fused window on
    the same 3 frames: max 1 u8 count, mean < 0.02 (the JAX test's bounds);
    4 frames run exactly 3 pair stages, the steady frame exactly one."""
    frames = _frames(4, seed=5)
    pair0 = service.stats["pair_programs"]
    assert service.stream_frame("d", frames[0]) is None
    assert service.stream_frame("d", frames[1]) is None
    out = service.stream_frame("d", frames[2])
    for a, b in zip(out, service.window(frames[:3])):
        mx, mean = _u8_diff(a, b)
        assert mx <= 1 and mean < 0.02
    before = service.stats["pair_programs"]
    assert len(service.stream_frame("d", frames[3])) == 3
    assert service.stats["pair_programs"] == before + 1
    assert service.stats["pair_programs"] - pair0 == 3
    assert service.drop_stream("d") and not service.drop_stream("d")


def test_service_device_calls_run_without_autograd(service):
    """Handler threads start in grad mode: the service turns autograd off
    itself, so its stream carry holds no graph."""
    out = []
    t = threading.Thread(target=lambda: out.append(
        [service.stream_frame("g", f) for f in _frames(2, seed=6)]))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and out
    st = service._streams["g"]
    assert torch.is_inference(st.prev1) and not st.pair[0].requires_grad
    service.drop_stream("g")


def test_stream_lru_eviction(service):
    service.max_streams = 2
    f = _noise(1, seed=9)[0]
    try:
        for sid in ("a", "b", "c"):        # c evicts a (LRU, cap 2)
            service.stream_frame(sid, f)
        assert "a" not in service._streams and len(service._streams) == 2
        # touching b then adding d evicts c, not b
        service.stream_frame("b", f)
        service.stream_frame("d", f)
        assert set(service._streams) == {"b", "d"}
    finally:
        service.max_streams = 64
        for sid in ("b", "d"):
            service.drop_stream(sid)


def test_constructor_refuses_other_frame_sizes(trees):
    ftree, ptree = trees
    fisr = params.fisrnet_from_jax(ftree, device="cpu")
    pwc = params.pwcnet_from_jax(ptree, device="cpu")
    with pytest.raises(ValueError, match="32-multiples"):
        FISRService(fisr, pwc, 48, 64, device="cpu", warmup=False)


# ---- HTTP


def test_metrics_endpoint(url, service):
    with urllib.request.urlopen(url + "/metrics") as r:
        assert r.headers.get("Content-Type", "").startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE fisr_windows_total counter" in text
    assert f"fisr_windows_total {service.stats['windows']}" in text
    assert "fisr_active_streams" in text
    assert service.metrics_text() == text


def test_health_and_info(url, service):
    with urllib.request.urlopen(url + "/healthz") as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(url + "/v1/info") as r:
        info = json.loads(r.read())
    assert info["model"] == "FISRnet" and info["frame"] == [H, W]
    assert info["dtype"] == "float32" and info["device"] == "cpu"
    assert info["fisr_grid"] is None and set(info["stats"]) == set(service.stats)
    # the warm-up ran its three stages under the memory check, which
    # measures nothing on the CPU
    assert service.memory_checks == {"window_step": None, "pair": None, "window": None}


def test_window_endpoint_and_stream_over_http(url, service):
    frames = _frames(4, seed=7)
    code, ctype, body = _post(url + "/v1/window", pack_frames(frames[:3]))
    assert code == 200 and ctype == "application/x-fisr-frames"
    mono = unpack_frames(body)
    for a, b in zip(mono, service.window(frames[:3])):
        np.testing.assert_array_equal(a, b)
    codes = [_post(url + "/v1/stream/s1/frame", pack_frames([f]))[0] for f in frames[:2]]
    assert codes == [202, 202]
    code, _, body = _post(url + "/v1/stream/s1/frame", pack_frames(frames[2:3]))
    assert code == 200
    for a, b in zip(unpack_frames(body), mono):
        mx, mean = _u8_diff(a, b)
        assert mx <= 1 and mean < 0.02
    req = urllib.request.Request(url + "/v1/stream/s1", method="DELETE")
    with urllib.request.urlopen(req) as r:
        assert json.loads(r.read())["dropped"] is True
    req = urllib.request.Request(url + "/v1/stream/s1", method="DELETE")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 404


def test_window_wrong_count_is_400(url):
    code, _, body = _post(url + "/v1/window", pack_frames(_noise(2)))
    assert code == 400 and b"3 frames" in body
    code, _, body = _post(url + "/v1/stream/x/frame", pack_frames(_noise(2)))
    assert code == 400 and b"1 frame" in body


def test_wrong_frame_size_is_400(url):
    bad = [np.zeros((H // 2, W, 3), np.uint8)] * 3
    code, _, body = _post(url + "/v1/window", pack_frames(bad))
    assert code == 400 and b"compiled for" in body
    code, _, body = _post(url + "/v1/window", b"\x01\x00\x00\x00\x04\x00\x00\x00junk")
    assert code == 400 and b"not a PNG" in body


def test_concurrent_clients(url, service):
    """4 threads x (window + stream) posts: the device lock serializes them
    without deadlock and every request completes."""

    def worker(k):
        f = _noise(3, seed=100 + k)
        code, _, body = _post(url + "/v1/window", pack_frames(f))
        assert code == 200 and len(unpack_frames(body)) == 3
        codes = [_post(f"{url}/v1/stream/conc{k}/frame", pack_frames(f[i:i + 1]))[0]
                 for i in range(3)]
        assert codes == [202, 202, 200]
        return k

    with cf.ThreadPoolExecutor(4) as ex:
        assert sorted(ex.map(worker, range(4), timeout=600)) == [0, 1, 2, 3]
    for k in range(4):
        assert service.drop_stream(f"conc{k}")


def test_rgb_colorspace_roundtrip(url, service):
    rgb = _noise(3, seed=3)
    code, _, body = _post(url + "/v1/window?colorspace=rgb", pack_frames(rgb))
    assert code == 200
    out = unpack_frames(body)
    want = daemon._yuv_to(service.window(daemon._yuv_from(rgb, "rgb")), "rgb")
    for a, b in zip(out, want):
        assert a.shape == (2 * H, 2 * W, 3)
        np.testing.assert_array_equal(a, b)


# ---- hardening: bearer auth + request size limit


@pytest.fixture(scope="module")
def auth_url(service):
    server = make_server(service, "127.0.0.1", 0, auth_token="sekrit", max_request_bytes=4096)
    yield _start(server)
    server.shutdown()
    server.server_close()


def _get(url, token=None):
    headers = {} if token is None else {"Authorization": f"Bearer {token}"}
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_auth_required(auth_url):
    code, body = _get(auth_url + "/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    assert _get(auth_url + "/v1/info")[0] == 401
    assert _get(auth_url + "/v1/info", token="wrong")[0] == 401
    assert _get(auth_url + "/metrics")[0] == 401
    code, body = _get(auth_url + "/v1/info", token="sekrit")
    assert code == 200 and json.loads(body)["model"] == "FISRnet"
    code, _, body = _post(auth_url + "/v1/window", pack_frames(_noise(3)))
    assert code == 401 and b"unauthorized" in body
    req = urllib.request.Request(auth_url + "/v1/stream/x", method="DELETE")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 401


def test_denied_post_closes_connection(auth_url):
    """A 401'd POST never drains its body; keeping the keep-alive socket open
    would parse the stale body bytes as the next request line."""
    host, port = auth_url[len("http://"):].split(":")
    body = b"\x89PNGgarbagebody" * 10
    req = (f"POST /v1/window HTTP/1.1\r\nHost: {host}\r\n"
           f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    with socket.create_connection((host, int(port)), timeout=5) as s:
        s.sendall(req)
        s.settimeout(5)
        data = b""
        while b"unauthorized" not in data:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        assert data.startswith(b"HTTP/1.1 401")
        while True:  # the server closes: EOF, not a parse of the body bytes
            tail = s.recv(4096)
            if not tail:
                break
            data += tail
        assert b"400" not in data.split(b"unauthorized")[-1]


def test_non_ascii_auth_header_is_401(auth_url):
    host, port = auth_url[len("http://"):].split(":")
    req = b"GET /v1/info HTTP/1.1\r\nHost: x\r\nAuthorization: Bearer s\xe9cret\r\n\r\n"
    with socket.create_connection((host, int(port)), timeout=5) as s:
        s.sendall(req)
        s.settimeout(5)
        assert s.recv(4096).startswith(b"HTTP/1.1 401")


def test_oversized_request_is_413(auth_url):
    payload = pack_frames(_noise(3))
    assert len(payload) > 4096
    req = urllib.request.Request(auth_url + "/v1/window", data=payload,
                                 headers={"Authorization": "Bearer sekrit"})
    try:
        with urllib.request.urlopen(req) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    assert code == 413 and b"exceeds limit" in body


# ---- MultiChipService: one service a device in one process (tests/test_daemon.py)


@pytest.fixture(scope="module")
def multi(trees):
    ftree, ptree = trees
    return MultiChipService(params.fisrnet_from_jax(ftree, device="cpu"),
                            params.pwcnet_from_jax(ptree, device="cpu"), H, W, warmup=False,
                            devices=["cpu", "cpu"])


def test_multichip_routing_and_carry(multi, service):
    """Streams pin to one service by crc32 (the JAX package's function: the
    same id lands on the same index); the output equals the single
    service's window within 1 u8 count (measured 0)."""
    from fisr_tpu.infer.daemon import MultiChipService as JMultiChipService

    frames = _frames(3, seed=21)
    svc = multi._for_stream("pinned")
    assert svc is multi._for_stream("pinned")
    ids = [f"cam{i}" for i in range(16)]
    jmulti = object.__new__(JMultiChipService)  # routing only: no services built
    jmulti.services = [0, 1]
    assert [multi.services.index(multi._for_stream(i)) for i in ids] == \
        [jmulti._for_stream(i) for i in ids]
    out = None
    for f in frames:
        out = multi.stream_frame("pinned", f)
    assert out is not None and len(out) == 3
    assert "pinned" in svc._streams
    assert all("pinned" not in s._streams for s in multi.services if s is not svc)
    for a, b in zip(out, service.window(frames)):
        assert _u8_diff(a, b)[0] <= 1
    assert multi.drop_stream("pinned") is True and multi.drop_stream("pinned") is False


def test_multichip_window_round_robin(multi):
    frames = _frames(3, seed=22)
    before = [s.stats["windows"] for s in multi.services]
    for _ in range(2 * len(multi.services)):
        assert len(multi.window(frames)) == 3
    assert [s.stats["windows"] - b for s, b in zip(multi.services, before)] == [2, 2]


def test_multichip_info_and_metrics(multi):
    info = multi.info()
    assert info["chips"] == 2 and info["device"] == "cpu"
    assert info["stats"] == {k: sum(s.stats[k] for s in multi.services)
                             for k in multi.services[0].stats}
    assert info["streams"] == sum(len(s._streams) for s in multi.services)
    text = multi.metrics_text()
    assert "# TYPE fisr_windows_total counter" in text
    for i in range(2):
        assert f'fisr_windows_total{{chip="{i}"}}' in text
        assert f'fisr_active_streams{{chip="{i}"}}' in text


def test_multichip_behind_http(multi):
    """The same HTTP layer serves a MultiChipService unchanged."""
    server = make_server(multi, "127.0.0.1", 0)
    url = _start(server)
    try:
        with urllib.request.urlopen(url + "/v1/info") as r:
            assert json.loads(r.read())["chips"] == 2
        code, _, body = _post(url + "/v1/window", pack_frames(_frames(3)))
        assert code == 200 and len(unpack_frames(body)) == 3
        codes = [_post(url + "/v1/stream/h/frame", pack_frames([f]))[0] for f in _frames(3)]
        assert codes == [202, 202, 200] and multi.drop_stream("h")
        with urllib.request.urlopen(url + "/metrics") as r:
            assert 'chip="1"' in r.read().decode()
    finally:
        server.shutdown()
        server.server_close()


def test_multichip_gives_each_device_its_own_models(trees):
    """`.to` moves a module in place: a service on another device than the
    models' takes a copy, one on the same device the models themselves."""
    ftree, ptree = trees
    fisr = params.fisrnet_from_jax(ftree, device="cpu")
    pwc = params.pwcnet_from_jax(ptree, device="cpu")
    m = MultiChipService(fisr, pwc, H, W, warmup=False, devices=["cpu", "cpu"])
    assert all(s.fisr_params is fisr and s.pwc_params is pwc for s in m.services)
    assert daemon._on(fisr, torch.device("meta")) is not fisr
    with pytest.raises(ValueError, match="no devices"):
        MultiChipService(fisr, pwc, H, W, warmup=False, devices=[])


# ---- cli/serve


def test_serve_parser_carries_the_jax_flags():
    from fisr_tpu.cli import serve as jserve

    ours = {a.dest: a.default for a in serve.build_parser()._actions}
    theirs = {a.dest: a.default for a in jserve.build_parser()._actions}
    assert {k: ours.get(k, "missing") for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"fisr_params_npz", "pwc_params_npz",
                                       "deterministic_weights", "device"}


def test_serve_multichip_waits_for_its_slice(capsys):
    """The slice it waited for is in: --multichip builds a MultiChipService,
    one service a visible card; with --device cpu one CPU service."""
    args = serve.build_parser().parse_args(["--height", "64", "--width", "64", "--multichip",
                                            "--device", "cpu", "--dtype", "float32",
                                            "--deterministic_weights", "--fisr_grid", "full"])
    service = serve.build_service(args)
    assert isinstance(service, MultiChipService) and service.devices == [torch.device("cpu")]
    assert service.info()["chips"] == 1 and "1 chip(s)" in capsys.readouterr().out


def test_serve_cli_starts_and_answers_healthz():
    """`python -m fisr_tpu_torch.cli.serve` with full-width generator
    weights on the CPU: it warms up, serves on a free port, answers /healthz
    and /v1/info, and exits on an interrupt."""
    cmd = [sys.executable, "-m", "fisr_tpu_torch.cli.serve", "--height", "64", "--width", "64",
           "--deterministic_weights", "--device", "cpu", "--dtype", "float32", "--port", "0",
           "--host", "127.0.0.1", "--fisr_grid", "full"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(300, proc.kill)  # a hung start ends the read below
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "serving on" in line:
                break
        assert "serving on" in lines[-1], "".join(lines)
        base = lines[-1].split()[3]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(base + "/v1/info", timeout=30) as r:
            info = json.loads(r.read())
        assert info["frame"] == [64, 64] and info["dtype"] == "float32"
        proc.send_signal(2)  # SIGINT
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
