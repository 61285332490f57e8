"""Closed-loop HTTP clients of the window service, in their own process
(standard library only, so it starts in well under a second).

    python3 -m fisrbench.traffic.serve_client --port P --payloads DIR --clients 4 \
        --seconds S --check N --pick SEED --out DIR

Reads every `DIR/payload_<i>.bin` (a packed 3-frame window) into memory,
opens one connection a client, prints "ready", and waits for a line on
standard input. Then client c POSTs payload (c + clients * j) mod n as its
j-th request, each as soon as the last one came back, until `--seconds`
have passed; the request in flight is finished. Then `--check` of the
completed responses, drawn with random.Random(--pick), are written to
`--out`. The
last line of standard output is a JSON summary: each request's round trip
in ms and its end on the wall clock, the counts, and the first send and the
last receipt.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import sys
import threading
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--payloads", required=True)
    ap.add_argument("--clients", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--check", type=int, required=True)
    ap.add_argument("--pick", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    names = sorted(f for f in os.listdir(args.payloads) if f.startswith("payload_"))
    payloads = []
    for f in names:
        with open(os.path.join(args.payloads, f), "rb") as fh:
            payloads.append(fh.read())
    conns = [http.client.HTTPConnection("127.0.0.1", args.port, timeout=600)
             for _ in range(args.clients)]
    print("ready", flush=True)
    sys.stdin.readline()

    lat, done, errors = [], [], []
    lock = threading.Lock()
    t_go = time.time()
    deadline = time.perf_counter() + args.seconds
    first_send, last_done = [None], [t_go]

    def client(c):
        conn, j = conns[c], 0
        while time.perf_counter() < deadline:
            body = payloads[(c + args.clients * j) % len(payloads)]
            t0 = time.perf_counter()
            with lock:
                if first_send[0] is None:
                    first_send[0] = time.time()
            try:
                conn.request("POST", "/v1/window", body=body,
                             headers={"Content-Type": "application/x-fisr-frames"})
                resp = conn.getresponse()
                data = resp.read()
                ok = resp.status == 200
            except (OSError, http.client.HTTPException) as e:
                data, ok = repr(e).encode(), False
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                last_done[0] = time.time()
                lat.append((ms, last_done[0]))
                if not ok:
                    errors.append(data[:200].decode("utf-8", "replace"))
                if ok:
                    done.append(((c + args.clients * j) % len(payloads), data))
            j += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in conns:
        c.close()
    files = []
    for k in random.Random(args.pick).sample(range(len(done)), min(args.check, len(done))):
        i, data = done[k]
        path = os.path.join(args.out, f"resp_{k}.bin")
        with open(path, "wb") as fh:
            fh.write(data)
        files.append({"payload": i, "path": path})
    print(json.dumps({"latency_ms": [ms for ms, _t in lat], "done": [t for _ms, t in lat],
                      "completed": len(lat) - len(errors),
                      "errors": errors[:5], "n_errors": len(errors), "t_go": t_go,
                      "first_send": first_send[0], "last_done": last_done[0],
                      "kept": files}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
