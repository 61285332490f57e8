"""Run the FISR serving daemon on one card.

    python -m fisr_tpu_torch.cli.serve --height 1024 --width 1920 \
        --checkpoint_dir ./checkpoint_dir --exp_num 1 --port 8417

Port of fisr_tpu/cli/serve.py. Loads FISRnet and PWC-Net with the main CLI's
weight rules (cli/main._model: --fisr_params_npz / --pwc_params_npz, then
--deterministic_weights, then the experiment's checkpoint and --pwc_ckpt or
<checkpoint_dir>/pwcnet), casts FISRnet to bf16 once under --dtype bfloat16,
warms the fused window and the pair-cached stream stages up for the fixed
frame size under the memory check, then serves HTTP (infer/daemon.py:
/healthz, /v1/info, /metrics, /v1/window, /v1/stream/<id>/frame).

The weight flags and --device are the port's own. The checkpoint directories
may hold steps of the port or of the JAX package's orbax manager (read with
tensorstore), so by default the repo's trained <checkpoint_dir>/pwcnet
loads as in the JAX CLI. As the JAX serve parser, this one has no TF1 bundle
flag. --multichip parses and raises (Queue 1 item 5b).
"""

from __future__ import annotations

import argparse

from fisr_tpu_torch.cli._common import parse_grid

__all__ = ["build_parser", "build_service", "make_http_server", "serve_forever", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8417)
    p.add_argument("--height", type=int, required=True,
                   help="frame height (32-multiple; e.g. 1024)")
    p.add_argument("--width", type=int, required=True,
                   help="frame width (32-multiple; e.g. 1920)")
    p.add_argument("--checkpoint_dir", default="./checkpoint_dir")
    p.add_argument("--exp_num", type=int, default=1)
    p.add_argument("--pwc_ckpt", type=str, default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--fisr_grid", default="auto",
                   help="'auto' (heuristic, serving's default), 'tuned' (this card's plan in "
                        "the autotune cache, see `python -m fisr_tpu_torch.cli.tune`), "
                        "'full' (no tiling) or 'GH,GW'")
    p.add_argument("--flow_scale", type=int, default=2, choices=(1, 2),
                   help="2 = reference-parity x2-upscaled flow; 1 = flow at native resolution")
    p.add_argument("--multichip", action="store_true",
                   help="one service a device in this process: not ported yet, raises")
    p.add_argument("--auth_token", type=str, default=None,
                   help="require 'Authorization: Bearer <token>' on every endpoint except "
                        "/healthz")
    p.add_argument("--max_request_bytes", type=int, default=192 * 1024 * 1024,
                   help="reject larger POST bodies with 413")
    # the port's weight and device flags (cli/main has the same)
    p.add_argument("--fisr_params_npz", type=str, default=None,
                   help="FISRnet weights: .npz of '/'-joined key paths -> arrays")
    p.add_argument("--pwc_params_npz", type=str, default=None,
                   help="PWC-Net (lg-6-2) weights, same format")
    p.add_argument("--deterministic_weights", action="store_true",
                   help="full-width weights from the TF-oracle generator for any model "
                        "without an .npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' serves from the CPU")
    return p


def build_service(args):
    """The FISRService that `args` describes, warmed up."""
    import torch

    from fisr_tpu_torch.cli.main import _model
    from fisr_tpu_torch.device import resolve_device
    from fisr_tpu_torch.infer.daemon import FISRService
    from fisr_tpu_torch.ops.conv import BF16, F32

    if args.multichip:
        raise NotImplementedError(
            "--multichip: one service a device (MultiChipService) is not ported yet "
            "(ROADMAP.md, Queue 1 item 5b)")
    device = resolve_device(args.device)
    policy = BF16 if args.dtype == "bfloat16" else F32
    fisr = _model(args, device, "fisr")
    pwc = _model(args, device, "pwc")
    if args.dtype == "bfloat16":
        fisr = fisr.to(torch.bfloat16)  # cast once at load
    print(f" [*] warming up for {args.height}x{args.width} "
          f"({args.dtype}, grid={args.fisr_grid}, {device}) ...", flush=True)
    return FISRService(fisr, pwc, args.height, args.width, policy=policy,
                       fisr_grid=parse_grid(args.fisr_grid), upscale=args.flow_scale,
                       device=device)


def make_http_server(service, args):
    """The HTTP server of `service` on --host / --port, not yet started."""
    from fisr_tpu_torch.infer.daemon import make_server

    return make_server(service, args.host, args.port, auth_token=args.auth_token,
                       max_request_bytes=args.max_request_bytes)


def serve_forever(server) -> None:
    """Serve until interrupted, then close the socket."""
    host, port = server.server_address[:2]
    print(f" [*] serving on http://{host}:{port} "
          f"(/healthz, /v1/info, /metrics, /v1/window, /v1/stream/<id>/frame)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    serve_forever(make_http_server(build_service(args), args))


if __name__ == "__main__":
    main()
