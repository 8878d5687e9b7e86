"""Command line of the PyTorch/CUDA port.

- ``serve``  run the HTTP serving stack::

      python -m pytorch_zappa_serverless_tpu_torch.cli serve \\
          --config profile.yaml --platform cuda

  ``--platform`` defaults to ``cuda``; without a GPU the command fails
  unless ``--platform cpu`` asks for the CPU.  With ``drain_timeout_s > 0``
  in the profile, SIGTERM drains gracefully (``/healthz`` and new work 503,
  in-flight work given the budget) before the server stops; a second
  SIGTERM skips the drain.
"""

from __future__ import annotations

import argparse
import sys

from .config import load_config


def cmd_serve(args) -> int:
    from .serving.server import run

    cfg = load_config(args.config, args.profile)
    if args.port is not None:
        cfg.port = args.port
    if args.host:
        cfg.host = args.host
    run(cfg, device=args.platform)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpuserve-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve", help="run the HTTP serving stack")
    sp.add_argument("--config", default=None, help="YAML/JSON config path")
    sp.add_argument("--profile", default=None, help="named profile in the config")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device to serve on (default cuda)")
    sp.add_argument("--port", type=int, default=None)
    sp.add_argument("--host", default=None, help="bind address (0.0.0.0 for containers)")
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
