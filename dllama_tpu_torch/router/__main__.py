"""``python -m dllama_tpu_torch.router`` — start the fleet router without
loading a model (``python -m dllama_tpu_torch router``
works too; this entry point starts in milliseconds)."""

import argparse

from ..obs import flight as obs_flight
from ..obs.log import configure as configure_logging
from .service import main as service_main


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dllama_tpu_torch.router",
        description="Fleet router fronting N API-server replicas")
    p.add_argument("--backends", required=True,
                   help="comma-separated replica addresses (host:port,...)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9990)
    p.add_argument("--probe-interval", type=float, default=2.0,
                   help="seconds between /health probes per backend")
    p.add_argument("--eject-after", type=int, default=3,
                   help="consecutive failures before ejection")
    p.add_argument("--readmit-after", type=int, default=2,
                   help="consecutive healthy probes before re-admission")
    p.add_argument("--router-retries", type=int, default=2,
                   help="max re-dispatches before giving up on a request")
    p.add_argument("--upstream-timeout", type=float, default=120.0,
                   help="socket timeout per upstream request (seconds)")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="seconds an open upstream stream may go silent "
                        "before the watchdog treats the replica as dead "
                        "(0 disables)")
    p.add_argument("--checkpoint-interval", type=float, default=0.0,
                   help="seconds between proactive DLREQ01 checkpoints "
                        "of in-flight greedy streams (0 disables)")
    p.add_argument("--resume-policy", choices=["auto", "never"],
                   default="auto",
                   help="default mid-stream crash behavior: auto resumes "
                        "greedy streams on a peer, never keeps the "
                        "honest replica_lost")
    p.add_argument("--log-format", choices=["human", "json"], default=None)
    p.add_argument("--log-level", default=None,
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--flight-buffer", type=int, default=None,
                   help="router-side flight ring capacity")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    configure_logging(args.log_format, args.log_level)
    obs_flight.configure(args.flight_buffer)
    service_main(args)


if __name__ == "__main__":
    main()
