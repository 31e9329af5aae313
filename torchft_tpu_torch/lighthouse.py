"""Standalone Lighthouse daemon.

Parity with the reference's ``torchft_lighthouse`` binary
(upstream torchft src/bin/lighthouse.rs): run one per job; managers point at
it via ``TPUFT_LIGHTHOUSE``. Serves the quorum/heartbeat RPCs plus an HTML
status dashboard on the same port (open http://host:port/ in a browser).

    python -m torchft_tpu_torch.lighthouse --bind "[::]:29510" --min-replicas 2
"""

from __future__ import annotations

import argparse
import signal
import threading

from torchft_tpu_torch.coordination import LighthouseServer


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--bind", default="[::]:29510", help="address to bind")
    parser.add_argument(
        "--min-replicas", type=int, required=True, help="minimum replicas for a quorum"
    )
    parser.add_argument(
        "--join-timeout-ms",
        type=int,
        default=60000,
        help="how long to wait for heartbeating stragglers before issuing a quorum",
    )
    parser.add_argument(
        "--quorum-tick-ms", type=int, default=100, help="quorum evaluation interval"
    )
    parser.add_argument(
        "--heartbeat-timeout-ms",
        type=int,
        default=5000,
        help="heartbeat age after which a replica is considered dead",
    )
    args = parser.parse_args()

    server = LighthouseServer(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
    )
    print(f"lighthouse serving on {server.address()} (dashboard: http://{server.address()}/)")

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    server.shutdown()


if __name__ == "__main__":
    main()
