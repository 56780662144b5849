"""Shard worker entrypoint: one :class:`EvalServer` hosting one shard
(counterpart of ``metrics_tpu/serve/worker.py``).

The slow fleet drills run workers as real processes::

    python -m metrics_tpu_torch.serve.worker --shard 1 --num-shards 4 \
        --num-streams 64 --checkpoint-root /tmp/fleet-ckpt

The worker builds the SAME per-shard registry :class:`LocalFleet` would
build for that shard (``mse`` plain job + ``per_tenant`` multistream job —
the drill vocabulary from ``serve.soak``), binds an ephemeral port unless
``--port`` is given, prints ``READY <port>`` on stdout for the parent to
scrape, and serves until SIGTERM/SIGINT.  The coordinator talks to it
through :class:`~metrics_tpu_torch.serve.coordinator.HTTPShard`; a kill -9 →
respawn of this process is the fleet failover drill.

The worker keeps its shard's state on ``--device`` (``cuda``, the default:
it exits with an error when CUDA is absent, or ``cpu``).  Each worker
process has its own CUDA context, so several share one card; start them
with ``subprocess`` (a fresh interpreter), never by forking a process that
has initialised CUDA.
"""
# analyze: skip-file[serve-blocking] -- process entrypoint: owns worker
# construction and the final drain/checkpoint on shutdown, like the fleet
# layer it mirrors.

from __future__ import annotations

import argparse
import functools
import signal
import threading
from typing import List, Optional, Sequence

from metrics_tpu_torch.serve.fleet import (
    FleetSpec,
    JobSpec,
    build_router,
    build_shard_registry,
)
from metrics_tpu_torch.serve.server import EvalServer, ServeConfig

__all__ = ["drill_jobs", "run_worker", "main"]


def drill_jobs(num_streams: int, device: str = "cuda") -> List[JobSpec]:
    """The fleet drill vocabulary: one plain job, one multistream job, each
    built on ``device``."""
    from metrics_tpu_torch.regression import MeanSquaredError

    build = functools.partial(MeanSquaredError, device=device)
    return [
        JobSpec("mse", build, num_streams=None),
        JobSpec("per_tenant", build, num_streams=int(num_streams)),
    ]


def run_worker(
    shard: int,
    num_shards: int,
    num_streams: int = 64,
    host: str = "127.0.0.1",
    port: int = 0,
    checkpoint_root: Optional[str] = None,
    block_rows: int = 64,
    flush_interval: float = 3600.0,
    max_staleness: Optional[float] = None,
    wal_exactly_once: bool = False,
    device: str = "cuda",
) -> EvalServer:
    """Build shard ``shard``'s registry and start its server (started).

    ``wal_exactly_once`` arms the worker side of the durable-ingest
    protocol: seq-tagged frame dedup on ``/ingest_columns``, applied-seq
    watermarks in every checkpoint, and ``wal_marks`` on ``/healthz`` —
    the frontend (or a soak harness) owns the WalWriter itself.  ``device``
    is where the shard keeps its state (``"cuda"`` raises without CUDA).
    """
    spec = FleetSpec(
        num_shards=int(num_shards),
        jobs=drill_jobs(num_streams, device=device),
        checkpoint_root=checkpoint_root,
        server_config=ServeConfig(
            host=host,
            port=int(port),
            block_rows=int(block_rows),
            # large interval = no wall-clock forcing: dispatch boundaries
            # stay a pure function of row count (the bitwise-drill contract)
            flush_interval=float(flush_interval),
            wal_exactly_once=bool(wal_exactly_once),
        ),
        max_staleness=max_staleness,
        device=device,
    )
    router = build_router(spec)
    registry = build_shard_registry(spec, int(shard), router)
    manager = None
    if checkpoint_root is not None:
        from metrics_tpu_torch.checkpoint.manager import (
            CheckpointManager,
            shard_checkpoint_directory,
        )

        manager = CheckpointManager(
            directory=shard_checkpoint_directory(checkpoint_root, int(shard)),
            max_staleness=max_staleness,
        )
    server = EvalServer(
        registry,
        config=spec.server_config,
        checkpoint_manager=manager,
        # builders arm /migrate_in: a subprocess worker can adopt spans
        # during an elastic resize just like an in-process shard
        builders={job.name: job for job in spec.jobs},
    )
    return server.start()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.serve.worker",
        description="one shard worker of the sharded serve fleet",
    )
    parser.add_argument("--shard", type=int, required=True)
    parser.add_argument("--num-shards", type=int, required=True)
    parser.add_argument("--num-streams", type=int, default=64)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--checkpoint-root", default=None)
    parser.add_argument("--block-rows", type=int, default=64)
    parser.add_argument("--flush-interval", type=float, default=3600.0)
    parser.add_argument("--max-staleness", type=float, default=None)
    parser.add_argument(
        "--wal-exactly-once",
        action="store_true",
        help="seq-dedup framed ingest and checkpoint applied-seq watermarks",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the shard keeps its state: cuda (the default) or cpu",
    )
    args = parser.parse_args(argv)

    # the handlers go in before READY is printed: a parent may stop the
    # worker the moment it reads READY, and that SIGTERM must drain the
    # server (and write the final checkpoint), not kill the process
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda _s, _f: stop.set())
    server = run_worker(
        shard=args.shard,
        num_shards=args.num_shards,
        num_streams=args.num_streams,
        host=args.host,
        port=args.port,
        checkpoint_root=args.checkpoint_root,
        block_rows=args.block_rows,
        flush_interval=args.flush_interval,
        max_staleness=args.max_staleness,
        wal_exactly_once=args.wal_exactly_once,
        device=args.device,
    )
    print(f"READY {server.port}", flush=True)
    while not stop.wait(timeout=0.2):
        pass
    # graceful drain; the final checkpoint only exists with a manager
    server.stop(final_checkpoint=args.checkpoint_root is not None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
