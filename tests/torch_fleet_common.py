"""Shared pieces of the port's fleet tests (``tests/test_torch_serve_fleet*.py``).

The fleets run on the CPU (``FleetSpec(device="cpu")``, every job built with
``device="cpu"``), with interval flushing off so that block boundaries depend
only on each shard's row count.  The traffic is dyadic (multiples of 1/8):
float32 sums are exact in any order, so fleets sharded differently agree
bitwise.
"""

import functools
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import FleetSpec, JobSpec, LocalFleet, ServeConfig, make_fleet_http_server

BLOCK = 8
CPU_MSE = functools.partial(MeanSquaredError, device="cpu")


def fleet_spec(num_shards, streams, checkpoint_root=None, export_top_k=2, **kw):
    """The JAX tests' two jobs: a plain ``mse`` and a multistream ``tenants`` over ``streams`` streams."""
    kw.setdefault("ring_capacity", 1024)
    return FleetSpec(
        num_shards=num_shards,
        jobs=[
            JobSpec("mse", CPU_MSE),
            JobSpec("tenants", CPU_MSE, num_streams=streams, export_top_k=export_top_k),
        ],
        checkpoint_root=checkpoint_root,
        server_config=ServeConfig(block_rows=BLOCK, flush_interval=3600.0),
        device="cpu",
        **kw,
    )


def dyadic_batch(n, lo=0, streams=6):
    """Deterministic dyadic traffic touching streams [0, streams)."""
    i = np.arange(lo, lo + n)
    preds = ((i * 3) % 32).astype(np.float32) / 8.0
    targets = ((i * 5) % 16).astype(np.float32) / 8.0
    sids = (i % streams).astype(np.int64)
    return preds, targets, sids


def feed(coordinator, n, lo=0, streams=6):
    preds, targets, sids = dyadic_batch(n, lo=lo, streams=streams)
    accepted, rejected = coordinator.ingest_columns("tenants", [preds, targets], sids)
    assert rejected == 0 and accepted == n
    accepted, rejected = coordinator.ingest_columns("mse", [preds, targets])
    assert rejected == 0 and accepted == n
    return n


def make_fleets(spec_fn):
    """A fixture body: ``make(num_shards, checkpoint_root=None)`` starts a fleet; ``stop_all(alive)`` at teardown."""
    alive = []

    def make(num_shards, checkpoint_root=None):
        fleet = LocalFleet(spec_fn(num_shards, checkpoint_root)).start()
        alive.append(fleet)
        return fleet

    return make, alive


def stop_all(fleets):
    """Stop the fleets side by side (each server's HTTP thread takes a poll interval to notice)."""
    threads = [threading.Thread(target=fleet.stop) for fleet in fleets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)


@pytest.fixture
def frontend():
    """``make(fleet)`` binds the fleet's HTTP frontend on an ephemeral port and returns the port."""
    servers = []

    def make(fleet):
        srv = make_fleet_http_server("127.0.0.1", 0, fleet.coordinator)
        thread = threading.Thread(target=lambda: srv.serve_forever(poll_interval=0.05), daemon=True)
        thread.start()
        servers.append((srv, thread))
        return srv.server_address[1]

    yield make
    for srv, thread in servers:
        srv.shutdown()
        thread.join(timeout=5.0)
        srv.server_close()


def get_json(port, path, expect=200):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10.0) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as err:
        assert err.code == expect, f"{path}: HTTP {err.code}: {err.read()!r}"
        return json.loads(err.read())


def post_json(port, path, payload, expect=200):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10.0) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as err:
        assert err.code == expect, f"{path}: HTTP {err.code}: {err.read()!r}"
        return json.loads(err.read())
