"""The port's fleet against the JAX package's, on the CPU.

Four two-shard fleets take the same dyadic traffic (``ColumnTraffic`` with
``dyadic=True``: multiples of 1/8, so float32 sums are exact and "equal"
means bitwise): the port's ``LocalFleet``, the JAX package's, the port's
coordinator (``FleetCoordinator`` over ``HTTPShard`` handles) in front of two
JAX ``EvalServer`` workers, and the JAX coordinator in front of two of the
port's.  Every fleet's ``compute_all()`` is bitwise every other's, and the
scatter-gather reads (``top_k`` both ways, ``where``, ``compute_streams``)
are equal.  Each of the eight job registries hosts the same spans: the port's
router places streams and plain jobs as the JAX one does.
"""

import functools

import pytest

import metrics_tpu.serve as jserve
import metrics_tpu.serve.fleet as jfleet
from metrics_tpu.regression import MeanSquaredError as JMeanSquaredError
from metrics_tpu_torch.serve import ColumnTraffic, FleetCoordinator, FleetSpec, HTTPShard, JobSpec, LocalFleet, ServeConfig
from metrics_tpu_torch.serve.fleet import build_router, build_shard_registry
from metrics_tpu_torch.serve.soak import trees_bitwise_equal
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import EvalServer

S = 16
BLOCK = 8
SHARDS = 2
ROWS, BATCH = 384, 48


def _port_spec():
    build = functools.partial(MeanSquaredError, device="cpu")
    return FleetSpec(
        num_shards=SHARDS,
        jobs=[JobSpec("mse", build), JobSpec("tenants", build, num_streams=S)],
        server_config=ServeConfig(block_rows=BLOCK, flush_interval=3600.0),
        ring_capacity=1024,
        device="cpu",
    )


def _jax_spec():
    return jserve.FleetSpec(
        num_shards=SHARDS,
        jobs=[jserve.JobSpec("mse", JMeanSquaredError), jserve.JobSpec("tenants", JMeanSquaredError, num_streams=S)],
        server_config=jserve.ServeConfig(block_rows=BLOCK, flush_interval=3600.0),
        ring_capacity=1024,
    )


def _feed(coordinator):
    tenants = ColumnTraffic("tenants", arity=2, num_streams=S, seed=5, dyadic=True)
    plain = ColumnTraffic("mse", arity=2, seed=6, dyadic=True)
    for lo in range(0, ROWS, BATCH):
        cols, ids = tenants.batch(lo, lo + BATCH)
        assert coordinator.ingest_columns("tenants", cols, ids) == (BATCH, 0)
        cols, _ = plain.batch(lo, lo + BATCH)
        assert coordinator.ingest_columns("mse", cols) == (BATCH, 0)
    assert coordinator.flush(30.0)


@pytest.fixture(scope="module")
def coordinators():
    """name -> a fed coordinator of one of the four fleets."""
    stops, out = [], {}
    try:
        port_fleet = LocalFleet(_port_spec()).start()
        stops.append(port_fleet.stop)
        out["port"] = port_fleet.coordinator
        jax_fleet = jserve.LocalFleet(_jax_spec()).start()
        stops.append(jax_fleet.stop)
        out["jax"] = jax_fleet.coordinator

        # the port's coordinator over two JAX workers
        jspec = _jax_spec()
        jrouter = jfleet.build_router(jspec)
        jworkers = [jserve.EvalServer(jfleet.build_shard_registry(jspec, s, jrouter), jspec.server_config).start()
                    for s in range(SHARDS)]
        stops.extend(w.kill for w in jworkers)
        port_over_jax = FleetCoordinator(build_router(_port_spec()), [HTTPShard("127.0.0.1", w.port) for w in jworkers])
        stops.append(port_over_jax.stop)
        out["port_over_jax"] = port_over_jax.start()

        # the JAX coordinator over two of the port's workers
        spec = _port_spec()
        router = build_router(spec)
        workers = [EvalServer(build_shard_registry(spec, s, router), spec.server_config).start() for s in range(SHARDS)]
        stops.extend(w.kill for w in workers)
        jax_over_port = jserve.FleetCoordinator(jrouter, [jserve.HTTPShard("127.0.0.1", w.port) for w in workers])
        stops.append(jax_over_port.stop)
        out["jax_over_port"] = jax_over_port.start()

        for coordinator in out.values():
            _feed(coordinator)
        yield out
    finally:
        for stop in reversed(stops):
            stop()


PAIRS = [("port", "jax"), ("port_over_jax", "jax"), ("jax_over_port", "port"), ("port_over_jax", "jax_over_port")]


def test_the_routers_place_alike():
    ours, theirs = build_router(_port_spec()), jfleet.build_router(_jax_spec())
    assert ours.owner("mse") == theirs.owner("mse")
    assert [ours.span("tenants", s) for s in range(SHARDS)] == [theirs.span("tenants", s) for s in range(SHARDS)]


@pytest.mark.parametrize("a,b", PAIRS)
def test_compute_all_is_bitwise_equal(coordinators, a, b):
    left, right = coordinators[a].compute_all(), coordinators[b].compute_all()
    assert all(value == value for value in left["tenants"]), "every stream is touched: no NaN crosses the wire"
    assert trees_bitwise_equal(left, right), (left, right)


@pytest.mark.parametrize("a,b", PAIRS)
def test_scatter_gather_reads_are_equal(coordinators, a, b):
    left, right = coordinators[a], coordinators[b]
    for k in (1, 5, S):
        for largest in (True, False):
            assert left.top_k("tenants", k, largest=largest) == right.top_k("tenants", k, largest=largest)
    for op, threshold in (("ge", 1.0), ("lt", 0.5), ("gt", 100.0)):
        assert left.where("tenants", op, threshold, k=S) == right.where("tenants", op, threshold, k=S)
    ids = [15, 0, 7, 8, 3]
    assert trees_bitwise_equal(left.compute_streams("tenants", ids), right.compute_streams("tenants", ids))
