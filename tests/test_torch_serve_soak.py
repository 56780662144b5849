"""The port's soak harness and its fleet drills over worker processes, on the CPU.

Mirrors ``tests/serve/test_soak.py`` and ``tests/serve/test_fleet_soak.py``
with ``device="cpu"``, slow tier as they are there (run with ``-m slow``):
the kill→restore soak drill under injected store faults, and two
``python -m metrics_tpu_torch.serve.worker --device cpu`` processes behind
one coordinator through a SIGKILL and failover, a WAL kill storm with zero
resends, and a resize storm, each bitwise an uninterrupted twin.  The
tier-1 case holds ``soak.trees_bitwise_equal`` to what the drills need of
it: tensors on any device, numpy arrays and jsonable floats compare bit for
bit, NaN payloads and signs included.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from metrics_tpu_torch.obs import counter_value
from metrics_tpu_torch.serve import (
    ColumnTraffic,
    FleetCoordinator,
    FleetSpec,
    HTTPShard,
    WalWriter,
    make_fleet_http_server,
    run_process_load,
)
from metrics_tpu_torch.serve.fleet import build_router
from metrics_tpu_torch.serve.soak import run_drill, trees_bitwise_equal
from metrics_tpu_torch.serve.worker import drill_jobs

NUM_SHARDS = 2
S = 16
BLOCK = 8


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)


class TestTreesBitwiseEqual:
    def test_tensors_arrays_and_floats_compare_bit_for_bit(self):
        card_nan, cpu_nan = _f32(0x7FFFFFFF), _f32(0xFFC00000)
        values = np.concatenate([np.float32([0.125, -0.0, np.inf]), cpu_nan])
        as_json = [0.125, -0.0, float("inf"), float(cpu_nan[0])]
        assert trees_bitwise_equal(torch.from_numpy(values), values)
        assert trees_bitwise_equal({"a": torch.from_numpy(values), "b": 3}, {"a": values, "b": torch.tensor(3)})
        assert trees_bitwise_equal(torch.from_numpy(values).tolist(), as_json)
        assert trees_bitwise_equal(torch.from_numpy(values[:3]).to(torch.bfloat16), values[:3])
        # the card's NaN is not the CPU's; +0.0 is not -0.0; shapes and keys must agree
        assert not trees_bitwise_equal(torch.from_numpy(card_nan), cpu_nan)
        assert not trees_bitwise_equal(torch.tensor([0.0]), torch.tensor([-0.0]))
        assert not trees_bitwise_equal(torch.zeros(2), torch.zeros(3))
        assert not trees_bitwise_equal({"a": 1.0}, {"b": 1.0})
        assert not trees_bitwise_equal([1.0, 2.0], torch.tensor([1.0, 2.0]))


@pytest.mark.slow
def test_soak_drill_under_faults(tmp_path):
    failures_before = counter_value("serve.checkpoint_failures")
    result = run_drill(
        str(tmp_path),
        n=1500,
        k=900,
        lost_tail=15,
        block_rows=64,
        store_faults=[("torn_write", "MANIFEST")],
        poll=True,
        device="cpu",
    )

    # the durability claim: recovery is bit-identical to never dying
    assert result.identical, {
        "baseline": result.baseline,
        "recovered": result.recovered,
    }
    assert result.restored_step == result.checkpoint_step
    assert result.final_step is not None

    # the chaos actually fired and the service rode it out
    assert ("torn_write", "step_00000000/MANIFEST.json") in result.chaos_injected
    assert result.checkpoint_failures >= 1
    assert counter_value("serve.checkpoint_failures") >= failures_before + 1
    assert result.sync_report.get("fallback") == "local"
    assert result.sync_report.get("faults_injected")

    # the HTTP surface never went dark: every poll in both phases got a 2xx
    assert result.poller_failures == []
    assert result.poller_summary["phase1"]["requests"] > 0
    assert result.poller_summary["phase2"]["requests"] > 0


class WorkerProc:
    """One ``python -m metrics_tpu_torch.serve.worker --device cpu`` child + its HTTP handle."""

    def __init__(
        self, shard, checkpoint_root, num_shards=NUM_SHARDS, wal=False
    ):
        self.shard = shard
        argv = [
                sys.executable,
                "-m",
                "metrics_tpu_torch.serve.worker",
                "--shard", str(shard),
                "--num-shards", str(num_shards),
                "--num-streams", str(S),
                "--block-rows", str(BLOCK),
                "--checkpoint-root", checkpoint_root,
                "--device", "cpu",
        ]
        if wal:
            argv.append("--wal-exactly-once")
        self.proc = subprocess.Popen(
            argv,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )
        line = self.proc.stdout.readline().strip()
        assert line.startswith("READY "), f"worker {shard}: {line!r}"
        self.port = int(line.split()[1])
        self.handle = HTTPShard("127.0.0.1", self.port)

    def sigkill(self):
        self.proc.kill()
        self.proc.wait(timeout=10.0)

    def terminate(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10.0)


class SubprocessFleet:
    """A coordinator over subprocess workers, with respawn-from-checkpoint."""

    def __init__(self, checkpoint_root, num_shards=NUM_SHARDS, wal_root=None):
        self.checkpoint_root = checkpoint_root
        self.wal_root = wal_root
        spec = FleetSpec(num_shards=num_shards, jobs=drill_jobs(S, device="cpu"), device="cpu")
        self.router = build_router(spec)
        self.workers = [
            WorkerProc(
                shard,
                checkpoint_root,
                num_shards=num_shards,
                wal=wal_root is not None,
            )
            for shard in range(num_shards)
        ]
        # the WAL lives with the COORDINATOR (the tier that fronts ingest), not
        # the workers: acks become durable before a worker ever sees rows
        self.wal = {}
        if wal_root is not None:
            for shard in range(num_shards):
                # small segments so the drill exercises rotation + GC
                self.wal[shard] = WalWriter(
                    os.path.join(wal_root, f"shard_{shard:04d}"),
                    segment_bytes=4096,
                )
        self.coordinator = FleetCoordinator(
            self.router,
            [w.handle for w in self.workers],
            respawn=self._respawn,
            provision=self._provision,
            retire=self._retire,
            ring_capacity=4096,
            wal=self.wal or None,
        ).start()

    def _respawn(self, shard):
        # a replacement must agree with the LIVE epoch's span layout (the
        # coordinator's router may be ahead of the construction-time one
        # after a resize)
        replacement = WorkerProc(
            shard,
            self.checkpoint_root,
            num_shards=self.coordinator.router.num_shards,
            wal=self.wal_root is not None,
        )
        self.workers[shard] = replacement
        return replacement.handle

    def _provision(self, shard, router):
        worker = WorkerProc(
            shard,
            self.checkpoint_root,
            num_shards=router.num_shards,
            wal=self.wal_root is not None,
        )
        while len(self.workers) <= shard:
            self.workers.append(None)
        self.workers[shard] = worker
        return worker.handle

    def _retire(self, shard):
        if shard < len(self.workers) and self.workers[shard] is not None:
            self.workers[shard].terminate()
            self.workers[shard] = None

    def feed(self, lo, hi, dyadic=False):
        """Deterministic single-threaded feed: both runs see the same rows
        in the same order, so block boundaries (and float accumulation
        order) match exactly.  ``dyadic`` quantizes values to multiples of
        1/8 — required when the twin fleets shard DIFFERENTLY (a resize
        drill), where block groupings diverge and only exact accumulation
        can stay bitwise."""
        tenant = ColumnTraffic(
            "per_tenant", arity=2, num_streams=S, seed=21, dyadic=dyadic
        )
        plain = ColumnTraffic("mse", arity=2, seed=22, dyadic=dyadic)
        for start in range(lo, hi, 64):
            end = min(start + 64, hi)
            cols, ids = tenant.batch(start, end)
            accepted, rejected = self.coordinator.ingest_columns(
                "per_tenant", cols, ids
            )
            assert (accepted, rejected) == (end - start, 0)
            cols, _ = plain.batch(start, end)
            accepted, rejected = self.coordinator.ingest_columns("mse", cols)
            assert (accepted, rejected) == (end - start, 0)

    def checkpoint_all(self):
        # the workers' HTTP POST /flush + /checkpoint routes, end to end
        steps = {
            w.shard: w.handle.checkpoint()
            for w in self.workers
            if w is not None
        }
        # once a checkpoint commits, the segments its watermarks cover are
        # garbage — same GC the LocalFleet runs
        for w in self.workers:
            if w is None:
                continue
            writer = self.wal.get(w.shard)
            marks = w.handle.last_checkpoint_wal_marks
            if writer is not None and marks:
                writer.truncate_covered(marks)
        return steps

    def stop(self):
        self.coordinator.stop()
        for w in self.workers:
            if w is not None:
                w.terminate()
        for writer in self.wal.values():
            writer.close()


@pytest.mark.slow
def test_subprocess_fleet_kill9_failover_is_bitwise(tmp_path):
    fleet = SubprocessFleet(str(tmp_path / "fleet"))
    twin = SubprocessFleet(str(tmp_path / "twin"))
    frontend = make_fleet_http_server("127.0.0.1", 0, fleet.coordinator)
    http_thread = threading.Thread(
        target=lambda: frontend.serve_forever(poll_interval=0.1), daemon=True
    )
    http_thread.start()
    try:
        # phase 1: identical cadence on both fleets, snapshots committed
        for f in (fleet, twin):
            f.feed(0, 600)
            assert f.coordinator.flush(60.0)
            steps = f.checkpoint_all()
            assert sorted(steps) == [0, 1]

        # SIGKILL one worker: no drain, no final checkpoint
        victim = fleet.router.shard_for("per_tenant", 0)
        fleet.workers[victim].sigkill()
        deadline = time.monotonic() + 30.0
        while fleet.coordinator.health()["status"] != "degraded":
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert fleet.coordinator.health()["dead_shards"] == [victim]

        # phase 2 rows keep flowing: the dead shard's park in its ring
        failovers = counter_value("serve.failovers", shard=str(victim))
        for f in (fleet, twin):
            f.feed(600, 900)

        fleet.coordinator.failover(victim)
        assert (
            counter_value("serve.failovers", shard=str(victim))
            == failovers + 1
        )
        for f in (fleet, twin):
            assert f.coordinator.flush(60.0)
        assert fleet.coordinator.health()["status"] == "serving"

        # the durability claim, over real process boundaries: recovery is
        # bit-identical to never having died
        assert trees_bitwise_equal(
            fleet.coordinator.compute_all(), twin.coordinator.compute_all()
        )

        # process-mode load against the recovered frontend stays clean
        port = frontend.server_address[1]
        report = run_process_load(
            f"http://127.0.0.1:{port}",
            "per_tenant",
            total_records=400,
            processes=2,
            batch_rows=50,
            num_streams=S,
        )
        assert report.records == 400
        assert report.accepted == 400 and report.rejected == 0
        assert report.errors == []
        assert fleet.coordinator.flush(60.0)
        values, ids = fleet.coordinator.top_k("per_tenant", 4)
        assert len(values) == len(ids) == 4
    finally:
        frontend.shutdown()
        http_thread.join(timeout=5.0)
        frontend.server_close()
        fleet.stop()
        twin.stop()


@pytest.mark.slow
def test_subprocess_wal_kill_storm_zero_resend_is_bitwise(tmp_path):
    """The durable-ingest headline over REAL processes: every row flushed
    into (and acked by) the workers, a SIGKILL storm takes the ENTIRE
    fleet between checkpoints, and the feeder re-sends nothing.  Recovery
    is checkpoint restore + WAL replay from the applied-seq watermarks —
    and ``compute_all`` must still be bit-identical to a never-killed
    twin.  The WAL-disabled drill above is the contrast: there, recovery
    leans on rows still parked in the coordinator's ring."""
    fleet = SubprocessFleet(
        str(tmp_path / "fleet"), wal_root=str(tmp_path / "fleet_wal")
    )
    twin = SubprocessFleet(str(tmp_path / "twin"))
    try:
        # phase 1: both fleets land the same rows and commit checkpoints
        # (which carry the per-job applied-seq watermarks)
        for f in (fleet, twin):
            f.feed(0, 600)
            assert f.coordinator.flush(60.0)
            steps = f.checkpoint_all()
            assert sorted(steps) == [0, 1]

        # phase 2: rows PAST the checkpoint — flushed all the way into
        # worker metric state and acked, so the coordinator's rings are
        # EMPTY when the storm hits.  Only the WAL covers these rows.
        for f in (fleet, twin):
            f.feed(600, 900)
            assert f.coordinator.flush(60.0)

        # the storm: every worker dies at once, no drain, no checkpoint
        for w in fleet.workers:
            w.sigkill()
        deadline = time.monotonic() + 30.0
        while fleet.coordinator.health()["status"] != "degraded":
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert sorted(fleet.coordinator.health()["dead_shards"]) == [0, 1]

        # recovery: failover only — the feeder does NOT re-send a single
        # row.  Replay must come from the log.
        replayed_before = sum(
            counter_value("serve.wal_replayed_rows", shard=str(s))
            for s in range(NUM_SHARDS)
        )
        for shard in range(NUM_SHARDS):
            fleet.coordinator.failover(shard)
        assert fleet.coordinator.health()["status"] == "serving"
        assert (
            sum(
                counter_value("serve.wal_replayed_rows", shard=str(s))
                for s in range(NUM_SHARDS)
            )
            > replayed_before
        )

        for f in (fleet, twin):
            assert f.coordinator.flush(60.0)
        assert trees_bitwise_equal(
            fleet.coordinator.compute_all(), twin.coordinator.compute_all()
        )

        # and the log GCs: a post-recovery checkpoint covers the replayed
        # frames, so truncation reclaims the sealed segments
        fleet.checkpoint_all()
        lag = sum(w.lag_rows() for w in fleet.wal.values())
        appended = sum(w.next_seq for w in fleet.wal.values())
        assert appended > 0 and lag < 900 * 2  # strictly less than the feed
    finally:
        fleet.stop()
        twin.stop()


@pytest.mark.slow
def test_subprocess_resize_storm_sigkill_is_bitwise(tmp_path):
    """The elastic drill over REAL processes: grow 2→4, then shrink 4→3
    with a SIGKILL mid-migration.  The killed resize aborts pre-flip, a
    failover restores the victim from its quiesced checkpoint, the retry
    lands, and ``compute_all`` stays bit-identical to a never-resized
    3-shard twin fed the same rows."""
    fleet = SubprocessFleet(str(tmp_path / "fleet"), num_shards=2)
    twin = SubprocessFleet(str(tmp_path / "twin"), num_shards=3)
    try:
        for f in (fleet, twin):
            f.feed(0, 400, dyadic=True)
            assert f.coordinator.flush(60.0)

        def durable(phase):
            # the subprocess analogue of LocalFleet.resize's durability
            # floor: snapshot every live worker once the fleet quiesces
            if phase == "quiesced":
                fleet.checkpoint_all()

        summary = fleet.coordinator.resize(4, timeout=120.0, phase_hook=durable)
        assert summary["new_shards"] == 4 and summary["epoch"] == 1
        for f in (fleet, twin):
            f.feed(400, 600, dyadic=True)
            # settle before the storm: the kill must not race rows still
            # being forwarded (a SIGKILL always loses a worker's queued-
            # but-undispatched rows — the standing failover loss model;
            # the drill's zero-loss claim is about MIGRATED state)
            assert f.coordinator.flush(60.0)

        victim = 3  # departs in 4→3, so it must donate its whole span

        def storm(phase):
            if phase == "quiesced":
                fleet.checkpoint_all()
                fleet.workers[victim].sigkill()

        resize_failures = counter_value("serve.resize_failures")
        with pytest.raises(Exception):
            fleet.coordinator.resize(3, timeout=120.0, phase_hook=storm)
        assert counter_value("serve.resize_failures") == resize_failures + 1
        # pre-flip abort: still 4 shards on the old epoch, nothing held
        stats = fleet.coordinator.ring_stats()
        assert stats["num_shards"] == 4 and stats["epoch"] == 1
        assert stats["held_jobs"] == []

        fleet.coordinator.failover(victim)
        summary = fleet.coordinator.resize(3, timeout=120.0, phase_hook=durable)
        assert summary["new_shards"] == 3 and summary["epoch"] == 2

        for f in (fleet, twin):
            f.feed(600, 800, dyadic=True)
            assert f.coordinator.flush(60.0)
        assert trees_bitwise_equal(
            fleet.coordinator.compute_all(), twin.coordinator.compute_all()
        )
    finally:
        fleet.stop()
        twin.stop()
