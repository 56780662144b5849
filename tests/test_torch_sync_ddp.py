"""Two processes syncing the port's metrics over ``torch.distributed`` (gloo) on the CPU.

Each scenario runs two ranks of this file as a script (``python
tests/test_torch_sync_ddp.py SCENARIO RANK STORE OUT``) that rendezvous
through a ``FileStore`` in a temporary directory (no fixed port) and write
what they saw under ``OUT``; its test then checks that, against the JAX
package where there is a reference.  The four launches start together, and
each has a hard time limit, so a hang fails that one test.

* ``union``: configuration 2 (macro ``Accuracy``/``F1Score``/``Precision`` and
  a ``ConfusionMatrix`` in a ``MetricCollection``) with a ``CatMetric`` (over a
  group of its own, ``process_group=``), a ``MeanMetric`` and a ``MaxMetric``
  on uneven shards.  Every rank's
  ``compute()`` equals the JAX package's single-process compute on the union
  (ints bitwise, floats to ``rtol=1e-6``), and ``unsync`` restores each
  rank's local state.
* ``desync``: rank 1 counts 6 classes where rank 0 counts 7; both ranks
  raise ``SyncDesyncError`` naming the peer and the state.
* ``stall``: rank 1 never syncs; rank 0 raises ``SyncTimeoutError`` within
  its budget, a later sync over the group refuses at once, and both ranks
  exit cleanly.
* ``delta``: a ``CatMetric`` over five rounds: round 1 is full, later rounds
  ship only the new rows, and clearing one rank's cache sends both back to
  one full gather.
"""

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
C = 7
SIZES = (48, 48, 48, 21)
SHARDS = {0: (0, 1), 1: (2, 3)}  # uneven: 96 rows on rank 0, 69 on rank 1
STALL_TIMEOUT = 1.0
LAUNCH_LIMIT = 60.0


def _batches(seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for size in SIZES:
        scores = ((np.argsort(rng.random((size, C)), axis=1) + 0.5) / C).astype(np.float32)
        out.append((scores, rng.integers(0, C, size)))
    return out


def _batch_stats(scores: np.ndarray, labels: np.ndarray):
    """Each sample's top score, and the batch's accuracy (a float32 scalar)."""
    top = scores.max(axis=1)
    acc = np.float32((scores.argmax(axis=1) == labels).sum()) / np.float32(len(labels))
    return top, np.float32(acc)


def _config2(pkg, collection_kwargs: dict, **kwargs):
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=C, average="macro", **kwargs),
            "f1": pkg.F1Score(num_classes=C, average="macro", **kwargs),
            "prec": pkg.Precision(num_classes=C, average="macro", **kwargs),
            "cm": pkg.ConfusionMatrix(num_classes=C, **kwargs),
        },
        **collection_kwargs,
    )


# ------------------------------------------------------------------ ranks
def _local_states(metric) -> dict:
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in metric.state_pytree().items()}


def _same_states(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a
    )


def _rank_union(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    import torch.distributed as dist

    col = _config2(mt, {"device": "cpu"}, device="cpu")
    group = dist.new_group([0, 1])  # a group of its own, named through process_group=
    cat = mt.CatMetric(device="cpu", process_group=group)
    mean, mx = mt.MeanMetric(device="cpu"), mt.MaxMetric(device="cpu")
    batches = _batches()
    for i in SHARDS[rank]:
        scores, labels = batches[i]
        col.update(torch.from_numpy(scores), torch.from_numpy(labels))
        top, acc = _batch_stats(scores, labels)
        cat.update(torch.from_numpy(top))
        mean.update(torch.tensor(acc), weight=float(len(labels)))
        mx.update(torch.tensor(acc))
    members = {**{f"col.{k}": m for k, m in col.items(keep_base=True)}, "cat": cat, "mean": mean, "max": mx}
    before = {name: _local_states(m) for name, m in members.items()}
    results = {f"col.{k}": v for k, v in col.compute().items()}
    results.update(cat=cat.compute(), mean=mean.compute(), max=mx.compute())
    unsynced = all(_same_states(before[n], _local_states(m)) and not m._is_synced for n, m in members.items())
    with col["acc"].sync_context():  # the counts behind the scores, as synced
        results.update({f"acc.{k}": getattr(col["acc"], k) for k in ("tp", "fp", "tn", "fn")})
    np.savez(out / f"rank{rank}.npz", **{k: v.numpy() for k, v in results.items()})
    (out / f"rank{rank}.json").write_text(json.dumps({
        "unsynced": unsynced,
        "aggregate": col.aggregate_sync_report(),
        "cat_report": cat.last_sync_report,
    }))


def _rank_desync(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.utils.exceptions import SyncDesyncError

    classes = C if rank == 0 else C - 1
    cm = mt.ConfusionMatrix(num_classes=classes, device="cpu")
    scores, labels = _batches()[rank]
    cm.update(torch.from_numpy(scores[:, :classes]), torch.from_numpy(labels % classes))
    try:
        cm.compute()
    except SyncDesyncError as err:
        seen = {"error": type(err).__name__, "rank": err.rank, "state": err.state}
    else:
        seen = {"error": None}
    (out / f"rank{rank}.json").write_text(json.dumps(seen))


def _rank_stall(rank: int, out: Path, store) -> None:
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.utils.exceptions import SyncTimeoutError

    if rank == 0:
        metric = mt.SumMetric(device="cpu", sync_timeout=STALL_TIMEOUT)
        metric.update(3.0)
        start = time.monotonic()
        try:
            metric.compute()
        except SyncTimeoutError as err:
            seen = {"error": type(err).__name__, "timeout": err.timeout, "attempts": err.attempts,
                    "state": err.state, "elapsed": time.monotonic() - start}
        else:
            seen = {"error": None}
        # the group is out of step now: a later sync refuses at once, and
        # on_sync_error="local" keeps compute alive on the local state
        later = mt.SumMetric(device="cpu", on_sync_error="local")
        later.update(2.0)
        start = time.monotonic()
        seen["local_value"] = float(later.compute())
        seen["local_elapsed"] = time.monotonic() - start
        seen["local_error"] = later.last_sync_report["error"]
        (out / "rank0.json").write_text(json.dumps(seen))
    # exit together, without tearing down a group whose collective was
    # abandoned: rank 1 (the stalled peer) leaves only after rank 0 is done
    store.set(f"exit/{rank}", "1")
    store.wait([f"exit/{1 - rank}"], timedelta(seconds=30))
    sys.stdout.flush()
    os._exit(0)


def _rank_delta(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    cat = mt.CatMetric(device="cpu")
    seen = []
    for rnd in range(5):
        if rnd == 3 and rank == 1:
            cat._delta_cache.clear()  # this rank lost its prefix: every rank must fall back
        cat.update(torch.arange(2 + rank + rnd, dtype=torch.float32) + 100 * rnd + 10 * rank)
        value = cat.compute()
        rep = cat.last_sync_report
        seen.append({"value": value.tolist(), "delta": rep["delta"], "bytes": rep["bytes_gathered"]})
    (out / f"rank{rank}.json").write_text(json.dumps(seen))


def _worker(scenario: str, rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    if scenario == "stall":
        _rank_stall(rank, out, store)
    {"union": _rank_union, "desync": _rank_desync, "delta": _rank_delta}[scenario](rank, out)
    dist.destroy_process_group()


# ------------------------------------------------------------------ tests
class _Launch:
    """Both ranks of one scenario, started at once."""

    def __init__(self, scenario: str, where: Path):
        self.scenario, self.out = scenario, where / "out"
        self.out.mkdir()
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
        self.deadline = time.monotonic() + LAUNCH_LIMIT
        self.procs = [
            subprocess.Popen(
                [sys.executable, __file__, scenario, str(rank), str(where / "store"), str(self.out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(WORLD)
        ]

    def result(self) -> Path:
        """Wait for both ranks; fail on a non-zero exit or past the time limit."""
        try:
            logs = [p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))[0] for p in self.procs]
        finally:
            self.kill()
        for rank, (proc, log) in enumerate(zip(self.procs, logs)):
            assert proc.returncode == 0, f"rank {rank} of {self.scenario} exited {proc.returncode}:\n{log}"
        return self.out

    def kill(self) -> None:
        for proc in self.procs:
            proc.kill()


_LAUNCHED: dict = {}


def _launched(tmp_path_factory, scenario: str) -> _Launch:
    """Every scenario's two ranks, all started by the first test that asks: they wait on
    each other, not on the CPU, so together they take about as long as one."""
    if not _LAUNCHED:
        _LAUNCHED.update({s: _Launch(s, tmp_path_factory.mktemp(s)) for s in ("union", "desync", "stall", "delta")})
    return _LAUNCHED[scenario]


def test_two_ranks_compute_the_union_like_the_jax_package(tmp_path_factory):
    import metrics_tpu as jm

    launch = _launched(tmp_path_factory, "union")  # the reference below runs while the ranks do
    eager = {"jit_update": False, "jit_compute": False}  # the same values, without a jit compile per instance
    ref_col = _config2(jm, {}, **eager)
    ref_cat, ref_mean, ref_max = jm.CatMetric(**eager), jm.MeanMetric(**eager), jm.MaxMetric(**eager)
    for scores, labels in _batches():  # the union, in rank order
        ref_col.update(scores, labels)
        top, acc = _batch_stats(scores, labels)
        ref_cat.update(top)
        ref_mean.update(acc, weight=float(len(labels)))
        ref_max.update(acc)
    ref = {f"col.{k}": np.asarray(v) for k, v in ref_col.compute().items()}
    ref.update(cat=np.asarray(ref_cat.compute()), mean=np.asarray(ref_mean.compute()), max=np.asarray(ref_max.compute()))
    ref.update({f"acc.{k}": np.asarray(ref_col["acc"]._state[k]) for k in ("tp", "fp", "tn", "fn")})
    out = launch.result()
    got = [dict(np.load(out / f"rank{rank}.npz")) for rank in range(WORLD)]
    for rank in range(WORLD):
        assert got[rank].keys() == ref.keys()
        for key, want in ref.items():
            have = got[rank][key]
            assert have.shape == want.shape and have.dtype == want.dtype, key
            if np.issubdtype(want.dtype, np.integer):
                np.testing.assert_array_equal(have, want, err_msg=key)
            else:
                np.testing.assert_allclose(have, want, rtol=1e-6, atol=0, err_msg=key)
            np.testing.assert_array_equal(have, got[0][key], err_msg=f"{key}: ranks differ")
        seen = json.loads((out / f"rank{rank}.json").read_text())
        assert seen["unsynced"], "compute() left a rank's state synced"
        agg = seen["aggregate"]
        assert agg["members_reporting"] == 4 and not agg["errors"]
        assert agg["preflight_calls"] == 4 * 2 and agg["gather_calls"] == 4 * 2  # meta + digests; sizes + blob
        assert seen["cat_report"]["world_size"] == WORLD and seen["cat_report"]["backend"] == "DistBackend"


def test_desynced_peer_raises_on_both_ranks(tmp_path_factory):
    out = _launched(tmp_path_factory, "desync").result()
    for rank in range(WORLD):
        seen = json.loads((out / f"rank{rank}.json").read_text())
        assert seen == {"error": "SyncDesyncError", "rank": 1 - rank, "state": "confmat"}


def test_stalled_peer_times_out_on_the_live_rank(tmp_path_factory):
    out = _launched(tmp_path_factory, "stall").result()
    seen = json.loads((out / "rank0.json").read_text())
    assert seen["error"] == "SyncTimeoutError"
    assert (seen["timeout"], seen["attempts"], seen["state"]) == (STALL_TIMEOUT, 1, "preflight/schema")
    assert seen["elapsed"] < STALL_TIMEOUT * 1 + 2.0
    assert seen["local_value"] == 2.0 and seen["local_elapsed"] < 1.0
    assert seen["local_error"].startswith("SyncError")


def test_delta_rounds_and_a_cleared_cache_fall_back_together(tmp_path_factory):
    out = _launched(tmp_path_factory, "delta").result()
    seen = [json.loads((out / f"rank{rank}.json").read_text()) for rank in range(WORLD)]

    def rows(rank, rnd):
        return (np.arange(2 + rank + rnd) + 100 * rnd + 10 * rank).tolist()

    for rnd in range(5):
        if rnd in (0, 3):  # a full gather: every rank's rows so far, in rank order
            want = [r for rank in range(WORLD) for k in range(rnd + 1) for r in rows(rank, k)]
        else:  # a delta round: this round's rows of every rank, after the gathered prefix
            want = seen[0][rnd - 1]["value"] + [r for rank in range(WORLD) for r in rows(rank, rnd)]
        for rank in range(WORLD):
            step = seen[rank][rnd]
            assert step["delta"] is (rnd not in (0, 3)), (rank, rnd)
            assert step["value"] == want, (rank, rnd)
    # a delta round ships its own rows only, fewer bytes than the full gather of round 3
    assert max(seen[0][rnd]["bytes"] for rnd in (1, 2, 4)) < seen[0][3]["bytes"]

if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
