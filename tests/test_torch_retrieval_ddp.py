"""Two processes syncing the port's retrieval metrics and a ``BootStrapper`` over
``torch.distributed`` (gloo) on the CPU.

Each scenario runs two ranks of this file as a script (``python
tests/test_torch_retrieval_ddp.py SCENARIO RANK STORE OUT``) that meet
through a ``FileStore`` in a temporary directory and write what they saw
under ``OUT``.  Both launches start together, each with a hard time limit.

* ``retrieval``: a ``MetricCollection`` of every retrieval metric over a
  stream of whole-query batches, rank 0 the first batches and rank 1 the
  rest.  The gathered buffers are the single process's rows in rank order,
  so every synced value equals one process's bitwise, and the JAX
  package's to the tolerances of ``tests/test_torch_retrieval.py``.
* ``bootstrap``: a ``BootStrapper(MeanSquaredError)`` on each rank's shard
  with one seed.  Each copy syncs its sums, so copy ``i``'s synced value is
  that of the sum of the two ranks' copy-``i`` states: one process running
  both shards' wrappers and summing their copies gives it bitwise.
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
QUERIES, DOCS, PER_BATCH = 12, 9, 3  # 4 batches of 3 whole queries
SPLIT = 1  # rank 0 holds the first batch, rank 1 the other three
LAUNCH_LIMIT = 60.0
U = 2.0**-24
COPIES, BOOT_ROWS = 6, (20, 33)


def _stream(seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(QUERIES) * 7 + 3, DOCS)
    preds = (rng.integers(0, 16, ids.size) / 16).astype(np.float32)
    target = (rng.random(ids.size) < 0.25).astype(np.int64)
    target[ids == 3 + 7 * 4] = 0  # a query without relevant documents
    rows = PER_BATCH * DOCS
    return [(preds[i : i + rows], target[i : i + rows], ids[i : i + rows]) for i in range(0, ids.size, rows)]


def _boot_shards(seed: int = 1):
    rng = np.random.default_rng(seed)
    return [tuple((rng.integers(-16, 17, n) / 8).astype(np.float32) for _ in range(2)) for n in BOOT_ROWS]


def _collection(pkg, **kwargs):
    return pkg.MetricCollection(
        {
            "map": pkg.RetrievalMAP(**kwargs),
            "mrr": pkg.RetrievalMRR(**kwargs),
            "ndcg": pkg.RetrievalNormalizedDCG(k=4, **kwargs),
            "p": pkg.RetrievalPrecision(k=3, **kwargs),
            "r": pkg.RetrievalRecall(k=3, **kwargs),
            "hr": pkg.RetrievalHitRate(k=2, **kwargs),
            "rp": pkg.RetrievalRPrecision(**kwargs),
            "fo": pkg.RetrievalFallOut(k=3, **kwargs),
            "curve": pkg.RetrievalPrecisionRecallCurve(max_k=5, **kwargs),
            "rafp": pkg.RetrievalRecallAtFixedPrecision(min_precision=0.2, max_k=5, **kwargs),
        },
        **({"device": "cpu"} if pkg.__name__ == "metrics_tpu_torch" else {}),
    )


def _flat(out: dict) -> dict:
    flat = {}
    for key, value in out.items():
        for i, v in enumerate(value if isinstance(value, tuple) else (value,)):
            flat[f"{key}.{i}"] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return flat


# ------------------------------------------------------------------ ranks
def _rank_retrieval(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    col = _collection(mt, device="cpu")
    batches = _stream()
    for preds, target, ids in batches[:SPLIT] if rank == 0 else batches[SPLIT:]:
        col.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(ids))
    results = _flat(col.compute())
    with col["map"].sync_context():
        results["rows.preds"] = col["map"].buffer_values("preds").numpy().copy()
    np.savez(out / f"rank{rank}.npz", **results)
    (out / f"rank{rank}.json").write_text(json.dumps({
        "local": not any(m._is_synced for m in col.values()), "groups": list(col.compute_groups.values()),
    }))


def _rank_bootstrap(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    boot = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=COPIES, seed=5, raw=True,
                           quantile=0.5, device="cpu")
    preds, target = _boot_shards()[rank]
    boot.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.savez(out / f"rank{rank}.npz", **{k: v.numpy() for k, v in boot.compute().items()})


def _worker(scenario: str, rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    {"retrieval": _rank_retrieval, "bootstrap": _rank_bootstrap}[scenario](rank, out)
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
            for proc in self.procs:
                proc.kill()
        for rank, (proc, log) in enumerate(zip(self.procs, logs)):
            assert proc.returncode == 0, f"rank {rank} of {self.scenario} exited {proc.returncode}:\n{log}"
        return self.out


_LAUNCHED: dict = {}


def _launched(tmp_path_factory, scenario: str) -> _Launch:
    """Both scenarios' ranks, all started by the first test that asks."""
    if not _LAUNCHED:
        _LAUNCHED.update({s: _Launch(s, tmp_path_factory.mktemp(s)) for s in ("retrieval", "bootstrap")})
    return _LAUNCHED[scenario]


def test_two_ranks_sync_retrieval_like_one_process(tmp_path_factory):
    import jax.numpy as jnp

    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    launch = _launched(tmp_path_factory, "retrieval")  # the references below run while the ranks do
    batches = _stream()
    one, ref = _collection(mt, device="cpu"), _collection(jm, jit_update=False, jit_compute=False)
    for preds, target, ids in batches:
        one.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(ids))
        ref.update(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(ids))
    single, want = _flat(one.compute()), _flat(ref.compute())
    out = launch.result()
    for rank in range(WORLD):
        got = dict(np.load(out / f"rank{rank}.npz"))
        info = json.loads((out / f"rank{rank}.json").read_text())
        assert info["local"], "compute() left a rank synced"
        assert len(info["groups"]) == 1, info["groups"]
        assert got.pop("rows.preds").tobytes() == np.concatenate([b[0] for b in batches]).tobytes()
        assert sorted(got) == sorted(single)
        for key, value in got.items():
            assert value.dtype == single[key].dtype and value.tobytes() == single[key].tobytes(), key
            np.testing.assert_allclose(value, want[key], rtol=0, atol=(DOCS + QUERIES) * U, err_msg=key)


def test_two_ranks_sync_each_bootstrap_copy(tmp_path_factory):
    import metrics_tpu_torch as mt

    out = _launched(tmp_path_factory, "bootstrap").result()
    boots = []
    for preds, target in _boot_shards():
        boot = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=COPIES, seed=5, device="cpu")
        boot.update(torch.from_numpy(preds), torch.from_numpy(target))
        boots.append(boot)
    assert all(b._stacked for b in boots)
    base = boots[0].metrics[0]
    raw = torch.stack([
        base.apply_compute({k: a._copy_state()[k] + b._copy_state()[k] for k in base._defaults})
        for a, b in zip(boots[0].metrics, boots[1].metrics)
    ])
    want = {"raw": raw, "mean": raw.sum(0) / torch.tensor(float(COPIES)), "std": raw.std(0),
            "quantile": torch.quantile(raw, torch.tensor(0.5))}
    for rank in range(WORLD):
        got = dict(np.load(out / f"rank{rank}.npz"))
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].tobytes() == value.numpy().tobytes(), (rank, key, got[key], value)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
