"""Two processes syncing the port's sketch metrics over ``torch.distributed`` (gloo) on the CPU.

Each scenario runs two ranks of this file as a script (``python
tests/test_torch_streaming_ddp.py SCENARIO RANK STORE OUT``) that meet
through a ``FileStore`` in a temporary directory and write what they saw
under ``OUT``.  Both launches start together, each with a hard time limit.

Rank 0 folds the first ``SPLIT`` values of one stream and rank 1 the rest,
into a ``StreamingQuantile`` and a ``WindowedMetric(StreamingQuantile)``
(the ranks advance their rings in lockstep).  ``packed`` syncs through the
default one-blob gather, ``pure`` through one stacked gather per leaf
(``Backend.all_gather_merge``).  On both ranks and both paths, the synced
leaves must be bitwise the JAX package's ``kll_merge`` of the two ranks'
states (rank order, slot by slot for the ring), and the ranks' local states
must come back after ``compute()``.
"""

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
SCENARIOS = ("packed", "pure")
N_VALUES, SPLIT, BATCH = 900, 300, 150
WINDOW, ADVANCE_EVERY = 3, 2
QUANTILE = dict(q=(0.1, 0.5, 0.99), capacity=8, max_items=1 << 9)
LAUNCH_LIMIT = 60.0


def _stream(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=N_VALUES), 2).astype(np.float32)
    v[::29] = -0.0
    v[7] = np.nan
    return v


def _shard(rank: int) -> list:
    v = _stream()
    part = v[:SPLIT] if rank == 0 else v[SPLIT:]
    return [part[i : i + BATCH] for i in range(0, part.size, BATCH)]


def _local_metrics(mt, rank: int, **kwargs):
    """Rank ``rank``'s metrics after its shard, unsynced."""
    q = mt.StreamingQuantile(device="cpu", **QUANTILE, **kwargs)
    w = mt.WindowedMetric(mt.StreamingQuantile(device="cpu", **QUANTILE), window_size=WINDOW, device="cpu", **kwargs)
    for i, batch in enumerate(_shard(rank)):
        q.update(torch.from_numpy(batch))
        w.update(torch.from_numpy(batch))
        if i % ADVANCE_EVERY == ADVANCE_EVERY - 1:
            w.advance()
    return q, w


def _leaves(metric, name: str) -> dict:
    return {k: v.numpy().copy() for k, v in metric.sketch_tree(name).items()}


# ------------------------------------------------------------------ ranks
def _worker(scenario: str, rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    import metrics_tpu_torch as mt
    from metrics_tpu_torch.parallel import DistBackend

    class _PerLeaf(DistBackend):
        supports_packed = False  # one stacked gather per sketch leaf

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    kwargs = {"sync_backend": _PerLeaf()} if scenario == "pure" else {}
    q, w = _local_metrics(mt, rank, **kwargs)
    local = {**{"q." + k: v for k, v in _leaves(q, "sketch").items()},
             **{"w." + k: v for k, v in _leaves(w, "wb_sketch").items()}}
    saved = {"value.q": q.compute().numpy(), "value.w": w.compute().numpy()}
    with q.sync_context():
        saved.update({"q." + k: v for k, v in _leaves(q, "sketch").items()})
    with w.sync_context():
        saved.update({"w." + k: v for k, v in _leaves(w, "wb_sketch").items()})
    after = {**{"q." + k: v for k, v in _leaves(q, "sketch").items()},
             **{"w." + k: v for k, v in _leaves(w, "wb_sketch").items()}}
    saved["local_kept"] = np.array(all(after[k].tobytes() == local[k].tobytes() for k in local))
    saved["bytes_gathered"] = np.array(q.last_sync_report["bytes_gathered"])
    np.savez(out / f"rank{rank}.npz", **saved)
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
_EXPECTED: dict = {}


def _launched(tmp_path_factory, scenario: str) -> _Launch:
    """Both scenarios' ranks, all started by the first test that asks."""
    if not _LAUNCHED:
        _LAUNCHED.update({s: _Launch(s, tmp_path_factory.mktemp(s)) for s in SCENARIOS})
    return _LAUNCHED[scenario]


def _expected() -> dict:
    """The JAX package's merge of the two ranks' local states (computed once, while the ranks run)."""
    if not _EXPECTED:
        import jax

        import metrics_tpu_torch as mt
        from metrics_tpu.streaming import sketches as jsk

        qs, ws = zip(*(_local_metrics(mt, rank) for rank in range(WORLD)))
        merge = jax.jit(lambda a, b: jsk.kll_merge([a, b]))
        _EXPECTED.update({"q." + k: np.asarray(v) for k, v in merge(*(_leaves(q, "sketch") for q in qs)).items()})
        ring = jax.jit(jax.vmap(lambda a, b: jsk.kll_merge([a, b])))(*(_leaves(w, "wb_sketch") for w in ws))
        _EXPECTED.update({"w." + k: np.asarray(v) for k, v in ring.items()})
        one_q = mt.StreamingQuantile(device="cpu", **QUANTILE)
        merged = {"sketch__sk_" + k[2:]: v for k, v in _EXPECTED.items() if k.startswith("q.")}
        one_q.load_state_pytree({"_update_count": 1, **merged})
        _EXPECTED["value.q"] = one_q.compute().numpy()
    return _EXPECTED


def _check(tmp_path_factory, scenario: str) -> None:
    launch = _launched(tmp_path_factory, scenario)
    want = _expected()
    out = launch.result()
    ranks = [dict(np.load(out / f"rank{rank}.npz")) for rank in range(WORLD)]
    for rank, got in enumerate(ranks):
        assert bool(got.pop("local_kept")), f"rank {rank}: compute() left the synced state in place"
        assert int(got.pop("bytes_gathered")) > 0
        for key, value in want.items():
            assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), (scenario, rank, key)
    assert ranks[0]["value.w"].tobytes() == ranks[1]["value.w"].tobytes()


def test_two_ranks_merge_sketches_through_the_packed_blob(tmp_path_factory):
    _check(tmp_path_factory, "packed")


def test_two_ranks_merge_sketches_leaf_by_leaf(tmp_path_factory):
    _check(tmp_path_factory, "pure")


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
