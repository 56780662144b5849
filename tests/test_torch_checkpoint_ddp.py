"""Two processes checkpointing the port's metrics through a ``torch.distributed`` group (gloo) on the CPU.

The test runs two ranks of this file as a script (``python
tests/test_torch_checkpoint_ddp.py RANK STORE CKPT OUT``) that meet through a
``FileStore`` in a temporary directory.  Each rank feeds its half of the
batches into a ``MultiStreamMetric(Accuracy)`` and a ``MeanMetric``, then
both save one checkpoint collectively: ``CheckpointManager`` takes its rank
and world size from the group and runs its barrier, commit broadcast and
restore quorum over the group's key-value store.  Both ranks then restore
the step (the quorum must agree on it), and each must get its own shard back
bit for bit; they also sync the per-stream accuracy.  The test process
restores the same checkpoint at world size 1, folding rank 1's shard into
rank 0's (the elastic restore): every state must equal one process that saw
all the batches, bitwise (the values are multiples of 1/8, so the float
sums are exact in any order), and so must the ranks' synced accuracy.
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
S, C, B, N_BATCHES = 6, 4, 40, 4
LAUNCH_LIMIT = 60.0


def _batches():
    rng = np.random.default_rng(0)
    return [
        (rng.integers(0, C, B), rng.integers(0, C, B), rng.integers(-1, S + 1, B), (rng.integers(-64, 64, B) / 8).astype(np.float32))
        for _ in range(N_BATCHES)
    ]


def _collection(mt):
    return mt.MetricCollection(
        {
            "acc": mt.MultiStreamMetric(mt.Accuracy(num_classes=C, device="cpu"), num_streams=S, device="cpu"),
            "mean": mt.MeanMetric(device="cpu"),
        },
        device="cpu",
    )


def _feed(col, batches):
    for preds, target, ids, vals in batches:
        col["acc"].update(torch.from_numpy(preds), torch.from_numpy(target), stream_ids=torch.from_numpy(ids))
        col["mean"].update(torch.from_numpy(vals))


def _states(col) -> dict:
    return {
        f"{name}.{k}": (v.numpy().copy() if isinstance(v, torch.Tensor) else np.array(v))
        for name, m in col.items()
        for k, v in m.state_pytree().items()
    }


# ------------------------------------------------------------------ ranks
def _worker(rank: int, store_path: str, ckpt: str, out: Path) -> None:
    import torch.distributed as dist

    import metrics_tpu_torch as mt
    from metrics_tpu_torch.checkpoint import CheckpointManager

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    col = _collection(mt)
    _feed(col, _batches()[rank::WORLD])
    mgr = CheckpointManager(ckpt, barrier_timeout=30.0)
    saved = {"identity": np.array([mgr.rank, mgr.world_size, mgr._kv_client() is not None])}
    saved["step"] = np.array(mgr.save(col))
    before = _states(col)
    again = _collection(mt)
    result = CheckpointManager(ckpt, barrier_timeout=30.0).restore(again)
    saved["restored_step"] = np.array(result.step)
    saved["same_shard"] = np.array(all(v.tobytes() == before[k].tobytes() for k, v in _states(again).items()))
    saved["synced_acc"] = again["acc"].compute().numpy()
    np.savez(out / f"rank{rank}.npz", **saved)
    dist.destroy_process_group()


# ------------------------------------------------------------------ test
def test_two_ranks_save_through_the_group_store_and_restore_at_world_one(tmp_path):
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.checkpoint import CheckpointManager

    out = tmp_path / "out"
    out.mkdir()
    ckpt = str(tmp_path / "ckpt")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    deadline = time.monotonic() + LAUNCH_LIMIT
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), str(tmp_path / "store"), ckpt, str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(WORLD)
    ]
    # the single-process reference, while the ranks run
    one = _collection(mt)
    _feed(one, _batches())
    want = _states(one)
    want_acc = one["acc"].compute().numpy()
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log}"
    ranks = [dict(np.load(out / f"rank{rank}.npz")) for rank in range(WORLD)]
    for rank, got in enumerate(ranks):
        assert got["identity"].tolist() == [rank, WORLD, True]
        assert int(got["step"]) == 0 and int(got["restored_step"]) == 0
        assert bool(got["same_shard"]), f"rank {rank} did not get its own shard back bit for bit"
        assert got["synced_acc"].tobytes() == want_acc.tobytes(), rank

    folded = _collection(mt)
    result = CheckpointManager(ckpt, rank=0, world_size=1).restore(folded)
    assert result.world_size == WORLD and result.folded_shards == [1]
    got = _states(folded)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key
    assert folded["acc"].compute().numpy().tobytes() == want_acc.tobytes()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], Path(sys.argv[4]))
