"""FID (sum states) and KID (cat states) synced over two gloo ranks equal one process.

Each rank is this file run as a script (``python tests/test_torch_image_gen_ddp.py
RANK STORE OUT``); the two meet through a ``FileStore`` in a temporary directory.
Rank 0 takes the first half of the batches and rank 1 the second, with images
still queued at the sync (``extractor_batch``), so the gathered KID features are
the single process's rows in its order.  The extractor gives multiples of 1/8
(``tests/test_torch_image_gen.py``), so FID's summed states are exact: both
values equal the port's single process bitwise, and the JAX package's to the
tolerances of ``tests/test_torch_image_gen.py``.
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
LAUNCH_LIMIT = 60.0
DIM = 8
SHARDS = {0: (0, 1), 1: (2, 3)}
KID = {"subsets": 4, "subset_size": 10}


def _port_extractor(imgs):
    flat = torch.as_tensor(imgs).reshape(imgs.shape[0], -1)[:, :DIM].to(torch.int64)
    return ((flat % 16) - 8).to(torch.float32) / 8


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n, 3, 6, 6), dtype=np.uint8) for n in (5, 3, 7, 4)]


def _metrics(mt):
    return {"fid": mt.FrechetInceptionDistance(feature=_port_extractor, feature_dim=DIM, extractor_batch=3, device="cpu"),
            "kid": mt.KernelInceptionDistance(feature=_port_extractor, extractor_batch=3, device="cpu", **KID)}


def _feed(metrics, batches) -> None:
    real, fake = _batches(0), _batches(1)
    for i in batches:
        for metric in metrics.values():
            metric.update(torch.from_numpy(real[i]), True)
            metric.update(torch.from_numpy(fake[i]), False)


def _values(metrics) -> dict:
    out = {}
    for name, metric in metrics.items():
        value = metric.compute()
        out[name] = [np.asarray(v.numpy(), np.float32).tobytes().hex() for v in (value if isinstance(value, tuple) else (value,))]
    return out


def _worker(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    import metrics_tpu_torch as mt

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    metrics = _metrics(mt)
    _feed(metrics, SHARDS[rank])
    queued = all(m._queue.pending for m in metrics.values())
    values = _values(metrics)
    local_rows = len(torch.cat(metrics["kid"].real_features))  # unsynced again after compute
    gathered = metrics["kid"].last_sync_report["bytes_gathered"]
    (out / f"rank{rank}.json").write_text(json.dumps(
        {"values": values, "queued": queued, "local_rows": local_rows, "bytes_gathered": gathered}))
    dist.destroy_process_group()


def test_two_ranks_sync_fid_and_kid_like_one_process(tmp_path):
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    out = tmp_path / "out"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    deadline = time.monotonic() + LAUNCH_LIMIT
    procs = [
        subprocess.Popen([sys.executable, __file__, str(rank), str(tmp_path / "store"), str(out)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)
    ]
    one = _metrics(mt)
    _feed(one, (0, 1, 2, 3))
    want = _values(one)
    import jax.numpy as jnp

    def jax_extractor(imgs):
        flat = jnp.asarray(imgs).reshape(imgs.shape[0], -1)[:, :DIM].astype(jnp.int32)
        return ((flat % 16) - 8).astype(jnp.float32) / 8

    ref = {"fid": jm.FrechetInceptionDistance(feature=jax_extractor, feature_dim=DIM),
           "kid": jm.KernelInceptionDistance(feature=jax_extractor, **KID)}
    real, fake = _batches(0), _batches(1)
    for r, f in zip(real, fake):
        for metric in ref.values():
            metric.update(r, True)
            metric.update(f, False)
    np.testing.assert_allclose(one["fid"].compute().numpy(), np.asarray(ref["fid"].compute()), rtol=1e-4)
    kid_mean, kid_std = ref["kid"].compute()
    got_mean, got_std = one["kid"].compute()
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(kid_mean), rtol=1e-5)
    np.testing.assert_allclose(got_std.numpy(), np.asarray(kid_std), rtol=1e-5, atol=1e-5 * abs(float(kid_mean)))
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log}"
        seen = json.loads((out / f"rank{rank}.json").read_text())
        assert seen["queued"], rank  # the sync drained images still in the queue
        assert seen["values"] == want, rank
        assert seen["local_rows"] == sum(_batches(0)[i].shape[0] for i in SHARDS[rank])
        assert seen["bytes_gathered"] > 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
