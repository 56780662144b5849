"""Two processes syncing ``MeanAveragePrecision`` over ``torch.distributed`` (gloo) on the CPU.

The ranks run this file as a script (``python tests/test_torch_detection_ddp.py
SCENARIO RANK STORE OUT``) and meet through a ``FileStore`` in a temporary
directory, with a hard time limit; both scenarios' ranks start together.

* ``step``: bbox mAP with ``dist_sync_on_step=True`` (the configuration of
  COCO-val evaluation inside a DDP loop): each rank ``forward``\\ s its own
  images, step by step.  Every step's value must be bitwise one process's
  over both ranks' images of that step (in rank order), the epoch's
  ``compute()`` bitwise one process's over all of them, with every IoU block
  served from the content cache the steps filled, and the list states in
  host memory.
* ``segm``: segm mAP on the device route (``on_device=True``), synced once at
  ``compute()``, against one process over the union.
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
STEPS = 3
PER_STEP = (4, 6)  # images each rank feeds a step: uneven
LAUNCH_LIMIT = 90.0


def _bbox_images(seed: int, n: int):
    """Integer-coordinate boxes jittered off the gts, as the JAX package's parity tests draw them."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for _ in range(n):
        n_g = int(rng.integers(1, 6))
        gb = np.stack([rng.integers(0, 50, n_g), rng.integers(0, 50, n_g),
                       rng.integers(55, 90, n_g), rng.integers(55, 90, n_g)], 1).astype(np.float64)
        gl = rng.integers(0, 4, n_g)
        n_p = int(rng.integers(0, 9))
        idx = rng.integers(0, n_g, max(n_p, 1))[:n_p]
        preds.append(dict(boxes=np.clip(gb[idx] + rng.integers(-8, 9, (n_p, 4)), 0, 100),
                          scores=rng.random(n_p).astype(np.float32), labels=gl[idx]))
        targets.append(dict(boxes=gb, labels=gl))
    return preds, targets


def _step_images(step: int, rank: int):
    return _bbox_images(100 * step + rank, PER_STEP[rank])


def _segm_images(rank: int, h: int = 40, w: int = 48):
    """Blob masks on one canvas, each prediction a shifted copy of a gt."""
    rng = np.random.default_rng(50 + rank)
    preds, targets = [], []
    for _ in range(5 + 3 * rank):
        n_g = int(rng.integers(1, 5))
        gm = np.zeros((n_g, h, w), np.uint8)
        for j in range(n_g):
            y0, x0 = int(rng.integers(0, h - 6)), int(rng.integers(0, w - 6))
            gm[j, y0 : y0 + int(rng.integers(2, 14)), x0 : x0 + int(rng.integers(2, 14))] = 1
        gl = rng.integers(0, 3, n_g)
        idx = rng.integers(0, n_g, int(rng.integers(1, 7)))
        pm = np.stack([np.roll(gm[i], (int(rng.integers(-3, 4)), int(rng.integers(-3, 4))), axis=(0, 1)) for i in idx])
        preds.append(dict(masks=pm, scores=rng.random(len(idx)).astype(np.float32), labels=gl[idx]))
        targets.append(dict(masks=gm, labels=gl))
    return preds, targets


def _flat(out: dict) -> dict:
    return {k: v.numpy().tobytes().hex() for k, v in out.items()}


# ------------------------------------------------------------------ ranks
def _rank_step(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    metric = mt.MeanAveragePrecision(device="cpu", dist_sync_on_step=True)
    steps = [_flat(metric(*_step_images(step, rank))) for step in range(STEPS)]
    final = _flat(metric.compute())
    record = {"steps": steps, "final": final, "profile": metric.last_compute_profile,
              "host": all(t.device.type == "cpu" for t in metric.detections),
              "delta": metric.last_sync_report.get("delta")}
    (out / f"rank{rank}.json").write_text(json.dumps(record, default=float))


def _rank_segm(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    metric = mt.MeanAveragePrecision(iou_type="segm", device="cpu", on_device=True)
    metric.update(*_segm_images(rank))
    (out / f"rank{rank}.json").write_text(json.dumps({"final": _flat(metric.compute())}))


def _worker(scenario: str, rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=60))
    {"step": _rank_step, "segm": _rank_segm}[scenario](rank, out)
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
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
            )
            for rank in range(WORLD)
        ]

    def result(self) -> list:
        """Each rank's record; fails on a non-zero exit or past the time limit."""
        try:
            logs = [p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))[0] for p in self.procs]
        finally:
            for proc in self.procs:
                proc.kill()
        for rank, (proc, log) in enumerate(zip(self.procs, logs)):
            assert proc.returncode == 0, f"rank {rank} of {self.scenario} exited {proc.returncode}:\n{log}"
        return [json.loads((self.out / f"rank{rank}.json").read_text()) for rank in range(WORLD)]


_LAUNCHED: dict = {}


def _launched(tmp_path_factory, scenario: str) -> _Launch:
    """Both scenarios' ranks, all started by the first test that asks."""
    if not _LAUNCHED:
        _LAUNCHED.update({s: _Launch(s, tmp_path_factory.mktemp(s)) for s in ("step", "segm")})
    return _LAUNCHED[scenario]


def _one_process(preds, targets, **kwargs) -> dict:
    import metrics_tpu_torch as mt

    metric = mt.MeanAveragePrecision(device="cpu", **kwargs)
    metric.update(preds, targets)
    return _flat(metric.compute())


def test_dist_sync_on_step_equals_one_process_over_the_union(tmp_path_factory):
    import metrics_tpu as jm

    launch = _launched(tmp_path_factory, "step")
    want_steps, all_p, all_t = [], [], []
    for step in range(STEPS):
        p0, t0 = _step_images(step, 0)
        p1, t1 = _step_images(step, 1)
        want_steps.append(_one_process(p0 + p1, t0 + t1))
        all_p += p0 + p1
        all_t += t0 + t1
    want_final = _one_process(all_p, all_t)
    ref = jm.MeanAveragePrecision(device=False)
    ref.update(all_p, all_t)
    assert want_final == {k: np.asarray(v).tobytes().hex() for k, v in ref.compute().items()}
    for rank, record in enumerate(launch.result()):
        assert record["steps"] == want_steps, f"rank {rank}: a step's value is not one process's over its images"
        assert record["final"] == want_final, f"rank {rank}: the epoch value is not one process's"
        prof = record["profile"]
        assert prof["iou_cache_enabled"] and prof["iou_blocks_new"] == 0 and prof["iou_blocks_cached"] > 0
        assert record["host"]


def test_segm_device_route_synced_equals_one_process(tmp_path_factory):
    launch = _launched(tmp_path_factory, "segm")
    p0, t0 = _segm_images(0)
    p1, t1 = _segm_images(1)
    want = _one_process(p0 + p1, t0 + t1, iou_type="segm", on_device=True)
    for record in launch.result():
        assert record["final"] == want


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
