"""Four processes evaluating segmentation data-parallel over ``torch.distributed`` (gloo) on the CPU, with the
Cityscapes collection of ``portbench/configs/cityscapes_seg_ddp4.json``: ``JaccardIndex``, macro ``Accuracy``
and ``ConfusionMatrix`` over 19 classes, each built with ``dist_sync_on_step=True``.

The four ranks of this file run as scripts (``python tests/test_torch_ddp_segmentation.py RANK STORE OUT``)
that rendezvous through a ``FileStore`` in a temporary directory, each with a hard time limit, and write
what they saw under ``OUT``.  Each rank runs two passes of ``forward`` on its own 32 x 64 images, one a
step, and a ``compute()`` and ``reset()`` at each pass end, with the port's spans on.  One launch serves
every test: each step's three values on every rank equal the plain reference on the four ranks' images of
that step (counts exactly, scores to 1e-6), each pass's values the reference on the pass's images of every
rank, the ranks agree bit for bit, and the sync's spans and byte counters appear.
"""

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench" / "configs" / "cityscapes_seg_ddp4.json"
WORLD = 4
H, W = 32, 64
PASSES, STEPS = 2, 3  # steps a pass on each rank, one image a step
LAUNCH_LIMIT = 60.0


def _image(rank: int, pass_: int, step: int):
    """``(1, C, H, W)`` float32 logits with one strict maximum a pixel, and ``(1, H, W)`` int64 labels that
    agree with the prediction on about 70 % of the pixels."""
    classes = json.loads(CONFIG.read_text())["num_classes"]
    gen = torch.Generator().manual_seed(1000 * rank + 100 * pass_ + step)
    logits = torch.rand(1, classes, H, W, generator=gen)
    pred = logits.argmax(1)
    other = torch.randint(0, classes, (1, H, W), generator=gen)
    labels = torch.where(torch.rand(1, H, W, generator=gen) < 0.7, pred, other)
    return logits, labels


# ------------------------------------------------------------------ ranks
def _rank(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    import metrics_tpu_torch as mt
    from metrics_tpu_torch import obs

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    cfg = json.loads(CONFIG.read_text())
    assert all(m["kwargs"]["dist_sync_on_step"] for m in cfg["metrics"])
    col = mt.MetricCollection([getattr(mt, m["class"])(**m["kwargs"], device="cpu") for m in cfg["metrics"]],
                              device="cpu")
    obs.reset()
    obs.enable()
    saved = {}
    for p in range(PASSES):
        for s in range(STEPS):
            for name, value in col(*_image(rank, p, s)).items():
                saved[f"step.{p}.{s}.{name}"] = value.numpy()
        for name, value in col.compute().items():
            saved[f"pass.{p}.{name}"] = value.numpy()
        col.reset()
    obs.disable()
    np.savez(out / f"rank{rank}.npz", **saved)
    counters = obs.counters_snapshot()
    (out / f"rank{rank}.json").write_text(json.dumps({
        "spans": sorted({name for name, _ in obs.spans_snapshot()}),
        "bytes_gathered": sum(v for (name, _), v in counters.items() if name == "sync.bytes_gathered"),
    }))
    dist.destroy_process_group()


# ------------------------------------------------------------------ tests
class _Launch:
    """The four ranks, started at once."""

    def __init__(self, where: Path):
        self.out = where / "out"
        self.out.mkdir()
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
        self.deadline = time.monotonic() + LAUNCH_LIMIT
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(rank), str(where / "store"), str(self.out)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(WORLD)
        ]
        self._done = None

    def result(self) -> Path:
        """Wait for every rank; fail on a non-zero exit or past the time limit."""
        if self._done is None:
            try:
                logs = [p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))[0] for p in self.procs]
            finally:
                for p in self.procs:
                    p.kill()
            self._done = [(p.returncode, log) for p, log in zip(self.procs, logs)]
        for rank, (code, log) in enumerate(self._done):
            assert code == 0, f"rank {rank} exited {code}:\n{log}"
        return self.out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each rank saw: its values (``.npz``) and its spans and counters (``.json``)."""
    out = _Launch(tmp_path_factory.mktemp("ddp_seg")).result()
    return ([dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)],
            [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)])


def _reference(confmat: torch.Tensor) -> dict:
    from portbench.reference import segmentation as ref

    return {"JaccardIndex": ref.jaccard(confmat), "Accuracy": ref.accuracy(confmat, "macro"),
            "ConfusionMatrix": confmat.numpy()}


def _confusion(rank: int, pass_: int, step: int) -> torch.Tensor:
    from portbench.reference import segmentation as ref

    logits, labels = _image(rank, pass_, step)
    return ref.confusion(logits, labels, logits.shape[1])


def _check(got: dict, prefix: str, want: dict) -> None:
    for name, value in want.items():
        have = got[f"{prefix}.{name}"]
        if name == "ConfusionMatrix":
            np.testing.assert_array_equal(have, value, err_msg=prefix)
        else:
            np.testing.assert_allclose(float(have), value, rtol=1e-6, atol=0, err_msg=f"{prefix}.{name}")


def test_each_step_value_is_the_four_ranks_batch(ranks):
    values, _ = ranks
    for p in range(PASSES):
        for s in range(STEPS):
            want = _reference(sum(_confusion(r, p, s) for r in range(WORLD)))
            for rank in range(WORLD):
                _check(values[rank], f"step.{p}.{s}", want)


def test_each_pass_value_is_the_union_of_the_ranks(ranks):
    values, _ = ranks
    for p in range(PASSES):
        want = _reference(sum(_confusion(r, p, s) for r in range(WORLD) for s in range(STEPS)))
        for rank in range(WORLD):
            _check(values[rank], f"pass.{p}", want)


def test_the_ranks_agree_bit_for_bit(ranks):
    values, _ = ranks
    for rank in range(1, WORLD):
        assert values[rank].keys() == values[0].keys()
        for key, value in values[0].items():
            assert values[rank][key].dtype == value.dtype and values[rank][key].tobytes() == value.tobytes(), key


def test_the_sync_spans_and_bytes_appear(ranks):
    _, seen = ranks
    for rank in range(WORLD):
        assert {"metric.sync", "sync.preflight", "sync.collective", "sync.reduce"} <= set(seen[rank]["spans"])
        assert seen[rank]["bytes_gathered"] > 0


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
