"""Two gloo ranks sync this slice's states like one process.

Each rank feeds its own shard to BLEU (the ``(n_gram,)`` vector sums), ROUGE
(the per-key sums and the count), BERTScore (the four int32 token ``cat``
states; the gathered rows are encoded once, at ``compute()``) and SDR
(``sum_sdr`` and ``total``), then computes: ``compute()`` syncs.  The one
process to match holds one metric per shard and merges the second into the
first (``merge_state``), the sums added in the order a two-rank all-reduce
adds them and the rows in rank order, so the values are compared bitwise.
This file runs itself as the ranks: ``python tests/test_torch_text_audio_ddp.py
RANK STORE OUT``.
"""

import json
import os
import subprocess
import sys
import time
import types
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
LAUNCH_LIMIT = 90.0
SHARDS = {0: (0, 2), 1: (1, 3)}
_WORDS = ("the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far", "away", "quick", "brown", "fox", "jumps")


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for size in (3, 2, 4, 1):
        preds = [" ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), size=rng.integers(3, 10))) for _ in range(size)]
        target = [" ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), size=rng.integers(3, 10))) for _ in range(size)]
        length = 256
        signal = rng.normal(size=(size, length)).astype(np.float32)
        noisy = (signal + 0.5 * rng.normal(size=(size, length))).astype(np.float32)
        out.append((preds, target, torch.from_numpy(noisy), torch.from_numpy(signal)))
    return out


class _Encoder(torch.nn.Module):
    """A seeded embedding table, Hugging Face style; counts the rows it encodes."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.table = torch.nn.Parameter(torch.randn(100, 8, generator=gen), requires_grad=False)
        self.rows = 0

    def forward(self, input_ids, attention_mask, output_hidden_states=False):
        self.rows += int(input_ids.shape[0])
        hidden = self.table[input_ids]
        return types.SimpleNamespace(last_hidden_state=hidden, hidden_states=(hidden,))


class _Tok:
    def __call__(self, texts, padding=None, max_length=12, truncation=True, return_attention_mask=True):
        ids = [[sum(map(ord, w)) % 99 + 1 for w in t.split()][:max_length] for t in texts]
        return {"input_ids": [i + [0] * (max_length - len(i)) for i in ids],
                "attention_mask": [[1] * len(i) + [0] * (max_length - len(i)) for i in ids]}


def _metrics(encoder):
    import metrics_tpu_torch as mt

    return {
        "bleu": mt.BLEUScore(device="cpu"),
        "rouge": mt.ROUGEScore(device="cpu"),
        "bert": mt.BERTScore(model=encoder, user_tokenizer=_Tok(), max_length=12, batch_size=2, device="cpu"),
        "sdr": mt.SignalDistortionRatio(filter_length=32, device="cpu"),
    }


def _feed(metrics, batch):
    preds, target, noisy, signal = batch
    for name, metric in metrics.items():
        if name == "sdr":
            metric.update(noisy, signal)
        else:
            metric.update(preds, target)


def _states(name, metric):
    keys = metric._defaults
    return {f"{name}/{key}": _hex(getattr(metric, key)) for key in keys}


def _hex(state):
    rows = torch.cat(state) if isinstance(state, list) else state
    return [str(rows.dtype), rows.numpy().tobytes().hex()]


def _digest(metrics, synced):
    """Every synced state and every value, as hex bytes (float32 lists for BERTScore's values)."""
    out = {}
    for name, metric in metrics.items():
        if synced:  # the gathered and reduced states, local again after the block
            with metric.sync_context():
                out.update(_states(name, metric))
        else:
            out.update(_states(name, metric))
        value = metric.compute()
        if name == "bert":
            out["bert/value"] = {k: np.asarray(v, np.float32).tobytes().hex() for k, v in value.items()}
        elif isinstance(value, dict):
            out[f"{name}/value"] = {k: v.numpy().tobytes().hex() for k, v in value.items()}
        else:
            out[f"{name}/value"] = value.numpy().tobytes().hex()
    return out


def _worker(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    encoder = _Encoder()
    metrics = _metrics(encoder)
    batches = _batches()
    for i in SHARDS[rank]:
        _feed(metrics, batches[i])
    encoded_before = encoder.rows
    digest = _digest(metrics, synced=True)
    (out / f"rank{rank}.json").write_text(json.dumps({"digest": digest, "compute_rows": encoder.rows - encoded_before}))
    dist.destroy_process_group()


def test_two_ranks_sync_bleu_rouge_bertscore_and_sdr_like_one_process(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    deadline = time.monotonic() + LAUNCH_LIMIT
    procs = [
        subprocess.Popen([sys.executable, __file__, str(rank), str(tmp_path / "store"), str(out)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)
    ]
    batches = _batches()
    encoder = _Encoder()
    shards = {rank: _metrics(encoder) for rank in range(WORLD)}
    for rank, metrics in shards.items():
        for i in SHARDS[rank]:
            _feed(metrics, batches[i])
    for name, metric in shards[0].items():
        metric.merge_state(shards[1][name].state_pytree())
    want = _digest(shards[0], synced=False)
    all_rows = 2 * sum(len(batches[i][0]) for shard in SHARDS.values() for i in shard)
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log}"
        seen = json.loads((out / f"rank{rank}.json").read_text())
        assert sorted(seen["digest"]) == sorted(want)
        for key in want:
            assert seen["digest"][key] == want[key], (rank, key)
        assert seen["compute_rows"] == all_rows, rank  # the gathered rows, both sides, encoded once


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
