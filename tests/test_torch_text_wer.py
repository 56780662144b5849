"""The port's WER family (WER, CER, MER, WIL, WIP) and the core's host-side sums against the JAX package.

The inputs are seeded word strings: references drawn from a small vocabulary,
hypotheses with substitutions, insertions and deletions.  Every value and
state is compared bitwise (``tobytes``): the statistics are integer counts
held as float32, and both packages fold a float64 host sum into each state
once, cast to float32 first.

The surfaces that must see pending host sums are each pinned here: a direct
state read, ``state``, ``compute``, ``forward``, ``merge_state``,
``state_dict``, a sync, pickling and ``reset`` (which drops them), the pure
state API (``apply_update`` adds at once into the swapped-in state and never
absorbs the instance's sums), a compute group in a ``MetricCollection``, and
two gloo ranks (this file run as a script: ``python
tests/test_torch_text_wer.py RANK STORE OUT``).
"""

import json
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
LAUNCH_LIMIT = 60.0
NAMES = {
    "WordErrorRate": ("word_error_rate", ("errors", "total")),
    "CharErrorRate": ("char_error_rate", ("errors", "total")),
    "MatchErrorRate": ("match_error_rate", ("errors", "total")),
    "WordInfoLost": ("word_information_lost", ("errors", "target_total", "preds_total")),
    "WordInfoPreserved": ("word_information_preserved", ("errors", "target_total", "preds_total")),
}


def _corpus(seed: int, n: int):
    """``n`` (hypothesis, reference) pairs: references of 3-14 words; each word of a hypothesis
    substituted, dropped or followed by an inserted word with probability 0.1 each."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, size=rng.integers(1, 9))) for _ in range(300)]
    preds, target = [], []
    for _ in range(n):
        ref = [vocab[i] for i in rng.integers(0, len(vocab), size=rng.integers(3, 15))]
        hyp = []
        for word in ref:
            u = rng.random()
            if u < 0.1:
                hyp.append(vocab[rng.integers(0, len(vocab))])
            elif u < 0.2:
                continue
            else:
                hyp.append(word)
            if rng.random() < 0.1:
                hyp.append(vocab[rng.integers(0, len(vocab))])
        preds.append(" ".join(hyp))
        target.append(" ".join(ref))
    return preds, target


def _batches(seed: int = 0, sizes=(7, 1, 12, 5)):
    preds, target = _corpus(seed, sum(sizes))
    out, at = [], 0
    for size in sizes:
        out.append((preds[at : at + size], target[at : at + size]))
        at += size
    return out


def _bits(x) -> bytes:
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float32).tobytes()


def _pair(name: str):
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    return getattr(jm, name)(), getattr(mt, name)(device="cpu")


def _jax_states(metric) -> dict:
    return {k: np.asarray(v) for k, v in metric.state.items()}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_functionals_equal_the_jax_package_bitwise(name):
    import metrics_tpu.functional as jf
    import metrics_tpu_torch.functional as tf

    fn = NAMES[name][0]
    for preds, target in _batches(1) + [("a lone hypothesis here", "a lone reference there")]:
        got = getattr(tf, fn)(preds, target)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert _bits(got) == _bits(getattr(jf, fn)(preds, target)), (fn, preds)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_modules_update_forward_and_compute_bitwise(name):
    ref, port = _pair(name)
    ref_fwd, port_fwd = _pair(name)
    for preds, target in _batches(2):
        ref.update(preds, target)
        port.update(preds, target)
        assert _bits(port_fwd(preds, target)) == _bits(ref_fwd(preds, target))
    assert _bits(port.compute()) == _bits(ref.compute())
    assert _bits(port_fwd.compute()) == _bits(ref_fwd.compute())
    want = _jax_states(ref)
    for key in NAMES[name][1]:
        got = getattr(port, key)
        assert got.dtype == torch.float32 and got.shape == ()
        assert _bits(got) == want[key].tobytes(), key


def test_an_update_holds_its_sums_on_the_host_until_a_direct_read():
    ref, port = _pair("WordInfoLost")
    (p0, t0), (p1, t1) = _batches(3)[:2]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port.update(p0, t0)
        port.update(p1, t1)
    assert [e.name for e in prof.events() if e.name.startswith("aten::")] == []  # no tensor operation
    assert port._host_buffers_dirty and "errors" not in port.__dict__
    ref.update(p0, t0)
    ref.update(p1, t1)
    got = port.errors  # a plain attribute read flushes the pending sums first
    assert not port._host_buffers_dirty and not port._host_scalar_acc
    assert _bits(got) == _bits(ref.errors)
    for key in ("target_total", "preds_total"):
        assert _bits(port.__dict__[key]) == _bits(getattr(ref, key))


@pytest.mark.parametrize(
    "surface",
    ["state", "compute", "forward", "merge_state", "state_dict", "state_pytree", "sync", "pickle", "clone"],
)
def test_every_read_surface_sees_the_pending_sums(surface):
    import metrics_tpu_torch as mt

    ref, port = _pair("WordErrorRate")
    batches = _batches(4)
    for preds, target in batches[:2]:
        ref.update(preds, target)
        port.update(preds, target)
    want = _jax_states(ref)
    if surface == "state":
        seen = port.state
    elif surface == "compute":
        assert _bits(port.compute()) == _bits(ref.compute())
        seen = port.__dict__
    elif surface == "forward":
        port(*batches[2])
        ref(*batches[2])
        want = _jax_states(ref)
        seen = port.__dict__
    elif surface == "merge_state":
        other_ref, other = _pair("WordErrorRate")
        other_ref.update(*batches[3])
        other.update(*batches[3])
        port.merge_state(other.state_pytree())
        ref.merge_state(other_ref.state_pytree())
        want = _jax_states(ref)
        seen = port.__dict__
    elif surface == "state_dict":
        port.persistent(True)
        seen = port.state_dict()
    elif surface == "state_pytree":
        seen = port.state_pytree()
    elif surface == "sync":
        port.sync(backend=mt.parallel.LoopbackBackend())
        seen = port.__dict__
        port.unsync()
    elif surface == "pickle":
        seen = pickle.loads(pickle.dumps(port)).__dict__
    else:
        seen = port.clone().__dict__
    for key in ("errors", "total"):
        assert _bits(seen[key]) == want[key].tobytes(), (surface, key)
    # the clone or the original goes on from there as the JAX metric does
    port.update(*batches[3])
    ref.update(*batches[3])
    assert _bits(port.compute()) == _bits(ref.compute())


def test_reset_drops_the_pending_sums():
    ref, port = _pair("CharErrorRate")
    preds, target = _batches(5)[0]
    port.update(preds, target)
    ref.update(preds, target)
    port.reset()
    ref.reset()
    assert not port._host_buffers_dirty and float(port.errors) == 0.0 == float(ref.errors)
    port.update(preds, target)
    ref.update(preds, target)
    assert _bits(port.compute()) == _bits(ref.compute())


def test_apply_update_adds_into_the_swapped_state_and_leaves_the_instance_pending():
    ref, port = _pair("MatchErrorRate")
    (p0, t0), (p1, t1), (p2, t2) = _batches(6)[:3]
    ref.update(p0, t0)
    port.update(p0, t0)  # pending on the instance
    ref_state = ref.apply_update(ref.init_state(), p1, t1)
    port_state = port.apply_update(port.init_state(), p1, t1)
    ref_state = ref.apply_update(ref_state, p2, t2)
    port_state = port.apply_update(port_state, p2, t2)
    assert port._host_buffers_dirty and "errors" not in port.__dict__  # the instance's sums still wait
    for key in ("errors", "total"):
        assert _bits(port_state[key]) == _bits(ref_state[key]), key
    assert _bits(port.apply_compute(port_state)) == _bits(ref.apply_compute(ref_state))
    for key, value in _jax_states(ref).items():  # the instance holds its own batch alone
        assert _bits(getattr(port, key)) == value.tobytes(), key


def test_a_collection_shares_pending_sums_through_its_compute_groups():
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    ref = jm.MetricCollection({n: getattr(jm, n)() for n in sorted(NAMES)})
    port = mt.MetricCollection({n: getattr(mt, n)(device="cpu") for n in sorted(NAMES)}, device="cpu")
    batches = _batches(7)
    ref.update(*batches[0])
    port.update(*batches[0])
    assert port.compute_groups == ref.compute_groups
    assert any(len(g) > 1 for g in port.compute_groups.values())  # WIL and WIP share their states
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for preds, target in batches[1:]:
            port.update(preds, target)
    assert [e.name for e in prof.events() if e.name.startswith("aten::")] == []
    for preds, target in batches[1:]:
        ref.update(preds, target)
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for key in want:
        assert _bits(got[key]) == _bits(want[key]), key
    for name in NAMES:
        for key, value in _jax_states(ref[name]).items():
            assert _bits(getattr(port[name], key)) == value.tobytes(), (name, key)


def test_load_jax_state_continues_bitwise():
    from metrics_tpu_torch import load_jax_state

    ref, port = _pair("WordInfoPreserved")
    batches = _batches(8)
    ref.update(*batches[0])
    ref.update(*batches[1])
    load_jax_state(port, ref.state_pytree())
    for preds, target in batches[2:]:
        ref.update(preds, target)
        port.update(preds, target)
    assert port.update_count == ref.update_count
    assert _bits(port.compute()) == _bits(ref.compute())


def test_construction_without_device_raises_when_cuda_is_absent(monkeypatch):
    import metrics_tpu_torch as mt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in NAMES:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(mt, name)()


# ------------------------------------------------------------------ two ranks
SHARDS = {0: (0, 2), 1: (1, 3)}


def _worker(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    import metrics_tpu_torch as mt

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    metrics = {n: getattr(mt, n)(device="cpu") for n in sorted(NAMES)}
    batches = _batches(9)
    for i in SHARDS[rank]:
        for metric in metrics.values():
            metric.update(*batches[i])
    pending = all(m._host_buffers_dirty for m in metrics.values())
    seen = {n: _bits(m.compute()).hex() for n, m in metrics.items()}
    local = {n: _bits(m.errors).hex() for n, m in metrics.items()}  # unsynced after compute
    (out / f"rank{rank}.json").write_text(json.dumps({"values": seen, "local": local, "pending": pending}))
    dist.destroy_process_group()


def test_two_ranks_sync_the_host_sums_like_one_process(tmp_path):
    import metrics_tpu as jm

    out = tmp_path / "out"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    deadline = time.monotonic() + LAUNCH_LIMIT
    procs = [
        subprocess.Popen([sys.executable, __file__, str(rank), str(tmp_path / "store"), str(out)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)
    ]
    batches = _batches(9)
    want, local = {}, {}
    for name in NAMES:  # one JAX process over all batches, and each rank's own share
        metric = getattr(jm, name)()
        for preds, target in batches:
            metric.update(preds, target)
        want[name] = _bits(metric.compute()).hex()
        for rank, shard in SHARDS.items():
            part = getattr(jm, name)()
            for i in shard:
                part.update(*batches[i])
            local[(name, rank)] = _bits(part.errors).hex()
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log}"
        seen = json.loads((out / f"rank{rank}.json").read_text())
        assert seen["pending"]
        assert seen["values"] == want, rank
        assert seen["local"] == {name: local[(name, rank)] for name in sorted(NAMES)}, rank


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
