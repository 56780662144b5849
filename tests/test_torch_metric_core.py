"""The port's ``Metric`` core on the CPU: the checks of the reference's ``MetricTester``.

Each metric streams the same seeded batches (four full ones and a ragged
one).  ``forward`` must return the functional on that batch and ``compute``
the functional on all the data, exactly: both come from the same int32
counts through the same code.
"""

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

NB, BS, C = 4, 32, 5


def _batches(seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    sizes = [BS] * NB + ([BS // 2 + 3] if ragged else [])
    out = []
    for size in sizes:
        scores = ((np.argsort(rng.random((size, C)), axis=1) + 0.5) / C).astype(np.float32)
        out.append((torch.from_numpy(scores), torch.from_numpy(rng.integers(0, C, size))))
    return out


def _cat(batches):
    return torch.cat([p for p, _ in batches]), torch.cat([t for _, t in batches])


METRICS = {
    "accuracy_micro": (
        lambda: mt.Accuracy(num_classes=C, device="cpu"),
        lambda p, t: tf.accuracy(p, t, num_classes=C),
    ),
    "accuracy_macro": (
        lambda: mt.Accuracy(num_classes=C, average="macro", device="cpu"),
        lambda p, t: tf.accuracy(p, t, num_classes=C, average="macro"),
    ),
    "f1_macro": (
        lambda: mt.F1Score(num_classes=C, average="macro", device="cpu"),
        lambda p, t: tf.f1_score(p, t, num_classes=C, average="macro"),
    ),
    "precision_weighted": (
        lambda: mt.Precision(num_classes=C, average="weighted", device="cpu"),
        lambda p, t: tf.precision(p, t, num_classes=C, average="weighted"),
    ),
    "recall_none": (
        lambda: mt.Recall(num_classes=C, average="none", device="cpu"),
        lambda p, t: tf.recall(p, t, num_classes=C, average="none"),
    ),
    "stat_scores_macro": (
        lambda: mt.StatScores(reduce="macro", num_classes=C, device="cpu"),
        lambda p, t: tf.stat_scores(p, t, reduce="macro", num_classes=C),
    ),
    "stat_scores_samples": (
        lambda: mt.StatScores(reduce="samples", num_classes=C, device="cpu"),
        lambda p, t: tf.stat_scores(p, t, reduce="samples", num_classes=C),
    ),
    "confusion_matrix": (
        lambda: mt.ConfusionMatrix(num_classes=C, device="cpu"),
        lambda p, t: tf.confusion_matrix(p, t, num_classes=C),
    ),
}


def _equal(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("full_state_update", [False, True])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_forward_batch_value_and_accumulated_value(name, full_state_update):
    make, fn = METRICS[name]
    metric = make()
    metric.full_state_update = full_state_update
    batches = _batches()
    for preds, target in batches:
        _equal(metric(preds, target), fn(preds, target))
    assert metric.update_count == len(batches)
    _equal(metric.compute(), fn(*_cat(batches)))
    for state in metric._defaults:
        value = getattr(metric, state)
        for v in value if isinstance(value, list) else [value]:
            assert v.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reset_restores_defaults(name):
    make, fn = METRICS[name]
    metric = make()
    batches = _batches(seed=1)
    for preds, target in batches:
        metric.update(preds, target)
    metric.reset()
    assert metric.update_count == 0
    for state, default in metric._defaults.items():
        value = getattr(metric, state)
        if isinstance(default, list):
            assert value == []
        else:
            _equal(value, default)
            assert value is not default
    for preds, target in batches[:2]:
        metric.update(preds, target)
    _equal(metric.compute(), fn(*_cat(batches[:2])))


@pytest.mark.parametrize("name", ["accuracy_macro", "stat_scores_samples", "confusion_matrix"])
def test_clone_is_independent(name):
    make, fn = METRICS[name]
    metric = make()
    batches = _batches(seed=2)
    metric.update(*batches[0])
    twin = metric.clone()
    for preds, target in batches[1:]:
        twin.update(preds, target)
    _equal(metric.compute(), fn(*batches[0]))
    _equal(twin.compute(), fn(*_cat(batches)))


@pytest.mark.parametrize("name", ["accuracy_micro", "f1_macro", "stat_scores_samples", "confusion_matrix"])
def test_state_dict_round_trip(name):
    make, fn = METRICS[name]
    metric = make()
    batches = _batches(seed=3)
    for preds, target in batches[:3]:
        metric.update(preds, target)
    assert metric.state_dict() == {}  # states are not persistent by default
    metric.persistent(True)
    saved = metric.state_dict()
    assert set(saved) == set(metric._defaults)
    restored = make()
    restored.load_state_dict(saved)
    restored._ckpt_load_extra_state(metric._ckpt_extra_state())
    for preds, target in batches[3:]:
        restored.update(preds, target)
        metric.update(preds, target)
    _equal(restored.compute(), metric.compute())
    _equal(restored.compute(), fn(*_cat(batches)))


@pytest.mark.parametrize("name", ["accuracy_macro", "recall_none", "stat_scores_samples", "confusion_matrix"])
def test_pickle_mid_stream_then_continue(name):
    make, fn = METRICS[name]
    metric = make()
    batches = _batches(seed=4)
    for preds, target in batches[:2]:
        metric.update(preds, target)
    copy = pickle.loads(pickle.dumps(metric))
    for preds, target in batches[2:]:
        copy.update(preds, target)
    _equal(copy.compute(), fn(*_cat(batches)))
    _equal(metric.compute(), fn(*_cat(batches[:2])))


def test_forward_leaves_earlier_results_and_defaults_unchanged():
    metric = mt.Accuracy(num_classes=C, average="macro", device="cpu")
    collection = mt.MetricCollection(
        {
            "f1": mt.F1Score(num_classes=C, average="macro", device="cpu"),
            "prec": mt.Precision(num_classes=C, average="macro", device="cpu"),
        },
        device="cpu",
    )
    defaults = {k: v.clone() for k, v in metric._defaults.items()}
    batches = _batches(seed=5)
    batch_value = metric(*batches[0])
    collection.update(*batches[0])
    first = metric.compute()
    first_states = {k: getattr(metric, k) for k in metric._defaults}
    snapshots = [batch_value.clone(), first.clone()] + [v.clone() for v in first_states.values()]
    group_first = collection.compute()
    group_snapshots = {k: v.clone() for k, v in group_first.items()}
    for preds, target in batches[1:]:
        metric(preds, target)
        collection.update(preds, target)
    for value, snapshot in zip([batch_value, first, *first_states.values()], snapshots):
        _equal(value, snapshot)
    for key, snapshot in group_snapshots.items():
        _equal(group_first[key], snapshot)
    for key, default in metric._defaults.items():
        _equal(default, defaults[key])
        assert not default.any()


def test_update_batched_equals_update_loop():
    batches = _batches(seed=6, ragged=False)
    stacked_preds = torch.stack([p for p, _ in batches])
    stacked_target = torch.stack([t for _, t in batches])
    looped = mt.F1Score(num_classes=C, average="macro", device="cpu")
    for preds, target in batches:
        looped.update(preds, target)
    fused = mt.F1Score(num_classes=C, average="macro", device="cpu")
    fused.update_batched(stacked_preds, stacked_target)
    assert fused.update_count == looped.update_count == NB
    _equal(fused.compute(), looped.compute())
    with pytest.raises(MetricsTPUUserError):
        fused.update_batched(stacked_preds, stacked_target[:2])


def test_state_pytree_round_trip_keeps_count_and_dtypes():
    make, fn = METRICS["stat_scores_samples"]
    metric = make()
    batches = _batches(seed=7)
    for preds, target in batches:
        metric.update(preds, target)
    tree = metric.state_pytree()
    assert tree["_update_count"] == len(batches)
    restored = make()
    restored.load_state_pytree(tree)
    restored._ckpt_load_extra_state(metric._ckpt_extra_state())
    assert restored.update_count == len(batches)
    _equal(restored.compute(), fn(*_cat(batches)))


def test_inputs_on_another_device_raise():
    metric = mt.Accuracy(num_classes=C, device="cpu")
    preds = torch.zeros((4, C), device="meta")
    target = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="keeps its state on cpu"):
        metric.update(preds, target)
    assert metric.update_count == 0


def test_mode_switch_raises():
    metric = mt.Accuracy(num_classes=C, device="cpu")
    preds, target = _batches(seed=8)[0]
    metric.update(preds, target)
    with pytest.raises(ValueError, match="You can not use"):
        metric.update((preds > 0.5).int(), target.reshape(-1, 1).repeat(1, C).clamp(max=1))


def test_update_while_synced_raises():
    metric = mt.Accuracy(num_classes=C, device="cpu")
    metric.update(*_batches(seed=9)[0])
    metric.sync()
    with pytest.raises(MetricsTPUUserError):
        metric.update(*_batches(seed=9)[1])
    metric.unsync()
    metric.update(*_batches(seed=9)[1])
    assert metric.update_count == 2


def test_sync_raises_once_a_process_group_exists(tmp_path):
    """Before sync was ported a process group made ``compute()`` raise; now it syncs over
    the group.  A world of one holds all the data, so the value is the local one."""
    from metrics_tpu_torch.parallel import DistBackend

    metric = mt.Accuracy(num_classes=C, device="cpu")
    local_only = mt.Accuracy(num_classes=C, device="cpu", sync_on_compute=False)
    batches = _batches(seed=10)
    for preds, target in batches:
        metric.update(preds, target)
        local_only.update(preds, target)
    expected = metric.compute()  # no process group: nothing to gather
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        metric._computed = None
        _equal(metric.compute(), expected)
        assert metric.last_sync_report is None  # a world of one has no peer to gather from
        explicit = mt.Accuracy(num_classes=C, device="cpu", sync_backend=DistBackend())
        for preds, target in batches:
            explicit.update(preds, target)
        explicit.sync(distributed_available=True)  # a world of one, through the real transport
        report = explicit.last_sync_report
        assert (report["backend"], report["world_size"], report["gather_calls"]) == ("DistBackend", 1, 2)
        explicit.unsync()
        _equal(explicit.compute(), expected)
        _equal(local_only.compute(), expected)
    finally:
        dist.destroy_process_group()
