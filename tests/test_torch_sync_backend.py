"""``DistBackend`` in one process: a gloo world of one, on the CPU.

The wire carries every payload as raw bytes and rebuilds dtype and shape on
arrival; reductions fold the gathered stack in rank order and keep the
state's dtype; a group that an abandoned collective left out of step
refuses every later collective.  The NCCL transport cannot run here (no
card, and NCCL refuses two ranks on one card): its choice of a CUDA wire is
checked by shape only.
"""

import pytest
import torch
import torch.distributed as dist

from metrics_tpu_torch.parallel import backend as bk
from metrics_tpu_torch.utils.exceptions import SyncError


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield bk.DistBackend()
    finally:
        bk._BROKEN_GROUPS.clear()
        dist.destroy_process_group()


PAYLOADS = {
    "int32-2d": torch.arange(12, dtype=torch.int32).reshape(3, 4),
    "int64-0d": torch.tensor(-7, dtype=torch.int64),
    "bool": torch.tensor([True, False, True]),
    "bfloat16": torch.tensor([1.5, -2.25, 0.0], dtype=torch.bfloat16),
    "float32-empty": torch.zeros((0, 5)),
}


@pytest.mark.parametrize("name", PAYLOADS)
def test_gather_rebuilds_dtype_and_shape(world_of_one, name):
    x = PAYLOADS[name]
    out = world_of_one.all_gather_stack(x)
    assert out.dtype == x.dtype and out.shape == (1,) + tuple(x.shape)
    assert torch.equal(out[0], x)
    tel = world_of_one.pop_telemetry()
    assert (tel["gather_calls"], tel["bytes_gathered"]) == (1, x.numel() * x.element_size())


def test_cat_and_bytes_gathers_are_framed_by_sizes(world_of_one):
    rows = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    assert torch.equal(world_of_one.all_gather_cat(rows), rows)
    assert world_of_one.all_gather_bytes(b"\x00blob\xff") == [b"\x00blob\xff"]
    assert world_of_one.all_gather_bytes(b"") == [b""]
    tel = world_of_one.pop_telemetry()
    assert tel["gather_calls"] == 6  # a sizes gather before every payload gather
    assert tel["bytes_gathered"] == (4 + 40) + (4 + 6) + (4 + 0)


def test_preflight_is_accounted_apart_and_world_of_one_skips_it(world_of_one):
    assert not world_of_one.is_distributed()
    assert world_of_one.preflight_check([("tp", "sum:(3,):int32")], 2) is None
    info = world_of_one._preflight_exchange([("tp", "sum:(3,):int32")], 2, (1, 5, 6), 0)
    assert info == {"peer_update_counts": [2], "delta_ok": True}


def test_reductions_fold_in_rank_order_and_keep_the_dtype():
    ints = torch.tensor([[2**30, 5], [2**30, -1], [3, 4]], dtype=torch.int32)
    total = bk.reduce_stack(ints, "sum")
    assert total.dtype == torch.int32 and total.tolist() == [(2**31 + 3) - 2**32, 8]  # int32 wraps, no widening
    floats = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    # a left fold, rank 0 first: (1e8 + 1) rounds to 1e8 in float32, so the sum is 0 (any
    # order that met -1e8 first would give 1)
    assert bk.reduce_stack(floats, "sum").item() == 0.0
    assert bk.reduce_stack(floats, "mean").item() == pytest.approx(0.0)
    assert bk.reduce_stack(ints, "mean").dtype == torch.float32
    assert bk.reduce_stack(ints, "max").tolist() == [2**30, 5]
    assert bk.reduce_stack(ints, "min").tolist() == [3, -1]
    nan = torch.tensor([[1.0], [float("nan")]])
    assert torch.isnan(bk.reduce_stack(nan, "max")).all()


def test_a_group_out_of_step_refuses_at_once(world_of_one):
    bk._BROKEN_GROUPS[world_of_one._group_key()] = "collective 'x' timed out"
    with pytest.raises(SyncError, match="out of step"):
        world_of_one.all_gather_stack(torch.ones(2))


def test_timeout_marks_the_group_out_of_step(world_of_one, monkeypatch):
    import threading

    release = threading.Event()
    monkeypatch.setattr(world_of_one, "_allgather", lambda x, wire: release.wait(5) and x[None])
    world_of_one.options = bk.SyncOptions(timeout=0.05, max_retries=3)
    with pytest.raises(bk.SyncTimeoutError) as err:
        world_of_one.all_gather_stack(torch.ones(2))
    release.set()
    assert (err.value.attempts, err.value.timeout) == (1, 0.05)  # never retried over torch.distributed
    assert world_of_one._group_key() in bk._BROKEN_GROUPS


def test_nccl_groups_put_the_wire_on_the_card(world_of_one, monkeypatch):
    assert world_of_one._wire_device() == torch.device("cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert world_of_one._wire_device() == torch.device("cuda", 0)


def test_get_backend_needs_more_than_one_rank(world_of_one):
    assert isinstance(bk.get_backend(), bk.NullBackend)
    assert isinstance(bk.get_backend(options=bk.SyncOptions(timeout=1.0)), bk.NullBackend)


def test_the_wire_device_is_taken_on_the_calling_thread(world_of_one, monkeypatch):
    """With a timeout the collective runs on a watchdog thread, whose current CUDA device is the runtime's
    default and not the rank's: the wire device is chosen before, on the caller's thread."""
    import threading

    seen = {}
    wire_device, allgather = world_of_one._wire_device, world_of_one._allgather

    def wire():
        seen["wire"] = threading.current_thread()
        return wire_device()

    def gather(x, wire):
        seen["gather"] = threading.current_thread()
        return allgather(x, wire)

    monkeypatch.setattr(world_of_one, "_wire_device", wire)
    monkeypatch.setattr(world_of_one, "_allgather", gather)
    world_of_one.options = bk.SyncOptions(timeout=30.0)
    x = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    out = world_of_one.all_gather_stack(x)
    assert out.dtype == x.dtype and torch.equal(out[0], x)
    assert seen["wire"] is threading.current_thread()
    assert seen["gather"] is not threading.current_thread()  # the watchdog's thread ran the collective


def test_a_collective_that_blocks_at_its_copy_back_times_out(world_of_one, monkeypatch):
    """Under NCCL ``all_gather`` only queues the collective: the host waits for it at the copy back to the
    payload's device.  That copy runs under the deadline too, so a stalled peer raises instead of blocking
    the caller, and the group is marked out of step."""
    import threading
    import time

    release = threading.Event()

    class Queued(torch.Tensor):  # a gathered row whose bytes land only once ``release`` is set
        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            if func is torch.Tensor.to:
                release.wait(5)
            return super().__torch_function__(func, types, args, kwargs or {})

    all_gather = dist.all_gather

    def queue_only(parts, raw, group=None):
        all_gather(parts, raw, group=group)
        parts[:] = [p.as_subclass(Queued) for p in parts]

    monkeypatch.setattr(dist, "all_gather", queue_only)
    world_of_one.options = bk.SyncOptions(timeout=0.05)
    start = time.monotonic()
    try:
        with pytest.raises(bk.SyncTimeoutError):
            world_of_one.all_gather_stack(torch.ones(2))
        assert time.monotonic() - start < 2.5
    finally:
        release.set()
    assert world_of_one._group_key() in bk._BROKEN_GROUPS
