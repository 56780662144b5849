"""Checkpoint codec: metric state <-> integrity-checked packed blobs
(counterpart of ``metrics_tpu/checkpoint/codec.py``, byte for byte).

Every state kind serializes through the same byte codec the packed sync
transport uses (:func:`metrics_tpu_torch.metric._pack_state_blob`, the JAX
package's format): a self-describing container of named arrays that
round-trips bf16 and 0-d shapes.  The checkpoint layer nests it twice:

* per *logical state* (tensor / list / buffer / sketch): the state's flat
  ``state_pytree`` keys packed into one blob, digested with blake2b: the
  unit of corruption detection and of the ``skip_state`` restore policy;
* per *metric*: the state blobs packed into one outer blob (each inner blob
  is a uint8 array to the container): the unit a rank shard file holds for
  every metric in the checkpoint target.

A sketch's PRNG key is a ``torch.uint32`` ``(2,)`` tensor and packs as the
``uint32`` array the JAX package writes (only pickling turns it into int32
words), so every inner blob and digest equals the JAX package's for the same
state, and a shard either package wrote verifies and restores in the other.

``_DeltaCache`` contents are not serialized: gathered prefixes describe a
fleet agreement that dies with the incarnation that negotiated it.
``load_state_pytree``/``merge_state`` clear the cache on restore.
"""

import hashlib
import json
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric, _pack_state_blob, _unpack_state_blob

FORMAT_VERSION = 1
DIGEST_BYTES = 16

# The metric-level bookkeeping that is not a registered state rides in a
# reserved pseudo-state (state names are identifiers the registration APIs
# accept, never this one).
META_STATE = "__meta__"
META_UPDATE_COUNT = "_update_count"

# Which Metric state-registration API produces which codec kind(s): every
# ``add*_state`` method on Metric appears here, and every kind named here has
# a serializer.
STATE_KIND_REGISTRARS: Dict[str, Tuple[str, ...]] = {
    "add_state": ("tensor", "list"),
    "add_buffer_state": ("buffer",),
    "add_sketch_state": ("sketch",),
}

Arrays = Dict[str, torch.Tensor]


class _KindSerializer(NamedTuple):
    """How one state kind maps to and from checkpoint arrays.

    ``to_arrays(metric, tree, name)`` pulls the state's arrays out of a
    ``state_pytree`` snapshot; ``to_pytree(metric, name, arrays, out)``
    writes restored arrays into a tree ``load_state_pytree`` accepts;
    ``to_merge(metric, name, arrays, out)`` writes them into a state dict
    ``merge_state`` accepts (list states re-wrapped as lists).
    """

    to_arrays: Callable[[Metric, Dict[str, Any], str], Arrays]
    to_pytree: Callable[[Metric, str, Arrays, Dict[str, Any]], None]
    to_merge: Callable[[Metric, str, Arrays, Dict[str, Any]], None]


def _plain_to_arrays(metric: Metric, tree: Dict[str, Any], name: str) -> Arrays:
    out: Arrays = {}
    for key in metric.state_keys(name):
        value = tree.get(key)
        if isinstance(value, list):
            continue  # empty list state: zero rows, nothing to pack
        out[key] = torch.as_tensor(value).detach().cpu()
    return out


def _plain_to_pytree(metric: Metric, name: str, arrays: Arrays, out: Dict[str, Any]) -> None:
    # load_state_pytree wraps a bare tensor back into [tensor] for list states
    out.update(arrays)


def _tensor_to_merge(metric: Metric, name: str, arrays: Arrays, out: Dict[str, Any]) -> None:
    out.update(arrays)


def _list_to_merge(metric: Metric, name: str, arrays: Arrays, out: Dict[str, Any]) -> None:
    # merge_state extends list states entry by entry; a checkpointed list
    # state is one pre-concatenated entry
    out[name] = [arrays[name]] if name in arrays else []


def _buffer_to_merge(metric: Metric, name: str, arrays: Arrays, out: Dict[str, Any]) -> None:
    bkey, lkey = name + "__buf", name + "__len"
    if bkey in arrays:
        out[bkey] = arrays[bkey]
        out[lkey] = int(arrays[lkey])
    else:  # the state was skipped: contribute the empty placeholder
        out[bkey] = torch.zeros((0,), dtype=torch.float32)
        out[lkey] = 0


def _meta_to_arrays(metric: Metric, tree: Dict[str, Any], name: str) -> Arrays:
    out = {META_UPDATE_COUNT: torch.tensor(int(tree.get(META_UPDATE_COUNT, 0)), dtype=torch.int64)}
    extra = metric._ckpt_extra_state()
    if extra:
        raw = np.frombuffer(json.dumps(extra, sort_keys=True).encode(), np.uint8)
        out["extra"] = torch.from_numpy(raw.copy())
    return out


def _meta_to_pytree(metric: Metric, name: str, arrays: Arrays, out: Dict[str, Any]) -> None:
    out[META_UPDATE_COUNT] = int(arrays[META_UPDATE_COUNT]) if META_UPDATE_COUNT in arrays else 0
    extra = arrays.get("extra")
    if extra is not None:
        # runtime-determined attributes (e.g. the classification `mode`) go
        # straight onto the metric: load_state_pytree only moves tensors
        metric._ckpt_load_extra_state(json.loads(extra.numpy().tobytes().decode()))


def _meta_to_merge(metric: Metric, name: str, arrays: Arrays, out: Dict[str, Any]) -> None:
    pass  # update counts merge through merge_state's other_count argument


SERIALIZERS: Dict[str, _KindSerializer] = {
    "tensor": _KindSerializer(_plain_to_arrays, _plain_to_pytree, _tensor_to_merge),
    "list": _KindSerializer(_plain_to_arrays, _plain_to_pytree, _list_to_merge),
    "buffer": _KindSerializer(_plain_to_arrays, _plain_to_pytree, _buffer_to_merge),
    "sketch": _KindSerializer(_plain_to_arrays, _plain_to_pytree, _tensor_to_merge),
    META_STATE: _KindSerializer(_meta_to_arrays, _meta_to_pytree, _meta_to_merge),
}


def state_digest(blob: bytes) -> str:
    return hashlib.blake2b(blob, digest_size=DIGEST_BYTES).hexdigest()


def _as_bytes_tensor(blob: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(blob, np.uint8).copy())


class EncodedMetric(NamedTuple):
    blob: bytes  # outer container: {state_name: inner blob as uint8}
    digests: Dict[str, str]  # state_name -> blake2b of the inner blob
    kinds: Dict[str, str]  # state_name -> codec kind
    update_count: int
    sync_round: int


def encode_metric(metric: Metric) -> EncodedMetric:
    """Snapshot one metric into an integrity-checked packed blob."""
    tree = metric.state_pytree()  # buffers trimmed to their rows, list states concatenated
    kinds = dict(metric.state_kinds())
    kinds[META_STATE] = META_STATE
    state_blobs = {sname: _pack_state_blob(SERIALIZERS[kind].to_arrays(metric, tree, sname)) for sname, kind in kinds.items()}
    digests = {sname: state_digest(b) for sname, b in state_blobs.items()}
    blob = _pack_state_blob({sname: _as_bytes_tensor(b) for sname, b in state_blobs.items()})
    return EncodedMetric(
        blob=blob,
        digests=digests,
        kinds=kinds,
        update_count=int(metric._update_count),
        sync_round=int(metric._delta_cache.round),
    )


class DecodedState(NamedTuple):
    arrays: Dict[str, Arrays]  # state_name -> flat CPU tensors
    failed: List[str]  # state names whose digest did not match


def decode_metric(blob: bytes, expected_digests: Dict[str, str]) -> DecodedState:
    """Unpack one metric blob, verifying each state against the manifest.

    A state whose recomputed digest differs from the manifest's, or whose
    inner blob fails to parse, lands in ``failed`` instead of ``arrays``; the
    caller applies the ``on_restore_error`` policy.  States in the manifest
    but absent from the blob fail too (a torn container).
    """
    arrays: Dict[str, Arrays] = {}
    failed: List[str] = []
    try:
        outer = _unpack_state_blob(blob)
    except Exception:
        return DecodedState(arrays={}, failed=sorted(expected_digests))
    for sname, expect in expected_digests.items():
        packed = outer.get(sname)
        if packed is None:
            failed.append(sname)
            continue
        raw = packed.numpy().tobytes()
        if state_digest(raw) != expect:
            failed.append(sname)
            continue
        try:
            arrays[sname] = _unpack_state_blob(raw)
        except Exception:
            failed.append(sname)
    return DecodedState(arrays=arrays, failed=failed)


def arrays_to_pytree(metric: Metric, states: Dict[str, Arrays]) -> Dict[str, Any]:
    """Assemble decoded per-state arrays into a ``load_state_pytree`` tree."""
    kinds = dict(metric.state_kinds())
    kinds[META_STATE] = META_STATE
    tree: Dict[str, Any] = {}
    for sname, arrays in states.items():
        kind = kinds.get(sname)
        if kind is None:
            continue  # the state is no longer registered on this metric class
        SERIALIZERS[kind].to_pytree(metric, sname, arrays, tree)
    return tree


def arrays_to_merge_state(metric: Metric, states: Dict[str, Arrays]) -> Dict[str, Any]:
    """Assemble decoded per-state arrays into a ``merge_state`` tree.

    States missing from ``states`` (failed digests under ``skip_state``, or a
    schema that grew since the checkpoint) contribute their defaults, so the
    multi-way merge still sees every key it iterates.
    """
    out: Dict[str, Any] = {}
    for sname, kind in metric.state_kinds().items():
        arrays = states.get(sname)
        if arrays is None:
            if kind in ("tensor", "sketch"):
                # the identity of the state's reduce: its registered default
                for key in metric.state_keys(sname):
                    out[key] = metric._defaults[key].clone()
                continue
            arrays = {}
        SERIALIZERS[kind].to_merge(metric, sname, arrays, out)
    return out
