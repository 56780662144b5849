"""Metric state placed on a device mesh, synced by the mesh's own collectives
(counterpart of ``metrics_tpu/parallel/mesh.py``).

The JAX package holds one global array across devices from one controller.
PyTorch runs one process per rank, and each rank feeds its own rows.  A
placed metric (:meth:`Metric.shard`) records its
:class:`~torch.distributed.device_mesh.DeviceMesh` and axis, keeps updating
and computing on each rank's plain tensors, and syncs through
:class:`MeshBackend`.  Its ``state`` shows each leaf as the
:class:`torch.distributed.tensor.DTensor` the placement describes:

* ``Partial(op)``: a reduced state (``sum``/``mean``/``max``/``min`` as
  ``sum``/``avg``/``max``/``min``) between syncs.  An update adds this rank's
  rows locally, with no collective; a sync reduces over the mesh axis.
* a synced value, whole on every rank, laid out by :func:`leaf_sharding` of
  its spec: ``Shard(0)`` rows where they split evenly over the axis, else
  ``Replicate()``.

Rows between syncs (``cat`` tensors, buffer rows), sketch leaves, states
reduced by a custom callable, list states and buffer row counts stay plain
local tensors (lists and ints).  A rank's rows are its own, in counts no
``Shard(0)`` layout describes: DTensor assumes ``torch.chunk``'s split, and
its own collectives on an uneven layout break a gloo group.  DTensor has no
placement for a partial that a merge function folds either.

:class:`MeshBackend` is the third real backend beside :class:`DistBackend`
(eager, host-framed gathers) and :class:`LoopbackBackend`.  Its collectives
run over the mesh axis's group through ``torch.distributed``'s functional
collectives (:class:`AxisBackend`): no preflight, no packed blob, no delta,
no watchdog; the reduced states of one reduce, dtype and device go in one
collective (``combine_reductions``), every other state in its own (rows: a
descriptor and a rows gather).
Each reduced state, row gather and sketch merge counts one
``in_xla_reductions`` tick (the JAX name: here, a reduction the mesh backend
made inside the rank's program), and a sync report carries that count and no
wire bytes.  Under gloo the bytes pass through host memory (``host_bytes``
in the report); under NCCL they stay on the card.

Every rank of the mesh axis must reach the same syncs, placements, restores
and whole-value reads (``state_dict``, ``state_pytree``) in the same order,
as in any SPMD program.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.parallel.backend import AxisBackend, SyncOptions, _dtensor_type

__all__ = [
    "MeshBackend",
    "PartitionSpec",
    "default_mesh",
    "leaf_sharding",
    "replicated",
    "row_sharded",
]


class PartitionSpec(tuple):
    """Where a state's dimensions live on the mesh: one entry per leading
    dimension, ``None`` (replicated over every mesh axis), a mesh axis name
    (that dimension split over the axis) or a tuple of names.  The JAX
    package's ``jax.sharding.PartitionSpec`` semantics, as a plain tuple.
    """

    def __new__(cls, *parts: Union[None, str, Sequence[str]]) -> "PartitionSpec":
        for part in parts:
            names = part if isinstance(part, (tuple, list)) else (part,)
            if part is not None and not all(isinstance(n, str) for n in names):
                raise TypeError(f"a PartitionSpec entry is None, an axis name or a tuple of names, got {part!r}")
        return super().__new__(cls, tuple(tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def default_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = "batch", device: str = "cuda") -> Any:
    """A 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` named ``axis_name``.

    ``devices`` are the ranks of the default process group it spans (all of
    them by default); ``device`` its device type, ``"cuda"`` unless the
    caller asks for ``"cpu"``.  Raises when no process group is initialised:
    the mesh's ranks are processes, which the caller starts.  Building a mesh
    over part of the group is a collective over the whole group.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "default_mesh needs an initialised torch.distributed process group: call "
            "torch.distributed.init_process_group (one rank per process) first"
        )
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' for a mesh of CPU ranks")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis_name,))


def _axis_names(mesh: Any) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_dim(mesh: Any, axis_name: str) -> int:
    names = _axis_names(mesh)
    if axis_name not in names:
        raise ValueError(f"axis {axis_name!r} is not an axis of the mesh (axes: {names})")
    return names.index(axis_name)


def replicated(mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of a value held whole on every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def row_sharded(mesh: Any, axis_name: str = "batch") -> Tuple[Any, ...]:
    """DTensor placements of a value whose rows are split over ``axis_name``."""
    from torch.distributed.tensor import Shard

    dim = _axis_dim(mesh, axis_name)
    return tuple(Shard(0) if j == dim else p for j, p in enumerate(replicated(mesh)))


def leaf_sharding(mesh: Any, value: Any, spec: Optional[PartitionSpec], axis_name: str = "batch") -> Tuple[Any, ...]:
    """The DTensor placements for one whole (global) leaf under ``spec``.

    ``spec`` wins when it fits the leaf; an unknown axis, more spec entries
    than dimensions, a zero or indivisible extent, or a layout DTensor cannot
    represent (one mesh axis over two dimensions, a dimension over mesh axes
    out of mesh order) falls back to replication.  Placement never changes
    values, only layout.
    """
    from torch.distributed.tensor import Replicate, Shard

    if spec is None:
        return replicated(mesh)
    dims = tuple(spec)
    shape = tuple(getattr(value, "shape", ()))
    if len(dims) > len(shape):
        return replicated(mesh)
    names = _axis_names(mesh)
    placements = list(replicated(mesh))
    for i, ax in enumerate(dims):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if any(name not in names for name in axes):
            return replicated(mesh)
        mesh_dims = [names.index(name) for name in axes]
        if mesh_dims != sorted(set(mesh_dims)) or any(not isinstance(placements[j], Replicate) for j in mesh_dims):
            return replicated(mesh)
        size = 1
        for j in mesh_dims:
            placements[j] = Shard(i)
            size *= mesh.size(j)
        if shape[i] == 0 or shape[i] % size:
            return replicated(mesh)
    return tuple(placements)


def _local_piece(mesh: Any, value: torch.Tensor, placements: Sequence[Any]) -> torch.Tensor:
    """This rank's piece of a whole ``value`` under ``placements`` that split it
    evenly (as :func:`leaf_sharding`'s do): the local tensor of the DTensor
    they describe, split mesh dimension by mesh dimension."""
    for j, p in enumerate(placements):
        if p.is_shard():
            value = value.chunk(mesh.size(j), dim=p.dim)[mesh.get_local_rank(j)]
    return value


def _all_replicated(placements: Sequence[Any]) -> bool:
    return all(p.is_replicate() for p in placements)


class MeshBackend(AxisBackend):
    """Collectives over an axis of an explicit :class:`DeviceMesh`.

    Plain tensors in, plain tensors out: a rank's contribution becomes the
    axis's value (what :meth:`Metric.sync` hands it).  A DTensor in follows
    its placement: ``Replicate()`` is already the value (the collective is an
    identity), any other is reduced or gathered from its local tensor, and
    the result comes back ``Replicate()`` on the mesh.
    """

    eager = False
    supports_delta = False
    supports_packed = False
    #: sync reports record ``in_xla_reductions`` instead of wire bytes
    in_xla = True

    def __init__(self, mesh: Optional[Any] = None, axis_name: str = "batch", options: Optional[SyncOptions] = None):
        mesh = mesh if mesh is not None else default_mesh(axis_name=axis_name)
        _axis_dim(mesh, axis_name)
        super().__init__(axis_name, mesh)
        self.options = options if options is not None else SyncOptions.from_env()
        self._telemetry: Dict[str, Any] = {}

    def pop_telemetry(self) -> Optional[Dict[str, Any]]:
        out, self._telemetry = self._telemetry, {}
        return out

    def is_distributed(self) -> bool:
        # a placed metric syncs through its mesh at any size: at one rank the
        # collectives are identities, and the report still counts them
        return True

    def world_size(self) -> int:
        return int(self.mesh.size(_axis_dim(self.mesh, self.axis_name)))

    def _tick(self) -> None:
        self._telemetry["in_xla_reductions"] = self._telemetry.get("in_xla_reductions", 0) + 1

    def _note_wire(self, wire: torch.device, nbytes: int) -> None:
        if wire.type == "cpu":
            self._telemetry["host_bytes"] = self._telemetry.get("host_bytes", 0) + int(nbytes)

    def _placed(self, x: Any, fn: Callable[[Any], torch.Tensor]) -> Any:
        self._tick()
        cls = _dtensor_type()
        if cls is None or not isinstance(x, cls):
            return fn(x)
        if _all_replicated(x.placements):
            return x
        return cls.from_local(fn(x.to_local()), self.mesh, replicated(self.mesh), run_check=False)

    def psum(self, x):
        return self._placed(x, super().psum)

    def pmean(self, x):
        return self._placed(x, super().pmean)

    def pmax(self, x):
        return self._placed(x, super().pmax)

    def pmin(self, x):
        return self._placed(x, super().pmin)

    def reduce_many(self, values: Sequence[torch.Tensor], fx: str) -> List[torch.Tensor]:
        for _ in values:
            self._tick()  # one reduction a state, as the JAX package counts them
        return super().reduce_many(values, fx)

    def all_gather_cat(self, x, device: Optional[torch.device] = None):
        return self._placed(x, lambda v: AxisBackend.all_gather_cat(self, v, device))

    def all_gather_list(self, entries: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's list-state entries, in rank order and each rank's entries in its own order.

        The JAX package's twin is the identity: there one controller's entries
        already span the mesh.  Here each rank holds its own entries, so this
        gathers them as a synced list state gathers its rows (the entries
        joined, one descriptor and one rows gather) plus one gather of each
        entry's row count, and splits the rows again on every rank.  An entry
        comes back at least 1-d, on this rank's first entry's device (the
        wire's when the rank has none).  A rank with no entries takes part too;
        when no rank has any, every rank gets ``[]``.
        """
        self._tick()
        entries = [torch.atleast_1d(torch.as_tensor(e)) for e in entries]
        device = entries[0].device if entries else self._wire_device(self._group())
        sizes = torch.tensor([int(e.shape[0]) for e in entries], dtype=torch.int64)
        counts = AxisBackend.all_gather_cat(self, sizes, device=torch.device("cpu"))
        if not counts.numel():
            return []
        rows = AxisBackend.all_gather_cat(self, torch.cat(entries).to(device) if entries else None, device=device)
        if rows is None:  # entries, but none with a row
            rows = torch.empty(0, device=device)
        return list(torch.split(rows, counts.tolist()))

    def all_gather_merge(self, tree: Dict[str, torch.Tensor], merge_fn: Callable) -> Dict[str, torch.Tensor]:
        self._tick()
        return super().all_gather_merge(tree, merge_fn)
