"""The dry-run's sharded trace: one card's share of a step on a mesh of N
cards, in one process (pair: the SPMD partitioning that the JAX package's
``repro/launch/dryrun.py:78-92`` compiles, and the collective bytes that
``repro/launch/hlo_analysis.py`` reads from its HLO).

:func:`fake_mesh` makes a ``DeviceMesh`` of N ranks over torch's ``fake``
process-group backend for the length of one trace: this process is rank
0, and a collective moves no data. :func:`distribute` turns a built
step's arguments (``launch/steps.py``, global shapes) into ``DTensor``s
under their specs (``launch/specs.py``), each holding rank 0's shard.
The step then runs on them as on plain tensors: DTensor's sharding rules
split each op (K3's and K4's are their modules' own), the model's seams
redistribute the activations to the JAX package's layouts
(``models/shardctx.py``), and every redistribute issues the collectives
a card would: the functional ones, and DTensor's own all-to-all
(``_dtensor.shard_dim_alltoall``, a move from one split to another on
one mesh axis). :class:`Counts` watches the local ops beneath DTensor's
dispatch: FLOPs (by ``torch.utils.flop_counter``'s formulas), and the
collectives by kind and mesh axis, in ``hlo_analysis``'s bytes (the
result's bytes on one card, an all-reduce twice); it stands in for each
collective with rank 0's operand (``_mirror``), so the same step also
runs on real tensors on one card. An op that has no sharding rule fails
the trace, and so does an op of the collectives' namespaces that is not
counted; nothing is replicated or moved behind the count's back.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import placements
from repro_torch.tree import tree_leaves, tree_unflatten

# the collectives a redistribute issues, by hlo_analysis's kind and the
# weight of their result's bytes: the functional ones, and DTensor's own
# all-to-all (a Shard(i) -> Shard(j) move on one mesh axis of a card mesh)
_c10d = torch.ops._c10d_functional
_alltoall = torch.ops._dtensor.shard_dim_alltoall
COLLECTIVES = {
    _c10d.all_gather_into_tensor: ("all-gather", 1),
    _c10d.all_reduce: ("all-reduce", 2),
    _c10d.reduce_scatter_tensor: ("reduce-scatter", 1),
    _c10d.all_to_all_single: ("all-to-all", 1),
    _alltoall: ("all-to-all", 1),
}
# the namespaces of the ops that may move data between cards, and their
# ops that move nothing (by name: not every torch has each)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "mesh_get_process_group")


@contextlib.contextmanager
def fake_mesh(mesh: Mesh):
    """A ``DeviceMesh`` of cards shaped as ``mesh`` over a ``fake`` process
    group of ``mesh.size`` ranks, this process rank 0, for the block (a
    mesh of cards whichever device the tensors claim: its redistributes
    are the card's, all-to-alls included). The default
    group is destroyed on exit, so ``torch.distributed`` is as it was.
    A process that already has a default group is refused: the fake group
    would replace it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the sharded trace makes a fake process group of its own, and "
                           "this process already has a default group")
    ensure_index_copy_rule()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield DeviceMesh("cuda", torch.arange(mesh.size).reshape(mesh.shape),
                         mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def has_strategy(op) -> bool:
    """Whether DTensor can place ``op`` by itself: a sharding rule or
    strategy of its own, or (where this torch has them) a strategy traced
    through the op's decomposition."""
    prop = DTensor._op_dispatcher.sharding_propagator
    if any(op in getattr(prop, table, {}) for table in
           ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs")):
        return True
    decomp = getattr(prop, "decomp_strategy", None)
    return decomp is not None and decomp.has_decomp(op)


def index_copy_sharding(self, dim, index, source):
    """The decode step's cache write (``models/layers.py::attn_decode_apply``)
    on ``DTensor``s, one mesh axis at a time: self and source split alike
    over any dimension but the one written into, the index whole. A cache
    split over its window takes the masked write there instead."""
    dim %= len(self.shape)
    whole = ([Replicate()], [Replicate(), None, Replicate(), Replicate()])
    return [whole] + [([Shard(d)], [Shard(d), None, Replicate(), Shard(d)])
                      for d in range(len(self.shape)) if d != dim]


def ensure_index_copy_rule() -> None:
    """Register :func:`index_copy_sharding` for ``aten.index_copy_`` where
    DTensor has no strategy of its own (torch 2.11 has none; later
    versions trace one through the op's decomposition, and keep it)."""
    op = torch.ops.aten.index_copy_.default
    if not has_strategy(op):
        register_sharding(op)(index_copy_sharding)


@contextlib.contextmanager
def unwatched_propagation():
    """DTensor infers each op's global output shape by running it once on
    fake tensors of the global shapes (the first time it meets the op's
    shardings); for the block that run happens outside every dispatch
    mode, so counting modes see only the local ops a card runs."""
    prop = DTensor._op_dispatcher.sharding_propagator
    inner = prop._propagate_tensor_meta_non_cached

    def quiet(op_schema):
        with _disable_current_modes():
            return inner(op_schema)

    prop._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached


def local_shape(shape: tuple, spec: tuple, dmesh: DeviceMesh) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` under ``spec``: each split
    dimension's first chunk, mesh axis by mesh axis (``torch.chunk``'s
    sizes, as ``Shard`` cuts)."""
    local = list(shape)
    for axis, p in enumerate(placements(spec, len(local), dmesh)):
        if isinstance(p, Shard):
            local[p.dim] = -(-local[p.dim] // dmesh.size(axis))
    return tuple(local)


def distribute(tree, specs, dmesh: DeviceMesh, make=None):
    """``tree`` with every tensor leaf a ``DTensor`` of its global shape
    under its spec, holding rank 0's shard: ``make(leaf, local_shape)``'s
    tensor (default: an empty one like the leaf, as a fake mode makes
    it). A leaf that requires grad gives a leaf ``DTensor`` that does."""
    make = make or (lambda t, shape: t.new_empty(shape))
    out = []
    for leaf, spec in S.leaves_with_specs(tree, specs):
        if not torch.is_tensor(leaf):
            out.append(leaf)
            continue
        place = placements(spec, leaf.ndim, dmesh)
        local = make(leaf, local_shape(leaf.shape, spec, dmesh))
        d = DTensor.from_local(local, dmesh, place, run_check=False, shape=leaf.shape,
                               stride=torch.empty(leaf.shape, device="meta").stride())
        out.append(d.detach().requires_grad_(leaf.requires_grad))
    return tree_unflatten(tree, out)


def locals_of(tree) -> list:
    """The local tensors of a tree's ``DTensor`` leaves (and its plain tensors)."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if torch.is_tensor(t)]


def _mirror(packet, x: torch.Tensor, rest: tuple) -> torch.Tensor:
    """A collective's result on one card as if every card held this card's
    operand: the fake group moves no data, and its outputs would be
    unwritten memory (a gathered token would index anywhere). All-gather:
    the operand repeated over the group; all-reduce and all-to-all of equal
    blocks: the operand; reduce-scatter: its first block; DTensor's
    all-to-all (gather_dim, shard_dim, group): the first block of the
    operand along shard_dim from each card, joined along gather_dim. Each
    is a new tensor of the collective's result shape, so a trace's live
    bytes see its output."""
    if packet is _c10d.all_gather_into_tensor:
        return torch.cat([x] * rest[0])
    if packet is _c10d.reduce_scatter_tensor:
        return x.chunk(rest[1])[0].clone()
    if packet is _alltoall:
        gather_dim, shard_dim, group = rest[:3]
        n = dist.distributed_c10d._resolve_process_group(group).size()
        return torch.cat([x.narrow(shard_dim, 0, x.shape[shard_dim] // n)] * n, gather_dim)
    return x.clone()


class Counts(TorchDispatchMode):
    """The FLOPs and the collectives of the local ops beneath DTensor's
    dispatch (an op on ``DTensor``s is handed on to it, and its local ops
    come back here). ``axes`` maps a process group's name to its mesh
    axis. ``collectives`` holds {kind: bytes} and ``by_axis`` {axis:
    {kind: bytes}}."""

    def __init__(self, dmesh: DeviceMesh):
        super().__init__()
        self.axes = {dmesh.get_group(d).group_name: name
                     for d, name in enumerate(dmesh.mesh_dim_names)}
        self.flops = 0
        self.collectives: dict[str, int] = {}
        self.by_axis: dict[str, dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in COLLECTIVES:
            out = _mirror(packet, args[0], args[1:])
            self._collective(packet, out, args, kwargs)
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES and packet.__name__ not in _NOT_COLLECTIVES:
            raise NotImplementedError(f"the sharded trace counts no {func}")
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        return out

    def _collective(self, packet, out, args, kwargs) -> None:
        kind, weight = COLLECTIVES[packet]
        group = kwargs.get("group_name", args[-1])
        axis = self.axes[group]
        n = weight * out.numel() * out.element_size()
        self.collectives[kind] = self.collectives.get(kind, 0) + n
        per = self.by_axis.setdefault(axis, {})
        per[kind] = per.get(kind, 0) + n
