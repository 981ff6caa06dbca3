"""Dry-run: what each (arch x input shape) step costs on a mesh of N
cards, reckoned without a card (pair: ``repro/launch/dryrun.py:1``).

The JAX package lowers and compiles each step on a simulated TPU mesh and
reads XLA's memory and cost analyses, and its HLO's collectives
(``repro/launch/hlo_analysis.py``). The port traces each step
(``launch/steps.py``) once on fake tensors (``FakeTensorMode``: nothing
is allocated), through the same code the card runs, its kernels K3, K4
and K5 as registered ops with fake bodies and FLOP formulas
(``kernels/{fused_xent,flash_attention,mlstm_chunk}.py``), and counts:

  * FLOPs (products only: matrix products and the kernels' formulas);
  * live bytes and their peak (:class:`LiveBytes`: every storage an op
    makes, held until it is freed, plus the scratch a kernel allocates
    inside its op, ``WORKSPACE``), and the bytes every op reads and writes;
  * on a mesh, the collectives by kind and mesh axis.

On more than one card every family but the xLSTM's (``SHARDED_FAMILIES``;
``UNSHARDED_BLOCKERS`` says what keeps it off) traces one card's share
(:func:`trace_sharded`, ``launch/sharded.py``): every argument a
``DTensor`` holding rank 0's shard under its spec
(``launch/specs.py``) on a fake process group of N ranks, the global
batch, the activations placed at the model's seams by the preset's specs
(``models/shardctx.py``), K3 and K4 under their sharding rules. FLOPs,
bytes and the peak are that card's local tensors', and every collective a
redistribute issues is counted in ``hlo_analysis``'s bytes (the result's
bytes on one card, an all-reduce twice). The roofline gains the
collective term: each mesh axis's bytes over its link rate (``LINK_BW``).
The xLSTM keeps the one-card trace at the per-card local batch
(the global batch over the data axes when split, >= 16), a tensor with
the shape of a weight, gradient or optimizer-state leaf counted at its
per-card share, every activation whole (an upper bound), FLOPs and bytes
moved split evenly over the model axis, and ``"collectives": null``.
``argument_bytes`` and ``output_bytes`` are the specs' own reckoning at
the global shapes (``specs.bytes_per_device``). The roofline takes one
H100's published peaks: 989 TFLOP/s bf16, 3.35 TB/s.

Not ported: the TPU meshes (``--devices N`` replaces ``--multi-pod``,
``launch/mesh.py``) and ``hlo_analysis.py``'s HLO parser (the port counts
its collectives at dispatch). No collective runs: the fake group moves no
data.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--devices 8]

``--all`` runs the combinations one after another; ``scripts/dryrun_all.sh``
runs them as single combinations side by side, one a core.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.kernels import flash_attention, mlstm_chunk
from repro_torch.launch import sharded
from repro_torch.launch import specs as S
from repro_torch.launch import steps as step_lib
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.shardctx import activation_sharding
from repro_torch.tree import tree_leaves

OUT_DIR = "experiments/dryrun_torch"
PEAK_FLOPS = 989e12        # one H100 SXM, bf16 dense (NVIDIA's data sheet)
HBM_BW = 3.35e12           # its device memory rate, bytes/s
WORKSPACE = {**flash_attention.WORKSPACE, **mlstm_chunk.WORKSPACE}
# the collective term's link rates, bytes/s one way, by mesh axis: the
# model axis (at most 8 cards, one HGX H100 node) over NVLink 4, 900 GB/s
# both ways a card; the data axis across nodes over one 400 Gb/s NDR
# InfiniBand link a card
LINK_BW = {"model": 450e9, "data": 50e9}
# the families whose steps trace on DTensors over a mesh of more than one card
SHARDED_FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid")
# what keeps each other family's steps off DTensors
UNSHARDED_BLOCKERS = {
    "ssm": "F.logsigmoid (aten.log_sigmoid_forward) has no DTensor sharding strategy "
           "(models/ssm.py:82), the mLSTM decode's einsum reads a scalar "
           "(aten._local_scalar_dense, models/ssm.py:117), and K5 (mlstm_chunk) has no "
           "sharding rule",
}
# a one-card record's notes: at one card the trace runs on plain tensors,
# which ``constrain`` leaves as they are, so the record's numbers stay what
# they were before the sharded trace
ONE_CARD_NOTES = {
    "temp_bytes_note": "traced peak over the arguments at the local batch; an upper "
                       "bound where the model axis would also split activations",
    "preset_note": "activation presets are not reckoned at one card: its trace runs on "
                   "plain tensors, which constrain leaves as they are",
}
UNSHARDED_NOTES = {
    "temp_bytes_note": ONE_CARD_NOTES["temp_bytes_note"],
    "preset_note": "activation presets are not reckoned for this family: its trace runs "
                   "on plain tensors, and a plain tensor is placed nowhere",
}
SHARDED_NOTES = {
    "temp_bytes_note": "traced peak over the arguments of one card: rank 0's shards of "
                       "every tensor, activations placed by the preset's specs",
}


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode prices one token."""
    n_active = M.count_params_analytic(cfg.replace(tie_embeddings=False), active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token / sequence


_VIEWS: dict = {}


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them (a view)."""
    if func not in _VIEWS:
        returns = func._schema.returns
        _VIEWS[func] = bool(returns) and all(
            r.alias_info is not None and not r.alias_info.is_write for r in returns)
    return _VIEWS[func]


# the queries that return no tensor and read only a tensor's metadata
_METADATA = {torch.ops.prim.device, torch.ops.prim.layout, torch.ops.aten.sym_size,
             torch.ops.aten.sym_stride, torch.ops.aten.sym_numel,
             torch.ops.aten.sym_storage_offset, torch.ops.aten.is_contiguous}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class LiveBytes(TorchDispatchMode):
    """The live bytes of a traced step and their peak, and the bytes its
    ops move.

    ``held`` are the tensors live before the step (its arguments). Every
    storage an op returns counts from then until it is freed, once however
    many views share it; an op of ``WORKSPACE`` adds its scratch while it
    runs. ``shares`` maps a shape to the cards a tensor of it is split
    over; a tensor of another shape counts whole, and the bytes it moves
    over ``split`` cards. A view and a metadata query (``_METADATA``) move
    nothing; any other op reads its tensor inputs and writes its outputs
    (an ``empty`` writes nothing)."""

    def __init__(self, held, shares: "dict | None" = None, split: int = 1):
        super().__init__()
        self.shares = shares or {}
        self.split = split
        self.live = 0
        self.moved = 0.0
        self._seen: set[int] = set()
        for t in held:
            self._hold(t)
        self.start = self.peak = self.live

    def _share(self, t: torch.Tensor) -> int:
        return self.shares.get(tuple(t.shape), 1)

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._seen:
            return
        n = storage.nbytes() // self._share(t)
        self._seen.add(key)
        self.live += n
        weakref.finalize(storage, self._release, key, n)

    def _release(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _moves(self, t: torch.Tensor) -> float:
        share = self.shares.get(tuple(t.shape))
        n = t.numel() * t.element_size()
        return n / share if share else n / self.split

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor's dispatch hands its local ops back
        out = func(*args, **(kwargs or {}))
        if _is_view(func) or func.overloadpacket in _METADATA:
            return out
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        scratch = WORKSPACE.get(func.overloadpacket)
        self.peak = max(self.peak, self.live + (scratch(*args) if scratch else 0))
        moves = ([] if "empty" in func.__name__ else outs) + _tensors(args) + _tensors(kwargs)
        self.moved += sum(self._moves(t) for t in moves)
        return out


def local_shape(shape, mesh: Mesh):
    """``shape`` at one card's batch: the global batch over the data axes
    when the specs split it (a batch of 16 or more)."""
    if shape.global_batch < 16:
        return shape
    n = 1
    for a in S.data_axes(mesh):
        n *= mesh.axis_size(a)
    return dataclasses.replace(shape, global_batch=-(-shape.global_batch // n))


def _shares(built: dict, mesh: Mesh) -> dict:
    """shape -> cards, over the state leaves (parameters, optimizer state,
    caches) of a built step: the fewest any leaf of that shape is split
    over."""
    shares: dict = {}
    for leaf, spec in S.leaves_with_specs(built["args"], built["in_specs"]):
        if torch.is_tensor(leaf):
            n = S.spec_divisor(spec, mesh)
            key = tuple(leaf.shape)
            shares[key] = min(shares.get(key, n), n)
    return {k: n for k, n in shares.items() if n > 1}


def trace_step(built: dict, mesh: Mesh) -> dict:
    """One call of a built step under its fake mode (or on its real
    tensors, where ``built["mode"]`` is None), counted: FLOPs, the peak of
    live bytes, the bytes live at the start (the arguments) and the bytes
    moved, per card of ``mesh`` (FLOPs and bytes moved over its model
    axis)."""
    split = mesh.axis_size("model")
    held = [t for t in tree_leaves(built["args"]) if torch.is_tensor(t)]
    with built["mode"] or contextlib.nullcontext(), activation_sharding(**built["act_specs"]):
        with LiveBytes(held, _shares(built, mesh), split) as mem, \
                FlopCounterMode(display=False) as counter:
            built["fn"](*built["args"])
    return {"flops": counter.get_total_flops() / split, "peak_bytes": mem.peak,
            "held_bytes": mem.start, "hbm_bytes": mem.moved}


def trace_sharded(built: dict, mesh: Mesh, make=None) -> dict:
    """One call of a built step (global shapes) on one card of ``mesh``:
    its arguments as ``DTensor``s holding rank 0's shards on a fake
    process group (``launch/sharded.py``), counted beneath DTensor's
    dispatch: FLOPs, the peak of live bytes, the bytes live at the start
    and the bytes moved, all of that card's local tensors, and the
    collectives by kind and mesh axis. The trace runs in ``built``'s fake
    mode; with ``make`` (``sharded.distribute``'s) the shards are real
    tensors and the step runs on them."""
    mode = None if make else built["mode"]
    with sharded.fake_mesh(mesh) as dmesh:
        with mode or contextlib.nullcontext():
            args = sharded.distribute(built["args"], built["in_specs"], dmesh, make)
        held = sharded.locals_of(args)
        with mode or contextlib.nullcontext(), implicit_replication(), \
                sharded.unwatched_propagation(), activation_sharding(**built["act_specs"]):
            with LiveBytes(held) as mem, sharded.Counts(dmesh) as counts:
                built["fn"](*args)
    return {"flops": counts.flops, "peak_bytes": mem.peak, "held_bytes": mem.start,
            "hbm_bytes": mem.moved, "collectives": counts.collectives,
            "by_axis": counts.by_axis}


def collective_seconds(by_axis: dict) -> float:
    """The collective term: each mesh axis's bytes over its link rate."""
    return sum(sum(kinds.values()) / LINK_BW[axis] for axis, kinds in by_axis.items())


def run_one(arch: str, shape_name: str, *, devices: int = 256, tier: "int | None" = None,
            step: "str | None" = None, save: bool = True, verbose: bool = True,
            preset: str = "baseline", pad_vocab: int = 0, cfg=None) -> dict:
    """Trace ``arch`` (its config, or ``cfg``) at ``shape_name`` on a mesh
    of ``devices`` cards; print one ``[dryrun]`` line and write the record
    to ``OUT_DIR`` unless ``save`` is False. Returns the record."""
    cfg = cfg or get_config(arch)
    if pad_vocab:
        cfg = cfg.replace(pad_vocab_multiple=pad_vocab)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(devices)
    builder = step_lib.builder_for(shape, step)
    kw = {}
    if builder is step_lib.build_dtfl_train:
        if tier is not None:
            kw["tier"] = tier
        kw["preset"] = preset
    if builder is step_lib.build_decode and preset != "baseline":
        kw["preset"] = preset
    built = builder(cfg, shape, mesh, **kw)
    local = local_shape(shape, mesh)
    on_mesh = mesh.size > 1 and built["cfg"].family in SHARDED_FAMILIES
    t0 = time.perf_counter()
    if on_mesh:
        counted = trace_sharded(built, mesh)
    else:
        counted = trace_step(builder(cfg, local, mesh, **kw) if local != shape else built, mesh)
    trace_s = time.perf_counter() - t0

    arg_bytes = S.bytes_per_device(built["args"], built["in_specs"], mesh)
    out_bytes = S.bytes_per_device(built["outs"], built["out_specs"], mesh)
    temp_bytes = counted["peak_bytes"] - counted["held_bytes"]
    mf = model_flops(built["cfg"], shape)
    compute_s, memory_s = counted["flops"] / PEAK_FLOPS, counted["hbm_bytes"] / HBM_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s}
    if on_mesh:
        terms["collective_s"] = collective_seconds(counted["by_axis"])
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(f"{a}{n}" for a, n in zip(mesh.axis_names, mesh.shape)),
        "n_devices": mesh.size,
        "step": step or shape.kind,
        "preset": preset + ("+padvocab" if pad_vocab else ""),
        "tier": built["tier"],
        "local_batch": local.global_batch,
        "trace_device": step_lib.trace_device(),
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp_bytes,
            "peak_bytes": arg_bytes + temp_bytes,
            **(SHARDED_NOTES if on_mesh else UNSHARDED_NOTES if mesh.size > 1
               else ONE_CARD_NOTES),
        },
        "flops_per_device": counted["flops"],
        "hbm_bytes_per_device": counted["hbm_bytes"],
        "roofline": {**terms, "dominant": max(terms, key=terms.get)[:-2]},
        "model_flops_total": mf,
        "useful_flops_ratio": mf / mesh.size / max(counted["flops"], 1.0),
    }
    if on_mesh:
        rec["collective_bytes"] = sum(counted["collectives"].values())
        rec["collectives"] = {"by_kind": counted["collectives"], "by_axis": counted["by_axis"]}
    elif mesh.size > 1:
        rec["collectives"] = None
        family = built["cfg"].family
        rec["collectives_note"] = (f"not reckoned for the {family} family: its layers take no "
                                   f"DTensor yet: {UNSHARDED_BLOCKERS[family]} (ROADMAP.md, "
                                   f"Queue 1)")
    if verbose:
        print(f"[dryrun] {arch:24s} {shape_name:12s} mesh={rec['mesh']:14s} "
              f"trace={trace_s:6.1f}s args/dev={arg_bytes / 2**30:7.2f}GiB "
              f"temp/dev={temp_bytes / 2**30:7.2f}GiB flops/dev={counted['flops']:.4e} "
              f"useful={rec['useful_flops_ratio']:.4f} "
              f"t_comp={compute_s * 1e3:.4g}ms t_mem={memory_s * 1e3:.4g}ms "
              + (f"coll/dev={rec['collective_bytes'] / 2**30:.4f}GiB "
                 f"t_coll={terms['collective_s'] * 1e3:.4g}ms " if on_mesh else "")
              + f"dom={rec['roofline']['dominant']}")
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        tag = f"{arch}_{shape_name}_d{mesh.size}" + (f"_{step}" if step else "")
        if preset != "baseline":
            tag += f"_{preset}"
        if pad_vocab:
            tag += f"_pv{pad_vocab}"
        with open(f"{OUT_DIR}/{tag}.json", "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--devices", type=int, default=256,
                    help="cards of the mesh: (data N/m, model m), m = min(N, 8)")
    ap.add_argument("--all", action="store_true", help="all (arch x shape) combos")
    ap.add_argument("--tier", type=int, default=None)
    ap.add_argument("--step", choices=list(step_lib.BUILDERS), default=None)
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--preset", default="baseline",
                    choices=["baseline", "seqpar", "megatron_sp", "serve_dp", "serve_seq"])
    ap.add_argument("--pad-vocab", type=int, default=0)
    args = ap.parse_args(argv)

    combos = ([(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES] if args.all
              else [(args.arch, args.shape)])
    kw = dict(devices=args.devices, tier=args.tier, step=args.step, save=not args.no_save,
              preset=args.preset, pad_vocab=args.pad_vocab)
    failures = []
    t0 = time.perf_counter()
    for arch, shape in combos:
        try:
            run_one(arch, shape, **kw)
        except Exception as e:  # noqa: BLE001 -- report every combination, then fail
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] FAIL {arch} {shape}: {e}")
            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures")
        sys.exit(1)
    print(f"[dryrun] all {len(combos)} combination(s) traced OK in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
