"""The dry-run's sharded trace (``launch/sharded.py``, ``launch/dryrun.py``,
``models/shardctx.py``, the K3/K4 sharding rules) against the JAX
package's ``hlo_analysis`` of the same programs, compiled on 8 host
devices in a process of its own (``tests/jax_hlo_collectives.py``).

Unit cases, on a (data 2, model 4) mesh, in fp32: per card, FLOPs and
collective bytes by kind equal the JAX package's. A column-parallel then
row-parallel pair makes one all-reduce; a vocab-split cross-entropy
three all-reduces of a row each (its backward none); an FSDP weight an
all-gather in its forward and, in its backward, a reduce-scatter of the
gradient, which XLA's CPU backend emits as an all-reduce of the whole
gradient followed by a slice: under ``hlo_analysis``'s weights that
all-reduce counts 2 x (data axis) x the reduce-scatter's bytes.

Also: the fake group leaves ``torch.distributed`` as it found it (and
refuses to replace a group that exists); the port's ``index_copy_`` rule
places the decode step's cache write as torch's own strategy does, where
torch has one; at one card a record is what the
port wrote before the sharded trace (a decode step's bytes as one-token
attention now reckons them, and a device query moving nothing); the
xLSTM, the family without the trace, writes ``"collectives": null`` with
a note naming what blocks it; DTensor's all-to-all is counted on its
mesh axis, and an uncounted op of the collectives' namespaces fails the
trace; the CLI prints ``t_coll`` and writes the collectives by kind and
axis.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, register_sharding

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels.fused_xent import fused_xent
from repro_torch.launch import dryrun, sharded
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import write_cache_slot
from repro_torch.sharding import gather_fsdp, placements

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MESH = Mesh(("data", "model"), (2, 4))
UNIT = dict(B=16, D=64, F=256, V=512)  # tests/jax_hlo_collectives.py's UNIT


def start_jax_hlo(*cases):
    """Start the JAX package's analysis of ``cases`` in a process of its
    own; returns the function that waits for it and gives {case:
    {"flops", "coll"}} (the caller traces the port's side meanwhile)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_hlo_collectives.py"),
                             *cases], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)

    def result() -> dict:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])

    return result


def jax_hlo(*cases) -> dict:
    """The JAX package's {case: {"flops", "coll"}} from a process of its own."""
    return start_jax_hlo(*cases)()


@pytest.fixture(scope="module")
def jax_units():
    return jax_hlo("unit")


def _colrow(x, w1, w2):
    y = (x @ w1) @ w2
    return y.redistribute(y.device_mesh, [Shard(0), Replicate()])


def _fsdp(x, w, dy):
    with torch.enable_grad():
        y = x @ gather_fsdp(w, x, 0)
        dw, = torch.autograd.grad(y, w, dy)
    assert tuple(y.placements) == tuple(dw.placements) == (Shard(0), Shard(1))


def _xent(logits, labels, g):
    with torch.enable_grad():
        per = fused_xent(logits, labels)
        dl, = torch.autograd.grad(per, logits, g)
    assert tuple(per.placements) == (Shard(0), Replicate())
    assert tuple(dl.placements) == (Shard(0), Shard(1))


f32 = torch.float32
CASES = {
    "colrow": (_colrow, [((UNIT["B"], UNIT["D"]), f32), ((UNIT["D"], UNIT["F"]), f32),
                         ((UNIT["F"], UNIT["D"]), f32)],
               [("data", None), (None, "model"), ("model", None)]),
    "fsdp": (_fsdp, [((UNIT["B"], UNIT["D"]), f32), ((UNIT["D"], UNIT["D"]), f32),
                     ((UNIT["B"], UNIT["D"]), f32)],
             [("data", None), ("data", "model"), ("data", "model")]),
    "xent": (_xent, [((UNIT["B"], UNIT["V"]), f32), ((UNIT["B"],), torch.int32),
                     ((UNIT["B"],), f32)],
             [("data", "model"), ("data",), ("data",)]),
}


def port_unit(name: str) -> "sharded.Counts":
    fn, shapes, specs = CASES[name]
    mode = FakeTensorMode()
    with sharded.fake_mesh(MESH) as dmesh:
        with mode:
            args = sharded.distribute([torch.empty(s, dtype=dt, device="meta")
                                       for s, dt in shapes], specs, dmesh)
            args = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
        with mode, implicit_replication(), sharded.unwatched_propagation(), \
                sharded.Counts(dmesh) as counts:
            fn(*args)
    return counts


@pytest.mark.parametrize("name", list(CASES))
def test_unit_case_flops_and_collectives_equal_jax(jax_units, name):
    counts, want = port_unit(name), jax_units[name]
    assert counts.flops == want["flops"]
    got = dict(counts.collectives)
    if name == "fsdp":
        # the gradient's reduce-scatter over data (2 cards): XLA's CPU
        # backend all-reduces the whole gradient, then slices it
        assert set(got) == {"all-gather", "reduce-scatter"}
        assert set(want["coll"]) == {"all-gather", "all-reduce"}
        assert want["coll"]["all-reduce"] == 2 * 2 * got.pop("reduce-scatter") > 0
        want = {"all-gather": want["coll"]["all-gather"]}
    else:
        want = want["coll"]
    assert got == want
    assert sum(got.values()) > 0


def test_dtensor_all_to_all_is_counted_and_mirrored():
    # a (16, 64) fp32 tensor split over its columns on the model axis,
    # redistributed to a split over its rows there: DTensor's all-to-all
    mode = FakeTensorMode()
    with sharded.fake_mesh(MESH) as dmesh, mode:
        d = DTensor.from_local(torch.empty(16, 16, device="meta"), dmesh,
                               [Replicate(), Shard(1)], run_check=False, shape=(16, 64),
                               stride=(64, 1))
        with implicit_replication(), sharded.unwatched_propagation(), \
                sharded.Counts(dmesh) as counts:
            y = d.redistribute(dmesh, [Replicate(), Shard(0)])
        assert tuple(y.placements) == (Replicate(), Shard(0))
        assert tuple(y.to_local().shape) == (4, 64)
    assert counts.by_axis == {"model": {"all-to-all": 4 * 64 * 4}}
    assert counts.collectives == {"all-to-all": 4 * 64 * 4} and counts.flops == 0
    # on real tensors (the op the redistribute issues, gather dim 1, split
    # dim 0): the all-to-all of equal (16, 16) operands, rank 0 holding the
    # first 4 rows of every card's block
    x = torch.randn(16, 16, generator=torch.Generator().manual_seed(0))
    with sharded.fake_mesh(MESH) as dmesh, sharded.Counts(dmesh) as counts:
        local = torch.ops._dtensor.shard_dim_alltoall(x, 1, 0, dmesh.get_group(1).group_name)
    assert torch.equal(local, torch.cat([x[:4]] * 4, dim=1))
    assert counts.by_axis == {"model": {"all-to-all": 4 * 64 * 4}}


def test_uncounted_collectives_fail_the_trace():
    lib = torch.library.Library("_dtensor", "FRAGMENT")
    lib.define("_test_moves(Tensor x, str group_name) -> Tensor")
    lib.impl("_test_moves", lambda x, group_name: x.clone(), "CompositeExplicitAutograd")
    x = torch.ones(4)
    with sharded.fake_mesh(MESH) as dmesh:
        group = dmesh.get_group(1).group_name
        for op in (lambda: torch.ops._c10d_functional.broadcast(x, 0, group),
                   lambda: torch.ops._dtensor._test_moves(x, group)):
            with sharded.Counts(dmesh), pytest.raises(NotImplementedError, match="counts no"):
                op()
        # what moves nothing passes: the process group's lookup, a wait
        with sharded.Counts(dmesh) as counts:
            torch.ops._c10d_functional.wait_tensor(x)
        assert counts.collectives == {}


# ---------------------------------------------------------------------------
# the fake group
# ---------------------------------------------------------------------------

def test_fake_mesh_leaves_torch_distributed_as_it_was():
    assert not dist.is_initialized()
    with sharded.fake_mesh(MESH) as dmesh:
        assert dist.is_initialized() and dist.get_world_size() == 8 and dist.get_rank() == 0
        assert dmesh.mesh_dim_names == ("data", "model") and tuple(dmesh.shape) == (2, 4)
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with sharded.fake_mesh(MESH):
            raise ValueError("inside the block")
    assert not dist.is_initialized()
    # a group that exists is kept, and the fake group refused
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        with pytest.raises(RuntimeError, match="already has a default group"):
            with sharded.fake_mesh(MESH):
                pass
        assert dist.is_initialized() and dist.group.WORLD is group
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_distribute_holds_rank_zero_shards():
    with sharded.fake_mesh(Mesh(("data", "model"), (2, 8))) as dmesh:
        with FakeTensorMode():
            t = torch.empty(1, 15, 6, device="meta")
            d, = sharded.distribute([t], [("model", "data")], dmesh)
        assert isinstance(d, DTensor) and tuple(d.shape) == (1, 15, 6)
        assert tuple(d.placements) == (Shard(2), Shard(1))
        assert tuple(d.to_local().shape) == (1, 2, 3)  # 15 over 8: torch.chunk's first
    assert sharded.local_shape((15, 6), ("model", "data"), dmesh) == (2, 3)


@contextlib.contextmanager
def _port_index_copy_rule():
    """The port's ``index_copy_`` rule in place of torch's own strategy for
    the block, torch's restored on exit."""
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.index_copy_.default
    saved = {t: getattr(prop, t).get(op) for t in ("op_strategy_funcs", "op_to_schema_info")}
    register_sharding(op)(sharded.index_copy_sharding)
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        for t, v in saved.items():
            if v is None:
                getattr(prop, t).pop(op, None)
            else:
                getattr(prop, t)[op] = v
        prop.propagate_op_sharding.cache_clear()


def _cache_write(cache_spec, source_spec) -> tuple:
    """The decode step's write (``write_cache_slot``) into a cache (C, B, W,
    KV, hd) at slot 3 on a (2, 4) mesh: the cache's placements and local
    shape after the write, and the collectives the write issued."""
    with sharded.fake_mesh(MESH) as dmesh:
        with FakeTensorMode():
            cache, source = sharded.distribute(
                [torch.empty(1, 4, 8, 8, 16, device="meta"),
                 torch.empty(1, 4, 1, 8, 16, device="meta")], [cache_spec, source_spec], dmesh)
            slot = torch.full((1,), 3, dtype=torch.int64, device="meta")
            with implicit_replication(), sharded.unwatched_propagation(), \
                    sharded.Counts(dmesh) as counts:
                assert write_cache_slot(cache, slot, source) is cache
        # an in-place write keeps the cache where it was
        assert tuple(cache.placements) == placements(cache_spec, 5, dmesh)
        return tuple(cache.placements), tuple(cache.to_local().shape), counts.by_axis


CACHE_WRITES = [(("data", None, "model", None), ("data", None, "model", None)),
                (("data", None, None, "model"), ("data", None, None, "model")),
                (("data", None, None, None), ("data", None, None, None)),
                (("data", None, "model", None), ("data", None, None, None)),
                ((None, None, None, "model"), (None, None, None, None))]


@pytest.mark.parametrize("cache_spec,source_spec", CACHE_WRITES)
def test_index_copy_rule_places_the_cache_write_as_torch_does(cache_spec, source_spec):
    # torch's own strategy where it has one (torch 2.13 traces one through
    # the op's decomposition); else the port's rule, which fake_mesh registers
    torch_own = _cache_write(cache_spec, source_spec)
    with _port_index_copy_rule():
        port = _cache_write(cache_spec, source_spec)
    assert port == torch_own


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------

# reduced SmolLM-360M at one card (seq <= 128, batch <= 16, tier 1), as the
# dry-run recorded it before the sharded trace: flops, hbm bytes, argument,
# output, temp and peak bytes; but the hbm bytes of train and prefill,
# where a device query (``prim.device``) now moves nothing (they were
# 1,461,750,568 and 273,769,496 while each query counted its tensor)
ONE_CARD = {
    "train_4k": (8526495744.0, 754960864.0, 8676364, 8659988, 26445328, 35121692),
    "prefill_32k": (2551185408.0, 214832912.0, 1189120, 16384, 10485760, 11674880),
    "decode_32k": (20971520.0, 50292664.0, 3278152, 2113544, 2162688, 5440840),
    "long_500k": (1310720.0, 11763664.0, 1312012, 132104, 69632, 1381644),
}
# the decode steps' hbm, temp and peak bytes where they differ from the
# records above: one-token attention (``models/layers.py::decode_attention``)
# is one pair of batched products for plain tensors and ``DTensor``s alike,
# whose ops the trace reckons, a device query moving nothing (the hbm
# bytes were 40,495,032 and 10,956,752 while each query counted its
# tensor); FLOPs and arguments are the records'
DECODE_BMM = {
    "decode_32k": (26694240.0, 2129920, 5408072),
    "long_500k": (2120748.0, 72704, 1384716),
}
ONE_CARD_KEYS = {"arch", "flops_per_device", "hbm_bytes_per_device", "local_batch", "memory",
                 "mesh", "model_flops_total", "n_devices", "preset", "roofline", "shape", "step",
                 "tier", "trace_device", "trace_s", "useful_flops_ratio"}


def _small(monkeypatch, name, seq=128, batch=16):
    shape = INPUT_SHAPES[name]
    monkeypatch.setitem(dryrun.INPUT_SHAPES, name, shape.__class__(
        name, min(shape.seq_len, seq), min(shape.global_batch, batch), shape.kind))


@pytest.mark.parametrize("name", list(ONE_CARD))
def test_one_card_record_is_unchanged(monkeypatch, name):
    _small(monkeypatch, name)
    cfg = get_config("smollm-360m").reduced()
    tier = 1 if name == "train_4k" else None
    rec = dryrun.run_one("smollm-360m", name, devices=1, save=False, verbose=False, cfg=cfg,
                         tier=tier)
    m = rec["memory"]
    flops, hbm, args, outs, temp, peak = ONE_CARD[name]
    hbm, temp, peak = DECODE_BMM.get(name, (hbm, temp, peak))
    assert (rec["flops_per_device"], rec["hbm_bytes_per_device"], m["argument_bytes"],
            m["output_bytes"], m["temp_bytes"], m["peak_bytes"]) == (flops, hbm, args, outs,
                                                                     temp, peak)
    assert set(rec) == ONE_CARD_KEYS and set(rec["roofline"]) == {"compute_s", "memory_s",
                                                                  "dominant"}
    assert m["preset_note"] == dryrun.ONE_CARD_NOTES["preset_note"]


def test_non_dense_record_has_no_collectives(monkeypatch):
    # the xLSTM, the one family the sharded trace does not take yet
    _small(monkeypatch, "decode_32k", seq=64)
    cfg = get_config("xlstm-350m").reduced()
    rec = dryrun.run_one("xlstm-350m", "decode_32k", devices=8, save=False, verbose=False,
                         cfg=cfg)
    assert rec["collectives"] is None and "ssm family" in rec["collectives_note"]
    assert all(b in rec["collectives_note"] for b in ("logsigmoid", "ssm.py:117", "K5"))
    assert "collective_s" not in rec["roofline"] and "collective_bytes" not in rec
    assert rec["memory"]["preset_note"] == dryrun.UNSHARDED_NOTES["preset_note"]


def test_cli_prints_t_coll_and_writes_collectives_by_kind_and_axis(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b",
                          "--shape", "decode_32k", "--devices", "8"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("[dryrun] yi-6b"))
    assert "mesh=data1xmodel8" in line and " t_coll=" in line and "ms dom=" in line
    rec = json.loads((tmp_path / dryrun.OUT_DIR / "yi-6b_decode_32k_d8.json").read_text())
    coll = rec["collectives"]
    assert set(coll) == {"by_kind", "by_axis"}
    assert rec["collective_bytes"] == sum(coll["by_kind"].values()) > 0
    assert set(coll["by_axis"]) <= {"data", "model"}
    for kind, n in coll["by_kind"].items():
        assert kind in {k for k, _ in sharded.COLLECTIVES.values()}
        assert n == sum(per.get(kind, 0) for per in coll["by_axis"].values())
    assert rec["roofline"]["collective_s"] == pytest.approx(
        sum(sum(per.values()) / dryrun.LINK_BW[axis] for axis, per in coll["by_axis"].items()))
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["temp_bytes_note"] == dryrun.SHARDED_NOTES["temp_bytes_note"]
