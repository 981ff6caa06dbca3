"""The port's dry-run (``launch/{dryrun,steps,specs,mesh}.py``,
``models/shardctx.py``, the configs' input shapes) against the JAX
package's host-side values, and its traceable kernel ops.

Exact: the input shapes and config lists, ``model_flops`` for every (arch
x input shape) (the JAX side from ``repro.models.model.count_params_analytic``
and the rule of ``repro/launch/dryrun.py:47-56``: that module is not
imported here, since it sets ``XLA_FLAGS`` to 512 host devices at import),
and every spec function for every arch x shape x preset on a 1 x 1 mesh
and on a (data 32, model 8) stand-in, against the JAX package's
``PartitionSpec``s as tuples (its ``_drop_indivisible`` reads only
``mesh.axis_names`` and ``mesh.devices.shape``). The port's trees carry a
client axis of 1: a parameter's spec is the JAX spec of the same leaf; a
cache leaf's, the JAX spec without its layer axis. The long-context cache
(``init_cache(long_context=True)``) keeps the JAX package's shapes for
every arch at long_500k, and its reduced ring decodes as the JAX
package's, within ``tests/test_torch_serve.py``'s 1e-5.

The kernel ops K3, K4 and K5 (``torch.ops.repro_torch.*``): on fake CUDA
tensors they return their true shapes and dtypes, build nothing and move
no launch count; their FLOP formulas count what ``chip_smoke.py``'s bounds
count (the (query, key) pairs the mask keeps, brute-forced here; K5's
``mlstm_work``; K3 0); on CPU tensors they give the plain versions' bits.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.launch import specs as JS
from repro.models import model as JM
from repro_torch import configs
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_xent as fx
from repro_torch.kernels import mlstm_chunk as mk
from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import (_visible, attention_bwd_ref, attention_ref,
                                     fused_xent_bwd_ref, fused_xent_ref, mlstm_chunk_ref)
from repro_torch.launch import dryrun, specs, steps
from repro_torch.launch.mesh import Mesh, data_axes, make_host_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import shardctx
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.ASSIGNED_ARCHS
PRESETS = ("baseline", "seqpar", "megatron_sp", "serve_dp", "serve_seq")
MESHES = {"1x1": (1, 1), "32x8": (32, 8)}


def _meshes(name):
    """(the port's mesh, the JAX package's stand-in) of one shape."""
    shape = MESHES[name]
    return (Mesh(("data", "model"), shape),
            types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape)))


def _tup(spec):
    return tuple(spec)


def _jax_by_path(tree, is_leaf=None) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        out[tuple(getattr(p, "key", getattr(p, "name", getattr(p, "idx", None)))
                  for p in path)] = leaf
    return out


def _port_by_path(tree) -> dict:
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _port_specs_by_path(specs_tree, tree) -> dict:
    """{path: spec} of a port tree under its specs."""
    paths = list(_port_by_path(tree))
    return dict(zip(paths, [s for _, s in specs.leaves_with_specs(tree, specs_tree)]))


def _is_p(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.fixture(scope="module")
def shapes():
    """{arch: (JAX params' ShapeDtypeStructs, the port's params on the meta
    device with a client axis)} at full size: nothing is allocated."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch)
        out[arch] = (jax.eval_shape(lambda k, c=jcfg: JM.init(k, c), jax.random.PRNGKey(0)),
                     tree_map(lambda t: t[None], M.init(None, get_config(arch), device="meta")))
    return out


# ---------------------------------------------------------------------------
# configs, model FLOPs, meshes, shardctx
# ---------------------------------------------------------------------------

def test_input_shapes_and_config_lists_equal_jax():
    assert list(INPUT_SHAPES) == list(jconfigs.INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(jconfigs.INPUT_SHAPES[name])
        assert configs.get_input_shape(name) == shape
    assert configs.list_configs() == jconfigs.list_configs()
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert configs.PAPER_MODELS == jconfigs.PAPER_MODELS


def _jax_model_flops(cfg, shape) -> float:
    """``repro/launch/dryrun.py:47-56`` from the JAX package's own count."""
    n = JM.count_params_analytic(cfg.replace(tie_embeddings=False), active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch):
    for name, shape in INPUT_SHAPES.items():
        assert dryrun.model_flops(get_config(arch), shape) == _jax_model_flops(
            jconfigs.get_config(arch), jconfigs.INPUT_SHAPES[name]), name


def test_production_meshes():
    assert make_production_mesh() == Mesh(("data", "model"), (32, 8))
    assert make_production_mesh(8) == Mesh(("data", "model"), (1, 8))
    assert make_production_mesh(4).shape == (1, 4)
    assert make_production_mesh(1) == make_host_mesh() == Mesh(("data", "model"), (1, 1))
    assert make_production_mesh(512).size == 512
    with pytest.raises(ValueError):
        make_production_mesh(12)
    assert data_axes(make_production_mesh()) == ("data",)
    assert make_production_mesh().axis_size("model") == 8


def test_shardctx_places_nothing():
    """A plain tensor passes ``constrain`` unchanged, in a context or not; a
    ``DTensor`` is redistributed to the context's spec (over its trailing
    dimensions, a leading client axis replicated), and left as it is
    without one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import sharded

    x = torch.ones(3)
    assert shardctx.constrain(x, "act") is x
    assert shardctx.get_setting("q_chunk") is None
    with shardctx.activation_sharding(act=("data", None, "model"), q_chunk=512):
        assert shardctx.constrain(x, "act") is x
        assert shardctx.get_setting("q_chunk") == 512
    assert shardctx.get_setting("q_chunk") is None
    with sharded.fake_mesh(Mesh(("data", "model"), (2, 4))) as dmesh, FakeTensorMode():
        d, = sharded.distribute([torch.empty(1, 16, 8, 64, device="meta")],
                                [("data", None, None)], dmesh)
        assert shardctx.constrain(d, "act") is d
        with shardctx.activation_sharding(act=("data", None, "model")):
            y = shardctx.constrain(d, "act")
        assert isinstance(y, DTensor) and tuple(y.placements) == (Shard(1), Shard(3))
        assert tuple(y.to_local().shape) == (1, 8, 8, 16)
        assert tuple(d.placements) == (Shard(1), Replicate())


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_bytes_equal_jax(shapes, arch, mesh_name):
    """Every parameter's spec under every preset, the optimizer state's, and
    the bytes a card holds (each leaf over the product of its spec's axes,
    reckoned from the JAX specs)."""
    jshapes, params = shapes[arch]
    mesh, jmesh = _meshes(mesh_name)
    for preset in PRESETS:
        want = _jax_by_path(JS.tree_pspecs(jshapes, jmesh, preset), is_leaf=_is_p)
        got = _port_specs_by_path(specs.tree_pspecs(params, mesh, preset), params)
        assert got.keys() == want.keys()
        assert all(got[p] == _tup(want[p]) for p in want), preset
    p_specs = specs.tree_pspecs(params, mesh)
    jleaves = _jax_by_path(jshapes)
    jspecs = _jax_by_path(JS.tree_pspecs(jshapes, jmesh), is_leaf=_is_p)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    want_bytes = 0
    for path, leaf in jleaves.items():
        n = 1
        for ax in jspecs[path]:
            for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
        want_bytes += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // n
    assert specs.bytes_per_device(params, p_specs, mesh) == want_bytes
    opt = {"lr": 1e-3, "t": torch.zeros((1,), dtype=torch.int32), "m": params, "v": params}
    jopt = JS.opt_state_pspecs({"lr": 0, "t": 0, "m": 0, "v": 0}, "P")
    assert specs.opt_state_pspecs(opt, p_specs) == {
        k: (p_specs if v == "P" else _tup(v)) for k, v in jopt.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_activation_and_cache_specs_equal_jax(arch, mesh_name):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    mesh, jmesh = _meshes(mesh_name)
    for name, shape in INPUT_SHAPES.items():
        jshape = jconfigs.INPUT_SHAPES[name]
        assert specs.batch_pspecs(cfg, shape, mesh) == {
            k: _tup(v) for k, v in JS.batch_pspecs(jcfg, jshape, jmesh).items()}
        for preset in PRESETS:
            want = JS.activation_pspecs(jcfg, jshape, jmesh, preset)
            assert specs.activation_pspecs(cfg, shape, mesh, preset) == {
                k: _tup(v) if _is_p(v) else v for k, v in want.items()}, (name, preset)
        if shape.kind != "decode":
            continue
        long = shape.seq_len > 100_000
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, jshape.global_batch,
                                                      jshape.seq_len, long_context=long))
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, long_context=long,
                             device="meta")
        for preset in PRESETS:
            want = _jax_by_path(JS.cache_pspecs(jcache, jshape, jmesh, preset), is_leaf=_is_p)
            got = _port_specs_by_path(specs.cache_pspecs(cache, shape, mesh, preset), cache)
            assert got[("pos",)] == _tup(want[("pos",)]) == ()
            for path, spec in got.items():
                if path[0] == "layers":
                    # the JAX cache stacks every layer; an xLSTM layer's
                    # holds both cells, the port's the one it runs
                    assert spec == _tup(want[("layers",) + path[2:]])[1:], (name, preset, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_long_context_cache_shapes_equal_jax(arch):
    """``input_specs`` at every shape: the JAX package's shapes behind the
    client axis; the decode caches' leaves (long_500k: the
    ``serve_window`` ring) per layer as the JAX package's stacked ones."""
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        got = specs.input_specs(cfg, shape)
        want = JS.input_specs(jcfg, jconfigs.INPUT_SHAPES[name])
        assert got.keys() == want.keys()
        if shape.kind != "decode":
            for k in want:
                assert tuple(got[k].shape) == (1,) + tuple(want[k].shape)
                assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
            continue
        assert tuple(got["token"].shape) == (1,) + tuple(want["token"].shape)
        jl = _jax_by_path(want["cache"]["layers"])
        assert len(got["cache"]["layers"]) == cfg.n_layers
        for i, layer in enumerate(got["cache"]["layers"]):
            for path, leaf in _port_by_path(layer).items():
                assert leaf.shape[1:] == jl[path].shape[1:], (name, i, path)
                assert str(leaf.dtype).removeprefix("torch.") == str(jl[path].dtype)
        if name == "long_500k" and cfg.serve_window:
            assert M._attn_cache_len(got["cache"]) == min(cfg.serve_window, shape.seq_len)


def test_long_context_ring_decode_matches_jax():
    """The reduced smollm-360m's long_500k cache, a ring of its
    ``serve_window`` (64 reduced), over 80 steps (it wraps): the logits of
    every step within 1e-5 of the JAX package's ``decode_step``."""
    cfg = get_config("smollm-360m").reduced().replace(dtype="float32")
    jcfg = jconfigs.get_config("smollm-360m").reduced().replace(dtype="float32")
    B, steps_n, S = 2, 80, INPUT_SHAPES["long_500k"].seq_len
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, steps_n)).astype(np.int32)
    jcache = JM.init_cache(jcfg, B, S, long_context=True)
    assert jcache["layers"]["k"].shape[2] == cfg.serve_window == 64
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a))[None], jax.tree.map(np.asarray, params))
    cache = M.init_cache(cfg, B, S, long_context=True)
    with torch.no_grad():
        for t in range(steps_n):
            want, jcache = step(params, jax.numpy.asarray(tokens[:, t]), jcache)
            got, cache = M.decode_step(tp, cfg, torch.from_numpy(tokens[None, :, t]), cache)
            want = np.asarray(want)
            np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"step {t}")


# ---------------------------------------------------------------------------
# the kernels as traceable ops
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    """Building or loading a kernel raises; the launch counts are checked
    unmoved after the test."""
    def refuse(name):
        raise AssertionError(f"a fake trace built {name}")

    monkeypatch.setattr(nvcc, "build", refuse)
    counts = [dict(m.LAUNCHES) for m in (fa, fx, mk)]
    shapes = [(len(m.SHAPES), len(m.BACKWARD_SHAPES)) for m in (fa, fx, mk)]
    yield
    assert [dict(m.LAUNCHES) for m in (fa, fx, mk)] == counts
    assert [(len(m.SHAPES), len(m.BACKWARD_SHAPES)) for m in (fa, fx, mk)] == shapes


def _pairs(N, Sq, Sk, H, causal, window) -> int:
    """chip_smoke.py's count before the formulas: the mask's kept pairs."""
    return N * H * int(_visible(Sq, Sk, causal, window, "cpu").sum())


@pytest.mark.parametrize("causal,window,Sk", [(True, 0, 96), (True, 16, 96), (False, 0, 40),
                                              (False, 24, 96)])
def test_k4_ops_on_fake_cuda_tensors(no_build, causal, window, Sk):
    N, S, H, KV, hd = 2, 96, 6, 2, 32
    with FakeTensorMode():
        q = torch.empty(N, S, H, hd, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(N, Sk, KV, hd, device="cuda", dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as counter:
            o, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, k, causal, window)
            grads = torch.ops.repro_torch.flash_attention_bwd(q, k, k, o, lse, o, causal, window)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, torch.bfloat16, "cuda")
    assert (lse.shape, lse.dtype) == ((N, H, S), torch.float32)
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    pairs = _pairs(N, S, Sk, H, causal, window)
    assert fa.attention_pairs(N, S, Sk, H, causal, window) == pairs
    counts = counter.get_flop_counts()["Global"]
    assert counts[torch.ops.repro_torch.flash_attention_fwd] == 4 * pairs * hd
    assert counts[torch.ops.repro_torch.flash_attention_bwd] == 10 * pairs * hd


def test_k3_and_k5_ops_on_fake_cuda_tensors(no_build):
    with FakeTensorMode():
        logits = torch.empty(50, 77, device="cuda", dtype=torch.bfloat16)
        labels = torch.empty(50, device="cuda", dtype=torch.int64)
        ins = [torch.empty(6, 300, 40, device="cuda") for _ in range(3)]
        gates = [torch.empty(6, 300, device="cuda") for _ in range(2)]
        with FlopCounterMode(display=False) as counter:
            loss, lse = torch.ops.repro_torch.fused_xent_fwd(logits, labels)
            dlogits = torch.ops.repro_torch.fused_xent_bwd(logits, labels, lse, loss)
            h, *saved = torch.ops.repro_torch.mlstm_chunk_fwd(*ins, *gates)
            grads = torch.ops.repro_torch.mlstm_chunk_bwd(*ins, *gates, h, *saved, h)
    assert (loss.shape, loss.dtype, lse.shape) == ((50,), torch.float32, (50,))
    assert (dlogits.shape, dlogits.dtype) == (logits.shape, torch.bfloat16)
    assert (h.shape, h.dtype, h.device.type) == ((6, 300, 40), torch.float32, "cuda")
    assert [s.shape for s in saved[4:6]] == [(6, 1, 40, 40), (6, 1, 40)]  # C, n a chunk boundary
    assert [g.shape for g in grads] == [t.shape for t in ins + gates]
    counts = counter.get_flop_counts()["Global"]
    fwd, _, bwd, _ = mk.mlstm_work(6, 300, 40)
    assert counts.get(torch.ops.repro_torch.fused_xent_fwd, 0) == 0
    assert counts[torch.ops.repro_torch.mlstm_chunk_fwd] == int(fwd)
    assert counts[torch.ops.repro_torch.mlstm_chunk_bwd] == int(bwd)


def test_k5_work_is_the_bound_of_the_perf_table():
    """``mlstm_work`` at the xLSTM path's (48, 512, 512): the 19.40 and 38.78
    GFLOP of PERF.md's K5 rows (their bound's operations)."""
    fwd, _, bwd, _ = mk.mlstm_work(48, 512, 512)
    assert round(fwd / 1e9, 2) == 19.40 and round(bwd / 1e9, 2) == 38.78


def test_autograd_through_the_ops_on_fake_meta_tensors(no_build):
    """Where this torch has no CUDA, the dry-run's backward traces on fake
    meta tensors (``steps.trace_device``); the wrappers take those to the
    ops too, and autograd reaches the backward ops and their formulas."""
    assert steps.trace_device() in ("cuda", "meta")
    N, S, H, KV, hd = 2, 64, 4, 2, 16
    with FakeTensorMode():
        q = torch.empty(N, S, H, hd, device="meta", requires_grad=True)
        k = torch.empty(N, S, KV, hd, device="meta", requires_grad=True)
        logits = torch.empty(N * S, 33, device="meta", requires_grad=True)
        with FlopCounterMode(display=False) as counter:
            fa.flash_attention(q, k, k).sum().backward()
            fx.fused_xent(logits, torch.zeros(N * S, dtype=torch.int64, device="meta")
                          ).sum().backward()
        assert q.grad.shape == q.shape and logits.grad.shape == logits.shape
    pairs = _pairs(N, S, S, H, True, 0)
    assert counter.get_total_flops() == 14 * pairs * hd


def test_plain_meta_tensors_still_raise():
    q = torch.zeros(2, 8, 4, 16, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])


def test_ops_on_cpu_tensors_are_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 6, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 40, 2, 16, generator=g, requires_grad=True)
    o = fa.flash_attention(q, k, k, causal=True, window=9)
    do = torch.randn_like(o)
    o.backward(do)
    want, lse = attention_ref(q.detach(), k.detach(), k.detach(), causal=True, window=9)
    assert torch.equal(o, want)
    dq, dk, dv = attention_bwd_ref(q.detach(), k.detach(), k.detach(), want, lse, do,
                                   causal=True, window=9)
    assert torch.equal(q.grad, dq) and torch.equal(k.grad, dk + dv)
    logits = torch.randn(30, 11, generator=g, requires_grad=True)
    labels = torch.randint(0, 11, (30,), generator=g)
    loss = fx.fused_xent(logits, labels)
    gl = torch.randn(30, generator=g)
    loss.backward(gl)
    want, lse = fused_xent_ref(logits.detach(), labels)
    assert torch.equal(loss, want)
    assert torch.equal(logits.grad, fused_xent_bwd_ref(logits.detach(), labels, lse, gl))
    ins = [torch.randn(3, 50, 8, generator=g) for _ in range(3)] + [
        torch.randn(3, 50, generator=g) for _ in range(2)]
    assert torch.equal(mk.mlstm_chunk(*ins), mlstm_chunk_ref(*ins))


# ---------------------------------------------------------------------------
# the dry-run: records and the CLI
# ---------------------------------------------------------------------------

def test_one_card_record_reckons_the_trace(tmp_path, monkeypatch):
    """At one card the record's arguments are the traced arguments' bytes,
    its peak the traced peak; its FLOPs the trace's count; the JSON record
    lands in OUT_DIR with every field."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    cfg = get_config("smollm-360m").reduced()
    rec = dryrun.run_one("smollm-360m", "prefill_32k", devices=1, cfg=cfg, verbose=False)
    built = steps.build_prefill(cfg, INPUT_SHAPES["prefill_32k"], make_host_mesh())
    traced = dryrun.trace_step(built, make_host_mesh())
    mem = rec["memory"]
    assert mem["argument_bytes"] == traced["held_bytes"] == sum(
        t.numel() * t.element_size() for t in tree_leaves(built["args"]))
    assert mem["peak_bytes"] == traced["peak_bytes"]
    assert rec["flops_per_device"] == traced["flops"] > 0
    assert mem["output_bytes"] == 32 * cfg.vocab * 2
    assert rec["useful_flops_ratio"] == rec["model_flops_total"] / rec["flops_per_device"]
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    saved = json.loads((tmp_path / "smollm-360m_prefill_32k_d1.json").read_text())
    assert saved == json.loads(json.dumps(rec))


def test_cli_traces_smollm_train_4k_on_this_host():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "smollm-360m", "--shape", "train_4k", "--no-save"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("[dryrun] smollm-360m"))
    assert "train_4k" in line and "mesh=data32xmodel8" in line
    assert "all 1 combination(s) traced OK" in out.stdout


def test_fake_trace_reads_the_slstm_flags_of_each_half(monkeypatch):
    """A fake trace has no flag values: each half's flags come from the
    config at the half's first layer (a server half is the model's tail),
    so the halves' forwards run the cells a real split runs, also where a
    half is a copy rather than a view into the whole model's leaves."""
    from repro_torch.models import transformer as tfm

    cfg = get_config("xlstm-350m").reduced().replace(n_layers=5, slstm_every=3, n_modules=3,
                                                     tie_embeddings=False)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=16, global_batch=2)
    cells = []
    apply = tfm.ssm_block_apply
    monkeypatch.setattr(tfm, "ssm_block_apply",
                        lambda x, bp, c, slstm: cells.append(slstm) or apply(x, bp, c, slstm))

    def halves(device=None, copy=False):
        built = steps.build_dtfl_train(cfg, shape, make_host_mesh(), tier=1, device=device)
        state, batch = built["args"]
        cells.clear()
        with built["mode"] or contextlib.nullcontext():
            server = state.server_params
            if copy:
                server = tree_map(torch.clone, server)
                assert server["blocks"]["is_slstm"].storage_offset() == 0
            z, _ = M.client_forward(state.client_params, cfg, batch)
            M.server_forward(server, cfg, z)
        return list(cells)

    want = [tfm.is_slstm_layer(cfg, i) for i in range(cfg.n_layers)]
    assert want == [False, False, True, False, False]
    assert halves() == halves(copy=True) == halves(device="cpu") == want
    with FakeTensorMode(), pytest.raises(ValueError, match="exceeds"):
        tfm.slstm_flags({"mlstm": {"ln": torch.zeros(1, 3)}, "is_slstm": torch.zeros(1, 3)},
                        cfg, first_layer=3)
