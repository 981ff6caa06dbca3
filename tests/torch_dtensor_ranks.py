"""Rank entry of ``tests/test_torch_dryrun_collectives.py``'s four-rank run.

The ranks are spawned processes, which import this module again; so it
imports ``torch`` and ``repro_torch`` only, never JAX. Each rank joins a
gloo group on a ``FileStore`` and a (data 2, model 2) CPU mesh, and runs
on ``DTensor``s what the dry-run's sharded trace runs on fake ones: K3
with the vocab and the rows split (and the rows alone), K4 with the batch and the heads split,
a reduced dense model's DTFL train step, prefill and decode (under
the baseline specs, and decode under serve_seq too), and a reduced MoE
model's train step and prefill (its experts over the model axis), with
real collectives. Rank 0 writes each result beside the same call on plain
tensors, as numpy arrays, to ``out_path``.
"""
import numpy as np
import torch
import torch.distributed as dist

MESH = (2, 2)


def dense_config():
    """A dense model whose KV heads (1) do not divide the model axis, and
    whose vocab does."""
    from repro_torch.configs import get_config

    return get_config("yi-6b").reduced().replace(
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=256,
        dtype="float32")


def moe_config():
    """An MoE model whose 2 experts split over the model axis, each token
    routed to both (top-2: no choice between near-equal probabilities for
    the sums' order to flip), and whose 1,024 tokens make 2 groups, one
    a data card."""
    from repro_torch.configs import get_config

    return get_config("deepseek-moe-16b").reduced().replace(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=64, d_ff_shared=64, vocab=256,
        n_experts=2, top_k=2, dtype="float32")


def check_rank(rank: int, world: int, store_path: str, out_path: str) -> None:
    from repro_torch.launch.sharded import ensure_index_copy_rule

    torch.set_num_threads(1)
    ensure_index_copy_rule()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = _check(rank)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def _dt(t, mesh, spec):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import placements

    return distribute_tensor(t, mesh, placements(spec, t.ndim, mesh))


def _tree(tree, specs, mesh):
    from repro_torch.launch import specs as S
    from repro_torch.tree import tree_unflatten

    return tree_unflatten(tree, [_dt(leaf, mesh, spec) if torch.is_tensor(leaf) else leaf
                                 for leaf, spec in S.leaves_with_specs(tree, specs)])


def _full(tree) -> list:
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    return [(t.full_tensor() if isinstance(t, DTensor) else t).detach().float().numpy()
            for t in tree_leaves(tree) if torch.is_tensor(t)]


def _check(rank: int) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import InputShape
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_xent import fused_xent
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import repeat_kv
    from repro_torch.models.shardctx import activation_sharding

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(MESH), mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)
    out = {}

    # K3: rows over data, the vocab over model (its all-reduces), and rows
    # over both with the vocab whole (the ops' sharding rules)
    for dtype, spec, name in ((torch.float32, ("data", "model"), "float32"),
                              (torch.bfloat16, ("data", "model"), "bfloat16"),
                              (torch.float32, (("data", "model"), None), "rows")):
        logits = (3 * torch.randn(8, 12, generator=gen)).to(dtype).requires_grad_()
        labels = torch.randint(0, 12, (8,), generator=gen)
        g = torch.randn(8, generator=gen)
        dl = _dt(logits.detach(), mesh, spec).requires_grad_()
        loss = fused_xent(dl, _dt(labels, mesh, spec[:1]))
        loss.backward(_dt(g, mesh, spec[:1]))
        ref = fused_xent(logits, labels)
        ref.backward(g)
        out[f"xent_{name}"] = np.stack([loss.full_tensor().detach().numpy(),
                                        ref.detach().numpy()])
        out[f"xent_grad_{name}"] = np.stack([dl.grad.full_tensor().float().numpy(),
                                             logits.grad.float().numpy()])

    # K4: batch over data, heads over model (k, v repeated to H)
    q = torch.randn(4, 16, 4, 8, generator=gen, requires_grad=True)
    k = torch.randn(4, 16, 1, 8, generator=gen, requires_grad=True)
    v = torch.randn(4, 16, 1, 8, generator=gen, requires_grad=True)
    do = torch.randn(4, 16, 4, 8, generator=gen)
    spec = ("data", None, "model", None)
    dq, dk, dv = (_dt(t.detach(), mesh, spec if t is q else ("data", None, None, None))
                  .requires_grad_() for t in (q, k, v))
    o = flash_attention(dq, repeat_kv(dk, 4), repeat_kv(dv, 4), causal=True)
    o.backward(_dt(do, mesh, spec))
    ref = flash_attention(q, k, v, causal=True)
    ref.backward(do)
    out["attn"] = np.stack([o.full_tensor().detach().numpy(), ref.detach().numpy()])
    for name, a, b in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        out[f"attn_{name}"] = np.stack([a.grad.full_tensor().numpy(), b.grad.numpy()])

    # a dense model's steps, sharded and plain
    cfg = dense_config()
    pmesh = Mesh(("data", "model"), MESH)
    cases = [("train", InputShape("train", 16, 16, "train"), "baseline"),
             ("prefill", InputShape("prefill", 16, 16, "prefill"), "baseline"),
             ("decode", InputShape("decode", 16, 16, "decode"), "baseline"),
             ("decode_seq", InputShape("decode", 16, 16, "decode"), "serve_seq")]
    # an MoE model's (the experts over model, the queues' all-to-alls)
    cases += [("moe_train", InputShape("train", 64, 16, "train"), "baseline"),
              ("moe_prefill", InputShape("prefill", 64, 16, "prefill"), "baseline")]
    for name, shape, preset in cases:
        cfg = moe_config() if name.startswith("moe") else cfg
        builder = steps.builder_for(shape)
        kw = {"tier": 1} if shape.kind == "train" else {}
        if preset != "baseline":
            kw["preset"] = preset
        plain = builder(cfg, shape, pmesh, device="cpu", **kw)
        sharded = builder(cfg, shape, pmesh, device="cpu", **kw)
        args = _tree(sharded["args"], sharded["in_specs"], mesh)
        with implicit_replication(), activation_sharding(**sharded["act_specs"]):
            got = _full(sharded["fn"](*args))
        want = _full(plain["fn"](*plain["args"]))
        for i, (a, b) in enumerate(zip(got, want)):
            out[f"{name}_{i}"] = np.stack([a, b])
    return out
