"""The sharded program the dry-run traces computes the plain one, and
every preset of the dense family traces.

Four spawned ranks on a gloo group (``tests/torch_dtensor_ranks.py``, a
(data 2, model 2) CPU mesh, real collectives) run on ``DTensor``s: K3
over logits split over their rows and their vocab (fp32 and bf16; the
plain versions on each rank's shard), and over rows split over both
axes with the vocab whole (the ops' own sharding rules); K4 with the
batch and the heads split (KV 1 repeated to the 4 heads); and a reduced
dense model (4 heads over 1 KV head, vocab split) through its DTFL train
step, prefill, decode, and decode under serve_seq (the cache split over
its window); and a reduced MoE model (2 experts over the model axis, each
token to both) through its train step and prefill.
Each result, gathered, is held to the same call on plain tensors within
5e-5 of the plain result's largest magnitude (at least 1): the sums run
in another order, and Adam's first step turns a gradient's last bits
into up to 2 lr where the gradient is near 0.

Then every ``--preset`` of the JAX CLI traces for a reduced yi-6b (2 KV
heads) on 8 cards at each input kind, as ``scripts/dryrun_all.sh`` runs
the full sizes: its collectives are counted and its term is in the
roofline.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dtensor_ranks
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun

torch.set_num_threads(2)
TOL = 5e-5


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dtensor_ranks")
    mp.spawn(torch_dtensor_ranks.check_rank, args=(4, str(d / "store"), str(d / "out.npz")),
             nprocs=4)
    return dict(np.load(d / "out.npz"))


GROUPS = ["xent_float32", "xent_bfloat16", "xent_rows", "attn", "train", "prefill", "decode",
          "decode_seq", "moe_train", "moe_prefill"]


@pytest.mark.parametrize("group", GROUPS)
def test_sharded_program_computes_the_plain_one(four_ranks, group):
    keys = [k for k in four_ranks if k == group or k.startswith(group + "_")
            and not (group == "decode" and k.startswith("decode_seq"))]
    assert keys
    for k in keys:
        got, want = four_ranks[k]
        assert got.shape == want.shape and np.isfinite(got).all()
        bound = TOL * max(float(np.max(np.abs(want), initial=0.0)), 1.0)
        assert float(np.max(np.abs(got - want), initial=0.0)) <= bound, k


PRESET_CASES = [("train_4k", None, p) for p in ("baseline", "seqpar", "megatron_sp")] + [
    ("train_4k", "full", "baseline"), ("prefill_32k", None, "baseline")] + [
    (s, None, p) for s in ("decode_32k", "long_500k")
    for p in ("baseline", "seqpar", "megatron_sp", "serve_dp", "serve_seq")]


@pytest.mark.parametrize("shape_name,step,preset", PRESET_CASES)
def test_every_preset_traces_on_eight_cards(monkeypatch, shape_name, step, preset):
    shape = INPUT_SHAPES[shape_name]
    monkeypatch.setitem(dryrun.INPUT_SHAPES, shape_name, dataclasses.replace(
        shape, seq_len=min(shape.seq_len, 128), global_batch=min(shape.global_batch, 16)))
    cfg = get_config("yi-6b").reduced().replace(n_heads=8, n_kv_heads=2, head_dim=16)
    tier = 1 if shape.kind == "train" and step is None else None
    rec = dryrun.run_one("yi-6b", shape_name, devices=8, step=step, save=False, verbose=False,
                         preset=preset, cfg=cfg, tier=tier)
    assert rec["mesh"] == "data1xmodel8" and rec["preset"] == preset
    assert rec["collective_bytes"] > 0 and rec["roofline"]["collective_s"] > 0
    assert rec["flops_per_device"] > 0 and rec["memory"]["temp_bytes"] > 0
