"""The MoE family in the dry-run's sharded trace against the JAX package's
``hlo_analysis`` (``tests/jax_hlo_collectives.py``, a process of its own
with 8 host devices), on a (data 2, model 4) mesh, in fp32.

One ``moe_apply`` layer of the reduced deepseek-moe-16b (4 experts, top-2,
2 shared experts) on 16 x 64 tokens in the ``act`` layout: per card, the
FLOPs within 5% of the JAX package's, an all-to-all on the model axis
within 2x of the JAX package's all-to-all bytes (GSPMD's move of the
expert queues onto the experts' split, ``repro/models/moe.py:85-89``),
and each card's expert products over its E / 4 experts, the weights
gathered over their FSDP split only.

Whole steps of the reduced deepseek-moe-16b and llama4-scout (top-1) at a
DTFL train step (tier 1), prefill and decode, held as
``test_torch_dryrun_collectives_steps.py`` holds the dense family's; their
train and prefill steps have an all-to-all on the model axis.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch import sharded
from repro_torch.launch import specs as S
from repro_torch.models import moe
from repro_torch.models.shardctx import activation_sharding
from repro_torch.tree import tree_map_with_path
from test_torch_dryrun_collectives import MESH
from test_torch_dryrun_collectives_steps import (CONFIGS, assert_bytes_within_ratio,
                                                 assert_flops_against_jax, both_sides)

torch.set_num_threads(2)
MOE = dict(B=16, S=64)  # tests/jax_hlo_collectives.py's MOE
CASES = ["dsmoe-train", "dsmoe-prefill", "dsmoe-decode", "scout-train", "scout-prefill",
         "scout-decode"]
ACT = ("data", None, "model")


@pytest.fixture(scope="module")
def sides():
    return both_sides(CASES, "moe")


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[0]


@pytest.fixture(scope="module")
def port_side(sides):
    return sides[1]


def moe_config():
    arch, upd = CONFIGS["dsmoe"]
    return get_config(arch).reduced().replace(**upd)


def port_moe_layer(monkeypatch) -> tuple:
    """The port's ``moe_apply`` on rank 0 of the (2, 4) mesh: its counts,
    and the local shapes of the expert queues and of the expert weights
    the products take."""
    cfg = moe_config()
    seen = {"queues": [], "weights": []}

    def on_experts(xe, w, dim):
        q = sharded_on(xe, w, dim)
        seen["queues"].append(tuple(q.to_local().shape))
        return q

    def gather_fsdp(w, x, dim):
        g = gathered(w, x, dim)
        seen["weights"].append(tuple(g.to_local().shape))
        return g

    sharded_on, gathered = moe.on_experts, moe.gather_fsdp
    monkeypatch.setattr(moe, "on_experts", on_experts)
    monkeypatch.setattr(moe, "gather_fsdp", gather_fsdp)
    mode = FakeTensorMode()
    with sharded.fake_mesh(MESH) as dmesh:
        with mode:
            params = moe.moe_param_init(None, cfg, lead=(1,), device="meta")
            # the specs of one layer of a stack: a layer axis given, then dropped
            specs = tree_map_with_path(
                lambda path, t: S.param_pspec(path, (1,) + tuple(t.shape[1:]))[1:], params)
            x = torch.empty(1, MOE["B"], MOE["S"], cfg.d_model, device="meta")
            x, params = sharded.distribute([x, params], [ACT, specs], dmesh)
        with mode, implicit_replication(), sharded.unwatched_propagation(), \
                activation_sharding(act=ACT), sharded.Counts(dmesh) as counts:
            out, aux = moe.moe_apply(x, params, cfg)
            assert tuple(out.placements) == tuple(x.placements)
    return counts, seen


def test_moe_layer_places_experts_on_the_model_axis(jax_side, monkeypatch):
    counts, seen = port_moe_layer(monkeypatch)
    want = jax_side["moe"]
    assert counts.flops == pytest.approx(want["flops"], rel=0.05)
    got = counts.by_axis["model"].get("all-to-all", 0)
    assert "all-to-all" not in counts.by_axis.get("data", {})
    assert 0.5 <= got / want["coll"]["all-to-all"] <= 2.0
    cfg = moe_config()
    local = cfg.n_experts // MESH.axis_size("model")
    # the queues (C, G, E, cap, d) and we1, we3 (C, E, d, f), we2 (C, E, f,
    # d): E / 4 experts each, d and f whole
    assert seen["queues"] and all(q[2] == local for q in seen["queues"])
    assert sorted(seen["weights"]) == sorted([(1, local, cfg.d_model, cfg.d_ff)] * 2
                                             + [(1, local, cfg.d_ff, cfg.d_model)])


@pytest.mark.parametrize("case", CASES)
def test_moe_step_collective_bytes_within_ratio_of_jax(jax_side, port_side, case):
    assert_bytes_within_ratio(port_side[case], jax_side[case])
    if not case.endswith("decode"):
        assert port_side[case]["by_axis"]["model"].get("all-to-all", 0) > 0


@pytest.mark.parametrize("case", CASES)
def test_moe_step_flops_per_card_against_jax(jax_side, port_side, case):
    assert_flops_against_jax(port_side[case], jax_side[case], case)
