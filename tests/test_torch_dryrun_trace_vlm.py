"""pixtral-12b's two train steps in the dry-run at its own head dim, 160, as
``test_torch_dryrun_trace.py`` traces every arch at ``reduced()`` size
(head dim 32 there): the DTFL tier step and the full step at train_4k, on
fake tensors, through K4's backward at hd 160 (its fake body and FLOP
formula). Each record is held as that file holds its records, to
``model_flops`` among them; nothing is built and no launch count moves.
Then one trace at the card's local batch counts K4's backward op: its
FLOPs are the formula's (``backward_flops``), once a layer."""
import dataclasses
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_xent as fx
from repro_torch.kernels import mlstm_chunk as mk
from repro_torch.kernels import nvcc
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_host_mesh

ARCH = "pixtral-12b"


@pytest.mark.parametrize("step", ["train", "full"])
def test_pixtral_train_steps_trace_at_head_dim_160(step, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a fake trace built {name}")

    monkeypatch.setattr(nvcc, "build", refuse)
    counts = [dict(m.LAUNCHES) for m in (fa, fx, mk)]
    cfg = get_config(ARCH).reduced().replace(head_dim=160)
    shape = INPUT_SHAPES["train_4k"]
    rec = dryrun.run_one(ARCH, "train_4k", cfg=cfg, tier=1, step=step, save=False,
                         verbose=False)
    mem = rec["memory"]
    assert (rec["arch"], rec["step"], rec["n_devices"]) == (ARCH, step, 256)
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0 and mem["temp_bytes"] >= 0
    assert rec["model_flops_total"] == dryrun.model_flops(cfg, shape)
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert math.isfinite(rec["useful_flops_ratio"]) and rec["useful_flops_ratio"] > 0
    assert rec["tier"] == (1 if step == "train" else None) and rec["local_batch"] == 8

    # one card's batch of 8: K4's backward once a layer (the DTFL step's
    # client and server halves hold one layer each), at hd 160
    cut = dataclasses.replace(shape, global_batch=rec["local_batch"])
    kw = {"tier": 1} if step == "train" else {}
    built = steps.builder_for(cut, step)(cfg, cut, make_host_mesh(), **kw)
    with built["mode"], FlopCounterMode(display=False) as counter:
        built["fn"](*built["args"])
    got = counter.get_flop_counts()["Global"][torch.ops.repro_torch.flash_attention_bwd]
    assert got == cfg.n_layers * fa.backward_flops(8, shape.seq_len, shape.seq_len,
                                                    cfg.n_heads, 160, True, 0)
    assert [dict(m.LAUNCHES) for m in (fa, fx, mk)] == counts
