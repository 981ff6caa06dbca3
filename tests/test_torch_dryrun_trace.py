"""Every assigned arch traces its four dry-run steps (``launch/dryrun.py``)
at ``reduced()`` size on this host: fake tensors (on the meta device where
this torch has no CUDA), the default 256-card mesh, the one tier a reduced
config has. hymba-1.5b, whose Mamba scan takes the longest to trace, is in
``test_torch_dryrun_trace_hybrid.py`` and ``_hybrid_prefill.py`` (files of
their own, so that test workers share it)."""
import math

import pytest

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_xent as fx
from repro_torch.kernels import mlstm_chunk as mk
from repro_torch.kernels import nvcc
from repro_torch.launch import dryrun


def trace_every_shape(arch, monkeypatch, shapes=tuple(INPUT_SHAPES)):
    """Trace ``arch``'s steps at ``shapes``; every record reckons finite positive
    bytes and roofline terms, its model FLOPs are ``model_flops``'; nothing
    is built and no launch count moves."""
    def refuse(name):
        raise AssertionError(f"a fake trace built {name}")

    monkeypatch.setattr(nvcc, "build", refuse)
    counts = [dict(m.LAUNCHES) for m in (fa, fx, mk)]
    cfg = get_config(arch).reduced()
    for name in shapes:
        shape = INPUT_SHAPES[name]
        rec = dryrun.run_one(arch, name, cfg=cfg, tier=1, save=False, verbose=False)
        mem = rec["memory"]
        assert (rec["arch"], rec["shape"], rec["n_devices"]) == (arch, name, 256)
        assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0 and mem["temp_bytes"] >= 0
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert rec["model_flops_total"] == dryrun.model_flops(cfg, shape)
        assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
        assert math.isfinite(rec["useful_flops_ratio"]) and rec["useful_flops_ratio"] > 0
        assert rec["tier"] == (1 if shape.kind == "train" else None)
        assert rec["local_batch"] == (max(1, shape.global_batch // 32)
                                      if shape.global_batch >= 16 else shape.global_batch)
    assert [dict(m.LAUNCHES) for m in (fa, fx, mk)] == counts


@pytest.mark.parametrize("arch", [a for a in ASSIGNED_ARCHS if a != "hymba-1.5b"])
def test_reduced_arch_traces_every_input_shape(arch, monkeypatch):
    trace_every_shape(arch, monkeypatch)
