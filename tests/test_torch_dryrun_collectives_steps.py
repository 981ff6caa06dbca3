"""Whole steps of the dry-run's sharded trace against the JAX package's
``hlo_analysis`` (``tests/jax_hlo_collectives.py``, a process of its own
with 8 host devices): reduced SmolLM-360M and a reduced yi-6b whose 2 KV
heads do not divide the model axis, on a (data 2, model 4) mesh, at a
DTFL train step (tier 1), prefill and decode, 16 sequences of 64 tokens,
in fp32 (XLA's CPU backend runs bf16 products and their collectives in
fp32 anyway).

The partitioners differ, so the bytes are held within a ratio, not
equal: the JAX package's total collective bytes are within 2x of the
port's, either way, once the port's reduce-scatters are counted in the
form XLA's CPU backend gives them (an all-reduce of the whole result and
a slice, 2 x the axis's cards x the reduce-scatter's bytes under
``hlo_analysis``'s weights). ``PERF.md`` names the op behind each kind's
difference. Per-card FLOPs: prefill and decode within 5% of the JAX
package's; a train step's between 0.75 and 1.0 of them, since the JAX
package's layer scan recomputes each layer's forward in the backward
(``jax.checkpoint``) and the port's step does not.
"""
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, steps
from test_torch_dryrun_collectives import MESH, jax_hlo, start_jax_hlo

torch.set_num_threads(2)
# tests/jax_hlo_collectives.py's CONFIGS, SHAPES and TIER
CONFIGS = {
    "smollm": ("smollm-360m", {"dtype": "float32"}),
    "yi": ("yi-6b", {"n_heads": 8, "n_kv_heads": 2, "head_dim": 16, "dtype": "float32"}),
    "dsmoe": ("deepseek-moe-16b", {"dtype": "float32"}),
    "scout": ("llama4-scout-17b-a16e", {"dtype": "float32"}),
    "pixtral": ("pixtral-12b", {"dtype": "float32"}),
    "whisper": ("whisper-base", {"dtype": "float32"}),
    "hymba": ("hymba-1.5b", {"dtype": "float32"}),
}
SHAPES = {kind: InputShape(kind, 64, 16, kind) for kind in ("train", "prefill", "decode")}
# the dense family's cases (the other families' are in ``_moe.py`` and ``_families.py``)
CASES = [f"{m}-{k}" for m in ("smollm", "yi") for k in SHAPES]
RATIO = 2.0


def both_sides(cases, *extra) -> tuple[dict, dict]:
    """(the JAX package's analysis of ``cases`` and of ``extra``, the port's
    traces of ``cases``): the JAX process runs while the port traces."""
    jax_side = start_jax_hlo(*extra, *cases)
    port = {case: port_trace(case) for case in cases}
    return jax_side(), port


@pytest.fixture(scope="module")
def sides():
    return both_sides(CASES)


@pytest.fixture(scope="module")
def jax_steps(sides):
    return sides[0]


def port_trace(case: str) -> dict:
    """The port's sharded trace of one case, rank 0 of the (2, 4) mesh."""
    model, kind = case.split("-")
    arch, upd = CONFIGS[model]
    cfg = get_config(arch).reduced().replace(**upd)
    kw = {"tier": 1} if kind == "train" else {}
    return dryrun.trace_sharded(steps.builder_for(SHAPES[kind])(cfg, SHAPES[kind], MESH, **kw),
                                MESH)


@pytest.fixture(scope="module")
def port_steps(sides):
    return sides[1]


def xla_cpu_form(by_axis: dict) -> float:
    """The port's collective bytes with each reduce-scatter counted as XLA's
    CPU backend emits it: an all-reduce of the whole result, then a slice."""
    return sum(n * (2 * MESH.axis_size(axis) if kind == "reduce-scatter" else 1)
               for axis, kinds in by_axis.items() for kind, n in kinds.items())


def assert_bytes_within_ratio(got: dict, jax_case: dict) -> None:
    """The JAX package's collective bytes within RATIO of the port's trace
    ``got``, either way, in XLA's CPU form, on both mesh axes."""
    want = sum(jax_case["coll"].values())
    assert set(got["by_axis"]) == {"data", "model"}
    assert sum(got["collectives"].values()) > 0 and want > 0
    assert 1 / RATIO <= want / xla_cpu_form(got["by_axis"]) <= RATIO


def assert_flops_against_jax(got: dict, jax_case: dict, case: str) -> None:
    """Per-card FLOPs: a train step's 0.75 to 1.0 of the JAX package's, the
    others' within 5%."""
    ratio = got["flops"] / jax_case["flops"]
    if case.endswith("train"):
        assert 0.75 <= ratio <= 1.0
    else:
        assert ratio == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("case", CASES)
def test_collective_bytes_within_ratio_of_jax(jax_steps, port_steps, case):
    assert_bytes_within_ratio(port_steps[case], jax_steps[case])


@pytest.mark.parametrize("case", CASES)
def test_flops_per_card_against_jax(jax_steps, port_steps, case):
    assert_flops_against_jax(port_steps[case], jax_steps[case], case)


def main(cases=CASES) -> None:
    """Print each case's ratios: the JAX package's collective bytes over the
    port's (raw, and with the port's reduce-scatters in XLA's CPU form),
    and the port's FLOPs over the JAX package's.

      PYTHONPATH=src:tests python tests/test_torch_dryrun_collectives_steps.py
    """
    jax_side = jax_hlo(*cases)
    for case in cases:
        got, want = port_trace(case), jax_side[case]
        total = sum(want["coll"].values())
        print(f"{case}: bytes JAX / port {total / sum(got['collectives'].values()):.3f} raw, "
              f"{total / xla_cpu_form(got['by_axis']):.3f} in XLA's CPU form; FLOPs port / "
              f"JAX {got['flops'] / want['flops']:.3f}; port {got['by_axis']}, JAX {want['coll']}")


if __name__ == "__main__":
    main(sys.argv[1:] or CASES)
