"""The VLM, encoder-decoder and hybrid families in the dry-run's sharded
trace against the JAX package's ``hlo_analysis``
(``tests/jax_hlo_collectives.py``, a process of its own with 8 host
devices): whole steps of the reduced pixtral-12b (its image frontend
fused into the first positions), whisper-base (the encoder over the
frames, cross-attention at Sq != Sk) and hymba-1.5b (windowed attention
beside the Mamba scan, each card scanning its own rows and channels) at a
DTFL train step (tier 1), prefill and decode, on a (data 2, model 4)
mesh, in fp32, held as ``test_torch_dryrun_collectives_steps.py`` holds
the dense family's.
"""
import pytest
import torch

from test_torch_dryrun_collectives_steps import (SHAPES, assert_bytes_within_ratio,
                                                 assert_flops_against_jax, both_sides)

torch.set_num_threads(2)
CASES = [f"{m}-{k}" for m in ("pixtral", "whisper", "hymba") for k in SHAPES]


@pytest.fixture(scope="module")
def sides():
    return both_sides(CASES)


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[0]


@pytest.fixture(scope="module")
def port_side(sides):
    return sides[1]


@pytest.mark.parametrize("case", CASES)
def test_family_step_collective_bytes_within_ratio_of_jax(jax_side, port_side, case):
    assert_bytes_within_ratio(port_side[case], jax_side[case])


@pytest.mark.parametrize("case", CASES)
def test_family_step_flops_per_card_against_jax(jax_side, port_side, case):
    assert_flops_against_jax(port_side[case], jax_side[case], case)
