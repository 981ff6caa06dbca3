"""A 3-round DTFL run of the port against the JAX package's, with the int8
wire codec and 4 clients (Dirichlet non-IID, so cohorts are ragged).

The model is the CLI's reduced resnet-56 (width 8, 16 px, one block per
stage, 3 tiers), priced on the full ResNet-56 as the CLI prices it. On
RESNET_MICRO the time model keeps every client on tier 0 for three
rounds; here round 1 already splits the cohort over two tiers.

Both runs are built from the same CLI flags (``repro.launch.train`` ->
``ExperimentSpec``, and ``repro_torch.launch.train.build``); the port
starts from the JAX trainer's round-0 parameters and per-tier aux heads,
copied through the bridge.

  * EXACT: the round clock, the tier assignment and the uplink bytes of
    every round. They are analytic (time model, scheduler, codec pricing)
    and do not depend on the trained weights.
  * CLOSE: the parameters and aux heads after 3 rounds, in units of
    U = lr * (local steps in the run), the most Adam can move a weight.
    The two frameworks sum fp32 products in different orders; Adam's
    early updates are about lr * sign(g), so a gradient element within
    rounding of zero moves a weight by up to 2 * lr either way, and later
    steps see slightly different weights; an int8 rounding boundary can
    also flip one quantization step of z or of an upload delta. Measured
    on this run (identity codec gives the same picture): max 0.16 U,
    99th percentile 0.05 U, median 0.001 U. Bounds: max 0.5 U, 99th
    percentile 0.1 U, median 0.01 U — a wrong mask, weight or codec row
    moves the median by O(U).

The second case adds ``--dcor-alpha 0.5``: the client loss carries the
distance-correlation regularizer (kernel K2's plain versions here). The
regularizer does not enter the time model, so the exact quantities are the
same as without it; the parameters are held to the same bounds.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.launch import train as ttrain

torch.set_num_threads(2)
FLAGS = ["--arch", "resnet-56", "--clients", "4", "--rounds", "3",
         "--samples", "200", "--batch-size", "16", "--codec", "int8", "--lr", "1e-3"]


@pytest.mark.parametrize("dcor_alpha", ["0.0", "0.5"])
def test_three_int8_rounds_match_jax(dcor_alpha):
    flags = FLAGS + ["--dcor-alpha", dcor_alpha]
    fed = jtrain.spec_from_args(jtrain.build_parser().parse_args(flags)).build()
    jt = fed.trainer
    assert jt.adapter.dcor_alpha == float(dcor_alpha)
    tt, eval_batch = ttrain.build(ttrain.build_parser().parse_args(flags + ["--device", "cpu"]))
    assert tt.adapter.dcor_alpha == float(dcor_alpha)
    tt.params = from_numpy_tree(jax.tree.map(np.asarray, jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(jax.tree.map(np.asarray, a), "cpu") for m, a in jt.aux.items()}

    jlogs = fed.run()
    tlogs = tt.run(3, eval_batch)
    assert len(tlogs) == len(jlogs) == 3
    for a, b in zip(jlogs, tlogs):
        assert b.clock == a.clock
        assert b.assignment == a.assignment
        assert b.uplink_bytes == a.uplink_bytes
        assert b.straggler == a.straggler
    assert len({t for log in tlogs for t in log.assignment.values()}) > 1, \
        "expected several tiers across the rounds"

    unit = 1e-3 * 3 * max(c.n_batches for c in tt.clients)
    for got, want in [(tt.params, jt.params)] + [(tt.aux[m], jt.aux[m]) for m in jt.aux]:
        d = np.concatenate([
            np.abs(g - w).ravel() for g, w in zip(
                jax.tree.leaves(to_numpy_tree(got)),
                jax.tree.leaves(jax.tree.map(np.asarray, want)))])
        assert d.max() <= 0.5 * unit, d.max() / unit
        assert np.quantile(d, 0.99) <= 0.1 * unit, np.quantile(d, 0.99) / unit
        assert np.median(d) <= 0.01 * unit, np.median(d) / unit


def test_three_transformer_rounds_match_jax():
    """A 3-round DTFL run on the transformer: SmolLM-360M reduced to 6
    layers, 4 heads over 2 KV heads, 4 modules (tests/test_torch_transformer.py),
    in fp32, priced on the full SmolLM-360M; 4 clients with the CLI's LM
    data (2 batches of 4 x 32 tokens each). Round 1 splits the cohort over
    tiers 0 and 2. The JAX trainer is built directly (the CLI cannot make
    this config); the port starts from its round-0 parameters and aux
    heads. EXACT and CLOSE as for the ResNet above (measured here: max
    0.14 U, 99th percentile 0.0006 U, median 4e-5 U; the aux head of tier
    1, which no client trained, is exact)."""
    from repro import optim as joptim
    from repro.configs import get_config as jget_config
    from repro.data.pipeline import SeqClientDataset as JSeqClientDataset
    from repro.data.synthetic import SeqTask as JSeqTask
    from repro.fed.adapter import TransformerAdapter as JAdapter
    from repro.fed.client import HeteroEnv as JHeteroEnv
    from repro.fed.client import SimClient as JSimClient
    from repro.fed.dtfl import DTFLTrainer as JTrainer
    from repro_torch import optim as toptim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SeqClientDataset
    from repro_torch.data.synthetic import SeqTask
    from repro_torch.fed.adapter import TransformerAdapter
    from repro_torch.fed.client import HeteroEnv, SimClient
    from repro_torch.fed.dtfl import DTFLTrainer

    red = dict(n_layers=6, n_kv_heads=2, n_modules=4, dtype="float32")
    jfull, full = jget_config("smollm-360m"), get_config("smollm-360m")
    jad = JAdapter(jfull.reduced().replace(**red), seq_len=32, cost_cfg=jfull)
    tad = TransformerAdapter(full.reduced().replace(**red), seq_len=32, cost_cfg=full)
    jtask, task = JSeqTask(vocab=jad.cfg.vocab), SeqTask(vocab=tad.cfg.vocab)
    jt = JTrainer(jad, [JSimClient(i, JSeqClientDataset(jtask, 2, 4, 32, i), None)
                        for i in range(4)], JHeteroEnv(4), joptim.adam(1e-3), seed=0)
    tt = DTFLTrainer(tad, [SimClient(i, SeqClientDataset(task, 2, 4, 32, i), None)
                           for i in range(4)], HeteroEnv(4), toptim.adam(1e-3), seed=0,
                     device="cpu")
    tt.params = from_numpy_tree(jax.tree.map(np.asarray, jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(jax.tree.map(np.asarray, a), "cpu") for m, a in jt.aux.items()}
    eval_batch = next(task.batches(4, 32, 1, seed=99))

    jlogs = jt.run(3, eval_batch)
    tlogs = tt.run(3, eval_batch)
    assert len(tlogs) == len(jlogs) == 3
    for a, b in zip(jlogs, tlogs):
        assert b.clock == a.clock
        assert b.assignment == a.assignment
        assert b.uplink_bytes == a.uplink_bytes
        assert b.straggler == a.straggler
    assert len({t for log in tlogs for t in log.assignment.values()}) > 1, \
        "expected several tiers across the rounds"

    unit = 1e-3 * 3 * 2
    for got, want in [(tt.params, jt.params)] + [(tt.aux[m], jt.aux[m]) for m in jt.aux]:
        d = np.concatenate([
            np.abs(g - w).ravel() for g, w in zip(
                jax.tree.leaves(to_numpy_tree(got)),
                jax.tree.leaves(jax.tree.map(np.asarray, want)))])
        assert d.max() <= 0.5 * unit, d.max() / unit
        assert np.quantile(d, 0.99) <= 0.1 * unit, np.quantile(d, 0.99) / unit
        assert np.median(d) <= 0.01 * unit, np.median(d) / unit
