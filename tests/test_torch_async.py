"""The port's async tier engine (``fed/engine.py::run_async``,
``split_speed_groups``; ``DTFLTrainer.train_group`` / ``async_groups``;
``core/aggregation.py::weighted_average``) against the JAX package's.

Each case is the CLI's reduced resnet-56 (3 tiers) priced on the full
ResNet-56, ``--engine async`` on 6 clients, built from the same flags in
both packages; the port starts from the JAX trainer's round-0 weights and
aux heads. Wave 0 plus ``rounds * n_groups`` merges.

  * EXACT: every log's clock, straggler (the wave's time), tier assignment
    and uplink bytes; the speed groups; the order of the waves trained, with
    their round index and members. They are host-side: the time model, the
    scheduler's estimates, the participant and churn draws.
  * CLOSE: the parameters after the budget, within max 0.5 U, 99th
    percentile 0.1 U, median 0.01 U (``tests/test_torch_dtfl.py``'s
    bounds), U = lr * (local steps in the run: the waves of the longest
    chain, one a log, times the batches of a client).

Cases: int8 uploads; churn (dropouts, switches, clients offline from the
start); ``--participation 0.5`` (each wave samples half its group).
"""
import jax
import numpy as np
import pytest
import torch

from hyputil import given, settings, st
from repro.fed import engine as jengine
from repro.launch import train as jtrain
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.core import aggregation
from repro_torch.fed import engine as tengine
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
BASE = ["--arch", "resnet-56", "--clients", "6", "--samples", "300", "--batch-size", "16",
        "--lr", "1e-3", "--engine", "async", "--rounds", "3"]
CASES = {
    "int8": ["--codec", "int8", "--n-groups", "3"],
    "churn": ["--n-groups", "2", "--churn", "--churn-drop", "0.2",
              "--churn-offline-frac", "0.2"],
    "participation": ["--n-groups", "2", "--participation", "0.5"],
}


def _record(trainer):
    """Wrap ``async_groups`` and ``train_group`` to record the groups and
    the waves trained, in order."""
    rec = {"groups": [], "waves": []}
    groups, train_group = trainer.async_groups, trainer.train_group

    def async_groups(cids, n):
        out = groups(cids, n)
        rec["groups"].append([[int(k) for k in g] for g in out])
        return out

    def train(r, plan, trained):
        rec["waves"].append((int(r), [int(k) for k in trained]))
        return train_group(r, plan, trained)

    trainer.async_groups, trainer.train_group = async_groups, train
    return rec


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_run_matches_jax(case):
    flags = BASE + CASES[case]
    jfed = jtrain.spec_from_args(jtrain.build_parser().parse_args(flags)).build()
    tfed = ttrain.spec_from_args(ttrain.build_parser().parse_args(flags)).build(device="cpu")
    jt, tt = jfed.trainer, tfed.trainer
    tt.params = from_numpy_tree(jax.tree.map(np.asarray, jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(jax.tree.map(np.asarray, a), "cpu") for m, a in jt.aux.items()}
    jrec, trec = _record(jt), _record(tt)
    jlogs, tlogs = jfed.run(), tfed.run()

    assert len(tlogs) == len(jlogs) == 1 + 3 * int(CASES[case][CASES[case].index("--n-groups") + 1])
    for a, b in zip(jlogs, tlogs):
        assert (b.round, b.clock, b.straggler, b.assignment, b.uplink_bytes) == \
            (a.round, a.clock, a.straggler, a.assignment, a.uplink_bytes)
    assert trec == jrec
    assert len(trec["groups"][0]) > 1, "expected several speed groups"
    if case == "participation":
        assert all(len(m) < 3 for _, m in trec["waves"])
    if case == "churn":     # dropouts and offline clients leave waves short
        assert any(len(m) < 3 for _, m in trec["waves"])

    unit = 1e-3 * len(tlogs) * max(c.n_batches for c in tt.clients)
    d = np.concatenate([
        np.abs(g - w).ravel() for g, w in zip(
            jax.tree.leaves(to_numpy_tree(tt.params)),
            jax.tree.leaves(jax.tree.map(np.asarray, jt.params)))])
    assert d.max() <= 0.5 * unit, d.max() / unit
    assert np.quantile(d, 0.99) <= 0.1 * unit, np.quantile(d, 0.99) / unit
    assert np.median(d) <= 0.01 * unit, np.median(d) / unit


@given(order=st.lists(st.integers(0, 10_000), max_size=40, unique=True),
       n_groups=st.integers(1, 12))
@settings(max_examples=200, deadline=None)
def test_split_speed_groups_matches_jax(order, n_groups):
    got = tengine.split_speed_groups(list(order), n_groups)
    assert got == jengine.split_speed_groups(list(order), n_groups)
    assert [k for g in got for k in g] == list(order)


def test_weighted_average_matches_jax():
    rng = np.random.default_rng(0)
    trees = [{"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]} for _ in range(3)]
    weights = [40.0, 12.0 / 3.0, 7.5]
    from repro.core import aggregation as jagg

    want = jax.tree.map(np.asarray, jagg.weighted_average(trees, weights))
    got = to_numpy_tree(aggregation.weighted_average(
        [from_numpy_tree(t, "cpu") for t in trees], weights))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        assert g.dtype == w.dtype


def test_wave_snapshot_survives_other_merges():
    """A wave trains from the params as they were at its launch. The port
    keeps that snapshot by reference, so any in-place write to a params
    leaf (optimizer, aggregation, load_state) would change it under the
    wave: every snapshot must be unchanged, element for element and in
    its tensors' version counters, when its wave trains, after other
    groups' merges have landed."""
    tfed = ttrain.spec_from_args(ttrain.build_parser().parse_args(
        BASE + CASES["int8"])).build(device="cpu")
    tt = tfed.trainer
    snaps, checked, trained = {}, [], [0]
    plan_round, train_group = tt.plan_round, tt.train_group

    def plan(r, members):
        p = plan_round(r, members)
        leaves = tree_leaves(tt.params)
        snaps[id(p)] = (tt.params, [x.clone() for x in leaves],
                        [x._version for x in leaves], trained[0])
        return p

    def train(r, p, members):
        if id(p) in snaps:
            ref, values, versions, at_launch = snaps[id(p)]
            assert tt.params is ref
            leaves = tree_leaves(tt.params)
            assert [x._version for x in leaves] == versions
            assert all(torch.equal(x, v) for x, v in zip(leaves, values))
            checked.append(trained[0] - at_launch)
        trained[0] += 1
        return train_group(r, p, members)

    tt.plan_round, tt.train_group = plan, train
    logs = tfed.run()
    assert len(logs) == 10 and len(checked) == 9
    assert max(checked) >= 1, "no wave trained after another group's merge"
    for ref, values, versions, _ in snaps.values():
        leaves = tree_leaves(ref)
        assert [x._version for x in leaves] == versions
        assert all(torch.equal(x, v) for x, v in zip(leaves, values))
