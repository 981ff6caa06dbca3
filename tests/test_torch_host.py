"""Port host-side (numpy) modules against the JAX package's: EXACT equality.

These modules are verbatim copies (time model, scheduler, data pipeline,
partitions, env, cohort building), so the same inputs must give the same
floats and the same batches, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import resnet_cifar as jcfg
from repro.core import codec as jcodec
from repro.core import scheduler as jsched
from repro.core import timemodel as jtime
from repro.data import partition as jpart
from repro.data import pipeline as jpipe
from repro.data.synthetic import ClassImageTask as JTask
from repro.fed import cohort as jcohort
from repro.fed.client import HeteroEnv as JEnv
from repro.fed.client import SimClient as JClient
from repro_torch.configs import resnet_cifar as tcfg
from repro_torch.core import codec as tcodec
from repro_torch.core import scheduler as tsched
from repro_torch.core import timemodel as ttime
from repro_torch.data import partition as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import ClassImageTask as TTask
from repro_torch.fed import cohort as tcohort
from repro_torch.fed.client import HeteroEnv as TEnv
from repro_torch.fed.client import SimClient as TClient

NAMES = ["resnet-56", "resnet-110", "resnet-bench", "resnet-micro"]


def _eq_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq_tree(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_resnet_tier_costs_exact(name, reduced):
    jc, tc = jcfg.get_resnet(name), tcfg.get_resnet(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    ja, ta = jtime.resnet_tier_costs(jc, 32), ttime.resnet_tier_costs(tc, 32)
    for f in dataclasses.fields(ja):
        np.testing.assert_array_equal(getattr(ta, f.name), getattr(ja, f.name))


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_simulate_client_times_batch_exact(codec):
    rng = np.random.default_rng(0)
    n = 12
    tiers = rng.integers(0, 7, n)
    flops = rng.uniform(0.1, 4, n) * jtime.UNIT_FLOPS
    bps = rng.uniform(10, 100, n) * 1e6 / 8
    nb = rng.integers(1, 9, n)
    jcost = jtime.resnet_tier_costs(jcfg.RESNET56, 32)
    tcost = ttime.resnet_tier_costs(tcfg.RESNET56, 32)
    jt = jtime.simulate_client_times_batch(jcost, tiers, flops, bps, nb, n_sharing=n,
                                           wires=jcodec.wire_sizes(jcost, codec))
    tt = ttime.simulate_client_times_batch(tcost, tiers, flops, bps, nb, n_sharing=n,
                                           wires=tcodec.wire_sizes(tcost, codec))
    _eq_tree(tt, jt)


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_dynamic_scheduler_exact_over_observations(codec):
    """Both schedulers see the same observation sequence; every round's
    estimate matrix and assignment are identical."""
    def make(time_mod, codec_mod, sched_mod, cfg):
        costs = time_mod.resnet_tier_costs(cfg.RESNET56, 32)
        prof = sched_mod.TierProfile.from_cost_table(
            costs, ref_flops=time_mod.UNIT_FLOPS, server_flops=time_mod.SERVER_FLOPS,
            wires=codec_mod.wire_sizes(costs, codec))
        return costs, sched_mod.DynamicTierScheduler(prof, 10)

    jcost, js = make(jtime, jcodec, jsched, jcfg)
    _, ts = make(ttime, tcodec, tsched, tcfg)
    rng = np.random.default_rng(1)
    profiles = jtime.PAPER_PROFILES
    for r in range(6):
        ks = sorted(rng.choice(10, 7, replace=False).tolist())
        np.testing.assert_array_equal(ts.estimate_matrix(ks), js.estimate_matrix(ks))
        assign = ts.schedule(ks)
        assert assign == js.schedule(ks)
        tiers = np.array([assign[k] for k in ks])
        prof = [profiles[k % len(profiles)] for k in ks]
        nb = rng.integers(1, 9, len(ks))
        t = jtime.simulate_client_times_batch(
            jcost, tiers, np.array([p.flops for p in prof]),
            np.array([p.bytes_per_s for p in prof]), nb, n_sharing=len(ks))
        obs = (ks, tiers, t["client"] + t["comm"],
               np.array([p.bytes_per_s for p in prof]), nb)
        js.observe_cohort(*obs)
        ts.observe_cohort(*obs)
    assert ts.schedule(None) == js.schedule(None)


def test_static_scheduler_exact():
    assert tsched.StaticScheduler(3, 5).schedule([0, 2]) == jsched.StaticScheduler(3, 5).schedule([0, 2])


def _clients(mod_task, mod_pipe, mod_part, mod_client, iid, n_clients=4, samples=150, bs=16):
    task = mod_task(n_classes=10, image_size=8)
    labels = np.random.default_rng(0).integers(0, 10, samples)
    parts = (mod_part.iid_partition(labels, n_clients, seed=0) if iid
             else mod_part.dirichlet_partition(labels, n_clients, 0.5, seed=0))
    return [mod_client(i, mod_pipe.ClientDataset(task, labels, parts[i], bs), None)
            for i in range(n_clients)], task


@pytest.mark.parametrize("iid", [True, False])
def test_data_and_cohorts_exact(iid):
    """Partitions, epochs, materialized rounds and stacked cohorts (batches
    and step masks), including a ragged cohort under Dirichlet skew."""
    jcl, jtask = _clients(JTask, jpipe, jpart, JClient, iid)
    tcl, ttask = _clients(TTask, tpipe, tpart, TClient, iid)
    for a, b in zip(jcl, tcl):
        np.testing.assert_array_equal(b.dataset.indices, a.dataset.indices)
        for x, y in zip(a.dataset.epoch(5), b.dataset.epoch(5)):
            _eq_tree(y, x)
        _eq_tree(tpipe.materialize_round(b.dataset, 2, 2), jpipe.materialize_round(a.dataset, 2, 2))
    _eq_tree(tpipe.make_eval_batch(ttask, 20), jpipe.make_eval_batch(jtask, 20))
    tier_of = {0: 1, 1: 2, 2: 1, 3: 1}
    jco = jcohort.build_cohorts(jcl, [0, 1, 2, 3], tier_of, 3, 1)
    tco = tcohort.build_cohorts(tcl, [0, 1, 2, 3], tier_of, 3, 1)
    assert len(jco) == len(tco)
    for a, b in zip(jco, tco):
        assert (b.tier, b.cids, b.n_pad) == (a.tier, a.cids, a.n_pad)
        np.testing.assert_array_equal(b.mask, a.mask)
        _eq_tree(b.batches, a.batches)
    if not iid:
        assert any(not c.mask.all() for c in tco), "expected a ragged cohort"


def test_hetero_env_exact():
    je, te = JEnv(20, switch_every=2, seed=3), TEnv(20, switch_every=2, seed=3)
    for r in range(7):
        je.maybe_switch(r)
        te.maybe_switch(r)
        np.testing.assert_array_equal(te.assignment, je.assignment)
        assert ([dataclasses.astuple(te.profile(k)) for k in range(20)]
                == [dataclasses.astuple(je.profile(k)) for k in range(20)])
