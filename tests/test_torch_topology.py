"""The port's offload topology and pairing scheduler against the JAX
package's (``repro/core/topology.py``, ``repro/core/scheduler.py:335-489``).

Everything here is host-side numpy, copied near-verbatim, so it must be
EXACT: ``OffloadTopology`` views, ``simulate_times``, the greedy and
Hungarian matchings, and the pairing scheduler's assignments, hosts and
estimate matrices over seeded observation draws.

A 3-round DTFL run with ``--topology pairing`` on the port's loop plane
with the int8 codec, against the JAX package's cohort plane: the clocks,
tiers, hosts and uplink bytes of every round must be exact (the topology
changes only the time model and the logs, not training); the parameters
are held to ``tests/test_torch_dtfl.py``'s bounds in U = lr * local
steps, max 0.5 U, 99th percentile 0.1 U, median 0.01 U (measured: max
0.12 U, 99th percentile 0.035 U, median 0.0008 U).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.resnet_cifar import RESNET56 as J_RESNET56
from repro.core import scheduler as jsched
from repro.core import timemodel as jtime
from repro.core import topology as jtopo
from repro.launch import train as jtrain
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.configs.resnet_cifar import RESNET56
from repro_torch.core import scheduler as tsched
from repro_torch.core import timemodel as ttime
from repro_torch.core import topology as ttopo
from repro_torch.launch import train as ttrain

torch.set_num_threads(2)


def _profiles(pkg_time, n, seed):
    rng = np.random.default_rng(seed)
    return [pkg_time.ResourceProfile(cpus=float(c), mbps=float(m))
            for c, m in zip(rng.uniform(0.1, 4.0, n), rng.uniform(5, 120, n))]


def test_assignment_and_offload_topology():
    for pkg in (jtopo, ttopo):
        assert pkg.SERVER == -1
    for value in (3, (2, 5), jtopo.Assignment(1, 4)):
        want = jtopo.as_assignment(value)
        got = ttopo.as_assignment(tuple(value) if isinstance(value, tuple) else value)
        assert tuple(got) == tuple(want)
    sched = {0: 2, 3: (1, 7), 7: (0, -1), 9: 4}
    j, t = jtopo.OffloadTopology.from_schedule(sched), ttopo.OffloadTopology.from_schedule(sched)
    assert t.tiers() == j.tiers() and t.hosts() == j.hosts()
    assert t.is_server_only == j.is_server_only is False
    assert t.server_hosted() == j.server_hosted()
    assert t.guests_of() == j.guests_of() == {7: [3]}
    assert ttopo.OffloadTopology.from_schedule({1: 0, 2: 3}).is_server_only


@pytest.mark.parametrize("seed", range(4))
def test_simulate_times_exact(seed):
    """Random tiers, hosts (server or a peer), profiles and batch counts, on
    identity and top-k wires."""
    rng = np.random.default_rng(seed)
    n = 7
    parts = sorted(rng.choice(50, n, replace=False).tolist())
    tiers = rng.integers(0, 7, n)
    hosts = [int(rng.choice(parts)) if rng.random() < 0.4 else -1 for _ in parts]
    hosts = [-1 if h == k else h for h, k in zip(hosts, parts)]
    nb = rng.integers(1, 9, n)
    jcost = jtime.resnet_tier_costs(J_RESNET56, 32)
    tcost = ttime.resnet_tier_costs(RESNET56, 32)
    from repro.core.codec import wire_sizes as jwires
    from repro_torch.core.codec import wire_sizes as twires
    for codec in ("identity", "topk0.05"):
        sched = {k: (int(tr), h) for k, tr, h in zip(parts, tiers, hosts)}
        want = jtopo.simulate_times(jcost, jtopo.OffloadTopology.from_schedule(sched), parts,
                                    _profiles(jtime, n, seed), nb, wires=jwires(jcost, codec))
        got = ttopo.simulate_times(tcost, ttopo.OffloadTopology.from_schedule(sched), parts,
                                   _profiles(ttime, n, seed), nb, wires=twires(tcost, codec))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_pair_matchings_exact(n):
    for seed in range(10):
        C = np.random.default_rng(seed * 17 + n).uniform(0.1, 50.0, (n, n))
        assert tsched._greedy_pairs(C) == jsched._greedy_pairs(C)
        assert tsched._hungarian_pairs(C) == jsched._hungarian_pairs(C)


@pytest.mark.parametrize("method", ["hungarian", "greedy"])
def test_pairing_scheduler_exact(method):
    """Both schedulers see the same seeded observations for 6 rounds of 10
    sampled clients out of 16; every assignment, host map and estimate
    matrix must be equal."""
    jprof = jsched.TierProfile.from_cost_table(
        jtime.resnet_tier_costs(J_RESNET56, 32), ref_flops=jtime.UNIT_FLOPS,
        server_flops=jtime.SERVER_FLOPS)
    tprof = tsched.TierProfile.from_cost_table(
        ttime.resnet_tier_costs(RESNET56, 32), ref_flops=ttime.UNIT_FLOPS,
        server_flops=ttime.SERVER_FLOPS)
    js = jsched.PairingScheduler(jprof, 16, method=method)
    ts = tsched.PairingScheduler(tprof, 16, method=method)
    rng = np.random.default_rng(7)
    speed = rng.uniform(0.05, 3.0, 16)
    nu = rng.uniform(1e6, 1.5e7, 16)
    nb = rng.integers(2, 9, 16)
    hosted = 0
    for _ in range(6):
        ks = sorted(rng.choice(16, 10, replace=False).tolist())
        ja, ta = js.schedule(ks), ts.schedule(ks)
        assert {k: tuple(v) for k, v in ta.items()} == {k: tuple(v) for k, v in ja.items()}
        assert ts.last_hosts == js.last_hosts
        hosted += len(ts.last_hosts)
        tiers = [ja[k].tier for k in ks]
        t = np.array([jprof.t_client_ref[m] * nb[k] / speed[k] * rng.uniform(0.9, 1.1)
                      for m, k in zip(tiers, ks)])
        js.observe_cohort(ks, tiers, t, nu[ks], nb[ks])
        ts.observe_cohort(ks, tiers, t, nu[ks], nb[ks])
        np.testing.assert_array_equal(ts.estimate_matrix(ks), js.estimate_matrix(ks))
        for k in ks:
            assert ts.speed(k) == js.speed(k)
    assert hosted > 0, "expected some rounds with peer hosts"


def test_pairing_specs():
    """The pairing specs build through the registry, as the trainer builds
    its scheduler."""
    from repro_torch import registry

    tprof = tsched.TierProfile.from_cost_table(
        ttime.resnet_tier_costs(RESNET56, 32), ref_flops=ttime.UNIT_FLOPS,
        server_flops=ttime.SERVER_FLOPS)
    for spec, method in (("pairing", "hungarian"), ("pairing:hungarian", "hungarian"),
                         ("pairing:greedy", "greedy")):
        s = registry.schedulers.build(spec, profile=tprof, n_clients=4,
                                      n_tiers=tprof.n_tiers)
        assert isinstance(s, tsched.PairingScheduler) and s.method == method
        assert s.provides_hosts


def test_three_pairing_rounds_match_jax():
    flags = ["--arch", "resnet-56", "--clients", "4", "--rounds", "3", "--samples", "200",
             "--batch-size", "16", "--lr", "1e-3", "--topology", "pairing", "--codec", "int8"]
    fed = jtrain.spec_from_args(jtrain.build_parser().parse_args(flags)).build()
    jt = fed.trainer
    tt, eval_batch = ttrain.build(ttrain.build_parser().parse_args(
        flags + ["--exec", "loop", "--device", "cpu"]))
    assert (tt.topology, tt.exec_plan.mode) == ("pairing", "loop")
    tt.params = from_numpy_tree(jax.tree.map(np.asarray, jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(jax.tree.map(np.asarray, a), "cpu") for m, a in jt.aux.items()}
    jlogs = fed.run()
    tlogs = tt.run(3, eval_batch)
    assert len(tlogs) == len(jlogs) == 3
    for a, b in zip(jlogs, tlogs):
        assert (b.clock, b.assignment, b.uplink_bytes, b.straggler, b.hosts) == \
            (a.clock, a.assignment, a.uplink_bytes, a.straggler, a.hosts)
    assert any(log.hosts for log in tlogs), "expected peer-hosted rounds"
    unit = 1e-3 * 3 * max(c.n_batches for c in tt.clients)
    for got, want in [(tt.params, jt.params)] + [(tt.aux[m], jt.aux[m]) for m in jt.aux]:
        d = np.concatenate([
            np.abs(g - w).ravel() for g, w in zip(
                jax.tree.leaves(to_numpy_tree(got)),
                jax.tree.leaves(jax.tree.map(np.asarray, want)))])
        assert d.max() <= 0.5 * unit, d.max() / unit
        assert np.quantile(d, 0.99) <= 0.1 * unit, np.quantile(d, 0.99) / unit
        assert np.median(d) <= 0.01 * unit, np.median(d) / unit
