"""The port's population plane and events engine against the JAX package's
(``repro/fed/population.py``, ``repro/core/events.py``,
``repro/fed/client.py::ChurnModel``, ``repro/fed/engine.py::run_events``).

Host-side quantities must be EXACT: ``cid_rng`` streams, the lazy store's
touched clients, ``LazyHeteroEnv`` profiles across switch rounds and
overrides, ``EventQueue`` pop order with cancellations, and every
``ChurnModel`` draw.

Two 3-round DTFL runs against the JAX package's cohort plane, both with
``--codec topk0.05`` on the CLI's reduced resnet-56 (batch 16):
``--population 50 --sample-size 4 --samples 64`` on the port's chunked
plane (``--chunk-size 2``), and ``--engine events --churn`` on 4 clients,
200 samples. Clocks, tiers, uplink bytes, the touched clients and the
clients holding residuals must be exact; parameters and residuals are held
to ``tests/test_torch_planes.py``'s bounds in U = lr * local steps
(parameters max 0.5 U, 99th percentile 0.1 U, median 0.01 U; residuals
and aux heads 0.5 / 0.2 / 0.01 U; measured: population max 0.10 U,
residuals 7e-5 U; events max 0.14 U, residuals 0.14 U, the 2 lr of a
flipped top-k entry, see there).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import events as jevents
from repro.core import timemodel as jtime
from repro.fed import client as jclient
from repro.fed import population as jpop
from repro.launch import train as jtrain
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.core import events as tevents
from repro_torch.core import timemodel as ttime
from repro_torch.fed import client as tclient
from repro_torch.fed import population as tpop
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)


def test_cid_rng_streams_exact():
    for parts in ((0, 11, 5), (3, 13, 50, 99_999), (7, 21, 123_456)):
        np.testing.assert_array_equal(tpop.cid_rng(*parts).random(5),
                                      jpop.cid_rng(*parts).random(5))


def test_client_store_touches_exactly():
    built = {"j": [], "t": []}
    js = jpop.ClientStore(10_000, lambda c: built["j"].append(c) or ("c", c))
    ts = tpop.ClientStore(10_000, lambda c: built["t"].append(c) or ("c", c))
    for cid in (3, 9999, 3, 0, 512, 9999):
        assert ts[cid] == js[cid]
    assert ts.touched() == js.touched() == [0, 3, 512, 9999]
    assert ts.n_touched == js.n_touched == len(built["t"]) == 4
    ts.compact([3, 512])
    js.compact([3, 512])
    assert ts.touched() == js.touched()
    with pytest.raises(IndexError):
        ts[10_000]


def test_lazy_env_profiles_exact():
    """Profiles of touched clients across switch rounds and mid-round
    overrides, in a touch order that differs between the two."""
    j = jpop.LazyHeteroEnv(100_000, switch_every=2, seed=3)
    t = tpop.LazyHeteroEnv(100_000, switch_every=2, seed=3)
    cids = np.random.default_rng(0).choice(100_000, 40, replace=False)
    for r in range(7):
        j.maybe_switch(r)
        t.maybe_switch(r)
        if r == 3:
            for c in cids[:5]:
                j.set_profile(c, 2)
                t.set_profile(c, 2)
        order = cids if r % 2 else cids[::-1]
        assert [t.profile_idx(c) for c in order] == [j.profile_idx(c) for c in order]
        assert t.profile(cids[0]) == ttime.PAPER_PROFILES[j.profile_idx(cids[0])]
        assert t.n_touched == j.n_touched
    assert jtime.PAPER_PROFILES == [jtime.ResourceProfile(p.cpus, p.mbps)
                                    for p in ttime.PAPER_PROFILES]


def test_event_queue_order_exact():
    """Seeded pushes with time ties and cancellations pop in the same
    order, at the same clock."""
    rng = np.random.default_rng(4)
    qs = (jevents.EventQueue(), tevents.EventQueue())
    evs = ([], [])
    for i in range(60):
        time = float(rng.integers(0, 20))
        for q, ev in zip(qs, evs):
            ev.append(q.push(time, "complete", idx=i))
    for i in rng.choice(60, 15, replace=False):
        for ev in evs:
            ev[i].cancel()
    got = ([], [])
    while not qs[0].empty():
        for q, g in zip(qs, got):
            e = q.pop()
            g.append((e.time, e.kind, e.payload["idx"], e.seq, q.now))
    assert qs[1].empty() and got[0] == got[1] and len(got[1]) == 45


def test_churn_draws_exact():
    kw = dict(drop_prob=0.2, switch_prob=0.3, start_offline_frac=0.25, rejoin_after=2, seed=5)
    jc, tc = jclient.ChurnModel(40, **kw), tclient.ChurnModel(40, **kw)
    jenv, tenv = jclient.HeteroEnv(40, seed=1), tclient.HeteroEnv(40, seed=1)
    assert tc.offline == jc.offline
    for r in range(8):
        np.testing.assert_array_equal(tc.begin_round(r), jc.begin_round(r))
        trained = tc.active()[:12]
        draws = tc.sample_mid_round(trained, np.ones(len(trained)))
        assert draws == jc.sample_mid_round(trained, np.ones(len(trained)))
        for kind, i, _ in draws:
            if kind == "dropout":
                jc.mark_offline(trained[i])
                tc.mark_offline(trained[i])
            else:
                jc.resample_profile(jenv, trained[i])
                tc.resample_profile(tenv, trained[i])
        assert tc.offline == jc.offline
        np.testing.assert_array_equal(tenv.assignment, jenv.assignment)


def _u(got, want):
    if torch.is_tensor(tree_leaves(got)[0]):
        got = to_numpy_tree(got)
    d = np.concatenate([np.abs(np.asarray(g) - np.asarray(w)).ravel()
                        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    return d.max(), np.quantile(d, 0.99), np.median(d)


def _held(got, want, unit, bounds):
    stats = [s / unit for s in _u(got, want)]
    assert all(s <= b for s, b in zip(stats, bounds)), stats


BASE = ["--arch", "resnet-56", "--rounds", "3", "--batch-size", "16", "--lr", "1e-3",
        "--codec", "topk0.05"]
CASES = {
    "population": (["--population", "50", "--sample-size", "4", "--samples", "64"],
                   ["--exec", "chunked", "--chunk-size", "2"]),
    "events-churn": (["--clients", "4", "--samples", "200", "--engine", "events", "--churn"], []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_rounds_match_jax(case):
    common, port_only = CASES[case]
    flags = BASE + common
    fed = jtrain.spec_from_args(jtrain.build_parser().parse_args(flags)).build()
    jt = fed.trainer
    args = ttrain.build_parser().parse_args(flags + port_only + ["--device", "cpu"])
    tt, eval_batch = ttrain.build(args)
    tt.params = from_numpy_tree(jax.tree.map(np.asarray, jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(jax.tree.map(np.asarray, a), "cpu") for m, a in jt.aux.items()}
    jlogs = fed.run()
    churn, drops = ttrain.make_churn(args), []
    if churn is not None:
        mark = churn.mark_offline
        churn.mark_offline = lambda cid: (drops.append(cid), mark(cid))
    tlogs = tt.run(3, eval_batch, sample_size=args.sample_size, engine=args.engine,
                   churn=churn)
    assert len(tlogs) == len(jlogs) == 3
    for a, b in zip(jlogs, tlogs):
        assert (b.clock, b.assignment, b.uplink_bytes, b.straggler) == \
            (a.clock, a.assignment, a.uplink_bytes, a.straggler)
    if case == "population":
        assert isinstance(tt.clients, tpop.ClientStore)
        assert tt.clients.touched() == jt.clients.touched()
        assert tt.sched.clients.touched() == jt.sched.clients.touched()
        assert tt.clients.n_touched <= 3 * 4 + 1      # the sampled, and client 0
    else:
        assert drops, "expected a mid-round dropout"
    sampled = set().union(*(log.assignment for log in tlogs))
    unit = 1e-3 * 3 * max(tt.clients[k].n_batches for k in sampled)
    _held(tt.params, jt.params, unit, (0.5, 0.1, 0.01))
    for m in jt.aux:
        _held(tt.aux[m], jt.aux[m], unit, (0.5, 0.2, 0.01))
    assert sorted(tt._ef) == sorted(jt._ef)
    for cid, st in jt._ef.items():
        assert tt._ef[cid]["tier"] == st["tier"]
        _held((tt._ef[cid]["c"], tt._ef[cid]["a"]), (st["c"], st["a"]), unit, (0.5, 0.2, 0.01))
