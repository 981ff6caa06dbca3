"""The port's FedGKT (``repro_torch/fed/fedgkt.py``) and the adapters'
FedGKT hooks against the JAX package's (``repro/fed/fedgkt.py``,
``repro/fed/adapter.py:110-118``, ``:180-190``).

  * Hooks: ``client_features``, ``aux_logits`` and ``server_logits`` of
    both adapters (the reduced ResNet-56; SmolLM-360M reduced to 6 layers,
    4 heads over 2 KV heads, 4 modules, in fp32) at the FedGKT split, on a
    cohort of two clients, within 1e-5 of the largest magnitude.
  * Three rounds from the same CLI flags as ``tests/test_torch_baselines.py``
    (with one and with two local epochs: only the last epoch uploads), the
    port started from the JAX trainer's envelope (edge model, server
    model, aux head, server optimizer). EXACT: clocks, stragglers, uplink
    bytes, trained clients, each round's server-phase seconds, the teacher
    cache's (client, batch) keys. CLOSE in U = lr x (local steps in the
    run): the merged parameters, the edge and server models and the aux
    head within max 0.5 U, 99th percentile 0.1 U, median 0.01 U. The
    teacher logits are the server model's outputs at each of its steps,
    and the two server models differ within those bounds, so the logits
    differ too: each (client, batch) entry within max 5e-3 and median 1e-3
    of its largest magnitude (measured: max 1.96e-3, median at most
    5.8e-4); another batch's or a stale round's logits differ by O(1).
  * Resume bit for bit on the CPU; the envelope crosses between the
    packages both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed.fedgkt import SPLIT_TIER as JSPLIT
from repro.launch import train as jtrain
from repro_torch.bridge import from_numpy_tree
from repro_torch.fed.fedgkt import SPLIT_TIER
from repro_torch.launch import train as ttrain

from test_torch_baselines import (BASE, BOUNDS, CASES, _close, _two_models, cli_run,
                                  client_unit, jax_state, logs_equal, spec, spy,
                                  states_equal, within)

torch.set_num_threads(2)
FLAGS = BASE + ["--method", "fedgkt", "--rounds", "3"]
TEACHER_TOL = (5e-3, 1e-3)   # max, median; of the entry's largest magnitude


@pytest.mark.parametrize("case", sorted(CASES))
def test_fedgkt_hooks_match_jax(case):
    assert SPLIT_TIER == JSPLIT == 1
    tad, jad, batch = CASES[case](5)
    params = _two_models(jad)
    aux = jax.tree.map(lambda a: np.stack([np.asarray(a)] * 2),
                       jad.aux_init(jax.random.PRNGKey(7), SPLIT_TIER))

    def jhooks(p, a, b):
        cp, sp = jad.split(p, SPLIT_TIER)
        z = jad.client_features(cp, b)
        return z, jad.aux_logits(a, z), jad.server_logits(sp, z, SPLIT_TIER)

    want = jax.jit(jax.vmap(jhooks))(params, aux, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = from_numpy_tree(params, "cpu")
    splits = [jad.split(jax.tree.map(lambda x: x[c], params), SPLIT_TIER) for c in range(2)]
    cp, sp = (from_numpy_tree(jax.tree.map(lambda a, b: np.stack([a, b]), *halves), "cpu")
              for halves in zip(*splits))
    assert sorted(tad.split(jax.tree.map(lambda t: t[0], tp), SPLIT_TIER)[0]) == sorted(cp)
    z = tad.client_features(cp, tb)
    got = (z, tad.aux_logits(from_numpy_tree(aux, "cpu"), z), tad.server_logits(sp, z, SPLIT_TIER))
    for g, w, what in zip(got, want, ("z", "aux logits", "server logits")):
        assert g.shape == w.shape, what
        _close(g, w, 1e-5, what)


def _flags(epochs):
    return FLAGS, ({"trainer.local_epochs": epochs} if epochs > 1 else None)


def _spec(pkg, flags, overrides):
    s = spec(pkg, flags)
    return s.with_overrides(overrides) if overrides else s


@pytest.mark.parametrize("epochs", [1, 2])
def test_three_fedgkt_rounds_match_jax(epochs):
    flags, over = _flags(epochs)
    jfed = _spec(jtrain, flags, over).build()
    jt = jfed.trainer
    init = jax_state(jt)
    jrec = spy(jt)
    jlogs = jfed.run()
    tfed = _spec(ttrain, flags, over).build(device="cpu")
    tt = tfed.trainer
    assert tt.local_epochs == epochs
    tt.load_state(init)
    trec = spy(tt)
    tlogs = tfed.run()
    logs_equal(tlogs, jlogs)
    assert trec == jrec
    assert all(e > 0 for e in trec["extra"])
    # the server phase counts one step per batch of the last local epoch
    for trained, extra in zip(trec["trained"], trec["extra"]):
        n_up = sum(tt.clients[k].n_batches for k in trained)
        assert extra == tt.costs.server_flops[SPLIT_TIER] * n_up / tt.server_flops
    assert sorted(tt._teacher) == sorted(jt._teacher)
    assert len(tt._teacher) == sum(c.n_batches for c in tt.clients)
    unit = client_unit(tt) * epochs
    for got, want, what in ((tt.params, jt.params, "params"),
                            (tt.client_params, jt.client_params, "edge model"),
                            (tt.server_params, jt.server_params, "server model"),
                            (tt.aux, jt.aux, "aux head")):
        within(got, want, unit, BOUNDS, what)
    for key, v in jt._teacher.items():
        assert tt._teacher[key].shape == (1,) + v.shape
        d, scale = np.abs(tt._teacher[key][0].numpy() - np.asarray(v)), np.abs(v).max()
        assert d.max() <= TEACHER_TOL[0] * scale, (key, d.max() / scale)
        assert np.median(d) <= TEACHER_TOL[1] * scale, (key, np.median(d) / scale)


def test_fedgkt_resume_is_bit_for_bit(tmp_path):
    """3 rounds straight against 2 with ``--out-ckpt`` then 3 with
    ``--resume``: round 2's log and the whole state (edge, server and aux
    models, the server optimizer, the teacher cache) equal, element for
    element."""
    flags = BASE + ["--method", "fedgkt"]
    path = str(tmp_path / "state.npz")
    straight, st = cli_run(flags + ["--rounds", "3"])
    cli_run(flags + ["--rounds", "2", "--out-ckpt", path, "--save-every", "2"])
    resumed, rt = cli_run(flags + ["--rounds", "3", "--resume", path])
    logs_equal(resumed, straight[2:])
    assert resumed[0].acc == straight[2].acc
    assert rt._teacher and sorted(rt._teacher) == sorted(st._teacher)
    states_equal(rt, st)


def test_fedgkt_envelope_crosses_packages(tmp_path):
    """The JAX package's envelope at round 2 resumes in the port (round 2's
    log equal, the models within the bounds over round 2's steps), and the
    port's in the JAX package (round 2's log equal)."""
    flags = BASE + ["--method", "fedgkt"]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jstraight = spec(jtrain, flags + ["--rounds", "3"]).build()
    jlogs = jstraight.run()
    spec(jtrain, flags + ["--rounds", "2", "--out-ckpt", jpath, "--save-every", "2"]).build().run()
    tfed = spec(ttrain, flags + ["--rounds", "3", "--resume", jpath]).build(device="cpu")
    logs_equal(tfed.run(), jlogs[2:])
    tt, jt = tfed.trainer, jstraight.trainer
    unit = client_unit(tt, rounds=1)
    for got, want in ((tt.server_params, jt.server_params), (tt.client_params, jt.client_params),
                      (tt.aux, jt.aux)):
        within(got, want, unit, BOUNDS, "models")
    assert sorted(tt._teacher) == sorted(jt._teacher)
    tlogs, _ = cli_run(flags + ["--rounds", "3"])
    cli_run(flags + ["--rounds", "2", "--out-ckpt", tpath, "--save-every", "2"])
    jresumed = spec(jtrain, flags + ["--rounds", "3", "--resume", tpath]).build()
    logs_equal(jresumed.run(), tlogs[2:])
    assert sorted(jresumed.trainer._teacher) == sorted(tt._teacher)
