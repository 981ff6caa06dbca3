"""Checkpoint and resume in the port (``fed/engine.py::save_train_state``,
``apply_resume``; ``DTFLTrainer.save_state`` / ``load_state``;
``api.Federation``), against an uninterrupted run and against the JAX
package.

  * The port's save then resume is BIT-FOR-BIT against an uninterrupted
    port run: 4 rounds straight against 2 rounds with ``--out-ckpt`` then
    4 with ``--resume``, in a fresh process state each. Rounds 2-3 must log
    the same clock, straggler, tiers, uplink bytes, hosts and accuracy, and
    the parameters, aux heads, residuals, scheduler state and env state
    must be equal, element for element. Cases: the rounds and events
    engines; the identity codec and ``topk0.05`` (EF residuals in the
    envelope); ``--population`` on the chunked plane (the lazy env's
    sparse state); ``--topology pairing`` on the loop plane (hosts).
  * A JAX envelope resumes in the port: the JAX package's Federation
    writes it at round 2, the port's Federation resumes it (the spec stamp
    must verify, so the two spec hashes are equal). Rounds 2-3 equal the
    JAX package's uninterrupted run exactly on clocks, tiers and uplink
    bytes; parameters within ``tests/test_torch_dtfl.py``'s bounds in U =
    lr * (local steps in rounds 2-3): max 0.5 U, 99th percentile 0.1 U,
    median 0.01 U. And the other way: a port envelope resumes in the JAX
    package with the port's clocks and tiers.
  * Rejections, with the JAX package's messages: a spec-hash mismatch, an
    async envelope into a sync engine, resume under async, resume with
    churn.
"""
import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.api import SpecError as JSpecError
from repro.launch import train as jtrain
from repro_torch import checkpoint as ckpt
from repro_torch.api import ExperimentSpec, SpecError
from repro_torch.bridge import to_numpy_tree
from repro_torch.fed.engine import save_train_state
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
BASE = ["--arch", "resnet-56", "--clients", "4", "--samples", "200", "--batch-size", "16",
        "--lr", "1e-3"]
CASES = {
    "rounds": [],
    "events": ["--engine", "events"],
    "rounds-topk": ["--codec", "topk0.05"],
    "events-topk": ["--engine", "events", "--codec", "topk0.05"],
    "population": ["--codec", "topk0.05", "--population", "50", "--sample-size", "4",
                   "--exec", "chunked", "--chunk-size", "2"],
    "pairing": ["--topology", "pairing", "--exec", "loop", "--codec", "int8"],
}
LOG_FIELDS = ("round", "clock", "straggler", "assignment", "uplink_bytes", "hosts", "acc")


def _port_run(flags, tmp_path=None):
    got = {}
    logs = ttrain.main(flags + ["--device", "cpu"],
                       on_round=lambda tr, log: got.update(trainer=tr))
    return logs, got["trainer"]


def _flat(tree):
    """Keyed numpy leaves of a port tree (tensors copied to the host)."""
    return ckpt._flatten(to_numpy_tree(tree))


def _state(trainer):
    """Everything a resume must restore, keyed: params, aux heads,
    residuals, scheduler rows, env state."""
    st = trainer.save_state()
    st.pop("params"), st.pop("aux")
    ef = st.pop("ef", {})
    flat = ckpt._flatten(st)
    for cid, e in ef.items():
        flat.update({f"ef/{cid}/{k}": v for k, v in _flat({"c": e["c"], "a": e["a"]}).items()})
        flat[f"ef/{cid}/tier"] = np.asarray(e["tier"])
    flat.update({f"params/{k}": v for k, v in _flat(trainer.params).items()})
    flat.update({f"aux/{k}": v for k, v in _flat(trainer.aux).items()})
    return flat


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resume_is_bit_for_bit(tmp_path, case):
    flags = BASE + CASES[case]
    path = str(tmp_path / "state.npz")
    straight, st = _port_run(flags + ["--rounds", "4"])
    first, _ = _port_run(flags + ["--rounds", "2", "--out-ckpt", path, "--save-every", "2"])
    assert [log.round for log in first] == [0, 1]
    resumed, rt = _port_run(flags + ["--rounds", "4", "--resume", path])
    assert [log.round for log in resumed] == [2, 3]
    for a, b in zip(straight[2:], resumed):
        assert [getattr(b, f) for f in LOG_FIELDS] == [getattr(a, f) for f in LOG_FIELDS]
    want, got = _state(st), _state(rt)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if "topk" in case or case == "population":
        assert st._ef and sorted(rt._ef) == sorted(st._ef)
    if case == "pairing":
        assert any(log.hosts for log in straight), "expected peer-hosted rounds"
        assert rt.sched.last_hosts == st.sched.last_hosts
    if case == "population":
        assert rt.env.save_state()["switch_rounds"].size == 0
        assert rt.sched.clients.touched() == st.sched.clients.touched()


def _within(got, want, unit):
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(
        jax.tree.leaves(to_numpy_tree(got)), jax.tree.leaves(jax.tree.map(np.asarray, want)))])
    assert d.max() <= 0.5 * unit, d.max() / unit
    assert np.quantile(d, 0.99) <= 0.1 * unit, np.quantile(d, 0.99) / unit
    assert np.median(d) <= 0.01 * unit, np.median(d) / unit


@pytest.mark.parametrize("case", ["events-topk", "pairing"])
def test_jax_envelope_resumes_in_the_port(tmp_path, case):
    flags = BASE + CASES[case]
    path = str(tmp_path / "jax.npz")
    jparse = lambda extra: jtrain.spec_from_args(jtrain.build_parser().parse_args(flags + extra))
    jfed = jparse(["--rounds", "4"]).build()
    jlogs = jfed.run()
    jparse(["--rounds", "2", "--out-ckpt", path, "--save-every", "2"]).build().run()
    spec = ttrain.spec_from_args(ttrain.build_parser().parse_args(
        flags + ["--rounds", "4", "--resume", path]))
    fed = spec.build(device="cpu")
    tlogs = fed.run()
    assert [log.round for log in tlogs] == [2, 3]
    for a, b in zip(jlogs[2:], tlogs):
        assert (b.clock, b.straggler, b.assignment, b.uplink_bytes, b.hosts) == \
            (a.clock, a.straggler, a.assignment, a.uplink_bytes, a.hosts)
    tt, jt = fed.trainer, jfed.trainer
    unit = 1e-3 * 2 * max(c.n_batches for c in tt.clients)
    _within(tt.params, jt.params, unit)
    if tt.codec.stateful:
        assert sorted(tt._ef) == sorted(jt._ef)
        assert {c: s["tier"] for c, s in tt._ef.items()} == {c: s["tier"] for c, s in jt._ef.items()}


def test_port_envelope_resumes_in_jax(tmp_path):
    flags = BASE + CASES["events-topk"]
    path = str(tmp_path / "port.npz")
    tlogs, _ = _port_run(flags + ["--rounds", "4"])
    _port_run(flags + ["--rounds", "2", "--out-ckpt", path, "--save-every", "2"])
    jspec = jtrain.spec_from_args(jtrain.build_parser().parse_args(
        flags + ["--rounds", "4", "--resume", path]))
    jlogs = jspec.build().run()
    assert [log.round for log in jlogs] == [2, 3]
    for a, b in zip(tlogs[2:], jlogs):
        assert (b.clock, b.straggler, b.assignment, b.uplink_bytes) == \
            (a.clock, a.straggler, a.assignment, a.uplink_bytes)


def test_rejections_carry_the_jax_messages(tmp_path):
    path = str(tmp_path / "state.npz")
    _port_run(BASE + ["--rounds", "1", "--out-ckpt", path])
    # a different experiment: the spec stamp does not verify
    other = BASE + ["--rounds", "2", "--resume", path, "--lr", "5e-3"]
    with pytest.raises(SpecError, match="different experiment") as te:
        ttrain.spec_from_args(ttrain.build_parser().parse_args(other)).build(
            device="cpu").run()
    with pytest.raises(JSpecError, match="different experiment") as je:
        jtrain.spec_from_args(jtrain.build_parser().parse_args(other)).build().run()
    assert str(te.value) == str(je.value)
    with pytest.raises(SystemExit):
        ttrain.main(other + ["--device", "cpu"])
    # an async envelope into a sync engine
    fed = ttrain.spec_from_args(ttrain.build_parser().parse_args(
        BASE + ["--rounds", "1"])).build(device="cpu")
    apath = str(tmp_path / "async.npz")
    save_train_state(apath, fed.trainer, round_=5, clock=10.0, engine="async")
    for engine in ("rounds", "events"):
        with pytest.raises(ValueError, match="written by engine='async'"):
            fed.trainer.run(6, fed.eval_batch, engine=engine, resume=ckpt.load(apath))
    # resume under async, resume with churn: refused by the spec and the engines
    for extra, match in ((["--engine", "async"], "resume supports"),
                         (["--engine", "events", "--churn"], "churn")):
        argv = BASE + ["--rounds", "2", "--resume", path] + extra
        with pytest.raises(SpecError, match=match) as te:
            ttrain.spec_from_args(ttrain.build_parser().parse_args(argv))
        with pytest.raises(JSpecError) as je:
            jtrain.spec_from_args(jtrain.build_parser().parse_args(argv))
        assert str(te.value) == str(je.value)
    env = ckpt.load(path)
    with pytest.raises(ValueError, match="async engine's in-flight wave queue"):
        fed.trainer.run(2, fed.eval_batch, engine="async", resume=env)
    from repro_torch.api import _churn_model

    churn = _churn_model(ExperimentSpec.from_dict(
        {"engine": {"name": "events", "churn": {}}, "data": {"clients": 4}}))
    with pytest.raises(ValueError, match="resume with churn is unsupported"):
        fed.trainer.run(2, fed.eval_batch, engine="events", churn=churn, resume=env)


def _fed(argv):
    return ttrain.spec_from_args(ttrain.build_parser().parse_args(BASE + argv)).build(
        device="cpu")


def _assert_state_equal(got_trainer, want_trainer):
    want, got = _state(want_trainer), _state(got_trainer)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trainer_save_restore_and_federation_resume(tmp_path):
    """``Federation.save`` / ``DTFLTrainer.save`` then ``restore`` into a
    trainer of another seed gives back the params, aux heads, scheduler
    rows, env state and EF residuals bit for bit; ``restore`` also unwraps
    a ``save_train_state`` envelope; ``Federation.resume(path)`` continues
    a run as ``--resume`` does, and refuses another experiment's envelope
    (the counterpart of ``tests/test_features.py``'s trainer checkpoint
    test)."""
    flags = ["--codec", "topk0.05"]
    src = _fed(flags + ["--rounds", "2"])
    src.run()
    assert src.trainer._ef
    bare = str(tmp_path / "bare.npz")
    src.save(bare)
    dst = _fed(flags + ["--rounds", "2", "--seed", "1"])
    assert not torch.equal(tree_leaves(dst.trainer.params)[0],
                           tree_leaves(src.trainer.params)[0])
    dst.trainer.restore(bare)
    _assert_state_equal(dst.trainer, src.trainer)
    assert [c.tier for c in dst.trainer.sched.clients] == \
        [c.tier for c in src.trainer.sched.clients]
    assert np.isfinite(dst.trainer.run(1, dst.eval_batch)[-1].acc)

    envelope = str(tmp_path / "envelope.npz")
    save_train_state(envelope, src.trainer, round_=2, clock=src.logs[-1].clock,
                     rng=np.random.default_rng(0), acc=src.logs[-1].acc)
    again = _fed(flags + ["--rounds", "2", "--seed", "2"])
    again.trainer.restore(envelope)
    _assert_state_equal(again.trainer, src.trainer)

    # Federation.resume(path) against an uninterrupted run and --resume
    path = str(tmp_path / "state.npz")
    straight = _fed(flags + ["--rounds", "4"])
    straight.run()
    _fed(flags + ["--rounds", "2", "--out-ckpt", path, "--save-every", "2"]).run()
    resumed = _fed(flags + ["--rounds", "4"])
    assert resumed.resume(path) is resumed
    logs = resumed.run()
    assert [log.round for log in logs] == [2, 3]
    for a, b in zip(straight.logs[2:], logs):
        assert [getattr(b, f) for f in LOG_FIELDS] == [getattr(a, f) for f in LOG_FIELDS]
    _assert_state_equal(resumed.trainer, straight.trainer)
    with pytest.raises(SpecError, match="different experiment"):
        _fed(flags + ["--rounds", "4", "--lr", "5e-3"]).resume(path)
