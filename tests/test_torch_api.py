"""The port's spec front end (``repro_torch.api``, ``registry``,
``presets`` and the CLI's flags -> spec translation) against the JAX
package's.

  * Every preset of ``repro/presets.py``, at its defaults and at a few
    overrides: the port's ``to_json()``, ``spec_hash()`` and
    ``program_key()`` equal the JAX package's, and ``from_json`` of the
    JAX JSON gives an equal port spec.
  * Unknown fields, illegal combinations and unknown names raise
    ``SpecError`` with the JAX package's message, word for word
    (``tests/test_api.py:28-125``'s cases).
  * The registries hold the same names, choices and spec-time metadata.
  * ``spec_from_args`` gives the JAX CLI's spec JSON for a set of argvs;
    ``--out``, ``--out-spec`` and ``--target-acc`` run on the CPU.
  * ``reuse=`` is accepted but adopts nothing (the port compiles no
    programs): a reused Federation trains as a fresh one.
  * A component the port does not have yet is registered, its spec
    validates and hashes, and building it raises "not yet ported".
"""
import json

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import presets as jpresets
from repro import registry as jregistry
from repro.launch import train as jtrain
from repro_torch import presets, registry
from repro_torch.api import ExperimentSpec, SpecError
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

OVERRIDES = [
    {},
    {"rounds": 7, "seed": 3, "trainer.lr": "0.005"},
    {"codec.name": " TOPK0.05 ", "exec.mode": "chunked", "exec.chunk_size": 4},
    {"engine.name": "events", "engine.churn.drop": 0.2},
    {"trainer.scheduler": "dynamic:2", "env.profiles": "case1"},
    {"checkpoint.path": "state.npz", "checkpoint.every": 3},
]


def _both(name, over):
    """The preset in each package, or the SpecError each raises."""
    out = []
    for mod, err in ((jpresets, japi.SpecError), (presets, SpecError)):
        try:
            out.append(mod.PRESETS[name]().with_overrides(over))
        except err as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_presets_serialize_and_hash_as_jax(name):
    assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)
    n_specs = 0
    for over in OVERRIDES:
        j, t = _both(name, over)
        if isinstance(j, str):
            assert t == j, over
            continue
        n_specs += 1
        assert t.to_json() == j.to_json(), over
        assert t.to_json(indent=1) == j.to_json(indent=1)
        assert t.spec_hash() == j.spec_hash(), over
        assert t.program_key() == j.program_key(), over
        assert t.identity_dict() == j.identity_dict()
        back = ExperimentSpec.from_json(j.to_json())
        assert back == t and back.spec_hash() == j.spec_hash()
    assert n_specs >= 1


@pytest.mark.parametrize("bad", [
    {"bogus": 1},
    {"trainer": {"lrr": 0.1}},
    {"engine": {"name": "events", "churn": {"dropp": 0.5}}},
    {"trainer": {"method": "dynmaic"}},
    {"trainer": {"scheduler": "dynmaic"}},
    {"trainer": {"scheduler": "static"}},
    {"codec": {"name": "zip9"}},
    {"codec": {"name": "topk"}},
    {"exec": {"mode": "warp"}},
    {"exec": {"mode": "cohort", "chunk_size": 4}},
    {"engine": {"name": "asink"}},
    {"data": {"dataset": "imagenet"}},
    {"data": {"clients": 0}},
    {"model": {"arch": "resnet-13"}},
    {"model": {"cost_model": "smollm-360m"}},
    {"env": {"profiles": "fast"}},
    {"env": {"profiles": []}},
    {"trainer": {"method": "fedgkt"}, "codec": {"name": "int8"}},
    {"trainer": {"method": "splitfed"}, "codec": {"name": "topk0.1"}},
    {"engine": {"churn": {}}},
    {"engine": {"name": "async"}, "checkpoint": {"resume": "x.npz"}},
    {"trainer": {"method": "fedat"}, "checkpoint": {"resume": "x.npz"}},
    {"engine": {"name": "events", "churn": {}}, "checkpoint": {"resume": "x.npz"}},
    {"trainer": {"method": "fedyogi"}, "engine": {"name": "async"}},
    {"trainer": {"method": "fedavg", "scheduler": 2}},
    {"trainer": {"topology": "pairing", "scheduler": 1}},
    {"model": {"arch": "smollm-360m"}},
    {"data": {"dataset": "lm"}},
    {"data": {"population": 100}, "engine": {"name": "async"}},
    {"trainer": {"sample_size": 4}, "engine": {"name": "async"}},
    {"trainer": {"patch_shuffle": True}, "model": {"arch": "xlstm-350m"},
     "data": {"dataset": "lm"}},
    {"participation": 0.0},
])
def test_invalid_specs_fail_with_the_jax_message(bad):
    with pytest.raises(japi.SpecError) as je:
        japi.ExperimentSpec.from_dict(bad)
    with pytest.raises(SpecError) as te:
        ExperimentSpec.from_dict(bad)
    assert str(te.value) == str(je.value)


def test_with_overrides_errors_match_jax():
    for over in ({"trainer.method": "nope"}, {"nope.x": 1},
                 {"engine.churn.drop": 0.2}):
        with pytest.raises(japi.SpecError) as je:
            jpresets.quickstart().with_overrides(over)
        with pytest.raises(SpecError) as te:
            presets.quickstart().with_overrides(over)
        assert str(te.value) == str(je.value)


def test_registries_match_jax():
    keys = ("supports_async", "supports_codec", "scheduler_aware", "async_native",
            "provides_hosts", "kind", "n_classes", "noise", "seed", "identity", "sync",
            "pattern", "scheduler")
    for name in ("trainers", "schedulers", "codecs", "engines", "exec_modes", "datasets",
                 "archs", "profile_pools", "topologies"):
        t, j = getattr(registry, name), getattr(jregistry, name)
        assert (t.kind, t.names(), t.choices()) == (j.kind, j.names(), j.choices()), name
        for n in j.names():
            tm, jm = t._entries[n], j._entries[n]
            assert {k: tm.get(k) for k in keys} == {k: jm.get(k) for k in keys}, (name, n)
    assert registry.ASSIGNED_ARCH_NAMES == jregistry.ASSIGNED_ARCH_NAMES
    for spec in ("dynamic:2", " pairing:hungarian", "3", "TOPK0.05".lower(), "none"):
        for name in ("schedulers", "codecs"):
            t, j = getattr(registry, name), getattr(jregistry, name)
            assert (spec in t) == (spec in j)
            if spec in j:
                assert t.validate(spec) == j.validate(spec)


def test_unported_components_are_registered_and_refused():
    unported = {"trainers": [],
                "archs": [n for n in registry.ASSIGNED_ARCH_NAMES
                          if n not in ("smollm-360m", "xlstm-350m")],
                "exec_modes": ["sharded"]}
    for name, names in unported.items():
        reg = getattr(registry, name)
        assert sorted(n for n in reg.names() if not reg.is_ported(n)) == sorted(names)
        for n in names:
            with pytest.raises(NotImplementedError, match="not yet ported"):
                reg.load(n) if name == "trainers" else reg.build(n)
    for spec in (presets.llm("yi-6b"), presets.llm("granite-3-2b"),
                 presets.llm("deepseek-67b"), presets.table4_wall(exec_mode="sharded", devices=2),
                 presets.llm("hymba-1.5b"), presets.table4_wall(devices=2)):
        assert spec.spec_hash() == japi.ExperimentSpec.from_json(spec.to_json()).spec_hash()
        with pytest.raises(NotImplementedError, match="not yet ported"):
            spec.build(device="cpu")


ARGVS = [
    [],
    ["--arch", "resnet-micro", "--clients", "3", "--rounds", "2", "--codec", "int8"],
    ["--engine", "async", "--n-groups", "2", "--participation", "0.5"],
    ["--engine", "events", "--churn", "--churn-drop", "0.3", "--churn-rejoin", "3"],
    ["--population", "1000", "--sample-size", "8", "--exec", "chunked", "--chunk-size", "4",
     "--codec", "topk0.05"],
    ["--topology", "pairing", "--exec", "loop"],
    ["--scheduler", "dynamic:2", "--dataset", "cinic10", "--iid", "--seed", "4"],
    ["--arch", "smollm-360m", "--full-size", "--seq-len", "512", "--batch-size", "4"],
    ["--arch", "xlstm-350m", "--dcor-alpha", "0.0", "--lr", "2e-3"],
    ["--out-ckpt", "s.npz", "--save-every", "0", "--resume", "r.npz", "--target-acc", "0.5"],
    ["--engine", "auto", "--switch-every", "5", "--samples", "900"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults" for a in ARGVS])
def test_spec_from_args_matches_jax_cli(argv):
    jspec = jtrain.spec_from_args(jtrain.build_parser().parse_args(argv))
    targs = ttrain.build_parser().parse_args(argv)
    assert targs.device == "cuda"
    tspec = ttrain.spec_from_args(targs)
    assert tspec.to_json() == jspec.to_json()
    assert tspec.spec_hash() == jspec.spec_hash()


def test_cli_rejects_bad_knobs_at_parse_time(capsys):
    for argv in (["--scheduler", "dynmaic"], ["--codec", "zip9"], ["--method", "fedsgd"],
                 ["--exec", "warp"], ["--engine", "asink"], ["--dataset", "imagenet"]):
        with pytest.raises(SystemExit):
            ttrain.main(argv)
        assert "registered" in capsys.readouterr().err, argv
    with pytest.raises(SystemExit):
        ttrain.main(["--churn", "--device", "cpu"])
    assert "churn requires" in capsys.readouterr().err


def test_cli_out_out_spec_and_target_acc(tmp_path, capsys):
    argv = ["--arch", "resnet-micro", "--clients", "3", "--samples", "120", "--rounds", "3",
            "--device", "cpu"]
    out, out_spec = str(tmp_path / "logs.json"), str(tmp_path / "spec.json")
    logs = ttrain.main(argv + ["--out", out, "--out-spec", out_spec, "--target-acc", "0.0"])
    assert len(logs) == 1                     # the target is met after round 0
    rows = json.load(open(out))
    assert [r["round"] for r in rows] == [0] and rows[0]["clock"] == logs[0].clock
    text = open(out_spec).read()
    jspec = jtrain.spec_from_args(jtrain.build_parser().parse_args(
        argv[:-2] + ["--target-acc", "0.0"]))
    assert text == jspec.to_json(indent=1)
    assert ExperimentSpec.from_json(text) == ttrain.spec_from_args(
        ttrain.build_parser().parse_args(argv + ["--target-acc", "0.0"]))
    assert japi.ExperimentSpec.from_json(text) == jspec
    assert "[train] dtfl resnet-micro: 1 rounds" in capsys.readouterr().out


def test_jax_spec_json_builds_a_port_federation():
    """A JAX preset's JSON builds the port's Federation on the CPU; its
    first round's clock, tiers and uplink bytes equal the JAX run's."""
    jspec = jpresets.quickstart(rounds=1)
    tfed = ExperimentSpec.from_json(jspec.to_json()).build(device="cpu")
    assert tfed.trainer.device.type == "cpu"
    assert tfed.trainer._spec_stamp["hash"] == jspec.spec_hash()
    jlog, tlog = jspec.build().run()[0], tfed.run()[0]
    assert (tlog.clock, tlog.assignment, tlog.uplink_bytes) == \
        (jlog.clock, jlog.assignment, jlog.uplink_bytes)


def test_reuse_adopts_programs_when_the_program_key_matches():
    """The port runs eagerly, so there is no compiled program to adopt:
    ``reuse=`` is accepted whether ``program_key`` matches or not, leaves
    ``programs_reused`` False (what the sweep's CSV column reads), and the
    reused Federation trains bit for bit as a fresh one. Its trainer's own
    codec sees its own uploads."""
    spec = presets.quickstart(rounds=1, clients=2).with_overrides({"codec.name": "int8"})
    first = spec.build(device="cpu")
    first.run()
    same = spec.with_overrides({"seed": 3, "data.clients": 3})
    assert same.program_key() == spec.program_key()
    second = same.build(reuse=first, device="cpu")
    other = spec.with_overrides({"codec.name": "bf16"})
    assert other.program_key() != spec.program_key()
    assert not second.programs_reused
    assert not other.build(reuse=first, device="cpu").programs_reused
    uploads = []
    real = second.trainer.codec.tree_rt
    second.trainer.codec.tree_rt = lambda t: uploads.append(1) or real(t)
    fresh = same.build(device="cpu")
    a, b = second.run()[0], fresh.run()[0]
    assert uploads
    assert (a.clock, a.assignment, a.acc) == (b.clock, b.assignment, b.acc)
    for x, y in zip(tree_leaves(second.trainer.params), tree_leaves(fresh.trainer.params)):
        assert torch.equal(x, y)


def test_federation_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        presets.quickstart(rounds=1).build()
    assert presets.quickstart(rounds=1).build(device="cpu").trainer.device.type == "cpu"
    assert np.isfinite(presets.quickstart(rounds=1, clients=2).build(device="cpu").run()[0].acc)
