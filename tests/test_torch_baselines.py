"""The port's full-model baselines (``repro_torch/fed/{base,fedavg,fedyogi,
splitfed,tifl,dropstrag,fedat}.py``) against the JAX package's; FedGKT is
in ``tests/test_torch_fedgkt.py``.

  * ``kd_loss``: forward and gradient, with and without a pad mask, at
    temperature 1 and 2, per client against ``jax.vmap`` of the JAX
    function: within 1e-6 of the largest magnitude (measured: 1.2e-7).
  * ``full_loss`` of both adapters (the reduced ResNet-56; SmolLM-360M
    reduced to 6 layers, 4 heads over 2 KV heads, 4 modules, in fp32):
    forward and gradient per client, within 1e-5 of each leaf's largest
    magnitude.
  * Three rounds of each trainer, built from the same CLI flags in both
    packages (the reduced ResNet-56 priced on the full one, 4 clients, 200
    samples, batch 16, Adam 1e-3); the port starts from the JAX trainer's
    state, carried over as its envelope (``save_state`` -> numpy ->
    ``load_state``). The JAX side runs its cohort plane; the port runs
    each of its three planes (cohort, loop, chunks of 2).
    EXACT: every round's clock, straggler, uplink bytes and log
    assignment; each round's trained clients (drop30's kept set, TiFL's
    tier); TiFL's speed profiles and rotation; FedAT's speed groups and
    merge clocks.
    CLOSE, in U = lr x (local steps in the run): parameters within max
    0.5 U, 99th percentile 0.1 U, median 0.01 U, the bounds of
    ``tests/test_torch_planes.py``. FedYogi's global parameters are
    written by the server's Yogi step, whose size is about ``server_lr``
    (0.05) a round whatever the pseudo-gradient's size, and which scales a
    pseudo-gradient element below its ``eps`` (1e-3) by up to
    ``server_lr / eps`` = 50: its U is ``server_lr`` x rounds (measured:
    max 0.69 client U, 0.055 server U). With ``topk0.05`` the residuals
    are held as in ``tests/test_torch_planes.py`` (the same clients, at
    most 5% of entries flipped, 99th percentile 0.2 U, median 0.01 U),
    except for their max: a full-model residual holds the whole unsent
    part of every local step so far, up to about 1 U itself (0.913 U
    here), and where top-k keeps an entry on one side and not on the
    other, in this round or an earlier one, the two residuals differ by up
    to that entry; so the max is held to 1 U (measured on the three
    planes: max 0.913 U, 99th percentile 0.159 U, median 0.0025 U, 1.8%
    flipped; parameters max 0.451 U).
  * Refusals with the JAX package's messages: SplitFed and FedGKT refuse
    a non-identity codec, FedYogi, FedGKT, TiFL and drop30 the async
    engine.
  * Resume: FedAvg (identity and top-k), TiFL and FedYogi resume bit for
    bit on the CPU; a FedAvg envelope crosses between the packages both
    ways.
  * The paper's headline: DTFL's clock beats FedAvg's on the ResNet-110
    cost table; FedAT's async clock beats its own synchronous clock.
"""
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.resnet_cifar import RESNET56 as JRESNET56
from repro.fed.adapter import ResNetAdapter as JResNetAdapter
from repro.fed.adapter import TransformerAdapter as JTransformerAdapter
from repro.fed.base import kd_loss as jkd_loss
from repro.launch import train as jtrain
from repro_torch import checkpoint as ckpt
from repro_torch import presets
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.configs import get_config
from repro_torch.configs.resnet_cifar import RESNET56
from repro_torch.fed.adapter import ResNetAdapter, TransformerAdapter
from repro_torch.fed.base import kd_loss
from repro_torch.fed.dtfl import _value_and_grad
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_map

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
BASE = ["--arch", "resnet-56", "--clients", "4", "--samples", "200", "--batch-size", "16",
        "--lr", "1e-3"]
FLAGS = BASE + ["--rounds", "3"]
LR = 1e-3
BOUNDS = (0.5, 0.1, 0.01)
EF_BOUNDS = (1.0, 0.2, 0.01)
FLIPS = 0.05
LOG_FIELDS = ("round", "clock", "straggler", "assignment", "uplink_bytes", "hosts")


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max() / scale)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_kd_loss_matches_jax(temp, masked):
    rng = np.random.default_rng(0)
    s = rng.normal(0, 2, (3, 8, 10)).astype(np.float32)
    t = rng.normal(0, 2, (3, 8, 10)).astype(np.float32)
    w = None
    if masked:
        w = np.ones((3, 8), np.float32)
        w[1, 5:] = 0.0
        w[2, 1:] = 0.0
    jl, jg = jax.vmap(jax.value_and_grad(lambda a, b, m: jkd_loss(a, b, temp, m)),
                      in_axes=(0, 0, None if w is None else 0))(s, t, w)
    ts = torch.from_numpy(s).requires_grad_(True)
    tl = kd_loss(ts, torch.from_numpy(t), temp, None if w is None else torch.from_numpy(w))
    assert tl.shape == (3,)
    tg, = torch.autograd.grad(tl.sum(), ts)
    _close(tl.detach(), jl, 1e-6, "loss")
    _close(tg, jg, 1e-6, "grad")


def _resnet_case(seed):
    cfg, jcfg = RESNET56.reduced(), JRESNET56.reduced()
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(2, 16, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.float32)
    mask[1, 11:] = 0.0       # the second client's batch is partial
    return (ResNetAdapter(cfg), JResNetAdapter(jcfg),
            {"images": images, "labels": labels, "mask": mask})


def _smollm_case(seed):
    red = dict(n_layers=6, n_kv_heads=2, n_modules=4, dtype="float32")
    cfg = get_config("smollm-360m").reduced().replace(**red)
    jcfg = jget_config("smollm-360m").reduced().replace(**red)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (2, 4, 33)).astype(np.int32)
    return (TransformerAdapter(cfg, seq_len=32), JTransformerAdapter(jcfg, seq_len=32),
            {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]})


CASES = {"resnet": _resnet_case, "smollm": _smollm_case}


def _two_models(jad):
    """Two JAX inits stacked on a client axis (numpy)."""
    ps = [jad.init_global(jax.random.PRNGKey(k)) for k in (0, 1)]
    return jax.tree.map(lambda a, b: np.stack([np.asarray(a), np.asarray(b)]), *ps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_loss_matches_jax(case):
    """Per-client forward and gradient of ``full_loss`` on a cohort of two
    clients with different weights and batches."""
    tad, jad, batch = CASES[case](3)
    params = _two_models(jad)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jad.full_loss)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, _, tg = _value_and_grad(lambda p: (tad.full_loss(p, tb), None),
                                from_numpy_tree(params, "cpu"))
    assert tl.shape == (2,)
    _close(tl, jl, 1e-5, "loss")
    for g, w in zip(jax.tree.leaves(to_numpy_tree(tg)), jax.tree.leaves(jg)):
        for c in range(2):
            _close(g[c], np.asarray(w)[c], 1e-5, ("grad", g.shape, c))


# ---------------------------------------------------------------------------
# three rounds against the JAX cohort plane
# ---------------------------------------------------------------------------

RUNS = {
    "fedavg": ["--method", "fedavg"],
    "fedavg-int8": ["--method", "fedavg", "--codec", "int8"],
    "fedavg-topk": ["--method", "fedavg", "--codec", "topk0.05"],
    "fedyogi": ["--method", "fedyogi"],
    "tifl": ["--method", "tifl"],
    "drop30": ["--method", "drop30"],
    "splitfed": ["--method", "splitfed"],
    "fedat": ["--method", "fedat", "--n-groups", "2"],
}
# FedAT merges with a staleness weight other than the default, through the
# spec's trainer options (the knob run_async takes)
OPTIONS = {"fedat": {"staleness_lambda": 0.5}}
PLANES = {"cohort": [], "loop": ["--exec", "loop"],
          "chunked2": ["--exec", "chunked", "--chunk-size", "2"]}


def spy(trainer) -> dict:
    """Record a trainer's hook results as the engine calls them: each
    round's trained clients, each round's extra serial seconds, the async
    speed groups. Works on either package's trainer."""
    rec = {"trained": [], "extra": []}
    plan_round, execute_round, groups = (trainer.plan_round, trainer.execute_round,
                                         trainer.async_groups)

    def plan(r, participants):
        p = plan_round(r, participants)
        rec["trained"].append(list(p.trained))
        return p

    def execute(r, p, trained):
        extra = execute_round(r, p, trained)
        rec["extra"].append(float(extra))
        return extra

    def async_groups(cids, n):
        rec["groups"] = groups(cids, n)
        return rec["groups"]

    trainer.plan_round, trainer.execute_round, trainer.async_groups = plan, execute, async_groups
    return rec


def spec(pkg, flags, options=None):
    s = pkg.spec_from_args(pkg.build_parser().parse_args(flags))
    return s.with_overrides({"trainer.options": options}) if options else s


def jax_state(jt) -> dict:
    """The JAX trainer's envelope body as numpy: what the port loads."""
    return jax.tree.map(np.asarray, jt.save_state())


_JAX = {}


def jax_run(case, flags, options=None):
    """The JAX package's cohort-plane run of ``flags`` (cached per case):
    (initial state, trainer, logs, hook record)."""
    if case not in _JAX:
        fed = spec(jtrain, flags, options).build()
        init = jax_state(fed.trainer)
        rec = spy(fed.trainer)
        _JAX[case] = (init, fed.trainer, fed.run(), rec)
    return _JAX[case]


def port_run(flags, init, options=None):
    fed = spec(ttrain, flags, options).build(device="cpu")
    fed.trainer.load_state(init)
    rec = spy(fed.trainer)
    return fed.trainer, fed.run(), rec


def _leaves(tree):
    if torch.is_tensor(jax.tree.leaves(tree)[0]):
        tree = to_numpy_tree(tree)
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def within(got, want, unit, bounds, what):
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(_leaves(got), _leaves(want))])
    stats = (d.max() / unit, np.quantile(d, 0.99) / unit, np.median(d) / unit)
    assert all(s <= b for s, b in zip(stats, bounds)), (what, stats)


def logs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert [getattr(b, f) for f in LOG_FIELDS] == [getattr(a, f) for f in LOG_FIELDS]


def client_unit(trainer, rounds=3):
    return LR * rounds * max(c.n_batches for c in trainer.clients)


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("case", sorted(RUNS))
def test_baseline_matches_jax_cohort(case, plane):
    flags = FLAGS + RUNS[case]
    init, jt, jlogs, jrec = jax_run(case, flags, OPTIONS.get(case))
    tt, tlogs, trec = port_run(flags + PLANES[plane], init, OPTIONS.get(case))
    assert tt.exec_plan.mode == ("cohort" if plane == "cohort" else PLANES[plane][1])
    logs_equal(tlogs, jlogs)
    assert trec == jrec
    unit = client_unit(tt)
    if case == "fedyogi":
        unit = tt.server_opt_state["lr"] * 3
        within(tt.server_opt_state["m"], jt.server_opt_state["m"], unit, BOUNDS, "yogi m")
    within(tt.params, jt.params, unit, BOUNDS, "params")
    if case == "tifl":
        assert (tt._speed_obs, tt._round_robin) == (jt._speed_obs, jt._round_robin)
        assert len({tuple(t) for t in trec["trained"]}) == 3, "expected every tier once"
    if case == "drop30":
        assert all(len(t) == 3 for t in trec["trained"]), trec   # ceil(0.7 * 4)
    if case == "fedat":
        assert len(trec["groups"]) == 2 and len(tlogs) == 1 + 3 * 2
        assert tt.staleness_lambda == 0.5
    if case == "fedavg-topk":
        assert sorted(tt._ef) == sorted(jt._ef) == [0, 1, 2, 3]
        flips = total = 0
        for cid in jt._ef:
            within(tt._ef[cid], jt._ef[cid], unit, EF_BOUNDS, f"ef {cid}")
            for g, w in zip(_leaves(tt._ef[cid]), _leaves(jt._ef[cid])):
                flips += int(((g == 0) != (w == 0)).sum())
                total += g.size
        assert flips <= FLIPS * total, (flips, total)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSALS = [("splitfed", "codec"), ("fedgkt", "codec"), ("fedyogi", "async"),
            ("fedgkt", "async"), ("tifl", "async"), ("drop30", "async")]


@pytest.mark.parametrize("method,what", REFUSALS, ids=[f"{m}-{w}" for m, w in REFUSALS])
def test_refusals_carry_the_jax_messages(method, what):
    """A non-identity codec at construction (``repro/fed/base.py:75-79``),
    the async engine in ``run`` (``:236-242``); the spec refuses both
    before, so the trainers are built directly."""
    from repro import optim as joptim
    from repro import registry as jregistry
    from repro_torch import optim, registry

    flags = FLAGS + ["--method", method, "--rounds", "1"]
    tfed = spec(ttrain, flags).build(device="cpu")
    jfed = spec(jtrain, flags).build()
    errors = []
    for reg, fed, opt, kw in ((registry, tfed, optim, {"device": "cpu"}),
                              (jregistry, jfed, joptim, {})):
        cls = reg.trainers.load(method)
        with pytest.raises(ValueError, match=what) as e:
            if what == "codec":
                cls(fed.adapter, fed.clients, fed.env, opt.adam(1e-3), codec="int8", **kw)
            else:
                fed.trainer.run(1, fed.eval_batch, engine="async")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

def cli_run(flags):
    got = {}
    logs = ttrain.main(flags + ["--device", "cpu"], on_round=lambda tr, log: got.update(tr=tr))
    return logs, got["tr"]


def flat_state(trainer) -> dict:
    """The trainer's whole envelope body, keyed, as numpy."""
    host = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x
    return ckpt._flatten(tree_map(host, trainer.save_state()))


def states_equal(got, want):
    got, want = flat_state(got), flat_state(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


RESUME = {"fedavg": ["--method", "fedavg"],
          "fedavg-topk": ["--method", "fedavg", "--codec", "topk0.05"],
          "tifl": ["--method", "tifl"], "fedyogi": ["--method", "fedyogi"]}


@pytest.mark.parametrize("case", sorted(RESUME))
def test_resume_is_bit_for_bit(tmp_path, case):
    """3 rounds straight against 2 with ``--out-ckpt`` then 3 with
    ``--resume``: round 2's log and the whole trainer state (parameters,
    env, residuals, TiFL's profile and rotation, FedYogi's server
    optimizer) equal, element for element; ``save`` then ``restore`` gives
    it back; ``compact`` drops the residuals of the clients it is not
    told to keep."""
    flags = BASE + RESUME[case]
    path = str(tmp_path / "state.npz")
    straight, st = cli_run(flags + ["--rounds", "3"])
    first, _ = cli_run(flags + ["--rounds", "2", "--out-ckpt", path, "--save-every", "2"])
    resumed, rt = cli_run(flags + ["--rounds", "3", "--resume", path])
    assert [log.round for log in resumed] == [2]
    logs_equal(resumed, straight[2:])
    assert resumed[0].acc == straight[2].acc
    states_equal(rt, st)
    # a bare save() restores into the resumed trainer as the envelope did
    bare = str(tmp_path / "bare.npz")
    st.save(bare)
    rt.restore(bare)
    states_equal(rt, st)
    if case == "fedavg-topk":
        assert sorted(rt._ef) == [0, 1, 2, 3]
        rt.compact([0, 2])
        assert sorted(rt._ef) == [0, 2]
    if case == "tifl":
        assert rt._round_robin == st._round_robin == 3


def test_fedavg_envelope_crosses_packages(tmp_path):
    """A JAX FedAvg envelope written at round 2 resumes in the port (the
    spec stamps verify), and the port's in the JAX package: round 2's log
    equals the writer's uninterrupted run, parameters within the bounds
    (U over round 2's local steps)."""
    flags = BASE + ["--method", "fedavg", "--codec", "int8"]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jstraight = spec(jtrain, flags + ["--rounds", "3"]).build()
    jlogs = jstraight.run()
    spec(jtrain, flags + ["--rounds", "2", "--out-ckpt", jpath, "--save-every", "2"]).build().run()
    tfed = spec(ttrain, flags + ["--rounds", "3", "--resume", jpath]).build(device="cpu")
    logs_equal(tfed.run(), jlogs[2:])
    within(tfed.trainer.params, jstraight.trainer.params,
           client_unit(tfed.trainer, rounds=1), BOUNDS, "params")
    tlogs, _ = cli_run(flags + ["--rounds", "3"])
    cli_run(flags + ["--rounds", "2", "--out-ckpt", tpath, "--save-every", "2"])
    logs_equal(spec(jtrain, flags + ["--rounds", "3", "--resume", tpath]).build().run(),
               tlogs[2:])


# ---------------------------------------------------------------------------
# the paper's headline, the CLI and the examples
# ---------------------------------------------------------------------------

def test_dtfl_round_clock_beats_fedavg():
    """``tests/test_system.py:47-63``: priced on the full ResNet-110 cost
    table, DTFL's straggler-bounded clock is below FedAvg's."""
    base = presets.quickstart(rounds=4, clients=5)
    dtfl = base.build(device="cpu").run()
    fedavg = base.with_overrides({"trainer.method": "fedavg"}).build(device="cpu").run()
    assert dtfl[-1].clock < fedavg[-1].clock
    assert dtfl[-1].straggler < fedavg[-1].straggler


def test_fedat_async_beats_own_sync_clock():
    """``tests/test_events.py:198-209``: for the same number of aggregate
    updates, FedAT's async clock (group stragglers) is below its own
    synchronous clock (global stragglers)."""
    s = presets.quickstart(clients=6).with_overrides(
        {"trainer.method": "fedat", "data.samples": 240, "engine.n_groups": 2})
    fed = s.build(device="cpu")
    async_logs = fed.trainer.run(2, fed.eval_batch, n_groups=2)
    sync = s.build(device="cpu")
    sync_logs = sync.trainer.run(len(async_logs), sync.eval_batch, engine="rounds")
    assert async_logs[-1].clock < sync_logs[-1].clock


METHODS = ["fedavg", "fedyogi", "splitfed", "fedgkt", "tifl", "drop30", "fedat"]


@pytest.mark.parametrize("method", METHODS)
def test_every_baseline_runs_from_the_cli(method, monkeypatch, capsys):
    """``--method <m>`` trains on the CPU when asked and raises "no CUDA
    device" without a card."""
    argv = ["--method", method, "--arch", "resnet-micro", "--clients", "2", "--samples", "40",
            "--rounds", "1"] + (["--n-groups", "2"] if method == "fedat" else [])
    logs = ttrain.main(argv + ["--device", "cpu"])
    assert len(logs) == (3 if method == "fedat" else 1)
    assert all(np.isfinite(log.acc) for log in logs)
    assert f"[train] {method} resnet-micro" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(argv)


@pytest.mark.parametrize("example,argv", [
    ("torch_quickstart.py", ["--rounds", "1", "--clients", "2"]),
    ("torch_dtfl_cifar.py", ["--rounds", "1", "--clients", "3"]),
])
def test_examples_compare_dtfl_with_fedavg_on_the_cpu(example, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [example] + argv + ["--device", "cpu"])
    runpy.run_path(str(ROOT / "examples" / example), run_name="__main__")
    out = capsys.readouterr().out
    assert "fedavg" in out and "speedup" in out
