"""The port's sharded plane (``fed/execplan.py``'s ``sharded`` mode,
``launch/mesh.py``, ``core/aggregation.py::combine_weighted_sums`` and the
trainers' one path of every plane) on the CPU over gloo, against the port's cohort
plane and the JAX package's cohort plane; the padding policy, the plan's
validation and the aggregation module's leftovers.

The JAX side runs its cohort plane only. Its sharded plane fails with the
installed JAX before it compares anything: JAX rejects the ``lax.scan``
inside ``shard_map`` with a ``TypeError`` raised at
``src/repro/fed/cohort.py:169`` (the optimizer state's varying-axis type
does not match the carry's), which is why ``tests/test_sharded.py``'s
one-device tests fail too. The JAX package documents its sharded plane as
the cohort plane's math (``src/repro/fed/execplan.py:1-21``,
``src/repro/fed/dtfl.py:375-382``), so the cohort plane is the reference.

  * One rank (a gloo group on a ``HashStore``, in this process), the CLI's
    reduced ResNet-56, 4 clients, 200 samples, batch 16, 3 rounds: bit-equal
    to the port's cohort plane in parameters, aux heads, residuals and
    every log field but ``wall_s`` (host seconds), for DTFL with
    ``topk0.05`` and ``int8`` and FedAvg with ``int8``; every baseline that
    trains through ``_train_round_full`` at ``resnet-micro``, too.
  * Two ranks (spawned once, gloo on a ``FileStore``, one thread each), 5
    clients of ragged Dirichlet sizes with ``topk0.05``, so the tier
    cohorts pad to an even width. EXACT: every round's clock, tiers,
    uplink bytes and straggler against both cohort planes. CLOSE, against
    the port's cohort plane from the same initial weights: parameters, aux
    heads and residuals within ``tests/test_torch_planes.py``'s
    ``BOUNDS``, ``EF_BOUNDS`` and ``FLIPS`` in its U (lr x 3 rounds x the
    most batches a client has); each rank's products run at half the
    cohort's width and the weighted sums add across the ranks, the same
    kind of difference as the chunked plane's there. The same clients hold
    residuals at the same tiers. Only rank 0 prints and writes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_sharded_ranks
from repro.core import aggregation as jagg
from repro.core import splitting as jsplit
from repro.launch import train as jtrain
from repro_torch import checkpoint as ckpt
from repro_torch.bridge import from_numpy_tree
from repro_torch.core import aggregation as tagg
from repro_torch.fed import cohort as cohort_engine
from repro_torch.fed.execplan import ExecPlan
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import init_client_group
from repro_torch.tree import tree_leaves
from test_torch_planes import BOUNDS, EF_BOUNDS, FLIPS, _ef_within, _within

torch.set_num_threads(1)
FLAGS = ["--arch", "resnet-56", "--clients", "4", "--rounds", "3", "--samples", "200",
         "--batch-size", "16", "--lr", "1e-3", "--device", "cpu"]
TWO_RANK_FLAGS = ["--arch", "resnet-56", "--clients", "5", "--rounds", "3", "--samples", "200",
                  "--batch-size", "16", "--lr", "1e-3", "--codec", "topk0.05"]
MICRO = ["--arch", "resnet-micro", "--clients", "3", "--samples", "60", "--rounds", "2",
         "--device", "cpu"]


@pytest.fixture
def no_group():
    """No process group before the test, none after it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _run(flags):
    got = {}
    logs = ttrain.main(flags, on_round=lambda tr, log: got.update(trainer=tr))
    return got["trainer"], logs


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _log_fields(log):
    return {k: v for k, v in log.__dict__.items() if k != "wall_s"}


# ---------------------------------------------------------------------------
# one rank, in process: bit for bit the cohort plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,codec", [("dtfl", "topk0.05"), ("dtfl", "int8"),
                                          ("fedavg", "int8")])
def test_one_rank_bit_equals_cohort(no_group, method, codec):
    flags = FLAGS + ["--method", method, "--codec", codec]
    base, blogs = _run(flags)
    sharded, slogs = _run(flags + ["--exec", "sharded"])
    assert sharded.exec_plan.describe() == "sharded[clients=1]"
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert [_log_fields(x) for x in slogs] == [_log_fields(x) for x in blogs]
    assert _bit_equal(sharded.params, base.params)
    if method == "dtfl":
        assert sorted(sharded.aux) == sorted(base.aux)
        assert all(_bit_equal(sharded.aux[m], base.aux[m]) for m in base.aux)
    assert sorted(sharded._ef) == sorted(base._ef)
    assert (len(base._ef) > 0) == (codec == "topk0.05")
    for cid, st in base._ef.items():
        if method == "dtfl":
            assert sharded._ef[cid]["tier"] == st["tier"]
            assert _bit_equal((sharded._ef[cid]["c"], sharded._ef[cid]["a"]), (st["c"], st["a"]))
        else:
            assert _bit_equal(sharded._ef[cid], st)


@pytest.mark.parametrize("method,extra", [
    ("fedavg", ["--codec", "topk0.05"]), ("fedyogi", ["--codec", "int8"]), ("splitfed", []),
    ("tifl", ["--codec", "int8"]), ("drop30", ["--codec", "int8"]),
    ("fedat", ["--n-groups", "2", "--codec", "int8"]), ("fedgkt", [])])
def test_one_rank_baselines_bit_equal_cohort(no_group, method, extra):
    """Every baseline on one rank: FedGKT trains outside the plane, as the
    JAX package's does; the others through the sharded branch."""
    flags = MICRO + ["--method", method] + extra
    base, blogs = _run(flags)
    sharded, slogs = _run(flags + ["--exec", "sharded", "--devices", "1"])
    assert sharded.exec_plan.mode == "sharded"
    assert [_log_fields(x) for x in slogs] == [_log_fields(x) for x in blogs]
    assert _bit_equal(sharded.params, base.params)
    assert sorted(sharded._ef) == sorted(base._ef)
    assert all(_bit_equal(sharded._ef[c], base._ef[c]) for c in base._ef)


# ---------------------------------------------------------------------------
# two ranks, spawned once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank CLI run and the gather check: rank 0's envelope and
    logs, each rank's printed lines and gathered tree, the files written."""
    d = tmp_path_factory.mktemp("sharded")
    gather, printed = str(d / "gather"), str(d / "printed")
    argv = TWO_RANK_FLAGS + ["--exec", "sharded", "--devices", "2", "--device", "cpu",
                             "--out", str(d / "logs.json"), "--out-ckpt", str(d / "state.npz"),
                             "--save-every", "2"]
    mp.spawn(torch_sharded_ranks.train_rank, args=(2, str(d / "store"), gather, argv, printed),
             nprocs=2, join=True)
    env = ckpt.load(str(d / "state.npz"))
    logs = json.loads((d / "logs.json").read_text())
    for log in logs:
        log["assignment"] = {int(k): v for k, v in log["assignment"].items()}
    lines = {r: open(f"{printed}.{r}").read() for r in (0, 1)}
    gathered = {r: list(np.load(f"{gather}.{r}.npz").values()) for r in (0, 1)}
    files = sorted(p.name for p in d.iterdir())
    return env, logs, lines, gathered, files


@pytest.fixture(scope="module")
def cohort_runs():
    """The JAX package's and the port's cohort planes with the two-rank
    run's flags; the port from its own initial weights, as the ranks."""
    jlogs = jtrain.spec_from_args(jtrain.build_parser().parse_args(TWO_RANK_FLAGS)).build().run()
    tt, tlogs = _run(TWO_RANK_FLAGS + ["--device", "cpu"])
    return jlogs, tt, tlogs


def test_two_ranks_gather_clients_concatenates_slices(two_ranks):
    _, _, _, gathered, _ = two_ranks
    width = torch_sharded_ranks.GATHER_COLS // 2
    want = [np.concatenate(xs) for xs in zip(
        *[[x.numpy() for x in tree_leaves(torch_sharded_ranks.gather_slices(r, width))]
          for r in (0, 1)])]
    for r in (0, 1):
        assert len(gathered[r]) == len(want)
        for g, w in zip(gathered[r], want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_two_ranks_logs_exact_against_both_cohort_planes(two_ranks, cohort_runs):
    _, logs, _, _, _ = two_ranks
    jlogs, _, tlogs = cohort_runs
    assert len(logs) == len(jlogs) == len(tlogs) == 3
    for got, j, t in zip(logs, jlogs, tlogs):
        key = (got["clock"], got["assignment"], got["uplink_bytes"], got["straggler"])
        assert key == (j.clock, j.assignment, j.uplink_bytes, j.straggler)
        assert key == (t.clock, t.assignment, t.uplink_bytes, t.straggler)
    assert len({t for log in logs for t in log["assignment"].values()}) > 1, \
        "expected more than one tier cohort"


def test_two_ranks_cohorts_pad(cohort_runs):
    """The run's tier cohorts are ragged: some pad to the even width."""
    _, tt, tlogs = cohort_runs
    pads = [co.n_pad for r, log in enumerate(tlogs)
            for co in cohort_engine.build_cohorts(tt.clients, sorted(log.assignment),
                                                  log.assignment, r, 1, pad_multiple=2)]
    assert 1 in pads, pads


def test_two_ranks_params_aux_residuals_within_bounds(two_ranks, cohort_runs):
    env, _, _, _, _ = two_ranks
    _, tt, _ = cohort_runs
    state = env["trainer"]
    unit = 1e-3 * 3 * max(c.n_batches for c in tt.clients)
    _within(from_numpy_tree(state["params"], "cpu"), tt.params, unit, BOUNDS, "params")
    assert sorted(int(m) for m in state["aux"]) == sorted(tt.aux)
    for m, a in state["aux"].items():
        _within(from_numpy_tree(a, "cpu"), tt.aux[int(m)], unit, EF_BOUNDS, f"aux {m}")
    ef = {int(c): {"tier": int(st["tier"]), "c": from_numpy_tree(st["c"], "cpu"),
                   "a": from_numpy_tree(st["a"], "cpu")} for c, st in state["ef"].items()}
    assert len(ef) == 5
    _ef_within(ef, tt._ef, unit)


def test_two_ranks_only_rank0_prints_and_writes(two_ranks):
    env, logs, printed, _, files = two_ranks
    assert printed[0].count("[dtfl] r=") == 3 and "[train] dtfl resnet-56: 3 rounds" in printed[0]
    assert printed[1] == ""
    assert "logs.json" in files and "state.npz" in files
    assert int(env["round"]) == 3 and len(logs) == 3


# ---------------------------------------------------------------------------
# padding policy and validation (tests/test_sharded.py:136-173)
# ---------------------------------------------------------------------------

def _clients(sizes, batch=16):
    from repro_torch.data.pipeline import ClientDataset
    from repro_torch.data.synthetic import ClassImageTask
    from repro_torch.fed.client import SimClient

    task = ClassImageTask(n_classes=10, image_size=8)
    labels = np.random.default_rng(0).integers(0, 10, sum(sizes))
    clients, off = [], 0
    for i, s in enumerate(sizes):
        clients.append(SimClient(i, ClientDataset(task, labels, np.arange(off, off + s), batch),
                                 None))
        off += s
    return clients


def test_ragged_cohort_pads_to_rank_multiple():
    clients = _clients([64, 48, 16, 96, 32])  # one tier, 5 clients
    (co,) = cohort_engine.build_cohorts(clients, list(range(5)), {k: 0 for k in range(5)},
                                        r=0, local_epochs=1, pad_multiple=4)
    assert co.size == 5 and co.n_pad == 3
    for arr in co.batches.values():
        assert arr.shape[1] == 8
        np.testing.assert_array_equal(arr[:, co.size:], 0)  # pad columns zeroed
    assert not co.mask[:, co.size:].any()                   # pads never step
    w = co.client_weights(clients)
    assert w.shape == (8,) and (w[co.size:] == 0).all() and (w[:co.size] > 0).all()


def test_pad_multiple_one_is_identity():
    clients = _clients([64, 48])
    (ca,) = cohort_engine.build_cohorts(clients, [0, 1], {0: 0, 1: 0}, 0, 1)
    (cb,) = cohort_engine.build_cohorts(clients, [0, 1], {0: 0, 1: 0}, 0, 1, pad_multiple=1)
    assert cb.n_pad == 0 and ca.mask.shape == cb.mask.shape
    for name in ca.batches:
        np.testing.assert_array_equal(ca.batches[name], cb.batches[name])


def test_execplan_validation(no_group):
    with pytest.raises(ValueError, match="unknown exec mode"):
        ExecPlan(mode="warp")
    with pytest.raises(ValueError, match="process group"):
        ExecPlan(mode="sharded")          # no group initialised
    with pytest.raises(ValueError, match="process group"):
        ExecPlan.resolve("sharded")       # a plan reads the group, never makes it
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc-per-node 2"):
        init_client_group(2, "cpu")
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc-per-node 3"):
        ttrain.main(MICRO + ["--exec", "sharded", "--devices", "3"])
    assert not dist.is_initialized()
    assert ExecPlan.resolve(None).mode == "cohort"
    assert ExecPlan.resolve("loop").mode == "loop"
    assert ExecPlan().pad_multiple == 1 and ExecPlan().rank == 0 and ExecPlan().lead
    assert ExecPlan().max_over_ranks(2.5, "cpu") == 2.5
    assert ExecPlan.from_flags("cohort", devices=2).mode == "cohort"  # as the JAX CLI
    assert ExecPlan().slices(6) == [slice(0, 6)]
    assert ExecPlan(mode="loop").slices(2) == [slice(0, 1), slice(1, 2)]
    assert ExecPlan(mode="chunked", chunk_size=2).slices(4) == [slice(0, 2), slice(2, 4)]
    assert init_client_group(None, "cpu") == torch.device("cpu")
    plan = ExecPlan.resolve("sharded")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert (plan.n_shards, plan.rank, plan.pad_multiple) == (1, 0, 1)
    assert plan.describe() == "sharded[clients=1]"
    assert plan.width(6) == 6 and plan.shard_slice(6) == slice(0, 6)
    assert plan.slices(6) == [slice(0, 6)]
    assert ExecPlan.sharded(devices=1) == plan
    with pytest.raises(RuntimeError, match="differs"):
        ExecPlan.sharded(devices=2)       # a group of 1 rank is not 2 ranks
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc-per-node 2"):
        init_client_group(2, "cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        ExecPlan(mode="sharded", chunk_size=4)
    # a 1-rank all-reduce and gather change nothing
    tree = {"a": torch.arange(6.0).reshape(3, 2), "b": [torch.ones(3, dtype=torch.float64)]}
    assert _bit_equal(plan.gather_clients(tree, 3), tree)
    assert _bit_equal(plan.all_reduce_tree(tree), tree)
    w = np.array([1.0, 2.0, 0.0], np.float32)
    assert _bit_equal(plan.all_reduce_tree(tree, scaled_by=w),
                      {"a": torch.tensordot(torch.tensor(w), tree["a"], dims=1),
                       "b": [torch.tensordot(torch.tensor(w), tree["b"][0].float(), dims=1)]})
    assert plan.max_over_ranks(1.5, "cpu") == 1.5


# ---------------------------------------------------------------------------
# core/aggregation.py against the JAX package's
# ---------------------------------------------------------------------------

def _np_tree(rng, lead=()):
    return {"stem": rng.standard_normal(lead + (3, 4)).astype(np.float32),
            "blocks": [{"w": rng.standard_normal(lead + (4, 4)).astype(np.float32)}
                       for _ in range(3)],
            "fc": rng.standard_normal(lead + (4,)).astype(np.float32)}


def _close_np(got, want):
    from repro_torch.bridge import to_numpy_tree

    for g, w in zip(jax.tree.leaves(to_numpy_tree(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_weighted_sums_matches_jax_and_cohort_average(seed):
    """Per-cohort fp32 sums and totals: the port's combine equals the JAX
    package's combine and its cohort average within fp32 rounding."""
    rng = np.random.default_rng(seed)
    stacked = [_np_tree(rng, (n,)) for n in (3, 2, 4)]
    ws = [rng.integers(10, 90, len(tree_leaves(s)[0])).astype(np.float32) for s in stacked]
    tstacked = [from_numpy_tree(s, "cpu") for s in stacked]
    sums = [tagg.weighted_sum(t, w) for t, w in zip(tstacked, ws)]
    totals = [torch.tensor(w).sum() for w in ws]
    got = tagg.combine_weighted_sums(sums, totals, like=tstacked[0])
    jsums = [jax.tree.map(lambda x, w=w: jnp.tensordot(jnp.asarray(w), x, axes=1), s)
             for s, w in zip(stacked, ws)]
    _close_np(got, jagg.combine_weighted_sums(jsums, [w.sum() for w in ws], like=stacked[0]))
    _close_np(got, jagg.weighted_average_cohorts(stacked, ws))


@pytest.mark.parametrize("seed", [0, 1])
def test_uniform_average_and_aggregate_dtfl_round_match_jax(seed):
    rng = np.random.default_rng(seed)
    trees = [_np_tree(rng) for _ in range(4)]
    _close_np(tagg.uniform_average([from_numpy_tree(t, "cpu") for t in trees]),
              jagg.uniform_average(trees))
    # transformer-shaped trees (stacked blocks) split at each client's tier
    full = [{"embed": rng.standard_normal((5, 4)).astype(np.float32),
             "blocks": {"w": rng.standard_normal((6, 4, 4)).astype(np.float32)},
             "final_ln": rng.standard_normal((4,)).astype(np.float32),
             "lm_head": rng.standard_normal((4, 5)).astype(np.float32)} for _ in range(3)]
    states = [(b, *jsplit.split_params(f, b, jsplit.TRANSFORMER)) for f, b in zip(full, (1, 3, 5))]
    weights = [30.0, 50.0, 20.0]
    want = jagg.aggregate_dtfl_round(None, states, weights)
    got = tagg.aggregate_dtfl_round(
        None, [(t, from_numpy_tree(jax.tree.map(np.asarray, c), "cpu"),
                from_numpy_tree(jax.tree.map(np.asarray, s), "cpu")) for t, c, s in states],
        weights)
    _close_np(got, want)
    assert tuple(got["blocks"]["w"].shape) == (6, 4, 4)
