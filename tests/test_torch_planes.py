"""The port's execution planes and the top-k codec with error feedback, in
3-round DTFL runs against the JAX package's cohort plane and against the
port's own cohort plane.

The model is the CLI's reduced resnet-56 (3 tiers) priced on the full
ResNet-56; 4 clients, 200 samples (Dirichlet non-IID), batch 16, Adam
1e-3, ``--codec topk0.05``. Both packages are built from the same CLI
flags; the port starts from the JAX trainer's round-0 weights and aux
heads. The JAX side always runs its cohort plane: its own cross-plane
identities fail on this machine and are not leaned on.

  * EXACT: the clock, tier assignment and uplink bytes of every round, and
    which clients hold residuals, at which tier.
  * CLOSE, in U = lr * (local steps in the run): the parameters within
    max 0.5 U, 99th percentile 0.1 U, median 0.01 U, as
    ``tests/test_torch_dtfl.py`` holds the int8 run (measured here: max
    0.087 U, 99th percentile 0.016 U, median 0.0003 U, on every plane).
    The residuals, and the aux heads (one tier-2 head is one client's
    top-k upload), within max 0.5 U, 99th percentile 0.2 U, median 0.01 U,
    and at most 5% of the residual entries "flipped" (zero on one side
    only: kept by top-k on one side and not on the other, or an exact zero
    against rounding noise). Adam's early steps are about lr * sign(g), so
    an update delta is close to a multiple of lr and many entries sit near
    the k-th magnitude: an fp32 ordering difference flips some of them, and
    a flipped or sign-changed entry moves by up to 2 lr (0.133 U here).
    Measured: max and 99th percentile 0.133 U (the re-tiered client),
    median at most 0.0005 U per client and leaf group, 3.5% flipped. A
    wrong mask, row or residual moves the median by O(U).

The port's own planes against its cohort plane: chunked is bit-equal to
cohort, residuals too, when every program has at least two client columns
on both sides (a one-column program takes other matrix-product paths and
rounds differently: a tier cohort of one client meets a padded chunk of
two); it is tested bit-equal with every client on tier 0, and within the
bounds above when tiers change (measured: parameters max 0.061 U, 0.3%
of residual entries flipped). The loop plane runs one column per client,
so it is held to the bounds above (measured: parameters max 0.076 U, 3.4%
flipped). Its int8 uploads are held bit-equal to the JAX package's
per-tensor int8, one scale per leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.launch import train as jtrain
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
FLAGS = ["--arch", "resnet-56", "--clients", "4", "--rounds", "3", "--samples", "200",
         "--batch-size", "16", "--lr", "1e-3", "--codec", "topk0.05"]
BOUNDS = (0.5, 0.1, 0.01)
EF_BOUNDS = (0.5, 0.2, 0.01)
FLIPS = 0.05


def _leaves(tree):
    """numpy leaves in JAX's order (sorted dict keys) for either package."""
    if torch.is_tensor(tree_leaves(tree)[0]):
        tree = to_numpy_tree(tree)
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _within(got, want, unit, bounds, what):
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(_leaves(got), _leaves(want))])
    stats = (d.max() / unit, np.quantile(d, 0.99) / unit, np.median(d) / unit)
    assert all(s <= b for s, b in zip(stats, bounds)), (what, stats)


def _ef_within(got_ef, want_ef, unit):
    """Residuals: the same clients at the same tiers, values within
    EF_BOUNDS, entries zero on one side only (flips) at most FLIPS of all."""
    assert sorted(got_ef) == sorted(want_ef)
    flips = total = 0
    for cid in want_ef:
        assert got_ef[cid]["tier"] == want_ef[cid]["tier"]
        for key in ("c", "a"):
            _within(got_ef[cid][key], want_ef[cid][key], unit, EF_BOUNDS, f"ef {cid}{key}")
            for g, w in zip(_leaves(got_ef[cid][key]), _leaves(want_ef[cid][key])):
                flips += int(((g == 0) != (w == 0)).sum())
                total += g.size
    assert flips <= FLIPS * total, (flips, total)


def _port(flags, jt=None):
    """The port's trainer from CLI flags on the CPU, started from the JAX
    trainer ``jt``'s weights when given; returns (trainer, logs)."""
    args = ttrain.build_parser().parse_args(flags + ["--device", "cpu"])
    tt, eval_batch = ttrain.build(args)
    if jt is not None:
        tt.params = from_numpy_tree(jax.tree.map(np.asarray, jt.params), "cpu")
        tt.aux = {m: from_numpy_tree(jax.tree.map(np.asarray, a), "cpu")
                  for m, a in jt.aux.items()}
    return tt, tt.run(args.rounds, eval_batch)


@pytest.fixture(scope="module")
def jax_run():
    fed = jtrain.spec_from_args(jtrain.build_parser().parse_args(FLAGS)).build()
    jt = fed.trainer
    init = (jax.tree.map(np.asarray, jt.params),
            {m: jax.tree.map(np.asarray, a) for m, a in jt.aux.items()})
    logs = fed.run()
    return init, jt, logs


@pytest.mark.parametrize("plane", [[], ["--exec", "loop"], ["--exec", "chunked", "--chunk-size", "2"]],
                         ids=["cohort", "loop", "chunked2"])
def test_topk_planes_match_jax_cohort(jax_run, plane):
    (p0, a0), jt, jlogs = jax_run
    args = ttrain.build_parser().parse_args(FLAGS + plane + ["--device", "cpu"])
    tt, eval_batch = ttrain.build(args)
    assert tt.exec_plan.mode == (plane[1] if plane else "cohort")
    tt.params = from_numpy_tree(p0, "cpu")
    tt.aux = {m: from_numpy_tree(a, "cpu") for m, a in a0.items()}
    tlogs = tt.run(3, eval_batch)
    assert len(tlogs) == len(jlogs) == 3
    for a, b in zip(jlogs, tlogs):
        assert (b.clock, b.assignment, b.uplink_bytes, b.straggler) == \
            (a.clock, a.assignment, a.uplink_bytes, a.straggler)
    assert len({t for log in tlogs for t in log.assignment.values()}) > 1, \
        "expected a re-tiered client (its residuals restart at zero)"
    unit = 1e-3 * 3 * max(c.n_batches for c in tt.clients)
    _within(tt.params, jt.params, unit, BOUNDS, "params")
    for m in jt.aux:
        _within(tt.aux[m], jt.aux[m], unit, EF_BOUNDS, f"aux {m}")
    _ef_within(tt._ef, jt._ef, unit)


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("chunk", ["2", "3"])
def test_chunked_bit_equals_cohort_on_tier0(chunk):
    """Every client on tier 0 (``--scheduler 0``): one cohort of 4 against
    chunks of 2 (no pad) or of 3 (one pad column); parameters, aux heads
    and residuals bit for bit."""
    base, _ = _port(FLAGS + ["--scheduler", "0"])
    chunked, _ = _port(FLAGS + ["--scheduler", "0", "--exec", "chunked", "--chunk-size", chunk])
    assert _bit_equal(chunked.params, base.params)
    assert all(_bit_equal(chunked.aux[m], base.aux[m]) for m in base.aux)
    assert sorted(chunked._ef) == sorted(base._ef) == [0, 1, 2, 3]
    for cid in base._ef:
        assert _bit_equal((chunked._ef[cid]["c"], chunked._ef[cid]["a"]),
                          (base._ef[cid]["c"], base._ef[cid]["a"]))


@pytest.mark.parametrize("plane", [["--exec", "loop"], ["--exec", "chunked", "--chunk-size", "2"]],
                         ids=["loop", "chunked2"])
def test_planes_match_port_cohort(plane):
    """Tiers change in round 1, so one-column programs meet wider ones:
    logs exact, parameters and residuals within the bounds above."""
    base, blogs = _port(FLAGS)
    other, ologs = _port(FLAGS + plane)
    for a, b in zip(blogs, ologs):
        assert (b.clock, b.assignment, b.uplink_bytes) == (a.clock, a.assignment, a.uplink_bytes)
    unit = 1e-3 * 3 * max(c.n_batches for c in base.clients)
    _within(other.params, base.params, unit, BOUNDS, "params")
    _ef_within(other._ef, base._ef, unit)


def test_loop_plane_int8_uploads_per_tensor():
    """The trainer's loop plane with ``--codec int8``, one round: every
    uploaded leaf travels as one row (a client axis of 1), and its round
    trip equals the JAX package's per-tensor int8 (``Int8Codec.rt``, as
    its ``uplink_rt_one`` calls it) bit for bit, conv leaves whose first
    axis is 3 included. An upload quantized per first-axis slice fails."""
    args = ttrain.build_parser().parse_args(
        FLAGS + ["--codec", "int8", "--exec", "loop", "--rounds", "1", "--device", "cpu"])
    tt, eval_batch = ttrain.build(args)
    jc, inner, seen = jcodec.make_codec("int8"), tt.codec.tree_rt, []

    def spy(tree):
        out = inner(tree)
        for x, y in zip(tree_leaves(tree), tree_leaves(out)):
            assert x.shape[0] == 1, x.shape
            want = np.asarray(jc.rt(jnp.asarray(x[0].numpy())))
            np.testing.assert_array_equal(y[0].numpy(), want)
            seen.append(tuple(x.shape[1:]))
        return out

    tt.codec.tree_rt = spy
    tt.run(1, eval_batch)
    assert any(len(s) == 4 and s[0] == 3 and s[1] == 3 for s in seen), seen
