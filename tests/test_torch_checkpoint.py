"""The port's checkpoint module (``repro_torch.checkpoint``) against the JAX
package's (``repro/checkpoint/__init__.py``).

  * The round trips of ``tests/test_checkpoint.py`` on the port's module:
    plain and empty containers, a NamedTuple through its port class, torch
    tensor leaves, the rng stream continuing after ``pack_rng`` /
    ``unpack_rng``, a non-PCG64 generator rejected, a bf16 leaf rejected,
    and a NamedTuple tag with no port class rejected.
  * Byte compatibility, both ways: an envelope written by one package
    loads in the other with every key path and every array equal to what
    the writer's own ``load`` gives, on a tree with NamedTuples and on a
    DTFL trainer's resume envelope (top-k residuals, pairing hosts).
"""
import collections
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.core.local_loss import DTFLState
from repro.fed.adapter import DTFLStepState as JStepState
from repro.fed.engine import save_train_state as jsave_train_state
from repro.launch import train as jtrain
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.fed.adapter import DTFLStepState
from repro_torch.fed.engine import save_train_state
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_map

torch.set_num_threads(2)


def roundtrip(tmp_path, tree):
    p = os.path.join(str(tmp_path), "ck.npz")
    ckpt.save(p, tree)
    return ckpt.load(p)


def _structure(tree):
    """Container types and keys, leaves replaced by None."""
    return tree_map(lambda _: None, tree) if not isinstance(tree, np.ndarray) else None


def test_namedtuple_structure_preserved(tmp_path):
    opt = optim.adam(1e-3)
    params = {"w": torch.ones((3, 2)), "b": torch.zeros(2)}
    tree = {
        "step": DTFLStepState(params, params, params,
                              opt.init(params), opt.init(params), opt.init(params)),
        "mixed": [1, ("a-tuple", np.arange(3)), {"k": (np.float32(2.5),)}],
    }
    out = roundtrip(tmp_path, tree)
    assert isinstance(out["step"], DTFLStepState)
    assert isinstance(out["step"].c_opt, dict) and set(out["step"].c_opt) == {"lr", "t", "m", "v"}
    assert _structure(out) == _structure(tree)
    _same_flat(ckpt._flatten(out), ckpt._flatten(tree))    # every leaf, keyed, with its dtype


def test_plain_containers_round_trip(tmp_path):
    tree = {"l": [np.arange(2), [np.arange(3)]], "t": (np.float64(1.5),),
            "scalar": np.int32(7), "tensor": torch.arange(4, dtype=torch.int64)}
    out = roundtrip(tmp_path, tree)
    assert _structure(out) == _structure(tree)
    assert isinstance(out["t"], tuple) and isinstance(out["l"], list)
    np.testing.assert_array_equal(out["tensor"], np.arange(4))
    assert out["scalar"].dtype == np.int32


def test_empty_containers_round_trip(tmp_path):
    tree = {"teacher": {}, "l": [], "t": (),
            "nt": DTFLStepState({"w": np.ones(2)}, {}, [],
                                (np.arange(2),), {"m": {}}, np.int32(1)),
            "nested": {"a": {}, "b": [np.ones(1)]}}
    out = roundtrip(tmp_path, tree)
    assert _structure(out) == _structure(tree)
    assert out["teacher"] == {} and out["l"] == [] and out["t"] == ()
    assert out["nt"].aux == {} and out["nt"].server == []
    assert int(out["nt"].s_opt) == 1  # fields did not shift


def test_rng_pack_roundtrip_continues_stream():
    g = np.random.default_rng(123)
    g.random(7)
    g.integers(0, 50, 11)
    h = ckpt.unpack_rng(ckpt.pack_rng(g))
    np.testing.assert_array_equal(g.random(16), h.random(16))
    np.testing.assert_array_equal(g.choice(100, 8, replace=False),
                                  h.choice(100, 8, replace=False))
    # the same vector as the JAX package's
    g2 = np.random.default_rng(5)
    g2.random(3)
    np.testing.assert_array_equal(ckpt.pack_rng(g2), jckpt.pack_rng(g2))


def test_rng_pack_rejects_non_pcg64():
    legacy = np.random.Generator(np.random.MT19937(0))
    with pytest.raises(ValueError, match="PCG64"):
        ckpt.pack_rng(legacy)


@pytest.mark.parametrize("leaf", ["torch", "numpy"])
def test_bf16_leaf_rejected(tmp_path, leaf):
    x = (torch.ones(3, dtype=torch.bfloat16) if leaf == "torch"
         else np.ones(3, dtype=ml_dtypes.bfloat16))
    p = os.path.join(str(tmp_path), "ck.npz")
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(p, {"w": x})
    assert not os.path.exists(p)


def test_unmapped_namedtuple_tag_rejected(tmp_path):
    """A JAX-package NamedTuple tag with no port class gives a clear error,
    and nothing of the JAX package is imported to resolve it. Every
    NamedTuple of the JAX package now has a port class (the dry-run brought
    ``repro.core.local_loss.DTFLState``), so the unmapped tag is a stand-in
    class named into that module; ``DTFLState`` loads as the port's."""
    p = os.path.join(str(tmp_path), "ck.npz")
    retired = collections.namedtuple("RetiredState", ["a"], module="repro.core.local_loss")
    jckpt.save(p, {"s": retired(np.zeros(1))})
    with pytest.raises(ValueError, match="repro_torch.core.local_loss.RetiredState"):
        ckpt.load(p)
    jckpt.save(p, {"s": DTFLState(*(np.zeros(1),) * 6)})
    loaded = ckpt.load(p)["s"]
    assert type(loaded).__module__ == "repro_torch.core.local_loss"
    assert type(loaded).__name__ == "DTFLState"


# ---------------------------------------------------------------------------
# byte compatibility with the JAX package
# ---------------------------------------------------------------------------

def _raw(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _same_flat(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_tree():
    opt = joptim.adam(1e-3)
    params = {"w": np.arange(6, dtype=np.float32).reshape(3, 2), "b": np.zeros(2, np.float32)}
    return {"step": JStepState(params, params, params,
                               opt.init(params), opt.init(params), opt.init(params)),
            "empty": {}, "l": [np.int64(3), ()], "rng": jckpt.pack_rng(np.random.default_rng(1))}


def test_jax_tree_loads_in_the_port(tmp_path):
    p = str(tmp_path / "j.npz")
    jckpt.save(p, _jax_tree())
    out = ckpt.load(p)
    assert isinstance(out["step"], DTFLStepState)
    # flattened again, the port's tree gives the file's own key paths
    _same_flat(ckpt._flatten(out), _raw(p))
    _same_flat(ckpt._flatten(out), jckpt._flatten(jckpt.load(p)))


def test_port_tree_loads_in_jax(tmp_path):
    """The JAX tree's arrays as torch tensors in the port's classes: the
    port writes the same file, which loads in the JAX package."""
    jtree = jax.tree.map(np.asarray, _jax_tree())
    to_torch = lambda t: tree_map(torch.from_numpy, t)
    tree = {**jtree, "step": DTFLStepState(*map(to_torch, jtree["step"]))}
    p, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ckpt.save(p, tree)
    jckpt.save(pj, _jax_tree())
    out = jckpt.load(p)
    assert isinstance(out["step"], JStepState)
    _same_flat(_raw(p), _raw(pj))                     # the same bytes of every array
    _same_flat(jckpt._flatten(jax.tree.map(np.asarray, out)), ckpt._flatten(ckpt.load(p)))


FLAGS = ["--arch", "resnet-56", "--clients", "4", "--rounds", "2", "--samples", "200",
         "--batch-size", "16", "--codec", "topk0.05", "--topology", "pairing", "--exec", "loop"]


def test_trainer_envelopes_cross_both_ways(tmp_path):
    """Resume envelopes of a 2-round DTFL run with top-k residuals and
    pairing hosts, one written by each package: each loads in the other
    with the writer's key paths and arrays."""
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    fed = jtrain.spec_from_args(jtrain.build_parser().parse_args(FLAGS)).build()
    fed.run()
    jsave_train_state(jp, fed.trainer, round_=2, clock=1.5, rng=np.random.default_rng(3),
                      acc=0.25, engine="events")
    tt, ev = ttrain.build(ttrain.build_parser().parse_args(FLAGS + ["--device", "cpu"]))
    tt.run(2, ev)
    save_train_state(tp, tt, round_=2, clock=1.5, rng=np.random.default_rng(3),
                     acc=0.25, engine="events")
    for path in (jp, tp):
        env = ckpt.load(path)
        _same_flat(ckpt._flatten(env), jckpt._flatten(jax.tree.map(np.asarray, jckpt.load(path))))
        _same_flat(ckpt._flatten(env), _raw(path))
    # the two envelopes hold the same key paths, but for the "key" the
    # port does not write
    jkeys, tkeys = set(_raw(jp)), set(_raw(tp))
    assert jkeys - tkeys == {"d:trainer/d:key"} and not tkeys - jkeys
    assert any(k.startswith("d:trainer/d:ef/") for k in tkeys)
    assert "d:trainer/d:sched/d:host_of" in tkeys
