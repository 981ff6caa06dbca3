"""The transformer client loss with the distance-correlation regularizer
(``TransformerAdapter(dcor_alpha=...)``) against the JAX package on the CPU.

The loss is ``(1 - a) * (token_xent + 0.01 * moe_aux) + a * dcor(x_in,
z)``, with x_in the embedded tokens and z the uploaded activations
(``repro/fed/adapter.py:157-162``); its pairwise distances are kernel K2's
plain versions here. Config: SmolLM-360M reduced to 6 layers, 4 heads over
2 KV heads, 4 modules (``tests/test_torch_transformer.py``), untied, fp32;
2 clients x 4 sequences x 32 tokens, the second client's last sequence
masked out of the task loss (dcor sees every row, as in the JAX package).

  * loss: rtol 1e-5 (the task loss and dcor are O(1); measured 7.9e-7).
  * gradients of the client half and the aux head: atol 2e-3 times each
    leaf's largest magnitude. The squared distances' diagonal is fp32
    rounding noise on both sides (exact 0 in exact arithmetic) and its
    square root moves dcor's gradient by about 1e-3 of its largest
    magnitude (``tests/test_torch_step.py`` measures it on the ResNet).
    Measured: 7.4e-4 of a leaf's largest magnitude with dcor, 1.9e-6
    without it.
  * the CLI: ``--dcor-alpha`` reaches the transformer adapter, and a
    2-round reduced run (the CLI's reduced SmolLM-360M, bf16) has the JAX
    CLI's clocks, tiers, uplink bytes and stragglers exactly. Its
    parameters, from the JAX trainer's round-0 weights, are held in U = lr
    x local steps to the JAX package's own spread in bf16: the JAX run
    against itself from weights moved by one ulp in half their elements
    differs by max 0.50 U, 99th percentile 0.165 U, median 0.0011 U
    (0.41 / 0.165 / 0.0011 U without dcor), and the port against JAX by
    0.491 / 0.168 / 0.0015 U with dcor. Bounds: max 1 U, 99th
    percentile 0.3 U, median 0.01 U (the fp32 runs of
    ``tests/test_torch_dtfl.py`` are held to 0.5 / 0.1 / 0.01 U).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.fed.adapter import TransformerAdapter as JAdapter
from repro.launch import train as jtrain
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.configs import get_config
from repro_torch.fed.adapter import TransformerAdapter
from repro_torch.fed.dtfl import _value_and_grad
from repro_torch.launch import train as ttrain

torch.set_num_threads(2)
RED = dict(n_layers=6, n_kv_heads=2, n_modules=4, dtype="float32")
C, B, S = 2, 4, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab):
    rng = np.random.default_rng(0)
    mask = np.ones((C, B, S), bool)
    mask[1, -1] = False
    return {"tokens": rng.integers(0, vocab, (C, B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (C, B, S)).astype(np.int32),
            "mask": mask}


def _client_losses(alpha: float, tier: int):
    """(JAX, port) per-client losses and gradients w.r.t. (client half, aux
    head), from the JAX package's initial weights."""
    jfull, full = jget_config("smollm-360m"), get_config("smollm-360m")
    jad = JAdapter(jfull.reduced().replace(**RED), seq_len=S, cost_cfg=jfull, dcor_alpha=alpha)
    tad = TransformerAdapter(full.reduced().replace(**RED), seq_len=S, cost_cfg=full,
                             dcor_alpha=alpha)
    params = jax.jit(jad.init_global)(jax.random.PRNGKey(0))
    jc, _ = jad.split(params, tier)
    ja = jad.aux_init(jax.random.PRNGKey(1), tier)
    batch = _batch(jad.cfg.vocab)

    def one(cp, ap, b):
        (loss, _), g = jax.value_and_grad(
            lambda ca: jad.client_loss(ca[0], ca[1], b), has_aux=True)((cp, ap))
        return loss, g

    lift = lambda t: jnp.broadcast_to(t, (C,) + t.shape)           # noqa: E731
    jc2, ja2 = jax.tree.map(lift, jc), jax.tree.map(lift, ja)
    want, want_g = _np(jax.jit(jax.vmap(one))(jc2, ja2, jax.tree.map(jnp.asarray, batch)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tc, ta = from_numpy_tree(_np(jc2), "cpu"), from_numpy_tree(_np(ja2), "cpu")
    got, _, got_g = _value_and_grad(lambda ca: tad.client_loss(ca[0], ca[1], tb), (tc, ta))
    return want, want_g, got.numpy(), to_numpy_tree(got_g)


@pytest.mark.parametrize("tier", [0, 2])
def test_client_loss_and_gradients_match_jax(tier):
    want, want_g, got, got_g = _client_losses(0.5, tier)
    assert got.shape == (C,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    plain, _, _, _ = _client_losses(0.0, tier)
    assert np.abs(want - plain).min() > 1e-3        # the regularizer is in the loss
    leaves = jax.tree.leaves(got_g)
    assert len(leaves) == len(jax.tree.leaves(want_g))
    for g, w in zip(leaves, jax.tree.leaves(want_g)):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * np.abs(w).max())
    # the embedding gets dcor's gradient through x_in as well as the task's
    assert np.abs(got_g[0]["embed"]).max() > 0


def test_cli_dcor_alpha_reaches_the_transformer_and_matches_jax():
    flags = ["--arch", "smollm-360m", "--clients", "3", "--rounds", "2", "--batch-size", "4",
             "--seq-len", "32", "--dcor-alpha", "0.5", "--lr", "1e-3"]
    fed = jtrain.spec_from_args(jtrain.build_parser().parse_args(flags)).build()
    jt = fed.trainer
    tt, eval_batch = ttrain.build(ttrain.build_parser().parse_args(flags + ["--device", "cpu"]))
    assert type(tt.adapter) is TransformerAdapter
    assert tt.adapter.dcor_alpha == jt.adapter.dcor_alpha == 0.5
    tt.params = from_numpy_tree(_np(jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(_np(a), "cpu") for m, a in jt.aux.items()}

    jlogs = fed.run()
    tlogs = tt.run(2, eval_batch)
    assert len(tlogs) == len(jlogs) == 2
    for a, b in zip(jlogs, tlogs):
        assert (b.clock, b.assignment, b.uplink_bytes, b.straggler) == \
            (a.clock, a.assignment, a.uplink_bytes, a.straggler)
    unit = 1e-3 * 2 * max(c.n_batches for c in tt.clients)
    for got, want in [(tt.params, jt.params)] + [(tt.aux[m], jt.aux[m]) for m in jt.aux]:
        d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(
            jax.tree.leaves(to_numpy_tree(got)), jax.tree.leaves(_np(want)))])
        assert d.max() <= 1.0 * unit, d.max() / unit
        assert np.quantile(d, 0.99) <= 0.3 * unit, np.quantile(d, 0.99) / unit
        assert np.median(d) <= 0.01 * unit, np.median(d) / unit
