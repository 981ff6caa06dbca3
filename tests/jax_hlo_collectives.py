"""The JAX package's per-card FLOPs and collective bytes for the cases of
``tests/test_torch_dryrun_collectives*.py``, as one JSON object on stdout.

Run in a process of its own, as those tests do: it sets 8 host devices
before JAX starts. Each case is jitted on a (data 2, model 4) mesh of
``AxisType.Auto`` axes (``with_sharding_constraint`` refuses the default
explicit axes) under its in- and out-shardings, compiled, and read with
``repro.launch.hlo_analysis.analyze``: ``{"flops", "coll"}`` per case,
``coll`` the collective bytes by kind (result-shape bytes per card,
all-reduce twice). ``unit`` names the unit cases, ``moe`` one MoE layer,
``<model>-<kind>`` a whole step of a reduced config of ``CONFIGS``.

  JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_hlo_collectives.py unit moe smollm-train ...
"""
import os

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.launch import hlo_analysis, steps  # noqa: E402
from repro.models.shardctx import activation_sharding  # noqa: E402

MESH = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
# the unit cases' sizes (the torch side takes them from here too)
UNIT = dict(B=16, D=64, F=256, V=512)
MOE = dict(B=16, S=64)
# the reduced configs of the whole steps, and their input shapes
CONFIGS = {
    "smollm": ("smollm-360m", {"dtype": "float32"}),
    "yi": ("yi-6b", {"n_heads": 8, "n_kv_heads": 2, "head_dim": 16, "dtype": "float32"}),
    "dsmoe": ("deepseek-moe-16b", {"dtype": "float32"}),
    "scout": ("llama4-scout-17b-a16e", {"dtype": "float32"}),
    "pixtral": ("pixtral-12b", {"dtype": "float32"}),
    "whisper": ("whisper-base", {"dtype": "float32"}),
    "hymba": ("hymba-1.5b", {"dtype": "float32"}),
}
SHAPES = {
    "train": InputShape("train", 64, 16, "train"),
    "prefill": InputShape("prefill", 64, 16, "prefill"),
    "decode": InputShape("decode", 64, 16, "decode"),
}
TIER = 1


def reduced(name: str, cfg_module=get_config):
    arch, upd = CONFIGS[name]
    return cfg_module(arch).reduced().replace(**upd)


def _named(tree):
    return jax.tree.map(lambda s: NamedSharding(MESH, s) if isinstance(s, P) else s, tree,
                        is_leaf=lambda x: isinstance(x, P))


def _analyse(fn, args, in_specs, out_specs, act_specs=None) -> dict:
    with jax.set_mesh(MESH), activation_sharding(**_named(act_specs or {})):
        lowered = jax.jit(fn, in_shardings=_named(in_specs),
                          out_shardings=_named(out_specs)).lower(*args)
    hlo = hlo_analysis.analyze(lowered.compile().as_text())
    return {"flops": hlo["flops"], "coll": hlo["coll"]}


def unit_cases() -> dict:
    B, D, F, V = UNIT["B"], UNIT["D"], UNIT["F"], UNIT["V"]
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    out = {}
    # column-parallel then row-parallel: one all-reduce of the (B, D) output
    out["colrow"] = _analyse(lambda x, w1, w2: (x @ w1) @ w2,
                             (f32(B, D), f32(D, F), f32(F, D)),
                             (P("data", None), P(None, "model"), P("model", None)),
                             P("data", None))
    # an FSDP-sharded weight (rows over data, columns over model): the
    # forward y = x w, the backward dw = x^T dy
    w_spec = P("data", "model")
    out["fsdp"] = _analyse(lambda x, w, dy: (x @ w, x.T @ dy),
                           (f32(B, D), f32(D, D), f32(B, D)),
                           (P("data", None), w_spec, w_spec), (w_spec, w_spec))

    # vocab-sharded cross-entropy: per-token loss and its vjp
    def xent(logits, labels, g):
        per, vjp = jax.vjp(lambda lg: _per_token(lg, labels), logits)
        return per, vjp(g)[0]

    out["xent"] = _analyse(xent, (f32(B, V), jax.ShapeDtypeStruct((B,), jnp.int32), f32(B)),
                           (P("data", "model"), P("data"), P("data")),
                           (P("data"), P("data", "model")))
    return out


def moe_case() -> dict:
    """One ``moe_apply`` layer of the reduced deepseek-moe-16b (4 experts,
    top-2, 2 shared) on 16 x 64 tokens in the ``act`` layout, its
    parameters under their specs as one layer of a stack (the specs'
    layer axis dropped): the experts on the model axis."""
    from repro.launch.specs import tree_pspecs
    from repro.models.moe import moe_apply, moe_param_init

    cfg = reduced("dsmoe")
    stacked = jax.eval_shape(lambda: jax.tree.map(lambda t: t[None],
                                                  moe_param_init(jax.random.key(0), cfg)))
    specs = jax.tree.map(lambda s: P(*s[1:]), tree_pspecs(stacked, MESH),
                         is_leaf=lambda s: isinstance(s, P))
    params = jax.tree.map(lambda t: jax.ShapeDtypeStruct(t.shape[1:], t.dtype), stacked)
    x = jax.ShapeDtypeStruct((MOE["B"], MOE["S"], cfg.d_model), jnp.float32)
    act = P("data", None, "model")
    return _analyse(lambda x, p: moe_apply(x, p, cfg), (x, params), (act, specs), (act, P()))


def _per_token(logits, labels):
    """``token_xent``'s per-token term (``repro/core/local_loss.py:27``)."""
    lse = jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1)
    picked = jnp.take_along_axis(logits.astype(jnp.float32), labels[..., None], axis=-1)[..., 0]
    return lse - picked


def step_case(name: str) -> dict:
    model, kind = name.split("-")
    cfg = reduced(model)
    kw = {"tier": TIER} if kind == "train" else {}
    built = steps.builder_for(SHAPES[kind])(cfg, SHAPES[kind], MESH, **kw)
    return _analyse(built["fn"], built["args"], built["in_specs"], built["out_specs"],
                    built["act_specs"])


def main(argv) -> None:
    out = {}
    for name in argv:
        out.update(unit_cases() if name == "unit" else {"moe": moe_case()} if name == "moe"
                   else {name: step_case(name)})
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
