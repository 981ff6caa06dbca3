"""Component registries of the port (pair: ``repro/registry.py``).

A copy of the JAX package's registries: the same registries, names,
canonical forms, patterns and metadata (``supports_async``,
``supports_codec``, ``scheduler_aware``, ``async_native``,
``provides_hosts``, a dataset's ``kind``/``n_classes``/``noise``/``seed``),
so an ``ExperimentSpec`` validates, canonicalises and hashes the same in
both packages. Lazy targets point at ``repro_torch`` modules.

* a :class:`Registry` maps a component *name* (or a parameterized spec such
  as ``dynamic:3`` / ``topk0.05``) to a lazily-imported factory plus static
  metadata, and every unknown name fails with the full legal choice set;
* ``repro_torch.api``'s :class:`~repro_torch.api.ExperimentSpec` validates
  all of its string knobs here at spec-construction time;
* the trainer resolves its scheduler and the codec plane its codec through
  these tables, as the JAX package's do.

A component the port does not have yet stays registered under its name
with ``ported=False``: a spec naming it validates and hashes as in the JAX
package, and building or loading it raises ``NotImplementedError("... not
yet ported")``. That covers the transformer archs other than
SmolLM-360M and xLSTM-350M, and exec mode ``sharded``.

The module is stdlib-only at import time; factories import their
implementation lazily when built.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable


class RegistryError(ValueError):
    """Unknown / duplicate component name (message lists the legal set)."""


class Registry:
    """Name -> (lazy factory, metadata) with parameterized-spec support.

    An entry may carry a ``parse`` callable: given a spec string it returns
    the canonical spec (e.g. ``"topk0.05"`` -> ``"topk0.05"``, ``"none"`` ->
    ``"identity"``) or ``None`` if the spec does not belong to this entry.
    ``pattern`` is the human-readable form shown in error messages.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, dict] = {}

    # -- registration --------------------------------------------------
    def register(self, name: str, **meta: Any) -> None:
        if name in self._entries:
            raise RegistryError(f"{self.kind} {name!r} is already registered")
        self._entries[name] = dict(meta)

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    # -- lookup --------------------------------------------------------
    def names(self) -> list[str]:
        return sorted(self._entries)

    def choices(self) -> list[str]:
        """Display forms for error messages (patterns for parameterized)."""
        return sorted(e.get("pattern", n) for n, e in self._entries.items())

    def __contains__(self, name: str) -> bool:
        try:
            self.resolve(name)
            return True
        except RegistryError:
            return False

    def resolve(self, spec: Any) -> tuple[str, dict]:
        """(canonical spec, entry) for an exact name or parameterized spec."""
        s = str(spec).strip()
        e = self._entries.get(s)
        if e is not None and e.get("parse") is None:
            return s, e
        for name in sorted(self._entries):
            entry = self._entries[name]
            parse = entry.get("parse")
            if parse is None:
                continue
            canon = parse(s)
            if canon is not None:
                return canon, entry
        # note: an exact entry name whose parse rejected it (a bare
        # parameterized family like "topk" or "static") is NOT a legal spec
        raise RegistryError(
            f"unknown {self.kind} {spec!r}; registered {self.kind}s: "
            + ", ".join(self.choices()))

    def validate(self, spec: Any) -> str:
        """Canonical spec string, or RegistryError listing the legal set."""
        return self.resolve(spec)[0]

    def meta(self, spec: Any) -> dict:
        return self.resolve(spec)[1]

    def is_ported(self, spec: Any) -> bool:
        """False for a component registered for the spec's sake that the
        port cannot build yet."""
        return self.resolve(spec)[1].get("ported", True)

    def _check_ported(self, canon: str, e: dict) -> None:
        if not e.get("ported", True):
            raise NotImplementedError(f"{self.kind} {canon!r} is not yet ported")

    def load(self, spec: Any):
        """Import and return the entry's target class/object."""
        canon, e = self.resolve(spec)
        self._check_ported(canon, e)
        target = e.get("target")
        if isinstance(target, str):
            mod, _, attr = target.partition(":")
            target = getattr(importlib.import_module(mod), attr)
            e["target"] = target  # cache the resolved class
        return target

    def build(self, spec: Any, **kw):
        """Call the entry's ``build(canonical_spec, **kw)`` factory."""
        canon, e = self.resolve(spec)
        self._check_ported(canon, e)
        build = e.get("build")
        if build is None:
            raise RegistryError(f"{self.kind} {canon!r} has no build factory")
        return build(canon, **kw)


# ---------------------------------------------------------------------------
# the registries + their public registration helpers
# ---------------------------------------------------------------------------

trainers = Registry("trainer")
schedulers = Registry("scheduler")
codecs = Registry("codec")
engines = Registry("engine")
exec_modes = Registry("exec mode")
datasets = Registry("dataset")
archs = Registry("arch")
profile_pools = Registry("profile pool")
topologies = Registry("topology")


def register_trainer(name: str, target: str | type, *, supports_async: bool = True,
                     supports_codec: bool = True, scheduler_aware: bool = False,
                     **meta: Any) -> None:
    """``target``: ``"module:Class"`` import path (lazy) or the class itself.
    ``supports_async`` / ``supports_codec`` mirror the class attributes so
    spec validation can reject illegal combos without importing the
    trainer."""
    trainers.register(name, target=target, supports_async=supports_async,
                      supports_codec=supports_codec,
                      scheduler_aware=scheduler_aware, **meta)


def register_scheduler(name: str, *, build: Callable, parse: Callable | None = None,
                       pattern: str | None = None, **meta: Any) -> None:
    """``build(spec, *, profile, n_clients, n_tiers) -> scheduler``;
    ``parse(spec_str) -> canonical | None`` claims parameterized specs."""
    schedulers.register(name, build=build, parse=parse,
                        pattern=pattern or name, **meta)


def register_codec(name: str, *, build: Callable, parse: Callable | None = None,
                   pattern: str | None = None, identity: bool = False) -> None:
    """``build(spec) -> core.codec.Codec``. ``identity=True`` marks codecs
    that are wire-transparent (legal for trainers with supports_codec=False)."""
    codecs.register(name, build=build, parse=parse, pattern=pattern or name,
                    identity=identity)


def register_engine(name: str, **meta: Any) -> None:
    engines.register(name, **meta)


def register_dataset(name: str, *, kind: str = "image", n_classes: int = 10,
                     noise: float = 0.35, seed: int = 0, **meta: Any) -> None:
    """Image datasets carry the ``ClassImageTask`` knobs (the task's
    image_size always comes from the model config at build time); ``kind=
    "lm"`` marks the token-LM task family for the transformer archs."""
    datasets.register(name, kind=kind, n_classes=n_classes, noise=noise,
                      seed=seed, **meta)


def register_arch(name: str, *, kind: str, build: Callable, **meta: Any) -> None:
    """``kind``: "resnet" (image data, ResNetAdapter) or "transformer"
    (token-LM data, TransformerAdapter); ``build() -> full config``."""
    archs.register(name, kind=kind, build=build, **meta)


def register_profile_pool(name: str, *, build: Callable) -> None:
    """``build() -> list[timemodel.ResourceProfile]``."""
    profile_pools.register(name, build=build)


# ---------------------------------------------------------------------------
# built-in components (factories import their implementations lazily)
# ---------------------------------------------------------------------------

register_trainer("dtfl", "repro_torch.fed.dtfl:DTFLTrainer", scheduler_aware=True)
# the full-model baselines (repro/fed/{fedavg,...}.py)
register_trainer("fedavg", "repro_torch.fed.fedavg:FedAvgTrainer")
register_trainer("fedyogi", "repro_torch.fed.fedyogi:FedYogiTrainer", supports_async=False)
register_trainer("splitfed", "repro_torch.fed.splitfed:SplitFedTrainer",
                 supports_codec=False)
register_trainer("fedgkt", "repro_torch.fed.fedgkt:FedGKTTrainer",
                 supports_async=False, supports_codec=False)
register_trainer("tifl", "repro_torch.fed.tifl:TiFLTrainer", supports_async=False)
register_trainer("drop30", "repro_torch.fed.dropstrag:DropStragglerTrainer",
                 supports_async=False)
register_trainer("fedat", "repro_torch.fed.fedat:FedATTrainer", async_native=True)

def _parse_dynamic(s: str) -> str | None:
    if s == "dynamic":
        return s
    if s.startswith("dynamic:"):
        try:
            m = int(s.split(":", 1)[1])
        except ValueError:
            return None
        return s if m >= 1 else None
    return None


def _build_dynamic(spec: str, *, profile, n_clients: int, n_tiers: int):
    from repro_torch.core.scheduler import DynamicTierScheduler

    if spec == "dynamic":
        return DynamicTierScheduler(profile, n_clients)
    m = int(spec.split(":", 1)[1])  # M-tier deployment (paper Table 11)
    allowed = list(range(n_tiers))[-m:]
    return DynamicTierScheduler(profile, n_clients, allowed=allowed)


def _parse_static(s: str) -> str | None:
    try:
        return str(int(s)) if int(s) >= 0 else None
    except ValueError:
        return None


def _build_static(spec: str, *, profile, n_clients: int, n_tiers: int):
    from repro_torch.core.scheduler import StaticScheduler

    return StaticScheduler(int(spec), n_clients)


def _parse_pairing(s: str) -> str | None:
    if s == "pairing" or s == "pairing:hungarian":
        return "pairing"
    if s == "pairing:greedy":
        return s
    return None


def _build_pairing(spec: str, *, profile, n_clients: int, n_tiers: int):
    from repro_torch.core.scheduler import PairingScheduler

    method = spec.split(":", 1)[1] if ":" in spec else "hungarian"
    return PairingScheduler(profile, n_clients, method=method)


register_scheduler("dynamic", build=_build_dynamic, parse=_parse_dynamic,
                   pattern="dynamic | dynamic:<M>")
register_scheduler("static", build=_build_static, parse=_parse_static,
                   pattern="<fixed tier index, e.g. 0>")
register_scheduler("pairing", build=_build_pairing, parse=_parse_pairing,
                   pattern="pairing | pairing:greedy", provides_hosts=True)

# Offload topologies (core/topology.py): who executes a client's far half.
# ``scheduler`` names the scheduler family that produces the required
# assignment shape; spec validation (api.py) keeps the two fields coherent.
topologies.register("server", scheduler=None,
                    doc="classic DTFL: every far half runs on the server")
topologies.register("pairing", scheduler="pairing",
                    doc="mutual offload: fast clients host slow clients' "
                        "far halves (arxiv 2308.13849)")


def _codec_build(cls_name: str):
    def build(spec: str):
        import repro_torch.core.codec as codec_lib

        cls = getattr(codec_lib, cls_name)
        if cls_name == "TopKCodec":
            return cls(float(spec[4:].lstrip(":")))
        return cls()

    return build


def _parse_identity(s: str) -> str | None:
    return "identity" if s in ("identity", "none", "") else None


def _parse_topk(s: str) -> str | None:
    if not s.startswith("topk"):
        return None
    try:
        frac = float(s[4:].lstrip(":"))
    except ValueError:
        return None
    return s if 0.0 < frac <= 1.0 else None


register_codec("identity", build=_codec_build("IdentityCodec"),
               parse=_parse_identity, identity=True)
register_codec("bf16", build=_codec_build("Bf16Codec"))
register_codec("int8", build=_codec_build("Int8Codec"))
register_codec("topk", build=_codec_build("TopKCodec"), parse=_parse_topk,
               pattern="topk<frac> (e.g. topk0.05)")

register_engine("rounds", sync=True)
register_engine("events", sync=True)
register_engine("async", sync=False)

for _m in ("loop", "cohort", "sharded", "chunked"):
    exec_modes.register(_m, ported=_m != "sharded")

# the paper's four image benchmarks (data/synthetic.DATASETS) + the noisier
# variants the Table-1/Table-5 protocols train on, + the token-LM family
register_dataset("cifar10", n_classes=10)
register_dataset("cifar100", n_classes=100)
register_dataset("cinic10", n_classes=10, noise=0.5, seed=1)
register_dataset("ham10000", n_classes=7, seed=2)
register_dataset("cifar10-hard", n_classes=10, noise=0.6)    # Table 1 protocol
register_dataset("cifar10-noisy", n_classes=10, noise=1.0)   # Table 5 protocol
register_dataset("lm", kind="lm")


def _resnet_arch(name: str):
    def build(spec: str):
        from repro_torch.configs.resnet_cifar import get_resnet

        return get_resnet(name)

    return build


def _transformer_arch(name: str):
    def build(spec: str):
        from repro_torch.configs import get_config

        return get_config(name)

    return build


for _n in ("resnet-56", "resnet-110", "resnet-bench", "resnet-micro"):
    register_arch(_n, kind="resnet", build=_resnet_arch(_n))

# the assigned transformer pool (repro/registry.py's ASSIGNED_ARCH_NAMES);
# the port runs SmolLM-360M and xLSTM-350M so far
ASSIGNED_ARCH_NAMES = (
    "whisper-base", "granite-3-2b", "pixtral-12b", "yi-6b", "xlstm-350m",
    "hymba-1.5b", "deepseek-moe-16b", "deepseek-67b", "llama4-scout-17b-a16e",
    "smollm-360m",
)
PORTED_TRANSFORMERS = ("smollm-360m", "xlstm-350m")
for _n in ASSIGNED_ARCH_NAMES:
    register_arch(_n, kind="transformer", build=_transformer_arch(_n),
                  ported=_n in PORTED_TRANSFORMERS)


def _pool(attr: str | None):
    def build(spec: str):
        from repro_torch.core import timemodel

        if attr is None:  # the paper's most bandwidth-starved class
            return [timemodel.ResourceProfile(0.1, 10.0)]
        return list(getattr(timemodel, attr))

    return build


register_profile_pool("paper", build=_pool("PAPER_PROFILES"))
register_profile_pool("case1", build=_pool("CASE1_PROFILES"))
register_profile_pool("case2", build=_pool("CASE2_PROFILES"))
register_profile_pool("slow10mbps", build=_pool(None))
