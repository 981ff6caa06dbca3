"""The declarative experiment API of the port (pair: ``repro/api.py``):
``ExperimentSpec`` -> ``Federation``.

The spec dataclasses, their validation, ``to_json``/``from_json``,
``with_overrides``, ``identity_dict``, ``spec_hash`` and ``program_key``
are the JAX package's, verbatim, over the port's copy of the registries
(``repro_torch.registry``): a spec validates, canonicalises, serialises and
hashes the same in both packages, so a JAX spec JSON builds a port
``Federation`` and a JAX envelope's spec stamp verifies here. An invalid
name or an illegal combination raises :class:`SpecError` with the full
legal choice set in the message.

``spec.build(device=...)`` returns a :class:`Federation` that builds the
port's adapter, clients, env and trainer as ``repro/api.py:542-624`` does
(the same data, profile and participant streams), and exposes ``run()`` /
``save()`` / ``resume()``. ``device`` is not a spec field and never enters
the hash; the run goes to the card unless ``device="cpu"``. Under
``exec.mode="sharded"`` the build first joins or makes the process group
(``launch/mesh.py::init_client_group``) and runs on this rank's device.
The spec stamps every checkpoint envelope (hash + canonical JSON), so
``resume()`` can verify it continues the same experiment.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field, fields

from repro_torch import registry
from repro_torch.registry import RegistryError


class SpecError(ValueError):
    """Invalid ExperimentSpec (bad name, bad value, or illegal combo)."""


def _positive(name: str, v, *, minimum=1) -> None:
    if v < minimum:
        raise SpecError(f"{name} must be >= {minimum}, got {v!r}")


def _validated(reg, name: str):
    try:
        return reg.validate(name)
    except RegistryError as e:
        raise SpecError(str(e)) from None


# ---------------------------------------------------------------------------
# the spec tree
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelSpec:
    """``arch`` picks the model family + adapter (registry ``archs``).
    ``full_size=False`` trains the ``reduced()`` CPU variant. ``cost_model``
    prices the analytic time model: None = the arch's FULL config (the
    paper's regime), ``"self"`` = the trained config itself, or a registered
    resnet name (Table 3 prices the reduced model on full ResNet-110)."""

    arch: str = "resnet-56"
    full_size: bool = False
    cost_model: str | None = None

    def __post_init__(self):
        _validated(registry.archs, self.arch)
        if self.cost_model not in (None, "self"):
            kind = registry.archs.meta(self.cost_model).get("kind") \
                if self.cost_model in registry.archs else None
            if kind != "resnet":
                raise SpecError(
                    f"cost_model {self.cost_model!r} must be None, 'self', or "
                    f"a registered resnet arch: "
                    + ", ".join(n for n in registry.archs.names()
                                if registry.archs.meta(n)["kind"] == "resnet"))

    @property
    def kind(self) -> str:
        return registry.archs.meta(self.arch)["kind"]


@dataclass(frozen=True)
class DataSpec:
    """Client data plane. Image datasets follow the ``train.py`` protocol
    (labels from ``default_rng(seed)``, iid or Dirichlet(alpha) partition);
    ``dataset="lm"`` is the token-LM task (``n_batches`` batches/client).
    ``eval_size=None`` resolves to 512 images / one ``batch_size`` LM batch."""

    dataset: str = "cifar10"
    clients: int = 10
    samples: int = 2000
    batch_size: int = 32
    iid: bool = False
    alpha: float = 0.5
    seq_len: int = 128
    n_batches: int = 2
    eval_size: int | None = None
    # population plane: a lazy registry of this many clients replaces the
    # dense ``clients`` list; per-client data/profile state is derived from
    # (seed, cid) on FIRST participation, so 10^5-10^6 registries cost
    # O(sampled). In population mode ``samples`` counts samples PER CLIENT
    # (a dense-mode global pool would itself be O(population)).
    population: int | None = None

    def __post_init__(self):
        _validated(registry.datasets, self.dataset)
        _positive("data.clients", self.clients)
        _positive("data.samples", self.samples)
        _positive("data.batch_size", self.batch_size)
        _positive("data.seq_len", self.seq_len)
        _positive("data.n_batches", self.n_batches)
        if self.eval_size is not None:
            _positive("data.eval_size", self.eval_size)
        if self.population is not None:
            _positive("data.population", self.population)

    @property
    def n_clients(self) -> int:
        """Registered clients: the lazy registry size in population mode,
        the dense ``clients`` count otherwise."""
        return self.clients if self.population is None else self.population

    @property
    def kind(self) -> str:
        return registry.datasets.meta(self.dataset)["kind"]


@dataclass(frozen=True)
class EnvSpec:
    """Heterogeneous resource environment: a registered profile-pool name
    (``paper``/``case1``/``case2``/``slow10mbps``) or an explicit tuple of
    ``(cpu_share, mbps)`` pairs; profiles of 30% of clients re-roll every
    ``switch_every`` rounds (0 disables switching)."""

    profiles: str | tuple = "paper"
    switch_every: int = 50

    def __post_init__(self):
        if isinstance(self.profiles, str):
            _validated(registry.profile_pools, self.profiles)
        else:
            try:
                pool = tuple(
                    (float(f), float(b)) for f, b in self.profiles)
            except (TypeError, ValueError):
                raise SpecError(
                    f"env.profiles must be a registered pool name "
                    f"({', '.join(registry.profile_pools.names())}) or a "
                    f"list of (cpu_share, mbps) pairs, got {self.profiles!r}"
                ) from None
            if not pool:
                raise SpecError("env.profiles custom pool is empty")
            object.__setattr__(self, "profiles", pool)
        _positive("env.switch_every", self.switch_every, minimum=0)


@dataclass(frozen=True)
class TrainerSpec:
    """Algorithm + its local-training knobs. ``scheduler`` is DTFL's tier
    scheduler spec (``dynamic`` | ``dynamic:<M>`` | a fixed tier index |
    ``pairing[:greedy]``) and is rejected for methods that have no tier
    scheduler. ``topology`` picks the offload topology (``server`` |
    ``pairing``, core/topology.py); ``scheduler=pairing`` and
    ``topology=pairing`` imply each other and are kept coherent here.
    ``options`` passes extra registered-trainer constructor kwargs (e.g.
    fedyogi's ``server_lr``) — keys must be identifiers."""

    method: str = "dtfl"
    scheduler: str | int = "dynamic"
    topology: str = "server"
    lr: float = 1e-3
    local_epochs: int = 1
    dcor_alpha: float = 0.0
    patch_shuffle: bool = False
    # absolute participants per round (population plane: "sample 512 of the
    # 10^6 registry"); None keeps fractional ``participation`` sizing
    sample_size: int | None = None
    options: dict = field(default_factory=dict)

    def __post_init__(self):
        _validated(registry.trainers, self.method)
        if self.sample_size is not None:
            _positive("trainer.sample_size", self.sample_size)
        canon = _validated(registry.schedulers, self.scheduler)
        object.__setattr__(
            self, "scheduler",
            int(canon) if canon.lstrip("-").isdigit() else canon)
        topo = _validated(registry.topologies, self.topology)
        pairing_sched = (isinstance(self.scheduler, str)
                         and self.scheduler.startswith("pairing"))
        if topo == "pairing" and not pairing_sched:
            if self.scheduler != "dynamic":
                raise SpecError(
                    f"trainer.topology='pairing' requires "
                    f"trainer.scheduler='pairing' (or 'pairing:greedy'), got "
                    f"scheduler={self.scheduler!r}")
            object.__setattr__(self, "scheduler", "pairing")
        elif pairing_sched:
            topo = "pairing"
        object.__setattr__(self, "topology", topo)
        _positive("trainer.lr", self.lr, minimum=0)
        _positive("trainer.local_epochs", self.local_epochs)
        if not isinstance(self.options, dict) or not all(
                isinstance(k, str) and k.isidentifier() for k in self.options):
            raise SpecError(
                f"trainer.options must map identifier kwargs to values, got "
                f"{self.options!r}")


@dataclass(frozen=True)
class ChurnSpec:
    """Client churn (events/async engines only): mid-round dropout /
    profile-switch probabilities, initially-offline fraction, rejoin delay.
    ``seed=None`` uses the experiment seed."""

    drop: float = 0.1
    switch: float = 0.1
    offline_frac: float = 0.0
    rejoin: int = 2
    seed: int | None = None

    def __post_init__(self):
        for n in ("drop", "switch", "offline_frac"):
            v = getattr(self, n)
            if not 0.0 <= v <= 1.0:
                raise SpecError(f"engine.churn.{n} must be in [0, 1], got {v!r}")
        _positive("engine.churn.rejoin", self.rejoin)


@dataclass(frozen=True)
class EngineSpec:
    """Round engine: ``auto`` resolves to ``async`` for fedat, ``rounds``
    otherwise (exactly ``train.py``'s default). ``n_groups`` is the async
    speed-group count."""

    name: str = "auto"
    n_groups: int = 3
    churn: ChurnSpec | None = None

    def __post_init__(self):
        if self.name != "auto":
            _validated(registry.engines, self.name)
        _positive("engine.n_groups", self.n_groups)


@dataclass(frozen=True)
class ExecSpec:
    """Execution plane: ``loop`` | ``cohort`` | ``sharded`` (+ mesh size) |
    ``chunked`` (+ ``chunk_size`` clients per device program — memory stays
    O(chunk), bit-equal to ``cohort``)."""

    mode: str = "cohort"
    devices: int | None = None
    chunk_size: int | None = None

    def __post_init__(self):
        _validated(registry.exec_modes, self.mode)
        if self.devices is not None:
            _positive("exec.devices", self.devices)
        if self.chunk_size is not None:
            _positive("exec.chunk_size", self.chunk_size)
            if self.mode != "chunked":
                raise SpecError(
                    f"exec.chunk_size applies to exec.mode='chunked' only; "
                    f"got mode={self.mode!r}")


@dataclass(frozen=True)
class CodecSpec:
    """Wire codec for the three wires (z uplink, model download, update
    upload): any spec registered with ``register_codec``."""

    name: str = "identity"

    def __post_init__(self):
        object.__setattr__(
            self, "name",
            _validated(registry.codecs, str(self.name).strip().lower()))

    @property
    def is_identity(self) -> bool:
        return bool(registry.codecs.meta(self.name).get("identity"))


@dataclass(frozen=True)
class CheckpointSpec:
    """Resumable-train-state envelope: write to ``path`` every ``every``
    rounds; ``resume`` restores (and spec-hash-verifies) an envelope."""

    path: str | None = None
    every: int = 10
    resume: str | None = None

    def __post_init__(self):
        _positive("checkpoint.every", self.every)


_NESTED = {"model": ModelSpec, "data": DataSpec, "env": EnvSpec,
           "trainer": TrainerSpec, "engine": EngineSpec, "exec": ExecSpec,
           "codec": CodecSpec, "checkpoint": CheckpointSpec}
# spec groups with_overrides may auto-create from None (nested optionals
# like engine.churn included)
_AUTO_GROUPS = frozenset(_NESTED) | {"churn"}
# run-length / IO knobs excluded from the experiment identity hash, so a
# checkpointed run can legally be resumed with a larger --rounds budget
_NON_IDENTITY_FIELDS = ("rounds", "target_acc", "checkpoint")


@dataclass(frozen=True)
class ExperimentSpec:
    """The root spec. Frozen, JSON-round-trippable, registry-validated."""

    model: ModelSpec = field(default_factory=ModelSpec)
    data: DataSpec = field(default_factory=DataSpec)
    env: EnvSpec = field(default_factory=EnvSpec)
    trainer: TrainerSpec = field(default_factory=TrainerSpec)
    engine: EngineSpec = field(default_factory=EngineSpec)
    exec: ExecSpec = field(default_factory=ExecSpec)
    codec: CodecSpec = field(default_factory=CodecSpec)
    checkpoint: CheckpointSpec = field(default_factory=CheckpointSpec)
    rounds: int = 20
    target_acc: float | None = None
    participation: float = 1.0
    eval_every: int = 1
    seed: int = 0

    # ------------------------------------------------------------------
    def __post_init__(self):
        _positive("rounds", self.rounds)
        _positive("eval_every", self.eval_every)
        if not 0.0 < self.participation <= 1.0:
            raise SpecError(
                f"participation must be in (0, 1], got {self.participation!r}")

        meta = registry.trainers.meta(self.trainer.method)
        # arch kind <-> data kind
        want = "lm" if self.model.kind == "transformer" else "image"
        if self.data.kind != want:
            names = [n for n in registry.datasets.names()
                     if registry.datasets.meta(n)["kind"] == want]
            raise SpecError(
                f"arch {self.model.arch!r} ({self.model.kind}) needs a "
                f"{want} dataset; got {self.data.dataset!r} "
                f"({self.data.kind}). Legal: {', '.join(names)}")
        if self.trainer.patch_shuffle and self.model.kind != "resnet":
            raise SpecError("trainer.patch_shuffle is an image-adapter knob; "
                            "it is not supported for transformer archs")
        # scheduler is a tier-scheduling knob; only scheduler-aware trainers
        # (dtfl) accept one
        if self.trainer.scheduler != "dynamic" and not meta.get("scheduler_aware"):
            aware = [n for n in registry.trainers.names()
                     if registry.trainers.meta(n).get("scheduler_aware")]
            raise SpecError(
                f"trainer.scheduler={self.trainer.scheduler!r} requires a "
                f"tier-scheduling method ({', '.join(aware)}); "
                f"{self.trainer.method!r} has no tier scheduler")
        # codec plane contract
        if not self.codec.is_identity and not meta.get("supports_codec", True):
            ok = [n for n in registry.trainers.names()
                  if registry.trainers.meta(n).get("supports_codec", True)]
            raise SpecError(
                f"method {self.trainer.method!r} does not support wire "
                f"compression (codec={self.codec.name!r}); its round "
                f"structure is not the download/update-upload contract the "
                f"codec plane compresses. Codec-capable methods: "
                + ", ".join(ok))
        # engine combos
        engine = self.resolved_engine
        if engine == "async" and not meta.get("supports_async", True):
            ok = [n for n in registry.trainers.names()
                  if registry.trainers.meta(n).get("supports_async", True)]
            raise SpecError(
                f"method {self.trainer.method!r} has no faithful async "
                f"formulation; engine='async' supports: {', '.join(ok)} "
                f"(use engine='rounds' or 'events')")
        if self.engine.churn is not None and engine == "rounds":
            raise SpecError(
                "engine.churn requires the event-driven engines "
                "(engine='events' or 'async'); the scalar-clock 'rounds' "
                "loop cannot express mid-round churn")
        # population plane combos (lazy registry + fixed-size sampling)
        if self.data.population is not None and engine == "async":
            raise SpecError(
                "data.population (the lazy client registry) supports "
                "engine='rounds'|'events' only; the async engine speed-"
                "groups the FULL population, which defeats lazy state")
        if self.trainer.sample_size is not None and engine == "async":
            raise SpecError(
                "trainer.sample_size is a rounds/events sampling knob; the "
                "async engine groups the full population (use "
                "participation)")
        if self.checkpoint.resume:
            if engine == "async":
                raise SpecError(
                    "checkpoint.resume supports engine='rounds'|'events' "
                    "only (the async engine's in-flight wave queue is not "
                    "checkpointed)")
            if self.engine.churn is not None:
                raise SpecError(
                    "checkpoint.resume with engine.churn is unsupported "
                    "(churn offline/arrival state is not checkpointed)")

    # ------------------------------------------------------------------
    @property
    def resolved_engine(self) -> str:
        if self.engine.name != "auto":
            return self.engine.name
        return "async" if self.trainer.method == "fedat" else "rounds"

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          default=_json_default)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        return _build_spec(cls, d, "spec")

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def with_overrides(self, overrides: dict) -> "ExperimentSpec":
        """New spec with dotted-path fields replaced (``{"trainer.method":
        "fedavg", "rounds": 2}``); string values are JSON-parsed when
        possible. Revalidates the full tree."""
        d = self.to_dict()
        for path, value in overrides.items():
            node, parts = d, path.split(".")
            for p in parts[:-1]:
                if not isinstance(node.get(p), dict):
                    if p in _AUTO_GROUPS and node.get(p) is None:
                        node[p] = {}  # e.g. engine.churn.drop on churn=None
                    else:
                        raise SpecError(f"override path {path!r}: no spec "
                                        f"group {p!r}")
                node = node[p]
            if isinstance(value, str):
                try:
                    value = json.loads(value)
                except (ValueError, TypeError):
                    pass
            node[parts[-1]] = value
        return type(self).from_dict(d)

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------
    def identity_dict(self) -> dict:
        """The experiment-identity fields: everything except run-length and
        checkpoint-IO knobs (so resuming with a larger round budget is the
        same experiment)."""
        d = self.to_dict()
        for k in _NON_IDENTITY_FIELDS:
            d.pop(k, None)
        return d

    def spec_hash(self) -> str:
        blob = json.dumps(self.identity_dict(), sort_keys=True,
                          default=_json_default)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def program_key(self) -> tuple:
        """Everything the per-tier programs close over, as the JAX package
        computes it (there, two specs with equal keys share one Federation's
        jitted programs). The port runs eagerly and compiles nothing, so
        ``Federation(spec, reuse=prev)`` shares nothing and saves no time."""
        t, m, d = self.trainer, self.model, self.data
        return (t.method, m.arch, m.full_size, d.dataset, d.batch_size,
                d.seq_len, d.n_batches, t.lr, t.local_epochs, t.dcor_alpha,
                t.patch_shuffle, tuple(sorted(t.options.items())),
                self.codec.name, self.exec.mode, self.exec.devices,
                self.exec.chunk_size)

    # ------------------------------------------------------------------
    def build(self, *, reuse: "Federation | None" = None,
              device=None) -> "Federation":
        return Federation(self, reuse=reuse, device=device)


def _json_default(o):
    raise TypeError(f"spec field value {o!r} is not JSON-serializable")


def _build_spec(cls, d: dict, path: str):
    if not isinstance(d, dict):
        raise SpecError(f"{path} must be a JSON object, got {d!r}")
    known = {f.name for f in fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise SpecError(
            f"unknown field(s) {', '.join(f'{path}.{u}' for u in unknown)}; "
            f"known fields: {', '.join(sorted(known))}")
    kw = {}
    for k, v in d.items():
        sub = _NESTED.get(k) if cls is ExperimentSpec else (
            ChurnSpec if (cls is EngineSpec and k == "churn") else None)
        if sub is not None and v is not None:
            v = _build_spec(sub, v, f"{path}.{k}")
        kw[k] = v
    try:
        return cls(**kw)
    except TypeError as e:
        raise SpecError(f"{path}: {e}") from None


# ---------------------------------------------------------------------------
# the Federation facade
# ---------------------------------------------------------------------------

def _churn_model(spec: ExperimentSpec):
    """The spec's ``ChurnModel`` over the registered clients, or None."""
    if spec.engine.churn is None:
        return None
    from repro_torch.fed.client import ChurnModel

    c = spec.engine.churn
    return ChurnModel(
        spec.data.n_clients, drop_prob=c.drop, switch_prob=c.switch,
        start_offline_frac=c.offline_frac, rejoin_after=c.rejoin,
        seed=spec.seed if c.seed is None else c.seed)


class Federation:
    """Owns the built experiment: adapter, clients, env, trainer, eval batch.

    ``run()`` executes ``spec.rounds`` rounds on the spec's engine and
    returns the ``RoundLog`` list; ``save(path)`` dumps the trainer state;
    ``resume(path)`` loads a checkpoint envelope and verifies its spec stamp
    before the next ``run()`` continues it.

    ``reuse=`` is accepted as the JAX package accepts it (the sweep passes
    the previous point), but adopts nothing: the port has no compiled
    programs to share, so ``programs_reused`` stays False. ``device`` picks
    the trainer's device (None: the card).
    """

    def __init__(self, spec: ExperimentSpec, *, reuse: "Federation | None" = None,
                 device=None):
        self.spec = spec
        self.logs = None
        self._resume = None
        # a component the port does not have yet raises before any data is
        # built
        cls = registry.trainers.load(spec.trainer.method)
        if spec.exec.mode == "sharded":
            # the process group before anything is built
            # (repro/api.py:547-549); the rank's device replaces ``device``
            from repro_torch.launch.mesh import init_client_group

            device = init_client_group(spec.exec.devices, device)

        from repro_torch import optim
        from repro_torch.fed.client import HeteroEnv
        from repro_torch.fed.execplan import ExecPlan

        plan = ExecPlan.from_flags(spec.exec.mode, devices=spec.exec.devices,
                                   chunk_size=spec.exec.chunk_size)
        cfg_full = registry.archs.build(spec.model.arch)
        cfg = cfg_full if spec.model.full_size else cfg_full.reduced()
        self.cfg = cfg
        if spec.model.kind == "resnet":
            from repro_torch.configs.resnet_cifar import get_resnet
            from repro_torch.fed.adapter import ResNetAdapter

            if spec.model.cost_model == "self":
                cost_cfg = None
            elif spec.model.cost_model is None:
                cost_cfg = cfg_full
            else:
                cost_cfg = get_resnet(spec.model.cost_model)
            self.adapter = ResNetAdapter(
                cfg, cost_cfg=cost_cfg, dcor_alpha=spec.trainer.dcor_alpha,
                patch_shuffle=spec.trainer.patch_shuffle)
            self.clients, self.eval_batch = _build_image_data(spec, cfg)
        else:
            from repro_torch.fed.adapter import TransformerAdapter

            cost_cfg = None if spec.model.cost_model == "self" else cfg_full
            self.adapter = TransformerAdapter(
                cfg, seq_len=spec.data.seq_len, cost_cfg=cost_cfg,
                dcor_alpha=spec.trainer.dcor_alpha)
            self.clients, self.eval_batch = _build_lm_data(spec, cfg)

        profiles = spec.env.profiles
        if isinstance(profiles, str):
            profiles = (None if profiles == "paper"
                        else registry.profile_pools.build(profiles))
        else:
            from repro_torch.core.timemodel import ResourceProfile

            profiles = [ResourceProfile(f, b) for f, b in profiles]
        if spec.data.population is not None:
            from repro_torch.fed.population import LazyHeteroEnv

            self.env = LazyHeteroEnv(spec.data.n_clients, profiles=profiles,
                                     switch_every=spec.env.switch_every,
                                     seed=spec.seed)
        else:
            self.env = HeteroEnv(spec.data.clients, profiles=profiles,
                                 switch_every=spec.env.switch_every,
                                 seed=spec.seed)

        kw = dict(spec.trainer.options)
        if registry.trainers.meta(spec.trainer.method).get("scheduler_aware"):
            kw["scheduler"] = spec.trainer.scheduler
            kw["topology"] = spec.trainer.topology
        kw["exec_plan"] = plan
        kw["codec"] = spec.codec.name
        self.trainer = cls(self.adapter, self.clients, self.env,
                           optim.adam(spec.trainer.lr), seed=spec.seed,
                           local_epochs=spec.trainer.local_epochs, device=device, **kw)
        # the engine stamps every checkpoint envelope with this, so resume
        # can verify it is continuing the SAME experiment
        self.trainer._spec_stamp = {"hash": spec.spec_hash(),
                                    "json": spec.to_json()}

        self.programs_reused = False

    # ------------------------------------------------------------------
    def run(self, *, verbose: bool = False, on_round=None):
        """``on_round(trainer, log)`` is called after each round."""
        sp = self.spec
        engine = sp.resolved_engine
        run_kw = {"engine": engine}
        if engine == "async":
            run_kw["n_groups"] = sp.engine.n_groups
        if sp.trainer.sample_size is not None:
            run_kw["sample_size"] = sp.trainer.sample_size
        if sp.checkpoint.path:
            run_kw["checkpoint_path"] = sp.checkpoint.path
            run_kw["checkpoint_every"] = sp.checkpoint.every
        resume = self._resume
        if resume is None and sp.checkpoint.resume:
            resume = self._load_verified(sp.checkpoint.resume)
        if resume is not None:
            run_kw["resume"] = resume
            self._resume = None
            if verbose and self.trainer.exec_plan.lead:
                print(f"[api] resuming at round {int(resume['round'])} "
                      f"(spec {self.spec.spec_hash()})")
        self.logs = self.trainer.run(
            sp.rounds, self.eval_batch, target_acc=sp.target_acc,
            participation=sp.participation, eval_every=sp.eval_every,
            verbose=verbose, churn=_churn_model(sp), on_round=on_round, **run_kw)
        return self.logs

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Dump the trainer's state (weights-level; for the full resumable
        envelope use ``spec.checkpoint.path`` so the engine writes round /
        clock / rng cursors too)."""
        self.trainer.save(path)

    def resume(self, path: str) -> "Federation":
        """Load + spec-verify a train-state envelope; the next ``run()``
        continues it."""
        self._resume = self._load_verified(path)
        return self

    def _load_verified(self, path: str) -> dict:
        from repro_torch import checkpoint as ckpt

        envelope = ckpt.load(path)
        stamp = envelope.get("spec") if isinstance(envelope, dict) else None
        if stamp is not None:
            have = str(stamp["hash"])
            want = self.spec.spec_hash()
            if have != want:
                raise SpecError(
                    f"checkpoint {path!r} was written by a different "
                    f"experiment (spec hash {have} != {want}). The stored "
                    f"spec was:\n{str(stamp['json'])}\nDiffering fields "
                    "must match for a resume to be meaningful (rounds / "
                    "target_acc / checkpoint paths are exempt).")
        return envelope


# ---------------------------------------------------------------------------
# data builders (repro/api.py:708-786: the same streams as the JAX package's)
# ---------------------------------------------------------------------------

def _build_image_data(spec: ExperimentSpec, cfg):
    import numpy as np

    from repro_torch.data.partition import dirichlet_partition, iid_partition
    from repro_torch.data.pipeline import ClientDataset, make_eval_batch
    from repro_torch.data.synthetic import ClassImageTask
    from repro_torch.fed.client import SimClient

    ds = registry.datasets.meta(spec.data.dataset)
    task = ClassImageTask(n_classes=ds["n_classes"], image_size=cfg.image_size,
                          noise=ds["noise"], seed=ds["seed"])
    if spec.data.population is not None:
        # population plane: each client's labels are a pure function of
        # (seed, cid) — iid uniform, or a per-client Dirichlet(alpha) class
        # mix — built on FIRST participation by the lazy store's factory, so
        # a 10^6-client registry allocates nothing up front. ``samples`` is
        # per client here (a global label pool would itself be O(population)).
        from repro_torch.fed.population import ClientStore, cid_rng

        per, bs, n_cls = spec.data.samples, spec.data.batch_size, task.n_classes
        iid, alpha, seed = spec.data.iid, spec.data.alpha, spec.seed

        def factory(cid: int):
            r = cid_rng(seed, 21, cid)
            if iid:
                labels = r.integers(0, n_cls, per)
            else:
                labels = r.choice(n_cls, size=per, p=r.dirichlet([alpha] * n_cls))
            # seed=cid+1: distinct per-client batch-shuffle streams (0 is
            # the dense path's shared legacy stream)
            return SimClient(
                cid, ClientDataset(task, labels, np.arange(per), bs, seed=cid + 1),
                None)

        return (ClientStore(spec.data.population, factory),
                make_eval_batch(task, spec.data.eval_size or 512))
    rng = np.random.default_rng(spec.seed)
    labels = rng.integers(0, task.n_classes, spec.data.samples)
    if spec.data.iid:
        parts = iid_partition(labels, spec.data.clients, seed=spec.seed)
    else:
        parts = dirichlet_partition(labels, spec.data.clients,
                                    spec.data.alpha, seed=spec.seed)
    clients = [
        SimClient(i, ClientDataset(task, labels, parts[i], spec.data.batch_size),
                  None)
        for i in range(spec.data.clients)
    ]
    return clients, make_eval_batch(task, spec.data.eval_size or 512)


def _build_lm_data(spec: ExperimentSpec, cfg):
    from repro_torch.data.pipeline import SeqClientDataset
    from repro_torch.data.synthetic import SeqTask
    from repro_torch.fed.client import SimClient

    task = SeqTask(vocab=cfg.vocab)
    if spec.data.population is not None:
        from repro_torch.fed.population import ClientStore

        d = spec.data
        clients = ClientStore(
            d.population,
            lambda cid: SimClient(
                cid, SeqClientDataset(task, d.n_batches, d.batch_size,
                                      d.seq_len, cid), None))
    else:
        clients = [
            SimClient(i, SeqClientDataset(task, spec.data.n_batches,
                                          spec.data.batch_size,
                                          spec.data.seq_len, i), None)
            for i in range(spec.data.clients)
        ]
    ev = next(task.batches(spec.data.eval_size or spec.data.batch_size,
                           spec.data.seq_len, 1, seed=99))
    return clients, ev


def __getattr__(name: str):
    if name == "presets":  # lazy: repro_torch.presets imports this module
        import repro_torch.presets as presets

        return presets
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
