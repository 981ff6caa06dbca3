"""Scenario library of the port (pair: ``repro/presets.py``): the paper's
Table 1-6 / figure setups as named specs.

A copy of the JAX package's factories: each returns a plain
:class:`repro_torch.api.ExperimentSpec` whose JSON and ``spec_hash`` equal
the JAX package's preset of the same name and arguments; callers refine
with ``spec.with_overrides({...})``. Every preset builds a spec; building a
Federation from one that names a component the port does not have yet (an
unported arch, the sharded plane) raises "not yet ported".

``PRESETS`` maps preset names to zero-argument factories (default
arguments).
"""
from __future__ import annotations

from repro_torch.api import (CheckpointSpec, ChurnSpec, CodecSpec, DataSpec,
                       EngineSpec, EnvSpec, ExecSpec, ExperimentSpec,
                       ModelSpec, TrainerSpec)


def quickstart(*, rounds: int = 3, clients: int = 4) -> ExperimentSpec:
    """Small DTFL run on the reduced paper ResNet: the 30-second tour."""
    return ExperimentSpec(
        data=DataSpec(clients=clients, samples=600, iid=True),
        model=ModelSpec(cost_model="resnet-110"),
        rounds=rounds,
    )


def table1_static(tier: int | None = 6, *, rounds: int = 30,
                  target: float = 0.75) -> ExperimentSpec:
    """Table 1 protocol: rounds-to-target with EVERY client pinned to one
    static tier (``tier=None``: the FedAvg row) on the 7-tier-capable bench
    ResNet, priced on full ResNet-110."""
    trainer = (TrainerSpec(method="fedavg") if tier is None
               else TrainerSpec(method="dtfl", scheduler=tier))
    return ExperimentSpec(
        model=ModelSpec(arch="resnet-bench", full_size=True,
                        cost_model="resnet-110"),
        data=DataSpec(dataset="cifar10-hard", clients=5, samples=1500,
                      iid=True),
        env=EnvSpec(switch_every=0),
        trainer=trainer,
        rounds=rounds, target_acc=target,
    )


def table3(method: str = "dtfl", *, iid: bool = True, rounds: int = 10,
           target: float = 0.55, topology: str = "server") -> ExperimentSpec:
    """Table 3: time-to-target, DTFL vs the baselines, IID / non-IID.
    ``topology="pairing"`` is the mutual-offload row (``dtfl_pairing`` in
    benchmarks/table3_baselines.py) — same heterogeneity profile, fast
    clients hosting slow clients' far halves."""
    return ExperimentSpec(
        model=ModelSpec(cost_model="resnet-110"),
        data=DataSpec(clients=10, iid=iid),
        trainer=TrainerSpec(method=method, topology=topology),
        rounds=rounds, target_acc=target,
    )


def pairing_demo(*, rounds: int = 8, clients: int = 10,
                 target: float | None = None) -> ExperimentSpec:
    """Mutual-offload tour: DTFL with the pairing topology on the paper's
    heterogeneity profile (fast clients host slow clients' far halves)."""
    return ExperimentSpec(
        model=ModelSpec(cost_model="resnet-110"),
        data=DataSpec(clients=clients, iid=True),
        trainer=TrainerSpec(method="dtfl", scheduler="pairing"),
        rounds=rounds, target_acc=target,
    )


def table4_accuracy(n: int = 10, method: str = "dtfl", *, rounds: int = 8,
                    target: float = 0.5) -> ExperimentSpec:
    """Table 4: simulated time-to-target vs client-pool size."""
    return ExperimentSpec(
        model=ModelSpec(cost_model="resnet-110"),
        data=DataSpec(clients=n, samples=200 * n, iid=True),
        trainer=TrainerSpec(method=method),
        rounds=rounds, target_acc=target,
        participation=max(0.1, 2.0 / n),
    )


def table4_wall(n: int = 10, *, exec_mode: str = "cohort",
                devices: int | None = None,
                chunk_size: int | None = None) -> ExperimentSpec:
    """Table 4 wall-time sweep: many small clients on the micro ResNet —
    the engine-overhead regime (the harness times ``train_round`` itself)."""
    return ExperimentSpec(
        model=ModelSpec(arch="resnet-micro", full_size=True,
                        cost_model="self"),
        data=DataSpec(clients=n, samples=64 * n, batch_size=8, iid=True),
        env=EnvSpec(switch_every=0),
        exec=ExecSpec(mode=exec_mode, devices=devices,
                      chunk_size=chunk_size),
        rounds=8,
    )


def table4_population(population: int = 100_000, *, sample_size: int = 512,
                      chunk_size: int = 64, rounds: int = 3,
                      samples: int = 64) -> ExperimentSpec:
    """Table 4 population regime: a 100k-client lazy registry with a fixed
    512-client sample per round, trained in fixed-size chunks so device and
    host memory stay O(sample), never O(population). ``samples`` is the
    PER-CLIENT dataset size (lazy per-cid pipelines)."""
    return ExperimentSpec(
        model=ModelSpec(arch="resnet-micro", full_size=True,
                        cost_model="self"),
        data=DataSpec(population=population, samples=samples, batch_size=8,
                      iid=True),
        env=EnvSpec(switch_every=0),
        trainer=TrainerSpec(sample_size=sample_size),
        exec=ExecSpec(mode="chunked", chunk_size=chunk_size),
        rounds=rounds,
    )


def table5(alpha: float = 0.0, *, patch_shuffle: bool = False,
           rounds: int = 6) -> ExperimentSpec:
    """Table 5: privacy integration (dcor regularizer / patch shuffling) on
    the intermediate-difficulty noisy task."""
    return ExperimentSpec(
        data=DataSpec(dataset="cifar10-noisy", clients=5, samples=1200,
                      iid=True),
        trainer=TrainerSpec(dcor_alpha=alpha, patch_shuffle=patch_shuffle),
        rounds=rounds,
    )


def table6(codec: str = "identity", *, env: str = "slow10mbps",
           exec_mode: str = "cohort", engine: str = "auto",
           devices: int | None = None, rounds: int = 10,
           target: float = 0.55, clients: int = 6, samples: int = 1200,
           seed: int = 0) -> ExperimentSpec:
    """Table 6 (repo extension): wire codecs on the bandwidth-starved and
    paper profiles — bytes/round + simulated time-to-target."""
    return ExperimentSpec(
        model=ModelSpec(cost_model="resnet-110"),
        data=DataSpec(clients=clients, samples=samples, iid=False),
        env=EnvSpec(profiles=env),
        engine=EngineSpec(name=engine),
        exec=ExecSpec(mode=exec_mode, devices=devices),
        codec=CodecSpec(name=codec),
        rounds=rounds, target_acc=target, seed=seed,
    )


def fig_async(mode: str = "sync_dtfl", *, rounds: int = 12,
              target: float = 0.55, clients: int = 10, n_groups: int = 3,
              churn: bool = True, seed: int = 0) -> ExperimentSpec:
    """Async-timeline figure: sync DTFL vs async DTFL vs FedAT under churn.
    ``mode``: sync_dtfl | async_dtfl | fedat."""
    method, engine = {
        "sync_dtfl": ("dtfl", "events"),
        "async_dtfl": ("dtfl", "async"),
        "fedat": ("fedat", "auto"),
    }[mode]
    churn_spec = ChurnSpec(drop=0.1, switch=0.1, offline_frac=0.2,
                           seed=seed + 1) if churn else None
    return ExperimentSpec(
        model=ModelSpec(cost_model="resnet-110"),
        data=DataSpec(clients=clients, iid=True),
        trainer=TrainerSpec(method=method),
        engine=EngineSpec(name=engine, n_groups=n_groups, churn=churn_spec),
        rounds=rounds, target_acc=target, seed=seed,
    )


def cifar_paper(method: str = "dtfl", *, rounds: int = 12, clients: int = 10,
                target: float = 0.7) -> ExperimentSpec:
    """The paper's main experiment, CPU-scaled: non-IID Dirichlet(0.5),
    profile switching every 5 rounds, priced on full ResNet-110."""
    return ExperimentSpec(
        model=ModelSpec(cost_model="resnet-110"),
        data=DataSpec(clients=clients, samples=3000),
        env=EnvSpec(switch_every=5),
        trainer=TrainerSpec(method=method),
        rounds=rounds, target_acc=target,
    )


def llm(arch: str = "smollm-360m", *, rounds: int = 6, clients: int = 4,
        seq_len: int = 64) -> ExperimentSpec:
    """DTFL on an assigned transformer arch: split-offloaded federated LM
    training (model-agnosticism demo)."""
    return ExperimentSpec(
        model=ModelSpec(arch=arch),
        data=DataSpec(dataset="lm", clients=clients, batch_size=8,
                      seq_len=seq_len, eval_size=16),
        env=EnvSpec(switch_every=3),
        trainer=TrainerSpec(lr=2e-3),
        rounds=rounds,
    )


def async_churn(engine: str = "auto", *, clients: int = 8, rounds: int = 6,
                n_groups: int = 2, churn: bool = False) -> ExperimentSpec:
    """The event-engine tour setup (examples/async_churn.py): one 8-client
    DTFL scenario run under rounds / events+churn / async engines."""
    churn_spec = ChurnSpec(drop=0.15, switch=0.15, offline_frac=0.25,
                           seed=1) if churn else None
    return ExperimentSpec(
        data=DataSpec(clients=clients, samples=1600, iid=True, eval_size=256),
        engine=EngineSpec(name=engine, n_groups=n_groups, churn=churn_spec),
        rounds=rounds,
    )


def resume_demo(*, rounds: int = 20, path: str = "/tmp/dtfl_state.npz",
                every: int = 5) -> ExperimentSpec:
    """Checkpointed quickstart: the resumable-training README example."""
    return quickstart(rounds=rounds).with_overrides(
        {"checkpoint.path": path, "checkpoint.every": every})


PRESETS = {
    "quickstart": quickstart,
    "table1_static": table1_static,
    "table3": table3,
    "pairing_demo": pairing_demo,
    "table4_accuracy": table4_accuracy,
    "table4_wall": table4_wall,
    "table4_population": table4_population,
    "table5": table5,
    "table6": table6,
    "fig_async": fig_async,
    "cifar_paper": cifar_paper,
    "llm": llm,
    "async_churn": async_churn,
    "resume_demo": resume_demo,
}
