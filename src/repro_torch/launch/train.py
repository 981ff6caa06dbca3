"""Training entry point of the port: CLI flags -> ``ExperimentSpec`` ->
``Federation`` (pair: ``repro/launch/train.py``).

Pure translation, as in the JAX package: every flag maps onto one field of
the spec tree in ``repro_torch.api``, and the run is
``spec.build(device=args.device).run()``. The flags, their names and
defaults are the JAX CLI's, plus ``--device``: the run goes to the card
unless ``--device cpu``. String knobs (``--method``, ``--scheduler``,
``--codec``, ``--arch``, ``--dataset``, ``--engine``, ``--exec``,
``--topology``) are validated against the port's registries at parse time:
a typo fails with the registered choice set. ``--exec sharded --devices N``
runs one process a device over ``torch.distributed`` (``launch/mesh.py``):
launch N ranks with ``torchrun``; one rank needs no launcher. Every rank
trains its slice of each cohort; only rank 0 prints and writes ``--out``,
``--out-spec`` and ``--out-ckpt``.
``--arch whisper-base`` and ``pixtral-12b`` go as far as the JAX CLI goes:
their LM batches carry no frontend, so the first client step raises
``KeyError: 'frontend'``, as ``repro/models/model.py:64`` and ``:72`` do.

  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet-56 \\
      --full-size --clients 10 --rounds 3 --codec int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet-56 \\
      --clients 4 --rounds 4 --out-ckpt state.npz --save-every 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train ... --resume state.npz
  PYTHONPATH=src python -m repro_torch.launch.train ... --engine async --n-groups 3
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch resnet-56 --clients 5 --exec sharded --devices 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import registry
from repro_torch.api import (CheckpointSpec, ChurnSpec, CodecSpec, DataSpec,
                             EngineSpec, EnvSpec, ExecSpec, ExperimentSpec,
                             ModelSpec, SpecError, TrainerSpec)


def _registry_type(reg):
    """argparse ``type=`` adapter: canonicalize through a registry, failing
    at PARSE time with the full registered choice set, or with "has no
    port yet" for a registered component the port does not have yet."""

    def parse(s: str):
        try:
            canon = reg.validate(s)
        except registry.RegistryError as e:
            raise argparse.ArgumentTypeError(str(e)) from None
        if not reg.is_ported(canon):
            raise argparse.ArgumentTypeError(f"{reg.kind} {canon!r} has no port yet")
        return canon

    parse.__name__ = reg.kind.replace(" ", "_")
    return parse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet-56",
                    type=_registry_type(registry.archs),
                    help="model family: " + ", ".join(registry.archs.names()))
    ap.add_argument("--method", default="dtfl",
                    type=_registry_type(registry.trainers),
                    help="algorithm: " + ", ".join(registry.trainers.names()))
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--population", type=int, default=None,
                    help="lazy client registry size: per-client state (data "
                         "pipeline, env profile, scheduler row, EF residual) "
                         "materializes on first participation. --samples "
                         "becomes PER-CLIENT dataset size; combine with "
                         "--sample-size and --exec chunked")
    ap.add_argument("--sample-size", type=int, default=None,
                    help="exact clients sampled per round (instead of "
                         "--participation * population); rounds/events only")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--dataset", default="cifar10",
                    type=_registry_type(registry.datasets),
                    help="image dataset for resnet archs (transformer archs "
                         "always train the token-LM task): "
                         + ", ".join(registry.datasets.names()))
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--full-size", action="store_true",
                    help="full config instead of the reduced variant")
    ap.add_argument("--scheduler", default="dynamic",
                    type=_registry_type(registry.schedulers),
                    help="tier scheduler spec: "
                         + " | ".join(registry.schedulers.choices()))
    ap.add_argument("--topology", default="server",
                    type=_registry_type(registry.topologies),
                    help="offload topology: server (classic DTFL) | pairing "
                         "(fast clients host slow clients' far halves; "
                         "implies --scheduler pairing)")
    ap.add_argument("--engine", default=None,
                    type=lambda s: s if s == "auto"  # the spec-level default
                    else _registry_type(registry.engines)(s),
                    help="rounds: scalar-clock synchronous loop; events: "
                         "discrete-event virtual clock (sync semantics, "
                         "supports churn); async: per-tier pacing with "
                         "staleness-weighted merges. Default: rounds")
    ap.add_argument("--exec", dest="exec_mode", default="cohort",
                    type=_registry_type(registry.exec_modes),
                    help="cohort: one program per tier cohort; chunked: the "
                         "same program --chunk-size clients at a time; loop: "
                         "one client at a time; sharded: each cohort's client "
                         "axis split over the ranks of a torch.distributed "
                         "group (NCCL on the card, gloo on the CPU), the "
                         "weighted sums all-reduced — see --devices")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks for --exec sharded (default: the launched "
                         "ranks, or 1). More than one needs torchrun "
                         "--nproc-per-node N, one rank a device")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="client-chunk length for --exec chunked (default "
                         "16)")
    ap.add_argument("--codec", default="identity",
                    type=_registry_type(registry.codecs),
                    help="communication codec for the three wires (activation "
                         "uplink z, client-model download, client-update "
                         "upload): " + " | ".join(registry.codecs.choices()))
    ap.add_argument("--n-groups", type=int, default=3,
                    help="speed groups for --engine async")
    ap.add_argument("--churn", action="store_true",
                    help="enable client churn (events/async engines only)")
    ap.add_argument("--churn-drop", type=float, default=0.1,
                    help="per-round mid-round dropout probability")
    ap.add_argument("--churn-switch", type=float, default=0.1,
                    help="per-round mid-round profile-switch probability")
    ap.add_argument("--churn-offline-frac", type=float, default=0.0,
                    help="fraction of the roster that starts offline and "
                         "arrives over time")
    ap.add_argument("--churn-rejoin", type=int, default=2,
                    help="rounds a dropped client stays offline")
    ap.add_argument("--target-acc", type=float, default=None)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dcor-alpha", type=float, default=0.0)
    ap.add_argument("--switch-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the RoundLog stream here as JSON")
    ap.add_argument("--out-spec", default=None,
                    help="write the resolved ExperimentSpec JSON here")
    ap.add_argument("--save-every", type=int, default=10,
                    help="checkpoint every N rounds (with --out-ckpt)")
    ap.add_argument("--out-ckpt", default=None,
                    help="write resumable train-state checkpoints here")
    ap.add_argument("--resume", default=None,
                    help="resume from a --out-ckpt envelope (either "
                         "package's): restores params, per-tier aux heads, "
                         "scheduler state, env profiles, EF residuals and the "
                         "rng streams, then continues deterministically "
                         "(rounds/events only). The envelope's spec stamp "
                         "must match this run's spec hash")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def spec_from_args(args) -> ExperimentSpec:
    """The flags -> spec translation (``repro/launch/train.py:153-186``)."""
    kind = registry.archs.meta(args.arch)["kind"]
    churn = None
    if args.churn:
        churn = ChurnSpec(drop=args.churn_drop, switch=args.churn_switch,
                          offline_frac=args.churn_offline_frac,
                          rejoin=args.churn_rejoin)
    return ExperimentSpec(
        model=ModelSpec(arch=args.arch, full_size=args.full_size),
        data=DataSpec(dataset=args.dataset if kind == "resnet" else "lm",
                      clients=args.clients, population=args.population,
                      samples=args.samples,
                      batch_size=args.batch_size, iid=args.iid,
                      seq_len=args.seq_len),
        env=EnvSpec(switch_every=args.switch_every),
        trainer=TrainerSpec(method=args.method, scheduler=args.scheduler,
                            topology=args.topology,
                            lr=args.lr, dcor_alpha=args.dcor_alpha,
                            sample_size=args.sample_size),
        engine=EngineSpec(name=args.engine or "auto", n_groups=args.n_groups,
                          churn=churn),
        exec=ExecSpec(mode=args.exec_mode, devices=args.devices,
                      chunk_size=args.chunk_size),
        codec=CodecSpec(name=args.codec),
        checkpoint=CheckpointSpec(path=args.out_ckpt,
                                  every=max(1, args.save_every),
                                  resume=args.resume),
        rounds=args.rounds, target_acc=args.target_acc,
        participation=args.participation, seed=args.seed,
    )


def build(args):
    """The built run of parsed ``args``: ``(trainer, eval_batch)``."""
    fed = spec_from_args(args).build(device=args.device)
    return fed.trainer, fed.eval_batch


def main(argv=None, *, on_round=None):
    """Parse ``argv``, train, print a summary; returns the RoundLog list.
    ``on_round(trainer, log)`` is called after each round."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        spec = spec_from_args(args)
    except SpecError as e:
        ap.error(str(e))
    fed = spec.build(device=args.device)
    plan = fed.trainer.exec_plan   # on the sharded plane, rank 0 prints and writes
    if args.out_spec and plan.lead:
        with open(args.out_spec, "w") as f:
            f.write(spec.to_json(indent=1))
    t0 = time.time()
    try:
        logs = fed.run(verbose=True, on_round=on_round)
    except SpecError as e:  # e.g. resume-envelope spec-hash mismatch
        ap.error(str(e))
    wall = time.time() - t0
    if plan.lead:
        print(f"[train] {args.method} {args.arch}: {len(logs)} rounds, "
              f"sim_clock={logs[-1].clock:,.0f}s acc={logs[-1].acc:.3f} wall={wall:.0f}s")
        if args.out:
            with open(args.out, "w") as f:
                json.dump([l.__dict__ for l in logs], f, default=str, indent=1)
    plan.barrier()
    return logs


if __name__ == "__main__":
    main()
