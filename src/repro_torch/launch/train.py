"""Training entry point of the port (pair: ``repro/launch/train.py:1``).

Same flag names and defaults as ``python -m repro.launch.train``; builds
data, env, adapter and trainer exactly as ``repro/api.py:552-615`` and
``:708-786`` do, so the data, profile and participant streams match the JAX
package's. Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet-56 \\
      --full-size --clients 10 --rounds 3 --codec int8 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet-56 \\
      --full-size --population 100000 --sample-size 64 --samples 64 \\
      --exec chunked --chunk-size 16 --codec topk0.05 --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --full-size --clients 4 --batch-size 4 --seq-len 512 --rounds 3

Supported here: DTFL on the ResNet archs (image datasets, with the
distance-correlation regularizer ``--dcor-alpha`` on kernel K2),
SmolLM-360M (kernels K3 and K4) and xLSTM-350M (kernels K5 and K3) on the
token-LM task; schedulers ``dynamic``, ``pairing[:greedy|:hungarian]`` or
a fixed tier; ``--topology server|pairing``; codecs identity | bf16 | int8
| topk<frac>; ``--exec cohort|chunked|loop``; the lazy population
(``--population``, ``--sample-size``); the rounds and events engines, with
churn (``--engine events --churn``). Other archs, datasets and methods fail
at parse time with "not yet ported"; ``--exec sharded``, ``--devices``,
``--engine async`` and the checkpoint flags when the run is built or
started.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.configs.resnet_cifar import get_resnet
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.pipeline import ClientDataset, SeqClientDataset, make_eval_batch
from repro_torch.data.synthetic import ClassImageTask, SeqTask
from repro_torch.fed.adapter import ResNetAdapter, TransformerAdapter
from repro_torch.fed.client import ChurnModel, HeteroEnv, SimClient
from repro_torch.fed.dtfl import DTFLTrainer
from repro_torch.fed.execplan import ExecPlan
from repro_torch.fed.population import ClientStore, LazyHeteroEnv, cid_rng

RESNET_ARCHS = ("resnet-56", "resnet-110", "resnet-bench", "resnet-micro")
TRANSFORMER_ARCHS = ("smollm-360m", "xlstm-350m")
ARCHS = RESNET_ARCHS + TRANSFORMER_ARCHS
# the image datasets of repro/registry.py:309-314 (n_classes, noise, seed)
DATASETS = {
    "cifar10": (10, 0.35, 0),
    "cifar100": (100, 0.35, 0),
    "cinic10": (10, 0.5, 1),
    "ham10000": (7, 0.35, 2),
    "cifar10-hard": (10, 0.6, 0),
    "cifar10-noisy": (10, 1.0, 0),
}
DIRICHLET_ALPHA = 0.5     # repro/api.py DataSpec.alpha
EVAL_SIZE = 512           # repro/api.py: eval_size None -> 512 images
LM_BATCHES = 2            # repro/api.py DataSpec.n_batches: LM batches per client
LM_EVAL_SEED = 99         # repro/api.py:782: the LM eval batch's stream


def _not_yet_ported(choices):
    def parse(s: str) -> str:
        if s not in choices:
            raise argparse.ArgumentTypeError(
                f"{s!r} is not yet ported; choose from {', '.join(choices)}")
        return s

    return parse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet-56", type=_not_yet_ported(ARCHS))
    ap.add_argument("--method", default="dtfl", type=_not_yet_ported(("dtfl",)))
    ap.add_argument("--full-size", action="store_true",
                    help="full config instead of the reduced variant")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--population", type=int, default=None,
                    help="lazy client registry of this size: a client's data, "
                         "profile and scheduler state are built on its first "
                         "participation; --samples is then PER CLIENT")
    ap.add_argument("--sample-size", type=int, default=None,
                    help="clients sampled per round (instead of "
                         "--participation * clients)")
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--dataset", default="cifar10", type=_not_yet_ported(tuple(DATASETS)))
    ap.add_argument("--iid", action="store_true")
    # the trainer resolves --scheduler and --codec and raises on other values
    ap.add_argument("--scheduler", default="dynamic",
                    help="dynamic | pairing | pairing:greedy | pairing:hungarian | "
                         "<fixed tier index, e.g. 0>")
    ap.add_argument("--topology", default="server", choices=("server", "pairing"),
                    help="pairing: fast clients host slow clients' far halves "
                         "(implies --scheduler pairing)")
    ap.add_argument("--exec", dest="exec_mode", default="cohort",
                    choices=("cohort", "loop", "chunked", "sharded"),
                    help="cohort: one program per tier cohort; chunked: the same "
                         "program --chunk-size clients at a time; loop: one client "
                         "at a time; sharded: not yet ported")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="client-chunk length for --exec chunked (default 16)")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size for --exec sharded: not yet ported")
    ap.add_argument("--codec", default="identity",
                    help="identity | bf16 | int8 | topk<frac> (e.g. topk0.05)")
    ap.add_argument("--engine", default="rounds", choices=("rounds", "events", "async"),
                    help="rounds: scalar-clock loop; events: discrete-event clock "
                         "(supports --churn); async: not yet ported")
    ap.add_argument("--churn", action="store_true",
                    help="client churn (events engine only)")
    ap.add_argument("--churn-drop", type=float, default=0.1,
                    help="per-round mid-round dropout probability")
    ap.add_argument("--churn-switch", type=float, default=0.1,
                    help="per-round mid-round profile-switch probability")
    ap.add_argument("--churn-offline-frac", type=float, default=0.0,
                    help="fraction of the roster that starts offline")
    ap.add_argument("--churn-rejoin", type=int, default=2,
                    help="rounds a dropped client stays offline")
    ap.add_argument("--save-every", type=int, default=None, help="checkpoints: not yet ported")
    ap.add_argument("--out-ckpt", default=None, help="checkpoints: not yet ported")
    ap.add_argument("--resume", default=None, help="checkpoints: not yet ported")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--switch-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dcor-alpha", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def _build_lm(args):
    """Adapter, clients and eval batch of a transformer arch: the token-LM
    task, ``LM_BATCHES`` batches per client (``repro/api.py:760-786``)."""
    cfg_full = get_config(args.arch)
    cfg = cfg_full if args.full_size else cfg_full.reduced()
    adapter = TransformerAdapter(cfg, seq_len=args.seq_len, cost_cfg=cfg_full,
                                 dcor_alpha=args.dcor_alpha)
    task = SeqTask(vocab=cfg.vocab)
    make = lambda i: SimClient(
        i, SeqClientDataset(task, LM_BATCHES, args.batch_size, args.seq_len, i), None)
    if args.population is not None:
        clients = ClientStore(args.population, make)
    else:
        clients = [make(i) for i in range(args.clients)]
    eval_batch = next(task.batches(args.batch_size, args.seq_len, 1, seed=LM_EVAL_SEED))
    return adapter, clients, eval_batch


def _build_images(args):
    """Adapter, clients and eval batch of a ResNet arch: an image dataset,
    partitioned as ``repro/api.py:708-757`` partitions it."""
    cfg_full = get_resnet(args.arch)
    cfg = cfg_full if args.full_size else cfg_full.reduced()
    adapter = ResNetAdapter(cfg, cost_cfg=cfg_full, dcor_alpha=args.dcor_alpha)
    n_classes, noise, task_seed = DATASETS[args.dataset]
    task = ClassImageTask(n_classes=n_classes, image_size=cfg.image_size,
                          noise=noise, seed=task_seed)
    if args.population is not None:
        return adapter, _population_images(args, task), make_eval_batch(task, EVAL_SIZE)
    rng = np.random.default_rng(args.seed)
    labels = rng.integers(0, task.n_classes, args.samples)
    if args.iid:
        parts = iid_partition(labels, args.clients, seed=args.seed)
    else:
        parts = dirichlet_partition(labels, args.clients, DIRICHLET_ALPHA, seed=args.seed)
    clients = [
        SimClient(i, ClientDataset(task, labels, parts[i], args.batch_size), None)
        for i in range(args.clients)
    ]
    return adapter, clients, make_eval_batch(task, EVAL_SIZE)


def _population_images(args, task) -> ClientStore:
    """The lazy registry of ``repro/api.py:719-744``: each client's labels
    are a pure function of (seed, cid), IID or a per-client Dirichlet class
    mix, ``--samples`` of them, built on first participation."""
    per, bs, n_cls = args.samples, args.batch_size, task.n_classes

    def factory(cid: int):
        r = cid_rng(args.seed, 21, cid)
        if args.iid:
            labels = r.integers(0, n_cls, per)
        else:
            labels = r.choice(n_cls, size=per, p=r.dirichlet([DIRICHLET_ALPHA] * n_cls))
        # seed=cid+1: distinct per-client batch-shuffle streams
        return SimClient(cid, ClientDataset(task, labels, np.arange(per), bs, seed=cid + 1),
                         None)

    return ClientStore(args.population, factory)


def _check_ported(args) -> None:
    for flag, value in (("--devices", args.devices), ("--save-every", args.save_every),
                        ("--out-ckpt", args.out_ckpt), ("--resume", args.resume)):
        if value is not None:
            raise NotImplementedError(f"{flag} is not yet ported")


def build(args) -> tuple[DTFLTrainer, dict]:
    """Trainer and eval batch for parsed ``args``."""
    _check_ported(args)
    plan = ExecPlan.from_flags(args.exec_mode, chunk_size=args.chunk_size)
    build_data = _build_lm if args.arch in TRANSFORMER_ARCHS else _build_images
    adapter, clients, eval_batch = build_data(args)
    if args.population is not None:
        env = LazyHeteroEnv(args.population, switch_every=args.switch_every, seed=args.seed)
    else:
        env = HeteroEnv(args.clients, switch_every=args.switch_every, seed=args.seed)
    trainer = DTFLTrainer(adapter, clients, env, optim.adam(args.lr), seed=args.seed,
                          scheduler=args.scheduler, topology=args.topology,
                          exec_plan=plan, codec=args.codec, device=args.device)
    return trainer, eval_batch


def make_churn(args) -> "ChurnModel | None":
    """The ``--churn*`` flags' model over the registered clients
    (``repro/api.py:641-648``), seeded with ``--seed``."""
    if not args.churn:
        return None
    n = args.population if args.population is not None else args.clients
    return ChurnModel(n, drop_prob=args.churn_drop, switch_prob=args.churn_switch,
                      start_offline_frac=args.churn_offline_frac,
                      rejoin_after=args.churn_rejoin, seed=args.seed)


def main(argv=None, *, on_round=None):
    """Parse ``argv``, train, print a summary; returns the RoundLog list.
    ``on_round(trainer, log)`` is called after each round."""
    args = build_parser().parse_args(argv)
    trainer, eval_batch = build(args)
    t0 = time.time()
    logs = trainer.run(args.rounds, eval_batch, verbose=True, on_round=on_round,
                       participation=args.participation, sample_size=args.sample_size,
                       engine=args.engine, churn=make_churn(args))
    wall = time.time() - t0
    print(f"[train] dtfl {args.arch}: {len(logs)} rounds, "
          f"sim_clock={logs[-1].clock:,.0f}s acc={logs[-1].acc:.3f} wall={wall:.0f}s")
    return logs


if __name__ == "__main__":
    main()
