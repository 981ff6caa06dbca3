"""Quickstart with the PyTorch port: one declarative spec -> a DTFL run,
then the FedAvg baseline on the same data (the port's counterpart of
``examples/quickstart.py``).

The experiment is ONE frozen, JSON-round-trippable ``ExperimentSpec``;
``spec.build(device=...)`` wires the port's model, data, heterogeneous
environment and trainer, and ``run()`` trains. Any field is one
``with_overrides`` away. Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch import presets


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    spec = presets.quickstart(rounds=args.rounds, clients=args.clients)
    print("spec:", spec.to_json(indent=1))
    print("spec hash:", spec.spec_hash(), "\n")

    logs = spec.build(device=args.device).run(verbose=True)
    print(f"\ndtfl: {len(logs)} rounds, sim_clock={logs[-1].clock:,.0f}s "
          f"acc={logs[-1].acc:.3f}")

    # the FedAvg baseline on the same data, one override apart
    fedavg = spec.with_overrides({"trainer.method": "fedavg"})
    logs2 = fedavg.build(device=args.device).run()
    print(f"fedavg: sim_clock={logs2[-1].clock:,.0f}s acc={logs2[-1].acc:.3f}")
    print(f"dtfl vs fedavg simulated speedup: "
          f"{logs2[-1].clock / max(logs[-1].clock, 1e-9):.1f}x "
          "(tiers adapt to the observed client speeds across rounds)")


if __name__ == "__main__":
    main()
