"""The paper's main experiment with the PyTorch port, scaled down (the
port's counterpart of ``examples/dtfl_cifar.py``).

The ``presets.cifar_paper`` scenario: ResNet on the CIFAR-shaped synthetic
task, heterogeneous clients, dynamic tier scheduling, non-IID
Dirichlet(0.5) partition, profile switching; DTFL against FedAvg in
simulated time to accuracy, one method override apart. Runs on the card
unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_dtfl_cifar.py --rounds 12
"""
from __future__ import annotations

import argparse

from repro_torch import presets


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--target", type=float, default=0.7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    results = {}
    for method in ("dtfl", "fedavg"):
        spec = presets.cifar_paper(method, rounds=args.rounds, clients=args.clients,
                                   target=args.target)
        logs = spec.build(device=args.device).run(verbose=True)
        results[method] = logs
        print(f"== {method}: acc={logs[-1].acc:.3f} sim_time={logs[-1].clock:,.0f}s "
              f"rounds={len(logs)}")

    speedup = results["fedavg"][-1].clock / max(results["dtfl"][-1].clock, 1e-9)
    print(f"\nDTFL vs FedAvg simulated speedup: {speedup:.1f}x "
          f"(paper reports ~5x on ResNet-110 CIFAR-10)")


if __name__ == "__main__":
    main()
