"""Privacy integration (paper §4.4) with the PyTorch port:
distance-correlation regularized DTFL (the port's counterpart of
``examples/privacy_dcor.py``).

Trains the ``repro_torch.presets.table5`` scenario with alpha in {0, 0.5}
and reports the accuracy and the achieved DCor(x, z): lower DCor means the
uploaded activations reveal less about the raw inputs. On the card the
regularizer's pairwise distances run on kernel K2. Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_privacy_dcor.py --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import presets
from repro_torch.data.pipeline import make_eval_batch
from repro_torch.models import resnet as R
from repro_torch.privacy import dcor
from repro_torch.tree import tree_map


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    for alpha in (0.0, 0.5):
        fed = presets.table5(alpha, rounds=args.rounds).with_overrides(
            {"data.clients": 4}).build(device=args.device)
        logs = fed.run()
        # probe on the same synthetic task the clients trained on; the
        # port's model functions take a leading client axis
        device = fed.trainer.device
        task = fed.clients[0].dataset.task
        x = torch.from_numpy(make_eval_batch(task, 128)["images"]).to(device)[None]
        cp, _ = fed.adapter.split(fed.trainer.params, 1)
        with torch.no_grad():
            z = R.client_forward(tree_map(lambda t: t[None], cp), fed.adapter.cfg, x)
            leak = float(dcor(x, z)[0])
        print(f"alpha={alpha}: acc={logs[-1].acc:.3f}  DCor(x, z)={leak:.3f}")
    print("higher alpha => lower DCor (less leakage) at a small accuracy cost")


if __name__ == "__main__":
    main()
