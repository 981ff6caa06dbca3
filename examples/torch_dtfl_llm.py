"""DTFL on an assigned transformer arch with the PyTorch port:
split-offloaded federated LM training with the dynamic tier scheduler, the
``repro_torch.presets.llm`` scenario (the port's counterpart of
``examples/dtfl_llm.py``).

The same spec drives the ResNets and the transformer archs the port runs
(SmolLM-360M, xLSTM-350M; reduced unless the spec says ``full_size``).
On the card, attention runs on kernel K4, the mLSTM on K5 and the token
loss on K3. Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_dtfl_llm.py --device cpu [--arch xlstm-350m]
"""
from __future__ import annotations

import argparse

from repro_torch import presets, registry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=[n for n in registry.archs.names()
                             if registry.archs.meta(n)["kind"] == "transformer"
                             and registry.archs.is_ported(n)])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    spec = presets.llm(args.arch, rounds=args.rounds, clients=args.clients,
                       seq_len=args.seq_len)
    logs = spec.build(device=args.device).run(verbose=True)
    print(f"[{args.arch}] next-token acc {logs[0].acc:.3f} -> {logs[-1].acc:.3f}; "
          f"sim clock {logs[-1].clock:,.0f}s "
          f"(times priced on the FULL {args.arch} cost table)")


if __name__ == "__main__":
    main()
