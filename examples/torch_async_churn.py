"""Event-engine tour of the PyTorch port: sync vs async tiers under churn.

The port's counterpart of ``examples/async_churn.py``: the same 8-client
DTFL scenario (``repro_torch.presets.async_churn``) run three ways — the
synchronous rounds loop, the discrete-event engine with churn (mid-round
dropouts, arrivals, profile switches) and async tiers (per-group waves,
staleness-weighted merges) — and each mode's virtual-clock / accuracy
trajectory. Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_async_churn.py --rounds 6 --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch import presets


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--n-groups", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    base = dict(clients=args.clients, rounds=args.rounds,
                n_groups=args.n_groups)
    for mode, spec in (
        ("rounds (sync)", presets.async_churn(engine="rounds", **base)),
        ("events + churn", presets.async_churn(engine="events", churn=True,
                                               **base)),
        ("async tiers", presets.async_churn(engine="async", **base)),
    ):
        logs = spec.build(device=args.device).run()
        last = logs[-1]
        print(f"\n== {mode} ==")
        for l in logs:
            print(f"  step={l.round:<3d} clock={l.clock:9.1f}s acc={l.acc:.3f} "
                  f"wall={l.wall_s:.2f}s")
        print(f"  -> {len(logs)} steps, final clock {last.clock:,.0f}s acc {last.acc:.3f}")


if __name__ == "__main__":
    main()
