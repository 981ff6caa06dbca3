"""Offload topology: who executes each client's far half, and at what price.

Verbatim copy of ``repro/core/topology.py:1`` (``Assignment``,
``as_assignment``, ``OffloadTopology``, ``simulate_times``), its time model
the port's.

DTFL (PAPER.md §3) hardcodes "the far half runs on *the server*".  The
pairing literature (arxiv 2308.13849) shows fast clients can instead host
slow clients' far-halves, with the activation/update wires priced per-link
(FedDCT, arxiv 2307.04420).  This module is the host-agnostic layer between
the schedulers and the time model:

* :class:`Assignment` — one client's generalized schedule entry
  ``(tier, host)``; ``host == SERVER`` (-1) is the classic DTFL case,
  ``host == cid`` of a peer means that peer executes the far half.
* :class:`OffloadTopology` — a round's full ``cid -> Assignment`` map, plus
  the engine-side widening adapter :meth:`OffloadTopology.from_schedule`
  that accepts the narrow ``cid -> tier`` dicts the static/dynamic
  schedulers return, so baselines that ignore hosts keep working without
  per-trainer shims.
* :func:`simulate_times` — per-link Eq. 5 pricing under an arbitrary
  topology.  For a server-only topology it reduces exactly to
  ``timemodel.simulate_client_times_batch`` with the legacy arguments
  (equivalence-tested), so ``topology=server`` stays bit-for-bit identical.

Only scheduling and time/byte accounting change with the topology.  The
training math (cohort programs, aux heads, aggregation) is keyed by tier
alone — *where* the far half runs is a simulation-plane distinction, exactly
like client ``ResourceProfile``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, NamedTuple, Sequence

import numpy as np

from repro_torch.core import timemodel

SERVER = -1  # host id of the central server


class Assignment(NamedTuple):
    """Generalized schedule entry for one client: ``(tier, host)``."""

    tier: int
    host: int = SERVER


def as_assignment(value) -> Assignment:
    """Widen a scheduler output value: bare tier int or ``(tier, host)``."""
    if isinstance(value, Assignment):
        return value
    if isinstance(value, tuple):
        tier, host = value
        return Assignment(int(tier), int(host))
    return Assignment(int(value), SERVER)


@dataclass(frozen=True)
class OffloadTopology:
    """A round's full offload map: ``cid -> Assignment``."""

    assign: Mapping[int, Assignment]

    @classmethod
    def from_schedule(cls, schedule: Mapping[int, object]) -> "OffloadTopology":
        """Engine-side adapter over ``scheduler.schedule()`` output.

        Accepts the narrow ``cid -> tier`` dict (StaticScheduler,
        DynamicTierScheduler) and the generalized ``cid -> (tier, host)``
        dict (PairingScheduler) alike.
        """
        return cls({int(k): as_assignment(v) for k, v in schedule.items()})

    def tiers(self) -> dict[int, int]:
        """The narrow view every existing consumer (cohorts, EF, logs) uses."""
        return {k: a.tier for k, a in self.assign.items()}

    def hosts(self) -> dict[int, int]:
        return {k: a.host for k, a in self.assign.items()}

    @property
    def is_server_only(self) -> bool:
        return all(a.host == SERVER for a in self.assign.values())

    def server_hosted(self) -> list[int]:
        return [k for k, a in self.assign.items() if a.host == SERVER]

    def guests_of(self) -> dict[int, list[int]]:
        """host cid -> guests whose far half it executes."""
        out: dict[int, list[int]] = {}
        for k, a in self.assign.items():
            if a.host != SERVER:
                out.setdefault(a.host, []).append(k)
        return out


def simulate_times(costs, topo: OffloadTopology, participants: Sequence[int],
                   profiles: Iterable[timemodel.ResourceProfile],
                   n_batches: np.ndarray, *,
                   server_flops: float = timemodel.SERVER_FLOPS,
                   wires=None) -> dict[str, np.ndarray]:
    """Per-link Eq. 5 round times under a general offload topology.

    Pricing model:

    * server-hosted clients share ``server_flops`` equally — but only among
      themselves (``n_sharing`` = number of server-hosted participants, the
      capacity relief pairing buys);
    * a peer-hosted far half runs at the host's full device speed, and its
      wire is the bottleneck of the two ends' bandwidths;
    * a host's own round is extended by the far-half work it executes for
      its guests (hosting is serialized with the host's own training).
    """
    parts = list(participants)
    pos = {k: i for i, k in enumerate(parts)}
    tiers = np.array([topo.assign[k].tier for k in parts])
    hosts = [topo.assign[k].host for k in parts]
    flops = np.array([p.flops for p in profiles])
    bps = np.array([p.bytes_per_s for p in profiles])
    nb = np.asarray(n_batches)

    n_srv = max(sum(1 for h in hosts if h == SERVER), 1)
    far_flops = np.empty(len(parts))
    link = bps.copy()
    for i, h in enumerate(hosts):
        if h == SERVER:
            far_flops[i] = server_flops / n_srv
        else:
            far_flops[i] = flops[pos[h]]
            link[i] = min(bps[i], bps[pos[h]])

    t = timemodel.simulate_client_times_batch(
        costs, tiers, flops, bps, nb, server_flops=server_flops,
        wires=wires, far_flops=far_flops, link_bytes_per_s=link)

    # hosting extends the host's round by its guests' far-half work
    hosting = np.zeros(len(parts))
    for i, h in enumerate(hosts):
        if h != SERVER:
            hosting[pos[h]] += t["server"][i]
    t["total"] = t["total"] + hosting
    t["link"] = link
    return t
