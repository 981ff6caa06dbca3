"""Dynamic tier scheduler — Algorithm 1 of the paper.

Verbatim copy of ``repro/core/scheduler.py:1`` up to ``StaticScheduler``
(``:313``), with its imports pointed at the port; ``PairingScheduler``
comes with the topology plane.

Host-side (numpy) component. The scheduler sees ONLY what the paper's server
sees per round:
  * the measured total client-side time of each client in its assigned tier,
  * the client's communicated link speed ``nu`` (bytes/s),
  * the client's batch count ``n_batches``.

Tier profiling (done once, lines "Tier Profiling"): reference per-tier
client/server times ``t_client_ref[m]``, ``t_server_ref[m]`` on a standard
batch, and transfer sizes — per-batch uplink ``z_bytes[m]`` plus the
per-round parameter wire ``param_bytes[m]``, kept separate so per-client
communication composes as ``z_bytes*N_k + param_bytes`` for any task size
``N_k`` (folding them into one per-batch ``d_size`` baked a reference batch
count into the profile and overcounted the download by ``N_k/N_ref`` for
clients whose task size differs). The Table-2 invariance — normalized
time ratios between tiers are client-independent — lets the scheduler
extrapolate a client's time in *unobserved* tiers from the one observed tier
(Algorithm 1 lines 24-29).

Scheduling (lines 31-33):
  T_max  = max_k min_m  T_hat_k(m)
  m_k    = argmax_m { m : T_hat_k(m) <= T_max }   (least offloading)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TierProfile:
    """Server-side profiling table (per standard batch).

    Communication is profiled per wire: ``z_bytes`` scales with a client's
    batch count, ``param_bytes`` is paid once per round. Legacy callers may
    still pass a combined per-batch ``d_size``; it is treated as all-z
    (every byte scales with n_batches), which reproduces the old
    ``d_size * N / nu`` composition exactly.
    """

    t_client_ref: np.ndarray   # (M,) reference client compute time per batch
    t_server_ref: np.ndarray   # (M,) server compute time per batch
    d_size: np.ndarray | None = None       # legacy: combined bytes per batch
    z_bytes: np.ndarray | None = None      # (M,) per-batch uplink bytes
    param_bytes: np.ndarray | None = None  # (M,) per-round parameter bytes
    server_speedup: float | None = None    # server flops / reference-client flops

    def __post_init__(self):
        if self.server_speedup is None:
            from repro_torch.core.timemodel import SERVER_FLOPS, UNIT_FLOPS

            self.server_speedup = SERVER_FLOPS / UNIT_FLOPS
        self.server_speedup = float(self.server_speedup)
        if self.z_bytes is None:
            if self.d_size is None:
                raise ValueError("TierProfile needs z_bytes (+param_bytes) "
                                 "or a legacy d_size")
            self.z_bytes = np.asarray(self.d_size, float)
        else:
            self.z_bytes = np.asarray(self.z_bytes, float)
        if self.param_bytes is None:
            self.param_bytes = np.zeros_like(self.z_bytes)
        else:
            self.param_bytes = np.asarray(self.param_bytes, float)

    @property
    def n_tiers(self) -> int:
        return len(self.t_client_ref)

    def comm_bytes(self, tiers, n_batches):
        """Per-round wire bytes for clients at ``tiers`` with ``n_batches``
        local batches (the D^m*N term of Algorithm 1 line 22, per-wire)."""
        return (self.z_bytes[tiers] * np.asarray(n_batches, float)
                + self.param_bytes[tiers])

    @classmethod
    def from_cost_table(cls, costs, *, ref_flops: float, server_flops: float,
                        wires=None):
        """Build the profile from an analytic TierCostTable (timemodel.py).

        ``wires`` (a ``codec.WireSizes``) prices the wires under the active
        compression codec; None uses the identity accounting. The profile
        keeps z and parameter bytes separate — the old version baked a
        reference ``n_batches`` into one d_size, which overcounted the
        parameter wire for clients with a different task size.
        """
        from repro_torch.core.codec import wire_sizes

        w = wires if wires is not None else wire_sizes(costs)
        return cls(
            t_client_ref=costs.client_flops / ref_flops,
            t_server_ref=costs.server_flops / server_flops,
            z_bytes=np.asarray(w.z_bytes, float).copy(),
            param_bytes=np.asarray(w.param_bytes, float).copy(),
            server_speedup=server_flops / ref_flops,
        )


class EMA:
    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self.value: float | None = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else self.alpha * x + (1 - self.alpha) * self.value
        return self.value


@dataclass
class _ClientState:
    tier: int                      # currently assigned tier (0-based)
    nu: float = 1e6                # last communicated link bytes/s
    n_batches: int = 1
    ema: dict = field(default_factory=dict)   # tier -> EMA of client compute time
    last_obs_tier: int | None = None


class _LazyClientStates:
    """Per-client scheduler state, materialized on first access.

    Looks like the dense ``list[_ClientState]`` it replaced (``len``, ``[]``,
    iteration — tests and small-n callers iterate it), but a never-observed
    client allocates no state until someone touches it, so a million-client
    registry costs O(sampled participants), not O(population). Iteration
    materializes everything and is reserved for test-sized registries.
    """

    def __init__(self, n: int, init_tier: int):
        self._n = int(n)
        self._init_tier = int(init_tier)
        self._states: dict[int, _ClientState] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k: int) -> _ClientState:
        k = int(k)
        if not 0 <= k < self._n:
            raise IndexError(f"client id {k} out of range [0, {self._n})")
        st = self._states.get(k)
        if st is None:
            st = self._states[k] = _ClientState(tier=self._init_tier)
        return st

    def __iter__(self):
        for k in range(self._n):
            yield self[k]

    @property
    def n_touched(self) -> int:
        return len(self._states)

    def touched(self) -> list[int]:
        return sorted(self._states)

    def touched_items(self) -> list[tuple[int, _ClientState]]:
        return sorted(self._states.items())

    def is_touched(self, k: int) -> bool:
        return int(k) in self._states

    def compact(self, keep) -> None:
        keep = set(int(k) for k in keep)
        self._states = {k: v for k, v in self._states.items() if k in keep}


class DynamicTierScheduler:
    """Stateful per-round scheduler. Tiers are 0-based here (paper: 1-based).

    The estimate matrix is INCREMENTAL: each client's T_hat row is cached
    and only recomputed after a new observation lands for that client (or
    for a never-observed client, served from one shared default row), so a
    round's scheduling costs O(observed-this-round + participants), never
    O(population). ``_row_recomputes`` counts row rebuilds — the
    regression test pins that it tracks observations, not registry size.
    """

    def __init__(self, profile: TierProfile, n_clients: int, *, ema_alpha: float = 0.5,
                 init_tier: int | None = None, allowed: list[int] | None = None):
        self.profile = profile
        self.M = profile.n_tiers
        # Table 11: an M-tier deployment exposes the LAST M split options
        # (the full-client option always exists; more tiers add offloading)
        self.allowed = sorted(allowed) if allowed is not None else list(range(self.M))
        init_tier = self.allowed[-1] if init_tier is None else init_tier
        self.clients = _LazyClientStates(n_clients, init_tier)
        self._rows: dict[int, np.ndarray] = {}   # cid -> cached T_hat row
        self._default_row: np.ndarray | None = None
        self._row_recomputes = 0

    # ------------------------------------------------------------------
    # Algorithm 1, lines 21-23: measure & update histories
    # ------------------------------------------------------------------
    def observe(self, k: int, *, tier: int, total_client_time: float, nu: float,
                n_batches: int) -> None:
        """Record a round observation for client k.

        ``total_client_time`` includes communication (as measured by a real
        server); the compute part is recovered as T - D^m * N / nu (line 22).
        """
        st = self.clients[k]
        st.nu = nu
        st.n_batches = n_batches
        comm = self.profile.comm_bytes(tier, n_batches) / nu
        compute = max(total_client_time - comm, 1e-9)
        st.ema.setdefault(tier, EMA()).update(compute)
        st.last_obs_tier = tier
        st.tier = tier
        self._rows.pop(k, None)    # row depends on (nu, nb, ema): recompute lazily

    def observe_cohort(self, ks, tiers, total_client_times, nus, n_batches) -> None:
        """Vectorized :meth:`observe` for a whole round's participants.

        The compute-time recovery (line 22) is done as one array expression;
        per-client EMA state updates follow. Results are identical to calling
        ``observe`` per client."""
        tiers = np.asarray(tiers, int)
        nb = np.asarray(n_batches)
        comm = self.profile.comm_bytes(tiers, nb) / np.asarray(nus, float)
        compute = np.maximum(np.asarray(total_client_times, float) - comm, 1e-9)
        for k, tier, c, nu, n in zip(ks, tiers, compute, nus, nb):
            st = self.clients[k]
            st.nu = float(nu)
            st.n_batches = int(n)
            st.ema.setdefault(int(tier), EMA()).update(float(c))
            st.last_obs_tier = int(tier)
            st.tier = int(tier)
            self._rows.pop(int(k), None)

    # ------------------------------------------------------------------
    # Algorithm 1, lines 24-29: per-tier estimates
    # ------------------------------------------------------------------
    def _state_row(self, nu: float, nb: float, last_obs_tier, ema_value) -> np.ndarray:
        """One client's T_hat row (Eq. 5 composition). Same elementwise IEEE
        expressions as the old dense (K, M) rebuild, so cached rows are
        bit-identical to a from-scratch recompute."""
        prof = self.profile
        t_com = (prof.z_bytes * nb + prof.param_bytes) / nu                   # (M,)
        t_srv = prof.t_server_ref * nb                                        # (M,)
        if last_obs_tier is None:
            t_cli = prof.t_client_ref * nb                                    # no-obs fallback
        else:
            m0 = last_obs_tier
            t_cli = prof.t_client_ref / prof.t_client_ref[m0] * ema_value     # EMA'd round time
        return np.maximum(t_cli + t_com, t_srv + t_com)

    def _row(self, k: int) -> np.ndarray:
        """Cached T_hat row for client ``k``; recomputed only after a new
        observation invalidated it. Never-observed clients share ONE default
        row (their state is uniform), so they cost no per-client work."""
        k = int(k)
        row = self._rows.get(k)
        if row is not None:
            return row
        if not self.clients.is_touched(k):
            if self._default_row is None:
                d = _ClientState(tier=0)    # tier does not enter the row
                self._default_row = self._state_row(
                    float(d.nu), float(d.n_batches), None, None)
                self._row_recomputes += 1
            return self._default_row
        st = self.clients[k]
        m0 = st.last_obs_tier
        row = self._state_row(
            float(st.nu), float(st.n_batches), m0,
            st.ema[m0].value if m0 is not None else None)
        self._rows[k] = row
        self._row_recomputes += 1
        return row

    def estimate_matrix(self, ks: list[int]) -> np.ndarray:
        """T_hat_k(m) for every k in ``ks`` and every m, as a (K, M) matrix
        (Eq. 5 composition). Assembled from per-client cached rows — cost is
        O(rows invalidated since the last call), not O(population)."""
        return np.stack([self._row(k) for k in ks])

    def estimate(self, k: int) -> np.ndarray:
        """T_hat_k(m) for all m (Eq. 5 composition)."""
        return self.estimate_matrix([k])[0]

    # ------------------------------------------------------------------
    # Algorithm 1, lines 31-33: assignment
    # ------------------------------------------------------------------
    def schedule(self, participants: list[int] | None = None) -> dict[int, int]:
        ks = list(range(len(self.clients))) if participants is None else list(participants)
        sel = np.array(self.allowed)
        est = self.estimate_matrix(ks)[:, sel]                                # (K, |sel|)
        t_max = est.min(axis=1).max()                                         # line 31
        feasible = est <= t_max + 1e-12
        assign = {}
        for i, k in enumerate(ks):                                            # line 33
            ok = np.flatnonzero(feasible[i])
            m = int(sel[ok.max()]) if len(ok) else int(sel[est[i].argmin()])
            assign[k] = m
            self.clients[k].tier = m
        return assign

    def round_time(self, assign: dict[int, int]) -> float:
        """Estimated straggler time under an assignment."""
        return max(self.estimate(k)[m] for k, m in assign.items())

    def compact(self, keep) -> None:
        """Drop per-client state/rows of clients outside ``keep`` (permanent
        departures); a compacted client that returns restarts from the
        default (never-observed) state."""
        self.clients.compact(keep)
        keep = set(int(k) for k in keep)
        self._rows = {k: v for k, v in self._rows.items() if k in keep}


class StaticScheduler:
    """Ablation: fixed tier for everyone (the paper's Table 1 columns)."""

    def __init__(self, tier: int, n_clients: int):
        self.tier = tier
        self.n = n_clients

    def observe(self, *a, **kw):
        pass

    def observe_cohort(self, *a, **kw):
        pass

    def schedule(self, participants=None) -> dict[int, int]:
        ks = range(self.n) if participants is None else participants
        return {k: self.tier for k in ks}
