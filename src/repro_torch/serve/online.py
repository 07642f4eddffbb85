"""Online policy refit: close the learned-vs-oracle gap from settled serving
(port of ``src/repro/serve/online.py``).

A ``LearnedPolicy`` fitted on the offline design space routes a live stream
it never saw. This module closes the loop:

  * every committed draft of ``repro_torch.serve.queue.serve_stream`` is
    observed: the request's raw feature row at its decision cell under the
    ACTUAL CI table, the per-tier carbon it settled at, per-tier latency /
    energy / QoS feasibility from the factorized evaluator, and the
    hindsight-optimal label (cheapest feasible tier at actual CI);
  * tuples accumulate in a bounded host-side replay buffer;
  * when enough fresh tuples settle, ``step`` refits the scheduler on the
    buffer (fresh standardization statistics) through the offline path
    (``LearnedPolicy.fit``, on the host) and hot-swaps the params into a
    rebuilt ``FleetRouter`` on the same device. The reference recompiles
    its jitted stream program there; eager torch has nothing to recompile.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import carbon_model
from repro_torch.core.schedulers import ClassificationScheduler, SchedulerDataset
from repro_torch.core.workloads import Workload
from repro_torch.serve.policy import LearnedPolicy, feature_rows
from repro_torch.serve.router import FleetRouter


@dataclasses.dataclass
class ReplayBuffer:
    """Bounded FIFO of settled routing tuples (columnar, host-side)."""

    max_rows: int = 200_000

    def __post_init__(self):
        self._chunks: list[tuple[np.ndarray, ...]] = []
        self._rows = 0

    def __len__(self) -> int:
        return self._rows

    def append(self, feats: np.ndarray, labels: np.ndarray,
               total_cf: np.ndarray, energy: np.ndarray,
               latency: np.ndarray, feasible: np.ndarray) -> None:
        self._chunks.append((feats, labels, total_cf, energy, latency,
                             feasible))
        self._rows += len(labels)
        while self._rows - len(self._chunks[0][1]) >= self.max_rows:
            self._rows -= len(self._chunks.pop(0)[1])

    def dataset(self) -> SchedulerDataset:
        """The buffer as a ``SchedulerDataset`` with FRESH standardization
        statistics (float64, as the reference computes them)."""
        if not self._rows:
            raise ValueError("empty replay buffer")
        cols = [np.concatenate([c[i] for c in self._chunks])
                for i in range(6)]
        X, labels, total_cf, energy, latency, feasible = cols
        mean = X.mean(0)
        std = np.maximum(X.std(0), 1e-9)
        return SchedulerDataset(
            features=((X - mean) / std).astype(np.float32),
            labels=labels.astype(np.int64),
            total_cf=total_cf, energy=energy, latency=latency,
            feasible=feasible,
            feat_mean=mean.astype(np.float32),
            feat_std=std.astype(np.float32))


@dataclasses.dataclass
class OnlineRefitter:
    """Accumulate settled tuples, periodically refit, hot-swap the router.

    ``scheduler_factory`` builds a fresh scheduler per refit (default: the
    carbon-headed classification scheduler). ``min_observations`` gates the
    first refit; after that a refit triggers every ``refit_every`` fresh
    observations. ``observe`` / ``step`` are driven by ``serve_stream``;
    ``step`` returns the (possibly rebuilt) router, also kept on
    ``self.router``."""

    scheduler_factory: Callable = ClassificationScheduler
    min_observations: int = 4096
    refit_every: int = 8192
    max_buffer: int = 200_000
    emb_lca: bool = False

    def __post_init__(self):
        self.buffer = ReplayBuffer(self.max_buffer)
        self.n_refits = 0
        self.router: FleetRouter | None = None
        self._since_refit = 0

    def observe(self, fr: FleetRouter, fb, targets: np.ndarray,
                committed: np.ndarray) -> None:
        """Settle a committed draft into the buffer: ``fb`` the
        ``FormedBatch`` just routed, ``targets`` its (k,) decisions,
        ``committed`` the (k,) mask of rows that routed (held and shed rows
        settled no carbon). Features are the raw rows at the decision cell
        under the ACTUAL CI table, labels the hindsight-cheapest feasible
        tier there."""
        k = fb.n
        keep = committed & np.asarray(fb.batch.available)[:k].any(axis=1)
        if not keep.any():
            return
        idx = np.nonzero(keep)[0]
        dev = fr.device
        sub = torch.as_tensor(idx, device=dev)
        w = fb.batch.workload(fr.cfg, device=dev)
        w = Workload(*[getattr(w, f.name)[sub]
                       for f in dataclasses.fields(Workload)])
        factors = carbon_model.energy_factors_batch(
            w, fr.infra, fr._interference, fr._net_slowdown)
        region = torch.as_tensor(fb.region[:k], device=dev).long()[sub]
        hour = torch.as_tensor(fb.hour[:k], device=dev).long()[sub]
        ci = fr._ci_table[region, hour]  # (m, 5) ACTUAL rows — settlement
        host = lambda t: t.cpu().numpy()
        X = host(feature_rows(w, ci, fr._interference, fr._net_slowdown,
                              hour, self.emb_lca))
        avail = np.asarray(fb.batch.available)[:k][idx]
        total_cf = host(carbon_model.total_cf_from_factors(factors, ci))
        feasible = host(carbon_model.qos_feasible_from_factors(
            factors, w)) & avail
        # hindsight label: cheapest feasible tier at actual CI; when nothing
        # is feasible, cheapest available (the oracle's degenerate fallback)
        cf_feas = np.where(feasible, total_cf, np.inf)
        none_ok = ~feasible.any(axis=1)
        cf_feas[none_ok] = np.where(avail, total_cf, np.inf)[none_ok]
        labels = cf_feas.argmin(axis=1)
        self.buffer.append(X, labels, total_cf, host(factors.energy_j),
                           host(factors.latency), feasible)
        self._since_refit += len(labels)

    def should_refit(self) -> bool:
        if len(self.buffer) < self.min_observations:
            return False
        return (self.n_refits == 0
                or self._since_refit >= self.refit_every)

    def step(self, fr: FleetRouter) -> tuple[FleetRouter, bool]:
        """Between-steps hook: refit + hot-swap when due. Returns the
        router for the next step (a new ``FleetRouter`` on ``fr``'s device
        holding the refitted inner scorer — same grid, fleet and caps) and
        whether a swap happened."""
        self.router = fr
        if not self.should_refit():
            return fr, False
        learned = LearnedPolicy.fit(self.scheduler_factory(),
                                    self.buffer.dataset(),
                                    emb_lca=self.emb_lca, infra=fr.infra,
                                    device=fr.device)
        policy = dataclasses.replace(fr.policy, inner=learned)
        fr = FleetRouter(fr.cfg, fleet=fr.fleet,
                         embodied_model=fr.embodied_model,
                         regions=fr.regions, interference=fr.interference,
                         net_slowdown=fr.net_slowdown, policy=policy,
                         grid=fr.grid, mesh=fr.mesh, device=fr.device)
        self.n_refits += 1
        self._since_refit = 0
        self.router = fr
        return fr, True
