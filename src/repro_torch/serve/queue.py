"""Continuous-batching request queue: arrival-ordered serving, not buckets
(port of ``src/repro/serve/queue.py``).

Requests arrive continuously, wait in a queue, and are drafted into
fixed-shape sub-batches whenever worker capacity frees up:

  * ``RequestQueue`` — columnar queue over timestamped arrivals; every
    request is QUEUED until the serve loop commits it (ROUTED) or its
    deadline expires under load (SHED); ``ready`` drains earliest deadline
    first. ``queued + routed + shed == pushed`` holds at every step.
  * ``BatchFormer`` — drafts padded sub-batches from the ready set, at most
    ``max_batch`` rows, each sized against a ``ServeEngine``'s KV capacity
    or a ``TierEnvelope``'s VRAM, padded to a power of two.
  * ``WorkerPool`` — per-(region, tier) worker slots with launch -> active
    -> draining -> terminated transitions; ``cap_matrix`` feeds the
    placement engines' ``cap_scale`` seam, so admission gates on live slots.
  * ``serve_stream`` — the loop: tick the pool, draft ready requests, route
    each draft through ``FleetRouter._route_arrays`` (committed capacity
    carried across steps via ``used0``, live slots via ``cap_scale``),
    commit work that executes this step, hold deferred or retryable work,
    and optionally feed every settled draft to an ``OnlineRefitter``.
    Routed carbon settles at actual CI of each committed cell.

The queue, drafts and pool are host numpy, as in the reference; each draft
is routed on the router's device and its decisions read back once (one
sync per draft). ``serve_stream(plan=...)`` steers the pool toward a
``repro_torch.serve.provision.ProvisioningPlan`` each step.
``BatchFormer(mesh=...)`` (sharded routing, ROADMAP item 9) raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.constants import N_TARGETS
from repro_torch.serve.forecast import _settle_carbon, pad_pow2, slice_batch
from repro_torch.serve.router import RequestBatch


#: request lifecycle states (``RequestQueue.status`` values)
QUEUED, ROUTED, SHED = 0, 1, 2

#: worker lifecycle states (``WorkerPool`` counters)
LAUNCHING, ACTIVE, DRAINING, TERMINATED = 0, 1, 2, 3


class RequestQueue:
    """Columnar queue of timestamped requests.

    ``push`` ingests a ``(RequestBatch, region, t_hours)`` arrival slice
    (append-only — the serving loop may keep pushing while draining);
    ``ready`` returns the QUEUED rows that have arrived by a given time in
    earliest-deadline-first order. The status array is the conservation
    ledger: every pushed request is in exactly one of QUEUED / ROUTED /
    SHED, and ``mark_routed`` / ``mark_shed`` refuse double transitions.
    """

    def __init__(self) -> None:
        self._batch: RequestBatch | None = None
        self.region = np.zeros(0, np.int32)
        self.t_hours = np.zeros(0, np.float64)
        self.status = np.zeros(0, np.int8)

    @classmethod
    def from_stream(cls, batch: RequestBatch, region: np.ndarray,
                    t_hours: np.ndarray) -> "RequestQueue":
        q = cls()
        q.push(batch, region, t_hours)
        return q

    def push(self, batch: RequestBatch, region: np.ndarray,
             t_hours: np.ndarray) -> None:
        n = len(batch)
        region = np.asarray(region, np.int32)
        t_hours = np.asarray(t_hours, np.float64)
        if region.shape != (n,) or t_hours.shape != (n,):
            raise ValueError(
                f"region/t_hours must be ({n},), got {region.shape} / "
                f"{t_hours.shape}")
        if self._batch is None:
            self._batch = batch
        else:
            cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)])
            slack = (None if self._batch.slack_hours is None
                     and batch.slack_hours is None else
                     cat(self._batch.slack_hours
                         if self._batch.slack_hours is not None
                         else np.zeros(len(self._batch)),
                         batch.slack_hours if batch.slack_hours is not None
                         else np.zeros(n)))
            self._batch = RequestBatch(
                prompt_tokens=cat(self._batch.prompt_tokens,
                                  batch.prompt_tokens),
                max_new_tokens=cat(self._batch.max_new_tokens,
                                   batch.max_new_tokens),
                latency_budget_s=cat(self._batch.latency_budget_s,
                                     batch.latency_budget_s),
                bytes_per_token=cat(self._batch.bytes_per_token,
                                    batch.bytes_per_token),
                available=cat(self._batch.available, batch.available),
                slack_hours=slack)
        self.region = np.concatenate([self.region, region])
        self.t_hours = np.concatenate([self.t_hours, t_hours])
        self.status = np.concatenate([self.status, np.zeros(n, np.int8)])

    @property
    def batch(self) -> RequestBatch:
        if self._batch is None:
            raise ValueError("empty queue has no batch view")
        return self._batch

    def __len__(self) -> int:
        return len(self.status)

    @property
    def arr_hour(self) -> np.ndarray:
        return np.floor(self.t_hours).astype(np.int32)

    def deadline(self, max_defer_h: int) -> np.ndarray:
        """(N,) int32 latest admissible execution hour: arrival + slack,
        slack clamped to the policy's deferral horizon."""
        slack = np.minimum(self.batch.slack_h, max_defer_h).astype(np.int32)
        return self.arr_hour + slack

    def ready(self, before_h: float, max_defer_h: int = 0) -> np.ndarray:
        """QUEUED rows with arrival time < ``before_h``, ordered earliest
        deadline first (ties: arrival order) — the draft order that lets
        tight-slack interactive work preempt deferrable batch work."""
        mask = (self.status == QUEUED) & (self.t_hours < before_h)
        idx = np.nonzero(mask)[0]
        dl = self.deadline(max_defer_h)[idx]
        return idx[np.lexsort((idx, self.t_hours[idx], dl))]

    def mark_routed(self, idx: np.ndarray) -> None:
        self._transition(idx, ROUTED)

    def mark_shed(self, idx: np.ndarray) -> None:
        self._transition(idx, SHED)

    def _transition(self, idx: np.ndarray, to: int) -> None:
        idx = np.asarray(idx, np.int64)
        if len(idx) and (self.status[idx] != QUEUED).any():
            raise ValueError("double transition: request already settled")
        self.status[idx] = to

    # conservation counters — queued + routed + shed == pushed, always
    @property
    def n_queued(self) -> int:
        return int((self.status == QUEUED).sum())

    @property
    def n_routed(self) -> int:
        return int((self.status == ROUTED).sum())

    @property
    def n_shed(self) -> int:
        return int((self.status == SHED).sum())


@dataclasses.dataclass(frozen=True)
class FormedBatch:
    """One draft: ``idx`` rows of the queue, padded to ``pad_to``
    (power-of-two) with unroutable dummies. ``hour`` is the effective
    decision hour (arrival clamped to the current step — a held request
    re-plans from *now*, not from its past arrival), ``slack`` the hours
    left to its deadline."""

    idx: np.ndarray  # (k,) queue row indices
    batch: RequestBatch  # (pad_to,) padded columnar view
    region: np.ndarray  # (pad_to,) int32
    hour: np.ndarray  # (pad_to,) int32 effective decision hour
    slack: np.ndarray  # (pad_to,) int32 re-anchored slack
    pad_to: int

    @property
    def n(self) -> int:
        return len(self.idx)


@dataclasses.dataclass
class BatchFormer:
    """Drafts fixed-shape sub-batches from a queue's ready set.

    ``max_batch`` bounds the rows per draft (padded to a power of two, as
    the reference pads to bound its jit shapes). ``engine`` optionally
    sizes each draft against a ``ServeEngine``'s KV capacity
    (``ServeEngine.kv_fit_rows``): a draft never holds more concurrent
    requests (or total prompt+decode tokens) than the engine's
    decode-state slots fit. ``kv_slots``/``max_seq`` apply the same
    decode-slot sizing WITHOUT a live engine — the per-tier VRAM path:
    ``for_envelope`` derives the slot count from a
    ``repro_torch.core.infrastructure.TierEnvelope``'s VRAM bytes, so drafts
    respect the accelerator memory of the hardware tier that will hold
    them. Drafts cross hourly window boundaries freely.

    ``mesh`` (the reference pads drafts to a multiple of the routing mesh)
    is ROADMAP item 9 and raises when not None.
    """

    max_batch: int = 65536
    min_pad: int = 16
    engine: object | None = None  # ServeEngine, optional
    mesh: object | None = None  # 1-D routing mesh, optional
    #: engine-less KV sizing: at most ``kv_slots`` concurrent requests
    #: per draft AND at most ``kv_slots * max_seq`` total prompt+decode
    #: tokens (each request clamped to ``max_seq`` — a longer one holds a
    #: full slot), mirroring ``ServeEngine.kv_fit_rows``. None = no VRAM
    #: bound (the historical behaviour, bit-for-bit).
    kv_slots: int | None = None
    max_seq: int = 4096

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "BatchFormer(mesh=...) pads drafts for the sharded routing "
                "path, which is not ported yet: ROADMAP item 9 "
                "(repro.serve.distributed)")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.kv_slots is not None and self.kv_slots < 1:
            raise ValueError(f"kv_slots must be >= 1, got {self.kv_slots}")

    @classmethod
    def for_envelope(cls, envelope, *, kv_bytes_per_token: float,
                     max_seq: int = 4096, tiers: tuple[int, ...] = (1, 2),
                     **kw) -> "BatchFormer":
        """A former sized against per-tier VRAM envelopes
        (``repro_torch.core.infrastructure.TierEnvelope``). One decode slot
        costs ``max_seq * kv_bytes_per_token`` bytes of accelerator
        memory; the draft bound is the MOST CONSTRAINED of ``tiers``'
        slot counts — conservative, so whichever of those tiers the
        router then picks can hold an entire draft's decode states.
        Mobile (tier 0) is excluded by default: on-device requests use
        the requester's own memory, one request at a time. Tiers with
        ``np.inf`` VRAM impose no bound."""
        slot_bytes = float(kv_bytes_per_token) * float(max_seq)
        slots = [envelope.kv_slots(t, slot_bytes) for t in tiers]
        finite = [s for s in slots if s is not None]
        return cls(kv_slots=min(finite) if finite else None,
                   max_seq=max_seq, **kw)

    def _pad_to(self, k: int) -> int:
        """Draft pad size: pow-2 bucketing (``forecast.pad_pow2``)."""
        return pad_pow2(k, self.min_pad)

    def draft(self, queue: RequestQueue, ready_idx: np.ndarray, now: int,
              max_defer_h: int = 0) -> list[FormedBatch]:
        """Chunk ``ready_idx`` (EDF order preserved) into padded drafts."""
        batch = queue.batch if len(ready_idx) else None
        deadline = queue.deadline(max_defer_h)
        drafts = []
        i = 0
        while i < len(ready_idx):
            chunk = ready_idx[i:i + self.max_batch]
            if self.engine is not None or self.kv_slots is not None:
                seq = (np.asarray(batch.prompt_tokens)[chunk]
                       + np.asarray(batch.max_new_tokens)[chunk])
                if self.engine is not None:
                    chunk = chunk[:max(1, self.engine.kv_fit_rows(seq))]
                if self.kv_slots is not None:
                    # same rule as ServeEngine.kv_fit_rows, from the
                    # envelope's VRAM instead of a live engine
                    s = np.minimum(seq[:len(chunk)].astype(np.float64),
                                   self.max_seq)
                    n_rows = min(len(s), int(self.kv_slots))
                    fits = (np.cumsum(s[:n_rows])
                            <= float(self.kv_slots) * float(self.max_seq))
                    chunk = chunk[:max(1, int(fits.sum()))]
            i += len(chunk)
            k = len(chunk)
            pad_to = self._pad_to(k)
            eff_hour = np.maximum(queue.arr_hour[chunk], now).astype(np.int32)
            eff_slack = np.maximum(deadline[chunk] - eff_hour,
                                   0).astype(np.int32)
            pad = pad_to - k
            drafts.append(FormedBatch(
                idx=chunk,
                batch=slice_batch(batch, chunk, pad_to),
                region=np.concatenate(
                    [queue.region[chunk], np.zeros(pad, np.int32)]),
                hour=np.concatenate(
                    [eff_hour, np.full(pad, now, np.int32)]),
                slack=np.concatenate([eff_slack, np.zeros(pad, np.int32)]),
                pad_to=pad_to))
        return drafts


class WorkerPool:
    """Per-(region, tier) worker slots with explicit lifecycle transitions.

    Each worker serves ``slots_per_worker`` requests per hour once ACTIVE.
    ``launch`` starts workers cold (they spend ``launch_delay_steps`` serve
    steps LAUNCHING before their slots count); ``drain`` moves active
    workers to DRAINING — they finish in-flight work but accept nothing
    new, so their slots leave ``cap_matrix`` immediately; a subsequent
    ``terminate_drained`` retires them. ``cap_matrix`` is the live
    (R, 3) slot matrix the serve loop passes as ``cap_scale``: build the
    routing policy with unit caps and the matrix IS the admission limit.
    The MOBILE tier is unbounded by default (on-device execution uses the
    requester's own hardware, not pooled workers) — matching the repo-wide
    ``caps[:, 0] = inf`` convention.
    """

    def __init__(self, n_regions: int, slots_per_worker: float = 64.0,
                 launch_delay_steps: int = 1, mobile_unbounded: bool = True):
        if slots_per_worker <= 0:
            raise ValueError("slots_per_worker must be positive")
        self.n_regions = n_regions
        self.slots_per_worker = float(slots_per_worker)
        self.launch_delay_steps = int(launch_delay_steps)
        self.mobile_unbounded = mobile_unbounded
        #: (R, 3) worker counts per lifecycle state
        self.active = np.zeros((n_regions, N_TARGETS), np.int64)
        self.draining = np.zeros((n_regions, N_TARGETS), np.int64)
        self.terminated = np.zeros((n_regions, N_TARGETS), np.int64)
        self._pending: list[list[int]] = []  # [region, tier, steps_left]

    def launch(self, region: int, tier: int, n: int = 1) -> None:
        if n < 1:
            raise ValueError("launch at least one worker")
        for _ in range(n):
            self._pending.append([region, tier, self.launch_delay_steps])

    @property
    def launching(self) -> np.ndarray:
        out = np.zeros((self.n_regions, N_TARGETS), np.int64)
        for r, t, _ in self._pending:
            out[r, t] += 1
        return out

    def drain(self, region: int, tier: int, n: int = 1) -> int:
        """Move up to ``n`` ACTIVE workers to DRAINING; returns how many."""
        k = int(min(n, self.active[region, tier]))
        self.active[region, tier] -= k
        self.draining[region, tier] += k
        return k

    def terminate_drained(self) -> int:
        """Retire every DRAINING worker; returns how many."""
        k = int(self.draining.sum())
        self.terminated += self.draining
        self.draining[:] = 0
        return k

    def tick(self) -> None:
        """Advance one serve step: launching workers come online."""
        still = []
        for rec in self._pending:
            rec[2] -= 1
            if rec[2] <= 0:
                self.active[rec[0], rec[1]] += 1
            else:
                still.append(rec)
        self._pending = still

    def cap_matrix(self) -> np.ndarray:
        """(R, 3) float32 live request slots — ACTIVE workers only (slots
        of LAUNCHING and DRAINING workers accept no new work)."""
        m = (self.active * self.slots_per_worker).astype(np.float32)
        if self.mobile_unbounded:
            m[:, 0] = np.inf
        return m


@dataclasses.dataclass(frozen=True)
class QueueStep:
    """One serve step's conservation record."""

    now: int  # step start (absolute horizon hour)
    drafted: int  # queue rows drafted this step (across all sub-batches)
    n_batches: int  # fixed-shape sub-batches formed
    routed: int  # rows committed ROUTED this step
    shed: int  # rows committed SHED this step
    held: int  # drafted rows held for re-planning next step
    queued_after: int  # queue's QUEUED count after the step
    slots: np.ndarray  # (R, 3) live worker slots seen (inf w/o a pool)
    refit: bool  # did the online refitter swap params after this step


@dataclasses.dataclass(frozen=True)
class QueueServeResult:
    """Outcome of ``serve_stream``: per-request commitments + step trace.
    Carbon is settled at ACTUAL CI of each committed (region, hour) cell."""

    target: np.ndarray  # (N,) int32 committed tier
    exec_region: np.ndarray  # (N,) int32 committed executing region
    exec_hour: np.ndarray  # (N,) int32 committed absolute execution hour
    defer_hours: np.ndarray  # (N,) int32 exec - arrival (0 if shed)
    shed: np.ndarray  # (N,) bool committed as shed
    step: np.ndarray  # (N,) int32 serve step (now-hour) that committed it
    carbon_g: np.ndarray  # (N,) gCO2 at actual CI of the committed cell
    total_carbon_g: float
    routed_carbon_g: float  # non-shed rows only
    steps: tuple[QueueStep, ...]
    refits: int  # policy hot-swaps performed by the online refitter

    @property
    def shed_count(self) -> int:
        return int(self.shed.sum())

    @property
    def deferred_count(self) -> int:
        return int(((self.defer_hours > 0) & ~self.shed).sum())


def serve_stream(fr, batch: RequestBatch, region: np.ndarray,
                 t_hours: np.ndarray, *, step_h: int = 1,
                 pool: WorkerPool | None = None,
                 former: BatchFormer | None = None,
                 refitter=None, plan=None) -> QueueServeResult:
    """Drive ``fr`` (any capacity-aware ``FleetRouter``) as a continuous-
    batching serve loop over the stream. The commit rule per draft row:

      * temporal policies: commit when the planned execution hour falls in
        the current step (or the row shed with an expired deadline); held
        rows re-plan next step under fresher capacity;
      * non-temporal policies: everything commits on decision, except shed
        rows that still have slack left — those retry.

    With a ``pool``, build the policy with unit caps: the pool's live (R, 3)
    slot matrix multiplies them via ``cap_scale``. With a ``refitter``
    (``repro_torch.serve.online.OnlineRefitter``) every committed draft is
    observed and the router is hot-swapped between steps when enough
    settled tuples accumulate; the final router is ``refitter.router``.
    With a ``plan`` (``repro_torch.serve.provision.ProvisioningPlan``),
    each step starts by launching/draining the pool toward the plan's
    server counts for that hour (a pool is created if none was given), so
    admission sees exactly the provisioned capacity."""
    if step_h < 1:
        raise ValueError(f"step_h must be >= 1, got {step_h}")
    if plan is not None and pool is None:
        pool = WorkerPool(plan.n_regions,
                          slots_per_worker=plan.slots_per_server)
    queue = RequestQueue.from_stream(batch, region, t_hours)
    former = former or BatchFormer()
    horizon = fr._horizon_h
    n = len(queue)
    if n and (queue.arr_hour.min() < 0 or queue.arr_hour.max() >= horizon):
        raise ValueError(
            f"t_hours must lie in [0, {horizon}) — the serve loop owns the "
            f"time axis and never wraps")

    max_defer = int(getattr(fr.policy, "max_defer_h", 0))
    W = getattr(fr.policy, "n_windows", None) or horizon
    n_regions = fr.grid.n_regions
    n_pairs = n_regions * N_TARGETS
    routable = np.asarray(queue.batch.available).any(axis=1) if n else \
        np.zeros(0, bool)
    arr_hour = queue.arr_hour
    deadline = queue.deadline(max_defer)

    tgt = np.zeros(n, np.int32)
    er = queue.region.copy()
    eh = arr_hour.copy()
    shed = np.zeros(n, bool)
    step_of = np.full(n, -1, np.int32)
    used_committed = np.zeros(W * n_pairs, np.float32)
    free_slots = np.full((n_regions, N_TARGETS), np.inf, np.float32)
    host = lambda t: t.cpu().numpy()

    steps: list[QueueStep] = []
    for now in range(0, horizon, step_h):
        last = now + step_h >= horizon
        dev = fr.device
        if pool is not None:
            if plan is not None:
                # retire last step's drains, then steer the pool toward the
                # plan's counts for this hour; with the default one-step
                # launch delay the tick below brings them online this step
                pool.terminate_drained()
                plan.apply_to_pool(pool, now)
            pool.tick()
            slots = pool.cap_matrix()
            cap_scale = torch.as_tensor(slots, device=dev)
        else:
            slots, cap_scale = free_slots, None

        ready = queue.ready(now + step_h, max_defer)
        drafted = routed_k = shed_k = held_k = 0
        n_batches = 0
        for fb in former.draft(queue, ready, now, max_defer):
            k = fb.n
            drafted += k
            n_batches += 1
            res, state = fr._route_arrays(
                fb.batch, fb.region, fb.hour, cap_scale=cap_scale,
                used0=torch.as_tensor(used_committed, device=dev),
                slack_np=fb.slack)
            p_tgt = host(res.target)[:k]
            p_shed_a = getattr(state, "shed", None)
            p_shed = (np.zeros(k, bool) if p_shed_a is None
                      else host(p_shed_a)[:k])
            p_er_a = getattr(state, "exec_region", None)
            p_er = (fb.region[:k] if p_er_a is None else host(p_er_a)[:k])
            p_eh_a = getattr(state, "exec_hour", None)
            temporal = p_eh_a is not None
            p_eh = fb.hour[:k] if not temporal else host(p_eh_a)[:k]

            expired = deadline[fb.idx] < now + step_h
            if temporal:
                commit = (p_eh < now + step_h) | (p_shed & expired)
            else:
                commit = ~p_shed | expired
            if last:
                commit = np.ones(k, bool)

            ci = fb.idx[commit]
            c_shed = p_shed[commit]
            queue.mark_routed(ci[~c_shed])
            queue.mark_shed(ci[c_shed])
            tgt[ci] = p_tgt[commit]
            er[ci] = p_er[commit]
            eh[ci] = p_eh[commit]
            shed[ci] = c_shed
            step_of[ci] = now
            routed_k += int((~c_shed).sum())
            shed_k += int(c_shed.sum())
            held_k += int((~commit).sum())

            live = commit & ~p_shed & routable[fb.idx]
            cells = ((p_eh[live] % W).astype(np.int64) * n_pairs
                     + p_er[live] * N_TARGETS + p_tgt[live])
            np.add.at(used_committed, cells, 1.0)

            if refitter is not None:
                refitter.observe(fr, fb, p_tgt, commit & ~p_shed)

        refit = False
        if refitter is not None:
            fr, refit = refitter.step(fr)
        steps.append(QueueStep(
            now=now, drafted=drafted, n_batches=n_batches, routed=routed_k,
            shed=shed_k, held=held_k, queued_after=queue.n_queued,
            slots=slots, refit=refit))

    assert queue.n_queued == 0, "serve loop left requests unsettled"

    # ---- settle at actuals (same tail as the rolling re-planner) ---------
    refits = 0 if refitter is None else refitter.n_refits
    if n == 0:
        return QueueServeResult(
            target=tgt, exec_region=er, exec_hour=eh,
            defer_hours=np.zeros(0, np.int32), shed=shed, step=step_of,
            carbon_g=np.zeros(0), total_carbon_g=0.0, routed_carbon_g=0.0,
            steps=tuple(steps), refits=refits)
    carbon = _settle_carbon(fr, queue.batch, queue.region, er, eh, tgt)
    defer = np.where(shed, 0, eh - arr_hour).astype(np.int32)
    return QueueServeResult(
        target=tgt, exec_region=er, exec_hour=eh, defer_hours=defer,
        shed=shed, step=step_of, carbon_g=carbon,
        total_carbon_g=float(carbon.sum()),
        routed_carbon_g=float(carbon[~shed].sum()),
        steps=tuple(steps), refits=refits)


def admit_batches(result: QueueServeResult, engine) -> list[np.ndarray]:
    """Serving side of the queue loop: per serve step, the stream indices
    ``engine`` admits (its tier's committed, non-shed rows), in serve
    order; each index array keeps the commit order within its step."""
    mask = engine.admit(torch.as_tensor(result.target)).cpu().numpy()
    mask = mask & ~result.shed
    out = []
    for s in sorted({int(v) for v in result.step if v >= 0}):
        out.append(np.nonzero(mask & (result.step == s))[0])
    return out
