"""Learned carbon-aware schedulers (paper §5.4, Fig 14) + energy baseline.

Port of the reference ``core/schedulers.py``: the dataset built from the
design space, the Oracle, Regression, Classification (with or without the
carbon head), BO (GP posterior on an actively chosen subset), RL (fitted-Q
contextual bandit) and EnergyAware (RL on energy) schedulers, and the
Fig-14 evaluation.

Every scheduler splits into ``fit_params(train)`` and a static
``torch_scores(params, X) -> (N, 3)`` (lower is better): the counterpart of
the reference's ``jax_scores``, which ``repro_torch.serve.policy.
LearnedPolicy`` calls on live streams. Fits run on the host, on CPU float32
tensors (RL in float64 numpy, as in the reference), so a fit is the same
whatever device later routes with it; ``load_fitted_params`` moves params
there. The scorers' products are ordered elementwise sums over the feature
axis (``_rowdot``), never a matmul, so the card and the CPU score to the
bit. ``ci_linear`` declares a scorer affine in the feature rows (see
``LearnedPolicy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.design_space import DesignSpaceResult
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SchedulerDataset:
    """Flattened (workload x scenario) decision problems (host numpy).

    ``feat_mean``/``feat_std`` are the standardization statistics of
    ``features``; a fitted model routes a live stream only if its feature
    rows are standardized with them, so they travel with the dataset."""

    features: np.ndarray  # (N, F) standardized
    labels: np.ndarray  # (N,) oracle carbon-optimal target
    total_cf: np.ndarray  # (N, 3) per-target carbon
    energy: np.ndarray  # (N, 3)
    latency: np.ndarray  # (N, 3)
    feasible: np.ndarray  # (N, 3)
    feat_mean: np.ndarray | None = None  # (F,)
    feat_std: np.ndarray | None = None  # (F,) clamped away from zero

    def split(self, test_frac: float = 0.25, seed: int = 0):
        rng = np.random.default_rng(seed)
        n = len(self.labels)
        perm = rng.permutation(n)
        k = int(n * (1 - test_frac))
        tr, te = perm[:k], perm[k:]
        pick = lambda idx: SchedulerDataset(
            self.features[idx], self.labels[idx], self.total_cf[idx],
            self.energy[idx], self.latency[idx], self.feasible[idx],
            self.feat_mean, self.feat_std)
        return pick(tr), pick(te)


def build_dataset(infos, result: DesignSpaceResult,
                  table) -> SchedulerDataset:
    """Features: workload descriptor + scenario CI/variance + hour
    harmonics, standardized in float64 as the reference does."""
    n_w, n_s, _ = result.total_cf.shape
    ws = [i.workload for i in infos]
    host = lambda t: t.detach().cpu().numpy()
    ci = host(table.envs.ci)  # (n_s, 5)
    interf = host(table.envs.interference)  # (n_s, 3)
    nets = host(table.envs.net_slowdown)  # (n_s, 2)
    hours = np.asarray([r["hour"] for r in table.rows], dtype=np.float64)
    emb_lca = np.asarray([r["embodied"] == "lca" for r in table.rows],
                         dtype=np.float64)
    feats = []
    for w in ws:
        f_w = np.array([
            np.log10(float(w.flops) + 1.0),
            np.log10(float(w.mem_bytes) + 1.0),
            np.log10(float(w.data_in) + 1.0),
            np.log10(float(w.data_out) + 1.0),
            np.log10(float(w.latency_req) + 1e-6),
            float(w.continuous),
        ])
        f_s = np.concatenate([
            ci / 100.0, interf, nets,
            np.sin(2 * np.pi * hours / 24)[:, None],
            np.cos(2 * np.pi * hours / 24)[:, None],
            emb_lca[:, None],
        ], axis=1)  # (n_s, 13)
        feats.append(np.concatenate([np.tile(f_w, (n_s, 1)), f_s], axis=1))
    X = np.concatenate(feats, axis=0)
    mean, std = X.mean(0), np.maximum(X.std(0), 1e-9)
    X = (X - mean) / std

    flat = lambda a: a.reshape(n_w * n_s, *a.shape[2:])
    return SchedulerDataset(
        features=X.astype(np.float32),
        labels=flat(result.carbon_opt),
        total_cf=flat(result.total_cf),
        energy=flat(result.energy_j),
        latency=flat(result.latency),
        feasible=flat(result.feasible),
        feat_mean=mean.astype(np.float32),
        feat_std=std.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitResult:
    predict_targets: np.ndarray  # (N_test,)
    train_flops: float
    flops_per_decision: float


def load_fitted_params(params: dict, *,
                       device: str | torch.device = "cuda") -> dict:
    """A scheduler's fitted params (numpy arrays or tensors, e.g. a
    reference scheduler's ``fit_params`` output) as tensors on ``device``:
    floating leaves in float32 (as ``jnp.asarray`` holds them with x64
    off), integer leaves as they are. What ``load_jax_params`` is for
    models."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)))
        if t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(dev)
    return out


def _host(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _with_bias(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                    device=X.device)], dim=1)


def _rowdot(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``X @ W`` for (N, F) @ (F, K) as an ordered sum over F of
    elementwise products: the same bits on every device (a matmul's
    accumulation order is the library's)."""
    out = X[:, 0:1] * W[0]
    for k in range(1, X.shape[1]):
        out = out + X[:, k:k + 1] * W[k]
    return out


def _argmin_np(scores: torch.Tensor) -> np.ndarray:
    return torch.argmin(scores, dim=-1).cpu().numpy()


class OracleScheduler:
    """Exhaustive Table-1 evaluation per decision (the paper's explorer)."""

    name = "oracle"

    def fit_predict(self, train: SchedulerDataset,
                    test: SchedulerDataset) -> FitResult:
        return FitResult(test.labels.copy(), 0.0,
                         flops_per_decision=3 * 40.0)  # 3 targets x model


class RegressionScheduler:
    """Ridge regression of per-target log-carbon + latency [104]."""

    name = "regression"
    #: the +10 latency-rank indicator is a step in the features: only
    #: piecewise-affine, so no sensitivity probing
    ci_linear = False

    def __init__(self, ridge: float = 1e-3):
        self.ridge = ridge

    def fit_params(self, train: SchedulerDataset) -> dict:
        Xb = _with_bias(_host(train.features))
        d = Xb.shape[1]
        gram = Xb.T @ Xb + self.ridge * torch.eye(d)
        W_cf = torch.linalg.solve(
            gram, Xb.T @ torch.log(_host(train.total_cf) + 1e-9))
        W_lat = torch.linalg.solve(
            gram, Xb.T @ torch.log(_host(train.latency) + 1e-9))
        return {"W_cf": W_cf, "W_lat": W_lat}

    @staticmethod
    def torch_scores(params: dict, X: torch.Tensor) -> torch.Tensor:
        """The reference's ``jax_scores``: predicted log-carbon plus 10 per
        target whose predicted log-latency is positive."""
        Xb = _with_bias(X)
        return (_rowdot(Xb, params["W_cf"])
                + 10.0 * (_rowdot(Xb, params["W_lat"]) > 0.0))

    def fit_predict(self, train, test) -> FitResult:
        params = self.fit_params(train)
        pred = _argmin_np(self.torch_scores(params, _host(test.features)))
        n, f = train.features.shape
        return FitResult(pred, float(2 * n * f * f + f ** 3),
                         flops_per_decision=2.0 * f * 6)


class ClassificationScheduler:
    """Least-squares SVM, one-vs-rest, on the oracle labels [111].

    ``carbon_head=True`` (the default) adds a ridge fit of per-target
    log-carbon, blended into the score as ``-logit + head_weight *
    log_cf_hat``; ``carbon_head=False`` is the paper's pure-logit
    configuration. Both terms are affine in the features (``ci_linear``)."""

    name = "classification"
    ci_linear = True

    def __init__(self, ridge: float = 1e-2, carbon_head: bool = True,
                 head_weight: float = 1.0):
        self.ridge = ridge
        self.carbon_head = carbon_head
        self.head_weight = head_weight

    def fit_params(self, train: SchedulerDataset) -> dict:
        Xb = _with_bias(_host(train.features))
        labels = torch.as_tensor(np.asarray(train.labels)).long()
        # LS-SVM targets: +1 for the class, -1 otherwise
        Y = 2.0 * torch.nn.functional.one_hot(labels, 3).float() - 1.0
        d = Xb.shape[1]
        gram = Xb.T @ Xb + self.ridge * len(Xb) * torch.eye(d)
        W = torch.linalg.solve(gram, Xb.T @ Y)
        if not self.carbon_head:
            return {"W": W}
        W_cf = torch.linalg.solve(
            gram, Xb.T @ torch.log(_host(train.total_cf) + 1e-9))
        return {"W": W, "W_cf": W_cf,
                "head_w": torch.tensor(self.head_weight, dtype=torch.float32)}

    @staticmethod
    def torch_scores(params: dict, X: torch.Tensor) -> torch.Tensor:
        """The reference's ``jax_scores``: ``-logit`` (+ the carbon head
        when the params carry one)."""
        Xb = _with_bias(X)
        s = -_rowdot(Xb, params["W"])  # argmin(-logit) = argmax(logit)
        if "W_cf" in params:
            s = s + params["head_w"] * _rowdot(Xb, params["W_cf"])
        return s

    def fit_predict(self, train, test) -> FitResult:
        params = self.fit_params(train)
        pred = _argmin_np(self.torch_scores(params, _host(test.features)))
        n, f = train.features.shape
        return FitResult(pred, float(2 * n * f * f + f ** 3),
                         flops_per_decision=2.0 * f
                         * (6 if self.carbon_head else 3))


class BOScheduler:
    """GP posterior (RBF) per target on an actively-chosen subset [107]."""

    name = "bo"

    def __init__(self, budget: int = 192, length_scale: float = 2.0,
                 noise: float = 1e-2, seed: int = 0):
        self.budget, self.ls, self.noise, self.seed = (budget, length_scale,
                                                       noise, seed)

    @staticmethod
    def _rbf(A: torch.Tensor, B: torch.Tensor, ls: float) -> torch.Tensor:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return torch.exp(-0.5 * d2 / ls ** 2)

    def fit_params(self, train: SchedulerDataset) -> dict:
        rng = np.random.default_rng(self.seed)
        X = _host(train.features)
        y = torch.log(_host(train.total_cf) + 1e-9)
        y = (y - y.mean(0)) / torch.clamp_min(y.std(0, correction=0), 1e-9)

        # greedy max posterior variance over a candidate pool, strictly
        # without replacement (chosen candidates are masked out)
        chosen = [int(rng.integers(len(X)))]
        cand = rng.permutation(len(X))[:4 * self.budget]
        for _ in range(min(self.budget, len(X), len(cand)) - 1):
            Xc = X[chosen]
            Kcc = self._rbf(Xc, Xc, self.ls) + self.noise * torch.eye(
                len(chosen))
            Kxc = self._rbf(X[cand], Xc, self.ls)
            sol = torch.linalg.solve(Kcc, Kxc.T)
            var = (1.0 - (Kxc.T * sol).sum(0)).numpy().copy()
            var[np.isin(cand, chosen)] = -np.inf
            chosen.append(int(cand[int(np.argmax(var))]))

        Xc, yc = X[chosen], y[chosen]
        Kcc = self._rbf(Xc, Xc, self.ls) + self.noise * torch.eye(len(chosen))
        alpha = torch.linalg.solve(Kcc, yc)
        return {"support": Xc, "alpha": alpha,
                "ls": torch.tensor(self.ls, dtype=torch.float32),
                "idx": torch.tensor(chosen, dtype=torch.int32)}

    @staticmethod
    def torch_scores(params: dict, X: torch.Tensor) -> torch.Tensor:
        """The reference's ``jax_scores``: the GP posterior mean, with the
        RBF kernel in its dot-product form (an (N, m) tensor, never
        (N, m, F))."""
        S = params["support"]
        d2 = ((X ** 2).sum(-1)[:, None] + (S ** 2).sum(-1)[None, :]
              - 2.0 * _rowdot(X, S.T))
        K = torch.exp(-0.5 * torch.clamp_min(d2, 0.0) / params["ls"] ** 2)
        return _rowdot(K, params["alpha"])

    def fit_predict(self, train, test) -> FitResult:
        params = self.fit_params(train)
        pred = _argmin_np(self.torch_scores(params, _host(test.features)))
        m, f = self.budget, train.features.shape[1]
        train_flops = self.budget * (m * m * f + m ** 3 / 3)
        return FitResult(pred, float(train_flops),
                         flops_per_decision=2.0 * m * f + 2 * m * 3)


class RLScheduler:
    """Fitted-Q contextual bandit with carbon (or energy) cost [72-style]:
    epsilon-greedy exploration over replayed episodes, QoS misses folded
    into the cost, features with squared CI terms and CI x workload
    interactions. The fit is float64 numpy, as in the reference."""

    name = "rl"

    def __init__(self, episodes: int = 8, eps: float = 0.25,
                 ridge: float = 1e-2, reward: str = "carbon", seed: int = 0):
        self.episodes, self.eps, self.ridge = episodes, eps, ridge
        self.reward = reward
        self.seed = seed

    @staticmethod
    def _phi(f: np.ndarray) -> np.ndarray:
        ci = f[:, 6:11]
        w = f[:, 0:6]
        inter = (ci[:, :, None] * w[:, None, :3]).reshape(len(f), -1)
        return np.concatenate(
            [f, ci ** 2, inter, np.ones((len(f), 1))], axis=1)

    def _cost(self, ds: SchedulerDataset) -> np.ndarray:
        base = ds.total_cf if self.reward == "carbon" else ds.energy
        norm = base / np.maximum(base.min(axis=1, keepdims=True), 1e-12)
        return np.log1p(norm) + 3.0 * (~ds.feasible)

    def fit_params(self, train: SchedulerDataset) -> dict:
        rng = np.random.default_rng(self.seed)
        X = self._phi(train.features)
        cost = self._cost(train)
        n, F = X.shape
        W = np.zeros((F, 3))
        seen_x: list[list[int]] = [[], [], []]
        seen_c: list[list[float]] = [[], [], []]
        order = np.arange(n)
        for ep in range(self.episodes):
            rng.shuffle(order)
            q = X @ W
            explore = rng.random(n) < self.eps * (0.5 ** ep)
            acts = np.where(explore, rng.integers(0, 3, n),
                            np.argmin(q, axis=1))
            for i in order:
                a = int(acts[i])
                seen_x[a].append(i)
                seen_c[a].append(cost[i, a])
            # fitted-Q: ridge regression per action on experienced costs
            for a in range(3):
                idx = np.asarray(seen_x[a])
                Xa, ca = X[idx], np.asarray(seen_c[a])
                gram = Xa.T @ Xa + self.ridge * len(idx) * np.eye(F)
                W[:, a] = np.linalg.solve(gram, Xa.T @ ca)
        return {"W": W}

    @staticmethod
    def torch_scores(params: dict, X: torch.Tensor) -> torch.Tensor:
        """The reference's ``jax_scores``: ``_phi`` on tensors, then the
        per-action linear Q."""
        ci = X[:, 6:11]
        wf = X[:, 0:6]
        inter = (ci[:, :, None] * wf[:, None, :3]).reshape(X.shape[0], -1)
        phi = torch.cat([X, ci ** 2, inter,
                         torch.ones((X.shape[0], 1), dtype=X.dtype,
                                    device=X.device)], dim=1)
        return _rowdot(phi, params["W"])

    def fit_predict(self, train, test) -> FitResult:
        W = np.asarray(self.fit_params(train)["W"])
        n, F = len(train.features), W.shape[0]
        pred = np.argmin(self._phi(test.features) @ W, axis=1)
        train_flops = self.episodes * (2 * n * F * F + F ** 3) * 3
        return FitResult(pred, float(train_flops),
                         flops_per_decision=float(2 * F * 3 + 4 * F))


class EnergyAwareScheduler(RLScheduler):
    """AutoScale-like energy-optimizing RL — the paper's SOTA baseline."""

    name = "energy-aware-rl"

    def __init__(self, **kw):
        kw.pop("reward", None)
        super().__init__(reward="energy", **kw)


ALL_SCHEDULERS = (OracleScheduler, RegressionScheduler,
                  ClassificationScheduler, BOScheduler, RLScheduler)


# ---------------------------------------------------------------------------
# Evaluation (Fig 14)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SchedulerEval:
    name: str
    accuracy: float
    cf_degradation: float  # mean effective (CF[pred]-CF[oracle])/CF[oracle]
    qos_violation_rate: float  # picks that miss the latency constraint
    train_flops: float
    flops_per_decision: float


#: effective-cost multiplier for QoS-violating picks (the request re-runs on
#: a feasible target, so the violating attempt's carbon is wasted)
QOS_PENALTY = 2.0


def evaluate_scheduler(sched, train: SchedulerDataset,
                       test: SchedulerDataset) -> SchedulerEval:
    fit = sched.fit_predict(train, test)
    pred = fit.predict_targets
    n = np.arange(len(pred))
    feas = test.feasible[n, pred]
    cf_pred = test.total_cf[n, pred] * np.where(feas, 1.0, QOS_PENALTY)
    # oracle labels can be infeasible too; the same effective cost applies
    feas_opt = test.feasible[n, test.labels]
    cf_opt = test.total_cf[n, test.labels] * np.where(feas_opt, 1.0,
                                                      QOS_PENALTY)
    return SchedulerEval(
        name=sched.name,
        accuracy=float((pred == test.labels).mean()),
        cf_degradation=float(((cf_pred - cf_opt)
                              / np.maximum(cf_opt, 1e-12)).mean()),
        qos_violation_rate=float((~feas).mean()),
        train_flops=fit.train_flops,
        flops_per_decision=fit.flops_per_decision,
    )
