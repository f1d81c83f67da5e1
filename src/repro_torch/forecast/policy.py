"""ForecastPolicy: model-predictive repartitioning over a fluid queue model.

At each decision event (arrival/completion/periodic timer) the policy

1. updates its arrival forecaster with the arrivals realized so far,
2. reads the simulator's *actual* state — jobs in system and outstanding
   work in 1g-minutes (both are observable by a real MIG controller),
3. for every candidate configuration rolls a cheap fluid/queueing
   approximation of the simulator forward over ``horizon_min`` minutes:
   forecast arrivals feed a two-class (inference/training) backlog, seated
   slices drain it at the §V-A job-mix expected throughput with
   duty-cycle-correct energy, an Erlang-C term supplies the stochastic
   queueing wait a deterministic fluid cannot see, and arrivals are charged
   the expected lateness read off a per-config curve precomputed from a
   deterministic sample of the §V-A job distribution (which is what prices
   the *tail*: a linear training job with a tight deadline needs the 4g
   slice that some layouts simply do not have),
4. charges switching candidates the §IV-D-3 repartition penalty (a blocked
   GPU for 4 s) inside the rollout,
5. picks the configuration minimizing the predicted ET scalarization
   ``(a·E + T̄)/(a + 1)`` — switching only when the predicted improvement
   clears ``switch_margin`` (``downsize_margin`` when cutting parallelism:
   shrinking on a transient quiet dip is how a controller gets caught by
   the next burst) and the configuration has dwelt ``min_dwell_min``, so
   the repartition penalty always amortizes (pinned by
   the reference's tests).

The fluid model is a first-order backlog estimate, deliberately far cheaper
than the event simulator it approximates, because it runs |configs| ×
(horizon/step) times per decision.

The port's own copy of ``repro.forecast.policy``.  The fleet factory
``device_forecast_factory`` is not copied (the port has no fleet layer).
"""

from __future__ import annotations

import bisect
import functools
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.jobs import SUBLINEAR_CURVES, Elasticity, LINEAR, capped
from repro_torch.core.power import A100_250W, PowerModel
from repro_torch.core.simulator import (
    REPARTITION_MODES,
    REPARTITION_PENALTY_MIN,
    MIGSimulator,
)
from repro_torch.core.slices import MIG_CONFIGS, Partition, transition

__all__ = [
    "expected_throughput",
    "EFFECTIVE_THROUGHPUT",
    "erlang_c_wait",
    "DEFAULT_CANDIDATES",
    "ForecastPolicy",
]


def expected_throughput(slots: int) -> float:
    """E[throughput] of a §V-A random job on a slice of ``slots`` compute.

    The workload draws its elasticity uniformly over {linear, capped,
    sublinear} with capped caps uniform on {2, 3, 4} and the four sublinear
    curves equally likely — the expectation simply averages those profiles.
    """
    linear = float(slots)
    capped_mean = sum(capped(c).throughput(slots) for c in (2, 3, 4)) / 3.0
    sub_mean = sum(e.throughput(slots) for e in SUBLINEAR_CURVES.values()) / len(
        SUBLINEAR_CURVES
    )
    return (linear + capped_mean + sub_mean) / 3.0


#: memoized E[tp] per canonical slice size (1, 2, 3, 4, 7)
EFFECTIVE_THROUGHPUT: Dict[int, float] = {k: expected_throughput(k) for k in (1, 2, 3, 4, 7)}


def erlang_c_wait(servers: int, lam: float, mu_per_server: float) -> float:
    """Expected M/M/c queueing wait (minutes) — the stochastic term a
    deterministic fluid model cannot see.

    At identical utilization a 2-slice configuration queues jobs far longer
    than a 4-slice one; this is what differentiates parallelism levels on
    the daytime plateau, so the lookahead must price it.  Uses the Erlang-B
    recursion (c ≤ 7, a handful of multiplies); returns 0 for an idle
    system and ``inf`` for an overloaded one (the caller caps it).
    """
    if lam <= 1e-12 or servers <= 0:
        return 0.0
    cap = servers * mu_per_server
    if lam >= cap * 0.999:
        return math.inf
    a = lam / mu_per_server
    b = 1.0
    for k in range(1, servers + 1):
        b = a * b / (k + a * b)
    rho = lam / cap
    p_wait = b / (1.0 - rho * (1.0 - b))
    return p_wait / (cap - lam)


# §V-A job-mix constants the two-class fluid model runs on, sourced from
# the workload defaults so a tuned WorkloadSpec default cannot silently
# diverge from the controller's priors.  Inference is 80 % of arrivals
# with Exp(mean 3) work; training is 20 % with U(10, 40) (mean 25) — a
# fifth of the jobs but two thirds of the work.
from repro_torch.core.workload import WorkloadSpec as _WorkloadSpec

_SPEC_DEFAULTS = _WorkloadSpec()
_INFERENCE_SPLIT = _SPEC_DEFAULTS.inference_split
_MEAN_WORK_INF = _SPEC_DEFAULTS.inference_mean_min
_MEAN_WORK_TRN = (_SPEC_DEFAULTS.training_lo_min + _SPEC_DEFAULTS.training_hi_min) / 2.0

#: Default candidate configurations for the paper's A100 table: the coarse
#: family the controller modulates between — full GPU overnight
#: (race-to-idle), the 4g+3g split on the shoulders, and the paper's
#: workhorse 4g+2g+1g layout through the daytime plateau.  Matches the
#: preferred-configuration structure of Fig. 11, and EXPERIMENTS.md
#: §Predictive-controller measures this pruning beating both the full
#: 12-config search (whose fine layouts the fluid model over-rates) and
#: every static baseline on ET.  Pass ``configs=`` to search a different
#: set (e.g. the device's full table).
DEFAULT_CANDIDATES = (1, 2, 3)


@functools.lru_cache(maxsize=4)
def _job_samples(n: int = 512) -> Tuple[Tuple[str, float, float, Elasticity], ...]:
    """A fixed, deterministic sample of the §V-A job distribution.

    Each entry is ``(kind, work, deadline_slack, elasticity)`` with the
    slack already resolved to minutes (``u * work / tp_el(7)``,
    u ~ U(1.2, 4.0)).  Drawn once from a pinned seed so every
    :class:`ForecastPolicy` instance — in any process — prices lateness
    against the identical sample (sweep determinism depends on it).
    """
    rng = np.random.default_rng(20250801)
    curves = list(SUBLINEAR_CURVES.values())
    out: List[Tuple[str, float, float, Elasticity]] = []
    for _ in range(n):
        is_inf = rng.uniform() < _INFERENCE_SPLIT
        work = (
            max(rng.exponential(_MEAN_WORK_INF), 1.0 / 60.0)
            if is_inf
            else rng.uniform(_SPEC_DEFAULTS.training_lo_min, _SPEC_DEFAULTS.training_hi_min)
        )
        u = rng.integers(0, 3)
        if u == 0:
            elast = LINEAR
        elif u == 1:
            elast = capped(int(rng.choice([2, 3, 4])))
        else:
            elast = curves[int(rng.integers(0, len(curves)))]
        slack = (
            rng.uniform(_SPEC_DEFAULTS.slack_lo, _SPEC_DEFAULTS.slack_hi)
            * elast.duration(work, 7)
        )
        out.append(("inf" if is_inf else "trn", float(work), float(slack), elast))
    return tuple(out)


def _config_tables(
    partition: Partition,
) -> Tuple[Tuple[float, ...], Tuple[float, ...], float, float]:
    """Per-config lateness curve + service moments from the job sample.

    For each sampled job, EDF-SS-style smallest-sufficient placement picks
    its slice on this partition (the slowest service that still meets the
    deadline at zero wait, else the fastest available); the job's
    *headroom* ``h = slack - service`` is how much queueing wait it
    tolerates before going late.  Expected lateness per arrival is then
    ``late(wait) = mean_j max(wait - h_j, 0)`` — piecewise linear, returned
    as (sorted headrooms, prefix sums) for O(log n) evaluation.  Jobs with
    negative headroom are late even on an idle GPU: exactly the tail a
    mean-job model misses on layouts lacking a big slice.

    Also returns the first two moments of the *service-time* distribution
    this placement induces — ``(mu_per_server, mg_factor)`` — feeding an
    M/G/c-corrected Erlang wait: the §V-A mix is heavy-tailed (a training
    job holds a server for minutes while sub-minute inference queues), and
    an M/M/c wait on the mean service underestimates that by the classic
    ``(1 + CV²)/2`` factor.
    """
    sizes = sorted(set(partition.slot_sizes()))
    headrooms: List[float] = []
    s1 = s2 = 0.0
    for _, work, slack, elast in _job_samples():
        candidates = [work / elast.throughput(s) for s in sizes]
        sufficient = [d for d in candidates if d <= slack + 1e-12]
        # smallest sufficient slice = the slowest service that still meets
        # the deadline; an impossible deadline falls back to the fastest
        service = max(sufficient) if sufficient else min(candidates)
        headrooms.append(slack - service)
        s1 += service
        s2 += service * service
    n = len(headrooms)
    mean_s = s1 / n
    cv2 = max(s2 / n / (mean_s * mean_s) - 1.0, 0.0)
    headrooms.sort()
    prefix = [0.0]
    for h in headrooms:
        prefix.append(prefix[-1] + h)
    return tuple(headrooms), tuple(prefix), 1.0 / mean_s, (1.0 + cv2) / 2.0


class ForecastPolicy:
    """Predictive repartitioning controller (forecast + MPC lookahead).

    Parameters
    ----------
    forecaster:
        An object with ``rate(t) -> jobs/min`` (and optionally
        ``observe(t, cumulative_count)`` / ``reset()``), normally an
        :class:`~repro_torch.forecast.forecaster.ArrivalForecaster`.  ``None``
        fits the default paper-diurnal day model (cached per process).
    configs / power:
        The device's partition table and power curve — defaults to the
        paper's A100.  Passing a different device's pair makes the
        controller native to that device.
    horizon_min / step_min:
        Lookahead length and fluid integration step.
    et_alpha:
        Energy weight ``a`` of the predicted-ET scalarization
        ``(a·E + T̄)/(a+1)`` (same form as :mod:`repro_torch.core.metrics`).
    switch_margin / downsize_margin:
        Relative predicted-ET improvement a challenger must clear before
        the controller repartitions; cutting parallelism requires the
        larger ``downsize_margin`` (asymmetric hysteresis: shrinking on a
        transient quiet dip is how a controller gets caught by a burst).
    min_dwell_min:
        Minimum minutes between repartitions.
    eval_interval_min:
        Full candidate evaluations are throttled to at most one per this
        many minutes — except when the queue depth jumped by ≥ 2 since the
        last evaluation (a burst must be seen immediately).
    reconsider_min:
        Period of the policy's own timer, so quiet stretches without
        arrivals still get decision points (e.g. the evening ramp-down).
    max_defer_min:
        Opportunistic-switch window (partial mode only): a wanted switch
        that would displace jobs running on to-be-destroyed slices is
        deferred — decision points recur at every completion, so within a
        couple of minutes the affected instances usually drain and the
        reconfiguration lands displacement-free, exactly how
        MIG-Serving-style schedulers time reconfigurations around running
        services.  After ``max_defer_min`` minutes the switch proceeds
        anyway (the lookahead's improvement must not rot while the GPU
        waits for a long training job).
    repartition_mode:
        How the simulator this policy controls charges a reconfiguration —
        must match the simulator's own mode so the lookahead prices what
        the physics will charge.  ``"partial"`` (default): a switching
        candidate keeps the transition's *surviving* slot capacity serving
        through the 4 s stall and only the displaced share of in-flight
        work pays the upfront requeue wait; ``"drain"``: the legacy flat
        full-drain penalty (zero service during the stall, everything
        displaced).
    """

    def __init__(
        self,
        forecaster=None,
        configs: Optional[Mapping[int, Partition]] = None,
        power: PowerModel = A100_250W,
        horizon_min: float = 30.0,
        step_min: float = 3.0,
        et_alpha: float = 2e-5,
        switch_margin: float = 0.01,
        downsize_margin: float = 0.05,
        min_dwell_min: float = 1.0,
        eval_interval_min: float = 0.5,
        reconsider_min: float = 5.0,
        inference_split: float = _INFERENCE_SPLIT,
        mean_work_inf: float = _MEAN_WORK_INF,
        mean_work_trn: float = _MEAN_WORK_TRN,
        repartition_penalty_min: float = REPARTITION_PENALTY_MIN,
        repartition_mode: str = "partial",
        max_defer_min: float = 3.0,
    ) -> None:
        if repartition_mode not in REPARTITION_MODES:
            raise ValueError(
                f"unknown repartition_mode {repartition_mode!r}; "
                f"valid: {REPARTITION_MODES}"
            )
        if forecaster is None:
            from repro_torch.forecast.forecaster import ArrivalForecaster, fit_scenario_forecaster

            forecaster = ArrivalForecaster(fit_scenario_forecaster())
        self.forecaster = forecaster
        if configs is None:
            configs = {cid: MIG_CONFIGS[cid] for cid in DEFAULT_CANDIDATES}
        self.configs: Dict[int, Partition] = dict(configs)
        self.power = power
        self.horizon_min = horizon_min
        self.step_min = step_min
        self.et_alpha = et_alpha
        self.switch_margin = switch_margin
        self.downsize_margin = downsize_margin
        self.min_dwell_min = min_dwell_min
        self.eval_interval_min = eval_interval_min
        self.reconsider_min = reconsider_min
        self.inference_split = inference_split
        self.mean_work_inf = mean_work_inf
        self.mean_work_trn = mean_work_trn
        self.penalty_min = repartition_penalty_min
        self.repartition_mode = repartition_mode
        self.max_defer_min = max_defer_min
        # memoized surviving-capacity fraction per (from, to) candidate pair
        self._surv_frac_cache: Dict[Tuple[int, int], float] = {}
        # opportunistic-switch deferral state: (wanted config, since when)
        self._defer_target: Optional[int] = None
        self._defer_since: float = 0.0

        # per-config seating order, mirroring EDF-SS's smallest-sufficient
        # placement: >=2g slices ascending (the smallest slice that meets a
        # mean job's deadline), then 1g slices — those only earn their power
        # draw once the queue is deeper than the sufficient slices
        self._seat_slots: Dict[int, Tuple[int, ...]] = {
            cid: tuple(sorted(p.slot_sizes(), key=lambda s: (s < 2, s)))
            for cid, p in self.configs.items()
        }
        # _srv[cid][k] = pooled service rate (1g-work/min) with k seats
        # busy; _pwr[cid][k] = power draw (W).  The rollout keeps the mean
        # number-in-system continuous and interpolates *between occupancy
        # levels* — E[P] = (1-frac)·P(k) + frac·P(k+1) — the
        # duty-cycle-correct expectation for a concave power curve: a
        # coarse config that races through its queue and idles must score
        # the idle watts it actually earns.
        self._srv: Dict[int, Tuple[float, ...]] = {}
        self._pwr: Dict[int, Tuple[float, ...]] = {}
        for cid, slots in self._seat_slots.items():
            eff = tuple(EFFECTIVE_THROUGHPUT[s] for s in slots)
            srv_k = [0.0]
            pwr_k = [power.power_watts(0.0)]
            for k in range(1, len(slots) + 1):
                srv_k.append(srv_k[-1] + eff[k - 1])
                pwr_k.append(power.power_watts(float(sum(slots[:k]))))
            self._srv[cid] = tuple(srv_k)
            self._pwr[cid] = tuple(pwr_k)
        # expected-lateness curves + M/G/c service moments from the
        # pinned §V-A job sample
        self._late: Dict[int, Tuple[Tuple[float, ...], Tuple[float, ...]]] = {}
        self._mu_server: Dict[int, float] = {}
        self._mg_factor: Dict[int, float] = {}
        for cid, p in self.configs.items():
            heads, prefix, mu_server, mg = _config_tables(p)
            self._late[cid] = (heads, prefix)
            self._mu_server[cid] = mu_server
            self._mg_factor[cid] = mg

        # reference drain capacity for the adaptive horizon: the best
        # pooled service rate any candidate offers on THIS device's table
        self._ref_capacity = max(srv[-1] for srv in self._srv.values())

        self._last_eval_t = -math.inf
        self._last_eval_n = 0.0
        self._last_switch_t = -math.inf
        # MPC from minute zero: the initial configuration is the lookahead
        # winner for an empty system at t=0 (no dwell/margin applies yet)
        self.initial_config = self._best_config(
            t=0.0, n_inf=0.0, w_inf=0.0, n_trn=0.0, w_trn=0.0, current=None
        )[0]

    # ------------------------------------------------------------------
    # RepartitionPolicy protocol

    def decide(self, t: float, sim: "MIGSimulator") -> Optional[int]:
        if t < self._last_eval_t - 1e-9:
            # time went backwards: the policy object is being reused for a
            # fresh episode (train_dqn guide runs) — start clean
            self.reset()
        # everything the controller reads comes through the structured
        # engine snapshot — the same observable surface a real MIG
        # controller (and the fleet dispatchers) would have
        snap = sim.snapshot()
        if hasattr(self.forecaster, "observe"):
            self.forecaster.observe(t, snap.active_jobs + snap.completed_jobs)
        if t - self._last_switch_t < self.min_dwell_min:
            return None

        n_inf = float(snap.inference_jobs)
        w_inf = snap.inference_backlog_1g_min
        n_trn = float(snap.training_jobs)
        w_trn = snap.training_backlog_1g_min
        # the eval throttle bounds lookahead cost (decision events arrive
        # with every job), but a queue jump since the last evaluation is a
        # burst the controller must see immediately
        queue_jumped = abs((n_inf + n_trn) - self._last_eval_n) >= 2.0
        if t - self._last_eval_t < self.eval_interval_min and not queue_jumped:
            return None
        self._last_eval_t = t
        self._last_eval_n = n_inf + n_trn
        current = snap.config_id

        best, costs = self._best_config(t, n_inf, w_inf, n_trn, w_trn, current)
        if best == current:
            # the want lapsed: a later re-wanted switch must open a fresh
            # deferral window, not inherit a stale _defer_since
            self._defer_target = None
            return None
        if current not in costs:
            # the running layout is outside the candidate set (an
            # ``initial_config`` override): adopt the lookahead winner
            # immediately — there is no priced incumbent to defend
            self._defer_target = None
            self._last_switch_t = t
            return best
        improvement = costs[current] - costs[best]
        shrinking = self.configs[best].num_slices < self.configs[current].num_slices
        margin = self.downsize_margin if shrinking else self.switch_margin
        if improvement <= margin * max(abs(costs[current]), 1e-9):
            self._defer_target = None
            return None
        if self.repartition_mode == "partial":
            # opportunistic switch timing: if the transition would tear down
            # a slice instance with a job still running on it, defer — the
            # next completions open displacement-free instants within
            # minutes, and a partial reconfiguration at such an instant
            # preempts nothing.  Bounded by max_defer_min so a long
            # training job cannot pin a stale layout indefinitely.
            plan = transition(self.configs[current], self.configs[best])
            surviving = {i for i, _ in plan.surviving}
            if any(s not in surviving for s in snap.occupied_slices):
                if self._defer_target != best:
                    self._defer_target = best
                    self._defer_since = t
                if t - self._defer_since < self.max_defer_min:
                    return None
        self._defer_target = None
        self._last_switch_t = t
        return best

    def next_timer(self, t: float) -> Optional[float]:
        return t + self.reconsider_min

    def reset(self) -> None:
        """Clear episode state (dwell/eval clocks, forecaster bias)."""
        self._last_eval_t = -math.inf
        self._last_eval_n = 0.0
        self._last_switch_t = -math.inf
        self._defer_target = None
        self._defer_since = 0.0
        if hasattr(self.forecaster, "reset"):
            self.forecaster.reset()

    # ------------------------------------------------------------------
    # fluid lookahead

    def _expected_lateness(self, config_id: int, wait: float) -> float:
        """Mean lateness (min) of an arrival facing ``wait`` min of queue."""
        headrooms, prefix = self._late[config_id]
        k = bisect.bisect_left(headrooms, wait)
        if k == 0:
            return 0.0
        return (k * wait - prefix[k]) / len(headrooms)

    def _best_config(
        self,
        t: float,
        n_inf: float,
        w_inf: float,
        n_trn: float,
        w_trn: float,
        current: Optional[int],
    ) -> Tuple[int, Dict[int, float]]:
        # State-adaptive horizon (shared by every candidate so costs stay
        # comparable): the controller re-optimizes at the next decision
        # event, so committing a near-empty system to a 30-minute rollout
        # overprices coarse configs it would abandon two arrivals later —
        # the effective commitment is roughly the time to the next couple
        # of arrivals plus the current drain, clamped to the full horizon.
        lam0 = max(self.forecaster.rate(t), 1e-3)
        drain = (w_inf + w_trn) / self._ref_capacity
        horizon = min(self.horizon_min, max(6.0, 2.0 / lam0 + drain))
        costs = {
            cid: self._predict_cost(
                cid, t, n_inf, w_inf, n_trn, w_trn,
                switch=(cid != current), horizon_min=horizon,
                survive_frac=self._survive_frac(current, cid),
            )
            for cid in self.configs
        }
        best = min(costs, key=lambda cid: (costs[cid], cid))
        return best, costs

    def _survive_frac(self, current: Optional[int], cand: int) -> float:
        """Fraction of the incumbent's slot capacity that survives a switch
        to ``cand`` (0 under drain mode, for an unknown incumbent, or full
        turnover) — what makes the lookahead price a *partial* transition
        instead of the flat full-drain stall."""
        if (
            self.repartition_mode != "partial"
            or current is None
            or current == cand
            or current not in self.configs
        ):
            return 0.0
        key = (current, cand)
        frac = self._surv_frac_cache.get(key)
        if frac is None:
            old = self.configs[current]
            plan = transition(old, self.configs[cand])
            surviving_slots = sum(old.slices[i].slots for i, _ in plan.surviving)
            frac = surviving_slots / max(old.total_slots, 1)
            self._surv_frac_cache[key] = frac
        return frac

    def _predict_cost(
        self,
        config_id: int,
        t0: float,
        n_inf: float,
        w_inf: float,
        n_trn: float,
        w_trn: float,
        switch: bool,
        horizon_min: Optional[float] = None,
        survive_frac: float = 0.0,
    ) -> float:
        """Predicted ET of running ``config_id`` over the lookahead horizon.

        ``survive_frac`` is the slot-capacity fraction that survives the
        transition into ``config_id`` (partial repartitioning): during the
        §IV-D-3 stall the candidate keeps serving at that fraction of its
        occupancy-appropriate rate, and only the displaced ``1 -
        survive_frac`` share of in-flight work pays the upfront requeue
        wait.  ``0.0`` reproduces the flat full-drain pricing exactly.
        """
        if horizon_min is None:
            horizon_min = self.horizon_min
        srv_table = self._srv[config_id]
        pwr_table = self._pwr[config_id]
        num_slices = len(srv_table) - 1
        mu_full = srv_table[-1]
        p_inf = self.inference_split
        rate = self.forecaster.rate
        mu_per_server = self._mu_server[config_id]
        mg_factor = self._mg_factor[config_id]
        # stochastic-wait cap: past this the fluid backlog term carries the
        # overload signal, so the Erlang term must not double it unboundedly
        wq_cap = self.horizon_min

        ni, wi, nt, wt = n_inf, w_inf, n_trn, w_trn
        energy_wh = 0.0
        tard_job_min = 0.0
        arrived = 0.0
        t = t0
        remaining = horizon_min
        # jobs already in the system are charged their expected lateness up
        # front — the burst signal that makes the controller react to a
        # queue spike instead of only pricing future arrivals
        if ni + nt > 1e-9:
            # jobs already in the system split into two populations across a
            # switch: runners on *surviving* slice instances keep going and
            # only face the backlog drain, while displaced runners and the
            # queue requeue behind the stall and eat the full penalty.  The
            # lateness curve prices the 4 s slip marginally — at a quiet
            # moment every job has headroom and the term vanishes (the
            # nightly consolidation to the full GPU stays free), under load
            # tearing through a busy layout costs real predicted lateness.
            # survive_frac = 0 (drain pricing / full turnover) collapses to
            # the legacy flat full-drain charge, bit for bit.
            n_tot0 = ni + nt
            base_wait = (wi + wt) / mu_full
            if switch:
                surv_jobs = survive_frac * min(n_tot0, float(num_slices))
                tard_job_min += surv_jobs * self._expected_lateness(
                    config_id, base_wait
                )
                tard_job_min += (n_tot0 - surv_jobs) * self._expected_lateness(
                    config_id, base_wait + self.penalty_min
                )
            else:
                tard_job_min += n_tot0 * self._expected_lateness(config_id, base_wait)
        # a switching candidate starts with the repartition stall: arrivals
        # queue and only the transition's surviving capacity keeps serving
        # (none of it under drain mode — the GPU idles, §IV-D-3)
        blocked = self.penalty_min if switch else 0.0
        while remaining > 1e-9:
            dt = min(self.step_min, remaining)
            lam = rate(t)
            n_tot = ni + nt
            if blocked > 0.0:
                dt = min(dt, blocked)
                # occupancy scaled to the surviving capacity fraction: a
                # partial transition serves (and draws power) at the
                # surviving slices' share of the normal rate
                x = min(n_tot, float(num_slices)) * survive_frac
                k_lo = min(int(x), num_slices - 1) if num_slices else 0
                frac = x - k_lo
                srv_total = srv_table[k_lo] + frac * (srv_table[k_lo + 1] - srv_table[k_lo])
                watts = pwr_table[k_lo] + frac * (pwr_table[k_lo + 1] - pwr_table[k_lo])
                srv_t = srv_total * (nt / n_tot) if n_tot > 1e-12 else 0.0
                srv_i = srv_total - srv_t
                blocked -= dt
            else:
                # continuous occupancy: k_lo seats fully busy, one more busy
                # ``frac`` of the time — service and power interpolate over
                # occupancy *levels* (duty cycle), not over busy slots
                x = min(n_tot, float(num_slices))
                k_lo = min(int(x), num_slices - 1) if num_slices else 0
                frac = x - k_lo
                srv_total = srv_table[k_lo] + frac * (srv_table[k_lo + 1] - srv_table[k_lo])
                watts = pwr_table[k_lo] + frac * (pwr_table[k_lo + 1] - pwr_table[k_lo])
                # processor-sharing split of the pooled rate by job count
                srv_t = srv_total * (nt / n_tot) if n_tot > 1e-12 else 0.0
                srv_i = srv_total - srv_t
            served_i = min(wi, srv_i * dt)
            served_t = min(wt, srv_t * dt)
            # completions deplete job counts at the observed mean remaining
            # work per job, so half-done jobs finish at the right rate
            if wi > 1e-9 and ni > 1e-9:
                ni = max(ni - served_i * ni / wi, 0.0)
            wi -= served_i
            if wt > 1e-9 and nt > 1e-9:
                nt = max(nt - served_t * nt / wt, 0.0)
            wt -= served_t
            arr = lam * dt
            ni += arr * p_inf
            wi += arr * p_inf * self.mean_work_inf
            nt += arr * (1.0 - p_inf)
            wt += arr * (1.0 - p_inf) * self.mean_work_trn
            energy_wh += watts * dt / 60.0
            # expected lateness of this step's arrivals: fluid backlog
            # drain plus the stochastic M/M/c wait, priced through the
            # config's sampled lateness curve
            # The slices run *preemptive EDF*: an urgent arrival displaces a
            # long job instantly, so an underloaded deadline scheduler
            # misses (almost) nothing regardless of FCFS wait — the
            # stochastic term only ramps in as utilization approaches
            # saturation, scaled further by the heavy-tail (1+CV^2)/2
            # M/G/c correction.  The fluid backlog term stays unscaled: an
            # actual queue is actual lateness risk at any utilization.
            rho = min(lam / (num_slices * mu_per_server), 1.0) if mu_per_server else 1.0
            edf_scale = min(max((rho - 0.25) / 0.5, 0.0), 1.0)
            factor = 1.0 + (mg_factor - 1.0) * rho
            wait = (wi + wt) / mu_full + min(
                edf_scale * factor * erlang_c_wait(num_slices, lam, mu_per_server),
                wq_cap,
            )
            tard_job_min += arr * self._expected_lateness(config_id, wait)
            arrived += arr
            t += dt
            remaining -= dt
        jobs_seen = max(n_inf + n_trn + arrived, 1.0)
        avg_tardiness = tard_job_min / jobs_seen
        a = self.et_alpha
        return (a * energy_wh + avg_tardiness) / (a + 1.0)

