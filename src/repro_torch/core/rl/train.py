"""Training and evaluation loops for the repartitioning DQN (paper §IV-D, §V-C).

The port's counterpart of ``repro.core.rl.train``:

* :func:`train_dqn` — the paper's host trainer (``backend="host"``, the
  default): each episode is one simulated day scheduled by (restricted)
  EDF-SS inside the selected configuration, driven through the incremental
  :class:`~repro_torch.core.rl.env.RepartitionEnv`; n-step transitions feed
  :class:`~repro_torch.core.rl.dqn.DQNLearner`, whose Q network and TD update
  run on ``device`` (default: the CUDA card).  An optional guide policy acts
  for the first episodes (the demonstration warm-start).
  ``backend="batched"`` dispatches to
  :func:`~repro_torch.core.rl.batched_train.train_dqn_batched` with the
  reference's argument checks.
* :func:`evaluate_policy` and :func:`evaluate_policy_fleet` — day
  simulations under a policy, each built as the reference builds its sweep
  cell and run through the sweep engine
  (:func:`repro_torch.sweep.runner.run_cells`): registered policies are
  memoized on disk and fan out over ``workers`` processes; ad-hoc callables
  run inline and uncached.

All of it but the Q network and the TD update is float64 host code with the
reference's order of operations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.metrics import SimResult
from repro_torch.core.rl.agent import NStepAccumulator
from repro_torch.core.rl.dqn import DQNConfig, DQNLearner
from repro_torch.core.rl.env import FEATURE_DIM, RepartitionEnv, RewardWeights
from repro_torch.core.workload import WorkloadSpec
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["TrainStats", "train_dqn", "evaluate_policy", "evaluate_policy_fleet"]


@dataclasses.dataclass
class TrainStats:
    episode_rewards: List[float]
    episode_et_proxy: List[float]
    losses: List[float]
    episodes: int
    wall_seconds: float
    env_steps: int = 0  # total decisions taken
    # the port's telemetry beside the reference's fields: each episode's wall
    # seconds and TD updates
    episode_wall_seconds: List[float] = dataclasses.field(default_factory=list)
    episode_updates: List[int] = dataclasses.field(default_factory=list)


def train_dqn(
    num_episodes: int = 200,
    spec: Optional[WorkloadSpec] = None,
    scheduler_name: str = "EDF-SS",
    dqn_config: Optional[DQNConfig] = None,
    rewards: RewardWeights = RewardWeights(),
    seed: int = 0,
    verbose: bool = False,
    guide=None,
    guide_episodes: int = 0,
    scenario: Optional[str] = None,
    scenario_kwargs: Optional[Dict] = None,
    backend: str = "host",
    train_config=None,
    decision_interval_min: Optional[float] = None,
    *,
    device: DeviceLike = None,
) -> tuple:
    """Train the repartitioning DQN; returns ``(learner, TrainStats)``.

    ``decision_interval_min`` puts the host env on a fixed decision cadence
    (decisions at multiples of the interval, configuration held in
    between); ``None`` keeps the native event cadence.

    ``guide``/``guide_episodes``: the first episodes act with the guide
    policy while the learner trains on the resulting transitions.

    ``scenario`` draws episode workloads from the named registry entry
    instead of ``spec``.

    ``backend="batched"`` dispatches to
    :func:`~repro_torch.core.rl.batched_train.train_dqn_batched`: EDF-FS
    only, a fixed decision cadence, ``train_config`` (a
    :class:`~repro_torch.core.rl.batched_train.BatchedTrainConfig`) for the
    batch shape; ``guide`` is host-only.

    ``device`` holds the Q network and its TD update: ``None`` is the CUDA
    card and raises without one, ``"cpu"`` on request.  Actions and replay
    samples come from the learner's ``np.random.default_rng(cfg.seed + 1)``,
    as in the reference.
    """
    if backend == "batched":
        from repro_torch.core.rl.batched_train import train_dqn_batched

        if guide is not None:
            raise ValueError("guide warm-start is host-backend only")
        if scheduler_name != "EDF-FS":
            raise ValueError(
                "the batched backend schedules with EDF-FS only; pass "
                "scheduler_name='EDF-FS' explicitly (host default is EDF-SS)"
            )
        from repro_torch.core.rl.batched_train import BatchedTrainConfig

        tcfg = train_config or BatchedTrainConfig()
        if scenario is not None:
            merged = dict(tcfg.scenario_kwargs or {})
            merged.update(scenario_kwargs or {})
            tcfg = dataclasses.replace(
                tcfg, scenarios=(scenario,), scenario_kwargs=merged or None
            )
        if decision_interval_min is not None:
            tcfg = dataclasses.replace(
                tcfg, decision_interval_min=decision_interval_min
            )
        return train_dqn_batched(
            num_episodes=num_episodes,
            dqn_config=dqn_config,
            train_config=tcfg,
            rewards=rewards,
            seed=seed,
            verbose=verbose,
            device=device,
        )
    if backend != "host":
        raise ValueError(f"unknown backend {backend!r} (host | batched)")
    spec = spec or WorkloadSpec()
    cfg = dqn_config or DQNConfig(state_dim=FEATURE_DIM, seed=seed)
    learner = DQNLearner(cfg, device=device)
    env = RepartitionEnv(
        scheduler_name=scheduler_name,
        spec=spec,
        scenario=scenario,
        scenario_kwargs=scenario_kwargs,
        rewards=rewards,
        decision_interval_min=decision_interval_min,
    )
    nstep = NStepAccumulator(cfg.n_step, cfg.gamma)

    t0 = time.time()  # lint: waive[DT002] wall-seconds telemetry only
    ep_rewards: List[float] = []
    ep_proxy: List[float] = []
    all_losses: List[float] = []
    ep_wall: List[float] = []
    ep_updates: List[int] = []
    env_steps = 0
    for ep in range(num_episodes):
        t_ep = time.perf_counter()  # lint: waive[DT002] per-episode wall telemetry only
        updates0 = learner.updates
        ep_seed = seed * 100_003 + ep
        epsilon = learner.epsilon(ep)
        use_guide = guide is not None and ep < guide_episodes
        if use_guide and hasattr(guide, "reset"):
            # stateful demonstration policies (e.g. the predictive
            # ForecastPolicy: EWMA bias, dwell clocks) start each episode
            # clean, exactly as a fresh simulated day would see them
            guide.reset()
        obs = env.reset(seed=ep_seed)
        nstep.clear()
        ep_reward = 0.0
        ep_losses: List[float] = []
        over = env.done  # degenerate empty episode (no decision points)
        while not over:
            if use_guide:
                choice = guide.decide(env.sim.t, env.sim)
                action = (
                    (choice - 1)
                    if choice is not None
                    else (env.sim.partition.config_id - 1)
                )
            else:
                action = learner.act(obs, epsilon)
            next_obs, r, terminated, truncated, _ = env.step(action)
            ep_reward += r
            env_steps += 1
            nstep.push(learner, obs, action, r, next_obs, terminated or truncated)
            loss = learner.maybe_train(1)
            if loss == loss:  # not NaN (returned before the buffer warms up)
                ep_losses.append(loss)
            obs = next_obs
            over = terminated or truncated
        result = env.result()
        ep_rewards.append(ep_reward)
        proxy = rewards.a * result.energy_wh + result.avg_tardiness
        ep_proxy.append(proxy)
        all_losses.extend(ep_losses)
        ep_wall.append(time.perf_counter() - t_ep)  # lint: waive[DT002] per-episode wall telemetry only
        ep_updates.append(learner.updates - updates0)
        if verbose and (ep + 1) % 10 == 0:  # pragma: no cover
            print(
                f"episode {ep + 1}/{num_episodes} eps={epsilon:.2f} "
                f"reward={ep_reward:.2f} proxy={proxy:.2f} "
                f"repart={result.repartitions}"
            )
    stats = TrainStats(
        episode_rewards=ep_rewards,
        episode_et_proxy=ep_proxy,
        losses=all_losses,
        episodes=num_episodes,
        wall_seconds=time.time() - t0,  # lint: waive[DT002] wall telemetry only
        env_steps=env_steps,
        episode_wall_seconds=ep_wall,
        episode_updates=ep_updates,
    )
    return learner, stats


def evaluate_policy(
    policy_factory,
    num_iterations: int = 50,
    spec: Optional[WorkloadSpec] = None,
    scheduler_name: str = "EDF-SS",
    seed: int = 10_000,
    mig_enabled: bool = True,
    workers: int = 0,
    scenario: Optional[str] = None,
    scenario_kwargs: Optional[Dict] = None,
    *,
    device: DeviceLike = None,
) -> List[SimResult]:
    """Run ``num_iterations`` independent day simulations under a policy.

    ``policy_factory`` is either a zero-arg callable returning a
    RepartitionPolicy (fresh DQN greedy agents keep per-episode state), or a
    registered sweep policy — a name like ``"heuristic"`` or a
    ``(name, kwargs)`` tuple, e.g. ``("dqn", {"params_path": ...})``.

    The runs go through the sweep engine (:mod:`repro_torch.sweep`):
    registered policies are memoized on disk (``artifacts/sweeps/cache``
    under the working directory) and fan out over ``workers`` processes;
    ad-hoc callables run inline and uncached (a closure over live learner
    state is neither picklable nor content-addressable).  ``scenario`` swaps
    the workload for a registered scenario (bursty, heavy-tailed, ...).
    ``device`` is where a DQN's Q network runs: ``None`` is the CUDA card and
    raises without one, ``"cpu"`` on request.
    """
    from repro_torch.sweep import make_cell, make_scenario_cell, result_to_sim_result, run_cells

    dev = resolve_device(device)
    spec = spec or WorkloadSpec()
    policy_name, policy_kwargs, factory = _resolve_policy(policy_factory)
    cells = []
    for it in range(num_iterations):
        if scenario is not None:
            cells.append(
                make_scenario_cell(
                    experiment="evaluate_policy",
                    group=policy_name,
                    scheduler=scheduler_name,
                    scenario=scenario,
                    scenario_kwargs=scenario_kwargs,
                    seed=seed + it,
                    policy=policy_name,
                    policy_kwargs=policy_kwargs,
                    mig_enabled=mig_enabled,
                )
            )
        else:
            cells.append(
                make_cell(
                    experiment="evaluate_policy",
                    group=policy_name,
                    scheduler=scheduler_name,
                    workload=spec,
                    seed=seed + it,
                    policy=policy_name,
                    policy_kwargs=policy_kwargs,
                    mig_enabled=mig_enabled,
                )
            )
    outcome = run_cells(
        "evaluate_policy",
        cells,
        workers=workers,
        cache=factory is None,
        artifacts_dir=None,
        policy_factory=factory,
        device=dev,
    )
    return [result_to_sim_result(r) for r in outcome.results]


def _resolve_policy(policy_factory):
    """(name, kwargs, ad_hoc_factory) from the evaluate_policy spec forms."""
    if isinstance(policy_factory, str):
        return policy_factory, {}, None
    if isinstance(policy_factory, tuple):
        name, kwargs = policy_factory
        return name, kwargs, None
    return "static", {}, policy_factory  # placeholder name; factory wins


def evaluate_policy_fleet(
    policy_factory,
    profiles: Sequence[str] = ("a100-250w",),
    dispatcher: str = "round-robin",
    num_iterations: int = 20,
    scheduler_name: str = "EDF-SS",
    scenario: str = "paper-diurnal",
    scenario_kwargs: Optional[Dict] = None,
    seed: int = 20_000,
    mig_enabled: bool = True,
    workers: int = 0,
    *,
    device: DeviceLike = None,
) -> List[SimResult]:
    """Evaluate a repartitioning policy per device inside a fleet.

    Each iteration dispatches one scenario day across ``profiles`` and runs
    an *independent instance* of the policy on every device (policies carry
    run state); returns the fleet-aggregate :class:`SimResult` per
    iteration.  Registered policies go through the sweep engine (cached,
    parallel); ad-hoc factories run inline and uncached, exactly as in
    :func:`evaluate_policy`.  A registry DQN builds one Q network a device,
    on ``device``.
    """
    from repro_torch.sweep import make_fleet_cell, result_to_sim_result, run_cells

    dev = resolve_device(device)
    policy_name, policy_kwargs, factory = _resolve_policy(policy_factory)
    cells = [
        make_fleet_cell(
            experiment="evaluate_policy_fleet",
            group=policy_name,
            profiles=profiles,
            dispatcher=dispatcher,
            scheduler=scheduler_name,
            scenario=scenario,
            scenario_kwargs=scenario_kwargs,
            seed=seed + it,
            policy=policy_name,
            policy_kwargs=policy_kwargs,
            mig_enabled=mig_enabled,
        )
        for it in range(num_iterations)
    ]
    outcome = run_cells(
        "evaluate_policy_fleet",
        cells,
        workers=workers,
        cache=factory is None,
        artifacts_dir=None,
        policy_factory=factory,
        device=dev,
    )
    return [result_to_sim_result(r) for r in outcome.results]
