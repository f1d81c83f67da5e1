"""Train the repartitioning DQN on one card and write its parameters (npz).

Two trainers, chosen by ``--backend``:

* ``batched`` (the default) — the port's entry point in place of the
  reference's ``train_dqn(backend="batched")`` and the training half of
  ``scripts/train_rl_baseline.py``, at that script's configuration: B 64
  rollouts a round, 104 decisions of 15 minutes on the 0.5-minute grid, the
  scenarios paper-diurnal, bursty-mmpp, heavy-tail-lognormal and
  heavy-tail-pareto at load scales 0.8-1.2, n-step 8, lr 3e-4, target sync
  every 2000 updates, min_buffer 2000, epsilon decay over 100 000 env steps,
  seed 7::

      python -m repro_torch.launch.train_rl --episodes 2048 --out params.npz

* ``host`` — the paper's own trainer (§IV-D), ``train_dqn`` over the
  event-cadence ``RepartitionEnv`` on ``WorkloadSpec`` days under EDF-SS, at
  ``examples/dynamic_repartitioning_day.py``'s configuration: n-step 8, lr
  3e-4, target sync every 2000 updates, epsilon decay over half the
  episodes, seed 0, the queue heuristic guiding the first ``max(N // 10,
  10)`` episodes (``--guide-episodes`` to change it); the Q network and its
  TD update on the card::

      python -m repro_torch.launch.train_rl --backend host --episodes 400 --out params.npz

Both write the reference's npz layout (``w{i}``, ``b{i}``, ``n_layers``):
``python -m repro_torch.launch.evaluate --table3 --params params.npz`` runs
the paper's Table III with it (the headline experiment, after the host
trainer), ``--race`` the batched baseline's race.  On the CPU, at whatever
size is given: ``python -m repro_torch.launch.train_rl --device cpu
--episodes 4 --batch 2 --horizon 8 --out params.npz``, or ``--backend host
--episodes 2 --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from repro_torch.core.rl.batched_train import BatchedTrainConfig, train_dqn_batched
from repro_torch.core.rl.dqn import DQNConfig
from repro_torch.core.rl.env import FEATURE_DIM
from repro_torch.core.rl.train import train_dqn
from repro_torch.device import DeviceLike
from repro_torch.launch.cluster_sim import queue_heuristic_policy

#: the families the baseline trains on and is raced on
TRAIN_SCENARIOS = (
    "paper-diurnal",
    "bursty-mmpp",
    "heavy-tail-lognormal",
    "heavy-tail-pareto",
)
TRAIN_SEED = 7
TRAIN_EPISODES = 2048
DECISION_INTERVAL_MIN = 15.0
#: the host trainer's default length (the example's)
HOST_EPISODES = 400


def dqn_config() -> DQNConfig:
    return DQNConfig(
        state_dim=FEATURE_DIM,
        n_step=8,
        lr=3e-4,
        target_sync_every=2000,
        min_buffer=2000,
        eps_decay_steps=100_000,
        seed=TRAIN_SEED,
    )


def train_config(batch: int = 64, horizon: int = 104) -> BatchedTrainConfig:
    return BatchedTrainConfig(
        batch=batch,
        scenarios=TRAIN_SCENARIOS,
        load_scale_range=(0.8, 1.2),
        decision_interval_min=DECISION_INTERVAL_MIN,
        horizon_decisions=horizon,
    )


def train(
    episodes: int = TRAIN_EPISODES,
    batch: int = 64,
    horizon: int = 104,
    device: DeviceLike = None,
    verbose: bool = True,
):
    """Fixed-seed batched training over the scenario × load-scale mix;
    returns ``(learner, stats)``."""
    return train_dqn_batched(
        num_episodes=episodes,
        dqn_config=dqn_config(),
        train_config=train_config(batch, horizon),
        seed=TRAIN_SEED,
        verbose=verbose,
        device=device,
    )


def host_dqn_config(episodes: int) -> DQNConfig:
    """``examples/dynamic_repartitioning_day.py``'s learner for ``episodes``."""
    return DQNConfig(
        state_dim=FEATURE_DIM,
        eps_decay_episodes=max(episodes // 2, 1),
        n_step=8,
        lr=3e-4,
        target_sync_every=2000,
    )


def host_guide_episodes(episodes: int) -> int:
    """The example's guided episodes: ``max(episodes // 10, 10)``."""
    return max(episodes // 10, 10)


def train_host(
    episodes: int = HOST_EPISODES,
    guide_episodes: Optional[int] = None,
    device: DeviceLike = None,
    verbose: bool = True,
):
    """The paper's host trainer at the example's configuration, the queue
    heuristic guiding the first episodes; returns ``(learner, stats)``."""
    return train_dqn(
        num_episodes=episodes,
        dqn_config=host_dqn_config(episodes),
        verbose=verbose,
        guide=queue_heuristic_policy(),
        guide_episodes=host_guide_episodes(episodes) if guide_episodes is None else guide_episodes,
        device=device,
    )


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("batched", "host"), default="batched",
                    help="the on-device batched trainer, or the paper's host trainer")
    ap.add_argument("--episodes", type=int, default=None,
                    help=f"episodes (default {TRAIN_EPISODES} batched, {HOST_EPISODES} host)")
    ap.add_argument("--batch", type=int, default=64, help="rollouts a round (batched)")
    ap.add_argument("--horizon", type=int, default=104, help="decisions a round (batched)")
    ap.add_argument("--guide-episodes", type=int, default=None,
                    help="episodes the queue heuristic acts (host; default max(N // 10, 10))")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--out", required=True, help="where to write the parameters (npz)")
    args = ap.parse_args(argv)

    if args.backend == "host":
        if args.batch != 64 or args.horizon != 104:
            ap.error("--batch and --horizon shape the batched trainer only")
        episodes = HOST_EPISODES if args.episodes is None else args.episodes
        learner, stats = train_host(episodes, args.guide_episodes, args.device)
        summary = {
            "backend": "host", "episodes": stats.episodes, "env_steps": stats.env_steps,
            "wall_s": stats.wall_seconds, "updates": learner.updates, "losses": len(stats.losses),
            "episode_wall_s": stats.episode_wall_seconds,
            "mean_episode_reward": sum(stats.episode_rewards) / max(len(stats.episode_rewards), 1),
        }
    else:
        if args.guide_episodes is not None:
            ap.error("--guide-episodes guides the host trainer only")
        episodes = TRAIN_EPISODES if args.episodes is None else args.episodes
        learner, stats = train(episodes, args.batch, args.horizon, args.device)
        summary = {
            "backend": "batched", "episodes": stats.episodes, "rounds": stats.rounds,
            "env_steps": stats.env_steps, "wall_s": stats.wall_seconds,
            "env_steps_per_s": stats.env_steps_per_sec, "updates": stats.updates,
            "final_epsilon": stats.final_epsilon, "round_wall_s": stats.round_wall_seconds,
            "losses": len(stats.losses),
            "mean_episode_reward": sum(stats.episode_rewards) / max(len(stats.episode_rewards), 1),
        }
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    learner.save(args.out)
    print(json.dumps({"out": args.out, "device": str(learner.device), **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
