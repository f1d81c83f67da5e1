"""Train the repartitioning DQN on one card and write its parameters (npz).

The port's entry point in place of the reference's
``train_dqn(backend="batched")`` and the training half of
``scripts/train_rl_baseline.py``, at that script's configuration: B 64
rollouts a round, 104 decisions of 15 minutes on the 0.5-minute grid, the
scenarios paper-diurnal, bursty-mmpp, heavy-tail-lognormal and
heavy-tail-pareto at load scales 0.8-1.2, n-step 8, lr 3e-4, target sync
every 2000 updates, min_buffer 2000, epsilon decay over 100 000 env steps,
seed 7::

    python -m repro_torch.launch.train_rl --episodes 2048 --out params.npz

writes the reference's npz layout (``w{i}``, ``b{i}``, ``n_layers``), which
``scripts/train_rl_baseline.py --check --params params.npz`` evaluates.  On
the CPU, at whatever size is given:
``python -m repro_torch.launch.train_rl --device cpu --episodes 4 --batch 2
--horizon 8 --out params.npz``.
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
from repro_torch.device import DeviceLike

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


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=TRAIN_EPISODES)
    ap.add_argument("--batch", type=int, default=64, help="rollouts a round")
    ap.add_argument("--horizon", type=int, default=104, help="decisions a round")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--out", required=True, help="where to write the parameters (npz)")
    args = ap.parse_args(argv)

    learner, stats = train(args.episodes, args.batch, args.horizon, args.device)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    learner.save(args.out)
    print(json.dumps({
        "out": args.out, "device": str(learner.device), "episodes": stats.episodes,
        "rounds": stats.rounds, "env_steps": stats.env_steps, "wall_s": stats.wall_seconds,
        "env_steps_per_s": stats.env_steps_per_sec, "updates": stats.updates,
        "final_epsilon": stats.final_epsilon, "round_wall_s": stats.round_wall_seconds,
        "losses": len(stats.losses),
        "mean_episode_reward": sum(stats.episode_rewards) / max(len(stats.episode_rewards), 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
