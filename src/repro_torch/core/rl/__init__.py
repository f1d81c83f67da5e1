"""Reinforcement-learning repartitioning (paper §IV-D) in torch: the DQN, its on-device trainer and its evaluator.

The port of ``repro.core.rl``:

* :mod:`repro_torch.core.rl.env` — the §IV-D feature layout, bin tables,
  :class:`RewardWeights`, :func:`state_features` and the incremental
  :class:`RepartitionEnv` over the event-driven engine;
* :mod:`repro_torch.core.rl.dqn` — the Q-network, the shared double-DQN TD
  update on the port's AdamW, :class:`DQNLearner` (the reference's npz);
* :mod:`repro_torch.core.rl.agent` — :class:`DQNAgent`, the n-step
  accumulator and :func:`greedy_policy`, the evaluation-mode policy;
* :mod:`repro_torch.core.rl.batched_train` — :func:`train_dqn_batched`, B
  rollouts and the learner advancing together on one device;
* :mod:`repro_torch.core.rl.train` — :func:`train_dqn`, the paper's host
  trainer over :class:`RepartitionEnv` (or, ``backend="batched"``, the
  on-device one), and :func:`evaluate_policy` / :func:`evaluate_policy_fleet`,
  day simulations under a policy on the event-driven simulator, one GPU or
  a fleet.
"""

from repro_torch.core.rl.agent import DQNAgent, NStepAccumulator, greedy_policy
from repro_torch.core.rl.batched_train import (
    BatchedTrainConfig,
    BatchedTrainStats,
    device_observations,
    train_dqn_batched,
)
from repro_torch.core.rl.dqn import DQNConfig, DQNLearner, ReplayBuffer, epsilon_by_step
from repro_torch.core.rl.env import (
    FEATURE_DIM,
    FLEET_FEATURE_DIM,
    M_JOBS,
    RepartitionEnv,
    RewardWeights,
    fleet_state_features,
    state_features,
)
from repro_torch.core.rl.train import (
    TrainStats,
    evaluate_policy,
    evaluate_policy_fleet,
    train_dqn,
)

__all__ = [
    "DQNConfig",
    "DQNLearner",
    "ReplayBuffer",
    "epsilon_by_step",
    "FEATURE_DIM",
    "FLEET_FEATURE_DIM",
    "M_JOBS",
    "RewardWeights",
    "RepartitionEnv",
    "state_features",
    "fleet_state_features",
    "DQNAgent",
    "NStepAccumulator",
    "greedy_policy",
    "BatchedTrainConfig",
    "BatchedTrainStats",
    "device_observations",
    "train_dqn_batched",
    "TrainStats",
    "train_dqn",
    "evaluate_policy",
    "evaluate_policy_fleet",
]
