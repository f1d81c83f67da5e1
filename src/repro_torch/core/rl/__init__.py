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
* :mod:`repro_torch.core.rl.train` — :func:`evaluate_policy`, day
  simulations under a policy on the event-driven simulator.

The host training loop (``train_dqn``) and ``evaluate_policy_fleet`` are not
ported yet.
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
    M_JOBS,
    RepartitionEnv,
    RewardWeights,
    state_features,
)
from repro_torch.core.rl.train import evaluate_policy

__all__ = [
    "DQNConfig",
    "DQNLearner",
    "ReplayBuffer",
    "epsilon_by_step",
    "FEATURE_DIM",
    "M_JOBS",
    "RewardWeights",
    "RepartitionEnv",
    "state_features",
    "DQNAgent",
    "NStepAccumulator",
    "greedy_policy",
    "BatchedTrainConfig",
    "BatchedTrainStats",
    "device_observations",
    "train_dqn_batched",
    "evaluate_policy",
]
