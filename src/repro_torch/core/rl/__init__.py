"""Reinforcement-learning repartitioning (paper §IV-D) in torch: the DQN and its on-device trainer.

The port of ``repro.core.rl`` as far as the batched trainer needs it:

* :mod:`repro_torch.core.rl.env` — the §IV-D feature layout, bin tables and
  :class:`RewardWeights` (host constants);
* :mod:`repro_torch.core.rl.dqn` — the Q-network, the shared double-DQN TD
  update on the port's AdamW, :class:`DQNLearner` (the reference's npz);
* :mod:`repro_torch.core.rl.batched_train` — :func:`train_dqn_batched`, B
  rollouts and the learner advancing together on one device.

The event-engine env (``RepartitionEnv``), the host training loop, the agent
and the evaluation path (``greedy_policy``, ``evaluate_policy``) sit on the
reference's event-driven oracle and are not ported.
"""

from repro_torch.core.rl.batched_train import (
    BatchedTrainConfig,
    BatchedTrainStats,
    device_observations,
    train_dqn_batched,
)
from repro_torch.core.rl.dqn import DQNConfig, DQNLearner, ReplayBuffer, epsilon_by_step
from repro_torch.core.rl.env import FEATURE_DIM, M_JOBS, RewardWeights

__all__ = [
    "DQNConfig",
    "DQNLearner",
    "ReplayBuffer",
    "epsilon_by_step",
    "FEATURE_DIM",
    "M_JOBS",
    "RewardWeights",
    "BatchedTrainConfig",
    "BatchedTrainStats",
    "device_observations",
    "train_dqn_batched",
]
