"""DQN agent <-> simulator glue.

The agent is a :class:`repro_torch.core.simulator.RepartitionPolicy`: at every
decision event (arrival/completion) it reads the state features, accumulates
the ET-scalarized reward since its previous decision, stores the transition,
optionally trains, and returns the chosen configuration.  It is the
evaluation-mode policy (``greedy_policy``) the policy registry
(:mod:`repro_torch.sweep.cells`) instantiates, and it still collects replay
when used as a live policy.

The port's own copy of ``repro.core.rl.agent``, on the port's
:class:`~repro_torch.core.rl.dqn.DQNLearner`: its Q network runs on the
learner's device (the CUDA card by default), one host-to-device copy of the
observation and one synchronisation a decision.
"""

from __future__ import annotations

import collections
from typing import Optional, TYPE_CHECKING

import numpy as np

from repro_torch.core.rl.dqn import DQNLearner
from repro_torch.core.rl.env import RewardWeights, state_features

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.simulator import MIGSimulator

__all__ = ["NStepAccumulator", "DQNAgent", "greedy_policy"]


class NStepAccumulator:
    """n-step return bookkeeping shared by the agent and the train loop.

    Transitions are buffered until ``n_step`` rewards have accumulated (or
    the episode ends), then emitted into the learner's replay with the
    discounted n-step return and the residual discount ``g`` for the
    bootstrap term.
    """

    def __init__(self, n_step: int, gamma: float) -> None:
        self.n_step = n_step
        self.gamma = gamma
        self._pending: collections.deque = collections.deque()

    def push(self, learner: DQNLearner, s, a, r, s_next, done: bool) -> None:
        """Append ``(s, a, r)``; emit matured transitions into replay."""
        self._pending.append([s, a, r])
        if done:
            # flush everything with the true remaining returns
            while self._pending:
                R, g = 0.0, 1.0
                for (_, _, ri) in self._pending:
                    R += g * ri
                    g *= self.gamma
                s0, a0, _ = self._pending.popleft()
                learner.observe(s0, a0, R, s_next, True, g)
        elif len(self._pending) >= self.n_step:
            R, g = 0.0, 1.0
            for (_, _, ri) in self._pending:
                R += g * ri
                g *= self.gamma
            s0, a0, _ = self._pending.popleft()
            learner.observe(s0, a0, R, s_next, False, g)

    def clear(self) -> None:
        """Drop buffered transitions (episode reset)."""
        self._pending = collections.deque()


class DQNAgent:
    """Training-mode policy: epsilon-greedy actions + replay collection.

    ``decision_interval_min`` puts the agent on a fixed decision cadence:
    it acts only at (or at the first event past) multiples of the interval
    and holds the configuration in between — the decision distribution the
    fused batched trainer (:mod:`repro_torch.core.rl.batched_train`) trains
    under, so cadence-trained policies evaluate on the oracle engine under
    matching semantics.  ``next_timer`` schedules the marks, so the engine
    creates a decision point at each one even when the system idles.
    """

    def __init__(
        self,
        learner: DQNLearner,
        rewards: RewardWeights = RewardWeights(),
        initial_config: int = 2,
        train: bool = True,
        train_steps_per_decision: int = 1,
        guide=None,  # optional policy whose actions warm-start the replay
        decision_interval_min: Optional[float] = None,
    ) -> None:
        if decision_interval_min is not None and decision_interval_min <= 0:
            raise ValueError("decision_interval_min must be positive")
        self.learner = learner
        self.rewards = rewards
        self.initial_config = initial_config
        self.train = train
        self.train_steps = train_steps_per_decision
        self.guide = guide
        self.decision_interval_min = decision_interval_min
        self._next_mark = 0.0
        self.use_guide = False
        self.epsilon = 0.0
        self._prev_state: Optional[np.ndarray] = None
        self._prev_action: Optional[int] = None
        self._prev_energy = 0.0
        self._prev_tard = 0.0
        self._pending_penalty = 0.0
        self._nstep = NStepAccumulator(learner.cfg.n_step, learner.cfg.gamma)
        self.episode_reward = 0.0
        self.losses: list = []

    # -- episode lifecycle -------------------------------------------------
    def begin_episode(self, epsilon: float) -> None:
        self.epsilon = epsilon
        self._next_mark = 0.0
        self._prev_state = None
        self._prev_action = None
        self._prev_energy = 0.0
        self._prev_tard = 0.0
        self._pending_penalty = 0.0
        self._nstep.clear()
        self.episode_reward = 0.0
        self.losses = []

    def _push_nstep(self, s, a, r, s_next, done: bool) -> None:
        self._nstep.push(self.learner, s, a, r, s_next, done)

    def end_episode(self, sim: "MIGSimulator") -> None:
        """Flush the terminal transition (done=True)."""
        if self._prev_state is None:
            return
        r = self._interval_reward(sim)
        self.episode_reward += r
        terminal = state_features(sim.t, sim)
        if self.train:
            self._push_nstep(self._prev_state, self._prev_action, r, terminal, True)
            self.learner.maybe_train(self.train_steps)
        self._prev_state = None

    # -- RepartitionPolicy protocol -----------------------------------------
    def decide(self, t: float, sim: "MIGSimulator") -> Optional[int]:
        if self.decision_interval_min is not None:
            if t < self._next_mark - 1e-9:
                return None  # off-cadence event: hold, no bookkeeping
            interval = self.decision_interval_min
            self._next_mark = (np.floor(t / interval + 1e-9) + 1.0) * interval
        state = state_features(t, sim)
        if self._prev_state is not None:
            r = self._interval_reward(sim)
            self.episode_reward += r
            if self.train:
                self._push_nstep(self._prev_state, self._prev_action, r, state, False)
                loss = self.learner.maybe_train(self.train_steps)
                if loss == loss:  # not NaN
                    self.losses.append(loss)
        if self.use_guide and self.guide is not None:
            choice = self.guide.decide(t, sim)
            action = (choice - 1) if choice is not None else (sim.partition.config_id - 1)
        elif self.train:
            action = self.learner.act(state, self.epsilon)
        else:
            action = self.learner.greedy_action(state)
        self._prev_state = state
        self._prev_action = action
        config_id = action + 1  # actions 0..11 -> configs 1..12
        if config_id != sim.partition.config_id:
            # §IV-D-3 switch penalty, charged to this (s, a) on its next reward
            self._pending_penalty = self.rewards.switch_penalty(len(sim.active))
            return config_id
        return None

    def next_timer(self, t: float) -> Optional[float]:
        if self.decision_interval_min is None:
            return None
        interval = self.decision_interval_min
        return (np.floor(t / interval + 1e-9) + 1.0) * interval

    # -- reward bookkeeping --------------------------------------------------
    def _interval_reward(self, sim: "MIGSimulator") -> float:
        d_e = sim.energy_wh - self._prev_energy
        d_t = sim.tardiness_integral - self._prev_tard
        self._prev_energy = sim.energy_wh
        self._prev_tard = sim.tardiness_integral
        r = self.rewards.interval_reward(d_e, d_t) - self._pending_penalty
        self._pending_penalty = 0.0
        return r


def greedy_policy(
    learner: DQNLearner,
    initial_config: int = 2,
    decision_interval_min: Optional[float] = None,
) -> DQNAgent:
    """Evaluation-mode agent: greedy, no replay writes, no training.

    ``decision_interval_min`` evaluates on the fixed cadence the batched
    trainer trained under (see :class:`DQNAgent`).
    """
    agent = DQNAgent(
        learner,
        train=False,
        initial_config=initial_config,
        decision_interval_min=decision_interval_min,
    )
    agent.begin_episode(epsilon=0.0)
    return agent
