"""Deep Q-Network in torch (paper §IV-D), the port of ``repro.core.rl.dqn``.

Epsilon-greedy exploration, experience replay, a target network and the
Huber TD loss, with no NN library: the Q-network is a ReLU MLP over the
``2+2m`` binned state features, held as a list of ``(w, b)`` tensors; the
action space is the 12 MIG configurations of Fig. 1.  The optimizer is the
port's :class:`~repro_torch.optim.adamw.AdamW` configured down to classic Adam
(``weight_decay=0``, no clipping, ``b2=0.999``), so the host learner and the
on-device trainer (:mod:`repro_torch.core.rl.batched_train`) share one update
rule: :func:`make_td_update`.

Parameters cross between the packages as numpy ``(w, b)`` pairs
(:func:`mlp_params_from_numpy`, :func:`mlp_params_to_numpy`), and
:meth:`DQNLearner.save`/:meth:`~DQNLearner.load` read and write the
reference's npz layout (``w{i}``, ``b{i}``, ``n_layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.slices import NUM_CONFIGS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import AdamW, AdamWConfig

__all__ = [
    "DQNConfig",
    "ReplayBuffer",
    "DQNLearner",
    "init_mlp",
    "q_forward",
    "make_optimizer",
    "make_td_update",
    "epsilon_by_step",
    "mlp_params_from_numpy",
    "mlp_params_to_numpy",
]

Params = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    state_dim: int = 8
    num_actions: int = NUM_CONFIGS
    hidden: Tuple[int, ...] = (256, 256)
    gamma: float = 0.99
    n_step: int = 8  # n-step TD targets (credit over event chains)
    lr: float = 5e-4
    batch_size: int = 128
    buffer_capacity: int = 200_000
    min_buffer: int = 2_000
    target_sync_every: int = 1_000
    huber_delta: float = 1.0
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_episodes: int = 150
    # global-env-step epsilon decay for vectorized training (None = unset;
    # the host loop keeps its per-episode schedule either way)
    eps_decay_steps: Optional[int] = None
    seed: int = 0


def init_mlp(generator: torch.Generator, sizes: Tuple[int, ...], device: DeviceLike = None) -> Params:
    """He-normal weights and zero biases, drawn from ``generator`` (a CPU one
    gives the same network on every device)."""
    dev = resolve_device(device)
    params: Params = []
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator, dtype=torch.float32,
                        device=generator.device)
        w = w * float(np.sqrt(np.float32(2.0 / sizes[i])))
        params.append((w.to(dev), torch.zeros((sizes[i + 1],), dtype=torch.float32, device=dev)))
    return params


def q_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in params[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    return h @ w + b


def mlp_params_from_numpy(pairs: Sequence[Tuple[Any, Any]], device: DeviceLike = None) -> Params:
    """The port's MLP from numpy ``(w, b)`` pairs (a reference ``DQNLearner.params``
    as numpy), as float32 tensors on ``device``; the arrays are copied."""
    dev = resolve_device(device)
    out: Params = []
    for i, (w, b) in enumerate(pairs):
        w = np.asarray(w, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: w {w.shape} and b {b.shape} are not an (in, out) and (out,) pair")
        if out and out[-1][0].shape[1] != w.shape[0]:
            raise ValueError(f"layer {i}: takes {w.shape[0]} inputs, layer {i - 1} gives {out[-1][0].shape[1]}")
        out.append((torch.from_numpy(w.copy()).to(dev), torch.from_numpy(b.copy()).to(dev)))
    return out


def mlp_params_to_numpy(params: Params) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``params`` as numpy ``(w, b)`` pairs (float32)."""
    return [(w.detach().cpu().numpy(), b.detach().cpu().numpy()) for w, b in params]


def _flat(params: Params) -> List[torch.Tensor]:
    return [t for wb in params for t in wb]


def _pairs(flat: Sequence[torch.Tensor]) -> Params:
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


class ReplayBuffer:
    """Circular numpy replay buffer."""

    def __init__(self, capacity: int, state_dim: int) -> None:
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.g = np.zeros((capacity,), np.float32)  # bootstrap discount gamma^k
        self.size = 0
        self.pos = 0

    def add(self, s, a, r, s2, done, g) -> None:
        i = self.pos
        self.s[i] = s
        self.a[i] = a
        self.r[i] = r
        self.s2[i] = s2
        self.done[i] = float(done)
        self.g[i] = g
        self.pos = (self.pos + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.size, size=batch)
        return (
            self.s[idx], self.a[idx], self.r[idx], self.s2[idx],
            self.done[idx], self.g[idx],
        )


# ------------------------ shared TD update step ----------------------------


def make_optimizer(cfg: DQNConfig, lr=None) -> AdamW:
    """The DQN optimizer: :class:`AdamW` as classic Adam (``weight_decay=0``,
    no clipping, ``b2=0.999``); ``lr`` may be a schedule (step -> lr),
    defaulting to the constant ``cfg.lr``."""
    return AdamW(AdamWConfig(
        lr=cfg.lr if lr is None else lr,
        b1=0.9, b2=0.999, eps=1e-8,
        weight_decay=0.0, grad_clip_norm=None,
    ))


def make_td_update(cfg: DQNConfig, lr=None):
    """Build ``(optimizer, update_fn)``: the one double-DQN training step.

    ``update_fn(params, target, opt_state, s, a, r, s2, done, g)`` returns
    ``(new_params, new_opt_state, loss)`` and is pure: it reads its tensors and
    returns new ones.  The loss is the Huber loss of ``Q(s, a)`` against the
    n-step target ``r + g * (1 - done) * Q_target(s2, argmax_a Q(s2, a))``
    (``r`` the discounted n-step sum, ``g = gamma^k``); the target, the
    online argmax on ``s2`` included, carries no gradient.
    """
    opt = make_optimizer(cfg, lr)

    def update(params, target, opt_state, s, a, r, s2, done, g):
        leaves = [t.detach().requires_grad_(True) for t in _flat(params)]
        p = _pairs(leaves)
        with torch.enable_grad():
            q = q_forward(p, s)
            q_sa = q.gather(1, a.long()[:, None])[:, 0]
            with torch.no_grad():
                # Double DQN: the online net picks the argmax, the target net evaluates it
                a2 = q_forward(p, s2).argmax(1)
                q_next = q_forward(target, s2).gather(1, a2[:, None])[:, 0]
                tgt = r + g * (1.0 - done) * q_next
            td = q_sa - tgt
            abs_td = torch.abs(td)
            # torch.minimum against a tensor, as jnp.minimum: ties split the gradient
            quad = torch.minimum(abs_td, torch.full_like(abs_td, cfg.huber_delta))
            lin = abs_td - quad
            loss = torch.mean(0.5 * quad ** 2 + cfg.huber_delta * lin)
        grads = torch.autograd.grad(loss, leaves)
        new_flat, new_opt = opt.update(grads, opt_state, [t.detach() for t in leaves])
        return _pairs(new_flat), new_opt, loss.detach()

    return opt, update


def epsilon_by_step(cfg: DQNConfig, env_step) -> np.float32:
    """Linear ``eps_start -> eps_end`` over ``cfg.eps_decay_steps`` global env steps.

    A host float32, formed as the reference's source forms it under JAX's
    promotion: ``f32(eps_start) + f32(eps_end - eps_start) * min(f32(step) /
    f32(decay), 1)``; equal to the reference's function evaluated eagerly (as
    its learner and trainer stats evaluate it).  Compiled inside the
    reference's round, XLA multiplies by the reciprocal and fuses and
    reassociates the multiply-add, which moves its epsilon by a few ulps.
    Invariant to how many rollouts advance in parallel, because the clock is
    *global* env steps, not episodes.
    """
    f32 = np.float32
    decay = max(int(cfg.eps_decay_steps or 1), 1)
    frac = np.minimum(f32(env_step) / f32(decay), f32(1.0))
    return f32(cfg.eps_start) + f32(cfg.eps_end - cfg.eps_start) * frac


# ------------------------------- learner ----------------------------------


class DQNLearner:
    """Holds online/target params and the optimizer state on ``device``
    (default: the CUDA card; ``"cpu"`` on request)."""

    def __init__(self, cfg: DQNConfig, device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        sizes = (cfg.state_dim, *cfg.hidden, cfg.num_actions)
        self.params = init_mlp(gen, sizes, self.device)
        self.target = [(w.clone(), b.clone()) for w, b in self.params]
        self._opt, self._update = make_td_update(cfg)
        self.opt_state = self._opt.init(_flat(self.params))
        self.updates = 0
        self.buffer = ReplayBuffer(cfg.buffer_capacity, cfg.state_dim)
        self._rng = np.random.default_rng(cfg.seed + 1)

    # -- acting ----------------------------------------------------------
    @torch.no_grad()
    def q(self, state: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(state, np.float32)[None, :], device=self.device)
        return q_forward(self.params, x).cpu().numpy()[0]

    def act(self, state: np.ndarray, epsilon: float) -> int:
        if self._rng.uniform() < epsilon:
            return int(self._rng.integers(0, self.cfg.num_actions))
        return int(np.argmax(self.q(state)))

    def greedy_action(self, state: np.ndarray) -> int:
        return int(np.argmax(self.q(state)))

    # -- learning ---------------------------------------------------------
    def observe(self, s, a, r, s2, done, g=None) -> None:
        self.buffer.add(s, a, r, s2, done, self.cfg.gamma if g is None else g)

    def maybe_train(self, steps: int = 1) -> float:
        if self.buffer.size < self.cfg.min_buffer:
            return float("nan")
        loss = float("nan")
        for _ in range(steps):
            batch = self.buffer.sample(self._rng, self.cfg.batch_size)
            self.params, self.opt_state, loss_t = self._update(
                self.params, self.target, self.opt_state,
                *(torch.as_tensor(x, device=self.device) for x in batch),
            )
            loss = float(loss_t)
            self.updates += 1
            if self.updates % self.cfg.target_sync_every == 0:
                self.target = [(w.clone(), b.clone()) for w, b in self.params]
        return loss

    def epsilon(self, episode: int) -> float:
        """Host-loop schedule: linear decay over ``eps_decay_episodes``."""
        c = self.cfg
        frac = min(episode / max(c.eps_decay_episodes, 1), 1.0)
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def epsilon_at_step(self, env_step: int) -> float:
        """Vectorized-training schedule: decay in *global* env steps."""
        return float(epsilon_by_step(self.cfg, env_step))

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        arrays: Dict[str, np.ndarray] = {}
        for i, (w, b) in enumerate(mlp_params_to_numpy(self.params)):
            arrays[f"w{i}"] = w
            arrays[f"b{i}"] = b
        arrays["n_layers"] = np.asarray(len(self.params))
        np.savez(path, **arrays)

    def load(self, path: str) -> None:
        with np.load(path) as data:
            n = int(data["n_layers"])
            pairs = [(data[f"w{i}"], data[f"b{i}"]) for i in range(n)]
        self.params = mlp_params_from_numpy(pairs, self.device)
        self.target = [(w.clone(), b.clone()) for w, b in self.params]
