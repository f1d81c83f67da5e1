"""On-device DQN training: B rollouts and the learner advance together on one device.

The port of ``repro.core.rl.batched_train``.  A *round* of ``B`` episodes
advances lock-step over ``horizon_decisions`` decisions.  The reference runs
the round as one jitted ``lax.scan``; here it is a host loop over decisions,
each of which issues, in the reference's order:

1. epsilon-greedy actions on the *global env-step* schedule
   (:func:`~repro_torch.core.rl.dqn.epsilon_by_step`: B rollouts advance B
   env steps a decision), greedy from the online network on the observation
   carried from the previous decision;
2. the §IV-D-3 switch penalty, priced on the jobs in the system;
3. ``spd`` grid steps of the simulation backend's own step
   (:func:`~repro_torch.core.batched.backend.make_step_fn`, the ``static``
   kind with the action as its target), so training rollouts obey the
   dynamics evaluation runs;
4. the float32 interval reward, the next observation
   (:func:`device_observations`) and the termination flags;
5. n-step transitions into a fixed-shape ring replay on the device (the
   recency rings emit what ``NStepAccumulator`` emits: maturation at lag
   n-1, and the flush of the shorter lags when a rollout terminates);
6. one TD update from that replay through the shared
   :func:`~repro_torch.core.rl.dqn.make_td_update`, while the replay holds at
   least ``min_buffer`` transitions, and the target sync by update count.

The replay's size decides whether a decision trains and bounds its sample
indices, so the host reads it: one synchronisation a decision, which also
brings back the decision's live count (the global env-step clock).  The
update count and the target sync are therefore host integers, and a decision
that does not train leaves the parameters and Adam's state untouched, as the
reference's ``lax.cond`` does.

Exploration, random actions and replay indices are drawn from one
``torch.Generator`` on the device.  The round also takes a private source of
these draws, with which the tests replay the reference's ``jax.random`` key
chain; no configuration reaches it.

Two float conventions meet here, each as its reference has it: the
trainer's rewards are float32 on the device, while
:class:`~repro_torch.core.batched.env.BatchedRepartitionEnv` forms its rewards
in float64 on the host.  Every scalar the reference forms in float32 (the
decision's time, epsilon, the reward weights) is formed so here.  The
reference's round runs compiled, and XLA rewrites a division by a constant
into a multiplication by the constant's float32 reciprocal; the features and
the rewards are formed that way here too (:func:`_recip`), so the features
are the reference round's bit for bit.  XLA's CPU backend also fuses and
reassociates multiply-adds, which torch does not: the rewards may sit an ulp
from the reference round's, and its epsilon a few ulps from
:func:`~repro_torch.core.rl.dqn.epsilon_by_step` (which equals the reference
function evaluated eagerly).

:func:`shard_rollouts` places rollout-batched tensors on a 1-D ``rollout``
mesh over a ``torch.distributed`` world; with one device it is the identity.
The trainer runs on one card and does not call it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor

from repro_torch.core.batched.backend import (
    DEFAULT_DT_MIN,
    RolloutState,
    _step_time,
    device_constants,
    init_state,
    make_step_fn,
    result_of,
)
from repro_torch.core.batched.state import BatchedJobs
from repro_torch.core.batched.tables import DeviceTables, build_tables
from repro_torch.core.rl.dqn import (
    DQNConfig,
    DQNLearner,
    epsilon_by_step,
    make_td_update,
    q_forward,
)
from repro_torch.core.rl.env import (
    _BIN_EDGES,
    _NUM_BINS,
    _TIME_BINS,
    FEATURE_DIM,
    M_JOBS,
    RewardWeights,
    inv_mean_durations,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import flatten_with_paths, unflatten

__all__ = [
    "shard_rollouts",
    "BatchedTrainConfig",
    "BatchedTrainStats",
    "ObsTables",
    "Replay",
    "device_observations",
    "new_replay",
    "observation_tables",
    "train_dqn_batched",
]

_EPS = 1e-6
_F32 = np.float32
# held_policy()'s day window, passed to make_step_fn as the env's steps do
_DAY_START = 5 * 60.0
_DAY_END = 17 * 60.0


@dataclasses.dataclass(frozen=True)
class BatchedTrainConfig:
    """Knobs of the on-device trainer (everything episode-shaped lives here).

    ``horizon_decisions`` is the fixed round length; rollouts that terminate
    earlier are masked out (no actions, no transitions, no env steps), and
    rollouts still live at the horizon are truncated: their pending n-step
    tail is dropped (a bootstrapped continuation).  ``load_scale_range``
    draws one uniform load scale per episode; ``scenarios`` round-robins per
    episode.
    """

    batch: int = 32
    scenarios: Tuple[str, ...] = ("paper-diurnal",)
    scenario_kwargs: Optional[Dict[str, Any]] = None
    load_scale_range: Tuple[float, float] = (1.0, 1.0)
    decision_interval_min: float = 15.0
    dt_min: float = DEFAULT_DT_MIN
    horizon_decisions: int = 104  # a 24h day at 15-min cadence + drain tail
    replay_capacity: int = 16_384
    repartition_mode: str = "partial"
    initial_config: int = 2
    lr_schedule: str = "constant"  # "constant" | "cosine"


@dataclasses.dataclass
class BatchedTrainStats:
    """Per-episode returns and ET proxies, losses and throughput.

    ``env_steps`` counts live decisions across all rollouts (the DESIGN §11
    currency); ``round_wall_seconds`` holds each round's wall time on the
    host clock, the first round's including the allocator's warm-up.
    """

    episode_rewards: List[float]
    episode_et_proxy: List[float]
    losses: List[float]
    episodes: int
    wall_seconds: float
    env_steps: int = 0
    env_steps_per_sec: float = 0.0
    updates: int = 0
    final_epsilon: float = 0.0
    rounds: int = 0
    batch: int = 0
    truncated_episodes: int = 0
    round_wall_seconds: List[float] = dataclasses.field(default_factory=list)
    round_env_steps: List[int] = dataclasses.field(default_factory=list)


# ---------------------------- device observations --------------------------


class ObsTables(NamedTuple):
    """The constants of :func:`device_observations` on one device.

    ``cfg_col[c]`` and ``bin_col[i]`` are the reference's float32 features
    ``(f32(config_id) - 1) / 11`` and ``f32(i) / 9`` as it computes them
    (times the constant's reciprocal), formed once in numpy and gathered by
    index.
    """

    edges: torch.Tensor  # (9,) f32 bin edges
    cfg_col: torch.Tensor  # (C,) f32
    bin_col: torch.Tensor  # (10,) f32
    ranks: torch.Tensor  # (m,) i32: 1 .. m


def _recip(c: float) -> np.float32:
    """The float32 reciprocal of the constant ``c``, by which compiled JAX
    multiplies where the reference divides by ``c``."""
    return _F32(1.0) / _F32(c)


def observation_tables(config_ids, device: DeviceLike = None, m: int = M_JOBS) -> ObsTables:
    dev = resolve_device(device)
    ids = np.asarray(config_ids).astype(np.float32)
    cfg_col = (ids - _F32(1.0)) * _recip(11.0)
    bin_col = np.arange(_NUM_BINS, dtype=np.float32) * _recip(_NUM_BINS - 1)
    return ObsTables(
        edges=torch.tensor(_BIN_EDGES, dtype=torch.float32, device=dev),
        cfg_col=torch.from_numpy(cfg_col).to(dev),
        bin_col=torch.from_numpy(bin_col).to(dev),
        ranks=torch.arange(1, m + 1, dtype=torch.int32, device=dev),
    )


def _tod_col(t: np.float32) -> float:
    """The time-of-day feature at ``t`` as the reference computes it in float32:
    ``mod(floor(mod(t / 60, 24) * 2), 48) / 47``."""
    tod = np.mod(_F32(t) * _recip(60.0), _F32(24.0))
    return float(np.mod(np.floor(tod * _F32(2.0)), _F32(_TIME_BINS)) * _recip(_TIME_BINS - 1))


def device_observations(
    state: RolloutState, arrival, deadline, valid, dorder, inv_mean_dur,
    tables: ObsTables, t, m: int = M_JOBS,
) -> torch.Tensor:
    """§IV-D-1 features for every rollout, on the device: ``(B, 2+2m)`` float32.

    The port of the reference's ``device_observations`` (a mirror of
    ``BatchedRepartitionEnv._obs``): the same bin edges, sentinels and
    EDF-stable order through the static ``dorder`` permutation, in float32.
    ``t`` is the decision's time, a host float32; ``tables`` from
    :func:`observation_tables`; ``dorder`` int64.
    """
    B, J = arrival.shape
    t32 = _F32(t)
    t_ = float(t32)
    t_eps = float(t32 + _F32(_EPS))

    # running mask from the slice->job lanes: a scatter-max over the clipped
    # lanes, so the padding lanes (-1 -> 0) never set job 0
    sj = state.slice_job.to(torch.int64)
    running = torch.zeros((B, J), dtype=torch.uint8, device=sj.device).scatter_reduce_(
        1, sj.clamp(0, J - 1), (sj >= 0).to(torch.uint8), "amax").bool()

    queued = (arrival <= t_eps) & (state.remaining > _EPS) & (~running) & valid
    # the first m in EDF order: permute the queued mask by the static deadline
    # order, then find the i-th set bit by a per-row search of the running
    # count (J where fewer than i jobs are queued)
    cs = queued.gather(1, dorder).cumsum(1, dtype=torch.int32)
    sel = torch.searchsorted(cs, tables.ranks.expand(B, -1).contiguous())  # (B, m)
    has = sel < J
    jobsel = dorder.gather(1, sel.clamp(0, J - 1))

    dl = deadline.gather(1, jobsel)
    rem = state.remaining.gather(1, jobsel)
    inv = inv_mean_dur.gather(1, jobsel)
    slack = (dl - t_).clamp(min=0.0)
    mean_dur = rem * inv
    sbin = tables.bin_col[torch.searchsorted(tables.edges, slack, right=True)]
    dbin = tables.bin_col[torch.searchsorted(tables.edges, mean_dur, right=True)]
    sfeat = torch.where(has, sbin, 1.0)  # "no job" sentinel: max slack
    dfeat = torch.where(has, dbin, 0.0)
    jobfeat = torch.stack([sfeat, dfeat], dim=2).reshape(B, 2 * m)

    cfg_col = tables.cfg_col[state.cfg.to(torch.int64)]
    tod_col = torch.full_like(cfg_col, _tod_col(t32))
    return torch.cat([cfg_col[:, None], tod_col[:, None], jobfeat], dim=1)


# ------------------------------- the replay ---------------------------------


class Replay(NamedTuple):
    """The fixed-shape ring replay on the device.

    Each tensor holds ``capacity + 1`` rows: the last is a sentinel that takes
    the writes of candidates not emitted (the reference's ``mode="drop"``);
    it is never sampled, since indices stay below ``size <= capacity``.
    ``pos`` and ``size`` are host integers.
    """

    s: torch.Tensor  # (cap + 1, D) f32
    a: torch.Tensor  # (cap + 1,) i32
    r: torch.Tensor  # (cap + 1,) f32
    s2: torch.Tensor  # (cap + 1, D) f32
    done: torch.Tensor  # (cap + 1,) f32
    g: torch.Tensor  # (cap + 1,) f32
    pos: int
    size: int

    @property
    def capacity(self) -> int:
        return self.a.shape[0] - 1


def new_replay(capacity: int, state_dim: int, device: DeviceLike = None) -> Replay:
    dev = resolve_device(device)
    n = int(capacity) + 1

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return Replay(z(n, state_dim), z(n, dtype=torch.int32), z(n), z(n, state_dim), z(n), z(n), 0, 0)


# ------------------------------- the draws ----------------------------------


class _GeneratorDraws:
    """The round's random draws from one ``torch.Generator`` on the device."""

    def __init__(self, generator: torch.Generator) -> None:
        self.gen = generator

    def act(self, B: int, A: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(uniform (B,) f32 in [0, 1), random actions (B,) int64 in [0, A))``."""
        dev = self.gen.device
        u = torch.rand((B,), generator=self.gen, device=dev)
        return u, torch.randint(0, A, (B,), generator=self.gen, device=dev)

    def sample(self, bs: int, size: int) -> torch.Tensor:
        """``bs`` replay indices in ``[0, max(size, 1))``, int64."""
        return torch.randint(0, max(size, 1), (bs,), generator=self.gen, device=self.gen.device)


class _RecordedDraws:
    """Draws recorded elsewhere, replayed in order: ``u`` and ``randa`` (H, B)
    and one row of ``idx`` per update (the test seam of the round)."""

    def __init__(self, u, randa, idx, device: DeviceLike = None) -> None:
        dev = resolve_device(device)
        self.u = torch.as_tensor(np.asarray(u, np.float32), device=dev)
        self.randa = torch.as_tensor(np.asarray(randa, np.int64), device=dev)
        self.idx = [torch.as_tensor(np.asarray(i, np.int64), device=dev) for i in idx]
        self.k = self.j = 0

    def act(self, B: int, A: int) -> Tuple[torch.Tensor, torch.Tensor]:
        self.k += 1
        return self.u[self.k - 1], self.randa[self.k - 1]

    def sample(self, bs: int, size: int) -> torch.Tensor:
        self.j += 1
        return self.idx[self.j - 1]


# ----------------------------- the round ------------------------------------


def _make_round_fn(
    cfg: DQNConfig,
    tcfg: BatchedTrainConfig,
    rewards: RewardWeights,
    tables: DeviceTables,
    consts: Dict[str, torch.Tensor],
    lr=None,
    device: DeviceLike = None,
):
    """Build the round: a host loop over ``horizon_decisions`` on ``device``.

    ``round_fn(env0, params, target, opt_state, replay, gstep, updates,
    generator, arrival, deadline, rates, valid, dorder, inv_md, _draws=None)``
    returns ``(env, params, target, opt_state, replay, gstep, updates, outs)``;
    ``gstep`` and ``updates`` are host integers, and ``outs`` holds per
    decision the rewards, live masks, actions and termination flags ``(H, B)``,
    the observations ``(H + 1, B, D)``, the losses ``(H,)`` (NaN where no
    update ran) and the epsilons ``(H,)``.
    """
    if cfg.num_actions != tables.num_configs:
        raise ValueError(
            f"num_actions={cfg.num_actions} != {tables.num_configs} device "
            "configs; the action space is the dense config index"
        )
    if cfg.state_dim != 2 + 2 * M_JOBS:
        raise ValueError(
            f"state_dim={cfg.state_dim} != feature dim {2 + 2 * M_JOBS}"
        )
    interval = float(tcfg.decision_interval_min)
    spd = int(round(interval / tcfg.dt_min))
    if abs(spd * tcfg.dt_min - interval) > 1e-9 or spd < 1:
        raise ValueError(
            f"decision_interval_min={interval} must be a positive multiple "
            f"of dt_min={tcfg.dt_min}"
        )
    dev = resolve_device(device)
    dt = float(tcfg.dt_min)
    step = make_step_fn("static", dt, float(tables.penalty_min), _DAY_START, _DAY_END)
    _, td_update = make_td_update(cfg, lr=lr)
    obs_tabs = observation_tables(tables.config_ids, dev)

    n = int(cfg.n_step)
    gamma = float(cfg.gamma)
    cap = int(tcfg.replay_capacity)
    H = int(tcfg.horizon_decisions)
    B = int(tcfg.batch)
    A = int(cfg.num_actions)
    D = int(cfg.state_dim)
    bs = int(cfg.batch_size)
    min_buffer = int(cfg.min_buffer)
    sync_every = int(cfg.target_sync_every)
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    # the reward weights as the reference's float32 constants, its divisors
    # as their reciprocals
    w_a, w_switch = float(_F32(rewards.a)), float(_F32(rewards.switch_penalty_min))
    r_norm, r_a1, r_scale = (float(_recip(rewards.tardiness_norm)), float(_recip(rewards.a + 1.0)),
                             float(_recip(rewards.scale)))
    # n-step returns: ret[:, o] = sum_{d <= o} rew_h[:, d] * gamma^(o-d), added
    # in the reference's order d = 0, 1, ..; the zero weights of d > o add 0
    gpow = np.zeros((n, n), np.float32)
    for d in range(n):
        for o in range(d, n):
            gpow[d, o] = gamma ** (o - d)
    gpow_t = torch.from_numpy(gpow).to(dev)
    g_flat = torch.from_numpy(np.repeat(np.asarray([gamma ** (o + 1) for o in range(n)],
                                                   np.float32), B)).to(dev)
    # candidate block o is valid where the rollout flushes (o < n-1) or is
    # live (o = n-1), and only once decision k has reached lag o
    which = torch.tensor([0] * (n - 1) + [1], dtype=i64, device=dev)
    lags = torch.arange(n, dtype=i64, device=dev)

    @torch.no_grad()
    def round_fn(env0, params, target, opt_state, replay, gstep, updates, generator,
                 arrival, deadline, rates, valid, dorder, inv_md, _draws=None):
        draws = _GeneratorDraws(generator) if _draws is None else _draws
        rs, ra, rr, rs2, rdone, rg, pos, size = replay
        obs_h = torch.zeros((B, n, D), dtype=f32, device=dev)
        act_h = torch.zeros((B, n), dtype=i32, device=dev)
        rew_h = torch.zeros((B, n), dtype=f32, device=dev)
        env = env0
        obs = device_observations(env, arrival, deadline, valid, dorder, inv_md, obs_tabs, _F32(0.0))
        o_rew, o_live, o_act, o_done, o_obs, o_loss, o_eps = [], [], [], [], [obs], [], []
        for k in range(H):
            t = _F32(k) * _F32(interval)
            t_eps = float(t + _F32(_EPS))
            # ``obs`` (the pre-step observation) is obs2 of the decision before
            live = env.stop_time > t_eps
            eps = epsilon_by_step(cfg, gstep)
            u, randa = draws.act(B, A)
            greedy = q_forward(params, obs).argmax(1)
            explore = u < float(eps)
            cfg_now = env.cfg.to(i64)
            # dense config index == action id; halted rollouts hold their
            # configuration and emit nothing
            action = torch.where(live, torch.where(explore, randa, greedy), cfg_now)

            # the physics, its reward and observation: under inference_mode,
            # which skips autograd's bookkeeping altogether (cheaper than
            # no_grad per op; chip_smoke's rl_train times both). What it makes
            # enters the replay and the rings by copy, never a graph.
            with torch.inference_mode():
                # §IV-D-3 switch penalty, priced on jobs currently in system
                in_sys = ((arrival <= t_eps) & (env.remaining > _EPS) & valid).sum(1, dtype=i32)
                pen_y = w_switch * in_sys.clamp(min=1).to(f32) * r_norm
                penalty = torch.where((action != cfg_now) & live, (pen_y * r_a1) * r_scale, 0.0)

                e0, td0 = env.energy_wh, env.tardiness_integral
                for i in range(spd):
                    env = step(env, _step_time(t, i, dt), arrival, deadline, rates, valid, dorder,
                               action, action, consts)
                d_e = env.energy_wh - e0
                d_t = env.tardiness_integral - td0
                reward = -((w_a * d_e + d_t * r_norm) * r_a1) * r_scale - penalty
                reward = torch.where(live, reward, 0.0)

                t_next = t + _F32(interval)
                obs2 = device_observations(env, arrival, deadline, valid, dorder, inv_md, obs_tabs,
                                           t_next)
                done_next = env.stop_time <= float(t_next + _F32(_EPS))

            # -- n-step recency rings: newest at index 0 --------------------
            obs_h = torch.roll(obs_h, 1, 1)
            obs_h[:, 0] = obs
            act_h = torch.roll(act_h, 1, 1)
            act_h[:, 0] = action.to(i32)
            rew_h = torch.roll(rew_h, 1, 1)
            rew_h[:, 0] = reward

            # candidate transitions: recency o originated at decision k-o.
            # Maturation emits only o = n-1 (done flag = done_next); a rollout
            # terminating now flushes o = 0..n-2 too, with shortened returns
            # (NStepAccumulator's flush-on-done).  Liveness is monotone, so a
            # rollout live at k was live at k-o and one mask covers the ring.
            flush = live & done_next
            ret = rew_h[:, :1] * gpow_t[0]
            for d in range(1, n):
                ret = ret + rew_h[:, d:d + 1] * gpow_t[d]
            v_flat = (torch.stack([flush, live])[which] & (lags <= k)[:, None]).reshape(n * B)
            s_flat = obs_h.transpose(0, 1).reshape(n * B, D)
            a_flat = act_h.t().reshape(n * B)
            r_flat = ret.t().reshape(n * B)
            rank = v_flat.cumsum(0, dtype=i32) - 1
            widx = torch.where(v_flat, torch.remainder(pos + rank, cap), cap).to(i64)  # cap = drop
            rs.index_copy_(0, widx, s_flat)
            ra.index_copy_(0, widx, a_flat)
            rr.index_copy_(0, widx, r_flat)
            rs2.index_copy_(0, widx, obs2.repeat(n, 1))
            rdone.index_copy_(0, widx, done_next.to(f32).repeat(n))
            rg.index_copy_(0, widx, g_flat)
            # the one synchronisation of the decision: the transitions emitted
            # (the replay's size gates and bounds the update) and the live count
            emitted, n_live = torch.stack([v_flat.sum(), live.sum()]).tolist()
            pos = (pos + emitted) % cap
            size = min(size + emitted, cap)

            # -- one TD update per decision (the host loop's cadence) --------
            if size >= min_buffer:
                idx = draws.sample(bs, size)
                params, opt_state, loss = td_update(
                    params, target, opt_state, rs[idx], ra[idx], rr[idx], rs2[idx], rdone[idx],
                    rg[idx])
                updates += 1
                if updates % sync_every == 0:
                    target = [(w.clone(), b.clone()) for w, b in params]
            else:
                loss = None
            gstep += n_live

            obs = obs2
            o_rew.append(reward)
            o_live.append(live)
            o_act.append(action)
            o_done.append(done_next)
            o_obs.append(obs2)
            o_loss.append(loss)
            o_eps.append(eps)

        ran = [x for x in o_loss if x is not None]
        ran = iter(torch.stack(ran).cpu().numpy().tolist() if ran else [])
        outs = {
            "reward": torch.stack(o_rew), "live": torch.stack(o_live),
            "action": torch.stack(o_act), "done": torch.stack(o_done),
            "obs": torch.stack(o_obs),
            "loss": np.asarray([np.nan if x is None else next(ran) for x in o_loss], np.float32),
            "eps": np.asarray(o_eps, np.float32),
        }
        replay = Replay(rs, ra, rr, rs2, rdone, rg, pos, size)
        return env, params, target, opt_state, replay, gstep, updates, outs

    return round_fn


# ------------------------------ the outer loop -----------------------------


def shard_rollouts(tree, mesh=None):
    """Place rollout-batched tensors across a 1-D ``rollout`` mesh.

    Leaves whose leading axis equals the batch size (that of the first leaf)
    become DTensors sharded on it (``Shard(0)``); everything else is left as
    it is. The mesh defaults to one over the ``torch.distributed`` world, on
    the first leaf's device type. The identity with one device (no process
    group, a world of 1, or a mesh of 1) or when the batch does not divide
    the device count, as the reference's.
    """
    flat = [leaf for _, leaf in flatten_with_paths(tree)]
    if not flat:
        return tree
    if mesh is None:
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return tree
        mesh = init_device_mesh(flat[0].device.type, (dist.get_world_size(),),
                                mesh_dim_names=("rollout",))
    n = mesh.size()
    B = int(flat[0].shape[0])
    if n <= 1 or B % n:
        return tree
    return unflatten(tree, [
        distribute_tensor(x, mesh, [Shard(0)])
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == B else x
        for x in flat])


def _batch_arrays(jobs: BatchedJobs, inv: np.ndarray, device: torch.device) -> tuple:
    """The round's per-rollout inputs on ``device``: arrival, deadline, rates,
    valid, dorder (int64) and the mean-duration coefficients."""

    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (on(jobs.arrival), on(jobs.deadline), on(jobs.rate_by_slots), on(jobs.valid),
            on(jobs.edf_order, torch.int64), on(inv))


def _round_inputs(
    tcfg: BatchedTrainConfig, rounds: int, seed: int, tables: DeviceTables
) -> Tuple[List[BatchedJobs], List[np.ndarray]]:
    """Every round's jobs and mean-duration coefficients (float32), generated up
    front: episode ``i`` draws seed ``seed * 100_003 + i``, scenario
    ``scenarios[i % len]`` and a uniform load scale from ``load_scale_range``;
    every round is padded to the largest episode of all rounds."""
    from repro_torch.core.scenarios import generate_scenario

    B = int(tcfg.batch)
    rng = np.random.default_rng(seed)
    skw = dict(tcfg.scenario_kwargs or {})
    episodes: List[List[Any]] = []
    for i in range(rounds * B):
        scen = tcfg.scenarios[i % len(tcfg.scenarios)]
        lo, hi = tcfg.load_scale_range
        kw = dict(skw)
        if (lo, hi) != (1.0, 1.0) or "load_scale" not in kw:
            scale = float(rng.uniform(lo, hi))
            kw.setdefault("load_scale", scale)
        episodes.append(
            generate_scenario(scen, seed=seed * 100_003 + i, **kw)
        )
    max_jobs = max((len(js) for js in episodes), default=1)

    round_jobs: List[BatchedJobs] = []
    round_inv: List[np.ndarray] = []
    for r in range(rounds):
        chunk = episodes[r * B:(r + 1) * B]
        jobs = BatchedJobs.from_job_lists(
            chunk, max_slots=tables.max_slots, min_jobs=max_jobs
        )
        round_jobs.append(jobs)
        round_inv.append(inv_mean_durations(chunk, jobs.arrival.shape, np.float32))
    return round_jobs, round_inv


def train_dqn_batched(
    num_episodes: int = 128,
    dqn_config: Optional[DQNConfig] = None,
    train_config: Optional[BatchedTrainConfig] = None,
    rewards: RewardWeights = RewardWeights(),
    seed: int = 0,
    verbose: bool = False,
    tables: Optional[DeviceTables] = None,
    device: DeviceLike = None,
) -> tuple:
    """Train the repartitioning DQN on ``device`` (default: the CUDA card);
    returns ``(learner, stats)``.

    Episodes are grouped into rounds of ``train_config.batch`` rollouts;
    episode ``i`` draws seed ``seed * 100_003 + i``, scenario
    ``scenarios[i % len]`` and a uniform load scale from
    ``load_scale_range``.  Every episode is generated up front and every
    round padded to one job-axis length.  The returned learner is a
    :class:`DQNLearner` holding the trained parameters, target network,
    optimizer state and update count (the replay is not carried over).
    """
    dev = resolve_device(device)
    tcfg = train_config or BatchedTrainConfig()
    B = int(tcfg.batch)
    rounds = max(1, -(-int(num_episodes) // B))
    cfg = dqn_config or DQNConfig(state_dim=FEATURE_DIM, seed=seed)
    if cfg.eps_decay_steps is None:
        # default the step schedule to the exploration budget of the host
        # schedule: eps_decay_episodes × the per-episode horizon
        cfg = dataclasses.replace(
            cfg,
            eps_decay_steps=cfg.eps_decay_episodes * tcfg.horizon_decisions,
        )
    if tables is None:
        tables = build_tables()
    consts = device_constants(tables, tcfg.repartition_mode, dev)

    lr = None
    if tcfg.lr_schedule == "cosine":
        from repro_torch.optim.schedule import cosine_schedule

        lr = cosine_schedule(
            cfg.lr, total_steps=rounds * tcfg.horizon_decisions,
            final_frac=0.1,
        )
    elif tcfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")

    round_jobs, round_inv = _round_inputs(tcfg, rounds, seed, tables)

    round_fn = _make_round_fn(cfg, tcfg, rewards, tables, consts, lr=lr, device=dev)

    # the learner's carry starts from DQNLearner, so host and batched
    # training start from the same network for a given DQNConfig
    learner = DQNLearner(cfg, dev)
    params, target = learner.params, learner.target
    opt_state = learner.opt_state
    replay = new_replay(tcfg.replay_capacity, cfg.state_dim, dev)
    gstep, updates = 0, 0
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed + 17)

    t_start = time.perf_counter()  # lint: waive[DT002] wall-seconds telemetry only
    ep_rewards: List[float] = []
    ep_proxy: List[float] = []
    all_losses: List[float] = []
    round_walls: List[float] = []
    round_steps: List[int] = []
    truncated = 0
    init_idx = np.full(
        (B,), tables.index_of(tcfg.initial_config), dtype=np.int32
    )
    for r in range(rounds):
        jobs = round_jobs[r]
        env0 = init_state(jobs, init_idx, dev)
        t_r = time.perf_counter()  # lint: waive[DT002] per-round wall telemetry only
        (env, params, target, opt_state, replay, gstep, updates, outs) = round_fn(
            env0, params, target, opt_state, replay, gstep, updates, generator,
            *_batch_arrays(jobs, round_inv[r], dev),
        )
        rew_hb = outs["reward"].cpu().numpy()  # (H, B)
        live_hb = outs["live"].cpu().numpy()
        loss_h = outs["loss"]
        round_walls.append(time.perf_counter() - t_r)  # lint: waive[DT002] wall telemetry only
        round_steps.append(int(live_hb.sum()))

        ep_rewards.extend(rew_hb.sum(axis=0).tolist())
        # ET proxy from the rollout accumulators, like the host loop's
        # per-episode `a * energy + avg_tardiness`
        for res in result_of(env, jobs, tables).to_sim_results():
            ep_proxy.append(rewards.a * res.energy_wh + res.avg_tardiness)
        all_losses.extend(loss_h[~np.isnan(loss_h)].tolist())
        truncated += int(live_hb[-1].sum())
        if verbose:  # pragma: no cover
            print(
                f"round {r + 1}/{rounds} episodes={B} "
                f"mean_reward={rew_hb.sum(axis=0).mean():.2f} "
                f"env_steps={gstep} updates={updates} "
                f"wall={round_walls[-1]:.1f}s",
                flush=True,
            )

    # install the trained state into the learner (same OptState type)
    learner.params = params
    learner.target = target
    learner.opt_state = opt_state
    learner.updates = updates

    wall = time.perf_counter() - t_start  # lint: waive[DT002] wall telemetry only
    stats = BatchedTrainStats(
        episode_rewards=ep_rewards,
        episode_et_proxy=ep_proxy,
        losses=all_losses,
        episodes=rounds * B,
        wall_seconds=wall,
        env_steps=gstep,
        env_steps_per_sec=gstep / wall if wall > 0 else 0.0,
        updates=updates,
        final_epsilon=float(epsilon_by_step(cfg, gstep)),
        rounds=rounds,
        batch=B,
        truncated_episodes=truncated,
        round_wall_seconds=round_walls,
        round_env_steps=round_steps,
    )
    return learner, stats
