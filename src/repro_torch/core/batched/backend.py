"""Fixed-timestep batched MIG rollouts in torch: one batched step, looped over time.

The throughput backend of the simulator: many independent rollouts advance
lock-step on a ``dt_min`` time grid, every per-rollout quantity a tensor with
the batch on its first axis.  The step is written as batched torch ops (no
``vmap``, no compiler): each op covers all ``B`` rollouts at once.  A host
loop runs the step ``chunk_steps`` times and, after each chunk, checks on the
host whether every rollout has passed its stop time.

Per step (the phases of the reference ``repro.core.batched.backend``, in its
order):

1. an elapsed repartition completes (survivors remapped via the
   ``old_to_new`` table, pending config installed);
2. the compiled policy may start a repartition — jobs on non-surviving
   slices are preempted, the §IV-D-3 stall timer starts;
3. EDF-FS reassigns eligible jobs to fastest-first slices (frozen while a
   repartition is in flight), preemptions counted by diffing assignments;
4. the step advances ``dt``: work depletes, completions land at their exact
   sub-step time, tardiness accrues (with refunds for mid-step completions),
   and freed capacity is handed to the next waiting job in the same step;
5. a rollout whose jobs are all done gets its stop time (for DayNight, the
   one boundary timer the event-driven oracle still fires);
6. energy, busy slot-minutes and the utilization histogram integrate over
   the accounted span.

Numerics are float32 throughout, with the reference's rounding: every scalar
that the reference forms in float32 (``t``, ``t + eps``, ``t + dt``) is formed
here in numpy float32 on the host and enters the ops as an exact float32
value, and the reference's Python-float sums (``dt + eps``) are rounded once.

Where torch and JAX differ, the step says so beside the op:

* JAX clamps out-of-range gather indices; torch raises on the CPU and hits a
  device-side assert on the card.  Every gather below takes an index the
  reference clips (``sjc``, ``blkc``, the clipped ranks and lanes), so no
  index relies on clamping.
* JAX's ``.at[idx].set(..., mode="drop")`` drops writes to the sentinel
  index.  Here the target gets one extra sentinel column, the scatter writes
  there, and the column is sliced off (:func:`_set_drop`).
* ``torch.cumsum`` of int32 returns int64 unless told otherwise, and
  ``torch.searchsorted`` needs its sequence and values in one dtype.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.batched.policies import BatchedPolicy
from repro_torch.core.batched.state import BatchedJobs, BatchedResult
from repro_torch.core.batched.tables import DeviceTables, build_tables
from repro_torch.core.simulator import REPARTITION_MODES, REPARTITION_PENALTY_MIN
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "DEFAULT_DT_MIN",
    "DEFAULT_CHUNK_STEPS",
    "RolloutState",
    "device_constants",
    "init_state",
    "make_step_fn",
    "run_steps",
    "simulate_batch",
    "result_of",
    "state_from_numpy",
    "state_to_numpy",
]

#: default time-grid resolution (minutes). Must divide 60 so the DayNight
#: boundaries (multiples of 60 min) land exactly on grid points.
DEFAULT_DT_MIN = 0.5

#: steps per chunk; the host checks the rollouts' stop times after each.
DEFAULT_CHUNK_STEPS = 512

_DAY = 24 * 60.0
# float32 grid: time comparisons tolerate ~1e-6 min, work ~1e-6 1g-minutes
_T_EPS = 1e-6
_W_EPS = 1e-6
#: job-axis block size for the two-level EDF rank search; J must be a
#: multiple of this (BatchedJobs pads to PAD_MULTIPLE == _BLOCK).
_BLOCK = 32

_F32 = np.float32
_INF = float("inf")


class RolloutState(NamedTuple):
    """Every mutable per-rollout quantity, batch-leading, on one device.

    ``cfg``/``pending`` are dense config indices (``pending != cfg`` means a
    repartition is in flight); ``stop_time`` is ``+inf`` until the rollout's
    accounting endpoint is known.  Float fields are float32, the others int32.
    """

    remaining: torch.Tensor  # (B, J) f32 work left
    completion: torch.Tensor  # (B, J) f32, +inf until completed
    slice_job: torch.Tensor  # (B, S) i32 job index running on each slice, -1 = idle
    cfg: torch.Tensor  # (B,) i32 dense config index
    pending: torch.Tensor  # (B,) i32 repartition target (== cfg when idle)
    stall_left: torch.Tensor  # (B,) f32 minutes of stall remaining
    stop_time: torch.Tensor  # (B,) f32 accounting endpoint, +inf while running
    energy_wh: torch.Tensor  # (B,) f32
    tardiness_integral: torch.Tensor  # (B,) f32
    busy_slot_minutes: torch.Tensor  # (B,) f32
    preemptions: torch.Tensor  # (B,) i32
    repartitions: torch.Tensor  # (B,) i32
    util_hist: torch.Tensor  # (B, K) f32 minutes at each integer busy level


_INT_FIELDS = frozenset({"slice_job", "cfg", "pending", "preemptions", "repartitions"})


def state_from_numpy(fields: Mapping[str, Any], device: DeviceLike = None) -> RolloutState:
    """A :class:`RolloutState` on ``device`` from numpy arrays keyed by field name.

    Takes the reference's carry as numpy (``{k: np.asarray(v) for k, v in
    ref_state._asdict().items()}``), so one mid-rollout state can be stepped
    by both packages.  The arrays are copied.
    """
    dev = resolve_device(device)
    out = {}
    for name in RolloutState._fields:
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        out[name] = torch.from_numpy(np.array(fields[name], dtype=dtype)).to(dev)
    return RolloutState(**out)


def state_to_numpy(state: RolloutState) -> Dict[str, np.ndarray]:
    """``state`` as numpy arrays keyed by field name (float32 and int32)."""
    return {name: getattr(state, name).cpu().numpy() for name in RolloutState._fields}


def device_constants(
    tables: DeviceTables, repartition_mode: str = "partial", device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """The tables one ``simulate_batch`` run needs, as tensors on ``device``.

    Drain mode degenerates the survivor table to all-(−1): every slice is
    destroyed on any switch, exactly the legacy full-drain model.  Index
    tables are int64 (torch's index type); ``ranks`` and ``lanes`` are the
    step's constant index vectors.
    """
    if repartition_mode not in REPARTITION_MODES:
        raise ValueError(
            f"unknown repartition_mode {repartition_mode!r}; valid: "
            f"{REPARTITION_MODES}"
        )
    dev = resolve_device(device)
    o2n = tables.old_to_new
    if repartition_mode == "drain":
        o2n = np.full_like(o2n, -1)
    S = tables.max_slices

    def idx(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)

    return {
        "slice_slots": idx(tables.slice_slots),
        "slice_rank": idx(tables.slice_rank),
        "num_slices": idx(tables.num_slices),
        "old_to_new": idx(o2n),
        "watts": torch.tensor(np.asarray(tables.watts_by_busy), dtype=torch.float32, device=dev),
        "ranks": torch.arange(1, 2 * S + 1, dtype=torch.int32, device=dev),
        "lanes": torch.arange(S, dtype=torch.int64, device=dev),
    }


def init_state(jobs: BatchedJobs, initial_idx: np.ndarray, device: DeviceLike = None) -> RolloutState:
    """Fresh state at ``t = 0`` with per-rollout initial config indices.

    Rollouts with no jobs (or only zero-work jobs) are already finished:
    their ``stop_time`` is 0 and zero-work jobs complete at their arrival.
    """
    B, J = jobs.arrival.shape
    K = jobs.rate_by_slots.shape[2]
    S = K - 1  # DeviceTables pads slices to max_slots
    zero_work = jobs.valid & (jobs.work <= _W_EPS)
    completion0 = np.where(zero_work, jobs.arrival, np.inf).astype(np.float32)
    has_work = (jobs.valid & (jobs.work > _W_EPS)).any(axis=1)
    stop0 = np.where(has_work, np.inf, 0.0).astype(np.float32)
    init = np.asarray(initial_idx, dtype=np.int32)
    if init.shape != (B,):
        raise ValueError(f"initial_idx shape {init.shape} != ({B},)")
    zeros_b = np.zeros((B,), np.float32)
    return state_from_numpy({
        "remaining": jobs.work,
        "completion": completion0,
        "slice_job": np.full((B, S), -1, np.int32),
        "cfg": init,
        "pending": init,
        "stall_left": zeros_b,
        "stop_time": stop0,
        "energy_wh": zeros_b,
        "tardiness_integral": zeros_b,
        "busy_slot_minutes": zeros_b,
        "preemptions": np.zeros((B,), np.int32),
        "repartitions": np.zeros((B,), np.int32),
        "util_hist": np.zeros((B, K), np.float32),
    }, device)


def _set_drop(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``base[:, :-1]`` after ``base[b, idx[b, i]] = src[b, i]``, writes to the last column dropped.

    ``base`` carries one sentinel column past the ``N`` live ones; indices equal
    to ``N`` stand for the reference's ``mode="drop"`` writes.  Only sentinel
    writes may collide: each caller's live indices are injective (distinct
    survivor slots, distinct ranks, disjoint running and handoff jobs), so the
    order in which the scatter applies colliding writes never shows.
    """
    return base.scatter_(1, idx, src)[:, :-1]


def _first_hit(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true element along the last axis, 0 where there is none.

    ``jnp.argmax`` over a bool mask; torch's ``argmax`` takes no bool, so it runs
    over an int8 cast. Both return the first maximum.
    """
    return mask.to(torch.int8).argmax(-1)


def _step_time(t0_min: float, i: int, dt_min: float) -> np.float32:
    """The step's time as the reference forms it: ``f32(t0) + f32(i) * f32(dt)``.

    Formed in float32, never in float64 and then cast: DayNight boundaries and
    repartition counts could move otherwise.
    """
    return _F32(t0_min) + _F32(i) * _F32(dt_min)


def _time_of_day(t: np.float32) -> np.float32:
    """``jnp.mod(t, _DAY)`` for ``t >= 0``: a float32 ``fmod``, which is exact."""
    return np.fmod(_F32(t), _F32(_DAY))


@functools.lru_cache(maxsize=None)
def make_step_fn(kind: str, dt: float, penalty: float, day_start: float, day_end: float):
    """Build (and cache) the batched step for one policy kind.

    Returns ``step(state, t, arrival, deadline, rates, valid, dorder, primary,
    secondary, consts) -> state`` over all ``B`` rollouts: ``t`` is the step's
    time, a float32 scalar shared by every rollout (:func:`_step_time`);
    ``arrival``/``deadline`` (B, J) f32, ``rates`` (B, J, K) f32, ``valid``
    (B, J) bool, ``dorder`` (B, J) int64, ``primary``/``secondary`` (B,) int64;
    ``consts`` from :func:`device_constants`.  This is the single source of the
    step's semantics; the input state is not modified.
    """
    dt32 = float(_F32(dt))
    fin_thr = float(_F32(dt + _T_EPS))  # the reference adds Python floats, then rounds once
    pen32 = float(_F32(penalty))
    i64 = torch.int64
    i32 = torch.int32

    def step(state, t, arrival, deadline, rates, valid, dorder, primary, secondary, consts):
        # every per-job quantity is (B, J); everything about the <= S running
        # jobs lives in (B, S) lanes keyed by slice index (``sj``), so the only
        # O(J) work per step is a handful of elementwise ops, one gather by
        # the static EDF order and one reduction per block of _BLOCK jobs
        (remaining, completion, slice_job, cfg, pending, stall_left,
         stop_time, energy, tard, busy_min, pre, rep, hist) = state
        t32 = _F32(t)
        t_ = float(t32)
        t_eps = float(t32 + _F32(_T_EPS))
        t_dt = float(t32 + _F32(dt))
        B, J = remaining.shape
        slice_slots = consts["slice_slots"]
        S = slice_slots.shape[1]
        watts = consts["watts"]
        max_slots = watts.shape[0] - 1
        o2n = consts["old_to_new"]
        sj, cfg, pending = slice_job.to(i64), cfg.to(i64), pending.to(i64)
        dev = remaining.device

        # -- 1. an elapsed repartition completes ------------------------
        in_flight = pending != cfg
        finish = in_flight & (stall_left <= _T_EPS)
        surv = o2n[cfg, pending]  # (B, S) old -> new survivor indices
        keep = finish[:, None] & (sj >= 0) & (surv >= 0)
        remapped = _set_drop(torch.full((B, S + 1), -1, dtype=i64, device=dev),
                             torch.where(keep, surv, S), torch.where(keep, sj, -1))
        sj = torch.where(finish[:, None], remapped, sj)
        cfg = torch.where(finish, pending, cfg)

        # -- 2. policy decision (never mid-flight, never past stop) -----
        in_flight = pending != cfg
        if kind == "daynight":
            tod = _time_of_day(t32)
            is_day = bool((tod >= _F32(day_start)) & (tod < _F32(day_end)))
            target = primary if is_day else secondary
        else:
            target = primary
        want = (~in_flight) & (stop_time + _T_EPS >= t_) & (target != cfg)
        surv_t = o2n[cfg, target]  # (B, S)
        kill = want[:, None] & (sj >= 0) & (surv_t < 0)
        pre = pre + kill.sum(1, dtype=i32)
        sj = sj.masked_fill(kill, -1)
        pending = torch.where(want, target, pending)
        stall_left = stall_left.masked_fill(want, pen32)
        rep = rep + want.to(i32)
        in_flight = pending != cfg

        # -- 3. EDF-FS reassignment (frozen while repartitioning) -------
        # the first 2S in-system jobs in EDF order: permute the in-system mask
        # by the static deadline order, then find the first 2S set bits with
        # a two-level rank search — per-block popcounts, a cumsum over
        # blocks, and an intra-block scan of only the <= 2S hit blocks
        insys = (arrival <= t_eps) & (remaining > _W_EPS) & valid
        m = insys.gather(1, dorder)
        NB = J // _BLOCK
        mb = m.view(B, NB, _BLOCK)
        # int32 throughout: cumsum would widen to int64 unasked, and
        # searchsorted needs sequence and values in one dtype
        bc = mb.sum(2, dtype=i32).cumsum(1, dtype=i32)  # (B, NB)
        ranks = consts["ranks"]  # (2S,) i32: 1 .. 2S
        # first block with cum >= rank (torch's default side is jnp's 'left');
        # NB where there are fewer in-system jobs than ranks
        blk = torch.searchsorted(bc, ranks.expand(B, -1).contiguous())
        blkc = blk.clamp(0, NB - 1)
        prev = torch.where(blk > 0, bc.gather(1, (blk - 1).clamp(min=0)), 0)
        sub = mb.gather(1, blkc[:, :, None].expand(B, 2 * S, _BLOCK))  # (B, 2S, BLOCK)
        sc = sub.cumsum(2, dtype=i32)
        need = (ranks - prev)[:, :, None]
        off = _first_hit(sub & (sc == need))
        pos = blkc * _BLOCK + off
        cand = torch.where(blk < NB, dorder.gather(1, pos), J)  # (B, 2S), J = none
        ranked = consts["slice_rank"][cfg]  # (B, S) slice ids fastest-first, -1 padded
        rv = (ranked >= 0) & (cand[:, :S] < J)
        proposed = _set_drop(torch.full((B, S + 1), -1, dtype=i64, device=dev),
                             torch.where(rv, ranked, S), torch.where(rv, cand[:, :S], -1))
        new_sj = torch.where(in_flight[:, None], sj, proposed)
        moved = (sj >= 0) & (new_sj != sj) & (~in_flight[:, None])
        pre = pre + moved.sum(1, dtype=i32)
        sj = new_sj

        # -- 4. advance dt ----------------------------------------------
        rates_flat = rates.reshape(B, -1)
        K = rates.shape[2]
        run = sj >= 0
        sjc = sj.clamp(0, J - 1)
        slots_of = slice_slots[cfg]  # (B, S)
        slot_s = torch.where(run, slots_of, 0)
        rem_s = remaining.gather(1, sjc)
        rate_s = rates_flat.gather(1, sjc * K + slot_s)
        fin = torch.where(run & (rate_s > 0), rem_s / rate_s.clamp(min=1e-12), _INF)
        run_time = torch.where(run, fin.clamp(max=dt32), 0.0)
        done = run & (fin <= fin_thr)
        comp_t = fin + t_
        new_rem_s = torch.where(done, 0.0, (rem_s - rate_s * dt32).clamp(min=0.0))
        # (B, J)-wide writes are deferred and merged with the handoff's into one
        # scatter per tensor
        busy_minutes = (slot_s * run_time).sum(1)

        # tardiness: each in-system job accrues the overlap of the step with
        # [deadline, inf); jobs completing mid-step get the overshoot past
        # their exact completion refunded
        tard = tard + torch.where(insys, (t_dt - deadline.clamp(min=t_)).clamp(min=0.0), 0.0).sum(1)
        base_s = deadline.gather(1, sjc).clamp(min=t_)
        over = torch.where(done, (t_dt - base_s).clamp(min=0.0) - (comp_t - base_s).clamp(min=0.0),
                           0.0)
        tard = tard - over.sum(1)
        held = sj  # lane -> job ids before done lanes are cleared
        sj = sj.masked_fill(done, -1)

        # -- 4b. same-step handoff of freed capacity --------------------
        # one round per step (no cascading): the r-th freed slice
        # (fastest-first) runs the r-th waiting job (EDF-first: candidates
        # num_slices.. of the buffer built above)
        leftover = torch.where(done & (~in_flight[:, None]), dt32 - run_time, 0.0)
        nsl = consts["num_slices"][cfg]  # (B,)
        fr = torch.where(ranked >= 0, leftover.gather(1, ranked.clamp(0, S - 1)), 0.0)
        has = fr > _T_EPS
        hpos = torch.where(has, has.cumsum(1) - 1, S)
        fslice = _set_drop(torch.full((B, S + 1), -1, dtype=i64, device=dev),
                           hpos, torch.where(has, ranked, -1))
        fgive = _set_drop(torch.zeros((B, S + 1), dtype=torch.float32, device=dev),
                          hpos, torch.where(has, fr, 0.0))
        wjob = cand.gather(1, (nsl[:, None] + consts["lanes"]).clamp(0, 2 * S - 1))
        wok = (fslice >= 0) & (wjob < J)
        wjc = wjob.clamp(0, J - 1)
        w_rem = remaining.gather(1, wjc)  # they were waiting: untouched by phase 4
        slot_w = slots_of.gather(1, fslice.clamp(0, S - 1))
        rate_w = rates_flat.gather(1, wjc * K + torch.where(wok, slot_w, 0))
        fin_w = torch.where(wok & (rate_w > 0), w_rem / rate_w.clamp(min=1e-12), _INF)
        h_done = wok & (fin_w <= fgive + _T_EPS)
        tc = (t_dt - fgive) + fin_w
        new_wrem = torch.where(h_done, 0.0, (w_rem - rate_w * fgive).clamp(min=0.0))
        # merged write-back: running jobs and handoff jobs touch disjoint
        # index sets, so one (B, 2S) scatter per tensor suffices
        rem_idx = torch.cat([torch.where(run, held, J), torch.where(wok, wjob, J)], 1)
        remaining = _set_drop(F.pad(remaining, (0, 1)), rem_idx, torch.cat([new_rem_s, new_wrem], 1))
        comp_idx = torch.cat([torch.where(done, held, J), torch.where(h_done, wjob, J)], 1)
        completion = _set_drop(F.pad(completion, (0, 1)), comp_idx, torch.cat([comp_t, tc], 1))
        busy_minutes = busy_minutes + torch.where(wok, slot_w * torch.minimum(fin_w, fgive), 0.0).sum(1)
        # it accrued tardiness as waiting-to-step-end; completing at tc
        # refunds the overshoot
        base_w = deadline.gather(1, wjc).clamp(min=t_)
        refund = (t_dt - base_w).clamp(min=0.0) - (tc - base_w).clamp(min=0.0)
        tard = tard - torch.where(h_done, refund, 0.0).sum(1)

        # -- rollout end detection --------------------------------------
        all_done = ~(valid & (remaining > _W_EPS)).any(1)
        finishes = all_done & (~torch.isfinite(stop_time))
        e = torch.maximum(torch.where(done, comp_t, -_INF).amax(1),
                          torch.where(h_done, tc, -_INF).amax(1)).clamp(min=t_)
        if kind == "daynight":
            # the oracle still fires the one pending boundary timer after
            # the last completion (idle until the boundary, then switches)
            base = torch.floor(e / _DAY) * _DAY
            cands = torch.stack([base + day_start, base + day_end,
                                 base + _DAY + day_start, base + _DAY + day_end], 1)
            end_stop = torch.where(cands > (e + _T_EPS)[:, None], cands, _INF).amin(1)
        else:
            end_stop = e
        stop_time = torch.where(finishes, end_stop, stop_time)

        # -- 5. energy / busy / histogram over the accounted span -------
        span = (stop_time.clamp(max=t_dt) - t_).clamp(0.0, dt32)
        busy_min = busy_min + busy_minutes
        avg_busy = torch.where(span > _T_EPS, busy_minutes / span.clamp(min=_T_EPS), 0.0)
        lo = avg_busy.floor().to(i64).clamp(0, max_slots)
        hi = (lo + 1).clamp(0, max_slots)
        frac = (avg_busy - lo.to(torch.float32)).clamp(0.0, 1.0)
        watts_now = watts[lo] * (1.0 - frac) + watts[hi] * frac
        energy = energy + watts_now * span / 60.0
        level = slot_s.sum(1).clamp(0, max_slots)
        hist = hist.scatter_add(1, level[:, None], span[:, None])  # hist.at[level].add(span)

        stall_left = (stall_left - dt32).clamp(min=0.0)
        return RolloutState(
            remaining, completion, sj.to(i32), cfg.to(i32), pending.to(i32), stall_left,
            stop_time, energy, tard, busy_min, pre, rep, hist,
        )

    return step


def _step_inputs(jobs: BatchedJobs, policy: BatchedPolicy, device: torch.device) -> tuple:
    """The step's per-rollout inputs on ``device``: arrival, deadline, rates,
    valid, dorder, primary, secondary (indices as int64)."""

    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (on(jobs.arrival), on(jobs.deadline), on(jobs.rate_by_slots), on(jobs.valid),
            on(jobs.edf_order, torch.int64), on(policy.primary, torch.int64),
            on(policy.secondary, torch.int64))


@torch.inference_mode()
def run_steps(
    state: RolloutState,
    jobs: BatchedJobs,
    policy: BatchedPolicy,
    consts: Dict[str, torch.Tensor],
    *,
    t0_min: float,
    n_steps: int,
    dt_min: float = DEFAULT_DT_MIN,
    penalty_min: Optional[float] = None,
) -> RolloutState:
    """Advance every rollout ``n_steps`` grid steps from ``t0_min``, on ``state``'s device.

    Runs under ``torch.inference_mode`` (the state is never differentiated),
    which takes about a tenth off the host's cost of each op.
    """
    if penalty_min is None:
        penalty_min = REPARTITION_PENALTY_MIN
    if jobs.padded_jobs % _BLOCK != 0:
        raise ValueError(
            f"padded job axis {jobs.padded_jobs} must be a multiple of "
            f"{_BLOCK} (use BatchedJobs.from_job_lists, which pads to it)"
        )
    step = make_step_fn(
        policy.kind, float(dt_min), float(penalty_min),
        float(policy.day_start), float(policy.day_end),
    )
    inputs = _step_inputs(jobs, policy, state.remaining.device)
    for i in range(int(n_steps)):
        state = step(state, _step_time(t0_min, i, dt_min), *inputs, consts)
    return state


def result_of(
    state: RolloutState, jobs: BatchedJobs, tables: DeviceTables
) -> BatchedResult:
    """Materialize a finished state into a host-side :class:`BatchedResult`."""
    s = state_to_numpy(state)
    return BatchedResult(
        energy_wh=s["energy_wh"].astype(np.float64),
        tardiness_integral=s["tardiness_integral"].astype(np.float64),
        busy_slot_minutes=s["busy_slot_minutes"].astype(np.float64),
        preemptions=s["preemptions"].astype(np.int64),
        repartitions=s["repartitions"].astype(np.int64),
        completion=s["completion"].astype(np.float64),
        deadline=np.asarray(jobs.deadline, dtype=np.float64),
        valid=np.asarray(jobs.valid),
        num_jobs=np.asarray(jobs.num_jobs, dtype=np.int64),
        makespan_min=s["stop_time"].astype(np.float64),
        util_histogram=s["util_hist"].astype(np.float64),
    )


def _horizon_bound(jobs: BatchedJobs) -> float:
    """A conservative makespan bound: serial 1g execution + two day cycles.

    Every job depletes at rate >= 1 on a 1-slot slice and EDF-FS always runs
    the queue head, so total work past the last arrival bounds the busy tail;
    the slack covers the DayNight post-drain boundary wait.
    """
    arr = np.where(jobs.valid, jobs.arrival, 0.0)
    work = np.where(jobs.valid, jobs.work, 0.0)
    per = arr.max(axis=1, initial=0.0) + work.sum(axis=1)
    return float(per.max(initial=0.0) + 2 * _DAY + 10.0)


def simulate_batch(
    jobs: BatchedJobs,
    policy: BatchedPolicy,
    *,
    tables: Optional[DeviceTables] = None,
    repartition_mode: str = "partial",
    dt_min: float = DEFAULT_DT_MIN,
    chunk_steps: int = DEFAULT_CHUNK_STEPS,
    max_minutes: Optional[float] = None,
    device: DeviceLike = None,
) -> BatchedResult:
    """Run every rollout to completion on ``device`` (default: the CUDA card).

    ``dt_min`` must divide 60 (so DayNight boundaries are grid points);
    ``max_minutes`` overrides the livelock guard (default: a conservative
    serial-execution bound).  The CPU runs only when asked (``device="cpu"``).
    """
    if tables is None:
        tables = build_tables()
    if abs(round(60.0 / dt_min) * dt_min - 60.0) > 1e-9:
        raise ValueError(f"dt_min={dt_min} must divide 60 minutes")
    if policy.batch != jobs.batch:
        raise ValueError(
            f"policy compiled for batch {policy.batch}, jobs batch {jobs.batch}"
        )
    if jobs.rate_by_slots.shape[2] != tables.max_slots + 1:
        raise ValueError("jobs rate table was built for a different device")
    dev = resolve_device(device)
    consts = device_constants(tables, repartition_mode, dev)
    state = init_state(jobs, policy.initial, dev)
    bound = _horizon_bound(jobs) if max_minutes is None else float(max_minutes)

    steps_done = 0
    while True:
        state = run_steps(
            state, jobs, policy, consts,
            t0_min=steps_done * dt_min, n_steps=chunk_steps, dt_min=dt_min,
            penalty_min=tables.penalty_min,
        )
        steps_done += chunk_steps
        t_now = steps_done * dt_min
        stop = state.stop_time.cpu().numpy()
        if np.all(stop < t_now):
            break
        if t_now > bound:
            raise RuntimeError(
                f"batched rollout still live at t={t_now:.0f} min "
                f"(bound {bound:.0f}); unfinished rollouts: "
                f"{int(np.sum(~(stop < t_now)))}"
            )
    return result_of(state, jobs, tables)
