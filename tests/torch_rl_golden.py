"""The inputs of ``tests/data/torch_rl_golden.json`` and the port's runs of them.

The golden file holds what the JAX package gives on these inputs (written by
``tests/test_torch_rl_train.py --write-golden``).  This module builds the same
inputs and runs the port on them, and imports nothing of JAX, so the CPU
tests, the card tests and ``chip_smoke.py`` (on a machine without JAX) share
one copy:

* the round: B 4, H 16, n-step 3 with learning on, He-normal parameters from a
  numpy seed, its draws injected (the reference's ``jax.random`` key chain in
  the CPU tests, the golden file's recording of it on the card);
* the TD update at the baseline's width from the checked-in parameters on a
  seeded batch;
* the env's scripted action sequence;
* the digest that stands for a parameter tensor in the golden file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_rl_golden.json"
RL_PARAMS = ROOT / "benchmarks" / "baselines" / "rl_dqn_params.npz"

ROUND = dict(batch=4, horizon=16, n_step=3, min_buffer=8, batch_size=8, eps_decay_steps=40,
             replay_capacity=32, target_sync_every=4, key_seed=5, params_seed=21,
             scenarios=("paper-diurnal", "bursty-mmpp"), load_scale=1.0, job_seeds=(70, 71, 72, 73))
TD = dict(batch_seed=11, batch_size=128)
SIZES = (18, 256, 256, 12)
# a strided sample of each parameter tensor stands for it in the golden file
DIGEST_SAMPLES = 256


def he_params(sizes, seed):
    """He-normal ``(w, b)`` numpy pairs (float32) from a numpy seed, biases small."""
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
             (0.01 * rng.standard_normal(b)).astype(np.float32))
            for a, b in zip(sizes[:-1], sizes[1:])]


def td_batch(bs, gamma, n, seed):
    """A seeded replay batch: bins-like states in [0, 1], rewards ~ N(0, 0.3), 10 % done."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(bs, 18)).astype(np.float32), rng.integers(0, 12, bs).astype(np.int32),
            (0.3 * rng.normal(size=bs)).astype(np.float32), rng.uniform(size=(bs, 18)).astype(np.float32),
            (rng.uniform(size=bs) < 0.1).astype(np.float32), np.full((bs,), gamma ** n, np.float32))


def scripted_actions(n_decisions, B, seed):
    """A fixed action script: mostly holds, with switches among all 12 configs."""
    rng = np.random.default_rng(seed)
    acts = np.empty((n_decisions, B), np.int64)
    cur = np.full(B, 1)
    for k in range(n_decisions):
        switch = rng.uniform(size=B) < 0.3
        cur = np.where(switch, rng.integers(0, 12, size=B), cur)
        acts[k] = cur
    return acts


def digest(pairs) -> list:
    """Per tensor: its float64 sum and a strided sample of its elements."""
    out = []
    for t in (x for wb in pairs for x in wb):
        flat = np.asarray(t, np.float32).ravel()
        stride = max(1, flat.size // DIGEST_SAMPLES)
        out.append({"sum": float(flat.astype(np.float64).sum()), "stride": stride,
                    "sample": flat[::stride].tolist()})
    return out


def digest_diff(a: list, b: list) -> float:
    """The largest difference of two digests: each sum relative to max(1, |sum|),
    and the samples' elements."""
    return max(max(abs(x["sum"] - y["sum"]) / max(1.0, abs(y["sum"])),
                   float(np.max(np.abs(np.subtract(x["sample"], y["sample"])), initial=0.0)))
               for x, y in zip(a, b, strict=True))


def round_config_kwargs(r=ROUND):
    """``(DQNConfig kwargs, BatchedTrainConfig kwargs)`` of the round, for either package."""
    kw = dict(state_dim=18, n_step=r["n_step"], min_buffer=r["min_buffer"],
              batch_size=r["batch_size"], eps_decay_steps=r["eps_decay_steps"],
              target_sync_every=r["target_sync_every"], seed=0)
    tkw = dict(batch=r["batch"], horizon_decisions=r["horizon"],
               replay_capacity=r["replay_capacity"])
    return kw, tkw


def round_jobs(r=ROUND):
    """The round's job streams (scenarios round-robin), padded, and their
    mean-duration coefficients (float32)."""
    import repro_torch.core.batched as P
    from repro_torch.core.rl.env import inv_mean_durations
    from repro_torch.core.scenarios import generate_scenario

    lists = [generate_scenario(r["scenarios"][i % len(r["scenarios"])], seed=s, load_scale=r["load_scale"])
             for i, s in enumerate(r["job_seeds"])]
    jobs = P.BatchedJobs.from_job_lists(lists, max_slots=P.build_tables().max_slots)
    return jobs, inv_mean_durations(lists, jobs.arrival.shape, np.float32)


def port_round(draws, r=ROUND, device="cpu") -> dict:
    """The port's round on ``device`` with ``draws`` injected: its outputs as numpy."""
    import repro_torch.core.batched as P
    from repro_torch.core.batched import backend as PB
    from repro_torch.core.rl import batched_train as PT
    from repro_torch.core.rl import dqn as PD
    from repro_torch.core.rl.env import RewardWeights
    from repro_torch.device import resolve_device
    from repro_torch.models.convert import mlp_params_from_numpy, mlp_params_to_numpy

    dev = resolve_device(device)
    kw, tkw = round_config_kwargs(r)
    cfg = PD.DQNConfig(**kw)
    tables = P.build_tables()
    round_fn = PT._make_round_fn(cfg, PT.BatchedTrainConfig(**tkw), RewardWeights(), tables,
                                 PB.device_constants(tables, "partial", dev), device=dev)
    jobs, inv = round_jobs(r)
    params = mlp_params_from_numpy(he_params(SIZES, r["params_seed"]), dev)
    target = [(w.clone(), b.clone()) for w, b in params]
    opt_state = PD.make_optimizer(cfg).init([t for wb in params for t in wb])
    env0 = PB.init_state(jobs, np.full((r["batch"],), tables.index_of(2), np.int32), dev)
    (env, params, target, opt_state, replay, gstep, updates, outs) = round_fn(
        env0, params, target, opt_state, PT.new_replay(r["replay_capacity"], 18, dev), 0, 0, None,
        *PT._batch_arrays(jobs, inv, dev), _draws=draws)
    cap = replay.capacity
    return {
        "reward": outs["reward"].cpu().numpy(), "live": outs["live"].cpu().numpy(),
        "loss": outs["loss"], "eps": outs["eps"], "action": outs["action"].cpu().numpy(),
        "replay": {k: getattr(replay, k)[:cap].cpu().numpy() for k in ("s", "a", "r", "s2", "done", "g")},
        "pos": replay.pos, "size": replay.size, "gstep": gstep, "updates": updates,
        "cfg": env.cfg.cpu().numpy(), "repartitions": env.repartitions.cpu().numpy(),
        "energy_wh": env.energy_wh.cpu().numpy(),
        "params": mlp_params_to_numpy(params), "target": mlp_params_to_numpy(target),
    }


def golden_draws(g: dict, device="cpu"):
    """The golden round's recorded draws, replayed on ``device``."""
    from repro_torch.core.rl import batched_train as PT

    return PT._RecordedDraws(g["draws"]["u"], g["draws"]["randa"], g["draws"]["idx"], device)


def port_td_update(device="cpu", td=TD):
    """One TD update at the baseline's configuration from the checked-in
    parameters (target = parameters, fresh Adam) on the seeded batch, on
    ``device``: ``(loss, parameters as numpy pairs)``."""
    from repro_torch.core.rl import dqn as PD
    from repro_torch.launch.train_rl import dqn_config
    from repro_torch.models.convert import mlp_params_to_numpy

    cfg = dqn_config()
    learner = PD.DQNLearner(cfg, device=device)
    learner.load(str(RL_PARAMS))
    batch = td_batch(td["batch_size"], cfg.gamma, cfg.n_step, td["batch_seed"])
    _, update = PD.make_td_update(cfg)
    params, _, loss = update(learner.params, learner.target, learner.opt_state,
                             *(torch.from_numpy(x).to(learner.device) for x in batch))
    return float(loss), mlp_params_to_numpy(params)
