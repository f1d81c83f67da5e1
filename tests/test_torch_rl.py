"""The port's repartitioning env, device observations, optimizer and DQN against the JAX package's.

The same inputs, made from numpy seeds, go through the reference
(``repro.core.batched.env``, ``repro.core.rl``, ``repro.optim``, jitted on the
CPU) and through the port with ``device="cpu"``:

* the host constants and :class:`RewardWeights` are equal;
* ``device_observations`` equals the reference's exactly on carried states,
  and the port env's host ``_obs`` as ``tests/test_batched_train.py`` holds it;
* the port's ``BatchedRepartitionEnv`` follows the reference env over a
  scripted action sequence: observations exact, rewards within 1e-6
  relative, flags exact, ``results()`` within ``tests/test_torch_sim.py``'s
  bars; the reference's trace of one scripted day is the ``env`` section of
  ``tests/data/torch_rl_golden.json``;
* ``AdamW`` and the schedules within 1e-6 (schedules equal), the double-DQN
  TD update within 1e-5 (DESIGN.md §11), ``epsilon_by_step`` equal, npz files
  read across, and the checked-in baseline's ``params_probe``.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_rl.py``.
The golden file is written by ``tests/test_torch_rl_train.py --write-golden``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batched as R
import repro_torch.core.batched as P
from repro.core.batched import backend as RB
from repro.core.batched.env import BatchedRepartitionEnv as RefEnv
from repro.core.rl import batched_train as RT
from repro.core.scenarios import generate_scenario as ref_scenario
from repro.core.rl import dqn as RD
from repro.core.rl import env as RE
from repro.optim import adamw as RA
from repro.optim import schedule as RS
from repro_torch.core.batched import backend as PB
from repro_torch.core.batched.env import BatchedRepartitionEnv as PortEnv
from repro_torch.core.rl import batched_train as PT
from repro_torch.core.rl import dqn as PD
from repro_torch.core.rl import env as PE
from repro_torch.models.convert import mlp_params_from_numpy, mlp_params_to_numpy
from repro_torch.optim import adamw as PA
from repro_torch.optim import schedule as PS
from torch_rl_golden import GOLDEN, he_params, scripted_actions

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"

# the port's env against the reference env: the same float32 step (whole
# rollouts agree with every integer exact, tests/test_torch_sim.py), so the
# observations' bins are exact.  The rewards are float64 differences of the
# float32 energy and tardiness accumulators, which sit up to one float32 ulp
# apart (tests/test_torch_sim.py measured energy at 1 ulp): 1e-6 relative, or
# the reward of 2 ulps of each accumulator at its largest (reward_atol).
REWARD_RTOL = 1e-6
# tests/test_torch_sim.py's bars for whole rollouts
ENERGY_BUSY_RTOL = 1e-5
TARD_RTOL, TARD_ATOL = 1e-4, 1e-3
MINUTES_ATOL = 1e-3
# the optimizer: the same float32 ops in the same order
ADAMW_TOL = 1e-6
# one TD update on an identical batch (DESIGN.md §11)
TD_TOL = 1e-5

# the scripted day of the golden file's env section
ENV_SCENARIO, ENV_LOAD, ENV_SEEDS, ENV_ACTION_SEED = "paper-diurnal", 0.3, tuple(range(40, 48)), 5
# obs values are i/9, i/11 or i/47: integers at this scale
OBS_CODE = 9 * 11 * 47


def obs_codes(obs: np.ndarray) -> list:
    return np.rint(np.asarray(obs, np.float64) * OBS_CODE).astype(np.int64).ravel().tolist()


def obs_digest(obs: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(obs, np.float32).tobytes()).hexdigest()


def jax_params(pairs):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs]


def reward_atol(energy_wh, tardiness_integral, w=RE.RewardWeights()) -> float:
    """The reward of 2 float32 ulps of each accumulator at its largest value."""
    ulp_e = float(np.spacing(np.float32(np.max(energy_wh))))
    ulp_t = float(np.spacing(np.float32(np.max(tardiness_integral))))
    return 2 * (w.a * ulp_e + ulp_t / w.tardiness_norm) / (w.a + 1.0) / w.scale


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)), initial=0.0))


# ----------------------------------------------------------------------
# host constants


def test_host_constants_and_reward_weights_are_equal():
    assert (PE.M_JOBS, PE.FEATURE_DIM) == (RE.M_JOBS, RE.FEATURE_DIM) == (8, 18)
    assert np.array_equal(PE._BIN_EDGES, RE._BIN_EDGES) and PE._BIN_EDGES.dtype == RE._BIN_EDGES.dtype
    assert (PE._NUM_BINS, PE._TIME_BINS) == (RE._NUM_BINS, RE._TIME_BINS)
    assert dataclasses.asdict(PE.RewardWeights()) == dataclasses.asdict(RE.RewardWeights())
    pw, rw = PE.RewardWeights(), RE.RewardWeights()
    for de, dt in [(0.0, 0.0), (41.25, 3.5), (1e4, 250.0), (-2.0, 0.125)]:
        assert pw.interval_reward(de, dt) == rw.interval_reward(de, dt)
    for n in (0, 1, 7, 600):
        assert pw.switch_penalty(n) == rw.switch_penalty(n)


# ----------------------------------------------------------------------
# device observations


def _ref_obs_inputs(scenario, seeds, load):
    tables = R.build_tables()
    lists = [ref_scenario(scenario, seed=s, load_scale=load) for s in seeds]
    jobs = R.BatchedJobs.from_job_lists(lists, max_slots=tables.max_slots)
    inv = np.zeros(jobs.arrival.shape, np.float32)
    for b, js in enumerate(lists):
        for j, job in enumerate(js):
            inv[b, j] = sum(1.0 / job.rate_on(float(k), True) for k in (1, 2, 3, 4, 7)) / 5
    return tables, jobs, inv


@pytest.mark.parametrize("scenario", ["paper-diurnal", "bursty-mmpp"])
def test_device_observations_match_the_reference_exactly(scenario):
    """Reference states at a few grid points of a repartitioning rollout,
    carried across: the port's features equal the reference's bit for bit,
    compiled as its round compiles them (XLA multiplies by the reciprocal of
    a constant divisor; evaluated op by op, the time-of-day and configuration
    columns could sit an ulp away)."""
    ref_obs = jax.jit(RT.device_observations)
    tables, jobs, inv = _ref_obs_inputs(scenario, (3, 4, 5, 6), 0.6)
    consts = RB.device_constants(tables, "partial")
    B = jobs.batch
    state = RB.init_state(jobs, np.full((B,), tables.index_of(2), np.int32))
    rng = np.random.default_rng(1)
    obs_t = PT.observation_tables(tables.config_ids, "cpu")
    t, seen = 0.0, 0
    for n_steps in (0, 240, 240, 240, 240, 240):  # one compiled chunk, up to 10:00
        if n_steps:
            pol = R.held_policy(rng.integers(0, 12, B).astype(np.int32), np.asarray(state.cfg))
            state = RB.run_steps(state, jobs, pol, consts, t0_min=t, n_steps=n_steps,
                                 penalty_min=tables.penalty_min)
            t += n_steps * RB.DEFAULT_DT_MIN
        ref = np.asarray(ref_obs(
            state, jnp.asarray(jobs.arrival), jnp.asarray(jobs.deadline), jnp.asarray(jobs.valid),
            jnp.asarray(jobs.edf_order), jnp.asarray(inv), jnp.asarray(tables.config_ids),
            jnp.float32(t)))
        pstate = PB.state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")
        port = PT.device_observations(
            pstate, torch.from_numpy(jobs.arrival), torch.from_numpy(jobs.deadline),
            torch.from_numpy(jobs.valid), torch.from_numpy(jobs.edf_order.astype(np.int64)),
            torch.from_numpy(inv), obs_t, np.float32(t)).numpy()
        assert port.dtype == np.float32 and port.shape == ref.shape == (B, 18)
        assert np.array_equal(port, ref), f"t={t}: {np.argwhere(port != ref)[:5]}"
        seen += int(((ref[:, 2::2] < 1.0) | (ref[:, 3::2] > 0.0)).sum())  # queued jobs featured
    assert seen > 0, "no state had a queued job"


def _port_obs_via_device(env):
    jobs = env._jobs
    return PT.device_observations(
        env._state, torch.from_numpy(jobs.arrival), torch.from_numpy(jobs.deadline),
        torch.from_numpy(jobs.valid), torch.from_numpy(jobs.edf_order.astype(np.int64)),
        torch.from_numpy(env._inv_mean_dur.astype(np.float32)),
        PT.observation_tables(env.tables.config_ids, "cpu"), np.float32(env._t)).numpy()


@pytest.mark.parametrize("scenario", ["paper-diurnal", "bursty-mmpp"])
def test_device_observations_match_the_envs_host_obs(scenario):
    """As tests/test_batched_train.py holds the reference: float32 bin inputs
    against the env's float64 ones may flip an exact-edge bin, so a 1 %
    mismatch budget; measured: zero mismatches."""
    env = PortEnv(scenario=scenario, scenario_kwargs={"load_scale": 0.3}, device="cpu")
    host = env.reset(seeds=(11, 12, 13))
    rng = np.random.default_rng(0)
    mism, total = 0, 0
    for _ in range(41):
        dev = _port_obs_via_device(env)
        assert dev.shape == host.shape == (3, 18)
        mism += int((np.abs(dev - host) > 1e-6).sum())
        total += dev.size
        if env.done:
            break
        host = env.step(rng.integers(0, 12, size=3))[0]
    assert total > 3 * 18
    assert mism / total <= 0.01
    assert mism == 0


def test_the_running_mask_ignores_padding_lanes():
    """Idle slices (-1) clip to job 0 but never mark it running: job 0, queued,
    stays in the features."""
    tables, jobs, inv = _ref_obs_inputs("paper-diurnal", (1,), 0.5)
    B, J = jobs.arrival.shape
    a0, a1 = float(jobs.arrival[0, 0]), float(jobs.arrival[0, 1])
    assert a1 > a0
    t = a0 + 0.5 * (a1 - a0)  # job 0 alone has arrived
    state = PB.init_state(P.BatchedJobs(**{f.name: getattr(jobs, f.name)
                                           for f in dataclasses.fields(jobs)}),
                          np.full((B,), 1, np.int32), "cpu")
    obs = PT.device_observations(
        state, torch.from_numpy(jobs.arrival), torch.from_numpy(jobs.deadline),
        torch.from_numpy(jobs.valid), torch.from_numpy(jobs.edf_order.astype(np.int64)),
        torch.from_numpy(inv), PT.observation_tables(tables.config_ids, "cpu"), np.float32(t))
    assert (state.slice_job == -1).all()
    assert obs[0, 2].item() < 1.0, "job 0 is queued and must be featured"
    running = state.slice_job.clone()
    running[0, 0] = 0  # job 0 on slice 0: now it is running, not queued
    obs2 = PT.device_observations(
        state._replace(slice_job=running), torch.from_numpy(jobs.arrival),
        torch.from_numpy(jobs.deadline), torch.from_numpy(jobs.valid),
        torch.from_numpy(jobs.edf_order.astype(np.int64)), torch.from_numpy(inv),
        PT.observation_tables(tables.config_ids, "cpu"), np.float32(t))
    assert obs2[0, 2].item() == 1.0 and obs2[0, 3].item() == 0.0  # no other job is queued


# ----------------------------------------------------------------------
# the env


def run_env(make_env, seeds, scenario, load, max_decisions=200):
    """Drive an env over the scripted actions to the end: the trace of it."""
    env = make_env(scenario=scenario, scenario_kwargs={"load_scale": load})
    obs = [env.reset(seeds=seeds)]
    acts = scripted_actions(max_decisions, len(seeds), ENV_ACTION_SEED)
    rewards, term, trunc = [], [], []
    k = 0
    while not env.done:
        o, r, te, tr, _ = env.step(acts[k])
        obs.append(o)
        rewards.append(np.asarray(r, np.float64))
        term.append(te)
        trunc.append(tr)
        k += 1
        assert k < max_decisions, "the scripted day did not end"
    return {"obs": np.stack(obs), "rewards": np.stack(rewards), "terminated": np.stack(term),
            "truncated": np.stack(trunc), "results": env.results(), "actions": acts[:k],
            "atol": reward_atol(_np(env._state.energy_wh), _np(env._state.tardiness_integral))}


RESULT_FIELDS = ("energy_wh", "avg_tardiness", "total_tardiness", "max_tardiness",
                 "deadline_misses", "busy_slot_minutes", "preemptions", "repartitions", "num_jobs")


def result_row(r) -> dict:
    """One ``SimResult`` as the golden file keeps it (its ``extra`` flattened)."""
    return {**{f: getattr(r, f) for f in RESULT_FIELDS}, **dict(r.extra)}


def assert_results_agree(port, ref, label=""):
    for p, r in zip(port, ref, strict=True):
        assert (p.preemptions, p.repartitions, p.num_jobs) == (r.preemptions, r.repartitions,
                                                               r.num_jobs), label
        assert p.energy_wh == pytest.approx(r.energy_wh, rel=ENERGY_BUSY_RTOL), label
        assert p.busy_slot_minutes == pytest.approx(r.busy_slot_minutes, rel=ENERGY_BUSY_RTOL), label
        assert p.avg_tardiness == pytest.approx(r.avg_tardiness, rel=TARD_RTOL, abs=TARD_ATOL), label
        assert p.deadline_misses == r.deadline_misses, label
        assert p.extra["makespan_min"] == pytest.approx(r.extra["makespan_min"], abs=MINUTES_ATOL), label


def golden_env() -> dict:
    """The reference env's trace of the scripted day (the golden file's env section)."""
    tr = run_env(RefEnv, ENV_SEEDS, ENV_SCENARIO, ENV_LOAD)
    return {
        "scenario": ENV_SCENARIO, "load_scale": ENV_LOAD, "seeds": list(ENV_SEEDS),
        "action_seed": ENV_ACTION_SEED, "decisions": int(tr["rewards"].shape[0]),
        "obs_code_scale": OBS_CODE, "obs_codes": obs_codes(tr["obs"]),
        "obs_sha256": obs_digest(tr["obs"]),
        "rewards": tr["rewards"].ravel().tolist(),
        "terminated": tr["terminated"].astype(int).ravel().tolist(),
        "truncated": tr["truncated"].astype(int).ravel().tolist(),
        "results": [result_row(r) for r in tr["results"]],
    }


@pytest.fixture(scope="module")
def scripted_day():
    return {
        "ref": run_env(RefEnv, ENV_SEEDS, ENV_SCENARIO, ENV_LOAD),
        "port": run_env(lambda **kw: PortEnv(device="cpu", **kw), ENV_SEEDS, ENV_SCENARIO,
                        ENV_LOAD),
    }


def test_env_follows_the_reference_env_through_a_scripted_day(scripted_day):
    ref, port = scripted_day["ref"], scripted_day["port"]
    assert port["obs"].shape == ref["obs"].shape and port["obs"].dtype == np.float32
    assert np.array_equal(port["obs"], ref["obs"]), np.argwhere(port["obs"] != ref["obs"])[:5]
    np.testing.assert_allclose(port["rewards"], ref["rewards"], rtol=REWARD_RTOL, atol=ref["atol"])
    assert np.array_equal(port["terminated"], ref["terminated"])
    assert np.array_equal(port["truncated"], ref["truncated"])
    assert ref["terminated"][-1].all() and not ref["terminated"][0].any()
    assert_results_agree(port["results"], ref["results"])
    assert len(set(ref["actions"].ravel().tolist())) == 12  # every config was chosen


@pytest.mark.parametrize("scenario,mode", [("bursty-mmpp", "partial"), ("paper-diurnal", "drain")])
def test_env_follows_the_reference_env_with_truncation(scenario, mode):
    """A shorter run with ``max_decisions`` truncating it, in both repartition modes."""
    kw = dict(scenario=scenario, scenario_kwargs={"load_scale": 0.4}, repartition_mode=mode,
              max_decisions=20)
    ref, port = RefEnv(**kw), PortEnv(device="cpu", **kw)
    ro, po = ref.reset(seeds=(2, 9)), port.reset(seeds=(2, 9))
    assert np.array_equal(po, ro)
    acts = scripted_actions(20, 2, 8)
    for k in range(20):
        ro, rr, rte, rtr, rinfo = ref.step(acts[k])
        po, pr, pte, ptr, pinfo = port.step(acts[k])
        assert np.array_equal(po, ro), k
        atol = reward_atol(np.asarray(ref._state.energy_wh), np.asarray(ref._state.tardiness_integral))
        np.testing.assert_allclose(pr, rr, rtol=REWARD_RTOL, atol=atol)
        assert np.array_equal(pte, rte) and np.array_equal(ptr, rtr)
        for key in ("switched", "config_id", "queue_depth"):
            assert np.array_equal(pinfo[key], rinfo[key]), key
        assert (pinfo["t"], pinfo["decisions"]) == (rinfo["t"], rinfo["decisions"])
    assert port.done and ref.done and ptr.all()


def test_golden_file_env_section_is_what_the_reference_gives(scripted_day):
    golden = json.loads(GOLDEN.read_text())["env"]
    ref = scripted_day["ref"]
    assert (golden["scenario"], golden["load_scale"], tuple(golden["seeds"])) == (
        ENV_SCENARIO, ENV_LOAD, ENV_SEEDS)
    assert golden["decisions"] == ref["rewards"].shape[0]
    assert golden["obs_codes"] == obs_codes(ref["obs"])
    assert golden["obs_sha256"] == obs_digest(ref["obs"])
    np.testing.assert_allclose(ref["rewards"].ravel(), golden["rewards"], rtol=1e-9)
    assert golden["terminated"] == ref["terminated"].astype(int).ravel().tolist()
    assert golden["truncated"] == ref["truncated"].astype(int).ravel().tolist()
    for g, r in zip(golden["results"], ref["results"], strict=True):
        got = result_row(r)
        assert sorted(got) == sorted(g)
        for f, v in g.items():
            assert got[f] == pytest.approx(v, rel=1e-6), f


def test_env_keeps_the_reference_checks_and_messages():
    with pytest.raises(ValueError, match="batched env supports only EDF-FS"):
        PortEnv(scheduler_name="EDF-SS", device="cpu")
    with pytest.raises(ValueError, match="must be a positive multiple of dt_min"):
        PortEnv(decision_interval_min=0.7, device="cpu")
    env = PortEnv(scenario="paper-diurnal", scenario_kwargs={"load_scale": 0.2}, device="cpu")
    with pytest.raises(RuntimeError, match=r"call reset\(\) first"):
        env.step([0])
    with pytest.raises(RuntimeError, match="no episode has run"):
        env.results()
    env.reset(seeds=(0, 1))
    with pytest.raises(ValueError, match=r"actions shape \(3,\) != \(2,\)"):
        env.step([0, 0, 0])
    with pytest.raises(ValueError, match=r"actions must be in \[0, 11\]"):
        env.step([0, 12])
    env = PortEnv(scenario="paper-diurnal", scenario_kwargs={"load_scale": 0.2}, max_decisions=1,
                  device="cpu")
    env.reset(seeds=(0,))
    env.step([1])
    assert env.done
    with pytest.raises(RuntimeError, match=r"all episodes over; call reset\(\)"):
        env.step([1])


def test_env_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortEnv()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.DQNLearner(PD.DQNConfig(state_dim=18))


# ----------------------------------------------------------------------
# the optimizer


ADAMW_CASES = [
    dict(grad_clip_norm=None, weight_decay=0.0),
    dict(grad_clip_norm=1.0, weight_decay=0.0),
    dict(grad_clip_norm=None, weight_decay=0.1),
    dict(grad_clip_norm=0.5, weight_decay=0.1),
    dict(grad_clip_norm=1.0, weight_decay=0.1, state_dtype="bfloat16"),
    dict(grad_clip_norm=None, weight_decay=0.0, b2=0.999, lr="warmup_cosine"),
]


@pytest.mark.parametrize("case", ADAMW_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_adamw_matches_the_reference_over_five_steps(case):
    case = dict(case)
    if case.get("lr") == "warmup_cosine":
        case["lr"] = (RS.linear_warmup_cosine(1e-2, 2, 6), PS.linear_warmup_cosine(1e-2, 2, 6))
    else:
        case["lr"] = (1e-2, 1e-2)
    rlr, plr = case.pop("lr")
    ropt = RA.AdamW(RA.AdamWConfig(lr=rlr, **case))
    popt = PA.AdamW(PA.AdamWConfig(lr=plr, **case))
    rng = np.random.default_rng(3)
    shapes = [(8, 5), (5,), (2, 3, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    rp, pp = [jnp.asarray(p) for p in params], [torch.from_numpy(p.copy()) for p in params]
    rs, ps = ropt.init(rp), popt.init(pp)
    for step in range(5):
        grads = [(rng.standard_normal(s) * 10 ** (step - 2)).astype(np.float32) for s in shapes]
        rp, rs = ropt.update([jnp.asarray(g) for g in grads], rs, rp)
        pp, ps = popt.update([torch.from_numpy(g) for g in grads], ps, pp)
        for a, b in zip(rp, pp, strict=True):
            assert max_diff(a, b.numpy()) <= ADAMW_TOL, step
        for name in ("m", "v"):
            for a, b in zip(getattr(rs, name), getattr(ps, name), strict=True):
                assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
                assert max_diff(np.asarray(a, np.float32), b.float().numpy()) <= ADAMW_TOL
        assert int(ps.step) == int(rs.step) == step + 1
    assert ps.step.dtype == torch.int32


@pytest.mark.parametrize("base,make", [
    (3e-4, lambda S: S.cosine_schedule(3e-4, 100)),
    (1.0, lambda S: S.cosine_schedule(1.0, 7, final_frac=0.0)),
    (5e-4, lambda S: S.linear_warmup_cosine(5e-4, 10, 200)),
], ids=["cosine", "cosine-to-zero", "warmup-cosine"])
def test_schedules_match_the_reference(base, make):
    """Over 300 steps, equal but where the two libraries' cosines round apart:
    measured 0-5 steps of 300 at one float32 ulp of ``base``; bar 2 ulps."""
    ref, port = make(RS), make(PS)
    got = np.asarray([port(torch.tensor(s, dtype=torch.int32)).item() for s in range(300)], np.float32)
    want = np.asarray([np.float32(ref(jnp.int32(s))) for s in range(300)])
    assert port(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    assert max_diff(got, want) <= 2 * np.spacing(np.float32(base))
    assert (got == want).mean() >= 0.98


def test_adamw_update_is_pure():
    opt = PA.AdamW(PA.AdamWConfig())
    p = [torch.ones(3, 2)]
    s = opt.init(p)
    new_p, new_s = opt.update([torch.ones(3, 2)], s, p)
    assert torch.equal(p[0], torch.ones(3, 2)) and int(s.step) == 0 and torch.equal(s.m[0], torch.zeros(3, 2))
    assert not torch.equal(new_p[0], p[0]) and int(new_s.step) == 1
    with pytest.raises(ValueError, match="differ in length"):
        opt.update([torch.ones(3, 2)] * 2, s, p)


# ----------------------------------------------------------------------
# the DQN


def _cfg(**kw):
    kw.setdefault("state_dim", 18)
    kw.setdefault("seed", 0)
    return (RD.DQNConfig(**kw), PD.DQNConfig(**kw))


def td_batch(bs, d, A, gamma, n, seed):
    """A seeded replay batch: states in [0, 1], rewards ~ N(0, 1), 10 % done."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(bs, d)).astype(np.float32), rng.integers(0, A, bs).astype(np.int32),
            rng.normal(size=bs).astype(np.float32), rng.uniform(size=(bs, d)).astype(np.float32),
            (rng.uniform(size=bs) < 0.1).astype(np.float32),
            np.full((bs,), gamma ** n, np.float32))


def test_dqn_config_defaults_are_equal():
    r, p = _cfg()
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert dataclasses.asdict(RD.DQNConfig()) == dataclasses.asdict(PD.DQNConfig())


@pytest.mark.parametrize("n_updates", [1, 3])
def test_td_update_matches_the_reference(n_updates):
    """Parameters, Adam's moments and the loss after ``n_updates`` chained
    updates on identical batches, from identical parameters and target."""
    rcfg, pcfg = _cfg(min_buffer=1)
    sizes = (18, 256, 256, 12)
    params, target = he_params(sizes, 1), he_params(sizes, 2)
    ropt, rupd = RD.make_td_update(rcfg)
    popt, pupd = PD.make_td_update(pcfg)
    rp, rt = jax_params(params), jax_params(target)
    pp, pt = mlp_params_from_numpy(params, "cpu"), mlp_params_from_numpy(target, "cpu")
    rs, ps = ropt.init(rp), popt.init([t for wb in pp for t in wb])
    rupd = jax.jit(rupd)
    for i in range(n_updates):
        batch = td_batch(128, 18, 12, rcfg.gamma, rcfg.n_step, 10 + i)
        rp, rs, rloss = rupd(rp, rt, rs, *map(jnp.asarray, batch))
        pp, ps, ploss = pupd(pp, pt, ps, *map(torch.from_numpy, batch))
        assert abs(float(rloss) - float(ploss)) <= TD_TOL
    for (rw, rb), (pw, pb) in zip(rp, mlp_params_to_numpy(pp), strict=True):
        assert max_diff(rw, pw) <= TD_TOL and max_diff(rb, pb) <= TD_TOL
    for a, b in zip(jax.tree_util.tree_leaves(rs.m), ps.m, strict=True):
        assert max_diff(a, b.numpy()) <= TD_TOL
    assert int(ps.step) == n_updates


def test_td_update_leaves_its_inputs_and_takes_no_gradient_through_the_target():
    _, pcfg = _cfg()
    sizes = (18, 32, 12)
    pp = mlp_params_from_numpy(he_params(sizes, 4), "cpu")
    before = [t.clone() for wb in pp for t in wb]
    opt, upd = PD.make_td_update(pcfg)
    st = opt.init([t for wb in pp for t in wb])
    batch = [torch.from_numpy(x) for x in td_batch(16, 18, 12, 0.99, 8, 5)]
    new, _, loss = upd(pp, pp, st, *batch)
    assert all(torch.equal(a, b) for a, b in zip(before, [t for wb in pp for t in wb]))
    assert not loss.requires_grad and all(not t.requires_grad for wb in new for t in wb)
    assert not any(torch.equal(a, b) for a, b in zip(before[::2], [w for w, _ in new]))


def test_epsilon_by_step_is_equal():
    for decay in (None, 1, 500, 100_000):
        rcfg, pcfg = _cfg(eps_decay_steps=decay)
        for s in (0, 1, 7, 63, 64, 499, 500, 501, 12_345, 99_999, 100_000, 3_000_000):
            want = np.float32(RD.epsilon_by_step(rcfg, s))
            got = PD.epsilon_by_step(pcfg, s)
            assert got.dtype == np.float32 and got == want, (decay, s)


def test_greedy_argmax_takes_the_first_of_tied_maxima():
    q = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    assert q.argmax(1).tolist() == np.asarray(jnp.argmax(jnp.asarray(q.numpy()), axis=1)).tolist() == [1, 0]


def test_npz_written_by_either_package_is_read_by_the_other(tmp_path):
    rcfg, pcfg = _cfg(seed=5)
    ref, port = RD.DQNLearner(rcfg), PD.DQNLearner(pcfg, device="cpu")
    ref.save(str(tmp_path / "ref.npz"))
    port.load(str(tmp_path / "ref.npz"))
    for (rw, rb), (pw, pb) in zip(ref.params, mlp_params_to_numpy(port.params), strict=True):
        assert np.array_equal(np.asarray(rw), pw) and np.array_equal(np.asarray(rb), pb)
    for (tw, _), (pw, _) in zip(port.target, port.params):
        assert torch.equal(tw, pw) and tw.data_ptr() != pw.data_ptr()
    port2 = PD.DQNLearner(dataclasses.replace(pcfg, seed=9), device="cpu")
    port2.save(str(tmp_path / "port.npz"))
    ref.load(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "port.npz") as data:
        assert sorted(data.files) == ["b0", "b1", "b2", "n_layers", "w0", "w1", "w2"]
        assert int(data["n_layers"]) == 3 and data["w1"].dtype == np.float32
    obs = np.random.default_rng(0).uniform(size=(20, 18)).astype(np.float32)
    assert [ref.greedy_action(o) for o in obs] == [port2.greedy_action(o) for o in obs]
    np.testing.assert_allclose(ref.q(obs[0]), port2.q(obs[0]), rtol=1e-5, atol=1e-6)


def test_mlp_params_carry_checks_shapes():
    good = he_params((18, 8, 12), 0)
    assert [w.shape for w, _ in mlp_params_from_numpy(good, "cpu")] == [(18, 8), (8, 12)]
    with pytest.raises(ValueError, match="not an"):
        mlp_params_from_numpy([(good[0][0], good[1][1])], "cpu")
    with pytest.raises(ValueError, match="takes 12 inputs"):
        mlp_params_from_numpy([good[0], (np.zeros((12, 3), np.float32), np.zeros(3, np.float32))], "cpu")


def test_params_probe_of_the_checked_in_baseline():
    """The pin of tests/test_batched_train.py, on the port: the checked-in
    parameters give the recorded greedy actions (16 × action 6)."""
    entry = json.loads((BASELINES / "rl_batched.json").read_text())
    probe = entry["params_probe"]
    learner = PD.DQNLearner(PD.DQNConfig(state_dim=18), device="cpu")
    learner.load(str(BASELINES / "rl_dqn_params.npz"))
    rng = np.random.default_rng(probe["seed"])
    obs = rng.uniform(0.0, 1.0, size=(len(probe["actions"]), 18))
    acts = [learner.greedy_action(o.astype(np.float32)) for o in obs]
    assert acts == probe["actions"] == [6] * 16


def test_host_learner_maybe_train_matches_the_reference():
    """The host learner's replay, sampler and update: identical buffers, the
    same numpy seed, injected parameters -> the same parameters after 4
    updates (with a target sync at 3), within the TD bar."""
    rcfg, pcfg = _cfg(min_buffer=32, batch_size=16, target_sync_every=3, seed=4)
    ref, port = RD.DQNLearner(rcfg), PD.DQNLearner(pcfg, device="cpu")
    port.params = mlp_params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in ref.params], "cpu")
    port.target = [(w.clone(), b.clone()) for w, b in port.params]
    rng = np.random.default_rng(2)
    assert np.isnan(port.maybe_train()) and np.isnan(ref.maybe_train())
    for _ in range(40):
        tr = (rng.uniform(size=18).astype(np.float32), int(rng.integers(0, 12)), float(rng.normal()),
              rng.uniform(size=18).astype(np.float32), bool(rng.uniform() < 0.1))
        ref.observe(*tr)
        port.observe(*tr)
    rl, pl = ref.maybe_train(steps=4), port.maybe_train(steps=4)
    assert ref.updates == port.updates == 4
    assert abs(rl - pl) <= TD_TOL
    for (rw, _), (pw, _) in zip(ref.target, mlp_params_to_numpy(port.target), strict=True):
        assert max_diff(rw, pw) <= TD_TOL
    for (rw, _), (pw, _) in zip(ref.params, mlp_params_to_numpy(port.params), strict=True):
        assert max_diff(rw, pw) <= TD_TOL
    assert port.act(np.zeros(18, np.float32), 0.0) == ref.act(np.zeros(18, np.float32), 0.0)
    assert port.epsilon(75) == ref.epsilon(75)
