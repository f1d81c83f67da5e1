"""The port's on-device DQN trainer (``repro_torch.core.rl.batched_train``) against the JAX package's.

* A round at B 4, H 16, n-step 3 with learning on (``min_buffer`` 8, batch 8,
  a 32-row replay that wraps, a target sync every 4 updates), its draws
  replayed from the reference's ``jax.random`` key chain (``split(key, 4)`` a
  decision), against the reference's jitted ``_make_round_fn``: every integer
  exact (live masks, the replay's actions, ``pos`` and ``size``, the update
  and env-step counts, the rollouts' configurations and repartitions), the
  rewards and the replay's floats within 1e-6, the losses and parameters
  within the bar measured below.
* The n-step accounting on a drained round: one transition a live decision,
  and the same transitions as the reference's ``NStepAccumulator`` fed the
  port's own trace.
* ``train_dqn_batched``'s outer loop beside the reference's: the episodes
  drawn, the one padded job axis, and the stats filled from the same round
  outputs and final carry (the ET proxies too); a run with consistent stats,
  the entry point ``python -m repro_torch.launch.train_rl``, and the round's
  checks.
* ``tests/data/torch_rl_golden.json``: its ``td_update`` and ``round``
  sections are what the reference gives today (``chip_smoke.py`` holds the
  card to them).

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_rl_train.py``.
The round's inputs and the port's run of them are ``tests/torch_rl_golden.py``'s
(JAX-free; ``chip_smoke.py`` and the card tests use them too).  Rewrite the
golden file (where JAX is):
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rl_train.py --write-golden``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batched as R
import repro_torch.core.batched as P
from repro.core.batched import backend as RB
from repro.core.rl import batched_train as RT
from repro.core.rl import dqn as RD
from repro.core.rl.agent import NStepAccumulator
from repro.core.rl.env import RewardWeights as RefRewards
from repro.core.scenarios import generate_scenario as ref_scenario
from repro_torch.core.batched import backend as PB
from repro_torch.core.rl import batched_train as PT
from repro_torch.core.rl import dqn as PD
from repro_torch.core.rl.env import RewardWeights, inv_mean_durations
from repro_torch.launch import train_rl
from repro_torch.models.convert import mlp_params_to_numpy
from torch_rl_golden import (GOLDEN, ROUND, SIZES, TD, digest, digest_diff, he_params, port_round,
                             port_td_update, round_config_kwargs, td_batch)

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"

# the round: rewards are float32 sums of the same physics (whose accumulators
# agree to an ulp, tests/test_torch_sim.py); replay floats are copies of them
ROUND_FLOAT_TOL = 1e-6
# the learner inside the round: 13 chained TD updates whose matmuls sum in
# another order than XLA's; measured max |Δ| 6.0e-8 (parameters and target),
# 4.8e-7 (losses); the bar is DESIGN.md §11's one-update bar
ROUND_PARAM_TOL = 1e-5
# one TD update on an identical batch (DESIGN.md §11)
TD_TOL = 1e-5
# the golden file against the reference recomputed (another CPU may sum in
# another order in the last bits)
GOLDEN_TOL = 1e-6

def max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)), initial=0.0))


class JaxKeyDraws:
    """The reference round's draws, from its key chain: each decision splits
    ``key`` into (key, exploration, random action, replay sample)."""

    def __init__(self, key_seed: int) -> None:
        self.key = jax.random.PRNGKey(key_seed)
        self.k_samp = None
        self.log = {"u": [], "randa": [], "idx": []}

    def act(self, B, A):
        self.key, k_expl, k_act, self.k_samp = jax.random.split(self.key, 4)
        u = np.asarray(jax.random.uniform(k_expl, (B,)))
        randa = np.asarray(jax.random.randint(k_act, (B,), 0, A, dtype=jnp.int32))
        self.log["u"].append(u.tolist())
        self.log["randa"].append(randa.tolist())
        return torch.from_numpy(np.array(u)), torch.from_numpy(randa.astype(np.int64))

    def sample(self, bs, size):
        idx = np.asarray(jax.random.randint(self.k_samp, (bs,), 0, jnp.maximum(jnp.int32(size), 1)))
        self.log["idx"].append(idx.tolist())
        return torch.from_numpy(idx.astype(np.int64))


def round_jobs(r=ROUND):
    """The round's job streams from the reference's generator, padded, and
    their mean-duration coefficients (float32)."""
    lists = [ref_scenario(r["scenarios"][i % len(r["scenarios"])], seed=s, load_scale=r["load_scale"])
             for i, s in enumerate(r["job_seeds"])]
    jobs = R.BatchedJobs.from_job_lists(lists, max_slots=R.build_tables().max_slots)
    return jobs, inv_mean_durations(lists, jobs.arrival.shape, np.float32)


def reference_round(r=ROUND):
    """The reference's round from injected parameters: its outputs as numpy."""
    kw, tkw = round_config_kwargs(r)
    rcfg, rtcfg = RD.DQNConfig(**kw), RT.BatchedTrainConfig(**tkw)
    tables = R.build_tables()
    consts = RB.device_constants(tables, "partial")
    round_fn = RT._make_round_fn(rcfg, rtcfg, RefRewards(), tables, consts)
    jobs, inv = round_jobs(r)
    params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in he_params(SIZES, r["params_seed"])]
    target = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = RD.make_optimizer(rcfg).init(params)
    cap, D = r["replay_capacity"], 18
    replay = (jnp.zeros((cap, D)), jnp.zeros((cap,), jnp.int32), jnp.zeros((cap,)),
              jnp.zeros((cap, D)), jnp.zeros((cap,)), jnp.zeros((cap,)),
              jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    env0 = RB.init_state(jobs, np.full((r["batch"],), tables.index_of(2), np.int32))
    arrays = tuple(jnp.asarray(a) for a in (jobs.arrival, jobs.deadline, jobs.rate_by_slots,
                                            jobs.valid, jobs.edf_order, inv))
    (env, params, target, opt_state, replay, gstep, updates, _key, outs) = round_fn(
        env0, params, target, opt_state, replay, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
        jax.random.PRNGKey(r["key_seed"]), *arrays)
    rs, ra, rr, rs2, rdone, rg, pos, size = (np.asarray(x) for x in replay)
    return {
        "reward": np.asarray(outs[0]), "live": np.asarray(outs[1]), "loss": np.asarray(outs[2]),
        "eps": np.asarray(outs[3]), "replay": {"s": rs, "a": ra, "r": rr, "s2": rs2, "done": rdone,
                                               "g": rg},
        "pos": int(pos), "size": int(size), "gstep": int(gstep), "updates": int(updates),
        "cfg": np.asarray(env.cfg), "repartitions": np.asarray(env.repartitions),
        "energy_wh": np.asarray(env.energy_wh),
        "params": [(np.asarray(w), np.asarray(b)) for w, b in params],
        "target": [(np.asarray(w), np.asarray(b)) for w, b in target],
    }


@pytest.fixture(scope="module")
def rounds():
    draws = JaxKeyDraws(ROUND["key_seed"])
    return {"ref": reference_round(), "port": port_round(draws), "draws": draws.log}


ROUND_INTS = ("pos", "size", "gstep", "updates")


def test_round_integers_are_exact(rounds):
    ref, port = rounds["ref"], rounds["port"]
    for k in ROUND_INTS:
        assert port[k] == ref[k], k
    assert np.array_equal(port["live"], ref["live"])
    assert np.array_equal(port["replay"]["a"], ref["replay"]["a"])
    assert np.array_equal(port["cfg"], ref["cfg"]) and np.array_equal(port["repartitions"],
                                                                       ref["repartitions"])
    assert np.array_equal(np.isnan(port["loss"]), np.isnan(ref["loss"]))
    # the round did what it is for: the ring wrapped, updates ran and synced
    # the target, both random and greedy actions were taken and switched
    assert ref["size"] == ROUND["replay_capacity"] and ref["updates"] >= 2 * ROUND["target_sync_every"]
    assert ref["eps"][0] == 1.0 and ref["eps"][-1] < 0.1 and ref["repartitions"].sum() > 4
    # compiled, the reference fuses epsilon's multiply-add (a few ulps)
    assert max_diff(port["eps"], ref["eps"]) <= ROUND_FLOAT_TOL


def test_round_floats_hold_their_bars(rounds):
    ref, port = rounds["ref"], rounds["port"]
    assert max_diff(port["reward"], ref["reward"]) <= ROUND_FLOAT_TOL
    for k in ("s", "r", "s2", "done", "g"):
        assert max_diff(port["replay"][k], ref["replay"][k]) <= ROUND_FLOAT_TOL, k
    assert np.array_equal(port["replay"]["s"], ref["replay"]["s"])  # observations are bins
    ran = ~np.isnan(ref["loss"])
    assert max_diff(port["loss"][ran], ref["loss"][ran]) <= ROUND_PARAM_TOL
    for key in ("params", "target"):
        for (rw, rb), (pw, pb) in zip(ref[key], port[key], strict=True):
            assert max_diff(pw, rw) <= ROUND_PARAM_TOL and max_diff(pb, rb) <= ROUND_PARAM_TOL, key
    np.testing.assert_allclose(port["energy_wh"], ref["energy_wh"], rtol=1e-6)


def test_recorded_draws_replay_the_round(rounds):
    """What the card runs: the golden file's recorded draws, replayed, give the
    same round as the key chain (here on the CPU)."""
    log = rounds["draws"]
    again = port_round(PT._RecordedDraws(log["u"], log["randa"], log["idx"], "cpu"))
    port = rounds["port"]
    for k in ROUND_INTS:
        assert again[k] == port[k]
    assert np.array_equal(again["replay"]["a"], port["replay"]["a"])
    for (a, _), (b, _) in zip(again["params"], port["params"]):
        assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# n-step accounting


class _Collect:
    def __init__(self):
        self.rows = []

    def observe(self, s, a, r, s2, done, g):
        self.rows.append((np.asarray(s), int(a), float(r), np.asarray(s2), bool(done), float(g)))


def test_nstep_accounting_matches_the_accumulator():
    """A drained round with no training: every live decision emits exactly one
    transition, and the replay holds, in its own order, what
    ``NStepAccumulator`` emits when fed the round's trace rollout by rollout."""
    n, B, H = 4, 3, 120
    kw, tkw = round_config_kwargs(dict(ROUND, n_step=n, min_buffer=10_000_000, batch=B, horizon=H,
                                       replay_capacity=16_384))
    pcfg, ptcfg = PD.DQNConfig(**kw), PT.BatchedTrainConfig(**tkw)
    tables = P.build_tables()
    lists = [ref_scenario("paper-diurnal", seed=s, load_scale=0.2) for s in (1, 2, 3)]
    jobs = P.BatchedJobs.from_job_lists(lists, max_slots=tables.max_slots)
    inv = inv_mean_durations(lists, jobs.arrival.shape, np.float32)
    round_fn = PT._make_round_fn(pcfg, ptcfg, RewardWeights(), tables,
                                 PB.device_constants(tables, "partial", "cpu"), device="cpu")
    learner = PD.DQNLearner(pcfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    (env, _p, _t, _o, replay, gstep, updates, outs) = round_fn(
        PB.init_state(jobs, np.full((B,), tables.index_of(2), np.int32), "cpu"), learner.params,
        learner.target, learner.opt_state, PT.new_replay(16_384, 18, "cpu"), 0, 0, gen,
        *PT._batch_arrays(jobs, inv, torch.device("cpu")))
    live, done = outs["live"].numpy(), outs["done"].numpy()
    obs, act, rew = outs["obs"].numpy(), outs["action"].numpy(), outs["reward"].numpy()
    assert not live[-1].any(), "episodes must drain inside the horizon"
    assert replay.size == gstep == int(live.sum()) and updates == 0
    assert np.isnan(outs["loss"]).all()

    emitted = {}
    for b in range(B):
        acc, sink = NStepAccumulator(n, pcfg.gamma), _Collect()
        for k in range(H):
            if not live[k, b]:
                break
            acc.push(sink, obs[k, b], act[k, b], float(rew[k, b]), obs[k + 1, b], bool(done[k, b]))
        emitted[b] = sink.rows  # drained: the i-th emission originated at decision i
        assert len(sink.rows) == int(live[:, b].sum())

    row = 0
    for k in range(H):
        for o in range(n):
            for b in range(B):
                ok = live[k, b] and k >= o and (o == n - 1 or done[k, b])
                if not ok:
                    continue
                s, a, r, s2, d, g = emitted[b][k - o]
                assert np.array_equal(replay.s[row].numpy(), s) and int(replay.a[row]) == a
                assert np.array_equal(replay.s2[row].numpy(), s2)
                assert float(replay.done[row]) == float(d)
                assert float(replay.r[row]) == pytest.approx(r, rel=1e-6, abs=1e-6)
                assert float(replay.g[row]) == pytest.approx(g, rel=1e-6)
                row += 1
    assert row == replay.size


# ----------------------------------------------------------------------
# the trainer


def test_train_dqn_batched_smoke_and_stats():
    """Two rounds train, update and report stats whose pieces agree."""
    cfg = PD.DQNConfig(state_dim=18, min_buffer=32, batch_size=16, eps_decay_steps=200,
                       target_sync_every=10, seed=0)
    tcfg = PT.BatchedTrainConfig(batch=2, horizon_decisions=40,
                                 scenarios=("paper-diurnal", "bursty-mmpp"),
                                 load_scale_range=(0.8, 1.2), replay_capacity=128)
    learner, stats = PT.train_dqn_batched(num_episodes=4, dqn_config=cfg, train_config=tcfg,
                                          seed=3, device="cpu")
    assert stats.episodes == 4 and stats.rounds == 2 and stats.batch == 2
    assert len(stats.episode_rewards) == len(stats.episode_et_proxy) == 4
    assert stats.env_steps == sum(stats.round_env_steps) == 2 * 2 * 40  # none ends by 10:00
    assert stats.truncated_episodes == 4
    assert stats.updates > 0 and len(stats.losses) == stats.updates
    assert np.isfinite(stats.losses).all() and np.isfinite(stats.episode_rewards).all()
    assert stats.final_epsilon == pytest.approx(learner.epsilon_at_step(stats.env_steps))
    assert learner.updates == stats.updates and int(learner.opt_state.step) == stats.updates
    for w, b in mlp_params_to_numpy(learner.params):
        assert np.isfinite(w).all() and np.isfinite(b).all()
    assert 0 <= learner.greedy_action(np.zeros(18, np.float32)) < cfg.num_actions
    assert len(stats.round_wall_seconds) == 2 and stats.env_steps_per_sec > 0


def test_trainer_draws_its_episodes_as_the_reference_does(monkeypatch):
    """Both trainers' outer loops side by side: the same episodes drawn (seed
    ``seed * 100_003 + i``, scenarios round-robin, a uniform load scale from
    the seed's generator), every round padded to the largest episode of all
    rounds, and the same stats filled from the same round outputs and final
    carry: the port's round runs, then its rewards, live masks, losses and
    final carry are swapped for the reference's of the same round."""
    import repro.core.scenarios as ref_scen
    import repro_torch.core.scenarios as port_scen

    drawn = {"ref": [], "port": []}

    def spy(side, real):
        def generate(name, seed, **kw):
            drawn[side].append((name, seed, kw))
            return real(name, seed=seed, **kw)
        return generate

    monkeypatch.setattr(ref_scen, "generate_scenario", spy("ref", ref_scen.generate_scenario))
    monkeypatch.setattr(port_scen, "generate_scenario", spy("port", port_scen.generate_scenario))

    ref_rounds, port_rounds = [], []
    ref_make, port_make = RT._make_round_fn, PT._make_round_fn

    def ref_round_fn(*a, **k):
        fn = ref_make(*a, **k)

        def run(*args):
            out = fn(*args)
            ref_rounds.append({"job_axis": args[8].shape, "env": out[0], "outs": out[-1],
                               "gstep": int(out[5])})
            return out
        return run

    def port_round_fn(*a, **k):
        fn = port_make(*a, **k)

        def run(*args):
            env, *carry, outs = fn(*args)
            ref = ref_rounds[len(port_rounds)]
            port_rounds.append({"job_axis": tuple(args[8].shape), "live": outs["live"].numpy(),
                                "gstep": carry[4] - args[5]})
            env = PB.state_from_numpy({k: np.asarray(v) for k, v in ref["env"]._asdict().items()},
                                      "cpu")
            rew, live, loss = (np.array(x) for x in ref["outs"][:3])
            outs = dict(outs, reward=torch.from_numpy(rew), live=torch.from_numpy(live), loss=loss)
            return (env, *carry, outs)
        return run

    monkeypatch.setattr(RT, "_make_round_fn", ref_round_fn)
    monkeypatch.setattr(PT, "_make_round_fn", port_round_fn)
    kw = dict(state_dim=18, min_buffer=10**9, seed=0)
    tkw = dict(batch=2, horizon_decisions=96, scenarios=("paper-diurnal", "bursty-mmpp"),
               load_scale_range=(0.2, 0.6))
    _, ref = RT.train_dqn_batched(num_episodes=3, dqn_config=RD.DQNConfig(**kw),
                                  train_config=RT.BatchedTrainConfig(**tkw), seed=1)
    _, port = PT.train_dqn_batched(num_episodes=3, dqn_config=PD.DQNConfig(**kw),
                                   train_config=PT.BatchedTrainConfig(**tkw), seed=1, device="cpu")

    rng = np.random.default_rng(1)
    want = [(("paper-diurnal", "bursty-mmpp")[i % 2], 100_003 + i,
             {"load_scale": float(rng.uniform(0.2, 0.6))}) for i in range(4)]
    assert drawn["port"] == drawn["ref"] == want
    # one job axis for every round, the largest episode's; the second round's
    # own episodes would pad to a shorter one
    lists = [ref_scen.generate_scenario(name, seed=seed, **k) for name, seed, k in want]

    def job_axis(episodes):
        return R.BatchedJobs.from_job_lists(episodes, max_slots=R.build_tables().max_slots).arrival.shape

    assert [r["job_axis"] for r in port_rounds] == [r["job_axis"] for r in ref_rounds] \
        == [(2, job_axis(lists)[1])] * 2
    assert job_axis(lists[2:])[1] < job_axis(lists)[1]
    # the port's own rounds ran the whole horizon; each counted its live decisions
    for p in port_rounds:
        assert p["live"].shape == (96, 2) and p["gstep"] > 0
    for f in ("episodes", "rounds", "batch", "env_steps", "updates", "truncated_episodes",
              "round_env_steps", "episode_rewards", "episode_et_proxy", "losses", "final_epsilon"):
        assert getattr(port, f) == getattr(ref, f), f
    # every episode's jobs finish inside the horizon (the ET proxies finite);
    # three episodes are still live at its last decision and count as truncated
    assert port.truncated_episodes == 3 and port.updates == 0
    assert np.isfinite(port.episode_et_proxy).all()


def test_round_rejects_what_it_cannot_run():
    tables = P.build_tables()
    consts = PB.device_constants(tables, "partial", "cpu")
    tcfg = PT.BatchedTrainConfig()
    with pytest.raises(ValueError, match="num_actions=5 != 12 device configs"):
        PT._make_round_fn(PD.DQNConfig(state_dim=18, num_actions=5), tcfg, RewardWeights(), tables,
                          consts, device="cpu")
    with pytest.raises(ValueError, match="state_dim=8 != feature dim 18"):
        PT._make_round_fn(PD.DQNConfig(), tcfg, RewardWeights(), tables, consts, device="cpu")
    with pytest.raises(ValueError, match="must be a positive multiple of dt_min"):
        PT._make_round_fn(PD.DQNConfig(state_dim=18),
                          PT.BatchedTrainConfig(decision_interval_min=0.75), RewardWeights(),
                          tables, consts, device="cpu")
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        PT.train_dqn_batched(num_episodes=1, train_config=PT.BatchedTrainConfig(lr_schedule="step"),
                             device="cpu")


def test_cosine_schedule_trains_and_needs_a_card_unless_asked(monkeypatch):
    cfg = PD.DQNConfig(state_dim=18, n_step=2, min_buffer=8, batch_size=8, seed=1)
    tcfg = PT.BatchedTrainConfig(batch=2, horizon_decisions=8, lr_schedule="cosine")
    learner, stats = PT.train_dqn_batched(num_episodes=2, dqn_config=cfg, train_config=tcfg,
                                          device="cpu")
    assert stats.updates > 0 and np.isfinite(stats.losses).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.train_dqn_batched(num_episodes=2, dqn_config=cfg, train_config=tcfg)


def test_train_rl_entry_point_writes_the_reference_npz(tmp_path, capsys):
    out = tmp_path / "p.npz"
    assert train_rl.main(["--device", "cpu", "--episodes", "2", "--batch", "2", "--horizon", "4",
                          "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["episodes"] == 2 and line["env_steps"] == 8 and line["device"] == "cpu"
    ref = RD.DQNLearner(RD.DQNConfig(state_dim=18))
    ref.load(str(out))
    assert [w.shape for w, _ in ref.params] == [(18, 256), (256, 256), (256, 12)]
    assert train_rl.dqn_config() == PD.DQNConfig(
        state_dim=18, n_step=8, lr=3e-4, target_sync_every=2000, min_buffer=2000,
        eps_decay_steps=100_000, seed=7)
    tcfg = train_rl.train_config()
    assert (tcfg.batch, tcfg.horizon_decisions, tcfg.replay_capacity, tcfg.load_scale_range,
            tcfg.decision_interval_min, tcfg.dt_min) == (64, 104, 16_384, (0.8, 1.2), 15.0, 0.5)


# ----------------------------------------------------------------------
# the golden file chip_smoke.py holds the card to


def reference_td_update() -> dict:
    """One TD update at the baseline's width and configuration from the
    checked-in parameters (target = parameters, fresh Adam) on a seeded batch."""
    cfg = RD.DQNConfig(state_dim=18, n_step=8, lr=3e-4, target_sync_every=2000, min_buffer=2000,
                       eps_decay_steps=100_000, seed=7)
    learner = RD.DQNLearner(cfg)
    learner.load(str(BASELINES / "rl_dqn_params.npz"))
    batch = td_batch(TD["batch_size"], cfg.gamma, cfg.n_step, TD["batch_seed"])
    _, update = RD.make_td_update(cfg)
    params, _, loss = jax.jit(update)(learner.params, learner.target, learner.opt_state,
                                      *map(jnp.asarray, batch))
    return {"loss": float(loss), "params": [(np.asarray(w), np.asarray(b)) for w, b in params]}


def golden_round(ref: dict, draws: dict) -> dict:
    return {
        "config": {k: list(v) if isinstance(v, tuple) else v for k, v in ROUND.items()},
        "draws": draws,
        "live": ref["live"].astype(int).ravel().tolist(),
        "reward": ref["reward"].ravel().tolist(),
        "loss": [None if np.isnan(x) else float(x) for x in ref["loss"]],
        "eps": ref["eps"].tolist(),
        **{k: ref[k] for k in ROUND_INTS},
        "replay_a": ref["replay"]["a"].tolist(), "replay_r": ref["replay"]["r"].tolist(),
        "cfg": ref["cfg"].tolist(), "repartitions": ref["repartitions"].tolist(),
        "params": digest(ref["params"]),
    }


def test_golden_file_td_and_round_sections_are_what_the_reference_gives(rounds):
    golden = json.loads(GOLDEN.read_text())
    td = reference_td_update()
    assert golden["td_update"]["config"] == TD
    assert abs(golden["td_update"]["loss"] - td["loss"]) <= GOLDEN_TOL
    assert digest_diff(digest(td["params"]), golden["td_update"]["params"]) <= GOLDEN_TOL
    g, want = golden["round"], golden_round(rounds["ref"], rounds["draws"])
    assert g["config"] == want["config"] and g["draws"] == want["draws"]
    for k in ("live", "replay_a", "cfg", "repartitions", *ROUND_INTS):
        assert g[k] == want[k], k
    for k in ("reward", "eps", "replay_r"):
        assert max_diff(g[k], want[k]) <= GOLDEN_TOL, k
    assert [x is None for x in g["loss"]] == [x is None for x in want["loss"]]
    assert digest_diff(want["params"], g["params"]) <= GOLDEN_TOL


def test_port_td_update_at_full_width_holds_the_golden_file():
    """What chip_smoke's rl_parity runs on the card, here on the CPU."""
    golden = json.loads(GOLDEN.read_text())["td_update"]
    loss, params = port_td_update("cpu")
    assert abs(loss - golden["loss"]) <= TD_TOL
    assert digest_diff(digest(params), golden["params"]) <= TD_TOL


def _write_golden() -> None:
    import test_torch_rl

    draws = JaxKeyDraws(ROUND["key_seed"])
    port_round(draws)  # asks the key chain for the draws at the round's replay sizes
    ref = reference_round()
    td = reference_td_update()
    out = {
        "td_update": {"config": TD, "loss": td["loss"], "params": digest(td["params"])},
        "round": golden_round(ref, draws.log),
        "env": test_torch_rl.golden_env(),
    }
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rl_train.py --write-golden")
    _write_golden()
