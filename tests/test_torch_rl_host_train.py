"""The port's host DQN trainer (``repro_torch.core.rl.train.train_dqn``) against the JAX package's, on the CPU.

``train_dqn(backend="host")`` is the paper's §IV-D loop: the event-cadence
``RepartitionEnv``, the n-step accumulator, ``DQNLearner.act`` and
``maybe_train``, and the guide warm-start.  Both learners draw actions and
replay samples from ``np.random.default_rng(cfg.seed + 1)``, but their
initialisations differ (``jax.random`` against ``torch.Generator``), so the
port's learner starts here from the reference learner's initial parameters:
the test patches the learner class that each package's ``train_dqn`` builds
with a recording subclass (the port's also loads those parameters); neither
trainer takes an argument the reference lacks.

Bars, at a reduced day (10 hours) with a small learner (hidden 64 x 64, batch
32, min_buffer 64, n-step 3, target sync every 25 updates) for 3 episodes,
the first guided by the queue heuristic:

* ``env_steps``, the update count and every action equal, up to the first
  decision whose greedy action flips (reported with its Q gap; a flip is
  allowed only where the gap is at rounding level, 1e-5 of the Q values'
  size, and everything after it is not compared);
* each episode's reward and ET proxy within 1e-9 relative (float64 host
  code: bit for bit while the actions agree);
* the losses, and each final parameter leaf, within 1e-5 of their largest
  magnitude (float32 TD updates in XLA and in torch, DESIGN.md §11).

Also: the ``backend="batched"`` dispatch and its argument errors (the
reference's messages), the default device raising without a card, and
``python -m repro_torch.launch.train_rl --backend host`` followed by
``python -m repro_torch.launch.evaluate --table3 --params``.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_rl_host_train.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import repro.core.rl.dqn as RD
import repro.core.rl.train as RT
import repro_torch.core.rl.dqn as PD
import repro_torch.core.rl.train as PT
from repro.core.workload import WorkloadSpec as RefSpec
from repro.launch.cluster_sim import queue_heuristic_policy as ref_heuristic
from repro_torch.core.rl.env import FEATURE_DIM
from repro_torch.core.workload import WorkloadSpec
from repro_torch.launch.cluster_sim import queue_heuristic_policy

EPISODES = 3
GUIDE_EPISODES = 1
HORIZON_MIN = 600.0
SEED = 2
CFG = dict(state_dim=FEATURE_DIM, hidden=(64, 64), n_step=3, lr=3e-4, batch_size=32, min_buffer=64,
           target_sync_every=25, eps_decay_episodes=2, seed=3)
REWARD_RTOL = 1e-9
TD_TOL = 1e-5  # of the largest magnitude
FLIP_GAP = 1e-5  # of the largest |Q|: a greedy flip below it is rounding


def _marking(env_cls, log, resets):
    """``env_cls`` whose ``reset`` records where each episode starts in ``log``."""

    class Marking(env_cls):
        def reset(self, *a, **kw):
            resets.append(len(log))
            return super().reset(*a, **kw)

    return Marking


def _record(base, log, init=None):
    """``base`` with ``act`` recording (action, Q values or None when it
    explored); the same draws and choices as ``base.act``.  With ``init``
    (numpy ``(w, b)`` pairs), the learner starts from those parameters."""

    class Recording(base):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            if init is not None:
                self.params = PD.mlp_params_from_numpy(init, self.device)
                self.target = [(w.clone(), b.clone()) for w, b in self.params]
                self.opt_state = self._opt.init([t for wb in self.params for t in wb])

        def act(self, state, epsilon):
            if self._rng.uniform() < epsilon:
                a = int(self._rng.integers(0, self.cfg.num_actions))
                log.append((a, None))
                return a
            q = np.asarray(self.q(state), np.float64)
            a = int(np.argmax(q))
            log.append((a, q))
            return a

    return Recording


def first_flip(port_log, ref_log):
    """The first decision whose action differs: its index, both actions, and
    the top-two Q gap of each side's Q values (None where it explored)."""
    for i, ((a, q), (b, qr)) in enumerate(zip(port_log, ref_log)):
        if a != b:
            def gap(x):
                return None if x is None else float(np.sort(x)[-1] - np.sort(x)[-2])

            scale = max(float(np.abs(q).max()) if q is not None else 0.0, 1.0)
            return {"decision": i, "port": a, "ref": b, "port_gap": gap(q), "ref_gap": gap(qr),
                    "q_scale": scale}
    return None


@pytest.fixture(scope="module")
def runs():
    """Both trainers from the reference learner's initial parameters."""
    init = [(np.asarray(w), np.asarray(b)) for w, b in RD.DQNLearner(RD.DQNConfig(**CFG)).params]
    ref_log, port_log, ref_resets, port_resets = [], [], [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(RT, "DQNLearner", _record(RD.DQNLearner, ref_log))
        mp.setattr(PT, "DQNLearner", _record(PD.DQNLearner, port_log, init))
        mp.setattr(RT, "RepartitionEnv", _marking(RT.RepartitionEnv, ref_log, ref_resets))
        mp.setattr(PT, "RepartitionEnv", _marking(PT.RepartitionEnv, port_log, port_resets))
        common = dict(num_episodes=EPISODES, seed=SEED, guide_episodes=GUIDE_EPISODES)
        ref = RT.train_dqn(spec=RefSpec(horizon_min=HORIZON_MIN), dqn_config=RD.DQNConfig(**CFG),
                           guide=ref_heuristic(), **common)
        port = PT.train_dqn(spec=WorkloadSpec(horizon_min=HORIZON_MIN), dqn_config=PD.DQNConfig(**CFG),
                            guide=queue_heuristic_policy(), device="cpu", **common)
    finally:
        mp.undo()
    return {"ref": ref, "port": port, "ref_log": ref_log, "port_log": port_log, "init": init,
            "ref_resets": ref_resets, "port_resets": port_resets}


def compared_episodes(r) -> int:
    """Episodes that ended before the first flip (all of them without one)."""
    flip = first_flip(r["port_log"], r["ref_log"])
    if flip is None:
        return EPISODES
    return sum(1 for k in r["port_resets"] if k <= flip["decision"]) - 1


def test_host_trainer_takes_the_references_actions(runs):
    (pl, ps), (rl, rs) = runs["port"], runs["ref"]
    flip = first_flip(runs["port_log"], runs["ref_log"])
    if flip is not None:
        # only a greedy choice between near-equal Q values may flip; nothing
        # after it is compared
        assert flip["port_gap"] is not None and flip["ref_gap"] is not None, flip
        assert min(flip["port_gap"], flip["ref_gap"]) <= FLIP_GAP * flip["q_scale"], flip
        k = compared_episodes(runs) + 1
        assert runs["port_resets"][:k] == runs["ref_resets"][:k]
        return
    # the guided episode's decisions call no ``act``
    assert ps.env_steps == rs.env_steps > len(runs["port_log"]) > 0
    assert pl.updates == rl.updates > 0
    assert [a for a, _ in runs["port_log"]] == [a for a, _ in runs["ref_log"]]
    assert runs["port_resets"] == runs["ref_resets"] and len(runs["port_resets"]) == EPISODES
    assert sum(q is not None for _, q in runs["port_log"]) > 0, "no greedy decision was compared"
    assert ps.episodes == rs.episodes == EPISODES
    assert ps.episode_updates[-1] > 0 and sum(ps.episode_updates) == pl.updates


def test_host_trainer_rewards_and_proxies_match_reference(runs):
    (_, ps), (_, rs) = runs["port"], runs["ref"]
    k = compared_episodes(runs)
    assert k >= GUIDE_EPISODES + 1, "the first learner episode flipped"
    for got, want in ((ps.episode_rewards, rs.episode_rewards), (ps.episode_et_proxy, rs.episode_et_proxy)):
        assert len(got) == len(want) == EPISODES
        for g, w in zip(got[:k], want[:k]):
            assert abs(g - w) <= REWARD_RTOL * max(abs(w), 1e-30), (g, w)


def test_host_trainer_losses_and_parameters_match_reference(runs):
    (pl, ps), (rl, rs) = runs["port"], runs["ref"]
    k = compared_episodes(runs)
    n = sum(ps.episode_updates[:k])
    got, want = np.asarray(ps.losses), np.asarray(rs.losses)
    assert got.size == pl.updates and np.isfinite(got).all() and n > 0
    assert np.abs(got[:n] - want[:n]).max() <= TD_TOL * np.abs(want[:n]).max()
    if k < EPISODES:
        return  # a flip: the parameters after it are not compared
    assert got.shape == want.shape
    for (w, b), (rw, rb) in zip(PD.mlp_params_to_numpy(pl.params), rl.params, strict=True):
        for a, r in ((w, np.asarray(rw)), (b, np.asarray(rb))):
            assert np.abs(a - r).max() <= TD_TOL * np.abs(r).max()
    # the parameters moved from where they started
    assert np.abs(PD.mlp_params_to_numpy(pl.params)[0][0] - runs["init"][0][0]).max() > 0.0


def test_host_trainer_on_a_decision_cadence_and_a_scenario(monkeypatch):
    """``decision_interval_min`` and ``scenario`` reach the env as in the
    reference: one unguided episode, both from the reference's parameters."""
    init = [(np.asarray(w), np.asarray(b)) for w, b in RD.DQNLearner(RD.DQNConfig(**CFG)).params]
    ref_log, port_log = [], []
    monkeypatch.setattr(RT, "DQNLearner", _record(RD.DQNLearner, ref_log))
    monkeypatch.setattr(PT, "DQNLearner", _record(PD.DQNLearner, port_log, init))
    kw = dict(num_episodes=1, seed=4, scenario="bursty-mmpp", scenario_kwargs={"horizon_min": 180.0},
              decision_interval_min=15.0)
    _, rs = RT.train_dqn(dqn_config=RD.DQNConfig(**CFG), **kw)
    _, ps = PT.train_dqn(dqn_config=PD.DQNConfig(**CFG), device="cpu", **kw)
    assert first_flip(port_log, ref_log) is None
    assert ps.env_steps == rs.env_steps == len(port_log) > 0
    assert ps.episode_rewards == pytest.approx(rs.episode_rewards, rel=REWARD_RTOL)
    assert ps.episode_et_proxy == pytest.approx(rs.episode_et_proxy, rel=REWARD_RTOL)


@pytest.mark.parametrize("kw, match", [
    (dict(backend="batched", guide=object()), "guide warm-start is host-backend only"),
    (dict(backend="batched"), "EDF-FS only"),
    (dict(backend="oracle"), "unknown backend"),
])
def test_backend_argument_errors_match_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        RT.train_dqn(num_episodes=1, **kw)
    with pytest.raises(ValueError, match=match):
        PT.train_dqn(num_episodes=1, device="cpu", **kw)


def test_batched_backend_dispatches_with_the_merged_config():
    from repro_torch.core.rl.batched_train import BatchedTrainConfig, train_dqn_batched

    cfg = PD.DQNConfig(state_dim=FEATURE_DIM, hidden=(16, 16), min_buffer=4, batch_size=4)
    tcfg = BatchedTrainConfig(batch=2, horizon_decisions=4, scenario_kwargs={"load_scale": 0.5})
    learner, stats = PT.train_dqn(num_episodes=2, dqn_config=cfg, backend="batched", scheduler_name="EDF-FS",
                                  train_config=tcfg, scenario="bursty-mmpp",
                                  scenario_kwargs={"horizon_min": 120.0}, decision_interval_min=30.0,
                                  seed=1, device="cpu")
    merged = BatchedTrainConfig(batch=2, horizon_decisions=4, scenarios=("bursty-mmpp",),
                                scenario_kwargs={"load_scale": 0.5, "horizon_min": 120.0},
                                decision_interval_min=30.0)
    direct, want = train_dqn_batched(num_episodes=2, dqn_config=cfg, train_config=merged, seed=1, device="cpu")
    assert stats.episode_rewards == want.episode_rewards and stats.env_steps == want.env_steps
    for (w, b), (dw, db) in zip(learner.params, direct.params):
        assert bool((w == dw).all()) and bool((b == db).all())


def test_host_trainer_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.train_dqn(num_episodes=1)


def test_train_rl_host_then_table3_on_the_cpu(tmp_path, capsys):
    """``train_rl --backend host`` writes the reference's npz, which the
    reference's learner loads and ``evaluate --table3 --params`` scores."""
    from repro_torch.launch import evaluate, train_rl

    out = tmp_path / "p.npz"
    assert train_rl.main(["--backend", "host", "--episodes", "2", "--guide-episodes", "1",
                          "--device", "cpu", "--out", str(out)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["backend"] == "host" and summary["episodes"] == 2 and summary["env_steps"] > 0
    ref = RD.DQNLearner(RD.DQNConfig(state_dim=FEATURE_DIM))
    ref.load(str(out))
    assert len(ref.params) == 3
    assert train_rl.host_dqn_config(400) == PD.DQNConfig(
        state_dim=FEATURE_DIM, eps_decay_episodes=200, n_step=8, lr=3e-4, target_sync_every=2000)
    assert train_rl.host_guide_episodes(400) == 40 and train_rl.host_guide_episodes(2) == 10
    with pytest.raises(SystemExit):
        train_rl.main(["--backend", "host", "--batch", "8", "--out", str(out)])
    assert evaluate.main(["--table3", "--params", str(out), "--scale", "0.2", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["model"] for r in rows][-1] == "DynamicMIG-DQN" and all(np.isfinite(r["ET"]) for r in rows)
