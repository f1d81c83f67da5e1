#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It puts
``src`` on ``sys.path`` itself, imports nothing of JAX or of the JAX package
``repro``, builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/`` and runs these phases, each printing one JSON line:

0. lint     — the port's invariant analyzer (``repro_torch.lint.lint_repo``,
              what ``python -m repro_torch.lint`` runs) over the tree this
              script runs from, without ``--diff`` (a shipped copy has no
              git): the files checked, the unwaived findings (0 allowed),
              the waived ones and the seconds (under 10 allowed).
1. device   — the card, the toolchain, the kernel build (seconds, ptxas -v).
2. kernels  — flash attention against its plain PyTorch version on the card:
              the attention cases of tests/test_kernels.py, cases at the
              head dims 80, 96 and 192 (carried in a larger tile), a bf16
              twin of each fp32 one (the wgmma route), and the gemma3-1b
              prefill shapes (tolerance 2e-5 fp32, 2e-2 bf16; bf16 also
              within 1e-2 of the exact value row by row, where a stand-in
              that rounds P to fp8 must fail); at D 80 on both routes, that
              the epilogue leaves the bytes past the last head as they were;
              at one prefill shape of each config with such a head dim, the
              kernel's time beside ``scaled_dot_product_attention``.
3. prefill  — full-width gemma3-1b ``forward`` on B=2, S=2048: fp32 kernel
              vs plain logits, the bf16 main path (launch counts, tokens/s,
              top-1 agreement with the plain path), kernel times vs bound.
4. decode   — full-width fp32 ``decode_step`` x16 against ``forward``.
5. serve    — ``serve("gemma3_1b", smoke=False, batch=4, steps=32)``.
6. profile  — torch.profiler over one bf16 prefill forward and 4 decode
              steps: device time by kernel and the device's idle share.

Then the jamba-v0.1-52b path, full width, cut to one 8-layer pattern unit:

7. jamba_kernels — the selective scan against its plain version: the cases
              of tests/test_kernels.py (2e-4 fp32, 3e-2 bf16), the jamba
              prefill shape, a ragged one and a slow-decaying state (where
              the plain scan with its state dropped every 128 steps must
              fail the bar); per case the grid, kernel (CUDA graph, and
              eager), plain, bound and exponential-floor times; its ptxas
              registers and spills (none allowed); flash attention at the
              jamba attention shape beside ``scaled_dot_product_attention``.
8. jamba_prefill — bf16 ``forward`` on B=2, S=2048 (launch counts: 7 scans
              and 1 attention, top-1 agreement with the plain path, tokens/s,
              peak memory); one fp32 mamba mixer, kernel vs plain.
9. jamba_profile — torch.profiler over one bf16 prefill and 4 decode steps.
10. jamba_decode — fp32 model, 16 ``decode_step``s against ``forward``.
11. jamba_serve — ``serve("jamba_v01_52b", smoke=False, n_layers=8, ...)``.

Then the xlstm-350m path, full width and full depth (21 mLSTM, 3 sLSTM):

12. xlstm_kernels — the chunkwise mLSTM kernel against its plain version
              (the chunked scan): the cases of tests/test_kernels.py, the
              prefill shape and a ragged T, in fp32 and bf16; per case the
              route (bf16 on wgmma, fp32 on the CUDA cores), kernel (in a
              CUDA graph, and eager), plain and bound times; the wgmma
              kernels' ptxas registers and spills (none allowed); at the
              prefill shape, the errors against an fp64 evaluation of the
              kernel, of the plain version and, in bf16, of the precision
              controls (the plain-torch model of the route's arithmetic with
              split, bf16 and TF32 operands; bf16 must fail the bar).
13. xlstm_prefill — bf16 ``forward`` on B=2, S=2048 (launch counts: 21
              mLSTM kernels, top-1 agreement with the plain path, tokens/s,
              peak memory); one fp32 mLSTM block, kernel vs plain.
14. xlstm_profile — torch.profiler over one bf16 prefill and 4 decode
              steps, and the sLSTM time loop's share of the prefill's wall
              time, timed on its own.
15. xlstm_decode — fp32 model, 16 ``decode_step``s against ``forward``.
16. xlstm_serve — ``serve("xlstm_350m", smoke=False, batch=4, steps=32)``.

Then the granite-moe-3b-a800m path, full width and full depth (32 layers, each
attention and a 40-expert top-8 MoE, tied embedding), whose MoE expert
products run on the grouped-matmul kernel K4 (as jamba's MoE layers now do):

17. gmm_kernels — K4 against its plain version: the cases of
              tests/test_kernels.py (uneven groups included) in fp32, bf16
              and bf16 with fp32 output, the granite and jamba prefill
              products, the decode shape (one row per expert), a ragged K,
              N and row block, a persistent-schedule case (more tiles than
              SMs, a ragged last wave) and a bad group id on the wgmma route
              (1e-3 fp32 output, 1e-2 bf16); at the paths' shapes the route,
              kernel, plain, bound and ``torch.bmm`` times, TFLOP/s and the
              ratios to ``torch.bmm`` and to the bound.
17b. decode_attention — K5 (decode attention, csrc/decode_attention.cu)
              against its plain version at mixtral's decode shape (64
              streams, a 4,096-slot bf16 cache, 32/8 heads of 128) filled to
              431 slots (the decode cell's) and to 4,096, and one stream over
              the full cache (many splits): the splits, K5's time a call in a
              CUDA graph, the bytes bound of the filled slots, the plain
              route's time (the fp32 upcast of the whole cache the port ran
              before K5) and ``scaled_dot_product_attention``'s over the
              filled slots; K5 within one unit of bf16's last place of the
              plain version.
18. granite_attention — flash attention at the granite attention shape
              (B=2, S=2048, 24/8 heads of 64, causal, bf16) against its plain
              version, beside ``scaled_dot_product_attention``.
19. granite_prefill — bf16 ``forward`` on B=2, S=2048 (launch counts: 32
              attention, 96 K4; top-1 agreement with the plain path,
              tokens/s, peak memory); one fp32 MoE layer, kernel vs plain.
20. granite_profile — torch.profiler over one bf16 prefill and 4 decode
              steps: K4's and K1's shares of the device time, the idle share.
21. granite_decode — fp32 model, 16 ``decode_step``s against ``forward``;
              K4's launches in those steps.
22. granite_serve — ``serve("granite_moe_3b_a800m", smoke=False, ...)``.

Then the logits product that every served path ends in (ROADMAP.md A.P1):

23. logits_product — the port's product (bf16 operands, fp32 out, no fp32
              copy of the unembedding, d_model summed 2,048 columns at a
              time) against the fp32 upcast it replaced, on the same operands
              at gemma3-1b's prefill shape and nemotron-4-340b's: the largest
              difference (1e-5 * max), both times, the memory each takes
              beyond its operands; the errors of both and of one GEMM over all
              of d_model against an fp64 product.

Then the remaining configs, at their published widths: whisper-base (6 + 6
layers; the encoder over precomputed frame embeddings and a cross-attention
in each decoder layer), gemma3-12b (48 layers), mixtral-8x7b cut to 16 of its
32 one-layer units (46.9 GB in bf16), stablelm-3b (32), phi-3-vision-4.2b
(32; 576 patch embeddings before the text) and nemotron-4-340b cut to 6 of
its 96 one-layer units (60.3 GB in bf16):

24. a5_attention — flash attention against its plain version (both bf16
              bars) at every shape these paths give it: whisper's encoder
              (non-causal, 1,500 frames), decoder (causal, 448), cross (448
              against 1,500) and decode cross (1 against 1,500); gemma3-12b's
              local (window 1,024) and global layers (16/8 heads of 256);
              mixtral's window (4,096 at S 8,192); stablelm's D 80 and
              phi-3-vision's D 96 over 2,624 positions; nemotron's GQA 96/8
              at D 192 over 4,096; per shape the kernel (CUDA graph, and
              eager), plain, SDPA and bound times.
25-30. {whisper, gemma3_12b, mixtral, stablelm, phi3_vision,
              nemotron}_{prefill, decode, serve} — per config: the fp32 kernel
              against the plain path through the whole model (logits
              1e-5·max; mixtral at 8 layers and S 6,144, nemotron at 1 layer
              and S 2,048), fp32 ``decode_step`` x16 against ``forward`` on
              the same parameters (2e-2; whisper's with ``encode``'s output
              as ``enc_out``, 6 K1 a step), the bf16 main path at
              A5_PREFILL's shape counted from 0 (K1 18 whisper, 48
              gemma3-12b, 16 mixtral with 48 K4, 32 stablelm, 32
              phi-3-vision, 6 nemotron at B 1 x S 4,096; finite logits of the
              text positions, wall time, tokens/s, peak GB, nemotron's at
              most 74), top-1 against the plain path >= 0.99 (nemotron's at S
              2,048), one prefill under torch.profiler (device time by
              kernel, the idle share), then ``serve`` (batch 4, 32 steps;
              whisper decodes without ``enc_out``, as the reference's
              ``serve`` does).

Then the batched MIG simulator (``repro_torch.core.batched``), which runs no
kernel of the four (its step is batched torch ops):

31. sim_parity — ``simulate_batch`` on the card for the eight rows of
              tests/test_batched.py's agreement matrix (6 seeds a row, load
              0.2; rows of one policy kind and mode in one batch), held to
              the port's CPU run on the same inputs (a child process a
              batch, beside the card's runs) and to the JAX
              reference's aggregates in tests/data/torch_sim_golden.json
              (integers exact; the bars of tests/test_torch_sim.py); the
              largest difference of each aggregate per row. It runs near the
              end, after 48, beside the dry-run's children.
32. sim_throughput — paper-diurnal, DayNight, partial, dt 0.5 at two sizes:
              (a) 2048 rollouts at load 1.0, the width of the RL training run
              of benchmarks/baselines/rl_batched.json; (b) 256 at load 12.0,
              the headline point of benchmarks/baselines/batched_agreement.json.
              Per size: padded J, steps and chunks, the wall time of
              ``simulate_batch`` after a warm-up of two chunks at full
              width, peak memory, env-steps/s, simulated
              rollout-minutes/s, events-equivalent/s (the reference oracle's
              event count at that load over the wall time), and over 128
              steps (since PR 25; a 512-step chunk before) under
              torch.profiler the launches and device busy time per step and
              the device's idle share; the first 8
              rollouts of (b) held to the port's CPU run of them.

Then the DQN trainers (``repro_torch.core.rl``): the on-device one, whose
step is the simulator's, and the paper's host loop over the event-driven
simulator; the learner is an MLP of three matmuls (no kernel of the four):

33. rl_parity — on the card, with tests/torch_rl_golden.py's inputs and
              runs of the port: the checked-in parameters
              (benchmarks/baselines/rl_dqn_params.npz) give rl_batched.json's
              params_probe (seed 123, 16 greedy actions); argmax takes the
              first of tied maxima; one TD update at the baseline's width and
              configuration from those parameters on a seeded batch, against
              the port's CPU run and the reference's in
              tests/data/torch_rl_golden.json (1e-5, DESIGN.md §11); the
              golden file's round (B 4, H 16, n-step 3, learning on) with the
              reference's draws replayed, against the golden file and the
              port's CPU run (integers exact, rewards and replay 1e-6,
              parameters 1e-5); ``BatchedRepartitionEnv`` through the golden
              file's scripted day at B 8 (observations bit for bit, rewards,
              flags, results).
34. rl_train — ``train_dqn_batched`` at the baseline's configuration (B 64,
              104 decisions of 15 minutes, n-step 8, the four training
              scenarios at loads 0.8-1.2) for 2 rounds: wall time of each
              round, env-steps/s, updates, the final epsilon, the finite
              losses, peak memory, the host's time a decision (the second
              round's wall over its 104 decisions); over 4 decisions of the
              second round, rebuilt as the trainer pads it, with updates on:
              the launches and device busy time per decision, and the idle
              share against the same decisions' unprofiled wall.

35. rl_host_train — the paper's host trainer (``train_rl --backend host``,
              ``train_dqn`` over ``RepartitionEnv`` at
              examples/dynamic_repartitioning_day.py's configuration, the
              queue heuristic guiding) for 4 episodes, 2 guided, the Q network
              and TD update on the card: seconds an episode, env-steps/s, TD
              updates, finite losses, peak memory; every 100th TD update
              repeated on the CPU from the card's state and batch (1e-5,
              DESIGN.md §11); the same 4 episodes on the CPU from the same
              initial parameters, in a child process beside the card's run,
              held to the card's (actions, rewards to 1e-9) up to the first
              decision where they part, which is reported with its TD updates
              and Q gaps (fp32 rounding, amplified by Adam, parts two runs
              after some hundreds of updates); over 50 more decisions with
              updates on, under torch.profiler, the launches and device busy
              time per decision and the idle share against their unprofiled
              wall.

Then the evaluation path (``repro_torch.launch.evaluate``): the event-driven
simulator, the four schedulers, the policy registry, the forecast controller
and the fleet layer (float64 host code), with the greedy DQN's Q network on
the card (no kernel of the four):

36. eval_replay — every cell of the seven checked-in sweep baselines
              (benchmarks/baselines/{smoke_sweep, scenario_matrix,
              repartition_policies, repartition_modes}.jsonl and the fleet
              rows of {fleet_scaling, dispatchers, serving_matrix}.jsonl, 518
              rows) as stored, through the port's ``run_cell`` on the sweep's
              worker processes (one ``run_cells`` call, no cache); per file
              the rows, the rows within rtol 1e-9 (the
              integers, ``dispatch_counts``, the devices' tenants,
              ``config_trace`` and ``util_histogram`` exact), the largest
              relative difference; the seconds of all seven; the
              forecaster's fitted coefficients against the reference's
              (tests/data/torch_eval_forecast_golden.json). Any row off fails.
37. fleet_dqn — ``evaluate_policy_fleet`` with the checked-in npz as the
              registry's ``"dqn"`` (one Q network a device, on the card) on
              2xA100+2xA30, state-aware, 4 paper-diurnal days, against the
              reference's results in tests/data/torch_fleet_golden.json
              (rtol 1e-9, integers exact); the same days with every greedy
              decision logged, each held to a CPU learner's action (flips
              with their Q gaps); the wall seconds.
38. eval_race — the checked-in policy (rl_dqn_params.npz) loaded into the
              port's learner on the card and raced against the forecast
              controller on the six families at scale 0.1, as
              scripts/train_rl_baseline.py's check does: each row and
              ``families_beaten`` against rl_batched.json, the decisions, the
              wall time, every decision whose action differs from the port's
              CPU run with its Q gap, and over one profiled day the Q
              network's launches and device time per decision.
39. eval_table3 — Table III at scale 1.0 (10 ``WorkloadSpec`` days a model):
              NoMIG, static config 3, DayNight, the queue heuristic and the
              checked-in npz as the registry's ``"dqn"`` (event cadence): ET
              and the improvement over NoMIG per model, measured, not gated.
40. serving_day — the multi-tenant-serving scenario (tenants of the
              configs above mapped to MIG slice classes, latency SLOs over the
              diurnal day): the balanced mix, seed 11, static config 3, a
              whole day at load 1.0, once with each of EDF-FS, EDF-SS, LLF
              and LALF through ``make_scenario_cell`` and ``run_cell``, each
              result against the reference's in
              tests/data/torch_serving_golden.json (integers, tenant counts,
              trace and histogram exact, floats within rtol 1e-9).

Then the sweep engine (``repro_torch.sweep``: content hashes, the on-disk
cache, the spawn worker pool, the 14 grids, the batched route), each phase in
a temporary working directory removed afterwards, with min(8, cores) worker
processes; tests/torch_sweep_golden.py holds the inputs and comparisons:

41. sweep_baselines — the seven checked-in baselines (518 rows) at scale
              0.1: their cells computed in one ``run_cells`` call on the
              workers (a spawned worker takes ~10 s to import torch on the
              card's machine, so each phase starts one pool), then each grid
              through ``run_grid`` from the cache, its artifact against its
              file as ``python -m repro_torch.sweep --check-baseline``
              compares them (every hash found, rtol 1e-9); the seconds and
              cells/s; then ``smoke`` again, every cell from the cache.
42. sweep_paper — the seven paper grids (Tables II-III, Figs. 4, 6-11) at
              scale 1.0, computed likewise in one pool and read through
              ``run_grid``, against the reference's rows in
              tests/data/torch_sweep_golden.json (cells, hashes, rows within
              rtol 1e-9, integers exact); then with the checked-in DQN
              parameters at artifacts/dqn_params.npz, Table III and Fig. 11
              through ``run_grid`` in this process, the registry DQN's Q
              network on the card (a row off the golden file fails, with
              every decision that differs from a CPU learner's and its Q
              gap); the seconds, the cells, the workers; one DQN day under
              the profiler (the Q network's launches, device time).
43. sweep_batched — the golden file's batched cells (static config 3,
              nomig and daynight x 64 paper-diurnal days under EDF-FS)
              through ``run_cells``: 3 ``simulate_batch`` groups on the card,
              held to the port's CPU run of the same cells (a child process
              a group, beside the card's) and to the reference's results (the
              bars of tests/test_torch_sim.py), then to the oracle (``num_jobs``
              and ``repartitions`` exact, each group's means within
              BATCHED_SIM.md §4, a rollout outside §4 only where the
              reference's is too; run on the cores the card's loop and the
              CPU children leave); cells/s of the batched route and of the
              oracle; one group's step under the profiler (launches, device
              time, idle share).

Then the training path (``repro_torch.launch.train``: ``loss_fn`` with the
chunked softmax, ``make_train_step``, ``SyntheticLM``, the checkpoint store),
which trains through autograd on the plain versions at ``impl="ref"``, as the
reference does (the four kernels are forward-only and stay off it):

44. train_parity — for gemma3-1b, jamba, xlstm and granite at their smoke
              configs in fp32 (granite with 2 microbatches), one
              ``make_train_step`` step from the same parameters and non-zero
              optimiser state on the same ``SyntheticLM`` batch, on the
              card and on the CPU: loss and grad norm within 1e-5 relative,
              every parameter within 1e-5 of its leaf's largest, m and v
              within 1e-4; the worst leaf of each arch.
45. train — ``train("gemma3_1b", smoke=False)`` at the reference's defaults
              (global batch 8, sequence 256, bf16; 0.9998 B parameters) for 6
              steps with a checkpoint every 3 into a temporary directory
              (its free disk first); then step 6 deleted and ``train`` again,
              which must resume at step 3 and repeat steps 4-6 within 1e-3
              relative (and says whether bit for bit). The losses, ms a step
              (median after the first), tokens/s, peak GB, the checkpoint's GB
              and files, the seconds of the host snapshot, the write and the
              restore, K1-K4's launches (0), and torch.profiler over one step.

Then the scheduler service (``repro_torch.service``: WAL, checkpoints, crash
recovery, the socket front end) and the TPU-pod cluster day
(``repro_torch.launch.cluster_sim.run_days`` over ``repro_torch.cluster``),
host code but for the greedy DQN's Q network, which runs on the card; every
result against the reference's in tests/data/torch_service_golden.json
(tests/torch_service_golden.py; rtol 1e-9, integers exact, 0 expected):

46. cluster_day — ``run_days`` on the simulated 256-chip pod, 2 days each:
              static config 3, daynight, the queue heuristic, the heuristic
              under ``FailureModel(mtbf_minutes=8*60, seed=3)``, and
              ``--policy dynamic``'s greedy DQN (rl_dqn_params.npz, its Q
              network on the card) without and with those failures; the DQN
              days again with every decision logged, each held to a CPU
              learner's action (no flip allowed); one DQN day under
              torch.profiler: the Q network's launches, device busy ms and
              idle share per decision.
47. service — ``python -m repro_torch.service replay`` and ``... serve``
              in child processes started before ``cluster_day`` (each
              imports torch meanwhile); the crash matrix (``daynight`` and
              ``heuristic`` x ``partial`` and ``drain``, each killed at 3
              seeded op indices, recovered from
              header, checkpoint and WAL tail, resumed); fleet mode (2
              devices) recovered from a pickled FleetStream; the replay child
              SIGKILLed once its WAL holds 25 lines, then recovered and fed
              the rest; the soak's full trace-scaled day (WAL < 1 MB, <= 2
              checkpoints, resident-set growth < 200 MB over the second half,
              p99 submit latency < 50 ms); a round trip through
              ``ServiceServer`` on a unix socket; then 6,000 submissions to
              the serve child over its socket (scripts/bench_service.py's
              feed): jobs/min (floor 5,000) and p50/p95/p99 latency (p99
              < 50 ms).

Then the sharding layer and the dry-run (``repro_torch.distributed``,
``repro_torch.launch.dryrun``); the dry-run's child processes start after
``service``, the last timed phase, and sim_parity (31) runs beside them:

48. sharded_step — an NCCL world of one (a TCP store on localhost) and a
              1x1 mesh: gemma3-1b's smoke train step on DTensors, 4
              ``serve`` steps (at ``impl="ref"``) and ``compressed_psum``
              bit-equal to the same without a mesh.
49. dryrun  — the port's dry-run of six production cells on a fake
              256-rank (16, 16) mesh, a child process each that does not see
              the card, at the lowest CPU priority: per cell ok or skip, the
              arguments and temporaries in GB a card (modelled), ``fits``,
              FLOPs, bytes, collective bytes by kind, the roofline terms at
              the H100's constants; nemotron ``long_500k`` must skip with the
              reference's reason.
50. roofline — gemma3-1b's prefill (the median of 5 timed forwards) and
              train step (the median of steps 2-6): their model FLOPs at the
              bf16 peak over the measured ms (``mfu``), and the FLOPs a trace
              of each on a 1x1 mesh counts (``counted_share``).

Then the card's name and power limit as nvidia-smi gives them, one JSON line
with every kernel's numbers, and last ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result; so
does a machine without a CUDA card, or a directory without the port.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (dense bf16 tensor rate, fp32 CUDA-core rate, HBM3), from their
# one cited source, repro_torch.analysis.constants
if (SRC / "repro_torch").is_dir():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.analysis.constants import HBM_BW as PEAK_BYTES
    from repro_torch.analysis.constants import PEAK_FLOPS
else:  # chip_smoke.py without the repo: main() says so and exits 2
    PEAK_FLOPS, PEAK_BYTES = {}, 0.0

# tests/test_kernels.py ATTN_CASES: B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset, dtype
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None, 0, "float32"),
    (1, 128, 128, 8, 8, 128, True, None, None, 0, "float32"),
    (1, 256, 256, 4, 1, 64, True, 128, None, 0, "float32"),
    (2, 128, 128, 4, 2, 64, False, None, 50.0, 0, "float32"),
    (1, 128, 384, 4, 2, 64, True, None, None, 256, "float32"),
    (1, 256, 256, 2, 2, 64, True, None, None, 0, "bfloat16"),
    (1, 128, 128, 4, 4, 256, True, 64, None, 0, "float32"),
]
# gemma3-1b prefill: 22 local layers (window 512) and 4 global (causal) per forward
PREFILL_B, PREFILL_S = 2, 2048
PREFILL_TIMED = 5  # timed bf16 forwards; prefill_s is their median
GEMMA_SHAPES = {
    "local": (PREFILL_B, PREFILL_S, PREFILL_S, 4, 1, 256, True, 512, None, 0, "bfloat16"),
    "global": (PREFILL_B, PREFILL_S, PREFILL_S, 4, 1, 256, True, None, None, 0, "bfloat16"),
}
LAYERS_PER_FORWARD = {"local": 22, "global": 4}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# head dims without a tile of their own (80 and 96 run in the D 128 tile, 192
# in the bf16 route's D 256 one): causal with GQA and windowed, Sq and Sk
# multiples of no tile; phase kernels adds a bf16 twin of each
ODD_D_CASES = [
    (2, 200, 200, 6, 2, 80, True, None, None, 0, "float32"),
    (1, 256, 256, 4, 1, 80, True, 64, None, 0, "float32"),
    (2, 130, 130, 8, 2, 96, True, None, None, 0, "float32"),
    (1, 256, 300, 4, 4, 96, True, 100, None, 44, "float32"),
    (1, 200, 200, 4, 2, 192, True, None, None, 0, "float32"),
    (2, 128, 128, 2, 1, 192, True, 50, None, 0, "float32"),
]
# a prefill shape (B=2, S=2048, causal, bf16) of each config with such a head
# dim: stablelm-3b 32/32 heads of 80, phi-3-vision-4.2b 32/32 of 96,
# nemotron-4-340b 96/8 of 192
ODD_D_SHAPES = {
    "stablelm_3b": (PREFILL_B, PREFILL_S, PREFILL_S, 32, 32, 80, True, None, None, 0, "bfloat16"),
    "phi3_vision_4_2b": (PREFILL_B, PREFILL_S, PREFILL_S, 32, 32, 96, True, None, None, 0, "bfloat16"),
    "nemotron_4_340b": (PREFILL_B, PREFILL_S, PREFILL_S, 96, 8, 192, True, None, None, 0, "bfloat16"),
}
# bf16 attention, second bar: the largest over (b, s, h) rows of
# |out - exact| / |exact| (norms over D), exact being the plain version in fp32
# on the same bf16 inputs, before any rounding. A row that attends many keys
# has outputs far below 2e-2, so the first bar cannot see an error that is
# systematic there; this one scales with each row. Rounding P and the output
# to bf16 gives a few 1e-3; a plain stand-in that rounds P to fp8 instead
# must fail it (checked at every shape), so the bar is known to bite.
ROW_REL_TOL = 1e-2
# fp32 full-width forward, kernel vs plain attention: max |diff| <= LOGIT_RTOL * max |plain|
LOGIT_RTOL = 1e-5
TOP1_MIN = 0.99

# jamba-v0.1-52b, cut to one pattern unit (7 mamba layers, 1 attention layer)
JAMBA = "jamba_v01_52b"
JAMBA_LAYERS = 8
# the selective scan: tests/test_kernels.py MAMBA_CASES (B, T, Di, N, x/dt type,
# B/C type), then the jamba prefill shape and a ragged one (T and Di not
# multiples of the kernel's 16-step stage and 64-channel tile), both with B
# and C as strided slices of the x -> (dt, B, C) projection, as in the mixer
MAMBA_CASES = [
    (2, 128, 256, 16, "float32", "float32"),
    (1, 256, 512, 16, "float32", "float32"),
    (2, 64, 128, 8, "float32", "float32"),
    (1, 128, 256, 16, "bfloat16", "float32"),
]
MAMBA_PREFILL = (PREFILL_B, PREFILL_S, 8192, 16, "bfloat16", "bfloat16")
MAMBA_RAGGED = (2, 1000, 8100, 16, "bfloat16", "bfloat16")
MAMBA_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# a slow-decaying state, as the mixer is initialised (dt log-uniform in
# [1e-3, 1e-1], A = -(1 .. N)), in fp32: the state lasts hundreds of steps, so
# the plain scan with its state dropped every MAMBA_RESTART steps must fail
# the bar here
MAMBA_SLOW = (1, 2048, 256, 16, "float32", "float32")
MAMBA_RESTART = 128
# the special-function units' exponentials: 16 a clock on each of 132 SMs at
# the H100 SXM's 1.98 GHz boost clock
EXP_RATE = 16 * 132 * 1.98e9
# K2's instantiations on the paths (N <= 16, 4 lanes a channel), whose ptxas
# lines chip_smoke prints; no instantiation of csrc/mamba_scan.cu may spill
_K2_KERNELS = {f"{x}_{bc}": f"mamba_scan_kernelI{m}Li4EE"
               for (x, bc), m in {("float32", "float32"): "ff", ("float32", "bfloat16"): "f13__nv_bfloat16",
                                  ("bfloat16", "float32"): "13__nv_bfloat16f",
                                  ("bfloat16", "bfloat16"): "13__nv_bfloat16S1_"}.items()}
DT_RANK = 256  # jamba's dt_rank = d_model / 16
# flash attention at the jamba attention layer's shape
JAMBA_ATTN = (PREFILL_B, PREFILL_S, PREFILL_S, 32, 8, 128, True, None, None, 0, "bfloat16")
# the mamba mixer in fp32, kernel vs plain: max |diff| <= MIXER_RTOL * max |plain|
MIXER_RTOL = 2e-4

# xlstm-350m at full width and depth: 3 repeats of (mLSTM x7, sLSTM)
XLSTM = "xlstm_350m"
# the chunkwise mLSTM: tests/test_kernels.py MLSTM_CASES (B, T, H, D), the
# prefill shape (H 4, D 512) and a ragged T (1000 = 7 * 128 + 104 on the
# wgmma route, 15 * 64 + 40 on the CUDA-core one, masked in the kernel's last
# chunk), each in fp32 (the CUDA-core route) and bf16 (the wgmma route, D a
# multiple of 64). The plain version is the chunked scan at the route's own
# chunk or, where it does not divide T, at the largest chunk below it that
# does (125, 50); the quadratic oracle, which sums the gates over the whole
# sequence, holds the kernel's ragged T at short T only (tests/test_torch_cuda.py)
MLSTM_CASES = [(2, 128, 2, 64), (1, 256, 4, 64), (1, 128, 1, 128)]
MLSTM_PREFILL = (PREFILL_B, PREFILL_S, 4, 512)
MLSTM_RAGGED = (2, 1000, 4, 512)
# max |a - b| / (|b| + 1e-2): fp32 the bar of tests/test_kernels.py; bf16 one
# bf16 ulp of the output (2^-7 relative) on top
MLSTM_TOL = {"float32": 2e-3, "bfloat16": 1e-2}
# one fp32 mLSTM block, kernel vs plain: max |diff| <= BLOCK_RTOL * max |plain|
BLOCK_RTOL = 1e-4

# granite-moe-3b-a800m at full width and depth: 32 x (attention, MoE)
GRANITE = "granite_moe_3b_a800m"
# flash attention at the granite attention shape (every layer: 24/8 heads of 64, causal)
GRANITE_ATTN = (PREFILL_B, PREFILL_S, PREFILL_S, 24, 8, 64, True, None, None, 0, "bfloat16")
# K5 at mixtral's decode shape: streams, cache slots, kv heads, query heads a
# kv head, head dim (bf16); the slots filled: the decode cell's (~431 a step at
# the end of its window) and the whole cache; then one stream at a full cache
DECODE_ATTN_SHAPE = (64, 4096, 8, 4, 128)
DECODE_ATTN_FILLS = (431, 4096)
L2_BYTES = 50 * 2**20  # the H100's L2: a case that fits is timed from a warm L2

# K4: tests/test_kernels.py's gmm cases as (group sizes, K, N), every group one
# row block, then a ragged one (K and N multiples of 8 but of no tile; row
# blocks of 200 rows, cut into tiles of 128 and 72)
GMM_CASES = [([256] * 4, 256, 128), ([128] * 8, 512, 256), ([128] * 2, 128, 128),
             ([256, 128, 384], 256, 128)]
GMM_RAGGED = ([200] * 3, 200, 72)
# the wgmma route's persistent schedule: 50 x 3 x 3 = 450 tiles of 128 x 256,
# 3.4 waves of 132 SMs, K and N multiples of no tile
GMM_PERSISTENT = ([384] * 50, 136, 520)
# fp32 output: the bar of tests/test_kernels.py (sums in another order); bf16
# output: a sum near a rounding boundary may round the other way, one bf16 ulp
# (2^-8 relative) and some
GMM_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# one fp32 MoE layer, kernel vs plain: max |diff| <= MOE_RTOL * max |plain|
MOE_RTOL = 1e-5

# the remaining one-card configs (ROADMAP.md A.5), at their published widths
WHISPER = "whisper_base"
GEMMA12 = "gemma3_12b"
MIXTRAL = "mixtral_8x7b"
STABLELM = "stablelm_3b"
PHI3V = "phi3_vision_4_2b"
NEMOTRON = "nemotron_4_340b"
# mixtral-8x7b cut to 16 of its 32 one-layer units (46.9 GB in bf16: one stage
# of a two-stage pipeline); its fp32 check at 8 (47.5 GB)
MIXTRAL_LAYERS = 16
# nemotron-4-340b cut to 6 of its 96 one-layer units: 60.3 GB in bf16, the
# untied 256,000 x 18,432 embedding and unembedding 18.9 GB of it; a 7th layer
# (6.9 GB) would leave less than 6 GB free at the bf16 prefill's peak
NEMOTRON_LAYERS = 6
A5_LAYERS = {MIXTRAL: MIXTRAL_LAYERS, NEMOTRON: NEMOTRON_LAYERS}
# per config: the bf16 prefill's batch and text length, the fp32 check's depth
# (None: the config's) and text length. whisper: 8 clips of 30 s (1,500 encoder
# frames each) against Whisper's 448-token decoder context; phi-3-vision: 576
# patch embeddings before 2,048 text tokens; mixtral: one sequence past its
# 4,096 window (at B 2 x S 2,048 the window would not mask), its fp32 check at
# S 6,144, where the window masks the last 2,048 rows' first keys and the plain
# attention's (1, 32, 6144, 6144) fp32 scores leave room beside 47.5 GB;
# nemotron: one sequence of 4,096 (its fp32 logits 4.2 GB), its fp32 check at
# one layer (51.6 GB of fp32 weights) and S 2,048
A5_PREFILL = {
    WHISPER: (8, 448, None, 448),
    GEMMA12: (PREFILL_B, PREFILL_S, None, PREFILL_S),
    MIXTRAL: (1, 8192, 8, 6144),
    STABLELM: (PREFILL_B, PREFILL_S, None, PREFILL_S),
    PHI3V: (PREFILL_B, PREFILL_S, None, PREFILL_S),
    NEMOTRON: (1, 4096, 1, 2048),
}
# the bf16 top-1 comparison's text length where it is not the main path's:
# nemotron's plain attention at S 4,096 holds 96 heads of 4,096^2 fp32 scores
# and their softmax (12.9 GB) beside 60.3 GB of weights
A5_TOP1_S = {NEMOTRON: 2048}
# the most memory a phase may hold (GB of the card's 80): 6 GB left free
A5_PEAK_GB = {NEMOTRON: 74.0}
# flash attention at each shape these configs' main paths give it, bf16, and its
# launches a bf16 forward: whisper's encoder (non-causal, 1,500 frames, ragged
# against every tile), decoder self-attention (causal, 448) and cross-attention
# (non-causal, 448 against 1,500; in a decode step with ``enc_out``, 1 against
# 1,500); gemma3-12b's local (window 1,024) and global layers (GQA 2 in the
# D 256 tile); mixtral's window of 4,096 at S 8,192; stablelm's D 80 and
# phi-3-vision's D 96 over 576 + 2,048 positions (a ragged last tile);
# nemotron's GQA 96/8 at D 192 (the bf16 D 256 tile) over 4,096
A5_ATTN = {
    WHISPER: {"encoder": ((8, 1500, 1500, 8, 8, 64, False, None, None, 0, "bfloat16"), 6),
              "self": ((8, 448, 448, 8, 8, 64, True, None, None, 0, "bfloat16"), 6),
              "cross": ((8, 448, 1500, 8, 8, 64, False, None, None, 0, "bfloat16"), 6),
              "decode_cross": ((8, 1, 1500, 8, 8, 64, False, None, None, 0, "bfloat16"), 0)},
    GEMMA12: {"local": ((PREFILL_B, PREFILL_S, PREFILL_S, 16, 8, 256, True, 1024, None, 0, "bfloat16"), 40),
              "global": ((PREFILL_B, PREFILL_S, PREFILL_S, 16, 8, 256, True, None, None, 0, "bfloat16"), 8)},
    MIXTRAL: {"window": ((1, 8192, 8192, 32, 8, 128, True, 4096, None, 0, "bfloat16"), MIXTRAL_LAYERS)},
    STABLELM: {"causal": ((PREFILL_B, PREFILL_S, PREFILL_S, 32, 32, 80, True, None, None, 0, "bfloat16"), 32)},
    PHI3V: {"causal": ((PREFILL_B, 2624, 2624, 32, 32, 96, True, None, None, 0, "bfloat16"), 32)},
    NEMOTRON: {"causal": ((1, 4096, 4096, 96, 8, 192, True, None, None, 0, "bfloat16"),
                          NEMOTRON_LAYERS)},
}
# the fp32 check at the full depth where it fits (gemma3-12b: 47 GB), else the
# depth above; the decode check (fp32, 16 steps against forward) on the same
# parameters
A5_DECODE_STEPS = 16
# K5 against its plain version at each shape this script's decode paths give
# it: per config with self-attention, the fp32 decode phases' (one stream, a
# 32-slot cache, 16 steps) and the bf16 serve phases' (4 streams, 128 slots,
# 32 steps) at their first, last and a full cache: (streams, slots, dtype,
# fills); the sliding-window configs also over a full ring of their window
DECODE_ATTN_CONFIGS = ("gemma3_1b", GEMMA12, JAMBA, GRANITE, MIXTRAL, NEMOTRON, STABLELM, PHI3V, WHISPER)
DECODE_ATTN_PATHS = ((1, 32, "float32", (1, 16, 32)), (4, 128, "bfloat16", (1, 32, 128)))

# the logits product (ROADMAP.md A.P1) at gemma3-1b's prefill (B 2 x S 2,048
# rows against its tied 262,144 x 1,152 embedding) and nemotron's (1 x 4,096
# rows against its 256,000 x 18,432 unembedding): rows, vocabulary, d_model
LOGITS_SHAPES = {"gemma3_1b": (PREFILL_B * PREFILL_S, 262144, 1152),
                 NEMOTRON: (4096, 256000, 18432)}
LOGITS_RTOL = 1e-5  # the port's product against the upcast, of max |upcast|
LOGITS_EXACT_V = 32768  # vocabulary rows of the fp64 product the errors are read against

# the batched MIG simulator: tests/test_batched.py's agreement matrix
# (scenario, policy, repartition mode), 6 seeds a row at load 0.2, as
# tests/test_torch_sim.py and the golden file hold it
SIM_ROWS = [
    ("paper-diurnal", "daynight", "partial"),
    ("paper-diurnal", "static", "drain"),
    ("bursty-mmpp", "static", "partial"),
    ("bursty-mmpp", "daynight", "drain"),
    ("weekend-flat", "nomig", "partial"),
    ("weekend-flat", "daynight", "drain"),
    ("heavy-tail-lognormal", "static", "drain"),
    ("heavy-tail-lognormal", "nomig", "partial"),
]
SIM_SEEDS = range(6)
SIM_LOAD = 0.2
SIM_GOLDEN = ROOT / "tests" / "data" / "torch_sim_golden.json"
# the bars of tests/test_torch_sim.py as (rtol, atol) of |a - b| <= atol +
# rtol * |b|, None = exact: the card and the CPU run the same float32 ops and
# differ only in the order of the sums over J and over the slices
SIM_BARS = {
    "preemptions": None, "repartitions": None, "num_jobs": None,
    "energy_wh": (1e-5, 0.0), "busy_slot_minutes": (1e-5, 0.0),
    "tardiness_integral": (1e-4, 1e-3),
    "makespan_min": (0.0, 1e-3), "completion": (0.0, 1e-3), "util_histogram": (0.0, 1e-3),
}
# throughput, paper-diurnal under DayNight, partial, dt 0.5, as (rollouts,
# load_scale): (a) the RL training width of benchmarks/baselines/rl_batched.json
# (2048 episodes at loads 0.8-1.2), (b) the headline point of
# benchmarks/baselines/batched_agreement.json (the paper's overload regime)
# at 64 rollouts: the day's ~17,000 host-bound steps, not the width, set its time
SIM_SIZES = {"a": (2048, 1.0), "b": (64, 12.0)}
SIM_AGREEMENT = ROOT / "benchmarks" / "baselines" / "batched_agreement.json"
SIM_HELD = 8  # rollouts of (b) held to the port's CPU run
# steps of the window timed alone and under torch.profiler (its per-step
# launches, busy time and idle share); an eighth of a 512-step chunk, since
# gathering a whole chunk's ~150 k device events took the profiler ~30 s a size
SIM_PROFILED_STEPS = 64

# the on-device DQN trainer: the checked-in baseline (its parameters and
# params_probe) and the golden file that tests/test_torch_rl.py and
# tests/test_torch_rl_train.py write from the JAX reference
RL_BASELINE = ROOT / "benchmarks" / "baselines" / "rl_batched.json"
RL_PARAMS = ROOT / "benchmarks" / "baselines" / "rl_dqn_params.npz"
RL_GOLDEN = ROOT / "tests" / "data" / "torch_rl_golden.json"
# one TD update on an identical batch (DESIGN.md §11); the round's rewards
# and the replay's copies of them (tests/test_torch_rl_train.py)
RL_TD_TOL = 1e-5
RL_FLOAT_TOL = 1e-6
# the env's float64 rewards: 1e-6 relative, or the reward of 2 float32 ulps of
# the energy and tardiness accumulators (tests/test_torch_rl.py)
RL_REWARD_RTOL = 1e-6
RL_ROUNDS = 2  # rl_train: rounds of 64 episodes at the baseline's width
RL_PROFILED = 4  # decisions of rl_train's profile

# the paper's host trainer (train_rl --backend host, examples/
# dynamic_repartitioning_day.py's configuration) for 4 episodes, 2 guided, on
# the card and, in a child process beside it, on the CPU from the same initial
# parameters; the episodes are held to each other up to the first greedy flip
RL_HOST_EPISODES = 4
RL_HOST_GUIDE = 2
RL_HOST_PROFILED = 50  # decisions under torch.profiler, updates on
RL_HOST_REWARD_RTOL = 1e-9  # float64 host rewards while the actions agree
# every RL_HOST_STEP_EVERY-th TD update of the card's run is repeated on the
# CPU from the card's state and batch (DESIGN.md §11's 1e-5): two independent
# runs part after some hundreds of updates, as a one-ulp change to one initial
# weight makes two CPU runs part (fp32 rounding, amplified by Adam and the
# bootstrapped targets), so the trajectory is held update by update
RL_HOST_STEP_EVERY = 100

# the evaluation path: the checked-in sweep rows it replays, at the reference's
# baseline tolerance (python -m repro.sweep --check-baseline's --rtol); the
# last three are fleet rows (the fleet layer)
EVAL_FILES = [ROOT / "benchmarks" / "baselines" / f"{name}.jsonl" for name in
              ("smoke_sweep", "scenario_matrix", "repartition_policies", "repartition_modes",
               "fleet_scaling", "dispatchers", "serving_matrix")]
# evaluate_policy_fleet with the checked-in npz as the registry's "dqn" on
# 2xA100+2xA30, state-aware, 4 paper-diurnal days (tests/test_torch_fleet.py)
FLEET_GOLDEN = ROOT / "tests" / "data" / "torch_fleet_golden.json"
EVAL_RTOL = 1e-9
EVAL_FORECAST_GOLDEN = ROOT / "tests" / "data" / "torch_eval_forecast_golden.json"
EVAL_RACE_SCALE = 0.1  # rl_batched.json's scale
EVAL_TABLE3_SCALE = 1.0
# the multi-tenant-serving day (tests/test_torch_serving.py, the cell of the
# reference's tests/test_serving.py::_serving_cell at a whole day, load 1.0),
# once per scheduler, against the reference's results in the golden file
SERVING_GOLDEN = ROOT / "tests" / "data" / "torch_serving_golden.json"
SERVING_CELL = {"experiment": "t", "group": "g", "seed": 11, "scenario": "multi-tenant-serving",
                "scenario_kwargs": {"horizon_min": 1440.0, "load_scale": 1.0},
                "policy": "static", "policy_kwargs": {"config_id": 3}}

# the sweep engine: the seven checked-in baselines (grid -> file stem) at the
# scale they were written at, and the worker processes of every sweep phase
BASELINES_DIR = ROOT / "benchmarks" / "baselines"
SWEEP_BASELINES = {"smoke": "smoke_sweep", "scenario_matrix": "scenario_matrix",
                   "repartition_policies": "repartition_policies", "repartition_modes": "repartition_modes",
                   "fleet_scaling": "fleet_scaling", "dispatchers": "dispatchers",
                   "serving_matrix": "serving_matrix"}
SWEEP_BASELINE_SCALE = 0.1
SWEEP_WORKERS = min(8, os.cpu_count() or 1)

# the training path: card against CPU at each ported arch's smoke config in
# fp32 (granite with 2 microbatches), one step from a non-zero optimiser state
TRAIN_PARITY_ARCHS = [("gemma3_1b", 1), (JAMBA, 1), (XLSTM, 1), (GRANITE, 2)]
TRAIN_PARITY_SHAPE = (4, 64)  # global batch, sequence
TRAIN_PARITY_LR = (1e-3, 1, 4)  # linear_warmup_cosine(base, warm-up, total)
TRAIN_RTOL = 1e-5  # loss and grad_norm, relative
TRAIN_PARAM_TOL = 1e-5  # every updated parameter, of its leaf's largest
TRAIN_STATE_TOL = 1e-4  # m and v, of their leaf's largest (the gradients' bar)
# gemma3-1b at full width and depth, the reference driver's defaults; resumed
# from its step-3 checkpoint, steps 4-6 again
TRAIN_ARCH = "gemma3_1b"
TRAIN_SMOKE = False
TRAIN_ARGS = {"steps": 6, "global_batch": 8, "seq_len": 256, "accum_steps": 1, "ckpt_every": 3}
TRAIN_RESUME_RTOL = 1e-3

# the dry-run on the production mesh of 256 H100s (a fake process group, fake
# tensors: per-card sizes are modelled), in child processes that do not see
# the card; and the 1x1-mesh counts of this script's gemma3-1b prefill and
# train step, read against the times those phases measure
DRYRUN_CELLS = [("gemma3-1b", "train_4k"), ("nemotron-4-340b", "train_4k"),
                ("nemotron-4-340b", "decode_32k"), ("mixtral-8x7b", "decode_32k"),
                ("jamba-v0.1-52b", "long_500k"), ("nemotron-4-340b", "long_500k")]
# repro/launch/shapes.py SKIP_REASONS, the reference's reason
NEMOTRON_LONG_SKIP = "pure full attention (quadratic prefill, O(seq) full-KV decode)"
ROOFLINE_STEPS = {"prefill": ("prefill", 2048, 2), "train": ("train", 256, 8)}
SHARDED_ARCH = "gemma3_1b"  # its smoke config on a 1x1 mesh of an NCCL world of one
SHARDED_SHAPE = (8, 64, 2)  # global batch, sequence, accumulation
MEASURED = {}  # times the phases measure that the roofline line reads


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``at_s`` is the script's seconds when it ended."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - T0}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch.device import resolve_device

    phase_lint()
    dev = resolve_device()
    smi = phase_device(torch)
    fa_row = phase_kernels(torch, dev)
    gemma_fa = phase_prefill(torch, dev)
    phase_decode(torch, dev)
    phase_serve(torch)
    phase_profile(torch, dev)

    ms_row, jamba_fa = phase_jamba_kernels(torch, dev)
    launches = phase_jamba_prefill(torch, dev)
    phase_jamba_decode(torch, dev)
    phase_jamba_serve(torch)
    ml_row = phase_xlstm_kernels(torch, dev)
    ml_row["launches"] = phase_xlstm_prefill(torch, dev)["mlstm"]
    phase_xlstm_decode(torch, dev)
    phase_xlstm_serve(torch)
    gmm_row, gmm_paths = phase_gmm_kernels(torch, dev)
    da_row = phase_decode_attention(torch, dev)
    granite_fa = phase_granite_attention(torch, dev)
    granite = phase_granite_prefill(torch, dev)
    phase_granite_decode(torch, dev)
    phase_granite_serve(torch)
    phase_logits_product(torch, dev)
    a5_fa = phase_a5_attention(torch, dev)
    a5 = {name: phase_a5_model(torch, dev, name) for name in A5_PREFILL}
    phase_sim_throughput(torch)
    phase_rl_parity(torch)
    phase_rl_train(torch)
    phase_rl_host_train(torch)
    phase_eval_replay(torch)
    # the registered policies of evaluate_policy(_fleet) go through the sweep
    # cache, which lands in the working directory
    with _sweep_golden().working_dir():
        phase_fleet_dqn(torch)
    with _sweep_golden().working_dir():
        phase_eval_race(torch)
    phase_eval_table3(torch)
    phase_serving_day(torch)
    phase_sweep_baselines(torch)
    phase_sweep_paper(torch)
    phase_sweep_batched(torch)
    phase_train_parity(torch)
    phase_train(torch)
    # the service's child processes first: each spends ~8 s importing torch,
    # which the pod's day covers
    children = _service_children()
    try:
        phase_cluster_day(torch)
    except BaseException:
        _stop_children(children)
        raise
    phase_service(torch, children)
    # the dry-run's children trace on the CPU only; they start after the last
    # timed phase, so that no phase's times share the host's cores with them,
    # and run beside the checks of bits that close the script
    dry_pool, dry_futs = _dryrun_children()
    phase_sharded_step(torch)
    phase_sim_parity(torch)
    phase_dryrun(torch, dry_pool, dry_futs)
    ms_row["launches"] = launches["mamba_scan"]
    jamba_fa["launches"] = launches["flash_attention"]
    granite_fa["launches"] = granite["flash_attention"]
    # K4's row holds its first path's numbers (granite, per launch over a
    # forward's 96); the jamba and mixtral paths' stand beside them under by_path
    gmm_paths[GRANITE]["launches"] = granite["gmm"]
    gmm_paths[JAMBA]["launches"] = launches["gmm"]
    gmm_paths[MIXTRAL]["launches"] = a5[MIXTRAL]["gmm"]
    gmm_row.update({k: gmm_paths[GRANITE][k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by", "library_ms")})
    gmm_row["by_path"] = gmm_paths
    # flash attention's row keeps its first path's numbers (gemma3-1b, per launch
    # over a forward's 26); the other paths' stand beside them under by_path
    fa_row.update({k: gemma_fa[k] for k in ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "tflops")})
    gemma_fa["max_abs_err"] = fa_row["max_abs_err"]
    for name, row in a5_fa.items():
        row["launches"] = a5[name]["flash_attention"]
    fa_row["by_path"] = {"gemma3_1b": gemma_fa, JAMBA: jamba_fa, GRANITE: granite_fa, **a5_fa}

    print(smi, flush=True)
    print(json.dumps({"kernels": [fa_row, ms_row, ml_row, gmm_row, da_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# ------------------------------- phases -------------------------------------


LINT_MAX_S = 10.0


def phase_lint() -> None:
    """R1-R4 of ``repro_torch.lint`` over this checkout; any unwaived finding fails."""
    from repro_torch.lint import lint_repo

    t0 = time.perf_counter()
    report = lint_repo(root=str(ROOT))
    seconds = time.perf_counter() - t0
    unwaived = [v for v in report.violations if not v.waived]
    emit("lint", files=report.files_checked, unwaived=len(unwaived),
         waived=len(report.violations) - len(unwaived), seconds=seconds,
         exit_code=report.exit_code,
         findings=[f"{v.path}:{v.line}: {v.rule} {v.message}" for v in unwaived[:20]])
    check(report.files_checked > 100, f"lint checked {report.files_checked} files, expected > 100")
    check(not unwaived and report.exit_code == 0,
          f"repro_torch.lint: {len(unwaived)} unwaived finding(s), exit {report.exit_code}")
    check(seconds < LINT_MAX_S, f"lint took {seconds:.2f} s, limit {LINT_MAX_S}")


def _reset_counts():
    """Every kernel's launch count to 0, just before a main path is driven."""
    import repro_torch.kernels.decode_attention as da
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.gmm as gk
    import repro_torch.kernels.mamba_scan as ms
    import repro_torch.kernels.mlstm as ml

    fa.LAUNCHES = ms.LAUNCHES = ml.LAUNCHES = gk.LAUNCHES = da.LAUNCHES = 0


def _counts() -> dict:
    import repro_torch.kernels.decode_attention as da
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.gmm as gk
    import repro_torch.kernels.mamba_scan as ms
    import repro_torch.kernels.mlstm as ml

    return {"flash_attention": fa.LAUNCHES, "mamba_scan": ms.LAUNCHES, "mlstm": ml.LAUNCHES,
            "gmm": gk.LAUNCHES, "decode_attention": da.LAUNCHES}


def _check_decode_counts(counts: dict, cfg, steps: int, what: str) -> None:
    """The launches of ``steps`` decode steps of a config with no
    cross-attention: K5 once a self-attention layer a step (one split: these
    caches fill at most 32 slots, one tile), K4 three times an MoE layer a
    step, no other kernel (the mamba mixer's one-token step is plain torch)."""
    n_moe = sum(m for _, m in cfg.pattern_unit()) * cfg.num_pattern_repeats
    want = {"flash_attention": 0, "mamba_scan": 0, "mlstm": 0, "gmm": 3 * n_moe * steps,
            "decode_attention": _n_attention(cfg) * steps}
    check(counts == want, f"{what} launched {counts}, expected {want}")


def phase_device(torch) -> str:
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIMS, smem_bytes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    emit(
        "device",
        nvidia_smi=smi,
        kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        python=sys.version.split()[0],
        build_wall_s=wall,
        builds={b.name: {"seconds": b.seconds, "cached": b.cached, "ptxas": b.ptxas}
                for b in built.values()},
        flash_attention_smem_bytes={str(dt).removeprefix("torch."): {d: smem_bytes(d, dt) for d in HEAD_DIMS}
                                    for dt in (torch.float32, torch.bfloat16)},
        # K1's bf16 route, per tile D: ptxas's registers at launch (the
        # consumers take 240, or 104 at D 64, by setmaxnreg) and spills
        flash_attention_wgmma_ptxas=_wgmma_ptxas(built["flash_attention"].ptxas, {
            d: f"fa_fwd_wgmma_kernelILi{d}E" for d in ("64", "128", "256")}),
    )
    return smi


def _wgmma_ptxas(lines, kernels) -> dict:
    """The ptxas lines (``_build.Built.ptxas``) of each kernel of ``kernels``
    (label: a fragment of its mangled name)."""
    out, label = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            label = next((k for k, frag in kernels.items() if frag in ln), None)
        elif label is not None:
            out.setdefault(label, []).append(ln)
    return out


def _qkv(torch, dev, case, seed):
    B, Sq, Sk, Hq, Hkv, D, *_, dtype = case
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dt)

    return t(B, Sq, Hq, D), t(B, Sk, Hkv, D), t(B, Sk, Hkv, D)


def _kw(case):
    causal, window, softcap, q_offset = case[6:10]
    return {"causal": causal, "window": window, "softcap": softcap, "q_offset": q_offset}


def phase_kernels(torch, dev) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    rows, gemma_err = [], 0.0
    cases = [(f"attn_case_{i}", c) for i, c in enumerate(ATTN_CASES)]
    cases += [(f"attn_case_{i}_bf16", c[:-1] + ("bfloat16",)) for i, c in enumerate(ATTN_CASES)
              if c[-1] == "float32"]
    cases += [(f"head_dim_{c[5]}_case_{i}", c) for i, c in enumerate(ODD_D_CASES)]
    cases += [(f"head_dim_{c[5]}_case_{i}_bf16", c[:-1] + ("bfloat16",)) for i, c in enumerate(ODD_D_CASES)]
    cases += [(f"gemma3_1b_{k}", c) for k, c in GEMMA_SHAPES.items()]
    for seed, (name, case) in enumerate(cases):
        q, k, v = _qkv(torch, dev, case, seed)
        out = flash_attention(q, k, v, **_kw(case))
        ref = attention_ref(q, k, v, **_kw(case))
        torch.cuda.synchronize()
        tol = TOL[case[-1]]
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))
        rel = _bf16_row_rel(torch, q, k, v, case, out) if case[-1] == "bfloat16" else {"ok": True}
        ok = ok and rel.pop("ok")
        rows.append({"case": name, "shape": case[:6], "dtype": case[-1], "max_abs_err": err,
                     "tol": tol, **rel, "ok": ok})
        del q, k, v, out, ref
        if name.startswith("gemma"):
            gemma_err = max(gemma_err, err)
    epilogue = [_head_dim_epilogue(torch, dev, dtype) for dtype in ("float32", "bfloat16")]
    head_dims = {name: _fa_at_shape(torch, dev, case, seed=200 + i)
                 for i, (name, case) in enumerate(ODD_D_SHAPES.items())}
    emit("kernels", cases=rows, head_dim_80_epilogue=epilogue, head_dim_shapes=head_dims)
    check(all(r["ok"] for r in rows), "flash_attention disagrees with attention_ref: "
          f"{[r for r in rows if not r['ok']]}")
    check(all(r["ok"] for r in epilogue), f"flash_attention at D 80 wrote past its head dim: {epilogue}")
    check(all(r.pop("ok") for r in head_dims.values()),
          f"flash_attention disagrees with attention_ref at a head-dim shape: {head_dims}")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:157",
        "max_abs_err": gemma_err,
    }


def _head_dim_epilogue(torch, dev, dtype) -> dict:
    """D 80 runs in the D 128 tile: q, k, v as strided views of one fused
    projection, the output a view of a buffer with one more head past it,
    whose bytes must stay as they were (the padding's 48 columns of every
    row would land on the next head's)."""
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 150, 6, 80)).astype(np.float32)).to(dev, getattr(torch, dtype))
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    p = fa.plan(q, k, v)
    n = q.numel()
    buf = torch.full((n + 80,), 7.0, dtype=q.dtype, device=dev)
    out = buf[:n].view(q.shape)
    fa._launch(q, k, v, out, p, causal=True, window=None, softcap=None, q_offset=0, scale=None)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    untouched = bool(torch.equal(buf[n:], torch.full_like(buf[n:], 7.0)))
    tol = TOL[dtype]
    err = (out.float() - ref.float()).abs().max().item()
    return {"dtype": dtype, "route": p.route, "head_dim": p.head_dim, "tile_d": p.tile_d,
            "neighbour_untouched": untouched, "max_abs_err": err, "tol": tol,
            "ok": untouched and bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))}


def _row_rel(torch, out, exact) -> float:
    """Largest |out - exact| / |exact| over rows (norms over the last axis); a
    row whose exact value is 0 must be 0."""
    diff = (out.float() - exact).norm(dim=-1)
    return (diff / exact.norm(dim=-1).clamp_min(1e-30)).max().item()


def _attention_p_rounded(torch, q, k, v, case, p_dtype):
    """Plain attention in fp32 that rounds the unnormalised probabilities P to
    ``p_dtype`` before P·V and sums the row's weights from P unrounded, as the
    bf16 route does; the output in bf16. A stand-in for the second bar only."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    causal, window, softcap, q_offset = case[6:10]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(B, Sq, Hkv, Hq // Hkv, D), k.float())
    s = s / D ** 0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True).clamp_min(-1e30))
    del s
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), v.float())
    o = torch.where(l > 0, o / l.clamp_min(1e-30), 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(torch.bfloat16)


def _bf16_row_rel(torch, q, k, v, case, out) -> dict:
    """The second bf16 bar (ROW_REL_TOL) for K1's output ``out`` on q, k, v,
    beside the readings of the plain stand-in with P in bf16 (what the kernel
    should read) and in fp8 (the control, which must fail the bar)."""
    from repro_torch.kernels.ref import attention_ref

    exact = attention_ref(q.float(), k.float(), v.float(), **_kw(case))
    rel = _row_rel(torch, out, exact)
    stand_in = _row_rel(torch, _attention_p_rounded(torch, q, k, v, case, torch.bfloat16), exact)
    control = _row_rel(torch, _attention_p_rounded(torch, q, k, v, case, torch.float8_e4m3fn), exact)
    return {"row_rel_err": rel, "row_rel_tol": ROW_REL_TOL, "row_rel_stand_in_bf16_p": stand_in,
            "row_rel_control_fp8_p": control, "ok": rel <= ROW_REL_TOL < control}


def _cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, iters=20, warmup=3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's cost of each call (the wrapper's checks,
    the allocation, the launch) is not timed. The decode shapes' kernels run
    in less time than that host cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attended_pairs(Sq, Sk, causal, window, q_offset) -> int:
    q = np.arange(Sq)[:, None] + q_offset
    k = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    return int(ok.sum())


def _bound_ms(case):
    """Least time for this call: each input read once, the output written once,
    4*D FLOP per attended (q, k) pair, at the peak rates for the input type."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, _, q_offset, dtype = case
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * D * (2 * B * Sq * Hq + 2 * B * Sk * Hkv)
    flops = 4 * D * B * Hq * _attended_pairs(Sq, Sk, causal, window, q_offset)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def _sdpa(torch, q, k, v, case):
    """torch's fused attention on the same function, as a yardstick only."""
    import torch.nn.functional as F

    Sq, Sk, causal, window = case[1], case[2], case[6], case[7]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_prefill(torch, dev) -> dict:
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import forward, init_params

    cfg = get_config("gemma3_1b")
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}

    with torch.inference_mode():
        # fp32: the kernel against the plain attention through the whole model
        params = init_params(cfg32, seed=0)
        before = fa.LAUNCHES
        lk, _ = forward(cfg32, params, batch, impl="auto")
        torch.cuda.synchronize()
        launches32 = fa.LAUNCHES - before
        lr, _ = forward(cfg32, params, batch, impl="ref")
        err32 = (lk - lr).abs().max().item()
        scale32 = lr.abs().max().item()
        del lk, lr, params
        torch.cuda.empty_cache()
        check(launches32 == cfg.n_layers, f"fp32 forward launched the kernel {launches32} times")
        check(err32 <= LOGIT_RTOL * scale32,
              f"fp32 logits kernel vs plain: {err32} > {LOGIT_RTOL} * {scale32}")

        # bf16, the serving dtype: the main path, counted from 0
        params = init_params(cfg, seed=0)
        forward(cfg, params, batch)  # warm-up (cuBLAS handles, kernel load)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        lk, _ = forward(cfg, params, batch)
        torch.cuda.synchronize()
        prefill_runs_s = [time.perf_counter() - t0]
        counts = _counts()
        for _ in range(PREFILL_TIMED - 1):  # more timed forwards, after the counts are read
            t0 = time.perf_counter()
            forward(cfg, params, batch)
            torch.cuda.synchronize()
            prefill_runs_s.append(time.perf_counter() - t0)
        prefill_s = float(np.median(prefill_runs_s))
        MEASURED["prefill_ms"] = prefill_s * 1e3
        launches = counts["flash_attention"]
        lr, _ = forward(cfg, params, batch, impl="ref")
        finite = bool(torch.isfinite(lk).all())
        top1 = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
        err16 = (lk - lr).abs().max().item()
        del lk, lr, params
        torch.cuda.empty_cache()
    check(launches == cfg.n_layers, f"bf16 forward launched the kernel {launches} times, not 26")
    check(counts["mamba_scan"] == counts["mlstm"] == counts["gmm"] == 0,
          f"gemma3-1b forward launched another kernel than flash attention: {counts}")
    check(finite, "bf16 logits are not finite")
    check(top1 >= TOP1_MIN, f"bf16 top-1 agreement kernel vs plain {top1} < {TOP1_MIN}")

    # the kernel at the two prefill shapes: kernel, plain and library times vs bound
    shapes = {}
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "flops": 0, "bytes": 0}
    for name, case in GEMMA_SHAPES.items():
        q, k, v = _qkv(torch, dev, case, seed=100)
        kw = _kw(case)
        kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        ms = _graph_ms(torch, kernel)
        plain_ms = _cuda_ms(torch, lambda: attention_ref(q, k, v, **kw))
        lib = _sdpa(torch, q, k, v, case)
        lib_err = (lib().transpose(1, 2).float() - attention_ref(q, k, v, **kw).float()).abs().max().item()
        library_ms = _graph_ms(torch, lib)
        bound_ms, bound_by, flops, nbytes = _bound_ms(case)
        shapes[name] = {"ms": ms, "ms_eager": _cuda_ms(torch, kernel), "plain_ms": plain_ms,
                        "library_ms": library_ms, "library_ms_eager": _cuda_ms(torch, lib),
                        "library_max_abs_err": lib_err, "bound_ms": bound_ms,
                        "bound_by": bound_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                        "tflops": flops / ms / 1e9}
        n = LAYERS_PER_FORWARD[name]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            agg[key] += n * shapes[name][key]
        agg["flops"] += n * flops
        agg["bytes"] += n * nbytes
    emit(
        "prefill",
        B=PREFILL_B, S=PREFILL_S,
        fp32_launches=launches32, fp32_logit_max_abs_err=err32, fp32_logit_max_abs=scale32,
        fp32_tol=f"max|diff| <= {LOGIT_RTOL} * max|plain|",
        bf16_launches=launches, bf16_top1_agreement=top1, bf16_logit_max_abs_err=err16,
        prefill_s=prefill_s, prefill_runs_s=prefill_runs_s,
        prefill_tok_per_s=PREFILL_B * PREFILL_S / prefill_s,
        kernel_ms_per_forward=agg["ms"], kernel_shapes=shapes,
    )
    n_calls = sum(LAYERS_PER_FORWARD.values())
    t_ops, t_bytes = agg["flops"] / PEAK_FLOPS["bfloat16"] * 1e3, agg["bytes"] / PEAK_BYTES * 1e3
    # per launch, averaged over the 26 launches of one forward at their shapes
    return {
        "launches": launches,
        "ms": agg["ms"] / n_calls,
        "plain_ms": agg["plain_ms"] / n_calls,
        "bound_ms": agg["bound_ms"] / n_calls,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": agg["library_ms"] / n_calls,
        "tflops": agg["flops"] / agg["ms"] / 1e9,
    }


def phase_decode(torch, dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_cache, init_params

    cfg = dataclasses.replace(get_config("gemma3_1b"), dtype="float32", param_dtype="float32")
    S = 16
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, S)), device=dev)
    with torch.inference_mode():
        params = init_params(cfg, seed=1)
        full, _ = forward(cfg, params, {"tokens": tokens})
        cache = init_cache(cfg, 1, 32)
        steps = []
        torch.cuda.synchronize()
        _reset_counts()
        for i in range(S):
            lg, cache = decode_step(cfg, params, cache, tokens[:, i : i + 1], i)
            steps.append(lg[:, 0])
        counts = _counts()
        dec = torch.stack(steps, dim=1)
        err = (dec - full).abs().max().item()
        err_last = (dec[:, -1] - full[:, -1]).abs().max().item()
        # the bar of tests/test_models.py::test_decode_matches_forward
        ok = bool(torch.allclose(dec, full, atol=2e-2, rtol=2e-2))
        del params, cache, full, dec
        torch.cuda.empty_cache()
    emit("decode", steps=S, max_abs_err=err, last_step_max_abs_err=err_last, tol="atol=rtol=2e-2",
         launches=counts)
    check(ok, f"decode_step logits disagree with forward: max abs err {err}")
    _check_decode_counts(counts, cfg, S, "gemma3-1b decode")


def _profile(torch, fn, top=8, groups=None, host_ops=True) -> dict:
    """Device time by kernel over one call of ``fn``, and the device's idle share
    of the call's wall time (torch.profiler; null where it saw no device time).
    ``groups`` maps a label to name fragments: the device time of every kernel
    whose name holds one of them is summed under ``group_ms``. ``host_ops=False``
    records the device's activity alone, for a call of ~10^5 launches whose
    host-side op events would take the profiler a minute to gather."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms or None,
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "kernels": len(rows),
        "launches": sum(r[1] for r in rows),
        "top": [{"kernel": k[:90], "ms": ms, "calls": n} for ms, n, k in rows[:top]],
        **({"group_ms": {label: sum(ms for ms, _, k in rows if any(f in k for f in frags))
                         for label, frags in groups.items()}} if groups else {}),
    }


def phase_profile(torch, dev) -> None:
    """Where the time goes: one bf16 prefill forward and 4 decode steps (batch 4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_cache, init_params

    cfg = get_config("gemma3_1b")
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S)), device=dev)
    with torch.inference_mode():
        params = init_params(cfg, seed=0)
        forward(cfg, params, {"tokens": tokens})  # warm-up
        prefill = _profile(torch, lambda: forward(cfg, params, {"tokens": tokens}))
        cache = init_cache(cfg, 4, 128)
        tok = tokens[:, :1].repeat(2, 1)
        decode_step(cfg, params, cache, tok, 0)  # warm-up

        def four_steps():
            for i in range(1, 5):
                decode_step(cfg, params, cache, tok, i)

        decode = _profile(torch, four_steps)
        del params, cache
        torch.cuda.empty_cache()
    emit("profile", prefill_forward=prefill, decode_4_steps=decode)


def phase_serve(torch) -> None:
    from repro_torch.launch.serve import serve

    from repro_torch.configs import get_config

    batch, steps = 4, 32
    _reset_counts()
    tps = serve("gemma3_1b", smoke=False, batch=batch, steps=steps, max_len=128, verbose=False)
    counts = _counts()
    emit("serve", batch=batch, steps=steps, tok_per_s=tps, ms_per_step=batch / tps * 1e3, launches=counts)
    check(tps > 0, "serve returned no rate")
    _check_decode_counts(counts, get_config("gemma3_1b"), steps, "gemma3-1b serve")


# ------------------------------ jamba phases ---------------------------------


def _scan_inputs(torch, dev, case, seed, strided_bc, slow=False):
    """The inputs of tests/test_kernels.py (dt = softplus(n) * 0.1, A = -exp(0.5 n));
    with ``strided_bc`` B and C are slices of one (B, T, dt_rank + 2N) tensor;
    with ``slow`` dt is log-uniform in [1e-3, 1e-1] and A = -(1 .. N)."""
    Bsz, T, Di, N, xdt, bcdt = case
    rng = np.random.default_rng(seed)

    def t(*shape, dtype="float32"):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, getattr(torch, dtype))

    x = t(Bsz, T, Di, dtype=xdt)
    if slow:
        dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (Bsz, T, Di))).astype(np.float32))
        dt = dt.to(dev, x.dtype)
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(Di, 1)
    else:
        dt = (torch.nn.functional.softplus(t(Bsz, T, Di)) * 0.1).to(x.dtype)
        A = -torch.exp(t(Di, N) * 0.5)
    if strided_bc:
        xdbc = t(Bsz, T, DT_RANK + 2 * N, dtype=bcdt)
        Bm, Cm = xdbc[..., DT_RANK : DT_RANK + N], xdbc[..., DT_RANK + N :]
    else:
        Bm, Cm = t(Bsz, T, N, dtype=bcdt), t(Bsz, T, N, dtype=bcdt)
    return x, dt, A, Bm, Cm, t(Di)


def _scan_bound(case):
    """Least time of one scan: x, dt, B, C, A, D read once and y written once
    over HBM, and 7 fp32 operations per (b, t, d, n) (dt*A, exp, dt*x*B, the
    two state terms, h*C and its sum) plus 3 per (b, t, d) (dt*x, D*x, the
    add) over the fp32 CUDA-core rate.

    Beside it, the exponential floor: a kernel that takes one hardware
    exponential per (b, t, d, n) spends at least B*T*Di*N of them over the
    special-function units' rate (``EXP_RATE``: 16 a clock an SM), 0.128 ms
    at jamba's prefill shape, twice the bytes bound."""
    Bsz, T, Di, N, xdt, bcdt = case
    xs, bs = (2 if xdt == "bfloat16" else 4), (2 if bcdt == "bfloat16" else 4)
    nbytes = 3 * Bsz * T * Di * xs + 2 * Bsz * T * N * bs + 4 * (Di * N + Di)
    ops = 7 * Bsz * T * Di * N + 3 * Bsz * T * Di
    t_ops, t_bytes = ops / PEAK_FLOPS["float32"] * 1e3, nbytes / PEAK_BYTES * 1e3
    exps = Bsz * T * Di * N
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes, "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
            "exp_floor_ms": exps / EXP_RATE * 1e3}


def _fa_at_shape(torch, dev, case, seed) -> dict:
    """K1 against attention_ref at one path's attention shape (both bf16 bars),
    with its kernel (in a CUDA graph, and eager), plain, torch's fused
    attention and bound times."""
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    q, k, v = _qkv(torch, dev, case, seed)
    kw = _kw(case)
    out, ref = fa.flash_attention(q, k, v, **kw), attention_ref(q, k, v, **kw)
    tol = TOL[case[-1]]
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))
    del ref
    rel = _bf16_row_rel(torch, q, k, v, case, out)
    ok = ok and rel.pop("ok")
    del out
    bound, by, flops, _ = _bound_ms(case)
    kernel, lib = (lambda: fa.flash_attention(q, k, v, **kw)), _sdpa(torch, q, k, v, case)
    ms = _graph_ms(torch, kernel)
    row = {
        "shape": case[:6], "dtype": case[-1], "max_abs_err": err, "tol": tol, **rel, "ok": ok,
        "ms": ms,
        "ms_eager": _cuda_ms(torch, kernel),
        "plain_ms": _cuda_ms(torch, lambda: attention_ref(q, k, v, **kw), iters=5, warmup=1),
        "library_ms": _graph_ms(torch, lib),
        "library_ms_eager": _cuda_ms(torch, lib),
        "bound_ms": bound,
        "bound_by": by,
        "gflop": flops / 1e9,
        "tflops": flops / ms / 1e9,
    }
    del q, k, v
    torch.cuda.empty_cache()
    return row


def phase_jamba_kernels(torch, dev):
    """K2 against its plain version on every case, with its grid, kernel
    (CUDA graph, and eager), plain, bound and exponential-floor times; the
    slow-decay case beside the plain scan that drops its state; its ptxas; K1
    at the jamba attention shape."""
    import repro_torch.kernels.mamba_scan as ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import mamba_scan_ref

    rows = []
    cases = [(f"mamba_case_{i}", c, False, False) for i, c in enumerate(MAMBA_CASES)]
    cases += [("jamba_prefill", MAMBA_PREFILL, True, False), ("ragged", MAMBA_RAGGED, True, False),
              ("slow_decay", MAMBA_SLOW, False, True)]
    for seed, (name, case, strided, slow) in enumerate(cases):
        args = _scan_inputs(torch, dev, case, seed, strided, slow)
        p = ms.plan(*args)
        out, ref = ms.mamba_scan(*args), mamba_scan_ref(*args)
        torch.cuda.synchronize()
        tol = MAMBA_TOL[case[4]]
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))
        row = {"case": name, "shape": case[:4], "dtype": case[4:], "blocks": p.blocks, "max_abs_err": err,
               "tol": tol, "ok": ok,
               "ms": _graph_ms(torch, lambda a=args: ms.mamba_scan(*a)),
               "ms_eager": _cuda_ms(torch, lambda a=args: ms.mamba_scan(*a)),
               "plain_ms": _cuda_ms(torch, lambda a=args: mamba_scan_ref(*a), iters=3, warmup=1),
               **_scan_bound(case)}
        if slow:
            # the control: the plain scan restarted from 0 every MAMBA_RESTART steps
            x, dt, A, Bm, Cm, D = args
            r = MAMBA_RESTART
            dropped = torch.cat([mamba_scan_ref(x[:, s : s + r], dt[:, s : s + r], A, Bm[:, s : s + r],
                                                Cm[:, s : s + r], D) for s in range(0, case[1], r)], dim=1)
            row.update(control_dropped_state_max_abs_err=(dropped - ref).abs().max().item(),
                       control_dropped_state_fails=not bool(torch.allclose(dropped, ref, atol=tol, rtol=tol)))
            row["ok"] = ok and row["control_dropped_state_fails"]
            del dropped
        rows.append(row)
        del args, out, ref
    lines = _build.build_all()["mamba_scan"].ptxas
    ptxas = _wgmma_ptxas(lines, _K2_KERNELS)
    check(all(r["ok"] for r in rows), f"mamba_scan disagrees with mamba_scan_ref: {rows}")
    check(set(ptxas) == set(_K2_KERNELS) and all("0 bytes spill stores, 0 bytes spill loads" in ln
                                                 for ln in lines if "spill" in ln),
          f"the mamba_scan kernels spill or are missing: {ptxas}")

    prefill = next(r for r in rows if r["case"] == "jamba_prefill")
    ms_row = {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:91",
        "max_abs_err": prefill["max_abs_err"],
        "ms": prefill["ms"],
        "ms_eager": prefill["ms_eager"],
        "plain_ms": prefill["plain_ms"],
        "bound_ms": prefill["bound_ms"],
        "bound_by": prefill["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a selective scan
    }

    # K1 at the jamba attention shape, beside torch's fused attention
    jamba_fa = _fa_at_shape(torch, dev, JAMBA_ATTN, seed=101)
    emit("jamba_kernels", mamba_scan_cases=rows, mamba_scan_ptxas=ptxas, flash_attention_jamba_shape=jamba_fa)
    check(jamba_fa.pop("ok"), f"flash_attention disagrees with attention_ref at the jamba shape: "
          f"max |diff| {jamba_fa['max_abs_err']}, row {jamba_fa['row_rel_err']}, "
          f"fp8 control {jamba_fa['row_rel_control_fp8_p']}")
    torch.cuda.empty_cache()
    return ms_row, jamba_fa


def _cfg(name, dtype="bfloat16", **moe):
    """A path's config in ``dtype``, jamba cut to JAMBA_LAYERS, mixtral and
    nemotron to their A5_LAYERS, with MoE overrides."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(name), dtype=dtype, param_dtype=dtype)
    if name == JAMBA:
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
    if name in A5_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=A5_LAYERS[name])
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _first_repeat_fp32(tree: dict) -> dict:
    return {k: _first_repeat_fp32(v) if isinstance(v, dict) else v[0].float() for k, v in tree.items()}


def phase_jamba_prefill(torch, dev) -> dict:
    """The bf16 main path, the fp32 mixer check and the profile, on one set of
    bf16 params. Returns the kernels' launch counts of the main path."""
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.models.mamba import mamba_apply

    cfg = _cfg(JAMBA)
    n_mamba = sum(k == "mamba" for k, _ in cfg.pattern_unit())
    n_attn = len(cfg.pattern_unit()) - n_mamba
    n_moe = sum(is_moe for _, is_moe in cfg.pattern_unit())
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_gb = torch.cuda.memory_allocated() / 1e9
        forward(cfg, params, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        lk, aux = forward(cfg, params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lr, aux_r = forward(cfg, params, batch, impl="ref")
        finite = bool(torch.isfinite(lk).all()) and bool(torch.isfinite(aux))
        top1 = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
        err16 = (lk - lr).abs().max().item()
        aux_k, aux_r = aux.item(), aux_r.item()
        del lk, lr

        # one full-width mixer in fp32 (layer 0's weights, upcast): kernel vs plain
        mixer = _first_repeat_fp32(params["blocks"]["u0"]["mixer"])
        cfg32 = _cfg(JAMBA, "float32")
        x = torch.as_tensor(np.random.default_rng(4).standard_normal((1, PREFILL_S, cfg.d_model)),
                            dtype=torch.float32, device=dev)
        yk = mamba_apply(mixer, cfg32, x, impl="auto")
        yr = mamba_apply(mixer, cfg32, x, impl="ref")
        mix_err = (yk - yr).abs().max().item()
        mix_scale = yr.abs().max().item()
        del mixer, x, yk, yr

        # profile: one prefill forward and 4 decode steps at batch 4
        prefill_prof = _profile(torch, lambda: forward(cfg, params, batch), groups=_GROUPS)
        cache = init_cache(cfg, 4, 128)
        tok = batch["tokens"][:, :1].repeat(2, 1)
        decode_step(cfg, params, cache, tok, 0)  # warm-up

        def four_steps():
            for i in range(1, 5):
                decode_step(cfg, params, cache, tok, i)

        decode_prof = _profile(torch, four_steps, groups=_GROUPS)
        del params, cache, batch
        torch.cuda.empty_cache()
    emit(
        "jamba_prefill",
        n_layers=cfg.n_layers, B=PREFILL_B, S=PREFILL_S, init_s=init_s, param_gb=param_gb,
        launches=counts, bf16_top1_agreement=top1, bf16_logit_max_abs_err=err16,
        aux_kernel=aux_k, aux_plain=aux_r,
        prefill_s=prefill_s, prefill_tok_per_s=PREFILL_B * PREFILL_S / prefill_s,
        peak_gb=peak_gb,
        fp32_mixer_max_abs_err=mix_err, fp32_mixer_max_abs=mix_scale,
        fp32_mixer_tol=f"max|diff| <= {MIXER_RTOL} * max|plain|",
    )
    emit("jamba_profile", prefill_forward=prefill_prof, decode_4_steps=decode_prof)
    check(counts == {"mamba_scan": n_mamba, "flash_attention": n_attn, "mlstm": 0, "gmm": 3 * n_moe,
                     "decode_attention": 0},
          f"jamba forward launched {counts}, expected {n_mamba} scans, {n_attn} attention and "
          f"{3 * n_moe} grouped products")
    check(finite, "jamba bf16 logits or aux are not finite")
    check(top1 >= TOP1_MIN, f"jamba bf16 top-1 agreement kernel vs plain {top1} < {TOP1_MIN}")
    check(mix_err <= MIXER_RTOL * mix_scale,
          f"fp32 mamba mixer kernel vs plain: {mix_err} > {MIXER_RTOL} * {mix_scale}")
    return counts


def phase_jamba_decode(torch, dev) -> None:
    """fp32 model: 16 decode steps against forward over the same tokens, with
    MoE capacity to spare (tests/test_models.py::test_decode_matches_forward)."""
    from repro_torch.models import decode_step, forward, init_cache, init_params

    cfg = _cfg(JAMBA, "float32", capacity_factor=8.0)
    S = 16
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, S)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params = init_params(cfg, seed=1)
        full, _ = forward(cfg, params, {"tokens": tokens})
        cache = init_cache(cfg, 1, 32)
        steps = []
        torch.cuda.synchronize()
        _reset_counts()
        for i in range(S):
            lg, cache = decode_step(cfg, params, cache, tokens[:, i : i + 1], i)
            steps.append(lg[:, 0])
        counts = _counts()
        dec = torch.stack(steps, dim=1)
        err = (dec - full).abs().max().item()
        ok = bool(torch.allclose(dec, full, atol=2e-2, rtol=2e-2))
        finite = bool(torch.isfinite(dec).all())
        del params, cache, full, dec
        torch.cuda.empty_cache()
    emit("jamba_decode", n_layers=cfg.n_layers, steps=S, max_abs_err=err, tol="atol=rtol=2e-2",
         launches=counts, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(finite and ok, f"jamba decode_step logits disagree with forward: max abs err {err}")
    _check_decode_counts(counts, cfg, S, "jamba decode")


def phase_jamba_serve(torch) -> None:
    from repro_torch.launch.serve import serve

    batch, steps = 4, 32
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tps = serve(JAMBA, smoke=False, n_layers=JAMBA_LAYERS, batch=batch, steps=steps, max_len=128,
                verbose=False)
    counts = _counts()
    torch.cuda.empty_cache()
    emit("jamba_serve", n_layers=JAMBA_LAYERS, batch=batch, steps=steps, tok_per_s=tps,
         ms_per_step=batch / tps * 1e3, launches=counts, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(tps > 0, "jamba serve returned no rate")
    _check_decode_counts(counts, _cfg(JAMBA), steps, "jamba serve")


# ------------------------------ xlstm phases ---------------------------------


def _mlstm_inputs(torch, dev, B, T, H, D, dtype, seed):
    """The inputs of tests/test_kernels.py: q, k, v ~ N(0, 1) in ``dtype``,
    fp32 gates i ~ N(0, 1) and f ~ N(2, 2)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0, dt="float32"):
        a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        return torch.from_numpy(a).to(dev, getattr(torch, dt))

    qkv = [t(B, T, H, D, dt=dtype) for _ in range(3)]
    return (*qkv, t(B, T, H), t(B, T, H, scale=2.0, shift=2.0))


def _mlstm_bound(B, T, H, D, dtype, L):
    """Least time of one call computed at chunk L: per chunk and sequence
    2*L*L*D FLOP for q k^T, 2*L*L*D for the weights times v, 2*L*D*D for q C
    and 2*L*D*D for the k^T v update of C, at the peak rate for the input type
    (bf16 at the tensor rate, fp32 on the CUDA cores); q, k, v read once and
    the output written once in that type, the two fp32 gates read once. The
    work grows with L, so L = 1 (the recurrent form: q C and a rank-1 update
    of C a step) gives the function's least time, the rows' ``bound_ms``."""
    itemsize = 2 if dtype == "bfloat16" else 4
    nc = -(-T // L)
    flops = nc * B * H * (4 * L * L * D + 4 * L * D * D)
    nbytes = 4 * B * T * H * D * itemsize + 2 * B * T * H * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes, "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def _mlstm_rel(out, ref) -> float:
    """max |a - b| / (|b| + 1e-2), the form of tests/test_kernels.py."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (ref.abs() + 1e-2)).max().item()


def _k3_precision(args, out, ref, exact) -> dict:
    """At the prefill shape in bf16: the kernel's and the plain version's
    error against an fp64 evaluation, beside the precision controls: the
    plain-torch model of the route's arithmetic (``mlstm_rounded_scan``, fp32
    matmuls) with W, the key-weighted k and C split into bf16 hi + lo (the
    kernel's), rounded to bf16 once, and rounded to TF32."""
    from repro_torch.kernels.ref import mlstm_rounded_scan

    res = {"bar": MLSTM_TOL["bfloat16"], "kernel": _mlstm_rel(out, exact), "plain": _mlstm_rel(ref, exact)}
    for operands in ("split", "bf16", "tf32"):
        res[f"emulated_{operands}"] = _mlstm_rel(mlstm_rounded_scan(*args, operands=operands), exact)
    return res


# the wgmma route's kernels, as ptxas names them
_K3_WGMMA = {"states": "states_wgmma_kernel", "output": "output_wgmma_kernel"}


def phase_xlstm_kernels(torch, dev) -> dict:
    """K3 against its plain version on every case: the route, kernel (CUDA
    graph and eager), plain and bound times; the precision controls at the
    prefill shape."""
    import repro_torch.kernels.mlstm as ml
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import mlstm_chunked_scan

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 products in full fp32
    cases = [(f"mlstm_case_{i}", c) for i, c in enumerate(MLSTM_CASES)]
    cases += [("xlstm_prefill", MLSTM_PREFILL), ("ragged", MLSTM_RAGGED)]
    rows = []
    seed = 0
    for name, (B, T, H, D) in cases:
        for dtype in ("float32", "bfloat16"):
            seed += 1
            args = _mlstm_inputs(torch, dev, B, T, H, D, dtype, seed)
            p = ml.plan(*args[:3])
            chunk = max(c for c in range(1, p.chunk + 1) if T % c == 0)
            plain = lambda a=args, c=chunk: mlstm_chunked_scan(*a, chunk=c)  # noqa: E731
            out, ref = ml.mlstm_chunkwise(*args), plain()
            torch.cuda.synchronize()
            rel = _mlstm_rel(out, ref)
            if name == "xlstm_prefill":
                # accuracy against an fp64 evaluation: the kernel's, and the
                # plain version's at its chunk and at the model's plain chunk
                exact = mlstm_chunked_scan(*args, chunk=chunk, dtype=torch.float64)
                if dtype == "float32":
                    fp64 = {"kernel": _mlstm_rel(out, exact), f"plain_chunk_{chunk}": _mlstm_rel(ref, exact),
                            "plain_chunk_256": _mlstm_rel(mlstm_chunked_scan(*args, chunk=256), exact)}
                else:
                    bf16_fp64 = _k3_precision(args, out, ref, exact)
                del exact
            rows.append({
                "case": name, "shape": (B, T, H, D), "dtype": dtype, "route": p.route,
                "kernel_chunk": p.chunk, "plain_chunk": chunk,
                "rel_err": rel, "tol": MLSTM_TOL[dtype], "ok": rel < MLSTM_TOL[dtype],
                "finite": bool(torch.isfinite(out).all()),
                "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                "max_abs": ref.float().abs().max().item(),
                "ms": _graph_ms(torch, lambda a=args: ml.mlstm_chunkwise(*a)),
                "ms_eager": _cuda_ms(torch, lambda a=args: ml.mlstm_chunkwise(*a)),
                "plain_ms": _cuda_ms(torch, plain, iters=5, warmup=1),
                **_mlstm_bound(B, T, H, D, dtype, 1),
                "bound_ms_route_chunk": _mlstm_bound(B, T, H, D, dtype, p.chunk)["bound_ms"],
                "bound_ms_chunk_64": _mlstm_bound(B, T, H, D, dtype, 64)["bound_ms"],
            })
            del args, out, ref
    ptxas = _wgmma_ptxas(_build.build_all()["mlstm"].ptxas, _K3_WGMMA)
    emit("xlstm_kernels", mlstm_cases=rows, tol="max|a-b|/(|b|+1e-2)", prefill_fp32_rel_err_vs_fp64=fp64,
         prefill_bf16_rel_err_vs_fp64=bf16_fp64, wgmma_ptxas=ptxas)
    check(all(r["ok"] and r["finite"] for r in rows), f"mlstm_chunkwise disagrees with its plain version: {rows}")
    check(all(r["route"] == ("wgmma" if r["dtype"] == "bfloat16" else "cuda_cores") for r in rows),
          f"mlstm routes: {[(r['case'], r['dtype'], r['route']) for r in rows]}")
    check(bf16_fp64["kernel"] < MLSTM_TOL["bfloat16"] < bf16_fp64["emulated_bf16"],
          f"mlstm bf16 precision against fp64: {bf16_fp64}")
    check(set(ptxas) == set(_K3_WGMMA) and all("0 bytes spill stores, 0 bytes spill loads" in " ".join(lines)
                                               for lines in ptxas.values()),
          f"the mlstm wgmma kernels spill or are missing: {ptxas}")
    torch.cuda.empty_cache()
    prefill = next(r for r in rows if r["case"] == "xlstm_prefill" and r["dtype"] == "bfloat16")
    return {
        "name": "mlstm_chunkwise",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm.py:137",
        "kernel_route": prefill["route"],
        "max_abs_err": prefill["max_abs_err"],
        "ms": prefill["ms"],
        "ms_eager": prefill["ms_eager"],
        "plain_ms": prefill["plain_ms"],
        "bound_ms": prefill["bound_ms"],
        "bound_by": prefill["bound_by"],
        "bound_ms_route_chunk": prefill["bound_ms_route_chunk"],
        "library_ms": None,  # no PyTorch call computes the chunkwise mLSTM
    }


def _slstm_loop_ms(torch, cfg, params, batch) -> list:
    """Wall time (ms) of each sLSTM layer's time loop alone, on the gates that
    the prefill gives it (host clock, synchronised around the loop)."""
    from repro_torch.models import xlstm
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import _embed, _index

    x = _embed(cfg, params, batch["tokens"])
    loops = []
    for r in range(cfg.num_pattern_repeats):
        for u, (kind, _) in enumerate(cfg.pattern_unit()):
            p = _index(params["blocks"][f"u{u}"], r)["block"]
            if kind != "slstm":
                x = xlstm.mlstm_block_apply(p, cfg, x)
                continue
            h = apply_norm(p["norm"], x, cfg.norm)
            xc = torch.nn.functional.silu(xlstm._causal_conv(p["conv"], h))
            gates, R = xlstm._slstm_gates(p, h, xc), xlstm._recurrent(p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xlstm._slstm_scan(R, gates)
            torch.cuda.synchronize()
            loops.append((time.perf_counter() - t0) * 1e3)
            x = xlstm.slstm_block_apply(p, cfg, x)
    return loops


# the launches of one K3 call, as the profiler names them: the gates pass of
# both routes, the wgmma route's two others, the CUDA-core route's three
_K3_KERNELS = ("gates_scan_kernel", "states_wgmma_kernel", "output_wgmma_kernel",
               "states_kernel", "scores_kernel", "output_kernel")


def phase_xlstm_prefill(torch, dev) -> dict:
    """The bf16 main path, the fp32 mLSTM block check, the profile and the
    sLSTM loop's share, on one set of bf16 params. Returns the main path's
    launch counts."""
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.models.xlstm import mlstm_block_apply

    cfg = _cfg(XLSTM)
    n_mlstm = sum(k == "mlstm" for k in cfg.layer_kinds())
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    with torch.inference_mode():
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        param_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
        n_params = sum(t.numel() for t in _leaves(params))
        forward(cfg, params, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        lk, _ = forward(cfg, params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lr, _ = forward(cfg, params, batch, impl="ref")
        finite = bool(torch.isfinite(lk).all())
        top1 = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
        err16 = (lk - lr).abs().max().item()
        del lk, lr

        # one full-width mLSTM block in fp32 (layer 0's weights, upcast): kernel vs plain
        block = _first_repeat_fp32(params["blocks"]["u0"]["block"])
        cfg32 = _cfg(XLSTM, "float32")
        x = torch.as_tensor(np.random.default_rng(7).standard_normal((1, PREFILL_S, cfg.d_model)),
                            dtype=torch.float32, device=dev)
        yk = mlstm_block_apply(block, cfg32, x, impl="auto")
        yr = mlstm_block_apply(block, cfg32, x, impl="ref")
        blk_err = (yk - yr).abs().max().item()
        blk_scale = yr.abs().max().item()
        del block, x, yk, yr

        # where the time goes: one profiled prefill, 4 decode steps at batch 4,
        # and the sLSTM loops alone against an unprofiled forward
        # device activity alone: the sLSTM loops' ~10^5 host-side op events
        # took the profiler about a minute to gather, and no row reads them
        prefill_prof = _profile(torch, lambda: forward(cfg, params, batch), top=12, host_ops=False,
                                groups={"mlstm_chunkwise": _K3_KERNELS, **{k: (k,) for k in _K3_KERNELS}})
        cache = init_cache(cfg, 4, 128)
        tok = batch["tokens"][:, :1].repeat(2, 1)
        decode_step(cfg, params, cache, tok, 0)  # warm-up

        def four_steps():
            for i in range(1, 5):
                decode_step(cfg, params, cache, tok, i)

        decode_prof = _profile(torch, four_steps, top=12)
        # host-clock times spread between runs on a shared host: medians of 3
        forward_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(cfg, params, batch)
            torch.cuda.synchronize()
            forward_ms.append((time.perf_counter() - t0) * 1e3)
        loops = np.median([_slstm_loop_ms(torch, cfg, params, batch) for _ in range(3)], axis=0)
        del params, cache, batch
        torch.cuda.empty_cache()
    emit(
        "xlstm_prefill",
        n_layers=cfg.n_layers, n_params=n_params, B=PREFILL_B, S=PREFILL_S, param_gb=param_gb,
        launches=counts, bf16_top1_agreement=top1, bf16_logit_max_abs_err=err16,
        prefill_s=prefill_s, prefill_tok_per_s=PREFILL_B * PREFILL_S / prefill_s, peak_gb=peak_gb,
        fp32_block_max_abs_err=blk_err, fp32_block_max_abs=blk_scale,
        fp32_block_tol=f"max|diff| <= {BLOCK_RTOL} * max|plain|",
    )
    k3_ms = prefill_prof["group_ms"]["mlstm_chunkwise"]
    busy = prefill_prof["device_busy_ms"]
    emit("xlstm_profile", prefill_forward=prefill_prof, decode_4_steps=decode_prof,
         k3_device_ms=k3_ms, k3_share_of_busy=k3_ms / busy if busy else None,
         k3_pass_ms={k: prefill_prof["group_ms"][k] for k in _K3_KERNELS if prefill_prof["group_ms"][k]},
         forward_ms=forward_ms, slstm_loop_ms=loops.tolist(), slstm_steps=PREFILL_S,
         slstm_loop_share_of_wall=float(loops.sum() / np.median(forward_ms)))
    check(counts == {"mlstm": n_mlstm, "flash_attention": 0, "mamba_scan": 0, "gmm": 0, "decode_attention": 0},
          f"xlstm forward launched {counts}, expected {n_mlstm} mLSTM kernels and no other")
    check(finite, "xlstm bf16 logits are not finite")
    check(top1 >= TOP1_MIN, f"xlstm bf16 top-1 agreement kernel vs plain {top1} < {TOP1_MIN}")
    check(blk_err <= BLOCK_RTOL * blk_scale,
          f"fp32 mLSTM block kernel vs plain: {blk_err} > {BLOCK_RTOL} * {blk_scale}")
    return counts


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_xlstm_decode(torch, dev) -> None:
    """fp32 model: 16 decode steps against forward over the same tokens
    (tests/test_models.py::test_decode_matches_forward)."""
    from repro_torch.models import decode_step, forward, init_cache, init_params

    cfg = _cfg(XLSTM, "float32")
    S = 16
    tokens = torch.as_tensor(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, S)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params = init_params(cfg, seed=1)
        full, _ = forward(cfg, params, {"tokens": tokens})
        cache = init_cache(cfg, 1, 32)
        steps = []
        for i in range(S):
            lg, cache = decode_step(cfg, params, cache, tokens[:, i : i + 1], i)
            steps.append(lg[:, 0])
        dec = torch.stack(steps, dim=1)
        err = (dec - full).abs().max().item()
        ok = bool(torch.allclose(dec, full, atol=2e-2, rtol=2e-2))
        finite = bool(torch.isfinite(dec).all())
        del params, cache, full, dec
        torch.cuda.empty_cache()
    emit("xlstm_decode", n_layers=cfg.n_layers, steps=S, max_abs_err=err, tol="atol=rtol=2e-2",
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(finite and ok, f"xlstm decode_step logits disagree with forward: max abs err {err}")


def phase_xlstm_serve(torch) -> None:
    from repro_torch.launch.serve import serve

    batch, steps = 4, 32
    torch.cuda.reset_peak_memory_stats()
    tps = serve(XLSTM, smoke=False, batch=batch, steps=steps, max_len=128, verbose=False)
    torch.cuda.empty_cache()
    emit("xlstm_serve", n_layers=_cfg(XLSTM).n_layers, batch=batch, steps=steps, tok_per_s=tps,
         ms_per_step=batch / tps * 1e3, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(tps > 0, "xlstm serve returned no rate")


# ----------------------------- granite phases --------------------------------

# the kernels' launches as the profiler names them, for device time by kernel
_GROUPS = {"gmm": ("gmm_wgmma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel"),
           "flash_attention": ("fa_fwd_kernel", "fa_fwd_wgmma_kernel"),
           "mamba_scan": ("mamba_scan_kernel",)}


def _capacity(cfg, tokens: int) -> int:
    """The MoE's rows per expert, ceil(T * k / E * capacity_factor), as models/moe.py."""
    mc = cfg.moe
    return int(np.ceil(tokens * mc.top_k / mc.num_experts * mc.capacity_factor))


# the MoE paths, with the tokens of their prefill: B 2 x S 2048, mixtral B 1 x S 8192
GMM_PATHS = {GRANITE: PREFILL_B * PREFILL_S, JAMBA: PREFILL_B * PREFILL_S, MIXTRAL: 8192}


def _gmm_products(torch):
    """The main paths' K4 launches at their prefill and at batch-4 decode:
    (path, product, groups E, rows per group C, K, N, output type, launches per
    forward). Up and gate return fp32 (the reference keeps them fp32 up to the
    activation); down returns the activations' type."""
    rows = []
    for name, prefill_tokens in GMM_PATHS.items():
        cfg = _cfg(name)
        n_moe = sum(m for _, m in cfg.pattern_unit()) * cfg.num_pattern_repeats
        E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
        for phase, tokens in (("prefill", prefill_tokens), ("decode", 4)):
            C = _capacity(cfg, tokens)
            rows.append((name, f"{phase}_up_gate", E, C, d, f, torch.float32, 2 * n_moe))
            rows.append((name, f"{phase}_down", E, C, f, d, torch.bfloat16, n_moe))
    return rows


def _gmm_bound(M, K, N, G, in_bytes, out_bytes):
    """Least time of one launch: lhs, the G weight matrices and the output
    moved once over HBM; 2*M*K*N operations at the tensor rate (bf16 inputs)
    or the CUDA-core rate (fp32 inputs)."""
    nbytes = in_bytes * (M * K + G * K * N) + out_bytes * M * N
    flops = 2 * M * K * N
    peak = PEAK_FLOPS["bfloat16" if in_bytes == 2 else "float32"]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6}


def _gmm_inputs(torch, dev, sizes, K, N, dtype, seed, scaled=False):
    """lhs ~ N(0, 1); rhs ~ N(0, 1) as in tests/test_kernels.py, or with
    ``scaled`` N(0, 1/K) as the MoE's weights are initialised. Drawn on the
    card: jamba's weight stack is 0.94 G numbers."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lhs = torch.randn((sum(sizes), K), generator=gen, device=dev).to(dtype)
    rhs = torch.randn((len(sizes), K, N), generator=gen, device=dev)
    if scaled:
        rhs /= np.sqrt(K)
    return lhs, rhs.to(dtype)


def _gmm_check(torch, dev, gk, gmm_ref, sizes, K, N, dtype, out_dtype, seed, scaled=False):
    lhs, rhs = _gmm_inputs(torch, dev, sizes, K, N, dtype, seed, scaled)
    bm = int(np.gcd.reduce(sizes))
    ids = torch.tensor(np.repeat(np.arange(len(sizes)), np.asarray(sizes) // bm), dtype=torch.int32,
                       device=dev)
    out = gk.gmm(lhs, rhs, ids, out_dtype=out_dtype)
    ref = gmm_ref(lhs, rhs, sizes, out_dtype=out_dtype)
    torch.cuda.synchronize()
    tol = GMM_TOL["float32" if out_dtype == torch.float32 else "bfloat16"]
    row = {"route": gk.plan(lhs, rhs, ids).route,
           "groups": len(sizes), "rows": sizes if len(set(sizes)) > 1 else sizes[0], "K": K, "N": N,
           "dtype": str(dtype).split(".")[-1], "out_dtype": str(out_dtype).split(".")[-1],
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "max_abs": ref.float().abs().max().item(), "tol": tol,
           "ok": bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))}
    return row, (lhs, rhs, ids)


def _gmm_poison(torch, dev, gk) -> dict:
    """The wgmma route with a group id outside [0, G) in the middle of three
    row blocks of 200 rows: its rows come out NaN, its neighbours' (whose
    second tiles read its rows through TMA) stay right."""
    lhs, rhs = _gmm_inputs(torch, dev, [200] * 3, 128, 128, torch.bfloat16, seed=99)
    ids = torch.tensor([0, 7, 1], dtype=torch.int32, device=dev)
    out = gk.gmm(lhs, rhs, ids).float()
    want = torch.cat([lhs[:200].float() @ rhs[0].float(), lhs[400:].float() @ rhs[1].float()]).bfloat16().float()
    got = torch.cat([out[:200], out[400:]])
    return {"case": "bad_group_id", "route": gk.plan(lhs, rhs, ids).route,
            "bad_rows_nan": bool(torch.isnan(out[200:400]).all()),
            "max_abs_err": (got - want).abs().max().item(), "tol": GMM_TOL["bfloat16"],
            "ok": bool(torch.isnan(out[200:400]).all())
            and bool(torch.allclose(got, want, atol=GMM_TOL["bfloat16"], rtol=GMM_TOL["bfloat16"]))}


def phase_gmm_kernels(torch, dev):
    """K4 against its plain version on every case; at the paths' shapes also
    its kernel, plain, bound and ``torch.bmm`` times (the call the port's MoE
    made before K4 carried it). The kernel and ``torch.bmm`` are timed in CUDA
    graphs (device time; ``ms_eager`` adds the wrapper's host cost, which
    exceeds a decode launch's device time). Returns K4's row and its numbers
    by path, per launch averaged over a prefill forward's launches."""
    import repro_torch.kernels.gmm as gk
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import gmm_ref

    f32, bf16 = torch.float32, torch.bfloat16
    cases, seed = [], 0
    named = [(f"gmm_case_{i}", c) for i, c in enumerate(GMM_CASES)]
    for name, (sizes, K, N) in [*named, ("ragged", GMM_RAGGED), ("persistent", GMM_PERSISTENT)]:
        for dtype, out_dtype in ((f32, f32), (bf16, bf16), (bf16, f32)):
            seed += 1
            row, _ = _gmm_check(torch, dev, gk, gmm_ref, sizes, K, N, dtype, out_dtype, seed)
            cases.append({"case": name, **row})
    cases.append(_gmm_poison(torch, dev, gk))
    paths = []
    for name, product, E, C, K, N, out_dtype, per_forward in _gmm_products(torch):
        seed += 1
        row, (lhs, rhs, ids) = _gmm_check(torch, dev, gk, gmm_ref, [C] * E, K, N, bf16, out_dtype,
                                          seed, scaled=True)
        lhs3 = lhs.view(E, C, K)
        bmm = ((lambda: torch.bmm(lhs3, rhs, out_dtype=f32)) if out_dtype == f32
               else (lambda: torch.bmm(lhs3, rhs)))
        lib_err = (bmm().reshape(E * C, N).float() - gmm_ref(lhs, rhs, [C] * E, out_dtype=out_dtype)
                   .float()).abs().max().item()
        kernel = lambda: gk.gmm(lhs, rhs, ids, out_dtype=out_dtype)  # noqa: E731
        row.update({
            "path": name, "product": product, "launches_per_forward": per_forward,
            "ms": _graph_ms(torch, kernel), "ms_eager": _cuda_ms(torch, kernel),
            "plain_ms": _cuda_ms(torch, lambda: gmm_ref(lhs, rhs, [C] * E, out_dtype=out_dtype),
                                 iters=5, warmup=1),
            "library_ms": _graph_ms(torch, bmm), "library_max_abs_err": lib_err,
            **_gmm_bound(E * C, K, N, E, 2, 4 if out_dtype == f32 else 2),
        })
        row.update({"tflops": 2 * E * C * K * N / row["ms"] / 1e9, "ratio_to_library": row["ms"] / row["library_ms"],
                    "ratio_to_bound": row["ms"] / row["bound_ms"]})
        paths.append(row)
        del lhs, rhs, lhs3
    torch.cuda.empty_cache()
    emit("gmm_kernels", cases=cases, path_products=paths,
         tol="allclose(atol=rtol=tol): 1e-3 fp32 output, 1e-2 bf16 output",
         # the wgmma route, per output type: registers at launch (the consumers
         # take 232 by setmaxnreg) and spills
         wgmma_ptxas=_wgmma_ptxas(_build.build_all()["gmm"].ptxas, {
             "float32": "gmm_wgmma_kernelIfE", "bfloat16": "gmm_wgmma_kernelI13__nv_bfloat16E"}))
    check(all(r["ok"] for r in cases + paths), "gmm disagrees with gmm_ref: "
          + json.dumps([r for r in cases + paths if not r["ok"]]))

    by_path = {}
    for name in GMM_PATHS:
        rows = [r for r in paths if r["path"] == name and r["product"].startswith("prefill")]
        n = sum(r["launches_per_forward"] for r in rows)
        agg = {k: sum(r[k] * r["launches_per_forward"] for r in rows) / n
               for k in ("ms", "plain_ms", "bound_ms", "library_ms", "gflop")}
        t_ops = sum(r["bound_ops_ms"] * r["launches_per_forward"] for r in rows)
        t_bytes = sum(r["bound_bytes_ms"] * r["launches_per_forward"] for r in rows)
        by_path[name] = {"max_abs_err": max(r["max_abs_err"] for r in rows), **agg,
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "launches_per_forward": n, "routes": sorted({r["route"] for r in rows}),
                         "tflops": agg["gflop"] / agg["ms"], "ratio_to_library": agg["ms"] / agg["library_ms"],
                         "ratio_to_bound": agg["ms"] / agg["bound_ms"]}
    return {
        "name": "gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm.py:91",
    }, by_path


def phase_decode_attention(torch, dev) -> dict:
    """K5 against its plain version at mixtral's decode shape, with its time
    (in a CUDA graph; ``ms_eager`` adds the wrapper's host cost), the bytes
    bound of the filled slots, the plain route's time and
    ``scaled_dot_product_attention``'s over the filled slots (timed only: the
    port never calls it), both outputs' precision against the fp32 result;
    then K5 against its plain version at every shape the script's decode
    paths give it. Returns K5's row."""
    import torch.nn.functional as F

    import repro_torch.kernels.decode_attention as da
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import decode_attention_ref

    B, L, Hkv, g, D = DECODE_ATTN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(33)
    q = torch.randn((B, 1, Hkv * g, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, L, Hkv, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    rows = []
    for b, fill in [*((B, f) for f in DECODE_ATTN_FILLS), (1, L)]:
        qb, kb, vb = q[:b], k[:b], v[:b]
        p = da.plan(qb, kb, vb, fill, da._sms(dev))
        got = da.decode_attention(qb, kb, vb, fill)
        want = decode_attention_ref(qb, kb, vb, fill)
        gap = (got.float() - want.float()).abs()
        ok = bool((gap <= 2.0**-7 * want.float().abs() + 1e-6).all())
        nbytes = 2 * D * (2 * b * Hkv * g + 2 * b * fill * Hkv)  # q and out, K and V of the filled slots
        flops = 4 * D * b * Hkv * g * fill

        def kernel():
            return da.decode_attention(qb, kb, vb, fill)

        def library():
            return F.scaled_dot_product_attention(qb.transpose(1, 2), kb[:, :fill].transpose(1, 2),
                                                  vb[:, :fill].transpose(1, 2), enable_gqa=True)

        row = {"B": b, "fill": fill, "splits": p.splits, "blocks": p.blocks, "launches": p.launches,
               "ok": ok, "max_abs_err": gap.max().item(), "gbytes": nbytes / 1e9, "l2_warm": nbytes < L2_BYTES,
               "ms": _graph_ms(torch, kernel), "ms_eager": _cuda_ms(torch, kernel),
               "plain_ms": _cuda_ms(torch, lambda: decode_attention_ref(qb, kb, vb, fill), iters=5, warmup=1),
               "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS["bfloat16"]) * 1e3,
               "bound_by": "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_FLOPS["bfloat16"] else "operations"}
        # precision against the fp32 result of the same function (q is exact in
        # fp32): of the bf16 outputs, the share that is not that result
        # rounded to bf16 and the largest gap; and K5's fp32 output for an
        # fp32 q over the bf16 cache, a route SDPA does not take (one dtype)
        exact = decode_attention_ref(qb.float(), kb, vb, fill)
        rounded = exact.to(torch.bfloat16)
        row.update({"fp32_max_abs_err": (got.float() - exact).abs().max().item(),
                    "not_rounded_share": (got != rounded).float().mean().item(),
                    "fp32_q_max_abs_err": (da.decode_attention(qb.float(), kb, vb, fill) - exact)
                    .abs().max().item()})
        try:
            lib = library().transpose(1, 2)
            row["library_ms"] = _graph_ms(torch, library)
            row["library_max_abs_err"] = (lib.float() - want.float()).abs().max().item()
            row["library_fp32_max_abs_err"] = (lib.float() - exact).abs().max().item()
            row["library_not_rounded_share"] = (lib != rounded).float().mean().item()
        except (TypeError, RuntimeError) as err:  # an SDPA without enable_gqa
            row["library_ms"], row["library_error"] = None, str(err)[:200]
        del exact, rounded
        row.update({"ratio_to_bound": row["ms"] / row["bound_ms"], "tb_per_s": nbytes / row["ms"] / 1e9,
                    "ratio_to_plain": row["ms"] / row["plain_ms"]})
        rows.append(row)
        del got, want, gap
    del q, k, v
    torch.cuda.empty_cache()
    emit("decode_attention", shape=dict(zip(("B", "L", "Hkv", "g", "D"), DECODE_ATTN_SHAPE)), cases=rows,
         tol="within one unit of bf16's last place of the plain version",
         ptxas=_build.build_all()["decode_attention"].ptxas)
    check(all(r["ok"] for r in rows), "decode_attention disagrees with decode_attention_ref: "
          + json.dumps([r for r in rows if not r["ok"]]))
    paths = _k5_path_cases(torch, dev)
    emit("decode_attention_paths", cases=paths,
         tol="fp32: atol=rtol=2e-5; bf16: within one unit of bf16's last place of the plain version")
    check(all(r["ok"] for r in paths), "decode_attention disagrees with decode_attention_ref at a path's "
          "shape: " + json.dumps([r for r in paths if not r["ok"]]))
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": None, "by_fill": rows}


def _k5_close(torch, out, ref) -> tuple:
    """(ok, max |diff|): tests/test_torch_cuda.py's bar (fp32: 2e-5; bf16: a
    unit of bf16's last place)."""
    gap = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        ok = bool(torch.allclose(out, ref, atol=2e-5, rtol=2e-5))
    else:
        ok = bool((gap <= 2.0**-7 * ref.float().abs() + 1e-6).all())
    return ok and out.dtype == ref.dtype, gap.max().item()


def _k5_path_cases(torch, dev) -> list:
    """K5 against decode_attention_ref at every DECODE_ATTN_PATHS shape of every
    DECODE_ATTN_CONFIGS config, the cache a per-layer view of a stacked cache
    as the model indexes it (read in place), with K5's splits and launches."""
    import repro_torch.kernels.decode_attention as da
    from repro_torch.kernels.ref import decode_attention_ref

    rows, seed = [], 330
    for name in DECODE_ATTN_CONFIGS:
        cfg = _cfg(name)
        Hkv, g, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
        shapes = [(B, L, dt, fills) for B, L, dt, fills in DECODE_ATTN_PATHS]
        if cfg.sliding_window is not None and cfg.sliding_window < DECODE_ATTN_SHAPE[1]:
            W = cfg.sliding_window  # a full ring: fill_len = L
            shapes += [(1, W, "float32", (W,)), (4, W, "bfloat16", (W,))]
        for B, L, dt, fills in shapes:
            seed += 1
            gen = torch.Generator(device=dev).manual_seed(seed)
            dtype = getattr(torch, dt)
            q = torch.randn((B, 1, Hkv * g, D), generator=gen, device=dev).to(dtype)
            stacked = torch.randn((2, 2, B, L, Hkv, D), generator=gen, device=dev).to(dtype)
            k, v = stacked[0, 1], stacked[1, 1]  # the model's cache["k"][r]
            for fill in fills:
                before = da.LAUNCHES
                ok, err = _k5_close(torch, da.decode_attention(q, k, v, fill),
                                    decode_attention_ref(q, k, v, fill))
                p = da.plan(q, k, v, fill, da._sms(q.device))
                ok = ok and da.LAUNCHES - before == p.launches
                rows.append({"config": name, "B": B, "L": L, "Hkv": Hkv, "g": g, "D": D, "dtype": dt,
                             "fill": fill, "splits": p.splits, "launches": da.LAUNCHES - before,
                             "ok": ok, "max_abs_err": err})
            del q, stacked, k, v
    torch.cuda.empty_cache()
    return rows


def phase_granite_attention(torch, dev) -> dict:
    """K1 at the attention shape of all 32 granite layers, beside torch's fused
    attention."""
    granite_fa = _fa_at_shape(torch, dev, GRANITE_ATTN, seed=102)
    emit("granite_attention", flash_attention_granite_shape=granite_fa)
    check(granite_fa.pop("ok"), f"flash_attention disagrees with attention_ref at the granite shape: "
          f"max |diff| {granite_fa['max_abs_err']}, row {granite_fa['row_rel_err']}, "
          f"fp8 control {granite_fa['row_rel_control_fp8_p']}")
    return granite_fa


def phase_granite_prefill(torch, dev) -> dict:
    """The bf16 main path, the fp32 MoE layer check and the profile, on one set
    of bf16 params. Returns the main path's launch counts."""
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.models.moe import moe_apply

    cfg = _cfg(GRANITE)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    with torch.inference_mode():
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        param_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
        n_params = sum(t.numel() for t in _leaves(params))
        forward(cfg, params, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        lk, aux = forward(cfg, params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lr, aux_r = forward(cfg, params, batch, impl="ref")
        finite = bool(torch.isfinite(lk).all()) and bool(torch.isfinite(aux))
        top1 = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
        err16 = (lk - lr).abs().max().item()
        aux_k, aux_r = aux.item(), aux_r.item()
        del lk, lr

        # one full-width MoE layer in fp32 (layer 0's weights, upcast) on one
        # input, so both sides route alike: kernel vs plain
        layer = _first_repeat_fp32(params["blocks"]["u0"]["moe"])
        cfg32 = _cfg(GRANITE, "float32")
        x = torch.as_tensor(np.random.default_rng(10).standard_normal((1, PREFILL_S, cfg.d_model)),
                            dtype=torch.float32, device=dev)
        yk, _ = moe_apply(layer, cfg32, x, impl="auto")
        yr, _ = moe_apply(layer, cfg32, x, impl="ref")
        moe_err = (yk - yr).abs().max().item()
        moe_scale = yr.abs().max().item()
        del layer, x, yk, yr

        # where the time goes: one profiled prefill and 4 decode steps at batch 4
        prefill_prof = _profile(torch, lambda: forward(cfg, params, batch), top=12, groups=_GROUPS)
        cache = init_cache(cfg, 4, 128)
        tok = batch["tokens"][:, :1].repeat(2, 1)
        decode_step(cfg, params, cache, tok, 0)  # warm-up

        def four_steps():
            for i in range(1, 5):
                decode_step(cfg, params, cache, tok, i)

        decode_prof = _profile(torch, four_steps, top=12, groups=_GROUPS)
        forward_ms = []
        for _ in range(3):  # host-clock times spread on a shared host: median of 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(cfg, params, batch)
            torch.cuda.synchronize()
            forward_ms.append((time.perf_counter() - t0) * 1e3)
        del params, cache, batch
        torch.cuda.empty_cache()
    emit(
        "granite_prefill",
        n_layers=cfg.n_layers, n_params=n_params, B=PREFILL_B, S=PREFILL_S, param_gb=param_gb,
        capacity=_capacity(cfg, PREFILL_B * PREFILL_S),
        launches=counts, bf16_top1_agreement=top1, bf16_logit_max_abs_err=err16,
        aux_kernel=aux_k, aux_plain=aux_r,
        prefill_s=prefill_s, prefill_tok_per_s=PREFILL_B * PREFILL_S / prefill_s, peak_gb=peak_gb,
        forward_ms=forward_ms,
        fp32_moe_max_abs_err=moe_err, fp32_moe_max_abs=moe_scale,
        fp32_moe_tol=f"max|diff| <= {MOE_RTOL} * max|plain|",
    )
    busy = prefill_prof["device_busy_ms"]
    shares = {k: v / busy if busy else None for k, v in prefill_prof["group_ms"].items()}
    emit("granite_profile", prefill_forward=prefill_prof, decode_4_steps=decode_prof,
         prefill_share_of_busy=shares)
    check(counts == {"flash_attention": cfg.n_layers, "gmm": 3 * cfg.n_layers, "mamba_scan": 0,
                     "mlstm": 0, "decode_attention": 0},
          f"granite forward launched {counts}, expected {cfg.n_layers} attention and "
          f"{3 * cfg.n_layers} grouped products")
    check(finite, "granite bf16 logits or aux are not finite")
    check(top1 >= TOP1_MIN, f"granite bf16 top-1 agreement kernel vs plain {top1} < {TOP1_MIN}")
    check(moe_err <= MOE_RTOL * moe_scale,
          f"fp32 MoE layer kernel vs plain: {moe_err} > {MOE_RTOL} * {moe_scale}")
    return counts


def phase_granite_decode(torch, dev) -> None:
    """fp32 model: 16 decode steps against forward over the same tokens, with
    MoE capacity to spare (tests/test_models.py::test_decode_matches_forward);
    K4's launches counted over the decode steps alone."""
    from repro_torch.models import decode_step, forward, init_cache, init_params

    cfg = _cfg(GRANITE, "float32", capacity_factor=8.0)
    S = 16
    tokens = torch.as_tensor(np.random.default_rng(11).integers(0, cfg.vocab_size, (1, S)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params = init_params(cfg, seed=1)
        full, _ = forward(cfg, params, {"tokens": tokens})
        cache = init_cache(cfg, 1, 32)
        steps = []
        torch.cuda.synchronize()
        _reset_counts()
        for i in range(S):
            lg, cache = decode_step(cfg, params, cache, tokens[:, i : i + 1], i)
            steps.append(lg[:, 0])
        counts = _counts()
        dec = torch.stack(steps, dim=1)
        err = (dec - full).abs().max().item()
        ok = bool(torch.allclose(dec, full, atol=2e-2, rtol=2e-2))
        finite = bool(torch.isfinite(dec).all())
        del params, cache, full, dec
        torch.cuda.empty_cache()
    emit("granite_decode", n_layers=cfg.n_layers, steps=S, max_abs_err=err, tol="atol=rtol=2e-2",
         launches=counts, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(finite and ok, f"granite decode_step logits disagree with forward: max abs err {err}")
    _check_decode_counts(counts, cfg, S, "granite decode")


def phase_granite_serve(torch) -> None:
    from repro_torch.launch.serve import serve

    batch, steps = 4, 32
    cfg = _cfg(GRANITE)
    n_layers = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tps = serve(GRANITE, smoke=False, batch=batch, steps=steps, max_len=128, verbose=False)
    counts = _counts()
    torch.cuda.empty_cache()
    emit("granite_serve", n_layers=n_layers, batch=batch, steps=steps, tok_per_s=tps,
         ms_per_step=batch / tps * 1e3, launches=counts, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(tps > 0, "granite serve returned no rate")
    _check_decode_counts(counts, cfg, steps, "granite serve")


# ------------------------------ the logits product ---------------------------


def phase_logits_product(torch, dev) -> None:
    """The port's logits product (``models.transformer._logits`` on bf16
    operands with autograd off: fp32 out, the d_model columns summed
    ``LOGITS_K_CHUNK`` at a time) against the upcast it replaced (both
    operands copied to fp32, one fp32 GEMM, TF32 off) on the same operands at
    each LOGITS_SHAPES shape: the largest difference (bar LOGITS_RTOL of max
    |upcast|), both times and the memory each takes beyond its operands (the
    port's must hold no fp32 copy of the unembedding); and against an fp64
    product over the first LOGITS_EXACT_V vocabulary rows, the errors of both
    and of one GEMM over all of d_model (the control for the chunking)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    rows = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(400)
    for name, (M, V, D) in LOGITS_SHAPES.items():
        cfg = get_config(name)  # its tie_embeddings and logit_softcap (none) are read
        x = torch.randn(M, D, device=dev, generator=gen).bfloat16()
        u = torch.randn(V, D, device=dev, generator=gen).bfloat16()
        params = {"embed" if cfg.tie_embeddings else "unembed": u}
        port = lambda: T._logits(cfg, params, x)  # noqa: E731
        upcast = lambda: torch.matmul(x.float(), u.float().t())  # noqa: E731
        one_gemm = lambda: torch.mm(x, u.t(), out_dtype=torch.float32)  # noqa: E731
        with torch.inference_mode():
            out, extra_gb = {}, {}
            for label, fn in (("port", port), ("upcast", upcast)):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out[label] = fn()
                torch.cuda.synchronize()
                extra_gb[label] = (torch.cuda.max_memory_allocated() - base) / 1e9
            err = (out["port"] - out["upcast"]).abs().max().item()
            scale = out["upcast"].abs().max().item()
            out["one_gemm"] = one_gemm()
            exact = x.double() @ u[:LOGITS_EXACT_V].double().t()
            exact_max = exact.abs().max().item()
            errs = {k: (y[:, :LOGITS_EXACT_V].double() - exact).abs().max().item() / exact_max
                    for k, y in out.items()}
            del out, exact
            torch.cuda.empty_cache()
            heavy = D > 4096  # the upcast's fp32 GEMM on the CUDA cores: ~0.7 s at nemotron's shape
            ms = _cuda_ms(torch, port, iters=10, warmup=2)
            rows[name] = {
                "rows": M, "vocab": V, "d_model": D, "chunks": -(-D // T.LOGITS_K_CHUNK),
                "max_abs_diff": err, "max_abs_upcast": scale, "rel_diff": err / scale,
                "tol": f"max|port - upcast| <= {LOGITS_RTOL} * max|upcast|",
                "rel_err_vs_fp64": errs, "ms": ms,
                "upcast_ms": _cuda_ms(torch, upcast, iters=3 if heavy else 10, warmup=1),
                "one_gemm_ms": _cuda_ms(torch, one_gemm, iters=10, warmup=2),
                "tflops": 2 * M * V * D / ms / 1e9,
                "bound_ms": max(2 * M * V * D / PEAK_FLOPS["bfloat16"],
                                ((M + V) * D * 2 + M * V * 4) / PEAK_BYTES) * 1e3,
                "logits_gb": M * V * 4 / 1e9, "unembed_fp32_copy_gb": V * D * 4 / 1e9,
                "port_extra_gb": extra_gb["port"], "upcast_extra_gb": extra_gb["upcast"],
            }
        del x, u, params
        torch.cuda.empty_cache()
    emit("logits_product", shapes=rows)
    for name, r in rows.items():
        check(r["max_abs_diff"] <= LOGITS_RTOL * r["max_abs_upcast"],
              f"logits product at {name}'s shape: {r['max_abs_diff']} > "
              f"{LOGITS_RTOL} * {r['max_abs_upcast']}")
        # nothing beyond the logits (the chunks add into them in place), and
        # so no fp32 copy of the unembedding
        check(r["port_extra_gb"] - r["logits_gb"] < 0.5 * r["unembed_fp32_copy_gb"],
              f"logits product at {name}'s shape took {r['port_extra_gb']} GB beyond its operands")


# ------------------------- the remaining one-card configs ---------------------


def phase_a5_attention(torch, dev) -> dict:
    """K1 at every shape of A5_ATTN against its plain version (both bf16 bars),
    with its kernel (CUDA graph, and eager), plain, SDPA and bound times.
    Returns, per config, the numbers per launch averaged over a bf16 forward's
    launches at their shapes (whisper's decode shape stands beside them)."""
    rows, by_path = {}, {}
    seed = 300
    for name, shapes in A5_ATTN.items():
        rows[name] = {}
        for label, (case, _) in shapes.items():
            seed += 1
            rows[name][label] = _fa_at_shape(torch, dev, case, seed)
        n = sum(per for _, per in shapes.values())
        agg = {k: sum(rows[name][label][k] * per for label, (_, per) in shapes.items()) / n
               for k in ("ms", "plain_ms", "bound_ms", "library_ms", "gflop")}
        t_ops = sum(_bound_ms(c)[2] / PEAK_FLOPS["bfloat16"] * per for c, per in shapes.values())
        t_bytes = sum(_bound_ms(c)[3] / PEAK_BYTES * per for c, per in shapes.values())
        by_path[name] = {"max_abs_err": max(r["max_abs_err"] for r in rows[name].values()), **agg,
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "launches_per_forward": n, "tflops": agg["gflop"] / agg["ms"],
                         "shapes": {label: case[:8] for label, (case, _) in shapes.items()}}
    emit("a5_attention", by_config=rows)
    bad = {f"{name}/{label}": r for name, shapes in rows.items() for label, r in shapes.items()
           if not r.pop("ok")}
    check(not bad, f"flash_attention disagrees with attention_ref at an A.5 shape: {bad}")
    decode = rows[WHISPER]["decode_cross"]
    by_path[WHISPER]["decode_cross"] = {k: decode[k] for k in ("ms", "ms_eager", "plain_ms", "bound_ms",
                                                               "bound_by", "library_ms", "max_abs_err")}
    torch.cuda.empty_cache()
    return by_path


def _a5_batch(torch, dev, cfg, B, S, seed) -> dict:
    """B x S text tokens, and whisper's (B, 1500, 512) frame or phi-3-vision's
    (B, 576, 3072) patch embeddings, fp32 N(0, 1), on the card."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device=dev)}
    if cfg.encoder is not None:
        batch["enc_frames"] = torch.as_tensor(
            rng.standard_normal((B, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32), device=dev)
    if cfg.vision_tokens:
        batch["img_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.vision_tokens, cfg.d_model), dtype=np.float32), device=dev)
    return batch


# the phases' names of each config
A5_PHASE = {WHISPER: "whisper", GEMMA12: "gemma3_12b", MIXTRAL: "mixtral", STABLELM: "stablelm",
            PHI3V: "phi3_vision", NEMOTRON: "nemotron"}


def _n_attention(cfg) -> int:
    """Self-attention layers (global and sliding-window)."""
    return sum(k in ("attn", "local") for k, _ in cfg.pattern_unit()) * cfg.num_pattern_repeats


def _a5_expected(cfg) -> dict:
    """K1-K5 launches of one forward: one K1 a self-attention layer, one more
    a cross-attention and an encoder layer; three K4 an MoE layer; no K5."""
    n_attn = _n_attention(cfg)
    n_moe = sum(m for _, m in cfg.pattern_unit()) * cfg.num_pattern_repeats
    n_k1 = 2 * n_attn + cfg.encoder.n_layers if cfg.encoder is not None else n_attn
    return {"flash_attention": n_k1, "mamba_scan": 0, "mlstm": 0, "gmm": 3 * n_moe, "decode_attention": 0}


def phase_a5_model(torch, dev, name) -> dict:
    """One config of A5_PREFILL through the port's entry points: the fp32 kernel
    against the plain path through the whole model (at the depth that fits),
    fp32 decode against forward on the same parameters (whisper's with
    ``encode``'s output as ``enc_out``, its K1 launches counted), the bf16 main
    path counted from 0 (launches, finiteness, wall time, tokens/s, peak
    memory), top-1 against the plain path (at A5_TOP1_S's shorter length
    where the plain attention does not fit beside the weights) and one
    profiled prefill, then ``launch.serve``. Returns the main path's counts."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, encode, forward, init_cache, init_params

    B, S, fp32_layers, fp32_S = A5_PREFILL[name]
    cfg = _cfg(name)
    cfg32 = _cfg(name, "float32")
    if fp32_layers is not None:
        cfg32 = dataclasses.replace(cfg32, n_layers=fp32_layers)
    with torch.inference_mode():
        # fp32: kernel against plain through the whole model, then decode against forward
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg32, seed=0)
        batch = _a5_batch(torch, dev, cfg32, B, fp32_S, seed=20)
        _reset_counts()
        lk, _ = forward(cfg32, params, batch)
        torch.cuda.synchronize()
        counts32 = _counts()
        lr, _ = forward(cfg32, params, batch, impl="ref")
        err32, scale32 = (lk - lr).abs().max().item(), lr.abs().max().item()
        del lk, lr, batch
        dcfg = cfg32 if cfg32.moe is None else dataclasses.replace(
            cfg32, moe=dataclasses.replace(cfg32.moe, capacity_factor=8.0))
        dbatch = _a5_batch(torch, dev, dcfg, 1, A5_DECODE_STEPS, seed=21)
        dbatch.pop("img_embeds", None)  # decode has no image positions (tests/test_models.py)
        full, _ = forward(dcfg, params, dbatch)
        enc_out = encode(dcfg, params, dbatch["enc_frames"]) if dcfg.encoder is not None else None
        cache = init_cache(dcfg, 1, 2 * A5_DECODE_STEPS)
        steps = []
        torch.cuda.synchronize()
        _reset_counts()
        for i in range(A5_DECODE_STEPS):
            lg, cache = decode_step(dcfg, params, cache, dbatch["tokens"][:, i : i + 1], i,
                                    enc_out=enc_out)
            steps.append(lg[:, 0])
        decode_counts = _counts()
        dec = torch.stack(steps, dim=1)
        dec_err = (dec - full).abs().max().item()
        dec_ok = bool(torch.allclose(dec, full, atol=2e-2, rtol=2e-2)) and bool(torch.isfinite(dec).all())
        del params, cache, full, dec, steps, enc_out, dbatch
        torch.cuda.empty_cache()
        fp32_peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # bf16, the serving dtype: the main path, counted from 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_gb = torch.cuda.memory_allocated() / 1e9
        init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        batch = _a5_batch(torch, dev, cfg, B, S, seed=22)
        forward(cfg, params, batch)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        lk, aux = forward(cfg, params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        counts = _counts()
        main_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finite = bool(torch.isfinite(lk).all()) and bool(torch.isfinite(aux))
        shape_ok = tuple(lk.shape) == (B, S, cfg.vocab_size)
        # top-1 against the plain path, on the main path's batch or a shorter one
        top1_S = A5_TOP1_S.get(name, S)
        tbatch = batch
        if top1_S != S:
            del lk
            tbatch = _a5_batch(torch, dev, cfg, B, top1_S, seed=23)
            lk, _ = forward(cfg, params, tbatch)
        lr, _ = forward(cfg, params, tbatch, impl="ref")
        top1 = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
        err16 = (lk - lr).abs().max().item()
        del lk, lr, tbatch
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # where the time goes: one profiled bf16 prefill
        prof = _profile(torch, lambda: forward(cfg, params, batch), top=6, groups=_GROUPS)
        del params, batch
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    batch_serve, steps_serve = 4, 32
    tps = serve(name, smoke=False, batch=batch_serve, steps=steps_serve, max_len=128, verbose=False,
                n_layers=A5_LAYERS.get(name))
    serve_counts = _counts()
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    short = A5_PHASE[name]
    want32, want = _a5_expected(cfg32), _a5_expected(cfg)
    # a decode step: K1 in each cross-attention, K4 three times an MoE layer,
    # K5 once a self-attention layer (one split: these caches fill one tile)
    n_cross = dcfg.n_layers if dcfg.encoder is not None else 0
    want_decode = {"flash_attention": n_cross * A5_DECODE_STEPS, "mamba_scan": 0, "mlstm": 0,
                   "gmm": want32["gmm"] * A5_DECODE_STEPS,
                   "decode_attention": _n_attention(dcfg) * A5_DECODE_STEPS}
    want_serve = {"flash_attention": 0, "mamba_scan": 0, "mlstm": 0, "gmm": want["gmm"] * steps_serve,
                  "decode_attention": _n_attention(cfg) * steps_serve}
    emit(f"{short}_prefill", config=cfg.name, n_layers=cfg.n_layers, B=B, S=S,
         positions=S + cfg.vision_tokens, encoder_frames=cfg.encoder.n_frames if cfg.encoder else 0,
         init_s=init_s, param_gb=param_gb, init_peak_gb=init_peak_gb, launches=counts,
         bf16_top1_agreement=top1, bf16_top1_S=top1_S, bf16_logit_max_abs_err=err16,
         prefill_s=prefill_s, prefill_tok_per_s=B * S / prefill_s, main_path_peak_gb=main_peak_gb,
         peak_gb=peak_gb, fp32_n_layers=cfg32.n_layers, fp32_S=fp32_S, fp32_launches=counts32,
         fp32_logit_max_abs_err=err32, fp32_logit_max_abs=scale32,
         fp32_tol=f"max|diff| <= {LOGIT_RTOL} * max|plain|", fp32_peak_gb=fp32_peak_gb,
         prefill_profile=prof)
    emit(f"{short}_decode", config=cfg.name, n_layers=dcfg.n_layers, steps=A5_DECODE_STEPS,
         enc_out=cfg.encoder is not None, max_abs_err=dec_err, tol="atol=rtol=2e-2", launches=decode_counts)
    emit(f"{short}_serve", config=cfg.name, n_layers=cfg.n_layers, batch=batch_serve, steps=steps_serve,
         tok_per_s=tps, ms_per_step=batch_serve / tps * 1e3, launches=serve_counts,
         peak_gb=serve_peak_gb)
    check(counts32 == want32, f"{cfg.name} fp32 forward launched {counts32}, expected {want32}")
    check(err32 <= LOGIT_RTOL * scale32,
          f"{cfg.name} fp32 logits kernel vs plain: {err32} > {LOGIT_RTOL} * {scale32}")
    check(dec_ok, f"{cfg.name} decode_step logits disagree with forward: max abs err {dec_err}")
    check(decode_counts == want_decode, f"{cfg.name} decode launched {decode_counts}, expected {want_decode}")
    check(counts == want, f"{cfg.name} bf16 forward launched {counts}, expected {want}")
    check(finite and shape_ok, f"{cfg.name} bf16 logits are not finite or not (B, S, V)")
    check(top1 >= TOP1_MIN, f"{cfg.name} bf16 top-1 agreement kernel vs plain {top1} < {TOP1_MIN}")
    most_gb = max(peak_gb, fp32_peak_gb, serve_peak_gb)
    check(most_gb <= A5_PEAK_GB.get(name, math.inf),
          f"{cfg.name} held {most_gb} GB, more than {A5_PEAK_GB.get(name)}")
    check(tps > 0 and serve_counts == want_serve,
          f"{cfg.name} serve: {tps} tok/s, launched {serve_counts}, expected {want_serve}")
    return counts


# ------------------------------ simulator phases -----------------------------


def _sim_policy(policy):
    from repro_torch.core.simulator import DayNightPolicy, NoMIGPolicy, StaticPolicy

    return {"static": lambda: StaticPolicy(3), "nomig": NoMIGPolicy, "daynight": DayNightPolicy}[policy]()


def _sim_jobs_part(seeds, load):
    """paper-diurnal's padded jobs at ``load`` for ``seeds`` (run in a worker process)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch.core.batched as P
    from repro_torch.core.scenarios import generate_scenario

    lists = [generate_scenario("paper-diurnal", seed=s, load_scale=load) for s in seeds]
    return P.BatchedJobs.from_job_lists(lists, max_slots=P.build_tables().max_slots)


SIM_WORKERS = max(1, min(8, os.cpu_count() or 1))


def _sim_jobs(P, B, load, pool):
    """paper-diurnal's padded jobs for seeds 0 .. B-1, as ``BatchedJobs.from_job_lists``
    makes them, drawn in ``pool``'s worker processes: the seeded Python generator
    takes ~20 ms a rollout at load 1 and ~230 ms at load 12."""
    chunks = [list(map(int, c)) for c in np.array_split(np.arange(B), SIM_WORKERS) if len(c)]
    parts = list(pool.map(_sim_jobs_part, chunks, [load] * len(chunks)))
    J = max(p.padded_jobs for p in parts)

    def stack(field, fill):
        return np.concatenate([np.pad(a, [(0, 0), (0, J - a.shape[1])] + [(0, 0)] * (a.ndim - 2),
                                      constant_values=fill)
                               for a in (getattr(p, field) for p in parts)])

    deadline = stack("deadline", np.inf)
    return P.BatchedJobs(
        arrival=stack("arrival", np.inf), deadline=deadline, work=stack("work", 0.0),
        rate_by_slots=stack("rate_by_slots", 0.0), valid=stack("valid", False),
        num_jobs=np.concatenate([p.num_jobs for p in parts]),
        edf_order=np.argsort(deadline, axis=1, kind="stable").astype(np.int32))


def _sim_group(P, rows, seeds, load):
    """Rows of one policy kind and repartition mode as one batch: their rollouts
    stacked, every row padded to the longest row's job count. A rollout's result
    does not depend on the others in its batch, so each row is read back by its
    slice of the batch."""
    from repro_torch.core.scenarios import generate_scenario

    tables = P.build_tables()
    lists = {row: [generate_scenario(row[0], seed=s, load_scale=load) for s in seeds] for row in rows}
    J = max(len(js) for ls in lists.values() for js in ls)
    jobs = [P.BatchedJobs.from_job_lists(ls, max_slots=tables.max_slots, min_jobs=J)
            for ls in lists.values()]
    pols = [P.compile_policy(_sim_policy(row[1]), tables, len(seeds)) for row in rows]
    jobs = dataclasses.replace(jobs[0], **{f.name: np.concatenate([getattr(j, f.name) for j in jobs])
                                           for f in dataclasses.fields(jobs[0])})
    pol = dataclasses.replace(pols[0], **{f: np.concatenate([getattr(p, f) for p in pols])
                                          for f in ("initial", "primary", "secondary")})
    return tables, jobs, pol


def _aggregates(res, rows=slice(None)) -> dict:
    return {f: np.asarray(getattr(res, f))[rows] for f in SIM_BARS}


def _sim_compare(got: dict, want: dict) -> dict:
    """Each aggregate of ``want`` against ``got`` under SIM_BARS: the largest
    absolute (and relative) difference and whether the bar holds; the jobs
    completed must be the same set."""
    out, ok = {}, True
    for f, w in want.items():
        g, w = np.asarray(got[f], dtype=np.float64), np.asarray(w, dtype=np.float64)
        if f == "completion":
            done = np.isfinite(w)
            same = bool(np.array_equal(np.isfinite(g), done))
            out["completed_sets_equal"] = same
            ok &= same
            g, w = g[done], w[done]
        diff = np.abs(g - w)
        bar = SIM_BARS[f]
        hold = bool(np.array_equal(g, w)) if bar is None else bool(np.all(diff <= bar[1] + bar[0] * np.abs(w)))
        out[f] = {"max_abs": float(diff.max(initial=0.0)),
                  "max_rel": float((diff / np.maximum(np.abs(w), 1e-30)).max(initial=0.0)), "ok": hold}
        ok &= hold
    out["ok"] = ok
    return out


def _sim_parity_cpu(tables, jobs, pol, mode=None):
    """One group's ``simulate_batch`` on the CPU, in a child process that does
    not see the card: the result and its seconds (``mode`` None: the default)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch

    torch.set_num_threads(2)
    import repro_torch.core.batched as P

    t0 = time.perf_counter()
    kw = {} if mode is None else {"repartition_mode": mode}
    res = P.simulate_batch(jobs, pol, tables=tables, device="cpu", **kw)
    return res, time.perf_counter() - t0


def phase_sim_parity(torch) -> None:
    """The card's ``simulate_batch`` against the port's CPU run (a child process
    a group, beside the card's runs) and the reference's golden aggregates, on
    every row of the agreement matrix."""
    import concurrent.futures
    import multiprocessing

    import repro_torch.core.batched as P

    golden = json.loads(SIM_GOLDEN.read_text())
    check(golden["load_scale"] == SIM_LOAD and golden["seeds"] == list(SIM_SEEDS),
          "the golden file holds other rollouts")
    # rows of one policy kind (nomig compiles to static) and mode run as one batch
    groups = {}
    for row in SIM_ROWS:
        groups.setdefault((row[1] == "daynight", row[2]), []).append(row)
    rows = {}
    n = len(SIM_SEEDS)
    built = {key: _sim_group(P, members, SIM_SEEDS, SIM_LOAD) for key, members in groups.items()}
    _reset_counts()
    # each group's CPU run in a child process of its own, beside the card's runs
    with concurrent.futures.ProcessPoolExecutor(
            len(groups), mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_futs = {key: pool.submit(_sim_parity_cpu, *built[key], key[1]) for key in groups}
        runs = {}
        for key in groups:
            tables, jobs, pol = built[key]
            t0 = time.perf_counter()
            card = P.simulate_batch(jobs, pol, tables=tables, repartition_mode=key[1])
            runs[key] = card, time.perf_counter() - t0
        runs = {key: (*runs[key], *cpu_futs[key].result()) for key in groups}
    for (daynight, mode), members in groups.items():
        tables, jobs, pol = built[(daynight, mode)]
        card, card_s, cpu, cpu_s = runs[(daynight, mode)]
        for i, (scenario, policy, _) in enumerate(members):
            rid = f"{scenario}/{policy}/{mode}"
            part = slice(i * n, (i + 1) * n)
            gold = golden["rows"][rid]
            rows[rid] = {
                "batch_with": len(members), "padded_jobs": jobs.padded_jobs, "card_s": card_s,
                "cpu_s": cpu_s, "makespan_max": float(card.makespan_min[part].max()),
                "card_vs_cpu": _sim_compare(_aggregates(card, part), _aggregates(cpu, part)),
                "card_vs_golden": _sim_compare(_aggregates(card, part), gold),
                "cpu_vs_golden": _sim_compare(_aggregates(cpu, part), gold),
                "finite": bool(np.isfinite(card.energy_wh[part]).all()
                               and np.isfinite(card.completion[part][card.valid[part]]).all()),
            }
    counts = _counts()
    emit("sim_parity", load_scale=SIM_LOAD, seeds=len(SIM_SEEDS), bars=SIM_BARS, rows=rows,
         model_kernel_launches=counts)
    bad = [rid for rid, r in rows.items()
           if not (r["finite"] and r["card_vs_cpu"]["ok"] and r["card_vs_golden"]["ok"]
                   and r["cpu_vs_golden"]["ok"])]
    check(not bad, f"simulate_batch on the card disagrees on {bad}")
    check(not any(counts.values()), f"the simulator launched a model kernel: {counts}")


def phase_sim_throughput(torch) -> None:
    """``simulate_batch`` on the card at the two sizes of SIM_SIZES: rates, and
    over SIM_PROFILED_STEPS steps the launches and busy time per step and the idle share."""
    import concurrent.futures
    import multiprocessing

    import repro_torch.core.batched as P
    from repro_torch.core.batched import backend as PB

    events = {p["load_scale"]: p["oracle_events_per_rollout"]
              for p in json.loads(SIM_AGREEMENT.read_text())["points"]}
    chunk, dt = P.DEFAULT_CHUNK_STEPS, P.DEFAULT_DT_MIN
    # one pool of workers for both sizes' job draws and (b)'s CPU check: a
    # spawned worker spends ~9 s importing torch
    pool = concurrent.futures.ProcessPoolExecutor(
        SIM_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    for label, (B, load) in SIM_SIZES.items():
        t0 = time.perf_counter()
        tables = P.build_tables()
        jobs = _sim_jobs(P, B, load, pool)
        pol = P.compile_policy(_sim_policy("daynight"), tables, B)
        setup_s = time.perf_counter() - t0
        if label == "b":
            # the first rollouts of (b), same padded J, run again on the CPU in a
            # child process, beside the card's runs
            held = slice(0, SIM_HELD)
            j8 = dataclasses.replace(jobs, **{f.name: getattr(jobs, f.name)[held]
                                               for f in dataclasses.fields(jobs)})
            p8 = dataclasses.replace(pol, initial=pol.initial[held], primary=pol.primary[held],
                                     secondary=pol.secondary[held])
            cpu_fut = pool.submit(_sim_parity_cpu, tables, j8, p8)
        # the parallel draw is the serial one: the first rollouts, padded alike
        first = _sim_jobs_part([0, 1, 2], load)
        same = all(np.array_equal(getattr(jobs, f.name)[:3, :first.padded_jobs], getattr(first, f.name))
                   for f in dataclasses.fields(first) if f.name not in ("num_jobs", "edf_order"))
        check(same and np.array_equal(jobs.num_jobs[:3], first.num_jobs),
              f"sim_throughput ({label}): the parallel job draw differs from the serial one")
        # warm-up: two chunks at full width from t = 0 load every kernel of the
        # step and grow the allocator's pools (the step runs the same ops at
        # every t), and bring the rollouts to 8:32, the morning ramp, for one
        # chunk timed alone and then under the profiler
        consts = PB.device_constants(tables, "partial")
        state = PB.run_steps(PB.init_state(jobs, pol.initial), jobs, pol, consts, t0_min=0.0,
                             n_steps=2 * chunk, penalty_min=tables.penalty_min)

        def one_chunk():
            return PB.run_steps(state, jobs, pol, consts, t0_min=2 * chunk * dt,
                                n_steps=SIM_PROFILED_STEPS, penalty_min=tables.penalty_min)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_chunk()
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        prof = _profile(torch, one_chunk, top=10, host_ops=False)
        profile_s = time.perf_counter() - t0
        busy = prof["device_busy_ms"] or 0.0

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = P.simulate_batch(jobs, pol, tables=tables)  # ends in a copy to the host
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        chunks = int(res.makespan_min.max() // (chunk * dt)) + 1  # the host stops after the chunk past it
        steps = chunks * chunk
        check(bool(np.isfinite(res.completion[res.valid]).all() and np.isfinite(res.energy_wh).all()
                   and (res.energy_wh > 0).all()), f"sim_throughput ({label}): unfinished or bad rollouts")
        row = {
            "rollouts": B, "load_scale": load, "padded_jobs": jobs.padded_jobs, "steps": steps,
            "chunks": chunks, "makespan_max_min": float(res.makespan_min.max()), "setup_s": setup_s,
            "wall_s": wall, "peak_gb": peak_gb,
            "env_steps_per_s": B * steps / wall,
            "rollout_minutes_per_s": B * steps * dt / wall,
            "oracle_events_per_rollout": events[load],
            "events_equiv_per_s": events[load] * B / wall,
            "events_note": "the reference oracle's event count at this load "
                           "(benchmarks/baselines/batched_agreement.json) over this run's wall time",
            "profiled_steps": SIM_PROFILED_STEPS,
            "chunk_wall_ms": chunk_ms,
            "profile_s": profile_s,
            "ms_per_step": chunk_ms / SIM_PROFILED_STEPS,
            "launches_per_step": prof["launches"] / SIM_PROFILED_STEPS,
            "device_busy_ms_per_step": busy / SIM_PROFILED_STEPS,
            "device_idle_share": 1 - busy / chunk_ms if busy else None,
            "profiled_chunk": prof,
        }
        if label == "b":
            cpu, row["cpu_first_8_s"] = cpu_fut.result()
            row["card_vs_cpu_first_8"] = _sim_compare(_aggregates(res, held), _aggregates(cpu))
        emit("sim_throughput", size=label, **row)
        if label == "b":
            check(row["card_vs_cpu_first_8"]["ok"], "sim_throughput (b): the card disagrees with the CPU")
        del state, consts, jobs, res
        torch.cuda.empty_cache()
    pool.shutdown()


# ----------------------------- the DQN trainer ---------------------------------


def _rl_golden():
    """tests/torch_rl_golden.py: the golden file's inputs and the port's runs of them."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_rl_golden

    return torch_rl_golden


def _rl_env_day(torch, g) -> dict:
    """``BatchedRepartitionEnv`` on the card through the golden file's scripted day."""
    import hashlib

    from repro_torch.core.batched.env import BatchedRepartitionEnv
    from repro_torch.core.rl.env import RewardWeights

    env = BatchedRepartitionEnv(scenario=g["scenario"], scenario_kwargs={"load_scale": g["load_scale"]})
    acts = _rl_golden().scripted_actions(200, len(g["seeds"]), g["action_seed"])
    t0 = time.perf_counter()
    obs = [env.reset(seeds=g["seeds"])]
    rewards, term, trunc = [], [], []
    while not env.done and len(rewards) < 200:
        o, r, te, tr, _ = env.step(acts[len(rewards)])
        obs.append(o)
        rewards.append(r)
        term.append(te)
        trunc.append(tr)
    wall = time.perf_counter() - t0
    obs = np.stack(obs)
    w = RewardWeights()
    ulp_e = float(np.spacing(np.float32(env._state.energy_wh.max().item())))
    ulp_t = float(np.spacing(np.float32(env._state.tardiness_integral.max().item())))
    atol = 2 * (w.a * ulp_e + ulp_t / w.tardiness_norm) / (w.a + 1.0) / w.scale
    rew = np.stack(rewards).ravel()
    want = np.asarray(g["rewards"])
    codes = np.rint(obs.astype(np.float64) * g["obs_code_scale"]).astype(np.int64).ravel().tolist()
    res_ok, res_diff = True, {}
    for got, gold in zip(env.results(), g["results"], strict=True):
        row = {**{f: getattr(got, f) for f in gold if hasattr(got, f)}, **dict(got.extra)}
        for f, v in gold.items():
            exact = f in ("preemptions", "repartitions", "num_jobs", "deadline_misses")
            bar = {"energy_wh": (1e-5, 0.0), "busy_slot_minutes": (1e-5, 0.0),
                   "makespan_min": (0.0, 1e-3)}.get(f, (1e-4, 1e-3))
            d = abs(row[f] - v)
            ok = d == 0 if exact else d <= bar[1] + bar[0] * abs(v)
            res_diff[f] = max(res_diff.get(f, 0.0), d)
            res_ok &= bool(ok)
    return {
        "decisions": len(rewards), "wall_s": wall,
        "obs_exact": hashlib.sha256(np.ascontiguousarray(obs, np.float32).tobytes()).hexdigest()
        == g["obs_sha256"] and codes == g["obs_codes"],
        "reward_max_abs": float(np.max(np.abs(rew - want), initial=0.0)) if rew.shape == want.shape else None,
        "reward_atol": atol,
        "rewards_ok": bool(rew.shape == want.shape
                           and np.all(np.abs(rew - want) <= atol + RL_REWARD_RTOL * np.abs(want))),
        "flags_exact": np.stack(term).astype(int).ravel().tolist() == g["terminated"]
        and np.stack(trunc).astype(int).ravel().tolist() == g["truncated"],
        "results_max_abs": res_diff, "results_ok": res_ok,
    }


def phase_rl_parity(torch) -> None:
    """The trainer's pieces on the card against the port's CPU run, the golden
    file and the checked-in baseline."""
    from repro_torch.core.rl import dqn as PD

    golden = json.loads(RL_GOLDEN.read_text())
    _reset_counts()
    # the checked-in parameters' params probe
    probe = json.loads(RL_BASELINE.read_text())["params_probe"]
    learner = PD.DQNLearner(PD.DQNConfig(state_dim=18))
    learner.load(str(RL_PARAMS))
    obs = np.random.default_rng(probe["seed"]).uniform(0.0, 1.0, size=(len(probe["actions"]), 18))
    probe_actions = [learner.greedy_action(o.astype(np.float32)) for o in obs]
    tie = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]], device=learner.device)
    tie_first = tie.argmax(1).tolist() == [1, 0]

    # one TD update at the baseline's width
    gold = _rl_golden()
    td = golden["td_update"]
    check(td["config"] == gold.TD, "the golden file's TD update has other inputs")
    card_loss, card_params = gold.port_td_update(None)
    cpu_loss, cpu_params = gold.port_td_update("cpu")
    td_row = {
        "loss": card_loss,
        "card_vs_cpu": max([abs(card_loss - cpu_loss)] + [float(np.abs(a - b).max()) for pa, pb in
                            zip(card_params, cpu_params) for a, b in zip(pa, pb)]),
        "card_vs_golden": max(abs(card_loss - td["loss"]), gold.digest_diff(gold.digest(card_params),
                                                                           td["params"])),
    }

    # the golden round, the reference's draws replayed
    g = golden["round"]
    t0 = time.perf_counter()
    card = gold.port_round(gold.golden_draws(g, None), g["config"], None)
    card_s = time.perf_counter() - t0
    cpu = gold.port_round(gold.golden_draws(g, "cpu"), g["config"], "cpu")
    ran = ~np.isnan(card["loss"])
    gloss = np.asarray([np.nan if x is None else x for x in g["loss"]])
    round_row = {
        "card_s": card_s, "updates": card["updates"], "size": card["size"],
        "ints_vs_golden": all(card[k] == g[k] for k in ("pos", "size", "gstep", "updates"))
        and card["live"].astype(int).ravel().tolist() == g["live"]
        and card["replay"]["a"].tolist() == g["replay_a"] and card["cfg"].tolist() == g["cfg"]
        and card["repartitions"].tolist() == g["repartitions"],
        "ints_vs_cpu": all(card[k] == cpu[k] for k in ("pos", "size", "gstep", "updates"))
        and all(np.array_equal(card[k], cpu[k]) for k in ("live", "action", "cfg"))
        and np.array_equal(card["replay"]["a"], cpu["replay"]["a"]),
        "reward_vs_golden": float(np.abs(card["reward"].ravel() - np.asarray(g["reward"])).max()),
        "replay_r_vs_golden": float(np.abs(card["replay"]["r"] - np.asarray(g["replay_r"])).max()),
        "eps_vs_golden": float(np.abs(card["eps"] - np.asarray(g["eps"])).max()),
        "loss_vs_golden": float(np.abs(card["loss"][ran] - gloss[ran]).max()),
        "loss_ran_as_golden": bool(np.array_equal(ran, ~np.isnan(gloss))),
        "params_vs_golden": gold.digest_diff(gold.digest(card["params"]), g["params"]),
        "params_vs_cpu": max(float(np.abs(a - b).max()) for pa, pb in zip(card["params"], cpu["params"])
                             for a, b in zip(pa, pb)),
    }
    env_row = _rl_env_day(torch, golden["env"])
    counts = _counts()
    emit("rl_parity", probe_actions=probe_actions, probe_ok=probe_actions == probe["actions"],
         argmax_first_of_ties=tie_first, td_update=td_row, round=round_row, env=env_row,
         bars={"td": RL_TD_TOL, "round_floats": RL_FLOAT_TOL, "env_reward_rtol": RL_REWARD_RTOL},
         model_kernel_launches=counts)
    check(probe_actions == probe["actions"], f"params probe {probe_actions} != {probe['actions']}")
    check(tie_first, "argmax on the card does not take the first of tied maxima")
    check(td_row["card_vs_cpu"] <= RL_TD_TOL and td_row["card_vs_golden"] <= RL_TD_TOL,
          f"TD update on the card: {td_row}")
    check(round_row["ints_vs_golden"] and round_row["ints_vs_cpu"] and round_row["loss_ran_as_golden"],
          f"the round's integers on the card: {round_row}")
    check(max(round_row[k] for k in ("reward_vs_golden", "replay_r_vs_golden", "eps_vs_golden")) <= RL_FLOAT_TOL
          and max(round_row[k] for k in ("loss_vs_golden", "params_vs_golden", "params_vs_cpu")) <= RL_TD_TOL,
          f"the round's floats on the card: {round_row}")
    check(env_row["obs_exact"] and env_row["rewards_ok"] and env_row["flags_exact"] and env_row["results_ok"],
          f"BatchedRepartitionEnv on the card disagrees with the golden file: {env_row}")
    check(not any(counts.values()), f"the trainer launched a model kernel: {counts}")


def phase_rl_train(torch) -> None:
    """``train_dqn_batched`` at the baseline's configuration for RL_ROUNDS rounds on
    the card; a profile of RL_PROFILED decisions of the second round, rebuilt."""
    import repro_torch.core.batched as P
    from repro_torch.core.batched import backend as PB
    from repro_torch.core.rl import batched_train as PT
    from repro_torch.core.rl.env import RewardWeights
    from repro_torch.launch import train_rl

    cfg, tcfg = train_rl.dqn_config(), train_rl.train_config()
    B = tcfg.batch
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    learner, stats = PT.train_dqn_batched(num_episodes=RL_ROUNDS * B, dqn_config=cfg, train_config=tcfg,
                                          seed=train_rl.TRAIN_SEED)
    call_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _counts()

    # the second round's inputs as the trainer made them (padded to the
    # largest episode of both rounds)
    tables = P.build_tables()
    dev = learner.device
    round_jobs, round_inv = PT._round_inputs(tcfg, RL_ROUNDS, train_rl.TRAIN_SEED, tables)
    jobs, inv = round_jobs[-1], round_inv[-1]
    consts = PB.device_constants(tables, tcfg.repartition_mode, dev)
    arrays = PT._batch_arrays(jobs, inv, dev)
    short = dataclasses.replace(tcfg, horizon_decisions=RL_PROFILED)
    round_fn = PT._make_round_fn(cfg, short, RewardWeights(), tables, consts, device=dev)
    # a full replay, so every profiled decision runs its TD update, as every
    # decision of the second round does
    replay = PT.new_replay(tcfg.replay_capacity, cfg.state_dim, dev)._replace(size=tcfg.replay_capacity)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    init_idx = np.full((B,), tables.index_of(tcfg.initial_config), np.int32)
    env0 = PB.init_state(jobs, init_idx, dev)  # the round reads it and writes nothing to it

    def decisions():
        return round_fn(env0, learner.params, learner.target, learner.opt_state, replay,
                        stats.env_steps, stats.updates, gen, *arrays)

    decisions()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = decisions()
    torch.cuda.synchronize()
    short_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(torch, decisions, top=10, host_ops=False)
    busy = prof["device_busy_ms"] or 0.0
    # the host's time a decision in the trainer: the second round's wall over
    # its decisions
    host_ms = stats.round_wall_seconds[-1] * 1e3 / tcfg.horizon_decisions

    losses = np.asarray(stats.losses)
    row = {
        "config": {"batch": B, "horizon": tcfg.horizon_decisions, "n_step": cfg.n_step,
                   "scenarios": list(tcfg.scenarios), "load_scale_range": list(tcfg.load_scale_range),
                   "replay_capacity": tcfg.replay_capacity, "min_buffer": cfg.min_buffer},
        "episodes": stats.episodes, "rounds": stats.rounds, "call_s": call_s,
        "train_wall_s": stats.wall_seconds, "round_wall_s": stats.round_wall_seconds,
        "round_env_steps": stats.round_env_steps, "env_steps": stats.env_steps,
        "env_steps_per_s": stats.env_steps_per_sec,
        "round_env_steps_per_s": [n / w for n, w in zip(stats.round_env_steps, stats.round_wall_seconds)],
        "updates": stats.updates, "final_epsilon": stats.final_epsilon,
        "losses": len(losses), "finite_losses": int(np.isfinite(losses).sum()),
        "truncated_episodes": stats.truncated_episodes, "peak_gb": peak_gb,
        "mean_episode_reward": float(np.mean(stats.episode_rewards)),
        "host_ms_per_decision": host_ms,
        "profiled_decisions": RL_PROFILED, "profiled_updates": out[6] - stats.updates,
        "profiled_round_ms_per_decision": short_ms / RL_PROFILED,
        "launches_per_decision": prof["launches"] / RL_PROFILED,
        "device_busy_ms_per_decision": busy / RL_PROFILED,
        # busy time and wall of the same decisions (the wall unprofiled)
        "device_idle_share": 1 - busy / short_ms if busy else None,
        "profile": prof,
        "model_kernel_launches": counts,
    }
    emit("rl_train", **row)
    check(stats.episodes == RL_ROUNDS * B and stats.updates > 0, f"rl_train: {stats.updates} updates")
    check(len(losses) > 0 and row["finite_losses"] == len(losses), "rl_train: non-finite losses")
    check(bool(np.isfinite(stats.episode_rewards).all()), "rl_train: non-finite episode rewards")
    check(all(np.isfinite(t.cpu().numpy()).all() for wb in learner.params for t in wb),
          "rl_train: non-finite parameters")
    check(row["profiled_updates"] == RL_PROFILED, "rl_train: the profiled decisions did not all train")
    check(not any(counts.values()), f"the trainer launched a model kernel: {counts}")


def _host_train_run(device=None) -> dict:
    """``train_rl.train_host`` for RL_HOST_EPISODES episodes (RL_HOST_GUIDE
    guided) on ``device``, every ``act`` recorded (the action and, where it was
    greedy, its Q values, and the TD updates made so far), where each episode
    starts in that record, and, on
    the card, the state and batch of every RL_HOST_STEP_EVERY-th TD update with
    the loss and parameters it gave. On the CPU (``device="cpu"``) it runs in a
    child process that does not see the card."""
    import copy

    if device == "cpu":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        sys.path.insert(0, str(SRC))
    import torch

    if device == "cpu":
        torch.set_num_threads(4)  # half the card machine's cores
    from repro_torch.core.rl import train as PT
    from repro_torch.core.rl.dqn import mlp_params_to_numpy
    from repro_torch.launch import train_rl

    log, resets, steps = [], [], []
    training = True  # the learner records its updates until train_host returns

    def host(tree):
        return [[t.detach().cpu().clone() for t in wb] for wb in tree]

    class Recording(PT.DQNLearner):
        def act(self, state, epsilon):  # the base act's draws and choice, recorded
            if self._rng.uniform() < epsilon:
                a = int(self._rng.integers(0, self.cfg.num_actions))
                log.append((a, None, self.updates))
                return a
            q = self.q(state)
            a = int(np.argmax(q))
            log.append((a, q, self.updates))
            return a

        def maybe_train(self, steps_=1):
            if (device == "cpu" or not training or self.buffer.size < self.cfg.min_buffer
                    or (self.updates + 1) % RL_HOST_STEP_EVERY):
                return super().maybe_train(steps_)
            # the batch the update will draw, from a copy of the generator
            batch = self.buffer.sample(copy.deepcopy(self._rng), self.cfg.batch_size)
            st = self.opt_state
            before = (host(self.params), host(self.target),
                      ([t.cpu().clone() for t in st.m], [t.cpu().clone() for t in st.v], st.step.cpu()))
            loss = super().maybe_train(steps_)
            steps.append({"update": self.updates, "state": before, "batch": batch, "loss": loss,
                          "params": mlp_params_to_numpy(self.params)})
            return loss

    class Marking(PT.RepartitionEnv):
        def reset(self, *a, **kw):
            resets.append(len(log))
            return super().reset(*a, **kw)

    saved = PT.DQNLearner, PT.RepartitionEnv
    PT.DQNLearner, PT.RepartitionEnv = Recording, Marking
    try:
        learner, stats = train_rl.train_host(RL_HOST_EPISODES, RL_HOST_GUIDE, device=device,
                                             verbose=False)
    finally:
        PT.DQNLearner, PT.RepartitionEnv = saved
        training = False
    return {"learner": learner if device != "cpu" else None, "log": log, "resets": resets,
            "steps": steps, "stats": dataclasses.asdict(stats), "updates": learner.updates,
            "params": mlp_params_to_numpy(learner.params)}


def _first_flip(log, other) -> dict:
    """The first decision whose action differs between two records, with each
    side's top-two Q gap (None where it explored)."""
    def gap(q):
        return None if q is None else float(np.sort(q)[-1] - np.sort(q)[-2])

    for i, ((a, q, updates), (b, qo, _)) in enumerate(zip(log, other)):
        if a != b:
            return {"decision": i, "updates_before": updates, "card": a, "cpu": b,
                    "card_q_gap": gap(q), "cpu_q_gap": gap(qo)}
    return None


def _steps_on_cpu(cfg, steps) -> dict:
    """Each recorded card TD update again on the CPU, from the card's state and
    batch: the largest loss and parameter differences (absolute)."""
    import torch

    from repro_torch.core.rl.dqn import make_td_update, mlp_params_to_numpy
    from repro_torch.optim.adamw import OptState

    _, update = make_td_update(cfg)
    loss_d, param_d = [], []
    for st in steps:
        params, target, (m, v, step) = st["state"]
        new, _, loss = update([tuple(wb) for wb in params], [tuple(wb) for wb in target],
                              OptState(m=m, v=v, step=step), *(torch.as_tensor(x) for x in st["batch"]))
        loss_d.append(abs(float(loss) - st["loss"]))
        param_d.append(max(float(np.abs(a - b).max()) for pa, pb in zip(mlp_params_to_numpy(new), st["params"])
                           for a, b in zip(pa, pb)))
    return {"updates_checked": [st["update"] for st in steps], "loss_max_diff": max(loss_d, default=None),
            "params_max_diff": max(param_d, default=None), "params_diff_by_update": param_d}


def phase_rl_host_train(torch) -> None:
    """The paper's host trainer on the card; its independent CPU run from the
    same initial parameters (in a child process beside it) up to the first
    decision where they part; every RL_HOST_STEP_EVERY-th TD update repeated on
    the CPU from the card's state; then RL_HOST_PROFILED decisions of the
    trained learner, updates on, under torch.profiler."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.core.rl.agent import NStepAccumulator
    from repro_torch.core.rl.env import RepartitionEnv
    from repro_torch.core.workload import WorkloadSpec

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_future = pool.submit(_host_train_run, "cpu")
        t0 = time.perf_counter()
        card = _host_train_run(None)
        card_s = time.perf_counter() - t0
        cpu = cpu_future.result()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _counts()
    learner, st, cs = card["learner"], card["stats"], cpu["stats"]
    cfg = learner.cfg
    stepwise = _steps_on_cpu(cfg, card["steps"])

    # the independent runs, up to the first decision where they part
    flip = _first_flip(card["log"], cpu["log"])
    n_eps = RL_HOST_EPISODES if flip is None else sum(k <= flip["decision"] for k in card["resets"]) - 1
    cut = None if flip is None else flip["decision"]

    def rel(a, b):
        return max((abs(x - y) / max(abs(y), 1e-300) for x, y in zip(a[:n_eps], b[:n_eps])), default=0.0)

    losses, cpu_losses = np.asarray(st["losses"]), np.asarray(cs["losses"])
    n = min(len(losses), len(cpu_losses))
    apart = np.abs(losses[:n] - cpu_losses[:n]) > RL_TD_TOL * np.abs(cpu_losses[:n]).max(initial=1.0)
    independent = {
        "episodes_before_first_flip": n_eps, "first_flip": flip,
        "first_update_whose_loss_parts_by_1e-5": int(np.argmax(apart)) if apart.any() else None,
        "env_steps": [st["env_steps"], cs["env_steps"]], "updates": [card["updates"], cpu["updates"]],
        "actions_equal_before_flip": [e[0] for e in card["log"][:cut]] == [e[0] for e in cpu["log"][:cut]],
        "reward_max_rel": rel(st["episode_rewards"], cs["episode_rewards"]),
        "proxy_max_rel": rel(st["episode_et_proxy"], cs["episode_et_proxy"]),
        "cpu_wall_s": cs["wall_seconds"], "cpu_episode_wall_s": cs["episode_wall_seconds"],
    }

    # RL_HOST_PROFILED decisions of the trained learner, as train_dqn's loop
    # takes them (act, step, n-step push, one TD update), first unprofiled
    env = RepartitionEnv(scheduler_name="EDF-SS", spec=WorkloadSpec())
    nstep = NStepAccumulator(cfg.n_step, cfg.gamma)
    box = {"obs": env.reset(seed=RL_HOST_EPISODES)}

    def decisions():
        obs = box["obs"]
        for _ in range(RL_HOST_PROFILED):
            a = learner.act(obs, cfg.eps_end)
            nxt, r, term, trunc, _ = env.step(a)
            nstep.push(learner, obs, a, r, nxt, term or trunc)
            learner.maybe_train(1)
            obs = nxt
        box["obs"] = obs

    u0 = learner.updates
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    u1 = learner.updates
    prof = _profile(torch, decisions, top=8, host_ops=False)
    busy = prof["device_busy_ms"] or 0.0
    row = {
        "config": {"episodes": RL_HOST_EPISODES, "guide_episodes": RL_HOST_GUIDE,
                   **{k: getattr(cfg, k) for k in ("n_step", "lr", "target_sync_every", "min_buffer",
                                                    "batch_size", "eps_decay_episodes", "seed")},
                   "hidden": list(cfg.hidden)},
        "call_s": card_s, "wall_s": st["wall_seconds"], "episode_wall_s": st["episode_wall_seconds"],
        "episode_updates": st["episode_updates"], "env_steps": st["env_steps"],
        "env_steps_per_s": st["env_steps"] / st["wall_seconds"], "updates": card["updates"],
        "losses": len(losses), "finite_losses": int(np.isfinite(losses).sum()),
        "episode_rewards": st["episode_rewards"], "peak_gb": peak_gb,
        "stepwise_vs_cpu": stepwise, "independent_cpu_run": independent,
        "profiled_decisions": RL_HOST_PROFILED, "profiled_updates": learner.updates - u1,
        "unprofiled_updates": u1 - u0, "unprofiled_ms_per_decision": wall_ms / RL_HOST_PROFILED,
        "launches_per_decision": prof["launches"] / RL_HOST_PROFILED,
        "device_busy_ms_per_decision": busy / RL_HOST_PROFILED,
        "device_idle_share": 1 - busy / wall_ms if busy else None, "profile": prof,
        "model_kernel_launches": counts,
    }
    emit("rl_host_train", **row)
    check(st["episodes"] == RL_HOST_EPISODES and card["updates"] > 0 and len(losses) == card["updates"],
          f"rl_host_train: {card['updates']} updates, {len(losses)} losses")
    check(row["finite_losses"] == len(losses) and bool(np.isfinite(st["episode_rewards"]).all()),
          "rl_host_train: non-finite losses or rewards")
    check(all(np.isfinite(a).all() for pa in card["params"] for a in pa), "rl_host_train: non-finite parameters")
    check(learner.device.type == "cuda" and row["profiled_updates"] == RL_HOST_PROFILED,
          "rl_host_train: the learner is off the card, or the profiled decisions did not all train")
    check(len(card["steps"]) == card["updates"] // RL_HOST_STEP_EVERY
          and stepwise["loss_max_diff"] <= RL_TD_TOL and stepwise["params_max_diff"] <= RL_TD_TOL,
          f"rl_host_train: a TD update on the card against the CPU: {stepwise}")
    check(independent["actions_equal_before_flip"] and n_eps >= RL_HOST_GUIDE
          and independent["reward_max_rel"] <= RL_HOST_REWARD_RTOL
          and independent["proxy_max_rel"] <= RL_HOST_REWARD_RTOL,
          f"rl_host_train: the card's episodes against the CPU's before they part: {independent}")
    check(not any(counts.values()), f"the trainer launched a model kernel: {counts}")


def phase_fleet_dqn(torch) -> None:
    """evaluate_policy_fleet with the checked-in npz as the registry's "dqn", one
    Q network a device on the card, against FLEET_GOLDEN; the same days with a
    decision log, whose greedy actions are held to a CPU learner's."""
    from repro_torch.core.rl.agent import greedy_policy
    from repro_torch.core.rl.train import evaluate_policy_fleet
    from repro_torch.launch import evaluate as PE
    from repro_torch.sweep.cells import result_to_sim_result

    golden = json.loads(FLEET_GOLDEN.read_text())
    g = golden["run"]
    params = str(ROOT / g["params"])
    kw = dict(profiles=g["profiles"], dispatcher=g["dispatcher"], num_iterations=g["num_iterations"],
              scheduler_name=g["scheduler"], scenario=g["scenario"], seed=g["seed"])
    _reset_counts()
    t0 = time.perf_counter()
    got = evaluate_policy_fleet(("dqn", {"params_path": params}), **kw)  # device=None: the card
    wall_s = time.perf_counter() - t0
    want = [dataclasses.asdict(result_to_sim_result(w)) for w in golden["results"]]
    got = [dataclasses.asdict(r) for r in got]
    days = [{"jobs": a["num_jobs"], "repartitions": a["repartitions"], "energy_wh": a["energy_wh"],
             "within_rtol": PE.values_close(a, b, EVAL_RTOL), "max_rel_diff": PE._max_rel(a, b)}
            for a, b in zip(got, want, strict=True)]
    # the same days, every greedy decision logged, against the CPU learner
    log = PE.DecisionLog(PE.load_learner(params))
    t0 = time.perf_counter()
    logged = evaluate_policy_fleet(lambda: greedy_policy(log), **kw)
    logged_s = time.perf_counter() - t0
    flips = PE.action_flips(log, PE.load_learner(params, "cpu"))
    counts = _counts()
    emit("fleet_dqn", run=g, days=days, wall_s=wall_s, decisions=len(log.records), logged_wall_s=logged_s,
         logged_equal=[dataclasses.asdict(r) for r in logged] == got, flips=flips[:16], n_flips=len(flips),
         model_kernel_launches=counts)
    check(all(d["within_rtol"] for d in days), f"fleet_dqn: days off the golden file: {days}; flips {flips[:8]}")
    check(not flips and days and len(log.records) > 0, f"fleet_dqn: card and CPU actions differ: {flips[:8]}")
    check(not any(counts.values()), f"the fleet evaluation launched a model kernel: {counts}")


def phase_eval_replay(torch) -> None:
    """Every checked-in sweep row: the stored cells of the seven files in one
    ``run_cells`` call on SWEEP_WORKERS processes (no cache), each result
    against its row as ``python -m repro_torch.launch.evaluate --replay``
    compares them (``compare_rows``)."""
    from repro_torch.forecast import fit_scenario_forecaster
    from repro_torch.launch import evaluate as PE
    from repro_torch.sweep.runner import run_cells

    rows = {path: [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
            for path in EVAL_FILES}
    _reset_counts()
    t0 = time.perf_counter()
    with _sweep_golden().working_dir():
        out = run_cells("eval_replay", [rec["cell"] for recs in rows.values() for rec in recs],
                        workers=SWEEP_WORKERS, cache=False, artifacts_dir=None)  # the card
    seconds = time.perf_counter() - t0
    files, start = [], 0
    for path, recs in rows.items():
        files.append(PE.compare_rows(path.name, recs, out.results[start:start + len(recs)], EVAL_RTOL))
        start += len(recs)
    counts = _counts()
    # the forecaster's least-squares fit (LAPACK) against the reference's
    # coefficients, written by the reference: the first suspect if a forecast
    # row moves on this machine
    golden = json.loads(EVAL_FORECAST_GOLDEN.read_text())
    fit_diff = {}
    for family, want in golden.items():
        m = fit_scenario_forecaster(family)
        fit_diff[family] = max(abs(a - b) for a, b in zip([m.mean, *m.cos_coeffs, *m.sin_coeffs], want))
    emit("eval_replay", files=files, rows=sum(f["rows"] for f in files),
         within_rtol=sum(f["within_rtol"] for f in files), seconds=seconds, workers=SWEEP_WORKERS,
         forecast_fit_max_diff=fit_diff, model_kernel_launches=counts)
    for f in files:
        check(f["within_rtol"] == f["rows"], f"eval_replay: {f['file']}: rows off {f['off'][:8]}")
    check(sum(f["rows"] for f in files) == 518, "eval_replay: the files hold 518 rows")
    check(not any(counts.values()), f"the evaluator launched a model kernel: {counts}")


def phase_serving_day(torch) -> None:
    """The multi-tenant-serving day (SERVING_CELL) through the port's
    ``make_scenario_cell`` and ``run_cell`` once per scheduler, each result
    against the reference's in SERVING_GOLDEN: the integers, the tenants' job
    and attainment counts, ``config_trace`` and ``util_histogram`` exact, the
    floats within EVAL_RTOL."""
    from repro_torch.launch import evaluate as PE
    from repro_torch.sweep.cells import make_scenario_cell, run_cell

    golden = json.loads(SERVING_GOLDEN.read_text())
    rows, off = {}, []
    _reset_counts()
    for scheduler, want in golden.items():
        cell = make_scenario_cell(scheduler=scheduler, **SERVING_CELL)
        t0 = time.perf_counter()
        got = run_cell(cell)
        seconds = time.perf_counter() - t0
        got.pop("elapsed_s")
        want = want["result"]
        tenants = {n: [t["jobs"], t["attained"]] for n, t in got["tenants"].items()}
        ok = (cell == golden[scheduler]["cell"] and PE.values_close(got, want, EVAL_RTOL)
              and PE._exact_part(got) == PE._exact_part(want)
              and tenants == {n: [t["jobs"], t["attained"]] for n, t in want["tenants"].items()})
        if not ok:
            off.append(scheduler)
        rows[scheduler] = {"jobs": got["num_jobs"], "slo_attainment": got["slo_attainment"],
                           "tenants_jobs_attained": tenants, "energy_wh": got["energy_wh"],
                           "deadline_misses": got["deadline_misses"],
                           "max_rel_diff": PE._max_rel(got, want), "seconds": seconds}
    counts = _counts()
    emit("serving_day", cell=SERVING_CELL, schedulers=rows, off=off, model_kernel_launches=counts)
    check(not off, f"serving_day: results off the golden file for {off}")
    check(not any(counts.values()), f"the serving day launched a model kernel: {counts}")


def phase_eval_race(torch) -> None:
    """The checked-in policy, its Q network on the card, against the forecast
    controller on the six families; each row against rl_batched.json."""
    from repro_torch.core.rl.agent import greedy_policy
    from repro_torch.core.rl.train import evaluate_policy
    from repro_torch.launch import evaluate as PE

    want = json.loads(RL_BASELINE.read_text())
    learner = PE.load_learner(str(RL_PARAMS))  # device=None: the card
    log = PE.DecisionLog(learner)
    _reset_counts()
    t0 = time.perf_counter()
    rows, _ = PE.race(log, EVAL_RACE_SCALE)
    wall_s = time.perf_counter() - t0
    counts = _counts()
    beaten = [r["scenario"] for r in rows if r["dqn_beats_forecast"]]
    keys = ("ET_DQN", "ET_Forecast", "repartitions_DQN", "energy_wh_DQN", "dqn_beats_forecast",
            "iterations")
    off = [{"scenario": g["scenario"], **{k: [g[k], w[k]] for k in keys if g[k] != w[k]}}
           for g, w in zip(rows, want["rows"]) if any(g[k] != w[k] for k in keys)]
    flips = PE.action_flips(log, PE.load_learner(str(RL_PARAMS), "cpu"))

    # the Q network's cost: one paper-diurnal day of the race under the profiler
    day = PE.DecisionLog(learner)
    prof = _profile(torch, lambda: evaluate_policy(
        lambda: greedy_policy(day, decision_interval_min=15.0), num_iterations=1,
        seed=PE.EVAL_SEED, scenario="paper-diurnal"), top=6)
    n_day = len(day.records)
    emit("eval_race", rows=rows, families_beaten=beaten, want_families_beaten=want["families_beaten"],
         rows_off=off, decisions=len(log.records), wall_s=wall_s, flips=flips,
         q_network={"day_decisions": n_day, "day_wall_ms": prof["wall_ms"],
                    "launches_per_decision": prof["launches"] / n_day,
                    "device_busy_ms_per_decision": (prof["device_busy_ms"] or 0.0) / n_day,
                    "device_idle_share": prof["device_idle_share"], "top": prof["top"]},
         params_probe=PE.params_probe(learner) == want["params_probe"],
         model_kernel_launches=counts)
    check(PE.params_probe(learner) == want["params_probe"], "eval_race: params probe")
    check(not off and beaten == want["families_beaten"],
          f"eval_race: rows off rl_batched.json {off}, beaten {beaten}; flips {flips[:8]}")
    check(all(math.isfinite(r["et_a"]) for r in rows), "eval_race: non-finite ET scale")
    check(not any(counts.values()), f"the evaluator launched a model kernel: {counts}")


def phase_eval_table3(torch) -> None:
    """Table III with the checked-in npz as the DQN row (measured, not gated)."""
    from repro_torch.launch import evaluate as PE

    _reset_counts()
    t0 = time.perf_counter()
    rows = PE.table3(EVAL_TABLE3_SCALE, str(RL_PARAMS))
    wall_s = time.perf_counter() - t0
    counts = _counts()
    emit("eval_table3", scale=EVAL_TABLE3_SCALE, days_per_model=PE.iters(10, EVAL_TABLE3_SCALE, 2),
         rows=rows, wall_s=wall_s,
         dqn_row_is="rl_batched.json's policy on WorkloadSpec days at the event cadence, "
                    "not the paper's trained agent",
         model_kernel_launches=counts)
    check([r["model"] for r in rows] == ["NoMIG", "StaticMIG", "DayNightMIG", "DynamicMIG-heuristic",
                                         "DynamicMIG-DQN"], "eval_table3: models")
    check(all(math.isfinite(v) for r in rows for k, v in r.items() if k != "model"),
          "eval_table3: non-finite row")
    check(not any(counts.values()), f"the evaluator launched a model kernel: {counts}")


# ------------------------------ the sweep engine ------------------------------


def _sweep_golden():
    """tests/torch_sweep_golden.py: the golden file's inputs and comparisons."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_sweep_golden

    return torch_sweep_golden


def phase_sweep_baselines(torch) -> None:
    """The seven checked-in baselines at scale 0.1: every grid's cells in one
    ``run_cells`` call on SWEEP_WORKERS spawned processes, then each grid
    through ``run_grid`` from the cache, its artifact against its file as
    the CLI's ``--check-baseline`` compares them; then ``smoke`` again."""
    from repro_torch.sweep.__main__ import check_baseline
    from repro_torch.sweep.grids import GRIDS, run_grid
    from repro_torch.sweep.runner import run_cells

    G = _sweep_golden()
    grids = {}
    _reset_counts()
    with G.working_dir():
        cells = [c for grid in SWEEP_BASELINES for c in GRIDS[grid].build(SWEEP_BASELINE_SCALE)]
        t0 = time.perf_counter()
        warm = run_cells("sweep_baselines", cells, workers=SWEEP_WORKERS, artifacts_dir=None)  # the card
        warm_s = time.perf_counter() - t0
        for grid, stem in SWEEP_BASELINES.items():
            t0 = time.perf_counter()
            _, out = run_grid(grid, scale=SWEEP_BASELINE_SCALE, workers=SWEEP_WORKERS)
            seconds = time.perf_counter() - t0
            bad = check_baseline(out.jsonl_path, str(BASELINES_DIR / f"{stem}.jsonl"), EVAL_RTOL)
            grids[grid] = {"cells": out.total, "computed": out.computed_count, "run_grid_s": seconds,
                           "mismatches": bad}
        t0 = time.perf_counter()
        _, again = run_grid("smoke", scale=SWEEP_BASELINE_SCALE, workers=SWEEP_WORKERS)
        cached = {"cells": again.total, "cached": again.cached_count, "computed": again.computed_count,
                  "seconds": time.perf_counter() - t0}
    counts = _counts()
    emit("sweep_baselines", scale=SWEEP_BASELINE_SCALE, workers=SWEEP_WORKERS, rtol=EVAL_RTOL,
         rows=len(cells), computed=warm.computed_count, compute_s=warm_s, cells_per_s=len(cells) / warm_s,
         grids=grids, smoke_again=cached, model_kernel_launches=counts)
    check(all(g["mismatches"] == 0 for g in grids.values()),
          f"sweep_baselines: mismatches {({k: g['mismatches'] for k, g in grids.items()})}")
    check(len(cells) == 518 and warm.computed_count == 518, "sweep_baselines: the files hold 518 rows")
    check(cached["computed"] == 0 and cached["cached"] == cached["cells"],
          f"sweep_baselines: smoke from the cache {cached}")
    check(not any(counts.values()), f"the sweep launched a model kernel: {counts}")


def _dqn_flips(cells) -> list:
    """The registry DQN's greedy decisions on ``cells``, on the card, each held
    to a CPU learner's: the decisions that differ, with their Q gaps."""
    from repro_torch.core.rl.agent import greedy_policy
    from repro_torch.launch import evaluate as PE
    from repro_torch.sweep.cells import run_cell

    log = PE.DecisionLog(PE.load_learner(str(RL_PARAMS)))
    for cell in cells:
        run_cell(cell, policy_factory=lambda: greedy_policy(log))
    return PE.action_flips(log, PE.load_learner(str(RL_PARAMS), "cpu"))


def phase_sweep_paper(torch) -> None:
    """The seven paper grids at scale 1.0 against the reference's rows in the
    golden file: their cells in one ``run_cells`` call on SWEEP_WORKERS
    spawned processes, then each grid through ``run_grid`` from the cache;
    then with the checked-in DQN parameters at artifacts/dqn_params.npz,
    Table III and Fig. 11 through ``run_grid`` in this process, their DQN
    days computed with the Q network on the card (the others cached); one
    DQN day under the profiler."""
    import shutil

    from repro_torch.sweep.cells import run_cell
    from repro_torch.sweep.grids import GRIDS, run_grid
    from repro_torch.sweep.runner import run_cells

    G = _sweep_golden()
    golden = json.loads(G.GOLDEN.read_text())
    check(golden["run"]["scale"] == G.SCALE, "sweep_paper: the golden file holds another scale")
    _reset_counts()
    with G.working_dir():
        cells = [c for g in G.PAPER_GRIDS for c in GRIDS[g].build(G.SCALE)]
        t0 = time.perf_counter()
        warm = run_cells("sweep_paper", cells, workers=SWEEP_WORKERS, artifacts_dir=None)  # the card
        warm_s = time.perf_counter() - t0
        plain = G.run_paper(run_grid, G.PAPER_GRIDS, G.SCALE, workers=SWEEP_WORKERS)
        os.makedirs("artifacts", exist_ok=True)
        shutil.copyfile(G.RL_PARAMS, G.DQN_PARAMS_PATH)
        dqn = G.run_paper(run_grid, G.DQN_GRIDS, G.SCALE, workers=0)
        dqn_cells = [c for g in G.DQN_GRIDS for c in GRIDS[g].build(G.SCALE) if c["policy"] == "dqn"]
        day = _profile(torch, lambda: run_cell(dqn_cells[0]), top=4)
        off = {"no_dqn": G.paper_off(plain, golden["paper"]["no_dqn"]),
               "dqn": G.paper_off(dqn, golden["paper"]["dqn"])}
        # a DQN row off the golden file: its decisions against the CPU's
        flips = _dqn_flips(dqn_cells) if off["dqn"] else None
    counts = _counts()

    def brief(got):
        return {g: {k: v[k] for k in ("cells", "computed", "seconds")} for g, v in got.items()}

    emit("sweep_paper", scale=G.SCALE, workers=SWEEP_WORKERS, cells=len(cells), computed=warm.computed_count,
         compute_s=warm_s, cells_per_s=len(cells) / warm_s, grids=brief(plain), dqn_workers=0,
         dqn_grids=brief(dqn), dqn_seconds=sum(v["seconds"] for v in dqn.values()),
         table3_dqn_rows=dqn["table3_repartitioning"]["rows"], off=off,
         rows_max_rel={"no_dqn": G.rows_max_rel(plain, golden["paper"]["no_dqn"]),
                       "dqn": G.rows_max_rel(dqn, golden["paper"]["dqn"])},
         q_network={"dqn_days": len(dqn_cells), "profiled_day_wall_ms": day["wall_ms"],
                    "profiled_day_launches": day["launches"], "profiled_day_device_busy_ms": day["device_busy_ms"],
                    "profiled_day_idle_share": day["device_idle_share"], "top": day["top"]},
         flips=None if flips is None else flips[:16], n_flips=None if flips is None else len(flips),
         model_kernel_launches=counts)
    check(not off["no_dqn"], f"sweep_paper: grids off the golden file {off['no_dqn']}")
    check(not off["dqn"], f"sweep_paper: DQN grids off the golden file {off['dqn']}; flips {flips}")
    check(warm.computed_count == len(cells) and all(v["computed"] == 0 for v in plain.values())
          and sum(v["computed"] for v in dqn.values()) == len(dqn_cells),
          "sweep_paper: cells computed where the cache should have served them")
    check(day["launches"] > 0, "sweep_paper: the DQN day launched nothing on the card")
    check(not any(counts.values()), f"the sweep launched a model kernel: {counts}")


def _sweep_batched_cpu(cells) -> list:
    """``run_batched_cells`` on the CPU for one group's cells, in a child
    process that does not see the card."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch

    torch.set_num_threads(1)
    from repro_torch.sweep.batched import run_batched_cells

    t0 = time.perf_counter()
    out = run_batched_cells(cells, device="cpu")
    return out, time.perf_counter() - t0


def phase_sweep_batched(torch) -> None:
    """The golden file's batched cells (3 policies x 64 paper-diurnal days, EDF-FS)
    through ``run_cells``: 3 ``simulate_batch`` groups on the card, against the
    port's CPU run of the same cells (a child process a group) and the oracle's
    (on the remaining cores), both beside the card's run, and against the
    reference's results; cells/s of both routes; one group's step under the
    profiler."""
    import concurrent.futures
    import multiprocessing

    import repro_torch.core.batched as P
    from repro_torch.core.batched import backend as PB
    from repro_torch.sweep.cells import cell_hash, cell_jobs, make_policy, make_scenario_cell
    from repro_torch.sweep.runner import run_cells

    G = _sweep_golden()
    golden = json.loads(G.GOLDEN.read_text())["batched"]
    cells = G.batched_cells(make_scenario_cell)
    check(G.hash_digest([cell_hash(c) for c in cells]) == golden["hashes"],
          "sweep_batched: the golden file holds other cells")
    n = len(G.BATCHED_SEEDS)
    groups = [cells[i:i + n] for i in range(0, len(cells), n)]
    # the cores beside the card's host loop and the CPU children run the oracle
    oracle_workers = max(1, SWEEP_WORKERS - len(groups) - 1)

    def oracle_run():
        t0 = time.perf_counter()
        out = run_cells("sweep_batched_oracle", [G.oracle_cell(c) for c in cells], workers=oracle_workers,
                        cache=False, artifacts_dir=None)
        return out.results, time.perf_counter() - t0

    _reset_counts()
    with G.working_dir(), concurrent.futures.ProcessPoolExecutor(
            len(groups), mp_context=multiprocessing.get_context("spawn")) as pool, \
            concurrent.futures.ThreadPoolExecutor(1) as side:
        cpu_futs = [pool.submit(_sweep_batched_cpu, group) for group in groups]
        oracle_fut = side.submit(oracle_run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = run_cells("sweep_batched", cells, cache=False, artifacts_dir=None).results  # the card
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        oracle, oracle_s = oracle_fut.result()
        cpu_runs = [f.result() for f in cpu_futs]
    cpu = [out for group, _ in cpu_runs for out in group]
    cpu_s = [s for _, s in cpu_runs]
    # one group (the first policy's 64 rollouts) as run_batched_cells builds it:
    # two chunks from t = 0, then SIM_PROFILED_STEPS steps timed alone and under
    # the profiler, as sim_throughput does
    head = cells[0]
    tables = P.build_tables()
    jobs = P.BatchedJobs.from_job_lists([cell_jobs(c) for c in cells[:n]], max_slots=tables.max_slots,
                                        mig_enabled=head["mig_enabled"])
    pol = P.compile_policy(make_policy(head["policy"], head["policy_kwargs"]), tables, batch=n)
    consts = PB.device_constants(tables, "partial")
    chunk, dt = P.DEFAULT_CHUNK_STEPS, P.DEFAULT_DT_MIN
    state = PB.run_steps(PB.init_state(jobs, pol.initial), jobs, pol, consts, t0_min=0.0,
                         n_steps=2 * chunk, penalty_min=tables.penalty_min)

    def steps():
        return PB.run_steps(state, jobs, pol, consts, t0_min=2 * chunk * dt, n_steps=SIM_PROFILED_STEPS,
                            penalty_min=tables.penalty_min)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    steps_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(torch, steps, top=6, host_ops=False)
    busy = prof["device_busy_ms"] or 0.0
    del state, consts, jobs
    torch.cuda.empty_cache()
    counts = _counts()

    for out in (*card, *cpu):
        out.pop("elapsed_s", None)
    card_vs_cpu = {f"{c['group']}/{c['seed']}": G.batched_off(a, b)
                   for c, a, b in zip(cells, card, cpu, strict=True) if G.batched_off(a, b)}
    card_vs_golden = {f"{c['group']}/{c['seed']}": G.batched_off(a, b)
                      for c, a, b in zip(cells, card, golden["results"], strict=True) if G.batched_off(a, b)}
    vs_oracle = G.oracle_report(cells, card, oracle, golden["results"])
    emit("sweep_batched", cells=len(cells), groups=len(G.BATCHED_POLICIES), seeds=n,
         batched_s=batched_s, batched_cells_per_s=len(cells) / batched_s,
         oracle_s=oracle_s, oracle_workers=oracle_workers, oracle_cells_per_s=len(cells) / oracle_s,
         oracle_beside_the_card=True,
         cpu_child_s=cpu_s, card_vs_cpu_off=card_vs_cpu, card_vs_golden_off=card_vs_golden,
         vs_oracle=vs_oracle,
         group_profile={"policy": head["policy"], "steps": SIM_PROFILED_STEPS, "wall_ms": steps_ms,
                        "launches_per_step": prof["launches"] / SIM_PROFILED_STEPS,
                        "device_busy_ms_per_step": busy / SIM_PROFILED_STEPS,
                        "device_idle_share": 1 - busy / steps_ms if busy else None, "top": prof["top"]},
         model_kernel_launches=counts)
    check(all(r["num_jobs"] > 0 and math.isfinite(r["energy_wh"]) for r in card), "sweep_batched: bad rollouts")
    check(not card_vs_cpu, f"sweep_batched: card against the CPU {dict(list(card_vs_cpu.items())[:8])}")
    check(not card_vs_golden, f"sweep_batched: card against the golden file {dict(list(card_vs_golden.items())[:8])}")
    check(vs_oracle["ok"], f"sweep_batched: against the oracle {vs_oracle}")
    check(prof["launches"] > 0, "sweep_batched: the profiled steps launched nothing")
    check(not any(counts.values()), f"the sweep launched a model kernel: {counts}")


def _worst(got, want, tol) -> dict:
    """The leaf of ``got`` (card tensors) farthest from ``want`` (CPU tensors) in
    units of that leaf's largest magnitude; ``ok``: every leaf within ``tol``."""
    worst, ok = {"leaf": None, "rel": 0.0}, True
    for (path, a), b in zip(got, want, strict=True):
        scale = max(float(b.abs().max()), 1e-30) if b.numel() else 1.0
        rel = float((a.cpu().float() - b.float()).abs().max()) / scale if b.numel() else 0.0
        ok &= rel <= tol
        if rel >= worst["rel"]:
            worst = {"leaf": path, "rel": rel}
    return {**worst, "ok": ok}


def phase_train_parity(torch) -> None:
    """One train step of each arch's fp32 smoke config, card against CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, AdamWConfig, OptState, linear_warmup_cosine
    from repro_torch.tree import flatten_with_paths, leaves, path_key, unflatten

    def card(t):
        return t.to("cuda")

    rows, failed = {}, []
    _reset_counts()
    for arch, accum in TRAIN_PARITY_ARCHS:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32", param_dtype="float32",
                                  remat="block")
        opt = AdamW(AdamWConfig(lr=linear_warmup_cosine(*TRAIN_PARITY_LR)))
        step = make_train_step(cfg, opt, accum_steps=accum, impl="ref")
        data = SyntheticLM(cfg, *TRAIN_PARITY_SHAPE, seed=0)
        # a non-zero optimiser state: the CPU's first step from init
        params = init_params(cfg, seed=0, device="cpu")
        p1, s1, _ = step(params, opt.init(leaves(params)), data.batch_for_step(0))
        batch = data.batch_for_step(1)
        p_cpu, s_cpu, m_cpu = step(p1, s1, batch)
        p1_card = unflatten(p1, [card(t) for t in leaves(p1)])
        s1_card = OptState(m=[card(t) for t in s1.m], v=[card(t) for t in s1.v], step=card(s1.step))
        t0 = time.perf_counter()
        p_card, s_card, m_card = step(p1_card, s1_card, batch)
        loss = float(m_card["loss"])
        card_s = time.perf_counter() - t0
        paths = [path_key(p) for p, _ in flatten_with_paths(p_cpu)]
        row = {
            "accum_steps": accum, "loss_card": loss, "loss_cpu": float(m_cpu["loss"]),
            "loss_rel": abs(loss - float(m_cpu["loss"])) / abs(float(m_cpu["loss"])),
            "grad_norm_card": float(m_card["grad_norm"]), "grad_norm_cpu": float(m_cpu["grad_norm"]),
            "step": [int(m_card["step"]), int(m_cpu["step"])], "card_step_s": card_s,
            "params": _worst(zip(paths, leaves(p_card)), leaves(p_cpu), TRAIN_PARAM_TOL),
            "m": _worst(zip(paths, s_card.m), s_cpu.m, TRAIN_STATE_TOL),
            "v": _worst(zip(paths, s_card.v), s_cpu.v, TRAIN_STATE_TOL),
        }
        row["grad_norm_rel"] = abs(row["grad_norm_card"] - row["grad_norm_cpu"]) / row["grad_norm_cpu"]
        rows[arch] = row
        row["on_card"] = p_card["embed"].is_cuda and m_card["loss"].is_cuda
        if not (row["loss_rel"] <= TRAIN_RTOL and row["grad_norm_rel"] <= TRAIN_RTOL
                and row["step"] == [2, 2] and all(row[k]["ok"] for k in ("params", "m", "v"))
                and row["on_card"]):
            failed.append(arch)
        del p1_card, s1_card, p_card, s_card
    counts = _counts()
    emit("train_parity", rows=rows, bars={"loss_rel": TRAIN_RTOL, "grad_norm_rel": TRAIN_RTOL,
                                          "params": TRAIN_PARAM_TOL, "m_v": TRAIN_STATE_TOL},
         model_kernel_launches=counts)
    check(not failed, f"train_parity: off the bars: {failed}")
    check(not any(counts.values()), f"the trainer launched a model kernel: {counts}")


def _dir_gb(path) -> dict:
    files = [os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs]
    return {"gb": sum(os.path.getsize(f) for f in files) / 1e9, "files": len(files)}


def phase_train(torch) -> None:
    """gemma3-1b trained at full width by the port's driver; resumed from its own
    step-3 checkpoint; one step under the profiler."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, AdamWConfig, linear_warmup_cosine
    from repro_torch.tree import leaves

    directory = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        emit("train_disk", directory=directory, free_gb=shutil.disk_usage(directory).free / 1e9)
        args = {"smoke": TRAIN_SMOKE, "ckpt_dir": directory, "verbose": False, **TRAIN_ARGS}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        first = {}
        t0 = time.perf_counter()
        params, losses = train(TRAIN_ARCH, stats=first, **args)
        wall_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(p.numel() for p in leaves(params))
        del params
        torch.cuda.empty_cache()
        steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
        ckpts = {d: _dir_gb(os.path.join(directory, d)) for d in steps}
        last = f"step_{TRAIN_ARGS['steps']:08d}"
        shutil.rmtree(os.path.join(directory, last))
        second = {}
        t0 = time.perf_counter()
        params, resumed = train(TRAIN_ARCH, stats=second, **args)
        resume_wall_s = time.perf_counter() - t0
        counts = _counts()
        del params
        torch.cuda.empty_cache()
        resumed_ckpt = _dir_gb(os.path.join(directory, last))
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    # one step of the same configuration under the profiler, after a warm-up step
    cfg = get_config(TRAIN_ARCH) if not TRAIN_SMOKE else smoke_config(TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, scan_layers=True, remat="block")
    opt = AdamW(AdamWConfig(lr=linear_warmup_cosine(3e-4, 1, TRAIN_ARGS["steps"])))
    step = make_train_step(cfg, opt, impl="ref")
    params = init_params(cfg, seed=0)
    state = opt.init(leaves(params))
    batch = SyntheticLM(cfg, TRAIN_ARGS["global_batch"], TRAIN_ARGS["seq_len"]).batch_for_step(0)
    params, state, _ = step(params, state, batch)
    box = {}

    def one_step():
        box["out"] = step(params, state, batch)

    prof = _profile(torch, one_step, top=10, host_ops=False)
    del params, state, box
    torch.cuda.empty_cache()

    k = TRAIN_ARGS["ckpt_every"]
    step_ms = float(np.median(first["step_s"][1:])) * 1e3
    MEASURED["train_step_ms"] = step_ms
    tokens = TRAIN_ARGS["global_batch"] * TRAIN_ARGS["seq_len"]
    again = losses[k:]
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, again)) if resumed else None
    row = {
        "arch": TRAIN_ARCH, "smoke": TRAIN_SMOKE, **TRAIN_ARGS, "parameters": n_params,
        "losses": losses, "resumed_losses": resumed, "resume_max_rel_diff": resume_rel,
        "resume_bitwise": resumed == again, "wall_s": wall_s, "resume_wall_s": resume_wall_s,
        "step_s": first["step_s"], "resumed_step_s": second["step_s"],
        "ms_per_step": step_ms, "tokens_per_s": tokens / (step_ms / 1e3), "peak_gb": peak_gb,
        "checkpoints": ckpts, "resumed_checkpoint": resumed_ckpt,
        "snapshot_s": [t["snapshot_s"] for t in first["timings"] + second["timings"]],
        "write_s": [t.get("write_s") for t in first["timings"] + second["timings"]],
        "restore_s": second["restore_s"],
        "profile_one_step": prof,
        "device_idle_share": prof["device_idle_share"],
        "model_kernel_launches": counts,
    }
    emit("train", **row)
    check(len(losses) == TRAIN_ARGS["steps"] and all(math.isfinite(x) for x in losses),
          f"train: losses {losses}")
    check(first["restore_s"] is None and second["restore_s"] is not None,
          "train: the first run restored, or the second did not")
    check(len(resumed) == TRAIN_ARGS["steps"] - k and resume_rel <= TRAIN_RESUME_RTOL,
          f"train: resumed {resumed} against {again}")
    check(steps == [f"step_{s:08d}" for s in range(k, TRAIN_ARGS["steps"] + 1, k)],
          f"train: checkpoints {steps}")
    check(not any(counts.values()), f"the trainer launched a model kernel: {counts}")



# ------------------------- the service and the pod's day -------------------------


def _service_golden():
    """tests/torch_service_golden.py: the golden file's inputs and comparisons."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_service_golden

    return torch_service_golden


def _port_package(device=None):
    """The port's classes as torch_service_golden runs them; the greedy DQN's
    Q network on ``device`` (None: the card)."""
    import repro_torch.core.scenarios as scenarios
    import repro_torch.core.simulator as simulator
    import repro_torch.distributed.fault_tolerance as fault_tolerance
    import repro_torch.launch.cluster_sim as cluster_sim
    import repro_torch.service as service

    return _service_golden().package_from(
        service, scenarios, cluster_sim, simulator, fault_tolerance,
        lambda params: cluster_sim.day_policy_factory("dynamic", params, device))


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _held(G, got, want) -> dict:
    off = G.off(got, want)
    return {"equal": not off, "max_rel_diff": G.max_rel(got, want), "off": off[:6]}


def _service_children() -> dict:
    """Start ``service``'s two child processes in a temporary directory:
    ``python -m repro_torch.service replay`` (the SIGKILL's victim, killed by
    a watcher thread once its WAL holds REPLAY_KILL_AFTER lines) and ``...
    serve`` (the socket load's server)."""
    import signal
    import tempfile
    import threading

    G = _service_golden()
    work = Path(tempfile.mkdtemp(prefix="svc-"))
    env = _child_env()
    c = {"work": work, "t0": time.perf_counter(), "killed": {}, "victim_dir": work / "victim",
         "load_dir": work / "load", "sock": work / "load.sock"}
    c["victim"] = subprocess.Popen([sys.executable, *G.replay_argv("repro_torch", c["victim_dir"])],
                                   env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    c["server"] = subprocess.Popen([sys.executable, "-m", "repro_torch.service",
                                    *G.load_serve_args(c["load_dir"], c["sock"])], env=env,
                                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def watch():
        victim = c["victim"]
        while victim.poll() is None and time.perf_counter() - c["t0"] < 300.0:
            n = G.wal_lines(c["victim_dir"] / "wal.jsonl")
            if n >= G.REPLAY_KILL_AFTER:
                victim.send_signal(signal.SIGKILL)
                c["killed"].update(wal_lines=n, at_s=time.perf_counter() - c["t0"])
                return
            time.sleep(0.01)

    c["watcher"] = threading.Thread(target=watch, daemon=True)
    c["watcher"].start()
    return c


def _stop_children(children: dict) -> None:
    """Kill whichever child still runs and remove the temporary directory."""
    import shutil

    for proc in (children["victim"], children["server"]):
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    shutil.rmtree(children["work"], ignore_errors=True)


def phase_service(torch, children: dict) -> None:
    """The scheduler service, host code: the crash matrix, fleet mode, a real
    SIGKILL of ``python -m repro_torch.service replay``, the soak's day, a
    socket round trip and the socket load against ``serve`` (both children
    started by :func:`_service_children`), each against the golden file."""
    import signal
    import threading

    G = _service_golden()
    pkg = _port_package()
    golden = json.loads(G.GOLDEN.read_text())["service"]
    work, victim, server, sock = children["work"], children["victim"], children["server"], children["sock"]
    victim_dir, watcher, killed = children["victim_dir"], children["watcher"], children["killed"]
    t_phase = time.perf_counter()
    try:
        _reset_counts()
        out, seconds = {}, {}
        t0 = time.perf_counter()
        crash = {}
        for policy in G.POLICIES:
            for mode in G.MODES:
                key = f"{policy}/{mode}"
                want = golden["crash"][key]
                d = work / f"crash-{policy}-{mode}"
                oracle = G.crash_oracle(pkg, d / "oracle", policy, mode)
                runs = G.crash_recovered(pkg, d, policy, mode)
                crash[key] = {"uninterrupted": _held(G, oracle, want),
                              "recovered": [{"cut": r["cut"], "recovered_ops": r["recovered_ops"],
                                             **_held(G, r["result"], want["result"])} for r in runs]}
        seconds["crash_matrix"] = time.perf_counter() - t0
        out["crash"] = crash
        t0 = time.perf_counter()
        out["fleet"] = _held(G, G.fleet_recovered(pkg, work / "fleet"), golden["fleet"])
        seconds["fleet"] = time.perf_counter() - t0
        m = G.soak(pkg, work / "soak")
        out["soak"] = {**_held(G, m.pop("result"), golden["soak"]), **m, "bounds_ok": G.soak_ok(m)}
        seconds["soak"] = m["wall_s"]

        # the SIGKILLed replay, recovered in this process and fed the rest
        watcher.join(timeout=300.0)
        victim.wait(timeout=60)
        t0 = time.perf_counter()
        resumed = G.replay_resume(pkg, victim_dir)
        out["sigkill"] = {**_held(G, resumed.pop("result"), golden["replay"]), **resumed, **killed,
                          "returncode": victim.returncode}
        seconds["sigkill_resume"] = time.perf_counter() - t0

        # a round trip through ServiceServer on a unix socket, in a thread
        rt_sock = work / "rt.sock"
        svc = pkg.SchedulerService(work / "rt", G.socket_config(pkg))
        srv = pkg.ServiceServer(svc, rt_sock, tick_interval_s=0.01)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        pkg.wait_for_socket(rt_sock, timeout_s=10.0)
        client = pkg.ServiceClient(rt_sock)
        rt = G.socket_script(client)
        client.shutdown()
        client.close()
        thread.join(timeout=10)
        out["socket"] = {**_held(G, rt["result"], golden["socket"]), "checks": rt["checks"],
                         "server_exited": not thread.is_alive() and not rt_sock.exists()}

        # the socket load against the serve child
        t0 = time.perf_counter()
        pkg.wait_for_socket(sock, timeout_s=120.0)
        seconds["server_ready_after_start_s"] = time.perf_counter() - children["t0"]
        client = pkg.ServiceClient(sock)
        load = G.load_feed(client)
        client.shutdown()
        client.close()
        server.wait(timeout=60)
        out["load"] = {**_held(G, load.pop("result"), golden["load"]), **load,
                       "server_returncode": server.returncode}
        seconds["load"] = time.perf_counter() - t0
    finally:
        _stop_children(children)
    counts = _counts()
    results = [c["uninterrupted"] for c in out["crash"].values()]
    results += [r for c in out["crash"].values() for r in c["recovered"]]
    results += [out[k] for k in ("fleet", "soak", "sigkill", "socket", "load")]
    emit("service", **out, seconds=seconds, phase_s=time.perf_counter() - t_phase,
         max_rel_diff=max(r["max_rel_diff"] for r in results),
         floors={"jobs_per_min": G.LOAD_MIN_JOBS_PER_MIN, "p99_ms": G.LOAD_MAX_P99_MS},
         model_kernel_launches=counts)
    check(all(r["equal"] for r in results), f"service: results off the golden file: "
          f"{[r['off'] for r in results if not r['equal']][:4]}")
    check(sum(len(c["recovered"]) for c in out["crash"].values()) == 4 * G.CRASH_CUTS,
          "service: the crash matrix's recovered runs")
    check(out["soak"]["bounds_ok"], f"service: the soak's bounds: {out['soak']}")
    check(out["sigkill"]["returncode"] == -signal.SIGKILL
          and 0 < out["sigkill"]["known_at_recovery"] < G.REPLAY_JOBS,
          f"service: the replay was not killed mid-feed: {out['sigkill']}")
    check(all(out["socket"]["checks"].values()) and out["socket"]["server_exited"],
          f"service: socket round trip {out['socket']}")
    check(out["load"]["jobs_per_min"] >= G.LOAD_MIN_JOBS_PER_MIN and out["load"]["p99_ms"] < G.LOAD_MAX_P99_MS
          and out["load"]["server_returncode"] == 0, f"service: the socket load's floors: {out['load']}")
    check(not any(counts.values()), f"the service launched a model kernel: {counts}")


def phase_cluster_day(torch) -> None:
    """``run_days`` on the simulated pod for each golden run (the DQN's Q
    network on the card), against the golden file; the DQN days again with
    every decision logged and held to a CPU learner; one DQN day profiled."""
    from repro_torch.core.rl import DQNConfig, DQNLearner, greedy_policy
    from repro_torch.core.rl.env import FEATURE_DIM
    from repro_torch.launch import evaluate as PE
    from repro_torch.launch.cluster_sim import run_days

    G = _service_golden()
    pkg = _port_package()  # the DQN on the card
    golden = json.loads(G.GOLDEN.read_text())["cluster"]
    t_phase = time.perf_counter()
    _reset_counts()
    runs = {}
    for name, run in G.cluster_runs(pkg).items():
        t0 = time.perf_counter()
        got = [G.as_dict(r) for r in run()]
        runs[name] = {**_held(G, got, golden[name]), "seconds": time.perf_counter() - t0,
                      "jobs": [d["num_jobs"] for d in got], "repartitions": [d["repartitions"] for d in got],
                      "energy_kwh": [d["energy_wh"] / 1e3 for d in got]}

    def learner(device):
        lrn = DQNLearner(DQNConfig(state_dim=FEATURE_DIM), device=device)
        lrn.load(str(G.RL_PARAMS))
        return lrn

    # the DQN days again, every greedy decision logged; the CPU's actions
    card, cpu = learner(None), learner("cpu")
    logged, flips = {}, {}
    for name, failures in (("dynamic", None), ("dynamic_failures", pkg.FailureModel(**G.FAILURES))):
        log = PE.DecisionLog(card)
        t0 = time.perf_counter()
        got = [G.as_dict(r) for r in run_days(lambda log=log: greedy_policy(log), iterations=G.CLUSTER_DAYS,
                                              failures=failures, seed=G.CLUSTER_SEED)]
        f = PE.action_flips(log, cpu)
        logged[name] = {**_held(G, got, golden[name]), "decisions": len(log.records),
                        "seconds": time.perf_counter() - t0, "n_flips": len(f)}
        flips[name] = f[:8]
    # the Q network's cost: one DQN day under the profiler
    day = PE.DecisionLog(card)
    prof = _profile(torch, lambda: run_days(lambda: greedy_policy(day), iterations=1, seed=G.CLUSTER_SEED),
                    top=6, host_ops=False)
    n = max(len(day.records), 1)
    counts = _counts()
    results = list(runs.values()) + list(logged.values())
    emit("cluster_day", runs=runs, logged=logged, flips=flips,
         q_network={"day_decisions": len(day.records), "day_wall_ms": prof["wall_ms"],
                    "launches_per_decision": prof["launches"] / n,
                    "device_busy_ms_per_decision": (prof["device_busy_ms"] or 0.0) / n,
                    "wall_ms_per_decision": prof["wall_ms"] / n,
                    "device_idle_share": prof["device_idle_share"], "top": prof["top"]},
         max_rel_diff=max(r["max_rel_diff"] for r in results), phase_s=time.perf_counter() - t_phase,
         model_kernel_launches=counts)
    check(all(r["equal"] for r in results),
          f"cluster_day: days off the golden file: {[r['off'] for r in results if not r['equal']][:4]}")
    check(all(v["n_flips"] == 0 and v["decisions"] > 0 for v in logged.values()),
          f"cluster_day: card and CPU actions differ: {flips}")
    check(prof["launches"] > 0, "cluster_day: the Q network launched nothing on the card")
    check(not any(counts.values()), f"the pod's day launched a model kernel: {counts}")


# ---------------------- the sharding layer and the dry-run ----------------------


def _dryrun_job(job):
    """One dry-run job in a child process that does not see the card, at the
    lowest CPU priority: a production cell's record (``run_cell`` on a fake
    world of 256), or the count of one of this script's own gemma3-1b steps on
    a 1x1 mesh. Fake tensors on the CPU: nothing runs."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.nice(19)
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as D

    kind, arch, shape = job
    t0 = time.perf_counter()
    if kind == "cell":
        rec = D.run_cell(arch, shape, multi_pod=False, with_cost=False, device="cpu")
    else:
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.shapes import ShapeSpec

        D.fake_world(1)
        name, seq, batch = ROOFLINE_STEPS[shape]
        rec = D.lower_cell(arch, ShapeSpec(shape, name, seq, batch),
                           make_smoke_mesh(1, 1, device="cpu"), device="cpu")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _dryrun_children():
    """The dry-run's jobs, one child process each, started together."""
    import concurrent.futures
    import multiprocessing

    jobs = [("cell", a, sh) for a, sh in DRYRUN_CELLS] + [
        ("count", "gemma3-1b", name) for name in ROOFLINE_STEPS]
    pool = concurrent.futures.ProcessPoolExecutor(
        len(jobs), mp_context=multiprocessing.get_context("spawn"))
    return pool, {job: pool.submit(_dryrun_job, job) for job in jobs}


def _gb(x):
    return None if x is None else x / 1e9


def phase_dryrun(torch, pool, futs) -> None:
    """The port's dry-run of DRYRUN_CELLS on the (16, 16) production mesh: per
    cell ok or skip, the arguments and temporaries in GB a card (modelled),
    ``fits``, FLOPs, bytes, collective bytes by kind, the three roofline terms
    at the H100's constants, the dominant one, the seconds taken. Then the
    ``roofline`` line: the gemma3-1b prefill and train step of this script,
    their model FLOPs' bound at the H100's bf16 peak beside the times the
    prefill and train phases measured (the MFU), and the FLOPs a trace of
    each on a 1x1 mesh counts."""
    from repro_torch.analysis.constants import CHIP_FLOPS_BF16
    from repro_torch.analysis.roofline import roofline_terms, step_model_flops

    t0 = time.perf_counter()
    try:
        recs = {job: fut.result() for job, fut in futs.items()}
    finally:
        pool.shutdown()
    waited_s = time.perf_counter() - t0
    cells = []
    for arch, shape in DRYRUN_CELLS:
        rec = recs[("cell", arch, shape)]
        row = {"arch": arch, "shape": shape, "seconds": rec["seconds"]}
        if rec.get("skipped"):
            row.update(status="skip", reason=rec["reason"])
        else:
            rec["ok"] = True
            terms = roofline_terms(rec)
            row.update(status="ok", args_gb=_gb(rec["argument_size_in_bytes"]),
                       temp_gb=_gb(rec["temp_size_in_bytes"]), fits=rec["fits"],
                       flops=rec["flops"], bytes_accessed=rec["bytes_accessed"],
                       collectives=rec["collectives"], accum_steps=rec.get("accum_steps"),
                       depth_extrapolated=rec.get("depth_extrapolated"),
                       t_compute_s=terms["t_compute_s"], t_memory_s=terms["t_memory_s"],
                       t_collective_s=terms["t_collective_s"], dominant=terms["dominant"])
        cells.append(row)
    emit("dryrun", devices=256, mesh="16x16", waited_s=waited_s, cells=cells,
         notes="per card, modelled on a fake process group under FakeTensorMode (nothing ran "
               "on a card); bytes unfused, an upper bound; flops count matmuls only")
    for row in cells:
        if (row["arch"], row["shape"]) == ("nemotron-4-340b", "long_500k"):
            check(row["status"] == "skip" and row["reason"] == NEMOTRON_LONG_SKIP,
                  f"dryrun: nemotron long_500k did not skip with the reference's reason: {row}")
        else:
            check(row["status"] == "ok", f"dryrun: {row['arch']} {row['shape']} did not lower")

    steps = {}
    for name, measured in (("prefill", MEASURED.get("prefill_ms")),
                           ("train", MEASURED.get("train_step_ms"))):
        rec = dict(recs[("count", "gemma3-1b", name)], ok=True, devices=1)
        kind, seq, batch = ROOFLINE_STEPS[name]
        # MFU's numerator: the model's FLOPs (2N / 6N a token, the attention
        # the masks keep); the counted ones, at impl="ref", add the full
        # S x S scores and the rematerialised forward
        mf = step_model_flops("gemma3_1b", kind, seq, batch)
        bound_ms = mf / CHIP_FLOPS_BF16 * 1e3
        counted_ms = roofline_terms(rec)["t_compute_s"] * 1e3
        steps[name] = {"B": batch, "S": seq, "model_flops": mf, "bound_ms": bound_ms,
                       "bound_by": "operations", "measured_ms": measured,
                       "mfu": bound_ms / measured if measured else None,
                       "counted_flops": rec["flops"], "counted_bound_ms": counted_ms,
                       "counted_share": counted_ms / measured if measured else None,
                       "bytes_accessed_unfused": rec["bytes_accessed"]}
    emit("roofline", arch="gemma3-1b", mesh="1x1", steps=steps,
         notes="mfu = the step's model FLOPs (2N prefill / 6N train a token, N active, plus the "
               "causal and 512-window attention products) at the 989 TFLOP/s bf16 peak over its "
               "measured ms (prefill: median of 5 forwards, which run flash attention; train: "
               "median of 5 steps); counted_* = the FLOPs a 1x1-mesh trace at impl='ref' "
               "counts (matmuls, full S x S scores, remat); bytes unfused, an upper bound")
    check(all(v["measured_ms"] for v in steps.values()), f"roofline: a step was not measured: {steps}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded_step(torch, device: str = "cuda", backend: str = "nccl") -> None:
    """The sharding layer on the card: an NCCL world of one (a TCP store on
    localhost) and a 1x1 mesh. gemma3-1b's smoke train step on DTensors
    equals the same step without a mesh bit for bit (loss, every parameter,
    m and v); four ``serve`` steps on the mesh equal them without it at
    ``impl="ref"`` (a cache on a mesh is attended by the plain split-K path,
    never by K5);
    ``compressed_psum`` over the world of one equals ``ef_compress``. The
    process group is destroyed before the next phase."""
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.compression import compressed_psum, ef_compress
    from repro_torch.distributed.sharding import (
        batch_shardings,
        cache_shardings,
        distribute_tree,
        full_tree,
        param_shardings,
    )
    from repro_torch.distributed.step import make_serve_step, make_train_step
    from repro_torch.launch.mesh import make_smoke_mesh, set_ambient_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.tree import leaves

    t_start = time.perf_counter()
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh(1, 1, device=device)
        set_ambient_mesh(None)
        cfg = smoke_config(SHARDED_ARCH)
        B, S, accum = SHARDED_SHAPE
        params = init_params(cfg, seed=0, device=device)
        opt = AdamW(AdamWConfig(lr=1e-3))
        step = make_train_step(cfg, opt, accum_steps=accum, impl="ref")
        batch = SyntheticLM(cfg, B, S, seed=0).batch_for_step(0)
        plain = step(params, opt.init(leaves(params)), batch)

        set_ambient_mesh(mesh)
        t0 = time.perf_counter()
        dp = distribute_tree(params, param_shardings(params, mesh), mesh)
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        db = distribute_tree(tb, batch_shardings(tb, mesh), mesh)
        on_mesh = step(dp, opt.init(leaves(dp)), db)
        mesh_step_s = time.perf_counter() - t0
        got = leaves(full_tree((on_mesh[0], on_mesh[1].m, on_mesh[1].v)))
        want = leaves((plain[0], plain[1].m, plain[1].v))
        train_equal = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        loss_equal = torch.equal(on_mesh[2]["loss"].full_tensor(), plain[2]["loss"])

        serve = make_serve_step(cfg, impl="ref")
        tok = torch.arange(B, device=device)[:, None] % cfg.vocab_size
        set_ambient_mesh(None)
        cache = init_cache(cfg, B, S, device=device)
        want_logits = []
        with torch.no_grad():  # DTensor views fail under inference_mode
            for i in range(4):
                lg, cache = serve(params, cache, tok + i, i)
                want_logits.append(lg)
        set_ambient_mesh(mesh)
        cache = init_cache(cfg, B, S, device=device)
        cache = distribute_tree(cache, cache_shardings(cache, mesh, B), mesh)
        dtok = distribute_tree({"t": tok}, batch_shardings({"t": tok}, mesh), mesh)["t"]
        serve_equal = True
        with torch.no_grad():
            for i in range(4):
                lg, cache = serve(dp, cache, dtok + i, i)
                serve_equal &= torch.equal(lg.full_tensor(), want_logits[i])

        gen = torch.Generator(device=device).manual_seed(0)
        g = torch.randn(3 * 2048 + 77, generator=gen, device=device)
        e = torch.randn(3 * 2048 + 77, generator=gen, device=device) * 1e-3
        red, new_e = compressed_psum({"w": g}, {"w": e})
        dec, err = ef_compress(g, e)
        psum_equal = torch.equal(red["w"], dec) and torch.equal(new_e["w"], err)
    finally:
        set_ambient_mesh(None)
        dist.destroy_process_group()
    emit("sharded_step", arch=SHARDED_ARCH, smoke=True, backend=backend, mesh="1x1",
         global_batch=B, seq_len=S, accum_steps=accum, train_bitwise=train_equal,
         loss_bitwise=loss_equal, serve_bitwise=serve_equal, compressed_psum_equal=psum_equal,
         mesh_step_s=mesh_step_s, seconds=time.perf_counter() - t_start)
    check(train_equal and loss_equal, "sharded_step: the train step on the mesh differs")
    check(serve_equal, "sharded_step: serve on the mesh differs")
    check(psum_equal, "sharded_step: compressed_psum over one rank differs from ef_compress")

if __name__ == "__main__":
    sys.exit(main())
