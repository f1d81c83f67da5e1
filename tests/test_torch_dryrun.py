"""The port's dry-run and roofline (repro_torch.launch.dryrun,
repro_torch.analysis) against the JAX package's, on the CPU.

* ``cell_applicable`` and its skip reasons, and ``model_flops``, equal the
  reference's for all 40 cells;
* ``roofline_terms`` and ``roofline_row`` fed one record (with and without
  a composite cost), at the reference's TPU constants, give the reference's
  output exactly; at the default constants, the H100's;
* the per-device ``argument_size_in_bytes`` of a smoke train cell on a (4, 2)
  mesh equals the reference's compiled ``memory_analysis()`` (the reference in
  a subprocess with placeholder devices, tests/torch_sharding_reference.py);
* ``composite_cost``'s FLOPs equal a direct count of the whole model;
* one ``dense`` under known placements counts the hand-counted FLOPs and
  all-gather bytes;
* gemma3-1b's ``train_4k`` cell at its full config on the 256-rank fake mesh
  lowers, and fits in 80 GB a card;
* ``step_model_flops`` (an MFU's numerator) counts the attention pairs that
  the model's own masks keep.

The fake process group is process-wide: each test that needs one sets it up
and the module tears it down.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.analysis.constants as tpu
import repro.analysis.roofline as jax_roofline
from repro.analysis.roofline import model_flops as jax_model_flops
from repro.launch.shapes import cell_applicable as jax_cell_applicable
from repro_torch.analysis import constants as h100
from repro_torch.analysis.roofline import (
    attention_flops,
    model_flops,
    roofline_row,
    roofline_terms,
    step_model_flops,
)
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.ref import _attn_mask
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_smoke_mesh, set_ambient_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, all_cells, cell_applicable
from repro_torch.models.layers import dense
from repro_torch.models.transformer import _window

HERE = os.path.dirname(__file__)
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
SMOKE_CELL = ShapeSpec("t", "train", 64, 8)
ARG_ARCHS = ["stablelm_3b"]  # dense: the reference's MoE/scan hints raise


def _env():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """The module's subprocesses, started together at its first test and
    awaited by the tests that read them: the reference's compiled cells and
    the port's gemma3-1b cell at full config (the CLI, as a user runs it)."""
    d = tmp_path_factory.mktemp("dryrun")
    (d / "in.json").write_text(json.dumps(
        {"archs": ARG_ARCHS, "seq": SMOKE_CELL.seq_len, "batch": SMOKE_CELL.global_batch}))
    started = {
        "ref": subprocess.Popen([sys.executable, os.path.join(HERE, "torch_sharding_reference.py"),
                                 "dryrun", str(d / "in.json"), str(d / "ref.json")], env=_env()),
        "gemma": subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                   "gemma3-1b", "--shape", "train_4k", "--no-cost", "--device",
                                   "cpu", "--out", str(d)], env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True),
    }
    yield d, started
    for p in started.values():
        if p.poll() is None:
            p.kill()
    set_ambient_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def _wait(proc) -> None:
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out


def test_cell_applicability_and_model_flops_equal_the_references():
    cells = list(all_cells())
    assert len(cells) == 40
    for arch, shape in cells:
        assert cell_applicable(arch, shape.name) == jax_cell_applicable(arch, shape.name)
        assert model_flops(arch, shape.name) == jax_model_flops(arch, shape.name), (arch, shape)
    assert cell_applicable("nemotron-4-340b", "long_500k") == (
        False, "pure full attention (quadratic prefill, O(seq) full-KV decode)")


def _record(with_cost: bool) -> dict:
    rec = {"ok": True, "devices": 256, "flops": 3.25e14, "bytes_accessed": 7.5e12,
           "collectives": {"all-gather": 2.5e10, "all-reduce": 1.25e10},
           "temp_size_in_bytes": 1.1e10, "argument_size_in_bytes": 4.0e7}
    if with_cost:
        rec["cost"] = {"composite": {"flops": 4.5e14, "bytes_accessed": 9.0e12,
                                     "collectives": {"all-gather": 3.0e10, "reduce-scatter": 1e9},
                                     "repeats": 26}}
    return rec


@pytest.mark.parametrize("with_cost", [False, True])
def test_roofline_terms_and_rows_equal_the_references_at_its_constants(tmp_path, monkeypatch,
                                                                        with_cost):
    rec = _record(with_cost)
    assert roofline_terms(rec, tpu) == jax_roofline.roofline_terms(rec)
    (tmp_path / "gemma3-1b__train_4k__pod.json").write_text(json.dumps(rec))
    monkeypatch.setattr(jax_roofline, "ART_DIR", str(tmp_path))
    want = jax_roofline.roofline_row("gemma3-1b", "train_4k")
    assert roofline_row("gemma3-1b", "train_4k", constants=tpu, art_dir=str(tmp_path)) == want
    h = roofline_terms(rec)  # the H100's constants by default
    flops = (rec["cost"]["composite"] if with_cost else rec)["flops"]
    assert h["t_compute_s"] == flops * 256 / (256 * h100.CHIP_FLOPS_BF16)


def test_h100_constants():
    assert (h100.CHIP_FLOPS_BF16, h100.CHIP_FLOPS_FP32, h100.HBM_BW, h100.HBM_BYTES,
            h100.LINK_BW) == (989e12, 67e12, 3.35e12, 80e9, 50e9)
    assert h100.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


@pytest.mark.parametrize("arch,seq", [("gemma3_1b", 1300), ("mixtral_8x7b", 4500),
                                      ("jamba_v01_52b", 700), ("xlstm_350m", 300)])
def test_step_model_flops_count_the_pairs_the_masks_keep(arch, seq):
    cfg = get_config(arch)
    pos = torch.arange(seq)
    pairs = sum(int(_attn_mask(pos, pos, True, _window(cfg, k)).sum())
                for k in cfg.layer_kinds() if k in ("attn", "local"))
    per_pair = 4 * cfg.n_heads * cfg.resolved_head_dim
    assert attention_flops(cfg, "prefill", seq, 3) == per_pair * pairs * 3
    assert attention_flops(cfg, "train", seq, 3) == 3 * per_pair * pairs * 3
    n = cfg.param_count(active_only=True)
    assert step_model_flops(arch, "prefill", seq, 3) == 2.0 * n * seq * 3 + per_pair * pairs * 3
    assert step_model_flops(arch, "train", seq, 3) == 6.0 * n * seq * 3 + 3 * per_pair * pairs * 3


def _smoke(arch):
    return dataclasses.replace(smoke_config(arch), scan_layers=True, remat="block")


def test_argument_bytes_equal_the_references_compiled_memory_analysis(procs):
    d, started = procs
    dryrun.fake_world(8)
    mesh = make_smoke_mesh(4, 2, device="cpu")
    got = {arch: dryrun.lower_cell(arch, SMOKE_CELL, mesh, cfg=_smoke(arch))
           for arch in ARG_ARCHS}
    _wait(started["ref"])
    want = json.loads((d / "ref.json").read_text())
    for arch in ARG_ARCHS:
        assert got[arch]["argument_size_in_bytes"] == want[arch]["argument_size_in_bytes"], arch


def test_composite_cost_equals_a_direct_count_of_the_whole_model():
    dryrun.fake_world(8)
    mesh = make_smoke_mesh(4, 2, device="cpu")
    arch = "stablelm_3b"  # four one-layer pattern units
    base = smoke_config(arch)
    comp = dryrun.composite_cost(arch, SMOKE_CELL, mesh, base=base)["composite"]
    whole = dryrun.lower_cell(arch, SMOKE_CELL, mesh, cfg=dryrun.runtime_config(
        arch, True, base.num_pattern_repeats, base))
    assert comp["repeats"] == base.num_pattern_repeats == 4
    assert comp["flops"] == whole["flops"] and comp["flops"] > 0


def test_one_linear_counts_its_flops_and_its_fsdp_gather():
    """x (8, 16, 32) rows over "data" (4), w (32, 64) as ("data", "model"):
    the weight's data shards are gathered, (32, 32) fp32 = 4,096 bytes, and
    the local product is (2 * 16) x 32 x 32, 2 * 32,768 FLOPs."""
    dryrun.fake_world(8)
    mesh = make_smoke_mesh(4, 2, device="cpu")
    set_ambient_mesh(mesh)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = dryrun._placed(torch.empty(8, 16, 32), ("data", None, None), mesh, "cpu")
            w = dryrun._placed(torch.empty(32, 64), ("data", "model"), mesh, "cpu")
            cost = dryrun.CostMode()
            with cost:
                y = dense(w, x)
        assert tuple(y.shape) == (8, 16, 64) and tuple(y.to_local().shape) == (2, 16, 32)
        assert cost.flops == 2 * (2 * 16) * 32 * 32
        assert cost.collectives == {"all-gather": 32 * 32 * 4}
    finally:
        set_ambient_mesh(None)


def test_gemma3_1b_train_4k_lowers_and_fits_on_the_production_mesh(procs):
    d, started = procs
    _wait(started["gemma"])
    rec = json.loads((d / "gemma3-1b__train_4k__pod.json").read_text())
    assert rec["ok"], rec.get("error")
    assert rec["devices"] == 256 and rec["accum_steps"] == 2
    assert rec["fits"] and 0 < rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"] <= 80e9
    assert rec["flops"] >= model_flops("gemma3-1b", "train_4k") / 256
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter"}
    assert SHAPES["train_4k"].global_batch == 256


def test_chip_smoke_reads_the_peaks_from_the_constants_module(monkeypatch):
    """chip_smoke.py's kernel bounds take the H100's peaks from
    repro_torch.analysis.constants, and give the numbers the peaks it held
    itself gave (989 TFLOP/s bf16, 67 TFLOP/s fp32, 3.35 TB/s)."""
    root = os.path.abspath(os.path.join(HERE, ".."))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as C

    assert C.PEAK_FLOPS is h100.PEAK_FLOPS and C.PEAK_BYTES == h100.HBM_BW

    def bounds():
        return ([C._bound_ms(case) for case in C.ATTN_CASES]
                + [C._scan_bound(case) for case in C.MAMBA_CASES]
                + [C._mlstm_bound(2, 2048, 4, 512, dt, 64) for dt in ("float32", "bfloat16")]
                + [C._gmm_bound(4096, 1536, 512, 40, ib, ob) for ib, ob in ((2, 4), (4, 4))])

    got = bounds()
    monkeypatch.setattr(C, "PEAK_FLOPS", {"bfloat16": 989e12, "float32": 67e12})
    monkeypatch.setattr(C, "PEAK_BYTES", 3.35e12)
    assert got == bounds()
