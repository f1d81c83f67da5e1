#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It puts
``src`` on ``sys.path`` itself, imports nothing of JAX or of the JAX package
``repro``, builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/`` and runs these phases, each printing one JSON line:

1. device   — the card, the toolchain, the kernel build (seconds, ptxas -v).
2. kernels  — each kernel against its plain PyTorch version on the card:
              the attention cases of tests/test_kernels.py plus the gemma3-1b
              prefill shapes (tolerance 2e-5 fp32, 2e-2 bf16).
3. prefill  — full-width gemma3-1b ``forward`` on B=2, S=2048: fp32 kernel
              vs plain logits, the bf16 main path (launch counts, tokens/s,
              top-1 agreement with the plain path), kernel times vs bound.
4. decode   — full-width fp32 ``decode_step`` x16 against ``forward``.
5. serve    — ``serve("gemma3_1b", smoke=False, batch=4, steps=32)``.
6. profile  — torch.profiler over one bf16 prefill forward and 4 decode
              steps: device time by kernel and the device's idle share.

Then the card's name and power limit as nvidia-smi gives them, one JSON line
with every kernel's numbers, and last ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result; so
does a machine without a CUDA card, or a directory without the port.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor rate, fp32 CUDA-core rate, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

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
GEMMA_SHAPES = {
    "local": (PREFILL_B, PREFILL_S, PREFILL_S, 4, 1, 256, True, 512, None, 0, "bfloat16"),
    "global": (PREFILL_B, PREFILL_S, PREFILL_S, 4, 1, 256, True, None, None, 0, "bfloat16"),
}
LAYERS_PER_FORWARD = {"local": 22, "global": 4}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# fp32 full-width forward, kernel vs plain attention: max |diff| <= LOGIT_RTOL * max |plain|
LOGIT_RTOL = 1e-5
TOP1_MIN = 0.99


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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

    dev = resolve_device()
    smi = phase_device(torch)
    fa_row = phase_kernels(torch, dev)
    fa_row.update(phase_prefill(torch, dev))
    phase_decode(torch, dev)
    phase_serve(torch)
    phase_profile(torch, dev)

    print(smi, flush=True)
    print(json.dumps({"kernels": [fa_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# ------------------------------- phases -------------------------------------


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
        flash_attention_smem_bytes={d: smem_bytes(d) for d in HEAD_DIMS},
    )
    return smi


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
    cases += [(f"gemma3_1b_{k}", c) for k, c in GEMMA_SHAPES.items()]
    for seed, (name, case) in enumerate(cases):
        q, k, v = _qkv(torch, dev, case, seed)
        out = flash_attention(q, k, v, **_kw(case))
        ref = attention_ref(q, k, v, **_kw(case))
        torch.cuda.synchronize()
        tol = TOL[case[-1]]
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        rows.append({"case": name, "shape": case[:6], "dtype": case[-1], "max_abs_err": err,
                     "tol": tol, "ok": bool(ok)})
        if name.startswith("gemma"):
            gemma_err = max(gemma_err, err)
    emit("kernels", cases=rows)
    check(all(r["ok"] for r in rows), "flash_attention disagrees with attention_ref")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:157",
        "max_abs_err": gemma_err,
    }


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
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        lk, _ = forward(cfg, params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = fa.LAUNCHES
        lr, _ = forward(cfg, params, batch, impl="ref")
        finite = bool(torch.isfinite(lk).all())
        top1 = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
        err16 = (lk - lr).abs().max().item()
        del lk, lr, params
        torch.cuda.empty_cache()
    check(launches == cfg.n_layers, f"bf16 forward launched the kernel {launches} times, not 26")
    check(finite, "bf16 logits are not finite")
    check(top1 >= TOP1_MIN, f"bf16 top-1 agreement kernel vs plain {top1} < {TOP1_MIN}")

    # the kernel at the two prefill shapes: kernel, plain and library times vs bound
    shapes = {}
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "flops": 0, "bytes": 0}
    for name, case in GEMMA_SHAPES.items():
        q, k, v = _qkv(torch, dev, case, seed=100)
        kw = _kw(case)
        ms = _cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = _cuda_ms(torch, lambda: attention_ref(q, k, v, **kw))
        lib = _sdpa(torch, q, k, v, case)
        lib_err = (lib().transpose(1, 2).float() - attention_ref(q, k, v, **kw).float()).abs().max().item()
        library_ms = _cuda_ms(torch, lib)
        bound_ms, bound_by, flops, nbytes = _bound_ms(case)
        shapes[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
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
        prefill_s=prefill_s, prefill_tok_per_s=PREFILL_B * PREFILL_S / prefill_s,
        kernel_ms_per_forward=agg["ms"], kernel_shapes=shapes,
    )
    n_calls = sum(LAYERS_PER_FORWARD.values())
    t_ops = agg["flops"] / PEAK_FLOPS["bfloat16"]
    t_bytes = agg["bytes"] / PEAK_BYTES
    # per launch, averaged over the 26 launches of one forward at their shapes
    return {
        "launches": launches,
        "ms": agg["ms"] / n_calls,
        "plain_ms": agg["plain_ms"] / n_calls,
        "bound_ms": agg["bound_ms"] / n_calls,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": agg["library_ms"] / n_calls,
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
        for i in range(S):
            lg, cache = decode_step(cfg, params, cache, tokens[:, i : i + 1], i)
            steps.append(lg[:, 0])
        dec = torch.stack(steps, dim=1)
        err = (dec - full).abs().max().item()
        err_last = (dec[:, -1] - full[:, -1]).abs().max().item()
        # the bar of tests/test_models.py::test_decode_matches_forward
        ok = bool(torch.allclose(dec, full, atol=2e-2, rtol=2e-2))
        del params, cache, full, dec
        torch.cuda.empty_cache()
    emit("decode", steps=S, max_abs_err=err, last_step_max_abs_err=err_last, tol="atol=rtol=2e-2")
    check(ok, f"decode_step logits disagree with forward: max abs err {err}")


def _profile(torch, fn, top=8) -> dict:
    """Device time by kernel over one call of ``fn``, and the device's idle share
    of the call's wall time (torch.profiler; null where it saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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

    batch, steps = 4, 32
    tps = serve("gemma3_1b", smoke=False, batch=batch, steps=steps, max_len=128, verbose=False)
    emit("serve", batch=batch, steps=steps, tok_per_s=tps, ms_per_step=batch / tps * 1e3)
    check(tps > 0, "serve returned no rate")


if __name__ == "__main__":
    sys.exit(main())
