#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's CTR inference path on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises; the script then exits non-zero):

1. Device and settings: the card's name and power limit (nvidia-smi),
   TF32 off for matmuls and cuDNN.
2. Build: every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
   sm_90a, one compiler per source, all at once.
3. Kernels: K1 ``mtl_gather`` (d = 32 and d = 1), K9 ``fused_cross_v2``,
   K10 ``fused_cross_v1`` and K11 ``fused_fm_second_order`` at the main
   path's shapes (b = 256 and 1024) against their plain PyTorch versions
   on the card — bitwise for K1, K9, K10, within ``FM_TOL`` for K11 —
   and timed with CUDA events beside the plain version, the one PyTorch
   call that computes the same function where there is one
   (``library_ms``), and the least time the card could take
   (``bound_ms``).
4. Main path: full-width DCNv2 on the uncapped Criteo schema (k = 39,
   d = 32, 6,648,548 table rows, D = 1248, three 1248×1248 cross layers,
   MLP 1248→1024→1024→1024) with random weights from a seed, served
   through ``compile_plan(level="dual")`` on two CUDA streams at batch
   256 and 1024: a few dozen ``plan.predict`` requests, partial batches
   among them, with the launch counters reset just before and read just
   after. Scores must be finite and in (0, 1); the four levels must agree
   on the card, and the card must agree with the CPU path on the same
   weights.
5. DCN, DeepFM and Wide&Deep at the same width, the same way.
6. One JSON line of every ported kernel, then the card's name and power
   limit, then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
FP32_FLOPS_PER_S = 67e12        # fp32 outside the tensor cores, same sheet
FM_TOL = dict(rtol=1e-5, atol=1e-5)
LADDER_TOL = dict(rtol=1e-5, atol=1e-6)
# GEMMs with K up to 2272 summed in another order by cuBLAS and the CPU BLAS
CPU_TOL = dict(rtol=1e-4, atol=1e-5)
SEED = 0
LATENCY_WARMUP, LATENCY_SAMPLES = 3, 60   # p80 has 12 samples beyond it


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, arg_sets, iters: int = 100) -> float:
    """Device time of one ``fn`` call, from CUDA events around ``iters``
    calls that cycle through ``arg_sets`` (enough sets that their bytes
    exceed the 50 MB L2, so each call finds its inputs in device memory).
    A sleep kernel queued first keeps the device busy while the host
    enqueues, so host launch cost does not pad the measurement."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(bytes_per_set: int) -> int:
    return max(2, min(32, math.ceil(120e6 / max(bytes_per_set, 1))))


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(torch, dev, table32, table1, offsets, schema, sample_ids):
    from repro_torch.kernels.fused_cross import (
        fused_cross_v1, fused_cross_v1_plain, fused_cross_v2,
        fused_cross_v2_plain)
    from repro_torch.kernels.fused_fm import (
        fused_fm_second_order, fused_fm_second_order_plain)
    from repro_torch.kernels.multi_table_lookup import (
        mtl_gather, mtl_gather_plain)

    k = schema.k
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []   # one dict per (kernel, shape)

    def record(name, shape, err, ms, plain_ms, lib_ms, bytes_moved, flops):
        b_ms, b_by = bound(bytes_moved, flops)
        rows.append(dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        lib = "n/a" if lib_ms is None else f"{lib_ms:.5f}"
        log(f"[kernels] {name} {shape}: max|kernel-plain|={err:.3e} "
            f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib} "
            f"bound_ms={b_ms:.5f} ({b_by})")

    for b in (256, 1024):
        # K1 at d = 32 (main table) and d = 1 (wide / FM tables)
        for table in (table32, table1):
            d = table.shape[1]
            sets = []
            for s in range(n_sets(2 * b * k * d * 4)):
                ids = torch.from_numpy(sample_ids(schema, b, step=s)).to(dev)
                flat = (ids.long() + offsets.long()[None, :]).reshape(-1)
                sets.append((ids, flat))
            ids0 = sets[0][0]
            out = mtl_gather(ids0, offsets, table)
            want = mtl_gather_plain(ids0, offsets, table)
            assert torch.equal(out, want), f"mtl_gather d={d} b={b}"
            bad = ids0.clone()
            bad[0, :3] = torch.tensor([-7, 2**31 - 1, 10**8], device=dev)
            assert torch.equal(mtl_gather(bad, offsets, table),
                               mtl_gather_plain(bad, offsets, table)), \
                "out-of-range ids"
            err = (out - want).abs().max().item()
            ms = device_ms(torch, lambda i, f: mtl_gather(i, offsets, table),
                           sets)
            plain_ms = device_ms(
                torch, lambda i, f: mtl_gather_plain(i, offsets, table), sets)
            lib_ms = device_ms(
                torch, lambda i, f: torch.index_select(table, 0, f), sets)
            uniq = torch.unique(sets[0][1]).numel()
            moved = b * k * 4 + k * 4 + uniq * d * 4 + b * k * d * 4
            record("mtl_gather", f"b={b},k={k},d={d}", err, ms, plain_ms,
                   lib_ms, moved, 0)

        dim = k * 32
        # K9 fused_cross_v2
        sets = [tuple(torch.randn((b, dim), device=dev, generator=g)
                      for _ in range(3))
                for _ in range(n_sets(4 * b * dim * 4))]
        out = fused_cross_v2(*sets[0])
        want = fused_cross_v2_plain(*sets[0])
        assert torch.equal(out, want), f"fused_cross_v2 b={b}"
        record("fused_cross_v2", f"b={b},D={dim}",
               (out - want).abs().max().item(),
               device_ms(torch, fused_cross_v2, sets),
               device_ms(torch, fused_cross_v2_plain, sets),
               device_ms(torch, lambda x0, xw, x: torch.addcmul(x, x0, xw),
                         sets),
               4 * b * dim * 4, 2 * b * dim)

        # K10 fused_cross_v1
        sets = [(torch.randn((b, dim), device=dev, generator=g),
                 torch.randn((b, 1), device=dev, generator=g),
                 torch.randn((dim,), device=dev, generator=g),
                 torch.randn((b, dim), device=dev, generator=g))
                for _ in range(n_sets(3 * b * dim * 4))]
        out = fused_cross_v1(*sets[0])
        want = fused_cross_v1_plain(*sets[0])
        assert torch.equal(out, want), f"fused_cross_v1 b={b}"
        record("fused_cross_v1", f"b={b},D={dim}",
               (out - want).abs().max().item(),
               device_ms(torch, fused_cross_v1, sets),
               device_ms(torch, fused_cross_v1_plain, sets), None,
               3 * b * dim * 4 + b * 4 + dim * 4, 3 * b * dim)

        # K11 fused_fm_second_order on embedding-scale values
        sets = [(torch.randn((b, k, 32), device=dev, generator=g) * 0.05,)
                for _ in range(n_sets(b * k * 32 * 4))]
        out = fused_fm_second_order(*sets[0])
        want = fused_fm_second_order_plain(*sets[0])
        torch.testing.assert_close(out, want, **FM_TOL)
        record("fused_fm_second_order", f"b={b},k={k},d=32",
               (out - want).abs().max().item(),
               device_ms(torch, fused_fm_second_order, sets),
               device_ms(torch, fused_fm_second_order_plain, sets), None,
               b * k * 32 * 4 + b * 4, 4 * b * k * 32)
    return rows


def trace_step(torch, name, plan, ids, n_steps: int = 20) -> None:
    """Profile ``n_steps`` calls of ``plan`` and print, per step: device
    busy time (union of kernel and copy intervals), the share of the
    traced window with nothing running on the device, the time kernels
    on two or more streams overlapped, and the five kernels that took the
    most device time. The Chrome trace lands in ``build/traces/``."""
    from torch.profiler import ProfilerActivity, profile

    plan(ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            plan(ids)
        torch.cuda.synchronize()
    out = ROOT / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}_{plan.level}_b{plan.batch_size}.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        log(f"[{name}] trace: no device events recorded")
        return
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["args"].get("stream", -1))
                   for e in events)
    busy = overlap = 0.0
    cur_end = spans[0][0]
    edges = sorted([(s, 1, st) for s, _, st in spans]
                   + [(t, -1, st) for _, t, st in spans],
                   key=lambda e: e[:2])                 # ends before starts
    active: dict = {}
    last = edges[0][0]
    for t, step, st in edges:
        if len({k for k, v in active.items() if v > 0}) >= 2:
            overlap += t - last
        last = t
        active[st] = active.get(st, 0) + step
    for s, t, _ in spans:
        if t > cur_end:
            busy += t - max(s, cur_end)
            cur_end = t
    window = spans[-1][1] - spans[0][0]
    by_kernel: dict = {}
    for e in events:
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    streams = sorted({st for _, _, st in spans})
    log(f"[{name}] trace {plan.level} b={plan.batch_size}, {n_steps} steps: "
        f"device busy {busy / n_steps:.1f} us/step, idle share of window "
        f"{1 - busy / window:.3f}, streams {streams}, multi-stream overlap "
        f"{overlap / n_steps:.1f} us/step")
    for kname, dur in top:
        log(f"[{name}]   {dur / n_steps:8.1f} us/step  {kname[:90]}")


def serve(plan, schema, sample_ids, n_requests: int, step0: int):
    """Answer ``n_requests`` predict calls, every third one a partial
    batch; returns all scores."""
    scores = []
    for r in range(n_requests):
        b = plan.batch_size if r % 3 else max(1, plan.batch_size // 3 - r)
        s = plan.predict(sample_ids(schema, b, step=step0 + r))
        assert s.shape == (b,), s.shape
        scores.append(s)
    return scores


def run_model(torch, dev, name, spec, schema, sample_ids, *, batches,
              n_requests):
    """Build one full-width model, check its levels and its CPU twin,
    serve it through "dual", and return its launch counts and steps."""
    import numpy as np

    from repro_torch.core import LEVELS, compile_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import CTR_MODELS

    model = CTR_MODELS[name](spec, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()

    # the four levels agree on the card
    ids = torch.from_numpy(sample_ids(schema, 256, step=10_000)).to(dev)
    plans = {}
    for level in LEVELS:
        plans[level] = compile_plan(model, level, 256, device=dev)
        log(f"[{name}] compiled {level} b=256 in "
            f"{plans[level].compile_ms:.1f} ms")
    logits = {lvl: p(ids) for lvl, p in plans.items()}
    for lvl, out in logits.items():
        assert out.shape == (256, 1), out.shape
        assert torch.isfinite(out).all(), lvl
        torch.testing.assert_close(out, logits["naive"], **LADDER_TOL,
                                   msg=lambda m: f"{name} {lvl}: {m}")
    diffs = {lvl: (out - logits["naive"]).abs().max().item()
             for lvl, out in logits.items()}
    log(f"[{name}] level ladder on the card: max|level-naive| = {diffs}")

    # the card agrees with the CPU path on the same weights
    cpu_model = CTR_MODELS[name](spec, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_plan = compile_plan(cpu_model, "dual", 16, device="cpu")
    small = sample_ids(schema, 16, step=20_000)
    want = cpu_plan(torch.from_numpy(small))
    got = plans["dual"](torch.from_numpy(
        np.concatenate([small, sample_ids(schema, 240, step=20_001)]))
        .to(dev))[:16].cpu()
    torch.testing.assert_close(got, want, **CPU_TOL)
    log(f"[{name}] card vs CPU, dual, 16 rows: max|diff| = "
        f"{(got - want).abs().max().item():.3e}")
    del cpu_model, cpu_plan

    # request latency per level at each batch (full batches, closed loop,
    # one caller), then a profiler trace of the "dual" step
    for b in batches:
        for level in LEVELS:
            plan = plans[level] if b == 256 else compile_plan(
                model, level, b, device=dev)
            ids_b = sample_ids(schema, b, step=30_000)
            lat = []
            for r in range(LATENCY_WARMUP + LATENCY_SAMPLES):
                t0 = time.perf_counter()
                plan.predict(ids_b)
                lat.append((time.perf_counter() - t0) * 1e3)
            lat = np.asarray(lat[LATENCY_WARMUP:])
            log(f"[{name}] latency {level} b={b}: p50 "
                f"{np.percentile(lat, 50):.3f} ms, p80 "
                f"{np.percentile(lat, 80):.3f} ms ({lat.size} requests)")
            if level == "dual":
                trace_step(torch, name, plan, torch.from_numpy(ids_b).to(dev))

    # the main path: counters reset just before, read just after
    dual = {b: compile_plan(model, "dual", b, device=dev) for b in batches}
    torch.cuda.synchronize()
    reset_launch_counts()
    n_steps = 0
    all_scores = []
    for b in batches:
        scores = serve(dual[b], schema, sample_ids, n_requests, 40_000 + b)
        n_steps += n_requests
        all_scores += scores
    torch.cuda.synchronize()
    counts = launch_counts()
    s = np.concatenate(all_scores)
    assert np.all(np.isfinite(s)) and np.all((s > 0) & (s < 1)), \
        (s.min(), s.max())
    log(f"[{name}] main path: {n_steps} requests through dual "
        f"({', '.join(str(b) for b in batches)}), {s.size} scores in "
        f"[{s.min():.4f}, {s.max():.4f}], launches {counts}")
    del plans, dual, model
    torch.cuda.empty_cache()
    return counts, n_steps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    # 1. device and settings
    card = nvidia_smi()
    log(f"[device] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    dev = torch.device("cuda")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.library(name)
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"under {_build.build_dir().relative_to(ROOT)}")
    for name in libs:
        for line in (_build.build_dir() / f"{name}.log").read_text() \
                .splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    from repro_torch.configs import ctr_spec
    from repro_torch.data import CRITEO, sample_ids
    from repro_torch.embedding import FusedEmbeddingCollection

    # 3. kernels at the main path's shapes: the full-width d = 32 table
    # and the d = 1 wide/FM table of the same schema
    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb = FusedEmbeddingCollection(spec.embedding_spec(), device=dev)
    wide = FusedEmbeddingCollection(spec.wide_spec(), device=dev)
    emb.store.reset_parameters(gen)
    wide.store.reset_parameters(gen)
    rows = phase_kernels(torch, dev, emb.dense_view(), wide.dense_view(),
                         emb.offsets, CRITEO, sample_ids)
    del emb, wide
    torch.cuda.empty_cache()

    # 4. the main path, then 5. the other three models; each model's run
    # resets the launch counters just before it and reads them just after
    launches = {}
    for name, batches, n_requests, gathers, kernel, per_step in (
            ("dcnv2", (256, 1024), 16, 1, "fused_cross_v2", 3),
            ("dcn", (256,), 24, 1, "fused_cross_v1", 3),
            ("deepfm", (256,), 24, 2, "fused_fm_second_order", 1),
            ("widedeep", (256,), 24, 2, None, 0)):
        spec_m = ctr_spec(name, "criteo", embed_dim=32, hidden=1024)
        counts, steps = run_model(torch, dev, name, spec_m, CRITEO,
                                  sample_ids, batches=batches,
                                  n_requests=n_requests)
        # DeepFM and Wide&Deep gather twice per step: d = 32 and d = 1
        assert counts["mtl_gather"] == gathers * steps, counts
        if name == "dcnv2":
            launches["mtl_gather"] = counts["mtl_gather"]
        if kernel is not None:
            assert counts[kernel] == per_step * steps, counts
            launches[kernel] = counts[kernel]

    # 6. summary
    sources = {"mtl_gather": ("mtl_gather.cu",
                              "src/repro/kernels/multi_table_lookup.py:60",
                              "b=1024,k=39,d=32"),
               "fused_cross_v2": ("fused_cross.cu",
                                  "src/repro/kernels/fused_cross.py:26",
                                  "b=1024,D=1248"),
               "fused_cross_v1": ("fused_cross.cu",
                                  "src/repro/kernels/fused_cross.py:48",
                                  "b=1024,D=1248"),
               "fused_fm_second_order": ("fused_fm.cu",
                                         "src/repro/kernels/fused_fm.py:31",
                                         "b=1024,k=39,d=32")}
    kernels = []
    for name, (src, replaces, shape) in sources.items():
        row = next(r for r in rows if r["name"] == name
                   and r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["name"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape})
    for name, count in launches.items():
        assert count > 0, f"{name} never launched on its main path"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
