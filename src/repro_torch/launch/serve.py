"""Serving driver: the CTR runtime/engine, on the card or on the CPU.

Counterpart of ``repro.launch.serve``, with its flags, defaults and
output lines, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --model dcnv2
    PYTHONPATH=src python -m repro_torch.launch.serve --policy bucketed
    PYTHONPATH=src python -m repro_torch.launch.serve --models deepfm,dcnv2 \\
        --async
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 64

    # online model updates: stream synthetic trainer deltas while serving
    PYTHONPATH=src python -m repro_torch.launch.serve --store cached \\
        --delta-every 100 --delta-rows 256

    # multi-device: batches over data, embedding tables over model
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --mesh data=4,model=2 --store cached

The CTR path is the compile→plan→engine→runtime flow: a ``ServingRuntime``
hosting one ``InferenceEngine`` (plan cache + batching policy picked by
``--policy``) per ``--models`` entry, each model's weights drawn from seed
0. With ``--async`` the engines are drained in the background (one shared
``DeviceScheduler`` pool, or a worker per engine with ``--sched
per-engine``); without it the driver drains synchronously. ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs the
plain versions of the kernels. ``--mesh data=N[,model=M]`` serves every
model over a device mesh (``repro_torch.distributed``): one card a
position, and an error naming the count where there are fewer cards;
with ``--device cpu`` every position is on the CPU. ``--mode lm`` (the
LM zoo, ROADMAP Queue A item 6) is not ported and exits with an error.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ctr_spec
from repro_torch.device import resolve_device

__all__ = ["main", "serve_ctr"]


def _make_policy(args):
    from repro_torch.serving import BucketedBatch, FixedBatch, TimeoutBatch
    ladder = tuple(int(b) for b in args.buckets.split(","))
    if args.policy == "fixed":
        return FixedBatch(args.batch)
    if args.policy == "bucketed":
        return BucketedBatch(ladder)
    return TimeoutBatch(BucketedBatch(ladder), max_wait_ms=args.max_wait_ms)


def _make_mesh(spec: str | None, dev: torch.device):
    """``"data=4,model=2"`` -> a mesh (``None`` passes through): one card
    a position on CUDA (fewer cards than positions exit, naming the
    count), every position on the CPU with ``--device cpu``."""
    if not spec:
        return None
    from repro_torch.distributed import make_mesh
    axes, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise SystemExit(f"--mesh: expected axis=N, got {part!r}")
        axes.append(name.strip())
        sizes.append(int(size))
    if dev.type == "cpu":
        return make_mesh(sizes, axes, devices="cpu")
    need = int(np.prod(sizes))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if need > have:
        raise SystemExit(f"--mesh {spec} needs {need} devices, found {have} "
                         "CUDA device(s); --device cpu runs it on the CPU")
    return make_mesh(sizes, axes)


def _traffic(args, schema):
    from repro_torch.data import zipf_ids
    if args.zipf:
        return zipf_ids(np.random.default_rng(0), args.requests,
                        schema.field_sizes, exponent=args.zipf)
    rng = np.random.default_rng(0)
    return np.stack([np.array([rng.integers(0, s)
                               for s in schema.field_sizes], dtype=np.int32)
                     for _ in range(args.requests)])


def _engine_line(name, eng, scores, store, use_async):
    s = eng.stats
    emb = (f"  emb_hit={s.emb_cache_hit_rate:.1%} "
           f"cached_traffic={s.emb_cached_traffic_fraction:.1%} "
           f"refreshes={s.emb_cache_refreshes}" if store else "")
    if store == "host":
        emb += (f" prefetch_hit={s.emb_prefetch_hit_rate:.1%} "
                f"staged={s.emb_staged_rows} h2d={s.emb_h2d_bytes}B")
    if s.emb_quant_rows:
        emb += (f" gather={s.emb_gather_bytes}B "
                f"quant_saved={s.emb_quant_bytes_saved}B")
    if s.mlp_quant_matmuls:
        emb += (f" q8_matmuls={s.mlp_quant_matmuls} "
                f"w_saved={s.mlp_quant_weight_bytes_saved}B")
    mode = "async" if use_async else "sync"
    print(f"[serve:{mode}] {name}: {s.n_requests} requests in "
          f"{s.n_batches} batches  p50={s.p50_ms:.1f}ms "
          f"p99={s.p99_ms:.1f}ms  plans={len(eng.cached_plans)} "
          f"cache_h/m={s.cache_hits}/{s.cache_misses} "
          f"pad_waste={s.padding_waste:.1%} "
          f"mean_score={scores.mean():.4f}{emb}")


def serve_ctr(args) -> None:
    from repro_torch.data import CRITEO
    from repro_torch.embedding import CachedStore, HostBackedStore
    from repro_torch.models.ctr import CTR_MODELS
    from repro_torch.serving import ServingRuntime
    # the mesh first: without the cards it asks for, the error names them
    mesh = _make_mesh(args.mesh, torch.device(args.device))
    dev = resolve_device(args.device)
    names = [n.strip() for n in
             (args.models.split(",") if args.models else [args.model])]
    schema = CRITEO.scaled(100_000)
    if mesh is not None:
        print(f"[serve] mesh {dict(mesh.shape)} over "
              f"{mesh.devices.size} devices")
    rt = ServingRuntime(refresh_every=args.runtime_refresh_every,
                        mesh=mesh, scheduler=args.sched,
                        pool_size=args.pool_size,
                        delta_every=args.delta_every)
    row_dtype = None if args.emb_dtype == "fp32" else args.emb_dtype
    if args.store == "dense" and row_dtype is not None:
        raise SystemExit("--emb-dtype int8 needs a tiered store "
                         "(--store cached or host); DenseStore stays "
                         "full-precision")
    hosts = []
    try:
        for name in names:
            spec = ctr_spec(name, "criteo", 16, 256, max_field=100_000)
            model = CTR_MODELS[name](spec, device=dev).init(
                torch.Generator(device=dev).manual_seed(0))
            store = None
            if args.store == "cached":
                store = CachedStore(spec.embedding_spec(),
                                    args.cache_capacity, row_dtype,
                                    device=dev)
            elif args.store == "host":
                store = HostBackedStore(spec.embedding_spec(),
                                        args.cache_capacity,
                                        row_dtype=row_dtype, device=dev)
                hosts.append(store)
            rt.add_model(name, model, level=args.level,
                         policy=_make_policy(args), store=store,
                         refresh_every=args.refresh_every,
                         compute_dtype=args.mlp_dtype, device=dev)
        _serve(args, rt, names, schema)
    finally:
        for store in hosts:              # their prefetch workers
            store.pipeline.stop()


def _serve(args, rt, names, schema) -> None:
    from repro_torch.serving import SyntheticTrainer
    if args.delta_every:
        if args.store == "dense":
            raise SystemExit("--delta-every needs a refreshable store "
                             "(--store cached or host); DenseStore tensors "
                             "are compiled into plans as constants")
        # one synthetic trainer per model: enough batches that the stream
        # outlives the traffic, drained on the shared admission clock
        n_batches = max(1, args.requests // args.delta_every)
        for i, name in enumerate(names):
            trainer = SyntheticTrainer(rt.engine(name).store.spec,
                                       rows_per_batch=args.delta_rows,
                                       n_batches=n_batches, seed=i)
            rt.attach_delta_stream(name, trainer)
    rt.warmup()
    ids = _traffic(args, schema)

    if args.use_async:
        # futures-based intake: round-robin the stream over the hosted
        # models; --sched shared (default) drains every queue through one
        # DeviceScheduler pool, --sched per-engine gives each its worker
        rt.start()
        futs = {n: [] for n in names}
        for i, row in enumerate(ids):
            name = names[i % len(names)]
            futs[name].append(rt.submit(name, row))
        scores = {n: np.array([f.result(timeout=120.0) for f in fs])
                  for n, fs in futs.items()}
        rt.stop()
    else:
        scores = {}
        for j, name in enumerate(names):
            eng = rt.engine(name)
            # submit through the runtime so the shared admission cadence
            # (--runtime-refresh-every) sees the traffic
            rt.submit_many(name, list(ids[j::len(names)]))
            scores[name] = np.concatenate([eng.serve_pending(), eng.flush()])

    for name in names:
        _engine_line(name, rt.engine(name), scores[name],
                     args.store if args.store != "dense" else None,
                     args.use_async)
    if len(names) > 1:
        agg = rt.stats()
        print(f"[serve:runtime] {agg.n_models} models  "
              f"{agg.n_requests} requests in {agg.n_batches} batches  "
              f"p50={agg.p50_ms:.1f}ms p99={agg.p99_ms:.1f}ms  "
              f"refreshes={agg.emb_cache_refreshes}")
    if args.delta_every:
        # join any in-flight background pull (stop() is idempotent — the
        # async path already called it), then drain what the cadence
        # didn't reach so the summary is deterministic
        rt.stop()
        rt.pull_updates()
        agg = rt.stats()
        print(f"[serve:delta] pushes={agg.emb_delta_pushes} "
              f"rows={agg.emb_delta_rows} version=v{agg.emb_version} "
              f"behind={agg.rows_behind}rows/"
              f"{agg.seconds_behind * 1e3:.1f}ms")
    sched = rt.scheduler
    if args.use_async and sched is not None:
        shares = " ".join(f"{n}={s:.1%}" for n, s in sorted(
            sched.shares.items()))
        slack = rt.stats().sched_preempted_slack_ms
        print(f"[serve:sched] pool={sched.pool_size} "
              f"dispatches={sched.n_dispatches} "
              f"preempted_slack={slack:.1f}ms  device_time {shares}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["ctr", "lm"], default="ctr")
    ap.add_argument("--device", default="cuda",
                    help="where the plans run: 'cuda' (default; raises "
                         "without a card) or 'cpu'")
    ap.add_argument("--model", default="dcnv2")
    ap.add_argument("--models", default=None,
                    help="comma-separated model list for the multi-model "
                         "runtime (overrides --model), e.g. deepfm,dcnv2")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="futures-based intake drained by background "
                         "workers instead of caller-driven serve_pending")
    ap.add_argument("--sched", default="shared",
                    choices=["shared", "per-engine"],
                    help="async drain mode: 'shared' (default) runs one "
                         "DeviceScheduler pool over every hosted engine "
                         "(constant thread count, least-SLO-slack-first); "
                         "'per-engine' keeps one worker thread per engine")
    ap.add_argument("--pool-size", type=int, default=2,
                    help="worker threads in the shared scheduler pool")
    ap.add_argument("--arch", default="llama3-8b",
                    help="LM architecture for --mode lm (not ported)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--level", default="dual",
                    choices=["naive", "fused_emb", "fused_all", "dual"])
    ap.add_argument("--policy", default="bucketed",
                    choices=["fixed", "bucketed", "timeout"])
    ap.add_argument("--buckets", default="16,32,64,128,256",
                    help="comma-separated bucket ladder for bucketed/timeout")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--mesh", default=None,
                    help="device mesh for multi-device serving, e.g. "
                         "'data=8' or 'data=4,model=2' (batches shard "
                         "over data, embedding tables over model)")
    ap.add_argument("--store", default="dense",
                    choices=["dense", "cached", "host"],
                    help="embedding store tier (repro_torch.embedding); "
                         "'host' keeps the backing table out of device "
                         "memory")
    ap.add_argument("--cache-capacity", type=int, default=65536,
                    help="hot-row capacity C for --store cached/host")
    ap.add_argument("--emb-dtype", default="fp32",
                    choices=["fp32", "int8"],
                    help="wire dtype of cached/host store rows: int8 "
                         "stores rows quantized (absmax + per-row fp32 "
                         "scale), dequantized in the gather kernel; fp32 "
                         "(default) stays bit-exact")
    ap.add_argument("--mlp-dtype", default="fp32",
                    choices=["fp32", "int8"],
                    help="dense-branch compute dtype: int8 runs every MLP "
                         "matmul quantized (K12); fp32 (default) stays "
                         "bit-exact")
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="per-engine: rebuild the hot cache every N served "
                         "batches (plan cache survives — tensor swap)")
    ap.add_argument("--runtime-refresh-every", type=int, default=None,
                    help="runtime-wide: refresh all stores every N "
                         "submitted requests across models")
    ap.add_argument("--delta-every", type=int, default=None,
                    help="online model updates: pull a synthetic trainer's "
                         "delta stream every N submitted requests across "
                         "models (versioned publish — no recompiles); "
                         "needs --store cached or host")
    ap.add_argument("--delta-rows", type=int, default=256,
                    help="embedding rows per synthetic delta batch for "
                         "--delta-every")
    ap.add_argument("--zipf", type=float, default=None,
                    help="zipf exponent for request traffic (default: "
                         "uniform random ids)")
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise SystemExit("--mode lm is not ported yet: the LM zoo and "
                         "serving/generate.py are ROADMAP Queue A item 6")
    serve_ctr(args)


if __name__ == "__main__":
    main()
