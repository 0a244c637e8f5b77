"""Serving launcher of the port: batched inference behind the Engine protocol.

Three engines, one serving stack (microbatcher + signature-keyed result
cache + active-learning feedback)::

    # surrogate: serve a trained FEM surrogate on catalog scenarios
    PYTHONPATH=src python -m repro_torch.launch.serve --engine surrogate \\
        --ckpt ckpt/surrogate --scenario ricker-soft-basin \\
        --scenario chirp-stiff-shelf --repeat 2 --feedback-out fb.jsonl

    # trajectory: full response histories in one O(log T) forward pass
    # (checkpoint from surrogate.trajectory.save_trajectory)
    PYTHONPATH=src python -m repro_torch.launch.serve --engine trajectory \\
        --ckpt ckpt/trajectory --scenario ricker-soft-basin --repeat 2

    # decode: batched LM generation, resident or host-offloaded KV
    # (--arch: every family whose prompts are tokens alone: the dense stacks,
    # gemma2-2b, mixtral-8x22b, deepseek-v2-236b, mamba2-780m, zamba2-7b,
    # internvl2-1b (text-only); --offload-kv takes a uniform stack of GQA
    # layers: dense, mixtral or internvl2; whisper-small exits 2)
    PYTHONPATH=src python -m repro_torch.launch.serve --engine decode \\
        --arch qwen3-1.7b --reduced --batch 4 --new 16 \\
        [--offload-kv --npart 4] [--temperature 0.8]

It runs on the card unless ``--device`` names another device (``cpu``).
Surrogate requests are keyed by :meth:`Scenario.signature` — a repeated
scenario (``--repeat``) is answered from the result cache without touching
the device.  With ``--feedback-out``, requests whose ensemble disagreement
exceeds ``--feedback-threshold`` are appended as scenario records, and the
compile-grouped plan they form is printed.

Decode prefills each batch through the flash kernel (once per layer) and
decodes with the KV cache on the card or, with ``--offload-kv``, in pinned
host memory streamed a layer group at a time.  Its parameters are random,
from ``transformer.init_params`` with a seeded generator; the prompts are
seeded too.  ``--reduced`` (the default) serves the architecture's tiny
fp32 relative, ``--full`` its published widths and depth.

Reliability knobs: ``--deadline-ms`` fails stale requests instead of
batching them, ``--breaker-threshold`` / ``--breaker-cooldown-s`` arm the
consecutive-failure circuit breaker, and ``--inject
fail_infer_every_n=N,limit=K`` deterministically rehearses the whole
degradation path (split-retry isolation, breaker trip and heal).

``--shard`` wraps the engine in ``ShardedEngine`` over the case mesh: every
card (``torch.cuda.device_count()``), or with ``--host-devices N`` N CPU
entries (the reference's forced host devices), all in this one process:
one replica of the engine a device, each entry's slice of a batch in a
host thread of its own.  (The train CLI's ``--host-devices`` launches one
process a device instead, as its DTensor mesh needs.)
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

TAG = "[serve]"


def _build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--engine", default="surrogate", choices=["surrogate", "trajectory", "decode"])
    ap.add_argument("--device", default=None, help="where the engine runs (default: the card)")
    # serving stack
    ap.add_argument("--max-batch", type=int, default=8, help="flush a microbatch once this many rows are pending")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="latency floor: flush when the oldest request has waited this long")
    ap.add_argument("--cache-size", type=int, default=256, help="result-cache capacity (entries); 0 disables")
    ap.add_argument("--feedback-out", default=None, help="append high-uncertainty scenarios to this JSONL")
    ap.add_argument("--feedback-threshold", type=float, default=0.05,
                    help="ensemble-disagreement score above which a request is routed to --feedback-out")
    ap.add_argument("--repeat", type=int, default=1,
                    help="submit the workload this many times (round ≥ 2 demonstrates cache hits)")
    # reliability knobs
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: a request older than this at flush time fails")
    ap.add_argument("--breaker-threshold", type=int, default=0,
                    help="consecutive engine failures that open the circuit breaker (0 disables)")
    ap.add_argument("--breaker-cooldown-s", type=float, default=1.0,
                    help="seconds the open breaker rejects requests before its half-open probe")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="deterministic fault injection (repro_torch.core.faults): "
                         "'fail_infer_every_n=N[,limit=K]' makes every Nth infer raise (at most K times)")
    ap.add_argument("--shard", action="store_true",
                    help="shard the batch axis over the case mesh: every card, or --host-devices CPU entries")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="N CPU entries on the case mesh, one host thread each in this process (the train CLI's "
                         "--host-devices launches processes instead)")
    # surrogate workload
    ap.add_argument("--ckpt", default=None, help="surrogate checkpoint dir (surrogate.train.save_surrogate)")
    ap.add_argument("--scenario", action="append", default=[], help="catalog scenario to serve (repeatable)")
    ap.add_argument("--sweep", default=None, help="scenario sweep spec (JSON file or inline) to serve")
    # decode workload
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4, help="decode: number of single-prompt requests")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--offload-kv", action="store_true")
    ap.add_argument("--npart", type=int, default=2)
    ap.add_argument("--kv-schedule", default="serial", choices=["serial", "prefetch", "donate"])
    ap.add_argument("--kv-prefetch", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy; > 0 = seeded categorical sampling")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _stack(args, engine):
    """Engine → (batcher, cache, feedback) per the CLI serving flags."""
    from repro_torch.core import faults
    from repro_torch.serving import FeedbackLog, MicroBatcher, ResultCache, ShardedEngine

    if args.shard:
        from repro_torch.launch.mesh import make_case_mesh

        engine = ShardedEngine(engine, make_case_mesh(device=engine.device.type, host_devices=args.host_devices))
        print(f"{TAG} sharding batch axis over {engine.n_devices} device(s)")
    inject = faults.parse(args.inject)
    if inject is not None:
        engine = faults.wrap_engine(inject, engine)
        print(f"{TAG} [inject] {inject.describe()} — signature={engine.signature()}")
    engine.warmup()
    cache = ResultCache(args.cache_size) if args.cache_size > 0 else None
    feedback = (FeedbackLog(args.feedback_out, threshold=args.feedback_threshold)
                if args.feedback_out else None)
    batcher = MicroBatcher(
        engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        cache=cache, feedback=feedback,
        deadline_ms=args.deadline_ms,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
    )
    return batcher, cache, feedback


def _report(batcher, cache, feedback):
    st = batcher.stats()
    print(f"{TAG} requests={st['requests']} rows={st['rows']} "
          f"batches={st['batches']} (full={st['flush_full']} "
          f"timeout={st['flush_timeout']} drain={st['flush_drain']}) "
          f"cache_hits={st['cache_hits']}")
    print(f"{TAG} wait mean={st['wait_ms_mean']:.2f}ms "
          f"max={st['wait_ms_max']:.2f}ms  "
          f"infer mean={st['infer_ms_mean']:.1f}ms/batch")
    print(f"{TAG} health: engine_failures={st['engine_failures']} "
          f"split_retries={st['split_retries']} "
          f"poison_requests={st['poison_requests']} "
          f"nonfinite_outputs={st['nonfinite_outputs']} "
          f"deadline_expired={st['deadline_expired']} "
          f"breaker_trips={st['breaker_trips']} "
          f"breaker_rejected={st['breaker_rejected']} "
          f"breaker_state={st['breaker_state']}")
    if cache is not None:
        cs = cache.stats()
        print(f"{TAG} cache: {cs['size']}/{cs['capacity']} entries, "
              f"{cs['hits']} hit(s), {cs['misses']} miss(es), "
              f"{cs['evictions']} eviction(s)")
    if feedback is not None:
        fs = feedback.stats()
        print(f"{TAG} feedback: {fs['routed']}/{fs['observed']} request(s) "
              f"routed to {fs['path']} (threshold {fs['threshold']})")
    return st


def _serve_surrogate(args, device, result) -> int:
    """--engine surrogate / trajectory: both families serve catalog
    scenarios through the same workload loop — only the engine class (and
    hence the checkpoint format and output stride) differs."""
    from repro_torch import scenario as sc
    from repro_torch.serving import SurrogateEngine, TrajectoryEngine, feedback_plan

    if not args.ckpt:
        print(f"{TAG} --engine {args.engine} needs --ckpt", file=sys.stderr)
        return 2
    if args.sweep:
        scenarios = sc.expand(sc.sweep_from_json(args.sweep))
    else:
        scenarios = [sc.get(n) for n in args.scenario or ["ricker-soft-basin"]]
    nts = {s.nt for s in scenarios}
    if len(nts) > 1:
        print(f"{TAG} scenarios disagree on nt ({sorted(nts)}); serve them separately", file=sys.stderr)
        return 2

    cls = TrajectoryEngine if args.engine == "trajectory" else SurrogateEngine
    engine = cls.from_checkpoint(args.ckpt, buckets=(args.max_batch,), nt=nts.pop(), device=device)
    print(f"{TAG} {args.engine} step={engine.step} members={len(engine.members)} "
          f"scale={engine.scale:.3g} on {engine.device} signature={engine.signature()}")

    batcher, cache, feedback = _stack(args, engine)
    served = result.setdefault("served", [])
    with batcher:
        for rnd in range(args.repeat):
            futs = [(s, batcher.submit(s.signature(), s.waves().astype(np.float32), meta=s)) for s in scenarios]
            for s, f in futs:
                # a failed request degrades (prints) instead of killing the
                # serving loop — poison isolation / breaker rehearsal path
                try:
                    r = f.result()
                except Exception as e:  # noqa: BLE001
                    print(f"{TAG} round {rnd + 1} {s.name}: FAILED ({type(e).__name__}: {e})")
                    served.append((rnd, s.name, None))
                    continue
                src = "cache" if r.cached else f"compute {r.infer_ms:.1f}ms"
                print(f"{TAG} round {rnd + 1} {s.name}: y{tuple(r.y.shape)} score={r.score:.3f} [{src}]")
                served.append((rnd, s.name, r))
            if batcher.stats()["breaker_state"] == "open":
                print(f"{TAG} circuit breaker open — waiting {batcher.breaker_cooldown_s:.1f}s cooldown "
                      f"before next round")
                time.sleep(batcher.breaker_cooldown_s + 0.05)
        result["stats"] = _report(batcher, cache, feedback)

    if feedback is not None and feedback.stats()["routed"] > 0:
        plan = feedback_plan(args.feedback_out)
        result["feedback_plan"] = plan
        print(f"{TAG} feedback plan: {plan.n_scenarios} scenario(s) in {len(plan.groups)} compile group(s) "
              f"from {args.feedback_out}")
    return 0


def _serve_decode(args, device, result) -> int:
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.serving import DecodeEngine, ServeConfig
    from repro_torch.serving.decode import check_generate_scope

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    try:
        check_generate_scope(cfg)
    except ValueError as e:
        print(f"{TAG} --arch {args.arch}: {e}", file=sys.stderr)
        return 2
    if args.offload_kv:  # refused before the weights are made (DecodeEngine refuses too, after)
        try:
            T.check_offload_scope(cfg)
        except ValueError as e:
            raise SystemExit(f"{TAG} --offload-kv: {e}") from None
    scfg = ServeConfig(kv_offload=args.offload_kv, kv_npart=args.npart, temperature=args.temperature,
                       seed=args.seed)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    engine = DecodeEngine(cfg, params, n_new=args.new, prompt_len=args.prompt_len, serve=scfg,
                          buckets=(args.max_batch,), kv_schedule=args.kv_schedule, kv_prefetch=args.kv_prefetch,
                          device=device)
    del params
    kv = f"host-offloaded, {args.npart} blocks" if args.offload_kv else "resident"
    mode = "greedy" if args.temperature == 0 else f"T={args.temperature}"
    print(f"{TAG} decode arch={cfg.name} [KV {kv}] {mode} on {engine.device} signature={engine.signature()}")

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).numpy().astype(np.int32)
    batcher, cache, feedback = _stack(args, engine)
    t0 = time.perf_counter()
    with batcher:
        for _ in range(args.repeat):
            futs = [batcher.submit(f"prompt{i}", prompts[i:i + 1]) for i in range(args.batch)]
            outs = [f.result() for f in futs]
        dt = time.perf_counter() - t0
        toks = np.concatenate([r.y for r in outs], axis=0)
        print(f"{TAG} generated {args.new} × batch {args.batch} in {dt:.1f}s "
              f"({args.new * args.batch / dt:.1f} tok/s)")
        print(f"{TAG} sample:", toks[0][:16].tolist())
        result["stats"] = _report(batcher, cache, feedback)
    result["tokens"] = toks
    return 0


def main(argv=None, result: dict | None = None) -> int:
    """Serve what the flags describe; returns the exit code.  A caller that
    passes a ``result`` dict gets the batcher's ``stats`` (and, per engine,
    the served results, the feedback plan or the generated tokens)."""
    args = _build_parser().parse_args(argv)
    if args.host_devices:
        if args.device not in (None, "cpu"):
            raise SystemExit(f"{TAG} --host-devices {args.host_devices} serves on CPU entries; drop --device "
                             f"{args.device}")
        args.device = "cpu"
    from repro_torch.serving.engine import _engine_device

    device = _engine_device(args.device)
    result = {} if result is None else result
    if args.engine in ("surrogate", "trajectory"):
        return _serve_surrogate(args, device, result)
    return _serve_decode(args, device, result)


if __name__ == "__main__":
    sys.exit(main())
