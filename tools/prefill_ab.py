#!/usr/bin/env python3
"""Time one source tree's language-model prefill on one CUDA card, warm.

    python3 tools/prefill_ab.py TREE [--trace] [--decode] [--models NAME,NAME]

``TREE`` is the root of a checkout (``.`` for this one, or another commit
unpacked with ``git archive <commit> | tar -x -C build/other``); its
``src/repro_torch`` is imported and its flash kernel is built into its own
``build/`` (only the wgmma source: prefill launches no other kernel).
Comparing two trees: run them one after the other on one card, in turns
(other, this, this, other), one process each.

deepseek-v2 and gemma2-2b (the default; ``--models`` also takes
mamba2-780m and zamba2-7b) run as ``chip_smoke.py``'s ``lm_families`` runs
them: the same depth cut, batch, prompt and cache length, bf16 compute over
fp32 parameters from seed 0, the prompt from seed 1.  Per model: the first
(cold) prefill's seconds, then 10 warm prefills, each on the host clock
around a synchronised call, and the bf16 flash launches of one prefill by
instance (DK, DV) where the tree counts them.  ``--trace``: one more warm
prefill under ``torch.profiler``, its device time by kernel (the 12
largest) and the device's busy share of the prefill's wall time.
``--decode``: 8 decode steps after the prefill (each from the prefill's
state: the same position rewritten), their host enqueue ms and
synchronised ms a step, and (with ``--trace``) one more step traced.
Prints one JSON line.
"""
import dataclasses
import importlib
import json
import os
import statistics
import sys
import time

import torch

# chip_smoke.py's FAMILIES_MAIN, the prefill's part
MODELS = {
    "deepseek-v2-236b": dict(cut={"n_layers": 2}, B=1, prompt=2048, cache_len=2080),
    "gemma2-2b": dict(cut={}, B=2, prompt=8192, cache_len=8224),
    "mamba2-780m": dict(cut={}, B=4, prompt=4096, cache_len=4128),
    "zamba2-7b": dict(cut={}, B=2, prompt=4096, cache_len=4128),
}
DEFAULT_MODELS = ("deepseek-v2-236b", "gemma2-2b")
DECODE_STEPS = 8
REPS = 10


def trace(fn):
    """Device ms by kernel of one call of ``fn`` and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an operator's row repeats the time of the kernels it launched
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    ops.sort(key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in ops)
    return {"wall_ms": wall * 1e3, "device_ms": busy_ms, "busy_share": busy_ms / (wall * 1e3),
            "top_ops": [{"op": k[:80], "device_ms": ms, "calls": n} for k, ms, n in ops[:12]]}


def main(tree, with_trace, with_decode=False, models=DEFAULT_MODELS):
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T

    fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")  # the binding module

    _build.SOURCES = ("flash_attention_wgmma.cu",)
    _build._ENTRY_POINTS = {"flash_attention_wgmma": _build._ENTRY_POINTS["flash_attention_wgmma"]}
    _build.library()
    dev = torch.device("cuda")
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    for name in models:
        spec = MODELS[name]
        cfg = dataclasses.replace(ARCHS[name], **spec["cut"])
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompt = torch.randint(0, cfg.vocab_size, (spec["B"], spec["prompt"]), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))

        def prefill():
            return T.prefill(params, cfg, {"tokens": prompt}, cache_len=spec["cache_len"])

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        cold = timed()
        by_instance = getattr(fa, "WGMMA_COUNTERS", {})
        for c in by_instance.values():
            c.reset()
        warm = [timed() for _ in range(REPS)]
        row = {"cold_s": cold, "warm_s": warm, "warm_median_s": statistics.median(warm), "warm_min_s": min(warm),
               "flash_launches_by_instance": {f"{dk}x{dv}": c.n // REPS for (dk, dv), c in by_instance.items()}}
        if with_trace:
            row["trace"] = trace(prefill)
        if with_decode:
            state = prefill()[1]
            tok = prompt[:, -1:]

            def step():
                T.decode_step(params, cfg, tok, dict(state))

            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DECODE_STEPS):
                step()
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row["decode"] = {"step_ms": wall / DECODE_STEPS * 1e3, "host_enqueue_ms": enqueue / DECODE_STEPS * 1e3,
                             **({"trace": trace(step)} if with_trace else {})}
            del state
        out[name] = row
        del params, prompt
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    names = args[args.index("--models") + 1].split(",") if "--models" in args else DEFAULT_MODELS
    if not set(names) <= set(MODELS):
        sys.exit(f"prefill_ab: --models takes {sorted(MODELS)}")
    tree = next(a for i, a in enumerate(args) if not a.startswith("--") and (i == 0 or args[i - 1] != "--models"))
    main(tree, "--trace" in args, "--decode" in args, names)
