"""Training launcher of the port::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --steps 30 --offload-optimizer [--npart 8] [--ckpt-dir DIR --ckpt-every 10] [--device cpu]

The JAX package's ``repro.launch.train`` on one device: config → init →
(offloaded) optimizer → prefetched data → checkpoints, resuming from the
latest checkpoint if one exists (kill it mid-run and relaunch it).  It runs
on the card unless ``--device`` names another device (``cpu``).

The resume is the reference's, exactly: a checkpoint holds the parameters
alone, the parameters after step ``i`` are saved as step ``i``, and a
relaunch from step ``i`` starts the data stream and the optimizer afresh
and runs step ``i`` again.

Several devices (``--mesh``, ``--multi-pod``, ``--distributed``,
``--host-devices`` above 1) are not ported: they exit non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.launch.campaign import MULTI_DEVICE_SLICE

TAG = "[train]"


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (B 8 × 128 tokens)")
    ap.add_argument("--mesh", default=None, help="not ported (one device)")
    ap.add_argument("--multi-pod", action="store_true", help="not ported (one device)")
    ap.add_argument("--host-devices", type=int, default=0, help="not ported above 1 (one device)")
    ap.add_argument("--offload-optimizer", action="store_true", help="Adam moments in pinned host memory")
    ap.add_argument("--npart", type=int, default=8, help="moment blocks of the offloaded optimizer")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--distributed", action="store_true", help="not ported (one device)")
    ap.add_argument("--device", default=None, help="where to train (default: the card)")
    return ap


def _refuse_unported(args) -> None:
    """Exit non-zero, before any device is touched, naming the first flag
    that asks for more than one device."""
    for flag, on in (("--mesh", args.mesh is not None), ("--multi-pod", args.multi_pod),
                     ("--distributed", args.distributed), ("--host-devices", args.host_devices > 1)):
        if on:
            raise SystemExit(f"{TAG} {flag} is not ported yet: {MULTI_DEVICE_SLICE}")


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    _refuse_unported(args)

    import torch

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core.offload import OffloadConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.training import data as data_mod
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainConfig, init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
        global_batch, seq = 8, 128
    else:
        shape = SHAPES[args.shape]
        global_batch, seq = shape.global_batch, shape.seq_len
    tcfg = TrainConfig(
        adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=50),
        offload=OffloadConfig(optimizer_state=args.offload_optimizer, optimizer_npart=args.npart),
    )
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_train_state(cfg, tcfg, params)
    step = make_train_step(cfg, tcfg)

    mgr = CheckpointManager(args.ckpt_dir)
    start = 0
    restored = mgr.restore_latest({"params": params})
    if restored is not None:
        start, state = restored
        params = state["params"]
        print(f"[resume] from checkpoint step {start}", flush=True)

    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=global_batch,
                               frontend=cfg.frontend, d_model=cfg.d_model,
                               n_frontend_tokens=cfg.n_frontend_tokens)
    it = data_mod.Prefetcher(data_mod.batches(dcfg), depth=2, device=dev)
    try:
        for i in range(start, args.steps):
            params, opt, metrics = step(params, opt, next(it))
            if i % 10 == 0:
                print(f"step {i:5d}  nll {float(metrics['nll']):.4f}", flush=True)
            if args.ckpt_every and i and i % args.ckpt_every == 0:
                mgr.save(i, {"params": params})
        mgr.save(args.steps, {"params": params}, blocking=True)
    finally:
        it.close()
    print("training complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
