"""Training launcher of the port::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --steps 30 --offload-optimizer [--npart 8] [--ckpt-dir DIR --ckpt-every 10] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --mesh 2x2 --host-devices 4 --steps 3          # four CPU processes, one mesh
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-1.7b \\
        --mesh 2x2 --distributed                        # four processes on the card(s)

The JAX package's ``repro.launch.train``: config → sharded init →
(offloaded) optimizer → prefetched data → checkpoints, resuming from the
latest checkpoint if one exists (kill it mid-run and relaunch it).  It runs
on the card unless ``--device`` names another device (``cpu``).

The resume is the reference's, exactly: a checkpoint holds the parameters
alone, the parameters after step ``i`` are saved as step ``i``, and a
relaunch from step ``i`` starts the data stream and the optimizer afresh
and runs step ``i`` again.

A mesh: ``--mesh DxM`` (or ``PxDxM`` with a ``pod`` axis) lays the
parameters out by the rules over a ``DeviceMesh`` of one device a process,
in a gloo group: ``--host-devices N`` launches the N processes on the CPU
(the rehearsal of the reference's forced host devices), ``--distributed``
joins torchrun's, and ``--coordinator/--num-processes/--process-id`` name
the group by hand; each process puts itself on the card (several may share
one).  Checkpoints stay whole (gathered, written leaf by leaf over the
processes), so any mesh, or one process, resumes them.  ``--multi-pod``
without ``--mesh`` is the reference's (2, 16, 16) mesh and needs 512
processes.  Unlike the reference, no ``--mesh`` trains on one device: the
reference's default (16, 16) mesh needs 256 processes, and the port
refuses a group of several without ``--mesh``.  Every family trains on a
mesh, each laid out by the reference's rules (``sharding.rules_for``).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

TAG = "[train]"
MODULE = "repro_torch.launch.train"


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (B 8 × 128 tokens)")
    ap.add_argument("--mesh", default=None, help="e.g. 2x2 → data×model, 2x2x2 → pod×data×model")
    ap.add_argument("--multi-pod", action="store_true", help="the (2, 16, 16) mesh: 512 processes")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="launch this many CPU processes, one a device, as the DTensor mesh needs (the campaign "
                         "and serve CLIs' --host-devices are CPU entries in one process instead)")
    ap.add_argument("--offload-optimizer", action="store_true", help="Adam moments in pinned host memory")
    ap.add_argument("--npart", type=int, default=8, help="moment blocks of the offloaded optimizer")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--distributed", action="store_true", help="join torchrun's process group (RANK, WORLD_SIZE, …)")
    ap.add_argument("--coordinator", default=None, help="process 0's address host:port (a hand-made group)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default=None, help="where to train (default: the card)")
    return ap


def _mesh_shape(args) -> tuple[tuple[int, ...], tuple[str, ...]] | None:
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, mesh_axes

    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        if len(shape) not in (2, 3):
            raise SystemExit(f"{TAG} --mesh {args.mesh}: two sizes (data×model) or three (pod×data×model)")
        return shape, mesh_axes(shape)
    if args.multi_pod:
        return PRODUCTION_SHAPES[True]
    return None


def _refuse(args, world: int) -> None:
    """Exit non-zero, naming the reason, where the flags and the group do
    not make a mesh the port trains on."""
    from repro_torch.configs import ARCHS

    mesh = _mesh_shape(args)
    if mesh is None:
        if world > 1:
            raise SystemExit(f"{TAG} {world} processes and no --mesh: the reference's default mesh is (16, 16) "
                             f"over 256 devices; name a mesh of {world} devices with --mesh")
        return
    n = math.prod(mesh[0])
    if n != world:
        how = "--multi-pod without --mesh is the (2, 16, 16) mesh, which" if args.mesh is None else \
            f"--mesh {args.mesh}"
        raise SystemExit(f"{TAG} {how} needs {n} processes, one a device; this launch has {world}")
    if n > 1:
        cfg = ARCHS[args.arch]
        cfg = cfg.reduced() if args.reduced else cfg
        _refuse_host_memory(cfg, int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _host_bytes() -> int:
    """This host's physical memory."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _refuse_host_memory(cfg, local: int) -> None:
    """Every process of a mesh draws the whole fp32 parameter tree on its
    host before it keeps its own shard (``convert.distribute_params``):
    exit, naming the sizes, where ``local`` processes' trees exceed this
    host's memory."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.utils.tree import tree_leaves

    tree = sum(x.numel() * x.element_size() for x in tree_leaves(T.init_params(cfg, torch.Generator(), "meta")))
    if local * tree > _host_bytes():
        raise SystemExit(f"{TAG} each process draws {cfg.name}'s whole parameter tree ({tree / 1e9:.1f} GB) on its "
                         f"host before it keeps its shard: {local} processes on this host need "
                         f"{local * tree / 1e9:.1f} GB of its {_host_bytes() / 1e9:.1f} GB (initialising each shard "
                         f"alone is ROADMAP queue 1 item 2)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _build_parser().parse_args(argv)
    from repro_torch.launch import bootstrap

    if args.host_devices > 1:
        if args.distributed or args.num_processes > 1 and not os.environ.get(bootstrap.HOST_DEVICES_ENV):
            raise SystemExit(f"{TAG} --host-devices launches its own processes; drop --distributed and the group "
                             f"flags")
        world = args.host_devices
    elif args.distributed:
        world = bootstrap.torchrun_args().num_processes
    else:
        world = args.num_processes
    _refuse(args, world)
    bootstrap.force_host_devices(argv=argv, module=MODULE)

    if args.distributed:
        dist_args = bootstrap.distributed_init(bootstrap.torchrun_args())
    else:
        dist_args = bootstrap.distributed_init(coordinator=args.coordinator, num_processes=args.num_processes,
                                               process_id=args.process_id)

    import contextlib

    import torch

    from repro_torch import convert
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core.offload import OffloadConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_auto_mesh, mesh_coordinates
    from repro_torch.models import transformer as T
    from repro_torch.parallel import collectives, sharding as sh
    from repro_torch.training import data as data_mod
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainConfig, init_train_state, make_train_step

    rank = dist_args.process_id
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
    mesh_shape = _mesh_shape(args)
    mesh = rules = None
    if mesh_shape is not None and math.prod(mesh_shape[0]) > 1:
        if dev.type == "cuda":
            collectives.stage_gloo_cuda()
        mesh = make_auto_mesh(*mesh_shape, device_type=dev.type)
        rules = sh.rules_for(cfg, mesh, kind="train", global_batch=global_batch, seq_len=seq)
        print(f"{TAG} process {rank}: backend {torch.distributed.get_backend()}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} at {mesh_coordinates(mesh)}, device {dev}", flush=True)
    say = print if rank == 0 else (lambda *a, **k: None)

    with sh.use_mesh(mesh, rules) if mesh is not None else contextlib.nullcontext():
        params = T.init_params(cfg, torch.Generator(device="cpu" if mesh is not None else dev).manual_seed(0),
                               "cpu" if mesh is not None else dev)
        pshard = None
        if mesh is not None:
            pshard = sh.tree_shardings(T.param_specs(cfg), mesh, rules)
            params = convert.distribute_params(params, T.param_specs(cfg), mesh, rules, device=dev)
        opt = init_train_state(cfg, tcfg, params)
        step = make_train_step(cfg, tcfg)

        mgr = CheckpointManager(args.ckpt_dir, process_index=rank, process_count=dist_args.num_processes,
                                whole_leaves=dist_args.num_processes > 1)
        start = 0
        restored = mgr.restore_latest({"params": params}, shardings={"params": pshard} if pshard else None)
        if restored is not None:
            start, state = restored
            params = state["params"]
            say(f"[resume] from checkpoint step {start}", flush=True)

        dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=global_batch,
                                   frontend=cfg.frontend, d_model=cfg.d_model,
                                   n_frontend_tokens=cfg.n_frontend_tokens)
        stream = data_mod.batches(dcfg)
        if mesh is not None:
            stream = (data_mod.local_rows(b, mesh, rules) for b in stream)
        it = data_mod.Prefetcher(stream, depth=2, device=dev)
        try:
            for i in range(start, args.steps):
                batch = next(it)
                if mesh is not None:
                    batch = data_mod.batch_to_mesh(batch, mesh, rules)
                params, opt, metrics = step(params, opt, batch)
                if i % 10 == 0:
                    say(f"step {i:5d}  nll {float(metrics['nll']):.4f}", flush=True)
                if args.ckpt_every and i and i % args.ckpt_every == 0:
                    mgr.save(i, {"params": params})
            mgr.save(args.steps, {"params": params}, blocking=True)
        finally:
            it.close()
    say("training complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
