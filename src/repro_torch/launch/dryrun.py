"""Dry run: trace every (architecture × shape × mesh) cell at full size and
depth on ``meta`` tensors, allocating nothing, and account for it per
device: FLOPs, bytes accessed, collective traffic, argument and output
bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --multi-pod single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --mesh 1x1

The JAX package lowers and compiles each cell with XLA's partitioner on
512 forced host devices and reads XLA's cost and memory analyses.  The port
runs the cell's step itself (a train step with remat and AdamW, a prefill,
or one decode step against a cache of S) on ``meta`` tensors: each op
computes shapes only.  ``FlopCounterMode`` counts its FLOPs (the flash
operator by its kernel's formula, the backward's blocked recompute as the
port runs it); a dispatch mode sums the bytes of every op's operands and
outputs; the sharding rules and the layouts of its trees give the bytes
per device and the collectives (``launch/hlo_analysis``) over a logical
mesh (``launch/mesh``).  A partitioned program's temporaries need an SPMD
partitioner, which the port does not have: ``memory.temp_bytes`` is null,
with the reason.  Serving cells run bf16 parameters, as the reference's do.

Reports land in ``build/dryrun/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pytree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh, parse_mesh
from repro_torch.models import layers as L, transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.train_step import TrainConfig, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")
META = torch.device("meta")
TEMP_BYTES_REASON = ("a partitioned program's temporaries need an SPMD partitioner, which the port does not have; "
                     "it places nothing across devices")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell, shaped and
    typed as the reference's ``ShapeDtypeStruct``s."""
    B, S = shape.global_batch, shape.seq_len
    front = (B, cfg.n_frontend_tokens, cfg.d_model)
    if shape.kind == "decode":  # one new token against a cache of S
        return {"tokens": _meta((B, 1), torch.int32)}
    toks = S - (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    batch = {"tokens": _meta((B, toks), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S if cfg.family == "vlm" else toks), torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = _meta(front, torch.bfloat16)
    elif cfg.family == "vlm":
        batch["patches"] = _meta(front, torch.bfloat16)
    return batch


def moments_shapes(params: Any) -> Any:
    """AdamW's fp32 moments ``{"m", "v"}`` a leaf, on ``meta``."""
    return tree_map(lambda p: {"m": _meta(p.shape, torch.float32), "v": _meta(p.shape, torch.float32)}, params)


def moments_specs(pspecs: Any) -> Any:
    if isinstance(pspecs, dict):
        return {k: moments_specs(v) for k, v in pspecs.items()}
    return {"m": pspecs, "v": pspecs}


class BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every tensor operand and output of each op run
    under it: what each op reads and writes once, as the port runs it
    eagerly (no fusion)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in _pytree_flatten((args, kwargs, out))[0]:
            if isinstance(x, torch.Tensor):
                self.total += x.numel() * x.element_size()
        return out


def _storages(tree) -> set[int]:
    return {x.untyped_storage()._cdata for x in tree_leaves(tree) if isinstance(x, torch.Tensor)}


def _aliased(outputs, inputs) -> list[torch.Tensor]:
    """Output tensors that share storage with an input (written in place)."""
    ins = _storages(inputs)
    return [x for x in tree_leaves(outputs) if isinstance(x, torch.Tensor) and x.untyped_storage()._cdata in ins]


def _run(cfg: ModelConfig, shape: ShapeConfig):
    """The cell's step on ``meta`` → (args, arg specs, outputs, output specs)."""
    params = T.init_params(cfg, torch.Generator(), META)
    pspecs = T.param_specs(cfg)
    batch = input_specs(cfg, shape)
    bspecs = {k: v for k, v in T.batch_specs(cfg, shape.kind == "train").items() if k in batch}
    if shape.kind == "train":
        tcfg = TrainConfig(adamw=AdamWConfig())
        opt = AdamWState(step=0, moments=moments_shapes(params))
        new_p, new_opt, metrics = make_train_step(cfg, tcfg)(params, opt, batch)
        mspecs = moments_specs(pspecs)
        return ((params, opt.moments, batch), (pspecs, mspecs, bspecs),
                (new_p, new_opt.moments, metrics["loss"]), (pspecs, mspecs, ()))
    if shape.kind == "prefill":
        logits, state = T.prefill(params, cfg, batch, cache_len=shape.seq_len)
        return ((params, batch), (pspecs, bspecs),
                (logits, state), (("batch", None, "vocab"), T.cache_specs(cfg)))
    state = T.init_decode_state(cfg, shape.global_batch, shape.seq_len, dtype=L.dt(cfg), device=META,
                                enc_len=cfg.n_frontend_tokens)
    state["pos"] = shape.seq_len - 1  # the last position of the cache: a full cache
    cspecs = T.cache_specs(cfg)
    logits, new_state = T.decode_step(params, cfg, batch["tokens"], state)
    return ((params, batch["tokens"], state), (pspecs, bspecs["tokens"], cspecs),
            (logits, new_state), (("batch", None, "vocab"), cspecs))


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Run ``cfg``'s step of ``shape`` on ``meta`` tensors as it stands (the
    caller sets the depth and the parameter dtype) and account for it over
    ``mesh`` → the report's measured part."""
    rules = sh.rules_for(cfg, mesh, kind=shape.kind, global_batch=shape.global_batch, seq_len=shape.seq_len)
    t0 = time.perf_counter()
    flops, moved = FlopCounterMode(display=False), BytesAccessed()
    with flops, moved:
        args, arg_specs, outs, out_specs = _run(cfg, shape)
    trace_s = time.perf_counter() - t0

    def per_device(pairs):
        return sum(H.tree_bytes(x, s, mesh, rules) for x, s in pairs)

    total = flops.get_total_flops()
    return {
        "n_params": sum(x.numel() for x in tree_leaves(args[0])),
        "rules": {k: (list(v) if isinstance(v, tuple) else v) for k, v in rules.items()},
        "flops": total / mesh.size, "flops_global": total,
        "bytes_accessed": moved.total / mesh.size, "bytes_accessed_global": moved.total,
        "collective_bytes": H.collective_bytes(cfg, shape, mesh, rules),
        "memory": {"argument_bytes": per_device(zip(args, arg_specs)),
                   "output_bytes": per_device(zip(outs, out_specs)),
                   "temp_bytes": None, "temp_bytes_reason": TEMP_BYTES_REASON,
                   "alias_bytes": per_device(_alias_specs(outs, out_specs, _aliased(outs, args)))},
        "trace_s": trace_s,
    }


def _alias_specs(tree, specs, alias):
    """(leaf, its spec) of the output leaves in ``alias``."""
    ids = {id(x) for x in alias}
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)] if id(tree) in ids else []
    if isinstance(tree, dict):
        return [p for k in tree for p in _alias_specs(tree[k], specs[k], alias)]
    if isinstance(tree, (list, tuple)):
        return [p for t, s in zip(tree, specs) for p in _alias_specs(t, s, alias)]
    return []


def serving_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Serving cells run on bf16 parameters (fp32 masters are a training concern)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16") if shape.kind in ("decode", "prefill") else cfg


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, mesh=None) -> dict:
    """One cell of the sweep at the architecture's published size and depth
    over the production mesh (``multi_pod``) or ``mesh``."""
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    head = {"arch": arch, "shape": shape_name, "mesh": mesh.name, "multi_pod": "pod" in mesh.axis_names}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    return {**head, "status": "ok", "kind": shape.kind, **trace_cell(serving_cfg(cfg, shape), shape, mesh)}


def cell_path(arch: str, shape_name: str, mesh_name: str) -> str:
    return os.path.join(REPORT_DIR, f"{arch}__{shape_name}__{mesh_name}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="both", choices=["both", "single", "multi"])
    ap.add_argument("--mesh", default=None, help="one logical mesh instead of the production ones, e.g. 1x1")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(REPORT_DIR, exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.mesh:
        meshes = [parse_mesh(args.mesh)]
    else:
        pods = {"both": [False, True], "single": [False], "multi": [True]}[args.multi_pod]
        meshes = [make_production_mesh(multi_pod=mp) for mp in pods]

    failures, t_all = [], time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            for mesh in meshes:
                path = cell_path(arch, shape_name, mesh.name)
                label = f"{arch} {shape_name} {mesh.name}"
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        print(f"[cached] {label}: {json.load(f)['status']}")
                    continue
                try:
                    r = lower_cell(arch, shape_name, mesh=mesh)
                except Exception as e:  # a failing cell is a bug: record it and go on
                    r = {"arch": arch, "shape": shape_name, "mesh": mesh.name, "status": "error",
                         "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
                    failures.append(label)
                with open(path, "w") as f:
                    json.dump(r, f, indent=1)
                if r["status"] == "ok":
                    print(f"[ok] {label}: {r['flops']:.3e} flops/device, "
                          f"{r['memory']['argument_bytes'] / 2**30:.2f} GiB arguments/device, "
                          f"trace {r['trace_s']:.1f}s")
                elif r["status"] == "skipped":
                    print(f"[skip] {label}: {r['reason']}")
                else:
                    print(f"[FAIL] {label}: {r['error']}")
    print(f"sweep {time.perf_counter() - t_all:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILING CELLS:")
        for f_ in failures:
            print(" -", f_)
        raise SystemExit(1)
    print("\nall requested cells green")


if __name__ == "__main__":
    main()
