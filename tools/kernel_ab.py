#!/usr/bin/env python3
"""Time the port's one-member FEM kernels of one source tree on one CUDA card.

    python3 tools/kernel_ab.py TREE

``TREE`` is the root of a checkout (``.`` for this one, or another commit
unpacked with ``git archive <commit> | tar -x -C build/other``); its
``src/repro_torch`` is imported and its kernels are built into its own
``build/``.  Comparing two trees: run them in one session on one card, in
turns (other, this, this, other), one process each.  Prints one JSON line:
the multispring kernel's ms at one streamed block (P 147,456) and at every
point (P 1,179,648) of the full-size mesh, 150 springs, fp64, from a state
that has taken three random strain steps; the EBE kernel's ms at the full
mesh in fp64 and fp32 on random positive-definite D; and each kernel
instance's registers and spill bytes.  Inputs come from fixed seeds.
"""
import json
import re
import sys

import torch


def main(tree: str) -> None:
    sys.path.insert(0, tree + "/src")
    from repro_torch.fem import meshgen, methods, multispring as ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.ebe_matvec import ops as ebe_ops
    from repro_torch.kernels.multispring import ops as ms_ops

    dev = torch.device("cuda")

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    out = {"tree": tree}
    mesh = meshgen.generate(64, 64, 12, pad_elems_to=8)
    ops = methods.FemOperators(mesh, methods.SeismicConfig(nspring=150), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for P in (147456, 1179648):
        st = ms.init_state(P, 150, torch.float64, device=dev)
        prm = ops.params.slice(slice(0, P))
        eps = torch.zeros((P, 6), dtype=torch.float64, device=dev)
        for _ in range(3):
            eps = eps + 3e-4 * torch.randn((P, 6), dtype=torch.float64, device=dev, generator=g)
            _, _, st, _ = ms_ops.multispring_cuda(eps, st, prm, ops.n_dirs, ops.w_dirs)
        out[f"multispring_ms_P{P}"] = cuda_ms(lambda: ms_ops.multispring_cuda(eps, st, prm, ops.n_dirs, ops.w_dirs), 10)
        del st
    for dt in (torch.float64, torch.float32):
        maps, E = ops.maps[dt], ops.n_elem
        x = torch.randn((ops.n_nodes, 3), dtype=dt, device=dev, generator=g)
        Q = torch.randn((E, 4, 6, 6), dtype=dt, device=dev, generator=g)
        D = (Q @ Q.transpose(-1, -2)).contiguous()
        coef = torch.rand((E,), dtype=dt, device=dev, generator=g) + 0.5
        out[f"ebe_ms_{dt}"] = cuda_ms(lambda: ebe_ops.ebe_matvec_cuda(x, maps.conn32, D, maps.Jinv, maps.wdet, coef), 50)
    for chunk in _build.ptxas_log().split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        m = re.search(r"(ms_update_kernel|ebe_kernel)I(d|f)(Lb[01]E)?E", name)
        if m:
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            out["".join(x or "" for x in m.groups())] = {"registers": regs and int(regs.group(1)),
                                                        "spill_bytes": spill and [int(x) for x in spill.groups()]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
