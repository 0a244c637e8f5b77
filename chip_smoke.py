#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero with
no result without them, or without the rest of the repository beside it.
Phases, each followed by a JSON line with its seconds:

1.  device     the card's name and power limit, as ``nvidia-smi`` reports them;
2.  build      the CUDA kernels from ``src/repro_torch/csrc`` (registers and
               spills of every kernel instance, and whether ptxas serialised
               a bf16 flash instance's wgmma, and its blocks an SM
               (cudaOccupancyMaxActiveBlocksPerMultiprocessor); static SASS
               counts of the fp64 FEM kernels and of the bf16 flash
               instances' local-memory traffic);
3.  kernels    each kernel against its plain PyTorch version on the card:
               multispring in both dtypes, P ragged, flags exact, at the
               default and a non-default tangent floor; the EBE product
               (gather fused in) in both dtypes on a random x and a random
               int32 connectivity with repeated nodes, E ragged and E
               smaller than a tile, at three tile sizes;
               flash attention in fp32 (3×TF32 mma.sync kernel) and bf16
               (wgmma/TMA kernel) over GQA, ragged, Sq < Skv, window, softcap,
               non-causal, Sq × Skv, dh ∈ {128, 256, 192 with dv 128}, dh and
               dv not multiples of 8 (the padding step), Sq 1 against 4,096
               keys, llama3-405b's 128 heads over 8 (S 1,024), and the new
               families' shapes
               (``FLASH_FAMILY_CASES``: non-causal over 1,500 keys, a ragged
               tail of key tiles, with Sq 1,500, 100, 1 and Sq 200 > Skv
               150; GQA at a group of 7; dh 112 inside (128, 128); the
               (64, 64) instance's 128-key tiles over 900 and 1,000 keys,
               ragged, GQA, causal with a window and a softcap); the
               bf16 kernel's large-head instances at their edges (``FLASH_EDGE_CASES``: dh 160, dv 96 zero-filled inside
               the (192, 128) instance, softcapped scores far past the cap
               at D 256, MLA's heads with Sq < Skv) per value against the
               plain version; whisper-small's cross attention at B 8, each
               row bitwise the row launched at B 1; the k-set entries (k members in one launch):
               EBE for k ∈ {1, 2, 3} in both dtypes (E 997 puts members off
               the bulk copies' 16-byte alignment) and multispring for k 2,
               each against its plain version and bitwise against k
               one-member launches, flags bit-equal;
4.  cpu        the FEM port on the card against the port on the CPU;
5.  prefetch   ``schedule="prefetch"`` and ``"donate"`` ≡ ``"serial"`` bitwise
               on the card;
6.  crs_check  all four methods on a small mesh on the card, solved to 1e-10:
               Baseline 2 and Proposed 1 against Baseline 1 (1e-12·max|v|),
               Proposed 2 against it (1e-5·max|v|), each CRS rung against
               itself on the CPU (1e-6·max|v|), Proposed 1 prefetch ≡ serial
               bitwise;
7.  kset_check the k-set ensembles (``run_ensemble``, M 3) of all four
               methods on crs_check's mesh and config: card ≡ CPU port
               (1e-6·max|v|), each lane ≡ its own ``run`` on the card
               (1e-9·max|v|); Proposed 1's k-set with θ offloaded ≡ θ on the
               card bitwise; a guarded NaN in lane 1 (Proposed 2): health
               words equal the CPU port's, the siblings bitwise unchanged;
               the same for Proposed 1 with θ offloaded (``guard_step`` gives
               it a second pinned θ set): words and counts the CPU port's,
               velocity within 1e-6·max|v|, siblings bitwise the clean run,
               which is bitwise the unguarded one, lane 1's pinned θ in both
               sets its last healthy θ, the bytes of both sets;
8.  campaign_check  the campaign CLI (``launch.campaign.main``) at (8, 8, 4),
               3 waves in rounds of 2, 6 steps, a checkpoint every 2,
               guarded, for Proposed 2, Proposed 1 and Baseline 1: killed
               after step 7 and relaunched, and relaunched once more (a pure
               restore), bitwise the uncheckpointed run; Proposed 2 card ≡
               CPU port (1e-6·max|v|); a NaN injected into case 1 (Proposed 2) gives
               the CPU's health words, leaves the siblings bitwise unchanged
               and is quarantined out of the shards, which load back with
               their CRCs checked; another seed and the CPU's kernel backend
               are refused as a different campaign;
9.  surrogate_check  the surrogates on the card against the port on the CPU:
               the CNN+LSTM (n_c 2, n_lstm 2, kernel 9, latent 16, T 64) and
               the trajectory model (defaults, T 129, both scans) — ``apply``,
               ``predict`` at an odd B and T (1e-5·max|y|), ``mae_loss`` and
               its gradient per leaf (1e-4·max|g|); 20 steps of ``fit`` of
               each (history within 1e-4 relative); the campaign CLI writes
               real FEM shards (3x3x3, 4 waves of 16 steps, a shard a case)
               in a thread while ``fit_stream`` consumes them from a
               ``ShardStream.from_cache``, ≡ post-hoc ``fit_shards`` (val MAE
               and params within 1e-6); saved on the card, loaded on the CPU
               bitwise;
10. surrogate_main  the CNN+LSTM at the widest point of the paper's search
               space (latent 1,024, n_lstm 3, kernel 65, n_c 2) trained 4
               Adam steps through ``fit_shards`` on the paper's dataset shape
               (100 waves × 16,000 samples × 3 in shards of 16; the targets a
               seeded causal FIR response of the waves), and the trajectory
               surrogate 4 steps through ``fit_trajectory_shards`` on the
               same shards, then ``step`` over 512 samples against
               ``apply(scan="seq")`` (1e-5·max|y|): s per Adam step (first and
               warm), s per validation ``predict``, peak device bytes, the
               device's busy share over one warm CNN step;
11. main       Proposed 2 at full size through ``methods.run``: 294,912 TET10
               elements, 150 springs per point (θ = 7.08 GB in pinned host
               memory), ``npart=8``, prefetch, fp64, 8 steps;
12. crs_main   the CRS rungs at main's size and config through ``methods.run``:
               Baseline 1 (θ on the card) and Proposed 1 (θ streamed) 4
               steps each, Baseline 2 (θ and the multispring on the host) 1
               step; per step the parts of the step, per rung the peak
               device memory against θ's bytes;
13. lm_cpu     qwen3-1.7b at full width, 2 layers, fp32: prefill + 4 decode
               steps on the card against the CPU, and prefill→decode against
               ``forward`` on the card (the fp32 flash kernel's path);
14. lm_main    qwen3-1.7b at full width and depth (28 layers), bf16 compute:
               prefill of 4 × 4,096 tokens (28 launches of the wgmma flash
               kernel, none of the fp32 one), then 32 greedy decode steps
               (no flash launch);
15. lm_offload ``generate`` with the KV cache in pinned host memory (4 blocks
               of 7 layers, prefetch) gives the resident tokens, each
               ``generate`` prefilling in one pass (28 bf16 flash launches,
               none of the fp32 kernel); the same tokens stepped one at a
               time through both decode steps give bitwise equal logits and
               caches;
16. lm_families_cpu  gemma2-2b at published widths, one pair of layers
               (window 32 under a prompt of 64), reduced mixtral and
               deepseek-v2 (capacity factor 8.0), and at published widths
               mamba2-780m (2 layers), zamba2-7b (7: a group of 6 and a
               remainder of 1), whisper-small (2 + 2 layers, 1,500 frames)
               and internvl2-1b (2 layers, 256 patches), fp32: prefill + 4
               decode steps on the card against the CPU, and against
               ``forward`` on the card (5e-5·max|logits|), greedy tokens and
               the MoE's aux loss equal; one fp32 flash launch per attention
               layer (whisper: and per cross attention and encoder layer) in
               prefill and in ``forward``;
17. lm_families  bf16 compute: gemma2-2b whole (26 layers, B 2, prompt
               8,192, 32 new tokens: 26 launches of the bf16 flash kernel's
               (256, 256) instance in prefill, 13 windowed and 13 global, none in
               decode; local caches of 4,096, global of 8,224), mixtral-8x22b
               at published widths, 2 of 56 layers (B 2, prompt 6,144; its KV
               offloaded in 2 pinned blocks through ``generate`` and stepped,
               bitwise the resident decode), deepseek-v2-236b at published
               widths, 1 dense + 1 MoE layer of 60 (B 1, prompt 2,048; MLA's
               prefill at dh 192, dv 128, the (192, 128) instance;
               ``tokens_dropped_fraction`` of its
               prefill's router logits, and the tokens each expert is
               routed); mamba2-780m whole (48 layers, B 4 × 4,096: no flash
               launch), zamba2-7b whole (81 layers, B 2 × 4,096: 13 launches
               of (128, 128) at dh 112, its shared block), whisper-small
               whole (12 + 12 layers, B 8 × 1,500 frames, prompt 128: 36 of
               (64, 64), 12 encoder and 12 cross non-causal, 12 decoder
               causal), internvl2-1b whole (24 layers, B 4 × 256 patches +
               3,840 tokens: 24 of (64, 64)); 32 new tokens each: prefill s
               (first and warm), tokens/s, decode tokens/s,
               peak device bytes, parameters and launches per model;
18. lm_tail    granite-8b and llama3-405b, with the launch tail: granite at full
               width, 2 layers, fp32, B 1 × 256 + 4 decode steps, card against
               CPU and against ``forward`` (5e-5·max|logits|, greedy tokens
               equal); granite-8b whole (36 layers, B 4 × 4,096: 36 launches of
               the bf16 kernel's (128, 128) instance at Hq 32 / Hkv 8) and
               llama3-405b at published widths, 2 of 126 layers (B 1 × 8,192: 2
               launches at Hq 128 / Hkv 8, a GQA group of 16; its prefill→decode
               against ``forward`` in fp32 on the same parameters), bf16 over
               fp32 parameters, 3 warm prefills and ``serving/decode.generate``
               of 32 greedy tokens (no flash launch past its prefill); the dry
               run's FLOP count of each prefill's cell (``launch/dryrun.
               trace_cell``: the cut depth, the card's 1×1 mesh, fp32
               parameters) equal to ``FlopCounterMode``'s over a warm prefill on
               the card, the achieved TFLOP/s and its share of the 989 TFLOP/s
               dense bf16 peak; ``tree_bytes`` of the card's parameter and cache
               trees equal to the bytes it holds; then two processes on the card
               in a gloo group run ``compressed_mean_grads`` over two full-width
               qwen3-1.7b layers' gradient shapes for 5 steps (CUDA tensors,
               residual carried): each mean within the reference test's bound
               (0.05·max|mean| + 1e-3), bitwise the same processes' CPU run;
19. train_cpu  one train step on the card against the port on the CPU,
               fp32, remat: qwen3-1.7b at full width, 2 layers, B 1 × 256,
               and every other family at its reduced config with its
               frontend input (B 2 × 32): the loss within 1e-5 relative,
               each gradient leaf within 1e-4·max|g|, AdamW on the CPU's
               gradients within 1e-6·max on both; the fp32 flash kernel
               twice a layer (the forward and the backward's recompute);
               then qwen3's case in bf16, the (128, 128) kernel twice a
               layer: the loss within 1e-4 relative and each leaf within
               5e-2·max|g| of the CPU's, and the card's distance from the
               fp32 step at most twice the CPU's;
20. train_main qwen3-1.7b whole (28 layers), bf16 over fp32 parameters,
               B 2 × 4,096 from ``data.batches`` through the
               ``Prefetcher``: AdamW alone on one step's gradients, resident
               and offloaded (8 pinned blocks, ``serial`` and ``prefetch``),
               bitwise equal, with each warm apply's ms; then 3 train steps
               resident, again resident, offloaded serial and offloaded
               prefetch from the same params and batches — s per step,
               tokens/s, peak device bytes, pinned moment bytes, 56 launches
               of the bf16 (128, 128) instance a step, the device's busy
               share and top ops (``torch.profiler``, the last step); the
               offloaded runs bitwise the resident one where two resident
               runs are (else within their spread); then the checks of
               the train CLI, whose processes run from before train_cpu
               (reduced qwen3, 30 steps, a checkpoint every 10: the nll at
               step 20 below step 0's; killed after a checkpoint and
               relaunched, it resumes);
21. serve_check  the serving tier small, card against the port on the CPU:
               ``SurrogateEngine`` and ``TrajectoryEngine`` (two members each;
               y within 1e-5·max|y|, score within 1e-5, equal signatures),
               batched ≡ per-request bitwise, ``ShardedEngine`` ≡ its engine
               with its signature, a repeat from the cache with no ``infer``;
               ``DecodeEngine`` on reduced qwen3 (fp32: the fp32 flash kernel)
               with the CPU's tokens, a single prompt padded to its bucket ≡
               its batched row, and on reduced gemma2, mixtral and deepseek-v2
               with the CPU's tokens and signatures; ``launch.serve.main`` for
               all three engines (decode also as ``--arch gemma2-2b`` and
               ``--arch mamba2-780m``; ``--arch whisper-small`` exits 2),
               the surrogate one with a repeat, feedback at threshold 0 and an
               injected failure, its health counts and feedback records the
               CPU run's;
22. serve_main the servers at full width through ``MicroBatcher`` with a
               ``ResultCache``: (a) the CNN+LSTM ensemble (surrogate_main's
               trained member and a second from ``init_params``) through
               ``save_surrogate`` → ``SurrogateEngine.from_checkpoint`` on 16
               shard waves of 16,000 samples in batches of 8, then again from
               the cache, then 8 sweep scenarios of 16,000 samples that the
               ``FeedbackLog`` routes (threshold 0) and ``load_feedback``
               reads back; (b) the trajectory surrogate alike; (c)
               ``DecodeEngine`` over lm_main's qwen3-1.7b, 8 prompts of 4,096
               tokens in buckets of 4, 32 new tokens: 28 bf16 flash launches a
               batch (its prefill), a prompt alone ≡ its batched row,
               offloaded KV ≡ resident tokens; then the serve CLI at full
               width.  Per server: requests/s, infer ms a batch, wait ms, cache
               hits, peak device bytes, tokens/s;
23. plan_check the planning and scheduling layer at crs_check's mesh, 12
               springs, on the card against the port on the CPU: ``run_plan`` of
               a two-group sweep (soil axis, 2 cases a scenario, 6 steps,
               tuned by the model) within 1e-6·max|v| with equal manifests
               apart from the time fields; ``choose(probe=True)`` on the card
               (a shortlisted candidate, the k-set kernels launched) and the
               CLI's ``--autotune --probe``; kill-and-rejoin through the queue
               (``run_worker`` w0 preempted after step 3, w1 finishing)
               bitwise the serial run; the CLI's ``--schedule --workers 2
               --train-while-generating`` (both workers rc 0, the queue
               settled, the trainer's validation MAE); ``--scenarios`` over
               ``serve_check``'s feedback log, its shards read back with CRCs;
24. kset_main  Proposed 2 as 2SET at main's mesh and 150 springs: two cases,
               θ of both resident on the card (2 × 7.08 GB), 4 steps of
               ``run_ensemble``, against each case alone in the same resident
               form (s/step, iterations, parts, peak device memory); one
               k-set multispring launch per step and one k-set EBE launch per
               matvec; lanes ≡ the single runs within 1e-6·max|v|;
25. campaign_main  the campaign at full width through ``run_campaign(...,
               device=None)`` (kset_main's 2SET carry parked on the host):
               (a) Proposed 2, kset 2, M 3 (two rounds, the tail padded), 4
               steps, unguarded and guarded — per chunk s/step per case, peak
               device bytes, the k-set kernels' launches (each > 0); round 0
               against kset_main's 2SET on the same waves (1e-12·max|v|);
               (b) M 2, a checkpoint every 2 steps (14.9 GB: θ of two cases
               is 14.16 GB), stopped after step 2 and resumed, bitwise (a)'s
               guarded round 0, with each checkpoint's bytes and seconds to
               copy, write, CRC and restore, and the free disk before;
26. campaign_mp  the multi-process campaign through the CLI
               (``python -m repro_torch.launch.campaign``, one process each)
               at main's size: Proposed 2, 150 springs, k 1, 3 waves of 4
               steps, a checkpoint every 2; one process as the reference,
               then two processes on the card (``--num-processes 2``),
               stopped after step 2 and relaunched: each process's banked
               rounds bitwise the one-process rows (process 1's padded lane
               bitwise case 2), ``OUT/p00`` ∪ ``OUT/p01`` the one-process
               shards, the pair's checkpoint refused by one process ("world
               size"), each worker's FEM kernel launches; per process and
               chunk s/step per case and peak device bytes, checkpoint bytes
               and seconds, cases/s and the pair's summed rate against one
               process's;
27. timing     each kernel at the shapes its main path gives it, against its
               plain version, its bound and (flash) SDPA, with flash held in
               fp32 and bf16 there too and timed in both (fp32 against the
               3×TF32 bound and the fp32 cores' bound, also at gemma2-2b's
               and deepseek-v2's MLA heads); the bf16 kernel's (256, 256)
               instance at gemma2-2b's prefill shapes (local and global, B 2,
               S 8,192, softcap 50), its (192, 128) one at deepseek-v2's MLA
               (B 1, 128 heads, S 2,048, dh 192, dv 128) and its (128, 128)
               one at mixtral-8x22b's (B 2, Hq 48 over Hkv 8, S 6,144, window
               4,096), at zamba2's (B 2, 32 heads, S 4,096, dh 112), at
               granite-8b's (B 4, Hq 32 over Hkv 8, S 4,096) and at llama3-405b's
               (B 1, Hq 128 over Hkv 8, S 8,192), its
               (64, 64) one at internvl2's (B 4, Hq 14 over Hkv 2, S 4,096)
               and whisper's (B 8, 12 heads: the encoder's 1,500 × 1,500 and
               the cross attention's 128 × 1,500, non-causal; the decoder's
               128 causal), each with its instance, registers and spills,
               against SDPA for the rows without a softcap (a window as a
               mask) and, without the softcap, for gemma2 (a comparison
               only); a breakdown of one
               whole EBE matvec (kernel, slot-table scatter) in both dtypes,
               of one full-size FEM step (with the multispring kernel summed
               over the step's blocks beside the streamed pass and the θ
               copy alone), of one ``bcsr_matvec`` against its byte bound and
               one ``crs_update`` by part, of one prefill and of one decode
               step; last, the k-set kernels at kset_main's shapes against
               two one-member launches and their plain versions; and the
               surrogates' recurrences, outside Pallas: the LSTM loop against
               ``torch.nn.LSTM`` (cuDNN) at B 4, T 4,000, H 1,024, forward and
               forward + backward, and ``ssm_scan`` against its loop at T ∈
               {256, 1,024, 4,096, 16,000} (``{"outside_pallas": [...]}``);
28. plan_main  the planning and scheduling layer at main's size, 150 springs,
               with a calibration table written from ``timing``'s own kernel
               times (the multispring block and the fp64 EBE product as
               backend ``cuda``, their plain versions as ``torch``): (a) the
               CLI's ``--sweep`` over one soil and two wave families (one
               group of 4 cases, 4 steps) with ``--autotune --probe
               --calibration``, beside the model's choices at the default
               4 GB budget and at 70 GB; (b) ``--schedule --workers 2
               --lease-s 120 --method proposed2 --kset 1`` over two soils × 2
               cases, one group per worker process on the card: the queue
               settled, no dead group, no takeover.  The FEM rows of the
               kernel line gain ``launches_by_path`` (``plan_check``, (a),
               ``campaign_mp``'s workers summed; (b)'s launches are in its
               worker processes, not counted).

It prints one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
then exits non-zero before the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, non-tensor-core for fp32/fp64)
HBM_BYTES_PER_S = 3.35e12
HOST_AHEAD_CYCLES = 20_000_000  # ~10 ms of the card's clock (1.98 GHz): cuda_ms's head start for the host
PEAK_FLOPS = {"torch.float64": 34e12, "torch.float32": 67e12, "torch.bfloat16": 989e12,  # bf16: tensor cores
              "tf32x3": 495e12 / 3}  # fp32 work done as three TF32 products on the tensor cores (495 TFLOP/s)
MS_OPS_PER_SPRING = 124  # counted from csrc/multispring.cu (pow as one op)
EBE_OPS_PER_ELEM = 2448  # 4 points × (2·90 g + 2·90 H + 2·36 Dε + 2·90 Bᵀσ)
FEM_KERNELS = ("multispring", "ebe_matvec_f64", "ebe_matvec_f32")
CRS_STEPS = {"baseline1": 4, "proposed1": 4, "baseline2": 1}  # crs_main; Baseline 2's host pass is slow
# (B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, softcap, strided q/k/v)
FLASH_CASES = [
    (1, 2, 2, 64, 64, 32, 32, True, None, None, False),
    (2, 4, 2, 100, 100, 64, 64, True, None, None, False),   # GQA, ragged
    (1, 2, 1, 48, 160, 64, 64, True, None, None, False),    # Sq < Skv
    (1, 2, 2, 96, 96, 64, 64, True, 32, None, False),       # window
    (1, 2, 2, 80, 80, 64, 64, True, None, 30.0, False),     # softcap
    (1, 3, 1, 64, 64, 40, 40, False, None, None, False),    # non-causal, odd dh
] + [(1, 2, 1, min(sq, skv), skv, 32, 32, True, None, None, False)
     for sq in (1, 7, 33, 130) for skv in (64, 129, 200)] + [
    (2, 16, 8, 100, 150, 128, 128, True, None, None, True),  # qwen3's heads, strided as in the layer
    (1, 4, 2, 100, 150, 256, 256, True, 64, 50.0, False),
    (1, 4, 2, 100, 150, 192, 128, True, None, None, False),  # MLA's dh ≠ dv
    (1, 2, 1, 50, 90, 36, 20, True, None, None, True),     # dh, dv not multiples of 8: bf16 pads for TMA
    (1, 4, 2, 1, 4096, 128, 128, True, None, None, False),  # one query row against a long cache
    (1, 128, 8, 1024, 1024, 128, 128, True, None, None, True),  # llama3-405b's heads: a GQA group of 16
    (1, 32, 2, 64, 96, 128, 128, True, None, None, False),   # the same group of 16, small enough to run whole
]
# the shapes the SSM, hybrid, encoder-decoder and VLM families give the kernel: non-causal
# with a ragged tail over many key tiles (whisper's encoder, S 1,500), Sq < Skv (its cross
# attention), Sq > Skv and Sq 1; GQA at a group of 7 (internvl2); dh 112 zero-filled
# inside the (128, 128) instance (zamba2); then the (64, 64) instance's 128-key tiles over
# long key ranges that end in a ragged tile: Sq 128 over 1,000 keys, GQA at Sq 64, and
# causal with a window and a softcap, whose first tiles no row sees
FLASH_FAMILY_CASES = [
    (1, 12, 12, 1500, 1500, 64, 64, False, None, None, True),
    (1, 4, 4, 100, 1500, 64, 64, False, None, None, True),
    (1, 4, 4, 200, 150, 64, 64, False, None, None, False),
    (1, 4, 4, 1, 1500, 64, 64, False, None, None, False),
    (1, 14, 2, 300, 300, 64, 64, True, None, None, True),
    (1, 4, 4, 300, 300, 112, 112, True, None, None, True),
    (1, 4, 4, 128, 1000, 64, 64, False, None, None, True),
    (2, 14, 2, 64, 900, 64, 64, False, None, None, True),
    (1, 4, 2, 50, 1000, 64, 64, True, 100, 30.0, False),
]
FLASH_CASES += FLASH_FAMILY_CASES
FLASH_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# the bf16 kernel's large-head instances at their edges, held per value (2 ulp(|o|)
# + 2^-5 of the row's rms): (B, Hq, Hkv, Sq, Skv, dh, dv, window, softcap, scale, q scale), causal
FLASH_EDGE_CASES = [
    (1, 4, 2, 100, 150, 160, 96, None, None, None, 1.0),      # (192, 128) instance, TMA zero-fills dh, dv
    (1, 4, 2, 100, 150, 256, 256, 64, 50.0, None, 1000.0),    # |s·scale| ≫ softcap: tanh.approx saturates
    (1, 4, 4, 70, 200, 192, 128, None, None, 192**-0.5, 1.0),  # MLA's heads, Sq < Skv
]


def wgmma_name(dk, dv):
    """The bf16 flash kernel's instance (DK, DV) as ``ptxas_report`` names it."""
    return f"flash_wgmma_kernel<bf16, {dk}, {dv}>"


def bf16_limit(ref32):
    """Per value: 2 ulps of |o| plus 2^-5 of its row's rms (p rounds to bf16 at
    different running maxima in the kernel and the plain version, an error of
    ~0.3% of the row's rms with no floor at o ≈ 0)."""
    import torch

    ulp = torch.where(ref32 == 0, 0.0, torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32)[1] - 8))
    return 2 * ulp + 2**-5 * ref32.pow(2).mean(-1, keepdim=True).sqrt()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def wgmma_serialized(log):
    """From an ``-Xptxas -v`` log: why ptxas serialised the wgmma of each
    function whose wgmma it serialised, by mangled name."""
    # "(C75xx) Potential Performance Loss: wgmma.mma_async instructions are serialized due to <why> ... '<name>'"
    return {name: why for why, name in re.findall(r"wgmma\.mma_async instructions are serialized due to "
                                                   r"([^']*?) (?:for|in) the function '([^']*)'", log)}


def ptxas_report(log):
    """Registers and spill bytes of every kernel instance, from ``-Xptxas -v``;
    for the bf16 flash kernel's instances (DK, DV) also why ptxas serialised
    their wgmma, if it did (None: it did not)."""
    kinds = {"d": "double", "f": "float"}
    serialized = wgmma_serialized(log)
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        m = re.search(r"(ms_update_kernel|ebe_kernel)I(d|f)(Lb[01]E)?E", mangled)
        fa = re.search(r"flash_kernelILi(\d+)E", mangled)  # the fp32 3×TF32 mma.sync kernel
        wg = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)E", mangled)  # the bf16 one
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if (m or fa or wg) and regs:
            if wg:
                name = wgmma_name(int(wg.group(1)), int(wg.group(2)))
            elif fa:
                name = f"flash_kernel<float, {fa.group(1)}>"
            else:  # the EBE kernel has a one-member and a k-set instance
                kset = {"Lb0E": ", one member", "Lb1E": ", k-set"}.get(m.group(3), "")
                name = f"{m.group(1)}<{kinds[m.group(2)]}{kset}>"
            out[name] = {"registers": int(regs.group(1)),
                         "spill_store_bytes": int(spill.group(1)) if spill else None,
                         "spill_load_bytes": int(spill.group(2)) if spill else None}
            if wg:
                out[name]["wgmma_serialized"] = serialized.get(mangled)
    return out


# one fp64 power as the multispring kernel takes it, and one fp64 division
SASS_PROBE = r"""
extern "C" __global__ void probe_power(const double* x, const double* b, double* y) {
  y[threadIdx.x] = exp2(b[threadIdx.x] * log2(x[threadIdx.x]));
}
extern "C" __global__ void probe_division(const double* x, const double* b, double* y) {
  y[threadIdx.x] = b[threadIdx.x] / (1.0 + x[threadIdx.x]);
}
"""
FP64_OPS = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")


def _sass_ops(chunk):
    return re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", chunk, re.M)


def sass_fp64_counts(lib, nvcc):
    """Static fp64 instructions (and all instructions) of the FEM kernels'
    fp64 instances in the built library, and of one power and one division
    (``SASS_PROBE``), from ``cuobjdump -sass``; and of each bf16 flash
    instance the local-memory loads and stores (``LDL``, ``STL``: spills),
    its wgmma (``HGMMA``) and SFU (``MUFU``) instructions."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    build_dir = os.path.dirname(lib)
    probe_src, probe_bin = os.path.join(build_dir, "sass_probe.cu"), os.path.join(build_dir, "sass_probe.cubin")
    with open(probe_src, "w") as f:
        f.write(SASS_PROBE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o", probe_bin,
                    probe_src], check=True, capture_output=True)
    out = {}
    for path in (str(lib), probe_bin):
        text = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True).stdout
        for chunk in re.split(r"\n\s+Function : ", text)[1:]:
            name = chunk.split("\n", 1)[0].strip()
            wg = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)E", name)
            if wg:
                ops = _sass_ops(chunk)
                out[wgmma_name(int(wg.group(1)), int(wg.group(2)))] = {
                    "instructions": len(ops), "LDL": ops.count("LDL"), "STL": ops.count("STL"),
                    "HGMMA": ops.count("HGMMA"), "MUFU": ops.count("MUFU")}
                continue
            key = next((k for k in ("ms_update_kernelIdE", "ebe_kernelIdLb0EE", "ebe_kernelIdLb1EE", "probe_power",
                                    "probe_division") if k in name), None)
            if key is None:
                continue
            ops = _sass_ops(chunk)
            out[key] = {"instructions": len(ops), "fp64": sum(op in FP64_OPS for op in ops),
                        "mufu": ops.count("MUFU")}
    return out


def emit(obj):
    print(json.dumps(obj), flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            emit({"phase": self.name, "seconds": time.perf_counter() - self.t0})
        return False


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Device ms of one call of ``fn``: CUDA events around ``reps`` calls after
    a warm-up.  The card first spins ~10 ms in a sleep kernel while the host
    enqueues the calls, so that they run back to back: where one call's host
    work outlasts its kernels (whisper's smallest attention shapes), the
    events time the kernels and not the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def bound(nbytes_, flops, dt):
    """The least ms the card could take: bytes over its memory rate or operations over its peak rate."""
    t_bytes, t_ops = nbytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS[str(dt)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# the families other than qwen3 in train_cpu, each at its reduced config
TRAIN_FAMILIES = ("granite-8b", "gemma2-2b", "mixtral-8x22b", "deepseek-v2-236b", "mamba2-780m", "zamba2-7b",
                  "whisper-small", "internvl2-1b")
TRAIN_NPART = 8  # train_main's moment blocks in pinned host memory
# train_cpu's bf16 step, card against CPU: relative to the CPU's loss, and to max|g| per leaf
# (readings on an H100 at 700 W: 2.5e-5 and 1.7e-2, the embedding's gradient)
TRAIN_BF16_TOL = {"loss": 1e-4, "grad": 5e-2}


def _train_batch(cfg, B, S, device, seed=0):
    """One ``data.batches`` batch of ``cfg`` (its frontend input included) on ``device``."""
    import torch
    from repro_torch.training import data as D

    b = next(D.batches(D.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=seed,
                                    frontend=cfg.frontend, d_model=cfg.d_model,
                                    n_frontend_tokens=cfg.n_frontend_tokens)))
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _worst_leaf(got, want):
    """(max over leaves of max|got − want| / max|want|, its leaf) for two trees of tensors."""
    from repro_torch.utils.tree import leaves_with_paths

    worst = (0.0, None)
    for (path, a), (_, b) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        b = b.float()
        err = float((a.float().to(b.device) - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, (err, path), key=lambda x: x[0])
    return worst


def train_cpu(dev):
    """qwen3-1.7b at full width, 2 layers, fp32, B 1 × 256, and every other
    family at its reduced config (B 2 × 32, its frontend input): the loss
    and the gradient of one train step on the card against the port on the
    CPU on the same weights and batch (1e-5 relative; each leaf within
    1e-4·max|g|), and AdamW on the CPU's gradients on both (params and
    moments within 1e-6·max).  With remat the backward recomputes each
    block, so the fp32 flash kernel runs twice a layer: twice what one
    ``forward`` under ``no_grad`` launches.  Then qwen3's case again in
    bf16 (:func:`_train_bf16`).  → the step's fp32 launches by model, and
    the bf16 step's launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT, train_step as TS

    qwen = ARCHS["qwen3-1.7b"]
    cases = [(dataclasses.replace(qwen, n_layers=2, dtype="float32"), 1, 256)]
    cases += [(ARCHS[name].reduced(), 2, 32) for name in TRAIN_FAMILIES]
    launches = {}
    for cfg, B, S in cases:
        tcfg = TS.TrainConfig()
        loss_fn = TS.make_loss_fn(cfg, tcfg)
        p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        p_gpu = _tree_to(p_cpu, dev)
        b_cpu = _train_batch(cfg, B, S, "cpu")
        b_gpu = {k: v.to(dev) for k, v in b_cpu.items()}
        m_cpu, g_cpu = TS.value_and_grad(loss_fn, p_cpu, b_cpu)
        kernels.reset_launch_counts()
        with torch.no_grad():
            T.forward(p_gpu, cfg, b_gpu)
        fwd = kernels.instance_counts()
        kernels.reset_launch_counts()  # the train step's launches alone
        m_gpu, g_gpu = TS.value_and_grad(loss_fn, p_gpu, b_gpu)
        torch.cuda.synchronize()
        step_launches = kernels.instance_counts()
        loss_rel = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        grad_err, grad_leaf = _worst_leaf(g_gpu, g_cpu)
        # AdamW on the same (the CPU's) gradients on both devices, clipping on
        st_cpu = OPT.adamw_init(p_cpu, tcfg.adamw)
        st_gpu = OPT.adamw_init(p_gpu, tcfg.adamw)
        new_cpu, st_cpu = OPT.adamw_apply(g_cpu, p_cpu, st_cpu, tcfg.adamw)
        new_gpu, st_gpu = OPT.adamw_apply(_tree_to(g_cpu, dev), p_gpu, st_gpu, tcfg.adamw)
        adamw_err = max(_worst_leaf(new_gpu, new_cpu)[0], _worst_leaf(st_gpu.moments, st_cpu.moments)[0])
        emit({"check": "train_gpu_vs_cpu", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype, "B": B,
              "S": S, "loss_cpu": float(m_cpu["loss"]), "loss_gpu": float(m_gpu["loss"]), "loss_rel_err": loss_rel,
              "grad_worst_rel_err": grad_err, "grad_worst_leaf": grad_leaf, "adamw_worst_rel_err": adamw_err,
              "tol": {"loss": 1e-5, "grad": 1e-4, "adamw": 1e-6},
              "flash_launches_forward": fwd, "flash_launches_train_step": step_launches})
        require(fwd["flash_attention_bf16"] == 0 and step_launches["flash_attention_bf16"] == 0,
                f"{cfg.name}: fp32 training launched the bf16 flash kernel")
        require(step_launches["flash_attention_f32"] == 2 * fwd["flash_attention_f32"],
                f"{cfg.name}: the train step's fp32 flash launches {step_launches}, not twice a forward's {fwd}")
        require(fwd["flash_attention_f32"] == flash_per_pass(cfg),
                f"{cfg.name}: forward's flash launches {fwd}, not {flash_per_pass(cfg)}")
        require(loss_rel <= 1e-5, f"{cfg.name}: training loss on the card differs from the CPU: {loss_rel}")
        require(grad_err <= 1e-4, f"{cfg.name}: gradient {grad_leaf} on the card differs from the CPU: {grad_err}")
        require(adamw_err <= 1e-6, f"{cfg.name}: AdamW on the card differs from the CPU: {adamw_err}")
        launches[cfg.name] = step_launches["flash_attention_f32"]
        if cfg is cases[0][0]:
            ref32 = float(m_cpu["loss"]), g_cpu  # the bf16 step below is held to these
        del p_cpu, p_gpu, g_cpu, g_gpu, new_cpu, new_gpu, st_cpu, st_gpu
    return launches, _train_bf16(dev, dataclasses.replace(cases[0][0], dtype="bfloat16"), *cases[0][1:], *ref32)


def _train_bf16(dev, cfg, B, S, loss32, g32):
    """The bf16 train step that train_main times, small: ``cfg`` (qwen3's
    two layers at full width, bf16 over the fp32 parameters of train_cpu's
    first case, its batch), on the card and on the CPU.  The card runs the
    bf16 (128, 128) kernel under ``FlashAttentionFn``, twice a layer; the
    CPU its plain version.  Held: the card's loss and each gradient leaf
    against the CPU's (``TRAIN_BF16_TOL``), and the card's distance from
    the fp32 step (``loss32``, ``g32``) at most twice the CPU's, leaf by
    leaf at the worst.  → the step's bf16 launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS

    loss_fn = TS.make_loss_fn(cfg, TS.TrainConfig())
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p_gpu = _tree_to(p_cpu, dev)
    b_cpu = _train_batch(cfg, B, S, "cpu")
    b_gpu = {k: v.to(dev) for k, v in b_cpu.items()}
    m_cpu, g_cpu = TS.value_and_grad(loss_fn, p_cpu, b_cpu)
    kernels.reset_launch_counts()
    with torch.no_grad():
        T.forward(p_gpu, cfg, b_gpu)
    fwd = kernels.instance_counts()
    kernels.reset_launch_counts()
    m_gpu, g_gpu = TS.value_and_grad(loss_fn, p_gpu, b_gpu)
    torch.cuda.synchronize()
    step_launches = kernels.instance_counts()
    loss_cpu, loss_gpu = float(m_cpu["loss"]), float(m_gpu["loss"])
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err, grad_leaf = _worst_leaf(g_gpu, g_cpu)
    cpu_vs32, gpu_vs32 = _worst_leaf(g_cpu, g32), _worst_leaf(g_gpu, g32)
    loss_cpu_vs32, loss_gpu_vs32 = abs(loss_cpu - loss32) / abs(loss32), abs(loss_gpu - loss32) / abs(loss32)
    emit({"check": "train_bf16_gpu_vs_cpu", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype, "B": B,
          "S": S, "loss_cpu": loss_cpu, "loss_gpu": loss_gpu, "loss_fp32": loss32, "loss_rel_err": loss_rel,
          "grad_worst_rel_err": grad_err, "grad_worst_leaf": grad_leaf,
          "loss_rel_err_vs_fp32": {"cpu": loss_cpu_vs32, "gpu": loss_gpu_vs32},
          "grad_worst_rel_err_vs_fp32": {"cpu": cpu_vs32, "gpu": gpu_vs32}, "tol": TRAIN_BF16_TOL,
          "flash_launches_forward": fwd, "flash_launches_train_step": step_launches})
    require(fwd["flash_attention_f32"] == 0 and step_launches["flash_attention_f32"] == 0,
            "bf16 training launched the fp32 flash kernel")
    require(fwd["flash_attention_bf16"] == flash_per_pass(cfg)
            and step_launches["flash_attention_bf16"] == 2 * fwd["flash_attention_bf16"],
            f"bf16 train step's flash launches {step_launches}, not twice a forward's {fwd}")
    require(loss_rel <= TRAIN_BF16_TOL["loss"], f"bf16 training loss on the card differs from the CPU: {loss_rel}")
    require(grad_err <= TRAIN_BF16_TOL["grad"],
            f"bf16 gradient {grad_leaf} on the card differs from the CPU: {grad_err}")
    require(loss_gpu_vs32 <= 2 * loss_cpu_vs32 + 1e-6,
            f"bf16 loss on the card is {loss_gpu_vs32} from fp32's, the CPU's {loss_cpu_vs32}")
    require(gpu_vs32[0] <= 2 * cpu_vs32[0],
            f"bf16 gradients on the card are {gpu_vs32} from fp32's, the CPU's {cpu_vs32}")
    return step_launches["flash_attention_bf16"]


def _pinned(tree):
    """A pinned host copy of a (nested dict) tree of tensors."""
    import torch

    if isinstance(tree, dict):
        return {k: _pinned(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True).copy_(tree)


def _equal_to_host(tree, host):
    """Every leaf of ``tree`` bitwise its host copy's in ``host``."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    return all(torch.equal(x, h.to(x.device)) for x, h in zip(tree_leaves(tree), tree_leaves(host)))


def _max_diff_to_host(tree, host):
    from repro_torch.utils.tree import tree_leaves

    pairs = zip(tree_leaves(tree), tree_leaves(host))
    return max(float((x.float() - h.to(x.device).float()).abs().max()) for x, h in pairs)


def _device_profile(prof, step_s, profiled_s):
    """The device's time in one profiled step (kernels and copies, ms), its
    share of an unprofiled step of ``step_s`` (the busy share; the profiled
    step's ``profiled_s`` carries the profiler's host overhead) and the top
    device ops."""
    # the raw device events (tens of thousands a step): key_averages() would
    # spend ~10 s building its tables
    by_name, n_ops = {}, 0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
            n_ops += 1
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": device_ms, "device_busy_share": device_ms / (step_s * 1e3), "profiled_step_s": profiled_s,
            "device_ops": n_ops, "top_device_ops_ms": {k[:120]: ms for k, ms in top}}


def _adamw_apply_timed(apply, *args):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = apply(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def train_main(dev, params, cfg, cli):
    """qwen3-1.7b whole (``params``: lm_main's fp32 parameters on the host;
    every run starts from a device copy of them),
    bf16 compute, B 2 × 4,096 from ``data.batches`` through the
    ``Prefetcher``.  First the train CLI's checks (:func:`train_cli_check`:
    its processes started before ``train_cpu`` and end before anything here
    is timed).  (1) AdamW alone on the gradients of one short batch, twice
    (the second from non-zero moments): resident, offloaded ``serial`` and
    ``prefetch`` (8 pinned blocks) — params and both moments bitwise equal,
    and each warm apply's ms.  (2) 3 train steps each: resident, resident
    again, offloaded serial, offloaded prefetch, from the same params and
    batches — s per step (first, warm), tokens/s, peak device bytes, pinned
    host bytes of the moments, bf16 (128, 128) launches a step (2 × 28),
    the device's busy share and top ops over the last step
    (``torch.profiler``).  If the two resident runs are bitwise equal, every
    run must be bitwise the resident one; else the offloaded runs are held
    to the resident run-to-run spread.  → the bf16 flash launches of
    (1) and (2)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import hetmem, offload as O
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.training import data as D, optimizer as OPT, train_step as TS
    from repro_torch.utils.tree import tree_leaves

    B, S, STEPS = 2, 4096, 3
    dcfg = D.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    tokens = B * S
    t_start = time.perf_counter()
    train_cli_check(cli)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    inst = (128, 128)  # qwen3's heads: dh 128

    marks = {}
    t_mark = t_start

    def mark(name):
        nonlocal t_mark
        torch.cuda.synchronize()
        marks[name] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()

    # (1) AdamW alone on the same gradients (of one short batch: the update's
    # cost and bits depend on the gradients' shapes, not their batch)
    tcfg = TS.TrainConfig()
    host_params, params = params, _tree_to(params, dev)
    pf = D.Prefetcher(D.batches(dataclasses.replace(dcfg, seq_len=512, global_batch=1)), depth=1, device=dev)
    _, grads = TS.value_and_grad(TS.make_loss_fn(cfg, tcfg), params, next(pf))
    pf.close()
    mark("gradients_s")
    adamw_ms = {}
    st = OPT.adamw_init(params, tcfg.adamw)
    (p1, st1), _ = _adamw_apply_timed(OPT.adamw_apply, grads, params, st, tcfg.adamw)
    del st
    (p_res, st_res), adamw_ms["resident"] = _adamw_apply_timed(OPT.adamw_apply, grads, p1, st1, tcfg.adamw)
    del p1, st1
    adamw_equal, host_bytes = {}, {}
    for schedule in ("serial", "prefetch"):
        off = O.OffloadConfig(optimizer_state=True, optimizer_npart=TRAIN_NPART)
        st = O.offloaded_adamw_init(params, tcfg.adamw, off)
        apply = lambda g, p, s: O.offloaded_adamw_apply(g, p, s, tcfg.adamw, schedule=schedule)  # noqa: E731
        mark(f"offloaded_init_{schedule}_s")
        (p1, st), _ = _adamw_apply_timed(apply, grads, params, st)
        (p2, st), adamw_ms[f"offloaded_{schedule}"] = _adamw_apply_timed(apply, grads, p1, st)
        del p1
        pinned = all(hetmem.is_pinned_host(x) for blk in st.moments.blocks for x in blk)
        host_bytes[schedule] = sum(x.numel() * x.element_size() for blk in st.moments.blocks for x in blk)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p2), tree_leaves(p_res)))
        same = same and all(torch.equal(a.to(dev), b) for a, b in zip(tree_leaves(O.moments_tree(st)),
                                                                      tree_leaves(st_res.moments)))
        adamw_equal[schedule] = same
        require(pinned, f"offloaded AdamW ({schedule}): the moment blocks are not pinned host tensors")
        del p2, st
        mark(f"offloaded_{schedule}_applies_and_compare_s")
    emit({"check": "train_adamw_offloaded_vs_resident", "arch": cfg.name, "npart": TRAIN_NPART,
          "bitwise_params_and_moments": adamw_equal, "adamw_ms_warm": adamw_ms,
          "moments_pinned_host_bytes": host_bytes["serial"]})
    for schedule, same in adamw_equal.items():
        require(same, f"offloaded AdamW ({schedule}) differs from the resident one on the same gradients")
    del grads, p_res, st_res, params
    launches = fa_ops.wgmma_launch_counts()[inst]
    torch.cuda.empty_cache()  # each run below starts from the same free memory

    # (2) whole train steps
    runs = {"resident": O.OffloadConfig(), "resident_repeat": O.OffloadConfig(),
            "offloaded_serial": O.OffloadConfig(optimizer_state=True, optimizer_npart=TRAIN_NPART),
            "offloaded_prefetch": O.OffloadConfig(optimizer_state=True, optimizer_npart=TRAIN_NPART,
                                                  optimizer_schedule="prefetch")}
    results = {}
    ref_host = ref_losses = None
    for name, off in runs.items():
        tcfg = TS.TrainConfig(offload=off)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mark(f"{name}_before_s")
        params = _tree_to(host_params, dev)
        opt = TS.init_train_state(cfg, tcfg, params)
        step = TS.make_train_step(cfg, tcfg)
        pf = D.Prefetcher(D.batches(dcfg), depth=2, device=dev)
        mark(f"{name}_init_s")
        p, secs, waits, losses = params, [], [], []
        fa_ops.counter.reset()
        for i in range(STEPS):
            batch = next(pf)
            waits.append(pf.last_wait_s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) if i == STEPS - 1
                  else contextlib.nullcontext()) as prof:
                p, opt, m = step(p, opt, batch)
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        pf.close()
        per_step = {f"{dk}x{dv}": n / STEPS for (dk, dv), n in fa_ops.wgmma_launch_counts().items() if n}
        f32 = fa_ops.COUNTERS[torch.float32].n
        launches += fa_ops.wgmma_launch_counts()[inst]
        r = {"run": name, "steps": STEPS, "B": B, "S": S, "losses": losses, "step_s": secs,
             "first_step_s": secs[0], "warm_step_s": secs[1], "tokens_per_s_warm": tokens / secs[1],
             "adamw_ms_warm": adamw_ms[f"offloaded_{off.optimizer_schedule}" if off.optimizer_state else "resident"],
             "prefetch_wait_s": waits, "peak_device_bytes": torch.cuda.max_memory_allocated(),
             "peak_device_bytes_above_start": torch.cuda.max_memory_allocated() - base,
             "flash_bf16_launches_per_step": per_step, "flash_f32_launches": f32,
             "profiled_step": _device_profile(prof, secs[1], secs[-1])}
        if off.optimizer_state:
            r["moments_pinned_host_bytes"] = sum(x.numel() * x.element_size() for blk in opt.moments.blocks
                                                 for x in blk)
        mark(f"{name}_steps_s")
        if ref_host is None:
            ref_host, ref_losses = _pinned(p), losses
        else:
            r["bitwise_resident"] = losses == ref_losses and _equal_to_host(p, ref_host)
            r["max_abs_param_diff_vs_resident"] = 0.0 if r["bitwise_resident"] else _max_diff_to_host(p, ref_host)
        results[name] = r
        emit({"train_main": r})
        require(per_step == {"128x128": 2 * cfg.n_layers} and f32 == 0,
                f"{name}: flash launches a step {per_step} (fp32 {f32}), not {2 * cfg.n_layers} of (128, 128)")
        require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        del p, params, opt, m, batch
    deterministic = results["resident_repeat"]["bitwise_resident"]
    spread = results["resident_repeat"]["max_abs_param_diff_vs_resident"]
    emit({"check": "train_offloaded_vs_resident", "resident_runs_bitwise_equal": deterministic,
          "resident_run_to_run_max_abs_param_diff": spread,
          "held_to": "bitwise" if deterministic else "the resident run-to-run spread",
          **{name: {k: results[name][k] for k in ("bitwise_resident", "max_abs_param_diff_vs_resident")}
             for name in ("offloaded_serial", "offloaded_prefetch")}})
    for name in ("offloaded_serial", "offloaded_prefetch"):
        if deterministic:
            require(results[name]["bitwise_resident"], f"{name}: train steps differ from the resident run")
        else:
            require(results[name]["max_abs_param_diff_vs_resident"] <= spread,
                    f"{name}: params differ from the resident run beyond its run-to-run spread")
    del ref_host
    torch.cuda.empty_cache()
    mark("after_runs_s")
    emit({"train_main_seconds": marks})
    return launches


def _train_cli_argv(ck, steps):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--reduced", "--steps",
            str(steps), "--offload-optimizer", "--ckpt-every", "10", "--ckpt-dir", ck]


def train_cli_start(root):
    """Start the train CLI on the card, reduced qwen3, in processes that run
    beside the phases that follow (``train_cli_check`` reads them): (a) 30
    steps with a checkpoint every 10; (b) the same with no end, killed once
    its step-10 checkpoint is committed, then (c) relaunched as (a) on its
    directory.  A thread drives (b) and (c); every process still running
    when the script exits is killed."""
    import atexit
    import threading

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ck_a, ck_b = os.path.join(root, "a"), os.path.join(root, "b")
    procs = []

    def launch(ck, steps):
        proc = subprocess.Popen(_train_cli_argv(ck, steps), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env=env, cwd=ROOT)
        procs.append(proc)
        return proc

    def stop_all():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop_all)
    cli = {"t0": time.perf_counter(), "a": launch(ck_a, 30), "stop_all": stop_all}
    b = launch(ck_b, 1_000_000)

    def kill_and_relaunch():
        try:
            b_out = []
            for line in b.stdout:
                b_out.append(line)
                if line.startswith("step    10"):
                    break
            deadline = time.perf_counter() + 300
            while not os.path.exists(os.path.join(ck_b, "step_000000010", "manifest.json")):
                if time.perf_counter() > deadline or b.poll() is not None:
                    raise AssertionError(f"train CLI (b) wrote no step-10 checkpoint: {''.join(b_out)[-2000:]}")
                time.sleep(0.005)
            b.kill()
            b.wait(timeout=60)
            cli.update(b_rc=b.returncode, checkpoints_at_kill=sorted(os.listdir(ck_b)))
            c = launch(ck_b, 30)
            cli.update(c_out=c.communicate(timeout=600)[0], c_rc=c.returncode)
        except BaseException as e:  # re-raised by train_cli_check on the main thread
            cli["error"] = e

    cli["thread"] = threading.Thread(target=kill_and_relaunch, daemon=True)
    cli["thread"].start()
    return cli


def train_cli_check(cli):
    """Wait for the processes of :func:`train_cli_start` and check them: (a)
    completes and its nll at step 20 is below step 0's (the CLI's learning
    rate and warm-up are gentler than the CPU test's); (b) was killed; (c)
    prints ``[resume]`` and completes."""
    try:
        a_out = cli["a"].communicate(timeout=600)[0]
        cli["thread"].join(timeout=600)
    finally:
        cli["stop_all"]()
    if "error" in cli:
        raise cli["error"]
    a_rc, c_out = cli["a"].returncode, cli.get("c_out", "")
    nll = {int(s): float(v) for s, v in re.findall(r"^step\s+(\d+)\s+nll\s+(\S+)$", a_out, re.M)}
    resumed = re.search(r"^\[resume\] from checkpoint step (\d+)$", c_out, re.M)
    emit({"check": "train_cli", "argv": _train_cli_argv("DIR", 30)[1:], "rc": a_rc, "nll": nll,
          "killed_rc": cli.get("b_rc"), "checkpoints_at_kill": cli.get("checkpoints_at_kill"),
          "relaunch_rc": cli.get("c_rc"), "relaunch_resumed_from": int(resumed.group(1)) if resumed else None,
          "relaunch_out": c_out[-400:], "seconds_since_start": time.perf_counter() - cli["t0"]})
    require(a_rc == 0 and "training complete" in a_out, f"train CLI failed: {a_out[-2000:]}")
    require(0 in nll and 20 in nll and nll[20] < nll[0], f"train CLI's nll did not fall by step 20: {nll}")
    require(cli.get("b_rc") not in (0, None), "train CLI (b) ended before it was killed")
    require(cli.get("c_rc") == 0 and resumed and "training complete" in c_out,
            f"relaunched train CLI did not resume: {c_out[-2000:]}")


KSET_KERNELS = ("multispring_kset", "ebe_matvec_kset_f64", "ebe_matvec_kset_f32")
# the campaign CLI at (8, 8, 4): 3 waves in rounds of 2, 6 steps, chunks of 2, guarded
CAMPAIGN_FLAGS = ["--waves", "3", "--nt", "6", "--mesh-n", "8x8x4", "--kset", "2", "--ckpt-every", "2", "--health"]


def campaign_check(root):
    """The port's campaign CLI in-process (``launch.campaign.main``) on the
    card at (8, 8, 4): for Proposed 2, Proposed 1 and Baseline 1 an
    uncheckpointed run, a run killed after step 7 and its relaunch, and a
    third launch (a pure restore), bitwise equal.  For Proposed 2 also the
    same campaign on the CPU within 1e-6·max|v|, an injected NaN in case 1
    (the same health words on the card as on the CPU, siblings bitwise
    unchanged, case 1 quarantined out of the shards, which load back with
    their CRCs checked) and two foreign relaunches (another seed; the CPU's
    kernel backend) refused as a different campaign."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch import campaign as cli
    from repro_torch.surrogate import dataset

    shutil.rmtree(root, ignore_errors=True)
    printed, seconds = [], {}

    def launch(*flags):
        out, buf = {}, io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*CAMPAIGN_FLAGS, *flags], result=out)
        where = "cpu" if "cpu" in flags else "card"
        seconds[where] = seconds.get(where, 0.0) + time.perf_counter() - t0
        printed.append(buf.getvalue())
        require(rc == 0, f"campaign {flags} exited {rc}")
        return out

    rows = {}
    for m in ("proposed2", "proposed1", "baseline1"):
        d = os.path.join(root, m, "ckpt")
        kernels.reset_launch_counts()
        straight = launch("--method", m)["campaign"]
        ran = kernels.launch_counts()
        part = launch("--method", m, "--ckpt-dir", d, "--stop-after-steps", "7")["campaign"]
        resumed = launch("--method", m, "--ckpt-dir", d)["campaign"]
        again = launch("--method", m, "--ckpt-dir", d)["campaign"]
        v = straight.velocity_history
        same = [bool(np.array_equal(r.velocity_history, v) and np.array_equal(r.iters, straight.iters))
                for r in (resumed, again)]
        rows[m] = {"steps_at_stop": part.steps_done, "resumed_from": [resumed.resumed_from, again.resumed_from],
                   "resume_bitwise": same[0], "restore_bitwise": same[1], "iters": straight.iters.tolist(),
                   "launches": ran}
        require(straight.completed and not part.completed and part.steps_done == 8, f"{m}: kill point")
        require(all(same), f"{m}: the resumed campaign is not bitwise the uncheckpointed one: {same}")
        if m == "proposed2":  # the CRS rungs' card ≡ CPU on this mesh: crs_check and kset_check
            cpu = launch("--method", m, "--device", "cpu")["campaign"]
            scale = float(np.abs(cpu.velocity_history).max())
            err = float(np.abs(v - cpu.velocity_history).max())
            rows[m].update(card_vs_cpu_rel=err / scale, iters_cpu=cpu.iters.tolist())
            require(scale > 0 and err <= 1e-6 * scale, f"{m}: card ≠ CPU: {err / scale}")
        require(ran["multispring_kset"] > 0 and ran["multispring"] > 0, f"{m}: multispring launches {ran}")
        require((ran["ebe_matvec_kset_f64"] > 0 and ran["ebe_matvec_kset_f32"] > 0) == (m == "proposed2"),
                f"{m}: k-set EBE launches {ran}")
        if m == "proposed2":
            clean, d_p2 = straight, d
    # an injected NaN: the same words on the card as on the CPU, siblings untouched, case 1 quarantined
    inject = ["--inject", "nan_at_step=2,case=1"]
    shards = os.path.join(root, "shards")
    bad = launch(*inject, "--out", shards)
    bad_cpu = launch(*inject, "--device", "cpu", "--out", os.path.join(root, "shards_cpu"))["campaign"]
    res = bad["campaign"]
    x, y = dataset.load_shards(shards)  # CRCs checked
    meta = dataset.shard_meta(shards)
    siblings = all(np.array_equal(res.velocity_history[i], clean.velocity_history[i]) for i in (0, 2))
    rows["inject"] = {"words": res.health.tolist(), "words_cpu": bad_cpu.health.tolist(),
                      "nonconverged": res.nonconverged.tolist(), "siblings_bitwise": siblings,
                      "shard_rows": len(x), "quarantine": meta.get("quarantine"),
                      "printed": [ln for ln in printed[-2].splitlines() if "[health]" in ln or "[quarantine]" in ln]}
    require(np.array_equal(res.health, bad_cpu.health), "health words differ between card and CPU")
    require(res.diverged_cases().tolist() == [1] and siblings, "the NaN did not stay in case 1")
    require(meta.get("quarantine") == [1] and len(x) == len(y) == 2, f"case 1 not quarantined: {meta}")
    require(np.array_equal(x, bad["waves"]) and np.array_equal(y, bad["responses"]), "shards read back differ")
    # foreign relaunches into the finished Proposed 2 checkpoint directory
    refused = {}
    for name, flags in (("seed", ["--seed", "1"]), ("kernel_backend", ["--device", "cpu", "--kernel-backend", "torch"])):
        try:
            launch(*flags, "--ckpt-dir", d_p2)
            refused[name] = "accepted"
        except ValueError as e:
            refused[name] = "different campaign" in str(e)
    rows["foreign_refused"] = refused
    emit({"check": "campaign", "mesh": [8, 8, 4], "waves": 3, "kset": 2, "nt": 6, "ckpt_every": 2, **rows,
          "launch_seconds": seconds})
    require(all(v is True for v in refused.values()), f"a foreign checkpoint was not refused: {refused}")


def campaign_main(mesh, cfg, waves, kset_v, root):
    """The campaign at full width on the card (``run_campaign(...,
    device=None)``): (a) Proposed 2, kset 2, M 3 (two rounds, the tail
    padded), 4 steps, unguarded and guarded: per chunk s/step per case, peak
    device bytes and the k-set kernels' launches; round 0 against
    kset_main's 2SET ``kset_v`` on the same waves.  (b) the checkpointed
    kill-and-resume, M 2, a checkpoint every 2 steps, keep 1, stopped after
    step 2 and resumed: bitwise (a)'s guarded round 0; each checkpoint's
    bytes and seconds to copy, write, CRC and restore; the free disk first;
    the peak device bytes of the stopped run and of the resume, which
    restores into the one carry it builds (no second k-set carry)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.campaign import CampaignConfig, run_campaign

    every_node = np.arange(mesh.n_nodes)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    runs = {}
    for guarded in (False, True):
        cfg_a = dataclasses.replace(cfg, health=guarded)
        chunks = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()  # counts of this run only
        last = dict(kernels.launch_counts())

        def on_chunk(info, chunks=chunks, last=last, resident_before=resident_before):
            counts = kernels.launch_counts()
            row = dict(info, s_per_step_per_case=info["seconds"] / ((info["t1"] - info["t0"]) * 2),
                       peak_device_bytes=torch.cuda.max_memory_allocated() - resident_before,
                       launches={k: counts[k] - last[k] for k in counts})
            last.update(counts)
            torch.cuda.reset_peak_memory_stats()
            chunks.append(row)
            emit({"campaign_main_chunk": row, "health": guarded})

        t0 = time.perf_counter()
        res = run_campaign(mesh, cfg_a, waves, observe=every_node, on_chunk=on_chunk,
                           campaign=CampaignConfig(kset=2, method="proposed2"))
        runs[guarded] = {"res": res, "run_s": time.perf_counter() - t0, "chunks": chunks,
                         "launches": kernels.launch_counts(), "resident_before": resident_before}
        require(res.completed and res.rounds_done == 2 and res.velocity_history.shape[0] == 3, "campaign (a) shape")
        require(bool(np.isfinite(res.velocity_history).all()) and np.abs(res.velocity_history).max() > 0,
                "campaign (a): not finite or moved nothing")
        for row in chunks:
            require(all(row["launches"][k] > 0 for k in KSET_KERNELS), f"a k-set kernel never launched: {row}")
    plain, guard = runs[False], runs[True]
    v0 = plain["res"].velocity_history[:2]
    vs_kset = float(np.abs(v0 - kset_v).max() / np.abs(kset_v).max())
    s_plain = [c["s_per_step_per_case"] for c in plain["chunks"]]
    s_guard = [c["s_per_step_per_case"] for c in guard["chunks"]]
    emit({"campaign_main": {
        "mesh": [64, 64, 12], "nspring": cfg.nspring, "M": 3, "kset": 2, "steps": waves.shape[1],
        "s_per_step_per_case": s_plain, "s_per_step_per_case_guarded": s_guard,
        "guard_cost_s_per_step_per_case": [g - p for g, p in zip(s_guard, s_plain)],
        "run_s": plain["run_s"], "run_s_guarded": guard["run_s"],
        "peak_device_bytes": [c["peak_device_bytes"] for c in plain["chunks"]],
        "peak_device_bytes_guarded": [c["peak_device_bytes"] for c in guard["chunks"]],
        "resident_before_bytes": plain["resident_before"], "launches": plain["launches"],
        "launches_guarded": guard["launches"], "iters": plain["res"].iters.tolist(),
        "round0_vs_kset_main_rel": vs_kset, "round0_bitwise_kset_main": bool(np.array_equal(v0, kset_v)),
        "guarded_bitwise_unguarded": bool(np.array_equal(guard["res"].velocity_history,
                                                         plain["res"].velocity_history)),
        "health": guard["res"].health.tolist()}})
    require(vs_kset <= 1e-12, f"campaign round 0 disagrees with kset_main's 2SET: {vs_kset}")
    require(guard["res"].health.tolist() == [0, 0, 0], "a healthy full-size case tripped its guard")
    # (b) the checkpointed kill-and-resume at full size, guarded
    d = os.path.join(root, "ckpt")
    free_before = shutil.disk_usage(root).free
    cc = CampaignConfig(kset=2, method="proposed2", checkpoint_dir=d, checkpoint_every=2, keep=1)
    cfg_b = dataclasses.replace(cfg, health=True)

    def peak_from(fn):
        """``fn()`` and its peak device bytes above what was allocated before it."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - before

    t0 = time.perf_counter()
    part, peak_stopped = peak_from(lambda: run_campaign(mesh, cfg_b, waves[:2], observe=every_node, campaign=cc,
                                                        stop_after_steps=2))
    t1 = time.perf_counter()
    full, peak_resumed = peak_from(lambda: run_campaign(mesh, cfg_b, waves[:2], observe=every_node, campaign=cc))
    t2 = time.perf_counter()
    ref = guard["res"]
    same = all(np.array_equal(a, b[:2]) for a, b in ((full.velocity_history, ref.velocity_history),
                                                      (full.iters, ref.iters), (full.health, ref.health)))
    records = [dict(r, call="stopped") for r in part.checkpoints] + [dict(r, call="resumed")
                                                                     for r in full.checkpoints]
    for r in records:
        for part_s in ("write_s", "crc_s", "read_s", "host_copy_s"):
            if r.get(part_s):
                r[part_s.replace("_s", "_GB_per_s")] = r["bytes"] / r[part_s] / 1e9
    peak_guarded = max(c["peak_device_bytes"] for c in guard["chunks"])
    ckpt_bytes = max(r["bytes"] for r in records)
    emit({"campaign_checkpoint": {
        "free_disk_bytes_before": free_before, "stopped_at": part.steps_done, "resumed_from": full.resumed_from,
        "stopped_run_s": t1 - t0, "resumed_run_s": t2 - t1, "bitwise_vs_uncheckpointed_round0": same,
        "peak_device_bytes_stopped": peak_stopped, "peak_device_bytes_resumed": peak_resumed,
        "peak_device_bytes_guarded_chunk": peak_guarded, "records": records}})
    require(not part.completed and part.steps_done == 2 and full.completed and full.resumed_from == 2,
            "campaign (b) did not stop and resume at step 2")
    require(same, "the full-size kill-and-resume is not bitwise the uninterrupted round")
    # a second k-set carry on the card would add the checkpoint's bytes again
    require(peak_resumed < peak_guarded + ckpt_bytes / 2,
            f"the resume held more than one k-set carry: peak {peak_resumed} B vs {peak_guarded} B uninterrupted")
    shutil.rmtree(root, ignore_errors=True)
    return plain["launches"]


# campaign_mp: the campaign CLI at main's size (Proposed 2, 150 springs, k 1), 3 waves of
# 4 steps (cut from 5 to fit the run's time limit), a checkpoint every 2: one process,
# then two processes on the one card
CAMPAIGN_MP_FLAGS = ["--waves", "3", "--nt", "4", "--mesh-n", "64x64x12", "--nspring", "150",
                     "--method", "proposed2", "--kset", "1", "--ckpt-every", "2"]
CAMPAIGN_MP_TIMEOUT_S = {"one": 300, "pair_stopped": 240, "pair_resumed": 300}
_CLI_RECORD = re.compile(r"\[(chunk|checkpoint|launches)\] (\{.*\})$")


def _spawn(argvs, log_dir, name, timeout):
    """Each argv as ``python <argv>`` in a process of its own, all started at
    once, each writing a log file (a pipe left full would stall a sibling at
    a barrier).  A child that exits non-zero, or a launch that outlives
    ``timeout``, fails the phase; its siblings are killed.  Returns each
    child's output and wall seconds."""
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH")) if p))
    procs, logs, walls = [], [], [None] * len(argvs)
    t0 = time.perf_counter()
    try:
        for i, argv in enumerate(argvs):
            logs.append(open(os.path.join(log_dir, f"{name}_{i}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, *argv], stdout=logs[-1], stderr=subprocess.STDOUT,
                                          env=env, cwd=ROOT))
        while None in walls:
            for i, p in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.perf_counter() - t0
                    if p.returncode:
                        logs[i].seek(0)
                        raise AssertionError(f"{name}: process {i} exited {p.returncode}:\n"
                                             f"{logs[i].read()[-4000:]}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"{name}: not done within {timeout} s")
            time.sleep(0.2)
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
        return outs, walls
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def _cli_records(out):
    """The ``[chunk]``, ``[checkpoint]`` and ``[launches]`` JSON records a
    campaign CLI printed, by kind."""
    recs = {"chunk": [], "checkpoint": [], "launches": []}
    for line in out.splitlines():
        m = _CLI_RECORD.search(line)
        if m:
            recs[m.group(1)].append(json.loads(m.group(2)))
    return recs


def _host_mem_available():
    with open("/proc/meminfo") as f:
        return next(int(ln.split()[1]) * 1024 for ln in f if ln.startswith("MemAvailable:"))


def campaign_mp(root):
    """The multi-process campaign through the CLI, as a user runs it, at
    main's size (64×64×12, 150 springs, Proposed 2, k 1; θ of a case, 7.08
    GB, on the card, as the campaign's k-set keeps it), 3 waves of 4 steps,
    a checkpoint every 2: (1) one process, as the reference; (2) two
    processes on the one card (``--num-processes 2``), stopped after step 2;
    (3) the pair relaunched, resuming.  Each process's banked rounds are
    bitwise the one-process run's rows (process 1's padded lane bitwise
    case 2), the union of ``OUT/p00`` and ``OUT/p01`` is the one-process
    shards, a one-process manager refuses the pair's checkpoints, and every
    worker launched the FEM kernels.  Returns the workers' summed launches."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.parallel.distributed import free_port
    from repro_torch.surrogate import dataset
    from repro_torch.training.checkpoint import CheckpointManager

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = {"parent_allocated_bytes": torch.cuda.memory_allocated(),
              "parent_reserved_bytes": torch.cuda.memory_reserved(),
              "host_mem_available_bytes": _host_mem_available(), "free_disk_bytes": shutil.disk_usage(root).free}
    emit({"campaign_mp_before": before})
    one_ck, one_out = os.path.join(root, "one_ckpt"), os.path.join(root, "one_out")
    mp_ck, mp_out = os.path.join(root, "mp_ckpt"), os.path.join(root, "mp_out")
    cli = ["-m", "repro_torch.launch.campaign", *CAMPAIGN_MP_FLAGS]
    (one,), (one_s,) = _spawn([cli + ["--ckpt-dir", one_ck, "--out", one_out]], root, "one",
                              CAMPAIGN_MP_TIMEOUT_S["one"])
    for name in os.listdir(one_ck):  # its banked rounds are what the pair is held to; the steps free the disk
        if name.startswith("step_"):
            shutil.rmtree(os.path.join(one_ck, name))

    def pair(name, *extra):
        port = free_port()
        return _spawn(
            [cli + ["--ckpt-dir", mp_ck, "--out", mp_out, "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(p), *extra] for p in range(2)],
            root, name, CAMPAIGN_MP_TIMEOUT_S[name])

    stopped, stopped_s = pair("pair_stopped", "--stop-after-steps", "2")
    names = os.listdir(mp_ck)
    on_disk = {s: any(n.endswith(s) for n in names) for s in (".p00", ".p01", ".commit.json")}
    resumed, resumed_s = pair("pair_resumed")
    runs = {"one": [one], "pair_stopped": stopped, "pair_resumed": resumed}
    recs = {k: [_cli_records(o) for o in outs] for k, outs in runs.items()}
    # the one-process run's banked rounds (round r is case r at k 1) against the pair's (round r of
    # process p is lane 2r + p; a lane past the last case pads with a repeat of it)
    n_waves = int(CAMPAIGN_MP_FLAGS[CAMPAIGN_MP_FLAGS.index("--waves") + 1])

    def banked(path):
        with np.load(path) as z:
            return z["vel"], z["iters"], z["health"]

    ref = [banked(os.path.join(one_ck, "rounds", f"round_{r:05d}.npz")) for r in range(n_waves)]
    rounds, same = [], []
    for r in range((n_waves + 1) // 2):
        for p in range(2):
            lane = 2 * r + p
            got = banked(os.path.join(mp_ck, "rounds", f"round_{r:05d}.p{p:02d}.npz"))
            want = ref[min(lane, n_waves - 1)]
            same.append(all(np.array_equal(a, b) for a, b in zip(got, want)))
            rounds.append({"round": r, "process": p, "lane": lane, "padding": lane >= n_waves, "bitwise": same[-1],
                           "committed": os.path.exists(os.path.join(mp_ck, "rounds", f"round_{r:05d}.ok")),
                           "max_abs_v": float(np.abs(got[0]).max()), "iters": got[1].tolist()})
    # the shards: OUT/p00 ∪ OUT/p01 against the one-process shards, matched by wave row
    x, y = dataset.load_shards(mp_out)
    sx, sy = dataset.load_shards(one_out)
    match = [next((j for j, sj in enumerate(sx) if np.array_equal(sj, xi)), -1) for xi in x]
    shards_same = sorted(match) == list(range(n_waves)) and bool(np.array_equal(y, sy[match]))
    per_process = {p: len(dataset.load_shards(os.path.join(mp_out, f"p{p:02d}"))[0]) for p in range(2)}
    try:
        CheckpointManager(mp_ck).restore_latest({"meta": {"round": np.zeros((), np.int64)}})
        refused = "accepted"
    except ValueError as e:
        refused = str(e)
    # launches of each worker (stopped and resumed runs summed); the one-process run's beside them
    worker = [{k: recs["pair_stopped"][p]["launches"][-1][k] + recs["pair_resumed"][p]["launches"][-1][k]
               for k in recs["pair_stopped"][p]["launches"][-1]} for p in range(2)]
    summed = {k: worker[0][k] + worker[1][k] for k in worker[0]}

    def s_step(rs):
        return [c["s_per_step_per_case"] for c in rs["chunk"]]

    one_steps = s_step(recs["one"][0])
    pair_steps = [s_step(recs["pair_stopped"][p]) + s_step(recs["pair_resumed"][p]) for p in range(2)]
    med = lambda v: float(np.median(v))  # noqa: E731
    out = {
        "flags": CAMPAIGN_MP_FLAGS, "before": before, "checkpoint_files": on_disk,
        "one": {"wall_s": one_s, "cases_per_s": n_waves / one_s, "s_per_step_per_case": one_steps,
                "peak_device_bytes": [c.get("peak_device_bytes") for c in recs["one"][0]["chunk"]],
                "checkpoints": recs["one"][0]["checkpoint"], "launches": recs["one"][0]["launches"][-1]},
        "pair": {"wall_s_stopped": stopped_s, "wall_s_resumed": resumed_s,
                 "cases_per_s": n_waves / (max(stopped_s) + max(resumed_s)),
                 "s_per_step_per_case": pair_steps,
                 "summed_case_steps_per_s_over_one": sum(1 / med(v) for v in pair_steps) * med(one_steps),
                 "peak_device_bytes": [[c.get("peak_device_bytes") for k in ("pair_stopped", "pair_resumed")
                                        for c in recs[k][p]["chunk"]] for p in range(2)],
                 "checkpoints": [[dict(c, run=k) for k in ("pair_stopped", "pair_resumed")
                                  for c in recs[k][p]["checkpoint"]] for p in range(2)],
                 "launches": worker},
        "rounds": rounds, "shards_union_equal": shards_same, "shard_rows_per_process": per_process,
        "one_process_refused": refused,
        "printed": {k: [ln for o in outs for ln in o.splitlines()
                        if "[stopped]" in ln or "[resume]" in ln or "[done]" in ln or "[shards]" in ln]
                    for k, outs in runs.items()}}
    emit({"campaign_mp": out})
    require(all(on_disk.values()), f"campaign_mp: the stopped pair's checkpoint files {on_disk}")
    require(all("[stopped]" in o for o in stopped) and all("[resume]" in o for o in resumed),
            "campaign_mp: the pair did not stop and resume")
    require(all(same) and all(r["committed"] for r in rounds), f"campaign_mp: a round differs {rounds}")
    require(all(np.isfinite(r["max_abs_v"]) and r["max_abs_v"] > 0 for r in rounds),
            "campaign_mp: a velocity history is not finite or moved nothing")
    require(shards_same and per_process == {0: (n_waves + 1) // 2, 1: n_waves // 2},
            f"campaign_mp: shards {match} {per_process}")
    require("world size" in refused, f"campaign_mp: one process resumed the pair's checkpoint: {refused}")
    for p, w in enumerate(worker):
        require(all(w[k] > 0 for k in ("multispring", *KSET_KERNELS)), f"campaign_mp: worker {p} launched {w}")
    shutil.rmtree(root, ignore_errors=True)
    return summed


# surrogate_check: the CNN+LSTM (n_c 2, n_lstm 2, kernel 9, latent 16, T 64) and the
# trajectory model (defaults, T 129), card ≡ CPU port; B·T odd in every loss, so no
# MAE sign sum cancels to an exact zero that two summation orders round apart
SURROGATE_CHECK = dict(n_c=2, n_lstm=2, kernel=9, latent=16)
# real FEM shards for surrogate_check's live ≡ post-hoc fit, one case a shard
SURROGATE_CAMPAIGN_FLAGS = ["--waves", "4", "--nt", "16", "--mesh-n", "3x3x3", "--shard-size", "1"]
# surrogate_main: the widest point of the paper's search space (SEARCH_SPACE) with the
# longest latent sequence (n_c 2: T/4 LSTM steps), on the paper's dataset shape
SURROGATE_MAIN = dict(n_c=2, n_lstm=3, kernel=65, latent=1024, lr=1.75e-4)
SURROGATE_DATA = dict(n_waves=100, nt=16000, shard_size=16, fir_taps=64)
SURROGATE_FIT = dict(steps=4, batch=4, val_shards=1, steps_per_shard=2)  # cut from 6 steps for the time limit


def _smooth_pairs(n, nt, seed):
    """Band-limited waves and a saturating response (the CPU tests' data)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, nt)
    x = rng.uniform(0.5, 1.5, (n, 1, 3)) * np.sin(t[None, :, None] + rng.uniform(0, 2 * np.pi, (n, 1, 3)))
    return x.astype(np.float32), np.tanh(1.5 * x).astype(np.float32)


def fir_response(x, taps, seed):
    """A seeded causal FIR response ``y[t] = Σ_k h_k x[t−k]`` (``h_k`` a 3×3
    mixing of the components, decaying with k): the stand-in target of
    surrogate_main, where 16,000-step FEM responses do not fit the run."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h = rng.normal(size=(taps, 3, 3)) * np.exp(-np.arange(taps) / (taps / 4))[:, None, None] / np.sqrt(taps / 4)
    y = np.zeros(x.shape, np.float64)
    for k in range(taps):
        y[:, k:] += x[:, : x.shape[1] - k] @ h[k]
    return y.astype(np.float32)


def surrogate_check(root):
    """The surrogates on the card against the port on the CPU, at small
    widths: ``apply`` (both scans for the trajectory model), ``predict`` at
    an odd B and T, and ``mae_loss`` with its gradient per leaf; 20 steps of
    ``fit`` of each family on both; live ``fit_stream`` over a
    ``ShardStream.from_cache`` that the campaign CLI fills on the card in
    another thread against post-hoc ``fit_shards`` on the same shards; a
    surrogate and a trajectory model saved on the card load on the CPU
    bitwise."""
    import contextlib
    import io
    import shutil
    import threading

    import numpy as np
    import torch

    from repro_torch.core.stream import leaves_in_insertion_order, tree_map
    from repro_torch.launch import campaign as cli
    from repro_torch.surrogate import dataset, model, seqmodel, train, trajectory

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    shutil.rmtree(root, ignore_errors=True)
    rows = {}

    def rel(a, b):  # a on the card, b (the CPU port) the reference
        a, b = a.detach().cpu(), b.detach().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def loss_and_grads(mod, params, cfg, x, y):
        ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        with model.exact_convs():
            loss = mod.mae_loss(ps, cfg, x, y)
            return float(loss.detach()), torch.autograd.grad(loss, leaves_in_insertion_order(ps))

    rng = np.random.default_rng(11)
    cnn, traj = model.SurrogateConfig(**SURROGATE_CHECK), seqmodel.TrajectoryConfig()
    for name, mod, cfg, T, T_odd, scans in (("cnn", model, cnn, 64, 37, (None,)),
                                            ("trajectory", seqmodel, traj, 129, 101, seqmodel.SCANS)):
        p_cpu = mod.init_params(cfg, torch.Generator().manual_seed(0), device=cpu)
        p_card = tree_map(lambda t: t.to(dev), p_cpu)
        x, y = (torch.tensor(rng.normal(size=(3, T, 3)), dtype=torch.float32) for _ in range(2))
        row = {}
        for scan in scans:
            kw = {} if scan is None else {"scan": scan}
            with torch.no_grad():
                row["apply" + (f"_{scan}" if scan else "")] = rel(mod.apply(p_card, cfg, x.to(dev), **kw),
                                                                   mod.apply(p_cpu, cfg, x, **kw))
        xo = rng.normal(size=(3, T_odd, 3)).astype(np.float32)
        row["predict"] = rel(mod.predict(p_card, cfg, xo, device=dev), mod.predict(p_cpu, cfg, xo, device=cpu))
        l_card, g_card = loss_and_grads(mod, p_card, cfg, x.to(dev), y.to(dev))
        l_cpu, g_cpu = loss_and_grads(mod, p_cpu, cfg, x, y)
        row["loss"] = abs(l_card - l_cpu) / abs(l_cpu)
        row["grad_per_leaf"] = max(rel(a, b) for a, b in zip(g_card, g_cpu))
        rows[name] = {"T": T, "T_odd": T_odd, "max_rel_err": row, "tol": {"forward": 1e-5, "grad_per_leaf": 1e-4}}
        require(all(v <= 1e-5 for k, v in row.items() if k != "grad_per_leaf"), f"{name}: card ≠ CPU: {row}")
        require(row["grad_per_leaf"] <= 1e-4, f"{name}: gradients card ≠ CPU: {row}")

    # 20 steps of fit on the card and on the CPU: the same loss history.  Each
    # at a rate where training is well conditioned (on the CPU alone, a 1e-7
    # change of the init moves these histories by ≤ 3e-7; the trajectory
    # model at lr 1e-2 would move by 5e-4, and compare nothing of the port)
    x_fit, y_fit = _smooth_pairs(8, 33, seed=0)
    for name, fit, cfg in (("fit_cnn", train.fit, dataclasses.replace(cnn, lr=3e-3)),
                           ("fit_trajectory", trajectory.fit_trajectory, traj)):
        t0 = time.perf_counter()
        _, card = fit(cfg, x_fit, y_fit, steps=20, batch=3, seed=0, device=dev)
        card_s = time.perf_counter() - t0
        _, host = fit(cfg, x_fit, y_fit, steps=20, batch=3, seed=0, device=cpu)
        worst = max(abs(a - b) / abs(b) for ha, hb in zip(card["history"], host["history"])
                    for a, b in zip(ha[1:], hb[1:]))
        worst = max(worst, abs(card["val_mae"] - host["val_mae"]) / host["val_mae"])
        rows[name] = {"history_card": card["history"], "history_cpu": host["history"], "max_rel_err": worst,
                      "tol": 1e-4, "card_s": card_s}
        require([h[0] for h in card["history"]] == [h[0] for h in host["history"]] and worst <= 1e-4,
                f"{name}: card ≠ CPU over 20 steps: {worst}")

    # real FEM shards from the campaign CLI on the card, consumed while they are written
    cache = os.path.join(root, "cache")
    gen = {}

    def generate():
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                gen["rc"] = cli.main([*SURROGATE_CAMPAIGN_FLAGS, "--out", os.path.join(cache, "campaign")], result=gen)
        except BaseException as e:  # re-raised on the main thread after the join
            gen["error"] = e
        gen["printed"] = buf.getvalue()

    fit_kw = dict(steps=8, batch=2, val_shards=1, steps_per_shard=2, seed=0, device=dev)
    writer = threading.Thread(target=generate, daemon=True)
    t0 = time.perf_counter()
    writer.start()
    stream = dataset.ShardStream.from_cache(cache, ["campaign"], poll_s=0.05, timeout_s=300.0)
    try:
        p_live, live = train.fit_stream(cnn, stream, **fit_kw)
    finally:
        writer.join(timeout=300.0)
    live_s = time.perf_counter() - t0
    require(not writer.is_alive(), "the campaign CLI did not finish")
    if "error" in gen:
        raise gen["error"]
    require(gen.get("rc") == 0, f"the campaign CLI exited {gen.get('rc')}")
    t0 = time.perf_counter()
    p_post, post = train.fit_shards(cnn, cache, order=["campaign"], **fit_kw)
    post_s = time.perf_counter() - t0
    pairs = list(zip(leaves_in_insertion_order(p_live), leaves_in_insertion_order(p_post)))
    leaf_err = max(float((a - b).abs().max()) for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    rows["live_vs_posthoc"] = {
        "shards": live["n_shards"], "rows": int(len(gen["waves"])), "nt": int(gen["waves"].shape[1]),
        "stream_wait_s": live["stream_wait_s"], "val_mae": [live["val_mae"], post["val_mae"]],
        "max_abs_param_diff": leaf_err, "bitwise": bitwise, "live_s": live_s, "posthoc_s": post_s,
        "printed": [ln for ln in gen["printed"].splitlines() if "[done]" in ln or "[shards]" in ln]}
    require(live["n_shards"] == post["n_shards"] == len(gen["waves"]) >= 2, f"shards: {live['n_shards']}")
    require(live["stream_wait_s"] > 0.0, "the stream never waited on the campaign")
    require(abs(live["val_mae"] - post["val_mae"]) <= 1e-6 and leaf_err <= 1e-6,
            f"live fit_stream ≠ post-hoc fit_shards: {live['val_mae']} vs {post['val_mae']}, params {leaf_err}")

    # saved on the card, loaded on the CPU: bitwise
    loaded = {}
    for name, save, load, cfg, params in (
            ("surrogate", train.save_surrogate, train.load_surrogate, cnn, p_post),
            ("trajectory", trajectory.save_trajectory, trajectory.load_trajectory, traj,
             seqmodel.init_params(traj, torch.Generator().manual_seed(3), device=dev))):
        d = os.path.join(root, f"ckpt_{name}")
        save(d, cfg, params, scale=post["scale"], step=8)
        cfg2, members, scale, step = load(d, device=cpu)
        same = all(b.device == cpu and torch.equal(a.cpu(), b) for a, b in zip(leaves_in_insertion_order(params),
                                                                               leaves_in_insertion_order(members[0])))
        loaded[name] = same
        require(same and cfg2 == cfg and scale == post["scale"] and step == 8, f"{name}: card → CPU not bitwise")
    rows["saved_on_card_loaded_on_cpu_bitwise"] = loaded
    emit({"check": "surrogate", **rows})


def _timed(mod, marks):
    """``mod`` (a surrogate module) for ``fit_*``'s ``model=``, with the host
    clock read, after a synchronise, as each Adam step's loss starts and
    around each validation ``predict``: the steps' and validations' seconds
    on the path a user runs, at the cost of one wait per step (each step's
    batch copy to the card waits for the card already)."""
    import torch

    def mark(kind):
        torch.cuda.synchronize()
        marks.append((kind, time.perf_counter()))

    class Timed:
        init_params = staticmethod(mod.init_params)

        @staticmethod
        def mae_loss(*a, **k):
            mark("step")
            return mod.mae_loss(*a, **k)

        @staticmethod
        def predict(*a, **k):
            mark("val")
            out = mod.predict(*a, **k)
            mark("val_end")
            return out

    return Timed


def _step_and_val_seconds(marks, end):
    """Each Adam step's seconds (from its loss to the next mark) and each
    validation's, from ``_timed``'s marks."""
    steps, vals = [], []
    for (kind, t), (_, t_next) in zip(marks, marks[1:] + [("end", end)]):
        if kind == "step":
            steps.append(t_next - t)
        elif kind == "val":
            vals.append(t_next - t)
    return steps, vals


def surrogate_main(root):
    """The CNN+LSTM at the widest point of the paper's search space (latent
    1024, n_lstm 3, kernel 65, n_c 2) trained through ``fit_shards`` on the
    paper's dataset shape (100 waves × 16,000 samples × 3, shards of 16)
    on the card, 4 Adam steps; the trajectory surrogate (defaults) through
    ``fit_trajectory_shards`` on the same shards, 4 steps, then ``step``
    over 512 samples of one wave against ``apply(scan="seq")``.  From the
    path itself (``_timed``): s per Adam step (the first, cold, and the
    warm ones) and s per validation ``predict`` (16 waves); s of each
    ``fit_*_shards``, its peak device bytes, and the device's busy share
    over one more warm CNN step under ``torch.profiler`` (its raw kernel
    records: building its event tables takes a minute for ~350k kernels).
    Requires that no TPU kernel launched on the path; returns the trained
    models, on the host, with the shard directory (phase ``serve_main``
    serves them)."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    from repro_torch import kernels
    from repro_torch.core.stream import leaves_in_insertion_order, tree_map
    from repro_torch.surrogate import dataset, model, seqmodel, train, trajectory

    dev = torch.device("cuda")
    shutil.rmtree(root, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ecfg = dataset.EnsembleConfig(n_waves=SURROGATE_DATA["n_waves"], nt=SURROGATE_DATA["nt"], seed=0)
    x = dataset.random_band_limited_waves(ecfg).astype(np.float32)
    y = fir_response(x, SURROGATE_DATA["fir_taps"], seed=1)
    shards = os.path.join(root, "shards")
    dataset.save_shards(shards, x, y, shard_size=SURROGATE_DATA["shard_size"])
    trained = {"shards": shards}
    out = {"data": {**SURROGATE_DATA, "shards": dataset.shard_meta(shards)["shards"],
                    "seconds": time.perf_counter() - t0}}

    for name, mod, cfg, fit_shards in (
            ("cnn", model, model.SurrogateConfig(**SURROGATE_MAIN), train.fit_shards),
            ("trajectory", seqmodel, seqmodel.TrajectoryConfig(), trajectory.fit_trajectory_shards)):
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = []
        t0 = time.perf_counter()
        if name == "cnn":
            params, info = fit_shards(cfg, shards, **SURROGATE_FIT, model=_timed(mod, marks), device=dev)
        else:  # fit_trajectory_shards fixes its model: its steps are timed in a second, identical run
            params, info = fit_shards(cfg, shards, **SURROGATE_FIT, device=dev)
        torch.cuda.synchronize()
        end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() - resident
        if name == "trajectory":
            t1 = time.perf_counter()
            _, again = train.fit_shards(cfg, shards, **SURROGATE_FIT, model=_timed(mod, marks), device=dev)
            torch.cuda.synchronize()
            require(again["history"] == info["history"], "fit_trajectory_shards is not deterministic")
        steps, vals = _step_and_val_seconds(marks, time.perf_counter())
        row = {"config": dataclasses.asdict(cfg), "params": sum(t.numel() for t in leaves_in_insertion_order(params)),
               "adam_step_s": {"first": steps[0], "warm": steps[1:]},
               "predict_s": {"first": vals[0], "warm": vals[1:], "batch": SURROGATE_DATA["shard_size"],
                             "nt": SURROGATE_DATA["nt"]},
               "fit_shards_s": end - t0, "history": info["history"], "val_mae": info["val_mae"],
               "n_shards": info["n_shards"], "peak_device_bytes": peak}
        if name == "trajectory":
            row["timed_rerun_s"] = time.perf_counter() - t1
        require(len(steps) == SURROGATE_FIT["steps"] and info["n_shards"] == out["data"]["shards"],
                f"{name}: {len(steps)} steps over {info['n_shards']} shards")
        require(np.isfinite(info["val_mae"]) and all(np.isfinite(h[1:]).all() for h in info["history"]),
                f"{name}: non-finite loss {info['history']}")
        if name == "cnn":  # the device's busy share over one more warm step
            step_fn, m, v = train._make_adam(cfg, params, mod.mae_loss)
            scale = np.float32(info["scale"])
            xb, yb = torch.from_numpy(x[16:20]).to(dev), torch.from_numpy(y[16:20] / scale).to(dev)
            torch.cuda.synchronize()  # fit_shards has run these shapes: the step is warm
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step_fn(params, m, v, 0, xb, yb)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            on_card = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
            by_name = {}
            for e in on_card:
                by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns() / 1e9
            busy = sum(by_name.values())
            row["profiled_step"] = {
                "wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall, "device_ops": len(on_card),
                "top_device_ops_s": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])}
            require(busy > 0, "the profiler saw no device time")
            del step_fn, m, v, xb, yb, prof, on_card
        else:  # O(1)-state streaming against the sequential path
            xs = torch.from_numpy(x[16:17, :512]).to(dev)
            with torch.no_grad():
                full = seqmodel.apply(params, cfg, xs, scan="seq")
                state, outs = seqmodel.init_state(cfg, 1, device=dev), []
                for t in range(xs.shape[1]):
                    y_t, state = seqmodel.step(params, cfg, xs[:, t], state)
                    outs.append(y_t)
                streamed = torch.stack(outs, 1)
            # held to 1e-5·max|y|: GEMMs over [1, H] and [512, H] round apart by a few
            # ulps of outputs near 15, and the reference's own step misses atol 1e-5
            # at these widths too (2.1e-5 at max|y| 28 from its init, on the CPU)
            err, top = float((streamed - full).abs().max()), float(full.abs().max())
            row["step_vs_seq"] = {"samples": xs.shape[1], "max_abs_err": err, "max_abs_output": top,
                                  "tol": "1e-5·max|y|", "within_atol_1e-5": err <= 1e-5,
                                  "bitwise": bool(torch.equal(streamed, full))}
            require(err <= 1e-5 * top, f"step ≠ apply(scan='seq') over 512 samples: {err} (max|y| {top})")
        out[name] = row
        trained[name] = (cfg, tree_map(lambda t: t.cpu(), params), info["scale"])  # phase serve_main serves them
        del params
    launches = kernels.launch_counts()
    out["tpu_kernel_launches"] = launches
    emit({"surrogate_main": out})
    require(sum(launches.values()) == 0, f"a TPU kernel ran on the surrogate path: {launches}")
    return trained


def surrogate_timing(cuda_ms):
    """The surrogates' recurrences, which the JAX package runs outside
    Pallas, against a library or a plain form on the card: the port's LSTM
    layer (a python loop over time) against ``torch.nn.LSTM`` (cuDNN, the
    forget +1 folded into ``bias_ih``) at B 4, T 4,000, H 1,024, forward
    and forward + backward; the doubling scan ``ssm_scan`` against the loop
    ``ssm_scan_ref``, alone at B 8, H 32, N 8 and inside the trajectory
    model's ``apply``, at T ∈ {256, 1,024, 4,096, 16,000}.  Nothing on the
    main path calls cuDNN's LSTM: it is the yardstick of a later kernel."""
    import torch

    from repro_torch.surrogate import model, seqmodel

    dev = torch.device("cuda")
    rows = []
    B, T, H = 4, 4000, 1024
    g = torch.Generator(device=dev).manual_seed(5)
    p = {"wx": torch.randn((H, 4 * H), device=dev, generator=g) * H ** -0.5,
         "wh": torch.randn((H, 4 * H), device=dev, generator=g) * H ** -0.5,
         "b": torch.randn((4 * H,), device=dev, generator=g) * 0.1}
    x = torch.randn((B, T, H), device=dev, generator=g)
    lib = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(p["wx"].T)
        lib.weight_hh_l0.copy_(p["wh"].T)
        lib.bias_ih_l0.copy_(p["b"])
        lib.bias_ih_l0[H:2 * H] += 1.0  # the reference's sigmoid(f + 1)
        lib.bias_hh_l0.zero_()
        ours, theirs = model._lstm_layer(p, x), lib(x)[0]
        err = float((ours - theirs).abs().max())
        fwd_ms = cuda_ms(lambda: model._lstm_layer(p, x), 2)
        lib_fwd_ms = cuda_ms(lambda: lib(x), 10)
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)

    def ours_fb():
        return torch.autograd.grad(model._lstm_layer(pg, xg).sum(), [xg, *pg.values()])

    def lib_fb():
        return torch.autograd.grad(lib(xg)[0].sum(), [xg, *lib.parameters()])

    fb_ms, lib_fb_ms = cuda_ms(ours_fb, 2), cuda_ms(lib_fb, 10)
    flops = 2 * B * T * (H + H) * 4 * H  # the two products a step; the gates' elementwise work aside
    rows.append({"part": "lstm_layer", "B": B, "T": T, "H": H, "max_abs_diff_vs_cudnn": err,
                 "forward_ms": fwd_ms, "cudnn_forward_ms": lib_fwd_ms,
                 "forward_backward_ms": fb_ms, "cudnn_forward_backward_ms": lib_fb_ms,
                 "forward_bound_ms": flops / PEAK_FLOPS["torch.float32"] * 1e3,
                 "forward_backward_bound_ms": 3 * flops / PEAK_FLOPS["torch.float32"] * 1e3})
    require(err <= 1e-4, f"the LSTM loop disagrees with cuDNN's LSTM: {err}")
    del p, pg, x, xg, lib, ours, theirs
    cfg = seqmodel.TrajectoryConfig()
    params = seqmodel.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    for T in (256, 1024, 4096, 16000):
        a = torch.rand((8, T, cfg.latent, cfg.state), device=dev, generator=g) * 0.899 + 0.1
        b = torch.randn((8, T, cfg.latent, cfg.state), device=dev, generator=g)
        xw = torch.randn((8, T, 3), device=dev, generator=g)
        with torch.no_grad():
            h, h_ref = seqmodel.ssm_scan(a, b), seqmodel.ssm_scan_ref(a, b)
            scan_err = float((h - h_ref).abs().max() / h_ref.abs().max())
            reps = max(1, 4096 // T)
            row = {"part": "ssm_scan", "B": 8, "T": T, "H": cfg.latent, "N": cfg.state, "max_rel_diff": scan_err,
                   "assoc_ms": cuda_ms(lambda: seqmodel.ssm_scan(a, b), 4 * reps),
                   "seq_ms": cuda_ms(lambda: seqmodel.ssm_scan_ref(a, b), reps),
                   "apply_assoc_ms": cuda_ms(lambda: seqmodel.apply(params, cfg, xw, scan="assoc"), 4 * reps),
                   "apply_seq_ms": cuda_ms(lambda: seqmodel.apply(params, cfg, xw, scan="seq"), reps)}
        row["assoc_speedup"] = row["seq_ms"] / row["assoc_ms"]
        row["apply_assoc_speedup"] = row["apply_seq_ms"] / row["apply_assoc_ms"]
        rows.append(row)
        require(scan_err <= 1e-5, f"ssm_scan ≠ ssm_scan_ref at T {T}: {scan_err}")
        del a, b, h, h_ref
    return rows


# serve_check: the small surrogate ensembles (two members each) and reduced qwen3 (fp32)
SERVE_CHECK = dict(surrogate=dict(n_c=2, n_lstm=1, latent=8), trajectory=dict(latent=8, state=4, n_layers=1,
                                                                               obs_every=2), nt=64)
# the serve CLI's surrogate rehearsal: four 4-case scenarios, two a batch (flush on full,
# whatever the timing), the second batch's infer failing once (split-retry), a repeat
SERVE_SWEEP = json.dumps({"base": {"n_cases": 4, "nt": 64},
                          "axes": {"wave.family": ["ricker", "chirp", "band_noise", "pulse_train"]}})
SERVE_CLI_SURROGATE = ["--sweep", SERVE_SWEEP, "--max-batch", "8", "--max-wait-ms", "2000", "--repeat", "2",
                       "--feedback-threshold", "0", "--inject", "fail_infer_every_n=2,limit=1",
                       "--breaker-threshold", "2"]
SERVE_CLI_DECODE = ["--engine", "decode", "--arch", "qwen3-1.7b", "--reduced", "--batch", "4", "--prompt-len", "16",
                    "--new", "8", "--max-batch", "4", "--repeat", "2"]
SERVE_CLI_GEMMA2 = ["--engine", "decode", "--arch", "gemma2-2b", "--reduced", "--batch", "4", "--prompt-len", "16",
                    "--new", "8", "--max-batch", "4", "--repeat", "2"]
SERVE_CLI_MAMBA2 = ["--engine", "decode", "--arch", "mamba2-780m", "--reduced", "--batch", "4", "--prompt-len", "16",
                    "--new", "8", "--max-batch", "4", "--repeat", "2"]
HEALTH_KEYS = ("batches", "cache_hits", "engine_failures", "split_retries", "poison_requests", "nonfinite_outputs",
               "deadline_expired", "breaker_trips", "breaker_rejected", "breaker_state")
# serve_main: 16 requests of one shard wave each through max_batch 8 (two batches), then
# the same 16 again (the cache's), then one batch of 8 one-case scenarios at the waves'
# 16,000 samples, each request carrying its scenario for the feedback log; decode: 8
# prompts of 4,096 tokens in buckets of 4, 32 new tokens; the serve CLI at qwen3-1.7b's
# full width on a shorter prompt
SERVE_MAIN = dict(requests=16, max_batch=8, decode_requests=8, decode_bucket=4, prompt=4096, new_tokens=32,
                  kv_npart=4)
SERVE_MAIN_SWEEP = json.dumps({"base": {"n_cases": 1, "nt": 16000},
                               "axes": {"wave.family": ["ricker", "chirp", "band_noise", "pulse_train"],
                                        "seed": [0, 1]}})
SERVE_CLI_FULL = ["--engine", "decode", "--arch", "qwen3-1.7b", "--full", "--batch", "4", "--prompt-len", "512",
                  "--new", "8", "--max-batch", "4", "--repeat", "2"]


def _serve_cli(argv, result):
    """``launch.serve.main(argv)`` in-process, its output captured: the
    ``[serve]`` report lines it printed."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(argv, result)
    require(rc == 0, f"serve CLI {argv} exited {rc}: {buf.getvalue()}")
    return [ln for ln in buf.getvalue().splitlines() if ln.startswith("[serve]")]


def _feedback_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def serve_check(root, dev, keep_feedback=None):
    """The serving tier small, on the card against the port on the CPU: the
    surrogate and trajectory engines (two members each: y within
    1e-5·max|y|, score within 1e-5, equal signatures), batched ≡
    per-request bitwise, ``ShardedEngine`` ≡ its engine bitwise with its
    signature, a repeat served from the cache with no ``infer``;
    ``DecodeEngine`` on reduced qwen3 (fp32: the fp32 flash kernel) with the
    CPU's tokens, a single prompt padded to the bucket giving its batched
    row, and on reduced gemma2, mixtral and deepseek-v2 with the CPU's tokens
    and signatures; ``launch.serve.main`` for all three engines (decode also
    as ``--arch gemma2-2b`` and ``--arch mamba2-780m``; ``--arch
    whisper-small`` exits 2, naming the frames it needs), the surrogate one
    with a repeat, feedback at threshold 0 and an injected failure whose
    split-retry and breaker counts and feedback records are the CPU run's.
    The card's feedback log is copied to ``keep_feedback`` (``plan_check``
    sweeps it).  Returns the phase's flash launches by kernel."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer as T
    from repro_torch.serving import (DecodeEngine, MicroBatcher, ResultCache, ShardedEngine, SurrogateEngine,
                                     TrajectoryEngine)
    from repro_torch.surrogate import model, seqmodel, train, trajectory

    cpu = torch.device("cpu")
    shutil.rmtree(root, ignore_errors=True)
    kernels.reset_launch_counts()  # counts of this phase's paths: the fp32 flash kernel's
    rows = {}
    rng = np.random.default_rng(21)
    x = rng.standard_normal((5, SERVE_CHECK["nt"], 3)).astype(np.float32)
    ckpts = {}
    for name, mod, cfg, cls, save in (
            ("surrogate", model, model.SurrogateConfig(**SERVE_CHECK["surrogate"]), SurrogateEngine,
             train.save_surrogate),
            ("trajectory", seqmodel, seqmodel.TrajectoryConfig(**SERVE_CHECK["trajectory"]), TrajectoryEngine,
             trajectory.save_trajectory)):
        members = [mod.init_params(cfg, torch.Generator().manual_seed(s), device=cpu) for s in (0, 1)]
        ckpts[name] = os.path.join(root, f"ckpt_{name}")
        save(ckpts[name], cfg, members, scale=2.0, step=3)
        card = cls.from_checkpoint(ckpts[name], buckets=(8,), nt=SERVE_CHECK["nt"], device=dev)
        host = cls(cfg, members, scale=2.0, buckets=(8,), nt=SERVE_CHECK["nt"], device=cpu)
        got, want = card.infer(x), host.infer(x)
        y_err = float(np.abs(got.y - want.y).max() / np.abs(want.y).max())
        s_err = float(np.abs(got.score - want.score).max())
        solos = [card.infer(x[i:i + 1]) for i in range(len(x))]
        solo_same = all(np.array_equal(r.y[0], got.y[i]) and r.score[0] == got.score[i] for i, r in enumerate(solos))
        sharded = ShardedEngine(card)
        sh = sharded.infer(x)
        sharded_same = (np.array_equal(sh.y, got.y) and np.array_equal(sh.score, got.score)
                        and sharded.signature() == card.signature())
        with MicroBatcher(card, max_batch=8, max_wait_ms=2.0, cache=ResultCache(8)) as mb:
            r1 = mb.submit("k", x[:1]).result(timeout=60)
            r2 = mb.submit("k", x[:1]).result(timeout=60)
            infers = mb.stats()["batches"]
        cached = r2.cached and infers == 1 and np.array_equal(r1.y, r2.y)
        rows[name] = {"max_rel_err_y": y_err, "max_abs_err_score": s_err, "tol": 1e-5,
                      "signature_equal": card.signature() == host.signature(),
                      "batched_vs_per_request_bitwise": solo_same, "sharded_bitwise_same_signature": sharded_same,
                      "repeat_from_cache_without_infer": cached, "y_host_numpy": isinstance(got.y, np.ndarray)}
        require(y_err <= 1e-5 and s_err <= 1e-5, f"{name} engine: card ≠ CPU: {rows[name]}")
        require(rows[name]["signature_equal"], f"{name} engine: card and CPU signatures differ")
        require(solo_same and sharded_same and cached and rows[name]["y_host_numpy"], f"{name}: {rows[name]}")

    # DecodeEngine on reduced qwen3 (fp32), card against CPU
    cfg = ARCHS["qwen3-1.7b"].reduced()
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = rng.integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    kw = dict(n_new=6, prompt_len=8, buckets=(4,))
    card, host = DecodeEngine(cfg, p_cpu, device=dev, **kw), DecodeEngine(cfg, p_cpu, device=cpu, **kw)
    before = kernels.instance_counts()
    got = card.infer(prompts)
    one = {n: c - before[n] for n, c in kernels.instance_counts().items()}
    solo = card.infer(prompts[:1])
    rows["decode"] = {"arch": cfg.name, "dtype": cfg.dtype, "tokens_equal_cpu": bool(np.array_equal(
                          got.y, host.infer(prompts).y)),
                      "solo_padded_equals_batched_row": bool(np.array_equal(solo.y[0], got.y[0])),
                      "signature_equal": card.signature() == host.signature(), "flash_launches_one_batch": one}
    require(rows["decode"]["tokens_equal_cpu"], "DecodeEngine's tokens on the card differ from the CPU's")
    require(rows["decode"]["solo_padded_equals_batched_row"], "a padded single prompt ≠ its batched row")
    require(one == {"flash_attention_bf16": 0, "flash_attention_f32": cfg.n_layers},
            f"a reduced fp32 decode batch made flash launches {one}")
    del card, host
    # DecodeEngine on reduced gemma2, mixtral and deepseek-v2 (fp32), card against CPU
    for name in FAMILY_NAMES:
        fcfg = ARCHS[name].reduced()
        fp = T.init_params(fcfg, torch.Generator().manual_seed(0), "cpu")
        fprompts = rng.integers(0, fcfg.vocab_size, (3, 8)).astype(np.int32)
        card, host = DecodeEngine(fcfg, fp, device=dev, **kw), DecodeEngine(fcfg, fp, device=cpu, **kw)
        before = kernels.instance_counts()
        got = card.infer(fprompts)
        one = {n: c - before[n] for n, c in kernels.instance_counts().items()}
        rows[f"decode_{name}"] = {"arch": fcfg.name, "dtype": fcfg.dtype,
                                  "tokens_equal_cpu": bool(np.array_equal(got.y, host.infer(fprompts).y)),
                                  "signature_equal": card.signature() == host.signature(),
                                  "flash_launches_one_batch": one}
        require(rows[f"decode_{name}"]["tokens_equal_cpu"], f"{name} DecodeEngine's tokens on the card ≠ the CPU's")
        require(rows[f"decode_{name}"]["signature_equal"], f"{name} DecodeEngine: card and CPU signatures differ")
        require(one == {"flash_attention_bf16": 0, "flash_attention_f32": fcfg.n_layers},
                f"a reduced fp32 {name} decode batch made flash launches {one}")
        del card, host, fp

    # the serve CLI in-process, all three engines; the surrogate one also on the CPU
    cli = {}
    for where, device_flag in (("card", []), ("cpu", ["--device", "cpu"])):
        res = {}
        fb = os.path.join(root, f"feedback_{where}.jsonl")
        lines = _serve_cli([*device_flag, "--engine", "surrogate", "--ckpt", ckpts["surrogate"], *SERVE_CLI_SURROGATE,
                            "--feedback-out", fb], res)
        cli[where] = {"stats": {k: res["stats"][k] for k in HEALTH_KEYS}, "records": _feedback_records(fb),
                      "plan": res.get("feedback_plan"), "lines": lines,
                      "failed": [name for _, name, r in res["served"] if r is None]}
    a, b = cli["card"], cli["cpu"]
    same_records = [{k: r[k] for k in ("signature", "key", "scenario")} for r in a["records"]] == \
        [{k: r[k] for k in ("signature", "key", "scenario")} for r in b["records"]]
    score_err = max(abs(r["score"] - q["score"]) for r, q in zip(a["records"], b["records"]))
    rows["cli_surrogate"] = {"card": a["stats"], "cpu": b["stats"], "feedback_records": len(a["records"]),
                             "records_equal_cpu": same_records, "max_score_diff": score_err,
                             "plan_scenarios": a["plan"].n_scenarios if a["plan"] else 0, "report": a["lines"]}
    require(a["stats"] == b["stats"], f"serve CLI health counts card {a['stats']} ≠ CPU {b['stats']}")
    require(a["stats"]["split_retries"] == 1 and a["stats"]["engine_failures"] == 1 and not a["failed"],
            f"the injected failure was not isolated by a split-retry: {a['stats']}, failed {a['failed']}")
    require(a["stats"]["cache_hits"] == 4, f"round 2 was not all cache hits: {a['stats']}")
    require(same_records and score_err <= 1e-5 and len(a["records"]) == 4, "feedback records card ≠ CPU")
    require(rows["cli_surrogate"]["plan_scenarios"] == 4 and any("feedback plan" in ln for ln in a["lines"]),
            "the feedback plan was not printed")
    res = {}
    lines = _serve_cli(["--engine", "trajectory", "--ckpt", ckpts["trajectory"], "--repeat", "2"], res)
    rows["cli_trajectory"] = {"stats": {k: res["stats"][k] for k in HEALTH_KEYS}, "report": lines}
    require(res["stats"]["cache_hits"] == 1 and res["stats"]["batches"] == 1, f"trajectory CLI: {res['stats']}")
    res = {}
    before = kernels.instance_counts()
    lines = _serve_cli(SERVE_CLI_DECODE, res)
    cli_launches = {n: c - before[n] for n, c in kernels.instance_counts().items()}
    rows["cli_decode"] = {"stats": {k: res["stats"][k] for k in HEALTH_KEYS}, "report": lines,
                          "flash_launches": cli_launches}
    require(res["stats"]["cache_hits"] == 4 and cli_launches["flash_attention_f32"] == 2 * cfg.n_layers,
            f"decode CLI: {res['stats']}, launches {cli_launches}")  # warm-up + one batch
    require(res["tokens"].shape == (4, 8), f"decode CLI tokens {res['tokens'].shape}")
    res = {}
    before = kernels.instance_counts()
    lines = _serve_cli(SERVE_CLI_GEMMA2, res)
    cli_launches = {n: c - before[n] for n, c in kernels.instance_counts().items()}
    rows["cli_decode_gemma2"] = {"stats": {k: res["stats"][k] for k in HEALTH_KEYS}, "report": lines,
                                 "flash_launches": cli_launches}
    g2 = ARCHS["gemma2-2b"].reduced()
    require(res["stats"]["cache_hits"] == 4 and cli_launches["flash_attention_f32"] == 2 * g2.n_layers,
            f"gemma2 decode CLI: {res['stats']}, launches {cli_launches}")  # warm-up + one batch
    require(res["tokens"].shape == (4, 8), f"gemma2 decode CLI tokens {res['tokens'].shape}")
    res = {}
    before = kernels.instance_counts()
    lines = _serve_cli(SERVE_CLI_MAMBA2, res)
    cli_launches = {n: c - before[n] for n, c in kernels.instance_counts().items()}
    rows["cli_decode_mamba2"] = {"stats": {k: res["stats"][k] for k in HEALTH_KEYS}, "report": lines,
                                 "flash_launches": cli_launches}
    require(res["stats"]["cache_hits"] == 4 and not any(cli_launches.values()),
            f"mamba2 decode CLI: {res['stats']}, launches {cli_launches}")  # no attention: no flash launch
    require(res["tokens"].shape == (4, 8), f"mamba2 decode CLI tokens {res['tokens'].shape}")
    # whisper needs frames beside its tokens: the decode CLI refuses it with exit 2, naming why
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = serve_cli.main([*SERVE_CLI_MAMBA2[:3], "whisper-small", *SERVE_CLI_MAMBA2[4:]], {})
    rows["cli_decode_whisper"] = {"exit": rc, "stderr": err.getvalue().strip()}
    require(rc == 2 and "frames" in err.getvalue(), f"the decode CLI on whisper-small: {rows['cli_decode_whisper']}")
    launches = kernels.instance_counts()
    rows["flash_launches"] = launches
    emit({"serve_check": rows})
    require(launches["flash_attention_bf16"] == 0, f"serve_check launched the bf16 flash kernel: {launches}")
    if keep_feedback:
        shutil.copyfile(os.path.join(root, "feedback_card.jsonl"), keep_feedback)
    shutil.rmtree(root, ignore_errors=True)
    return launches


def _serve_round(batcher, requests):
    """Submit every ``(key, x)`` or ``(key, x, meta)`` and wait for all: each
    future must resolve.  Returns the results and the round's seconds."""
    t0 = time.perf_counter()
    futs = [batcher.submit(*req) for req in requests]
    out = [f.result() for f in futs]
    return out, time.perf_counter() - t0


def serve_main(root, dev, trained, lm_params, qwen):
    """The serving tier at full width on the card, through ``MicroBatcher``:
    (a) the CNN+LSTM ensemble (surrogate_main's trained member and a second
    from ``init_params``) saved with ``save_surrogate`` and served by
    ``SurrogateEngine.from_checkpoint(buckets=(8,), nt=16,000)`` on 16 shard
    waves, then again from the cache, then 8 sweep scenarios at 16,000
    samples whose requests carry their scenarios, all routed by the
    ``FeedbackLog`` (threshold 0) and read back by ``load_feedback`` and
    ``feedback_plan``; (b) the trajectory surrogate the same way; (c)
    ``DecodeEngine`` over lm_main's qwen3-1.7b (28 layers, bf16 compute),
    8 prompts of 4,096 tokens in buckets of 4, 32 new tokens: exactly 28
    bf16 flash launches a batch (its prefill), none of the fp32 kernel, a
    single prompt ≡ its batched row, offloaded KV ≡ resident tokens; then
    the serve CLI at full width.  Per server: requests/s and
    rows/s, infer ms per batch (first, warm), the batcher's wait ms, cache
    hits, peak device bytes above what was resident; tokens/s for decode.
    Returns the bf16 flash launches of the path."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.scenario import planner
    from repro_torch.serving import DecodeEngine, FeedbackLog, MicroBatcher, ResultCache, ServeConfig
    from repro_torch.serving import SurrogateEngine, TrajectoryEngine, feedback_plan, load_feedback
    from repro_torch.surrogate import dataset, model, seqmodel, train, trajectory

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n_req, max_batch = SERVE_MAIN["requests"], SERVE_MAIN["max_batch"]
    waves = dataset.load_shards(trained["shards"])[0][:n_req]
    scenarios = planner.expand(planner.sweep_from_json(SERVE_MAIN_SWEEP))
    routed_requests = [(s.signature(), s.waves().astype(np.float32), s) for s in scenarios]
    require(len(scenarios) == max_batch and all(x.shape == (1, *waves.shape[1:]) for _, x, _ in routed_requests),
            f"the sweep's {len(scenarios)} scenarios are not one batch of shard-shaped waves")
    out = {}
    for name, mod, cls, save in (("surrogate", model, SurrogateEngine, train.save_surrogate),
                                 ("trajectory", seqmodel, TrajectoryEngine, trajectory.save_trajectory)):
        cfg, params, scale = trained["cnn" if name == "surrogate" else "trajectory"]
        second = mod.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        ckpt = os.path.join(root, f"ckpt_{name}")
        t0 = time.perf_counter()
        save(ckpt, cfg, [params, second], scale=scale, step=SURROGATE_FIT["steps"])
        save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = cls.from_checkpoint(ckpt, buckets=(max_batch,), nt=waves.shape[1])
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sig = engine.signature()
        sig_s = time.perf_counter() - t0
        cache, log = ResultCache(64), os.path.join(root, f"feedback_{name}.jsonl")
        feedback = FeedbackLog(log, threshold=0.0)
        requests = [(f"wave{i}", waves[i:i + 1]) for i in range(n_req)]
        with MicroBatcher(engine, max_batch=max_batch, max_wait_ms=1000.0, cache=cache, feedback=feedback) as mb:
            first, first_s = _serve_round(mb, requests)
            computed = mb.stats()["batches"]
            again, again_s = _serve_round(mb, requests)
            st = mb.stats()
            routed, routed_s = _serve_round(mb, routed_requests)
            routed_batches = mb.stats()["batches"] - st["batches"]
        peak = torch.cuda.max_memory_allocated() - resident
        infer_ms = [first[i].infer_ms for i in range(0, n_req, max_batch)]  # one request of each batch
        logged = load_feedback(log)
        plan = feedback_plan(log)
        solo = {i: engine.infer(waves[i:i + 1]) for i in (0, n_req - 1)}  # one row of each batch, alone
        bitwise = all(np.array_equal(solo[i].y[0], first[i].y[0]) and solo[i].score[0] == first[i].score
                      for i in solo)
        ys = np.concatenate([r.y for r in first])
        out[name] = {"config": dataclasses.asdict(cfg), "members": len(engine.members), "signature": sig,
                     "signature_s": sig_s, "save_s": save_s, "load_s": load_s, "requests": n_req, "nt": waves.shape[1],
                     "output_shape": list(ys.shape), "requests_per_s": n_req / first_s, "rows_per_s": n_req / first_s,
                     "infer_ms": {"first": infer_ms[0], "warm": infer_ms[1:]},
                     "wait_ms": {"mean": st["wait_ms_mean"], "max": st["wait_ms_max"]},
                     "cache_round": {"seconds": again_s, "hits": st["cache_hits"], "infers": st["batches"] - computed},
                     "batches": st["batches"], "flush_full": st["flush_full"], "peak_device_bytes": peak,
                     "score": [float(min(r.score for r in first)), float(max(r.score for r in first))],
                     "feedback_round": {"scenarios": len(scenarios), "seconds": routed_s, "batches": routed_batches,
                                        "infer_ms": routed[0].infer_ms, **feedback.stats(),
                                        "plan_scenarios": plan.n_scenarios, "plan_groups": len(plan.groups)},
                     "batched_vs_alone_bitwise": bitwise}
        require(computed == n_req // max_batch and st["flush_full"] == computed, f"{name}: {st}")
        require(st["cache_hits"] == n_req and all(r.cached for r in again) and st["batches"] == computed,
                f"{name}: the second round was not all cache hits: {st}")
        require(routed_batches == 1 and not any(r.cached for r in routed)
                and feedback.stats()["observed"] == n_req + len(scenarios)
                and feedback.stats()["routed"] == len(scenarios),
                f"{name}: the sweep round was not one batch of routed scenarios: {out[name]['feedback_round']}")
        require([s.signature() for s in logged] == [s.signature() for s in scenarios]
                and plan.n_scenarios == len(scenarios), f"{name}: the feedback log does not read back its scenarios")
        require(bool(np.isfinite(ys).all()) and all(r.score > 0 for r in first), f"{name}: non-finite or score 0")
        require(bitwise, f"{name}: a row alone ≠ its batched row")
        del engine, solo
    emit({"serve_main_surrogates": out})

    # (c) the decode server over lm_main's parameters
    B, S0, NEW = SERVE_MAIN["decode_bucket"], SERVE_MAIN["prompt"], SERVE_MAIN["new_tokens"]
    n_dec = SERVE_MAIN["decode_requests"]
    prompts = torch.randint(0, qwen.vocab_size, (n_dec, S0), generator=torch.Generator().manual_seed(5)).numpy()
    engine = DecodeEngine(qwen, lm_params, n_new=NEW, prompt_len=S0, buckets=(B,))
    t0 = time.perf_counter()
    sig = engine.signature()
    sig_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # counts of the decode server's run only
    with MicroBatcher(engine, max_batch=B, max_wait_ms=1000.0, cache=ResultCache(64)) as mb:
        first, first_s = _serve_round(mb, [(f"prompt{i}", prompts[i:i + 1]) for i in range(n_dec)])
        again, _ = _serve_round(mb, [(f"prompt{i}", prompts[i:i + 1]) for i in range(n_dec)])
        st = mb.stats()
    served_launches = kernels.instance_counts()
    peak = torch.cuda.max_memory_allocated() - resident
    toks = np.concatenate([r.y for r in first])
    solo = engine.infer(prompts[n_dec - 1:])  # the last prompt alone, padded to the bucket
    kernels.reset_launch_counts()
    off = DecodeEngine(qwen, lm_params, n_new=NEW, prompt_len=S0, buckets=(B,), kv_schedule="prefetch",
                       serve=ServeConfig(kv_offload=True, kv_npart=SERVE_MAIN["kv_npart"]))
    t0 = time.perf_counter()
    off_toks = off.infer(prompts[:B]).y
    off_s = time.perf_counter() - t0
    off_launches = kernels.instance_counts()
    batches = st["batches"]
    infer_ms = [first[i].infer_ms for i in range(0, n_dec, B)]  # one request of each batch
    out = {"arch": qwen.name, "layers": qwen.n_layers, "dtype": qwen.dtype, "signature": sig, "signature_s": sig_s,
           "requests": n_dec, "bucket": B, "prompt": S0, "new_tokens": NEW, "requests_per_s": n_dec / first_s,
           "rows_per_s": n_dec / first_s, "tokens_per_s": n_dec * NEW / first_s,
           "infer_ms": {"first": infer_ms[0], "warm": infer_ms[1:]},
           "wait_ms": {"mean": st["wait_ms_mean"], "max": st["wait_ms_max"]}, "cache_hits": st["cache_hits"],
           "batches": st["batches"], "peak_device_bytes": peak, "flash_launches": served_launches,
           "solo_equals_batched_row": bool(np.array_equal(solo.y[0], toks[-1])),
           "offloaded": {"kv_npart": SERVE_MAIN["kv_npart"], "schedule": "prefetch", "seconds": off_s,
                         "tokens_equal_resident": bool(np.array_equal(off_toks, toks[:B])),
                         "flash_launches": off_launches},
           "tokens_row0": toks[0, :8].tolist()}
    require(batches == n_dec // B and st["cache_hits"] == n_dec and all(r.cached for r in again),
            f"decode server: {st}, {batches} infers")
    require(served_launches == {"flash_attention_bf16": qwen.n_layers * batches, "flash_attention_f32": 0},
            f"decode server's flash launches {served_launches}, not {qwen.n_layers} of the bf16 kernel a batch")
    require(off_launches == {"flash_attention_bf16": qwen.n_layers, "flash_attention_f32": 0},
            f"offloaded decode's flash launches {off_launches}")
    require(toks.shape == (n_dec, NEW) and out["solo_equals_batched_row"], "decode: a prompt alone ≠ its row")
    require(out["offloaded"]["tokens_equal_resident"], "offloaded KV's tokens differ from the resident engine's")
    del engine, off

    # the serve CLI at qwen3-1.7b's full width (its own parameters)
    torch.cuda.empty_cache()
    res = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lines = _serve_cli(SERVE_CLI_FULL, res)
    cli_launches = kernels.instance_counts()
    out["cli_full"] = {"argv": SERVE_CLI_FULL, "seconds": time.perf_counter() - t0, "report": lines,
                       "flash_launches": cli_launches}
    require(cli_launches == {"flash_attention_bf16": 2 * qwen.n_layers, "flash_attention_f32": 0},
            f"the full-width decode CLI's flash launches {cli_launches}")  # warm-up + one batch
    require(res["stats"]["cache_hits"] == 4 and bool(np.isfinite(res["tokens"]).all()), f"CLI: {res['stats']}")
    emit({"serve_main_decode": out})
    shutil.rmtree(root, ignore_errors=True)
    return {"serve_main_decode": served_launches["flash_attention_bf16"],
            "serve_main_offloaded": off_launches["flash_attention_bf16"],
            "serve_main_cli": cli_launches["flash_attention_bf16"]}


# plan_check: the planner, autotuner and scheduler at crs_check's mesh, 12 springs: a
# sweep over the soil axis (two compile groups, 2 cases a scenario, 6 steps)
PLAN_CHECK_SWEEP = {"base": {"n_cases": 2, "nt": 6, "mesh_n": [8, 8, 4], "nspring": 12},
                    "axes": {"soil.vs": [[0.8, 1.0], [1.0, 1.0]]}}
# plan_main at main's size and 150 springs: (a) one soil, two wave families, 2 cases each,
# 4 steps, autotuned with the probe; (b) two soils × 2 cases, 4 steps, through two queue workers
PLAN_MAIN_BASE = {"n_cases": 2, "nt": 4, "mesh_n": [64, 64, 12], "nspring": 150}
PLAN_MAIN_SWEEP_A = {"base": PLAN_MAIN_BASE, "axes": {"wave.family": ["band_noise", "ricker"]}}
PLAN_MAIN_SWEEP_B = {"base": PLAN_MAIN_BASE, "axes": {"soil.vs": [[0.8, 1.0], [1.0, 1.0]]}}
PLAN_TIME_FIELDS = ("wall_s", "cases_per_s")


def _campaign_cli(argv, result):
    """``launch.campaign.main(argv)`` in-process, its output captured."""
    import contextlib
    import io

    from repro_torch.launch import campaign as campaign_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = campaign_cli.main(argv, result)
    require(rc == 0, f"campaign CLI {argv} exited {rc}: {buf.getvalue()}")
    return buf.getvalue().splitlines()


def _manifest(path, strip=False):
    with open(path) as f:
        m = json.load(f)
    if strip:
        for g in m["groups"]:
            for k in PLAN_TIME_FIELDS:
                g.pop(k, None)
    return m


def _require_groups_completed(stats, what):
    bad = {k: st for k, st in stats.items() if not st.get("completed") or st.get("failed")}
    require(stats and not bad, f"{what}: a group did not complete: {bad}")


def _shortlist(mesh, cfg, n_cases, calibration=None):
    """The autotuner's model ranking at its defaults, and the probe's
    shortlist of it."""
    from repro_torch.scenario import autotune

    scored = sorted(autotune._model_scores(
        mesh, cfg, n_cases=n_cases, n_devices=1, methods=("proposed2", "proposed1"), kset_cap=4, npart_cap=8,
        link_gbps=autotune.DEFAULT_LINK_GBPS, device_budget_bytes=autotune.DEFAULT_DEVICE_GB * 1e9,
        calibration=calibration), key=lambda c: (c[0], c[1], c[2], c[3]))
    return scored, autotune._probe_shortlist(scored, 2)


def _shards_equal(a, b, names):
    import numpy as np

    from repro_torch.surrogate import dataset

    for n in names:
        (xa, ya), (xb, yb) = dataset.load_shards(os.path.join(a, n)), dataset.load_shards(os.path.join(b, n))
        if not (np.array_equal(xa, xb) and np.array_equal(ya, yb)):
            return False
    return True


def plan_check(root, dev, feedback):
    """The planning and scheduling layer on the card at (8, 8, 4), 12 springs,
    against the port on the CPU: ``run_plan`` of a two-group sweep (soil axis,
    autotuned by the model) within 1e-6·max|v| of the CPU with equal manifests
    apart from the time fields (so equal ``TuneChoice``s); ``choose(probe=True)``
    on the card, whose k-set kernels launch, and the CLI's ``--autotune
    --probe``; kill-and-rejoin (``run_worker`` w0 preempted after step 3, w1
    finishing) bitwise the serial run on the card; the CLI's ``--schedule
    --workers 2 --train-while-generating``; and ``--scenarios`` over the
    feedback log that ``serve_check`` wrote.  Returns the phase's in-process
    launches by kernel."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import kernels, scenario as sc
    from repro_torch.scenario import autotune
    from repro_torch.surrogate import dataset

    cpu = torch.device("cpu")
    shutil.rmtree(root, ignore_errors=True)
    kernels.reset_launch_counts()
    spec = sc.sweep_from_json(json.dumps(PLAN_CHECK_SWEEP))
    group_kw = dict(autotune=True, ckpt_every=2, shard_size=1)
    rows = {}

    # 1. run_plan on the card against the CPU (model-tuned: equal choices)
    runs = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        runs[where] = sc.run_plan(sc.make_plan(spec), device=d, ckpt_dir=os.path.join(root, f"ck_{where}"),
                                  out_dir=os.path.join(root, f"serial_{where}"), **group_kw)
        _require_groups_completed(runs[where].group_stats, f"run_plan on {where}")
    a, b = runs["card"].scenarios, runs["cpu"].scenarios
    require(sorted(a) == sorted(b) and len(a) == 2, f"run_plan scenarios: {sorted(a)} vs {sorted(b)}")
    scale = max(float(np.abs(r.responses).max()) for r in b.values())
    err = max(float(np.abs(a[n].responses - b[n].responses).max()) for n in a)
    m_card, m_cpu = (_manifest(runs[w].manifest_path, strip=True) for w in ("card", "cpu"))
    rows["run_plan"] = {"groups": len(runs["card"].plan.groups), "card_vs_cpu_rel": err / scale,
                        "tol": 1e-6, "manifests_equal_but_time": m_card == m_cpu,
                        "choices": [g["choice"] for g in m_card["groups"]],
                        "mean_iters": [g["mean_iters"] for g in m_card["groups"]],
                        "wall_s": [runs["card"].group_stats[g.key]["wall_s"] for g in runs["card"].plan.groups]}
    require(scale > 0 and err <= 1e-6 * scale, f"run_plan on the card ≠ CPU: {err / scale}")
    require(m_card == m_cpu, f"plan manifests differ between card and CPU: {m_card} vs {m_cpu}")
    require(len(m_card["groups"]) == 2 and all(g["choice"]["source"] == "model" for g in m_card["groups"]),
            "the model did not tune each group")

    # 2. the probe on the card: a shortlisted candidate, its k-set kernels launched
    group = runs["card"].plan.groups[0]
    ref = group.scenarios[0]
    mesh = ref.build_mesh()
    waves = np.concatenate([s.waves() for s in group.scenarios])
    cfg = ref.sim_config()
    shortlist = _shortlist(mesh, cfg, group.n_cases)[1]
    before = kernels.launch_counts()
    probed = autotune.choose(mesh, cfg, n_cases=group.n_cases, probe=True, waves=waves, obs=ref.obs.indices(mesh),
                             device=dev)
    probe_launches = {k: c - before[k] for k, c in kernels.launch_counts().items()}
    res = {}
    _campaign_cli(["--sweep", json.dumps(PLAN_CHECK_SWEEP), "--autotune", "--probe",
                   "--out", os.path.join(root, "probe_out")], res)
    _require_groups_completed(res["plan_run"].group_stats, "--autotune --probe")
    cli_choices = [g.choice for g in res["plan_run"].plan.groups]
    rows["probe"] = {"choice": dataclasses.asdict(probed), "shortlist": shortlist, "launches": probe_launches,
                     "cli_choices": [dataclasses.asdict(c) for c in cli_choices]}
    require(probed.source == "probe" and probed.probed_case_s > 0
            and (probed.modeled_case_s, probed.method, probed.npart, probed.kset) in shortlist,
            f"the probe on the card: {probed}, shortlist {shortlist}")
    require(probe_launches["multispring_kset"] > 0, f"the probe launched no k-set multispring: {probe_launches}")
    require(probe_launches["ebe_matvec_kset_f64"] > 0 and probe_launches["ebe_matvec_kset_f32"] > 0,
            f"the Proposed 2 probe launched no k-set EBE product: {probe_launches}")
    require(all(c.source == "probe" and c.probed_case_s > 0 for c in cli_choices), f"CLI probe: {cli_choices}")

    # 3. kill-and-rejoin through the queue ≡ the serial run on the card, bitwise
    ck, out = os.path.join(root, "ck_queue"), os.path.join(root, "queue_out")
    w0 = sc.run_worker(sc.make_plan(spec), worker="w0", device=dev, ckpt_dir=ck, out_dir=out,
                       stop_after_steps=3, **group_kw)
    w1 = sc.run_worker(sc.make_plan(spec), worker="w1", device=dev, ckpt_dir=ck, out_dir=out, **group_kw)
    names = sorted(a)
    q = sc.JobQueue(os.path.join(ck, "queue"))
    fails = sorted(os.path.basename(p) for g in runs["card"].plan.groups for p in q.fail_paths(g.key))
    same = _shards_equal(out, os.path.join(root, "serial_card"), names)
    rows["kill_rejoin"] = {"w0_preempted": len(w0.preempted), "w0_done": len(w0.done), "w1_done": len(w1.done),
                           "settled": w1.settled, "dead": w1.dead, "fail_records": fails,
                           "bitwise_serial": same}
    require(len(w0.preempted) == 1 and not w0.done and w1.settled and not w1.dead and len(w1.done) == 2,
            f"kill-and-rejoin: {rows['kill_rejoin']}")
    require(same, "the scheduled kill-and-rejoin is not bitwise the serial run on the card")

    # 4. the CLI's two-worker pool with the trainer alongside (children on the card)
    res = {}
    t0 = time.perf_counter()
    lines = _campaign_cli(["--sweep", json.dumps(PLAN_CHECK_SWEEP), "--schedule", "--workers", "2",
                           "--train-while-generating", "--train-steps", "8", "--shard-size", "1",
                           "--out", os.path.join(root, "sched_out"), "--ckpt-dir", os.path.join(root, "sched_ck")],
                          res)
    train = res.get("train", {})
    rows["schedule_cli"] = {"seconds": time.perf_counter() - t0, "rcs": res.get("rcs"), "settled": res.get("settled"),
                            "dead": res.get("dead"), "train_val_mae": train.get("info", {}).get("val_mae"),
                            "train_shards": train.get("info", {}).get("n_shards"),
                            "report": [ln for ln in lines if "[train]" in ln or "[schedule]" in ln]}
    require(res.get("rcs") == [0, 0] and res.get("settled") and not res.get("dead"),
            f"the scheduled CLI did not settle: {rows['schedule_cli']}")
    require("info" in train and np.isfinite(train["info"]["val_mae"]) and any("val MAE" in ln for ln in lines),
            f"the trainer did not report its validation MAE: {train.get('error')}")

    # 5. --scenarios over the serving tier's feedback log
    res = {}
    fb_out = os.path.join(root, "feedback_out")
    _campaign_cli(["--scenarios", feedback, "--out", fb_out], res)
    run = res["plan_run"]
    _require_groups_completed(run.group_stats, "--scenarios")
    loaded = {n: dataset.load_shards(os.path.join(fb_out, n)) for n in run.scenarios}  # CRCs checked
    rows["feedback_sweep"] = {"scenarios": len(run.scenarios), "groups": len(run.plan.groups),
                              "cases": {n: len(x) for n, (x, _) in loaded.items()},
                              "finite": all(bool(np.isfinite(y).all()) for _, y in loaded.values())}
    require(len(run.scenarios) == run.plan.n_scenarios >= 1 and rows["feedback_sweep"]["finite"],
            f"--scenarios: {rows['feedback_sweep']}")
    launches = kernels.launch_counts()
    rows["launches"] = launches
    emit({"plan_check": rows})
    shutil.rmtree(root, ignore_errors=True)
    return launches


def calibration_table(path, rows, device_name):
    """``timing``'s multispring (one streamed block) and fp64 EBE rows as a
    ``BENCH_kernels.json``-format table: the CUDA kernels as backend ``cuda``,
    their plain versions as ``torch``."""
    by = {r["name"]: r for r in rows}
    table = {"bench": "chip_smoke.py timing", "platform": "gpu", "device": device_name, "kernels": {}}
    for name, row, unit, units in (
            ("multispring", by["multispring"], "point_spring", by["multispring"]["detail"]["P"]
             * by["multispring"]["detail"]["S"]),
            ("ebe_matvec", by["ebe_matvec_f64"], "element", by["ebe_matvec_f64"]["detail"]["E"])):
        table["kernels"][name] = {"unit": unit, "units": units, "backends": {
            "cuda": {"us_per_call": row["ms"] * 1e3}, "torch": {"us_per_call": row["plain_ms"] * 1e3}}}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    return path


def plan_main(root, dev, calibration, mesh):
    """The planning and scheduling layer at main's size, 150 springs:
    (a) the CLI's ``--sweep`` over one soil and two wave families (one
    compile group of 4 cases, 4 steps), ``--autotune --probe --calibration``
    (the table ``timing`` measured), beside the model's choices at the
    default 4 GB budget and at 70 GB; (b) ``--schedule --workers 2 --lease-s
    120 --method proposed2 --kset 1`` over two soils × 2 cases: one group per
    worker process on the card, a settled queue with no dead group and no
    takeover.  ``mesh`` is main's mesh (its element count sizes the model).
    Returns (a)'s launches by kernel."""
    import glob
    import shutil

    import numpy as np
    import torch

    from repro_torch import kernels, scenario as sc
    from repro_torch.scenario import autotune

    shutil.rmtree(root, ignore_errors=True)
    out = {}
    # (a) the autotuned sweep, in-process
    cfg = sc.Scenario(nspring=PLAN_MAIN_BASE["nspring"]).sim_config()
    cal = autotune.pipeline.load_kernel_calibration(calibration)
    model = {f"device_gb_{gb:g}": dataclasses.asdict(autotune.choose(mesh, cfg, n_cases=4, device_gb=gb,
                                                                      calibration=cal))
             for gb in (autotune.DEFAULT_DEVICE_GB, 70.0)}
    scored, shortlist = _shortlist(mesh, cfg, 4, cal)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = {}
    a_out = os.path.join(root, "a_out")
    t0 = time.perf_counter()
    lines = _campaign_cli(["--sweep", json.dumps(PLAN_MAIN_SWEEP_A), "--autotune", "--probe", "--calibration",
                           calibration, "--out", a_out], res)
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    run = res["plan_run"]
    _require_groups_completed(run.group_stats, "plan_main (a)")
    m = _manifest(os.path.join(a_out, "plan.json"))
    g = m["groups"][0]
    peak_v = max(float(np.abs(r.responses).max()) for r in run.scenarios.values())
    out["a"] = {"sweep": PLAN_MAIN_SWEEP_A, "groups": len(m["groups"]), "cases": m["n_cases"], "choice": g["choice"],
                "shortlist": shortlist, "considered": len(scored), "model_choice": model,
                "wall_s": g["wall_s"], "cases_per_s": g["cases_per_s"], "mean_iters": g["mean_iters"],
                "cli_s": a_s, "peak_device_bytes": torch.cuda.max_memory_allocated() - resident,
                "resident_before_bytes": resident, "launches": launches, "peak_abs_v": peak_v,
                "report": [ln for ln in lines if "group" in ln]}
    ch = g["choice"]
    require(len(m["groups"]) == 1 and m["n_cases"] == 4, f"plan_main (a): {m['n_cases']} cases")
    require(ch["source"] == "probe" and ch["probed_case_s"] > 0 and ch["calibration"] == "cuda"
            and (ch["modeled_case_s"], ch["method"], ch["npart"], ch["kset"]) in shortlist,
            f"plan_main (a): the probe's choice {ch} is not in the shortlist {shortlist}")
    require(launches["multispring_kset"] > 0, f"plan_main (a) launched no k-set multispring: {launches}")
    require(np.isfinite(peak_v) and peak_v > 0, "plan_main (a): responses not finite or zero")
    del res, run
    torch.cuda.empty_cache()

    # (b) two worker processes on the card, one group each
    res = {}
    b_out = os.path.join(root, "b_out")
    t0 = time.perf_counter()
    lines = _campaign_cli(["--sweep", json.dumps(PLAN_MAIN_SWEEP_B), "--schedule", "--workers", "2",
                           "--lease-s", "120", "--method", "proposed2", "--kset", "1", "--out", b_out], res)
    settle_s = time.perf_counter() - t0
    qdir = os.path.join(b_out, "queue")
    fails = [json.load(open(p)) for p in sorted(glob.glob(os.path.join(qdir, "job_*.fail_*.json")))]
    m = _manifest(os.path.join(b_out, "plan.json"))
    out["b"] = {"sweep": PLAN_MAIN_SWEEP_B, "workers": 2, "lease_s": 120, "rcs": res.get("rcs"),
                "settled": res.get("settled"), "dead": res.get("dead"), "seconds_to_settle": settle_s,
                "groups": [{k: g.get(k) for k in ("key", "worker", "attempt", "wall_s", "cases_per_s", "mean_iters")}
                           for g in m["groups"]],
                "fail_records": [{k: f.get(k) for k in ("kind", "worker", "error")} for f in fails],
                "report": [ln for ln in lines if "[schedule]" in ln or "[watchdog]" in ln]}
    emit({"plan_main": out})
    require(res.get("rcs") == [0, 0] and res.get("settled") and not res.get("dead"),
            f"plan_main (b) did not settle: {out['b']}")
    require(all(g.get("completed") for g in m["groups"]) and len(m["groups"]) == 2, "plan_main (b): a group")
    require(not any(f.get("kind") == "expired" for f in fails), f"plan_main (b): a lease was taken over: {fails}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# gemma2-2b, mixtral-8x22b and deepseek-v2-236b.  lm_families_cpu: gemma2-2b at its
# published widths cut to one pair of layers (window 32 under a prompt of 64, so the
# window acts), mixtral and deepseek-v2 reduced at capacity factor 8.0 (as the
# reference's own decode test: decode then routes as forward does); fp32
FAMILY_NAMES = ("gemma2-2b", "mixtral-8x22b", "deepseek-v2-236b")
FAMILIES_CPU = dict(B=2, prompt=64, new_tokens=4)
# the SSM, hybrid, encoder-decoder and VLM families at their published widths, few layers:
# zamba2 one group of 6 Mamba blocks and the shared attention block, then a remainder of 1
SSM_FAMILY_CPU_CUTS = {"mamba2-780m": {"n_layers": 2}, "zamba2-7b": {"n_layers": 7},
                       "whisper-small": {"n_layers": 2, "encoder_layers": 2}, "internvl2-1b": {"n_layers": 2}}
# the stub frontends' outputs [B, n, d_model], seeded random: whisper's frames, internvl2's patches
FRONTEND = {"whisper-small": ("frames", 1500), "internvl2-1b": ("patches", 256)}
# lm_families: bf16 compute, fp32 parameters, greedy.  gemma2-2b whole (26 layers, its
# 8,192 context: twice the local window); mixtral 2 of 56 layers (141 G parameters do
# not fit in 80 GB; the prompt passes its 4,096 window) with the KV offloaded in 2
# pinned blocks beside; deepseek-v2 1 dense + 1 MoE layer of 60; mamba2-780m, zamba2-7b
# (6.7 G parameters, 27 GB in fp32), whisper-small and internvl2-1b whole, at 4,096
# decoder positions (internvl2: 256 patches and 3,840 tokens; whisper: 1,500 frames
# and a prompt of 128)
FAMILIES_MAIN = {
    "gemma2-2b": dict(cut={}, B=2, prompt=8192, cache_len=8224, new_tokens=32),
    "mixtral-8x22b": dict(cut={"n_layers": 2}, B=2, prompt=6144, cache_len=6176, new_tokens=32, kv_npart=2),
    "deepseek-v2-236b": dict(cut={"n_layers": 2}, B=1, prompt=2048, cache_len=2080, new_tokens=32),
    "mamba2-780m": dict(cut={}, B=4, prompt=4096, cache_len=4128, new_tokens=32),
    "zamba2-7b": dict(cut={}, B=2, prompt=4096, cache_len=4128, new_tokens=32),
    "whisper-small": dict(cut={}, B=8, prompt=128, cache_len=160, new_tokens=32, frontend=1500),
    "internvl2-1b": dict(cut={}, B=4, prompt=3840, cache_len=4128, new_tokens=32, frontend=256),
}
# timing's bf16 flash rows at the families' prefill shapes (the kernel's (256, 256)
# instance for gemma2, (192, 128) for MLA, (128, 128) at mixtral's windowed GQA shape and
# at zamba2's dh 112, (64, 64) at internvl2's GQA group of 7 and at whisper's encoder,
# cross attention and decoder): (row, the paths whose launches it counts, B, Hq, Hkv, Sq,
# Skv, dh, dv, causal, window, softcap, scale)
FAMILY_FLASH = (
    ("flash_attention_bf16_d256_gemma2_local", ("gemma2-2b local",), 2, 8, 4, 8192, 8192, 256, 256, True, 4096,
     50.0, None),
    ("flash_attention_bf16_d256_gemma2_global", ("gemma2-2b global",), 2, 8, 4, 8192, 8192, 256, 256, True, None,
     50.0, None),
    ("flash_attention_bf16_d192_mla", ("deepseek-v2-236b MLA",), 1, 128, 128, 2048, 2048, 192, 128, True, None,
     None, 192**-0.5),
    ("flash_attention_bf16_d128_mixtral", ("mixtral-8x22b prefill", "mixtral-8x22b offloaded generate"),
     2, 48, 8, 6144, 6144, 128, 128, True, 4096, None, None),
    ("flash_attention_bf16_d112_zamba2", ("zamba2-7b shared attention",), 2, 32, 32, 4096, 4096, 112, 112, True,
     None, None, None),
    ("flash_attention_bf16_d64_internvl2", ("internvl2-1b prefill",), 4, 14, 2, 4096, 4096, 64, 64, True, None,
     None, None),
    ("flash_attention_bf16_d64_whisper_encoder", ("whisper-small encoder",), 8, 12, 12, 1500, 1500, 64, 64, False,
     None, None, None),
    ("flash_attention_bf16_d64_whisper_cross", ("whisper-small cross",), 8, 12, 12, 128, 1500, 64, 64, False, None,
     None, None),
    ("flash_attention_bf16_d64_whisper_decoder", ("whisper-small decoder",), 8, 12, 12, 128, 128, 64, 64, True,
     None, None, None),
    ("flash_attention_bf16_d128_granite", ("granite-8b prefill",), 4, 32, 8, 4096, 4096, 128, 128, True, None,
     None, None),
    ("flash_attention_bf16_d128_llama3", ("llama3-405b prefill",), 1, 128, 8, 8192, 8192, 128, 128, True, None,
     None, None),
)


class Recorded:
    """Calls to ``module.<name>`` recorded while the block runs (the callee runs
    as it is): the arguments ``what(*args, **kwargs)`` picks.  Kernel launches
    are counted by the wrappers' own counters, not here."""

    def __init__(self, module, name, what):
        self.module, self.name, self.what, self.calls = module, name, what, []

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def recorder(*args, **kwargs):
            self.calls.append(self.what(*args, **kwargs))
            return inner(*args, **kwargs)

        setattr(self.module, self.name, recorder)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)
        return False


def _flash_call(q, k, v, **kw):
    return {"dh": q.shape[-1], "dv": v.shape[-1], "window": kw.get("window"), "softcap": kw.get("softcap"),
            "causal": kw.get("causal", True), "sq": q.shape[2], "skv": k.shape[2]}


def flash_per_pass(cfg):
    """Flash launches in one prefill or ``forward`` of ``cfg``: one per
    attention layer of the decoder (zamba2: per application of its shared
    block), one more per whisper decoder block (its cross attention) and one
    per encoder layer."""
    from repro_torch.models import transformer as T

    slots = T.layout(cfg)
    return sum(s.kind != "mamba" for s in slots) + sum(s.kind == "cross" for s in slots) + cfg.encoder_layers


def frontend_inputs(name, cfg, B, n, generator, device):
    """``{"frames" | "patches": [B, n, d_model]}`` seeded random for whisper
    and internvl2 (the reference's stub frontends), else nothing."""
    import torch

    if name not in FRONTEND:
        return {}
    return {FRONTEND[name][0]: torch.randn((B, n, cfg.d_model), generator=generator, device=device)}


def wgmma_key(dk, dv):
    """The bf16 flash kernel's instance (DK, DV) as ``_by_instance`` keys it."""
    return f"{dk}x{dv}"


def _by_instance():
    """The bf16 flash kernel's launches since the last reset by the instance
    its wrapper passed to the C entry, ``{"DKxDV": n}`` (instances that ran)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return {wgmma_key(dk, dv): n for (dk, dv), n in fa_ops.wgmma_launch_counts().items() if n}


def _call_counts(calls):
    out = {}
    for c in calls:
        key = json.dumps(c, sort_keys=True)
        out[key] = out.get(key, 0) + 1
    return out


def _family_cfg_cpu(name):
    from repro_torch.configs import ARCHS

    if name == "gemma2-2b":
        return dataclasses.replace(ARCHS[name], n_layers=2, window=32, dtype="float32")
    if name in SSM_FAMILY_CPU_CUTS:
        return dataclasses.replace(ARCHS[name], dtype="float32", **SSM_FAMILY_CPU_CUTS[name])
    return dataclasses.replace(ARCHS[name].reduced(), capacity_factor=8.0)


def lm_families_cpu(dev):
    """gemma2-2b (published widths, one pair of layers, window 32), reduced
    mixtral and deepseek-v2, and mamba2-780m, zamba2-7b, whisper-small and
    internvl2-1b at their published widths with few layers
    (``SSM_FAMILY_CPU_CUTS``; whisper on 1,500 frames, internvl2 on 256
    patches), fp32: prefill + 4 decode steps on the card against the CPU on
    the same weights, prefill→decode against ``forward`` on the card
    (5e-5·max|logits|), greedy tokens equal, the MoE's aux loss card against
    CPU; exactly ``flash_per_pass`` fp32 flash launches in prefill and as many
    in ``forward`` (none for mamba2), none of the bf16 kernel.  Returns the
    fp32 launches by model."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    B, S0, NEW = FAMILIES_CPU["B"], FAMILIES_CPU["prompt"], FAMILIES_CPU["new_tokens"]
    rows, launches = {}, {}
    for name in FAMILY_NAMES + tuple(SSM_FAMILY_CPU_CUTS):
        cfg = _family_cfg_cpu(name)
        p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        p_gpu = _tree_to(p_cpu, dev)
        toks = torch.randint(0, cfg.vocab_size, (B, S0 + NEW), generator=torch.Generator().manual_seed(1))
        front = frontend_inputs(name, cfg, B, FRONTEND.get(name, (None, 0))[1], torch.Generator().manual_seed(2), cpu)
        P = front["patches"].shape[1] if "patches" in front else 0  # decoder positions before the tokens
        runs = {}
        for where, params, d in (("cpu", p_cpu, cpu), ("gpu", p_gpu, dev)):
            kernels.reset_launch_counts()  # the card's run is counted: the fp32 flash kernel's path
            t = toks.to(d)
            extra = {k: x.to(d) for k, x in front.items()}
            lg, st = T.prefill(params, cfg, {"tokens": t[:, :S0], **extra}, cache_len=P + S0 + NEW)
            out = [lg[:, 0]]
            for i in range(S0, S0 + NEW):
                lg, st = T.decode_step(params, cfg, t[:, i:i + 1], st)
                out.append(lg[:, 0])
            runs[where] = torch.stack(out, 1).cpu()
        fwd, aux = T.forward(p_gpu, cfg, {"tokens": toks.to(dev), **{k: x.to(dev) for k, x in front.items()}})
        fwd = fwd[:, P + S0 - 1:].cpu()
        got = kernels.instance_counts()
        aux_cpu = T.forward(p_cpu, cfg, {"tokens": toks})[1] if cfg.n_experts else aux.cpu()
        scale = float(runs["cpu"].abs().max())
        err_cpu = float((runs["gpu"] - runs["cpu"]).abs().max())
        err_fwd = float((runs["gpu"] - fwd).abs().max())
        same_tokens = torch.equal(runs["gpu"].argmax(-1), runs["cpu"].argmax(-1))
        want = {"flash_attention_bf16": 0, "flash_attention_f32": 2 * flash_per_pass(cfg)}
        rows[name] = {"cfg": {k: getattr(cfg, k) for k in ("family", "n_layers", "encoder_layers", "d_model",
                                                            "n_heads", "n_kv_heads", "vocab_size", "window",
                                                            "capacity_factor", "ssm_state", "attn_every")},
                      "hd": cfg.hd if cfg.n_heads else None, "B": B, "prompt": S0, "decode_steps": NEW,
                      "frontend": {k: list(x.shape) for k, x in front.items()}, "max_abs_err_vs_cpu": err_cpu,
                      "max_abs_err_vs_forward": err_fwd, "atol": 5e-5 * scale, "greedy_tokens_equal": same_tokens,
                      "aux": float(aux), "aux_cpu": float(aux_cpu), "flash_launches": got,
                      "state_shapes": {k: {n: list(x.shape) for n, x in c.items()}
                                       for k, c in st.items() if k != "pos"}}
        require(got == want, f"{name}: fp32 prefill + forward made flash launches {got}, not {want}")
        require(err_cpu <= 5e-5 * scale, f"{name}: logits on the card differ from the CPU: {err_cpu}")
        require(err_fwd <= 5e-5 * scale, f"{name}: prefill→decode differs from forward on the card: {err_fwd}")
        require(same_tokens, f"{name}: greedy tokens differ between card and CPU")
        require(abs(float(aux) - float(aux_cpu)) <= 1e-5 * max(1.0, abs(float(aux_cpu))),
                f"{name}: aux loss card {float(aux)} ≠ CPU {float(aux_cpu)}")
        launches[name] = got["flash_attention_f32"]
        del p_cpu, p_gpu, runs, fwd, st, lg, front
    emit({"lm_families_cpu": rows})
    return launches


def lm_families(dev):
    """The seven models on the card, bf16 compute, fp32 parameters, greedy:
    prefill (the bf16 flash kernel ``flash_per_pass`` times: gemma2 13
    windowed and 13 global sub-layers at dh 256, the (256, 256) instance;
    deepseek-v2's MLA at dh 192, dv 128, the (192, 128) one; mamba2 never;
    zamba2's shared block 13 times at dh 112, the (128, 128) one; whisper's 12
    encoder layers (non-causal), 12 decoder self attentions (causal) and 12
    cross attentions (non-causal, 128 × 1,500) and internvl2's 24 layers, the
    (64, 64) one) and 32 decode steps (no flash launch); mixtral's KV
    offloaded in 2 pinned blocks, through ``generate`` and stepped beside the
    resident decode, bitwise; the MoE's ``tokens_dropped_fraction`` over its
    prefill's router logits, with the tokens each expert is routed (first
    choice and all top-k).  Prefill s (the first call, then 3 warm ones),
    tokens/s, decode tokens/s, peak device bytes, parameters and launches
    (of the bf16 kernel also by instance) per model; each model is freed
    before the next.  Returns the bf16 launches by path."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core import hetmem
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L, moe as M, transformer as T
    from repro_torch.serving import decode as serve
    from repro_torch.utils.tree import tree_leaves

    def greedy(logits):
        return logits[:, -1].argmax(-1, keepdim=True)

    rows, by_path = {}, {}
    for name, spec in FAMILIES_MAIN.items():
        cfg = dataclasses.replace(ARCHS[name], **spec["cut"])
        B, S0, NEW, C = spec["B"], spec["prompt"], spec["new_tokens"], spec["cache_len"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident_before = torch.cuda.memory_allocated()
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        prompt = torch.randint(0, cfg.vocab_size, (B, S0), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        batch = {"tokens": prompt, **frontend_inputs(name, cfg, B, spec.get("frontend", 0),
                                                     torch.Generator(device=dev).manual_seed(2), dev)}
        positions = S0 + (batch["patches"].shape[1] if "patches" in batch else 0)  # the decoder's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()  # counts of this model's path only
        with Recorded(L, "flash_attention", _flash_call) as flash, \
                Recorded(M, "moe", lambda p, x, *a, **kw: (p["router"], x)) as moe_in:
            t0 = time.perf_counter()
            logits, state = T.prefill(params, cfg, batch, cache_len=C)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        prefill_by_kernel, prefill_by_instance = kernels.instance_counts(), _by_instance()
        require(bool(torch.isfinite(logits).all()), f"{name}: prefill logits not finite")
        router_logits = [(x.reshape(-1, cfg.d_model) @ r.to(x.dtype)).float() for r, x in moe_in.calls]
        dropped = [float(M.tokens_dropped_fraction(lg, cfg)) for lg in router_logits]
        # tokens per expert: the router's first choice, and all top-k choices (what fills the capacity)
        expert_counts = [{"first_choice": torch.bincount(lg.argmax(-1), minlength=cfg.n_experts).tolist(),
                          "top_k": torch.bincount(torch.topk(lg, cfg.top_k, dim=-1).indices.reshape(-1),
                                                  minlength=cfg.n_experts).tolist()}
                         for lg in router_logits]
        del moe_in, router_logits
        tok, gen, step_logits = greedy(logits), [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NEW):
            gen.append(tok)
            logits, state = T.decode_step(params, cfg, tok, state)
            step_logits.append(logits)
            tok = greedy(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = kernels.instance_counts()
        decode_launches = {k: launches[k] - prefill_by_kernel[k] for k in launches}
        prefill_warm_s = []  # the first prefill above also pays first-call costs (allocations, library plans)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = T.prefill(params, cfg, batch, cache_len=C)
            torch.cuda.synchronize()
            prefill_warm_s.append(time.perf_counter() - t0)
            del again
        gen = torch.cat(gen, 1)
        row = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": ARCHS[name].n_layers, "params": n_params,
               "B": B, "prompt": S0, "frontend": {k: list(x.shape) for k, x in batch.items() if k != "tokens"},
               "cache_len": C, "new_tokens": NEW, "prefill_s": prefill_s,
               "prefill_tokens_per_s": B * positions / prefill_s, "prefill_warm_s": prefill_warm_s,
               "prefill_warm_tokens_per_s": B * positions / min(prefill_warm_s), "decode_s": decode_s,
               "decode_tokens_per_s": B * NEW / decode_s, "peak_device_bytes": peak,
               "resident_before_bytes": resident_before, "flash_launches_prefill": prefill_by_kernel,
               "flash_launches_prefill_by_instance": prefill_by_instance, "flash_calls_prefill": _call_counts(flash.calls), "flash_launches_decode": decode_launches,
               "cache_shapes": {k: {n: list(t.shape) for n, t in c.items()} for k, c in state.items() if k != "pos"},
               "tokens_row0": gen[0, :8].tolist()}
        n_attn = flash_per_pass(cfg)
        require(prefill_by_kernel == {"flash_attention_bf16": n_attn, "flash_attention_f32": 0},
                f"{name}: prefill's flash launches {prefill_by_kernel}, not {n_attn} of the wgmma kernel alone")
        # the instance that launched, as the wrapper counted it at the C entry
        heads = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) if cfg.attn_type == "mla"
                 else (cfg.hd, cfg.hd) if cfg.n_heads else None)
        want_instance = {wgmma_key(*fa_ops.wgmma_instance(*heads)): n_attn} if n_attn else {}
        require(prefill_by_instance == want_instance,
                f"{name}: prefill's bf16 flash launches by instance {prefill_by_instance}, not {want_instance}")
        require(all(v == 0 for v in decode_launches.values()), f"{name}: decode launched flash: {decode_launches}")
        require(bool(torch.isfinite(logits).all()), f"{name}: decode logits not finite")
        require(tuple(gen.shape) == (B, NEW) and state["pos"] == positions + NEW,
                f"{name}: generated {tuple(gen.shape)} to position {state['pos']}")
        hd = cfg.hd if cfg.n_heads else None  # mamba2 has no attention
        calls = {"dh": hd, "dv": hd, "window": cfg.window, "softcap": cfg.attn_softcap, "causal": True,
                 "sq": positions, "skv": positions}  # a causal self attention over the decoder's positions
        if name == "mamba2-780m":
            require(not flash.calls and set(state) == {"pos", "layers"}, f"mamba2's prefill: {row['cache_shapes']}")
        elif name == "zamba2-7b":
            require(flash.calls == [calls] * n_attn == [calls] * 13, f"zamba2's prefill flash calls {flash.calls}")
            require(tuple(state["shared_attn"]["k"].shape[:1]) == (13,) and tuple(state["groups"]["ssm"].shape[:2])
                    == (13, 6) and tuple(state["remainder"]["ssm"].shape[:1]) == (3,),
                    f"zamba2's caches {row['cache_shapes']}")
            by_path["zamba2-7b shared attention"] = len(flash.calls)
        elif name == "whisper-small":
            Sf = spec["frontend"]
            kinds = {"encoder": dict(calls, causal=False, sq=Sf, skv=Sf), "decoder": calls,
                     "cross": dict(calls, causal=False, skv=Sf)}
            want = [kinds["encoder"]] * cfg.encoder_layers + [kinds["decoder"], kinds["cross"]] * cfg.n_layers
            require(flash.calls == want, f"whisper's prefill flash calls {_call_counts(flash.calls)}")
            require(tuple(state["enc_kv"]["k"].shape) == (cfg.n_layers, B, cfg.n_kv_heads, Sf, cfg.hd),
                    f"whisper's caches {row['cache_shapes']}")
            for kind, c in kinds.items():
                by_path[f"whisper-small {kind}"] = flash.calls.count(c)
        elif name == "internvl2-1b":
            require(flash.calls == [calls] * cfg.n_layers, f"internvl2's prefill flash calls {flash.calls}")
            by_path["internvl2-1b prefill"] = len(flash.calls)
        elif name == "gemma2-2b":
            windows = [c["window"] for c in flash.calls]
            require(all(c["dh"] == c["dv"] == cfg.hd and c["softcap"] == cfg.attn_softcap for c in flash.calls)
                    and windows == [cfg.window, None] * (n_attn // 2),
                    f"gemma2's prefill flash calls {_call_counts(flash.calls)}")
            require(state["local"]["k"].shape[3] == cfg.window and state["global"]["k"].shape[3] == C,
                    f"gemma2's caches {row['cache_shapes']}")
            by_path["gemma2-2b local"] = windows.count(cfg.window)
            by_path["gemma2-2b global"] = windows.count(None)
        elif name == "deepseek-v2-236b":
            mla = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim, None)  # (192, 128, no window)
            require(all((c["dh"], c["dv"], c["window"]) == mla for c in flash.calls),
                    f"MLA's prefill flash calls {_call_counts(flash.calls)}")
            require(len(dropped) == 1 and 0.0 <= dropped[0] < 1.0, f"tokens_dropped_fraction {dropped}")
            row["tokens_dropped_fraction_at_capacity_factor"] = {"capacity_factor": cfg.capacity_factor,
                                                                 "moe_layers": dropped}
            row["router_tokens_per_expert"] = expert_counts
            by_path["deepseek-v2-236b MLA"] = len(flash.calls)
        else:  # mixtral: the KV offloaded in pinned blocks, bitwise the resident decode
            row["tokens_dropped_fraction_at_capacity_factor"] = {"capacity_factor": cfg.capacity_factor,
                                                                 "moe_layers": dropped}
            row["router_tokens_per_expert"] = expert_counts
            npart = spec["kv_npart"]
            require(all(c == calls for c in flash.calls), f"mixtral's prefill flash calls {flash.calls}")
            by_path["mixtral-8x22b prefill"] = len(flash.calls)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            off_tok = serve.generate(params, cfg, prompt, NEW, serve.ServeConfig(kv_offload=True, kv_npart=npart),
                                     kv_schedule="prefetch")
            torch.cuda.synchronize()
            off_s = time.perf_counter() - t0
            off_launches, off_by_instance = kernels.instance_counts(), _by_instance()
            blocks = serve.make_kv_blocks(cfg, B, C, npart, dtype=L.dt(cfg), device=dev)
            host = {n: [x for blk in blocks for x in blk[j]] for j, n in enumerate(("k", "v"))}
            _, ostate = T.prefill(params, cfg, {"tokens": prompt}, cache_len=C, out=host)
            ostate, steps_equal = {"pos": ostate["pos"]}, 0
            for t in range(NEW):
                olg, ostate, blocks = serve.decode_step_offloaded(params, cfg, gen[:, t:t + 1], ostate, blocks,
                                                                  schedule="prefetch")
                steps_equal += int(torch.equal(olg, step_logits[t]))
            kv_equal = all(torch.equal(torch.cat([blk[i] for blk in blocks]).to(dev), state["layers"][n])
                           for i, n in enumerate(("k", "v")))
            pinned = all(hetmem.is_pinned_host(x) for blk in blocks for x in blk)
            row["offloaded_vs_resident"] = {
                "kv_npart": npart, "schedule": "prefetch", "generate_s": off_s,
                "tokens_equal": torch.equal(off_tok[:, S0:], gen), "steps_with_bitwise_logits": steps_equal,
                "steps": NEW, "kv_bitwise": kv_equal, "kv_blocks_pinned_host": pinned,
                "generate_flash_launches": off_launches, "generate_flash_launches_by_instance": off_by_instance}
            require(off_launches == {"flash_attention_bf16": n_attn, "flash_attention_f32": 0}
                    and off_by_instance == want_instance,
                    f"mixtral's offloaded generate made flash launches {off_launches}, {off_by_instance}")
            require(torch.equal(off_tok[:, S0:], gen), "mixtral: offloaded generate's tokens differ from resident")
            require(steps_equal == NEW and kv_equal and pinned, f"mixtral offload: {row['offloaded_vs_resident']}")
            by_path["mixtral-8x22b offloaded generate"] = off_launches["flash_attention_bf16"]
            del blocks, host, ostate, olg
        emit({"lm_families": row})
        rows[name] = row
        del params, state, logits, step_logits, prompt, batch, flash
    torch.cuda.empty_cache()
    return by_path


# lm_tail: granite-8b whole and llama3-405b at its published widths, 2 of 126 layers (10.6 G
# parameters, 42.3 GB in fp32, mixtral's cut), bf16 compute over fp32 parameters, greedy
TAIL_MAIN = {
    "granite-8b": dict(cut={}, B=4, prompt=4096, new_tokens=32),
    "llama3-405b": dict(cut={"n_layers": 2}, B=1, prompt=8192, new_tokens=32),
}
TAIL_CPU = dict(B=1, prompt=256, new_tokens=4)  # granite-8b full width, 2 layers, fp32: card ≡ CPU
COMPRESSION_STEPS = 5
COMPRESSION_TIMEOUT_S = 600


def _prefill_then_decode(params, cfg, toks, S0, forward=True):
    """Prefill ``toks[:, :S0]``, then decode the rest a token at a time →
    (the logits of every position from S0 − 1 on, [B, n, V], on the host;
    ``forward``'s logits at the same positions, or None)."""
    import torch

    from repro_torch.models import transformer as T

    lg, st = T.prefill(params, cfg, {"tokens": toks[:, :S0]}, cache_len=toks.shape[1])
    out = [lg[:, 0]]
    for i in range(S0, toks.shape[1]):
        lg, st = T.decode_step(params, cfg, toks[:, i:i + 1], st)
        out.append(lg[:, 0])
    fwd = None
    if forward:
        with torch.no_grad():
            fwd = T.forward(params, cfg, {"tokens": toks})[0][:, S0 - 1:].cpu()
    return torch.stack(out, 1).cpu(), fwd


def _tree_nbytes(tree):
    from repro_torch.utils.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree) if hasattr(x, "element_size"))


def lm_tail(dev):
    """granite-8b and llama3-405b on the card.  (a) granite at full width, 2
    layers, fp32, B 1 × 256 (+ 4 decode steps): card against CPU and
    prefill→decode against ``forward`` on the card, 5e-5·max|logits|, greedy
    tokens equal (the fp32 flash kernel, twice a layer).  (b) Each of
    ``TAIL_MAIN`` at bf16 over fp32 parameters: prefill (one launch of the
    bf16 kernel's (128, 128) instance a layer: 36 for granite, 2 for llama3),
    3 warm prefills, then ``serving/decode.generate`` of 32 greedy tokens
    (its prefill's launches and none more); the dry run's FLOP count for
    the same cell (its depth, the card mesh, fp32 parameters) equal to
    ``FlopCounterMode``'s over a warm prefill on the card, the achieved
    TFLOP/s and its share of the dense bf16 peak; ``tree_bytes`` of the
    card's parameters and caches equal to the bytes the card holds.
    llama3 also prefills→decodes against ``forward`` in fp32 on the same
    parameters (B 1 × 256 + 4, 5e-5·max|logits|).  Returns the bf16
    launches by path."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, hlo_analysis as H
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding
    from repro_torch.serving import decode as serve
    from repro_torch.utils.tree import tree_leaves

    cpu, card = torch.device("cpu"), make_card_mesh()

    def fp32_check(name, cfg, params_gpu, params_cpu=None):
        """prefill + decode on the card against the CPU (when given) and
        against ``forward`` on the card, fp32 (cfg's parameters as they are)."""
        B, S0, NEW = TAIL_CPU["B"], TAIL_CPU["prompt"], TAIL_CPU["new_tokens"]
        toks = torch.randint(0, cfg.vocab_size, (B, S0 + NEW), generator=torch.Generator().manual_seed(1))
        kernels.reset_launch_counts()
        gpu, fwd = _prefill_then_decode(params_gpu, cfg, toks.to(dev), S0)
        launches = kernels.instance_counts()
        scale = float(gpu.abs().max())
        row = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype, "B": B, "prompt": S0,
               "decode_steps": NEW, "max_abs_err_vs_forward": float((gpu - fwd).abs().max()), "atol": 5e-5 * scale,
               "flash_launches": launches}
        if params_cpu is not None:
            ref, _ = _prefill_then_decode(params_cpu, cfg, toks, S0, forward=False)
            row["max_abs_err_vs_cpu"] = float((gpu - ref).abs().max())
            row["greedy_tokens_equal"] = torch.equal(gpu.argmax(-1), ref.argmax(-1))
            require(row["max_abs_err_vs_cpu"] <= 5e-5 * float(ref.abs().max()),
                    f"{name}: logits on the card differ from the CPU: {row['max_abs_err_vs_cpu']}")
            require(row["greedy_tokens_equal"], f"{name}: greedy tokens differ between card and CPU")
        emit({"lm_tail_fp32": row})
        require(launches == {"flash_attention_bf16": 0, "flash_attention_f32": 2 * cfg.n_layers},
                f"{name}: fp32 prefill + forward made flash launches {launches}")
        require(row["max_abs_err_vs_forward"] <= 5e-5 * scale,
                f"{name}: prefill→decode differs from forward on the card: {row['max_abs_err_vs_forward']}")

    cfg_s = dataclasses.replace(ARCHS["granite-8b"], n_layers=2, dtype="float32")
    p_cpu = T.init_params(cfg_s, torch.Generator().manual_seed(0), cpu)
    p_gpu = _tree_to(p_cpu, dev)
    fp32_check("granite-8b", cfg_s, p_gpu, p_cpu)
    del p_cpu, p_gpu

    by_path = {}
    for name, spec in TAIL_MAIN.items():
        cfg = dataclasses.replace(ARCHS[name], **spec["cut"])
        B, S0, NEW = spec["B"], spec["prompt"], spec["new_tokens"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident_before = torch.cuda.memory_allocated()
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        prompt = torch.randint(0, cfg.vocab_size, (B, S0), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        batch, C = {"tokens": prompt}, S0 + NEW
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()  # counts of this model's path only
        t0 = time.perf_counter()
        logits, state = T.prefill(params, cfg, batch, cache_len=C)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches, prefill_by_instance = kernels.instance_counts(), _by_instance()
        require(bool(torch.isfinite(logits).all()), f"{name}: prefill logits not finite")
        require(prefill_launches == {"flash_attention_bf16": cfg.n_layers, "flash_attention_f32": 0}
                and prefill_by_instance == {wgmma_key(128, 128): cfg.n_layers},
                f"{name}: prefill's flash launches {prefill_launches}, {prefill_by_instance}, not {cfg.n_layers} "
                f"of (128, 128)")
        by_path[f"{name} prefill"] = prefill_launches["flash_attention_bf16"]
        # the trees the card holds, as the dry run's accounting counts them on the card's mesh
        rules = sharding.rules_for(cfg, card, kind="prefill", global_batch=B, seq_len=S0)
        held = {"params": (H.tree_bytes(params, T.param_specs(cfg), card, rules), _tree_nbytes(params)),
                "caches": (H.tree_bytes(state, T.cache_specs(cfg), card, rules), _tree_nbytes(state))}
        del logits, state
        warm = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = T.prefill(params, cfg, batch, cache_len=C)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            del again
        with FlopCounterMode(display=False) as fc:
            T.prefill(params, cfg, batch, cache_len=C)
        card_flops = fc.get_total_flops()
        dry = dryrun.trace_cell(cfg, ShapeConfig(f"{name}_prefill", "prefill", S0, B), card)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve.generate(params, cfg, prompt, NEW)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        gen_launches, gen_by_instance = kernels.instance_counts(), _by_instance()
        peak = torch.cuda.max_memory_allocated()
        achieved, peak_tflops = card_flops / min(warm) / 1e12, PEAK_FLOPS["torch.bfloat16"] / 1e12
        row = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": ARCHS[name].n_layers, "params": n_params,
               "B": B, "prompt": S0, "new_tokens": NEW, "prefill_s": prefill_s, "prefill_warm_s": warm,
               "prefill_warm_tokens_per_s": B * S0 / min(warm), "generate_s": generate_s,
               "generate_tokens_per_s": B * NEW / generate_s,
               "decode_tokens_per_s_after_warm_prefill": B * NEW / (generate_s - min(warm)),
               "peak_device_bytes": peak, "resident_before_bytes": resident_before,
               "flash_launches_prefill": prefill_launches, "flash_launches_prefill_by_instance": prefill_by_instance,
               "flash_launches_generate": gen_launches, "flops_card": card_flops, "flops_dryrun": dry["flops_global"],
               "dryrun_trace_s": dry["trace_s"], "dryrun_argument_bytes": dry["memory"]["argument_bytes"],
               "achieved_tflop_per_s": achieved, "share_of_bf16_peak": achieved / peak_tflops,
               "tree_bytes_vs_held": held, "tokens_row0": out[0, S0:S0 + 8].tolist()}
        print(f"{name}: prefill {B} × {S0} achieves {achieved:.1f} TFLOP/s, {100 * achieved / peak_tflops:.1f}% "
              f"of the {peak_tflops:.0f} TFLOP/s dense bf16 peak", flush=True)
        emit({"lm_tail": row})
        require(tuple(out.shape) == (B, S0 + NEW) and torch.equal(out[:, :S0], prompt), f"{name}: generate's tokens")
        require(gen_launches == prefill_launches and gen_by_instance == prefill_by_instance,
                f"{name}: generate made flash launches {gen_launches}, not its prefill's alone")
        require(card_flops == dry["flops_global"] > 0,
                f"{name}: FLOPs on the card {card_flops} ≠ the dry run's {dry['flops_global']}")
        require(all(a == b for a, b in held.values()), f"{name}: tree_bytes ≠ the bytes the card holds: {held}")
        if name == "llama3-405b":
            fp32_check(name, dataclasses.replace(cfg, dtype="float32"), params)
        del params, prompt, batch, out
    torch.cuda.empty_cache()
    return by_path


def compression_worker(rank, port, device, out):
    """One of two processes of ``compression_on_card``: a gloo group, then
    ``compressed_mean_grads`` for ``COMPRESSION_STEPS`` steps over the leaf
    shapes of two full-width qwen3-1.7b layers, on ``device`` and, from the
    same seeded gradients copied to the host, on the CPU, each carrying its
    residual; writes each step's error against the exact mean, whether card
    ≡ CPU bitwise, and a digest of the mean (both ranks must hold the same)
    to ``out``."""
    import hashlib

    import torch
    import torch.distributed as torch_dist

    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.parallel.compression import compressed_mean_grads, init_residual
    from repro_torch.utils.tree import tree_leaves, tree_map

    torch_dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"], n_layers=2)
    layers = T.init_params(cfg, torch.Generator(), torch.device("meta"))["layers"]  # shapes only

    def grads(step, member):
        g = torch.Generator(device=device).manual_seed(1000 * step + member)
        return tree_map(lambda x: (1 + member) * torch.randn(x.shape, generator=g, device=device), layers)

    def host(tree):
        return tree_leaves(tree_map(lambda x: x.cpu(), tree))

    rows, r_card, r_cpu = [], None, None
    for step in range(COMPRESSION_STEPS):
        g = grads(step, rank)
        g_cpu = tree_map(lambda x: x.cpu(), g)
        r_card, r_cpu = (r_card, r_cpu) if r_card else (init_residual(g), init_residual(g_cpu))
        t0 = time.perf_counter()
        mean, r_card = compressed_mean_grads(g, r_card)
        if device != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        mean_cpu, r_cpu = compressed_mean_grads(g_cpu, r_cpu)
        t2 = time.perf_counter()
        exact = tree_map(lambda a, b: (a + b) / 2, grads(step, 0), grads(step, 1))
        got = host(mean)
        rows.append({"step": step, "err": max(float((a - e).abs().max()) for a, e in zip(tree_leaves(mean),
                                                                                           tree_leaves(exact))),
                     "bound": 0.05 * max(float(e.abs().max()) for e in tree_leaves(exact)) + 1e-3,
                     "card_cpu_bitwise": all(torch.equal(a, b) for a, b in zip(got, tree_leaves(mean_cpu))),
                     "digest": hashlib.sha256(b"".join(a.numpy().tobytes() for a in got)).hexdigest(),
                     "s_card": t1 - t0, "s_cpu": t2 - t1})
        del g, g_cpu, mean, mean_cpu, exact, got
    residual_bitwise = all(torch.equal(a, b) for a, b in zip(host(r_card), tree_leaves(r_cpu)))
    n = sum(x.numel() for x in tree_leaves(r_cpu))
    torch_dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"rank": rank, "device": str(device), "elements": n, "steps": rows,
                   "residual_card_cpu_bitwise": residual_bitwise}, f)


def compression_on_card(root, device="cuda"):
    """Two processes on the one card in a gloo group (as ``campaign_mp``
    starts its workers), ``compressed_mean_grads`` over two full-width
    qwen3-1.7b layers' gradient shapes (CUDA tensors, 5 steps, the residual
    carried): each step's mean within the reference test's bound of the
    exact mean, bitwise the same processes' run on CPU tensors, and the same
    on both ranks."""
    from repro_torch.parallel.distributed import free_port

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    port = free_port()
    outs = [os.path.join(root, f"rank{r}.json") for r in range(2)]
    code = "import sys, chip_smoke; chip_smoke.compression_worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])"
    _, walls = _spawn([["-c", code, str(r), str(port), device, outs[r]] for r in range(2)], root, "compression",
                      COMPRESSION_TIMEOUT_S)
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    emit({"compression": {"ranks": ranks, "wall_s": walls, "leaves": "two qwen3-1.7b layers' gradients"}})
    for rk in ranks:
        for row in rk["steps"]:
            require(row["err"] < row["bound"], f"compression rank {rk['rank']} step {row['step']}: {row}")
            require(row["card_cpu_bitwise"], f"compression rank {rk['rank']} step {row['step']}: card ≠ CPU")
        require(rk["residual_card_cpu_bitwise"], f"compression rank {rk['rank']}: the residual card ≠ CPU")
    require(all(a["digest"] == b["digest"] for a, b in zip(ranks[0]["steps"], ranks[1]["steps"])),
            "compression: the two ranks hold different means")


def flex_mods(window, cap):
    """``flex_attention``'s score_mod (the softcap on the scaled score) and
    mask_mod (causal, and the window) of a softcapped row, Sq = Skv."""
    import torch

    def score_mod(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    def mask_mod(b, h, qi, ki):
        return (ki <= qi) if window is None else (ki <= qi) & (qi - ki < window)

    return score_mod, mask_mod


def flex_softcap(dev, S, window, cap, scale):
    """One PyTorch call of a softcapped row's whole function: ``flex_attention``
    compiled with ``flex_mods``, the mask as a block mask, GQA by
    ``enable_gqa``.  A yardstick only: the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    score_mod, mask_mod = flex_mods(window, cap)
    block_mask = create_block_mask(mask_mod, None, None, S, S, device=dev)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: flex(q, k, v, score_mod=score_mod, block_mask=block_mask, scale=scale, enable_gqa=True)


def flash_batch_check(dev):
    """The bf16 kernel at whisper-small's cross attention (the (64, 64)
    instance, B 8 × 12 heads, Sq 128 over 1,500 keys, non-causal, q, k and v
    strided as the layer gives them): each batch row of the B 8 launch
    bitwise the same row launched at B 1, and the launch within its limit of
    the plain version."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, H, Sq, Skv, d = 8, 12, 128, 1500, 64
    g = torch.Generator(device=dev).manual_seed(26)
    q = torch.randn((B, Sq, H, d), device=dev, generator=g).bfloat16().transpose(1, 2)
    k = torch.randn((B, Skv, H, d), device=dev, generator=g).bfloat16().transpose(1, 2)
    v = torch.randn((B, Skv, H, d), device=dev, generator=g).bfloat16().transpose(1, 2)
    before = fa_ops.wgmma_launch_counts()
    whole = fa_ops.flash_attention_cuda(q, k, v, causal=False)
    rows = [fa_ops.flash_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=False) for i in range(B)]
    torch.cuda.synchronize()
    ran = {inst: n - before[inst] for inst, n in fa_ops.wgmma_launch_counts().items() if n != before[inst]}
    same = [bool(torch.equal(whole[i:i + 1], rows[i])) for i in range(B)]
    ref32 = fa_ops.flash_attention_ref(q, k, v, causal=False).float()
    ratio = float(((whole.float() - ref32).abs() / bf16_limit(ref32)).max())
    out = {"check": "flash_batch", "B": B, "H": H, "Sq": Sq, "Skv": Skv, "launches_by_instance": str(ran),
           "bitwise_b8_vs_b1": same, "err_over_limit": ratio}
    require(ran == {(64, 64): B + 1}, f"the batch check launched the instances {ran}")
    require(all(same), f"the bf16 kernel's rows depend on the batch: {same}")
    require(ratio <= 1.0, f"the bf16 kernel disagrees with the plain version: {ratio} of its limit")
    return out


def family_flash_rows(dev, sdpa, launches):
    """timing's rows for the bf16 flash kernel at the families' prefill
    shapes (the instance ``wgmma_instance`` picks: (256, 256) for gemma2,
    (192, 128) for MLA, (128, 128) for mixtral's window of 4,096 at a GQA
    group of 6, for zamba2's dh 112 and for granite-8b's and llama3-405b's
    GQA groups of 4 and 16, (64, 64) for internvl2's GQA group of
    7 and whisper's non-causal encoder and cross attention and its causal
    decoder), laid out as the layers
    give them (q and k contiguous, v a transposed view of its projection):
    each against its plain version (per value: 2 ulp(|o|) + 2^-5 rms of its
    row), its bound, and the library call that computes the function: SDPA
    for the rows without a softcap (a window as a boolean mask, GQA by
    ``enable_gqa``), ``flex_softcap`` for gemma2 (held to the same limit),
    beside which gemma2's rows also give SDPA without the softcap and the
    kernel without it."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    report = ptxas_report(_build.ptxas_log())
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for name, paths, B, Hq, Hkv, Sq, S, dh, dv, causal, window, cap, scale in FAMILY_FLASH:
        instance = wgmma_name(*fa_ops.wgmma_instance(dh, dv))
        regs = {k: v for k, v in report.items() if k == instance}
        bf = torch.bfloat16
        q = torch.randn((B, Hq, Sq, dh), device=dev, generator=g).to(bf)
        k = torch.randn((B, Hkv, S, dh), device=dev, generator=g).to(bf)
        v = torch.randn((B, S, Hkv, dv), device=dev, generator=g).to(bf).transpose(1, 2)
        kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
        out_k, out_p = fa_ops.flash_attention_cuda(q, k, v, **kw), fa_ops.flash_attention_ref(q, k, v, **kw)
        ref32 = out_p.float()
        ratio = float(((out_k.float() - ref32).abs() / bf16_limit(ref32)).max())
        err = float((out_k.float() - ref32).abs().max())
        require(ratio <= 1.0, f"{name}: the bf16 flash kernel disagrees with its plain version: {ratio} of its limit")
        if cap is not None:
            t0 = time.perf_counter()
            flex = flex_softcap(dev, S, window, cap, scale)
            out_l = flex(q, k, v)
            torch.cuda.synchronize()
            flex_s = time.perf_counter() - t0
            flex_ratio = float(((out_l.float() - ref32).abs() / bf16_limit(ref32)).max())
            require(flex_ratio <= 1.0, f"{name}: flex_attention disagrees with the plain version: {flex_ratio}")
            del out_l
        del ref32, out_p
        flops = 2 * B * Hq * fa_ops.visible_pairs(Sq, S, causal, window) * (dh + dv)
        b_ms, by = bound(nbytes(q, k, v, out_k), flops, bf)
        ms = cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw), 10)
        if window is None:
            lib = lambda: sdpa(q, k, v, is_causal=causal, scale=scale, enable_gqa=Hq != Hkv)  # noqa: E731
        else:
            i, j = torch.arange(S - Sq, S, device=dev)[:, None], torch.arange(S, device=dev)[None, :]
            mask = (j <= i) & (i - j < window)
            lib = lambda: sdpa(q, k, v, attn_mask=mask, scale=scale, enable_gqa=Hq != Hkv)  # noqa: E731
        detail = {"launches_by_path": {p: launches[p] for p in paths}, "instance": instance, "B": B, "Hq": Hq,
                  "Hkv": Hkv, "Sq": Sq, "Skv": S, "dh": dh, "dv": dv, "window": window,
                  "softcap": cap, "scale": scale, "causal": causal, "v_strided": True, "flops": flops,
                  "bf16_err_over_limit": ratio, "bf16_limit": "2 ulp(|o|) + 2^-5 rms(o row)",
                  "tflop_per_s": flops / (ms / 1e3) / 1e12, "share_of_bound": b_ms / ms, "registers_spills": regs}
        detail["sdpa_form"] = ("boolean window mask" if window is not None else "is_causal" if causal
                               else "no mask")
        if cap is None:
            library_ms = cuda_ms(lib, 10)
        else:
            library_ms = cuda_ms(lambda: flex(q, k, v), 10)
            detail["library"] = {"call": "flex_attention, compiled: softcap score_mod, causal/window block mask",
                                 "err_over_limit": flex_ratio, "build_and_first_call_s": flex_s}
            plain_kw = dict(kw, softcap=None)  # a comparison only: both without the softcap
            detail["comparison_without_softcap"] = {
                "kernel_ms": cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **plain_kw), 10),
                "sdpa_ms": cuda_ms(lib, 3), "note": "SDPA has no softcap: not the path's function"}
        rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
                     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83",
                     "launches": sum(launches[p] for p in paths), "max_abs_err": err, "ms": ms,
                     "plain_ms": cuda_ms(lambda: fa_ops.flash_attention_ref(q, k, v, **kw), 1),
                     "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms, "detail": detail})
        del q, k, v, out_k, lib
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core import faults, health, hetmem
    from repro_torch.core.stream import tree_map
    from repro_torch.fem import assembly, meshgen, methods, multispring as ms, spmv
    from repro_torch.kernels import _build
    from repro_torch.kernels.ebe_matvec import ops as ebe_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.multispring import ops as ms_ops
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.serving import decode as serve
    from repro_torch.utils.tree import tree_leaves

    # plain versions run on the card below: full fp32, no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    with Phase("device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        emit({"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    with Phase("build"):
        lib = _build.build()
        _build.library()
        emit({"registers_spills": ptxas_report(_build.ptxas_log()),
              "wgmma_blocks_per_sm": {wgmma_name(*inst): n for inst, n in fa_ops.wgmma_blocks_per_sm().items()}})
        emit({"sass_static_counts": sass_fp64_counts(lib, _build._nvcc())})

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    with Phase("kernels"):
        K = ms.STATE_KEYS
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 3e-5)):
            # P not a multiple of the block's points; S 195 takes two staged chunks
            for gmf, S in ((1e-3, 150), (0.3, 150), (1e-3, 195)):
                rng = np.random.default_rng(7)
                P = 29
                prm = ms.SpringParams(*(torch.tensor(rng.uniform(lo, hi, P), dtype=dt, device=dev)
                                        for lo, hi in ((5e7, 5e8), (5e-4, 5e-3), (0.7, 1.0), (1e8, 1e9))),
                                      g_min_frac=gmf)
                n, w = (torch.tensor(a, dtype=dt, device=dev) for a in ms.spring_directions(S))
                st_p = ms.init_state(P, S, dt, device=dev)
                st_k = {k: v.clone() for k, v in st_p.items()}
                eps = torch.zeros((P, 6), dtype=dt, device=dev)
                worst = 0.0
                for _ in range(6):
                    eps = eps + torch.tensor(rng.normal(scale=8e-4, size=(P, 6)), dtype=dt, device=dev)
                    sp, Dp, st_p, fp = ms_ops.multispring_ref(eps, st_p, prm, n, w)
                    sk, Dk, st_k, fk = ms_ops.multispring_cuda(eps, st_k, prm, n, w)
                    torch.cuda.synchronize()
                    worst = max(worst, rel_err(sk, sp), rel_err(Dk, Dp))
                    for key in ms.FLAG_KEYS:
                        require(st_k[key].dtype == torch.int32 and torch.equal(st_k[key], st_p[key]),
                                f"multispring flags {key} differ ({dt}, g_min_frac={gmf})")
                    require(torch.allclose(fk, fp, rtol=1e-4, atol=1e-6), "multispring frac differs")
                for key in K[:4]:
                    worst = max(worst, rel_err(st_k[key], st_p[key]))
                emit({"check": "multispring", "dtype": str(dt), "g_min_frac": gmf, "P": P, "S": S,
                      "max_rel_err": worst, "tol": tol})
                require(worst <= tol, f"multispring disagrees: {worst} > {tol}")
            g = torch.Generator(device=dev).manual_seed(1)
            etol = 1e-13 if dt == torch.float64 else 5e-6
            N = 400
            # E not a multiple of a tile, and E smaller than one
            for E, tiles in ((1001, (ebe_ops.TILE_E, 4, 64)), (5, (ebe_ops.TILE_E,))):
                x = torch.randn((N, 3), dtype=dt, device=dev, generator=g)
                conn = torch.randint(0, N, (E, 10), device=dev, generator=g, dtype=torch.int32)
                conn[::3, 9] = conn[::3, 0]  # repeated nodes within an element
                Q = torch.randn((E, 4, 6, 6), dtype=torch.float64, device=dev, generator=g)
                D = (Q @ Q.transpose(-1, -2)).to(dt).contiguous()
                Jinv = torch.randn((E, 3, 3), dtype=dt, device=dev, generator=g)
                wdet = torch.rand((E, 4), dtype=dt, device=dev, generator=g)
                coef = torch.rand((E,), dtype=dt, device=dev, generator=g) + 0.5
                u = spmv.gather_elem(x, conn.long())
                for c in (coef, None):
                    ref = ebe_ops.ebe_element_matvec_ref(u, D, Jinv, wdet, c)
                    for te in tiles:
                        err = rel_err(ebe_ops.ebe_matvec_cuda(x, conn, D, Jinv, wdet, c, tile_e=te), ref)
                        emit({"check": "ebe_matvec", "dtype": str(dt), "E": E, "N": N, "tile_e": te,
                              "coef": c is not None, "max_rel_err": err, "tol": etol})
                        require(err <= etol, f"ebe_matvec disagrees: {err} > {etol} (E {E}, tile_e {te})")

        # the k-set entries: k members in one launch, against the plain k-set
        # version and bitwise against k one-member launches (fp32 E 997 puts
        # members 1 and 2 off the 16-byte alignment of the bulk copies)
        for dt, etol in ((torch.float64, 1e-13), (torch.float32, 5e-6)):
            g = torch.Generator(device=dev).manual_seed(2)
            N = 400
            for E in (1001, 997, 5):
                conn = torch.randint(0, N, (E, 10), device=dev, generator=g, dtype=torch.int32)
                Jinv = torch.randn((E, 3, 3), dtype=dt, device=dev, generator=g)
                wdet = torch.rand((E, 4), dtype=dt, device=dev, generator=g)
                for k in (1, 2, 3):
                    x = torch.randn((k, N, 3), dtype=dt, device=dev, generator=g)
                    Q = torch.randn((k, E, 4, 6, 6), dtype=torch.float64, device=dev, generator=g)
                    D = (Q @ Q.transpose(-1, -2)).to(dt).contiguous()
                    coef = torch.rand((k, E), dtype=dt, device=dev, generator=g) + 0.5
                    for c in (coef, None):
                        fk = ebe_ops.ebe_matvec_kset_cuda(x, conn, D, Jinv, wdet, c)
                        fp = ebe_ops.ebe_element_matvec_kset_ref(x, conn.long(), D, Jinv, wdet, c)
                        ones = torch.stack([ebe_ops.ebe_matvec_cuda(x[i].contiguous(), conn, D[i].clone(), Jinv, wdet,
                                                                    None if c is None else c[i].clone())
                                            for i in range(k)])
                        torch.cuda.synchronize()
                        err, same = rel_err(fk, fp), torch.equal(fk, ones)
                        emit({"check": "ebe_matvec_kset", "dtype": str(dt), "k": k, "E": E, "N": N,
                              "coef": c is not None, "max_rel_err": err, "tol": etol, "bitwise_vs_one_member": same})
                        require(err <= etol, f"ebe_matvec k-set disagrees: {err} > {etol} (k {k}, E {E})")
                        require(same, f"ebe_matvec k-set ≠ {k} one-member launches (E {E}, {dt})")
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 3e-5)):
            rng = np.random.default_rng(8)
            k, P, S = 2, 29, 150
            prm = ms.SpringParams(*(torch.tensor(rng.uniform(lo, hi, P), dtype=dt, device=dev)
                                    for lo, hi in ((5e7, 5e8), (5e-4, 5e-3), (0.7, 1.0), (1e8, 1e9))))
            n, w = (torch.tensor(a, dtype=dt, device=dev) for a in ms.spring_directions(S))
            st_k = {key: v.expand(k, P, S).clone() for key, v in ms.init_state(P, S, dt, device=dev).items()}
            st_p = {key: v.clone() for key, v in st_k.items()}
            eps = torch.zeros((k, P, 6), dtype=dt, device=dev)
            worst, same = 0.0, True
            for _ in range(6):
                eps = eps + torch.tensor(rng.normal(scale=8e-4, size=(k, P, 6)), dtype=dt, device=dev)
                out_k = ms_ops.multispring_kset_cuda(eps, st_k, prm, n, w)
                out_p = ms_ops.multispring_kset_ref(eps, st_p, prm, n, w)
                ones = [ms_ops.multispring_cuda(eps[i].contiguous(), {key: v[i].contiguous() for key, v in st_k.items()},
                                                prm, n, w) for i in range(k)]
                torch.cuda.synchronize()
                for key in ms.FLAG_KEYS:
                    require(torch.equal(out_k[2][key], out_p[2][key]), f"multispring k-set flags {key} differ ({dt})")
                worst = max(worst, rel_err(out_k[0], out_p[0]), rel_err(out_k[1], out_p[1]))
                same &= all(torch.equal(out_k[j][i], ones[i][j]) for i in range(k) for j in (0, 1, 3))
                same &= all(torch.equal(out_k[2][key][i], ones[i][2][key]) for i in range(k) for key in ms.STATE_KEYS)
                st_k, st_p = out_k[2], out_p[2]
            emit({"check": "multispring_kset", "dtype": str(dt), "k": k, "P": P, "S": S, "max_rel_err": worst,
                  "tol": tol, "flags_equal": True, "bitwise_vs_one_member": same})
            require(worst <= tol, f"multispring k-set disagrees: {worst} > {tol}")
            require(same, f"multispring k-set ≠ {k} one-member launches ({dt})")

        for case in FLASH_CASES:
            B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, cap, strided = case
            for dt in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(Sq * 1000 + Skv)

                def heads(H, S, d):  # [B,H,S,d], or a transposed view of [B,S,H,d] as the layer gives
                    shape = (B, S, H, d) if strided else (B, H, S, d)
                    x = torch.randn(shape, device=dev, generator=g).to(dt)
                    return x.transpose(1, 2) if strided else x

                q, k, v = heads(Hq, Sq, dh), heads(Hkv, Skv, dh), heads(Hkv, Skv, dv)
                kw = dict(causal=causal, window=window, softcap=cap)
                before = kernels.instance_counts()
                out_k = fa_ops.flash_attention_cuda(q, k, v, **kw)
                ran = {n: c - before[n] for n, c in kernels.instance_counts().items()}
                require(ran == {n: int(n == fa_ops.COUNTERS[dt].name) for n in ran},
                        f"flash {dt} went through {ran}, not {fa_ops.COUNTERS[dt].name} alone")
                out_p = fa_ops.flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err = float((out_k.float() - out_p.float()).abs().max())
                tol = FLASH_TOL[str(dt)]
                emit({"check": "flash_attention", "dtype": str(dt), "case": case, "max_abs_err": err,
                      "tol": tol})
                require(out_k.dtype == dt and tuple(out_k.shape) == (B, Hq, Sq, dv), "flash output shape/dtype")
                require(err <= tol, f"flash_attention disagrees: {err} > {tol} at {case} ({dt})")
        for case in FLASH_EDGE_CASES:
            B, Hq, Hkv, Sq, Skv, dh, dv, window, cap, scale, q_scale = case
            g = torch.Generator(device=dev).manual_seed(Sq * 1000 + Skv)
            q = (q_scale * torch.randn((B, Hq, Sq, dh), device=dev, generator=g)).bfloat16()
            k = torch.randn((B, Hkv, Skv, dh), device=dev, generator=g).bfloat16()
            v = torch.randn((B, Skv, Hkv, dv), device=dev, generator=g).bfloat16().transpose(1, 2)
            kw = dict(causal=True, window=window, softcap=cap, scale=scale)
            before = fa_ops.wgmma_launch_counts()
            out_k = fa_ops.flash_attention_cuda(q, k, v, **kw)
            ran = [inst for inst, n in fa_ops.wgmma_launch_counts().items() if n != before[inst]]
            require(ran == [fa_ops.wgmma_instance(dh, dv)], f"flash bf16 at {case} launched the instances {ran}")
            ref32 = fa_ops.flash_attention_ref(q, k, v, **kw).float()
            torch.cuda.synchronize()
            ratio = float(((out_k.float() - ref32).abs() / bf16_limit(ref32)).max())
            emit({"check": "flash_attention_edge", "dtype": "torch.bfloat16", "case": case,
                  "instance": wgmma_name(*ran[0]),
                  "max_abs_err": float((out_k.float() - ref32).abs().max()), "err_over_limit": ratio,
                  "limit": "2 ulp(|o|) + 2^-5 rms(o row)"})
            require(tuple(out_k.shape) == (B, Hq, Sq, dv), "flash output shape")
            require(ratio <= 1.0, f"flash_attention bf16 disagrees at {case}: {ratio} of its limit")
        emit(flash_batch_check(dev))

    def wave_for(nt, dt):
        t = np.arange(nt) * dt
        wave = np.zeros((nt, 3))
        wave[:, 0] = 0.3 * np.sin(2 * np.pi * 2.0 * t + 0.5)  # nonzero from step 0
        wave[:, 2] = 0.1 * np.cos(2 * np.pi * 1.5 * t)
        return wave

    with Phase("cpu"):
        mesh = meshgen.generate(8, 8, 4, pad_elems_to=8)
        cfg = methods.SeismicConfig(dt=0.01, npart=4, nspring=30, maxiter=600)
        wave = wave_for(3, cfg.dt)
        r_cpu = methods.run(mesh, cfg, wave, device="cpu")
        r_gpu = methods.run(mesh, cfg, wave, device=dev)
        a = r_cpu["velocity_history"].numpy()
        b = r_gpu["velocity_history"].cpu().numpy()
        err = float(np.abs(a - b).max())
        atol = 1e-6 * float(np.abs(a).max())
        emit({"check": "gpu_vs_cpu", "mesh": [8, 8, 4], "max_abs_err_v": err, "atol": atol,
              "iters_cpu": r_cpu["iters"].tolist(), "iters_gpu": r_gpu["iters"].tolist()})
        require(np.abs(a).max() > 0 and err <= atol, "port on the card disagrees with the port on the CPU")
        require(float((r_gpu["u"].cpu() - r_cpu["u"]).abs().max()) <= 1e-6 * float(r_cpu["u"].abs().max()),
                "u differs between card and CPU")

    with Phase("prefetch"):
        mesh = meshgen.generate(16, 16, 8, pad_elems_to=8)
        cfg = methods.SeismicConfig(dt=0.01, npart=4, nspring=30, maxiter=600)
        wave = wave_for(3, cfg.dt)
        serial = methods.run(mesh, cfg, wave, device=dev)
        for sched in ("prefetch", "donate"):  # donate: two device buffers per leaf, reused
            pre = methods.run(mesh, dataclasses.replace(cfg, schedule=sched, prefetch=1), wave, device=dev)
            same_u = torch.equal(serial["u"], pre["u"])
            same_theta = all(torch.equal(x, y) for bs, bp in zip(serial["carry"][1].blocks, pre["carry"][1].blocks)
                             for x, y in zip(bs, bp))
            emit({"check": f"{sched}_vs_serial", "mesh": [16, 16, 8], "u_bitwise": same_u,
                  "theta_bitwise": same_theta})
            require(same_u and same_theta, f"{sched} is not bitwise serial on the card")

    def rungs_disagree(runs, ref, rel):
        """Each run's velocity history against ``ref``'s over their common
        steps, held to ``rel[m]``·max|v|."""
        v0 = runs[ref]["velocity_history"].cpu()
        scale = float(v0.abs().max())
        require(scale > 0, "the wave moved nothing")
        out = {}
        for m, r in runs.items():
            if m != ref:
                v = r["velocity_history"].cpu()[:v0.shape[0]]
                n = v.shape[0]
                err = float((v - v0[:n]).abs().max())
                atol = rel[m] * scale
                out[m] = {"max_abs_err_v": err, "rel_err_v": err / scale, "atol": atol,
                          "bitwise": torch.equal(v, v0[:n]), "steps": n}
                require(err <= atol, f"{m} disagrees with {ref}: {err} > {atol}")
        return out

    with Phase("crs_check"):
        mesh_c = meshgen.generate(8, 8, 4, pad_elems_to=8)
        # solved to 1e-10: at the default 1e-8 the CRS PCG stops near 9e-9 while
        # flexible CG lands near 1e-10, and Proposed 2 sits 1.149e-5·max|v| off
        # Baseline 1 on this mesh in the JAX package too; at 1e-10 both packages
        # put it 3.1e-7 off, so the comparison measures the physics
        cfg_c = methods.SeismicConfig(dt=0.01, npart=4, nspring=30, maxiter=600, tol=1e-10)
        wave_c = wave_for(3, cfg_c.dt)
        card, ran = {}, {}
        for m in methods.METHODS:
            kernels.reset_launch_counts()
            card[m] = methods.run(mesh_c, cfg_c, wave_c, method=m, device=dev)
            ran[m] = kernels.launch_counts()
            require(bool(card[m]["converged"].all()), f"{m} did not converge")
        vs_b1 = rungs_disagree(card, "baseline1", {"baseline2": 1e-12, "proposed1": 1e-12, "proposed2": 1e-5})
        vs_cpu = {}
        for m in CRS_STEPS:
            r_cpu = methods.run(mesh_c, cfg_c, wave_c, method=m, device="cpu")
            vs_cpu[m] = rungs_disagree({"cpu": r_cpu, "gpu": card[m]}, "cpu", {"gpu": 1e-6})["gpu"]
            vs_cpu[m]["iters_cpu"], vs_cpu[m]["iters_gpu"] = r_cpu["iters"].tolist(), card[m]["iters"].tolist()
        pre = methods.run(mesh_c, dataclasses.replace(cfg_c, schedule="prefetch", prefetch=1), wave_c,
                          method="proposed1", device=dev)
        same_u = torch.equal(pre["u"], card["proposed1"]["u"])
        same_theta = all(torch.equal(x, y) for bs, bp in zip(card["proposed1"]["carry"][1].blocks,
                                                              pre["carry"][1].blocks) for x, y in zip(bs, bp))
        b2_theta = card["baseline2"]["carry"][1]
        emit({"check": "crs_rungs", "mesh": [8, 8, 4], "nspring": cfg_c.nspring, "steps": 3,
              "vs_baseline1": vs_b1, "card_vs_cpu": vs_cpu, "launches": ran,
              "proposed1_prefetch_vs_serial": {"u_bitwise": same_u, "theta_bitwise": same_theta},
              "baseline2_theta_devices": sorted({str(x.device) for x in b2_theta.values()})})
        require(same_u and same_theta, "Proposed 1 prefetch(1) is not bitwise serial on the card")
        for m in CRS_STEPS:  # Baseline 2 computes the multispring on the host, the others launch the kernel
            require((ran[m]["multispring"] == 0) == (m == "baseline2"), f"{m} made multispring launches {ran[m]}")
            require(ran[m]["ebe_matvec_f64"] == ran[m]["ebe_matvec_f32"] == 0, f"{m} launched the EBE kernel")
        require(all(x.device.type == "cpu" for x in b2_theta.values()), "Baseline 2's θ left the host")
        del card, pre, r_cpu

    def kset_waves(M, nt, dt):
        t = np.arange(nt) * dt
        waves = np.zeros((M, nt, 3))
        for i in range(M):  # nonzero from step 0, a different case per lane
            waves[i, :, 0] = (0.3 - 0.05 * i) * np.sin(2 * np.pi * (2.0 + 0.5 * i) * t + 0.5 + 0.3 * i)
            waves[i, :, 2] = 0.1 * np.cos(2 * np.pi * 1.5 * t + 0.2 * i)
        return waves

    with Phase("kset_check"):
        # the k-set ensembles (run_ensemble, M 3) of all four methods on crs_check's
        # mesh and config: card ≡ CPU port, each lane ≡ its own run on the card
        every_c = np.arange(mesh_c.n_nodes)
        waves_c = kset_waves(3, 3, cfg_c.dt)
        kset_rows = {}
        for m in methods.METHODS:
            kernels.reset_launch_counts()
            card = methods.run_ensemble(mesh_c, cfg_c, waves_c, method=m, device=dev, observe=every_c)
            ran_k = kernels.launch_counts()
            cpu = methods.run_ensemble(mesh_c, cfg_c, waves_c, method=m, device="cpu", observe=every_c)
            v_card = card["velocity_history"].cpu()
            scale = float(cpu["velocity_history"].abs().max())
            err_cpu = float((v_card - cpu["velocity_history"]).abs().max())
            lanes = []
            for i in range(3):
                solo = methods.run(mesh_c, cfg_c, waves_c[i], method=m, device=dev, observe=every_c)
                v_solo = solo["velocity_history"].cpu()
                lanes.append({"rel_err_v": float((v_card[i] - v_solo).abs().max()) / float(v_solo.abs().max()),
                              "iters": card["iters"][i].tolist(), "iters_solo": solo["iters"].tolist()})
            kset_rows[m] = {"card_vs_cpu_rel": err_cpu / scale, "iters_card": card["iters"].tolist(),
                            "iters_cpu": cpu["iters"].tolist(), "lanes_vs_solo": lanes, "launches": ran_k}
            require(scale > 0 and bool(card["converged"].all()), f"{m} k-set: did not converge or moved nothing")
            require(err_cpu <= 1e-6 * scale, f"{m} k-set on the card disagrees with the CPU port: {err_cpu / scale}")
            require(all(x["rel_err_v"] <= 1e-9 for x in lanes), f"{m} k-set lane disagrees with its own run: {lanes}")
            require(ran_k["ebe_matvec_f64"] == ran_k["ebe_matvec_f32"] == 0, f"{m} k-set made one-member EBE launches")
            require((ran_k["ebe_matvec_kset_f64"] > 0) == (m == "proposed2"), f"{m} k-set EBE launches {ran_k}")
            require((ran_k["multispring_kset"] > 0) == (m != "baseline2"), f"{m} k-set multispring launches {ran_k}")
        # Proposed 1's k-set with θ in pinned host blocks updated in place ≡ θ on the card
        ops_c = methods.FemOperators(mesh_c, cfg_c, device=dev)
        outs = {}
        for offload in (True, False):
            step, carry = methods.make_ensemble_step(ops_c, "proposed1", kset=3, offload=offload)
            for f_t in torch.as_tensor(waves_c, device=dev).unbind(1):
                carry, _ = step(carry, f_t)
            torch.cuda.synchronize()
            outs[offload] = carry
        theta_pinned = all(hetmem.is_pinned_host(x) for blk in outs[True][1].blocks for x in blk)
        same_u = torch.equal(outs[True][0].u, outs[False][0].u)
        same_theta = all(torch.equal(x.to(dev), y) for b1, b2 in zip(outs[True][1].blocks, outs[False][1].blocks)
                         for x, y in zip(b1, b2))
        del outs, ops_c
        # a NaN in lane 1's forcing at step 1, guarded (Proposed 2, 2SET form)
        cfg_h = dataclasses.replace(cfg_c, health=True)
        poisoned = faults.nan_at_step(waves_c, 1, case=1)
        clean = methods.run_ensemble(mesh_c, cfg_h, waves_c, device=dev, observe=every_c)
        bad = methods.run_ensemble(mesh_c, cfg_h, poisoned, device=dev, observe=every_c)
        bad_cpu = methods.run_ensemble(mesh_c, cfg_h, poisoned, device="cpu", observe=every_c)
        siblings = all(torch.equal(bad["velocity_history"][i], clean["velocity_history"][i]) for i in (0, 2))
        emit({"check": "kset", "mesh": [8, 8, 4], "nspring": cfg_c.nspring, "steps": 3, "M": 3, "methods": kset_rows,
              "proposed1_offload_vs_resident": {"u_bitwise": same_u, "theta_bitwise": same_theta,
                                                "theta_pinned_host": theta_pinned},
              "health": {"words": bad["health"].tolist(), "words_cpu": bad_cpu["health"].tolist(),
                         "words_clean": clean["health"].tolist(), "nonconverged": bad["nonconverged"].tolist(),
                         "siblings_bitwise": siblings,
                         "finite": bool(torch.isfinite(bad["velocity_history"]).all())}})
        require(same_u and same_theta and theta_pinned, "Proposed 1 k-set: offload=True is not bitwise offload=False")
        require(torch.equal(bad["health"], bad_cpu["health"]), "health words differ between card and CPU")
        require(torch.equal(bad["nonconverged"], bad_cpu["nonconverged"]), "nonconverged counts differ")
        require(bad["health"].tolist()[0] == bad["health"].tolist()[2] == 0 and bad["health"].tolist()[1] != 0,
                f"the NaN did not trip lane 1 alone: {bad['health'].tolist()}")
        require(clean["health"].tolist() == [0, 0, 0], "a clean guarded run tripped")
        require(siblings, "the poisoned lane changed its siblings")
        require(bool(torch.isfinite(bad["velocity_history"]).all()), "NaN entered the frozen lane's carry")
        del card, cpu, solo, clean, bad, bad_cpu

        # Proposed 1's k-set with θ offloaded (pinned host blocks), guarded: the
        # guard gives θ a second pinned set; a NaN in lane 1's forcing at step 1
        def offloaded_p1(device, waves, guard):
            ops_g = methods.FemOperators(mesh_c, cfg_c, device=device)
            step, carry = methods.make_ensemble_step(ops_g, "proposed1", kset=3, offload=True)
            if guard:
                step, carry = health.guard_step(step), health.initial_guard_carry(carry)
            obs, vel, theta_before = torch.as_tensor(every_c, device=device), [], None
            for t, f_t in enumerate(torch.as_tensor(waves, device=device).unbind(1)):
                if t == 1 and guard:  # lane 1's last healthy θ
                    theta_before = [x[1].clone() for blk in carry[0][1].blocks for x in blk]
                carry, _ = step(carry, f_t)
                vel.append((carry[0][0] if guard else carry[0]).v[:, obs])
            if device.type == "cuda":
                torch.cuda.synchronize()
            return carry, torch.stack(vel, dim=1).cpu(), theta_before

        cpu_dev = torch.device("cpu")
        g_bad, v_bad, theta_before = offloaded_p1(dev, poisoned, True)
        g_cpu, v_cpu, _ = offloaded_p1(cpu_dev, poisoned, True)
        _, v_clean, _ = offloaded_p1(dev, waves_c, True)
        _, v_plain, _ = offloaded_p1(dev, waves_c, False)
        theta = g_bad[0][1]
        sets = {"blocks": theta.blocks, "spare": theta.spare}
        lane1_frozen = {name: all(torch.equal(x[1], y) for x, y in zip((x for blk in blocks for x in blk), theta_before))
                        for name, blocks in sets.items()}
        pinned = {name: all(hetmem.is_pinned_host(x) for blk in blocks for x in blk) for name, blocks in sets.items()}
        set_bytes = {name: sum(x.numel() * x.element_size() for blk in blocks for x in blk)
                     for name, blocks in sets.items()}
        scale_p1 = float(v_cpu[[0, 2]].abs().max())
        err_p1 = float((v_bad - v_cpu).abs().max())
        sib_p1 = all(torch.equal(v_bad[i], v_clean[i]) for i in (0, 2))
        emit({"check": "kset_guarded_offloaded", "method": "proposed1", "mesh": [8, 8, 4], "M": 3, "steps": 3,
              "nan": {"step": 1, "lane": 1}, "words": g_bad[1].tolist(), "words_cpu": g_cpu[1].tolist(),
              "nonconverged": g_bad[2].tolist(), "nonconverged_cpu": g_cpu[2].tolist(),
              "card_vs_cpu_rel": err_p1 / scale_p1, "siblings_bitwise": sib_p1,
              "clean_guarded_vs_unguarded_bitwise": torch.equal(v_clean, v_plain),
              "frozen_lanes": list(theta.frozen), "lane1_theta_frozen": lane1_frozen, "theta_pinned_host": pinned,
              "theta_set_bytes": set_bytes})
        require(torch.equal(g_bad[1], g_cpu[1]) and torch.equal(g_bad[2], g_cpu[2]),
                "guarded offloaded Proposed 1: health words or counts differ between card and CPU")
        require(health.diverged(g_bad[1]).tolist() == [False, True, False],
                f"the NaN did not trip lane 1 alone (offloaded Proposed 1): {g_bad[1].tolist()}")
        require(bool(torch.isfinite(v_bad).all()) and err_p1 <= 1e-6 * scale_p1,
                f"guarded offloaded Proposed 1 on the card disagrees with the CPU port: {err_p1 / scale_p1}")
        require(sib_p1, "the poisoned lane changed its siblings (offloaded Proposed 1)")
        require(torch.equal(v_clean, v_plain), "the clean guarded offloaded run is not the unguarded one")
        require(all(lane1_frozen.values()), f"lane 1's pinned θ is not its last healthy θ: {lane1_frozen}")
        require(all(pinned.values()) and set_bytes["blocks"] == set_bytes["spare"],
                f"θ's two host sets: pinned {pinned}, bytes {set_bytes}")
        del g_bad, g_cpu, theta, sets, theta_before

    with Phase("campaign_check"):
        campaign_check(os.path.join(ROOT, "build", "campaign_check"))

    with Phase("surrogate_check"):
        surrogate_check(os.path.join(ROOT, "build", "surrogate_check"))

    with Phase("surrogate_main"):
        trained = surrogate_main(os.path.join(ROOT, "build", "surrogate_main"))
        torch.cuda.empty_cache()

    with Phase("main"):
        mesh = meshgen.generate(64, 64, 12, pad_elems_to=8)
        cfg = methods.SeismicConfig(npart=8, schedule="prefetch", prefetch=1, nspring=150)
        nt = 8
        wave = wave_for(nt, cfg.dt)
        theta_bytes = mesh.n_elem * 4 * cfg.nspring * 40
        emit({"mesh": [64, 64, 12], "elements": mesh.n_elem, "nodes": mesh.n_nodes, "dof": mesh.ndof,
              "nspring": cfg.nspring, "theta_GB": theta_bytes / 1e9, "npart": cfg.npart, "steps": nt})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        last = dict(kernels.launch_counts())
        steps = []

        def on_step(k, info):
            counts = kernels.launch_counts()
            delta = {name: counts[name] - last[name] for name in counts}
            last.update(counts)
            row = dict(step=k, **info, launches=delta,
                       theta_GB_per_s_over_step=2 * theta_bytes / info["seconds"] / 1e9)
            steps.append(row)
            emit(row)

        kernels.reset_launch_counts()  # counts of the main path's run only
        last.update(kernels.launch_counts())
        res = methods.run(mesh, cfg, wave, device=dev, on_step=on_step)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        blocks = res["carry"][1].blocks
        pinned = all(hetmem.is_pinned_host(x) for blk in blocks for x in blk)
        v = res["velocity_history"]
        emit({"launches": launches, "peak_device_bytes": peak, "theta_bytes": theta_bytes,
              "theta_pinned_host": pinned, "converged": res["converged"].tolist(),
              "max_abs_v_observed": float(v.abs().max()), "max_abs_v_field": float(res["v"].abs().max()),
              "max_abs_u_field": float(res["u"].abs().max())})
        require(bool(res["converged"].all()), "a full-size step did not converge")
        require(all(launches[n] > 0 for n in FEM_KERNELS), f"a kernel of the path never launched: {launches}")
        require(pinned, "θ blocks are not pinned host tensors")
        require(peak < theta_bytes, f"peak device memory {peak} ≥ θ bytes {theta_bytes}")
        require(bool(torch.isfinite(v).all()) and bool(torch.isfinite(res["u"]).all()), "result not finite")
        require(float(res["v"].abs().max()) > 0, "the wave moved nothing")
        require(tuple(res["u"].shape) == (mesh.n_nodes, 3), "u has the wrong shape")

    with Phase("crs_main"):
        # main's mesh and config (npart 8, prefetch(1), fp64, 150 springs, the same
        # wave); every node observed, since the wave reaches no surface node in 4 steps
        crs_runs, crs_launches = {}, {}
        every_node = np.arange(mesh.n_nodes)
        for m, nt_m in CRS_STEPS.items():
            crs_steps = []

            def on_crs_step(k, info, m=m):
                counts = kernels.launch_counts()
                delta = {name: counts[name] - last[name] for name in counts}
                last.update(counts)
                row = dict(method=m, step=k, **info, launches=delta)
                crs_steps.append(row)
                emit(row)

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            resident_before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()  # counts of this rung's run only
            last = dict(kernels.launch_counts())
            t0 = time.perf_counter()
            r = methods.run(mesh, cfg, wave_for(nt_m, cfg.dt), method=m, device=dev, on_step=on_crs_step,
                            observe=every_node)
            run_s = time.perf_counter() - t0
            crs_launches[m] = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            theta = r["carry"][1]
            leaves = [x for blk in theta.blocks for x in blk] if m == "proposed1" else list(theta.values())
            row = {"method": m, "steps": nt_m, "run_s": run_s, "launches": crs_launches[m],
                   "peak_device_bytes": peak, "resident_before_bytes": resident_before,
                   "theta_bytes": theta_bytes, "theta_devices": sorted({str(x.device) for x in leaves}),
                   "theta_pinned_host": all(hetmem.is_pinned_host(x) for x in leaves),
                   "converged": r["converged"].tolist(), "iters": r["iters"].tolist(),
                   "step_s": [x["seconds"] for x in crs_steps],
                   "parts_ms": [x["ms"] for x in crs_steps]}
            if m == "baseline2":
                P = mesh.n_elem * 4
                row["host"] = {"threads": torch.get_num_threads(),
                               "host_compute_ms": [x["ms"]["host_compute"] for x in crs_steps],
                               "bytes_down_eps": P * 6 * 8, "bytes_up_sigma_D_frac": P * (6 + 36 + 1) * 8,
                               "points": P, "springs": P * cfg.nspring}
            emit(row)
            require(bool(r["converged"].all()), f"{m}: a full-size step did not converge")
            require(crs_launches[m]["ebe_matvec_f64"] == crs_launches[m]["ebe_matvec_f32"] == 0,
                    f"{m} launched the EBE kernel")
            v = r["velocity_history"]
            require(bool(torch.isfinite(v).all()) and bool(torch.isfinite(r["u"]).all()), f"{m}: result not finite")
            require(float(r["v"].abs().max()) > 0, f"{m}: the wave moved nothing")
            require(tuple(r["u"].shape) == (mesh.n_nodes, 3), f"{m}: u has the wrong shape")
            if m == "baseline2":
                require(crs_launches[m]["multispring"] == 0, "Baseline 2 launched the multispring kernel")
                require(all(x.device.type == "cpu" for x in leaves), "Baseline 2's θ left the host")
            else:
                require(crs_launches[m]["multispring"] > 0, f"{m} never launched the multispring kernel")
            if m == "proposed1":
                require(row["theta_pinned_host"], "Proposed 1's θ blocks are not pinned host tensors")
                require(peak < theta_bytes, f"Proposed 1's peak device memory {peak} ≥ θ bytes {theta_bytes}")
            crs_runs[m] = {"velocity_history": v.cpu()}
            del r, theta, leaves, v
        # 1e-10 here, 1e-12 in crs_check: the rungs' damping fractions are summed in
        # other orders (the kernel's, the plain version's on the card or the host),
        # and the solve carries that last bit into v through A's condition number,
        # larger at this size (Proposed 1 sat 8.2e-13·max|v| off on an H100, and
        # 2.25e-12 with the block products summed in another order)
        emit({"check": "crs_full_size_vs_baseline1", "observed": "every node",
              **rungs_disagree(crs_runs, "baseline1", {"baseline2": 1e-10, "proposed1": 1e-10})})

    qwen = ARCHS["qwen3-1.7b"]

    def greedy(logits):
        return logits[:, -1].argmax(-1, keepdim=True)

    with Phase("lm_cpu"):
        # full width, 2 layers, fp32: the card against the CPU on the same weights
        cfg_s = dataclasses.replace(qwen, n_layers=2, dtype="float32")
        p_cpu = T.init_params(cfg_s, torch.Generator().manual_seed(0), "cpu")
        p_gpu = _tree_to(p_cpu, dev)
        B, S0, NEW = 2, 64, 4
        toks = torch.randint(0, qwen.vocab_size, (B, S0 + NEW), generator=torch.Generator().manual_seed(1))
        runs = {}
        kernels.reset_launch_counts()  # counts of this path's run only: the fp32 flash kernel's path
        for name, params_, d in (("cpu", p_cpu, torch.device("cpu")), ("gpu", p_gpu, dev)):
            t = toks.to(d)
            lg, st = T.prefill(params_, cfg_s, {"tokens": t[:, :S0]}, cache_len=S0 + NEW)
            out = [lg[:, 0]]
            for i in range(S0, S0 + NEW):
                lg, st = T.decode_step(params_, cfg_s, t[:, i:i + 1], st)
                out.append(lg[:, 0])
            runs[name] = torch.stack(out, 1).cpu()
        fwd = T.forward(p_gpu, cfg_s, {"tokens": toks.to(dev)})[0][:, S0 - 1:].cpu()
        cpu_path_launches = kernels.instance_counts()
        scale = float(runs["cpu"].abs().max())
        err_cpu = float((runs["gpu"] - runs["cpu"]).abs().max())
        err_fwd = float((runs["gpu"] - fwd).abs().max())
        same_tokens = torch.equal(runs["gpu"].argmax(-1), runs["cpu"].argmax(-1))
        emit({"check": "lm_gpu_vs_cpu", "arch": cfg_s.name, "layers": 2, "dtype": "float32", "B": B,
              "prompt": S0, "decode_steps": NEW, "max_abs_err_vs_cpu": err_cpu, "max_abs_err_vs_forward": err_fwd,
              "atol": 5e-5 * scale, "greedy_tokens_equal": same_tokens, "flash_launches": cpu_path_launches})
        require(cpu_path_launches == {"flash_attention_bf16": 0, "flash_attention_f32": 2 * cfg_s.n_layers},
                f"fp32 prefill + forward made flash launches {cpu_path_launches}")
        require(err_cpu <= 5e-5 * scale, f"LM logits on the card differ from the CPU: {err_cpu}")
        require(err_fwd <= 5e-5 * scale, f"prefill→decode differs from forward on the card: {err_fwd}")
        require(same_tokens, "greedy tokens differ between card and CPU")
        del p_cpu, p_gpu, runs, fwd, st, lg

    with Phase("lm_main"):
        cfg_l = qwen  # 28 layers, bf16 compute, fp32 parameters
        params = T.init_params(cfg_l, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        B, S0, NEW, C = 4, 4096, 32, 4128
        prompt_main = torch.randint(0, cfg_l.vocab_size, (B, S0), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()  # counts of the main path's run only
        t0 = time.perf_counter()
        logits, state = T.prefill(params, cfg_l, {"tokens": prompt_main}, cache_len=C)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        flash_prefill = kernels.launch_counts()["flash_attention"]
        prefill_by_kernel = kernels.instance_counts()
        require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        tok, gen = greedy(logits), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NEW):
            gen.append(tok)
            logits, state = T.decode_step(params, cfg_l, tok, state)
            tok = greedy(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        lm_launches = kernels.launch_counts()
        gen = torch.cat(gen, 1)
        emit({"arch": cfg_l.name, "layers": cfg_l.n_layers, "params": n_params, "B": B, "prompt": S0,
              "cache_len": C, "new_tokens": NEW, "prefill_s": prefill_s,
              "prefill_tokens_per_s": B * S0 / prefill_s, "decode_s": decode_s,
              "decode_tokens_per_s": B * NEW / decode_s, "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "flash_launches_prefill": prefill_by_kernel,
              "flash_launches_decode": lm_launches["flash_attention"] - flash_prefill,
              "launches": lm_launches, "tokens_row0": gen[0, :8].tolist()})
        require(prefill_by_kernel == {"flash_attention_bf16": cfg_l.n_layers, "flash_attention_f32": 0},
                f"prefill's flash launches {prefill_by_kernel}, not {cfg_l.n_layers} of the wgmma kernel alone")
        require(lm_launches["flash_attention"] == flash_prefill, "decode launched the flash kernel")
        require(bool(torch.isfinite(logits).all()), "decode logits not finite")
        require(tuple(gen.shape) == (B, NEW), f"generated {tuple(gen.shape)}, not {(B, NEW)}")
        require(state["pos"] == S0 + NEW, "decode state position")
        del state, logits

    with Phase("lm_offload"):
        B, S0, NEW, npart = 4, 64, 32, 4
        prompt = torch.randint(0, qwen.vocab_size, (B, S0), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(2))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()  # counts of the two generates: each prefills through the flash kernel
        t0 = time.perf_counter()
        res_tok = serve.generate(params, qwen, prompt, NEW)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res_launches = kernels.instance_counts()
        off_tok = serve.generate(params, qwen, prompt, NEW, serve.ServeConfig(kv_offload=True, kv_npart=npart),
                                 kv_schedule="prefetch")
        torch.cuda.synchronize()
        res_s, off_s = t1 - t0, time.perf_counter() - t1
        off_launches = {n: c - res_launches[n] for n, c in kernels.instance_counts().items()}
        offload_launches = kernels.instance_counts()
        # the generated tokens stepped one at a time through both decode
        # steps (generate prefills the prompt in one pass; this holds the two
        # decode steps to each other over every position): every step's
        # logits, the last one's included, and the final caches bitwise equal
        C = S0 + NEW
        state = T.init_decode_state(qwen, B, C, dtype=L.dt(qwen), device=dev)
        ostate, kv = {"pos": 0}, serve.make_kv_blocks(qwen, B, C, npart, dtype=L.dt(qwen), device=dev)
        steps_equal = 0
        for t in range(C):
            lg, state = T.decode_step(params, qwen, res_tok[:, t:t + 1], state)
            olg, ostate, kv = serve.decode_step_offloaded(params, qwen, res_tok[:, t:t + 1], ostate, kv,
                                                          schedule="prefetch")
            steps_equal += int(torch.equal(olg, lg))
        kv_equal = all(torch.equal(torch.cat([blk[i] for blk in kv]).to(dev), state["layers"][name])
                       for i, name in enumerate(("k", "v")))
        pinned = all(hetmem.is_pinned_host(x) for blk in kv for x in blk)
        emit({"check": "offloaded_vs_resident", "B": B, "prompt": S0, "new_tokens": NEW, "kv_npart": npart,
              "layers_per_block": qwen.n_layers // npart, "schedule": "prefetch",
              "tokens_equal": torch.equal(off_tok, res_tok), "steps_with_bitwise_logits": steps_equal,
              "steps": C, "kv_bitwise": kv_equal, "kv_blocks_pinned_host": pinned,
              "resident_generate_s": res_s, "offloaded_generate_s": off_s,
              "flash_launches": {"resident_generate": res_launches, "offloaded_generate": off_launches}})
        one_prefill = {"flash_attention_bf16": qwen.n_layers, "flash_attention_f32": 0}
        require(res_launches == one_prefill and off_launches == one_prefill,
                f"generate's flash launches resident {res_launches}, offloaded {off_launches}: not one prefill's")
        require(tuple(off_tok.shape) == (B, S0 + NEW), "generate returned the wrong shape")
        require(torch.equal(off_tok, res_tok), "offloaded generate's tokens differ from resident")
        require(steps_equal == C, f"offloaded logits differ from resident at {C - steps_equal} of {C} steps")
        require(kv_equal, "offloaded KV cache differs from resident")
        require(pinned, "KV blocks are not pinned host tensors")
        del state, ostate, kv, lg, olg

    with Phase("lm_families_cpu"):
        families_cpu_launches = lm_families_cpu(dev)

    with Phase("lm_families"):
        # gemma2-2b, mamba2-780m, zamba2-7b, whisper-small and internvl2-1b whole,
        # mixtral and deepseek-v2 at published widths; lm_main's qwen3 stays on the
        # card for serve_main
        families_launches = lm_families(dev)

    with Phase("lm_tail"):
        # granite-8b whole and llama3-405b (2 of 126 layers) after the families have been
        # freed; lm_main's qwen3 stays on the card for serve_main
        tail_launches = lm_tail(dev)
        compression_on_card(os.path.join(ROOT, "build", "compression"))

    # the train CLI's processes run beside train_cpu; train_main reads them
    cli = train_cli_start(os.path.join(ROOT, "build", "train_cli"))
    with Phase("train_cpu"):
        train_cpu_launches, train_cpu_bf16_launches = train_cpu(dev)

    with Phase("train_main"):
        # lm_main's qwen3-1.7b parameters are every run's starting point; they wait on the
        # host meanwhile, so the runs have the card's memory to themselves
        params = _pinned(params)
        train_main_launches = train_main(dev, params, qwen, cli)
        params = _tree_to(params, dev)

    feedback_log = os.path.join(ROOT, "build", "serve_feedback.jsonl")
    with Phase("serve_check"):
        serve_check_launches = serve_check(os.path.join(ROOT, "build", "serve_check"), dev, keep_feedback=feedback_log)

    with Phase("serve_main"):
        # lm_main's qwen3-1.7b parameters serve the decode server
        serve_launches = serve_main(os.path.join(ROOT, "build", "serve_main"), dev, trained, params, qwen)
        del trained
        torch.cuda.empty_cache()

    with Phase("plan_check"):
        plan_launches = {"plan_check": plan_check(os.path.join(ROOT, "build", "plan_check"), dev, feedback_log)}
        torch.cuda.empty_cache()

    with Phase("kset_main"):
        # the paper's Proposed 2 as 2SET: two cases, θ of both resident on the
        # card (2 × 7.08 GB), at main's mesh and 150 springs, against each case
        # run alone in the same resident form; every node observed
        K2, nt2 = 2, 4
        waves2 = kset_waves(K2, nt2, cfg.dt)
        every_node = np.arange(mesh.n_nodes)
        kset_runs = {}
        for name, w in (("2set", waves2), ("one_0", waves2[:1]), ("one_1", waves2[1:])):
            steps_k = []
            last_k = {}

            def on_kset_step(k, info, name=name, steps_k=steps_k, last_k=last_k):
                counts = kernels.launch_counts()
                delta = {c: counts[c] - last_k[c] for c in counts}
                last_k.update(counts)
                row = dict(run=name, step=k, **info, launches=delta)
                steps_k.append(row)
                emit(row)

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            resident_before = torch.cuda.memory_allocated()  # the LM's weights, the 2SET carry kept for timing
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()  # counts of this run only
            last_k.update(kernels.launch_counts())
            t0 = time.perf_counter()
            r = methods.run_ensemble(mesh, cfg, w, device=dev, on_step=on_kset_step, observe=every_node)
            torch.cuda.synchronize()
            kset_runs[name] = {"run_s": time.perf_counter() - t0, "steps": steps_k, "launches": kernels.launch_counts(),
                               "peak": torch.cuda.max_memory_allocated() - resident_before,
                               "resident_before": resident_before, "v": r["velocity_history"].cpu(),
                               "iters": r["iters"].tolist(), "converged": bool(r["converged"].all())}
            if name == "2set":
                kset_carry = r["carry"]  # timed in phase timing
                kset_launches = kset_runs[name]["launches"]
            del r
        v2 = kset_runs["2set"]["v"]
        lanes = []
        for i in range(K2):
            v1 = kset_runs[f"one_{i}"]["v"][0]
            lanes.append(float((v2[i] - v1).abs().max()) / float(v1.abs().max()))
        s2 = [x["seconds"] for x in kset_runs["2set"]["steps"]]
        s1 = [a["seconds"] + b["seconds"] for a, b in zip(kset_runs["one_0"]["steps"], kset_runs["one_1"]["steps"])]
        emit({"kset_main": {"mesh": [64, 64, 12], "nspring": cfg.nspring, "k": K2, "steps": nt2,
                            "theta_GB_resident": K2 * theta_bytes / 1e9, "s_per_step_2set": s2,
                            "s_per_step_two_single_runs": s1, "iters": kset_runs["2set"]["iters"],
                            "iters_single": [kset_runs["one_0"]["iters"][0], kset_runs["one_1"]["iters"][0]],
                            "parts_ms": [x["ms"] for x in kset_runs["2set"]["steps"]],
                            "peak_device_bytes_over_resident": kset_runs["2set"]["peak"],
                            "peak_device_bytes_over_resident_single": [kset_runs["one_0"]["peak"],
                                                                       kset_runs["one_1"]["peak"]],
                            "resident_before_bytes": [x["resident_before"] for x in kset_runs.values()],
                            "launches": kset_launches, "lanes_vs_single_rel": lanes}})
        for name, run in kset_runs.items():
            require(run["converged"], f"kset_main {name}: a step did not converge")
            require(bool(torch.isfinite(run["v"]).all()) and float(run["v"].abs().max()) > 0,
                    f"kset_main {name}: not finite or moved nothing")
            for row in run["steps"]:  # one k-set launch per multispring pass and per matvec, for all members
                it = max(row["iters"])
                d = row["launches"]
                require(d["multispring_kset"] == 1 and d["multispring"] == (row["step"] == 0),  # + the initial tangent
                        f"{name} step {row['step']}: {d}")
                require(d["ebe_matvec_kset_f64"] == 2 + it and d["ebe_matvec_kset_f32"] == 8 * (1 + it)
                        and d["ebe_matvec_f64"] == d["ebe_matvec_f32"] == 0, f"{name} step {row['step']}: {d}")
        require(all(x <= 1e-6 for x in lanes), f"2SET lanes disagree with the single runs: {lanes}")
        require(tuple(v2.shape) == (K2, nt2, mesh.n_nodes, 3), "2SET velocity history shape")
        kset_v = v2.numpy()  # campaign_main's round 0 runs the same waves
        del kset_runs, v2

    with Phase("campaign_main"):
        # kset_main's 2SET carry waits on the host (phase timing takes it back)
        # so the campaign's rounds have the card as kset_main had it
        kset_carry = tree_map(lambda x: x.cpu(), kset_carry)
        torch.cuda.empty_cache()
        campaign_launches = campaign_main(mesh, cfg, kset_waves(3, 4, cfg.dt), kset_v,
                                          os.path.join(ROOT, "build", "campaign_main"))
        del kset_v

    with Phase("campaign_mp"):
        # the CLI in one and in two worker processes on the card beside this one,
        # with kset_main's carry still on the host
        campaign_mp_launches = campaign_mp(os.path.join(ROOT, "build", "campaign_mp"))
        kset_carry = tree_map(lambda x: x.to(dev), kset_carry)

    with Phase("timing"):
        ops = methods.FemOperators(mesh, cfg, device=dev)
        nm, ps, D, alpha, beta_e = res["carry"][:5]
        rows = []
        # multispring at one streamed block of the main path, from its final state
        chunk = ops.n_elem * 4 // cfg.npart
        blk = {k: x.to(dev) for k, x in zip(ms.STATE_KEYS, ps.blocks[0])}
        eps = spmv.strain_at_points(nm.u, ops.maps[cfg.rdtype])[:chunk].contiguous()
        prm = ops.block_params(cfg.npart)[0]
        args = (eps, blk, prm, ops.n_dirs, ops.w_dirs)
        out_k, out_p = ms_ops.multispring_cuda(*args), ms_ops.multispring_ref(*args)
        require(all(torch.equal(out_k[2][k], out_p[2][k]) for k in ms.FLAG_KEYS), "flags differ at full size")
        err = max(float((out_k[i] - out_p[i]).abs().max()) for i in (0, 1, 3))
        rel = max(rel_err(out_k[i], out_p[i]) for i in (0, 1))
        require(rel <= 1e-12, f"multispring disagrees at full size: {rel}")
        b_ms, by = bound(nbytes(eps, *blk.values(), prm.G0, prm.gamma_r, prm.beta, prm.bulk, ops.n_dirs,
                                ops.w_dirs, out_k[0], out_k[1], out_k[3], *out_k[2].values()),
                         chunk * cfg.nspring * MS_OPS_PER_SPRING, cfg.rdtype)
        rows.append({"name": "multispring", "route": "cuda", "source": "src/repro_torch/csrc/multispring.cu",
                     "replaces": "src/repro/kernels/multispring/multispring.py:118",
                     "launches": launches["multispring"], "max_abs_err": err,
                     "ms": cuda_ms(lambda: ms_ops.multispring_cuda(*args), 20),
                     "plain_ms": cuda_ms(lambda: ms_ops.multispring_ref(*args), 5),
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "detail": {"P": chunk, "S": cfg.nspring, "dtype": str(cfg.rdtype),
                                "max_rel_err": rel, "tol": 1e-12, "tile_p": ms_ops.TILE_P,
                                "launches_by_rung": {"proposed2": launches["multispring"],
                                                     **{m: c["multispring"] for m, c in crs_launches.items()}},
                                "steps_by_rung": {"proposed2": nt, **CRS_STEPS}}})
        del blk, out_k, out_p, args
        # EBE element product (gather fused in) at the full mesh, fp64 (outer)
        # and fp32 (inner), and one whole matvec with its parts
        matvec_parts = {}
        for dt, name in ((torch.float64, "ebe_matvec_f64"), (torch.float32, "ebe_matvec_f32")):
            maps = ops.maps[dt]
            x = nm.u.to(dt).contiguous()
            Dx = D.to(dt).contiguous()
            coef = (1.0 + (2.0 / cfg.dt) * beta_e).to(dt)
            a = (x, maps.conn32, Dx, maps.Jinv, maps.wdet, coef)

            def plain(x, conn, *rest):
                return ebe_ops.ebe_element_matvec_ref(spmv.gather_elem(x, conn), *rest)

            fk, fp = ebe_ops.ebe_matvec_cuda(*a), plain(x, maps.conn, *a[2:])
            f64 = plain(x.double(), maps.conn, *(t.double() for t in a[2:]))  # same inputs, in fp64
            vs_fp64 = {"kernel": rel_err(fk.double(), f64), "plain": rel_err(fp.double(), f64)}
            del f64
            # fp32 on the main path's data: u is dominated by a smooth, nearly
            # rigid motion whose strain cancels, so K·u is small beside its
            # terms and two fp32 summation orders differ by more than on the
            # random inputs above (5e-6); vs_fp64 shows both orders' error.
            rel, etol = rel_err(fk, fp), (1e-13 if dt == torch.float64 else 2e-5)
            require(rel <= etol, f"{name} disagrees at full size: {rel} (vs fp64: {vs_fp64})")
            # the bytes the fused kernel must move: x once, conn as int32, D,
            # J⁻¹, wdet, coef and f_e (a kernel fed the gathered u_e [E,10,3]
            # would count u_e in place of x and conn)
            b_e, by = bound(nbytes(*a, fk), ops.n_elem * EBE_OPS_PER_ELEM, dt)
            k_ms = cuda_ms(lambda: ebe_ops.ebe_matvec_cuda(*a), 50)
            rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/ebe_matvec.cu",
                         "replaces": "src/repro/kernels/ebe_matvec/ebe_matvec.py:99",
                         "launches": launches[name], "max_abs_err": float((fk - fp).abs().max()),
                         "ms": k_ms, "plain_ms": cuda_ms(lambda: plain(x, maps.conn, *a[2:]), 5),
                         "bound_ms": b_e, "bound_by": by, "library_ms": None,
                         "detail": {"E": ops.n_elem, "N": ops.n_nodes, "dtype": str(dt), "max_rel_err": rel,
                                    "tol": etol, "max_rel_err_vs_fp64": vs_fp64, "tile_e": ebe_ops.TILE_E,
                                    "bound_bytes": nbytes(*a, fk), "bound_counts": "x, conn int32, D, Jinv, "
                                    "wdet, coef, f_e (gather fused)"}})
            # one whole spmv.ebe_matvec (CUDA events) and its parts; the
            # gather runs inside the kernel
            matvec_parts[str(dt)] = {
                "matvec_ms": cuda_ms(lambda: spmv.ebe_matvec(x, Dx, maps, coef), 20),
                "gather_ms": None, "kernel_ms": k_ms,
                "scatter_ms": cuda_ms(lambda: spmv.scatter_add(fk, maps.dof_slots), 20)}
            del a, fk, fp, Dx, x
        emit({"ebe_matvec_breakdown": matvec_parts})
        # breakdown of one full-size step (CUDA events)
        copy_only = cuda_ms(lambda: [h.copy_(h.to(dev, non_blocking=True), non_blocking=True)
                                     for blk_ in ps.blocks for h in blk_], 1)
        eps_all = spmv.strain_at_points(nm.u, ops.maps[cfg.rdtype])
        bp = ops.block_params(cfg.npart)
        stream_ms = cuda_ms(lambda: methods._streamed_multispring(ops, eps_all, ps, bp), 2)
        # the multispring kernel alone over the step's blocks, each block's
        # state resident on the card
        ms_blocks_ms = 0.0
        for j, blk_h in enumerate(ps.blocks):
            blk_j = {k: h.to(dev) for k, h in zip(ms.STATE_KEYS, blk_h)}
            a_j = (eps_all[j * chunk:(j + 1) * chunk], blk_j, bp[j], ops.n_dirs, ops.w_dirs)
            ms_blocks_ms += cuda_ms(lambda: ms_ops.multispring_cuda(*a_j), 5)
            del blk_j, a_j
        diag_ms = cuda_ms(lambda: ops.ebe_diag_inverse(D, beta_e, alpha), 3)
        step_s = sorted(r["seconds"] for r in steps)[len(steps) // 2]
        emit({"breakdown": {
            "step_median_ms": step_s * 1e3,
            "theta_copy_only_h2d_d2h_ms": copy_only,
            "theta_link_GB_per_s": 2 * theta_bytes / (copy_only / 1e3) / 1e9,
            "streamed_multispring_ms": stream_ms,
            "multispring_kernel_over_blocks_ms": ms_blocks_ms,
            "ebe_diag_inverse_ms": diag_ms,
            "solve_and_rest_ms": step_s * 1e3 - stream_ms - diag_ms,
            "outer_iters": [r["iters"] for r in steps]}})
        # the CRS rungs' UpdateCRS by part, and one BCSR product held against
        # the EBE operator, on main's final tangent (CUDA events)
        bcsr, maps64 = ops.bcsr, ops.maps[cfg.rdtype]
        coef = 1.0 + (2.0 / cfg.dt) * beta_e

        def stiffness():
            return assembly.element_stiffness(D, maps64.Jinv, maps64.wdet, chunk=methods.DIAG_CHUNK)

        K_e = stiffness()
        valA = assembly.add_diag(assembly.assemble_bcsr(K_e, bcsr.entry_slots, coef), bcsr.diag_slots,
                                 ops._diag_add(alpha))
        crs_parts = {
            "element_stiffness_ms": cuda_ms(stiffness, 2),
            "assemble_valA_ms": cuda_ms(lambda: assembly.assemble_bcsr(K_e, bcsr.entry_slots, coef), 3),
            "add_diag_ms": cuda_ms(lambda: assembly.add_diag(valA, bcsr.diag_slots, ops._diag_add(alpha)), 3),
            "assemble_valCk_ms": cuda_ms(lambda: assembly.assemble_bcsr(K_e, bcsr.entry_slots, beta_e), 3),
            "block_jacobi_inverse_ms": cuda_ms(lambda: assembly.block_jacobi_inverse(valA, bcsr.diag_slots), 3),
            "crs_update_ms": cuda_ms(lambda: ops.crs_update(D, beta_e, alpha), 2)}
        del K_e
        x = nm.u.contiguous()
        xj = x[bcsr.col_idx]
        prod = (valA * xj[:, None, :]).sum(-1)
        bcsr_parts = {"gather_ms": cuda_ms(lambda: x[bcsr.col_idx], 20),
                      "products_ms": cuda_ms(lambda: (valA * xj[:, None, :]).sum(-1), 20),
                      "products_as_einsum_ms": cuda_ms(lambda: torch.einsum("nab,nb->na", valA, xj), 5),
                      "row_sum_ms": cuda_ms(lambda: torch.segment_reduce(prod, "sum", lengths=bcsr.row_lengths), 20)}
        del xj, prod
        # a library's sparse product on the same matrix, as scalar CSR (cuSPARSE): a yardstick only
        i = torch.repeat_interleave(torch.arange(mesh.n_nodes, device=dev), bcsr.row_lengths)
        i = (3 * i[:, None, None] + torch.arange(3, device=dev)[None, :, None]).expand(-1, 3, 3).reshape(-1)
        j = (3 * bcsr.col_idx[:, None, None] + torch.arange(3, device=dev)[None, None, :]).expand(-1, 3, 3).reshape(-1)
        A_csr = torch.sparse_coo_tensor(torch.stack([i, j]), valA.reshape(-1), (mesh.ndof, mesh.ndof)).coalesce()
        A_csr = A_csr.to_sparse_csr()
        del i, j
        xv = x.reshape(-1, 1)
        lib_err = rel_err((A_csr @ xv).reshape(-1, 3), spmv.bcsr_matvec(valA, bcsr, x))
        bcsr_parts["library_csr_ms"] = cuda_ms(lambda: A_csr @ xv, 20)
        bcsr_parts["library_csr_max_rel_err"] = lib_err
        del A_csr, xv
        y = spmv.bcsr_matvec(valA, bcsr, x)
        y_ebe = ops.ebe_matvec_A(D, beta_e, alpha)(x.reshape(-1)).reshape(-1, 3)
        rel = rel_err(y, y_ebe)
        require(rel <= 1e-12, f"bcsr_matvec disagrees with the EBE operator at full size: {rel}")
        # bytes the product must move: values, col_idx and row_ptr as the mesh stores them (int32), x, y
        nnzb = bcsr.nnzb
        bcsr_bytes = nbytes(valA, x, y) + (nnzb + mesh.n_nodes + 1) * 4
        b_bcsr, by = bound(bcsr_bytes, nnzb * 18, cfg.rdtype)
        emit({"crs_update_breakdown": crs_parts,
              "bcsr_matvec": {"ms": cuda_ms(lambda: spmv.bcsr_matvec(valA, bcsr, x), 20), "bound_ms": b_bcsr,
                              "bound_by": by, "bound_bytes": bcsr_bytes, "nnzb": nnzb, "dtype": str(cfg.rdtype),
                              "max_rel_err_vs_ebe_operator": rel, "tol": 1e-12, "parts": bcsr_parts,
                              "ebe_operator_ms": cuda_ms(lambda: ops.ebe_matvec_A(D, beta_e, alpha)(x.reshape(-1)),
                                                         20)}})
        del valA, y, y_ebe, x
        # flash attention at lm_main's shape: B 4, Hq 16, Hkv 8, S 4,096, dh 128, causal,
        # laid out as the layer gives it: q and k contiguous (rope's output), v
        # a transposed view of the [B,S,Hkv,dh] projection
        g = torch.Generator(device=dev).manual_seed(3)
        Bf, Hq, Hkv, S, dh = 4, qwen.n_heads, qwen.n_kv_heads, 4096, qwen.hd
        q = torch.randn((Bf, Hq, S, dh), device=dev, generator=g)
        k = torch.randn((Bf, Hkv, S, dh), device=dev, generator=g)
        v_bshd = torch.randn((Bf, S, Hkv, dh), device=dev, generator=g)
        sdpa = torch.nn.functional.scaled_dot_product_attention  # yardstick only: the port never calls it
        pairs = S * (S + 1) // 2  # (q, k) pairs the causal mask keeps
        flops = 4 * Bf * Hq * pairs * dh
        # fp32 (the 3×TF32 mma.sync kernel) at the reference's 2e-5: at S 4,096
        # most rows average thousands of keys, so |o| is ~0.03 and only fp32
        # holds those rows sharply.  Its bound is three TF32 products at the
        # tensor cores' rate; the fp32 cores' bound stands beside it.
        def flash32(q, k, v, flops, sdpa_kw, **kw):
            """One fp32 instance: error against the plain version, ms of the
            kernel, the plain version and (where it computes the function) SDPA,
            and both bounds."""
            out = fa_ops.flash_attention_cuda(q, k, v, **kw)
            err = float((out - fa_ops.flash_attention_ref(q, k, v, **kw)).abs().max())
            require(err <= FLASH_TOL["torch.float32"], f"flash_attention fp32 disagrees at {tuple(q.shape)}: {err}")
            moved = nbytes(q, k, v, out)
            b3, by3 = bound(moved, flops, "tf32x3")
            return {"max_abs_err": err, "ms": cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw), 5),
                    "plain_ms": cuda_ms(lambda: fa_ops.flash_attention_ref(q, k, v, **kw), 1),
                    "bound_ms": b3, "bound_by": by3, "bound_basis": "3×TF32 on the tensor cores, 495 TFLOP/s",
                    "bound_fp32_cores_ms": bound(moved, flops, torch.float32)[0],
                    "library_ms": None if sdpa_kw is None else cuda_ms(lambda: sdpa(q, k, v, **sdpa_kw), 3)}

        args = (q, k, v_bshd.transpose(1, 2))
        f32 = flash32(*args, flops, dict(is_causal=True, enable_gqa=True))
        del args
        # two more fp32 instances, at published head shapes: gemma2-2b (Hq 8,
        # Hkv 4, dh 256, window 4,096, softcap 50; SDPA has no softcap) and
        # deepseek-v2's MLA heads (dh 192, dv 128, Hq = Hkv, 128 heads cut to 16)
        instances = {}
        for name, (Bi, Hqi, Hkvi, dhi, dvi, win, cap) in {
                "gemma2-2b": (2, 8, 4, 256, 256, 4096, 50.0), "deepseek-v2 MLA": (1, 16, 16, 192, 128, None, None)}.items():
            qi = torch.randn((Bi, Hqi, S, dhi), device=dev, generator=g)
            ki = torch.randn((Bi, Hkvi, S, dhi), device=dev, generator=g)
            vi = torch.randn((Bi, S, Hkvi, dvi), device=dev, generator=g).transpose(1, 2)
            kept = sum(min(i + 1, win or S) for i in range(S))  # (q, k) pairs the causal mask and window keep
            fl = 2 * Bi * Hqi * kept * (dhi + dvi)
            instances[name] = {"B": Bi, "Hq": Hqi, "Hkv": Hkvi, "S": S, "dh": dhi, "dv": dvi, "window": win,
                               "softcap": cap, "causal": True, "v_strided": True, "flops": fl,
                               **flash32(qi, ki, vi, fl, None if cap else dict(is_causal=True, enable_gqa=Hqi != Hkvi),
                                         causal=True, window=win, softcap=cap)}
            del qi, ki, vi
        regs = {key: val for key, val in ptxas_report(_build.ptxas_log()).items() if key.startswith("flash_kernel<")}
        rows.append({"name": "flash_attention_f32", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83",
                     "launches": (cpu_path_launches["flash_attention_f32"] + sum(families_cpu_launches.values())
                                  + serve_check_launches["flash_attention_f32"] + sum(train_cpu_launches.values())),
                     **f32,
                     "detail": {"B": Bf, "Hq": Hq, "Hkv": Hkv, "S": S, "dh": dh, "dtype": "torch.float32",
                                "causal": True, "v_strided": True, "tol": FLASH_TOL["torch.float32"], "flops": flops,
                                "tflop_per_s": flops / (f32["ms"] / 1e3) / 1e12,
                                "registers_spills": regs, "instances": instances,
                                "launches_by_path": {
                                    "lm_cpu (fp32 prefill + forward on the card)": cpu_path_launches[
                                        "flash_attention_f32"],
                                    **{f"lm_families_cpu {n} (fp32 prefill + forward)": c
                                       for n, c in families_cpu_launches.items()},
                                    "serve_check (reduced qwen3, gemma2, mixtral, deepseek-v2 DecodeEngine and "
                                    "serve CLI, fp32)": serve_check_launches["flash_attention_f32"],
                                    **{f"train_cpu {n} (one train step, fp32, remat)": c
                                       for n, c in train_cpu_launches.items()}}}})
        q, k, v = q.bfloat16(), k.bfloat16(), v_bshd.bfloat16().transpose(1, 2)
        del v_bshd
        out_k, out_p = fa_ops.flash_attention_cuda(q, k, v), fa_ops.flash_attention_ref(q, k, v)
        err = float((out_k.float() - out_p.float()).abs().max())
        # bf16 relative to each value (bf16_limit)
        ref32 = out_p.float()
        lim = bf16_limit(ref32)
        ratio = float(((out_k.float() - ref32).abs() / lim).max())
        require(ratio <= 1.0, f"flash_attention bf16 disagrees at the main path's shape: {ratio} of its limit")
        lib = sdpa(q, k, v, is_causal=True, enable_gqa=True).float()
        lib_err, lib_ratio = float((lib - ref32).abs().max()), float(((lib - ref32).abs() / lim).max())
        del ref32, lim, lib
        b_fa, by = bound(nbytes(q, k, v, out_k), flops, torch.bfloat16)
        fa_ms = cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v), 20)
        rows.append({"name": "flash_attention_bf16", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
                     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83",
                     "launches": (prefill_by_kernel["flash_attention_bf16"] + offload_launches["flash_attention_bf16"]
                                  + sum(serve_launches.values()) + train_cpu_bf16_launches + train_main_launches),
                     "max_abs_err": err,
                     "ms": fa_ms, "plain_ms": cuda_ms(lambda: fa_ops.flash_attention_ref(q, k, v), 2),
                     "bound_ms": b_fa, "bound_by": by,
                     "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20),
                     "detail": {"B": Bf, "Hq": Hq, "Hkv": Hkv, "S": S, "dh": dh, "dtype": "torch.bfloat16",
                                "instance": wgmma_name(*fa_ops.wgmma_instance(dh, dh)),
                                "registers_spills": {k: v for k, v in ptxas_report(_build.ptxas_log()).items()
                                                     if k == wgmma_name(*fa_ops.wgmma_instance(dh, dh))},
                                "causal": True, "v_strided": True, "bf16_err_over_limit": ratio,
                                "bf16_limit": "2 ulp(|o|) + 2^-5 rms(o row)", "sdpa_max_abs_err": lib_err,
                                "sdpa_err_over_limit": lib_ratio, "tflop_per_s": flops / (fa_ms / 1e3) / 1e12,
                                "launches_by_path": {"lm_main": prefill_by_kernel["flash_attention_bf16"],
                                                     "lm_offload": offload_launches["flash_attention_bf16"],
                                                     **serve_launches,
                                                     "train_cpu qwen3-1.7b (one train step, bf16, remat)":
                                                         train_cpu_bf16_launches,
                                                     "train_main": train_main_launches}}})
        del q, k, v, out_k, out_p
        # the (256, 256) instance at gemma2-2b's (local, global) prefill shapes, (192, 128) at
        # deepseek-v2's MLA, (128, 128) at mixtral's (window 4,096, GQA group 6)
        rows.extend(family_flash_rows(dev, sdpa, {**families_launches, **tail_launches}))
        # breakdown of one prefill at lm_main's shape (CUDA events)
        x = torch.randn((4, S, qwen.d_model), device=dev, generator=g).to(torch.bfloat16)
        lp = T.layer(params["layers"], 0)

        def layer_matmuls():
            a = lp["attn"]
            for w in (a["wq"], a["wk"], a["wv"]):
                L.proj(x, w.to(x.dtype))
            x @ a["wo"].to(x.dtype).reshape(-1, qwen.d_model)
            h = L.proj(x, lp["mlp"]["w1"].to(x.dtype))
            h @ lp["mlp"]["w2"].to(x.dtype)
            L.proj(x, lp["mlp"]["w3"].to(x.dtype))

        prefill_ms = cuda_ms(lambda: T.prefill(params, qwen, {"tokens": prompt_main}, cache_len=4128), 1)
        mm_ms = qwen.n_layers * cuda_ms(layer_matmuls, 3)
        emit({"prefill_breakdown": {
            "prefill_ms": prefill_ms, "flash_total_ms": qwen.n_layers * fa_ms,
            "matmuls_with_weight_casts_ms": mm_ms,
            "rest_ms": prefill_ms - qwen.n_layers * fa_ms - mm_ms}})
        # one decode step at lm_main's shape (cache 4,128, pos 4,096): host
        # enqueue time, synchronised step time, and the kernels' own time from
        # the profiler, whose sum over the step time is the device's busy share
        state = T.prefill(params, qwen, {"tokens": prompt_main}, cache_len=4128)[1]
        tok, n = prompt_main[:, -1:], 8

        def steps():
            for _ in range(n):
                T.decode_step(params, qwen, tok, state)  # rewrites slot 4,096 each time

        steps()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        enqueue_ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            steps()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernel_ms = sum(getattr(e, "self_device_time_total", 0) for e in events) / n / 1e3
        emit({"decode_breakdown": {
            "step_ms": step_ms, "host_enqueue_ms": enqueue_ms, "device_kernel_ms": kernel_ms,
            "device_busy_share": kernel_ms / step_ms,
            "device_ops_per_step": sum(e.count for e in events if getattr(e, "self_device_time_total", 0)) / n,
            "top_device_ops_ms_per_step": {e.key: getattr(e, "self_device_time_total", 0) / n / 1e3 for e in sorted(
                events, key=lambda e: -getattr(e, "self_device_time_total", 0))[:6]}}})
        del state, params
        # the k-set kernels at kset_main's shapes (2SET, k 2) against two
        # one-member launches on the same members and their plain versions;
        # last, with the LM's weights freed: the plain multispring over
        # 2 × 1,179,648 points holds ~25 GB of temporaries per member
        nm2, th2, D2, alpha2, beta2 = kset_carry[:5]
        K2 = D2.shape[0]
        for dt, name in ((torch.float64, "ebe_matvec_kset_f64"), (torch.float32, "ebe_matvec_kset_f32")):
            maps = ops.maps[dt]
            x2 = nm2.u.to(dt).contiguous()
            Dk = D2.to(dt).contiguous()
            ck = (1.0 + (2.0 / cfg.dt) * beta2).to(dt)
            a = (x2, maps.conn32, Dk, maps.Jinv, maps.wdet, ck)
            ones = [(x2[i].contiguous(), maps.conn32, Dk[i].clone(), maps.Jinv, maps.wdet, ck[i].clone())
                    for i in range(K2)]
            fk, fp = ebe_ops.ebe_matvec_kset_cuda(*a), ebe_ops.ebe_element_matvec_kset_ref(*a)
            rel, etol = rel_err(fk, fp), (1e-13 if dt == torch.float64 else 2e-5)
            require(rel <= etol, f"{name} disagrees at kset_main's shape: {rel}")
            require(torch.equal(fk, torch.stack([ebe_ops.ebe_matvec_cuda(*o) for o in ones])),
                    f"{name} ≠ {K2} one-member launches at kset_main's shape")
            b_e, by = bound(nbytes(*a, fk), K2 * ops.n_elem * EBE_OPS_PER_ELEM, dt)
            k_ms = cuda_ms(lambda: ebe_ops.ebe_matvec_kset_cuda(*a), 50)
            one_ms = cuda_ms(lambda: [ebe_ops.ebe_matvec_cuda(*o) for o in ones], 50)
            rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/ebe_matvec.cu",
                         "replaces": "src/repro/kernels/ebe_matvec/ebe_matvec.py:99",
                         "launches": kset_launches[name], "max_abs_err": float((fk - fp).abs().max()),
                         "ms": k_ms, "plain_ms": cuda_ms(lambda: ebe_ops.ebe_element_matvec_kset_ref(*a), 3),
                         "bound_ms": b_e, "bound_by": by, "library_ms": None,
                         "detail": {"k": K2, "E": ops.n_elem, "N": ops.n_nodes, "dtype": str(dt), "max_rel_err": rel,
                                    "tol": etol, "bitwise_vs_one_member": True, "one_member_launches_ms": one_ms,
                                    "kset_over_one_member": k_ms / one_ms, "bound_bytes": nbytes(*a, fk),
                                    "launches_from": "kset_main (2SET, 4 steps)",
                                    "campaign_main_launches": campaign_launches[name]}})
            del a, ones, fk, fp, Dk, x2
        # multispring over k × P = 2 × 1,179,648 points, from the 2SET run's final θ
        P2 = ops.n_elem * 4
        eps2 = spmv.strain_at_points(nm2.u, ops.maps[cfg.rdtype]).contiguous()
        args = (eps2, th2, ops.params, ops.n_dirs, ops.w_dirs)
        out_k = ms_ops.multispring_kset_cuda(*args)
        err, rel = 0.0, 0.0
        for i in range(K2):  # member by member, to bound the plain version's temporaries
            out_p = ms_ops.multispring_ref(eps2[i], {key: v[i] for key, v in th2.items()}, ops.params, ops.n_dirs,
                                           ops.w_dirs)
            require(all(torch.equal(out_k[2][key][i], out_p[2][key]) for key in ms.FLAG_KEYS),
                    "multispring k-set flags differ at kset_main's shape")
            err = max([err] + [float((out_k[j][i] - out_p[j]).abs().max()) for j in (0, 1, 3)])
            rel = max(rel, rel_err(out_k[0][i], out_p[0]), rel_err(out_k[1][i], out_p[1]))
            del out_p
        require(rel <= 1e-12, f"multispring k-set disagrees at kset_main's shape: {rel}")
        b_ms, by = bound(nbytes(eps2, *th2.values(), ops.params.G0, ops.params.gamma_r, ops.params.beta,
                                ops.params.bulk, ops.n_dirs, ops.w_dirs, out_k[0], out_k[1], out_k[3],
                                *out_k[2].values()), K2 * P2 * cfg.nspring * MS_OPS_PER_SPRING, cfg.rdtype)
        del out_k
        k_ms = cuda_ms(lambda: ms_ops.multispring_kset_cuda(*args), 5)
        ones = [(eps2[i], {key: v[i] for key, v in th2.items()}, ops.params, ops.n_dirs, ops.w_dirs)
                for i in range(K2)]
        one_ms = cuda_ms(lambda: [ms_ops.multispring_cuda(*o) for o in ones], 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(lambda: ms_ops.multispring_kset_ref(*args), 1)
        rows.append({"name": "multispring_kset", "route": "cuda", "source": "src/repro_torch/csrc/multispring.cu",
                     "replaces": "src/repro/kernels/multispring/multispring.py:118",
                     "launches": kset_launches["multispring_kset"], "max_abs_err": err, "ms": k_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "detail": {"k": K2, "P": P2, "S": cfg.nspring, "dtype": str(cfg.rdtype), "max_rel_err": rel,
                                "tol": 1e-12, "one_member_launches_ms": one_ms, "kset_over_one_member": k_ms / one_ms,
                                "plain_peak_device_bytes": torch.cuda.max_memory_allocated(),
                                "launches_from": "kset_main (2SET, 4 steps)",
                                "campaign_main_launches": campaign_launches["multispring_kset"]}})
        del args, ones, eps2, kset_carry, nm2, th2, D2, alpha2, beta2
        # parts outside Pallas: the surrogates' recurrences against cuDNN's LSTM and the loop
        torch.cuda.empty_cache()
        emit({"outside_pallas": surrogate_timing(cuda_ms)})
        calibration = calibration_table(os.path.join(ROOT, "build", "plan_main_calibration", "kernels.json"), rows,
                                        torch.cuda.get_device_name(0))
        # main's carry (θ pinned on the host) and what still holds the LM's stacked
        # weights (layer 0's views) go before plan_main's worker processes start
        del ops, nm, ps, D, alpha, beta_e, res, lp, x, eps_all

    with Phase("plan_main"):
        torch.cuda.empty_cache()
        plan_launches["plan_main_a"] = plan_main(os.path.join(ROOT, "build", "plan_main"), dev, calibration, mesh)
        # the planning paths' launches of the FEM kernels; plan_main (b)'s run in
        # its worker processes and are not counted here
        for r in rows:
            if r["name"] in plan_launches["plan_check"]:
                r["detail"]["launches_by_path"] = {**{p: c[r["name"]] for p, c in plan_launches.items()},
                                                   "plan_main_b": "in the worker processes, not counted",
                                                   "campaign_mp": campaign_mp_launches[r["name"]]}
        print(smi, flush=True)
        emit({"kernel_detail": {r["name"]: r["detail"] for r in rows}})
        emit({"kernels": [{k: v for k, v in r.items() if k != "detail"} for r in rows]})

    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
