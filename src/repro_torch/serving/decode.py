"""Serving: batched greedy decode, resident or host-offloaded KV cache.

``decode_step_offloaded`` is Algorithm 3 applied to serving: the KV cache
(the serving analogue of the multi-spring state — large, evolving, touched
once per step) lives in pinned host memory, split into ``npart``
layer-group blocks.  Per token, block ``j`` streams host→device, its layer
group attends and appends, and the block returns to host while the next
block's copy is in flight (``core/stream.StreamEngine`` with the hidden
state as its carry).  Only ``1/npart`` of the cache (times the prefetch
depth) is on the card at a time.

The layer computations are those of ``models/transformer.decode_step``, in
the same order, so offloaded decode is bitwise equal to resident decode.
Offloading takes a uniform stack of GQA layers, dense, MoE (mixtral) or
VLM (internvl2, text-only), as the reference does; gemma2's pair stack, MLA,
a first dense stack and the Mamba families decode resident
(``transformer.check_offload_scope`` refuses the rest).

:func:`generate` prefills the prompt in one pass (``transformer.prefill``:
the flash kernel once per layer) and then decodes token by token.  With
the KV cache offloaded, the same prefill writes each layer's cache straight
into its host block, so both paths decode from bitwise the same caches.
(The JAX package prefills by decode, one step per prompt token.)  It serves
every family whose requests are tokens alone; whisper's also carry frames,
so :func:`check_generate_scope` refuses it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hetmem
from repro_torch.core.stream import StreamEngine, StreamPlan
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    kv_offload: bool = False
    kv_npart: int = 4
    temperature: float = 0.0  # 0 → greedy, else seeded categorical sampling
    seed: int = 0             # sampling generator's seed when temperature > 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be ≥ 0, got {self.temperature}")


def check_generate_scope(cfg: ModelConfig) -> None:
    """``generate`` takes a prompt of tokens alone: raise ``ValueError`` for
    the encoder-decoder family, whose prefill needs the frames beside them
    (the reference's ``generate`` decodes whisper from an empty cross cache
    and fails)."""
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: generate takes tokens alone, and the encoder-decoder family needs frames "
                         f"beside them: serve it by transformer.prefill({{'tokens', 'frames'}}) then decode_step")


def make_kv_blocks(cfg: ModelConfig, B: int, cache_len: int, npart: int, dtype=torch.bfloat16,
                   device=None) -> list[list[torch.Tensor]]:
    """Per-group KV blocks ``[k, v]``, each ``[L/npart, B, Hkv, C, hd]``, in
    pinned host memory for decode on ``device`` (``None`` → the card; plain
    CPU tensors when ``device`` is the CPU)."""
    T.check_offload_scope(cfg)
    dev = resolve_device(device)
    if cfg.n_layers % npart:
        raise ValueError(f"layers {cfg.n_layers} not divisible by npart={npart}")
    g = cfg.n_layers // npart
    C = T.cache_capacity(cfg, cache_len)
    blocks = []
    for _ in range(npart):
        kv = T._kv_cache(cfg, (g,), B, C, dtype, "cpu")
        blocks.append(hetmem.put_host([kv["k"], kv["v"]], dev))
    return blocks


@torch.no_grad()
def decode_step_offloaded(params, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
                          kv_blocks: list[list[torch.Tensor]], *, schedule: str = "serial",
                          prefetch: int = 1):
    """One decode step with layer-group-streamed KV.  Returns ``(logits,
    state, new_kv_blocks)``; the host blocks are updated in place.

    The hidden state ``x`` is the StreamEngine's carry: it threads through
    the layer-group blocks in order while their caches round-trip
    host↔device.  Prefetching block ``j+k`` is legal because the copies
    depend only on host state, not on the carry.  Each layer is
    ``transformer.decode_step``'s (an MoE layer routes dropless, as there).
    """
    T.check_offload_scope(cfg)
    pos = state["pos"]
    x = T._embed(params, cfg, tokens)
    positions = torch.arange(pos, pos + 1, device=x.device)  # no host→device copy: no sync
    npart = len(kv_blocks)
    n = T.n_stacked(params["layers"])
    if n % npart:
        raise ValueError(f"layers {n} not divisible by {npart} KV blocks")
    g = n // npart
    pgroups = [T.layer_slice(params["layers"], j * g, (j + 1) * g) for j in range(npart)]
    slots = T.layout(cfg)
    sgroups = [slots[j * g:(j + 1) * g] for j in range(npart)]

    def group_fn(blk, h, lp, group_slots):
        k, v = blk
        for i, slot in enumerate(group_slots):
            c = {"k": k[i], "v": v[i], "pos": pos}  # views: written in place
            h, _, _ = T._block(T.layer(lp, i), h, cfg, slot, "decode", positions, cache=c)
        return [k, v], h

    plan = StreamPlan(npart=npart, schedule=schedule, prefetch=prefetch, device=x.device)
    res = StreamEngine(plan).run(group_fn, hetmem.PartitionedState(blocks=list(kv_blocks)),
                                 per_block=(pgroups, sgroups), carry=x)
    return T._unembed(params, cfg, res.carry), {**state, "pos": pos + 1}, res.state.blocks


def sample_token(logits: torch.Tensor, temperature: float, generator: torch.Generator | None = None):
    """Next token from ``logits [B, V]``: argmax when ``temperature == 0``
    (exactly — greedy is an identity, not an approximation; ties go to the
    first maximum), else a categorical draw over ``logits / temperature``
    from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_new: int, scfg: ServeConfig = ServeConfig(),
             cache_len: int | None = None, kv_schedule: str = "serial", kv_prefetch: int = 1):
    """Serving loop honouring every :class:`ServeConfig` field: resident or
    host-offloaded KV (``kv_offload`` / ``kv_npart``), greedy or
    temperature-sampled tokens (``temperature`` / ``seed``).

    Runs where the parameters are.  The prompt is prefilled in one pass
    (the flash kernel once per layer; offloaded, its caches written layer by
    layer into the host blocks), then each new token is one decode step.
    Returns ``[B, S0 + n_new]`` (prompt + generated).
    """
    check_generate_scope(cfg)
    B, S0 = prompt.shape
    cache_len = cache_len or S0 + n_new
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(scfg.seed) if scfg.temperature > 0 else None

    if scfg.kv_offload:
        blocks = make_kv_blocks(cfg, B, cache_len, scfg.kv_npart, dtype=L.dt(cfg), device=dev)
        host = {name: [x for blk in blocks for x in blk[j]] for j, name in enumerate(("k", "v"))}  # by layer
        logits, state = T.prefill(params, cfg, {"tokens": prompt}, cache_len, out=host)
        state = {"pos": state["pos"]}

        def advance(tok):
            nonlocal state, blocks
            logits, state, blocks = decode_step_offloaded(params, cfg, tok, state, blocks,
                                                          schedule=kv_schedule, prefetch=kv_prefetch)
            return logits
    else:
        logits, state = T.prefill(params, cfg, {"tokens": prompt}, cache_len)

        def advance(tok):
            nonlocal state
            logits, state = T.decode_step(params, cfg, tok, state)
            return logits

    def pick(logits):
        return sample_token(logits[:, -1], scfg.temperature, gen)[:, None].to(prompt.dtype)

    out = [prompt]
    cur = pick(logits)
    for _ in range(n_new):
        out.append(cur)
        cur = pick(advance(cur))
    return torch.cat(out, dim=1)


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_new: int,
                    scfg: ServeConfig = ServeConfig(), cache_len: int | None = None):
    """Reference serving loop: :func:`generate` pinned to greedy resident
    decode (``scfg``'s sampling and offload fields are overridden)."""
    scfg = dataclasses.replace(scfg, temperature=0.0, kv_offload=False)
    return generate(params, cfg, prompt, n_new, scfg, cache_len)
