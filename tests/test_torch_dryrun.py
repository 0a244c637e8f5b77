"""The port's dry run (``launch/dryrun``) and its accounting
(``launch/hlo_analysis``) against the JAX package: the same model inputs
and parameter counts for every cell; FLOPs of a reduced dense prefill
equal a hand count; the per-device argument bytes of a reduced qwen3
decode cell on a (2, 4) mesh equal XLA's ``memory_analysis`` of the same
cell (one compile in a subprocess on 8 forced host devices); its
collective terms equal a hand count."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as RL, transformer as RT
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D, hlo_analysis as H, mesh as M
from repro_torch.parallel import sharding as sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_dryrun():
    """The JAX package's dry-run module; importing it sets ``XLA_FLAGS`` to 512
    host devices for a later jax start, which this process must not take."""
    jax.devices()  # this process's backend is up before the import
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_and_n_params_match_reference(name):
    ref = _reference_dryrun()
    for shape in SHAPES.values():
        mine = D.input_specs(ARCHS[name], shape)
        want = ref.input_specs(REF_ARCHS[name], shape)
        assert {k: (tuple(x.shape), str(x.dtype).split(".")[-1]) for k, x in mine.items()} == \
            {k: (tuple(x.shape), str(x.dtype)) for k, x in want.items()}, (name, shape.name)
        assert all(x.device.type == "meta" for x in mine.values())
    with RL.abstract_params():
        ref_params, _ = RT.init_params(REF_ARCHS[name], jax.random.key(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(ref_params))
    params = D.T.init_params(ARCHS[name], torch.Generator(), D.META)
    assert sum(x.numel() for x in D.tree_leaves(params)) == n_ref
    spec = D.moments_specs(D.T.param_specs(ARCHS[name]))
    moments = D.moments_shapes(params)
    assert jax.tree_util.tree_structure(spec, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, moments))


def test_counted_flops_of_a_reduced_dense_prefill_equal_a_hand_count():
    """qwen3 reduced (4 layers, D 64, 4 heads over 2 KV heads of 16, F 128,
    V 256, tied), prefill B 2 × 32: the projections, the SwiGLU MLP and the
    flash operator's visible pairs (its formula), then the last position's
    unembedding; norms, rope and the softmax count nothing."""
    cfg = ARCHS["qwen3-1.7b"].reduced()
    B, S = 2, 32
    r = D.trace_cell(cfg, ShapeConfig("p", "prefill", S, B), M.make_card_mesh())
    L, Dm, H, Hkv, hd, F, V = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size
    T = B * S
    proj = 2 * T * Dm * (H + 2 * Hkv) * hd + 2 * T * H * hd * Dm
    mlp = 3 * 2 * T * Dm * F
    flash = 2 * B * H * (S * (S + 1) // 2) * (hd + hd)
    assert r["flops_global"] == L * (proj + mlp + flash) + 2 * B * Dm * V == 20_021_248
    layer = Dm * (H + 2 * Hkv) * hd + H * hd * Dm + 3 * Dm * F + 2 * Dm + 2 * hd  # + ln1, ln2, q_norm, k_norm
    assert r["flops"] == r["flops_global"] and r["n_params"] == V * Dm + L * layer + Dm
    assert r["memory"]["temp_bytes"] is None and r["memory"]["temp_bytes_reason"]


XLA_CELL = """
import dataclasses, jax, jax.numpy as jnp
from repro.configs import ARCHS
from repro.launch.mesh import make_host_mesh
from repro.models import layers as L, transformer as T
from repro.parallel import sharding as sh

cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].reduced(), dtype="bfloat16", param_dtype="bfloat16")
mesh = make_host_mesh((2, 4))
B, S = {B}, {S}
rules = sh.rules_for(cfg, mesh, kind="decode", global_batch=B, seq_len=S)
with L.abstract_params():
    params, pspecs = T.init_params(cfg, jax.random.key(0))
state = jax.eval_shape(lambda: T.init_decode_state(cfg, B, cache_len=S, dtype=jnp.bfloat16))
shard = lambda t: sh.tree_shardings(t, mesh, rules)
with mesh, sh.use_mesh(mesh, rules):
    step = jax.jit(lambda p, t, s: T.decode_step(p, cfg, t, s), donate_argnums=(2,),
                   in_shardings=(shard(pspecs), shard(T.batch_specs(cfg, False))["tokens"], shard(T.cache_specs(cfg))))
    mem = step.lower(params, jax.ShapeDtypeStruct((B, 1), jnp.int32), state).compile().memory_analysis()
print(json.dumps({{"argument": mem.argument_size_in_bytes, "alias": mem.alias_size_in_bytes}}))
"""


def _decode_cell():
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].reduced(), dtype="bfloat16", param_dtype="bfloat16")
    return cfg, ShapeConfig("decode", "decode", 64, 8), M.make_host_mesh((2, 4))


def test_argument_bytes_of_a_decode_cell_equal_xla():
    """Per device on (data 2, model 4): bf16 parameters (FSDP over data, heads
    and the MLP over model), the tokens, the bf16 KV caches (batch over data,
    sequence over model: split-S).  XLA also counts the state's ``pos``, an
    int32 argument it aliases to its output; the port's ``pos`` is a python
    int, no tensor: 4 bytes apart in both."""
    cfg, shape, mesh = _decode_cell()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = "import json\n" + textwrap.dedent(XLA_CELL.format(B=shape.global_batch, S=shape.seq_len))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    xla = json.loads(out.stdout.strip().splitlines()[-1])
    r = D.trace_cell(cfg, shape, mesh)
    POS = 4
    assert r["memory"]["argument_bytes"] + POS == xla["argument"]
    assert r["memory"]["alias_bytes"] + POS == xla["alias"]
    # the caches written in place, by hand: [4 layers, 8 → 4, 2 KV heads, 64 → 16, 16] × 2 (k, v) in bf16
    caches = 2 * 4 * 4 * 2 * 16 * 16 * 2
    assert r["memory"]["alias_bytes"] == caches


def test_collective_terms_of_a_decode_cell_equal_a_hand_count():
    """The same cell: decode replicates the activations (8 tokens) and keeps
    the weights sharded.  Each layer all-reduces q (over data: 1 head of 16 a
    device), k and v (over data: both KV heads), wo's output (over model:
    D/2), w1's and w3's (over data: F/4) and w2's (over model: D/2), and
    all-gathers wo's and w2's outputs over data back into the residual
    stream; the embedding rows from the vocab-sharded table and the
    unembedding's logits (over data: V/4) all-reduce once."""
    cfg, shape, mesh = _decode_cell()
    rules = sh.rules_for(cfg, mesh, kind="decode", global_batch=8, seq_len=64)
    assert (rules["batch"], rules["kv_seq"], rules["heads"], rules["kv_heads"], rules["mlp"]) == \
        (None, "model", "model", None, "model")
    t, a = 8, 2  # tokens, bf16 bytes
    per_layer_ar = t * a * (1 * 16 + 2 * 16 + 2 * 16 + 64 // 2 + 128 // 4 + 128 // 4 + 64 // 2)
    per_layer_ag = 2 * t * a * 64
    ar = 4 * per_layer_ar + t * a * 64 + t * a * 256 // 4
    assert H.collective_bytes(cfg, shape, mesh, rules) == {"all-reduce": ar, "all-gather": 4 * per_layer_ag}
    assert ar == 15_360


def test_train_and_prefill_terms():
    """Reduced qwen3 (fp32 parameters) at B 8 × 64 on (data 2, model 4): prefill
    gathers each FSDP leaf over data once (the tied embedding twice: lookup
    and unembedding), training twice (forward, backward) and reduce-scatters
    the FSDP gradients (the norms' gradients all-reduce); on (pod 2, data 2,
    model 4) each device holds half the tokens and every gradient shard also
    crosses the pod axis as the compressed all-reduce's int32 and a scale."""
    cfg = ARCHS["qwen3-1.7b"].reduced()
    host, pods = M.make_host_mesh((2, 4)), M.make_host_mesh((2, 2, 4), ("pod", "data", "model"))
    train, prefill = ShapeConfig("t", "train", 64, 8), ShapeConfig("p", "prefill", 64, 8)

    def terms(m, s):
        return H.collective_bytes(cfg, s, m, sh.rules_for(cfg, m, kind=s.kind, global_batch=8, seq_len=64))

    f = 4  # fp32
    # gathered over data, still split over model: embed [256/4, 64]; a layer's wq [64, 4/4, 16],
    # wk and wv [64, 2, 16], wo [4/4, 16, 64], w1 and w3 [64, 128/4], w2 [128/4, 64]
    layer_full = f * (64 * 16 + 2 * 64 * 2 * 16 + 16 * 64 + 3 * 64 * 32)
    gathers = 2 * f * 64 * 64 + 4 * layer_full
    # the shards each device holds: the same with D (fsdp) halved
    layer_shard, emb_shard = layer_full // 2, f * 64 * 32
    norms = f * (4 * (2 * 64 + 2 * 16) + 64)  # ln1, ln2, q_norm, k_norm a layer; final_norm
    assert terms(host, prefill).get("all-gather") == gathers and "reduce-scatter" not in terms(host, prefill)
    t_host, t_pods = terms(host, train), terms(pods, train)
    assert t_host["all-gather"] == t_pods["all-gather"] == 2 * gathers
    assert t_host["reduce-scatter"] == t_pods["reduce-scatter"] == emb_shard + 4 * layer_shard == 106_496
    activations = t_host["all-reduce"] - norms
    n_leaves = 2 + 11  # embed, final_norm; 11 stacked leaves (each [4, …])
    pod = 4 * (emb_shard + 4 * layer_shard + norms) // f + 4 * n_leaves
    assert t_pods["all-reduce"] == activations / 2 + norms + pod


def test_cli_writes_a_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "REPORT_DIR", str(tmp_path))
    D.main(["--arch", "whisper-small", "--shape", "decode_32k", "--mesh", "1x1"])
    r = json.load(open(tmp_path / "whisper-small__decode_32k__1x1.json"))
    assert r["status"] == "ok" and r["kind"] == "decode" and r["mesh"] == "1x1"
    assert r["flops"] == r["flops_global"] > 0 and r["collective_bytes"] == {}
    assert r["memory"]["argument_bytes"] > r["memory"]["alias_bytes"] > 0
    D.main(["--arch", "whisper-small", "--shape", "long_500k", "--mesh", "1x1"])
    assert json.load(open(tmp_path / "whisper-small__long_500k__1x1.json"))["status"] == "skipped"
    assert "all requested cells green" in capsys.readouterr().out
