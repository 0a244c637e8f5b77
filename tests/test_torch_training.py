"""LM training in the port against the JAX package, on the CPU.

* leaf order and LPT block assignment (``utils/tree``, the offloaded
  optimizer's partition) equal the reference's;
* ``adamw_update_leaf`` and ``clip_by_global_norm`` within 1e-6
  (relative, with an absolute floor of 1e-6·max) on identical inputs;
* offloaded AdamW ≡ resident AdamW bitwise at npart 1, 3 and 7 (as
  ``tests/test_hetmem.py`` holds the reference's), for params and moments;
* reduced qwen3: the training loss within 1e-5 relative and every gradient
  leaf within 1e-4·max|g| of ``jax.value_and_grad``; then 3 train steps,
  losses within 1e-4 relative; a JAX AdamW state carried across by
  ``convert.adamw_state_from_numpy`` steps to the reference's next params;
* whole offloaded train steps ≡ resident bitwise; the loss falls by 0.5
  over 30 steps on the bigram stream (``tests/test_training.py``);
* ``data.batches`` bitwise the reference's, frontends and label pads
  included; the ``Prefetcher`` delivers and reports its wait;
* ``elastic_plan``: the coverage property and the exact layouts;
* the train CLI on the CPU: killed after a checkpoint (its later
  checkpoints removed) and relaunched, it resumes as the reference does.
"""
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS as REF_ARCHS
from repro.core import offload as RO
from repro.models import transformer as RT
from repro.training import data as RD
from repro.training import elastic as RE
from repro.training import optimizer as ROPT
from repro.training import train_step as RTS
from repro.utils import tree as RTREE
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.core import offload as O
from repro_torch.launch import train as cli
from repro_torch.training import data as D
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from repro_torch.training.elastic import elastic_plan
from repro_torch.utils import tree
from test_torch_train_families import assert_grads_close, reference_loss_and_grads

QWEN = "qwen3-1.7b"


def _params(seed=2, widths=(8, 16, 4, 32, 12)):
    """A small tree of kernels and biases (``tests/test_hetmem.py``'s), as numpy."""
    rng = np.random.default_rng(seed)
    return {f"w{i}": {"kernel": rng.standard_normal((w, w)).astype(np.float32), "bias": np.zeros((w,), np.float32)}
            for i, w in enumerate(widths)}


def _to_torch(tree_):
    return jax.tree_util.tree_map(torch.from_numpy, tree_)


def _close(got, want, tol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# tree utilities and the offloaded optimizer's partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("npart", [1, 3, 7, 8])
def test_leaf_order_and_blocks_match_reference(npart):
    ref_params, _ = RT.init_params(REF_ARCHS["deepseek-v2-236b"].reduced(), jax.random.key(0))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                                       ARCHS["deepseek-v2-236b"].reduced(), "cpu")
    ref_paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    assert [p for p, _ in tree.leaves_with_paths(params)] == ref_paths
    assert tree.byte_size(params) == RTREE.byte_size(ref_params)
    _, ref_spec = RTREE.group_leaves_into_blocks(ref_params, npart)
    blocks, spec = tree.group_leaves_into_blocks(params, npart)
    assert spec.block_of == ref_spec.block_of
    back = tree.reassemble_blocks(blocks, spec)
    assert all(a is b for a, b in zip(tree.tree_leaves(back), tree.tree_leaves(params)))
    off = RO.OffloadConfig(optimizer_state=True, optimizer_npart=npart)
    ref_state = RO.offloaded_adamw_init(ref_params, ROPT.AdamWConfig(), off)
    state = O.offloaded_adamw_init(params, OPT.AdamWConfig(), O.OffloadConfig(optimizer_state=True,
                                                                             optimizer_npart=npart))
    assert state.spec.block_of == ref_state.moments.spec.block_of
    assert state.moments.npart == len(ref_state.moments.blocks)


def test_tree_map_flatten_up_to_and_allclose():
    t = {"b": [np.ones(2), None], "a": (np.zeros(3),)}
    leaves, treedef = tree.tree_flatten(t)
    assert [p for p, _ in tree.leaves_with_paths(t)] == ["['a'][0]", "['b'][0]"]
    assert treedef.unflatten([1, 2]) == {"b": [2, None], "a": (1,)}
    assert treedef.flatten_up_to({"a": ({"m": 1},), "b": [{"m": 2}, None]}) == [{"m": 1}, {"m": 2}]
    with pytest.raises(ValueError):
        treedef.flatten_up_to({"a": [1]})
    assert tree.tree_allclose(t, tree.tree_map(lambda x: x + 1e-9, t))
    assert not tree.tree_allclose(t, tree.tree_map(lambda x: x + 1.0, t))
    blocks, spec = tree.group_leaves_into_blocks(t, 2)
    doubled = tree.reassemble_blocks(tree.map_blocks(lambda x: 2 * x, blocks), spec)
    assert tree.tree_allclose(doubled, tree.tree_map(lambda x: 2 * x, t))


def test_offload_policies_keep_the_gradients():
    """The activation policies (defined and unwired, as in the reference):
    under ``remat_policy`` with host offload, or the plain one, a train
    step's gradients are the same; on the CPU host and device are one
    memory, so the saved tensors stay where they are."""
    _, _, _, cfg, tcfg, params = _setup()
    batch = _torch_batch(next(D.batches(D.DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2))))
    loss_fn = TS.make_loss_fn(cfg, tcfg)
    runs = []
    for off in (O.OffloadConfig(), O.OffloadConfig(activations=True)):
        with O.remat_policy(off):
            runs.append(TS.value_and_grad(loss_fn, params, batch)[1])
    for a, b in zip(tree.tree_leaves(runs[0]), tree.tree_leaves(runs[1])):
        assert torch.equal(a, b)


def test_tree_walks_keep_no_leaf_alive():
    """With the cyclic collector off, an optimizer state that nothing holds
    is freed at once: no walker of ``utils/tree`` leaves a reference cycle
    around the leaves it returns (on the card, such a cycle held a whole
    moment tree, 13.8 GB for qwen3-1.7b, until the collector ran)."""
    import gc
    import weakref

    params = _to_torch(_params())
    cfg = OPT.AdamWConfig()
    gc.disable()
    try:
        st = OPT.adamw_init(params, cfg)
        old = weakref.ref(st.moments["w0"]["kernel"]["m"])
        grads = tree.tree_map(torch.ones_like, params)
        OPT.adamw_apply(grads, params, st, cfg)
        off = O.offloaded_adamw_init(params, cfg, O.OffloadConfig(optimizer_state=True, optimizer_npart=3))
        O.offloaded_adamw_apply(grads, params, off, cfg)
        blocks = weakref.ref(off.moments.blocks[0][0])
        del st, off
        assert old() is None and blocks() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 4, 250])
def test_adamw_update_leaf_matches_reference(step):
    rng = np.random.default_rng(step)
    g, p = (rng.standard_normal((7, 5)).astype(np.float32) for _ in range(2))
    mv = {"m": rng.standard_normal((7, 5)).astype(np.float32) * 0.1,
          "v": np.abs(rng.standard_normal((7, 5))).astype(np.float32) * 0.01}
    cfg, rcfg = OPT.AdamWConfig(warmup_steps=10), ROPT.AdamWConfig(warmup_steps=10)
    assert OPT.lr_at(cfg, step) == pytest.approx(float(ROPT.lr_at(rcfg, jnp.int32(step))), rel=1e-7)
    rp, rmv = ROPT.adamw_update_leaf(jnp.asarray(g), jnp.asarray(p), jax.tree_util.tree_map(jnp.asarray, mv),
                                     jnp.int32(step), rcfg)
    tp, tmv = OPT.adamw_update_leaf(torch.from_numpy(g), torch.from_numpy(p), _to_torch(mv), step, cfg)
    _close(tp, rp)
    for key in ("m", "v"):
        _close(tmv[key], rmv[key])


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _params(seed=5)
    ref, ref_gn = ROPT.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    got, gn = OPT.clip_by_global_norm(_to_torch(grads), max_norm)
    _close(gn, ref_gn)
    for a, b in zip(tree.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        _close(a, b)


@pytest.mark.parametrize("npart", [1, 3, 7])
def test_offloaded_adamw_matches_resident(npart):
    """Two steps from the same params and gradients: params and both
    moments bitwise equal (clipping on)."""
    cfg = OPT.AdamWConfig(learning_rate=1e-2, warmup_steps=1, grad_clip_norm=1.0)
    off = O.OffloadConfig(optimizer_state=True, optimizer_npart=npart)
    params = _to_torch(_params())
    grads = tree.tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator().manual_seed(3)), params)
    p_res, st_res = params, OPT.adamw_init(params, cfg)
    p_off, st_off = params, O.offloaded_adamw_init(params, cfg, off)
    for schedule in ("serial", "prefetch"):
        p_res, st_res = OPT.adamw_apply(grads, p_res, st_res, cfg)
        p_off, st_off = O.offloaded_adamw_apply(grads, p_off, st_off, cfg, schedule=schedule)
    assert st_res.step == st_off.step == 2
    for a, b in zip(tree.tree_leaves(p_res), tree.tree_leaves(p_off)):
        assert torch.equal(a, b)
    res_mv, off_mv = tree.tree_leaves(st_res.moments), tree.tree_leaves(O.moments_tree(st_off))
    assert len(res_mv) == len(off_mv) == 2 * len(tree.tree_leaves(params))
    for a, b in zip(res_mv, off_mv):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# reduced qwen3 against the reference
# ---------------------------------------------------------------------------


def test_qwen3_loss_and_grads_match_reference():
    cfg, params, batch, ref_loss, ref_grads = reference_loss_and_grads(QWEN)
    metrics, grads = TS.value_and_grad(TS.make_loss_fn(cfg, TS.TrainConfig()), params,
                                       {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    assert_grads_close(grads, ref_grads, cfg)


def _setup(offload=False, npart=4, lr=3e-3):
    """Reduced qwen3 with the JAX init carried across, and both trainers
    (``tests/test_training.py``'s ``_tiny_setup``)."""
    ref_cfg, cfg = REF_ARCHS[QWEN].reduced(), ARCHS[QWEN].reduced()
    ref_tcfg = RTS.TrainConfig(adamw=ROPT.AdamWConfig(learning_rate=lr, warmup_steps=10, weight_decay=0.0))
    tcfg = TS.TrainConfig(adamw=OPT.AdamWConfig(learning_rate=lr, warmup_steps=10, weight_decay=0.0),
                          offload=O.OffloadConfig(optimizer_state=offload, optimizer_npart=npart))
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_tcfg, ref_params, cfg, tcfg, params


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_three_train_steps_match_reference():
    ref_cfg, ref_tcfg, ref_params, cfg, tcfg, params = _setup()
    ref_step = jax.jit(RTS.make_train_step(ref_cfg, ref_tcfg))
    step = TS.make_train_step(cfg, tcfg)
    ref_opt, opt = RTS.init_train_state(ref_cfg, ref_tcfg, ref_params), TS.init_train_state(cfg, tcfg, params)
    it = D.batches(D.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    for _ in range(3):
        b = next(it)
        ref_params, ref_opt, ref_m = ref_step(ref_params, ref_opt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, _torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-4)
    # the reference's params and AdamW state carried across take the reference's next step
    carried = convert.adamw_state_from_numpy(jax.tree_util.tree_map(np.asarray, ref_opt), cfg, "cpu")
    assert carried.step == 3
    start = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    b = next(it)
    ref_params, _, _ = ref_step(ref_params, ref_opt, {k: jnp.asarray(v) for k, v in b.items()})
    params, _, _ = step(start, carried, _torch_batch(b))
    want = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    for (path, a), (_, w) in zip(tree.leaves_with_paths(params), tree.leaves_with_paths(want)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5 * float(w.abs().max()), err_msg=path)


def test_offloaded_train_steps_are_bitwise_resident():
    _, _, _, cfg, tcfg, params = _setup()
    _, _, _, _, tcfg_off, _ = _setup(offload=True, npart=3)
    runs = []
    for tc in (tcfg, tcfg_off):
        p, opt, step = params, TS.init_train_state(cfg, tc, params), TS.make_train_step(cfg, tc)
        it = D.batches(D.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
        losses = []
        for _ in range(3):
            p, opt, m = step(p, opt, _torch_batch(next(it)))
            losses.append(float(m["loss"]))
        runs.append((losses, p))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(tree.tree_leaves(runs[0][1]), tree.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_training_reduces_loss_on_learnable_data():
    _, _, _, cfg, tcfg, params = _setup()
    opt, step = TS.init_train_state(cfg, tcfg, params), TS.make_train_step(cfg, tcfg)
    it = D.batches(D.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8))
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, _torch_batch(next(it)))
        losses.append(float(m["nll"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert np.isfinite(losses).all()
    eval_m = TS.make_eval_step(cfg, tcfg)(params, _torch_batch(next(it)))
    assert float(eval_m["nll"]) < losses[0] - 0.5


# ---------------------------------------------------------------------------
# data, elastic re-layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kind", [(QWEN, "bigram"), (QWEN, "uniform"), ("internvl2-1b", "bigram"),
                                       ("whisper-small", "bigram")])
def test_batches_bitwise_reference(name, kind):
    cfg = ARCHS[name].reduced()
    kw = dict(vocab_size=cfg.vocab_size, seq_len=12, global_batch=3, kind=kind, seed=7, frontend=cfg.frontend,
              d_model=cfg.d_model, n_frontend_tokens=cfg.n_frontend_tokens)
    ref_it, it = RD.batches(RD.DataConfig(**kw)), D.batches(D.DataConfig(**kw))
    for _ in range(3):
        ref, got = next(ref_it), next(it)
        assert set(got) == set(ref)
        for key in ref:
            assert got[key].dtype == ref[key].dtype and np.array_equal(got[key], ref[key]), key
    if cfg.frontend == "vision_patches":
        assert (got["labels"][:, :cfg.n_frontend_tokens] == -100).all()


def test_prefetcher_delivers_and_reports_wait():
    dcfg = D.DataConfig(vocab_size=64, seq_len=8, global_batch=2)
    pf = D.Prefetcher(D.batches(dcfg), depth=2, device="cpu")
    b = next(pf)
    want = next(D.batches(dcfg))
    assert tuple(b["tokens"].shape) == (2, 8) and b["tokens"].dtype == torch.int32
    assert np.array_equal(b["tokens"].numpy(), want["tokens"])
    assert pf.last_wait_s >= 0.0
    deadline = time.monotonic() + 10
    while not pf._q.full() and time.monotonic() < deadline:  # closed with its queue full, the thread still ends
        time.sleep(0.01)
    assert pf._q.full()
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


@given(gb=st.sampled_from([32, 256, 100]), old=st.integers(1, 8), new=st.integers(1, 8))
@settings(max_examples=25, deadline=None)
def test_elastic_plan_covers_batch_exactly(gb, old, new):
    plan = elastic_plan(gb, old, new)
    assert plan == RE.elastic_plan(gb, old, new)
    covered = []
    for _, (start, size) in plan.items():
        covered.extend(range(start, start + size))
    assert sorted(covered) == list(range(gb))


def test_elastic_plan_relayout_exact():
    assert elastic_plan(8, 2, 4) == {0: (0, 2), 1: (2, 2), 2: (4, 2), 3: (6, 2)}
    assert elastic_plan(100, 4, 3) == {0: (0, 34), 1: (34, 34), 2: (68, 32)}
    assert elastic_plan(7, 1, 3) == {0: (0, 3), 1: (3, 3), 2: (6, 1)}
    assert elastic_plan(32, 8, 2) == {0: (0, 16), 1: (16, 16)}
    assert elastic_plan(32, 5, 2) == elastic_plan(32, 8, 2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_resumes_from_a_checkpoint(tmp_path, capsys):
    """Run 12 steps with a checkpoint every 5 (kept: steps 5, 10 and the
    final 12), then remove the later two, as if killed after step 5's
    checkpoint was written; relaunched, it resumes from step 5 and runs
    steps 5–11 again (the reference's resume)."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", QWEN, "--reduced", "--steps", "12", "--ckpt-every", "5", "--offload-optimizer",
            "--npart", "3", "--device", "cpu", "--ckpt-dir", ck]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "step     0  nll" in out and "step    10  nll" in out and "training complete" in out
    assert sorted(os.listdir(ck)) == ["step_000000005", "step_000000010", "step_000000012"]
    for step in ("step_000000010", "step_000000012"):
        shutil.rmtree(os.path.join(ck, step))
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[resume] from checkpoint step 5" in out
    assert "step     0  nll" not in out and "step    10  nll" in out and "training complete" in out
