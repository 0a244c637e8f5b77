"""Port parity of the sharding rules and the logical-axis spec trees: the
port's ``parallel/sharding.rules_for`` equals the JAX package's for every
architecture, input shape and mesh (the reference tests' fake mesh: no
device needed); ``transformer.param_specs`` / ``cache_specs`` /
``batch_specs`` equal the spec trees the JAX package returns beside its
parameters, and the port's ``meta`` parameters have the shapes of the JAX
package's abstract ones, at full size; a ``ShardSpec`` holds what XLA's
``NamedSharding`` would give one device."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
from repro.models import layers as RL, transformer as RT
from repro.parallel import sharding as rsh
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh

MESHES = {"16x16": M.make_production_mesh(), "2x16x16": M.make_production_mesh(multi_pod=True),
          "2x4": M.make_host_mesh(), "1x1": M.make_card_mesh()}


class _FakeMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


def _fake(mesh):
    return _FakeMesh(mesh.sizes)


def _specs(tree):
    """A spec tree as plain dicts of tuples (either package's)."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_rules_for_match_reference(name):
    for shape in SHAPES.values():
        for mesh_name, mesh in MESHES.items():
            kw = dict(kind=shape.kind, global_batch=shape.global_batch, seq_len=shape.seq_len)
            got = sh.rules_for(ARCHS[name], mesh, **kw)
            want = rsh.rules_for(REF_ARCHS[name], _fake(mesh), **kw)
            assert got == want, (name, shape.name, mesh_name)
    assert sh.DEFAULT_RULES == rsh.DEFAULT_RULES


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_trees_and_meta_shapes_match_reference(name):
    with RL.abstract_params():
        ref_params, ref_specs = RT.init_params(REF_ARCHS[name], jax.random.key(0))
    cfg = ARCHS[name]
    assert _specs(T.param_specs(cfg)) == _specs(ref_specs)
    assert _specs(T.cache_specs(cfg)) == _specs(RT.cache_specs(REF_ARCHS[name]))
    for labels in (True, False):
        assert T.batch_specs(cfg, labels) == RT.batch_specs(REF_ARCHS[name], labels)
    mine = T.init_params(cfg, torch.Generator(), torch.device("meta"))
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), mine)
    assert shapes == jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), ref_params)
    # the spec tree and the parameter tree have the same leaves, one entry a dimension
    dims = jax.tree_util.tree_map(lambda a: a.dim(), mine)
    assert jax.tree_util.tree_map(len, T.param_specs(cfg), is_leaf=lambda x: isinstance(x, tuple)) == dims


def test_decode_state_follows_cache_specs():
    """Every cache tensor of the port's decode state has a spec of its rank."""
    for name in ARCHS:
        cfg = ARCHS[name].reduced()
        state = T.init_decode_state(cfg, 2, 16, device=torch.device("meta"), enc_len=cfg.n_frontend_tokens)
        specs = T.cache_specs(cfg)
        assert set(state) == set(specs)
        for key, caches in state.items():
            if key != "pos":
                assert {n: len(specs[key][n]) for n in caches} == {n: t.dim() for n, t in caches.items()}, name


def test_spec_for_and_shard_shapes_match_reference():
    """``spec_for`` under an active mesh as the reference's; a ShardSpec's
    per-device shape as a NamedSharding's over the same (abstract) mesh
    (which refuses an uneven split; the port rounds it up, as XLA pads)."""
    cfg = ARCHS["llama3-405b"]
    for mesh in MESHES.values():
        rules = sh.rules_for(cfg, mesh, kind="train", global_batch=256, seq_len=4096)
        logical = [("batch", "act_seq", None), ("fsdp", "heads", None), ("experts", "fsdp", "moe_mlp"),
                   ("layers", "kv_batch", "kv_heads", "kv_seq", None), ("vocab", "fsdp")]
        with sh.use_mesh(mesh, rules), rsh.use_mesh(_fake(mesh), rules):
            for axes in logical:
                assert sh.spec_for(*axes) == tuple(rsh.spec_for(*axes))
        abstract = jax.sharding.AbstractMesh(mesh.shape, mesh.axis_names)
        for axes, shape in ((("fsdp", "heads", None), (16384, 128, 128)), (("vocab", "fsdp"), (128256, 16384)),
                            (("batch", None), (256, 7)), (("layers", "fsdp", "mlp"), (126, 16384, 53248))):
            spec = sh.tree_shardings(axes, mesh, rules)
            ref = jax.sharding.NamedSharding(abstract, jax.sharding.PartitionSpec(*spec.spec))
            assert spec.shard_shape(shape) == tuple(ref.shard_shape(shape)), (axes, mesh.shape)
    one = sh.tree_shardings(("fsdp", "heads"), M.make_host_mesh(), {"heads": "model"})
    assert one.shard_shape((5, 6)) == (3, 2) and one.nbytes((5, 6), 2) == 12


def test_one_device_mesh_is_the_identity():
    x = torch.ones(3)
    assert sh.constrain(x, "batch") is x
    with sh.use_mesh(M.make_card_mesh()):
        assert sh.constrain(x, "batch") is x
        assert sh.named_sharding("batch", None).spec == ("data", None)
    fn = lambda a: a + 1  # noqa: E731
    assert sh.shard_map(fn, M.make_card_mesh(), None, None) is fn
    assert sh.shard_map(fn, None, None, None) is fn


def test_logical_meshes():
    assert MESHES["16x16"].sizes == {"data": 16, "model": 16} and MESHES["16x16"].size == 256
    assert MESHES["2x16x16"].axis_names == ("pod", "data", "model") and MESHES["2x16x16"].size == 512
    assert M.parse_mesh("1x1") == M.make_card_mesh() and M.parse_mesh("2x16x16") == MESHES["2x16x16"]
    with pytest.raises(ValueError):
        M.LogicalMesh((2, 0), ("data", "model"))
    with pytest.raises(ValueError):
        M.LogicalMesh((2,), ("data", "model"))
    shapes = {s.name: dataclasses.asdict(s) for s in SHAPES.values()}
    assert shapes == {s.name: dataclasses.asdict(s) for s in REF_SHAPES.values()}
