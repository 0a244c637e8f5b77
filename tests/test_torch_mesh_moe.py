"""The MoE families training over a (data, model) device mesh, on the CPU.

Reduced mixtral (4 experts, top-2, softmax over the selected logits) over
(2, 2) (experts over ``model``, two routing groups: one a shard of the
batch) and (1, 4) (an expert a process, one routing group), over (2, 1,
2) (pod, data, model) (the batch over pod and data: two groups), and reduced
deepseek-v2 (MLA through ``mesh_attention`` with k expanded per head, a
first dense layer, then the MoE with a shared expert) over (2, 2); fp32,
a global batch of 8 × 64 uniform tokens (on the bigram stream the two
groups happen to drop what one group drops), four gloo CPU processes
(``test_torch_mesh_families.run_meshes``).

Held against the JAX package's ``value_and_grad`` on four forced host
devices laid out as the same mesh: the first loss within 1e-5 relative,
the gradients within 1e-4·max|g| per leaf.  The reference routes
``_n_token_groups`` groups with the capacity of a group's tokens, so over
(2, 2) the experts see other tokens than on one process, and the port
follows the reference there, not the one process; over (1, 4) one group
routes every token, and the port's mesh matches its one process (the
first loss and 3 steps' losses, the gradients).  Each process holds
``ShardSpec.shard_shape`` of every leaf.
"""
import numpy as np
import pytest
from test_torch_mesh_families import case_id, grads_close, run_meshes

from repro_torch.utils.tree import leaves_with_paths

CASES = [("mixtral-8x22b", (2, 2)), ("mixtral-8x22b", (1, 4)), ("mixtral-8x22b", (2, 1, 2)),
         ("deepseek-v2-236b", (2, 2))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_meshes(tmp_path_factory.mktemp("mesh_moe"), CASES, one=["mixtral-8x22b"], kind="uniform")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_mesh_matches_reference_mesh(runs, case):
    """The first loss and its gradients against the JAX package on the same mesh."""
    ref, port = runs["ref"][case], runs["port"][case]
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    grads_close(port["grads"], ref["grads"])


def test_one_routing_group_matches_one_process(runs):
    """Over (1, 4) one group routes every token, as on one process: the
    first loss, 3 steps' losses and the gradients."""
    one, port = runs["one"]["mixtral-8x22b"], runs["port"][("mixtral-8x22b", (1, 4))]
    np.testing.assert_allclose(port["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], one["losses"], rtol=1e-5)
    grads_close(port["grads"], one["grads"])


def test_two_routing_groups_follow_the_reference(runs):
    """Over (2, 2) each shard of the batch routes alone at the capacity of
    its own tokens: some expert's gradient lies farther from one process's
    (one group) than the tolerance, and within it of the reference's."""
    case = ("mixtral-8x22b", (2, 2))
    port = dict(leaves_with_paths(runs["port"][case]["grads"]))
    one = dict(leaves_with_paths(runs["one"][case[0]]["grads"]))
    apart = [k for k in one if "moe" in k and np.abs(port[k] - one[k]).max() > 1e-4 * np.abs(one[k]).max()]
    assert apart, "two routing groups dropped the same entries as one: the case shows nothing"
    grads_close(runs["port"][case]["grads"], runs["ref"][case]["grads"])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_each_process_holds_its_shard(runs, case):
    """Every leaf on every process has ``ShardSpec.shard_shape`` of its rules' layout."""
    for shards in runs["shards"]:
        for path, got, want in shards[case]:
            assert got == want, (case, path)
