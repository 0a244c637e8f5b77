"""StreamEngine invariants of the port (CPU placements are the identity):
``serial`` with ``offload=False`` is bit-identical to the resident
computation, ``prefetch(k)`` is bit-identical to ``serial``, bad block
counts raise, and what is not ported yet raises NotImplementedError."""
import numpy as np
import pytest
import torch

from repro_torch.core import hetmem
from repro_torch.core.hetmem import PartitionedState
from repro_torch.core.stream import StreamEngine, StreamPlan


def _state(npart=4, chunk=8, width=5, seed=0):
    rng = np.random.default_rng(seed)
    return PartitionedState(blocks=[
        [torch.tensor(rng.normal(size=(chunk, width)), dtype=torch.float32),
         torch.tensor(rng.normal(size=(chunk,)), dtype=torch.float32)]
        for _ in range(npart)
    ])


def _kernel(blk, scale):
    a, b = blk
    return [torch.tanh(a * scale) + 0.25 * a, b * scale + 1.0]


def _flat(state):
    return torch.cat([x.reshape(-1) for blk in state.blocks for x in blk])


def test_serial_bit_identical_to_resident():
    ps = _state()
    scale = torch.tensor(1.3, dtype=torch.float32)
    resident = [_kernel(blk, scale) for blk in ps.blocks]
    off = StreamEngine(StreamPlan(npart=4, offload=False)).run(_kernel, ps, broadcast=(scale,))
    on = StreamEngine(StreamPlan(npart=4, offload=True)).run(_kernel, ps, broadcast=(scale,))
    for res in (off, on):
        assert torch.equal(_flat(res.state), torch.cat([x.reshape(-1) for blk in resident for x in blk]))


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_bit_identical_to_serial(depth):
    scale = torch.tensor(0.7, dtype=torch.float32)
    serial = StreamEngine(StreamPlan(npart=4)).run(_kernel, _state(), broadcast=(scale,))
    pre = StreamEngine(StreamPlan(npart=4, schedule="prefetch", prefetch=depth)).run(
        _kernel, _state(), broadcast=(scale,))
    assert torch.equal(_flat(serial.state), _flat(pre.state))


def test_per_block_and_collect():
    ps = _state(npart=3)
    offs = [torch.tensor(float(j)) for j in range(3)]

    def fn(blk, off, scale):
        a, b = blk
        return [a + off, b], (a.sum() * scale + off)

    res = StreamEngine(StreamPlan(npart=3, schedule="prefetch", collect=True)).run(
        fn, ps, per_block=(offs,), broadcast=(torch.tensor(2.0),))
    for j in range(3):
        assert torch.equal(res.state.blocks[j][0], ps.blocks[j][0] + j)
        assert torch.equal(res.extras[j], ps.blocks[j][0].sum() * 2.0 + j)


def test_bad_npart_raises():
    ps = _state(npart=4)
    with pytest.raises(ValueError, match="npart"):
        StreamEngine(StreamPlan(npart=3)).run(_kernel, ps, broadcast=(torch.tensor(1.0),))
    with pytest.raises(ValueError, match="per_block"):
        StreamEngine(StreamPlan(npart=4)).run(_kernel, ps, per_block=([1, 2],))
    with pytest.raises(ValueError, match="npart"):
        StreamPlan(npart=0)
    with pytest.raises(ValueError, match="not divisible"):
        hetmem.partition_arrays({"x": torch.zeros(10, 3)}, 4)
    with pytest.raises(ValueError, match="not divisible"):
        hetmem.check_divisible(10, 3)
    with pytest.raises(ValueError):
        StreamPlan(npart=2, schedule="prefetch", prefetch=0)
    with pytest.raises(ValueError, match="schedule"):
        StreamPlan(npart=2, schedule="eager")


def test_donate_and_kset_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamPlan(npart=2, schedule="donate")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamPlan(npart=2, kset=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamEngine(StreamPlan(npart=1)).kmap(lambda x: x, torch.zeros(2))


def test_partition_and_host_placement_on_cpu():
    tree = {"a": torch.arange(12.0).reshape(6, 2), "b": torch.arange(6, dtype=torch.int32)}
    parts = hetmem.partition_arrays(tree, 3)
    assert [p["a"].shape[0] for p in parts] == [2, 2, 2]
    assert torch.equal(torch.cat([p["b"] for p in parts]), tree["b"])
    blk = [parts[0]["a"], parts[0]["b"]]
    assert all(x is y for x, y in zip(hetmem.put_host(blk, "cpu"), blk))  # identity on the CPU
    assert not hetmem.transfers_real("cpu") and hetmem.transfers_real("cuda")
