"""StreamEngine invariants of the port (CPU placements are the identity):
``serial`` with ``offload=False`` is bit-identical to the resident
computation, ``prefetch(k)`` is bit-identical to ``serial``, bad block
counts raise, and ``donate`` and k-set plans build and validate (their
runs are held in tests/test_torch_kset.py)."""
import numpy as np
import pytest
import torch

from repro_torch.core import hetmem
from repro_torch.core.hetmem import PartitionedState
from repro_torch.core.stream import SCHEDULES, StreamEngine, StreamPlan


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


def test_donate_and_kset_plans_build_and_validate():
    donate = StreamPlan(npart=2, schedule="donate")
    assert donate.schedule in SCHEDULES and donate.device_buffers == 2
    kset = StreamPlan(npart=2, kset=2)
    assert kset.kset == 2 and kset.device_buffers == 2
    with pytest.raises(ValueError, match="kset must be"):
        StreamPlan(npart=2, kset=0)
    assert torch.equal(StreamEngine(StreamPlan(npart=1, kset=2)).kmap(lambda x: x * 2, torch.ones(2)),
                       torch.full((2,), 2.0))


def test_partition_and_host_placement_on_cpu():
    tree = {"a": torch.arange(12.0).reshape(6, 2), "b": torch.arange(6, dtype=torch.int32)}
    parts = hetmem.partition_arrays(tree, 3)
    assert [p["a"].shape[0] for p in parts] == [2, 2, 2]
    assert torch.equal(torch.cat([p["b"] for p in parts]), tree["b"])
    blk = [parts[0]["a"], parts[0]["b"]]
    assert all(x is y for x, y in zip(hetmem.put_host(blk, "cpu"), blk))  # identity on the CPU
    assert not hetmem.transfers_real("cpu") and hetmem.transfers_real("cuda")


@pytest.mark.parametrize("schedule,depth", [("serial", 1), ("prefetch", 1), ("prefetch", 2)])
def test_carry_threads_through_blocks_in_order(schedule, depth):
    """``fn(blk, carry, *pb_j, *bc) → (blk', carry')``: the carry visits the
    blocks in order, prefetch(k) ≡ serial bitwise, and with ``collect`` the
    extras come third."""
    ps = _state(npart=4)
    offs = [torch.tensor(float(j + 1)) for j in range(4)]
    order = []

    def fn(blk, h, off, scale):
        order.append(int(off))
        a, b = blk
        h = torch.tanh(h * scale + a.sum(0)) + off
        return [a + h[0], b * scale], h

    h0 = torch.linspace(-1, 1, 5)
    plan = StreamPlan(npart=4, schedule=schedule, prefetch=depth)
    res = StreamEngine(plan).run(fn, ps, per_block=(offs,), broadcast=(torch.tensor(0.5),), carry=h0)
    ref_h, ref_blocks = h0, []
    for j, (a, b) in enumerate(_state(npart=4).blocks):
        ref_h = torch.tanh(ref_h * 0.5 + a.sum(0)) + (j + 1)
        ref_blocks.append([a + ref_h[0], b * 0.5])
    assert order == [1, 2, 3, 4]
    assert torch.equal(res.carry, ref_h)
    assert torch.equal(_flat(res.state), torch.cat([x.reshape(-1) for blk in ref_blocks for x in blk]))
    serial = StreamEngine(StreamPlan(npart=4)).run(fn, _state(npart=4), per_block=(offs,),
                                                   broadcast=(torch.tensor(0.5),), carry=h0)
    assert torch.equal(serial.carry, res.carry) and torch.equal(_flat(serial.state), _flat(res.state))

    collected = StreamEngine(StreamPlan(npart=4, collect=True)).run(
        lambda blk, h: (blk, h + 1, h.sum()), _state(npart=4), carry=torch.zeros(2))
    assert torch.equal(collected.carry, torch.full((2,), 4.0))
    assert [float(e) for e in collected.extras] == [0.0, 2.0, 4.0, 6.0]
    assert StreamEngine(StreamPlan(npart=4)).run(_kernel, _state(), broadcast=(torch.tensor(1.0),)).carry is None
