"""The port's Algorithm-3 cost model (``repro_torch.core.pipeline``)
against the JAX package's (``repro.core.pipeline``): both are plain
python arithmetic, so every float is held *exactly* equal (tolerance 0)
over a seeded grid of inputs, the refusals raise alike, and a kernel
calibration table reads into equal :class:`KernelCalibration`s — the
repo's ``BENCH_kernels.json`` (backends ``jnp`` and ``pallas_interpret``)
and a table of the same format with backends ``cuda`` and ``torch``."""
import dataclasses
import itertools
import json
import os

import numpy as np
import pytest

from repro.core import pipeline as ref
from repro_torch.core import pipeline as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield dict(
            compute_s_per_block=float(rng.uniform(1e-4, 1.0)),
            bytes_in_per_block=float(rng.uniform(1e6, 1e10)),
            bytes_out_per_block=float(rng.uniform(1e6, 1e10)),
            link_gbps=float(rng.choice([25.0, 63.0, 128.0, 900.0])),
            npart=int(rng.integers(1, 80)),
        )


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.speedup_from_overlap == b.speedup_from_overlap


@pytest.mark.parametrize("duplex", [True, False])
def test_pipeline_time_equals_reference(duplex):
    for kw in _grid(40, seed=int(duplex)):
        _same(port.pipeline_time(**kw, duplex=duplex), ref.pipeline_time(**kw, duplex=duplex))


@pytest.mark.parametrize("prefetch,kset", list(itertools.product([1, 2, 4], [1, 2, 3])))
def test_stream_time_equals_reference(prefetch, kset):
    rng = np.random.default_rng(10 * prefetch + kset)
    for kw in _grid(12, seed=prefetch * 7 + kset):
        extra = dict(prefetch=prefetch, kset=kset,
                     shared_bytes_per_block=float(rng.uniform(0, 1e8)),
                     kset_compute_marginal=float(rng.uniform(0.1, 1.0)),
                     jitter_frac=float(rng.choice([0.0, 0.1, 0.5])),
                     duplex=bool(rng.integers(2)))
        a, b = port.stream_time(**kw, **extra), ref.stream_time(**kw, **extra)
        _same(a, b)
        assert a.pipelined_per_member_s == b.pipelined_per_member_s


@pytest.mark.parametrize("bad", [dict(npart=0), dict(prefetch=0), dict(kset=0), dict(jitter_frac=-0.1)])
def test_stream_time_refusals_match(bad):
    kw = {**next(_grid(1, seed=3)), **bad}
    with pytest.raises(ValueError) as ep:
        port.stream_time(**kw)
    with pytest.raises(ValueError) as er:
        ref.stream_time(**kw)
    assert str(ep.value) == str(er.value)


def test_breakeven_equals_reference():
    for kw in _grid(20, seed=5):
        args = dict(compute_s_per_block=kw["compute_s_per_block"], bytes_per_block=kw["bytes_in_per_block"])
        assert port.breakeven_link_gbps(**args) == ref.breakeven_link_gbps(**args)


def _card_table(path):
    table = {"bench": "kernels", "platform": "gpu", "kernels": {
        "multispring": {"unit": "point_spring", "units": 147456 * 150,
                        "backends": {"cuda": {"us_per_call": 757.0}, "torch": {"us_per_call": 12188.0}}},
        "ebe_matvec": {"unit": "element", "units": 294912,
                       "backends": {"cuda": {"us_per_call": 199.1}, "torch": {"us_per_call": 7320.0}}}}}
    with open(path, "w") as f:
        json.dump(table, f)
    return str(path)


@pytest.mark.parametrize("table", ["repo", "card"])
@pytest.mark.parametrize("backend", [None, "jnp", "cuda", "torch", "pallas_interpret"])
def test_load_kernel_calibration_equals_reference(tmp_path, table, backend):
    path = os.path.join(REPO, "BENCH_kernels.json") if table == "repo" else _card_table(tmp_path / "k.json")
    a, b = port.load_kernel_calibration(path, backend), ref.load_kernel_calibration(path, backend)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.multispring_s(1179648, 150) == b.multispring_s(1179648, 150)
    assert a.ebe_matvec_s(294912) == b.ebe_matvec_s(294912)
    if table == "card" and backend is None:
        assert a.backend == "cuda"  # the fastest measured backend


def test_load_kernel_calibration_missing_and_malformed(tmp_path):
    assert port.load_kernel_calibration(str(tmp_path / "none.json")) is None
    assert port.load_kernel_calibration("") is None
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kernels": {"multispring": {"units": 1}}}))
    with pytest.raises(ValueError, match="malformed"):
        port.load_kernel_calibration(str(bad))
    with pytest.raises(ValueError, match="malformed"):
        ref.load_kernel_calibration(str(bad))
