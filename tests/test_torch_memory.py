"""Port parity for parallel/memory.py: the per-device audit and the
traffic model give the JAX package's numbers exactly, for every preset
(both packages ship the same presets) under the arguments fit_sharded
passes, with and without ZeRO-1, for each moment format, both layouts
and both HBM sizes."""

import dataclasses

import pytest

from dladmm_tpu.parallel import memory as jmem
from dladmm_tpu_torch.parallel import memory as tmem
from dladmm_tpu_torch.utils.config import PRESETS

MOMENTS = (None, 2.0, 1.02)


def _fields(bd):
    """A breakdown's fields and total (the two packages' classes differ),
    or the MemoryError's message."""
    return bd if isinstance(bd, str) else (dataclasses.asdict(bd), bd.total)


def _args(cfg, zero1, moment_bytes, layout):
    p, t, s = cfg.problem, cfg.train, cfg.sharding
    return dict(
        m=p.m, n=p.n, K=p.K, batch=t.batch, data_axis=s.data_axis, model_axis=s.model_axis, layout=layout,
        dtype_bytes=4, compute_dtype_bytes=2 if t.compute_dtype == "bfloat16" else None,
        d=None if p.identity_B else (p.d or p.m), opt_shard_degree=s.data_axis if zero1 else 1,
        moment_bytes=moment_bytes,
    )


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_per_chip_bytes_and_audit_match_jax(name):
    cfg = PRESETS[name]
    for zero1 in (False, True):
        for mb in MOMENTS:
            for layout in ("sharded_w2", "replicated_w2"):
                kw = _args(cfg, zero1, mb, layout)
                assert _fields(tmem.per_chip_bytes(**kw)) == _fields(jmem.per_chip_bytes(**kw)), kw
                for hbm in (16e9, 80e9):
                    got = want = None
                    try:
                        want = jmem.audit_or_raise(**kw, hbm_bytes=hbm)
                    except MemoryError as e:
                        want = str(e)
                    try:
                        got = tmem.audit_or_raise(**kw, hbm_bytes=hbm)
                    except MemoryError as e:
                        got = str(e)
                    assert _fields(got) == _fields(want), (kw, hbm)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_step_traffic_bytes_match_jax(name):
    cfg = PRESETS[name]
    p, t, s = cfg.problem, cfg.train, cfg.sharding
    for layout in ("sharded_w2", "replicated_w2"):
        for hosts in (1, 2):
            kw = dict(m=p.m, n=p.n, K=p.K, batch=t.batch, data_axis=s.data_axis, model_axis=s.model_axis,
                      layout=layout, dtype_bytes=4, hosts=hosts)
            assert tmem.step_traffic_bytes(**kw) == jmem.step_traffic_bytes(**kw), kw


def test_audit_prints_the_same_table(capsys):
    """The audit's printed rows, as the JAX package prints them."""
    kw = _args(PRESETS["multihost"], False, None, "sharded_w2")
    lines_t, lines_j = [], []
    tmem.audit_or_raise(**kw, hbm_bytes=80e9, print_fn=lines_t.append)
    jmem.audit_or_raise(**kw, hbm_bytes=80e9, print_fn=lines_j.append)
    assert lines_t == lines_j and len(lines_t) == 7


def test_detect_hbm_bytes_on_the_cpu():
    assert tmem.detect_hbm_bytes("cpu") == tmem.DEFAULT_HBM_BYTES == jmem.DEFAULT_HBM_BYTES
    assert tmem.DEFAULT_HEADROOM == jmem.DEFAULT_HEADROOM
