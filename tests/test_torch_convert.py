"""The converter the port's CPU tests use to hand one seeded numpy input to
both packages, and its own tests.

The system has no weights: its state is the ``Config`` and the per-window
arrays (``ReadBatch``). The tests build both with the JAX package's helpers
(``Config()``, ``simulate_batch_fast``, ``tests/util_bam.py``), and
``port_config`` / ``port_batch`` carry them field by field into the port's
own classes, so a test never hands one package's object to the other.
``PortBackend`` is the port's device backend behind the converter.
"""
import dataclasses

import numpy as np
import pytest

from methyldackel_tpu import config as jconfig
from methyldackel_tpu.io import bam as jbam
from methyldackel_tpu_torch import config as pconfig
from methyldackel_tpu_torch.io import bam as pbam
from methyldackel_tpu_torch.parallel.device import make_device_backend


def jax_group_tables(aligned_sorted, ntiles, K, LP, T=512):
    """The JAX package's offset-group tables (``pileup_pallas.py:469-473``,
    inline there), for its CPU twins: group k of tile t holds the rows whose
    128-aligned start is t*T - LP + 128*k. Returns int32 (srtk, cntk)
    [ntiles*K]. The port's kernels take ``host_prep.tile_rows`` instead."""
    bounds = (np.arange(ntiles)[:, None] * T - LP
              + 128 * np.arange(K + 1)[None, :])
    flat = np.searchsorted(aligned_sorted, bounds.reshape(-1), side="left")
    flat = flat.reshape(ntiles, K + 1)
    srtk = flat[:, :K].astype(np.int32).reshape(-1)
    cntk = np.diff(flat, axis=1).astype(np.int32).reshape(-1)
    return srtk, cntk


def _carry(obj, cls, what):
    """A ``cls`` with every field of ``obj`` (dataclass fields and extra
    attributes set on the instance). A field ``cls`` does not know fails."""
    known = {f.name for f in dataclasses.fields(cls)}
    values = dict(vars(obj))
    unknown = sorted(set(values) - known)
    if unknown:
        raise TypeError(f"{what}: the port's {cls.__name__} has no field "
                        f"{unknown}")
    missing = sorted(known - set(values))
    if missing:
        raise TypeError(f"{what}: the JAX package's object lacks {missing}")
    return cls(**values)


def port_config(cfg):
    """JAX-package ``Config`` -> the port's ``Config``, field by field
    (lists copied). A port ``Config`` passes through."""
    if isinstance(cfg, pconfig.Config):
        return cfg
    assert isinstance(cfg, jconfig.Config), type(cfg)
    out = _carry(cfg, pconfig.Config, "Config")
    for name in ("bounds", "absoluteBounds", "chromNames", "chromLengths"):
        setattr(out, name, list(getattr(cfg, name)))
    return out


def port_batch(batch):
    """JAX-package ``ReadBatch`` -> the port's ``ReadBatch`` over the same
    arrays. A port ``ReadBatch`` passes through."""
    if isinstance(batch, pbam.ReadBatch):
        return batch
    assert isinstance(batch, jbam.ReadBatch), type(batch)
    return _carry(batch, pbam.ReadBatch, "ReadBatch")


def port_item(item):
    """A window item ``(batch, strand, keep, ref, offset, start, end[,
    rstrand])`` with its batch converted."""
    return (port_batch(item[0]), *item[1:])


class PortBackend:
    """The port's device backend (on the CPU unless told otherwise) taking
    the JAX package's ``Config`` and ``ReadBatch`` through the converter."""

    def __init__(self, cfg, device="cpu"):
        self.backend = make_device_backend(port_config(cfg), device)

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def __call__(self, cfg, batch, *rest):
        return self.backend(port_config(cfg), port_batch(batch), *rest)

    def dispatch(self, cfg, batch, *rest):
        return self.backend.dispatch(port_config(cfg), port_batch(batch),
                                     *rest)

    def dispatch_group(self, cfg, items, pad_to=0):
        return self.backend.dispatch_group(
            port_config(cfg), [port_item(it) for it in items], pad_to)


def test_config_carries_every_field():
    cfg = jconfig.Config()
    cfg.minPhred, cfg.minOppositeDepth, cfg.maxVariantFrac = 7, 3, 0.25
    cfg.keepCHG, cfg.reg, cfg.chunkSize = 1, "chr1:5-90", 4096
    cfg.bounds[3] = 9
    got = port_config(cfg)
    assert type(got) is pconfig.Config and type(got) is not type(cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    got.bounds[3] = 1
    assert cfg.bounds[3] == 9  # lists are copies
    assert port_config(got) is got


def test_config_field_sets_are_equal():
    """The port's Config is a copy of the JAX package's: same fields, same
    defaults, same helpers."""
    names = lambda c: [(f.name, f.type) for f in dataclasses.fields(c)]
    assert names(pconfig.Config) == names(jconfig.Config)
    assert dataclasses.asdict(pconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())
    assert dataclasses.asdict(pconfig.perread_defaults()) == \
        dataclasses.asdict(jconfig.perread_defaults())
    for s in ("12", " -7x", "0xD00", "", "+3"):
        assert pconfig.c_atoi(s) == jconfig.c_atoi(s)
    for s in ("0.5", "1e-2x", "abc", "-.5"):
        assert pconfig.c_atof(s) == jconfig.c_atof(s)


def test_config_unknown_field_fails():
    cfg = jconfig.Config()
    cfg.not_a_port_field = 1
    with pytest.raises(TypeError, match="not_a_port_field"):
        port_config(cfg)


def test_batch_carries_every_array():
    from methyldackel_tpu.utils.simulate import (random_reference,
                                                 simulate_batch_fast)

    rng = np.random.default_rng(5)
    _ref, codes = random_reference(rng, 2000)
    batch = simulate_batch_fast(rng, codes, 40, 60)
    got = port_batch(batch)
    assert type(got) is pbam.ReadBatch and got.n == batch.n
    assert got.width == batch.width
    for f in dataclasses.fields(jbam.ReadBatch):
        a, b = getattr(batch, f.name), getattr(got, f.name)
        assert a is b, f.name
    batch.extra = 1
    with pytest.raises(TypeError, match="extra"):
        port_batch(batch)
