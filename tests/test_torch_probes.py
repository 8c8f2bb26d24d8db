"""The port's probes on the CPU: B4's plain version against the TPU
kernel, the probes' command lines, and that importing them leaves jax out.

`stream_plain` is held against scripts/probe_dma.py's Pallas kernel run in
interpret mode on a tiny bank (2 groups of 64 blocks of 8 x 768 rows),
with and without `score`.  The script is loaded by path and its `_kernel`
is called through a pallas_call built as its `stream` builds it (:71-82),
with interpret=True, which `stream` does not take.  The query holds small
integers, so every product and sum is exact and the two must be equal.
"""

import functools
import importlib.util
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vector_store_tpu_torch.probes import dma, fused_sweep, two_stage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _probe_dma():
    spec = importlib.util.spec_from_file_location(
        "probe_dma_tpu", os.path.join(ROOT, "scripts", "probe_dma.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_stream(q, bank, score, nbuf=4):
    mod = _probe_dma()
    kern = functools.partial(mod._kernel, score=score, nbuf=nbuf)
    return pl.pallas_call(
        kern,
        grid=(bank.shape[0] // mod.UNROLL,),
        in_specs=[
            pl.BlockSpec((8, mod.D), lambda g: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((1, 8), lambda g: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 8), jnp.float32),
        interpret=True,
    )(q, bank)


def _inputs(rows=8, groups=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-3, 4, size=(8, 768)).astype(np.float32)
    bank = rng.integers(-127, 128, size=(groups * dma.GROUP, rows, q.shape[1]), dtype=np.int8)
    return q, bank


@pytest.mark.parametrize("score", [True, False])
def test_stream_plain_matches_pallas_interpret(score):
    q, bank = _inputs()
    assert _probe_dma().UNROLL == dma.GROUP and _probe_dma().D == q.shape[1]
    want = np.asarray(_pallas_stream(jnp.asarray(q), jnp.asarray(bank), score))
    tq, tb = torch.from_numpy(q), torch.from_numpy(bank)
    got = dma.stream_plain(tq, tb, score)
    assert got.shape == (1, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(dma.stream(tq, tb, score), got)  # CPU wrapper = plain
    assert dma.LAUNCHES == {"stream": 0}


def test_stream_plain_is_the_last_group():
    """Only the last group's blocks count, in block order."""
    q, bank = _inputs(groups=3, seed=1)
    tq, tb = torch.from_numpy(q), torch.from_numpy(bank)
    np.testing.assert_array_equal(
        dma.stream_plain(tq, tb, False).numpy()[0],
        bank[-dma.GROUP :, 0, :8].astype(np.float32).sum(0),
    )
    last = bank[-dma.GROUP :].astype(np.float64)
    mins = np.einsum("sbd,sd->sb", last, q[np.arange(dma.GROUP) % 8]).min(1)
    np.testing.assert_array_equal(dma.stream_plain(tq, tb, True).numpy()[0], np.full(8, mins.sum()))


def test_stream_refuses_what_the_kernel_does_not_take():
    meta = torch.device("meta")
    q = torch.empty((8, 768), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        dma.stream(q, torch.empty((64, 8, 768), dtype=torch.int8, device=meta), True)


def test_bank_bytes_cut_into_whole_groups():
    n = dma.bank_bytes(1 << 30, 768)
    assert n >= 1 << 30
    for B in dma.BLOCK_ROWS:
        assert n % (dma.GROUP * B * 768) == 0
    assert dma.bank_bytes(1, 768) == dma.GROUP * max(dma.BLOCK_ROWS) * 768


def test_probe_command_lines():
    a = fused_sweep.parse(["2000000", "2", "4", "--rpb", "340", "--score", "qi8", "--q", "256",
                           "--no-oracle", "--live-prefix", "1"])
    assert (a.n, a.probes, a.rpb, a.score, a.q, a.no_oracle, a.live_prefix) == (
        2_000_000, [2, 4], 340, "qi8", 256, True, 1
    )
    d = fused_sweep.parse([])
    assert (d.n, d.probes, d.rpb, d.score, d.q, d.live_prefix) == (1_000_000, [4], 170, "f32", 1024, None)
    with pytest.raises(SystemExit):
        fused_sweep.parse(["--score", "int4"])
    t = two_stage.parse(["50000", "--rpb", "340", "--cluster-min", "4096"])
    assert (t.n, t.rpb, t.cluster_min) == (50_000, 340, 4096)


def test_snapshot_path_is_in_the_temporary_directory(tmp_path, monkeypatch):
    """The IVF probes cache their index under the JAX scripts' name, in the
    process's temporary directory, not in a fixed /tmp."""
    from vector_store_tpu_torch import probes

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert probes.snapshot_path(1_000_000, 340) == str(tmp_path / "vst_ivf_1000000_int8_rpb340.npz")


@pytest.mark.parametrize("mod", [dma, fused_sweep, two_stage])
def test_probes_refuse_to_run_without_a_card(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mod.main(["1000"] if mod is not dma else [])
    assert e.value.code == 2


def test_probe_imports_leave_jax_out():
    code = (
        "import sys, vector_store_tpu_torch.probes, vector_store_tpu_torch.probes.dma, "
        "vector_store_tpu_torch.probes.fused_sweep, vector_store_tpu_torch.probes.two_stage; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
