"""Port parity: ``utils/profiling.py`` and the prefill-phase profile against
the JAX package.

The roofline and the decode-memory estimate are arithmetic on the same
arguments and must agree within float rounding (rtol 1e-12). K10's plain
version ``mini_reference`` is held against the JAX profile's
``_mini_kernel`` run as a Pallas kernel in interpret mode, in all four
modes at B1 H2 L512 hd64 bf16, within the bf16 tolerance 5e-2
(``BASELINE.md:18-20``) and, closer, within ``mini_tolerance``: both round
p to bf16 before PV and o to bf16, so they may lie one bf16 ulp of |o|
apart plus one p of a row rounded the other way.
The profile entry point runs at a small shape on the CPU (its plain
versions, timed with the host clock).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from flash_attention_softmax_n_tpu import models as jm
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu.utils import profiling as jprof
from flash_attention_softmax_n_tpu_torch import models as tm
from flash_attention_softmax_n_tpu_torch.convert import (
    params_from_jax,
    tensor_from_numpy,
)
from flash_attention_softmax_n_tpu_torch.kernels import prefill_phases as pp
from flash_attention_softmax_n_tpu_torch.utils import profile_prefill_phases as ppp
from flash_attention_softmax_n_tpu_torch.utils import profiling as tprof
from scripts import profile_prefill_phases as jscript

torch.set_num_threads(2)
TINY_KW = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq_len=128, softmax_n=1.0)


def _roof_keys(r):
    return {k: v for k, v in r.items() if k != "percent_of_sol"}


@pytest.mark.parametrize("args", [(2, 32, 2048, 2048, 64, True, 2),
                                  (1, 8, 128, 4096, 128, False, 2),
                                  (4, 16, 1, 512, 64, False, 1),
                                  (2, 4, 300, 300, 32, True, 4)])
def test_attention_roofline_matches_jax(args):
    b, h, lq, lk, hd, causal, nbytes = args
    for j_chip, t_chip in ((jprof.V5E, tprof.ChipSpec("v5e", 197e12, 394e12, 819e9)),
                           (jprof.ChipSpec(*dataclasses.astuple(tprof.H100)),
                            tprof.H100)):
        want = jprof.attention_roofline(b, h, lq, lk, hd, causal=causal,
                                        dtype_bytes=nbytes, chip=j_chip)
        got = tprof.attention_roofline(b, h, lq, lk, hd, causal=causal,
                                       dtype_bytes=nbytes, chip=t_chip)
        assert got["bound"] == want["bound"]
        for k, v in _roof_keys(want).items():
            if k != "bound":
                assert got[k] == pytest.approx(v, rel=1e-12)
        assert got["percent_of_sol"](2e-3) == pytest.approx(
            want["percent_of_sol"](2e-3), rel=1e-12)


def test_h100_spec_is_the_data_sheet():
    assert (tprof.H100.bf16_flops, tprof.H100.int8_ops, tprof.H100.hbm_bw) == (
        989e12, 1979e12, 3.35e12)
    assert tprof.card_description(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_decode_memory_estimate_matches_jax(kv):
    jc = jm.DecoderConfig(**TINY_KW, dtype=jnp.float32)
    tc = tm.DecoderConfig(**TINY_KW, dtype=torch.float32)
    jp = j_quantize_weights(jm.init_decoder_params(jc, jax.random.PRNGKey(0)), 8)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    nbytes = tprof.pytree_bytes(tp)
    assert nbytes == jprof.pytree_bytes(jp)
    for batch, max_len in ((8, 2048), (96, 512), (1, 64)):
        want = jprof.estimate_decode_hbm_bytes(jc, batch, max_len, kv, nbytes)
        got = tprof.estimate_decode_hbm_bytes(tc, batch, max_len, kv, nbytes)
        assert got == want
    want = tprof.estimate_decode_hbm_bytes(tc, 8, 2048, kv, nbytes)
    assert tprof.check_decode_hbm_fit(tc, 8, 2048, kv, nbytes,
                                      budget_bytes=want["total"]) == want
    with pytest.raises(RuntimeError, match="will not fit"):
        tprof.check_decode_hbm_fit(tc, 8, 2048, kv, nbytes,
                                   budget_bytes=want["total"] - 1)


def test_measure_and_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    secs = tprof.measure(torch.matmul, x, x, iters=3)
    assert secs > 0
    path = tmp_path / "trace.json"
    with tprof.trace(str(path)):
        torch.matmul(x, x)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def _jax_mini(mode, q, k, v):
    """The JAX profile's _mini_kernel with its own block specs, in
    interpret mode (its module fixes BQ = 512 query rows per block)."""
    b, h, l, hd = q.shape
    bq = jscript.BQ
    return pl.pallas_call(
        functools.partial(jscript._mini_kernel, mode),
        grid=(b, h, l // bq),
        in_specs=[
            pl.BlockSpec((1, 1, bq, hd), lambda b, h, i: (b, h, i, 0)),
            pl.BlockSpec((1, 1, l, hd), lambda b, h, i: (b, h, 0, 0)),
            pl.BlockSpec((1, 1, l, hd), lambda b, h, i: (b, h, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, bq, hd), lambda b, h, i: (b, h, i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, l, hd), q.dtype),
        interpret=True,
    )(q, k, v)


@pytest.mark.parametrize("mode", pp.MODES)
def test_mini_reference_matches_jax_mini_kernel(mode):
    rng = np.random.RandomState(7)
    q, k, v = ((0.3 * rng.randn(1, 2, 512, 64)).astype(np.float32)
               .astype(jnp.bfloat16) for _ in range(3))
    want = np.asarray(_jax_mini(mode, jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v)), np.float32)
    tq, tk, tv = (tensor_from_numpy(a, "cpu") for a in (q, k, v))
    got = pp.mini_reference(mode, tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=0)
    tol = pp.mini_tolerance(mode, tq, tk, tv, got).numpy()
    assert (np.abs(got.float().numpy() - want) <= tol).all()
    # the wrapper takes the plain version on a CPU tensor
    assert torch.equal(pp.mini(mode, tq, tk, tv), got)


@pytest.mark.parametrize("mode", pp.MODES)
def test_mini_tolerance_catches_a_row_sum_3_percent_off(mode):
    # a kernel that drops one of 32 key tiles from l is about 3% off
    gen = torch.Generator().manual_seed(3)
    q, k, v = ((0.3 * torch.randn((1, 2, 512, 64), generator=gen)).to(torch.bfloat16)
               for _ in range(3))
    o = pp.mini_reference(mode, q, k, v)
    tol = pp.mini_tolerance(mode, q, k, v, o)
    assert bool((tol >= 2.0 ** -7 * o.float().abs()).all())
    assert float(((1.03 * o.float() - o.float()).abs() > tol).float().mean()) > 0.5


def test_mini_masks_keys_past_the_query():
    q = torch.randn(1, 1, 8, 32)
    v = torch.randn(1, 1, 8, 32)
    out = pp.mini_reference("mask_softmax", q, q, v)
    # row 0 sees key 0 alone, row 1 keys 0-1
    torch.testing.assert_close(out[0, 0, 0], v[0, 0, 0], atol=1e-6, rtol=0)
    s = q[0, 0, 1] @ q[0, 0, :2].T
    torch.testing.assert_close(out[0, 0, 1], torch.softmax(s, -1) @ v[0, 0, :2],
                               atol=1e-5, rtol=0)


def test_mini_rejects_unknown_modes_and_devices():
    q = torch.randn(1, 1, 8, 32)
    with pytest.raises(ValueError, match="unknown mode"):
        pp.mini("relu", q, q, q)
    meta = torch.empty((1, 1, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pp.mini("softmax", meta, meta, meta)


def test_profile_entry_point_on_the_cpu(capsys):
    lines = ppp.run((1, 2, 128, 64), device="cpu", iters=1)
    assert lines[0]["hw"] == "cpu" and lines[0]["timer"] == "host clock"
    assert lines[0]["shape"] == "B1 H2 L128 hd64 bf16"
    assert [x["name"] for x in lines[1:]] == list(ppp.PHASES)
    for x in lines[1:]:
        assert x["ms"] > 0 and x["tf_s"] > 0 and 0 < x["roofline_share"]
    causal = {x["name"]: x["roofline_ms"] for x in lines[1:]}
    assert causal["mask_softmax"] == causal["full_causal"]
    assert ppp.main(["--device", "cpu", "--shape", "1,1,64,32", "--iters", "1"]) == 0
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(printed) == 1 + len(ppp.PHASES)
    with pytest.raises(SystemExit):
        ppp.main(["--device", "cpu", "--shape", "1,1,64"])
