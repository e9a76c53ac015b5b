"""Port parity: grids, codes, packed bytes and the synthetic corpus.

The same numpy inputs go through ``repro`` (JAX) and ``repro_torch``; all of
it is integer or exactly rounded math, so the tolerance is equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.quant import grid as jgrid
from repro.quant import pack as jpack
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.quant import grid as tgrid
from repro_torch.quant import pack as tpack
from repro_torch.quant.qtensor import QuantizedTensor, dequantize_tensor
from tests._torch_cpu import one_torch_thread  # noqa: F401

CASES = [
    (4, False, None, 16, 96),
    (3, False, None, 16, 96),
    (2, True, None, 8, 64),
    (8, False, 32, 8, 96),
    (4, False, 256, 8, 384),  # ragged: groups of 256 + 128
    (4, True, 48, 4, 100),  # ragged symmetric
]


def _weights(q, p, seed):
    r = np.random.default_rng(seed)
    w = r.standard_normal((q, p)).astype(np.float32)
    w[r.random((q, p)) < 0.01] *= 8.0
    return w


@pytest.mark.parametrize("bits,sym,gsz,q,p", CASES)
def test_grid_and_codes_equal(bits, sym, gsz, q, p):
    w = _weights(q, p, bits * p)
    jspec = jgrid.GridSpec(bits=bits, symmetric=sym, group_size=gsz)
    tspec = tgrid.GridSpec(bits=bits, symmetric=sym, group_size=gsz)
    jg = jgrid.compute_grid(jnp.asarray(w), jspec)
    tg = tgrid.compute_grid(torch.from_numpy(w), tspec)
    np.testing.assert_array_equal(tg.scale.numpy(), np.asarray(jg.scale))
    np.testing.assert_array_equal(tg.zero.numpy(), np.asarray(jg.zero))
    for a, b in zip(tg.per_column(p), jg.per_column(p)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jc = np.asarray(jgrid.quantize_codes(jnp.asarray(w), jg))
    tc = tgrid.quantize_codes(torch.from_numpy(w), tg)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(
        tgrid.dequantize_codes(tc, tg).numpy(),
        np.asarray(jgrid.dequantize_codes(jnp.asarray(jc), jg)),
    )
    np.testing.assert_array_equal(
        tgrid.quantize_dequantize(torch.from_numpy(w), tg).numpy(),
        np.asarray(jgrid.quantize_dequantize(jnp.asarray(w), jg)),
    )


def test_batched_grid_matches_per_slice():
    w = np.stack([_weights(8, 64, s) for s in range(3)])
    spec = tgrid.GridSpec(bits=4, group_size=16)
    g3 = tgrid.compute_grid(torch.from_numpy(w), spec)
    for i in range(3):
        gi = tgrid.compute_grid(torch.from_numpy(w[i]), spec)
        np.testing.assert_array_equal(g3[i].scale.numpy(), gi.scale.numpy())
        np.testing.assert_array_equal(g3[i].zero.numpy(), gi.zero.numpy())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("p", [64, 67, 384])
def test_packed_bytes_equal(bits, p):
    r = np.random.default_rng(bits * 1000 + p)
    codes = r.integers(0, 1 << bits, (5, p)).astype(np.uint8)
    jp = np.asarray(jpack.pack_codes(jnp.asarray(codes), bits))
    tp = tpack.pack_codes(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tpack.unpack_codes(tp, bits, p).numpy(), codes)


def test_qtensor_dequantize_matches_grid():
    w = _weights(8, 384, 1)
    spec = tgrid.GridSpec(bits=4, group_size=256)
    g = tgrid.compute_grid(torch.from_numpy(w), spec)
    codes = tgrid.quantize_codes(torch.from_numpy(w), g)
    qt = QuantizedTensor(codes=tpack.pack_codes(codes, 4), scale=g.scale, zero=g.zero,
                         bits=4, group_size=256, packed=True)
    assert qt.shape == (8, 384)
    np.testing.assert_array_equal(
        dequantize_tensor(qt).numpy(), tgrid.dequantize_codes(codes, g).numpy()
    )


@pytest.mark.parametrize("split", ["train", "calib", "eval"])
def test_corpus_tokens_bit_identical(split):
    cfg = get_config("phi3_mini_3_8b")
    for vocab in (256, cfg.vocab):
        jfn, jc = jpipe.make_batch_fn(jpipe.DataConfig(vocab=vocab, seed=3), cfg, 2, 40, split=split)
        tfn, tc = tpipe.make_batch_fn(tpipe.DataConfig(vocab=vocab, seed=3), cfg, 2, 40, split=split)
        assert tc.entropy_floor() == jc.entropy_floor()
        for step in (0, 7):
            a, b = jfn(step)["tokens"], tfn(step)["tokens"]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_splits_are_disjoint_and_validated():
    cfg = get_config("phi3_mini_3_8b")
    dc = tpipe.DataConfig(vocab=256, seed=0)
    toks = {s: tpipe.make_batch_fn(dc, cfg, 2, 32, split=s)[0](0)["tokens"] for s in tpipe.SPLITS}
    assert not np.array_equal(toks["calib"], toks["eval"])
    with pytest.raises(ValueError):
        tpipe.make_batch_fn(dc, cfg, 2, 32, split="test")
