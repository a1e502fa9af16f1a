"""Kernel K3's plain version (alignq_tpu_torch/kernels/stage_kernel.py,
which the CPU runs) against the JAX package's stage_identity_blocks_reference
under jax.jit, on the same numpy inputs: the int16 stream is bit-identical
(both round each f32 multiply-add once)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import stage_kernel as jsk
from alignq_tpu.kernels.convert import QConvInt8 as JQConv
from alignq_tpu.quant.cdf import ERF_SQRT2_POLY
from alignq_tpu_torch.kernels import stage_kernel as tsk
from alignq_tpu_torch.kernels.convert import QConvInt8 as TQConv

CSRC = Path(tsk.__file__).resolve().parents[1] / "csrc"
CU = CSRC / "stage_kernel.cu"
HEADER = CSRC / "act_codes.cuh"


def _blocks(rng, c, nblk):
    blocks = []
    for _ in range(nblk):
        blk = {}
        for name in ("conv0", "conv1"):
            blk[name] = (
                rng.randint(-20, 20, (3, 3, c, c)).astype(np.int8),
                (rng.rand(c) * 1e-3).astype(np.float32),
                ((rng.rand(c) - 0.5) * 0.1).astype(np.float32),
            )
        blocks.append(blk)
    return blocks


def _as(blocks, qconv, conv):
    return [{k: qconv(*(conv(a) for a in v)) for k, v in blk.items()} for blk in blocks]


@pytest.mark.parametrize(
    "c,h,w,batch,ms,g",
    [
        (16, 8, 8, 4, (2, 3), 127),  # stage-1-like
        (32, 4, 4, 4, (2, 3), 127),  # stage-2-like
        (16, 8, 8, 2, (1,), 127),  # m=1 lossless requant
        (16, 8, 8, 2, (2,), 7),  # A4 grid
        (64, 4, 4, 2, (2, 3), 127),  # stage-3 width
    ],
)
def test_plain_bit_identical_to_jax(c, h, w, batch, ms, g):
    rng = np.random.RandomState(c + len(ms) + g)
    blocks = _blocks(rng, c, len(ms))
    wt, scale, bias = jsk.pack_block_weights(_as(blocks, JQConv, jnp.asarray))
    stream = rng.randint(0, 4 * g, (c, batch * h * w)).astype(np.int16)
    want = jax.jit(jsk.stage_identity_blocks_reference, static_argnums=(4, 5, 6, 7))(
        stream, wt, scale, bias, ms, g, w, h
    )
    tw, ts, tb = tsk.pack_block_weights(_as(blocks, TQConv, torch.from_numpy))
    got = tsk.stage_identity_blocks(torch.from_numpy(stream), tw, ts, tb, ms, g=g, w_img=w, h_img=h)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "c,hw,ms",
    [(16, 32, (1, 2, 3)), (32, 16, (2, 3)), (64, 8, (2, 3))],  # the three runs of ResNet-20
)
def test_nhwc_plain_bit_identical_to_jax(c, hw, ms):
    """stage_identity_blocks_nhwc, the forward's entry point, on a CPU
    tensor: JAX's reference on the (C, B*H*W) stream, transposed."""
    batch = 2
    rng = np.random.RandomState(c + hw)
    blocks = _blocks(rng, c, len(ms))
    wt, scale, bias = jsk.pack_block_weights(_as(blocks, JQConv, jnp.asarray))
    stream = rng.randint(0, 4 * 127, (c, batch * hw * hw)).astype(np.int16)
    want = jax.jit(jsk.stage_identity_blocks_reference, static_argnums=(4, 5, 6, 7))(
        stream, wt, scale, bias, ms, 127, hw, hw
    )
    want = np.asarray(want).reshape(c, batch, hw, hw).transpose(1, 2, 3, 0)
    x = torch.from_numpy(np.ascontiguousarray(stream.reshape(c, batch, hw, hw).transpose(1, 2, 3, 0)))
    tw, ts, tb = tsk.pack_block_weights(_as(blocks, TQConv, torch.from_numpy))
    got = tsk.stage_identity_blocks_nhwc(x, tw, ts, tb, ms, g=127)
    assert got.dtype == torch.int16 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_block_weights_equal():
    blocks = _blocks(np.random.RandomState(5), 32, 3)
    want = jsk.pack_block_weights(_as(blocks, JQConv, jnp.asarray))
    got = tsk.pack_block_weights(_as(blocks, TQConv, torch.from_numpy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_poly_codes_equal():
    h = (np.random.RandomState(6).randn(1 << 14) * 2).astype(np.float32)
    for g in (127.0, 7.0):
        want = jax.jit(lambda v: jsk._poly_codes(v, g))(h)
        np.testing.assert_array_equal(tsk._poly_codes(torch.from_numpy(h), g).numpy(), np.asarray(want))


def test_cuda_source_carries_f32_poly_coefficients():
    """The poly codes of csrc/stage_kernel.cu are csrc/act_codes.cuh's
    poly_code, which writes ERF_SQRT2_POLY as f32 hex literals, highest
    degree first (the Horner order)."""
    cu = CU.read_text()
    assert '#include "act_codes.cuh"' in cu and "act::poly_code(" in cu
    hexfloat = r"(-?0x[0-9a-f.]+p[-+]?\d+)f"
    assert re.findall(hexfloat, cu) == []  # no coefficient of its own
    body = re.search(r"int poly_code\(.*?\n}\n", HEADER.read_text(), re.S).group(0)
    lits = re.findall(hexfloat, body)
    want = [float(np.float32(c)) for c in ERF_SQRT2_POLY[::-1]]
    assert [float.fromhex(v) for v in lits] == want


def test_rejects_bad_multipliers():
    wt = torch.zeros((1, 2, 16, 144), dtype=torch.int8)
    sc = torch.zeros((1, 2, 16))
    stream = torch.zeros((16, 64), dtype=torch.int16)
    with pytest.raises(ValueError):
        tsk.stage_identity_blocks(stream, wt, sc, sc, (2, 3), w_img=8, h_img=8)
    with pytest.raises(ValueError):
        tsk.stage_identity_blocks(stream, wt, sc, sc, (0,), w_img=8, h_img=8)


def test_rejects_chunks_of_images():
    """chunk_imgs stays in the signature, but one image a CTA is the only
    value the CUDA kernel takes; the plain version holds to it too."""
    wt = torch.zeros((1, 2, 16, 144), dtype=torch.int8)
    sc = torch.zeros((1, 2, 16))
    stream = torch.zeros((16, 128), dtype=torch.int16)
    with pytest.raises(ValueError, match="chunk_imgs"):
        tsk.stage_identity_blocks(stream, wt, sc, sc, (2,), w_img=8, h_img=8, chunk_imgs=2)
    assert tsk.stage_identity_blocks(stream, wt, sc, sc, (2,), w_img=8, h_img=8, chunk_imgs=1).shape == (16, 128)
