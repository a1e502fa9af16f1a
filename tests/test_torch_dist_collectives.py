"""The port's compressed gradient means (alignq_tpu_torch/dist/
collectives.py compressed_tree_pmean) against the JAX package's
compressed_pmean (alignq_tpu/dist/collectives.py) under shard_map, on the
same per-shard numpy inputs, over 2, 3 and 4 ranks (gloo subprocesses on the
CPU; JAX over as many virtual CPU devices, as tests/test_collectives.py
runs it):
- 'int8_gather' bit for bit: the codes each rank sends and the result
  (under jit XLA turns JAX's `/ 127.0` into a multiply by f32(1/127),
  which moves 79% of one leaf's results by an ulp at n=4; the port
  multiplies too);
- 'f32' within 1e-6 relative to the leaf's largest magnitude (gloo's
  ring all-reduce and XLA's reduction add 4 shards in different orders,
  and an element that cancels to near 0 keeps the absolute error of a
  rounding of its addends);
- 'bf16' within one bf16 ulp of the result's magnitude: of the bf16 sum
  of the n shards, the leaf's largest, then / n (XLA's reduction and
  gloo's round the partial sums of 3 or 4 shards in other orders, and an
  element that cancels keeps the error of its larger partial sums);
- the all-zero tensor gives zeros in every mode; an unknown mode raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from torch_port_helpers import run_ranks

from alignq_tpu.dist import make_mesh
from alignq_tpu.dist.collectives import compressed_pmean


def _inputs(n):
    """Per-shard leaves, (n, ...) each: gradient-like tensors of a few
    shapes and scales, and the all-zero tensor."""
    r = np.random.RandomState(n)
    return {
        "conv": (r.randn(n, 16, 8, 3, 3) * 0.05).astype(np.float32),
        "bias": (r.randn(n, 16) * 3.0).astype(np.float32),
        "head": (r.randn(n, 64, 10) * r.rand(n, 1, 1)).astype(np.float32),
        "zero": np.zeros((n, 5, 7), np.float32),
    }


def _jax_means(leaves, n, mode):
    mesh = make_mesh((n,), ("data",), jax.devices()[:n])
    f = jax.shard_map(lambda t: jax.tree.map(lambda a: compressed_pmean(a[0], "data", mode), t), mesh=mesh,
                      in_specs=P("data"), out_specs=P(), check_vma=False)
    return jax.device_get(jax.jit(f)({k: jnp.asarray(v) for k, v in leaves.items()}))


def _jax_codes(leaves, n):
    """The int8 codes of each shard as JAX's int8_gather computes them."""

    def codes(a, axis_name="data"):
        scale = jnp.maximum(jax.lax.pmax(jnp.max(jnp.abs(a[0])), axis_name) / 127.0, 1e-30)
        return jnp.clip(jnp.round(a[0] / scale), -127, 127).astype(jnp.int8)[None]

    mesh = make_mesh((n,), ("data",), jax.devices()[:n])
    f = jax.shard_map(lambda t: jax.tree.map(codes, t), mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                      check_vma=False)
    return jax.device_get(jax.jit(f)({k: jnp.asarray(v) for k, v in leaves.items()}))


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_compressed_means_match_jax(tmp_path, n):
    leaves = _inputs(n)
    np.savez(tmp_path / "in.npz", **leaves)
    run_ranks(n, dict(kind="means", inputs=str(tmp_path / "in.npz"), out=str(tmp_path / "out_{rank}.npz")), tmp_path)
    outs = [np.load(tmp_path / f"out_{r}.npz") for r in range(n)]
    want = {m: _jax_means(leaves, n, m) for m in ("f32", "bf16", "int8_gather")}
    jcodes = _jax_codes(leaves, n)
    for r, got in enumerate(outs):
        assert int(got["refused"]) == 1
        for k in leaves:
            np.testing.assert_array_equal(got[f"c:{k}"], jcodes[k][r], err_msg=f"codes {k} rank {r}")
            np.testing.assert_array_equal(got[f"int8_gather/{k}"], want["int8_gather"][k], err_msg=k)
            np.testing.assert_allclose(got[f"f32/{k}"], want["f32"][k], rtol=0,
                                       atol=1e-6 * np.abs(want["f32"][k]).max(), err_msg=k)
            w, g = want["bf16"][k], got[f"bf16/{k}"]
            assert np.abs(g - w).max() <= _bf16_ulp(n * np.abs(w).max()) / n, k
            assert got[f"bf16/{k}"].dtype == np.float32
        for m in want:
            np.testing.assert_array_equal(got[f"{m}/zero"], np.zeros((5, 7), np.float32))
    # every rank holds the same mean
    for k in leaves:
        for m in want:
            for got in outs[1:]:
                np.testing.assert_array_equal(got[f"{m}/{k}"], outs[0][f"{m}/{k}"])
    # the int8 wire format is not the f32 mean: it rounds each shard's
    # contribution to its scale, within max|x| / 254 of the mean
    x = leaves["head"]
    err = np.abs(outs[0]["int8_gather/head"] - x.mean(0)).max()
    assert 0 < err <= np.abs(x).max() / 254 + 1e-6


def test_the_batch_axis_is_read_in_a_forward_only():
    """A custom autograd Function that read the active batch axis in its
    backward would see none on autograd's threads and reduce over its own
    shard: current_axis() raises there instead; a forward reads it."""
    import torch

    from alignq_tpu_torch.dist import collectives as C

    class ReadsInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.axis = C.current_axis()
            return x * 2

        @staticmethod
        def backward(ctx, g):
            C.current_axis()
            return g * 2

    axis = C.BatchAxis(group=None, rank=0, size=1)
    x = torch.ones(3, requires_grad=True)
    with C.batch_axis(axis):
        assert C.current_axis() is axis
        y = ReadsInBackward.apply(x).sum()
        with pytest.raises(RuntimeError, match="read in a backward"):
            y.backward()
    assert C.current_axis() is None
