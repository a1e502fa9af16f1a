"""The port's tensor-parallel pieces against the JAX package and against
one process, on the CPU (gloo ranks through torch_port_helpers.run_ranks):

- the sharding rules (alignq_tpu_torch/dist/sharding.py param_shardings,
  qparams_shardings) against JAX's on the same trees, leaf by leaf: which
  leaves split and on which dimension (the port's QAT kernels are OIHW,
  JAX's HWIO; the qparams are HWIO in both);
- JAX's SHAPES (tests/test_dist.py) through the port's quantize_weight at
  W4 float64, sliced over 2 ranks against whole: zero grid flips, values
  within 1e-12;
- the model axis's autograd: a column-parallel QConv ('ours', LSQ, LLSQ,
  DoReFa, APoT) and QDense over 2 ranks give the one-process output,
  input gradient and parameter gradients (the kernel's as this rank's
  slice) within 1e-12 at float64;
- the multihost helpers against tests/test_multihost.py's cases;
- dryrun_multichip(4): a (2, 2) gather step and a (4,) local step.
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import run_ranks

from alignq_tpu_torch.dist.mesh import Mesh
from alignq_tpu_torch.dist.sharding import param_shardings, place_qparams, qparams_shardings
from alignq_tpu_torch.entry import dryrun_multichip

SHAPES = ((3, 3, 16, 16), (3, 3, 16, 32), (1, 1, 16, 32), (3, 3, 32, 64), (3, 3, 64, 64), (7, 7, 3, 64))
METHODS = ("ours", "lsq", "llsq", "dorefa", "apot")
TOL = dict(rtol=1e-12, atol=1e-12)


def _mesh(n_data, n_model):
    return Mesh(("data", "model"), (n_data, n_model), None, 0)


def _spec(jmesh):
    """A JAX NamedSharding's spec as the port's split dim: None or the index of 'model'."""
    spec = tuple(jmesh.spec)
    return spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)], ids=["4x2", "2x4", "8x1"])
def test_param_shardings_match_jax(shape):
    from alignq_tpu.dist import make_mesh, param_shardings as jax_param_shardings
    from alignq_tpu.models import resnet20_quant

    from alignq_tpu_torch.models.resnet_cifar import resnet20_quant as port_resnet20

    jm = resnet20_quant(bitW=4, abitW=4, method="llsq")
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, 32, 32, 3)),
                                             train=False))["params"]
    jsh = jax_param_shardings(jparams, make_mesh(shape, ("data", "model")))
    flat = {"/".join(str(k.key) for k in path): _spec(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jsh)[0]}
    port = dict(port_resnet20(bitW=4, abitW=4, method="llsq").named_parameters())
    got = param_shardings(port, _mesh(*shape))
    assert set(flat) == {k.replace(".", "/") for k in got}
    for name, dim in got.items():
        want = flat[name.replace(".", "/")]
        # HWIO's split dim 3 is OIHW's 0; a dense (in, out) kernel splits on 1 in both
        want = 0 if (want == 3 and port[name].ndim == 4) else want
        assert dim == want, name
    n_split = sum(d is not None for d in got.values())
    assert n_split == (0 if shape[1] == 1 else 22 if shape[1] == 2 else 21)  # the head's 10 columns: not by 4


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)], ids=["4x2", "2x4", "8x1"])
def test_qparams_shardings_match_jax(shape):
    from alignq_tpu.dist import make_mesh
    from alignq_tpu.dist.sharding import qparams_shardings as jax_qparams_shardings
    from alignq_tpu.kernels.infer import convert_resnet20 as jax_convert
    from torch_port_helpers import random_preact_tree

    from alignq_tpu_torch import interop
    from alignq_tpu_torch.kernels.infer import convert_preact_resnet

    params, stats = random_preact_tree(20, seed=1)
    jq = jax_convert(params, stats)
    jsh = jax_qparams_shardings(jq, make_mesh(shape, ("data", "model")))
    jflat = [_spec(v) for v in jax.tree.leaves(jsh)]
    tq = convert_preact_resnet(*interop.params_from_numpy(params, stats, "cpu"))
    tflat = jax.tree.leaves(qparams_shardings(tq, _mesh(*shape)), is_leaf=lambda v: v is None)
    assert tflat == jflat
    assert sum(d is not None for d in tflat) == (0 if shape[1] == 1 else 21)
    # place_qparams cuts the split leaves to a rank's slice (this process: model rank 0)
    mesh = Mesh(("data", "model"), shape, None, 0, object(), 0)
    placed = place_qparams(tq, mesh)
    k = placed["layers"][0]["conv0"].kernel_int8
    assert k.shape[-1] == tq["layers"][0]["conv0"].kernel_int8.shape[-1] // shape[1]
    assert torch.equal(k, tq["layers"][0]["conv0"].kernel_int8[..., : k.shape[-1]])


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """The tp_units worker over 2 gloo ranks, its inputs drawn here."""
    tmp = tmp_path_factory.mktemp("tp_units")
    r = np.random.RandomState(0)
    arrays = {str(i): r.randn(*s) * 0.1 for i, s in enumerate(SHAPES)}
    arrays["x:conv"], arrays["ct:conv"] = r.randn(2, 8, 6, 6), r.randn(2, 8, 6, 6)
    arrays["x:dense"], arrays["ct:dense"] = r.randn(4, 32), r.randn(4, 8)
    np.savez(tmp / "w.npz", **arrays)
    spec = dict(kind="tp_units", weights=str(tmp / "w.npz"), shapes=[list(s) for s in SHAPES],
                methods=list(METHODS), out=str(tmp / "out_{rank}.npz"))
    run_ranks(2, spec, tmp)
    return arrays, [dict(np.load(tmp / f"out_{rank}.npz")) for rank in range(2)]


def test_sharded_weight_quant_zero_grid_flips(units):
    from alignq_tpu_torch.quant.fake_quant import quantize_weight

    arrays, ranks = units
    spacing = 2.0 / (2**4 - 1)
    flips = 0
    for i in range(len(SHAPES)):
        whole = quantize_weight(torch.from_numpy(arrays[str(i)]).permute(3, 2, 0, 1).contiguous(), 4).wq.numpy()
        tp = np.concatenate([ranks[r][f"q:{i}"] for r in range(2)], axis=0)
        np.testing.assert_allclose(tp, whole, **TOL)
        flips += int((np.abs(tp - whole) > 0.5 * spacing).sum())
    assert flips == 0


@pytest.mark.parametrize("method", METHODS)
def test_model_axis_autograd_equals_one_process(units, method):
    from alignq_tpu_torch.nn.layers import QConv, QDense

    arrays, ranks = units
    for kind in ("conv", "dense") if method == "ours" else ("conv",):
        gen = torch.Generator().manual_seed(3)
        layer = (QConv(8, 8, 3, padding=1, w_bit=4, a_bit=4, method=method, generator=gen) if kind == "conv"
                 else QDense(32, 8, w_bit=4, method="ours", generator=gen)).double()
        x = torch.from_numpy(arrays[f"x:{kind}"]).requires_grad_(True)
        y = layer(x)
        y.backward(torch.from_numpy(arrays[f"ct:{kind}"]))
        tag = f"g:{method}:{kind}:"
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[tag + "y"], y.detach().numpy(), **TOL, err_msg=f"{tag} rank {r}")
            np.testing.assert_allclose(got[tag + "dx"], x.grad.numpy(), **TOL, err_msg=f"{tag} rank {r}")
            for name, p in layer.named_parameters():
                want = p.grad.numpy()
                if name == "kernel":  # this rank's slice of the output channels
                    dim = 0 if kind == "conv" else 1
                    want = np.split(want, 2, axis=dim)[r]
                np.testing.assert_allclose(got[tag + name], want, **TOL, err_msg=f"{tag}{name} rank {r}")


def test_multihost_helpers(units):
    """tests/test_multihost.py's oracles in the one-process-a-device form:
    each rank's placed rows are its contiguous slice, the assembled global
    batch comes back in global row order, and active() holds across
    processes (here, in one process, it does not)."""
    from alignq_tpu_torch.dist import multihost

    _, ranks = units
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["m:rows"], np.arange(r * 8, (r + 1) * 8))
        np.testing.assert_array_equal(got["m:gy"], np.arange(16))
        np.testing.assert_array_equal(got["m:gx"], np.arange(16, dtype=np.float32).reshape(16, 1) * 10.0)
        assert bool(got["m:active"])
    assert not multihost.active() and multihost.is_primary()


def test_dryrun_multichip_4(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "ok (gather corr): mesh=(2x2)" in out and "ok (local corr): mesh=(4x1)" in out
