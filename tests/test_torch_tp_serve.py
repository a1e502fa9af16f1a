"""Mesh serving (alignq_tpu_torch/serve.py over a ('data', 'model') mesh,
the column-parallel K1 site of kernels/qmatmul.py, dist/sharding.py
shard_operands) on the CPU: gloo ranks through torch_port_helpers.run_ranks
serve artifacts through engine_from_artifact, and rank 0's answers equal
the one-process engine's bit for bit on meshes (1, 2), (2, 1) and (2, 2):
ResNet-20 on the slice route (poly codes, K3's plain version) and on the
erf route, W4A4 bins_int (the cutpoints sliced with their convs) and the
ResNet-18 trunk at 32x32 (its per-batch requant over the global batch);
chip_smoke.py phase 25 serves DenseNet-40's int8 stage buffer besides. The mesh's layout
is row-major, as JAX's. An engine batch the data axis does not divide
raises ValueError."""

import numpy as np
import pytest
import torch
from torch_port_helpers import random_like, random_preact_tree, run_ranks

from alignq_tpu_torch import interop
from alignq_tpu_torch.dist.mesh import Mesh
from alignq_tpu_torch.kernels.artifact import save_int8_artifact
from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
from alignq_tpu_torch.serve import engine_from_artifact

N_REQUESTS = 1
MESHES_2 = ((1, 2), (2, 1))


def _artifacts(tmp):
    """(path, engine batch, image shape) of each served net."""
    out = []

    def save(name, params, stats, meta, batch, hw=32):
        tp, ts = interop.params_from_numpy(params, stats, "cpu")
        q = DEPLOY_FAMILIES[meta["model"]].convert(tp, ts, meta)
        path = str(tmp / f"{name}.npz")
        save_int8_artifact(path, q, meta=meta)
        out.append((path, batch, (hw, hw, 3)))

    p, s = random_preact_tree(20, seed=1)
    base = {"model": "resnet20", "act_bits": 8, "weight_bits": 8, "stream": "int16"}
    save("slice", p, s, dict(base, act_impl="poly", use_stage_kernel=1), 4)
    save("erf", p, s, dict(base, act_impl="erf"), 4)
    save("bins_int", p, s, dict(base, act_impl="bins_int", act_bits=4, weight_bits=4), 4)
    trunk = interop.init_resnet_imagenet_params("resnet18", torch.Generator().manual_seed(0), "cpu")
    p, s = random_like(trunk, seed=3)
    save("trunk", p, s, {"model": "resnet18", "act_bits": 8, "weight_bits": 8, "act_impl": "erf",
                         "image_size": 32}, 4)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    arts = _artifacts(tmp)
    r = np.random.RandomState(0)
    reqs = {f"{i}/{j}": r.randn(batch, *shape).astype(np.float32) * 1.5
            for i, (_, batch, shape) in enumerate(arts) for j in range(N_REQUESTS)}
    np.savez(tmp / "reqs.npz", **reqs)
    want = {}
    for i, (path, batch, _) in enumerate(arts):
        engine = engine_from_artifact(path, batch, device="cpu")
        try:
            for j in range(N_REQUESTS):
                want[f"{i}/{j}"] = engine.submit(reqs[f"{i}/{j}"]).result(timeout=300)
        finally:
            engine.close()
    got = {}
    for n, meshes in ((2, MESHES_2), (4, ((2, 2),))):
        spec = dict(kind="serve", meshes=[list(m) for m in meshes], n_requests=N_REQUESTS,
                    artifacts=[[p, b] for p, b, _ in arts], requests=str(tmp / "reqs.npz"),
                    out=str(tmp / f"serve{n}_{{rank}}.npz"))
        run_ranks(n, spec, tmp, timeout=600)
        for r in range(n):
            got.update({f"{k}@{r}" if k.endswith(("layout", "groups")) else k: v
                        for k, v in np.load(tmp / f"serve{n}_{r}.npz").items() if r == 0 or "/layout" in k
                        or "/groups" in k})
    return arts, want, got


NETS = ("slice", "erf", "bins_int", "trunk")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)], ids=["1x2", "2x1", "2x2"])
@pytest.mark.parametrize("net", range(len(NETS)), ids=NETS)
def test_mesh_serving_equals_one_process(served, mesh, net):
    _, want, got = served
    for j in range(N_REQUESTS):
        a, b = got[f"{mesh[0]}x{mesh[1]}/{net}/{j}"], want[f"{net}/{j}"]
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)], ids=["1x2", "2x1", "2x2"])
def test_mesh_layout_is_row_major(served, mesh):
    """Global rank r sits at (r // n_model, r % n_model), as JAX's
    reshape of the device list; its data group holds the ranks of its
    model coordinate, its model group those of its data coordinate (none
    with a model axis of 1: the data group is then the world)."""
    _, _, got = served
    n_data, n_model = mesh
    for r in range(n_data * n_model):
        d, m = divmod(r, n_model)
        assert got[f"{n_data}x{n_model}/layout@{r}"].tolist() == [d, m]
        want = [dd * n_model + m for dd in range(n_data)]
        if n_model > 1:
            want += [d * n_model + mm for mm in range(n_model)]
        assert got[f"{n_data}x{n_model}/groups@{r}"].tolist() == want


def test_indivisible_batch_raises(served):
    arts, _, _ = served
    with pytest.raises(ValueError, match="divisible"):
        engine_from_artifact(arts[0][0], 3, mesh=Mesh(("data", "model"), (2, 1), None, 0), device="cpu")
