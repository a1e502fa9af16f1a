"""Warm starts (alignq_tpu_torch/train/pretrained.py, fit's
pretrained_dir, the CLI's --pretrained) and the classification presets
(alignq_tpu_torch/configs.py): the cases of tests/test_pretrained.py and
of tests/test_configs.py, the merge held against JAX's merge_pretrained
and each preset against JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread, write_tiny_cifar10  # noqa: F401

from alignq_tpu import configs as jconfigs
from alignq_tpu.train.pretrained import merge_pretrained as j_merge
from alignq_tpu_torch import configs
from alignq_tpu_torch.models.registry import build_model
from alignq_tpu_torch.models.resnet_cifar import resnet20_quant
from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step
from alignq_tpu_torch.train.checkpoint import CheckpointManager
from alignq_tpu_torch.train.pretrained import load_pretrained, merge_pretrained

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_matching_leaves_taken_shape_mismatch_kept():
    target = {"a": torch.zeros((2, 2)), "b": torch.zeros(3), "c": torch.zeros(4)}
    source = {"a": torch.ones((2, 2)), "b": torch.ones(5), "d": torch.ones(4)}
    n, total = merge_pretrained(target, source)
    assert (target["a"] == 1).all()  # matched
    assert (target["b"] == 0).all()  # shape mismatch: the fresh init stays
    assert (target["c"] == 0).all()  # missing in the source
    assert (n, total) == (1, 3)
    merged, jn, jtotal = j_merge({"a": jnp.zeros((2, 2)), "b": jnp.zeros(3), "c": jnp.zeros(4)},
                                 {k: jnp.asarray(v.numpy()) for k, v in source.items()})
    assert (jn, jtotal) == (n, total)
    for k, v in target.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(merged[k]))


def _state(bits, admm, seed, job_dir):
    cfg = TrainConfig(train_batch_size=8, bitW=bits, abitW=bits, admm=admm, job_dir=str(job_dir))
    model = resnet20_quant(bits, bits, "ours", admm=admm, generator=torch.Generator().manual_seed(seed))
    state = create_train_state(torch.Generator().manual_seed(seed), model, cfg, input_shape=(1, 16, 16, 3),
                               steps_per_epoch=4)
    return cfg, model, state


def test_8bit_pretrain_into_4bit_admm_run(tmp_path):
    """The reference's flow: train 8-bit, warm-start the 4-bit ADMM run
    from it (the source has no duals; the target does)."""
    cfg8, m8, s8 = _state(8, False, 0, tmp_path / "w8")
    x = torch.randn((8, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    y = torch.zeros(8, dtype=torch.long)
    make_train_step(m8, cfg8)(s8, x, y)
    CheckpointManager(str(tmp_path / "w8")).save(1, s8, metrics={"top1": 50.0})

    cfg4, m4, s4 = _state(4, True, 2, tmp_path / "w4")
    duals = {k: v.gamma.clone() for k, v in s4.admm_duals.items()}
    before = s4.params["conv0.kernel"].clone()
    s4 = load_pretrained(s4, str(tmp_path / "w8"))
    for table in ("params", "batch_stats"):
        for k, v in getattr(s4, table).items():
            assert torch.equal(v, getattr(s8, table)[k]), k  # weights and statistics from the 8-bit run
    assert not torch.equal(before, s4.params["conv0.kernel"])
    # the duals and the optimizer stay fresh, and the state still trains
    assert len(s4.admm_duals) == 21 and all(torch.equal(s4.admm_duals[k].gamma, g) for k, g in duals.items())
    assert s4.tx.count == 0 and not s4.tx.trace
    _, m = make_train_step(m4, cfg4)(s4, x, y)
    assert np.isfinite(float(m["loss"]))


def test_missing_source_is_noop(tmp_path):
    _, _, s = _state(4, False, 0, tmp_path / "job")
    before = {k: v.clone() for k, v in s.params.items()}
    s2 = load_pretrained(s, str(tmp_path / "nothing"))
    assert all(torch.equal(s2.params[k], v) for k, v in before.items())
    assert not (tmp_path / "nothing").exists()


def test_cli_pretrained_warm_starts_fit(tmp_path):
    """--pretrained: a 4-bit ADMM run at lr 0 keeps the 8-bit run's
    weights through its one step (weight decay times lr 0 moves nothing)."""
    from alignq_tpu_torch.train import cli

    common = ["--device", "cpu", "--dataset", "cifar10", "--data_dir", write_tiny_cifar10(tmp_path / "data"),
              "--num_epochs", "1", "--train_batch_size", "8", "--eval_batch_size", "32", "--print_freq", "1"]
    first = cli.main(common + ["--max_steps", "2", "--job_dir", str(tmp_path / "w8")])
    second = cli.main(common + ["--max_steps", "1", "--bitW", "4", "--abitW", "4", "--admm", "--lr", "0",
                                "--pretrained", str(tmp_path / "w8"), "--job_dir", str(tmp_path / "w4")])
    for k, v in first["state"].params.items():
        assert torch.equal(second["state"].params[k], v), k
    assert len(second["state"].admm_duals) == 21 and second["state"].step == 1


def test_all_presets_construct_as_jax():
    """Every preset, the three domain-adaptation ones (DAConfig) among
    them, equals JAX's field for field (but for the directories)."""
    from alignq_tpu_torch.train.da import DAConfig

    assert set(configs.ALL) == set(jconfigs.ALL)
    for name, fn in configs.ALL.items():
        cfg, want = fn(), jconfigs.ALL[name]()
        assert isinstance(cfg, DAConfig if type(want).__name__ == "DAConfig" else TrainConfig), name
        assert cfg.bitW in (4, 5, 8, 32), name
        ours = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("data_dir", "job_dir")}
        theirs = {k: getattr(want, k) for k in ours}
        assert {k: tuple(v) if isinstance(v, list) else v for k, v in ours.items()} == \
            {k: tuple(v) if isinstance(v, list) else v for k, v in theirs.items()}, name


def test_classification_presets_build_models():
    for name in ("resnet20_cifar10_w8a8", "resnet20_cifar10_w4a4_admm", "resnet56_cifar10_w4a4_admm",
                 "densenet40_cifar10", "mobilenetv2_svhn_w8a8", "resnet20_cifar10_w8a8_fast_deploy",
                 "resnet20_svhn_w8a8"):
        assert build_model(configs.ALL[name]()) is not None, name
    assert configs.densenet40_cifar10().correction_exclude == ()
    mb = configs.mobilenetv2_svhn_w8a8()
    assert mb.correction_exclude == () and mb.warmup_epochs == 2.0 and mb.dataset == "svhn"


def test_overrides_apply():
    cfg = configs.resnet20_cifar10_w8a8(num_epochs=3, lr=0.1)
    assert cfg.num_epochs == 3 and cfg.lr == 0.1
