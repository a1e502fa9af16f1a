"""The int8 stage buffer's calibrators on a deliberately noisy QAT run
(port of tools/stage_calib_ab.py).

DenseNet-40 with the int8 stage buffer (stage_int8, deploy_exact, W8A8) is
trained on the synthetic set where one early batch is scaled by --spike
(an activation transient; SpikeLoader), once per calibrator of the
buffer's per-channel scale (nn/layers.py StageRequant: `max`, the
monotone running max; `ema`; `ema_p999`, an EMA of the 99.9th
percentile), after one spike-free `max` run whose amax is the reference
scale. Per run, one JSON line: the QAT eval's best top-1 (`qat_top1`); the
fake-quant eval's and the INT graph's top-1 on the test set and their
prediction agreement, the INT graph folded and run by the port's export
path (export_int8.export_and_compare); and the scale inflation, each
site's mean ratio of its final amax to the spike-free run's (mean and max
over the sites). A final summary line.

    python -m alignq_tpu_torch.tools.stage_calib_ab [--epochs 3] [--batch 64] [--spike 8] [--calibs max,ema,ema_p999]
        [--smoke] [--device cpu]

--smoke: a depth-10 DenseNet, 2 steps at batch 8, 16 test images.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch


class SpikeLoader:
    """A train loader whose batch `at_batch` of the first epoch is scaled
    by `spike`; the rest as the inner loader's."""

    def __init__(self, inner, spike: float, at_batch: int = 1):
        self.inner = inner
        self.spike = spike
        self.at_batch = at_batch
        self._epoch = 0

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, name):  # x, y, batch_size, ... of the inner loader
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name == "pin_memory":
            setattr(self.inner, name, value)
        else:
            super().__setattr__(name, value)

    def __iter__(self):
        self._epoch += 1
        for i, (x, y) in enumerate(self.inner):
            yield (x * self.spike, y) if self._epoch == 1 and i == self.at_batch else (x, y)


def amax_leaves(model) -> dict:
    """{site: its StageRequant amax} of a model."""
    return {name[: -len(".amax")]: t.detach().cpu().numpy() for name, t in model.named_buffers()
            if name.endswith("amax")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="StageRequant calibrators on a spiked DenseNet-40 stage_int8 QAT run")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--spike", type=float, default=8.0)
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--calibs", default="max,ema,ema_p999")
    p.add_argument("--smoke", action="store_true", help="depth 10, 2 steps at batch 8, 16 test images")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.data.registry import get_data
    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.export_int8 import FAMILIES, export_and_compare
    from alignq_tpu_torch.models import DenseNet
    from alignq_tpu_torch.tools.corr_mode_ab import head
    from alignq_tpu_torch.train import TrainConfig
    from alignq_tpu_torch.train.loop import fit
    from alignq_tpu_torch.utils.launches import device_line

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev)}), flush=True)
    depth, batch, max_steps = (10, 8, 2) if a.smoke else (40, a.batch, a.max_steps)
    results, baseline = {}, None
    for tag, spike, calibs in (("clean", 1.0, ["max"]), ("spiked", a.spike, a.calibs.split(","))):
        for calib in calibs:
            with tempfile.TemporaryDirectory(prefix=f"stage_calib_{tag}_{calib}_") as job:  # its checkpoints
                cfg = TrainConfig(
                    target_model=FAMILIES["densenet40"][0], method="ours", bitW=a.bits, abitW=a.bits, variant="int8",
                    dataset="synthetic", num_epochs=1 if a.smoke else a.epochs, train_batch_size=batch,
                    eval_batch_size=batch, job_dir=job, print_freq=10000, correction_exclude=(), deploy_exact=True,
                    stage_int8=True, stage_calib=calib,
                )
                data = get_data(cfg.dataset, cfg.job_dir, batch, batch, cfg.seed)
                data.loader_train = SpikeLoader(data.loader_train, spike)
                if a.smoke:
                    data.loader_test = head(data.loader_test, 16)
                model = DenseNet(depth=depth, compression_rate=1, w_bit=a.bits, a_bit=a.bits, method="ours",
                                 variant="int8", deploy_exact=True, stage_int8=True, stage_calib=calib,
                                 generator=torch.Generator().manual_seed(cfg.seed))
                res = fit(cfg, data, model=model, max_steps=max_steps, device=dev)
                model = res["state"].model
                meta = {"model": "densenet40", "act_bits": a.bits, "weight_bits": a.bits, "act_impl": "erf",
                        "stream": "int16", "variant": "int8", "deploy_exact": 1, "packed_int4": 0, "stage_int8": 1,
                        "use_stage_kernel": 0, "depth": depth}
                report, _ = export_and_compare(model, data.loader_test, "densenet40", meta)
            am = amax_leaves(model)
            if tag == "clean":
                baseline, key = am, "clean_max"
            else:
                key = calib
            infl = [float(np.mean(v / np.maximum(baseline[site], 1e-9))) for site, v in am.items()]
            row = {"calib": key, "spike": spike, "qat_top1": res["best_top1"], "int8_top1": report["int_top1"],
                   "fq_top1": report["fq_top1"], "agreement_pct": report["agreement"],
                   "amax_inflation_mean": float(np.mean(infl)), "amax_inflation_max": float(np.max(infl))}
            results[key] = row
            print(json.dumps(row), flush=True)
    summary = {"summary": {k: {"agreement_pct": v["agreement_pct"], "amax_inflation_mean": v["amax_inflation_mean"]}
                           for k, v in results.items()}}
    print(json.dumps(summary), flush=True)
    return {**results, **summary}


if __name__ == "__main__":
    main()
