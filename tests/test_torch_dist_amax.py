"""The combine of StageRequant's `amax` under data parallelism, against the
JAX package's (tests/test_torch_dist_steps.py's setting: two gloo ranks
against JAX's jitted steps over 2 virtual CPU devices, a depth-10 DenseNet
at f64, within 1e-9), here with the int8 stage buffer under 'ema'.
"""

from test_torch_dist_steps import _dense_case


def test_densenet_stage_int8_local_step_combines_amax_by_max(tmp_path):
    """The int8 stage buffer under 'ema': in gather mode each StageRequant
    takes the global batch's max (a MAX over the ranks inside the
    forward); in local mode each rank's `amax` moves by its own shard's
    max and the step combines them by MAX, the BatchNorm statistics by
    their mean, as JAX's shard_map step does."""
    outs, _ = _dense_case(tmp_path, True, [("gather", "f32"), ("local", "f32")], 12)
    amax = [k for k in outs[0] if k.startswith("local/f32/b:") and k.endswith("amax")]
    assert len(amax) == 9
