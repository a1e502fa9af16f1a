from alignq_tpu_torch.nn.layers import BatchNorm, QConv, QDense, QuantAct, StageRequant  # noqa: F401
