from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam  # noqa
