"""The port's launcher: ``python -m deepspeed_tpu_torch.launcher.runner``
(``dstpu``; one process per device) and its multi-node transports
(``launcher/multinode_runner.py``)."""
