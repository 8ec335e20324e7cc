"""ZeRO over a process group (``runtime/zero/sharding.py``) and its
optimizer allowlist (``runtime/zero/utils.py``)."""
