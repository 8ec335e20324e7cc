"""Launcher of the port: so far only the restart policy that the serving
fleet's replica supervision shares (``launcher/runner.py``)."""
