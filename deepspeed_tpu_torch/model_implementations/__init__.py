"""Served model wrappers of the port (``diffusers``: ``DSUNet``,
``DSVAE``)."""
