"""Standalone tools of the port (the reference's ``ultragrid_tpu/tools/``)."""
