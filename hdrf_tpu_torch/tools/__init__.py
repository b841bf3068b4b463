"""Operator tools of the port (hdrf_tpu/tools): the CLI, the SLO and
gap reports."""
