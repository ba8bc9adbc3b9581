"""utils layer of tpu_rt_torch (see the package docstring)."""
