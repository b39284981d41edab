"""Sharding rules of the LM stack over a device mesh (port of
`repro.distributed`)."""
from .sharding import (batch_spec, batch_specs, cache_spec, cache_specs,
                       data_axes, named, param_specs, residual_spec,
                       spec_for_param)

__all__ = ["batch_spec", "batch_specs", "cache_spec", "cache_specs",
           "data_axes", "named", "param_specs", "residual_spec",
           "spec_for_param"]
