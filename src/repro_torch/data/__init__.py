"""Data pipelines (port of `repro/data`)."""
from .pipeline import (ProjectionSource, SyntheticTokens, TensorSpec,
                       batch_specs, synthetic_batch)
