"""Deterministic synthetic token batches and their prefetching pipeline."""
from repro_torch.data.pipeline import (DataPipeline, PipelineState,  # noqa: F401
                                       synthetic_batch)
