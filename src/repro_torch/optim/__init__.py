"""AdamW, its learning-rate schedule and int8 gradient compression."""
from repro_torch.optim.adamw import AdamW, OptState, cosine_schedule
from repro_torch.optim.compress import (compress_int8, decompress_int8,
                                        error_feedback_update)

__all__ = ["AdamW", "OptState", "cosine_schedule",
           "compress_int8", "decompress_int8", "error_feedback_update"]
