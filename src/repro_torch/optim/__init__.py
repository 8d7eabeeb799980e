"""AdamW and its learning-rate schedule."""
