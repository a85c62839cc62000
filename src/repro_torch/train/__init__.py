"""Training: the loss, the train step with gradient accumulation
(``steps``), AdamW with warmup-cosine (``optimizer``) and int8
error-feedback gradient compression (``compress``), as ``repro/train``."""
