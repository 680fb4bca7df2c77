"""Training: AdamW, the train step and gradient compression (ports of
``repro/training``)."""
