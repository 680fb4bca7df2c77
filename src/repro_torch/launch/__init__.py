"""Entry points: the trainer (port of ``repro/launch/train.py``)."""
