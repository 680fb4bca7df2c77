from repro_torch.checkpoint.ckpt import (
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["latest_step", "load_checkpoint", "save_checkpoint"]
