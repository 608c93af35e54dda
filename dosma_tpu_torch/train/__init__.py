"""U-Net training on a mesh of ranks (counterpart of ``dosma_tpu/train/``)."""

from dosma_tpu_torch.train.checkpoint import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from dosma_tpu_torch.train.seg_trainer import (  # noqa: F401
    SegTrainer,
    adam_state_from_optax,
    dice_bce_loss,
    make_sharded_train_step,
    param_shardings,
)
