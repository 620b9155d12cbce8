"""Training harness: losses, SGDR schedules, checkpointing, AWGN trainer
(port of yondx/train)."""
from .losses import l1_loss, charbonnier_loss, unet_loss, psnr_loss, \
    gradient_loss, pyramid_loss, unet_dpsv_loss, unet_dpsv_loss_up
from .schedule import get_cos_lr, get_multistep_lr, lr_lambda_from_hyper
from .ckpt import save_checkpoint, load_checkpoint
from .trainer import AWGNTrainer

__all__ = [
    "l1_loss", "charbonnier_loss", "unet_loss", "psnr_loss",
    "gradient_loss", "pyramid_loss", "unet_dpsv_loss", "unet_dpsv_loss_up",
    "get_cos_lr", "get_multistep_lr", "lr_lambda_from_hyper",
    "save_checkpoint", "load_checkpoint", "AWGNTrainer",
]
