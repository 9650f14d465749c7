from .multiscale import build_multiscale_loss
from .sequence import build_sequence_loss, cpcl_loss, epe_loss, mix_loss, smear_mask

__all__ = ["build_multiscale_loss", "build_sequence_loss", "cpcl_loss", "epe_loss",
           "mix_loss", "smear_mask"]
