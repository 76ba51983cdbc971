from .train import SageTrainStep, link_bce_loss, sage_loss

__all__ = ['SageTrainStep', 'link_bce_loss', 'sage_loss']
