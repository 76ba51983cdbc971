from .train import SageTrainStep, sage_loss

__all__ = ['SageTrainStep', 'sage_loss']
