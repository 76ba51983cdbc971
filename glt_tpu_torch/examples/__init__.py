"""The port's counterparts of the repository's example scripts, runnable
as modules (``python -m glt_tpu_torch.examples.<name>``): on the card
unless given ``--device cpu``."""
