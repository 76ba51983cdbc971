"""The distributed examples of the repository (examples/distributed),
ported: partitioned supervised GraphSAGE (``python -m
glt_tpu_torch.examples.distributed.dist_train_sage``) and partitioned
unsupervised link prediction (``... .dist_sage_unsup``), one rank a card
(``torchrun --nproc_per_node N`` for N ranks)."""
