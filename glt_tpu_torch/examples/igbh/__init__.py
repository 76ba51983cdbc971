"""The IGBH example of the repository (examples/igbh), ported: a synthetic
IGBH-layout dataset, its seed split, and the partitioned RGNN trainer
(``python -m glt_tpu_torch.examples.igbh.dist_train_rgnn``)."""
