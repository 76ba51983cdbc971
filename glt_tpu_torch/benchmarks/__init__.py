"""The port's counterparts of the JAX package's benchmark scripts
(benchmarks/): the compile probe's ladder and the gather microbench, each
run as ``python -m glt_tpu_torch.benchmarks.<name>`` on a card."""
