"""Install glt_tpu (pure Python; the native shm library builds on demand
via make -C glt_tpu/csrc) and its PyTorch/CUDA port glt_tpu_torch (the
CUDA kernels in glt_tpu_torch/csrc build with nvcc on first use)."""
from setuptools import find_packages, setup

setup(
    name='glt_tpu',
    version='0.1.0',
    description=('TPU-native graph learning framework: sampling, unified '
                 'feature store, distributed GNN training on JAX/XLA'),
    packages=find_packages(include=['glt_tpu', 'glt_tpu.*',
                                    'glt_tpu_torch', 'glt_tpu_torch.*']),
    package_data={'glt_tpu': ['csrc/*.cc', 'csrc/Makefile'],
                  'glt_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'numpy',
    ],
    extras_require={
        'ckpt': ['orbax-checkpoint'],
        'torch': ['torch'],
        'test': ['pytest'],
    },
)
