"""Package build for deepspeed_tpu.

Python package plus (when a toolchain is present) the C++ host extensions
under deepspeed_tpu/ops/native built through the op_builder registry —
the analogue of the reference's setup.py DS_BUILD_* AOT path.  Also ships
the PyTorch/CUDA port, deepspeed_tpu_torch, with its CUDA sources.
"""

from setuptools import find_packages, setup

setup(
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native distributed training & inference framework "
                "(DeepSpeed-compatible surface on JAX/XLA/Pallas)",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch",
                                    "deepspeed_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these sources at first
    # use (deepspeed_tpu_torch/ops/kernels/build.py)
    package_data={"deepspeed_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
)
