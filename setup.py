"""Setup for accelerate-tpu — a TPU-native training & inference framework on JAX/XLA.

Mirrors the packaging surface of the reference (reference: setup.py:52-70) with a
console entry point for the CLI.
"""

from setuptools import find_packages, setup

setup(
    name="accelerate-tpu",
    version="0.1.0",
    description="TPU-native training and big-model inference framework on JAX/XLA (pjit/GSPMD, shard_map, Pallas)",
    long_description=open("README.md", encoding="utf-8").read(),
    long_description_content_type="text/markdown",
    author="The accelerate-tpu authors",
    license="Apache 2.0",
    # accelerate_tpu_torch is the PyTorch/CUDA port; its CUDA sources ship with
    # it and are compiled with nvcc at first use on the card.
    packages=find_packages(
        include=["accelerate_tpu", "accelerate_tpu.*", "accelerate_tpu_torch", "accelerate_tpu_torch.*"]
    ),
    package_data={"accelerate_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax>=0.4.30", "numpy>=1.24", "pyyaml"],
    extras_require={
        "flax": ["flax", "optax"],
        "checkpoint": ["orbax-checkpoint"],
        "test": ["pytest"],
        "torch": ["torch>=2.5"],
    },
    entry_points={
        "console_scripts": [
            "accelerate-tpu=accelerate_tpu.commands.accelerate_cli:main",
            "accelerate-tpu-launch=accelerate_tpu.commands.launch:main",
            "accelerate-tpu-torch=accelerate_tpu_torch.commands.accelerate_cli:main",
            "accelerate-tpu-torch-launch=accelerate_tpu_torch.commands.launch:main",
        ]
    },
)
