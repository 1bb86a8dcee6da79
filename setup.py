from setuptools import find_packages, setup

setup(
    name='dpvo_tpu',
    version='0.1.0',
    description='TPU-native deep patch visual odometry / SLAM (JAX/XLA/Pallas)'
                ' and its PyTorch / CUDA port (dpvo_torch)',
    packages=find_packages(include=['dpvo_tpu', 'dpvo_tpu.*',
                                    'dpvo_torch', 'dpvo_torch.*']),
    package_data={'dpvo_torch': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'numpy', 'pyyaml', 'opencv-python', 'matplotlib',
    ],
    extras_require={
        'train': ['optax'],
        'torch': ['torch'],
        'dev': ['pytest'],
    },
)
