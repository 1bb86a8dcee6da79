"""Data readers (numpy + cv2): synthetic scenes with exact ground truth,
the TartanAir training and test sets, their augmentation and frame graph,
and the dataset factory train/cli.py builds from."""
from .factory import dataset_factory

__all__ = ['dataset_factory']
