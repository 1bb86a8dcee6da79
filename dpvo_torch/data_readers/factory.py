"""Dataset factory (reference dpvo/data_readers/factory.py:9-26; a copy of
dpvo_tpu/data_readers/factory.py)."""
from __future__ import annotations


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.lengths = [len(d) for d in datasets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self.lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError


def dataset_factory(dataset_list, **kwargs):
    """ConcatDataset of each named dataset ('tartan', 'synthetic') built
    with kwargs."""
    from .synthetic import Synthetic
    from .tartan import TartanAir
    dataset_map = {'tartan': (TartanAir,), 'synthetic': (Synthetic,)}
    db_list = []
    for key in dataset_list:
        db = dataset_map[key][0](**kwargs)
        print(f'Dataset {key} has {len(db)} images')
        db_list.append(db)
    return ConcatDataset(db_list)
