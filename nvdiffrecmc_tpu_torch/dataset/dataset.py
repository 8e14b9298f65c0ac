"""Dataset base and the batch iterator (counterpart of
nvdiffrecmc_tpu/dataset/dataset.py).  The iterator and the datasets expose
their state, so that a checkpoint can hold where the data loop stood."""

import numpy as np
import torch

from .. import tracing


def rng_state(rng):
    """A numpy RandomState's state as tensors and numbers (what torch.load
    reads back with weights_only)."""
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return {'name': name, 'keys': torch.as_tensor(keys.astype(np.int64)),
            'pos': int(pos), 'has_gauss': int(has_gauss),
            'gauss': float(gauss)}


def set_rng_state(rng, state):
    rng.set_state((state['name'], state['keys'].numpy().astype(np.uint32),
                   state['pos'], state['has_gauss'], state['gauss']))


class Dataset:
    """An indexable source of samples and the collation of a list of them
    into one batch.  The image datasets' items hold tensors on the
    dataset's device, and their collation keeps them there."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, i):
        raise NotImplementedError

    def collate(self, batch):
        """The cameras and images of the items concatenated; resolution,
        spp and light from the first."""
        out = {k: torch.cat([b[k] for b in batch])
               for k in ('mv', 'mvp', 'campos', 'img') if k in batch[0]}
        out.update(resolution=batch[0]['resolution'], spp=batch[0]['spp'])
        if 'light' in batch[0]:
            out['light'] = batch[0]['light']
        return out

    def state_dict(self):
        """What a checkpoint holds of the dataset: nothing for a dataset
        that draws no randoms."""
        return {}

    def load_state_dict(self, state):
        pass


class BatchIterator:
    """The JAX package's batch_iterator: cycles over a dataset in batches
    forever.  With shuffle, the order is shuffled by RandomState(seed)
    before the first epoch and again at each wrap; a batch that would run
    past the end starts a new epoch."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.order = np.arange(len(dataset))
        if shuffle:
            self.rng.shuffle(self.order)
        self.pos = 0

    def __iter__(self):
        return self

    def next_indices(self):
        if self.pos + self.batch_size > len(self.order):
            if self.shuffle:
                self.rng.shuffle(self.order)
            self.pos = 0
        idx = self.order[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        return idx

    def __next__(self):
        with tracing.span('dataset.next'):
            return self.dataset.collate([self.dataset[int(j)]
                                         for j in self.next_indices()])

    def state_dict(self):
        return {'rng': rng_state(self.rng),
                'order': torch.as_tensor(self.order), 'pos': self.pos}

    def load_state_dict(self, state):
        set_rng_state(self.rng, state['rng'])
        self.order = state['order'].numpy().copy()
        self.pos = state['pos']
